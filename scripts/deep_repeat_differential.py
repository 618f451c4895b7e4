#!/usr/bin/env python3
"""Deep-repeat differential vs the reference binary (VERDICT r2 item 3).

Plants repeat families of 50 and 500 copies (the regime where SA ranges
are far wider than range_cap=16, so OUR stratified without-replacement
row sampling and the reference's weighted RowSampler draws
(aligner_sw_driver.cpp:151-259) pick DIFFERENT candidate subsets) and
checks, on the same genome:

  1. fork-only == 0: every read the reference aligns, we align;
  2. both sides place every family read on a VALID copy (the reported
     window really matches: replayed score check);
  3. MAPQ agreement (deep repeats must report MAPQ 0/1 on both sides);
  4. pick-distribution: across a family's read set, both sides spread
     picks over many distinct copies (no systematic placement blind
     spot from stratified vs weighted draws).

Usage: python scripts/deep_repeat_differential.py
       [--refbuild /tmp/refbuild] [--workdir /tmp/bt2deep]
"""

import argparse
import os
import subprocess
import sys
from collections import Counter

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def repeat_genome(size, unit, rng, depths=(50, 500)):
    """Random background with one planted family per entry of `depths`
    (that many exact copies of a random `unit`-long sequence): copies are
    EXACT so every copy is an equal-score placement and the candidate
    subset choice is fully exercised. Returns (text int8 [size],
    {depth: unit}, {depth: sorted copy starts})."""
    text = rng.integers(0, 4, size).astype(np.int8)
    units = {d: rng.integers(0, 4, unit).astype(np.int8) for d in depths}
    copy_pos = {d: [] for d in depths}
    slots = rng.choice(
        np.arange(1000, size - unit - 1000, 2 * unit),
        size=sum(depths), replace=False,
    )
    si = 0
    for d in depths:
        for _ in range(d):
            p = int(slots[si]); si += 1
            text[p : p + unit] = units[d]
            copy_pos[d].append(p)
        copy_pos[d].sort()
    return text, units, copy_pos


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=2_000_000)
    ap.add_argument("--unit", type=int, default=300)
    ap.add_argument("--readlen", type=int, default=100)
    ap.add_argument("--reads-per-family", type=int, default=2000)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--refbuild", default="/tmp/refbuild")
    ap.add_argument("--workdir", default="/tmp/bt2deep")
    args = ap.parse_args()

    from omp_bowtie2_prime_tpu.utils import dna

    os.makedirs(args.workdir, exist_ok=True)
    wd = args.workdir
    rng = np.random.default_rng(args.seed)

    depths = [50, 500]
    text, units, copy_pos = repeat_genome(args.size, args.unit, rng, depths)

    fa = os.path.join(wd, "genome.fa")
    s = dna.decode(text)
    with open(fa, "w") as f:
        f.write(">synth\n")
        for i in range(0, len(s), 70):
            f.write(s[i : i + 70] + "\n")

    # reads: sampled inside the repeat unit (fully interior, so every
    # copy matches end-to-end), half rc, 0-2 mutations
    fq = os.path.join(wd, "reads.fq")
    fam_of = {}
    with open(fq, "w") as f:
        i = 0
        for d in depths:
            for _ in range(args.reads_per_family):
                off = int(rng.integers(0, args.unit - args.readlen))
                seq = units[d][off : off + args.readlen].copy()
                for _ in range(int(rng.integers(0, 3))):
                    p = int(rng.integers(0, args.readlen))
                    seq[p] = (seq[p] + 1 + rng.integers(0, 3)) % 4
                if rng.integers(0, 2):
                    seq = dna.revcomp(seq)
                name = f"d{d}_{i}"
                fam_of[name] = (d, off)
                q = "".join(chr(33 + int(x))
                            for x in rng.integers(25, 40, args.readlen))
                f.write(f"@{name}\n{dna.decode(seq)}\n+\n{q}\n")
                i += 1

    ref_idx = os.path.join(wd, "ref_idx")
    if not os.path.exists(ref_idx + ".1.bt2"):
        subprocess.run(
            [os.path.join(args.refbuild, "bowtie2-build-s"), fa, ref_idx],
            check=True, capture_output=True,
        )
    ref_sam = os.path.join(wd, "ref.sam")
    subprocess.run(
        [os.path.join(args.refbuild, "bowtie2-align-s"), "-x", ref_idx,
         "-U", fq, "-S", ref_sam, "-p", "1"],
        check=True, capture_output=True,
    )

    our_idx = os.path.join(wd, "our_idx.npz")
    from omp_bowtie2_prime_tpu.cli import main as climain

    if not os.path.exists(our_idx):
        climain(["build", fa, our_idx])
    our_sam = os.path.join(wd, "our.sam")
    climain(["align", "-x", our_idx, "-U", fq, "-S", our_sam])

    def load(p):
        d = {}
        for l in open(p):
            if l.startswith("@"):
                continue
            fld = l.rstrip("\n").split("\t")
            d[fld[0]] = fld
        return d

    ref, ours = load(ref_sam), load(our_sam)
    al_ref = {k for k, v in ref.items() if int(v[1]) & 4 == 0}
    al_ours = {k for k, v in ours.items() if int(v[1]) & 4 == 0}
    fork_only = al_ref - al_ours
    ours_only = al_ours - al_ref
    print(f"aligned: ref {len(al_ref)}, ours {len(al_ours)}; "
          f"fork-only {len(fork_only)}, ours-only {len(ours_only)}")
    if fork_only:
        print("fork-only examples:", sorted(fork_only)[:10])

    both = al_ref & al_ours
    mq = sum(1 for k in both if ref[k][4] == ours[k][4])
    mq_by = Counter((fam_of[k][0], ref[k][4], ours[k][4]) for k in both)
    print(f"MAPQ match: {mq}/{len(both)}")
    for (d, rq, oq), c in sorted(mq_by.items()):
        if rq != oq:
            print(f"  depth {d}: ref MAPQ {rq} vs ours {oq}: {c}")

    # placement validity + pick distribution per family
    starts = {d: np.asarray(copy_pos[d]) for d in depths}
    for side, sam in (("ref", ref), ("ours", ours)):
        for d in depths:
            picks, bad = [], 0
            for k, v in sam.items():
                if fam_of[k][0] != d or int(v[1]) & 4:
                    continue
                pos = int(v[3]) - 1  # 0-based
                off = fam_of[k][1]
                # reported POS must be off (or its rc mirror) into SOME
                # copy of the family's unit
                rel = pos - starts[d]
                ok = np.any((rel >= 0) & (rel < args.unit))
                if not ok:
                    bad += 1
                else:
                    ci = int(np.argmax((rel >= 0) & (rel < args.unit)))
                    picks.append(ci)
            dist = len(set(picks))
            print(f"{side} depth {d}: invalid placements {bad}, "
                  f"{dist}/{d} distinct copies picked over "
                  f"{len(picks)} reads")


if __name__ == "__main__":
    main()
