#!/usr/bin/env python3
"""Randomized differential harness vs the reference binaries.

The analog of the reference's scripts/sim + scripts/test/regressions.py:
generate a random genome + mutated reads, build indexes with both
toolchains, align with both, and compare. Requires the reference binaries
(build once: cp -r /root/reference /tmp/refbuild; see DIFFERENTIAL.md).

Usage:
  python scripts/differential.py [--size 4600000] [--reads 20000]
      [--refbuild /tmp/refbuild] [--workdir /tmp/bt2diff]
"""

import argparse
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=4_600_000)
    ap.add_argument("--reads", type=int, default=20_000)
    ap.add_argument("--readlen", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-runs", type=int, default=0,
                    help="sprinkle this many short N runs (1-6bp) into "
                         "the genome to exercise the N-bridge DP path")
    ap.add_argument("--refbuild", default="/tmp/refbuild")
    ap.add_argument("--workdir", default="/tmp/bt2diff")
    args = ap.parse_args()

    from omp_bowtie2_prime_tpu.utils import dna

    os.makedirs(args.workdir, exist_ok=True)
    wd = args.workdir
    rng = np.random.default_rng(args.seed)

    fa = os.path.join(wd, "genome.fa")
    if not os.path.exists(fa):
        text = rng.integers(0, 4, args.size).astype(np.int8)
        for _ in range(args.n_runs):  # intra-ref N gaps (bridge path)
            p = int(rng.integers(100, args.size - 100))
            text[p : p + int(rng.integers(1, 7))] = 4
        s = dna.decode(text)
        with open(fa, "w") as f:
            f.write(">synth\n")
            for i in range(0, len(s), 70):
                f.write(s[i : i + 70] + "\n")
        print(f"wrote genome {args.size}bp", file=sys.stderr)
    else:
        from omp_bowtie2_prime_tpu.index.fasta import parse_fasta

        _, seqs = parse_fasta(fa)
        text = seqs[0]

    fq = os.path.join(wd, "reads.fq")
    if not os.path.exists(fq):
        with open(fq, "w") as f:
            for i in range(args.reads):
                pos = int(rng.integers(0, args.size - args.readlen))
                seq = text[pos : pos + args.readlen].copy()
                for _ in range(int(rng.integers(0, 4))):
                    p = int(rng.integers(0, args.readlen))
                    seq[p] = (seq[p] + 1 + rng.integers(0, 3)) % 4
                if rng.integers(0, 2):
                    seq = dna.revcomp(seq)
                q = "".join(chr(33 + int(x)) for x in rng.integers(25, 40, args.readlen))
                f.write(f"@d{i}\n{dna.decode(seq)}\n+\n{q}\n")
        print(f"wrote {args.reads} reads", file=sys.stderr)

    # reference toolchain
    ref_idx = os.path.join(wd, "ref_idx")
    if not os.path.exists(ref_idx + ".1.bt2"):
        t0 = time.time()
        subprocess.run([os.path.join(args.refbuild, "bowtie2-build-s"), fa, ref_idx],
                       check=True, capture_output=True)
        print(f"reference build: {time.time()-t0:.1f}s", file=sys.stderr)
    ref_sam = os.path.join(wd, "ref.sam")
    t0 = time.time()
    subprocess.run([os.path.join(args.refbuild, "bowtie2-align-s"), "-x", ref_idx,
                    "-U", fq, "-S", ref_sam, "-p", "1"], check=True,
                   capture_output=True)
    ref_dt = time.time() - t0
    print(f"reference align: {ref_dt:.1f}s "
          f"({args.reads/ref_dt:.0f} reads/s, 1 core)", file=sys.stderr)

    # our toolchain
    our_idx = os.path.join(wd, "our_idx.npz")
    if not os.path.exists(our_idx):
        t0 = time.time()
        from omp_bowtie2_prime_tpu.cli import main as climain

        climain(["build", fa, our_idx])
        print(f"our build: {time.time()-t0:.1f}s", file=sys.stderr)
    our_sam = os.path.join(wd, "our.sam")
    t0 = time.time()
    from omp_bowtie2_prime_tpu.cli import main as climain

    climain(["align", "-x", our_idx, "-U", fq, "-S", our_sam])
    our_dt = time.time() - t0
    print(f"our align: {our_dt:.1f}s ({args.reads/our_dt:.0f} reads/s, "
          f"incl. startup)", file=sys.stderr)

    # compare
    def load(p):
        d = {}
        for l in open(p):
            if l.startswith("@"):
                continue
            f = l.rstrip("\n").split("\t")
            d[f[0]] = f
        return d

    ref, ours = load(ref_sam), load(our_sam)
    al_ref = {k for k, v in ref.items() if int(v[1]) & 4 == 0}
    al_ours = {k for k, v in ours.items() if int(v[1]) & 4 == 0}
    both = al_ref & al_ours
    posflag = sum(1 for k in both
                  if ref[k][1] == ours[k][1] and ref[k][3] == ours[k][3])
    mapq = sum(1 for k in both if ref[k][4] == ours[k][4])
    print(f"aligned: ref {len(al_ref)}, ours {len(al_ours)}")
    print(f"ref-only: {len(al_ref - al_ours)}, ours-only: {len(al_ours - al_ref)}")
    print(f"POS+FLAG match on co-aligned: {posflag}/{len(both)}")
    print(f"MAPQ match: {mapq}/{len(both)}")
    missed = sorted(al_ref - al_ours)[:10]
    if missed:
        print("examples ref-only:", missed)


if __name__ == "__main__":
    main()
