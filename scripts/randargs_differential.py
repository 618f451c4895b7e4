#!/usr/bin/env python3
"""Randomized ARGUMENT-combination differential vs the reference binary.

The reference's scripts/sim harness aligns random genomes under random
argument combinations and cross-checks outputs (scripts/test/README.md:
31-43); this is that strategy pointed at our aligner: every trial draws a
random genome, random mutated reads, and a random policy-knob combination,
runs the reference binary and ours with the same knobs, and compares.

Checks per trial:
  - reads the reference aligns that we miss (expected: 0 — we emulate its
    budgets but search exhaustively within them)
  - POS+FLAG agreement on co-aligned reads with reference MAPQ >= 10
    (high-confidence unique placements must agree exactly)
  - MAPQ agreement on those same records

Usage: python scripts/randargs_differential.py [--trials 12] [--seed 1]
       [--refbuild /tmp/refbuild] [--workdir /tmp/bt2randargs]
"""

import argparse
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def draw_args(rng):
    """One random knob combination, as (ref_argv, our_argv, label)."""
    ref, ours = [], []

    def both(*a):
        ref.extend(a)
        ours.extend(a)

    preset = rng.choice([None, "--very-fast", "--fast", "--sensitive",
                         "--very-sensitive"])
    if preset is not None:
        both(str(preset))
    # seed length: few distinct values (each -L compiles a new seed-lane
    # shape through the slow device link)
    if rng.random() < 0.5:
        both("-L", str(rng.choice([20, 22, 25])))
    if rng.random() < 0.5:
        both("-i", f"S,1,{rng.choice([0.75, 1.15, 1.75, 2.5])}")
    if rng.random() < 0.5:
        mx = int(rng.integers(3, 8))
        mn = int(rng.integers(1, min(mx, 4)))
        both("--mp", f"{mx},{mn}")
    if rng.random() < 0.4:
        both("--np", str(int(rng.integers(0, 3))))
    if rng.random() < 0.4:
        both("--rdg", f"{int(rng.integers(3, 7))},{int(rng.integers(2, 5))}")
    if rng.random() < 0.4:
        both("--rfg", f"{int(rng.integers(3, 7))},{int(rng.integers(2, 5))}")
    if rng.random() < 0.4:
        both("--score-min",
             f"L,{rng.choice([0, -0.3, -0.6])},{rng.choice([-0.3, -0.6, -0.9])}")
    if rng.random() < 0.3:
        both("-D", str(int(rng.integers(5, 31))))
    if rng.random() < 0.3:
        both("-R", str(int(rng.integers(1, 4))))
    if rng.random() < 0.25:
        both("--ignore-quals")
    if rng.random() < 0.2:
        both(str(rng.choice(["--nofw", "--norc"])))
    if rng.random() < 0.2:
        both("--gbar", str(int(rng.integers(2, 9))))
    if rng.random() < 0.25:
        both("-5", str(int(rng.integers(1, 6))))
    if rng.random() < 0.25:
        both("-3", str(int(rng.integers(1, 6))))
    if rng.random() < 0.15:
        both("--xeq")  # =/X CIGARs; POS/FLAG/MAPQ comparison unaffected
    return ref, ours, " ".join(ref) or "(defaults)"


def draw_local_args(rng):
    """One random --local knob combination (VERDICT r4 item 5). The fork
    cannot run local mode at all (bt2_search.cpp:1345-1348 hard-rejects
    it), so these trials are validated by the local-mode ORACLE
    (scripts/oracle_check.py --local: window-optimal soft-clipped score
    + clip-geometry check) instead of a binary diff.  Returns
    (our_argv, oracle_argv, label) with the scoring knobs mirrored into
    the oracle invocation."""
    ours = [str(rng.choice(["--local", "--very-fast-local", "--fast-local",
                            "--sensitive-local", "--very-sensitive-local"]))]
    ma = 2
    oracle = ["--local"]
    if rng.random() < 0.4:
        ma = int(rng.integers(1, 4))
        ours += ["--ma", str(ma)]
    oracle += ["--ma", str(ma)]
    if rng.random() < 0.5:
        mx = int(rng.integers(3, 8))
        mn = int(rng.integers(1, min(mx, 4)))
        ours += ["--mp", f"{mx},{mn}"]
        oracle += ["--mp", f"{mx},{mn}"]
    if rng.random() < 0.4:
        np_ = int(rng.integers(0, 3))
        ours += ["--np", str(np_)]
        oracle += ["--np", str(np_)]
    if rng.random() < 0.4:
        g = f"{int(rng.integers(3, 7))},{int(rng.integers(2, 5))}"
        ours += ["--rdg", g]
        oracle += ["--rdg", g]
    if rng.random() < 0.4:
        g = f"{int(rng.integers(3, 7))},{int(rng.integers(2, 5))}"
        ours += ["--rfg", g]
        oracle += ["--rfg", g]
    if rng.random() < 0.4:
        # local min-score: G,a,b -> a + b*ln(rdlen) (scoring.h setLocal)
        ours += ["--score-min",
                 f"G,{rng.choice([8, 12, 20])},{rng.choice([4, 8])}"]
    if rng.random() < 0.5:
        ours += ["-L", str(rng.choice([20, 22, 25]))]
    if rng.random() < 0.4:
        ours += ["-i", f"S,1,{rng.choice([0.75, 1.15, 2.0])}"]
    if rng.random() < 0.3:
        ours += ["-D", str(int(rng.integers(5, 31)))]
    if rng.random() < 0.3:
        ours += ["-R", str(int(rng.integers(1, 4)))]
    if rng.random() < 0.25:
        ours += ["--ignore-quals"]
        oracle += ["--ignore-quals"]
    if rng.random() < 0.2:
        gb = str(int(rng.integers(2, 9)))
        ours += ["--gbar", gb]
        oracle += ["--gbar", gb]
    return ours, oracle, " ".join(ours)


def write_adapter_reads(f, text, n, rl, rng, prefix="a"):
    """Write n FASTQ reads with adapter read-through: a genome prefix of
    rl//2 .. rl-6 bases, then a random (foreign) tail — the clipping
    workload --local exists for (upstream manual: local trims). Half are
    reverse-complemented."""
    from omp_bowtie2_prime_tpu.utils import dna

    for i in range(n):
        pos = int(rng.integers(0, len(text) - rl))
        keep = int(rng.integers(rl // 2, rl - 5))
        seq = text[pos : pos + rl].copy()
        seq[keep:] = rng.integers(0, 4, rl - keep)
        if rng.integers(0, 2):
            seq = dna.revcomp(seq)
        q = "".join(chr(33 + int(x)) for x in rng.integers(20, 41, rl))
        f.write(f"@{prefix}{i}\n{dna.decode(seq)}\n+\n{q}\n")


def run_local_trials(args):
    """Oracle-validated randomized --local trials: for each drawn knob
    combination, align mutated reads (plus adapter-contaminated reads —
    the soft-clip case local mode exists for) and assert every sampled
    record's AS is the window-optimal local score with a valid clip
    geometry."""
    import numpy as np

    from omp_bowtie2_prime_tpu.cli import main as climain

    import math

    wd = args.workdir
    os.makedirs(wd, exist_ok=True)
    rng = np.random.default_rng(args.seed + 77)
    failures = 0
    done = 0
    t = -1
    while done < args.trials:
        t += 1
        rl = int(rng.choice([50, 76, args.readlen, 130]))
        fa, fq = make_trial_data(rng, wd, args.size, args.reads, rl)
        # append adapter-contaminated reads: genome prefix + foreign
        # tail, the clipping workload (upstream manual: local trims)
        if args.reads // 4:
            from omp_bowtie2_prime_tpu.index.fasta import parse_fasta

            with open(fq, "a") as f:
                write_adapter_reads(f, parse_fasta(fa)[1][0],
                                    args.reads // 4, rl, rng)
        our_argv, oracle_argv, label = draw_local_args(rng)
        print(f"[....] local trial {t}: {label}", flush=True)
        idx = os.path.join(wd, "idx")
        climain(["build", fa, idx + ".npz"])
        our_sam = os.path.join(wd, "our_local.sam")
        t0 = time.time()
        climain(["align", "-x", idx + ".npz", "-U", fq, "-S", our_sam,
                 *our_argv])
        r = subprocess.run(
            [sys.executable,
             os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "oracle_check.py"),
             fa, our_sam, "400", *oracle_argv],
            capture_output=True, text=True,
        )
        naln = sum(1 for ln in open(our_sam)
                   if not ln.startswith("@")
                   and not int(ln.split("\t", 2)[1]) & 0x104)
        nclip = sum(1 for ln in open(our_sam)
                    if not ln.startswith("@")
                    and "S" in ln.split("\t", 6)[5])
        ok = r.returncode == 0
        if naln == 0:
            # a zero-aligned trial is only a valid (vacuous) pass when
            # the drawn knobs make even a perfect read unalignable:
            # local min score = G,20,8 -> 20 + 8*ln(rl) vs ma*rl
            # (scoring.h setLocal; the upstream binary emits nothing
            # for such configs too). Anything else aligning zero is a
            # failure, and either way it contributes no oracle
            # evidence — run a replacement trial.
            ma = 2
            if "--ma" in our_argv:
                ma = int(our_argv[our_argv.index("--ma") + 1])
            floor = 20.0 + 8.0 * math.log(rl)
            expected_zero = ma * rl < floor
            if not expected_zero:
                ok = False
            status = "OK-0" if ok else "FAIL"
            print(f"[{status}] local trial {t}: vacuous (aligned 0, "
                  f"ma*rl={ma * rl} < G-floor {floor:.1f}: "
                  f"{expected_zero}); replacement drawn", flush=True)
            if not ok:
                failures += 1
            continue
        done += 1
        if not ok:
            failures += 1
            print(r.stdout.strip())
        status = "OK  " if ok else "FAIL"
        print(f"[{status}] local trial {t}: "
              f"{r.stdout.strip().splitlines()[-1] if r.stdout else '?'} "
              f"(aligned {naln}, soft-clipped {nclip}, "
              f"{time.time()-t0:.0f}s)", flush=True)
    print(f"\n{done - failures}/{done} non-vacuous local trials clean "
          f"(+{t + 1 - done} vacuous)")
    sys.exit(1 if failures else 0)


def make_trial_data(rng, wd, size, nreads, readlen):
    from omp_bowtie2_prime_tpu.utils import dna

    text = rng.integers(0, 4, size).astype(np.int8)
    fa = os.path.join(wd, "g.fa")
    with open(fa, "w") as f:
        f.write(">t\n")
        s = dna.decode(text)
        for i in range(0, len(s), 70):
            f.write(s[i : i + 70] + "\n")
    fq = os.path.join(wd, "r.fq")
    with open(fq, "w") as f:
        for i in range(nreads):
            pos = int(rng.integers(0, size - readlen))
            seq = text[pos : pos + readlen].copy()
            for _ in range(int(rng.integers(0, 4))):
                p = int(rng.integers(0, readlen))
                seq[p] = (seq[p] + 1 + rng.integers(0, 3)) % 4
            if rng.integers(0, 2):
                seq = dna.revcomp(seq)
            # low-quality tails with some probability: exercises the
            # qual-scaled MM penalty interpolation (scoring.h mmpens)
            lo = 2 if rng.random() < 0.3 else 20
            q = "".join(chr(33 + int(x))
                        for x in rng.integers(lo, 41, readlen))
            f.write(f"@d{i}\n{dna.decode(seq)}\n+\n{q}\n")
    return fa, fq


def load_sam(p):
    d = {}
    for line in open(p):
        if line.startswith("@"):
            continue
        f = line.rstrip("\n").split("\t")
        if int(f[1]) & 0x104:  # unmapped or secondary
            continue
        d[f[0]] = (int(f[1]) & 16, int(f[3]), int(f[4]))
    return d


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=12)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--size", type=int, default=400_000)
    ap.add_argument("--reads", type=int, default=1500)
    ap.add_argument("--readlen", type=int, default=100)
    ap.add_argument("--refbuild", default="/tmp/refbuild")
    ap.add_argument("--workdir", default="/tmp/bt2randargs")
    ap.add_argument("--local", action="store_true",
                    help="oracle-validated --local trials instead of the "
                         "reference-binary differential (VERDICT r4 "
                         "item 5: the fork hard-rejects local mode)")
    args = ap.parse_args()

    if args.local:
        run_local_trials(args)

    os.makedirs(args.workdir, exist_ok=True)
    wd = args.workdir
    rng = np.random.default_rng(args.seed)
    from omp_bowtie2_prime_tpu.cli import main as climain

    failures = 0
    for t in range(args.trials):
        # vary read length per trial (<=130: beyond 138 the reference's
        # 200-col SSE envelope makes reads unalignable for it, a known
        # capability divergence, not a bug to flag here)
        rl = int(rng.choice([50, 76, args.readlen, 130]))
        fa, fq = make_trial_data(rng, wd, args.size, args.reads, rl)
        ref_argv, our_argv, label = draw_args(rng)
        print(f"[....] trial {t}: {label}", flush=True)
        idx = os.path.join(wd, "idx")
        # one .bt2 index serves both sides (our writer is byte-identical)
        climain(["build", "--bt2", fa, idx])
        climain(["build", fa, idx + ".npz"])
        ref_sam, our_sam = os.path.join(wd, "ref.sam"), os.path.join(wd, "our.sam")
        t0 = time.time()
        subprocess.run(
            [os.path.join(args.refbuild, "bowtie2-align-s"), "-x", idx,
             "-U", fq, "-S", ref_sam, "-p", "1", *ref_argv],
            check=True, capture_output=True,
        )
        climain(["align", "-x", idx + ".npz", "-U", fq, "-S", our_sam,
                 *our_argv])
        ref, ours = load_sam(ref_sam), load_sam(our_sam)
        co = set(ref) & set(ours)
        ref_only = len(set(ref) - set(ours))
        hi = [q for q in co if ref[q][2] >= 10]
        pf = sum(1 for q in hi if ref[q][:2] == ours[q][:2])
        mq = sum(1 for q in hi if ref[q][2] == ours[q][2])
        ok = ref_only == 0 and pf == len(hi) and mq == len(hi)
        status = "OK  " if ok else "FAIL"
        if not ok:
            failures += 1
        print(f"[{status}] trial {t}: {label}")
        print(f"        ref {len(ref)} ours {len(ours)} ref-only {ref_only}; "
              f"hi-conf POS+FLAG {pf}/{len(hi)} MAPQ {mq}/{len(hi)} "
              f"({time.time()-t0:.0f}s)", flush=True)
        if not ok:
            bad = [q for q in hi if ref[q][:2] != ours[q][:2]
                   or ref[q][2] != ours[q][2]][:6]
            for q in bad:
                print(f"        {q}: ref={ref[q]} ours={ours[q]}")
    print(f"\n{args.trials - failures}/{args.trials} trials clean")
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
