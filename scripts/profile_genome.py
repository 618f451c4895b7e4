#!/usr/bin/env python3
"""Genome-scale phase profile.

Builds (and caches) a synthetic genome index at the requested size,
synthesizes mutated reads, and measures steady-state align_batch
throughput on the default JAX device with PhaseTimers (per-phase
table).

Usage:
  PYTHONPATH=/root/repo python scripts/profile_genome.py \
      [--size 46000000] [--reads 100000] [--readlen 100] [--batch 16384] \
      [--iters 3] [--workdir /tmp/bt2prof]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def synth_reads(text, n, readlen, rng):
    """Mutated reads sampled from text (differential.py protocol)."""
    from omp_bowtie2_prime_tpu.utils import dna
    from omp_bowtie2_prime_tpu.io.fastq import Read

    size = len(text)
    pos = rng.integers(0, size - readlen, n)
    nmut = rng.integers(0, 4, n)
    reads = []
    qual_pool = rng.integers(25, 40, (256, readlen)).astype(np.uint8)
    for i in range(n):
        seq = text[pos[i] : pos[i] + readlen].copy()
        for _ in range(int(nmut[i])):
            p = int(rng.integers(0, readlen))
            seq[p] = (seq[p] + 1 + rng.integers(0, 3)) % 4
        if nmut[i] & 1:
            seq = dna.revcomp(seq)
        reads.append(Read(rdid=i, name=f"r{i}",
                          seq=np.ascontiguousarray(seq),
                          qual=qual_pool[i & 255]))
    return reads


def synth_pairs(text, n, readlen, rng, frag_lo=250, frag_hi=450):
    """Mutated --fr pairs: a fragment of frag_lo..frag_hi bases, mate 1
    its forward prefix, mate 2 the reverse complement of its suffix, each
    with 0-3 substitutions (synth_reads' protocol); half the pairs swap
    mates. Fragments stay inside the default -X 500."""
    from omp_bowtie2_prime_tpu.utils import dna
    from omp_bowtie2_prime_tpu.io.fastq import Read

    frag = rng.integers(frag_lo, frag_hi + 1, n)
    pos = rng.integers(0, len(text) - frag_hi, n)
    qual_pool = rng.integers(25, 40, (256, readlen)).astype(np.uint8)
    pairs = []
    for i in range(n):
        p, f = int(pos[i]), int(frag[i])
        m1 = text[p : p + readlen].copy()
        m2 = dna.revcomp(text[p + f - readlen : p + f])
        for s in (m1, m2):
            for _ in range(int(rng.integers(0, 4))):
                j = int(rng.integers(0, readlen))
                s[j] = (s[j] + 1 + rng.integers(0, 3)) % 4
        if rng.integers(0, 2):
            m1, m2 = m2, m1
        pairs.append((
            Read(rdid=i, name=f"p{i}", seq=np.ascontiguousarray(m1),
                 qual=qual_pool[(2 * i) & 255]),
            Read(rdid=i, name=f"p{i}", seq=np.ascontiguousarray(m2),
                 qual=qual_pool[(2 * i + 1) & 255]),
        ))
    return pairs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=46_000_000)
    ap.add_argument("--reads", type=int, default=100_000)
    ap.add_argument("--readlen", type=int, default=100)
    ap.add_argument("--batch", type=int, default=16384)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workdir", default="/tmp/bt2prof")
    ap.add_argument("--build-only", action="store_true",
                    help="build+save the index and exit (no device use)")
    ap.add_argument("--cprofile", default=None, metavar="OUT.pstats",
                    help="wrap the measured iterations in cProfile and "
                         "dump stats (host-phase attribution; use on CPU)")
    ap.add_argument("--pipe", action="store_true",
                    help="-p2 overlap mode: two align workers over "
                         "interleaved batches (host phases hide behind "
                         "the other worker's device waits)")
    ap.add_argument("--stream", action="store_true",
                    help="single-thread cross-batch software pipeline "
                         "(align_stream): batch k+1's round-0 mega is "
                         "queued before batch k's host phases")
    args = ap.parse_args()

    os.makedirs(args.workdir, exist_ok=True)
    t0 = time.time()
    import jax

    print(f"## devices {jax.devices()} init={time.time()-t0:.1f}s",
          flush=True)

    from omp_bowtie2_prime_tpu.index.format import FMIndex
    from omp_bowtie2_prime_tpu.models.aligner import TPUAligner

    tag = f"{args.size//1_000_000}M"
    idx_path = os.path.join(args.workdir, f"idx{tag}.npz")
    txt_path = os.path.join(args.workdir, f"text{tag}.npy")
    rng = np.random.default_rng(args.seed)
    if not os.path.exists(idx_path):
        from omp_bowtie2_prime_tpu.index.builder import build_index_from_text
        from omp_bowtie2_prime_tpu.index.fasta import join_references

        text = rng.integers(0, 4, args.size).astype(np.int8)
        np.save(txt_path, text)
        t0 = time.time()
        joined, refmap = join_references(["synth"], [text])
        fm = build_index_from_text(joined, refmap)
        print(f"## build {time.time()-t0:.1f}s", flush=True)
        fm.save(idx_path)
    else:
        rng.integers(0, 4, args.size)  # keep the read stream identical
        text = np.load(txt_path)
    if args.build_only:
        print("## build-only done", flush=True)
        return
    t0 = time.time()
    fm = FMIndex.load(idx_path)
    print(f"## load {time.time()-t0:.1f}s", flush=True)

    t0 = time.time()
    reads = synth_reads(text, args.reads, args.readlen, rng)
    print(f"## synth {args.reads} reads {time.time()-t0:.1f}s", flush=True)

    al = TPUAligner(fm)
    # warmup (compile + cache)
    t0 = time.time()
    al.align_batch(reads[: args.batch])
    print(f"## warmup {time.time()-t0:.1f}s", flush=True)
    al2 = None
    if args.pipe or args.stream:
        from omp_bowtie2_prime_tpu.models.pipeline import (
            align_stream, run_pipeline,
        )

        al2 = TPUAligner(fm, share=al)
        t0 = time.time()
        al2.align_batch(reads[: args.batch])
        print(f"## warmup2 {time.time()-t0:.1f}s", flush=True)

    prof = None
    if args.cprofile:
        import cProfile

        prof = cProfile.Profile()
        prof.enable()
    best = None
    for it in range(args.iters):
        al.timers.reset()
        t0 = time.time()
        naligned = 0
        if args.stream:
            al2.timers.reset()
            batches = [reads[lo : lo + args.batch]
                       for lo in range(0, len(reads), args.batch)]
            outs = align_stream([al, al2], batches)
            naligned = sum(1 for rs in outs for r in rs
                           if r.status == "aligned")
        elif args.pipe:
            batches = [reads[lo : lo + args.batch]
                       for lo in range(0, len(reads), args.batch)]
            out = {}
            run_pipeline(
                iter(enumerate(batches)), None,
                lambda b, r: out.__setitem__(b[0], r),
                align_fns=[lambda b: al.align_batch(b[1]),
                           lambda b: al2.align_batch(b[1])],
            )
            naligned = sum(1 for rs in out.values() for r in rs
                           if r.status == "aligned")
        else:
            for lo in range(0, len(reads), args.batch):
                res = al.align_batch(reads[lo : lo + args.batch])
                naligned += sum(1 for r in res if r.status == "aligned")
        dt = time.time() - t0
        rps = len(reads) / dt
        print(f"## iter{it} {dt:.2f}s rps={rps:.0f} aligned={naligned}",
              flush=True)
        if best is None or dt < best:
            best = dt
            al.timers.report()
            if al2 is not None:
                al2.timers.report()
            sys.stderr.flush()
    if prof is not None:
        prof.disable()
        prof.dump_stats(args.cprofile)
        print(f"## cprofile -> {args.cprofile}", flush=True)
    print(f"## best rps={len(reads)/best:.0f} batch={args.batch}",
          flush=True)
    m = al.metrics
    print(f"## metrics {m.render()}", flush=True)


if __name__ == "__main__":
    main()
