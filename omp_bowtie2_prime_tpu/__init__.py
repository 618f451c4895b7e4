"""omp_bowtie2_prime_tpu — a JAX short-read DNA aligner.

A from-scratch JAX/XLA re-design of the capabilities of
sfiligoi/omp-bowtie2-prime (an OpenMP-batched bowtie2 fork):

- FM-index (BWT + checkpointed occ) exact-seed backward search
- bounded group-walk SA resolution (text-position sampled, <=15 LF steps)
- banded end-to-end Smith-Waterman seed extension as a batched
  column-vectorized row-scan kernel
- bowtie2-compatible scoring presets, MAPQ, SAM emission

Layout:
    index/     host index builder + device repack (ref: bt2_idx.h, bt2_build.cpp)
    ops/       device kernels: rank/LF, seed search, SA walk, SW DP
    models/    end-to-end alignment pipelines (ref: bt2_search.cpp worker phases)
    io/        FASTQ/FASTA parsing + SAM emission (ref: pat.cpp, sam.cpp)
    parallel/  jax.sharding mesh, data-parallel read batches
    utils/     scoring, MAPQ, CIGAR, DNA encoding (ref: scoring.h, unique.h)
"""

__version__ = "0.1.0"
