"""Regression: re-executing the fused rank/frame mega across mixed chunk
counts.

Module-level jnp scalar constants (ops/rank.py _EVEN/_FULL, ops/
rank_frame.py BIG) are device arrays that every trace captures as
runtime-supplied executable constants, and the jax-0.9 pjit C++ fast
path fails to supply them when signatures with different constant sets
interleave: the SECOND execution of the one-chunk signature after a
multi-chunk call raised "Execution supplied 15 buffers but compiled
program expected 19 buffers". Those constants are numpy scalars now;
this pins the NC5 -> NC1 -> NC1 -> NC5 -> NC1 sequence that reproduced
it.
"""

import numpy as np
import pytest


def _mk_args(idx, fm, nc, sb=2048, npad=256, seed_len=10):
    import jax.numpy as jnp

    rng = np.random.default_rng(nc)
    # packed read matrix (code | pen << 4); seeds gather from it on device
    matpk = (rng.integers(0, 4, (2 * npad, 64)).astype(np.uint8)
             | np.uint8(6 << 4))
    src2 = rng.integers(0, 2 * npad, (nc, sb)).astype(np.int32)
    off2 = rng.integers(0, 64 - seed_len, (nc, sb)).astype(np.int32)
    eff2 = np.full((nc, sb), seed_len, np.int32)
    valid2 = np.zeros((nc, sb), bool)
    valid2[:, :64] = True
    S = nc * sb
    return (
        idx, jnp.asarray(matpk), jnp.asarray(src2), jnp.asarray(off2),
        jnp.asarray(eff2), jnp.asarray(valid2),
        jnp.asarray(np.zeros((nc, sb), np.uint32)),
        jnp.asarray(np.zeros(S, np.int32)),
        jnp.asarray(np.zeros(S, bool)),
        jnp.asarray(np.zeros(S, np.int32)),
        jnp.asarray(np.full(npad, 50, np.int32)),
        jnp.asarray(np.full(npad, 5, np.int32)),
        jnp.asarray(np.ones(npad, bool)),
        np.int32(fm.n),
    )


def test_mega_mixed_chunk_count_reexecution():
    from omp_bowtie2_prime_tpu.index.builder import build_index_from_text
    from omp_bowtie2_prime_tpu.index.fasta import join_references
    from omp_bowtie2_prime_tpu.index.format import DeviceIndex
    from omp_bowtie2_prime_tpu.models import aligner as A

    rng = np.random.default_rng(3)
    text = rng.integers(0, 4, 5000).astype(np.int8)
    joined, refmap = join_references(["c"], [text])
    fm = build_index_from_text(joined, refmap, ftab_k=7)
    idx = DeviceIndex.from_host(fm)

    kw = dict(range_cap=16, expand=4, max_elts=400, max_dp=300,
              p_cap=A.P_CAP, seed_len=10)
    a3 = _mk_args(idx, fm, 3)
    a1 = _mk_args(idx, fm, 1)
    # the failing sequence: multi-chunk, then one-chunk twice (second
    # one-chunk execution used to die in the pjit C++ fast path), then
    # interleave again
    outs = []
    for args in (a3, a1, a1, a3, a1):
        outs.append(np.asarray(A._rank_frame_mega(*args, **kw)))
    np.testing.assert_array_equal(outs[1], outs[2])
    np.testing.assert_array_equal(outs[1], outs[4])
    np.testing.assert_array_equal(outs[0], outs[3])


def test_no_module_level_device_constants():
    """Module-level jnp constants (device arrays) in ops/models/parallel
    would re-introduce the fast-path fault — keep them numpy."""
    import importlib
    import pkgutil

    import jax

    import omp_bowtie2_prime_tpu as pkg

    bad = []
    for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        mod = importlib.import_module(m.name)
        for name, val in vars(mod).items():
            if isinstance(val, jax.Array):
                bad.append(f"{m.name}.{name}")
    assert not bad, f"module-level device arrays: {bad}"
