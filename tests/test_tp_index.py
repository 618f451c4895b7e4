"""Tensor-parallel FM-index: blocks/SA-sample sharded row-wise across a
'model' mesh axis with per-step psum recombination (parallel/tp_index.py,
ops/rank.py:_gather_block) — the device-mesh analog of the reference's shared
index (--mm/--shmem, SURVEY §2.4), lifting capacity past one device's
HBM. Everything must be bitwise the replicated-index result."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from omp_bowtie2_prime_tpu.index.builder import build_index_from_text
from omp_bowtie2_prime_tpu.index.fasta import join_references
from omp_bowtie2_prime_tpu.index.format import DeviceIndex
from omp_bowtie2_prime_tpu.io.fastq import Read
from omp_bowtie2_prime_tpu.models.aligner import TPUAligner
from omp_bowtie2_prime_tpu.ops.seed_search import search_resolve_seeds
from omp_bowtie2_prime_tpu.parallel.tp_index import (
    make_tp_mesh, shard_index, tp_hbm_per_device, tp_search_resolve_fn,
)
from omp_bowtie2_prime_tpu.utils import dna


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(3)
    text = rng.integers(0, 4, 50000).astype(np.int8)
    joined, refmap = join_references(["chrT"], [text.copy()])
    fm = build_index_from_text(joined, refmap, ftab_k=8)
    return rng, text, fm


def test_tp_search_resolve_bitwise(setup):
    rng, text, fm = setup
    idx = DeviceIndex.from_host(fm)
    S, L = 256, 22
    pos = rng.integers(0, len(text) - L, S)
    seeds = np.stack([text[p : p + L] for p in pos]).astype(np.int8)
    valid = np.ones(S, bool)
    lseed = rng.integers(0, 1 << 32, S, dtype=np.uint32)
    ref = jax.jit(search_resolve_seeds, static_argnums=(3, 4))(
        idx, seeds, valid, 16, 2, lane_seed=jnp.asarray(lseed)
    )
    mesh = make_tp_mesh(4, n_data=1)
    idx_tp = shard_index(idx, mesh)
    out = tp_search_resolve_fn(idx_tp, mesh, 16, 2)(
        idx_tp, jnp.asarray(seeds), jnp.asarray(valid),
        jnp.asarray(lseed)
    )
    for a, b in zip(ref, out):
        assert jnp.array_equal(a, b)


def test_tp_shards_divide_memory(setup):
    _, _, fm = setup
    idx = DeviceIndex.from_host(fm)
    mesh = make_tp_mesh(4, n_data=1)
    idx_tp = shard_index(idx, mesh)
    dev_blocks = {
        s.device for s in idx_tp.blocks.addressable_shards
    }
    assert len(dev_blocks) == 4
    per_shard = idx_tp.blocks.addressable_shards[0].data.shape[0]
    assert per_shard * 4 >= np.asarray(idx.blocks).shape[0]
    rep = tp_hbm_per_device(idx, 4)
    assert rep["tp_sharded"] < rep["replicated"]


def test_tp_aligner_end_to_end(setup):
    rng, text, fm = setup
    reads = []
    for i in range(48):
        p = int(rng.integers(0, len(text) - 100))
        s = text[p : p + 100].copy()
        s[int(rng.integers(0, 100))] = (s[50] + 1) % 4
        if rng.integers(0, 2):
            s = dna.revcomp(s)
        reads.append(Read(0, f"r{i}", s, np.full(100, 40, np.uint8)))
    plain = TPUAligner(fm).align_batch(reads)
    tp = TPUAligner(fm, mesh=make_tp_mesh(4, n_data=2)).align_batch(reads)
    for a, b in zip(plain, tp):
        assert (a.status, a.refoff, a.score, a.mapq, a.cigar) == (
            b.status, b.refoff, b.score, b.mapq, b.cigar
        )
