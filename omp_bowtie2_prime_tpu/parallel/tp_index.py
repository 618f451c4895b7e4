"""Tensor-parallel FM-index: shard the index itself across devices.

The reference shares ONE index across threads of a host (--mm mmap /
--shmem SysV, mm.h/shmem.h, SURVEY §2.4) — its capacity ceiling is host
RAM. The device analog shards the two large index arrays (interleaved
block records and the SA sample) row-wise across a mesh axis, so the
genome capacity ceiling becomes the mesh's combined device memory rather
than one device's. Queries stay lockstep-replicated: each rank/LF/walk
step gathers the 512-byte block record on its owner device and recombines
it everywhere with one psum (ops/rank.py:_gather_block / sa_lookup) —
compute is replicated, memory is divided by the axis size.

Composes with data parallelism: a ('data', 'model') mesh shards seed
lanes over 'data' while each data-replica's index shards over 'model'.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_tp_mesh(n_model: int, n_data: int = 1) -> Mesh:
    devs = np.asarray(jax.devices()[: n_model * n_data])
    return Mesh(devs.reshape(n_data, n_model), ("data", "model"))


def _pad_rows(a: np.ndarray, mult: int) -> np.ndarray:
    n = a.shape[0]
    pad = (-n) % mult
    if pad == 0:
        return a
    return np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)])


def shard_index(idx, mesh: Mesh, axis: str = "model"):
    """Places a DeviceIndex with blocks/sa_sample sharded row-wise over
    `axis` (padded to a multiple of the axis size) and everything else
    replicated; returns the placed index with its `tp` descriptor set.
    Must then be used inside shard_map (see tp_search_resolve_fn)."""
    d = mesh.shape[axis]
    blocks = _pad_rows(np.asarray(idx.blocks), d)
    sa = _pad_rows(np.asarray(idx.sa_sample), d)
    shard = NamedSharding(mesh, P(axis))
    repl = NamedSharding(mesh, P())
    placed = dataclasses.replace(
        idx,
        blocks=jax.device_put(blocks, shard),
        sa_sample=jax.device_put(sa, shard),
        fchr=jax.device_put(idx.fchr, repl),
        ftab=jax.device_put(idx.ftab, repl),
        ref_words=jax.device_put(idx.ref_words, repl),
        zoff=jax.device_put(idx.zoff, repl),
        nrows=jax.device_put(idx.nrows, repl),
        tp=(axis, blocks.shape[0] // d, sa.shape[0] // d),
    )
    return placed


def _index_specs(idx, axis: str):
    """PartitionSpec pytree matching a tp-sharded DeviceIndex."""
    return dataclasses.replace(
        idx, blocks=P(axis), sa_sample=P(axis), fchr=P(), ftab=P(),
        ref_words=P(), zoff=P(), nrows=P(),
    )


def tp_search_resolve_fn(idx, mesh: Mesh, range_cap: int, expand: int,
                         axis: str = "model", data_axis: str | None = None,
                         sample_seed: int = 0, sub_ftab: bool = False):
    """jitted shard_map wrapper of ops/seed_search.search_resolve_seeds
    for a tp-sharded index: seed lanes shard over `data_axis` (or
    replicate if None/absent), index blocks live sharded over `axis`,
    results come back replicated per data shard.  With a data axis the
    returned `starts` index each data shard's LOCAL offs buffer — the
    aligner's chunked host loop uses data_axis=None, where results are
    bitwise those of the replicated index."""
    from ..ops.seed_search import search_resolve_seeds

    dspec = P(data_axis) if data_axis and mesh.shape.get(data_axis, 1) > 1 \
        else P()

    def fn(idx_, seeds, valid, lane_seed):
        return search_resolve_seeds(
            idx_, seeds, valid, cap=range_cap, expand=expand,
            sample_seed=sample_seed, sub_ftab=sub_ftab,
            lane_seed=lane_seed,
        )

    mapped = jax.shard_map(
        fn, mesh=mesh,
        in_specs=(_index_specs(idx, axis), dspec, dspec, dspec),
        out_specs=(dspec, dspec, dspec, dspec),
        check_vma=False,
    )
    return jax.jit(mapped)


def tp_hbm_per_device(idx, n_model: int) -> dict:
    """Bytes per device for the sharded vs replicated layouts — the
    capacity win the sharding buys."""
    blocks = np.asarray(idx.blocks)
    sa = np.asarray(idx.sa_sample)
    big = blocks.nbytes + sa.nbytes
    rest = sum(
        np.asarray(a).nbytes
        for a in (idx.fchr, idx.ftab, idx.ref_words)
    )
    return {
        "replicated": big + rest,
        "tp_sharded": big // n_model + rest,
        "n_model": n_model,
    }
