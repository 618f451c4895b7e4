"""Data-parallel sharding over a device mesh.

The reference's parallelism is OpenMP data-parallel over a resident read
batch (bt2_search.cpp:2302-2304, SURVEY §2.4). The device mapping:
every device phase (fused seed-search+SA-resolve, fused DP+backtrace) is
embarrassingly parallel over its leading batch axis, so the whole align
step shards over a 1-D 'data' mesh with the FM index replicated per
device; XLA inserts no collectives (pure SPMD data parallelism). The
mesh is the first n of jax.devices(): every device reaches every other
at the same rate, so the mesh needs no topology shape.

Multi-host: each host feeds its own FASTQ shard (deterministic merge by
read id — the analog of the reference's OutputQueue reorder contract,
outq.h:31-45). See parallel/distributed.py.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), ("data",))


class MeshPlacer:
    """Places phase inputs for SPMD parallelism: batch-leading arrays
    shard over 'data' (when present), the index replicates — or, when the
    mesh has a 'model' axis, shards row-wise across it (tensor-parallel
    index, parallel/tp_index.py) for genomes past one device's HBM."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        names = mesh.axis_names
        self.data_axis = "data" if "data" in names else None
        self.model_axis = (
            "model" if "model" in names and mesh.shape["model"] > 1 else None
        )
        self.batched = NamedSharding(
            mesh, P(self.data_axis) if self.data_axis else P()
        )
        self.repl = NamedSharding(mesh, P())
        self.ndev = mesh.devices.size

    def put_index(self, idx):
        if self.model_axis is not None:
            from .tp_index import shard_index

            return shard_index(idx, self.mesh, self.model_axis)
        return jax.tree.map(lambda a: jax.device_put(a, self.repl), idx)

    def put_batch(self, a):
        return jax.device_put(a, self.batched)

    def put_chunked(self, a):
        """Place [NC, lanes, ...] arrays whose leading dim is a device
        LOOP (lax.map chunk axis): shard the lane axis over 'data'."""
        spec = P(None, self.data_axis) if self.data_axis else P()
        return jax.device_put(a, NamedSharding(self.mesh, spec))


def full_align_step(idx, seeds, seed_valid, reads, pens, rdlens, refs,
                    wlens, swp, range_cap: int = 16):
    """The FULL production device step (fused search+resolve and fused
    DP+device-backtrace) as one jittable function — the compile/shard
    target for the multi-chip dry run; the host pipeline calls the two
    phases separately because their batch sizes differ."""
    from ..ops.seed_search import search_resolve_seeds
    from ..ops.sw import sw_e2e_backtrace_batch

    top, bot, starts, offs = search_resolve_seeds(
        idx, seeds, seed_valid, range_cap
    )
    best, bestcol, ops, startcol = sw_e2e_backtrace_batch(
        reads, pens, rdlens, refs, wlens, swp
    )
    return top, bot, starts, offs, best, bestcol, ops, startcol
