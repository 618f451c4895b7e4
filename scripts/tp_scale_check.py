#!/usr/bin/env python3
"""tp-index at GRCh38 table scale: does the sharded executable compile
and execute at 23.4M block records? (VERDICT r4 item 3 / weak #4.)

A fori-gather comparator once sat >30 min in the compiler at this table
size — a concrete risk that the tp-sharded search/resolve might not
compile at the scale that motivates it. This check loads the real
3.1 Gbp index, shards blocks + SA sample over an 8-way 'model' axis on
the virtual CPU mesh, jits the
fused search_resolve mega at a production lane count, and records
compile wall + one execution + per-device resident bytes.  Identity vs
the replicated index is NOT re-proven here (it is pinned at 46 Mbp by
scripts/multichip_bench.py and at 50 Kbp by tests/test_tp_index.py);
at 3.1 Gbp a replicated comparison would need a second 13.5 GB copy
per "device" on one host.

  JAX_PLATFORM_NAME=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python scripts/tp_scale_check.py [--idx /tmp/bt2prof/idx3100M.npz]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ.setdefault("JAX_PLATFORM_NAME", "cpu")
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--idx", default="/tmp/bt2prof/idx3100M.npz")
    ap.add_argument("--ndev", type=int, default=8)
    ap.add_argument("--lanes", type=int, default=16384)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from omp_bowtie2_prime_tpu.index.format import DeviceIndex, FMIndex
    from omp_bowtie2_prime_tpu.parallel.tp_index import (
        make_tp_mesh, shard_index, tp_hbm_per_device, tp_search_resolve_fn,
    )

    t0 = time.time()
    fm = FMIndex.load(args.idx)
    print(f"loaded n={fm.n} ({time.time()-t0:.0f}s)", flush=True)
    t0 = time.time()
    idx = DeviceIndex.from_host(fm)
    nblocks = int(np.asarray(idx.blocks).shape[0])
    print(f"device index: {nblocks} block records "
          f"({time.time()-t0:.0f}s)", flush=True)
    hbm = tp_hbm_per_device(idx, args.ndev)
    print(f"bytes/device sharded {hbm['tp_sharded']/1e9:.2f} GB vs "
          f"replicated {hbm['replicated']/1e9:.2f} GB", flush=True)

    mesh = make_tp_mesh(args.ndev, n_data=1)
    t0 = time.time()
    idx_tp = shard_index(idx, mesh)
    print(f"sharded over {args.ndev}-way model axis "
          f"({time.time()-t0:.0f}s)", flush=True)

    # production-shaped seed lanes (22 bp multiseed rows)
    rng = np.random.default_rng(0)
    S, L = args.lanes, 22
    text = None  # random seeds: content does not affect compile
    seeds = rng.integers(0, 4, (S, L)).astype(np.int8)
    valid = np.ones(S, bool)
    lseed = rng.integers(0, 1 << 32, S, dtype=np.uint32)

    fn = tp_search_resolve_fn(idx_tp, mesh, range_cap=16, expand=4)
    t0 = time.time()
    lowered = fn.lower(idx_tp, jnp.asarray(seeds), jnp.asarray(valid),
                       jnp.asarray(lseed))
    print(f"lowered ({time.time()-t0:.1f}s)", flush=True)
    t0 = time.time()
    compiled = lowered.compile()
    t_compile = time.time() - t0
    print(f"COMPILED in {t_compile:.1f}s at {nblocks} blocks", flush=True)
    t0 = time.time()
    out = compiled(idx_tp, jnp.asarray(seeds), jnp.asarray(valid),
                   jnp.asarray(lseed))
    out = [np.asarray(o) for o in out]
    t_exec = time.time() - t0
    nz = int((out[0] > 0).sum()) if len(out) else -1
    print(f"EXECUTED in {t_exec:.1f}s; first-output nonzero rows: {nz}",
          flush=True)
    print(f"RESULT: ok compile={t_compile:.1f}s exec={t_exec:.1f}s "
          f"blocks={nblocks} lanes={S}", flush=True)


if __name__ == "__main__":
    main()
