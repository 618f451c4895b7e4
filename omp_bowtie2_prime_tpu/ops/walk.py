"""Batched SA-offset resolution ("group walk").

Device analog of GroupWalk2/GWState (group_walk.h:263-554) and
Ebwt::getOffset (bt2_idx.cpp:149-171). Because this index samples by TEXT
position (every SA value % srate == 0 is marked; see index/format.py), every
walk terminates within srate-1 LF steps, so the kernel is a fixed
srate-iteration masked loop over [B] lanes — no unbounded chase, no
per-element host control flow.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from . import rank


def resolve_rows(idx, rows: jnp.ndarray, valid: jnp.ndarray,
                 nlive=None, tile: int = 65536) -> jnp.ndarray:
    """Resolve BWT rows -> joined-text offsets.

    rows: int32 [B]; valid: bool [B]. Returns int32 [B] joined offsets,
    -1 for invalid lanes.

    nlive (traced scalar, optional): number of LIVE lanes, which the
    caller's cumsum compaction guarantees occupy the PREFIX [0, nlive)
    (ops/seed_search.search_resolve_seeds slot layout).  The walk then
    runs tile-by-tile under a while_loop and stops at the live
    prefix — the fixed-shape fori walk gathered srate+1 block rows for
    EVERY slot including the dead tail (typically ~2/3 of the buffer at
    genome scale: slot demand ~0.37/lane vs the expand=1.0 sizing), and
    those wasted 512 B gathers were the second-largest term in the
    searchResolve HBM budget (scripts/roofline_searchresolve.py).
    """
    rows = rows.astype(idx.fchr.dtype)
    B = rows.shape[0]
    if nlive is not None and B > tile and B % tile == 0:
        ntiles = B // tile

        def cond(c):
            t, _ = c
            return t * tile < nlive

        def body(c):
            t, out = c
            sl = jax.lax.dynamic_slice(rows, (t * tile,), (tile,))
            vl = jax.lax.dynamic_slice(valid, (t * tile,), (tile,))
            r = resolve_rows(idx, sl, vl)
            return t + 1, jax.lax.dynamic_update_slice(out, r, (t * tile,))

        out0 = jnp.full(B, -1, idx.fchr.dtype)
        _, out = jax.lax.while_loop(
            cond, body, (jnp.zeros((), jnp.int32), out0)
        )
        return out

    def step(_, carry):
        row, steps, done, rnk = carry
        # fused mark-test + LF from one block gather (rank.walk_step)
        marked, r, nrow = rank.walk_step(idx, row)
        hit = marked & ~done & valid
        # record the mark rank; the SA-sample gather happens ONCE after
        # the loop (an in-loop sa_lookup issued srate gathers per lane
        # where one suffices — the walk loop is gather-bound).  int32
        # always (nmarked < 2^31 at any .bt2l scale; under x64 the
        # popcount-sum arithmetic promotes, so pin the carry dtype)
        rnk = jnp.where(hit, r.astype(jnp.int32), rnk)
        done = done | hit
        # step left where not yet done (safe: zoff is marked, so lf_row
        # is never evaluated "through" the sentinel for live lanes)
        row = jnp.where(done, row, nrow)
        steps = jnp.where(done, steps, steps + 1)
        return row, steps, done, rnk

    init = (
        rows,
        jnp.zeros(B, rows.dtype),
        jnp.zeros(B, jnp.bool_),
        jnp.zeros(B, jnp.int32),
    )
    _, steps, done, rnk = jax.lax.fori_loop(0, idx.srate, step, init)
    off = rank.sa_lookup(idx, rnk) + steps
    return jnp.where(valid & done, off, -1)
