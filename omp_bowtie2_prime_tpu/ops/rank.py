"""Batched FM-index rank / LF-mapping device ops.

The reference's hot op (ref: countBt2Side / mapLF / mapBiLFEx,
bt2_idx.h:1811-2472) counts base c in BWT[0:i) via per-side checkpoints +
popcount with an XOR mask trick (countInU64Ex, bt2_idx.h:2029-2083). Like
the reference's interleaved "sides" (EbwtParams, bt2_idx.h:112-279), the
device layout interleaves everything a query needs into ONE block record
(BWT words + occ checkpoints + SA-mark bits + mark rank checkpoint,
index/format.py DEV_* layout) so every rank / LF / group-walk step is a
single [B]-lane gather followed by popcounts. These ops are
memory-latency bound; one gather per step instead of three is the device
analog of the reference's software prefetch of sides (bt2_idx.h:370-398).

The record row is 128 uint32 words (512 B, 1024 BWT rows per record), and
the ftab and SA-sample lookups use the same 128-lane rows with a
compare-select of the wanted lane instead of a scalar gather. The layout
was chosen for the gather unit of the original accelerator and is
unmeasured on this device (index/format.py DEV_* notes).

All ops take a DeviceIndex and int32/int64 row vectors; everything is
jittable with static shapes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..index.format import (
    DEV_BWT, DEV_BWT_WORDS, DEV_FTAB_PER_ROW, DEV_MARK, DEV_MARKCP,
    DEV_MARK_WORDS, DEV_OCC, DEV_OCC_BLOCK, DEV_SA_PER_ROW, WORD_BASES,
)

# numpy (not jnp) scalars: module-level jnp constants are device arrays
# that every trace captures as *runtime-supplied* executable constants,
# and the jax-0.9 pjit C++ fast path drops them on re-execution
# ("Execution supplied N buffers but compiled program expected N+k").
# numpy scalars bake into the HLO as literals instead.
_EVEN = np.uint32(0x55555555)
_FULL = np.uint32(0xFFFFFFFF)


def _pair_limit_mask(nbases):
    """uint32 mask selecting the even (pair-flag) bits of the first
    `nbases` 2-bit pairs of a word; nbases in [0, 16]."""
    nb = jnp.clip(nbases, 0, WORD_BASES)
    sh = jnp.where(nb >= WORD_BASES, 0, 2 * nb).astype(jnp.uint32)
    part = (jnp.uint32(1) << sh) - jnp.uint32(1)
    return jnp.where(nb >= WORD_BASES, _FULL, part) & _EVEN


def _count_pairs_eq(words, c, limit_masks):
    """Count 2-bit pairs equal to c within the masked region.

    words: uint32 [..., W]; c: int32 broadcastable to [...]; limit_masks:
    uint32 [..., W] from _pair_limit_mask. XOR-mask trick: pair == c iff
    (pair ^ c) == 0; OR the two bits of each pair down onto the even bit.
    """
    cmask = jnp.uint32(0x55555555) * c.astype(jnp.uint32)
    x = words ^ cmask[..., None]
    y = x | (x >> 1)
    z = jnp.bitwise_not(y) & limit_masks
    return jax.lax.population_count(z).astype(jnp.int32).sum(axis=-1)


def _word_limits(k):
    """Per-word base counts for an in-block offset k: [..., W] in [0,16]."""
    j = jnp.arange(DEV_BWT_WORDS, dtype=jnp.int32) * WORD_BASES
    return jnp.clip(k[..., None] - j, 0, WORD_BASES)


def _select_minor(mat, i, n: int):
    """mat[..., i] for per-lane i in [0, n) WITHOUT a gather: a
    compare-select over the (tiny) minor dim (chosen for the original
    accelerator, where 1-element gathers are slow; unmeasured on this
    device)."""
    sel = i[..., None] == jnp.arange(n, dtype=jnp.int32)
    return jnp.sum(jnp.where(sel, mat[..., :n], 0), axis=-1)


def small_lookup(table, i, n: int):
    """table[i] for a small 1-D table (fchr and friends) via compare-select
    instead of a scalar gather."""
    return _select_minor(
        jnp.broadcast_to(table[:n], i.shape + (n,)), i, n
    )


def ftab_lookup(idx, q):
    """(top, bot) = ftab[q]: ONE tile-row gather of the interleaved
    [ceil(4^k/64), 128] table, lanes [q%64] / [64 + q%64]."""
    rowdt = idx.fchr.dtype
    row = idx.ftab[q // DEV_FTAB_PER_ROW]
    lane = (q % DEV_FTAB_PER_ROW).astype(jnp.int32)
    top = _select_minor(row[..., :DEV_FTAB_PER_ROW], lane, DEV_FTAB_PER_ROW)
    bot = _select_minor(row[..., DEV_FTAB_PER_ROW:], lane, DEV_FTAB_PER_ROW)
    return top.astype(rowdt), bot.astype(rowdt)


def _gather_block(idx, rows):
    """ONE gather of the interleaved block record. Returns
    (blk [B, DEV_BLOCK_U32] uint32, k [B] int32 in-block offset).

    Tensor-parallel path (idx.tp set, inside shard_map): each device holds
    a contiguous 1/D slice of the block records (parallel/tp_index.py);
    the owner gathers locally and one psum of the 512-byte record
    reconstructs it on every device — the device-mesh analog of the
    reference's
    shared-memory index (--mm/--shmem, SURVEY §2.4), except the index
    exceeds ONE device's memory rather than one host's."""
    b = rows // DEV_OCC_BLOCK
    k = (rows % DEV_OCC_BLOCK).astype(jnp.int32)
    if idx.tp is None:
        return idx.blocks[b], k
    ax, nblk_loc, _ = idx.tp
    base = jax.lax.axis_index(ax).astype(b.dtype) * nblk_loc
    lb = b - base
    mine = (lb >= 0) & (lb < nblk_loc)
    blk = idx.blocks[jnp.where(mine, lb, 0)]
    blk = jnp.where(mine[..., None], blk, jnp.uint32(0))
    return jax.lax.psum(blk, ax), k


def sa_lookup(idx, r):
    """idx.sa_sample[r] ([m, 128] uint32 tile rows), tensor-parallel
    aware: the SA sample is the other large index array, sharded row-wise
    with the same owner-gather + psum recombination."""
    rowdt = idx.fchr.dtype
    lane = (r % DEV_SA_PER_ROW).astype(jnp.int32)
    if idx.tp is None:
        rec = idx.sa_sample[r // DEV_SA_PER_ROW]
        return _select_minor(rec, lane, DEV_SA_PER_ROW).astype(rowdt)
    ax, _, nsa_loc = idx.tp
    row = r // DEV_SA_PER_ROW
    base = jax.lax.axis_index(ax).astype(row.dtype) * nsa_loc
    lrow = row - base
    mine = (lrow >= 0) & (lrow < nsa_loc)
    rec = idx.sa_sample[jnp.where(mine, lrow, 0)]
    rec = jnp.where(mine[..., None], rec, jnp.uint32(0))
    rec = jax.lax.psum(rec, ax)
    return _select_minor(rec, lane, DEV_SA_PER_ROW).astype(rowdt)


def _occ_from_block(blk, k, c, rows, zoff):
    rowdt = rows.dtype
    words = blk[..., DEV_BWT : DEV_BWT + DEV_BWT_WORDS]
    cp = _select_minor(
        blk[..., DEV_OCC : DEV_OCC + 4].astype(rowdt), c, 4
    )
    limits = _pair_limit_mask(_word_limits(k))
    cnt = cp + _count_pairs_eq(words, c, limits).astype(rowdt)
    adj = ((c == 0) & (rows > zoff)).astype(rowdt)
    return cnt - adj


def occ(idx, c, rows):
    """occ(c, row) = #{i < row : BWT[i] == c}, batched.

    c, rows: int32 [B]. Adjusts for the dummy char (stored as 0) at zoff
    (ref: Ebwt's $-handling around _zOff, bt2_idx.h:2372-2424).
    """
    blk, k = _gather_block(idx, rows)
    return _occ_from_block(blk, k, c, rows, idx.zoff)


def occ_all(idx, rows):
    """occ for all 4 chars at once: int32 [B, 4] (ref: mapBiLFEx's 4-way
    count, bt2_idx.h:2431-2472)."""
    blk, k = _gather_block(idx, rows)
    words = blk[..., DEV_BWT : DEV_BWT + DEV_BWT_WORDS]
    cp = blk[..., DEV_OCC : DEV_OCC + 4].astype(jnp.int32)
    limits = _pair_limit_mask(_word_limits(k))
    cs = jnp.arange(4, dtype=jnp.int32)
    cnt = jax.vmap(
        lambda c: _count_pairs_eq(words, jnp.broadcast_to(c, rows.shape), limits),
        out_axes=-1,
    )(cs)
    cnt = cp + cnt
    adj = (rows > idx.zoff).astype(jnp.int32)
    return cnt.at[:, 0].add(-adj)


def lf(idx, c, rows):
    """LF step for char c: fchr[c] + occ(c, row)."""
    return small_lookup(idx.fchr, c, 4) + occ(idx, c, rows)


def lf_range(idx, c, top, bot):
    """Backward-search range update: new [top, bot) for prepended char c."""
    both = jnp.concatenate([top, bot])
    cc = jnp.concatenate([c, c])
    res = lf(idx, cc, both)
    n = top.shape[0]
    return res[:n], res[n:]


def _bwt_char_from_block(blk, k):
    w = _select_minor(
        blk[..., DEV_BWT : DEV_BWT + DEV_BWT_WORDS].astype(jnp.int32),
        k // WORD_BASES, DEV_BWT_WORDS,
    ).astype(jnp.uint32)
    return ((w >> (2 * (k % WORD_BASES)).astype(jnp.uint32)) & 3).astype(jnp.int32)


def bwt_char(idx, rows):
    """The BWT char at each row (dummy 0 at zoff; callers exclude zoff)."""
    blk, k = _gather_block(idx, rows)
    return _bwt_char_from_block(blk, k)


def lf_row(idx, rows):
    """LF of a single row via its own BWT char (group-walk step; invalid at
    zoff — the walk kernel never steps from zoff because it is marked)."""
    blk, k = _gather_block(idx, rows)
    c = _bwt_char_from_block(blk, k)
    return small_lookup(idx.fchr, c, 4) + _occ_from_block(blk, k, c, rows, idx.zoff)


def _mark_from_block(blk, k):
    mwords = blk[..., DEV_MARK : DEV_MARK + DEV_MARK_WORDS]
    j = jnp.arange(DEV_MARK_WORDS, dtype=jnp.int32) * 32
    nb = jnp.clip(k[..., None] - j, 0, 32)
    sh = jnp.where(nb >= 32, 0, nb).astype(jnp.uint32)
    part = (jnp.uint32(1) << sh) - jnp.uint32(1)
    masks = jnp.where(nb >= 32, _FULL, part)
    cnt = jax.lax.population_count(mwords & masks).astype(jnp.int32).sum(axis=-1)
    rank = blk[..., DEV_MARKCP].astype(jnp.int32) + cnt
    wsel = _select_minor(
        mwords.astype(jnp.int32), k // 32, DEV_MARK_WORDS
    ).astype(jnp.uint32)
    marked = ((wsel >> (k % 32).astype(jnp.uint32)) & 1).astype(jnp.bool_)
    return marked, rank


def mark_rank(idx, rows):
    """(marked, rank): is `row` SA-sampled, and how many sampled rows
    precede it (rank into sa_sample)."""
    blk, k = _gather_block(idx, rows)
    return _mark_from_block(blk, k)


def walk_step(idx, rows):
    """Fused group-walk step from ONE block gather: returns
    (marked, rank, lf_next) — mark test + LF(row) together (the whole
    inner loop of GWState::advance / Ebwt::getOffset, group_walk.h:352+,
    bt2_idx.cpp:149-171, as a single memory transaction per lane)."""
    blk, k = _gather_block(idx, rows)
    marked, rank = _mark_from_block(blk, k)
    c = _bwt_char_from_block(blk, k)
    nxt = small_lookup(idx.fchr, c, 4) + _occ_from_block(blk, k, c, rows, idx.zoff)
    return marked, rank, nxt
