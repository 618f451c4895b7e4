"""Batched exact-match FM backward search over seed lanes.

Device analog of the reference's lockstep seed-search kernel
(SeedAligner::searchSeedBi<SS_SIZE>, aligner_seed.cpp:820-957, with the
ftab jump of startSearchSeedBi, aligner_seed.cpp:757-811). The fork runs 8
seeds in interleaved lockstep to hide memory latency; here every lane of a
[B]-wide batch advances in lockstep per LF step, with dead lanes masked
instead of swap-compacted (fixed shapes for XLA).

The fork supports exact seeds only (mmSeeds throws for mms>0,
aligner_seed.h:356-369), so a seed containing N can never match and is
invalidated up front.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from . import rank


def pack_kmer(seed_tail: jnp.ndarray) -> jnp.ndarray:
    """[B, k] codes -> packed 4-ary int32 key (first char = high digits)."""
    k = seed_tail.shape[-1]
    w = (4 ** jnp.arange(k - 1, -1, -1, dtype=jnp.int32))[None, :]
    return jnp.sum(jnp.clip(seed_tail, 0, 3).astype(jnp.int32) * w, axis=-1)


def search_seeds(idx, seeds: jnp.ndarray, valid: jnp.ndarray,
                 sub_ftab: bool = False):
    """Exact backward search of seeds.

    seeds: int32/int8 [B, L] codes (4 = N; NEGATIVE = padding). Seeds
    shorter than L — the reference's min(seed_len, rdlen) clamp for
    short reads (SeedAligner::prepareSeed, aligner_seed.cpp:321-341) —
    come in two layouts:
      - length >= ftab_k: RIGHT-aligned (left-padded), ftab jump on the
        last k chars, pad lanes hold their finished range;
      - length < ftab_k (only when sub_ftab=True): LEFT-aligned
        (right-padded), initialized to the FULL row range [0, nrows) —
        one LF step from the full range IS the fchr lookup (LF(c, 0) =
        fchr[c], LF(c, nrows) = fchr[c+1]), so the same lockstep loop
        searches the whole short seed with no special init
        (startSearchSeedBi's fchr fallback, aligner_seed.cpp:769-776).
    valid: bool [B].  Returns (top, bot) [B]; empty lanes top == bot.
    """
    seeds = seeds.astype(jnp.int32)
    B, L = seeds.shape
    k = idx.ftab_k

    has_n = jnp.any(seeds == 4, axis=-1)
    alive = valid & ~has_n
    rowdt = idx.fchr.dtype
    zero = jnp.zeros((), rowdt)

    if L >= k:
        # ftab jump on the last k chars (backward search starts at seed end)
        q = pack_kmer(seeds[:, L - k :])
        ft, fb = rank.ftab_lookup(idx, q)
        if sub_ftab:
            # left-aligned sub-ftab lanes are right-PADDED: their last
            # column is padding (right-aligned lanes always end real)
            short = seeds[:, L - 1] < 0
            ft = jnp.where(short & alive, zero, ft)
            fb = jnp.where(short & alive, idx.nrows, fb)
            nsteps = max(L - k, min(k, L) - 1)
        else:
            short = jnp.zeros(B, bool)
            nsteps = L - k
        top = jnp.where(alive, ft, zero)
        bot = jnp.where(alive, fb, zero)
        ftab_hi = L - k  # right-aligned lanes consumed positions >= this
    else:
        # whole-batch seed length below the ftab k-mer (e.g. -L below
        # the index's ftab chars): same full-range trick, LF through
        # every char
        short = jnp.ones(B, bool)
        top = jnp.where(alive, zero, zero)
        bot = jnp.where(alive, idx.nrows, zero)
        nsteps = L
        ftab_hi = L

    def step(i, carry):
        top, bot = carry
        # walk right-to-left over the remaining chars
        pos = nsteps - 1 - i
        c = jax.lax.dynamic_index_in_dim(seeds, pos, axis=1, keepdims=False)
        live = bot > top
        upd = live & (c >= 0) & ((pos < ftab_hi) | short)
        ntop, nbot = rank.lf_range(idx, c, top, bot)
        top = jnp.where(upd, ntop, top)
        bot = jnp.where(upd, nbot, jnp.where(live, bot, top))
        return top, bot

    if nsteps > 0:
        top, bot = jax.lax.fori_loop(0, nsteps, step, (top, bot))
    bot = jnp.maximum(top, bot)
    empty = ~alive
    zero = jnp.zeros((), top.dtype)
    return jnp.where(empty, zero, top), jnp.where(empty, zero, bot)


def device_seed_grid(lens, ival, active, *, K: int, seed_len: int,
                     nrounds: int, roundi: int):
    """The multiseed grid computed ON DEVICE from per-read lengths.

    Device analog of the host `_seed_grid` (models/aligner.py): the seed
    set is pure integer arithmetic of (rdlen, interval, round), so the
    steady loop ships only [n_reads] metadata instead of [n_seeds]
    arrays — at genome scale that removes ~95% of the per-round
    host->device bytes and every per-seed host-side repeat/concat
    (instantiateSeeds, the reference's P2, aligner_seed.cpp:397-447).

    lens, ival: int32 [npad] (ival = max(1, msIval f(len)), computed
    host-side once per batch — float64 SimpleFunc semantics); active:
    bool [npad].  K: static lane capacity (host sizes it from the same
    arithmetic).  roundi >= 0: multiseed round; roundi == -1: the
    half-read rescue round (two seeds per read).

    Returns (rsel [K] int32 read index, d [K] int32 fw 5' offset,
    eff [K] int32 effective seed length, valid [K] bool). Lane order is
    (read ascending, depth ascending) exactly like the host grid.
    """
    npad = lens.shape[0]
    if roundi < 0:
        eff_r = jnp.minimum(seed_len, jnp.maximum(1, lens // 2))
        cnt = jnp.where(active & (lens >= 1), 2, 0).astype(jnp.int32)
        start = jnp.zeros(npad, jnp.int32)
    else:
        eff_r = jnp.minimum(lens, seed_len)
        nr = jnp.minimum(nrounds, ival)
        start = (ival * roundi) // nr
        cnt = jnp.where(
            active & (roundi < nr) & (lens >= 1)
            & (start <= lens - eff_r),
            (lens - eff_r - start) // ival + 1,
            0,
        ).astype(jnp.int32)
    ccum = jnp.cumsum(cnt)
    G = ccum[-1]
    k = jnp.arange(K, dtype=jnp.int32)
    # lane k belongs to the first read r with ccum[r] > k, i.e.
    # rsel[k] = #{r : ccum[r] <= k} — a scatter-add + cumsum instead of
    # a per-lane binary search (chosen for the original accelerator,
    # whose scalar gathers are slow; unmeasured on this device)
    ind = jnp.zeros(K + 1, jnp.int32).at[jnp.clip(ccum, 0, K)].add(1)
    rsel = jnp.cumsum(ind)[:K]
    valid = k < G
    rs = jnp.clip(rsel, 0, npad - 1)
    base = ccum[rs] - cnt[rs]
    klocal = k - base
    if roundi < 0:
        d = jnp.where(klocal == 1, lens[rs] - eff_r[rs], 0)
    else:
        d = start[rs] + klocal * ival[rs]
    return rs, d, eff_r[rs], valid


def _mix32(a, b):
    """uint32 avalanche hash of two lane vectors (splitmix-style)."""
    x = a.astype(jnp.uint32) ^ (b.astype(jnp.uint32)
                                * jnp.uint32(0x9E3779B9))
    x = (x ^ (x >> 16)) * jnp.uint32(0x7FEB352D)
    x = (x ^ (x >> 15)) * jnp.uint32(0x846CA68B)
    return x ^ (x >> 16)


def search_resolve_seeds(idx, seeds: jnp.ndarray, valid: jnp.ndarray,
                         cap: int, expand: float = 4,
                         sample_seed: int | None = 0,
                         sub_ftab: bool = False,
                         lane_seed: jnp.ndarray | None = None):
    """Fused seed search + SA resolution in ONE device dispatch (the fork
    splits these into phases P4/P6 with host work between,
    bt2_search.cpp:2638/2683; fusing them saves a dispatch and a
    device->host round trip).

    For each seed, min(width, cap) SA rows are compacted (cumsum
    scatter) into a flat buffer of int(S*expand) slots and resolved to
    joined offsets (expand may be fractional: after seed dedupe the slot
    demand is typically ~0.3 slots/lane, and the resolve walk's cost is
    linear in the slot count). Ranges no wider than cap resolve fully;
    wider ranges draw `cap` DISTINCT rows by seeded stratified sampling
    (one uniform pick per equal stratum of the range) — the batched
    analog of the reference's weighted random element draw over large
    ranges (RowSampler/Random1toN, aligner_sw_driver.cpp:151-259,
    random_util.h): picks are random across the whole range yet
    deterministic in (range, read, --seed), so output stays batch/shard
    placement invariant.  lane_seed (uint32 [S], optional) mixes each
    lane's per-read genRandSeed (utils/rng.gen_rand_seed — itself a pure
    function of read content + --seed, the reference's own invariance
    trick, pat.cpp:45-82) into the draw, recovering the reference's
    PER-READ pick diversity on deep repeats (its RowSampler draws from a
    per-read RNG): distinct reads hitting the same wide SA range sample
    different rows.  sample_seed=None restores first-cap-rows.
    Returns (top, bot, starts, offs) with seed s's offsets at
    offs[starts[s] : starts[s] + min(bot-top, cap)[s]]; seeds whose
    slots spill past the buffer have starts[s] + width > int(S*expand)
    (host retries the chunk with a wider buffer).
    """
    from .walk import resolve_rows

    top, bot = search_seeds(idx, seeds, valid, sub_ftab)
    rowdt = top.dtype
    S = seeds.shape[0]
    wfull = bot - top
    # compaction bookkeeping stays int32 even on the int64 (.bt2l) path:
    # per-seed take <= cap so totals fit easily, and an int32 cumsum is
    # half the bytes of an int64 one
    width = jnp.minimum(wfull, cap).astype(jnp.int32)
    rmax = int(S * expand)
    starts = jnp.cumsum(width) - width
    ends = starts + width
    # slot -> owning seed WITHOUT a [S, cap] scatter (most of whose
    # elements were dumped): owner of slot g is the first seed whose
    # slot range ends past g, i.e. #{s : ends[s] <= g} — one
    # scatter-add + cumsum (S*cap scatter elements -> rmax)
    cnt_end = jnp.zeros(rmax + 1, jnp.int32).at[
        jnp.clip(ends, 0, rmax)
    ].add(1)
    owner = jnp.cumsum(cnt_end)[:rmax]
    own = jnp.clip(owner, 0, S - 1)
    g32 = jnp.arange(rmax, dtype=jnp.int32)
    intra = g32 - starts[own]
    live = (owner < S) & (intra >= 0) & (intra < width[own])
    k = intra.astype(rowdt)
    wo = wfull[own]
    if sample_seed is None:
        rows_flat = top[own] + k
    else:
        # stratified without-replacement sample of cap rows from [0, w):
        # stratum j = [j*(w//cap) + min(j, w%cap), ...) of size
        # w//cap (+1 for the first w%cap strata); all arithmetic stays
        # within the row dtype (no k*w products that could overflow).
        # Per-slot formulation of the same (seed, stratum) hash — picks
        # are identical to the per-seed [S, cap] formulation.
        #
        # EMISSION ORDER is itself a per-(range, read) pseudorandom
        # permutation of the cap strata (odd-multiplier LCG when cap is
        # a power of two, rotation otherwise): the candidate STREAM
        # order downstream is diagonal-dedupe + budget + tighten replay
        # order (aligner_sw_driver.cpp:588-618 keeps only what was
        # reported before the minsc raise), and the reference's stream
        # is its RowSampler's random draw order — emitting our strata
        # in fixed SA order concentrated the post-tighten survivors on
        # the first strata's fixed copy subset (measured: depth-500
        # deep repeats reported only ~2 strata ~= 64 fixed copies).
        q = wo // cap
        r = wo % cap
        to = top[own]
        t32 = to if rowdt == jnp.int32 else to ^ (to >> 32)
        hbase = (t32.astype(jnp.uint32)
                 + jnp.uint32(np.uint32(sample_seed & 0xFFFFFFFF)))
        if lane_seed is not None:
            hbase = hbase + lane_seed[own].astype(jnp.uint32)
        k32 = k.astype(jnp.uint32)
        if cap & (cap - 1) == 0:  # odd-multiplier bijection mod 2^m
            ja = _mix32(hbase, jnp.uint32(0xA5A5)) | jnp.uint32(1)
            jb = _mix32(hbase, jnp.uint32(0x5A5A))
            j32 = (k32 * ja + jb) & jnp.uint32(cap - 1)
        else:  # rotation is a bijection for any cap
            jb = _mix32(hbase, jnp.uint32(0x5A5A))
            j32 = (k32 + jb) % jnp.uint32(cap)
        j = j32.astype(rowdt)
        lo = j * q + jnp.minimum(j, r)
        span = q + (j < r)
        h = _mix32(hbase, j + 1)
        pick = lo + (h % jnp.maximum(span, 1).astype(jnp.uint32)).astype(
            rowdt
        )
        rows_flat = to + jnp.where(wo > cap, pick, k)
    # live slots occupy the prefix [0, min(total demand, rmax)) by the
    # cumsum compaction — the tiled walk stops there (ops/walk.py)
    nlive = jnp.minimum(ends[S - 1], rmax).astype(jnp.int32)
    offs = resolve_rows(idx, rows_flat, live, nlive=nlive)
    return top, bot, starts, offs
