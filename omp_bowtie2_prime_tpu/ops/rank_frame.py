"""On-device range ranking, element budgeting, dedupe and DP framing.

The device formulation of the aligner's P5/P6 stage (rankSeedHits,
aligner_seed.h:1000-1062; prioritizeSATups element streaming + budgets,
aligner_sw_driver.cpp:61-631; frameSeedExtensionRect, dp_framer.cpp:81)
— semantically identical to the vectorized host-numpy block in
models/aligner.py collect_candidates, but running where the seed-search
results already live, so the per-seed range/offset tables never cross
the device->host copy: one packed problem table comes back instead.

Everything is fixed-shape: dynamic-size numpy idioms (flatnonzero,
repeat, unique) become sorts over the fixed slot space with validity
masking:

  1. seed sort by (read, width, !fw, offset)  — the range rank order
  2. slot ownership via searchsorted over the compaction starts; slot
     sort by (seed rank, intra)               — the element stream
  3. element sort by ((orientation, diagonal), stream pos) — first-
     occurrence dedupe exactly like np.unique(return_index)
  4. segmented cumsums (cummax trick) for the per-read element (400)
     and DP (300) budgets in stream order
  5. scatter of kept problems into a fixed [p_cap, 2] table

int32 throughout (multi-key lax.sort instead of packed int64 keys, so
the x64 flag stays off); the large-index int64 path keeps the host
formulation.  Every sort is stable and every .at[].set scatter has
unique live targets (dropped lanes share one dump slot that is sliced
off), so the table does not depend on the backend's sort or scatter
order.
"""

from __future__ import annotations

import functools

import jax
import numpy as np
import jax.numpy as jnp

I32 = jnp.int32
# numpy scalar on purpose — a module-level jnp scalar is a device array
# captured as a runtime executable constant, which the jax-0.9 pjit C++
# fast path fails to supply on re-execution (see ops/rank.py _EVEN note)
BIG = np.int32(2**30)


def _sort(operands, num_keys):
    # stable: lanes tied on every key keep lane order on every backend
    return jax.lax.sort(operands, num_keys=num_keys, is_stable=True)


@functools.partial(
    jax.jit,
    static_argnames=("range_cap", "expand", "max_elts", "max_dp",
                     "p_cap", "n_reads"),
)
def rank_frame(
    tops,      # [NC, SB] index dtype
    bots,      # [NC, SB]
    starts,    # [NC, SB] compaction starts within the chunk
    offs,      # [NC, int(SB*expand)] resolved joined offsets (-1 unres.)
    m_ri,      # [S] int32 read index per seed (S = NC*SB; pad ri=n_reads)
    m_fw,      # [S] bool
    m_off,     # [S] int32 seed offset within the read
    lens,      # [n_reads] int32 read lengths
    mgn,       # [n_reads] int32 narrow window slack per read
    read_ok,   # [n_reads] bool (length <= l_hard)
    text_n,    # scalar int32/int64 joined text length
    *,
    range_cap: int,
    expand: float,
    max_elts: int,
    max_dp: int,
    p_cap: int,
    n_reads: int,
):
    """Returns (problems [p_cap, 2] int32 (src, diag) — the host
    reframes wstart/wlen from diag (collect_candidates),
    count, hit_nonz [n_reads], hit_elts [n_reads], overflow flag)."""
    NC, SB = tops.shape
    S = NC * SB
    spc = int(SB * expand)  # slots per chunk (expand may be fractional)
    G = NC * spc

    w = (bots - tops).reshape(S).astype(I32)
    base = (jnp.arange(NC, dtype=I32) * spc)[:, None]
    gstart = (starts.astype(I32) + base).reshape(S)
    gend = jnp.broadcast_to(base + spc, (NC, SB)).reshape(S)
    goffs = offs.reshape(G)

    ri = m_ri.astype(I32)
    ok_read = read_ok[jnp.clip(ri, 0, n_reads - 1)] & (ri < n_reads)
    valid = (w > 0) & ok_read

    # per-read seed-hit stats (numElts_/nonzTot_, aligner_seed.h:802-807)
    seg = jnp.where(ri < n_reads, ri, n_reads)
    nzw = jnp.where(w > 0, 1, 0)
    hit_nonz = jax.ops.segment_sum(nzw, seg, num_segments=n_reads + 1)[:-1]
    # per-seed width clipped to 2^20 so the int32 per-read sum cannot
    # wrap; the --seed-boost gate only compares avg >= thresh (~300), and
    # a clipped width still forces avg far past any sane threshold
    hit_elts = jax.ops.segment_sum(
        jnp.clip(w, 0, 1 << 20), seg, num_segments=n_reads + 1
    )[:-1]

    # ---- 1. range rank order: (ri, width, !fw, off) ascending ----
    k1 = jnp.where(valid, ri, BIG)
    k2 = w
    k3 = ((~m_fw).astype(I32) << 16) | m_off.astype(I32)
    ri_s, w_s, k3_s, sid = _sort(
        (k1, k2, k3, jnp.arange(S, dtype=I32)), num_keys=3
    )
    valid_s = ri_s < BIG
    take = jnp.minimum(w_s, range_cap)
    gstart_s = gstart[sid]
    gend_s = gend[sid]
    spill = gstart_s + take > gend_s
    overflow = jnp.any(spill & valid_s)
    take = jnp.where(valid_s & ~spill, take, 0)

    # element-stream cap per read (maxIters): running slot base per read
    csum = jnp.cumsum(take)
    read_first = jnp.concatenate(
        [jnp.ones(1, bool), ri_s[1:] != ri_s[:-1]]
    )
    base_of_read = jax.lax.cummax(
        jnp.where(read_first, csum - take, 0)
    )
    elt_base = csum - take - base_of_read
    take_eff = jnp.clip(max_elts - elt_base, 0, take)

    # stream position base per seed: cumulative take_eff in rank order,
    # scattered back to lane space
    csum_eff = jnp.cumsum(take_eff)
    total_stream = csum_eff[-1]
    stream_base = jnp.zeros(S, I32).at[sid].set(csum_eff - take_eff)
    take_eff_stream = jnp.zeros(S, I32).at[sid].set(take_eff)

    # ---- 2. slot ownership + element stream order ----
    # owner of slot g = the seed (lane order) whose slot range covers g:
    # #{s : slot-range-end(s) <= g} — scatter-add + cumsum instead of a
    # per-slot binary search (chosen for the original accelerator;
    # unmeasured on this device), and a direct scatter to stream
    # positions instead of a [G] sort: stream pos of slot (seed, intra)
    # = stream_base[seed] + intra, which is exactly the (seed rank,
    # intra) sort order over live slots.
    g = jnp.arange(G, dtype=I32)
    ends_o = jnp.concatenate([gstart[1:], jnp.full(1, G, I32)])
    cnt_end = jnp.zeros(G + 1, I32).at[jnp.clip(ends_o, 0, G)].add(1)
    owner = jnp.cumsum(cnt_end)[:G]
    owner = jnp.clip(owner, 0, S - 1)
    intra = g - gstart[owner]
    slot_ok = (intra >= 0) & (intra < take_eff_stream[owner])
    pos = stream_base[owner] + intra
    tgt = jnp.where(slot_ok, jnp.minimum(pos, G), G)
    g_e = jnp.zeros(G + 1, I32).at[tgt].set(g)[:G]
    epos_ok = jnp.arange(G, dtype=I32) < total_stream

    owner_e = owner[g_e]
    # joined offsets keep their index dtype: int64 for .bt2l-scale
    # genomes (framing below follows cand.dtype; the output table widens)
    joff = goffs[g_e]
    ri_e = jnp.where(epos_ok, ri[owner_e], n_reads)
    fw_e = m_fw[owner_e]
    soff_e = m_off[owner_e].astype(joff.dtype)
    ok_e = epos_ok & (joff >= 0)
    cand = joff - soff_e

    # ---- 3. dedupe by (read, fw, diagonal), first stream pos wins ----
    # epos is a SORT KEY (not payload): ties on (group, diag) must
    # resolve to the smallest stream position, like np.unique's
    # return_index over the stream array
    dk1 = jnp.where(ok_e, ri_e * 2 + fw_e.astype(I32), BIG)
    epos = jnp.arange(G, dtype=I32)
    sdk1, sdk2, eidx = _sort((dk1, cand, epos), num_keys=3)
    first = jnp.concatenate(
        [jnp.ones(1, bool), (sdk1[1:] != sdk1[:-1]) | (sdk2[1:] != sdk2[:-1])]
    ) & (sdk1 < BIG)
    keep = jnp.zeros(G, bool).at[eidx].set(first)

    # ---- 4. window framing + wlen filter (narrow tier) ----
    ln_e = lens[jnp.clip(ri_e, 0, n_reads - 1)].astype(cand.dtype)
    mg_e = mgn[jnp.clip(ri_e, 0, n_reads - 1)].astype(cand.dtype)
    wstart = jnp.maximum(jnp.zeros((), cand.dtype), cand - mg_e)
    wend = jnp.minimum(
        jnp.asarray(text_n, cand.dtype), cand + ln_e + mg_e
    )
    keep &= (wend - wstart) > 0

    # DP cap per read (maxDp) among kept, in stream order
    kc = jnp.cumsum(keep.astype(I32))
    rf_e = jnp.concatenate([jnp.ones(1, bool), ri_e[1:] != ri_e[:-1]])
    kbase = jax.lax.cummax(jnp.where(rf_e, kc - keep.astype(I32), 0))
    kord = kc - keep.astype(I32) - kbase
    keep &= kord < max_dp

    # ---- 5. compact kept problems into the fixed table ----
    # SLIM table: (src, diag) only — wstart/wlen are pure arithmetic of
    # (diag, read len, narrow slack) and the host reframes them with the
    # same clamps (collect_candidates), so shipping them would double
    # the mega's dominant device->host payload for nothing
    out_pos = jnp.cumsum(keep.astype(I32)) - 1
    count = jnp.sum(keep.astype(I32))
    srcs = 2 * ri_e + jnp.where(fw_e, 0, 1)
    tgt = jnp.where(keep & (out_pos < p_cap), out_pos, p_cap)
    odt = cand.dtype  # int64 table for .bt2l-scale genomes
    problems = jnp.zeros((p_cap + 1, 2), odt)
    problems = problems.at[tgt, 0].set(srcs.astype(odt))
    problems = problems.at[tgt, 1].set(cand.astype(odt))
    return problems[:p_cap], count, hit_nonz, hit_elts, overflow
