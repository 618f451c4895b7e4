"""End-to-end unpaired alignment pipeline (the flagship "model").

Accelerator re-design of the reference's batched worker
(multiseedSearchWorker, bt2_search.cpp:2297-2888). The fork already made
alignment phase-synchronous over a resident batch; here each phase is a
fixed-shape device computation over padded batches:

  P1 read/filter      -> host (io/fastq.py)
  P2 instantiate seeds-> host numpy (offsets every interval, fw + rc)
  P4 seed search      -> ops/seed_search.search_seeds   [SEED_BATCH lanes]
  P5 rank hits        -> host (sort ranges by width)
  P6 resolve          -> ops/walk.resolve_rows          [ROW_BATCH lanes]
  P7 extend (DP)      -> ops/sw.sw_e2e_batch            [DP_BATCH problems]
  P8 select/report    -> host (selection, backtrace, MAPQ, SAM)

Budgets/envelopes mirror the reference (bt2_search.cpp:403-433,
aligner_result.h:42-43): seed rounds collapse to one exhaustive pass here
because all seeds are searched at once on device.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..index.format import DeviceIndex, FMIndex
from ..ops import seed_search, sw, walk
from ..utils import dna
from ..utils import rng as refrng
from ..utils.mapq import mapq_v2_e2e, mapq_v2_local, mapq_v3
from ..utils.metrics import PhaseTimers, PipelineMetrics
from ..utils.scoring import Scoring, SimpleFunc, SIMPLE_FUNC_SQRT
from ..utils import cigar as cigar_util


@dataclasses.dataclass(frozen=True)
class AlignOpts:
    seed_len: int = 22  # multiseedLen (aligner_seed_policy.h:27)
    # -i S,1,1.15 (sensitive default, presets.cpp)
    ival: SimpleFunc = dataclasses.field(
        default_factory=lambda: SimpleFunc(SIMPLE_FUNC_SQRT, 1.0, 1.15)
    )
    range_cap: int = 16  # SA elements resolved per seed range
    max_elts_per_read: int = 400  # maxIters (bt2_search.cpp:411)
    max_dp_per_read: int = 300  # maxDp (bt2_search.cpp:413)
    maxhalf: int = 15  # --dpad: gap clamp per DP side (bt2_search.cpp:408)
    l_max: int = 160  # ALN_MAX_ROWS (aligner_result.h:42)
    # DP window cap. The reference's is 200 (ALN_MAX_COLS, its fixed SSE
    # buffer, aligner_result.h:43) which makes >138bp reads unalignable
    # (rect = rdlen + 4*maxhalf + 2, dp_framer.cpp:94-101); ours is a
    # compile shape, sized so every read up to l_max fits with full slack
    c_strict: int = 224
    # hard read-length ceiling: reads up to this long align through the
    # irregular (any-shape XLA) DP bucket — the reference rejects them
    # outright (rdlen < 256 assert + its 200-col envelope)
    l_hard: int = 1024
    minsc_clamp: int = -254  # u8-only build clamp (bt2_search.cpp:2487-2491)
    nrounds: int = 2  # -R / ROUNDS re-seeding rounds (bt2_search.cpp:433)
    dps: int = 15  # -D / DPS extension fail-streak budget (presets.cpp)
    # --seed-boost: a read re-seeds (next round) only if it had no seed
    # hits at all or averaged >= this many SA elements per nonzero seed
    # (averageHitsPerSeed, aligner_seed.h:802-807; gate bt2_search.cpp:2792)
    seed_boost: int = 300
    nofw: bool = False  # --nofw: skip forward-orientation seeds
    norc: bool = False  # --norc: skip reverse-complement seeds
    # --local: soft-clipping local alignment. The fork removed its local
    # kernels (bt2_search.cpp:1345-1348) but kept the whole local policy
    # surface; this restores upstream bowtie2's local mode on the
    # sw_local_* kernels (ops/sw.py)
    local: bool = False
    khits: int = 1  # -k: report up to this many alignments
    allhits: bool = False  # -a: report all found alignments
    # --tighten: -M-mode minsc raising once best+secondBest are known
    # (0=off, 1=best, 2=secbest+1, 3=interpolated; bt2_search.cpp:233,431)
    tighten: int = 3
    mapqv: int = 2  # --mapq-v: 2 = BowtieMapq2 (default), 3 = V3 table
    # --seed: global RNG seed mixed into every per-read reporting seed
    # (genRandSeed, pat.cpp:45-82) — equal-score tie-breaks draw from a
    # read-content-seeded LCG, so output is shard/batch-placement
    # invariant exactly as the reference's is thread-count invariant
    rng_seed: int = 0
    # chunk shapes: sized so a full CLI read-batch needs only a few device
    # dispatches (each dispatch pays a fixed launch + host sync cost)
    seed_batch: int = 32768
    row_batch: int = 32768
    # flat-lane cap for the grid mega (one chunk up to this many lanes;
    # larger seed sets fall back to chunked lax.map): transient gather
    # blocks are [2*lanes, 128] u32 = 1 GB at the cap
    grid_lanes_cap: int = 1 << 20
    # compaction slots per seed lane for SA resolution (may be
    # fractional; the walk kernel's cost is linear in slots). The fused
    # mega path never dedupes seeds, and on real genomes nearly every
    # existing k-mer has >= 1 hit, so demand is ~1 slot/lane: 0.5 made
    # the mega spill on EVERY genome-scale batch and silently fall back
    # to the host path (found round 2 via the 46 Mbp phase profile —
    # the "0.3/lane post-dedupe" sizing only described the deduped host
    # path). Deep-repeat batches past 1.0 still spill and fall back.
    resolve_expand: float = 1.0
    # up-front rescue round (half-read exact seeds, _seed_grid roundi=-1):
    # restores upstream's do1mmUpFront capability for reads whose every
    # multiseed crosses the mismatch; off = --no-1mm-upfront
    upfront_rescue: bool = True
    # --overhang (gReportOverhangs, bt2_search.cpp:1092): alignments may
    # hang off the reference ends — off-end positions align against N
    # (scored -npen, counted in ns/XN) and the overhanging read chars
    # soft-clip in the record (aligner_result.cpp:1806-1840). Such
    # problems run through the ref-space bridge DP.
    overhang: bool = False
    dp_batch: int = 2048
    dp_cols: int = 200  # device window capacity, short-read bucket (cols)


class LazyStats:
    """Mapping view over one native-finisher stats row (csrc/sais.cpp
    bt_finish_batch) + raw MD bytes; values materialize on access so the
    hot path never builds per-record dicts."""

    __slots__ = ("_row", "_md")
    _IDX = {"nm": 0, "xm": 1, "xo": 2, "xg": 3, "xn": 4, "ref_span": 5,
            "ns": 8}

    def __init__(self, row, md):
        self._row = row  # list of ints (stats row, pre-tolist'ed)
        self._md = md    # bytes | str

    def __getitem__(self, k):
        if k == "md":
            md = self._md
            if not isinstance(md, str):
                md = self._md = md.decode("ascii")
            return md
        return self._row[self._IDX[k]]

    def get(self, k, default=None):
        try:
            return self[k]
        except KeyError:
            return default

    def __bool__(self):
        return True

    def __repr__(self):
        d = {k: self._row[i] for k, i in self._IDX.items()}
        d["md"] = self["md"]
        return repr(d)


class _LazyCigar:
    """Shared lazy-``cigar`` property implementation: the op-tuple list is
    parsed from the native finisher's ASCII string only when accessed."""

    __slots__ = ()

    @property
    def cigar(self) -> list:
        c = self._cigar
        if c is None:
            c = self._cigar = cigar_util.parse_cigar(self.cigar_str)
        return c

    @cigar.setter
    def cigar(self, v):
        self._cigar = v


class AlnResult(_LazyCigar):
    """Per-read outcome."""

    __slots__ = ("status", "fw", "refid", "refoff", "score", "secbest",
                 "mapq", "_cigar", "cigar_str", "stats", "nhits", "span",
                 "extra", "filt")

    def __init__(self, status, fw=True, refid=-1, refoff=-1, score=0,
                 secbest=None, mapq=0, cigar=None, cigar_str="",
                 stats=None, nhits=0, span=0, extra=None, filt=None):
        self.status = status  # "aligned" | "unaligned"
        self.fw = fw
        self.refid = refid
        self.refoff = refoff  # 0-based
        self.score = score
        self.secbest = secbest
        self.mapq = mapq
        self._cigar = cigar
        self.cigar_str = cigar_str  # ready ASCII CIGAR ("" -> from _cigar)
        self.stats = stats if stats is not None else {}
        self.nhits = nhits
        self.span = span  # reference chars consumed
        # secondary alignments for -k/-a reporting (flag 0x100 records)
        self.extra = extra if extra is not None else []
        # pre-alignment filter reason ("NS" = N ceiling, YF:Z tag;
        # AlnFlags::printYF, aligner_result.cpp:987-1000)
        self.filt = filt


class Candidate(_LazyCigar):
    """A scored DP endpoint for one read: a distinct (fw, joined end col)
    (the dedupe key the reference applies per DP problem via its redundancy
    checks, aligner_sw_driver.cpp:528-560). Backtrace details are filled
    lazily by TPUAligner.backtrace()."""

    __slots__ = ("score", "fw", "endj", "problem", "bc", "ops_row",
                 "start_col", "resolved", "valid", "joined_start", "span",
                 "refid", "refoff", "_cigar", "cigar_str", "stats",
                 "bridge", "row_lo", "row_hi")

    def __init__(self, score, fw, endj, problem, bc, ops_row=None,
                 start_col=-1, bridge=None, row_lo=0, row_hi=-1):
        self.score = score
        self.fw = fw
        self.endj = endj  # joined-text col where the alignment ends (excl)
        self.problem = problem  # src/wstart/wlen/diag of the DP window
        self.bc = bc  # best end column within the window
        # device-computed backtrace raw results (op string END->START +
        # start col), finished lazily on host into cigar/stats:
        self.ops_row = ops_row
        self.start_col = start_col
        # lazily-populated backtrace results:
        self.resolved = False
        self.valid = False  # False if straddles a fragment boundary
        self.joined_start = -1
        self.span = 0
        self.refid = -1
        self.refoff = -1
        self._cigar = None
        self.cigar_str = ""
        self.stats = {}
        # N-bridge DP problems (window spans an intra-reference N gap)
        # carry their ref-space frame: (refid, ref_lo, refw int8 window)
        self.bridge = bridge
        # local mode: aligned read-row range [row_lo, row_hi) — soft clips
        # are row_lo leading and rdlen - row_hi trailing chars
        # (row_hi = -1 means the whole read: end-to-end mode)
        self.row_lo = row_lo
        self.row_hi = row_hi


class Problems:
    """SoA DP-problem table: parallel arrays over the batch's DP
    problems (the columnar replacement for the per-problem dict list —
    tens of thousands of Python dicts per batch were pure host
    overhead).  src = 2*ri + (0 fw / 1 rc); ri/fw are derived views."""

    __slots__ = ("src", "wstart", "wlen", "diag", "ri", "fw")

    def __init__(self, src, wstart, wlen, diag):
        self.src = np.asarray(src, np.int64)
        self.wstart = np.asarray(wstart, np.int64)
        self.wlen = np.asarray(wlen, np.int32)
        self.diag = np.asarray(diag, np.int64)
        self.ri = self.src >> 1
        self.fw = (self.src & 1) == 0

    def __len__(self):
        return len(self.src)

    def take(self, idxs):
        return Problems(self.src[idxs], self.wstart[idxs],
                        self.wlen[idxs], self.diag[idxs])

    def one(self, i) -> dict:
        """Per-candidate dict view (Candidate.problem compatibility)."""
        return dict(src=int(self.src[i]), wstart=int(self.wstart[i]),
                    wlen=int(self.wlen[i]), diag=int(self.diag[i]))


class CandTable:
    """Columnar single-candidate table: one row per read whose round
    emitted EXACTLY one candidate (and no N-bridge entry) — at genome
    scale that is ~97% of reads, and the per-read dict + Candidate +
    AlnResult Python churn for them was the finishRead phase's dominant
    cost (VERDICT r4 item 1: 11.5 s/1M reads; the reference finishes
    reads in a C++ loop, bt2_search.cpp:2723-2860, so the analog here is
    arrays end to end).  Finished by _finalize_singles_table without
    materializing Candidate objects."""

    __slots__ = ("ri", "score", "fw", "src", "wstart", "wlen", "diag",
                 "bc", "start_col", "row_lo", "row_hi", "ops")

    def __init__(self, ri, score, fw, src, wstart, wlen, diag, bc,
                 start_col, row_lo, row_hi, ops):
        self.ri = ri              # int64 [m] read index
        self.score = score        # int64 [m]
        self.fw = fw              # bool [m]
        self.src = src            # int64 [m] matrix row (2*ri + !fw)
        self.wstart = wstart      # int64 [m] window start (joined)
        self.wlen = wlen          # int64 [m]
        self.diag = diag          # int64 [m]
        self.bc = bc              # int64 [m] best end col in window
        self.start_col = start_col  # int64 [m]
        self.row_lo = row_lo      # int64 [m] | None (local soft clips)
        self.row_hi = row_hi      # int64 [m] | None
        self.ops = ops            # list[int | uint8 array] per row

    def __len__(self):
        return len(self.ri)

    def candidate(self, t) -> "Candidate":
        """Materialize row t as a Candidate (fallback paths only)."""
        return Candidate(
            score=int(self.score[t]), fw=bool(self.fw[t]),
            endj=int(self.wstart[t] + self.bc[t]),
            problem=dict(src=int(self.src[t]), wstart=int(self.wstart[t]),
                         wlen=int(self.wlen[t]), diag=int(self.diag[t])),
            bc=int(self.bc[t]), ops_row=self.ops[t],
            start_col=int(self.start_col[t]),
            row_lo=int(self.row_lo[t]) if self.row_lo is not None else 0,
            row_hi=int(self.row_hi[t]) if self.row_hi is not None else -1,
        )


_EMPTY_OFFS = np.empty(0, np.int32)


def _put_factory(placer):
    import jax.numpy as jnp

    if placer is None:
        return jnp.asarray
    return lambda a: placer.put_batch(jnp.asarray(a))


P_CAP = 32768  # fixed on-device problem-table rows (fused rank/frame)


def _gather_seed_windows(matpk, src, off, eff, seed_len: int, ftab_k: int):
    """[B] (matrix row, fw offset, effective len) -> [B, seed_len] int8
    seed codes from the resident packed read matrix.

    ONE u32 row gather per seed + compare-selects instead of a [B,
    seed_len] per-byte gather (one row read per seed instead of seed_len
    element reads).
    Layout contract for short seeds matches ops/seed_search.search_seeds:
    eff >= ftab_k lanes are right-aligned (left -1 padded), shorter lanes
    left-aligned (right -1 padded)."""
    W = matpk.shape[1]
    if matpk.dtype == jnp.uint16:
        ipw = 2  # 16-bit items per u32 word
        matw = jax.lax.bitcast_convert_type(
            matpk.reshape(-1, W // ipw, ipw), jnp.uint32
        )
        bits = 16
    else:
        ipw = 4
        matw = jax.lax.bitcast_convert_type(
            matpk.reshape(-1, W // ipw, ipw), jnp.uint32
        )
        bits = 8
    Wq = W // ipw
    row = matw[src]  # [B, Wq] u32
    shift = jnp.where(eff >= ftab_k, seed_len - eff, 0)
    off2 = off - shift
    a = off2 % ipw
    w0 = off2 // ipw
    nw = (seed_len + ipw - 1) // ipw + 1
    sel = jnp.arange(Wq, dtype=jnp.int32)[None, :]
    wstack = jnp.stack(
        [jnp.sum(jnp.where((w0 + t)[:, None] == sel, row, 0), axis=1)
         for t in range(nw)],
        axis=1,
    )  # [B, nw] u32
    tsel = jnp.arange(nw, dtype=jnp.int32)[None, :]
    chars = []
    j32 = jnp.arange(seed_len, dtype=jnp.int32)
    for j in range(seed_len):
        wi = (a + j) // ipw
        sh = (((a + j) % ipw) * bits).astype(jnp.uint32)
        w = jnp.sum(jnp.where(wi[:, None] == tsel, wstack, 0), axis=1)
        chars.append(((w >> sh) & 0xF).astype(jnp.int8))
    s = jnp.stack(chars, axis=1)  # [B, seed_len]
    real = (j32[None, :] >= shift[:, None]) & (
        j32[None, :] < (shift + eff)[:, None]
    )
    return jnp.where(real, s, jnp.int8(-1))


@jax.jit
def _expand_oriented_mat(pkfw, lens_c):
    """[n, W] packed fw read rows -> [2n, W] oriented matrix ON DEVICE
    (row 2i = fw, row 2i+1 = revcomp).  The rc rows are pure arithmetic
    of the fw rows, so only the fw rows are uploaded: half the largest
    per-batch host->device transfer."""
    n, W = pkfw.shape
    j = jnp.arange(W, dtype=jnp.int32)[None, :]
    lc = lens_c[:, None]
    src = jnp.clip(lc - 1 - j, 0, W - 1)
    rcb = jnp.take_along_axis(pkfw, src, axis=1)
    c = (rcb & jnp.array(0xF, pkfw.dtype)).astype(pkfw.dtype)
    cc = jnp.where(c < 4, 3 - c, c).astype(pkfw.dtype)
    hi = ((rcb >> 4) << 4).astype(pkfw.dtype)
    rc = jnp.where(j < lc, cc | hi, jnp.array(4, pkfw.dtype))
    return jnp.stack([pkfw, rc], axis=1).reshape(2 * n, W)


def _bt_gap_cap(B: int) -> int:
    """Side-buffer rows for gapped-alignment op strings per DP dispatch
    of B problems (indel alignments are a small minority; overflow
    triggers a full-size retry of the chunk)."""
    return max(64, B // 16)


@functools.partial(
    jax.jit,
    static_argnames=("range_cap", "expand", "max_elts", "max_dp", "p_cap",
                     "seed_len", "sample_seed", "sub_ftab"),
)
def _rank_frame_mega(idx, matpk, src2, off2, eff2, valid2, lseed2, m_ri,
                     m_fw, m_off, lens, mgn, read_ok, text_n, *,
                     range_cap, expand, max_elts, max_dp, p_cap, seed_len,
                     sample_seed=0, sub_ftab=False):
    """The WHOLE P2+P4-P6 stage as ONE executable: seed windows gathered
    from the resident packed read matrix (nothing but per-seed (row,
    offset) pairs cross the host->device link), then lax.map of the
    fused seed-search+resolve over the chunk axis, then the on-device
    rank/frame stage; everything the host needs comes back as one int32
    vector (single device->host copy)."""
    from ..ops.rank_frame import rank_frame

    def one(args):
        src, off, eff, v, ls = args
        # seeds shorter than seed_len (the reference clamps to
        # min(seed_len, rdlen), prepareSeed, aligner_seed.cpp:321-341):
        # alignment layout handled in _gather_seed_windows
        s = _gather_seed_windows(matpk, src, off, eff, seed_len,
                                 idx.ftab_k)
        return seed_search.search_resolve_seeds(idx, s, v, range_cap,
                                                expand, sample_seed,
                                                sub_ftab, lane_seed=ls)

    tops, bots, starts, offs = jax.lax.map(
        one, (src2, off2, eff2, valid2, lseed2)
    )
    probs, count, hn, he, ov = rank_frame(
        tops, bots, starts, offs, m_ri, m_fw, m_off, lens, mgn, read_ok,
        text_n, range_cap=range_cap, expand=expand, max_elts=max_elts,
        max_dp=max_dp, p_cap=p_cap, n_reads=lens.shape[0],
    )
    odt = probs.dtype  # int64 for .bt2l-scale genomes, else int32
    return jnp.concatenate([
        probs.reshape(-1),
        jnp.stack([count.astype(odt), ov.astype(odt)]),
        hn.astype(odt), he.astype(odt),
    ])


@functools.partial(
    jax.jit,
    static_argnames=("K", "NC", "SB", "roundi", "seed_len", "nrounds",
                     "range_cap", "expand", "max_elts", "max_dp", "p_cap",
                     "sample_seed", "sub_ftab", "nofw", "norc"),
)
def _rank_frame_mega_grid(idx, matpk, meta, active, text_n, *, K, NC, SB,
                          roundi, seed_len, nrounds, range_cap, expand,
                          max_elts, max_dp, p_cap, sample_seed, sub_ftab,
                          nofw, norc):
    """P2+P4-P6 in one executable with the seed grid computed ON DEVICE
    (ops/seed_search.device_seed_grid): the host ships one [npad, 4]
    int32 meta row per read ONCE per batch plus a per-round active mask
    — no per-seed arrays are uploaded (the _rank_frame_mega path ships
    4 chunked [S] arrays + 3 flat [S] arrays per round)."""
    from ..ops.rank_frame import rank_frame
    from ..ops.seed_search import device_seed_grid

    lens = meta[:, 0]
    mgn = meta[:, 1]
    read_ok = meta[:, 2] != 0
    ival = meta[:, 3]
    # per-read genRandSeed (int32 bit pattern -> uint32): mixed into the
    # wide-range row sampling for per-read pick diversity
    rdseed = jax.lax.bitcast_convert_type(meta[:, 4], jnp.uint32)
    npad = lens.shape[0]
    rs, d, eff, vg = device_seed_grid(
        lens, ival, active, K=K, seed_len=seed_len, nrounds=nrounds,
        roundi=roundi,
    )
    srcs, offs_, fws = [], [], []
    if not nofw:
        srcs.append(2 * rs)
        offs_.append(d)
        fws.append(jnp.ones(K, bool))
    if not norc:
        srcs.append(2 * rs + 1)
        offs_.append(lens[rs] - d - eff)
        fws.append(jnp.zeros(K, bool))

    def cat(xs):
        return jnp.concatenate(xs) if len(xs) > 1 else xs[0]

    src = cat(srcs)
    offw = cat(offs_)
    m_fw = cat(fws)
    eff2 = cat([eff] * len(srcs))
    valid = cat([vg] * len(srcs))
    lseed = cat([rdseed[jnp.clip(rs, 0, npad - 1)]] * len(srcs))
    m_ri = jnp.where(valid, cat([rs] * len(srcs)), npad).astype(jnp.int32)
    m_off = jnp.where(valid, offw, 0).astype(jnp.int32)

    def one(args):
        src, off, eff, v, ls = args
        # short-seed layout contract: see _gather_seed_windows
        s = _gather_seed_windows(matpk, src, off, eff, seed_len,
                                 idx.ftab_k)
        return seed_search.search_resolve_seeds(idx, s, v, range_cap,
                                                expand, sample_seed,
                                                sub_ftab, lane_seed=ls)

    if NC == 1:
        t1, b1, s1, o1 = one((src, m_off, eff2, valid, lseed))
        tops, bots, starts, offs = (t1[None], b1[None], s1[None], o1[None])
    else:
        tops, bots, starts, offs = jax.lax.map(
            one,
            (src.reshape(NC, SB), m_off.reshape(NC, SB),
             eff2.reshape(NC, SB), valid.reshape(NC, SB),
             lseed.reshape(NC, SB)),
        )
    probs, count, hn, he, ov = rank_frame(
        tops, bots, starts, offs, m_ri, m_fw, m_off, lens, mgn, read_ok,
        text_n, range_cap=range_cap, expand=expand, max_elts=max_elts,
        max_dp=max_dp, p_cap=p_cap, n_reads=npad,
    )
    odt = probs.dtype  # int64 for .bt2l-scale genomes, else int32
    return jnp.concatenate([
        probs.reshape(-1),
        jnp.stack([count.astype(odt), ov.astype(odt)]),
        hn.astype(odt), he.astype(odt),
    ])


def _prefetch(*arrs):
    """Start async device->host copies so chunked results stream back
    overlapped instead of one blocking copy per np.asarray."""
    for a in arrs:
        try:
            a.copy_to_host_async()
        except AttributeError:
            pass
    return arrs if len(arrs) > 1 else arrs[0]


class TPUAligner:
    def __init__(self, fm: FMIndex, scoring: Scoring | None = None,
                 opts: AlignOpts | None = None, mesh=None, share=None):
        """mesh: optional jax.sharding.Mesh with a 'data' axis — device
        phases then run SPMD data-parallel across its devices with the FM
        index replicated (SURVEY §2.4's OpenMP-batch -> device-mesh mapping).

        share: another TPUAligner over the SAME index — the new instance
        reuses its device index, unpacked text and window cache (read-only
        after construction) instead of uploading/uncompressing another
        copy. This is what makes -p2 overlap (two aligner instances, one
        per pipeline worker — models/pipeline.py) viable at genome scale:
        one 3.6 GB HBM-resident index serves both workers, the analog of
        the reference's one-index-many-threads sharing (--mm/--shmem,
        SURVEY §2.4)."""
        from ..utils.jaxcfg import enable_compile_cache

        enable_compile_cache()
        self.fm = fm
        self.sc = scoring or Scoring()
        self.opts = opts or AlignOpts()
        self.placer = None
        if mesh is not None:
            from ..parallel.mesh import MeshPlacer

            self.placer = MeshPlacer(mesh)
        if share is not None:
            if share.fm is not fm:
                raise ValueError("share= must wrap the same FMIndex")
            self.placer = share.placer
            self.idx = share.idx
            self.text = share.text
            self._win_cache = getattr(share, "_win_cache", None) or {}
            share._win_cache = self._win_cache
        else:
            self.idx = DeviceIndex.from_host(fm)
            if self.placer is not None:
                self.idx = self.placer.put_index(self.idx)
            self.text = dna.unpack_2bit(fm.ref_words, fm.n)
        self._large_index = (
            str(jnp.asarray(self.idx.fchr).dtype) == "int64"
        )
        self.mm_tab = self.sc.mm_table()
        self.swp = sw.SWParams.from_scoring(self.sc)
        o = self.opts
        self.timers = PhaseTimers()
        self.metrics = PipelineMetrics()
        # self-tuning DP side-buffer size (multiplies _bt_gap_cap): at
        # genome scale the gapped-alignment fraction can exceed B/16,
        # and each overflow costs a full-size synchronous retry dispatch
        # (measured 13.3 s/1M reads at 3.1 Gbp — every chunk retried).
        # One overflow doubles the cap for every later dispatch.
        self._gap_cap_mult = 1
        if self.placer is not None and self.placer.model_axis is not None:
            # tensor-parallel index: seed search runs under shard_map so
            # each rank/walk gather recombines the owner device's block
            # record with a psum (parallel/tp_index.py)
            from ..parallel.tp_index import tp_search_resolve_fn

            _tp_fns: dict = {}

            def _srf(idx, seeds, valid, lseed, cap, expand,
                     sub_ftab=False):
                key = (cap, expand, sub_ftab)
                if key not in _tp_fns:
                    _tp_fns[key] = tp_search_resolve_fn(
                        idx, self.placer.mesh, cap, expand,
                        self.placer.model_axis,
                        sample_seed=self.opts.rng_seed & 0xFFFFFFFF,
                        sub_ftab=sub_ftab,
                    )
                return _tp_fns[key](idx, seeds, valid, lseed)

            self._search_resolve_fn = _srf
        else:
            # pack the four result arrays into ONE on device: one
            # device->host copy per chunk instead of four
            _sseed = o.rng_seed & 0xFFFFFFFF

            def _sr_packed(idx, chunk, valid, lseed, cap, expand,
                           sub_ftab=False):
                t, b, st, of = seed_search.search_resolve_seeds(
                    idx, chunk, valid, cap, expand, _sseed, sub_ftab,
                    lane_seed=lseed,
                )
                return jnp.concatenate([t, b, st.astype(t.dtype), of])

            def _sr_mega(idx, seeds3, valid2, lseed2, cap, expand,
                         sub_ftab=False):
                # ALL seed chunks in one executable (lax.map over the
                # chunk axis) and ONE packed result copy
                def one(args):
                    s, v, ls = args
                    return _sr_packed(idx, s, v, ls, cap, expand, sub_ftab)

                return jax.lax.map(one, (seeds3, valid2, lseed2))

            self._search_resolve_fn = None
            self._search_resolve_packed = jax.jit(
                _sr_packed, static_argnums=(4, 5, 6)
            )
            self._search_resolve_mega = jax.jit(
                _sr_mega, static_argnums=(4, 5, 6)
            )
            # fused rank/frame path: the whole P4-P6 stage runs in one
            # executable (ops/rank_frame.py via _rank_frame_mega); one
            # packed table comes back instead of every range/offset array
            import os as _os_

            # default ON (BT2TPU_FUSED_RANK=0 selects the host path)
            _fenv = _os_.environ.get("BT2TPU_FUSED_RANK")
            self._use_fused_rank = _fenv != "0"
        # local-mode DP adapter: same (best, bestcol, ops, startcol) head
        # as the e2e kernel, plus (bestrow, startrow) — the soft-clip
        # endpoints — appended to the packed header (hdr width 5 not 3)
        def _local_bt(reads, pens, rdlens, refs, wlens, p):
            best, brow, bcol, opsp, stc, srow = sw.sw_local_backtrace_batch(
                reads, pens, rdlens, refs, wlens, p
            )
            return best, bcol, opsp, stc, brow, srow

        dp_fn = _local_bt if o.local else sw.sw_e2e_backtrace_batch
        self._hdr_w = 5 if o.local else 3

        def _pack_bt_out(best, bestcol, stc, extra, opsp, cap):
            # Compacted DP result: alignments without indels (the vast
            # majority) ship NO op string — their op row is `m_count`
            # M's, synthesized on host; only gapped rows scatter their
            # packed ops into a small side buffer, shrinking the
            # per-dispatch payload from [B, hdr+96] to [B, hdr+1] +
            # [B/4, 96].
            # Layout (flat int32): hdr_ext [B, hw+1] ++ side [cap, P4/4]
            # ++ [gap_count]; hdr_ext[:, -1] = opsinfo (>= 0: pure-M
            # count; < 0: -(side_slot + 1)).  gap_count > cap means the
            # side buffer overflowed (caller retries with the full
            # layout).
            B, P = opsp.shape
            P4 = -(-P // 4) * 4
            # opsp bytes hold FOUR 2-bit op fields each (pack_ops2): a
            # field is I/D iff its high bit is set (codes 2/3), M iff
            # low set + high clear (code 1)
            hi = opsp & jnp.uint8(0xAA)
            gap = jnp.any(hi != 0, axis=1)
            m_bits = opsp & jnp.uint8(0x55) & jnp.bitwise_not(hi >> 1)
            mcnt = jax.lax.population_count(m_bits).astype(
                jnp.int32).sum(axis=1)
            gidx = jnp.cumsum(gap.astype(jnp.int32)) - gap.astype(jnp.int32)
            opsinfo = jnp.where(gap, -(gidx + 1), mcnt)
            w = jnp.pad(opsp, ((0, 0), (0, P4 - P)))
            w = jax.lax.bitcast_convert_type(
                w.reshape(B, P4 // 4, 4), jnp.int32
            )
            slot = jnp.where(gap, jnp.minimum(gidx, cap), cap)
            side = jnp.zeros((cap + 1, P4 // 4), jnp.int32).at[slot].set(w)
            hdr = jnp.stack(
                [best.astype(jnp.int32), bestcol.astype(jnp.int32),
                 stc.astype(jnp.int32)]
                + [x.astype(jnp.int32) for x in extra]
                + [opsinfo], axis=1,
            )
            return jnp.concatenate([
                hdr.reshape(-1), side[:cap].reshape(-1),
                jnp.sum(gap.astype(jnp.int32))[None],
            ])

        def _bt_packed(fn):
            # ONE packed input put and ONE packed result copy per DP
            # dispatch: big uint8 [B, 2L] = reads|pens, small [B, 3] = (rdlen,
            # wlen, wstart); the reference window is gathered ON DEVICE
            # from the resident 2-bit text (gather_ref_windows) instead
            # of uploading [B, C] bytes every dispatch.
            # host_refs=True keeps the old inline layout (big [B, 2L+C])
            # for windows wider than the text's tail padding.
            def wrapped(big, small, refw, p, L, C, host_refs, cap):
                reads = jax.lax.bitcast_convert_type(big[:, :L], jnp.int8)
                pens = big[:, L : 2 * L]
                if host_refs:
                    refs = jax.lax.bitcast_convert_type(
                        big[:, 2 * L :], jnp.int8
                    )
                else:
                    refs = sw.gather_ref_windows(
                        refw, small[:, 2], small[:, 1], C
                    )
                best, bestcol, opsp, stc, *extra = fn(
                    reads, pens, small[:, 0].astype(jnp.int32), refs,
                    small[:, 1].astype(jnp.int32), p
                )
                return _pack_bt_out(best, bestcol, stc, extra, opsp, cap)

            return jax.jit(wrapped, static_argnums=(3, 4, 5, 6, 7))

        def _bt_packed_mat(fn):
            # index-only DP dispatch: the oriented read/pen matrices are
            # put on device ONCE per batch (align_batch), so a dispatch
            # ships just [B, 4] ints (src row, rdlen, wlen, wstart) —
            # reads/pens are row gathers, the reference window comes from
            # the resident 2-bit text.  ~20x fewer bytes uploaded than
            # the inline layout; every later dispatch (round 2,
            # escalation, irregular classes, backtrace re-runs) reuses
            # the same resident matrices for free.
            def wrapped(small, matpk, refw, p, L, C, cap):
                rows = small[:, 0].astype(jnp.int32)
                pk = matpk[rows]  # [B, W] u8/u16: read code | pen << 4
                W = pk.shape[1]
                if W < L:  # length class wider than this batch's matrix
                    pk = jnp.pad(pk, ((0, 0), (0, L - W)),
                                 constant_values=4)
                else:
                    pk = pk[:, :L]
                reads = (pk & 0xF).astype(jnp.int8)
                pens = (pk >> 4).astype(jnp.int32)
                refs = sw.gather_ref_windows(
                    refw, small[:, 3], small[:, 2], C
                )
                best, bestcol, opsp, stc, *extra = fn(
                    reads, pens, small[:, 1].astype(jnp.int32), refs,
                    small[:, 2].astype(jnp.int32), p
                )
                return _pack_bt_out(best, bestcol, stc, extra, opsp, cap)

            return jax.jit(wrapped, static_argnums=(3, 4, 5, 6))

        self._sw_bt = _bt_packed(dp_fn)
        self._sw_bt_mat = _bt_packed_mat(dp_fn)
        # index-only dispatch needs a globally-addressable matrix row
        # gather. Single device: trivially. Data mesh: the packed read
        # matrix REPLICATES per device (~10 MB/batch — negligible next
        # to the index) so row gathers stay local and XLA inserts no
        # collectives. Only a model-sharded (tp-index) mesh falls back
        # to inline rows.
        self._dp_from_mat = (
            self.placer is None or self.placer.model_axis is None
        )
        self._dev_mat = None
        self._put = _put_factory(self.placer)
        self._put_chunked = (
            jnp.asarray if self.placer is None
            else (lambda a: self.placer.put_chunked(jnp.asarray(a)))
        )

    # ---------------- P2: seed instantiation ----------------

    def _instantiate_seeds(self, reads, indices=None, roundi: int = 0):
        """Returns (seeds [S, seed_len] int8, meta (ri, fw, off) int arrays).

        Offsets every interval from the 5' end of each orientation; round
        r>0 shifts the start by interval*r/nrounds (ref: prepareOneSeed
        call sites, bt2_search.cpp:2538-2584; instantiateSeeds,
        aligner_seed.cpp:301-313, 397-447). Vectorized per read-length
        group: fw seeds at offsets start, start+ival, ...; rc seeds
        extracted mirrored (offset rdlen-depth-sl in the rc read).
        """
        o = self.opts
        sl = o.seed_len
        if indices is None:
            indices = range(len(reads))
        mat = getattr(self, "_mat_reads", None)
        vec = None
        if mat is not None:
            idx = np.asarray(list(indices), np.int64)
            fits = self._mat_lens[idx] <= mat.shape[1]
            vec = self._instantiate_seeds_vec(idx[fits], roundi)
            if fits.all():
                return vec
            indices = idx[~fits].tolist()  # long reads: grouped fallback
        groups: dict[int, list] = {}
        for ri in indices:
            groups.setdefault(len(reads[ri].seq), []).append(ri)
        seed_chunks, ri_chunks, fw_chunks, off_chunks = [], [], [], []
        if vec is not None and len(vec[0]):
            seed_chunks.append(vec[0])
            ri_chunks.append(vec[1][0])
            fw_chunks.append(vec[1][1])
            off_chunks.append(vec[1][2])
        for ln, ris in sorted(groups.items()):
            if ln < sl:
                continue
            ival = max(1, int(o.ival.f(float(ln))))
            nrounds = min(o.nrounds, ival)
            if roundi >= nrounds:
                continue
            start = (ival * roundi) // nrounds
            if start > 0 and sl + start > ln:
                continue
            depths = np.arange(start, ln - sl + 1, ival)
            nd = len(depths)
            if nd == 0:
                continue
            ris_a = np.asarray(ris, np.int32)
            # reuse the oriented batch matrices (build_read_matrices runs
            # first): row 2ri = fw seq, 2ri+1 = rc — skips re-stacking
            # and re-complementing every group
            mat = getattr(self, "_mat_reads", None)
            if mat is not None and ln <= mat.shape[1]:
                seqs = mat[2 * ris_a.astype(np.int64)]
                rcs_rows = (mat[2 * ris_a.astype(np.int64) + 1]
                            if not o.norc else None)
            else:
                seqs = np.stack([reads[ri].seq for ri in ris])  # [G, ln]
                rcs_rows = (dna.revcomp_batch(seqs)
                            if not o.norc else None)
            win = depths[:, None] + np.arange(sl)[None, :]  # [nd, sl]
            if not o.nofw:
                fw_seeds = seqs[:, win].reshape(-1, sl)  # [G*nd, sl]
                seed_chunks.append(fw_seeds)
                ri_chunks.append(np.repeat(ris_a, nd))
                fw_chunks.append(np.ones(len(ris_a) * nd, bool))
                off_chunks.append(np.tile(depths, len(ris_a)))
            if not o.norc:
                rc_offs = ln - depths - sl
                rwin = rc_offs[:, None] + np.arange(sl)[None, :]
                rc_seeds = rcs_rows[:, rwin].reshape(-1, sl)
                seed_chunks.append(rc_seeds)
                ri_chunks.append(np.repeat(ris_a, nd))
                fw_chunks.append(np.zeros(len(ris_a) * nd, bool))
                off_chunks.append(np.tile(rc_offs, len(ris_a)))
        if not seed_chunks:
            return np.zeros((0, sl), np.int8), (
                np.zeros(0, np.int32), np.zeros(0, bool), np.zeros(0, np.int32)
            )
        seeds = np.concatenate(seed_chunks).astype(np.int8)
        meta = (
            np.concatenate(ri_chunks),
            np.concatenate(fw_chunks),
            np.concatenate(off_chunks).astype(np.int32),
        )
        return seeds, meta

    def _instantiate_seeds_vec(self, idx: np.ndarray, roundi: int):
        """Group-free seed instantiation for reads resident in the batch
        matrices: per-read depth counts by arithmetic, all seed windows by
        one flat gather per orientation. Within-read seed order (depths
        ascending, fw block before rc block) matches the grouped path."""
        o = self.opts
        sl = o.seed_len
        lens = self._mat_lens[idx].astype(np.int64)
        rsel, d, eff_s = self._seed_grid(idx, lens, roundi)
        S = len(rsel)
        if S == 0:
            return np.zeros((0, sl), np.int8), (
                np.zeros(0, np.int32), np.zeros(0, bool),
                np.zeros(0, np.int32),
            )
        ri_s = idx[rsel]
        mat = self._mat_reads
        L = mat.shape[1]
        flat = mat.reshape(-1)
        j = np.arange(sl, dtype=np.int64)
        # short seeds: right-aligned when they can still ftab-jump
        # (eff >= ftab_k), left-aligned below (sub-ftab lanes; layout
        # contract in ops/seed_search.py search_seeds)
        shift = np.where(eff_s >= self.fm.ftab_k, sl - eff_s, 0)
        jj = j[None, :] - shift[:, None]
        real = (jj >= 0) & (jj < eff_s[:, None])

        def win(base):
            v = flat[base[:, None] + np.clip(jj, 0, None)]
            if not real.all():
                v = np.where(real, v, np.int8(-1))
            return v

        chunks, metas = [], []
        if not o.nofw:
            chunks.append(win(2 * ri_s * L + d))
            metas.append((ri_s, np.ones(S, bool), d))
        if not o.norc:
            rc_off = lens[rsel] - d - eff_s  # mirrored rc offsets
            chunks.append(win((2 * ri_s + 1) * L + rc_off))
            metas.append((ri_s, np.zeros(S, bool), rc_off))
        seeds = np.concatenate(chunks) if len(chunks) > 1 else chunks[0]
        return seeds, (
            np.concatenate([m[0] for m in metas]).astype(np.int32),
            np.concatenate([m[1] for m in metas]),
            np.concatenate([m[2] for m in metas]).astype(np.int32),
        )

    def _seed_grid(self, idx, lens, roundi: int):
        """Per-seed (read sel, fw offset, effective length) for one round.

        roundi >= 0: the reference's multiseed grid — seeds of
        min(seed_len, rdlen) every ival(rdlen), round offsets staggered
        (prepareSeed/instantiateSeeds, aligner_seed.cpp:321-447).

        roundi == -1: the up-front-rescue round — TWO half-read exact
        seeds (prefix + suffix). Upstream bowtie2 catches 1-mismatch
        reads whose every multiseed crosses the mismatch with a
        bidirectional 1mm end-to-end search (do1mmUpFront); the fork
        compiled that out with the mirror index (bt2_search.cpp:
        4018-4034 #if 0). Same guarantee, existing machinery: any
        1-mismatch (or 1-small-gap) alignment has an exact half, so the
        half seeds feed the normal resolve+DP path."""
        o = self.opts
        sl = o.seed_len
        if roundi < 0:
            h = np.minimum(sl, np.maximum(1, lens // 2))
            rsel = np.repeat(np.arange(len(idx), dtype=np.int64), 2)
            second = np.arange(2 * len(idx)) % 2 == 1
            d = np.where(second, lens[rsel] - h[rsel], 0)
            return rsel, d, h[rsel]
        # min(seed_len, rdlen) clamp: short reads yield one full-read
        # seed, stored right-aligned with -1 padding (prepareSeed,
        # aligner_seed.cpp:321-341; pad semantics in ops/seed_search.py)
        eff = np.minimum(lens, sl)
        ivals = np.maximum(1, o.ival.f_vec(lens.astype(np.float64)))
        nr = np.minimum(o.nrounds, ivals)
        start = (ivals * roundi) // nr
        count = np.where(
            (roundi < nr) & (lens >= 1) & (start <= lens - eff),
            (lens - eff - start) // ivals + 1,
            0,
        )
        S = int(count.sum())
        rsel = np.repeat(np.arange(len(idx), dtype=np.int64), count)
        k = np.arange(S, dtype=np.int64)
        k -= np.repeat(np.cumsum(count) - count, count)
        d = start[rsel] + k * ivals[rsel]  # fw 5' seed offsets
        return rsel, d, eff[rsel]

    def _instantiate_seeds_meta(self, indices, roundi: int):
        """(m_ri, m_fw, m_off, m_eff) for the fused device path: the same
        seed multiset _instantiate_seeds would emit, WITHOUT materializing
        the seed windows — the device gathers them from the resident
        packed read matrix (_rank_frame_mega).  Reads longer than the
        matrix width (> l_hard, truncated, read_ok=False anyway) clamp
        their depth range to the resident prefix."""
        o = self.opts
        idx = np.asarray(list(indices), np.int64)
        W = self._mat_reads.shape[1]
        lens = np.minimum(self._mat_lens[idx], W).astype(np.int64)
        rsel, d, eff_s = self._seed_grid(idx, lens, roundi)
        S = len(rsel)
        if S == 0:
            z32 = np.zeros(0, np.int32)
            return (z32, np.zeros(0, bool), z32, z32)
        ri_s = idx[rsel].astype(np.int32)
        eff32 = eff_s.astype(np.int32)
        metas = []
        if not o.nofw:
            metas.append((ri_s, np.ones(S, bool), d.astype(np.int32)))
        if not o.norc:
            rc_off = (lens[rsel] - d - eff_s).astype(np.int32)
            metas.append((ri_s, np.zeros(S, bool), rc_off))
        return (
            np.concatenate([m[0] for m in metas]),
            np.concatenate([m[1] for m in metas]),
            np.concatenate([m[2] for m in metas]),
            np.concatenate([eff32] * len(metas)),
        )

    # ---------------- device phase helpers (padded chunking) ----------------

    def _search_resolve(self, seeds: np.ndarray,
                        lseed: np.ndarray | None = None):
        """Chunked fused search+resolve. Returns (tops, bots, offs_of) where
        offs_of(si) -> np array of resolved joined offsets for seed si
        (first min(width, range_cap) SA rows; -1 = unresolved).

        Identical seed INSTANCES are searched ONCE: FM search + SA
        resolution are pure functions of (seed text, per-read sample
        seed), and reads share many seeds (lambda 10K: ~26% duplicates;
        more on repetitive genomes), so instances are deduped up front
        and the per-unique results fanned back out by index.  lseed
        (uint32 [S]) is each lane's per-read genRandSeed, mixed into the
        wide-range row sampling (ops/seed_search.search_resolve_seeds) —
        it joins the dedupe key so distinct reads keep distinct draws."""
        if lseed is None:
            lseed = np.zeros(len(seeds), np.uint32)
        if len(seeds) > 1024 and seeds.shape[1] <= 24:  # 6^24 < 2^63
            key = np.zeros(len(seeds), np.int64)
            for j in range(seeds.shape[1]):  # base-6 (codes -1..4 -> 0..5)
                key = key * 6 + (seeds[:, j] + 1)
            uniq, first, inv = np.unique(
                np.stack([key, lseed.astype(np.int64)], 1), axis=0,
                return_index=True, return_inverse=True,
            )
            inv = inv.reshape(-1)  # numpy 2.x keeps the stacked shape
            if len(uniq) <= 0.92 * len(seeds):
                tops, bots, (offs, start, end) = self._search_resolve_impl(
                    seeds[first], lseed[first]
                )
                return tops[inv], bots[inv], (offs, start[inv], end[inv])
        return self._search_resolve_impl(seeds, lseed)

    def _search_resolve_impl(self, seeds: np.ndarray, lseed: np.ndarray):
        o = self.opts
        S = len(seeds)
        npdt = np.asarray(self.idx.fchr).dtype
        tops = np.zeros(S, npdt)
        bots = np.zeros(S, npdt)
        nchunks = (S + o.seed_batch - 1) // o.seed_batch
        chunk_starts = [None] * nchunks
        chunk_offs = [None] * nchunks
        packed_mode = getattr(self, "_search_resolve_fn", None) is None
        SB = o.seed_batch
        # sub-ftab lanes (reads shorter than ftab_k) are right-padded
        sub_ftab = bool(S) and bool((seeds[:, -1] < 0).any())
        futs = []
        if packed_mode:
            # one executable + one result copy for ALL chunks
            seeds3 = np.zeros((nchunks, SB, seeds.shape[1]), np.int8)
            valid2 = np.zeros((nchunks, SB), bool)
            lseed2 = np.zeros((nchunks, SB), np.uint32)
            for ci, lo in enumerate(range(0, S, SB)):
                hi = min(lo + SB, S)
                seeds3[ci, : hi - lo] = seeds[lo:hi]
                valid2[ci, : hi - lo] = True
                lseed2[ci, : hi - lo] = lseed[lo:hi]
            a2d = np.asarray(self._search_resolve_mega(
                self.idx, self._put_chunked(seeds3),
                self._put_chunked(valid2), self._put_chunked(lseed2),
                o.range_cap, o.resolve_expand, sub_ftab,
            ))
            for ci, lo in enumerate(range(0, S, SB)):
                hi = min(lo + SB, S)
                futs.append((ci, lo, hi, seeds3[ci], valid2[ci],
                             lseed2[ci], a2d[ci]))
        else:
            for ci, lo in enumerate(range(0, S, SB)):
                hi = min(lo + SB, S)
                chunk = np.zeros((SB, seeds.shape[1]), np.int8)
                chunk[: hi - lo] = seeds[lo:hi]
                valid = np.zeros(SB, bool)
                valid[: hi - lo] = True
                lsc = np.zeros(SB, np.uint32)
                lsc[: hi - lo] = lseed[lo:hi]
                res = _prefetch(*self._search_resolve_fn(
                    self.idx, self._put(chunk), self._put(valid),
                    self._put(lsc), o.range_cap, o.resolve_expand,
                    sub_ftab,
                ))
                futs.append((ci, lo, hi, chunk, valid, lsc, res))
        rmax = int(o.seed_batch * o.resolve_expand)
        for ci, lo, hi, chunk, valid, lsc, res in futs:
            if packed_mode:
                a = res
                t, b = a[:SB], a[SB : 2 * SB]
                st, of = a[2 * SB : 3 * SB], a[3 * SB :]
            else:
                t, b, st, of = res
            tops[lo:hi] = np.asarray(t)[: hi - lo]
            bots[lo:hi] = np.asarray(b)[: hi - lo]
            st = np.asarray(st)
            # compaction-buffer overflow (sum of min(width, cap) > rmax):
            # retry the chunk with a wider expansion — rare, repeat-heavy
            w_last = min(int(bots[hi - 1] - tops[hi - 1]), o.range_cap)                 if hi > lo else 0
            if hi > lo and int(st[hi - lo - 1]) + w_last > rmax:
                if packed_mode:
                    a2 = np.asarray(self._search_resolve_packed(
                        self.idx, self._put(chunk), self._put(valid),
                        self._put(lsc), o.range_cap, o.range_cap,
                        sub_ftab,
                    ))
                    st2, of2 = a2[2 * SB : 3 * SB], a2[3 * SB :]
                else:
                    _, _, st2, of2 = self._search_resolve_fn(
                        self.idx, self._put(chunk), self._put(valid),
                        self._put(lsc), o.range_cap, o.range_cap,
                        sub_ftab,
                    )
                chunk_starts[ci] = np.asarray(st2)
                chunk_offs[ci] = np.asarray(of2)
            else:
                chunk_starts[ci] = st
                chunk_offs[ci] = np.asarray(of)

        cap = o.range_cap

        # flat offsets across chunks: the element slots of seed si live at
        # glob_offs[glob_start[si] : glob_start[si] + min(width, cap)],
        # capped at glob_end[si] (compaction spill -> no slots)
        glob_offs = np.concatenate(chunk_offs) if chunk_offs else _EMPTY_OFFS
        glob_start = np.zeros(S, np.int64)
        glob_end = np.zeros(S, np.int64)
        base = 0
        for ci in range(nchunks):
            lo = ci * o.seed_batch
            hi = min(lo + o.seed_batch, S)
            glob_start[lo:hi] = base + chunk_starts[ci][: hi - lo]
            base += len(chunk_offs[ci])
            glob_end[lo:hi] = base

        return tops, bots, (glob_offs, glob_start, glob_end)

    def _rank_frame_device(self, m_ri, m_fw, m_off, m_eff, lens_pad,
                           mgn_pad, read_ok_pad):
        """Fused instantiate+search+resolve+rank+frame: per-seed (matrix
        row, offset) pairs go up, ONE packed problem table comes back —
        neither seed windows nor range/offset tables cross the bus.
        Returns (problems [count, 4] in the index dtype (int64 for
        .bt2l-scale genomes), hit_nonz, hit_elts) or None when a fixed
        table overflowed (caller reruns the host path)."""
        o = self.opts
        S_act = len(m_ri)
        SB = o.seed_batch
        NC = (S_act + SB - 1) // SB
        S = NC * SB
        src_p = np.zeros(S, np.int32)
        src_p[:S_act] = 2 * m_ri.astype(np.int32) + (~m_fw)
        offw_p = np.zeros(S, np.int32)
        offw_p[:S_act] = m_off
        # per-seed effective length (min(seed_len, rdlen) on normal
        # rounds, half-read on the rescue round — see _seed_grid)
        eff_p = np.full(S, o.seed_len, np.int32)
        eff_p[:S_act] = m_eff
        valid2 = np.zeros(S, bool)
        valid2[:S_act] = True
        lseed_p = np.zeros(S, np.uint32)
        lseed_p[:S_act] = self._batch_rdseed()[m_ri]
        npad = len(lens_pad)
        ri_p = np.full(S, npad, np.int32)
        ri_p[:S_act] = m_ri
        fw_p = np.zeros(S, bool)
        fw_p[:S_act] = m_fw
        off_p = np.zeros(S, np.int32)
        off_p[:S_act] = m_off
        with self.timers.phase("searchResolve.put"):
            d_src = self._put_chunked(src_p.reshape(NC, SB))
            d_offw = self._put_chunked(offw_p.reshape(NC, SB))
            d_eff = self._put_chunked(eff_p.reshape(NC, SB))
            d_valid = self._put_chunked(valid2.reshape(NC, SB))
            d_lseed = self._put_chunked(lseed_p.reshape(NC, SB))
        _t_disp = self.timers.phase("searchResolve.dispatch")
        _t_disp.__enter__()
        packed = _rank_frame_mega(
            self.idx, self._dev_mat, d_src, d_offw, d_eff, d_valid,
            d_lseed, self._put(ri_p), self._put(fw_p), self._put(off_p),
            self._put(lens_pad), self._put(mgn_pad),
            self._put(read_ok_pad),
            np.int64(self.fm.n) if self._large_index else
            np.int32(self.fm.n),
            range_cap=o.range_cap, expand=o.resolve_expand,
            max_elts=o.max_elts_per_read, max_dp=o.max_dp_per_read,
            # problem-table rows scale with the batch: typical yield is
            # ~1.2 problems/read (fw+rc diagonals), so a fixed 32K table
            # overflowed on every full 32K-read batch — and the silent
            # host-path fallback halved genome-scale throughput
            p_cap=max(P_CAP, 2 * npad), seed_len=o.seed_len,
            sample_seed=o.rng_seed & 0xFFFFFFFF,
            sub_ftab=bool((eff_p[:S_act] < self.fm.ftab_k).any()),
        )
        _t_disp.__exit__(None, None, None)
        p_cap = max(P_CAP, 2 * npad)
        with self.timers.phase("searchResolve.wait"):
            a = np.asarray(packed)
        count, ov = int(a[2 * p_cap]), int(a[2 * p_cap + 1])
        if ov or count > p_cap:
            return None
        probs = a[: 2 * count].reshape(count, 2) if count else \
            np.zeros((0, 2), np.int32)
        hn = a[2 * p_cap + 2 : 2 * p_cap + 2 + npad]
        he = a[2 * p_cap + 2 + npad :]
        return probs, hn, he

    def _reframe_slim(self, probs, lens_all, mgn_all):
        """(src, diag) slim device table -> full Problems: wstart/wlen
        recomputed with rank_frame's exact clamps (read len clamped to
        the matrix width — the value the device meta carried; window
        clipped to [0, n)).  Shipping only 2 of 4 columns halves the
        mega's dominant device->host payload."""
        if not len(probs):
            return Problems(np.zeros(0, np.int64), np.zeros(0, np.int64),
                            np.zeros(0, np.int32), np.zeros(0, np.int64))
        src = probs[:, 0]
        cand = probs[:, 1].astype(np.int64)
        ri = (src >> 1).astype(np.int64)
        W = self._mat_reads.shape[1]
        ln = np.minimum(lens_all[ri], W)
        mg = mgn_all[ri]
        ws = np.maximum(0, cand - mg)
        we = np.minimum(self.fm.n, cand + ln + mg)
        return Problems(src, ws, we - ws, cand)

    def _grid_meta(self, mgn_all, read_ok):
        """Per-batch device meta for the grid mega: [npad, 5] int32
        (len clamped to the matrix width, narrow slack, read_ok, seed
        interval, per-read genRandSeed as an int32 bit pattern).  Built+
        put ONCE per batch (build_read_matrices clears it); rounds ship
        only the active mask."""
        o = self.opts
        n = len(self._mat_lens)
        npad = 1 << max(8, (n - 1).bit_length())
        W = self._mat_reads.shape[1]
        lens_c = np.minimum(self._mat_lens, W).astype(np.int32)
        ivals = np.maximum(1, o.ival.f_vec(
            np.maximum(lens_c, 1).astype(np.float64)
        )).astype(np.int32)
        meta = np.zeros((npad, 5), np.int32)
        meta[:n, 0] = lens_c
        meta[:n, 1] = mgn_all
        meta[:n, 2] = read_ok
        meta[:n, 3] = ivals
        meta[:n, 4] = self._batch_rdseed().view(np.int32)
        self._meta_host = (lens_c, ivals, npad)
        self._meta_dev = self._put(meta)

    def _rank_frame_device_grid(self, active, roundi, mgn_all, read_ok):
        """Fused instantiate+search+resolve+rank+frame with the seed grid
        computed on device: ships one [npad] active mask per round (plus
        the per-batch meta on first use).  Returns (probs, hn, he,
        n_seeds), the string "empty" when the round emits no seeds, or
        None when the fixed table overflowed (caller reruns the host
        path)."""
        h = self._grid_dispatch(active, roundi, mgn_all, read_ok)
        if isinstance(h, str):
            return h
        return self._grid_collect(h)

    def _grid_dispatch(self, active, roundi, mgn_all, read_ok):
        """Dispatch half of _rank_frame_device_grid: queues the mega on
        the device and returns an opaque handle for _grid_collect — the
        cross-batch software pipeline (align_stream) dispatches batch
        k+1's round-0 mega while batch k's host phases run, so the device
        never idles between batches (the device analog of the fork's
        resident-batch refill keeping every phase's workers busy,
        bt2_search.cpp:2297-2888)."""
        o = self.opts
        if getattr(self, "_meta_dev", None) is None:
            with self.timers.phase("searchResolve.put"):
                self._grid_meta(mgn_all, read_ok)
        lens_c, ivals, npad = self._meta_host
        n = len(lens_c)
        act = np.zeros(npad, bool)
        act[np.asarray(active, np.int64)] = True
        # size the static lane count with the same integer arithmetic
        # the device grid uses (ops/seed_search.device_seed_grid)
        sl = o.seed_len
        a = act[:n]
        if roundi < 0:
            eff = np.minimum(sl, np.maximum(1, lens_c // 2))
            cnt = np.where(a & (lens_c >= 1), 2, 0)
        else:
            eff = np.minimum(lens_c, sl)
            nr = np.minimum(o.nrounds, ivals)
            start = (ivals * roundi) // nr
            cnt = np.where(
                a & (roundi < nr) & (lens_c >= 1)
                & (start <= lens_c - eff),
                (lens_c - eff - start) // ivals + 1,
                0,
            )
        G = int(cnt.sum())
        if G == 0:
            return "empty"
        sub_ftab = bool((eff[cnt > 0] < self.fm.ftab_k).any())
        orients = int(not o.nofw) + int(not o.norc)
        # ONE wide chunk, lanes padded to a power of two: the chunked
        # lax.map serialized 26 fori-loop gather steps PER CHUNK; flat
        # lanes issue each LF/walk step as one wide gather instead
        # (bounded by grid_lanes_cap — transient gather blocks are
        # [2*lanes, 128] u32)
        lanes = orients * G
        cap_l = o.grid_lanes_cap
        if lanes <= cap_l:
            S = 1 << max(13, (lanes - 1).bit_length())
            NC, SB = 1, S
        else:
            SB = cap_l
            NC = (lanes + SB - 1) // SB
        K = NC * SB // orients
        p_cap = max(P_CAP, 2 * npad)
        with self.timers.phase("searchResolve.put"):
            d_act = self._put(act)
        _t_disp = self.timers.phase("searchResolve.dispatch")
        _t_disp.__enter__()
        packed = _rank_frame_mega_grid(
            self.idx, self._dev_mat, self._meta_dev, d_act,
            np.int64(self.fm.n) if self._large_index else
            np.int32(self.fm.n),
            K=K, NC=NC, SB=SB, roundi=roundi, seed_len=sl,
            nrounds=o.nrounds, range_cap=o.range_cap,
            expand=o.resolve_expand, max_elts=o.max_elts_per_read,
            max_dp=o.max_dp_per_read, p_cap=p_cap,
            sample_seed=o.rng_seed & 0xFFFFFFFF, sub_ftab=sub_ftab,
            nofw=o.nofw, norc=o.norc,
        )
        _t_disp.__exit__(None, None, None)
        return packed, p_cap, npad, orients * G

    def _grid_collect(self, handle):
        """Wait half of _rank_frame_device_grid (see _grid_dispatch)."""
        packed, p_cap, npad, n_seeds = handle
        with self.timers.phase("searchResolve.wait"):
            a = np.asarray(packed)
        count, ov = int(a[2 * p_cap]), int(a[2 * p_cap + 1])
        if ov or count > p_cap:
            return None
        probs = a[: 2 * count].reshape(count, 2) if count else \
            np.zeros((0, 2), np.int32)
        hn = a[2 * p_cap + 2 : 2 * p_cap + 2 + npad]
        he = a[2 * p_cap + 2 + npad :]
        return probs, hn, he, n_seeds

    # windows wider than the device text's tail padding (ops/sw.py
    # gather_ref_windows; DeviceIndex pads 128 words = 2048 bases) ship
    # host-gathered refs inline instead
    _DEVICE_REFS_MAX_C = 2000

    def _pack_dp_inputs(self, problems, L: int, C: int,
                        need_rows: bool = True):
        """Vectorized DP problem assembly: oriented read rows gathered
        from the per-batch matrices (no per-problem Python).  Reference
        windows stay on device (gathered from the resident 2-bit text)
        unless C exceeds the tail-padding envelope; with need_rows=False
        (index-only dispatch) reads/pens stay on device entirely."""
        n = len(problems)
        if isinstance(problems, Problems):
            src, ws, wl = problems.src, problems.wstart, problems.wlen
        else:  # list-of-dicts path (paired rescue, backtrace re-runs)
            src = np.fromiter((p["src"] for p in problems), np.int64, n)
            ws = np.fromiter((p["wstart"] for p in problems), np.int64, n)
            wl = np.fromiter((p["wlen"] for p in problems), np.int32, n)
        rdlens = self._mat_lens[src // 2]
        if not need_rows:
            return None, None, rdlens, None, ws, wl, src
        W = self._mat_reads.shape[1]
        if L <= W:
            reads = self._mat_reads[src, :L]
            pens = self._mat_pens[src, :L]
        else:  # length-class L wider than this batch's matrices: pad
            reads = np.full((n, L), 4, np.int8)
            reads[:, :W] = self._mat_reads[src]
            pens = np.zeros((n, L), np.uint8)
            pens[:, :W] = self._mat_pens[src]
        if C <= self._DEVICE_REFS_MAX_C:
            return reads, pens, rdlens, None, ws, wl, src
        # wide-window fallback: host window gather as a strided row view
        # (a 2-D fancy index over the whole text is ~20x slower)
        win = self._text_windows(C)
        refs = win[np.minimum(ws, len(win) - 1)].copy()
        refs[np.arange(C)[None, :] >= wl[:, None]] = 4
        return reads, pens, rdlens, refs, ws, wl, src

    def _text_windows(self, C: int):
        """Cached sliding-window view of the joined text (rows = all
        C-wide reference windows)."""
        cache = getattr(self, "_win_cache", None)
        if cache is None:
            cache = self._win_cache = {}
        if C not in cache:
            pad = np.concatenate([self.text, np.full(C, 4, np.int8)])
            cache[C] = np.lib.stride_tricks.sliding_window_view(pad, C)
        return cache[C]

    # quantized dispatch sizes: every chunk pads up to one of these, so
    # the executable set per (L, C, kernel) stays small and the compile
    # cache warm, while one big batch goes out as ONE dispatch
    _DP_LADDER = (256, 512, 1024, 2048, 4096, 8192, 16384, 32768)

    @classmethod
    def _dp_quant(cls, m: int) -> int:
        for b in cls._DP_LADDER:
            if b >= m:
                return b
        return cls._DP_LADDER[-1]

    def _dp_chunk(self, packed, lo, hi, B):
        """One packed (big, small) input pair for rows [lo, hi) padded to
        B: big uint8 [B, 2L] = reads|pens (plus |refs inline when the
        wide-window host fallback is active), small [B, 3] = (rdlen,
        wlen, wstart) — int64 when the joined text exceeds int32."""
        reads, pens, rdlens, refs, ws, wl, _src = packed
        L = reads.shape[1]
        C = 0 if refs is None else refs.shape[1]
        m = hi - lo
        big = np.empty((B, 2 * L + C), np.uint8)
        big[:m, :L] = reads[lo:hi].view(np.uint8)
        big[:m, L : 2 * L] = pens[lo:hi]
        if m < B:
            big[m:, :L] = 4
            big[m:, L : 2 * L] = 0
        if refs is not None:
            big[:m, 2 * L :] = refs[lo:hi].view(np.uint8)
            if m < B:
                big[m:, 2 * L :] = 4
        sdt = np.int64 if self._large_index else np.int32
        small = np.zeros((B, 3), sdt)
        small[:m, 0] = rdlens[lo:hi]
        small[:m, 1] = wl[lo:hi]
        small[:m, 2] = ws[lo:hi]
        return big, small

    def _dp_chunk_mat(self, packed, lo, hi, B):
        """Index-only chunk: [B, 4] = (src row, rdlen, wlen, wstart)."""
        _reads, _pens, rdlens, _refs, ws, wl, src = packed
        m = hi - lo
        sdt = np.int64 if self._large_index else np.int32
        small = np.zeros((B, 4), sdt)
        small[:m, 0] = src[lo:hi]
        small[:m, 1] = rdlens[lo:hi]
        small[:m, 2] = wl[lo:hi]
        small[:m, 3] = ws[lo:hi]
        return small

    def _dispatch_dp_bt(self, problems, cols: int | None = None,
                        batch: int | None = None, lmax: int | None = None):
        """Dispatch the batched DP+backtrace chunks async; returns an
        opaque state for _collect_dp_bt (lets multiple shape buckets
        queue on-device back-to-back instead of host-syncing between)."""
        o = self.opts
        n = len(problems)
        # no explicit cap: one ladder-quantized dispatch up to 32K rows
        dp_batch = batch or self._DP_LADDER[-1]
        L, C = (lmax or o.l_max), (cols or o.dp_cols)
        use_mat = (self._dp_from_mat and self._dev_mat is not None
                   and C <= self._DEVICE_REFS_MAX_C)
        packed = self._pack_dp_inputs(problems, L, C,
                                      need_rows=not use_mat)
        futs = []
        if use_mat:
            bt_fn = self._sw_bt_mat
            with self.timers.phase("dp.put"):
                for lo in range(0, n, dp_batch):
                    hi = min(lo + dp_batch, n)
                    B = self._dp_quant(hi - lo)
                    small = self._dp_chunk_mat(packed, lo, hi, B)
                    d_small = self._put(small)
                    args = (d_small, self._dev_mat, self.idx.ref_words,
                            self.swp, L, C)
                    cap = min(B, _bt_gap_cap(B) * self._gap_cap_mult)
                    futs.append((lo, hi, B, cap,
                                 _prefetch(bt_fn(*args, cap)),
                                 lambda a=args, b=B: bt_fn(*a, b)))
            return n, futs
        bt_fn = self._sw_bt
        host_refs = packed[3] is not None
        with self.timers.phase("dp.put"):
            for lo in range(0, n, dp_batch):
                hi = min(lo + dp_batch, n)
                B = self._dp_quant(hi - lo)
                big, small = self._dp_chunk(packed, lo, hi, B)
                args = (self._put(big), self._put(small),
                        self.idx.ref_words, self.swp, L, C, host_refs)
                cap = min(B, _bt_gap_cap(B) * self._gap_cap_mult)
                futs.append((lo, hi, B, cap,
                             _prefetch(bt_fn(*args, cap)),
                             lambda a=args, b=B: bt_fn(*a, b)))
        return n, futs

    def _parse_bt_flat(self, a, B, m, cap, retry):
        """Parse one flat compacted DP result (see _pack_bt_out).
        Returns (hdr [m, hw+1] int32 view, ops list of length m — int
        M-count for gapless rows, uint8 op array for gapped ones)."""
        hw = self._hdr_w
        he = hw + 1
        count = int(a[-1])
        if count > cap and retry is not None:
            # side-buffer overflow (indel-heavy chunk): full-size retry.
            # Also jump the self-tuning cap multiplier straight to what
            # THIS chunk needed (next power of two, 25% headroom) so
            # later dispatches ship a big-enough side buffer instead of
            # paying a synchronous retry every chunk — at genome scale
            # the gap fraction exceeds B/16 persistently.
            need = -(-(count + (count >> 2)) // _bt_gap_cap(B))
            mult = 1
            while mult < need and mult < 16:
                mult *= 2
            if mult > self._gap_cap_mult:
                self._gap_cap_mult = mult
            a = np.asarray(retry())
            cap = B
        hdr = a[: B * he].reshape(B, he)
        opsinfo = hdr[:m, hw]
        ops: list = opsinfo.tolist()
        gi = np.flatnonzero(opsinfo < 0)
        if len(gi):
            nw = (len(a) - 1 - B * he) // cap
            side = a[B * he : B * he + cap * nw].reshape(cap, nw)
            slots = -opsinfo[gi] - 1
            ops_np = sw.unpack_ops2(
                np.ascontiguousarray(side[slots]).view(np.uint8)
            )
            for k, i in enumerate(gi.tolist()):
                ops[i] = ops_np[k]
        return hdr, ops

    def _collect_dp_bt(self, state):
        n, futs = state
        hw = self._hdr_w
        best = np.full(n, sw.NEG, np.int64)
        bestcol = np.zeros(n, np.int32)
        startcols = np.zeros(n, np.int32)
        all_ops: list = [None] * n
        # local mode: (bestrow, startrow) soft-clip endpoints ride in the
        # two extra header columns
        rows = (
            (np.zeros(n, np.int32), np.zeros(n, np.int32))
            if hw == 5 else None
        )
        for lo, hi, B, cap, res, retry in futs:
            with self.timers.phase("dp.wait"):
                a = np.asarray(res)  # flat int32 (_pack_bt_out)
            m = hi - lo
            with self.timers.phase("dp.unpack"):
                hdr, ops = self._parse_bt_flat(a, B, m, cap, retry)
                best[lo:hi] = hdr[:m, 0]
                bestcol[lo:hi] = hdr[:m, 1]
                startcols[lo:hi] = hdr[:m, 2]
                if rows is not None:
                    rows[0][lo:hi] = hdr[:m, 3]  # bestrow (trail clip)
                    rows[1][lo:hi] = hdr[:m, 4]  # startrow (lead clip)
                all_ops[lo:hi] = ops
        return best, bestcol, all_ops, startcols, rows

    def _run_dp_bt(self, problems, cols: int | None = None,
                   batch: int | None = None, lmax: int | None = None):
        """Batched DP with fused device backtrace walk: returns
        (best, bestcol, ops list, startcols, rows) for every problem —
        rows is None in end-to-end mode, (bestrow, startrow) arrays in
        local mode."""
        return self._collect_dp_bt(
            self._dispatch_dp_bt(problems, cols, batch, lmax)
        )

    # ---------------- main entry ----------------

    def align_batch(self, reads, *, _prebuilt=False, _predisp=None,
                    _minscs=None, _next_cb=None) -> list[AlnResult]:
        """Multi-round alignment: round 0 seeds at offset 0, round 1 (for
        reads still unaligned) at offset interval/2 — the fork's resident
        batch keeps reads for nSeedRounds=2 rounds (bt2_search.cpp:2436,
        2572-2584).

        _prebuilt/_predisp/_minscs: align_stream already built this
        batch's matrices and queued its round-0 mega; _next_cb: invoked
        exactly once, right after round 0's main DP problems are
        dispatched (or immediately after round 0 if it dispatched none)
        — align_stream queues the NEXT batch's round-0 mega there so the
        device FIFO alternates dp(k), mega(k+1) and stays busy through
        batch k's host tail (models/pipeline.py)."""
        n = len(reads)
        self.metrics.add(reads=n)
        if not _prebuilt:
            with self.timers.phase("buildMatrices"):
                self.build_read_matrices(reads)
        # None = not (yet) aligned; materialized as unaligned AlnResults
        # only at the end (at genome scale ~every read aligns, so 32K
        # placeholder constructions per batch were pure waste)
        results: list = [None] * n
        # per-read scoring context (minsc clamps: bt2_search.cpp:2476-2491)
        minscs = self.min_scores(reads) if _minscs is None else _minscs
        # _next_cb = (build_cb, mega_cb): each fires at most once; build
        # overlaps the main DP execution, the mega dispatch lands after
        # the escalation dispatch (see _extend_and_collect)
        cb_state = [False, False]

        def _mk_once(i):
            def fire():
                if not cb_state[i]:
                    cb_state[i] = True
                    _next_cb[i]()
            return fire

        _cbs = ((_mk_once(0), _mk_once(1))
                if _next_cb is not None else None)

        def _cb_once():
            if _cbs is not None:
                _cbs[0]()
                _cbs[1]()

        # NOTE on the up-front N pre-filter (Scoring::nFilter): the fork
        # BYPASSES it for every rdlen<256 read (`bool filt = rdlen<256`
        # short-circuit, bt2_search.cpp:2495-2500) — verified empirically:
        # a 13-N/80bp read is rejected by the BACKTRACE-level ns>nCeil cap
        # (aligner_swsse_ee_u8.cpp:1284, reproduced in the finish paths)
        # with the generic YF:Z:LN, never YF:Z:NS. We therefore apply no
        # pre-filter either; n_filter_mask stays available for callers.
        active = list(range(n))
        for roundi in range(self.opts.nrounds):
            if not active:
                break
            cands, table = self.collect_candidates(
                reads, minscs, active, roundi,
                predisp=_predisp if roundi == 0 else None,
                after_dp=(_cbs if roundi == 0 else None),
                columnar=True,
            )
            if roundi == 0 and _next_cb is not None:
                _cb_once()  # round 0 dispatched no DP: fire now
            self.metrics.add(candidates=sum(len(c) for c in cands)
                             + (len(table) if table is not None else 0))
            with self.timers.phase("finishRead"):
                self._finalize_unpaired(reads, minscs, cands, results,
                                        table=table)
            active = [ri for ri in active if results[ri] is None]
            # --seed-boost gate (bt2_search.cpp:2792): only reads with no
            # seed hits at all (averageHitsPerSeed = MAX) or a repetitive
            # hit profile re-seed at the next round's offsets
            sb = self.opts.seed_boost
            if sb > 0:
                active = [
                    ri for ri in active
                    if self._hit_nonz[ri] == 0
                    or self._hit_elts[ri] // self._hit_nonz[ri] >= sb
                ]
        if self.opts.upfront_rescue:
            # half-read-seed rescue round for reads still unaligned —
            # upstream's do1mmUpFront capability (the fork compiled it
            # out, bt2_search.cpp:4018 #if 0); only previously-unaligned
            # reads enter, so fork-differential records are unchanged
            rescue = [ri for ri in range(n) if results[ri] is None]
            if rescue:
                cands, table = self.collect_candidates(
                    reads, minscs, rescue, -1, columnar=True)
                self.metrics.add(candidates=sum(len(c) for c in cands)
                                 + (len(table) if table is not None else 0))
                with self.timers.phase("finishRead"):
                    self._finalize_unpaired(reads, minscs, cands, results,
                                            table=table)
        if _next_cb is not None:
            _cb_once()  # n == 0 / no rounds ran: still chain the stream
        for i in range(n):
            if results[i] is None:
                results[i] = AlnResult(status="unaligned")
        return results

    def build_read_matrices(self, reads) -> None:
        """Per-batch oriented read/penalty matrices [2n, W] (row
        2*ri+0 = fw, 2*ri+1 = rc), built vectorized by length group. DP
        problem assembly then reduces to numpy row gathers.  W grows past
        l_max (up to l_hard) when the batch holds long reads — those DP
        through the irregular bucket (any-shape XLA kernel), a capability
        the reference's fixed 160x200 SSE buffer lacks entirely."""
        o = self.opts
        n = len(reads)
        lens = np.fromiter((len(rd.seq) for rd in reads), np.int32, n)
        longest = int(lens.max()) if n else 0
        L = o.l_max
        if longest > L:
            L = min(o.l_hard, ((longest + 31) // 32) * 32)
        # vectorized fill (no per-length-group loop): concatenate all read
        # bytes once, boolean-scatter into the padded [n, L] panel; the rc
        # rows come from one flat reverse-within-read gather
        flat_r = (np.concatenate([rd.seq for rd in reads])
                  if n else np.zeros(0, np.int8))
        flat_q = (np.concatenate([rd.qual for rd in reads])
                  if n else np.zeros(0, np.uint8))
        clipped = np.minimum(lens, L).astype(np.int64)
        starts = np.cumsum(clipped) - clipped
        pos = np.arange(int(clipped.sum()), dtype=np.int64)
        pos -= np.repeat(starts, clipped)
        if longest > L:  # drop tails of reads beyond the hard cap
            starts_f = np.cumsum(lens.astype(np.int64)) - lens
            keep = (np.arange(len(flat_r), dtype=np.int64)
                    - np.repeat(starts_f, lens)) < L
            flat_r, flat_q = flat_r[keep], flat_q[keep]
        flat_p = self.mm_tab[flat_q]
        # per-read genRandSeed while the flat concatenations exist (the
        # standalone gen_rand_seeds_batch re-concatenates — ~1s/32K batch)
        self._rdseed = refrng.gen_rand_seeds_flat(
            flat_r if longest <= L else
            np.concatenate([rd.seq for rd in reads]),
            flat_q if longest <= L else
            np.concatenate([rd.qual for rd in reads]),
            lens, [rd.name for rd in reads], self.opts.rng_seed,
        ) if n else np.zeros(0, np.uint32)
        rev_src = np.repeat(starts + clipped - 1, clipped) - pos
        mask = np.arange(L, dtype=np.int32)[None, :] < clipped[:, None]
        mat_r = np.full((2 * n, L), 4, np.int8)
        # penalty field width: u8 packing (code | pen << 4) when every
        # penalty fits 4 bits (default qual-scaled 2..6), u16 otherwise
        # (policy strings like MMP=C30 — penalties wrap mod 16 in a u8)
        pdt = np.uint8 if int(self.mm_tab.max()) <= 15 else np.uint16
        mat_p = np.zeros((2 * n, L), pdt)
        mat_r[0::2][mask] = flat_r
        mat_p[0::2][mask] = flat_p
        mat_r[1::2][mask] = dna.comp(flat_r[rev_src])
        mat_p[1::2][mask] = flat_p[rev_src]
        self._mat_reads = mat_r
        self._mat_pens = mat_p
        self._mat_lens = lens
        self._meta_dev = None  # grid meta is per-batch (see _grid_meta)
        self._fc_cache = None  # frame consts are per-batch (same minscs)
        self._batch_reads = reads
        if getattr(self, "_dp_from_mat", False):
            # ONE resident device copy for index-only DP dispatch and
            # on-device seed gathering: read code and qual-scaled
            # mismatch penalty packed per byte (code | pen << 4).
            # Only the FW rows are uploaded; the rc rows are computed on
            # device (_expand_oriented_mat), halving the largest
            # per-batch transfer.
            # On a data mesh the matrix replicates (placer.repl) so the
            # per-problem row gathers never cross shards.
            pk_fw = (mat_r[0::2].view(np.uint8).astype(pdt)
                     | (mat_p[0::2] << np.uint8(4)))
            if self.placer is None:
                self._dev_mat = _expand_oriented_mat(
                    jnp.asarray(pk_fw),
                    jnp.asarray(clipped.astype(np.int32)),
                )
            else:
                packed = (mat_r.view(np.uint8).astype(pdt)
                          | (mat_p << np.uint8(4)))
                self._dev_mat = jax.device_put(packed, self.placer.repl)

    def _batch_rdseed(self) -> np.ndarray:
        """Per-read genRandSeed for the resident batch (uint32 [n]),
        computed in build_read_matrices from the flat concatenations —
        feeds the wide-range row sampling (per-read pick diversity,
        aligner_sw_driver.cpp:151-259)."""
        if getattr(self, "_rdseed", None) is None:  # direct callers
            self._rdseed = refrng.gen_rand_seeds_batch(
                self._batch_reads, self.opts.rng_seed
            )
        return self._rdseed

    def min_scores(self, reads) -> np.ndarray:
        """Per-read clamped minimum scores (bt2_search.cpp:2476-2491).
        The -254 clamp is the fork's u8-kernel artifact and is applied
        only to reads the fork can align (<= l_max): long reads have no
        fork behavior to match, and our int32 DP has no such limit."""
        o, sc = self.opts, self.sc
        lens = np.fromiter(
            (len(rd.seq) for rd in reads), np.float64, len(reads)
        )
        m = sc.score_min.f_vec(lens)
        if o.local:
            return m  # positive G-func floor (G,20,8); no u8 clamp
        m = np.minimum(m, 0)
        m[(m < o.minsc_clamp) & (lens <= o.l_max)] = o.minsc_clamp
        return m

    def n_filter_mask(self, reads) -> np.ndarray:
        """True = read fails the N-ceiling pre-filter (Scoring::nFilter,
        scoring.cpp:104-117: more Ns than nCeil.f(rdlen)); such reads are
        never aligned and report YF:Z:NS. Uses the resident batch matrices
        (padding is code 4, subtracted out)."""
        lens = self._mat_lens.astype(np.int64)
        mat = self._mat_reads
        L = mat.shape[1]
        row4 = (mat[0::2] == 4).sum(axis=1).astype(np.int64)
        ns = row4 - (L - np.minimum(lens, L))
        for ri in np.flatnonzero(lens > L).tolist():  # truncated tails
            ns[ri] += int((np.asarray(reads[ri].seq[L:]) == 4).sum())
        maxns = np.minimum(
            self.sc.n_ceil.f_vec(lens.astype(np.float64)), lens
        )
        return ns > maxns

    def _frame_consts(self, minscs):
        """Per-read framing constants (narrow/wide window slacks, the
        escalation threshold, the hot-shape eligibility mask) — a pure
        function of the resident batch's lengths and min scores, shared
        by collect_candidates and the align_stream pre-dispatch."""
        o, sc = self.opts, self.sc
        # per-read envelopes: two window tiers.  The reference rect pads
        # each side by 2 * min(gap budget, maxhalf) diagonals ("LHS gap +
        # LHS extra", dp_framer.cpp:94-101).  We frame with the NARROW
        # half of that (min(budget, maxhalf)) first and escalate only
        # provably-affected problems to the full rect: any path leaving a
        # +-mg_n window carries > mg_n gap chars of one type, costing at
        # least const + (mg_n+1)*linear, so a problem whose narrow best
        # beats that bound is bitwise-identical under the wide rect.
        cached = getattr(self, "_fc_cache", None)
        if cached is not None and cached[0] is minscs:
            return cached[1]  # same batch, same minscs (pure function)
        lens_all = self._mat_lens.astype(np.int64)
        gap_const = min(sc.rdg_const, sc.rfg_const)
        gap_lin = min(sc.rdg_linear, sc.rfg_linear)
        # vectorized over ALL reads (distinct (len, minsc) pairs are few;
        # values for reads outside `active` are the same per-read
        # constants and feed the cached grid meta).  1-D packed key: the
        # axis=0 row-unique lexsorts and row-compares — ~25x slower
        ms64 = np.asarray(minscs).astype(np.int64)
        key = (lens_all << 33) + (ms64 + (1 << 32))
        ukey, first, uinv = np.unique(
            key, return_index=True, return_inverse=True
        )
        mg_u = np.fromiter(
            (min(sc.max_read_gaps(int(ms64[i]), int(lens_all[i])),
                 o.maxhalf) for i in first), np.int64, len(first),
        )
        mgn_all = mg_u[uinv]  # narrow slack (first pass)
        mgw_all = 2 * mgn_all  # full reference-rect slack
        thr_all = -(gap_const + (mgn_all + 1) * gap_lin)
        # any read up to l_hard aligns: regular problems (ln <= l_max,
        # window <= dp_cols) take the hot DP shape, everything else
        # routes to the irregular any-shape XLA bucket
        read_ok = lens_all <= o.l_hard
        out = (lens_all, mgn_all, mgw_all, thr_all, read_ok)
        self._fc_cache = (minscs, out)
        return out

    def dispatch_round0(self, reads, minscs):
        """align_stream's pre-dispatch: queue this batch's round-0 grid
        mega on the device (matrices must be built) and return the
        handle for collect_candidates(predisp=...).  None when the grid
        path is unavailable (mesh/tp or fused-rank off) — the stream
        then just runs align_batch serially for this batch."""
        fused = getattr(self, "_use_fused_rank", False)
        if not (fused and self.placer is None
                and getattr(self, "_dev_mat", None) is not None):
            return None
        _, mgn_all, _, _, read_ok = self._frame_consts(minscs)
        with self.timers.phase("searchResolve"):
            return self._grid_dispatch(
                list(range(len(reads))), 0, mgn_all, read_ok
            )

    def _note_rf_overflow(self):
        """Count a seeding round whose fused rank/frame table overflowed
        and so reruns on the host path (PipelineMetrics.rf_overflow), and
        say so once per aligner: a silent per-batch fallback cost 2-3x
        end-to-end throughput before it was noticed (resolve_expand
        sizing, AlignOpts)."""
        if not self.metrics.rf_overflow:
            import sys as _sys

            print("note: fused rank/frame table overflowed "
                  "(repeat-heavy batch); such batches use the host "
                  "path", file=_sys.stderr)
        self.metrics.add(rf_overflow=1)

    def collect_candidates(self, reads, minscs, active, roundi,
                           predisp=None, after_dp=None, columnar=False):
        """Phases P2-P7 for one seeding round: returns per-read dicts
        {(fw, endj): Candidate} for every valid-scoring DP endpoint.
        predisp: a _grid_dispatch handle already queued for (active,
        roundi); after_dp: zero-arg callback invoked once right after
        the main DP problems are DISPATCHED (align_stream queues the
        next batch's round-0 mega there, so the device FIFO alternates
        dp(k), mega(k+1) and never drains during batch k's host
        tail).  columnar=True returns (cands, CandTable|None) with
        single-candidate reads in the table instead of the dicts."""
        o, sc = self.opts, self.sc
        n = len(reads)

        empty = ([{} for _ in range(n)], None) if columnar \
            else [{} for _ in range(n)]
        # zero-hit reads count as averageHitsPerSeed = MAX (always re-seed)
        self._hit_nonz = np.zeros(n, np.int64)
        self._hit_elts = np.zeros(n, np.int64)

        # P2 + P4/P6 fused: seeds, search and SA resolution in one dispatch.
        # The fused device path needs only the per-seed (read, fw, offset)
        # meta — windows are gathered on device from the resident matrix;
        # the host paths materialize seed arrays lazily below.
        fused = getattr(self, "_use_fused_rank", False)
        # grid path: the seed grid is computed on device from per-read
        # meta (single-device only — a data mesh keeps the sharded-lanes
        # mega; a tp mesh keeps its shard_map path)
        grid = (fused and self.placer is None
                and getattr(self, "_dev_mat", None) is not None)
        seeds = None
        m_ri = None
        if not grid:
            with self.timers.phase("instantiateSeeds"):
                if fused:
                    m_ri, m_fw, m_off, m_eff = self._instantiate_seeds_meta(
                        active, roundi
                    )
                else:
                    seeds, (m_ri, m_fw, m_off) = self._instantiate_seeds(
                        reads, active, roundi
                    )
            if len(m_ri) == 0:
                return empty
        lens_all, mgn_all, mgw_all, thr_all, read_ok = \
            self._frame_consts(minscs)

        problems = None
        dp_cells = 0

        # ---- grid device path: P2+P4-P6 in ONE dispatch, one copy ----
        if grid:
            with self.timers.phase("searchResolve"):
                if predisp is not None:  # queued by dispatch_round0
                    out = (predisp if isinstance(predisp, str)
                           else self._grid_collect(predisp))
                else:
                    out = self._rank_frame_device_grid(
                        active, roundi, mgn_all, read_ok
                    )
            if isinstance(out, str):  # no seeds this round
                return empty
            if out is not None:
                probs, hn, he, n_seeds = out
                self.metrics.add(seeds=n_seeds)
                self._hit_nonz = hn[:n].astype(np.int64)
                self._hit_elts = he[:n].astype(np.int64)
                with self.timers.phase("rankAndFrame"):
                    problems = self._reframe_slim(probs, lens_all,
                                                  mgn_all)
                    dp_cells = int(
                        (lens_all[problems.ri]
                         * problems.wlen.astype(np.int64)).sum()
                    ) if len(probs) else 0
                self.metrics.add(
                    ranges_nonzero=int(self._hit_nonz.sum()),
                    dps=len(problems),
                    dp_cells=dp_cells,
                )
                if not problems:
                    return empty
                return self._extend_and_collect(
                    reads, minscs, n, problems,
                    lens_all, mgn_all, mgw_all, thr_all,
                    after_dp=after_dp, columnar=columnar,
                )
            # table overflow (repeat-heavy batch): the host path below
            # (with up-front seed dedupe) handles it
            self._note_rf_overflow()
            fused = False
            with self.timers.phase("instantiateSeeds"):
                seeds, (m_ri, m_fw, m_off) = self._instantiate_seeds(
                    reads, active, roundi
                )
            if len(m_ri) == 0:
                return empty

        # ---- fused device path: P4-P6 in two dispatches, one copy ----
        if fused:
            npad = 1 << max(8, (n - 1).bit_length())
            lens_pad = np.zeros(npad, np.int32)
            lens_pad[:n] = lens_all
            mgn_pad = np.zeros(npad, np.int32)
            mgn_pad[:n] = mgn_all
            rok_pad = np.zeros(npad, bool)
            rok_pad[:n] = read_ok
            with self.timers.phase("searchResolve"):
                fused = self._rank_frame_device(
                    m_ri, m_fw, m_off, m_eff, lens_pad, mgn_pad, rok_pad
                )
            self.metrics.add(seeds=len(m_ri))
            if fused is not None:
                probs, hn, he = fused
                self._hit_nonz = hn[:n].astype(np.int64)
                self._hit_elts = he[:n].astype(np.int64)
                with self.timers.phase("rankAndFrame"):
                    problems = self._reframe_slim(probs, lens_all,
                                                  mgn_all)
                    dp_cells = int(
                        (lens_all[problems.ri]
                         * problems.wlen.astype(np.int64)).sum()
                    ) if len(probs) else 0
                self.metrics.add(
                    ranges_nonzero=int(self._hit_nonz.sum()),
                    dps=len(problems),
                    dp_cells=dp_cells,
                )
                if not problems:
                    return empty
                return self._extend_and_collect(
                    reads, minscs, n, problems,
                    lens_all, mgn_all, mgw_all, thr_all,
                    after_dp=after_dp, columnar=columnar,
                )
            # table overflow (repeat-heavy batch): host path below
            self._note_rf_overflow()

        if seeds is None:  # fused fallback: materialize seed windows
            with self.timers.phase("instantiateSeeds"):
                seeds, (m_ri, m_fw, m_off) = self._instantiate_seeds(
                    reads, active, roundi
                )
        with self.timers.phase("searchResolve"):
            tops, bots, (glob_offs, glob_start, glob_end) = \
                self._search_resolve(seeds, self._batch_rdseed()[m_ri])
        self.metrics.add(seeds=len(seeds))

        # P5 + framing, fully vectorized with the reference's semantics:
        # per read, ranges sorted by (width, !fw, off) ascending
        # (rankSeedHits, aligner_seed.h:1000-1062); element stream capped at
        # maxIters=400/read; candidates deduped by (read, fw, diagonal);
        # DP problems capped at maxDp=300/read; windows = diag +- maxgaps
        # clamped (frameSeedExtensionRect, dp_framer.cpp:81).
        _t_rank = self.timers.phase("rankAndFrame"); _t_rank.__enter__()
        widths = (bots - tops).astype(np.int64)

        # per-read seed-hit stats for the --seed-boost re-seed gate
        # (numElts_/nonzTot_, aligner_seed.h:802-807)
        nzm = widths > 0
        self._hit_nonz = np.bincount(m_ri[nzm], minlength=n)
        self._hit_elts = np.bincount(
            m_ri[nzm], weights=widths[nzm], minlength=n
        ).astype(np.int64)

        nz = np.flatnonzero((widths > 0) & read_ok[m_ri])
        if len(nz):
            w_nz = widths[nz]
            ri_nz = m_ri[nz].astype(np.int64)
            fw_nz = m_fw[nz]
            # range order within each read: (width, !fw, off) ascending
            order = np.lexsort((m_off[nz], ~fw_nz, w_nz, ri_nz))
            sid = nz[order]
            ri_s = ri_nz[order]
            take = np.minimum(w_nz[order], o.range_cap)
            # compaction spill -> no slots for that seed
            take = np.where(
                glob_start[sid] + take > glob_end[sid], 0, take
            )
            # element-stream cap per read (maxIters)
            csum = np.cumsum(take)
            read_first = np.concatenate([[True], ri_s[1:] != ri_s[:-1]])
            base_of_read = np.where(read_first, csum - take, 0)
            np.maximum.accumulate(base_of_read, out=base_of_read)
            elt_base = csum - take - base_of_read
            take_eff = np.clip(o.max_elts_per_read - elt_base, 0, take)
            total = int(take_eff.sum())
            if total:
                rep = np.repeat(np.arange(len(sid)), take_eff)
                excl = np.concatenate([[0], np.cumsum(take_eff)[:-1]])
                intra = np.arange(total) - excl[rep]
                joff = glob_offs[glob_start[sid[rep]] + intra].astype(np.int64)
                ri_e = ri_s[rep]
                fw_e = fw_nz[order][rep]
                soff_e = m_off[nz][order][rep].astype(np.int64)
                ok = joff >= 0
                cand = joff - soff_e
                # dedupe by (read, fw, diagonal), first occurrence wins
                key = ((ri_e * 2 + fw_e) * np.int64(self.fm.n + 2)
                       + cand + 1)
                key = np.where(ok, key, -1)
                _, first = np.unique(key, return_index=True)
                keep = np.zeros(total, bool)
                keep[first] = True
                keep &= ok
                # window framing + wlen filter (narrow tier)
                mg_e = mgn_all[ri_e]
                ln_e = lens_all[ri_e]
                wstart = np.maximum(0, cand - mg_e)
                wend = np.minimum(self.fm.n, cand + ln_e + mg_e)
                keep &= (wend - wstart) > 0
                kidx = np.flatnonzero(keep)
                # DP cap per read (maxDp), in stream order
                ri_k = ri_e[kidx]
                kfirst = np.concatenate([[True], ri_k[1:] != ri_k[:-1]])
                pos = np.arange(len(kidx))
                start_pos = np.where(kfirst, pos, 0)
                np.maximum.accumulate(start_pos, out=start_pos)
                kidx = kidx[(pos - start_pos) < o.max_dp_per_read]
                srcs = 2 * ri_e[kidx] + np.where(fw_e[kidx], 0, 1)
                wl_k = (wend - wstart)[kidx]
                problems = Problems(srcs, wstart[kidx], wl_k, cand[kidx])
                dp_cells = int((lens_all[ri_e[kidx]] * wl_k).sum())

        _t_rank.__exit__(None, None, None)
        self.metrics.add(
            ranges_nonzero=int(np.count_nonzero(widths > 0)),
            dps=0 if problems is None else len(problems),
            dp_cells=dp_cells if problems is not None else 0,
        )
        if problems is None or not len(problems):
            return empty
        return self._extend_and_collect(
            reads, minscs, n, problems,
            lens_all, mgn_all, mgw_all, thr_all,
            after_dp=after_dp, columnar=columnar,
        )

    def _extend_and_collect(self, reads, minscs, n, problems,
                            lens_all, mgn_all, mgw_all, thr_all,
                            after_dp=None, columnar=False):
        """P7 + P8a: batched DP, tier escalation, -D streak, candidate
        collection — shared by the fused-device and host rank/frame
        paths.  columnar=True additionally returns a CandTable holding
        the single-candidate reads (returned as (cands, table); those
        reads are absent from the dicts)."""
        o = self.opts
        # windows spanning an intra-reference N gap leave the joined-text
        # fast path entirely (see _run_bridge); zero overhead when the
        # genome has no such gaps
        bridge_cands = []
        bi = self._bridge_problem_indices(problems, mgn_all)
        if len(bi):
            bridge_probs = problems.take(bi)
            keep = np.ones(len(problems), bool)
            keep[bi] = False
            problems = problems.take(np.flatnonzero(keep))
            bridge_cands = self._run_bridge(minscs, bridge_probs, mgn_all)
            if not len(problems):
                cands = [{} for _ in range(n)]
                for ri, key, cand in bridge_cands:
                    if key not in cands[ri]:
                        cands[ri][key] = cand
                return (cands, None) if columnar else cands
        # P7 + P8a fused: batched DP with device backtrace walk; ONE
        # compile shape (l_max x dp_cols) for the dominant bucket.
        # Read-length classes would add per-bucket dispatches that
        # serialize; whether they beat the padding they save on this
        # device is unmeasured.
        _t_dp = self.timers.phase("extendDP")
        _t_dp.__enter__()
        lens_p = self._mat_lens[problems.src // 2]
        irr_mask = (problems.wlen > o.dp_cols) | (lens_p > o.l_max)
        irr_i = np.flatnonzero(irr_mask)
        if not len(irr_i):
            # two-phase next-batch chaining (after_dp = (build_cb,
            # mega_cb), both once-guarded): the next batch's HOST build
            # runs here, overlapping dp(k)'s device execution; its mega
            # DISPATCH waits until after the escalation dispatch below
            # so the device FIFO holds [wide(k), mega(k+1)] and the
            # mega executes under batch k's host tail.  Measured at
            # GRCh38-scale: build+dispatch both here = 18.4K reads/s,
            # both after escalation = 15.3K, split = best.
            st_main = self._dispatch_dp_bt(problems)
            _t_dp.__exit__(None, None, None)
            if after_dp is not None:
                after_dp[0]()
            _t_dp = self.timers.phase("extendDP")
            _t_dp.__enter__()
            best, bestcol, ops, startcols, rows = \
                self._collect_dp_bt(st_main)
        else:
            reg_i = np.flatnonzero(~irr_mask)
            n_all = len(problems)
            best = np.full(n_all, sw.NEG, np.int64)
            bestcol = np.zeros(n_all, np.int32)
            startcols = np.zeros(n_all, np.int32)
            ops = [None] * n_all
            rows = (
                (np.zeros(n_all, np.int32), np.zeros(n_all, np.int32))
                if o.local else None
            )
            # FIXED length classes (no per-batch shape churn -> the
            # compile cache stays warm across batches)
            jobs = []
            if len(reg_i):
                jobs.append(((None, None, None), reg_i))
            sub: dict = {}
            for i in irr_i.tolist():
                ln = int(lens_p[i])
                lc = next(c for c in (o.l_max, 256, 384, 512, 768,
                                      o.l_hard) if ln <= c)
                cc = ((lc + 2 * o.maxhalf + 31) // 32) * 32
                wl_i = int(problems.wlen[i])
                if wl_i > cc:  # wide window (custom --dpad)
                    cc = ((wl_i + 127) // 128) * 128
                sub.setdefault((lc, cc), []).append(i)
            for (lc, cc), idxs in sorted(sub.items()):
                bt = 1024 if lc <= 384 else 256
                lm = None if lc == o.l_max else lc
                jobs.append(((cc, lm, bt), np.asarray(idxs)))
            states = [
                (idxs, self._dispatch_dp_bt(
                    problems.take(idxs), cols=cols, batch=bt, lmax=lm,
                ))
                for (cols, lm, bt), idxs in jobs
            ]
            _t_dp.__exit__(None, None, None)
            if after_dp is not None:
                after_dp[0]()
                after_dp[1]()
            _t_dp = self.timers.phase("extendDP")
            _t_dp.__enter__()
            for idxs, st in states:
                b, bc, op, stc, rws = self._collect_dp_bt(st)
                best[idxs] = b
                bestcol[idxs] = bc
                startcols[idxs] = stc
                if rows is not None:
                    rows[0][idxs] = rws[0]
                    rows[1][idxs] = rws[1]
                for t, i in enumerate(idxs.tolist()):
                    ops[i] = op[t]
        _t_dp.__exit__(None, None, None)

        # fork-reach escalation: rerun with the full reference rect only
        # the problems it could provably change — narrow best at/below the
        # window-exit gap cost, or (in -k/-a enumeration) a minsc that
        # admits such paths.  Replaced results are bitwise what an
        # always-wide first pass would have produced.
        multi = o.allhits or o.khits > 1
        ri_arr = problems.ri
        thr_p = thr_all[ri_arr]
        esc = np.flatnonzero(
            (mgw_all[ri_arr] > mgn_all[ri_arr])
            & (thr_p >= minscs[ri_arr])
            & ((best <= thr_p) | multi)
        )
        if len(esc):
            mg_w = mgw_all[ri_arr[esc]].astype(np.int64)
            ws = np.maximum(0, problems.diag[esc] - mg_w)
            we = np.minimum(
                self.fm.n,
                problems.diag[esc]
                + lens_all[ri_arr[esc]].astype(np.int64) + mg_w,
            )
            wide_probs = Problems(problems.src[esc], ws, we - ws,
                                  problems.diag[esc])
            wmax = int(wide_probs.wlen.max())
            wcols = None if wmax <= o.dp_cols else ((wmax + 31) // 32) * 32
            wlns = int(lens_p[esc].max())
            wlmax = None if wlns <= o.l_max else ((wlns + 31) // 32) * 32
            # escalations are rare: pad to a small batch (256), not the
            # full dp_batch, so the extra dispatch stays ~free
            wbatch = min(512, max(256, 1 << (len(esc) - 1).bit_length()))
            self.metrics.add(
                dps_wide=len(esc),
                dp_cells=int(
                    (lens_p[esc].astype(np.int64) * wide_probs.wlen).sum()
                ),
            )
            with self.timers.phase("extendDPWide"):
                st_w = self._dispatch_dp_bt(
                    wide_probs, cols=wcols, batch=wbatch, lmax=wlmax
                )
            if after_dp is not None:
                after_dp[1]()  # FIFO [wide(k), mega(k+1)]: the mega
                # executes under batch k's host tail below
            with self.timers.phase("extendDPWide"):
                b, bc, op, stc, rws = self._collect_dp_bt(st_w)
            # fused-path arrays can be read-only views of the device copy
            if not problems.wstart.flags.writeable:
                problems.wstart = problems.wstart.copy()
            if not problems.wlen.flags.writeable:
                problems.wlen = problems.wlen.copy()
            problems.wstart[esc] = ws
            problems.wlen[esc] = wide_probs.wlen
            best[esc] = b
            bestcol[esc] = bc
            startcols[esc] = stc
            if rows is not None and rws is not None:
                rows[0][esc] = rws[0]
                rows[1][esc] = rws[1]
            for t, i in enumerate(esc.tolist()):
                ops[i] = op[t]
        if after_dp is not None:
            after_dp[0]()  # not fired yet (no escalation / no DP):
            after_dp[1]()  # chain the next batch now

        # -D fail streak (maxDpStreak, bt2_search.cpp:417 + streak budget
        # grows 10 per extra -k, :2208): after this many consecutive
        # failed extensions the read's remaining problems are abandoned
        # (EXTEND_EXCEEDED_SOFT_LIMIT, aligner_sw_driver.cpp:512-514).
        # Post-hoc here: the DP already ran batched, but candidates past
        # the stop point are discarded exactly as the reference's would
        # never have been computed.
        P = len(problems)
        minsc_p = minscs[ri_arr]
        dropped = np.zeros(P, bool)
        streak_lim = o.dps + (o.khits - 1) * 10
        if o.dps > 0 and P:
            # vectorized reset-counter: consecutive fails ending at each
            # stream position = pos - (last success/read-start barrier)
            pos = np.arange(P, dtype=np.int64)
            rf = np.empty(P, bool)
            rf[0] = True
            rf[1:] = ri_arr[1:] != ri_arr[:-1]
            fail = best < minsc_p
            barrier = np.where(~fail, pos,
                               np.where(rf, pos - 1, np.int64(-1)))
            np.maximum.accumulate(barrier, out=barrier)
            consec = pos - barrier
            stop = fail & (consec >= streak_lim)
            starts = np.flatnonzero(rf)
            sp = np.where(stop, pos, np.int64(P + 1))
            first_stop = np.minimum.reduceat(sp, starts)
            grp = np.cumsum(rf) - 1
            dropped = pos > first_stop[grp]

        # collect valid-scoring candidates, deduped by (fw, end column):
        # per (read, fw, endj) group the max score wins, earliest stream
        # position on ties, and groups enter the per-read dict in
        # first-valid-occurrence order (the insertion-order semantics of
        # the old per-problem loop, which downstream tie-break selection
        # depends on)
        _t_cc = self.timers.phase("collectCands"); _t_cc.__enter__()
        cands = [{} for _ in range(n)]
        table = None
        vi = np.flatnonzero((best >= minsc_p) & ~dropped)
        if len(vi):
            endj = problems.wstart[vi] + bestcol[vi].astype(np.int64)
            fwv = problems.fw[vi]
            riv = ri_arr[vi]
            # local mode groups by DIAGONAL (endj - end read row), not
            # end position: a lower-scoring sub-alignment of the same
            # diagonal is redundant with the longer one (the reference's
            # per-cell RedundantAlns check, aligner_result.h:1687; two
            # DISJOINT same-diagonal local alignments also collapse here
            # — an accepted approximation, they share the seed diagonal)
            gkey = endj if rows is None else (
                endj - rows[0][vi].astype(np.int64)
            )
            order = np.lexsort(
                (np.arange(len(vi)), -best[vi], gkey, fwv, riv)
            )
            r_o, f_o, e_o = riv[order], fwv[order], gkey[order]
            gf = np.empty(len(vi), bool)
            gf[0] = True
            gf[1:] = ((r_o[1:] != r_o[:-1]) | (f_o[1:] != f_o[:-1])
                      | (e_o[1:] != e_o[:-1]))
            gstarts = np.flatnonzero(gf)
            win = order[gstarts]  # winner (vi-relative) per group
            firstpos = np.minimum.reduceat(order, gstarts)
            # bulk-convert every per-winner scalar once (np-scalar indexing
            # per candidate was ~half the loop's cost)
            emit = win[np.argsort(firstpos, kind="stable")]
            pis = vi[emit]
            if columnar:
                # single-candidate reads (no bridge entry) go columnar:
                # no dict / Candidate / per-read Python for them at all
                riv_e = riv[emit]
                counts = np.bincount(riv_e, minlength=n)
                is_single = counts[riv_e] == 1
                if bridge_cands:
                    br = np.zeros(n, bool)
                    br[[bri for bri, _k, _c in bridge_cands]] = True
                    is_single &= ~br[riv_e]
                sg = np.flatnonzero(is_single)
                if len(sg):
                    ps = pis[sg]
                    table = CandTable(
                        ri=riv_e[sg].astype(np.int64),
                        score=best[ps],
                        fw=fwv[emit[sg]],
                        src=problems.src[ps],
                        wstart=problems.wstart[ps],
                        wlen=problems.wlen[ps].astype(np.int64),
                        diag=problems.diag[ps],
                        bc=bestcol[ps].astype(np.int64),
                        start_col=startcols[ps].astype(np.int64),
                        row_lo=(rows[1][ps].astype(np.int64)
                                if rows is not None else None),
                        row_hi=(rows[0][ps].astype(np.int64)
                                if rows is not None else None),
                        ops=[ops[i] for i in ps.tolist()],
                    )
                keep = np.flatnonzero(~is_single)
                emit = emit[keep]
                pis = pis[keep]
            pi_l = pis.tolist()
            ri_l = riv[emit].tolist()
            fw_l = fwv[emit].tolist()
            ej_l = endj[emit].tolist()
            gk_l = gkey[emit].tolist()  # dict key: diag in local mode
            sc_l = best[pis].tolist()
            bc_l = bestcol[pis].tolist()
            st_l = startcols[pis].tolist()
            src_l = problems.src[pis].tolist()
            ws_l = problems.wstart[pis].tolist()
            wl_l = problems.wlen[pis].tolist()
            dg_l = problems.diag[pis].tolist()
            if rows is not None:
                rhi_l = rows[0][pis].tolist()
                rlo_l = rows[1][pis].tolist()
            for t in range(len(emit)):
                ri = ri_l[t]
                cands[ri][(fw_l[t], gk_l[t])] = Candidate(
                    score=sc_l[t], fw=fw_l[t], endj=ej_l[t],
                    problem=dict(src=src_l[t], wstart=ws_l[t],
                                 wlen=wl_l[t], diag=dg_l[t]),
                    bc=bc_l[t], ops_row=ops[pi_l[t]], start_col=st_l[t],
                    row_lo=rlo_l[t] if rows is not None else 0,
                    row_hi=rhi_l[t] if rows is not None else -1,
                )
        _t_cc.__exit__(None, None, None)
        # N-bridge candidates join after the main stream (their fork-side
        # tie order is unknowable: the fork's own records there are
        # self-inconsistent — see DIFFERENTIAL.md)
        for ri, key, cand in bridge_cands:
            if key not in cands[ri]:
                cands[ri][key] = cand
        return (cands, table) if columnar else cands

    # ---------------- N-bridge DP (windows spanning intra-ref N gaps) ----
    # The reference's DP reference windows come from BitPairReference::
    # getStretch, which decodes N-gap positions as code 4
    # (reference.cpp:377-422) — so its DP aligns reads ACROSS short N runs,
    # each N column a mismatch at the N penalty, capped by nCeil.  Our
    # joined text removes N runs entirely, so problems whose window spans
    # a same-reference fragment boundary are routed here: re-framed in
    # per-reference coordinates with an explicit N-filled window (the
    # getStretchNaive analog), DP'd through the host-rows kernel path, and
    # finished directly in ref space.

    _BRIDGE_EXTRA_MAX = 96  # max N-gap chars a window may absorb

    def _has_intra_ref_gaps(self) -> bool:
        flag = getattr(self, "_intra_gaps", None)
        if flag is None:
            fr = self.fm.refmap.frag_refid
            flag = self._intra_gaps = bool(
                len(fr) > 1 and (fr[1:] == fr[:-1]).any()
            )
        return flag

    def _bridge_problem_indices(self, problems, mgn_all=None) -> np.ndarray:
        """Indices of problems whose joined window crosses a fragment
        boundary between fragments of the SAME reference (an N gap), plus
        — under --overhang — problems whose desired (unclipped) window
        extends outside the containing reference's [0, reflen) span
        (gReportOverhangs: such alignments run in ref space with N fill
        and soft-clip the off-end part)."""
        if len(problems) == 0:
            return np.zeros(0, np.int64)
        sel = np.zeros(len(problems), bool)
        rm = self.fm.refmap
        if self._has_intra_ref_gaps():
            ws = problems.wstart
            we = ws + problems.wlen
            fi_s = np.searchsorted(rm.frag_joined, ws, side="right") - 1
            fi_e = np.searchsorted(rm.frag_joined, we - 1, side="right") - 1
            sel |= (fi_s != fi_e) & (
                rm.frag_refid[fi_s] == rm.frag_refid[fi_e]
            )
        if self.opts.overhang and mgn_all is not None:
            fi_d = np.searchsorted(
                rm.frag_joined, problems.diag, side="right") - 1
            fi_d = np.clip(fi_d, 0, None)
            rid = rm.frag_refid[fi_d]
            ref_diag = rm.frag_ref[fi_d] + (
                problems.diag - rm.frag_joined[fi_d]
            )
            mg = mgn_all[problems.ri]
            ln = self._mat_lens[problems.ri].astype(np.int64)
            sel |= (ref_diag - mg < 0) | (
                ref_diag + ln + mg > rm.reflens[rid]
            )
        return np.flatnonzero(sel)

    def _run_bridge(self, minscs, probs, mgn_all=None) -> list:
        """DP the bridge problems with explicit ref-space N-filled windows;
        returns [(ri, key, Candidate)] for valid-scoring endpoints."""
        rm = self.fm.refmap
        o = self.opts
        ws = probs.wstart
        we = ws + probs.wlen
        fi_s = np.searchsorted(rm.frag_joined, ws, side="right") - 1
        fi_e = np.searchsorted(rm.frag_joined, we - 1, side="right") - 1
        map_lo = rm.frag_ref[fi_s] + (ws - rm.frag_joined[fi_s])
        map_hi = rm.frag_ref[fi_e] + (we - 1 - rm.frag_joined[fi_e]) + 1
        # anchor every window on the seed DIAGONAL's fragment: the joined
        # window's other end may live across a huge N gap (or in another
        # reference entirely) — such spans are clamped, not dropped (the
        # alignment cannot bridge more than X gap chars anyway: a
        # deletion of that size busts any score budget)
        fi_d = np.clip(np.searchsorted(
            rm.frag_joined, probs.diag, side="right") - 1, 0, None)
        rid_d = rm.frag_refid[fi_d].astype(np.int64)
        ref_diag = rm.frag_ref[fi_d] + (probs.diag - rm.frag_joined[fi_d])
        mg = mgn_all[probs.ri] if mgn_all is not None else (
            probs.wlen.astype(np.int64) // 2
        )
        ln = self._mat_lens[probs.ri].astype(np.int64)
        if o.overhang:
            # --overhang: full desired margins, off-reference positions
            # included (N-filled by ref_window; soft-clipped at finish)
            want_lo = ref_diag - mg
            want_hi = ref_diag + ln + mg
        else:
            want_lo = np.maximum(ref_diag - mg, 0)
            want_hi = np.minimum(ref_diag + ln + mg, rm.reflens[rid_d])
        X = self._BRIDGE_EXTRA_MAX
        same_s = rm.frag_refid[fi_s] == rid_d
        same_e = rm.frag_refid[fi_e] == rid_d
        refid = rid_d
        ref_lo = np.maximum(
            want_lo - X,
            np.minimum(np.where(same_s, map_lo, want_lo), want_lo),
        )
        ref_hi = np.minimum(
            want_hi + X,
            np.maximum(np.where(same_e, map_hi, want_hi), want_hi),
        )
        width = (ref_hi - ref_lo).astype(np.int64)
        keep = np.flatnonzero(width > 0)
        if not len(keep):
            return []
        srcs = probs.src[keep]
        rdl = self._mat_lens[srcs // 2].astype(np.int64)
        n_b = len(keep)
        C = int(-(-int(width[keep].max()) // 32) * 32)
        L = o.l_max if rdl.max() <= o.l_max else int(
            -(-int(rdl.max()) // 32) * 32
        )
        refs = np.full((n_b, C), 4, np.int8)
        for t, k in enumerate(keep.tolist()):
            refs[t, : width[k]] = rm.ref_window(
                self.text, int(refid[k]), int(ref_lo[k]), int(width[k])
            )
        reads = np.full((n_b, L), 4, np.int8)
        pens = np.zeros((n_b, L), np.uint8)
        W = self._mat_reads.shape[1]
        w = min(W, L)
        reads[:, :w] = self._mat_reads[srcs, :w]
        pens[:, :w] = self._mat_pens[srcs, :w]
        B = self._dp_quant(n_b)
        big = np.empty((B, 2 * L + C), np.uint8)
        big[:n_b, :L] = reads.view(np.uint8)
        big[:n_b, L : 2 * L] = pens
        big[:n_b, 2 * L :] = refs.view(np.uint8)
        big[n_b:, :L] = 4
        big[n_b:, L : 2 * L] = 0
        big[n_b:, 2 * L :] = 4
        sdt = np.int64 if self._large_index else np.int32
        small = np.zeros((B, 3), sdt)
        small[:n_b, 0] = rdl
        small[:n_b, 1] = width[keep]
        args = (self._put(big), self._put(small), self.idx.ref_words,
                self.swp, L, C, True)
        out = np.asarray(self._sw_bt(*args, _bt_gap_cap(B)))
        hw = self._hdr_w
        hdr, ops = self._parse_bt_flat(
            out, B, n_b, _bt_gap_cap(B),
            lambda: self._sw_bt(*args, B),
        )
        best, bestcol, startcol = hdr[:, 0], hdr[:, 1], hdr[:, 2]
        brows = hdr[:, 3] if hw == 5 else None
        srows = hdr[:, 4] if hw == 5 else None
        self.metrics.add(dps_bridge=n_b)
        res = []
        for t in range(n_b):
            k = int(keep[t])
            ri = int(probs.ri[keep[t]])
            if best[t] < minscs[ri]:
                continue
            rid = int(refid[k])
            end_ref = int(ref_lo[k]) + int(bestcol[t])
            # dedupe key: the joined end position when it exists, else a
            # synthetic ref-space key (negative, cannot collide)
            jend = rm.ref_to_joined(rid, end_ref - 1)
            key_end = jend + 1 if jend is not None else -(
                (rid + 1) << 40
            ) - end_ref
            fwb = bool(probs.fw[keep[t]])
            cand = Candidate(
                score=int(best[t]), fw=fwb, endj=key_end,
                problem=dict(src=int(srcs[t]), wstart=int(ws[k]),
                             wlen=int(width[k]), diag=int(probs.diag[k])),
                bc=int(bestcol[t]), ops_row=ops[t],
                start_col=int(startcol[t]),
                bridge=(rid, int(ref_lo[k]), refs[t]),
                row_lo=int(srows[t]) if srows is not None else 0,
                row_hi=int(brows[t]) if brows is not None else -1,
            )
            res.append((ri, (fwb, key_end), cand))
        return res

    def _finish_bridge(self, c: Candidate) -> None:
        """Finish one bridge candidate directly in ref space (no joined
        mapping, no fragment-straddle check: the window is built within
        one reference)."""
        rid, ref_lo, refw = c.bridge
        if isinstance(c.ops_row, int):
            cigar = [("M", c.ops_row)] if c.ops_row > 0 else []
        else:
            cigar = sw.ops_to_cigar(c.ops_row)
        if not cigar:
            return
        src = c.problem["src"]
        rdlen = int(self._mat_lens[src // 2])
        read = self._mat_reads[src][:rdlen]
        row_hi = c.row_hi if c.row_hi >= 0 else rdlen
        ql, qr = c.row_lo, rdlen - row_hi
        if ql or qr:
            read = read[ql:row_hi]  # local: flanks soft-clip
        cigar = cigar_util.left_align_cigar(cigar, read, refw, c.start_col)
        stats = cigar_util.alignment_stats(read, refw, c.start_col, cigar)
        if stats["ns"] > self.sc.n_ceil_for(rdlen):
            return  # too many Ns (aligner_swsse_ee_u8.cpp:1284)
        refoff = int(ref_lo + c.start_col)
        reflen = int(self.fm.refmap.reflens[rid])
        if self.opts.overhang and (
            refoff < 0 or refoff + stats["ref_span"] > reflen
        ):
            # soft-clip the off-reference columns for the record
            # (aligner_result.cpp:1806-1840); AS keeps the full DP score
            # and ns/XN keep the full alignment's N count — only
            # CIGAR/POS/MD/NM/XM reflect the trimmed span
            cig2, refoff2, lead, trail = cigar_util.clip_off_end(
                cigar, refoff, reflen
            )
            if not cig2:
                return
            read2 = read[lead : len(read) - trail] if (lead or trail) \
                else read
            st2 = cigar_util.alignment_stats(
                read2, refw, refoff2 - int(ref_lo), cig2
            )
            st2["ns"] = stats["ns"]
            st2["xn"] = stats["xn"]
            stats = st2
            ql += lead
            qr += trail
            cigar = cig2
            refoff = refoff2
        c.refid = rid
        c.refoff = refoff
        c.span = stats["ref_span"]
        js = self.fm.refmap.ref_to_joined(rid, c.refoff)
        c.joined_start = js if js is not None else -1
        if ql or qr:
            cigar = (
                ([("S", ql)] if ql else [])
                + cigar
                + ([("S", qr)] if qr else [])
            )
        c.cigar = cigar
        c.stats = stats
        c.valid = True

    def backtrace(self, cand: Candidate) -> Candidate:
        """Backtrace one candidate (batched version preferred)."""
        self.backtrace_batch([cand])
        return cand

    def backtrace_batch(self, cands: list) -> None:
        """Batched backtrace: re-runs the DP on device with a fused
        trace-bit walk (the analog of the reference's stored-E/F/H CPU
        backtrace, aligner_swsse_ee_u8.cpp:746-1350, moved on-device);
        only the op strings transfer back. Fills coords/cigar/stats."""
        todo = [c for c in cands if not c.resolved]
        if not todo:
            return
        # candidates from the fused DP already carry their op strings:
        # finishing them is host work, batched through the native finisher
        # (csrc/sais.cpp bt_finish_batch) when available
        self.metrics.add(backtraces=len(todo))
        for c in todo:
            if c.bridge is not None:  # ref-space finish, no joined mapping
                c.resolved = True
                self._finish_bridge(c)
        todo = [c for c in todo if not c.resolved]
        have_ops = [c for c in todo if c.ops_row is not None]
        if have_ops:
            for c in have_ops:
                c.resolved = True
            if not self._finish_candidates_native(have_ops):
                for c in have_ops:
                    self._finish_backtrace(c, c.ops_row, c.start_col)
        todo = [c for c in todo if c.ops_row is None]
        if not todo:
            return
        o = self.opts
        # group by device window width + row class (seed-extend vs rescue
        # vs long reads past l_max)
        by_w: dict[tuple, list] = {}
        for c in todo:
            c.resolved = True
            w = o.dp_cols if c.problem["wlen"] <= o.dp_cols else (
                (c.problem["wlen"] + 127) // 128 * 128
            )
            ln = int(self._mat_lens[c.problem["src"] // 2])
            lg = o.l_max if ln <= o.l_max else ((ln + 31) // 32) * 32
            by_w.setdefault((w, lg), []).append(c)
        futs = []
        for (W, L), group in by_w.items():
            B = min(o.dp_batch, 1024)
            use_mat = (self._dp_from_mat and self._dev_mat is not None
                       and W <= self._DEVICE_REFS_MAX_C)
            for lo in range(0, len(group), B):
                chunk = group[lo : lo + B]
                packed = self._pack_dp_inputs(
                    [c.problem for c in chunk], L, W,
                    need_rows=not use_mat,
                )
                Bq = self._dp_quant(len(chunk))
                if use_mat:
                    bt_fn = self._sw_bt_mat
                    small = self._dp_chunk_mat(packed, 0, len(chunk), Bq)
                    args = (self._put(small), self._dev_mat,
                            self.idx.ref_words, self.swp, L, W)
                else:
                    bt_fn = self._sw_bt
                    big, small = self._dp_chunk(packed, 0, len(chunk), Bq)
                    args = (self._put(big), self._put(small),
                            self.idx.ref_words, self.swp, L, W,
                            packed[3] is not None)
                futs.append((chunk, Bq, _bt_gap_cap(Bq),
                             _prefetch(bt_fn(*args, _bt_gap_cap(Bq))),
                             lambda a=args, b=Bq, f=bt_fn: f(*a, b)))
        hw = self._hdr_w
        for chunk, Bq, cap, res, retry in futs:
            a = np.asarray(res)
            hdr, ops = self._parse_bt_flat(a, Bq, len(chunk), cap, retry)
            for k, c in enumerate(chunk):
                if hw == 5:  # local: refresh the soft-clip endpoints
                    c.row_hi = int(hdr[k, 3])
                    c.row_lo = int(hdr[k, 4])
                self._finish_backtrace(c, ops[k], int(hdr[k, 2]))

    def _finish_candidates_native(self, cands: list) -> bool:
        """Batched native CIGAR/MD/stats finish; False -> caller uses the
        Python path (library unavailable)."""
        from ..native import finish_batch

        n = len(cands)
        # ops rows from different window buckets differ in length (L+C);
        # zero-pad to the longest (0 = end-of-ops, so padding is inert).
        # int rows are compacted gapless results (that many M's): filled
        # with one vectorized mask instead of per-row materialization
        mcounts = np.fromiter(
            (c.ops_row if isinstance(c.ops_row, int) else -1
             for c in cands), np.int64, n,
        )
        arr_i = np.flatnonzero(mcounts < 0)
        maxlen = int(mcounts.max(initial=1))
        if len(arr_i):
            maxlen = max(maxlen, max(len(cands[i].ops_row)
                                     for i in arr_i.tolist()))
        ops_mat = np.zeros((n, maxlen), np.uint8)
        pure = mcounts >= 0
        ops_mat[pure] = (
            np.arange(maxlen)[None, :] < mcounts[pure, None]
        ).astype(np.uint8)
        for i in arr_i.tolist():
            row = cands[i].ops_row
            ops_mat[i, : len(row)] = row
        start_cols = np.fromiter((c.start_col for c in cands), np.int32, n)
        wstarts = np.fromiter((c.problem["wstart"] for c in cands), np.int64, n)
        srcs = np.fromiter((c.problem["src"] for c in cands), np.int64, n)
        row_los = clip_his = None
        if self.opts.local:
            row_los = np.fromiter((c.row_lo for c in cands), np.int32, n)
            row_his = np.fromiter((c.row_hi for c in cands), np.int32, n)
            rdlens = self._mat_lens[srcs >> 1].astype(np.int32)
            clip_his = np.where(row_his >= 0, rdlens - row_his, 0)
        out = finish_batch(ops_mat, start_cols, wstarts, self._mat_reads,
                           srcs, self.text, row_los=row_los,
                           clip_his=clip_his)
        if out is None:
            return False
        cig_buf, md_buf, stats = out
        spans = stats[:, 5]
        joined = wstarts + start_cols
        refid, refoff, valid = self.fm.refmap.joined_to_ref_batch(joined, spans)
        # bulk scalar conversion: one C pass instead of 6 np-scalar int()
        # casts per record
        stats_l = stats.tolist()
        joined_l = joined.tolist()
        refid_l = refid.tolist()
        refoff_l = refoff.tolist()
        valid_l = valid.tolist()
        cig_bytes = cig_buf.tobytes()
        md_bytes = md_buf.tobytes()
        cslot = cig_buf.shape[1]
        mslot = md_buf.shape[1]
        lens_l = self._mat_lens
        nceil_cache: dict = {}
        for k, c in enumerate(cands):
            row = stats_l[k]
            ciglen = row[6]
            if ciglen < 0:  # slot overflow: python fallback for this record
                c.resolved = True
                self._finish_backtrace(c, c.ops_row, int(start_cols[k]))
                continue
            if ciglen == 0:
                continue  # no alignment traced
            c.joined_start = joined_l[k]
            c.span = row[5]
            if not valid_l[k]:
                continue  # fragment-boundary straddle (bt2_idx.cpp:54-128)
            if row[8]:  # Ns in the alignment: nCeil cap
                rdlen = int(lens_l[srcs[k] >> 1])
                mx = nceil_cache.get(rdlen)
                if mx is None:
                    mx = nceil_cache[rdlen] = self.sc.n_ceil_for(rdlen)
                if row[8] > mx:
                    continue  # too many Ns (aligner_swsse_ee_u8.cpp:1284)
            c.refid = refid_l[k]
            c.refoff = refoff_l[k]
            c.cigar_str = cig_bytes[k * cslot : k * cslot + ciglen].decode(
                "ascii"
            )
            c.stats = LazyStats(row, md_bytes[k * mslot : k * mslot + row[7]])
            c.valid = True
        return True

    def _finish_backtrace(self, cand: Candidate, ops_row, start_col: int) -> None:
        pr = cand.problem
        # int ops_row = compacted gapless result: the op string is that
        # many M's (see _pack_bt_out)
        if isinstance(ops_row, int):
            cigar = [("M", ops_row)] if ops_row > 0 else []
        else:
            cigar = sw.ops_to_cigar(ops_row)
        if not cigar:
            return
        cand.joined_start = pr["wstart"] + start_col
        cand.span = cand.bc - start_col
        mapped = self.fm.refmap.joined_to_ref(cand.joined_start, cand.span)
        if mapped is None:
            return  # straddles fragment boundary (bt2_idx.cpp:54-128)
        cand.refid, cand.refoff = mapped
        src = pr["src"]
        rdlen = int(self._mat_lens[src // 2])
        read = self._mat_reads[src][:rdlen]
        # local mode: the op string covers read rows [row_lo, row_hi);
        # the flanks become soft clips (upstream local semantics — the
        # fork removed its local kernels, bt2_search.cpp:1345-1348)
        row_hi = cand.row_hi if cand.row_hi >= 0 else rdlen
        ql, qr = cand.row_lo, rdlen - row_hi
        if ql or qr:
            read = read[ql:row_hi]
        refw = self.text[pr["wstart"] : pr["wstart"] + pr["wlen"]]
        cigar = cigar_util.left_align_cigar(cigar, read, refw, start_col)
        stats = cigar_util.alignment_stats(read, refw, start_col, cigar)
        if stats["ns"] > self.sc.n_ceil_for(rdlen):
            return  # too many Ns (aligner_swsse_ee_u8.cpp:1284)
        if ql or qr:
            cigar = (
                ([("S", ql)] if ql else [])
                + cigar
                + ([("S", qr)] if qr else [])
            )
        cand.cigar = cigar
        cand.stats = stats
        cand.valid = True

    @staticmethod
    def rank_candidates(alns: dict, rnd=None) -> list:
        """Candidate order per selectByScore (aln_sink.cpp:1477-1628):
        score descending, every equal-score streak shuffled with the
        per-read LCG when ``rnd`` is given (a RandomSource or a lazy
        zero-arg factory — the reference's read-seeded tie-break
        contract, utils/rng.py); deterministic (fw first, end col asc)
        when it is not."""
        if len(alns) == 1:  # the common case: unique best candidate
            return list(alns.items())
        ranked = sorted(
            alns.items(), key=lambda kv: (-kv[1].score, not kv[0][0], kv[0][1])
        )
        if rnd is not None and len(ranked) > 1:
            ranked = refrng.select_by_score(
                ranked, [c.score for _k, c in ranked], rnd
            )
        return ranked

    def read_rng(self, read) -> refrng.RandomSource:
        """Per-read reporting RNG: LCG seeded from read content + --seed
        (genRandSeed pat.cpp:45-82; init site bt2_search.cpp:2528)."""
        return refrng.RandomSource(refrng.gen_rand_seed(
            read.seq, read.qual, read.name, self.opts.rng_seed
        ))

    def _tighten_filter(self, alns: dict, minsc: int, perfect: int) -> dict:
        """-M minsc tightening (aligner_sw_driver.cpp:588-618): replay
        the candidate stream in report order (dict insertion order ==
        first stream occurrence, the reference's report order),
        maintaining the running best/secondBest exactly like
        AlnSinkWrap::report (aln_sink.cpp:1427-1441) and raising the
        running minimum score per --tighten mode; candidates below the
        raised bound are exactly those whose later DP the reference
        would have failed."""
        mode = self.opts.tighten
        best = sec = None
        cur = minsc
        out = {}
        for key, c in alns.items():
            s = c.score
            if s < cur:
                continue
            out[key] = c
            if best is None or s > best:
                best, sec = s, best
            elif sec is None or s > sec:
                sec = s
            if sec is None:
                continue
            if mode == 1:
                if best >= cur:
                    cur = best
                    if cur < perfect and best == sec:
                        cur += 1
            elif mode == 2:
                if sec >= cur:
                    cur = sec
                    if cur < perfect:
                        cur += 1
            else:
                bot = sec + ((best - sec) * 3) // 4
                if bot >= cur:
                    cur = bot
                    if cur < perfect:
                        cur += 1
        return out

    def _mapq_fn(self):
        o = self.opts
        if o.mapqv == 3:
            return mapq_v3
        if o.local:
            return mapq_v2_local  # non-monotone branch, unique.h:330-383
        return mapq_v2_e2e

    def _finalize_unpaired(self, reads, minscs, cands, results,
                           table=None) -> None:
        # pick winner per read; backtraces batched across reads, advancing
        # to the next-ranked candidate only when one proves invalid
        # (fragment-boundary straddle — rare)
        if table is not None and len(table):
            self._finalize_singles_table(reads, minscs, table, results)
        o = self.opts
        multi = o.allhits or o.khits > 1
        bonus = self.sc.match_bonus
        mins_l = np.asarray(minscs, np.int64).tolist()
        lens_l = self._mat_lens.tolist()
        pend = {}  # ri -> (ranked list, next index)
        singles = []  # (ri, cand): the dominant unique-candidate case
        rank = self.rank_candidates
        read_rng = self.read_rng
        tighten = o.tighten and not multi
        for ri, alns in enumerate(cands):
            la = len(alns)
            if la == 0:
                continue
            if la == 1:  # unique candidate: no rank/RNG/pend machinery
                singles.append((ri, next(iter(alns.values()))))
                continue
            if tighten and la > 2:  # <3 candidates never prune
                alns = self._tighten_filter(
                    alns, mins_l[ri], bonus * lens_l[ri]
                )
            if len(alns) == 1:
                pend[ri] = (list(alns.items()), 0)
            else:
                pend[ri] = (
                    rank(alns, (lambda rd=reads[ri]: read_rng(rd))), 0
                )
        # -k>1 / -a report modes don't compute a meaningful MAPQ
        # (BowtieMapq2's !canMax short-circuit, unique.h:200-205)
        mapq_fn = self._mapq_fn()
        mq_cache: dict = {}  # distinct (score, secbest, minsc, len) are few
        if singles:
            # straight-line fast path: one batched backtrace, secbest is
            # None by construction, invalid (fragment straddle) reads
            # just stay unaligned — at genome scale ~every read lands
            # here, and the pend/while machinery below was ~half of the
            # finishRead phase
            self.backtrace_batch([c for _, c in singles])
            mget = mq_cache.get
            for ri, cand in singles:
                if not cand.valid:
                    continue
                if multi:
                    mq = 255
                else:
                    key = (cand.score, None, mins_l[ri], lens_l[ri])
                    mq = mget(key)
                    if mq is None:
                        mq = mq_cache[key] = mapq_fn(
                            cand.score, None, mins_l[ri],
                            bonus * lens_l[ri],
                        )
                results[ri] = AlnResult(
                    "aligned", cand.fw, cand.refid, cand.refoff,
                    cand.score, None, mq, cand._cigar, cand.cigar_str,
                    cand.stats, 1, cand.span,
                )
        while pend:
            batch = []
            for ranked, i in pend.values():
                batch.append(ranked[i][1])
                if i + 1 < len(ranked) and ranked[i + 1][1].bridge is not None:
                    # the runner-up's validity is uncertain (N-filled
                    # window: gap bridge or --overhang) — validate it now
                    # so a nceil-rejected candidate never sets XS/MAPQ
                    # (the reference only tracks second-best among
                    # alignments that survived its backtrace filters)
                    batch.append(ranked[i + 1][1])
            self.backtrace_batch(batch)
            nxt = {}
            for ri, (ranked, i) in pend.items():
                cand = ranked[i][1]
                if not cand.valid:
                    if i + 1 < len(ranked):
                        nxt[ri] = (ranked, i + 1)
                    continue
                secbest = None
                for j in range(i + 1, len(ranked)):
                    c2 = ranked[j][1]
                    if c2.resolved and not c2.valid:
                        continue  # proved invalid: not a second-best
                    secbest = c2.score
                    break
                if multi:
                    mq = 255
                else:
                    key = (cand.score, secbest, mins_l[ri], lens_l[ri])
                    mq = mq_cache.get(key)
                    if mq is None:
                        mq = mq_cache[key] = mapq_fn(
                            cand.score, secbest, mins_l[ri],
                            bonus * lens_l[ri],
                        )
                res = AlnResult(
                    status="aligned",
                    fw=cand.fw,
                    refid=cand.refid,
                    refoff=cand.refoff,
                    score=cand.score,
                    secbest=secbest,
                    mapq=mq,
                    cigar=cand._cigar,
                    cigar_str=cand.cigar_str,
                    stats=cand.stats,
                    nhits=1,
                    span=cand.span,
                )
                if multi:
                    self._attach_secondaries(res, ranked, i, secbest)
                results[ri] = res
            pend = nxt

    def _finalize_singles_table(self, reads, minscs, table, results) -> None:
        """Columnar finish of single-candidate reads (see CandTable): the
        array analog of _finalize_unpaired's singles fast path — native
        CIGAR/MD/stats straight from the table's arrays, vectorized
        validity / nCeil filters, one tight emission loop.  Results are
        bitwise those of routing the same reads through the dict path
        (tests/test_finalize_table.py); the reference's per-read finish
        loop is bt2_search.cpp:2723-2860."""
        from ..native import finish_batch

        o = self.opts
        m = len(table)
        mcounts = np.fromiter(
            (op if isinstance(op, int) else -1 for op in table.ops),
            np.int64, m,
        )
        arr_i = np.flatnonzero(mcounts < 0)
        maxlen = int(mcounts.max(initial=1))
        if len(arr_i):
            maxlen = max(maxlen, max(len(table.ops[i])
                                     for i in arr_i.tolist()))
        ops_mat = np.zeros((m, maxlen), np.uint8)
        pure = mcounts >= 0
        ops_mat[pure] = (
            np.arange(maxlen)[None, :] < mcounts[pure, None]
        ).astype(np.uint8)
        for i in arr_i.tolist():
            row = table.ops[i]
            ops_mat[i, : len(row)] = row
        row_los = clip_his = None
        if o.local:
            rdl32 = self._mat_lens[table.src >> 1].astype(np.int32)
            row_his = table.row_hi.astype(np.int32)
            row_los = table.row_lo.astype(np.int32)
            clip_his = np.where(row_his >= 0, rdl32 - row_his, 0)
        out = finish_batch(ops_mat, table.start_col.astype(np.int32),
                           table.wstart, self._mat_reads, table.src,
                           self.text, row_los=row_los, clip_his=clip_his)
        if out is None:
            # no native library: run these rows through the object path
            tmp = [{} for _ in range(len(reads))]
            for t in range(m):
                c = table.candidate(t)
                tmp[int(table.ri[t])][(c.fw, c.endj)] = c
            self._finalize_unpaired(reads, minscs, tmp, results)
            return
        self.metrics.add(backtraces=m)
        cig_buf, md_buf, stats = out
        spans = stats[:, 5]
        joined = table.wstart + table.start_col
        refid, refoff, valid = self.fm.refmap.joined_to_ref_batch(
            joined, spans
        )
        ciglen = stats[:, 6]
        ovf = np.flatnonzero(ciglen < 0)  # slot overflow: object fallback
        okm = valid & (ciglen > 0)
        okm[ovf] = False
        lens_t = self._mat_lens[table.src >> 1]
        ns = stats[:, 8]
        need_ns = np.flatnonzero(okm & (ns > 0))
        if len(need_ns):
            nceil_cache: dict = {}
            for t in need_ns.tolist():
                L = int(lens_t[t])
                mx = nceil_cache.get(L)
                if mx is None:
                    mx = nceil_cache[L] = self.sc.n_ceil_for(L)
                if ns[t] > mx:  # aligner_swsse_ee_u8.cpp:1284
                    okm[t] = False
        multi = o.allhits or o.khits > 1
        mins_a = np.asarray(minscs, np.int64)
        bonus = self.sc.match_bonus
        mapq_fn = self._mapq_fn()
        ok_i = np.flatnonzero(okm)
        ok_l = ok_i.tolist()
        ri_l = table.ri[ok_i].tolist()
        fw_l = table.fw[ok_i].tolist()
        sc_l = table.score[ok_i].tolist()
        rid_l = refid[ok_i].tolist()
        roff_l = refoff[ok_i].tolist()
        minsc_l = mins_a[table.ri[ok_i]].tolist()
        len_l = lens_t[ok_i].tolist()
        stats_l = stats[ok_i].tolist()
        cig_bytes = cig_buf.tobytes()
        md_bytes = md_buf.tobytes()
        cslot = cig_buf.shape[1]
        mslot = md_buf.shape[1]
        mq_cache: dict = {}
        mget = mq_cache.get
        # hottest loop in the aligner (~1M iterations per 1M reads at
        # genome scale): iterate with zip, build AlnResults via __new__
        # + direct slot stores — AlnResult.__init__'s call frame plus
        # default handling alone measured 6.2 s/1M reads in the GRCh38
        # profile. Field set must mirror AlnResult.__init__ exactly.
        new = AlnResult.__new__
        for k, ri_t, fw_t, sc_t, rid_t, roff_t, minsc_t, len_t, row in zip(
            ok_l, ri_l, fw_l, sc_l, rid_l, roff_l, minsc_l, len_l, stats_l
        ):
            if multi:
                mq = 255  # !canMax short-circuit, unique.h:200-205
            else:
                key = (sc_t, minsc_t, len_t)
                mq = mget(key)
                if mq is None:
                    mq = mq_cache[key] = mapq_fn(
                        sc_t, None, minsc_t, bonus * len_t
                    )
            r = new(AlnResult)
            r.status = "aligned"
            r.fw = fw_t
            r.refid = rid_t
            r.refoff = roff_t
            r.score = sc_t
            r.secbest = None
            r.mapq = mq
            r._cigar = None
            r.cigar_str = cig_bytes[k * cslot : k * cslot + row[6]].decode(
                "ascii")
            r.stats = LazyStats(row, md_bytes[k * mslot : k * mslot + row[7]])
            r.nhits = 1
            r.span = row[5]
            r.extra = []
            r.filt = None
            results[ri_t] = r
        for t in ovf.tolist():
            c = table.candidate(t)
            c.resolved = True
            self._finish_backtrace(c, c.ops_row, int(table.start_col[t]))
            if not c.valid:
                continue
            ri = int(table.ri[t])
            mq = 255 if multi else mapq_fn(
                c.score, None, int(mins_a[ri]), bonus * int(lens_t[t])
            )
            results[ri] = AlnResult(
                "aligned", c.fw, c.refid, c.refoff, c.score, None, mq,
                c._cigar, c.cigar_str, c.stats, 1, c.span,
            )

    def _attach_secondaries(self, res: AlnResult, ranked, primary_i: int,
                            secbest) -> None:
        """-k/-a: report additional distinct alignments as secondary records
        (SAM_FLAG_NOT_PRIMARY; selection order = rank order, the
        deterministic stand-in for selectAlnsToReport's rotation,
        aln_sink.cpp:1640-1676)."""
        o = self.opts
        limit = len(ranked) if o.allhits else o.khits
        extras = []
        for j, (_key, cand) in enumerate(ranked):
            if len(extras) + 1 >= limit:
                break
            if j == primary_i:
                continue
            self.backtrace(cand)
            if not cand.valid:
                continue
            extras.append(AlnResult(
                status="aligned",
                fw=cand.fw,
                refid=cand.refid,
                refoff=cand.refoff,
                score=cand.score,
                secbest=secbest,
                mapq=255,
                cigar=cand._cigar,
                cigar_str=cand.cigar_str,
                stats=cand.stats,
                nhits=1,
                span=cand.span,
            ))
        res.extra = extras
        res.nhits = 1 + len(extras)
        # XS from surviving alignments: the rank-order secbest may have
        # been a candidate the backtrace filters rejected (nceil /
        # fragment straddle); first not-known-invalid non-primary wins
        vsec = None
        for j, (_key, c2) in enumerate(ranked):
            if j == primary_i or (c2.resolved and not c2.valid):
                continue
            vsec = c2.score
            break
        if res.secbest != vsec:
            res.secbest = vsec
            for ex in extras:
                ex.secbest = vsec
