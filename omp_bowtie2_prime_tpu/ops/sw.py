"""Banded end-to-end Smith-Waterman seed extension.

Device replacement for the reference's Farrar striped-SSE kernels
(EEU8_alignNucleotides, aligner_swsse_ee_u8.cpp:398-536 and the i16
variant). Instead of striping the read into SIMD segments with lazy-F
fixups, the recurrence is reorganized row-by-row with the horizontal
(read-gap) state computed as a max-plus prefix scan over the whole row:

    F[i][j] = max(H[i-1][j] - rfg_open, F[i-1][j] - rfg_ext)        (vertical)
    Ho[i][j] = max(H[i-1][j-1] + s(i,j), F[i][j])                   (no E yet)
    E[i][j] = max_{k<j} Ho[i][k] - rdg_open - (j-1-k)*rdg_ext       (prefix max)
    H[i][j] = max(Ho[i][j], E[i][j])

The E scan is exact for affine gaps: a read-gap run always starts from a
non-E state (continuing through an E-valued H is dominated by extending),
so E is a cummax of Ho[k] + k*ext. Rows iterate in a fori_loop; columns
and the problem batch vectorize. Scores are int32 on device (the
reference's u8 saturating domain is an x86 register-width artifact).

Semantics matched to the reference end-to-end mode: whole read aligned
(no soft clips), free leading/trailing reference within the window,
qual-scaled mismatch penalties, N penalty, affine gaps with the gap
barrier (gGapBarrier) vetoing gaps within `gbar` read chars of either end.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

NEG = -(1 << 20)


def gather_ref_windows(ref_words, wstart, wlen, C: int):
    """Reference DP windows gathered ON DEVICE from the 2-bit packed
    text: [B] joined window starts -> [B, C] int8 base codes, 4 beyond
    wlen.  Replaces shipping the windows over the host link (the
    BitPairReference getStretch analog, reference.h:111, moved to where
    the text already lives).

    ref_words must carry >= C//16 + 2 words of zero padding (see
    DeviceIndex.from_host).  One contiguous word slice per row (XLA
    lowers the vmapped dynamic_slice to a sliced gather) + a 16-way
    static-shift select instead of per-element gathers (chosen for
    the original accelerator; unmeasured on this device).
    """
    B = wstart.shape[0]
    W16 = (C + 15) // 16 + 1
    # word index always fits int32: nrows < 2^32 -> nwords < 2^28
    w0 = (wstart >> 4).astype(jnp.int32)
    words = jax.vmap(
        lambda s: jax.lax.dynamic_slice(ref_words, (s,), (W16,))
    )(w0)  # [B, W16] uint32
    shifts = (jnp.arange(16, dtype=jnp.uint32) * 2)[None, None, :]
    crumbs = (words[:, :, None] >> shifts) & 3  # [B, W16, 16] LSB-first
    unp = crumbs.reshape(B, W16 * 16).astype(jnp.int8)
    sh = (wstart & 15).astype(jnp.int32)  # [B] in-word offset
    stacked = jnp.stack(
        [unp[:, k : k + C] for k in range(16)], axis=0
    )  # [16, B, C]
    onehot = (
        jnp.arange(16, dtype=jnp.int32)[:, None] == sh[None, :]
    ).astype(jnp.int8)  # [16, B]
    refs = jnp.sum(stacked * onehot[:, :, None], axis=0)
    mask = (jnp.arange(C, dtype=jnp.int32)[None, :]
            >= wlen[:, None].astype(jnp.int32))
    return jnp.where(mask, jnp.int8(4), refs)


@dataclasses.dataclass(frozen=True)
class SWParams:
    """Static DP parameters (device kernel specializes on these).
    `ma` (match bonus) is only consumed by the local kernels: end-to-end
    mode is monotone with ma = 0 by construction (scoring.h:28-30)."""

    rdg_open: int = 8  # first read-gap char (const+linear)
    rdg_ext: int = 3
    rfg_open: int = 8
    rfg_ext: int = 3
    npen: int = 1
    gbar: int = 4
    ma: int = 0

    @classmethod
    def from_scoring(cls, sc) -> "SWParams":
        return cls(
            rdg_open=sc.read_gap_open,
            rdg_ext=sc.read_gap_extend,
            rfg_open=sc.ref_gap_open,
            rfg_ext=sc.ref_gap_extend,
            npen=sc.npen,
            gbar=sc.gap_barrier,
            ma=sc.match_bonus,
        )


def sw_e2e_batch(
    reads: jnp.ndarray,  # [B, L] int32 codes (4 = N/pad)
    pen_mm: jnp.ndarray,  # [B, L] int32 qual-scaled mismatch penalty per pos
    rdlens: jnp.ndarray,  # [B] int32
    refs: jnp.ndarray,  # [B, W] int32 window codes (4 = pad)
    wlens: jnp.ndarray,  # [B] int32 valid window length (<= W)
    p: SWParams,
):
    """Batched end-to-end DP. Returns (best [B], bestcol [B], hlast [B, W+1]).

    hlast[b, j] = best score of an alignment consuming the whole read and
    exactly j reference chars from the window start... (j = end column).
    """
    reads = reads.astype(jnp.int32)
    pen_mm = pen_mm.astype(jnp.int32)
    refs = refs.astype(jnp.int32)
    B, L = reads.shape
    W = refs.shape[1]
    C = W + 1  # columns incl. virtual empty-ref column 0

    cols = jnp.arange(C, dtype=jnp.int32)[None, :]  # [1, C]
    col_ok = cols <= wlens[:, None]  # [B, C]

    h0 = jnp.where(col_ok, 0, NEG).astype(jnp.int32)
    f0 = jnp.full((B, C), NEG, jnp.int32)
    hfin = jnp.full((B, C), NEG, jnp.int32)

    k_ext = cols * p.rdg_ext  # [1, C] for the E scan

    def body(i, carry):
        # i: 1-based read row
        h_prev, f_prev, hfin = carry
        rc = jax.lax.dynamic_index_in_dim(reads, i - 1, axis=1)  # [B, 1]
        pm = jax.lax.dynamic_index_in_dim(pen_mm, i - 1, axis=1)  # [B, 1]
        rd_n = rc >= 4
        ref_n = refs >= 4
        s = jnp.where(
            rd_n | ref_n,
            -p.npen,
            jnp.where(refs == rc, 0, -pm),
        ).astype(jnp.int32)  # [B, W]

        gap_ok = (i > p.gbar) & (i <= rdlens - p.gbar)  # [B]
        gmask = jnp.where(gap_ok, 0, NEG)[:, None].astype(jnp.int32)

        f = jnp.maximum(h_prev - p.rfg_open + gmask, f_prev - p.rfg_ext)
        f = jnp.maximum(f, NEG)

        diag = jnp.concatenate(
            [jnp.full((B, 1), NEG, jnp.int32), h_prev[:, :-1] + s], axis=1
        )
        h_open = jnp.maximum(diag, f)

        scan = jax.lax.cummax(h_open + k_ext, axis=1)
        e = jnp.concatenate(
            [
                jnp.full((B, 1), NEG, jnp.int32),
                scan[:, :-1] - p.rdg_open - k_ext[:, 1:] + p.rdg_ext + gmask,
            ],
            axis=1,
        )
        e = jnp.maximum(e, NEG)

        h = jnp.maximum(h_open, e)
        h = jnp.where(col_ok, jnp.maximum(h, NEG), NEG)

        hfin = jnp.where((i == rdlens)[:, None], h, hfin)
        return h, f, hfin

    _, _, hfin = jax.lax.fori_loop(1, L + 1, body, (h0, f0, hfin))
    best = jnp.max(hfin, axis=1)
    bestcol = jnp.argmax(hfin, axis=1).astype(jnp.int32)
    return best, bestcol, hfin


def sw_e2e_tb_batch(
    reads: jnp.ndarray,  # [B, L] int32 codes (4 = N/pad)
    pen_mm: jnp.ndarray,  # [B, L]
    rdlens: jnp.ndarray,  # [B]
    refs: jnp.ndarray,  # [B, W]
    wlens: jnp.ndarray,  # [B]
    p: SWParams,
):
    """DP with per-cell trace bits for host backtrace. Returns
    (best [B], bestcol [B], tb [B, L, W+1] uint8) where tb bits encode the
    predecessor tests the host walk needs (the analog of the reference
    storing full E/F/H SSE matrices for its CPU backtrace,
    aligner_swsse.h:104-241):

      bit0: diagonal step achieves H   (M move valid)
      bit1: F achieves H               (prefer F over E when not M)
      bit2: F opens from H above       (leave F state)
      bit3: E opens from H left        (leave E state)

    Walk cost on host is O(L + W) per problem with no score matrices.
    """
    reads = reads.astype(jnp.int32)
    pen_mm = pen_mm.astype(jnp.int32)
    refs = refs.astype(jnp.int32)
    B, L = reads.shape
    W = refs.shape[1]
    C = W + 1

    cols = jnp.arange(C, dtype=jnp.int32)[None, :]
    col_ok = cols <= wlens[:, None]

    h0 = jnp.where(col_ok, 0, NEG).astype(jnp.int32)
    f0 = jnp.full((B, C), NEG, jnp.int32)
    hfin = jnp.full((B, C), NEG, jnp.int32)
    tb0 = jnp.zeros((B, L, C), jnp.uint8)

    k_ext = cols * p.rdg_ext

    def body(i, carry):
        h_prev, f_prev, hfin, tb = carry
        rc = jax.lax.dynamic_index_in_dim(reads, i - 1, axis=1)
        pm = jax.lax.dynamic_index_in_dim(pen_mm, i - 1, axis=1)
        rd_n = rc >= 4
        ref_n = refs >= 4
        s = jnp.where(
            rd_n | ref_n, -p.npen, jnp.where(refs == rc, 0, -pm)
        ).astype(jnp.int32)

        gap_ok = (i > p.gbar) & (i <= rdlens - p.gbar)
        gmask = jnp.where(gap_ok, 0, NEG)[:, None].astype(jnp.int32)

        f = jnp.maximum(h_prev - p.rfg_open + gmask, f_prev - p.rfg_ext)
        f = jnp.maximum(f, NEG)

        diag = jnp.concatenate(
            [jnp.full((B, 1), NEG, jnp.int32), h_prev[:, :-1] + s], axis=1
        )
        h_open = jnp.maximum(diag, f)

        scan = jax.lax.cummax(h_open + k_ext, axis=1)
        e = jnp.concatenate(
            [
                jnp.full((B, 1), NEG, jnp.int32),
                scan[:, :-1] - p.rdg_open - k_ext[:, 1:] + p.rdg_ext + gmask,
            ],
            axis=1,
        )
        e = jnp.maximum(e, NEG)

        h = jnp.maximum(h_open, e)
        h = jnp.where(col_ok, jnp.maximum(h, NEG), NEG)

        b0 = (diag >= h).astype(jnp.uint8)
        b1 = (f >= h).astype(jnp.uint8)
        b2 = ((h_prev - p.rfg_open + gmask) >= f).astype(jnp.uint8)
        left_open = jnp.concatenate(
            [
                jnp.zeros((B, 1), jnp.int32),
                ((h[:, :-1] - p.rdg_open + gmask) >= e[:, 1:]).astype(jnp.int32),
            ],
            axis=1,
        ).astype(jnp.uint8)
        row_bits = b0 | (b1 << 1) | (b2 << 2) | (left_open << 3)
        tb = jax.lax.dynamic_update_slice_in_dim(
            tb, row_bits[:, None, :], i - 1, axis=1
        )

        hfin = jnp.where((i == rdlens)[:, None], h, hfin)
        return h, f, hfin, tb

    _, _, hfin, tb = jax.lax.fori_loop(1, L + 1, body, (h0, f0, hfin, tb0))
    best = jnp.max(hfin, axis=1)
    bestcol = jnp.argmax(hfin, axis=1).astype(jnp.int32)
    return best, bestcol, tb


def sw_e2e_backtrace_batch(
    reads: jnp.ndarray,  # [B, L] int32 codes (4 = N/pad)
    pen_mm: jnp.ndarray,
    rdlens: jnp.ndarray,
    refs: jnp.ndarray,
    wlens: jnp.ndarray,
    p: SWParams,
):
    """Fused DP + device backtrace walk. The trace-bit matrix never leaves
    the device; only the op string does (~L+W bytes/problem instead of
    L*W). Returns (best [B], bestcol [B], ops [B, L+W+1] uint8 in
    END->START order with 0 = done, 1=M 2=I 3=D, start_col [B])."""
    best, bestcol, tb = sw_e2e_tb_batch(reads, pen_mm, rdlens, refs, wlens, p)
    B, L = reads.shape
    C = refs.shape[1] + 1
    MAXOPS = L + C
    tbf = tb.reshape(B, L * C)
    lanes = jnp.arange(B, dtype=jnp.int32)

    def step(k, carry):
        i, j, state, ops = carry
        done = i <= 0
        bidx = jnp.clip(i - 1, 0, L - 1) * C + j
        bits = jnp.take_along_axis(tbf, bidx[:, None], axis=1)[:, 0].astype(jnp.int32)
        in_h = state == 0
        m_ok = in_h & ((bits & 1) > 0) & (j > 0)
        f_br = (state == 1) | (in_h & ~m_ok & ((bits & 2) > 0))
        e_br = ~m_ok & ~f_br
        op = jnp.where(done, 0, jnp.where(m_ok, 1, jnp.where(f_br, 2, 3)))
        ops = jax.lax.dynamic_update_slice_in_dim(
            ops, op.astype(jnp.uint8)[:, None], k, axis=1
        )
        ni = jnp.where(done | e_br, i, i - 1)
        nj = jnp.where(done | f_br, j, j - 1)
        nstate = jnp.where(
            done, state,
            jnp.where(
                m_ok, 0,
                jnp.where(
                    f_br,
                    jnp.where((bits & 4) > 0, 0, 1),
                    jnp.where((bits & 8) > 0, 0, 2),
                ),
            ),
        )
        return ni, nj, nstate, ops

    init = (
        rdlens.astype(jnp.int32),
        bestcol.astype(jnp.int32),
        jnp.zeros(B, jnp.int32),
        jnp.zeros((B, MAXOPS), jnp.uint8),
    )
    _, j_fin, _, ops = jax.lax.fori_loop(0, MAXOPS, step, init)
    return best, bestcol, pack_ops2(ops), j_fin


def pack_ops2(ops: jnp.ndarray) -> jnp.ndarray:
    """Pack device op codes (0..3) 4-per-byte for the device->host copy —
    the ops matrix dominates result-transfer bytes.  [B, M] uint8
    -> [B, ceil(M/4)] uint8, little-endian 2-bit fields."""
    B, M = ops.shape
    MP = -(-M // 4) * 4
    o = jnp.pad(ops, ((0, 0), (0, MP - M))).reshape(B, MP // 4, 4)
    o = o.astype(jnp.uint8)
    return o[:, :, 0] | (o[:, :, 1] << 2) | (o[:, :, 2] << 4) | (o[:, :, 3] << 6)


def unpack_ops2(packed: np.ndarray) -> np.ndarray:
    """Host inverse of pack_ops2 (op 0 terminates a row, so the <=3
    trailing pad codes are inert)."""
    B, P = packed.shape
    out = np.empty((B, P * 4), np.uint8)
    for k in range(4):
        out[:, k::4] = (packed >> (2 * k)) & 3
    return out


def ops_to_cigar(ops_row: np.ndarray) -> list:
    """RLE an END->START device op string into a CIGAR [(op, n)]."""
    v = ops_row[ops_row != 0][::-1]
    if len(v) == 0:
        return []
    brk = np.flatnonzero(np.diff(v)) + 1
    starts = np.concatenate([[0], brk])
    ends = np.concatenate([brk, [len(v)]])
    sym = "XMID"
    return [(sym[int(v[s])], int(e - s)) for s, e in zip(starts, ends)]


def backtrace_bits(read, refw, tb: np.ndarray, end_col: int, score: int) -> "Alignment":
    """Host walk over device trace bits (see sw_e2e_tb_batch). Same
    deterministic move priority as backtrace_numpy: M > F > E."""
    L = len(read)
    i, j = L, int(end_col)
    state = "H"
    edits = []
    ops = []
    while i > 0:
        bits = int(tb[i - 1, j])
        if state == "H":
            if (bits & 1) and j > 0:
                rc, refc = int(read[i - 1]), int(refw[j - 1])
                if rc >= 4 or refc >= 4:
                    edits.append((i - 1, "n", refc))
                elif rc != refc:
                    edits.append((i - 1, "mm", refc))
                ops.append("M")
                i, j = i - 1, j - 1
            elif bits & 2:
                state = "F"
            else:
                state = "E"
        elif state == "F":
            edits.append((i - 1, "ins", -1))
            ops.append("I")
            if bits & 4:
                state = "H"
            i -= 1
        else:  # E
            edits.append((i, "del", int(refw[j - 1])))
            ops.append("D")
            if bits & 8:
                state = "H"
            j -= 1
    start_col = j
    ops.reverse()
    edits.reverse()
    cigar = []
    for op in ops:
        if cigar and cigar[-1][0] == op:
            cigar[-1][1] += 1
        else:
            cigar.append([op, 1])
    return Alignment(
        score=int(score),
        start_col=start_col,
        end_col=int(end_col),
        edits=edits,
        cigar=[(o, n) for o, n in cigar],
    )


# ---------------------------------------------------------------------------
# numpy oracle + backtrace (host side; the reference backtraces on CPU-side
# stored matrices too — backtraceNucleotidesEnd2EndSseU8,
# aligner_swsse_ee_u8.cpp:746-1350)
# ---------------------------------------------------------------------------


def sw_e2e_full_numpy(read, pen_mm, refw, p: SWParams):
    """Full H/E/F matrices, [L+1, W+1] int64. Same semantics as device.

    Row-vectorized like the device kernel; E uses the prefix-max scan,
    which equals the standard E recurrence (opening from an E-valued H is
    dominated by extending when rdg_open >= rdg_ext, induction on j)."""
    read = np.asarray(read)
    refw = np.asarray(refw, dtype=np.int64)
    L = len(read)
    W = len(refw)
    H = np.full((L + 1, W + 1), NEG, dtype=np.int64)
    E = np.full((L + 1, W + 1), NEG, dtype=np.int64)
    F = np.full((L + 1, W + 1), NEG, dtype=np.int64)
    H[0, :] = 0
    k_ext = np.arange(W + 1, dtype=np.int64) * p.rdg_ext
    for i in range(1, L + 1):
        gap_ok = (i > p.gbar) and (i <= L - p.gbar)
        rc = int(read[i - 1])
        if rc >= 4:
            s = np.full(W, -p.npen, dtype=np.int64)
        else:
            s = np.where(
                refw >= 4, -p.npen, np.where(refw == rc, 0, -int(pen_mm[i - 1]))
            )
        f = np.maximum(
            (H[i - 1] - p.rfg_open) if gap_ok else NEG, F[i - 1] - p.rfg_ext
        )
        np.maximum(f, NEG, out=f)
        F[i] = f
        ho = np.empty(W + 1, dtype=np.int64)
        ho[0] = f[0]
        np.maximum(H[i - 1, :-1] + s, f[1:], out=ho[1:])
        if gap_ok:
            scan = np.maximum.accumulate(ho + k_ext)
            e = np.empty(W + 1, dtype=np.int64)
            e[0] = NEG
            e[1:] = scan[:-1] - p.rdg_open - k_ext[1:] + p.rdg_ext
            np.maximum(e, NEG, out=e)
        else:
            e = np.full(W + 1, NEG, dtype=np.int64)
        E[i] = e
        H[i] = np.maximum(np.maximum(ho, e), NEG)
    return H, E, F


@dataclasses.dataclass
class Alignment:
    score: int
    start_col: int  # window column where alignment starts (ref chars before)
    end_col: int  # window column after last consumed ref char
    edits: list  # (read_pos, kind, ref_code) kind in {"mm","ins","del","n"}
    cigar: list  # [(op, length)] ops in "MID"


def backtrace_numpy(read, pen_mm, refw, p: SWParams, H, E, F, end_col):
    """Trace one alignment ending at (L, end_col). Deterministic priority:
    diagonal > ref gap (F) > read gap (E). (The reference tie-breaks with a
    read-seeded RNG — aligner_swsse_ee_u8.cpp backtrace; deterministic order
    is round-1 behavior, RNG-compatible selection is a later milestone.)"""
    L = len(read)
    i, j = L, int(end_col)
    state = "H"
    edits = []
    ops = []  # reversed cigar ops
    while i > 0:
        gap_ok = (i > p.gbar) and (i <= L - p.gbar)
        if state == "H":
            # recompute components
            f = F[i, j]
            e = E[i, j]
            if j > 0:
                rc = read[i - 1]
                refc = refw[j - 1]
                if rc >= 4 or refc >= 4:
                    s = -p.npen
                elif refc == rc:
                    s = 0
                else:
                    s = -int(pen_mm[i - 1])
                diag = H[i - 1, j - 1] + s
            else:
                diag = NEG
            if diag >= H[i, j] and j > 0:
                if s != 0:
                    kind = "n" if (read[i - 1] >= 4 or refw[j - 1] >= 4) else "mm"
                    edits.append((i - 1, kind, int(refw[j - 1])))
                ops.append("M")
                i, j = i - 1, j - 1
            elif f >= H[i, j]:
                state = "F"
            else:
                state = "E"
        elif state == "F":
            # ref gap: read char i-1 consumed, no ref char (CIGAR I)
            edits.append((i - 1, "ins", -1))
            ops.append("I")
            up_open = (H[i - 1, j] - p.rfg_open) if gap_ok else NEG
            if up_open >= F[i, j]:
                state = "H"
            i = i - 1
        else:  # E: read gap: ref char j-1 consumed, no read char (CIGAR D)
            edits.append((i, "del", int(refw[j - 1])))
            ops.append("D")
            left_open = (H[i, j - 1] - p.rdg_open) if gap_ok else NEG
            if left_open >= E[i, j]:
                state = "H"
            j = j - 1
    start_col = j
    ops.reverse()
    edits.reverse()
    cigar = []
    for op in ops:
        if cigar and cigar[-1][0] == op:
            cigar[-1][1] += 1
        else:
            cigar.append([op, 1])
    return Alignment(
        score=int(H[L, end_col]),
        start_col=start_col,
        end_col=int(end_col),
        edits=edits,
        cigar=[(o, n) for o, n in cigar],
    )


# ---------------------------------------------------------------------------
# Local-mode kernels. The reference fork REMOVED its local SSE kernels
# (--local prints "not supported", bt2_search.cpp:1345-1348) but kept the
# whole local policy surface (match bonus DEFAULT_MATCH_BONUS_LOCAL=2,
# scoring.h:32-33; --score-min G,20,8 scoring.h:54-55; local presets
# presets.cpp:62-92; local MAPQ table unique.h:330-383). These kernels
# restore upstream bowtie2's local capability on the same row-scan DP:
# the recurrence gains the classic Smith-Waterman 0 floor (alignments may
# start at any cell), the best cell is tracked over ALL rows (alignments
# may end before the read does -> trailing soft clip), and the backtrace
# stops at the first 0-valued H cell (-> leading soft clip).
# ---------------------------------------------------------------------------


def sw_local_tb_batch(
    reads: jnp.ndarray,  # [B, L] int32 codes (4 = N/pad)
    pen_mm: jnp.ndarray,  # [B, L]
    rdlens: jnp.ndarray,  # [B]
    refs: jnp.ndarray,  # [B, W]
    wlens: jnp.ndarray,  # [B]
    p: SWParams,
):
    """Local DP with trace bits. Returns (best [B], bestrow [B],
    bestcol [B], tb [B, L, W+1] uint8). Trace bits 0-3 as in
    sw_e2e_tb_batch, plus bit4: H == 0 (local start point — the backtrace
    stops here). Ties for the best cell resolve to the smallest row, then
    the smallest column (deterministic; the reference's RNG tie-break died
    with its local kernels)."""
    reads = reads.astype(jnp.int32)
    pen_mm = pen_mm.astype(jnp.int32)
    refs = refs.astype(jnp.int32)
    B, L = reads.shape
    W = refs.shape[1]
    C = W + 1

    cols = jnp.arange(C, dtype=jnp.int32)[None, :]
    col_ok = cols <= wlens[:, None]

    h0 = jnp.where(col_ok, 0, NEG).astype(jnp.int32)
    f0 = jnp.full((B, C), NEG, jnp.int32)
    tb0 = jnp.zeros((B, L, C), jnp.uint8)
    best0 = jnp.zeros(B, jnp.int32)
    brow0 = jnp.zeros(B, jnp.int32)
    bcol0 = jnp.zeros(B, jnp.int32)

    k_ext = cols * p.rdg_ext

    def body(i, carry):
        h_prev, f_prev, best, brow, bcol, tb = carry
        rc = jax.lax.dynamic_index_in_dim(reads, i - 1, axis=1)
        pm = jax.lax.dynamic_index_in_dim(pen_mm, i - 1, axis=1)
        rd_n = rc >= 4
        ref_n = refs >= 4
        s = jnp.where(
            rd_n | ref_n, -p.npen, jnp.where(refs == rc, p.ma, -pm)
        ).astype(jnp.int32)

        gap_ok = (i > p.gbar) & (i <= rdlens - p.gbar)
        gmask = jnp.where(gap_ok, 0, NEG)[:, None].astype(jnp.int32)

        f = jnp.maximum(h_prev - p.rfg_open + gmask, f_prev - p.rfg_ext)
        f = jnp.maximum(f, NEG)

        diag = jnp.concatenate(
            [jnp.full((B, 1), NEG, jnp.int32), h_prev[:, :-1] + s], axis=1
        )
        h_open = jnp.maximum(diag, f)

        scan = jax.lax.cummax(h_open + k_ext, axis=1)
        e = jnp.concatenate(
            [
                jnp.full((B, 1), NEG, jnp.int32),
                scan[:, :-1] - p.rdg_open - k_ext[:, 1:] + p.rdg_ext + gmask,
            ],
            axis=1,
        )
        e = jnp.maximum(e, NEG)

        # the 0 floor: any cell may start a fresh local alignment.
        # E sources below 0 can never surface through the floor (an E >= 0
        # needs a source H >= rdg_open > 0), so scanning pre-floor h_open
        # stays exact — same induction as the end-to-end scan.
        h = jnp.maximum(jnp.maximum(h_open, e), 0)
        h = jnp.where(col_ok, h, NEG)

        b0 = (diag >= h).astype(jnp.uint8)
        b1 = (f >= h).astype(jnp.uint8)
        b2 = ((h_prev - p.rfg_open + gmask) >= f).astype(jnp.uint8)
        left_open = jnp.concatenate(
            [
                jnp.zeros((B, 1), jnp.int32),
                ((h[:, :-1] - p.rdg_open + gmask) >= e[:, 1:]).astype(jnp.int32),
            ],
            axis=1,
        ).astype(jnp.uint8)
        b4 = (h == 0).astype(jnp.uint8)
        row_bits = b0 | (b1 << 1) | (b2 << 2) | (left_open << 3) | (b4 << 4)
        tb = jax.lax.dynamic_update_slice_in_dim(
            tb, row_bits[:, None, :], i - 1, axis=1
        )

        # best-cell tracking, only over real read rows (i <= rdlen)
        hm = jnp.where(col_ok & (i <= rdlens)[:, None], h, NEG)
        rowbest = jnp.max(hm, axis=1)
        rowarg = jnp.argmax(hm, axis=1).astype(jnp.int32)
        upd = rowbest > best
        best = jnp.where(upd, rowbest, best)
        brow = jnp.where(upd, i, brow)
        bcol = jnp.where(upd, rowarg, bcol)
        return h, f, best, brow, bcol, tb

    _, _, best, brow, bcol, tb = jax.lax.fori_loop(
        1, L + 1, body, (h0, f0, best0, brow0, bcol0, tb0)
    )
    return best, brow, bcol, tb


def sw_local_backtrace_batch(
    reads: jnp.ndarray,  # [B, L] int32 codes (4 = N/pad)
    pen_mm: jnp.ndarray,
    rdlens: jnp.ndarray,
    refs: jnp.ndarray,
    wlens: jnp.ndarray,
    p: SWParams,
):
    """Fused local DP + device backtrace. Returns (best [B], bestrow [B],
    bestcol [B], packed ops [B, ceil((L+W+1)/4)] uint8 END->START,
    start_col [B], start_row [B]). Leading soft clip = start_row chars,
    trailing = rdlen - bestrow."""
    best, brow, bcol, tb = sw_local_tb_batch(
        reads, pen_mm, rdlens, refs, wlens, p
    )
    B, L = reads.shape
    C = refs.shape[1] + 1
    MAXOPS = L + C
    tbf = tb.reshape(B, L * C)

    def step(k, carry):
        i, j, state, ops = carry
        bidx = jnp.clip(i - 1, 0, L - 1) * C + j
        bits = jnp.take_along_axis(
            tbf, bidx[:, None], axis=1)[:, 0].astype(jnp.int32)
        in_h = state == 0
        # stop on read start OR a 0-valued H cell reached in H state
        done = (i <= 0) | (in_h & ((bits & 16) > 0))
        m_ok = in_h & ((bits & 1) > 0) & (j > 0)
        f_br = (state == 1) | (in_h & ~m_ok & ((bits & 2) > 0))
        op = jnp.where(done, 0, jnp.where(m_ok, 1, jnp.where(f_br, 2, 3)))
        e_br = ~m_ok & ~f_br
        ops = jax.lax.dynamic_update_slice_in_dim(
            ops, op.astype(jnp.uint8)[:, None], k, axis=1
        )
        ni = jnp.where(done | e_br, i, i - 1)
        nj = jnp.where(done | f_br, j, j - 1)
        nstate = jnp.where(
            done, state,
            jnp.where(
                m_ok, 0,
                jnp.where(
                    f_br,
                    jnp.where((bits & 4) > 0, 0, 1),
                    jnp.where((bits & 8) > 0, 0, 2),
                ),
            ),
        )
        return ni, nj, nstate, ops

    init = (
        brow.astype(jnp.int32),
        bcol.astype(jnp.int32),
        jnp.zeros(B, jnp.int32),
        jnp.zeros((B, MAXOPS), jnp.uint8),
    )
    i_fin, j_fin, _, ops = jax.lax.fori_loop(0, MAXOPS, step, init)
    return best, brow, bcol, pack_ops2(ops), j_fin, i_fin


def sw_local_full_numpy(read, pen_mm, refw, p: SWParams):
    """Local-mode numpy oracle: full floored H/E/F, [L+1, W+1] int64."""
    read = np.asarray(read)
    refw = np.asarray(refw, dtype=np.int64)
    L = len(read)
    W = len(refw)
    H = np.full((L + 1, W + 1), NEG, dtype=np.int64)
    E = np.full((L + 1, W + 1), NEG, dtype=np.int64)
    F = np.full((L + 1, W + 1), NEG, dtype=np.int64)
    H[0, :] = 0
    k_ext = np.arange(W + 1, dtype=np.int64) * p.rdg_ext
    for i in range(1, L + 1):
        gap_ok = (i > p.gbar) and (i <= L - p.gbar)
        rc = int(read[i - 1])
        if rc >= 4:
            s = np.full(W, -p.npen, dtype=np.int64)
        else:
            s = np.where(
                refw >= 4, -p.npen,
                np.where(refw == rc, p.ma, -int(pen_mm[i - 1])),
            )
        f = np.maximum(
            (H[i - 1] - p.rfg_open) if gap_ok else NEG, F[i - 1] - p.rfg_ext
        )
        np.maximum(f, NEG, out=f)
        F[i] = f
        ho = np.empty(W + 1, dtype=np.int64)
        ho[0] = f[0]
        np.maximum(H[i - 1, :-1] + s, f[1:], out=ho[1:])
        if gap_ok:
            scan = np.maximum.accumulate(ho + k_ext)
            e = np.empty(W + 1, dtype=np.int64)
            e[0] = NEG
            e[1:] = scan[:-1] - p.rdg_open - k_ext[1:] + p.rdg_ext
            np.maximum(e, NEG, out=e)
        else:
            e = np.full(W + 1, NEG, dtype=np.int64)
        E[i] = e
        H[i] = np.maximum(np.maximum(ho, e), 0)
    return H, E, F
