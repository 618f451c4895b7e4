"""FM-index builder (host side).

Equivalent capability to bowtie2-build's driver (ref: bt2_build.cpp:376,
Ebwt::buildToDisk bt2_idx.h:2922-3290) but emits the device-blocked layout in
format.py: blocked occ checkpoints, base-5 keyed ftab with explicit
top/bot arrays (replacing the reference's eftab boundary patching), and
text-position SA sampling for bounded walks.
"""

from __future__ import annotations

import numpy as np

from ..utils import dna
from ..utils.suffix_array import suffix_array, bwt_from_sa
from .fasta import parse_fasta, join_references
from .format import (
    FMIndex,
    MARK_WORDS_PER_BLOCK,
    OCC_BLOCK,
    WORD_BASES,
    WORDS_PER_BLOCK,
)




def _pack_padded(codes: np.ndarray, total: int) -> np.ndarray:
    """2-bit pack codes, zero-padded to `total` bases."""
    padded = np.zeros(total, dtype=np.int8)
    padded[: len(codes)] = codes
    return dna.pack_2bit(padded)


def _occ_checkpoints(bwt: np.ndarray, nblocks: int) -> np.ndarray:
    """[nblocks,4] counts of each char in bwt[0 : b*OCC_BLOCK) (dummy counted
    as char 0; query-side adjusts for zoff). Vectorized: per-block counts by
    reduceat, then an exclusive prefix sum (genome-scale builds)."""
    padded = np.zeros(nblocks * OCC_BLOCK, dtype=np.int8)
    padded[: len(bwt)] = bwt
    blk = padded.reshape(nblocks, OCC_BLOCK)
    cp = np.zeros((nblocks, 4), dtype=np.int64)
    for c in range(4):
        # bool axis-sum (no int64[n] staging array as reduceat needed)
        per_block = (blk == c).sum(axis=1, dtype=np.int64)
        cp[1:, c] = np.cumsum(per_block)[:-1]
    return cp


def _ftab(text: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """ftab_top/bot[4^k]: SA row range of every k-mer (backward-search seed
    jump, ref: Ebwt::ftab semantics bt2_idx.h:1259, aligner_seed.cpp:757-811).

    Keys are base-5 (sentinel=0, chars 1..4) so suffixes shorter than k sort
    correctly below any full k-mer sharing their prefix; [top, bot) are
    rank counts of each full k-mer key over the key multiset.
    """
    assert k <= 13  # 5**13 < 2**31: keys stay int32
    n = len(text)
    nrows = n + 1
    # per-position keys by rolling Horner over the text (sequential
    # passes; the old per-SA-row [chunk, k] gather + int64 matmul was
    # memory-bound and ~10x slower on this host)
    s5 = np.zeros(n + k, dtype=np.int32)
    np.add(text, 1, out=s5[:n], casting="unsafe")
    acc = np.zeros(nrows, dtype=np.int32)
    if k % 2 == 0:
        # base-25 pairs: half the accumulate passes (5^k < 2^31 bounds acc)
        pair = s5[:-1] * 5
        pair += s5[1:]
        for m in range(k // 2):
            acc *= 25
            acc += pair[2 * m : 2 * m + nrows]
    else:
        for j in range(k):
            acc *= 5
            acc += s5[j : j + nrows]
    # top/bot are rank counts over the key multiset — order-independent,
    # so a histogram over TEXT-order keys replaces the acc[sa] random
    # gather (one miss/row) plus the 4^k searchsorted probes entirely.
    # q5 is strictly increasing in q (base-4 digits map order-preserving
    # to base-5), so one reduceat over interleaved boundaries
    # [0, q5_0, q5_0+1, q5_1, ...] yields alternating gap/exact-bin sums
    # whose running total IS top (keys < q5_i) and bot (<= q5_i) — no
    # serial cumsum over the 5^k-bin histogram (12.9s at k=12 on this
    # host; this path is ~4s).
    hist = np.bincount(acc, minlength=5**k + 1)
    return _ftab_from_hist(hist, k)


def _ftab_from_hist(hist: np.ndarray, k: int):
    """top/bot from the base-5 key histogram (shared by the in-memory
    and blockwise builders — identical output by construction)."""
    nq = 4**k
    q5 = _q5_keys(k)
    idx = np.empty(2 * nq + 1, np.int64)
    idx[0] = 0
    idx[1::2] = q5
    idx[2::2] = q5 + np.int64(1)
    seg = np.add.reduceat(hist, idx)
    # reduceat quirk: an empty segment (idx[i] == idx[i+1]) yields
    # hist[idx[i]] instead of 0
    seg[:-1][idx[1:] == idx[:-1]] = 0
    cs = np.cumsum(seg[:-1])
    top = cs[0::2].astype(np.uint32)
    bot = cs[1::2].astype(np.uint32)
    return top, bot


def _ftab_hist(text: np.ndarray, k: int, chunk: int = 1 << 24):
    """_ftab with bounded memory: the per-suffix base-5 keys histogram
    accumulates chunk-by-chunk (the in-memory path stages two O(n)
    staging arrays — too big under the blockwise build's RAM cap)."""
    from .blockwise import _keys_chunk

    n = len(text)
    hist = np.zeros(5**k + 1, np.int64)
    for lo in range(0, n + 1, chunk):
        hi = min(lo + chunk, n + 1)
        hist[: 5**k] += np.bincount(
            _keys_chunk(text, lo, hi, k), minlength=5**k
        )
    return _ftab_from_hist(hist, k)


_Q5_CACHE: dict = {}


def _q5_keys(k: int) -> np.ndarray:
    """Base-5 key of every full k-mer (digits 1..4 + 1), cached per k."""
    q5 = _Q5_CACHE.get(k)
    if q5 is None:
        q = np.arange(4**k, dtype=np.int64)
        q5 = np.zeros(4**k, dtype=np.int64)
        for j in range(k):
            digit = (q >> (2 * (k - 1 - j))) & 3
            q5 += (digit + 1) * (5 ** (k - 1 - j))
        _Q5_CACHE[k] = q5
    return q5


def build_index_from_text(
    text: np.ndarray,
    refmap,
    ftab_k: int | None = None,
    srate: int = 8,
) -> FMIndex:
    """Build the FM index over a joined ACGT text (codes 0..3).

    ftab_k=None picks automatically: 12 for genomes >= 1 Mbp (the 2x4^12
    x 4B = 134 MB jump table cuts two LF steps off every seed search —
    the device search loop is latency-bound, so steps are wall-clock),
    10 below (tiny test genomes gain nothing from a big table).
    """
    text = np.asarray(text, dtype=np.int8)
    assert text.min(initial=0) >= 0 and text.max(initial=0) < 4
    n = len(text)
    if ftab_k is None:
        ftab_k = 12 if n >= 1_000_000 else 10
    nrows = n + 1
    sa = suffix_array(text)
    bwt, zoff = bwt_from_sa(text, sa)

    nblocks = (nrows + OCC_BLOCK - 1) // OCC_BLOCK
    bwt_words = _pack_padded(bwt, nblocks * OCC_BLOCK)
    occ_cp = _occ_checkpoints(bwt, nblocks)

    # chunked count: np.bincount casts int8 input to int64 whole —
    # a +8n-byte transient (17 GB at 2.3 Gbp, measured)
    cnt = np.zeros(4, np.int64)
    for lo in range(0, n, 1 << 26):
        cnt += np.bincount(text[lo : lo + (1 << 26)], minlength=4)[:4]
    fchr = np.zeros(5, dtype=np.int64)
    fchr[0] = 1  # sentinel occupies row 0..1
    for c in range(1, 5):
        fchr[c] = fchr[c - 1] + cnt[c - 1]
    assert fchr[4] == nrows

    ftab_top, ftab_bot = _ftab(text, ftab_k)

    marked = (sa % srate) == 0
    nmark_words = nblocks * MARK_WORDS_PER_BLOCK
    mark_bits = np.zeros(nmark_words * 32, dtype=bool)
    mark_bits[:nrows] = marked
    # LSB-first bit pack == little-endian packbits viewed as uint32
    mark_words = np.packbits(mark_bits, bitorder="little").view(np.uint32)
    marked_per_block = (
        mark_bits.reshape(nblocks, OCC_BLOCK).sum(axis=1).astype(np.int64)
    )
    mark_cp = np.concatenate([[0], np.cumsum(marked_per_block)[:-1]])
    sa_sample = sa[marked].astype(np.uint32)

    ref_words = dna.pack_2bit(text)

    return FMIndex(
        n=n,
        nrows=nrows,
        zoff=zoff,
        fchr=fchr,
        bwt_words=bwt_words,
        occ_cp=occ_cp,
        ftab_k=ftab_k,
        ftab_top=ftab_top,
        ftab_bot=ftab_bot,
        srate=srate,
        mark_words=mark_words,
        mark_cp=mark_cp,
        sa_sample=sa_sample,
        ref_words=ref_words,
        refmap=refmap,
    )


def build_index(fasta_paths, ftab_k: int | None = None,
                srate: int = 8, bmax: int | None = None,
                bmaxdivn: int | None = None,
                dcv: int | None = None) -> FMIndex:
    """FASTA file(s) -> FMIndex (the bowtie2-build equivalent entry point).

    bmax/bmaxdivn/dcv select the bounded-memory blockwise build
    (index/blockwise.py — byte-identical output, SA streamed in sorted
    buckets of ~bmax suffixes; the --bmax/--bmaxdivn/--dcv capability of
    the reference's KarkkainenBlockwiseSA, blockwise_sa.h:255+). Left
    None, the whole-SA native SA-IS path runs (faster, more RAM)."""
    names, seqs = parse_fasta(fasta_paths)
    joined, refmap = join_references(names, seqs)
    if bmax is not None or bmaxdivn is not None or dcv is not None:
        from .blockwise import build_index_blockwise

        if bmax is None:
            bmax = max(1 << 20, (len(joined) + 1) // (bmaxdivn or 4))
        return build_index_blockwise(
            joined, refmap, ftab_k=ftab_k, srate=srate, bmax=bmax,
            dcv=dcv or 1024,
        )
    return build_index_from_text(joined, refmap, ftab_k=ftab_k, srate=srate)
