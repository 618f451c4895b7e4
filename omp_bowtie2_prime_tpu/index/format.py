"""FM-index containers: host (numpy) and device (jnp pytree) layouts.

Device layout (not the reference's 48*OFF_SIZE-byte "sides",
bt2_idx.h:112-279): the BWT is 2-bit packed into uint32 words grouped in
blocks with absolute occ checkpoints per block, so a rank query is one
block-row gather + masked popcounts with no horizontal dependencies.

SA sampling is by TEXT position (every row whose SA value % srate == 0 is
marked in a bitmap with its own rank checkpoints). Unlike the reference's
row-index sampling (bt2_idx.h offs[]), this bounds every group-walk to
srate-1 LF steps, which is what makes a fixed-shape device walk kernel
possible (ref behavior: Ebwt::getOffset, bt2_idx.cpp:149-171 walks an
unbounded number of steps).
"""

from __future__ import annotations

import dataclasses
import pickle

import jax
import numpy as np

OCC_BLOCK = 128  # BWT rows per occ checkpoint block (HOST format)
WORD_BASES = 16  # 2-bit bases per uint32 word
WORDS_PER_BLOCK = OCC_BLOCK // WORD_BASES  # 8
MARK_WORDS_PER_BLOCK = OCC_BLOCK // 32  # 4

# Host-format interleaved block record (kept for .npz compatibility and
# host-side tooling; the DEVICE layout below is wider).
BLK_BWT = 0  # [0:8)  2-bit BWT words
BLK_OCC = WORDS_PER_BLOCK  # [8:12) absolute occ counts at block start
BLK_MARK = BLK_OCC + 4  # [12:16) SA-mark bitmap words
BLK_MARKCP = BLK_MARK + MARK_WORDS_PER_BLOCK  # [16] marked-row rank at start
BLOCK_U32 = BLK_MARKCP + 1  # 17

# DEVICE block record: one 128-word uint32 row (512 B) per 1024 BWT rows,
# so every rank / LF / group-walk step is ONE row gather at 0.5 B per BWT
# row — the analog of the reference sizing its "sides" to cache lines
# (EbwtParams, bt2_idx.h:112-279).  The 128-lane width was chosen for the
# gather unit of the original accelerator; on a GPU a step reads four 128 B
# lines, and whether a narrower record is faster is unmeasured.
DEV_OCC_BLOCK = 1024  # BWT rows per device block record
DEV_BWT_WORDS = DEV_OCC_BLOCK // WORD_BASES  # 64
DEV_MARK_WORDS = DEV_OCC_BLOCK // 32  # 32
DEV_BWT = 0  # [0:64)   2-bit BWT words
DEV_OCC = DEV_BWT_WORDS  # [64:68)  absolute occ counts at block start
DEV_MARK = DEV_OCC + 4  # [68:100) SA-mark bitmap words
DEV_MARKCP = DEV_MARK + DEV_MARK_WORDS  # [100] marked-row rank at start
DEV_BLOCK_U32 = 128  # padded to one full tile row
# ftab: top/bot interleaved per 128-lane row — row q//64 holds top(q) at
# lane q%64 and bot(q) at lane 64 + q%64 (one gather serves both)
DEV_FTAB_PER_ROW = 64
# SA sample: plain [ceil(nmark/128), 128] uint32 rows
DEV_SA_PER_ROW = 128


@dataclasses.dataclass
class FMIndex:
    """Host-side FM index (numpy arrays)."""

    n: int  # joined text length
    nrows: int  # n + 1 (includes sentinel row)
    zoff: int  # row where SA == 0 (dummy BWT char stored there)
    fchr: np.ndarray  # [5] int64: C array; row range of char c is [fchr[c], fchr[c+1])
    bwt_words: np.ndarray  # [nblocks * WORDS_PER_BLOCK] uint32
    occ_cp: np.ndarray  # [nblocks, 4] int64 abs counts at block start
    ftab_k: int
    ftab_top: np.ndarray  # [4^k] uint32
    ftab_bot: np.ndarray  # [4^k] uint32
    srate: int  # SA sample rate (text positions)
    mark_words: np.ndarray  # [nblocks * MARK_WORDS_PER_BLOCK] uint32 bitmap
    mark_cp: np.ndarray  # [nblocks] int64 marked-row count before block
    sa_sample: np.ndarray  # [nmarked] uint32: SA values of marked rows, row order
    ref_words: np.ndarray  # joined text 2-bit packed, uint32
    refmap: object  # ReferenceMap (host only)

    @property
    def nblocks(self) -> int:
        return self.occ_cp.shape[0]

    def save(self, path: str) -> None:
        arrs = {
            f.name: getattr(self, f.name)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), np.ndarray)
        }
        scalars = {
            f.name: getattr(self, f.name)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), int)
        }
        np.savez_compressed(
            path,
            __scalars__=np.frombuffer(pickle.dumps(scalars), dtype=np.uint8),
            __refmap__=np.frombuffer(pickle.dumps(self.refmap), dtype=np.uint8),
            **arrs,
        )

    @classmethod
    def load(cls, path: str) -> "FMIndex":
        z = np.load(path, allow_pickle=False)
        scalars = pickle.loads(z["__scalars__"].tobytes())
        refmap = pickle.loads(z["__refmap__"].tobytes())
        arrs = {k: z[k] for k in z.files if not k.startswith("__")}
        return cls(refmap=refmap, **scalars, **arrs)

    def subsample_sa(self, new_srate: int) -> "FMIndex":
        """Load-time offrate override (-o at align time,
        bt2_io.cpp:220-235): keep only the SA samples at text positions
        = 0 mod new_srate. Sparser resident sample, walks bounded by
        new_srate instead of srate."""
        if new_srate <= self.srate:
            return self
        if new_srate % self.srate:
            raise SystemExit(
                "error: -o override must be a multiple of the built "
                f"SA rate ({self.srate})"
            )
        keep = (self.sa_sample.astype(np.int64) % new_srate) == 0
        bits = np.unpackbits(
            self.mark_words.view(np.uint8), bitorder="little"
        )
        pos = np.flatnonzero(bits)  # marked rows, row order
        bits[pos[~keep]] = 0
        mark_words = np.packbits(bits, bitorder="little").view(np.uint32)
        per_block = bits.reshape(self.nblocks, OCC_BLOCK).sum(axis=1)
        mark_cp = np.concatenate(
            [[0], np.cumsum(per_block, dtype=np.int64)[:-1]]
        )
        return dataclasses.replace(
            self, srate=new_srate, mark_words=mark_words,
            mark_cp=mark_cp, sa_sample=self.sa_sample[keep],
        )


def _static(default):
    """A DeviceIndex field that is pytree metadata: part of the jit cache
    key, never traced."""
    return dataclasses.field(default=default, metadata={"static": True})


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DeviceIndex:
    """Device-resident FM index (a jax pytree of arrays).

    Row indices are int32 for genomes under 2^31-2 rows and int64 above
    (the .bt2/.bt2l split, bt2_idx.cpp:29-37) — GRCh38-scale genomes use
    the 64-bit path automatically.
    """

    blocks: object  # [nblocks, DEV_BLOCK_U32] uint32 1024-row tile records
    fchr: object  # [5] row dtype (int32, or int64 for >2^31-row genomes)
    # big lookup tables are stored as 128-lane uint32 rows and
    # compare-selected down to the wanted lane (see DEV_* layout notes)
    ftab: object  # [ceil(4^k/64), 128] uint32: top | bot interleaved
    sa_sample: object  # [ceil(nmarked/128), 128] uint32
    ref_words: object  # [nrefwords] uint32
    zoff: object  # [] int32
    nrows: object  # [] int32
    ftab_k: int = _static(10)
    srate: int = _static(16)
    # tensor-parallel descriptor (axis_name, nblocks_local, nsa_local),
    # set by parallel/tp_index.shard_index when blocks/sa_sample are
    # sharded row-wise across a mesh axis; None = replicated index
    tp: object = _static(None)

    @classmethod
    def from_host(cls, fm: FMIndex) -> "DeviceIndex":
        """Row indices are int32 up to 2^31-2 rows and int64 beyond (the
        .bt2 vs .bt2l split, bt2_idx.cpp:29-37); block-internal occ/mark
        checkpoints stay uint32 (valid to 2^32 rows — the same GRCh38-scale
        envelope the reference's 64-bit build covers with wider sides)."""
        import os

        import jax.numpy as jnp

        assert fm.nrows < (1 << 32), "block checkpoints are uint32"
        large = fm.nrows >= (1 << 31) - 2 or os.environ.get(
            "BT2TPU_FORCE_LARGE"
        ) == "1"
        if large:
            # int64 device arithmetic requires x64 (off by default in jax)
            jax.config.update("jax_enable_x64", True)
        rowdt = jnp.int64 if large else jnp.int32
        # re-aggregate the host's 128-row blocks into 1024-row device
        # tile records (8 host blocks per device block; checkpoints at
        # the device block start are the host cp of its first sub-block)
        nbh = fm.nblocks
        nbd = (nbh + 7) // 8
        blocks = np.zeros((nbd, DEV_BLOCK_U32), dtype=np.uint32)
        bw = np.zeros(nbd * DEV_BWT_WORDS, np.uint32)
        bw[: nbh * WORDS_PER_BLOCK] = fm.bwt_words
        blocks[:, DEV_BWT : DEV_BWT + DEV_BWT_WORDS] = bw.reshape(
            nbd, DEV_BWT_WORDS
        )
        blocks[:, DEV_OCC : DEV_OCC + 4] = fm.occ_cp[::8].astype(np.uint32)
        mw = np.zeros(nbd * DEV_MARK_WORDS, np.uint32)
        mw[: nbh * MARK_WORDS_PER_BLOCK] = fm.mark_words
        blocks[:, DEV_MARK : DEV_MARK + DEV_MARK_WORDS] = mw.reshape(
            nbd, DEV_MARK_WORDS
        )
        blocks[:, DEV_MARKCP] = fm.mark_cp[::8].astype(np.uint32)

        import numpy as _np

        def wide128(a):
            n = (len(a) + DEV_SA_PER_ROW - 1) // DEV_SA_PER_ROW
            out = _np.zeros(n * DEV_SA_PER_ROW, _np.uint32)
            out[: len(a)] = a
            return out.reshape(-1, DEV_SA_PER_ROW)

        F = len(fm.ftab_top)
        nfr = (F + DEV_FTAB_PER_ROW - 1) // DEV_FTAB_PER_ROW
        ftab = _np.zeros((nfr, DEV_BLOCK_U32), _np.uint32)
        top = _np.zeros(nfr * DEV_FTAB_PER_ROW, _np.uint32)
        top[:F] = fm.ftab_top
        bot = _np.zeros(nfr * DEV_FTAB_PER_ROW, _np.uint32)
        bot[:F] = fm.ftab_bot
        ftab[:, :DEV_FTAB_PER_ROW] = top.reshape(nfr, DEV_FTAB_PER_ROW)
        ftab[:, DEV_FTAB_PER_ROW:] = bot.reshape(nfr, DEV_FTAB_PER_ROW)

        return cls(
            blocks=jnp.asarray(blocks),
            fchr=jnp.asarray(fm.fchr, dtype=rowdt),
            ftab=jnp.asarray(ftab),
            sa_sample=jnp.asarray(wide128(fm.sa_sample)),
            # +128 zero words of tail padding so the DP window gather's
            # per-row word slices (ops/sw.py gather_ref_windows) never
            # clamp backward at the text end
            ref_words=jnp.asarray(
                _np.concatenate(
                    [fm.ref_words.astype(_np.uint32),
                     _np.zeros(128, _np.uint32)]
                )
            ),
            zoff=jnp.asarray(fm.zoff, dtype=rowdt),
            nrows=jnp.asarray(fm.nrows, dtype=rowdt),
            ftab_k=fm.ftab_k,
            srate=fm.srate,
        )
