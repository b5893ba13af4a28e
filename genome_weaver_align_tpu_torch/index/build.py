"""FM-index construction and the host-side (NumPy) oracle FM-index.

Covers SURVEY.md §2 #5 (BWT build pipeline, reference `BWTransform`/`BWTFiles`),
#6 (occurrence table, reference `OccurrenceCountTable`/`CharacterCount`),
#7 (sparse suffix array, reference `SparseSuffixArray`) and the host half of
#8 (FM-index facade, reference `FMIndex`).

Conventions (shared bit-for-bit with the device kernels in ``ops.rank``):

- Text ``T`` (2-bit codes, length ``n``) is indexed as ``T$`` with the
  sentinel strictly smallest.  SA has length ``n+1``; ``SA[0] == n``.
- The BWT row holding ``$`` (``primary``, i.e. the row with ``SA==0``) is
  *dropped* from the packed BWT; rank queries shift their argument across it:
  ``occ$(c, k) = occ_packed(c, k - (k > primary))``.  This keeps the packed
  array strictly 2-bit (the BWA trick).
- ``C[c] = 1 + #{b < c in T}`` (the ``1`` accounts for ``$``); backward step:
  ``lo' = C[c] + occ$(c, lo)``, ``hi' = C[c] + occ$(c, hi)``.
- Occurrence checkpoints every ``BLOCK_BASES`` BWT positions; between
  checkpoints, XOR/popcount scan over uint32 words (16 bases each).
- Sparse SA: rows with ``SA % sample_rate == 0`` are marked in a rank-enabled
  bit vector; values stored compacted in row order.  Locate walks LF at most
  ``sample_rate - 1`` times — a *bounded* loop, chosen so the device locate
  can be a fixed-trip-count ``lax.fori_loop``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from genome_weaver_align_tpu.utils import packing
from genome_weaver_align_tpu.utils.bitvector import BitVector
from genome_weaver_align_tpu.utils.packing import (
    BASES_PER_WORD,
    match_mask_word,
    popcount32,
)
from .sais import suffix_array

BLOCK_BASES = 128
WORDS_PER_BLOCK = BLOCK_BASES // BASES_PER_WORD


def _pair_mask(allowed: np.ndarray) -> np.ndarray:
    """uint32 mask covering the first ``allowed`` (0..16) base slots."""
    a = np.asarray(allowed, dtype=np.int64)
    return ((np.int64(1) << (2 * a)) - 1).astype(np.uint32)


@dataclass
class FMIndexData:
    """Host-resident FM-index; arrays are laid out ready for device upload."""

    n: int
    primary: int
    counts: np.ndarray  # (4,) int64
    C: np.ndarray  # (5,) int64; C[4] = n+1 sentinel-inclusive total
    bwt_words: np.ndarray  # ((nb+1)*WORDS_PER_BLOCK,) uint32, zero-padded
    occ_cp: np.ndarray  # (nb+1, 4) int64
    sample_rate: int
    ssa_marks: BitVector  # over n+1 BWT rows
    ssa_values: np.ndarray  # int64, sampled SA values in row order
    text_words: np.ndarray  # packed text (window extraction for DP verify)
    full_sa: np.ndarray | None = None  # optional (n+1,) int32 full SA —
    # locate becomes ONE gather (memory-for-bandwidth HBM trade, SURVEY.md §7)

    # ---------------- rank / occ ----------------

    def occ_packed(self, c: int, k) -> np.ndarray:
        """#occurrences of code c in packed BWT[0, k); vectorised over k."""
        k = np.atleast_1d(np.asarray(k, dtype=np.int64))
        b = k // BLOCK_BASES
        out = self.occ_cp[b, c].copy()
        r = k - b * BLOCK_BASES
        for j in range(WORDS_PER_BLOCK):
            w = self.bwt_words[b * WORDS_PER_BLOCK + j]
            m = match_mask_word(w, c)
            allowed = np.clip(r - BASES_PER_WORD * j, 0, BASES_PER_WORD)
            out += popcount32(m & _pair_mask(allowed))
        return out

    def occ(self, c: int, k) -> np.ndarray:
        """occ over the sentinel-inclusive BWT coordinate system [0, n+1]."""
        k = np.atleast_1d(np.asarray(k, dtype=np.int64))
        return self.occ_packed(c, k - (k > self.primary))

    # ---------------- search ----------------

    def backward_search(self, pattern: np.ndarray) -> tuple[int, int]:
        """SA interval [lo, hi) of exact occurrences of ``pattern``."""
        lo, hi = 0, self.n + 1
        for c in np.asarray(pattern, dtype=np.uint8)[::-1]:
            lo = int(self.C[c] + self.occ(int(c), lo)[0])
            hi = int(self.C[c] + self.occ(int(c), hi)[0])
            if lo >= hi:
                return lo, lo
        return lo, hi

    def bwt_char(self, i) -> np.ndarray:
        """BWT char of row(s) i (must not be the primary row)."""
        i = np.atleast_1d(np.asarray(i, dtype=np.int64))
        return packing.get(self.bwt_words, i - (i > self.primary))

    def lf(self, i) -> np.ndarray:
        c = self.bwt_char(i)
        out = np.empty(c.shape, dtype=np.int64)
        for code in range(4):
            sel = c == code
            if sel.any():
                out[sel] = self.C[code] + self.occ(code, np.asarray(i)[sel])
        return out

    def locate(self, i) -> np.ndarray:
        """Text position(s) of BWT row(s) i via bounded LF walk."""
        i = np.atleast_1d(np.asarray(i, dtype=np.int64)).copy()
        d = np.zeros_like(i)
        for _ in range(self.sample_rate):
            unmarked = ~self.ssa_marks.get(i)
            if not unmarked.any():
                break
            i[unmarked] = self.lf(i[unmarked])
            d[unmarked] += 1
        slot = self.ssa_marks.rank1(i)
        return self.ssa_values[slot] + d

    def extract(self, start: int, length: int) -> np.ndarray:
        """Text codes in [start, start+length) (clipped to the text)."""
        start = max(0, int(start))
        end = min(self.n, start + int(length))
        if end <= start:
            return np.zeros(0, dtype=np.uint8)
        w0, w1 = start // packing.BASES_PER_WORD, (end - 1) // packing.BASES_PER_WORD + 1
        span = packing.unpack(self.text_words[w0:w1], (w1 - w0) * packing.BASES_PER_WORD)
        off = start - w0 * packing.BASES_PER_WORD
        return span[off : off + (end - start)]


def build_fm_index(
    codes: np.ndarray,
    sample_rate: int = 32,
    sa: np.ndarray | None = None,
    keep_full_sa: bool = False,
) -> FMIndexData:
    codes = np.asarray(codes, dtype=np.uint8)
    n = codes.size
    if sa is None:
        from .native import suffix_array_best

        sa = suffix_array_best(codes)
    sa = np.asarray(sa, dtype=np.int64)
    assert sa.size == n + 1 and sa[0] == n
    primary = int(np.nonzero(sa == 0)[0][0])

    bwt_rows = np.delete(sa, primary) - 1  # all remaining rows have SA > 0
    bwt_codes = codes[bwt_rows]
    nb = (n + BLOCK_BASES - 1) // BLOCK_BASES
    bwt_words = np.zeros((nb + 1) * WORDS_PER_BLOCK, dtype=np.uint32)
    packed = packing.pack(bwt_codes)
    bwt_words[: packed.size] = packed

    # occurrence checkpoints (occ_packed at every block boundary)
    per_word = np.zeros(((nb + 1) * WORDS_PER_BLOCK, 4), dtype=np.int64)
    for c in range(4):
        per_word[:, c] = popcount32(match_mask_word(bwt_words, c))
    # NOTE: padding bases are code 0 (A) and inflate the last partial block's
    # count, but occ_cp[nb] is only ever consulted when n % BLOCK_BASES == 0
    # (otherwise k <= n lands in block nb-1 with a partial mask that excludes
    # the pad), so every checkpoint actually read is pad-free.
    per_block = per_word.reshape(nb + 1, WORDS_PER_BLOCK, 4).sum(axis=1)
    occ_cp = np.zeros((nb + 1, 4), dtype=np.int64)
    np.cumsum(per_block[:-1], axis=0, out=occ_cp[1:])

    counts = np.bincount(codes, minlength=4).astype(np.int64)
    C = np.zeros(5, dtype=np.int64)
    C[1:] = np.cumsum(counts)
    C += 1  # sentinel

    marked = (sa % sample_rate) == 0
    ssa_marks = BitVector(marked)
    ssa_values = sa[marked].astype(np.int64)

    full_sa = None
    if keep_full_sa:
        assert n + 1 < 2**31, "full SA requires int32 rows; use multi-part index"
        full_sa = sa.astype(np.int32)

    return FMIndexData(
        n=n,
        primary=primary,
        counts=counts,
        C=C,
        bwt_words=bwt_words,
        occ_cp=occ_cp,
        sample_rate=sample_rate,
        ssa_marks=ssa_marks,
        ssa_values=ssa_values,
        text_words=packing.pack(codes),
        full_sa=full_sa,
    )
