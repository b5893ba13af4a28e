"""Bit vector with O(1) rank via sampled popcounts (SURVEY.md §2 #2).

Host-side twin of the device rank structure.  Layout mirrors the occurrence
table: uint32 words (LSB-first bit order) plus an int32 checkpoint array with
``rank1(i)`` sampled every ``BLOCK_BITS`` positions, so the same arrays upload
directly to HBM for the device-side marked-row test used by sparse-SA locate.
"""

from __future__ import annotations

import numpy as np

from .packing import popcount32

BITS_PER_WORD = 32
BLOCK_BITS = 128  # checkpoint spacing; multiple of 32
WORDS_PER_BLOCK = BLOCK_BITS // BITS_PER_WORD


class BitVector:
    def __init__(self, bits: np.ndarray):
        bits = np.asarray(bits, dtype=bool)
        self.n = bits.size
        nw = (self.n + BITS_PER_WORD - 1) // BITS_PER_WORD
        padded = np.zeros(nw * BITS_PER_WORD, dtype=np.uint32)
        padded[: self.n] = bits
        lanes = padded.reshape(nw, BITS_PER_WORD) << np.arange(
            BITS_PER_WORD, dtype=np.uint32
        )
        self.words = np.bitwise_or.reduce(lanes, axis=1).astype(np.uint32)
        # checkpoints: rank1 at every block boundary, inclusive final entry
        nb = max(1, (nw + WORDS_PER_BLOCK - 1) // WORDS_PER_BLOCK)
        wpad = np.zeros(nb * WORDS_PER_BLOCK, dtype=np.uint32)
        wpad[:nw] = self.words
        per_word = popcount32(wpad)
        per_block = per_word.reshape(nb, WORDS_PER_BLOCK).sum(axis=1)
        self.checkpoints = np.zeros(nb + 1, dtype=np.int64)
        np.cumsum(per_block, out=self.checkpoints[1:])
        self._wpad = wpad  # padded words, device-friendly (nb*WORDS_PER_BLOCK,)

    def get(self, i) -> np.ndarray:
        i = np.asarray(i)
        return ((self.words[i // BITS_PER_WORD] >> (i % BITS_PER_WORD).astype(np.uint32)) & 1).astype(bool)

    def rank1(self, i) -> np.ndarray:
        """#set bits in [0, i); vectorised over i."""
        i = np.atleast_1d(np.asarray(i, dtype=np.int64))
        b = i // BLOCK_BITS
        out = self.checkpoints[b].copy()
        # whole words between block start and i
        w0 = b * WORDS_PER_BLOCK
        wi = i // BITS_PER_WORD
        for off in range(WORDS_PER_BLOCK):
            w = w0 + off
            full = w < wi
            out += np.where(full & (w < self._wpad.size), popcount32(self._wpad[np.minimum(w, self._wpad.size - 1)]), 0)
        rem = (i % BITS_PER_WORD).astype(np.uint32)
        has_partial = (rem > 0) & (wi < self._wpad.size)
        partial_word = self._wpad[np.minimum(wi, self._wpad.size - 1)]
        mask = ((np.uint32(1) << rem) - np.uint32(1)).astype(np.uint32)
        out += np.where(has_partial, popcount32(partial_word & mask), 0)
        return out

    def rank0(self, i):
        i = np.atleast_1d(np.asarray(i, dtype=np.int64))
        return i - self.rank1(i)
