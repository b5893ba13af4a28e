"""2-bit packing of DNA codes into uint32 words (SURVEY.md §2 #1).

Layout: word ``w`` holds bases ``[16w, 16w+16)``; base ``i`` occupies bits
``[2*(i%16), 2*(i%16)+2)`` of its word (LSB-first).  This is the on-device
layout of the BWT and of the packed genome: 16 bases per 32-bit lane, scanned
with XOR/popcount tricks (see ``ops.rank``).  Word-parallel counting here is
the host-side (NumPy) twin of the device kernels and serves as their oracle.
"""

from __future__ import annotations

import numpy as np

BASES_PER_WORD = 16
_SHIFTS = (2 * np.arange(BASES_PER_WORD, dtype=np.uint32)).astype(np.uint32)
PAIR_MASK = np.uint32(0x55555555)


def pack(codes: np.ndarray) -> np.ndarray:
    """uint8 codes (values 0..3) -> uint32 words; tail padded with 0 (A)."""
    codes = np.asarray(codes, dtype=np.uint8)
    if codes.size and codes.max() > 3:
        raise ValueError("pack() requires 2-bit codes; resolve N first")
    n = codes.size
    nw = (n + BASES_PER_WORD - 1) // BASES_PER_WORD
    padded = np.zeros(nw * BASES_PER_WORD, dtype=np.uint32)
    padded[:n] = codes
    lanes = padded.reshape(nw, BASES_PER_WORD) << _SHIFTS[None, :]
    return np.bitwise_or.reduce(lanes, axis=1).astype(np.uint32)


def unpack(words: np.ndarray, n: int) -> np.ndarray:
    """uint32 words -> first ``n`` uint8 codes."""
    words = np.asarray(words, dtype=np.uint32)
    lanes = (words[:, None] >> _SHIFTS[None, :]) & np.uint32(3)
    return lanes.reshape(-1)[:n].astype(np.uint8)


def get(words: np.ndarray, i) -> np.ndarray:
    """Base code(s) at position(s) ``i`` (vectorised)."""
    i = np.asarray(i)
    w = words[i // BASES_PER_WORD]
    return ((w >> (2 * (i % BASES_PER_WORD)).astype(np.uint32)) & 3).astype(np.uint8)


def match_mask_word(words: np.ndarray, code: int) -> np.ndarray:
    """Per-word uint32 with bit ``2r`` set iff base ``r`` equals ``code``."""
    words = np.asarray(words, dtype=np.uint32)
    x = words ^ np.uint32(int(code) * 0x55555555)
    return ~(x | (x >> np.uint32(1))) & PAIR_MASK


def popcount32(x: np.ndarray) -> np.ndarray:
    """Vectorised popcount of uint32 (NumPy host side)."""
    x = np.asarray(x, dtype=np.uint32)
    with np.errstate(over="ignore"):  # wraparound multiply is intended
        x = x - ((x >> np.uint32(1)) & np.uint32(0x55555555))
        x = (x & np.uint32(0x33333333)) + ((x >> np.uint32(2)) & np.uint32(0x33333333))
        x = (x + (x >> np.uint32(4))) & np.uint32(0x0F0F0F0F)
        return ((x * np.uint32(0x01010101)) >> np.uint32(24)).astype(np.int64)


def count_prefix(words: np.ndarray, code: int, k: int) -> int:
    """#occurrences of ``code`` among the first ``k`` packed bases."""
    k = int(k)
    nfull = k // BASES_PER_WORD
    rem = k % BASES_PER_WORD
    m = match_mask_word(words[: nfull + (1 if rem else 0)], code)
    total = int(popcount32(m[:nfull]).sum()) if nfull else 0
    if rem:
        tail_mask = np.uint32((1 << (2 * rem)) - 1)
        total += int(popcount32(m[nfull] & tail_mask))
    return total
