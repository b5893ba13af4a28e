"""k-mer prefix interval table: precomputed SA intervals for all 4^j j-mers.

Backward search of a read's last j characters is the same for every read
sharing that suffix; the table turns those j interval-update steps (2j
gather-rounds on the occ table) into ONE 8-byte lookup.  Standard FM-index
acceleration; sized j=10..13 (8 MB .. 512 MB HBM at 2 int32/entry).

Built host-side by batched backward extension over all patterns level by
level (vectorised NumPy over the whole 4^j table at once).
"""

from __future__ import annotations

import numpy as np

from .build import FMIndexData


def build_kmer_table(fm: FMIndexData, j: int) -> tuple[np.ndarray, np.ndarray]:
    """-> (lo, hi) int32 arrays of size 4^j.

    Index encoding: pattern p[0..j) (p[0] = leftmost char) maps to
    sum(p[t] << 2*(j-1-t)) — i.e. big-endian base-4, so extending a pattern
    on the LEFT prepends high bits: idx' = c << 2*(j-1) | idx.
    """
    lo = np.zeros(1, dtype=np.int64)
    hi = np.full(1, fm.n + 1, dtype=np.int64)
    for level in range(j):
        # prepend each code c to every current pattern
        size = lo.size
        nlo = np.empty(4 * size, dtype=np.int64)
        nhi = np.empty(4 * size, dtype=np.int64)
        for c in range(4):
            # alive intervals only (dead stay dead: occ(lo)==occ(hi))
            nlo[c * size : (c + 1) * size] = fm.C[c] + fm.occ(c, lo)
            nhi[c * size : (c + 1) * size] = fm.C[c] + fm.occ(c, hi)
        lo, hi = nlo, nhi
    # layout check: after j levels, index bits are (c_0 c_1 ... c_{j-1}) with
    # c_0 (the leftmost/last-prepended char) in the HIGH bits — matching the
    # encoding in the docstring.
    return lo.astype(np.int32), np.maximum(hi, lo).astype(np.int32)


def kmer_index_of(reads: np.ndarray, lengths: np.ndarray, j: int) -> np.ndarray:
    """Host helper (oracle/tests): table index of each read's last j chars."""
    B, L = reads.shape
    idx = np.zeros(B, dtype=np.int64)
    for t in range(j):
        pos = lengths - j + t
        idx = (idx << 2) | reads[np.arange(B), pos]
    return idx
