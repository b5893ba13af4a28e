"""CSR j-mer position table: k-mer -> sorted genome positions, one gather.

The suffix-filter candidate generator (SURVEY.md §2 #10) only needs, per
piece, the genome positions where the piece occurs.  The FM path answers
that with ~2 rank gathers per character plus an LF-walk locate; this table
answers it with TWO gathers total (offsets row + a positions slice), because
pigeonhole completeness survives weakening "whole piece exact" to "the
piece's last j characters exact" — an exact piece implies its last j-mer is
exact, so seeding on j-mers proposes a superset of the exact-piece diagonals
(false extras are killed by the DP verify, reference `SuffixFilter` ->
`BitParallelSmithWaterman` flow).

Layout (HBM-resident, SURVEY.md §7 memory-for-bandwidth stance):
- ``offsets``: (4^j + 1,) int32 — CSR bucket starts (cumulative counts).
- ``positions``: (n - j + 1,) int32 — genome positions grouped by k-mer,
  ascending within each bucket (deterministic candidate order).

j is chosen so E[occurrences per j-mer] = n / 4^j stays ~1 (j=13 covers
chr20/chr1 scale); buckets wider than ``max_hits`` overflow-flag the read,
same contract as the FM path.
"""

from __future__ import annotations

import numpy as np


def rolling_kmers(codes: np.ndarray, j: int) -> np.ndarray:
    """Big-endian base-4 value of codes[i : i+j] for every window start i.

    Matches the k-mer interval-table encoding (index.kmer): leftmost
    character in the high bits.
    """
    codes = np.asarray(codes, dtype=np.int64)
    n = codes.size
    assert n >= j
    kv = np.zeros(n - j + 1, dtype=np.int64)
    for t in range(j):
        kv = (kv << 2) | codes[t : n - j + 1 + t]
    return kv


def build_seed_table(codes: np.ndarray, j: int) -> tuple[np.ndarray, np.ndarray]:
    """-> (offsets (4^j+1,) int32, positions (n-j+1,) int32).

    Dispatches to the native C++ counting sort (two O(n) passes,
    native/seedtable.cpp) when the shared library builds; the NumPy argsort
    below is the oracle twin and the fallback."""
    assert 2 * j < 63
    from . import native

    if native.available() and codes.size < 2**31:
        return native.seed_table_native(codes, j)
    return build_seed_table_numpy(codes, j)


def build_seed_table_numpy(codes: np.ndarray, j: int) -> tuple[np.ndarray, np.ndarray]:
    """NumPy oracle/fallback builder (stable argsort over rolling j-mers)."""
    kv = rolling_kmers(codes, j)
    order = np.argsort(kv, kind="stable")  # groups by kmer, position-ascending
    counts = np.bincount(kv, minlength=4**j)
    offsets = np.zeros(4**j + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    assert offsets[-1] == kv.size
    assert offsets[-1] < 2**31 and codes.size < 2**31
    return offsets.astype(np.int32), order.astype(np.int32)


def save_seed_table(path, offsets: np.ndarray, positions: np.ndarray, j: int) -> None:
    np.savez(path, offsets=offsets, positions=positions, j=np.int64(j))


def load_seed_table(path) -> tuple[np.ndarray, np.ndarray, int]:
    z = np.load(path)
    return z["offsets"], z["positions"], int(z["j"])
