"""Batched exact-match FM backward search: the torch counterpart of
``genome_weaver_align_tpu.models.exact``.

A (B,) pair of interval tensors advances a fixed number of steps in
lockstep; dead lanes (empty interval) and exhausted lanes (past the read's
first character) are frozen by masking, not branching.  It is the
single-device reference of ``parallel.sharded_index.
make_sharded_exact_search``.  ``ExactAligner`` and the CLI's ``-k 0`` are not
ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import rank
from ..ops.rank import DeviceFMIndex

I32 = torch.int32


def exact_interval_search(
    fm: DeviceFMIndex,
    reads: torch.Tensor,  # (B, L) int32 codes, left-aligned, pad arbitrary
    lengths: torch.Tensor,  # (B,) int32
    max_len: int | None = None,
    kmer_tab: tuple[torch.Tensor, torch.Tensor] | None = None,  # (lo, hi) of size 4^j
    kmer_j: int = 0,
):
    """SA intervals [lo, hi) of each read's exact occurrences; hi <= lo =>
    none.

    With a k-mer prefix table (``index.kmer``), the last ``kmer_j``
    characters of every read resolve with one table lookup; the backward
    loop then covers only the remaining prefix."""
    B, L = reads.shape
    dev = reads.device
    reads = reads.to(I32)
    lengths = lengths.to(I32)
    steps = L if max_len is None else max_len

    if kmer_tab is not None and kmer_j > 0:
        use_tab = lengths >= kmer_j
        idx = torch.zeros(B, dtype=I32, device=dev)
        for t in range(kmer_j):
            pos = (lengths - kmer_j + t).clamp(0, L - 1)
            idx = (idx << 2) | torch.gather(reads, 1, pos[:, None].long())[:, 0]
        lo = torch.where(use_tab, kmer_tab[0][idx.long()], 0)
        hi = torch.where(use_tab, kmer_tab[1][idx.long()], fm.n + 1)
        skip = torch.where(use_tab, kmer_j, 0)
        # reads shorter than kmer_j still need up to kmer_j - 1 steps
        trip = steps - kmer_j if steps >= 2 * kmer_j - 1 else steps
    else:
        lo = torch.zeros(B, dtype=I32, device=dev)
        hi = torch.full((B,), fm.n + 1, dtype=I32, device=dev)
        skip = torch.zeros(B, dtype=I32, device=dev)
        trip = steps

    for t in range(trip):
        j = lengths - 1 - skip - t
        active = (j >= 0) & (lo < hi)
        c = torch.gather(reads, 1, j.clamp(0, L - 1)[:, None].long())[:, 0]
        nlo, nhi = rank.backward_step(fm, c, lo, hi)
        lo, hi = torch.where(active, nlo, lo), torch.where(active, nhi, hi)
    return lo.to(I32), hi.to(I32)


def locate_hits(fm: DeviceFMIndex, lo: torch.Tensor, hi: torch.Tensor, max_hits: int):
    """Text positions for up to ``max_hits`` rows of each interval.

    Returns (positions (B, max_hits) int32, -1 where invalid; valid (B,
    max_hits) bool)."""
    rows = lo[:, None] + torch.arange(max_hits, dtype=I32, device=lo.device)[None, :]
    valid = rows < hi[:, None]
    pos = rank.locate(fm, rows.clamp(0, fm.n).reshape(-1)).reshape(rows.shape)
    return torch.where(valid, pos, -1), valid


def revcomp_batch(reads: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Host-side reverse complement of a left-aligned padded batch."""
    B, L = reads.shape
    out = np.zeros_like(reads)
    for i in range(B):
        l = int(lengths[i])
        out[i, :l] = (3 - reads[i, :l][::-1]) % 4
    return out
