"""Suffix-array construction on the device by prefix doubling: the torch
counterpart of ``genome_weaver_align_tpu.index.device_build``.

Manber-Myers prefix doubling is two stable argsorts and a segmented rank
assignment a round, O(log n) rounds, all of them parallel primitives.  The
host SA-IS (``index.native``) does O(n) work against this O(n log^2 n);
the device build's use is to leave the host free while an index is built.

Ranks are int32, as in the JAX package, so one text holds at most
2^31 - 2 bases; whole genomes are built in parts (``index.multipart_io``).
"""

from __future__ import annotations

import numpy as np
import torch

I32 = torch.int32


def _lexsort_pairs(primary: torch.Tensor, secondary: torch.Tensor) -> torch.Tensor:
    """argsort by (primary, secondary) via two stable sorts."""
    o1 = torch.argsort(secondary, stable=True)
    o2 = torch.argsort(primary[o1], stable=True)
    return o1[o2]


def _doubling_round(k: int, rank: torch.Tensor):
    """Sort by (rank[i], rank[i + k]) and rank the pairs densely:
    (order, new rank)."""
    N = rank.shape[0]
    idx = torch.arange(N, dtype=I32, device=rank.device) + k
    key2 = torch.where(idx < N, rank[idx.clamp(0, N - 1).long()], -1)
    order = _lexsort_pairs(rank, key2)
    r1, r2 = rank[order], key2[order]
    diff = torch.ones(N, dtype=I32, device=rank.device)
    diff[1:] = ((r1[1:] != r1[:-1]) | (r2[1:] != r2[:-1])).to(I32)
    new_sorted = (torch.cumsum(diff, 0) - 1).to(I32)  # cumsum of int32 is int64
    new_rank = torch.empty_like(rank)
    new_rank[order] = new_sorted
    return order, new_rank


def suffix_array_device(codes: np.ndarray, device="cuda") -> np.ndarray:
    """SA of codes+$ computed on ``device``; int64 positions.

    The loop runs on the host and stops once every rank is distinct (the
    last sorted suffix has rank N - 1): one device read a round.  It always
    runs at least one round: the JAX build also stops before any round when
    the initial code ranks reach N - 1, which texts of at most 4 bases can
    do with ties left, and then returns an unsorted order."""
    codes = np.asarray(codes, dtype=np.uint8)
    n = codes.size
    if n + 1 > np.iinfo(np.int32).max:
        raise ValueError("text too large for int32 device build; split it")
    rank0 = np.zeros(n + 1, dtype=np.int32)
    rank0[:n] = codes.astype(np.int32) + 1
    rank = torch.from_numpy(rank0).to(device)
    N = n + 1
    k = 1
    while True:
        order, rank = _doubling_round(k, rank)
        if int(rank[order[-1]]) == N - 1:
            break
        k *= 2
    return order.cpu().numpy().astype(np.int64)
