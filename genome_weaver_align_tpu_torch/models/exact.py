"""Batched exact-match FM backward search: the torch counterpart of
``genome_weaver_align_tpu.models.exact``.

A (B,) pair of interval tensors advances a fixed number of steps in
lockstep; dead lanes (empty interval) and exhausted lanes (past the read's
first character) are frozen by masking, not branching.  On a CUDA device
the whole loop is one kernel (``csrc/fm_search.cu``, one thread a read).  It is the
single-device reference of ``parallel.sharded_index.
make_sharded_exact_search``; ``best_strand`` is the step of
``models.pipeline.ExactAligner`` and of ``parallel.multihost.exact_align``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import fm_search_cuda, rank
from ..ops.rank import DeviceFMIndex
from ..utils import sam

I32 = torch.int32
NO_HIT = 2**30  # the position of a read found on neither strand


def _trip(L: int, max_len: int | None, kmer_tab, kmer_j: int) -> int:
    """The search loop's trip count: the read length or ``max_len``, less
    the k-mer table's characters when every read that is long enough for
    the table still has its own steps."""
    steps = L if max_len is None else max_len
    if kmer_tab is not None and kmer_j > 0 and steps >= 2 * kmer_j - 1:
        return steps - kmer_j  # reads shorter than kmer_j still need kmer_j - 1 steps
    return steps


def exact_interval_search(
    fm: DeviceFMIndex,
    reads: torch.Tensor,  # (B, L) int32 codes, left-aligned, pad arbitrary
    lengths: torch.Tensor,  # (B,) int32
    max_len: int | None = None,
    kmer_tab: tuple[torch.Tensor, torch.Tensor] | None = None,  # (lo, hi) of size 4^j
    kmer_j: int = 0,
):
    """SA intervals [lo, hi) of each read's exact occurrences; hi <= lo =>
    none.  On a CUDA device the whole loop is one kernel
    (``csrc/fm_search.cu``); on the CPU, ``exact_interval_search_plain``."""
    if not reads.is_cuda:
        return exact_interval_search_plain(fm, reads, lengths, max_len, kmer_tab, kmer_j)
    lo, hi = fm_search_cuda.backward_search_cuda(
        fm, reads.to(I32).contiguous(), lengths.to(I32).contiguous(), 1,
        _trip(reads.shape[1], max_len, kmer_tab, kmer_j), kmer_tab, kmer_j)
    return lo.reshape(-1), hi.reshape(-1)


def exact_interval_search_plain(
    fm: DeviceFMIndex,
    reads: torch.Tensor,
    lengths: torch.Tensor,
    max_len: int | None = None,
    kmer_tab: tuple[torch.Tensor, torch.Tensor] | None = None,
    kmer_j: int = 0,
):
    """The search as a loop of torch ops, one backward step an iteration
    (the kernel's plain version).

    With a k-mer prefix table (``index.kmer``), the last ``kmer_j``
    characters of every read resolve with one table lookup; the backward
    loop then covers only the remaining prefix."""
    B, L = reads.shape
    dev = reads.device
    reads = reads.to(I32)
    lengths = lengths.to(I32)
    trip = _trip(L, max_len, kmer_tab, kmer_j)

    if kmer_tab is not None and kmer_j > 0:
        use_tab = lengths >= kmer_j
        idx = torch.zeros(B, dtype=I32, device=dev)
        for t in range(kmer_j):
            pos = (lengths - kmer_j + t).clamp(0, L - 1)
            idx = (idx << 2) | torch.gather(reads, 1, pos[:, None].long())[:, 0]
        lo = torch.where(use_tab, kmer_tab[0][idx.long()], 0)
        hi = torch.where(use_tab, kmer_tab[1][idx.long()], fm.n + 1)
        skip = torch.where(use_tab, kmer_j, 0)
    else:
        lo = torch.zeros(B, dtype=I32, device=dev)
        hi = torch.full((B,), fm.n + 1, dtype=I32, device=dev)
        skip = torch.zeros(B, dtype=I32, device=dev)

    for t in range(trip):
        j = lengths - 1 - skip - t
        active = (j >= 0) & (lo < hi)
        c = torch.gather(reads, 1, j.clamp(0, L - 1)[:, None].long())[:, 0]
        lo, hi = rank.step_where(active, rank.backward_step(fm, c, lo, hi), (lo, hi))
    return lo.to(I32), hi.to(I32)


def locate_hits(fm: DeviceFMIndex, lo: torch.Tensor, hi: torch.Tensor, max_hits: int):
    """Text positions for up to ``max_hits`` rows of each interval.

    Returns (positions (B, max_hits) int32, -1 where invalid; valid (B,
    max_hits) bool)."""
    rows = lo[:, None] + torch.arange(max_hits, dtype=I32, device=lo.device)[None, :]
    valid = rows < hi[:, None]
    pos = rank.locate(fm, rows.clamp(0, fm.n).reshape(-1)).reshape(rows.shape)
    return torch.where(valid, pos, -1), valid


def best_strand(
    fm: DeviceFMIndex,
    reads: torch.Tensor,  # (B, L) codes
    lengths: torch.Tensor,  # (B,) int32
    max_len: int | None = None,
    kmer_tab: tuple[torch.Tensor, torch.Tensor] | None = None,
    kmer_j: int = 0,
):
    """Both strands of every read searched exactly and the first located
    row of each interval taken; the smaller position wins, the forward
    strand on a tie.  -> (pos, strand, n_hits) (B,) int32: pos is NO_HIT
    where neither strand matches, n_hits the two intervals' widths."""
    rc = torch.where(reads < 4, 3 - reads, reads).flip(1)
    outs = []
    for batch in (reads, rc):
        lo, hi = exact_interval_search(fm, batch.to(I32), lengths, max_len=max_len,
                                       kmer_tab=kmer_tab, kmer_j=kmer_j)
        pos, valid = locate_hits(fm, lo, hi, 1)
        outs.append((torch.where(valid[:, 0], pos[:, 0], NO_HIT), (hi - lo).clamp(min=0)))
    (pf, wf), (pr, wr) = outs
    take_r = pr < pf
    return torch.where(take_r, pr, pf), take_r.to(I32), wf + wr


def sam_records(genome, names, reads: np.ndarray, pos: np.ndarray, strand: np.ndarray):
    """SAM records of exact hits on the host (``best_strand``'s pos and
    strand, gathered): read i mapped at global ``pos[i]`` with an all-match
    CIGAR, or unmapped at NO_HIT."""
    recs = []
    for i, name in enumerate(names):
        codes = reads[i].astype(np.uint8)
        if pos[i] >= NO_HIT:
            recs.append(sam.unmapped(name, codes))
            continue
        ci, local = genome.coord(int(pos[i]))
        recs.append(sam.mapped(name, codes, genome.names[int(ci[0])], int(local[0]),
                               int(strand[i]), f"{codes.size}M", edit_distance=0))
    return recs


def revcomp_batch(reads: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Host-side reverse complement of a left-aligned padded batch."""
    B, L = reads.shape
    out = np.zeros_like(reads)
    for i in range(B):
        l = int(lengths[i])
        out[i, :l] = (3 - reads[i, :l][::-1]) % 4
    return out
