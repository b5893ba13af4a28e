"""Wavelet-matrix rank over the BWT: the torch counterpart of
``genome_weaver_align_tpu.index.wavelet`` (the reference's ``WaveletArray``
alternative to the sampled occurrence table, SURVEY.md §2 #6).

For the 4-letter DNA alphabet the wavelet matrix is two bit-vector levels:
level 0 stores each symbol's high bit; level 1 stores the low bit after a
stable partition by the high bit.  ``rank(c, i)`` is two bit-vector rank
queries per level.

It is the space-lean backend (2n bits + rank samples, ~0.31 n bytes
against 0.375 n for the fused occ rows of ``ops.rank``) but costs 4
dependent lookups a query where the fused rows cost one row gather, so the
fused rows stay the aligners' backend.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops import rank as rank_ops
from ..utils.bitvector import BLOCK_BITS, WORDS_PER_BLOCK, BitVector

I32 = torch.int32


class WaveletRank:
    """occ(c, i) over a 2-bit symbol sequence via a 2-level wavelet matrix."""

    def __init__(self, codes: np.ndarray):
        codes = np.asarray(codes, dtype=np.uint8)
        self.n = codes.size
        hi = (codes >> 1) & 1
        self.l0 = BitVector(hi.astype(bool))
        self.z0 = int((hi == 0).sum())  # symbols with high bit 0
        # stable partition by high bit, then low bits
        order = np.argsort(hi, kind="stable")
        lo_bits = (codes[order] & 1).astype(bool)
        self.l1 = BitVector(lo_bits)
        # zeros (low bit 0) inside each partition, for per-partition rank
        self.z1_left = int((~lo_bits[: self.z0]).sum())

    def rank(self, c: int, i) -> np.ndarray:
        """#occurrences of code c in codes[0, i); vectorised over i."""
        i = np.atleast_1d(np.asarray(i, dtype=np.int64))
        b0 = (c >> 1) & 1
        b1 = c & 1
        # step into level 1: position inside the b0 partition
        r1 = self.l0.rank1(i)
        i1 = (i - r1) if b0 == 0 else r1
        base = 0 if b0 == 0 else self.z0
        lo_rank = self.l1.rank1(base + i1) - self.l1.rank1(np.full_like(i1, base))
        if b1 == 1:
            return lo_rank
        return i1 - lo_rank

    def device_arrays(self):
        """Bit-vector words + checkpoints, ready for a device twin."""
        return {
            "l0_words": self.l0._wpad,
            "l0_cp": self.l0.checkpoints,
            "l1_words": self.l1._wpad,
            "l1_cp": self.l1.checkpoints,
            "z0": self.z0,
        }


@dataclass(frozen=True)
class DeviceWaveletRank:
    """``WaveletRank`` on the device: occ(c, i) with two sampled-popcount
    bit-vector ranks a level."""

    l0_words: torch.Tensor  # (nb0 * 4,) int32 holding the uint32 words, LSB-first
    l0_cp: torch.Tensor  # (nb0 + 1,) int32 rank1 checkpoints per 128 bits
    l1_words: torch.Tensor
    l1_cp: torch.Tensor
    z0: int  # count of high-bit-0 symbols
    n: int


def to_device(wv: WaveletRank, device="cuda") -> DeviceWaveletRank:
    a = wv.device_arrays()
    return DeviceWaveletRank(
        l0_words=rank_ops._upload(a["l0_words"], device),
        l0_cp=rank_ops._upload(a["l0_cp"].astype(np.int32), device),
        l1_words=rank_ops._upload(a["l1_words"], device),
        l1_cp=rank_ops._upload(a["l1_cp"].astype(np.int32), device),
        z0=int(a["z0"]),
        n=wv.n,
    )


def _dev_rank1(words: torch.Tensor, cp: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """rank1(i) on a device bit vector; vectorised over i (any shape)."""
    i = i.to(I32)
    b = i // BLOCK_BITS
    blk = words.reshape(-1, WORDS_PER_BLOCK)[b.long()]  # (..., 4)
    rem = i - b * BLOCK_BITS
    j = 32 * torch.arange(WORDS_PER_BLOCK, dtype=I32, device=i.device)
    masks = rank_ops._low_bits((rem[..., None] - j).clamp(0, 32))
    part = rank_ops._popcount(blk & masks).sum(dim=-1, dtype=I32)
    return cp[b.long()] + part


def device_rank(wv: DeviceWaveletRank, c: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """occ(c, i): #occurrences of code c in [0, i); c and i vectorised."""
    c = c.to(I32)
    i = i.to(I32)
    b0 = (c >> 1) & 1
    b1 = c & 1
    r1 = _dev_rank1(wv.l0_words, wv.l0_cp, i)
    i1 = torch.where(b0 == 0, i - r1, r1)
    base = torch.where(b0 == 0, 0, wv.z0).to(I32)
    lo = _dev_rank1(wv.l1_words, wv.l1_cp, base + i1) - _dev_rank1(wv.l1_words, wv.l1_cp, base)
    return torch.where(b1 == 1, lo, i1 - lo)


def exact_search_wavelet(
    wv: DeviceWaveletRank,
    C: torch.Tensor,  # (5,) int32 cumulative counts
    primary: int,  # BWT primary row
    reads: torch.Tensor,  # (B, L) int32
    lengths: torch.Tensor,  # (B,)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Backward search with wavelet-rank occ; the same (lo, hi) as
    ``models.exact.exact_interval_search`` on the fused rows.

    The wavelet stores BWT symbols only: the primary row's $ is not a
    symbol, so row coordinates past it step back one before ranking, as
    the fused rows do."""
    B, L = reads.shape
    dev = reads.device
    reads = reads.to(I32)
    lengths = lengths.to(I32)
    C = C.to(I32)

    def occ(c, k):
        return device_rank(wv, c, k - (k > primary).to(I32))

    lo = torch.zeros(B, dtype=I32, device=dev)
    hi = torch.full((B,), wv.n + 1, dtype=I32, device=dev)
    for t in range(L):
        j = lengths - 1 - t
        active = (j >= 0) & (lo < hi)
        c = torch.gather(reads, 1, j.clamp(min=0)[:, None].long())[:, 0]
        Cc = C[c.long()]
        nlo, nhi = Cc + occ(c, lo), Cc + occ(c, hi)
        lo, hi = torch.where(active, nlo, lo), torch.where(active, nhi, hi)
    return lo, hi
