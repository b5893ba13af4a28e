"""Bidirectional BWT search in torch: the counterpart of
``genome_weaver_align_tpu.models.bidirectional``.

Synchronized SA intervals in the forward-text index (for pattern P) and the
reverse-text index (for rev(P)), so P can be extended by one character on
either side (Lam et al. 2BWT).  Backward extension P -> cP on the forward
index:

    cnt[a]  = occ$(a, hi) - occ$(a, lo)          (all four codes, one pass)
    s       = [lo <= primary < hi]               ($ sorts before every base)
    lo'     = C[c] + occ$(c, lo);   hi' = lo' + cnt[c]
    rlo'    = rlo + s + sum_{a<c} cnt[a];  rhi' = rlo' + cnt[c]

Forward extension P -> Pc is the mirror image with the two indexes swapped.
Every extension fetches the lo and hi rows in one stacked ``occ_all4``
gather.  Codes must lie in 0..3: callers clamp their read index (a lane
that reads past its read is masked out afterwards), where the JAX gathers
fill or clamp.  ``HostBiIndex`` is the numpy oracle the tests hold the
device version against.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..index.build import FMIndexData
from ..ops import rank
from ..ops.rank import DeviceFMIndex

I32 = torch.int32


class BiInterval(NamedTuple):
    """Synchronized interval pair; tensors of one shape."""

    lo: torch.Tensor
    hi: torch.Tensor
    rlo: torch.Tensor
    rhi: torch.Tensor

    @property
    def width(self):
        return self.hi - self.lo


@dataclass(frozen=True)
class DeviceBiIndex:
    fwd: DeviceFMIndex
    rev: DeviceFMIndex


def from_host_bi(fwd: FMIndexData, rev: FMIndexData, device) -> DeviceBiIndex:
    return DeviceBiIndex(rank.from_host(fwd, device), rank.from_host(rev, device))


# ---------------------------------------------------------------- device

def init_interval(n: int, shape, device) -> BiInterval:
    z = torch.zeros(shape, dtype=I32, device=device)
    f = torch.full(shape, n + 1, dtype=I32, device=device)
    return BiInterval(z, f, z.clone(), f.clone())


def _occ_all4_pair(fm: DeviceFMIndex, a: torch.Tensor, b: torch.Tensor):
    """occ_all4 at two coordinate tensors via ONE stacked row gather: the
    sequential extension steps wait on their occ rows, so one gather round
    a step instead of two."""
    both = rank.occ_all4(fm, torch.stack([a, b], dim=0))
    return both[0], both[1]


def _extend(main: DeviceFMIndex, mlo, mhi, olo, c):
    """One-character extension on ``main``: (main lo, main hi, other lo,
    other hi) of the extended pattern; c broadcasts to the intervals."""
    occ_lo, occ_hi = _occ_all4_pair(main, mlo, mhi)
    cnt = occ_hi - occ_lo  # (..., 4)
    p = main.primary
    s = ((mlo <= p) & (p < mhi)).to(I32)
    pref = torch.cumsum(cnt, dim=-1, dtype=I32) - cnt  # exclusive prefix over codes
    c = torch.broadcast_to(c.to(I32), mlo.shape)
    c_ = c[..., None].long()
    below = torch.gather(pref, -1, c_)[..., 0]
    cc = torch.gather(cnt, -1, c_)[..., 0]
    mlo2 = main.C[c.long()] + torch.gather(occ_lo, -1, c_)[..., 0]
    olo2 = olo + s + below
    return mlo2, mlo2 + cc, olo2, olo2 + cc


def extend_backward(bi: DeviceBiIndex, st: BiInterval, c: torch.Tensor) -> BiInterval:
    """P -> cP.  c int codes 0..3, broadcastable to the interval tensors."""
    lo2, hi2, rlo2, rhi2 = _extend(bi.fwd, st.lo, st.hi, st.rlo, c)
    return BiInterval(lo2, hi2, rlo2, rhi2)


def extend_forward(bi: DeviceBiIndex, st: BiInterval, c: torch.Tensor) -> BiInterval:
    """P -> Pc (character update on the reverse-text index, forward synced)."""
    rlo2, rhi2, lo2, hi2 = _extend(bi.rev, st.rlo, st.rhi, st.lo, c)
    return BiInterval(lo2, hi2, rlo2, rhi2)


def _extend_all4(main: DeviceFMIndex, mlo, mhi, olo):
    occ_lo, occ_hi = _occ_all4_pair(main, mlo, mhi)
    cnt = occ_hi - occ_lo
    p = main.primary
    s = ((mlo <= p) & (p < mhi)).to(I32)[..., None]
    pref = torch.cumsum(cnt, dim=-1, dtype=I32) - cnt
    mlo2 = main.C[:4] + occ_lo
    olo2 = olo[..., None] + s + pref
    return mlo2, mlo2 + cnt, olo2, olo2 + cnt


def extend_backward_all4(bi: DeviceBiIndex, st: BiInterval) -> BiInterval:
    """All four backward extensions at once: result tensors get a trailing
    axis of size 4 (used by branching approximate search)."""
    lo2, hi2, rlo2, rhi2 = _extend_all4(bi.fwd, st.lo, st.hi, st.rlo)
    return BiInterval(lo2, hi2, rlo2, rhi2)


def extend_forward_all4(bi: DeviceBiIndex, st: BiInterval) -> BiInterval:
    rlo2, rhi2, lo2, hi2 = _extend_all4(bi.rev, st.rlo, st.rhi, st.lo)
    return BiInterval(lo2, hi2, rlo2, rhi2)


# ---------------------------------------------------------------- host oracle

class HostBiIndex:
    def __init__(self, fwd: FMIndexData, rev: FMIndexData):
        assert fwd.n == rev.n
        self.fwd, self.rev = fwd, rev

    def init(self) -> tuple[int, int, int, int]:
        n = self.fwd.n
        return (0, n + 1, 0, n + 1)

    def _ext(self, main: FMIndexData, mlo, mhi, olo, c):
        cnt = [int(main.occ(a, mhi)[0] - main.occ(a, mlo)[0]) for a in range(4)]
        s = 1 if mlo <= main.primary < mhi else 0
        below = sum(cnt[:c])
        mlo2 = int(main.C[c] + main.occ(c, mlo)[0])
        olo2 = olo + s + below
        return mlo2, mlo2 + cnt[c], olo2, olo2 + cnt[c]

    def extend_backward(self, st, c):
        lo, hi, rlo, rhi = st
        return self._ext(self.fwd, lo, hi, rlo, c)

    def extend_forward(self, st, c):
        lo, hi, rlo, rhi = st
        rlo2, rhi2, lo2, hi2 = self._ext(self.rev, rlo, rhi, lo, c)
        return (lo2, hi2, rlo2, rhi2)
