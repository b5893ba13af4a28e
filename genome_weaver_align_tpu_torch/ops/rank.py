"""FM-index rank/occ, LF and locate on the device, in torch.

Torch counterpart of ``genome_weaver_align_tpu.ops.rank``.  Every query is
one fused-row gather plus an XOR/popcount reduce, batched over a lane axis.
BWT words and their occurrence checkpoint are interleaved into one 12-word
row per 128-base block::

    row b (12 words): [ 8 bwt words | occ_cp[b, A..T] ]

so occ(c, k) costs a single row gather.  Bit layout matches
``index.build``; the tests hold every function against its JAX twin.

Words are int32 tensors holding the JAX package's uint32 bits: torch has no
unsigned 32-bit arithmetic to speak of.  ``>>`` is arithmetic on int32, so
every shift is followed by a mask that drops the copied sign bits, and bit
masks wider than 31 bits come from int64 arithmetic reinterpreted as int32
(``_as_i32``).  torch has no popcount either: ``_popcount`` is a SWAR count
over the two 16-bit halves, whose intermediates never leave [0, 2^16).
All indices are int32 values below 2^31 - 2^20 (``utils.larray``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from genome_weaver_align_tpu_torch.utils.larray import check_device_indexable

from ..index.build import BLOCK_BASES, WORDS_PER_BLOCK, FMIndexData

I32 = torch.int32

FUSED_WIDTH = WORDS_PER_BLOCK + 4  # 8 bwt words + 4 checkpoint lanes

MARK_BLOCK_BITS = 128
MARK_WORDS_PER_BLOCK = MARK_BLOCK_BITS // 32

_PAIR = 0x55555555  # the low bit of every 2-bit base slot
_PAIR_HI = 0xAAAAAAAA - (1 << 32)  # the high bit of every slot, as int32


@dataclass(frozen=True)
class DeviceFMIndex:
    """Device-resident FM-index tables (one strand direction)."""

    blocks: torch.Tensor  # (nb+1, 12) int32 fused rows (see module docstring)
    C: torch.Tensor  # (5,) int32
    primary: int  # row of $ in the sentinel-inclusive BWT
    mark_blocks: torch.Tensor  # (mb, 4) int32 — sparse-SA row marks
    mark_cp: torch.Tensor  # (mb+1,) int32 — rank1 checkpoints over marks
    ssa_values: torch.Tensor  # (n_samples,) int32 — sampled SA values, row order
    n: int
    sample_rate: int
    full_sa: torch.Tensor | None = None  # optional (n+1,) int32 — locate in ONE gather


def fuse_blocks(bwt_words: np.ndarray, occ_cp: np.ndarray) -> np.ndarray:
    """Host-side interleave: (nb+1, 8) words + (nb+1, 4) cp -> (nb+1, 12)."""
    nb = occ_cp.shape[0]
    words = bwt_words.reshape(nb, WORDS_PER_BLOCK)
    fused = np.empty((nb, FUSED_WIDTH), dtype=np.uint32)
    fused[:, :WORDS_PER_BLOCK] = words
    fused[:, WORDS_PER_BLOCK:] = occ_cp.astype(np.int32).view(np.uint32)
    return fused


def _upload(a: np.ndarray, device) -> torch.Tensor:
    """Host array -> int32 device tensor (uint32 arrays keep their bits)."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.astype(np.int32, copy=False)).to(device)


def from_host(fm: FMIndexData, device="cpu") -> DeviceFMIndex:
    """The numpy ``FMIndexData`` that both packages load -> device tables."""
    check_device_indexable(fm.n + 1, "FM index")
    marks = fm.ssa_marks
    mw = marks._wpad
    mb = mw.size // MARK_WORDS_PER_BLOCK
    return DeviceFMIndex(
        blocks=_upload(fuse_blocks(fm.bwt_words, fm.occ_cp), device),
        C=_upload(fm.C, device),
        primary=int(fm.primary),
        mark_blocks=_upload(mw.reshape(mb, MARK_WORDS_PER_BLOCK), device),
        mark_cp=_upload(marks.checkpoints, device),
        ssa_values=_upload(fm.ssa_values, device),
        n=int(fm.n),
        sample_rate=int(fm.sample_rate),
        full_sa=None if fm.full_sa is None else _upload(fm.full_sa, device),
    )


def from_arrays(
    blocks: np.ndarray,
    C: np.ndarray,
    primary: int,
    mark_blocks: np.ndarray,
    mark_cp: np.ndarray,
    ssa_values: np.ndarray,
    n: int,
    sample_rate: int,
    full_sa: np.ndarray | None = None,
    device="cpu",
) -> DeviceFMIndex:
    """DeviceFMIndex straight from device-ready host arrays (the flat
    multi-part layout stores exactly these); equal to ``from_host``'s."""
    check_device_indexable(int(n) + 1, "FM index")
    return DeviceFMIndex(
        blocks=_upload(blocks, device),
        C=_upload(C, device),
        primary=int(primary),
        mark_blocks=_upload(mark_blocks, device),
        mark_cp=_upload(mark_cp, device),
        ssa_values=_upload(ssa_values, device),
        n=int(n),
        sample_rate=int(sample_rate),
        full_sa=None if full_sa is None else _upload(full_sa, device),
    )


def _as_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensors with the same low 32 bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(I32)


def _low_bits(nbits: torch.Tensor) -> torch.Tensor:
    """Masks of the low ``nbits`` (0..32) bits as int32 words."""
    return _as_i32((1 << nbits.to(torch.int64)) - 1)


def _popcount16(v: torch.Tensor) -> torch.Tensor:
    v = v - ((v >> 1) & 0x5555)
    v = (v & 0x3333) + ((v >> 2) & 0x3333)
    v = (v + (v >> 4)) & 0x0F0F
    return (v + (v >> 8)) & 0x1F


def _popcount(x: torch.Tensor) -> torch.Tensor:
    """Set bits of the uint32 pattern of each int32 word."""
    return _popcount16(x & 0xFFFF) + _popcount16((x >> 16) & 0xFFFF)


def _pair_masks(r: torch.Tensor) -> torch.Tensor:
    """(...,) base offsets in [0, 128] -> (..., 8) int32 pair masks.

    Word j of a block may count min(max(r - 16j, 0), 16) leading bases; the
    mask covers exactly those 2-bit slots."""
    j = 16 * torch.arange(WORDS_PER_BLOCK, dtype=I32, device=r.device)
    allowed = (r[..., None] - j).clamp(0, 16)
    return _low_bits(2 * allowed)


def _code_pattern(code: torch.Tensor) -> torch.Tensor:
    """code (0..3) repeated in all 16 base slots: the uint32 ``code *
    0x55555555`` as int32 (bit 0 of the code fills the even bits, bit 1
    the odd ones)."""
    return (-(code & 1) & _PAIR) | (-((code >> 1) & 1) & _PAIR_HI)


def _match_counts(words: torch.Tensor, code: torch.Tensor, pair_masks: torch.Tensor) -> torch.Tensor:
    """#bases equal to ``code`` within the masked slots; sums last axis."""
    x = words ^ _code_pattern(code)[..., None]
    mm = ~(x | ((x >> 1) & 0x7FFFFFFF)) & _PAIR & pair_masks
    return _popcount(mm).sum(dim=-1, dtype=I32)


def _row_split(fm: DeviceFMIndex, k: torch.Tensor):
    """Fused-row fetch for sentinel-inclusive coordinates k."""
    k_adj = (k - (k > fm.primary).to(k.dtype)).to(I32)
    b = torch.div(k_adj, BLOCK_BASES, rounding_mode="floor")
    r = k_adj - b * BLOCK_BASES
    row = fm.blocks[b.long()]  # (..., 12) — ONE gather
    return row[..., :WORDS_PER_BLOCK], row[..., WORDS_PER_BLOCK:], r


def occ_codes(fm: DeviceFMIndex, codes: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """occ$(codes[i], k[i]) for each lane i — sentinel-inclusive coordinates."""
    words, cp, r = _row_split(fm, k)
    codes = codes.to(I32)
    base = torch.gather(cp, -1, codes[..., None].long())[..., 0]
    return base + _match_counts(words, codes, _pair_masks(r))


def occ_all4(fm: DeviceFMIndex, k: torch.Tensor) -> torch.Tensor:
    """occ$(c, k) for all four codes: (...,) -> (..., 4).  The four codes'
    match counts run as one (..., 4, 8) word tensor: the bidirectional
    search calls this once a sequential step, so its op count is the
    step's launch count."""
    words, cp, r = _row_split(fm, k)
    codes = torch.arange(4, dtype=I32, device=k.device)
    counts = _match_counts(words[..., None, :], codes, _pair_masks(r)[..., None, :])
    return cp + counts


def backward_step(fm: DeviceFMIndex, codes: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor):
    """One batched backward-search interval update: lo and hi are fetched
    in a single stacked gather."""
    both = occ_codes(fm, torch.cat([codes, codes], dim=0), torch.cat([lo, hi], dim=0))
    occ_lo, occ_hi = torch.chunk(both, 2, dim=0)
    Cc = fm.C[codes.long()]
    return Cc + occ_lo, Cc + occ_hi


def bwt_char(fm: DeviceFMIndex, i: torch.Tensor) -> torch.Tensor:
    """BWT code at sentinel-inclusive row(s) i (caller avoids the primary row)."""
    idx = (i - (i > fm.primary).to(i.dtype)).to(I32)
    b = torch.div(idx, BLOCK_BASES, rounding_mode="floor")
    w = fm.blocks[b.long(), ((idx - b * BLOCK_BASES) >> 4).long()]
    return (w >> (2 * (idx & 15))) & 3


def lf(fm: DeviceFMIndex, i: torch.Tensor) -> torch.Tensor:
    c = bwt_char(fm, i)
    return fm.C[c.long()] + occ_codes(fm, c, i)


def lf_fused(fm: DeviceFMIndex, i: torch.Tensor) -> torch.Tensor:
    """LF with a single row gather: char and occ from the same fused row."""
    words, cp, r = _row_split(fm, i)
    w = torch.gather(words, -1, (r >> 4)[..., None].long())[..., 0]
    c = (w >> (2 * (r & 15))) & 3
    base = torch.gather(cp, -1, c[..., None].long())[..., 0]
    return fm.C[c.long()] + base + _match_counts(words, c, _pair_masks(r))


def _mark_get(fm: DeviceFMIndex, i: torch.Tensor) -> torch.Tensor:
    i = i.to(I32)
    w = fm.mark_blocks[(i >> 7).long(), ((i & (MARK_BLOCK_BITS - 1)) >> 5).long()]
    return ((w >> (i & 31)) & 1).bool()


def _mark_rank1(fm: DeviceFMIndex, i: torch.Tensor) -> torch.Tensor:
    i = i.to(I32)
    b = i >> 7
    words = fm.mark_blocks[b.long()]  # (..., 4)
    rem = i - b * MARK_BLOCK_BITS
    j = 32 * torch.arange(MARK_WORDS_PER_BLOCK, dtype=I32, device=i.device)
    masks = _low_bits((rem[..., None] - j).clamp(0, 32))
    return fm.mark_cp[b.long()] + _popcount(words & masks).sum(dim=-1, dtype=I32)


def locate(fm: DeviceFMIndex, rows: torch.Tensor) -> torch.Tensor:
    """Text positions of BWT rows.

    With a full SA on the device this is ONE gather; otherwise an LF walk
    of exactly ``sample_rate`` steps to the nearest sparse-SA sample: a
    fixed trip count, so the walk never waits on the device to decide
    whether to stop.  Results are bit-identical either way."""
    if fm.full_sa is not None:
        return fm.full_sa[rows.long()]
    i = rows.to(I32)
    d = torch.zeros_like(i)
    for _ in range(fm.sample_rate):
        marked = _mark_get(fm, i)
        i = torch.where(marked, i, lf_fused(fm, i))
        d = d + (~marked).to(I32)
    return fm.ssa_values[_mark_rank1(fm, i).long()] + d
