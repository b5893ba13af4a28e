"""BWT-interval index sharding and merged rank queries: the torch
counterpart of ``genome_weaver_align_tpu.parallel.sharded_index``.

The index is split into contiguous, block-aligned BWT rank ranges: shard s
owns a slice of the packed BWT and its occurrence checkpoints, of the
sparse-SA mark bits and of the sampled SA values.  Every rank, LF or locate
query is answered by its owning shard and the shards' partials are merged
by a sum over the shard axis (non-owners contribute zero).

Two coordinate spaces are sharded independently (both 128-aligned):
- packed BWT coordinates [0, n]   -> bwt blocks + occ checkpoints
- BWT row coordinates   [0, n+1)  -> sparse-SA marks, sampled values

Checkpoint values stay global (no rebasing), so a local partial popcount
plus the local checkpoint is already the global occ value.

All shards live on one device, stacked on a leading shard axis S as in the
JAX package's host layout; every ``local_*`` function answers a query for
all S shards at once and returns ``(S, ...)`` partials.  A ``merge`` takes
those partials and returns the ``(...)`` sum: ``parts.sum(0)`` by default
(the analogue of ``psum``), or the ring kernels of ``parallel.ring``.
Words are int32 tensors holding the uint32 bits, as in ``ops.rank``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..index.build import BLOCK_BASES, WORDS_PER_BLOCK, FMIndexData
from ..ops import rank
from ..ops.rank import MARK_BLOCK_BITS, MARK_WORDS_PER_BLOCK
from . import ring
from .mesh import ShardLayout

I32 = torch.int32

_STACKED = (
    "bwt_blocks",
    "occ_cp",
    "pk_start",
    "pk_end",
    "mark_blocks",
    "mark_cp",
    "row_start",
    "row_end",
    "ssa_values",
    "ssa_base",
)


@dataclass(frozen=True)
class ShardedFMIndex:
    """Stacked per-shard tables; leading axis = interval shard.  Numpy
    arrays from ``shard_fm_index``, int32 device tensors after
    ``put_sharded``."""

    bwt_blocks: object  # (S, nbs+1, 8) uint32 words
    occ_cp: object  # (S, nbs+1, 4) int32 (global values)
    C: object  # (5,) int32 (replicated)
    primary: int
    pk_start: object  # (S,) int32 packed-coordinate shard starts
    pk_end: object  # (S,) int32 (exclusive; last = n+1 to own k == n)
    mark_blocks: object  # (S, mbs, 4) uint32
    mark_cp: object  # (S, mbs+1) int32 (global rank1 at local block starts)
    row_start: object  # (S,) int32 row-coordinate shard starts
    row_end: object  # (S,) int32
    ssa_values: object  # (S, vmax) int32 (padded)
    ssa_base: object  # (S,) int32 marked rows before this shard
    n: int
    sample_rate: int
    n_shards: int


def shard_fm_index(fm: FMIndexData, n_shards: int) -> ShardedFMIndex:
    """Host-side split of FMIndexData into n_shards stacked slices (numpy;
    array for array the JAX package's split)."""
    n = fm.n
    # ---- packed space
    nb_total = fm.bwt_words.size // WORDS_PER_BLOCK  # includes +1 pad block
    nbs = -(-nb_total // n_shards)
    bwt = np.zeros((n_shards, nbs + 1, WORDS_PER_BLOCK), dtype=np.uint32)
    occ = np.zeros((n_shards, nbs + 1, 4), dtype=np.int32)
    blocks = fm.bwt_words.reshape(nb_total, WORDS_PER_BLOCK)
    pk_start = np.zeros(n_shards, np.int32)
    pk_end = np.zeros(n_shards, np.int32)
    for s in range(n_shards):
        b0 = s * nbs
        b1 = min(nb_total, b0 + nbs + 1)  # +1: boundary block overlap
        if b0 < nb_total:
            bwt[s, : b1 - b0] = blocks[b0:b1]
            occ[s, : b1 - b0] = fm.occ_cp[b0:b1].astype(np.int32)
        # clamped, disjoint, and covering [0, n]: the +1-padded final block
        # guarantees (nb_total)*BLOCK_BASES > n, so k == n has an owner
        pk_start[s] = min(b0 * BLOCK_BASES, n + 1)
        pk_end[s] = min((b0 + nbs) * BLOCK_BASES, n + 1)
    # ---- row space
    marks = fm.ssa_marks
    mw = marks._wpad  # (mb_total * 4,) uint32 words over n+1 rows
    mb_total = mw.size // MARK_WORDS_PER_BLOCK
    mbs = -(-mb_total // n_shards)
    mblk = np.zeros((n_shards, mbs, MARK_WORDS_PER_BLOCK), dtype=np.uint32)
    mcp = np.zeros((n_shards, mbs + 1), dtype=np.int32)
    row_start = np.zeros(n_shards, np.int32)
    row_end = np.zeros(n_shards, np.int32)
    mwords = mw.reshape(mb_total, MARK_WORDS_PER_BLOCK)
    cps = marks.checkpoints.astype(np.int32)  # (mb_total+1,)
    ssa_base = np.zeros(n_shards, np.int32)
    ssa_parts = []
    for s in range(n_shards):
        b0 = s * mbs
        b1 = min(mb_total, b0 + mbs)
        if b0 < mb_total:
            mblk[s, : b1 - b0] = mwords[b0:b1]
            mcp[s, : b1 - b0 + 1] = cps[b0 : b1 + 1]
        row_start[s] = min(b0 * MARK_BLOCK_BITS, n + 1)
        row_end[s] = min((b0 + mbs) * MARK_BLOCK_BITS, n + 1)
        ssa_base[s] = cps[min(b0, mb_total)]
        lo_rank = int(ssa_base[s])
        hi_rank = int(cps[min(b0 + mbs, mb_total)])
        ssa_parts.append(fm.ssa_values[lo_rank:hi_rank].astype(np.int32))
    vmax = max(1, max(p.size for p in ssa_parts))
    ssa = np.zeros((n_shards, vmax), dtype=np.int32)
    for s, p in enumerate(ssa_parts):
        ssa[s, : p.size] = p

    return ShardedFMIndex(
        bwt_blocks=bwt,
        occ_cp=occ,
        C=fm.C.astype(np.int32),
        primary=int(fm.primary),
        pk_start=pk_start,
        pk_end=pk_end,
        mark_blocks=mblk,
        mark_cp=mcp,
        row_start=row_start,
        row_end=row_end,
        ssa_values=ssa,
        ssa_base=ssa_base,
        n=int(fm.n),
        sample_rate=int(fm.sample_rate),
        n_shards=n_shards,
    )


def put_sharded(sh: ShardedFMIndex, device) -> ShardedFMIndex:
    """Upload every table to ``device`` as int32 tensors (uint32 words keep
    their bits); all shards on the one device."""
    kw = {f: rank._upload(np.asarray(getattr(sh, f)), device) for f in (*_STACKED, "C")}
    return dataclasses.replace(sh, **kw)


# ---- local (per-shard) queries, vectorised over the shard axis: a query of
# shape (...) gives (S, ...) partials; non-owners contribute 0.


def _col(v: torch.Tensor, ndim: int) -> torch.Tensor:
    """(S,) -> (S, 1, ..., 1) broadcasting against (1, *query_shape)."""
    return v.reshape((-1,) + (1,) * ndim)


def _shard_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table (S, R, ...) gathered at per-shard row indices idx (S, ...)."""
    S, R = table.shape[:2]
    flat = idx.long() + _col(torch.arange(S, device=idx.device) * R, idx.dim() - 1)
    return table.reshape((S * R,) + table.shape[2:])[flat]


def _block_split(sh: ShardedFMIndex, k: torch.Tensor):
    """Owner mask, clamped local block and in-block offset of sentinel-
    inclusive coordinates k, per shard."""
    k_adj = (k - (k > sh.primary).to(k.dtype)).to(I32)[None]
    ps, pe = _col(sh.pk_start, k.dim()), _col(sh.pk_end, k.dim())
    own = (k_adj >= ps) & (k_adj < pe)
    kk = torch.maximum(k_adj, ps)
    b_local = torch.div(kk - ps, BLOCK_BASES, rounding_mode="floor")
    b_local = b_local.clamp(0, sh.bwt_blocks.shape[1] - 1)
    return own, b_local, kk - ps - b_local * BLOCK_BASES


def local_occ_codes(sh: ShardedFMIndex, codes: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Each shard's contribution to occ$(codes, k): (S, ...); the caller
    merges."""
    own, b_local, r = _block_split(sh, k)
    words = _shard_rows(sh.bwt_blocks, b_local)
    cs = codes.to(I32).expand(own.shape)
    base = torch.gather(_shard_rows(sh.occ_cp, b_local), -1, cs[..., None].long())[..., 0]
    val = base + rank._match_counts(words, cs, rank._pair_masks(r))
    return torch.where(own, val, 0)


def local_occ_gather(sh: ShardedFMIndex, codes: torch.Tensor, k: torch.Tensor):
    """Gather half of ``local_occ_codes`` for ``ring.fused_rank_ring`` (the
    JAX contract's entry; the sharded search calls ``fused_occ``).

    Returns (words (S, Q, 8), roff (S, Q), base (S, Q), own (S, Q)), all
    int32, such that the sum over shards of
    ``own * (base + match_count(words, codes, roff))`` equals that of
    ``local_occ_codes(sh, codes, k)`` bit for bit.  ``roff`` may exceed 128
    for non-owned clamped queries: the mask saturates at the full block and
    ``own`` zeroes the result."""
    own, b_local, roff = _block_split(sh, k)
    words = _shard_rows(sh.bwt_blocks, b_local)  # ONE gather
    cs = codes.to(I32).expand(own.shape)
    base = torch.gather(_shard_rows(sh.occ_cp, b_local), -1, cs[..., None].long())[..., 0]
    return words, roff, base, own.to(I32)


def fused_occ_plain(sh: ShardedFMIndex, codes: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """``fused_occ``'s plain version: the int32 sum over shards of
    ``local_occ_codes``."""
    return local_occ_codes(sh, codes, k).sum(0, dtype=I32)


def fused_occ(sh: ShardedFMIndex, codes: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Merged occ$(codes, k) of queries of any shape (codes 0..3) -> int32
    of that shape.  On the card one kernel reads each query's row from its
    owner's table and sums over the shards (``ops.ring_cuda.fused_occ_cuda``:
    no gathered word tensor); a CPU tensor takes ``fused_occ_plain``."""
    if codes.is_cuda:
        from ..ops import ring_cuda

        return ring_cuda.fused_occ_cuda(
            sh.bwt_blocks, sh.occ_cp, sh.pk_start, sh.pk_end, sh.primary,
            codes.to(I32).contiguous(), k.to(I32).contiguous(),
        )
    return fused_occ_plain(sh, codes, k)


def local_occ_all4(sh: ShardedFMIndex, k: torch.Tensor) -> torch.Tensor:
    """occ$(c, k) contributions for all four codes: (S, ..., 4)."""
    own, b_local, r = _block_split(sh, k)
    words = _shard_rows(sh.bwt_blocks, b_local)
    masks = rank._pair_masks(r)
    counts = [
        rank._match_counts(words, torch.full(own.shape, c, dtype=I32, device=k.device), masks)
        for c in range(4)
    ]
    val = _shard_rows(sh.occ_cp, b_local) + torch.stack(counts, dim=-1)
    return torch.where(own[..., None], val, 0)


def local_bwt_char(sh: ShardedFMIndex, i: torch.Tensor) -> torch.Tensor:
    """Owner returns the BWT code at row i, others 0 (so the sum is it)."""
    idx = (i - (i > sh.primary).to(i.dtype)).to(I32)[None]
    ps, pe = _col(sh.pk_start, i.dim()), _col(sh.pk_end, i.dim())
    own = (idx >= ps) & (idx < pe) & (idx < sh.n)
    local = (idx - ps).clamp(min=0)
    b_local = (local // BLOCK_BASES).clamp(0, sh.bwt_blocks.shape[1] - 1)
    row = _shard_rows(sh.bwt_blocks, b_local)
    w = torch.gather(row, -1, ((local % BLOCK_BASES) // 16)[..., None].long())[..., 0]
    c = (w >> (2 * (local % 16))) & 3
    return torch.where(own, c, 0)


def _row_split(sh: ShardedFMIndex, i: torch.Tensor):
    i = i.to(I32)[None]
    rs, re_ = _col(sh.row_start, i.dim() - 1), _col(sh.row_end, i.dim() - 1)
    own = (i >= rs) & (i < re_)
    local = (i - rs).clamp(min=0)
    b = (local // MARK_BLOCK_BITS).clamp(0, sh.mark_blocks.shape[1] - 1)
    return own, local, b


def local_mark_get(sh: ShardedFMIndex, i: torch.Tensor) -> torch.Tensor:
    own, local, b = _row_split(sh, i)
    row = _shard_rows(sh.mark_blocks, b)
    w = torch.gather(row, -1, ((local % MARK_BLOCK_BITS) // 32)[..., None].long())[..., 0]
    bit = (w >> (local % 32)) & 1
    return torch.where(own, bit, 0)


def local_mark_rank1(sh: ShardedFMIndex, i: torch.Tensor) -> torch.Tensor:
    """Global rank1(i) contribution (checkpoints hold global values)."""
    own, local, b = _row_split(sh, i)
    words = _shard_rows(sh.mark_blocks, b)
    rem = local - b * MARK_BLOCK_BITS
    j = 32 * torch.arange(MARK_WORDS_PER_BLOCK, dtype=I32, device=i.device)
    masks = rank._low_bits((rem[..., None] - j).clamp(0, 32))
    part = rank._popcount(words & masks).sum(dim=-1, dtype=I32)
    return torch.where(own, _shard_rows(sh.mark_cp, b) + part, 0)


def local_ssa_value(sh: ShardedFMIndex, i: torch.Tensor, global_rank: torch.Tensor) -> torch.Tensor:
    own, _, _ = _row_split(sh, i)
    slot = (global_rank.to(I32)[None] - _col(sh.ssa_base, i.dim()))
    slot = slot.clamp(0, sh.ssa_values.shape[1] - 1)
    return torch.where(own, _shard_rows(sh.ssa_values, slot), 0)


# ---- merged primitives: a merge maps (S, ...) partials to their (...) sum.


def default_merge(parts: torch.Tensor) -> torch.Tensor:
    """The analogue of ``psum``: the int32 sum over the shard axis."""
    return parts.sum(0, dtype=I32)


def ring_merge(parts: torch.Tensor) -> torch.Tensor:
    """The ring all-reduce (``parallel.ring.ring_psum``); shard 0's copy."""
    return ring.ring_psum(parts)[0]


def occ_codes(sh, codes, k, merge=None):
    merge = merge or default_merge
    return merge(local_occ_codes(sh, codes, k))


def backward_step(sh, codes, lo, hi, merge=None):
    """One interval update; the merge payload per shard is (2, ...): the
    lo and hi partials stacked."""
    merge = merge or default_merge
    part = torch.stack([local_occ_codes(sh, codes, lo), local_occ_codes(sh, codes, hi)], dim=1)
    occ_lo, occ_hi = merge(part)
    Cc = sh.C[codes.long()]
    return Cc + occ_lo, Cc + occ_hi


def lf(sh, i, merge=None):
    merge = merge or default_merge
    c = merge(local_bwt_char(sh, i))
    return sh.C[c.long()] + merge(local_occ_codes(sh, c, i))


def locate(sh, rows, merge=None):
    """LF walk of exactly ``sample_rate`` steps with merges per step."""
    merge = merge or default_merge
    i = rows.to(I32)
    d = torch.zeros_like(i)
    for _ in range(sh.sample_rate):
        marked = merge(local_mark_get(sh, i)) > 0
        nxt = lf(sh, i, merge)
        i, d = torch.where(marked, i, nxt), torch.where(marked, d, d + 1)
    grank = merge(local_mark_rank1(sh, i))
    val = merge(local_ssa_value(sh, i, grank))
    return val + d


def make_sharded_exact_search(
    layout: ShardLayout,
    max_len: int,
    like: ShardedFMIndex = None,
    *,
    merge: str = "psum",
    microbatch: int = 1,
):
    """Exact search over interval shards.  Returns fn(sharded_index, reads,
    lengths) -> (lo, hi, positions), reads and lengths as ``mesh.
    shard_reads`` gives them.

    ``merge`` picks the merge of the extension steps: "psum"
    (``parts.sum(0)``), "ring" (``ring.ring_psum``: one launch per
    microbatch chunk per step, payload (2, B / microbatch)) or "fused"
    (``fused_occ``: one launch per step that reads every chunk's lo and hi
    rows from the shard tables and sums the shards' occ values).
    ``microbatch`` > 1 splits the batch into that many chunks per step (when
    it divides the batch), as the JAX code splits each data shard's batch;
    the results are the same for every chunking.  ``locate``'s merges stay ``parts.sum(0)``.
    ``like`` is accepted for the JAX signature; nothing is read from it.
    """
    if merge not in ("psum", "ring", "fused"):
        raise ValueError(f"merge={merge!r}: expected psum, ring or fused")
    step_merge = ring_merge if merge == "ring" else default_merge

    def fn(sh: ShardedFMIndex, reads: torch.Tensor, lengths: torch.Tensor):
        B, L = reads.shape
        dev = reads.device
        reads = reads.to(I32)
        lengths = lengths.to(I32)
        mb = microbatch if B % microbatch == 0 else 1
        Bc = B // mb
        rchunks = [reads[m * Bc : (m + 1) * Bc] for m in range(mb)]
        lchunks = [lengths[m * Bc : (m + 1) * Bc] for m in range(mb)]
        state = [
            (torch.zeros(Bc, dtype=I32, device=dev), torch.full((Bc,), sh.n + 1, dtype=I32, device=dev))
            for _ in range(mb)
        ]
        for t in range(max_len):
            cs, actives = [], []
            for m in range(mb):
                lo, hi = state[m]
                j = lchunks[m] - 1 - t
                actives.append((j >= 0) & (lo < hi))
                cs.append(torch.gather(rchunks[m], 1, j.clamp(0, L - 1)[:, None].long())[:, 0])
            if merge == "fused":
                # one payload a chunk, its lo then its hi queries: ONE
                # kernel reads their rows and sums the shards
                occ = fused_occ(sh, torch.stack([torch.cat([c, c]) for c in cs]),
                                torch.stack([torch.cat(s) for s in state]))
                news = [
                    (sh.C[c.long()] + occ[m, :Bc], sh.C[c.long()] + occ[m, Bc:])
                    for m, c in enumerate(cs)
                ]
            else:
                news = [
                    backward_step(sh, c, *state[m], step_merge) for m, c in enumerate(cs)
                ]
            state = [
                (torch.where(a, nlo, lo), torch.where(a, nhi, hi))
                for a, (nlo, nhi), (lo, hi) in zip(actives, news, state)
            ]
        lo = torch.cat([s[0] for s in state])
        hi = torch.cat([s[1] for s in state])
        pos = locate(sh, lo.clamp(0, sh.n))
        return lo, hi, torch.where(hi > lo, pos, -1)

    return fn
