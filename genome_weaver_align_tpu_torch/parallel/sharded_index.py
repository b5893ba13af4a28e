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

In one process all shards live on one device, stacked on a leading shard
axis S as in the JAX package's host layout.  Under
``multihost.initialize_distributed`` a layout whose interval axis spans
interval groups of g processes (``mesh.make_layout``) gives each process
S / g of the shards.  On the mapped route (every group on one host)
``put_sharded`` maps the other members' on their cards (``parallel.peer``):
the big tables become ``peer.Shards``, one tensor a shard.  Every
``local_*`` function answers a query for all S shards at once, wherever
they live, and returns ``(S, ...)`` partials.  A ``merge`` takes those
partials and returns the ``(...)`` sum: ``parts.sum(0)`` by default (the
analogue of ``psum``), or the ring kernels of ``parallel.ring``; across
processes the exact search merges each process's own shards' partials
(``make_sharded_exact_search``).  On the collective route (a group spans
hosts, where CUDA IPC cannot reach) each process uploads only its own
shards and reads them through ``held_index``; every step is answered from
them and merged by one ``all_reduce`` over the group (``held_step``,
``locate_collective``), as the JAX ``psum`` does across hosts.  Words are
int32 tensors holding the uint32 bits, as in ``ops.rank``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ..index.build import BLOCK_BASES, WORDS_PER_BLOCK, FMIndexData
from ..ops import rank
from ..ops.rank import MARK_BLOCK_BITS, MARK_WORDS_PER_BLOCK
from . import multihost as mh
from . import peer, ring
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
# the tables that shrink with the shards (each process uploads its own);
# the bounds and C are every process's
_TABLES = ("bwt_blocks", "occ_cp", "mark_blocks", "mark_cp", "ssa_values")
_BOUNDS = tuple(f for f in _STACKED if f not in _TABLES)


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


def _cuts(cuts, total: int, n_shards: int) -> list[int]:
    """The block cuts of a split: ``cuts`` checked, or equal widths of
    ceil(total / n_shards) blocks (the last shards may start past the end)."""
    if cuts is None:
        width = -(-total // n_shards)
        return [s * width for s in range(n_shards + 1)]
    cuts = [int(c) for c in cuts]
    if len(cuts) != n_shards + 1 or cuts[0] != 0 or any(b < a for a, b in zip(cuts, cuts[1:])):
        raise ValueError(f"expected {n_shards + 1} non-decreasing block cuts from 0, got {cuts}")
    return cuts


def shard_fm_index(fm: FMIndexData, n_shards: int, pk_cuts=None,
                   row_cuts=None) -> ShardedFMIndex:
    """Host-side split of FMIndexData into n_shards stacked slices (numpy;
    array for array the JAX package's split).  Shard s owns packed blocks
    [pk_cuts[s], pk_cuts[s + 1]) of 128 coordinates and mark blocks
    [row_cuts[s], row_cuts[s + 1]) of 128 rows; by default the cuts are
    equal widths, ceil(blocks / n_shards).  Explicit cuts (n_shards + 1
    non-decreasing block counts from 0) give unequal shards, the tables
    padded to the widest."""
    n = fm.n
    # ---- packed space
    nb_total = fm.bwt_words.size // WORDS_PER_BLOCK  # includes +1 pad block
    pk_cuts = _cuts(pk_cuts, nb_total, n_shards)
    nbs = max(b - a for a, b in zip(pk_cuts, pk_cuts[1:]))
    bwt = np.zeros((n_shards, nbs + 1, WORDS_PER_BLOCK), dtype=np.uint32)
    occ = np.zeros((n_shards, nbs + 1, 4), dtype=np.int32)
    blocks = fm.bwt_words.reshape(nb_total, WORDS_PER_BLOCK)
    pk_start = np.zeros(n_shards, np.int32)
    pk_end = np.zeros(n_shards, np.int32)
    for s in range(n_shards):
        b0 = pk_cuts[s]
        b1 = min(nb_total, pk_cuts[s + 1] + 1)  # +1: boundary block overlap
        if b0 < nb_total:
            bwt[s, : b1 - b0] = blocks[b0:b1]
            occ[s, : b1 - b0] = fm.occ_cp[b0:b1].astype(np.int32)
        # clamped, disjoint, and covering [0, n]: the +1-padded final block
        # guarantees (nb_total)*BLOCK_BASES > n, so k == n has an owner
        pk_start[s] = min(b0 * BLOCK_BASES, n + 1)
        pk_end[s] = min(pk_cuts[s + 1] * BLOCK_BASES, n + 1)
    # ---- row space
    marks = fm.ssa_marks
    mw = marks._wpad  # (mb_total * 4,) uint32 words over n+1 rows
    mb_total = mw.size // MARK_WORDS_PER_BLOCK
    row_cuts = _cuts(row_cuts, mb_total, n_shards)
    mbs = max(b - a for a, b in zip(row_cuts, row_cuts[1:]))
    mblk = np.zeros((n_shards, mbs, MARK_WORDS_PER_BLOCK), dtype=np.uint32)
    mcp = np.zeros((n_shards, mbs + 1), dtype=np.int32)
    row_start = np.zeros(n_shards, np.int32)
    row_end = np.zeros(n_shards, np.int32)
    mwords = mw.reshape(mb_total, MARK_WORDS_PER_BLOCK)
    cps = marks.checkpoints.astype(np.int32)  # (mb_total+1,)
    ssa_base = np.zeros(n_shards, np.int32)
    ssa_parts = []
    for s in range(n_shards):
        b0 = row_cuts[s]
        b1 = min(mb_total, row_cuts[s + 1])
        if b0 < mb_total:
            mblk[s, : b1 - b0] = mwords[b0:b1]
            mcp[s, : b1 - b0 + 1] = cps[b0 : b1 + 1]
        row_start[s] = min(b0 * MARK_BLOCK_BITS, n + 1)
        row_end[s] = min(row_cuts[s + 1] * MARK_BLOCK_BITS, n + 1)
        ssa_base[s] = cps[min(b0, mb_total)]
        lo_rank = int(ssa_base[s])
        hi_rank = int(cps[min(row_cuts[s + 1], mb_total)])
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


def put_tables(host, device, layout: ShardLayout, tables, small):
    """Upload a sharded structure's ``tables`` and its ``small`` bounds to
    ``device`` as int32 tensors (uint32 words keep their bits).  In one
    process, or with a layout whose interval axis spans none, all shards
    go on the one device, stacked.  With a layout whose interval axis spans
    the processes, each uploads the shards of ``tables`` it holds
    (``layout.held``): on the mapped route it maps every other process's,
    and they become ``peer.Shards`` (a collective: every process of the
    interval group calls it); on the collective route it maps nothing, and
    each table is the ``(h, R, ...)`` tensor of its own shards alone (read
    it through ``held_index``).  The small bounds are every shard's."""
    spread = layout is not None and layout.interval_procs > 1

    def big(a):
        if not spread:
            return rank._upload(a, device)
        if layout.collective:
            return rank._upload(a[layout.held.start : layout.held.stop], device)
        return peer.shard_table(a, device, layout, layout.group)

    kw = {f: big(np.asarray(getattr(host, f))) for f in tables}
    kw.update({f: rank._upload(np.asarray(getattr(host, f)), device) for f in small})
    return dataclasses.replace(host, **kw)


def put_sharded(sh: ShardedFMIndex, device, layout: ShardLayout = None) -> ShardedFMIndex:
    """The index's shards on ``device`` (``put_tables``: across processes
    each uploads its own and maps the others')."""
    if layout is not None and layout.n_interval != sh.n_shards:
        raise ValueError(f"a layout of {layout.n_interval} shards for an index of {sh.n_shards}")
    return put_tables(sh, device, layout, _TABLES, (*_BOUNDS, "C"))


def held_tables(obj, layout: ShardLayout, tables, small):
    """A sharded structure's shards that this process holds, as a stacked
    structure of their own: each of ``tables`` its held ``(h, R, ...)``
    tensor (a ``peer.Shards``' ``held``, or the table itself on the
    collective route, which uploads nothing else) and each of ``small``
    cut to the held shards; ``obj`` itself in the stacked layout."""
    if layout.interval_procs == 1:
        return obj
    held = layout.held
    kw = {f: getattr(obj, f).held if isinstance(getattr(obj, f), peer.Shards)
          else getattr(obj, f) for f in tables}
    kw.update({f: getattr(obj, f)[held.start : held.stop] for f in small})
    return dataclasses.replace(obj, **kw)


def held_index(sh: ShardedFMIndex, layout: ShardLayout) -> ShardedFMIndex:
    """The shards this process holds, as a stacked index of their own
    (``local_*`` partials of these shards only): ``sh`` itself in the
    stacked layout."""
    own = held_tables(sh, layout, _TABLES, _BOUNDS)
    return own if own is sh else dataclasses.replace(own, n_shards=len(layout.held))


# ---- local (per-shard) queries, vectorised over the shard axis: a query of
# shape (...) gives (S, ...) partials; non-owners contribute 0.


def _col(v: torch.Tensor, ndim: int) -> torch.Tensor:
    """(S,) -> (S, 1, ..., 1) broadcasting against (1, *query_shape)."""
    return v.reshape((-1,) + (1,) * ndim)


def shard_rows(table, idx: torch.Tensor) -> torch.Tensor:
    """table (S, R, ...), stacked or ``peer.Shards``, gathered at per-shard
    row indices idx (S, ...).  A mapped shard's tensor lies on this
    process's card whichever card holds its memory (``peer.share``), so
    torch indexes it there, over NVLink for a shard on another card."""
    if not isinstance(table, torch.Tensor):
        return torch.stack([t[i.long()] for t, i in zip(table, idx)])
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
    words = shard_rows(sh.bwt_blocks, b_local)
    cs = codes.to(I32).expand(own.shape)
    base = torch.gather(shard_rows(sh.occ_cp, b_local), -1, cs[..., None].long())[..., 0]
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
    words = shard_rows(sh.bwt_blocks, b_local)  # ONE gather
    cs = codes.to(I32).expand(own.shape)
    base = torch.gather(shard_rows(sh.occ_cp, b_local), -1, cs[..., None].long())[..., 0]
    return words, roff, base, own.to(I32)


def fused_occ_plain(sh: ShardedFMIndex, codes: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """``fused_occ``'s plain version: the int32 sum over shards of
    ``local_occ_codes``."""
    return local_occ_codes(sh, codes, k).sum(0, dtype=I32)


def fused_occ(sh: ShardedFMIndex, codes: torch.Tensor, k: torch.Tensor,
              out: torch.Tensor | None = None) -> torch.Tensor:
    """Merged occ$(codes, k) of queries of any shape (codes 0..3) -> int32
    of that shape, written into ``out`` where given.  On the card one
    kernel reads each query's row from its owner's table
    (``ops.ring_cuda.fused_occ_cuda``: no gathered word tensor); with
    disjoint bounds, as ``shard_fm_index`` cuts them, that owner's count is
    the sum over the shards, and with overlapping bounds the kernel sums
    every owner's count.  A CPU tensor takes ``fused_occ_plain``."""
    if codes.is_cuda:
        from ..ops import ring_cuda

        return ring_cuda.fused_occ_cuda(
            sh.bwt_blocks, sh.occ_cp, sh.pk_start, sh.pk_end, sh.primary,
            codes.to(I32).contiguous(), k.to(I32).contiguous(), out,
        )
    got = fused_occ_plain(sh, codes, k)
    return got if out is None else out.copy_(got)


def local_occ_all4(sh: ShardedFMIndex, k: torch.Tensor) -> torch.Tensor:
    """occ$(c, k) contributions for all four codes: (S, ..., 4)."""
    own, b_local, r = _block_split(sh, k)
    words = shard_rows(sh.bwt_blocks, b_local)
    masks = rank._pair_masks(r)
    counts = [
        rank._match_counts(words, torch.full(own.shape, c, dtype=I32, device=k.device), masks)
        for c in range(4)
    ]
    val = shard_rows(sh.occ_cp, b_local) + torch.stack(counts, dim=-1)
    return torch.where(own[..., None], val, 0)


def local_bwt_char(sh: ShardedFMIndex, i: torch.Tensor) -> torch.Tensor:
    """Owner returns the BWT code at row i, others 0 (so the sum is it)."""
    idx = (i - (i > sh.primary).to(i.dtype)).to(I32)[None]
    ps, pe = _col(sh.pk_start, i.dim()), _col(sh.pk_end, i.dim())
    own = (idx >= ps) & (idx < pe) & (idx < sh.n)
    local = (idx - ps).clamp(min=0)
    b_local = (local // BLOCK_BASES).clamp(0, sh.bwt_blocks.shape[1] - 1)
    row = shard_rows(sh.bwt_blocks, b_local)
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
    row = shard_rows(sh.mark_blocks, b)
    w = torch.gather(row, -1, ((local % MARK_BLOCK_BITS) // 32)[..., None].long())[..., 0]
    bit = (w >> (local % 32)) & 1
    return torch.where(own, bit, 0)


def local_mark_rank1(sh: ShardedFMIndex, i: torch.Tensor) -> torch.Tensor:
    """Global rank1(i) contribution (checkpoints hold global values)."""
    own, local, b = _row_split(sh, i)
    words = shard_rows(sh.mark_blocks, b)
    rem = local - b * MARK_BLOCK_BITS
    j = 32 * torch.arange(MARK_WORDS_PER_BLOCK, dtype=I32, device=i.device)
    masks = rank._low_bits((rem[..., None] - j).clamp(0, 32))
    part = rank._popcount(words & masks).sum(dim=-1, dtype=I32)
    return torch.where(own, shard_rows(sh.mark_cp, b) + part, 0)


def local_ssa_value(sh: ShardedFMIndex, i: torch.Tensor, global_rank: torch.Tensor) -> torch.Tensor:
    own, _, _ = _row_split(sh, i)
    slot = (global_rank.to(I32)[None] - _col(sh.ssa_base, i.dim()))
    slot = slot.clamp(0, sh.ssa_values.shape[1] - 1)
    return torch.where(own, shard_rows(sh.ssa_values, slot), 0)


# ---- merged primitives: a merge maps (S, ...) partials to their (...) sum.


def default_merge(parts: torch.Tensor) -> torch.Tensor:
    """The analogue of ``psum``: the int32 sum over the shard axis."""
    return parts.sum(0, dtype=I32)


def ring_merge(parts: torch.Tensor) -> torch.Tensor:
    """The ring all-reduce (``parallel.ring.ring_psum``); shard 0's copy, the
    only output the kernel writes."""
    return ring.ring_psum(parts, only=0)


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


def held_step(own, codes, lo, hi, merge):
    """One interval update answered by the shards ``own`` this process
    holds and merged across its interval group by ``merge``.  On the card
    the held shards' lo and hi partials come from one launch of the fused
    table entry (``fused_occ``: a coordinate no held shard owns adds 0),
    merged as one ``(1, 2, ...)`` payload; on the CPU ``backward_step``'s
    ``(h, 2, ...)`` partials.  The sharded piece search and the exact
    search's psum share it."""
    if not codes.is_cuda:
        return backward_step(own, codes, lo, hi, merge)
    occ_lo, occ_hi = merge(fused_occ(own, torch.stack([codes, codes]), torch.stack([lo, hi]))[None])
    Cc = own.C[codes.long()]
    return Cc + occ_lo, Cc + occ_hi


def lf(sh, i, merge=None):
    merge = merge or default_merge
    c = merge(local_bwt_char(sh, i))
    return sh.C[c.long()] + merge(local_occ_codes(sh, c, i))


def local_lf(sh: ShardedFMIndex, i: torch.Tensor) -> torch.Tensor:
    """Each shard's contribution to ``lf(i)``: the owner of i's packed
    coordinate gives C[c] + occ(c, i) with c its own BWT character at i,
    the others 0.  ``shard_fm_index``'s packed ranges are disjoint and
    cover [0, n], so one shard owns each row, its c is the merged one, and
    the sum over the shards is ``lf``'s value: one merge where ``lf`` makes
    two."""
    own, _, _ = _block_split(sh, i)
    c = local_bwt_char(sh, i)
    return torch.where(own, sh.C[c.long()] + local_occ_codes(sh, c, i), 0)


def local_ssa_at(sh: ShardedFMIndex, i: torch.Tensor) -> torch.Tensor:
    """Each shard's contribution to the sampled value at a marked row i:
    the owner of the row reads its global rank and its value, the others
    0 (one merge where the walk's tail makes two)."""
    own, _, _ = _row_split(sh, i)
    slot = local_mark_rank1(sh, i) - _col(sh.ssa_base, i.dim())
    slot = slot.clamp(0, sh.ssa_values.shape[1] - 1)
    return torch.where(own, shard_rows(sh.ssa_values, slot), 0)


def locate_collective(own: ShardedFMIndex, rows: torch.Tensor, merge) -> torch.Tensor:
    """``locate``'s LF walk over the shards ``own`` this process holds,
    merged across its interval group by ``merge`` (``(h, ...)`` partials to
    the group's sum) once a step: the stacked (marked, next row) partials
    (``local_mark_get``, ``local_lf``), then one merge of the sampled
    value (``local_ssa_at``): ``sample_rate + 1`` merges where the JAX
    walk makes three a step and two at its end, with exactly its values
    (the owner of a row computes each fused quantity whole).  Every
    process of the group passes the same rows."""
    i = rows.to(I32)
    d = torch.zeros_like(i)
    for _ in range(own.sample_rate):
        marked, nxt = merge(torch.stack([local_mark_get(own, i), local_lf(own, i)], dim=1))
        marked = marked > 0
        i, d = torch.where(marked, i, nxt), torch.where(marked, d, d + 1)
    return merge(local_ssa_at(own, i)) + d


def locate(sh, rows):
    """Text positions of BWT rows (values in [0, n]) over the shards.  On a
    CUDA device one kernel walks each row, reading every step from the
    shards that own it (``ops.locate_cuda.locate_sharded_cuda``,
    ``csrc/locate.cu``); on the CPU, ``locate_plain``."""
    if rows.is_cuda:
        from ..ops import locate_cuda

        return locate_cuda.locate_sharded_cuda(sh, rows.to(I32).contiguous())
    return locate_plain(sh, rows)


def locate_plain(sh, rows, merge=None):
    """LF walk of exactly ``sample_rate`` steps with merges per step (the
    kernel's plain version)."""
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


# The merges across processes by route, counted where each runs: psum over
# NCCL on the card or gloo on the host; ring by the flag wait or behind a
# host barrier; the collective route's verify gathers (chip_smoke.py [20]
# and [22] read them)
CROSS_MERGES = dict.fromkeys(("psum nccl", "psum gloo", "ring flag wait", "ring host barrier",
                              "all_gather nccl", "all_gather gloo"), 0)


def group_nccl(layout: ShardLayout, dev: torch.device):
    """The NCCL group of this process's interval group where its tensors
    lie on the card and ``initialize_distributed`` made one (its members
    on distinct cards), else None (gloo on the host)."""
    return mh.nccl_group(layout.interval_procs) if dev.type == "cuda" else None


def hosts_apart(layout: ShardLayout) -> list[str]:
    """Two hosts of the first interval group that spans hosts (none on the
    mapped route)."""
    for ranks in mh.groups_of(layout.process_count, layout.interval_procs):
        hosts = list(dict.fromkeys(mh.host_of(r) for r in ranks))
        if len(hosts) > 1:
            return hosts[:2]
    return []


def gather_across(group, nccl):
    """``all_gather`` across the interval group, concatenated along the
    last axis in group order (the JAX ``all_gather(tiled=True)`` over an
    interval axis that spans processes): over ``nccl`` on the device
    tensor, else over gloo on the host."""
    def gather(x: torch.Tensor) -> torch.Tensor:
        y = x.contiguous() if nccl is not None else x.cpu().contiguous()
        parts = [torch.empty_like(y) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, y, group=group if nccl is None else nccl)
        CROSS_MERGES["all_gather gloo" if nccl is None else "all_gather nccl"] += 1
        return torch.cat(parts, dim=-1).to(x.device)

    return gather


def _psum_across(group, nccl):
    """The psum merge across processes: each process's own shards' partials
    summed, then ``all_reduce`` over the interval group (the JAX ``psum``
    over an interval axis that spans processes): over the NCCL group
    ``nccl`` on the device tensor where the group's processes lie on
    separate cards, else over gloo on the host."""
    def merge(parts: torch.Tensor) -> torch.Tensor:
        x = parts.sum(0, dtype=I32)
        if nccl is not None:
            dist.all_reduce(x, group=nccl)
            CROSS_MERGES["psum nccl"] += 1
            return x
        x = x.cpu()
        dist.all_reduce(x, group=group)
        CROSS_MERGES["psum gloo"] += 1
        return x.to(parts.device)

    return merge


class _RingSlots:
    """The ring merge across processes.  Each member of the interval group
    holds two inboxes, taken in turn (merge i uses inbox i % 2), each a
    ``(P, ...)`` tensor mapped by every member (``peer.share``): row q is
    member q's partial.  A chunk-step (``step``) writes this process's
    partial, its held shards' sum, into its row of its own inbox (on the
    card one launch of the fused table entry, ``fused_occ(out=...)``; on
    the CPU ``backward_step``'s partials summed), and one launch merges the
    group's P rows in group order.  Two orders between the processes,
    picked by the layout:

    - one card a process (``apart``): the flag-wait entry, prepared once
      (``ops.ring_cuda.FlagWait``: every check, pointer array and output
      made here; a merge is one ctypes call with its epoch).  The kernel
      pushes this process's row into every peer's inbox over NVLink and
      publishes the epoch into every peer's flag words, one a block, then
      waits until every peer's block has published it and sums from its
      own inbox, so the host orders nothing.  A wait that times out sets
      the error word and poisons the peers' waits, which set theirs;
      ``check`` raises in every process;
    - processes that share a card (or the CPU): a stream synchronize and a
      barrier between a process's write of its row and any read of it,
      then the sum kernel reads each member's row from its inbox (no
      kernel waits on another process's flag: the card time-slices their
      kernels).

    Either way every process finished reading inbox i % 2 in merge i - 2
    before it could pass merge i - 1's barrier or flag wait."""

    def __init__(self, layout: ShardLayout, group, shape, device, apart: bool):
        from ..ops.ring_cuda import WAIT_BLOCKS, FlagWait

        P = layout.interval_procs
        self.group, self.me, self.turn = group, layout.group_rank, 0
        # one shared buffer a process, one mapping a peer: the flag words
        # (across cards), then the two inboxes, each 16-byte aligned
        n = P * int(np.prod(shape))
        box = -(-n // 4) * 4
        words = P * WAIT_BLOCKS if apart else 0
        bufs = peer.share(torch.zeros(words + 2 * box, dtype=I32, device=device), group)
        self.inboxes = [[b[words + s * box : words + s * box + n].view(P, *shape) for b in bufs]
                        for s in range(2)]
        self.error = self.wait = None
        if apart:
            self.error = torch.zeros(1, dtype=I32, device=device)
            self.wait = FlagWait(self.inboxes, [b[:words].view(P, WAIT_BLOCKS) for b in bufs],
                                 self.me, self.error)

    def close(self) -> None:
        """Let go of the inboxes and flags, this process's and the mapped
        ones: the last references (``peer.release(..., collect=False)``)."""
        self.inboxes, self.wait = [], None

    def check(self) -> None:
        """Raise if a flag wait timed out (a synchronise)."""
        if self.error is not None:
            from ..ops import ring_cuda

            ring_cuda.check_flag_wait(self.error)

    def row(self) -> torch.Tensor:
        """This process's row of the inbox the next merge takes: write its
        partial there."""
        return self.inboxes[self.turn % 2][self.me][self.me]

    def merge(self) -> torch.Tensor:
        """The group's sum of the rows of the next merge's inbox."""
        slot = self.turn % 2
        self.turn += 1
        if self.wait is None:
            peer.barrier(self.group)
            CROSS_MERGES["ring host barrier"] += 1
            return ring.ring_psum([box[q] for q, box in enumerate(self.inboxes[slot])],
                                  only=self.me)
        CROSS_MERGES["ring flag wait"] += 1
        return self.wait(slot, self.turn)

    def __call__(self, parts: torch.Tensor) -> torch.Tensor:
        """``(h, ...)`` partials of the held shards -> the group's sum."""
        torch.sum(parts, 0, dtype=I32, out=self.row())
        return self.merge()

    def step(self, own, codes, lo, hi):
        """``held_step`` with this merge: the held shards' lo and hi
        partials written straight into this process's row."""
        if not codes.is_cuda:
            return backward_step(own, codes, lo, hi, self)
        fused_occ(own, torch.stack([codes, codes]), torch.stack([lo, hi]), out=self.row())
        occ_lo, occ_hi = self.merge()
        Cc = own.C[codes.long()]
        return Cc + occ_lo, Cc + occ_hi


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
    the results are the same for every chunking.  The located positions
    come from ``locate``: one kernel on a CUDA device, whatever ``merge``
    (on the collective route, ``locate_collective``).  ``like`` is
    accepted for the JAX signature; nothing is read from it.

    When the layout's interval axis spans interval groups of processes,
    every process of a group takes the group's reads (``mesh.shard_reads``
    with a data axis over the groups: each group its slice, as the devices
    of a JAX interval group take the same reads; a layout whose data axis
    spans the processes is refused), and the merges cross the
    group's processes: "psum" sums each process's own shards' partials
    (``held_step``) and ``all_reduce``s them over the group (NCCL on the
    card where the processes hold their shards on separate cards,
    ``peer.apart``; gloo on the host where they share one), "ring" writes
    each process's held partial into its row of its inbox and merges the
    group's rows in one kernel (``_RingSlots``: pushed over NVLink behind a
    flag wait in the kernel across cards, a host barrier on one card; a
    wait that fails, here or in a peer, makes the search raise at its
    end), and
    "fused" needs
    no exchange: the table entry reads each query's row from the shard
    that owns it, through the peer map, on whichever card it lies.  Every
    process of a group gets the group's whole result.  ``CROSS_MERGES``
    counts the merges by route.

    On the collective route (``layout.collective``: an interval group
    spans hosts) only "psum" runs, as the JAX ``psum`` does across hosts:
    each step's held partials ``all_reduce``d over the group (NCCL where
    its members have cards of their own, else gloo), and the final locate
    is ``locate_collective``.  "ring" and "fused" read the other members'
    memory, which cannot cross a host: they raise, naming two hosts.
    """
    if merge not in ("psum", "ring", "fused"):
        raise ValueError(f"merge={merge!r}: expected psum, ring or fused")
    if layout.interval_procs > 1 and layout.data_procs == layout.process_count:
        # each process of a group would search other reads than its peers,
        # and the merges would add up partials of different reads
        raise ValueError(
            f"the exact search's data axis ({layout.n_data}) spans the {layout.process_count} "
            f"processes, but its interval groups of {layout.interval_procs} need the same reads "
            f"in every member: make the layout with n_data = {layout.groups} (or 1)")
    if layout.collective and merge != "psum":
        a, b = hosts_apart(layout)
        raise ValueError(f"merge={merge!r} reads the other members' shards or slots directly, "
                         f"which cannot cross a host: an interval group spans hosts {a!r} and "
                         f"{b!r} (use merge='psum')")
    group = layout.group

    def fn(sh: ShardedFMIndex, reads: torch.Tensor, lengths: torch.Tensor):
        B, L = reads.shape
        dev = reads.device
        reads = reads.to(I32)
        lengths = lengths.to(I32)
        mb = microbatch if B % microbatch == 0 else 1
        Bc = B // mb
        own = held_index(sh, layout)  # the partials' shards: this process's
        apart = group is not None and not layout.collective and peer.apart(sh.bwt_blocks,
                                                                            layout)
        if group is None:
            step_merge = ring_merge if merge == "ring" else default_merge
        elif layout.collective:
            step_merge = _psum_across(group, group_nccl(layout, dev))
        elif merge == "ring":
            step_merge = _RingSlots(layout, group, (2, Bc), dev, apart)
        elif merge == "psum":
            nccl = mh.nccl_group(layout.interval_procs) if apart else None
            if apart and nccl is None:
                raise RuntimeError("the interval group's processes hold their shards on "
                                   "separate cards, but initialize_distributed made no NCCL "
                                   "group for them (their recorded cards differ from the "
                                   "shards' cards)")
            step_merge = _psum_across(group, nccl)
        else:
            step_merge = None  # fused: the table entry reads every shard, no exchange
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
            elif isinstance(step_merge, _RingSlots):
                # the held shards' partial straight into this process's row
                news = [step_merge.step(own, c, *state[m]) for m, c in enumerate(cs)]
            else:
                # the psum across processes sums the held partials first:
                # one table-entry launch gives them
                step = held_step if group is not None else backward_step
                news = [step(own, c, *state[m], step_merge) for m, c in enumerate(cs)]
            state = [
                (torch.where(a, nlo, lo), torch.where(a, nhi, hi))
                for a, (nlo, nhi), (lo, hi) in zip(actives, news, state)
            ]
        if isinstance(step_merge, _RingSlots):
            peer.release(group, step_merge.close, collect=False)
            step_merge.check()
        lo = torch.cat([s[0] for s in state])
        hi = torch.cat([s[1] for s in state])
        pos = (locate_collective(own, lo.clamp(0, sh.n), step_merge) if layout.collective
               else locate(sh, lo.clamp(0, sh.n)))
        return lo, hi, torch.where(hi > lo, pos, -1)

    return fn
