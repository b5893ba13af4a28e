"""Interval shards held by separate processes: each process uploads the
shards it holds and maps every other process's of its interval group, so
that any process reads any shard's rows without a copy.  The counterpart of
the JAX package's interval axis across devices and hosts
(``parallel/mesh.py``, ``parallel/multihost.py``), where each device holds
its own shard and the ring kernels read the others' partials by remote DMA.

The route follows the device of the tensors, as every kernel wrapper of the
port does:

- on the card, CUDA IPC: ``torch.multiprocessing.reductions.reduce_tensor``
  exports a tensor (its caching-allocator segment and the tensor's offset
  in it), the exports are exchanged with ``all_gather_object`` over the
  gloo group, and ``rebuild_cuda_tensor`` maps each peer's.  The handle is
  opened on this process's card, whichever card holds the memory: torch
  opens it there with ``cudaIpcMemLazyEnablePeerAccess``, so the mapping
  of a shard on another card is a peer mapping that this card's kernels
  read over NVLink, and no process makes a CUDA context on a card not its
  own (opened on the holder's card, the pointer is not valid on this one:
  a kernel that reads it faults).  The mapped tensor's ``device`` is
  therefore this process's card, and every kernel wrapper and torch op
  takes it as a tensor of this card; the card that holds it is in
  ``Shared.cards``.  Before it maps a peer on another card, ``share``
  checks that this card reaches it (``check_reach``:
  ``torch.cuda.can_device_access_peer``; else it raises, naming both
  cards);
- on the CPU, shared memory: each tensor is written once to a file in the
  temporary directory and mapped by every process with
  ``torch.from_file(shared=True)``; the file is removed once every process
  has mapped it.

Teardown (``release``): a barrier, every process drops its mapped peers,
a second barrier; only then may a process free the tensors it exported.
No fallback: a process that cannot map a peer's tensor raises.
"""

from __future__ import annotations

import gc
import os
import tempfile
from collections.abc import Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..ops.rank import _upload

# the place of the exporter's device among rebuild_cuda_tensor's arguments
# (torch.multiprocessing.reductions.reduce_tensor's export of a CUDA tensor)
_DEVICE = 6


class Shared(list):
    """``share``'s result: every process's tensor in group rank order, and
    ``cards``, the card that holds each (None on the CPU)."""

    def __init__(self, tensors, cards):
        super().__init__(tensors)
        self.cards = tuple(cards)


class Shards(Sequence):
    """One table's S interval shards, wherever they live: ``self[s]`` is
    shard s's ``(R, ...)`` tensor, this process's own or mapped from the
    process that holds it, on this process's card or another.  ``held`` is
    this process's consecutive shards (``layout.held``) as the one
    ``(h, R, ...)`` tensor it uploaded.  ``shape`` is the stacked table's,
    ``(S, R, ...)``; ``device`` is ``held``'s; ``cards`` the card that
    holds each shard (a mapped shard's tensor lies on this process's card
    as a peer mapping: ``share``)."""

    def __init__(self, parts, held: torch.Tensor, cards=None):
        self.parts = tuple(parts)
        self.held = held
        self.cards = tuple(cards) if cards is not None else tuple(
            t.device.index for t in self.parts)

    def __getitem__(self, s):
        return self.parts[s]

    def __len__(self) -> int:
        return len(self.parts)

    @property
    def shape(self) -> tuple:
        return (len(self.parts), *self.parts[0].shape)

    @property
    def device(self) -> torch.device:
        return self.held.device

    @property
    def dtype(self) -> torch.dtype:
        return self.held.dtype


def apart(table: Shards, layout) -> bool:
    """Whether each process of the interval group holds its shards of
    ``table`` on a card of its own: the merges across processes then reach
    the other cards directly (NCCL, the flag wait) instead of being ordered
    from the host, as processes that share a card must be."""
    return table.held.is_cuda and len(set(table.cards)) == layout.interval_procs


def barrier(group) -> None:
    """The host-side order between processes: every process's earlier work
    on its stream is complete, and every process has reached this point."""
    if group is None:
        return
    if torch.cuda.is_initialized():  # a process that never used the card has no work there
        torch.cuda.current_stream().synchronize()
    dist.barrier(group=group)


def check_reach(own: int, theirs: int) -> None:
    """Raise, naming both cards, unless kernels on card ``own`` can read
    memory on card ``theirs`` (a card reads its own): there is no
    fallback."""
    if own != theirs and not torch.cuda.can_device_access_peer(own, theirs):
        raise RuntimeError(f"card cuda:{own} cannot reach card cuda:{theirs} (no peer access): "
                           "its kernels cannot read a shard held there")


def share(own: torch.Tensor, group) -> Shared:
    """Every process's ``own`` (contiguous, non-empty) in group rank order:
    this process's own, the others mapped on this process's device, not
    copied, with the card that holds each.  On the CPU ``own`` is first
    copied to shared memory, and the entry at this process's rank is that
    shared tensor: write there for the others to see it.  A collective:
    every process of ``group`` calls it with its tensor."""
    if group is None:
        return Shared([own], [own.device.index])
    if not own.is_contiguous() or own.numel() == 0:
        raise ValueError(f"share takes a contiguous, non-empty tensor, got {tuple(own.shape)}")
    me = dist.get_rank(group)
    if own.is_cuda:
        from torch.multiprocessing.reductions import rebuild_cuda_tensor, reduce_tensor

        # written before it is exported: a peer may write into it (the flag
        # words) or read it as soon as it is mapped
        torch.cuda.current_stream(own.device).synchronize()
        # one export a peer: each export's reference count is released by
        # the one process that maps it
        n = dist.get_world_size(group)
        exports = [None if r == me else reduce_tensor(own)[1] for r in range(n)]
        sent = [None] * n
        dist.all_gather_object(sent, exports, group=group)
        here = own.device.index
        cards = [here if r == me else sent[r][me][_DEVICE] for r in range(n)]
        if not all(isinstance(c, int) for c in cards):
            raise RuntimeError(f"unexpected CUDA export layout: devices {cards}")
        for theirs in cards:
            check_reach(here, theirs)
        # opened on this card (the export's device replaced by this one's)
        out = [own if r == me else rebuild_cuda_tensor(
            *sent[r][me][:_DEVICE], here, *sent[r][me][_DEVICE + 1:]) for r in range(n)]
        return Shared(out, cards)
    fd, path = tempfile.mkstemp(prefix="gwa-shard-")
    with os.fdopen(fd, "wb") as fh:
        own.numpy().tofile(fh)
    sent = [None] * dist.get_world_size(group)
    dist.all_gather_object(sent, (path, tuple(own.shape), str(own.dtype)), group=group)
    out = []
    for p, shape, dtype in sent:
        dt = getattr(torch, dtype.split(".")[-1])
        n = int(np.prod(shape))
        out.append(torch.from_file(p, shared=True, size=n, dtype=dt).view(shape))
    dist.barrier(group=group)  # every process has mapped every file
    os.unlink(path)
    return Shared(out, [None] * len(out))


def shards(tables: Shared, layout) -> Shards:
    """Every process's ``(h, R, ...)`` tensor of its consecutive shards, in
    process order (``share``) -> the S shards, each a view of its owner's."""
    per = len(layout.held)
    return Shards([tables[o][s - per * o] for s, o in enumerate(layout.owners)],
                  tables[layout.group_rank], [tables.cards[o] for o in layout.owners])


def shard_table(host: np.ndarray, device, layout, group) -> Shards:
    """Upload the shards of a stacked host table ``(S, R, ...)`` that this
    process holds (``layout.held``) as one tensor, and map the other
    processes' -> ``Shards``."""
    held = layout.held
    return shards(share(_upload(host[held.start : held.stop], device), group), layout)


def release(group, drop, collect: bool = True) -> None:
    """Teardown of mapped tensors: a barrier (every process is done
    reading), ``drop()`` (the caller lets go of everything it mapped or
    holds here, which closes the mappings), a garbage collection (for
    mappings held in reference cycles; ``collect=False`` where ``drop``
    lets go of the last reference itself), a second barrier; after it each
    process may free what it exported.  A collective."""
    if group is None:
        drop()
        return
    barrier(group)
    drop()
    if collect:
        gc.collect()
    barrier(group)
