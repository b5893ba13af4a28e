"""Interval shards held by separate processes: each process uploads the
shards it holds and maps every other process's, so that any process reads
any shard's rows without a copy.  The counterpart of the JAX package's
interval axis across devices and hosts (``parallel/mesh.py``,
``parallel/multihost.py``), where each device holds its own shard and the
ring kernels read the others' partials by remote DMA.

The route follows the device of the tensors, as every kernel wrapper of the
port does:

- on the card, CUDA IPC: ``torch.multiprocessing.reductions.reduce_tensor``
  exports a tensor (its caching-allocator segment and the tensor's offset
  in it), the exports are exchanged with ``all_gather_object`` over the
  gloo group, and ``rebuild_cuda_tensor`` maps each peer's.  The mapped
  pointers are device pointers of this process: a kernel reads a peer's
  shard as it reads its own.  The processes share one card; shards on
  several cards (peer access, NCCL) are later work;
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


class Shards(Sequence):
    """One table's S interval shards, wherever they live: ``self[s]`` is
    shard s's ``(R, ...)`` tensor, this process's own or mapped from the
    process that holds it.  ``held`` is this process's consecutive shards
    (``layout.held``) as the one ``(h, R, ...)`` tensor it uploaded.
    ``shape`` is the stacked table's, ``(S, R, ...)``."""

    def __init__(self, parts, held: torch.Tensor):
        self.parts = tuple(parts)
        self.held = held

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


def barrier(group) -> None:
    """The host-side order between processes: every process's earlier work
    on its stream is complete, and every process has reached this point."""
    if group is None:
        return
    if torch.cuda.is_initialized():  # a process that never used the card has no work there
        torch.cuda.current_stream().synchronize()
    dist.barrier(group=group)


def share(own: torch.Tensor, group) -> list[torch.Tensor]:
    """Every process's ``own`` (contiguous, non-empty) in group rank order:
    this process's own, the others mapped, not copied.  On the CPU ``own``
    is first copied to shared memory, and the entry at this process's rank
    is that shared tensor: write there for the others to see it.  A
    collective: every process of ``group`` calls it with its tensor."""
    if group is None:
        return [own]
    if not own.is_contiguous() or own.numel() == 0:
        raise ValueError(f"share takes a contiguous, non-empty tensor, got {tuple(own.shape)}")
    me = dist.get_rank(group)
    if own.is_cuda:
        from torch.multiprocessing.reductions import rebuild_cuda_tensor, reduce_tensor

        # one export a peer: each export's reference count is released by
        # the one process that maps it
        n = dist.get_world_size(group)
        exports = [None if r == me else reduce_tensor(own)[1] for r in range(n)]
        sent = [None] * n
        dist.all_gather_object(sent, exports, group=group)
        out = [own if r == me else rebuild_cuda_tensor(*sent[r][me]) for r in range(n)]
        for r, t in enumerate(out):
            if t.device != own.device:
                raise ValueError(f"process {r}'s shard lies on {t.device}, this one's on "
                                 f"{own.device}: the processes of an interval group share one "
                                 "card")
        return out
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
    return out


def shards(tables: list[torch.Tensor], layout) -> Shards:
    """Every process's ``(h, R, ...)`` tensor of its consecutive shards, in
    process order (``share``) -> the S shards, each a view of its owner's."""
    per = len(layout.held)
    return Shards([tables[o][s - per * o] for s, o in enumerate(layout.owners)],
                  tables[layout.process_index])


def shard_table(host: np.ndarray, device, layout, group) -> Shards:
    """Upload the shards of a stacked host table ``(S, R, ...)`` that this
    process holds (``layout.held``) as one tensor, and map the other
    processes' -> ``Shards``."""
    held = layout.held
    return shards(share(_upload(host[held.start : held.stop], device), group), layout)


def release(group, drop) -> None:
    """Teardown of mapped tensors: a barrier (every process is done
    reading), ``drop()`` (the caller lets go of everything it mapped or
    holds here, which closes the mappings), a second barrier; after it each
    process may free what it exported.  A collective."""
    if group is None:
        drop()
        return
    barrier(group)
    drop()
    gc.collect()
    barrier(group)
