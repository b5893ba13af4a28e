"""Shard layout across processes: the torch counterpart of
``genome_weaver_align_tpu.parallel.mesh``.

Axes keep the JAX package's names:

- ``data``     — read-cohort data parallelism across processes
                 (``parallel.multihost``): with ``n_data`` > 1 the axis
                 spans the processes, and ``shard_reads`` pads the batch to
                 a multiple of ``n_data`` and uploads this process's slice,
                 by the process index and count the layout recorded when it
                 was made.  With ``n_data`` = 1 every process takes the whole
                 batch, as every device of a JAX interval group does.  In
                 one process it is only padding, and the outputs, sliced to
                 the batch, are the same for every ``n_data``.
- ``interval`` — BWT-interval index sharding into ``n_interval`` shards.
                 In one process every sharded table keeps a leading shard
                 axis of size ``n_interval`` on ``device`` (the stacked
                 layout).  Under ``multihost.initialize_distributed`` with P
                 processes and ``n_interval`` > 1 the axis spans them: each
                 process holds ``n_interval / P`` consecutive shards (``held``)
                 and maps every other process's (``parallel.peer``); P must
                 divide ``n_interval``.  Each rank query is answered by its
                 owning shard and the per-shard partials are merged by a sum
                 over the shards (``parallel.ring``, ``parts.sum(0)``, or
                 across processes ``sharded_index.make_sharded_exact_search``'s
                 merges).

The processes of one interval group share one card: shards on several
cards are later work (ROADMAP #16).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import multihost as mh

DATA_AXIS = "data"
INTERVAL_AXIS = "interval"


@dataclass(frozen=True)
class ShardLayout:
    """Stands in for the JAX ``Mesh``: axis sizes, the one device, this
    process's place among the processes, and which of them each axis
    spans: the data axis ``data_procs`` (each owns ``n_data //
    data_procs`` consecutive positions on it), the interval axis
    ``interval_procs`` (each holds ``n_interval // interval_procs``
    consecutive shards)."""

    n_data: int = 1
    n_interval: int = 1
    device: torch.device = torch.device("cuda")
    process_index: int = 0
    process_count: int = 1
    interval_procs: int = 1

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.n_data, INTERVAL_AXIS: self.n_interval}

    @property
    def data_procs(self) -> int:
        """Processes the data axis spans: all of them when n_data > 1."""
        return self.process_count if self.n_data > 1 else 1

    @property
    def held(self) -> range:
        """The shards this process holds."""
        per = self.n_interval // self.interval_procs
        first = per * (self.process_index if self.interval_procs > 1 else 0)
        return range(first, first + per)

    @property
    def owners(self) -> tuple[int, ...]:
        """The process that holds each shard (0 for every shard in the
        stacked layout, where this process holds them all)."""
        per = self.n_interval // self.interval_procs
        return tuple(s // per if self.interval_procs > 1 else 0 for s in range(self.n_interval))


def make_layout(n_data: int = 1, n_interval: int = 1, device="cuda") -> ShardLayout:
    """A layout for this process in the current process group (one process
    when none is initialised): make it after ``initialize_distributed``.
    With P > 1 processes an axis of size > 1 spans them all and P must
    divide it; at least one axis must span them."""
    if n_data < 1 or n_interval < 1:
        raise ValueError(f"axis sizes must be >= 1, got n_data={n_data}, n_interval={n_interval}")
    pi, pc = mh.process_index(), mh.process_count()
    if n_interval > 1 and n_interval % pc:
        raise ValueError(f"the interval axis ({n_interval} shards) must divide across {pc} "
                         f"processes: each holds n_interval / {pc} shards")
    if (n_data > 1 or n_interval == 1) and n_data % pc:
        raise ValueError(f"the data axis ({n_data}) must divide across {pc} processes")
    return ShardLayout(n_data, n_interval, torch.device(device), pi, pc,
                       pc if n_interval > 1 else 1)


def shard_reads(layout: ShardLayout, reads: np.ndarray, lengths: np.ndarray):
    """Pad the whole batch to a multiple of the data-axis size and upload
    this process's slice of it (the whole padded batch when the data axis
    spans no processes): (reads, lengths, B) with B the unpadded batch
    size.  ``multihost.gather_to_host`` of the results gives the padded
    batch's rows in order."""
    B = reads.shape[0]
    pad = (-B) % layout.n_data
    if pad:
        reads = np.concatenate([reads, np.zeros((pad,) + reads.shape[1:], reads.dtype)])
        lengths = np.concatenate([lengths, np.zeros(pad, lengths.dtype)])
    hb = reads.shape[0] // layout.data_procs
    first = hb * (layout.process_index if layout.data_procs > 1 else 0)
    mine = slice(first, first + hb)
    r, l, _ = mh.make_global_batch(layout, reads[mine], lengths[mine])
    return r, l, B
