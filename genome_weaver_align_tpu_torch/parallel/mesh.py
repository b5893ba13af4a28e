"""Shard layout on one device: the torch counterpart of
``genome_weaver_align_tpu.parallel.mesh``.

Axes keep the JAX package's names:

- ``data``     — read-cohort data parallelism across processes
                 (``parallel.multihost``): ``shard_reads`` pads the batch to
                 a multiple of ``n_data`` and uploads this process's slice,
                 by the process index and count the layout recorded when it
                 was made.  In one process it is only padding, and the
                 outputs, sliced to the batch, are the same for every
                 ``n_data``.
- ``interval`` — BWT-interval index sharding: every sharded table keeps a
                 leading shard axis of size ``n_interval``, and all shards
                 live on ``device``.  Each rank query is answered by its
                 owning shard and the per-shard partials are merged by a sum
                 over that axis (``parallel.ring`` or ``parts.sum(0)``).

Interval shards on several cards are later work.
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
    """Stands in for the JAX ``Mesh``: axis sizes, the one device, and this
    process's place among the processes the data axis spans (each owns
    ``n_data // process_count`` consecutive positions on it)."""

    n_data: int = 1
    n_interval: int = 1
    device: torch.device = torch.device("cuda")
    process_index: int = 0
    process_count: int = 1

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.n_data, INTERVAL_AXIS: self.n_interval}


def make_layout(n_data: int = 1, n_interval: int = 1, device="cuda") -> ShardLayout:
    """A layout for this process in the current process group (one process
    when none is initialised): make it after ``initialize_distributed``."""
    if n_data < 1 or n_interval < 1:
        raise ValueError(f"axis sizes must be >= 1, got n_data={n_data}, n_interval={n_interval}")
    pi, pc = mh.process_index(), mh.process_count()
    if n_data % pc:
        raise ValueError(f"the data axis ({n_data}) must divide across {pc} processes")
    return ShardLayout(n_data, n_interval, torch.device(device), pi, pc)


def shard_reads(layout: ShardLayout, reads: np.ndarray, lengths: np.ndarray):
    """Pad the whole batch to a multiple of the data-axis size and upload
    this process's slice of it: (reads, lengths, B) with B the unpadded
    batch size.  ``multihost.gather_to_host`` of the results gives the
    padded batch's rows in order."""
    B = reads.shape[0]
    pad = (-B) % layout.n_data
    if pad:
        reads = np.concatenate([reads, np.zeros((pad,) + reads.shape[1:], reads.dtype)])
        lengths = np.concatenate([lengths, np.zeros(pad, lengths.dtype)])
    hb = reads.shape[0] // layout.process_count
    mine = slice(layout.process_index * hb, (layout.process_index + 1) * hb)
    r, l, _ = mh.make_global_batch(layout, reads[mine], lengths[mine])
    return r, l, B
