"""Shard layout on one device: the torch counterpart of
``genome_weaver_align_tpu.parallel.mesh``.

Axes keep the JAX package's names:

- ``data``     — read-cohort data parallelism.  In one process on one
                 device it is only padding: ``shard_reads`` pads the batch
                 to a multiple of ``n_data``, and the outputs, sliced to the
                 batch, are the same for every ``n_data``.
- ``interval`` — BWT-interval index sharding: every sharded table keeps a
                 leading shard axis of size ``n_interval``, and all shards
                 live on ``device``.  Each rank query is answered by its
                 owning shard and the per-shard partials are merged by a sum
                 over that axis (``parallel.ring`` or ``parts.sum(0)``).

Shards on several cards or in several processes are later work.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

DATA_AXIS = "data"
INTERVAL_AXIS = "interval"


@dataclass(frozen=True)
class ShardLayout:
    """Stands in for the JAX ``Mesh``: axis sizes and the one device."""

    n_data: int = 1
    n_interval: int = 1
    device: torch.device = torch.device("cuda")

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.n_data, INTERVAL_AXIS: self.n_interval}


def make_layout(n_data: int = 1, n_interval: int = 1, device="cuda") -> ShardLayout:
    if n_data < 1 or n_interval < 1:
        raise ValueError(f"axis sizes must be >= 1, got n_data={n_data}, n_interval={n_interval}")
    return ShardLayout(n_data, n_interval, torch.device(device))


def shard_reads(layout: ShardLayout, reads: np.ndarray, lengths: np.ndarray):
    """Pad the batch to a multiple of the data-axis size and upload it:
    (reads, lengths, B) with B the unpadded batch size."""
    B = reads.shape[0]
    pad = (-B) % layout.n_data
    if pad:
        reads = np.concatenate([reads, np.zeros((pad,) + reads.shape[1:], reads.dtype)])
        lengths = np.concatenate([lengths, np.zeros(pad, lengths.dtype)])
    dev = layout.device
    return (
        torch.from_numpy(np.ascontiguousarray(reads, dtype=np.int32)).to(dev),
        torch.from_numpy(np.ascontiguousarray(lengths, dtype=np.int32)).to(dev),
        B,
    )
