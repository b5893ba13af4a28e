"""Shard layout across processes: the torch counterpart of
``genome_weaver_align_tpu.parallel.mesh``, whose ``make_mesh`` reshapes the
devices into ``(n_data, n_interval)``.

With P processes (``multihost.initialize_distributed``, one a card) and
``n_interval`` = S > 1, the processes form interval groups of g
consecutive ranks (``interval_span``):

- g = S where S divides P: one shard a process, as JAX has one a device,
  and P / g copies of the index;
- else g = P, where P divides S: every process in one group, each holding
  S / P shards.

Each process of a group holds ``n_interval / g`` consecutive shards
(``held``).  Two routes, one for the whole world (``mapped``):

- every interval group on one host (``multihost.one_host``): each process
  maps the other members' shards (``parallel.peer``), wherever their cards
  lie, and reads any shard directly;
- some interval group across hosts, where CUDA IPC cannot reach: the
  collective route, the JAX mesh's across hosts.  Each process uploads its
  own shards only and maps nothing; every step that reads the index is
  answered by each process from its own shards (non-owners give 0) and
  merged by one ``all_reduce`` over the group.  Every member of a group
  takes the group's reads: the data axis spans the groups.

S = 1, or one process, is the stacked layout: every sharded table keeps a
leading shard axis of size ``n_interval`` on ``device``.  Each rank query
is answered by its owning shard and the per-shard partials are merged by a
sum over the shards (``parallel.ring``, ``parts.sum(0)``, or across
processes the merges of ``sharded_index.make_sharded_exact_search`` and of
the sharded pipeline).

Axes keep the JAX package's names:

- ``data``     — read-cohort data parallelism.  ``shard_reads`` pads the
                 batch to a multiple of ``n_data`` and uploads this
                 process's slice of it.  Where P divides ``n_data`` the
                 axis spans the processes: each takes its own slice (the
                 port's ``ShardedAligner`` on the mapped route, whose every
                 process runs the whole pipeline over the mapped shards).
                 Else it spans the interval groups, P / g of them dividing
                 ``n_data``: every process of a group takes the group's
                 slice, as the devices of a JAX interval group take the
                 same reads (the exact search, and ``ShardedAligner`` on
                 the collective route).  With one group and ``n_data`` = 1 every process
                 takes the whole batch.  In one process it is only padding,
                 and the outputs, sliced to the batch, are the same for
                 every ``n_data``.
- ``interval`` — BWT-interval index sharding into ``n_interval`` shards,
                 spanning the g processes of an interval group.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import multihost as mh

DATA_AXIS = "data"
INTERVAL_AXIS = "interval"


def interval_span(n_procs: int, n_interval: int) -> int:
    """g, the processes of one interval group: S where S divides P, else
    P where P divides S (1 for S = 1); any other pair raises."""
    if n_interval == 1:
        return 1
    if n_procs % n_interval == 0:
        return n_interval
    if n_interval % n_procs == 0:
        return n_procs
    raise ValueError(f"the interval axis ({n_interval} shards) and {n_procs} processes: one "
                     "must divide the other (an interval group is one shard a process, or every "
                     "process)")


@dataclass(frozen=True)
class ShardLayout:
    """Stands in for the JAX ``Mesh``: axis sizes, the one device, this
    process's place among the processes, and which of them each axis
    spans: the interval axis the ``interval_procs`` consecutive processes
    of this process's interval group (each holds ``n_interval //
    interval_procs`` consecutive shards), the data axis ``data_procs``
    units, processes or interval groups (each owns ``n_data // data_procs``
    consecutive positions on it).  ``mapped``: every interval group lies
    on one host, so its members map each other's shards; else the whole
    world takes the collective route (``collective``)."""

    n_data: int = 1
    n_interval: int = 1
    device: torch.device = torch.device("cuda")
    process_index: int = 0
    process_count: int = 1
    interval_procs: int = 1
    data_procs: int = 1
    mapped: bool = True

    @property
    def collective(self) -> bool:
        """Whether this process's interval group merges by collectives over
        its own shards (some group spans hosts) instead of mapping the
        other members' shards."""
        return self.interval_procs > 1 and not self.mapped

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.n_data, INTERVAL_AXIS: self.n_interval}

    @property
    def groups(self) -> int:
        """Interval groups: copies of the index across the processes."""
        return self.process_count // self.interval_procs

    @property
    def group_index(self) -> int:
        """This process's interval group."""
        return self.process_index // self.interval_procs

    @property
    def group_rank(self) -> int:
        """This process's place in its interval group."""
        return self.process_index % self.interval_procs

    @property
    def group_ranks(self) -> range:
        """The processes of this process's interval group."""
        first = self.group_index * self.interval_procs
        return range(first, first + self.interval_procs)

    @property
    def group(self):
        """This process's interval group (``multihost.interval_group``), or
        None when the interval axis spans no processes."""
        return mh.interval_group(self.interval_procs) if self.interval_procs > 1 else None

    @property
    def data_index(self) -> int:
        """This process's unit on the data axis: itself, its interval
        group, or 0 where the axis spans nothing."""
        if self.data_procs == 1:
            return 0
        return self.process_index if self.data_procs == self.process_count else self.group_index

    @property
    def held(self) -> range:
        """The shards this process holds."""
        per = self.n_interval // self.interval_procs
        return range(per * self.group_rank, per * self.group_rank + per)

    @property
    def owners(self) -> tuple[int, ...]:
        """The process of the interval group (its place in it) that holds
        each shard (0 for every shard in the stacked layout)."""
        per = self.n_interval // self.interval_procs
        return tuple(s // per for s in range(self.n_interval))


def groups_mapped(n_procs: int, n_interval: int) -> bool:
    """Whether every interval group of ``n_procs`` processes at
    ``n_interval`` shards lies on one host (``multihost.one_host``): the
    mapped route, else the collective one."""
    g = interval_span(n_procs, n_interval)
    return all(mh.one_host(ranks) for ranks in mh.groups_of(n_procs, g))


def make_layout(n_data: int = 1, n_interval: int = 1, device="cuda") -> ShardLayout:
    """A layout for this process in the current process group (one process
    when none is initialised): make it after ``initialize_distributed``.
    With P > 1 processes the interval axis spans groups of
    ``interval_span(P, n_interval)`` processes, and the data axis the P
    processes where P divides ``n_data``, else the P / g groups, which must
    divide it.  The route (``mapped``) follows the hosts of the groups
    (``groups_mapped``)."""
    if n_data < 1 or n_interval < 1:
        raise ValueError(f"axis sizes must be >= 1, got n_data={n_data}, n_interval={n_interval}")
    pi, pc = mh.process_index(), mh.process_count()
    g = interval_span(pc, n_interval)
    if n_data % pc == 0:
        data_procs = pc
    elif n_data % (pc // g) == 0:
        data_procs = pc // g
    else:
        raise ValueError(f"the data axis ({n_data}) must divide across {pc} processes or their "
                         f"{pc // g} interval groups")
    return ShardLayout(n_data, n_interval, torch.device(device), pi, pc, g, data_procs,
                       groups_mapped(pc, n_interval))


def shard_reads(layout: ShardLayout, reads: np.ndarray, lengths: np.ndarray):
    """Pad the whole batch to a multiple of the data-axis size and upload
    this process's slice of it: its own, its interval group's (``data_index``),
    or the whole padded batch when the data axis spans nothing: (reads,
    lengths, B) with B the unpadded batch size.  Where the axis spans the
    processes, ``multihost.gather_to_host`` of the results gives the padded
    batch's rows in order."""
    B = reads.shape[0]
    pad = (-B) % layout.n_data
    if pad:
        reads = np.concatenate([reads, np.zeros((pad,) + reads.shape[1:], reads.dtype)])
        lengths = np.concatenate([lengths, np.zeros(pad, lengths.dtype)])
    hb = reads.shape[0] // layout.data_procs
    first = hb * layout.data_index
    mine = slice(first, first + hb)
    r, l, _ = mh.make_global_batch(layout, reads[mine], lengths[mine])
    return r, l, B
