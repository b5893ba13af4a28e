"""Several processes over ``torch.distributed``: the torch counterpart of
``genome_weaver_align_tpu.parallel.multihost``.

One process per card, joined by ``initialize_distributed``.  Reads are
streamed data-parallel: every process holds the whole batch, pads it to a
multiple of the process count and aligns only its own slice
(``host_shard_info``, ``make_global_batch``).  ``gather_to_host`` brings
every slice's results back to every process, in global read order, so the
host tail that follows (CIGARs, SAM) sees the whole batch and the SAM bytes
are the same for any process count.  With one process every function
degenerates to the local case.

Each process takes a card: its local rank (``LOCAL_RANK``, else its rank:
one host) modulo the cards it sees (``card_for``, ``device``); several
processes share a card where there are fewer cards than processes.  Each
process also records every process's host (``host_of``): its hostname,
joined with its node rank where a multi-node launcher states one
(``GROUP_RANK``, as torchrun sets it).  On real nodes both differ; on one
machine the node rank alone declares the nodes.  CUDA IPC, and so the shard
maps of ``parallel.peer``, stops at the host: an interval group whose
processes lie on several hosts merges by collectives instead
(``mesh.ShardLayout.mapped``).

Two transports:

- gloo, the world group: ``gather_to_host`` (the results go to the host
  for the SAM in any case, as the JAX package's ``process_allgather``
  returns host arrays), the shard maps' exchanges and barriers, and every
  collective on CPU tensors;
- NCCL, beside gloo, for each interval group whose processes lie on
  distinct cards (``nccl_group``): the exact search's psum on the card,
  with no hop to the host.  NCCL refuses two ranks on one card, so a group
  whose ranks share a card has no NCCL group and keeps gloo.

The interval groups (``interval_group``) are the processes that together
hold one copy of an interval-sharded index: g consecutive ranks, each
holding ``n_interval / g`` of the shards (``mesh.make_layout`` chooses g;
``parallel.peer`` maps the others').  ``initialize_distributed`` makes the
groups of every span g that divides the process count, so a layout of any
shard count finds its groups made.  Their collectives are the shard maps'
exchanges and barriers and the exact search's cross-process merges.
"""

from __future__ import annotations

import datetime
import os
import socket
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ..models import exact

# a rank that never reaches a collective fails the others after this long
# instead of hanging them
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=300)

_CARD = None  # this process's card, recorded by initialize_distributed
_GROUPS = {}  # span -> (this process's gloo group, its NCCL group or None)
_HOSTS = []  # every process's host, recorded by initialize_distributed


def card_for(local_rank: int, n_cards: int) -> int | None:
    """The card a process of local rank ``local_rank`` takes among
    ``n_cards`` (None without a card)."""
    return local_rank % n_cards if n_cards > 0 else None


def spans(n_procs: int) -> list[int]:
    """The spans of the interval groups made for ``n_procs`` processes:
    every divisor above 1."""
    return [g for g in range(2, n_procs + 1) if n_procs % g == 0]


def groups_of(n_procs: int, span: int) -> list[list[int]]:
    """The interval groups of ``span`` consecutive ranks."""
    return [list(range(first, first + span)) for first in range(0, n_procs, span)]


def this_host() -> str:
    """This process's host: its hostname, and its node rank where the
    launcher sets ``GROUP_RANK``."""
    node = os.environ.get("GROUP_RANK")
    return socket.gethostname() if node is None else f"{socket.gethostname()}/node{node}"


def host_of(rank: int) -> str:
    """The host of process ``rank`` as ``initialize_distributed`` recorded
    it; without a record (one process, or a group that function did not
    make) every process is taken for one on this host."""
    return _HOSTS[rank] if process_count() > 1 and rank < len(_HOSTS) else this_host()


def one_host(ranks) -> bool:
    """Whether the processes ``ranks`` lie on one host."""
    return len({host_of(r) for r in ranks}) <= 1


def apart(places, ranks) -> bool:
    """Whether the processes ``ranks`` lie on distinct cards: ``places``
    is every process's (host, card), card None without one."""
    cards = [places[r] for r in ranks]
    return all(c[1] is not None for c in cards) and len(set(cards)) == len(cards)


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Join a gloo process group at ``coordinator_address`` (``host:port``;
    process 0 listens there), take this process's card (``card_for``; made
    the current CUDA device), record every process's host (``host_of``)
    and make the interval groups of every span, each with an NCCL group
    beside its gloo group where its processes lie on distinct cards; no-op
    for a single process."""
    global _CARD
    if num_processes is None or num_processes <= 1:
        return
    dist.init_process_group(
        "gloo",
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes,
        rank=process_id,
        timeout=COLLECTIVE_TIMEOUT,
    )
    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    _CARD = card_for(int(os.environ.get("LOCAL_RANK", process_id)), n_cards)
    if _CARD is not None:
        torch.cuda.set_device(_CARD)
    # (hostname, card) names a physical card whatever node rank a process
    # declares: processes of two declared nodes on one machine may share one
    found = [None] * num_processes
    dist.all_gather_object(found, (socket.gethostname(), _CARD, this_host()))
    places = [f[:2] for f in found]
    _HOSTS[:] = [f[2] for f in found]
    nccl = dist.is_nccl_available() and n_cards > 0
    _GROUPS.clear()
    for g in spans(num_processes):
        # every process makes every group, in one order (a collective)
        for ranks in groups_of(num_processes, g):
            gloo = dist.new_group(ranks, backend="gloo", timeout=COLLECTIVE_TIMEOUT)
            fast = (dist.new_group(ranks, backend="nccl", timeout=COLLECTIVE_TIMEOUT)
                    if nccl and apart(places, ranks) else None)
            if process_id in ranks:
                _GROUPS[g] = (gloo, fast)


def card() -> int | None:
    """This process's card (None in one process, or without a card)."""
    return _CARD if process_count() > 1 else None


def device() -> torch.device:
    """This process's card as a device (the current CUDA device in one
    process; the CPU without a card)."""
    c = card()
    if c is not None:
        return torch.device("cuda", c)
    return torch.device("cuda", torch.cuda.current_device()) if torch.cuda.is_available() \
        else torch.device("cpu")


def _group(span: int | None):
    span = process_count() if span is None else span
    if process_count() == 1 or span == 1:
        return None
    if span not in _GROUPS:
        raise RuntimeError(f"no interval group of {span} processes: the process group was not "
                           "made by initialize_distributed, or the span does not divide "
                           f"{process_count()} processes")
    return _GROUPS[span]


def interval_group(span: int | None = None):
    """The gloo group of this process's interval group of ``span``
    consecutive processes (all of them by default; ``mesh.ShardLayout.
    group``), or None when it is this process alone."""
    g = _group(span)
    return None if g is None else g[0]


def nccl_group(span: int | None = None):
    """The NCCL group beside ``interval_group(span)``: None where its
    processes share a card or have none (they keep gloo)."""
    g = _group(span)
    return None if g is None else g[1]


def process_index() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


@dataclass
class HostShardInfo:
    process_index: int
    process_count: int
    global_batch: int
    host_batch: int
    host_start: int  # first read index of this process's slice of a batch


def host_shard_info(global_batch: int) -> HostShardInfo:
    pi, pc = process_index(), process_count()
    if global_batch % pc:
        raise ValueError(f"global batch {global_batch} must divide across {pc} processes")
    hb = global_batch // pc
    return HostShardInfo(pi, pc, global_batch, hb, pi * hb)


def make_global_batch(layout, host_reads: np.ndarray, host_lengths: np.ndarray):
    """Upload this process's slice of a batch to ``layout.device``:
    (reads, lengths, global batch size), the global size by the processes
    the layout's data axis spans.  Each process passes ONLY its own rows;
    with one process, or a data axis that spans none, they are the whole
    batch."""
    dev = layout.device
    reads = torch.from_numpy(np.ascontiguousarray(host_reads, dtype=np.int32)).to(dev)
    lengths = torch.from_numpy(np.ascontiguousarray(host_lengths, dtype=np.int32)).to(dev)
    return reads, lengths, host_reads.shape[0] * layout.data_procs


def gather_to_host(tensors, span: int = 1) -> list[np.ndarray]:
    """Every process's slice of each result, concatenated along axis 0 in
    process order, as numpy arrays on every process (the JAX package's
    ``process_allgather(tiled=True)``).  Slices must have the same shape on
    every process: pad the batch before it is split, and slice the padding
    off after the gather.  ``span`` > 1 takes the slice of the first of
    every ``span`` consecutive processes only: the members of an interval
    group whose data axis spans the groups hold one slice each.  The
    transfer still moves all P slices and drops the duplicates here, which
    keeps one collective over the whole world; a gather from one member a
    group would move 1/span of the bytes."""
    local = [t.cpu() if isinstance(t, torch.Tensor) else torch.from_numpy(np.asarray(t))
             for t in tensors]
    pc = process_count()
    if pc == 1:
        return [t.numpy() for t in local]
    out = []
    for t in local:
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(pc)]
        dist.all_gather(parts, t)
        out.append(torch.cat(parts[::span]).numpy())
    return out


def exact_align(fm, layout, reads: np.ndarray, lengths: np.ndarray, max_len: int | None = None):
    """The exact search of one batch across the processes: each passes the
    whole batch, uploads its slice (``host_shard_info``,
    ``make_global_batch``), searches both strands (``exact.best_strand``)
    and gathers.  -> (pos, strand) of every read, on every process."""
    info = host_shard_info(reads.shape[0])
    mine = slice(info.host_start, info.host_start + info.host_batch)
    r, ln, _ = make_global_batch(layout, reads[mine], lengths[mine])
    pos, strand, _ = exact.best_strand(fm, r, ln, max_len=max_len)
    return gather_to_host([pos, strand])


def stream_batches(reads: list, batch_size: int):
    """Deterministic batch iterator: (start index, slice of reads)."""
    n = len(reads)
    for start in range(0, n, batch_size):
        yield start, reads[start : start + batch_size]
