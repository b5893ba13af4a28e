"""Several processes over ``torch.distributed``: the torch counterpart of
``genome_weaver_align_tpu.parallel.multihost``.

One process per host (or per card), joined by ``initialize_distributed``.
Reads are streamed data-parallel: every process holds the whole batch, pads
it to a multiple of the process count and aligns only its own slice
(``host_shard_info``, ``make_global_batch``).  ``gather_to_host`` brings
every slice's results back to every process, in global read order, so the
host tail that follows (CIGARs, SAM) sees the whole batch and the SAM bytes
are the same for any process count.  With one process every function
degenerates to the local case.

The transport is gloo, always:

- the results go to the host for the SAM tail in any case, as the JAX
  package's ``process_allgather`` returns host arrays;
- gloo runs the same way on the CPU and with several ranks on one card;
- NCCL refuses two ranks on one GPU.

The interval group (``interval_group``) is the processes that together
hold one copy of an interval-sharded index: every process, each holding
``n_interval / P`` of the shards (``mesh.make_layout``,
``parallel.peer``).  Its collectives are the shard maps' exchanges and
barriers and the exact search's cross-process merges.

NCCL belongs with shards spread across cards (ROADMAP queue 1 #16).
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ..models import exact

# a rank that never reaches a collective fails the others after this long
# instead of hanging them
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=300)

_INTERVAL_GROUP = None


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Join a gloo process group at ``coordinator_address`` (``host:port``;
    process 0 listens there) and make its interval group; no-op for a
    single process."""
    global _INTERVAL_GROUP
    if num_processes is None or num_processes <= 1:
        return
    dist.init_process_group(
        "gloo",
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes,
        rank=process_id,
        timeout=COLLECTIVE_TIMEOUT,
    )
    _INTERVAL_GROUP = dist.new_group(list(range(num_processes)), backend="gloo",
                                     timeout=COLLECTIVE_TIMEOUT)


def interval_group():
    """The gloo group of the processes that together hold one copy of an
    interval-sharded index (all of them), or None in one process."""
    if process_count() == 1:
        return None
    if _INTERVAL_GROUP is None:
        raise RuntimeError("the process group was not made by initialize_distributed")
    return _INTERVAL_GROUP


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


def gather_to_host(tensors) -> list[np.ndarray]:
    """Every process's slice of each result, concatenated along axis 0 in
    process order, as numpy arrays on every process (the JAX package's
    ``process_allgather(tiled=True)``).  Slices must have the same shape on
    every process: pad the batch before it is split, and slice the padding
    off after the gather."""
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
        out.append(torch.cat(parts).numpy())
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
