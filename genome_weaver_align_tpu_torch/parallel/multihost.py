"""Single-process part of ``genome_weaver_align_tpu.parallel.multihost``.

Results come back to the host in global read order, so the SAM writer emits
the same bytes whatever the shard layout.  Several processes
(``torch.distributed``) are not ported: ``initialize_distributed`` raises
for more than one (ROADMAP queue 1 #14).
"""

from __future__ import annotations

import numpy as np
import torch


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """No-op for a single process; more than one is not ported."""
    if num_processes is None or num_processes <= 1:
        return
    raise NotImplementedError(
        f"{num_processes} processes: multi-host alignment over torch.distributed "
        "is not ported yet (ROADMAP queue 1 #14)"
    )


def gather_to_host(tensors) -> list[np.ndarray]:
    """Device tensors -> numpy arrays (one device-to-host copy each)."""
    return [t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t) for t in tensors]


def stream_batches(reads: list, batch_size: int):
    """Deterministic batch iterator: (start index, slice of reads)."""
    n = len(reads)
    for start in range(0, n, batch_size):
        yield start, reads[start : start + batch_size]
