"""Ring all-reduce over the interval-shard axis: the torch counterpart of
``genome_weaver_align_tpu.parallel.ring``.

Every extension step of the interval-sharded exact search merges the
shards' rank partials.  Here all shards live on one device, and the merge
is a sum over the shards that every shard receives:

- ``ring_psum(parts)``: ``(S, ...)`` int32 or float32 -> ``(S, ...)``,
  every row the sum; ``parts`` may also be S tensors ``(...)`` in their
  own allocations (across processes on one card: each rank's partial,
  its row of its mapped inbox, ``sharded_index._RingSlots``), and
  ``only`` = d returns shard d's sum alone, the only output written;
- ``fused_rank_ring(words, codes, roff, base, own)``: the occ-rank
  partials of M payloads computed and ring-summed in one pass -> ``(M, Q)``
  int32 (shard 0's copy: every shard holds the same).

Each sends a CUDA tensor to its hand-written kernel (``ops.ring_cuda``,
source ``csrc/ring.cu``: one pass over every shard's input, no ring on one
card) and a CPU tensor to its plain version below; there is no fallback
from one to the other.  The plain versions add in the ring's order, shard
d receiving x_{d-1}, x_{d-2}, ... one hop at a time, so the kernels equal
them bit for bit, float32 included.  The sharded exact search reads its
rows from the shard tables instead (``sharded_index.fused_occ``).

The JAX package threads a token through ``lax.optimization_barrier`` so that
ring merges run in one order on every device (``ring.py:329-333``,
``:383-387``).  Launches on one CUDA stream already run in issue order, so
that sequencing is the stream's and is not ported.
"""

from __future__ import annotations

import torch

from ..ops import rank

_DTYPES = (torch.int32, torch.float32)


def ring_psum_plain(parts: torch.Tensor) -> torch.Tensor:
    """The ring's sum in its addition order: after hop s shard d has added
    x_{d-1-s}."""
    acc = parts.clone()
    p = parts
    for _ in range(parts.shape[0] - 1):
        p = p.roll(1, 0)
        acc += p
    return acc


def ring_psum(parts, only: int | None = None) -> torch.Tensor:
    """All-reduce sum over the shards: ``(S, ...)`` int32 or float32, or S
    ``(...)`` tensors -> ``(S, ...)`` with every shard's row the sum, or
    with ``only`` = d shard d's ``(...)``."""
    first = parts if isinstance(parts, torch.Tensor) else parts[0]
    if first.dtype not in _DTYPES:
        raise TypeError(f"ring_psum takes int32 or float32, got {first.dtype}")
    if first.is_cuda:
        from ..ops import ring_cuda

        if isinstance(parts, torch.Tensor):
            parts = parts.contiguous()
        return ring_cuda.ring_allreduce_cuda(parts, only)
    out = ring_psum_plain(parts if isinstance(parts, torch.Tensor) else torch.stack(list(parts)))
    return out if only is None else out[only]


def rank_partials(words, codes, roff, base, own) -> torch.Tensor:
    """Per shard and payload: ``own * (base + #bases equal to code in the
    first roff of the block)`` (``roff`` above 128 saturates)."""
    cnt = rank._match_counts(words, codes.to(torch.int32), rank._pair_masks(roff))
    return own * (base + cnt)


def fused_rank_ring_plain(words, codes, roff, base, own) -> torch.Tensor:
    """``rank_partials`` then the ring sum: (S, M, Q) int32."""
    return ring_psum_plain(rank_partials(words, codes, roff, base, own))


def fused_rank_ring(
    words: torch.Tensor,  # (S, M, Q, 8) int32: each query's block words, uint32 bits
    codes: torch.Tensor,  # (S, M, Q) int32
    roff: torch.Tensor,  # (S, M, Q) int32 base offsets in the block
    base: torch.Tensor,  # (S, M, Q) int32 the checkpoint value occ_cp[b][code]
    own: torch.Tensor,  # (S, M, Q) int32 1 where the shard owns the query, else 0
) -> torch.Tensor:
    """Merged occ values of M payloads: (M, Q) int32, equal to the sum over
    shards of ``sharded_index.local_occ_codes``."""
    if words.is_cuda:
        from ..ops import ring_cuda

        return ring_cuda.fused_rank_ring_cuda(
            *(t.contiguous() for t in (words, codes, roff, base, own))
        )[0]
    return fused_rank_ring_plain(words, codes, roff, base, own)[0]
