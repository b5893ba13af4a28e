"""Binding of the hand-written CUDA all-reduce kernels (``csrc/ring.cu``).

``ring_allreduce_cuda`` replaces the JAX package's Pallas kernel
``genome_weaver_align_tpu/parallel/ring.py::_ring_kernel``; the fused occ
rank + shard sum that replaces ``_fused_rank_ring_kernel`` has two entries:

- ``fused_rank_ring_cuda``: the JAX function's contract, rows already
  gathered per shard; equal to ``parallel.ring.fused_rank_ring_plain``;
- ``fused_occ_cuda``: reads each query's row straight from the sharded
  tables (the sharded exact search's entry); equal to
  ``parallel.sharded_index.fused_occ_plain``.

``ring_allreduce_cuda`` equals ``parallel.ring.ring_psum_plain``.  Every
kernel is one pass over every shard's input: nothing to wait on, no
scratch, nothing read back.  ``ops._cuda_build`` compiles the source at first use with
``nvcc`` for ``sm_90a``; without ``nvcc``, or when the build fails, loading
raises: there is no fallback to the plain versions.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ._cuda_build import load_kernel_library

MAX_SHARDS = 16
_DTYPES = {torch.int32: 0, torch.float32: 1}


@functools.cache
def _library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    lib = load_kernel_library("ring.cu")
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    lib.gwa_allreduce.argtypes = [i32, i32, i64, vp, vp, vp]
    lib.gwa_fused_words.argtypes = [i32, i64, vp, vp]
    lib.gwa_fused_occ.argtypes = [i32, i32, i32, i64, vp, vp, vp, vp, vp, vp, vp, vp]
    for fn in (lib.gwa_allreduce, lib.gwa_fused_words, lib.gwa_fused_occ):
        fn.restype = ctypes.c_int
    return lib


def _check_shards(S: int) -> None:
    if not 1 <= S <= MAX_SHARDS:
        raise ValueError(f"{S} shards: the ring kernels take 1..{MAX_SHARDS}")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def ring_allreduce_cuda(parts: torch.Tensor) -> torch.Tensor:
    """All-reduce over the leading shard axis of a CUDA tensor ``(S, ...)``
    int32 or float32: every shard's row of the result holds the sum, added
    in ``ring_psum_plain``'s order.  One kernel pass; launches on the
    current stream without synchronising.  Counts each launch in
    ``.launches``."""
    # Bad input: the kernel is built for int32 and float32 on the card; a
    # CPU tensor or another type raises here and never reaches a plain
    # version
    if not parts.is_cuda:
        raise ValueError("ring_allreduce_cuda needs a tensor on a CUDA device")
    if parts.dtype not in _DTYPES:
        raise TypeError(f"ring_allreduce_cuda takes int32 or float32, got {parts.dtype}")
    if parts.dim() < 1 or not parts.is_contiguous():
        raise ValueError("ring_allreduce_cuda needs a contiguous (S, ...) tensor")
    S = parts.shape[0]
    _check_shards(S)
    out = torch.empty_like(parts)
    n = parts[0].numel()
    if n == 0:
        return out
    flat, oflat = parts.reshape(S, n), out.view(S, n)
    ptr_in = (ctypes.c_uint64 * S)(*[flat[d].data_ptr() for d in range(S)])
    ptr_out = (ctypes.c_uint64 * S)(*[oflat[d].data_ptr() for d in range(S)])
    lib = _library()
    with torch.cuda.device(parts.device):
        rc = lib.gwa_allreduce(_DTYPES[parts.dtype], S, n, ptr_in, ptr_out, _stream())
    if rc != 0:
        raise RuntimeError(f"gwa_allreduce launch failed ({S} shards): CUDA error {rc}")
    ring_allreduce_cuda.launches += 1
    return out


ring_allreduce_cuda.launches = 0


def _check_int32_cuda(name: str, ts) -> None:
    if not all(t.is_cuda and t.device == ts[0].device for t in ts):
        raise ValueError(f"{name} needs all tensors on one CUDA device")
    if any(t.dtype != torch.int32 for t in ts):
        raise TypeError(f"{name} takes int32 tensors, got {[t.dtype for t in ts]}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{name} needs contiguous tensors")


def fused_rank_ring_cuda(
    words: torch.Tensor,  # (S, M, Q, 8) int32, the uint32 BWT words of each query's block
    codes: torch.Tensor,  # (S, M, Q) int32 query base codes
    roff: torch.Tensor,  # (S, M, Q) int32 base offsets in the block (may exceed 128)
    base: torch.Tensor,  # (S, M, Q) int32 the owner's checkpoint value
    own: torch.Tensor,  # (S, M, Q) int32 1 where the shard owns the query
) -> torch.Tensor:
    """Fused occ-rank partials + shard sum -> (S, M, Q) int32: every
    shard's row holds, per payload m, the sum over shards of
    ``own * (base + match count)``.  One pass, any M.  Counts each launch
    in ``.launches``."""
    ts = (words, codes, roff, base, own)
    _check_int32_cuda("fused_rank_ring_cuda", ts)
    if words.dim() != 4 or words.shape[3] != 8 or any(t.shape != words.shape[:3] for t in ts[1:]):
        raise ValueError(
            f"expected words (S, M, Q, 8) and (S, M, Q) codes/roff/base/own, got "
            f"{[tuple(t.shape) for t in ts]}"
        )
    if words.data_ptr() % 16:
        raise ValueError("fused_rank_ring_cuda loads each 32-byte word row as two 16-byte "
                         "vectors: words must start 16-byte aligned")
    S = codes.shape[0]
    _check_shards(S)
    out = torch.empty(codes.shape, dtype=torch.int32, device=words.device)
    n = codes[0].numel()
    if n == 0:
        return out
    ptrs = (ctypes.c_uint64 * (6 * S))(
        *[t[d].data_ptr() for d in range(S) for t in (*ts, out)]
    )
    with torch.cuda.device(words.device):
        rc = _library().gwa_fused_words(S, n, ptrs, _stream())
    if rc != 0:
        raise RuntimeError(f"gwa_fused_words launch failed ({S} shards): CUDA error {rc}")
    fused_rank_ring_cuda.launches += 1
    return out


fused_rank_ring_cuda.launches = 0


def fused_occ_cuda(
    bwt_blocks: torch.Tensor,  # (S, R, 8) int32 words of each shard's BWT blocks
    occ_cp: torch.Tensor,  # (S, R, 4) int32 global checkpoint values
    pk_start: torch.Tensor,  # (S,) int32 packed-coordinate shard starts
    pk_end: torch.Tensor,  # (S,) int32 shard ends (exclusive)
    primary: int,  # the sentinel's BWT row
    codes: torch.Tensor,  # (...) int32 query codes, 0..3
    k: torch.Tensor,  # (...) int32 sentinel-inclusive coordinates
) -> torch.Tensor:
    """Merged occ$(codes, k) over the interval shards, each query's row read
    from its owner's table -> (...) int32, equal to
    ``sharded_index.fused_occ_plain``.  Launches on the current stream
    without synchronising; counts each launch in ``.launches``."""
    ts = (bwt_blocks, occ_cp, pk_start, pk_end, codes, k)
    _check_int32_cuda("fused_occ_cuda", ts)
    S, R = bwt_blocks.shape[:2]
    if (bwt_blocks.shape[2:] != (8,) or occ_cp.shape != (S, R, 4)
            or pk_start.shape != (S,) or pk_end.shape != (S,) or codes.shape != k.shape):
        raise ValueError(
            f"expected bwt_blocks (S, R, 8), occ_cp (S, R, 4), pk_start/pk_end (S,) and codes "
            f"and k of one shape, got {[tuple(t.shape) for t in ts]}"
        )
    if bwt_blocks.data_ptr() % 16:
        raise ValueError("fused_occ_cuda loads each 32-byte word row as two 16-byte vectors: "
                         "bwt_blocks must start 16-byte aligned")
    _check_shards(S)
    out = torch.empty(codes.shape, dtype=torch.int32, device=codes.device)
    n = codes.numel()
    if n == 0:
        return out
    with torch.cuda.device(codes.device):
        rc = _library().gwa_fused_occ(S, R, int(primary), n, *(t.data_ptr() for t in ts),
                                      out.data_ptr(), _stream())
    if rc != 0:
        raise RuntimeError(f"gwa_fused_occ launch failed ({S} shards): CUDA error {rc}")
    fused_occ_cuda.launches += 1
    return out


fused_occ_cuda.launches = 0
