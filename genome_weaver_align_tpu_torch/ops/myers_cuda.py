"""Binding of the hand-written CUDA Myers kernel (``csrc/myers.cu``).

The kernel replaces the JAX package's Pallas kernel
``genome_weaver_align_tpu/ops/myers_pallas.py::_kernel`` and computes
exactly ``ops.myers.myers_semiglobal_end``.  ``ops._cuda_build`` compiles it
at first use with ``nvcc`` for ``sm_90a``; without ``nvcc``, or when the
build fails, loading raises: there is no fallback to the plain version.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ._cuda_build import load_kernel_library

MAX_LEN = 256  # 8 words of 32 bits, as the TPU kernel
MAX_WORDS = MAX_LEN // 32


@functools.cache
def _library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    lib = load_kernel_library("myers.cu")
    vp, i32 = ctypes.c_void_p, ctypes.c_int32
    lib.gwa_myers.argtypes = [vp, vp, vp, vp, vp, ctypes.c_int64, i32, i32, i32, i32, i32, vp]
    lib.gwa_myers.restype = ctypes.c_int
    return lib


def myers_semiglobal_cuda(
    reads: torch.Tensor,  # (Q, L) int8 or int32 codes on a CUDA device
    lengths: torch.Tensor,  # (Q,) int32
    windows: torch.Tensor,  # (Q, W), the dtype of reads
    nwords: int | None = None,  # bit-vector words; default ceil(L / 32)
    steps: int | None = None,  # window columns consumed; default W
):
    """Launch the kernel -> (best (Q,) int32, end (Q,) int32), equal to
    ``ops.myers.myers_semiglobal_end`` on every lane.  Launches on the
    current stream without synchronising; counts each launch in
    ``.launches``."""
    if not (reads.is_cuda and lengths.device == reads.device == windows.device):
        raise ValueError("myers_semiglobal_cuda needs all tensors on one CUDA device")
    if reads.dtype != windows.dtype or reads.dtype not in (torch.int8, torch.int32) \
            or lengths.dtype != torch.int32:
        raise ValueError(
            f"expected int8 or int32 reads/windows of one dtype and int32 lengths, "
            f"got {reads.dtype}/{windows.dtype}/{lengths.dtype}"
        )
    if reads.dim() != 2 or windows.dim() != 2 or lengths.shape != (reads.shape[0],) \
            or windows.shape[0] != reads.shape[0]:
        raise ValueError(
            f"shape mismatch: reads {tuple(reads.shape)}, lengths "
            f"{tuple(lengths.shape)}, windows {tuple(windows.shape)}"
        )
    if not (reads.is_contiguous() and windows.is_contiguous() and lengths.is_contiguous()):
        raise ValueError("myers_semiglobal_cuda needs contiguous tensors")
    Q, L = reads.shape
    W = windows.shape[1]
    if L > MAX_LEN:
        raise ValueError(f"read length {L} > {MAX_LEN} unsupported")
    nwords = max(1, -(-L // 32)) if nwords is None else nwords
    steps = W if steps is None else steps
    if not 1 <= nwords <= MAX_WORDS:
        raise ValueError(f"nwords={nwords}: the kernel is built for 1..{MAX_WORDS} words")
    if steps > 0 and W == 0:
        raise ValueError("windows have no columns to step over")
    best = torch.empty(Q, dtype=torch.int32, device=reads.device)
    end = torch.empty(Q, dtype=torch.int32, device=reads.device)
    if Q == 0:
        return best, end
    lib = _library()
    with torch.cuda.device(reads.device):
        rc = lib.gwa_myers(
            reads.data_ptr(), lengths.data_ptr(), windows.data_ptr(),
            best.data_ptr(), end.data_ptr(), Q, L, W, nwords, steps,
            reads.element_size(), torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"gwa_myers launch failed: CUDA error {rc}")
    myers_semiglobal_cuda.launches += 1
    return best, end


myers_semiglobal_cuda.launches = 0
