"""Binding of the hand-written CUDA banded-DP kernel (``csrc/banded_dp.cu``).

The kernel replaces the JAX package's Pallas kernel
``genome_weaver_align_tpu/ops/dp_pallas.py::_kernel`` and computes exactly
``ops.dp.banded_edit_distance``.  ``ops._cuda_build`` compiles it at first
use with ``nvcc`` for ``sm_90a`` into the gitignored ``_build/`` directory;
without ``nvcc``, or when the build fails, loading raises: there is no
fallback to the plain version.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ._cuda_build import load_kernel_library
from .dp import INF

MAX_K = 8  # the kernel is instantiated for k = 1..MAX_K


@functools.cache
def _library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    lib = load_kernel_library("banded_dp.cu")
    vp = ctypes.c_void_p
    lib.gwa_banded_dp.argtypes = [
        vp, vp, vp, vp, vp, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, vp,
    ]
    lib.gwa_banded_dp.restype = ctypes.c_int
    return lib


def banded_edit_distance_cuda(
    reads: torch.Tensor,  # (Q, L) int8 codes on a CUDA device
    lengths: torch.Tensor,  # (Q,) int32
    windows: torch.Tensor,  # (Q, W) int8
    k: int,
):
    """Launch the kernel -> (dist (Q,) int32, end_b (Q,) int32), equal to
    ``ops.dp.banded_edit_distance`` on every lane.  Launches on the current
    stream without synchronising; counts each launch in ``.launches``."""
    if not (reads.is_cuda and lengths.device == reads.device == windows.device):
        raise ValueError("banded_edit_distance_cuda needs all tensors on one CUDA device")
    if reads.dtype != torch.int8 or windows.dtype != torch.int8 or lengths.dtype != torch.int32:
        raise ValueError(
            f"expected int8 reads/windows and int32 lengths, got "
            f"{reads.dtype}/{windows.dtype}/{lengths.dtype}"
        )
    if reads.dim() != 2 or windows.dim() != 2 or lengths.shape != (reads.shape[0],) \
            or windows.shape[0] != reads.shape[0]:
        raise ValueError(
            f"shape mismatch: reads {tuple(reads.shape)}, lengths "
            f"{tuple(lengths.shape)}, windows {tuple(windows.shape)}"
        )
    if not (reads.is_contiguous() and windows.is_contiguous() and lengths.is_contiguous()):
        raise ValueError("banded_edit_distance_cuda needs contiguous tensors")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k}: the CUDA banded DP is built for 1 <= k <= {MAX_K}")
    Q, L = reads.shape
    W = windows.shape[1]
    if L >= INF:  # distances must stay below the saturation value
        raise ValueError(f"read length {L} >= {INF}: kernel would saturate")
    lib = _library()
    dist = torch.empty(Q, dtype=torch.int32, device=reads.device)
    end_b = torch.empty(Q, dtype=torch.int32, device=reads.device)
    if Q == 0:
        return dist, end_b
    with torch.cuda.device(reads.device):
        rc = lib.gwa_banded_dp(
            reads.data_ptr(), lengths.data_ptr(), windows.data_ptr(),
            dist.data_ptr(), end_b.data_ptr(), Q, L, W, k,
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"gwa_banded_dp launch failed: CUDA error {rc}")
    banded_edit_distance_cuda.launches += 1
    return dist, end_b


banded_edit_distance_cuda.launches = 0
