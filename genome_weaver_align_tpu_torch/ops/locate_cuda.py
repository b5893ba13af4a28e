"""Binding of the hand-written CUDA LF-walk locate (``csrc/locate.cu``).

The kernels replace the JAX package's device loops
``genome_weaver_align_tpu/ops/rank.py:234`` (``locate``) and
``genome_weaver_align_tpu/parallel/sharded_index.py:267`` (the sharded
``locate``): one thread a row, the whole walk in one launch, stopping at
the row's first sampled row.  ``locate_cuda`` is equal to
``ops.rank.locate_plain`` and ``locate_sharded_cuda`` to
``parallel.sharded_index.locate_plain`` with the default merge.

``ops._cuda_build`` compiles the source at first use with ``nvcc`` for
``sm_90a`` into the gitignored ``_build/`` directory; without ``nvcc``, or
when the build fails, loading raises: there is no fallback to the plain
versions.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ._cuda_build import load_kernel_library
from .fm_search_cuda import check_sharded, check_table, stream
from .rank import MARK_WORDS_PER_BLOCK, DeviceFMIndex

I32 = torch.int32


@functools.cache
def _library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    lib = load_kernel_library("locate.cu")
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    lib.gwa_locate.argtypes = [vp, i64, vp, i32, vp, i32, i32, vp, i32, vp, vp, i32, i32, vp, vp]
    lib.gwa_locate_sharded.argtypes = [
        vp, i64, i32, i32, vp, vp, vp, vp, i32, vp, vp, vp, vp, i32, vp, vp, vp, i32, i32, i32,
        vp, vp,
    ]
    lib.gwa_locate.restype = lib.gwa_locate_sharded.restype = ctypes.c_int
    return lib


def _check_rows(rows: torch.Tensor, name: str) -> None:
    if rows.dtype != I32 or not rows.is_contiguous():
        raise ValueError(f"{name}: expected contiguous int32 rows, got {rows.dtype}")


def locate_cuda(fm: DeviceFMIndex, rows: torch.Tensor) -> torch.Tensor:
    """Text positions of the BWT rows ``rows`` (int32, any shape, values in
    [0, n], on a CUDA device) -> int32 of that shape.  Launches on the
    current stream without synchronising; counts each launch in
    ``.launches``."""
    name = "locate_cuda"
    _check_rows(rows, name)
    mb, mcp, ssa = fm.mark_blocks, fm.mark_cp, fm.ssa_values
    if mb.dim() != 2 or mb.shape[1] != MARK_WORDS_PER_BLOCK or mcp.shape != (mb.shape[0] + 1,):
        raise ValueError(f"{name}: expected (mb, {MARK_WORDS_PER_BLOCK}) mark blocks and (mb + 1,) "
                         f"checkpoints, got {tuple(mb.shape)} and {tuple(mcp.shape)}")
    if ssa.dim() != 1 or ssa.numel() == 0 or mb.shape[0] == 0:
        raise ValueError(f"{name}: the index has no marks or no sampled values")
    if fm.blocks.shape[0] * 128 <= fm.n:
        raise ValueError(f"{name}: the fused rows do not cover the index's {fm.n} symbols")
    check_table(fm, rows.device, name, marks=True)
    if not rows.is_cuda:  # last, so that CPU tensors reach every other check
        raise ValueError(f"{name} needs rows on a CUDA device")
    out = torch.empty_like(rows)
    if rows.numel() == 0:
        return out
    with torch.cuda.device(rows.device):
        rc = _library().gwa_locate(
            rows.data_ptr(), rows.numel(), fm.blocks.data_ptr(), fm.blocks.shape[0],
            fm.C.data_ptr(), fm.primary, fm.n, mb.data_ptr(), mb.shape[0], mcp.data_ptr(),
            ssa.data_ptr(), ssa.numel(), fm.sample_rate, out.data_ptr(), stream())
    if rc != 0:
        raise RuntimeError(f"gwa_locate launch failed: CUDA error {rc}")
    locate_cuda.launches += 1
    return out


locate_cuda.launches = 0


def locate_sharded_cuda(sh, rows: torch.Tensor) -> torch.Tensor:
    """Text positions of the BWT rows ``rows`` (int32, any shape, values in
    [0, n], on a CUDA device) over the interval shards of ``sh`` (a
    ``ShardedFMIndex`` after ``put_sharded``) -> int32 of that shape.
    Launches on the current stream without synchronising; counts each
    launch in ``.launches``."""
    name = "locate_sharded_cuda"
    _check_rows(rows, name)
    check_sharded(sh, rows.device, name)
    if not rows.is_cuda:  # last, so that CPU tensors reach every other check
        raise ValueError(f"{name} needs rows on a CUDA device")
    out = torch.empty_like(rows)
    if rows.numel() == 0:
        return out
    S, R = sh.bwt_blocks.shape[:2]
    with torch.cuda.device(rows.device):
        rc = _library().gwa_locate_sharded(
            rows.data_ptr(), rows.numel(), S, R, sh.bwt_blocks.data_ptr(), sh.occ_cp.data_ptr(),
            sh.pk_start.data_ptr(), sh.pk_end.data_ptr(), sh.mark_blocks.shape[1],
            sh.mark_blocks.data_ptr(), sh.mark_cp.data_ptr(), sh.row_start.data_ptr(),
            sh.row_end.data_ptr(), sh.ssa_values.shape[1], sh.ssa_values.data_ptr(),
            sh.ssa_base.data_ptr(), sh.C.data_ptr(), sh.primary, sh.n, sh.sample_rate,
            out.data_ptr(), stream())
    if rc != 0:
        raise RuntimeError(f"gwa_locate_sharded launch failed ({S} shards): CUDA error {rc}")
    locate_sharded_cuda.launches += 1
    return out


locate_sharded_cuda.launches = 0
