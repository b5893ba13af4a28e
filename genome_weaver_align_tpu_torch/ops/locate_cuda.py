"""Binding of the hand-written CUDA LF-walk locate (``csrc/locate.cu``).

The kernels replace the JAX package's device loops
``genome_weaver_align_tpu/ops/rank.py:234`` (``locate``) and
``genome_weaver_align_tpu/parallel/sharded_index.py:267`` (the sharded
``locate``): a persistent grid whose threads walk one row after another,
the whole walk of every row in one launch, stopping at the row's first
sampled row.  ``locate_cuda`` is equal to ``ops.rank.locate_plain``
and ``locate_sharded_cuda`` to ``parallel.sharded_index.locate_plain``
with the default merge.

``launch_shape`` gives a launch's grid and capacity (the walks the grid
holds at once; a thread whose row is done takes the row the grid's threads
further on).  ``ops._cuda_build`` compiles the source at first use with ``nvcc`` for ``sm_90a`` into the gitignored ``_build/``
directory; without ``nvcc``, or when the build fails, loading raises:
there is no fallback to the plain versions.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ._cuda_build import load_kernel_library
from .fm_search_cuda import (
    PTRS, check_sharded, check_table, owner_divisor, packed_divisor, shard_ptrs, sharded_args,
    sm_count, stream,
)
from .rank import MARK_WORDS_PER_BLOCK, DeviceFMIndex

I32 = torch.int32
THREADS = 256  # csrc/locate.cu kThreads
MAX_ROWS = 1 << 30  # csrc/locate.cu launch: a thread's next row stays inside int32


@functools.cache
def _library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    lib = load_kernel_library("locate.cu")
    vp, i32, i64, u32 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64, ctypes.c_uint32
    lib.gwa_locate.argtypes = [
        vp, i64, vp, i32, vp, i32, i32, vp, i32, vp, vp, i32, i32, vp, i32, vp,
    ]
    lib.gwa_locate_sharded.argtypes = [
        vp, i64, i32, i32, PTRS, PTRS, vp, vp, u32, i32, i32, i32, PTRS, PTRS, vp, vp, u32, i32,
        i32, i32, PTRS, vp, vp, i32, i32, i32, vp, i32, vp, vp,
    ]
    lib.gwa_locate_resident.argtypes = [i32, ctypes.POINTER(ctypes.c_int)]
    for fn in (lib.gwa_locate, lib.gwa_locate_sharded, lib.gwa_locate_resident):
        fn.restype = ctypes.c_int
    return lib


@functools.cache
def _resident(index: int, sharded: bool) -> int:
    """Blocks of a locate kernel that fit on one SM of device ``index``."""
    blocks = ctypes.c_int(0)
    with torch.cuda.device(index):
        rc = _library().gwa_locate_resident(int(sharded), ctypes.byref(blocks))
    if rc != 0 or blocks.value < 1:
        raise RuntimeError(f"gwa_locate_resident failed: CUDA error {rc}, {blocks.value} blocks")
    return blocks.value


def launch_shape(Q: int, dev: torch.device, sharded: bool) -> tuple[int, int]:
    """(blocks, capacity) of a launch over ``Q`` rows on ``dev``: the
    persistent grid is the blocks that fit on the SMs at once, no more than
    the rows need; its capacity is the walks it holds at once (blocks x 256
    threads)."""
    if not 0 <= Q <= MAX_ROWS:
        raise ValueError(f"{Q} rows: the locate kernels take 0 to 2^30")
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    most = _resident(index, sharded) * sm_count(dev)
    return max(1, min(most, -(-Q // THREADS))), most * THREADS


def _check_rows(rows: torch.Tensor, name: str) -> None:
    if rows.dtype != I32 or not rows.is_contiguous():
        raise ValueError(f"{name}: expected contiguous int32 rows, got {rows.dtype}")
    if rows.numel() > MAX_ROWS:
        raise ValueError(f"{name}: {rows.numel()} rows: the kernels take at most 2^30")


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
    grid, _ = launch_shape(rows.numel(), rows.device, False)
    with torch.cuda.device(rows.device):
        rc = _library().gwa_locate(
            rows.data_ptr(), rows.numel(), fm.blocks.data_ptr(), fm.blocks.shape[0],
            fm.C.data_ptr(), fm.primary, fm.n, mb.data_ptr(), mb.shape[0], mcp.data_ptr(),
            ssa.data_ptr(), ssa.numel(), fm.sample_rate, out.data_ptr(), grid, stream())
    if rc != 0:
        raise RuntimeError(f"gwa_locate launch failed: CUDA error {rc}")
    locate_cuda.launches += 1
    return out


locate_cuda.launches = 0


def locate_sharded_cuda(sh, rows: torch.Tensor) -> torch.Tensor:
    """Text positions of the BWT rows ``rows`` (int32, any shape, values in
    [0, n], on a CUDA device) over the interval shards of ``sh`` (a
    ``ShardedFMIndex`` after ``put_sharded``: stacked, or one tensor a
    shard, some mapped from other processes) -> int32 of that shape.  Each
    step's owners are guessed by division (``shard_fm_index``'s equal
    widths: nbs = R - 1 blocks of 128 packed coordinates, mbs mark blocks
    of 128 rows) and confirmed against the bounds; other bounds take a scan.
    Launches on the current stream without synchronising; counts each
    launch in ``.launches``."""
    name = "locate_sharded_cuda"
    _check_rows(rows, name)
    per = check_sharded(sh, rows.device, name)
    if not rows.is_cuda:  # last, so that CPU tensors reach every other check
        raise ValueError(f"{name} needs rows on a CUDA device")
    out = torch.empty_like(rows)
    if rows.numel() == 0:
        return out
    S, R = len(per["bwt_blocks"]), per["bwt_blocks"][0].shape[0]
    mbs = per["mark_blocks"][0].shape[0]
    ptrs = {key: shard_ptrs(ts) for key, ts in per.items()}
    grid, _ = launch_shape(rows.numel(), rows.device, True)
    keys = ("bwt_blocks", "occ_cp", "mark_blocks", "mark_cp", "ssa_values")
    with torch.cuda.device(rows.device):
        table, pk_facts, row_facts = sharded_args(
            rows.device, [per[key] for key in keys], (sh.pk_start, sh.pk_end),
            (sh.row_start, sh.row_end))
        rc = _library().gwa_locate_sharded(
            rows.data_ptr(), rows.numel(), S, R, ptrs["bwt_blocks"], ptrs["occ_cp"],
            sh.pk_start.data_ptr(), sh.pk_end.data_ptr(), *packed_divisor(sh), pk_facts, mbs,
            ptrs["mark_blocks"], ptrs["mark_cp"], sh.row_start.data_ptr(),
            sh.row_end.data_ptr(), *owner_divisor(mbs * 128), row_facts,
            per["ssa_values"][0].shape[0], ptrs["ssa_values"], sh.ssa_base.data_ptr(),
            sh.C.data_ptr(), sh.primary, sh.n, sh.sample_rate, out.data_ptr(), grid, table,
            stream())
    if rc != 0:
        raise RuntimeError(f"gwa_locate_sharded launch failed ({S} shards): CUDA error {rc}")
    locate_sharded_cuda.launches += 1
    return out


locate_sharded_cuda.launches = 0
