"""Binding of the hand-written CUDA banded-DP kernels (``csrc/banded_dp.cu``,
and ``csrc/banded_group.cu`` for the group of threads a lane).

The kernel replaces the JAX package's Pallas kernel
``genome_weaver_align_tpu/ops/dp_pallas.py::_kernel``.  It has two entries
over one kernel body:

- ``banded_edit_distance_text_cuda``: windows gathered from the 2-bit
  packed text inside the kernel, reads picked by a read id per lane; equal
  to ``ops.dp.banded_edit_distance_text_plain``;
- ``banded_edit_distance_cuda``: (Q, W) int8 windows and (Q, L) reads; equal
  to ``ops.dp.banded_edit_distance``.

Both take any band half-width k >= 0 and any read length below INF, as
the plain version does: one thread a lane for k <= ``REGISTER_K``, a group
of 8-32 threads a lane for k <= ``GROUP_K``, a warp a lane over a scratch
buffer (allocated here) past it; rows staged in shared memory while a
block's lanes x L fits it, read from global memory past that.

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
from .dp import INF

REGISTER_K = 16  # one thread a lane (the band in registers) for k = 0..REGISTER_K
GROUP_K = 127  # a group of 8-32 threads a lane, 9-16 band slots a thread, up to here
DESIGNS = ("lane", "group", "scratch")


def design(k: int) -> str:
    """The kernel a launch at band half-width k runs: one thread a lane, a
    group of threads a lane, or a warp a lane over scratch."""
    return "lane" if k <= REGISTER_K else "group" if k <= GROUP_K else "scratch"


@functools.cache
def _library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    lib = load_kernel_library("banded_dp.cu")
    vp, i32 = ctypes.c_void_p, ctypes.c_int32
    lib.gwa_banded_dp.argtypes = [
        vp, vp, vp, vp, vp, vp, vp, vp, ctypes.c_int64, i32, i32, i32, i32, i32, i32, vp,
        ctypes.c_int64, vp,
    ]
    lib.gwa_banded_dp.restype = ctypes.c_int
    lib.gwa_banded_dp_scratch_words.argtypes = [ctypes.c_int64, i32]
    lib.gwa_banded_dp_scratch_words.restype = ctypes.c_int64
    return lib


@functools.cache
def _group_library() -> ctypes.CDLL:
    """Build and load the group kernel's library (k = REGISTER_K + 1 ..
    GROUP_K)."""
    lib = load_kernel_library("banded_group.cu")
    vp, i32 = ctypes.c_void_p, ctypes.c_int32
    lib.gwa_banded_group.argtypes = [
        vp, vp, vp, vp, vp, vp, vp, vp, ctypes.c_int64, i32, i32, i32, i32, i32, i32, vp,
    ]
    lib.gwa_banded_group.restype = ctypes.c_int
    return lib


def _check_common(reads: torch.Tensor, lengths: torch.Tensor, k: int, name: str) -> None:
    if reads.dtype != torch.int8 or lengths.dtype != torch.int32:
        raise ValueError(f"{name}: expected int8 reads and int32 lengths, got "
                         f"{reads.dtype}/{lengths.dtype}")
    if reads.dim() != 2 or lengths.shape != (reads.shape[0],):
        raise ValueError(f"{name}: shape mismatch: reads {tuple(reads.shape)}, lengths "
                         f"{tuple(lengths.shape)}")
    if not 0 <= k < INF:  # the plain version's band needs 4k + 1 >= 1 slots
        raise ValueError(f"k={k}: the banded DP takes 0 <= k < {INF}")
    L = reads.shape[1]
    if L >= INF:  # distances must stay below the saturation value
        raise ValueError(f"read length {L} >= {INF}: kernel would saturate")


def _launch(reads, lengths, rid, windows, text, starts, Q: int, W: int, nw: int, n_text: int,
            k: int):
    dev = reads.device
    dist = torch.empty(Q, dtype=torch.int32, device=dev)
    end_b = torch.empty(Q, dtype=torch.int32, device=dev)
    if Q == 0:
        return dist, end_b
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    args = (ptr(reads), ptr(lengths), ptr(rid), ptr(windows), ptr(text), ptr(starts),
            dist.data_ptr(), end_b.data_ptr(), Q, reads.shape[0], reads.shape[1], W, nw, n_text, k)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if design(k) == "group":
            rc = _group_library().gwa_banded_group(*args, stream)
        else:
            lib = _library()
            n_scratch = lib.gwa_banded_dp_scratch_words(Q, k)
            scratch = torch.empty(n_scratch, dtype=torch.int32, device=dev) if n_scratch else None
            rc = lib.gwa_banded_dp(*args, ptr(scratch), n_scratch, stream)
    if rc != 0:
        raise RuntimeError(f"gwa_banded_dp launch failed (k = {k}): CUDA error {rc}")
    return dist, end_b


def banded_edit_distance_cuda(
    reads: torch.Tensor,  # (Q, L) int8 codes on a CUDA device
    lengths: torch.Tensor,  # (Q,) int32
    windows: torch.Tensor,  # (Q, W) int8
    k: int,
):
    """Launch the windows entry -> (dist (Q,) int32, end_b (Q,) int32),
    equal to ``ops.dp.banded_edit_distance`` on every lane.  Launches on the
    current stream without synchronising; counts each launch in
    ``.launches`` and, by the kernel design it ran (``design``), in
    ``.by_design``."""
    if not (reads.is_cuda and lengths.device == reads.device == windows.device):
        raise ValueError("banded_edit_distance_cuda needs all tensors on one CUDA device")
    if windows.dtype != torch.int8:
        raise ValueError(f"expected int8 windows, got {windows.dtype}")
    _check_common(reads, lengths, k, "banded_edit_distance_cuda")
    if windows.dim() != 2 or windows.shape[0] != reads.shape[0]:
        raise ValueError(f"shape mismatch: reads {tuple(reads.shape)}, windows "
                         f"{tuple(windows.shape)}")
    if not (reads.is_contiguous() and windows.is_contiguous() and lengths.is_contiguous()):
        raise ValueError("banded_edit_distance_cuda needs contiguous tensors")
    Q = reads.shape[0]
    out = _launch(reads, lengths, None, windows, None, None, Q, windows.shape[1], 0, 0, k)
    if Q:
        banded_edit_distance_cuda.launches += 1
        banded_edit_distance_cuda.by_design[design(k)] += 1
    return out


banded_edit_distance_cuda.launches = 0
banded_edit_distance_cuda.by_design = dict.fromkeys(DESIGNS, 0)  # launches by kernel design


def banded_edit_distance_text_cuda(
    text_words: torch.Tensor,  # (nw,) int32 packed text, 16 bases a word
    n_text: int,  # text length in bases
    starts: torch.Tensor,  # (Q,) int32 window starts (may be negative or past n_text)
    reads: torch.Tensor,  # (B, L) int8 codes
    lengths: torch.Tensor,  # (B,) int32
    rid: torch.Tensor,  # (Q,) int32 read of each lane, in [0, B)
    k: int,
    W: int,
):
    """Launch the text entry -> (dist (Q,) int32, end_b (Q,) int32), equal
    to ``ops.dp.banded_edit_distance_text_plain`` on every lane.  A rid
    outside [0, B) is clamped into it (the plain version raises).  Launches
    on the current stream without synchronising; counts each launch in
    ``.launches`` and ``.by_design``."""
    ts = (text_words, starts, reads, lengths, rid)
    if not (reads.is_cuda and all(t.device == reads.device for t in ts)):
        raise ValueError("banded_edit_distance_text_cuda needs all tensors on one CUDA device")
    if text_words.dtype != torch.int32 or starts.dtype != torch.int32 or rid.dtype != torch.int32:
        raise ValueError(f"expected int32 text words, starts and rid, got "
                         f"{text_words.dtype}/{starts.dtype}/{rid.dtype}")
    _check_common(reads, lengths, k, "banded_edit_distance_text_cuda")
    if text_words.dim() != 1 or starts.dim() != 1 or rid.shape != starts.shape:
        raise ValueError(f"shape mismatch: text {tuple(text_words.shape)}, starts "
                         f"{tuple(starts.shape)}, rid {tuple(rid.shape)}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("banded_edit_distance_text_cuda needs contiguous tensors")
    Q = starts.shape[0]
    if Q and (reads.shape[0] == 0 or text_words.shape[0] == 0):
        raise ValueError("banded_edit_distance_text_cuda needs at least one read and one text word")
    if not 0 <= n_text < 1 << 31 or W < 0:
        raise ValueError(f"n_text={n_text}, W={W}: out of the kernel's int32 range")
    out = _launch(reads, lengths, rid, None, text_words, starts, Q, W, text_words.shape[0],
                  n_text, k)
    if Q:
        banded_edit_distance_text_cuda.launches += 1
        banded_edit_distance_text_cuda.by_design[design(k)] += 1
    return out


banded_edit_distance_text_cuda.launches = 0
banded_edit_distance_text_cuda.by_design = dict.fromkeys(DESIGNS, 0)
