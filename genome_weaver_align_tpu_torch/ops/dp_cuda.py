"""Binding of the hand-written CUDA banded-DP kernel (``csrc/banded_dp.cu``).

The kernel replaces the JAX package's Pallas kernel
``genome_weaver_align_tpu/ops/dp_pallas.py::_kernel``.  It has two entries
over one kernel body:

- ``banded_edit_distance_text_cuda``: windows gathered from the 2-bit
  packed text inside the kernel, reads picked by a read id per lane; equal
  to ``ops.dp.banded_edit_distance_text_plain``;
- ``banded_edit_distance_cuda``: (Q, W) int8 windows and (Q, L) reads; equal
  to ``ops.dp.banded_edit_distance``.

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

MAX_K = 16  # the kernel is instantiated for k = 1..MAX_K: the long-read band, kb = 16
_THREADS = 128  # lanes a block; the block stages up to this many read rows
_MAX_SMEM = 232_448  # shared memory a block can have on sm_90


@functools.cache
def _library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    lib = load_kernel_library("banded_dp.cu")
    vp, i32 = ctypes.c_void_p, ctypes.c_int32
    lib.gwa_banded_dp.argtypes = [
        vp, vp, vp, vp, vp, vp, vp, vp, ctypes.c_int64, i32, i32, i32, i32, i32, i32, vp,
    ]
    lib.gwa_banded_dp.restype = ctypes.c_int
    return lib


def _check_common(reads: torch.Tensor, lengths: torch.Tensor, k: int, name: str) -> None:
    if reads.dtype != torch.int8 or lengths.dtype != torch.int32:
        raise ValueError(f"{name}: expected int8 reads and int32 lengths, got "
                         f"{reads.dtype}/{lengths.dtype}")
    if reads.dim() != 2 or lengths.shape != (reads.shape[0],):
        raise ValueError(f"{name}: shape mismatch: reads {tuple(reads.shape)}, lengths "
                         f"{tuple(lengths.shape)}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k}: the CUDA banded DP is built for 1 <= k <= {MAX_K}")
    L = reads.shape[1]
    if L >= INF:  # distances must stay below the saturation value
        raise ValueError(f"read length {L} >= {INF}: kernel would saturate")
    if _THREADS * L + 16 > _MAX_SMEM:
        raise ValueError(f"read length {L}: {_THREADS} rows of it exceed a block's shared memory")


def _launch(reads, lengths, rid, windows, text, starts, Q: int, W: int, nw: int, n_text: int,
            k: int):
    dev = reads.device
    dist = torch.empty(Q, dtype=torch.int32, device=dev)
    end_b = torch.empty(Q, dtype=torch.int32, device=dev)
    if Q == 0:
        return dist, end_b
    lib = _library()
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(dev):
        rc = lib.gwa_banded_dp(
            ptr(reads), ptr(lengths), ptr(rid), ptr(windows), ptr(text), ptr(starts),
            dist.data_ptr(), end_b.data_ptr(), Q, reads.shape[0], reads.shape[1], W, nw,
            n_text, k, torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"gwa_banded_dp launch failed: CUDA error {rc}")
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
    ``.launches``."""
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
    return out


banded_edit_distance_cuda.launches = 0


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
    ``.launches``."""
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
    return out


banded_edit_distance_text_cuda.launches = 0
