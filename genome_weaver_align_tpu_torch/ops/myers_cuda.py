"""Binding of the hand-written CUDA Myers kernel (``csrc/myers.cu``).

The kernel replaces the JAX package's Pallas kernel
``genome_weaver_align_tpu/ops/myers_pallas.py::_kernel``.  It has two
entries over one kernel body:

- ``myers_semiglobal_text_cuda``: windows streamed from the 2-bit packed
  text inside the kernel, reads picked by a read id per lane, columns at or
  after a per-lane bound never matching; equal to
  ``ops.myers.myers_semiglobal_text_plain``;
- ``myers_semiglobal_cuda``: (Q, W) windows and (Q, L) reads; equal to
  ``ops.myers.myers_semiglobal_end``.

``ops._cuda_build`` compiles it at first use with ``nvcc`` for ``sm_90a``;
without ``nvcc``, or when the build fails, loading raises: there is no
fallback to the plain versions.
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
    lib.gwa_myers_text.argtypes = [
        vp, i32, i32, vp, vp, vp, vp, vp, vp, vp, ctypes.c_int64, i32, i32, i32, i32, vp,
    ]
    lib.gwa_myers_text.restype = ctypes.c_int
    return lib


def _check_words(L: int, nwords: int) -> None:
    if L > MAX_LEN:
        raise ValueError(f"read length {L} > {MAX_LEN} unsupported")
    if not 1 <= nwords <= MAX_WORDS:
        raise ValueError(f"nwords={nwords}: the kernel is built for 1..{MAX_WORDS} words")


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
    nwords = max(1, -(-L // 32)) if nwords is None else nwords
    steps = W if steps is None else steps
    _check_words(L, nwords)
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


def myers_semiglobal_text_cuda(
    text_words: torch.Tensor,  # (nw,) int32 packed text, 16 bases a word
    n_text: int,  # text length in bases
    starts: torch.Tensor,  # (Q,) int32 window starts (may be negative or past n_text)
    reads: torch.Tensor,  # (B, L) int8 codes
    lengths: torch.Tensor,  # (B,) int32
    rid: torch.Tensor,  # (Q,) int32 read of each lane, in [0, B)
    valid: torch.Tensor,  # (Q,) int32 columns >= valid[q] never match
    W: int,  # window width
    nwords: int,  # bit-vector words
):
    """Launch the text entry -> (best (Q,) int32, end (Q,) int32), equal to
    ``ops.myers.myers_semiglobal_text_plain`` on every lane.  A rid outside
    [0, B) is clamped into it (the plain version raises).  Launches on the
    current stream without synchronising; counts each launch in
    ``.launches``."""
    ts = (text_words, starts, reads, lengths, rid, valid)
    if not (reads.is_cuda and all(t.device == reads.device for t in ts)):
        raise ValueError("myers_semiglobal_text_cuda needs all tensors on one CUDA device")
    if reads.dtype != torch.int8 or any(t.dtype != torch.int32 for t in ts if t is not reads):
        raise ValueError(f"expected int8 reads and int32 text words, starts, lengths, rid and "
                         f"valid, got {[t.dtype for t in ts]}")
    Q = starts.shape[0]
    if (text_words.dim() != 1 or reads.dim() != 2 or starts.dim() != 1
            or lengths.shape != (reads.shape[0],) or rid.shape != (Q,) or valid.shape != (Q,)):
        raise ValueError(f"shape mismatch: {[tuple(t.shape) for t in ts]}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("myers_semiglobal_text_cuda needs contiguous tensors")
    B, L = reads.shape
    _check_words(L, nwords)
    if not 0 <= n_text < 1 << 31 or W < 0:
        raise ValueError(f"n_text={n_text}, W={W}: out of the kernel's int32 range")
    best = torch.empty(Q, dtype=torch.int32, device=reads.device)
    end = torch.empty(Q, dtype=torch.int32, device=reads.device)
    if Q == 0:
        return best, end
    if B == 0 or text_words.shape[0] == 0:
        raise ValueError("myers_semiglobal_text_cuda needs at least one read and one text word")
    lib = _library()
    with torch.cuda.device(reads.device):
        rc = lib.gwa_myers_text(
            text_words.data_ptr(), text_words.shape[0], n_text, starts.data_ptr(),
            reads.data_ptr(), lengths.data_ptr(), rid.data_ptr(), valid.data_ptr(),
            best.data_ptr(), end.data_ptr(), Q, B, L, W, nwords,
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"gwa_myers_text launch failed: CUDA error {rc}")
    myers_semiglobal_text_cuda.launches += 1
    return best, end


myers_semiglobal_text_cuda.launches = 0
