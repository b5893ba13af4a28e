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

Both take any number of words, as the plain version does: one thread a
lane up to ``LANE_WORDS`` words, a group of 8-32 threads a lane (1-16
words a thread in registers, ``group_shape``) up to ``MEM_WORDS``, a warp
a lane over a scratch buffer (allocated here) past it.  A group runs as a
wavefront: thread j a window column behind thread j - 1.

``ops._cuda_build`` compiles it at first use with ``nvcc`` for ``sm_90a``;
without ``nvcc``, or when the build fails, loading raises: there is no
fallback to the plain versions.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ._cuda_build import load_kernel_library

LANE_WORDS = 8  # one thread a lane up to 8 words (256 bases), as the TPU kernel
MEM_WORDS = 512  # a group's words in registers up to here (16,384 bases)
DESIGNS = ("lane", "group", "scratch")
# words a thread the register design is built for (``csrc/myers.cu``
# ``dispatch``): those ``group_shape`` picks
REG_WORDS = (1, 4, 8, 16)


def group_shape(nwords: int) -> tuple[int, int]:
    """(G threads a lane, P words a thread) past ``LANE_WORDS`` words.  A
    wavefront time step is one thread's P-word chain, and what sets its
    pace is the instructions a warp issues a step: up to 16 words 16
    threads of one word (the 300 bp rescue's few hundred lanes leave most
    schedulers a warp or less, and a one-word step is the shortest), past
    them 4 words a thread (the step unrolled) on the power of two that
    covers nwords / 4, 8-32 threads, then a warp of 8 or 16.  Measured on
    an NVIDIA H100 80GB HBM3 at 700.00 W (``scripts/verify_kernels_ab.py``
    with ``DIR:GxP``, PERF.md section 6): [8]'s first 300 bp rescue call
    0.0670 ms at 16 x 1 against 0.1323 at 4 x 4 and 0.2847 at 8 x 8; at
    2,048 lanes 32 words 0.1485 ms at 8 x 4 against 0.3202 at 8 x 8, 64
    words 0.4906 at 16 x 4 against 0.5616 at 8 x 8.  Past ``MEM_WORDS`` a
    warp of ceil(nwords / 32) words a thread in scratch."""
    if nwords > MEM_WORDS:
        return 32, -(-nwords // 32)
    if nwords <= 16:
        return 16, 1
    for P in (4, 8, 16):
        need = -(-nwords // P)
        if need <= 32:
            return 1 << (need - 1).bit_length(), P
    raise AssertionError(nwords)


def design(nwords: int) -> str:
    """The kernel a launch over nwords words runs: one thread a lane, a
    group of threads a lane, or a warp a lane over scratch."""
    return "lane" if nwords <= LANE_WORDS else "group" if nwords <= MEM_WORDS else "scratch"


@functools.cache
def _library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    lib = load_kernel_library("myers.cu")
    vp, i32 = ctypes.c_void_p, ctypes.c_int32
    i64 = ctypes.c_int64
    lib.gwa_myers.argtypes = [vp, vp, vp, vp, vp, i64, i32, i32, i32, i32, i32, i32, i32, vp,
                              i64, vp]
    lib.gwa_myers.restype = ctypes.c_int
    lib.gwa_myers_text.argtypes = [
        vp, i32, i32, vp, vp, vp, vp, vp, vp, vp, i64, i32, i32, i32, i32, i32, i32, vp, i64, vp,
    ]
    lib.gwa_myers_text.restype = ctypes.c_int
    return lib


def _check_words(nwords: int) -> None:
    if not 1 <= nwords < 1 << 26:
        raise ValueError(f"nwords={nwords}: the kernel takes 1 <= nwords < 2^26")


SCRATCH_VECTORS = 6  # Peq x 4, PV, MV (``csrc/myers.cu`` kScratchVectors)


def _scratch(Q: int, nwords: int, G: int, P: int, device):
    """The scratch buffer a launch past ``MEM_WORDS`` words needs: (tensor
    or None, its words)."""
    n = SCRATCH_VECTORS * P * Q * G if nwords > MEM_WORDS else 0
    return (torch.empty(n, dtype=torch.int32, device=device) if n else None), n


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
    ``.launches`` and, by the kernel design it ran (``design``), in
    ``.by_design``."""
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
    _check_words(nwords)
    G, P = group_shape(nwords) if nwords > LANE_WORDS else (0, 0)
    if steps > 0 and W == 0:
        raise ValueError("windows have no columns to step over")
    best = torch.empty(Q, dtype=torch.int32, device=reads.device)
    end = torch.empty(Q, dtype=torch.int32, device=reads.device)
    if Q == 0:
        return best, end
    lib = _library()
    scratch, n_scratch = _scratch(Q, nwords, G, P, reads.device)
    with torch.cuda.device(reads.device):
        rc = lib.gwa_myers(
            reads.data_ptr(), lengths.data_ptr(), windows.data_ptr(),
            best.data_ptr(), end.data_ptr(), Q, L, W, nwords, G, P, steps,
            reads.element_size(), None if scratch is None else scratch.data_ptr(), n_scratch,
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"gwa_myers launch failed: CUDA error {rc}")
    myers_semiglobal_cuda.launches += 1
    myers_semiglobal_cuda.by_design[design(nwords)] += 1
    return best, end


myers_semiglobal_cuda.launches = 0
myers_semiglobal_cuda.by_design = dict.fromkeys(DESIGNS, 0)  # launches by kernel design


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
    ``.launches`` and ``.by_design``."""
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
    _check_words(nwords)
    G, P = group_shape(nwords) if nwords > LANE_WORDS else (0, 0)
    if not 0 <= n_text < 1 << 31 or W < 0:
        raise ValueError(f"n_text={n_text}, W={W}: out of the kernel's int32 range")
    best = torch.empty(Q, dtype=torch.int32, device=reads.device)
    end = torch.empty(Q, dtype=torch.int32, device=reads.device)
    if Q == 0:
        return best, end
    if B == 0 or text_words.shape[0] == 0:
        raise ValueError("myers_semiglobal_text_cuda needs at least one read and one text word")
    lib = _library()
    scratch, n_scratch = _scratch(Q, nwords, G, P, reads.device)
    with torch.cuda.device(reads.device):
        rc = lib.gwa_myers_text(
            text_words.data_ptr(), text_words.shape[0], n_text, starts.data_ptr(),
            reads.data_ptr(), lengths.data_ptr(), rid.data_ptr(), valid.data_ptr(),
            best.data_ptr(), end.data_ptr(), Q, B, L, W, nwords, G, P,
            None if scratch is None else scratch.data_ptr(), n_scratch,
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"gwa_myers_text launch failed: CUDA error {rc}")
    myers_semiglobal_text_cuda.launches += 1
    myers_semiglobal_text_cuda.by_design[design(nwords)] += 1
    return best, end


myers_semiglobal_text_cuda.launches = 0
myers_semiglobal_text_cuda.by_design = dict.fromkeys(DESIGNS, 0)
