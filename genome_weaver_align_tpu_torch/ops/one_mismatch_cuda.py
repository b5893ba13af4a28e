"""Binding of the hand-written CUDA one-mismatch search
(``csrc/one_mismatch.cu``).

The kernel replaces the JAX package's device loops of
``genome_weaver_align_tpu/models/one_mismatch.py`` (the spines :101, case
A :127, case B :150, with ``_compact`` :40 and ``_spawn`` :48): one group
of lanes a (read, case), both cases in one launch, lanes only on live work
(the spine, live slots and case B's distinct dead chains), any
``n_slots``.  ``one_mismatch_candidates_cuda`` is equal to
``models.one_mismatch.one_mismatch_candidates_plain`` on every output, the
stale intervals of dead branch slots included.  The binding picks the
lanes a group from the batch (``lanes_for``; the entry takes more where a
warp's groups outgrow a block's shared memory), and allocates global
scratch for pools that outgrow it even at a warp a group
(``gwa_one_mismatch_scratch_ints``).

``ops._cuda_build`` compiles the source at first use with ``nvcc`` for
``sm_90a`` into the gitignored ``_build/`` directory; without ``nvcc``, or
when the build fails, loading raises: there is no fallback to the plain
version.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ._cuda_build import load_kernel_library
from .fm_search_cuda import check_reads, check_table, group_lanes, sm_count, stream

I32 = torch.int32
# lanes a (read, case) when the reads are many, and few: the fastest at
# 16,384 reads, and within 4% of the fastest at 512-4,096 (PERF.md §6)
LEAST, MOST = 2, 4


@functools.cache
def _library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    lib = load_kernel_library("one_mismatch.cu")
    vp, i32 = ctypes.c_void_p, ctypes.c_int32
    lib.gwa_one_mismatch.argtypes = [
        vp, vp, i32, i32, i32, i32, vp, vp, i32, vp, vp, i32, i32, vp, vp, vp, i32, vp,
        ctypes.c_int64, vp,
    ]
    lib.gwa_one_mismatch.restype = ctypes.c_int
    lib.gwa_one_mismatch_scratch_ints.argtypes = [i32, i32, ctypes.c_int64]
    lib.gwa_one_mismatch_scratch_ints.restype = ctypes.c_int64
    return lib


def lanes_for(reads: int, dev: torch.device) -> int:
    """Lanes a (read, case): ``MOST`` while the launch fits
    ``group_lanes``' lanes an SM, fewer as the reads grow, down to
    ``LEAST`` (the kernel's entry takes more where a warp's groups outgrow
    a block's shared memory)."""
    return group_lanes(2 * reads, LEAST, MOST, sm_count(dev))


def one_mismatch_candidates_cuda(
    bi,  # models.bidirectional.DeviceBiIndex
    reads: torch.Tensor,  # (B, L) int32 search codes 0..3, contiguous, on a CUDA device
    lengths: torch.Tensor,  # (B,) int32
    steps: int,  # the plain version's step count
    n_slots: int,
):
    """Launch the search -> (cand_lo, cand_hi) (B, 2 n_slots + 1) int32 and
    overflow (B,) bool.  Launches on the current stream without
    synchronising; counts each launch in ``.launches``."""
    name = "one_mismatch_candidates_cuda"
    if n_slots < 1:
        raise ValueError(f"{name}: n_slots={n_slots}: the kernel takes one or more")
    check_reads(reads, lengths, name)
    for fm in (bi.fwd, bi.rev):
        check_table(fm, reads.device, name)
    if bi.fwd.n != bi.rev.n:
        raise ValueError(f"{name}: forward and reverse tables of different texts")
    B, L = reads.shape
    dev = reads.device
    cand_lo = torch.empty((B, 2 * n_slots + 1), dtype=I32, device=dev)
    cand_hi = torch.empty((B, 2 * n_slots + 1), dtype=I32, device=dev)
    overflow = torch.zeros(B, dtype=torch.bool, device=dev)  # a case writes 1 where it overflows
    if B == 0:
        return cand_lo, cand_hi, overflow
    lanes = lanes_for(B, dev)
    with torch.cuda.device(dev):
        n_scratch = _library().gwa_one_mismatch_scratch_ints(lanes, n_slots, B)
        scratch = torch.empty(n_scratch, dtype=I32, device=dev) if n_scratch else None
        rc = _library().gwa_one_mismatch(
            reads.data_ptr(), lengths.data_ptr(), B, L, n_slots, max(steps, 0),
            bi.fwd.blocks.data_ptr(), bi.fwd.C.data_ptr(), bi.fwd.primary,
            bi.rev.blocks.data_ptr(), bi.rev.C.data_ptr(), bi.rev.primary, bi.fwd.n,
            cand_lo.data_ptr(), cand_hi.data_ptr(), overflow.data_ptr(), lanes,
            None if scratch is None else scratch.data_ptr(), n_scratch, stream(),
        )
    if rc != 0:
        raise RuntimeError(f"gwa_one_mismatch launch failed: CUDA error {rc}")
    one_mismatch_candidates_cuda.launches += 1
    return cand_lo, cand_hi, overflow


one_mismatch_candidates_cuda.launches = 0
