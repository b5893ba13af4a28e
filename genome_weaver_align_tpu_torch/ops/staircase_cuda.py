"""Binding of the hand-written CUDA staircase search (``csrc/staircase.cu``).

The kernel replaces the JAX package's device loops of
``genome_weaver_align_tpu/models/staircase.py`` (the spine :131, the
forward staircase :215, the left narrowing :235 and ``_compact_pool``
:43): one group of lanes a (piece, read) pool, the whole search in one
launch, up to and including each pool's compaction to ``keep`` slots, lanes
only on live slots, any ``n_slots``.  ``staircase_pools_cuda`` is equal to
``models.staircase.staircase_pools_plain`` on every output.  The binding
picks the lanes a pool from the pool count, ``n_slots`` and
``narrow_left`` (``lanes_for``; the entry takes more where a warp's pools
outgrow a block's shared memory), and allocates global scratch for pools
that outgrow it even at a warp a pool (``gwa_staircase_scratch_ints``).

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
from .fm_search_cuda import MAX_PIECES, check_reads, check_table, group_lanes, sm_count, stream

I32 = torch.int32


@functools.cache
def _library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    lib = load_kernel_library("staircase.cu")
    vp, i32 = ctypes.c_void_p, ctypes.c_int32
    lib.gwa_staircase.argtypes = [
        vp, vp, i32, i32, i32, i32, i32, i32, i32, i32, i32, i32, vp, vp, i32, vp, vp, i32, i32,
        vp, vp, vp, i32, vp, ctypes.c_int64, vp,
    ]
    lib.gwa_staircase.restype = ctypes.c_int
    lib.gwa_staircase_scratch_ints.argtypes = [i32, i32, ctypes.c_int64]
    lib.gwa_staircase_scratch_ints.restype = ctypes.c_int64
    return lib


def lanes_for(pools: int, n_slots: int, narrow_left: bool, dev: torch.device) -> int:
    """Lanes a pool: a whole warp under ``narrow_left`` (rank-major
    placement counts a step's parents by ballot; a warp takes two slots a
    lane past 32); else enough for a pool's slots in one pass while the
    launch fits ``group_lanes``' lanes an SM, fewer as the pools grow, down
    to one (the kernel's entry takes more where a warp's pools outgrow a
    block's shared memory)."""
    if narrow_left:
        return 32
    return group_lanes(pools, 1, min(32, 1 << (n_slots - 1).bit_length()), sm_count(dev))


def staircase_pools_cuda(
    bi,  # models.bidirectional.DeviceBiIndex
    reads: torch.Tensor,  # (B, L) int32 search codes 0..3, contiguous, on a CUDA device
    lengths: torch.Tensor,  # (B,) int32
    k: int,
    n_slots: int,
    keep: int,
    spine_steps: int,
    fwd_steps: int,
    bwd_steps: int,
    narrow_left: bool,
):
    """Launch the search -> (lo, hi) (P, B, keep) int32 and overflow (P, B)
    bool, P = k + 1, for the plain version's trip counts.  Launches on the
    current stream without synchronising; counts each launch in
    ``.launches``."""
    name = "staircase_pools_cuda"
    P = k + 1
    if not 1 <= P <= MAX_PIECES:
        raise ValueError(f"{name}: k={k}: the kernel takes 0 <= k < {MAX_PIECES}")
    if n_slots < 1:
        raise ValueError(f"{name}: n_slots={n_slots}: the kernel takes one or more")
    if keep < 0:
        raise ValueError(f"{name}: keep={keep} must be >= 0")
    check_reads(reads, lengths, name)
    for fm in (bi.fwd, bi.rev):
        check_table(fm, reads.device, name)
    if bi.fwd.n != bi.rev.n:
        raise ValueError(f"{name}: forward and reverse tables of different texts")
    B, L = reads.shape
    dev = reads.device
    lo = torch.empty((P, B, keep), dtype=I32, device=dev)
    hi = torch.empty((P, B, keep), dtype=I32, device=dev)
    overflow = torch.empty((P, B), dtype=torch.bool, device=dev)
    if B == 0:
        return lo, hi, overflow
    lanes = lanes_for(P * B, n_slots, narrow_left, dev)
    with torch.cuda.device(dev):
        n_scratch = _library().gwa_staircase_scratch_ints(lanes, n_slots, P * B)
        scratch = torch.empty(n_scratch, dtype=I32, device=dev) if n_scratch else None
        rc = _library().gwa_staircase(
            reads.data_ptr(), lengths.data_ptr(), B, L, P, k, n_slots, keep,
            max(spine_steps, 0), max(fwd_steps, 0), max(bwd_steps, 0), int(narrow_left),
            bi.fwd.blocks.data_ptr(), bi.fwd.C.data_ptr(), bi.fwd.primary,
            bi.rev.blocks.data_ptr(), bi.rev.C.data_ptr(), bi.rev.primary, bi.fwd.n,
            lo.data_ptr(), hi.data_ptr(), overflow.data_ptr(), lanes,
            None if scratch is None else scratch.data_ptr(), n_scratch, stream(),
        )
    if rc != 0:
        raise RuntimeError(f"gwa_staircase launch failed: CUDA error {rc}")
    staircase_pools_cuda.launches += 1
    return lo, hi, overflow


staircase_pools_cuda.launches = 0
