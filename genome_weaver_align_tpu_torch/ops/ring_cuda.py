"""Binding of the hand-written CUDA all-reduce kernels (``csrc/ring.cu``).

``ring_allreduce_cuda`` replaces the JAX package's Pallas kernel
``genome_weaver_align_tpu/parallel/ring.py::_ring_kernel`` and
``fused_rank_ring_cuda`` replaces ``_fused_rank_ring_kernel``; they compute
exactly ``parallel.ring.ring_psum_plain`` and ``fused_rank_ring_plain``.
``ops._cuda_build`` compiles the source at first use with ``nvcc`` for
``sm_90a``; without ``nvcc``, or when the build fails, loading raises: there
is no fallback to the plain versions.

``ring_allreduce_cuda`` is one pass over every shard's input: no flags, no
scratch, nothing read back.  The fused kernel runs the ring's multi-hop flag
protocol: each shard's scratch (two receive slots per thread block, and the
flags) is its own tensor, cached per device and grown on demand, and every
launch takes a new epoch that tags its flags (see the source).  Launches
that share the scratch must run in one stream order: one stream at a time
per device.  A fused ring whose flag wait passes about 1 s sets an error
word; with ``check=True`` the wrapper reads it after the launch (a
synchronising read) and raises ``RuntimeError``; with ``check=False`` the
caller calls ``raise_if_failed`` later.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ._cuda_build import load_kernel_library

MAX_SHARDS = 16
MAX_PAYLOADS = 8  # the fused kernel is instantiated for M = 1..MAX_PAYLOADS
_INPUTS = 5
_DTYPES = {torch.int32: 0, torch.float32: 1}
_STUCK = {1: "a capacity grant", 2: "a receive flag"}


@functools.cache
def _library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    lib = load_kernel_library("ring.cu")
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    lib.gwa_allreduce.argtypes = [i32, i32, i64, vp, vp, vp]
    lib.gwa_allreduce.restype = ctypes.c_int
    lib.gwa_ring_plan.argtypes = [i32, i32, i64, ctypes.POINTER(i32), ctypes.POINTER(i64)]
    lib.gwa_ring_plan.restype = ctypes.c_int
    lib.gwa_ring_launch.argtypes = [
        i32, i32, i32, i64, vp, vp, vp, vp, ctypes.c_uint64, vp, i32, vp,
    ]
    lib.gwa_ring_launch.restype = ctypes.c_int
    return lib


class _Scratch:
    """One device's fused-ring scratch: per-shard slots and flags, the error
    word, the epoch counter."""

    def __init__(self, device: torch.device):
        self.device = device
        self.slots: list[torch.Tensor] = []
        self.flags: list[torch.Tensor] = []
        self.err = torch.zeros(1, dtype=torch.int32, device=device)
        self.epoch = 0

    def reserve(self, S: int, slot_elems: int, n_flags: int):
        while len(self.slots) < S:
            self.slots.append(torch.empty(0, dtype=torch.int32, device=self.device))
            self.flags.append(torch.zeros(0, dtype=torch.int64, device=self.device))
        for d in range(S):
            if self.slots[d].numel() < slot_elems:
                self.slots[d] = torch.empty(slot_elems, dtype=torch.int32, device=self.device)
            if self.flags[d].numel() < n_flags:
                # zero flags lie below every epoch's values
                self.flags[d] = torch.zeros(n_flags, dtype=torch.int64, device=self.device)
        self.epoch += 1
        if self.epoch >= 1 << 32:
            raise RuntimeError("ring flag epochs exhausted on this device")
        return self.epoch


_scratch: dict[torch.device, _Scratch] = {}


def _scratch_for(device: torch.device) -> _Scratch:
    if device not in _scratch:
        _scratch[device] = _Scratch(device)
    return _scratch[device]


def raise_if_failed(device) -> None:
    """Raise ``RuntimeError`` if a fused ring launch on ``device`` timed out
    (synchronises with the device); clears the error word."""
    sc = _scratch.get(torch.device(device))
    if sc is None:
        return
    code = int(sc.err.item())
    if code:
        sc.err.zero_()
        raise RuntimeError(
            f"ring kernel stuck on {sc.device}: a block waited over 1 s for "
            f"{_STUCK.get(code, f'flag (code {code})')}; the result is invalid"
        )


def _run_fused(M: int, ins: list[list[torch.Tensor]], out: torch.Tensor, Q: int, check: bool,
               stall_shard: int) -> None:
    """Plan, reserve scratch, launch the fused ring over S shards (``ins[d]``
    the inputs of shard d, ``out[d]`` its output).  ``stall_shard`` >= 0
    makes that shard's blocks return at once (the no-hang test): its
    neighbours time out."""
    lib = _library()
    S = len(ins)
    dev = out.device
    G, slot_elems = ctypes.c_int32(0), ctypes.c_int64(0)
    with torch.cuda.device(dev):
        rc = lib.gwa_ring_plan(M, S, Q, ctypes.byref(G), ctypes.byref(slot_elems))
        if rc != 0:
            raise RuntimeError(f"gwa_ring_plan failed for {S} shards: CUDA error {rc}")
        sc = _scratch_for(dev)
        epoch = sc.reserve(S, slot_elems.value, 2 * G.value)
        ptr_in = (ctypes.c_uint64 * (S * _INPUTS))()
        for d, tensors in enumerate(ins):
            for i, t in enumerate(tensors):
                ptr_in[d * _INPUTS + i] = t.data_ptr()
        ptr_out = (ctypes.c_uint64 * S)(*[out[d].data_ptr() for d in range(S)])
        ptr_slot = (ctypes.c_uint64 * S)(*[sc.slots[d].data_ptr() for d in range(S)])
        ptr_flag = (ctypes.c_uint64 * S)(*[sc.flags[d].data_ptr() for d in range(S)])
        rc = lib.gwa_ring_launch(
            M, S, G.value, Q, ptr_in, ptr_out, ptr_slot, ptr_flag, epoch,
            sc.err.data_ptr(), stall_shard, torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"gwa_ring_launch failed ({S} shards x {G.value} blocks): CUDA error {rc}"
        )
    if check:
        raise_if_failed(dev)


def _check_shards(S: int) -> None:
    if not 1 <= S <= MAX_SHARDS:
        raise ValueError(f"{S} shards: the ring kernels take 1..{MAX_SHARDS}")


def ring_allreduce_cuda(parts: torch.Tensor) -> torch.Tensor:
    """All-reduce over the leading shard axis of a CUDA tensor ``(S, ...)``
    int32 or float32: every shard's row of the result holds the sum, added
    in ``ring_psum_plain``'s order.  One kernel pass; launches on the
    current stream without synchronising.  Counts each launch in
    ``.launches``."""
    # Bad input: the kernel is built for int32 and float32 on the card; a
    # CPU tensor or another type raises here and never reaches a plain
    # version
    if not parts.is_cuda:
        raise ValueError("ring_allreduce_cuda needs a tensor on a CUDA device")
    if parts.dtype not in _DTYPES:
        raise TypeError(f"ring_allreduce_cuda takes int32 or float32, got {parts.dtype}")
    if parts.dim() < 1 or not parts.is_contiguous():
        raise ValueError("ring_allreduce_cuda needs a contiguous (S, ...) tensor")
    S = parts.shape[0]
    _check_shards(S)
    out = torch.empty_like(parts)
    n = parts[0].numel()
    if n == 0:
        return out
    flat, oflat = parts.reshape(S, n), out.view(S, n)
    ptr_in = (ctypes.c_uint64 * S)(*[flat[d].data_ptr() for d in range(S)])
    ptr_out = (ctypes.c_uint64 * S)(*[oflat[d].data_ptr() for d in range(S)])
    lib = _library()
    with torch.cuda.device(parts.device):
        rc = lib.gwa_allreduce(_DTYPES[parts.dtype], S, n, ptr_in, ptr_out,
                               torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gwa_allreduce launch failed ({S} shards): CUDA error {rc}")
    ring_allreduce_cuda.launches += 1
    return out


ring_allreduce_cuda.launches = 0


def fused_rank_ring_cuda(
    words: torch.Tensor,  # (S, M, Q, 8) int32, the uint32 BWT words of each query's block
    codes: torch.Tensor,  # (S, M, Q) int32 query base codes
    roff: torch.Tensor,  # (S, M, Q) int32 base offsets in the block (may exceed 128)
    base: torch.Tensor,  # (S, M, Q) int32 the owner's checkpoint value
    own: torch.Tensor,  # (S, M, Q) int32 1 where the shard owns the query
    check: bool = True,
    stall_shard: int = -1,
) -> torch.Tensor:
    """Fused occ-rank partials + ring all-reduce -> (S, M, Q) int32: every
    shard's row holds, per payload m, the sum over shards of
    ``own * (base + match count)``.  Counts each launch in ``.launches``."""
    ts = (words, codes, roff, base, own)
    if not all(t.is_cuda and t.device == words.device for t in ts):
        raise ValueError("fused_rank_ring_cuda needs all tensors on one CUDA device")
    if any(t.dtype != torch.int32 for t in ts):
        raise TypeError(f"fused_rank_ring_cuda takes int32 tensors, got {[t.dtype for t in ts]}")
    if words.dim() != 4 or words.shape[3] != 8 or any(t.shape != words.shape[:3] for t in ts[1:]):
        raise ValueError(
            f"expected words (S, M, Q, 8) and (S, M, Q) codes/roff/base/own, got "
            f"{[tuple(t.shape) for t in ts]}"
        )
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("fused_rank_ring_cuda needs contiguous tensors")
    if words.data_ptr() % 16:
        raise ValueError("fused_rank_ring_cuda loads each 32-byte word row as two 16-byte "
                         "vectors: words must start 16-byte aligned")
    S, M, Q = codes.shape
    _check_shards(S)
    if not 1 <= M <= MAX_PAYLOADS:
        raise ValueError(f"M={M}: the fused kernel is built for 1 <= M <= {MAX_PAYLOADS}")
    out = torch.empty((S, M, Q), dtype=torch.int32, device=words.device)
    if Q == 0:
        return out
    _run_fused(M, [[t[d] for t in ts] for d in range(S)], out, Q, check, stall_shard)
    fused_rank_ring_cuda.launches += 1
    return out


fused_rank_ring_cuda.launches = 0
