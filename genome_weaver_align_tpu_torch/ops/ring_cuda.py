"""Binding of the hand-written CUDA all-reduce kernels (``csrc/ring.cu``).

``ring_allreduce_cuda`` replaces the JAX package's Pallas kernel
``genome_weaver_align_tpu/parallel/ring.py::_ring_kernel``; the fused occ
rank + shard sum that replaces ``_fused_rank_ring_kernel`` has two entries:

- ``fused_rank_ring_cuda``: the JAX function's contract, rows already
  gathered per shard; equal to ``parallel.ring.fused_rank_ring_plain``;
- ``fused_occ_cuda``: reads each query's row straight from the sharded
  tables (the sharded exact search's entry); equal to
  ``parallel.sharded_index.fused_occ_plain``.

``ring_allreduce_cuda`` equals ``parallel.ring.ring_psum_plain``.  Every
kernel is one pass over every shard's input: nothing to wait on, no
scratch, nothing read back.  A shard may be a row of a stacked tensor (the
kernel adds the stride), its own allocation, or another process's mapped
through CUDA IPC (on this card, whichever card holds the memory:
``parallel.peer``); this binding decides which, and passes the kernels
the addresses of shards apart as a device table (``fm_search_cuda.
address_table``, made once for a set of addresses), which the sum reads for
past 16 shards and the flag-wait push past 16 ranks (below, their pointers
are kernel parameters).  Past 16 shards the int32 sum spreads each 16-byte
vector's shards over a group of a warp's lanes, several loads in flight a
lane; every sum writes one output row where ``only`` names it.

``ring_allreduce_wait_cuda`` is the sum's flag-wait entry, for ranks on
separate cards: each rank's partial lies in its row of its own inbox, and
every rank's inbox is mapped on every card (``parallel.peer.share``).  Its
launch pushes this rank's row into every peer's inbox over NVLink,
publishes the merge's epoch into every peer's flag words, one word a
block, and waits, bounded, until every peer's block has published it; each
block then sums its chunk from its own inbox.  A wait that times out, or
that finds a peer's word poisoned, sets the error word, which
``check_flag_wait`` turns into an exception; from then on this rank
publishes the poison instead of its epochs, so every peer's wait fails
too.  It equals ``ring_psum_plain`` over the ranks' partials, this rank's
row.  ``FlagWait`` is the same launch prepared once for a caller that
merges many times (``sharded_index._RingSlots``): every check, the pointer
arrays and the outputs made when it is built, one ctypes call a merge.
``ops._cuda_build`` compiles the source at first use with ``nvcc`` for
``sm_90a``; without ``nvcc``, or when the build fails, loading raises:
there is no fallback to the plain versions.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ._cuda_build import load_kernel_library
from .fm_search_cuda import (
    PTRS, address_table, owner_divisor, shard_parts, shard_ptrs, sharded_args, stacked,
)
_DTYPES = {torch.int32: 0, torch.float32: 1}
# a flag wait gives up after this long: far above any merge's skew between
# ranks, far below the collectives' timeout
FLAG_TIMEOUT_S = 30.0
# a flag word that holds this is poisoned: its rank's wait failed
# (``csrc/ring.cu`` kPoison, above every epoch)
POISON = (1 << 31) - 1
# flag words a rank of a flag-wait merge holds for each peer: the most
# blocks of its grid (``csrc/ring.cu`` kWaitBlocks)
WAIT_BLOCKS = 128


@functools.cache
def _library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    lib = load_kernel_library("ring.cu")
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    lib.gwa_allreduce.argtypes = [i32, i32, i64, PTRS, PTRS, vp, i32, i32, vp]
    lib.gwa_allreduce_wait.argtypes = [i32, i64, i32, i32, vp, vp, vp, vp, i32,
                                       ctypes.c_longlong, i32, vp, vp]
    lib.gwa_allreduce_wait_blocks.argtypes = [i64]
    lib.gwa_fused_words.argtypes = [i32, i64, vp, vp, vp, vp, vp, vp, vp]
    lib.gwa_fused_occ.argtypes = [
        i32, i32, i32, i64, vp, vp, vp, vp, vp, ctypes.c_uint32, i32, i32, vp, vp, vp, vp,
    ]
    for fn in (lib.gwa_allreduce, lib.gwa_allreduce_wait, lib.gwa_allreduce_wait_blocks,
               lib.gwa_fused_words, lib.gwa_fused_occ):
        fn.restype = ctypes.c_int
    return lib


def _check_shards(S: int) -> None:
    if S < 1:
        raise ValueError(f"{S} shards: the ring kernels take one or more")


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _sum_io(parts, only, name):
    """Check a sum's shards and allocate its output on the launching card
    (shard ``only``'s, or the first shard's): (inputs, output, output rows,
    dtype code)."""
    # Bad input: the kernel is built for int32 and float32 on the card; a
    # CPU tensor or another type raises here and never reaches a plain
    # version
    ins = shard_parts(parts)
    S = len(ins)
    _check_shards(S)
    if only is not None and not 0 <= only < S:
        raise ValueError(f"{name}: only={only} is not a shard of {S}")
    dev = ins[0 if only is None else only].device
    if not all(t.is_cuda and t.device == dev for t in ins):
        raise ValueError(f"{name} needs its tensors on one CUDA device")
    if any(t.dtype not in _DTYPES or t.dtype != ins[0].dtype for t in ins):
        raise TypeError(f"{name} takes int32 or float32, got "
                        f"{sorted({str(t.dtype) for t in ins})}")
    if not all(t.is_contiguous() and t.shape == ins[0].shape for t in ins):
        raise ValueError(f"{name} needs contiguous shards of one shape")
    dtype, shape = ins[0].dtype, ins[0].shape
    out = torch.empty((S, *shape) if only is None else shape, dtype=dtype, device=dev)
    n = ins[0].numel()
    outs = list(out.view(S, n)) if only is None else [
        out if d == only else None for d in range(S)]
    return ins, out, outs, _DTYPES[dtype]


def ring_allreduce_cuda(parts, only: int | None = None) -> torch.Tensor:
    """All-reduce over the shards of a CUDA tensor ``(S, ...)`` int32 or
    float32, or of S such ``(...)`` tensors, each its own allocation (the
    ranks' partial slots, mapped from other processes): every shard's row of
    the result holds the sum, added in ``ring_psum_plain``'s order.  With
    ``only`` = d the kernel writes shard d's sum alone and returns it
    ``(...)``.  One kernel pass on the output's card (shard
    d's, or the first shard's); launches on the current stream without
    synchronising.  Counts each launch in ``.launches``."""
    ins, out, outs, code = _sum_io(parts, only, "ring_allreduce_cuda")
    n = ins[0].numel()
    if n == 0:
        return out
    in_ptrs = shard_ptrs(ins)
    out_ptrs = (ctypes.c_uint64 * len(outs))(*[0 if t is None else t.data_ptr() for t in outs])
    aligned = not any(a % 16 for a in (*in_ptrs, *out_ptrs))
    dev = out.device
    with torch.cuda.device(dev):
        in_table = None if stacked(ins) else address_table(dev, list(in_ptrs))
        rc = _library().gwa_allreduce(code, len(ins), n, in_ptrs, out_ptrs, _ptr(in_table),
                                      int(aligned), -1 if only is None else only, _stream())
    if rc != 0:
        raise RuntimeError(f"gwa_allreduce launch failed ({len(ins)} shards): CUDA error {rc}")
    ring_allreduce_cuda.launches += 1
    return out


ring_allreduce_cuda.launches = 0


class FlagWait:
    """The flag-wait merge prepared for one caller: every rank's inboxes
    and flag words checked, and the ctypes pointer arrays and the outputs
    made, once.  ``inboxes``: one entry a slot (taken in turn by the
    caller), each every rank's ``(ranks, ...)`` int32 or float32 inbox
    mapped on this card, this rank's own at ``me``; this rank's partial is
    row ``me`` of its own inbox.  ``flags``: every rank's ``(ranks,
    WAIT_BLOCKS)`` int32 flag words, mapped alike; ``error``: a ``(1,)``
    int32 word on this card that a failed wait sets to 1 (read it with
    ``check_flag_wait``).  Every tensor contiguous and 16-byte aligned.
    ``self(slot, epoch)`` merges the slot's rows with ``epoch`` (>= 1,
    rising from merge to merge, below ``POISON``) and returns that slot's
    ``(...)`` output, overwritten by the slot's next merge: one ctypes
    call on the stream that was current when it was built.  Counts each
    launch in ``ring_allreduce_wait_cuda.launches``."""

    def __init__(self, inboxes, flags, me: int, error: torch.Tensor,
                 timeout_s: float = FLAG_TIMEOUT_S):
        name = "the flag-wait merge"
        ranks = len(flags)
        if ranks < 1 or not 0 <= me < ranks:
            raise ValueError(f"{name}: rank {me} of {ranks}")
        boxes = [list(slot) for slot in inboxes]
        first = boxes[0][0] if boxes and boxes[0] else None
        if first is None or first.dim() < 1 or first.shape[0] != ranks:
            raise ValueError(f"{name}: every inbox must be ({ranks}, ...), got "
                             f"{None if first is None else tuple(first.shape)}")
        shape = first.shape
        every = [t for slot in boxes for t in slot]
        if any(len(slot) != ranks for slot in boxes) or any(t.shape != shape for t in every):
            raise ValueError(f"{name}: every slot needs {ranks} inboxes of shape "
                             f"{tuple(shape)}, got {[[tuple(t.shape) for t in s] for s in boxes]}")
        if any(f.shape != (ranks, WAIT_BLOCKS) or f.dtype != torch.int32 for f in flags):
            raise ValueError(f"{name}: every rank's flags must be ({ranks}, {WAIT_BLOCKS}) int32")
        if error.dtype != torch.int32 or error.numel() != 1:
            raise ValueError(f"{name}: the error word must be one int32")
        if first.dtype not in _DTYPES or any(t.dtype != first.dtype for t in every):
            raise TypeError(f"{name} takes int32 or float32 inboxes, got "
                            f"{sorted({str(t.dtype) for t in every})}")
        if timeout_s < 0:
            raise ValueError(f"{name}: timeout {timeout_s} s")
        tensors = [*every, *flags, error]
        if not all(t.is_contiguous() for t in tensors):
            raise ValueError(f"{name} needs contiguous inboxes and flag words")
        if any(t.data_ptr() % 16 for t in tensors):
            raise ValueError(f"{name} moves 16-byte vectors: every inbox, flag tensor and the "
                             "error word must start 16-byte aligned")
        dev = error.device
        if not all(t.is_cuda and t.device == dev for t in tensors):
            raise ValueError(f"{name} needs its tensors on one CUDA device (the inboxes and "
                             "flags of other cards mapped on it)")
        self.outs = [torch.empty(shape[1:], dtype=first.dtype, device=dev) for _ in boxes]
        self.n = first[0].numel()
        lib = _library()
        flag_ptrs = shard_ptrs(flags)
        with torch.cuda.device(dev):
            stream = _stream()
            # each slot's inbox and flag addresses on the card (read past 16 ranks)
            tables = [address_table(dev, [*shard_ptrs(slot), *flag_ptrs]) for slot in boxes]
        self._calls = [
            (_DTYPES[first.dtype], self.n, ranks, me, shard_ptrs(slot), flag_ptrs,
             out.data_ptr(), error.data_ptr()) for slot, out in zip(boxes, self.outs)]
        self._tables = [_ptr(t) for t in tables]
        self.keep = (boxes, list(flags), error, tables)  # the pointers stay valid
        self._tail = (int(timeout_s * 1e9), dev.index)
        self._stream = stream
        self._launch = lib.gwa_allreduce_wait

    def __call__(self, slot: int, epoch: int) -> torch.Tensor:
        if not 1 <= epoch < POISON:
            raise ValueError(f"the flag-wait merge: epoch {epoch} outside 1..{POISON - 1}")
        rc = self._launch(*self._calls[slot], epoch, *self._tail, self._tables[slot],
                          self._stream)
        if rc != 0:
            raise RuntimeError(f"gwa_allreduce_wait launch failed ({self._calls[slot][2]} ranks): "
                               f"CUDA error {rc}")
        ring_allreduce_wait_cuda.launches += 1
        return self.outs[slot]


def ring_allreduce_wait_cuda(inboxes, flags, me: int, epoch: int, error: torch.Tensor,
                             timeout_s: float = FLAG_TIMEOUT_S) -> torch.Tensor:
    """One flag-wait merge across cards (``FlagWait`` prepared for one
    slot): this rank's partial is row ``me`` of its own inbox
    ``inboxes[me]``; every rank's ``(ranks, ...)`` inbox and ``(ranks,
    WAIT_BLOCKS)`` flag words are mapped on this card.  Pushes the row
    into every peer's inbox, publishes ``epoch`` into every peer's flag
    words and waits, at most ``timeout_s``, until every peer has published
    it; -> ``(...)``, ``ring_psum_plain`` of the ranks' partials, this
    rank's row.  Once ``error`` is set the launch pushes nothing, waits no
    more and publishes the poison, not ``epoch``.  Counts each launch in
    ``.launches``."""
    if not 1 <= epoch < POISON:
        raise ValueError(f"the flag-wait merge: epoch {epoch} outside 1..{POISON - 1}")
    return FlagWait([inboxes], flags, me, error, timeout_s)(0, epoch)


ring_allreduce_wait_cuda.launches = 0


def wait_blocks(n: int) -> int:
    """The blocks of a flag-wait merge of ``n`` elements, one flag word a
    block (the same on every rank; at most ``WAIT_BLOCKS``)."""
    return _library().gwa_allreduce_wait_blocks(n)


def check_flag_wait(error: torch.Tensor) -> None:
    """Raise if a flag wait set ``error`` (reads the word: a synchronise)."""
    if int(error.item()):
        raise RuntimeError("a flag wait of the ring merge across cards failed: it timed out, or "
                           "a peer's had; the merged sums are not valid")


def _check_int32_cuda(name: str, ts) -> None:
    if not all(t.is_cuda and t.device == ts[0].device for t in ts):
        raise ValueError(f"{name} needs all tensors on one CUDA device")
    if any(t.dtype != torch.int32 for t in ts):
        raise TypeError(f"{name} takes int32 tensors, got {[t.dtype for t in ts]}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{name} needs contiguous tensors")


def fused_rank_ring_cuda(
    words: torch.Tensor,  # (S, M, Q, 8) int32, the uint32 BWT words of each query's block
    codes: torch.Tensor,  # (S, M, Q) int32 query base codes
    roff: torch.Tensor,  # (S, M, Q) int32 base offsets in the block (may exceed 128)
    base: torch.Tensor,  # (S, M, Q) int32 the owner's checkpoint value
    own: torch.Tensor,  # (S, M, Q) int32 1 where the shard owns the query
) -> torch.Tensor:
    """Fused occ-rank partials + shard sum -> (S, M, Q) int32: every
    shard's row holds, per payload m, the sum over shards of
    ``own * (base + match count)``.  One pass, any M.  Counts each launch
    in ``.launches``."""
    ts = (words, codes, roff, base, own)
    _check_int32_cuda("fused_rank_ring_cuda", ts)
    if words.dim() != 4 or words.shape[3] != 8 or any(t.shape != words.shape[:3] for t in ts[1:]):
        raise ValueError(
            f"expected words (S, M, Q, 8) and (S, M, Q) codes/roff/base/own, got "
            f"{[tuple(t.shape) for t in ts]}"
        )
    if words.data_ptr() % 16:
        raise ValueError("fused_rank_ring_cuda loads each 32-byte word row as two 16-byte "
                         "vectors: words must start 16-byte aligned")
    S = codes.shape[0]
    _check_shards(S)
    out = torch.empty(codes.shape, dtype=torch.int32, device=words.device)
    n = codes[0].numel()
    if n == 0:
        return out
    with torch.cuda.device(words.device):
        rc = _library().gwa_fused_words(S, n, *[t.data_ptr() for t in (*ts, out)], _stream())
    if rc != 0:
        raise RuntimeError(f"gwa_fused_words launch failed ({S} shards): CUDA error {rc}")
    fused_rank_ring_cuda.launches += 1
    return out


fused_rank_ring_cuda.launches = 0


def fused_occ_cuda(
    bwt_blocks,  # (S, R, 8) int32 words of each shard's BWT blocks, or S (R, 8) tensors
    occ_cp,  # (S, R, 4) int32 global checkpoint values, or S (R, 4) tensors
    pk_start: torch.Tensor,  # (S,) int32 packed-coordinate shard starts
    pk_end: torch.Tensor,  # (S,) int32 shard ends (exclusive)
    primary: int,  # the sentinel's BWT row
    codes: torch.Tensor,  # (...) int32 query codes, 0..3
    k: torch.Tensor,  # (...) int32 sentinel-inclusive coordinates
    out: torch.Tensor | None = None,  # (...) int32 to write, contiguous (else allocated)
) -> torch.Tensor:
    """Merged occ$(codes, k) over the interval shards, each query's row read
    from its owner's table, wherever that shard's tensor lies (one base
    pointer a shard) -> (...) int32, equal to
    ``sharded_index.fused_occ_plain``, written into ``out`` where given
    (the ring merge's inbox row).  Launches on the current stream without
    synchronising; counts each launch in ``.launches``."""
    bwt, cp = shard_parts(bwt_blocks), shard_parts(occ_cp)
    ts = (*bwt, *cp, pk_start, pk_end, codes, k)
    _check_int32_cuda("fused_occ_cuda", ts)
    S = len(bwt)
    R = bwt[0].shape[0] if bwt[0].dim() == 2 else -1
    if (any(t.shape != (R, 8) for t in bwt) or len(cp) != S
            or any(t.shape != (R, 4) for t in cp) or pk_start.shape != (S,)
            or pk_end.shape != (S,) or codes.shape != k.shape):
        raise ValueError(
            f"expected bwt_blocks (S, R, 8), occ_cp (S, R, 4), pk_start/pk_end (S,) and codes "
            f"and k of one shape, got {[tuple(t.shape) for t in ts]}"
        )
    if any(t.data_ptr() % 16 for t in (*bwt, *cp)):
        raise ValueError("fused_occ_cuda loads each 32-byte word row and its 16-byte checkpoints "
                         "as 16-byte vectors: bwt_blocks and occ_cp must start 16-byte aligned")
    _check_shards(S)
    if out is None:
        out = torch.empty(codes.shape, dtype=torch.int32, device=codes.device)
    elif (out.shape != codes.shape or out.dtype != torch.int32 or not out.is_contiguous()
          or out.device != codes.device):
        raise ValueError(f"fused_occ_cuda: out must be contiguous int32 {tuple(codes.shape)} on "
                         f"{codes.device}, got {out.dtype} {tuple(out.shape)} on {out.device}")
    n = codes.numel()
    if n == 0:
        return out
    with torch.cuda.device(codes.device):
        table, facts = sharded_args(codes.device, (bwt, cp), (pk_start, pk_end))
        rc = _library().gwa_fused_occ(S, R, int(primary), n, bwt[0].data_ptr(), cp[0].data_ptr(),
                                      table, pk_start.data_ptr(), pk_end.data_ptr(),
                                      *owner_divisor((R - 1) * 128), facts, codes.data_ptr(),
                                      k.data_ptr(), out.data_ptr(), _stream())
    if rc != 0:
        raise RuntimeError(f"gwa_fused_occ launch failed ({S} shards): CUDA error {rc}")
    fused_occ_cuda.launches += 1
    return out


fused_occ_cuda.launches = 0
