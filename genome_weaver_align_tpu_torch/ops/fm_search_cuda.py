"""Binding of the hand-written CUDA backward exact search (``csrc/fm_search.cu``).

The kernel replaces the JAX package's device loops
``genome_weaver_align_tpu/models/exact.py:65`` (``exact_interval_search``),
``genome_weaver_align_tpu/models/suffix_filter.py:123``
(``piece_interval_search``) and the piece search of
``genome_weaver_align_tpu/parallel/sharded_pipeline.py:330``
(``make_sharded_pigeonhole_align``): one thread a lane, the whole loop in
one launch.  ``backward_search_cuda`` is equal to
``models.exact.exact_interval_search_plain`` (one piece a read) and to
``models.suffix_filter.piece_interval_search_plain`` (P pieces a read);
``backward_search_sharded_cuda``, over the interval shards of a
``ShardedFMIndex``, to ``parallel.sharded_pipeline.sharded_piece_search_plain``.

``ops._cuda_build`` compiles the source at first use with ``nvcc`` for
``sm_90a`` into the gitignored ``_build/`` directory; without ``nvcc``, or
when the build fails, loading raises: there is no fallback to the plain
versions.  ``check_table`` (built on ``check_tables``, which owns the
dtype, contiguity, alignment and device rules) and ``group_lanes`` are
shared with the staircase, one-mismatch and locate bindings,
``check_sharded``, ``owner_divisor`` (the sharded kernels' owner by
division) and ``sharded_args`` (the layout of the shards' tables, decided
here and nowhere else: the rows of one stacked tensor, or shards in their
own allocations, another process's mapped, whose pointers go to the card
as a table; and what a split's bounds are; each found once and cached)
with the locate and fused-occ bindings.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ._cuda_build import load_kernel_library
from .rank import FUSED_WIDTH, MARK_WORDS_PER_BLOCK, DeviceFMIndex

I32 = torch.int32
PTRS = ctypes.POINTER(ctypes.c_uint64)  # an array of device pointers, one a shard
MAX_PIECES = 32  # pieces a read (the staircase's k + 1)
_CACHED = 64  # device tables and split findings kept, the oldest dropped first
# Lanes a launch of lane groups may take an SM before each group takes
# fewer: the crossover of the staircase and one-mismatch kernels' group
# sizes at their paths' shapes (PERF.md section 6, chip_smoke.py [18])
LANES_AN_SM = 768


@functools.cache
def _library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    lib = load_kernel_library("fm_search.cu")
    vp, i32 = ctypes.c_void_p, ctypes.c_int32
    lib.gwa_backward_search.argtypes = [
        vp, vp, i32, i32, i32, vp, vp, i32, i32, vp, vp, i32, i32, i32, vp, vp, vp,
    ]
    lib.gwa_backward_search_sharded.argtypes = [
        vp, vp, i32, i32, i32, i32, i32, vp, vp, vp, vp, vp, ctypes.c_uint32, i32, i32, vp, i32,
        i32, i32, vp, vp, vp,
    ]
    lib.gwa_backward_search.restype = lib.gwa_backward_search_sharded.restype = ctypes.c_int
    return lib


def check_reads(reads: torch.Tensor, lengths: torch.Tensor, name: str) -> None:
    """(B, L) int32 codes and (B,) int32 lengths, contiguous, with
    len * (P + 1) inside int32 for any P the kernels take, on one CUDA
    device (checked last, so that the CPU tests reach every other check)."""
    if reads.dtype != I32 or lengths.dtype != I32:
        raise ValueError(f"{name}: expected int32 reads and lengths, got "
                         f"{reads.dtype}/{lengths.dtype}")
    if reads.dim() != 2 or lengths.shape != (reads.shape[0],):
        raise ValueError(f"{name}: shape mismatch: reads {tuple(reads.shape)}, lengths "
                         f"{tuple(lengths.shape)}")
    if not (reads.is_contiguous() and lengths.is_contiguous()):
        raise ValueError(f"{name} needs contiguous reads and lengths")
    if reads.shape[1] * (MAX_PIECES + 1) >= 1 << 31:
        raise ValueError(f"{name}: reads of {reads.shape[1]} bases: piece bounds would leave int32")
    if not (reads.is_cuda and lengths.device == reads.device):
        raise ValueError(f"{name} needs reads and lengths on one CUDA device")


def check_table(fm: DeviceFMIndex, dev: torch.device, name: str, marks: bool = False) -> None:
    """The fused rows and C of one table (with ``marks`` its mark blocks,
    mark checkpoints and sampled values too: locate), int32 and contiguous
    on ``dev``, the tables read as 16-byte vectors 16-byte aligned (each
    fused row is three 16-byte loads)."""
    b = fm.blocks
    if b.dim() != 2 or b.shape[1] != FUSED_WIDTH:
        raise ValueError(f"{name}: expected (nb + 1, {FUSED_WIDTH}) int32 fused rows, got "
                         f"{tuple(b.shape)}")
    tables = {"blocks": b, "C": fm.C}
    if marks:
        tables.update(mark_blocks=fm.mark_blocks, mark_cp=fm.mark_cp, ssa_values=fm.ssa_values)
    check_tables(name, dev, tables, aligned=("blocks", "mark_blocks"))
    if not 0 <= fm.n < (1 << 31) - 1:
        raise ValueError(f"{name}: an index of {fm.n} symbols leaves int32")


def check_tables(name: str, dev: torch.device, tables: dict, aligned=()) -> None:
    """Every table int32 and contiguous on ``dev``; those in ``aligned``
    (read as 16-byte vectors) 16-byte aligned."""
    for key, t in tables.items():
        if t.dtype != I32 or not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be a contiguous int32 tensor, got {t.dtype}")
        if key in aligned and t.data_ptr() % 16:
            raise ValueError(f"{name}: {key} is read as 16-byte vectors: it must start 16-byte "
                             "aligned")
    for key, t in tables.items():
        if t.device != dev:
            raise ValueError(f"{name}: {key} is not on the queries' device {dev}")


def shard_parts(table) -> list[torch.Tensor]:
    """A sharded table's per-shard tensors: the views of a stacked
    ``(S, R, ...)`` tensor, or the S tensors of a sequence (``parallel.peer.
    Shards``: shards in their own allocations, some mapped from other
    processes)."""
    return list(table.unbind(0)) if isinstance(table, torch.Tensor) else list(table)


def shard_ptrs(parts) -> ctypes.Array:
    """The device pointers of the per-shard tensors, a kernel parameter's
    source (the staged sharded locate, the sums up to 16 shards or ranks)."""
    return (ctypes.c_uint64 * len(parts))(*[t.data_ptr() for t in parts])


def _remember(cache: dict, key, value):
    cache[key] = value
    while len(cache) > _CACHED:
        cache.pop(next(iter(cache)))
    return value


_TABLES: dict = {}


def address_table(dev: torch.device, addrs) -> torch.Tensor:
    """``addrs`` (device addresses) as an int64 tensor on ``dev``: a
    kernel's pointer table (``csrc/fm_occ.cuh``, ``csrc/ring.cu``).  Made
    once for a set of addresses and kept (a blocking upload the first
    time)."""
    key = (dev, tuple(addrs))
    if key in _TABLES:
        return _TABLES[key]
    return _remember(_TABLES, key, torch.tensor(key[1], dtype=torch.int64, device=dev))


def device_table(dev: torch.device, *parts) -> torch.Tensor | None:
    """The device pointers of the per-shard tensors of each of ``parts``
    (lists of S tensors), one list after another (``address_table``); None
    where every list is the rows of one stacked tensor (the kernels add the
    stride instead)."""
    if all(stacked(ts) for ts in parts):
        return None
    return address_table(dev, [t.data_ptr() for ts in parts for t in ts])


def stacked(parts) -> bool:
    """Whether the per-shard tensors are the rows of one stacked tensor:
    shard s at shard 0's address plus s rows (the kernels then add the
    stride, and get no pointer table)."""
    first, row = parts[0].data_ptr(), parts[0].numel() * parts[0].element_size()
    return all(t.data_ptr() == first + s * row for s, t in enumerate(parts))


_FACTS: dict = {}


def split_facts(start: torch.Tensor, end: torch.Tensor) -> int:
    """What the S ranges [start, end) of a split are, for the sharded
    kernels (``csrc/fm_occ.cuh`` owner_of): bit 0 where no x lies in two
    ranges, bit 1 where they are also in order, start[0] <= end[0] <=
    start[1] <= ... (``shard_fm_index``'s splits and any run of their
    shards).  Read from the device once for the bounds' memory and kept
    while it is unchanged (the version counter, which a view shares with
    its base): a process's held bounds are a new view of the same memory
    each step.  The cache holds the tensors, so their memory is not
    reused while it does."""
    key = tuple((t.device, t.data_ptr(), t.shape, t.stride()) for t in (start, end))
    hit = _FACTS.get(key)
    if hit is not None and hit[2] == (start._version, end._version):
        return hit[3]
    lo, hi = start.tolist(), end.tolist()
    spans = sorted((a, b) for a, b in zip(lo, hi) if a < b)
    disjoint = all(b0 <= a1 for (_, b0), (a1, _) in zip(spans, spans[1:]))
    in_order = all(a <= b for a, b in zip(lo, hi)) and all(b <= a for b, a in zip(hi, lo[1:]))
    facts = int(disjoint) | int(disjoint and in_order) << 1
    _remember(_FACTS, key, (start, end, (start._version, end._version), facts))
    return facts


def check_sharded(sh, dev: torch.device, name: str, marks: bool = True) -> dict:
    """The tables of a ``ShardedFMIndex`` (``put_sharded``), stacked or one
    tensor a shard: S >= 1 shards, shapes that agree, every shard's
    tensor int32 and contiguous on ``dev``, the vector-read ones 16-byte
    aligned; with ``marks`` the row-space tables too (locate), else the
    packed space alone (the piece search).  -> each table's per-shard
    tensors."""
    keys = ("bwt_blocks", "occ_cp") + (("mark_blocks", "mark_cp", "ssa_values") if marks else ())
    per = {key: shard_parts(getattr(sh, key)) for key in keys}
    S = len(per["bwt_blocks"])
    if S < 1:
        raise ValueError(f"{name}: an index of no shards")
    first = {key: ts[0].shape for key, ts in per.items()}
    R = first["bwt_blocks"][0] if len(first["bwt_blocks"]) == 2 else -1
    shapes = {"bwt_blocks": (R, 8), "occ_cp": (R, 4)}
    if marks:
        mbs, vmax = first["mark_blocks"][0], first["ssa_values"][-1]
        shapes.update(mark_blocks=(mbs, MARK_WORDS_PER_BLOCK), mark_cp=(mbs + 1,),
                      ssa_values=(vmax,))
    small = {key: (S,) for key in ("pk_start", "pk_end")}
    if marks:
        small.update({key: (S,) for key in ("row_start", "row_end", "ssa_base")})
    small["C"] = (5,)
    want = {**{key: [shapes[key]] * S for key in per}, **small}
    got = {**{key: [tuple(t.shape) for t in ts] for key, ts in per.items()},
           **{key: tuple(getattr(sh, key).shape) for key in small}}
    if got != want or R < 1 or (marks and (mbs + 1 < 2 or vmax < 1)):
        raise ValueError(f"{name}: the shard tables' shapes disagree or are empty: {got}")
    tables = {f"{key}[{s}]": t for key, ts in per.items() for s, t in enumerate(ts)}
    tables.update({key: getattr(sh, key) for key in small})
    check_tables(name, dev, tables, aligned=tuple(
        key for key in tables if key.split("[")[0] in ("bwt_blocks", "occ_cp", "mark_blocks")))
    if not 0 <= sh.n < (1 << 31) - 1:
        raise ValueError(f"{name}: an index of {sh.n} symbols leaves int32")
    return per


def owner_divisor(width: int) -> tuple[int, int]:
    """(magic, shift) with ``x // width == ((x * magic) >> 32) >> shift``
    for every 0 <= x < 2^31 (Granlund and Montgomery's round-up division:
    magic = ceil(2^(31 + l) / width), shift = l - 1, 2^(l-1) < width <=
    2^l): the sharded kernels' guess of a coordinate's owner
    (``csrc/fm_occ.cuh`` ``owner_of``), which the shard's bounds confirm.
    A width below 2 gives (0, 0): every guess is shard 0."""
    if width < 2:
        return 0, 0
    log = (width - 1).bit_length()
    return -(-(1 << (31 + log)) // width), log - 1


def packed_divisor(sh) -> tuple[int, int]:
    """``owner_divisor`` of the packed coordinates' split:
    ``shard_fm_index``'s equal widths, nbs = R - 1 blocks of 128."""
    return owner_divisor((sh.bwt_blocks.shape[1] - 1) * 128)


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(dev: torch.device) -> int:
    """The SMs of a CUDA device."""
    return _sm_count(dev.index if dev.index is not None else torch.cuda.current_device())


def group_lanes(groups: int, least: int, most: int, sms: int) -> int:
    """Lanes a group (a staircase pool, a one-mismatch read's case) for a
    launch of ``groups`` groups on ``sms`` SMs: the most, a power of two
    from ``least`` to ``most``, for which the launch's lanes stay within
    ``LANES_AN_SM`` an SM, and ``least`` where even that is more.  Few
    groups wait on their steps' latency and want lanes for a step's work;
    many wait on instruction issue and want a warp's lanes shared."""
    lanes = most
    while lanes > least and groups * lanes > LANES_AN_SM * sms:
        lanes //= 2
    return lanes


def backward_search_cuda(
    fm: DeviceFMIndex,
    reads: torch.Tensor,  # (B, L) int32 codes 0..3, contiguous, on a CUDA device
    lengths: torch.Tensor,  # (B,) int32
    n_pieces: int,
    trip: int,  # the plain loop's trip count
    kmer_tab: tuple[torch.Tensor, torch.Tensor] | None = None,  # (lo, hi) of size 4^kmer_j
    kmer_j: int = 0,
):
    """Launch the search -> (lo, hi) (B, n_pieces) int32: read b's piece p
    is [floor(len p / P), floor(len (p + 1) / P)), searched last character
    first for ``trip`` steps at most.  Launches on the current stream
    without synchronising; counts each launch in ``.launches``."""
    name = "backward_search_cuda"
    if not 1 <= n_pieces <= MAX_PIECES:
        raise ValueError(f"{name}: n_pieces={n_pieces}: the kernel takes 1..{MAX_PIECES}")
    use_tab = kmer_tab is not None and kmer_j > 0
    if use_tab and not 0 < kmer_j <= 15:
        raise ValueError(f"{name}: kmer_j={kmer_j}: the lookup index is int32")
    check_reads(reads, lengths, name)
    check_table(fm, reads.device, name)
    if use_tab:
        tlo, thi = kmer_tab
        if not (tlo.device == thi.device == reads.device and tlo.dtype == thi.dtype == I32
                and tlo.is_contiguous() and thi.is_contiguous() and tlo.dim() == 1
                and tlo.shape == thi.shape and tlo.shape[0] > 0):
            raise ValueError(f"{name}: the k-mer table must be two equal, non-empty, "
                             "contiguous 1-D int32 tensors on the reads' device")
    B, L = reads.shape
    dev = reads.device
    lo = torch.empty((B, n_pieces), dtype=I32, device=dev)
    hi = torch.empty((B, n_pieces), dtype=I32, device=dev)
    if B == 0:
        return lo, hi
    with torch.cuda.device(dev):
        rc = _library().gwa_backward_search(
            reads.data_ptr(), lengths.data_ptr(), B, L, n_pieces, fm.blocks.data_ptr(),
            fm.C.data_ptr(), fm.primary, fm.n,
            tlo.data_ptr() if use_tab else None, thi.data_ptr() if use_tab else None,
            tlo.shape[0] if use_tab else 0, kmer_j if use_tab else 0, max(trip, 0),
            lo.data_ptr(), hi.data_ptr(), stream(),
        )
    if rc != 0:
        raise RuntimeError(f"gwa_backward_search launch failed: CUDA error {rc}")
    backward_search_cuda.launches += 1
    return lo, hi


backward_search_cuda.launches = 0


def sharded_args(dev: torch.device, parts, *splits) -> tuple:
    """The sharded kernels' layout arguments: the pointer table of
    ``parts`` (``device_table``'s pointer; None where every table is
    stacked) and each split's ``split_facts``."""
    table = device_table(dev, *parts)
    return (None if table is None else table.data_ptr(),
            *[split_facts(a, b) for a, b in splits])


def backward_search_sharded_cuda(
    sh,  # a ShardedFMIndex after put_sharded: S >= 1 interval shards, stacked or not
    reads: torch.Tensor,  # (B, L) int32 codes 0..3, contiguous, on a CUDA device
    lengths: torch.Tensor,  # (B,) int32
    n_pieces: int,
    trip: int,  # the plain loop's trip count
):
    """Launch the piece search over the interval shards -> (lo, hi)
    (B, n_pieces) int32: read b's piece p is [floor(len p / P),
    floor(len (p + 1) / P)), searched last character first for ``trip``
    steps at most, each row read from the shard that owns it, wherever its
    tensor lies (one base pointer a shard).  Launches on
    the current stream without synchronising; counts each launch in
    ``.launches``."""
    name = "backward_search_sharded_cuda"
    if not 1 <= n_pieces <= MAX_PIECES:
        raise ValueError(f"{name}: n_pieces={n_pieces}: the kernel takes 1..{MAX_PIECES}")
    per = check_sharded(sh, reads.device, name, marks=False)
    check_reads(reads, lengths, name)
    B, L = reads.shape
    dev = reads.device
    lo = torch.empty((B, n_pieces), dtype=I32, device=dev)
    hi = torch.empty((B, n_pieces), dtype=I32, device=dev)
    if B == 0:
        return lo, hi
    bwt, cp = per["bwt_blocks"], per["occ_cp"]
    S, R = len(bwt), bwt[0].shape[0]
    with torch.cuda.device(dev):
        table, facts = sharded_args(dev, (bwt, cp), (sh.pk_start, sh.pk_end))
        rc = _library().gwa_backward_search_sharded(
            reads.data_ptr(), lengths.data_ptr(), B, L, n_pieces, S, R, bwt[0].data_ptr(),
            cp[0].data_ptr(), table, sh.pk_start.data_ptr(), sh.pk_end.data_ptr(),
            *packed_divisor(sh), facts, sh.C.data_ptr(), sh.primary, sh.n, max(trip, 0),
            lo.data_ptr(), hi.data_ptr(), stream(),
        )
    if rc != 0:
        raise RuntimeError(f"gwa_backward_search_sharded launch failed ({S} shards): CUDA error "
                           f"{rc}")
    backward_search_sharded_cuda.launches += 1
    return lo, hi


backward_search_sharded_cuda.launches = 0
