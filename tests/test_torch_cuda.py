"""Tests that need an NVIDIA GPU with nvcc (marker ``cuda``; they skip
without one).  On the card:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

They import no JAX: they hold each CUDA kernel entry (banded DP and Myers,
each from the packed text and from given windows; the shard sum; the fused
rank + shard sum from gathered rows and from the shard tables; the backward
exact and piece search, the staircase and the one-mismatch search) against
its plain torch version, and the aligners, the sharded search, two ranks of
``ShardedAligner`` sharing the card, the sharded kernels on shards in their
own allocations and on another process's shards mapped through CUDA IPC,
the table entry over one process's held shards, two processes on two
cards declared as two hosts (the collective route), the device suffix-array build and the
wavelet search on the card against the same code on the CPU (or native
SA-IS), which the CPU tests hold against the JAX package."""

import contextlib
from unittest import mock

import numpy as np
import pytest
import torch

from genome_weaver_align_tpu_torch.utils.simulate import simulate_reads_array
from genome_weaver_align_tpu_torch.index.build import build_fm_index
from genome_weaver_align_tpu_torch.index.files import Genome, GenomeIndex
from genome_weaver_align_tpu_torch.index.seedtable import build_seed_table
from genome_weaver_align_tpu_torch.models import paired, pipeline, suffix_filter
from genome_weaver_align_tpu_torch.ops import (
    dp, dp_cuda, fm_search_cuda, myers, myers_cuda, one_mismatch_cuda, rank, ring_cuda,
    staircase_cuda, window,
)
from genome_weaver_align_tpu_torch.parallel import mesh as pmesh
from genome_weaver_align_tpu_torch.parallel import ring, sharded_index, sharded_pipeline
from genome_weaver_align_tpu_torch.utils import packing
from genome_weaver_align_tpu_torch.utils.fasta import Contig

import torch_fm_models as fm_models  # tests/ is on the path under pytest

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("k", range(1, dp_cuda.REGISTER_K + 1))
@pytest.mark.parametrize("narrow", [False, True])
def test_kernel_equals_plain(cuda, k, narrow):
    rng = np.random.default_rng(k)
    Q, L = 3001, 77
    W = L // 2 if narrow else L + 3 * k  # narrow: dead lanes saturate to INF
    reads = rng.integers(0, 5, size=(Q, L), dtype=np.int8)
    wins = rng.integers(0, 5, size=(Q, W), dtype=np.int8)
    wins[::2, k : k + min(L, W - 2 * k)] = reads[::2, : min(L, W - 2 * k)]
    lengths = rng.integers(0, L + 1, size=Q).astype(np.int32)
    r, ln, w = (torch.from_numpy(a).to(cuda) for a in (reads, lengths, wins))
    before = dp_cuda.banded_edit_distance_cuda.launches
    got = dp_cuda.banded_edit_distance_cuda(r, ln, w, k)
    assert dp_cuda.banded_edit_distance_cuda.launches == before + 1
    want = dp.banded_edit_distance(r, ln, w, k)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert bool((want[0] >= dp.INF).any()) == narrow


def test_kernel_rejects_what_it_cannot_take(cuda):
    """The wrappers refuse a wrong dtype, a strided tensor and a negative
    band; a band past the one-thread kernel (k = 17, a group of threads)
    and reads of 1,816 bases (128 rows of them overflow a block's shared
    memory: fewer rows a block) are taken and equal the plain version."""
    rng = np.random.default_rng(17)
    r = torch.from_numpy(rng.integers(0, 5, size=(4, 10)).astype(np.int8)).to(cuda)
    w = torch.from_numpy(rng.integers(0, 5, size=(4, 16)).astype(np.int8)).to(cuda)
    ln = torch.full((4,), 10, dtype=torch.int32, device=cuda)
    k = dp_cuda.REGISTER_K + 1
    got = dp_cuda.banded_edit_distance_cuda(r, ln, w, k)
    want = dp.banded_edit_distance(r, ln, w, k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(ValueError, match="int8"):
        dp_cuda.banded_edit_distance_cuda(r.int(), ln, w, 2)
    with pytest.raises(ValueError, match="contiguous"):
        dp_cuda.banded_edit_distance_cuda(r.t().contiguous().t(), ln, w, 2)
    got = dp_cuda.banded_edit_distance_cuda(r[:0], ln[:0], w[:0], 2)
    assert got[0].shape == (0,)
    long_r = torch.from_numpy(rng.integers(0, 5, size=(4, 1816)).astype(np.int8)).to(cuda)
    long_w = long_r.new_zeros((4, 1822))
    long_w[:, 2:1818] = long_r
    long_ln = torch.full((4,), 1816, dtype=torch.int32, device=cuda)
    got = dp_cuda.banded_edit_distance_cuda(long_r, long_ln, long_w, 2)
    want = dp.banded_edit_distance(long_r, long_ln, long_w, 2)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    words = torch.zeros(8, dtype=torch.int32, device=cuda)
    starts = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="k=-1"):
        dp_cuda.banded_edit_distance_text_cuda(words, 100, starts, r, ln, starts, -1, 16)
    with pytest.raises(ValueError, match="int32"):
        dp_cuda.banded_edit_distance_text_cuda(words, 100, starts.long(), r, ln, starts, 2, 16)


@pytest.mark.parametrize("k,L", [(0, 77), (16, 77), (17, 77), (20, 77), (24, 128), (31, 77),
                                 (32, 128), (48, 128), (64, 128), (96, 60), (127, 60), (128, 60),
                                 (200, 40), (2, 1815), (2, 1816), (2, 7231), (2, 7232),
                                 (17, 3000), (24, 2000)])
def test_kernel_designs_equal_plain(cuda, k, L):
    """Both entries on each side of the kernel's design edges: one thread
    a lane up to k = 16 (and k = 0, a band of one slot), a group of 8-32
    threads a lane up to 127, a warp over scratch past it; reads whose
    rows fill a block's shared memory at 128, 64 and 32 threads a block,
    and past a warp's (rows from global memory).  dist and end_b equal
    to plain on every lane, and each launch counted under its design."""
    W = L + 3 * k
    Q = 1001 if L < 1000 else 300
    for B in (Q, Q // 6):  # a lane a read, ~6 lanes a read
        words, n, starts, reads, lengths, rid = (
            torch.from_numpy(a).to(cuda) if isinstance(a, np.ndarray) else a
            for a in _text_inputs(k, W, k + L + B, Q=Q, B=B, L=L))
        before = dict(dp_cuda.banded_edit_distance_text_cuda.by_design)
        got = dp.banded_edit_distance_text(words, n, starts, reads, lengths, rid, k, W)
        after = dp_cuda.banded_edit_distance_text_cuda.by_design
        assert after[dp_cuda.design(k)] == before[dp_cuda.design(k)] + 1
        want = dp.banded_edit_distance_text_plain(words, n, starts, reads, lengths, rid, k, W)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), B
        r, ln = reads[rid.long()].contiguous(), lengths[rid.long()].contiguous()
        wins = window.gather_windows(words, n, starts, W)
        got = dp_cuda.banded_edit_distance_cuda(r, ln, wins, k)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), B


@pytest.mark.parametrize("k", [17, 20, 24, 31, 32, 48, 64, 96, 127])
def test_group_kernel_at_the_window_edges_equals_plain(cuda, k):
    """The group kernel (no row checks the window's bounds) at its edges,
    both entries: the verify window, a narrow window (W = 16: long reads
    end with no candidate in the band) and W = 1, lengths past the read
    rows, negative read and window bytes (equal ones match), starts off
    both text ends."""
    L = 70
    for W in (L + 3 * k, 16, 1):
        Q = 601
        words, n, starts, reads, lengths, rid = (
            torch.from_numpy(a).to(cuda) if isinstance(a, np.ndarray) else a
            for a in _text_inputs(k, W, 3 * k + W, Q=Q, B=100, L=L))
        lengths[::13] = L + 5
        reads[::7, ::5] = -1
        want = dp.banded_edit_distance_text_plain(words, n, starts, reads, lengths, rid, k, W)
        got = dp_cuda.banded_edit_distance_text_cuda(words, n, starts, reads, lengths, rid, k, W)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), W
        r, ln = reads[rid.long()].contiguous(), lengths[rid.long()].contiguous()
        wins = window.gather_windows(words, n, starts, W)
        wins[::5, ::3] = -1
        want = dp.banded_edit_distance(r, ln, wins, k)
        got = dp_cuda.banded_edit_distance_cuda(r, ln, wins, k)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), W


def _text_inputs(k, W, seed, Q=3001, B=500, L=77, n=20_000):
    """Text-entry inputs like the verify stage's: rid not decreasing (with
    a tail of rid 0, as compact_lanes leaves unused lanes), half the lanes
    holding their read near the window start, starts off both text ends and
    next to word boundaries, ragged and 0-length reads, N codes."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=n, dtype=np.uint8)
    words = packing.pack(codes)
    rid = np.sort(rng.integers(0, B, size=Q)).astype(np.int32)
    rid[-200:] = 0
    starts = rng.integers(-W, n + 5, size=Q).astype(np.int32)
    edges = [-W - 7, -k - 1, -1, 0, 15, 16, 17, 31, 32, n - W - 1, n - W, n - W + 3, n - 1, n, n + 20]
    starts[: len(edges)] = edges
    reads = rng.integers(0, 5, size=(B, L)).astype(np.int8)
    for q in range(len(edges), Q, 2):
        seg = codes[max(starts[q] + k, 0) : max(starts[q] + k + L, 0)]
        reads[rid[q], : seg.size] = seg
    lengths = np.where(rng.random(B) < 0.7, L, rng.integers(0, L + 1, size=B)).astype(np.int32)
    lengths[::41] = 0
    return words.view(np.int32), n, starts, reads, lengths, rid


@pytest.mark.parametrize("k", range(1, dp_cuda.REGISTER_K + 1))
@pytest.mark.parametrize("narrow", [False, True])
def test_text_entry_equals_plain(cuda, k, narrow):
    """The fused entry (window gathered from the packed text in the kernel)
    against ``gather_windows`` + ``reads[rid]`` + the plain DP on every
    lane; a block over more than 128 reads takes the per-lane read copy."""
    L = 77
    W = L // 2 if narrow else L + 3 * k
    for B in (500, 6000):  # ~6 and ~0.5 lanes a read
        words, n, starts, reads, lengths, rid = (
            torch.from_numpy(a).to(cuda) if isinstance(a, np.ndarray) else a
            for a in _text_inputs(k, W, 10 * k + narrow + B, B=B, L=L))
        before = dp_cuda.banded_edit_distance_text_cuda.launches
        got = dp.banded_edit_distance_text(words, n, starts, reads, lengths, rid, k, W)
        assert dp_cuda.banded_edit_distance_text_cuda.launches == before + 1
        want = dp.banded_edit_distance_text_plain(words, n, starts, reads, lengths, rid, k, W)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), B
        assert bool((want[0] >= dp.INF).any()) == narrow


def _hits_equal(a, b):
    for field in pipeline.ArrayHits._fields:
        x, y = getattr(a, field), getattr(b, field)
        assert (x == y) if isinstance(x, dict) else np.array_equal(x, y), field


def test_aligner_on_card_equals_cpu(cuda):
    rng = np.random.default_rng(9)
    unit = rng.integers(0, 4, size=300, dtype=np.uint8)
    copies = []
    for _ in range(30):
        c = unit.copy()
        mut = rng.random(300) < 0.03
        c[mut] = (c[mut] + rng.integers(1, 4, size=int(mut.sum()))) % 4
        copies.append(c)
    codes = np.concatenate(copies + [rng.integers(0, 4, size=60000, dtype=np.uint8)])
    genome = Genome.from_contigs([Contig("c", codes)])
    gi = GenomeIndex(genome, build_fm_index(genome.codes, sample_rate=16), None)
    tab = build_seed_table(genome.codes, 10)
    reads, _, _, _ = simulate_reads_array(codes, 2000, 100, seed=3, max_subs=2, indel_frac=0.2)
    reads = reads.astype(np.int8)
    lengths = np.full(2000, 100, np.int32)
    ragged = rng.integers(40, 101, size=2000).astype(np.int32)
    for kw in ({}, {"max_hits_per_piece": 2}):
        on_card = pipeline.SuffixFilterAligner(gi, seed_table=tab, seed_j=10, device=cuda, **kw)
        on_cpu = pipeline.SuffixFilterAligner(gi, seed_table=tab, seed_j=10, device="cpu", **kw)
        for lens in (lengths, ragged):
            before = dp_cuda.banded_edit_distance_text_cuda.launches
            h = on_card.align_arrays_submit(reads, lens)
            pipeline.prefetch_result(h)
            got = on_card.align_arrays_finish(h)
            assert dp_cuda.banded_edit_distance_text_cuda.launches > before
            _hits_equal(got, on_cpu.align_arrays_finish(on_cpu.align_arrays_submit(reads, lens)))


def _myers_inputs(Q, L, W, seed):
    """Half the lanes hold their read (a few substitutions) inside the
    window, half are random; codes 0..4 (4 = N); ragged lengths, some 0."""
    rng = np.random.default_rng(seed)
    reads = rng.integers(0, 5, size=(Q, L)).astype(np.int32)
    wins = rng.integers(0, 5, size=(Q, W)).astype(np.int32)
    planted = np.nonzero(rng.random(Q) < 0.5)[0]
    at = int(rng.integers(0, max(1, W - L)))
    span = min(L, W - at)
    wins[planted, at : at + span] = reads[planted, :span]
    for _ in range(3):
        col = rng.integers(0, W, size=planted.size)
        wins[planted, col] = rng.integers(0, 4, size=planted.size)
    lengths = np.where(rng.random(Q) < 0.7, L, rng.integers(0, L + 1, size=Q)).astype(np.int32)
    lengths[::37] = 0
    return reads, lengths, wins


@pytest.mark.parametrize("L", [20, 32, 64, 96, 100, 128, 150, 160, 192, 224, 256])
@pytest.mark.parametrize("dtype", [torch.int8, torch.int32])
def test_myers_kernel_equals_plain(cuda, L, dtype):
    Q, W = 1001, L + 43  # Q not a multiple of the 128-thread block, W not of 8
    reads, lengths, wins = _myers_inputs(Q, L, W, L)
    r, w = (torch.from_numpy(a).to(cuda, dtype) for a in (reads, wins))
    ln = torch.from_numpy(lengths).to(cuda)
    nwords = -(-L // 32)
    for steps in (W, W - 5):
        before = myers_cuda.myers_semiglobal_cuda.launches
        got = myers_cuda.myers_semiglobal_cuda(r, ln, w, nwords, steps)
        assert myers_cuda.myers_semiglobal_cuda.launches == before + 1
        want = myers._myers_plain(r, ln, w, nwords, steps)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    zero = torch.from_numpy(lengths == 0).to(cuda)
    assert int(got[0][zero].abs().sum()) == 0 and int(got[1][zero].abs().sum()) == 0
    # the dispatcher sends CUDA tensors to the kernel
    before = myers_cuda.myers_semiglobal_cuda.launches
    myers.myers_semiglobal_end(r, ln, w, nwords)
    assert myers_cuda.myers_semiglobal_cuda.launches == before + 1


def test_myers_kernel_rejects_what_it_cannot_take(cuda):
    """The wrappers refuse CPU tensors, a strided tensor, mixed dtypes and
    no words; reads of 257 bases (9 words: a group of threads a lane) are
    taken by both entries and equal the plain version."""
    reads, lengths, wins = _myers_inputs(4, 257, 300, 257)
    r = torch.from_numpy(reads).to(cuda, torch.int8)
    w = torch.from_numpy(wins).to(cuda, torch.int8)
    ln = torch.from_numpy(lengths).to(cuda)
    got = myers_cuda.myers_semiglobal_cuda(r, ln, w)
    want = myers._myers_plain(r, ln, w, 9, 300)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(ValueError, match="nwords=0"):
        myers_cuda.myers_semiglobal_cuda(r, ln, w, 0)
    r, w, ln = r[:, :100].contiguous(), w[:, :120].contiguous(), ln.clone().fill_(100)
    with pytest.raises(ValueError, match="CUDA"):
        myers_cuda.myers_semiglobal_cuda(r.cpu(), ln.cpu(), w.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        myers_cuda.myers_semiglobal_cuda(r.t().contiguous().t(), ln, w)
    with pytest.raises(ValueError, match="int8 or int32"):
        myers_cuda.myers_semiglobal_cuda(r, ln, w.int())
    got = myers_cuda.myers_semiglobal_cuda(r[:0], ln[:0], w[:0])
    assert got[0].shape == (0,)
    words = torch.from_numpy(packing.pack(np.arange(128, dtype=np.uint8) % 4).view(np.int32))
    words = words.to(cuda)
    z = torch.zeros(4, dtype=torch.int32, device=cuda)
    r257 = torch.from_numpy(reads).to(cuda, torch.int8)
    ln257 = torch.from_numpy(lengths).to(cuda)
    args = (words, 128, z - 5, r257, ln257, z + torch.arange(4, dtype=torch.int32, device=cuda),
            z + 290, 300, 9)
    got = myers_cuda.myers_semiglobal_text_cuda(*args)
    want = myers.myers_semiglobal_text_plain(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(ValueError, match="int8"):
        myers_cuda.myers_semiglobal_text_cuda(words, 100, z, r.int(), ln, z, z, 120, 4)
    got = myers_cuda.myers_semiglobal_text_cuda(words, 100, z[:0], r, ln, z[:0], z[:0], 120, 4)
    assert got[0].shape == (0,)


def _myers_text_inputs(L, W, B, Q, seed, n=30_000):
    """Text-entry lanes like the rescue's and the verify's: repeated rids,
    starts off both text ends and at word edges, the read planted (with an
    indel or substitutions) in half the windows, valid < W in half the
    lanes, N codes, ragged and zero lengths."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=n, dtype=np.uint8)
    words = packing.pack(codes).view(np.int32)
    rid = rng.integers(0, B, size=Q).astype(np.int32)
    starts = rng.integers(-W, n + 5, size=Q).astype(np.int32)
    edges = [-W - 7, -40, -1, 0, 15, 16, 17, 31, 32, n - W - 1, n - W, n - 1, n, n + 20]
    starts[: len(edges)] = edges
    reads = rng.integers(0, 5, size=(B, L)).astype(np.int8)
    for q in range(len(edges), Q, 2):
        at = int(rng.integers(0, max(1, W - L)))
        seg = codes[max(starts[q] + at, 0) : max(starts[q] + at + L + 1, 0)].astype(np.int8)
        if seg.size and rng.random() < 0.3:
            seg = np.delete(seg, rng.integers(0, seg.size))
        reads[rid[q], : min(L, seg.size)] = seg[:L]
        reads[rid[q], rng.integers(0, L, size=2)] = rng.integers(0, 4, size=2)
    lengths = np.where(rng.random(B) < 0.7, L, rng.integers(0, L + 1, size=B)).astype(np.int32)
    lengths[::37] = 0
    valid = np.where(rng.random(Q) < 0.5, W, rng.integers(-2, W + 1, size=Q)).astype(np.int32)
    return words, n, starts, reads, lengths, rid, valid


@pytest.mark.parametrize("nwords", [8, 9, 16, 17, 32, 33, 64, 65, 96, 97, 128, 129, 256, 257,
                                    512, 513])
def test_myers_designs_equal_plain(cuda, nwords):
    """Both entries on each side of the kernel's design edges: one thread a
    lane up to 8 words, then groups of 16 and 32 threads of one word, a
    warp of 2, 3, 4, 8 and 16 words a thread, and a warp over scratch past
    512 words (reads of 32 nwords - 5 bases; the int32 windows entry too).
    (best, end) equal to plain on every lane, each launch counted under
    its design."""
    L = 32 * nwords - 5
    W = L + 43
    Q = 257 if nwords <= 64 else 64
    words, n, starts, reads, lengths, rid, valid = _myers_text_inputs(L, W, Q, Q, nwords,
                                                                      n=L + 30_000)
    args = [torch.from_numpy(a).to(cuda) if isinstance(a, np.ndarray) else a
            for a in (words, n, starts, reads, lengths, rid, valid)]
    before = dict(myers_cuda.myers_semiglobal_text_cuda.by_design)
    got = myers.myers_semiglobal_text(*args, W, nwords)
    after = myers_cuda.myers_semiglobal_text_cuda.by_design
    assert after[myers_cuda.design(nwords)] == before[myers_cuda.design(nwords)] + 1
    want = myers.myers_semiglobal_text_plain(*args, W, nwords)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int((want[0] <= max(5, L // 20)).sum()) > Q // 20
    r, ln, w = (torch.from_numpy(a).to(cuda) for a in _myers_inputs(Q, L, W, nwords))
    want = myers._myers_plain(r, ln, w, nwords, W - 7)
    for dtype in (torch.int8, torch.int32):
        got = myers_cuda.myers_semiglobal_cuda(r.to(dtype), ln, w.to(dtype), nwords, W - 7)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), dtype


@pytest.mark.parametrize("L", [257, 300, 512, 1000, 2048, 4000, 8000, 16_000, 32 * 520 - 5])
def test_myers_wavefront_shapes_equal_plain(cuda, L):
    """The group kernel as a wavefront, both entries, at [8]'s 300 bp
    rescue length, 257-16,000 bases (every (G, P) that ``group_shape``
    picks: 16 x 1, then 8, 16 and 32 threads of 4 words, a warp of 8 and
    of 16) and 520 words (scratch): (best, end) equal to plain on every
    lane."""
    nwords = -(-L // 32)
    G, P = myers_cuda.group_shape(nwords)
    assert G * P >= nwords and (P in myers_cuda.REG_WORDS or nwords > myers_cuda.MEM_WORDS)
    W = L + 43
    Q = 257 if nwords <= 64 else 48
    words, n, starts, reads, lengths, rid, valid = _myers_text_inputs(L, W, Q, Q, L,
                                                                      n=L + 30_000)
    args = [torch.from_numpy(a).to(cuda) if isinstance(a, np.ndarray) else a
            for a in (words, n, starts, reads, lengths, rid, valid)]
    want_t = myers.myers_semiglobal_text_plain(*args, W, nwords)
    r, ln, w = (torch.from_numpy(a).to(cuda) for a in _myers_inputs(Q, L, W, nwords))
    want_w = myers._myers_plain(r, ln, w, nwords, W - 7)
    got = myers_cuda.myers_semiglobal_text_cuda(*args, W, nwords)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want_t[0]) and torch.equal(got[1], want_t[1]), (G, P)
    got = myers_cuda.myers_semiglobal_cuda(r, ln, w, nwords, W - 7)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want_w[0]) and torch.equal(got[1], want_w[1]), (G, P)
    assert int((want_t[0] <= max(5, L // 20)).sum()) > Q // 20


@pytest.mark.parametrize("L", [20, 32, 64, 100, 150, 256])
def test_myers_text_entry_equals_plain(cuda, L):
    """The text entry (window streamed from the packed text in the kernel)
    against gather + where + the plain loop on every lane; a block over
    more rows than it has lanes takes the per-lane read copy."""
    W = L + 43  # not a multiple of the 16-column group
    for B, Q, rid_sorted in ((3000, 3001, False), (300, 2048, True), (40, 999, False)):
        words, n, starts, reads, lengths, rid, valid = _myers_text_inputs(L, W, B, Q, L + B)
        if rid_sorted:
            rid = np.sort(rid)
        args = [torch.from_numpy(a).to(cuda) if isinstance(a, np.ndarray) else a
                for a in (words, n, starts, reads, lengths, rid, valid)]
        nwords = -(-L // 32)
        before = myers_cuda.myers_semiglobal_text_cuda.launches
        got = myers.myers_semiglobal_text(*args, W, nwords)
        assert myers_cuda.myers_semiglobal_text_cuda.launches == before + 1
        want = myers.myers_semiglobal_text_plain(*args, W, nwords)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), (B, Q)
        assert int((want[0] <= 5).sum()) > Q // 20


def test_fm_path_and_rescue_on_card_equal_cpu(cuda):
    """The FM pigeonhole path (banded kernel) and paired mate rescue
    (Myers kernel) on the card against the same aligners on the CPU."""
    rng = np.random.default_rng(12)
    codes = rng.integers(0, 4, size=80_000, dtype=np.uint8)
    genome = Genome.from_contigs([Contig("c", codes)])
    gi = GenomeIndex(genome, build_fm_index(genome.codes, sample_rate=8), None)
    n, L = 512, 100
    pos1 = rng.integers(0, codes.size - 600, size=n)
    c1 = codes[pos1[:, None] + np.arange(L)].astype(np.int8)
    p2 = pos1 + rng.integers(250, 550, size=n) - L
    c2 = np.ascontiguousarray((3 - codes[p2[:, None] + np.arange(L)].astype(np.int8))[:, ::-1])
    half = np.arange(0, n, 8)
    for col in (10, 35, 60, 85):  # 4 substitutions: unmappable at k = 2, rescued
        c2[half, col] = (c2[half, col] + 1) % 4
    lengths = np.full(n, L, np.int32)
    results = []
    for device in (cuda, torch.device("cpu")):
        pa = paired.PairedAligner(pipeline.SuffixFilterAligner(gi, k=2, device=device),
                                  min_insert=200, max_insert=600)
        before = (dp_cuda.banded_edit_distance_text_cuda.launches,
                  myers_cuda.myers_semiglobal_text_cuda.launches,
                  myers_cuda.myers_semiglobal_cuda.launches,
                  fm_search_cuda.backward_search_cuda.launches)
        results.append(pa.align_pair_arrays(c1, lengths, c2, lengths))
        if device.type == "cuda":
            assert fm_search_cuda.backward_search_cuda.launches > before[3]
            assert dp_cuda.banded_edit_distance_text_cuda.launches > before[0]
            assert myers_cuda.myers_semiglobal_text_cuda.launches > before[1]
            assert myers_cuda.myers_semiglobal_cuda.launches == before[2]
    got, want = results
    assert sum(ph.rescued != 0 for ph in got) >= n // 10
    assert [(a.h1, a.h2, a.proper, a.rescued) for a in got] == \
        [(b.h1, b.h2, b.proper, b.rescued) for b in want]


def test_rescue_and_myers_verify_stream_from_the_text(cuda, monkeypatch):
    """Mate rescue and verify_mode="myers" on the card equal the CPU and
    reach the Myers text entry without ever gathering a window tensor."""
    rng = np.random.default_rng(13)
    codes = rng.integers(0, 4, size=60_000, dtype=np.uint8)
    genome = Genome.from_contigs([Contig("c", codes)])
    gi = GenomeIndex(genome, build_fm_index(genome.codes, sample_rate=8), None)
    n, L = 300, 100
    pos = rng.integers(0, codes.size - 700, size=n)
    # each mate on the reverse strand 300 bases past its forward anchor
    mates = np.ascontiguousarray((3 - codes[pos[:, None] + 300 + np.arange(L)].astype(np.int8))[:, ::-1])
    mates[::3, 40] = (mates[::3, 40] + 1) % 4
    anchors = [pipeline.ApproxHit(int(p), 0, 0, f"{L}M", 1, False) for p in pos]
    jobs = [(m[: L - (i % 7)], a, L) for i, (m, a) in enumerate(zip(mates, anchors))]
    B, C = 64, 5
    reads = codes[pos[:B, None] + np.arange(L)].astype(np.int32)
    cand = np.stack([pos[:B] + o for o in (0, 3, -2, 500, 9000)], axis=1).astype(np.int32)
    cand[::4, 2] = suffix_filter.NO_CAND
    text_cpu = torch.from_numpy(packing.pack(codes).view(np.int32))
    out = {}
    for device in (torch.device("cpu"), cuda):
        if device.type == "cuda":
            def no_gather(*a, **kw):
                raise AssertionError("a (Q, W) window tensor was gathered")
            monkeypatch.setattr(window, "gather_windows", no_gather)
        pa = paired.PairedAligner(pipeline.SuffixFilterAligner(gi, k=2, device=device),
                                  min_insert=200, max_insert=600)
        before = myers_cuda.myers_semiglobal_text_cuda.launches
        rescued = pa._rescue_batch(jobs)
        dist = suffix_filter.verify_candidates_myers(
            text_cpu.to(device), codes.size, torch.from_numpy(reads).to(device),
            torch.full((B,), L, dtype=torch.int32, device=device),
            torch.from_numpy(cand).to(device), 2, L + 6, 4)
        out[device.type] = (rescued, dist.cpu())
        if device.type == "cuda":
            assert myers_cuda.myers_semiglobal_text_cuda.launches == before + 2
    assert out["cuda"][0] == out["cpu"][0]
    assert sum(h is not None for h in out["cpu"][0]) > n // 2
    assert torch.equal(out["cuda"][1], out["cpu"][1])
    assert int((out["cpu"][1] == 0).sum()) >= B // 2


def test_verify_mode_myers_on_card_equals_cpu(cuda):
    """Myers verify runs on the ragged path, as in the JAX aligner."""
    rng = np.random.default_rng(14)
    codes = rng.integers(0, 4, size=50_000, dtype=np.uint8)
    genome = Genome.from_contigs([Contig("c", codes)])
    gi = GenomeIndex(genome, build_fm_index(genome.codes, sample_rate=8), None)
    reads, _, _, _ = simulate_reads_array(codes, 500, 100, seed=5, max_subs=2, indel_frac=0.2)
    reads = reads.astype(np.int8)
    lengths = rng.integers(40, 101, size=500).astype(np.int32)
    for i, n in enumerate(lengths):
        reads[i, n:] = 0
    hits = []
    for device in (cuda, torch.device("cpu")):
        al = pipeline.SuffixFilterAligner(gi, k=2, verify_mode="myers", device=device)
        before = myers_cuda.myers_semiglobal_text_cuda.launches
        hits.append(al.align_arrays_finish(al.align_arrays_submit(reads, lengths)))
        if device.type == "cuda":
            assert myers_cuda.myers_semiglobal_text_cuda.launches > before
    _hits_equal(*hits)


@pytest.mark.parametrize("S", [1, 2, 3, 4, 5, 8, 16])
def test_ring_allreduce_equals_plain(cuda, S):
    """The one-pass kernel against the ring's plain sum on every element:
    int32 (wrapping) and float32 bit for bit, at sizes that are and are not
    a multiple of the 4-element vector."""
    rng = np.random.default_rng(S)
    for n in (1, 3, 777, 4099, 65_536, 4_194_304):
        x = torch.from_numpy(rng.integers(-(1 << 30), 1 << 30, size=(S, n), dtype=np.int32)).to(cuda)
        before = ring_cuda.ring_allreduce_cuda.launches
        got = ring_cuda.ring_allreduce_cuda(x)
        assert ring_cuda.ring_allreduce_cuda.launches == before + 1
        assert torch.equal(got, ring.ring_psum_plain(x)), n  # int32 wraps alike
    for shape in ((4, 16_384), (5, 7), (1023,)):
        xf = torch.from_numpy(rng.standard_normal((S, *shape)).astype(np.float32) * 1e4).to(cuda)
        got = ring_cuda.ring_allreduce_cuda(xf)
        assert torch.equal(got, ring.ring_psum_plain(xf)), shape  # the same order: bit-equal
    # the dispatcher sends CUDA tensors to the kernel
    before = ring_cuda.ring_allreduce_cuda.launches
    ring.ring_psum(xf)
    assert ring_cuda.ring_allreduce_cuda.launches == before + 1


@pytest.mark.parametrize("S", [17, 32, 64, 1024])
def test_ring_allreduce_past_16_shards_equals_plain(cuda, S):
    """Past 16 shards: stacked shards and shards in their own allocations
    (the addresses from a device table), every output or one (``only``),
    int32 and float32 bit for bit in the ring's order."""
    gen = torch.Generator(device=cuda).manual_seed(S)
    for n in (1, 3, 777, 4099):
        x = torch.randint(-(1 << 30), 1 << 30, (S, n), generator=gen, device=cuda,
                          dtype=torch.int32)
        xf = torch.randn((S, n), generator=gen, device=cuda) * 1e4
        for t in (x, xf):
            want = ring.ring_psum_plain(t)
            before = ring_cuda.ring_allreduce_cuda.launches
            assert torch.equal(ring_cuda.ring_allreduce_cuda(t), want), (n, t.dtype)
            assert ring_cuda.ring_allreduce_cuda.launches == before + 1
            apart = [u.clone() for u in t]
            assert torch.equal(ring_cuda.ring_allreduce_cuda(apart), want), (n, t.dtype)
            for d in (0, S // 2, S - 1):
                assert torch.equal(ring.ring_psum(apart, only=d), want[d]), (n, t.dtype, d)


@pytest.mark.parametrize("S", [1, 2, 3, 4, 5, 8, 9, 16, 17, 32, 33, 100, 128, 129, 256, 1024])
def test_ring_sum_split_equals_plain_with_and_without_only(cuda, S):
    """The int32 sum split over a group's lanes (and the float32 ring
    order) at S = 1..1,024: stacked and from a device table (one allocation
    a shard), every output and ``only``, vector and element items, against
    ``ring_psum_plain`` on every element."""
    gen = torch.Generator(device=cuda).manual_seed(1000 + S)
    for n in (5, 4 * 1025, 2 * 32_768):
        for dtype in (torch.int32, torch.float32):
            x = (torch.randint(-(1 << 31), (1 << 31) - 1, (S, n), generator=gen, device=cuda,
                               dtype=torch.int32) if dtype == torch.int32
                 else torch.randn((S, n), generator=gen, device=cuda) * 1e4)
            want = ring.ring_psum_plain(x)
            apart = [t.clone() for t in x]
            for parts in (x, apart):
                assert torch.equal(ring_cuda.ring_allreduce_cuda(parts), want), (n, dtype)
                for d in sorted({0, S // 3, S - 1}):
                    got = ring_cuda.ring_allreduce_cuda(parts, only=d)
                    assert got.shape == (n,) and torch.equal(got, want[d]), (n, dtype, d)
    parts = torch.randint(-99, 99, (S, 2, 64), generator=gen, device=cuda, dtype=torch.int32)
    before = ring_cuda.ring_allreduce_cuda.launches
    assert torch.equal(sharded_index.ring_merge(parts), parts.sum(0, dtype=torch.int32))
    assert ring_cuda.ring_allreduce_cuda.launches == before + 1


def test_sharded_seed_verify_at_32_shards_equals_the_stacked_plain(cuda):
    """The seed path's verify at 32 shards on the card (the window gather
    from each base's owner shard, then the banded windows entry), stacked
    and one allocation a shard: the windows equal the whole text's
    (``window.gather_windows``), and (best_pos, best_dist, n_good) equal the
    plain verify of those windows on the CPU."""
    rng = np.random.default_rng(32)
    codes = rng.integers(0, 4, size=200_000, dtype=np.uint8)
    fm = build_fm_index(codes, sample_rate=8)
    B, C, L, k = 512, 24, 100, 2
    W = L + 3 * k
    pos = rng.integers(-20, fm.n - L + 20, size=(B, C))
    pos[:, 0] = rng.integers(0, fm.n - L, size=B)
    cand = np.sort(np.where(rng.random((B, C)) < 0.3, suffix_filter.NO_CAND, pos), axis=1)
    reads = codes[pos[:, 0, None] + np.arange(L)].astype(np.int32)
    reads[::5, 7] = (reads[::5, 7] + 1) % 4
    lengths = np.full(B, L, np.int32)
    args = [torch.from_numpy(a) for a in (reads, lengths, cand.astype(np.int32))]
    invalid = args[2] == suffix_filter.NO_CAND
    starts = torch.where(invalid, 0, args[2] - k).reshape(-1)
    wins = window.gather_windows(torch.from_numpy(fm.text_words.view(np.int32)), fm.n, starts, W)
    dist, _ = dp.banded_edit_distance_best(
        args[0].to(torch.int8).repeat_interleave(C, dim=0), args[1].repeat_interleave(C), wins, k)
    want = suffix_filter.best_hit(args[2], torch.where(invalid, dp.INF, dist.reshape(B, C)), k)
    tx = sharded_pipeline.put_text(sharded_pipeline.shard_text(fm.text_words, fm.n, 32), cuda)
    apart = sharded_pipeline.ShardedText(
        [t.clone() for t in tx.words], tx.base, tx.end, tx.n)
    for t in (tx, apart):
        assert torch.equal(sharded_pipeline.gather_windows(t, starts.to(cuda), W).cpu(), wins)
        before = dp_cuda.banded_edit_distance_cuda.launches
        got = sharded_pipeline._verify_best(t, *(a.to(cuda) for a in args), k, W)
        assert dp_cuda.banded_edit_distance_cuda.launches == before + 1
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)
    assert int((want.best_dist == 0).sum()) >= B // 2


def test_ring_rejects_what_it_cannot_take(cuda):
    for dtype in (torch.int64, torch.float16, torch.int8):
        with pytest.raises(TypeError, match="int32 or float32"):
            ring_cuda.ring_allreduce_cuda(torch.zeros((2, 8), dtype=dtype, device=cuda))
        with pytest.raises(TypeError, match="int32 or float32"):
            ring.ring_psum(torch.zeros((2, 8), dtype=dtype, device=cuda))
    with pytest.raises(ValueError, match="shards"):
        ring_cuda.ring_allreduce_cuda(torch.zeros((0, 8), dtype=torch.int32, device=cuda))
    z = torch.zeros((0, 2, 5), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="shards"):
        ring_cuda.fused_rank_ring_cuda(torch.zeros((0, 2, 5, 8), dtype=torch.int32, device=cuda),
                                       z, z, z, z)
    s = torch.zeros(2, dtype=torch.int32, device=cuda)
    q = torch.zeros(5, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="occ_cp"):
        ring_cuda.fused_occ_cuda(torch.zeros((2, 3, 8), dtype=torch.int32, device=cuda),
                                 torch.zeros((2, 4, 4), dtype=torch.int32, device=cuda), s, s, 0,
                                 q, q)
    with pytest.raises(TypeError, match="int32"):
        ring_cuda.fused_occ_cuda(torch.zeros((2, 3, 8), dtype=torch.int32, device=cuda),
                                 torch.zeros((2, 3, 4), dtype=torch.int32, device=cuda), s, s, 0,
                                 q.long(), q)


def _sharded_rows(fm, S, M, Q, seed):
    """Fused-kernel inputs gathered from a real sharded index: Q query
    coordinates over the whole range (the primary row and the shard edges
    included) per payload."""
    rng = np.random.default_rng(seed)
    sh = sharded_index.put_sharded(sharded_index.shard_fm_index(fm, S), "cpu")
    edges = np.concatenate([sh.pk_start.numpy(), sh.pk_end.numpy(), [fm.primary, fm.n]])
    k = rng.integers(0, fm.n + 1, size=(M, Q)).astype(np.int32)
    k[:, : min(Q, 2 * edges.size)] = np.clip(
        np.concatenate([edges, edges - 1])[: min(Q, 2 * edges.size)], 0, fm.n)
    c = rng.integers(0, 4, size=(M, Q)).astype(np.int32)
    g = [sharded_index.local_occ_gather(sh, torch.from_numpy(c[m]), torch.from_numpy(k[m]))
         for m in range(M)]
    words, roff, base, own = (torch.stack([x[f] for x in g], dim=1) for f in range(4))
    codes = torch.from_numpy(c)[None].expand(S, M, Q).contiguous()
    return words, codes, roff, base, own, (c, k)


@pytest.fixture(scope="module")
def ring_fm():
    rng = np.random.default_rng(77)
    return build_fm_index(rng.integers(0, 4, size=200_000, dtype=np.uint8), sample_rate=8)


@pytest.mark.parametrize("S", [*range(1, 17), 17, 32, 64])
def test_fused_rank_ring_equals_plain(cuda, ring_fm, S):
    """The words entry: one pass, any M, against the plain rank + ring sum
    and the index's own occ, to 64 shards."""
    fm = ring_fm
    for M in (range(1, 10) if S <= 16 else (1, 2, 9)):
        for Q in ((96, 65_536) if M in (2, 9) else (96,)):
            ins = _sharded_rows(fm, S, M, Q, Q + S + M)
            plain = ring.fused_rank_ring_plain(*ins[:5])
            before = ring_cuda.fused_rank_ring_cuda.launches
            got = ring_cuda.fused_rank_ring_cuda(*(t.to(cuda) for t in ins[:5]))
            assert ring_cuda.fused_rank_ring_cuda.launches == before + 1
            assert torch.equal(got.cpu(), plain), (M, Q)
            c, k = ins[5]
            for m in range(M):
                want = np.array([fm.occ(int(cc), int(kk)) for cc, kk in zip(c[m, :50], k[m, :50])])
                assert np.array_equal(got[0, m, :50].cpu().numpy(), want.reshape(-1))


@pytest.mark.parametrize("S", [1, 2, 3, 4, 8, 16, 17, 32, 64, 128, 1024])
def test_fused_occ_equals_plain(cuda, ring_fm, S):
    """The table entry: rows read from the shard tables on the card against
    ``fused_occ_plain`` and the single-device rank, every coordinate."""
    fm = ring_fm
    sh = sharded_index.put_sharded(sharded_index.shard_fm_index(fm, S), cuda)
    rng = np.random.default_rng(S)
    # every coordinate; past 64 shards every 29th (the plain version's
    # (S, 2, queries) partials must fit the card)
    k = torch.arange(0, fm.n + 2, 1 if S <= 64 else 29, dtype=torch.int32, device=cuda)
    c = torch.from_numpy(rng.integers(0, 4, size=k.numel()).astype(np.int32)).to(cuda)
    before = ring_cuda.fused_occ_cuda.launches
    got = sharded_index.fused_occ(sh, torch.stack([c, 3 - c]), torch.stack([k, k.flip(0)]))
    assert ring_cuda.fused_occ_cuda.launches == before + 1
    want = sharded_index.fused_occ_plain(sh, torch.stack([c, 3 - c]), torch.stack([k, k.flip(0)]))
    assert torch.equal(got, want)
    assert torch.equal(got[0], rank.occ_codes(rank.from_host(fm, cuda), c, k))


@pytest.mark.parametrize("S", [*range(2, 17), 34, 64])
def test_fused_occ_on_held_shards_equals_plain(cuda, ring_fm, S):
    """The table entry over the shards one process of a collective interval
    group holds (uploaded alone, ``held_index``; for every g dividing S, so
    held shards that do not start at shard 0): every coordinate of [0,
    n + 1] against ``fused_occ_plain`` over the same shards, coordinates no
    held shard owns give 0, and the group's results sum to the stacked
    index's occ."""
    fm = ring_fm
    rng = np.random.default_rng(100 + S)
    k = torch.arange(fm.n + 2, dtype=torch.int32, device=cuda)
    c = torch.from_numpy(rng.integers(0, 4, size=fm.n + 2).astype(np.int32)).to(cuda)
    stacked = sharded_index.put_sharded(sharded_index.shard_fm_index(fm, S), cuda)
    whole = sharded_index.fused_occ_plain(stacked, c, k)
    for g in (d for d in range(2, S + 1) if S % d == 0):
        total = torch.zeros_like(whole)
        for rank in range(g):
            lay = pmesh.ShardLayout(1, S, cuda, rank, g, g, 1, mapped=False)
            held = sharded_index.held_index(
                sharded_index.put_sharded(sharded_index.shard_fm_index(fm, S), cuda, lay), lay)
            assert held.bwt_blocks.shape[0] == S // g
            before = ring_cuda.fused_occ_cuda.launches
            got = sharded_index.fused_occ(held, c, k)
            assert ring_cuda.fused_occ_cuda.launches == before + 1
            assert torch.equal(got, sharded_index.fused_occ_plain(held, c, k)), (g, rank)
            k_adj = k - (k > fm.primary).to(torch.int32)
            owned = (k_adj >= held.pk_start[0]) & (k_adj < held.pk_end[-1])
            assert not bool(got[~owned].any()), (g, rank)
            total += got
        assert torch.equal(total, whole), g


@pytest.mark.parametrize("S", [4, 32])
@pytest.mark.parametrize("overlap", ["a block", "the whole range"])
def test_fused_occ_on_overlapping_bounds_sums_every_owner(cuda, ring_fm, overlap, S):
    """Packed bounds that overlap (each of the first three shards reaching
    100 coordinates into the next, or the first shard's range covering
    every coordinate): the table entry sums every owner's count, as
    ``fused_occ_plain`` does, on every coordinate."""
    import dataclasses

    fm = ring_fm
    sh = sharded_index.put_sharded(sharded_index.shard_fm_index(fm, S), cuda)
    pk_end = sh.pk_end.clone()
    if overlap == "a block":
        pk_end[:3] = (pk_end[:3] + 100).clamp(max=fm.n + 1)
    else:
        pk_end[0] = fm.n + 1
    sh = dataclasses.replace(sh, pk_end=pk_end)
    rng = np.random.default_rng(5)
    k = torch.arange(fm.n + 2, dtype=torch.int32, device=cuda)
    c = torch.from_numpy(rng.integers(0, 4, size=fm.n + 2).astype(np.int32)).to(cuda)
    got = sharded_index.fused_occ(sh, c, k)
    want = sharded_index.fused_occ_plain(sh, c, k)
    assert torch.equal(got, want)
    assert not torch.equal(want, rank.occ_codes(rank.from_host(fm, cuda), c, k))


def test_sharded_search_and_aligner_on_card_equal_cpu(cuda):
    """All three merges of the sharded exact search, and ShardedAligner on
    both candidate paths, on the card against the CPU."""
    rng = np.random.default_rng(21)
    codes = rng.integers(0, 4, size=120_000, dtype=np.uint8)
    genome = Genome.from_contigs([Contig("c", codes)])
    gi = GenomeIndex(genome, build_fm_index(genome.codes, sample_rate=8), None)
    B, L = 1000, 60
    starts = rng.integers(0, codes.size - L, size=B)
    reads = codes[starts[:, None] + np.arange(L)].astype(np.int32)
    reads[::9, 5] = (reads[::9, 5] + 1) % 4
    lengths = np.full(B, L, np.int32)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        layout = pmesh.make_layout(1, 4, dev)
        sh = sharded_index.put_sharded(sharded_index.shard_fm_index(gi.fwd, 4), dev)
        r, l, _ = pmesh.shard_reads(layout, reads, lengths)
        for merge in ("psum", "ring", "fused"):
            counts = (ring_cuda.ring_allreduce_cuda, ring_cuda.fused_occ_cuda,
                      ring_cuda.fused_rank_ring_cuda)
            before = [f.launches for f in counts]
            fn = sharded_index.make_sharded_exact_search(layout, L, sh, merge=merge, microbatch=2)
            out[dev.type, merge] = [v.cpu() for v in fn(sh, r, l)]
            after = [f.launches for f in counts]
            if dev.type == "cuda":
                assert after[0] - before[0] == (2 * L if merge == "ring" else 0)
                assert after[1] - before[1] == (L if merge == "fused" else 0)
                assert after[2] == before[2]
    for key, val in out.items():
        assert all(torch.equal(a, b) for a, b in zip(val, out["cpu", "psum"])), key
    lo, hi, pos = out["cpu", "psum"]
    one = (hi - lo == 1).numpy()
    assert one.sum() > B // 2 and np.array_equal(pos.numpy()[one], starts[one])

    sims = simulate_reads_array(codes, 600, 100, seed=4, max_subs=2, indel_frac=0.1)[0]
    from genome_weaver_align_tpu_torch.utils.fasta import Read

    reads = [Read(f"r{i}", s.astype(np.uint8)) for i, s in enumerate(sims)]
    tab = build_seed_table(genome.codes, 10)
    for kw in ({}, {"seed_table": tab, "seed_j": 10}):
        hits = []
        for dev in (cuda, torch.device("cpu")):
            al = sharded_pipeline.ShardedAligner(gi, k=2, n_interval=4, device=dev, **kw)
            before = dp_cuda.banded_edit_distance_cuda.launches
            hits.append([r.line() for r in al.to_sam(reads, al.align_batch(reads))])
            if dev.type == "cuda":
                assert dp_cuda.banded_edit_distance_cuda.launches > before
        assert hits[0] == hits[1]


def test_text_entries_clamp_read_ids_on_card(cuda):
    """A read id outside [0, B) (negative, B and past it): both text
    kernels equal their plain versions, which clamp the id into range."""
    L, k = 77, 2
    W = L + 3 * k
    words, n, starts, reads, lengths, rid = _text_inputs(k, W, 91, Q=600, B=50, L=L)
    rid = rid.copy()
    rid[::5] = -1
    rid[1::5] = 50 + 3
    rid[2::7] = 50
    rid[3::11] = -40
    args = [torch.from_numpy(a).to(cuda) if isinstance(a, np.ndarray) else a
            for a in (words, n, starts, reads, lengths, rid)]
    got = dp_cuda.banded_edit_distance_text_cuda(*args, k, W)
    want = dp.banded_edit_distance_text_plain(*args, k, W)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int((want[0] <= k).sum()) > 0

    Lm, Wm = 100, 143
    words, n, starts, reads, lengths, rid, valid = _myers_text_inputs(Lm, Wm, 60, 900, 92)
    rid[::4] = -2
    rid[1::4] = 60 + 5
    rid[2::9] = 60
    args = [torch.from_numpy(a).to(cuda) if isinstance(a, np.ndarray) else a
            for a in (words, n, starts, reads, lengths, rid, valid)]
    got = myers_cuda.myers_semiglobal_text_cuda(*args, Wm, 4)
    want = myers.myers_semiglobal_text_plain(*args, Wm, 4)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.fixture(scope="module")
def flooded_gi():
    """60 copies of a 400 bp unit (3% diverged) before random sequence,
    indexed with its reverse text, its 8-mer seed table, and reads from
    inside the copies with 2 substitutions: at tiny budgets every seed
    bucket floods and tier 2 takes the reads tier 1 leaves."""
    from genome_weaver_align_tpu_torch.index.files import build_genome_index

    rng = np.random.default_rng(11)
    unit = rng.integers(0, 4, size=400, dtype=np.uint8)
    parts = []
    for _ in range(60):
        c = unit.copy()
        mut = rng.random(400) < 0.03
        c[mut] = (c[mut] + rng.integers(1, 4, size=int(mut.sum()))) % 4
        parts.append(c)
    codes = np.concatenate(parts + [rng.integers(0, 4, size=30000, dtype=np.uint8)])
    gi = build_genome_index(Genome.from_contigs([Contig("chrR", codes)]), sample_rate=16)
    reads = np.empty((300, 96), dtype=np.int8)
    for i in range(300):
        p = int(rng.integers(0, 60)) * 400 + int(rng.integers(0, 400 - 96))
        r = codes[p : p + 96].astype(np.int8)
        r[rng.integers(0, 96, size=2)] = rng.integers(0, 4, size=2)
        reads[i] = r
    return gi, build_seed_table(codes, 8), reads


def test_staircase_on_card_equals_cpu(cuda, flooded_gi):
    """Tier 2 behind the seed path (flooding budgets) and the staircase as
    the aligner's own search (``use_staircase``, with and without left
    narrowing), on a uniform and a ragged batch: ArrayHits on the card equal
    the CPU's, tier 2 ran, and its verify launched the banded text entry."""
    gi, tab, reads = flooded_gi
    lengths = np.full(reads.shape[0], reads.shape[1], np.int32)
    ragged = np.random.default_rng(4).integers(60, 97, size=reads.shape[0]).astype(np.int32)
    flood = dict(max_hits_per_piece=2, max_cands=4, seed_table=tab, seed_j=8, seed_probes=1,
                 verify_slack=2)
    for kw in (flood, dict(use_staircase=True),
               dict(use_staircase=True, staircase_narrow_left=True)):
        on_card = pipeline.SuffixFilterAligner(gi, k=2, device=cuda, **kw)
        on_cpu = pipeline.SuffixFilterAligner(gi, k=2, device="cpu", **kw)
        for lens in (lengths, ragged):
            before = dp_cuda.banded_edit_distance_text_cuda.launches
            before_st = staircase_cuda.staircase_pools_cuda.launches
            got = on_card.align_arrays_finish(on_card.align_arrays_submit(reads, lens))
            assert dp_cuda.banded_edit_distance_text_cuda.launches > before
            assert staircase_cuda.staircase_pools_cuda.launches > before_st
            _hits_equal(got, on_cpu.align_arrays_finish(on_cpu.align_arrays_submit(reads, lens)))
            counts = lambda st: {key: v for key, v in st.items() if not key.startswith("t_")}
            assert counts(on_card.last_stats) == counts(on_cpu.last_stats)
            if "seed_table" in kw:  # tier 2 shares the primary's forward tables
                assert on_card.last_stats["n_staircase_fallback"] > 0
                fb2 = on_card._get_fb2()
                assert fb2.bi.fwd is on_card.fm and fb2.text_words is on_card.text_words
            assert got.mapped.mean() > 0.8


def test_exact_and_one_mismatch_aligners_on_card_equal_cpu(cuda):
    """``ExactAligner`` and ``OneMismatchAligner`` on the card against the
    CPU: the same hits, on error-free and one-substitution reads of a
    random genome, a ragged read, a read with an N and an absent read."""
    from genome_weaver_align_tpu_torch.index.files import build_genome_index
    from genome_weaver_align_tpu_torch.models.one_mismatch import OneMismatchAligner
    from genome_weaver_align_tpu_torch.utils.fasta import Read
    from genome_weaver_align_tpu_torch.utils.simulate import simulate_reads

    rng = np.random.default_rng(21)
    codes = rng.integers(0, 4, size=60_000, dtype=np.uint8)
    gi = build_genome_index(Genome.from_contigs([Contig("c", codes)]), sample_rate=16)
    for cls, subs in ((pipeline.ExactAligner, 0), (OneMismatchAligner, 1)):
        sims = simulate_reads(codes, 400, 100, seed=5, sub_rate=0.01, max_subs=subs)
        reads = [s.read for s in sims]
        withn = reads[0].codes.copy()
        withn[30] = 4
        reads += [Read("with_n", withn), Read("short", reads[1].codes[:61].copy()),
                  Read("junk", rng.integers(0, 4, size=100, dtype=np.uint8))]
        counter = (fm_search_cuda.backward_search_cuda if subs == 0
                   else one_mismatch_cuda.one_mismatch_candidates_cuda)
        before = counter.launches
        got = cls(gi, device=cuda).align_batch(reads)
        assert counter.launches > before
        want = cls(gi, device="cpu").align_batch(reads)
        assert [None if h is None else h.__dict__ for h in got] == \
            [None if h is None else h.__dict__ for h in want]
        assert sum(h is not None for h in got) >= 400


def _long_reads(codes, n, rng):
    """Ragged reads of 300-2,000 bases on both strands, 6 substitutions and
    2 one-base indels each, zero-padded to the longest."""
    lens = rng.integers(300, 2001, size=n)
    reads = np.zeros((n, int(lens.max())), np.int8)
    for i, m in enumerate(lens):
        p = int(rng.integers(0, codes.size - m - 40))
        seq = list(codes[p : p + m + 20])
        for _ in range(2):
            at = int(rng.integers(60, m - 60))
            if rng.random() < 0.5:
                seq.insert(at, int(rng.integers(0, 4)))
            else:
                del seq[at]
        seq = np.array(seq[:m], np.int8)
        at = rng.integers(0, m, size=6)
        seq[at] = (seq[at] + rng.integers(1, 4, size=6)) % 4
        reads[i, :m] = (3 - seq)[::-1] if i % 2 else seq
    return reads, lens.astype(np.int32)


def test_long_read_aligner_on_card_equals_cpu(cuda, monkeypatch):
    """LongReadAligner on the card (segment verify at kb = 16 through the
    text entry, never the plain version) against the CPU, field for field,
    with and without traceback, at kb = 16 and kb = 15."""
    from genome_weaver_align_tpu_torch.models import long_read

    rng = np.random.default_rng(14)
    codes = rng.integers(0, 4, size=300_000, dtype=np.uint8)
    genome = Genome.from_contigs([Contig("c", codes)])
    gi = GenomeIndex(genome, build_fm_index(genome.codes, sample_rate=16), None)
    tab = build_seed_table(genome.codes, 11)
    reads, lens = _long_reads(codes, 48, rng)
    plain = dp.banded_edit_distance_text_plain
    for kb in (16, 15):
        on_card = long_read.LongReadAligner(gi, tab, 11, kb=kb, device=cuda)
        on_cpu = long_read.LongReadAligner(gi, tab, 11, kb=kb, device="cpu")
        for traceback in (True, False):
            def no_plain(*a, **kw):
                raise AssertionError("the card run reached the plain DP")

            monkeypatch.setattr(dp, "banded_edit_distance_text_plain", no_plain)
            before = dp_cuda.banded_edit_distance_text_cuda.launches
            got = on_card.align_arrays(reads, lens, traceback=traceback)
            assert dp_cuda.banded_edit_distance_text_cuda.launches == before + 2  # both strands
            monkeypatch.setattr(dp, "banded_edit_distance_text_plain", plain)
            want = on_cpu.align_arrays(reads, lens, traceback=traceback)
            for field in long_read.LongHits._fields:
                x, y = getattr(got, field), getattr(want, field)
                assert (x == y) if isinstance(x, dict) else np.array_equal(x, y), (kb, field)
            assert got.mapped.mean() > 0.9


@pytest.mark.parametrize("flat", [False, True])
@pytest.mark.parametrize("tight", [False, True])
def test_multipart_stream_on_card_equals_cpu(cuda, tmp_path, monkeypatch, flat, tight):
    """align_stream_multipart on the card against the CPU port: two parts
    written by build_multipart (with reversed-text indexes), npz or flat; a
    tail batch; with budgets cut to 1 hit a piece, the staircase rescue."""
    from genome_weaver_align_tpu_torch.index import multipart_io as mp

    if tight:
        monkeypatch.setattr(mp, "_part_budgets", lambda n, j, k: (1, 3, 1))
        monkeypatch.setattr(pipeline.SuffixFilterAligner, "FB_MULT", 1)
    rng = np.random.default_rng(6)
    contigs = [Contig(f"c{i}", rng.integers(0, 4, size=40_000, dtype=np.uint8)) for i in range(3)]
    unit = rng.integers(0, 4, size=60, dtype=np.uint8)
    for c in contigs:  # a shared unit: ties across parts
        c.codes[1000:1060] = unit
    mi = mp.build_multipart(tmp_path, contigs, part_limit=80_000, seed_j=8, flat=flat)
    assert mi.n_parts == 2
    whole = np.concatenate([c.codes for c in contigs])
    starts = np.concatenate([rng.integers(0, whole.size - 100, size=2990),
                             [1000 - 20, 41_000 - 20, 81_000 - 20]])
    reads = whole[starts[:, None] + np.arange(100)].astype(np.int8)
    rows = np.arange(reads.shape[0])
    for _ in range(2):
        at = rng.integers(0, 100, size=rows.size)
        reads[rows, at] = (reads[rows, at] + 1) % 4
    rc = rng.random(rows.size) < 0.5
    reads[rc] = (3 - reads[rc])[:, ::-1]
    lrow = np.full(1024, 100, np.int32)
    st_card, st_cpu = {}, {}
    before = dp_cuda.banded_edit_distance_text_cuda.launches
    got = mp.align_stream_multipart(mi, reads, lrow, 1024, stats=st_card, device=cuda)
    assert dp_cuda.banded_edit_distance_text_cuda.launches > before
    want = mp.align_stream_multipart(mi, reads, lrow, 1024, stats=st_cpu, device="cpu")
    for g, w in zip(got[:4], want[:4]):
        assert np.array_equal(g, w)
    assert got[3].mean() > 0.99
    assert len(st_card["peak_mem_bytes"]) == 2 and all(b > 0 for b in st_card["peak_mem_bytes"])
    assert st_card["rescued"] == st_cpu["rescued"] and (st_card["rescued"] > 0) == tight


def test_two_ranks_on_the_card_write_the_one_rank_sam(cuda, tmp_path):
    """``ShardedAligner`` in 2 gloo processes sharing the card against 1
    (``tests/torch_multihost_driver.py``, sharded mode): the same SAM bytes,
    and the banded DP's windows entry launched in every rank."""
    import re

    # the test's own directory is on sys.path under pytest's default import
    # mode; a top-level "tests" package elsewhere may shadow this one
    from torch_multihost_driver import launch

    texts = {n: launch(n, tmp_path / f"{n}.sam", "sharded", "--device", "cuda", timeout=600)
             for n in (1, 2)}
    a, b = ((tmp_path / f"{n}.sam").read_bytes() for n in (1, 2))
    assert b"long0" in a and b"short0" in a and a == b
    for text in texts[1] + texts[2]:
        assert int(re.search(r"windows-entry launches (\d+)", text).group(1)) > 0


def test_device_suffix_array_on_card_equals_native(cuda):
    from genome_weaver_align_tpu_torch.index import device_build, native
    from genome_weaver_align_tpu_torch.index.device_build import suffix_array_device
    from genome_weaver_align_tpu_torch.index.sais import suffix_array_naive

    if not native.available():
        pytest.skip("the native SA-IS library did not build")
    rng = np.random.default_rng(17)
    unit = rng.integers(0, 4, size=300, dtype=np.uint8)
    for codes in (rng.integers(0, 4, size=200_000, dtype=np.uint8),
                  np.concatenate([np.tile(unit, 40), rng.integers(0, 4, 5000, np.uint8)])):
        with mock.patch.object(device_build, "_doubling_round",
                               wraps=device_build._doubling_round) as rounds:
            got = suffix_array_device(codes, device=cuda)
        assert np.array_equal(got, native.suffix_array_native(codes))
        assert rounds.call_count >= 4
    for t in ([], [1, 1], [2, 0, 2], [3, 3, 3, 3]):
        codes = np.array(t, np.uint8)
        assert np.array_equal(suffix_array_device(codes, device=cuda), suffix_array_naive(codes))


def test_wavelet_rank_and_search_on_card_equal_cpu(cuda):
    from genome_weaver_align_tpu_torch.index import wavelet
    from genome_weaver_align_tpu_torch.models import exact

    rng = np.random.default_rng(23)
    codes = rng.integers(0, 4, size=50_000, dtype=np.uint8)
    fm = build_fm_index(codes, sample_rate=8)
    w = wavelet.WaveletRank(packing.unpack(fm.bwt_words, fm.n))
    ks = torch.from_numpy(rng.integers(0, fm.n + 1, size=4096))
    cs = torch.from_numpy(rng.integers(0, 4, size=4096))
    B, L = 2048, 36
    starts = rng.integers(0, codes.size - L, size=B)
    reads = torch.from_numpy(codes[starts[:, None] + np.arange(L)].astype(np.int32))
    reads[::5, 7] = (reads[::5, 7] + 1) % 4
    lengths = torch.full((B,), L, dtype=torch.int32)
    lengths[::9] = L - 11
    C = torch.from_numpy(fm.C.astype(np.int32))
    out = {}
    for dev in (cuda, torch.device("cpu")):
        dw = wavelet.to_device(w, device=dev)
        occ = wavelet.device_rank(dw, cs.to(dev), ks.to(dev))
        lo, hi = wavelet.exact_search_wavelet(dw, C.to(dev), fm.primary, reads.to(dev),
                                              lengths.to(dev))
        out[dev.type] = [occ.cpu(), lo.cpu(), hi.cpu()]
        if dev.type == "cuda":
            flo, fhi = exact.exact_interval_search(rank.from_host(fm, dev), reads.to(dev),
                                                   lengths.to(dev))
            assert torch.equal(lo, flo) and torch.equal(hi, fhi)
    assert all(torch.equal(a, b) for a, b in zip(out["cuda"], out["cpu"]))
    assert int((out["cpu"][2] > out["cpu"][1]).sum()) > B // 2


# ---------------------------------------------------------------- FM search kernels

def _fm_genome(seed: int, alphabet: int = 4):
    """The edge-case genome of ``tests/torch_fm_models.py``, both strands'
    tables and a 4-mer table, on the CPU."""
    from genome_weaver_align_tpu_torch.index.kmer import build_kmer_table
    from genome_weaver_align_tpu_torch.models import bidirectional as bd

    codes = fm_models.genome_codes(seed, alphabet)
    fwd = build_fm_index(codes, sample_rate=16)
    rev = build_fm_index(codes[::-1].copy(), sample_rate=16)
    tab = tuple(torch.from_numpy(a.astype(np.int32)) for a in build_kmer_table(fwd, 4))
    return codes, fwd, rev, bd, tab


def _fm_reads(codes, seed, dying=False, **kw):
    """``torch_fm_models.edge_reads`` (or ``dying_reads``) as CPU tensors,
    300 reads of up to 60 bp unless ``kw`` says otherwise."""
    kw = dict(dict(B=300, L=60), **kw)
    make = fm_models.dying_reads if dying else fm_models.edge_reads
    reads, lengths = make(codes, seed, **kw)
    return torch.from_numpy(reads), torch.from_numpy(lengths)


@pytest.mark.parametrize("P", [1, 3])
@pytest.mark.parametrize("kmer", ["none", "table", "full_cover"])
@pytest.mark.parametrize("max_len", [None, 9])
def test_backward_search_kernel_equals_plain(cuda, P, kmer, max_len):
    """``exact_interval_search`` (P = 1) and ``piece_interval_search``
    (P = 3) on the card launch the kernel once and equal their plain loops
    on the card on every lane."""
    from genome_weaver_align_tpu_torch.models import exact

    codes, fwd, _, _, tab = _fm_genome(30)
    fm = rank.from_host(fwd, cuda)
    r, ln = _fm_reads(codes, 31 + P)
    if kmer == "full_cover":
        ln = ln.clamp(min=12)
    tab = None if kmer == "none" else tuple(t.to(cuda) for t in tab)
    kj = 0 if tab is None else 4
    r, ln = r.to(cuda), ln.to(cuda)
    before = fm_search_cuda.backward_search_cuda.launches
    if P == 1:
        got = exact.exact_interval_search(fm, r, ln, max_len, tab, kj)
        want = exact.exact_interval_search_plain(fm, r, ln, max_len, tab, kj)
    else:
        got = suffix_filter.piece_interval_search(fm, r, ln, P, max_len, tab, kj,
                                                  kmer == "full_cover")
        want = suffix_filter.piece_interval_search_plain(fm, r, ln, P, max_len, tab, kj,
                                                         kmer == "full_cover")
    assert fm_search_cuda.backward_search_cuda.launches == before + 1
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert int((want[1] > want[0]).sum()) > 0


STAIRCASE_CARD_CASES = [
    dict(k=2), dict(k=1), dict(k=2, n_slots=1), dict(k=2, n_slots=64), dict(k=2, keep=1),
    dict(k=3, narrow_left=True), dict(k=2, n_slots=64, narrow_left=True),
    dict(k=2, n_slots=2, narrow_left=True, keep=3), dict(k=2, max_len=20),
    dict(k=2, n_slots=65), dict(k=3, n_slots=128, narrow_left=True),
]


@pytest.mark.parametrize("kw", STAIRCASE_CARD_CASES,
                         ids=lambda kw: "-".join(f"{k}{v}" for k, v in kw.items()))
def test_staircase_kernel_equals_plain(cuda, kw):
    """The staircase pools (lo, hi, overflow, every slot) and the
    candidates after the tail, kernel against the plain loop on the card."""
    from genome_weaver_align_tpu_torch.models import staircase

    codes, fwd, rev, bd, _ = _fm_genome(40)
    bi = bd.from_host_bi(fwd, rev, cuda)
    r, ln = (t.to(cuda) for t in _fm_reads(codes, 41))
    kw = dict(kw)
    k = kw.pop("k")
    before = staircase_cuda.staircase_pools_cuda.launches
    got = staircase.staircase_pools(bi, r, ln, k, **kw)
    assert staircase_cuda.staircase_pools_cuda.launches == before + 1
    want = staircase.staircase_pools_plain(bi, r, ln, k, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert int((want[1] > want[0]).sum()) > 0
    cands = staircase.staircase_filter_candidates(bi, r, ln, k, **kw)
    with mock.patch.object(staircase, "staircase_pools", staircase.staircase_pools_plain):
        plain = staircase.staircase_filter_candidates(bi, r, ln, k, **kw)
    assert all(torch.equal(a, b) for a, b in zip(cands, plain))


@pytest.mark.parametrize("n_slots", [1, 4, 48, 64, 65, 128])
@pytest.mark.parametrize("max_len", [None, 7])
def test_one_mismatch_kernel_equals_plain(cuda, n_slots, max_len):
    """cand_lo, cand_hi (dead slots' stale intervals included) and
    overflow, kernel against the plain loop on the card."""
    from genome_weaver_align_tpu_torch.models import one_mismatch

    codes, fwd, rev, bd, _ = _fm_genome(50)
    bi = bd.from_host_bi(fwd, rev, cuda)
    r, ln = (t.to(cuda) for t in _fm_reads(codes, 51, subs=1))
    before = one_mismatch_cuda.one_mismatch_candidates_cuda.launches
    got = one_mismatch.one_mismatch_candidates(bi, r, ln, max_len, n_slots)
    assert one_mismatch_cuda.one_mismatch_candidates_cuda.launches == before + 1
    want = one_mismatch.one_mismatch_candidates_plain(bi, r, ln, max_len, n_slots)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert int((want[1] > want[0]).sum()) > 0


def test_fm_kernels_where_every_spine_dies_at_once(cuda):
    """A genome without code 3 and reads whose pieces and halves end in 3:
    all three kernels equal their plain loops; also B = 0."""
    from genome_weaver_align_tpu_torch.models import exact, one_mismatch, staircase

    codes, fwd, rev, bd, _ = _fm_genome(60, alphabet=3)
    bi = bd.from_host_bi(fwd, rev, cuda)
    r, ln = (t.to(cuda) for t in _fm_reads(codes, 61, dying=True))
    for a, b in ((staircase.staircase_pools(bi, r, ln, 2),
                  staircase.staircase_pools_plain(bi, r, ln, 2)),
                 (staircase.staircase_pools(bi, r, ln, 2, narrow_left=True),
                  staircase.staircase_pools_plain(bi, r, ln, 2, narrow_left=True)),
                 (one_mismatch.one_mismatch_candidates(bi, r, ln),
                  one_mismatch.one_mismatch_candidates_plain(bi, r, ln)),
                 (suffix_filter.piece_interval_search(bi.fwd, r, ln, 3),
                  suffix_filter.piece_interval_search_plain(bi.fwd, r, ln, 3)),
                 (exact.exact_interval_search(bi.fwd, r[:0], ln[:0]),
                  exact.exact_interval_search_plain(bi.fwd, r[:0], ln[:0]))):
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(a, b))


def _lanes(binding, lanes):
    """Launch the binding's kernel with ``lanes`` lanes a group (a pool, or
    a read's case) whatever the shape; None keeps the binding's choice."""
    if lanes is None:
        return contextlib.nullcontext()
    return mock.patch.object(binding, "lanes_for", lambda *shape: lanes)


def _fm_bi(cuda, codes):
    from genome_weaver_align_tpu_torch.models import bidirectional as bd

    fwd = build_fm_index(codes, sample_rate=16)
    rev = build_fm_index(codes[::-1].copy(), sample_rate=16)
    return bd.from_host_bi(fwd, rev, cuda)


@pytest.mark.parametrize("n_slots, narrow, lanes", [
    (n_slots, narrow, lanes) for n_slots in (1, 8, 16, 17, 32, 33, 64) for narrow in (False, True)
    for lanes in ((32,) if narrow else (1, 2, 4, 8, 32))] + [
    (n_slots, narrow, None) for n_slots in (65, 96, 128, 256, 1024) for narrow in (False, True)]
    + [(n_slots, False, lanes) for n_slots in (128, 1024) for lanes in (1, 4)])
def test_staircase_kernel_at_slot_counts_and_group_sizes(cuda, n_slots, narrow, lanes):
    """301 reads (903 pools: no multiple of the pools a block holds at any
    group size) on the repeat genome, every field against the plain loop; a
    narrowing pool at a whole warp, the only size its kernel takes."""
    from genome_weaver_align_tpu_torch.models import staircase

    codes = fm_models.genome_codes(40)
    bi = _fm_bi(cuda, codes)
    r, ln = (t.to(cuda) for t in _fm_reads(codes, 42, B=301))
    with _lanes(staircase_cuda, lanes):
        got = staircase.staircase_pools(bi, r, ln, 2, n_slots=n_slots, narrow_left=narrow)
    want = staircase.staircase_pools_plain(bi, r, ln, 2, n_slots=n_slots, narrow_left=narrow)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert int((want[1] > want[0]).sum()) > 0


@pytest.mark.parametrize("lanes", [None, 1, 2, 4, 8, 16, 32])
def test_fm_kernels_where_pools_of_one_warp_die_at_different_steps(cuda, lanes):
    """Dying reads (every spine empty after one step) interleaved with
    reads that live on, 301 of them, on the genome without code 3: the
    groups of one warp leave their phases at different steps."""
    from genome_weaver_align_tpu_torch.models import one_mismatch, staircase

    codes = fm_models.genome_codes(60, alphabet=3)
    bi = _fm_bi(cuda, codes)
    live_r, live_ln = _fm_reads(codes, 62, B=301)
    dying_r, dying_ln = _fm_reads(codes, 63, dying=True, B=301)
    pick = torch.arange(301) % 2 == 0
    r = torch.where(pick[:, None], dying_r, live_r).to(cuda)
    ln = torch.where(pick, dying_ln, live_ln).to(cuda)
    for kw in (dict(), dict(narrow_left=True, n_slots=33)):  # narrowing: a warp a pool
        with _lanes(staircase_cuda, None if kw.get("narrow_left") else lanes):
            got = staircase.staircase_pools(bi, r, ln, 2, **kw)
        want = staircase.staircase_pools_plain(bi, r, ln, 2, **kw)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    with _lanes(one_mismatch_cuda, lanes):
        got = one_mismatch.one_mismatch_candidates(bi, r, ln)
    want = one_mismatch.one_mismatch_candidates_plain(bi, r, ln)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("lanes", [None, 1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("n_slots", [48, 9, 64, 65, 128, 1024])
def test_one_mismatch_kernel_with_many_dead_chains(cuda, lanes, n_slots):
    """A 7 bp repeat: spawned branches die at different places, so a
    read's dead slots hold several distinct lo values (five or more in some
    step: checked on the CPU); 301 reads, every field against the plain
    loop."""
    from genome_weaver_align_tpu_torch.models import one_mismatch

    codes = fm_models.chains_genome(94)
    bi = _fm_bi(cuda, codes)
    reads, lengths = fm_models.chain_reads(codes, 95, B=301)
    r, ln = torch.from_numpy(reads).to(cuda), torch.from_numpy(lengths).to(cuda)
    with _lanes(one_mismatch_cuda, lanes):
        got = one_mismatch.one_mismatch_candidates(bi, r, ln, None, n_slots)
    want = one_mismatch.one_mismatch_candidates_plain(bi, r, ln, None, n_slots)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert int((want[1] > want[0]).sum()) > 0


def test_fm_kernels_with_pools_in_global_scratch(cuda):
    """Pools past a block's shared memory at a warp a pool (8,192
    staircase slots, both orders; 16,384 one-mismatch slots): global
    scratch; and 1,024 one-mismatch slots asked at 1 lane a case (the
    entry doubles the lanes until a warp's groups fit): every field
    against the plain loop."""
    from genome_weaver_align_tpu_torch.models import one_mismatch, staircase

    codes = fm_models.genome_codes(40)
    bi = _fm_bi(cuda, codes)
    r, ln = (t.to(cuda) for t in _fm_reads(codes, 43, B=31))
    for narrow in (False, True):
        assert staircase_cuda._library().gwa_staircase_scratch_ints(32, 8192, 93) > 0
        got = staircase.staircase_pools(bi, r, ln, 2, n_slots=8192, narrow_left=narrow)
        want = staircase.staircase_pools_plain(bi, r, ln, 2, n_slots=8192, narrow_left=narrow)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, want)), narrow
    for n_slots, lanes in ((16_384, None), (1024, 1)):
        with _lanes(one_mismatch_cuda, lanes):
            got = one_mismatch.one_mismatch_candidates(bi, r, ln, None, n_slots)
        want = one_mismatch.one_mismatch_candidates_plain(bi, r, ln, None, n_slots)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, want)), n_slots


@pytest.mark.parametrize("lanes", [1, 2, 4, 8, 16])
def test_staircase_kernel_refuses_narrowing_below_a_warp(cuda, lanes):
    """Rank-major placement sees a step's parents in one pass: the kernel
    takes a narrowing pool only as a whole warp, and its binding picks
    that."""
    from genome_weaver_align_tpu_torch.models import staircase

    codes = fm_models.genome_codes(40)
    bi = _fm_bi(cuda, codes)
    r, ln = (t.to(cuda) for t in _fm_reads(codes, 42, B=31))
    assert staircase_cuda.lanes_for(3 * 31, 64, True, cuda) == 32
    with _lanes(staircase_cuda, lanes), pytest.raises(RuntimeError, match="launch failed"):
        staircase.staircase_pools(bi, r, ln, 2, narrow_left=True)


def test_fm_kernels_reject_what_they_cannot_take(cuda):
    codes, fwd, rev, bd, _ = _fm_genome(70)
    bi = bd.from_host_bi(fwd, rev, cuda)
    r = torch.zeros((4, 20), dtype=torch.int32, device=cuda)
    ln = torch.full((4,), 20, dtype=torch.int32, device=cuda)
    cpu_fm = rank.from_host(fwd, "cpu")
    with pytest.raises(ValueError, match="device"):
        fm_search_cuda.backward_search_cuda(cpu_fm, r, ln, 1, 5)
    shifted = torch.empty(bi.fwd.blocks.numel() + 1, dtype=torch.int32, device=cuda)[1:]
    shifted = shifted.view(bi.fwd.blocks.shape)
    with pytest.raises(ValueError, match="aligned"):
        fm_search_cuda.backward_search_cuda(
            rank.DeviceFMIndex(shifted, *[getattr(bi.fwd, f) for f in
                                          ("C", "primary", "mark_blocks", "mark_cp",
                                           "ssa_values", "n", "sample_rate")]), r, ln, 1, 5)
    with pytest.raises(ValueError, match="n_slots=0"):
        staircase_cuda.staircase_pools_cuda(bi, r, ln, 2, 0, 8, 7, 14, 14, False)
    with pytest.raises(ValueError, match="n_slots=0"):
        one_mismatch_cuda.one_mismatch_candidates_cuda(bi, r, ln, 5, 0)
    with pytest.raises(ValueError, match="contiguous"):
        one_mismatch_cuda.one_mismatch_candidates_cuda(bi, r.t().contiguous().t(), ln, 5, 48)
    with pytest.raises(ValueError, match="int32"):
        one_mismatch_cuda.one_mismatch_candidates_cuda(bi, r.long(), ln, 5, 48)


# ---------------------------------------------------------------- locate and the sharded search

def _locate_genome(rate):
    """The edge-case genome indexed at ``rate``, and every row 0..n of it
    with the edge rows once more at the front (0, where the staircase pins
    its dead lanes, the primary row, n, and n again as a row clamped from
    n + 1), on the CPU."""
    codes = fm_models.genome_codes(80)
    fwd = build_fm_index(codes, sample_rate=rate)
    edges = [0, fwd.primary, fwd.n, fwd.n]
    rows = np.concatenate([edges, np.random.default_rng(rate).permutation(fwd.n + 1)])
    return codes, fwd, torch.from_numpy(rows.astype(np.int32))


@pytest.mark.parametrize("rate", [8, 16])
def test_locate_kernel_equals_plain_on_every_row(cuda, rate):
    """``rank.locate`` on the card launches the kernel once and equals
    ``locate_plain`` on the card (and on the CPU) on every row, also as a
    (rows, hits) tensor; a full SA still takes one gather, no kernel."""
    from genome_weaver_align_tpu_torch.ops import locate_cuda

    _, fwd, rows = _locate_genome(rate)
    fm = rank.from_host(fwd, cuda)
    r = rows.to(cuda)
    before = locate_cuda.locate_cuda.launches
    got = rank.locate(fm, r)
    assert locate_cuda.locate_cuda.launches == before + 1
    want = rank.locate_plain(fm, r)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(), rank.locate_plain(rank.from_host(fwd, "cpu"), rows))
    grid = r[: 4 * 1000].reshape(1000, 4)
    assert torch.equal(rank.locate(fm, grid), want[: 4 * 1000].reshape(1000, 4))
    assert rank.locate(fm, r[:0]).shape == (0,)
    import dataclasses

    full = dataclasses.replace(fm, full_sa=want[4:][torch.argsort(r[4:])].contiguous())
    before = locate_cuda.locate_cuda.launches
    assert torch.equal(rank.locate(full, r), want)
    assert locate_cuda.locate_cuda.launches == before


@pytest.mark.parametrize("S", [*range(1, 17), 17, 32, 64, 128, 1024])
def test_sharded_locate_kernel_equals_plain_on_every_row(cuda, S):
    """The sharded ``locate`` on the card launches the kernel once and
    equals its plain loop (with the sum and the ring merges), and the
    single-index locate, on every row."""
    from genome_weaver_align_tpu_torch.ops import locate_cuda

    _, fwd, rows = _locate_genome(8 if S % 2 else 16)
    sh = sharded_index.put_sharded(sharded_index.shard_fm_index(fwd, S), cuda)
    r = rows.to(cuda)
    before = locate_cuda.locate_sharded_cuda.launches
    got = sharded_index.locate(sh, r)
    assert locate_cuda.locate_sharded_cuda.launches == before + 1
    want = sharded_index.locate_plain(sh, r)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got, rank.locate_plain(rank.from_host(fwd, cuda), r))
    ring_merged = sharded_index.locate_plain(sh, r[:512], sharded_index.ring_merge)
    assert torch.equal(ring_merged, want[:512])


def _tiled(rows, Q):
    """``rows`` repeated to Q rows (the edge rows first)."""
    return rows.repeat(-(-Q // rows.numel()))[:Q].contiguous()


@pytest.mark.parametrize("sharded", [False, True])
def test_locate_kernels_at_the_grid_capacity(cuda, sharded):
    """Row counts at the persistent grid's capacity (the walks it holds at
    once, as the binding reports it) - 1, + 0 and + 1, and twice it + 1:
    every row equals the plain locate."""
    from genome_weaver_align_tpu_torch.ops import locate_cuda

    _, fwd, rows = _locate_genome(8)
    fm = rank.from_host(fwd, cuda)
    sh = sharded_index.put_sharded(sharded_index.shard_fm_index(fwd, 4), cuda)
    grid, cap = locate_cuda.launch_shape(locate_cuda.MAX_ROWS, cuda, sharded)
    assert cap == grid * locate_cuda.THREADS
    for Q in (cap - 1, cap, cap + 1, 2 * cap + 1):
        r = _tiled(rows.to(cuda), Q)
        assert locate_cuda.launch_shape(Q, cuda, sharded)[0] == grid
        got = (locate_cuda.locate_sharded_cuda(sh, r) if sharded
               else locate_cuda.locate_cuda(fm, r))
        assert torch.equal(got, rank.locate_plain(fm, r)), Q


@pytest.mark.parametrize("sharded", [False, True])
def test_locate_kernels_on_rows_repeated_across_a_warp(cuda, sharded):
    """Each row 32 times in a row (one warp's lanes on one row, as [7]'s
    compaction pins its spare lanes), then each 7 times (runs across warp
    edges)."""
    from genome_weaver_align_tpu_torch.ops import locate_cuda

    _, fwd, rows = _locate_genome(16)
    fm = rank.from_host(fwd, cuda)
    sh = sharded_index.put_sharded(sharded_index.shard_fm_index(fwd, 3), cuda)
    r = rows[:2000].to(cuda)
    r = torch.cat([r.repeat_interleave(32), r.repeat_interleave(7)]).contiguous()
    got = locate_cuda.locate_sharded_cuda(sh, r) if sharded else locate_cuda.locate_cuda(fm, r)
    assert torch.equal(got, rank.locate_plain(fm, r))


# block cuts of the packed and the row coordinates (tests/test_torch_locate.py)
UNEQUAL = [([0, 3, 4, 16, 30], [0, 9, 10, 11, 30]), ([0, 1, 30], [0, 20, 28]),
           ([0, 5, 5, 9, 12, 30], [0, 2, 2, 17, 18, 30]),
           (fm_models.unequal_cuts(32, 30, 5), fm_models.unequal_cuts(32, 30, 6))]


@pytest.mark.parametrize("cuts", UNEQUAL, ids=["S4", "S2", "S5-empty", "S32"])
def test_sharded_kernels_on_unequal_bounds(cuda, cuts):
    """Hand-made unequal shard bounds (the owner guess misses: each owner
    comes from the scan): the sharded locate, the sharded piece search and
    the fused table entry equal their plain versions and the one-index
    locate and search."""
    from genome_weaver_align_tpu_torch.ops import locate_cuda

    codes = fm_models.genome_codes(81, size=3_000)
    fwd = build_fm_index(codes, sample_rate=8)
    sh = sharded_index.put_sharded(sharded_index.shard_fm_index(fwd, len(cuts[0]) - 1, *cuts),
                                   cuda)
    fm = rank.from_host(fwd, cuda)
    rows = torch.arange(fwd.n + 1, dtype=torch.int32, device=cuda)
    before = locate_cuda.locate_sharded_cuda.launches
    got = sharded_index.locate(sh, rows)
    assert locate_cuda.locate_sharded_cuda.launches == before + 1
    assert torch.equal(got, sharded_index.locate_plain(sh, rows))
    assert torch.equal(got, rank.locate_plain(fm, rows))
    r, ln = (t.to(cuda) for t in _fm_reads(codes, 95))
    got = sharded_pipeline.sharded_piece_search(sh, r, ln, 3, r.shape[1])
    want = sharded_pipeline.sharded_piece_search_plain(sh, r, ln, 3, r.shape[1])
    one = suffix_filter.piece_interval_search_plain(fm, r, ln, 3)
    assert all(torch.equal(a, b) and torch.equal(a, c) for a, b, c in zip(got, want, one))
    gen = torch.Generator(device=cuda).manual_seed(96)
    k = torch.randint(0, fwd.n + 2, (4096,), generator=gen, device=cuda, dtype=torch.int32)
    c = torch.randint(0, 4, (4096,), generator=gen, device=cuda, dtype=torch.int32)
    assert torch.equal(sharded_index.fused_occ(sh, c, k), sharded_index.fused_occ_plain(sh, c, k))


def _own_allocations(sh):
    """``sh`` with each shard of each sharded table in an allocation of its
    own (``peer.Shards``), as shards mapped from other processes are."""
    import dataclasses

    from genome_weaver_align_tpu_torch.parallel import peer

    return dataclasses.replace(sh, **{
        f: peer.Shards([t.clone() for t in getattr(sh, f)], getattr(sh, f))
        for f in sharded_index._TABLES})


@pytest.mark.parametrize("S,cuts", [(S, None) for S in (*range(1, 17), 17, 32, 1024)] + [
    (len(c[0]) - 1, c) for c in UNEQUAL])
def test_sharded_kernels_on_shards_in_their_own_allocations(cuda, S, cuts):
    """The three sharded kernels (locate, piece search, fused table entry)
    with every shard in its own allocation (one base pointer a shard) equal
    the stacked tables' launch and the plain versions on every element."""
    codes = fm_models.genome_codes(84, size=3_000 if cuts else 20_000)
    fwd = build_fm_index(codes, sample_rate=8)
    stacked = sharded_index.put_sharded(
        sharded_index.shard_fm_index(fwd, S, *(cuts or ())), cuda)
    apart = _own_allocations(stacked)
    assert all(a.data_ptr() != b.data_ptr() for a, b in zip(apart.bwt_blocks, stacked.bwt_blocks))
    rows = torch.arange(fwd.n + 1, dtype=torch.int32, device=cuda)
    want = sharded_index.locate_plain(stacked, rows)
    assert torch.equal(sharded_index.locate(apart, rows), want)
    assert torch.equal(sharded_index.locate(stacked, rows), want)
    r, ln = (t.to(cuda) for t in _fm_reads(codes, 85))
    want = sharded_pipeline.sharded_piece_search_plain(stacked, r, ln, 3, r.shape[1])
    for sh in (apart, stacked):
        got = sharded_pipeline.sharded_piece_search(sh, r, ln, 3, r.shape[1])
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    gen = torch.Generator(device=cuda).manual_seed(86)
    k = torch.randint(0, fwd.n + 2, (8192,), generator=gen, device=cuda, dtype=torch.int32)
    c = torch.randint(0, 4, (8192,), generator=gen, device=cuda, dtype=torch.int32)
    want = sharded_index.fused_occ_plain(stacked, c, k)
    assert torch.equal(sharded_index.fused_occ(apart, c, k), want)
    assert torch.equal(sharded_index.fused_occ(stacked, c, k), want)
    assert torch.equal(sharded_index.fused_occ_plain(apart, c, k), want)


def test_ring_sum_over_separate_allocations_writes_one_output(cuda):
    """The sum kernel over S tensors in their own allocations (the ranks'
    mapped slots) with ``only``: shard d's sum, equal to the stacked sum's
    row d, float32 in its ring order."""
    gen = torch.Generator(device=cuda).manual_seed(87)
    for S in (1, 2, 3, 4, 8, 16, 17, 32):
        for dtype in (torch.int32, torch.float32):
            x = (torch.randint(-(1 << 30), 1 << 30, (S, 2, 777), generator=gen, device=cuda,
                               dtype=torch.int32) if dtype == torch.int32
                 else torch.randn((S, 2, 777), generator=gen, device=cuda) * 1e4)
            apart = [t.clone() for t in x]
            want = ring.ring_psum_plain(x)
            for d in range(S):
                assert torch.equal(ring.ring_psum(apart, only=d), want[d]), (S, dtype, d)
            assert torch.equal(ring_cuda.ring_allreduce_cuda(apart), want)


def test_two_processes_map_each_others_shards_on_the_card(cuda, tmp_path):
    """Two processes on the card, each holding 2 of 4 shards and mapping
    the other's through CUDA IPC: the sharded locate kernel on the mapped
    shards equals its plain loop on every row, each process reads the
    other's changes through its map, and the exact search under every merge
    and the SAM equal the same run on the CPU."""
    import json

    import torch_multihost_driver as drv

    for dev in ("cuda", "cpu"):
        drv.launch(2, tmp_path / f"{dev}.sam", "interval", "--n-interval", "4", "--device", dev,
                   timeout=300)
    assert (tmp_path / "cuda.sam").read_bytes() == (tmp_path / "cpu.sam").read_bytes()
    for pid in range(2):
        facts = json.loads((tmp_path / f"cuda.sam.{pid}.json").read_text())
        assert facts["locate_equal"] and facts["locate_launches"] == 1
        assert facts["seen"] == [True] * 4
        assert facts["ring"]["inbox"][0] == 2 and facts["ring"]["bad"] == 0, facts["ring"]
        assert all(here * 2 == stacked for here, stacked in facts["bytes"].values())
        got, want = (np.load(tmp_path / f"{d}.sam.{pid}.npz") for d in ("cuda", "cpu"))
        assert all(np.array_equal(got[key], want[key]) for key in want.files)


@pytest.mark.parametrize("S", [*range(1, 17), 17, 32, 64, 128, 1024])
@pytest.mark.parametrize("max_len", [None, 9])
def test_sharded_piece_search_kernel_equals_plain(cuda, S, max_len):
    """The sharded piece search on the card launches the kernel once and
    equals its plain loop on every lane (reads of length 0, 1, < P and
    ragged), and the single-index piece search."""
    codes = fm_models.genome_codes(82)
    fwd = build_fm_index(codes, sample_rate=16)
    sh = sharded_index.put_sharded(sharded_index.shard_fm_index(fwd, S), cuda)
    r, ln = (t.to(cuda) for t in _fm_reads(codes, 83))
    max_len = max_len or r.shape[1]
    before = fm_search_cuda.backward_search_sharded_cuda.launches
    got = sharded_pipeline.sharded_piece_search(sh, r, ln, 3, max_len)
    assert fm_search_cuda.backward_search_sharded_cuda.launches == before + 1
    want = sharded_pipeline.sharded_piece_search_plain(sh, r, ln, 3, max_len)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    one = suffix_filter.piece_interval_search_plain(
        rank.from_host(fwd, cuda), r, ln, 3,
        None if max_len == r.shape[1] else sharded_pipeline._piece_steps(max_len, 3))
    assert all(torch.equal(a, b) for a, b in zip(got, one[:2]))
    assert int((want[1] > want[0]).sum()) > 0


def test_locate_kernels_reject_what_they_cannot_take(cuda):
    import dataclasses

    from genome_weaver_align_tpu_torch.ops import locate_cuda

    _, fwd, rows = _locate_genome(8)
    fm = rank.from_host(fwd, cuda)
    r = rows.to(cuda)
    with pytest.raises(ValueError, match="device"):
        locate_cuda.locate_cuda(rank.from_host(fwd, "cpu"), r)
    with pytest.raises(ValueError, match="int32"):
        locate_cuda.locate_cuda(fm, r.long())
    shifted = torch.empty(fm.mark_blocks.numel() + 1, dtype=torch.int32, device=cuda)[1:]
    with pytest.raises(ValueError, match="aligned"):
        locate_cuda.locate_cuda(
            dataclasses.replace(fm, mark_blocks=shifted.view(fm.mark_blocks.shape)), r)
    sh17 = sharded_index.put_sharded(sharded_index.shard_fm_index(fwd, 17), cuda)
    assert torch.equal(locate_cuda.locate_sharded_cuda(sh17, r), rank.locate_plain(fm, r))
    reads = torch.zeros((4, 20), dtype=torch.int32, device=cuda)
    lens = torch.full((4,), 20, dtype=torch.int32, device=cuda)
    got = sharded_pipeline.sharded_piece_search(sh17, reads, lens, 3, 8)
    want = sharded_pipeline.sharded_piece_search_plain(sh17, reads, lens, 3, 8)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    sh = sharded_index.put_sharded(sharded_index.shard_fm_index(fwd, 4), "cpu")
    with pytest.raises(ValueError, match="device"):
        locate_cuda.locate_sharded_cuda(sh, r)
    with pytest.raises(ValueError, match="device"):
        fm_search_cuda.backward_search_sharded_cuda(sh, reads, lens, 3, 8)
    shc = sharded_index.put_sharded(sharded_index.shard_fm_index(fwd, 4), cuda)
    for Q in (-1, locate_cuda.MAX_ROWS + 1):
        with pytest.raises(ValueError, match="0 to 2"):
            locate_cuda.launch_shape(Q, cuda, True)
    shifted = torch.empty(shc.occ_cp.numel() + 1, dtype=torch.int32, device=cuda)[1:]
    with pytest.raises(ValueError, match="aligned"):
        sharded_index.fused_occ(dataclasses.replace(shc, occ_cp=shifted.view(shc.occ_cp.shape)),
                                r[:8] & 3, r[:8])
    assert locate_cuda.locate_cuda(fm, r[:0]).shape == (0,)
    assert locate_cuda.locate_sharded_cuda(shc, r[:0]).shape == (0,)


def _cards(n: int) -> list:
    """The first n cards; skips with fewer."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA devices")
    return [torch.device("cuda", d) for d in range(n)]


def test_two_ranks_on_two_cards_map_each_others_shards(tmp_path):
    """Two processes, one a card, each holding 2 of 4 shards and mapping the
    other's over NVLink: the sharded locate, piece search, fused table
    entry and the torch gather of rows on the mapped shards equal their
    plain versions, the psum goes over NCCL and the ring merge through the
    flag wait with no host barrier, and the exact search and the SAM equal
    the CPU run's."""
    import json

    import torch_multihost_driver as drv

    _cards(2)
    for dev in ("cuda", "cpu"):
        drv.launch(2, tmp_path / f"{dev}.sam", "interval", "--n-interval", "4", "--device", dev,
                   timeout=300)
    assert (tmp_path / "cuda.sam").read_bytes() == (tmp_path / "cpu.sam").read_bytes()
    for pid in range(2):
        facts = json.loads((tmp_path / f"cuda.sam.{pid}.json").read_text())
        assert facts["card"] == pid and facts["cards"] == [0, 0, 1, 1]
        assert all(facts[f"{k}_equal"] for k in ("locate", "pieces", "fused", "gather"))
        routes = facts["routes"]
        assert routes["psum nccl"] > 0 and routes["psum gloo"] == 0, routes
        assert routes["ring flag wait"] > 0 and routes["ring host barrier"] == 0, routes
        assert facts["ring"]["inbox"][0] == 2 and facts["ring"]["bad"] == 0, facts["ring"]
        assert facts["seen"] == [True] * 4
        got, want = (np.load(tmp_path / f"{d}.sam.{pid}.npz") for d in ("cuda", "cpu"))
        assert all(np.array_equal(got[key], want[key]) for key in want.files)


def test_two_hosts_on_two_cards_merge_by_collectives(tmp_path):
    """Two processes, one a card, declared on two hosts (``GROUP_RANK`` 0 and
    1): the collective route.  Nothing is mapped (``peer.share`` raises in
    them), each holds its own 2 of 4 shards, the psums and the verify's
    gathers go over NCCL, every process launches the fused table entry and
    the banded DP's text entry (never its windows entry), and the seed-path
    and FM-path SAMs and the exact search equal the CPU run's (which the
    CPU tests hold against one process and the JAX package)."""
    import json

    import torch_multihost_driver as drv

    _cards(2)
    for dev in ("cuda", "cpu"):
        drv.launch(2, tmp_path / f"{dev}.sam", "interval", "--n-interval", "4", "--device", dev,
                   timeout=300, nodes=[0, 1])
    for tail in ("", ".fm.sam"):
        assert (tmp_path / f"cuda.sam{tail}").read_bytes() == \
            (tmp_path / f"cpu.sam{tail}").read_bytes()
    for pid in range(2):
        facts = json.loads((tmp_path / f"cuda.sam.{pid}.json").read_text())
        assert facts["collective"] and facts["held"] == [2 * pid, 2 * pid + 1]
        assert all(facts["plain"].values()) and not facts["text_shards"]
        for routes in (facts["routes"], facts["aligner_routes"]):
            assert routes["psum nccl"] > 0 and routes["psum gloo"] == 0, routes
        assert facts["aligner_routes"]["all_gather nccl"] > 0, facts["aligner_routes"]
        assert facts["aligner_routes"]["all_gather gloo"] == 0, facts["aligner_routes"]
        n = facts["launches"]
        assert n["text entry"] > 0 and n["fused table entry"] > 0 and n["windows entry"] == 0, n
        got, want = (np.load(tmp_path / f"{d}.sam.{pid}.npz") for d in ("cuda", "cpu"))
        assert all(np.array_equal(got[key], want[key]) for key in want.files)


@pytest.mark.parametrize("N", [2, 4])
def test_flag_wait_ring_equals_plain_across_cards(tmp_path, N):
    """N processes, one a card, each inbox and flag word mapped by the
    others (CUDA IPC opened on each process's card): the flag-wait sum
    equals the plain ring sum of the processes' partials on every element,
    int32 and float32, merge after merge, and every process's row arrives
    in every inbox.  Then process 0 times out at an epoch no peer has
    reached and runs two more merges; every peer, arriving after that,
    fails at once on the poison, every flag word a peer holds of a failed
    process is poisoned, and every process raises."""
    import json

    import torch_multihost_driver as drv

    _cards(N)
    drv.launch(N, tmp_path / "fw", "flagwait", timeout=300)
    for pid in range(N):
        facts = json.loads((tmp_path / f"fw.{pid}.json").read_text())
        assert facts["card"] == pid and facts["cards"] == list(range(N))
        assert facts["equal"] == [True] * 4 and facts["pushed"] == [True] * 4
        assert facts["launches"] == 4
        assert facts["error"] == 0
        assert facts["raised"], facts
        assert facts["poisoned"] == [q != pid for q in range(N)], facts
        assert facts["failure_s"] < 10, facts


def test_flag_wait_times_out_and_raises(cuda):
    """Two ranks' inboxes and flag words on one card, launched from this
    process: rank 0 waits for an epoch rank 1 never publishes, gives up
    after the timeout, sets its error word and poisons every word it holds
    in rank 1's flags; its later merges do not wait and publish the
    poison, never their epochs.  Rank 1, arriving late at that epoch,
    fails at once.  ``check_flag_wait`` raises for both."""
    import time

    W = ring_cuda.WAIT_BLOCKS
    flags = [torch.zeros((2, W), dtype=torch.int32, device=cuda) for _ in range(2)]
    errors = [torch.zeros(1, dtype=torch.int32, device=cuda) for _ in range(2)]
    inboxes = [torch.ones((2, 1024), dtype=torch.int32, device=cuda) for _ in range(2)]
    t0 = time.perf_counter()
    ring_cuda.ring_allreduce_wait_cuda(inboxes, flags, 0, 1, errors[0], timeout_s=0.05)
    with pytest.raises(RuntimeError, match="flag wait"):
        ring_cuda.check_flag_wait(errors[0])
    assert 0.05 <= time.perf_counter() - t0 < 10
    assert bool((flags[1][0] == ring_cuda.POISON).all())
    t0 = time.perf_counter()
    for epoch in (2, 3):
        ring_cuda.ring_allreduce_wait_cuda(inboxes, flags, 0, epoch, errors[0], timeout_s=5.0)
    torch.cuda.synchronize(cuda)
    assert time.perf_counter() - t0 < 1.0  # the error word set: no wait
    assert bool((flags[1][0] == ring_cuda.POISON).all())  # the poison, never a later epoch
    t0 = time.perf_counter()
    out = ring_cuda.ring_allreduce_wait_cuda(inboxes, flags, 1, 1, errors[1], timeout_s=5.0)
    torch.cuda.synchronize(cuda)
    assert time.perf_counter() - t0 < 1.0  # failed on the poison, not on the timeout
    assert out.shape == (1024,)
    with pytest.raises(RuntimeError, match="flag wait"):
        ring_cuda.check_flag_wait(errors[1])
    assert bool((flags[0][1] == ring_cuda.POISON).all())
    with pytest.raises(ValueError, match="epoch"):
        ring_cuda.ring_allreduce_wait_cuda(inboxes, flags, 0, ring_cuda.POISON, errors[0])


def _load_publisher(side) -> None:
    """Run the emulated peer's kernels (a device sleep, a one-word fill at
    every alignment: torch picks the fill kernel by the address) once on
    ``side`` before any wait: CUDA loads a kernel lazily at its first
    launch, and a load while a kernel spins on the card waits for that
    kernel."""
    with torch.cuda.stream(side):
        torch.cuda._sleep(1)
        words = torch.zeros(8, dtype=torch.int32, device=side.device)
        for i in range(4):
            words[i].fill_(1)
    side.synchronize()


def _block_of(n: int, G: int, device) -> torch.Tensor:
    """The block of a flag-wait grid of G blocks that sums each of n
    elements: item i (a 16-byte vector where n % 4 == 0, else an element)
    goes to block (i // 256) % G."""
    e = torch.arange(n, device=device)
    return ((e // 4 if n % 4 == 0 else e) // 256) % G


@pytest.mark.parametrize("dtype, n", [(torch.int32, 65_536), (torch.float32, 65_536),
                                      (torch.int32, 262_148), (torch.float32, 4_099)])
def test_flag_wait_blocks_wait_for_their_own_flags(cuda, dtype, n):
    """One card, rank 0 of 2 with its peer emulated: the peer's row lies in
    rank 0's inbox before the launch, and while the kernel waits a second
    stream publishes the peer's flag words one block at a time, in reverse
    order.  Every block's chunk equals the plain ring sum, rank 0's row
    lands in the peer's inbox and its epoch in each of the grid's words.
    Then with one block's word never published, that block times out,
    sets the error word and poisons every word rank 0 holds in the peer's
    flags, while every other block's chunk is still the plain sum."""
    W = ring_cuda.WAIT_BLOCKS
    G = ring_cuda.wait_blocks(n)
    items = n // 4 if n % 4 == 0 else n
    assert G == min(-(-items // 256), W)
    gen = torch.Generator(device=cuda).manual_seed(n)
    x = (torch.randint(-(1 << 30), 1 << 30, (2, n), generator=gen, device=cuda,
                       dtype=torch.int32) if dtype == torch.int32
         else torch.randn((2, n), generator=gen, device=cuda) * 1e4)
    want = ring.ring_psum_plain(x)[0]
    block = _block_of(n, G, cuda)
    main, side = torch.cuda.Stream(cuda), torch.cuda.Stream(cuda)
    _load_publisher(side)
    for never in (None, G // 2):
        mine = x.clone()  # rank 0's inbox: its row, and the peer's row already pushed
        theirs = torch.zeros_like(x)
        flags = [torch.zeros((2, W), dtype=torch.int32, device=cuda) for _ in range(2)]
        error = torch.zeros(1, dtype=torch.int32, device=cuda)
        torch.cuda.synchronize(cuda)
        with torch.cuda.stream(main):
            wait = ring_cuda.FlagWait([[mine, theirs]], flags, 0, error,
                                      timeout_s=5.0 if never is None else 0.2)
            out = wait(0, 1)
        with torch.cuda.stream(side):
            for b in reversed(range(G)):
                torch.cuda._sleep(20_000)
                if b != never:
                    flags[0][1, b].fill_(1)
        torch.cuda.synchronize(cuda)
        ok = block != never if never is not None else torch.ones_like(block, dtype=torch.bool)
        assert torch.equal(out[ok], want[ok]), never
        assert torch.equal(theirs[0], x[0]), never
        if never is None:
            assert int(error) == 0 and bool((flags[1][0, :G] == 1).all())
        else:
            assert int(error) == 1 and bool((flags[1][0] == ring_cuda.POISON).all())
            with pytest.raises(RuntimeError, match="flag wait"):
                ring_cuda.check_flag_wait(error)


@pytest.mark.parametrize("R", [2, 4, 16, 17, 32])
def test_flag_wait_emulated_ranks_equal_plain(cuda, R):
    """One card, rank me of R with every peer emulated (the peers' rows
    already in rank me's inbox, their flag words already published): the
    merge equals the plain ring sum of the R rows, rank me's row lands in
    every peer's inbox and its epoch in each of the grid's words; past 16
    ranks through the device table."""
    W = ring_cuda.WAIT_BLOCKS
    n = 4_099 if R % 2 else 65_536
    G = ring_cuda.wait_blocks(n)
    gen = torch.Generator(device=cuda).manual_seed(R)
    for dtype in (torch.int32, torch.float32):
        x = (torch.randint(-(1 << 30), 1 << 30, (R, n), generator=gen, device=cuda,
                           dtype=torch.int32) if dtype == torch.int32
             else torch.randn((R, n), generator=gen, device=cuda) * 1e4)
        me = R // 2
        inboxes = [x.clone() if q == me else torch.zeros_like(x) for q in range(R)]
        flags = [torch.zeros((R, W), dtype=torch.int32, device=cuda) for _ in range(R)]
        flags[me][:, :G] = 3
        error = torch.zeros(1, dtype=torch.int32, device=cuda)
        before = ring_cuda.ring_allreduce_wait_cuda.launches
        out = ring_cuda.ring_allreduce_wait_cuda(inboxes, flags, me, 3, error, timeout_s=5.0)
        torch.cuda.synchronize(cuda)
        assert ring_cuda.ring_allreduce_wait_cuda.launches == before + 1
        assert int(error) == 0
        assert torch.equal(out, ring.ring_psum_plain(x)[me]), dtype
        for q in range(R):
            if q != me:
                assert torch.equal(inboxes[q][me], x[me]), q
                assert bool((flags[q][me, :G] == 3).all()), q


def test_wrappers_raise_on_a_shard_on_another_card():
    """A shard tensor that lies on another card (not mapped onto this one
    through ``parallel.peer``) is refused by every kernel wrapper that
    reads shards: no kernel reads another card's memory unmapped."""
    import dataclasses

    from genome_weaver_align_tpu_torch.ops import locate_cuda
    from genome_weaver_align_tpu_torch.parallel import peer

    devs = _cards(2)
    codes = fm_models.genome_codes(88, size=3_000)
    sh = sharded_index.put_sharded(sharded_index.shard_fm_index(build_fm_index(
        codes, sample_rate=8), 2), devs[0])
    far = dataclasses.replace(sh, **{
        f: peer.Shards([getattr(sh, f)[0].clone(), getattr(sh, f)[1].to(devs[1])],
                       getattr(sh, f)) for f in sharded_index._TABLES})
    rows = torch.arange(100, dtype=torch.int32, device=devs[0])
    reads = torch.zeros((4, 20), dtype=torch.int32, device=devs[0])
    lens = torch.full((4,), 20, dtype=torch.int32, device=devs[0])
    with pytest.raises(ValueError, match="device"):
        locate_cuda.locate_sharded_cuda(far, rows)
    with pytest.raises(ValueError, match="device"):
        fm_search_cuda.backward_search_sharded_cuda(far, reads, lens, 3, 8)
    with pytest.raises(ValueError, match="device"):
        ring_cuda.fused_occ_cuda(far.bwt_blocks, far.occ_cp, far.pk_start, far.pk_end,
                                 far.primary, rows & 3, rows)
    with pytest.raises(ValueError, match="device"):
        ring_cuda.ring_allreduce_cuda([rows, rows.to(devs[1])], only=0)
