"""Tests that need an NVIDIA GPU with nvcc (marker ``cuda``; they skip
without one).  On the card:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

They import no JAX: they hold each CUDA kernel entry (banded DP and Myers,
each from the packed text and from given windows; the shard sum; the fused
rank + shard sum from gathered rows and from the shard tables) against its
plain torch version, and the aligners and the sharded search on the card
against the same code on the CPU, which the CPU tests hold against the JAX
package."""

import numpy as np
import pytest
import torch

from genome_weaver_align_tpu_torch.utils.simulate import simulate_reads_array
from genome_weaver_align_tpu_torch.index.build import build_fm_index
from genome_weaver_align_tpu_torch.index.files import Genome, GenomeIndex
from genome_weaver_align_tpu_torch.index.seedtable import build_seed_table
from genome_weaver_align_tpu_torch.models import paired, pipeline, suffix_filter
from genome_weaver_align_tpu_torch.ops import dp, dp_cuda, myers, myers_cuda, rank, ring_cuda, window
from genome_weaver_align_tpu_torch.parallel import mesh as pmesh
from genome_weaver_align_tpu_torch.parallel import ring, sharded_index, sharded_pipeline
from genome_weaver_align_tpu_torch.utils import packing
from genome_weaver_align_tpu_torch.utils.fasta import Contig

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("k", range(1, dp_cuda.MAX_K + 1))
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
    r = torch.zeros((4, 10), dtype=torch.int8, device=cuda)
    w = torch.zeros((4, 16), dtype=torch.int8, device=cuda)
    ln = torch.full((4,), 10, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="k=15"):
        dp_cuda.banded_edit_distance_cuda(r, ln, w, dp_cuda.MAX_K + 1)
    with pytest.raises(ValueError, match="int8"):
        dp_cuda.banded_edit_distance_cuda(r.int(), ln, w, 2)
    with pytest.raises(ValueError, match="contiguous"):
        dp_cuda.banded_edit_distance_cuda(r.t().contiguous().t(), ln, w, 2)
    got = dp_cuda.banded_edit_distance_cuda(r[:0], ln[:0], w[:0], 2)
    assert got[0].shape == (0,)
    long_r = torch.zeros((4, 1816), dtype=torch.int8, device=cuda)  # 128 rows exceed the block
    with pytest.raises(ValueError, match="shared memory"):
        dp_cuda.banded_edit_distance_cuda(long_r, ln, torch.zeros((4, 1822), dtype=torch.int8,
                                                                  device=cuda), 2)
    words = torch.zeros(8, dtype=torch.int32, device=cuda)
    starts = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="k=0"):
        dp_cuda.banded_edit_distance_text_cuda(words, 100, starts, r, ln, starts, 0, 16)
    with pytest.raises(ValueError, match="int32"):
        dp_cuda.banded_edit_distance_text_cuda(words, 100, starts.long(), r, ln, starts, 2, 16)


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


@pytest.mark.parametrize("k", range(1, dp_cuda.MAX_K + 1))
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
    r = torch.zeros((4, 257), dtype=torch.int8, device=cuda)
    w = torch.zeros((4, 300), dtype=torch.int8, device=cuda)
    ln = torch.full((4,), 257, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="257"):
        myers_cuda.myers_semiglobal_cuda(r, ln, w)
    r, w, ln = r[:, :100].contiguous(), w[:, :120].contiguous(), ln.clone().fill_(100)
    with pytest.raises(ValueError, match="CUDA"):
        myers_cuda.myers_semiglobal_cuda(r.cpu(), ln.cpu(), w.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        myers_cuda.myers_semiglobal_cuda(r.t().contiguous().t(), ln, w)
    with pytest.raises(ValueError, match="int8 or int32"):
        myers_cuda.myers_semiglobal_cuda(r, ln, w.int())
    got = myers_cuda.myers_semiglobal_cuda(r[:0], ln[:0], w[:0])
    assert got[0].shape == (0,)
    words = torch.zeros(8, dtype=torch.int32, device=cuda)
    z = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="257"):
        myers_cuda.myers_semiglobal_text_cuda(words, 100, z, torch.zeros((4, 257), dtype=torch.int8,
                                              device=cuda), ln, z, z + 9, 300, 9)
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
                  myers_cuda.myers_semiglobal_cuda.launches)
        results.append(pa.align_pair_arrays(c1, lengths, c2, lengths))
        if device.type == "cuda":
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


def test_ring_rejects_what_it_cannot_take(cuda):
    for dtype in (torch.int64, torch.float16, torch.int8):
        with pytest.raises(TypeError, match="int32 or float32"):
            ring_cuda.ring_allreduce_cuda(torch.zeros((2, 8), dtype=dtype, device=cuda))
        with pytest.raises(TypeError, match="int32 or float32"):
            ring.ring_psum(torch.zeros((2, 8), dtype=dtype, device=cuda))
    with pytest.raises(ValueError, match="shards"):
        ring_cuda.ring_allreduce_cuda(torch.zeros((17, 8), dtype=torch.int32, device=cuda))
    z = torch.zeros((17, 2, 5), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="shards"):
        ring_cuda.fused_rank_ring_cuda(torch.zeros((17, 2, 5, 8), dtype=torch.int32, device=cuda),
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


@pytest.mark.parametrize("S", range(1, 17))
def test_fused_rank_ring_equals_plain(cuda, ring_fm, S):
    """The words entry: one pass, any M, against the plain rank + ring sum
    and the index's own occ."""
    fm = ring_fm
    for M in range(1, 10):
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


@pytest.mark.parametrize("S", [1, 2, 3, 4, 8, 16])
def test_fused_occ_equals_plain(cuda, ring_fm, S):
    """The table entry: rows read from the shard tables on the card against
    ``fused_occ_plain`` and the single-device rank, every coordinate."""
    fm = ring_fm
    sh = sharded_index.put_sharded(sharded_index.shard_fm_index(fm, S), cuda)
    rng = np.random.default_rng(S)
    k = torch.arange(fm.n + 2, dtype=torch.int32, device=cuda)
    c = torch.from_numpy(rng.integers(0, 4, size=fm.n + 2).astype(np.int32)).to(cuda)
    before = ring_cuda.fused_occ_cuda.launches
    got = sharded_index.fused_occ(sh, torch.stack([c, 3 - c]), torch.stack([k, k.flip(0)]))
    assert ring_cuda.fused_occ_cuda.launches == before + 1
    want = sharded_index.fused_occ_plain(sh, torch.stack([c, 3 - c]), torch.stack([k, k.flip(0)]))
    assert torch.equal(got, want)
    assert torch.equal(got[0], rank.occ_codes(rank.from_host(fm, cuda), c, k))


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
