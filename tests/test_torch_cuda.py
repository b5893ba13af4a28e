"""Tests that need an NVIDIA GPU with nvcc (marker ``cuda``; they skip
without one).  On the card:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

They import no JAX: they hold each CUDA kernel (banded DP through both
entries, Myers, the two ring merges) against its plain torch version, and the aligners and the
sharded search on the card against the same code on the CPU, which the CPU
tests hold against the JAX package."""

import numpy as np
import pytest
import torch

from genome_weaver_align_tpu_torch.utils.simulate import simulate_reads_array
from genome_weaver_align_tpu_torch.index.build import build_fm_index
from genome_weaver_align_tpu_torch.index.files import Genome, GenomeIndex
from genome_weaver_align_tpu_torch.index.seedtable import build_seed_table
from genome_weaver_align_tpu_torch.models import paired, pipeline
from genome_weaver_align_tpu_torch.ops import dp, dp_cuda, myers, myers_cuda, ring_cuda
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
    with pytest.raises(ValueError, match="k=9"):
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
                  myers_cuda.myers_semiglobal_cuda.launches)
        results.append(pa.align_pair_arrays(c1, lengths, c2, lengths))
        if device.type == "cuda":
            assert dp_cuda.banded_edit_distance_text_cuda.launches > before[0]
            assert myers_cuda.myers_semiglobal_cuda.launches > before[1]
    got, want = results
    assert sum(ph.rescued != 0 for ph in got) >= n // 10
    assert [(a.h1, a.h2, a.proper, a.rescued) for a in got] == \
        [(b.h1, b.h2, b.proper, b.rescued) for b in want]


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
    z = torch.zeros((2, 9, 5), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="M=9"):
        ring_cuda.fused_rank_ring_cuda(torch.zeros((2, 9, 5, 8), dtype=torch.int32, device=cuda),
                                       z, z, z, z)


def test_stuck_ring_raises_instead_of_hanging(cuda):
    """Shard 1's blocks of the fused ring return at once: its neighbours
    wait ~1 s, set the error word and return; the wrapper raises, and the
    next launch works."""
    import time

    w = torch.zeros((3, 2, 4096, 8), dtype=torch.int32, device=cuda)
    z = torch.zeros((3, 2, 4096), dtype=torch.int32, device=cuda)
    t0 = time.time()
    with pytest.raises(RuntimeError, match="stuck"):
        ring_cuda.fused_rank_ring_cuda(w, z, z, z + 1, z + 1, stall_shard=1)
    assert time.time() - t0 < 30
    # roff 0 counts no bases: each of the 3 owning shards adds its base 1
    assert torch.equal(ring_cuda.fused_rank_ring_cuda(w, z, z, z + 1, z + 1), z + 3)


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


@pytest.mark.parametrize("S,M", [(1, 2), (2, 2), (4, 2), (4, 3), (8, 2)])
def test_fused_rank_ring_equals_plain(cuda, S, M):
    rng = np.random.default_rng(S * 10 + M)
    fm = build_fm_index(rng.integers(0, 4, size=200_000, dtype=np.uint8), sample_rate=8)
    for Q in (96, 65_536):
        ins = _sharded_rows(fm, S, M, Q, Q + S)
        plain = ring.fused_rank_ring_plain(*ins[:5])
        before = ring_cuda.fused_rank_ring_cuda.launches
        got = ring_cuda.fused_rank_ring_cuda(*(t.to(cuda) for t in ins[:5]))
        assert ring_cuda.fused_rank_ring_cuda.launches == before + 1
        assert torch.equal(got.cpu(), plain), Q
        c, k = ins[5]
        for m in range(M):
            want = np.array([fm.occ(int(cc), int(kk)) for cc, kk in zip(c[m, :50], k[m, :50])])
            assert np.array_equal(got[0, m, :50].cpu().numpy(), want.reshape(-1))


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
            before = (ring_cuda.ring_allreduce_cuda.launches, ring_cuda.fused_rank_ring_cuda.launches)
            fn = sharded_index.make_sharded_exact_search(layout, L, sh, merge=merge, microbatch=2)
            out[dev.type, merge] = [v.cpu() for v in fn(sh, r, l)]
            after = (ring_cuda.ring_allreduce_cuda.launches, ring_cuda.fused_rank_ring_cuda.launches)
            if dev.type == "cuda":
                assert after[0] - before[0] == (2 * L if merge == "ring" else 0)
                assert after[1] - before[1] == (L if merge == "fused" else 0)
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
