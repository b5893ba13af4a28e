"""The port's SuffixFilterAligner against the JAX one on the same numpy
index: ArrayHits equal field by field, CIGARs and AS/NM included, on the
seed-table path and on the FM pigeonhole path, through the tier-1 fallback
(indexes without their reverse text: neither aligner runs tier 2) and
through the tier-2 staircase (a repeat genome indexed with its reverse
text); and the k range both devices enforce."""

import numpy as np
import pytest
import torch

from genome_weaver_align_tpu.index.files import Genome, GenomeIndex, build_genome_index
from genome_weaver_align_tpu.index.build import build_fm_index
from genome_weaver_align_tpu.index.kmer import build_kmer_table
from genome_weaver_align_tpu.index import native as j_native
from genome_weaver_align_tpu.index.seedtable import build_seed_table
from genome_weaver_align_tpu.models import pipeline as j_pipeline
from genome_weaver_align_tpu.ops import affine as j_affine
from genome_weaver_align_tpu.utils.fasta import Contig, Read
from genome_weaver_align_tpu.utils.simulate import simulate_reads, simulate_reads_array
from genome_weaver_align_tpu_torch.models import pipeline
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

J = 9


@pytest.fixture(scope="module", autouse=True)
def _jax_native_off():
    """The JAX side runs its numpy builders and scored engine here, never
    its in-place ``make -C native``: test workers running that make at once
    can load a half-written library.  The port keeps its native engine, so
    the two engines are held against each other."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_native, "_lib", None)
        mp.setattr(j_native, "_build_failed", True)
        mp.setattr(j_affine, "_native_fn", None)
        mp.setattr(j_affine, "_native_failed", True)
        yield


def _gi(codes):
    genome = Genome.from_contigs([Contig("chrP", codes)])
    return GenomeIndex(genome, build_fm_index(genome.codes, sample_rate=16), None)


@pytest.fixture(scope="module")
def random_gi():
    codes = np.random.default_rng(8).integers(0, 4, size=60000, dtype=np.uint8)
    gi = _gi(codes)
    return gi, build_seed_table(gi.genome.codes, J)


@pytest.fixture(scope="module")
def repeat_gi():
    """30 copies of a 300 bp unit, each 3% diverged, before random
    sequence: reads from the copies flood the seed buckets, their own copy
    falls outside the hit budget, and they take the tier-1 fallback."""
    rng = np.random.default_rng(5)
    unit = rng.integers(0, 4, size=300, dtype=np.uint8)
    copies = []
    for _ in range(30):
        c = unit.copy()
        mut = rng.random(300) < 0.03
        c[mut] = (c[mut] + rng.integers(1, 4, size=int(mut.sum()))) % 4
        copies.append(c)
    codes = np.concatenate(copies + [rng.integers(0, 4, size=30000, dtype=np.uint8)])
    gi = _gi(codes)
    return gi, build_seed_table(gi.genome.codes, J)


def _run_both(gi, seed_tab, reads, lengths, **kw):
    """``seed_tab=None`` runs the FM pigeonhole path."""
    args = dict(k=2, **kw)
    if seed_tab is not None:
        args.update(seed_table=seed_tab, seed_j=J)
    jal = j_pipeline.SuffixFilterAligner(gi, **args)
    pal = pipeline.SuffixFilterAligner(gi, device=torch.device("cpu"), **args)
    want = jal.align_arrays_finish(jal.align_arrays_submit(reads, lengths))
    # two batches in flight, as the CLI drives it
    h1 = pal.align_arrays_submit(reads, lengths)
    h2 = pal.align_arrays_submit(reads[::-1].copy(), lengths[::-1].copy())
    pipeline.prefetch_result(h2)
    got = pal.align_arrays_finish(h1)
    stats = dict(pal.last_stats)
    pal.align_arrays_finish(h2)
    for field in pipeline.ArrayHits._fields:
        g, w = getattr(got, field), getattr(want, field)
        if isinstance(w, dict):
            assert g == w, field
        else:
            assert g.dtype == w.dtype, field
            assert np.array_equal(g, w), field
    return jal.last_stats, stats, got


def test_uniform_batch(random_gi):
    gi, tab = random_gi
    reads, pos, strand, _ = simulate_reads_array(gi.genome.codes, 200, 100, seed=1, max_subs=2)
    reads = reads.astype(np.int8)
    reads[7, 40] = 4  # an N
    _, stats, got = _run_both(gi, tab, reads, np.full(200, 100, np.int32))
    assert got.mapped.mean() > 0.98
    assert np.mean(got.pos[got.mapped] == pos[got.mapped]) > 0.98
    assert stats["n_slow_traceback"] == 0


def test_ragged_batch(random_gi):
    gi, tab = random_gi
    reads, _, _, _ = simulate_reads_array(gi.genome.codes, 120, 100, seed=2, max_subs=2)
    reads = reads.astype(np.int32)
    lengths = np.random.default_rng(3).integers(3 * J, 101, size=120).astype(np.int32)
    for i, l in enumerate(lengths):
        reads[i, l:] = 0
    _, _, got = _run_both(gi, tab, reads, lengths)
    assert got.mapped.mean() > 0.9


@pytest.mark.parametrize("scored", [True, False])
def test_indel_batch_slow_path(random_gi, scored):
    gi, tab = random_gi
    reads, _, _, has_indel = simulate_reads_array(
        gi.genome.codes, 160, 100, seed=4, max_subs=1, indel_frac=0.5
    )
    _, stats, got = _run_both(gi, tab, reads.astype(np.int8), np.full(160, 100, np.int32),
                              scored=scored)
    assert stats["n_slow_traceback"] > 0
    assert len(got.cigars) > 0 and (len(got.aux) > 0) == scored


def test_repeat_genome_tier1_fallback(repeat_gi):
    gi, tab = repeat_gi
    codes = gi.genome.codes
    reads, _, _, _ = simulate_reads_array(codes[: 300 * 30], 96, 100, seed=6, max_subs=2)
    more, _, _, _ = simulate_reads_array(codes, 32, 100, seed=7, max_subs=2)
    reads = np.concatenate([reads, more]).astype(np.int8)
    jstats, stats, got = _run_both(gi, tab, reads, np.full(128, 100, np.int32),
                                   max_hits_per_piece=2)
    assert stats["n_overflow_fallback"] == jstats["n_overflow_fallback"] > 0
    assert got.overflow.any()
    # without a reverse-text index neither aligner runs tier 2
    assert jstats["n_staircase_fallback"] == stats["n_staircase_fallback"] == 0


# ------------------------------------------------------------- FM path


@pytest.mark.parametrize("kmer", [False, True])
def test_fm_path_uniform_batch(random_gi, kmer):
    gi, _ = random_gi
    reads, pos, _, _ = simulate_reads_array(gi.genome.codes, 200, 100, seed=11, max_subs=2)
    reads = reads.astype(np.int8)
    reads[5, 60] = 4  # an N
    kw = dict(kmer_table=build_kmer_table(gi.fwd, 6), kmer_j=6) if kmer else {}
    _, stats, got = _run_both(gi, None, reads, np.full(200, 100, np.int32), **kw)
    assert got.mapped.mean() > 0.98
    assert np.mean(got.pos[got.mapped] == pos[got.mapped]) > 0.98


def test_fm_path_ragged_batch(random_gi):
    gi, _ = random_gi
    reads, _, _, _ = simulate_reads_array(gi.genome.codes, 120, 100, seed=12, max_subs=2,
                                          indel_frac=0.3)
    reads = reads.astype(np.int32)
    lengths = np.random.default_rng(13).integers(15, 101, size=120).astype(np.int32)
    for i, l in enumerate(lengths):
        reads[i, l:] = 0
    _, stats, got = _run_both(gi, None, reads, lengths)
    assert got.mapped.mean() > 0.9
    assert stats["n_slow_traceback"] > 0


def test_short_pieces_take_the_fm_path(random_gi):
    """A seed table whose j exceeds the pieces: both aligners fall back to
    the FM search."""
    gi, tab = random_gi
    reads, _, _, _ = simulate_reads_array(gi.genome.codes, 64, 3 * J - 3, seed=14, max_subs=1)
    _, _, got = _run_both(gi, tab, reads.astype(np.int8), np.full(64, 3 * J - 3, np.int32))
    assert got.mapped.mean() > 0.9


@pytest.mark.parametrize("verify_slack", [0, 6])
def test_verify_mode_myers(random_gi, verify_slack):
    """Myers verify runs on the ragged (general) path, the one the JAX
    aligner sends it to; uniform batches keep the fused banded step."""
    gi, _ = random_gi
    reads, _, _, _ = simulate_reads_array(gi.genome.codes, 100, 90, seed=15, max_subs=2,
                                          indel_frac=0.3)
    reads = reads.astype(np.int32)
    lengths = np.random.default_rng(16).integers(40, 91, size=100).astype(np.int32)
    for i, l in enumerate(lengths):
        reads[i, l:] = 0
    _, _, got = _run_both(gi, None, reads, lengths, verify_mode="myers",
                          verify_slack=verify_slack)
    assert got.mapped.mean() > 0.9


def test_fm_path_repeat_tier1_fallback(repeat_gi):
    gi, _ = repeat_gi
    codes = gi.genome.codes
    reads, _, _, _ = simulate_reads_array(codes[: 300 * 30], 96, 100, seed=17, max_subs=2)
    more, _, _, _ = simulate_reads_array(codes, 32, 100, seed=18, max_subs=2)
    reads = np.concatenate([reads, more]).astype(np.int8)
    jstats, stats, got = _run_both(gi, None, reads, np.full(128, 100, np.int32),
                                   max_hits_per_piece=2)
    assert stats["n_overflow_fallback"] == jstats["n_overflow_fallback"] > 0
    assert got.overflow.any()
    assert jstats["n_staircase_fallback"] == stats["n_staircase_fallback"] == 0


# ------------------------------------------------------------- tier 2

SEED_J2 = 8


@pytest.fixture(scope="module")
def flooded():
    """The JAX tier-2 test's genome, indexed with its reverse text: 60
    copies of a 400 bp unit (each 3% diverged) before random sequence, and
    reads from inside the copies with 2 substitutions each."""
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
    reads = np.empty((40, 96), dtype=np.int8)
    for i in range(40):
        p = int(rng.integers(0, 60)) * 400 + int(rng.integers(0, 400 - 96))
        r = codes[p : p + 96].astype(np.int8)
        for _ in range(2):
            at = int(rng.integers(0, 96))
            r[at] = (r[at] + int(rng.integers(1, 4))) % 4
        reads[i] = r
    return gi, build_seed_table(codes, SEED_J2), reads


def _flood_args(tab):
    """Tiny budgets that flood every seed bucket (the JAX test's)."""
    return dict(max_hits_per_piece=2, max_cands=4, seed_table=tab, seed_j=SEED_J2,
                seed_probes=1, verify_slack=2)


def test_tier2_staircase_matches_jax(flooded):
    """Reads still flooded after tier 1 go through the staircase on both
    aligners; the merged ArrayHits are equal, and the staircase maps reads
    the rev-less index leaves unmapped (the merge is improve-only)."""
    gi, tab, reads = flooded
    lengths = np.full(reads.shape[0], reads.shape[1], np.int32)
    jstats, stats, got = _run_both(gi, None, reads, lengths, **_flood_args(tab))
    assert stats["n_staircase_fallback"] == jstats["n_staircase_fallback"] > 0
    assert stats["t_tier2_ms"] >= 0 and "t_tier1_ms" in stats
    no_rev = pipeline.SuffixFilterAligner(GenomeIndex(gi.genome, gi.fwd, None), device="cpu",
                                          k=2, **_flood_args(tab))
    base = no_rev.align_arrays_finish(no_rev.align_arrays_submit(reads, lengths))
    assert no_rev.last_stats["n_staircase_fallback"] == 0
    assert got.mapped.sum() > base.mapped.sum()
    assert np.all(got.mapped[base.mapped])
    assert np.all(got.dist[base.mapped] <= base.dist[base.mapped])


def test_tier2_on_ragged_and_list_api_matches_jax(flooded):
    """A ragged flooded batch (tier 2 on the general path) through the list
    API and to_sam: SAM lines equal."""
    gi, tab, reads = flooded
    lens = np.random.default_rng(4).integers(60, 97, size=reads.shape[0])
    rs = [Read(f"r{i}", reads[i, :l].astype(np.uint8)) for i, l in enumerate(lens)]
    jal = j_pipeline.SuffixFilterAligner(gi, k=2, **_flood_args(tab))
    pal = pipeline.SuffixFilterAligner(gi, k=2, device="cpu", **_flood_args(tab))
    want = [r.line() for r in jal.to_sam(rs, jal.align_batch(rs))]
    got = [r.line() for r in pal.to_sam(rs, pal.align_batch(rs))]
    assert got == want
    assert pal.last_stats["n_staircase_fallback"] == jal.last_stats["n_staircase_fallback"] > 0


@pytest.mark.parametrize("k", [0, 15, -1])
def test_k_outside_1_to_14_is_rejected(random_gi, k):
    """Both aligners refuse k outside 1..14 when built, on the CPU as on
    the card (the JAX aligner instead unmaps reads at k >= 15)."""
    from genome_weaver_align_tpu_torch.ops import dp_cuda
    from genome_weaver_align_tpu_torch.parallel.sharded_pipeline import ShardedAligner

    assert pipeline.MAX_ALIGNER_K == 14 and dp_cuda.REGISTER_K == 16
    gi, _ = random_gi
    with pytest.raises(ValueError, match="1 <= k <= 14"):
        pipeline.SuffixFilterAligner(gi, k=k, device="cpu")
    with pytest.raises(ValueError, match="1 <= k <= 14"):
        ShardedAligner(gi, k=k, n_interval=2, device="cpu")
    pipeline.SuffixFilterAligner(gi, k=14, device="cpu")


@pytest.mark.parametrize("k", [15, 16, 17, 32])
def test_kernel_band_past_14_stays_refused_by_short_read_aligners(random_gi, k):
    """The banded DP kernel takes any k (one thread a lane up to 16, a
    group of threads past it: the long-read bands), but the short-read
    aligners keep their own bound: their 4-bit dist field saturates at
    15."""
    from genome_weaver_align_tpu_torch.ops import dp_cuda

    assert (k <= dp_cuda.REGISTER_K) == (k <= 16) and k <= dp_cuda.GROUP_K
    gi, _ = random_gi
    with pytest.raises(ValueError, match="1 <= k <= 14"):
        pipeline.SuffixFilterAligner(gi, k=k, device="cpu")
    with pytest.raises(ValueError, match="1 <= k <= 14"):
        pipeline.check_k(k)


def test_list_api_and_to_sam(random_gi):
    """align_batch + to_sam over Read objects (ragged, with an N and an
    unmappable read), SAM lines identical."""
    gi, _ = random_gi
    rng = np.random.default_rng(19)
    sims = simulate_reads(gi.genome.codes, 40, 80, seed=20, sub_rate=0.02, max_subs=2,
                          indel_rate=0.01, max_indels=1)
    reads = [s.read for s in sims]
    reads.append(Read("junk", rng.integers(0, 4, size=80, dtype=np.uint8)))
    reads.append(Read("short", reads[0].codes[:50].copy()))
    jal = j_pipeline.SuffixFilterAligner(gi, k=3)
    pal = pipeline.SuffixFilterAligner(gi, k=3, device="cpu")
    want = [r.line() for r in jal.to_sam(reads, jal.align_batch(reads))]
    got = [r.line() for r in pal.to_sam(reads, pal.align_batch(reads))]
    assert got == want
    assert sum("\t4\t" not in l for l in got) > 35
