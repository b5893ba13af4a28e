"""The port's SuffixFilterAligner against the JAX one on the same numpy
index (no reverse-text index, so the JAX aligner runs no tier 2 either):
ArrayHits equal field by field, CIGARs and AS/NM included."""

import numpy as np
import pytest
import torch

from genome_weaver_align_tpu.index.files import Genome, GenomeIndex
from genome_weaver_align_tpu.index.build import build_fm_index
from genome_weaver_align_tpu.index import native as j_native
from genome_weaver_align_tpu.index.seedtable import build_seed_table
from genome_weaver_align_tpu.models import pipeline as j_pipeline
from genome_weaver_align_tpu.ops import affine as j_affine
from genome_weaver_align_tpu.utils.fasta import Contig
from genome_weaver_align_tpu.utils.simulate import simulate_reads_array
from genome_weaver_align_tpu_torch.models import pipeline

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
    args = dict(k=2, seed_table=seed_tab, seed_j=J, **kw)
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
    # without a reverse-text index the JAX aligner runs no tier 2 either
    assert jstats["n_staircase_fallback"] == 0
    assert stats["n_staircase_pending"] == int(np.sum(got.overflow & ~got.mapped))


def test_missing_fm_path_raises(random_gi):
    gi, tab = random_gi
    with pytest.raises(ValueError, match="FM pigeonhole"):
        pipeline.SuffixFilterAligner(gi, k=2)
    al = pipeline.SuffixFilterAligner(gi, k=2, seed_table=tab, seed_j=J)
    with pytest.raises(ValueError, match="FM pigeonhole"):
        al.align_arrays_submit(np.zeros((4, 3 * J - 1), np.int8), np.full(4, 3 * J - 1, np.int32))
