"""The port's in-memory multi-part index (``index/multi.py``) against the
JAX package's: ``build_multi_index`` packs the same parts with equal FM
tables, and ``MultiIndexAligner`` gives equal hits (ties across parts
included: the same repeat unit sits in contigs of different parts), SAM
records and header; a contig longer than the part limit raises in both."""

import dataclasses

import numpy as np
import pytest

from genome_weaver_align_tpu.index import multi as j_multi
from genome_weaver_align_tpu.index import native as j_native
from genome_weaver_align_tpu.ops import affine as j_affine
from genome_weaver_align_tpu.utils import simulate
from genome_weaver_align_tpu.utils.fasta import Contig, Read
from genome_weaver_align_tpu_torch.index import multi
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module", autouse=True)
def _jax_native_off():
    """The JAX side runs its numpy builders and scored engine here, never
    its in-place ``make -C native``."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_native, "_lib", None)
        mp.setattr(j_native, "_build_failed", True)
        mp.setattr(j_affine, "_native_fn", None)
        mp.setattr(j_affine, "_native_failed", True)
        yield


@pytest.fixture(scope="module")
def contigs():
    """Four contigs; contigs 0 and 2 (different parts under a 25,000 bp
    limit) share a 200 bp unit, so reads from it tie across parts."""
    rng = np.random.default_rng(81)
    cs = [rng.integers(0, 4, size=sz, dtype=np.uint8) for sz in (12000, 9000, 15000, 7000)]
    unit = rng.integers(0, 4, size=200, dtype=np.uint8)
    cs[0][3000:3200] = unit
    cs[2][8000:8200] = unit
    return [Contig(f"chr{i}", c) for i, c in enumerate(cs)]


@pytest.fixture(scope="module")
def both(contigs):
    return (j_multi.build_multi_index(contigs, part_limit=25000, sample_rate=16),
            multi.build_multi_index(contigs, part_limit=25000, sample_rate=16))


def test_build_multi_index_matches_jax(contigs, both):
    want, got = both
    assert len(got.parts) == len(want.parts) >= 2
    assert (got.names, got.lengths, got.n_total) == (want.names, want.lengths, want.n_total)
    for g, w in zip(got.parts, want.parts):
        assert (g.global_offset, g.contig_range) == (w.global_offset, w.contig_range)
        assert g.gi.genome.names == w.gi.genome.names
        assert np.array_equal(g.gi.genome.codes, w.gi.genome.codes)
        for f in ("n", "primary", "sample_rate"):
            assert getattr(g.gi.fwd, f) == getattr(w.gi.fwd, f), f
        for f in ("C", "bwt_words", "occ_cp", "ssa_values", "text_words"):
            assert np.array_equal(getattr(g.gi.fwd, f), getattr(w.gi.fwd, f)), f
        assert g.gi.rev is None and w.gi.rev is None
    for pos in (0, 11999, 12000, 33000, got.n_total - 1):
        assert got.coord(pos) == want.coord(pos)
    with_rev = multi.build_multi_index(contigs[:2], part_limit=25000, sample_rate=16,
                                       build_rev=True)
    want_rev = j_multi.build_multi_index(contigs[:2], part_limit=25000, sample_rate=16,
                                         build_rev=True)
    assert np.array_equal(with_rev.parts[0].gi.rev.bwt_words, want_rev.parts[0].gi.rev.bwt_words)


def test_multi_index_aligner_matches_jax(both):
    jmi, pmi = both
    whole = np.concatenate([p.gi.genome.codes for p in jmi.parts])
    sims = simulate.simulate_reads(whole, 50, 80, seed=6, sub_rate=0.02, max_subs=2)
    reads = [s.read for s in sims]
    # reads inside the shared unit: equal distance in two parts
    for t, s in enumerate((3010, 3050, 3100)):
        reads.append(Read(f"tie{t}", whole[s : s + 80].copy()))
    reads.append(Read("junk", np.random.default_rng(2).integers(0, 4, 80).astype(np.uint8)))
    jal = j_multi.MultiIndexAligner(jmi, k=2)
    pal = multi.MultiIndexAligner(pmi, k=2, device="cpu")
    want, got = jal.align_batch(reads), pal.align_batch(reads)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert dataclasses.astuple(g) == dataclasses.astuple(w)
    # the tie goes to the smaller global position: contig 0's copy
    assert [(h.pos, h.dist) for h in got[-4:-1]] == [(3010, 0), (3050, 0), (3100, 0)]
    assert got[-1] is None
    assert [r.line() for r in pal.to_sam(reads, got)] == [r.line() for r in jal.to_sam(reads, want)]
    assert pal.sam_header().replace("gwa-torch", "gwa-tpu") == jal.sam_header()


def test_contig_exceeding_limit_raises():
    c = Contig("big", np.random.default_rng(1).integers(0, 4, size=1000, dtype=np.uint8))
    with pytest.raises(ValueError, match="exceeds part_limit"):
        multi.build_multi_index([c], part_limit=500)
    with pytest.raises(ValueError, match="exceeds part_limit"):
        j_multi.build_multi_index([c], part_limit=500)
