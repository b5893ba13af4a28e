"""The port's PairedAligner against the JAX one: pairs built as the JAX
bench builds them (FR mates, 1-2 substitutions each, 10% of mate2 with 4
more substitutions: unmappable at k = 2, within the rescue bar), equal
PairHits, SAM records and rescue counts, on both candidate paths."""

import numpy as np
import pytest

from genome_weaver_align_tpu.index import native as j_native
from genome_weaver_align_tpu.index.build import build_fm_index
from genome_weaver_align_tpu.index.files import Genome, GenomeIndex
from genome_weaver_align_tpu.index.seedtable import build_seed_table
from genome_weaver_align_tpu.models import paired as j_paired
from genome_weaver_align_tpu.models import pipeline as j_pipeline
from genome_weaver_align_tpu.ops import affine as j_affine
from genome_weaver_align_tpu.utils.fasta import Contig, Read
from genome_weaver_align_tpu_torch.models import paired, pipeline
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

J = 10
N_PAIRS, L = 256, 100


@pytest.fixture(scope="module", autouse=True)
def _jax_native_off():
    """The JAX side runs its numpy builders and scored engine here, never
    its in-place ``make -C native``: test workers running that make at once
    can load a half-written library."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_native, "_lib", None)
        mp.setattr(j_native, "_build_failed", True)
        mp.setattr(j_affine, "_native_fn", None)
        mp.setattr(j_affine, "_native_failed", True)
        yield


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(21)
    codes = rng.integers(0, 4, size=80_000, dtype=np.uint8)
    genome = Genome.from_contigs([Contig("chrP", codes[:50_000]), Contig("chrQ", codes[50_000:])])
    gi = GenomeIndex(genome, build_fm_index(genome.codes, sample_rate=8), None)
    n = N_PAIRS
    insert = rng.integers(250, 550, size=n)
    pos1 = rng.integers(0, codes.size - 600, size=n)
    c1 = codes[pos1[:, None] + np.arange(L)[None, :]].astype(np.int8)
    p2 = pos1 + insert - L
    c2raw = codes[p2[:, None] + np.arange(L)[None, :]].astype(np.int8)
    c2 = np.ascontiguousarray((3 - c2raw)[:, ::-1])  # mate2 on the reverse strand
    for arr in (c1, c2):
        for _ in range(2):
            at = rng.integers(0, L, size=n)
            rows = np.nonzero(rng.random(n) < 0.6)[0]
            arr[rows, at[rows]] = (arr[rows, at[rows]] + rng.integers(1, 4, size=rows.size)) % 4
    half = np.nonzero(rng.random(n) < 0.10)[0]
    for _ in range(4):
        at = rng.integers(0, L, size=n)
        c2[half, at[half]] = (c2[half, at[half]] + rng.integers(1, 4, size=half.size)) % 4
    pairs = [(Read(f"p{i}", c1[i].astype(np.uint8)), Read(f"p{i}", c2[i].astype(np.uint8)))
             for i in range(n)]
    return gi, build_seed_table(genome.codes, J), c1, c2, pairs


def _hit_tuple(h):
    return None if h is None else (h.pos, h.strand, h.dist, h.cigar, h.n_good, h.overflow,
                                   h.score, h.nm)


@pytest.mark.parametrize("path,inserts", [
    ("seed", (200, 600)), ("fm", (200, 600)), ("fm", None),
])
def test_paired_matches_jax(data, path, inserts):
    gi, tab, c1, c2, pairs = data
    kw = dict(k=2, max_hits_per_piece=8)
    if path == "seed":
        kw.update(seed_table=tab, seed_j=J, max_cands=12, verify_slack=4)
    ins = dict(min_insert=inserts[0], max_insert=inserts[1]) if inserts else {}
    jpa = j_paired.PairedAligner(j_pipeline.SuffixFilterAligner(gi, **kw), **ins)
    ppa = paired.PairedAligner(pipeline.SuffixFilterAligner(gi, device="cpu", **kw), **ins)
    lengths = np.full(N_PAIRS, L, np.int32)
    want = jpa.align_pair_arrays(c1, lengths, c2, lengths)
    got = ppa.align_pair_arrays(c1, lengths, c2, lengths)
    for g, w in zip(got, want):
        assert (_hit_tuple(g.h1), _hit_tuple(g.h2), g.proper, g.rescued) == \
            (_hit_tuple(w.h1), _hit_tuple(w.h2), w.proper, w.rescued)
    assert ppa.last_rescue_jobs == jpa.last_rescue_jobs
    n_rescued = sum(ph.rescued != 0 for ph in got)
    assert n_rescued >= 0.05 * N_PAIRS  # the rescue path really ran
    assert sum(ph.proper for ph in got) >= 0.9 * N_PAIRS
    assert [r.line() for r in ppa.to_sam(pairs, got)] == \
        [r.line() for r in jpa.to_sam(pairs, want)]


def test_align_pairs_list_api_and_half_mapped(data):
    """align_pairs over Read objects, with junk mates that neither aligner
    can map or rescue."""
    gi, _, _, _, pairs = data
    rng = np.random.default_rng(5)
    mixed = pairs[:40] + [(pairs[i][0], Read("junk", rng.integers(0, 4, size=L, dtype=np.uint8)))
                          for i in range(40, 48)]
    jpa = j_paired.PairedAligner(j_pipeline.SuffixFilterAligner(gi, k=2))
    ppa = paired.PairedAligner(pipeline.SuffixFilterAligner(gi, k=2, device="cpu"))
    want = [r.line() for r in jpa.to_sam(mixed, jpa.align_pairs(mixed))]
    got_hits = ppa.align_pairs(mixed)
    assert [r.line() for r in ppa.to_sam(mixed, got_hits)] == want
    assert sum(ph.h2 is None for ph in got_hits) >= 8
