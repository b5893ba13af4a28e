"""The port's staircase suffix filter (``models/staircase.py``) against the
JAX package's: candidates, counts and overflow flags equal at k = 1, 2, 3,
with and without ``narrow_left``; recall against a brute-force scan;
pruning against pigeonhole; and ``SuffixFilterAligner(use_staircase=True)``
ArrayHits equal on the fused (uniform) and the general (ragged) path."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genome_weaver_align_tpu.index import native as j_native
from genome_weaver_align_tpu.index.build import build_fm_index
from genome_weaver_align_tpu.index.files import Genome, GenomeIndex
from genome_weaver_align_tpu.models import bidirectional as j_bd
from genome_weaver_align_tpu.models import pipeline as j_pipeline
from genome_weaver_align_tpu.models import staircase as j_staircase
from genome_weaver_align_tpu.ops import affine as j_affine
from genome_weaver_align_tpu.utils.simulate import simulate_reads_array
from genome_weaver_align_tpu_torch.models import bidirectional as bd
from genome_weaver_align_tpu_torch.models import pipeline, staircase, suffix_filter
from genome_weaver_align_tpu_torch.models.suffix_filter import NO_CAND
from genome_weaver_align_tpu_torch.ops import rank
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")


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
def setup():
    codes = np.random.default_rng(23).integers(0, 4, size=40000, dtype=np.uint8)
    fwd = build_fm_index(codes, sample_rate=16)
    rev = build_fm_index(codes[::-1].copy(), sample_rate=16)
    return codes, fwd, rev, bd.from_host_bi(fwd, rev, CPU), j_bd.from_host_bi(fwd, rev)


def brute_loci(codes, read, k):
    wins = np.lib.stride_tricks.sliding_window_view(codes, read.size)
    mm = (wins != read[None, :]).sum(axis=1)
    return set(np.nonzero(mm <= k)[0].tolist())


def _planted(codes, k, seed, B=24, L=60):
    rng = np.random.default_rng(seed)
    reads = np.zeros((B, L), dtype=np.int32)
    for i in range(B):
        p = int(rng.integers(0, codes.size - L))
        r = codes[p : p + L].astype(np.int32).copy()
        for _ in range(int(rng.integers(0, k + 1))):
            at = int(rng.integers(0, L))
            r[at] = (r[at] + 1 + rng.integers(0, 3)) % 4
        reads[i] = r
    return reads, np.full(B, L, np.int32)


def _both(setup, reads, lengths, k, **kw):
    _, _, _, bi, jbi = setup
    got = staircase.staircase_filter_candidates(
        bi, torch.from_numpy(reads), torch.from_numpy(lengths), k, **kw)
    want = j_staircase.staircase_filter_candidates(
        jbi, jnp.asarray(reads), jnp.asarray(lengths), k, **kw)
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), np.asarray(b))
    return got


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("narrow_left", [False, True])
def test_staircase_recall_matches_jax(setup, k, narrow_left):
    codes = setup[0]
    reads, lengths = _planted(codes, k, 100 + k)
    res = _both(setup, reads, lengths, k, narrow_left=narrow_left)
    cand, ovf = res.cand_pos.numpy(), res.overflow.numpy()
    for i in range(reads.shape[0]):
        want = brute_loci(codes, reads[i], k)
        got = set(int(x) for x in cand[i] if x != NO_CAND)
        if not ovf[i]:
            assert want <= got, f"read {i}: missing {want - got}"


def test_staircase_ragged_and_tiny_pool_matches_jax(setup):
    """Ragged lengths (lanes past their read), a 2-slot pool that
    overflows, max_len, and an empty read."""
    codes = setup[0]
    reads, lengths = _planted(codes, 2, 7, B=20, L=48)
    lengths = np.random.default_rng(8).integers(12, 49, size=20).astype(np.int32)
    lengths[3] = 0
    for kw in (dict(n_slots=2), dict(n_slots=2, narrow_left=True, keep=3, hits_per_state=2),
               dict(max_len=40)):
        res = _both(setup, reads, lengths, 2, **kw)
    assert res.n_cands.sum() > 0


def test_compact_pool_matches_jax():
    """Stable compaction, dead slots zeroed, live count past n_slots."""
    rng = np.random.default_rng(4)
    B, S4 = 9, 24
    lo = rng.integers(0, 50, size=(B, S4)).astype(np.int32)
    hi = lo + rng.integers(-2, 3, size=(B, S4)).astype(np.int32)
    rlo = rng.integers(0, 50, size=(B, S4)).astype(np.int32)
    mm = rng.integers(0, 3, size=(B, S4)).astype(np.int32)
    for n_slots in (1, 4, 16, 30):
        got = staircase._compact_pool(bd.BiInterval(*[torch.from_numpy(a) for a in
                                                      (lo, hi, rlo, rlo + 1)]),
                                      torch.from_numpy(mm), n_slots)
        want = j_staircase._compact_pool(j_bd.BiInterval(*[jnp.asarray(a) for a in
                                                           (lo, hi, rlo, rlo + 1)]),
                                         jnp.asarray(mm), n_slots)
        for a, b in zip((*got[0], got[1], got[2]), (*want[0], want[1], want[2])):
            assert np.array_equal(a.numpy(), np.asarray(b)), n_slots


def test_staircase_prunes_vs_pigeonhole(setup):
    codes, fwd = setup[0], setup[1]
    rng = np.random.default_rng(55)
    k, B, L = 2, 16, 60
    reads = np.zeros((B, L), dtype=np.int32)
    for i in range(B):
        p = int(rng.integers(0, codes.size - L))
        reads[i] = codes[p : p + L]
    lengths = np.full(B, L, np.int32)
    st = _both(setup, reads, lengths, k)
    ph = suffix_filter.pigeonhole_candidates(
        rank.from_host(fwd, "cpu"), torch.from_numpy(reads), torch.from_numpy(lengths), k + 1, 16)
    for i in range(B):
        sset = set(int(x) for x in st.cand_pos[i].tolist() if x != NO_CAND)
        pset = set(int(x) for x in ph.cand_pos[i].tolist() if x != NO_CAND)
        assert sset <= pset
        assert sset, "planted exact read must produce at least one candidate"


@pytest.fixture(scope="module")
def gi(setup):
    codes, fwd, rev = setup[:3]
    genome = Genome(names=["chrS"], offsets=np.array([0, codes.size], dtype=np.int64),
                    codes=codes, n_mask_spans=np.zeros((0, 2), np.int64))
    return GenomeIndex(genome, fwd, rev)


@pytest.mark.parametrize("narrow_left", [False, True])
def test_aligner_staircase_mode_matches_jax(gi, narrow_left):
    """``use_staircase=True``: the fused staircase step on a uniform batch
    and the stacked-strands general path on a ragged one (with indel reads
    for the slow path), ArrayHits equal field by field."""
    reads, pos, strand, _ = simulate_reads_array(gi.genome.codes, 40, 100, seed=2, max_subs=2,
                                                 indel_frac=0.2)
    reads = reads.astype(np.int32)
    ragged = np.random.default_rng(3).integers(60, 101, size=40).astype(np.int32)
    kw = dict(k=2, use_staircase=True, staircase_narrow_left=narrow_left)
    jal = j_pipeline.SuffixFilterAligner(gi, **kw)
    pal = pipeline.SuffixFilterAligner(gi, device=CPU, **kw)
    for lengths in (np.full(40, 100, np.int32), ragged):
        r = reads.copy()
        for i, l in enumerate(lengths):
            r[i, l:] = 0
        want = jal.align_arrays_finish(jal.align_arrays_submit(r, lengths))
        got = pal.align_arrays_finish(pal.align_arrays_submit(r, lengths))
        for field in pipeline.ArrayHits._fields:
            g, w = getattr(got, field), getattr(want, field)
            assert (g == w) if isinstance(w, dict) else np.array_equal(g, w), field
        assert got.mapped.mean() > 0.8
