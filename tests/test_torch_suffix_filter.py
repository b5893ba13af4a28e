"""Each suffix-filter function of the port (seed-table path, FM pigeonhole
path, banded and Myers verify) equals its JAX twin on the same inputs
(exact equality: the pipeline is integer-only)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from genome_weaver_align_tpu.index import native as j_native
from genome_weaver_align_tpu.index.build import build_fm_index
from genome_weaver_align_tpu.index.kmer import build_kmer_table
from genome_weaver_align_tpu.index.seedtable import build_seed_table
from genome_weaver_align_tpu.models import suffix_filter as j_sf
from genome_weaver_align_tpu.ops import rank as j_rank
from genome_weaver_align_tpu.utils import packing
from genome_weaver_align_tpu.utils.simulate import simulate_reads_array
from genome_weaver_align_tpu_torch.models import suffix_filter as sf
from genome_weaver_align_tpu_torch.ops import rank
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

K = 2
J = 8


@pytest.fixture(scope="module", autouse=True)
def _jax_native_off():
    """The JAX seed table comes from its numpy builder here, never from its
    in-place ``make -C native``: test workers running that make at once can
    load a half-written library."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_native, "_lib", None)
        mp.setattr(j_native, "_build_failed", True)
        yield


def _eq(got, want):
    got = got.numpy()
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.array_equal(got, want.astype(got.dtype))


@pytest.fixture(scope="module")
def setup():
    """A genome with a tiled repeat (wide seed buckets -> overflow) and a
    ragged read batch with Ns."""
    rng = np.random.default_rng(33)
    unit = rng.integers(0, 4, size=120, dtype=np.uint8)
    codes = np.concatenate([np.tile(unit, 12), rng.integers(0, 4, size=30000, dtype=np.uint8)])
    offsets, positions = build_seed_table(codes, J)
    B, L = 96, 72
    reads, _, _, _ = simulate_reads_array(codes, B, L, seed=5, max_subs=2, indel_frac=0.2)
    reads = reads.astype(np.int32)
    reads[3, 10] = 4
    lengths = np.where(np.arange(B) % 3 == 0, rng.integers(3 * J, L + 1, size=B), L).astype(np.int32)
    for i in range(B):
        reads[i, lengths[i]:] = 0
    return dict(codes=codes, words=packing.pack(codes), offsets=offsets,
                positions=positions, reads=reads, lengths=lengths)


def _t(a):
    a = np.asarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


@pytest.mark.parametrize("max_hits,max_cands,n_probes", [(8, 12, 4), (2, 5, 1), (4, None, 3)])
def test_seed_candidates(setup, max_hits, max_cands, n_probes):
    s = setup
    search = np.where(s["reads"] >= 4, 0, s["reads"]).astype(np.int32)
    want = j_sf.seed_candidates(
        jnp.asarray(s["offsets"]), jnp.asarray(s["positions"]), jnp.asarray(search),
        jnp.asarray(s["lengths"]), K + 1, J, max_hits=max_hits, max_cands=max_cands,
        n_probes=n_probes,
    )
    got = sf.seed_candidates(
        _t(s["offsets"]), _t(s["positions"]), _t(search), _t(s["lengths"]), K + 1, J,
        max_hits=max_hits, max_cands=max_cands, n_probes=n_probes,
    )
    for g, w in zip(got, want):
        _eq(g, w)
    assert got.overflow.any() and (~got.overflow).any()


@pytest.mark.parametrize("K_lanes", [0, 7, 40, 300])
def test_compact_lanes(K_lanes):
    valid = np.random.default_rng(K_lanes).random(200) < 0.3
    want = j_sf.compact_lanes(jnp.asarray(valid), K_lanes)
    got = sf.compact_lanes(torch.from_numpy(valid), K_lanes)
    for g, w in zip(got, want):
        _eq(g, w)


@pytest.fixture(scope="module")
def cands(setup):
    s = setup
    search = np.where(s["reads"] >= 4, 0, s["reads"]).astype(np.int32)
    c = sf.seed_candidates(_t(s["offsets"]), _t(s["positions"]), _t(search),
                           _t(s["lengths"]), K + 1, J, max_hits=8, max_cands=12)
    return c.cand_pos.numpy()


@pytest.mark.parametrize("slack", [1, 6])
def test_verify_compact_and_best_hit_compact(setup, cands, slack):
    s = setup
    L = s["reads"].shape[1]
    W = L + 3 * K
    want = j_sf.verify_candidates_compact(
        jnp.asarray(s["words"]), s["codes"].size, jnp.asarray(s["reads"]),
        jnp.asarray(s["lengths"]), jnp.asarray(cands), K, W, slack=slack,
    )
    got = sf.verify_candidates_compact(
        _t(s["words"]), s["codes"].size, _t(s["reads"]), _t(s["lengths"]),
        _t(cands), K, W, slack=slack,
    )
    for g, w in zip(got, want):
        _eq(g, w)
    if slack == 1:
        assert got[3].any()  # the lane budget overflowed for some reads
    B = s["reads"].shape[0]
    want_b = j_sf.best_hit_compact(*(jnp.asarray(a.numpy()) for a in got[2::-1]), K, B)
    got_b = sf.best_hit_compact(got[2], got[1], got[0], K, B)
    for g, w in zip(got_b, want_b):
        _eq(g, w)


def test_verify_candidates_and_best_hit(setup, cands):
    s = setup
    W = s["reads"].shape[1] + 3 * K
    want = j_sf.verify_candidates(
        jnp.asarray(s["words"]), s["codes"].size, jnp.asarray(s["reads"]),
        jnp.asarray(s["lengths"]), jnp.asarray(cands), K, W,
    )
    got = sf.verify_candidates(
        _t(s["words"]), s["codes"].size, _t(s["reads"]), _t(s["lengths"]), _t(cands), K, W,
    )
    for g, w in zip(got, want):
        _eq(g, w)
    want_b = j_sf.best_hit(jnp.asarray(cands), jnp.asarray(got[0].numpy()), K)
    got_b = sf.best_hit(_t(cands), got[0], K)
    for g, w in zip(got_b, want_b):
        _eq(g, w)
    assert (got_b.n_good > 0).float().mean() > 0.5


def test_offset_hamming(setup, cands):
    s = setup
    rng = np.random.default_rng(2)
    # candidate estimates, including some near both text ends
    cp = cands[:, 0].copy()
    cp[cp == sf.NO_CAND] = 0
    cp[:4] = [0, 1, s["codes"].size - 50, s["codes"].size - 2]
    cp[4:8] = rng.integers(0, s["codes"].size, size=4)
    want = j_sf.offset_hamming(
        jnp.asarray(s["words"]), s["codes"].size, jnp.asarray(s["reads"]),
        jnp.asarray(s["lengths"]), jnp.asarray(cp.astype(np.int32)), K,
    )
    got = sf.offset_hamming(
        _t(s["words"]), s["codes"].size, _t(s["reads"]), _t(s["lengths"]),
        _t(cp.astype(np.int32)), K,
    )
    for g, w in zip(got, want):
        _eq(g, w)


# ---------------------------------------------------------------- FM path


@pytest.fixture(scope="module")
def fm_setup(setup):
    """Both packages' device FM tables and a 5-mer interval table for the
    setup genome (its tiled repeat gives wide intervals -> overflow)."""
    fm = build_fm_index(setup["codes"], sample_rate=8)
    lo, hi = build_kmer_table(fm, 5)
    return dict(jfm=j_rank.from_host(fm), pfm=rank.from_host(fm), kmer=(lo, hi), j=5)


def _search(s):
    return np.where(s["reads"] >= 4, 0, s["reads"]).astype(np.int32)


@pytest.mark.parametrize("use_kmer,full_cover", [(False, False), (True, False), (True, True)])
def test_piece_interval_search(setup, fm_setup, use_kmer, full_cover):
    s, f = setup, fm_setup
    search = _search(s)
    kw_j = dict(kmer_tab=tuple(jnp.asarray(a) for a in f["kmer"]), kmer_j=f["j"],
                kmer_full_cover=full_cover) if use_kmer else {}
    kw_p = dict(kmer_tab=tuple(_t(a) for a in f["kmer"]), kmer_j=f["j"],
                kmer_full_cover=full_cover) if use_kmer else {}
    want = j_sf.piece_interval_search(
        f["jfm"], jnp.asarray(search), jnp.asarray(s["lengths"]), K + 1, **kw_j
    )
    got = sf.piece_interval_search(f["pfm"], _t(search), _t(s["lengths"]), K + 1, **kw_p)
    for g, w in zip(got, want):
        _eq(g, w)
    lo, hi, _ = got
    assert ((hi - lo) > 8).any() and ((hi - lo) == 1).any()  # repeats and unique pieces


@pytest.mark.parametrize("max_hits,max_cands,slack,use_kmer", [
    (8, 8, 2, False), (2, 5, 1, False), (4, None, 2, True), (16, 8, 1, True),
])
def test_pigeonhole_candidates(setup, fm_setup, max_hits, max_cands, slack, use_kmer):
    s, f = setup, fm_setup
    search = _search(s)
    kw_j = dict(kmer_tab=tuple(jnp.asarray(a) for a in f["kmer"]), kmer_j=f["j"],
                kmer_full_cover=True) if use_kmer else {}
    kw_p = dict(kmer_tab=tuple(_t(a) for a in f["kmer"]), kmer_j=f["j"],
                kmer_full_cover=True) if use_kmer else {}
    want = j_sf.pigeonhole_candidates(
        f["jfm"], jnp.asarray(search), jnp.asarray(s["lengths"]), K + 1, max_hits,
        locate_slack=slack, max_cands=max_cands, **kw_j,
    )
    got = sf.pigeonhole_candidates(
        f["pfm"], _t(search), _t(s["lengths"]), K + 1, max_hits,
        locate_slack=slack, max_cands=max_cands, **kw_p,
    )
    for g, w in zip(got, want):
        _eq(g, w)
    assert got.overflow.any() and (~got.overflow).any()
    # about half the reads come from the reverse strand, which this
    # forward-strand search cannot place
    assert (got.n_cands > 0).float().mean() > 0.4


def test_verify_candidates_myers(setup, cands):
    s = setup
    L = s["reads"].shape[1]
    W = L + 3 * K
    nwords = (L + 31) // 32
    want = j_sf.verify_candidates_myers(
        jnp.asarray(s["words"]), s["codes"].size, jnp.asarray(s["reads"]),
        jnp.asarray(s["lengths"]), jnp.asarray(cands), K, W, nwords,
    )
    got = sf.verify_candidates_myers(
        _t(s["words"]), s["codes"].size, _t(s["reads"]), _t(s["lengths"]), _t(cands),
        K, W, nwords,
    )
    _eq(got, want)
    assert (got <= K).any() and (got == sf.dp_ops.INF).any()
