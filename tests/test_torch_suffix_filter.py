"""Each seed-path suffix-filter function of the port equals its JAX twin on
the same inputs (exact equality: the pipeline is integer-only)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from genome_weaver_align_tpu.index import native as j_native
from genome_weaver_align_tpu.index.seedtable import build_seed_table
from genome_weaver_align_tpu.models import suffix_filter as j_sf
from genome_weaver_align_tpu.utils import packing
from genome_weaver_align_tpu.utils.simulate import simulate_reads_array
from genome_weaver_align_tpu_torch.models import suffix_filter as sf

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
