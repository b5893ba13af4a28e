"""The port's FM-index primitives (``ops/rank.py``) against the JAX package's
on one index: bit-identical occ, LF, backward search and locate, with the
rows around the primary row and the last rows covered."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from genome_weaver_align_tpu.index import native as j_native
from genome_weaver_align_tpu.index.build import build_fm_index
from genome_weaver_align_tpu.ops import rank as j_rank
from genome_weaver_align_tpu_torch.ops import rank


@pytest.fixture(scope="module", autouse=True)
def _jax_native_off():
    """The index comes from the JAX package's numpy SA builder here, never
    from its in-place ``make -C native``: test workers running that make at
    once can load a half-written library."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_native, "_lib", None)
        mp.setattr(j_native, "_build_failed", True)
        yield


@pytest.fixture(scope="module", params=[8, 16])
def fms(request):
    """One ~20 kbp random genome per sample rate, both packages' tables."""
    codes = np.random.default_rng(40).integers(0, 4, size=20_011, dtype=np.uint8)
    fm = build_fm_index(codes, sample_rate=request.param, keep_full_sa=True)
    return fm, j_rank.from_host(fm), rank.from_host(fm, "cpu")


def _rows(fm, rng, size=3000):
    """Random rows in [0, n] plus the edges: 0, 1, primary +- 1, n, and
    n + 1 (sentinel-inclusive coordinates reach n + 1)."""
    p = fm.primary
    edges = [0, 1, p - 1, p, p + 1, fm.n - 1, fm.n, fm.n + 1]
    edges = [e for e in edges if 0 <= e <= fm.n + 1]
    return np.concatenate([edges, rng.integers(0, fm.n + 1, size=size)]).astype(np.int32)


def _eq(got: torch.Tensor, want):
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.array_equal(got.numpy(), want.astype(got.numpy().dtype))


def test_device_tables_identical(fms):
    _, jfm, pfm = fms
    for name in ("blocks", "C", "mark_blocks", "mark_cp", "ssa_values", "full_sa"):
        _eq(getattr(pfm, name), np.asarray(getattr(jfm, name)).view(np.int32)
            if np.asarray(getattr(jfm, name)).dtype == np.uint32 else getattr(jfm, name))
    assert pfm.primary == int(jfm.primary) and pfm.n == jfm.n


def test_from_arrays_equals_from_host(fms):
    fm, _, pfm = fms
    marks = fm.ssa_marks
    got = rank.from_arrays(
        rank.fuse_blocks(fm.bwt_words, fm.occ_cp), fm.C, fm.primary,
        marks._wpad.reshape(-1, rank.MARK_WORDS_PER_BLOCK), marks.checkpoints,
        fm.ssa_values, fm.n, fm.sample_rate, device="cpu",
    )
    for name in ("blocks", "C", "mark_blocks", "mark_cp", "ssa_values"):
        assert torch.equal(getattr(got, name), getattr(pfm, name)), name
    assert got.full_sa is None and got.primary == pfm.primary


def test_occ_codes_and_occ_all4(fms):
    fm, jfm, pfm = fms
    rng = np.random.default_rng(1)
    k = _rows(fm, rng)
    codes = rng.integers(0, 4, size=k.size).astype(np.int32)
    _eq(rank.occ_codes(pfm, torch.from_numpy(codes), torch.from_numpy(k)),
        j_rank.occ_codes(jfm, jnp.asarray(codes), jnp.asarray(k)))
    _eq(rank.occ_all4(pfm, torch.from_numpy(k)), j_rank.occ_all4(jfm, jnp.asarray(k)))
    # and against the numpy oracle, one code at a time
    all4 = rank.occ_all4(pfm, torch.from_numpy(k)).numpy()
    for c in range(4):
        assert np.array_equal(all4[:, c], fm.occ(c, k))


def test_backward_step(fms):
    fm, jfm, pfm = fms
    rng = np.random.default_rng(2)
    lo = _rows(fm, rng)
    hi = np.minimum(lo + rng.integers(0, 50, size=lo.size), fm.n + 1).astype(np.int32)
    codes = rng.integers(0, 4, size=lo.size).astype(np.int32)
    got = rank.backward_step(pfm, *(torch.from_numpy(a) for a in (codes, lo, hi)))
    want = j_rank.backward_step(jfm, *(jnp.asarray(a) for a in (codes, lo, hi)))
    for g, w in zip(got, want):
        _eq(g, w)


def test_lf_and_bwt_char(fms):
    fm, jfm, pfm = fms
    rng = np.random.default_rng(3)
    i = _rows(fm, rng)
    i = i[(i != fm.primary) & (i <= fm.n)]  # LF is defined off the $ row
    ti, ji = torch.from_numpy(i), jnp.asarray(i)
    _eq(rank.bwt_char(pfm, ti), j_rank.bwt_char(jfm, ji))
    _eq(rank.lf(pfm, ti), j_rank.lf(jfm, ji))
    _eq(rank.lf_fused(pfm, ti), j_rank.lf_fused(jfm, ji))
    assert np.array_equal(rank.lf_fused(pfm, ti).numpy(), fm.lf(i))


def test_mark_rank(fms):
    fm, jfm, pfm = fms
    i = np.arange(fm.n + 1, dtype=np.int32)
    _eq(rank._mark_get(pfm, torch.from_numpy(i)), j_rank._mark_get(jfm, jnp.asarray(i)))
    _eq(rank._mark_rank1(pfm, torch.from_numpy(i)), j_rank._mark_rank1(jfm, jnp.asarray(i)))


@pytest.mark.parametrize("full_sa", [False, True])
def test_locate(fms, full_sa):
    fm, jfm, pfm = fms
    if not full_sa:
        pfm = rank.DeviceFMIndex(**{**pfm.__dict__, "full_sa": None})
        jfm = j_rank.from_host(
            type(fm)(**{**fm.__dict__, "full_sa": None})
        )
    rows = np.arange(fm.n + 1, dtype=np.int32)  # every row, primary included
    got = rank.locate(pfm, torch.from_numpy(rows))
    _eq(got, j_rank.locate(jfm, jnp.asarray(rows)))
    assert np.array_equal(got.numpy(), fm.full_sa)  # the suffix array itself


def test_popcount_matches_numpy():
    rng = np.random.default_rng(4)
    words = np.concatenate([[0, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF, 1],
                            rng.integers(0, 2**32, size=5000)]).astype(np.uint32)
    want = np.array([bin(int(w)).count("1") for w in words])
    got = rank._popcount(torch.from_numpy(words.view(np.int32))).numpy()
    assert np.array_equal(got, want)
