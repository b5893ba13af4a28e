"""The port's wavelet rank backend (``index/wavelet.py``) against naive
counting, the occurrence table, the JAX package's ``WaveletRank``,
``device_rank`` and ``exact_search_wavelet`` on the same inputs, and the
port's fused-row exact search."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genome_weaver_align_tpu.index import wavelet as j_wavelet
from genome_weaver_align_tpu_torch.index import wavelet
from genome_weaver_align_tpu_torch.index.build import build_fm_index
from genome_weaver_align_tpu_torch.index.wavelet import WaveletRank
from genome_weaver_align_tpu_torch.models import exact
from genome_weaver_align_tpu_torch.ops import rank
from genome_weaver_align_tpu_torch.utils import packing
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("n,seed", [(1, 0), (63, 1), (128, 2), (1000, 3), (5000, 4)])
def test_wavelet_rank_vs_naive_and_jax(n, seed):
    codes = np.random.default_rng(seed).integers(0, 4, size=n, dtype=np.uint8)
    w, jw = WaveletRank(codes), j_wavelet.WaveletRank(codes)
    ks = np.arange(n + 1)
    for c in range(4):
        expect = np.concatenate([[0], np.cumsum(codes == c)])
        assert np.array_equal(w.rank(c, ks), expect), f"c={c}"
        assert np.array_equal(w.rank(c, ks), jw.rank(c, ks)), f"c={c}"
    a, ja = w.device_arrays(), jw.device_arrays()
    assert a.keys() == ja.keys()
    for key in a:
        assert np.array_equal(a[key], ja[key]) and np.asarray(a[key]).dtype == np.asarray(ja[key]).dtype
    assert (w.z0, w.z1_left) == (jw.z0, jw.z1_left)


def test_wavelet_matches_occ_table():
    codes = np.random.default_rng(9).integers(0, 4, size=3000, dtype=np.uint8)
    fm = build_fm_index(codes)
    w = WaveletRank(packing.unpack(fm.bwt_words, fm.n))
    ks = np.random.default_rng(1).integers(0, fm.n + 1, size=200)
    for c in range(4):
        assert np.array_equal(w.rank(c, ks), fm.occ_packed(c, ks))


def test_device_wavelet_rank_matches_host_and_jax():
    """``to_device``/``device_rank`` on the CPU against the host rank and
    the JAX twin: one code for all lanes, including i = 0 and i = n, then a
    code a lane (the backward search's access pattern)."""
    rng = np.random.default_rng(11)
    codes = rng.integers(0, 4, size=4097, dtype=np.uint8)
    w = WaveletRank(codes)
    dw = wavelet.to_device(w, device="cpu")
    jdw = j_wavelet.to_device(j_wavelet.WaveletRank(codes))
    assert dw.l0_words.dtype == torch.int32 and dw.n == codes.size
    ks = np.concatenate([[0, codes.size], rng.integers(0, codes.size + 1, 300)])
    for c in range(4):
        got = wavelet.device_rank(dw, torch.full((ks.size,), c), torch.from_numpy(ks)).numpy()
        assert np.array_equal(got, w.rank(c, ks)), f"c={c}"
        jgot = j_wavelet.device_rank(jdw, jnp.full(ks.size, c, jnp.int32), jnp.asarray(ks))
        assert np.array_equal(got, np.asarray(jgot))
    cs = rng.integers(0, 4, size=ks.size)
    want = np.array([w.rank(int(c), int(k))[0] for c, k in zip(cs, ks)])
    got = wavelet.device_rank(dw, torch.from_numpy(cs), torch.from_numpy(ks))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert np.array_equal(
        got.numpy(), np.asarray(j_wavelet.device_rank(jdw, jnp.asarray(cs), jnp.asarray(ks))))
    # a (B, 2) lane shape, as lo and hi stacked
    got2 = wavelet.device_rank(dw, torch.from_numpy(cs.reshape(-1, 2)),
                               torch.from_numpy(ks.reshape(-1, 2)))
    assert np.array_equal(got2.numpy().ravel(), want)


def _search_inputs(seed, B, L):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=5000, dtype=np.uint8)
    fm = build_fm_index(codes, sample_rate=8)
    starts = rng.integers(0, codes.size - L, size=B)
    reads = np.stack([codes[s : s + L] for s in starts]).astype(np.int32)
    reads[::5] = rng.integers(0, 4, size=(reads[::5].shape[0], L))  # misses
    lengths = np.full(B, L, np.int32)
    lengths[::7] = L - 5
    lengths[3] = 0
    return fm, reads, lengths


@pytest.mark.parametrize("seed,B,L", [(3, 32, 24), (4, 65, 40)])
def test_exact_search_wavelet_equals_fused_and_jax(seed, B, L):
    """The whole backward search on the wavelet backend: the same (lo, hi)
    as the port's fused-row search and as the JAX wavelet search, for hit
    and miss reads, short and empty ones."""
    fm, reads, lengths = _search_inputs(seed, B, L)
    dw = wavelet.to_device(WaveletRank(packing.unpack(fm.bwt_words, fm.n)), device="cpu")
    r, ln = torch.from_numpy(reads), torch.from_numpy(lengths)
    lo, hi = wavelet.exact_search_wavelet(
        dw, torch.from_numpy(fm.C.astype(np.int32)), int(fm.primary), r, ln)
    assert lo.dtype == hi.dtype == torch.int32
    flo, fhi = exact.exact_interval_search(rank.from_host(fm, "cpu"), r, ln)
    assert torch.equal(lo, flo) and torch.equal(hi, fhi)
    jlo, jhi = j_wavelet.exact_search_wavelet(
        j_wavelet.to_device(j_wavelet.WaveletRank(packing.unpack(fm.bwt_words, fm.n))),
        jnp.asarray(fm.C.astype(np.int32)), jnp.int32(fm.primary),
        jnp.asarray(reads), jnp.asarray(lengths))
    assert np.array_equal(lo.numpy(), np.asarray(jlo)) and np.array_equal(hi.numpy(), np.asarray(jhi))
    assert int((hi > lo).sum()) > B // 2 and int((hi <= lo).sum()) > 0
