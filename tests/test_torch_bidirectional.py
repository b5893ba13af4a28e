"""The port's bidirectional BWT search (``models/bidirectional.py``) against
naive occurrence counting and against the JAX package's: the host oracle,
single-character extensions and the all-4 extensions, exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genome_weaver_align_tpu.index import native as j_native
from genome_weaver_align_tpu.index.build import build_fm_index
from genome_weaver_align_tpu.models import bidirectional as j_bd
from genome_weaver_align_tpu_torch.models import bidirectional as bd
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _jax_native_off():
    """The index comes from the JAX package's numpy SA builder, never from
    its in-place ``make -C native``."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_native, "_lib", None)
        mp.setattr(j_native, "_build_failed", True)
        yield


def naive_count(text, pat):
    n, m = text.size, pat.size
    if m == 0:
        return n + 1
    return sum(1 for i in range(n - m + 1) if np.array_equal(text[i : i + m], pat))


@pytest.fixture(scope="module")
def setup():
    codes = np.random.default_rng(7).integers(0, 4, size=800, dtype=np.uint8)
    fwd = build_fm_index(codes, sample_rate=8)
    rev = build_fm_index(codes[::-1].copy(), sample_rate=8)
    return codes, fwd, rev


@pytest.mark.parametrize("seed", range(6))
def test_host_bidir_extensions(setup, seed):
    """The port's host oracle tracks (pattern, reversed pattern) and equals
    the JAX oracle step for step."""
    codes, fwd, rev = setup
    rng = np.random.default_rng(seed)
    bi, jbi = bd.HostBiIndex(fwd, rev), j_bd.HostBiIndex(fwd, rev)
    L = 16
    p0 = int(rng.integers(0, codes.size - L))
    left = right = p0 + L // 2  # current pattern = codes[left:right]
    st = bi.init()
    assert st == jbi.init()
    for _ in range(L):
        if (rng.random() < 0.5 and left > p0) or right >= p0 + L:
            left -= 1
            c = int(codes[left])
            want = jbi.extend_backward(st, c)
            st = bi.extend_backward(st, c)
        else:
            right += 1
            c = int(codes[right - 1])
            want = jbi.extend_forward(st, c)
            st = bi.extend_forward(st, c)
        assert tuple(st) == tuple(want)
        pat = codes[left:right]
        lo, hi, rlo, rhi = st
        assert hi - lo == rhi - rlo == naive_count(codes, pat)
        if hi > lo:
            pos = sorted(int(x) for x in fwd.locate(np.arange(lo, hi)))
            assert pos == [i for i in range(codes.size - pat.size + 1)
                           if np.array_equal(codes[i : i + pat.size], pat)]


def test_device_matches_host_and_jax(setup):
    """Random walks of 32 lanes, backward or forward per lane per step: the
    port's device extensions equal the host oracle and the JAX device
    extensions."""
    codes, fwd, rev = setup
    bi_h = bd.HostBiIndex(fwd, rev)
    bi_d = bd.from_host_bi(fwd, rev, CPU)
    jbi = j_bd.from_host_bi(fwd, rev)
    rng = np.random.default_rng(3)
    B = 32
    sts_h = [bi_h.init() for _ in range(B)]
    st_d = bd.init_interval(fwd.n, (B,), CPU)
    st_j = j_bd.init_interval(fwd.n, (B,))
    for step in range(12):
        cs = rng.integers(0, 4, size=B)
        dirs = rng.integers(0, 2, size=B)
        for i in range(B):
            f = bi_h.extend_backward if dirs[i] else bi_h.extend_forward
            sts_h[i] = f(sts_h[i], int(cs[i]))
        c = torch.from_numpy(cs.astype(np.int32))
        sel = torch.from_numpy(dirs.astype(bool))
        st_d = bd.BiInterval(*[torch.where(sel, b, f) for b, f in zip(
            bd.extend_backward(bi_d, st_d, c), bd.extend_forward(bi_d, st_d, c))])
        jc, jsel = jnp.asarray(cs, jnp.int32), jnp.asarray(dirs, bool)
        st_j = j_bd.BiInterval(*[jnp.where(jsel, b, f) for b, f in zip(
            j_bd.extend_backward(jbi, st_j, jc), j_bd.extend_forward(jbi, st_j, jc))])
        got = np.stack([x.numpy() for x in st_d], axis=1)
        assert np.array_equal(got, np.array(sts_h)), f"step {step}"
        assert np.array_equal(got, np.stack([np.asarray(x) for x in st_j], axis=1))
        assert all(x.dtype == torch.int32 for x in st_d)


def test_extend_all4_matches_single_and_jax(setup):
    """The all-4 extenders equal the single-character ones at every code and
    the JAX all-4 extenders, on (B,) and (B, S) interval shapes, with a
    (B, 1) code column broadcast over S (as the one-mismatch branches do)."""
    codes, fwd, rev = setup
    bi_d = bd.from_host_bi(fwd, rev, CPU)
    jbi = j_bd.from_host_bi(fwd, rev)
    rng = np.random.default_rng(5)
    st = bd.init_interval(fwd.n, (8,), CPU)
    for _ in range(6):
        c = torch.from_numpy(rng.integers(0, 4, size=8).astype(np.int32))
        jst = j_bd.BiInterval(*[jnp.asarray(f.numpy()) for f in st])
        for dev_all4, dev_one, jax_all4 in (
            (bd.extend_backward_all4, bd.extend_backward, j_bd.extend_backward_all4),
            (bd.extend_forward_all4, bd.extend_forward, j_bd.extend_forward_all4),
        ):
            all4, one = dev_all4(bi_d, st), dev_one(bi_d, st, c)
            for f_all, f_one, f_jax in zip(all4, one, jax_all4(jbi, jst)):
                assert torch.equal(torch.gather(f_all, 1, c[:, None].long())[:, 0], f_one)
                assert np.array_equal(f_all.numpy(), np.asarray(f_jax))
            # (B, S) intervals with a (B, 1) code column
            st2 = bd.BiInterval(*[f[:, :3] for f in all4])
            got = dev_one(bi_d, st2, c[:, None])
            for s in range(3):
                col = dev_one(bi_d, bd.BiInterval(*[f[:, s] for f in st2]), c)
                assert all(torch.equal(a[:, s], b) for a, b in zip(got, col))
        st = bd.extend_backward(bi_d, st, c)
