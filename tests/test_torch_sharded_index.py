"""The port's interval-sharded index (``parallel/sharded_index.py``) against
the JAX package's: the host split array for array, every occ value through
the sum merge, and the sharded exact search (psum, and the ring and fused
merges through their plain versions, microbatch 1 and 2) equal to the JAX
``make_sharded_exact_search`` psum path on the 8-device CPU mesh."""

import numpy as np
import pytest
import torch

from genome_weaver_align_tpu.index import native as j_native
from genome_weaver_align_tpu.index.build import build_fm_index
from genome_weaver_align_tpu.parallel import mesh as j_mesh
from genome_weaver_align_tpu.parallel import sharded_index as j_si
from genome_weaver_align_tpu_torch.parallel import mesh as pmesh
from genome_weaver_align_tpu_torch.parallel import sharded_index as si


@pytest.fixture(scope="module", autouse=True)
def _jax_native_off():
    """The index comes from the JAX package's numpy SA builder, never from
    its in-place ``make -C native``."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_native, "_lib", None)
        mp.setattr(j_native, "_build_failed", True)
        yield


@pytest.fixture(scope="module")
def setup():
    codes = np.random.default_rng(31).integers(0, 4, size=5000, dtype=np.uint8)
    return codes, build_fm_index(codes, sample_rate=16)


@pytest.mark.parametrize("n_shards", [1, 2, 3, 4, 8])
def test_shard_fm_index_equals_jax(setup, n_shards):
    _, fm = setup
    want = j_si.shard_fm_index(fm, n_shards)
    got = si.shard_fm_index(fm, n_shards)
    for f in (*si._STACKED, "C"):
        a, b = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert got.primary == int(want.primary)
    assert (got.n, got.sample_rate, got.n_shards) == (want.n, want.sample_rate, want.n_shards)


@pytest.mark.parametrize("n_shards", [3, 4])
def test_sharded_occ_all_positions(setup, n_shards):
    """Every occ value and every BWT char over the whole coordinate range,
    through the sum merge."""
    _, fm = setup
    sh = si.put_sharded(si.shard_fm_index(fm, n_shards), "cpu")
    ks = torch.arange(fm.n + 2, dtype=torch.int32)
    for c in range(4):
        got = si.occ_codes(sh, torch.full_like(ks, c), ks)
        assert np.array_equal(got.numpy(), fm.occ(c, np.arange(fm.n + 2))), c
    all4 = si.default_merge(si.local_occ_all4(sh, ks))
    for c in range(4):
        assert np.array_equal(all4[:, c].numpy(), fm.occ(c, np.arange(fm.n + 2)))


@pytest.mark.parametrize("n_data,n_interval", [(2, 4), (1, 8), (4, 2)])
def test_sharded_exact_search_matches_jax(setup, n_data, n_interval):
    codes, fm = setup
    rng = np.random.default_rng(1)
    B, L = 16 * n_data + 2, 28  # not a multiple of n_data: padding
    reads = np.zeros((B, L), dtype=np.int32)
    lengths = rng.integers(L - 6, L + 1, size=B).astype(np.int32)
    for i in range(B):
        p = int(rng.integers(0, codes.size - L))
        reads[i] = codes[p : p + L]
    reads[::5, 3] = (reads[::5, 3] + 1) % 4  # some reads with no exact match

    jm = j_mesh.make_mesh(n_data=n_data, n_interval=n_interval)
    jsh = j_si.put_sharded(j_si.shard_fm_index(fm, n_interval), jm, j_mesh.INTERVAL_AXIS)
    jfn = j_si.make_sharded_exact_search(
        jm, j_mesh.INTERVAL_AXIS, j_mesh.DATA_AXIS, max_len=L, like=jsh
    )
    r, l, _ = j_mesh.shard_reads(jm, reads, lengths)
    want = [np.asarray(v)[:B] for v in jfn(jsh, r, l)]
    assert (want[1] > want[0]).sum() > B // 2

    layout = pmesh.make_layout(n_data, n_interval, "cpu")
    sh = si.put_sharded(si.shard_fm_index(fm, n_interval), "cpu")
    r, l, nb = pmesh.shard_reads(layout, reads, lengths)
    assert nb == B and r.shape[0] % n_data == 0
    for merge in ("psum", "ring", "fused"):
        for mb in (1, 2):
            fn = si.make_sharded_exact_search(layout, L, sh, merge=merge, microbatch=mb)
            got = [v.numpy()[:B] for v in fn(sh, r, l)]
            for a, b, name in zip(got, want, ("lo", "hi", "pos")):
                assert np.array_equal(a, b), (merge, mb, name)


def test_ring_merges_reach_the_ring(setup, monkeypatch):
    """merge="ring" merges every extension step of every chunk through
    ``ring.ring_psum``; merge="fused" once per step through the table entry
    ``sharded_index.fused_occ``, with every chunk's lo and hi queries."""
    codes, fm = setup
    from genome_weaver_align_tpu_torch.parallel import ring

    calls = {"ring": 0, "fused": 0}
    real_psum, real_fused = ring.ring_psum, si.fused_occ

    def count(name, real):
        def f(*a, **kw):
            calls[name] += 1
            return real(*a, **kw)
        return f

    monkeypatch.setattr(ring, "ring_psum", count("ring", real_psum))
    monkeypatch.setattr(si, "fused_occ", count("fused", real_fused))
    layout = pmesh.make_layout(1, 4, "cpu")
    sh = si.put_sharded(si.shard_fm_index(fm, 4), "cpu")
    reads = np.stack([codes[i : i + 20] for i in range(0, 800, 100)]).astype(np.int32)
    r, l, _ = pmesh.shard_reads(layout, reads, np.full(8, 20, np.int32))
    si.make_sharded_exact_search(layout, 20, sh, merge="ring", microbatch=2)(sh, r, l)
    si.make_sharded_exact_search(layout, 20, sh, merge="fused", microbatch=2)(sh, r, l)
    assert calls == {"ring": 20 * 2, "fused": 20}
