"""The port's ring merges (``parallel/ring.py``): the plain ring sum against
``x.sum(0)``, the plain fused rank + ring and the sharded index's
``fused_occ_plain`` against the JAX package's ``psum(local_occ_codes)`` on
the 8-device CPU mesh, and the dispatch rules
(CPU tensors to the plain versions, no CPU tensor into the CUDA wrapper,
a missing nvcc named).  The JAX ring kernels themselves are held to
``psum`` by ``tests/test_ring.py``; the CUDA kernels to the plain versions
by ``tests/test_torch_cuda.py`` on the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from genome_weaver_align_tpu.index import native as j_native
from genome_weaver_align_tpu.index.build import build_fm_index
from genome_weaver_align_tpu.parallel import sharded_index as j_si
from genome_weaver_align_tpu_torch.ops import ring_cuda
from genome_weaver_align_tpu_torch.parallel import ring
from genome_weaver_align_tpu_torch.parallel import sharded_index as si


@pytest.fixture(scope="module", autouse=True)
def _jax_native_off():
    """The index comes from the JAX package's numpy SA builder, never from
    its in-place ``make -C native``."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_native, "_lib", None)
        mp.setattr(j_native, "_build_failed", True)
        yield


@pytest.mark.parametrize("S", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("shape", [(3,), (2, 5), (1024,), (2, 3, 7)])
def test_ring_psum_plain_is_the_sum(S, shape):
    rng = np.random.default_rng(S * 100 + len(shape))
    xi = torch.from_numpy(rng.integers(-(1 << 20), 1 << 20, size=(S,) + shape, dtype=np.int32))
    got = ring.ring_psum(xi)
    assert got.shape == xi.shape and got.dtype == torch.int32
    for d in range(S):
        assert torch.equal(got[d], xi.sum(0, dtype=torch.int32))
    xf = torch.from_numpy(rng.standard_normal(size=(S,) + shape).astype(np.float32))
    gotf = ring.ring_psum(xf)
    for d in range(S):
        torch.testing.assert_close(gotf[d], xf.sum(0), rtol=1e-6, atol=1e-6)


def test_ring_psum_plain_adds_in_ring_order():
    """Shard d adds x_{d-1}, x_{d-2}, ... in turn: float32 results differ
    between shards exactly as that order rounds."""
    x = torch.tensor([[1.0], [1e8], [-1e8], [1.0]], dtype=torch.float32)
    got = ring.ring_psum_plain(x)[:, 0].tolist()
    want = []
    for d in range(4):
        acc = torch.tensor(x[d, 0].item(), dtype=torch.float32)
        for s in range(1, 4):
            acc = acc + x[(d - s) % 4, 0]
        want.append(acc.item())
    assert got == want


def test_ring_psum_rejects_other_dtypes():
    with pytest.raises(TypeError, match="int32 or float32"):
        ring.ring_psum(torch.zeros((2, 4), dtype=torch.int64))


def _mesh(n):
    return jax.make_mesh((n,), ("i",), devices=jax.devices("cpu")[:n])


@pytest.mark.parametrize("n,M", [(1, 2), (2, 2), (4, 2), (4, 3), (8, 2)])
def test_fused_rank_ring_plain_matches_jax_psum(n, M):
    rng = np.random.default_rng(3 * n + M)
    fm = build_fm_index(rng.integers(0, 4, size=1500, dtype=np.uint8), sample_rate=16)
    jsh = j_si.shard_fm_index(fm, n)
    sh_dev = j_si.put_sharded(jsh, _mesh(n), "i")
    Q = 96
    qk = rng.integers(0, fm.n + 1, size=(M, Q)).astype(np.int32)
    # the shard edges, the sentinel's row and both ends among the queries
    edges = np.concatenate([jsh.pk_start, jsh.pk_end, [fm.primary, 0, fm.n, fm.n + 1]])
    edges = np.clip(np.concatenate([edges, edges - 1, edges + 1]), 0, fm.n + 1)[:Q]
    qk[:, : edges.size] = edges
    qc = rng.integers(0, 4, size=(M, Q)).astype(np.int32)

    def f(shl):
        shl = j_si.squeeze_local(shl)
        return jnp.stack([
            jax.lax.psum(j_si.local_occ_codes(shl, jnp.asarray(qc[m]), jnp.asarray(qk[m])), "i")
            for m in range(M)
        ])[None]

    fn = jax.jit(jax.shard_map(f, mesh=_mesh(n), in_specs=(j_si.index_specs("i", jsh),),
                               out_specs=P("i"), check_vma=False))
    want = np.asarray(fn(sh_dev))  # (n, M, Q)

    psh = si.put_sharded(si.shard_fm_index(fm, n), "cpu")
    g = [si.local_occ_gather(psh, torch.from_numpy(qc[m]), torch.from_numpy(qk[m]))
         for m in range(M)]
    words, roff, base, own = (torch.stack([x[f] for x in g], dim=1) for f in range(4))
    codes = torch.from_numpy(qc)[None].expand(n, M, Q)
    all_shards = ring.fused_rank_ring_plain(words, codes, roff, base, own)
    for d in range(n):
        assert np.array_equal(all_shards[d].numpy(), want[d]), (n, M, d)
    assert torch.equal(ring.fused_rank_ring(words, codes, roff, base, own), all_shards[0])
    # the table entry's plain twin: rows read from the shard tables
    occ = si.fused_occ(psh, torch.from_numpy(qc), torch.from_numpy(qk))
    assert torch.equal(occ, si.fused_occ_plain(psh, torch.from_numpy(qc), torch.from_numpy(qk)))
    assert np.array_equal(occ.numpy(), want[0]), (n, M)


def test_cpu_tensors_take_the_plain_versions(monkeypatch):
    def kernel_called(*a, **kw):
        raise AssertionError("CPU tensors must not reach the CUDA wrapper")

    monkeypatch.setattr(ring_cuda, "ring_allreduce_cuda", kernel_called)
    monkeypatch.setattr(ring_cuda, "fused_rank_ring_cuda", kernel_called)
    monkeypatch.setattr(ring_cuda, "fused_occ_cuda", kernel_called)
    x = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    assert torch.equal(ring.ring_psum(x), ring.ring_psum_plain(x))
    w = torch.zeros((2, 1, 5, 8), dtype=torch.int32)
    z = torch.zeros((2, 1, 5), dtype=torch.int32)
    # roff 0 counts no bases: each of the 2 shards owns with base 3
    got = ring.fused_rank_ring(w, z, z, z + 3, z + 1)
    assert torch.equal(got, torch.full((1, 5), 6, dtype=torch.int32))
    fm = build_fm_index(np.arange(300, dtype=np.uint8) % 4, sample_rate=16)
    sh = si.put_sharded(si.shard_fm_index(fm, 2), "cpu")
    k = torch.arange(fm.n + 2, dtype=torch.int32)
    assert torch.equal(si.fused_occ(sh, k % 4, k), si.occ_codes(sh, k % 4, k))


def test_cuda_wrappers_reject_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        ring_cuda.ring_allreduce_cuda(torch.zeros((2, 8), dtype=torch.int32))
    z = torch.zeros((2, 1, 5), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        ring_cuda.fused_rank_ring_cuda(torch.zeros((2, 1, 5, 8), dtype=torch.int32), z, z, z, z)
    s = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        ring_cuda.fused_occ_cuda(torch.zeros((2, 3, 8), dtype=torch.int32),
                                 torch.zeros((2, 3, 4), dtype=torch.int32), s, s, 0, z, z)
    assert ring_cuda.ring_allreduce_cuda.launches == 0
    assert ring_cuda.fused_rank_ring_cuda.launches == 0
    assert ring_cuda.fused_occ_cuda.launches == 0


def test_ring_loader_names_missing_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))  # a toolkit dir without nvcc
    ring_cuda._library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc"):
            ring_cuda._library()
    finally:
        ring_cuda._library.cache_clear()
