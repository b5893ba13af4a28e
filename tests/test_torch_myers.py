"""The port's plain Myers bit-parallel engine (``ops/myers.py``) against the
JAX package's jnp engine and its Pallas kernel in interpret mode: (best,
end) bit-identical on mixed streams (planted edits, junk rows, N codes,
ragged and zero lengths); the text entry's plain version against the jnp
engine on JAX-gathered windows."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from genome_weaver_align_tpu.ops import myers as j_myers
from genome_weaver_align_tpu.ops import myers_pallas
from genome_weaver_align_tpu.ops import window as j_window
from genome_weaver_align_tpu.utils import packing
from genome_weaver_align_tpu_torch.ops import myers, myers_cuda
from tests.streams import mixed_stream

# the shapes of tests/test_myers_pallas.py, then its non-lane-multiple case
SHAPES = [(600, 100, 112, 2), (300, 150, 174, 4), (64, 33, 60, 1), (128, 256, 280, 3),
          (133, 70, 83, 2)]


def _inputs(S, L, W, k):
    rng = np.random.default_rng(S + L)
    reads, lens, wins = mixed_stream(rng, S, L, W, k)
    lens[3::17] = 0  # zero-length lanes give (0, 0)
    return reads, lens.astype(np.int32), wins


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("S,L,W,k", SHAPES)
def test_plain_matches_jax_engines(S, L, W, k):
    reads, lens, wins = _inputs(S, L, W, k)
    nwords = -(-L // 32)
    got_b, got_e = myers.myers_semiglobal_end(*_t(reads, lens, wins), nwords)
    want_b, want_e = j_myers.myers_semiglobal_end(
        jnp.asarray(reads), jnp.asarray(lens), jnp.asarray(wins), nwords
    )
    assert np.array_equal(got_b.numpy(), np.asarray(want_b))
    assert np.array_equal(got_e.numpy(), np.asarray(want_e))
    pal_b, pal_e = myers_pallas.myers_semiglobal_pallas(
        jnp.asarray(reads), jnp.asarray(lens), jnp.asarray(wins), interpret=True, lanes=128,
    )
    assert np.array_equal(got_b.numpy(), np.asarray(pal_b))
    assert np.array_equal(got_e.numpy(), np.asarray(pal_e))
    assert np.all(got_b.numpy()[lens == 0] == 0) and np.all(got_e.numpy()[lens == 0] == 0)
    best = myers.myers_semiglobal(*_t(reads, lens, wins), nwords)
    assert np.array_equal(best.numpy(), np.asarray(
        j_myers.myers_semiglobal(jnp.asarray(reads), jnp.asarray(lens), jnp.asarray(wins), nwords)
    ))


@pytest.mark.parametrize("max_window", [40, 90])
def test_max_window_matches_jax(max_window):
    """A step count below and beyond W (past W the JAX loop's clamped index
    reads the last column again)."""
    reads, lens, wins = _inputs(90, 60, 70, 2)
    got = myers.myers_semiglobal_end(*_t(reads, lens, wins), 2, max_window)
    want = j_myers.myers_semiglobal_end(
        jnp.asarray(reads), jnp.asarray(lens), jnp.asarray(wins), 2, max_window
    )
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("seed,L,W", [(0, 100, 140), (1, 64, 90), (2, 150, 183)])
def test_text_entry_plain_matches_jax(seed, L, W):
    """Lane q runs read rid[q] against the text at starts[q] with columns >=
    valid[q] set to 4: starts off both text ends and at word edges,
    valid < W, repeated rids, planted reads, N codes, ragged lengths."""
    rng = np.random.default_rng(seed)
    n, B, Q = 4001, 60, 300
    codes = rng.integers(0, 4, size=n, dtype=np.uint8)
    words = packing.pack(codes)
    rid = rng.integers(0, B, size=Q).astype(np.int32)  # repeated, unsorted
    starts = rng.integers(-W, n + 10, size=Q).astype(np.int32)
    edges = [-W - 3, -40, -1, 0, 15, 16, 17, n - W, n - 5, n, n + 7]
    starts[: len(edges)] = edges
    reads = rng.integers(0, 5, size=(B, L)).astype(np.int8)
    for q in range(len(edges), Q, 3):  # plant the read (and a substitution)
        seg = codes[max(starts[q] + 5, 0) : max(starts[q] + 5 + L, 0)].astype(np.int8)
        reads[rid[q], : seg.size] = seg
        reads[rid[q], rng.integers(0, L)] = rng.integers(0, 4)
    lengths = np.where(rng.random(B) < 0.7, L, rng.integers(0, L + 1, size=B)).astype(np.int32)
    lengths[::13] = 0
    valid = np.where(rng.random(Q) < 0.5, W, rng.integers(-3, W + 1, size=Q)).astype(np.int32)
    nwords = -(-L // 32)
    got = myers.myers_semiglobal_text(
        torch.from_numpy(words.view(np.int32)), n, *_t(starts, reads, lengths, rid, valid),
        W, nwords)
    wins = np.asarray(j_window.gather_windows(jnp.asarray(words), n, jnp.asarray(starts), W))
    wins = np.where(np.arange(W)[None, :] >= valid[:, None], 4, wins).astype(np.int32)
    want = j_myers.myers_semiglobal_end(
        jnp.asarray(reads[rid].astype(np.int32)), jnp.asarray(lengths[rid]), jnp.asarray(wins),
        nwords)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert (got[0].numpy() <= 2).sum() > Q // 10  # planted lanes are found


def test_int8_inputs_and_build_eq():
    reads, lens, wins = _inputs(100, 64, 80, 2)
    got = myers.myers_semiglobal_end(*_t(reads.astype(np.int8), lens, wins.astype(np.int8)), 2)
    want = myers.myers_semiglobal_end(*_t(reads, lens, wins), 2)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    eq = myers.build_eq(*_t(reads, lens), 2)
    j_eq = j_myers.build_eq(jnp.asarray(reads), jnp.asarray(lens), 2)
    assert np.array_equal(eq.numpy(), np.asarray(j_eq).view(np.int32))


def test_add_with_carry_matches_unsigned():
    rng = np.random.default_rng(7)
    a = rng.integers(0, 2**32, size=(500, 3), dtype=np.uint64)
    b = rng.integers(0, 2**32, size=(500, 3), dtype=np.uint64)
    a[:50] = 0xFFFFFFFF  # carry chains through saturated words
    b[:50, 0] = 1
    got = myers._add_with_carry(*_t(a.astype(np.uint32).view(np.int32),
                                    b.astype(np.uint32).view(np.int32)))
    full = lambda x: sum(x[:, w].astype(object) << (32 * w) for w in range(3))
    s = (full(a) + full(b)) % (1 << 96)
    want = np.stack([(s >> (32 * w)) & 0xFFFFFFFF for w in range(3)], axis=1).astype(np.uint32)
    assert np.array_equal(got.numpy().view(np.uint32), want)


def test_dispatcher_sends_cpu_tensors_to_plain(monkeypatch):
    def kernel_called(*a, **kw):
        raise AssertionError("CPU tensors must not reach the CUDA wrapper")

    monkeypatch.setattr(myers_cuda, "myers_semiglobal_cuda", kernel_called)
    monkeypatch.setattr(myers_cuda, "myers_semiglobal_text_cuda", kernel_called)
    reads, lens, wins = _inputs(20, 40, 50, 1)
    got = myers.myers_semiglobal_end(*_t(reads, lens, wins), 2)
    want = myers._myers_plain(*_t(reads, lens, wins), 2, 50)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    words = torch.from_numpy(packing.pack(np.zeros(64, np.uint8)).view(np.int32))
    z = torch.zeros(20, dtype=torch.int32)
    got = myers.myers_semiglobal_text(words, 64, z, *_t(reads.astype(np.int8), lens), z, z + 50,
                                      50, 2)
    want = myers.myers_semiglobal_text_plain(words, 64, z, *_t(reads.astype(np.int8), lens), z,
                                             z + 50, 50, 2)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_kernel_wrapper_rejects_cpu_tensors():
    reads, lens, wins = _inputs(20, 40, 50, 1)
    with pytest.raises(ValueError, match="CUDA"):
        myers_cuda.myers_semiglobal_cuda(*_t(reads, lens, wins))
    z = torch.zeros(20, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        myers_cuda.myers_semiglobal_text_cuda(z, 100, z, *_t(reads.astype(np.int8), lens), z, z,
                                              50, 2)
    assert myers_cuda.myers_semiglobal_cuda.launches == 0
    assert myers_cuda.myers_semiglobal_text_cuda.launches == 0
