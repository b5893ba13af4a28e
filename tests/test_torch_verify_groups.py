"""The group designs of the two verify kernels, as numpy models in the
kernels' own order of operations (``tests/torch_verify_models.py``),
against the port's plain versions on every lane (tolerance: equal on every
element, the pipeline is integer): Myers past 8 words (a group of G
threads, P words each, run as a wavefront) at every shape the binding
picks (``myers_cuda.group_shape``), at others and at the scratch path's
(a warp, ceil(nwords / 32) words a thread); the banded DP past k = 16 (a
group of G threads, 9..16 slots each, the band padded at its bottom) and
at the scratch path's (a warp, ceil((4k+1) / 32) slots a thread).  A few
lanes also against the full-matrix host oracle."""

import numpy as np
import pytest
import torch

from genome_weaver_align_tpu_torch.ops import dp, myers, myers_cuda

import torch_verify_models as models  # tests/ is on the path under pytest


def banded_group(k):
    """``csrc/banded_dp.cuh``'s ``group_for`` and its slots a thread: (G, N),
    G the power of two whose 16-slot threads cover the band, N =
    ceil((4k + 1) / G)."""
    g = 1
    while g * 16 < 4 * k + 1:
        g *= 2
    return g, -(-(4 * k + 1) // g)


GROUP_KS = [17, 20, 24, 31, 32, 48, 64, 96, 127]  # every G and N = 9..16 at its edges


def _myers_inputs(Q, L, W, seed):
    """Half the lanes hold their read (an indel in a third, substitutions)
    in the window where it is wider than the read, half are random; N codes
    and a negative code, ragged and zero lengths, lengths past L."""
    rng = np.random.default_rng(seed)
    reads = rng.integers(0, 4, size=(Q, L)).astype(np.int8)
    reads[rng.random((Q, L)) < 0.01] = 4
    wins = rng.integers(0, 5, size=(Q, W)).astype(np.int8)
    for q in range(0, Q if W > L else 0, 2):
        at = int(rng.integers(0, W - L))
        seg = np.delete(reads[q], rng.integers(0, L)) if q % 3 == 0 else reads[q]
        wins[q, at:at + seg.size] = seg
        wins[q, rng.integers(0, W, size=3)] = rng.integers(0, 4, size=3)
    wins[1, :5] = -1  # reads Peq[0]
    lens = np.where(rng.random(Q) < 0.7, L, rng.integers(0, L + 1, size=Q)).astype(np.int32)
    lens[3::11] = 0
    lens[5] = 32 * (-(-L // 32))  # past L, inside the last word
    return reads, lens, wins


def _hold(reads, lens, wins, nwords, steps, G, P):
    got = models.myers_wavefront(reads, lens, wins, nwords, steps, G, P)
    want = myers.myers_semiglobal_end(*(torch.from_numpy(a) for a in (reads, lens, wins)),
                                      nwords, steps)
    for g, w in zip(got, want):
        assert np.array_equal(g, w.numpy())
    return want


@pytest.mark.parametrize("L", [257, 300, 512, 1000])
def test_myers_group_model_equals_plain(L):
    """nwords 9, 10, 16, 32: the binding's (G, P), 16 threads of a word
    each up to 16 words, 8 of 4 words at 32."""
    Q, W = 40, L + 60
    reads, lens, wins = _myers_inputs(Q, L, W, L)
    nwords = -(-L // 32)
    G, P = myers_cuda.group_shape(nwords)
    want = _hold(reads, lens, wins, nwords, W, G, P)
    assert (want[0].numpy()[::2] <= L // 20).mean() > 0.8  # planted lanes: the rescue bar


@pytest.mark.parametrize("nwords,G,P", [(9, 32, 1), (10, 2, 5), (40, 32, 2), (12, 8, 2),
                                        (10, 4, 3), (10, 8, 2), (600, 32, 19)])
def test_myers_group_model_other_shapes(nwords, G, P):
    """The scratch path's shape (a warp, ceil(nwords / 32) words a thread)
    and groups the binding does not pick: padding threads and words, a
    group of a thread's single word, more words than the read needs."""
    L = 32 * nwords - 7
    Q, W = 24, L + 40 if nwords <= 64 else 300  # the scratch shape: a window of 300
    reads, lens, wins = _myers_inputs(Q, L, W, nwords)
    _hold(reads, lens, wins, nwords, W - 3, G, P)


@pytest.mark.parametrize("nwords", [9, 16, 17, 32, 33, 64, 65, 96, 97, 128, 129, 256, 257,
                                    512])
def test_myers_wavefront_model_every_picked_shape(nwords):
    """Every (G, P) that ``group_shape`` picks from 9 to 512 words, at its
    edges, on windows shorter than the read (every word's carries and
    shifts still run each column)."""
    G, P = myers_cuda.group_shape(nwords)
    assert G * P >= nwords and P in myers_cuda.REG_WORDS
    L = 32 * nwords - 5
    Q, W = 16, min(L + 40, 160)
    reads, lens, wins = _myers_inputs(Q, L, W, nwords)
    _hold(reads, lens, wins, nwords, W, G, P)


@pytest.mark.parametrize("steps", [101, 16, 17])
@pytest.mark.parametrize("nwords", [10, 40, 300])
def test_myers_wavefront_model_edge_lanes(nwords, steps):
    """Lanes of length 0, of bit len - 1 in each thread of the group (first
    and last bit of its words), windows wholly and partly off the text
    (code 4), a column of a negative code; more steps than columns, and
    runs that end at, just past and short of a 16-step scoring run."""
    G, P = myers_cuda.group_shape(nwords)
    L = 32 * nwords
    rng = np.random.default_rng(nwords)
    lens = [0, 1, L]
    for j in range(G):
        lens += [min(32 * j * P + 1, L), min(32 * (j + 1) * P, L)]
    Q = len(lens)
    W = 96
    reads = rng.integers(0, 4, size=(Q, L)).astype(np.int8)
    wins = rng.integers(0, 4, size=(Q, W)).astype(np.int8)
    for q in range(Q):
        n = min(lens[q], W // 2)
        wins[q, 10:10 + n] = reads[q, :n]  # a read's head: the score falls
    wins[0::3] = 4  # off the text
    wins[1::3, :30] = 4
    wins[2::3, -25:] = 4
    wins[4, 3] = -1
    _hold(reads, np.array(lens, np.int32), wins, nwords, steps, G, P)
    _hold(reads, np.array(lens, np.int32), wins, nwords, 13, G, P)  # a partial run


def _dp_inputs(k, Q, L, W, seed):
    rng = np.random.default_rng(seed)
    reads = rng.integers(0, 5, size=(Q, L)).astype(np.int8)
    wins = rng.integers(0, 5, size=(Q, W)).astype(np.int8)
    span = min(L, W - 2 * k)
    for q in range(0, Q, 2):  # the read near the diagonal, an indel and k // 2 substitutions
        seg = np.delete(reads[q], rng.integers(0, L)) if q % 4 == 0 else reads[q]
        n = min(span, seg.size)
        if n > 0:
            wins[q, k:k + n] = seg[:n]
            wins[q, rng.integers(0, W, size=k // 2)] = rng.integers(0, 4, size=k // 2)
    lens = np.where(rng.random(Q) < 0.7, L, rng.integers(0, L + 1, size=Q)).astype(np.int32)
    lens[2::9] = 0
    return reads, lens, wins


@pytest.mark.parametrize("k", GROUP_KS)
@pytest.mark.parametrize("narrow", [False, True])
def test_banded_group_model_equals_plain(k, narrow):
    """G = 8, 16, 32 threads of 9..16 slots; the verify window W = L + 3k
    and a narrow one whose long reads cannot reach its end (dead lanes, no
    candidate in the band: INF in both), the window's surroundings read as
    no-match (the windows entry) and as codes (the text entry's text)."""
    Q = 30
    L = k + 32 if narrow else 64
    W = 16 if narrow else L + 3 * k
    reads, lens, wins = _dp_inputs(k, Q, L, W, 10 * k + narrow)
    want = dp.banded_edit_distance(*(torch.from_numpy(a) for a in (reads, lens, wins)), k)
    for beyond in (None, k):
        got = models.banded_group(reads, lens, wins, k, *banded_group(k), beyond=beyond)
        for g, w in zip(got, want):
            assert np.array_equal(g, w.numpy())
    assert bool((want[0].numpy() >= dp.INF).any()) == narrow


@pytest.mark.parametrize("k,G,S", [(17, 32, 3), (20, 32, 3), (128, 32, 17)])
def test_banded_scratch_shape_model_equals_plain(k, G, S):
    """The scratch kernel's shape: a warp a lane, ceil((4k+1) / 32) slots a
    thread (k = 128 is where it starts)."""
    Q, L = 12, 48
    reads, lens, wins = _dp_inputs(k, Q, L, L + 3 * k, k)
    got = models.banded_scratch(reads, lens, wins, k, G, S)
    want = dp.banded_edit_distance(*(torch.from_numpy(a) for a in (reads, lens, wins)), k)
    for g, w in zip(got, want):
        assert np.array_equal(g, w.numpy())


@pytest.mark.parametrize("k", [17, 24, 48, 96, 127])
def test_banded_model_against_full_matrix_oracle(k):
    """Where the read lies inside its window (the band holds every
    alignment within k), the banded distance is the full-matrix one."""
    Q, L = 8, 60
    W = L + 3 * k
    reads, lens, wins = _dp_inputs(k, Q, L, W, 7 * k)
    lens[:] = L
    reads = np.where(reads >= 4, 0, reads).astype(np.int8)
    got, _ = models.banded_group(reads, lens, wins, k, *banded_group(k), beyond=k)
    for q in range(0, Q, 2):
        want = dp.edit_distance_semiglobal_host(reads[q].astype(np.int64),
                                                wins[q].astype(np.int64))
        if want <= k:
            assert got[q] == want
