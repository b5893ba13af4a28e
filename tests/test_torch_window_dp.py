"""Port window gather, Hamming verify and plain banded DP against the JAX
package: its jnp version, its Pallas kernel in interpret mode and its host
band DP.  Tolerance: exact equality (integer pipeline), except end_b on dead
lanes against the Pallas kernel, which the JAX engines disagree on."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from genome_weaver_align_tpu.ops import dp as j_dp
from genome_weaver_align_tpu.ops import dp_pallas as j_dp_pallas
from genome_weaver_align_tpu.ops import window as j_window
from genome_weaver_align_tpu.utils import packing
from genome_weaver_align_tpu_torch.ops import dp, window


@pytest.mark.parametrize("width", [37, 106])
def test_gather_windows_matches_jax(width):
    rng = np.random.default_rng(width)
    n = 5003
    words = packing.pack(rng.integers(0, 4, size=n, dtype=np.uint8))
    starts = np.concatenate([
        rng.integers(0, n - width, size=40),
        [-width - 5, -17, -1, 0, n - width, n - width + 1, n - 3, n, n + 40],
    ]).astype(np.int32)
    want = np.asarray(j_window.gather_windows(jnp.asarray(words), n, jnp.asarray(starts), width))
    got = window.gather_windows(torch.from_numpy(words.view(np.int32)), n,
                                torch.from_numpy(starts), width).numpy()
    host = window.gather_windows_host(words, n, starts, width)
    assert got.dtype == want.dtype == np.int8
    assert np.array_equal(got, want)
    assert np.array_equal(got, host)


def _dp_inputs(k, Q, L, W, seed):
    rng = np.random.default_rng(seed)
    reads = rng.integers(0, 5, size=(Q, L)).astype(np.int8)  # 4 = N never matches
    wins = rng.integers(0, 5, size=(Q, W)).astype(np.int8)
    planted = rng.random(Q) < 0.5
    span = min(L, W - 2 * k)
    if span > 0:  # half the lanes hold their read (near-zero distances)
        wins[planted, k : k + span] = reads[planted, :span]
    lengths = rng.integers(0, L + 1, size=Q).astype(np.int32)  # ragged, some 0
    lengths[: Q // 3] = L
    return reads, lengths, wins


@pytest.mark.parametrize("offset", [-3, 0, 2, 5])
def test_hamming_distance_matches_jax(offset):
    reads, lengths, wins = _dp_inputs(2, 64, 40, 47, seed=offset + 10)
    want = np.asarray(j_dp.hamming_distance(
        jnp.asarray(reads.astype(np.int32)), jnp.asarray(lengths),
        jnp.asarray(wins.astype(np.int32)), offset))
    got = dp.hamming_distance(torch.from_numpy(reads), torch.from_numpy(lengths),
                              torch.from_numpy(wins), offset).numpy()
    assert np.array_equal(got, want)


# (k, W): the verify shape W = L + 3k, and a narrow window whose long reads
# cannot reach its end (dead lanes: dist saturates to INF)
DP_CASES = [(1, None), (2, None), (3, None), (4, None), (2, 20)]


@pytest.mark.parametrize("k,W", DP_CASES)
def test_banded_edit_distance_matches_jax_engines(k, W):
    Q, L = 130, 50
    W = L + 3 * k if W is None else W
    reads, lengths, wins = _dp_inputs(k, Q, L, W, seed=k * 100 + W)
    got_d, got_e = (t.numpy() for t in dp.banded_edit_distance(
        torch.from_numpy(reads), torch.from_numpy(lengths), torch.from_numpy(wins), k))
    jr, jl, jw = jnp.asarray(reads.astype(np.int32)), jnp.asarray(lengths), jnp.asarray(wins.astype(np.int32))

    # the JAX jnp version: every lane, dist and end_b
    want_d, want_e = (np.asarray(a) for a in j_dp.banded_edit_distance(jr, jl, jw, k))
    assert np.array_equal(got_d, want_d)
    assert np.array_equal(got_e, want_e)

    # the Pallas kernel in interpret mode: dist everywhere, end_b on live lanes
    pal_d, pal_e = (np.asarray(a) for a in j_dp_pallas.banded_edit_distance_pallas(
        jr, jl, jw, k, interpret=True))
    live = got_d < dp.INF
    assert np.array_equal(got_d, pal_d)
    assert np.array_equal(got_e[live], pal_e[live])

    # the host band DP keeping every row
    rows = dp.banded_rows_host(reads.astype(np.int64), lengths, wins.astype(np.int64), k)
    boff = np.arange(4 * k + 1) - k
    j_end = lengths[:, None] + boff[None, :]
    Df = np.where((j_end >= 0) & (j_end <= W), rows[np.arange(Q), np.minimum(lengths, L)], dp.INF)
    assert np.array_equal(got_d, np.minimum(Df.min(axis=1), dp.INF))
    assert np.array_equal(got_e, Df.argmin(axis=1))
    if W == 20:
        assert (~live).any() and live.any()


@pytest.mark.parametrize("narrow", [False, True])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_banded_edit_distance_text_matches_jax(k, narrow):
    """The text entry (windows gathered from the packed text, reads picked
    by lane) against the JAX package's ``gather_windows`` + banded DP:
    starts off both ends of the text and next to word boundaries, ragged
    and 0-length reads, N codes, and a narrow window with dead lanes."""
    rng = np.random.default_rng(10 * k + narrow)
    n, B, L = 3001, 40, 48
    W = L // 2 if narrow else L + 3 * k
    codes = rng.integers(0, 4, size=n, dtype=np.uint8)
    words = packing.pack(codes)
    rid = np.sort(rng.integers(0, B, size=150)).astype(np.int32)
    Q = rid.size
    starts = rng.integers(0, n - W, size=Q).astype(np.int32)
    edges = [-W - 3, -k - 1, -1, 0, 15, 16, 17, 31, n - W - 1, n - W + 2, n - 5, n, n + 9]
    starts[: len(edges)] = edges
    reads = rng.integers(0, 5, size=(B, L)).astype(np.int8)  # 4 = N never matches
    for q in range(len(edges), Q, 2):  # half the lanes hold their read near the start
        seg = codes[max(starts[q] + k, 0) : starts[q] + k + L]
        reads[rid[q], : seg.size] = seg
    lengths = rng.integers(0, L + 1, size=B).astype(np.int32)
    lengths[: B // 2] = L
    lengths[3] = 0

    got_d, got_e = (t.numpy() for t in dp.banded_edit_distance_text(
        torch.from_numpy(words.view(np.int32)), n, torch.from_numpy(starts),
        torch.from_numpy(reads), torch.from_numpy(lengths), torch.from_numpy(rid), k, W))
    wins = j_window.gather_windows(jnp.asarray(words), n, jnp.asarray(starts), W)
    want_d, want_e = (np.asarray(a) for a in j_dp.banded_edit_distance(
        jnp.asarray(reads[rid].astype(np.int32)), jnp.asarray(lengths[rid]),
        wins.astype(jnp.int32), k))
    assert np.array_equal(got_d, want_d)
    assert np.array_equal(got_e, want_e)
    live = got_d < dp.INF
    assert live.any() and (got_d[live] <= k).any()
    assert (~live).any() == narrow


def test_banded_text_entry_clamps_read_ids():
    """A read id outside [0, B) (-1, B + 3) reads the nearest read, as the
    CUDA kernel does; the JAX gather ``reads[rid]`` clamps the ids past B
    alike (a negative id wraps there; no caller passes one)."""
    rng = np.random.default_rng(31)
    n, B, L, k = 2001, 12, 40, 2
    W = L + 3 * k
    words = torch.from_numpy(packing.pack(rng.integers(0, 4, size=n, dtype=np.uint8)).view(np.int32))
    reads = torch.from_numpy(rng.integers(0, 5, size=(B, L)).astype(np.int8))
    lengths = torch.from_numpy(rng.integers(1, L + 1, size=B).astype(np.int32))
    rid = torch.tensor([-1, B + 3, 0, B - 1, -7, B], dtype=torch.int32)
    starts = torch.from_numpy(rng.integers(0, n - W, size=rid.numel()).astype(np.int32))
    got = dp.banded_edit_distance_text(words, n, starts, reads, lengths, rid, k, W)
    want = dp.banded_edit_distance_text(words, n, starts, reads, lengths, rid.clamp(0, B - 1), k, W)
    jw = j_window.gather_windows(jnp.asarray(words.numpy().view(np.uint32)), n,
                                 jnp.asarray(starts.numpy()), W)
    jr = jnp.asarray(reads.numpy().astype(np.int32))[jnp.asarray(rid.numpy())]
    jl = jnp.asarray(lengths.numpy())[jnp.asarray(rid.numpy())]
    jax_d, jax_e = j_dp.banded_edit_distance(jr, jl, jw.astype(jnp.int32), k)
    up = rid.numpy() >= 0
    for g, w, j in zip(got, want, (jax_d, jax_e)):
        assert torch.equal(g, w)
        assert np.array_equal(g.numpy()[up], np.asarray(j)[up])


@pytest.mark.parametrize("k,L", [(17, 48), (24, 48), (32, 48), (2, 1816), (2, 2000)])
def test_wide_band_and_long_rows_match_jax(k, L):
    """Bands past k = 16 and reads past 1,815 bases (more than 128 rows of
    them overflow a block's shared memory on the card): the text entry's
    plain version and the windows entry's against the JAX package's
    ``gather_windows`` + jnp banded DP on every lane, dist and end_b, and
    a planted lane against the full-matrix host oracle."""
    rng = np.random.default_rng(k * L)
    n, B = 3 * L + 4001, 24
    W = L + 3 * k
    codes = rng.integers(0, 4, size=n, dtype=np.uint8)
    words = packing.pack(codes)
    rid = np.sort(rng.integers(0, B, size=60)).astype(np.int32)
    starts = rng.integers(0, n - W, size=rid.size).astype(np.int32)
    starts[:5] = [-W - 3, -k - 1, 0, n - W + 2, n + 9]
    reads = rng.integers(0, 5, size=(B, L)).astype(np.int8)
    for q in range(5, rid.size, 2):  # the read near the window start, k // 2 substitutions
        seg = codes[starts[q] + k : starts[q] + k + L].astype(np.int8)
        seg[rng.integers(0, L, size=k // 2)] = rng.integers(0, 4, size=k // 2)
        reads[rid[q], : seg.size] = seg
    lengths = np.where(rng.random(B) < 0.7, L, rng.integers(0, L + 1, size=B)).astype(np.int32)
    got_d, got_e = (t.numpy() for t in dp.banded_edit_distance_text(
        torch.from_numpy(words.view(np.int32)), n, torch.from_numpy(starts),
        torch.from_numpy(reads), torch.from_numpy(lengths), torch.from_numpy(rid), k, W))
    wins = np.array(j_window.gather_windows(jnp.asarray(words), n, jnp.asarray(starts), W))
    jr, jl = reads[rid].astype(np.int32), lengths[rid]
    want_d, want_e = (np.asarray(a) for a in j_dp.banded_edit_distance(
        jnp.asarray(jr), jnp.asarray(jl), jnp.asarray(wins.astype(np.int32)), k))
    assert np.array_equal(got_d, want_d)
    assert np.array_equal(got_e, want_e)
    win_d, win_e = (t.numpy() for t in dp.banded_edit_distance_best(
        torch.from_numpy(reads[rid]), torch.from_numpy(jl), torch.from_numpy(wins), k))
    assert np.array_equal(win_d, want_d)
    assert np.array_equal(win_e, want_e)
    q = next(q for q in range(5, rid.size, 2) if jl[q] == L)
    assert got_d[q] <= k
    assert got_d[q] == dp.edit_distance_semiglobal_host(jr[q].astype(np.int64),
                                                        wins[q].astype(np.int64))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_host_oracles_match_jax(seed):
    """The full-matrix oracles, copies of the JAX package's: distance, start,
    end and CIGAR equal on planted reads with indels, junk and N codes."""
    rng = np.random.default_rng(seed)
    for L, W in ((30, 45), (57, 80), (1, 5), (12, 12)):
        read = rng.integers(0, 5, size=L).astype(np.int64)
        window = rng.integers(0, 5, size=W).astype(np.int64)
        if W >= 16:
            seg = list(read[: W - 8])
            del seg[int(rng.integers(2, len(seg) - 2))]
            window[4 : 4 + len(seg)] = seg
        assert dp.edit_distance_semiglobal_host(read, window) == \
            j_dp.edit_distance_semiglobal_host(read, window)
        assert dp.traceback_semiglobal_host(read, window) == \
            j_dp.traceback_semiglobal_host(read, window)
