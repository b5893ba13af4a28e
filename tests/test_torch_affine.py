"""The port's native affine traceback split into row chunks on host threads
(the route a library built without OpenMP takes) gives exactly what one
native call gives, and both equal the JAX package's numpy engine."""

import numpy as np
import pytest

from genome_weaver_align_tpu.ops import affine as j_affine
from genome_weaver_align_tpu_torch.index import native
from genome_weaver_align_tpu_torch.ops import affine
from tests.streams import mixed_stream


@pytest.fixture(scope="module")
def cohort():
    """Indel-bearing reads against their windows (W = L + 3k), ragged
    lengths, junk rows and N codes."""
    rng = np.random.default_rng(30)
    k = 3
    reads, lens, wins = mixed_stream(rng, 700, 100, 100 + 3 * k, k)
    return reads, lens, wins, k


def _run(cohort, monkeypatch, min_rows, threads):
    reads, lens, wins, k = cohort
    monkeypatch.setattr(affine, "THREAD_MIN_ROWS", min_rows)
    monkeypatch.setattr(affine, "HOST_THREADS", threads)
    return affine.affine_banded_batch(reads, lens, wins, k)


@pytest.mark.parametrize("threads", [3, 4])
def test_chunked_traceback_equals_single_call(cohort, monkeypatch, threads):
    assert native.available() and affine._load_native() is not None
    monkeypatch.setattr(native, "built_with_openmp", False)
    single = _run(cohort, monkeypatch, min_rows=10**9, threads=threads)
    calls = []
    real = affine._native_fn
    monkeypatch.setattr(affine, "_native_fn", lambda *a: calls.append(a[3]) or real(*a))
    chunked = _run(cohort, monkeypatch, min_rows=8, threads=threads)
    assert sorted(calls, reverse=True)[0] < len(cohort[0]) and len(calls) == threads
    assert sum(calls) == len(cohort[0])
    for a, b in zip(single, chunked):
        assert (a == b) if isinstance(a, list) else np.array_equal(a, b)
    assert any(set(c) & set("ID") for c in chunked[2])  # indel CIGARs compared


def test_single_call_below_the_threshold_and_with_openmp(cohort, monkeypatch):
    calls = []
    real = affine._load_native()
    monkeypatch.setattr(affine, "_native_fn", lambda *a: calls.append(a[3]) or real(*a))
    monkeypatch.setattr(native, "built_with_openmp", True)
    _run(cohort, monkeypatch, min_rows=8, threads=4)
    monkeypatch.setattr(native, "built_with_openmp", False)
    _run(cohort, monkeypatch, min_rows=len(cohort[0]) + 1, threads=4)
    assert calls == [len(cohort[0])] * 2


def test_native_equals_jax_numpy_engine(cohort, monkeypatch):
    reads, lens, wins, k = cohort
    monkeypatch.setattr(native, "built_with_openmp", False)
    got = _run(cohort, monkeypatch, min_rows=8, threads=4)
    want = j_affine.affine_banded_batch_numpy(reads, lens, wins, k)
    for a, b in zip(got, want):
        assert (a == b) if isinstance(a, list) else np.array_equal(a, b)
