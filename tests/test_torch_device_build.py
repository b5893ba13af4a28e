"""The port's prefix-doubling SA builder (``index/device_build.py``, on the
CPU here) against the naive SA, the JAX package's device build on the same
codes, and as the builder of ``index --builder device``, whose index must
equal ``--builder native``'s array for array."""

import itertools
from unittest import mock

import numpy as np
import pytest

from genome_weaver_align_tpu.index.device_build import suffix_array_device as j_sa_device
from genome_weaver_align_tpu_torch.index import device_build
from genome_weaver_align_tpu_torch.index.device_build import suffix_array_device
from genome_weaver_align_tpu_torch.index.sais import suffix_array_naive
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)


def sa(codes, **kw):
    return suffix_array_device(codes, device="cpu", **kw)


def counted_rounds(fn, *args, **kw):
    """fn(*args, **kw) with the device build's doubling rounds counted:
    (result, rounds)."""
    with mock.patch.object(device_build, "_doubling_round",
                           wraps=device_build._doubling_round) as spy:
        return fn(*args, **kw), spy.call_count


@pytest.mark.parametrize("n,seed", [(1, 0), (2, 1), (63, 2), (1000, 3), (5000, 4)])
def test_device_sa_vs_naive_and_jax(n, seed):
    codes = np.random.default_rng(seed).integers(0, 4, size=n, dtype=np.uint8)
    got = sa(codes)
    assert got.dtype == np.int64
    assert np.array_equal(got, suffix_array_naive(codes))
    assert np.array_equal(got, j_sa_device(codes))


@pytest.mark.parametrize("codes", [
    np.zeros(300, np.uint8),
    np.tile(np.array([0, 1, 2, 3], np.uint8), 128),
    np.tile(np.array([1, 1, 0], np.uint8), 200),
], ids=["zeros", "acgt", "cca"])
def test_device_sa_repetitive(codes):
    got, rounds = counted_rounds(sa, codes)
    assert np.array_equal(got, suffix_array_naive(codes))
    assert np.array_equal(got, j_sa_device(codes))
    # round r ranks prefixes of 2^r bases; suffixes of a text of period p
    # share prefixes of up to n - p bases, so 2^rounds must pass n - p
    assert rounds == {300: 9, 512: 9, 600: 10}[codes.size]


def test_device_sa_short_texts_all_sorted():
    """Every text of at most 4 bases.  The JAX build stops before its first
    round when the initial code ranks already reach N - 1, which some of
    these texts do with ties left (it returns [2, 0, 1] for "CC"); the port
    always runs a round, and equals the JAX build wherever that is sorted."""
    n_jax_unsorted = 0
    for n in range(5):
        for t in itertools.product(range(4), repeat=n):
            codes = np.array(t, np.uint8)
            want = suffix_array_naive(codes)
            assert np.array_equal(sa(codes), want), t
            n_jax_unsorted += not np.array_equal(j_sa_device(codes), want)
    assert n_jax_unsorted == 133


def test_device_sa_feeds_index_build():
    from genome_weaver_align_tpu_torch.index.build import build_fm_index

    codes = np.random.default_rng(9).integers(0, 4, size=3000, dtype=np.uint8)
    fm = build_fm_index(codes, sa=sa(codes))
    lo, hi = fm.backward_search(codes[500:540])
    assert hi - lo >= 1
    assert 500 in fm.locate(np.arange(lo, hi)).tolist()


def test_device_sa_refuses_past_int32():
    huge = np.broadcast_to(np.zeros(1, np.uint8), (np.iinfo(np.int32).max,))  # no copy
    with pytest.raises(ValueError, match="int32"):
        suffix_array_device(huge, device="cpu")


def _write_genome(path):
    from genome_weaver_align_tpu_torch.utils.fasta import Contig, write_fasta

    rng = np.random.default_rng(5)
    unit = rng.integers(0, 4, size=120, dtype=np.uint8)
    write_fasta(path, [
        Contig("chrA", np.concatenate([np.tile(unit, 6), rng.integers(0, 4, 3000, np.uint8)])),
        Contig("chrB", rng.integers(0, 4, size=2500, dtype=np.uint8)),
    ])


def test_cli_builder_device_equals_native(tmp_path):
    from genome_weaver_align_tpu_torch.cli import main

    _write_genome(tmp_path / "g.fa")
    common = ["index", str(tmp_path / "g.fa"), "--sample-rate", "8", "--seed", "8"]
    assert main([*common, "-o", str(tmp_path / "native.npz"), "--builder", "native"]) == 0
    assert main([*common, "-o", str(tmp_path / "device.npz"), "--builder", "device",
                 "--device", "cpu"]) == 0
    for name in ("{}.npz", "{}.npz.seed8.npz"):
        with np.load(tmp_path / name.format("native")) as a, \
                np.load(tmp_path / name.format("device")) as b:
            assert sorted(a.files) == sorted(b.files)
            for key in a.files:
                assert a[key].dtype == b[key].dtype and np.array_equal(a[key], b[key]), key


def test_cli_builder_device_without_gpu_names_the_missing_device(tmp_path, capsys, monkeypatch):
    import torch

    from genome_weaver_align_tpu_torch.cli import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _write_genome(tmp_path / "g.fa")
    assert main(["index", str(tmp_path / "g.fa"), "-o", str(tmp_path / "d.npz"),
                 "--builder", "device"]) == 1
    assert "--device cuda" in capsys.readouterr().err
    assert not (tmp_path / "d.npz").exists()
    # the host builders never touch the device
    assert main(["index", str(tmp_path / "g.fa"), "-o", str(tmp_path / "n.npz")]) == 0
