"""The port's ``parallel/multihost.py`` against the JAX package's: the
single-process no-op, ``host_shard_info``, the round trip of
``make_global_batch`` and ``gather_to_host``, ``stream_batches``; then real
gloo process groups on the CPU (``tests/torch_multihost_driver.py``): 2
processes write the same SAM as 1, in ``exact`` and in ``sharded`` mode,
and the 1-process SAM body equals the JAX driver's
(``tests/multihost_driver.py``)."""

from pathlib import Path

import numpy as np
import pytest
import torch

from genome_weaver_align_tpu.parallel import mesh as j_mesh
from genome_weaver_align_tpu.parallel import multihost as j_mh
from genome_weaver_align_tpu_torch.parallel import mesh as pmesh
from genome_weaver_align_tpu_torch.parallel import multihost as mh
from tests.torch_multihost_driver import launch
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

TESTS = Path(__file__).resolve().parent


def test_initialize_noop_single_process():
    mh.initialize_distributed(num_processes=1)  # must not raise
    assert not torch.distributed.is_initialized()
    info = mh.host_shard_info(64)
    assert info == mh.HostShardInfo(0, 1, 64, 64, 0)
    j_mh.initialize_distributed(num_processes=1)
    assert vars(info) == vars(j_mh.host_shard_info(64))


def test_host_shard_info_splits_and_refuses_a_batch_that_does_not_divide(monkeypatch):
    monkeypatch.setattr(mh, "process_count", lambda: 2)
    monkeypatch.setattr(mh, "process_index", lambda: 1)
    assert mh.host_shard_info(64) == mh.HostShardInfo(1, 2, 64, 32, 32)
    with pytest.raises(ValueError, match="divide"):
        mh.host_shard_info(63)


def test_make_global_batch_and_gather():
    reads = np.arange(8 * 20, dtype=np.int32).reshape(8, 20)
    lengths = np.full(8, 20, np.int32)
    r, l, gb = mh.make_global_batch(pmesh.make_layout(4, 2, "cpu"), reads, lengths)
    assert gb == 8 and r.shape == (8, 20) and r.dtype == torch.int32
    back = mh.gather_to_host([r, l])
    want = j_mh.gather_to_host(
        j_mh.make_global_batch(j_mesh.make_mesh(n_data=4, n_interval=2), reads, lengths))
    for got, w, orig in zip(back, want, (reads, lengths)):
        assert np.array_equal(got, orig) and np.array_equal(got, w)
    assert isinstance(mh.gather_to_host([np.arange(3)])[0], np.ndarray)


def test_shard_reads_pads_then_takes_this_process_slice(monkeypatch):
    """The slice comes from the process place the layout recorded."""
    reads = np.arange(5 * 3, dtype=np.int32).reshape(5, 3)
    lengths = np.arange(5, dtype=np.int32)
    monkeypatch.setattr(mh, "process_count", lambda: 2)
    monkeypatch.setattr(mh, "process_index", lambda: 1)
    layout = pmesh.make_layout(2, 1, "cpu")
    monkeypatch.undo()
    r, l, B = pmesh.shard_reads(layout, reads, lengths)
    assert (layout.process_index, layout.process_count) == (1, 2)
    assert B == 5
    assert np.array_equal(r.numpy(), np.concatenate([reads[3:], np.zeros((1, 3), np.int32)]))
    assert np.array_equal(l.numpy(), [3, 4, 0])


def test_make_layout_refuses_a_data_axis_that_does_not_divide(monkeypatch):
    monkeypatch.setattr(mh, "process_count", lambda: 2)
    assert pmesh.make_layout(4, 1, "cpu").n_data == 4
    with pytest.raises(ValueError, match="divide"):
        pmesh.make_layout(3, 1, "cpu")


def test_sharded_aligner_built_before_the_group_refuses_to_align(monkeypatch):
    from genome_weaver_align_tpu_torch.index.files import Genome, build_genome_index
    from genome_weaver_align_tpu_torch.parallel.sharded_pipeline import ShardedAligner
    from genome_weaver_align_tpu_torch.utils import simulate
    from genome_weaver_align_tpu_torch.utils.fasta import Contig, Read

    g = simulate.random_genome(4_000, seed=5)
    gi = build_genome_index(Genome.from_contigs([Contig("c1", g)]), sample_rate=16)
    al = ShardedAligner(gi, k=1, n_interval=2, device="cpu")
    reads = [Read("a", g[100:130].copy())]
    assert al.align_batch(reads)[0].pos == 100
    monkeypatch.setattr(mh, "process_count", lambda: 2)
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        al.align_batch(reads)


def test_stream_batches_deterministic():
    reads = list(range(25))
    batches = list(mh.stream_batches(reads, 8))
    assert batches == list(j_mh.stream_batches(reads, 8))
    assert [b[0] for b in batches] == [0, 8, 16, 24]
    assert batches[-1][1] == [24]
    assert list(mh.stream_batches(reads, 8))[2:] == batches[2:]


@pytest.mark.parametrize("mode,marker", [("exact", b"r0"), ("sharded", b"long0")])
def test_two_processes_write_the_one_process_sam(tmp_path, mode, marker):
    """2 gloo processes, each passing only its slice of every batch, write
    the same SAM bytes as 1 process."""
    launch(1, tmp_path / "single.sam", mode, "--device", "cpu")
    launch(2, tmp_path / "dual.sam", mode, "--device", "cpu")
    a, b = (tmp_path / "single.sam").read_bytes(), (tmp_path / "dual.sam").read_bytes()
    assert marker in a and (mode == "exact" or b"short0" in a)
    assert a == b


@pytest.mark.parametrize("mode", ["exact", "sharded"])
def test_one_process_sam_equals_the_jax_driver(tmp_path, mode):
    launch(1, tmp_path / "port.sam", mode, "--device", "cpu")
    launch(1, tmp_path / "jax.sam", mode, driver=TESTS / "multihost_driver.py")
    port, want = ([line for line in (tmp_path / n).read_text().splitlines()
                   if not line.startswith("@PG")] for n in ("port.sam", "jax.sam"))
    assert len([line for line in want if line[0] != "@"]) == (32 if mode == "exact" else 128)
    assert port == want


@pytest.mark.parametrize("P", [1, 2, 3, 4])
@pytest.mark.parametrize("n_cards", [0, 1, 2, 4])
def test_each_rank_takes_a_card_and_groups_apart_get_nccl(P, n_cards):
    """Rank r takes card r % n_cards (none without cards); the interval
    groups of every span g that divides P are g consecutive ranks; a group
    gets an NCCL group beside gloo only where its ranks' cards differ."""
    cards = [mh.card_for(r, n_cards) for r in range(P)]
    assert cards == [r % n_cards if n_cards else None for r in range(P)]
    places = [("host", c) for c in cards]
    assert mh.spans(P) == [g for g in (2, 3, 4) if g <= P and P % g == 0]
    for g in mh.spans(P):
        groups = mh.groups_of(P, g)
        assert [r for grp in groups for r in grp] == list(range(P))
        for grp in groups:
            assert grp == list(range(grp[0], grp[0] + g))
            assert mh.apart(places, grp) == (0 < g <= n_cards)
    # one card a host, two hosts: apart
    assert mh.apart([("a", 0), ("b", 0)], [0, 1])


def test_one_process_has_no_card_of_its_own():
    mh.initialize_distributed(num_processes=1)
    assert mh.card() is None and mh.interval_group() is None and mh.nccl_group() is None
    assert mh.device() == (torch.device("cuda", torch.cuda.current_device())
                           if torch.cuda.is_available() else torch.device("cpu"))
