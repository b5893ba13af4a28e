"""Interval shards in separate processes (BASELINE config 5's layout) on
the CPU: gloo processes (``tests/torch_multihost_driver.py``, mode
``interval``) hold S shards of a 100 kb genome's index, each process its
interval group's S / g and the others' mapped through shared memory: 2
processes at S = 2 and 4 (one group), and 4 processes at S = 2 (two
groups of two, one shard a process: the two-axis layout) and S = 4 (one
group, one shard a process).

- the exact search's (lo, hi, pos) in every process, under the psum, ring
  and fused merges, equals the JAX ``make_sharded_exact_search`` on a
  (1, S) mesh of the CPU's virtual devices (the ring and fused merges in
  interpret mode, as ``tests/test_ring.py`` runs them) on the rows of its
  interval group's slice of the batch, and in one process (g = 1);
- the ring merge across processes writes one ``(2, Bc)`` inbox row a
  member, the held shards' partial;
- the ``ShardedAligner`` SAM from P processes equals the 1-process SAM and
  the JAX package's (``tests/multihost_driver.py``) byte for byte, but
  ``@PG``;
- each process holds only its own shards, and what it reads of the
  others' shards is theirs, not a copy; its interval group is the right
  processes;
- ``mesh.make_layout``'s arithmetic: the span g of an interval group, the
  groups, the shards each process holds and the data axis, over P = 1..4
  and S = 1, 2, 4, 8, and its refusals;
- ``sharded_index.shard_rows`` of shards in their own tensors equals the
  stacked gather."""

import functools
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from genome_weaver_align_tpu.index import native as j_native
from genome_weaver_align_tpu.index.build import build_fm_index
from genome_weaver_align_tpu.parallel import mesh as j_mesh
from genome_weaver_align_tpu.parallel import sharded_index as j_si
from genome_weaver_align_tpu_torch.parallel import mesh as pmesh
from genome_weaver_align_tpu_torch.parallel import multihost as mh
from tests.torch_multihost_driver import (
    EXACT_L, exact_search_reads, launch, sharded_genome, sharded_main,
)
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

TESTS = Path(__file__).resolve().parent
MERGES = ("psum", "ring", "fused")
# (P, S) runs of the driver; the 2-process runs keep their ids
RUNS = ((2, 2), (2, 4), (4, 2), (4, 4))
# an interval group's span g at P processes and S shards; None: refused
SPAN = {(1, 1): 1, (1, 2): 1, (1, 4): 1, (1, 8): 1, (2, 1): 1, (2, 2): 2, (2, 4): 2, (2, 8): 2,
        (3, 1): 1, (3, 2): None, (3, 4): None, (3, 8): None,
        (4, 1): 1, (4, 2): 2, (4, 4): 4, (4, 8): 4}


@pytest.fixture(scope="module", autouse=True)
def _jax_native_off():
    """The JAX index comes from the JAX package's numpy SA builder, never
    from its in-place ``make -C native``."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_native, "_lib", None)
        mp.setattr(j_native, "_build_failed", True)
        yield


@pytest.fixture(scope="module", params=RUNS,
                ids=lambda ps: f"S{ps[1]}" if ps[0] == 2 else f"P{ps[0]}-S{ps[1]}")
def procs(request, tmp_path_factory):
    """One run of P processes holding S shards: (P, S, the run's
    directory)."""
    P, S = request.param
    d = tmp_path_factory.mktemp(f"interval{P}x{S}")
    launch(P, d / "out.sam", "interval", "--n-interval", str(S), "--device", "cpu",
           timeout=180)
    return P, S, d


@functools.cache
def _jax_exact(S: int, merge: str):
    g = sharded_genome()
    fm = build_fm_index(g, sample_rate=16)
    reads, lengths = exact_search_reads(g)
    jm = j_mesh.make_mesh(n_data=1, n_interval=S, devices=jax.devices()[:S])
    jsh = j_si.put_sharded(j_si.shard_fm_index(fm, S), jm, j_mesh.INTERVAL_AXIS)
    fn = j_si.make_sharded_exact_search(jm, j_mesh.INTERVAL_AXIS, j_mesh.DATA_AXIS,
                                        max_len=EXACT_L, like=jsh, merge=merge, microbatch=2,
                                        ring_interpret=True)
    r, ln, _ = j_mesh.shard_reads(jm, reads, lengths)
    return [np.asarray(v)[: reads.shape[0]] for v in fn(jsh, r, ln)]


@pytest.mark.parametrize("merge", MERGES)
def test_exact_search_across_processes_equals_jax(procs, merge):
    P, S, d = procs
    want = _jax_exact(S, merge)
    assert (want[1] > want[0]).sum() > len(want[0]) // 2
    covered = set()
    for pid in range(P):
        got = np.load(d / f"out.sam.{pid}.npz")
        first, stop = json.loads((d / f"out.sam.{pid}.json").read_text())["rows"]
        covered.update(range(first, stop))
        for key, w in zip(("lo", "hi", "pos"), want):
            assert np.array_equal(got[f"{merge}_{key}"], w[first:stop]), (pid, key)
    assert covered == set(range(len(want[0])))


def test_sam_across_processes_equals_one_process_and_jax(procs, tmp_path):
    P, S, d = procs
    sharded_main(0, tmp_path / "one.sam", torch.device("cpu"), S).close()
    launch(1, tmp_path / "jax.sam", "sharded", driver=TESTS / "multihost_driver.py", timeout=120)
    two, one, jx = ((p).read_text() for p in (d / "out.sam", tmp_path / "one.sam",
                                               tmp_path / "jax.sam"))
    assert two == one
    assert [ln for ln in two.splitlines() if not ln.startswith("@PG")] == [
        ln for ln in jx.splitlines() if not ln.startswith("@PG")]
    assert len([ln for ln in two.splitlines() if ln[0] != "@"]) == 128


def test_each_process_holds_only_its_own_shards(procs):
    """Every sharded table here is 1/g of the stacked one, each process's
    change to its own shard is what every process of its group reads
    through its map of that shard, and the interval group is the g
    consecutive processes around it."""
    P, S, d = procs
    g = SPAN[P, S]
    per = S // g
    for pid in range(P):
        facts = json.loads((d / f"out.sam.{pid}.json").read_text())
        place = pid % g
        assert facts["held"] == list(range(place * per, (place + 1) * per))
        assert facts["owners"] == [s // per for s in range(S)]
        assert facts["group"] == list(range(pid - place, pid - place + g))
        assert facts["card"] is None  # no card: the CPU run
        assert facts["cards"] == ([None] * S if g > 1 else None)
        routes = facts["routes"]  # a group on the CPU merges over gloo and host barriers
        assert routes["psum nccl"] == routes["ring flag wait"] == 0
        assert (routes["psum gloo"] > 0 and routes["ring host barrier"] > 0) == (g > 1)
        for table, (here, stacked) in facts["bytes"].items():
            assert here * g == stacked, table
        assert facts["seen"] == [True] * S


def test_ring_route_writes_one_row_a_rank(procs):
    """Across processes the ring merge's inbox is one ``(2, Bc)`` row a
    member of the interval group, and after every chunk-step this
    process's row holds its held shards' lo and hi partials (the exact
    search's equality with JAX is ``test_exact_search_across_processes_
    equals_jax``)."""
    P, S, d = procs
    g = SPAN[P, S]
    for pid in range(P):
        facts = json.loads((d / f"out.sam.{pid}.json").read_text())
        first, stop = facts["rows"]
        ring = facts["ring"]
        assert ring["inbox"] == [g, 2, (stop - first) // 2], ring  # microbatch 2
        assert ring["steps"] == 2 * EXACT_L and ring["bad"] == 0, ring


@pytest.mark.parametrize("S", [2, 4])
def test_ring_route_in_one_process(S):
    """g = 1: one process holds every shard.  The search's ring merge (the
    stacked ``ring_merge``) equals the JAX search and the stacked psum
    search, and ``_RingSlots`` over a group of one writes one ``(2, Bc)``
    row, the held shards' partial, and returns ``backward_step``'s
    values."""
    from genome_weaver_align_tpu_torch.index.build import build_fm_index as p_build
    from genome_weaver_align_tpu_torch.parallel import sharded_index as si

    g = sharded_genome()
    sh = si.put_sharded(si.shard_fm_index(p_build(g, sample_rate=16), S), "cpu")
    layout = pmesh.make_layout(1, S, "cpu")
    reads, lengths = exact_search_reads(g)
    r, ln, _ = pmesh.shard_reads(layout, reads, lengths)
    got = si.make_sharded_exact_search(layout, EXACT_L, sh, merge="ring", microbatch=2)(sh, r, ln)
    psum = si.make_sharded_exact_search(layout, EXACT_L, sh, merge="psum")(sh, r, ln)
    for a, b, w in zip(got, psum, _jax_exact(S, "ring")):
        assert np.array_equal(a.numpy(), w) and torch.equal(a, b)
    Bc = r.shape[0] // 2
    slots = si._RingSlots(layout, None, (2, Bc), "cpu", apart=False)
    assert [tuple(box[0].shape) for box in slots.inboxes] == [(1, 2, Bc)] * 2
    lo = torch.zeros(Bc, dtype=torch.int32)
    hi = torch.full((Bc,), sh.n + 1, dtype=torch.int32)
    before = si.CROSS_MERGES["ring host barrier"]
    for t in range(6):
        c = r[:Bc, t]
        want = si.backward_step(sh, c, lo, hi)
        nlo, nhi = slots.step(sh, c, lo, hi)
        row = slots.inboxes[t % 2][0][0]
        assert torch.equal(row, torch.stack([si.local_occ_codes(sh, c, k).sum(0, dtype=torch.int32)
                                             for k in (lo, hi)]))
        assert torch.equal(nlo, want[0]) and torch.equal(nhi, want[1])
        lo, hi = nlo, nhi
    assert si.CROSS_MERGES["ring host barrier"] == before + 6


@pytest.mark.parametrize("procs_, shards", [(2, 3), (4, 3), (4, 6), (3, 4)])
def test_make_layout_refuses_a_process_count_that_does_not_divide_the_shards(
        monkeypatch, procs_, shards):
    monkeypatch.setattr(mh, "process_count", lambda: procs_)
    with pytest.raises(ValueError, match=rf"interval axis \({shards} shards\).*{procs_} processes"):
        pmesh.make_layout(procs_, shards, "cpu")


@pytest.mark.parametrize("P", [1, 2, 3, 4])
@pytest.mark.parametrize("S", [1, 2, 4, 8])
def test_layout_arithmetic(monkeypatch, P, S):
    """The interval groups' span g, the groups, each process's place,
    shards and data-axis unit, with the data axis over the processes
    (``ShardedAligner``'s n_data = P) and over the groups (the exact
    search's); the pairs where neither S divides P nor P divides S are
    refused."""
    monkeypatch.setattr(mh, "process_count", lambda: P)
    g = SPAN[P, S]
    assert g == (None if g is None else pmesh.interval_span(P, S))
    if g is None:
        with pytest.raises(ValueError, match=rf"interval axis \({S} shards\)"):
            pmesh.interval_span(P, S)
        with pytest.raises(ValueError, match=rf"interval axis \({S} shards\)"):
            pmesh.make_layout(P, S, "cpu")
        return
    per = S // g
    held = []
    for rank in range(P):
        monkeypatch.setattr(mh, "process_index", lambda: rank)
        lay = pmesh.make_layout(P, S, "cpu")
        assert (lay.interval_procs, lay.groups) == (g, P // g)
        assert (lay.group_index, lay.group_rank) == (rank // g, rank % g)
        assert lay.group_ranks == range(rank - rank % g, rank - rank % g + g)
        assert lay.held == range(per * (rank % g), per * (rank % g) + per)
        assert lay.owners == tuple(s // per for s in range(S))
        assert (lay.data_procs, lay.data_index) == (P, rank)
        grouped = pmesh.make_layout(P // g, S, "cpu")
        want = (P, rank) if g == 1 else (P // g, rank // g)
        assert (grouped.data_procs, grouped.data_index) == want
        held.append((rank // g, tuple(lay.held)))
    # every interval group holds every shard once
    for gi in range(P // g):
        assert sorted(s for grp, h in held if grp == gi for s in h) == list(range(S))
    if P // g > 1:
        with pytest.raises(ValueError, match="interval groups"):
            pmesh.make_layout(1, S, "cpu")


@pytest.mark.parametrize("rank", [0, 1, 2, 3])
def test_layout_records_the_shards_each_process_holds(monkeypatch, rank):
    monkeypatch.setattr(mh, "process_count", lambda: 4)
    monkeypatch.setattr(mh, "process_index", lambda: rank)
    lay = pmesh.make_layout(4, 8, "cpu")
    assert lay.interval_procs == 4 and lay.held == range(2 * rank, 2 * rank + 2)
    assert lay.owners == (0, 0, 1, 1, 2, 2, 3, 3)
    exact = pmesh.make_layout(1, 8, "cpu")  # every process the same reads
    assert exact.data_procs == 1 and exact.held == lay.held
    one = pmesh.make_layout(4, 1, "cpu")  # an index of one shard: whole in every process
    assert one.interval_procs == 1 and one.held == range(1) and one.data_procs == 4


@pytest.mark.parametrize("S", [1, 2, 3, 4, 8])
def test_plain_queries_read_shards_in_their_own_tensors(S):
    """Every ``local_*`` query, the plain locate, piece search and fused
    occ, the window gather and the seed-path step read a table held one
    tensor a shard (``peer.Shards``, as mapped shards are) exactly as the
    stacked table."""
    import dataclasses

    from genome_weaver_align_tpu_torch.index.build import build_fm_index as p_build
    from genome_weaver_align_tpu_torch.index.seedtable import build_seed_table
    from genome_weaver_align_tpu_torch.parallel import peer
    from genome_weaver_align_tpu_torch.parallel import sharded_index as si
    from genome_weaver_align_tpu_torch.parallel import sharded_pipeline as sp

    def apart(obj, fields):
        return dataclasses.replace(obj, **{
            f: peer.Shards([t.clone() for t in getattr(obj, f)], getattr(obj, f))
            for f in fields})

    g = sharded_genome()[:20_000]
    fm = p_build(g, sample_rate=16)
    sh = si.put_sharded(si.shard_fm_index(fm, S), "cpu")
    ap = apart(sh, si._TABLES)
    ks = torch.arange(fm.n + 2, dtype=torch.int32)
    for c in range(4):
        assert torch.equal(si.local_occ_codes(ap, torch.full_like(ks, c), ks),
                           si.local_occ_codes(sh, torch.full_like(ks, c), ks))
    assert torch.equal(si.local_occ_all4(ap, ks), si.local_occ_all4(sh, ks))
    assert torch.equal(si.local_bwt_char(ap, ks), si.local_bwt_char(sh, ks))
    rows = ks[: fm.n + 1]
    assert torch.equal(si.locate_plain(ap, rows), si.locate_plain(sh, rows))
    assert torch.equal(si.locate(ap, rows), si.locate(sh, rows))
    assert torch.equal(si.fused_occ(ap, ks % 4, ks), si.fused_occ(sh, ks % 4, ks))
    reads, lengths = (torch.from_numpy(a) for a in exact_search_reads(g))
    for a, b in zip(sp.sharded_piece_search(ap, reads, lengths, 3, EXACT_L),
                    sp.sharded_piece_search(sh, reads, lengths, 3, EXACT_L)):
        assert torch.equal(a, b)
    tx = sp.put_text(sp.shard_text(fm.text_words, fm.n, S), "cpu")
    starts = torch.arange(-40, fm.n + 40, 97, dtype=torch.int32)
    assert torch.equal(sp.gather_windows(apart(tx, ("words",)), starts, 53),
                       sp.gather_windows(tx, starts, 53))
    offsets, positions = build_seed_table(g, 6)
    st = sp.put_seed(sp.shard_seed_table(offsets, positions, 6, S), "cpu")
    layout = pmesh.make_layout(1, S, "cpu")
    step = sp.make_sharded_seed_align(layout, like_seed=st, max_len=EXACT_L, k=2)
    for a, b in zip(step(apart(st, ("offsets", "positions")), apart(tx, ("words",)), reads,
                         lengths), step(st, tx, reads, lengths)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("S", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("row", [(), (4,), (8,)], ids=["scalar", "w4", "w8"])
def test_shard_rows_of_shards_apart_equals_the_stacked_gather(S, row):
    """``shard_rows`` of a table held one tensor a shard (``peer.Shards``,
    as mapped shards are) equals the stacked table's gather at every
    per-shard index shape."""
    from genome_weaver_align_tpu_torch.parallel import peer
    from genome_weaver_align_tpu_torch.parallel import sharded_index as si

    rng = np.random.default_rng(40 + S)
    R = 37
    stacked = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, size=(S, R, *row),
                                            dtype=np.int64).astype(np.int32))
    apart = peer.Shards([t.clone() for t in stacked], stacked)
    for shape in ((S,), (S, 5), (S, 3, 7)):
        idx = torch.from_numpy(rng.integers(0, R, size=shape).astype(np.int32))
        want = si.shard_rows(stacked, idx)
        assert want.shape == (*shape, *row)
        assert torch.equal(si.shard_rows(apart, idx), want)


@pytest.mark.parametrize("P, S", [(2, 2), (2, 4), (4, 2), (4, 4), (4, 8)])
def test_exact_search_refuses_a_data_axis_over_the_processes(monkeypatch, P, S):
    """A layout whose interval groups span several processes but whose
    data axis spans the processes (``make_layout(P, S)``, as
    ``ShardedAligner`` makes it) would give the members of a group other
    reads each, and the merges would add partials of different reads: the
    exact search refuses it before it makes a collective."""
    from genome_weaver_align_tpu_torch.parallel import sharded_index as si

    monkeypatch.setattr(mh, "process_count", lambda: P)
    monkeypatch.setattr(mh, "process_index", lambda: P - 1)
    lay = pmesh.make_layout(P, S, "cpu")
    assert lay.interval_procs > 1 and lay.data_procs == P
    for merge in ("psum", "ring", "fused"):
        with pytest.raises(ValueError, match=rf"data axis \({P}\) spans the {P} processes"):
            si.make_sharded_exact_search(lay, EXACT_L, None, merge=merge)


@pytest.mark.parametrize("own, theirs, reach", [(0, 1, False), (1, 0, False), (0, 1, True),
                                                (2, 2, False)])
def test_a_card_that_cannot_reach_a_peer_raises_naming_both(monkeypatch, own, theirs, reach):
    """``peer.check_reach``, which ``share`` runs before it maps a peer's
    tensor: a card that cannot reach the card holding it raises, naming
    both; a reachable card, or the card itself, passes."""
    from genome_weaver_align_tpu_torch.parallel import peer

    monkeypatch.setattr(torch.cuda, "can_device_access_peer", lambda a, b: reach)
    if own == theirs or reach:
        peer.check_reach(own, theirs)
        return
    with pytest.raises(RuntimeError, match=rf"cuda:{own} cannot reach card cuda:{theirs}"):
        peer.check_reach(own, theirs)
