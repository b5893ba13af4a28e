"""Interval groups that span hosts (BASELINE config 5: the index sharded
across hosts, the interval merge by collectives) on the CPU.  The hosts are
declared the way a multi-node launch states them: each process's
``GROUP_RANK`` (``tests/torch_multihost_driver.py`` ``launch(nodes=...)``,
mode ``interval``).  4 processes on two hosts (ranks 0-1 and 2-3) and 2
processes on two hosts, S = 4 shards: one interval group across both hosts,
so the whole world takes the collective route.

- the seed-path and FM-path ``ShardedAligner`` SAMs equal the 1-process SAMs
  and the JAX package's byte for byte, but ``@PG``;
- the exact search's psum (lo, hi, pos) in every process equals the JAX
  ``make_sharded_exact_search`` on a (1, S) mesh on its group's rows, with
  one merge an extension step and chunk and ``sample_rate + 1`` in the
  locate; the ring and fused merges raise, naming the two hosts;
- each process holds its own shards only, as plain tensors, never calls
  ``peer.share`` (replaced by a function that raises) and makes no text
  shards; its merges go over gloo;
- ``mesh.make_layout``'s route and data axis over P = 1..4, S = 1, 2, 4, 8
  and four host maps, and ``ShardedAligner``'s layout and uploads on the
  collective route in one process standing for each rank;
- the collective locate and piece search (one merge a step) in g threads
  standing for the processes of a group, each holding S / g shards, against
  the JAX sharded ``locate`` under ``shard_map``, the port's ``locate_plain``
  and the stacked piece search, at S = 1..8;
- the sharded kernels' owner guess over a process's held shards (the scalar
  model of ``csrc/fm_occ.cuh`` ``owner_of``): exact for every coordinate
  they own, none for the others, at S = 2..16."""

import functools
import json
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

from genome_weaver_align_tpu.index import native as j_native
from genome_weaver_align_tpu.index.build import build_fm_index
from genome_weaver_align_tpu.index.files import Genome as JGenome
from genome_weaver_align_tpu.index.files import build_genome_index as j_genome_index
from genome_weaver_align_tpu.ops import affine as j_affine
from genome_weaver_align_tpu.parallel import mesh as j_mesh
from genome_weaver_align_tpu.parallel import sharded_index as j_si
from genome_weaver_align_tpu.parallel import sharded_pipeline as j_sp
from genome_weaver_align_tpu.utils import sam as j_sam
from genome_weaver_align_tpu.utils.fasta import Contig as JContig
from genome_weaver_align_tpu.utils.fasta import Read as JRead
from genome_weaver_align_tpu_torch.index.files import Genome, build_genome_index
from genome_weaver_align_tpu_torch.index.seedtable import build_seed_table
from genome_weaver_align_tpu_torch.parallel import mesh as pmesh
from genome_weaver_align_tpu_torch.parallel import multihost as mh
from genome_weaver_align_tpu_torch.parallel import peer
from genome_weaver_align_tpu_torch.parallel import sharded_index as si
from genome_weaver_align_tpu_torch.parallel import sharded_pipeline as sp
from genome_weaver_align_tpu_torch.utils.fasta import Contig
from tests import torch_fm_models as models
from tests.torch_multihost_driver import (
    EXACT_L, exact_search_reads, launch, sharded_batches, sharded_genome, sharded_main,
)
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

TESTS = Path(__file__).resolve().parent
CPU = torch.device("cpu")
SHARDS = 4
# P processes at S shards, each process's node rank: two hosts
RUNS = {"P4-S4": (4, SHARDS, (0, 0, 1, 1)), "P2-S4": (2, SHARDS, (0, 1))}
# host maps of P processes: one host, halves, alternating, a host each
HOST_MAPS = {"one": lambda r, P: "a", "halves": lambda r, P: f"h{r * 2 // P}",
             "alternate": lambda r, P: f"h{r % 2}", "each": lambda r, P: f"h{r}"}


@pytest.fixture(scope="module", autouse=True)
def _jax_native_off():
    """The JAX side runs its numpy builders and scored engine, never its
    in-place ``make -C native``."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_native, "_lib", None)
        mp.setattr(j_native, "_build_failed", True)
        mp.setattr(j_affine, "_native_fn", None)
        mp.setattr(j_affine, "_native_failed", True)
        yield


@pytest.fixture(scope="module", params=list(RUNS))
def run(request, tmp_path_factory):
    """One run of the driver's ``interval`` mode: (P, S, the run's directory,
    every process's facts)."""
    P, S, nodes = RUNS[request.param]
    d = tmp_path_factory.mktemp(request.param)
    launch(P, d / "out.sam", "interval", "--n-interval", str(S), "--device", "cpu", timeout=180,
           nodes=nodes)
    return P, S, d, [json.loads((d / f"out.sam.{p}.json").read_text()) for p in range(P)]


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    """The 1-process port SAMs at S shards and the JAX package's, seed path
    and FM path."""
    d = tmp_path_factory.mktemp("refs")
    sharded_main(0, d / "one.sam", CPU, SHARDS).close()
    sharded_main(0, d / "one.fm.sam", CPU, SHARDS, seed_table=False).close()
    launch(1, d / "jax.sam", "sharded", driver=TESTS / "multihost_driver.py", timeout=120)
    g = sharded_genome()
    gi = j_genome_index(JGenome.from_contigs([JContig("c1", g)]), sample_rate=16)
    al = j_sp.ShardedAligner(gi, k=2, n_interval=SHARDS, max_hits=8,
                             devices=jax.devices()[:SHARDS])
    recs = []
    for _, batch in sharded_batches(g):
        reads = [JRead(name, codes) for name, codes in batch]
        recs.extend(al.to_sam(reads, al.align_batch(reads)))
    j_sam.write_sam(str(d / "jax.fm.sam"), al.sam_header(), recs)
    return {name: (d / name).read_text() for name in ("one.sam", "one.fm.sam", "jax.sam",
                                                      "jax.fm.sam")}


def _body(text: str) -> list[str]:
    return [ln for ln in text.splitlines() if not ln.startswith("@PG")]


# the SAM of each path: this run's, the 1-process port's and the JAX package's
SAMS = {"seed": ("out.sam", "one.sam", "jax.sam"), "fm": ("out.sam.fm.sam", "one.fm.sam",
                                                          "jax.fm.sam")}


@pytest.mark.parametrize("path", list(SAMS))
def test_sam_across_hosts_equals_one_process_and_jax(run, refs, path):
    P, S, d, _ = run
    mine, one, jx = SAMS[path]
    got = (d / mine).read_text()
    assert got == refs[one]
    assert _body(got) == _body(refs[jx])
    assert len([ln for ln in got.splitlines() if ln[0] != "@"]) == 128


@functools.cache
def _jax_exact(S: int):
    g = sharded_genome()
    fm = build_fm_index(g, sample_rate=16)
    reads, lengths = exact_search_reads(g)
    jm = j_mesh.make_mesh(n_data=1, n_interval=S, devices=jax.devices()[:S])
    jsh = j_si.put_sharded(j_si.shard_fm_index(fm, S), jm, j_mesh.INTERVAL_AXIS)
    fn = j_si.make_sharded_exact_search(jm, j_mesh.INTERVAL_AXIS, j_mesh.DATA_AXIS,
                                        max_len=EXACT_L, like=jsh, merge="psum", microbatch=2)
    r, ln, _ = j_mesh.shard_reads(jm, reads, lengths)
    return [np.asarray(v)[: reads.shape[0]] for v in fn(jsh, r, ln)]


def test_exact_search_psum_across_hosts_equals_jax(run):
    P, S, d, facts = run
    want = _jax_exact(S)
    assert (want[1] > want[0]).sum() > len(want[0]) // 2
    for pid in range(P):
        got = np.load(d / f"out.sam.{pid}.npz")
        first, stop = facts[pid]["rows"]
        assert (first, stop) == (0, len(want[0]))  # one group: every process the whole batch
        for key, w in zip(("lo", "hi", "pos"), want):
            assert np.array_equal(got[f"psum_{key}"], w[first:stop]), (pid, key)
        # one merge an extension step and chunk (2 chunks), one a locate step
        # and one for the sampled values, all over gloo
        assert facts[pid]["routes"] == {**dict.fromkeys(si.CROSS_MERGES, 0),
                                        "psum gloo": 2 * EXACT_L + 16 + 1}


def test_ring_and_fused_raise_naming_the_hosts(run):
    P, S, _, facts = run
    for f in facts:
        a, b = dict.fromkeys(f["hosts"])
        assert a.endswith("/node0") and b.endswith("/node1")
        for merge in ("ring", "fused"):
            msg = f["refused"][merge]
            assert f"merge={merge!r}" in msg and repr(a) in msg and repr(b) in msg


def test_each_process_holds_its_own_shards_and_maps_nothing(run):
    """Every table here is the process's held shards alone, a plain tensor
    (``peer.share`` raises in these processes, so nothing was mapped), no
    text shards exist, and the aligners' merges went over gloo."""
    P, S, _, facts = run
    per = S // P
    for pid, f in enumerate(facts):
        assert f["collective"] and not f["mapped"]
        assert f["held"] == list(range(pid * per, (pid + 1) * per))
        assert f["group"] == list(range(P)) and f["data"] == [1, 0]
        assert not f["text_shards"]
        assert all(f["plain"].values())
        for table, (here, stacked) in f["bytes"].items():
            if stacked is not None:
                assert here * P == stacked, table
        assert [rows for rows, *_ in f["seed_rows"]] == [per, per]
        routes = f["aligner_routes"]
        assert routes["psum gloo"] > 0 and routes["all_gather gloo"] > 0
        assert sum(routes.values()) == routes["psum gloo"] + routes["all_gather gloo"]


def _route(P, S, hosts):
    """(mapped, g): whether every interval group lies on one host."""
    g = pmesh.interval_span(P, S)
    return all(len({hosts[r] for r in grp}) == 1 for grp in mh.groups_of(P, g)), g


@pytest.mark.parametrize("hostmap", list(HOST_MAPS))
@pytest.mark.parametrize("S", [1, 2, 4, 8])
@pytest.mark.parametrize("P", [1, 2, 3, 4])
def test_layout_route_and_data_axis(monkeypatch, P, S, hostmap):
    """The route follows the hosts of the interval groups; the collective
    route's data axis (``ShardedAligner``: the groups) gives every member of
    a group the group's slice and its held shards."""
    hosts = [HOST_MAPS[hostmap](r, P) for r in range(P)]
    monkeypatch.setattr(mh, "process_count", lambda: P)
    monkeypatch.setattr(mh, "host_of", lambda r: hosts[r])
    if P == 3 and S > 1:  # neither divides the other: refused, whatever the hosts
        with pytest.raises(ValueError, match="interval axis"):
            pmesh.make_layout(P, S, "cpu")
        return
    mapped, g = _route(P, S, hosts)
    assert pmesh.groups_mapped(P, S) == mapped
    per = S // g
    for rank in range(P):
        monkeypatch.setattr(mh, "process_index", lambda: rank)
        lay = pmesh.make_layout(P, S, "cpu")
        assert lay.mapped == mapped and lay.collective == (g > 1 and not mapped)
        assert lay.held == range(per * (rank % g), per * (rank % g) + per)
        if lay.collective:
            grouped = pmesh.make_layout(lay.groups, S, "cpu")
            assert grouped.collective and grouped.held == lay.held
            assert (grouped.data_procs, grouped.data_index) == (P // g, rank // g)
        else:
            assert (lay.data_procs, lay.data_index) == (P, rank)


@functools.cache
def _small_index():
    g = sharded_genome()[:8_000]
    return g, build_genome_index(Genome.from_contigs([Contig("c1", g)]), sample_rate=8)


@pytest.mark.parametrize("P, S, hostmap", [(4, 4, "halves"), (2, 4, "each"), (4, 2, "alternate"),
                                           (4, 8, "halves"), (2, 2, "each")])
def test_sharded_aligner_takes_the_collective_route(monkeypatch, P, S, hostmap):
    """``ShardedAligner`` in one process standing for each rank in turn: its
    layout's data axis spans the groups, it uploads its held shards of the
    index and the seed table only, makes no text shards, maps nothing
    (``peer.share`` raises) and closes without ``peer.release``; the exact
    search refuses ring and fused, naming two hosts, before any
    collective."""
    hosts = [HOST_MAPS[hostmap](r, P) for r in range(P)]
    g_codes, gi = _small_index()
    seed = build_seed_table(g_codes, 6)
    stacked = si.shard_fm_index(gi.fwd, S)

    def refuse(*_a, **_k):
        raise AssertionError("nothing may be mapped on the collective route")

    monkeypatch.setattr(mh, "process_count", lambda: P)
    monkeypatch.setattr(mh, "host_of", lambda r: hosts[r])
    monkeypatch.setattr(peer, "share", refuse)
    monkeypatch.setattr(peer, "release", refuse)
    g = pmesh.interval_span(P, S)
    for rank in range(P):
        monkeypatch.setattr(mh, "process_index", lambda: rank)
        al = sp.ShardedAligner(gi, k=2, n_interval=S, seed_table=seed, seed_j=6, device="cpu")
        lay = al.layout
        assert lay.collective and (lay.n_data, lay.data_procs) == (P // g, P // g)
        assert lay.data_index == rank // g
        held = lay.held
        assert al.tx is None
        for f in si._TABLES:
            t = getattr(al.sh, f)
            assert type(t) is torch.Tensor
            assert torch.equal(t, torch.from_numpy(getattr(stacked, f)[held.start : held.stop]
                                                   .view(np.int32)))
        assert al.sh.pk_start.shape == (S,)  # the bounds stay every shard's
        assert al.sst.offsets.shape[0] == al.sst.positions.shape[0] == len(held)
        a, b = list(dict.fromkeys(hosts))[:2]
        for merge in ("ring", "fused"):
            with pytest.raises(ValueError, match=rf"spans hosts '{a}' and '{b}'"):
                si.make_sharded_exact_search(pmesh.make_layout(lay.groups, S, "cpu"), EXACT_L,
                                             merge=merge)
        al.close()
        assert al.sh is None


class _Group:
    """g threads standing for the processes of an interval group: the merge
    of thread r sums its held partials and all-reduces the sums behind a
    barrier, as ``sharded_index._psum_across`` does over gloo."""

    def __init__(self, g: int):
        self.g = g
        self.barrier = threading.Barrier(g, timeout=60)
        self.slots = [None] * g
        self.merges = [0] * g

    def merge_of(self, r: int):
        def merge(parts):
            self.slots[r] = parts.sum(0, dtype=torch.int32)
            self.barrier.wait()
            out = torch.stack(self.slots).sum(0, dtype=torch.int32)
            self.barrier.wait()
            self.merges[r] += 1
            return out
        return merge

    def run(self, fn):
        """fn(rank, merge) in every thread -> their results in rank order."""
        with ThreadPoolExecutor(self.g) as ex:
            return [f.result() for f in [ex.submit(fn, r, self.merge_of(r)) for r in range(self.g)]]


def _held(fm, S: int, g: int, rank: int):
    """What process ``rank`` of a collective interval group of g holds: its
    own shards, uploaded alone, as ``held_index`` gives them."""
    lay = pmesh.ShardLayout(1, S, CPU, rank, g, g, 1, mapped=False)
    return si.held_index(si.put_sharded(si.shard_fm_index(fm, S), CPU, lay), lay)


def _jax_sharded_locate(fm, S, rows):
    mesh = j_mesh.make_mesh(n_interval=S, devices=jax.devices()[:S])
    jsh = j_si.put_sharded(j_si.shard_fm_index(fm, S), mesh, j_mesh.INTERVAL_AXIS)

    def local(sh, r):
        return j_si.locate(j_si.squeeze_local(sh), r, j_mesh.INTERVAL_AXIS)

    fn = jax.shard_map(local, mesh=mesh,
                       in_specs=(j_si.index_specs(j_mesh.INTERVAL_AXIS, jsh), PartitionSpec()),
                       out_specs=PartitionSpec(), check_vma=False)
    return np.asarray(jax.jit(fn)(jsh, jnp.asarray(rows)))


@functools.cache
def _locate_genome():
    return build_fm_index(models.genome_codes(81, size=3_000), sample_rate=8)


@pytest.mark.parametrize("S", range(1, 9))
def test_collective_locate_one_merge_a_step_equals_jax(S):
    """``locate_collective`` in each of g threads (every g dividing S),
    each holding S / g shards: every row 0..n equals the JAX sharded
    ``locate`` (three psums a step) and the port's ``locate_plain``, after
    exactly ``sample_rate + 1`` merges."""
    fm = _locate_genome()
    rows = np.arange(fm.n + 1, dtype=np.int32)
    want = _jax_sharded_locate(fm, S, rows)
    assert np.array_equal(si.locate_plain(si.put_sharded(si.shard_fm_index(fm, S), CPU),
                                          torch.from_numpy(rows)).numpy(), want)
    for g in (d for d in range(1, S + 1) if S % d == 0):
        grp = _Group(g)
        got = grp.run(lambda r, merge: si.locate_collective(_held(fm, S, g, r),
                                                             torch.from_numpy(rows), merge))
        for out in got:
            assert np.array_equal(out.numpy(), want), g
        assert grp.merges == [fm.sample_rate + 1] * g


@pytest.mark.parametrize("S", [1, 2, 3, 4, 8])
def test_held_piece_search_equals_the_stacked_search(S):
    """``held_piece_search`` in g threads, each over its held shards with one
    merge a step, equals the stacked plain piece search on every lane."""
    g_codes = sharded_genome()[:20_000]
    fm = build_fm_index(g_codes, sample_rate=16)
    reads, lengths = (torch.from_numpy(a) for a in exact_search_reads(g_codes))
    want = sp.sharded_piece_search_plain(si.put_sharded(si.shard_fm_index(fm, S), CPU), reads,
                                         lengths, 3, EXACT_L)
    for g in (d for d in range(1, S + 1) if S % d == 0):
        grp = _Group(g)
        got = grp.run(lambda r, merge: sp.held_piece_search(_held(fm, S, g, r), reads, lengths, 3,
                                                            EXACT_L, merge))
        for lo, hi in got:
            assert torch.equal(lo, want[0]) and torch.equal(hi, want[1])
        assert grp.merges == [sp._piece_steps(EXACT_L, 3)] * g


@pytest.mark.parametrize("S", [*range(2, 17), 34, 64])
def test_owner_guess_over_held_shards(S):
    """The sharded kernels' owner guess (the model of ``fm_occ.cuh``
    ``owner_of``) over the bounds of every run of consecutive shards a
    process can hold (g dividing S): every coordinate of [0, n + 1] gets
    the scan's owner, the guess by division from the first held start is
    that owner wherever one exists, and coordinates outside the held
    shards have none."""
    fm = build_fm_index(models.genome_codes(93, size=1_500), sample_rate=8)
    st = models.Shards(si.shard_fm_index(fm, S))
    xs = range(fm.n + 2)
    for g in (d for d in range(2, S + 1) if S % d == 0):
        per = S // g
        for rank in range(g):
            a, b = rank * per, (rank + 1) * per
            for bounds, (magic, shift), *_ in (st.pk_split, st.row_split):
                held = (bounds[0][a:b], bounds[1][a:b])
                sp_ = (held, (magic, shift), *models.facts(held))  # the kernel's divisor
                base = int(held[0][0])
                for x in xs:
                    s = models.owner_of(sp_, x)
                    whole = models.Shards.owner(bounds, x)
                    assert s == (whole - a if a <= whole < b else -1), (g, rank, x)
                    if s >= 0:
                        assert ((((x - base) & models.M32) * magic) >> 32) >> shift == s
