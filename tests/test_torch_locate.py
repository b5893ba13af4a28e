"""The LF-walk locate and the sharded piece search, which run as CUDA kernels
on the card (``csrc/locate.cu``, ``csrc/fm_search.cu``), on the CPU.

- The plain versions against the JAX package's functions on every row
  0..n of the test index (the primary row and n among them, and row 0,
  where the staircase pins its dead lanes): ``rank.locate_plain`` against
  the JAX ``rank.locate``, the sharded ``locate_plain`` against the JAX
  sharded ``locate`` under ``shard_map`` on the 8-device CPU mesh
  (S = 1, 2, 4, 8 at ``sample_rate`` 8 and 16), and
  ``sharded_piece_search_plain`` against the JAX ``piece_interval_search``
  at the kernels' edges (reads of length 0, 1 and < P, ragged, a
  ``max_len`` shorter than the reads).
- The scalar models of the kernels (``tests/torch_fm_models.py``, in the
  CUDA sources' loop order) against the plain versions on every row and
  lane, at S = 1..16, and the FM sharded align step with both models in
  place of the port's functions against the JAX
  ``make_sharded_pigeonhole_align``.  The locate models run the kernels'
  persistent walk on small grids: every row written once and equal to the
  plain version at row counts around the grid's capacity, on grids of one,
  two and five warps.
- ``owner_of`` (the sharded kernels' owner by division, confirmed by the
  bounds) equal to the scan for every coordinate of both splits at S =
  1..16 (the last shards empty) and on hand-made unequal bounds
  (``shard_fm_index`` at explicit block cuts), where the sharded plain
  locate and the model still equal the one-index locate.
- The bindings refuse what the kernels cannot take, and a CPU tensor
  reaches the plain version and never a kernel.

Everything is int32, so every comparison is exact equality."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

from genome_weaver_align_tpu.index import native as j_native
from genome_weaver_align_tpu.index.build import build_fm_index
from genome_weaver_align_tpu.models import suffix_filter as j_sf
from genome_weaver_align_tpu.ops import rank as j_rank
from genome_weaver_align_tpu.parallel import mesh as j_mesh
from genome_weaver_align_tpu.parallel import sharded_index as j_si
from genome_weaver_align_tpu.parallel import sharded_pipeline as j_sp
from genome_weaver_align_tpu_torch.ops import fm_search_cuda, locate_cuda, rank
from genome_weaver_align_tpu_torch.parallel import mesh as pmesh
from genome_weaver_align_tpu_torch.parallel import sharded_index as si
from genome_weaver_align_tpu_torch.parallel import sharded_pipeline as sp
from tests import torch_fm_models as models
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")
RATES = (8, 16)


@pytest.fixture(scope="module", autouse=True)
def _jax_native_off():
    """The indexes come from the JAX package's numpy SA builder, never from
    its in-place ``make -C native``."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_native, "_lib", None)
        mp.setattr(j_native, "_build_failed", True)
        yield


@pytest.fixture(scope="module")
def genome():
    """The edge-case genome (a 40 bp unit 12 times, then random) indexed at
    sample_rate 8 and 16, and every row 0..n of it."""
    codes = models.genome_codes(81, size=3_000)
    g = {"codes": codes}
    for rate in RATES:
        fm = build_fm_index(codes, sample_rate=rate)
        g[rate] = dict(fm=fm, pfm=rank.from_host(fm, CPU), jfm=j_rank.from_host(fm))
    g["rows"] = np.arange(g[8]["fm"].n + 1, dtype=np.int32)
    return g


def _sharded(genome, rate, S):
    return si.put_sharded(si.shard_fm_index(genome[rate]["fm"], S), CPU)


def _jax_sharded_locate(fm, S, rows):
    """The JAX sharded ``locate`` on S interval shards of the CPU mesh (the
    rows replicated over it)."""
    mesh = j_mesh.make_mesh(n_interval=S)
    jsh = j_si.put_sharded(j_si.shard_fm_index(fm, S), mesh, j_mesh.INTERVAL_AXIS)

    def local(sh, r):
        return j_si.locate(j_si.squeeze_local(sh), r, j_mesh.INTERVAL_AXIS)

    fn = jax.shard_map(local, mesh=mesh,
                       in_specs=(j_si.index_specs(j_mesh.INTERVAL_AXIS, jsh), PartitionSpec()),
                       out_specs=PartitionSpec(), check_vma=False)
    return np.asarray(jax.jit(fn)(jsh, jnp.asarray(rows)))


# ---------------------------------------------------------------- plain vs JAX

@pytest.mark.parametrize("rate", RATES)
def test_locate_plain_matches_jax_on_every_row(genome, rate):
    g, rows = genome[rate], genome["rows"]
    got = rank.locate_plain(g["pfm"], torch.from_numpy(rows)).numpy()
    want = np.asarray(j_rank.locate(g["jfm"], jnp.asarray(rows)))
    assert np.array_equal(got, want)
    assert np.array_equal(np.sort(got), np.arange(rows.size))  # a permutation: the SA


@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("S", [1, 2, 4, 8])
def test_sharded_locate_plain_matches_jax_on_every_row(genome, rate, S):
    rows = genome["rows"]
    got = si.locate_plain(_sharded(genome, rate, S), torch.from_numpy(rows)).numpy()
    assert np.array_equal(got, _jax_sharded_locate(genome[rate]["fm"], S, rows))


@pytest.mark.parametrize("S", [1, 2, 4, 8])
def test_sharded_piece_search_plain_matches_jax_at_edges(genome, S):
    """Each lane's (lo, hi) equals the single-index JAX piece search, whose
    trip is the sharded one's when ``max_len`` is the reads' width."""
    reads, lengths = models.edge_reads(genome["codes"], 82)
    L = reads.shape[1]
    sh = _sharded(genome, 8, S)
    for max_len in (L, 9):
        got = sp.sharded_piece_search_plain(sh, torch.from_numpy(reads),
                                            torch.from_numpy(lengths), 3, max_len)
        # the JAX piece search takes its trip as max_len, ceil(L / P) + 1 without
        trip = None if max_len == L else sp._piece_steps(max_len, 3)
        want = j_sf.piece_interval_search(genome[8]["jfm"], jnp.asarray(reads),
                                          jnp.asarray(lengths), 3, max_len=trip)[:2]
        for a, b in zip(got, want):
            assert np.array_equal(a.numpy(), np.asarray(b)), max_len


# ---------------------------------------------------------------- kernel models vs plain

@pytest.mark.parametrize("rate", RATES)
def test_locate_model_matches_plain_on_every_row(genome, rate):
    g, rows = genome[rate], genome["rows"]
    want = rank.locate_plain(g["pfm"], torch.from_numpy(rows)).numpy()
    got, writes = models.locate(g["pfm"], rows)
    assert np.array_equal(got, want)
    assert (writes == 1).all()


@pytest.mark.parametrize("rate, S", [(8, 1), (16, 3), (8, 8), (16, 16), (8, 17), (16, 32),
                                     (8, 64)])
def test_sharded_locate_model_matches_plain_on_every_row(genome, rate, S):
    """Every row 0..n, and row n + 1, which no shard owns in the row
    coordinates (the plain version's sums of zeros)."""
    sh = _sharded(genome, rate, S)
    rows = np.concatenate([genome["rows"], [genome[rate]["fm"].n + 1]]).astype(np.int32)
    want = si.locate_plain(sh, torch.from_numpy(rows)).numpy()
    got, writes = models.locate_sharded(sh, rows)
    assert np.array_equal(got, want)
    assert (writes == 1).all()


GRIDS = (32, 64, 160)  # the models' grids: one, two and five warps
ROW_COUNTS = {"0": lambda cap: 0, "1": lambda cap: 1, "31": lambda cap: 31, "33": lambda cap: 33,
              "capacity-1": lambda cap: cap - 1, "capacity+1": lambda cap: cap + 1,
              "3capacity+5": lambda cap: 3 * cap + 5}


def _walk_rows(genome, Q, seed):
    """Q rows of the test index: the edge rows (0, the primary row, n)
    first, then random rows, some repeated in runs (lanes of one warp on
    one row, as [7]'s compaction pins them)."""
    fm = genome[8]["fm"]
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, fm.n + 1, size=Q)
    rows[Q // 2:] = np.repeat(rows[Q // 2::7], 7)[: Q - Q // 2]
    rows[:3] = [0, fm.primary, fm.n][: min(Q, 3)]
    return rows.astype(np.int32)


@pytest.mark.parametrize("threads", GRIDS)
@pytest.mark.parametrize("count", list(ROW_COUNTS))
def test_locate_model_writes_every_row_once(genome, count, threads):
    """locate.cu's walk on a grid of 32, 64 and 160 threads: at Q = 0, 1,
    31, 33, the grid's capacity (its threads) +- 1 and beyond it, every
    row is written exactly once and equals ``locate_plain``."""
    rows = _walk_rows(genome, ROW_COUNTS[count](threads), 91)
    pfm = genome[8]["pfm"]
    got, writes = models.locate(pfm, rows, threads=threads)
    assert (writes == 1).all()
    assert np.array_equal(got, rank.locate_plain(pfm, torch.from_numpy(rows)).numpy())


@pytest.mark.parametrize("threads", GRIDS)
@pytest.mark.parametrize("count", list(ROW_COUNTS))
def test_sharded_locate_model_writes_every_row_once(genome, count, threads):
    """The sharded walk likewise, on 5 shards."""
    rows = _walk_rows(genome, ROW_COUNTS[count](threads), 92)
    sh = _sharded(genome, 8, 5)
    got, writes = models.locate_sharded(sh, rows, threads=threads)
    assert (writes == 1).all()
    assert np.array_equal(got, si.locate_plain(sh, torch.from_numpy(rows)).numpy())


def _scan_and_guess(sp, xs):
    return ([models.Shards.owner(sp[0], x) for x in xs], [models.owner_of(sp, x) for x in xs])


@pytest.mark.parametrize("S", [*range(1, 17), 17, 32, 64, 1024])
def test_owner_of_equals_the_scan_on_the_equal_split(S):
    """Both splits of ``shard_fm_index`` on a 2,000-base genome (16 blocks
    of 128: from S = 9 on the last shards are empty), every x of [0,
    n + 1]: the guess by division with the bindings' divisors is the scan's
    owner, confirmed (no x of [0, n] falls back to the scan)."""
    fm = build_fm_index(models.genome_codes(93, size=1_500), sample_rate=8)
    st = models.Shards(si.shard_fm_index(fm, S))
    xs = range(fm.n + 2)
    for sp in (st.pk_split, st.row_split):
        scan, guess = _scan_and_guess(sp, xs)
        assert scan == guess
        bounds, (magic, shift), apart, _ = sp
        assert apart
        assert all(((x * magic) >> 32) >> shift == s for x, s in zip(xs, scan) if s >= 0)
        assert scan[-1] == -1 and min(scan[:-1]) == 0  # n + 1 has no owner; [0, n] all do
    if S > 8:
        assert st.pk[0][-1] == st.pk[1][-1] == fm.n + 1  # an empty last shard


# block cuts of the packed and the row coordinates (29 and 28 blocks)
UNEQUAL = [([0, 3, 4, 16, 30], [0, 9, 10, 11, 30]), ([0, 1, 30], [0, 20, 28]),
           ([0, 5, 5, 9, 12, 30], [0, 2, 2, 17, 18, 30]), ([0, 30], [0, 30]),
           (models.unequal_cuts(32, 30, 5), models.unequal_cuts(32, 30, 6))]


@pytest.mark.parametrize("cuts", UNEQUAL, ids=["S4", "S2", "S5-empty", "S1", "S32"])
def test_owner_of_and_the_locates_on_unequal_bounds(genome, cuts):
    """Hand-made unequal splits (an empty shard among them): ``owner_of``
    equals the scan for every coordinate, and the sharded plain locate and
    its model equal the one-index locate on every row, and the model of
    the sharded piece search the one-index search."""
    fm = genome[8]["fm"]
    sh = si.put_sharded(si.shard_fm_index(fm, len(cuts[0]) - 1, *cuts), CPU)
    st = models.Shards(sh)
    xs = range(-2, fm.n + 3)
    for sp in (st.pk_split, st.row_split):
        scan, guess = _scan_and_guess(sp, xs)
        assert scan == guess
    rows = genome["rows"]
    want = rank.locate_plain(genome[8]["pfm"], torch.from_numpy(rows)).numpy()
    assert np.array_equal(si.locate_plain(sh, torch.from_numpy(rows)).numpy(), want)
    got, writes = models.locate_sharded(sh, rows)
    assert np.array_equal(got, want) and (writes == 1).all()
    reads, lengths = models.edge_reads(genome["codes"], 94)
    one = models.backward_search(genome[8]["pfm"], reads, lengths, 3, reads.shape[1])
    for a, b in zip(models.backward_search_sharded(sh, reads, lengths, 3, reads.shape[1]), one):
        assert np.array_equal(a, b)


def test_shard_fm_index_at_its_own_equal_cuts_gives_the_equal_split(genome):
    """``shard_fm_index`` given its default cuts explicitly gives the same
    arrays, and it refuses cuts it cannot take."""
    fm, S = genome[8]["fm"], 4
    want = si.shard_fm_index(fm, S)
    nbs = want.bwt_blocks.shape[1] - 1
    mbs = want.mark_blocks.shape[1]
    got = si.shard_fm_index(fm, S, [s * nbs for s in range(S + 1)], [s * mbs for s in range(S + 1)])
    for f in dataclasses.fields(want):
        assert np.array_equal(np.asarray(getattr(got, f.name)), np.asarray(getattr(want, f.name)))
    for cuts in ([0, 5, 30], [1, 5, 9, 12, 30], [0, 9, 5, 12, 30]):
        with pytest.raises(ValueError, match="block cuts"):
            si.shard_fm_index(fm, S, cuts, [s * mbs for s in range(S + 1)])


@pytest.mark.parametrize("S", [1, 3, 16, 32, 1024])
@pytest.mark.parametrize("max_len", [None, 9])
def test_sharded_piece_search_model_matches_plain(genome, S, max_len):
    reads, lengths = models.edge_reads(genome["codes"], 83)
    max_len = max_len or reads.shape[1]
    sh = _sharded(genome, 8, S)
    want = sp.sharded_piece_search_plain(sh, torch.from_numpy(reads), torch.from_numpy(lengths),
                                         3, max_len)
    got = models.backward_search_sharded(sh, reads, lengths, 3, sp._piece_steps(max_len, 3))
    for a, b in zip(want, got):
        assert np.array_equal(a.numpy(), b)


def test_pigeonhole_step_with_the_models_matches_jax(genome, monkeypatch):
    """The FM sharded align step with the piece search and the locate of
    the kernels' models in place of the plain loops (1 data x 4 interval
    shards) equals the JAX ``make_sharded_pigeonhole_align``."""
    codes, fm = genome["codes"], genome[16]["fm"]
    rng = np.random.default_rng(84)
    k, L, B, S = 2, 40, 24, 4
    reads = np.stack([codes[p:p + L] for p in rng.integers(0, codes.size - L, size=B)])
    reads = reads.astype(np.int32)
    reads[::3, 7] = (reads[::3, 7] + 1) % 4
    lengths = np.full(B, L, np.int32)
    jm = j_mesh.make_mesh(n_data=1, n_interval=S)
    jsh = j_si.put_sharded(j_si.shard_fm_index(fm, S), jm, j_mesh.INTERVAL_AXIS)
    jtx = j_sp.put_text(j_sp.shard_text(fm.text_words, fm.n, S), jm, j_mesh.INTERVAL_AXIS)
    jfn = j_sp.make_sharded_pigeonhole_align(
        jm, j_mesh.INTERVAL_AXIS, j_mesh.DATA_AXIS, like_index=jsh, like_text=jtx, max_len=L,
        k=k, max_hits=8)
    r, ln = j_mesh.shard_reads(jm, reads, lengths)[:2]
    want = [np.asarray(x)[:B] for x in jfn(jsh, jtx, r, ln)]

    def search_model(sh, reads, lengths, P, max_len):
        out = models.backward_search_sharded(sh, reads.numpy(), lengths.numpy(), P,
                                             sp._piece_steps(max_len, P))
        return tuple(torch.from_numpy(x) for x in out)

    monkeypatch.setattr(sp, "sharded_piece_search", search_model)
    monkeypatch.setattr(si, "locate",
                        lambda sh, rows: torch.from_numpy(models.locate_sharded(sh, rows.numpy())[0]))
    layout = pmesh.make_layout(1, S, "cpu")
    sh = si.put_sharded(si.shard_fm_index(fm, S), CPU)
    tx = sp.put_text(sp.shard_text(fm.text_words, fm.n, S), CPU)
    fn = sp.make_sharded_pigeonhole_align(layout, like_index=sh, like_text=tx, max_len=L, k=k,
                                          max_hits=8)
    r, ln, _ = pmesh.shard_reads(layout, reads, lengths)
    got = [x.numpy()[:B] for x in fn(sh, tx, r, ln)]
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    assert int((want[1] <= k).sum()) > B // 2


# ---------------------------------------------------------------- bindings and dispatch

def test_locate_bindings_refuse_what_the_kernels_cannot_take(genome):
    pfm, fm = genome[8]["pfm"], genome[8]["fm"]
    rows = torch.arange(10, dtype=torch.int32)
    r = torch.zeros((4, 20), dtype=torch.int32)
    ln = torch.full((4,), 20, dtype=torch.int32)
    sh = _sharded(genome, 8, 4)
    sh17 = si.put_sharded(si.shard_fm_index(fm, 17), CPU)

    def shifted(t):
        """``t``'s values in a tensor that starts 4 bytes past an aligned one."""
        s = torch.empty(t.numel() + 1, dtype=t.dtype)[1:].view(t.shape)
        s.copy_(t)
        return s

    bad = [
        (lambda: locate_cuda.locate_cuda(pfm, rows), "CUDA device"),
        (lambda: locate_cuda.locate_cuda(pfm, rows.long()), "int32"),
        (lambda: locate_cuda.locate_cuda(pfm, r.t()), "contiguous"),
        (lambda: locate_cuda.locate_cuda(
            dataclasses.replace(pfm, mark_blocks=shifted(pfm.mark_blocks)), rows), "aligned"),
        (lambda: locate_cuda.locate_cuda(
            dataclasses.replace(pfm, blocks=shifted(pfm.blocks)), rows), "aligned"),
        (lambda: locate_cuda.locate_cuda(
            dataclasses.replace(pfm, mark_cp=pfm.mark_cp[:-1]), rows), "checkpoints"),
        (lambda: locate_cuda.locate_sharded_cuda(sh, rows), "CUDA device"),
        (lambda: locate_cuda.locate_sharded_cuda(sh, rows.short()), "int32"),
        (lambda: locate_cuda.locate_sharded_cuda(sh17, rows), "CUDA device"),  # 17 taken
        (lambda: locate_cuda.locate_sharded_cuda(
            dataclasses.replace(sh, bwt_blocks=shifted(sh.bwt_blocks)), rows), "aligned"),
        (lambda: locate_cuda.locate_sharded_cuda(
            dataclasses.replace(sh, mark_blocks=shifted(sh.mark_blocks)), rows), "aligned"),
        (lambda: locate_cuda.locate_sharded_cuda(
            dataclasses.replace(sh, ssa_base=sh.ssa_base[:2]), rows), "shapes"),
        (lambda: locate_cuda.launch_shape(-1, CPU, False), "0 to 2"),
        (lambda: locate_cuda.launch_shape(locate_cuda.MAX_ROWS + 1, CPU, True), "0 to 2"),
        (lambda: fm_search_cuda.backward_search_sharded_cuda(sh, r, ln, 3, 8), "CUDA device"),
        (lambda: fm_search_cuda.backward_search_sharded_cuda(sh17, r, ln, 3, 8), "CUDA device"),
        (lambda: fm_search_cuda.backward_search_sharded_cuda(sh, r.long(), ln, 3, 8), "int32"),
        (lambda: fm_search_cuda.backward_search_sharded_cuda(sh, r, ln, 33, 8), "n_pieces=33"),
        (lambda: fm_search_cuda.backward_search_sharded_cuda(
            dataclasses.replace(sh, occ_cp=shifted(sh.occ_cp)), r, ln, 3, 8), "aligned"),
    ]
    for call, match in bad:
        with pytest.raises(ValueError, match=match):
            call()


def test_cpu_tensors_take_the_plain_locate_and_search(genome, monkeypatch):
    """On the CPU ``rank.locate``, the sharded ``locate`` and the sharded
    piece search run their plain loops: the kernels' wrappers are never
    called."""
    def refuse(*a, **k):
        raise AssertionError("a CPU tensor reached a CUDA kernel wrapper")

    for mod, fn in ((locate_cuda, "locate_cuda"), (locate_cuda, "locate_sharded_cuda"),
                    (fm_search_cuda, "backward_search_sharded_cuda")):
        monkeypatch.setattr(mod, fn, refuse)
    rows = torch.from_numpy(genome["rows"])
    pfm, sh = genome[8]["pfm"], _sharded(genome, 8, 4)
    assert torch.equal(rank.locate(pfm, rows), rank.locate_plain(pfm, rows))
    assert torch.equal(si.locate(sh, rows), si.locate_plain(sh, rows))
    reads, lengths = (torch.from_numpy(a) for a in models.edge_reads(genome["codes"], 85))
    for a, b in zip(sp.sharded_piece_search(sh, reads, lengths, 3, reads.shape[1]),
                    sp.sharded_piece_search_plain(sh, reads, lengths, 3, reads.shape[1])):
        assert torch.equal(a, b)
