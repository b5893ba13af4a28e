"""The sharded verify's window gather (``sharded_pipeline.gather_windows``:
each base read from the one shard that owns it) and the seed path past 16
shards, on the CPU (tolerance: equal on every element, the pipeline is
integer):

- the gather equals the owner-computes merge the JAX package runs (every
  shard's partial codes and ownership mask from its
  ``local_gather_windows``, summed over the shards, code 4 where no shard
  owns a position) and the whole text's windows, at S = 1-257
  and on unequal shard bounds with empty shards, with the shards stacked,
  one allocation a shard, and mapped from files as another process's are
  (``peer.shards`` over shared-memory files);
- the seed align step at S = 32 equals the JAX step on one shard and the
  port's own at S = 1, in each layout, and at S = 8 the JAX step on a
  (1, 8) mesh;
- the verify's largest allocation does not grow with S (``torch.profiler``
  with ``profile_memory``, S = 4 against S = 256 on the same lanes)."""

import types

import numpy as np
import pytest
import torch

from genome_weaver_align_tpu.index import native as j_native
from genome_weaver_align_tpu.index.build import build_fm_index
from genome_weaver_align_tpu.index.seedtable import build_seed_table
from genome_weaver_align_tpu.parallel import mesh as j_mesh
from genome_weaver_align_tpu.parallel import sharded_pipeline as j_sp
from genome_weaver_align_tpu_torch.models import suffix_filter as sf
from genome_weaver_align_tpu_torch.ops import window
from genome_weaver_align_tpu_torch.parallel import mesh as pmesh
from genome_weaver_align_tpu_torch.parallel import peer
from genome_weaver_align_tpu_torch.parallel import sharded_pipeline as sp
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

LAYOUTS = ("stacked", "apart", "mapped")


@pytest.fixture(scope="module", autouse=True)
def _jax_native_off():
    """The JAX side runs its numpy builders, never its in-place ``make -C
    native``."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_native, "_lib", None)
        mp.setattr(j_native, "_build_failed", True)
        yield


def _laid_out(table: torch.Tensor, layout: str, tmp_path):
    """A stacked (S, R) table as one allocation a shard, or as two
    processes' halves mapped from shared-memory files (``peer.shards``, as
    ``peer.share`` maps them on the CPU), or as it is."""
    if layout == "stacked":
        return table
    S = table.shape[0]
    if layout == "apart":
        return peer.Shards([t.clone() for t in table], table)
    P = 2 if S % 2 == 0 else 1
    per = S // P
    maps = []
    for o in range(P):
        path = tmp_path / f"shards{o}.bin"
        table[o * per:(o + 1) * per].contiguous().numpy().tofile(path)
        maps.append(torch.from_file(str(path), shared=True, size=per * table.shape[1],
                                    dtype=table.dtype).view(per, table.shape[1]))
    lay = types.SimpleNamespace(held=range(per), owners=tuple(s // per for s in range(S)),
                                group_rank=0)
    return peer.shards(peer.Shared(maps, [None] * P), lay)


def _with_words(tx: sp.ShardedText, layout: str, tmp_path) -> sp.ShardedText:
    return sp.ShardedText(_laid_out(tx.words, layout, tmp_path), tx.base, tx.end, tx.n)


def _owner_sum(tx: sp.ShardedText, starts: torch.Tensor, width: int) -> torch.Tensor:
    """The owner-computes merge of the JAX package: every shard's partial
    codes and ownership mask (``local_gather_windows``), summed over the
    shards; code 4 where no shard owns."""
    import jax.numpy as jnp

    words = tx.words.numpy().view(np.uint32)
    q = jnp.asarray(starts.numpy())
    code = owned = 0
    for s in range(words.shape[0]):
        shard = j_sp.ShardedText(jnp.asarray(words[s]), jnp.int32(int(tx.base[s])),
                                 jnp.int32(int(tx.end[s])), tx.n)
        c, own = j_sp.local_gather_windows(shard, q, width)
        code, owned = code + np.asarray(c), owned + np.asarray(own)
    assert int(owned.max()) <= 1  # disjoint ownership
    return torch.from_numpy(np.where(owned > 0, code, 4).astype(np.int8))


def _unequal_text(text_words: np.ndarray, n: int, cuts) -> sp.ShardedText:
    """Shards cut at the given word indices (some empty), each padded to the
    longest: the text split at unequal bounds."""
    edges = [0, *cuts, text_words.size]
    S = len(edges) - 1
    ws = max(max(edges[s + 1] - edges[s] for s in range(S)), 1)
    words = np.zeros((S, ws), np.uint32)
    base = np.zeros(S, np.int32)
    end = np.zeros(S, np.int32)
    for s in range(S):
        w0, w1 = edges[s], edges[s + 1]
        words[s, : w1 - w0] = text_words[w0:w1]
        base[s], end[s] = min(16 * w0, n), min(16 * w1, n)
    return sp.ShardedText(torch.from_numpy(words.view(np.int32)), torch.from_numpy(base),
                          torch.from_numpy(end), n)


def _genome(n, seed):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=n, dtype=np.uint8)
    return codes, build_fm_index(codes, sample_rate=16)


def _starts(n, width, seed):
    rng = np.random.default_rng(seed)
    edge = [-width - 3, -width, -width + 1, -1, 0, 1, 15, 16, n - width, n - 1, n, n + 7]
    return torch.from_numpy(np.concatenate([edge, rng.integers(-width, n + 4, size=500)])
                            .astype(np.int32))


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("S", [1, 3, 4, 32, 257])
def test_gather_windows_equals_the_owner_sum(S, layout, tmp_path):
    """Windows on and off both ends of the genome, across shard bounds, and
    (at S = 257, more shards than a window's width of words) over several
    shards each."""
    codes, fm = _genome(9_000 + 13, S)
    n, width = fm.n, 106
    stacked = sp.put_text(sp.shard_text(fm.text_words, n, S), "cpu")
    tx = _with_words(stacked, layout, tmp_path)
    starts = _starts(n, width, S)
    got = sp.gather_windows(tx, starts, width)
    assert got.dtype == torch.int8 and got.shape == (starts.shape[0], width)
    assert torch.equal(got, _owner_sum(stacked, starts, width))
    whole = torch.from_numpy(fm.text_words.view(np.int32))
    assert torch.equal(got, window.gather_windows(whole, n, starts, width).to(torch.int8))


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("cuts", [(1, 2, 300), (0, 0, 40, 41, 41, 560), (100, 101, 102)])
def test_gather_windows_on_unequal_bounds(cuts, layout, tmp_path):
    """Shards of 0 to hundreds of words, empty shards first, inside and
    last: each position still read from its owner."""
    codes, fm = _genome(10_000, 7)
    n, width = fm.n, 53
    stacked = _unequal_text(fm.text_words, n, cuts)
    tx = _with_words(stacked, layout, tmp_path)
    starts = _starts(n, width, len(cuts))
    got = sp.gather_windows(tx, starts, width)
    assert torch.equal(got, _owner_sum(stacked, starts, width))
    whole = torch.from_numpy(fm.text_words.view(np.int32))
    assert torch.equal(got, window.gather_windows(whole, n, starts, width).to(torch.int8))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_gather_windows_on_shards_out_of_order(layout, tmp_path):
    """Shards whose bases are not in shard order (a permutation of unequal
    bounds, empty shards among them): the gather orders them by base."""
    codes, fm = _genome(10_000, 9)
    n, width = fm.n, 53
    cut = _unequal_text(fm.text_words, n, (0, 40, 41, 41, 300, 560))
    perm = torch.from_numpy(np.random.default_rng(3).permutation(cut.base.shape[0]))
    stacked = sp.ShardedText(cut.words[perm].contiguous(), cut.base[perm], cut.end[perm], n)
    tx = _with_words(stacked, layout, tmp_path)
    starts = _starts(n, width, 9)
    got = sp.gather_windows(tx, starts, width)
    assert torch.equal(got, _owner_sum(stacked, starts, width))
    whole = torch.from_numpy(fm.text_words.view(np.int32))
    assert torch.equal(got, window.gather_windows(whole, n, starts, width).to(torch.int8))


def _seed_inputs():
    rng = np.random.default_rng(32)
    codes, fm = _genome(30_000, 32)
    j, k, L, B = 8, 2, 90, 41
    offsets, positions = build_seed_table(codes, j)
    reads = np.zeros((B, L), np.int32)
    for i in range(B):
        p = int(rng.integers(0, codes.size - L))
        reads[i] = codes[p:p + L]
        for _ in range(int(rng.integers(0, k + 2))):  # some reads past k
            at = int(rng.integers(0, L))
            reads[i, at] = (reads[i, at] + 1 + rng.integers(0, 3)) % 4
    return fm, offsets, positions, j, k, L, reads, np.full(B, L, np.int32)


def _port_seed_step(S, layout, tmp_path, text=None):
    fm, offsets, positions, j, k, L, reads, lengths = _seed_inputs()
    st = sp.put_seed(sp.shard_seed_table(offsets, positions, j, S), "cpu")
    tx = text if text is not None else sp.put_text(sp.shard_text(fm.text_words, fm.n, S), "cpu")
    if layout != "stacked":
        st = sp.ShardedSeedTable(_laid_out(st.offsets, layout, tmp_path / "o"),
                                 _laid_out(st.positions, layout, tmp_path / "p"), st.k_lo,
                                 st.k_hi, st.j)
        tx = _with_words(tx, layout, tmp_path / "w")
    fn = sp.make_sharded_seed_align(pmesh.make_layout(1, S, "cpu"), like_seed=st, max_len=L,
                                    k=k, max_hits=16)
    return [x.numpy() for x in fn(st, tx, torch.from_numpy(reads), torch.from_numpy(lengths))]


def _jax_seed_step(S):
    fm, offsets, positions, j, k, L, reads, lengths = _seed_inputs()
    import jax

    jm = j_mesh.make_mesh(n_data=1, n_interval=S, devices=jax.devices()[:S])
    jst = j_sp.put_seed(j_sp.shard_seed_table(offsets, positions, j, S), jm, j_mesh.INTERVAL_AXIS)
    jtx = j_sp.put_text(j_sp.shard_text(fm.text_words, fm.n, S), jm, j_mesh.INTERVAL_AXIS)
    jfn = j_sp.make_sharded_seed_align(jm, j_mesh.INTERVAL_AXIS, j_mesh.DATA_AXIS, like_seed=jst,
                                       like_text=jtx, max_len=L, k=k, max_hits=16)
    r, ln, _ = j_mesh.shard_reads(jm, reads, lengths)
    return [np.asarray(x)[: reads.shape[0]] for x in jfn(jst, jtx, r, ln)]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_sharded_seed_align_at_32_shards(layout, tmp_path):
    """(best_pos, best_dist, n_good, overflow) at 32 shards equal the JAX
    step on one shard and the port's at S = 1; at 8 shards the JAX step on
    a (1, 8) mesh."""
    for d in ("o", "p", "w"):
        (tmp_path / d).mkdir()
    got = _port_seed_step(32, layout, tmp_path)
    want = _jax_seed_step(1)
    for a, b, c, name in zip(got, want, _port_seed_step(1, "stacked", tmp_path),
                             ("best_pos", "best_dist", "n_good", "overflow")):
        assert np.array_equal(a, b) and np.array_equal(a, c), name
    assert (got[1] <= 2).sum() > 20
    for a, b in zip(_port_seed_step(8, layout, tmp_path), _jax_seed_step(8)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_sharded_seed_align_on_unequal_text_bounds(layout, tmp_path):
    """The seed step with the text cut at unequal word bounds (empty shards
    included) equals the step on the equal cut."""
    for d in ("o", "p", "w"):
        (tmp_path / d).mkdir()
    fm = _seed_inputs()[0]
    cuts = (0, 3, 3, 500, 501, 1000, 1700)  # 8 shards
    text = _unequal_text(fm.text_words, fm.n, cuts)
    got = _port_seed_step(8, layout, tmp_path, text=text)
    for a, b in zip(got, _port_seed_step(8, "stacked", tmp_path)):
        assert np.array_equal(a, b)


def test_verify_peak_allocation_does_not_grow_with_shards():
    """The verify of the same (B, C) candidates over the text in 4 and in
    256 shards: the largest allocation any op makes (``torch.profiler``,
    ``profile_memory``) within 2x (no tensor of S x lanes x W)."""
    codes, fm = _genome(40_000, 4)
    rng = np.random.default_rng(5)
    B, C, L, k = 64, 24, 100, 2
    W = L + 3 * k
    pos = rng.integers(0, fm.n - L, size=(B, C))
    cand = torch.from_numpy(np.sort(np.where(rng.random((B, C)) < 0.2, sf.NO_CAND, pos), axis=1)
                            .astype(np.int32))
    reads = torch.from_numpy(codes[pos[:, 0, None] + np.arange(L)].astype(np.int32))
    lengths = torch.full((B,), L, dtype=torch.int32)
    peak, best = {}, {}
    for S in (4, 256):
        tx = sp.put_text(sp.shard_text(fm.text_words, fm.n, S), "cpu")
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                    profile_memory=True) as prof:
            best[S] = sp._verify_best(tx, reads, lengths, cand, k, W)
        peak[S] = max(e.self_cpu_memory_usage for e in prof.events())
    assert peak[4] >= B * C * W  # the (Q, W) windows are there
    assert peak[256] <= 2 * peak[4], peak
    for a, b in zip(best[4], best[256]):
        assert torch.equal(a, b)
    assert int((best[4].best_dist == 0).sum()) >= B // 2
