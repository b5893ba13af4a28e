"""The port's on-disk parts and streaming alignment (``index/multipart_io.py``)
against the JAX package's, at the toy sizes of ``tests/test_multipart_io.py``
(2 parts of 6,000 bases with shared repeat units).

Parts are written by the JAX package's ``save_part`` and by the port's in
turn, and each side's files load in the other, npz and flat alike.
``align_stream_multipart`` equals the JAX function on ``best_dist``,
``best_gpos``, ``best_strand`` and ``mapped``: the npz and the flat paths,
a tail batch shorter than ``batch``, and the staircase rescue of reads in a
repeat family."""

import json

import numpy as np
import pytest
import torch

from genome_weaver_align_tpu.index import multipart_io as j_mp
from genome_weaver_align_tpu.index import native as j_native
from genome_weaver_align_tpu.index import seedtable
from genome_weaver_align_tpu.index.build import build_fm_index
from genome_weaver_align_tpu.ops import affine as j_affine
from genome_weaver_align_tpu_torch.index import multipart_io as mp
from genome_weaver_align_tpu_torch.ops import rank
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

J = 6
L, K = 40, 2


@pytest.fixture(scope="module", autouse=True)
def _jax_native_off():
    """The JAX side runs its numpy builders and scored engine here, never
    its in-place ``make -C native``."""
    with pytest.MonkeyPatch.context() as m:
        m.setattr(j_native, "_lib", None)
        m.setattr(j_native, "_build_failed", True)
        m.setattr(j_affine, "_native_fn", None)
        m.setattr(j_affine, "_native_failed", True)
        yield


def _random_parts(rng, n_per_part=6000, n_parts=2):
    """Random parts, each with 6 copies of its own 60 bp unit."""
    parts = []
    for _ in range(n_parts):
        codes = rng.integers(0, 4, size=n_per_part, dtype=np.uint8)
        unit = rng.integers(0, 4, size=60, dtype=np.uint8)
        for s in rng.integers(0, n_per_part - 60, size=6):
            codes[s : s + 60] = unit
        parts.append(codes)
    return parts


def _repeat_parts(rng, n_copies=50, n_per_part=6000):
    """Part 0 random; part 1 holds ``n_copies`` copies of a 60 bp unit with
    4 private substitutions each: reads from a copy flood the seed
    buckets."""
    part0 = rng.integers(0, 4, size=n_per_part, dtype=np.uint8)
    unit = rng.integers(0, 4, size=60, dtype=np.uint8)
    copies = []
    for _ in range(n_copies):
        c = unit.copy()
        at = rng.choice(60, size=4, replace=False)
        c[at] = (c[at] + rng.integers(1, 4, size=4)) % 4
        copies.append(c)
    part1 = np.concatenate(
        [rng.integers(0, 4, size=1500, dtype=np.uint8)] + copies
        + [rng.integers(0, 4, size=n_per_part - 1500 - n_copies * 60, dtype=np.uint8)])
    return [part0, part1]


def _write(side, part_dir, parts_codes, rev=False):
    """Write the parts (and their reversed-text indexes) with ``side``'s
    ``save_part``; -> the global offsets."""
    offsets = np.concatenate([[0], np.cumsum([c.size for c in parts_codes])]).tolist()
    for p, codes in enumerate(parts_codes):
        fm = build_fm_index(codes, sample_rate=8)
        so, sp = seedtable.build_seed_table(codes, J)
        side.save_part(part_dir, p, fm, so, sp, J,
                       side.PartMeta(names=[f"c{p}"], lengths=[codes.size],
                                     global_offset=offsets[p]))
        if rev:
            rfm = build_fm_index(codes[::-1].copy(), sample_rate=8)
            if side is mp:
                mp.save_rev(part_dir, p, rfm)
            else:  # the layout tests/test_multipart_io.py writes for the JAX side
                marks = rfm.ssa_marks.get(np.arange(rfm.n + 1))
                np.savez(part_dir / f"part{p}_rev.npz", n=rfm.n, primary=rfm.primary,
                         counts=rfm.counts, C=rfm.C, bwt_words=rfm.bwt_words,
                         occ_cp_i32=rfm.occ_cp.astype(np.int32), sample_rate=rfm.sample_rate,
                         mark_bits=np.packbits(marks),
                         ssa_values_i32=rfm.ssa_values.astype(np.int32),
                         text_words=rfm.text_words)
    (part_dir / "parts.json").write_text(json.dumps(dict(
        n_parts=len(parts_codes), names=[f"c{p}" for p in range(len(parts_codes))],
        lengths=[int(c.size) for c in parts_codes], part_offsets=offsets[:-1])))
    return offsets


def _fm_equal(a, b):
    for f in ("n", "primary", "sample_rate"):
        assert getattr(a, f) == getattr(b, f), f
    for f in ("counts", "C", "bwt_words", "occ_cp", "ssa_values", "text_words"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert np.array_equal(a.ssa_marks.get(np.arange(a.n + 1)), b.ssa_marks.get(np.arange(b.n + 1)))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_parts_load_in_the_other_package(tmp_path, writer):
    parts = _random_parts(np.random.default_rng(0))
    side, other = (j_mp, mp) if writer == "jax" else (mp, j_mp)
    _write(side, tmp_path, parts, rev=True)
    z1 = np.load(tmp_path / "part1.npz")
    for p in range(2):
        a, b = side.load_part(tmp_path, p), other.load_part(tmp_path, p)
        _fm_equal(a[0].fwd, b[0].fwd)
        assert a[0].genome.names == b[0].genome.names
        assert np.array_equal(a[0].genome.offsets, b[0].genome.offsets)
        assert a[0].genome.codes.size == b[0].genome.codes.size == 0
        assert np.array_equal(a[1][0], b[1][0]) and np.array_equal(a[1][1], b[1][1])
        assert a[2:] == b[2:] == (J, 6000 * p)
        _fm_equal(side.load_rev(tmp_path, p), other.load_rev(tmp_path, p))
    assert np.array_equal(b[0].fwd.extract(100, 60), parts[1][100:160].astype(np.int64))
    # the port writes exactly the JAX package's npz keys
    ref = tmp_path / "ref"
    _write(j_mp if writer == "port" else mp, ref, parts)
    assert sorted(np.load(ref / "part1.npz").files) == sorted(z1.files)
    assert other.load_rev(ref, 0) is None


def test_flat_layout_round_trips(tmp_path):
    """Both converters write the same flat files from one npz part; each
    package's loader reads the other's; the port's flat tables equal
    ``rank.from_host`` of the npz load, forward and reversed."""
    parts = _random_parts(np.random.default_rng(7), n_per_part=3000)
    for name, side in (("a", j_mp), ("b", mp)):
        _write(j_mp, tmp_path / name, parts, rev=True)
        side.convert_part_to_flat(tmp_path / name, 0)
    da, db = mp.flat_dir(tmp_path / "a", 0), mp.flat_dir(tmp_path / "b", 0)
    assert json.loads((da / "manifest.json").read_text()) == json.loads(
        (db / "manifest.json").read_text())
    for fname, _ in mp._FLAT_FILES.values():
        assert (da / fname).read_bytes() == (db / fname).read_bytes(), fname
    assert mp.has_flat(tmp_path / "a", 1) and not mp.has_flat(tmp_path / "a", 2)

    gi, (so, sp), j, goff = mp.load_part(tmp_path / "a", 0)
    ref = rank.from_host(gi.fwd, "cpu")
    fp = mp.load_part_flat(tmp_path / "a", 0, device="cpu")
    jfp = j_mp.load_part_flat(tmp_path / "b", 0)
    assert fp.n == gi.fwd.n and fp.seed_j == j and fp.global_offset == goff and fp.has_rev
    for f in ("blocks", "C", "mark_blocks", "mark_cp", "ssa_values"):
        assert torch.equal(getattr(fp.fm, f), getattr(ref, f)), f
        assert np.array_equal(getattr(fp.fm, f).numpy(),
                              np.asarray(getattr(jfp.fm, f)).view(np.int32)
                              if np.asarray(getattr(jfp.fm, f)).dtype == np.uint32
                              else np.asarray(getattr(jfp.fm, f))), f
    assert (fp.fm.primary, fp.fm.sample_rate) == (ref.primary, ref.sample_rate)
    assert np.array_equal(fp.text_words.numpy(), gi.fwd.text_words.view(np.int32))
    assert np.array_equal(fp.text_host, gi.fwd.text_words)
    assert np.array_equal(fp.seed_tab[0].numpy(), so) and np.array_equal(fp.seed_tab[1].numpy(), sp)

    ref_rev = rank.from_host(mp.load_rev(tmp_path / "a", 0), "cpu")
    dev_rev = mp.load_rev_flat(tmp_path / "a", 0, device="cpu")
    for f in ("blocks", "mark_blocks", "mark_cp", "ssa_values"):
        assert torch.equal(getattr(dev_rev, f), getattr(ref_rev, f)), f
    # without the FM and the seed table: dummy tables, real metadata
    fp2 = mp.load_part_flat(tmp_path / "a", 0, want_fm=False, want_seed=False, device="cpu")
    assert fp2.fm.n == gi.fwd.n and fp2.seed_tab is None and tuple(fp2.fm.blocks.shape) == (1, 12)


def _reads_within_parts(rng, parts_codes, offsets, n_reads):
    whole = np.concatenate(parts_codes)
    starts = rng.integers(0, whole.size - L, size=n_reads)
    size0 = parts_codes[0].size
    starts = np.where((starts % size0) > size0 - L, starts - L, starts)  # inside one part
    reads = whole[starts[:, None] + np.arange(L)[None, :]].astype(np.int8)
    at = rng.integers(0, L, size=n_reads)
    reads[np.arange(n_reads), at] = (reads[np.arange(n_reads), at] + 1) % 4
    rc = rng.random(n_reads) < 0.5
    reads[rc] = (3 - reads[rc])[:, ::-1]
    return reads


def _stream_both(part_dir, reads, batch):
    lengths_row = np.full(batch, L, np.int32)
    want = j_mp.align_stream_multipart(j_mp.load_multi_index(part_dir), reads, lengths_row,
                                       batch, k=K)
    stats = {}
    got = mp.align_stream_multipart(mp.load_multi_index(part_dir), reads, lengths_row, batch,
                                    k=K, stats=stats, device="cpu")
    for name, g, w in zip(("best_dist", "best_gpos", "best_strand", "mapped"), got, want):
        assert np.array_equal(g, w), name
    assert got[4] > 0 and got[5] > 0  # align_s, load_s
    return got, stats


@pytest.mark.parametrize("n_reads", [64, 53])  # 53: a tail batch of 21 reads
def test_stream_matches_jax(tmp_path, n_reads):
    rng = np.random.default_rng(1)
    parts = _random_parts(rng)
    offsets = _write(j_mp, tmp_path, parts)
    reads = _reads_within_parts(rng, parts, offsets, n_reads)
    got, stats = _stream_both(tmp_path, reads, 32)
    assert stats["format"] == "npz" and got[3].all() and got[0].size == n_reads
    assert stats["peak_mem_bytes"] == [None, None]  # measured on a CUDA device only
    for p in range(2):
        mp.convert_part_to_flat(tmp_path, p)
    got_flat, stats = _stream_both(tmp_path, reads, 32)
    assert stats["format"] == "flat"
    for a, b in zip(got_flat[:4], got[:4]):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("tight", [False, True])
def test_staircase_rescue_matches_jax(tmp_path, monkeypatch, tight):
    """Reads from inside a repeat family of 50 copies (the JAX test's case).
    With the parts' own budgets the stream and its tier 1 place them;
    with budgets cut to 1 hit a piece in both packages (tier 1 no bigger)
    some stay unmapped through the stream, and the deferred staircase
    rescue (every part has its reversed-text index) places them.  npz and
    flat alike, equal to the JAX function."""
    from genome_weaver_align_tpu.models import pipeline as j_pipeline
    from genome_weaver_align_tpu_torch.models import pipeline

    if tight:
        monkeypatch.setattr(j_mp, "_part_budgets", lambda n, j: (1, 3, 1))
        monkeypatch.setattr(mp, "_part_budgets", lambda n, j, k: (1, 3, 1))
        monkeypatch.setattr(j_pipeline.SuffixFilterAligner, "FB_MULT", 1)
        monkeypatch.setattr(pipeline.SuffixFilterAligner, "FB_MULT", 1)
    rng = np.random.default_rng(3)
    parts = _repeat_parts(rng)
    offsets = _write(mp, tmp_path, parts, rev=True)
    n_rep, B = 8, 32
    reads = np.zeros((B, L), dtype=np.int8)
    true_g = np.zeros(B, dtype=np.int64)
    for t in range(n_rep):
        s = 1500 + 60 * (4 + t) + 10
        row = parts[1][s : s + L].copy()
        row[7] = (row[7] + 1) % 4
        reads[t], true_g[t] = row, offsets[1] + s
    for t in range(n_rep, B):
        s = int(rng.integers(0, 6000 - L))
        reads[t], true_g[t] = parts[0][s : s + L], s
    got, stats = _stream_both(tmp_path, reads, B)
    assert got[3].all() and np.array_equal(got[1], true_g)
    assert (got[0][:n_rep] == 1).all()
    assert (stats["rescued"] > 0) == (stats["un_before_rescue"] > 0) == tight
    for p in range(2):
        mp.convert_part_to_flat(tmp_path, p)
    got_flat, stats = _stream_both(tmp_path, reads, B)
    assert stats["format"] == "flat" and (stats["rescued"] > 0) == tight
    for a, b in zip(got_flat[:4], got[:4]):
        assert np.array_equal(a, b)


def test_flat_stream_refuses_reads_too_short_for_the_seed_table(tmp_path):
    """The JAX flat path would search a dummy FM index and unmap such
    reads; the port raises."""
    parts = _random_parts(np.random.default_rng(4), n_per_part=3000)
    _write(mp, tmp_path, parts)
    for p in range(2):
        mp.convert_part_to_flat(tmp_path, p)
    short = np.zeros((8, 3 * J - 1), np.int8)  # 17 // 3 = 5 < j = 6
    with pytest.raises(ValueError, match="shorter than the seed table"):
        mp.align_stream_multipart(mp.load_multi_index(tmp_path), short,
                                  np.full(8, short.shape[1], np.int32), 8, device="cpu")


@pytest.mark.parametrize("k", [1, 2, 4])
def test_part_budgets_count_k_plus_1_pieces(k):
    """At k = 2 the budgets equal the JAX package's (which assumes 3
    pieces); at other k they count k + 1."""
    for n, j in ((6000, 6), (1_600_000_000, 13), (230_000_000, 13)):
        got = mp._part_budgets(n, j, k)
        if k == 2:
            assert got == j_mp._part_budgets(n, j)
        mean = n / 4**j
        max_hits = max(8, min(64, int(1.5 * mean)))
        assert got == (max_hits, max(12, min(128, (k + 1) * max_hits)),
                       max(4, min(got[1], int(0.9 * (k + 1) * mean))))
