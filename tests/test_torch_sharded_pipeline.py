"""The port's interval-sharded pipeline (``parallel/sharded_pipeline.py``)
against the JAX package's on the 8-device CPU mesh: the FM and seed align
steps, ``ShardedAligner`` hits and SAM lines (indel reads, and a repeat
genome whose reads overflow into the fallback), and the CLI's
``align --n-interval 2`` SAM byte for byte but the ``@PG`` line."""

import numpy as np
import pytest

from genome_weaver_align_tpu.cli import main as jax_main
from genome_weaver_align_tpu.index import native as j_native
from genome_weaver_align_tpu.index.build import build_fm_index
from genome_weaver_align_tpu.index.files import Genome, GenomeIndex
from genome_weaver_align_tpu.index.seedtable import build_seed_table
from genome_weaver_align_tpu.ops import affine as j_affine
from genome_weaver_align_tpu.parallel import mesh as j_mesh
from genome_weaver_align_tpu.parallel import sharded_pipeline as j_sp
from genome_weaver_align_tpu.parallel import sharded_index as j_si
from genome_weaver_align_tpu.utils.fasta import Contig
from genome_weaver_align_tpu.utils.simulate import simulate_reads
from genome_weaver_align_tpu_torch.cli import main as port_main
from genome_weaver_align_tpu_torch.parallel import mesh as pmesh
from genome_weaver_align_tpu_torch.parallel import sharded_index as si
from genome_weaver_align_tpu_torch.parallel import sharded_pipeline as sp
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)


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


def _mutated_reads(rng, codes, B, L, k):
    reads = np.zeros((B, L), dtype=np.int32)
    for i in range(B):
        p = int(rng.integers(0, codes.size - L))
        r = codes[p : p + L].astype(np.int32).copy()
        for _ in range(int(rng.integers(0, k + 2))):  # some reads past k
            at = int(rng.integers(0, L))
            r[at] = (r[at] + 1 + rng.integers(0, 3)) % 4
        reads[i] = r
    return reads


def _run_jax(fn, tabs, n_data, reads, lengths):
    jm_reads = j_mesh.shard_reads(_JM[n_data], reads, lengths)
    return [np.asarray(x)[: reads.shape[0]] for x in fn(*tabs, *jm_reads[:2])]


_JM = {}


@pytest.mark.parametrize("n_data,n_interval", [(2, 4), (4, 2)])
def test_sharded_pigeonhole_align_matches_jax(n_data, n_interval):
    rng = np.random.default_rng(71)
    codes = rng.integers(0, 4, size=20000, dtype=np.uint8)
    fm = build_fm_index(codes, sample_rate=16)
    k, L, B = 2, 60, 8 * n_data + 3
    reads = _mutated_reads(rng, codes, B, L, k)
    lengths = np.full(B, L, np.int32)

    jm = _JM[n_data] = j_mesh.make_mesh(n_data=n_data, n_interval=n_interval)
    jsh = j_si.put_sharded(j_si.shard_fm_index(fm, n_interval), jm, j_mesh.INTERVAL_AXIS)
    jtx = j_sp.put_text(j_sp.shard_text(fm.text_words, fm.n, n_interval), jm, j_mesh.INTERVAL_AXIS)
    jfn = j_sp.make_sharded_pigeonhole_align(
        jm, j_mesh.INTERVAL_AXIS, j_mesh.DATA_AXIS, like_index=jsh, like_text=jtx,
        max_len=L, k=k, max_hits=8,
    )
    want = _run_jax(jfn, (jsh, jtx), n_data, reads, lengths)

    layout = pmesh.make_layout(n_data, n_interval, "cpu")
    sh = si.put_sharded(si.shard_fm_index(fm, n_interval), "cpu")
    tx = sp.put_text(sp.shard_text(fm.text_words, fm.n, n_interval), "cpu")
    fn = sp.make_sharded_pigeonhole_align(layout, like_index=sh, like_text=tx, max_len=L, k=k,
                                          max_hits=8)
    r, l, _ = pmesh.shard_reads(layout, reads, lengths)
    got = [x.numpy()[:B] for x in fn(sh, tx, r, l)]
    for a, b, name in zip(got, want, ("best_pos", "best_dist", "n_good", "overflow")):
        assert np.array_equal(a, b), name
    assert (got[1] <= k).sum() > B // 2


@pytest.mark.parametrize("n_data,n_interval", [(2, 4), (4, 2)])
def test_sharded_seed_align_matches_jax(n_data, n_interval):
    rng = np.random.default_rng(91)
    codes = rng.integers(0, 4, size=30000, dtype=np.uint8)
    fm = build_fm_index(codes, sample_rate=16)
    j, k, L, B = 8, 2, 90, 8 * n_data + 1
    offsets, positions = build_seed_table(codes, j)
    reads = _mutated_reads(rng, codes, B, L, k)
    lengths = np.full(B, L, np.int32)

    jm = _JM[n_data] = j_mesh.make_mesh(n_data=n_data, n_interval=n_interval)
    jst = j_sp.put_seed(j_sp.shard_seed_table(offsets, positions, j, n_interval), jm,
                        j_mesh.INTERVAL_AXIS)
    jtx = j_sp.put_text(j_sp.shard_text(fm.text_words, fm.n, n_interval), jm, j_mesh.INTERVAL_AXIS)
    jfn = j_sp.make_sharded_seed_align(
        jm, j_mesh.INTERVAL_AXIS, j_mesh.DATA_AXIS, like_seed=jst, like_text=jtx,
        max_len=L, k=k, max_hits=16,
    )
    want = _run_jax(jfn, (jst, jtx), n_data, reads, lengths)

    pst = sp.shard_seed_table(offsets, positions, j, n_interval)
    for f in ("offsets", "positions", "k_lo", "k_hi"):
        assert np.array_equal(getattr(pst, f), np.asarray(getattr(jst, f))), f
    layout = pmesh.make_layout(n_data, n_interval, "cpu")
    st = sp.put_seed(pst, "cpu")
    tx = sp.put_text(sp.shard_text(fm.text_words, fm.n, n_interval), "cpu")
    fn = sp.make_sharded_seed_align(layout, like_seed=st, like_text=tx, max_len=L, k=k,
                                    max_hits=16)
    r, l, _ = pmesh.shard_reads(layout, reads, lengths)
    got = [x.numpy()[:B] for x in fn(st, tx, r, l)]
    for a, b, name in zip(got, want, ("best_pos", "best_dist", "n_good", "overflow")):
        assert np.array_equal(a, b), name


def _repeat_genome(seed):
    """30 copies of a 300 bp unit, each 3% diverged, then random sequence."""
    rng = np.random.default_rng(seed)
    unit = rng.integers(0, 4, size=300, dtype=np.uint8)
    copies = []
    for _ in range(30):
        c = unit.copy()
        mut = rng.random(300) < 0.03
        c[mut] = (c[mut] + rng.integers(1, 4, size=int(mut.sum()))) % 4
        copies.append(c)
    return np.concatenate(copies + [rng.integers(0, 4, size=30000, dtype=np.uint8)])


@pytest.mark.parametrize("n_interval", [2, 4])
@pytest.mark.parametrize("seed_table", [False, True])
def test_sharded_aligner_matches_jax(n_interval, seed_table):
    codes = _repeat_genome(13)
    genome = Genome.from_contigs([Contig("chrS", codes)])
    gi = GenomeIndex(genome, build_fm_index(genome.codes, sample_rate=16), None)
    kw = {}
    if seed_table:
        kw = dict(seed_table=build_seed_table(genome.codes, 8), seed_j=8)
    sims = simulate_reads(genome.codes, 60, 100, seed=5, sub_rate=0.02, max_subs=2,
                          indel_rate=0.01, max_indels=1)
    sims += simulate_reads(genome.codes[:9000], 30, 100, seed=6, max_subs=1)  # the repeat
    reads = [s.read for s in sims]
    jal = j_sp.ShardedAligner(gi, k=2, n_interval=n_interval, **kw)
    pal = sp.ShardedAligner(gi, k=2, n_interval=n_interval, device="cpu", **kw)
    want, got = jal.align_batch(reads), pal.align_batch(reads)
    assert [h and (h.pos, h.strand, h.dist, h.cigar, h.n_good, h.overflow, h.score, h.nm)
            for h in got] == \
           [h and (h.pos, h.strand, h.dist, h.cigar, h.n_good, h.overflow, h.score, h.nm)
            for h in want]
    assert any(h is not None and ("I" in h.cigar or "D" in h.cigar) for h in got)
    assert pal._fb is not None and jal._fb is not None  # the repeat reads overflowed
    assert [r.line() for r in pal.to_sam(reads, got)] == [r.line() for r in jal.to_sam(reads, want)]
    assert pal.sam_header().replace("gwa-torch", "gwa-tpu") == jal.sam_header()


@pytest.fixture(scope="module")
def cli_files(tmp_path_factory):
    from genome_weaver_align_tpu.utils.fasta import write_fasta

    d = tmp_path_factory.mktemp("shcli")
    write_fasta(d / "g.fa", [Contig("chrA", _repeat_genome(3)[:20000]),
                             Contig("chrB", _repeat_genome(4)[5000:30000])])
    assert port_main(["index", str(d / "g.fa"), "-o", str(d / "g.npz"), "--sample-rate", "8",
                      "--seed", "10"]) == 0
    assert port_main(["simulate", str(d / "g.fa"), "-o", str(d / "r.fq"), "-n", "300", "-l",
                      "100", "--seed", "3", "--sub-rate", "0.02", "--max-subs", "2",
                      "--indel-rate", "0.01", "--max-indels", "1"]) == 0
    return d


@pytest.mark.parametrize("seed_table", [False, True])
def test_cli_32_interval_shards_identical_to_jax_single_device(tmp_path, seed_table):
    """``align --n-interval 32`` (the sharded aligner's plain versions on
    the CPU: 32 shards, more than the JAX package's CPU mesh holds) writes
    the JAX CLI's single-device SAM body byte for byte on a random genome."""
    from genome_weaver_align_tpu.utils.fasta import write_fasta

    rng = np.random.default_rng(32)
    write_fasta(tmp_path / "g.fa", [Contig("chrR", rng.integers(0, 4, size=40_000,
                                                                dtype=np.uint8))])
    assert port_main(["index", str(tmp_path / "g.fa"), "-o", str(tmp_path / "g.npz"),
                      "--sample-rate", "8", "--seed", "10"]) == 0
    assert port_main(["simulate", str(tmp_path / "g.fa"), "-o", str(tmp_path / "r.fq"), "-n",
                      "200", "-l", "100", "--seed", "4", "--sub-rate", "0.02", "--max-subs",
                      "2"]) == 0
    extra = ["--seed-table", str(tmp_path / "g.npz.seed10.npz")] if seed_table else []
    base = ["align", str(tmp_path / "g.npz"), str(tmp_path / "r.fq"), "-k", "2",
            "--batch-size", "128", *extra]
    assert port_main([*base, "--n-interval", "32", "-o", str(tmp_path / "port.sam"),
                      "--device", "cpu"]) == 0
    assert jax_main([*base, "-o", str(tmp_path / "jax.sam")]) == 0
    port = [line for line in (tmp_path / "port.sam").read_text().splitlines() if line[0] != "@"]
    ref = [line for line in (tmp_path / "jax.sam").read_text().splitlines() if line[0] != "@"]
    assert port == ref and len(port) == 200
    assert sum(line.split("\t")[1] != "4" for line in port) > 150  # mapped


@pytest.mark.parametrize("seed_table", [False, True])
def test_cli_n_interval_identical_to_jax(cli_files, seed_table):
    d = cli_files
    extra = ["--seed-table", str(d / "g.npz.seed10.npz")] if seed_table else []
    base = ["align", str(d / "g.npz"), str(d / "r.fq"), "-k", "2", "--n-interval", "2",
            "--batch-size", "128", *extra]
    assert port_main([*base, "-o", str(d / "port.sam"), "--device", "cpu"]) == 0
    assert jax_main([*base, "-o", str(d / "jax.sam")]) == 0
    port = (d / "port.sam").read_text().splitlines()
    ref = (d / "jax.sam").read_text().splitlines()
    assert [l for l in port if not l.startswith("@PG")] == [l for l in ref if not l.startswith("@PG")]
    assert "@PG\tID:gwa-torch\tPN:gwa-torch" in port
    assert len([l for l in port if l[0] != "@"]) == 300
