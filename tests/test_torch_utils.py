"""The port's own host utilities (``genome_weaver_align_tpu_torch/utils``)
against the JAX package's originals: the same seed simulates the same reads,
FASTA/FASTQ round-trip to the same records, SAM strings, configs, packed
words and bit-vector ranks are equal.  ``log`` differs on purpose (it
profiles with ``torch.profiler``); its stopwatch is held to the original."""

import io
import re
from types import SimpleNamespace

import numpy as np
import pytest

from genome_weaver_align_tpu.utils import bitvector as j_bitvector
from genome_weaver_align_tpu.utils import config as j_config
from genome_weaver_align_tpu.utils import dna as j_dna
from genome_weaver_align_tpu.utils import fasta as j_fasta
from genome_weaver_align_tpu.utils import larray as j_larray
from genome_weaver_align_tpu.utils import packing as j_packing
from genome_weaver_align_tpu.utils import sam as j_sam
from genome_weaver_align_tpu.utils import simulate as j_simulate
from genome_weaver_align_tpu_torch.utils import (
    bitvector, config, dna, fasta, larray, log, packing, sam, simulate,
)


def _same_reads(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.name == y.name and np.array_equal(x.codes, y.codes)
        assert (x.qual is None) == (y.qual is None)
        assert x.qual is None or np.array_equal(x.qual, y.qual)


def _same_sims(a, b):
    _same_reads([s.read for s in a], [s.read for s in b])
    assert [(s.true_pos, s.true_strand, s.n_sub, s.n_ins, s.n_del) for s in a] == \
        [(s.true_pos, s.true_strand, s.n_sub, s.n_ins, s.n_del) for s in b]


@pytest.mark.parametrize("seed", [0, 7])
def test_random_and_repeat_genomes_equal(seed):
    assert np.array_equal(simulate.random_genome(5000, seed=seed, gc=0.4),
                          j_simulate.random_genome(5000, seed=seed, gc=0.4))
    assert np.array_equal(simulate.repeat_genome(20000, seed=seed),
                          j_simulate.repeat_genome(20000, seed=seed))


@pytest.mark.parametrize("kw", [
    dict(sub_rate=0.02, max_subs=2),
    dict(sub_rate=0.01, max_subs=3, indel_rate=0.01, max_indels=1),
])
def test_simulate_reads_equal(kw):
    g = j_simulate.random_genome(20000, seed=1)
    _same_sims(simulate.simulate_reads(g, 50, 100, seed=3, **kw),
               j_simulate.simulate_reads(g, 50, 100, seed=3, **kw))


@pytest.mark.parametrize("indel_frac", [0.0, 0.3])
def test_simulate_reads_array_equal(indel_frac):
    g = j_simulate.random_genome(20000, seed=2)
    got = simulate.simulate_reads_array(g, 300, 100, seed=5, max_subs=2, indel_frac=indel_frac)
    want = j_simulate.simulate_reads_array(g, 300, 100, seed=5, max_subs=2,
                                           indel_frac=indel_frac)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)


def test_simulate_pairs_and_batch_equal():
    g = j_simulate.random_genome(20000, seed=3)
    got = simulate.simulate_pairs(g, 40, 100, seed=4, sub_rate=0.01, max_subs=2)
    want = j_simulate.simulate_pairs(g, 40, 100, seed=4, sub_rate=0.01, max_subs=2)
    _same_sims([p.r1 for p in got], [p.r1 for p in want])
    _same_sims([p.r2 for p in got], [p.r2 for p in want])
    assert [(p.fragment_start, p.fragment_len) for p in got] == \
        [(p.fragment_start, p.fragment_len) for p in want]
    reads = [p.r1.read for p in want]
    assert np.array_equal(simulate.reads_to_batch(reads, pad_to=120),
                          j_simulate.reads_to_batch(reads, pad_to=120))


@pytest.mark.parametrize("ragged", [False, True])
def test_fastq_round_trip_equal(tmp_path, ragged):
    rng = np.random.default_rng(9)
    reads = []
    for i in range(37):
        n = int(rng.integers(20, 81)) if ragged else 80
        codes = rng.integers(0, 5, size=n).astype(np.uint8)  # N included
        reads.append(fasta.Read(f"r{i} extra", codes, rng.integers(2, 41, size=n).astype(np.int32)))
    fasta.write_fastq(tmp_path / "p.fq", reads)
    j_fasta.write_fastq(tmp_path / "j.fq", reads)
    assert (tmp_path / "p.fq").read_bytes() == (tmp_path / "j.fq").read_bytes()
    _same_reads(list(fasta.iter_reads(tmp_path / "p.fq")),
                list(j_fasta.iter_reads(tmp_path / "p.fq")))
    for a, b in zip(fasta.iter_fastq_array_batches(tmp_path / "p.fq", 10),
                    j_fasta.iter_fastq_array_batches(tmp_path / "p.fq", 10)):
        assert a[0] == b[0] and all(np.array_equal(x, y) for x, y in zip(a[1:], b[1:]))
    got = fasta.read_fastq_arrays(tmp_path / "p.fq", batch_size=16)
    want = j_fasta.read_fastq_arrays(tmp_path / "p.fq", batch_size=16)
    assert got[0] == want[0] and all(np.array_equal(x, y) for x, y in zip(got[1:], want[1:]))


def test_fasta_round_trip_equal(tmp_path):
    rng = np.random.default_rng(10)
    contigs = [fasta.Contig(f"c{i}", rng.integers(0, 5, size=int(n)).astype(np.uint8))
               for i, n in enumerate((1, 70, 71, 500))]
    fasta.write_fasta(tmp_path / "p.fa", contigs, width=60)
    j_fasta.write_fasta(tmp_path / "j.fa", contigs, width=60)
    assert (tmp_path / "p.fa").read_bytes() == (tmp_path / "j.fa").read_bytes()
    got, want = fasta.read_fasta(tmp_path / "p.fa"), j_fasta.read_fasta(tmp_path / "p.fa")
    assert [(c.name, c.codes.tolist()) for c in got] == [(c.name, c.codes.tolist()) for c in want]
    _same_reads(list(fasta.iter_reads(tmp_path / "p.fa")),
                list(j_fasta.iter_reads(tmp_path / "p.fa")))


def test_truncated_fastq_raises_the_same(tmp_path):
    (tmp_path / "t.fq").write_text("@a\nACGT\n+\nIII\n")
    errors = []
    for mod in (fasta, j_fasta):
        with pytest.raises(ValueError) as e:
            list(mod.iter_fastq_array_batches(tmp_path / "t.fq", 4))
        errors.append(str(e.value))
    assert errors[0] == errors[1]


@pytest.mark.parametrize("strand", [0, 1])
@pytest.mark.parametrize("with_qual", [False, True])
def test_sam_records_equal(strand, with_qual):
    rng = np.random.default_rng(strand + 2 * with_qual)
    codes = rng.integers(0, 5, size=60).astype(np.uint8)
    qual = rng.integers(2, 41, size=60).astype(np.int32) if with_qual else None
    for kw in (dict(), dict(n_hits=3), dict(n_hits=10_000, score=41), dict(overflow=True)):
        args = ("r1", codes, "chr1", 1234, strand, "30M2I28M", 3)
        assert sam.mapped(*args, qual=qual, **kw).line() == \
            j_sam.mapped(*args, qual=qual, **kw).line()
    for ov in (False, True):
        assert sam.unmapped("r2", codes, qual, overflow=ov).line() == \
            j_sam.unmapped("r2", codes, qual, overflow=ov).line()
    for cig, nm in (("60M", 2), ("10M3D50M", 4), ("5S55M", 0)):
        assert sam.alignment_score(cig, nm) == j_sam.alignment_score(cig, nm)
    assert sam.header(["a", "b"], [10, 20]) == j_sam.header(["a", "b"], [10, 20])
    assert sam.header(["a"], [10], prog="gwa-torch") == j_sam.header(["a"], [10], prog="gwa-torch")


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("scored", [False, True])
def test_sam_lines_from_arrays_equal(ragged, scored):
    rng = np.random.default_rng(3 * ragged + scored)
    B, L = 64, 50
    codes = rng.integers(0, 5, size=(B, L)).astype(np.uint8)
    lengths = rng.integers(20, L + 1, size=B).astype(np.int32) if ragged else np.full(B, L, np.int32)
    ah = SimpleNamespace(
        mapped=rng.random(B) < 0.8, strand=rng.integers(0, 2, size=B),
        dist=rng.integers(0, 3, size=B), n_good=rng.integers(0, 300, size=B),
        overflow=rng.random(B) < 0.1, pos=rng.integers(0, 3000, size=B),
        aux={3: (40, 2), 9: (35, 3)}, cigars={3: "20M1I29M", 9: "10M2D40M", 11: "50M"},
    )
    names = [f"q{i}" for i in range(B)]
    offsets = np.array([0, 1000, 3100])
    quals = rng.integers(2, 41, size=(B, L)).astype(np.int32)
    for q in (None, quals):
        args = (names, codes, lengths, ah, ["chrA", "chrB"], offsets)
        assert sam.lines_from_arrays(*args, quals=q, scored=scored) == \
            j_sam.lines_from_arrays(*args, quals=q, scored=scored)


def test_write_sam_equal(tmp_path):
    codes = np.arange(40, dtype=np.uint8) % 4
    recs = [j_sam.mapped("a", codes, "c", 5, 1, "40M", 1), j_sam.unmapped("b", codes)]
    sam.write_sam(tmp_path / "p.sam", "@HD", recs)
    j_sam.write_sam(tmp_path / "j.sam", "@HD", recs)
    assert (tmp_path / "p.sam").read_bytes() == (tmp_path / "j.sam").read_bytes()


@pytest.mark.parametrize("cls", ["IndexConfig", "AlignConfig"])
def test_configs_from_args_agree(cls):
    ns = SimpleNamespace(genome="g.fa", out="o", sample_rate=16, seed=12, index="g.npz",
                         reads="r.fq", k=3, batch_size=128, n_interval=4, unrelated=1)
    got, want = getattr(config, cls), getattr(j_config, cls)
    assert vars(got.from_args(ns)) == vars(want.from_args(ns))
    assert vars(got()) == vars(want())


def test_packing_equal():
    rng = np.random.default_rng(4)
    codes = rng.integers(0, 4, size=1003).astype(np.uint8)
    words = packing.pack(codes)
    assert np.array_equal(words, j_packing.pack(codes))
    assert np.array_equal(packing.unpack(words, codes.size), j_packing.unpack(words, codes.size))
    idx = rng.integers(0, codes.size, size=50)
    assert np.array_equal(packing.get(words, idx), j_packing.get(words, idx))
    for c in range(4):
        assert np.array_equal(packing.match_mask_word(words, c), j_packing.match_mask_word(words, c))
        for k in (0, 5, 16, 17, 1000):
            assert packing.count_prefix(words, c, k) == j_packing.count_prefix(words, c, k)
    assert np.array_equal(packing.popcount32(words), j_packing.popcount32(words))


def test_bitvector_equal():
    bits = np.random.default_rng(5).random(1000) < 0.3
    got, want = bitvector.BitVector(bits), j_bitvector.BitVector(bits)
    for f in ("words", "checkpoints", "_wpad"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    i = np.arange(1001)
    assert np.array_equal(got.rank1(i), want.rank1(i))
    assert np.array_equal(got.rank0(i), want.rank0(i))
    assert np.array_equal(got.get(i[:-1]), want.get(i[:-1]))


def test_dna_and_larray_equal():
    seq = "ACGTNacgtnRYX"
    codes = dna.encode(seq)
    assert np.array_equal(codes, j_dna.encode(seq))
    assert dna.decode(codes) == j_dna.decode(codes)
    assert np.array_equal(dna.revcomp(codes), j_dna.revcomp(codes))
    assert np.array_equal(dna.complement(codes), j_dna.complement(codes))
    for a, b in zip(dna.resolve_ambiguous(codes, seed=2), j_dna.resolve_ambiguous(codes, seed=2)):
        assert np.array_equal(a, b)
    assert larray.PART_LIMIT == j_larray.PART_LIMIT
    larray.check_device_indexable(1000)
    for mod in (larray, j_larray):
        with pytest.raises(ValueError):
            mod.check_device_indexable(1 << 31, "bwt")


def test_log_stopwatch_and_torch_trace(tmp_path):
    from genome_weaver_align_tpu.utils import log as j_log

    lines = []
    for mod in (log, j_log):
        out = io.StringIO()
        mod.StopWatch(stream=out).lap("loaded")
        lines.append(re.sub(r"[0-9.]+s", "Ts", out.getvalue()))
    assert lines[0] == lines[1] and "loaded" in lines[0]
    with log.profile_to(str(tmp_path / "trace")):
        with log.trace_annotation("span"):
            np.zeros(10).sum()
    assert "span" in (tmp_path / "trace" / "trace.json").read_text()
