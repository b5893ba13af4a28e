"""The port's CLI (index -> simulate -> align) writes SAM byte-identical to
the JAX CLI on the same files, on the seed-table path, the FM pigeonhole
path (with and without a k-mer table), FASTA reads, and paired input
(--paired, --interleaved); the only allowed difference is the @PG header
line naming the program.  The search modes and tier 2 are in
test_torch_cli_modes.py and test_torch_cli_tier2.py."""

import json
import re

import numpy as np
import pytest

from genome_weaver_align_tpu.cli import main as jax_main
from genome_weaver_align_tpu.index import native as j_native
from genome_weaver_align_tpu.ops import affine as j_affine
from genome_weaver_align_tpu.utils.fasta import Contig, Read, write_fasta, write_fastq
from genome_weaver_align_tpu.utils.simulate import simulate_pairs
from genome_weaver_align_tpu_torch.cli import main as port_main
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

J = 10


def main(argv):
    """The port's CLI, its ``align`` on the CPU (the default is the card)."""
    return port_main([*argv, "--device", "cpu"] if argv[0] == "align" else argv)


@pytest.fixture(scope="module", autouse=True)
def _jax_native_off():
    """The JAX CLI runs its numpy scored engine here, never its in-place
    ``make -C native``: test workers running that make at once can load a
    half-written library."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_native, "_lib", None)
        mp.setattr(j_native, "_build_failed", True)
        mp.setattr(j_affine, "_native_fn", None)
        mp.setattr(j_affine, "_native_failed", True)
        yield


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(12)
    codes = rng.integers(0, 4, size=50000, dtype=np.uint8)
    codes[20000:20040] = 4  # an N run, resolved by the index
    write_fasta(d / "g.fa", [Contig("chrA", codes[:30000]), Contig("chrB", codes[30000:])])
    assert main(["index", str(d / "g.fa"), "-o", str(d / "g.npz"), "--sample-rate", "8",
                 "--seed", str(J), "--kmer", "6"]) == 0
    assert main(["simulate", str(d / "g.fa"), "-o", str(d / "r.fq"), "-n", "700", "-l", "100",
                 "--seed", "3", "--sub-rate", "0.02", "--max-subs", "2",
                 "--indel-rate", "0.01", "--max-indels", "1"]) == 0
    # pairs: FR mates, a few mate2s corrupted past k = 2 (rescue), as
    # separate files, interleaved, and single-end reads as FASTA
    sims = simulate_pairs(codes[:30000], 150, 100, seed=8, sub_rate=0.01, max_subs=2)
    r1 = [s.r1.read for s in sims]
    r2 = []
    for i, s in enumerate(sims):
        c = s.r2.read.codes.copy()
        if i % 10 == 0:
            c[[10, 35, 60, 85]] = (c[[10, 35, 60, 85]] + 1) % 4
        r2.append(Read(s.r2.read.name, c, s.r2.read.qual))
    write_fastq(d / "p1.fq", r1)
    write_fastq(d / "p2.fq", r2)
    write_fastq(d / "pi.fq", [r for pair in zip(r1, r2) for r in pair])
    write_fasta(d / "r.fa", [Contig(r.name, r.codes) for r in r1[:60]])
    return d


def _align(fn, d, out, *extra):
    return fn(["align", str(d / "g.npz"), str(d / "r.fq"), "-k", "2", "-o", str(d / out),
               "--seed-table", str(d / f"g.npz.seed{J}.npz"), "--batch-size", "256", *extra])


def _body(path):
    lines = path.read_text().splitlines()
    pg = [l for l in lines if l.startswith("@PG")]
    return [l for l in lines if not l.startswith("@PG")], pg


def test_cli_sam_identical_to_jax(files):
    d = files
    assert _align(main, d, "port.sam", "--report", str(d / "rep.json")) == 0
    assert _align(jax_main, d, "jax.sam") == 0
    port, port_pg = _body(d / "port.sam")
    ref, ref_pg = _body(d / "jax.sam")
    assert port == ref
    assert port_pg == ["@PG\tID:gwa-torch\tPN:gwa-torch"]
    assert ref_pg == ["@PG\tID:gwa-tpu\tPN:gwa-tpu"]
    records = [l for l in port if not l.startswith("@")]
    assert len(records) == 700
    assert any(set(l.split("\t")[5]) & set("ID") for l in records)  # slow path ran
    rep = json.loads((d / "rep.json").read_text())
    assert rep["reads"] == 700 and rep["device"] == "cpu"
    assert rep["mapped"] == sum(1 for l in records if not int(l.split("\t")[1]) & 4)


def test_cli_resume_identical_to_jax(files):
    d = files
    for fn, out in ((main, "port_r.sam"), (jax_main, "jax_r.sam")):
        (d / f"{out}.progress").write_text(json.dumps({"batches_done": 2}))
        assert _align(fn, d, out, "--resume") == 0
        assert json.loads((d / f"{out}.progress").read_text()) == {"batches_done": 3}
    port, _ = _body(d / "port_r.sam")
    ref, _ = _body(d / "jax_r.sam")
    assert port == ref
    assert len([l for l in port if not l.startswith("@")]) == 700 - 2 * 256


def _same_sam(d, reads, *extra, records=None):
    """Run both CLIs on ``reads`` with ``extra`` flags (no seed table unless
    given) and require identical SAM but for @PG."""
    for fn, out in ((main, "port_x.sam"), (jax_main, "jax_x.sam")):
        assert fn(["align", str(d / "g.npz"), str(d / reads), "-k", "2", "-o", str(d / out),
                   "--batch-size", "64", *extra]) == 0
    port, port_pg = _body(d / "port_x.sam")
    ref, _ = _body(d / "jax_x.sam")
    assert port == ref
    assert port_pg == ["@PG\tID:gwa-torch\tPN:gwa-torch"]
    body = [l for l in port if not l.startswith("@")]
    if records is not None:
        assert len(body) == records
    return body


def test_cli_fm_path_identical_to_jax(files):
    body = _same_sam(files, "r.fq", records=700)
    # every read within k = 2 edits maps (a third carry three edits)
    within_k = [l for l in body if sum(int(x) for x in re.findall(r"_[mid](\d+)", l.split("\t")[0])) <= 2]
    assert len(within_k) > 400 and all(not int(l.split("\t")[1]) & 4 for l in within_k)


def test_cli_kmer_table_identical_to_jax(files):
    _same_sam(files, "r.fq", "--kmer-table", str(files / "g.npz.kmer6.npz"), records=700)


def test_cli_fasta_reads_identical_to_jax(files):
    _same_sam(files, "r.fa", records=60)


@pytest.mark.parametrize("seed_table", [False, True])
def test_cli_paired_identical_to_jax(files, seed_table):
    extra = ["--seed-table", str(files / f"g.npz.seed{J}.npz")] if seed_table else []
    body = _same_sam(files, "p1.fq", "--paired", str(files / "p2.fq"), *extra, records=300)
    flags = [int(l.split("\t")[1]) for l in body]
    assert sum(f & 0x2 for f in flags) // 2 >= 130  # proper pairs
    assert all(f & 0x1 for f in flags)


def test_cli_interleaved_identical_to_jax(files):
    body = _same_sam(files, "pi.fq", "--interleaved", records=300)
    paired_body = _same_sam(files, "p1.fq", "--paired", str(files / "p2.fq"))
    assert body == paired_body


@pytest.mark.parametrize("extra", [
    ["--mode", "exact", "--interleaved"], ["--mode", "staircase", "--n-interval", "2"],
    ["--mode", "long", "--n-interval", "2"], ["--mode", "exact", "--n-interval", "2"],
    ["--mode", "onemm", "--interleaved"], ["--mode", "pigeonhole", "--n-interval", "2", "--interleaved"],
])
def test_cli_unported_modes_exit_2(files, capsys, extra):
    assert _align(main, files, "never.sam", *extra) == 2
    assert "not yet ported" in capsys.readouterr().err
    assert not (files / "never.sam").exists()


@pytest.mark.parametrize("extra", [["--paired", "p2.fq"], ["--interleaved"], ["--kmer-table", "k.npz"]])
def test_cli_n_interval_unported_modes_exit_2(files, capsys, extra):
    extra = [str(files / e) if e.endswith(("fq", "npz")) else e for e in extra]
    assert _align(main, files, "never.sam", "--n-interval", "2", *extra) == 2
    assert "not yet ported" in capsys.readouterr().err
    assert not (files / "never.sam").exists()


def test_cli_without_gpu_names_the_missing_device(files, capsys, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert _align(port_main, files, "never.sam") != 0
    assert "no CUDA device" in capsys.readouterr().err
    assert not (files / "never.sam").exists()
