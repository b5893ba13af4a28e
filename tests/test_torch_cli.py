"""The port's CLI (index -> simulate -> align --seed-table) writes SAM
byte-identical to the JAX CLI on the same files; the only allowed
difference is the @PG header line naming the program."""

import json

import numpy as np
import pytest

from genome_weaver_align_tpu.cli import main as jax_main
from genome_weaver_align_tpu.index import native as j_native
from genome_weaver_align_tpu.ops import affine as j_affine
from genome_weaver_align_tpu.utils.fasta import Contig, write_fasta
from genome_weaver_align_tpu_torch.cli import main

J = 10


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
                 "--seed", str(J)]) == 0
    assert main(["simulate", str(d / "g.fa"), "-o", str(d / "r.fq"), "-n", "700", "-l", "100",
                 "--seed", "3", "--sub-rate", "0.02", "--max-subs", "2",
                 "--indel-rate", "0.01", "--max-indels", "1"]) == 0
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


@pytest.mark.parametrize("extra", [
    ["--mode", "exact"], ["--mode", "staircase"], ["--mode", "long"], ["-k", "0"],
    ["--paired", "x.fq"], ["--interleaved"], ["--n-interval", "2"],
    ["--kmer-table", "x.npz"], ["--profile", "prof"],
])
def test_cli_unported_modes_exit_2(files, capsys, extra):
    assert _align(main, files, "never.sam", *extra) == 2
    assert "not yet ported" in capsys.readouterr().err
    assert not (files / "never.sam").exists()


def test_cli_align_without_seed_table_exits_2(files, capsys):
    d = files
    rc = main(["align", str(d / "g.npz"), str(d / "r.fq"), "-k", "2", "-o", str(d / "n.sam")])
    assert rc == 2
    assert "FM pigeonhole" in capsys.readouterr().err
