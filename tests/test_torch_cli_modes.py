"""The port's CLI in its search modes writes SAM byte-identical to the JAX
CLI's but for @PG: exact (``-k 0`` under auto, or ``--mode exact``), one
mismatch (``--mode onemm``) and the staircase (``--mode staircase``); and a
k outside 1..14 for the k-edit modes exits 2 naming the range."""

import numpy as np
import pytest

from genome_weaver_align_tpu.cli import main as jax_main
from genome_weaver_align_tpu.index import native as j_native
from genome_weaver_align_tpu.ops import affine as j_affine
from genome_weaver_align_tpu.utils.fasta import Contig, write_fasta
from genome_weaver_align_tpu.utils.simulate import simulate_reads
from genome_weaver_align_tpu_torch.cli import main as port_main
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)


def main(argv):
    """The port's CLI, its ``align`` on the CPU (the default is the card)."""
    return port_main([*argv, "--device", "cpu"] if argv[0] == "align" else argv)


@pytest.fixture(scope="module", autouse=True)
def _jax_native_off():
    """The JAX CLI runs its numpy builders and scored engine here, never its
    in-place ``make -C native``."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_native, "_lib", None)
        mp.setattr(j_native, "_build_failed", True)
        mp.setattr(j_affine, "_native_fn", None)
        mp.setattr(j_affine, "_native_failed", True)
        yield


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Two contigs with an N run, indexed by the port's CLI; 400 FASTQ reads
    with substitutions and indels, 60 FASTA reads with 0-2 substitutions."""
    d = tmp_path_factory.mktemp("cli_modes")
    rng = np.random.default_rng(12)
    codes = rng.integers(0, 4, size=50000, dtype=np.uint8)
    codes[20000:20040] = 4
    write_fasta(d / "g.fa", [Contig("chrA", codes[:30000]), Contig("chrB", codes[30000:])])
    assert main(["index", str(d / "g.fa"), "-o", str(d / "g.npz"), "--sample-rate", "8"]) == 0
    assert main(["simulate", str(d / "g.fa"), "-o", str(d / "r.fq"), "-n", "400", "-l", "100",
                 "--seed", "3", "--sub-rate", "0.01", "--max-subs", "2",
                 "--indel-rate", "0.005", "--max-indels", "1"]) == 0
    sims = simulate_reads(codes[:30000], 60, 100, seed=8, sub_rate=0.01, max_subs=2)
    write_fasta(d / "r.fa", [Contig(s.read.name, s.read.codes) for s in sims])
    return d


def _align(fn, d, reads, out, *extra):
    return fn(["align", str(d / "g.npz"), str(d / reads), "-k", "2", "-o", str(d / out),
               "--batch-size", "64", *extra])


def _body(path):
    lines = path.read_text().splitlines()
    return [l for l in lines if not l.startswith("@PG")], [l for l in lines if l.startswith("@PG")]


@pytest.mark.parametrize("extra", [["-k", "0"], ["--mode", "exact"], ["--mode", "onemm"],
                                   ["--mode", "staircase"]])
def test_cli_search_modes_identical_to_jax(files, extra):
    """Exact on the FASTQ reads, one mismatch and the staircase on the
    FASTA reads: the list path in both CLIs, SAM equal but for @PG."""
    reads, n, least = {"0": ("r.fq", 400, 85), "exact": ("r.fq", 400, 85),
                       "onemm": ("r.fa", 60, 45), "staircase": ("r.fa", 60, 58)}[extra[-1]]
    for fn, out in ((main, "port.sam"), (jax_main, "jax.sam")):
        assert _align(fn, files, reads, out, *extra) == 0
    port, port_pg = _body(files / "port.sam")
    assert port == _body(files / "jax.sam")[0]
    assert port_pg == ["@PG\tID:gwa-torch\tPN:gwa-torch"]
    body = [l for l in port if not l.startswith("@")]
    assert len(body) == n
    assert sum(not int(l.split("\t")[1]) & 4 for l in body) >= least


@pytest.mark.parametrize("extra", [
    ["-k", "15"], ["--mode", "pigeonhole", "-k", "0"], ["--mode", "staircase", "-k", "0"],
    ["--mode", "staircase", "-k", "15"], ["-k", "0", "--n-interval", "2"],
])
def test_cli_k_outside_1_to_14_exits_2(files, capsys, extra):
    """The k-edit modes (and the sharded aligner) take 1 <= k <= 14; the
    JAX CLI would unmap reads at k >= 15 instead."""
    assert _align(main, files, "r.fq", "never.sam", *extra) == 2
    assert "1 <= k <= 14" in capsys.readouterr().err
    assert not (files / "never.sam").exists()
