"""The port's ``dump`` prints what the JAX CLI's prints, line for line, and
``align --profile DIR`` writes a ``torch.profiler`` trace beside the same
SAM as a run without it (the array path and the list path)."""

import json

import numpy as np
import pytest

from genome_weaver_align_tpu.cli import main as jax_main
from genome_weaver_align_tpu.index import native as j_native
from genome_weaver_align_tpu.ops import affine as j_affine
from genome_weaver_align_tpu.utils.fasta import Contig, write_fasta
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
    d = tmp_path_factory.mktemp("cli_dump")
    rng = np.random.default_rng(31)
    codes = rng.integers(0, 4, size=20000, dtype=np.uint8)
    codes[5000:5030] = 4
    write_fasta(d / "g.fa", [Contig("chrA", codes[:12000]), Contig("chrB", codes[12000:])])
    assert main(["index", str(d / "g.fa"), "-o", str(d / "g.npz"), "--sample-rate", "8"]) == 0
    assert main(["simulate", str(d / "g.fa"), "-o", str(d / "r.fq"), "-n", "120", "-l", "80",
                 "--seed", "4", "--sub-rate", "0.01", "--max-subs", "2"]) == 0
    return d


def test_dump_matches_jax(files, capsys):
    assert main(["dump", str(files / "g.npz")]) == 0
    port = capsys.readouterr().out.splitlines()
    assert jax_main(["dump", str(files / "g.npz")]) == 0
    assert port == capsys.readouterr().out.splitlines()
    assert port[0].startswith("n=20000 ") and len(port) == 4


@pytest.mark.parametrize("extra", [[], ["--mode", "staircase"]])  # array path, list path
def test_profile_writes_a_trace_and_the_same_sam(files, extra):
    prof = files / f"prof{len(extra)}"
    args = ["align", str(files / "g.npz"), str(files / "r.fq"), "-k", "2", "--batch-size", "64",
            *extra]
    assert main([*args, "-o", str(files / "plain.sam")]) == 0
    assert main([*args, "-o", str(files / "prof.sam"), "--profile", str(prof)]) == 0
    assert (files / "prof.sam").read_text() == (files / "plain.sam").read_text()
    trace = json.loads((prof / "trace.json").read_text())
    assert trace["traceEvents"]
