"""The port's CLI on a repeat genome indexed with its reverse text: reads
flooded by the repeat family stay unmapped after the tier-1 fallback and
take the tier-2 staircase, in the port as in the JAX CLI, and the SAM is
byte-identical but for @PG."""

import json

import numpy as np
import pytest

from genome_weaver_align_tpu.cli import main as jax_main
from genome_weaver_align_tpu.index import native as j_native
from genome_weaver_align_tpu.ops import affine as j_affine
from genome_weaver_align_tpu.utils.fasta import Contig, write_fasta
from genome_weaver_align_tpu_torch.cli import main as port_main
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)


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
def repeat_files(tmp_path_factory):
    """150 copies of a 300 bp unit, each 2% diverged, before 5 kbp of random
    sequence, indexed with its reverse text, and 100 simulated reads: at
    one hit a piece, reads flooded by the family stay unmapped after tier 1
    and take the tier-2 staircase."""
    d = tmp_path_factory.mktemp("cli_tier2")
    rng = np.random.default_rng(6)
    unit = rng.integers(0, 4, size=300, dtype=np.uint8)
    parts = []
    for _ in range(150):
        c = unit.copy()
        mut = rng.random(300) < 0.02
        c[mut] = (c[mut] + rng.integers(1, 4, size=int(mut.sum()))) % 4
        parts.append(c)
    parts.append(rng.integers(0, 4, size=5000, dtype=np.uint8))
    write_fasta(d / "g.fa", [Contig("chrR", np.concatenate(parts))])
    assert port_main(["index", str(d / "g.fa"), "-o", str(d / "g.npz"), "--sample-rate", "8"]) == 0
    assert port_main(["simulate", str(d / "g.fa"), "-o", str(d / "r.fq"), "-n", "100", "-l", "100",
                      "--seed", "3", "--sub-rate", "0.02", "--max-subs", "2"]) == 0
    return d


def test_cli_tier2_staircase_identical_to_jax(repeat_files):
    """Auto mode (the array stream): tier 2 fires, the port's report counts
    it, and the SAM equals the JAX CLI's but for @PG."""
    d = repeat_files
    for fn, out, extra in ((port_main, "port.sam", ["--device", "cpu", "--report",
                                                    str(d / "rep.json")]),
                           (jax_main, "jax.sam", [])):
        assert fn(["align", str(d / "g.npz"), str(d / "r.fq"), "-k", "2", "-o", str(d / out),
                   "--max-hits-per-piece", "1", "--batch-size", "100", *extra]) == 0
    lines = {n: (d / n).read_text().splitlines() for n in ("port.sam", "jax.sam")}
    strip = lambda ls: [l for l in ls if not l.startswith("@PG")]  # noqa: E731
    assert strip(lines["port.sam"]) == strip(lines["jax.sam"])
    assert [l for l in lines["port.sam"] if l.startswith("@PG")] == ["@PG\tID:gwa-torch\tPN:gwa-torch"]
    body = [l for l in lines["port.sam"] if not l.startswith("@")]
    assert len(body) == 100
    rep = json.loads((d / "rep.json").read_text())
    assert rep["n_staircase_fallback"] > 0 and rep["mode"] == "pigeonhole"
    assert rep["mapped"] == sum(not int(l.split("\t")[1]) & 4 for l in body) > 80
