"""The port's ``align --mode long`` writes SAM byte-identical to the JAX
CLI's but for @PG (ragged long reads on both strands, with indels, a read
shorter than one segment and a read of junk, in several batches; FASTQ and
FASTA), the same ``--report`` keys, and exits 2 without ``--seed-table``."""

import json

import numpy as np
import pytest

from genome_weaver_align_tpu.cli import main as jax_main
from genome_weaver_align_tpu.index import native as j_native
from genome_weaver_align_tpu.ops import affine as j_affine
from genome_weaver_align_tpu.utils.fasta import Contig, Read, write_fasta, write_fastq
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
    """Two contigs indexed by the port's CLI with a 10-mer seed table; 20
    long reads (512-1,024 bases, 4 substitutions and 2 one-base indels
    each, both strands; one of 90 bases, one of junk) as FASTQ and FASTA."""
    d = tmp_path_factory.mktemp("cli_long")
    rng = np.random.default_rng(23)
    codes = rng.integers(0, 4, size=60000, dtype=np.uint8)
    write_fasta(d / "g.fa", [Contig("chrA", codes[:35000]), Contig("chrB", codes[35000:])])
    assert main(["index", str(d / "g.fa"), "-o", str(d / "g.npz"), "--sample-rate", "8",
                 "--seed", "10"]) == 0
    reads = []
    for i in range(20):
        n = int(rng.integers(512, 1025)) if i not in (5, 11) else 90
        p = int(rng.integers(0, codes.size - n - 40))
        if (p < 35000) != (p + n + 20 < 35000):  # keep the read inside one contig
            p = 35000 + 10
        seq = list(codes[p : p + n + 20])
        if n > 200:
            for _ in range(2):
                at = int(rng.integers(60, n - 60))
                if rng.random() < 0.5:
                    seq.insert(at, int(rng.integers(0, 4)))
                else:
                    del seq[at]
        seq = np.array(seq[:n], dtype=np.uint8)
        at = rng.integers(0, n, size=4)
        seq[at] = (seq[at] + rng.integers(1, 4, size=4)) % 4
        if i % 2:
            seq = (3 - seq)[::-1].copy()
        if i == 11:
            seq = rng.integers(0, 4, size=n).astype(np.uint8)
        reads.append(Read(f"long{i}", seq))
    write_fastq(d / "r.fq", reads)
    write_fasta(d / "r.fa", [Contig(r.name, r.codes) for r in reads])
    return d


def _align(fn, d, reads, out, *extra):
    return fn(["align", str(d / "g.npz"), str(d / reads), "--mode", "long", "-o", str(d / out),
               "--batch-size", "8", *extra])


def _body(path):
    lines = path.read_text().splitlines()
    return [l for l in lines if not l.startswith("@PG")], [l for l in lines if l.startswith("@PG")]


@pytest.mark.parametrize("reads", ["r.fq", "r.fa"])
def test_cli_long_identical_to_jax(files, reads):
    seed = ["--seed-table", str(files / "g.npz.seed10.npz")]
    for fn, out in ((main, "port"), (jax_main, "jax")):
        assert _align(fn, files, reads, f"{out}.sam", *seed, "--report",
                      str(files / f"{out}.json")) == 0
    port, port_pg = _body(files / "port.sam")
    assert port == _body(files / "jax.sam")[0]
    assert port_pg == ["@PG\tID:gwa-torch\tPN:gwa-torch"]
    body = [l.split("\t") for l in port if not l.startswith("@")]
    assert len(body) == 20
    mapped = [f for f in body if not int(f[1]) & 4]
    assert len(mapped) >= 17 and all("XT:A:L" in f for f in mapped)
    assert {int(f[1]) & 16 for f in mapped} == {0, 16}
    assert any(("I" in f[5] or "D" in f[5]) for f in mapped)
    rp, rj = (json.loads((files / f"{n}.json").read_text()) for n in ("port", "jax"))
    assert sorted(rp) == sorted(rj) and rp["mode"] == "long" and rp["batch_size"] == 8
    assert (rp["reads"], rp["mapped"], rp["k"]) == (rj["reads"], rj["mapped"], rj["k"])


def test_cli_long_without_seed_table_exits_2(files, capsys):
    assert _align(main, files, "r.fq", "never.sam") == 2
    assert "requires --seed-table" in capsys.readouterr().err
    assert not (files / "never.sam").exists()
