"""The PyTorch port imports and runs with JAX absent, and its CUDA kernel
has no silent fallback."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from genome_weaver_align_tpu_torch.ops import dp, dp_cuda

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "genome_weaver_align_tpu_torch"

_NO_JAX_DRIVE = r"""
import sys
sys.modules["jax"] = None  # any "import jax" now raises ImportError
import numpy as np
import genome_weaver_align_tpu_torch
from genome_weaver_align_tpu_torch import cli
from genome_weaver_align_tpu_torch.index import build, files, kmer, native, sais, seedtable
from genome_weaver_align_tpu_torch.models import pipeline, suffix_filter
from genome_weaver_align_tpu_torch.ops import affine, dp, dp_cuda, window
from genome_weaver_align_tpu.utils.fasta import Contig, write_fasta

rng = np.random.default_rng(0)
write_fasta("g.fa", [Contig("c", rng.integers(0, 4, size=8000, dtype=np.uint8))])
assert cli.main(["index", "g.fa", "-o", "g.npz", "--seed", "8"]) == 0
assert cli.main(["simulate", "g.fa", "-o", "r.fq", "-n", "40", "-l", "60"]) == 0
assert cli.main(["align", "g.npz", "r.fq", "-k", "2", "-o", "out.sam",
                 "--seed-table", "g.npz.seed8.npz"]) == 0
assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules if sys.modules[m])
print("NO_JAX_OK")
"""


def test_port_runs_with_jax_absent(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run(
        [sys.executable, "-c", _NO_JAX_DRIVE], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr[-3000:]
    assert "NO_JAX_OK" in res.stdout
    body = [l for l in (tmp_path / "out.sam").read_text().splitlines() if l[0] != "@"]
    assert len(body) == 40


def test_port_source_never_imports_jax():
    offenders = [
        str(p.relative_to(ROOT))
        for p in PKG.rglob("*.py")
        for line in p.read_text().splitlines()
        if line.strip().startswith(("import jax", "from jax"))
    ]
    assert offenders == []


def test_kernel_loader_names_missing_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))  # a toolkit dir without nvcc
    dp_cuda._library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc"):
            dp_cuda._library()
    finally:
        dp_cuda._library.cache_clear()


def test_kernel_wrapper_rejects_cpu_tensors():
    reads = torch.zeros((4, 10), dtype=torch.int8)
    wins = torch.zeros((4, 16), dtype=torch.int8)
    lens = torch.full((4,), 10, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        dp_cuda.banded_edit_distance_cuda(reads, lens, wins, 2)
    assert dp_cuda.banded_edit_distance_cuda.launches == 0


def test_dispatcher_sends_cpu_tensors_to_plain(monkeypatch):
    def kernel_called(*a, **kw):
        raise AssertionError("CPU tensors must not reach the CUDA wrapper")

    monkeypatch.setattr(dp_cuda, "banded_edit_distance_cuda", kernel_called)
    g = torch.Generator().manual_seed(0)
    reads = torch.randint(0, 5, (8, 20), generator=g, dtype=torch.int8)
    wins = torch.randint(0, 5, (8, 26), generator=g, dtype=torch.int8)
    lens = torch.full((8,), 20, dtype=torch.int32)
    got = dp.banded_edit_distance_best(reads, lens, wins, 2)
    want = dp.banded_edit_distance(reads, lens, wins, 2)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
