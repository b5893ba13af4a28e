"""The PyTorch port imports and runs with JAX and the JAX package absent
(every align mode it has), its source imports neither, and its CUDA
kernels have no silent fallback."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from genome_weaver_align_tpu_torch.ops import (
    dp, dp_cuda, fm_search_cuda, myers_cuda, one_mismatch_cuda, staircase_cuda,
)

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "genome_weaver_align_tpu_torch"

_NO_JAX_DRIVE = r"""
import sys
sys.modules["jax"] = None  # any "import jax" now raises ImportError
sys.modules["genome_weaver_align_tpu"] = None  # and so does the JAX package
import numpy as np
import genome_weaver_align_tpu_torch
from genome_weaver_align_tpu_torch import cli
from genome_weaver_align_tpu_torch.index import build, files, kmer, native, sais, seedtable
from genome_weaver_align_tpu_torch.index import device_build, multi, multipart_io, wavelet
from genome_weaver_align_tpu_torch.models import long_read, paired, pipeline, suffix_filter
from genome_weaver_align_tpu_torch.models import bidirectional, exact, one_mismatch, staircase
from genome_weaver_align_tpu_torch.ops import (
    affine, dp, dp_cuda, fm_search_cuda, myers, myers_cuda, one_mismatch_cuda, rank, ring_cuda,
    staircase_cuda, window,
)
from genome_weaver_align_tpu_torch.parallel import (
    mesh, multihost, peer, ring, sharded_index, sharded_pipeline,
)
from genome_weaver_align_tpu_torch.utils.fasta import Contig, write_fasta

rng = np.random.default_rng(0)
write_fasta("g.fa", [Contig("c", rng.integers(0, 4, size=8000, dtype=np.uint8))])
assert cli.main(["index", "g.fa", "-o", "g.npz", "--seed", "8"]) == 0
assert cli.main(["index", "g.fa", "-o", "gd.npz", "--builder", "device", "--device", "cpu"]) == 0
with np.load("g.npz") as a, np.load("gd.npz") as b:
    assert all(np.array_equal(a[key], b[key]) for key in a.files)
multihost.initialize_distributed(num_processes=1)
import torch
w = wavelet.to_device(wavelet.WaveletRank(np.zeros(5, np.uint8)), device="cpu")
assert int(wavelet.device_rank(w, torch.zeros(1), torch.tensor([5]))[0]) == 5
assert cli.main(["simulate", "g.fa", "-o", "r.fq", "-n", "40", "-l", "60"]) == 0
align = ["align", "g.npz", "r.fq", "-k", "2", "--device", "cpu", "-o"]
assert cli.main([*align, "out.sam", "--seed-table", "g.npz.seed8.npz"]) == 0
assert cli.main([*align, "fm.sam"]) == 0
assert cli.main([*align, "pairs.sam", "--interleaved"]) == 0
assert cli.main([*align, "sharded.sam", "--n-interval", "2"]) == 0
assert cli.main([*align, "stair.sam", "--mode", "staircase"]) == 0
assert cli.main([*align, "onemm.sam", "--mode", "onemm"]) == 0
assert cli.main([*align, "long.sam", "--mode", "long", "--seed-table", "g.npz.seed8.npz"]) == 0
assert cli.main(["dump", "g.npz"]) == 0
align[4] = "0"  # -k 0: the exact aligner
assert cli.main([*align, "exact.sam"]) == 0
contigs = [Contig(f"c{i}", rng.integers(0, 4, size=3000, dtype=np.uint8)) for i in range(2)]
mi = multipart_io.build_multipart("parts", contigs, part_limit=4000, seed_j=6, sample_rate=8)
reads = np.stack([contigs[i % 2].codes[50 * i : 50 * i + 60] for i in range(16)]).astype(np.int8)
res = multipart_io.align_stream_multipart(mi, reads, np.full(8, 60, np.int32), 8, device="cpu")
assert res[3].all()
assert not any(m == "jax" or m.startswith(("jax.", "genome_weaver_align_tpu."))
               for m in sys.modules if sys.modules[m])
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
    for name in ("out.sam", "fm.sam", "pairs.sam", "sharded.sam", "stair.sam", "onemm.sam",
                 "exact.sam", "long.sam"):
        body = [l for l in (tmp_path / name).read_text().splitlines() if l[0] != "@"]
        assert len(body) == 40, name
    sam = [(tmp_path / n).read_text().splitlines() for n in ("fm.sam", "sharded.sam")]
    assert [l for l in sam[0] if l[0] != "@"] == [l for l in sam[1] if l[0] != "@"]


def test_port_source_never_imports_jax():
    offenders = [
        str(p.relative_to(ROOT))
        for p in [*PKG.rglob("*.py"), ROOT / "chip_smoke.py"]
        for line in p.read_text().splitlines()
        if line.strip().startswith(("import jax", "from jax"))
    ]
    assert offenders == []


_JAX_PACKAGE_IMPORT = re.compile(r"^\s*(import|from)\s+genome_weaver_align_tpu(?!_torch)\b")


def test_port_source_never_imports_the_jax_package():
    """No module of the port, and not ``chip_smoke.py``, imports the JAX
    package, not even its host-only modules: the port carries its own
    copies (``genome_weaver_align_tpu_torch/utils``)."""
    offenders = [
        f"{p.relative_to(ROOT)}:{i}"
        for p in [*PKG.rglob("*.py"), ROOT / "chip_smoke.py"]
        for i, line in enumerate(p.read_text().splitlines(), 1)
        if _JAX_PACKAGE_IMPORT.match(line)
    ]
    assert offenders == []


@pytest.mark.parametrize("binding", [dp_cuda, myers_cuda, fm_search_cuda, staircase_cuda,
                                     one_mismatch_cuda])
def test_kernel_loader_names_missing_nvcc(monkeypatch, tmp_path, binding):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))  # a toolkit dir without nvcc
    binding._library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc"):
            binding._library()
    finally:
        binding._library.cache_clear()


def test_kernel_wrapper_rejects_cpu_tensors():
    reads = torch.zeros((4, 10), dtype=torch.int8)
    wins = torch.zeros((4, 16), dtype=torch.int8)
    lens = torch.full((4,), 10, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        dp_cuda.banded_edit_distance_cuda(reads, lens, wins, 2)
    assert dp_cuda.banded_edit_distance_cuda.launches == 0
    words, starts, rid = (torch.zeros(4, dtype=torch.int32) for _ in range(3))
    with pytest.raises(ValueError, match="CUDA"):
        dp_cuda.banded_edit_distance_text_cuda(words, 64, starts, reads, lens, rid, 2, 16)
    assert dp_cuda.banded_edit_distance_text_cuda.launches == 0


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


def test_text_entry_sends_cpu_tensors_to_plain(monkeypatch):
    def kernel_called(*a, **kw):
        raise AssertionError("CPU tensors must not reach the CUDA wrapper")

    monkeypatch.setattr(dp_cuda, "banded_edit_distance_text_cuda", kernel_called)
    g = torch.Generator().manual_seed(1)
    words = torch.randint(-(1 << 31), 1 << 31, (8,), generator=g, dtype=torch.int64).to(torch.int32)
    reads = torch.randint(0, 5, (3, 20), generator=g, dtype=torch.int8)
    lens = torch.tensor([20, 7, 0], dtype=torch.int32)
    rid = torch.tensor([0, 0, 1, 2, 2], dtype=torch.int32)
    starts = torch.tensor([-5, 3, 60, 100, 127], dtype=torch.int32)
    got = dp.banded_edit_distance_text(words, 128, starts, reads, lens, rid, 2, 26)
    want = dp.banded_edit_distance_text_plain(words, 128, starts, reads, lens, rid, 2, 26)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert got[0].shape == (5,)
