"""Tests that need an NVIDIA GPU with nvcc (marker ``cuda``; they skip
without one).  On the card:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

They import no JAX: they hold the CUDA kernel against the plain torch
version, and the aligner on the card against the same aligner on the CPU,
which the CPU tests hold against the JAX package."""

import numpy as np
import pytest
import torch

from genome_weaver_align_tpu.utils.simulate import simulate_reads_array
from genome_weaver_align_tpu_torch.index.build import build_fm_index
from genome_weaver_align_tpu_torch.index.files import Genome, GenomeIndex
from genome_weaver_align_tpu_torch.index.seedtable import build_seed_table
from genome_weaver_align_tpu_torch.models import pipeline
from genome_weaver_align_tpu_torch.ops import dp, dp_cuda
from genome_weaver_align_tpu.utils.fasta import Contig

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("k", range(1, dp_cuda.MAX_K + 1))
@pytest.mark.parametrize("narrow", [False, True])
def test_kernel_equals_plain(cuda, k, narrow):
    rng = np.random.default_rng(k)
    Q, L = 3001, 77
    W = L // 2 if narrow else L + 3 * k  # narrow: dead lanes saturate to INF
    reads = rng.integers(0, 5, size=(Q, L), dtype=np.int8)
    wins = rng.integers(0, 5, size=(Q, W), dtype=np.int8)
    wins[::2, k : k + min(L, W - 2 * k)] = reads[::2, : min(L, W - 2 * k)]
    lengths = rng.integers(0, L + 1, size=Q).astype(np.int32)
    r, ln, w = (torch.from_numpy(a).to(cuda) for a in (reads, lengths, wins))
    before = dp_cuda.banded_edit_distance_cuda.launches
    got = dp_cuda.banded_edit_distance_cuda(r, ln, w, k)
    assert dp_cuda.banded_edit_distance_cuda.launches == before + 1
    want = dp.banded_edit_distance(r, ln, w, k)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert bool((want[0] >= dp.INF).any()) == narrow


def test_kernel_rejects_what_it_cannot_take(cuda):
    r = torch.zeros((4, 10), dtype=torch.int8, device=cuda)
    w = torch.zeros((4, 16), dtype=torch.int8, device=cuda)
    ln = torch.full((4,), 10, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="k=9"):
        dp_cuda.banded_edit_distance_cuda(r, ln, w, dp_cuda.MAX_K + 1)
    with pytest.raises(ValueError, match="int8"):
        dp_cuda.banded_edit_distance_cuda(r.int(), ln, w, 2)
    with pytest.raises(ValueError, match="contiguous"):
        dp_cuda.banded_edit_distance_cuda(r.t().contiguous().t(), ln, w, 2)
    got = dp_cuda.banded_edit_distance_cuda(r[:0], ln[:0], w[:0], 2)
    assert got[0].shape == (0,)


def _hits_equal(a, b):
    for field in pipeline.ArrayHits._fields:
        x, y = getattr(a, field), getattr(b, field)
        assert (x == y) if isinstance(x, dict) else np.array_equal(x, y), field


def test_aligner_on_card_equals_cpu(cuda):
    rng = np.random.default_rng(9)
    unit = rng.integers(0, 4, size=300, dtype=np.uint8)
    copies = []
    for _ in range(30):
        c = unit.copy()
        mut = rng.random(300) < 0.03
        c[mut] = (c[mut] + rng.integers(1, 4, size=int(mut.sum()))) % 4
        copies.append(c)
    codes = np.concatenate(copies + [rng.integers(0, 4, size=60000, dtype=np.uint8)])
    genome = Genome.from_contigs([Contig("c", codes)])
    gi = GenomeIndex(genome, build_fm_index(genome.codes, sample_rate=16), None)
    tab = build_seed_table(genome.codes, 10)
    reads, _, _, _ = simulate_reads_array(codes, 2000, 100, seed=3, max_subs=2, indel_frac=0.2)
    reads = reads.astype(np.int8)
    lengths = np.full(2000, 100, np.int32)
    ragged = rng.integers(40, 101, size=2000).astype(np.int32)
    for kw in ({}, {"max_hits_per_piece": 2}):
        on_card = pipeline.SuffixFilterAligner(gi, seed_table=tab, seed_j=10, device=cuda, **kw)
        on_cpu = pipeline.SuffixFilterAligner(gi, seed_table=tab, seed_j=10, **kw)
        for lens in (lengths, ragged):
            before = dp_cuda.banded_edit_distance_cuda.launches
            h = on_card.align_arrays_submit(reads, lens)
            pipeline.prefetch_result(h)
            got = on_card.align_arrays_finish(h)
            assert dp_cuda.banded_edit_distance_cuda.launches > before
            _hits_equal(got, on_cpu.align_arrays_finish(on_cpu.align_arrays_submit(reads, lens)))
