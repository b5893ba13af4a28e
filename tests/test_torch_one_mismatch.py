"""The port's 1-mismatch bidirectional search (``models/one_mismatch.py``)
against the JAX package's: candidate intervals and overflow flags equal,
recall and precision against a brute-force Hamming scan, variable lengths,
a pool small enough to overflow, and ``OneMismatchAligner`` hits and SAM
lines equal end to end."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genome_weaver_align_tpu.index import native as j_native
from genome_weaver_align_tpu.index.build import build_fm_index
from genome_weaver_align_tpu.index.files import Genome, build_genome_index
from genome_weaver_align_tpu.models import bidirectional as j_bd
from genome_weaver_align_tpu.models import one_mismatch as j_one_mismatch
from genome_weaver_align_tpu.utils import simulate
from genome_weaver_align_tpu.utils.fasta import Contig, Read
from genome_weaver_align_tpu_torch.models import bidirectional as bd
from genome_weaver_align_tpu_torch.models import exact, one_mismatch
from genome_weaver_align_tpu_torch.ops import rank
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _jax_native_off():
    """The index comes from the JAX package's numpy SA builder, never from
    its in-place ``make -C native``."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_native, "_lib", None)
        mp.setattr(j_native, "_build_failed", True)
        yield


@pytest.fixture(scope="module")
def setup():
    codes = np.random.default_rng(11).integers(0, 4, size=30000, dtype=np.uint8)
    fwd = build_fm_index(codes, sample_rate=16)
    rev = build_fm_index(codes[::-1].copy(), sample_rate=16)
    return codes, fwd, rev, bd.from_host_bi(fwd, rev, CPU), j_bd.from_host_bi(fwd, rev)


def brute_hits(codes, read, maxmm=1):
    wins = np.lib.stride_tricks.sliding_window_view(codes, read.size)
    mm = (wins != read[None, :]).sum(axis=1)
    return set(np.nonzero(mm <= maxmm)[0].tolist())


def _both(setup, reads, lengths, **kw):
    bi, jbi = setup[3], setup[4]
    got = one_mismatch.one_mismatch_candidates(
        bi, torch.from_numpy(reads), torch.from_numpy(lengths), **kw)
    want = j_one_mismatch.one_mismatch_candidates(
        jbi, jnp.asarray(reads), jnp.asarray(lengths), **kw)
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), np.asarray(b))
    return got


def _positions(fwd, cand_lo, cand_hi, max_hits=8):
    B, C = cand_lo.shape
    pos, valid = exact.locate_hits(rank.from_host(fwd), cand_lo.reshape(-1),
                                   cand_hi.reshape(-1), max_hits)
    pos, valid = pos.reshape(B, -1).numpy(), valid.reshape(B, -1).numpy()
    return [set(pos[i][valid[i]].tolist()) for i in range(B)]


def test_one_mismatch_recall_precision_matches_jax(setup):
    codes, fwd = setup[0], setup[1]
    rng = np.random.default_rng(5)
    B, L = 48, 40
    reads = np.zeros((B, L), dtype=np.int32)
    planted = []
    for i in range(B):
        p = int(rng.integers(0, codes.size - L))
        r = codes[p : p + L].astype(np.int32).copy()
        nmm = int(rng.integers(0, 2))
        for _ in range(nmm):
            at = int(rng.integers(0, L))
            r[at] = (r[at] + 1 + rng.integers(0, 3)) % 4
        reads[i] = r
        planted.append(p)
    cand_lo, cand_hi, ovf = _both(setup, reads, np.full(B, L, np.int32))
    assert not ovf.any(), "slot overflow on random genome"
    got = _positions(fwd, cand_lo, cand_hi)
    for i in range(B):
        assert got[i] == brute_hits(codes, reads[i]), i
        assert planted[i] in got[i]


def test_one_mismatch_variable_lengths_matches_jax(setup):
    codes, fwd = setup[0], setup[1]
    rng = np.random.default_rng(9)
    B, L = 16, 36
    reads = np.zeros((B, L), dtype=np.int32)
    lengths = rng.integers(20, L + 1, size=B).astype(np.int32)
    for i in range(B):
        l = int(lengths[i])
        p = int(rng.integers(0, codes.size - l))
        r = codes[p : p + l].astype(np.int32).copy()
        at = int(rng.integers(0, l))
        r[at] = (r[at] + 1 + rng.integers(0, 3)) % 4
        reads[i, :l] = r
    cand_lo, cand_hi, _ = _both(setup, reads, lengths)
    got = _positions(fwd, cand_lo, cand_hi)
    for i in range(B):
        l = int(lengths[i])
        assert got[i] == brute_hits(codes, reads[i, :l]), f"read {i} len={l}"


def test_one_mismatch_small_pool_overflows_like_jax(setup):
    """Short reads in a 4-slot pool: branches outgrow it, and the flags,
    the packed slots and max_len agree with JAX."""
    codes = setup[0]
    rng = np.random.default_rng(2)
    B, L = 24, 10
    reads = np.stack([codes[p : p + L] for p in rng.integers(0, codes.size - L, size=B)])
    reads = reads.astype(np.int32)
    _, _, ovf = _both(setup, reads, np.full(B, L, np.int32), n_slots=4)
    assert ovf.any()
    _both(setup, reads, np.full(B, L, np.int32), n_slots=4, max_len=8)


@pytest.fixture(scope="module")
def gi():
    rng = np.random.default_rng(19)
    return build_genome_index(
        Genome.from_contigs([Contig("c", rng.integers(0, 4, size=40000, dtype=np.uint8))]),
        sample_rate=16,
    )


def test_one_mismatch_aligner_matches_jax(gi):
    """End to end: hits (position, strand, mismatches, overflow) and SAM
    lines equal to the JAX aligner's, with an N read, a ragged read and an
    unmappable read in the batch."""
    sims = simulate.simulate_reads(gi.genome.codes, 30, 100, seed=4, sub_rate=0.005, max_subs=1)
    reads = [s.read for s in sims]
    withn = reads[0].codes.copy()
    withn[20] = 4
    reads += [Read("with_n", withn), Read("short", reads[1].codes[:70].copy()),
              Read("junk", np.random.default_rng(1).integers(0, 4, size=100, dtype=np.uint8))]
    jal = j_one_mismatch.OneMismatchAligner(gi)
    pal = one_mismatch.OneMismatchAligner(gi, device=CPU)
    want, got = jal.align_batch(reads), pal.align_batch(reads)
    assert [None if h is None else h.__dict__ for h in got] == \
        [None if h is None else h.__dict__ for h in want]
    for s, h in zip(sims, got):
        assert h is not None and h.dist == s.n_sub
        if h.pos == s.true_pos:
            assert h.strand == s.true_strand
    assert [r.line() for r in pal.to_sam(reads, got)] == [r.line() for r in jal.to_sam(reads, want)]
    assert pal.sam_header().endswith("@PG\tID:gwa-torch\tPN:gwa-torch")
