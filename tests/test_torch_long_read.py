"""The port's long-read mapper (``models/long_read.py``) against the JAX
package's on the same numpy index and seed table: ``_chunk_vote_verify``
and ``LongReadAligner.align_arrays`` (with and without traceback) equal
field for field on ragged reads of 512-1,024 bases on both strands, a read
shorter than one segment, a read of junk and a read with N codes, at the
default segment band kb = 16 and at kb = 0, 17, 24 and 32; and the plain
banded DP at the long-read band (k = 15, 16) equal to the JAX jnp engine on
every lane."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genome_weaver_align_tpu.index import native as j_native
from genome_weaver_align_tpu.index.build import build_fm_index
from genome_weaver_align_tpu.index.files import Genome, GenomeIndex
from genome_weaver_align_tpu.index.seedtable import build_seed_table
from genome_weaver_align_tpu.models import long_read as j_long_read
from genome_weaver_align_tpu.ops import affine as j_affine
from genome_weaver_align_tpu.ops import dp as j_dp
from genome_weaver_align_tpu.utils.fasta import Contig
from genome_weaver_align_tpu_torch.models import long_read
from genome_weaver_align_tpu_torch.ops import dp
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

J = 10


@pytest.fixture(scope="module", autouse=True)
def _jax_native_off():
    """The JAX side runs its numpy builders and scored engine here, never
    its in-place ``make -C native``."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_native, "_lib", None)
        mp.setattr(j_native, "_build_failed", True)
        mp.setattr(j_affine, "_native_fn", None)
        mp.setattr(j_affine, "_native_failed", True)
        yield


@pytest.fixture(scope="module")
def setup():
    codes = np.random.default_rng(71).integers(0, 4, size=50_000, dtype=np.uint8)
    genome = Genome.from_contigs([Contig("chrL", codes)])
    gi = GenomeIndex(genome, build_fm_index(genome.codes, sample_rate=16), None)
    return codes, gi, build_seed_table(codes, J)


def _long_reads(codes, seed):
    """(B, 1024) int8 reads zero-padded past their lengths, as the CLI
    batches them: ragged reads of 512-1,024 bases on both strands with 6
    substitutions and 2 one-base indels each, one read of 100 bases (less
    than a segment), one of junk, one with N codes."""
    rng = np.random.default_rng(seed)
    L = 1024
    lens = [1024, 1000, 512, 777, 900, 640, 1024, 513, 100, 700, 1024]
    reads = np.zeros((len(lens), L), dtype=np.int8)
    for i, n in enumerate(lens):
        p = int(rng.integers(0, codes.size - n - 50))
        seq = list(codes[p : p + n + 20])
        if n > 200:
            for _ in range(2):
                at = int(rng.integers(50, n - 50))
                if rng.random() < 0.5:
                    seq.insert(at, int(rng.integers(0, 4)))
                else:
                    del seq[at]
        seq = np.array(seq[:n], dtype=np.int8)
        at = rng.integers(0, n, size=6)
        seq[at] = (seq[at] + rng.integers(1, 4, size=6)) % 4
        if i % 2:
            seq = (3 - seq)[::-1]
        reads[i, :n] = seq
    reads[9, :700] = rng.integers(0, 4, size=700)  # junk
    reads[10, 300:304] = 4  # N codes
    return reads, np.asarray(lens, np.int32)


def test_chunk_vote_verify_matches_jax(setup):
    codes, gi, (so, sp) = setup
    reads, lens = _long_reads(codes, seed=1)
    kw = dict(j=J, seg_len=128, hits_per_seg=4, n_probes=4, band=48, kb=16)
    s = np.where(reads >= 4, 0, reads)
    want = j_long_read._chunk_vote_verify(
        jnp.asarray(so), jnp.asarray(sp), jnp.asarray(gi.fwd.text_words), gi.fwd.n,
        jnp.asarray(s.astype(np.int32)), jnp.asarray(reads.astype(np.int32)), jnp.asarray(lens),
        **kw)
    got = long_read._chunk_vote_verify(
        torch.from_numpy(so.astype(np.int32)), torch.from_numpy(sp.astype(np.int32)),
        torch.from_numpy(gi.fwd.text_words.view(np.int32)), gi.fwd.n,
        torch.from_numpy(s), torch.from_numpy(reads), torch.from_numpy(lens), **kw)
    for name, g, w in zip(("best_diag", "dist_total", "support"), got, want):
        assert np.array_equal(g.numpy(), np.asarray(w)), name
    # the real reads voted and verified: most segments support the diagonal
    assert (got[2].numpy()[[0, 2, 4, 6]] >= 4).all()


def _hits_equal(a, b):
    for field in long_read.LongHits._fields:
        x, y = getattr(a, field), getattr(b, field)
        if isinstance(x, dict):
            assert x == y, field
        else:
            assert np.array_equal(np.asarray(x), np.asarray(y)), field


@pytest.mark.parametrize("traceback", [True, False])
def test_long_read_aligner_matches_jax(setup, traceback):
    codes, gi, tab = setup
    reads, lens = _long_reads(codes, seed=2)
    want = j_long_read.LongReadAligner(gi, tab, J).align_arrays(reads, lens, traceback=traceback)
    got = long_read.LongReadAligner(gi, tab, J, device="cpu").align_arrays(
        reads, lens, traceback=traceback)
    _hits_equal(got, want)
    # both strands mapped, the junk read not
    assert got.mapped[[0, 1, 2, 3]].all() and not got.mapped[9]
    assert set(got.strand[got.mapped].tolist()) == {0, 1}
    if traceback:
        assert any(("I" in c or "D" in c) for c in got.cigars.values())


def test_long_read_aligner_other_shapes_match_jax(setup):
    """A narrower segment band and segment length than the defaults."""
    codes, gi, tab = setup
    reads, lens = _long_reads(codes, seed=3)
    kw = dict(seg_len=96, hits_per_seg=3, n_probes=3, band=32, kb=8, min_support=2)
    want = j_long_read.LongReadAligner(gi, tab, J, **kw).align_arrays(reads, lens)
    got = long_read.LongReadAligner(gi, tab, J, device="cpu", **kw).align_arrays(reads, lens)
    _hits_equal(got, want)


@pytest.mark.parametrize("kb", [0, 17, -1])
def test_kb_outside_1_to_16_is_refused(setup, kb):
    """A band outside the one-thread kernel's 1..16: the port takes what
    the JAX aligner computes (kb = 0, a band of one slot, and kb = 17, a
    group of threads on the card) with the JAX aligner's hits, and refuses
    kb = -1 when built, where the JAX aligner fails as it verifies."""
    codes, gi, tab = setup
    reads, lens = _long_reads(codes, seed=5)
    if kb < 0:
        with pytest.raises(ValueError, match="kb >= 0"):
            long_read.LongReadAligner(gi, tab, J, kb=kb, device="cpu")
        with pytest.raises(IndexError):
            j_long_read.LongReadAligner(gi, tab, J, kb=kb).align_arrays(reads, lens)
        return
    want = j_long_read.LongReadAligner(gi, tab, J, kb=kb).align_arrays(reads, lens,
                                                                       traceback=False)
    got = long_read.LongReadAligner(gi, tab, J, kb=kb, device="cpu").align_arrays(
        reads, lens, traceback=False)
    _hits_equal(got, want)
    assert got.mapped.sum() >= 6


@pytest.mark.parametrize("kb", [17, 24, 32])
def test_long_read_aligner_wide_band_matches_jax(setup, kb):
    """Segment bands past the one-thread kernel's 16 (a group of 8 or 16
    threads a lane on the card), without traceback: every field equal to
    the JAX aligner's."""
    codes, gi, tab = setup
    reads, lens = _long_reads(codes, seed=kb)
    want = j_long_read.LongReadAligner(gi, tab, J, kb=kb).align_arrays(reads, lens,
                                                                       traceback=False)
    got = long_read.LongReadAligner(gi, tab, J, kb=kb, device="cpu").align_arrays(
        reads, lens, traceback=False)
    _hits_equal(got, want)
    assert got.mapped[[0, 1, 2, 3]].all() and not got.mapped[9]


@pytest.mark.parametrize("k", [15, 16])
def test_banded_dp_at_long_read_band_matches_jax(k):
    """The plain banded DP at k = 15 and 16 against the JAX jnp engine on
    every lane, dist and end_b: planted reads with a few edits, random
    lanes, ragged and 0-length reads, N codes, a narrow window."""
    rng = np.random.default_rng(k)
    Q, L = 96, 128
    for W in (L + 3 * k, L // 2):
        reads = rng.integers(0, 5, size=(Q, L)).astype(np.int8)
        wins = rng.integers(0, 5, size=(Q, W)).astype(np.int8)
        span = min(L, W - 2 * k)
        if span > 0:
            wins[::2, k : k + span] = reads[::2, :span]
            at = rng.integers(0, W, size=(Q // 2, 3))
            wins[np.arange(0, Q, 2)[:, None], at] = rng.integers(0, 4, size=at.shape)
        lengths = rng.integers(0, L + 1, size=Q).astype(np.int32)
        lengths[: Q // 2] = L
        lengths[5] = 0
        got_d, got_e = (t.numpy() for t in dp.banded_edit_distance(
            torch.from_numpy(reads), torch.from_numpy(lengths), torch.from_numpy(wins), k))
        want_d, want_e = (np.asarray(a) for a in j_dp.banded_edit_distance_best(
            jnp.asarray(reads.astype(np.int32)), jnp.asarray(lengths),
            jnp.asarray(wins.astype(np.int32)), k, engine="jnp"))
        assert np.array_equal(got_d, want_d), W
        assert np.array_equal(got_e, want_e), W
        assert (got_d <= k).any()
