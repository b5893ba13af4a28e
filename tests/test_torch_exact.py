"""The port's exact search (``models/exact.py``) against the JAX package's:
intervals with and without the k-mer table, located hits and the host
reverse complement, exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genome_weaver_align_tpu.index import native as j_native
from genome_weaver_align_tpu.index.build import build_fm_index
from genome_weaver_align_tpu.index.kmer import build_kmer_table
from genome_weaver_align_tpu.models import exact as j_exact
from genome_weaver_align_tpu.ops import rank as j_rank
from genome_weaver_align_tpu_torch.models import exact
from genome_weaver_align_tpu_torch.ops import rank
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)


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
    rng = np.random.default_rng(17)
    codes = np.concatenate([np.tile(rng.integers(0, 4, size=50, dtype=np.uint8), 6),
                            rng.integers(0, 4, size=6000, dtype=np.uint8)])
    fm = build_fm_index(codes, sample_rate=8)
    B, L = 64, 30
    reads = np.zeros((B, L), dtype=np.int32)
    lengths = rng.integers(3, L + 1, size=B).astype(np.int32)
    for i in range(B):
        p = int(rng.integers(0, codes.size - L))
        reads[i] = codes[p : p + L]
    reads[::4, 1] = (reads[::4, 1] + 2) % 4
    reads[::7, 0] = 0  # reads that start in the repeat or nowhere
    return codes, fm, reads, lengths


@pytest.mark.parametrize("kmer_j", [0, 4, 6])
@pytest.mark.parametrize("max_len", [None, 12])
def test_exact_interval_search_matches_jax(setup, kmer_j, max_len):
    _, fm, reads, lengths = setup
    jfm, pfm = j_rank.from_host(fm), rank.from_host(fm)
    jtab = ptab = None
    if kmer_j:
        lo, hi = build_kmer_table(fm, kmer_j)
        jtab = (jnp.asarray(lo), jnp.asarray(hi))
        ptab = (torch.from_numpy(lo.astype(np.int32)), torch.from_numpy(hi.astype(np.int32)))
    want = j_exact.exact_interval_search(
        jfm, jnp.asarray(reads), jnp.asarray(lengths), max_len=max_len, kmer_tab=jtab,
        kmer_j=kmer_j,
    )
    got = exact.exact_interval_search(
        pfm, torch.from_numpy(reads), torch.from_numpy(lengths), max_len=max_len,
        kmer_tab=ptab, kmer_j=kmer_j,
    )
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("max_hits", [1, 8])
def test_locate_hits_matches_jax(setup, max_hits):
    codes, fm, reads, lengths = setup
    jfm, pfm = j_rank.from_host(fm), rank.from_host(fm)
    lo, hi = j_exact.exact_interval_search(jfm, jnp.asarray(reads), jnp.asarray(lengths))
    want = j_exact.locate_hits(jfm, lo, hi, max_hits)
    got = exact.locate_hits(pfm, torch.from_numpy(np.array(lo)), torch.from_numpy(np.array(hi)),
                            max_hits)
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), np.asarray(b))
    pos, valid = got
    for i in np.nonzero(valid[:, 0].numpy())[0]:
        l = int(lengths[i])
        p = int(pos[i, 0])
        assert codes[p : p + l].tolist() == reads[i, :l].tolist()


def test_revcomp_batch_matches_jax(setup):
    _, _, reads, lengths = setup
    assert np.array_equal(exact.revcomp_batch(reads, lengths), j_exact.revcomp_batch(reads, lengths))


# ------------------------------------------------------------- ExactAligner


@pytest.fixture(scope="module")
def exact_gi():
    from genome_weaver_align_tpu.index.files import Genome, build_genome_index
    from genome_weaver_align_tpu.utils.fasta import Contig

    rng = np.random.default_rng(0)
    cs = [Contig(f"chr{i}", rng.integers(0, 4, size=10000, dtype=np.uint8)) for i in range(2)]
    return build_genome_index(Genome.from_contigs(cs), sample_rate=16)


@pytest.mark.parametrize("kmer_j", [0, 5])
def test_exact_aligner_matches_jax(exact_gi, kmer_j):
    """``ExactAligner`` end to end (acceptance config 1): hits and SAM lines
    equal to the JAX aligner's on simulated 36 bp reads both strands, a read
    with an N, a ragged batch and an absent read; the true locus wins where
    the read is unique."""
    from genome_weaver_align_tpu.models.pipeline import ExactAligner as JaxExactAligner
    from genome_weaver_align_tpu.utils import simulate
    from genome_weaver_align_tpu.utils.fasta import Read
    from genome_weaver_align_tpu_torch.models.pipeline import ExactAligner

    gi = exact_gi
    sims = simulate.simulate_reads(gi.genome.codes, n_reads=100, read_len=36, seed=3)
    reads = [s.read for s in sims]
    kw = {}
    if kmer_j:
        kw = dict(kmer_table=build_kmer_table(gi.fwd, kmer_j), kmer_j=kmer_j)
    jal, pal = JaxExactAligner(gi, **kw), ExactAligner(gi, device="cpu", **kw)
    hits = pal.align_batch(reads)
    assert [h.__dict__ for h in hits] == [h.__dict__ for h in jal.align_batch(reads)]
    assert sum(h.pos == s.true_pos and h.strand == s.true_strand
               for s, h in zip(sims, hits) if h.n_hits == 1) >= 90
    assert [r.line() for r in pal.to_sam(reads, hits)] == \
        [r.line() for r in jal.to_sam(reads, jal.align_batch(reads))]

    rng = np.random.default_rng(99)
    withn = reads[0].codes.copy()
    withn[5] = 4
    odd = [Read("noexist", rng.integers(0, 4, size=36, dtype=np.uint8)), Read("with_n", withn),
           Read("short", reads[2].codes[:20].copy()), reads[3]]
    got, want = pal.align_batch(odd), jal.align_batch(odd)
    assert [None if h is None else h.__dict__ for h in got] == \
        [None if h is None else h.__dict__ for h in want]
    assert [r.line() for r in pal.to_sam(odd, got)] == [r.line() for r in jal.to_sam(odd, want)]
    assert pal.sam_header().endswith("@PG\tID:gwa-torch\tPN:gwa-torch")
