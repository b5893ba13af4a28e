"""The port reproduces ``tests/data/golden.sam``: the JAX package's golden
dataset (FM pigeonhole single-end block at k = 4, then a paired block with
mate rescue) run through the port's aligners gives the same SAM on every
line but ``@PG``, which names the program."""

from pathlib import Path

import numpy as np
import pytest

from genome_weaver_align_tpu.index import native as j_native
from genome_weaver_align_tpu.index.files import Genome, build_genome_index
from genome_weaver_align_tpu.models.pipeline import SuffixFilterAligner as JaxAligner
from genome_weaver_align_tpu.ops import affine as j_affine
from genome_weaver_align_tpu.utils import simulate
from genome_weaver_align_tpu.utils.fasta import Contig, Read
from genome_weaver_align_tpu_torch.models.paired import PairedAligner
from genome_weaver_align_tpu_torch.models.pipeline import SuffixFilterAligner
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

GOLDEN = Path(__file__).parent / "data" / "golden.sam"


@pytest.fixture(scope="module", autouse=True)
def _jax_native_off():
    """The golden index comes from the JAX package's numpy builders here,
    never from its in-place ``make -C native``: test workers running that
    make at once can load a half-written library."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_native, "_lib", None)
        mp.setattr(j_native, "_build_failed", True)
        mp.setattr(j_affine, "_native_fn", None)
        mp.setattr(j_affine, "_native_failed", True)
        yield


@pytest.fixture(scope="module")
def golden_inputs():
    """tests/test_golden_sam.py::build_output's genome and reads."""
    rng = np.random.default_rng(2026)
    gi = build_genome_index(
        Genome.from_contigs(
            [
                Contig("gA", rng.integers(0, 4, size=30000, dtype=np.uint8)),
                Contig("gB", rng.integers(0, 4, size=20000, dtype=np.uint8)),
            ]
        ),
        sample_rate=16,
    )
    sims = simulate.simulate_reads(
        gi.genome.codes, 24, 100, seed=11, sub_rate=0.02, max_subs=2,
        indel_rate=0.01, max_indels=2,
    )
    reads = [s.read for s in sims]
    nr = reads[0].codes.copy()
    nr[10:13] = 4
    reads.append(Read("with_n", nr))
    reads.append(Read("junk", rng.integers(0, 4, size=100, dtype=np.uint8)))
    pairs = [
        (p.r1.read, p.r2.read)
        for p in simulate.simulate_pairs(gi.genome.codes, 6, 100, seed=12, sub_rate=0.01, max_subs=1)
    ]
    return gi, reads, pairs


def test_jax_sends_no_golden_read_to_tier2(golden_inputs):
    """The golden single-end block sends no read to the tier-2 staircase,
    so the golden file does not depend on it (tier 2 has its own parity
    tests in test_torch_pipeline.py)."""
    gi, reads, _ = golden_inputs
    jal = JaxAligner(gi, k=4)
    jal.align_batch(reads)
    assert jal.last_stats.get("n_staircase_fallback", 0) == 0


def test_port_reproduces_golden_sam(golden_inputs):
    gi, reads, pairs = golden_inputs
    al = SuffixFilterAligner(gi, k=4, device="cpu")
    lines = [al.sam_header()]
    lines += [r.line() for r in al.to_sam(reads, al.align_batch(reads))]
    assert al.last_stats["n_staircase_fallback"] == 0
    pal = PairedAligner(al)
    phits = pal.align_pairs(pairs)
    lines += [r.line() for r in pal.to_sam(pairs, phits)]
    got = "\n".join(lines) + "\n"
    want = GOLDEN.read_text()
    strip = lambda text: [l for l in text.splitlines() if not l.startswith("@PG")]
    assert strip(got) == strip(want)
    assert [l for l in got.splitlines() if l.startswith("@PG")] == ["@PG\tID:gwa-torch\tPN:gwa-torch"]
    assert len(strip(got)) == len(want.splitlines()) - 1
