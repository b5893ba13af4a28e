"""The port's host copies against the JAX package's originals: the same
code, the same arrays, and files that each package's loader reads from the
other's writer."""

import ast
import inspect
import textwrap

import numpy as np
import pytest

from genome_weaver_align_tpu.index import build as j_build
from genome_weaver_align_tpu.index import files as j_files
from genome_weaver_align_tpu.index import kmer as j_kmer
from genome_weaver_align_tpu.index import native as j_native
from genome_weaver_align_tpu.index import sais as j_sais
from genome_weaver_align_tpu.index import seedtable as j_seedtable
from genome_weaver_align_tpu.models import paired as j_paired
from genome_weaver_align_tpu.models import pipeline as j_pipeline
from genome_weaver_align_tpu.ops import affine as j_affine
from genome_weaver_align_tpu.ops import dp as j_dp
from genome_weaver_align_tpu.ops import rank as j_rank
from genome_weaver_align_tpu.ops import window as j_window
from genome_weaver_align_tpu.utils.fasta import Contig
from genome_weaver_align_tpu_torch.index import build, files, kmer, native, sais, seedtable
from genome_weaver_align_tpu_torch.models import paired, pipeline
from genome_weaver_align_tpu_torch.ops import affine, dp, rank, window

# (original module, port module, names copied verbatim).  native._load is
# one deliberate difference: it compiles with g++ into the port's _build/
# directory instead of running make in native/.  affine_banded_batch is
# another: it splits large cohorts over host threads when the library has
# no OpenMP (tests/test_torch_affine.py holds it to the single call).
COPIES = {
    "sais": (j_sais, sais, ["suffix_array_naive", "suffix_array"]),
    "build": (j_build, build, ["BLOCK_BASES", "_pair_mask", "FMIndexData", "build_fm_index"]),
    "files": (j_files, files, ["Genome", "_mask_to_spans", "GenomeIndex",
                               "build_genome_index", "_FM_FIELDS", "save_index",
                               "_marks_bits", "load_index"]),
    "seedtable": (j_seedtable, seedtable, ["rolling_kmers", "build_seed_table",
                                           "build_seed_table_numpy", "save_seed_table",
                                           "load_seed_table"]),
    "kmer": (j_kmer, kmer, ["build_kmer_table", "kmer_index_of"]),
    "native": (j_native, native, ["_SYMBOLS", "_bind", "available", "_require",
                                  "suffix_array_native", "bwt_native",
                                  "seed_table_native", "suffix_array_best"]),
    "affine": (j_affine, affine, ["_NEG", "_load_native", "_score_rows",
                                  "affine_banded_batch_numpy", "affine_semiglobal_host"]),
    "window": (j_window, window, ["gather_windows_host"]),
    "dp": (j_dp, dp, ["_HINF", "banded_rows_host", "traceback_banded_batch"]),
    "pipeline": (j_pipeline, pipeline, ["ApproxHit", "ArrayHits", "hits_from_arrays",
                                        "revcomp_verify_batch", "reads_to_batch_verify",
                                        "pack_reads_2bit", "_RESULT_INF", "_unpack_result"]),
    "paired": (j_paired, paired, ["PairHit", "_ref_span", "_with_mate"]),
    "rank": (j_rank, rank, ["fuse_blocks"]),
}


@pytest.fixture(scope="module", autouse=True)
def _jax_native_off():
    """The JAX side runs its numpy builders here, never its in-place
    ``make -C native``: test workers running that make at once can load a
    half-written library.  The port's native build is the one under test."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_native, "_lib", None)
        mp.setattr(j_native, "_build_failed", True)
        mp.setattr(j_affine, "_native_fn", None)
        mp.setattr(j_affine, "_native_failed", True)
        yield


def _code(obj):
    """AST of a function or class with docstrings dropped (comments and
    docstrings may differ between the copies; code may not)."""
    tree = ast.parse(textwrap.dedent(inspect.getsource(obj)))
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant):
                node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)


@pytest.mark.parametrize("name", sorted(COPIES))
def test_host_copy_pinned_to_original(name):
    orig, port, names = COPIES[name]
    for n in names:
        a, b = getattr(orig, n), getattr(port, n)
        if inspect.isfunction(a) or inspect.isclass(a):
            assert _code(a) == _code(b), f"{name}.{n} drifted from the original"
        else:
            assert repr(a) == repr(b), f"{name}.{n} drifted from the original"


def _fm_fields(fm):
    n = fm.n + 1
    return {
        "n": fm.n, "primary": fm.primary, "counts": fm.counts, "C": fm.C,
        "bwt_words": fm.bwt_words, "occ_cp": fm.occ_cp, "sample_rate": fm.sample_rate,
        "marks": fm.ssa_marks.get(np.arange(n)), "ssa_values": fm.ssa_values,
        "text_words": fm.text_words, "full_sa": fm.full_sa,
    }


def _assert_fm_equal(a, b):
    fa, fb = _fm_fields(a), _fm_fields(b)
    for key in fa:
        if fa[key] is None:
            assert fb[key] is None, key
        else:
            assert np.array_equal(np.asarray(fa[key]), np.asarray(fb[key])), key
            assert np.asarray(fa[key]).dtype == np.asarray(fb[key]).dtype, key


@pytest.fixture(scope="module")
def genome_codes():
    return np.random.default_rng(21).integers(0, 4, size=20011, dtype=np.uint8)


@pytest.mark.parametrize("builder", ["auto", "numpy"])
@pytest.mark.parametrize("full_sa", [False, True])
def test_build_fm_index_identical(genome_codes, builder, full_sa):
    sa_j = j_sais.suffix_array(genome_codes) if builder == "numpy" else None
    sa_p = sais.suffix_array(genome_codes) if builder == "numpy" else None
    want = j_build.build_fm_index(genome_codes, sample_rate=8, sa=sa_j, keep_full_sa=full_sa)
    got = build.build_fm_index(genome_codes, sample_rate=8, sa=sa_p, keep_full_sa=full_sa)
    _assert_fm_equal(got, want)


def test_native_builds_into_port_dir():
    assert native.available()
    assert native._lib_path().parent.name == "_build"
    assert native._lib_path().exists()


@pytest.mark.parametrize("j", [6, 9])
def test_build_seed_table_identical(genome_codes, j):
    want = j_seedtable.build_seed_table(genome_codes, j)
    got = seedtable.build_seed_table(genome_codes, j)
    ref = seedtable.build_seed_table_numpy(genome_codes, j)
    for a, b, c in zip(got, want, ref):
        assert a.dtype == b.dtype == np.int32
        assert np.array_equal(a, b) and np.array_equal(a, c)


def test_kmer_table_identical(genome_codes):
    fm_j = j_build.build_fm_index(genome_codes, sample_rate=16)
    fm_p = build.build_fm_index(genome_codes, sample_rate=16)
    for a, b in zip(kmer.build_kmer_table(fm_p, 5), j_kmer.build_kmer_table(fm_j, 5)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_index_files_cross_load(tmp_path, writer):
    rng = np.random.default_rng(4)
    c1 = rng.integers(0, 4, size=7000, dtype=np.uint8)
    c1[100:130] = 4  # an N run, resolved and recorded in n_mask_spans
    contigs = [Contig("chrA", c1), Contig("chrB", rng.integers(0, 4, size=5000, dtype=np.uint8))]
    w_files, r_files = (files, j_files) if writer == "port" else (j_files, files)
    gi = w_files.build_genome_index(w_files.Genome.from_contigs(contigs), sample_rate=8,
                                    keep_full_sa=True)
    path = tmp_path / "g.npz"
    w_files.save_index(path, gi)
    back = r_files.load_index(path)
    assert back.genome.names == gi.genome.names
    assert np.array_equal(back.genome.offsets, gi.genome.offsets)
    assert np.array_equal(back.genome.codes, gi.genome.codes)
    assert np.array_equal(back.genome.n_mask_spans, gi.genome.n_mask_spans)
    _assert_fm_equal(back.fwd, gi.fwd)
    _assert_fm_equal(back.rev, gi.rev)
    # the seed-table file format too
    o, p = seedtable.build_seed_table(gi.genome.codes, 7)
    (seedtable if writer == "port" else j_seedtable).save_seed_table(tmp_path / "s.npz", o, p, 7)
    o2, p2, j2 = (j_seedtable if writer == "port" else seedtable).load_seed_table(tmp_path / "s.npz")
    assert j2 == 7 and np.array_equal(o, o2) and np.array_equal(p, p2)
