"""The FM search loops that run as CUDA kernels on the card, on the CPU.

- The plain versions (``exact_interval_search_plain``,
  ``piece_interval_search_plain``, the staircase's pool search and
  ``one_mismatch_candidates_plain``) against the JAX package's functions,
  on every output, at the kernels' edges: reads of length 0, 1 and < P,
  ``max_len`` shorter than the reads, ``n_slots`` 1 and 64, ``keep`` 1,
  ``narrow_left`` at k = 3, ``kmer_full_cover``, and a spine that dies at
  its first step.
- The scalar models of the kernels (``tests/torch_fm_models.py``, in the
  CUDA sources' own loop order) against the plain versions on every field,
  at several lane-group sizes.
- What the one-mismatch kernel rests on, in the plain loop and in the JAX
  function alike (each slot update spied): a dead slot has lo == hi at
  every step, case A leaves a dead slot's (lo, hi) as it is, and case B
  moves dead slots of equal lo alike, on a genome whose reads hold several
  distinct dead lo values at once.
- The bindings refuse what the kernels cannot take, a CPU tensor reaches
  the plain version and never a kernel, and ``rank.from_host`` and
  ``rank.from_arrays`` take no default device.

Everything is int32, so every comparison is exact equality."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genome_weaver_align_tpu.index import native as j_native
from genome_weaver_align_tpu.index.build import build_fm_index
from genome_weaver_align_tpu.index.kmer import build_kmer_table
from genome_weaver_align_tpu.models import bidirectional as j_bd
from genome_weaver_align_tpu.models import exact as j_exact
from genome_weaver_align_tpu.models import one_mismatch as j_one_mismatch
from genome_weaver_align_tpu.models import staircase as j_staircase
from genome_weaver_align_tpu.models import suffix_filter as j_sf
from genome_weaver_align_tpu.ops import rank as j_rank
from genome_weaver_align_tpu_torch.models import bidirectional as bd
from genome_weaver_align_tpu_torch.models import exact, one_mismatch, staircase, suffix_filter
from genome_weaver_align_tpu_torch.ops import (
    fm_search_cuda, one_mismatch_cuda, rank, staircase_cuda,
)
from tests import torch_fm_models as models
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _jax_native_off():
    """The indexes come from the JAX package's numpy SA builder, never from
    its in-place ``make -C native``."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_native, "_lib", None)
        mp.setattr(j_native, "_build_failed", True)
        yield


def _index(codes):
    fwd = build_fm_index(codes, sample_rate=16)
    rev = build_fm_index(codes[::-1].copy(), sample_rate=16)
    return dict(codes=codes, fwd=fwd, rev=rev, bi=bd.from_host_bi(fwd, rev, CPU),
                jbi=j_bd.from_host_bi(fwd, rev), fm=rank.from_host(fwd, CPU),
                jfm=j_rank.from_host(fwd))


@pytest.fixture(scope="module")
def genome():
    """A random genome with a 40 bp unit repeated 12 times (wide
    intervals, pools that overflow) and its 4-mer table."""
    g = _index(models.genome_codes(91))
    lo, hi = build_kmer_table(g["fwd"], 4)
    g["ptab"] = (torch.from_numpy(lo.astype(np.int32)), torch.from_numpy(hi.astype(np.int32)))
    g["jtab"] = (jnp.asarray(lo), jnp.asarray(hi))
    return g


@pytest.fixture(scope="module")
def no_t_genome():
    """A genome without code 3: a piece ending in 3 has an empty spine
    after its first step."""
    return _index(models.genome_codes(92, alphabet=3, size=6_000))


@pytest.fixture(scope="module")
def chains():
    """A 7 bp unit repeated 300 times, 5% of it changed: one-mismatch
    branches die at different places (several dead chains a read)."""
    return _index(models.chains_genome(93))


def _eq(got, want):
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        assert np.array_equal(a, np.asarray(b)), f"output {i} differs"


# ---------------------------------------------------------------- plain vs JAX

@pytest.mark.parametrize("kmer_j", [0, 4])
@pytest.mark.parametrize("max_len", [None, 9])
def test_exact_plain_matches_jax_at_edges(genome, kmer_j, max_len):
    reads, lengths = models.edge_reads(genome["codes"], 1)
    kw = dict(max_len=max_len, kmer_j=kmer_j)
    got = exact.exact_interval_search_plain(
        genome["fm"], torch.from_numpy(reads), torch.from_numpy(lengths),
        kmer_tab=genome["ptab"] if kmer_j else None, **kw)
    want = j_exact.exact_interval_search(
        genome["jfm"], jnp.asarray(reads), jnp.asarray(lengths),
        kmer_tab=genome["jtab"] if kmer_j else None, **kw)
    _eq(got, want)


@pytest.mark.parametrize("kmer", ["none", "table", "full_cover"])
@pytest.mark.parametrize("max_len", [None, 6])
def test_piece_plain_matches_jax_at_edges(genome, kmer, max_len):
    reads, lengths = models.edge_reads(genome["codes"], 2)
    if kmer == "full_cover":  # the caller guarantees pieces of at least kmer_j
        lengths = np.maximum(lengths, 12).astype(np.int32)
    kw = dict(max_len=max_len, kmer_j=0 if kmer == "none" else 4,
              kmer_full_cover=kmer == "full_cover")
    got = suffix_filter.piece_interval_search_plain(
        genome["fm"], torch.from_numpy(reads), torch.from_numpy(lengths), 3,
        kmer_tab=None if kmer == "none" else genome["ptab"], **kw)
    want = j_sf.piece_interval_search(
        genome["jfm"], jnp.asarray(reads), jnp.asarray(lengths), 3,
        kmer_tab=None if kmer == "none" else genome["jtab"], **kw)
    _eq(got, want)


STAIRCASE_EDGES = [
    dict(k=2, n_slots=1),
    dict(k=2, n_slots=64),
    dict(k=2, keep=1),
    dict(k=3, narrow_left=True),
    dict(k=2, n_slots=2, narrow_left=True, keep=3, hits_per_state=2),
    dict(k=2, max_len=20),
    dict(k=2, n_slots=65),
    dict(k=2, n_slots=128, narrow_left=True),
]


@pytest.mark.parametrize("kw", STAIRCASE_EDGES, ids=lambda kw: "-".join(map(str, kw.values())))
def test_staircase_plain_matches_jax_at_edges(genome, kw):
    reads, lengths = models.edge_reads(genome["codes"], 3)
    kw = dict(kw)
    k = kw.pop("k")
    got = staircase.staircase_filter_candidates(
        genome["bi"], torch.from_numpy(reads), torch.from_numpy(lengths), k, **kw)
    want = j_staircase.staircase_filter_candidates(
        genome["jbi"], jnp.asarray(reads), jnp.asarray(lengths), k, **kw)
    _eq(got, want)


@pytest.mark.parametrize("kw", [dict(n_slots=1), dict(n_slots=64), dict(max_len=7),
                                dict(n_slots=65), dict(n_slots=128)],
                         ids=["slots1", "slots64", "max_len7", "slots65", "slots128"])
def test_one_mismatch_plain_matches_jax_at_edges(genome, kw):
    reads, lengths = models.edge_reads(genome["codes"], 4, subs=1)
    got = one_mismatch.one_mismatch_candidates_plain(
        genome["bi"], torch.from_numpy(reads), torch.from_numpy(lengths), **kw)
    want = j_one_mismatch.one_mismatch_candidates(
        genome["jbi"], jnp.asarray(reads), jnp.asarray(lengths), **kw)
    _eq(got, want)


def test_spines_dying_at_their_first_step_match_jax(no_t_genome):
    g = no_t_genome
    reads, lengths = models.dying_reads(g["codes"], 5)
    r, ln = torch.from_numpy(reads), torch.from_numpy(lengths)
    _eq(staircase.staircase_filter_candidates(g["bi"], r, ln, 2),
        j_staircase.staircase_filter_candidates(g["jbi"], jnp.asarray(reads),
                                                jnp.asarray(lengths), 2))
    _eq(one_mismatch.one_mismatch_candidates_plain(g["bi"], r, ln),
        j_one_mismatch.one_mismatch_candidates(g["jbi"], jnp.asarray(reads),
                                               jnp.asarray(lengths)))
    _eq(suffix_filter.piece_interval_search_plain(g["fm"], r, ln, 3),
        j_sf.piece_interval_search(g["jfm"], jnp.asarray(reads), jnp.asarray(lengths), 3))


# ---------------------------------------------------------------- kernel models vs plain

@pytest.mark.parametrize("P", [1, 3])
@pytest.mark.parametrize("kmer", ["none", "table", "full_cover"])
@pytest.mark.parametrize("max_len", [None, 9])
def test_backward_search_model_matches_plain(genome, P, kmer, max_len):
    reads, lengths = models.edge_reads(genome["codes"], 6)
    if kmer == "full_cover":
        lengths = np.maximum(lengths, 12).astype(np.int32)
    tab = None if kmer == "none" else genome["ptab"]
    r, ln = torch.from_numpy(reads), torch.from_numpy(lengths)
    if P == 1:
        want = exact.exact_interval_search_plain(genome["fm"], r, ln, max_len, tab,
                                                 0 if tab is None else 4)
        want = tuple(w[:, None] for w in want)
        trip = exact._trip(reads.shape[1], max_len, tab, 0 if tab is None else 4)
    else:
        want = suffix_filter.piece_interval_search_plain(
            genome["fm"], r, ln, P, max_len, tab, 0 if tab is None else 4,
            kmer == "full_cover")[:2]
        trip = suffix_filter._piece_trip(reads.shape[1], P, max_len, tab,
                                         0 if tab is None else 4, kmer == "full_cover")
    got = models.backward_search(genome["fm"], reads, lengths, P, trip, tab,
                                 0 if tab is None else 4)
    _eq(want, got)


@pytest.mark.parametrize("kw", STAIRCASE_EDGES + [dict(k=1), dict(k=2, narrow_left=True)],
                         ids=lambda kw: "-".join(map(str, kw.values())))
def test_staircase_model_matches_plain(genome, kw):
    reads, lengths = models.edge_reads(genome["codes"], 7, B=10)
    kw = {key: v for key, v in kw.items() if key != "hits_per_state"}
    k = kw.pop("k")
    n_slots, keep = kw.get("n_slots", 16), kw.get("keep", 8)
    want = staircase.staircase_pools_plain(genome["bi"], torch.from_numpy(reads),
                                           torch.from_numpy(lengths), k, **kw)
    got = models.staircase_pools(genome["bi"], reads, lengths, k, n_slots, keep,
                                 *staircase._trip_counts(reads.shape[1], k, kw.get("max_len")),
                                 kw.get("narrow_left", False))
    _eq(want, got)


@pytest.mark.parametrize("n_slots", [1, 4, 48, 64, 65, 128])
def test_one_mismatch_model_matches_plain(genome, n_slots):
    reads, lengths = models.edge_reads(genome["codes"], 8, B=8, subs=1)
    want = one_mismatch.one_mismatch_candidates_plain(
        genome["bi"], torch.from_numpy(reads), torch.from_numpy(lengths), n_slots=n_slots)
    got = models.one_mismatch_candidates(genome["bi"], reads, lengths,
                                         one_mismatch._steps(reads.shape[1], None), n_slots)
    _eq(want, got)


def test_models_match_plain_where_spines_die_at_once(no_t_genome):
    g = no_t_genome
    reads, lengths = models.dying_reads(g["codes"], 9)
    r, ln = torch.from_numpy(reads), torch.from_numpy(lengths)
    _eq(staircase.staircase_pools_plain(g["bi"], r, ln, 2),
        models.staircase_pools(g["bi"], reads, lengths, 2, 16, 8,
                               *staircase._trip_counts(reads.shape[1], 2, None), False))
    _eq(one_mismatch.one_mismatch_candidates_plain(g["bi"], r, ln),
        models.one_mismatch_candidates(g["bi"], reads, lengths,
                                       one_mismatch._steps(reads.shape[1], None), 48))


_STAIR_GROUP_INPUTS = [
    ("edge", dict(k=2)), ("edge", dict(k=2, n_slots=1)), ("edge", dict(k=3, narrow_left=True)),
    ("edge", dict(k=2, n_slots=64, narrow_left=True, keep=3)),
    ("chains", dict(k=2, n_slots=17)), ("chains", dict(k=2, n_slots=33, narrow_left=True)),
    ("chains", dict(k=2, n_slots=96)), ("chains", dict(k=2, n_slots=128, narrow_left=True)),
]


def _stair_group_ids(v):
    return v if isinstance(v, (str, int)) else "-".join(map(str, v.values()))


def _stair_group_inputs(g, inputs, kw):
    reads, lengths = (models.edge_reads(g["codes"], 7, B=10) if inputs == "edge"
                      else models.chain_reads(g["codes"], 12, B=8))
    kw = dict(kw)
    return reads, lengths, kw.pop("k"), kw


@pytest.mark.parametrize("inputs, kw, lanes", [
    (inputs, kw, lanes) for inputs, kw in _STAIR_GROUP_INPUTS
    for lanes in ((32, 64) if kw.get("narrow_left") else (1, 2, 8, 32, 64))
], ids=_stair_group_ids)
def test_staircase_model_lane_groups_match_plain(genome, chains, lanes, inputs, kw):
    """The staircase model at other group sizes than the default's: one
    lane a pool (every step many passes), two, eight, a whole warp, and a
    warp taking two slots a lane (64 a pass); a narrowing pool only at a
    whole warp, where rank-major placement sees every parent in one
    pass."""
    g = genome if inputs == "edge" else chains
    reads, lengths, k, kw = _stair_group_inputs(g, inputs, kw)
    want = staircase.staircase_pools_plain(g["bi"], torch.from_numpy(reads),
                                           torch.from_numpy(lengths), k, **kw)
    trips = staircase._trip_counts(reads.shape[1], k, None)
    got = models.staircase_pools(g["bi"], reads, lengths, k, kw.get("n_slots", 16),
                                 kw.get("keep", 8), *trips, kw.get("narrow_left", False), lanes)
    _eq(want, got)


@pytest.mark.parametrize("inputs, kw, lanes", [
    (inputs, kw, lanes) for inputs, kw in _STAIR_GROUP_INPUTS if kw.get("narrow_left")
    for lanes in (1, 2, 8)
], ids=_stair_group_ids)
def test_staircase_model_refuses_narrowing_below_a_warp(genome, chains, lanes, inputs, kw):
    """Rank-major placement needs every parent of a step in one pass, so
    the model, like the kernel's entry, takes a narrowing pool only as a
    whole warp."""
    g = genome if inputs == "edge" else chains
    reads, lengths, k, kw = _stair_group_inputs(g, inputs, kw)
    with pytest.raises(ValueError, match="whole warp"):
        models.staircase_pools(g["bi"], reads, lengths, k, kw.get("n_slots", 16),
                               kw.get("keep", 8), *staircase._trip_counts(reads.shape[1], k, None),
                               True, lanes)


@pytest.mark.parametrize("lanes", [1, 2, 4, 32])
@pytest.mark.parametrize("inputs, n_slots", [("edge", 48), ("edge", 3), ("chains", 48),
                                             ("chains", 9)])
def test_one_mismatch_model_lane_groups_match_plain(genome, chains, lanes, inputs, n_slots):
    """The one-mismatch model at other group sizes than the default's,
    also on reads with many dead chains (several chunks of them a step)."""
    g = genome if inputs == "edge" else chains
    reads, lengths = (models.edge_reads(g["codes"], 8, B=8, subs=1) if inputs == "edge"
                      else models.chain_reads(g["codes"], 13))
    want = one_mismatch.one_mismatch_candidates_plain(
        g["bi"], torch.from_numpy(reads), torch.from_numpy(lengths), n_slots=n_slots)
    got = models.one_mismatch_candidates(g["bi"], reads, lengths,
                                         one_mismatch._steps(reads.shape[1], None), n_slots, lanes)
    _eq(want, got)


# ------------------------------------------------ what the one-mismatch kernel rests on

@pytest.fixture(scope="module")
def slot_updates(genome, no_t_genome, chains):
    """(impl, inputs) -> (every (B, S) slot update of the one-mismatch
    search as (forward, old lo, old hi, new lo, new hi) numpy arrays, the
    outputs), for the plain loop ("plain") or the JAX function ("jax", run
    eagerly under ``jax.disable_jit`` so that its loop's steps are seen),
    with each package's ``extend_forward`` and ``extend_backward`` spied.
    Both run ceil(L / 2) steps, after which every lane is inactive."""
    inputs = {"edge": (genome, lambda c: models.edge_reads(c, 14, B=8, subs=1)),
              "dying": (no_t_genome, lambda c: models.dying_reads(c, 15)),
              "chains": (chains, lambda c: models.chain_reads(c, 16, B=8))}
    done = {}

    def record(impl, name):
        if (impl, name) in done:
            return done[impl, name]
        g, make = inputs[name]
        reads, lengths = make(g["codes"])
        max_len = (reads.shape[1] + 1) // 2
        mod = bd if impl == "plain" else j_bd
        rec = []
        with pytest.MonkeyPatch.context() as mp:
            for fn, forward in (("extend_forward", True), ("extend_backward", False)):
                def spy(bi, st, c, real=getattr(mod, fn), forward=forward):
                    new = real(bi, st, c)
                    if st.lo.ndim == 2:
                        rec.append((forward, *(np.asarray(x) for x in (st.lo, st.hi, new.lo,
                                                                       new.hi))))
                    return new
                mp.setattr(mod, fn, spy)
            if impl == "plain":
                out = one_mismatch.one_mismatch_candidates_plain(
                    g["bi"], torch.from_numpy(reads), torch.from_numpy(lengths), max_len)
            else:
                with jax.disable_jit():
                    out = j_one_mismatch.one_mismatch_candidates(
                        g["jbi"], jnp.asarray(reads), jnp.asarray(lengths), max_len)
        assert len(rec) == 2 * max_len  # every step of both cases
        done[impl, name] = rec, [np.asarray(o) for o in out]
        return done[impl, name]

    return record


@pytest.mark.parametrize("impl", ["plain", "jax"])
@pytest.mark.parametrize("inputs", ["edge", "dying", "chains"])
def test_one_mismatch_dead_slots_have_lo_equal_hi(slot_updates, impl, inputs):
    rec, (cand_lo, cand_hi, _) = slot_updates(impl, inputs)
    n_dead = 0
    for _, lo, hi, _, _ in rec:
        dead = hi <= lo
        assert np.array_equal(lo[dead], hi[dead])
        n_dead += int(dead.sum())
    dead = cand_hi <= cand_lo  # and after the last step
    assert np.array_equal(cand_lo[dead], cand_hi[dead])
    assert n_dead > 0


@pytest.mark.parametrize("impl", ["plain", "jax"])
@pytest.mark.parametrize("inputs", ["edge", "dying", "chains"])
def test_one_mismatch_case_a_dead_slots_keep_their_interval(slot_updates, impl, inputs):
    rec, _ = slot_updates(impl, inputs)
    n_dead = 0
    for forward, lo, hi, new_lo, new_hi in rec:
        if forward:
            dead = hi <= lo
            assert np.array_equal(new_lo[dead], lo[dead]) and np.array_equal(new_hi[dead], hi[dead])
            n_dead += int(dead.sum())
    assert n_dead > 0


@pytest.mark.parametrize("impl", ["plain", "jax"])
@pytest.mark.parametrize("inputs", ["edge", "chains"])
def test_one_mismatch_case_b_dead_slots_of_one_lo_stay_equal(slot_updates, impl, inputs):
    """Case B moves every dead slot of one lo to one new lo (= hi); on the
    repeat genome a read holds five or more distinct dead lo values."""
    rec, _ = slot_updates(impl, inputs)
    most = 0
    for forward, lo, hi, new_lo, new_hi in rec:
        if forward:
            continue
        for b in range(lo.shape[0]):
            dead = hi[b] <= lo[b]
            values = np.unique(lo[b][dead])
            most = max(most, values.size)
            for v in values:
                moved = dead & (lo[b] == v)
                assert np.unique(new_lo[b][moved]).size == 1
                assert np.array_equal(new_lo[b][moved], new_hi[b][moved])
    assert most >= (5 if inputs == "chains" else 1)


# ---------------------------------------------------------------- bindings and dispatch

def test_bindings_refuse_what_the_kernels_cannot_take(genome):
    bi, fm = genome["bi"], genome["fm"]
    r = torch.zeros((4, 20), dtype=torch.int32)
    ln = torch.full((4,), 20, dtype=torch.int32)
    bad = [
        (lambda: fm_search_cuda.backward_search_cuda(fm, r, ln, 0, 5), "n_pieces=0"),
        (lambda: fm_search_cuda.backward_search_cuda(fm, r, ln, 33, 5), "n_pieces=33"),
        (lambda: fm_search_cuda.backward_search_cuda(fm, r, ln, 1, 5, genome["ptab"], 16),
         "kmer_j=16"),
        (lambda: fm_search_cuda.backward_search_cuda(fm, r.long(), ln, 1, 5), "int32"),
        (lambda: fm_search_cuda.backward_search_cuda(fm, r.t().contiguous().t(), ln, 1, 5),
         "contiguous"),
        (lambda: fm_search_cuda.backward_search_cuda(fm, r, ln[:3], 1, 5), "shape"),
        (lambda: fm_search_cuda.backward_search_cuda(
            fm, torch.zeros((1, 1 << 26), dtype=torch.int32), ln[:1], 1, 5), "int32"),
        (lambda: fm_search_cuda.backward_search_cuda(fm, r, ln, 1, 5), "CUDA device"),
        (lambda: staircase_cuda.staircase_pools_cuda(bi, r, ln, 2, 0, 8, 1, 1, 1, False),
         "n_slots=0"),
        (lambda: staircase_cuda.staircase_pools_cuda(bi, r, ln, 2, 65, 8, 1, 1, 1, False),
         "CUDA device"),  # 65 slots taken: only the CPU tensors refused
        (lambda: staircase_cuda.staircase_pools_cuda(bi, r, ln, 32, 16, 8, 1, 1, 1, False),
         "k=32"),
        (lambda: staircase_cuda.staircase_pools_cuda(bi, r, ln, 2, 16, -1, 1, 1, 1, False),
         "keep=-1"),
        (lambda: staircase_cuda.staircase_pools_cuda(bi, r.short(), ln, 2, 16, 8, 1, 1, 1,
                                                     False), "int32"),
        (lambda: staircase_cuda.staircase_pools_cuda(bi, r, ln, 2, 16, 8, 1, 1, 1, False),
         "CUDA device"),
        (lambda: one_mismatch_cuda.one_mismatch_candidates_cuda(bi, r, ln, 5, 0), "n_slots=0"),
        (lambda: one_mismatch_cuda.one_mismatch_candidates_cuda(bi, r, ln, 5, 65),
         "CUDA device"),  # 65 slots taken: only the CPU tensors refused
        (lambda: one_mismatch_cuda.one_mismatch_candidates_cuda(bi, r, ln.long(), 5, 48),
         "int32"),
        (lambda: one_mismatch_cuda.one_mismatch_candidates_cuda(bi, r, ln, 5, 48),
         "CUDA device"),
    ]
    for call, match in bad:
        with pytest.raises(ValueError, match=match):
            call()


def _flag_wait_case(case: str):
    """One refusal of the flag-wait binding (CPU tensors: each check comes
    before the device's) -> (call, match)."""
    from genome_weaver_align_tpu_torch.ops import ring_cuda

    P, n, W = 2, 8, ring_cuda.WAIT_BLOCKS

    def zeros(*shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype)

    inboxes = [zeros(P, 2, n) for _ in range(P)]
    flags = [zeros(P, W) for _ in range(P)]
    err = zeros(1)
    wait = ring_cuda.ring_allreduce_wait_cuda
    misaligned = zeros(P * 2 * n + 1)[1:].view(P, 2, n)
    return {
        "rank past the ranks": (lambda: wait(inboxes, flags, P, 1, err), f"rank {P} of {P}"),
        "negative rank": (lambda: wait(inboxes, flags, -1, 1, err), f"rank -1 of {P}"),
        # 17 ranks are taken (past 16 the kernel reads the addresses from a
        # device table): only the CPU tensors are refused
        "17 ranks": (lambda: wait([zeros(17, 4)] * 17, [zeros(17, W)] * 17, 0, 1, err),
                     "CUDA device"),
        "epoch 0": (lambda: wait(inboxes, flags, 0, 0, err), "epoch 0"),
        "epoch at the poison": (lambda: wait(inboxes, flags, 0, ring_cuda.POISON, err),
                                f"epoch {ring_cuda.POISON}"),
        "an inbox of other ranks": (lambda: wait([zeros(3, 2, n)] * P, flags, 0, 1, err),
                                    r"\(2, \.\.\.\)"),
        "inboxes of two shapes": (lambda: wait([inboxes[0], zeros(P, 2, n + 4)], flags, 0, 1,
                                               err), "inboxes of shape"),
        "one inbox short": (lambda: wait(inboxes[:1], flags, 0, 1, err), "inboxes of shape"),
        "flags of another width": (lambda: wait(inboxes, [zeros(P, W // 2)] * P, 0, 1, err),
                                   f"\\({P}, {W}\\) int32"),
        "two error words": (lambda: wait(inboxes, flags, 0, 1, zeros(2)), "error word"),
        "int64 inboxes": (lambda: wait([zeros(P, 2, n, dtype=torch.int64)] * P, flags, 0, 1,
                                       err), "int32 or float32"),
        "a strided inbox": (lambda: wait([zeros(P, 2, 2 * n)[:, :, ::2]] * P, flags, 0, 1,
                                         err), "contiguous"),
        "a misaligned inbox": (lambda: wait([inboxes[0], misaligned], flags, 0, 1, err),
                               "16-byte aligned"),
        "CPU tensors": (lambda: wait(inboxes, flags, 0, 1, err), "CUDA device"),
    }[case]


@pytest.mark.parametrize("case", [
    "rank past the ranks", "negative rank", "17 ranks", "epoch 0", "epoch at the poison",
    "an inbox of other ranks", "inboxes of two shapes", "one inbox short",
    "flags of another width", "two error words", "int64 inboxes", "a strided inbox",
    "a misaligned inbox", "CPU tensors"])
def test_flag_wait_binding_refuses_what_the_kernel_cannot_take(case):
    """The ring merge's flag-wait binding (``ring_cuda.FlagWait``, one
    merge by ``ring_allreduce_wait_cuda``) refuses, before any launch,
    what its kernel cannot take: a rank or an epoch out of range, inboxes
    that are not one ``(ranks, ...)`` tensor a rank, flag words that are
    not ``(ranks, WAIT_BLOCKS)``, another type, a strided or misaligned
    tensor, a tensor off the card."""
    call, match = _flag_wait_case(case)
    with pytest.raises((ValueError, TypeError), match=match):
        call()


@pytest.mark.parametrize("groups, least, most, want", [
    (0, 1, 16, 16), (100, 1, 16, 16), (150, 1, 16, 8), (400, 1, 16, 4), (3_200, 1, 16, 1),
    (1_000, 2, 32, 2), (40, 2, 32, 32)])
def test_group_lanes_shrink_as_the_groups_outgrow_the_card(monkeypatch, groups, least, most,
                                                           want):
    """The most lanes a group, a power of two from ``least`` to ``most``,
    that keep the launch within its lanes an SM (here 800 on 2 SMs)."""
    monkeypatch.setattr(fm_search_cuda, "LANES_AN_SM", 800)
    assert fm_search_cuda.group_lanes(groups, least, most, 2) == want


@pytest.mark.parametrize("n_slots, narrow, most", [
    (1, False, 1), (16, False, 16), (17, False, 32), (64, False, 32), (2, True, 32),
    (64, True, 32)])
@pytest.mark.parametrize("pools", [768, 6_144, 98_304])
def test_lane_choices_of_the_bindings(monkeypatch, pools, n_slots, narrow, most):
    """The staircase binding takes a whole warp for a narrowing pool and
    otherwise at most a pass over a pool's slots; the one-mismatch binding
    shares the same rule between its own limits."""
    dev = torch.device("cuda", 0)
    for binding in (staircase_cuda, one_mismatch_cuda):
        monkeypatch.setattr(binding, "sm_count", lambda d: 132)
    want = 32 if narrow else fm_search_cuda.group_lanes(pools, 1, most, 132)
    assert staircase_cuda.lanes_for(pools, n_slots, narrow, dev) == want
    assert one_mismatch_cuda.lanes_for(pools, dev) == fm_search_cuda.group_lanes(
        2 * pools, one_mismatch_cuda.LEAST, one_mismatch_cuda.MOST, 132)


def test_cpu_tensors_take_the_plain_loops(genome, monkeypatch):
    """On the CPU each search function runs its plain loop: the kernels'
    wrappers are never called and their counts stay."""
    def refuse(*a, **k):
        raise AssertionError("a CPU tensor reached a CUDA kernel wrapper")

    for mod, fn in ((fm_search_cuda, "backward_search_cuda"),
                    (staircase_cuda, "staircase_pools_cuda"),
                    (one_mismatch_cuda, "one_mismatch_candidates_cuda")):
        monkeypatch.setattr(mod, fn, refuse)
    reads, lengths = models.edge_reads(genome["codes"], 10, B=6)
    r, ln = torch.from_numpy(reads), torch.from_numpy(lengths)
    _eq(exact.exact_interval_search(genome["fm"], r, ln),
        exact.exact_interval_search_plain(genome["fm"], r, ln))
    _eq(suffix_filter.piece_interval_search(genome["fm"], r, ln, 3),
        suffix_filter.piece_interval_search_plain(genome["fm"], r, ln, 3))
    _eq(staircase.staircase_pools(genome["bi"], r, ln, 2),
        staircase.staircase_pools_plain(genome["bi"], r, ln, 2))
    _eq(one_mismatch.one_mismatch_candidates(genome["bi"], r, ln),
        one_mismatch.one_mismatch_candidates_plain(genome["bi"], r, ln))


def test_plain_loops_advance_every_step_through_step_where(genome, monkeypatch):
    """Each plain loop advances its lanes once a sequential step through
    ``rank.step_where``, where the smoke counts the live extensions its
    bounds charge (active lanes with a non-empty interval).  Counting there
    changes no output; for the exact search the count equals, step by step,
    the reads still alive in searches cut at ``max_len`` = t."""
    reads, lengths = models.edge_reads(genome["codes"], 11, B=8)
    r, ln = torch.from_numpy(reads), torch.from_numpy(lengths)
    L = r.shape[1]
    fm, bi = genome["fm"], genome["bi"]
    cases = ((exact.exact_interval_search_plain, (fm, r, ln), L),
             (suffix_filter.piece_interval_search_plain, (fm, r, ln, 3),
              suffix_filter._piece_trip(L, 3, None, None, 0, False)),
             (staircase.staircase_pools_plain, (bi, r, ln, 2),
              sum(staircase._trip_counts(L, 2, None)[:2])),
             (staircase.staircase_pools_plain, (bi, r, ln, 2, 16, 8, None, True),
              sum(staircase._trip_counts(L, 2, None))),
             (one_mismatch.one_mismatch_candidates_plain, (bi, r, ln),
              6 * one_mismatch._steps(L, None)))  # 2 spines, 2 searches of 2 updates
    want = [plain(*args) for plain, args, _ in cases]
    alive = []
    for t in range(L):
        lo, hi = exact.exact_interval_search_plain(fm, r, ln, max_len=t)
        alive.append(int(((t < ln) & (hi > lo)).sum()))
    real, live = rank.step_where, []

    def counting(active, new, old):
        live.append(int((active & (old[1] > old[0])).sum()))
        return real(active, new, old)

    monkeypatch.setattr(rank, "step_where", counting)
    for (plain, args, n_updates), w in zip(cases, want):
        live.clear()
        _eq(plain(*args), w)
        assert len(live) == n_updates and live[0] > 0
        if plain is exact.exact_interval_search_plain:
            assert live == alive


def test_index_upload_names_its_device(genome):
    """``from_host`` and ``from_arrays`` have no default device: a caller
    that leaves it out is refused, not given the CPU."""
    fm = genome["fwd"]
    with pytest.raises(TypeError):
        rank.from_host(fm)
    marks = fm.ssa_marks
    args = (rank.fuse_blocks(fm.bwt_words, fm.occ_cp), fm.C, fm.primary,
            marks._wpad.reshape(-1, rank.MARK_WORDS_PER_BLOCK), marks.checkpoints,
            fm.ssa_values, fm.n, fm.sample_rate)
    with pytest.raises(TypeError):
        rank.from_arrays(*args)
    assert rank.from_arrays(*args, device="cpu").blocks.device == CPU


@pytest.mark.parametrize("narrow", [False, True])
def test_wide_staircase_steps_take_several_passes(chains, narrow):
    """At 128 slots the chains genome's pools fill (overflow), so a warp's
    steps run several passes of 64 parents, and a narrowing step two
    rounds of them: the model equals the plain loop, and the plain loop the
    JAX search."""
    g = chains
    reads, lengths = models.chain_reads(g["codes"], 12, B=8)
    r, ln = torch.from_numpy(reads), torch.from_numpy(lengths)
    want = staircase.staircase_pools_plain(g["bi"], r, ln, 2, n_slots=128, narrow_left=narrow)
    assert bool(want[2].any())  # some pool held more than 128 live slots
    trips = staircase._trip_counts(reads.shape[1], 2, None)
    _eq(want, models.staircase_pools(g["bi"], reads, lengths, 2, 128, 8, *trips, narrow))
    _eq(staircase.staircase_filter_candidates(g["bi"], r, ln, 2, n_slots=128,
                                              narrow_left=narrow),
        j_staircase.staircase_filter_candidates(g["jbi"], jnp.asarray(reads),
                                                jnp.asarray(lengths), 2, n_slots=128,
                                                narrow_left=narrow))
