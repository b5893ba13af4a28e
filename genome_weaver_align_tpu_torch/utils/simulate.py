"""Synthetic genome + read simulator (test/bench data; no network in env).

BASELINE.json names real datasets only by *scale* (E. coli 4.6 Mbp, chr20
~64 Mbp, chr1 ~230 Mbp); synthetic sequences of those sizes exercise the same
code paths.  Reads carry their true locus in the name for accuracy checks.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import dna
from .fasta import Read

E_COLI_LEN = 4_641_652
CHR20_LEN = 64_444_167
CHR1_LEN = 230_481_012


def random_genome(n: int, seed: int = 0, gc: float = 0.5) -> np.ndarray:
    rng = np.random.default_rng(seed)
    p_at = (1.0 - gc) / 2
    p_gc = gc / 2
    return rng.choice(4, size=n, p=[p_at, p_gc, p_gc, p_at]).astype(np.uint8)


def repeat_genome(
    n: int,
    seed: int = 0,
    interspersed_frac: float = 0.25,
    tandem_frac: float = 0.05,
    divergence: float = 0.05,
    n_families: int = 8,
) -> np.ndarray:
    """Repeat-rich synthetic genome (VERDICT r1 weak-#3: random DNA makes the
    seed table nearly collision-free, so candidate budgets and the overflow
    paths are barely stressed).

    Structure mimics a human chromosome's repeat landscape:
    - *interspersed* repeats: ``n_families`` SINE/LINE-like units (150-450 bp)
      pasted as mutated copies (``divergence`` per-base substitution rate)
      until ~``interspersed_frac`` of the genome is covered — the Alu-style
      many-near-identical-loci case that floods per-piece hit budgets;
    - *tandem* repeats: satellite-like arrays (unit 10-200 bp tiled to
      0.5-5 kb) covering ~``tandem_frac`` — the worst case for seed
      multiplicity within one locus.
    """
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, size=n, dtype=np.uint8)

    fams = [
        rng.integers(0, 4, size=int(rng.integers(150, 451)), dtype=np.uint8)
        for _ in range(n_families)
    ]
    covered = 0
    target = int(n * interspersed_frac)
    while covered < target:
        fam = fams[int(rng.integers(0, n_families))]
        u = fam.size
        copy = fam.copy()
        mut = rng.random(u) < divergence
        copy[mut] = (copy[mut] + rng.integers(1, 4, size=int(mut.sum()))) % 4
        at = int(rng.integers(0, n - u))
        g[at : at + u] = copy
        covered += u

    covered = 0
    target = int(n * tandem_frac)
    while covered < target:
        u = int(rng.integers(10, 201))
        span = int(rng.integers(500, 5001))
        unit = rng.integers(0, 4, size=u, dtype=np.uint8)
        at = int(rng.integers(0, n - span))
        reps = -(-span // u)
        g[at : at + span] = np.tile(unit, reps)[:span]
        covered += span
    return g


@dataclass
class SimRead:
    read: Read
    true_pos: int
    true_strand: int  # 0 fwd, 1 rev
    n_sub: int
    n_ins: int
    n_del: int


def simulate_reads(
    genome: np.ndarray,
    n_reads: int,
    read_len: int,
    seed: int = 1,
    sub_rate: float = 0.0,
    max_subs: int | None = None,
    indel_rate: float = 0.0,
    max_indels: int = 0,
) -> list[SimRead]:
    """Sample reads uniformly from both strands with planted errors.

    ``max_subs``/``max_indels`` cap the per-read error count so acceptance
    configs ("1-mismatch", "edit distance <= 4") can be generated exactly.
    """
    rng = np.random.default_rng(seed)
    n = genome.size
    out: list[SimRead] = []
    for ridx in range(n_reads):
        # leave indel slack at the template edge
        pos = int(rng.integers(0, n - read_len - max_indels - 1))
        strand = int(rng.integers(0, 2))
        n_sub = _count(rng, read_len, sub_rate, max_subs)
        n_indel = _count(rng, read_len, indel_rate, max_indels)
        tmpl = genome[pos : pos + read_len + max_indels].copy()

        n_ins = n_del = 0
        seq = tmpl[:read_len].copy()
        if n_indel:
            seq = tmpl.copy()
            for _ in range(n_indel):
                at = int(rng.integers(1, read_len - 1))
                if rng.integers(0, 2):  # deletion from the template
                    seq = np.delete(seq, at)
                    n_del += 1
                else:  # insertion of a random base into the read
                    seq = np.insert(seq, at, rng.integers(0, 4))
                    n_ins += 1
            seq = seq[:read_len]
        for _ in range(n_sub):
            at = int(rng.integers(0, read_len))
            seq[at] = (seq[at] + 1 + rng.integers(0, 3)) % 4
        if strand:
            seq = dna.revcomp(seq)
        name = f"r{ridx}_p{pos}_s{strand}_m{n_sub}_i{n_ins}_d{n_del}"
        out.append(
            SimRead(
                Read(name, seq.astype(np.uint8), None),
                pos,
                strand,
                n_sub,
                n_ins,
                n_del,
            )
        )
    return out


def simulate_reads_array(
    genome: np.ndarray,
    n_reads: int,
    read_len: int,
    seed: int = 1,
    max_subs: int = 2,
    indel_frac: float = 0.0,
):
    """Vectorised bench-scale simulator (millions of reads in ms, no Python
    per-read loop): uniform loci, both strands, 0..max_subs substitutions,
    and at most ONE indel (insertion or deletion) in ``indel_frac`` of reads.

    Returns (reads (B, L) uint8, true_pos (B,), strand (B,), has_indel (B,)).
    An indel inside the read does not move its genome start, so true_pos
    stays exact for accuracy checks.
    """
    rng = np.random.default_rng(seed)
    B, L = n_reads, read_len
    pos = rng.integers(0, genome.size - L - 1, size=B)
    tmpl = genome[pos[:, None] + np.arange(L + 1)[None, :]].astype(np.uint8)

    idx = np.broadcast_to(np.arange(L)[None, :], (B, L)).copy()
    has_indel = rng.random(B) < indel_frac
    at = rng.integers(1, L - 1, size=B)
    is_del = rng.integers(0, 2, size=B).astype(bool) & has_indel
    is_ins = has_indel & ~is_del
    # deletion at `at`: skip template base at that offset
    idx = idx + (is_del[:, None] & (idx >= at[:, None]))
    # insertion at `at`: shift the tail right, splice a random base in
    ins_shift = is_ins[:, None] & (idx > at[:, None])
    reads = np.take_along_axis(tmpl, idx - ins_shift, axis=1)
    ins_base = rng.integers(0, 4, size=B, dtype=np.uint8)
    at_mask = is_ins[:, None] & (np.arange(L)[None, :] == at[:, None])
    reads = np.where(at_mask, ins_base[:, None], reads)

    n_sub = rng.integers(0, max_subs + 1, size=B)
    for srow in range(1, max_subs + 1):
        sel = np.nonzero(n_sub >= srow)[0]
        sat = rng.integers(0, L, size=B)
        delta = rng.integers(1, 4, size=B).astype(np.uint8)
        reads[sel, sat[sel]] = (reads[sel, sat[sel]] + delta[sel]) % 4

    strand = rng.integers(0, 2, size=B)
    rc = (3 - reads)[:, ::-1]
    reads = np.where(strand[:, None] == 1, rc, reads)
    return reads, pos, strand, has_indel


def _count(rng, read_len: int, rate: float, cap: int | None) -> int:
    if rate <= 0:
        return 0
    c = int(rng.binomial(read_len, rate))
    return min(c, cap) if cap is not None else c


def reads_to_batch(reads: list[Read], pad_to: int | None = None) -> np.ndarray:
    """Stack equal-length reads into a (B, L) uint8 batch (N -> code 0)."""
    L = max(len(r) for r in reads)
    if pad_to is not None:
        L = max(L, pad_to)
    out = np.zeros((len(reads), L), dtype=np.uint8)
    for i, r in enumerate(reads):
        c = np.where(r.codes >= 4, 0, r.codes)
        out[i, : len(r)] = c
    return out


@dataclass
class SimPair:
    r1: SimRead
    r2: SimRead
    fragment_start: int
    fragment_len: int


def simulate_pairs(
    genome: np.ndarray,
    n_pairs: int,
    read_len: int,
    seed: int = 1,
    insert_mean: int = 350,
    insert_sd: int = 30,
    sub_rate: float = 0.0,
    max_subs: int | None = None,
) -> list[SimPair]:
    """FR-oriented pairs: R1 = fragment start (fwd), R2 = fragment end (rc)."""
    rng = np.random.default_rng(seed)
    n = genome.size
    out: list[SimPair] = []
    for pidx in range(n_pairs):
        frag = int(np.clip(rng.normal(insert_mean, insert_sd), 2 * read_len, None))
        pos = int(rng.integers(0, n - frag - 1))
        segs = []
        for mate, (p, strand) in enumerate(
            [(pos, 0), (pos + frag - read_len, 1)]
        ):
            seq = genome[p : p + read_len].copy()
            n_sub = _count(rng, read_len, sub_rate, max_subs)
            for _ in range(n_sub):
                at = int(rng.integers(0, read_len))
                seq[at] = (seq[at] + 1 + rng.integers(0, 3)) % 4
            if strand:
                seq = dna.revcomp(seq)
            name = f"p{pidx}"
            segs.append(
                SimRead(Read(name, seq.astype(np.uint8), None), p, strand, n_sub, 0, 0)
            )
        out.append(SimPair(segs[0], segs[1], pos, frag))
    return out
