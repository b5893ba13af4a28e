"""Scalar models of the port's FM search kernels, in the kernels' own loop
order, for the CPU tests (no card here runs the CUDA code).

Each model follows its CUDA source step for step: ``csrc/fm_occ.cuh``'s
row split and three-popcount count (code 0 as r less the other three),
``csrc/fm_search.cu``'s one lane at a time with its early exit,
``csrc/staircase.cu``'s one pool at a time with lane l holding slots l and
l + 32 and ballot-and-prefix compaction, and ``csrc/one_mismatch.cu``'s
one read at a time with its stable partition and spawns in code order.
The tests hold each model against the plain torch version on every
output, so the formulation the CUDA code follows is checked on the CPU.
The genome and read generators at the end are the edge-case inputs of both
the CPU tests and the card tests.
"""

from __future__ import annotations

import numpy as np

M32 = 0xFFFFFFFF
LANES = 32


class Table:
    """One DeviceFMIndex's fused rows, C and primary, as host values."""

    def __init__(self, fm):
        self.words = fm.blocks.cpu().numpy().view(np.uint32)
        self.cp = fm.blocks.cpu().numpy()[:, 8:]
        self.C = [int(x) for x in fm.C.cpu().numpy()[:4]]
        self.primary = int(fm.primary)
        self.n = int(fm.n)

    def row(self, k):
        k_adj = k - (1 if k > self.primary else 0)
        return k_adj >> 7, k_adj & 127


def _slot_mask(r, j):
    allowed = min(max(r - 16 * j, 0), 16)
    return (M32 if allowed >= 16 else (1 << (2 * allowed)) - 1) & 0x55555555


def occ4(t: Table, k):
    b, r = t.row(k)
    c1 = c2 = c3 = 0
    for j in range(8):
        w, m = int(t.words[b, j]), _slot_mask(r, j)
        lo, hi = w & m, (w >> 1) & m
        c1 += bin(lo & ~hi & M32).count("1")
        c2 += bin(hi & ~lo & M32).count("1")
        c3 += bin(lo & hi).count("1")
    cp = [int(x) for x in t.cp[b]]
    return [cp[0] + r - (c1 + c2 + c3), cp[1] + c1, cp[2] + c2, cp[3] + c3]


def occ1(t: Table, k, c):
    b, r = t.row(k)
    pattern = (c * 0x55555555) & M32
    n = 0
    for j in range(8):
        x = int(t.words[b, j]) ^ pattern
        n += bin(~(x | (x >> 1)) & _slot_mask(r, j) & M32).count("1")
    return int(t.cp[b, c]) + n


def children(t: Table, mlo, mhi, olo):
    """All four children on table t: lists (mlo, mhi, olo, ohi) by code."""
    a, b = occ4(t, mlo), occ4(t, mhi)
    s = 1 if mlo <= t.primary < mhi else 0
    out, below = [], 0
    for c in range(4):
        cnt = b[c] - a[c]
        m = t.C[c] + a[c]
        o = olo + s + below
        out.append((m, m + cnt, o, o + cnt))
        below += cnt
    return out


def bi_children(fwd, rev, forward, v):
    """Children of v = (lo, hi, rlo, rhi) as the same 4-tuples, by code."""
    lo, hi, rlo, rhi = v
    if forward:
        return [(o, oh, m, mh) for m, mh, o, oh in children(rev, rlo, rhi, lo)]
    return [(m, mh, o, oh) for m, mh, o, oh in children(fwd, lo, hi, rlo)]


def code_at(read, L, j):
    return int(read[min(max(j, 0), L - 1)]) & 3 if L > 0 else 0


# ---------------------------------------------------------------- fm_search.cu

def backward_search(fm, reads, lengths, n_pieces, trip, kmer_tab=None, kmer_j=0):
    """(lo, hi) (B, P) int32, lane by lane."""
    t = Table(fm)
    B, L = reads.shape
    P = n_pieces
    lo_out = np.zeros((B, P), np.int32)
    hi_out = np.zeros((B, P), np.int32)
    tab = None if kmer_tab is None or kmer_j <= 0 else [np.asarray(x) for x in kmer_tab]
    for b in range(B):
        ln = int(lengths[b])
        for p in range(P):
            start, end = ln * p // P, ln * (p + 1) // P
            lo, hi, skip = 0, t.n + 1, 0
            if tab is not None and end - start >= kmer_j:
                idx = 0
                for u in range(kmer_j):
                    idx = (idx << 2) | code_at(reads[b], L, end - kmer_j + u)
                idx = min(max(idx, 0), tab[0].shape[0] - 1)
                lo, hi, skip = int(tab[0][idx]), int(tab[1][idx]), kmer_j
            for s in range(trip):
                j = end - 1 - skip - s
                if j < start or lo >= hi:
                    break
                c = code_at(reads[b], L, j)
                lo, hi = t.C[c] + occ1(t, lo, c), t.C[c] + occ1(t, hi, c)
            lo_out[b, p], hi_out[b, p] = lo, hi
    return lo_out, hi_out


# ---------------------------------------------------------------- staircase.cu

def _expand_step(pool, n_slots, fwd, rev, forward, c, budget, rank_major):
    """One all-4 expansion of the pool's live slots and the warp's
    ballot compaction; returns the kept count."""
    lane_state = []
    for lane in range(LANES):
        halves = []
        for h in range(2):
            s = lane + 32 * h
            live = s < n_slots and pool["hi"][s] > pool["lo"][s]
            v = tuple(pool[f][s] for f in ("lo", "hi", "rlo", "rhi")) if live else (0, 0, 0, 0)
            mm = pool["mm"][s] if live else 0
            ch = bi_children(fwd, rev, forward, v) if live else [(0, 0, 0, 0)] * 4
            keep = 0
            for a in range(4):
                ok = mm + (a != c) <= budget and ch[a][1] > ch[a][0]
                keep |= (1 if live and ok else 0) << a
            halves.append((ch, mm, keep))
        lane_state.append(halves)

    def write(dest, ch, mm):
        if dest < n_slots:
            for f, x in zip(("lo", "hi", "rlo", "rhi", "mm"), (*ch, mm)):
                pool[f][dest] = x

    base = 0
    if rank_major:
        for r in range(4):
            a = c if r == 0 else (r - 1) + (1 if r - 1 >= c else 0)
            for h in range(2):
                ballot = [(lane_state[lane][h][2] >> a) & 1 for lane in range(LANES)]
                for lane in range(LANES):
                    if ballot[lane]:
                        ch, mm, _ = lane_state[lane][h]
                        write(base + sum(ballot[:lane]), ch[a], mm + (a != c))
                base += sum(ballot)
    else:
        for h in range(2):
            counts = [bin(lane_state[lane][h][2]).count("1") for lane in range(LANES)]
            for lane in range(LANES):
                ch, mm, keep = lane_state[lane][h]
                dest = base + sum(counts[:lane])  # the three ballots' prefix
                for a in range(4):
                    if (keep >> a) & 1:
                        write(dest, ch[a], mm + (a != c))
                        dest += 1
            base += sum(counts)
    for s in range(base, n_slots):
        for f in pool:
            pool[f][s] = 0
    return base


def staircase_pools(bi, reads, lengths, k, n_slots, keep, spine_steps, fwd_steps, bwd_steps,
                    narrow_left):
    """(lo, hi) (P, B, keep) int32 and overflow (P, B) bool, pool by pool."""
    fwd, rev = Table(bi.fwd), Table(bi.rev)
    B, L = reads.shape
    P = k + 1
    out_lo = np.zeros((P, B, keep), np.int32)
    out_hi = np.zeros((P, B, keep), np.int32)
    out_ovf = np.zeros((P, B), bool)
    for p in range(P):
        for b in range(B):
            ln = int(lengths[b])
            s_p, e_p = ln * p // P, ln * (p + 1) // P
            read = reads[b]
            spine = (0, fwd.n + 1, 0, fwd.n + 1)
            for t in range(spine_steps):
                j = e_p - 1 - t
                if j < s_p or spine[1] <= spine[0]:
                    break
                spine = bi_children(fwd, rev, False, spine)[code_at(read, L, j)]
            pool = {f: [0] * n_slots for f in ("lo", "hi", "rlo", "rhi", "mm")}
            for f, x in zip(("lo", "hi", "rlo", "rhi"), spine):
                pool[f][0] = x
            overflow = False
            empty = spine[1] <= spine[0]
            for t in range(fwd_steps):
                j = e_p + t
                if empty or j >= ln:
                    break
                piece_of_j = sum(1 for i in range(P + 1) if ln * i // P <= j) - 1
                live = _expand_step(pool, n_slots, fwd, rev, True, code_at(read, L, j),
                                    piece_of_j - p, narrow_left)
                overflow |= live > n_slots
                empty = live == 0
            if narrow_left:
                for t in range(bwd_steps):
                    j = s_p - 1 - t
                    if empty or j < 0:
                        break
                    live = _expand_step(pool, n_slots, fwd, rev, False, code_at(read, L, j), k,
                                        True)
                    overflow |= live > n_slots
                    empty = live == 0
            base = 0
            for h in range(2):
                ballot = [lane + 32 * h < n_slots
                          and pool["hi"][lane + 32 * h] > pool["lo"][lane + 32 * h]
                          for lane in range(LANES)]
                for lane in range(LANES):
                    dest = base + sum(ballot[:lane])
                    if ballot[lane] and dest < keep:
                        out_lo[p, b, dest] = pool["lo"][lane + 32 * h]
                        out_hi[p, b, dest] = pool["hi"][lane + 32 * h]
                base += sum(ballot)
            out_ovf[p, b] = overflow or base > keep
    return out_lo, out_hi, out_ovf


# ---------------------------------------------------------------- one_mismatch.cu

def _search_case(fwd, rev, forward, read, L, ln, mid, S, steps):
    first, last = (0, mid) if forward else (mid, ln)
    spine = (0, fwd.n + 1, 0, fwd.n + 1)
    for t in range(steps):
        j = last - 1 - t
        if j < first:
            break
        spine = bi_children(fwd, rev, False, spine)[code_at(read, L, j)]
    br = [(0, 0, 0, 0)] * S
    overflow = False
    for t in range(steps):
        j = mid + t if forward else mid - 1 - t
        if (j >= ln) if forward else (j < 0):
            break
        c = code_at(read, L, j)
        ext = [bi_children(fwd, rev, forward, v)[c] for v in br]
        sm = bi_children(fwd, rev, forward, spine)
        alive = [[lane + 32 * h < S and ext[lane + 32 * h][1] > ext[lane + 32 * h][0]
                  for lane in range(LANES)] for h in range(2)]
        dead = [[lane + 32 * h < S and not alive[h][lane] for lane in range(LANES)]
                for h in range(2)]
        count = sum(alive[0]) + sum(alive[1])
        new = [None] * S
        for lane in range(LANES):
            for h in range(2):
                s = lane + 32 * h
                if s >= S:
                    continue
                if alive[h][lane]:
                    dest = (sum(alive[0]) if h else 0) + sum(alive[h][:lane])
                else:
                    dest = count + (sum(dead[0]) if h else 0) + sum(dead[h][:lane])
                new[dest] = ext[s]
        br = new
        spawned = 0
        for u in range(3):
            w = sm[u + (1 if u >= c else 0)]
            if w[1] > w[0]:
                slot = count + spawned
                if slot >= S:
                    overflow = True
                else:
                    br[slot] = w
                spawned += 1
        spine = sm[c]
    return spine, br, overflow


def one_mismatch_candidates(bi, reads, lengths, steps, n_slots):
    """(cand_lo, cand_hi) (B, 2 S + 1) int32 and overflow (B,) bool, read
    by read."""
    fwd, rev = Table(bi.fwd), Table(bi.rev)
    B, L = reads.shape
    S = n_slots
    cand_lo = np.zeros((B, 2 * S + 1), np.int32)
    cand_hi = np.zeros((B, 2 * S + 1), np.int32)
    ovf = np.zeros(B, bool)
    for b in range(B):
        ln = int(lengths[b])
        mid = ln // 2
        spine, br_a, oa = _search_case(fwd, rev, True, reads[b], L, ln, mid, S, steps)
        _, br_b, ob = _search_case(fwd, rev, False, reads[b], L, ln, mid, S, steps)
        cand_lo[b] = [spine[0]] + [v[0] for v in br_a] + [v[0] for v in br_b]
        cand_hi[b] = [spine[1]] + [v[1] for v in br_a] + [v[1] for v in br_b]
        ovf[b] = oa or ob
    return cand_lo, cand_hi, ovf


# ---------------------------------------------------------------- test inputs

def genome_codes(seed, alphabet=4, size=12_000):
    """A random genome; with all four codes, a 40 bp unit repeated 12 times
    in front of it (wide intervals, pools that overflow)."""
    rng = np.random.default_rng(seed)
    if alphabet < 4:
        return rng.integers(0, alphabet, size=size, dtype=np.uint8)
    unit = rng.integers(0, 4, size=40, dtype=np.uint8)
    return np.concatenate([np.tile(unit, 12), rng.integers(0, 4, size=size, dtype=np.uint8)])


def edge_reads(codes, seed, B=14, L=36, subs=2):
    """Reads from the genome (0..subs substitutions, some in the repeat) of
    lengths 0, 1, 2 (< P at k >= 2), 5, L and ragged, plus one random read:
    (reads (B, L), lengths (B,)) int32 arrays."""
    rng = np.random.default_rng(seed)
    reads = np.zeros((B, L), np.int32)
    for i in range(B):
        p = int(rng.integers(0, codes.size - L)) if i % 3 else int(rng.integers(0, 400))
        r = codes[p : p + L].astype(np.int32)
        for at in rng.integers(0, L, size=int(rng.integers(0, subs + 1))):
            r[at] = (r[at] + 1 + rng.integers(0, 3)) % 4
        reads[i] = r
    reads[-1] = rng.integers(0, 4, size=L)
    lengths = rng.integers(L // 2, L + 1, size=B).astype(np.int32)
    lengths[:4] = [0, 1, 2, 5]
    lengths[4:7] = L
    return reads, lengths


def dying_reads(codes, seed, B=8, L=30):
    """Reads from a genome without code 3 whose every piece ends in 3 (at
    k = 2) and whose halves end in 3: every spine is empty after one step."""
    reads, lengths = edge_reads(codes, seed, B=B, L=L, subs=0)
    lengths[:4] = L
    for i in range(B):
        ln = int(lengths[i])
        for e in (ln * 1 // 3, ln * 2 // 3, ln, ln // 2):
            if e > 0:
                reads[i, e - 1] = 3
    return reads, lengths
