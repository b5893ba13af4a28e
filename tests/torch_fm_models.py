"""Scalar models of the port's FM search and locate kernels, in the
kernels' own loop order, for the CPU tests (no card here runs the CUDA
code).

Each model follows its CUDA source step for step: ``csrc/fm_occ.cuh``'s
row split and three-popcount count (code 0 as r less the other three),
``csrc/fm_search.cu``'s one lane at a time with its early exit, its loop
shared by one index and the interval shards through a table accessor
(the sharded one finds each coordinate's owner and reads that shard's
split tables, the owner guessed by division and confirmed as
``fm_occ.cuh`` ``owner_of`` does: up to 16 shards the bounds checked for
overlap and scanned, past 16 the bindings' findings on the bounds and a
bisection where they are in order), ``csrc/locate.cu``'s persistent walk
(a thread's rows one after another, the next the grid's threads further
on; mark block and row read together, stop at the first mark; over the
shards, each step's row and packed owners looked up),
``csrc/staircase.cu``'s one pool at a time as a group of G lanes (the spine
in group lane 0, passes of G live slots into the other buffer, the
ballot-and-prefix placement; rank-major placement in one pass of a whole
warp, or past 64 slots in two rounds of passes, the counts first), and
``csrc/one_mismatch.cu``'s one (read, case) at a time as a group of G lanes
(the work items: spine, live slots and case B's distinct dead chains, found
by chunks of G; the newly dead staged until the live count is known; spawns
in code order).  Shared memory the
kernel never writes holds None here, so a model that reads it fails.  The
tests hold each model against the plain torch version on every output, at
several G, so the formulation the CUDA code follows is checked on the CPU.
The genome and read generators at the end are the edge-case inputs of both
the CPU tests and the card tests.
"""

from __future__ import annotations

import numpy as np

import torch

from genome_weaver_align_tpu_torch.ops.fm_search_cuda import owner_divisor, split_facts

M32 = 0xFFFFFFFF


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


def occ1_row(words, cp, r, c):
    """fm_occ.cuh's occ1 on one row: its 8 words, 4 checkpoints and the
    bases r of the block before the coordinate."""
    pattern = (c * 0x55555555) & M32
    n = 0
    for j in range(8):
        x = int(words[j]) ^ pattern
        n += bin(~(x | (x >> 1)) & _slot_mask(r, j) & M32).count("1")
    return int(cp[c]) + n


def row_code(words, r):
    """fm_occ.cuh's row_code: the BWT code at base r of the block."""
    return (int(words[r >> 4]) >> (2 * (r & 15))) & 3


def lf_below(words, cp, C, r, coded=True):
    """fm_occ.cuh's lf_below: C[c] + occ$(c, k) for the code c at base r of
    the row (0 where not ``coded``), the words below the coordinate's word
    wq counted in full and wq cut to its r & 15 slots."""
    wq = int(words[(r >> 4) & 7])
    c = (wq >> (2 * (r & 15))) & 3 if coded else 0
    pattern = (c * 0x55555555) & M32
    x = wq ^ pattern
    n = bin(~(x | (x >> 1)) & ((1 << (2 * (r & 15))) - 1) & 0x55555555).count("1")
    for j in range(7):
        x = int(words[j]) ^ pattern
        if j < r >> 4:
            n += bin(~(x | (x >> 1)) & 0x55555555).count("1")
    return (C[c] + int(cp[c]) + n + 2**31) % 2**32 - 2**31


def occ1(t: Table, k, c):
    b, r = t.row(k)
    return occ1_row(t.words[b], t.cp[b], r, c)


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

class OneIndex:
    """fm_search.cu's accessor over one index's fused rows."""

    def __init__(self, fm):
        self.t = Table(fm)
        self.C, self.n = self.t.C, self.t.n

    def load(self, k):
        b, r = self.t.row(k)
        return self.t.words[b], self.t.cp[b], r

    def occ(self, row, c):
        return occ1_row(*row, c)


STAGED = 16  # csrc/fm_occ.cuh kMaxStaged: the sharded locate stages its bounds up to it


def split(bounds, width, staged=False):
    """fm_occ.cuh Split: the bounds, the bindings' divisor of ``width``
    (ops/fm_search_cuda.py owner_divisor), whether the ranges are disjoint
    and whether they are in order (``facts``)."""
    return bounds, owner_divisor(width), *facts(bounds, staged)


def facts(bounds, staged=False):
    """(disjoint, in order) of a split's bounds as the kernels have them:
    the bindings' split_facts, or, staged (load_split, once a block), the
    bounds checked for overlap pair by pair and no order."""
    if staged:
        spans = list(zip((int(x) for x in bounds[0]), (int(x) for x in bounds[1])))
        return not any(max(a0, b0) < min(a1, b1)
                       for i, (a0, a1) in enumerate(spans) for b0, b1 in spans[i + 1:]), False
    found = split_facts(*(torch.as_tensor(np.asarray(b)) for b in bounds))
    return bool(found & 1), bool(found & 2)


def owner_of(sp, x):
    """fm_occ.cuh owner_of on a ``split``: the guess (x - base) / width
    (__umulhi(x - base, magic) >> shift, base the first shard's start; an x
    below it wraps), kept when its range holds x and the ranges are
    disjoint, else with the bounds in order the bisection (the last shard
    whose start is at most x, kept when its end is above x), else the scan
    of every shard's bounds."""
    bounds, (magic, shift), apart, in_order = sp
    g = min(((((x - int(bounds[0][0])) & M32) * magic) >> 32) >> shift, len(bounds[0]) - 1)
    if apart and int(bounds[0][g]) <= x < int(bounds[1][g]):
        return g
    if in_order:
        lo, hi = 0, len(bounds[0])
        while lo < hi:
            mid = (lo + hi) >> 1
            if int(bounds[0][mid]) <= x:
                lo = mid + 1
            else:
                hi = mid
        return lo - 1 if lo > 0 and x < int(bounds[1][lo - 1]) else -1
    return Shards.owner(bounds, x)


class Shards:
    """The stacked tables of a ``ShardedFMIndex`` (on the CPU) as host
    values, and fm_search.cu's accessor over them: a coordinate's row is
    read from the shard that owns it (fm_occ.cuh load_row), none without
    an owner.  ``locate``: the sharded locate's splits, staged up to
    ``STAGED`` shards."""

    def __init__(self, sh, locate=False):
        def host(x):
            return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)

        self.words = host(sh.bwt_blocks).view(np.uint32)
        self.occ_cp = host(sh.occ_cp)
        self.pk = (host(sh.pk_start), host(sh.pk_end))
        self.marks = host(sh.mark_blocks).view(np.uint32)
        self.mark_cp = host(sh.mark_cp)
        self.rows = (host(sh.row_start), host(sh.row_end))
        self.ssa, self.ssa_base = host(sh.ssa_values), host(sh.ssa_base)
        self.C = [int(x) for x in host(sh.C)[:4]]
        self.primary, self.n, self.S = int(sh.primary), int(sh.n), self.words.shape[0]
        self.sample_rate = int(sh.sample_rate)
        # the splits as the bindings pass them: shard_fm_index's equal widths
        staged = locate and self.S <= STAGED
        self.pk_split = split(self.pk, (self.words.shape[1] - 1) * 128, staged)
        self.row_split = split(self.rows, self.marks.shape[1] * 128, staged)

    @staticmethod
    def owner(bounds, x):
        """The shard whose [start, end) holds x, -1 if none (fm_occ.cuh
        owner_of's scan)."""
        s = -1
        for d in range(len(bounds[0])):
            if bounds[0][d] <= x < bounds[1][d]:
                s = d
        return s

    def load(self, k):
        k_adj = k - (1 if k > self.primary else 0)
        s = owner_of(self.pk_split, k_adj)
        if s < 0:
            return None
        local = k_adj - int(self.pk[0][s])
        b = min(local // 128, self.words.shape[1] - 1)
        return self.words[s, b], self.occ_cp[s, b], local - b * 128

    def occ(self, row, c):
        return 0 if row is None else occ1_row(*row, c)


def _search_lane(tab, read, L, ln, p, P, trip, kmer=None, kmer_j=0):
    """fm_search.cu search_lane: one lane's (lo, hi)."""
    start, end = ln * p // P, ln * (p + 1) // P
    lo, hi, skip = 0, tab.n + 1, 0
    if kmer is not None and end - start >= kmer_j:
        idx = 0
        for u in range(kmer_j):
            idx = (idx << 2) | code_at(read, L, end - kmer_j + u)
        idx = min(max(idx, 0), kmer[0].shape[0] - 1)
        lo, hi, skip = int(kmer[0][idx]), int(kmer[1][idx]), kmer_j
    for s in range(trip):
        j = end - 1 - skip - s
        if j < start or lo >= hi:
            break
        c = code_at(read, L, j)
        rl, rh = tab.load(lo), tab.load(hi)
        lo, hi = tab.C[c] + tab.occ(rl, c), tab.C[c] + tab.occ(rh, c)
    return lo, hi


def _search(tab, reads, lengths, P, trip, kmer=None, kmer_j=0):
    B, L = reads.shape
    lo_out = np.zeros((B, P), np.int32)
    hi_out = np.zeros((B, P), np.int32)
    for b in range(B):
        for p in range(P):
            lo_out[b, p], hi_out[b, p] = _search_lane(tab, reads[b], L, int(lengths[b]), p, P,
                                                      trip, kmer, kmer_j)
    return lo_out, hi_out


def backward_search(fm, reads, lengths, n_pieces, trip, kmer_tab=None, kmer_j=0):
    """(lo, hi) (B, P) int32, lane by lane over one index."""
    kmer = None if kmer_tab is None or kmer_j <= 0 else [np.asarray(x) for x in kmer_tab]
    return _search(OneIndex(fm), reads, lengths, n_pieces, trip, kmer, kmer_j)


def backward_search_sharded(sh, reads, lengths, n_pieces, trip):
    """(lo, hi) (B, P) int32, lane by lane over the interval shards."""
    return _search(Shards(sh), reads, lengths, n_pieces, trip)


# ---------------------------------------------------------------- locate.cu

def _mark_bit(words4, rem):
    return (int(words4[rem >> 5]) >> (rem & 31)) & 1


def _marks_below(words4, rem):
    n = 0
    for j in range(4):
        allowed = min(max(rem - 32 * j, 0), 32)
        n += bin(int(words4[j]) & ((1 << allowed) - 1)).count("1")
    return n


class _OneWalk:
    """locate.cu's OneIndex accessor: a step's mark block and fused row."""

    def __init__(self, fm):
        self.t = Table(fm)
        self.blocks = fm.mark_blocks.cpu().numpy().view(np.uint32)
        self.cp, self.ssa = fm.mark_cp.cpu().numpy(), fm.ssa_values.cpu().numpy()
        self.sample_rate = int(fm.sample_rate)

    def load(self, i):
        mblk = min(max(i >> 7, 0), self.blocks.shape[0] - 1)
        return (mblk, i - mblk * 128, self.blocks[mblk], self.t.row(min(max(i, 0), self.t.n)))

    def marked(self, st):
        return _mark_bit(st[2], st[1] & 127)

    def lf(self, st):
        b, r = st[3]
        return lf_below(self.t.words[b], self.t.cp[b], self.t.C, r)

    def stop(self, st):
        return st[0], _marks_below(st[2], st[1])

    def value_index(self, key, rank0):
        return min(max(rank0 + key, 0), self.ssa.size - 1)


class _ShardWalk:
    """locate.cu's Shards accessor: each step's owners by owner_of."""

    def __init__(self, sh):
        self.st = Shards(sh, locate=True)
        self.cp, self.ssa = self.st.mark_cp.reshape(-1), self.st.ssa.reshape(-1)
        self.mbs, self.vmax = self.st.marks.shape[1], self.st.ssa.shape[1]
        self.sample_rate = self.st.sample_rate

    def load(self, i):
        st = self.st
        owner, b, rem, marks = owner_of(st.row_split, i), 0, 0, np.zeros(4, np.uint32)
        if owner >= 0:
            local = i - int(st.rows[0][owner])
            b = min(local >> 7, self.mbs - 1)
            rem = local - b * 128
            marks = st.marks[owner, b]
        coded = i - (1 if i > st.primary else 0) < st.n
        return owner, b, rem, marks, st.load(i), coded

    def marked(self, step):
        return step[0] >= 0 and _mark_bit(step[3], step[2])

    def lf(self, step):
        row, coded = step[4], step[5]
        if row is None:
            return self.st.C[0]
        words, cp, r = row
        return lf_below(words, cp, self.st.C, r, coded)

    def stop(self, step):
        owner, b, rem, marks = step[:4]
        if owner < 0:
            return -1, 0
        return owner * (self.mbs + 1) + b, _marks_below(marks, rem) | owner << 8

    def value_index(self, key, rank0):
        owner = key >> 8
        slot = min(max(rank0 + (key & 255) - int(self.st.ssa_base[owner]), 0), self.vmax - 1)
        return owner * self.vmax + slot


def _walk(tab, rows, threads):
    """locate.cu walk on a grid of ``threads`` threads: thread t walks rows
    t, t + threads, ... one after another until the rows run out.  ->
    (positions (Q,) int32, writes of each row)."""
    rows = [int(x) for x in rows]
    Q = len(rows)
    out, writes = np.zeros(Q, np.int64), np.zeros(Q, np.int64)

    def walk_one(i):
        d, st = 0, tab.load(i)
        while d != tab.sample_rate and not tab.marked(st):
            i = tab.lf(st)
            d += 1
            st = tab.load(i)
        cp, key = tab.stop(st)
        if cp < 0:
            return d
        return int(tab.ssa[tab.value_index(key, int(tab.cp[cp]))]) + d

    for t in range(threads):
        for q in range(t, Q, threads):
            out[q] = walk_one(rows[q])
            writes[q] += 1
    return out.astype(np.int32), writes


def locate(fm, rows, threads=64):
    """locate.cu locate_kernel on a model grid -> (positions int32, writes
    of each row)."""
    return _walk(_OneWalk(fm), rows, threads)


def locate_sharded(sh, rows, threads=64):
    """locate.cu locate_sharded_kernel on a model grid -> (positions int32,
    writes of each row)."""
    return _walk(_ShardWalk(sh), rows, threads)


# ---------------------------------------------------------------- staircase.cu

FIELDS = ("lo", "hi", "rlo", "mm")  # a slot in shared memory; rhi = rlo + hi - lo


def _children_of(buf, s, fwd, rev, forward, c, budget):
    """One lane's work on parent slot s: its four children (lo, hi, rlo,
    rhi) by code and the bits of those kept under the budget."""
    lo, hi, rlo, mm = (buf[f][s] for f in FIELDS)
    ch = bi_children(fwd, rev, forward, (lo, hi, rlo, rlo + hi - lo))
    keep = 0
    for a in range(4):
        if mm + (a != c) <= budget and ch[a][1] > ch[a][0]:
            keep |= 1 << a
    return ch, mm, keep


def _expand_step(cur, nxt, live, n_slots, fwd, rev, forward, c, budget, rank_major, lanes):
    """One all-4 expansion of a pool's live slots [0, live) from buffer
    ``cur`` into ``nxt``, as a group of ``lanes`` lanes runs it: passes of
    ``lanes`` parents in slot order, the kept children placed by ballot and
    prefix popcount (a warp taking two slots a lane is ``lanes`` = 64).
    Rank-major placement takes every parent in one pass, whose ballots give
    each rank's total; past 64 slots (the Wide kernel) in two rounds of the
    passes, the first counting each rank's kept children, the second
    recomputing and placing them.  Returns the kept count (which may exceed
    n_slots)."""
    passes = [range(p0, min(p0 + lanes, live)) for p0 in range(0, live, lanes)]

    def write(dest, child, mm):
        if dest < n_slots:
            for f, x in zip(FIELDS, (*child[:3], mm)):
                nxt[f][dest] = x

    base = 0
    if not rank_major:
        for slots in passes:
            work = [_children_of(cur, s, fwd, rev, forward, c, budget) for s in slots]
            for ch, mm, keep in work:  # a lane's kept children are consecutive
                for a in range(4):
                    if (keep >> a) & 1:
                        write(base, ch[a], mm + (a != c))
                        base += 1
        return base
    ranks = [c] + [a for a in range(4) if a != c]  # exact child first, then by code
    if n_slots <= 64:
        assert len(passes) <= 1, "rank-major placement in more than one pass"
        work = [_children_of(cur, s, fwd, rev, forward, c, budget) for s in range(live)]
        for a in ranks:
            ballot = [(keep >> a) & 1 for _, _, keep in work]
            for lane, (ch, mm, keep) in enumerate(work):
                if ballot[lane]:
                    write(base + sum(ballot[:lane]), ch[a], mm + (a != c))
            base += sum(ballot)
        return base
    total = [0] * 4
    for slots in passes:  # round 1: each rank's kept children over every pass
        for _, _, keep in (_children_of(cur, s, fwd, rev, forward, c, budget) for s in slots):
            for r, a in enumerate(ranks):
                total[r] += (keep >> a) & 1
    at = [sum(total[:r]) for r in range(4)]
    for slots in passes:  # round 2: the children again, placed
        work = [_children_of(cur, s, fwd, rev, forward, c, budget) for s in slots]
        for r, a in enumerate(ranks):
            ballot = [(keep >> a) & 1 for _, _, keep in work]
            for lane, (ch, mm, keep) in enumerate(work):
                if ballot[lane]:
                    write(at[r] + sum(ballot[:lane]), ch[a], mm + (a != c))
            at[r] += sum(ballot)
    return at[3]


def staircase_pools(bi, reads, lengths, k, n_slots, keep, spine_steps, fwd_steps, bwd_steps,
                    narrow_left, lanes=None):
    """(lo, hi) (P, B, keep) int32 and overflow (P, B) bool, pool by pool,
    each pool a group of ``lanes`` lanes (by default 4, and a whole warp
    under ``narrow_left``, which the kernel refuses with fewer).  Group lane
    0 builds the spine; the pool is two buffers of slots (None where the
    kernel never wrote), and only its live prefix [0, live) is read."""
    if lanes is None:
        lanes = 32 if narrow_left else 4
    if narrow_left and lanes < 32:
        raise ValueError(f"narrow_left at {lanes} lanes a pool: the kernel takes a whole warp")
    if lanes == 32 and n_slots > 32:
        lanes = 64  # two slots a lane: one pass covers the pool
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
            bufs = [{f: [None] * n_slots for f in FIELDS} for _ in range(2)]
            live, cur = 0, 0
            if spine[1] > spine[0]:
                for f, x in zip(FIELDS, (*spine[:3], 0)):
                    bufs[0][f][0] = x
                live = 1
            overflow = False
            piece, next_bound = p, e_p  # piece_of(j), and where the next piece starts
            for t in range(fwd_steps):
                j = e_p + t
                if live == 0 or j >= ln:
                    break
                while next_bound <= j:
                    piece += 1
                    next_bound = ln * (piece + 1) // P
                kept = _expand_step(bufs[cur], bufs[1 - cur], live, n_slots, fwd, rev, True,
                                    code_at(read, L, j), piece - p, narrow_left, lanes)
                overflow |= kept > n_slots
                live, cur = min(kept, n_slots), 1 - cur
            if narrow_left:
                for t in range(bwd_steps):
                    j = s_p - 1 - t
                    if live == 0 or j < 0:
                        break
                    kept = _expand_step(bufs[cur], bufs[1 - cur], live, n_slots, fwd, rev,
                                        False, code_at(read, L, j), k, True, lanes)
                    overflow |= kept > n_slots
                    live, cur = min(kept, n_slots), 1 - cur
            for i in range(min(live, keep)):
                out_lo[p, b, i] = bufs[cur]["lo"][i]
                out_hi[p, b, i] = bufs[cur]["hi"][i]
            out_ovf[p, b] = overflow or live > keep
    return out_lo, out_hi, out_ovf


# ---------------------------------------------------------------- one_mismatch.cu

def _dead_chains(lo, hi, n_live, hw, S, lanes):
    """Case B's distinct dead chains: the dead entries are the slots that
    died, [n_live, hw), and the never-spawned tail [hw, S), which is one
    chain kept in slot S - 1.  In chunks of ``lanes`` entries, an entry
    whose lo an earlier chunk listed takes that index; the others match
    each other (``__match_any_sync``), and the lowest lane of each value
    appends it.  Each entry's index is parked in its slot's hi (a dead
    slot's hi equals its lo).  -> (the distinct lo values, entry count)."""
    n_dead = hw - n_live
    n_ent = n_dead + (1 if hw < S else 0)
    table = []
    for e0 in range(0, n_ent, lanes):
        ents = range(e0, min(e0 + lanes, n_ent))
        slot = {e: n_live + e if e < n_dead else S - 1 for e in ents}
        idx = {e: table.index(lo[slot[e]]) if lo[slot[e]] in table else -1 for e in ents}
        fresh = [e for e in ents if idx[e] < 0]
        leaders = [e for e in fresh if not any(lo[slot[f]] == lo[slot[e]] for f in fresh if f < e)]
        for e in leaders:
            idx[e] = len(table)
            table.append(lo[slot[e]])
        for e in fresh:
            idx[e] = idx[next(f for f in leaders if lo[slot[f]] == lo[slot[e]])]
        for e in ents:
            assert lo[slot[e]] == hi[slot[e]], "a dead slot with hi != lo"
            hi[slot[e]] = idx[e]
    return table, n_ent


def _search_case(fwd, rev, forward, read, L, ln, mid, S, steps, lanes):
    """One (read, case) group of ``lanes`` lanes.  The pool is shared
    memory that the kernel never initialises but for slot S - 1 (None
    elsewhere until written); live slots are [0, n_live), the slots that
    died [n_live, hw) and the never-spawned tail [hw, S), kept in slot
    S - 1.  A step's work items are the spine (item 0, group lane 0), the
    live slots, and in case B the distinct dead chains, ``lanes`` a pass."""
    first, last = (0, mid) if forward else (mid, ln)
    spine = (0, fwd.n + 1, 0, fwd.n + 1)
    for t in range(steps):
        j = last - 1 - t
        if j < first or (not forward and spine[1] <= spine[0]):  # case B's spine is not output
            break
        spine = bi_children(fwd, rev, False, spine)[code_at(read, L, j)]
    lo, hi, rlo = [None] * S, [None] * S, [None] * S
    aux = [None] * S  # distinct dead chains, then the newly dead
    lo[S - 1] = hi[S - 1] = 0
    n_live = hw = 0
    overflow = False
    for t in range(steps):
        j = mid + t if forward else mid - 1 - t
        if (j >= ln) if forward else (j < 0):
            break
        if forward and spine[1] <= spine[0] and n_live == 0:  # nothing moves any more
            break
        c = code_at(read, L, j)
        table, n_ent = ([], 0) if forward else _dead_chains(lo, hi, n_live, hw, S, lanes)
        D = len(table)
        aux[:D] = table
        n_items = 1 + n_live + D
        count = dead = 0
        spine_ch = None
        for p0 in range(0, n_items, lanes):
            items = range(p0, min(p0 + lanes, n_items))
            ops = {}  # every operand of the pass is read before anything is written
            for i in items:
                if i == 0:
                    ops[i] = spine if spine[1] > spine[0] else None
                elif i <= n_live:
                    s = i - 1
                    ops[i] = (lo[s], hi[s], rlo[s], rlo[s] + hi[s] - lo[s])
                else:
                    ops[i] = aux[i - 1 - n_live]
            alive, died = [], []
            for i in items:
                if i == 0:
                    if ops[i] is not None:
                        spine_ch = bi_children(fwd, rev, forward, ops[i])
                elif i <= n_live:
                    v = bi_children(fwd, rev, forward, ops[i])[c]
                    (alive if v[1] > v[0] else died).append(v)
                else:
                    aux[i - 1 - n_live] = fwd.C[c] + occ1(fwd, ops[i], c)
            for v in alive:
                lo[count], hi[count], rlo[count] = v[:3]
                count += 1
            for v in died:
                aux[D + dead] = v[0]  # hi == lo
                dead += 1
        for e in range(dead):
            lo[count + e] = hi[count + e] = aux[D + e]
        for e in range(n_ent):
            s = n_live + e if e < hw - n_live else S - 1
            lo[s] = hi[s] = aux[hi[s]]
        spawned = 0
        if spine_ch is not None:
            for u in range(3):
                w = spine_ch[u + (1 if u >= c else 0)]
                if w[1] > w[0]:
                    slot = count + spawned
                    if slot >= S:
                        overflow = True
                    else:
                        lo[slot], hi[slot], rlo[slot] = w[:3]
                    spawned += 1
            spine = spine_ch[c]
        n_live = min(S, count + spawned)
        hw = max(hw, n_live)
    out = [(lo[s], hi[s]) if s < hw else (lo[S - 1], hi[S - 1]) for s in range(S)]
    return spine, out, overflow


def one_mismatch_candidates(bi, reads, lengths, steps, n_slots, lanes=8):
    """(cand_lo, cand_hi) (B, 2 S + 1) int32 and overflow (B,) bool, read
    by read, each case a group of ``lanes`` lanes."""
    fwd, rev = Table(bi.fwd), Table(bi.rev)
    B, L = reads.shape
    S = n_slots
    cand_lo = np.zeros((B, 2 * S + 1), np.int32)
    cand_hi = np.zeros((B, 2 * S + 1), np.int32)
    ovf = np.zeros(B, bool)
    for b in range(B):
        ln = int(lengths[b])
        mid = ln // 2
        spine, br_a, oa = _search_case(fwd, rev, True, reads[b], L, ln, mid, S, steps, lanes)
        _, br_b, ob = _search_case(fwd, rev, False, reads[b], L, ln, mid, S, steps, lanes)
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


def unequal_cuts(S, total, seed):
    """S + 1 non-decreasing block cuts from 0 to ``total`` at random, some
    equal (empty shards): ``shard_fm_index``'s explicit cuts."""
    rng = np.random.default_rng(seed)
    return [0, *sorted(int(x) for x in rng.integers(0, total + 1, size=S - 1)), total]


def chains_genome(seed, copies=300, size=4_000):
    """A 7 bp unit repeated ``copies`` times with 5% of its bases changed,
    then a random genome: one-mismatch branches spawned inside the repeat
    die at different places, so a read's dead slots hold several distinct
    lo values at once (more than eight in some steps of ``chain_reads``)."""
    rng = np.random.default_rng(seed)
    rep = np.tile(rng.integers(0, 4, size=7, dtype=np.uint8), copies)
    hit = rng.random(rep.size) < 0.05
    rep[hit] = (rep[hit] + rng.integers(1, 4, size=int(hit.sum()))) % 4
    return np.concatenate([rep, rng.integers(0, 4, size=size, dtype=np.uint8)]).astype(np.uint8)


def chain_reads(codes, seed, B=16, L=40, repeat_len=2_100):
    """Reads from the repeat of ``chains_genome``, every other one with one
    substitution: (reads (B, L), lengths (B,)) int32 arrays."""
    rng = np.random.default_rng(seed)
    reads = np.zeros((B, L), np.int32)
    for i in range(B):
        p = int(rng.integers(0, repeat_len - L))
        reads[i] = codes[p : p + L]
        if i % 2:
            at = int(rng.integers(0, L))
            reads[i, at] = (reads[i, at] + 1 + rng.integers(0, 3)) % 4
    return reads, np.full(B, L, np.int32)
