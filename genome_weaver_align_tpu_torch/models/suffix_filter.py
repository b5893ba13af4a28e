"""Approximate search: piece partitioning + candidate generation (FM
pigeonhole or CSR seed table) + DP verify + deterministic best hit.

Torch counterpart of ``genome_weaver_align_tpu.models.suffix_filter``.
Split each read into ``k+1`` pieces; any alignment with <= k edits leaves
at least one piece exact (pigeonhole).  The FM path backward-searches every
piece and locates its occurrences; the seed-table path looks up j-mers
inside each piece (an exact piece implies every j-mer inside it is exact),
a complete superset of candidate diagonals.  The banded DP (or Myers)
verifies them.

Every function takes tensors on one device and keeps fixed shapes with no
host synchronisation, so a batch's whole step is enqueued without waiting.
Where the JAX code relies on clamped gathers or dropped out-of-range
scatters, this code clamps explicitly or scatters into a spare slot that it
slices off: an out-of-range index on a CUDA device is a device assert.

The staircase (tier 2) is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import dp as dp_ops
from ..ops import myers as myers_ops
from ..ops import rank, window
from ..ops.rank import DeviceFMIndex

I32 = torch.int32


class CandidateResult(NamedTuple):
    cand_pos: torch.Tensor  # (B, C) int32, sorted; NO_CAND where invalid
    n_cands: torch.Tensor  # (B,)
    overflow: torch.Tensor  # (B,) bool — some piece bucket exceeded the cap


# invalid-candidate sentinel: must sort AFTER every real candidate diagonal
# so the "sorted ascending, NO_CAND tail" invariant (dedup slice, best_hit
# tie-break) holds.  Same value as the JAX package: it leaks into sort order.
NO_CAND = 2**31 - 2**20


def compact_lanes(valid: torch.Tensor, K: int):
    """Stable indices of the first K True lanes — O(n) cumsum + scatter.

    Returns (sel (K,) int32 source indices — 0 on lanes past the valid
    count, so scatters *from* them must mask with ``ok``; ok (K,) bool;
    dropped (n,) bool — valid lanes beyond the budget).  Invalid and
    over-budget lanes scatter into a spare slot K, which is sliced off
    (the JAX code drops them with ``mode="drop"``).
    """
    n = valid.shape[0]
    dev = valid.device
    slot = torch.cumsum(valid.to(I32), dim=0, dtype=I32) - 1
    tgt = torch.where(valid, slot, K).clamp_(max=K).long()
    sel = torch.full((K + 1,), n, dtype=I32, device=dev)
    sel.scatter_(0, tgt, torch.arange(n, dtype=I32, device=dev))
    sel = sel[:K]
    total = slot[-1:] + 1 if n else torch.zeros(1, dtype=I32, device=dev)
    ok = torch.arange(K, dtype=I32, device=dev) < total
    sel = torch.where(ok, sel, 0)  # safe to gather from; mask with ok
    dropped = valid & (slot >= K)
    return sel, ok, dropped


def _piece_bounds(lengths: torch.Tensor, n_pieces: int) -> torch.Tensor:
    """Equal-split piece boundaries [s_i, e_i) per read (reference's split
    scheduling: floor(i*len/p))."""
    i = torch.arange(n_pieces + 1, dtype=I32, device=lengths.device)[None, :]
    return torch.div(lengths.to(I32)[:, None] * i, n_pieces, rounding_mode="floor")


def _dedupe_cands(cand: torch.Tensor, overflow: torch.Tensor, max_cands: int | None):
    """Shared candidate tail: sort, neighbour-dedupe, cap at max_cands."""
    B = cand.shape[0]
    cand = torch.sort(cand, dim=1).values
    dup = torch.cat(
        [torch.zeros((B, 1), dtype=torch.bool, device=cand.device),
         cand[:, 1:] == cand[:, :-1]],
        dim=1,
    )
    cand = torch.where(dup, NO_CAND, cand)
    cand = torch.sort(cand, dim=1).values
    n = (cand != NO_CAND).sum(dim=1, dtype=I32)
    if max_cands is not None and max_cands < cand.shape[1]:
        overflow = overflow | (n > max_cands)
        cand = cand[:, :max_cands]
        n = n.clamp(max=max_cands)
    return CandidateResult(cand, n, overflow)


def piece_interval_search(
    fm: DeviceFMIndex,
    reads: torch.Tensor,  # (B, L) int32 search codes (N already mapped to 0)
    lengths: torch.Tensor,
    n_pieces: int,
    max_len: int | None = None,
    kmer_tab: tuple[torch.Tensor, torch.Tensor] | None = None,
    kmer_j: int = 0,
    kmer_full_cover: bool = False,
):
    """Exact backward search of every piece: (lo, hi, s), each (B, P).

    A fixed trip count of ceil(L/P) + 1 interval updates (lanes whose piece
    is exhausted or whose interval is empty stop updating).  With a k-mer
    table, each piece's last ``kmer_j`` characters resolve with one lookup
    (pieces shorter than kmer_j take the plain loop);
    ``kmer_full_cover=True`` (caller guarantees every piece >= kmer_j) also
    shortens the loop by kmer_j rounds."""
    B, L = reads.shape
    dev = reads.device
    reads = reads.to(I32)
    bounds = _piece_bounds(lengths, n_pieces)
    s, e = bounds[:, :-1], bounds[:, 1:]  # (B, P)
    steps = (L + n_pieces - 1) // n_pieces + 1 if max_len is None else max_len

    if kmer_tab is not None and kmer_j > 0:
        use_tab = (e - s) >= kmer_j  # (B, P)
        idx = torch.zeros((B, n_pieces), dtype=I32, device=dev)
        for t in range(kmer_j):
            pos = (e - kmer_j + t).clamp(0, L - 1)
            idx = (idx << 2) | torch.gather(reads, 1, pos.long())
        idx = idx.clamp(0, kmer_tab[0].shape[0] - 1).long()
        lo = torch.where(use_tab, kmer_tab[0][idx], 0)
        hi = torch.where(use_tab, kmer_tab[1][idx], fm.n + 1)
        skip = torch.where(use_tab, kmer_j, 0)
    else:
        lo = torch.zeros((B, n_pieces), dtype=I32, device=dev)
        hi = torch.full((B, n_pieces), fm.n + 1, dtype=I32, device=dev)
        skip = torch.zeros((B, n_pieces), dtype=I32, device=dev)

    trip = steps - kmer_j if (kmer_tab is not None and kmer_full_cover) else steps
    for t in range(trip):
        j = e - 1 - skip - t  # (B, P)
        active = (j >= s) & (lo < hi)
        c = torch.gather(reads, 1, j.clamp(0, L - 1).long())
        nlo, nhi = rank.backward_step(fm, c, lo, hi)
        lo, hi = torch.where(active, nlo, lo), torch.where(active, nhi, hi)
    return lo, hi, s


def pigeonhole_candidates(
    fm: DeviceFMIndex,
    reads: torch.Tensor,
    lengths: torch.Tensor,
    n_pieces: int,
    max_hits: int = 16,
    kmer_tab=None,
    kmer_j: int = 0,
    kmer_full_cover: bool = False,
    locate_slack: int = 2,
    max_cands: int | None = None,
) -> CandidateResult:
    """Candidate loci from exact piece matches, deduped and sorted.

    Locate is the gather-dominated stage, so only valid interval rows walk
    the LF chain: rows are batch-compacted and the first
    ``B * n_pieces * locate_slack`` lanes located; a read whose valid row
    fell beyond the budget is overflow-flagged, never silently dropped.
    ``max_cands`` caps the candidate axis after dedup (sorted ascending, so
    the slice keeps the smallest loci; more real candidates also flags
    overflow)."""
    B, L = reads.shape
    dev = reads.device
    lo, hi, s = piece_interval_search(
        fm, reads, lengths, n_pieces,
        kmer_tab=kmer_tab, kmer_j=kmer_j, kmer_full_cover=kmer_full_cover,
    )
    overflow = torch.any(hi - lo > max_hits, dim=1)

    rows = lo[:, :, None] + torch.arange(max_hits, dtype=I32, device=dev)  # (B, P, H)
    valid = rows < hi[:, :, None]
    rows_flat = rows.clamp(0, fm.n).reshape(-1)
    valid_flat = valid.reshape(-1)
    N = rows_flat.shape[0]
    sel, ok, dropped = compact_lanes(valid_flat, B * n_pieces * locate_slack)
    sel = sel.long()
    pos_sel = rank.locate(fm, rows_flat[sel])
    # lanes past the valid count write the spare slot N, sliced off
    sel_tgt = torch.where(ok, sel, N)
    pos_flat = torch.zeros(N + 1, dtype=I32, device=dev).scatter_(0, sel_tgt, pos_sel)[:N]
    located = (valid_flat & ~dropped).reshape(rows.shape)
    overflow = overflow | torch.any(dropped.reshape(B, -1), dim=1)
    pos = pos_flat.reshape(rows.shape)

    cand = torch.where(valid & located, pos - s[:, :, None], NO_CAND)
    return _dedupe_cands(cand.reshape(B, n_pieces * max_hits), overflow, max_cands)


SEED_PROBES = 4  # rare-seed probes per piece (see the JAX package)


def _all_jmers(reads: torch.Tensor, j: int) -> torch.Tensor:
    """(B, L) int32: the j-mer value starting at every read position.

    Rolling accumulation over j static shifts of the whole read tensor.
    Positions past L - j accumulate zero-padding; callers only read
    positions with a full j-mer in range."""
    B, L = reads.shape
    ext = torch.cat([reads.to(I32), torch.zeros((B, j), dtype=I32, device=reads.device)], dim=1)
    acc = torch.zeros((B, L), dtype=I32, device=reads.device)
    for t in range(j):
        acc = (acc << 2) | ext[:, t : t + L]
    return acc


def _seed_probe_idx(reads, s, e, j: int, n_probes: int):
    """j-mer values + start offsets for ``n_probes`` positions per piece.

    Probe r starts at s + floor(avail * r / (R-1)) with avail = e - j - s;
    the last probe is the piece-end-anchored j-mer, so n_probes=1
    degenerates to it.  Returns (idx, jstart) both (B, P, R) int32."""
    B, L = reads.shape
    jm = _all_jmers(reads, j)  # (B, L)
    avail = (e - j - s).clamp(min=0)  # (B, P)
    starts = []
    for r in range(n_probes):
        if n_probes > 1:
            starts.append(s + torch.div(avail * r, n_probes - 1, rounding_mode="floor"))
        else:
            starts.append(s + avail)
    jstart = torch.stack(starts, dim=2)  # (B, P, R)
    P, R = jstart.shape[1], jstart.shape[2]
    gidx = jstart.reshape(B, P * R).clamp(0, L - 1).long()
    idx = torch.gather(jm, 1, gidx).reshape(B, P, R)
    return idx, jstart


def seed_candidates(
    offsets: torch.Tensor,  # (4^j + 1,) int32 CSR bucket starts
    positions: torch.Tensor,  # (n - j + 1,) int32 positions grouped by j-mer
    reads: torch.Tensor,  # (B, L) int32 search codes (N already mapped to 0)
    lengths: torch.Tensor,
    n_pieces: int,
    j: int,
    max_hits: int = 16,
    max_cands: int | None = None,
    n_probes: int = SEED_PROBES,
) -> CandidateResult:
    """Candidate loci via the CSR seed table: per piece ``n_probes`` bucket
    widths, then ONE positions slice gather for the rarest live probe.
    Caller guarantees every piece length >= j."""
    B, L = reads.shape
    dev = reads.device
    bounds = _piece_bounds(lengths, n_pieces)
    s, e = bounds[:, :-1], bounds[:, 1:]  # (B, P)

    idx, jstart = _seed_probe_idx(reads, s, e, j, n_probes)  # (B, P, R)
    pair = idx[..., None] + torch.arange(2, dtype=I32, device=dev)
    off2 = offsets[pair.clamp(0, offsets.shape[0] - 1).long()]  # (B, P, R, 2)
    start_all, end_all = off2[..., 0], off2[..., 1]
    width_all = end_all - start_all
    # a zero-width bucket is a j-mer absent from the genome (a probe that
    # crossed a read edit): it must not win the rarest-probe argmin
    width_all = torch.where(width_all <= 0, 1 << 30, width_all)
    r_best = torch.argmin(width_all, dim=2, keepdim=True)  # first min: deterministic

    def take(a):
        return torch.gather(a, 2, r_best)[..., 0]

    start, end, jst = take(start_all), take(end_all), take(jstart)
    width = end - start
    overflow = torch.any(width > max_hits, dim=1)

    slots = start[..., None] + torch.arange(max_hits, dtype=I32, device=dev)  # (B, P, H)
    valid = slots < end[..., None]
    hit = positions[slots.clamp(0, positions.shape[0] - 1).long()]
    # diagonal: j-mer genome position minus its offset in the read
    cand = torch.where(valid, hit - jst[..., None], NO_CAND)
    return _dedupe_cands(cand.reshape(B, n_pieces * max_hits), overflow, max_cands)


class VerifyResult(NamedTuple):
    best_pos: torch.Tensor  # (B,) int32 window-adjusted best locus (cand estimate)
    best_dist: torch.Tensor  # (B,) int32 (INF if none within threshold)
    best_cand: torch.Tensor  # (B,) int32 index into cand axis
    n_good: torch.Tensor  # (B,) candidates within threshold


def verify_candidates(
    text_words: torch.Tensor,
    n_text: int,
    reads: torch.Tensor,  # (B, L) verify codes (N = 4)
    lengths: torch.Tensor,
    cand_pos: torch.Tensor,  # (B, C)
    k: int,
    window_width: int,
):
    """Banded edit distance for every candidate: (B, C) dists (INF invalid)."""
    B, C = cand_pos.shape
    invalid = cand_pos == NO_CAND
    rid = torch.div(torch.arange(B * C, dtype=I32, device=cand_pos.device), C,
                    rounding_mode="floor")
    dist, end_b = dp_ops.banded_edit_distance_text(
        text_words, n_text, torch.where(invalid, 0, cand_pos - k).reshape(-1),
        reads.to(torch.int8).contiguous(), lengths.to(I32).contiguous(), rid, k, window_width,
    )
    dist = torch.where(invalid, dp_ops.INF, dist.reshape(B, C))
    return dist, end_b.reshape(B, C)


def verify_candidates_myers(
    text_words: torch.Tensor,
    n_text: int,
    reads: torch.Tensor,
    lengths: torch.Tensor,
    cand_pos: torch.Tensor,
    k: int,
    window_width: int,
    nwords: int,
) -> torch.Tensor:
    """Myers bit-parallel verify over the same windows (no band limit):
    (B, C) dists, INF where invalid."""
    B, C = cand_pos.shape
    invalid = cand_pos == NO_CAND
    dev = cand_pos.device
    rid = torch.div(torch.arange(B * C, dtype=I32, device=dev), C, rounding_mode="floor")
    dist, _ = myers_ops.myers_semiglobal_text(
        text_words, n_text, torch.where(invalid, 0, cand_pos - k).reshape(-1),
        reads.to(torch.int8).contiguous(), lengths.to(I32).contiguous(), rid,
        torch.full((B * C,), window_width, dtype=I32, device=dev), window_width, nwords,
    )
    return torch.where(invalid, dp_ops.INF, dist.reshape(B, C))


def offset_hamming(
    text_words: torch.Tensor,
    n_text: int,
    reads: torch.Tensor,  # (B, L) verify codes
    lengths: torch.Tensor,
    cand_pos: torch.Tensor,  # (B,) chosen best candidate estimate
    k: int,
):
    """Hamming distance of each read vs window[cand-k+o : ...] for o in
    [0, 2k].  If min == the edit distance, the alignment is pure
    substitutions: CIGAR is '<L>M' with start cand-k+argmin — no traceback
    needed (the fast path for substitution-dominated read streams)."""
    B, L = reads.shape
    W = L + 2 * k + 1
    wins = window.gather_windows(text_words, n_text, cand_pos - k, W)
    h = torch.stack(
        [dp_ops.hamming_distance(reads, lengths, wins, o) for o in range(2 * k + 1)],
        dim=1,
    )  # (B, 2k+1)
    return h.min(dim=1).values, torch.argmin(h, dim=1).to(I32)


def verify_candidates_compact(
    text_words: torch.Tensor,
    n_text: int,
    reads: torch.Tensor,  # (B, L) verify codes (N = 4)
    lengths: torch.Tensor,
    cand_pos: torch.Tensor,  # (B, C) sorted, NO_CAND tail
    k: int,
    window_width: int,
    slack: int = 6,
):
    """Banded verify over batch-compacted candidate lanes.

    The whole batch shares a budget of ``B * slack`` lanes: valid
    candidates are compacted to the front and only those lanes run the DP.
    A read whose candidates fall beyond the budget is overflow-flagged,
    never silently dropped.

    Returns (dist (K,), cp (K,), rid (K,), overflow (B,)) — compacted
    lanes with their read ids, for ``best_hit_compact``.
    """
    B, C = cand_pos.shape
    flat = cand_pos.reshape(-1)
    valid = flat != NO_CAND
    K = B * slack
    sel, ok, dropped = compact_lanes(valid, K)
    sel = sel.long()
    rid = torch.div(sel, C, rounding_mode="floor").to(I32)
    cp = flat[sel]
    dist, _ = dp_ops.banded_edit_distance_text(
        text_words, n_text, torch.where(ok, cp - k, 0), reads.to(torch.int8).contiguous(),
        lengths.to(I32).contiguous(), rid, k, window_width,
    )
    dist = torch.where(ok, dist, dp_ops.INF)
    overflow = torch.any(dropped.reshape(B, C), dim=1)
    return dist, cp, rid, overflow


def best_hit_compact(
    rid: torch.Tensor, cp: torch.Tensor, dist: torch.Tensor, k: int, n_reads: int
) -> VerifyResult:
    """Deterministic per-read best over compacted lanes via scatter-min.

    Order matches ``best_hit``: lexicographic (dist, pos), dist <= k only.
    Integer scatter-min and scatter-add are deterministic on the device.
    """
    dev = dist.device
    INF = dp_ops.INF
    rid = rid.long()
    good = dist <= k
    dkey = torch.where(good, dist, INF)
    best_dist = torch.full((n_reads,), INF, dtype=dist.dtype, device=dev)
    best_dist.scatter_reduce_(0, rid, dkey, "amin", include_self=True)
    pkey = torch.where(good & (dist == best_dist[rid]), cp, NO_CAND)
    best_pos = torch.full((n_reads,), NO_CAND, dtype=cp.dtype, device=dev)
    best_pos.scatter_reduce_(0, rid, pkey, "amin", include_self=True)
    n_good = torch.zeros((n_reads,), dtype=I32, device=dev).index_add_(0, rid, good.to(I32))
    has = n_good > 0
    return VerifyResult(
        torch.where(has, best_pos, -1),
        torch.where(has, best_dist, INF),
        torch.zeros((n_reads,), dtype=I32, device=dev),  # lane index is meaningless here
        n_good,
    )


def best_hit(cand_pos: torch.Tensor, dist: torch.Tensor, k: int) -> VerifyResult:
    """Deterministic best: min (dist, pos); only dist <= k counts.

    ``cand_pos`` rows are sorted ascending, so argmin's first-match
    tie-break picks the smallest position among equal distances.
    """
    good = dist <= k
    key = torch.where(good, dist, dp_ops.INF)
    bi = torch.argmin(key, dim=1, keepdim=True)
    bb = torch.gather(dist, 1, bi)[:, 0]
    bp = torch.gather(cand_pos, 1, bi)[:, 0]
    n_good = good.sum(dim=1, dtype=I32)
    has = n_good > 0
    return VerifyResult(
        torch.where(has, bp, -1),
        torch.where(has, bb, dp_ops.INF),
        bi[:, 0].to(I32),
        n_good,
    )
