"""Staircase suffix-filter search (Kärkkäinen–Na suffix filters) in torch:
the counterpart of ``genome_weaver_align_tpu.models.staircase``.

For each piece i of the k+1 partition, match the read *suffix* starting at
piece i: piece i exactly (backward-built bidirectional spine), then forward
through pieces i+1..k under the staircase budget — cumulative mismatches
within pieces i..m must stay <= m - i.  Every locus with <= k substitutions
passes at least one piece's staircase, so this is a complete filter for
substitution-k matching with far fewer false candidates than pigeonhole.
Indel alignments are not guaranteed to pass; the DP verify scores them.

The search state is a dense (P, B, S) pool of (bidirectional interval,
mismatch count) lanes, one pool per (piece, read): the P piece searches run
as a leading lane axis, so the sequential step count is about L (spine
ceil(L/P) plus forward ceil(L(P-1)/P)).  Each step expands every lane into
its 4 children with one ``extend_forward_all4`` (one stacked occ gather),
masks them by the budget and compacts the 4S children back to S slots.
Overflow is flagged per read.  Every step has fixed shapes and no host
synchronisation.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import bidirectional as bd
from .bidirectional import BiInterval, DeviceBiIndex
from .suffix_filter import NO_CAND, CandidateResult, _dedupe_cands, _piece_bounds
from ..ops import rank

I32 = torch.int32


class Pool(NamedTuple):
    iv: BiInterval  # (B, S) synchronized intervals
    mm: torch.Tensor  # (B, S) int32 mismatch counts
    overflow: torch.Tensor  # (B,) bool


def _compact_pool(iv: BiInterval, mm: torch.Tensor, n_slots: int):
    """Keep the first n_slots live lanes (stable), count total live.

    src[b, s] = index of the (s+1)-th live lane, found by a batched binary
    search on the per-row liveness cumsum, then one gather per field.
    Stable order, dead slots zeroed, ``live`` = total live lanes (may
    exceed n_slots — the caller's overflow flag)."""
    B, S4 = mm.shape
    alive = iv.hi > iv.lo
    cs = torch.cumsum(alive.to(I32), dim=1, dtype=I32)  # (B, S4) nondecreasing
    live = cs[:, -1]
    targets = torch.arange(1, n_slots + 1, dtype=I32, device=mm.device)
    src = torch.searchsorted(cs, targets.expand(B, n_slots).contiguous(), right=False)
    src = src.clamp_(0, S4 - 1)
    ok = targets[None, :] <= live[:, None]

    def take(field):
        return torch.where(ok, torch.gather(field, 1, src), 0)

    packed = BiInterval(take(iv.lo), take(iv.hi), take(iv.rlo), take(iv.rhi))
    return packed, take(mm), live


def staircase_filter_candidates(
    bi: DeviceBiIndex,
    reads: torch.Tensor,  # (B, L) int32 search codes (N already mapped to 0)
    lengths: torch.Tensor,
    k: int,
    n_slots: int = 16,
    hits_per_state: int = 4,
    keep: int = 8,
    max_len: int | None = None,
    narrow_left: bool = False,  # after the suffix staircase, extend every
    # surviving state LEFT through the pieces before its anchor under the
    # full k budget, so final intervals hold whole-read matches (about
    # +2L/3 sequential steps): complete inside high-copy repeat families,
    # where a suffix interval is wide and only hits_per_state rows of it
    # are located
) -> CandidateResult:
    B, L = reads.shape
    dev = reads.device
    reads = reads.to(I32)
    lengths = lengths.to(I32)
    Lb = L if max_len is None else max_len
    P = k + 1
    spine_steps = -(-Lb // P)
    fwd_steps = -(-(Lb * (P - 1)) // P)  # piece 0's bound covers all lanes
    bounds = _piece_bounds(lengths, P)  # (B, P+1)
    n = bi.fwd.n

    s_pb = bounds[:, :-1].T.contiguous()  # (P, B) piece starts
    e_pb = bounds[:, 1:].T.contiguous()  # (P, B) piece ends
    lane_piece = torch.arange(P, dtype=I32, device=dev)[:, None]  # (P, 1)

    def char_at(j):  # j (P, B) -> codes (P, B); lanes past the read are inactive
        return torch.gather(reads, 1, j.clamp(0, L - 1).T.long()).T

    # ---- spines: every piece built backward simultaneously
    spine = bd.init_interval(n, (P, B), dev)
    for t in range(spine_steps):
        j = e_pb - 1 - t
        active = j >= s_pb
        ext = bd.extend_backward(bi, spine, char_at(j))
        spine = BiInterval(*[torch.where(active, a, b) for a, b in zip(ext, spine)])

    # ---- pool init: slot 0 = spine, mm 0
    slot0 = (torch.arange(n_slots, device=dev) == 0)[None, None, :]
    iv = BiInterval(*[torch.where(slot0, f[:, :, None], 0) for f in spine])
    mm = torch.zeros((P, B, n_slots), dtype=I32, device=dev)
    overflow_pb = torch.zeros((P, B), dtype=torch.bool, device=dev)
    codes = torch.arange(4, dtype=I32, device=dev)

    def compact(iv4, mm4, slots):
        flat_iv = BiInterval(*[f.reshape(P * B, -1) for f in iv4])
        p_iv, p_mm, live = _compact_pool(flat_iv, mm4.reshape(P * B, -1), slots)
        return (
            BiInterval(*[f.reshape(P, B, slots) for f in p_iv]),
            p_mm.reshape(P, B, slots),
            live.reshape(P, B),
        )

    def expand_step(iv, mm, ovf, c, budget, active, extend_all4):
        """One masked all-4 expansion + compaction.  With ``narrow_left``
        each parent's children are reordered exact-first and the pool laid
        out child-rank-major, so overflow truncation drops the highest-mm
        states first."""
        all4 = extend_all4(bi, iv)  # fields (P, B, S, 4)
        child_mm = mm[..., None] + (codes != c[..., None, None]).to(I32)
        ok = child_mm <= budget[..., None, None]
        pool_iv = BiInterval(
            torch.where(ok, all4.lo, 0), torch.where(ok, all4.hi, 0), all4.rlo, all4.rhi
        )
        if narrow_left:
            perm = torch.argsort(
                (codes != c[..., None]).to(I32) * 4 + codes, dim=-1
            )  # (P, B, 4) — exact child first, then code order (keys unique)
            pb4 = perm[:, :, None, :]

            def reorder(f):  # (P, B, S, 4) -> (P, B, 4, S), child-rank-major
                return torch.gather(f, -1, pb4.expand(f.shape)).transpose(2, 3)

            pool_iv = BiInterval(*[reorder(f) for f in pool_iv])
            child_mm = reorder(child_mm)
        new_iv, new_mm, live = compact(pool_iv, child_mm, n_slots)
        ovf = ovf | (active & (live > n_slots))
        out_iv = BiInterval(
            *[torch.where(active[..., None], a, b) for a, b in zip(new_iv, iv)]
        )
        out_mm = torch.where(active[..., None], new_mm, mm)
        return out_iv, out_mm, ovf

    for t in range(fwd_steps):
        j = e_pb + t  # (P, B)
        active = j < lengths[None, :]
        jcap = torch.minimum(j, lengths[None, :] - 1)
        piece_of_j = (bounds[None, :, :] <= jcap[:, :, None]).sum(dim=2, dtype=I32) - 1
        budget = piece_of_j - lane_piece
        iv, mm, overflow_pb = expand_step(
            iv, mm, overflow_pb, char_at(j), budget, active, bd.extend_forward_all4
        )

    if narrow_left:
        # leftward narrowing: extend every surviving state back through
        # the pieces BEFORE its anchor piece under the full k budget
        bwd_steps = -(-(Lb * (P - 1)) // P)  # lane P-1 walks the most
        full_budget = torch.full((P, B), k, dtype=I32, device=dev)
        for t in range(bwd_steps):
            j = s_pb - 1 - t  # (P, B)
            iv, mm, overflow_pb = expand_step(
                iv, mm, overflow_pb, char_at(j), full_budget, j >= 0,
                bd.extend_backward_all4,
            )

    # final states: compact to the keep-window before the (costly) locate
    iv, mm, live_final = compact(iv, mm, keep)
    overflow_pb = overflow_pb | (live_final > keep)

    # -> candidate loci (read start = occ - s_i), ONE locate for all pieces.
    # Dead lanes are pinned to row 0: the sparse-SA LF walk on scattered
    # rows would spread its gathers over the whole index.
    rows = iv.lo[..., None] + torch.arange(hits_per_state, dtype=I32, device=dev)
    valid = rows < iv.hi[..., None]
    rows = torch.where(valid, rows, 0)
    pos = rank.locate(bi.fwd, rows.clamp(0, n).reshape(-1)).reshape(rows.shape)
    # narrowed states span the WHOLE read, so their occurrence IS the read
    # start; suffix-only states start at their piece
    cand_off = torch.zeros_like(s_pb) if narrow_left else s_pb
    cand = torch.where(valid, pos - cand_off[..., None, None], NO_CAND)  # (P,B,keep,H)
    overflow_pb = overflow_pb | torch.any((iv.hi - iv.lo) > hits_per_state, dim=2)
    overflow = torch.any(overflow_pb, dim=0)
    cand = cand.permute(1, 0, 2, 3).reshape(B, P * keep * hits_per_state)
    return _dedupe_cands(cand, overflow, None)
