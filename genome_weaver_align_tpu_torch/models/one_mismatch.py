"""1-mismatch bidirectional BWT search (acceptance config 2) in torch: the
counterpart of ``genome_weaver_align_tpu.models.one_mismatch``.

Search scheme (the k=1 optimum scheme): split each read P = P1 P2 at mid.

  Case A: P1 exact (built backward), then forward extension through P2
          allowing <= 1 substitution (spine keeps 0 mm; each step spawns
          3 single-mismatch branches that must finish exactly).
  Case B: P2 exact (built backward from the end), then backward extension
          through P1 requiring exactly 1 substitution (branches only).

The two cases are disjoint (error side) and complete for Hamming distance 1.
The per-read search state is a dense (B, S) slot tensor of synchronized
bidirectional intervals advanced in lockstep; dead slots are packed to the
front each step with a stable argsort, and slot overflow is flagged per
read, never silently dropped.  On a CUDA device both cases are one kernel
(``csrc/one_mismatch.cu``, one warp a read).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from genome_weaver_align_tpu_torch.utils import sam

from . import bidirectional as bd
from . import exact as exact_mod
from .bidirectional import BiInterval, DeviceBiIndex
from ..ops import one_mismatch_cuda, rank

I32 = torch.int32


class MMState(NamedTuple):
    spine: BiInterval  # (B,)
    br: BiInterval  # (B, S) single-mismatch branches
    overflow: torch.Tensor  # (B,) bool


def _compact(br: BiInterval) -> tuple[BiInterval, torch.Tensor]:
    """Pack live slots (width > 0) to the front; returns (state, live_count)."""
    alive = br.hi > br.lo
    order = torch.argsort((~alive).to(I32), dim=1, stable=True)
    packed = BiInterval(*[torch.gather(f, 1, order) for f in br])
    return packed, alive.sum(dim=1, dtype=I32)


def _spawn(br: BiInterval, count, all4: BiInterval, c, overflow):
    """Write the 3 wrong-char extensions of the spine into free slots."""
    S = br.lo.shape[1]
    slots = torch.arange(S, dtype=I32, device=count.device)[None, :]
    n_live_spawn = torch.zeros_like(count)
    fields = list(br)
    for t in range(3):
        wc = (t + (t >= c).to(I32))[:, None].long()  # t-th code != c
        vals = [torch.gather(f, 1, wc)[:, 0] for f in all4]
        live = vals[1] > vals[0]
        slot = count + n_live_spawn
        overflow = overflow | (live & (slot >= S))
        mask = (slots == slot[:, None]) & live[:, None]
        fields = [torch.where(mask, v[:, None], f) for f, v in zip(fields, vals)]
        n_live_spawn = n_live_spawn + live.to(I32)
    return BiInterval(*fields), overflow


def _steps(L: int, max_len: int | None) -> int:
    """Each case's step count.  Its lanes are all inactive after ceil(L/2)
    steps (mid = len // 2), and an inactive step changes nothing: its
    compaction of an already packed pool is the identity.  The JAX loops
    run L steps."""
    return min(L if max_len is None else max_len, (L + 1) // 2)


def one_mismatch_candidates(
    bi: DeviceBiIndex,
    reads: torch.Tensor,  # (B, L) int32 search codes
    lengths: torch.Tensor,  # (B,)
    max_len: int | None = None,
    n_slots: int = 48,
):
    """Candidate fwd-index SA intervals for all <=1-substitution matches.

    Returns (cand_lo, cand_hi) of shape (B, 2*n_slots + 1) — case-A spine
    (exact match) in slot 0, then case-A branches, then case-B branches —
    plus an overflow flag (B,).  Empty candidates have hi <= lo.  On a CUDA
    device the whole search is one kernel (``csrc/one_mismatch.cu``, one
    warp a read); on the CPU, ``one_mismatch_candidates_plain``.
    """
    if not reads.is_cuda:
        return one_mismatch_candidates_plain(bi, reads, lengths, max_len, n_slots)
    return one_mismatch_cuda.one_mismatch_candidates_cuda(
        bi, reads.to(I32).contiguous(), lengths.to(I32).contiguous(),
        _steps(reads.shape[1], max_len), n_slots)


def one_mismatch_candidates_plain(
    bi: DeviceBiIndex,
    reads: torch.Tensor,
    lengths: torch.Tensor,
    max_len: int | None = None,
    n_slots: int = 48,
):
    """``one_mismatch_candidates`` as a loop of torch ops over all reads at
    once, one sequential step an iteration (the kernel's plain version)."""
    B, L = reads.shape
    dev = reads.device
    reads = reads.to(I32)
    lengths = lengths.to(I32)
    steps = _steps(L, max_len)
    mid = torch.div(lengths, 2, rounding_mode="floor")
    n = bi.fwd.n

    def char_at(j):  # lanes past the read are inactive: any in-range code
        return torch.gather(reads, 1, j.clamp(0, L - 1)[:, None].long())[:, 0]

    def masked(active, new: BiInterval, old: BiInterval) -> BiInterval:
        return BiInterval(*rank.step_where(active, new, old))

    def build_backward(first, last_excl):
        """Spine = read[first(b) : last_excl(b)] built by backward extension."""
        st = bd.init_interval(n, (B,), dev)
        for t in range(steps):
            j = last_excl - 1 - t
            st = masked(j >= first, bd.extend_backward(bi, st, char_at(j)), st)
        return st

    def search(spine, j_of, active_of, extend, extend_all4):
        state = MMState(
            spine,
            BiInterval(*[torch.zeros((B, n_slots), dtype=I32, device=dev) for _ in range(4)]),
            torch.zeros(B, dtype=torch.bool, device=dev),
        )
        for t in range(steps):
            j = j_of(t)
            active = active_of(j)
            c = char_at(j)
            br, count = _compact(extend(bi, state.br, c[:, None]))
            all4 = extend_all4(bi, state.spine)
            spine_new = BiInterval(*[torch.gather(f, 1, c[:, None].long())[:, 0] for f in all4])
            br2, ovf = _spawn(br, count, all4, c, state.overflow)
            # inactive lanes keep their state: their pool is already packed
            state = MMState(
                masked(active, spine_new, state.spine),
                masked(active[:, None], br2, state.br),
                torch.where(active, ovf, state.overflow),
            )
        return state

    # ---- Case A: P1 exact, forward through P2 with <=1 mismatch
    stA = search(build_backward(torch.zeros_like(mid), mid), lambda t: mid + t,
                 lambda j: j < lengths, bd.extend_forward, bd.extend_forward_all4)
    # ---- Case B: P2 exact (backward build), backward through P1, exactly 1 mm
    stB = search(build_backward(mid, lengths), lambda t: mid - 1 - t,
                 lambda j: j >= 0, bd.extend_backward, bd.extend_backward_all4)

    cand_lo = torch.cat([stA.spine.lo[:, None], stA.br.lo, stB.br.lo], dim=1)
    cand_hi = torch.cat([stA.spine.hi[:, None], stA.br.hi, stB.br.hi], dim=1)
    return cand_lo, cand_hi, stA.overflow | stB.overflow


class OneMismatchAligner:
    """Acceptance config 2 as a first-class aligner: bidirectional k=1
    search scheme -> candidate intervals -> locate -> SAM.  FM-space
    branches guarantee <=1 substitution, so no DP verify is needed; the
    mismatch count for NM is a direct text comparison at the located
    position.  Needs the index's reverse text (``gi.rev``)."""

    def __init__(self, gi, device: str | torch.device = "cuda"):
        self.gi = gi
        self.device = torch.device(device)
        self.bi = bd.from_host_bi(gi.fwd, gi.rev, self.device)
        self.fm = self.bi.fwd

    def _strand(self, search: np.ndarray, lengths: np.ndarray):
        from .pipeline import _to_device

        cand_lo, cand_hi, ovf = one_mismatch_candidates(
            self.bi, _to_device(search, self.device), _to_device(lengths, self.device)
        )
        B, C = cand_lo.shape
        pos, valid = exact_mod.locate_hits(self.fm, cand_lo.reshape(-1), cand_hi.reshape(-1), 2)
        pos = torch.where(valid, pos, 2**30).reshape(B, C * 2)
        best = pos.min(dim=1).values  # deterministic: smallest locus
        out = torch.stack([best, ovf.to(I32)]).cpu().numpy()  # one transfer
        return out[0], out[1].astype(bool)

    def align_batch(self, reads):
        from .pipeline import ApproxHit, reads_to_batch_verify, revcomp_verify_batch

        lengths = np.array([len(r) for r in reads], dtype=np.int32)
        vf = reads_to_batch_verify(reads)
        sfwd = np.where(vf >= 4, 0, vf).astype(np.int32)
        vrc = revcomp_verify_batch(vf, lengths)
        src = np.where(vrc >= 4, 0, vrc).astype(np.int32)

        bf, of = self._strand(sfwd, lengths)
        br, orr = self._strand(src, lengths)
        take_r = br < bf
        pos = np.where(take_r, br, bf).astype(np.int64)
        strand = take_r.astype(np.int64)
        mapped = pos < 2**30

        vsel = np.where(strand[:, None] == 0, vf, vrc)
        out = []
        for i in range(len(reads)):
            if not mapped[i]:
                out.append(None)
                continue
            l = int(lengths[i])
            codes = vsel[i, :l]
            win = self.gi.fwd.extract(int(pos[i]), l).astype(np.int64)
            mm = int((codes[: win.size] != win).sum() + (l - win.size))
            out.append(
                ApproxHit(int(pos[i]), int(strand[i]), mm, f"{l}M", 1, bool(of[i] or orr[i]))
            )
        return out

    def to_sam(self, reads, hits):
        from .pipeline import SuffixFilterAligner

        return SuffixFilterAligner.to_sam(self, reads, hits)

    def sam_header(self):
        return sam.header(self.gi.genome.names, self.gi.genome.lengths, prog="gwa-torch")
