"""Paired-end alignment: FR proper-pair classification and mate rescue.

Torch counterpart of ``genome_weaver_align_tpu.models.paired``.  The
single-end pipeline aligns both mates; pairing logic then classifies
FR-oriented pairs within the insert-size window as proper pairs and rescues
half-mapped pairs: the unmapped mate is verified directly against the
expected insert window next to its mapped mate with the Myers bit-parallel
engine (``ops.myers``: the hand-written CUDA kernel on the card), one
batched pass over all half-mapped pairs, no FM search needed.

SAM pair semantics: flags 0x1/0x2/0x8/0x20/0x40/0x80, RNEXT '=' for
same-contig mates, PNEXT, signed TLEN (leftmost mate positive).

The JAX package pads the rescue cohort to a power-of-two bucket to bound
XLA recompiles and slices the results back; the port runs eagerly, so it
takes the cohort as it is.  Each lane's result does not depend on the
others, so the output is the same.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from genome_weaver_align_tpu_torch.utils import dna, sam
from genome_weaver_align_tpu_torch.utils.fasta import Read

from ..ops import affine, myers, window
from .pipeline import (
    ApproxHit,
    SuffixFilterAligner,
    _to_device,
    hits_from_arrays,
    reads_to_batch_verify,
)


@dataclass
class PairHit:
    h1: ApproxHit | None
    h2: ApproxHit | None
    proper: bool
    rescued: int  # 0 none, 1 = mate1 rescued, 2 = mate2 rescued


class PairedAligner:
    def __init__(
        self,
        aligner: SuffixFilterAligner,
        min_insert: int = 50,
        max_insert: int = 1000,
        rescue: bool = True,
    ):
        self.al = aligner
        self.min_insert = min_insert
        self.max_insert = max_insert
        self.rescue = rescue

    def _is_proper(self, h1: ApproxHit, h2: ApproxHit, l1: int, l2: int) -> bool:
        if h1.strand == h2.strand:
            return False
        fwd, fl, rev, rl = (
            (h1, l1, h2, l2) if h1.strand == 0 else (h2, l2, h1, l1)
        )
        tlen = (rev.pos + rl) - fwd.pos
        return fwd.pos <= rev.pos and self.min_insert <= tlen <= self.max_insert

    def _rescue_batch(self, jobs: list[tuple[np.ndarray, ApproxHit, int]]):
        """Batched mate rescue: ONE Myers verify over all half-mapped mates on
        the device, each against its insert window of the packed text, then
        ONE banded affine traceback for the accepted cohort on the host.

        Each job is (unmapped mate codes, anchor hit, anchor length); returns
        per-job ApproxHit | None."""
        J = len(jobs)
        lens = np.array([c.size for c, _, _ in jobs], dtype=np.int64)
        lmax = int(lens.max())
        W = self.max_insert - self.min_insert + lmax
        codes = np.zeros((J, lmax), dtype=np.int8)
        ws = np.empty(J, dtype=np.int64)
        strands = np.empty(J, dtype=np.int64)
        for t, (rcodes, anchor, anchor_len) in enumerate(jobs):
            l = rcodes.size
            if anchor.strand == 0:
                ws[t] = anchor.pos + self.min_insert - l
                strands[t] = 1
            else:
                ws[t] = anchor.pos + anchor_len - self.max_insert
                strands[t] = 0
            rc = rcodes if strands[t] == 0 else dna.revcomp(rcodes.astype(np.uint8))
            codes[t, :l] = rc

        dev = self.al.device
        # W is sized with the cohort max read length; columns beyond each
        # read's OWN insert window (max_insert - min_insert + len) never
        # match, so a shorter mate cannot be rescued outside its insert
        # bound.  On the card the kernel streams each window from the packed
        # text: no (J, W) window tensor is made
        own_w = (W - lmax) + lens  # (J,) per-job valid window length
        d, end = myers.myers_semiglobal_text(
            self.al.text_words, self.al.fm.n, _to_device(ws.astype(np.int32), dev),
            _to_device(codes, dev), _to_device(lens.astype(np.int32), dev),
            torch.arange(J, dtype=torch.int32, device=dev),
            _to_device(own_w.astype(np.int32), dev), W, (lmax + 31) // 32,
        )
        # ONE transfer for the accept stats
        d, end = torch.stack([d, end]).cpu().numpy().astype(np.int64)

        max_k = np.maximum(self.al.k, lens // 20)  # permissive rescue bar
        ok = np.nonzero(d <= max_k)[0]
        out: list[ApproxHit | None] = [None] * J
        if ok.size == 0:
            return out
        # narrow band around the Myers end column: the alignment spans
        # [end - l - d, end], so a k'-band window starting at end - l - k'
        # places the true start within slot range [k'-d, k'+d] within
        # [0, 2k'].  The band is decoded from the packed genome on the host
        # at absolute coordinates, with the same visibility rules as the big
        # window (4 outside [0, own_w)); k' is the static accept bound, so
        # the band does not depend on who else was in the batch.
        kp = max(1, self.al.k, lmax // 20)
        W2 = lmax + 3 * kp
        vcodes = codes[ok].astype(np.int64)
        ws2 = end[ok] - lens[ok] - kp  # local (big-window) coordinates
        col2 = np.arange(W2, dtype=np.int64)
        local = ws2[:, None] + col2[None, :]
        visible = (local >= 0) & (local < own_w[ok][:, None])
        wins2 = window.gather_windows_host(self.al.text_host, self.al.fm.n, ws[ok] + ws2, W2)
        wins2 = np.where(visible, wins2.astype(np.int64), 4)
        score, start, cigars, nm = affine.affine_banded_batch(vcodes, lens[ok], wins2, kp)
        for t, j in enumerate(ok.tolist()):
            pos = max(0, int(ws[j] + ws2[t] + start[t]))
            out[j] = ApproxHit(
                pos, int(strands[j]), int(d[j]), cigars[t], 1, False,
                int(score[t]), int(nm[t]),
            )
        return out

    def align_pairs(self, pairs: list[tuple[Read, Read]]) -> list[PairHit]:
        """List-of-Read pair alignment through the array-native path."""
        r1 = [p[0] for p in pairs]
        r2 = [p[1] for p in pairs]
        l1 = np.array([len(r) for r in r1], dtype=np.int32)
        l2 = np.array([len(r) for r in r2], dtype=np.int32)
        return self.align_pair_arrays(
            reads_to_batch_verify(r1), l1, reads_to_batch_verify(r2), l2
        )

    def align_pair_arrays(
        self,
        codes1: np.ndarray,  # (B, L1) verify codes (N = 4)
        lengths1: np.ndarray,
        codes2: np.ndarray,  # (B, L2)
        lengths2: np.ndarray,
    ) -> list[PairHit]:
        """Array-native pair alignment: both mates go through the fused
        array step (submitted together so the two device batches queue back
        to back), then ONE batched rescue pass for half-mapped pairs.
        ``last_phase_ms`` holds the host wall time of the two phases."""
        t0 = time.time()
        p1 = self.al.align_arrays_submit(codes1, lengths1)
        p2 = self.al.align_arrays_submit(codes2, lengths2)
        h1s = hits_from_arrays(self.al.align_arrays_finish(p1))
        pending = self.al.last_stats["n_staircase_pending"]
        h2s = hits_from_arrays(self.al.align_arrays_finish(p2))
        # mates left overflowed and unmapped for the unported tier 2
        self.last_staircase_pending = pending + self.al.last_stats["n_staircase_pending"]
        t1 = time.time()
        out = self._pair_and_rescue(codes1, lengths1, codes2, lengths2, h1s, h2s)
        self.last_phase_ms = {
            "align": round((t1 - t0) * 1e3, 1),
            "pair_rescue": round((time.time() - t1) * 1e3, 1),
        }
        return out

    def _pair_and_rescue(
        self, codes1, lengths1, codes2, lengths2, h1s, h2s
    ) -> list[PairHit]:
        # collect every half-mapped pair, rescue the whole cohort at once
        jobs, slots = [], []
        self.last_rescue_jobs = 0
        if self.rescue:
            for i, (h1, h2) in enumerate(zip(h1s, h2s)):
                if h1 is not None and h2 is None:
                    jobs.append((codes2[i, : lengths2[i]], h1, int(lengths1[i])))
                    slots.append((i, 2))
                elif h2 is not None and h1 is None:
                    jobs.append((codes1[i, : lengths1[i]], h2, int(lengths2[i])))
                    slots.append((i, 1))
        rescued_at = {}
        if jobs:
            self.last_rescue_jobs = len(jobs)
            for (i, mate), hit in zip(slots, self._rescue_batch(jobs)):
                if hit is not None:
                    (h2s if mate == 2 else h1s)[i] = hit
                    rescued_at[i] = mate
        out = []
        for i, (h1, h2) in enumerate(zip(h1s, h2s)):
            proper = (
                h1 is not None
                and h2 is not None
                and self._is_proper(h1, h2, int(lengths1[i]), int(lengths2[i]))
            )
            out.append(PairHit(h1, h2, proper, rescued_at.get(i, 0)))
        return out

    def to_sam(self, pairs: list[tuple[Read, Read]], hits: list[PairHit]):
        recs = []
        for (m1, m2), ph in zip(pairs, hits):
            recs.extend(self._pair_records(m1, m2, ph))
        return recs

    def _pair_records(self, m1: Read, m2: Read, ph: PairHit):
        gi = self.al.gi
        recs = []
        for mate_idx, (read, own, other, other_read) in enumerate(
            [(m1, ph.h1, ph.h2, m2), (m2, ph.h2, ph.h1, m1)]
        ):
            flag = 0x1 | (0x40 if mate_idx == 0 else 0x80)
            if ph.proper:
                flag |= 0x2
            if own is None:
                flag |= 0x4
            elif own.strand:
                flag |= 0x10
            if other is None:
                flag |= 0x8
            elif other.strand:
                flag |= 0x20

            if own is None:
                rec = sam.unmapped(read.name, read.codes, read.qual)
                rec.flag = flag | 0x4
                if other is not None:
                    ci, local = gi.genome.coord(other.pos)
                    rec.rname = gi.genome.names[int(ci[0])]
                    rec.pos = int(local[0])
                recs.append(rec)
                continue
            ci, local = gi.genome.coord(own.pos)
            # native AS/NM when the hit carries them (scored slow path or
            # batched rescue); all-M hits get the closed-form affine score
            if own.score is not None:
                score, nm = own.score, own.nm
            elif getattr(self.al, "scored", False):
                score, nm = 1 * (len(read) - own.dist) - 4 * own.dist, own.dist
            else:
                score, nm = None, own.dist
            rec = sam.mapped(
                read.name,
                read.codes,
                gi.genome.names[int(ci[0])],
                int(local[0]),
                own.strand,
                own.cigar,
                edit_distance=nm,
                mapq=37 if own.n_good == 1 else 3,
                qual=read.qual,
                score=score,
            )
            rec.flag = flag
            recs.append(rec)
        # mate linkage + TLEN
        r1, r2 = recs
        if not (r1.flag & 0x4) and not (r2.flag & 0x4):
            same = r1.rname == r2.rname
            tlen = 0
            if same:
                left = min(r1.pos, r2.pos)
                right = max(
                    r1.pos + _ref_span(r1.cigar), r2.pos + _ref_span(r2.cigar)
                )
                tlen = right - left
            recs = [
                _with_mate(r1, "=" if same else r2.rname, r2.pos,
                           tlen if r1.pos <= r2.pos else -tlen),
                _with_mate(r2, "=" if same else r1.rname, r1.pos,
                           tlen if r2.pos < r1.pos else -tlen),
            ]
        return recs


def _ref_span(cigar: str) -> int:
    import re

    return sum(int(c) for c, op in re.findall(r"(\d+)([MIDSH])", cigar) if op in "MD")


def _with_mate(rec: sam.SamRecord, rnext: str, pnext: int, tlen: int) -> sam.SamRecord:
    rec.rnext = rnext
    rec.pnext = pnext
    rec.tlen = tlen
    return rec
