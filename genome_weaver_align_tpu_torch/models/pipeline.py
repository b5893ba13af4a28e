"""Alignment pipeline: the k-edit ``SuffixFilterAligner`` in torch.

Torch counterpart of ``genome_weaver_align_tpu.models.pipeline``'s flagship
path.  Per batch: host 2-bit pack -> one device step for both strands
(unpack, candidates from the seed table or the FM pigeonhole search,
dedupe, lane compaction, window gather, banded DP verify, scatter-min best
hit, cross-strand pick, offset-Hamming fast-CIGAR check, 2-row packed
result) -> host finish (unpack, affine traceback for indel reads, tier-1
overflow fallback) -> SAM lines.  ``align_batch``/``to_sam`` are the
list-of-``Read`` API over the same arrays, which ``models.paired`` and the
CLI's FASTA and paired modes use.

The device step enqueues its work with fixed shapes and no host
synchronisation, so a driver that submits batch N+1 before finishing batch N
overlaps host work with device work, as the JAX package's async dispatch
does.

Not ported yet: the tier-2 staircase (reads tier 2 would take stay
overflow-flagged and are counted in ``last_stats["n_staircase_pending"]``),
and the exact, one-mismatch and long-read aligners.  The interval-sharded
aligner is ``parallel.sharded_pipeline.ShardedAligner``.
"""

from __future__ import annotations

import copy
import time
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from genome_weaver_align_tpu_torch.utils import dna, sam
from genome_weaver_align_tpu_torch.utils.fasta import Read

from ..ops import affine
from ..ops import dp as dp_ops
from ..ops import rank
from ..ops import window as window_ops
from . import suffix_filter

I32 = torch.int32


@dataclass
class ApproxHit:
    pos: int  # global genome start of the alignment (exact, post-traceback)
    strand: int
    dist: int
    cigar: str
    n_good: int  # candidates within threshold across both strands
    overflow: bool
    score: int | None = None  # native AS from the scored affine aligner
    nm: int | None = None  # NM of the *emitted* (score-optimal) alignment


class ArrayHits(NamedTuple):
    """Column-oriented batch result (array-native API).

    ``cigars`` holds only the non-trivial (indel) CIGARs keyed by read index;
    every other mapped read's CIGAR is ``f"{length}M"``.
    """

    mapped: np.ndarray  # (B,) bool
    pos: np.ndarray  # (B,) int64, 0 where unmapped
    strand: np.ndarray  # (B,) int64
    dist: np.ndarray  # (B,) int64 (>k where unmapped)
    n_good: np.ndarray  # (B,) int64
    overflow: np.ndarray  # (B,) bool
    lengths: np.ndarray  # (B,) int32
    cigars: dict[int, str]
    aux: dict[int, tuple[int, int]]  # read idx -> (AS, NM) from the scored
    # affine traceback (slow-path reads only; fast-path AS is exact from the
    # all-M alignment).  Required (no default): a {} default on a NamedTuple
    # field is class-level shared state and in-place mutation would leak
    # entries across batches.


class _PendingResult:
    """A submitted batch's packed device result and its host copy."""

    def __init__(self, dev: torch.Tensor):
        self.dev = dev
        self.host = None
        self.event = None

    def prefetch(self) -> None:
        """Start the device->host copy into pinned memory without waiting."""
        if self.host is None and self.dev.is_cuda:
            self.host = torch.empty(
                self.dev.shape, dtype=self.dev.dtype, pin_memory=True
            )
            self.host.copy_(self.dev, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()

    def numpy(self) -> np.ndarray:
        """Wait for the result and return it on the host."""
        if self.host is None:
            return self.dev.cpu().numpy()
        self.event.synchronize()
        return self.host.numpy()


def prefetch_result(handle) -> None:
    """Start the device->host copy of a submitted batch's packed result
    early: a ``non_blocking`` copy into pinned memory plus a CUDA event.
    Called by pipelined drivers right after submitting batch N+1, so the
    copy starts the moment the device finishes batch N instead of waiting
    for the host to reach ``align_arrays_finish``."""
    if handle and handle[0] == "uniform":
        handle[3].prefetch()


def hits_from_arrays(ah: ArrayHits) -> list[ApproxHit | None]:
    """ArrayHits -> per-read ApproxHit list (SAM-writer compatibility)."""
    cigar_cache = {int(l): f"{l}M" for l in np.unique(ah.lengths)}
    out: list[ApproxHit | None] = []
    cols = zip(
        ah.mapped.tolist(),
        ah.pos.tolist(),
        ah.strand.tolist(),
        ah.dist.tolist(),
        ah.n_good.tolist(),
        ah.overflow.tolist(),
        ah.lengths.tolist(),
    )
    for i, (m, p, st, d, g, o, l) in enumerate(cols):
        if not m:
            out.append(None)
        else:
            score, nm = ah.aux.get(i, (None, None))
            out.append(
                ApproxHit(p, st, d, ah.cigars.get(i, cigar_cache[l]), g, o, score, nm)
            )
    return out


def device_tables(gi, device, seed_table=None, kmer_table=None) -> dict:
    """Numpy index arrays -> the aligner's device tensors.

    ``gi.fwd`` (the numpy ``FMIndexData``) becomes a ``rank.DeviceFMIndex``
    ("fm"), and its packed text (uint32) int32 words with the same bits
    ("text"); ``seed_table`` is the CSR ``(offsets, positions)`` pair and
    ``kmer_table`` the ``(lo, hi)`` interval pair, each uploaded when
    given.  ``gi`` may be either package's ``GenomeIndex``: only these
    fields are read, so both packages can run on the same state.
    """
    words = np.ascontiguousarray(gi.fwd.text_words, dtype=np.uint32).view(np.int32)

    def pair(tab):
        if tab is None:
            return None
        return tuple(torch.as_tensor(np.asarray(a, dtype=np.int32)).to(device) for a in tab)

    return {
        "fm": rank.from_host(gi.fwd, device),
        "text": torch.from_numpy(words).to(device),
        "text_host": gi.fwd.text_words,
        "seed": pair(seed_table),
        "kmer": pair(kmer_table),
    }


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> device tensor; CUDA uploads go through pinned memory
    asynchronously, so they do not wait for work already queued."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class SuffixFilterAligner:
    """Acceptance configs 3-4: k-edit suffix filter (seed-table or FM
    pigeonhole candidates) + banded DP verify + SAM emission (the flagship
    pipeline)."""

    def __init__(
        self,
        gi,
        k: int = 2,
        max_hits_per_piece: int = 8,
        kmer_table=None,  # (lo, hi) numpy arrays from index.kmer, optional
        kmer_j: int = 0,
        verify_mode: str = "banded",  # banded | myers
        seed_table=None,  # (offsets, positions) from index.seedtable, optional
        seed_j: int = 0,
        max_cands: int | None = None,  # verify lanes per read after dedup;
        # default 8 (FM path) / 4*(k+1) (seed path, which proposes a superset)
        verify_slack: int = 6,  # batch-pooled verify budget (lanes/read avg);
        # 0 = per-read lanes (verify_candidates); >0 = compacted verify
        overflow_fallback: bool = True,  # rerun budget-overflowed reads with
        # FB_MULT-x hit/candidate budgets and per-read verify lanes
        scored: bool = True,  # emit indel CIGARs/POS/NM/AS from the scored
        # affine-gap aligner (ops.affine); selection stays edit-based
        seed_probes: int = suffix_filter.SEED_PROBES,
        device: str | torch.device = "cuda",  # the CPU only when asked for
    ):
        self.gi = gi
        self.k = k
        self.n_pieces = k + 1
        self.max_hits = max_hits_per_piece
        self.device = torch.device(device)
        use_kmer = kmer_table is not None and kmer_j > 0
        use_seed = seed_table is not None and seed_j > 0
        tables = device_tables(
            gi, self.device,
            seed_table=seed_table if use_seed else None,
            kmer_table=kmer_table if use_kmer else None,
        )
        self.fm = tables["fm"]
        self.text_words = tables["text"]
        self.text_host = tables["text_host"]
        self.verify_mode = verify_mode
        self.kmer_tab = tables["kmer"]
        self.kmer_j = kmer_j if use_kmer else 0
        self.seed_tab = tables["seed"]
        self.seed_j = seed_j if use_seed else 0
        if max_cands is None:
            max_cands = 4 * (k + 1) if self.seed_tab is not None else 8
        self.max_cands = max_cands
        self.verify_slack = verify_slack
        self.overflow_fallback = overflow_fallback
        self.scored = scored
        self.seed_probes = seed_probes
        self._fb: "SuffixFilterAligner | None" = None

    def _strand_pass(self, search_reads, verify_reads, lengths):
        """One strand: candidates -> verify -> per-read best, downloaded."""
        L = search_reads.shape[1]
        W = L + 3 * self.k
        dev = self.device
        search = _to_device(search_reads.astype(np.int32), dev)
        verify = _to_device(verify_reads.astype(np.int32), dev)
        lens = _to_device(lengths.astype(np.int32), dev)
        min_piece = int(lengths.min()) // self.n_pieces
        if self.seed_tab is not None and min_piece >= self.seed_j:
            cands = suffix_filter.seed_candidates(
                self.seed_tab[0], self.seed_tab[1], search, lens, self.n_pieces,
                self.seed_j, max_hits=self.max_hits, max_cands=self.max_cands,
                n_probes=self.seed_probes,
            )
        else:
            cands = suffix_filter.pigeonhole_candidates(
                self.fm, search, lens, self.n_pieces, self.max_hits,
                kmer_tab=self.kmer_tab, kmer_j=self.kmer_j,
                kmer_full_cover=bool(self.kmer_j and min_piece >= self.kmer_j),
                max_cands=self.max_cands,
            )
        if self.verify_slack and self.verify_mode == "banded":
            dist_c, cp_c, rid_c, ovf2 = suffix_filter.verify_candidates_compact(
                self.text_words, self.fm.n, verify, lens, cands.cand_pos,
                self.k, W, slack=self.verify_slack,
            )
            best = suffix_filter.best_hit_compact(rid_c, cp_c, dist_c, self.k, len(lengths))
            ovf = cands.overflow | ovf2
        else:
            if self.verify_mode == "myers":
                dist = suffix_filter.verify_candidates_myers(
                    self.text_words, self.fm.n, verify, lens, cands.cand_pos,
                    self.k, W, (L + 31) // 32,
                )
            else:
                dist, _ = suffix_filter.verify_candidates(
                    self.text_words, self.fm.n, verify, lens, cands.cand_pos, self.k, W,
                )
            best = suffix_filter.best_hit(cands.cand_pos, dist, self.k)
            ovf = cands.overflow
        # ONE transfer for all four results
        out = torch.stack([best.best_pos, best.best_dist, best.n_good, ovf.to(I32)]).cpu().numpy()
        return out[0], out[1], out[2], out[3].astype(bool)

    def align_batch(self, reads: list[Read]) -> list[ApproxHit | None]:
        """Submit + finish in one call (see align_batch_submit for the
        pipelined two-phase API used by streaming drivers)."""
        return self.align_batch_finish(self.align_batch_submit(reads))

    def align_batch_submit(self, reads: list[Read]):
        """List-of-Read wrapper over the array-native submit."""
        lengths = np.array([len(r) for r in reads], dtype=np.int32)
        verify_fwd = reads_to_batch_verify(reads)
        return ("reads", reads, self.align_arrays_submit(verify_fwd, lengths))

    def align_batch_finish(self, handle) -> list[ApproxHit | None]:
        _, reads, inner = handle
        return hits_from_arrays(self.align_arrays_finish(inner))

    def align_arrays_submit(self, verify_fwd: np.ndarray, lengths: np.ndarray):
        """Array-native submit: enqueue device work for a (B, L) code batch.

        Uniform-length batches run the fused step, which is enqueued
        without waiting for the device; ragged batches are handled at
        finish through ``_strand_pass``."""
        L = verify_fwd.shape[1]
        if not bool(np.all(lengths == L)):
            return ("general", lengths, verify_fwd)
        min_piece = L // self.n_pieces
        use_seed = self.seed_tab is not None and min_piece >= self.seed_j
        rwords, nmask = pack_reads_2bit(verify_fwd)
        dev = self.device
        out_dev = _fused_align_step_impl(
            self.fm,
            self.text_words,
            self.kmer_tab,
            self.seed_tab if use_seed else None,
            _to_device(rwords.view(np.int32), dev),
            _to_device(nmask.view(np.int32), dev),
            _to_device(np.asarray(lengths, dtype=np.int32), dev),
            L=L,
            k=self.k,
            n_pieces=self.n_pieces,
            max_hits=self.max_hits,
            kmer_j=self.kmer_j,
            kmer_full_cover=bool(self.kmer_j and min_piece >= self.kmer_j),
            max_cands=self.max_cands,
            W=L + 3 * self.k,
            seed_j=self.seed_j if use_seed else 0,
            verify_slack=self.verify_slack,
            seed_probes=self.seed_probes,
        )
        return ("uniform", lengths, verify_fwd, _PendingResult(out_dev))

    def align_arrays_finish(self, handle) -> ArrayHits:
        kind = handle[0]
        if kind == "uniform":
            _, lengths, verify_fwd, pending = handle
            packed = pending.numpy()  # blocks here, not at submit
            cand, dist, take_r, n_good, ovf, ham, o_min = _unpack_result(packed, self.k)
            strand = take_r.astype(np.int64)
            mapped = dist <= self.k
            verify_rc = None  # built lazily for slow-path reads only
        else:
            _, lengths, verify_fwd = handle
            search_fwd = np.where(verify_fwd >= 4, 0, verify_fwd).astype(np.int32)
            verify_rc = revcomp_verify_batch(verify_fwd, lengths)
            search_rc = np.where(verify_rc >= 4, 0, verify_rc).astype(np.int32)
            pf, df, nf, of = self._strand_pass(search_fwd, verify_fwd, lengths)
            pr, dr, nr, orv = self._strand_pass(search_rc, verify_rc, lengths)

            # deterministic best across strands: (dist, pos, strand) order
            df = np.where(df <= self.k, df, 1 << 20)
            dr = np.where(dr <= self.k, dr, 1 << 20)
            take_r = (dr < df) | ((dr == df) & (pr < pf))
            dist = np.where(take_r, dr, df).astype(np.int64)
            cand = np.where(take_r, pr, pf).astype(np.int64)
            strand = take_r.astype(np.int64)
            mapped = dist <= self.k
            n_good = (nf + nr).astype(np.int64)
            ovf = of | orv

            # fast CIGAR path: pure-substitution alignments skip traceback
            vsel = np.where(strand[:, None] == 0, verify_fwd, verify_rc)
            dev = self.device
            ham, o_min = suffix_filter.offset_hamming(
                self.text_words,
                self.fm.n,
                _to_device(vsel.astype(np.int32), dev),
                _to_device(np.asarray(lengths, dtype=np.int32), dev),
                _to_device(np.where(mapped, cand, 0).astype(np.int32), dev),
                self.k,
            )
            ham, o_min = torch.stack([ham, o_min]).cpu().numpy()  # one sync, not two

        # vectorised assembly: pure-substitution alignments (the fast path)
        # resolve entirely with array ops; only indel reads need traceback
        fast = mapped & (ham == dist)
        pos = np.where(mapped, cand - self.k + o_min, 0)
        ws_all = cand - self.k
        cigars: dict[int, str] = {}
        aux: dict[int, tuple[int, int]] = {}

        slow_idx = np.nonzero(mapped & ~fast)[0]
        if slow_idx.size:
            # slow path (indels): one banded DP + lockstep traceback over
            # the whole cohort, on the host
            S = int(slow_idx.size)
            lmax = int(lengths[slow_idx].max())
            Wb = lmax + 3 * self.k
            vcodes = np.zeros((S, lmax), dtype=np.int64)
            lens_s = np.empty(S, dtype=np.int64)
            for t, i in enumerate(slow_idx):
                l = int(lengths[i])
                lens_s[t] = l
                st = int(strand[i])
                if verify_rc is None:  # uniform fast path: build RC lazily
                    row = verify_fwd[i]
                    vc = (
                        row
                        if st == 0
                        else dna.revcomp(row.astype(np.uint8)).astype(row.dtype)
                    )
                else:
                    vc = vsel[i]
                vcodes[t, :l] = vc[:l]
            # traceback windows decoded on the host: a device gather here
            # would queue behind the next pipelined batch's step
            wins = window_ops.gather_windows_host(
                self.text_host, self.fm.n, ws_all[slow_idx], Wb
            ).astype(np.int64)
            if self.scored:
                # scored emission: the affine engine alone supplies
                # CIGAR/POS/NM/AS; ``dist`` is already the banded edit
                # distance from the device verify.  Selection stays
                # edit-distance (the filter's completeness guarantee).
                sc_s, astart_s, acig_s, nm_s = affine.affine_banded_batch(
                    vcodes, lens_s, wins, self.k
                )
                # clamp: a traceback beginning in the left pad of a window
                # that overhangs the genome start must not go negative
                pos[slow_idx] = np.maximum(ws_all[slow_idx] + astart_s, 0)
                for t, i in enumerate(slow_idx):
                    cigars[int(i)] = acig_s[t]
                    aux[int(i)] = (int(sc_s[t]), int(nm_s[t]))
            else:
                dist_s, start_s, cig_s = dp_ops.traceback_banded_batch(
                    vcodes, lens_s, wins, self.k
                )
                pos[slow_idx] = np.maximum(ws_all[slow_idx] + start_s, 0)
                dist[slow_idx] = dist_s
                for t, i in enumerate(slow_idx):
                    cigars[int(i)] = cig_s[t]
        self.last_stats = {
            "n_slow_traceback": int(slow_idx.size),
            "n_mapped": int(mapped.sum()),
            "n_staircase_pending": 0,
        }
        ah = ArrayHits(
            mapped=mapped,
            pos=pos,
            strand=strand,
            dist=dist,
            n_good=np.asarray(n_good),
            overflow=np.asarray(ovf),
            lengths=np.asarray(lengths),
            cigars=cigars,
            aux=aux,
        )
        if self.overflow_fallback and bool(ah.overflow.any()):
            ah = self._apply_overflow_fallback(ah, verify_fwd, np.asarray(lengths))
        return ah

    FB_CHUNK = 4096  # tier-1 rerun chunk size: bounds the fallback step's
    # verify temps and gives one shape for any cohort size (the JAX value)

    FB_MULT = 16  # tier-1 fallback budget multiplier (the JAX value)

    def _get_fb(self) -> "SuffixFilterAligner":
        """Fallback aligner: FB_MULT-x hit/candidate budgets, per-read
        verify lanes.  Shares the device tables with the primary (a shallow
        copy, not a second upload) and differs only in its budgets."""
        if self._fb is None:
            fb = copy.copy(self)
            # absolute caps: 256/192 keep the default budgets (8/12 ->
            # 128/192) unchanged and bound the verify temps of larger ones
            fb.max_hits = min(self.max_hits * self.FB_MULT, 256)
            fb.max_cands = min(self.max_cands * self.FB_MULT, 192)
            fb.verify_slack = 0
            fb.overflow_fallback = False
            fb._fb = None
            self._fb = fb
        return self._fb

    def _apply_overflow_fallback(
        self, ah: ArrayHits, verify_fwd: np.ndarray, lengths: np.ndarray
    ) -> ArrayHits:
        """Rerun budget-overflowed reads through the fallback aligner.

        The fallback searches a strict superset (bigger budgets, no shared
        verify pool), so its result replaces the primary's wholesale.  Only
        UNMAPPED overflowed reads rerun; a read that mapped despite budget
        truncation keeps its hit with the XO multiplicity-floor flag.  The
        subset is padded to a power-of-two bucket (or FB_CHUNK chunks).

        Tier 2 (the staircase) is not ported: reads still overflowed and
        unmapped after tier 1 stay so, and are counted in
        ``last_stats["n_staircase_pending"]``, as the JAX aligner leaves
        them when it has no reverse-text index.
        """
        idx = np.nonzero(ah.overflow & ~ah.mapped)[0]
        if idx.size == 0:
            return ah
        _t0 = time.perf_counter()
        fb = self._get_fb()
        writable = lambda a: a if a.flags.writeable else a.copy()
        ah = ah._replace(
            mapped=writable(ah.mapped), pos=writable(ah.pos),
            strand=writable(ah.strand), dist=writable(ah.dist),
            n_good=writable(ah.n_good), overflow=writable(ah.overflow),
        )
        n = idx.size
        CH = self.FB_CHUNK
        if n <= CH:
            P = max(128, 1 << (int(n) - 1).bit_length())
            chunks = [(idx, P)]
        else:
            chunks = [(idx[o : o + CH], CH) for o in range(0, n, CH)]

        def _submit(ch, P):
            sel = np.concatenate([ch, np.full(P - ch.size, ch[0], ch.dtype)])
            return fb.align_arrays_submit(verify_fwd[sel], lengths[sel])

        still_parts = []
        pending = _submit(*chunks[0])
        prefetch_result(pending)
        for ci, (ch, P) in enumerate(chunks):
            nxt = _submit(*chunks[ci + 1]) if ci + 1 < len(chunks) else None
            prefetch_result(nxt)
            fh = fb.align_arrays_finish(pending)
            pending = nxt
            m = ch.size
            ah.mapped[ch] = fh.mapped[:m]
            ah.pos[ch] = fh.pos[:m]
            ah.strand[ch] = fh.strand[:m]
            ah.dist[ch] = fh.dist[:m]
            ah.n_good[ch] = fh.n_good[:m]
            ah.overflow[ch] = fh.overflow[:m]  # still set if even capped-x overflowed
            for t, i in enumerate(ch.tolist()):
                if t in fh.cigars:
                    ah.cigars[i] = fh.cigars[t]
                else:
                    ah.cigars.pop(i, None)
                if t in fh.aux:
                    ah.aux[i] = fh.aux[t]
                else:
                    ah.aux.pop(i, None)
            still_parts.append(
                ch[
                    np.asarray(fh.overflow[:m], dtype=bool)
                    & ~np.asarray(fh.mapped[:m], dtype=bool)
                ]
            )
        self.last_stats["n_overflow_fallback"] = int(n)
        self.last_stats["t_tier1_ms"] = round((time.perf_counter() - _t0) * 1e3, 1)
        self.last_stats["n_staircase_pending"] = int(sum(p.size for p in still_parts))
        return ah

    def to_sam_lines(
        self,
        names,
        codes: np.ndarray,
        lengths: np.ndarray,
        ah: ArrayHits,
        quals: np.ndarray | None = None,
    ) -> list[str]:
        """Vectorised SAM emission straight from ArrayHits (column-wise
        assembly; see utils.sam.lines_from_arrays)."""
        return sam.lines_from_arrays(
            names,
            codes,
            lengths,
            ah,
            self.gi.genome.names,
            np.asarray(self.gi.genome.offsets),
            quals=quals,
            scored=self.scored,
        )

    def to_sam(self, reads: list[Read], hits) -> list[sam.SamRecord]:
        recs = []
        for r, h in zip(reads, hits):
            if h is None:
                recs.append(sam.unmapped(r.name, r.codes, r.qual))
                continue
            ci, local = self.gi.genome.coord(h.pos)
            # native AS: slow-path reads carry the affine traceback's score;
            # fast-path alignments are all-M with h.dist mismatches, whose
            # affine score is exact in closed form (no gaps)
            if h.score is not None:
                score, nm = h.score, h.nm
            elif getattr(self, "scored", False):
                score = 1 * (len(r) - h.dist) - 4 * h.dist
                nm = h.dist
            else:
                score, nm = None, h.dist
            recs.append(
                sam.mapped(
                    r.name,
                    r.codes,
                    self.gi.genome.names[int(ci[0])],
                    int(local[0]),
                    h.strand,
                    h.cigar,
                    edit_distance=nm,
                    mapq=37 if h.n_good == 1 else (3 if h.n_good > 1 else 0),
                    qual=r.qual,
                    n_hits=h.n_good,
                    overflow=h.overflow,
                    score=score,
                )
            )
        return recs

    def sam_header(self) -> str:
        return sam.header(self.gi.genome.names, self.gi.genome.lengths, prog="gwa-torch")


def reads_to_batch_verify(reads: list[Read]) -> np.ndarray:
    """(B, L) int32 with N kept as 4 (counts as an edit in verify)."""
    L = max(len(r) for r in reads)
    if all(len(r) == L for r in reads):  # uniform: one vectorised stack
        return np.stack([r.codes for r in reads]).astype(np.int32)
    out = np.zeros((len(reads), L), dtype=np.int32)
    for i, r in enumerate(reads):
        out[i, : len(r)] = r.codes
    return out


def revcomp_verify_batch(batch: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    L = batch.shape[1]
    if np.all(lengths == L):  # uniform-length fast path
        rc = batch[:, ::-1]
        return np.where(rc < 4, 3 - rc, rc).astype(batch.dtype)
    out = np.zeros_like(batch)
    for i in range(batch.shape[0]):
        l = int(lengths[i])
        out[i, :l] = dna.revcomp(batch[i, :l].astype(np.uint8))
    return out


def pack_reads_2bit(verify_fwd: np.ndarray):
    """Host-side 2-bit pack of a (B, L) verify-code batch + N bitmask.

    2 bits/base + 1 N-mask bit cuts the upload about 3.5x against int8
    codes; the device unpacks with two shifts inside the fused step.
    Host copy of the JAX package's function (tests pin the two)."""
    B, L = verify_fwd.shape
    W16 = (L + 15) // 16
    W32 = (L + 31) // 32
    # byte-wise pack (uint8 ops on L/4 columns, then a little-endian u32
    # view — bit k of word w is base 16w + k/2, matching the device
    # unpack)
    c = np.zeros((B, W16 * 16), np.uint8)
    cl = verify_fwd.astype(np.uint8, copy=False)
    isn = cl >= 4
    c[:, :L] = np.where(isn, 0, cl)
    b4 = (
        c[:, 0::4]
        | (c[:, 1::4] << 2)
        | (c[:, 2::4] << 4)
        | (c[:, 3::4] << 6)
    )
    rwords = np.ascontiguousarray(b4).view("<u4")
    nm = np.packbits(isn, axis=1, bitorder="little")
    nmb = np.zeros((B, W32 * 4), np.uint8)
    nmb[:, : nm.shape[1]] = nm
    nmask = nmb.view("<u4")
    return rwords, nmask


def _unpack_reads_2bit(rwords: torch.Tensor, nmask: torch.Tensor, L: int) -> torch.Tensor:
    """Device-side inverse of pack_reads_2bit -> (B, L) int32 verify codes.

    The words arrive as int32 with the uint32 bits: an arithmetic shift by
    at most 31 followed by the mask reads the same bits."""
    pos = torch.arange(L, dtype=I32, device=rwords.device)
    w = rwords[:, (pos >> 4).long()]
    code = (w >> (2 * (pos & 15))) & 3
    nb = (nmask[:, (pos >> 5).long()] >> (pos & 31)) & 1
    return torch.where(nb != 0, 4, code)


def _pack_result(cand, dist, take_r, n_good, ovf, ham, o_min, k):
    """Pack the per-read result columns into TWO int32 rows (bitfield) —
    the download is 8 bytes/read instead of 28.  Saturations are
    harmless: dist saturates at 15 (> any k <= 4 = unmapped), ham at 511
    (only compared against dist <= k), o_min at 31 (range <= 3k), n_good
    at 255 (the SAM X0 cap is 8)."""
    bf = (
        dist.clamp(0, 15)
        | (take_r.to(I32) << 4)
        | (ovf.to(I32) << 5)
        | (o_min.clamp(0, 31) << 6)
        | (ham.clamp(0, 511) << 11)
        | (n_good.clamp(0, 255) << 20)
    )
    return torch.stack([cand.to(I32), bf.to(I32)])


_RESULT_INF = 1 << 20


def _unpack_result(packed: np.ndarray, k: int):
    """Host-side inverse of _pack_result -> the 7 result columns."""
    cand = packed[0].astype(np.int64)
    bf = packed[1]
    dist = (bf & 15).astype(np.int64)
    dist = np.where(dist > k, _RESULT_INF, dist)  # 15 == saturated INF
    take_r = (bf >> 4) & 1
    ovf = ((bf >> 5) & 1).astype(bool)
    o_min = (bf >> 6) & 31
    ham = (bf >> 11) & 511
    n_good = ((bf >> 20) & 255).astype(np.int64)
    return cand, dist, take_r, n_good, ovf, ham, o_min


def _fused_align_step_impl(
    fm, text_words, kmer_tab, seed_tab, rwords, nmask, lengths,
    *, L, k, n_pieces, max_hits, kmer_j, kmer_full_cover, max_cands, W,
    seed_j=0, verify_slack=0, seed_probes=suffix_filter.SEED_PROBES,
):
    """Whole per-batch device step: both strands, candidates (the seed
    table when given, else the FM pigeonhole search), verify, cross-strand
    best, fast-CIGAR hamming -> (2, B) int32 packed result.  Uniform-length
    batches only (device-side reverse complement).  Fixed shapes, no host
    synchronisation."""
    INF = dp_ops.INF
    vf = _unpack_reads_2bit(rwords, nmask, L)
    vrc = torch.where(vf < 4, 3 - vf, vf).flip(1)

    def strand_pass(vcodes):
        search = torch.where(vcodes >= 4, 0, vcodes)
        if seed_tab is not None and seed_j > 0:
            cands = suffix_filter.seed_candidates(
                seed_tab[0], seed_tab[1], search, lengths, n_pieces, seed_j,
                max_hits=max_hits, max_cands=max_cands, n_probes=seed_probes,
            )
        else:
            cands = suffix_filter.pigeonhole_candidates(
                fm, search, lengths, n_pieces, max_hits,
                kmer_tab=kmer_tab, kmer_j=kmer_j, kmer_full_cover=kmer_full_cover,
                max_cands=max_cands,
            )
        if verify_slack:
            dist_c, cp_c, rid_c, ovf2 = suffix_filter.verify_candidates_compact(
                text_words, fm.n, vcodes, lengths, cands.cand_pos, k, W,
                slack=verify_slack,
            )
            best = suffix_filter.best_hit_compact(rid_c, cp_c, dist_c, k, vcodes.shape[0])
            return best, cands.overflow | ovf2
        dist, _ = suffix_filter.verify_candidates(
            text_words, fm.n, vcodes, lengths, cands.cand_pos, k, W,
        )
        return suffix_filter.best_hit(cands.cand_pos, dist, k), cands.overflow

    bf, ovf_f = strand_pass(vf)
    br, ovf_r = strand_pass(vrc)

    df = torch.where(bf.best_dist <= k, bf.best_dist, INF)
    dr = torch.where(br.best_dist <= k, br.best_dist, INF)
    take_r = (dr < df) | ((dr == df) & (br.best_pos < bf.best_pos))
    dist = torch.where(take_r, dr, df)
    cand = torch.where(take_r, br.best_pos, bf.best_pos)
    n_good = bf.n_good + br.n_good
    ovf = ovf_f | ovf_r
    mapped = dist <= k

    vsel = torch.where(take_r[:, None], vrc, vf)
    ham, o_min = suffix_filter.offset_hamming(
        text_words, fm.n, vsel, lengths, torch.where(mapped, cand, 0), k,
    )
    return _pack_result(cand, dist, take_r, n_good, ovf, ham, o_min, k)
