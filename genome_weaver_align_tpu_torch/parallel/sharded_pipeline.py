"""Interval-sharded approximate alignment: the torch counterpart of
``genome_weaver_align_tpu.parallel.sharded_pipeline``.

Per batch, with the index, the genome text and the seed table split into S
interval shards on one device:

1. piece exact search  — every interval update answered by the owning BWT
                         shard, partials merged by a sum over the shards;
   (seed path)         — each probe's k-mer answered by the shard that owns
                         its k-mer range, one merge of the candidates;
2. sparse-SA locate    — merges per LF step (FM path);
3. candidate dedup     — sort + neighbour mask;
4. window gather       — each genome position contributed by the shard that
                         owns it, merged;
5. banded DP verify    — one verify over all (B, Cs*S) candidates, NO_CAND
                         padding giving INF.  The JAX package splits this
                         across the interval axis and all_gathers the
                         distances; on one device the split buys nothing;
6. best hit            — deterministic (dist, pos) order.

The verify runs the hand-written banded-DP kernel on a CUDA device and its
plain version on the CPU (``ops.dp.banded_edit_distance_best``).
"""

from __future__ import annotations

import copy
import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..models import suffix_filter as sf
from ..models.pipeline import (
    ApproxHit,
    SuffixFilterAligner,
    check_k,
    reads_to_batch_verify,
    revcomp_verify_batch,
)
from ..ops import affine
from ..ops import dp as dp_ops
from ..ops.rank import _upload
from ..utils import sam as sam_mod
from . import mesh as pmesh
from . import multihost as mh
from . import sharded_index as si

I32 = torch.int32


@dataclass(frozen=True)
class ShardedText:
    """Interval-sharded packed genome text for window gathers."""

    words: object  # (S, wlen) uint32 words (int32 bits on the device)
    base: object  # (S,) int32 — first base covered by this shard
    end: object  # (S,) int32
    n: int


def shard_text(text_words: np.ndarray, n: int, n_shards: int) -> ShardedText:
    total_words = text_words.size
    ws = -(-total_words // n_shards)
    words = np.zeros((n_shards, ws), dtype=np.uint32)
    base = np.zeros(n_shards, np.int32)
    end = np.zeros(n_shards, np.int32)
    for s in range(n_shards):
        w0 = s * ws
        w1 = min(total_words, w0 + ws)
        if w0 < total_words:
            words[s, : w1 - w0] = text_words[w0:w1]
        base[s] = min(w0 * 16, n)
        end[s] = min(w1 * 16, n)
    return ShardedText(words, base, end, n)


def put_text(tx: ShardedText, device) -> ShardedText:
    return dataclasses.replace(
        tx, words=_upload(tx.words, device), base=_upload(tx.base, device),
        end=_upload(tx.end, device),
    )


def local_gather_windows(tx: ShardedText, starts: torch.Tensor, width: int):
    """Each shard's contribution to the (Q, width) window codes and its
    ownership mask: two (S, Q, width) int32 tensors; the merge sums them.
    Positions outside the genome have no owner: the caller writes code 4
    where the merged mask is 0."""
    idx = starts.to(I32)[:, None] + torch.arange(width, dtype=I32, device=starts.device)[None, :]
    base, end = tx.base[:, None, None], tx.end[:, None, None]
    own = (idx[None] >= base) & (idx[None] < end)
    local = (idx[None] - base).clamp(min=0)
    S, wlen = tx.words.shape
    row = (local >> 4).clamp(0, wlen - 1).long() + (torch.arange(S, device=idx.device) * wlen)[:, None, None]
    codes = (tx.words.reshape(-1)[row] >> (2 * (local & 15))) & 3
    return torch.where(own, codes, 0), own.to(I32)


@dataclass(frozen=True)
class ShardedSeedTable:
    """CSR seed table sharded by k-mer range: shard s owns buckets
    [k_lo[s], k_hi[s]) and their positions slice."""

    offsets: object  # (S, nb_local + 1) int32 — local bucket starts
    positions: object  # (S, max_local) int32 — global genome positions
    k_lo: object  # (S,) int32 — first owned k-mer
    k_hi: object  # (S,) int32
    j: int


def shard_seed_table(
    offsets: np.ndarray, positions: np.ndarray, j: int, n_shards: int
) -> ShardedSeedTable:
    nk = offsets.size - 1
    if nk != 4**j:
        raise ValueError(f"seed table has {nk} buckets, expected 4^{j}")
    per = -(-nk // n_shards)
    max_local = 0
    parts = []
    for s in range(n_shards):
        k0, k1 = min(s * per, nk), min((s + 1) * per, nk)
        off = offsets[k0 : k1 + 1].astype(np.int64)
        pos = positions[off[0] : off[-1]]
        parts.append((k0, k1, (off - off[0]).astype(np.int32), pos))
        max_local = max(max_local, pos.size)
    off_arr = np.zeros((n_shards, per + 1), np.int32)
    pos_arr = np.zeros((n_shards, max(max_local, 1)), np.int32)
    k_lo = np.zeros(n_shards, np.int32)
    k_hi = np.zeros(n_shards, np.int32)
    for s, (k0, k1, off, pos) in enumerate(parts):
        off_arr[s, : off.size] = off
        off_arr[s, off.size :] = off[-1]
        pos_arr[s, : pos.size] = pos
        k_lo[s], k_hi[s] = k0, k1
    return ShardedSeedTable(off_arr, pos_arr, k_lo, k_hi, j)


def put_seed(st: ShardedSeedTable, device) -> ShardedSeedTable:
    return dataclasses.replace(
        st, offsets=_upload(st.offsets, device), positions=_upload(st.positions, device),
        k_lo=_upload(st.k_lo, device), k_hi=_upload(st.k_hi, device),
    )


def _take_shard_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table (S, R) at per-shard indices idx (S, ...)."""
    S, R = table.shape
    off = (torch.arange(S, device=idx.device) * R).reshape((S,) + (1,) * (idx.dim() - 1))
    return table.reshape(-1)[idx.long() + off]


def _dedupe(cand: torch.Tensor) -> torch.Tensor:
    B = cand.shape[0]
    cand = torch.sort(cand, dim=1).values
    dup = torch.cat(
        [torch.zeros((B, 1), dtype=torch.bool, device=cand.device), cand[:, 1:] == cand[:, :-1]],
        dim=1,
    )
    return torch.sort(torch.where(dup, sf.NO_CAND, cand), dim=1).values


def _verify_best(tx, reads, lengths, cand, k, W, n_interval):
    """Windows of every candidate (owner-computes + merge), one banded
    verify over the padded (B, Cs * S) candidates, best hit."""
    B, C = cand.shape
    Cs = -(-C // n_interval)
    pad = Cs * n_interval - C
    cand_p = torch.cat([cand, torch.full((B, pad), sf.NO_CAND, dtype=I32, device=cand.device)], dim=1)
    Cp = cand_p.shape[1]
    invalid = cand_p == sf.NO_CAND
    ws_all = torch.where(invalid, 0, cand_p - k).reshape(-1)
    part, own = local_gather_windows(tx, ws_all, W)
    wins = si.default_merge(torch.stack([part, own], dim=1))
    codes_all = torch.where(wins[1] > 0, wins[0], 4)
    r = reads.to(torch.int8).repeat_interleave(Cp, dim=0)
    ln = lengths.to(I32).repeat_interleave(Cp)
    dist, _ = dp_ops.banded_edit_distance_best(r, ln, codes_all.to(torch.int8), k)
    dist = torch.where(invalid, dp_ops.INF, dist.reshape(B, Cp))
    return sf.best_hit(cand_p, dist, k)


def make_sharded_seed_align(
    layout: pmesh.ShardLayout,
    *,
    like_seed: ShardedSeedTable,
    like_text: ShardedText = None,
    max_len: int,
    k: int,
    max_hits: int = 16,
):
    """Seed-path sharded align step: candidate generation needs one merge
    of the probe widths and one of the candidates, and no locate.  Returns
    fn(seed_shards, text_shards, reads, lengths) -> (best_pos, best_dist,
    n_good, overflow)."""
    n_pieces = k + 1
    n_interval = layout.n_interval
    W = max_len + 3 * k
    j = like_seed.j

    def fn(st, tx, reads, lengths):
        reads = reads.to(I32)
        lengths = lengths.to(I32)
        B = reads.shape[0]
        S = st.k_lo.shape[0]
        bounds = sf._piece_bounds(lengths, n_pieces)
        s, e = bounds[:, :-1], bounds[:, 1:]

        # 1. rare-seed probe widths: each probe's k-mer has ONE owner; the
        # merge makes every shard pick the same rarest probe (a zero-width
        # probe may win here, as in the JAX sharded step)
        idx, jstart = sf._seed_probe_idx(reads, s, e, j, sf.SEED_PROBES)  # (B, P, R)
        col = lambda v: v.reshape(S, 1, 1, 1)  # noqa: E731
        mine_all = (idx[None] >= col(st.k_lo)) & (idx[None] < col(st.k_hi))
        idx_loc = (idx[None] - col(st.k_lo)).clamp(0, st.offsets.shape[1] - 2)
        start_all = _take_shard_rows(st.offsets, idx_loc)
        end_all = _take_shard_rows(st.offsets, idx_loc + 1)
        width_all = si.default_merge(torch.where(mine_all, end_all - start_all, 0))
        r_best = torch.argmin(width_all, dim=2, keepdim=True)  # first min: deterministic

        def take(a):
            rb = r_best.expand(a.shape[:-1] + (1,))
            return torch.gather(a, a.dim() - 1, rb)[..., 0]

        start, end, mine = take(start_all), take(end_all), take(mine_all)
        jst, width = take(jstart), take(width_all)

        # 2. seed candidates: the owner of the chosen probe contributes, ONE
        # merge
        slots = start[..., None] + torch.arange(max_hits, dtype=I32, device=reads.device)
        valid_l = mine[..., None] & (slots < end[..., None])
        hit = _take_shard_rows(st.positions, slots.clamp(0, st.positions.shape[1] - 1))
        cand_part = torch.where(valid_l, hit - jst[None, ..., None], 0)
        cand_all = si.default_merge(cand_part.reshape(S, B, -1)).reshape(B, n_pieces, max_hits)
        overflow = torch.any(width > max_hits, dim=1)
        valid = torch.arange(max_hits, dtype=I32, device=reads.device) < width[..., None]
        cand = torch.where(valid, cand_all, sf.NO_CAND).reshape(B, -1)

        best = _verify_best(tx, reads, lengths, _dedupe(cand), k, W, n_interval)
        return best.best_pos, best.best_dist, best.n_good, overflow

    return fn


def make_sharded_pigeonhole_align(
    layout: pmesh.ShardLayout,
    *,
    like_index: si.ShardedFMIndex = None,
    like_text: ShardedText = None,
    max_len: int,
    k: int,
    max_hits: int = 8,
):
    """FM-path sharded align step: piece search and locate with merges per
    step.  Returns fn(index_shards, text_shards, reads, lengths) ->
    (best_pos, best_dist, n_good, overflow)."""
    n_pieces = k + 1
    n_interval = layout.n_interval
    W = max_len + 3 * k

    def fn(sh, tx, reads, lengths):
        reads = reads.to(I32)
        lengths = lengths.to(I32)
        B, L = reads.shape
        dev = reads.device
        bounds = sf._piece_bounds(lengths, n_pieces)
        s, e = bounds[:, :-1], bounds[:, 1:]

        # 1. piece search with per-step interval merges
        steps = (max_len + n_pieces - 1) // n_pieces + 1
        lo = torch.zeros((B, n_pieces), dtype=I32, device=dev)
        hi = torch.full((B, n_pieces), sh.n + 1, dtype=I32, device=dev)
        for t in range(steps):
            j = e - 1 - t
            active = (j >= s) & (lo < hi)
            c = torch.gather(reads, 1, j.clamp(0, L - 1).long())
            nlo, nhi = si.backward_step(sh, c, lo, hi)
            lo, hi = torch.where(active, nlo, lo), torch.where(active, nhi, hi)
        overflow = torch.any((hi - lo) > max_hits, dim=1)

        # 2. locate candidate rows (merged LF walk)
        rows = lo[:, :, None] + torch.arange(max_hits, dtype=I32, device=dev)[None, None, :]
        valid = rows < hi[:, :, None]
        pos = si.locate(sh, rows.clamp(0, sh.n).reshape(-1)).reshape(rows.shape)
        cand = torch.where(valid, pos - s[:, :, None], sf.NO_CAND).reshape(B, -1)

        best = _verify_best(tx, reads, lengths, _dedupe(cand), k, W, n_interval)
        return best.best_pos, best.best_dist, best.n_good, overflow

    return fn


class ShardedAligner:
    """``SuffixFilterAligner``-compatible facade over the sharded pipeline.

    Splits the index, the text and (when given) the seed table into
    ``n_interval`` interval shards on ``device`` and runs the merged
    pipeline per batch.  CIGARs come from the same fast-Hamming / host
    traceback split as the single-device aligner, over the full text, so
    the SAM bytes are the same whatever the shard count.
    """

    def __init__(
        self,
        gi,
        k: int = 2,
        n_interval: int = 2,
        max_hits: int = 8,
        seed_table=None,  # (offsets, positions) from index.seedtable
        seed_j: int = 0,
        overflow_fallback: bool = True,  # rerun budget-overflowed reads at
        # 4x hit budgets, as the JAX sharded aligner does
        device: str | torch.device = "cuda",  # the CPU only when asked for
    ):
        check_k(k)
        self.gi = gi
        self.k = k
        self.device = torch.device(device)
        # one device: the data axis would only pad the batch
        self.layout = pmesh.make_layout(1, n_interval, self.device)
        self.sst = None
        self.seed_j = 0
        if seed_table is not None and seed_j > 0:
            self.sst = put_seed(
                shard_seed_table(seed_table[0], seed_table[1], seed_j, n_interval), self.device
            )
            self.seed_j = seed_j
        # FM shards are always built: batches whose shortest read has pieces
        # < seed_j fall back to them
        self.sh = si.put_sharded(si.shard_fm_index(gi.fwd, n_interval), self.device)
        self.tx = put_text(shard_text(gi.fwd.text_words, gi.fwd.n, n_interval), self.device)
        self.max_hits = max_hits
        self.scored = True  # the same scored affine indel tail as the
        # single-device aligner
        self.overflow_fallback = overflow_fallback
        self._fb = None
        self._fns = {}
        self._text = _upload(gi.fwd.text_words, self.device)

    def _fn(self, L, use_seed: bool):
        key = (L, use_seed)
        if key not in self._fns:
            if use_seed:
                self._fns[key] = make_sharded_seed_align(
                    self.layout, like_seed=self.sst, like_text=self.tx, max_len=L,
                    k=self.k, max_hits=self.max_hits,
                )
            else:
                self._fns[key] = make_sharded_pigeonhole_align(
                    self.layout, like_index=self.sh, like_text=self.tx, max_len=L,
                    k=self.k, max_hits=self.max_hits,
                )
        return self._fns[key]

    def align_batch_submit(self, reads):
        """The CLI's two-phase API; the sharded step runs at finish."""
        return reads

    def align_batch_finish(self, handle):
        return self.align_batch(handle)

    def align_batch(self, reads):
        lengths = np.array([len(r) for r in reads], dtype=np.int32)
        vf = reads_to_batch_verify(reads)
        vrc = revcomp_verify_batch(vf, lengths)
        L = vf.shape[1]

        # gate the seed path on the SHORTEST read's pieces
        min_piece = int(lengths.min()) // (self.k + 1)
        use_seed = self.sst is not None and min_piece >= self.seed_j
        fn = self._fn(L, use_seed)
        tab = self.sst if use_seed else self.sh

        res = []
        for batch in (np.where(vf >= 4, 0, vf), np.where(vrc >= 4, 0, vrc)):
            r, l, _ = pmesh.shard_reads(self.layout, batch.astype(np.int32), lengths)
            out = fn(tab, self.tx, r, l)
            res.append(tuple(x[: len(reads)] for x in mh.gather_to_host(out)))
        (pf, df, nf, of), (pr, dr, nr, orr) = res
        df = np.where(df <= self.k, df, 1 << 20)
        dr = np.where(dr <= self.k, dr, 1 << 20)
        take_r = (dr < df) | ((dr == df) & (pr < pf))
        dist = np.where(take_r, dr, df).astype(np.int64)
        cand = np.where(take_r, pr, pf).astype(np.int64)
        strand = take_r.astype(np.int64)
        mapped = dist <= self.k

        # the single-device aligner's fast-Hamming CIGAR split
        vsel = np.where(strand[:, None] == 0, vf, vrc)
        dev = self.device
        ham, o_min = sf.offset_hamming(
            self._text,
            self.gi.fwd.n,
            torch.from_numpy(vsel.astype(np.int32)).to(dev),
            torch.from_numpy(lengths).to(dev),
            torch.from_numpy(np.where(mapped, cand, 0).astype(np.int32)).to(dev),
            self.k,
        )
        ham, o_min = torch.stack([ham, o_min]).cpu().numpy()

        # batched indel tail: banded traceback, then the scored affine
        # aligner supplies POS/CIGAR/AS/NM, as in the JAX sharded aligner
        fast = mapped & (ham == dist)
        ws_all = cand - self.k
        pos = np.where(mapped, ws_all + o_min, 0)
        cigars: dict[int, str] = {}
        aux: dict[int, tuple[int, int]] = {}
        slow_idx = np.nonzero(mapped & ~fast)[0]
        if slow_idx.size:
            S = int(slow_idx.size)
            lmax = int(lengths[slow_idx].max())
            Wb = lmax + 3 * self.k
            vcodes = np.zeros((S, lmax), dtype=np.int64)
            wins = np.full((S, Wb), 4, dtype=np.int64)
            lens_s = np.empty(S, dtype=np.int64)
            for t, i in enumerate(slow_idx):
                l = int(lengths[i])
                lens_s[t] = l
                vcodes[t, :l] = vsel[i, :l]
                ws = int(ws_all[i])
                s0 = max(0, ws)
                seg = self.gi.fwd.extract(s0, min(self.gi.fwd.n, ws + Wb) - s0)
                wins[t, s0 - ws : s0 - ws + seg.size] = seg
            dist_s, start_s, cig_s = dp_ops.traceback_banded_batch(vcodes, lens_s, wins, self.k)
            # clamp: a traceback beginning in the left pad of a window that
            # overhangs the genome start must not yield a negative coordinate
            pos[slow_idx] = np.maximum(ws_all[slow_idx] + start_s, 0)
            dist[slow_idx] = dist_s
            for t, i in enumerate(slow_idx):
                cigars[int(i)] = cig_s[t]
            if self.scored:
                sc_s, astart_s, acig_s, nm_s = affine.affine_banded_batch(
                    vcodes, lens_s, wins, self.k
                )
                pos[slow_idx] = np.maximum(ws_all[slow_idx] + astart_s, 0)
                for t, i in enumerate(slow_idx):
                    cigars[int(i)] = acig_s[t]
                    aux[int(i)] = (int(sc_s[t]), int(nm_s[t]))

        out = []
        for i in range(len(reads)):
            if not mapped[i]:
                out.append(None)
                continue
            score, nm = aux.get(int(i), (None, None))
            out.append(
                ApproxHit(
                    int(pos[i]), int(strand[i]), int(dist[i]),
                    cigars.get(i, f"{int(lengths[i])}M"), int(nf[i] + nr[i]),
                    bool(of[i] or orr[i]), score, nm,
                )
            )
        if self.overflow_fallback:
            idx = np.nonzero(np.asarray(of, bool) | np.asarray(orr, bool))[0]
            if idx.size:
                # the JAX aligner pads this cohort to a power of two only to
                # bound XLA retraces; each read's result is independent of
                # the others in its batch, so the port takes it as it is
                fh = self._get_fb().align_batch([reads[i] for i in idx])
                for t, i in enumerate(idx.tolist()):
                    out[i] = fh[t]
        return out

    def _get_fb(self) -> "ShardedAligner":
        """Fallback: 4x per-piece hit budgets, the same shards."""
        if self._fb is None:
            fb = copy.copy(self)
            fb.max_hits = self.max_hits * 4
            fb.overflow_fallback = False
            fb._fb = None
            fb._fns = {}
            self._fb = fb
        return self._fb

    def to_sam(self, reads, hits):
        return SuffixFilterAligner.to_sam(self, reads, hits)

    def sam_header(self):
        return sam_mod.header(self.gi.genome.names, self.gi.genome.lengths, prog="gwa-torch")
