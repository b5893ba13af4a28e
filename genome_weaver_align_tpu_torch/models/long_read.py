"""Long-read mapping by chunked seeding and diagonal voting, in torch.

Torch counterpart of ``genome_weaver_align_tpu.models.long_read``:

1. split the read into fixed ``seg_len`` segments (the tail segment is
   masked by the read length);
2. per segment, probe the CSR seed table with the rarest of ``n_probes``
   j-mers -> up to ``hits_per_seg`` genome positions -> candidate diagonals
   (hit minus the probe's offset in the whole read);
3. vote: the diagonal with the most diagonals of the read within ``band``
   above it wins (one sort and a (S*H, S*H) windowed count a read);
4. verify every segment on its own diagonal inside the winning cluster (or
   the cluster's, when it has none) with the banded DP at ``kb``, each
   segment's distance capped, summed over the read.

Step 4 runs the banded DP's text entry (``ops.dp.banded_edit_distance_text``:
on a CUDA device the hand-written kernel ``csrc/banded_dp.cu`` gathers each
segment's window from the 2-bit text itself), so neither the (B*S, W)
windows nor a per-lane read copy is made.  Mapped reads then get an exact
POS/CIGAR/AS/NM from one banded affine traceback over the whole read on the
host (``ops.affine``, half-width ``kb + band``).

Differences from the JAX package: the aligner uploads only the packed text
and the seed table (the JAX one also uploads the FM tables, of which it
reads only the text length), and it refuses a negative ``kb`` when built
(the JAX engine fails on it when it verifies: a band of 4 kb + 1 < 1
slots).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import affine
from ..ops import dp as dp_ops
from ..ops import window
from .pipeline import _to_device, revcomp_verify_batch
from .suffix_filter import NO_CAND, _all_jmers

I32 = torch.int32


class LongHits(NamedTuple):
    mapped: np.ndarray  # (B,) bool
    pos: np.ndarray  # (B,) int64 genome start (exact after traceback, else
    # the winning diagonal)
    strand: np.ndarray  # (B,)
    dist: np.ndarray  # (B,) NM of the traceback alignment (or the summed
    # per-segment banded distance without traceback)
    support: np.ndarray  # (B,) segments voting for the winning diagonal
    cigars: dict  # read idx -> CIGAR (traceback only)
    aux: dict  # read idx -> (AS, NM) from the affine traceback


def _chunk_vote_verify(
    offsets: torch.Tensor,  # (4^j + 1,) int32 CSR seed-table offsets
    positions: torch.Tensor,  # (P,) int32 seed-table positions
    text_words: torch.Tensor,  # (nw,) int32 packed text
    n_text: int,
    reads: torch.Tensor,  # (B, L) search codes (N -> 0)
    vreads: torch.Tensor,  # (B, L) verify codes (N = 4)
    lengths: torch.Tensor,  # (B,) int32
    *,
    j: int,
    seg_len: int,
    hits_per_seg: int,
    n_probes: int,
    band: int,
    kb: int,
):
    """-> (best_diag (B,) int32, dist_total (B,) int32, support (B,) int32)
    for one strand; fixed shapes, no host synchronisation."""
    B, L = reads.shape
    S = L // seg_len
    dev = reads.device
    lengths = lengths.to(I32)
    seg_starts = torch.arange(S, dtype=I32, device=dev) * seg_len  # (S,)

    # --- 1-2. rare-probe seeding per segment
    jm = _all_jmers(reads, j)  # (B, L)
    step = max(1, (seg_len - j) // max(1, n_probes))
    probe_off = torch.arange(n_probes, dtype=I32, device=dev) * step  # (R,)
    pidx = seg_starts[:, None] + probe_off[None, :]  # (S, R)
    pval = jm[:, pidx.long()].long()  # (B, S, R)
    start_all, end_all = offsets[pval], offsets[pval + 1]
    width_all = end_all - start_all
    # a probe running past the read end, or a j-mer absent from the genome
    # (zero-width bucket), must not win the argmin
    probe_end = pidx[None] + j  # (1, S, R)
    big = torch.tensor(1 << 30, dtype=I32, device=dev)
    width_all = torch.where(probe_end <= lengths[:, None, None], width_all, big)
    width_all = torch.where(width_all <= 0, big, width_all)
    r_best = torch.argmin(width_all, dim=2, keepdim=True)  # (B, S, 1), first minimum

    b_start = torch.gather(start_all, 2, r_best)[..., 0]
    b_end = torch.gather(end_all, 2, r_best)[..., 0]
    b_off = torch.gather(pidx[None].expand(B, S, n_probes), 2, r_best)[..., 0]  # (B, S)
    slots = b_start[..., None] + torch.arange(hits_per_seg, dtype=I32, device=dev)
    valid = (slots < b_end[..., None]) & ((b_off[..., None] + j) <= lengths[:, None, None])
    hit = positions[slots.clamp(0, positions.shape[0] - 1).long()]
    # each diagonal estimates the read-global start
    diag3 = torch.where(valid, hit - b_off[..., None], NO_CAND).to(I32)  # (B, S, H)
    diag = diag3.reshape(B, S * hits_per_seg)

    # --- 3. diagonal voting: votes_i = #{j : d_i <= d_j <= d_i + band}
    d = torch.sort(diag, dim=1).values  # NO_CAND tail
    real = d != NO_CAND
    votes = ((d[:, None, :] >= d[:, :, None]) & (d[:, None, :] <= d[:, :, None] + band)).sum(
        dim=2, dtype=I32)
    votes = torch.where(real, votes, 0)
    bi = torch.argmax(votes, dim=1, keepdim=True)  # first maximum
    support = torch.gather(votes, 1, bi)[:, 0]
    best_diag = torch.gather(d, 1, bi)[:, 0]  # the cluster's minimum

    # --- 4. chunked banded verify, each segment re-anchored on its own
    # diagonal inside the winning cluster, else on the cluster's
    member = (diag3 >= best_diag[:, None, None]) & (diag3 <= best_diag[:, None, None] + band)
    seg_diag = torch.where(member, diag3, NO_CAND).amin(dim=2)  # (B, S)
    seg_diag = torch.where(seg_diag != NO_CAND, seg_diag, best_diag[:, None])
    Wseg = seg_len + 3 * kb
    ws = (seg_diag + seg_starts[None, :]).to(I32).reshape(-1)  # window starts at the diagonal
    segs = vreads.to(torch.int8).reshape(B * S, seg_len).contiguous()
    seg_lens = (lengths[:, None] - seg_starts[None, :]).clamp(0, seg_len).to(I32).reshape(-1)
    rid = torch.arange(B * S, dtype=I32, device=dev)
    dists, _ = dp_ops.banded_edit_distance_text(
        text_words, n_text, ws, segs, seg_lens, rid, kb, Wseg
    )
    # cap a segment that could not be verified (unanchored and drifted past
    # the band), so one bad segment degrades the read's score, not destroys it
    live = seg_lens > 0
    cap = torch.where(live, torch.clamp(seg_lens // 4, min=2 * kb), 0)
    dists = torch.where(live, torch.minimum(dists, cap), 0)
    dist_total = dists.reshape(B, S).sum(dim=1, dtype=I32)
    return best_diag, dist_total, support


class LongReadAligner:
    """Chunked long-read mapper over the CSR seed table.

    A read maps when its summed per-segment banded distance is at most
    ``max_edit_frac`` of its length and at least ``min_support`` segments
    voted for the winning diagonal.  ``kb`` is the segment verify's band
    half-width, any kb >= 0 (the banded kernel holds the band in one
    thread up to 16, in a group of threads past it)."""

    def __init__(
        self,
        gi,
        seed_table,
        seed_j: int,
        seg_len: int = 128,
        hits_per_seg: int = 4,
        n_probes: int = 4,
        band: int = 48,
        kb: int = 16,
        min_support: int = 3,
        max_edit_frac: float = 0.12,
        device: str | torch.device = "cuda",  # the CPU only when asked for
    ):
        if kb < 0:
            raise ValueError(f"kb={kb}: the long-read segment verify takes kb >= 0 (a band "
                             f"of 4 kb + 1 slots)")
        self.gi = gi
        self.device = torch.device(device)
        self.n_text = int(gi.fwd.n)
        words = np.ascontiguousarray(gi.fwd.text_words, dtype=np.uint32).view(np.int32)
        self.text_words = _to_device(words, self.device)
        self.seed_tab = tuple(
            _to_device(np.asarray(a, dtype=np.int32), self.device) for a in seed_table
        )
        self.seed_j = seed_j
        self.seg_len = seg_len
        self.hits_per_seg = hits_per_seg
        self.n_probes = n_probes
        self.band = band
        self.kb = kb
        self.min_support = min_support
        self.max_edit_frac = max_edit_frac

    def align_arrays(
        self, verify_fwd: np.ndarray, lengths: np.ndarray, traceback: bool = True
    ) -> LongHits:
        """Map the batch; with ``traceback`` (default) every mapped read also
        gets an exact CIGAR/POS/AS/NM from one banded affine traceback over
        the whole read (band half-width ``kb + band``)."""
        lengths = np.asarray(lengths, dtype=np.int32)
        L = verify_fwd.shape[1]
        pad = (-L) % self.seg_len
        if pad:  # the pad sits at the end; tail segments mask by length
            verify_fwd = np.pad(verify_fwd, ((0, 0), (0, pad)), constant_values=4)
        # each row reverses only [0, len), so the reverse-complement read
        # also occupies [0, len) and the same segment masking applies
        vrc_np = revcomp_verify_batch(verify_fwd, lengths)
        lens = _to_device(lengths, self.device)

        outs = []
        for host in (verify_fwd, vrc_np):
            v = _to_device(host.astype(np.int8), self.device)
            outs.append(_chunk_vote_verify(
                self.seed_tab[0], self.seed_tab[1], self.text_words, self.n_text,
                torch.where(v >= 4, 0, v), v, lens,
                j=self.seed_j, seg_len=self.seg_len, hits_per_seg=self.hits_per_seg,
                n_probes=self.n_probes, band=self.band, kb=self.kb,
            ))
        (pf, df, sf_), (pr, dr, sr_) = [tuple(x.cpu().numpy() for x in o) for o in outs]

        max_d = np.maximum(1, (self.max_edit_frac * lengths)).astype(np.int64)
        nc = int(NO_CAND)
        ok_f = (sf_ >= self.min_support) & (df <= max_d) & (pf != nc)
        ok_r = (sr_ >= self.min_support) & (dr <= max_d) & (pr != nc)
        take_r = ok_r & (~ok_f | (dr < df) | ((dr == df) & (pr < pf)))
        mapped = ok_f | ok_r
        pos = np.where(take_r, pr, pf).astype(np.int64)
        dist = np.where(take_r, dr, df).astype(np.int64)
        support = np.where(take_r, sr_, sf_).astype(np.int64)
        strand = take_r.astype(np.int64)
        pos = np.where(mapped, pos, 0)

        cigars: dict[int, str] = {}
        aux: dict[int, tuple[int, int]] = {}
        if traceback and mapped.any():
            idx = np.nonzero(mapped)[0]
            # the diagonal is the cluster's minimum, so the true start lies
            # up to the whole band to its right, plus kb of segment slack
            kb2 = self.kb + self.band
            lmax = int(lengths[idx].max())
            Wb = lmax + 3 * kb2
            vcodes = np.zeros((idx.size, lmax), dtype=np.int64)
            lens_s = lengths[idx].astype(np.int64)
            ws_all = pos[idx] - kb2
            for t, i in enumerate(idx):
                n = int(lengths[i])
                vcodes[t, :n] = (vrc_np if strand[i] else verify_fwd)[i, :n]
            wins = window.gather_windows_host(
                self.gi.fwd.text_words, self.n_text, ws_all, Wb
            ).astype(np.int64)
            sc, start, cig, nm = affine.affine_banded_batch(vcodes, lens_s, wins, kb2)
            pos[idx] = np.maximum(ws_all + start, 0)
            dist[idx] = nm
            for t, i in enumerate(idx.tolist()):
                cigars[i] = cig[t]
                aux[i] = (int(sc[t]), int(nm[t]))

        return LongHits(mapped=mapped, pos=pos, strand=strand, dist=dist, support=support,
                        cigars=cigars, aux=aux)
