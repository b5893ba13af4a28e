"""Interval-sharded approximate alignment: the torch counterpart of
``genome_weaver_align_tpu.parallel.sharded_pipeline``.

Per batch, with the index, the genome text and the seed table split into S
interval shards on one device (and, under several processes, the batch
split across them while each process holds its interval group's S / g
shards and maps the others' through ``parallel.peer``, on its card or on
others: every step below reads any shard wherever it lives, so any process
runs the whole pipeline for its reads):

1. piece exact search  — every interval update answered by the owning BWT
   (FM path)             shard (``sharded_piece_search``: one kernel on a
                         CUDA device, ``csrc/fm_search.cu``; on the CPU a
                         loop of per-step partials merged by a sum over the
                         shards);
   (seed path)         — each probe's k-mer answered by the shard that owns
                         its k-mer range, one merge of the candidates;
2. sparse-SA locate    — the LF walk, each step answered by the owning
   (FM path)             shards (``sharded_index.locate``: one kernel on a
                         CUDA device, ``csrc/locate.cu``; on the CPU merges
                         per LF step);
3. candidate dedup     — sort + neighbour mask;
4. window gather       — each genome position read from the one shard that
                         owns it (``gather_windows``: one (Q, W) tensor,
                         code 4 where no shard owns the position; the sum
                         of the owners' contributions that the JAX package
                         merges, since ownership is disjoint);
5. banded DP verify    — one verify over all (B, C) candidates, NO_CAND
                         giving INF.  The JAX package pads the candidates
                         to Cs*S, splits the verify across the interval
                         axis and all_gathers the distances; on one device
                         the split buys nothing, and the padding only adds
                         lanes that best_hit never picks;
6. best hit            — deterministic (dist, pos) order.

The verify runs the hand-written banded-DP kernel on a CUDA device and its
plain version on the CPU (``ops.dp.banded_edit_distance_best``).

Where an interval group spans hosts (``mesh.ShardLayout.collective``: CUDA
IPC cannot reach across them) the JAX design holds: every process of a
group takes the group's reads, holds its own shards only and maps nothing,
and every step that reads the shards is answered by each process from its
own (non-owners give 0) and merged by one ``all_reduce`` over the group
(``sharded_index._psum_across``: NCCL where the members have cards of
their own, else gloo).  The seed path's two merges as above; the piece
search a loop of ``sharded_index.held_step`` (one launch of the fused table
entry a step on the card); the locate ``sharded_index.locate_collective``
(one merge a step); and the verify split over the g members as the JAX
package splits it: each verifies its share of the padded candidates with
the banded DP's text entry (``ops.dp.banded_edit_distance_text``) against
the whole packed text every process holds for the CIGAR check, and the
distances are all_gathered (``sharded_index.gather_across``).  The same
windows as the owner-computes merge, and no window bytes moved.
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
from ..ops import affine, rank, window
from ..ops import dp as dp_ops
from ..ops.rank import _upload
from ..utils import sam as sam_mod
from . import mesh as pmesh
from . import multihost as mh
from . import peer
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


def put_text(tx: ShardedText, device, layout: pmesh.ShardLayout = None) -> ShardedText:
    """The text shards on ``device``; across processes each uploads its own
    and maps the others' (as ``sharded_index.put_sharded``)."""
    return si.put_tables(tx, device, layout, ("words",), ("base", "end"))


def _shard_order(tx: ShardedText):
    """The shards in order of their first base, empty ones last: (order,
    the sorted keys).  The one shard that can hold a position is at the
    place ``searchsorted(keys, pos, right=True) - 1`` of that order: the
    last non-empty shard whose base is at most pos, -1 before every shard
    (the caller checks the shard's end)."""
    key = torch.where(tx.end > tx.base, tx.base, torch.iinfo(I32).max)
    order = torch.argsort(key, stable=True).to(I32)
    return order, key[order].contiguous()


def gather_windows(tx: ShardedText, starts: torch.Tensor, width: int) -> torch.Tensor:
    """The (Q, width) int8 window codes at ``starts``, each base read from
    the one shard whose [base, end) holds it, code 4 where none does (off
    the genome): what the owners' contributions merged by a sum give, since
    the shards' ranges are disjoint.  Nothing grows with the shard count.
    The windows in order of their start: the windows a shard's range
    touches are then one run of them, found for every shard at once and
    read to the host in one synchronisation; each shard fills its run from
    its own words wherever they live (stacked, one tensor a shard, mapped
    from another process; ``ops.window.gather_windows``)."""
    starts = starts.to(I32)
    # the windows' codes in order of their start, 4 until an owner writes
    got = torch.full((starts.shape[0], width), 4, dtype=torch.int8, device=starts.device)
    if starts.shape[0] == 0 or width == 0:
        return got
    by = torch.argsort(starts)
    s_by = starts[by]
    order, keys = _shard_order(tx)
    # the shard places of each window's first and last base: both
    # nondecreasing along ``by``
    first = torch.searchsorted(keys, s_by, right=True) - 1
    last = torch.searchsorted(keys, s_by + (width - 1), right=True) - 1
    ranks = torch.arange(len(tx.words), device=starts.device)
    lo = torch.searchsorted(last, ranks)  # the first window reaching the shard
    hi = torch.searchsorted(first, ranks, right=True)  # past the last starting by it
    runs = torch.stack([order.long(), lo, hi, tx.base[order].long(), tx.end[order].long()])
    for s, a, z, b, e in zip(*runs.tolist()):
        if a < z and b < e:
            # the shard's codes where it owns a position, 4 elsewhere: the
            # owners are disjoint, so the least code is the owner's
            run = got[a:z]
            torch.minimum(run, window.gather_windows(tx.words[s], e - b, s_by[a:z] - b, width),
                          out=run)
    out = torch.empty_like(got)
    out[by] = got
    return out


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


def put_seed(st: ShardedSeedTable, device, layout: pmesh.ShardLayout = None) -> ShardedSeedTable:
    """The seed table's shards on ``device``; across processes each uploads
    its own and maps the others' (as ``sharded_index.put_sharded``)."""
    return si.put_tables(st, device, layout, ("offsets", "positions"), ("k_lo", "k_hi"))


def _dedupe(cand: torch.Tensor) -> torch.Tensor:
    B = cand.shape[0]
    cand = torch.sort(cand, dim=1).values
    dup = torch.cat(
        [torch.zeros((B, 1), dtype=torch.bool, device=cand.device), cand[:, 1:] == cand[:, :-1]],
        dim=1,
    )
    return torch.sort(torch.where(dup, sf.NO_CAND, cand), dim=1).values


def _pad_candidates(cand, n_interval):
    """The candidates padded with NO_CAND to Cs * S columns, Cs = ceil(C /
    S): the JAX package's split of the verify over the interval axis."""
    B, C = cand.shape
    pad = -(-C // n_interval) * n_interval - C
    return torch.cat([cand, torch.full((B, pad), sf.NO_CAND, dtype=I32, device=cand.device)], dim=1)


def _verify_split(text, reads, lengths, cand, k, W, layout, gather):
    """The collective route's verify: the padded candidates split over the
    interval group's members in order; this member verifies its share
    against the whole packed text ``text`` = (words, n) with the banded
    DP's text entry, and ``gather`` all_gathers the distances; best hit.
    The windows are those the owner-computes merge gives (code 4 off the
    genome)."""
    words, n = text
    B = cand.shape[0]
    cand_p = _pad_candidates(cand, layout.n_interval)
    Cm = cand_p.shape[1] // layout.interval_procs
    mine = cand_p[:, layout.group_rank * Cm : (layout.group_rank + 1) * Cm]
    invalid = mine == sf.NO_CAND
    starts = torch.where(invalid, 0, mine - k).reshape(-1).to(I32).contiguous()
    rid = torch.arange(B, dtype=I32, device=cand.device).repeat_interleave(Cm)
    dist, _ = dp_ops.banded_edit_distance_text(words, n, starts, reads.to(torch.int8).contiguous(),
                                               lengths.to(I32).contiguous(), rid, k, W)
    dist = torch.where(invalid, dp_ops.INF, dist.reshape(B, Cm))
    return sf.best_hit(cand_p, gather(dist), k)


def _collective(layout: pmesh.ShardLayout, dev):
    """The collective route's merges for this process's interval group:
    (psum, all_gather), over NCCL where the members have cards of their own
    and the tensors lie on the card, else over gloo."""
    nccl = si.group_nccl(layout, dev)
    return si._psum_across(layout.group, nccl), si.gather_across(layout.group, nccl)


def _verify_best(tx, reads, lengths, cand, k, W):
    """Windows of every candidate, each base read from its owner shard
    (``gather_windows``), one banded verify over the (B, C) candidates
    (the windows entry), best hit."""
    B, C = cand.shape
    invalid = cand == sf.NO_CAND
    ws_all = torch.where(invalid, 0, cand - k).reshape(-1)
    codes_all = gather_windows(tx, ws_all, W)
    r = reads.to(torch.int8).repeat_interleave(C, dim=0)
    ln = lengths.to(I32).repeat_interleave(C)
    dist, _ = dp_ops.banded_edit_distance_best(r, ln, codes_all, k)
    dist = torch.where(invalid, dp_ops.INF, dist.reshape(B, C))
    return sf.best_hit(cand, dist, k)


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
    n_good, overflow).  On the collective route (``layout.collective``)
    the seed shards are this process's own (``put_seed``), the merges are
    ``all_reduce``s over its interval group, and ``text_shards`` is the
    whole packed text (words, n) for the split verify."""
    n_pieces = k + 1
    W = max_len + 3 * k
    j = like_seed.j

    def fn(st, tx, reads, lengths):
        reads = reads.to(I32)
        lengths = lengths.to(I32)
        B = reads.shape[0]
        if layout.collective:
            st = si.held_tables(st, layout, ("offsets", "positions"), ("k_lo", "k_hi"))
            merge, gather = _collective(layout, reads.device)
        else:
            merge = si.default_merge
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
        start_all = si.shard_rows(st.offsets, idx_loc)
        end_all = si.shard_rows(st.offsets, idx_loc + 1)
        width_all = merge(torch.where(mine_all, end_all - start_all, 0))
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
        hit = si.shard_rows(st.positions, slots.clamp(0, st.positions.shape[1] - 1))
        cand_part = torch.where(valid_l, hit - jst[None, ..., None], 0)
        cand_all = merge(cand_part.reshape(S, B, -1)).reshape(B, n_pieces, max_hits)
        overflow = torch.any(width > max_hits, dim=1)
        valid = torch.arange(max_hits, dtype=I32, device=reads.device) < width[..., None]
        cand = torch.where(valid, cand_all, sf.NO_CAND).reshape(B, -1)

        if layout.collective:
            best = _verify_split(tx, reads, lengths, _dedupe(cand), k, W, layout, gather)
        else:
            best = _verify_best(tx, reads, lengths, _dedupe(cand), k, W)
        return best.best_pos, best.best_dist, best.n_good, overflow

    return fn


def _piece_steps(max_len: int, n_pieces: int) -> int:
    """The sharded piece search's trip count: ceil(max_len / P) + 1."""
    return (max_len + n_pieces - 1) // n_pieces + 1


def sharded_piece_search(sh: si.ShardedFMIndex, reads: torch.Tensor, lengths: torch.Tensor,
                         n_pieces: int, max_len: int):
    """Exact backward search of every piece of every read over the interval
    shards -> (lo, hi), each (B, P) int32.  On a CUDA device the whole loop
    is one kernel (``ops.fm_search_cuda.backward_search_sharded_cuda``); on
    the CPU, ``sharded_piece_search_plain``."""
    if not reads.is_cuda:
        return sharded_piece_search_plain(sh, reads, lengths, n_pieces, max_len)
    from ..ops import fm_search_cuda

    return fm_search_cuda.backward_search_sharded_cuda(
        sh, reads.to(I32).contiguous(), lengths.to(I32).contiguous(), n_pieces,
        _piece_steps(max_len, n_pieces))


def _piece_loop(n: int, reads: torch.Tensor, lengths: torch.Tensor, n_pieces: int, max_len: int,
                step):
    """ceil(max_len / P) + 1 interval updates of every piece, each
    ``step(codes, lo, hi)``; lanes whose piece is exhausted or whose
    interval is empty stop updating."""
    reads = reads.to(I32)
    B, L = reads.shape
    dev = reads.device
    bounds = sf._piece_bounds(lengths, n_pieces)
    s, e = bounds[:, :-1], bounds[:, 1:]
    lo = torch.zeros((B, n_pieces), dtype=I32, device=dev)
    hi = torch.full((B, n_pieces), n + 1, dtype=I32, device=dev)
    for t in range(_piece_steps(max_len, n_pieces)):
        j = e - 1 - t
        active = (j >= s) & (lo < hi)
        c = torch.gather(reads, 1, j.clamp(0, L - 1).long())
        lo, hi = rank.step_where(active, step(c, lo, hi), (lo, hi))
    return lo, hi


def sharded_piece_search_plain(sh: si.ShardedFMIndex, reads: torch.Tensor, lengths: torch.Tensor,
                               n_pieces: int, max_len: int):
    """The piece search as a loop of torch ops (the kernel's plain version):
    ceil(max_len / P) + 1 interval updates, each answered by the owning BWT
    shard with the partials summed over the shards; lanes whose piece is
    exhausted or whose interval is empty stop updating."""
    return _piece_loop(sh.n, reads, lengths, n_pieces, max_len,
                       lambda c, lo, hi: si.backward_step(sh, c, lo, hi))


def held_piece_search(own: si.ShardedFMIndex, reads: torch.Tensor, lengths: torch.Tensor,
                      n_pieces: int, max_len: int, merge):
    """The collective route's piece search over the shards ``own`` this
    process holds: each interval update is ``sharded_index.held_step``, the
    held shards' lo and hi partials (one launch of the fused table entry on
    the card; on the CPU the partials of ``sharded_piece_search_plain``'s
    step) merged across the interval group by ``merge``."""
    return _piece_loop(own.n, reads, lengths, n_pieces, max_len,
                       lambda c, lo, hi: si.held_step(own, c, lo, hi, merge))


def make_sharded_pigeonhole_align(
    layout: pmesh.ShardLayout,
    *,
    like_index: si.ShardedFMIndex = None,
    like_text: ShardedText = None,
    max_len: int,
    k: int,
    max_hits: int = 8,
):
    """FM-path sharded align step: the piece search and the locate over the
    interval shards (one kernel each on a CUDA device).  Returns
    fn(index_shards, text_shards, reads, lengths) -> (best_pos, best_dist,
    n_good, overflow).  On the collective route (``layout.collective``)
    the piece search is ``held_piece_search``, the locate
    ``sharded_index.locate_collective`` and the verify split over the
    group, each over this process's own shards and merged across its
    interval group; ``text_shards`` is then the whole packed text (words,
    n)."""
    n_pieces = k + 1
    W = max_len + 3 * k

    def fn(sh, tx, reads, lengths):
        reads = reads.to(I32)
        lengths = lengths.to(I32)
        B = reads.shape[0]
        dev = reads.device
        s = sf._piece_bounds(lengths, n_pieces)[:, :-1]
        if layout.collective:
            own = si.held_index(sh, layout)
            merge, gather = _collective(layout, dev)

        # 1. piece search, every interval update answered by its owner shard
        if layout.collective:
            lo, hi = held_piece_search(own, reads, lengths, n_pieces, max_len, merge)
        else:
            lo, hi = sharded_piece_search(sh, reads, lengths, n_pieces, max_len)
        overflow = torch.any((hi - lo) > max_hits, dim=1)

        # 2. locate candidate rows (the LF walk over the shards)
        rows = lo[:, :, None] + torch.arange(max_hits, dtype=I32, device=dev)[None, None, :]
        valid = rows < hi[:, :, None]
        rows = rows.clamp(0, sh.n).reshape(-1)
        pos = (si.locate_collective(own, rows, merge) if layout.collective
               else si.locate(sh, rows)).reshape(valid.shape)
        cand = torch.where(valid, pos - s[:, :, None], sf.NO_CAND).reshape(B, -1)

        if layout.collective:
            best = _verify_split(tx, reads, lengths, _dedupe(cand), k, W, layout, gather)
        else:
            best = _verify_best(tx, reads, lengths, _dedupe(cand), k, W)
        return best.best_pos, best.best_dist, best.n_good, overflow

    return fn


class ShardedAligner:
    """``SuffixFilterAligner``-compatible facade over the sharded pipeline.

    Splits the index, the text and (when given) the seed table into
    ``n_interval`` interval shards on ``device`` and runs the merged
    pipeline per batch.  Under ``multihost.initialize_distributed`` with P
    processes (one a card) the processes form interval groups of g
    (``mesh.interval_span``: one shard a process where ``n_interval``
    divides P, giving P / g copies of the index; else every process, each
    holding ``n_interval / P``): each holds its group's ``n_interval / g``
    shards and maps the others' (``parallel.peer``, over NVLink where they
    lie on other cards).  Every process passes the whole batch, aligns its
    slice of it and gathers the rest: the batch is split over all P
    processes, and the interval axis shards the memory (the JAX package's
    interval group aligns the same reads on each of its devices).  A branch that decides a
    collective (the seed path, the overflow cohort) is decided from the
    gathered batch, so every process makes the same collectives in the same
    order.  CIGARs come from the same fast-Hamming / host traceback split as
    the single-device aligner, over the full text (``_text``: every process
    uploads all of it, n / 4 bytes), so the SAM bytes are the same whatever
    the shard and process counts.  ``close`` releases the mapped shards (a
    collective).

    Where an interval group spans hosts (``mesh.ShardLayout.collective``,
    the hosts from ``multihost.host_of``) the aligner takes the collective
    route: the data axis spans the interval groups (every member of a group
    takes the group's slice of each batch, and the gather keeps one copy a
    group), each process uploads its own shards of the index and the seed
    table only and maps nothing, and no text shards are made (the split
    verify reads the whole text ``_text``).
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
        # the data axis spans the processes (one in a plain run): each one
        # aligns its slice of every batch, and every one runs the host tail
        # on the gathered batch, as every JAX process does; the interval
        # axis spans each interval group (n_interval > 1): each process
        # holds its own shards
        self.layout = pmesh.make_layout(mh.process_count(), n_interval, self.device)
        if self.layout.collective:
            # an interval group spans hosts: its members take the same reads
            self.layout = pmesh.make_layout(self.layout.groups, n_interval, self.device)
        self.sst = None
        self.seed_j = 0
        if seed_table is not None and seed_j > 0:
            self.sst = put_seed(
                shard_seed_table(seed_table[0], seed_table[1], seed_j, n_interval), self.device,
                self.layout)
            self.seed_j = seed_j
        # FM shards are always built: batches whose shortest read has pieces
        # < seed_j fall back to them
        self.sh = si.put_sharded(si.shard_fm_index(gi.fwd, n_interval), self.device, self.layout)
        self.tx = None if self.layout.collective else put_text(
            shard_text(gi.fwd.text_words, gi.fwd.n, n_interval), self.device, self.layout)
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
        if self.layout.process_count != mh.process_count():
            raise RuntimeError(
                f"this aligner was built for {self.layout.process_count} process(es) and the "
                f"group has {mh.process_count()}: build it after initialize_distributed")
        lengths = np.array([len(r) for r in reads], dtype=np.int32)
        vf = reads_to_batch_verify(reads)
        vrc = revcomp_verify_batch(vf, lengths)
        L = vf.shape[1]

        # gate the seed path on the SHORTEST read's pieces
        min_piece = int(lengths.min()) // (self.k + 1)
        use_seed = self.sst is not None and min_piece >= self.seed_j
        fn = self._fn(L, use_seed)
        tab = self.sst if use_seed else self.sh
        lay = self.layout
        tx = (self._text, self.gi.fwd.n) if lay.collective else self.tx
        span = lay.interval_procs if lay.collective else 1  # one copy a group

        res = []
        for batch in (np.where(vf >= 4, 0, vf), np.where(vrc >= 4, 0, vrc)):
            r, l, _ = pmesh.shard_reads(lay, batch.astype(np.int32), lengths)
            out = fn(tab, tx, r, l)
            res.append(tuple(x[: len(reads)] for x in mh.gather_to_host(out, span)))
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

    def close(self) -> None:
        """Release the shard tables, the mapped ones first in every process
        (``peer.release``: a collective), then this process's own; on the
        collective route nothing was mapped."""
        def drop():
            self.sh = self.tx = self.sst = self._fb = None
            self._fns = {}

        if self.layout.collective:
            drop()
        else:
            peer.release(self.layout.group, drop)

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
