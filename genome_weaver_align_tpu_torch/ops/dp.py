"""Banded edit-distance DP verify: plain torch version, dispatcher, host
traceback helpers.

Same coordinates as ``genome_weaver_align_tpu.ops.dp``:
- candidate locus estimate ``cand`` -> window starts at ``ws = cand - k``,
  window width ``W >= L + 3k``.
- band slot b in [0, 4k] represents window position j = i + b - k at read
  position i.

Semi-global: leading/trailing window characters are free (D(0, j) = 0,
answer = min_b D(L, b)); the read must align end-to-end.

``banded_edit_distance_text`` (windows gathered from the packed text, the
verify stage's entry) and ``banded_edit_distance_best`` (windows given)
send a CUDA tensor to the hand-written kernel (``ops.dp_cuda``, source
``csrc/banded_dp.cu``) and a CPU tensor to the plain versions below; there
is no fallback from one to the other.
"""

from __future__ import annotations

import numpy as np
import torch

from .window import gather_windows

INF = 1 << 20


def banded_edit_distance(
    reads: torch.Tensor,  # (Q, L) codes; values >= 4 never match
    lengths: torch.Tensor,  # (Q,)
    windows: torch.Tensor,  # (Q, W) codes; values >= 4 never match
    k: int,
):
    """Min edit distance of each read vs. any substring of its window.

    Returns (dist (Q,) int32, end_b (Q,) int32) where end_b is the first
    argmin band slot of the unclamped final row (window end position =
    lengths + end_b - k), for traceback seeding.  Cells above INF are
    garbage that accumulates +1s; ``dist`` clamps them to exactly INF.
    """
    Q, L = reads.shape
    W = windows.shape[1]
    band = 4 * k + 1
    dev = reads.device
    lengths = lengths.to(torch.int32)

    boff = torch.arange(band, dtype=torch.int32, device=dev) - k  # j - i per slot
    inf_col = torch.full((Q, 1), INF, dtype=torch.int32, device=dev)
    # row i=0: D(0, j) = 0 wherever j = b - k is a valid window position
    D = torch.where(boff >= 0, 0, INF).to(torch.int32).expand(Q, band).contiguous()
    for i in range(L):
        active = (i < lengths)[:, None]
        j = i + boff
        valid = (j >= 0) & (j < W)
        wchar = windows[:, j.clamp(0, W - 1)]
        r = reads[:, i : i + 1]
        sub = (~(valid & (wchar == r) & (r < 4))).to(torch.int32)
        diag = D + sub
        # read-insertion: D(i, j) -> D(i+1, j): slot shifts down by one
        ins = torch.cat([D[:, 1:], inf_col], dim=1) + 1
        tmp = torch.where(valid, torch.minimum(diag, ins), INF)
        # window-deletion: running min along the band (in-row dependency)
        cols = [tmp[:, 0]]
        for b in range(1, band):
            cols.append(torch.minimum(tmp[:, b], cols[-1] + 1))
        D = torch.where(active, torch.stack(cols, dim=1), D)

    j_end = lengths[:, None] + boff[None, :]
    valid_end = (j_end >= 0) & (j_end <= W)
    Df = torch.where(valid_end, D, INF)
    dist = Df.min(dim=1).values.clamp_(max=INF)
    end_b = Df.argmin(dim=1).to(torch.int32)
    return dist, end_b


def banded_edit_distance_best(
    reads: torch.Tensor, lengths: torch.Tensor, windows: torch.Tensor, k: int
):
    """Device-dispatched banded verify: the CUDA kernel for CUDA tensors
    (it raises on what it cannot take), the plain version for CPU tensors.
    Both give the same ``dist`` and ``end_b`` on every lane."""
    if reads.is_cuda:
        from . import dp_cuda

        return dp_cuda.banded_edit_distance_cuda(reads, lengths, windows, k)
    return banded_edit_distance(reads, lengths, windows, k)


def banded_edit_distance_text_plain(
    text_words: torch.Tensor, n_text: int, starts: torch.Tensor, reads: torch.Tensor,
    lengths: torch.Tensor, rid: torch.Tensor, k: int, W: int,
):
    """The text entry's plain version: gather every lane's window and read,
    then ``banded_edit_distance``."""
    rid = rid.long()
    return banded_edit_distance(
        reads[rid], lengths[rid], gather_windows(text_words, n_text, starts, W), k
    )


def banded_edit_distance_text(
    text_words: torch.Tensor,  # (nw,) int32 packed text
    n_text: int,  # text length in bases
    starts: torch.Tensor,  # (Q,) int32 window starts (may be negative or past n_text)
    reads: torch.Tensor,  # (B, L) int8 codes; values >= 4 never match
    lengths: torch.Tensor,  # (B,) int32
    rid: torch.Tensor,  # (Q,) int32 read of each lane
    k: int,
    W: int,  # window width
):
    """Banded verify of lane q: read ``rid[q]`` against the W text bases at
    ``starts[q]`` (code 4 off the text) -> (dist (Q,), end_b (Q,)) int32.

    A CUDA tensor launches the kernel, which gathers each window from the
    packed words itself (no (Q, W) or (Q, L) tensor is made); a CPU tensor
    takes ``banded_edit_distance_text_plain``.  Both give the same ``dist``
    and ``end_b`` on every lane."""
    if reads.is_cuda:
        from . import dp_cuda

        return dp_cuda.banded_edit_distance_text_cuda(
            text_words, n_text, starts, reads, lengths, rid, k, W
        )
    return banded_edit_distance_text_plain(text_words, n_text, starts, reads, lengths, rid, k, W)


def hamming_distance(
    reads: torch.Tensor, lengths: torch.Tensor, windows: torch.Tensor, offset: int
) -> torch.Tensor:
    """Substitution-only verify: mismatches of read vs window[offset:offset+len]."""
    Q, L = reads.shape
    W = windows.shape[1]
    pos = torch.arange(L, dtype=torch.int32, device=reads.device)
    idx = pos + offset
    valid = (idx >= 0) & (idx < W)
    wchar = windows[:, idx.clamp(0, W - 1)]
    in_read = pos[None, :] < lengths[:, None]
    mm = (wchar != reads) | (reads >= 4) | ~valid
    return (mm & in_read).sum(dim=1, dtype=torch.int32)


# ------------------------------------------------- batched band traceback
#
# Host copies of the JAX package's numpy helpers (tests pin the two).  The
# pipeline's finish path uses ``traceback_banded_batch`` for indel reads
# when it emits unit-cost CIGARs (``scored=False``).

_HINF = np.int32(1 << 20)


def banded_rows_host(reads: np.ndarray, lengths: np.ndarray, windows: np.ndarray, k: int):
    """Band DP keeping all rows: (Q, L+1, band) int32, device-identical."""
    Q, L = reads.shape
    W = windows.shape[1]
    band = 4 * k + 1
    boff = np.arange(band, dtype=np.int64) - k
    D = np.empty((Q, L + 1, band), dtype=np.int32)
    D[:, 0, :] = np.where(boff >= 0, 0, _HINF)[None, :]
    reads = np.asarray(reads, dtype=np.int64)
    lengths = np.asarray(lengths, dtype=np.int64)
    for i in range(L):
        prev = D[:, i, :]
        j = i + boff[None, :]  # (1, band) diag-predecessor window positions
        valid = (j >= 0) & (j < W)
        wchar = np.take_along_axis(windows, np.clip(j, 0, W - 1), axis=1)
        sub = np.where(
            valid & (wchar == reads[:, i][:, None]) & (reads[:, i][:, None] < 4), 0, 1
        )
        diag = prev + sub
        ins = np.concatenate([prev[:, 1:], np.full((Q, 1), _HINF, np.int32)], axis=1) + 1
        tmp = np.minimum(diag, ins)
        tmp = np.where(valid, tmp, _HINF)
        run = tmp[:, 0].copy()
        out = D[:, i + 1, :]
        out[:, 0] = run
        for b in range(1, band):
            run = np.minimum(tmp[:, b], run + 1)
            out[:, b] = run
        active = i < lengths
        out[~active] = prev[~active]
    return D


def traceback_banded_batch(
    reads: np.ndarray,  # (Q, L) verify codes (>=4 never matches)
    lengths: np.ndarray,  # (Q,)
    windows: np.ndarray,  # (Q, W)
    k: int,
):
    """Banded DP + lockstep traceback for a read cohort.

    Returns (dist (Q,), start_in_window (Q,), cigars list[str]).  Operation
    preference is M > I > D at equal cost (same order as the full-matrix
    ``traceback_semiglobal_host``); ties at the end pick the smallest window
    end position (first argmin), matching ``banded_edit_distance``'s end_b.
    """
    Q, L = reads.shape
    W = windows.shape[1]
    band = 4 * k + 1
    boff = np.arange(band, dtype=np.int64) - k
    D = banded_rows_host(reads, lengths, windows, k)
    lengths = np.asarray(lengths, dtype=np.int64)
    reads = np.asarray(reads, dtype=np.int64)

    j_end = lengths[:, None] + boff[None, :]
    Df = np.where((j_end >= 0) & (j_end <= W), D[np.arange(Q), lengths, :], _HINF)
    dist = Df.min(axis=1).astype(np.int64)
    b = Df.argmin(axis=1).astype(np.int64)

    i = lengths.copy()
    max_steps = L + 2 * k + 1
    ops = np.zeros((Q, max_steps), dtype=np.int8)  # 0 none, 1 M, 2 I, 3 D
    q = np.arange(Q)
    for step in range(max_steps):
        active = i > 0
        if not active.any():
            break
        j = i + b - k  # current cell's window position
        cur = D[q, i, b]
        ip = np.maximum(i - 1, 0)
        jp = j - 1  # diag predecessor window position (char indices i-1, j-1)
        wchar = np.take_along_axis(windows, np.clip(jp, 0, W - 1)[:, None], axis=1)[:, 0]
        rchar = np.take_along_axis(reads, np.clip(ip, 0, L - 1)[:, None], axis=1)[:, 0]
        sub = np.where((jp >= 0) & (jp < W) & (wchar == rchar) & (rchar < 4), 0, 1)
        diag_ok = active & (j >= 1) & (cur == D[q, ip, b] + sub)
        bp = np.minimum(b + 1, band - 1)
        ins_ok = active & ~diag_ok & (b + 1 < band) & (cur == D[q, ip, bp] + 1)
        bm = np.maximum(b - 1, 0)
        del_ok = active & ~diag_ok & ~ins_ok & (b >= 1) & (cur == D[q, i, bm] + 1)
        assert bool(np.all(diag_ok | ins_ok | del_ok | ~active)), "traceback stuck"
        ops[:, step] = np.where(diag_ok, 1, np.where(ins_ok, 2, np.where(del_ok, 3, 0)))
        i = i - (diag_ok | ins_ok)
        b = np.where(ins_ok, b + 1, np.where(del_ok, b - 1, b))
    start = (i + b - k).astype(np.int64)  # i == 0 here: window start of alignment

    cigars = []
    sym = "?MID"
    for qi in range(Q):
        row = ops[qi][ops[qi] != 0][::-1]  # reverse: traceback ran end -> start
        if row.size == 0:
            cigars.append("")
            continue
        cut = np.nonzero(np.diff(row))[0]
        runs = np.diff(np.r_[-1, cut, row.size - 1])
        vals = row[np.r_[cut, row.size - 1]]
        cigars.append("".join(f"{r}{sym[v]}" for r, v in zip(runs, vals)))
    return dist, start, cigars
