"""Myers bit-parallel semi-global edit distance: plain torch version and
dispatcher.

Torch counterpart of ``genome_weaver_align_tpu.ops.myers``: the minimum
over window substrings of the edit distance against the whole read, by the
Myers 1999 bit-vector recurrence.  Each read is a column bit-vector (PV/MV)
packed into ``nwords`` 32-bit words; one window character costs ~20 word
ops whatever the read length, with carry and shift propagation across
words.  Window codes >= 4 have no matching bits (Peq = 0).

Words are int32 tensors holding the JAX package's uint32 bits.  ``+``
wraps, and ``>>`` is arithmetic, so every right shift is followed by a
mask; the carry of a word add comes from the bit-majority identity
``((a & b) | ((a | b) & ~s)) >> 31`` instead of an unsigned compare.

``myers_semiglobal_text`` (windows streamed from the packed text: mate
rescue and ``verify_mode="myers"``), ``myers_semiglobal`` and
``myers_semiglobal_end`` (windows given) send CUDA tensors to the
hand-written kernel (``ops.myers_cuda``, source ``csrc/myers.cu``; it takes
reads of at most 256 bases) and CPU tensors to the plain loop below; there
is no fallback from one to the other.
"""

from __future__ import annotations

import torch

from . import window

I32 = torch.int32


def build_eq(reads: torch.Tensor, lengths: torch.Tensor, nwords: int) -> torch.Tensor:
    """Per-read match masks: (Q, 4, nwords) int32 words; bit i of word w set
    iff read[32w+i] == code.  Positions past the read length are zero."""
    Q, L = reads.shape
    dev = reads.device
    pos = torch.arange(L, dtype=I32, device=dev)
    in_len = pos[None, :] < lengths.to(I32)[:, None]  # (Q, L)
    out = []
    for c in range(4):
        match = (reads == c) & in_len
        bits = torch.where(match, 1 << (pos & 31).to(torch.int64), 0)  # (Q, L) int64
        out.append(_scatter_or(bits, pos >> 5, nwords))
    return torch.stack(out, dim=1)


def _scatter_or(bits: torch.Tensor, word: torch.Tensor, nwords: int) -> torch.Tensor:
    """(Q, L) single-bit int64 values OR-ed into (Q, nwords) int32 words by
    word index (disjoint bits: the sum is the OR, below 2^32)."""
    acc = []
    for w in range(nwords):
        s = torch.where((word == w)[None, :], bits, 0).sum(dim=1)
        acc.append(torch.where(s >= 1 << 31, s - (1 << 32), s).to(I32))
    return torch.stack(acc, dim=1)


def _carry(a: torch.Tensor, b: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Carry out of the 32-bit add s = a + b: bit 31 of majority(a, b, ~s)."""
    return (((a & b) | ((a | b) & ~s)) >> 31) & 1


def _add_with_carry(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Multi-word unsigned add along the last axis; returns sum words."""
    outs = []
    carry = torch.zeros(a.shape[:-1], dtype=I32, device=a.device)
    for w in range(a.shape[-1]):
        s1 = a[..., w] + b[..., w]
        s2 = s1 + carry
        outs.append(s2)
        carry = _carry(a[..., w], b[..., w], s1) | _carry(s1, carry, s2)
    return torch.stack(outs, dim=-1)


def _shl1_or(x: torch.Tensor, fill: torch.Tensor) -> torch.Tensor:
    """(x << 1) | fill across the word chain (fill enters bit 0 of word 0)."""
    outs = []
    carry_in = fill.to(I32)
    for w in range(x.shape[-1]):
        outs.append((x[..., w] << 1) | carry_in)
        carry_in = (x[..., w] >> 31) & 1
    return torch.stack(outs, dim=-1)


def _myers_plain(reads, lengths, windows, nwords: int, steps: int):
    """The plain recurrence: (best (Q,), end (Q,)) int32; ``end`` is the
    exclusive window end of the first strict improvement."""
    Q = reads.shape[0]
    W = windows.shape[1]
    dev = reads.device
    lengths = lengths.to(I32)
    eq = build_eq(reads, lengths, nwords)  # (Q, 4, nwords)

    # mask of the bit at position len-1 (the score row); none when len <= 0
    last = lengths - 1
    word_idx = torch.arange(nwords, dtype=I32, device=dev)[None, :]
    last_mask = torch.where(
        word_idx == torch.div(last, 32, rounding_mode="floor")[:, None],
        torch.ones((), dtype=I32, device=dev) << (last & 31)[:, None],
        0,
    )  # (Q, nwords)

    pv = torch.full((Q, nwords), -1, dtype=I32, device=dev)
    mv = torch.zeros((Q, nwords), dtype=I32, device=dev)
    score = lengths.clone()
    best = lengths.clone()
    end = torch.zeros(Q, dtype=I32, device=dev)
    zero_fill = torch.zeros(Q, dtype=I32, device=dev)
    for t in range(steps):
        # canonical search-variant recurrence (Myers 1999 / Hyyrö 2003):
        # free text start, so horizontal shifts fill with 0.  A step past
        # the window reads its last column, as the JAX loop's clamped index.
        c = windows[:, min(t, W - 1)].to(I32)
        peq = torch.gather(eq, 1, c.clamp(0, 3)[:, None, None].expand(Q, 1, nwords).long())[:, 0]
        peq = torch.where((c < 4)[:, None], peq, 0)  # Peq = 0 for N / out of range
        x0 = peq | mv
        d0 = (_add_with_carry(peq & pv, pv) ^ pv) | x0
        hn = pv & d0
        hp = mv | ~(pv | d0)
        score = (
            score
            + ((hp & last_mask) != 0).sum(dim=1, dtype=I32)
            - ((hn & last_mask) != 0).sum(dim=1, dtype=I32)
        )
        xs = _shl1_or(hp, zero_fill)
        mv = xs & d0
        pv = _shl1_or(hn, zero_fill) | ~(xs | d0)
        better = score < best  # strict: ties keep the earliest end
        end = torch.where(better, t + 1, end)
        best = torch.minimum(best, score)
    return best, end


def myers_semiglobal(reads, lengths, windows, nwords: int, max_window: int | None = None):
    """Min edit distance of each read vs. any substring of its window:
    (Q,) int32.  Reads (Q, L) and windows (Q, W) hold codes; >= 4 never
    matches."""
    return myers_semiglobal_end(reads, lengths, windows, nwords, max_window)[0]


def myers_semiglobal_end(reads, lengths, windows, nwords: int, max_window: int | None = None):
    """Like ``myers_semiglobal`` but also returns the best end column:
    (best (Q,), end (Q,)) int32, ``end`` the *exclusive* window end of the
    first (smallest) argmin — the tie-break shared with the banded engines.
    CUDA tensors go to the kernel, CPU tensors to the plain loop."""
    steps = windows.shape[1] if max_window is None else max_window
    if reads.is_cuda:
        from . import myers_cuda

        return myers_cuda.myers_semiglobal_cuda(reads, lengths, windows, nwords, steps)
    return _myers_plain(reads, lengths, windows, nwords, steps)


def myers_semiglobal_text_plain(text_words, n_text: int, starts, reads, lengths, rid, valid,
                                W: int, nwords: int):
    """The text entry's plain version: gather every lane's window and read,
    set the columns at or after ``valid`` to 4, then the plain loop."""
    rid = rid.long()
    wins = window.gather_windows(text_words, n_text, starts, W)
    col = torch.arange(W, dtype=I32, device=wins.device)
    wins = torch.where(col[None, :] >= valid.to(I32)[:, None], 4, wins)
    return _myers_plain(reads[rid], lengths[rid], wins, nwords, W)


def myers_semiglobal_text(
    text_words: torch.Tensor,  # (nw,) int32 packed text
    n_text: int,  # text length in bases
    starts: torch.Tensor,  # (Q,) int32 window starts (may be negative or past n_text)
    reads: torch.Tensor,  # (B, L) int8 codes; values >= 4 never match
    lengths: torch.Tensor,  # (B,) int32
    rid: torch.Tensor,  # (Q,) int32 read of each lane
    valid: torch.Tensor,  # (Q,) int32 columns at or after valid[q] never match
    W: int,  # window width
    nwords: int,
):
    """Myers of lane q: read ``rid[q]`` against the W text bases at
    ``starts[q]`` (code 4 off the text and at columns >= ``valid[q]``) ->
    (best (Q,), end (Q,)) int32, as ``myers_semiglobal_end`` gives them.

    A CUDA tensor launches the kernel, which streams each window from the
    packed words itself (no (Q, W) tensor is made); a CPU tensor takes
    ``myers_semiglobal_text_plain``.  Both give the same result on every
    lane."""
    if reads.is_cuda:
        from . import myers_cuda

        return myers_cuda.myers_semiglobal_text_cuda(
            text_words, n_text, starts, reads, lengths, rid, valid, W, nwords
        )
    return myers_semiglobal_text_plain(text_words, n_text, starts, reads, lengths, rid, valid,
                                       W, nwords)
