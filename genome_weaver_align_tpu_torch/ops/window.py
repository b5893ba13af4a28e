"""Genome window gather: packed text on the device -> per-candidate code windows.

Used by the DP verify stage: each candidate locus extracts W codes starting
at ``ws`` from the 2-bit packed text.  Out-of-range positions return code 4
(never matches, counts as an edit) so callers need no masks.

The packed words are held as int32 (the bits of the JAX package's uint32
words): torch's uint32 support is partial.  An arithmetic ``>>`` by at most
30 followed by ``& 3`` reads the same two bits either way.
"""

from __future__ import annotations

import torch


def gather_windows(
    text_words: torch.Tensor,  # (nw,) int32 packed text
    n: int,  # text length in bases
    starts: torch.Tensor,  # (Q,) int32 window starts (may be negative)
    width: int,
) -> torch.Tensor:
    """-> (Q, width) int8 codes, 4 where out of range.

    One word gather per base: the packed text (n/4 bytes, 16 MB at chr20
    scale) sits in the card's L2, so the per-base gather that the TPU
    avoided with a word-select loop is cheap here."""
    idx = starts.to(torch.int32)[:, None] + torch.arange(
        width, dtype=torch.int32, device=starts.device
    )[None, :]
    valid = (idx >= 0) & (idx < n)
    widx = (idx >> 4).clamp_(0, text_words.shape[0] - 1).long()
    codes = (text_words[widx] >> (2 * (idx & 15))) & 3
    return torch.where(valid, codes, 4).to(torch.int8)


def gather_windows_host(text_words, n: int, starts, width: int):
    """NumPy twin of ``gather_windows`` for small host-side cohorts.

    The slow-path CIGAR traceback needs a few dozen windows per batch;
    issuing a DEVICE gather for them from the finish path would enqueue a
    tiny op BEHIND the next pipelined batch's compute on the in-order
    stream and wait for it.  Decoding the few windows from the packed
    words on host keeps the device queue untouched.  Same semantics:
    (Q, width) codes, 4 out of range.  Host copy of the JAX package's
    function (tests pin the two)."""
    import numpy as np

    starts = np.asarray(starts, dtype=np.int64)
    nw = width // 16 + 2
    w0 = starts >> 4
    widx = w0[:, None] + np.arange(nw, dtype=np.int64)[None, :]
    words = np.asarray(text_words)[np.clip(widx, 0, len(text_words) - 1)]
    shifts = (2 * np.arange(16, dtype=np.uint32))[None, None, :]
    codes = ((words[:, :, None] >> shifts) & 3).astype(np.int8)
    codes = codes.reshape(starts.size, nw * 16)
    off = (starts - (w0 << 4)).astype(np.int64)
    cols = off[:, None] + np.arange(width, dtype=np.int64)[None, :]
    out = np.take_along_axis(codes, cols, axis=1)
    pos = starts[:, None] + np.arange(width, dtype=np.int64)[None, :]
    return np.where((pos >= 0) & (pos < n), out, np.int8(4))
