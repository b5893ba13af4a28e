"""Scored banded Smith-Waterman with affine gaps (SURVEY.md §2 #12).

The reference's ``SmithWatermanAligner`` produced a *scored* alignment
(match/mismatch/gap-open/gap-extension), not just an edit distance; round 1
back-derived AS from CIGAR+NM, which diverges from a true scored alignment
whenever the score optimum and the edit-distance optimum differ (VERDICT r1
missing-#3).  This module is the native scored engine: a banded semi-global
Gotoh DP, vectorised over the read cohort, plus a lockstep batched traceback
producing (score, start, CIGAR, NM) per read.

Score semantics (reference-style, matching BWA conventions and the round-1
``sam.alignment_score`` formula it replaces):

- match: +``match``      (default +1)
- mismatch (or N): -``mismatch``   (default -4)
- gap of length g: -(``gap_open`` + ``gap_ext``*(g-1))  (defaults 6, 1)
- semi-global: leading/trailing *window* bases are free; the read aligns
  end-to-end (no read clipping — the reference emitted full-length CIGARs).

Role in the pipeline: candidate *selection* stays with the edit-distance
engine (``ops.dp``) — it is the filter the suffix-filter search is complete
for — while the *emitted* alignment (CIGAR, POS, NM, AS) for indel reads
comes from this scored engine, so AS is the aligner's own maximum, not a
formula.

Band convention shared with ``ops.dp``: candidate window starts at
``cand - k``; band slot b in [0, 4k] at read row i represents window column
j = i + b - k.  In band coordinates the diagonal predecessor is the SAME
slot one row up, a read-consuming gap (I) is slot b+1 one row up, and a
window-consuming gap (D) is slot b-1 in the same row.
"""

from __future__ import annotations

import ctypes
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

_NEG = np.int32(-(1 << 20))

# Without OpenMP in the native library, ``affine_banded_batch`` splits a
# cohort of at least THREAD_MIN_ROWS rows into HOST_THREADS contiguous chunks
# and runs one native call per chunk on its own thread; smaller cohorts take
# one call, where a thread pool would cost more than it saves.
THREAD_MIN_ROWS = 256
HOST_THREADS = os.cpu_count() or 1

_native_fn = None
_native_failed = False


def _load_native():
    """gwa_affine_banded_batch from native/affine.cpp (same .so as SA-IS);
    None if the build is unavailable — callers fall back to the NumPy
    engine, which is also the oracle the native path is tested against."""
    global _native_fn, _native_failed
    if _native_fn is not None or _native_failed:
        return _native_fn
    from ..index import native as idx_native

    if not idx_native.available():
        _native_failed = True
        return None
    lib = idx_native._load()
    try:
        fn = lib.gwa_affine_banded_batch
    except AttributeError:  # stale .so built before affine.cpp existed
        _native_failed = True
        return None
    i8p = ctypes.POINTER(ctypes.c_int8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    fn.restype = ctypes.c_int
    fn.argtypes = [
        i8p, i32p, i8p,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        i32p, i32p, i32p,
        ctypes.c_char_p, ctypes.c_int32,
    ]
    _native_fn = fn
    return fn


def _score_rows(
    reads: np.ndarray,  # (Q, L) verify codes; >=4 never matches
    lengths: np.ndarray,  # (Q,)
    windows: np.ndarray,  # (Q, W) verify codes; >=4 never matches
    k: int,
    match: int,
    mismatch: int,
    gap_open: int,
    gap_ext: int,
):
    """Banded Gotoh keeping all rows: (H, E, F) each (Q, L+1, band) int32.

    H = best score ending in a diagonal (M) move, E = ending in a
    window-gap run (D, in-row), F = ending in a read-gap run (I).
    """
    Q, L = reads.shape
    W = windows.shape[1]
    band = 4 * k + 1
    boff = np.arange(band, dtype=np.int64) - k
    reads = np.asarray(reads, dtype=np.int64)
    lengths = np.asarray(lengths, dtype=np.int64)

    H = np.full((Q, L + 1, band), _NEG, dtype=np.int32)
    E = np.full((Q, L + 1, band), _NEG, dtype=np.int32)
    F = np.full((Q, L + 1, band), _NEG, dtype=np.int32)
    # row 0: leading window is free wherever j = b - k is a valid column
    H[:, 0, :] = np.where(boff >= 0, 0, _NEG)[None, :]

    for i in range(1, L + 1):
        prevH, prevF = H[:, i - 1, :], F[:, i - 1, :]
        j = i + boff[None, :]  # (1, band) current window column per slot
        valid = (j >= 0) & (j <= W)
        # diagonal: chars read[i-1], window[j-1]; same slot one row up
        wchar = np.take_along_axis(windows, np.clip(j - 1, 0, W - 1), axis=1)
        rchar = reads[:, i - 1][:, None]
        s = np.where((j >= 1) & (wchar == rchar) & (rchar < 4), match, -mismatch).astype(np.int32)
        diag = np.where(j >= 1, prevH + s, _NEG).astype(np.int32)
        # F (read gap / I): predecessors at slot b+1 one row up
        upH = np.concatenate([prevH[:, 1:], np.full((Q, 1), _NEG, np.int32)], axis=1)
        upF = np.concatenate([prevF[:, 1:], np.full((Q, 1), _NEG, np.int32)], axis=1)
        Fi = np.maximum(upH - gap_open, upF - gap_ext)
        Fi = np.where(valid, Fi, _NEG)
        diag = np.where(valid, diag, _NEG)
        # E (window gap / D): in-row running max over slots.  No clamping
        # anywhere: garbage accumulates at most ~L*gap_open below _NEG (no
        # int32 overflow) and stored values exactly match the traceback's
        # equality arithmetic.
        Ei = np.full((Q, band), _NEG, dtype=np.int32)
        Hi = np.full((Q, band), _NEG, dtype=np.int32)
        run_h = np.full(Q, _NEG, dtype=np.int32)  # H[i, b-1]
        run_e = np.full(Q, _NEG, dtype=np.int32)  # E[i, b-1]
        for b in range(band):
            e = np.where(
                valid[0, b],
                np.maximum(run_h - gap_open, run_e - gap_ext),
                _NEG,
            ).astype(np.int32)
            h = np.maximum(np.maximum(diag[:, b], Fi[:, b]), e).astype(np.int32)
            Ei[:, b] = e
            Hi[:, b] = h
            run_h, run_e = h, e
        active = (i <= lengths)[:, None]
        H[:, i, :] = np.where(active, Hi, prevH)
        E[:, i, :] = np.where(active, Ei, E[:, i - 1, :])
        F[:, i, :] = np.where(active, Fi, prevF)
    return H, E, F


def affine_banded_batch(
    reads: np.ndarray,
    lengths: np.ndarray,
    windows: np.ndarray,
    k: int,
    match: int = 1,
    mismatch: int = 4,
    gap_open: int = 6,
    gap_ext: int = 1,
):
    """Scored banded alignment + traceback; native C++ engine when built
    (bit-identical to the NumPy lockstep, and faster), NumPy fallback
    otherwise.  A native library without OpenMP runs large cohorts as row
    chunks on host threads (see THREAD_MIN_ROWS)."""
    fn = _load_native()
    if fn is None:
        return affine_banded_batch_numpy(
            reads, lengths, windows, k, match, mismatch, gap_open, gap_ext
        )
    Q, L = reads.shape
    W = windows.shape[1]
    r8 = np.ascontiguousarray(reads, dtype=np.int8)
    w8 = np.ascontiguousarray(windows, dtype=np.int8)
    l32 = np.ascontiguousarray(lengths, dtype=np.int32)
    score = np.empty(Q, np.int32)
    start = np.empty(Q, np.int32)
    nm = np.empty(Q, np.int32)
    # worst case run count <= ops count <= 3L + 2*band; <= 6 bytes per run
    cigar_cap = 6 * (3 * L + 2 * (4 * k + 1)) + 16
    buf = np.zeros((Q, cigar_cap), np.uint8)
    i8p = ctypes.POINTER(ctypes.c_int8)
    i32p = ctypes.POINTER(ctypes.c_int32)

    def rows(lo: int, hi: int) -> int:
        """One native call on rows [lo, hi): row slices of the C-ordered
        inputs and outputs are contiguous, so each call gets its own."""
        return fn(
            r8[lo:hi].ctypes.data_as(i8p), l32[lo:hi].ctypes.data_as(i32p),
            w8[lo:hi].ctypes.data_as(i8p),
            hi - lo, L, W, k, match, mismatch, gap_open, gap_ext,
            score[lo:hi].ctypes.data_as(i32p), start[lo:hi].ctypes.data_as(i32p),
            nm[lo:hi].ctypes.data_as(i32p),
            buf[lo:hi].ctypes.data_as(ctypes.c_char_p), cigar_cap,
        )

    from ..index import native as idx_native

    n_chunks = min(HOST_THREADS, Q)
    if idx_native.built_with_openmp is True or Q < THREAD_MIN_ROWS or n_chunks <= 1:
        rc = rows(0, Q)
    else:
        # a library built without OpenMP runs its row loop on one core; the
        # rows are independent and ctypes releases the GIL during a foreign
        # call, so contiguous row chunks run on a thread each
        bounds = np.linspace(0, Q, n_chunks + 1).astype(np.int64).tolist()
        with ThreadPoolExecutor(n_chunks) as pool:
            rc = max(pool.map(rows, bounds[:-1], bounds[1:]))
    if rc != 0:
        raise RuntimeError("native affine traceback failed")
    flat = buf.tobytes()
    cigars = [
        flat[q * cigar_cap : (q + 1) * cigar_cap].split(b"\0", 1)[0].decode()
        for q in range(Q)
    ]
    return score.astype(np.int64), start.astype(np.int64), cigars, nm.astype(np.int64)


def affine_banded_batch_numpy(
    reads: np.ndarray,
    lengths: np.ndarray,
    windows: np.ndarray,
    k: int,
    match: int = 1,
    mismatch: int = 4,
    gap_open: int = 6,
    gap_ext: int = 1,
):
    """Scored banded alignment + lockstep traceback for a read cohort.

    Returns (score (Q,), start_in_window (Q,), cigars list[str], nm (Q,))
    where nm counts mismatched M bases plus I/D bases of the *emitted*
    (score-optimal) alignment.  Tie preference M > I > D, end slot = first
    argmax (smallest window end), matching the edit engine's determinism.
    """
    Q, L = reads.shape
    W = windows.shape[1]
    band = 4 * k + 1
    boff = np.arange(band, dtype=np.int64) - k
    H, E, F = _score_rows(reads, lengths, windows, k, match, mismatch, gap_open, gap_ext)
    lengths = np.asarray(lengths, dtype=np.int64)
    reads = np.asarray(reads, dtype=np.int64)

    j_end = lengths[:, None] + boff[None, :]
    Hf = np.where((j_end >= 0) & (j_end <= W), H[np.arange(Q), lengths, :], _NEG)
    score = Hf.max(axis=1).astype(np.int64)
    b = Hf.argmax(axis=1).astype(np.int64)

    i = lengths.copy()
    state = np.zeros(Q, dtype=np.int8)  # 0=H, 1=E(D-run), 2=F(I-run)
    # provable bound: M/I steps <= L (each decrements i); D steps <= #I + band
    # (b stays in [0, band)); opening transitions (toE/toF, no op emitted)
    # <= one per gap run <= #D + #I.  Total <= 3L + 2*band.
    max_steps = 3 * L + 2 * band + 2
    ops = np.zeros((Q, max_steps), dtype=np.int8)  # 0 none, 1 M, 2 I, 3 D
    nm = np.zeros(Q, dtype=np.int64)
    q = np.arange(Q)
    for step in range(max_steps):
        active = (i > 0) | (state != 0)
        if not active.any():
            break
        j = i + b - k
        ip = np.maximum(i - 1, 0)
        wchar = np.take_along_axis(windows, np.clip(j - 1, 0, W - 1)[:, None], axis=1)[:, 0]
        rchar = np.take_along_axis(reads, np.clip(ip, 0, L - 1)[:, None], axis=1)[:, 0]
        is_match = (j >= 1) & (wchar == rchar) & (rchar < 4)
        s = np.where(is_match, match, -mismatch)

        inH = active & (state == 0)
        curH = H[q, i, b]
        diag_ok = inH & (i >= 1) & (j >= 1) & (curH == H[q, ip, b] + s)
        # tie preference M > I > D, same order as the edit-distance traceback
        toF = inH & ~diag_ok & (curH == F[q, i, b])
        toE = inH & ~diag_ok & ~toF & (curH == E[q, i, b])

        inE = active & (state == 1)
        bm = np.maximum(b - 1, 0)
        e_open = inE & (b >= 1) & (E[q, i, b] == H[q, i, bm] - gap_open)

        inF = active & (state == 2)
        bp = np.minimum(b + 1, band - 1)
        f_open = inF & (i >= 1) & (b + 1 < band) & (F[q, i, b] == H[q, ip, bp] - gap_open)

        if not bool(np.all(diag_ok | toE | toF | inE | inF | ~active)):
            raise RuntimeError("affine traceback stuck")  # not assert: must survive -O
        ops[:, step] = np.where(diag_ok, 1, np.where(inF, 2, np.where(inE, 3, 0)))
        nm += np.where(diag_ok & ~is_match, 1, 0) + inE + inF
        # transitions
        i = i - (diag_ok | inF)
        b = np.where(inE, b - 1, np.where(inF, b + 1, b))
        state = np.where(diag_ok, 0, state)
        state = np.where(toE, 1, state)
        state = np.where(toF, 2, state)
        state = np.where(inE & e_open, 0, state)
        state = np.where(inF & f_open, 0, state)
    if bool(((i > 0) | (state != 0)).any()):
        # truncation here would silently emit a wrong start/CIGAR/NM
        raise RuntimeError("affine traceback did not terminate within max_steps")
    start = (i + b - k).astype(np.int64)

    cigars = []
    sym = "?MID"
    for qi in range(Q):
        row = ops[qi][ops[qi] != 0][::-1]
        if row.size == 0:
            cigars.append("")
            continue
        cut = np.nonzero(np.diff(row))[0]
        runs = np.diff(np.r_[-1, cut, row.size - 1])
        vals = row[np.r_[cut, row.size - 1]]
        cigars.append("".join(f"{r}{sym[v]}" for r, v in zip(runs, vals)))
    return score, start, cigars, nm


# ---------------------------------------------------------------- host oracle

def affine_semiglobal_host(
    read: np.ndarray,
    window: np.ndarray,
    match: int = 1,
    mismatch: int = 4,
    gap_open: int = 6,
    gap_ext: int = 1,
) -> int:
    """Full-matrix Gotoh oracle: max score of read vs any window substring."""
    L, W = read.size, window.size
    NEG = -(1 << 30)
    Hp = np.zeros(W + 1, dtype=np.int64)  # row 0: leading window free
    Ep = np.full(W + 1, NEG, dtype=np.int64)
    Fp = np.full(W + 1, NEG, dtype=np.int64)
    for i in range(1, L + 1):
        Hc = np.full(W + 1, NEG, dtype=np.int64)
        Ec = np.full(W + 1, NEG, dtype=np.int64)
        Fc = np.maximum(Hp - gap_open, Fp - gap_ext)
        s = np.where((window == read[i - 1]) & (read[i - 1] < 4), match, -mismatch)
        diag = Hp[:-1] + s
        Hc[0] = Fc[0]
        for j in range(1, W + 1):
            Ec[j] = max(Hc[j - 1] - gap_open, Ec[j - 1] - gap_ext)
            Hc[j] = max(diag[j - 1], Fc[j], Ec[j])
        Hp, Ep, Fp = Hc, Ec, Fc
    return int(Hp.max())
