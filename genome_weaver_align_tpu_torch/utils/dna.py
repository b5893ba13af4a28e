"""DNA alphabet primitives (reference parity: ACGT/ACGTSequence, SURVEY.md §2 #1).

The 2-bit alphabet is A=0, C=1, G=2, T=3.  The FM-index sentinel ``$`` sorts
before every base and is handled *out of band* (see ``index.build``): packed
arrays only ever hold 2-bit codes.  Ambiguous bases (N and IUPAC codes) are
carried as code ``4`` by :func:`encode` and must be resolved by the caller
(genome: deterministic pseudo-random substitution recorded in a mask; reads:
mapped to 'A' but scored as mismatch by the verifier).
"""

from __future__ import annotations

import numpy as np

A, C, G, T = 0, 1, 2, 3
N_CODE = 4  # ambiguous marker produced by encode(); never stored packed

_ENC = np.full(256, N_CODE, dtype=np.uint8)
for i, ch in enumerate("ACGT"):
    _ENC[ord(ch)] = i
    _ENC[ord(ch.lower())] = i
_DEC = np.frombuffer(b"ACGTN", dtype=np.uint8)


def encode(seq) -> np.ndarray:
    """str/bytes -> uint8 code array (4 marks ambiguous)."""
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    raw = np.frombuffer(bytes(seq), dtype=np.uint8)
    return _ENC[raw]


def decode(codes: np.ndarray) -> str:
    return _DEC[np.asarray(codes, dtype=np.uint8)].tobytes().decode("ascii")


def complement(codes: np.ndarray) -> np.ndarray:
    """A<->T, C<->G; code 4 (N) maps to itself."""
    codes = np.asarray(codes)
    return np.where(codes < 4, 3 - codes, codes).astype(codes.dtype)


def revcomp(codes: np.ndarray) -> np.ndarray:
    return complement(codes)[::-1]


def resolve_ambiguous(codes: np.ndarray, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Replace N codes by deterministic pseudo-random bases.

    Returns (resolved_codes, n_mask).  Mirrors the common aligner practice of
    randomising N runs in the genome while remembering where they were.
    """
    codes = np.asarray(codes, dtype=np.uint8)
    mask = codes >= 4
    if not mask.any():
        return codes, mask
    rng = np.random.default_rng(seed)
    out = codes.copy()
    out[mask] = rng.integers(0, 4, size=int(mask.sum()), dtype=np.uint8)
    return out, mask
