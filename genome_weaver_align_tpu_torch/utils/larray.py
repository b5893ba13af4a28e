"""Large-array abstraction (SURVEY.md §2 #3).

The Java reference needed ``LSeq``/``LIntArray`` wrappers because Java arrays
are capped at 2^31 elements.  NumPy has no such cap, so the host side is a
thin facade; what survives of the concern on TPU is *index width*: device
arrays use int32, so any single index shard must stay below 2^31 elements.
Human chr1 (~230 Mbp) fits; a whole-genome (~3.1 Gbp) index must be built as
multiple sub-indexes (per chromosome group / per interval shard) — see
``parallel.sharded_index``.
"""

from __future__ import annotations

INT32_MAX = (1 << 31) - 1

# Hard per-part size cap.  Tighter than int32 by 2^20: the candidate machinery
# uses NO_CAND = 2^31 - 2^20 (models/suffix_filter.py) as an
# "invalid, sorts after every real diagonal" sentinel, so positions must stay
# strictly below it.  A part with n in (2^31-2^20, 2^31) would be int32-legal
# yet sort real candidates at/after the sentinel, silently displacing them —
# enforcing the tighter bound here closes that window for every upload path.
PART_LIMIT = (1 << 31) - (1 << 20)


def check_device_indexable(n: int, what: str = "array") -> None:
    """Reject sizes a single device index part cannot represent.

    ``n`` counts elements including any sentinel slot (callers pass
    ``codes.size + 1``).  The bound is PART_LIMIT, not int32-max — see above.
    """
    if n > PART_LIMIT:
        raise ValueError(
            f"{what} has {n} elements > 2^31-2^20 (candidate-sentinel "
            "headroom); split into sub-indexes (see parallel.sharded_index) "
            "before uploading to device"
        )
