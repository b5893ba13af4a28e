"""Build ``native/libgwa_native.so`` once, before any test is collected.

The JAX package builds this library on first use by running
``make -C native``, and the Makefile writes it in place (``-o $@``).  When
the test suite runs in several xdist workers on a checkout without the
library, every worker reaches that first use during collection and runs
the same make at once; a worker can then load a half-written file and
skip or fail the tests that need the library.

pytest imports this file in the controlling process before it starts any
xdist worker (and again in each worker), so the make runs here first,
under an exclusive lock, with the loader's own staleness check: the
library is missing or older than one of ``native/*.cpp``.  A worker that
takes the lock after the build finds the library current and does
nothing.  When the make fails, nothing changes: the loader tries again
and skips as it would have.
"""

import fcntl
import subprocess
from pathlib import Path

_NATIVE = Path(__file__).resolve().parent / "native"
_LIB = _NATIVE / "libgwa_native.so"


def _stale() -> bool:
    return not _LIB.exists() or any(
        _LIB.stat().st_mtime < src.stat().st_mtime for src in _NATIVE.glob("*.cpp")
    )


def _build_native_once() -> None:
    if not (_NATIVE / "Makefile").exists() or not _stale():
        return
    # the lock is held on this file itself, which every process can open
    with open(__file__, "rb") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if _stale():
                subprocess.run(["make", "-C", str(_NATIVE)], capture_output=True, check=False)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


_build_native_once()
