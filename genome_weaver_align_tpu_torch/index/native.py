"""ctypes binding to the native C++ SA-IS builder (native/sais.cpp).

Host copy of ``genome_weaver_align_tpu.index.native`` with one change: the
shared ``native/*.cpp`` sources are compiled with ``g++`` into this
package's gitignored ``_build/`` directory, named by a hash of the sources
and flags and renamed into place once complete, instead of ``make`` writing
into ``native/``.  Falls back cleanly: callers use :func:`available` and
drop to the NumPy prefix-doubling builder otherwise.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parent.parent.parent / "native"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
_SOURCES = ("sais.cpp", "affine.cpp", "seedtable.cpp")
# native/Makefile's flags; -fopenmp is added when g++ can link it (see _build)
_CXXFLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-march=native",
             "-funroll-loops")
_lib = None
_build_failed = False
# whether this process's build linked OpenMP (None: it loaded a prebuilt one)
built_with_openmp: bool | None = None


# (symbol name, argtypes) — bound individually so a prebuilt .so missing a
# newer symbol degrades per-symbol instead of disabling ALL native paths
# (ADVICE r3: an AttributeError here used to set _build_failed globally)
_SYMBOLS = {
    "gwa_sais_u8": [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64,
    ],
    "gwa_bwt_u8": [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
    ],
    "gwa_seed_table": [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64,
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
    ],
}
_missing: set[str] = set()


def _bind(lib) -> set[str]:
    """Bind every known symbol; return the set that could not be bound."""
    missing = set()
    for name, argtypes in _SYMBOLS.items():
        try:
            fn = getattr(lib, name)
        except AttributeError:
            missing.add(name)
            continue
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    return missing


def _lib_path() -> Path:
    h = hashlib.sha256(" ".join((*_CXXFLAGS, "[-fopenmp]")).encode())
    for name in _SOURCES:
        h.update((_NATIVE_DIR / name).read_bytes())
    return _BUILD_DIR / f"libgwa_native-{h.hexdigest()[:16]}.so"


def _build(path: Path) -> None:
    """Compile into a private temp name, then rename: concurrent builders
    (test workers) never load a half-written library.

    A g++ without libgomp cannot link ``-fopenmp``; the sources guard their
    OpenMP use with ``#ifdef _OPENMP``, so the library is then built without
    it and gives the same results, with the affine traceback on one core."""
    global built_with_openmp
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    cmd = [os.environ.get("CXX", "g++"), *_CXXFLAGS, "-o", str(tmp)]
    cmd += [str(_NATIVE_DIR / s) for s in _SOURCES]
    try:
        try:
            subprocess.run([*cmd, "-fopenmp"], check=True, capture_output=True)
            built_with_openmp = True
        except subprocess.CalledProcessError:
            subprocess.run(cmd, check=True, capture_output=True)
            built_with_openmp = False
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)


def _load():
    global _lib, _build_failed, _missing
    if _lib is not None or _build_failed:
        return _lib
    try:
        path = _lib_path()
        if not path.exists():
            _build(path)
        lib = ctypes.CDLL(str(path))
        _missing = _bind(lib)
        _lib = lib
    except (OSError, subprocess.CalledProcessError):
        _build_failed = True
        _lib = None
    return _lib


def available() -> bool:
    """True when the core SA-IS/BWT symbols are usable."""
    return _load() is not None and not (
        {"gwa_sais_u8", "gwa_bwt_u8"} & _missing
    )


def _require(symbol: str):
    lib = _load()
    if lib is None or symbol in _missing:
        raise RuntimeError(f"native symbol {symbol} unavailable (build failed "
                           "or stale library without the symbol)")
    return lib


def suffix_array_native(codes: np.ndarray) -> np.ndarray:
    """SA of codes+$ via C++ SA-IS; int64 result for API parity."""
    lib = _require("gwa_sais_u8")
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    m = codes.size
    sa = np.empty(m + 1, dtype=np.int32)
    rc = lib.gwa_sais_u8(
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        sa.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int64(m),
    )
    if rc != 0:
        raise RuntimeError(f"gwa_sais_u8 failed rc={rc}")
    return sa.astype(np.int64)


def bwt_native(codes: np.ndarray, sa32: np.ndarray) -> tuple[np.ndarray, int]:
    """(bwt codes with $ row dropped, primary row index)."""
    lib = _require("gwa_bwt_u8")
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    sa32 = np.ascontiguousarray(sa32, dtype=np.int32)
    m = codes.size
    bwt = np.empty(m, dtype=np.uint8)
    primary = ctypes.c_int64(-1)
    rc = lib.gwa_bwt_u8(
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        sa32.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        bwt.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(m),
        ctypes.byref(primary),
    )
    if rc != 0:
        raise RuntimeError(f"gwa_bwt_u8 failed rc={rc}")
    return bwt, int(primary.value)


def seed_table_native(codes: np.ndarray, j: int) -> tuple[np.ndarray, np.ndarray]:
    """CSR j-mer table via the C++ counting sort (native/seedtable.cpp).

    Identical layout to ``index.seedtable.build_seed_table`` (oracle-tested);
    O(n) two-pass vs the NumPy argsort's O(n log n).
    """
    lib = _require("gwa_seed_table")
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    n = codes.size
    # mirror the C++ guard BEFORE allocating: a bad j would otherwise
    # attempt a multi-GB 4^j allocation and n < j raises a confusing
    # negative-dimension error from np.empty (ADVICE r3)
    if not (1 <= j and 2 * j <= 62):
        raise ValueError(f"seed table j={j} out of range (1 <= j, 2j <= 62)")
    if n < j:
        raise ValueError(f"sequence length {n} shorter than j={j}")
    if n >= 1 << 31:
        raise ValueError(f"sequence length {n} >= 2^31 (int32 positions)")
    offsets = np.empty(4**j + 1, dtype=np.int32)
    positions = np.empty(n - j + 1, dtype=np.int32)
    rc = lib.gwa_seed_table(
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(n),
        ctypes.c_int32(j),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        positions.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if rc != 0:
        raise RuntimeError(f"gwa_seed_table failed rc={rc}")
    return offsets, positions


def suffix_array_best(codes: np.ndarray) -> np.ndarray:
    """Native SA-IS when available, NumPy prefix doubling otherwise."""
    if available() and codes.size + 1 <= np.iinfo(np.int32).max:
        return suffix_array_native(codes)
    from .sais import suffix_array

    return suffix_array(codes)
