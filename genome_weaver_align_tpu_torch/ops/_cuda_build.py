"""Build and load the port's hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled at first use with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C entry, named by a hash of the source, the
shared headers and the flags, in this package's gitignored ``_build/``
directory (written to a private temporary name, then renamed into place),
and loaded with ``ctypes``.  ptxas reports each kernel's registers, shared memory and
spills (``-Xptxas -v``); the report is kept beside the library as
``<name>.ptxas.txt`` (``ptxas_report``).  Without ``nvcc``, or when the
build fails, loading raises: the kernels have no fallback to their plain
versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc`` when CUDA_HOME is set, else ``nvcc`` on PATH,
    else the toolkit's default install path."""
    home = os.environ.get("CUDA_HOME")
    candidates = [Path(home) / "bin" / "nvcc"] if home else [
        shutil.which("nvcc"), Path("/usr/local/cuda/bin/nvcc")
    ]
    for c in candidates:
        if c and Path(c).is_file():
            return str(c)
    raise RuntimeError(
        "cannot build the CUDA kernels: nvcc not found "
        f"(CUDA_HOME={home!r}; looked for {[str(c) for c in candidates if c]})"
    )


def _library_path(source: str) -> Path:
    """The library's path, named by a hash of the source, the shared
    headers (``csrc/*.cuh``) and the flags."""
    src = CSRC / source
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def ptxas_report(source: str) -> str:
    """What ptxas said when it built ``csrc/<source>`` ("" if not built)."""
    rep = _library_path(source).with_suffix(".ptxas.txt")
    return rep.read_text() if rep.exists() else ""


def load_kernel_library(source: str) -> ctypes.CDLL:
    """Compile ``csrc/<source>`` (once per source hash) and load it."""
    src = CSRC / source
    nvcc = find_nvcc()
    path = _library_path(source)
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        try:
            res = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                                 capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed to build {src.name} (rc={res.returncode}):\n"
                    f"{res.stderr[-4000:]}"
                )
            path.with_suffix(".ptxas.txt").write_text(res.stderr)
            os.replace(tmp, path)
        finally:
            tmp.unlink(missing_ok=True)
    return ctypes.CDLL(str(path))
