"""Binding of the hand-written CUDA banded-DP kernel (``csrc/banded_dp.cu``).

The kernel replaces the JAX package's Pallas kernel
``genome_weaver_align_tpu/ops/dp_pallas.py::_kernel`` and computes exactly
``ops.dp.banded_edit_distance``.  It is compiled at first use with ``nvcc``
for ``sm_90a`` into a shared library with a plain C entry, named by a hash
of the source and flags, in this package's gitignored ``_build/``
directory, and loaded with ``ctypes``.  Without ``nvcc``, or when the build
fails, loading raises: there is no fallback to the plain version.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from .dp import INF

_PKG = Path(__file__).resolve().parent.parent
_SOURCE = _PKG / "csrc" / "banded_dp.cu"
_BUILD_DIR = _PKG / "_build"
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
)
MAX_K = 8  # the kernel is instantiated for k = 1..MAX_K


def _find_nvcc() -> str:
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
        "cannot build the banded DP CUDA kernel: nvcc not found "
        f"(CUDA_HOME={home!r}; looked for {[str(c) for c in candidates if c]})"
    )


@functools.cache
def _library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    nvcc = _find_nvcc()
    h = hashlib.sha256(_SOURCE.read_bytes() + " ".join(_NVCC_FLAGS).encode())
    path = _BUILD_DIR / f"banded_dp-{h.hexdigest()[:16]}.so"
    if not path.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *_NVCC_FLAGS, "-o", str(tmp), str(_SOURCE)]
        try:
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed to build {_SOURCE.name} (rc={res.returncode}):\n"
                    f"{res.stderr[-4000:]}"
                )
            os.replace(tmp, path)
        finally:
            tmp.unlink(missing_ok=True)
    lib = ctypes.CDLL(str(path))
    vp = ctypes.c_void_p
    lib.gwa_banded_dp.argtypes = [
        vp, vp, vp, vp, vp, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, vp,
    ]
    lib.gwa_banded_dp.restype = ctypes.c_int
    return lib


def banded_edit_distance_cuda(
    reads: torch.Tensor,  # (Q, L) int8 codes on a CUDA device
    lengths: torch.Tensor,  # (Q,) int32
    windows: torch.Tensor,  # (Q, W) int8
    k: int,
):
    """Launch the kernel -> (dist (Q,) int32, end_b (Q,) int32), equal to
    ``ops.dp.banded_edit_distance`` on every lane.  Launches on the current
    stream without synchronising; counts each launch in ``.launches``."""
    if not (reads.is_cuda and lengths.device == reads.device == windows.device):
        raise ValueError("banded_edit_distance_cuda needs all tensors on one CUDA device")
    if reads.dtype != torch.int8 or windows.dtype != torch.int8 or lengths.dtype != torch.int32:
        raise ValueError(
            f"expected int8 reads/windows and int32 lengths, got "
            f"{reads.dtype}/{windows.dtype}/{lengths.dtype}"
        )
    if reads.dim() != 2 or windows.dim() != 2 or lengths.shape != (reads.shape[0],) \
            or windows.shape[0] != reads.shape[0]:
        raise ValueError(
            f"shape mismatch: reads {tuple(reads.shape)}, lengths "
            f"{tuple(lengths.shape)}, windows {tuple(windows.shape)}"
        )
    if not (reads.is_contiguous() and windows.is_contiguous() and lengths.is_contiguous()):
        raise ValueError("banded_edit_distance_cuda needs contiguous tensors")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k}: the CUDA banded DP is built for 1 <= k <= {MAX_K}")
    Q, L = reads.shape
    W = windows.shape[1]
    if L >= INF:  # distances must stay below the saturation value
        raise ValueError(f"read length {L} >= {INF}: kernel would saturate")
    lib = _library()
    dist = torch.empty(Q, dtype=torch.int32, device=reads.device)
    end_b = torch.empty(Q, dtype=torch.int32, device=reads.device)
    if Q == 0:
        return dist, end_b
    with torch.cuda.device(reads.device):
        rc = lib.gwa_banded_dp(
            reads.data_ptr(), lengths.data_ptr(), windows.data_ptr(),
            dist.data_ptr(), end_b.data_ptr(), Q, L, W, k,
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"gwa_banded_dp launch failed: CUDA error {rc}")
    banded_edit_distance_cuda.launches += 1
    return dist, end_b


banded_edit_distance_cuda.launches = 0
