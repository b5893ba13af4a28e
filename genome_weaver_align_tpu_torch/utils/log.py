"""Logging + timing utilities (SURVEY.md §2 #17, §5.1; reference used
xerial-core ``Logger``/``StopWatch``).

``StopWatch`` prints per-phase wall time to stderr; ``trace_annotation``
marks a named range for ``torch.profiler`` and, on a CUDA device, for
NVTX; ``profile_to`` records a ``torch.profiler`` trace (host and CUDA
activity) as a Chrome/Perfetto JSON file.
"""

from __future__ import annotations

import contextlib
import logging
import sys
import time

logger = logging.getLogger("gwa_tpu")
if not logger.handlers:
    _h = logging.StreamHandler(sys.stderr)
    _h.setFormatter(logging.Formatter("[%(levelname)s %(name)s] %(message)s"))
    logger.addHandler(_h)
    logger.setLevel(logging.INFO)


class StopWatch:
    def __init__(self, stream=sys.stderr):
        self.t0 = self.last = time.time()
        self.stream = stream

    def lap(self, msg: str) -> float:
        now = time.time()
        dt = now - self.last
        self.last = now
        self.stream.write(f"[gwa-tpu +{now - self.t0:7.2f}s] {msg} ({dt:.2f}s)\n")
        return dt


@contextlib.contextmanager
def trace_annotation(name: str):
    """``torch.profiler.record_function`` range, plus an NVTX range when a
    CUDA device is present (no-op outside an active trace)."""
    import torch

    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


@contextlib.contextmanager
def profile_to(dir_path: str | None):
    """Capture a ``torch.profiler`` trace into ``dir_path/trace.json`` if
    given (CUDA activity too when a device is present)."""
    if not dir_path:
        yield
        return
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    os.makedirs(dir_path, exist_ok=True)
    prof.export_chrome_trace(os.path.join(dir_path, "trace.json"))
