#!/usr/bin/env python3
"""The two verify kernels at the main paths' shapes, from several checkouts
in turn, on one card: the banded DP's text entry at the verify shape
(65,536 reads x 6 lanes of 100 bases, k = 2, W = 106: ``chip_smoke.py``'s
``text_lanes``) and at the long-read segment shape (8,192 lanes of 128
bases, kb = 16: ``segment_lanes``; and at every band of the smoke's
``WIDE_KS``, k = 17-127, the group kernel), and the Myers text entry at
the rescue shape (2,048 lanes of 100 bases, W = 500: ``myers_text_lanes``).

    python3 scripts/verify_kernels_ab.py --smoke DIR DIR [DIR ...]

Each DIR is a checkout of the repository (``git archive <commit>``
unpacked).  The runs go in the order given (parent, change, change,
parent to compare two commits), each in a fresh interpreter whose import
path starts at DIR, so each run builds and loads its own checkout's
kernels; the inputs and the timing (CUDA events behind a device sleep,
two sets of 50 launches) come from the ``--smoke`` checkout's
``chip_smoke.py``, so every run times the same lanes.  Each run prints one
JSON line, ``{"dir": ..., "card": ..., "ms": {shape: [ms, ms]}}``; the
script exits non-zero when a run fails.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

CHILD = """
import importlib.util, json, sys
from pathlib import Path
import torch
root, smoke = sys.argv[1], sys.argv[2]
sys.path.insert(0, root)
spec = importlib.util.spec_from_file_location("chip_smoke", Path(smoke) / "chip_smoke.py")
s = importlib.util.module_from_spec(spec)
spec.loader.exec_module(s)
import genome_weaver_align_tpu_torch as port
from genome_weaver_align_tpu_torch.ops import dp_cuda, myers_cuda
assert Path(port.__file__).resolve().parent.parent == Path(root).resolve()
dev = torch.device("cuda", 0)
dp_cuda._library()
myers_cuda._library()
codes, words = s.random_text(torch, dev, s.GENOME_LEN, seed=3)
gen = torch.Generator(device=dev)
gen.manual_seed(4)
n = s.GENOME_LEN


def twice(fn):
    return [s.cuda_time_ms(fn, reps=50, hide_host=True) for _ in range(2)]


ms = {}
W = s.L + 3 * s.K
starts, reads, lengths, rid = s.text_lanes(torch, codes, s.K, W, gen)
a = (words, n, starts, reads, lengths, rid, s.K, W)
ms["banded text, k = 2, 393,216 lanes"] = twice(lambda: dp_cuda.banded_edit_distance_text_cuda(*a))
starts, reads, lengths, rid, W = s.segment_lanes(torch, dev, codes, gen, s.LONG_KB,
                                                 s.LONG_B * (s.LONG_L // s.LONG_SEG), s.LONG_SEG)
b = (words, n, starts, reads, lengths, rid, s.LONG_KB, W)
ms["banded text, kb = 16, 8,192 segments"] = twice(
    lambda: dp_cuda.banded_edit_distance_text_cuda(*b))
for k in s.WIDE_KS:
    starts, reads, lengths, rid, W = s.segment_lanes(torch, dev, codes, gen, k,
                                                     s.LONG_B * (s.LONG_L // s.LONG_SEG),
                                                     s.LONG_SEG)
    g = (words, n, starts, reads, lengths, rid, k, W)
    ms[f"banded text, k = {k}, 8,192 segments"] = twice(
        lambda: dp_cuda.banded_edit_distance_text_cuda(*g))
W = s.L + 400
starts, reads, lengths, rid, valid = s.myers_text_lanes(torch, codes, s.RESCUE_LANES, s.L, W,
                                                        gen, "identity")
c = (words, n, starts, reads, lengths, rid, valid, W, -(-s.L // 32))
ms["Myers text, L = 100, 2,048 lanes"] = twice(lambda: myers_cuda.myers_semiglobal_text_cuda(*c))
print(json.dumps({"dir": root, "card": s.card_line(), "ms": ms}), flush=True)
"""


def main(argv: list[str]) -> int:
    if len(argv) < 3 or argv[0] != "--smoke":
        print(__doc__, file=sys.stderr)
        return 2
    smoke, dirs = argv[1], argv[2:]
    for d in dirs:
        env = dict(os.environ, PYTHONPATH=str(Path(d).resolve()))
        res = subprocess.run([sys.executable, "-c", CHILD, str(Path(d).resolve()),
                              str(Path(smoke).resolve())], env=env, capture_output=True,
                             text=True, timeout=1200)
        print(res.stdout, end="", flush=True)
        if res.returncode != 0:
            print(f"verify_kernels_ab: {d} failed (rc {res.returncode}):\n{res.stderr[-3000:]}",
                  file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
