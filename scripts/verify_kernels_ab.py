#!/usr/bin/env python3
"""The two verify kernels at the main paths' shapes, from several checkouts
in turn, on one card: the banded DP's text entry at the verify shape
(65,536 reads x 6 lanes of 100 bases, k = 2, W = 106: ``chip_smoke.py``'s
``text_lanes``) and at the long-read segment shape (8,192 lanes of 128
bases, kb = 16: ``segment_lanes``; and at every band of the smoke's
``WIDE_KS``, k = 17-127, the group kernel), and the Myers text entry at
the rescue shape (2,048 lanes of 100 and of 256 bases, W = L + 400:
``myers_text_lanes``), past 8 words (the group kernel) at the smoke's
``WIDE_MYERS_L`` (2,048 lanes, W = L + 400) and at [8]'s first 300 bp
rescue call's shape (819 lanes, W = 1,250).

    python3 scripts/verify_kernels_ab.py --smoke DIR DIR[:GxP] [DIR ...]

Each DIR is a checkout of the repository (``git archive <commit>``
unpacked).  The runs go in the order given (parent, change, change,
parent to compare two commits), each in a fresh interpreter whose import
path starts at DIR, so each run builds and loads its own checkout's
kernels.  ``DIR:GxP`` runs that checkout with its ``myers_cuda.
group_shape`` answering (G, P) wherever G x P covers a group kernel's
words in registers (the binding's own pick elsewhere): another group
shape, timed as the binding would launch it, its (best, end) first held
against the plain version's on every lane.  The inputs the inputs and the timing (CUDA events behind a device sleep,
two sets of 50 launches) come from the ``--smoke`` checkout's
``chip_smoke.py``, so every run times the same lanes.  Each run prints one
JSON line, ``{"dir": ..., "group_shape": "GxP" or null, "card": ...,
"ms": {shape: [ms, ms]}, "shapes": {shape: "GxP"}}`` (``shapes``: the
group shape each group-kernel shape ran); the script exits non-zero when a
run fails.
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
root, smoke, forced = sys.argv[1], sys.argv[2], sys.argv[3]
sys.path.insert(0, root)
spec = importlib.util.spec_from_file_location("chip_smoke", Path(smoke) / "chip_smoke.py")
s = importlib.util.module_from_spec(spec)
spec.loader.exec_module(s)
import genome_weaver_align_tpu_torch as port
from genome_weaver_align_tpu_torch.ops import dp_cuda, myers, myers_cuda
assert Path(port.__file__).resolve().parent.parent == Path(root).resolve()
dev = torch.device("cuda", 0)
dp_cuda._library()
myers_cuda._library()
if forced:
    fG, fP = (int(x) for x in forced.split("x"))
    picked = myers_cuda.group_shape

    def group_shape(nwords):
        if myers_cuda.LANE_WORDS < nwords <= myers_cuda.MEM_WORDS and fG * fP >= nwords:
            return fG, fP
        return picked(nwords)

    myers_cuda.group_shape = group_shape
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
shapes = {}
for Q, Lr, W, tag in ([(s.RESCUE_LANES, 256, 656, "2,048 lanes")]
                      + [(s.RESCUE_LANES, Lr, Lr + 400, "2,048 lanes") for Lr in s.WIDE_MYERS_L]
                      + [(819, s.PAIR300_L, 1_250, "[8]'s rescue call, 819 lanes, W = 1,250")]):
    starts, reads, lengths, rid, valid = s.myers_text_lanes(torch, codes, Q, Lr, W, gen,
                                                            "identity")
    m = (words, n, starts, reads, lengths, rid, valid, W, -(-Lr // 32))
    if forced:
        got = myers_cuda.myers_semiglobal_text_cuda(*m)
        want = myers.myers_semiglobal_text_plain(*m)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), (forced, Lr)
    ms[f"Myers text, L = {Lr}, {tag}"] = twice(lambda: myers_cuda.myers_semiglobal_text_cuda(*m))
    if hasattr(myers_cuda, "group_shape") and m[-1] > myers_cuda.LANE_WORDS:
        shapes[f"Myers text, L = {Lr}, {tag}"] = "x".join(map(str, myers_cuda.group_shape(m[-1])))
print(json.dumps({"dir": root, "group_shape": forced or None, "card": s.card_line(), "ms": ms,
                  "shapes": shapes}), flush=True)
"""


def main(argv: list[str]) -> int:
    if len(argv) < 3 or argv[0] != "--smoke":
        print(__doc__, file=sys.stderr)
        return 2
    smoke, dirs = argv[1], argv[2:]
    for arg in dirs:
        d, _, forced = arg.partition(":")
        env = dict(os.environ, PYTHONPATH=str(Path(d).resolve()))
        res = subprocess.run([sys.executable, "-c", CHILD, str(Path(d).resolve()),
                              str(Path(smoke).resolve()), forced], env=env, capture_output=True,
                             text=True, timeout=1200)
        print(res.stdout, end="", flush=True)
        if res.returncode != 0:
            print(f"verify_kernels_ab: {arg} failed (rc {res.returncode}):\n{res.stderr[-3000:]}",
                  file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
