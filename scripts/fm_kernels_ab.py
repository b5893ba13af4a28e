#!/usr/bin/env python3
"""Phase [18] of ``chip_smoke.py`` (the FM search kernels at their paths'
shapes), or with ``--phase modes`` its phase [13] (``-k 0``, ``--mode
onemm`` and ``--mode staircase`` through the CLI), or with ``--phase
locate`` its phase [19] without the edges and the S sweep (the locate and
the sharded locate at their five path shapes and on subsets of [7]'s rows;
the SASS of their loops; the sharded piece search at [11]) and its phase
[9] (the shard sums and the fused table entry, which reads the shard
tables through the same owner lookup) and the first part of its phase [20]
(the flag-wait sum, the ranks emulated on one card), from several
checkouts in turn, on one card.

    python3 scripts/fm_kernels_ab.py [--phase modes|locate] [--smoke DIR] [--old-limits]
        DIR [DIR ...]

Each DIR is a checkout of the repository (``git archive <commit>``
unpacked).  The runs go in the order given (parent, change, change,
parent to compare two commits), each in a fresh interpreter whose import
path starts at DIR, so each run builds and loads its own checkout's
kernels and plain loops.  With ``--smoke DIR`` every run drives them with
that checkout's ``chip_smoke.py`` (its shapes, counts and lane sweeps, the
sweeps left out for a binding without a lane choice), else each with its
own.  The smoke genome and repeat genome are indexed once, into the first
DIR's ``smoke_cache/``, and every run reads them there.  Each run prints
the phase's lines and then one JSON line, ``{"dir": ..., "kernels":
{entry: {"ms": ..., "plain_ms": ..., ...}}}`` for [18], ``{"dir": ...,
"launches": {mode: {kernel: n}}}`` for [13], ``{"dir": ..., "locate":
{case: {"ms": ..., ...}, "sweep": ..., "sass": ...}, "rings": {"table":
[ms, ...], ...}, "flag_wait": {"ms": ...}}`` for [19], [9] and [20]; the
script exits non-zero when a run fails.  A locate binding from before the
persistent grid (one thread a row, no ``launch_shape``) is given the grid
it launches, so ``--smoke`` with the newer checkout drives both.  ``--old-limits`` leaves out the
smoke's checks past 16 shards and 64 slots in every run (its
``PAST_OLD_LIMITS``), for a checkout whose kernels stop there.
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
root, cache, smoke, phase, old = sys.argv[1:6]
sys.path.insert(0, root)
spec = importlib.util.spec_from_file_location("chip_smoke", Path(smoke) / "chip_smoke.py")
s = importlib.util.module_from_spec(spec)
spec.loader.exec_module(s)
import genome_weaver_align_tpu_torch as port
from genome_weaver_align_tpu_torch.utils.simulate import random_genome, repeat_genome
print(f"package {Path(port.__file__).parent}, smoke {smoke}/chip_smoke.py", flush=True)
s.CACHE = Path(cache)
s.PAST_OLD_LIMITS = old != "old-limits"
s.MAX_SM_HZ = s.max_sm_hz()
s.INT_OPS_PER_S = s.int_ops_per_s(torch, s.MAX_SM_HZ)
codes = random_genome(s.GENOME_LEN, seed=s.GENOME_SEED)
if phase == "modes":  # the kernels built first, as the smoke's [2] builds them
    from genome_weaver_align_tpu_torch.ops import (
        dp_cuda, fm_search_cuda, one_mismatch_cuda, staircase_cuda,
    )
    for m in (dp_cuda, fm_search_cuda, one_mismatch_cuda, staircase_cuda):
        m._library()
    out = {"launches": s.phase_modes(codes, s.card_line())}
elif phase == "locate":  # the kernels built first, as the smoke's [2] builds them
    from genome_weaver_align_tpu_torch import cli
    from genome_weaver_align_tpu_torch.index.files import load_index
    from genome_weaver_align_tpu_torch.ops import fm_search_cuda, locate_cuda, ring_cuda
    for m in (fm_search_cuda, locate_cuda, ring_cuda):
        m._library()
    if not hasattr(locate_cuda, "launch_shape"):  # one thread a row: (blocks, capacity)
        locate_cuda.launch_shape = lambda Q, dev, sharded: (-(-Q // 256), -(-Q // 256) * 256)
    rep = repeat_genome(s.GENOME_LEN, seed=s.REPEAT_SEED)
    dev = torch.device("cuda", 0)
    out = {"locate": s.phase_locate(torch, dev, codes, rep, s.card_line(), edges=False)}
    fwd = load_index(s.build_index(cli, codes)[0]).fwd
    out["rings"] = s.phase_rings(torch, dev, fwd, s.card_line())[1]
    w = s.phase_flag_wait(torch, s.card_line())  # the flag-wait sum, ranks emulated
    out["flag_wait"] = {"ms": w["ms"], **{P: v["ms"] for P, v in w["wide"].items()}}
else:
    rep = repeat_genome(s.GENOME_LEN, seed=s.REPEAT_SEED)
    out = {"kernels": s.phase_fm_kernels(torch, torch.device("cuda", 0), codes, rep,
                                         s.card_line())}
print(json.dumps({"dir": root, "smoke": smoke, **out}, default=str), flush=True)
"""


def main(argv: list[str]) -> int:
    smoke, phase, old = None, "fm_kernels", "new-limits"
    while argv[:1] in (["--smoke"], ["--phase"], ["--old-limits"]) and len(argv) > 1:
        if argv[0] == "--old-limits":
            old = "old-limits"
            argv = argv[1:]
            continue
        if argv[0] == "--smoke":
            smoke = Path(argv[1]).resolve()
        elif argv[1] in ("fm_kernels", "modes", "locate"):
            phase = argv[1]
        else:
            print(f"fm_kernels_ab: unknown phase {argv[1]}", file=sys.stderr)
            return 2
        argv = argv[2:]
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    dirs = [Path(d).resolve() for d in argv]
    cache = dirs[0] / "smoke_cache"
    cache.mkdir(exist_ok=True)
    for i, d in enumerate(dirs):
        print(f"=== run {i + 1} of {len(dirs)}: {d}", flush=True)
        env = dict(os.environ, PYTHONPATH=str(d))
        rc = subprocess.run([sys.executable, "-c", CHILD, str(d), str(cache), str(smoke or d),
                             phase, old],
                            cwd=d, env=env).returncode
        if rc != 0:
            print(f"fm_kernels_ab: run {i + 1} ({d}) exited {rc}", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
