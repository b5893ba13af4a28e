#!/usr/bin/env python3
"""The sharded seed path's align step (``sharded_pipeline.make_sharded_seed_
align``: seed lookup, candidate merge, the window gather from the text
shards, the banded verify, best hit) at ``chip_smoke.py`` [11]'s shape,
from several checkouts in turn, on one card: 65,536 reads of 100 bases
(both strands, 0-2 substitutions) and their reverse complements, k = 2,
8 hits a piece, over the smoke's chr20-scale random genome (64,444,167
bases, seed 0) and its seed table (j = 13), the seed table and the text
in S interval shards on the card, stacked and one allocation a shard.

    python3 scripts/sharded_verify_ab.py [--shards 4,32] DIR [DIR ...]

Each DIR is a checkout of the repository (``git archive <commit>``
unpacked).  The runs go in the order given (parent, change, change,
parent to compare two commits), each in a fresh interpreter whose import
path starts at DIR.  The genome, its packed text and seed table are made
once, into this script's checkout's ``smoke_cache/``, and every run reads
them there.  A step is timed on the host's clock from a synchronised card to a
synchronised card (the host's own synchronisations inside the step
count), the first call left out, then five calls; the step's peak device
memory above what was allocated before it is read from
``torch.cuda.max_memory_allocated``.  Where the checkout has
``sharded_pipeline.gather_windows``, the window gather alone is timed the
same way on 1,048,576 windows of 106 bases at random starts over the
genome and its ends (``gather_ms``).  Each run prints one JSON line,
``{"dir": ..., "card": ..., "runs": {"S=4 stacked": {"ms": [...],
"reads_per_s": ..., "peak_bytes": ..., "digest": ..., "gather_ms":
[...]}, ...}}`` (``digest``: a hash of the step's outputs, equal across
checkouts that align alike); the script exits non-zero when a run
fails.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

CHILD = """
import hashlib, json, subprocess, sys, time
from pathlib import Path
import numpy as np
import torch
root, cache, shards = sys.argv[1], Path(sys.argv[2]), sys.argv[3]
sys.path.insert(0, root)
import genome_weaver_align_tpu_torch as port
from genome_weaver_align_tpu_torch.parallel import mesh as pmesh
from genome_weaver_align_tpu_torch.parallel import peer
from genome_weaver_align_tpu_torch.parallel import sharded_pipeline as sp
from genome_weaver_align_tpu_torch.utils.simulate import simulate_reads_array
assert Path(port.__file__).resolve().parent.parent == Path(root).resolve()
GENOME_LEN, GENOME_SEED, SEED_J, B, L, K, HITS = 64_444_167, 0, 13, 65_536, 100, 2, 8
z = np.load(cache / "genome.npz")
codes, words, offsets, positions = z["codes"], z["words"], z["offsets"], z["positions"]
reads, _, _, _ = simulate_reads_array(codes, B, L, seed=51, max_subs=2)
reads = np.concatenate([reads, (3 - reads)[:, ::-1]]).astype(np.int32)
dev = torch.device("cuda", 0)
r = torch.from_numpy(reads).to(dev)
ln = torch.full((r.shape[0],), L, dtype=torch.int32, device=dev)
card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                      capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]


def apart(table):
    return peer.Shards([t.clone() for t in table], table)


def wall_ms(fn, reps=5):
    fn()
    ms = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms


gen = torch.Generator(device=dev).manual_seed(7)
g_starts = torch.randint(-200, GENOME_LEN + 100, (1 << 20,), generator=gen, device=dev,
                         dtype=torch.int32)


runs = {}
for S in (int(x) for x in shards.split(",")):
    st = sp.put_seed(sp.shard_seed_table(offsets, positions, SEED_J, S), dev)
    tx = sp.put_text(sp.shard_text(words, GENOME_LEN, S), dev)
    for layout in ("stacked", "apart"):
        if layout == "apart":
            st = sp.ShardedSeedTable(apart(st.offsets), apart(st.positions), st.k_lo, st.k_hi,
                                     st.j)
            tx = sp.ShardedText(apart(tx.words), tx.base, tx.end, tx.n)
        fn = sp.make_sharded_seed_align(pmesh.make_layout(1, S, dev), like_seed=st, max_len=L,
                                        k=K, max_hits=HITS)
        out = fn(st, tx, r, ln)
        torch.cuda.synchronize()
        h = hashlib.sha256()
        for x in out:
            h.update(x.cpu().numpy().tobytes())
        ms = wall_ms(lambda: fn(st, tx, r, ln))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        fn(st, tx, r, ln)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev) - base
        runs[f"S={S} {layout}"] = {"ms": ms, "reads_per_s": r.shape[0] / (min(ms) / 1e3),
                                   "peak_bytes": peak, "digest": h.hexdigest()[:16]}
        if hasattr(sp, "gather_windows"):
            runs[f"S={S} {layout}"]["gather_ms"] = wall_ms(
                lambda: sp.gather_windows(tx, g_starts, L + 3 * K))
        print(f"S={S} {layout}: {runs[f'S={S} {layout}']}", file=sys.stderr, flush=True)
    del st, tx
print(json.dumps({"dir": root, "card": card, "runs": runs}), flush=True)
"""

MAKE = """
import sys
from pathlib import Path
import numpy as np
root, cache = sys.argv[1], Path(sys.argv[2])
sys.path.insert(0, root)
from genome_weaver_align_tpu_torch.index.seedtable import build_seed_table
from genome_weaver_align_tpu_torch.utils import packing
from genome_weaver_align_tpu_torch.utils.simulate import random_genome
codes = random_genome(64_444_167, seed=0)
offsets, positions = build_seed_table(codes, 13)
cache.mkdir(parents=True, exist_ok=True)
tmp = cache / "genome.tmp.npz"
np.savez(tmp, codes=codes, words=packing.pack(codes), offsets=offsets, positions=positions)
tmp.replace(cache / "genome.npz")
"""


def main(argv: list[str]) -> int:
    shards = "4"
    if argv[:1] == ["--shards"]:
        shards, argv = argv[1], argv[2:]
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent.parent
    cache = root / "smoke_cache" / "sharded_verify_ab"
    if not (cache / "genome.npz").exists():
        subprocess.run([sys.executable, "-c", MAKE, str(root), str(cache)], check=True,
                       timeout=1200)
    for d in argv:
        env = dict(os.environ, PYTHONPATH=str(Path(d).resolve()))
        res = subprocess.run([sys.executable, "-c", CHILD, str(Path(d).resolve()), str(cache),
                              shards], env=env, capture_output=True, text=True, timeout=1200)
        print(res.stdout, end="", flush=True)
        if res.returncode != 0:
            print(f"sharded_verify_ab: {d} failed (rc {res.returncode}):\n{res.stderr[-3000:]}",
                  file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
