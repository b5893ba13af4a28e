"""Trace the interval-sharded exact search's ring merge (``merge="ring"``)
with ``torch.profiler`` and say where each chunk-step's time goes.

Usage (on a machine with CUDA cards):

    python3 scripts/ring_trace.py [--layouts cards4 card1x4 card1x1]
                                  [--out smoke_cache/ring_trace]

The traffic is ``chip_smoke.py``'s [10] / [20] exact search: BATCH reads
of L bases on the chr20-scale random genome (its index built once into
``smoke_cache/``, as the smoke builds it), S = SHARDS interval shards, the
ring merge at microbatch RING_MICROBATCH.  Layouts:

- ``cards4``: 4 processes, process r on card r (needs 4 cards): the ring
  merge across cards (the flag wait);
- ``card1x4``: 4 processes on card 0 (``CUDA_VISIBLE_DEVICES=0``): the
  sum kernel behind a host barrier;
- ``card1x1``: 1 process, the stacked shards: the one-process ring
  (``ring_merge``).

Every process runs the search once to warm up, once timed, and once more;
process 0 traces that last run (CPU and CUDA activities).  The code under
trace is marked with ``torch.profiler.record_function`` ranges put around
its functions here, whichever of them the checkout has: ``chunk-step``
(``backward_step``, ``_RingSlots.step``), ``partials``
(``local_occ_codes``, ``fused_occ``), ``merge`` (``_RingSlots.__call__``,
``_RingSlots.merge``), ``slot set-up`` (``_RingSlots.__init__``),
``locate`` and ``release``.  Each device activity is put in the innermost
range that encloses the host call that launched it (the trace's
correlation ids).  For each layout process 0 writes
``<out>/<layout>.json`` (the per-chunk-step figures: host ms, the
partials' device activities and device ms, the slot copy, the merge
kernel, the device's idle gaps), ``<out>/<layout>.txt`` (the profiler's
table) and ``<out>/<layout>.trace.json.gz`` (the timeline), and the
script prints one line a layout.  ``--summarise <out>/<layout>.json ...``
computes the figures again from the saved timelines.
"""

from __future__ import annotations

import argparse
import bisect
import gzip
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
LAYOUTS = {"cards4": (4, None), "card1x4": (4, "0"), "card1x1": (1, "0")}
REGIONS = ("chunk-step", "partials", "merge", "slot set-up", "locate", "release")
TIMEOUT_S = 900


def annotate(torch, si, peer) -> None:
    """Wrap the search's functions in ``record_function`` ranges, where the
    checkout has them."""
    from torch.profiler import record_function

    def wrap(owner, attr, region):
        fn = getattr(owner, attr, None)
        if fn is None:
            return

        def ranged(*a, **kw):
            with record_function(region):
                return fn(*a, **kw)

        setattr(owner, attr, ranged)

    wrap(si, "backward_step", "chunk-step")
    wrap(si, "local_occ_codes", "partials")
    wrap(si, "fused_occ", "partials")
    wrap(si, "locate", "locate")
    wrap(si, "ring_merge", "merge")
    wrap(peer, "release", "release")
    slots = si._RingSlots
    for attr, region in (("step", "chunk-step"), ("__call__", "merge"), ("merge", "merge"),
                         ("__init__", "slot set-up")):
        if attr in vars(slots):
            wrap(slots, attr, region)


def summarise(trace: dict, search_ms: float) -> dict:
    """Per-chunk-step figures from a chrome trace: the device activities
    (kernels, copies, sets) by the innermost range that launched them."""
    ev = trace["traceEvents"]
    ranges = {r: {} for r in REGIONS}
    launch = {}
    device = []
    for e in ev:
        cat, args = e.get("cat", ""), e.get("args", {})
        if e.get("ph") != "X":
            continue
        if cat == "user_annotation" and e["name"] in ranges:
            ranges[e["name"]].setdefault(e["tid"], []).append((e["ts"], e["ts"] + e["dur"]))
        elif cat in ("cuda_runtime", "cuda_driver") and "correlation" in args:
            launch[args["correlation"]] = (e["tid"], e["ts"])
        elif cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            device.append(e)
    for by_tid in ranges.values():  # each name's ranges as their union (they may nest)
        for tid, iv in by_tid.items():
            union = []
            for a, b in sorted(iv):
                if union and a < union[-1][1]:
                    union[-1] = (union[-1][0], max(union[-1][1], b))
                else:
                    union.append((a, b))
            by_tid[tid] = union

    def inside(region, tid, ts) -> bool:
        iv = ranges[region].get(tid, [])
        i = bisect.bisect_right(iv, (ts, float("inf"))) - 1
        return i >= 0 and iv[i][0] <= ts <= iv[i][1]

    def where(e) -> str:
        tid, ts = launch.get(e["args"].get("correlation"), (None, None))
        if tid is None:
            return "unlaunched"
        for region in ("locate", "partials", "slot set-up", "release"):
            if inside(region, tid, ts):
                return region
        if inside("merge", tid, ts):
            if e["cat"] == "gpu_memcpy":
                return "slot copy"
            kernel = "allreduce" in e["name"] or "push_wait" in e["name"]
            return "merge kernel" if kernel else "merge, other"
        return "chunk-step, other" if inside("chunk-step", tid, ts) else "outside the steps"

    by = {}
    spans = []
    for e in device:
        key = where(e)
        n, ms = by.get(key, (0, 0.0))
        by[key] = (n + 1, ms + e["dur"] / 1e3)
        spans.append((e["ts"], e["ts"] + e["dur"]))
    spans.sort()
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    window = (spans[-1][1] - spans[0][0]) / 1e3 if spans else 0.0
    steps = sum(len(v) for v in ranges["chunk-step"].values())
    host = {r: sum(b - a for tid, iv in ranges[r].items() for a, b in iv
                   if r != "partials" or inside("chunk-step", tid, a)) / 1e3 for r in REGIONS}
    per = max(1, steps)
    return {
        "search_ms_traced": search_ms, "chunk_steps": steps,
        "host_ms_a_chunk_step": host["chunk-step"] / per,
        "host_ms_in_merge_a_chunk_step": host["merge"] / per,
        "host_ms_in_partials_a_chunk_step": host["partials"] / per,
        "host_ms_slot_set_up": host["slot set-up"], "host_ms_release": host["release"],
        "host_ms_locate": host["locate"],
        "device": {k: {"count": n, "ms": ms, "count_a_chunk_step": n / per,
                       "ms_a_chunk_step": ms / per} for k, (n, ms) in sorted(by.items())},
        "device_window_ms": window, "device_busy_ms": busy / 1e3,
        "device_idle_ms": window - busy / 1e3,
        "device_idle_ms_a_chunk_step": (window - busy / 1e3) / per,
    }


def child(argv) -> int:
    tag, rank, n, port, idx, reads_path, out = argv
    rank, n = int(rank), int(n)
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke
    from genome_weaver_align_tpu_torch.index.files import load_index
    from genome_weaver_align_tpu_torch.parallel import mesh as pmesh
    from genome_weaver_align_tpu_torch.parallel import multihost as mh
    from genome_weaver_align_tpu_torch.parallel import peer
    from genome_weaver_align_tpu_torch.parallel import sharded_index as si

    torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    mh.initialize_distributed(f"127.0.0.1:{port}", n, rank)
    dev = mh.device()
    torch.cuda.set_device(dev)
    annotate(torch, si, peer)
    S = smoke.SHARDS
    gi = load_index(idx)
    layout = pmesh.make_layout(max(1, n // pmesh.interval_span(n, S)), S, dev)
    sh = si.put_sharded(si.shard_fm_index(gi.fwd, S), dev, layout)
    z = np.load(reads_path)
    reads = z["reads"]
    r, ln, _ = pmesh.shard_reads(layout, reads, np.full(reads.shape[0], reads.shape[1], np.int32))
    fn = si.make_sharded_exact_search(layout, reads.shape[1], sh, merge="ring",
                                      microbatch=smoke.RING_MICROBATCH)
    fn(sh, r, ln)  # warm-up
    torch.cuda.synchronize(dev)
    peer.barrier(layout.group)
    t0 = time.perf_counter()
    fn(sh, r, ln)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    peer.barrier(layout.group)
    result = {"layout": tag, "rank": rank, "ranks": n, "card": dev.index, "wall_s": wall}
    if rank == 0:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn(sh, r, ln)
            torch.cuda.synchronize(dev)
            traced = time.perf_counter() - t0
        path = Path(out) / f"{tag}.trace.json"
        prof.export_chrome_trace(str(path))
        trace = json.loads(path.read_text())
        with gzip.open(f"{path}.gz", "wt") as fh:
            json.dump(trace, fh)
        path.unlink()
        result.update(summarise(trace, 1e3 * traced))
        avg = prof.key_averages()
        try:
            table = avg.table(sort_by="self_device_time_total", row_limit=25)
        except (AttributeError, KeyError, ValueError):
            table = avg.table(sort_by="self_cuda_time_total", row_limit=25)
        (Path(out) / f"{tag}.txt").write_text(table)
    else:
        fn(sh, r, ln)
        torch.cuda.synchronize(dev)
    peer.barrier(layout.group)
    if n > 1:
        torch.distributed.destroy_process_group()
    print("TRACE_RESULT " + json.dumps(result), flush=True)
    return 0


def run_layout(tag, n, visible, idx, reads_path, out) -> list[dict]:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    if visible is not None:
        env["CUDA_VISIBLE_DEVICES"] = visible
    procs = [subprocess.Popen([sys.executable, __file__, "--child", tag, str(r), str(n), port,
                               str(idx), str(reads_path), str(out)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(n)]
    results = []
    try:
        for r, p in enumerate(procs):
            text, _ = p.communicate(timeout=TIMEOUT_S)
            lines = [ln for ln in text.splitlines() if ln.startswith("TRACE_RESULT ")]
            if p.returncode != 0 or len(lines) != 1:
                raise RuntimeError(f"{tag}: process {r} exited {p.returncode}: {text[-3000:]}")
            results.append(json.loads(lines[0].split(" ", 1)[1]))
    finally:
        for p in procs:
            p.kill()
            p.wait()
    return results


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--layouts", nargs="+", choices=list(LAYOUTS), default=list(LAYOUTS))
    p.add_argument("--out", default=str(ROOT / "smoke_cache" / "ring_trace"))
    a = p.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("ring_trace: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke
    from genome_weaver_align_tpu_torch import cli
    from genome_weaver_align_tpu_torch.parallel import mesh as pmesh
    from genome_weaver_align_tpu_torch.utils.simulate import random_genome

    out = Path(a.out)
    out.mkdir(parents=True, exist_ok=True)
    card = smoke.card_line()
    codes = random_genome(smoke.GENOME_LEN, seed=smoke.GENOME_SEED)
    t0 = time.time()
    idx, _, _ = smoke.build_index(cli, codes)
    _, reads, _ = smoke.sharded_search_reads(codes, pmesh.make_layout(1, 1, "cpu"))
    reads_path = out / "reads.npz"
    np.savez(reads_path, reads=reads.numpy())
    print(f"index and reads in {time.time() - t0:.1f} s ({card})", flush=True)
    for tag in a.layouts:
        n, visible = LAYOUTS[tag]
        if visible is None and torch.cuda.device_count() < n:
            print(f"{tag}: skipped, {torch.cuda.device_count()} card(s)", flush=True)
            continue
        t0 = time.time()
        res = run_layout(tag, n, visible, idx, reads_path, out)
        summary = {**res[0], "wall_s_by_rank": [r["wall_s"] for r in res], "card_line": card}
        (out / f"{tag}.json").write_text(json.dumps(summary, indent=1))
        print(f"{tag} ({time.time() - t0:.1f} s): " + json.dumps(summary), flush=True)
    reads_path.unlink()
    return 0


def resummarise(paths) -> int:
    """``--summarise LAYOUT.json ...``: the figures again from each
    layout's saved timeline (``LAYOUT.trace.json.gz`` beside it), written
    back into the JSON."""
    for p in map(Path, paths):
        summary = json.loads(p.read_text())
        with gzip.open(p.with_suffix(".trace.json.gz"), "rt") as fh:
            summary.update(summarise(json.load(fh), summary["search_ms_traced"]))
        p.write_text(json.dumps(summary, indent=1))
        print(f"{p.stem}: " + json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--summarise"]:
        sys.exit(resummarise(sys.argv[2:]))
    sys.exit(child(sys.argv[2:]) if sys.argv[1:2] == ["--child"] else main())
