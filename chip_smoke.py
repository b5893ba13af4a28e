#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port (``genome_weaver_align_tpu_torch``) on the card, one phase
per line, and exits non-zero at the first phase that fails:

1. environment: ``nvidia-smi`` name and power limit, torch and CUDA
   versions;
2. the host C++ library (``native/*.cpp``) and the banded-DP CUDA kernel
   (``csrc/banded_dp.cu``) are built from the checkout; the kernel is held
   against the plain torch version on the card, k = 1..4, at the main
   path's verify shape (65,536 reads x 6 lanes, L = 100),
   ragged lengths and dead lanes included: dist and end_b must be equal on
   every lane.  Both are timed at k = 2;
3. one fused align step on a 65,536-read batch, with the kernel and with
   the plain DP, both on the card: the packed results must be identical;
4. end to end through the port's CLI on a chr20-scale random genome
   (64,444,167 bp, one contig): ``index --seed 13`` (cached under
   ``smoke_cache/``), then ``align -k 2 --seed-table ... --batch-size 65536``
   on 6 x 65,536 simulated 100 bp reads with <= 2 substitutions.  The
   kernel must have been launched, and >= 99% of reads must map, >= 99% at
   their true strand and position (+-k);
5. where one align loop's time goes: the CLI's submit/finish/SAM loop run
   from arrays (no FASTQ parse or file write) on 8 batches of
   substitution-only reads, timed by stage on the host clock; the device's
   busy share and its largest items over 4 of those batches from
   ``torch.profiler``; and the same loop on reads of which 10% carry one
   indel, which take the host slow path (affine traceback).

The last lines are a JSON summary of the kernel, the card's name and power
limit as nvidia-smi prints them, and ``{"ok": true, "device": {...}}``.
Without a CUDA device the script fails and prints no result.  It imports
nothing of JAX.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
CACHE = ROOT / "smoke_cache"

GENOME_LEN = 64_444_167  # chr20 scale
GENOME_SEED = 0
SEED_J = 13
K = 2
L = 100
BATCH = 65_536
N_BATCHES = 6
VERIFY_SLACK = 6  # SuffixFilterAligner's default lanes per read
MIN_MAPPED = 0.99
MIN_CORRECT = 0.99


class SmokeFailure(Exception):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def dp_inputs(k: int, Q: int, W: int, seed: int):
    """Reads/windows like the verify stage's: half the lanes hold their read
    in the window (with a few substitutions), half are random; codes 0..4
    (4 = N); ragged lengths with some 0-length lanes."""
    import numpy as np

    rng = np.random.default_rng(seed)
    reads = rng.integers(0, 5, size=(Q, L), dtype=np.int8)
    windows = rng.integers(0, 5, size=(Q, W), dtype=np.int8)
    planted = rng.random(Q) < 0.5
    span = min(L, W - 2 * k)
    if span > 0:
        windows[planted, k : k + span] = reads[planted, :span]
        for _ in range(k):
            at = rng.integers(0, W, size=Q)
            windows[planted, at[planted]] = rng.integers(0, 4, size=int(planted.sum()))
    lengths = np.where(rng.random(Q) < 0.7, L, rng.integers(0, L + 1, size=Q)).astype(np.int32)
    lengths[rng.random(Q) < 0.01] = 0
    return reads, lengths, windows


def phase_kernel(torch, dev):
    """Build the kernel, compare it with the plain version, time both."""
    import numpy as np

    from genome_weaver_align_tpu_torch.ops import dp, dp_cuda

    t0 = time.time()
    dp_cuda._library()
    log(f"[2] built csrc/banded_dp.cu with nvcc for sm_90a in {time.time() - t0:.1f} s")
    Q = BATCH * VERIFY_SLACK
    max_err = 0
    timing = None
    for k in (1, 2, 3, 4):
        # the main-path window width, then a narrow one whose long reads
        # cannot reach the window end (dead lanes: dist saturates at INF)
        for W in (L + 3 * k, L // 2):
            r, ln, w = (torch.from_numpy(a).to(dev) for a in dp_inputs(k, Q, W, 10 * k + W))
            d_kern, e_kern = dp_cuda.banded_edit_distance_cuda(r, ln, w, k)
            d_plain, e_plain = dp.banded_edit_distance(r, ln, w, k)
            torch.cuda.synchronize()
            n_dead = int((d_plain >= dp.INF).sum())
            err = int((d_kern - d_plain).abs().max())
            max_err = max(max_err, err)
            n_bad_d = int((d_kern != d_plain).sum())
            n_bad_e = int((e_kern != e_plain).sum())
            log(f"[2] k={k} Q={Q} L={L} W={W}: {n_dead} dead lanes, dist mismatches "
                f"{n_bad_d}, end_b mismatches {n_bad_e}, max |dist err| {err}")
            check(n_bad_d == 0 and n_bad_e == 0, f"kernel disagrees with plain at k={k} W={W}")
            if k == 2 and W == L + 3 * k:
                ms = cuda_time_ms(lambda: dp_cuda.banded_edit_distance_cuda(r, ln, w, k), reps=20)
                plain_ms = cuda_time_ms(lambda: dp.banded_edit_distance(r, ln, w, k), reps=3, warmup=1)
                timing = (ms, plain_ms)
    return max_err, timing


def phase_fused_step(torch, dev, codes, offsets, positions):
    """One fused align step with the kernel and with the plain DP."""
    import numpy as np

    from genome_weaver_align_tpu.utils import packing
    from genome_weaver_align_tpu.utils.simulate import simulate_reads_array
    from genome_weaver_align_tpu_torch.models import pipeline
    from genome_weaver_align_tpu_torch.ops import dp

    text = torch.from_numpy(packing.pack(codes).view(np.int32)).to(dev)
    seed_tab = (torch.from_numpy(offsets).to(dev), torch.from_numpy(positions).to(dev))
    reads, _, _, _ = simulate_reads_array(codes, BATCH, L, seed=7, max_subs=2)
    rwords, nmask = pipeline.pack_reads_2bit(reads.astype(np.int8))
    args = (
        text, int(codes.size), seed_tab,
        torch.from_numpy(rwords.view(np.int32)).to(dev),
        torch.from_numpy(nmask.view(np.int32)).to(dev),
        torch.full((BATCH,), L, dtype=torch.int32, device=dev),
    )
    static = dict(L=L, k=K, n_pieces=K + 1, max_hits=8, max_cands=4 * (K + 1),
                  W=L + 3 * K, seed_j=SEED_J, verify_slack=VERIFY_SLACK)

    def step():
        return pipeline._fused_align_step_impl(*args, **static)

    out_kernel = step()
    with mock.patch.object(dp, "banded_edit_distance_best", dp.banded_edit_distance):
        out_plain = step()
        plain_ms = cuda_time_ms(step, reps=3, warmup=1)
    ms = cuda_time_ms(step, reps=5, warmup=1)
    torch.cuda.synchronize()
    same = torch.equal(out_kernel, out_plain)
    mapped = float(((out_kernel[1] & 15) <= K).float().mean())
    log(f"[3] fused step, {BATCH} reads: packed results identical={same}, mapped share "
        f"{mapped:.6f}; step {ms:.3f} ms with the kernel, {plain_ms:.3f} ms with the plain DP")
    check(same, "fused step differs between the kernel and the plain DP")
    check(mapped >= MIN_MAPPED, f"fused step mapped only {mapped:.4f}")


def build_index(cli, codes) -> tuple[Path, Path, float | None]:
    """The CLI index of the smoke genome, built once into smoke_cache/."""
    from genome_weaver_align_tpu.utils.fasta import Contig, write_fasta

    cache = CACHE / f"random_{GENOME_LEN}_seed{GENOME_SEED}"
    idx, seedf = cache / "genome.npz", cache / f"genome.npz.seed{SEED_J}.npz"
    if idx.exists() and seedf.exists():
        return idx, seedf, None
    tmp = cache.with_name(cache.name + f".tmp{os.getpid()}")
    tmp.mkdir(parents=True)
    write_fasta(tmp / "genome.fa", [Contig("chr20s", codes)])
    t0 = time.time()
    rc = cli.main(["index", str(tmp / "genome.fa"), "-o", str(tmp / "genome.npz"),
                   "--seed", str(SEED_J)])
    secs = time.time() - t0
    check(rc == 0, f"index exited {rc}")
    os.replace(tmp, cache)
    return idx, seedf, secs


def write_reads(path: Path, codes) -> None:
    import numpy as np

    from genome_weaver_align_tpu.utils.simulate import simulate_reads_array

    reads, pos, strand, _ = simulate_reads_array(codes, BATCH * N_BATCHES, L, seed=11, max_subs=2)
    seqs = np.frombuffer(b"ACGT", np.uint8)[reads].tobytes()
    qual = "I" * L
    with open(path, "w") as fh:
        fh.write("".join(
            f"@r{i}_p{p}_s{s}\n{seqs[i * L:(i + 1) * L].decode()}\n+\n{qual}\n"
            for i, (p, s) in enumerate(zip(pos.tolist(), strand.tolist()))
        ))


def score_sam(path: Path) -> tuple[int, int, int]:
    n = mapped = correct = 0
    with open(path) as fh:
        for line in fh:
            if line.startswith("@"):
                continue
            name, flag, _, pos = line.split("\t", 4)[:4]
            n += 1
            flag = int(flag)
            if flag & 4:
                continue
            mapped += 1
            _, tp, ts = name.split("_")
            if int(ts[1:]) == bool(flag & 16) and abs(int(pos) - 1 - int(tp[1:])) <= K:
                correct += 1
    return n, mapped, correct


def align_loop(aligner, reads, n_batches: int) -> dict:
    """The CLI's align loop (submit N+1, prefetch, finish N, SAM lines) on
    in-memory batches; host seconds by stage."""
    import numpy as np

    from genome_weaver_align_tpu_torch.models.pipeline import prefetch_result

    names = [f"r{i}" for i in range(BATCH)]
    lengths = np.full(BATCH, L, np.int32)
    quals = np.full((BATCH, L), 40, np.int32)
    t = dict(submit=0.0, finish=0.0, sam=0.0, n_slow=0)

    def finish(h, codes):
        t0 = time.perf_counter()
        ah = aligner.align_arrays_finish(h)
        t1 = time.perf_counter()
        aligner.to_sam_lines(names, codes, lengths, ah, quals=quals)
        t["finish"] += t1 - t0
        t["sam"] += time.perf_counter() - t1
        t["n_slow"] += aligner.last_stats["n_slow_traceback"]

    wall0 = time.perf_counter()
    pending = None
    for b in range(n_batches):
        codes = reads[b * BATCH:(b + 1) * BATCH]
        t0 = time.perf_counter()
        h = aligner.align_arrays_submit(codes.astype(np.int8), lengths)
        prefetch_result(h)
        t["submit"] += time.perf_counter() - t0
        if pending is not None:
            finish(*pending)
        pending = (h, codes)
    finish(*pending)
    t["wall"] = time.perf_counter() - wall0
    t["reads_per_s"] = n_batches * BATCH / t["wall"]
    return t


def device_busy(torch, prof) -> tuple[int, float, list]:
    """(device events, union of their intervals in s, the ten device items
    (kernels, copies) with the most device time as (name, ms, share of all
    device time)) from a finished torch.profiler run."""
    from collections import Counter

    spans = sorted(
        (e.time_range.start, e.time_range.end, e.name) for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
    )
    by_name = Counter()
    busy_us, cur_s, cur_e = 0.0, None, None
    for s, e, name in spans:
        by_name[name] += e - s
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy_us += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy_us += cur_e - cur_s
    total = sum(by_name.values()) or 1.0
    top = [(name, us / 1e3, us / total) for name, us in by_name.most_common(10)]
    return len(spans), busy_us / 1e6, top


def phase_profile(torch, dev, codes, card):
    """The align loop's host stages, the device's busy share, and the indel
    slow path."""
    from torch.profiler import ProfilerActivity, profile

    from genome_weaver_align_tpu.utils.simulate import simulate_reads_array
    from genome_weaver_align_tpu_torch import cli
    from genome_weaver_align_tpu_torch.index import native
    from genome_weaver_align_tpu_torch.index.files import load_index
    from genome_weaver_align_tpu_torch.index.seedtable import load_seed_table
    from genome_weaver_align_tpu_torch.models.pipeline import SuffixFilterAligner

    idx, seedf, _ = build_index(cli, codes)
    gi = load_index(idx)
    offsets, positions, sj = load_seed_table(seedf)
    aligner = SuffixFilterAligner(gi, k=K, seed_table=(offsets, positions), seed_j=sj,
                                  device=dev)
    subs, _, _, _ = simulate_reads_array(codes, BATCH * 8, L, seed=21, max_subs=2)
    align_loop(aligner, subs, 1)  # warm the allocator and the kernel's library
    t = align_loop(aligner, subs, 8)
    log(f"[5] array loop, 8 x {BATCH} substitution-only reads: {t['reads_per_s']:.1f} reads/s, "
        f"wall {t['wall']:.3f} s; host: pack + submit {t['submit']:.3f} s, finish "
        f"{t['finish']:.3f} s, SAM lines {t['sam']:.3f} s ({card})")

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        w0 = time.perf_counter()
        align_loop(aligner, subs, 4)
        torch.cuda.synchronize()
        wall = time.perf_counter() - w0
    n_ev, busy_s, top = device_busy(torch, prof)
    if n_ev:
        log(f"[5] device busy share over 4 batches under torch.profiler: {busy_s / wall:.4f} "
            f"({busy_s:.4f} s, union of {n_ev} device intervals, in {wall:.3f} s of wall) "
            f"({card})")
        for name, ms, share in top:
            log(f"[5]   {share:7.2%} of device time {ms:8.3f} ms  {name[:100]}")
    else:
        log("[5] device busy share: not measured (torch.profiler recorded no device events)")

    indel, _, _, has_indel = simulate_reads_array(codes, BATCH * 4, L, seed=22, max_subs=1,
                                                  indel_frac=0.1)
    t_sub = align_loop(aligner, subs, 4)
    t_ind = align_loop(aligner, indel, 4)
    omp = {True: "with OpenMP", False: "without OpenMP", None: "prebuilt"}[
        native.built_with_openmp]
    log(f"[5] indel slow path, 4 x {BATCH} reads, {int(has_indel.sum())} with one indel: "
        f"{t_ind['n_slow']} slow-path reads, finish {t_ind['finish']:.3f} s against "
        f"{t_sub['finish']:.3f} s for substitution-only reads; {t_ind['reads_per_s']:.1f} "
        f"against {t_sub['reads_per_s']:.1f} reads/s (native library {omp}, "
        f"{os.cpu_count()} host cores) ({card})")
    check(t_ind["n_slow"] > 0, "the indel reads never took the slow path")


def phase_cli(codes, card):
    from genome_weaver_align_tpu_torch import cli
    from genome_weaver_align_tpu_torch.ops import dp_cuda

    idx, seedf, index_s = build_index(cli, codes)
    log(f"[4] index --seed {SEED_J} of {GENOME_LEN} bp: "
        + (f"{index_s:.1f} s ({card})" if index_s is not None else f"cached in {idx.parent}"))
    work = CACHE / f"run{os.getpid()}"
    work.mkdir(parents=True)
    fq, sam, rep = work / "reads.fq", work / "out.sam", work / "report.json"
    write_reads(fq, codes)

    dp_cuda.banded_edit_distance_cuda.launches = 0
    rc = cli.main(["align", str(idx), str(fq), "-k", str(K), "--seed-table", str(seedf),
                   "--batch-size", str(BATCH), "--report", str(rep), "-o", str(sam)])
    launches = dp_cuda.banded_edit_distance_cuda.launches
    check(rc == 0, f"align exited {rc}")
    report = json.loads(rep.read_text())
    n, mapped, correct = score_sam(sam)
    shutil.rmtree(work)
    log(f"[4] align -k {K}: {n} reads, mapped {mapped / n:.6f}, correct {correct / n:.6f}, "
        f"{report['reads_per_s']} reads/s over {report['wall_s']} s ({card}), "
        f"kernel launches {launches}, device {report['device']}")
    check(n == BATCH * N_BATCHES, f"SAM holds {n} records")
    check(launches > 0, "the align run never launched the banded DP kernel")
    check(mapped / n >= MIN_MAPPED, f"mapped share {mapped / n:.4f} < {MIN_MAPPED}")
    check(correct / n >= MIN_CORRECT, f"correct share {correct / n:.4f} < {MIN_CORRECT}")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    try:
        import genome_weaver_align_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not importable from {ROOT}: {e}", file=sys.stderr)
        return 1
    import numpy as np

    from genome_weaver_align_tpu.utils.simulate import random_genome
    from genome_weaver_align_tpu_torch.index.seedtable import build_seed_table

    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"[1] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} visible")
    try:
        from genome_weaver_align_tpu_torch.index import native

        t0 = time.time()
        check(native.available(), "the native C++ library (native/*.cpp) did not build")
        omp = {True: "with OpenMP", False: "without OpenMP", None: "prebuilt, loaded"}[
            native.built_with_openmp]
        log(f"[2] built native/*.cpp with g++ in {time.time() - t0:.1f} s ({omp})")
        max_err, (ms, plain_ms) = phase_kernel(torch, dev)
        log(f"[2] k=2, {BATCH * VERIFY_SLACK} lanes: kernel {ms:.3f} ms, plain torch "
            f"{plain_ms:.3f} ms ({card})")
        t0 = time.time()
        codes = random_genome(GENOME_LEN, seed=GENOME_SEED)
        offsets, positions = build_seed_table(codes, SEED_J)
        log(f"[3] genome of {codes.size} bp and its {SEED_J}-mer seed table in "
            f"{time.time() - t0:.1f} s")
        phase_fused_step(torch, dev, codes, offsets, positions)
        del offsets, positions
        launches = phase_cli(codes, card)
        phase_profile(torch, dev, codes, card)
        check("jax" not in sys.modules, "the smoke imported jax")
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    log(json.dumps({"kernels": [{
        "name": "banded_dp",
        "route": "cuda",
        "source": "genome_weaver_align_tpu_torch/csrc/banded_dp.cu",
        "replaces": "genome_weaver_align_tpu/ops/dp_pallas.py:47",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    log(card_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
