#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port (``genome_weaver_align_tpu_torch``) on the card, one phase
per line, and exits non-zero at the first phase that fails:

1. environment: ``nvidia-smi`` name and power limit, torch and CUDA
   versions;
2. the host C++ library (``native/*.cpp``) and the CUDA kernels are built
   from the checkout.  The banded DP's text entry (window gathered from the
   2-bit text in the kernel) is held against its plain version on the card
   at the main path's verify shape (65,536 reads x 6 lanes, L = 100, on a
   chr20-scale random text), k = 1..14 (the aligner's k < 15), with starts
   off both text ends and next to word boundaries, ragged and 0-length
   reads, N codes, and a narrow window with dead lanes; the windows entry
   is held against the plain DP at k = 1..4 and 9..14 on random windows.
   dist and end_b must be equal on every lane.  At k = 2 the text entry,
   the stage it replaces (``gather_windows`` + ``reads[rid]`` + the windows
   entry), the windows entry alone and both plain versions are timed, the
   SASS of the text kernel's unrolled row loop is counted per band cell
   (``cuobjdump``), and ptxas's registers and spills at k = 14 are printed;
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
   indel, which take the host slow path (affine traceback, split over the
   host's cores when the native library has no OpenMP);
6. both Myers entries held against their plain versions on every lane:
   the windows entry (``csrc/myers.cu``, built in phase 2) at the
   paired-rescue shape (2,048 lanes x L + 400 window columns, L = 32, 64,
   100, 150, 256) and at a verify shape (65,536 x 6 lanes, L = 100,
   W = 106); the text entry (window streamed from the 2-bit text in the
   kernel) at the same shapes on a chr20-scale random text, with starts
   off both text ends and at word edges, ``valid`` < W (the insert bound)
   and repeated read ids.  At L = 100 the text entry, the stage it
   replaces (``gather_windows`` + ``where`` + ``contiguous`` + the windows
   entry), the windows entry and the plain versions are timed, and the
   text kernel's dependent chain a window column is counted from its SASS
   (the latency floor);
7. the FM pigeonhole path end to end: the CLI's ``align -k 2`` without a
   seed table on the same index, 2 x 65,536 reads; >= 99% mapped and
   correct, banded-DP kernel launched;
8. paired end to end: the CLI's ``align --paired --seed-table`` on 6 x
   16,384 pairs of 100 bp (FR mates, inserts 250-550, 1-2 substitutions a
   mate, 10% of mate2 with 4 more: unmappable at k = 2, within the rescue
   bar); >= 90% proper pairs and the Myers kernel launched; then the same
   pairs through ``PairedAligner.align_pair_arrays`` (inserts 200-600):
   pairs/s, the phase split, and >= 5% of pairs rescued; the rescue must
   reach the Myers text entry and never the windows entry;
9. the shard-sum kernels (``csrc/ring.cu``, built in phase 2) held against
   their plain torch versions on every element: the one-pass
   ``ring_psum`` over S = 1, 2, 3, 4, 8, 16 shards (int32 at 3, 777,
   65,536 and 4,194,304 elements a shard, float32 at 777 and 65,536, bit
   for bit); the fused rank + sum's words entry (``fused_rank_ring``) at
   S = 1, 2, 3, 4, 8, 16 and M = 1, 2, 3, 9, Q = 96 and 65,536, on rows
   gathered from the phase-4 index split into S interval shards, and its
   table entry (``sharded_index.fused_occ``: rows read from the shard
   tables) at S = 1, 2, 4, 8, 16, both also against the single-device
   ``rank.occ_codes``; then the kernels, their plain versions,
   ``parts.sum(0)`` and the stage the table entry replaces timed at the
   exact search's payloads (S = 4: sum (2, 32,768), fused M = 2,
   Q = 65,536);
10. the interval-sharded exact search at full size: the phase-4 index in
   4 interval shards on the card, 65,536 error-free forward-strand 100 bp
   reads; ``make_sharded_exact_search`` with ``merge="psum"``, ``"ring"``
   and ``"fused"`` (microbatch 2) must give the same (lo, hi, pos) as each
   other and as the single-device ``exact_interval_search`` + ``locate``,
   find every read, and place every unique one at its true start; the
   sum kernel launched 100 x 2 times and the fused table entry 100 times;
11. ``ShardedAligner`` end to end through the CLI: ``align -k 2
   --n-interval 4`` with the seed table on 65,536 reads and without it
   (FM shards) on 16,384 reads; the SAM body must be byte-identical to
   the single-device CLI's on the same FASTQ, >= 99% mapped and correct,
   and the banded-DP kernel launched.

Each path's kernel launch counts are set to 0 just before it runs and read
just after.  The last lines are a JSON summary of every kernel entry (each
with the run its launches were counted in, its time, its plain version's,
a bound from its inputs' bytes and operations, and the time of one PyTorch
call that computes the same function where there is one; integer work is
priced at the card's int32 issue rate, 64 a clock on each SM at the
maximum SM clock), the card's
name and power limit as
nvidia-smi prints them, and ``{"ok": true, "device": {...}}``.  Without a
CUDA device the script fails and prints no result.  It imports nothing of
JAX.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace
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
FM_BATCHES = 2  # FM-path CLI run: 2 x 65,536 reads
PAIR_BATCH = 16_384
PAIR_BATCHES = 6
MIN_PROPER = 0.9
MIN_RESCUED = 0.05
RESCUE_LANES = 2048
SHARDS = 4  # interval shards of phases 10-11
RING_MICROBATCH = 2
SHARDED_FM_READS = 16_384
# The card's published peaks (H100 SXM, at its full 700 W limit): memory
# bytes/s and the float32 rate outside the tensor cores.  Integer work is
# priced at the int32 issue rate, SMs x 64 a clock x the maximum SM clock,
# read from the card in main() (H100 SXM: 132 x 64 x 1.98 GHz = 16.7e12/s).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOAT_OPS_PER_S = 67e12
INT32_PER_CLOCK_PER_SM = 64
INT_OPS_PER_S = None  # set in main()
MAX_SM_HZ = None  # the card's maximum SM clock, set in main()
# Cycles from one fixed-latency integer instruction to a dependent one on
# Hopper, for the Myers latency floor: its step chain is counted in such
# links from the SASS.
CYCLES_PER_LINK = 4
# Least integer instructions per unit of work, as each kernel's source note
# derives them: a banded-DP band cell; a Myers step per read word and per
# step; a fused-rank word.
DP_OPS_PER_CELL = 4
MYERS_OPS_PER_WORD, MYERS_OPS_PER_STEP = 11, 5
RANK_OPS_PER_WORD = 7


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


def cuda_time_ms(fn, reps: int, warmup: int = 2, hide_host: bool = False) -> float:
    """Device ms per call from CUDA events around ``reps`` calls.  With
    ``hide_host`` the calls queue behind a ~0.1 s device sleep, so calls
    shorter than their host launch cost run back to back and the events
    time the device work, not the host."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if hide_host:
        torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def max_sm_hz() -> float:
    """The card's maximum SM clock in Hz."""
    res = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return float(res.stdout.strip().splitlines()[0]) * 1e6


def int_ops_per_s(torch, hz: float) -> float:
    """The card's int32 issue rate: SMs x 64 a clock x the maximum SM clock."""
    return torch.cuda.get_device_properties(0).multi_processor_count * INT32_PER_CLOCK_PER_SM * hz


def bound(n_bytes: float, int_ops: float, float_ops: float = 0.0) -> tuple[float, str]:
    """(least ms, what sets it): the bytes the function must move (each
    input read once, each output written once) over the memory rate, or
    its integer and float operations over their peak rates, whichever is
    longer."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = (int_ops / INT_OPS_PER_S + float_ops / PEAK_FLOAT_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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


def random_text(torch, dev, n: int, seed: int):
    """A random genome of n bases made on the card: (codes (n,) int8, the
    packed text (ceil(n / 16),) int32, 16 bases a word as ``utils.packing``
    lays them out)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    nw = -(-n // 16)
    codes = torch.randint(0, 4, (nw * 16,), generator=gen, device=dev, dtype=torch.int64)
    codes[n:] = 0
    words = (codes.view(nw, 16) << (2 * torch.arange(16, device=dev))).sum(1)
    words = torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)
    return codes[:n].to(torch.int8), words


def text_lanes(torch, codes, k: int, W: int, gen):
    """The verify stage's lanes on a text: BATCH reads of L, VERIFY_SLACK
    lanes a read with rid not decreasing and the last 1% of lanes on read 0
    (as ``compact_lanes`` leaves unused lanes).  Each read's first lane
    starts k before the read's true locus (the read copied from the text
    with up to k substitutions; N codes in 1% of reads), the other lanes at
    random starts, the first lanes off both text ends and next to word
    boundaries.  Ragged lengths, 1% zero.  -> (starts, reads, lengths,
    rid)."""
    dev = codes.device
    n = codes.numel()
    B, Q = BATCH, BATCH * VERIFY_SLACK
    rid = torch.div(torch.arange(Q, device=dev), VERIFY_SLACK, rounding_mode="floor")
    rid[-Q // 100:] = 0
    rid = rid.to(torch.int32)
    starts = torch.randint(-W, n + 5, (Q,), generator=gen, device=dev, dtype=torch.int32)
    locus = torch.randint(0, n - L, (B,), generator=gen, device=dev)
    starts[::VERIFY_SLACK] = (locus - k).to(torch.int32)
    edges = [-W - 7, -k - 1, -1, 0, 15, 16, 17, 31, 32, n - W - 1, n - W, n - W + 3, n - 1, n,
             n + 20]
    starts[: len(edges)] = torch.tensor(edges, dtype=torch.int32, device=dev)
    reads = codes[locus[:, None] + torch.arange(L, device=dev)[None, :]]
    rows = torch.arange(B, device=dev)
    for _ in range(k):
        at = torch.randint(0, L, (B,), generator=gen, device=dev)
        bump = torch.randint(1, 4, (B,), generator=gen, device=dev, dtype=torch.int8)
        reads[rows, at] = (reads[rows, at] + bump) % 4
    n_rows = torch.rand(B, generator=gen, device=dev) < 0.01
    reads[n_rows, torch.randint(0, L, (B,), generator=gen, device=dev)[n_rows]] = 4
    lengths = torch.where(torch.rand(B, generator=gen, device=dev) < 0.7, L,
                          torch.randint(0, L + 1, (B,), generator=gen, device=dev))
    lengths[torch.rand(B, generator=gen, device=dev) < 0.01] = 0
    return starts, reads.contiguous(), lengths.to(torch.int32), rid


def sass_per_cell(lib, tag: str) -> str:
    """Count the SASS of the loop with the most DPX ``VIADDMNMX`` (one a
    band cell) in the kernel whose mangled name holds ``tag``: instructions
    a cell and the loop's opcodes.  The kernel's whole SASS goes to
    ``smoke_cache/``."""
    import re
    from collections import Counter

    from genome_weaver_align_tpu_torch.ops._cuda_build import find_nvcc

    tool = Path(find_nvcc()).parent / "cuobjdump"
    if not tool.is_file():
        return f"not measured (no {tool})"
    res = subprocess.run([str(tool), "-sass", lib._name], capture_output=True, text=True,
                         timeout=300)
    for fn in res.stdout.split("Function : ")[1:]:
        name, _, body = fn.partition("\n")
        if tag not in name:
            continue
        CACHE.mkdir(exist_ok=True)
        (CACHE / f"sass_{tag}.txt").write_text(name + "\n" + body)
        insts = []
        for line in body.splitlines():
            m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+([^;]*);", line)
            if m:
                toks = m.group(2).split()
                op = toks[1] if toks[0].startswith("@") else toks[0]
                insts.append((int(m.group(1), 16), op.split(".")[0], m.group(2)))
        best = None
        for addr, op, text in insts:
            tgt = re.search(r"0x([0-9a-f]+)", text) if op == "BRA" else None
            if tgt and int(tgt.group(1), 16) <= addr:
                loop = [o for a, o, _ in insts if int(tgt.group(1), 16) <= a <= addr]
                cells = loop.count("VIADDMNMX")
                if cells and (best is None or cells > best[0]):
                    best = (cells, loop)
        if best is None:
            return f"{name}: no loop with VIADDMNMX found ({len(insts)} instructions)"
        cells, loop = best
        top = ", ".join(f"{op} {c}" for op, c in Counter(loop).most_common(12))
        return (f"{name}: row loop {len(loop)} instructions for {cells} band cells = "
                f"{len(loop) / cells:.2f} a cell ({top})")
    return f"no kernel named *{tag}* in {lib._name}"


def ptxas_usage(source: str, tag: str) -> str:
    """Registers and spills that ptxas reported for the kernel of
    ``csrc/<source>`` whose mangled name holds ``tag``."""
    import re

    from genome_weaver_align_tpu_torch.ops._cuda_build import ptxas_report

    for part in ptxas_report(source).split("Compiling entry function '")[1:]:
        name, _, rest = part.partition("'")
        if tag not in name:
            continue
        regs = re.search(r"Used (\d+) registers", rest)
        spill = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes "
                          r"spill loads", rest)
        return (f"{regs.group(1) if regs else '?'} registers, "
                + (f"{spill.group(1)} bytes stack frame, {spill.group(2)} bytes spill stores, "
                   f"{spill.group(3)} bytes spill loads" if spill else "no spill line"))
    return f"not measured (no ptxas entry *{tag}*)"


def phase_kernel(torch, dev, card):
    """Build all kernels; hold both banded-DP entries against their plain
    versions; time the text entry, the stage it replaces and the windows
    entry; the bound at the timed shape."""
    from concurrent.futures import ThreadPoolExecutor

    from genome_weaver_align_tpu_torch.ops import dp, dp_cuda, myers_cuda, ring_cuda, window

    t0 = time.time()
    libs = (dp_cuda._library, myers_cuda._library, ring_cuda._library)
    with ThreadPoolExecutor(len(libs)) as pool:  # one nvcc per source, all at once
        for f in [pool.submit(lib) for lib in libs]:
            f.result()
    log(f"[2] built csrc/banded_dp.cu, csrc/myers.cu and csrc/ring.cu with nvcc for sm_90a "
        f"in {time.time() - t0:.1f} s")
    Q = BATCH * VERIFY_SLACK
    max_err = 0
    timing = None
    for k in (1, 2, 3, 4, *range(9, dp_cuda.MAX_K + 1)):
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
            log(f"[2] windows entry k={k} Q={Q} L={L} W={W}: {n_dead} dead lanes, dist "
                f"mismatches {n_bad_d}, end_b mismatches {n_bad_e}, max |dist err| {err}")
            check(n_bad_d == 0 and n_bad_e == 0, f"windows entry disagrees with plain at k={k} W={W}")
        del r, ln, w, d_kern, e_kern, d_plain, e_plain

    codes, words = random_text(torch, dev, GENOME_LEN, seed=3)
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    for k in range(1, dp_cuda.MAX_K + 1):
        for W in ((L + 3 * k, L // 2) if k in (1, 2, 8, dp_cuda.MAX_K) else (L + 3 * k,)):
            starts, reads, lengths, rid = text_lanes(torch, codes, k, W, gen)
            args = (words, GENOME_LEN, starts, reads, lengths, rid, k, W)
            d_kern, e_kern = dp_cuda.banded_edit_distance_text_cuda(*args)
            d_plain, e_plain = dp.banded_edit_distance_text_plain(*args)
            torch.cuda.synchronize()
            n_dead = int((d_plain >= dp.INF).sum())
            n_hit = int((d_plain <= k).sum())
            err = int((d_kern - d_plain).abs().max())
            max_err = max(max_err, err)
            n_bad_d = int((d_kern != d_plain).sum())
            n_bad_e = int((e_kern != e_plain).sum())
            log(f"[2] text entry k={k} Q={Q} L={L} W={W}: {n_hit} lanes within k, {n_dead} "
                f"dead lanes, dist mismatches {n_bad_d}, end_b mismatches {n_bad_e}, "
                f"max |dist err| {err}")
            check(n_bad_d == 0 and n_bad_e == 0, f"text entry disagrees with plain at k={k} W={W}")
            if k == K and W == L + 3 * k:
                rid_l = rid.long()

                def old_stage():
                    wins = window.gather_windows(words, GENOME_LEN, starts, W)
                    return dp_cuda.banded_edit_distance_cuda(reads[rid_l], lengths[rid_l], wins, k)

                r, ln = reads[rid_l], lengths[rid_l]
                wins = window.gather_windows(words, GENOME_LEN, starts, W)
                times = {}
                for name, fn in (
                    ("text", lambda: dp_cuda.banded_edit_distance_text_cuda(*args)),
                    ("stage", old_stage),
                    ("windows", lambda: dp_cuda.banded_edit_distance_cuda(r, ln, wins, k)),
                    ("text2", lambda: dp_cuda.banded_edit_distance_text_cuda(*args)),
                ):
                    times[name] = cuda_time_ms(fn, reps=50, hide_host=True)
                plain_ms = cuda_time_ms(lambda: dp.banded_edit_distance_text_plain(*args),
                                        reps=3, warmup=1)
                win_plain_ms = cuda_time_ms(lambda: dp.banded_edit_distance(r, ln, wins, k),
                                            reps=3, warmup=1)
                # reads, lengths, rid, starts and the text words the windows
                # cover in, dist and end_b out; DP_OPS_PER_CELL a band cell of
                # every live read row
                w0 = (starts >> 4).long()[:, None] + torch.arange(W // 16 + 2, device=dev)
                n_words = int(torch.unique(w0.clamp(0, words.numel() - 1)).numel())
                rows = int(lengths[rid_l].clamp(0, L).sum())
                n_ops = DP_OPS_PER_CELL * (4 * k + 1) * rows
                n_bytes = reads.numel() + 4 * (BATCH + 2 * Q + n_words) + 8 * Q
                b_text = bound(n_bytes, n_ops)
                b_win = bound(Q * (L + W) + 12 * Q, n_ops)
                log(f"[2] k={k}, {Q} lanes over {BATCH} reads, W={W}, {rows} live read rows: text "
                    f"entry {times['text']:.4f} / {times['text2']:.4f} ms (bound {b_text[0]:.4f} ms "
                    f"by {b_text[1]}); the stage it replaces (gather_windows + reads[rid] + "
                    f"windows entry) {times['stage']:.4f} ms; windows entry alone "
                    f"{times['windows']:.4f} ms (bound {b_win[0]:.4f} ms by {b_win[1]}); plain "
                    f"{plain_ms:.3f} ms, windows plain {win_plain_ms:.3f} ms ({card})")
                timing = {"text": (min(times["text"], times["text2"]), plain_ms, *b_text),
                          "windows": (times["windows"], win_plain_ms, *b_win)}
                del wins, r, ln
    log(f"[2] SASS: {sass_per_cell(dp_cuda._library(), f'banded_dp_kernelILi{K}ELb1E')}")
    for entry, flag in (("text", 1), ("windows", 0)):
        tag = f"banded_dp_kernelILi{dp_cuda.MAX_K}ELb{flag}E"
        log(f"[2] ptxas, {entry} entry at k={dp_cuda.MAX_K}: {ptxas_usage('banded_dp.cu', tag)}")
    return max_err, timing


def phase_fused_step(torch, dev, codes, offsets, positions):
    """One fused align step with the kernel and with the plain DP."""
    import numpy as np

    from genome_weaver_align_tpu_torch.utils import packing
    from genome_weaver_align_tpu_torch.utils.simulate import simulate_reads_array
    from genome_weaver_align_tpu_torch.models import pipeline
    from genome_weaver_align_tpu_torch.ops import dp

    text = torch.from_numpy(packing.pack(codes).view(np.int32)).to(dev)
    seed_tab = (torch.from_numpy(offsets).to(dev), torch.from_numpy(positions).to(dev))
    reads, _, _, _ = simulate_reads_array(codes, BATCH, L, seed=7, max_subs=2)
    rwords, nmask = pipeline.pack_reads_2bit(reads.astype(np.int8))
    fm = SimpleNamespace(n=int(codes.size))  # the seed path reads only the text length
    args = (
        fm, text, None, seed_tab,
        torch.from_numpy(rwords.view(np.int32)).to(dev),
        torch.from_numpy(nmask.view(np.int32)).to(dev),
        torch.full((BATCH,), L, dtype=torch.int32, device=dev),
    )
    static = dict(L=L, k=K, n_pieces=K + 1, max_hits=8, kmer_j=0, kmer_full_cover=False,
                  max_cands=4 * (K + 1), W=L + 3 * K, seed_j=SEED_J,
                  verify_slack=VERIFY_SLACK)

    def step():
        return pipeline._fused_align_step_impl(*args, **static)

    out_kernel = step()
    with mock.patch.object(dp, "banded_edit_distance_text", dp.banded_edit_distance_text_plain):
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
    from genome_weaver_align_tpu_torch.utils.fasta import Contig, write_fasta

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


def write_reads(path: Path, codes, n: int = BATCH * N_BATCHES, seed: int = 11) -> None:
    import numpy as np

    from genome_weaver_align_tpu_torch.utils.simulate import simulate_reads_array

    reads, pos, strand, _ = simulate_reads_array(codes, n, L, seed=seed, max_subs=2)
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

    from genome_weaver_align_tpu_torch.utils.simulate import simulate_reads_array
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

    dp_cuda.banded_edit_distance_text_cuda.launches = 0
    dp_cuda.banded_edit_distance_cuda.launches = 0
    rc = cli.main(["align", str(idx), str(fq), "-k", str(K), "--seed-table", str(seedf),
                   "--batch-size", str(BATCH), "--report", str(rep), "-o", str(sam)])
    launches = dp_cuda.banded_edit_distance_text_cuda.launches
    win_launches = dp_cuda.banded_edit_distance_cuda.launches
    check(rc == 0, f"align exited {rc}")
    report = json.loads(rep.read_text())
    n, mapped, correct = score_sam(sam)
    shutil.rmtree(work)
    log(f"[4] align -k {K}: {n} reads, mapped {mapped / n:.6f}, correct {correct / n:.6f}, "
        f"{report['reads_per_s']} reads/s over {report['wall_s']} s ({card}), "
        f"banded-DP launches: text entry {launches}, windows entry {win_launches}, device "
        f"{report['device']}")
    check(n == BATCH * N_BATCHES, f"SAM holds {n} records")
    check(launches > 0, "the align run never launched the banded DP kernel's text entry")
    check(mapped / n >= MIN_MAPPED, f"mapped share {mapped / n:.4f} < {MIN_MAPPED}")
    check(correct / n >= MIN_CORRECT, f"correct share {correct / n:.4f} < {MIN_CORRECT}")
    return launches


def myers_inputs(Q: int, Lr: int, W: int, seed: int):
    """Rescue-like lanes: half hold their read (a few substitutions and an
    indel) somewhere in the window, half are random; codes 0..4 (4 = N);
    ragged lengths, some 0."""
    import numpy as np

    rng = np.random.default_rng(seed)
    reads = rng.integers(0, 5, size=(Q, Lr), dtype=np.int8)
    windows = rng.integers(0, 5, size=(Q, W), dtype=np.int8)
    planted = np.nonzero(rng.random(Q) < 0.5)[0]
    at = rng.integers(0, max(1, W - Lr - 1), size=planted.size)
    for q, a in zip(planted.tolist(), at.tolist()):
        seg = np.delete(reads[q], rng.integers(0, Lr)) if rng.random() < 0.3 else reads[q]
        span = min(seg.size, W - a)
        windows[q, a : a + span] = seg[:span]
    cols = rng.integers(0, W, size=(planted.size, 3))
    windows[planted[:, None], cols] = rng.integers(0, 4, size=cols.shape)
    lengths = np.where(rng.random(Q) < 0.8, Lr, rng.integers(0, Lr + 1, size=Q)).astype(np.int32)
    lengths[rng.random(Q) < 0.01] = 0
    return reads, lengths, windows


def sass_loop(lib, tags) -> tuple[str, list]:
    """(kernel name, the instructions of its longest loop as (opcode,
    operand text)) for the kernel of ``lib`` whose mangled name holds every
    tag; the kernel's whole SASS goes to ``smoke_cache/``."""
    import re

    from genome_weaver_align_tpu_torch.ops._cuda_build import find_nvcc

    tool = Path(find_nvcc()).parent / "cuobjdump"
    if not tool.is_file():
        return f"no {tool}", []
    res = subprocess.run([str(tool), "-sass", lib._name], capture_output=True, text=True,
                         timeout=300)
    for fn in res.stdout.split("Function : ")[1:]:
        name, _, body = fn.partition("\n")
        if not all(t in name for t in tags):
            continue
        CACHE.mkdir(exist_ok=True)
        (CACHE / f"sass_{'_'.join(tags)}.txt").write_text(name + "\n" + body)
        insts = []
        for line in body.splitlines():
            m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+([^;]*);", line)
            if m:
                toks = m.group(2).split(None, 2 if m.group(2).startswith("@") else 1)
                guard = toks[0] if toks[0].startswith("@") else ""
                rest = toks[1:] if guard else toks
                insts.append((int(m.group(1), 16), rest[0], (rest[1] if len(rest) > 1 else ""),
                              guard))
        best = []
        for addr, op, text, _ in insts:
            tgt = re.search(r"0x([0-9a-f]+)", text) if op.startswith("BRA") else None
            if tgt and int(tgt.group(1), 16) <= addr:
                loop = [i for i in insts if int(tgt.group(1), 16) <= i[0] <= addr]
                if len(loop) > len(best):
                    best = loop
        return name, best
    return f"no kernel named *{'*'.join(tags)}*", []


def dependent_chain(loop, iterations: int = 4) -> int:
    """Instructions on the longest dependency chain of one steady-state
    trip round ``loop`` (SASS as ``sass_loop`` gives it): registers and
    predicates read and written, each fixed-latency instruction one link;
    loads, shared-memory and special-register reads are left off (the
    stream prefetches its word a trip ahead)."""
    import re

    reg = re.compile(r"(?<![\w.])!?-?~?\|?(R\d+|P\d)(\.64)?")
    ready: dict[str, int] = {}
    ends = []
    for _ in range(iterations):
        top = 0
        for _, op, text, guard in loop:
            ops = [o.strip() for o in text.split(",")] if text else []
            dests: list[str] = []
            if ops and not ops[0].startswith("[") and not op.startswith(("ST", "BRA", "BAR", "RED",
                                                                         "ATOM", "EXIT", "RET")):
                first = ops[0].lstrip("!")
                if re.fullmatch(r"R\d+(\.64)?|P\d|PT", first):
                    dests.append(ops[0])
                    for o in ops[1:]:
                        if re.fullmatch(r"P\d|PT", o):
                            dests.append(o)
                        else:
                            break
                    if first.startswith("P"):
                        dests = dests[:2]
            srcs = [o for o in ops if o not in dests] + ([guard[1:]] if guard else [])
            names = []
            for o in srcs:
                for m in reg.finditer(o.replace(".reuse", "")):
                    names.append(m.group(1))
                    if m.group(2):
                        names.append(f"R{int(m.group(1)[1:]) + 1}")
            t = max([ready.get(n, 0) for n in names] + [0])
            fixed = not op.startswith(("LD", "S2R", "S2UR", "CS2R", "LDS", "LDG", "LDC", "ULDC",
                                       "SHFL", "MATCH", "VOTE", "REDUX"))
            t += 1 if fixed else 0
            for d in dests:
                d = d.lstrip("!")
                if d.endswith(".64"):
                    ready[d[:-3]] = ready[f"R{int(d[1:-3]) + 1}"] = t
                elif d not in ("PT", "RZ"):
                    ready[d] = t
            top = max(top, t)
        ends.append(top)
    return ends[-1] - ends[-2]


def myers_text_lanes(torch, codes, Q: int, Lr: int, W: int, gen, rid_mode: str):
    """Text-entry lanes on the card: Q windows of W over the text, half of
    them holding their read (substitutions, and an indel in 30%), starts off
    both text ends and at word edges, ragged and 0 lengths, 1% N codes.
    rid_mode "identity" (the rescue), "repeat" (the second half of the lanes
    re-reads random rows) or "verify" (VERIFY_SLACK lanes a read).  valid is
    the rescue's insert bound W - Lr + length in half the lanes, random in
    [-2, W] in a tenth, W elsewhere.  -> (starts, reads, lengths, rid,
    valid)."""
    dev = codes.device
    n = codes.numel()
    B = Q // VERIFY_SLACK if rid_mode == "verify" else Q
    starts = torch.randint(-W, n + 5, (Q,), generator=gen, device=dev, dtype=torch.int32)
    locus = torch.randint(0, n - W, (B,), generator=gen, device=dev)
    off = torch.randint(0, W - Lr, (B,), generator=gen, device=dev)
    reads = codes[(locus + off)[:, None] + torch.arange(Lr + 1, device=dev)[None, :]]
    indel = torch.rand(B, generator=gen, device=dev) < 0.3
    cut = torch.randint(0, Lr, (B,), generator=gen, device=dev)
    col = torch.arange(Lr, device=dev)[None, :]
    reads = torch.where(indel[:, None] & (col >= cut[:, None]), reads[:, 1:], reads[:, :Lr])
    rows = torch.arange(B, device=dev)
    for _ in range(2):
        at = torch.randint(0, Lr, (B,), generator=gen, device=dev)
        reads[rows, at] = (reads[rows, at] + torch.randint(1, 4, (B,), generator=gen, device=dev,
                                                           dtype=torch.int8)) % 4
    n_rows = torch.rand(B, generator=gen, device=dev) < 0.01
    reads[n_rows, torch.randint(0, Lr, (B,), generator=gen, device=dev)[n_rows]] = 4
    lengths = torch.where(torch.rand(B, generator=gen, device=dev) < 0.8, Lr,
                          torch.randint(0, Lr + 1, (B,), generator=gen, device=dev))
    lengths[torch.rand(B, generator=gen, device=dev) < 0.01] = 0
    if rid_mode == "verify":
        rid = torch.div(torch.arange(Q, device=dev), VERIFY_SLACK, rounding_mode="floor")
        starts[::VERIFY_SLACK] = (locus + off - K).to(torch.int32)
    else:
        rid = torch.arange(Q, device=dev)
        if rid_mode == "repeat":
            rid[Q // 2:] = torch.randint(0, Q, (Q - Q // 2,), generator=gen, device=dev)
        planted = torch.arange(0, Q, 2, device=dev)
        starts[planted] = locus[planted].to(torch.int32)
    edges = [-W - 7, -W + 3, -1, 0, 15, 16, 17, 31, n - W - 1, n - W, n - W + 3, n - 1, n, n + 20]
    starts[: len(edges)] = torch.tensor(edges, dtype=torch.int32, device=dev)
    rid = rid.to(torch.int32)
    valid = torch.full((Q,), W, dtype=torch.int32, device=dev)
    if rid_mode != "verify":
        valid[::2] = (W - Lr + lengths[rid.long()][::2]).to(torch.int32)
        some = torch.rand(Q, generator=gen, device=dev) < 0.1
        valid[some] = torch.randint(-2, W + 1, (int(some.sum()),), generator=gen, device=dev,
                                    dtype=torch.int32)
    return starts, reads.contiguous(), lengths.to(torch.int32), rid, valid


def phase_myers(torch, dev, card):
    """Both Myers entries against their plain versions on every lane; the
    text entry, the stage it replaces, the windows entry and the plain
    versions timed; the text kernel's step chain from its SASS."""
    from genome_weaver_align_tpu_torch.ops import myers, myers_cuda, window

    max_err = 0
    times = {}
    shapes = [(RESCUE_LANES, Lr, Lr + 400) for Lr in (32, 64, 100, 150, 256)]
    shapes.append((BATCH * VERIFY_SLACK, L, L + 3 * K))
    for Q, Lr, W in shapes:
        r, ln, w = (torch.from_numpy(a).to(dev) for a in myers_inputs(Q, Lr, W, Lr + Q))
        nwords = -(-Lr // 32)
        b_kern, e_kern = myers_cuda.myers_semiglobal_cuda(r, ln, w, nwords)
        b_plain, e_plain = myers._myers_plain(r, ln, w, nwords, W)
        torch.cuda.synchronize()
        err = max(int((b_kern - b_plain).abs().max()), int((e_kern - e_plain).abs().max()))
        max_err = max(max_err, err)
        n_bad = int(((b_kern != b_plain) | (e_kern != e_plain)).sum())
        n_hit = int((b_plain <= max(K, Lr // 20)).sum())
        log(f"[6] windows entry Q={Q} L={Lr} W={W}: {n_hit} lanes within the rescue bar, "
            f"(best, end) mismatches {n_bad}, max |err| {err}")
        check(n_bad == 0, f"Myers windows entry disagrees with plain at Q={Q} L={Lr} W={W}")
        if Lr == L:
            shape = "rescue" if Q == RESCUE_LANES else "verify"
            ms = cuda_time_ms(lambda: myers_cuda.myers_semiglobal_cuda(r, ln, w, nwords), reps=50,
                              hide_host=True)
            plain_ms = cuda_time_ms(lambda: myers._myers_plain(r, ln, w, nwords, W),
                                    reps=2, warmup=1)
            # reads, lengths and windows in, best and end out; the least
            # integer work of a window column of each non-empty lane
            n_bytes = Q * (Lr + W) * r.element_size() + 3 * 4 * Q
            n_ops = (MYERS_OPS_PER_WORD * nwords + MYERS_OPS_PER_STEP) * W * int((ln > 0).sum())
            times["windows", shape] = (ms, plain_ms, *bound(n_bytes, n_ops))
            b = times["windows", shape]
            log(f"[6] windows entry Q={Q} L={Lr} W={W}: kernel {ms:.4f} ms, plain torch "
                f"{plain_ms:.3f} ms, bound {b[2]:.4f} ms by {b[3]} ({card})")
        del r, ln, w

    max_text = 0
    codes, words = random_text(torch, dev, GENOME_LEN, seed=5)
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    text_shapes = [(RESCUE_LANES, Lr, Lr + 400, mode) for Lr in (32, 64, 100, 150, 256)
                   for mode in ("identity", "repeat")]
    text_shapes.append((BATCH * VERIFY_SLACK, L, L + 3 * K, "verify"))
    for Q, Lr, W, mode in text_shapes:
        starts, reads, lengths, rid, valid = myers_text_lanes(torch, codes, Q, Lr, W, gen, mode)
        nwords = -(-Lr // 32)
        args = (words, GENOME_LEN, starts, reads, lengths, rid, valid, W, nwords)
        b_kern, e_kern = myers_cuda.myers_semiglobal_text_cuda(*args)
        b_plain, e_plain = myers.myers_semiglobal_text_plain(*args)
        torch.cuda.synchronize()
        err = max(int((b_kern - b_plain).abs().max()), int((e_kern - e_plain).abs().max()))
        max_text = max(max_text, err)
        n_bad = int(((b_kern != b_plain) | (e_kern != e_plain)).sum())
        n_hit = int((b_plain <= max(K, Lr // 20)).sum())
        log(f"[6] text entry Q={Q} L={Lr} W={W} rid {mode}: {n_hit} lanes within the rescue "
            f"bar, {int((valid < W).sum())} lanes with valid < W, (best, end) mismatches "
            f"{n_bad}, max |err| {err}")
        check(n_bad == 0, f"Myers text entry disagrees with plain at Q={Q} L={Lr} W={W} {mode}")
        check(n_hit > Q // 20, f"too few planted lanes found at Q={Q} L={Lr}")
        if Lr != L or mode == "repeat":
            continue
        shape = "rescue" if Q == RESCUE_LANES else "verify"
        col = torch.arange(W, device=dev)
        rid_l = rid.long()

        def old_stage():
            wins = window.gather_windows(words, GENOME_LEN, starts, W)
            wins = torch.where(col[None, :] >= valid[:, None], 4, wins).contiguous()
            r, ln = (reads, lengths) if shape == "rescue" else (reads[rid_l], lengths[rid_l])
            return myers_cuda.myers_semiglobal_cuda(r, ln, wins, nwords)

        t = {}
        for name, fn in (("text", lambda: myers_cuda.myers_semiglobal_text_cuda(*args)),
                         ("stage", old_stage),
                         ("text2", lambda: myers_cuda.myers_semiglobal_text_cuda(*args))):
            t[name] = cuda_time_ms(fn, reps=50, hide_host=True)
        plain_ms = cuda_time_ms(lambda: myers.myers_semiglobal_text_plain(*args), reps=2,
                                warmup=1)
        # reads, lengths, starts, rid, valid and the text words the windows
        # cover in, best and end out; the least integer work as above
        w0 = (starts >> 4).long()[:, None] + torch.arange(W // 16 + 2, device=dev)
        n_words = int(torch.unique(w0.clamp(0, words.numel() - 1)).numel())
        n_bytes = reads.numel() + 4 * (lengths.numel() + 3 * Q + n_words) + 8 * Q
        n_ops = (MYERS_OPS_PER_WORD * nwords + MYERS_OPS_PER_STEP) * W * int(
            (lengths[rid_l] > 0).sum())
        b = bound(n_bytes, n_ops)
        ms = min(t["text"], t["text2"])
        times["text", shape] = (ms, plain_ms, *b)
        times["stage", shape] = t["stage"]
        log(f"[6] text entry Q={Q} L={Lr} W={W}: kernel {t['text']:.4f} / {t['text2']:.4f} ms "
            f"(bound {b[0]:.4f} ms by {b[1]}); the stage it replaces (gather_windows + where + "
            f"contiguous + windows entry) {t['stage']:.4f} ms; plain {plain_ms:.3f} ms ({card})")

    name, loop = sass_loop(myers_cuda._library(), ("myers_kernelILi4E", "TextStream"))
    chain = dependent_chain(loop) if loop else 0
    if chain:
        # 16 window columns a trip round the unrolled loop
        per_step = chain / 16
        floor_ms = (L + 400) * per_step * CYCLES_PER_LINK / MAX_SM_HZ * 1e3
        # a warp issues at most one instruction a cycle, and the rescue
        # cohort is a warp or less a multiprocessor: each lane's warp issues
        # the loop's instructions of every column itself
        issue_ms = (L + 400) * len(loop) / 16 / MAX_SM_HZ * 1e3
        times["floor"], times["issue_floor"] = floor_ms, issue_ms
        log(f"[6] SASS of {name}: the 16-column loop is {len(loop)} instructions "
            f"({len(loop) / 16:.2f} a column), its longest dependent chain a trip {chain} "
            f"instructions = {per_step:.2f} a column; at the rescue shape ({L + 400} columns, "
            f"{MAX_SM_HZ / 1e9:.2f} GHz) the latency floor ({CYCLES_PER_LINK} cycles a link) is "
            f"{floor_ms:.4f} ms and one warp's issue floor (one instruction a cycle) "
            f"{issue_ms:.4f} ms")
    else:
        times["floor"] = times["issue_floor"] = None
        log(f"[6] SASS: not measured ({name})")
    return (max_err, max_text), times


def phase_fm_cli(codes, card):
    """The FM pigeonhole path end to end through the CLI (no seed table)."""
    from genome_weaver_align_tpu_torch import cli
    from genome_weaver_align_tpu_torch.ops import dp_cuda, myers_cuda

    idx, _, _ = build_index(cli, codes)
    work = CACHE / f"fm{os.getpid()}"
    work.mkdir(parents=True)
    fq, sam, rep = work / "reads.fq", work / "out.sam", work / "report.json"
    n_reads = BATCH * FM_BATCHES
    write_reads(fq, codes, n_reads, seed=31)

    dp_cuda.banded_edit_distance_text_cuda.launches = 0
    dp_cuda.banded_edit_distance_cuda.launches = 0
    myers_cuda.myers_semiglobal_text_cuda.launches = 0
    myers_cuda.myers_semiglobal_cuda.launches = 0
    rc = cli.main(["align", str(idx), str(fq), "-k", str(K), "--batch-size", str(BATCH),
                   "--report", str(rep), "-o", str(sam)])
    launches = dp_cuda.banded_edit_distance_text_cuda.launches
    check(rc == 0, f"FM-path align exited {rc}")
    report = json.loads(rep.read_text())
    n, mapped, correct = score_sam(sam)
    shutil.rmtree(work)
    log(f"[7] FM path, align -k {K} without a seed table: {n} reads, mapped "
        f"{mapped / n:.6f}, correct {correct / n:.6f}, {report['reads_per_s']} reads/s over "
        f"{report['wall_s']} s ({card}), banded-DP launches: text entry {launches}, windows "
        f"entry {dp_cuda.banded_edit_distance_cuda.launches}; Myers launches: text entry "
        f"{myers_cuda.myers_semiglobal_text_cuda.launches}, windows entry "
        f"{myers_cuda.myers_semiglobal_cuda.launches}")
    check(n == n_reads, f"SAM holds {n} records")
    check(launches > 0, "the FM-path run never launched the banded DP kernel's text entry")
    check(mapped / n >= MIN_MAPPED, f"FM path mapped share {mapped / n:.4f} < {MIN_MAPPED}")
    check(correct / n >= MIN_CORRECT, f"FM path correct share {correct / n:.4f} < {MIN_CORRECT}")


def make_pairs(codes):
    """6 x 16,384 FR pairs of 100 bp: inserts 250-550, 1-2 substitutions on
    each mate, 10% of mate2 with 4 more (unmappable at k = 2, within the
    rescue bar max(k, L // 20) = 5)."""
    import numpy as np

    rng = np.random.default_rng(21)
    n = PAIR_BATCH * PAIR_BATCHES
    insert = rng.integers(250, 550, size=n)
    pos1 = rng.integers(0, codes.size - 600, size=n)
    c1 = codes[pos1[:, None] + np.arange(L)[None, :]].astype(np.int8)
    p2 = pos1 + insert - L
    c2raw = codes[p2[:, None] + np.arange(L)[None, :]].astype(np.int8)
    c2 = np.ascontiguousarray((3 - c2raw)[:, ::-1])  # mate2 on the reverse strand
    for arr in (c1, c2):
        for _ in range(2):
            at = rng.integers(0, L, size=n)
            rows = np.nonzero(rng.random(n) < 0.6)[0]
            arr[rows, at[rows]] = (arr[rows, at[rows]] + rng.integers(1, 4, size=rows.size)) % 4
    half = np.nonzero(rng.random(n) < 0.10)[0]
    for _ in range(4):
        at = rng.integers(0, L, size=n)
        c2[half, at[half]] = (c2[half, at[half]] + rng.integers(1, 4, size=half.size)) % 4
    return c1, c2, pos1


def write_mates(path: Path, mates, pos1) -> None:
    import numpy as np

    seqs = np.frombuffer(b"ACGT", np.uint8)[mates].tobytes()
    qual = "I" * L
    with open(path, "w") as fh:
        fh.write("".join(
            f"@p{i}_{p}\n{seqs[i * L:(i + 1) * L].decode()}\n+\n{qual}\n"
            for i, p in enumerate(pos1.tolist())
        ))


def phase_paired(torch, dev, codes, card):
    """Paired end to end through the CLI, then the same pairs through
    ``PairedAligner.align_pair_arrays``."""
    import numpy as np

    from genome_weaver_align_tpu_torch import cli
    from genome_weaver_align_tpu_torch.index.files import load_index
    from genome_weaver_align_tpu_torch.index.seedtable import load_seed_table
    from genome_weaver_align_tpu_torch.models.paired import PairedAligner
    from genome_weaver_align_tpu_torch.models.pipeline import SuffixFilterAligner
    from genome_weaver_align_tpu_torch.ops import dp_cuda, myers_cuda

    idx, seedf, _ = build_index(cli, codes)
    c1, c2, pos1 = make_pairs(codes)
    n_pairs = c1.shape[0]
    work = CACHE / f"pairs{os.getpid()}"
    work.mkdir(parents=True)
    f1, f2, sam, rep = work / "r1.fq", work / "r2.fq", work / "out.sam", work / "report.json"
    write_mates(f1, c1, pos1)
    write_mates(f2, c2, pos1)

    dp_cuda.banded_edit_distance_text_cuda.launches = 0
    myers_cuda.myers_semiglobal_text_cuda.launches = 0
    myers_cuda.myers_semiglobal_cuda.launches = 0
    rc = cli.main(["align", str(idx), str(f1), "--paired", str(f2), "-k", str(K),
                   "--seed-table", str(seedf), "--batch-size", str(PAIR_BATCH),
                   "--report", str(rep), "-o", str(sam)])
    launches = (dp_cuda.banded_edit_distance_text_cuda.launches,
                myers_cuda.myers_semiglobal_text_cuda.launches,
                myers_cuda.myers_semiglobal_cuda.launches)
    check(rc == 0, f"paired align exited {rc}")
    report = json.loads(rep.read_text())
    n_rec = n_proper_rec = 0
    with open(sam) as fh:
        for line in fh:
            if line[0] != "@":
                n_rec += 1
                n_proper_rec += bool(int(line.split("\t", 2)[1]) & 2)
    shutil.rmtree(work)
    proper = n_proper_rec / 2 / n_pairs
    log(f"[8] paired CLI, align --paired --seed-table -k {K}: {n_pairs} pairs, "
        f"{n_rec} records, proper {proper:.6f} (report {report['proper_pairs']}), "
        f"{report['reads_per_s']} reads/s over {report['wall_s']} s ({card}), banded-DP "
        f"text-entry launches {launches[0]}, Myers launches: text entry {launches[1]}, "
        f"windows entry {launches[2]}")
    check(n_rec == 2 * n_pairs, f"SAM holds {n_rec} records")
    check(proper >= MIN_PROPER, f"proper share {proper:.4f} < {MIN_PROPER}")
    check(launches[1] > 0, "the paired run never launched the Myers kernel's text entry")
    check(launches[2] == 0, "the paired rescue built a window tensor for the windows entry")

    gi = load_index(idx)
    offsets, positions, sj = load_seed_table(seedf)
    al = SuffixFilterAligner(gi, k=K, max_hits_per_piece=8, seed_table=(offsets, positions),
                             seed_j=sj, max_cands=12, verify_slack=4, device=dev)
    pa = PairedAligner(al, min_insert=200, max_insert=600)
    lengths = np.full(PAIR_BATCH, L, np.int32)
    pa.align_pair_arrays(c1[:PAIR_BATCH], lengths, c2[:PAIR_BATCH], lengths)  # warm-up
    times, n_proper, n_rescued, phases = [], 0, 0, []
    for b in range(PAIR_BATCHES):
        sl = slice(b * PAIR_BATCH, (b + 1) * PAIR_BATCH)
        t0 = time.perf_counter()
        phs = pa.align_pair_arrays(c1[sl], lengths, c2[sl], lengths)
        times.append(time.perf_counter() - t0)
        n_proper += sum(ph.proper for ph in phs)
        n_rescued += sum(ph.rescued != 0 for ph in phs)
        phases.append((pa.last_rescue_jobs, pa.last_phase_ms))
    rescued = n_rescued / n_pairs
    log(f"[8] paired arrays, {PAIR_BATCHES} x {PAIR_BATCH} pairs (inserts 200-600): "
        f"{n_pairs / sum(times):.1f} pairs/s over {sum(times):.3f} s, best batch "
        f"{PAIR_BATCH / min(times):.1f} pairs/s; proper {n_proper / n_pairs:.6f}, rescued "
        f"{rescued:.6f} ({card})")
    for jobs, ms in phases:
        log(f"[8]   rescue jobs {jobs}, last_phase_ms {ms}")
    check(rescued >= MIN_RESCUED, f"rescued share {rescued:.4f} < {MIN_RESCUED}")
    return launches[1]


def fused_inputs(torch, sh, M: int, Q: int, gen, gather: bool = True):
    """``fused_rank_ring``'s inputs for M payloads of Q (code, coordinate)
    queries over the whole range of a sharded index on the card, the shard
    edges, the primary row and the last row among them: (words, codes,
    roff, base, own) (None without ``gather``) and the queries (M, Q)."""
    from genome_weaver_align_tpu_torch.parallel import sharded_index as si

    dev = sh.pk_start.device
    k = torch.randint(0, sh.n + 1, (M, Q), generator=gen, device=dev, dtype=torch.int32)
    c = torch.randint(0, 4, (M, Q), generator=gen, device=dev, dtype=torch.int32)
    edges = torch.cat([sh.pk_start, sh.pk_end,
                       torch.tensor([sh.primary, sh.n, sh.n + 1], dtype=torch.int32, device=dev)])
    edges = torch.cat([edges, edges - 1]).clamp(0, sh.n + 1)[:Q]
    k[:, : edges.numel()] = edges
    if not gather:
        return None, (c, k)
    g = [si.local_occ_gather(sh, c[m], k[m]) for m in range(M)]
    words, roff, base, own = (torch.stack([x[f] for x in g], dim=1).contiguous()
                              for f in range(4))
    codes = c[None].expand(sh.n_shards, M, Q).contiguous()
    return (words, codes, roff, base, own), (c, k)


def phase_rings(torch, dev, fm, card):
    """The shard sum and both fused entries against their plain versions on
    every element; kernels, plain versions, the stage the table entry
    replaces and ``parts.sum(0)`` timed at the search's payloads."""
    from genome_weaver_align_tpu_torch.ops import rank, ring_cuda
    from genome_weaver_align_tpu_torch.parallel import ring
    from genome_weaver_align_tpu_torch.parallel import sharded_index as si

    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    max_err = {"ring": 0, "words": 0, "table": 0}
    for S in (1, 2, 3, 4, 8, 16):
        cases = [(torch.int32, n) for n in (3, 777, 65_536, 4_194_304)] + [
            (torch.float32, n) for n in (777, 65_536)]
        for dtype, n in cases:
            if dtype == torch.int32:
                x = torch.randint(-(1 << 30), 1 << 30, (S, n), generator=gen, device=dev,
                                  dtype=torch.int32)
            else:
                x = torch.randn((S, n), generator=gen, device=dev) * 1e4
            got, want = ring_cuda.ring_allreduce_cuda(x), ring.ring_psum_plain(x)
            n_bad = int((got != want).sum())
            err = float((got.double() - want.double()).abs().max())
            max_err["ring"] = max(max_err["ring"], err)
            log(f"[9] ring_psum S={S} {str(dtype)[6:]} x {n}: mismatches {n_bad}, max |err| {err}")
            check(n_bad == 0, f"ring kernel disagrees with plain at S={S} {dtype} n={n}")

    fm_dev = rank.from_host(fm, dev)
    shards = {}
    for S in (1, 2, 3, 4, 8, 16):
        shards[S] = sh = si.put_sharded(si.shard_fm_index(fm, S), dev)
        for Q in (96, 65_536):
            for M in (1, 2, 3, 9):
                ins, (c, k) = fused_inputs(torch, sh, M, Q, gen)
                got, want = ring_cuda.fused_rank_ring_cuda(*ins), ring.fused_rank_ring_plain(*ins)
                occ = rank.occ_codes(fm_dev, c, k)  # the single-device rank
                n_bad = int((got != want).sum())
                n_wrong = int((got[0] != occ).sum())
                err = int((got.long() - want.long()).abs().max())
                max_err["words"] = max(max_err["words"], err)
                log(f"[9] fused words entry S={S} M={M} Q={Q}: mismatches with plain {n_bad}, "
                    f"with the single-device occ {n_wrong}, max |err| {err}")
                check(n_bad == 0 and n_wrong == 0, f"fused words entry wrong at S={S} M={M} Q={Q}")
            if S in (3,):
                continue
            _, (c, k) = fused_inputs(torch, sh, 2, Q, gen, gather=False)
            got, want = ring_cuda.fused_occ_cuda(sh.bwt_blocks, sh.occ_cp, sh.pk_start, sh.pk_end,
                                                 sh.primary, c, k), si.fused_occ_plain(sh, c, k)
            occ = rank.occ_codes(fm_dev, c, k)
            n_bad, n_wrong = int((got != want).sum()), int((got != occ).sum())
            err = int((got.long() - want.long()).abs().max())
            max_err["table"] = max(max_err["table"], err)
            log(f"[9] fused table entry S={S} M=2 Q={Q}: mismatches with plain {n_bad}, with "
                f"the single-device occ {n_wrong}, max |err| {err}")
            check(n_bad == 0 and n_wrong == 0, f"fused table entry wrong at S={S} Q={Q}")
        if S not in (SHARDS,):
            del shards[S]

    # the exact search's payloads: ring (2, B / microbatch) per shard,
    # fused M = microbatch payloads of Q = 2 B / M
    timing = {}
    S, n = SHARDS, BATCH // RING_MICROBATCH
    sh = shards[S]
    parts = torch.randint(-(1 << 20), 1 << 20, (S, 2, n), generator=gen, device=dev,
                          dtype=torch.int32)
    ms = cuda_time_ms(lambda: ring_cuda.ring_allreduce_cuda(parts), reps=200, hide_host=True)
    plain_ms = cuda_time_ms(lambda: ring.ring_psum_plain(parts), reps=200, hide_host=True)
    lib_ms = cuda_time_ms(lambda: parts.sum(0, dtype=torch.int32), reps=200, hide_host=True)
    # each shard's partials in, each shard's sum out; S - 1 adds an element
    timing["ring"] = (ms, plain_ms, *bound(2 * parts.numel() * 4, (S - 1) * parts.numel()),
                      lib_ms)
    M, Q = RING_MICROBATCH, 2 * BATCH // RING_MICROBATCH
    ins, (c, k) = fused_inputs(torch, sh, M, Q, gen)
    ms = cuda_time_ms(lambda: ring_cuda.fused_rank_ring_cuda(*ins), reps=200, hide_host=True)
    plain_ms = cuda_time_ms(lambda: ring.fused_rank_ring_plain(*ins), reps=50, hide_host=True)
    # what this run's data needs: every shard's own in and sum out per
    # query, and the row (32 B), code, roff and base only where own is set;
    # RANK_OPS_PER_WORD a word for the match count and 2 for own * (base +
    # count) of each owner, S - 1 adds
    n_own = int((ins[4] != 0).sum())
    n_q = ins[1].numel()
    timing["words"] = (ms, plain_ms,
                       *bound(n_q * 2 * 4 + n_own * (32 + 3 * 4),
                              n_own * (8 * RANK_OPS_PER_WORD + 2) + n_q * (S - 1) // S), None)

    def table():
        return ring_cuda.fused_occ_cuda(sh.bwt_blocks, sh.occ_cp, sh.pk_start, sh.pk_end,
                                        sh.primary, c, k)

    def old_stage():  # what merge="fused" ran a step before the table entry
        g = [si.local_occ_gather(sh, c[m], k[m]) for m in range(M)]
        w, roff, base, own = (torch.stack([x[f] for x in g], dim=1) for f in range(4))
        return ring.fused_rank_ring(w, c[None].expand(S, M, Q), roff, base, own)

    t = {}
    for name, fn in (("table", table), ("stage", old_stage), ("table2", table)):
        t[name] = cuda_time_ms(fn, reps=200, hide_host=True)
    plain_ms = cuda_time_ms(lambda: si.fused_occ_plain(sh, c, k), reps=50, hide_host=True)
    # k, code, the owner's 32-byte row and checkpoint in and the sum out per
    # query (the S bounds once); RANK_OPS_PER_WORD a word, the owner test
    # and block split of each shard
    n_q = c.numel()
    timing["table"] = (min(t["table"], t["table2"]), plain_ms,
                       *bound(n_q * (4 + 4 + 32 + 4 + 4) + 8 * S,
                              n_q * (8 * RANK_OPS_PER_WORD + 4 * S + 6)), None)
    for name, (tm, p, b, by, lib) in timing.items():
        shape = tuple(parts.shape) if name == "ring" else (S, M, Q)
        log(f"[9] {name} at S={S}, payload {shape}: kernel {tm:.4f} ms, plain torch {p:.4f} ms, "
            f"parts.sum(0) {'%.4f ms' % lib if lib is not None else 'none'}, bound {b:.4f} ms "
            f"by {by} ({card})")
    log(f"[9] table entry {t['table']:.4f} / {t['table2']:.4f} ms; the stage it replaces "
        f"(local_occ_gather of both chunks + stack + the words entry) {t['stage']:.4f} ms "
        f"({card})")
    timing["stage"] = t["stage"]
    return max_err, timing


def phase_sharded_search(torch, dev, codes, gi, card):
    """The interval-sharded exact search at full size, three merges."""
    import numpy as np

    from genome_weaver_align_tpu_torch.models import exact
    from genome_weaver_align_tpu_torch.ops import rank, ring_cuda
    from genome_weaver_align_tpu_torch.parallel import mesh as pmesh
    from genome_weaver_align_tpu_torch.parallel import sharded_index as si

    rng = np.random.default_rng(41)
    starts = rng.integers(0, codes.size - L, size=BATCH)
    reads = codes[starts[:, None] + np.arange(L)[None, :]].astype(np.int32)
    lengths = np.full(BATCH, L, np.int32)
    t0 = time.time()
    layout = pmesh.make_layout(1, SHARDS, dev)
    sh = si.put_sharded(si.shard_fm_index(gi.fwd, SHARDS), dev)
    r, ln, _ = pmesh.shard_reads(layout, reads, lengths)
    torch.cuda.synchronize()
    log(f"[10] {SHARDS} interval shards of the {gi.fwd.n} bp index on the card in "
        f"{time.time() - t0:.1f} s")

    fm = rank.from_host(gi.fwd, dev)
    t0 = time.time()
    lo, hi = exact.exact_interval_search(fm, r, ln, max_len=L)
    pos = torch.where(hi > lo, rank.locate(fm, lo.clamp(0, gi.fwd.n)), -1)
    torch.cuda.synchronize()
    ref = [lo.cpu(), hi.cpu(), pos.cpu()]
    log(f"[10] single-device exact search + locate, {BATCH} reads: {time.time() - t0:.3f} s")

    launches, secs = {}, {}
    for merge, mb in (("psum", 1), ("ring", RING_MICROBATCH), ("fused", RING_MICROBATCH)):
        fn = si.make_sharded_exact_search(layout, L, sh, merge=merge, microbatch=mb)
        fn(sh, r[:1024], ln[:1024])  # warm-up: scratch and allocator
        torch.cuda.synchronize()
        counters = (ring_cuda.ring_allreduce_cuda, ring_cuda.fused_occ_cuda,
                    ring_cuda.fused_rank_ring_cuda)
        for f in counters:
            f.launches = 0
        t0 = time.time()
        out = fn(sh, r, ln)
        torch.cuda.synchronize()
        secs[merge] = time.time() - t0
        launches[merge] = tuple(f.launches for f in counters)
        got = [v.cpu() for v in out]
        same = all(torch.equal(a, b) for a, b in zip(got, ref))
        log(f"[10] merge={merge} microbatch={mb}: {secs[merge]:.3f} s "
            f"({BATCH / secs[merge]:.1f} reads/s), (lo, hi, pos) equal to the single-device "
            f"search: {same}; launches: sum {launches[merge][0]}, fused table entry "
            f"{launches[merge][1]}, fused words entry {launches[merge][2]} ({card})")
        check(same, f"merge={merge} differs from the single-device search")
    lo, hi, pos = ref
    n_found = int((hi > lo).sum())
    unique = (hi - lo == 1).numpy()
    n_placed = int((pos.numpy()[unique] == starts[unique]).sum())
    log(f"[10] {n_found} of {BATCH} reads found, {int(unique.sum())} unique, {n_placed} of "
        f"them at their true start")
    check(n_found == BATCH, "an error-free read was not found")
    check(n_placed == int(unique.sum()), "a unique read was placed off its true start")
    check(launches["ring"] == (L * RING_MICROBATCH, 0, 0),
          f"merge=ring launched {launches['ring']}, expected ({L * RING_MICROBATCH}, 0, 0)")
    check(launches["fused"] == (0, L, 0),
          f"merge=fused launched {launches['fused']}, expected (0, {L}, 0)")
    check(launches["psum"] == (0, 0, 0), "merge=psum launched a ring kernel")
    return launches["ring"][0], launches["fused"][1]


def phase_sharded_cli(codes, card):
    """ShardedAligner through the CLI (--n-interval 4) against the
    single-device CLI on the same FASTQ, seed table and FM shards."""
    from genome_weaver_align_tpu_torch import cli
    from genome_weaver_align_tpu_torch.ops import dp_cuda

    idx, seedf, _ = build_index(cli, codes)
    sharded_launches = 0
    work = CACHE / f"sharded{os.getpid()}"
    work.mkdir(parents=True)
    for name, n_reads, extra, seed in (("seed-table", BATCH, ["--seed-table", str(seedf)], 51),
                                       ("FM", SHARDED_FM_READS, [], 52)):
        fq = work / "reads.fq"
        write_reads(fq, codes, n_reads, seed=seed)
        bodies = {}
        for n_int in (SHARDS, 1):
            sam, rep = work / f"out{n_int}.sam", work / f"report{n_int}.json"
            dp_cuda.banded_edit_distance_text_cuda.launches = 0
            dp_cuda.banded_edit_distance_cuda.launches = 0
            rc = cli.main(["align", str(idx), str(fq), "-k", str(K), *extra, "--n-interval",
                           str(n_int), "--batch-size", str(BATCH), "--report", str(rep),
                           "-o", str(sam)])
            # the sharded verify takes the windows entry (its windows are
            # sums of shard partials), the single-device one the text entry
            launches = (dp_cuda.banded_edit_distance_text_cuda.launches,
                        dp_cuda.banded_edit_distance_cuda.launches)
            check(rc == 0, f"{name} align --n-interval {n_int} exited {rc}")
            report = json.loads(rep.read_text())
            n, mapped, correct = score_sam(sam)
            with open(sam) as fh:
                bodies[n_int] = [line for line in fh if line[0] != "@"]
            log(f"[11] {name} align -k {K} --n-interval {n_int}: {n} reads, mapped "
                f"{mapped / n:.6f}, correct {correct / n:.6f}, {report['reads_per_s']} reads/s "
                f"over {report['wall_s']} s ({card}), banded-DP launches: text entry "
                f"{launches[0]}, windows entry {launches[1]}")
            check(n == n_reads, f"SAM holds {n} records")
            check(mapped / n >= MIN_MAPPED, f"mapped share {mapped / n:.4f} < {MIN_MAPPED}")
            check(correct / n >= MIN_CORRECT, f"correct share {correct / n:.4f} < {MIN_CORRECT}")
            entry = 1 if n_int > 1 else 0
            check(launches[entry] > 0, f"--n-interval {n_int} never launched the banded DP "
                  f"kernel's {('text', 'windows')[entry]} entry")
            if n_int > 1:
                sharded_launches += launches[1]
        same = bodies[SHARDS] == bodies[1]
        log(f"[11] {name}: the --n-interval {SHARDS} SAM body is byte-identical to the "
            f"single-device one: {same}")
        check(same, f"{name}: the sharded SAM differs from the single-device SAM")
    shutil.rmtree(work)
    return sharded_launches


def kernel_row(name, source, replaces, path, launches, max_err, timing, **extra) -> dict:
    """One entry of the ``kernels`` line; ``path`` names the run whose
    launches are counted."""
    ms, plain_ms, bound_ms, bound_by, library_ms = timing
    return {"name": name, "route": "cuda", "source": f"genome_weaver_align_tpu_torch/csrc/{source}",
            "replaces": f"genome_weaver_align_tpu/{replaces}", "path": path,
            "launches": launches, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms, **extra}


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

    from genome_weaver_align_tpu_torch.utils.simulate import random_genome
    from genome_weaver_align_tpu_torch.index.seedtable import build_seed_table

    global INT_OPS_PER_S, MAX_SM_HZ
    dev = torch.device("cuda", 0)
    card = card_line()
    MAX_SM_HZ = max_sm_hz()
    INT_OPS_PER_S = int_ops_per_s(torch, MAX_SM_HZ)
    log(f"[1] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} visible; "
        f"int32 issue rate {INT_OPS_PER_S:.4g}/s")
    try:
        from genome_weaver_align_tpu_torch.index import native

        t0 = time.time()
        check(native.available(), "the native C++ library (native/*.cpp) did not build")
        omp = {True: "with OpenMP", False: "without OpenMP", None: "prebuilt, loaded"}[
            native.built_with_openmp]
        log(f"[2] built native/*.cpp with g++ in {time.time() - t0:.1f} s ({omp})")
        max_err, dp_timing = phase_kernel(torch, dev, card)
        t0 = time.time()
        codes = random_genome(GENOME_LEN, seed=GENOME_SEED)
        offsets, positions = build_seed_table(codes, SEED_J)
        log(f"[3] genome of {codes.size} bp and its {SEED_J}-mer seed table in "
            f"{time.time() - t0:.1f} s")
        phase_fused_step(torch, dev, codes, offsets, positions)
        del offsets, positions
        launches = phase_cli(codes, card)
        phase_profile(torch, dev, codes, card)
        myers_err, myers_times = phase_myers(torch, dev, card)
        phase_fm_cli(codes, card)
        myers_launches = phase_paired(torch, dev, codes, card)
        from genome_weaver_align_tpu_torch import cli
        from genome_weaver_align_tpu_torch.index.files import load_index

        gi = load_index(build_index(cli, codes)[0])
        ring_err, ring_timing = phase_rings(torch, dev, gi.fwd, card)
        ring_launches, fused_launches = phase_sharded_search(torch, dev, codes, gi, card)
        del gi
        banded_win_launches = phase_sharded_cli(codes, card)
        check("jax" not in sys.modules, "the smoke imported jax")
        check(not any(m == "genome_weaver_align_tpu" or m.startswith("genome_weaver_align_tpu.")
                      for m in sys.modules), "the smoke imported the JAX package")
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    myers_win_err, myers_text_err = myers_err
    log(json.dumps({"kernels": [
        kernel_row("banded_dp_text", "banded_dp.cu", "ops/dp_pallas.py:47",
                   "[4] align --seed-table", launches, max_err, (*dp_timing["text"], None)),
        kernel_row("banded_dp_windows", "banded_dp.cu", "ops/dp_pallas.py:47",
                   "[11] align --n-interval 4", banded_win_launches, max_err,
                   (*dp_timing["windows"], None)),
        kernel_row("myers_text", "myers.cu", "ops/myers_pallas.py:75",
                   "[8] align --paired (mate rescue)", myers_launches, myers_text_err,
                   (*myers_times["text", "rescue"], None),
                   stage_ms=myers_times["stage", "rescue"],
                   latency_floor_ms=myers_times["floor"],
                   warp_issue_floor_ms=myers_times["issue_floor"]),
        kernel_row("myers_windows", "myers.cu", "ops/myers_pallas.py:75",
                   "none: the JAX contract's entry, held against plain in [6]", 0,
                   myers_win_err, (*myers_times["windows", "rescue"], None)),
        kernel_row("ring_allreduce", "ring.cu", "parallel/ring.py:58",
                   "[10] merge=ring", ring_launches, ring_err["ring"], ring_timing["ring"]),
        kernel_row("fused_rank_ring_words", "ring.cu", "parallel/ring.py:162",
                   "none: the JAX contract's entry, held against plain in [9]", 0,
                   ring_err["words"], ring_timing["words"]),
        kernel_row("fused_occ_table", "ring.cu", "parallel/ring.py:162", "[10] merge=fused",
                   fused_launches, ring_err["table"], ring_timing["table"],
                   stage_ms=ring_timing["stage"]),
    ]}))
    log(card_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
