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
   chr20-scale random text), k = 1..16 (the short-read aligners' k <= 14
   and the long-read segment band, 16), with starts off both text ends and
   next to word boundaries, ragged and 0-length reads, N codes, and a
   narrow window with dead lanes; the windows entry is held against the
   plain DP at k = 1..4 and 9..16 on random windows.  dist and end_b must
   be equal on every lane.  At k = 2 the text entry, the stage it replaces
   (``gather_windows`` + ``reads[rid]`` + the windows entry), the windows
   entry alone and both plain versions are timed; the text entry is also
   held against its plain version and timed at the long-read segment
   verify's shape (8,192 lanes of 128 bases, W = 176, k = 16); the SASS of
   the text kernel's unrolled row loop is counted per band cell
   (``cuobjdump``), and ptxas's registers and spills at k = 14 and 16 are
   printed.  Past the one-thread kernel: both entries against plain on
   every lane at the segment shape (8,192 lanes of 128 bases) for k = 17,
   20, 24, 31, 32, 48, 64, 96 and 127 (a group of 8, 16 or 32 threads a
   lane, 9..16 band slots a thread), at k = 130 (a warp a lane over
   scratch, 1,024 lanes) and at k = 2 and 24 on 4,096 reads of 1,816,
   2,000 and 4,096 bases (fewer staged rows a block, then rows from global
   memory), the text entry timed beside its plain version and its bound
   (4 (4k+1) integer instructions a live row and lane), and the new
   kernels' registers and spills;
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
   (the latency floor).  Past 8 words (a group of threads a lane, run as
   a wavefront): both entries at L = 257, 300, 512, 1,000 and 2,048
   (2,048 lanes, W = L + 400), and at 520 words on 256 lanes of 300 bases
   (a warp a lane over scratch), each timed with its bound ((11 nwords +
   5) integer instructions a lane-step) and the group shape (G x P) the
   binding picked, beside the earlier design's times as PERF.md records
   them (``LOOKAHEAD_MYERS_GROUP_MS``: constants, printed, not measured
   here); the group kernels' registers and spills, and the group kernel's
   step chain from its SASS (the latency floor at [8]'s rescue call: time
   steps x (chain + one shuffle), each link and the shuffle at the
   latencies ``probe_latencies`` measures on the card);
7. the FM pigeonhole path end to end: the CLI's ``align -k 2`` without a
   seed table on the same index, 2 x 65,536 reads; >= 99% mapped and
   correct, banded-DP kernel, the backward-search kernel (the pieces'
   search, ``csrc/fm_search.cu``) and the locate kernel launched;
8. paired end to end: the CLI's ``align --paired --seed-table`` on 6 x
   16,384 pairs of 100 bp (FR mates, inserts 250-550, 1-2 substitutions a
   mate, 10% of mate2 with 4 more: unmappable at k = 2, within the rescue
   bar); >= 90% proper pairs and the Myers kernel launched; then the same
   pairs through ``PairedAligner.align_pair_arrays`` (inserts 200-600):
   pairs/s, the phase split, and >= 5% of pairs rescued; the rescue must
   reach the Myers text entry and never the windows entry.  Then
   MiSeq-style pairs: the CLI on 2 x 8,192 pairs of 300 bp (inserts
   450-750, 10% of mate2 with 8 more substitutions: within the rescue bar
   15), exit 0, >= 90% proper, >= 5% rescued, the Myers text entry's group
   kernel launched at 10 words, and the first rescue call's lanes equal to
   the plain version; that call timed at the binding's group shape and at
   every other, beside the lookahead design's figure;
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
   exact search's payloads (S = 4: sum (2, 32,768) as the ring merge calls
   it, shard 0's row alone, and every row; fused M = 2, Q = 65,536), the
   sum also at 32 shards.  Past 16 shards at S = 17, 32, 64, 128
   and 1,024: the sum (int32 and float32; stacked, in separate
   allocations, one output), the table entry (stacked and one allocation
   a shard) and, up to 64, the words entry, each against plain;
10. the interval-sharded exact search at full size: the phase-4 index in
   4 interval shards on the card, 65,536 error-free forward-strand 100 bp
   reads; ``make_sharded_exact_search`` with ``merge="psum"``, ``"ring"``
   and ``"fused"`` (microbatch 2) must give the same (lo, hi, pos) as each
   other and as the single-device ``exact_interval_search`` + ``locate``,
   find every read, and place every unique one at its true start; the
   sum kernel launched 100 x 2 times and the fused table entry 100 times,
   the sharded locate once under each merge; the same at 32 shards;
11. ``ShardedAligner`` end to end through the CLI: ``align -k 2
   --n-interval 4`` with the seed table on 65,536 reads and without it
   (FM shards) on 16,384 reads; the SAM body must be byte-identical to
   the single-device CLI's on the same FASTQ, >= 99% mapped and correct,
   and the banded-DP kernel launched; on the FM shards the sharded piece
   search and the sharded locate launched (the locate on one device); then
   ``--n-interval 32`` on 2 x 16,384 reads, FM shards and with the seed
   table, each against ``--n-interval 1``;
12. the tier-2 staircase at scale, on the JAX package's repeat bench
   configuration (``bench.py`` ``bench_repeat``): ``repeat_genome`` of the
   same length (seed 4) indexed by the CLI with its reverse text (cached
   under ``smoke_cache/``), ``SuffixFilterAligner`` at k = 2 with 8 hits a
   piece, 12 candidates and 4 verify lanes a read, the array loop over 6 x
   32,768 reads with <= 2 substitutions.  >= 97% mapped (the bench's
   limit), some reads through tier 2, the banded text entry launched inside
   tier 2, the staircase kernel (``csrc/staircase.cu``) and the locate
   kernel (``csrc/locate.cu``) launched inside tier 2, and the same reads
   on the index without its reverse text map no read that tier 2 loses.
   Per batch: both tiers' host ms and cohorts; for one tier-2 call: its
   wall, the wall a sequential staircase step, and
   the device events and busy share under ``torch.profiler``, which must be
   at least 10x fewer events than the eager staircase loop's 13,230;
13. the search modes through the CLI on the phase-4 index: ``-k 0``
   (``ExactAligner``) on 65,536 error-free reads, ``--mode onemm`` on
   16,384 reads with <= 1 substitution, ``--mode staircase -k 2`` on the
   first 16,384 of phase 4's reads; >= 99% mapped and correct in each,
   reads/s, the banded text entry and the staircase kernel launched under
   ``staircase``, the backward-search kernel under ``-k 0``, the
   one-mismatch kernel (``csrc/one_mismatch.cu``) under ``onemm`` and the
   locate kernel under each; then
   ``OneMismatchAligner.align_batch`` on the onemm reads, its two strands'
   device searches timed apart from its host loop;
14. long reads, as the JAX package's long-read bench runs them
   (``bench.py`` ``bench_long``): the phase-4 index and seed table, 4 x 256
   reads of 4,096 bases (seed 31, 8 one-base indels and 20 substitutions a
   read, both strands), the default ``LongReadAligner`` (128-base segments,
   4 hits a segment, 4 probes, band 48, kb = 16) without and then with
   traceback: reads/s of each, >= 99% mapped, >= 99% at their locus (same
   strand, within band + kb), >= 99% at their exact start after traceback
   (+-4), the banded text entry launched; the same reads at kb = 24 (the
   banded group kernel, launched) without traceback, >= 99% mapped and at
   their locus; then ``align --mode long``
   through the CLI on the same 1,024 reads: >= 99% mapped, every mapped
   record tagged ``XT:A:L``;
15. multi-part streaming with the JAX package's gbp bench traffic
   (``bench.py`` ``bench_gbp``: 16 batches of 8,192 reads of 150 bp,
   k = 2, <= 2 substitutions, both strands), first on the phase-3 genome
   cut into two contigs of 32 Mbp, then on the phase-12 repeat genome cut
   the same way, each built by the port into two parts with their
   reversed-text indexes in the flat layout (cached under
   ``smoke_cache/``): ``align_stream_multipart``; on the random genome
   >= 99% mapped and at their true global position (+-k) and strand, on
   the repeat genome >= 97% mapped (phase 12's limit), some reads through
   the two-tier staircase rescue, >= 97% of them mapped, and the banded
   text entry, the staircase kernel and the locate kernel launched in it
   (the staircase in each rescue tier that runs); align and load seconds,
   reads/s, each part's peak device memory, the rescue cohort, and the banded text entry
   launched in each part's stream;
16. several processes (BASELINE config 5's stream on one host): card 0's
   compute mode must not be ``Exclusive_Process``; this script starts
   itself as each rank (``--rank``), joined by gloo on a free loopback
   port, rank r on card r % device_count (on one card, all of them).
   ``ShardedAligner`` (k = 2, 4 interval shards, the phase-4 index and seed
   table; with 2 ranks each holds 2 of the shards and maps the other's, as
   in [20]) on 4 x 32,768 reads of 150 bp (seed 17, <= 1 substitution, one
   indel in 15%), each rank aligning its slice of every batch and running
   the host tail on the gathered batch; then the exact search
   (``multihost.exact_align``: ``make_global_batch``,
   ``exact_interval_search`` + ``locate_hits`` on both strands,
   ``gather_to_host``) on 65,536 error-free 36 bp reads. Each with 1 rank
   and with 2: the 2-rank SAM byte-identical to the 1-rank SAM, >= 99%
   mapped and correct, the windows entry launched in every sharded rank
   (each rank counts its own) and equal to the plain DP on every call of
   one batch of that rank (L = 150, W = 156); reads/s, ``gather_to_host``
   ms a batch (after a barrier, whose wait is printed apart) and each
   rank's peak device memory;
17. index builders and rank backends: ``index --builder device --seed 13``
   through the CLI on the phase-4 FASTA must write every array of the
   phase-4 index (native SA-IS) and its seed table; the device build's
   seconds, doubling rounds and peak device memory a strand against native
   SA-IS on the forward text.  Then ``WaveletRank`` over the forward BWT
   on the card: ``exact_search_wavelet`` on 65,536 error-free 36 bp reads
   must give the fused-row search's (lo, hi) on every read; both searches
   timed;
18. the FM search kernels (``csrc/fm_search.cu``, ``csrc/staircase.cu``,
   ``csrc/one_mismatch.cu``), each held against its plain torch loop on
   every output field (lo, hi, overflow, every slot) at each path's shape
   on that path's index: the backward search on 65,536 reads of 100 bp on
   the phase-4 index (exact and P = 3 pieces, each without a table, with a
   10-mer table, and with a ``max_len`` shorter than the reads); the
   staircase at ``--mode staircase``'s shape (2 x 16,384 lanes) on the
   phase-4 index and at a tier-2 call's (2 x 256 lanes) and the rescue's
   (64 slots, ``narrow_left``) on the phase-12 repeat index; the
   one-mismatch search on 16,384 reads of 100 bp with 48 slots; then 512
   reads of lengths 0, 1, 2 and ragged with N codes mapped to 0 through
   every kernel, with a 1-slot pool (it overflows) and ``keep`` 1.  At each
   shape the kernel, its plain loop (device time, and the eager loop's
   wall: the stage the kernel replaced), the bound (the rows this run's
   data fetches, 48 B each, and their integer work) and the latency floor
   (its sequential steps times one dependent step, measured on one lane
   of 8,192 backward steps) are printed.  The staircase and one-mismatch
   kernels are also held and timed at each group size (1-32 lanes a pool,
   or a read's case; the bindings pick one from the shape), the live slots
   of each non-empty staircase pool-step are counted (mean and maximum), and
   so are the one-mismatch search's case-B dead chains (distinct dead lo
   values a read and step, a row each for bit-equal outputs), with the
   bound that adds them beside the live-only one.  Past 64 slots: the
   staircase at 65, 128 and 256 slots, slot-major and
   narrowing, on the tier-2 cohort of the repeat index (pools that fill),
   and the one-mismatch search at 65 and 128 slots on 4,096 reads, held
   and timed alike;
19. the LF-walk locate (``csrc/locate.cu``: ``rank.locate`` and the
   sharded ``locate``) and the sharded piece search
   (``csrc/fm_search.cu``'s sharded entry), each held against its plain
   loop on every element with the inputs its path gives it, captured from
   the path's own functions on this run's reads: [7]'s locate rows (65,536
   reads, 3 pieces, 8 hits, 2 lanes of slack a piece), [13] ``-k 0``'s
   (65,536 reads), a [12] tier-2 call's (2 x 256 lanes on the repeat
   index), the sharded locate's at [11] (16,384 reads on 4 shards) and
   [10] (65,536), and [11]'s sharded piece search; each timed (kernel,
   plain device time, the eager loop's wall, a bound from the distinct
   rows the walks read, the latency floor in [18]'s dependent-step unit),
   with the persistent grid the locate binding chose; both locates on
   subsets of [7]'s rows (4,096 to 393,216) and the SASS of each kernel's
   LF step (instructions, inner loops, opcodes).  Then row 0, the primary
   row, n and 65,536 random
   rows through both locates at S = 1..16 shards and on hand-made unequal
   shard bounds (the owner guess misses: the scan), the sharded search at
   each S, and one FM sharded align step's device events with the kernels
   and with the plain loops.  With every shard in its own allocation (one
   base pointer a shard, as a shard mapped from another process is), the
   sharded locate, the sharded piece search and the fused table entry
   (65,536 random queries) must equal their plain versions at each S and
   on the unequal bounds.  The same past 16 shards at
   S = 17, 32, 64, 128 and 1,024 and on 32 unequal shards, and the sharded
   locate and piece search timed at [11]'s and [10]'s shapes at 32 shards,
   stacked and one allocation a shard;
20. interval shards in separate processes (BASELINE config 5's layout),
   rank r on card r % device_count: first, in this process, the flag-wait
   ring entry (push, one flag word a block) against its plain version on
   every element on one card (4 ranks emulated, the peers' flags
   pre-published; the pushes and epochs must land in every peer; then the
   peer's per-block words published in reverse order from a second stream
   while the kernel waits), the prepared launch timed, and its failures:
   a wait no peer satisfies must time out, the rank's later merges must
   not wait and must poison every word of its peer, the peer arriving
   late must fail too, and both must raise; and 17 and 32 ranks emulated
   (addresses from a device table), held and timed.  Then this script as 1, 2 and 4
   ranks (``--rank interval``), and as 2 ranks with 32 shards (16 held,
   16 mapped: the kernels on IPC-mapped tables past 16 shards, and the
   seed path's verify, whose peak device memory at 32 shards must stay
   within 1.5x of the 4-shard run's),
   ``ShardedAligner`` with 4 interval shards, each rank
   holding 4 / n of them and mapping the others' through CUDA IPC
   (``parallel.peer``; over NVLink where they lie on other cards; one
   rank: the stacked layout): the seed path on [16]'s reads and the FM
   path on [11]'s, each rank aligning its slice; each card's used memory
   with every rank alive; [10]'s exact search on the same 65,536 reads in
   every rank under the psum (NCCL ``all_reduce`` on the card where the
   ranks have a card each, else gloo on the host), ring (each rank's held
   partial written into its inbox row by the fused table entry, then the
   flag-wait push across cards, else the sum kernel behind a host
   barrier) and fused (the table entry through the peer map) merges, with
   the route each merge took; one merge at the search's payload (2 x
   32,768 int32) timed by route (the ring merge, NCCL back to back and
   synchronised every merge, and gloo ``all_reduce``).  The n-rank SAMs must equal the 1-rank SAMs byte
   for byte with >= 99% mapped and correct, every rank's exact search the
   1-rank result, each rank's sharded tables at most 1 / n of the stacked
   bytes plus one block row a shard (the allocator's requested bytes of
   the uploads, mapped peers not counted; the whole text printed apart),
   the sharded locate, piece search, fused table entry and the ring merge
   equal to their plain versions on the mapped layout, and every rank
   must launch the sharded locate, the sharded piece search, the fused
   table entry, the ring sum (the flag-wait entry across cards) and the
   windows entry; a ring search across ranks exactly one table-entry
   launch and one merge launch a chunk-step.
   Where the ranks have a card each, the psum must go over NCCL alone and
   the ring merge through the flag wait with no host barrier.  Each run's
   wall, reads/s, ms a batch, host barriers and peak device memory a rank
   are printed;
21. the two-axis layout: [20] with 2 shards over 4 ranks, two interval
   groups of two ranks (two copies of the index, one shard a rank), the
   exact search giving each group its half of the reads: the SAMs and
   each rank's exact search equal to [20]'s 1-rank stacked run, each rank
   holding only its group's one shard, and [20]'s routes and launches;
22. BASELINE config 5 with the index sharded across hosts: [20]'s traffic
   with 4 shards over 4 ranks declared on two hosts (``GROUP_RANK`` = r //
   2, ``LOCAL_RANK`` = r: rank r on card r % device_count), one interval
   group across both, which takes the collective route: each rank uploads
   its own shard only and maps nothing (no ``peer.share`` call), the piece
   search is a loop of one fused-table-entry launch and one ``all_reduce``
   a step, the locate one ``all_reduce`` a step, and the verify is split
   over the ranks (each its share of the candidates through the banded
   DP's text entry, the distances all_gathered); the exact search under
   psum, ring and fused refused naming both hosts.  The SAMs and the
   search must equal [20]'s 1-rank results, the merges go over NCCL alone
   where the ranks have a card each and over gloo alone where they share
   one, each rank's tables at most its share plus a block row a shard, the
   fused table entry and the text entry launched in every rank (never the
   windows entry or the mapped route's sharded kernels), and the table
   entry on a rank's held shards equal to plain (0 off them); reads/s, ms
   a batch, merges a batch by route and one merge's ms by route printed.
Each path's kernel launch counts are set to 0 just before it runs and read
just after; the locate kernel's are read in [7], [12], [13], [15] and
[16]'s exact ranks, the sharded locate's in [10], [11], [16]'s sharded
ranks (which take the seed path: 0 there), [20]'s and [21]'s, the sharded
piece search's in [11], [16], [20] and [21], the sum's and the fused table
entry's in [10], [20] and [21], the fused table entry's and the text
entry's in [22], the flag-wait sum's in [20] and [21].  The last lines are a JSON summary of every kernel entry (each
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

import contextlib
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
REPEAT_SEED = 4  # phase 12: the JAX package's repeat bench (bench.py bench_repeat)
REPEAT_BATCH = 32_768
REPEAT_BATCHES = 6
MIN_REPEAT_MAPPED = 0.97  # that bench's own limit
TIER2_EVENTS_PR8 = 13_230  # one tier-2 call's device events with the eager staircase loop
EXACT_READS = 65_536  # phase 13
MODE_READS = 16_384
# phase 14: the JAX package's long-read bench (bench.py bench_long)
LONG_B, LONG_L, LONG_BATCHES, LONG_SEED = 256, 4096, 4, 31
LONG_SEG, LONG_KB, LONG_BAND = 128, 16, 48  # LongReadAligner's defaults
MIN_EXACT_POS = 0.99
# the verify kernels past their one-thread designs: segment bands past 16
# (a group of threads a lane), a band for the scratch kernel, reads past
# the 1,815 bases of which 128 rows fill a block's shared memory ([2], [14]);
# Myers reads past 8 words, and the scratch kernel's words ([6], [8])
WIDE_KS = (17, 20, 24, 31, 32, 48, 64, 96, 127)  # every G (8, 16, 32) and N (9..16) at its edges
WIDE_LONG_KB = 24  # [14]'s second aligner
SCRATCH_K, SCRATCH_K_LANES = 130, 1_024
LONG_ROWS, LONG_ROW_LANES = (1_816, 2_000, 4_096), 4_096
WIDE_MYERS_L = (257, 300, 512, 1_000, 2_048)
SCRATCH_WORDS, SCRATCH_MYERS_LANES, SCRATCH_MYERS_L = 520, 256, 300
PAIR300_L, PAIR300_BATCH, PAIR300_BATCHES = 300, 8_192, 2
PAIR300_INSERTS, PAIR300_FAR_SUBS = (450, 750), 8  # rescue bar max(k, 300 // 20) = 15
PAIR300_RESCUE_W = 1_250  # the first 300 bp rescue call's window columns
# phase 15: the JAX package's gbp bench traffic (bench.py bench_gbp)
GBP_BATCH, GBP_BATCHES, GBP_L, GBP_SEED = 8_192, 8, 150, 29  # the bench runs 16 batches
# phase 16: several processes on one card (BASELINE config 5's stream)
RANKS = 2
RANK_BATCH, RANK_BATCHES, RANK_L, RANK_SEED = 32_768, 2, 150, 17
RANK_EXACT_READS, RANK_EXACT_L, RANK_EXACT_SEED = 65_536, 36, 18  # config 1's length
RANK_TIMEOUT_S = 600  # a rank that hangs fails the phase
INTERVAL_RANKS = (1, 2, 4)  # phase 20: the shards over 1 (stacked), 2 and 4 processes
# past 16 shards and ranks (the kernels' limit until it was lifted): [9],
# [19] sweep these shard counts, [10], [11] and [20] run WIDE_SHARDS on the
# paths ([20]: over 2 ranks, each mapping the other's 16), [20] emulates the
# flag-wait ranks
WIDE_SHARD_COUNTS = (17, 32, 64, 128, 1_024)
WIDE_SHARDS = 32
WIDE_RANKS = (17, 32)
# the checks past 16 shards and 64 slots in [9] and [18], which every entry
# takes; scripts/fm_kernels_ab.py --old-limits turns them off to drive a
# checkout whose kernels stopped there
PAST_OLD_LIMITS = True
TWO_AXIS_RANKS, TWO_AXIS_SHARDS = 4, 2  # phase 21: two interval groups of two ranks
HOST_RANKS, RANKS_A_HOST = 4, 2  # phase 22: SHARDS shards over 4 ranks on two declared hosts
NVLINK_BYTES_PER_S = 450e9  # one direction between two cards of the host
# phase 17: the wavelet search's traffic
WAVELET_READS, WAVELET_L = 65_536, 36
# phase 18: the FM search kernels at their paths' shapes
FM_KMER_J = 10  # a 4^10-entry k-mer table (8 MB)
STAIR_COHORT = 256  # a tier-2 call's padded cohort ([12]) and a rescue chunk's reads ([15])
RESCUE_SLOTS = 64  # the multi-part rescue's pools
WIDE_SLOTS = (65, 128, 256)  # [18]: pools past 64 slots, both orders
WIDE_MM_SLOTS = (65, 128)
# the shapes on either side of the bindings' lane choices: larger tier-2
# cohorts (padded to powers of two, up to the pipeline's 4,096-read chunk),
# the multi-part rescue's own chunk, and smaller --mode batches
STAIR_COHORTS = (512, 1_024, 2_048, 4_096)
RESCUE_CHUNK = 1_024
MODE_SUBSETS = (1_024, 4_096)
ONEMM_SUBSETS = (512, 2_048, 4_096)
CHAIN_L = 8_192  # one read this long, one lane: the dependent-step latency
FM_ROW_BYTES = 48  # one fused row: 8 BWT words and 4 checkpoints
# Least integer instructions a fused row, as csrc/fm_occ.cuh counts it: for
# one code 5 a word (xor, shift, or-not, and with the mask, popcount; the
# add folds into the popcount's sum), for all four codes 12 a word (shift,
# two ands with the mask, three and-nots, three popcounts, three adds).
FM_OPS_PER_ROW_ONE, FM_OPS_PER_ROW_ALL4 = 40, 96
# The locate walk ([19], csrc/locate.cu): a LF step also takes the row's
# code (shift, and, select: 4) and its mark bit (shift, and, test, select:
# 4); rank1 is 4 instructions a mark word (mask, and, popcount, add).
MARK_BLOCK_BYTES = 16
LF_STEP_OPS, RANK1_OPS = 8, 16
# [19]: subsets of [7]'s locate rows, below and past the walks the
# persistent grid holds at once
SWEEP_ROWS = (4_096, 16_384, 65_536, 131_072, 262_144, 393_216)
# The card's published peaks (H100 SXM, at its full 700 W limit): memory
# bytes/s and the float32 rate outside the tensor cores.  Integer work is
# priced at the int32 issue rate, SMs x 64 a clock x the maximum SM clock,
# read from the card in main() (H100 SXM: 132 x 64 x 1.98 GHz = 16.7e12/s).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOAT_OPS_PER_S = 67e12
INT32_PER_CLOCK_PER_SM = 64
INT_OPS_PER_S = None  # set in main()
MAX_SM_HZ = None  # the card's maximum SM clock, set in main()
# The earlier Myers group kernel (carry lookahead over ballots), as PERF.md
# section 6 records its times on an NVIDIA H100 80GB HBM3 at 700.00 W: the
# text entry at [6]'s shapes (2,048 lanes, W = L + 400; 520 words: 256
# lanes of 300) and [8]'s first 300 bp rescue call (819 lanes, W = 1,250),
# ms.  Constants, printed in [6] and [8] beside this run's figures and
# nowhere else: this run does not measure them.
LOOKAHEAD_MYERS_GROUP_MS = {257: 0.0889, 300: 0.0940, 512: 0.1231, 1_000: 0.1795, 2_048: 0.5757,
                       "520 words": 1.4322, "[8] rescue call": 0.1616}
# Least integer instructions per unit of work, as each kernel's source note
# derives them: a banded-DP band cell; a Myers step per read word and per
# step; a fused-rank word.
DP_OPS_PER_CELL = 4
MYERS_OPS_PER_WORD, MYERS_OPS_PER_STEP = 11, 5
RANK_OPS_PER_WORD = 7


# the wall of the checks past the verify kernels' one-thread designs, by
# phase ([2], [6], [8], [14]); main() prints their sum
WIDE_WALL_S: dict[str, float] = {}


class SmokeFailure(Exception):
    pass


# [20]'s verify peak device memory (bytes above what was allocated at its
# call), by (ranks, shards, path)
VERIFY_PEAK: dict[tuple, int] = {}


# when each phase printed its first line (time.time()), keyed by its tag:
# the phases' walls at the end
PHASE_START: dict[str, float] = {}


def log(msg: str) -> None:
    if msg.startswith("["):
        PHASE_START.setdefault(msg[: msg.find("]") + 1], time.time())
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


def ptxas_usage(source: str, tag) -> str:
    """Registers and spills that ptxas reported for the kernel of
    ``csrc/<source>`` whose mangled name holds ``tag`` (or every string of
    a tuple of tags)."""
    import re

    from genome_weaver_align_tpu_torch.ops._cuda_build import ptxas_report

    tags = (tag,) if isinstance(tag, str) else tuple(tag)
    for part in ptxas_report(source).split("Compiling entry function '")[1:]:
        name, _, rest = part.partition("'")
        if not all(t in name for t in tags):
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
    from concurrent.futures import ThreadPoolExecutor, as_completed

    from genome_weaver_align_tpu_torch.ops import (
        dp, dp_cuda, fm_search_cuda, locate_cuda, myers_cuda, one_mismatch_cuda, ring_cuda,
        staircase_cuda, window,
    )

    t0 = time.time()
    libs = (dp_cuda._library, dp_cuda._group_library, myers_cuda._library, ring_cuda._library,
            fm_search_cuda._library, staircase_cuda._library, one_mismatch_cuda._library,
            locate_cuda._library)
    done = {}
    with ThreadPoolExecutor(len(libs)) as pool:  # one nvcc per source, all at once
        futures = {pool.submit(lib): f"{lib.__module__.rsplit('.', 1)[-1]}{lib.__name__}"
                   for lib in libs}
        for f in as_completed(futures):
            f.result()
            done[futures[f]] = round(time.time() - t0, 1)
    log(f"[2] built csrc/banded_dp.cu, banded_group.cu, myers.cu, ring.cu, fm_search.cu, "
        f"staircase.cu, one_mismatch.cu and locate.cu with nvcc for sm_90a in "
        f"{time.time() - t0:.1f} s (each binding's library done at, s: {done}); ptxas: "
        f"flag-wait sum (4 ranks) {ptxas_usage('ring.cu', 'push_wait_kernelIiLi4ELb1E')}, "
        f"fm_search {ptxas_usage('fm_search.cu', 'backward_search_kernel')}, fm_search sharded "
        f"{ptxas_usage('fm_search.cu', 'backward_search_sharded_kernel')}, "
        f"locate {ptxas_usage('locate.cu', '13locate_kernel')}, locate sharded "
        f"{ptxas_usage('locate.cu', '21locate_sharded_kernel')}, fused table entry "
        f"{ptxas_usage('ring.cu', 'fused_occ_kernel')}, staircase (a slot a lane) "
        f"{ptxas_usage('staircase.cu', 'staircase_kernelILi1E')}, staircase (two slots a "
        f"lane) {ptxas_usage('staircase.cu', 'staircase_kernelILi2E')}, one_mismatch "
        f"{ptxas_usage('one_mismatch.cu', 'one_mismatch_kernel')}")
    Q = BATCH * VERIFY_SLACK
    max_err = 0
    timing = None
    for k in (1, 2, 3, 4, *range(9, dp_cuda.REGISTER_K + 1)):
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
    for k in range(1, dp_cuda.REGISTER_K + 1):
        for W in ((L + 3 * k, L // 2) if k in (1, 2, 8, dp_cuda.REGISTER_K) else (L + 3 * k,)):
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
    timing["text_long"] = long_segment_timing(torch, dev, codes, words, gen, card)
    log(f"[2] SASS: {sass_per_cell(dp_cuda._library(), f'banded_dp_kernelILi{K}ELb1E')}")
    for k in (14, dp_cuda.REGISTER_K):  # the short-read aligners' top k, one thread's top
        for entry, flag in (("text", 1), ("windows", 0)):
            tag = f"banded_dp_kernelILi{k}ELb{flag}E"
            log(f"[2] ptxas, {entry} entry at k={k}: {ptxas_usage('banded_dp.cu', tag)}")
    wide_err, timing["wide"] = wide_band_checks(torch, dev, codes, words, gen, card)
    return max(max_err, wide_err), timing


def segment_lanes(torch, dev, codes, gen, k: int, Q: int, Lseg: int):
    """Lanes like the long-read segment verify's: Q segments of Lseg bases,
    each its own lane (rid = arange(Q)), the window of Lseg + 3k starting
    at the segment's diagonal.  Segments copied from the text with 1%
    substitutions and a one-base indel in a quarter of them; 5% ragged (a
    read's tail segment).  -> (starts, reads, lengths, rid, W)."""
    W = Lseg + 3 * k
    n = codes.numel()
    locus = torch.randint(0, n - W - 2, (Q,), generator=gen, device=dev)
    cols = torch.arange(Lseg, device=dev)[None, :].expand(Q, Lseg)
    r = torch.randint(0, 8, (Q, 1), generator=gen, device=dev)
    shift = torch.where(r == 0, -1, torch.where(r == 1, 1, 0))  # an indel in a quarter
    at = torch.randint(8, Lseg - 8, (Q, 1), generator=gen, device=dev)
    reads = codes[locus[:, None] + k + cols + torch.where(cols >= at, shift, 0)]
    sub = torch.rand(Q, Lseg, generator=gen, device=dev) < 0.01
    reads = torch.where(sub, (reads + 1) % 4, reads).to(torch.int8).contiguous()
    lengths = torch.full((Q,), Lseg, dtype=torch.int32, device=dev)
    tail = torch.rand(Q, generator=gen, device=dev) < 0.05
    lengths[tail] = torch.randint(0, Lseg, (int(tail.sum()),), generator=gen, device=dev,
                                  dtype=torch.int32)
    rid = torch.arange(Q, dtype=torch.int32, device=dev)
    return locus.to(torch.int32), reads, lengths, rid, W


def segment_bound(torch, words, starts, reads, lengths, W: int, k: int) -> tuple[float, str]:
    """The text entry's bound on segment lanes: reads, lengths, rid, starts
    and the text words the windows cover in, dist and end_b out;
    DP_OPS_PER_CELL a band cell of every live row."""
    Q = starts.numel()
    w0 = (starts >> 4).long()[:, None] + torch.arange(W // 16 + 2, device=starts.device)
    n_words = int(torch.unique(w0.clamp(0, words.numel() - 1)).numel())
    rows = int(lengths.clamp(max=reads.shape[1]).sum())
    return bound(reads.numel() + 4 * (3 * Q + n_words) + 8 * Q,
                 DP_OPS_PER_CELL * (4 * k + 1) * rows)


def long_segment_timing(torch, dev, codes, words, gen, card):
    """The text entry at the long-read segment verify's shape: LONG_B
    reads of LONG_L bases in LONG_SEG-base segments (Q = 8,192 lanes a
    strand), kb = 16 (``segment_lanes``).  Held against the plain version
    on every lane and timed.  -> (kernel ms, plain ms, bound ms, bound
    by)."""
    from genome_weaver_align_tpu_torch.ops import dp, dp_cuda

    k, Lseg = LONG_KB, LONG_SEG
    Q = LONG_B * (LONG_L // Lseg)
    n = codes.numel()
    starts, reads, lengths, rid, W = segment_lanes(torch, dev, codes, gen, k, Q, Lseg)
    args = (words, n, starts, reads, lengths, rid, k, W)
    d_kern, e_kern = dp_cuda.banded_edit_distance_text_cuda(*args)
    d_plain, e_plain = dp.banded_edit_distance_text_plain(*args)
    torch.cuda.synchronize()
    n_bad = int((d_kern != d_plain).sum()) + int((e_kern != e_plain).sum())
    n_hit = int((d_plain <= 2 * k).sum())
    check(n_bad == 0, f"text entry disagrees with plain at the long-read shape ({n_bad} values)")
    t = [cuda_time_ms(lambda: dp_cuda.banded_edit_distance_text_cuda(*args), reps=50,
                      hide_host=True) for _ in range(2)]
    plain_ms = cuda_time_ms(lambda: dp.banded_edit_distance_text_plain(*args), reps=3, warmup=1)
    b = segment_bound(torch, words, starts, reads, lengths, W, k)
    log(f"[2] text entry at the long-read segment shape, k={k} Q={Q} L={Lseg} W={W}: {n_hit} "
        f"lanes within 2k, mismatches with plain 0; kernel {t[0]:.4f} / {t[1]:.4f} ms (bound "
        f"{b[0]:.4f} ms by {b[1]}, {int(lengths.sum())} live rows), plain {plain_ms:.3f} ms "
        f"({card})")
    return (min(t), plain_ms, *b)


def wide_band_checks(torch, dev, codes, words, gen, card):
    """Both banded entries past the one-thread kernel, against their plain
    versions on every lane (dist, end_b): the group of threads a lane at the
    segment shape (8,192 lanes of 128 bases) for each k of WIDE_KS, the
    scratch kernel at k = SCRATCH_K, and k = 2 and k = WIDE_LONG_KB (the
    group kernel) on LONG_ROW_LANES reads of each LONG_ROWS length (fewer
    staged rows a block, then rows from global memory). The text entry timed
    (CUDA events) beside its plain version and its bound: DP_OPS_PER_CELL
    (4k+1) integer instructions a live row and lane at the card's int32
    rate. ptxas's registers and spills of the new kernels. -> (max |err|,
    {case: (ms, plain ms, bound ms, by, lanes, L, W, k, launches by
    design)})."""
    from genome_weaver_align_tpu_torch.ops import dp, dp_cuda, window

    t_wall = time.time()
    n = codes.numel()
    cases = ([(k, LONG_SEG, LONG_B * (LONG_L // LONG_SEG)) for k in WIDE_KS]
             + [(SCRATCH_K, LONG_SEG, SCRATCH_K_LANES)]
             + [(kk, Lr, LONG_ROW_LANES) for kk in (2, WIDE_LONG_KB) for Lr in LONG_ROWS])
    out, max_err = {}, 0
    for k, Lr, Q in cases:
        starts, reads, lengths, rid, W = segment_lanes(torch, dev, codes, gen, k, Q, Lr)
        args = (words, n, starts, reads, lengths, rid, k, W)
        before = dict(dp_cuda.banded_edit_distance_text_cuda.by_design)
        d_kern, e_kern = dp_cuda.banded_edit_distance_text_cuda(*args)
        ran = [d for d, c in dp_cuda.banded_edit_distance_text_cuda.by_design.items()
               if c != before[d]]
        wins = window.gather_windows(words, n, starts, W)
        d_win, e_win = dp_cuda.banded_edit_distance_cuda(reads, lengths, wins, k)
        d_plain, e_plain = dp.banded_edit_distance_text_plain(*args)
        torch.cuda.synchronize()
        err = max(int((d_kern - d_plain).abs().max()), int((d_win - d_plain).abs().max()))
        max_err = max(max_err, err)
        n_bad = sum(int((x != y).sum()) for x, y in ((d_kern, d_plain), (e_kern, e_plain),
                                                     (d_win, d_plain), (e_win, e_plain)))
        n_hit = int((d_plain <= 2 * k + 2).sum())
        check(n_bad == 0, f"banded entries disagree with plain at k={k} L={Lr} ({n_bad} values)")
        if Lr == LONG_SEG:  # long rows carry 1% substitutions: dozens at L = 4,096
            check(n_hit > Q // 2, f"too few planted lanes found at k={k} L={Lr}: {n_hit}")
        t = [cuda_time_ms(lambda: dp_cuda.banded_edit_distance_text_cuda(*args), reps=20,
                          hide_host=True) for _ in range(2)]
        plain_ms = cuda_time_ms(lambda: dp.banded_edit_distance_text_plain(*args), reps=1,
                                warmup=0)
        b = segment_bound(torch, words, starts, reads, lengths, W, k)
        out[f"k={k} L={Lr}"] = (min(t), plain_ms, *b, Q, Lr, W, k, ran)
        log(f"[2] wide band / long rows, k={k} Q={Q} L={Lr} W={W} ({', '.join(ran)} kernel): "
            f"{n_hit} lanes within 2k + 2; text and windows entries against plain: mismatches 0, "
            f"max |dist err| {err}; text entry {t[0]:.4f} / {t[1]:.4f} ms (bound {b[0]:.4f} ms "
            f"by {b[1]}, {int(lengths.sum())} live rows), plain {plain_ms:.3f} ms ({card})")
        del wins
    for what, source, tag in (
            ("group, text, 9 slots a thread", "banded_group.cu", "banded_group_kernelILi9ELb1E"),
            ("group, text, 16 slots a thread", "banded_group.cu",
             "banded_group_kernelILi16ELb1E"),
            ("group, windows, 13 slots a thread", "banded_group.cu",
             "banded_group_kernelILi13ELb0E"),
            ("scratch, text", "banded_dp.cu", "banded_mem_kernelILb1E"),
            ("one thread, text, k = 0", "banded_dp.cu", "banded_dp_kernelILi0ELb1E")):
        log(f"[2] ptxas, banded {what}: {ptxas_usage(source, tag)}")
    WIDE_WALL_S["[2]"] = time.time() - t_wall
    log(f"[2] wide band and long rows: {WIDE_WALL_S['[2]']:.1f} s of wall")
    return max_err, out


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


def build_parts(g, name: str) -> tuple[Path, float | None]:
    """[15]'s parts of ``g``: cut into two contigs and built into two flat
    parts with their reversed-text indexes, once, into smoke_cache/parts_<name>
    -> (the directory, the build's seconds or None where it was built)."""
    from genome_weaver_align_tpu_torch.index import multipart_io
    from genome_weaver_align_tpu_torch.utils.fasta import Contig

    part_dir = CACHE / f"parts_{name}"
    if (part_dir / "parts.json").exists():
        return part_dir, None
    mid = g.size // 2
    tmp = part_dir.with_name(part_dir.name + f".tmp{os.getpid()}")
    t0 = time.time()
    multipart_io.build_multipart(
        tmp, [Contig("chr20a", g[:mid]), Contig("chr20b", g[mid:])],
        part_limit=g.size - mid, seed_j=SEED_J, sample_rate=8,
        flat=True, log=lambda m: log(f"[15] {m}"))
    os.replace(tmp, part_dir)
    return part_dir, time.time() - t0


def prebuild_child() -> int:
    """``chip_smoke.py --prebuild``: the host-only index builds that [12]
    and [15] read from smoke_cache/, made on the host's cores while the main
    process runs [2]-[11] on the card: the repeat genome's CLI index (its
    seconds to smoke_cache/prebuild.json) and both genomes' parts.  The
    card is hidden from it (CUDA_VISIBLE_DEVICES is empty): every builder
    runs on the host, as in the main process."""
    sys.path.insert(0, str(ROOT))
    from genome_weaver_align_tpu_torch import cli
    from genome_weaver_align_tpu_torch.utils.simulate import random_genome, repeat_genome

    rep_codes = repeat_genome(GENOME_LEN, seed=REPEAT_SEED)
    _, _, index_s = build_index(cli, rep_codes, f"repeat_{GENOME_LEN}_seed{REPEAT_SEED}",
                                "chr20rep")
    (CACHE / "prebuild.json").write_text(json.dumps({"repeat_index_s": index_s}))
    parts_s = {}
    for name, g in ((f"{GENOME_LEN}_seed{GENOME_SEED}", random_genome(GENOME_LEN,
                                                                      seed=GENOME_SEED)),
                    (f"repeat_{GENOME_LEN}_seed{REPEAT_SEED}", rep_codes)):
        parts_s[name] = build_parts(g, name)[1]
    (CACHE / "prebuild.json").write_text(json.dumps({"repeat_index_s": index_s,
                                                     "parts_s": parts_s}))
    return 0


# the prebuild process (``prebuild_child``) while it runs
PREBUILD: dict = {}


def start_prebuild() -> None:
    """Start ``chip_smoke.py --prebuild`` with its output to smoke_cache/."""
    CACHE.mkdir(exist_ok=True)
    out = open(CACHE / "prebuild.log", "w")
    PREBUILD["proc"] = subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--prebuild"], stdout=out,
        stderr=subprocess.STDOUT, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    PREBUILD["t0"] = time.time()
    out.close()


def join_prebuild(tag: str) -> dict:
    """Wait for the prebuild (once), print its lines and how long ``tag``
    waited for it; it must have exited 0.  -> its prebuild.json."""
    proc = PREBUILD.pop("proc", None)
    if proc is not None:
        t0 = time.time()
        rc = proc.wait()
        lines = (CACHE / "prebuild.log").read_text().splitlines()
        for line in lines:
            log(f"{tag} prebuild: {line}")
        log(f"{tag} the prebuild of [12]'s index and [15]'s parts ran on the host beside [2]-"
            f"[11]: exited {rc} after {time.time() - PREBUILD['t0']:.1f} s, {tag} waited "
            f"{time.time() - t0:.1f} s for it")
        check(rc == 0, f"the prebuild exited {rc}")
    return json.loads((CACHE / "prebuild.json").read_text())


def stop_prebuild() -> None:
    """End the prebuild if it still runs (a phase failed before joining it)."""
    proc = PREBUILD.pop("proc", None)
    if proc is not None and proc.poll() is None:
        proc.kill()
        proc.wait()


def build_index(cli, codes, name: str = f"random_{GENOME_LEN}_seed{GENOME_SEED}",
                contig: str = "chr20s") -> tuple[Path, Path, float | None]:
    """The CLI index (with its reverse text) and seed table of a smoke
    genome, built once into smoke_cache/<name>."""
    from genome_weaver_align_tpu_torch.utils.fasta import Contig, write_fasta

    cache = CACHE / name
    idx, seedf = cache / "genome.npz", cache / f"genome.npz.seed{SEED_J}.npz"
    if idx.exists() and seedf.exists():
        return idx, seedf, None
    tmp = cache.with_name(cache.name + f".tmp{os.getpid()}")
    tmp.mkdir(parents=True)
    write_fasta(tmp / "genome.fa", [Contig(contig, codes)])
    t0 = time.time()
    rc = cli.main(["index", str(tmp / "genome.fa"), "-o", str(tmp / "genome.npz"),
                   "--seed", str(SEED_J)])
    secs = time.time() - t0
    check(rc == 0, f"index exited {rc}")
    os.replace(tmp, cache)
    return idx, seedf, secs


def write_reads(path: Path, codes, n: int = BATCH * N_BATCHES, seed: int = 11,
                max_subs: int = 2, of: int | None = None) -> None:
    """n simulated reads with 0..max_subs substitutions as FASTQ, their true
    locus and strand in the name; with ``of``, the first n of the ``of``
    reads that seed gives."""
    import numpy as np

    from genome_weaver_align_tpu_torch.utils.simulate import simulate_reads_array

    reads, pos, strand, _ = simulate_reads_array(codes, of or n, L, seed=seed, max_subs=max_subs)
    reads, pos, strand = reads[:n], pos[:n], strand[:n]
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
    return launches, index_s


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


def sass_loops(lib, tags) -> tuple[str, list]:
    """(kernel name, every loop of its SASS, each the instructions between
    a backward branch's target and the branch as (address, opcode, operand
    text, guard)) for the kernel of ``lib`` whose mangled name holds every
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
        loops = []
        for addr, op, text, _ in insts:
            tgt = re.search(r"0x([0-9a-f]+)", text) if op.startswith("BRA") else None
            if tgt and int(tgt.group(1), 16) <= addr:
                loops.append([i for i in insts if int(tgt.group(1), 16) <= i[0] <= addr])
        return name, loops
    return f"no kernel named *{'*'.join(tags)}*", []


def sass_loop(lib, tags) -> tuple[str, list]:
    """(kernel name, the instructions of its longest loop) (``sass_loops``)."""
    name, loops = sass_loops(lib, tags)
    return name, max(loops, key=len, default=[])


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


# One warp times two dependent chains with the SM clock: 64 x n integer
# instructions, an xor and an add in turn (LOP3 and IADD3, the links of the
# Myers step), then 32 x n warp shuffles, each taking the last's result.
LATENCY_PROBE = r"""
#include <cuda_runtime.h>
__global__ void chains(long long* out, unsigned x, unsigned y, unsigned z, int n) {
  x += threadIdx.x;
  const long long t0 = clock64();
  for (int i = 0; i < n; ++i) {
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      asm volatile("xor.b32 %0, %0, %1;" : "+r"(x) : "r"(y));
      asm volatile("add.u32 %0, %0, %1;" : "+r"(x) : "r"(z));
    }
  }
  const long long t1 = clock64();
  unsigned v = x;
  for (int i = 0; i < n; ++i) {
#pragma unroll
    for (int k = 0; k < 32; ++k) v = __shfl_up_sync(0xFFFFFFFFu, v, 1);
  }
  const long long t2 = clock64();
  if (threadIdx.x == 0) {
    out[0] = t1 - t0;
    out[1] = t2 - t1;
    out[2] = static_cast<long long>(v);
  }
}
extern "C" int gwa_latency_probe(long long* host, int n) {
  long long* d = nullptr;
  cudaError_t e = cudaMalloc(&d, 3 * sizeof(long long));
  if (e != cudaSuccess) return static_cast<int>(e);
  chains<<<1, 32>>>(d, 0x9E3779B9u, 0x85EBCA6Bu, 0xC2B2AE35u, n);
  e = cudaMemcpy(host, d, 3 * sizeof(long long), cudaMemcpyDeviceToHost);
  cudaFree(d);
  return static_cast<int>(e);
}
"""


def probe_latencies() -> tuple[float, float]:
    """(cycles from an integer instruction to a dependent one, cycles from
    a warp shuffle to a dependent one), measured on card 0 by
    ``LATENCY_PROBE``: its two chains timed with clock64, the second of
    two launches (the first warms the code)."""
    import ctypes

    from genome_weaver_align_tpu_torch.ops._cuda_build import BUILD_DIR, NVCC_FLAGS, find_nvcc

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = BUILD_DIR / f"latency_probe{os.getpid()}.cu"
    lib_path = src.with_suffix(".so")
    src.write_text(LATENCY_PROBE)
    try:
        subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", str(lib_path), str(src)], check=True,
                       capture_output=True, text=True, timeout=300)
        lib = ctypes.CDLL(str(lib_path))
        out = (ctypes.c_longlong * 3)()
        n = 256
        for _ in range(2):
            rc = lib.gwa_latency_probe(out, n)
            check(rc == 0, f"the latency probe failed: CUDA error {rc}")
    finally:
        src.unlink(missing_ok=True)
        lib_path.unlink(missing_ok=True)
    return out[0] / (64 * n), out[1] / (32 * n)


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
    versions timed, the group kernel at the binding's group shape; the
    text kernel's and the group kernel's step chains from their SASS, at
    the latencies ``probe_latencies`` measures."""
    from genome_weaver_align_tpu_torch.ops import myers, myers_cuda, window

    max_err = 0
    times = {}
    # the one-thread kernel's shapes, the verify shape, reads past 8 words
    # (a group of threads a lane) and the scratch kernel's words
    shapes = [(RESCUE_LANES, Lr, Lr + 400, -(-Lr // 32)) for Lr in (32, 64, 100, 150, 256)]
    shapes.append((BATCH * VERIFY_SLACK, L, L + 3 * K, -(-L // 32)))
    shapes += [(RESCUE_LANES, Lr, Lr + 400, -(-Lr // 32)) for Lr in WIDE_MYERS_L]
    shapes.append((SCRATCH_MYERS_LANES, SCRATCH_MYERS_L, SCRATCH_MYERS_L + 400, SCRATCH_WORDS))
    t_wide = 0.0
    for Q, Lr, W, nwords in shapes:
        t_shape = time.time()
        r, ln, w = (torch.from_numpy(a).to(dev) for a in myers_inputs(Q, Lr, W, Lr + Q))
        b_kern, e_kern = myers_cuda.myers_semiglobal_cuda(r, ln, w, nwords)
        b_plain, e_plain = myers._myers_plain(r, ln, w, nwords, W)
        torch.cuda.synchronize()
        err = max(int((b_kern - b_plain).abs().max()), int((e_kern - e_plain).abs().max()))
        max_err = max(max_err, err)
        n_bad = int(((b_kern != b_plain) | (e_kern != e_plain)).sum())
        n_hit = int((b_plain <= max(K, Lr // 20)).sum())
        log(f"[6] windows entry Q={Q} L={Lr} W={W} nwords={nwords} "
            f"({myers_cuda.design(nwords)} kernel): {n_hit} lanes within the rescue bar, "
            f"(best, end) mismatches {n_bad}, max |err| {err}")
        check(n_bad == 0, f"Myers windows entry disagrees with plain at Q={Q} L={Lr} W={W}")
        if nwords > myers_cuda.LANE_WORDS:
            times["windows_wide", Lr, nwords] = cuda_time_ms(
                lambda: myers_cuda.myers_semiglobal_cuda(r, ln, w, nwords), reps=20,
                hide_host=True)
            t_wide += time.time() - t_shape
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
    text_shapes = [(RESCUE_LANES, Lr, Lr + 400, mode, -(-Lr // 32))
                   for Lr in (32, 64, 100, 150, 256) for mode in ("identity", "repeat")]
    text_shapes.append((BATCH * VERIFY_SLACK, L, L + 3 * K, "verify", -(-L // 32)))
    text_shapes += [(RESCUE_LANES, Lr, Lr + 400, "identity", -(-Lr // 32)) for Lr in WIDE_MYERS_L]
    text_shapes.append((RESCUE_LANES, PAIR300_L, PAIR300_L + 400, "repeat", -(-PAIR300_L // 32)))
    text_shapes.append((SCRATCH_MYERS_LANES, SCRATCH_MYERS_L, SCRATCH_MYERS_L + 400, "identity",
                        SCRATCH_WORDS))
    for Q, Lr, W, mode, nwords in text_shapes:
        t_shape = time.time()
        starts, reads, lengths, rid, valid = myers_text_lanes(torch, codes, Q, Lr, W, gen, mode)
        args = (words, GENOME_LEN, starts, reads, lengths, rid, valid, W, nwords)
        b_kern, e_kern = myers_cuda.myers_semiglobal_text_cuda(*args)
        b_plain, e_plain = myers.myers_semiglobal_text_plain(*args)
        torch.cuda.synchronize()
        err = max(int((b_kern - b_plain).abs().max()), int((e_kern - e_plain).abs().max()))
        max_text = max(max_text, err)
        n_bad = int(((b_kern != b_plain) | (e_kern != e_plain)).sum())
        n_hit = int((b_plain <= max(K, Lr // 20)).sum())
        log(f"[6] text entry Q={Q} L={Lr} W={W} nwords={nwords} rid {mode} "
            f"({myers_cuda.design(nwords)} kernel): {n_hit} lanes within the rescue "
            f"bar, {int((valid < W).sum())} lanes with valid < W, (best, end) mismatches "
            f"{n_bad}, max |err| {err}")
        check(n_bad == 0, f"Myers text entry disagrees with plain at Q={Q} L={Lr} W={W} {mode}")
        check(n_hit > Q // 20, f"too few planted lanes found at Q={Q} L={Lr}")
        if nwords > myers_cuda.LANE_WORDS and mode == "identity":
            # reads, lengths, starts, rid, valid and the text words in, best
            # and end out; (11 nwords + 5) instructions a lane-step
            t = [cuda_time_ms(lambda: myers_cuda.myers_semiglobal_text_cuda(*args), reps=20,
                              hide_host=True) for _ in range(2)]
            plain_ms = None
            if Lr == PAIR300_L or nwords > myers_cuda.MEM_WORDS:
                plain_ms = cuda_time_ms(lambda: myers.myers_semiglobal_text_plain(*args),
                                        reps=1, warmup=0)
            w0 = (starts >> 4).long()[:, None] + torch.arange(W // 16 + 2, device=dev)
            n_words = int(torch.unique(w0.clamp(0, words.numel() - 1)).numel())
            n_bytes = reads.numel() + 4 * (lengths.numel() + 3 * Q + n_words) + 8 * Q
            n_ops = (MYERS_OPS_PER_WORD * nwords + MYERS_OPS_PER_STEP) * W * int(
                (lengths[rid.long()] > 0).sum())
            b = bound(n_bytes, n_ops)
            times["text_wide", Lr, nwords] = (min(t), plain_ms, *b, Q, W)
            win_ms = times.get(("windows_wide", Lr, nwords))
            G, P = myers_cuda.group_shape(nwords)
            before = LOOKAHEAD_MYERS_GROUP_MS.get(Lr if nwords <= myers_cuda.MEM_WORDS
                                                  else f"{nwords} words")
            log(f"[6] text entry Q={Q} L={Lr} W={W} nwords={nwords} "
                f"({myers_cuda.design(nwords)} kernel, G x P = {G} x {P}): kernel {t[0]:.4f} / "
                f"{t[1]:.4f} ms (bound {b[0]:.4f} ms by {b[1]}); windows entry {win_ms:.4f} ms; "
                f"plain " + (f"{plain_ms:.3f} ms" if plain_ms is not None else "not timed")
                + f" ({card}); the lookahead design's {before} ms as PERF.md records it "
                "(a constant, not measured in this run)")
        if nwords > myers_cuda.LANE_WORDS:
            t_wide += time.time() - t_shape
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

    WIDE_WALL_S["[6]"] = t_wide
    log(f"[6] reads past 8 words: {t_wide:.1f} s of wall")
    for P in myers_cuda.REG_WORDS:
        tags = ("myers_group_kernel", f"RegWordsILi{P}E", "TextStream")
        log(f"[6] ptxas, Myers group text entry, {P} words a thread: "
            f"{ptxas_usage('myers.cu', tags)}")
    log(f"[6] ptxas, Myers group text entry, scratch: "
        f"{ptxas_usage('myers.cu', ('myers_group_kernel', 'MemWords', 'TextStream'))}")
    times["shape_by_L"] = {Lr: "x".join(map(str, myers_cuda.group_shape(-(-Lr // 32))))
                           for Lr in WIDE_MYERS_L}
    link, shfl = probe_latencies()
    times["link_cycles"], times["shfl_cycles"] = link, shfl
    log(f"[6] measured on the card: {link:.2f} cycles from an integer instruction to a "
        f"dependent one, {shfl:.2f} from a warp shuffle to a dependent one ({card})")
    # the wavefront's floor: a time step waits on one thread's chain and one
    # shuffle; [8]'s rescue call runs (RESCUE_W + G - 1) of them at 10 words
    G, P = myers_cuda.group_shape(-(-PAIR300_L // 32))
    name, loop = sass_loop(myers_cuda._library(),
                           ("myers_group_kernel", f"RegWordsILi{P}E", "TextStream"))
    chain = dependent_chain(loop) if loop else 0
    if chain:
        per_step = chain / 16
        steps = PAIR300_RESCUE_W + G - 1
        floor_ms = steps * (per_step * link + shfl) / MAX_SM_HZ * 1e3
        times["group_floor"] = floor_ms
        log(f"[6] SASS of {name}: the 16-step loop is {len(loop)} instructions, its longest "
            f"dependent chain a trip {chain} fixed-latency instructions = {per_step:.2f} a time "
            f"step, plus one shuffle; at [8]'s rescue call ({PAIR300_RESCUE_W} columns + "
            f"{G - 1}, G x P = {G} x {P}, {MAX_SM_HZ / 1e9:.2f} GHz, the latencies above) the "
            f"latency floor is {floor_ms:.4f} ms")
    else:
        times["group_floor"] = None
        log(f"[6] SASS of the group kernel: not measured ({name})")
    name, loop = sass_loop(myers_cuda._library(), ("myers_kernelILi4E", "TextStream"))
    chain = dependent_chain(loop) if loop else 0
    if chain:
        # 16 window columns a trip round the unrolled loop
        per_step = chain / 16
        floor_ms = (L + 400) * per_step * link / MAX_SM_HZ * 1e3
        # a warp issues at most one instruction a cycle, and the rescue
        # cohort is a warp or less a multiprocessor: each lane's warp issues
        # the loop's instructions of every column itself
        issue_ms = (L + 400) * len(loop) / 16 / MAX_SM_HZ * 1e3
        times["floor"], times["issue_floor"] = floor_ms, issue_ms
        log(f"[6] SASS of {name}: the 16-column loop is {len(loop)} instructions "
            f"({len(loop) / 16:.2f} a column), its longest dependent chain a trip {chain} "
            f"instructions = {per_step:.2f} a column; at the rescue shape ({L + 400} columns, "
            f"{MAX_SM_HZ / 1e9:.2f} GHz) the latency floor ({link:.2f} cycles a link) is "
            f"{floor_ms:.4f} ms and one warp's issue floor (one instruction a cycle) "
            f"{issue_ms:.4f} ms")
    else:
        times["floor"] = times["issue_floor"] = None
        log(f"[6] SASS: not measured ({name})")
    return (max_err, max_text), times


def phase_fm_cli(codes, card) -> tuple[int, int]:
    """The FM pigeonhole path end to end through the CLI (no seed table).
    -> the backward-search kernel's launches (the pieces' search) and the
    locate kernel's."""
    from genome_weaver_align_tpu_torch import cli
    from genome_weaver_align_tpu_torch.ops import dp_cuda, fm_search_cuda, locate_cuda, myers_cuda

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
    fm_search_cuda.backward_search_cuda.launches = 0
    locate_cuda.locate_cuda.launches = 0
    rc = cli.main(["align", str(idx), str(fq), "-k", str(K), "--batch-size", str(BATCH),
                   "--report", str(rep), "-o", str(sam)])
    launches = dp_cuda.banded_edit_distance_text_cuda.launches
    search_launches = fm_search_cuda.backward_search_cuda.launches
    locate_launches = locate_cuda.locate_cuda.launches
    check(rc == 0, f"FM-path align exited {rc}")
    report = json.loads(rep.read_text())
    n, mapped, correct = score_sam(sam)
    shutil.rmtree(work)
    log(f"[7] FM path, align -k {K} without a seed table: {n} reads, mapped "
        f"{mapped / n:.6f}, correct {correct / n:.6f}, {report['reads_per_s']} reads/s over "
        f"{report['wall_s']} s ({card}), banded-DP launches: text entry {launches}, windows "
        f"entry {dp_cuda.banded_edit_distance_cuda.launches}; Myers launches: text entry "
        f"{myers_cuda.myers_semiglobal_text_cuda.launches}, windows entry "
        f"{myers_cuda.myers_semiglobal_cuda.launches}; backward-search (piece) launches "
        f"{search_launches}; locate launches {locate_launches}")
    check(n == n_reads, f"SAM holds {n} records")
    check(launches > 0, "the FM-path run never launched the banded DP kernel's text entry")
    check(search_launches > 0, "the FM-path run never launched the backward-search kernel")
    check(locate_launches > 0, "the FM-path run never launched the locate kernel")
    check(mapped / n >= MIN_MAPPED, f"FM path mapped share {mapped / n:.4f} < {MIN_MAPPED}")
    check(correct / n >= MIN_CORRECT, f"FM path correct share {correct / n:.4f} < {MIN_CORRECT}")
    return search_launches, locate_launches


def make_pairs(codes, n: int = PAIR_BATCH * PAIR_BATCHES, Lr: int = L,
               inserts: tuple[int, int] = (250, 550), far_subs: int = 4, seed: int = 21):
    """n FR pairs of Lr bases: inserts in ``inserts``, 1-2 substitutions on
    each mate, 10% of mate2 with ``far_subs`` more (unmappable at k = 2,
    within the rescue bar max(k, Lr // 20): 5 for 6 x 16,384 pairs of 100
    bp with 4, 15 for 2 x 8,192 of 300 bp with 8)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    insert = rng.integers(*inserts, size=n)
    pos1 = rng.integers(0, codes.size - inserts[1] - 50, size=n)
    c1 = codes[pos1[:, None] + np.arange(Lr)[None, :]].astype(np.int8)
    p2 = pos1 + insert - Lr
    c2raw = codes[p2[:, None] + np.arange(Lr)[None, :]].astype(np.int8)
    c2 = np.ascontiguousarray((3 - c2raw)[:, ::-1])  # mate2 on the reverse strand
    for arr in (c1, c2):
        for _ in range(2):
            at = rng.integers(0, Lr, size=n)
            rows = np.nonzero(rng.random(n) < 0.6)[0]
            arr[rows, at[rows]] = (arr[rows, at[rows]] + rng.integers(1, 4, size=rows.size)) % 4
    half = np.nonzero(rng.random(n) < 0.10)[0]
    for _ in range(far_subs):
        at = rng.integers(0, Lr, size=n)
        c2[half, at[half]] = (c2[half, at[half]] + rng.integers(1, 4, size=half.size)) % 4
    return c1, c2, pos1


def write_mates(path: Path, mates, pos1) -> None:
    import numpy as np

    Lr = mates.shape[1]
    seqs = np.frombuffer(b"ACGT", np.uint8)[mates].tobytes()
    qual = "I" * Lr
    with open(path, "w") as fh:
        fh.write("".join(
            f"@p{i}_{p}\n{seqs[i * Lr:(i + 1) * Lr].decode()}\n+\n{qual}\n"
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


def phase_paired_300(torch, dev, codes, card) -> dict:
    """MiSeq-style pairs through the CLI: ``align --paired --seed-table`` on
    PAIR300_BATCHES x PAIR300_BATCH pairs of 300 bp (``make_pairs``: inserts
    450-750, 10% of mate2 with 8 more substitutions).  Exit 0, >= 90%
    proper pairs, >= 5% of pairs rescued (counted from the pairs the CLI's
    ``PairedAligner.align_pairs`` returns), the Myers text entry launched
    at 10 words (its group kernel) and never the windows entry, and the
    first rescue call's lanes equal to the plain version on its own
    inputs.  -> {"launches", "group", "max_err", "ms", "pairs_per_s"}."""
    from genome_weaver_align_tpu_torch import cli
    from genome_weaver_align_tpu_torch.models.paired import PairedAligner
    from genome_weaver_align_tpu_torch.ops import myers, myers_cuda

    idx, seedf, _ = build_index(cli, codes)
    t_wall = time.time()
    n_pairs = PAIR300_BATCH * PAIR300_BATCHES
    c1, c2, pos1 = make_pairs(codes, n_pairs, PAIR300_L, PAIR300_INSERTS, PAIR300_FAR_SUBS,
                              seed=23)
    work = CACHE / f"pairs300_{os.getpid()}"
    work.mkdir(parents=True)
    f1, f2, sam, rep = work / "r1.fq", work / "r2.fq", work / "out.sam", work / "report.json"
    write_mates(f1, c1, pos1)
    write_mates(f2, c2, pos1)

    calls, words, hits = [], [], []
    real_text, real_pairs = myers.myers_semiglobal_text, PairedAligner.align_pairs

    def rescue(*args):
        words.append(args[-1])
        out = real_text(*args)
        if not calls:  # the first rescue call: its inputs and lanes, held below
            calls.append(([a.clone() if torch.is_tensor(a) else a for a in args],
                          [o.clone() for o in out]))
        return out

    def align_pairs(self, batch):
        out = real_pairs(self, batch)
        hits.extend(out)
        return out

    myers_cuda.myers_semiglobal_text_cuda.launches = 0
    myers_cuda.myers_semiglobal_text_cuda.by_design = dict.fromkeys(myers_cuda.DESIGNS, 0)
    myers_cuda.myers_semiglobal_cuda.launches = 0
    with mock.patch.object(myers, "myers_semiglobal_text", rescue), \
            mock.patch.object(PairedAligner, "align_pairs", align_pairs):
        rc = cli.main(["align", str(idx), str(f1), "--paired", str(f2), "-k", str(K),
                       "--seed-table", str(seedf), "--batch-size", str(PAIR300_BATCH),
                       "--report", str(rep), "-o", str(sam)])
    launches = myers_cuda.myers_semiglobal_text_cuda.launches
    by_design = dict(myers_cuda.myers_semiglobal_text_cuda.by_design)
    win_launches = myers_cuda.myers_semiglobal_cuda.launches
    check(rc == 0, f"paired align of {PAIR300_L} bp exited {rc}")
    report = json.loads(rep.read_text())
    n_rec = n_proper_rec = 0
    with open(sam) as fh:
        for line in fh:
            if line[0] != "@":
                n_rec += 1
                n_proper_rec += bool(int(line.split("\t", 2)[1]) & 2)
    shutil.rmtree(work)
    proper = n_proper_rec / 2 / n_pairs
    rescued = sum(ph.rescued != 0 for ph in hits) / n_pairs
    check(calls, "the 300 bp pairs never reached the mate rescue")
    args, (b_kern, e_kern) = calls[0]
    b_plain, e_plain = myers.myers_semiglobal_text_plain(*args)
    torch.cuda.synchronize()
    err = max(int((b_kern - b_plain).abs().max()), int((e_kern - e_plain).abs().max()))
    n_bad = int(((b_kern != b_plain) | (e_kern != e_plain)).sum())
    lanes, W, nwords = int(args[2].numel()), args[-2], args[-1]
    ms = cuda_time_ms(lambda: real_text(*args), reps=20, hide_host=True)
    G, P = myers_cuda.group_shape(nwords)
    WIDE_WALL_S["[8]"] = wall = time.time() - t_wall
    log(f"[8] paired CLI, {n_pairs} pairs of {PAIR300_L} bp (inserts {PAIR300_INSERTS[0]}-"
        f"{PAIR300_INSERTS[1]}): {n_rec} records, proper {proper:.6f} (report "
        f"{report['proper_pairs']}), rescued {rescued:.6f}, {report['reads_per_s']} reads/s over "
        f"{report['wall_s']} s (phase wall {wall:.1f} s); Myers text-entry launches {launches} "
        f"({by_design}), at nwords {sorted(set(words))}, windows entry {win_launches}; the first "
        f"rescue call, {lanes} lanes x W={W} at {nwords} words, against plain: mismatches "
        f"{n_bad}, max |err| {err}; that call's kernel {ms:.4f} ms at G x P = {G} x {P} "
        f"({card}); the lookahead design's {LOOKAHEAD_MYERS_GROUP_MS['[8] rescue call']} ms as "
        "PERF.md records it (a constant, not measured in this run)")
    check(n_rec == 2 * n_pairs, f"SAM holds {n_rec} records")
    check(proper >= MIN_PROPER, f"{PAIR300_L} bp proper share {proper:.4f} < {MIN_PROPER}")
    check(rescued >= MIN_RESCUED, f"{PAIR300_L} bp rescued share {rescued:.4f} < {MIN_RESCUED}")
    check(launches > 0 and set(words) == {-(-PAIR300_L // 32)} and by_design["group"] == launches,
          f"the {PAIR300_L} bp rescue did not run the Myers text entry's group kernel at "
          f"{-(-PAIR300_L // 32)} words")
    check(win_launches == 0, "the 300 bp rescue built a window tensor for the windows entry")
    check(n_bad == 0, "a 300 bp rescue call's lanes disagree with the plain version")
    return {"launches": launches, "group": by_design["group"], "max_err": err, "ms": ms,
            "lanes": lanes, "W": W, "nwords": nwords, "shape": [G, P]}


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


# the sum kernel writing every shard's row, by S ([9], beside the path's
# one-row call)
RING_ALL_ROWS_MS: dict[int, float] = {}


def time_path_sum(torch, ring_cuda, ring, parts) -> tuple:
    """The sum as the exact search's ring merge calls it (shard 0's row
    alone), held against plain first: (kernel ms, plain ms, bound ms, bound
    by, ``parts.sum(0)`` ms), all timed in one run; the kernel writing every
    row goes to ``RING_ALL_ROWS_MS``.  Bound: every shard's partial read
    and one row written; S - 1 adds an element."""
    S = parts.shape[0]
    check(torch.equal(ring_cuda.ring_allreduce_cuda(parts, only=0), ring.ring_psum_plain(parts)[0]),
          f"[9] the one-row sum differs from plain at S={S}")
    ms = cuda_time_ms(lambda: ring_cuda.ring_allreduce_cuda(parts, only=0), reps=200,
                      hide_host=True)
    lib_ms = cuda_time_ms(lambda: parts.sum(0, dtype=torch.int32), reps=200, hide_host=True)
    ms2 = cuda_time_ms(lambda: ring_cuda.ring_allreduce_cuda(parts, only=0), reps=200,
                       hide_host=True)
    RING_ALL_ROWS_MS[S] = cuda_time_ms(lambda: ring_cuda.ring_allreduce_cuda(parts), reps=200,
                                       hide_host=True)
    plain_ms = cuda_time_ms(lambda: ring.ring_psum_plain(parts), reps=20, hide_host=True)
    row = parts[0].numel()
    return (min(ms, ms2), plain_ms, *bound((S + 1) * row * 4, (S - 1) * row), lib_ms)


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

    # past 16 shards: the sum stacked and in separate allocations (one
    # output and all), the words entry, the table entry stacked and one
    # allocation a shard
    t_wide = time.time()
    for S in WIDE_SHARD_COUNTS if PAST_OLD_LIMITS else ():
        for dtype, n in ((torch.int32, 777), (torch.int32, 65_536), (torch.float32, 777)):
            x = (torch.randint(-(1 << 30), 1 << 30, (S, n), generator=gen, device=dev,
                               dtype=torch.int32) if dtype == torch.int32
                 else torch.randn((S, n), generator=gen, device=dev) * 1e4)
            want = ring.ring_psum_plain(x)
            apart = [t.clone() for t in x]
            outs = [ring_cuda.ring_allreduce_cuda(x), ring_cuda.ring_allreduce_cuda(apart),
                    torch.stack([ring.ring_psum(apart, only=d) for d in (0, S - 1)])]
            n_bad = sum(int((o != w).sum()) for o, w in zip(outs, (want, want, want[[0, -1]])))
            check(n_bad == 0, f"[9] ring kernel disagrees with plain at S={S} {dtype} n={n}")
        sh = si.put_sharded(si.shard_fm_index(fm, S), dev)
        if S <= 64:
            ins, (c, k) = fused_inputs(torch, sh, 2, 96, gen)
            check(torch.equal(ring_cuda.fused_rank_ring_cuda(*ins),
                              ring.fused_rank_ring_plain(*ins)),
                  f"[9] fused words entry wrong at S={S}")
        # 2 x 65,536 queries; past 64 shards 2 x 8,192 (the plain version's
        # (S, 2, Q, 8) words must fit the card)
        _, (c, k) = fused_inputs(torch, sh, 2, 65_536 if S <= 64 else 8_192, gen, gather=False)
        want = si.fused_occ_plain(sh, c, k)
        ap = own_allocations(sh)
        n_bad = sum(int((ring_cuda.fused_occ_cuda(t.bwt_blocks, t.occ_cp, sh.pk_start, sh.pk_end,
                                                  sh.primary, c, k) != want).sum())
                    for t in (sh, ap))
        n_bad += int((want != rank.occ_codes(fm_dev, c, k)).sum())
        check(n_bad == 0, f"[9] fused table entry wrong at S={S}")
        del sh, ap
    log(f"[9] past 16 shards, S = {list(WIDE_SHARD_COUNTS)}: the sum (int32 x 777 and 65,536, "
        f"float32 x 777; stacked, separate allocations, one output) and the table entry (2 x "
        f"65,536 queries, past S = 64 2 x 8,192; stacked and one allocation a shard; the "
        f"single-device occ) equal to plain, the words entry too up to S = 64; "
        f"{time.time() - t_wide:.1f} s")

    # the exact search's payloads: ring (2, B / microbatch) per shard,
    # fused M = microbatch payloads of Q = 2 B / M
    timing = {}
    S, n = SHARDS, BATCH // RING_MICROBATCH
    sh = shards[S]
    parts = torch.randint(-(1 << 20), 1 << 20, (S, 2, n), generator=gen, device=dev,
                          dtype=torch.int32)
    timing["ring"] = time_path_sum(torch, ring_cuda, ring, parts)
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

    ap = own_allocations(sh)

    def table_apart():  # every shard in its own allocation (the mapped layout's kernel)
        return ring_cuda.fused_occ_cuda(ap.bwt_blocks, ap.occ_cp, sh.pk_start, sh.pk_end,
                                        sh.primary, c, k)

    check(torch.equal(table_apart(), table()),
          "[9] the fused table entry on separate allocations differs from the stacked one")
    t = {}
    for name, fn in (("table", table), ("stage", old_stage), ("table2", table),
                     ("apart", table_apart)):
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
        if name == "ring":
            log(f"[9] ring at S={S}: the path's call (shard 0's row alone, as ring_merge asks) "
                f"{tm:.4f} ms; every shard's row {RING_ALL_ROWS_MS[S]:.4f} ms ({card})")
        log(f"[9] {name} at S={S}, payload {shape}: kernel {tm:.4f} ms, plain torch {p:.4f} ms, "
            f"parts.sum(0) {'%.4f ms' % lib if lib is not None else 'none'}, bound {b:.4f} ms "
            f"by {by} ({card})")
    log(f"[9] table entry {t['table']:.4f} / {t['table2']:.4f} ms; the stage it replaces "
        f"(local_occ_gather of both chunks + stack + the words entry) {t['stage']:.4f} ms; "
        f"every shard in its own allocation {t['apart']:.4f} ms ({card})")
    timing["stage"] = t["stage"]
    timing["apart"] = t["apart"]
    if PAST_OLD_LIMITS:  # the same payloads at WIDE_SHARDS shards
        Sw = WIDE_SHARDS
        wparts = torch.randint(-(1 << 20), 1 << 20, (Sw, 2, n), generator=gen, device=dev,
                               dtype=torch.int32)
        check(torch.equal(ring_cuda.ring_allreduce_cuda(wparts), ring.ring_psum_plain(wparts)),
              f"[9] the sum differs from plain at S={Sw}")
        timing["ring_wide"] = time_path_sum(torch, ring_cuda, ring, wparts)
        log(f"[9] ring at S={Sw}: the path's call (shard 0's row alone) "
            f"{timing['ring_wide'][0]:.4f} ms; every shard's row {RING_ALL_ROWS_MS[Sw]:.4f} ms "
            f"({card})")
        wsh = si.put_sharded(si.shard_fm_index(fm, Sw), dev)

        def wide_table():
            return ring_cuda.fused_occ_cuda(wsh.bwt_blocks, wsh.occ_cp, wsh.pk_start,
                                            wsh.pk_end, wsh.primary, c, k)

        check(torch.equal(wide_table(), si.fused_occ_plain(wsh, c, k)),
              f"[9] the fused table entry differs from plain at S={Sw}")
        timing["table_wide"] = (
            cuda_time_ms(wide_table, reps=200, hide_host=True),
            cuda_time_ms(lambda: si.fused_occ_plain(wsh, c, k), reps=10, hide_host=True),
            *bound(n_q * (4 + 4 + 32 + 4 + 4) + 8 * Sw,
                   n_q * (8 * RANK_OPS_PER_WORD + 4 * Sw + 6)), None)
        for name, shape in (("ring_wide", (Sw, 2, n)), ("table_wide", (Sw, M, Q))):
            tm, p, b, by, lib = timing[name]
            log(f"[9] {name} at S={Sw}, payload {shape}: kernel {tm:.4f} ms, plain torch "
                f"{p:.4f} ms, parts.sum(0) {'%.4f ms' % lib if lib is not None else 'none'}, "
                f"bound {b:.4f} ms by {by} ({card})")
        del wsh, wparts
    return max_err, timing


def sharded_search_reads(codes, layout):
    """[10]'s reads: BATCH error-free reads of L bases at seeded starts,
    laid out for ``layout`` -> (starts, reads, lengths)."""
    import numpy as np

    from genome_weaver_align_tpu_torch.parallel import mesh as pmesh

    starts = np.random.default_rng(41).integers(0, codes.size - L, size=BATCH)
    reads = codes[starts[:, None] + np.arange(L)[None, :]].astype(np.int32)
    r, ln, _ = pmesh.shard_reads(layout, reads, np.full(BATCH, L, np.int32))
    return starts, r, ln


def phase_sharded_search(torch, dev, codes, gi, card):
    """The interval-sharded exact search at full size, three merges."""
    import numpy as np

    from genome_weaver_align_tpu_torch.models import exact
    from genome_weaver_align_tpu_torch.ops import locate_cuda, rank, ring_cuda
    from genome_weaver_align_tpu_torch.parallel import mesh as pmesh
    from genome_weaver_align_tpu_torch.parallel import sharded_index as si

    t0 = time.time()
    layout = pmesh.make_layout(1, SHARDS, dev)
    sh = si.put_sharded(si.shard_fm_index(gi.fwd, SHARDS), dev)
    starts, r, ln = sharded_search_reads(codes, layout)
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
                    ring_cuda.fused_rank_ring_cuda, locate_cuda.locate_sharded_cuda)
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
            f"{launches[merge][1]}, fused words entry {launches[merge][2]}, sharded locate "
            f"{launches[merge][3]} ({card})")
        check(same, f"merge={merge} differs from the single-device search")
    # WIDE_SHARDS shards on the search's path
    t0 = time.time()
    wlay = pmesh.make_layout(1, WIDE_SHARDS, dev)
    wsh = si.put_sharded(si.shard_fm_index(gi.fwd, WIDE_SHARDS), dev)
    for merge, mb in (("psum", 1), ("ring", RING_MICROBATCH), ("fused", RING_MICROBATCH)):
        fn = si.make_sharded_exact_search(wlay, L, wsh, merge=merge, microbatch=mb)
        counters = (ring_cuda.ring_allreduce_cuda, ring_cuda.fused_occ_cuda,
                    locate_cuda.locate_sharded_cuda)
        for f in counters:
            f.launches = 0
        t1 = time.time()
        out = fn(wsh, r, ln)
        torch.cuda.synchronize()
        wide = tuple(f.launches for f in counters)
        same = all(torch.equal(a.cpu(), b) for a, b in zip(out, ref))
        log(f"[10] {WIDE_SHARDS} shards, merge={merge}: {time.time() - t1:.3f} s, equal to the "
            f"single-device search: {same}; launches: sum {wide[0]}, fused table entry "
            f"{wide[1]}, sharded locate {wide[2]} ({card})")
        check(same, f"{WIDE_SHARDS} shards, merge={merge}: differs from the single-device search")
        expect = {"psum": (0, 0, 1), "ring": (L * RING_MICROBATCH, 0, 1), "fused": (0, L, 1)}
        check(wide == expect[merge], f"{WIDE_SHARDS} shards, merge={merge} launched {wide}, "
              f"expected {expect[merge]}")
        launches[f"{WIDE_SHARDS} {merge}"] = wide
    del wsh
    log(f"[10] {WIDE_SHARDS} shards: {time.time() - t0:.1f} s")
    lo, hi, pos = ref
    n_found = int((hi > lo).sum())
    unique = (hi - lo == 1).numpy()
    n_placed = int((pos.numpy()[unique] == starts[unique]).sum())
    log(f"[10] {n_found} of {BATCH} reads found, {int(unique.sum())} unique, {n_placed} of "
        f"them at their true start")
    check(n_found == BATCH, "an error-free read was not found")
    check(n_placed == int(unique.sum()), "a unique read was placed off its true start")
    check(launches["ring"] == (L * RING_MICROBATCH, 0, 0, 1),
          f"merge=ring launched {launches['ring']}, expected ({L * RING_MICROBATCH}, 0, 0, 1)")
    check(launches["fused"] == (0, L, 0, 1),
          f"merge=fused launched {launches['fused']}, expected (0, {L}, 0, 1)")
    check(launches["psum"] == (0, 0, 0, 1), "merge=psum launched a ring kernel, or the sharded "
          "locate other than once")
    return launches["ring"][0], launches["fused"][1], {
        **{f"[10] merge={m}": launches[m][3] for m in ("psum", "ring", "fused")},
        **{f"[10] {WIDE_SHARDS} shards, merge={m}": launches[f"{WIDE_SHARDS} {m}"][2]
           for m in ("psum", "ring", "fused")}}, {
        f"[10] {WIDE_SHARDS} shards, merge={m}": launches[f"{WIDE_SHARDS} {m}"]
        for m in ("ring", "fused")}


def phase_sharded_cli(codes, card):
    """ShardedAligner through the CLI (--n-interval 4) against the
    single-device CLI on the same FASTQ, seed table and FM shards."""
    from genome_weaver_align_tpu_torch import cli
    from genome_weaver_align_tpu_torch.ops import dp_cuda, fm_search_cuda, locate_cuda

    fm_counters = {"locate": locate_cuda.locate_cuda,
                   "sharded locate": locate_cuda.locate_sharded_cuda,
                   "sharded piece search": fm_search_cuda.backward_search_sharded_cuda}
    idx, seedf, _ = build_index(cli, codes)
    sharded_launches, fm_launches = 0, {}
    work = CACHE / f"sharded{os.getpid()}"
    work.mkdir(parents=True)
    for name, n_reads, extra, seed, shards, batch in (
            ("seed-table", BATCH, ["--seed-table", str(seedf)], 51, SHARDS, BATCH),
            ("FM", SHARDED_FM_READS, [], 52, SHARDS, BATCH),
            (f"FM, {WIDE_SHARDS} shards", 2 * SHARDED_FM_READS, [], 52, WIDE_SHARDS,
             SHARDED_FM_READS),
            (f"seed-table, {WIDE_SHARDS} shards", 2 * SHARDED_FM_READS,
             ["--seed-table", str(seedf)], 53, WIDE_SHARDS, SHARDED_FM_READS)):
        fq = work / "reads.fq"
        write_reads(fq, codes, n_reads, seed=seed)
        bodies = {}
        for n_int in (shards, 1):
            sam, rep = work / f"out{n_int}.sam", work / f"report{n_int}.json"
            dp_cuda.banded_edit_distance_text_cuda.launches = 0
            dp_cuda.banded_edit_distance_cuda.launches = 0
            for c in fm_counters.values():
                c.launches = 0
            rc = cli.main(["align", str(idx), str(fq), "-k", str(K), *extra, "--n-interval",
                           str(n_int), "--batch-size", str(batch), "--report", str(rep),
                           "-o", str(sam)])
            # the sharded verify takes the windows entry (its windows are
            # sums of shard partials), the single-device one the text entry
            launches = (dp_cuda.banded_edit_distance_text_cuda.launches,
                        dp_cuda.banded_edit_distance_cuda.launches)
            fm_launches[name, n_int] = {key: c.launches for key, c in fm_counters.items()}
            check(rc == 0, f"{name} align --n-interval {n_int} exited {rc}")
            report = json.loads(rep.read_text())
            n, mapped, correct = score_sam(sam)
            with open(sam) as fh:
                bodies[n_int] = [line for line in fh if line[0] != "@"]
            log(f"[11] {name} align -k {K} --n-interval {n_int}: {n} reads, mapped "
                f"{mapped / n:.6f}, correct {correct / n:.6f}, {report['reads_per_s']} reads/s "
                f"over {report['wall_s']} s ({card}), banded-DP launches: text entry "
                f"{launches[0]}, windows entry {launches[1]}; FM launches "
                f"{fm_launches[name, n_int]}")
            check(n == n_reads, f"SAM holds {n} records")
            check(mapped / n >= MIN_MAPPED, f"mapped share {mapped / n:.4f} < {MIN_MAPPED}")
            check(correct / n >= MIN_CORRECT, f"correct share {correct / n:.4f} < {MIN_CORRECT}")
            entry = 1 if n_int > 1 else 0
            check(launches[entry] > 0, f"--n-interval {n_int} never launched the banded DP "
                  f"kernel's {('text', 'windows')[entry]} entry")
            if n_int > 1:
                sharded_launches += launches[1]
            if name.startswith("FM"):  # the FM path: its searches and locate are kernels
                want = ("sharded locate", "sharded piece search") if n_int > 1 else ("locate",)
                for key in want:
                    check(fm_launches[name, n_int][key] > 0,
                          f"FM --n-interval {n_int} never launched the {key} kernel")
        same = bodies[shards] == bodies[1]
        log(f"[11] {name}: the --n-interval {shards} SAM body is byte-identical to the "
            f"single-device one: {same}")
        check(same, f"{name}: the sharded SAM differs from the single-device SAM")
    shutil.rmtree(work)
    return sharded_launches, fm_launches


def phase_tier2(torch, dev, card):
    """The tier-2 staircase at scale, on the JAX package's repeat bench
    configuration: the repeat genome indexed by the CLI with its reverse
    text, k = 2, 8 hits a piece, 12 candidates, 4 verify lanes a read, the
    array loop over 6 x 32,768 reads; then the same reads on the index
    without its reverse text (no tier 2), and one tier-2 call profiled.
    -> the banded text entry's launches inside tier 2, and the repeat genome."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from genome_weaver_align_tpu_torch import cli
    from genome_weaver_align_tpu_torch.index.files import GenomeIndex, load_index
    from genome_weaver_align_tpu_torch.index.seedtable import load_seed_table
    from genome_weaver_align_tpu_torch.models.pipeline import SuffixFilterAligner, prefetch_result
    from genome_weaver_align_tpu_torch.ops import dp_cuda, locate_cuda, staircase_cuda
    from genome_weaver_align_tpu_torch.utils.simulate import repeat_genome, simulate_reads_array

    index_s = join_prebuild("[12]")["repeat_index_s"]
    t0 = time.time()
    codes = repeat_genome(GENOME_LEN, seed=REPEAT_SEED)
    gen_s = time.time() - t0
    idx, seedf, here_s = build_index(cli, codes, f"repeat_{GENOME_LEN}_seed{REPEAT_SEED}",
                                     "chr20rep")
    index_s = here_s if here_s is not None else index_s
    log(f"[12] repeat_genome({GENOME_LEN}, seed={REPEAT_SEED}) in {gen_s:.1f} s; index --seed "
        f"{SEED_J}: " + (f"{index_s:.1f} s ({card})" if index_s is not None
                         else f"cached in {idx.parent}"))
    gi = load_index(idx)
    check(gi.rev is not None, "the CLI index of the repeat genome has no reverse text")
    offsets, positions, sj = load_seed_table(seedf)
    kw = dict(k=K, max_hits_per_piece=8, max_cands=12, verify_slack=4,
              seed_table=(offsets, positions), seed_j=sj, device=dev)
    reads, _, _, _ = simulate_reads_array(codes, REPEAT_BATCH * REPEAT_BATCHES, L, seed=13,
                                          max_subs=2)
    reads = reads.astype(np.int8)
    lengths = np.full(REPEAT_BATCH, L, np.int32)

    def run(aligner):
        """The array loop (submit N+1, then finish N): per batch the
        ArrayHits' mapped and overflow columns and ``last_stats``."""
        out = []
        pending = None
        for b in range(REPEAT_BATCHES + 1):
            h = None
            if b < REPEAT_BATCHES:
                h = aligner.align_arrays_submit(reads[b * REPEAT_BATCH:(b + 1) * REPEAT_BATCH],
                                                lengths)
                prefetch_result(h)
            if pending is not None:
                ah = aligner.align_arrays_finish(pending)
                out.append((ah.mapped.copy(), ah.overflow.copy(), dict(aligner.last_stats)))
            pending = h
        return out

    no_rev = SuffixFilterAligner(GenomeIndex(gi.genome, gi.fwd, None), **kw)
    w0 = time.perf_counter()
    base = run(no_rev)
    base_s = time.perf_counter() - w0
    del no_rev
    al = SuffixFilterAligner(gi, **kw)
    fb2 = al._get_fb2()  # the reverse text goes up here, not inside the first batch
    submit2 = fb2.align_arrays_submit
    tier2 = {"launches": 0, "calls": 0, "staircase": 0, "locate": 0}

    def counted_submit(*a):
        n0 = dp_cuda.banded_edit_distance_text_cuda.launches
        s0 = staircase_cuda.staircase_pools_cuda.launches
        l0 = locate_cuda.locate_cuda.launches
        h = submit2(*a)
        tier2["launches"] += dp_cuda.banded_edit_distance_text_cuda.launches - n0
        tier2["staircase"] += staircase_cuda.staircase_pools_cuda.launches - s0
        tier2["locate"] += locate_cuda.locate_cuda.launches - l0
        tier2["calls"] += 1
        return h

    fb2.align_arrays_submit = counted_submit
    dp_cuda.banded_edit_distance_text_cuda.launches = 0
    staircase_cuda.staircase_pools_cuda.launches = 0
    locate_cuda.locate_cuda.launches = 0
    w0 = time.perf_counter()
    res = run(al)
    wall = time.perf_counter() - w0
    launches = dp_cuda.banded_edit_distance_text_cuda.launches
    fb2.align_arrays_submit = submit2
    total = REPEAT_BATCH * REPEAT_BATCHES
    for b, (mapped, ovf, st) in enumerate(res):
        log(f"[12] batch {b}: t_tier1_ms {st.get('t_tier1_ms')}, t_tier2_ms "
            f"{st.get('t_tier2_ms')}, tier-1 cohort {st.get('n_overflow_fallback', 0)}, tier-2 "
            f"cohort {st['n_staircase_fallback']}, mapped {int(mapped.sum())} ({card})")
    m_rev = np.concatenate([r[0] for r in res])
    m_base = np.concatenate([r[0] for r in base])
    n_tier2 = sum(r[2]["n_staircase_fallback"] for r in res)
    lost = int((m_base & ~m_rev).sum())
    log(f"[12] {total} reads, k={K}: mapped {m_rev.mean():.6f} with tier 2 against "
        f"{m_base.mean():.6f} on the index without its reverse text (+{int(m_rev.sum()) - int(m_base.sum())} "
        f"reads, {lost} lost); overflowed {np.concatenate([r[1] for r in res]).mean():.6f}; "
        f"{n_tier2} reads through tier 2 in {tier2['calls']} calls; banded text-entry launches "
        f"{launches} in the loop, {tier2['launches']} of them in tier 2; staircase launches "
        f"{staircase_cuda.staircase_pools_cuda.launches} in the loop, {tier2['staircase']} of "
        f"them in tier 2; locate launches {locate_cuda.locate_cuda.launches} in the loop, "
        f"{tier2['locate']} of them in tier 2; loop {wall:.3f} s "
        f"({total / wall:.1f} reads/s) against {base_s:.3f} s without tier 2 ({card})")
    check(m_rev.mean() >= MIN_REPEAT_MAPPED, f"mapped share {m_rev.mean():.4f} < {MIN_REPEAT_MAPPED}")
    check(n_tier2 > 0, "no read went through the tier-2 staircase")
    check(tier2["launches"] > 0, "tier 2 never launched the banded DP kernel's text entry")
    check(tier2["staircase"] > 0, "tier 2 never launched the staircase kernel")
    check(tier2["locate"] > 0, "tier 2 never launched the locate kernel")
    check(lost == 0 and m_rev.sum() >= m_base.sum(), "tier 2 unmapped reads (the merge must be "
          "improve-only)")

    # one tier-2 call on the largest batch cohort, as _apply_overflow_fallback
    # builds it: reads still overflowed and unmapped after tier 1, padded
    # to a power of two of at least 128
    b = max(range(REPEAT_BATCHES), key=lambda i: res[i][2]["n_staircase_fallback"])
    cohort = b * REPEAT_BATCH + np.nonzero(base[b][1] & ~base[b][0])[0]
    P2 = max(128, 1 << (int(cohort.size) - 1).bit_length())
    sel = np.concatenate([cohort, np.full(P2 - cohort.size, cohort[0], cohort.dtype)])
    c_reads, c_lens = reads[sel], np.full(P2, L, np.int32)

    def call():
        return fb2.align_arrays_finish(fb2.align_arrays_submit(c_reads, c_lens))

    call()
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    steps = -(-L // (K + 1)) + -(-(L * K) // (K + 1))  # spine + forward
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t0
    n_ev, busy_s, top = device_busy(torch, prof)
    log(f"[12] one tier-2 call, cohort {cohort.size} padded to {P2} (2 x {P2} stacked strand "
        f"lanes): wall {min(times) * 1e3:.3f} ms (best of 3: "
        f"{', '.join(f'{t * 1e3:.3f}' for t in times)}), {steps} sequential staircase steps, "
        f"{min(times) * 1e3 / steps:.4f} ms a step ({card})")
    if n_ev:
        log(f"[12] under torch.profiler: {n_ev} device events (kernels and copies), "
            f"{n_ev / steps:.1f} a step; device busy {busy_s * 1e3:.3f} ms of {pwall * 1e3:.3f} ms, "
            f"share {busy_s / pwall:.4f} ({card})")
        for name, ms, share in top:
            log(f"[12]   {share:7.2%} of device time {ms:8.3f} ms  {name[:100]}")
    else:
        log("[12] device busy share: not measured (torch.profiler recorded no device events)")
    check(0 < n_ev <= TIER2_EVENTS_PR8 // 10,
          f"one tier-2 call ran {n_ev} device events: not 10x fewer than the eager "
          f"staircase's {TIER2_EVENTS_PR8}")
    del al, fb2, gi
    torch.cuda.empty_cache()
    return tier2, codes


def phase_modes(codes, card) -> dict:
    """The search modes through the CLI on the phase-4 index (it holds its
    reverse text): ``-k 0`` (exact) on error-free reads, ``--mode onemm``
    on reads with <= 1 substitution, ``--mode staircase -k 2`` on the first
    reads of phase 4's set.  -> {mode: {kernel: launches}} for the banded
    text entry, the three FM search kernels and the locate."""
    from genome_weaver_align_tpu_torch import cli
    from genome_weaver_align_tpu_torch.ops import (
        dp_cuda, fm_search_cuda, locate_cuda, one_mismatch_cuda, staircase_cuda,
    )

    counters = {"banded": dp_cuda.banded_edit_distance_text_cuda,
                "backward": fm_search_cuda.backward_search_cuda,
                "staircase": staircase_cuda.staircase_pools_cuda,
                "one-mismatch": one_mismatch_cuda.one_mismatch_candidates_cuda,
                "locate": locate_cuda.locate_cuda}

    idx, _, _ = build_index(cli, codes)
    work = CACHE / f"modes{os.getpid()}"
    work.mkdir(parents=True)
    launches = {}
    for name, extra, n_reads, reads_kw in (
        ("-k 0", ["-k", "0"], EXACT_READS, dict(seed=61, max_subs=0)),
        ("--mode onemm", ["--mode", "onemm"], MODE_READS, dict(seed=62, max_subs=1)),
        ("--mode staircase -k 2", ["--mode", "staircase", "-k", str(K)], MODE_READS,
         dict(seed=11, of=BATCH * N_BATCHES)),
    ):
        fq, sam, rep = work / "reads.fq", work / "out.sam", work / "report.json"
        write_reads(fq, codes, n_reads, **reads_kw)
        for c in counters.values():
            c.launches = 0
        rc = cli.main(["align", str(idx), str(fq), *extra, "--batch-size", str(n_reads),
                       "--report", str(rep), "-o", str(sam)])
        launches[name] = {key: c.launches for key, c in counters.items()}
        check(rc == 0, f"align {name} exited {rc}")
        report = json.loads(rep.read_text())
        n, mapped, correct = score_sam(sam)
        log(f"[13] align {name}: {n} reads, mode {report['mode']}, mapped {mapped / n:.6f}, "
            f"correct {correct / n:.6f}, {report['reads_per_s']} reads/s over {report['wall_s']} s "
            f"({card}), launches {launches[name]}")
        check(n == n_reads, f"SAM holds {n} records")
        check(mapped / n >= MIN_MAPPED, f"{name}: mapped share {mapped / n:.4f} < {MIN_MAPPED}")
        check(correct / n >= MIN_CORRECT, f"{name}: correct share {correct / n:.4f} < {MIN_CORRECT}")
    check(launches["--mode staircase -k 2"]["banded"] > 0,
          "--mode staircase never launched the banded DP kernel's text entry")
    check(launches["--mode staircase -k 2"]["staircase"] > 0,
          "--mode staircase never launched the staircase kernel")
    check(launches["-k 0"]["backward"] > 0, "-k 0 never launched the backward-search kernel")
    check(launches["--mode onemm"]["one-mismatch"] > 0,
          "--mode onemm never launched the one-mismatch kernel")
    for name in launches:
        check(launches[name]["locate"] > 0, f"align {name} never launched the locate kernel")
    shutil.rmtree(work)

    # where --mode onemm's time goes now that its search is one launch a
    # strand: OneMismatchAligner.align_batch on the same reads, its two
    # strands' device work timed apart from the whole call
    import torch

    from genome_weaver_align_tpu_torch.index.files import load_index
    from genome_weaver_align_tpu_torch.models.one_mismatch import OneMismatchAligner
    from genome_weaver_align_tpu_torch.utils.fasta import Read
    from genome_weaver_align_tpu_torch.utils.simulate import simulate_reads_array

    mm_reads, _, _, _ = simulate_reads_array(codes, MODE_READS, L, seed=62, max_subs=1)
    reads = [Read(f"r{i}", r) for i, r in enumerate(mm_reads)]
    al = OneMismatchAligner(load_index(idx), device="cuda")
    al.align_batch(reads[:256])
    strand_s = []
    inner = al._strand

    def timed_strand(*a):  # ends in a download, so the device work is done
        t0 = time.perf_counter()
        out = inner(*a)
        strand_s.append(time.perf_counter() - t0)
        return out

    al._strand = timed_strand
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hits = al.align_batch(reads)
    total_s = time.perf_counter() - t0
    search_s = sum(strand_s)
    log(f"[13] --mode onemm's OneMismatchAligner.align_batch on the same {MODE_READS} reads: "
        f"{total_s:.3f} s, of which the two strands' searches (upload, one kernel launch, locate, "
        f"best, one download each) {search_s:.3f} s and the host (batch build, the per-read loop "
        f"with one text extract a read) {total_s - search_s:.3f} s; "
        f"{sum(h is not None for h in hits)} mapped ({card})")
    return launches


def long_reads(codes):
    """The JAX package's long-read bench reads: LONG_B x LONG_BATCHES reads
    of LONG_L bases (seed LONG_SEED), 8 scattered one-base indels and
    L // 200 substitutions a read, both strands.  -> (reads (N, L) int8,
    true start (N,), strand (N,))."""
    import numpy as np

    rng = np.random.default_rng(LONG_SEED)
    N, Lr = LONG_B * LONG_BATCHES, LONG_L
    pos = rng.integers(0, codes.size - Lr - 64, size=N)
    reads = np.zeros((N, Lr), dtype=np.uint8)
    for i in range(N):
        seq = codes[pos[i] : pos[i] + Lr + 32].tolist()
        for _ in range(8):
            at = int(rng.integers(64, Lr - 64))
            if rng.random() < 0.5:
                seq.insert(at, int(rng.integers(0, 4)))
            else:
                del seq[at]
        row = np.array(seq[:Lr], dtype=np.uint8)
        subs = rng.integers(0, Lr, size=max(1, Lr // 200))
        row[subs] = (row[subs] + rng.integers(1, 4, size=subs.size)) % 4
        reads[i] = row
    strand = rng.integers(0, 2, size=N)
    reads = np.where(strand[:, None] == 1, (3 - reads)[:, ::-1], reads).astype(np.int8)
    return reads, pos, strand


def phase_long_reads(torch, dev, codes, card) -> tuple[int, int]:
    """Long reads on the phase-4 index and seed table, as the JAX package's
    long-read bench runs them: the default LongReadAligner on LONG_BATCHES
    batches of LONG_B reads, without and then with traceback; the same
    reads at kb = WIDE_LONG_KB without traceback (the banded group kernel);
    then ``align --mode long`` through the CLI on the same reads.  -> the
    banded text entry's launches in the kb = 16 loop and in the kb =
    WIDE_LONG_KB loop."""
    import numpy as np

    from genome_weaver_align_tpu_torch import cli
    from genome_weaver_align_tpu_torch.index.files import load_index
    from genome_weaver_align_tpu_torch.index.seedtable import load_seed_table
    from genome_weaver_align_tpu_torch.models.long_read import LongReadAligner
    from genome_weaver_align_tpu_torch.ops import dp_cuda

    idx, seedf, _ = build_index(cli, codes)
    gi = load_index(idx)
    offsets, positions, sj = load_seed_table(seedf)
    al = LongReadAligner(gi, (offsets, positions), sj, device=dev)
    check((al.seg_len, al.kb, al.band) == (LONG_SEG, LONG_KB, LONG_BAND),
          "LongReadAligner's defaults changed")
    t0 = time.time()
    reads, pos, strand = long_reads(codes)
    log(f"[14] {reads.shape[0]} reads of {LONG_L} bases (8 indels, {LONG_L // 200} "
        f"substitutions each) in {time.time() - t0:.1f} s")
    lens = np.full(LONG_B, LONG_L, np.int32)
    al.align_arrays(reads[:LONG_B], lens, traceback=False)  # warm-up
    torch.cuda.synchronize()
    rates, n_mapped, n_close, n_exact = {}, 0, 0, 0
    dp_cuda.banded_edit_distance_text_cuda.launches = 0
    for traceback in (False, True):
        times = []
        for b in range(LONG_BATCHES):
            sl = slice(b * LONG_B, (b + 1) * LONG_B)
            t0 = time.perf_counter()
            lh = al.align_arrays(reads[sl], lens, traceback=traceback)
            times.append(time.perf_counter() - t0)
            ok = lh.mapped & (lh.strand == strand[sl])
            if traceback:
                n_exact += int((ok & (np.abs(lh.pos - pos[sl]) <= 4)).sum())
            else:
                n_mapped += int(lh.mapped.sum())
                n_close += int((ok & (np.abs(lh.pos - pos[sl]) <= al.band + al.kb)).sum())
        rates[traceback] = (LONG_B * LONG_BATCHES / sum(times), times)
    launches = dp_cuda.banded_edit_distance_text_cuda.launches
    N = reads.shape[0]
    log(f"[14] LongReadAligner, {LONG_BATCHES} x {LONG_B} reads of {LONG_L}: map "
        f"{rates[False][0]:.1f} reads/s without traceback (batches "
        f"{', '.join(f'{t:.3f}' for t in rates[False][1])} s), {rates[True][0]:.1f} reads/s with "
        f"traceback (batches {', '.join(f'{t:.3f}' for t in rates[True][1])} s); mapped "
        f"{n_mapped / N:.6f}, locus-correct {n_close / N:.6f}, exact position after traceback "
        f"{n_exact / N:.6f}; banded text-entry launches at kb={al.kb}: {launches} ({card})")
    check(n_mapped / N >= MIN_MAPPED, f"long reads: mapped share {n_mapped / N:.4f} < {MIN_MAPPED}")
    check(n_close / N >= MIN_CORRECT, f"long reads: locus-correct {n_close / N:.4f} < {MIN_CORRECT}")
    check(n_exact / N >= MIN_EXACT_POS, f"long reads: exact position {n_exact / N:.4f} < "
          f"{MIN_EXACT_POS}")
    check(launches > 0, "the long-read loop never launched the banded DP kernel's text entry")
    del al

    # a segment band past the one-thread kernel's 16: a group of threads a lane
    t_wall = time.time()
    al = LongReadAligner(gi, (offsets, positions), sj, kb=WIDE_LONG_KB, device=dev)
    al.align_arrays(reads[:LONG_B], lens, traceback=False)  # warm-up
    torch.cuda.synchronize()
    dp_cuda.banded_edit_distance_text_cuda.launches = 0
    dp_cuda.banded_edit_distance_text_cuda.by_design = dict.fromkeys(dp_cuda.DESIGNS, 0)
    times, n_mapped, n_close = [], 0, 0
    for b in range(LONG_BATCHES):
        sl = slice(b * LONG_B, (b + 1) * LONG_B)
        t0 = time.perf_counter()
        lh = al.align_arrays(reads[sl], lens, traceback=False)
        times.append(time.perf_counter() - t0)
        n_mapped += int(lh.mapped.sum())
        ok = lh.mapped & (lh.strand == strand[sl])
        n_close += int((ok & (np.abs(lh.pos - pos[sl]) <= al.band + al.kb)).sum())
    wide = {"launches": dp_cuda.banded_edit_distance_text_cuda.launches,
            "by_design": dict(dp_cuda.banded_edit_distance_text_cuda.by_design)}
    WIDE_WALL_S["[14]"] = time.time() - t_wall
    log(f"[14] LongReadAligner(kb={al.kb}), {LONG_BATCHES} x {LONG_B} reads of {LONG_L}: "
        f"{LONG_B * LONG_BATCHES / sum(times):.1f} reads/s without traceback (batches "
        f"{', '.join(f'{t:.3f}' for t in times)} s); mapped {n_mapped / N:.6f}, locus-correct "
        f"{n_close / N:.6f}; banded text-entry launches {wide['launches']} "
        f"({wide['by_design']}); {WIDE_WALL_S['[14]']:.1f} s of wall ({card})")
    check(n_mapped / N >= MIN_MAPPED, f"long reads at kb={al.kb}: mapped {n_mapped / N:.4f}")
    check(n_close / N >= MIN_CORRECT, f"long reads at kb={al.kb}: locus-correct {n_close / N:.4f}")
    check(wide["launches"] > 0 and wide["by_design"]["group"] == wide["launches"],
          f"the kb={al.kb} loop did not run the banded text entry's group kernel")
    del al

    work = CACHE / f"long{os.getpid()}"
    work.mkdir(parents=True)
    fq, sam, rep = work / "long.fq", work / "long.sam", work / "report.json"
    seqs = np.frombuffer(b"ACGT", np.uint8)[reads].tobytes()
    with open(fq, "w") as fh:
        fh.write("".join(f"@l{i}_p{p}_s{st}\n{seqs[i * LONG_L:(i + 1) * LONG_L].decode()}\n+\n"
                         f"{'I' * LONG_L}\n" for i, (p, st) in enumerate(zip(pos, strand))))
    dp_cuda.banded_edit_distance_text_cuda.launches = 0
    rc = cli.main(["align", str(idx), str(fq), "--mode", "long", "--seed-table", str(seedf),
                   "--batch-size", str(LONG_B), "--report", str(rep), "-o", str(sam)])
    cli_launches = dp_cuda.banded_edit_distance_text_cuda.launches
    check(rc == 0, f"align --mode long exited {rc}")
    n = n_map = n_tag = 0
    with open(sam) as fh:
        for line in fh:
            if line[0] == "@":
                continue
            n += 1
            f = line.rstrip("\n").split("\t")
            if not int(f[1]) & 4:
                n_map += 1
                n_tag += "XT:A:L" in f[11:]
    report = json.loads(rep.read_text())
    log(f"[14] align --mode long: {n} reads, mapped {n_map / n:.6f}, {n_tag} of {n_map} mapped "
        f"records carry XT:A:L, {report['reads_per_s']} reads/s over {report['wall_s']} s, "
        f"banded text-entry launches {cli_launches} ({card})")
    check(n == N, f"the long-read SAM holds {n} records")
    check(n_map / n >= MIN_MAPPED, f"align --mode long: mapped share {n_map / n:.4f}")
    check(n_tag == n_map, "a mapped long-read record lacks XT:A:L")
    shutil.rmtree(work)
    return launches, wide["launches"]


def phase_multipart(torch, dev, codes, rep_codes, card) -> dict:
    """Multi-part streaming with the JAX package's gbp bench traffic
    (batches of 8,192 reads of 150 bp, 8 batches, k = 2, <= 2
    substitutions, both strands) on the chr20-scale genome cut into two
    contigs, then on the phase-12 repeat genome cut the same way, each
    indexed by the port into two parts with their reversed texts in the
    flat layout (cached in smoke_cache/).  -> the banded text entry's
    launches in each part's stream and in the rescue, for each genome."""
    import numpy as np

    from genome_weaver_align_tpu_torch.index import multipart_io
    from genome_weaver_align_tpu_torch.ops import dp_cuda, locate_cuda, staircase_cuda
    from genome_weaver_align_tpu_torch.utils.simulate import simulate_reads_array

    prebuilt = join_prebuild("[15]").get("parts_s", {})

    def parts_of(g, name):
        """``g`` cut into two contigs and built into two flat parts (by the
        prebuild, or here)."""
        part_dir, secs = build_parts(g, name)
        secs = secs if secs is not None else prebuilt.get(name)
        mi = multipart_io.load_multi_index(part_dir)
        log(f"[15] {name}: " + (f"built {mi.n_parts} parts with their reversed-text indexes "
                                f"and the flat layout in {secs:.1f} s ({card})" if secs is not None
                                else f"{mi.n_parts} parts cached in {part_dir}"))
        check(mi.n_parts == 2 and multipart_io.has_flat(part_dir, 2), "expected 2 flat parts")
        return mi

    def traffic(g):
        """The bench's reads, none across the contig boundary (such a read
        has no locus in either part: it moves one read length left)."""
        mid = g.size // 2
        reads, pos, strand, _ = simulate_reads_array(g, GBP_BATCH * GBP_BATCHES, GBP_L,
                                                     seed=GBP_SEED, max_subs=2)
        cross = (pos < mid) & (pos + GBP_L > mid)
        pos = np.where(cross, pos - GBP_L, pos)
        for i in np.nonzero(cross)[0]:
            fwd = g[pos[i]:pos[i] + GBP_L]
            reads[i] = (3 - fwd)[::-1] if strand[i] else fwd
        return reads.astype(np.int8), pos, strand

    def stream(mi, reads, tag):
        """``align_stream_multipart`` with the launch count set to 0 just
        before and read just after; -> its outputs, stats and the banded
        text entry's launches in each part's stream and in the rescue."""
        counts = {}
        stair = {"A/plain": 0, "B/narrow": 0, "mark": 0}
        loc = {"parts": 0}

        def smoke_log(msg):
            if msg.startswith("part ") and ("flat load" in msg or ": streamed" in msg):
                counts[msg.split(":")[0] + (" start" if "flat load" in msg else " end")] = (
                    dp_cuda.banded_edit_distance_text_cuda.launches)
                stair["mark"] = staircase_cuda.staircase_pools_cuda.launches
                loc["parts"] = locate_cuda.locate_cuda.launches
            if msg.startswith("rescue tier "):  # one part of one rescue tier is done
                n = staircase_cuda.staircase_pools_cuda.launches
                stair[msg.split()[2]] += n - stair["mark"]
                stair["mark"] = n
            if not msg.startswith("part ") or "batch" not in msg:
                log(f"[15] {tag}: {msg}")

        stats = {}
        dp_cuda.banded_edit_distance_text_cuda.launches = 0
        staircase_cuda.staircase_pools_cuda.launches = 0
        locate_cuda.locate_cuda.launches = 0
        out = multipart_io.align_stream_multipart(
            mi, reads, np.full(GBP_BATCH, GBP_L, np.int32), GBP_BATCH, k=K, log=smoke_log,
            stats=stats, device=dev)
        total = dp_cuda.banded_edit_distance_text_cuda.launches
        per_part = [counts[f"part {p} end"] - counts[f"part {p} start"] for p in range(2)]
        stats["staircase_launches"] = {t: stair[t] for t in ("A/plain", "B/narrow")}
        # the parts' streams (up to the last part's end), then the rescue
        stats["locate_launches"] = {"parts": loc["parts"],
                                    "rescue": locate_cuda.locate_cuda.launches - loc["parts"]}
        return out, stats, per_part, total - counts["part 1 end"]

    def report(tag, out, stats, per_part, rescue, pos, strand):
        _, gpos, st, mapped, align_s, load_s = out
        correct = mapped & (np.abs(gpos - pos) <= K) & (st == strand)
        log(f"[15] {tag}: align_stream_multipart, {GBP_BATCHES} x {GBP_BATCH} reads of {GBP_L}, "
            f"k={K}: mapped {mapped.mean():.6f}, correct {correct.mean():.6f}; align_s "
            f"{align_s:.3f}, load_s {load_s:.3f}, {mapped.size / align_s:.1f} reads/s from "
            f"align_s; peak device memory by part {stats['peak_mem_bytes']} B, rescue "
            f"{stats.get('rescue_peak_mem_bytes')} B; banded text-entry launches by part "
            f"{per_part}, rescue {rescue}; staircase launches by rescue tier "
            f"{stats['staircase_launches']}; locate launches {stats['locate_launches']}; rescue "
            f"cohort {stats['un_before_rescue']} reads, "
            f"{stats['rescued']} improved; tier-1 reruns {stats['n_overflow_rerun']}; batch ms "
            f"{stats['batch_ms']} ({card})")
        return mapped, correct

    mi = parts_of(codes, f"{GENOME_LEN}_seed{GENOME_SEED}")
    reads, pos, strand = traffic(codes)
    out, stats, per_part, rescue = stream(mi, reads, "random")
    mapped, correct = report("random", out, stats, per_part, rescue, pos, strand)
    check(mapped.mean() >= MIN_MAPPED, f"multi-part: mapped share {mapped.mean():.4f}")
    check(correct.mean() >= MIN_CORRECT, f"multi-part: correct share {correct.mean():.4f}")
    check(all(n > 0 for n in per_part), "a part's stream never launched the banded DP kernel")
    del mi, reads, out

    # the repeat genome: reads whose every seed bucket a repeat family
    # floods stay unmapped through the deferred tier 1 and reach the
    # two-tier staircase rescue over every part's reversed text
    rmi = parts_of(rep_codes, f"repeat_{GENOME_LEN}_seed{REPEAT_SEED}")
    reads, pos, strand = traffic(rep_codes)
    out, rstats, rper_part, rrescue = stream(rmi, reads, "repeat")
    rmapped, _ = report("repeat", out, rstats, rper_part, rrescue, pos, strand)
    # the rescue only improves a read's best, so every read unmapped at the
    # end was in its cohort and the rest of the cohort is what it mapped
    cohort = rstats["un_before_rescue"]
    placed = cohort - int((~rmapped).sum())
    log(f"[15] repeat: the rescue mapped {placed} of its cohort of {cohort} reads "
        f"({placed / max(cohort, 1):.6f})")
    check(rmapped.mean() >= MIN_REPEAT_MAPPED,
          f"multi-part, repeat genome: mapped share {rmapped.mean():.4f} < {MIN_REPEAT_MAPPED}")
    check(all(n > 0 for n in rper_part), "a part's stream never launched the banded DP kernel")
    check(cohort > 0, "no read of the repeat genome reached the multi-part rescue")
    check(placed / cohort >= MIN_REPEAT_MAPPED,
          f"the multi-part rescue mapped {placed / cohort:.4f} of its cohort < {MIN_REPEAT_MAPPED}")
    check(rrescue > 0, "the multi-part rescue never launched the banded DP kernel")
    check(rstats["staircase_launches"]["A/plain"] > 0,
          "the multi-part rescue's tier A never launched the staircase kernel")
    tier_b = (rmapped.size - int(rmapped.sum())) > 0 or rstats["staircase_launches"]["B/narrow"]
    check(not tier_b or rstats["staircase_launches"]["B/narrow"] > 0,
          "the multi-part rescue's tier B ran and never launched the staircase kernel")
    check(rstats["locate_launches"]["rescue"] > 0,
          "the multi-part rescue never launched the locate kernel")
    return {"by_part": per_part, "rescue": rescue, "repeat_by_part": rper_part,
            "repeat_rescue": rrescue, "staircase": stats["staircase_launches"],
            "repeat_staircase": rstats["staircase_launches"],
            "locate": stats["locate_launches"], "repeat_locate": rstats["locate_launches"]}


def run_ranks(mode: str, n: int, idx: Path, seedf: Path, reads: Path, sam: Path,
              tag: str = "[16]", extra=(), env_of=None) -> list[dict]:
    """``n`` processes of this script (``--rank``, then ``extra``), one gloo
    group on a free loopback port, rank r on card r % device_count (its
    ``LOCAL_RANK`` where ``env_of(r)``, variables added to rank r's
    environment, sets one); every one must exit 0 within RANK_TIMEOUT_S.
    -> each rank's result line, in rank order."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--rank", mode, str(r), str(n), port,
         str(idx), str(seedf), str(reads), str(sam), *extra],
        env={**env, **(env_of(r) if env_of else {})}, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(n)]
    results = []
    try:
        for r, p in enumerate(procs):
            try:
                text, _ = p.communicate(timeout=RANK_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                raise SmokeFailure(f"{tag} {mode}: rank {r} of {n} ran past {RANK_TIMEOUT_S} s")
            check(p.returncode == 0, f"{tag} {mode}: rank {r} of {n} exited {p.returncode}: "
                  f"{text[-3000:]}")
            lines = [ln for ln in text.splitlines() if ln.startswith("RANK_RESULT ")]
            check(len(lines) == 1, f"{tag} {mode}: rank {r} of {n} printed no result: "
                  f"{text[-3000:]}")
            results.append(json.loads(lines[0].split(" ", 1)[1]))
    finally:
        for p in procs:
            p.kill()
            p.wait()
    return results


def check_dp_entry(torch, aligner, batch, text: bool = False) -> dict:
    """Align ``batch`` once (also the warm-up) with every call of one entry
    of the banded DP held against its plain version on the same tensors, at
    this rank's shapes: the windows entry (the verify over mapped or
    stacked shards) or, with ``text``, the text entry (the collective
    route's verify of the rank's share of the candidates).  -> lanes, read
    and window widths of each call, and the mismatches of dist and end_b."""
    import inspect

    from genome_weaver_align_tpu_torch.ops import dp

    name = "banded_edit_distance_text" if text else "banded_edit_distance_best"
    real = getattr(dp, name)  # the entry on a CUDA tensor
    plain = dp.banded_edit_distance_text_plain if text else dp.banded_edit_distance
    sig = inspect.signature(real)
    res = {"lanes": [], "L": [], "W": [], "bad_dist": 0, "bad_end": 0, "max_abs_err": 0}

    def held(*a, **kw):
        arg = sig.bind(*a, **kw).arguments
        reads = arg["reads"]
        check(reads.is_cuda, "the sharded verify's reads are not on the card")
        d, e = real(*a, **kw)
        d_plain, e_plain = plain(*a, **kw)
        res["lanes"].append(int(d.shape[0]))
        res["L"].append(reads.shape[1])
        res["W"].append(arg["W"] if text else arg["windows"].shape[1])
        res["bad_dist"] += int((d != d_plain).sum())
        res["bad_end"] += int((e != e_plain).sum())
        if d.numel():
            res["max_abs_err"] = max(res["max_abs_err"], int((d - d_plain).abs().max()))
        return d, e

    with mock.patch.object(dp, name, held):
        aligner.align_batch(batch)
    return res


def check_dp_results(who: str, checks: dict, entry: str) -> int:
    """Log and check one rank's ``check_dp_entry`` results, keyed by run:
    every call's dist and end_b equal to the plain DP's.  -> the largest
    |dist err|."""
    for tag, c in checks.items():
        log(f"{who}, {tag}: the {entry} against the plain DP on one batch's calls, lanes "
            f"{c['lanes']}, L {c['L']}, W {c['W']}, k={K}: dist mismatches {c['bad_dist']}, "
            f"end_b mismatches {c['bad_end']}, max |dist err| {c['max_abs_err']}")
        check(c["lanes"] and c["bad_dist"] == 0 and c["bad_end"] == 0,
              f"{who}, {tag}: the {entry} disagrees with the plain DP")
    return max((c["max_abs_err"] for c in checks.values()), default=0)


def rank_child(argv: list[str]) -> int:
    """One rank of phase 16, 20, 21 or 22 (``chip_smoke.py --rank MODE RANK
    N PORT INDEX SEEDS READS SAM [SHARDS]``; mode ``interval``:
    ``interval_child``): joins the gloo group, runs its slice of every
    batch on the card ``multihost.device`` gave it (``cuda:RANK %
    device_count``), and prints one ``RANK_RESULT`` JSON
    line: wall seconds of the main path, its windows-entry, locate and
    sharded search launches (set to 0 just before it and read just after),
    the seconds each
    ``gather_to_host`` waited at a barrier for the other ranks and the
    seconds the gather itself took, and the peak device memory.  In sharded
    mode, before the timed run, every windows-entry call of one batch is
    held against the plain DP on the same tensors.  Rank 0 writes the
    SAM."""
    mode, rank, n, port, idx, seedf, reads_path, sam_path, *extra = argv
    rank, n = int(rank), int(n)
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    from genome_weaver_align_tpu_torch.index.files import load_index
    from genome_weaver_align_tpu_torch.ops import dp_cuda, fm_search_cuda, locate_cuda
    from genome_weaver_align_tpu_torch.parallel import multihost as mh
    from genome_weaver_align_tpu_torch.utils import sam

    fm_counters = {"locate": locate_cuda.locate_cuda,
                   "sharded locate": locate_cuda.locate_sharded_cuda,
                   "sharded piece search": fm_search_cuda.backward_search_sharded_cuda}

    # the ranks share the host's cores: torch's intra-op pools would
    # oversubscribe them
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    mh.initialize_distributed(f"127.0.0.1:{port}", n, rank)
    check(mh.process_count() == n and mh.process_index() == rank, "the process group is wrong")
    dev = mh.device()  # card rank % device_count
    check(dev == torch.device("cuda", rank % torch.cuda.device_count()),
          f"rank {rank} took {dev}")
    torch.cuda.set_device(dev)
    gi = load_index(idx)
    if mode == "interval":
        return interval_child(torch, rank, n, dev, gi, seedf, reads_path, sam_path,
                              int(extra[0]) if extra else SHARDS)
    z = np.load(reads_path)
    reads, pos, strand = z["reads"], z["pos"], z["strand"]
    names = [f"r{i}_p{p}_s{s}" for i, (p, s) in enumerate(zip(pos.tolist(), strand.tolist()))]
    gather = {"s": 0.0, "wait_s": 0.0, "calls": 0}
    real_gather = mh.gather_to_host

    def timed_gather(tensors, span=1):
        # the gather, not the step before it nor the wait for the slower rank
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        if n > 1:
            torch.distributed.barrier()
        t1 = time.perf_counter()
        out = real_gather(tensors, span)
        gather["wait_s"] += t1 - t0
        gather["s"] += time.perf_counter() - t1
        gather["calls"] += 1
        return out

    mh.gather_to_host = timed_gather
    dp_check = None
    if mode == "sharded":
        from genome_weaver_align_tpu_torch.index.seedtable import load_seed_table
        from genome_weaver_align_tpu_torch.parallel.sharded_pipeline import ShardedAligner
        from genome_weaver_align_tpu_torch.utils.fasta import Read

        so, sp, j = load_seed_table(seedf)
        al = ShardedAligner(gi, k=K, n_interval=SHARDS, seed_table=(so, sp), seed_j=j, device=dev)
        del so, sp
        batches = [[Read(names[i], reads[i]) for i in range(b * RANK_BATCH, (b + 1) * RANK_BATCH)]
                   for b in range(reads.shape[0] // RANK_BATCH)]
        dp_check = check_dp_entry(torch, al, batches[0])
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        gather.update(s=0.0, wait_s=0.0, calls=0)
        dp_cuda.banded_edit_distance_cuda.launches = 0
        for c in fm_counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        recs = []
        for batch in batches:
            recs.extend(al.to_sam(batch, al.align_batch(batch)))
        wall = time.perf_counter() - t0
        launches = dp_cuda.banded_edit_distance_cuda.launches
        fm_launches = {key: c.launches for key, c in fm_counters.items()}
        hdr = al.sam_header()
        al.close()  # the mapped shards released in every rank before any frees its own
    else:
        from genome_weaver_align_tpu_torch.models import exact
        from genome_weaver_align_tpu_torch.ops import rank as rank_ops
        from genome_weaver_align_tpu_torch.parallel import mesh as pmesh

        fm = rank_ops.from_host(gi.fwd, dev)
        B, L_ = reads.shape
        layout = pmesh.make_layout(n, 1, dev)
        reads32, lengths = reads.astype(np.int32), np.full(B, L_, np.int32)
        mh.exact_align(fm, layout, reads32[:1024 * n], lengths[:1024 * n], max_len=L_)
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        gather.update(s=0.0, wait_s=0.0, calls=0)
        dp_cuda.banded_edit_distance_cuda.launches = 0
        for c in fm_counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        gpos, gstr = mh.exact_align(fm, layout, reads32, lengths, max_len=L_)
        wall = time.perf_counter() - t0
        launches = dp_cuda.banded_edit_distance_cuda.launches
        fm_launches = {key: c.launches for key, c in fm_counters.items()}
        recs = exact.sam_records(gi.genome, names, reads, gpos, gstr) if rank == 0 else []
        hdr = sam.header(gi.genome.names, gi.genome.lengths)
    if rank == 0:
        sam.write_sam(sam_path, hdr, recs)
    result = {"rank": rank, "ranks": n, "mode": mode, "reads": int(reads.shape[0]), "wall_s": wall,
              "windows_launches": launches, "fm_launches": fm_launches, "gather_s": gather["s"],
              "gather_wait_s": gather["wait_s"], "gather_calls": gather["calls"],
              "peak_mem_bytes": torch.cuda.max_memory_allocated(dev), "dp_check": dp_check}
    if n > 1:
        torch.distributed.destroy_process_group()
    print("RANK_RESULT " + json.dumps(result), flush=True)
    return 0


def phase_ranks(torch, codes, card) -> dict:
    """Several processes, rank r on card r % device_count:
    ``ShardedAligner`` (k = 2, 4 interval shards, the phase-4 index and
    seed table) on 4 x 32,768 reads of 150
    bp with at most one substitution and, in 15% of them, one indel, then
    the exact search on 65,536 error-free 36 bp reads; each with 1 rank and
    with 2, every rank a process of this script.  The
    2-rank SAM must equal the 1-rank SAM byte for byte, and in every
    sharded rank the windows entry must equal the plain DP on one batch's
    calls.  -> (the windows entry's launches in each sharded rank, keyed by
    run; its max |dist err| there; the locate and sharded search kernels'
    launches in each rank of each run)."""
    import numpy as np

    from genome_weaver_align_tpu_torch import cli
    from genome_weaver_align_tpu_torch.utils.simulate import simulate_reads_array

    mode_q = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    log(f"[16] compute mode {mode_q}")
    check(mode_q != "Exclusive_Process",
          "the card is in Exclusive_Process compute mode: two processes cannot share it")
    idx, seedf, _ = build_index(cli, codes)
    torch.cuda.empty_cache()  # the card's memory to the ranks
    work = CACHE / f"ranks{os.getpid()}"
    work.mkdir(parents=True)
    launches, max_err, fm_launches = {}, 0, {}
    for mode, n_reads, length, kw in (
        # <= 1 substitution and <= 1 indel keep every read within k = 2
        ("sharded", RANK_BATCH * RANK_BATCHES, RANK_L,
         dict(seed=RANK_SEED, max_subs=1, indel_frac=0.15)),
        ("exact", RANK_EXACT_READS, RANK_EXACT_L, dict(seed=RANK_EXACT_SEED, max_subs=0)),
    ):
        reads, pos, strand, _ = simulate_reads_array(codes, n_reads, length, **kw)
        np.savez(work / "reads.npz", reads=reads, pos=pos, strand=strand)
        bodies = {}
        for n in (1, RANKS):
            sam = work / f"{mode}{n}.sam"
            res = run_ranks(mode, n, idx, seedf, work / "reads.npz", sam)
            bodies[n] = sam.read_bytes()
            wall = max(r["wall_s"] for r in res)
            n_sam, mapped, correct = score_sam(sam)
            n_batches = RANK_BATCHES if mode == "sharded" else 1
            def per_batch_ms(key):
                return [round(1e3 * r[key] / n_batches, 3) for r in res]

            log(f"[16] {mode}, {n} rank(s): {n_reads} reads of {length} bp in "
                f"{wall:.3f} s, {n_reads / wall:.1f} reads/s ({card}); mapped {mapped / n_sam:.6f}, "
                f"correct {correct / n_sam:.6f}; by rank: wall_s "
                f"{[round(r['wall_s'], 3) for r in res]}, gather_to_host ms a batch "
                f"{per_batch_ms('gather_s')} ({res[0]['gather_calls']} calls; before them the "
                f"wait for the other ranks at a barrier, ms a batch "
                f"{per_batch_ms('gather_wait_s')}), peak device memory "
                f"{[r['peak_mem_bytes'] for r in res]} B, windows-entry launches "
                f"{[r['windows_launches'] for r in res]}, FM launches "
                f"{[r['fm_launches'] for r in res]}")
            for r in res:
                fm_launches[f"[16] {mode}, rank {r['rank']} of {n}"] = r["fm_launches"]
            if mode == "exact":  # exact_align's locate_hits: the locate kernel in every rank
                check(all(r["fm_launches"]["locate"] > 0 for r in res),
                      f"[16] exact, {n} rank(s): a rank never launched the locate kernel")
            check(n_sam == n_reads, f"[16] {mode}: the SAM holds {n_sam} records")
            check(mapped / n_sam >= MIN_MAPPED, f"[16] {mode}: mapped share {mapped / n_sam:.4f}")
            check(correct / n_sam >= MIN_CORRECT,
                  f"[16] {mode}: correct share {correct / n_sam:.4f}")
            if mode == "sharded":
                for r in res:
                    key = f"[16] sharded, rank {r['rank']} of {n}"
                    launches[key] = r["windows_launches"]
                    check(launches[key] > 0, f"{key} never launched the banded DP's windows entry")
                    max_err = max(max_err, check_dp_results(key, {"seed path": r["dp_check"]},
                                                            "windows entry"))
        same = bodies[RANKS] == bodies[1]
        log(f"[16] {mode}: the {RANKS}-rank SAM is byte-identical to the 1-rank SAM: {same}")
        check(same, f"[16] {mode}: the {RANKS}-rank SAM differs from the 1-rank SAM")
    shutil.rmtree(work)
    return launches, max_err, fm_launches


def metered_uploads(torch, dev, mem: dict):
    """Patches of the sharded uploads (``put_sharded``, ``put_text``,
    ``put_seed``) that add each upload's device bytes to ``mem``: the
    allocator's requested and allocated bytes ("requested", "allocated",
    the mapped peers not counted), and the host bytes of the stacked big
    tables ("stacked") apart from the small bounds every rank uploads
    ("small").  -> a context manager that holds them."""
    import dataclasses

    import numpy as np

    from genome_weaver_align_tpu_torch.parallel import sharded_index as si
    from genome_weaver_align_tpu_torch.parallel import sharded_pipeline as sp

    def measured(put, tables):
        def wrapped(host, device, layout=None):
            torch.cuda.synchronize(dev)
            r0 = torch.cuda.memory_stats(dev)["requested_bytes.all.current"]
            a0 = torch.cuda.memory_allocated(dev)
            out = put(host, device, layout)
            torch.cuda.synchronize(dev)
            mem["requested"] += torch.cuda.memory_stats(dev)["requested_bytes.all.current"] - r0
            mem["allocated"] += torch.cuda.memory_allocated(dev) - a0
            for f in dataclasses.fields(host):
                a = getattr(host, f.name)
                if isinstance(a, np.ndarray):
                    mem["stacked" if f.name in tables else "small"] += a.size * 4
            return out
        return wrapped

    stack = contextlib.ExitStack()
    for mod, name, tables in ((si, "put_sharded", si._TABLES), (sp, "put_text", ("words",)),
                              (sp, "put_seed", ("offsets", "positions"))):
        stack.enter_context(mock.patch.object(mod, name, measured(getattr(mod, name), tables)))
    return stack


def read_batches(z, key: str, size: int) -> list:
    """The reads ``key`` of a rank phase's reads file as batches of
    ``size`` ``Read``s, each named by its true position and strand."""
    from genome_weaver_align_tpu_torch.utils.fasta import Read

    reads, pos, strand = z[f"{key}_reads"], z[f"{key}_pos"], z[f"{key}_strand"]
    recs = [Read(f"r{i}_p{p}_s{s}", reads[i])
            for i, (p, s) in enumerate(zip(pos.tolist(), strand.tolist()))]
    return [recs[b : b + size] for b in range(0, len(recs), size)]


def interval_child(torch, rank, n, dev, gi, seedf, reads_path, sam_path, shards) -> int:
    """One rank of phases 20, 21 and 22 (``--rank interval ... [SHARDS]``;
    for [22] started with its ``GROUP_RANK``, the declared host, and
    ``LOCAL_RANK``): ``ShardedAligner`` with ``shards`` interval shards,
    this rank holding its interval group's ``shards / g`` of them
    (``mesh.interval_span``; the stacked layout with one rank).  On the
    mapped route it maps the other members' shards; on the collective route
    (a group spans hosts) it maps nothing and merges by collectives.  The
    device bytes of each sharded upload (the allocator's requested and
    allocated bytes, the mapped peers not counted) and the ``peer.share``
    calls; the seed path on [16]'s reads and the FM path on [11]'s, each
    rank aligning its slice, every call of the verify's DP entry (windows
    entry on the mapped route, text entry on the collective one) of one
    batch held against its plain version; each card's used memory while
    every rank holds both aligners; [10]'s exact search, every rank of a
    group on its group's slice of the reads, under each merge (results to
    ``SAM.<rank>.npz``) or, where a merge reads the other members' memory
    across a host, the error it raises; the merges of each run by route;
    the sharded kernels, the fused table entry (on the held shards alone on
    the collective route, with 0 on every coordinate they do not own) and
    the ring sum against their plain versions on this layout; the merge of
    one step at the exact search's payload timed by route (the ring merge
    on the mapped route, NCCL where the group has a card a rank, and gloo);
    the kernels' launches of each run (set to 0 just before it and read
    just after); one ``RANK_RESULT`` line.  Rank 0 writes the seed path's
    SAM and the FM path's (``SAM.fm.sam``)."""
    import numpy as np

    from genome_weaver_align_tpu_torch.index.seedtable import load_seed_table
    from genome_weaver_align_tpu_torch.ops import (
        dp_cuda, fm_search_cuda, locate_cuda, ring_cuda,
    )
    from genome_weaver_align_tpu_torch.parallel import mesh as pmesh
    from genome_weaver_align_tpu_torch.parallel import multihost as mh
    from genome_weaver_align_tpu_torch.parallel import peer, ring
    from genome_weaver_align_tpu_torch.parallel import sharded_index as si
    from genome_weaver_align_tpu_torch.parallel import sharded_pipeline as sp
    from genome_weaver_align_tpu_torch.utils import sam

    counters = {"text entry": dp_cuda.banded_edit_distance_text_cuda,
                "windows entry": dp_cuda.banded_edit_distance_cuda,
                "sharded locate": locate_cuda.locate_sharded_cuda,
                "sharded piece search": fm_search_cuda.backward_search_sharded_cuda,
                "fused table entry": ring_cuda.fused_occ_cuda,
                "ring sum": ring_cuda.ring_allreduce_cuda,
                "flag-wait ring sum": ring_cuda.ring_allreduce_wait_cuda}

    def zero():
        torch.cuda.synchronize(dev)
        for c in counters.values():
            c.launches = 0
        for key in si.CROSS_MERGES:
            si.CROSS_MERGES[key] = 0

    def launches():
        torch.cuda.synchronize(dev)
        return {key: c.launches for key, c in counters.items()}

    shares = {"calls": 0}
    real_share = peer.share

    def counted_share(*a, **kw):
        shares["calls"] += 1
        return real_share(*a, **kw)

    counting = mock.patch.object(peer, "share", counted_share)
    counting.start()
    mem = {"requested": 0, "allocated": 0, "small": 0, "stacked": 0}
    z = np.load(reads_path)
    so, spos, j = load_seed_table(seedf)
    with metered_uploads(torch, dev, mem):
        al = sp.ShardedAligner(gi, k=K, n_interval=shards, device=dev, seed_table=(so, spos),
                               seed_j=j)
    del so, spos
    lay = al.layout
    mapped = isinstance(al.sh.bwt_blocks, peer.Shards)
    result = {"rank": rank, "ranks": n, "shards": shards, "held": list(lay.held),
              "group": list(lay.group_ranks), "card": dev.index, "mem": mem,
              "hosts": [mh.host_of(r) for r in range(n)], "collective": lay.collective,
              "data": [lay.data_procs, lay.data_index],
              "text_bytes": al._text.numel() * al._text.element_size(),
              "text_shards": al.tx is not None, "mapped": mapped,
              "shard_cards": list(al.sh.bwt_blocks.cards) if mapped else [dev.index] * shards,
              "apart": mapped and peer.apart(al.sh.bwt_blocks, lay),
              "nccl": si.group_nccl(lay, dev) is not None, "launches": {}, "routes": {},
              "wall_s": {}, "reads": {}, "batches": {}, "bad": {}, "dp_check": {},
              "refused": {}}

    # the verify's own peak device memory (the window gather and the DP
    # entry over one batch's candidates), above what was allocated at its
    # call; the run's overall peak kept across the resets this needs
    real_verify, peaks = sp._verify_best, {"run": 0, "verify": 0}

    def metered_verify(*a, **kw):
        torch.cuda.synchronize(dev)
        peaks["run"] = max(peaks["run"], torch.cuda.max_memory_allocated(dev))
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        out = real_verify(*a, **kw)
        torch.cuda.synchronize(dev)
        peaks["verify"] = max(peaks["verify"], torch.cuda.max_memory_allocated(dev) - base)
        return out

    def run(tag, aligner, bs):
        # the warm-up: the verify's DP entry against plain on one batch
        result["dp_check"][tag] = check_dp_entry(torch, aligner, bs[0][:4096],
                                                 text=lay.collective)
        zero()
        torch.cuda.reset_peak_memory_stats(dev)
        peaks["run"] = peaks["verify"] = 0
        t0 = time.perf_counter()
        recs = []
        with mock.patch.object(sp, "_verify_best", metered_verify):
            for b in bs:
                recs.extend(aligner.to_sam(b, aligner.align_batch(b)))
        result["wall_s"][tag] = time.perf_counter() - t0
        result["launches"][tag] = launches()
        result["routes"][tag] = dict(si.CROSS_MERGES)
        result["reads"][tag] = sum(len(b) for b in bs)
        result["batches"][tag] = len(bs)
        result[f"peak_mem_bytes_{tag}"] = max(peaks["run"], torch.cuda.max_memory_allocated(dev))
        result[f"verify_peak_bytes_{tag}"] = peaks["verify"]
        return recs, aligner.sam_header()

    seed_recs, hdr = run("seed path", al, read_batches(z, "seed", RANK_BATCH))
    fm_al = sp.ShardedAligner(gi, k=K, n_interval=shards, device=dev)
    fm_recs, hdr = run("FM path", fm_al, read_batches(z, "fm", BATCH))
    if rank == 0:
        sam.write_sam(sam_path, hdr, seed_recs)
        sam.write_sam(f"{sam_path}.fm.sam", hdr, fm_recs)

    # every card's used memory while every rank holds both aligners
    if n > 1:
        torch.distributed.barrier()
    if rank == 0:
        for key, query in (("memory_used", ["--query-gpu=index,memory.used"]),
                           ("compute_apps", ["--query-compute-apps=pid,gpu_uuid,used_memory"])):
            res = subprocess.run(["nvidia-smi", *query, "--format=csv,noheader"],
                                 capture_output=True, text=True, timeout=60)
            result[key] = res.stdout.strip().splitlines() or [res.stderr.strip()]
    if n > 1:
        torch.distributed.barrier()

    if not lay.collective:  # the piece search over every shard against its plain loop
        fr = torch.from_numpy(np.where(z["fm_reads"][:4096] >= 4, 0, z["fm_reads"][:4096])
                              .astype(np.int32)).to(dev)
        fl = torch.full((fr.shape[0],), fr.shape[1], dtype=torch.int32, device=dev)
        got = sp.sharded_piece_search(fm_al.sh, fr, fl, K + 1, fr.shape[1])
        want = sp.sharded_piece_search_plain(fm_al.sh, fr, fl, K + 1, fr.shape[1])
        result["bad"]["sharded piece search"] = sum(int((a != b).sum())
                                                    for a, b in zip(got, want))

    # [10]'s exact search: every rank of a group its group's slice of the
    # reads, the merges across the group's ranks
    layout = pmesh.make_layout(lay.groups, shards, dev)
    er = z["exact_reads"]
    r, ln, B = pmesh.shard_reads(layout, er, np.full(er.shape[0], er.shape[1], np.int32))
    check(B % layout.groups == 0, "[20] the exact reads do not split evenly over the groups")
    first = layout.data_index * r.shape[0]
    result["rows"] = [first, first + r.shape[0]]
    barrier = {"s": 0.0, "calls": 0}
    real_barrier = peer.barrier

    def timed_barrier(group):
        t0 = time.perf_counter()
        real_barrier(group)
        barrier["s"] += time.perf_counter() - t0
        barrier["calls"] += 1

    exact = {}
    with mock.patch.object(peer, "barrier", timed_barrier):
        for merge, mb in (("psum", 1), ("ring", RING_MICROBATCH), ("fused", RING_MICROBATCH)):
            if lay.collective and merge != "psum":  # they read the other members' memory
                try:
                    si.make_sharded_exact_search(layout, er.shape[1], al.sh, merge=merge,
                                                 microbatch=mb)
                except ValueError as e:
                    result["refused"][merge] = str(e)
                continue
            fn = si.make_sharded_exact_search(layout, er.shape[1], al.sh, merge=merge,
                                              microbatch=mb)
            fn(al.sh, r[:1024], ln[:1024])  # warm-up
            zero()
            barrier.update(s=0.0, calls=0)
            t0 = time.perf_counter()
            out = fn(al.sh, r, ln)
            torch.cuda.synchronize(dev)
            tag = f"exact, merge={merge}"
            result["wall_s"][tag] = time.perf_counter() - t0
            result["launches"][tag] = launches()
            result["routes"][tag] = dict(si.CROSS_MERGES)
            result["reads"][tag] = r.shape[0]
            result["batches"][tag] = 1
            result[f"barrier_{merge}"] = dict(barrier)
            for key, v in zip(("lo", "hi", "pos"), out):
                exact[f"{merge}_{key}"] = v.cpu().numpy()
    np.savez(f"{sam_path}.{rank}.npz", **exact)
    counting.stop()
    result["shares"] = shares["calls"]

    # the sharded locate and the fused table entry on this layout against
    # their plain versions, at the exact search's rows and 2 x 65,536
    # random queries over every coordinate; on the collective route the
    # table entry over the held shards alone
    gen = torch.Generator(device=dev)
    gen.manual_seed(20)
    if not lay.collective:
        rows = torch.from_numpy(exact["psum_lo"]).to(dev).clamp(0, gi.fwd.n)
        result["bad"]["sharded locate"] = int((si.locate(al.sh, rows)
                                               != si.locate_plain(al.sh, rows)).sum())
    tab = si.held_index(al.sh, lay) if lay.collective else al.sh
    qk = torch.randint(0, gi.fwd.n + 2, (2, 65_536), generator=gen, device=dev,
                       dtype=torch.int32)
    qc = torch.randint(0, 4, (2, 65_536), generator=gen, device=dev, dtype=torch.int32)
    got = si.fused_occ(tab, qc, qk)
    result["bad"]["fused table entry"] = int((got != si.fused_occ_plain(tab, qc, qk)).sum())
    if lay.collective:
        k_adj = qk - (qk > tab.primary).to(torch.int32)
        owned = (k_adj >= tab.pk_start[0]) & (k_adj < tab.pk_end[-1])
        result["bad"]["unowned coordinates not 0"] = int((got[~owned] != 0).sum())
        result["unowned"] = int((~owned).sum())

    # one merge at the exact search's payload, (2, 32,768) int32 a step at
    # microbatch 2 (the ring's) on the mapped route, (2, 65,536) at
    # microbatch 1 (the psum's) on the collective one, by route: the ring
    # merge this layout takes (mapped route: this rank's partial in its
    # inbox row, the merge alone timed; its sums held against the plain
    # ring sum of every rank's partial), NCCL all_reduce and gloo
    # all_reduce (as _psum_across runs them).  The ring merge and NCCL are
    # timed back to back (the host and the device overlap: wall / merges)
    # and with a synchronize after every merge; the host ms of the ring
    # merge's calls alone beside them
    group = lay.group
    if group is not None:
        payload = (2, er.shape[0] // (1 if lay.collective else RING_MICROBATCH))

        def partial_of(q):  # group rank q's partial, the same in every rank
            g = torch.Generator(device=dev)
            g.manual_seed(1000 + q)
            return torch.randint(-(1 << 30), 1 << 30, payload, generator=g, device=dev,
                                 dtype=torch.int32)

        mine = partial_of(lay.group_rank)
        ms = {"payload": list(payload)}
        reps = 200

        def timed(merge):  # (back to back, synchronised every merge) ms a merge
            peer.barrier(group)
            t0 = time.perf_counter()
            for _ in range(reps):
                merge()
            torch.cuda.synchronize(dev)
            free = 1e3 * (time.perf_counter() - t0) / reps
            peer.barrier(group)
            t0 = time.perf_counter()
            for _ in range(reps):
                merge()
                torch.cuda.synchronize(dev)
            return free, 1e3 * (time.perf_counter() - t0) / reps

        if not lay.collective:
            want = ring.ring_psum_plain(torch.stack([partial_of(q)
                                                     for q in range(lay.interval_procs)]))
            slots = si._RingSlots(lay, group, payload, dev, result["apart"])
            for s in range(2):  # this rank's partial in both inboxes
                slots.inboxes[s][slots.me][slots.me].copy_(mine)
            for _ in range(6):
                got = slots.merge()
            torch.cuda.synchronize(dev)
            if result["apart"]:  # the host barrier's merges wait on the host
                t0 = time.perf_counter()
                for _ in range(reps):
                    got = slots.merge()
                ms["ring_host"] = 1e3 * (time.perf_counter() - t0) / reps
                torch.cuda.synchronize(dev)
            ms["ring"], ms["ring_sync"] = timed(slots.merge)
            got = slots.merge()
            torch.cuda.synchronize(dev)
            ms["ring_route"] = "flag wait" if result["apart"] else "host barrier"
            result["bad"]["ring merge"] = int((got != want[lay.group_rank]).sum())
            peer.release(group, slots.close, collect=False)
            slots.check()
        x = mine.clone()
        nccl = si.group_nccl(lay, dev)
        if nccl is not None:
            for _ in range(5):
                torch.distributed.all_reduce(x, group=nccl)
            ms["nccl"], ms["nccl_sync"] = timed(lambda: torch.distributed.all_reduce(x,
                                                                                     group=nccl))
        peer.barrier(group)
        t0 = time.perf_counter()
        for _ in range(reps // 4):
            y = x.cpu()
            torch.distributed.all_reduce(y, group=group)
            x = y.to(dev)
        torch.cuda.synchronize(dev)
        ms["gloo"] = 1e3 * (time.perf_counter() - t0) / (reps // 4)
        result["merge_ms"] = ms
    fm_al.close()
    al.close()
    if n > 1:
        torch.distributed.destroy_process_group()
    print("RANK_RESULT " + json.dumps(result), flush=True)
    return 0


def phase_flag_wait(torch, card) -> dict:
    """The flag-wait ring entry (push, one flag word a block) against its
    plain version on every element, on card 0 alone, at [10]'s ring
    payload, with SHARDS ranks emulated on the card: each rank's inbox
    holds every rank's partial (the peers' pushes already landed) and its
    peers' flag words are pre-published, so the wait passes at once; each
    rank's launch must push its row into every other inbox and publish its
    epoch in every peer's words; int32 at every rank, float32 at one; the
    prepared launch timed (device and host).  Then two ranks with the
    peer's per-block words published one block at a time, in reverse
    order, from a second stream while the kernel waits.  Then the
    failures: rank 0 waits for an epoch its peer never publishes, must
    time out, and goes on to two later merges that must not wait and must
    publish the poison; rank 1, arriving late at that epoch, must find the
    poison and fail too; ``check_flag_wait`` must raise for both.  Across
    cards the entry runs in [20]'s ranks.  -> the largest mismatch and the
    times."""
    from genome_weaver_align_tpu_torch.ops import ring_cuda
    from genome_weaver_align_tpu_torch.parallel import ring

    dev = torch.device("cuda", 0)
    W = ring_cuda.WAIT_BLOCKS
    gen = torch.Generator(device=dev)
    gen.manual_seed(21)
    payload = (2, BATCH // RING_MICROBATCH)  # [10]'s ring payload
    P = SHARDS
    bad, pushed = 0, True
    for dtype, ranks in ((torch.int32, range(P)), (torch.float32, (1,))):
        x = (torch.randint(-(1 << 30), 1 << 30, (P, *payload), generator=gen, device=dev,
                           dtype=torch.int32) if dtype == torch.int32
             else torch.randn((P, *payload), generator=gen, device=dev) * 1e4)
        want = ring.ring_psum_plain(x)
        if dtype == torch.int32:
            xi = x.view(P, -1)
        for me in ranks:
            boxes = [x.clone() if q == me else torch.zeros_like(x) for q in range(P)]
            flags = [torch.zeros((P, W), dtype=torch.int32, device=dev) for _ in range(P)]
            flags[me].fill_(1 << 30)  # every peer has published every epoch
            error = torch.zeros(1, dtype=torch.int32, device=dev)
            got = ring_cuda.ring_allreduce_wait_cuda(boxes, flags, me, me + 1, error)
            bad += int((got != want[me]).sum())
            G = ring_cuda.wait_blocks(x[0].numel())
            pushed &= all(torch.equal(boxes[q][me], x[me]) and
                          bool((flags[q][me, :G] == me + 1).all()) for q in range(P) if q != me)
            check(int(error) == 0, f"[20] flag wait on one card: error word {int(error)}")
    x = xi
    boxes = [x.clone()] + [torch.zeros_like(x) for _ in range(P - 1)]
    flags = [torch.full((P, W), 1 << 30, dtype=torch.int32, device=dev) for _ in range(P)]
    error = torch.zeros(1, dtype=torch.int32, device=dev)
    prepared = ring_cuda.FlagWait([boxes], flags, 0, error)
    ms = cuda_time_ms(lambda: prepared(0, 7), reps=200, hide_host=True)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(200):
        prepared(0, 7)
    host_ms = 1e3 * (time.perf_counter() - t0) / 200
    torch.cuda.synchronize(dev)
    plain_ms = cuda_time_ms(lambda: ring.ring_psum_plain(x), reps=20)

    # two ranks, the peer's words published block by block in reverse order
    n = x[0].numel()
    G = ring_cuda.wait_blocks(n)
    mine, theirs = x[:2].clone(), torch.zeros_like(x[:2])
    flags = [torch.zeros((2, W), dtype=torch.int32, device=dev) for _ in range(2)]
    error = torch.zeros(1, dtype=torch.int32, device=dev)
    main, side = torch.cuda.Stream(dev), torch.cuda.Stream(dev)
    # CUDA loads a kernel at its first launch, and a load while a kernel
    # spins waits for that kernel: the publisher's kernels run once first
    # (torch picks the one-word fill's kernel by the word's alignment)
    with torch.cuda.stream(side):
        torch.cuda._sleep(1)
        for i in range(4):
            flags[1][1, i].fill_(0)
    torch.cuda.synchronize(dev)
    with torch.cuda.stream(main):
        got = ring_cuda.ring_allreduce_wait_cuda([mine, theirs], flags, 0, 1, error,
                                                 timeout_s=5.0)
    with torch.cuda.stream(side):
        for b in reversed(range(G)):
            torch.cuda._sleep(20_000)
            flags[0][1, b].fill_(1)
    torch.cuda.synchronize(dev)
    reverse_bad = int((got != ring.ring_psum_plain(x[:2])[0]).sum()) + int(error) * n

    def raises(err) -> bool:
        try:
            ring_cuda.check_flag_wait(err)
        except RuntimeError:
            return True
        return False

    # rank 0 times out at an epoch rank 1 has not reached, then runs on
    boxes = [x[:2].clone(), x[:2].clone()]
    flags = [torch.zeros((2, W), dtype=torch.int32, device=dev) for _ in range(2)]
    errors = [torch.zeros(1, dtype=torch.int32, device=dev) for _ in range(2)]
    t0 = time.perf_counter()
    ring_cuda.ring_allreduce_wait_cuda(boxes, flags, 0, 1, errors[0], timeout_s=0.01)
    torch.cuda.synchronize(dev)
    waited = time.perf_counter() - t0
    t0 = time.perf_counter()
    for epoch in (2, 3):
        ring_cuda.ring_allreduce_wait_cuda(boxes, flags, 0, epoch, errors[0], timeout_s=30.0)
    torch.cuda.synchronize(dev)
    after = time.perf_counter() - t0
    poisoned = bool((flags[1][0] == ring_cuda.POISON).all())
    # rank 1 arrives late at epoch 1: rank 0 has poisoned its words there
    t0 = time.perf_counter()
    ring_cuda.ring_allreduce_wait_cuda(boxes, flags, 1, 1, errors[1], timeout_s=30.0)
    torch.cuda.synchronize(dev)
    late = time.perf_counter() - t0
    both = raises(errors[0]) and raises(errors[1])
    log(f"[20] one card: the flag-wait sum ({P} ranks emulated, {tuple(payload)} a partial, "
        f"peers pre-published; int32 at every rank, float32 at one) against plain: {bad} "
        f"mismatches, pushes and epochs landed in every peer: {pushed}; the prepared launch "
        f"{ms:.4f} ms on the device, {host_ms:.4f} ms on the host a call, plain ring sum "
        f"{plain_ms:.4f} ms; {G} blocks, the peer's words published in reverse order: "
        f"{reverse_bad} mismatches; a wait no peer satisfies timed out after {waited:.3f} s, "
        f"the rank's two later merges took {after:.3f} s and left the poison in every word of "
        f"its peer: {poisoned}; the late peer failed after {late:.3f} s; both raised: {both} "
        f"({card})")
    check(bad == 0 and pushed and reverse_bad == 0,
          "[20] the flag-wait sum differs from plain on one card")
    check(both and poisoned and after < 5 and late < 5,
          "[20] a failed flag wait did not reach its peer, or a rank waited after it")

    # past 16 ranks, emulated as above: int32 at the first, a middle and the last rank, float32 at one
    wide = {}
    for P in WIDE_RANKS if PAST_OLD_LIMITS else ():
        wbad, wpushed = 0, True
        for dtype, ranks in ((torch.int32, (0, P // 2, P - 1)), (torch.float32, (1,))):
            x = (torch.randint(-(1 << 30), 1 << 30, (P, *payload), generator=gen, device=dev,
                               dtype=torch.int32) if dtype == torch.int32
                 else torch.randn((P, *payload), generator=gen, device=dev) * 1e4)
            want = ring.ring_psum_plain(x)
            for me in ranks:
                boxes = [x.clone() if q == me else torch.zeros_like(x) for q in range(P)]
                flags = [torch.zeros((P, W), dtype=torch.int32, device=dev) for _ in range(P)]
                flags[me].fill_(1 << 30)
                error = torch.zeros(1, dtype=torch.int32, device=dev)
                got = ring_cuda.ring_allreduce_wait_cuda(boxes, flags, me, me + 1, error)
                wbad += int((got != want[me]).sum()) + int(error)
                wpushed &= all(torch.equal(boxes[q][me], x[me]) and
                               bool((flags[q][me, :G] == me + 1).all())
                               for q in range(P) if q != me)
        boxes = [x.clone()] + [torch.zeros_like(x) for _ in range(P - 1)]
        flags = [torch.full((P, W), 1 << 30, dtype=torch.int32, device=dev) for _ in range(P)]
        error = torch.zeros(1, dtype=torch.int32, device=dev)
        prepared = ring_cuda.FlagWait([boxes], flags, 0, error)
        wide[P] = {"err": wbad, "ms": cuda_time_ms(lambda: prepared(0, 7), reps=200,
                                                    hide_host=True),
                   "plain_ms": cuda_time_ms(lambda: ring.ring_psum_plain(x), reps=5)}
        log(f"[20] one card, {P} ranks emulated ({tuple(payload)} a partial): the flag-wait sum "
            f"against plain {wbad} mismatches, pushes and epochs landed in every peer: "
            f"{wpushed}; the prepared launch {wide[P]['ms']:.4f} ms ({card})")
        check(wbad == 0 and wpushed, f"[20] the flag-wait sum differs from plain at {P} ranks")
    return {"err": bad, "ms": ms, "host_ms": host_ms, "plain_ms": plain_ms,
            "payload": list(payload), "blocks": G, "wide": wide}


def phase_interval(torch, codes, card) -> dict:
    """Interval shards in separate processes (BASELINE config 5's layout),
    rank r on card r % device_count: [20] SHARDS shards over 1 (the
    stacked layout), 2 and 4 ranks, one interval group; [21] the two-axis
    layout, 2 shards over 4 ranks (two interval groups, two copies of the
    index).  Each rank holds its group's shards and maps the other
    members' (CUDA IPC; over NVLink where they lie on other cards).  The
    P-rank SAMs (seed and FM path) must equal the 1-rank SAMs byte for
    byte, every rank's exact search the 1-rank result on its group's rows,
    each rank's sharded tables at most its share of the stacked bytes plus
    one block row a shard, the sharded kernels, the ring merge and every
    windows-entry call of one batch (each aligner path's warm-up) equal to
    their plain versions on the mapped layout, and every rank must launch
    the sharded locate, the sharded piece search, the fused table entry,
    the ring sum (the flag-wait entry across cards) and the windows entry.
    Where the ranks have a card each, the psum must go over NCCL, the ring
    merge through the flag wait with no host barrier.  -> the launches of
    each rank, keyed by run, each run's merge timings, the 1-rank run's SAM
    bodies and exact search, the directory of its reads (for [22], which
    removes it), and the windows entry's largest |dist err|."""
    import numpy as np

    from genome_weaver_align_tpu_torch import cli
    from genome_weaver_align_tpu_torch.parallel import mesh as pmesh
    from genome_weaver_align_tpu_torch.utils.simulate import simulate_reads_array

    idx, seedf, _ = build_index(cli, codes)
    torch.cuda.empty_cache()  # the card's memory to the ranks
    work = CACHE / f"interval{os.getpid()}"
    work.mkdir(parents=True)
    seed = simulate_reads_array(codes, RANK_BATCH * RANK_BATCHES, RANK_L, seed=RANK_SEED,
                                max_subs=1, indel_frac=0.15)[:3]
    fm = simulate_reads_array(codes, SHARDED_FM_READS, L, seed=52, max_subs=2)[:3]  # [11]'s
    _, er, _ = sharded_search_reads(codes, pmesh.make_layout(1, 1, "cpu"))  # [10]'s
    np.savez(work / "reads.npz", **{f"{key}_{f}": a for key, arrs in (("seed", seed), ("fm", fm))
                                    for f, a in zip(("reads", "pos", "strand"), arrs)},
             exact_reads=er.numpy())
    n_cards = torch.cuda.device_count()
    ref, launches, timings, dp_err = {}, {}, {}, 0
    t_phase = time.time()
    runs = [("[20]", n, SHARDS) for n in INTERVAL_RANKS] + [
        ("[20]", 2, WIDE_SHARDS), ("[21]", TWO_AXIS_RANKS, TWO_AXIS_SHARDS)]
    for phase, n, S in runs:
        if phase == "[20]" and S != SHARDS:  # its own keys beside the SHARDS run's
            phase = f"[20] {S} shards"
        sam = work / f"seed{n}x{S}.sam"
        res = run_ranks("interval", n, idx, seedf, work / "reads.npz", sam, tag=phase,
                        extra=(str(S),))
        g = pmesh.interval_span(n, S)
        own_cards = 1 < n <= n_cards  # every rank on a card of its own
        head = f"{phase} {n} rank(s), {S} shards ({n // g} interval group(s) of {g})"
        paths = {"seed path": sam, "FM path": Path(f"{sam}.fm.sam")}
        bodies = {tag: path.read_bytes() for tag, path in paths.items()}
        exact = [dict(np.load(f"{sam}.{r['rank']}.npz")) for r in res]
        for r in res:
            log(f"{head}: rank {r['rank']} on cuda:{r['card']}, group {r['group']}, shards "
                f"{r['held']} on cards {r['shard_cards']}: peers on other cards "
                f"{r['apart']}, NCCL group {r['nccl']}; merge routes by run "
                f"{r['routes']}")
            if r.get("memory_used"):
                log(f"{head}: with every rank alive, memory.used by card {r['memory_used']}; "
                    f"compute apps {r['compute_apps']} ({card})")
        for tag, path in paths.items():
            n_sam, mapped, correct = score_sam(path)
            wall = max(r["wall_s"][tag] for r in res)
            n_batches = -(-n_sam // (RANK_BATCH if tag == "seed path" else BATCH))
            log(f"{head}, {tag}: {n_sam} reads in {wall:.3f} s, {n_sam / wall:.1f} reads/s, "
                f"{1e3 * wall / n_batches:.1f} ms a batch ({card}); mapped "
                f"{mapped / n_sam:.6f}, correct {correct / n_sam:.6f}; peak device memory by "
                f"rank {[r[f'peak_mem_bytes_{tag}'] for r in res]} B, of the verify (above "
                f"what was allocated at its call) {[r[f'verify_peak_bytes_{tag}'] for r in res]} "
                f"B; launches by rank {[r['launches'][tag] for r in res]}")
            if not res[0]["collective"]:
                VERIFY_PEAK[n, S, tag] = max(r[f"verify_peak_bytes_{tag}"] for r in res)
            check(mapped / n_sam >= MIN_MAPPED and correct / n_sam >= MIN_CORRECT,
                  f"{phase} {tag}, {n} ranks: mapped {mapped / n_sam:.4f}, correct "
                  f"{correct / n_sam:.4f}")
        for merge in ("psum", "ring", "fused"):
            tag = f"exact, merge={merge}"
            wall = max(r["wall_s"][tag] for r in res)
            bar = [r[f"barrier_{merge}"] for r in res]
            log(f"{head}, {tag}: {res[0]['reads'][tag]} reads in each rank, {wall:.3f} s "
                f"({card}); host barriers {[b['calls'] for b in bar]}, "
                f"{[round(1e3 * b['s'] / max(1, b['calls']), 4) for b in bar]} ms each by rank; "
                f"launches by rank {[r['launches'][tag] for r in res]}")
        for r in res:
            if "merge_ms" in r:
                log(f"{head}: rank {r['rank']}, one merge of {r['merge_ms']['payload']} int32, "
                    f"ms: {r['merge_ms']} ({card})")
        if n == 1:
            ref = {"bodies": bodies, "exact": exact[0]}
        for tag, body in bodies.items() if n > 1 else ():
            same = body == ref["bodies"][tag]
            log(f"{head}, {tag}: the SAM is byte-identical to the 1-rank stacked SAM: {same}")
            check(same, f"{phase} {tag}: the {n}-rank SAM differs from the 1-rank SAM")
        for r, ex in zip(res, exact):
            who = f"{phase} rank {r['rank']} of {n}"
            first, stop = r["rows"]
            same = all(np.array_equal(ex[key], ref["exact"][key][first:stop])
                       for key in ref["exact"])
            check(same, f"{who}: the exact search differs from the 1-rank stacked search")
            m = r["mem"]
            big = m["requested"] - m["small"]
            per = S // g
            limit = m["stacked"] * per / S + FM_ROW_BYTES * per
            log(f"{who} holds shards {r['held']} "
                f"({'the others mapped' if r['mapped'] else 'stacked'}): sharded tables "
                f"{big} B requested ({m['allocated']} B allocated with the bounds), stacked "
                f"{m['stacked']} B, limit {limit:.0f} B; the whole text (_text) {r['text_bytes']} "
                f"B apart; the exact search on rows {r['rows']} equal to the 1-rank search "
                f"under psum, ring and fused: {same}; kernels against plain on this layout, "
                f"mismatches {r['bad']}")
            check(big <= limit, f"{who} holds {big} B of sharded tables, more than {limit:.0f}")
            check(r["mapped"] == (g > 1) and not r["collective"],
                  f"{who}: mapped {r['mapped']}, collective {r['collective']}")
            dp_err = max(dp_err, check_dp_results(who, r["dp_check"], "windows entry"))
            check(r["held"] == list(range(per * (r["rank"] % g), per * (r["rank"] % g + 1))),
                  f"{who} holds shards {r['held']}")
            check(not any(r["bad"].values()), f"{who}: a kernel differs from its plain "
                  f"version: {r['bad']}")
            check(r["card"] == r["rank"] % n_cards, f"{who} is on cuda:{r['card']}")
            routes = {tag: r["routes"][f"exact, merge={tag}"] for tag in ("psum", "ring")}
            if own_cards:
                check(r["apart"] and len(set(r["shard_cards"])) == g,
                      f"{who}: its group's shards are not one card a rank: {r['shard_cards']}")
                check(routes["psum"]["psum nccl"] > 0 and routes["psum"]["psum gloo"] == 0,
                      f"{who}: the psum did not go over NCCL: {routes['psum']}")
                check(routes["ring"]["ring flag wait"] > 0
                      and routes["ring"]["ring host barrier"] == 0,
                      f"{who}: the ring merge did not take the flag wait alone: "
                      f"{routes['ring']}")
            elif g > 1:
                check(routes["psum"]["psum gloo"] > 0 and routes["ring"]["ring host barrier"] > 0,
                      f"{who}: ranks that share a card must merge over gloo and host barriers: "
                      f"{routes}")
            want = {"seed path": ("windows entry",),
                    "FM path": ("windows entry", "sharded locate", "sharded piece search"),
                    "exact, merge=psum": ("sharded locate",),
                    "exact, merge=ring": ("sharded locate", "flag-wait ring sum" if own_cards
                                          else "ring sum"),
                    "exact, merge=fused": ("sharded locate", "fused table entry")}
            for tag, kernels in want.items():
                for kname in kernels:
                    check(r["launches"][tag][kname] > 0, f"{who}, {tag}: the {kname} kernel was "
                          f"never launched")
                launches[f"{phase} {tag}, rank {r['rank']} of {n}"] = r["launches"][tag]
            if g > 1:  # the ring's chunk-step: one table-entry launch, one merge launch
                ring_run = r["launches"]["exact, merge=ring"]
                merges = sum(routes["ring"][k] for k in ("ring flag wait", "ring host barrier"))
                kname = "flag-wait ring sum" if own_cards else "ring sum"
                check(ring_run["fused table entry"] == ring_run[kname] == merges > 0,
                      f"{who}: the ring search's chunk-steps are not one table-entry launch and "
                      f"one merge launch each: {ring_run}, {merges} merges")
        timings[phase, n] = {key: res[0][key] for key in ("merge_ms",) if key in res[0]}
    for tag in ("seed path", "FM path"):
        few, wide = VERIFY_PEAK[2, SHARDS, tag], VERIFY_PEAK[2, WIDE_SHARDS, tag]
        log(f"[20] 2 ranks, {tag}: the verify's peak device memory {few} B at {SHARDS} shards, "
            f"{wide} B at {WIDE_SHARDS} shards ({wide / max(few, 1):.3f}x, limit 1.5x) ({card})")
        check(wide <= 1.5 * few, f"[20] {tag}: the verify's peak at {WIDE_SHARDS} shards is "
              f"{wide / max(few, 1):.3f}x that at {SHARDS}")
    if n_cards == 1:
        log(f"[20] the ranks share one card: a peer's shard is read from the same HBM as this "
            f"rank's own, so these times say nothing of reads across NVLink ({card})")
    log(f"[20], [21] phase wall {time.time() - t_phase:.1f} s ({card})")
    return launches, timings, ref, work, dp_err


def phase_hosts(torch, codes, card, ref, work) -> dict:
    """BASELINE config 5 with the index sharded across hosts: [20]'s
    traffic (the seed path on [16]'s reads, the FM path on [11]'s, [10]'s
    exact search) with SHARDS shards over HOST_RANKS ranks declared on two
    hosts (``GROUP_RANK`` = r // RANKS_A_HOST, ``LOCAL_RANK`` = r: rank r on
    card r % device_count), one interval group across both, so the
    collective route: each rank uploads its own shard only, maps nothing,
    and merges every step by ``all_reduce`` (and the verify's distances by
    ``all_gather``) over the group.  The SAMs and the exact search must
    equal [20]'s 1-rank results (``ref``), the merges go over NCCL alone
    where the ranks have a card each and over gloo alone where they share
    one, no rank shares memory with another (0 ``peer.share`` calls) or
    makes text shards, each rank's tables are at most its share of the
    stacked bytes plus a block row a shard, ring and fused raise naming
    both hosts, every rank launches the fused table entry (FM path, exact
    search) and the banded DP's text entry (both aligner paths) and neither
    the windows entry nor the sharded locate or piece search, every text
    entry call of one batch (the warm-up of each aligner path) equals the
    plain DP in every rank, and the table entry on a rank's held shards
    equals its plain version with 0 on every coordinate they do not own.
    Reads/s, ms a batch, merges a batch by route, one merge's ms by route,
    each rank's table bytes and peak device memory, each card's used memory
    and the phase's wall are printed.  -> (the launches of each rank, keyed
    by run; the text entry's largest |dist err|)."""
    import numpy as np

    from genome_weaver_align_tpu_torch import cli

    t_phase = time.time()
    idx, seedf, _ = build_index(cli, codes)
    n, S = HOST_RANKS, SHARDS
    n_cards = torch.cuda.device_count()
    sam = work / "hosts.sam"
    res = run_ranks("interval", n, idx, seedf, work / "reads.npz", sam, tag="[22]",
                    extra=(str(S),),
                    env_of=lambda r: {"GROUP_RANK": str(r // RANKS_A_HOST), "LOCAL_RANK": str(r)})
    own_cards = n <= n_cards
    head = (f"[22] {n} ranks on {n // RANKS_A_HOST} declared hosts, {S} shards, one interval "
            f"group across them")
    bodies = {"seed path": sam.read_bytes(), "FM path": Path(f"{sam}.fm.sam").read_bytes()}
    launches, dp_err = {}, 0
    for r in res:
        log(f"{head}: rank {r['rank']} on cuda:{r['card']}, host {r['hosts'][r['rank']]}, shards "
            f"{r['held']}, collective route {r['collective']}, NCCL group {r['nccl']}, data axis "
            f"{r['data']}, peer.share calls {r['shares']}; merges by run and route {r['routes']}")
        if r.get("memory_used"):
            log(f"{head}: with every rank alive, memory.used by card {r['memory_used']}; compute "
                f"apps {r['compute_apps']} ({card})")
    for tag in ("seed path", "FM path"):
        n_sam, mapped, correct = score_sam(sam if tag == "seed path" else Path(f"{sam}.fm.sam"))
        wall = max(r["wall_s"][tag] for r in res)
        batches = res[0]["batches"][tag]
        per_batch = {key: v / batches for key, v in res[0]["routes"][tag].items() if v}
        log(f"{head}, {tag}: {n_sam} reads in {wall:.3f} s, {n_sam / wall:.1f} reads/s, "
            f"{1e3 * wall / batches:.1f} ms a batch ({card}); mapped {mapped / n_sam:.6f}, "
            f"correct {correct / n_sam:.6f}; merges a batch by route {per_batch}; peak device "
            f"memory by rank {[r[f'peak_mem_bytes_{tag}'] for r in res]} B; launches by rank "
            f"{[r['launches'][tag] for r in res]}")
        check(mapped / n_sam >= MIN_MAPPED and correct / n_sam >= MIN_CORRECT,
              f"[22] {tag}: mapped {mapped / n_sam:.4f}, correct {correct / n_sam:.4f}")
        same = bodies[tag] == ref["bodies"][tag]
        log(f"{head}, {tag}: the SAM is byte-identical to [20]'s 1-rank stacked SAM: {same}")
        check(same, f"[22] {tag}: the SAM differs from [20]'s 1-rank SAM")
    tag = "exact, merge=psum"
    wall = max(r["wall_s"][tag] for r in res)
    log(f"{head}, {tag}: {res[0]['reads'][tag]} reads in each rank, {wall:.3f} s ({card}); "
        f"merges {res[0]['routes'][tag]}; launches by rank {[r['launches'][tag] for r in res]}")
    for r in res:
        who = f"[22] rank {r['rank']} of {n}"
        ex = dict(np.load(f"{sam}.{r['rank']}.npz"))
        first, stop = r["rows"]
        same = all(np.array_equal(ex[key], ref["exact"][key][first:stop]) for key in ex)
        check(same, f"{who}: the exact search differs from [20]'s 1-rank search")
        m = r["mem"]
        big = m["requested"] - m["small"]
        limit = m["stacked"] * len(r["held"]) / S + FM_ROW_BYTES * len(r["held"])
        log(f"{who} holds shards {r['held']} alone: tables {big} B requested ({m['allocated']} B "
            f"allocated with the bounds), stacked {m['stacked']} B, limit {limit:.0f} B; the "
            f"whole text {r['text_bytes']} B apart; exact search on rows {r['rows']} equal to "
            f"[20]'s: {same}; kernels against plain, mismatches {r['bad']} ({r['unowned']} "
            f"queries outside its shards); one merge of {r['merge_ms']['payload']} int32, ms "
            f"{r['merge_ms']} ({card}); ring refused: {r['refused'].get('ring')}")
        check(r["collective"] and r["shares"] == 0 and not r["text_shards"],
              f"{who}: not the collective route, or memory shared: {r['collective']}, "
              f"{r['shares']} peer.share calls, text shards {r['text_shards']}")
        check(r["held"] == [r["rank"]] and r["data"] == [1, 0],
              f"{who} holds {r['held']}, data axis {r['data']}")
        check(big <= limit, f"{who} holds {big} B of tables, more than {limit:.0f}")
        check(not any(r["bad"].values()), f"{who}: the table entry on its held shards differs "
              f"from plain: {r['bad']}")
        dp_err = max(dp_err, check_dp_results(who, r["dp_check"], "text entry"))
        check(r["card"] == r["rank"] % n_cards, f"{who} is on cuda:{r['card']}")
        a, b = r["hosts"][0], r["hosts"][-1]
        check(a != b and all(f"{a!r}" in r["refused"].get(m, "") and f"{b!r}" in r["refused"][m]
                             for m in ("ring", "fused")),
              f"{who}: ring and fused did not raise naming hosts {a} and {b}: {r['refused']}")
        for run, routes in r["routes"].items():
            fast, slow = ("nccl", "gloo") if own_cards else ("gloo", "nccl")
            check(routes[f"psum {fast}"] > 0 and routes[f"psum {slow}"] == 0
                  and routes[f"all_gather {slow}"] == 0
                  and sum(routes.values()) == routes[f"psum {fast}"] + routes[f"all_gather {fast}"],
                  f"{who}, {run}: the merges did not go over {fast} alone: {routes}")
        want = {"seed path": ("text entry",), "FM path": ("text entry", "fused table entry"),
                "exact, merge=psum": ("fused table entry",)}
        for run, kernels in want.items():
            got = r["launches"][run]
            for kname in kernels:
                check(got[kname] > 0, f"{who}, {run}: the {kname} was never launched")
            check(got["windows entry"] == got["sharded locate"] == got["sharded piece search"]
                  == 0, f"{who}, {run}: a mapped-route kernel launched: {got}")
            launches[f"[22] {run}, rank {r['rank']} of {n}"] = got
    if not own_cards:
        log(f"[22] the ranks share one card: the merges go over gloo on the host, so these times "
            f"say nothing of NCCL between cards ({card})")
    shutil.rmtree(work)
    log(f"[22] phase wall {time.time() - t_phase:.1f} s ({card})")
    return launches, dp_err


def phase_builders(torch, dev, codes, card, native_index_s):
    """The device suffix-array builder and the wavelet rank backend at chr20
    scale: ``index --builder device`` through the CLI on the phase-4 FASTA
    with phase 4's options must write the same arrays as the cached index
    (native SA-IS), then ``exact_search_wavelet`` over the forward BWT must
    give the fused-row search's (lo, hi) on every read."""
    import numpy as np

    from genome_weaver_align_tpu_torch import cli
    from genome_weaver_align_tpu_torch.index import device_build, native, wavelet
    from genome_weaver_align_tpu_torch.index.files import load_index
    from genome_weaver_align_tpu_torch.models import exact
    from genome_weaver_align_tpu_torch.ops import rank as rank_ops
    from genome_weaver_align_tpu_torch.utils import packing

    idx, seedf, _ = build_index(cli, codes)
    fasta = idx.parent / "genome.fa"
    check(fasta.exists(), f"{fasta} is missing")
    work = CACHE / f"devbuild{os.getpid()}"
    work.mkdir(parents=True)
    runs = []
    real_sa = device_build.suffix_array_device

    real_round = device_build._doubling_round
    rounds = [0]

    def counted_round(k, rank):  # keeps no reference to a round's tensors
        rounds[0] += 1
        return real_round(k, rank)

    def timed_sa(c, device="cuda"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        rounds[0] = 0
        with mock.patch.object(device_build, "_doubling_round", counted_round):
            t0 = time.perf_counter()
            sa = real_sa(c, device=device)
            s = time.perf_counter() - t0
        runs.append({"s": s, "rounds": rounds[0],
                     "peak": torch.cuda.max_memory_allocated(dev), "sa": sa if not runs else None})
        return sa

    torch.cuda.empty_cache()
    with mock.patch.object(device_build, "suffix_array_device", timed_sa):
        t0 = time.time()
        rc = cli.main(["index", str(fasta), "-o", str(work / "genome.npz"), "--seed", str(SEED_J),
                       "--builder", "device"])
        cli_s = time.time() - t0
    check(rc == 0, f"index --builder device exited {rc}")
    check(len(runs) == 2, f"the device builder ran {len(runs)} times, expected 2")
    t0 = time.perf_counter()
    sa_native = native.suffix_array_native(codes)
    native_s = time.perf_counter() - t0
    same_sa = np.array_equal(runs[0]["sa"], sa_native)
    del sa_native
    runs[0]["sa"] = None
    diff = []
    for name in ("genome.npz", f"genome.npz.seed{SEED_J}.npz"):
        with np.load(idx.parent / name) as a, np.load(work / name) as b:
            diff += [f"{name}:{key}" for key in sorted(set(a.files) | set(b.files))
                     if key not in a.files or key not in b.files
                     or a[key].dtype != b[key].dtype or not np.array_equal(a[key], b[key])]
    shutil.rmtree(work)
    log(f"[17] index --builder device --seed {SEED_J} of {codes.size} bp: {cli_s:.1f} s through "
        f"the CLI (phase 4's index --builder auto: "
        + (f"{native_index_s:.1f} s" if native_index_s is not None else "cached, not timed")
        + f"); suffix_array_device forward / reverse {runs[0]['s']:.3f} / {runs[1]['s']:.3f} s in "
        f"{runs[0]['rounds']} / {runs[1]['rounds']} doubling rounds, peak device memory "
        f"{runs[0]['peak']} / {runs[1]['peak']} B; native SA-IS forward {native_s:.3f} s; "
        f"forward SA equal to native: {same_sa}; arrays that differ from the cached index: "
        f"{diff} ({card})")
    check(same_sa, "the device suffix array differs from native SA-IS")
    check(not diff, f"index --builder device differs from the cached index in {diff}")

    fm = load_index(idx).fwd
    t0 = time.time()
    wv = wavelet.WaveletRank(packing.unpack(fm.bwt_words, fm.n))
    dw = wavelet.to_device(wv, dev)
    fused = rank_ops.from_host(fm, dev)
    torch.cuda.synchronize()
    build_s = time.time() - t0
    wav_bytes = sum(t.numel() * 4 for t in (dw.l0_words, dw.l0_cp, dw.l1_words, dw.l1_cp))
    rng = np.random.default_rng(44)
    starts = rng.integers(0, codes.size - WAVELET_L, size=WAVELET_READS)
    reads = codes[starts[:, None] + np.arange(WAVELET_L)[None, :]].astype(np.int32)
    r = torch.from_numpy(reads).to(dev)
    ln = torch.full((WAVELET_READS,), WAVELET_L, dtype=torch.int32, device=dev)
    C = rank_ops._upload(fm.C, dev)

    def wav():
        return wavelet.exact_search_wavelet(dw, C, fm.primary, r, ln)

    def fused_search():
        return exact.exact_interval_search(fused, r, ln, max_len=WAVELET_L)

    lo_w, hi_w = wav()
    lo_f, hi_f = fused_search()
    same = torch.equal(lo_w, lo_f) and torch.equal(hi_w, hi_f)
    n_found = int((hi_f > lo_f).sum())
    ms_w = cuda_time_ms(wav, reps=3, hide_host=True)
    ms_f = cuda_time_ms(fused_search, reps=3, hide_host=True)
    walls = {}
    for name, fn in (("wavelet", wav), ("fused", fused_search)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls[name] = (time.perf_counter() - t0) * 1e3
    log(f"[17] wavelet rank over the forward BWT ({fm.n} symbols): built and uploaded in "
        f"{build_s:.1f} s, {wav_bytes} B on the card against {fused.blocks.numel() * 4} B of fused "
        f"rows; exact search of {WAVELET_READS} error-free {WAVELET_L} bp reads: wavelet "
        f"{ms_w:.3f} ms, fused rows {ms_f:.3f} ms (CUDA events, launches queued behind a device "
        f"sleep; host wall a call {walls['wavelet']:.3f} / {walls['fused']:.3f} ms) ({card}); "
        f"(lo, hi) equal on every read: {same}; {n_found} reads found")
    check(same, "exact_search_wavelet differs from the fused-row exact search")
    check(n_found == WAVELET_READS, "an error-free read was not found")


def dependent_step_us(torch, fwd, codes, card, tag) -> float:
    """The dependent-step latency, the latency floors' unit: one lane of
    the backward search over a read of CHAIN_L bases from the genome (alive
    through every step), in us a step."""
    import numpy as np

    from genome_weaver_align_tpu_torch.models import exact

    dev = fwd.blocks.device
    chain = codes[1_000_000:1_000_000 + CHAIN_L][None, :].astype(np.int32)
    chain = torch.from_numpy(np.where(chain >= 4, 0, chain)).to(dev)
    chain_ln = torch.full((1,), CHAIN_L, dtype=torch.int32, device=dev)
    lo, hi = exact.exact_interval_search(fwd, chain, chain_ln)
    check(int(hi[0] - lo[0]) >= 1, "the latency chain's read was not found")
    chain_ms = cuda_time_ms(lambda: exact.exact_interval_search(fwd, chain, chain_ln), reps=5)
    step_us = chain_ms * 1e3 / CHAIN_L
    log(f"{tag} one lane, {CHAIN_L} dependent backward steps: {chain_ms:.4f} ms, {step_us:.4f} us "
        f"a step: the latency floor's unit ({card})")
    return step_us


def phase_fm_kernels(torch, dev, codes, rep_codes, card) -> dict:
    """Each FM search kernel against its plain version on every output field
    (lo, hi, overflow and every slot), at each path's shape on the index
    that path uses, then at the edges; kernel, plain (device time and the
    eager loop's wall), bound and latency floor timed at each shape; the
    staircase and one-mismatch kernels also at every group size (lanes a
    pool or a read's case), with the live slots a staircase pool-step and
    case B's dead chains counted.  -> {entry: {"err", "ms", "plain_ms",
    "stage_ms", "bound", "floor_ms", "shape", and those counts}}."""
    import numpy as np

    from genome_weaver_align_tpu_torch import cli
    from genome_weaver_align_tpu_torch.index.files import load_index
    from genome_weaver_align_tpu_torch.index.kmer import build_kmer_table
    from genome_weaver_align_tpu_torch.models import bidirectional as bd
    from genome_weaver_align_tpu_torch.models import exact, one_mismatch, staircase, suffix_filter
    from genome_weaver_align_tpu_torch.ops import one_mismatch_cuda, rank, staircase_cuda
    from genome_weaver_align_tpu_torch.utils.simulate import simulate_reads_array

    def search_codes(r):
        return torch.from_numpy(np.where(r >= 4, 0, r).astype(np.int32)).to(dev)

    def both_strands(r):
        """Forward and reverse-complement search codes stacked, as tier 2
        and the staircase mode search them (uniform lengths)."""
        r = np.where(r >= 4, 0, r).astype(np.int32)
        return torch.from_numpy(np.concatenate([r, (3 - r)[:, ::-1]])).to(dev)

    def lens(n, length=L):
        return torch.full((n,), length, dtype=torch.int32, device=dev)

    def err_of(got, want) -> int:
        """Largest |difference| over every field (a differing flag is 1)."""
        check(len(got) == len(want), "the kernel returned another number of outputs")
        worst = 0
        for a, b in zip(got, want):
            check(a.shape == b.shape and a.dtype == b.dtype,
                  f"output {tuple(a.shape)} {a.dtype} against {tuple(b.shape)} {b.dtype}")
            if a.numel():
                worst = max(worst, int((a.long() - b.long()).abs().max()))
        return worst

    fm_tables = load_index(build_index(cli, codes)[0])
    fm = bd.from_host_bi(fm_tables.fwd, fm_tables.rev, dev)
    step_us = dependent_step_us(torch, fm.fwd, codes, card, "[18]")

    out = {"step_us": step_us}

    def live_extensions(plain, spine_with_slots):
        """``plain`` run once with ``rank.step_where`` counted.  Each plain
        loop advances its lanes through it once a sequential step; the
        active lanes there whose interval is not empty are the step's live
        extensions, two row fetches each, the only ones this run's data
        needs.  With ``spine_with_slots`` (the one-mismatch search) the
        update of a (B, S) slot pool is part of the step of the (B,) spine
        update just before it, and the second search's (case B's) slot
        updates also count each active read's distinct dead lo values (its
        dead chains, one row each for bit-equal outputs).  A (P, B, S)
        staircase pool update counts the live slots of each active pool
        that has any.  -> (outputs, live extensions, sequential steps with
        one or more, extra counts)."""
        real, counts, pools, chains = rank.step_where, [], [], []

        def counting(active, new, old):
            live = active & (old[1] > old[0])
            counts.append((int(live.sum()), old[0].dim() > 1))
            if old[0].dim() == 3:  # a staircase pool update
                per_pool = live.sum(-1)
                pools.append((int((per_pool > 0).sum()), int(per_pool.sum()),
                              int(per_pool.max()) if per_pool.numel() else 0))
            if spine_with_slots and old[0].dim() == 2:  # a one-mismatch slot update
                dead_lo = torch.where(active & (old[1] <= old[0]), old[0], -1)
                srt = dead_lo.sort(dim=1).values
                chains.append(int(((srt[:, 1:] != srt[:, :-1]) & (srt[:, 1:] >= 0)).sum()
                                  + (srt[:, 0] >= 0).sum()))
            return real(active, new, old)

        with mock.patch.object(rank, "step_where", counting):
            want = plain()
        steps, spine_live = 0, False
        for live, on_slots in counts:
            if spine_with_slots and on_slots:
                steps += live > 0 and not spine_live
            else:
                steps += live > 0
                spine_live = live > 0
        extra = {}
        if pools:
            busy = sum(n for n, _, _ in pools)
            extra = dict(nonempty_pool_steps=busy,
                         live_slots_mean=sum(n for _, n, _ in pools) / max(busy, 1),
                         live_slots_max=max(m for _, _, m in pools))
        if chains:
            extra = dict(dead_chains=sum(chains[len(chains) // 2:]))  # case B: the second search
        return want, sum(live for live, _ in counts), steps, extra

    def lane_sweep(name, binding, kernel, want):
        """The kernel at each group size (lanes a pool or a read's case),
        held against the plain outputs and timed; -> {lanes: ms}, empty for
        a checkout whose binding has no lane choice to sweep (one timed
        against this script by ``scripts/fm_kernels_ab.py``)."""
        times = {}
        if not hasattr(binding, "lanes_for"):
            return times
        for g in (1, 2, 4, 8, 16, 32):
            with mock.patch.object(binding, "lanes_for", lambda *shape, g=g: g):
                err = err_of(kernel(), want)
                check(err == 0, f"[18] {name}: the kernel with {g} lanes a group differs from "
                      f"its plain version by {err}")
                times[g] = cuda_time_ms(kernel, reps=10, hide_host=True)
        return times

    def measure(name, shape, kernel, plain, ops_per_row, io_bytes, spine_with_slots=False,
                binding=None):
        """Kernel against plain on every field, then timed; the bound counts
        the rows this run's data fetches (two a live extension) and the
        latency floor its sequential steps.  With ``binding`` the kernel is
        also held and timed at every group size."""
        got = kernel()
        want, live, steps, extra = live_extensions(plain, spine_with_slots)
        torch.cuda.synchronize()
        err = err_of(got, want)
        check(err == 0, f"[18] {name}: the kernel differs from its plain version by {err}")
        ms = cuda_time_ms(kernel, reps=20, hide_host=True)
        t0 = time.perf_counter()
        plain()
        torch.cuda.synchronize()
        stage_ms = (time.perf_counter() - t0) * 1e3
        plain_ms = cuda_time_ms(plain, reps=1, warmup=0, hide_host=True)
        rows = 2 * live
        b = bound(rows * FM_ROW_BYTES + io_bytes, rows * ops_per_row)
        floor_ms = steps * step_us / 1e3
        note = ""
        if "dead_chains" in extra:  # what bit-equal outputs force on top: a row a chain
            chains = extra["dead_chains"]
            b_chains = bound((rows + chains) * FM_ROW_BYTES + io_bytes,
                             rows * ops_per_row + chains * FM_OPS_PER_ROW_ONE)
            extra["bound_with_dead_chains_ms"] = b_chains[0]
            note = (f"; case B's distinct dead chains {chains} (a row each): bound with them "
                    f"{b_chains[0]:.4f} ms by {b_chains[1]}")
        if "live_slots_mean" in extra:
            note = (f"; live slots a non-empty active pool-step: mean "
                    f"{extra['live_slots_mean']:.4f}, max {extra['live_slots_max']} over "
                    f"{extra['nonempty_pool_steps']} pool-steps")
        if binding is not None and hasattr(binding, "lanes_for"):
            extra["lanes_ms"] = lane_sweep(name, binding, kernel, want)
            note += "; by lanes a group: " + ", ".join(
                f"{g} {t:.4f} ms" for g, t in extra["lanes_ms"].items())
        out[name] = dict(err=err, ms=ms, plain_ms=plain_ms, stage_ms=stage_ms, bound=b,
                         floor_ms=floor_ms, shape=shape, **extra)
        log(f"[18] {name} ({shape}): equal on every field; kernel {ms:.4f} ms, plain "
            f"{plain_ms:.3f} ms on the device, eager loop wall {stage_ms:.3f} ms; bound "
            f"{b[0]:.4f} ms by {b[1]} ({rows} row fetches); latency floor {floor_ms:.4f} ms "
            f"({steps} sequential steps){note} ({card})")

    def held(name, shape, kernel, plain):
        """The kernel against plain on every field once, then timed (no
        stage, bound or floor: the shapes measure() covers beside it)."""
        err = err_of(kernel(), plain())
        check(err == 0, f"[18] {name}: the kernel differs from its plain version by {err}")
        ms = cuda_time_ms(kernel, reps=20, hide_host=True)
        out[name] = dict(err=err, ms=ms, shape=shape)
        log(f"[18] {name} ({shape}): equal on every field; kernel {ms:.4f} ms ({card})")

    # ---- the backward search on the [4] index: -k 0's and [7]'s shapes
    t0 = time.time()
    tab = tuple(torch.from_numpy(a).to(dev) for a in build_kmer_table(fm_tables.fwd, FM_KMER_J))
    log(f"[18] {FM_KMER_J}-mer table in {time.time() - t0:.1f} s")
    exact_r, _, _, _ = simulate_reads_array(codes, EXACT_READS, L, seed=61, max_subs=0)
    piece_r, _, _, _ = simulate_reads_array(codes, BATCH, L, seed=71, max_subs=2)
    er, pr = search_codes(exact_r), search_codes(piece_r)
    for name, r, P, kw in (
        ("exact", er, 1, {}),
        (f"exact, {FM_KMER_J}-mer table", er, 1, dict(kmer_tab=tab, kmer_j=FM_KMER_J)),
        ("exact, max_len 60", er, 1, dict(max_len=60)),
        ("pieces", pr, K + 1, {}),
        (f"pieces, {FM_KMER_J}-mer table, full cover", pr, K + 1,
         dict(kmer_tab=tab, kmer_j=FM_KMER_J, kmer_full_cover=True)),
        ("pieces, max_len 20", pr, K + 1, dict(max_len=20)),
    ):
        ln = lens(r.shape[0])
        if P == 1:
            kernel = lambda r=r, ln=ln, kw=kw: exact.exact_interval_search(fm.fwd, r, ln, **kw)
            plain = lambda r=r, ln=ln, kw=kw: exact.exact_interval_search_plain(
                fm.fwd, r, ln, **kw)
        else:
            kernel = lambda r=r, ln=ln, kw=kw: suffix_filter.piece_interval_search(
                fm.fwd, r, ln, K + 1, **kw)
            plain = lambda r=r, ln=ln, kw=kw: suffix_filter.piece_interval_search_plain(
                fm.fwd, r, ln, K + 1, **kw)
        measure(name, f"{r.shape[0]} reads x {L}, P = {P}", kernel, plain, FM_OPS_PER_ROW_ONE,
                r.numel() * 4 + r.shape[0] * 4 + r.shape[0] * P * 8)

    # ---- the staircase: --mode staircase's shape on the [4] index
    def stair(bi, r, name, shape, **kw):
        """A narrowing pool takes a whole warp (no group size to sweep)."""
        ln = lens(r.shape[0])
        keep = kw.get("keep", 8)
        measure(name, shape, lambda: staircase.staircase_pools(bi, r, ln, K, **kw),
                lambda: staircase.staircase_pools_plain(bi, r, ln, K, **kw),
                FM_OPS_PER_ROW_ALL4, r.numel() * 4 + r.shape[0] * (4 + (K + 1) * (8 * keep + 1)),
                binding=None if kw.get("narrow_left") else staircase_cuda)

    mode_r, _, _, _ = simulate_reads_array(codes, MODE_READS, L, seed=11, max_subs=2)
    stair(fm, both_strands(mode_r), "staircase, --mode staircase",
          f"2 x {MODE_READS} lanes, k = {K}, 16 slots, keep 8")
    for n in MODE_SUBSETS:
        stair(fm, both_strands(mode_r[:n]), f"staircase, --mode staircase, {n} reads",
              f"2 x {n} lanes, k = {K}, 16 slots, keep 8")

    # ---- the one-mismatch search on the [4] index: --mode onemm's shape
    mm_r, _, _, _ = simulate_reads_array(codes, MODE_READS, L, seed=62, max_subs=1)

    def onemm(name, r):
        ln = lens(r.shape[0])
        measure(name, f"{r.shape[0]} reads x {L}, 48 slots",
                lambda: one_mismatch.one_mismatch_candidates(fm, r, ln),
                lambda: one_mismatch.one_mismatch_candidates_plain(fm, r, ln),
                FM_OPS_PER_ROW_ALL4, r.numel() * 4 + r.shape[0] * (4 + 97 * 8 + 1),
                spine_with_slots=True, binding=one_mismatch_cuda)

    mr = search_codes(mm_r)
    onemm("one-mismatch", mr)
    for n in ONEMM_SUBSETS:
        onemm(f"one-mismatch, {n} reads", mr[:n].contiguous())
    # past 64 slots
    if PAST_OLD_LIMITS:
        sub = mr[:max(ONEMM_SUBSETS)].contiguous()
        ln = lens(sub.shape[0])
        for n_slots in WIDE_MM_SLOTS:
            (measure if n_slots == WIDE_MM_SLOTS[-1] else held)(
                    f"one-mismatch, {n_slots} slots",
                    f"{sub.shape[0]} reads x {L}, {n_slots} slots",
                    lambda n_slots=n_slots: one_mismatch.one_mismatch_candidates(
                        fm, sub, ln, n_slots=n_slots),
                    lambda n_slots=n_slots: one_mismatch.one_mismatch_candidates_plain(
                        fm, sub, ln, n_slots=n_slots),
                    *((FM_OPS_PER_ROW_ALL4,
                       sub.numel() * 4 + sub.shape[0] * (4 + (2 * n_slots + 1) * 8 + 1))
                      if n_slots == WIDE_MM_SLOTS[-1] else ()))

    # ---- edges on the [4] index: reads of length 0, 1 and < P, N codes
    # mapped to 0, a 1-slot pool (it overflows every step), keep 1
    rng = np.random.default_rng(18)
    edge = piece_r[:512].copy()
    edge[rng.random(edge.shape) < 0.02] = 4
    er_e = search_codes(edge)
    eln = torch.from_numpy(np.concatenate([[0, 1, 2], rng.integers(3, L + 1, size=len(edge) - 3)])
                           .astype(np.int32)).to(dev)
    edge_cases = [
        ("exact", lambda: exact.exact_interval_search(fm.fwd, er_e, eln),
         lambda: exact.exact_interval_search_plain(fm.fwd, er_e, eln)),
        ("exact, table", lambda: exact.exact_interval_search(fm.fwd, er_e, eln, 40, tab, FM_KMER_J),
         lambda: exact.exact_interval_search_plain(fm.fwd, er_e, eln, 40, tab, FM_KMER_J)),
        ("pieces", lambda: suffix_filter.piece_interval_search(fm.fwd, er_e, eln, K + 1),
         lambda: suffix_filter.piece_interval_search_plain(fm.fwd, er_e, eln, K + 1)),
        ("staircase, 1 slot", lambda: staircase.staircase_pools(fm, er_e, eln, K, n_slots=1),
         lambda: staircase.staircase_pools_plain(fm, er_e, eln, K, n_slots=1)),
        ("staircase, narrow, keep 1",
         lambda: staircase.staircase_pools(fm, er_e, eln, K, narrow_left=True, keep=1),
         lambda: staircase.staircase_pools_plain(fm, er_e, eln, K, narrow_left=True, keep=1)),
        ("one-mismatch, 1 slot", lambda: one_mismatch.one_mismatch_candidates(fm, er_e, eln,
                                                                               n_slots=1),
         lambda: one_mismatch.one_mismatch_candidates_plain(fm, er_e, eln, n_slots=1)),
    ]
    flags = {}
    for name, kernel, plain in edge_cases:
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        check(err_of(got, want) == 0, f"[18] edge case {name}: the kernel differs from plain")
        if name.endswith("1 slot"):
            flags[name] = int(want[-1].sum())
    log(f"[18] edges (512 reads, lengths 0, 1, 2 and ragged, 2% N codes mapped to 0): exact, "
        f"exact with the table and max_len 40, pieces, the staircase with 1 slot and narrowed "
        f"with keep 1, the one-mismatch search with 1 slot: equal on every field; overflow "
        f"flags of the 1-slot pools {flags}")
    check(all(v > 0 for v in flags.values()), "a 1-slot pool never overflowed")
    del fm, fm_tables, tab, er, pr, mr, er_e
    torch.cuda.empty_cache()

    # ---- the staircase on the [12] repeat index: one tier-2 call's shape
    # and the multi-part rescue's (64 slots, narrow_left)
    rep = load_index(build_index(cli, rep_codes, f"repeat_{GENOME_LEN}_seed{REPEAT_SEED}",
                                 "chr20rep")[0])
    rbi = bd.from_host_bi(rep.fwd, rep.rev, dev)
    coh, _, _, _ = simulate_reads_array(rep_codes, STAIR_COHORT, L, seed=13, max_subs=2)
    cr = both_strands(coh)
    stair(rbi, cr, "staircase, tier-2 call", f"2 x {STAIR_COHORT} lanes, k = {K}, 16 slots, "
          "keep 8, repeat index")
    stair(rbi, cr, "staircase, rescue", f"2 x {STAIR_COHORT} lanes, k = {K}, {RESCUE_SLOTS} "
          "slots, narrow_left, keep 8, repeat index", n_slots=RESCUE_SLOTS, narrow_left=True)
    coh, _, _, _ = simulate_reads_array(rep_codes, max(STAIR_COHORTS), L, seed=14, max_subs=2)
    for n in STAIR_COHORTS:
        stair(rbi, both_strands(coh[:n]), f"staircase, tier-2 call, {n} reads",
              f"2 x {n} lanes, k = {K}, 16 slots, keep 8, repeat index")
    chunk = both_strands(coh[:RESCUE_CHUNK])
    for narrow in (False, True):
        stair(rbi, chunk, f"staircase, rescue chunk{', narrow_left' * narrow}",
              f"2 x {RESCUE_CHUNK} lanes, k = {K}, {RESCUE_SLOTS} slots"
              f"{', narrow_left' * narrow}, keep 8, repeat index", n_slots=RESCUE_SLOTS,
              narrow_left=narrow)
    # past 64 slots (a narrowing step counts before it places): the
    # tier-2 cohort, both orders, the binding's lanes (a warp here), no sweep
    if PAST_OLD_LIMITS:
        for n_slots in WIDE_SLOTS:
            for narrow in (False, True):
                ln = lens(cr.shape[0])
                kw = dict(n_slots=n_slots, narrow_left=narrow)
                row = n_slots == WIDE_SLOTS[1] and narrow  # the kernels line's shape
                (measure if row else held)(
                    f"staircase, {n_slots} slots{', narrow_left' * narrow}",
                    f"2 x {STAIR_COHORT} lanes, k = {K}, {n_slots} slots"
                    f"{', narrow_left' * narrow}, keep 8, repeat index",
                    lambda kw=kw, ln=ln: staircase.staircase_pools(rbi, cr, ln, K, **kw),
                    lambda kw=kw, ln=ln: staircase.staircase_pools_plain(rbi, cr, ln, K, **kw),
                    *((FM_OPS_PER_ROW_ALL4, cr.numel() * 4 + cr.shape[0] * (4 + (K + 1) * 65))
                      if row else ()))
    del rbi, rep, cr, chunk
    torch.cuda.empty_cache()
    return out


def walk_sass(locate_cuda) -> dict:
    """The SASS of each locate kernel's LF step: the smallest loop that
    loads from global memory (the step reads its row and mark block; a
    thread's loop over its rows holds the step loop), its instructions,
    the inner loops it holds (owner scans) and the most frequent opcodes."""
    from collections import Counter

    lib = locate_cuda._library()
    out = {}
    for kernel, name in (("13locate_kernel", "locate"), ("21locate_sharded_kernel", "sharded")):
        fn, loops = sass_loops(lib, [kernel])
        steps = [lp for lp in loops if any(op.startswith("LDG") for _, op, _, _ in lp)]
        if not steps:
            out[name] = {"kernel": fn, "instructions": None}
            continue
        step = min(steps, key=len)
        inner = [lp for lp in loops if len(lp) < len(step) and lp[0][0] >= step[0][0]
                 and lp[-1][0] <= step[-1][0]]
        in_inner = {i[0] for lp in inner for i in lp}
        top = ", ".join(f"{op} {c}" for op, c in Counter(op.split(".")[0] for _, op, _, _ in step)
                        .most_common(10))
        out[name] = {"kernel": fn, "instructions": len(step), "inner_loops": len(inner),
                     "outside_inner_loops": len(step) - len(in_inner), "opcodes": top}
    return out


def phase_locate(torch, dev, codes, rep_codes, card, step_us=None, edges=True) -> dict:
    """[19] The locate kernel, the sharded locate and the sharded piece
    search, each held against its plain version on every element at each
    path's shape, with the inputs the path itself gives them (captured from
    the path's own functions on this run's reads), then timed: kernel,
    plain (device time), the eager loop's wall (stage), bound and latency
    floor, with the persistent grid the locate binding chose; both locates
    on subsets of [7]'s rows (SWEEP_ROWS); the SASS of their loops.  With
    ``edges`` (the smoke; ``scripts/fm_kernels_ab.py --phase locate``
    leaves them out): every row kind at the edges (row 0, the primary row,
    n) and 65,536 random rows over S = 1..16 shards and on hand-made
    unequal bounds, and the FM sharded align step's device events with the
    kernels and with the plain loops.  -> {case: {"err", "ms", "plain_ms",
    "stage_ms", "bound", "floor_ms", "shape", "grid"}}, "sweep", "sass" and
    (edges) the step's "events"."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from genome_weaver_align_tpu_torch import cli
    from genome_weaver_align_tpu_torch.index.files import load_index
    from genome_weaver_align_tpu_torch.models import bidirectional as bd
    from genome_weaver_align_tpu_torch.models import exact, staircase, suffix_filter
    from genome_weaver_align_tpu_torch.ops import locate_cuda, rank
    from genome_weaver_align_tpu_torch.parallel import mesh as pmesh
    from genome_weaver_align_tpu_torch.parallel import sharded_index as si
    from genome_weaver_align_tpu_torch.parallel import sharded_pipeline as sp
    from genome_weaver_align_tpu_torch.utils.simulate import simulate_reads_array

    out = {}

    def capture(mod, attr, call):
        """The arguments of the first call of ``mod.attr`` inside ``call()``."""
        seen, real = [], getattr(mod, attr)

        def spy(*a, **kw):
            seen.append(a)
            return real(*a, **kw)

        with mock.patch.object(mod, attr, spy):
            call()
        torch.cuda.synchronize()
        check(bool(seen), f"[19] the path never called {attr}")
        return seen[0]

    def err_of(got, want) -> int:
        got, want = (got if isinstance(got, tuple) else (got,)), (
            want if isinstance(want, tuple) else (want,))
        worst = 0
        for a, b in zip(got, want):
            check(a.shape == b.shape and a.dtype == b.dtype,
                  f"output {tuple(a.shape)} {a.dtype} against {tuple(b.shape)} {b.dtype}")
            if a.numel():
                worst = max(worst, int((a.long() - b.long()).abs().max()))
        return worst

    def walk(fm, rows):
        """The plain walk, counted: its LF steps, the longest walk, and the
        distinct fused rows and mark blocks it reads (each read once is the
        least a walk must move: neighbouring rows of one interval share
        their blocks), and the distinct checkpoints and sampled values."""
        i, d = rows.reshape(-1).to(torch.int32), torch.zeros(rows.numel(), dtype=torch.int32,
                                                              device=rows.device)
        fused, marks = [], [i >> 7]
        for _ in range(fm.sample_rate):
            marked = rank._mark_get(fm, i)
            live = i[~marked]
            fused.append((live - (live > fm.primary).to(torch.int32)) >> 7)
            i = torch.where(marked, i, rank.lf_fused(fm, i))
            d += (~marked).to(torch.int32)
            marks.append(i[~marked] >> 7)

        def distinct(parts):
            return int(torch.unique(torch.cat(parts)).numel()) if parts else 0

        return dict(steps=int(d.sum()), longest=int(d.max()) if d.numel() else 0,
                    rows=distinct(fused), marks=distinct(marks), cps=distinct([i >> 7]),
                    values=distinct([i]))

    def locate_bound(w, Q):
        """The distinct 48-byte fused rows and 16-byte mark blocks the walks
        read, a 4-byte checkpoint and sampled value each distinct end row,
        the rows in and the positions out; the integer work of every LF
        step and rank1."""
        return bound(w["rows"] * FM_ROW_BYTES + w["marks"] * MARK_BLOCK_BYTES
                     + (w["cps"] + w["values"]) * 4 + Q * 8,
                     w["steps"] * (FM_OPS_PER_ROW_ONE + LF_STEP_OPS) + Q * RANK1_OPS)

    def grid_of(rows, sharded) -> str:
        grid, cap = locate_cuda.launch_shape(rows.numel(), rows.device, sharded)
        return f"{grid} blocks of 256 threads (capacity {cap} walks)"

    def timed(name, shape, kernel, plain, b, chain, grid=""):
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        err = err_of(got, want)
        check(err == 0, f"[19] {name}: the kernel differs from its plain version by {err}")
        ms = cuda_time_ms(kernel, reps=20, hide_host=True)
        t0 = time.perf_counter()
        plain()
        torch.cuda.synchronize()
        stage_ms = (time.perf_counter() - t0) * 1e3
        plain_ms = cuda_time_ms(plain, reps=1, warmup=0, hide_host=True)
        floor_ms = chain * step_us / 1e3
        out[name] = dict(err=err, ms=ms, plain_ms=plain_ms, stage_ms=stage_ms, bound=b,
                         floor_ms=floor_ms, shape=shape, grid=grid)
        log(f"[19] {name} ({shape}{'; ' + grid if grid else ''}): equal on every element; "
            f"kernel {ms:.4f} ms, plain {plain_ms:.3f} ms on the device, eager loop wall "
            f"{stage_ms:.3f} ms; bound {b[0]:.4f} ms by {b[1]}; latency floor {floor_ms:.4f} ms "
            f"({chain} dependent loads) ({card})")

    def locate_case(name, path_fm, rows, kernel, plain, sharded):
        """The floor: the longest walk's dependent loads (a row and its mark
        block together a step, the first mark block, the checkpoint, the
        sampled value)."""
        w = walk(path_fm, rows)
        Q = rows.numel()
        shape = (f"{Q} rows, sample_rate {path_fm.sample_rate}, {w['steps'] / max(Q, 1):.4f} LF "
                 f"steps a row, longest {w['longest']}, {w['rows']} distinct fused rows, "
                 f"{w['marks']} distinct mark blocks")
        timed(name, shape, kernel, plain, locate_bound(w, Q), w["longest"] + 3,
              grid_of(rows, sharded))

    # ---- the [4] index: [7]'s and [13]'s rows, [10]'s, and the [11] shards
    gi = load_index(build_index(cli, codes)[0])
    fm = rank.from_host(gi.fwd, dev)
    if step_us is None:
        step_us = dependent_step_us(torch, fm, codes, card, "[19]")
    out["sass"] = walk_sass(locate_cuda)
    for kind, v in out["sass"].items():
        log(f"[19] SASS of the {kind} kernel's LF step loop ({v['kernel']}): "
            + (f"{v['instructions']} instructions, {v['outside_inner_loops']} of them outside "
               f"its {v['inner_loops']} inner loops; {v['opcodes']}"
               if v["instructions"] else "not found"))
    lens = torch.full((BATCH,), L, dtype=torch.int32, device=dev)
    piece_r, _, _, _ = simulate_reads_array(codes, BATCH, L, seed=71, max_subs=2)
    pr = torch.from_numpy(np.where(piece_r >= 4, 0, piece_r).astype(np.int32)).to(dev)
    rows7 = capture(rank, "locate", lambda: suffix_filter.pigeonhole_candidates(
        fm, pr, lens, K + 1, max_hits=8))[1]
    locate_case("locate, [7] FM pigeonhole", fm, rows7, lambda: rank.locate(fm, rows7),
                lambda: rank.locate_plain(fm, rows7), False)
    exact_r, _, _, _ = simulate_reads_array(codes, EXACT_READS, L, seed=61, max_subs=0)
    er = torch.from_numpy(exact_r.astype(np.int32)).to(dev)
    lo, hi = exact.exact_interval_search(fm, er, lens[:EXACT_READS])
    rows13 = capture(rank, "locate", lambda: exact.locate_hits(fm, lo, hi, 1))[1]
    locate_case("locate, [13] -k 0", fm, rows13, lambda: rank.locate(fm, rows13),
                lambda: rank.locate_plain(fm, rows13), False)

    sh = si.put_sharded(si.shard_fm_index(gi.fwd, SHARDS), dev)
    layout = pmesh.make_layout(1, SHARDS, dev)
    tx = sp.put_text(sp.shard_text(gi.fwd.text_words, gi.fwd.n, SHARDS), dev)
    step = sp.make_sharded_pigeonhole_align(layout, like_index=sh,
                                            like_text=tx, max_len=L, k=K, max_hits=8)
    sf_r, _, _, _ = simulate_reads_array(codes, SHARDED_FM_READS, L, seed=52, max_subs=2)
    sr = torch.from_numpy(np.where(sf_r >= 4, 0, sf_r).astype(np.int32)).to(dev)
    sln = lens[:SHARDED_FM_READS]
    rows11 = capture(si, "locate", lambda: step(sh, tx, sr, sln))[1]
    locate_case(f"sharded locate, [11] S = {SHARDS}", fm, rows11, lambda: si.locate(sh, rows11),
                lambda: si.locate_plain(sh, rows11), True)
    _, r10, ln10 = sharded_search_reads(codes, layout)
    search10 = si.make_sharded_exact_search(layout, L, sh)
    rows10 = capture(si, "locate", lambda: search10(sh, r10, ln10))[1]
    locate_case(f"sharded locate, [10] S = {SHARDS}", fm, rows10, lambda: si.locate(sh, rows10),
                lambda: si.locate_plain(sh, rows10), True)

    # both locates on subsets of [7]'s rows: time against row count
    sweep = {}
    flat7 = rows7.reshape(-1)
    for N in SWEEP_ROWS:
        r = flat7[:N].contiguous()
        want = rank.locate_plain(fm, r)
        check(err_of(rank.locate(fm, r), want) == 0 and err_of(si.locate(sh, r), want) == 0,
              f"[19] a locate differs from its plain version on {N} of [7]'s rows")
        b = locate_bound(walk(fm, r), N)
        res = {"bound": b[0], "bound_by": b[1],
               "locate": cuda_time_ms(lambda r=r: rank.locate(fm, r), reps=20, hide_host=True),
               "sharded": cuda_time_ms(lambda r=r: si.locate(sh, r), reps=20, hide_host=True)}
        sweep[N] = res
        log(f"[19] sweep, the first {N} of [7]'s rows: locate {res['locate']:.4f} ms, sharded "
            f"{res['sharded']:.4f} ms, bound {b[0]:.4f} ms by {b[1]} ({card})")
    out["sweep"] = sweep

    # the sharded piece search: two 48-byte rows a live extension, counted
    # where the plain loop advances its lanes (rank.step_where)
    real, live, steps = rank.step_where, [0], [0]

    def counting(active, new, old):
        n_live = int((active & (old[1] > old[0])).sum())
        live[0] += n_live
        steps[0] += n_live > 0
        return real(active, new, old)

    with mock.patch.object(rank, "step_where", counting):
        sp.sharded_piece_search_plain(sh, sr, sln, K + 1, L)
    P = K + 1
    timed(f"sharded piece search, [11] S = {SHARDS}",
          f"{SHARDED_FM_READS} reads x {L}, P = {P}, {live[0]} live extensions",
          lambda: sp.sharded_piece_search(sh, sr, sln, P, L),
          lambda: sp.sharded_piece_search_plain(sh, sr, sln, P, L),
          bound(2 * live[0] * FM_ROW_BYTES + sr.numel() * 4 + SHARDED_FM_READS * (4 + 8 * P),
                2 * live[0] * FM_OPS_PER_ROW_ONE), steps[0])

    # the same launches with every shard in its own allocation: the kernels'
    # other instantiation (one base pointer a shard, from a device table),
    # the layout of shards mapped from other processes ([20])
    ap = own_allocations(sh)
    out["apart"] = {}
    for name, on in ((f"sharded locate, [11] S = {SHARDS}", lambda t: si.locate(t, rows11)),
                     (f"sharded locate, [10] S = {SHARDS}", lambda t: si.locate(t, rows10)),
                     (f"sharded piece search, [11] S = {SHARDS}",
                      lambda t: sp.sharded_piece_search(t, sr, sln, P, L))):
        check(err_of(on(ap), on(sh)) == 0,
              f"[19] {name}: separate allocations differ from the stacked tables")
        out["apart"][name] = cuda_time_ms(lambda: on(ap), reps=20, hide_host=True)
        log(f"[19] {name}, every shard in its own allocation: equal to the stacked launch; "
            f"{out['apart'][name]:.4f} ms against {out[name]['ms']:.4f} ms stacked ({card})")
    del ap

    if edges:
        # the FM sharded step's device events, with the kernels and with the
        # plain loops in their place
        events = {}
        for how in ("kernels", "plain loops"):
            with contextlib.ExitStack() as stack:
                if how == "plain loops":
                    stack.enter_context(mock.patch.object(sp, "sharded_piece_search",
                                                          sp.sharded_piece_search_plain))
                    stack.enter_context(mock.patch.object(si, "locate", si.locate_plain))
                step(sh, tx, sr, sln)
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    step(sh, tx, sr, sln)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
            n_ev, busy_s, _ = device_busy(torch, prof)
            events[how] = n_ev
            log(f"[19] one FM sharded align step ([11], {SHARDED_FM_READS} reads, S = {SHARDS}) "
                f"with the {how}: {n_ev} device events, busy {busy_s * 1e3:.3f} ms of "
                f"{wall * 1e3:.3f} ms ({card})")
        out["events"] = events
        check(0 < events["kernels"] < events["plain loops"],
              "the sharded step with the kernels ran no fewer device events than with the loops")

        # ---- edges: row 0, the primary row, n (twice: a row clamped from
        # n + 1) and 65,536 random rows, one index, S = 1..16 shards and the
        # hand-made unequal bounds
        gen = torch.Generator(device=dev).manual_seed(19)
        edge = torch.cat([torch.tensor([0, gi.fwd.primary, gi.fwd.n, gi.fwd.n],
                                       dtype=torch.int32, device=dev),
                          torch.randint(0, gi.fwd.n + 1, (65_536,), generator=gen, device=dev,
                                        dtype=torch.int32)])
        want = rank.locate_plain(fm, edge)
        check(err_of(rank.locate(fm, edge), want) == 0, "[19] locate differs at the edges")
        qk = torch.randint(0, gi.fwd.n + 2, (65_536,), generator=gen, device=dev,
                           dtype=torch.int32)
        qc = torch.randint(0, 4, (65_536,), generator=gen, device=dev, dtype=torch.int32)

        def apart_equal(shs, tag):
            """The three sharded kernels with each shard in its own
            allocation: equal to the stacked launch and the plain versions."""
            ap = own_allocations(shs)
            check(err_of(si.locate(ap, edge), want) == 0,
                  f"[19] the sharded locate on separate allocations differs, {tag}")
            check(err_of(sp.sharded_piece_search(ap, sr[:2048], sln[:2048], P, L),
                         sp.sharded_piece_search_plain(shs, sr[:2048], sln[:2048], P, L)) == 0,
                  f"[19] the sharded piece search on separate allocations differs, {tag}")
            fused = si.fused_occ_plain(shs, qc, qk)
            check(err_of(si.fused_occ(ap, qc, qk), fused) == 0 and
                  err_of(si.fused_occ(shs, qc, qk), fused) == 0,
                  f"[19] the fused table entry differs from its plain version, {tag}")

        done = []
        for S in range(1, 17):
            shs = si.put_sharded(si.shard_fm_index(gi.fwd, S), dev)
            check(err_of(si.locate(shs, edge), want) == 0 and
                  err_of(si.locate_plain(shs, edge[:4096]), want[:4096]) == 0,
                  f"[19] the sharded locate differs at the edges, S = {S}")
            check(err_of(sp.sharded_piece_search(shs, sr[:2048], sln[:2048], P, L),
                         sp.sharded_piece_search_plain(shs, sr[:2048], sln[:2048], P, L)) == 0,
                  f"[19] the sharded piece search differs from its plain loop, S = {S}")
            apart_equal(shs, f"S = {S}")
            done.append(S)
            del shs
        # 4 shards cut at unequal block counts of both coordinates (one of
        # 1,000 packed blocks, one of 100 mark blocks)
        nb, mb = gi.fwd.bwt_words.size // 8, gi.fwd.ssa_marks._wpad.size // 4
        uneq = si.put_sharded(si.shard_fm_index(
            gi.fwd, 4, [0, nb // 12, nb // 12 + 1_000, 2 * nb // 3, nb],
            [0, mb // 2, mb // 2 + 100, 3 * mb // 4, mb]), dev)
        check(err_of(si.locate(uneq, edge), want) == 0 and
              err_of(si.locate_plain(uneq, edge[:4096]), want[:4096]) == 0,
              "[19] the sharded locate differs on the unequal shard bounds")
        check(err_of(sp.sharded_piece_search(uneq, sr[:2048], sln[:2048], P, L),
                     sp.sharded_piece_search_plain(uneq, sr[:2048], sln[:2048], P, L)) == 0,
              "[19] the sharded piece search differs on the unequal shard bounds")
        apart_equal(uneq, "unequal bounds")
        bounds = [(int(a), int(b)) for a, b in zip(uneq.row_start, uneq.row_end)]
        # past 16 shards, the equal split and WIDE_SHARDS unequal shards
        t_wide = time.time()
        wide_launches = {}
        rng = np.random.default_rng(191)
        cuts = [sorted(int(x) for x in rng.integers(0, m + 1, size=WIDE_SHARDS - 1))
                for m in (nb, mb)]
        wides = [(S, None) for S in WIDE_SHARD_COUNTS] + [
            (WIDE_SHARDS, ([0, *cuts[0], nb], [0, *cuts[1], mb]))]
        for S, cut in wides:
            tag = f"S = {S}{', unequal' if cut else ''}"
            shs = si.put_sharded(si.shard_fm_index(gi.fwd, S, *(cut or ())), dev)
            locate_cuda.locate_sharded_cuda.launches = 0
            check(err_of(si.locate(shs, edge), want) == 0 and
                  err_of(si.locate_plain(shs, edge[:4096]), want[:4096]) == 0,
                  f"[19] the sharded locate differs at the edges, {tag}")
            check(err_of(sp.sharded_piece_search(shs, sr[:2048], sln[:2048], P, L),
                         sp.sharded_piece_search_plain(shs, sr[:2048], sln[:2048], P, L)) == 0,
                  f"[19] the sharded piece search differs from its plain loop, {tag}")
            apart_equal(shs, tag)
            wide_launches[tag] = locate_cuda.locate_sharded_cuda.launches
            del shs
        check(all(n == 2 for n in wide_launches.values()),
              f"[19] the sharded locate did not launch its kernel at every S: {wide_launches}")
        log(f"[19] past 16 shards, {list(wide_launches)}: the sharded locate at the edges equal "
            f"to the one-index plain loop (and its own plain loop on 4,096 rows), the sharded "
            f"piece search on 2,048 reads equal to its plain loop, stacked and with every shard "
            f"in its own allocation, the fused table entry too; {time.time() - t_wide:.1f} s")
        # the [11] shapes at WIDE_SHARDS shards, stacked and one allocation a
        # shard, beside the S = SHARDS times above
        wsh = si.put_sharded(si.shard_fm_index(gi.fwd, WIDE_SHARDS), dev)
        wap = own_allocations(wsh)
        for rows, tag in ((rows11, "[11]"), (rows10, "[10]")):
            locate_case(f"sharded locate, {tag} S = {WIDE_SHARDS}", fm, rows,
                        lambda rows=rows: si.locate(wsh, rows),
                        lambda rows=rows: si.locate_plain(wsh, rows), True)
        timed(f"sharded piece search, [11] S = {WIDE_SHARDS}",
              f"{SHARDED_FM_READS} reads x {L}, P = {P}, {live[0]} live extensions",
              lambda: sp.sharded_piece_search(wsh, sr, sln, P, L),
              lambda: sp.sharded_piece_search_plain(wsh, sr, sln, P, L),
              out[f"sharded piece search, [11] S = {SHARDS}"]["bound"], steps[0])
        out["apart"].update({
            f"sharded locate, [11] S = {WIDE_SHARDS}": cuda_time_ms(
                lambda: si.locate(wap, rows11), reps=20, hide_host=True),
            f"sharded piece search, [11] S = {WIDE_SHARDS}": cuda_time_ms(
                lambda: sp.sharded_piece_search(wap, sr, sln, P, L), reps=20, hide_host=True)})
        log(f"[19] {WIDE_SHARDS} shards, one allocation a shard: sharded locate on [11]'s rows "
            f"{out['apart'][f'sharded locate, [11] S = {WIDE_SHARDS}']:.4f} ms, sharded piece "
            f"search {out['apart'][f'sharded piece search, [11] S = {WIDE_SHARDS}']:.4f} ms "
            f"({card})")
        del wsh, wap
        log(f"[19] edges (row 0, the primary row, n twice, 65,536 random rows): locate equal to "
            f"its plain loop; the sharded locate equal to the one-index plain loop at S = {done} "
            f"and on unequal row bounds {bounds} (and its own plain loop on 4,096 of them); the "
            f"sharded piece search on 2,048 reads equal to its plain loop at each S; with every "
            f"shard in its own allocation, the sharded locate, the piece search and the fused "
            f"table entry (65,536 random queries) equal to the plain versions at each S and on "
            f"the unequal bounds")
        del uneq, edge
    del gi, fm, sh, tx, pr, er, sr, r10, ln10
    torch.cuda.empty_cache()

    # ---- the [12] repeat index: a tier-2 call's rows
    rep = load_index(build_index(cli, rep_codes, f"repeat_{GENOME_LEN}_seed{REPEAT_SEED}",
                                 "chr20rep")[0])
    rbi = bd.from_host_bi(rep.fwd, rep.rev, dev)
    coh, _, _, _ = simulate_reads_array(rep_codes, STAIR_COHORT, L, seed=13, max_subs=2)
    coh = np.where(coh >= 4, 0, coh).astype(np.int32)
    cr = torch.from_numpy(np.concatenate([coh, (3 - coh)[:, ::-1]])).to(dev)
    rows12 = capture(rank, "locate", lambda: staircase.staircase_filter_candidates(
        rbi, cr, lens[:cr.shape[0]], K))[1]
    locate_case("locate, [12] tier-2 call", rbi.fwd, rows12, lambda: rank.locate(rbi.fwd, rows12),
                lambda: rank.locate_plain(rbi.fwd, rows12), False)
    del rbi, rep, cr
    torch.cuda.empty_cache()
    return out


def own_allocations(sh):
    """``sh`` with each shard of each sharded table copied to an allocation
    of its own (``peer.Shards``): one base pointer a shard, as a shard
    mapped from another process is."""
    import dataclasses

    from genome_weaver_align_tpu_torch.parallel import peer
    from genome_weaver_align_tpu_torch.parallel import sharded_index as si

    return dataclasses.replace(sh, **{
        f: peer.Shards([t.clone() for t in getattr(sh, f)], getattr(sh, f))
        for f in si._TABLES})


def kernel_row(name, source, replaces, path, launches, max_err, timing, **extra) -> dict:
    """One entry of the ``kernels`` line; ``path`` names the run whose
    launches are counted."""
    ms, plain_ms, bound_ms, bound_by, library_ms = timing
    return {"name": name, "route": "cuda", "source": f"genome_weaver_align_tpu_torch/csrc/{source}",
            "replaces": replaces if replaces.startswith("none") else
            f"genome_weaver_align_tpu/{replaces}", "path": path,
            "launches": launches, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms, **extra}


def fm_rows(fm_k, fm_cli_launches, tier2_staircase, mode_launches, mp_launches) -> list:
    """The ``kernels`` line's rows of the three FM search kernels: one for
    each entry at each path's shape, with the launches of every path that
    runs it (each count set to 0 just before that path and read just
    after), the eager loop's wall (``stage_ms``) and the latency floor."""
    def row(name, source, replaces, entry, path, launches, by_path):
        r = fm_k[entry]
        extra = {key: r[key] for key in ("dead_chains", "bound_with_dead_chains_ms",
                                         "live_slots_mean", "live_slots_max", "lanes_ms")
                 if key in r}
        return kernel_row(name, source, replaces, path, launches, r["err"],
                          (r["ms"], r["plain_ms"], *r["bound"], None), stage_ms=r["stage_ms"],
                          latency_floor_ms=r["floor_ms"], shape=r["shape"],
                          launches_by_path=by_path, **extra)

    back = {"[7] align (FM pigeonhole pieces)": fm_cli_launches,
            "[13] align -k 0": mode_launches["-k 0"]["backward"]}
    stair = {"[12] tier 2 (repeat genome)": tier2_staircase,
             "[13] align --mode staircase -k 2": mode_launches["--mode staircase -k 2"]["staircase"],
             **{f"[15] multi-part rescue, tier {t}": n for t, n in mp_launches["staircase"].items()},
             **{f"[15] multi-part repeat rescue, tier {t}": n
                for t, n in mp_launches["repeat_staircase"].items()}}
    onemm = {"[13] align --mode onemm": mode_launches["--mode onemm"]["one-mismatch"]}
    return [
        row("fm_backward_search_exact", "fm_search.cu", "models/exact.py:65", "exact",
            "[13] align -k 0", back["[13] align -k 0"], back),
        row("fm_backward_search_pieces", "fm_search.cu", "models/suffix_filter.py:123", "pieces",
            "[7] align (FM pigeonhole pieces)", fm_cli_launches, back),
        row("staircase_tier2", "staircase.cu", "models/staircase.py:215",
            "staircase, tier-2 call", "[12] tier 2 (repeat genome)", tier2_staircase, stair),
        row("staircase_mode", "staircase.cu", "models/staircase.py:215",
            "staircase, --mode staircase", "[13] align --mode staircase -k 2",
            stair["[13] align --mode staircase -k 2"], stair),
        row("staircase_rescue", "staircase.cu", "models/staircase.py:235", "staircase, rescue",
            "[15] multi-part repeat rescue, tiers A and B",
            sum(mp_launches["repeat_staircase"].values()), stair),
        row("one_mismatch", "one_mismatch.cu", "models/one_mismatch.py:127", "one-mismatch",
            "[13] align --mode onemm", onemm["[13] align --mode onemm"], onemm),
        row("staircase_wide", "staircase.cu", "models/staircase.py:235",
            f"staircase, {WIDE_SLOTS[1]} slots, narrow_left",
            "none: no path takes more than 64 slots (the API does)", 0, {}),
        row("one_mismatch_wide", "one_mismatch.cu", "models/one_mismatch.py:127",
            f"one-mismatch, {WIDE_MM_SLOTS[-1]} slots",
            "none: no path takes more than 64 slots (the API does)", 0, {}),
    ]

def across_cards_bound(local_bytes: float, remote_bytes: float) -> tuple[float, str]:
    """(least ms, what sets it) of a function that moves ``local_bytes``
    in this card's memory and ``remote_bytes`` over NVLink from other
    cards: whichever takes longer."""
    t_local = local_bytes / PEAK_BYTES_PER_S * 1e3
    t_remote = remote_bytes / NVLINK_BYTES_PER_S * 1e3
    return (t_remote, "bytes over NVLink") if t_remote > t_local else (t_local, "bytes")


def flag_wait_row(wait20, timings20, launches20) -> dict:
    """The flag-wait ring entry's row: where [20]'s 4 ranks had a card
    each, one merge of the exact search's step timed in the ranks (the
    prepared launch back to back, the skew between ranks included; beside
    it synchronised every merge, and its host ms a call), bounded by this
    rank's row pushed to the 3 peers over NVLink or the 4 rows read and the
    sum written on this card, with NCCL's ``all_reduce`` of the same
    payload as the library call (also synchronised every merge) and gloo's
    beside it; on one card the prepared launch with the peers' flags
    pre-published ([20] one card)."""
    run = f"[20] exact, merge=ring, rank 0 of {INTERVAL_RANKS[-1]}"
    ms = timings20.get(("[20]", INTERVAL_RANKS[-1]), {}).get("merge_ms", {})
    row = 4 * 2 * (BATCH // RING_MICROBATCH)  # one rank's partial, (2, 32,768) int32
    extra = {"one_card_ms": wait20["ms"], "one_card_host_ms": wait20["host_ms"],
             "blocks": wait20["blocks"],
             "one_card_ms_by_ranks": {P: v["ms"] for P, v in wait20.get("wide", {}).items()},
             "launches_by_path": per_run(launches20, "flag-wait ring sum")}
    if ms.get("ring_route") == "flag wait":
        timing = (ms["ring"], wait20["plain_ms"],
                  *across_cards_bound((SHARDS + 1) * row, (SHARDS - 1) * row), ms.get("nccl"))
        extra.update(library="NCCL all_reduce of the payload across the ranks' cards",
                     synchronised_ms=ms["ring_sync"], host_ms=ms["ring_host"],
                     library_synchronised_ms=ms.get("nccl_sync"), gloo_ms=ms["gloo"],
                     measured="one merge in 4 ranks on 4 cards")
    else:
        timing = (wait20["ms"], wait20["plain_ms"], *bound((SHARDS + 1) * row, 0), None)
        extra.update(measured="one prepared launch on one card, the peers' flags pre-published")
    return kernel_row("ring_allreduce_flag_wait", "ring.cu", "parallel/ring.py:58", run,
                      launches20[run]["flag-wait ring sum"], wait20["err"], timing, **extra)


def per_run(launches: dict, kernel: str) -> dict:
    """One kernel's launches in each run of a phase's ranks (keyed by run)."""
    return {run: n[kernel] for run, n in launches.items()}


def locate_rows(loc_k, fm_cli_locate, tier2_locate, mode_launches, mp_launches, locate10, fm11,
                fm16, launches20) -> list:
    """The ``kernels`` line's rows of the locate, the sharded locate and
    the sharded piece search, each timed at its main path's shape ([19];
    its other paths' shapes under ``other_shapes``), with the launches of
    every path that runs it (each count set to 0 just before that path and
    read just after; [16]'s sharded ranks take the seed path, which runs
    neither sharded entry)."""
    def row(name, replaces, entry, path, launches, by_path, others=()):
        r = loc_k[entry]
        source = "fm_search.cu" if "piece" in entry else "locate.cu"
        other = {o: {key: (loc_k[o]["bound"][0] if key == "bound_ms" else loc_k[o][key])
                     for key in ("ms", "plain_ms", "stage_ms", "bound_ms", "floor_ms", "shape")}
                 for o in others}
        extra = {"other_shapes": other} if other else {}
        if entry in loc_k["apart"]:  # the sharded kernels with one allocation a shard
            extra["separate_allocations_ms"] = loc_k["apart"][entry]
        if r.get("grid"):  # the locates: the persistent grid the binding chose
            extra["grid"] = r["grid"]
            for o in others:
                other[o]["grid"] = loc_k[o]["grid"]
        return kernel_row(name, source, replaces, path, launches, r["err"],
                          (r["ms"], r["plain_ms"], *r["bound"], None), stage_ms=r["stage_ms"],
                          latency_floor_ms=r["floor_ms"], shape=r["shape"],
                          launches_by_path=by_path, **extra)

    loc = {"[7] align (FM pigeonhole pieces)": fm_cli_locate,
           "[12] tier 2 (repeat genome)": tier2_locate,
           **{f"[13] align {m}": n["locate"] for m, n in mode_launches.items()},
           **{f"[15] multi-part, {k}": n for k, n in mp_launches["locate"].items()},
           **{f"[15] multi-part repeat, {k}": n for k, n in mp_launches["repeat_locate"].items()},
           **{run: n["locate"] for run, n in fm16.items()}}
    fm_run = fm11["FM", SHARDS]
    wide_run = fm11[f"FM, {WIDE_SHARDS} shards", WIDE_SHARDS]
    path11w = f"[11] align --n-interval {WIDE_SHARDS} (FM shards)"
    sharded = {**locate10, f"[11] align --n-interval {SHARDS} (FM shards)":
               fm_run["sharded locate"], path11w: wide_run["sharded locate"],
               **{run: n["sharded locate"] for run, n in fm16.items() if "sharded" in run},
               **per_run(launches20, "sharded locate")}
    pieces = {f"[11] align --n-interval {SHARDS} (FM shards)": fm_run["sharded piece search"],
              path11w: wide_run["sharded piece search"],
              **{run: n["sharded piece search"] for run, n in fm16.items() if "sharded" in run},
              **per_run(launches20, "sharded piece search")}
    path11 = f"[11] align --n-interval {SHARDS} (FM shards)"
    return [
        row("locate", "ops/rank.py:234", "locate, [7] FM pigeonhole",
            "[7] align (FM pigeonhole pieces)", fm_cli_locate, loc,
            ("locate, [12] tier-2 call", "locate, [13] -k 0")),
        row("locate_sharded", "parallel/sharded_index.py:267", f"sharded locate, [11] S = {SHARDS}",
            path11, fm_run["sharded locate"], sharded, (f"sharded locate, [10] S = {SHARDS}",)),
        row("fm_backward_search_sharded_pieces", "parallel/sharded_pipeline.py:330",
            f"sharded piece search, [11] S = {SHARDS}", path11, fm_run["sharded piece search"],
            pieces),
        row("locate_sharded_wide", "parallel/sharded_index.py:267",
            f"sharded locate, [11] S = {WIDE_SHARDS}", path11w, wide_run["sharded locate"],
            sharded, (f"sharded locate, [10] S = {WIDE_SHARDS}",)),
        row("fm_backward_search_sharded_pieces_wide", "parallel/sharded_pipeline.py:330",
            f"sharded piece search, [11] S = {WIDE_SHARDS}", path11w,
            wide_run["sharded piece search"], pieces),
    ]


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
    t_smoke = time.time()
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
        start_prebuild()
        max_err, dp_timing = phase_kernel(torch, dev, card)
        t0 = time.time()
        codes = random_genome(GENOME_LEN, seed=GENOME_SEED)
        offsets, positions = build_seed_table(codes, SEED_J)
        log(f"[3] genome of {codes.size} bp and its {SEED_J}-mer seed table in "
            f"{time.time() - t0:.1f} s")
        phase_fused_step(torch, dev, codes, offsets, positions)
        del offsets, positions
        launches, native_index_s = phase_cli(codes, card)
        phase_profile(torch, dev, codes, card)
        myers_err, myers_times = phase_myers(torch, dev, card)
        fm_cli_launches, fm_cli_locate = phase_fm_cli(codes, card)
        myers_launches = phase_paired(torch, dev, codes, card)
        pairs300 = phase_paired_300(torch, dev, codes, card)
        from genome_weaver_align_tpu_torch import cli
        from genome_weaver_align_tpu_torch.index.files import load_index

        gi = load_index(build_index(cli, codes)[0])
        ring_err, ring_timing = phase_rings(torch, dev, gi.fwd, card)
        ring_launches, fused_launches, locate10, wide10 = phase_sharded_search(torch, dev, codes,
                                                                               gi, card)
        del gi
        banded_win_launches, fm11 = phase_sharded_cli(codes, card)
        tier2, rep_codes = phase_tier2(torch, dev, card)
        tier2_launches = tier2["launches"]
        mode_launches = phase_modes(codes, card)
        long_launches, wide_long_launches = phase_long_reads(torch, dev, codes, card)
        mp_launches = phase_multipart(torch, dev, codes, rep_codes, card)
        rank_launches, rank_err, fm16 = phase_ranks(torch, codes, card)
        wait20 = phase_flag_wait(torch, card)
        launches20, timings20, ref20, work20, err20 = phase_interval(torch, codes, card)
        launches22, err22 = phase_hosts(torch, codes, card, ref20, work20)
        phase_builders(torch, dev, codes, card, native_index_s)
        fm_k = phase_fm_kernels(torch, dev, codes, rep_codes, card)
        loc_k = phase_locate(torch, dev, codes, rep_codes, card, fm_k["step_us"])
        check("jax" not in sys.modules, "the smoke imported jax")
        check(not any(m == "genome_weaver_align_tpu" or m.startswith("genome_weaver_align_tpu.")
                      for m in sys.modules), "the smoke imported the JAX package")
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        stop_prebuild()
    myers_win_err, myers_text_err = myers_err
    wide20 = wait20["wide"][WIDE_RANKS[-1]]
    log(f"[smoke] wall {time.time() - t_smoke:.1f} s, of which the checks past the verify "
        f"kernels' one-thread designs {sum(WIDE_WALL_S.values()):.1f} s "
        f"({', '.join(f'{k} {v:.1f}' for k, v in WIDE_WALL_S.items())}); each phase's first "
        f"line, s after the start: "
        f"{', '.join(f'{k} {v - t_smoke:.1f}' for k, v in PHASE_START.items())}")
    log(json.dumps({"kernels": [
        kernel_row("banded_dp_text", "banded_dp.cu", "ops/dp_pallas.py:47",
                   "[4] align --seed-table", launches, max(max_err, err22),
                   (*dp_timing["text"], None),
                   launches_by_path={"[4] align --seed-table": launches,
                                     "[12] tier 2 (repeat genome)": tier2_launches,
                                     **{f"[13] align {m}": n["banded"]
                                        for m, n in mode_launches.items()},
                                     "[14] long reads": long_launches,
                                     **{f"[15] multi-part, part {p}": n
                                        for p, n in enumerate(mp_launches["by_part"])},
                                     "[15] multi-part, rescue": mp_launches["rescue"],
                                     **{f"[15] multi-part repeat, part {p}": n
                                        for p, n in enumerate(mp_launches["repeat_by_part"])},
                                     "[15] multi-part repeat, rescue":
                                         mp_launches["repeat_rescue"],
                                     **per_run(launches22, "text entry")}),
        kernel_row("banded_dp_text_long_read", "banded_dp.cu", "ops/dp_pallas.py:47",
                   "[14] long reads (LongReadAligner, kb = 16)", long_launches, max_err,
                   (*dp_timing["text_long"], None),
                   shape={"Q": LONG_B * (LONG_L // LONG_SEG), "L": LONG_SEG,
                          "W": LONG_SEG + 3 * LONG_KB, "k": LONG_KB},
                   long_rows={Lr: {key: dp_timing["wide"][f"k=2 L={Lr}"][i]
                                   for i, key in ((0, "ms"), (1, "plain_ms"), (2, "bound_ms"))}
                              for Lr in LONG_ROWS}),
        kernel_row("banded_dp_text_group", "banded_dp.cu", "ops/dp_pallas.py:47",
                   f"[14] long reads (LongReadAligner, kb = {WIDE_LONG_KB})", wide_long_launches,
                   max_err, (*dp_timing["wide"][f"k={WIDE_LONG_KB} L={LONG_SEG}"][:4], None),
                   shape={"Q": LONG_B * (LONG_L // LONG_SEG), "L": LONG_SEG,
                          "W": LONG_SEG + 3 * WIDE_LONG_KB, "k": WIDE_LONG_KB},
                   ms_by_k={k: dp_timing["wide"][f"k={k} L={LONG_SEG}"][0] for k in WIDE_KS},
                   bound_ms_by_k={k: dp_timing["wide"][f"k={k} L={LONG_SEG}"][2]
                                  for k in WIDE_KS},
                   long_rows={Lr: {key: dp_timing["wide"][f"k={WIDE_LONG_KB} L={Lr}"][i]
                                   for i, key in ((0, "ms"), (1, "plain_ms"), (2, "bound_ms"))}
                              for Lr in LONG_ROWS}),
        kernel_row("banded_dp_scratch", "banded_dp.cu", "ops/dp_pallas.py:47",
                   f"none: k >= 128 runs on no path here; both entries held against plain in "
                   f"[2] at k = {SCRATCH_K}", 0, max_err,
                   (*dp_timing["wide"][f"k={SCRATCH_K} L={LONG_SEG}"][:4], None),
                   shape={"Q": SCRATCH_K_LANES, "L": LONG_SEG, "W": LONG_SEG + 3 * SCRATCH_K,
                          "k": SCRATCH_K}),
        kernel_row("banded_dp_windows", "banded_dp.cu", "ops/dp_pallas.py:47",
                   "[11] align --n-interval 4", banded_win_launches,
                   max(max_err, rank_err, err20),
                   (*dp_timing["windows"], None),
                   launches_by_path={"[11] align --n-interval 4": banded_win_launches,
                                     **rank_launches,
                                     **per_run(launches20, "windows entry")}),
        kernel_row("myers_text", "myers.cu", "ops/myers_pallas.py:75",
                   "[8] align --paired (mate rescue)", myers_launches, myers_text_err,
                   (*myers_times["text", "rescue"], None),
                   stage_ms=myers_times["stage", "rescue"],
                   latency_floor_ms=myers_times["floor"],
                   warp_issue_floor_ms=myers_times["issue_floor"]),
        kernel_row("myers_text_group", "myers.cu", "ops/myers_pallas.py:75",
                   f"[8] align --paired, {PAIR300_L} bp (mate rescue)", pairs300["launches"],
                   max(myers_text_err, pairs300["max_err"]),
                   (*myers_times["text_wide", PAIR300_L, -(-PAIR300_L // 32)][:4], None),
                   shape={"Q": RESCUE_LANES, "L": PAIR300_L, "W": PAIR300_L + 400,
                          "nwords": -(-PAIR300_L // 32)},
                   rescue_call={k: pairs300[k] for k in ("lanes", "W", "nwords", "ms", "shape")},
                   latency_floor_ms=myers_times["group_floor"],
                   link_cycles=myers_times["link_cycles"],
                   shfl_cycles=myers_times["shfl_cycles"],
                   ms_by_L={Lr: myers_times["text_wide", Lr, -(-Lr // 32)][0]
                            for Lr in WIDE_MYERS_L},
                   shape_by_L=myers_times["shape_by_L"],
                   bound_ms_by_L={Lr: myers_times["text_wide", Lr, -(-Lr // 32)][2]
                                  for Lr in WIDE_MYERS_L}),
        kernel_row("myers_scratch", "myers.cu", "ops/myers_pallas.py:75",
                   f"none: past 512 words runs on no path here; both entries held against "
                   f"plain in [6] at {SCRATCH_WORDS} words", 0, myers_text_err,
                   (*myers_times["text_wide", SCRATCH_MYERS_L, SCRATCH_WORDS][:4], None),
                   shape={"Q": SCRATCH_MYERS_LANES, "L": SCRATCH_MYERS_L,
                          "W": SCRATCH_MYERS_L + 400, "nwords": SCRATCH_WORDS}),
        kernel_row("myers_windows", "myers.cu", "ops/myers_pallas.py:75",
                   "none: the JAX contract's entry, held against plain in [6]", 0,
                   myers_win_err, (*myers_times["windows", "rescue"], None)),
        kernel_row("ring_allreduce", "ring.cu", "parallel/ring.py:58",
                   "[10] merge=ring", ring_launches, ring_err["ring"], ring_timing["ring"],
                   shape={"S": SHARDS, "payload": [2, BATCH // RING_MICROBATCH], "only": 0},
                   all_rows_ms=RING_ALL_ROWS_MS[SHARDS],
                   launches_by_path={"[10] merge=ring": ring_launches,
                                     f"[10] {WIDE_SHARDS} shards, merge=ring":
                                         wide10[f"[10] {WIDE_SHARDS} shards, merge=ring"][0],
                                     **per_run(launches20, "ring sum")}),
        flag_wait_row(wait20, timings20, launches20),
        kernel_row("ring_allreduce_wide", "ring.cu", "parallel/ring.py:58",
                   f"[10] {WIDE_SHARDS} shards, merge=ring",
                   wide10[f"[10] {WIDE_SHARDS} shards, merge=ring"][0], ring_err["ring"],
                   ring_timing["ring_wide"],
                   shape={"S": WIDE_SHARDS, "payload": [2, BATCH // RING_MICROBATCH], "only": 0},
                   all_rows_ms=RING_ALL_ROWS_MS[WIDE_SHARDS]),
        kernel_row("ring_allreduce_flag_wait_wide", "ring.cu", "parallel/ring.py:58",
                   f"none: one card, {WIDE_RANKS[-1]} ranks emulated ([20]); across cards the "
                   f"ranks are the cards", 0, wide20["err"],
                   (wide20["ms"], wide20["plain_ms"],
                    *bound((WIDE_RANKS[-1] + 1) * 4 * 2 * (BATCH // RING_MICROBATCH), 0), None),
                   ms_by_ranks={P: v["ms"] for P, v in wait20["wide"].items()}),
        kernel_row("fused_rank_ring_words", "ring.cu", "parallel/ring.py:162",
                   "none: the JAX contract's entry, held against plain in [9]", 0,
                   ring_err["words"], ring_timing["words"]),
        kernel_row("fused_occ_table", "ring.cu", "parallel/ring.py:162", "[10] merge=fused",
                   fused_launches, ring_err["table"], ring_timing["table"],
                   stage_ms=ring_timing["stage"], separate_allocations_ms=ring_timing["apart"],
                   wide_ms={WIDE_SHARDS: ring_timing["table_wide"][0]},
                   wide_bound_ms={WIDE_SHARDS: ring_timing["table_wide"][2]},
                   launches_by_path={"[10] merge=fused": fused_launches,
                                     f"[10] {WIDE_SHARDS} shards, merge=fused":
                                         wide10[f"[10] {WIDE_SHARDS} shards, merge=fused"][1],
                                     **per_run(launches20, "fused table entry"),
                                     **per_run(launches22, "fused table entry")}),
        *fm_rows(fm_k, fm_cli_launches, tier2["staircase"], mode_launches, mp_launches),
        *locate_rows(loc_k, fm_cli_locate, tier2["locate"], mode_launches, mp_launches, locate10,
                     fm11, fm16, launches20),
    ]}))
    log(card_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(rank_child(sys.argv[2:]) if sys.argv[1:2] == ["--rank"]
             else prebuild_child() if sys.argv[1:2] == ["--prebuild"] else main())
