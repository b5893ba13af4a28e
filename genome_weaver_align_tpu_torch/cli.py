"""Command-line interface of the PyTorch/CUDA port.

Same verbs, flags and files as ``genome_weaver_align_tpu.cli``:

    python -m genome_weaver_align_tpu_torch index genome.fa -o genome.npz --seed 13
    python -m genome_weaver_align_tpu_torch simulate genome.fa -n 1000 -l 100 -o reads.fq
    python -m genome_weaver_align_tpu_torch align genome.npz reads.fq -k 2 \\
        --seed-table genome.npz.seed13.npz -o out.sam
    python -m genome_weaver_align_tpu_torch align genome.npz r1.fq --paired r2.fq -k 2 -o out.sam

``align`` runs, as the JAX CLI does:

- ``--mode auto|pigeonhole`` with 1 <= k <= 14: the k-edit pipeline, with
  candidates from the seed table when one is given and its j fits the read
  pieces, else from the FM index (optionally with a ``--kmer-table``); reads
  left flooded after the tier-1 fallback take the tier-2 staircase when the
  index holds its reverse text (``index`` always writes it);
- ``--mode staircase``: the k-edit pipeline with the staircase search;
- ``--mode exact`` or ``-k 0`` (auto): exact matches (``ExactAligner``);
- ``--mode onemm``: at most one substitution (``OneMismatchAligner``);

on FASTQ or FASTA reads, single-end, ``--paired`` or ``--interleaved``.
With ``--n-interval N`` (N > 1) it runs ``ShardedAligner``: the index, the
text and the seed table split into N interval shards on the one device.  It
runs on the CUDA device (``--device cuda``, the default) and exits non-zero
when there is none; ``--device cpu`` runs the plain torch versions on the
CPU.  A k outside 1..14 for the k-edit modes exits with code 2 (the JAX CLI
unmaps such reads instead), and so do the modes and flags whose paths are
not ported yet, each saying so.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

_NOT_PORTED = 2


def _not_ported(what: str) -> int:
    sys.stderr.write(f"gwa-torch: {what} is not yet ported\n")
    return _NOT_PORTED


def _cmd_index(args) -> int:
    from genome_weaver_align_tpu_torch.utils.config import IndexConfig
    from genome_weaver_align_tpu_torch.utils.fasta import read_fasta
    from genome_weaver_align_tpu_torch.utils.log import StopWatch

    from .index.build import build_fm_index
    from .index.files import Genome, GenomeIndex, save_index

    cfg = IndexConfig.from_args(args)
    if cfg.builder == "device":
        return _not_ported("index --builder device")
    sw = StopWatch()
    contigs = read_fasta(cfg.genome)
    genome = Genome.from_contigs(contigs)
    sw.lap(f"loaded {len(contigs)} contig(s), {genome.n} bp")

    def sa_for(codes):
        if cfg.builder == "numpy":
            from .index.sais import suffix_array

            return suffix_array(codes)
        if cfg.builder == "native":
            from .index.native import suffix_array_native

            return suffix_array_native(codes)
        return None  # auto: build_fm_index picks native-else-numpy

    fwd = build_fm_index(
        genome.codes,
        sample_rate=cfg.sample_rate,
        sa=sa_for(genome.codes),
        keep_full_sa=cfg.full_sa,
    )
    rcodes = genome.codes[::-1].copy()
    rev = build_fm_index(rcodes, sample_rate=cfg.sample_rate, sa=sa_for(rcodes))
    gi = GenomeIndex(genome, fwd, rev)
    sw.lap(f"built forward+reverse FM indexes (builder={cfg.builder})")
    save_index(cfg.out, gi)
    sw.lap(f"saved {cfg.out}")
    if cfg.kmer:
        from .index.kmer import build_kmer_table

        lo, hi = build_kmer_table(fwd, cfg.kmer)
        np.savez(cfg.out + f".kmer{cfg.kmer}.npz", lo=lo, hi=hi)
        sw.lap(f"built {cfg.kmer}-mer table -> {cfg.out}.kmer{cfg.kmer}.npz")
    if cfg.seed:
        from .index.seedtable import build_seed_table, save_seed_table

        offsets, positions = build_seed_table(genome.codes, cfg.seed)
        save_seed_table(cfg.out + f".seed{cfg.seed}.npz", offsets, positions, cfg.seed)
        sw.lap(f"built {cfg.seed}-mer seed table -> {cfg.out}.seed{cfg.seed}.npz")
    return 0


def _align_mode(cfg) -> str:
    """The aligner ``--mode`` names; ``auto`` is exact at k = 0, else
    pigeonhole, as in the JAX CLI."""
    if cfg.mode == "auto":
        return "exact" if cfg.k == 0 else "pigeonhole"
    return cfg.mode


def _unported_align_feature(args, cfg) -> str | None:
    """The first requested align feature whose path is not ported, or None."""
    mode = _align_mode(cfg)
    if mode == "long":
        return "align --mode long"
    if cfg.n_interval > 1 and cfg.mode not in ("auto", "pigeonhole"):
        # the JAX CLI runs ShardedAligner there and ignores the mode
        return f"align --n-interval > 1 with --mode {cfg.mode}"
    if cfg.n_interval > 1 and (args.paired or args.interleaved or cfg.kmer_table):
        return "align --n-interval > 1 with --paired, --interleaved or --kmer-table"
    if mode in ("exact", "onemm") and (args.paired or args.interleaved):
        return f"align --mode {mode} with --paired or --interleaved"
    if args.profile:
        return "align --profile"
    return None


def _cmd_align(args) -> int:
    import torch

    from genome_weaver_align_tpu_torch.utils.config import AlignConfig
    from genome_weaver_align_tpu_torch.utils.log import StopWatch

    from .index.files import load_index
    from .models.pipeline import MAX_K, ExactAligner, SuffixFilterAligner

    cfg = AlignConfig.from_args(args)
    missing = _unported_align_feature(args, cfg)
    if missing:
        return _not_ported(missing)
    mode = _align_mode(cfg)
    if (mode in ("pigeonhole", "staircase") or cfg.n_interval > 1) and not 1 <= cfg.k <= MAX_K:
        sys.stderr.write(f"gwa-torch: align -k {cfg.k}: the k-edit modes take 1 <= k <= {MAX_K}\n")
        return _NOT_PORTED
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        sys.stderr.write(
            "gwa-torch: --device cuda was asked for (the default) but no CUDA "
            "device is available; pass --device cpu to run on the CPU\n"
        )
        return 1
    sw = StopWatch()
    gi = load_index(cfg.index)
    sw.lap(f"loaded index ({gi.genome.n} bp)")
    tables = {}
    if cfg.kmer_table:
        z = np.load(cfg.kmer_table)
        j = int(np.log2(z["lo"].size) / 2)
        tables.update(kmer_table=(z["lo"], z["hi"]), kmer_j=j)
        sw.lap(f"loaded {j}-mer table")
    if cfg.seed_table:
        from .index.seedtable import load_seed_table

        offsets, positions, sj = load_seed_table(cfg.seed_table)
        tables.update(seed_table=(offsets, positions), seed_j=sj)
        sw.lap(f"loaded {sj}-mer seed table")
    if cfg.n_interval > 1:
        from .parallel.sharded_pipeline import ShardedAligner

        # the JAX CLI builds it with its default hit budget, not the flag's
        aligner = ShardedAligner(
            gi, k=cfg.k, n_interval=cfg.n_interval,
            seed_table=tables.get("seed_table"), seed_j=tables.get("seed_j", 0),
            device=device,
        )
        sw.lap(f"uploaded {cfg.n_interval} interval shards to {device}")
        return _align_read_list(args, cfg, aligner, sw)
    if mode == "exact":
        aligner = ExactAligner(gi, device=device)
    elif mode == "onemm":
        from .models.one_mismatch import OneMismatchAligner

        aligner = OneMismatchAligner(gi, device=device)
    else:
        aligner = SuffixFilterAligner(
            gi, k=cfg.k, max_hits_per_piece=cfg.max_hits_per_piece,
            use_staircase=mode == "staircase", device=device, **tables,
        )
    sw.lap(f"uploaded tables to {device}")
    # array streaming: uniform unpaired FASTQ of the auto/pigeonhole k-edit
    # path goes straight to (B, L) arrays; FASTA, paired input and the other
    # modes take the list-of-Read path, as in the JAX CLI
    base = cfg.reads[:-3] if cfg.reads.endswith(".gz") else cfg.reads
    if (base.endswith((".fq", ".fastq")) and not args.interleaved and not args.paired
            and mode == "pigeonhole"):
        return _align_array_stream(args, aligner, sw)
    return _align_read_list(args, cfg, aligner, sw)


def _n_tier2(aligner) -> int:
    """Reads the last finished batch sent to the tier-2 staircase (0 for
    aligners without a tier 2)."""
    return getattr(aligner, "last_stats", {}).get("n_staircase_fallback", 0)


def _align_read_list(args, cfg, aligner, sw) -> int:
    """List-of-Read align loop (FASTA reads, ``--paired``,
    ``--interleaved``, ``--n-interval``, the exact, onemm and staircase
    modes): all reads are loaded, aligned batch by batch (single-end batches
    pipelined where the aligner has a submit/finish pair: submit N+1 before
    finishing N) and the SAM is written at the end, as the JAX CLI's list
    path does."""
    from genome_weaver_align_tpu_torch.utils.fasta import iter_reads
    from genome_weaver_align_tpu_torch.utils.sam import write_sam

    from .models.paired import PairedAligner

    reads = list(iter_reads(cfg.reads))
    paired = None
    if args.interleaved:
        if len(reads) % 2:
            raise ValueError("interleaved input needs an even read count")
        mates = reads[1::2]
        reads = reads[0::2]
        paired = PairedAligner(aligner)
        sw.lap(f"loaded {len(reads)} interleaved pairs")
    elif args.paired:
        mates = list(iter_reads(args.paired))
        if len(mates) != len(reads):
            raise ValueError("paired files must have equal read counts")
        paired = PairedAligner(aligner)
        sw.lap(f"loaded {len(reads)} pairs")
    else:
        sw.lap(f"loaded {len(reads)} reads")

    # resume: skip batches recorded as complete for this output path
    progress_path = (cfg.out + ".progress") if cfg.out != "-" else None
    start_batch = 0
    if args.resume and progress_path and os.path.exists(progress_path):
        with open(progress_path) as fh:
            start_batch = json.loads(fh.read()).get("batches_done", 0)
        sw.lap(f"resuming at batch {start_batch}")

    records = []
    n_mapped = n_proper = n_tier2 = 0
    t0 = time.time()
    bs = cfg.batch_size
    n_batches = (len(reads) + bs - 1) // bs
    pending = None  # single-end: (batch, submitted handle)
    pipelined = hasattr(aligner, "align_batch_submit")

    def finish_single(batch, hits):
        nonlocal n_mapped, n_tier2
        n_tier2 += _n_tier2(aligner)
        records.extend(aligner.to_sam(batch, hits))
        n_mapped += sum(h is not None for h in hits)

    for b in range(start_batch, n_batches):
        i = b * bs
        if paired is not None:
            batch = list(zip(reads[i : i + bs], mates[i : i + bs]))
            hits = paired.align_pairs(batch)
            n_tier2 += paired.last_staircase_fallback
            records.extend(paired.to_sam(batch, hits))
            n_mapped += sum((ph.h1 is not None) + (ph.h2 is not None) for ph in hits)
            n_proper += sum(ph.proper for ph in hits)
        elif pipelined:
            batch = reads[i : i + bs]
            nxt = (batch, aligner.align_batch_submit(batch))
            if pending is not None:
                finish_single(pending[0], aligner.align_batch_finish(pending[1]))
            pending = nxt
        else:
            batch = reads[i : i + bs]
            finish_single(batch, aligner.align_batch(batch))
        if progress_path:
            with open(progress_path, "w") as fh:
                fh.write(json.dumps({"batches_done": b + 1}))
    if pending is not None:
        finish_single(pending[0], aligner.align_batch_finish(pending[1]))
    dt = time.time() - t0
    total = len(reads) * (2 if paired else 1)
    sw.lap(
        f"aligned: {n_mapped}/{total} mapped, {total/max(dt,1e-9):.0f} reads/s"
        + (f", {n_proper} proper pairs" if paired else "")
    )
    sw.lap(f"{n_tier2} read(s) went through the tier-2 staircase")

    hdr = aligner.sam_header()
    if cfg.out == "-":
        sys.stdout.write(hdr + "\n")
        for r in records:
            sys.stdout.write(r.line() + "\n")
    else:
        write_sam(cfg.out, hdr, records)
        sw.lap(f"wrote {cfg.out}")
    if args.report:
        _write_report(args.report, sw, {
            "reads": total,
            "mapped": n_mapped,
            "proper_pairs": n_proper if paired else None,
            "reads_per_s": round(total / max(dt, 1e-9), 1),
            "wall_s": round(dt, 3),
            "mode": _align_mode(cfg),
            "k": cfg.k,
            "batch_size": bs,
            "n_staircase_fallback": n_tier2,
            "device": str(aligner.device),
        })
    return 0


def _write_report(path, sw, report: dict) -> None:
    with open(path, "w") as fh:
        fh.write(json.dumps(report, indent=1))
    sw.lap(f"report -> {path}")


def _align_array_stream(args, aligner, sw) -> int:
    """Array-native align loop: FASTQ -> (B, L) code batches -> ArrayHits.

    Two-phase (submit N+1 before finish N) so host parsing/SAM assembly
    overlaps device compute; at most two batches are in flight and SAM is
    emitted incrementally."""
    from genome_weaver_align_tpu_torch.utils.fasta import iter_fastq_array_batches

    from .models.pipeline import prefetch_result

    progress_path = (args.out + ".progress") if args.out != "-" else None
    start_batch = 0
    if args.resume and progress_path and os.path.exists(progress_path):
        with open(progress_path) as fh:
            start_batch = json.loads(fh.read()).get("batches_done", 0)
        sw.lap(f"resuming at batch {start_batch}")

    bs = args.batch_size
    total = n_mapped = n_tier2 = 0
    t0 = time.time()
    out_fh = sys.stdout if args.out == "-" else open(args.out, "w")
    try:
        out_fh.write(aligner.sam_header() + "\n")

        def emit(pb, ah, names, codes, quals, lengths):
            nonlocal n_mapped, n_tier2
            n_mapped += int(ah.mapped.sum())
            n_tier2 += _n_tier2(aligner)
            lines = aligner.to_sam_lines(names, codes, lengths, ah, quals=quals)
            out_fh.write("\n".join(lines) + "\n")
            if progress_path:
                with open(progress_path, "w") as fh:
                    fh.write(json.dumps({"batches_done": pb + 1}))

        pending = None
        for b, (names, codes, quals, lengths) in enumerate(
            iter_fastq_array_batches(args.reads, bs)
        ):
            total += len(names)
            if b < start_batch:
                continue
            nxt = (
                b,
                aligner.align_arrays_submit(codes.astype(np.int8), lengths),
                names, codes, quals, lengths,
            )
            prefetch_result(nxt[1])
            if pending is None:
                pending = nxt
                continue
            pb, ph, pn, pc, pq, pl = pending
            pending = nxt
            emit(pb, aligner.align_arrays_finish(ph), pn, pc, pq, pl)
        if pending is not None:
            pb, ph, pn, pc, pq, pl = pending
            emit(pb, aligner.align_arrays_finish(ph), pn, pc, pq, pl)
    finally:
        if out_fh is not sys.stdout:
            out_fh.close()
    dt = time.time() - t0
    sw.lap(f"aligned: {n_mapped}/{total} mapped, {total/max(dt,1e-9):.0f} reads/s")
    sw.lap(f"{n_tier2} read(s) went through the tier-2 staircase")
    if args.report:
        _write_report(args.report, sw, {
            "reads": total,
            "mapped": n_mapped,
            "proper_pairs": None,
            "reads_per_s": round(total / max(dt, 1e-9), 1),
            "wall_s": round(dt, 3),
            "mode": "pigeonhole",
            "k": args.k,
            "batch_size": bs,
            "n_staircase_fallback": n_tier2,
            "device": str(aligner.device),
        })
    return 0


def _cmd_simulate(args) -> int:
    from genome_weaver_align_tpu_torch.utils.fasta import read_fasta, write_fastq
    from genome_weaver_align_tpu_torch.utils.simulate import simulate_reads

    from .index.files import Genome

    genome = Genome.from_contigs(read_fasta(args.genome))
    sims = simulate_reads(
        genome.codes,
        n_reads=args.n,
        read_len=args.length,
        seed=args.seed,
        sub_rate=args.sub_rate,
        max_subs=args.max_subs,
        indel_rate=args.indel_rate,
        max_indels=args.max_indels,
    )
    write_fastq(args.out, [s.read for s in sims])
    print(f"wrote {len(sims)} reads to {args.out}")
    return 0


def main(argv=None) -> int:
    # argparse defaults come from the shared config dataclasses, as in the
    # JAX package's CLI
    from genome_weaver_align_tpu_torch.utils.config import AlignConfig, IndexConfig

    icfg, acfg = IndexConfig(), AlignConfig()
    p = argparse.ArgumentParser(prog="gwa-torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    pi = sub.add_parser("index", help="build FM index from FASTA")
    pi.add_argument("genome")
    pi.add_argument("-o", "--out", required=True)
    pi.add_argument("--sample-rate", type=int, default=icfg.sample_rate)
    pi.add_argument(
        "--builder", choices=["auto", "numpy", "native", "device"], default=icfg.builder,
        help="suffix-array builder ('device' is not yet ported)",
    )
    pi.add_argument("--kmer", type=int, default=icfg.kmer, help="also build a j-mer table")
    pi.add_argument(
        "--full-sa", action="store_true",
        help="keep the full suffix array in the index (locate = one gather)",
    )
    pi.add_argument(
        "--seed", type=int, default=icfg.seed,
        help="also build a CSR j-mer seed table (index.seedtable)",
    )
    pi.set_defaults(fn=_cmd_index)

    pa = sub.add_parser("align", help="align reads to an index")
    pa.add_argument("index")
    pa.add_argument("reads")
    pa.add_argument("-o", "--out", default=acfg.out)
    pa.add_argument("-k", type=int, default=acfg.k, help="max edit distance")
    pa.add_argument(
        "--mode",
        choices=["auto", "exact", "onemm", "pigeonhole", "staircase", "long"],
        default=acfg.mode,
        help="'long' is not yet ported",
    )
    pa.add_argument("--batch-size", type=int, default=acfg.batch_size)
    pa.add_argument("--max-hits-per-piece", type=int, default=acfg.max_hits_per_piece)
    pa.add_argument("--paired", help="R2 file: align as pairs (reads = R1)")
    pa.add_argument(
        "--interleaved", action="store_true",
        help="reads file holds R1/R2 alternating (paired mode)",
    )
    pa.add_argument("--kmer-table", help=".npz with lo/hi arrays (index.kmer)")
    pa.add_argument("--seed-table", help=".npz seed table (index.seedtable)")
    pa.add_argument("--report", help="write a JSON run report here")
    pa.add_argument("--resume", action="store_true", help="resume from .progress")
    pa.add_argument("--profile", help="(not yet ported)")
    pa.add_argument("--n-interval", type=int, default=acfg.n_interval,
                    help="interval shards of the index (ShardedAligner when > 1)")
    pa.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="run on the CUDA device (default; fails without one) or the CPU")
    pa.set_defaults(fn=_cmd_align)

    ps = sub.add_parser("simulate", help="simulate reads from a genome")
    ps.add_argument("genome")
    ps.add_argument("-o", "--out", required=True)
    ps.add_argument("-n", type=int, default=1000)
    ps.add_argument("-l", "--length", type=int, default=100)
    ps.add_argument("--seed", type=int, default=1)
    ps.add_argument("--sub-rate", type=float, default=0.0)
    ps.add_argument("--max-subs", type=int, default=None)
    ps.add_argument("--indel-rate", type=float, default=0.0)
    ps.add_argument("--max-indels", type=int, default=0)
    ps.set_defaults(fn=_cmd_simulate)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
