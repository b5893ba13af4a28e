"""Run configuration (SURVEY.md §5.6; reference: xerial annotation options).

One dataclass per subcommand, mirroring the reference CLI's knobs (k, band
width, sample rate, paths) plus the TPU-rebuild's mesh/sharding knobs.

These are the single source of truth for defaults: ``cli.py`` pulls argparse
defaults from the class fields and each subcommand materialises its config
via ``from_args`` before running, so programmatic callers can construct the
same configs without argparse.
"""

from __future__ import annotations

from dataclasses import dataclass, fields


class _FromArgs:
    @classmethod
    def from_args(cls, args):
        """Build a config from an argparse namespace (extra attrs ignored)."""
        kw = {}
        for f in fields(cls):
            if hasattr(args, f.name):
                kw[f.name] = getattr(args, f.name)
        return cls(**kw)


@dataclass
class IndexConfig(_FromArgs):
    genome: str = ""  # FASTA path
    out: str = ""  # output .npz index path
    sample_rate: int = 8  # sparse-SA sampling (locate cost ~ sample_rate)
    builder: str = "auto"  # auto | native | numpy | device
    kmer: int = 0  # also build a j-mer interval table (0 = off)
    seed: int = 0  # also build a CSR j-mer seed table (0 = off)
    full_sa: bool = False  # keep the full SA (locate = one gather)


@dataclass
class AlignConfig(_FromArgs):
    index: str = ""  # index .npz path
    reads: str = ""  # FASTA/FASTQ path
    out: str = "-"  # SAM path or '-' for stdout
    k: int = 2  # max edit distance
    mode: str = "auto"  # auto | exact | onemm | pigeonhole | staircase
    batch_size: int = 4096
    max_hits_per_piece: int = 8
    kmer_table: str | None = None  # .npz j-mer interval table (index.kmer)
    seed_table: str | None = None  # .npz CSR seed table (index.seedtable)
    # mesh
    n_interval: int = 1  # interval-shard the index across this many devices
