"""Index serialization + genome container (SURVEY.md §2 #5, reference `BWTFiles`).

The reference's checkpoint/resume analogue: the index is built once
(`gwa-tpu index`) and reloaded for every align run (see SURVEY.md §5.4).
On-disk format: one ``.npz`` per genome holding the packed text, forward and
reverse-text FM tables, sparse-SA arrays and the chromosome name/offset table.
"""

from __future__ import annotations

import json
from dataclasses import dataclass

import numpy as np

from genome_weaver_align_tpu.utils import dna
from genome_weaver_align_tpu.utils.bitvector import BitVector
from genome_weaver_align_tpu.utils.fasta import Contig
from .build import FMIndexData, build_fm_index


@dataclass
class Genome:
    """Concatenated multi-contig genome with a name/offset table."""

    names: list[str]
    offsets: np.ndarray  # (n_contigs + 1,) int64 cumulative starts
    codes: np.ndarray  # concatenated 2-bit codes (N resolved)
    n_mask_spans: np.ndarray  # (k, 2) spans that were ambiguous in the input

    @property
    def n(self) -> int:
        return self.codes.size

    @property
    def lengths(self) -> list[int]:
        return list(np.diff(self.offsets).astype(int))

    @classmethod
    def from_contigs(cls, contigs: list[Contig], seed: int = 0) -> "Genome":
        names = [c.name for c in contigs]
        offsets = np.zeros(len(contigs) + 1, dtype=np.int64)
        offsets[1:] = np.cumsum([c.codes.size for c in contigs])
        cat = np.concatenate([c.codes for c in contigs]) if contigs else np.zeros(0, np.uint8)
        resolved, mask = dna.resolve_ambiguous(cat, seed=seed)
        spans = _mask_to_spans(mask)
        return cls(names, offsets, resolved, spans)

    def coord(self, pos) -> tuple[np.ndarray, np.ndarray]:
        """Global position(s) -> (contig_index, local_position)."""
        pos = np.atleast_1d(np.asarray(pos, dtype=np.int64))
        ci = np.searchsorted(self.offsets, pos, side="right") - 1
        return ci, pos - self.offsets[ci]


def _mask_to_spans(mask: np.ndarray) -> np.ndarray:
    if not mask.any():
        return np.zeros((0, 2), dtype=np.int64)
    d = np.diff(mask.astype(np.int8))
    starts = np.nonzero(d == 1)[0] + 1
    ends = np.nonzero(d == -1)[0] + 1
    if mask[0]:
        starts = np.r_[0, starts]
    if mask[-1]:
        ends = np.r_[ends, mask.size]
    return np.stack([starts, ends], axis=1).astype(np.int64)


@dataclass
class GenomeIndex:
    """Forward + reverse-text FM indexes over one genome (bidirectional search)."""

    genome: Genome
    fwd: FMIndexData
    rev: FMIndexData  # index of the *reversed* text (not reverse-complement)


def build_genome_index(
    genome: Genome, sample_rate: int = 32, keep_full_sa: bool = False
) -> GenomeIndex:
    fwd = build_fm_index(genome.codes, sample_rate=sample_rate, keep_full_sa=keep_full_sa)
    rev = build_fm_index(genome.codes[::-1].copy(), sample_rate=sample_rate)
    return GenomeIndex(genome, fwd, rev)


_FM_FIELDS = ("bwt_words", "occ_cp", "ssa_values", "text_words")


def save_index(path, gi: GenomeIndex) -> None:
    meta = {
        "names": gi.genome.names,
        "offsets": gi.genome.offsets.tolist(),
        "fm": {},
    }
    arrays: dict[str, np.ndarray] = {
        "codes": gi.genome.codes,
        "n_mask_spans": gi.genome.n_mask_spans,
    }
    for tag, fm in (("fwd", gi.fwd), ("rev", gi.rev)):
        meta["fm"][tag] = {
            "n": fm.n,
            "primary": fm.primary,
            "sample_rate": fm.sample_rate,
        }
        for f in _FM_FIELDS:
            arrays[f"{tag}_{f}"] = getattr(fm, f)
        arrays[f"{tag}_counts"] = fm.counts
        arrays[f"{tag}_C"] = fm.C
        arrays[f"{tag}_ssa_mark_bits"] = _marks_bits(fm)
        if fm.full_sa is not None:
            arrays[f"{tag}_full_sa"] = fm.full_sa
    arrays["meta_json"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def _marks_bits(fm: FMIndexData) -> np.ndarray:
    # store the raw mark bits; BitVector rebuilds its checkpoints on load
    bits = np.zeros(fm.n + 1, dtype=bool)
    idx = np.arange(fm.n + 1)
    bits[:] = fm.ssa_marks.get(idx)
    return np.packbits(bits)


def load_index(path) -> GenomeIndex:
    z = np.load(path, allow_pickle=False)
    meta = json.loads(bytes(z["meta_json"]).decode())
    genome = Genome(
        names=list(meta["names"]),
        offsets=np.asarray(meta["offsets"], dtype=np.int64),
        codes=z["codes"],
        n_mask_spans=z["n_mask_spans"],
    )
    fms = {}
    for tag in ("fwd", "rev"):
        m = meta["fm"][tag]
        bits = np.unpackbits(z[f"{tag}_ssa_mark_bits"])[: m["n"] + 1].astype(bool)
        fms[tag] = FMIndexData(
            n=m["n"],
            primary=m["primary"],
            counts=z[f"{tag}_counts"],
            C=z[f"{tag}_C"],
            bwt_words=z[f"{tag}_bwt_words"],
            occ_cp=z[f"{tag}_occ_cp"],
            sample_rate=m["sample_rate"],
            ssa_marks=BitVector(bits),
            ssa_values=z[f"{tag}_ssa_values"],
            text_words=z[f"{tag}_text_words"],
            full_sa=z[f"{tag}_full_sa"] if f"{tag}_full_sa" in z else None,
        )
    return GenomeIndex(genome, fms["fwd"], fms["rev"])
