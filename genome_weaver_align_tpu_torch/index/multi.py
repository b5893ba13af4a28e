"""Multi-part index for genomes past the int32 device-index limit.

Torch counterpart of ``genome_weaver_align_tpu.index.multi``.  The genome's
contigs are packed greedily into parts of at most ``part_limit`` bases;
each part has its own FM index (its own BWT coordinates).  An alignment
searches every part and merges each read's hits in the deterministic
(dist, global_pos, strand) order, so a multi-part run equals one over a
single index of the whole genome.  Every part's tables sit in memory at
once here; ``index.multipart_io`` streams parts through the device one at a
time with the same merge.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from genome_weaver_align_tpu_torch.utils import sam as sam_mod
from genome_weaver_align_tpu_torch.utils.fasta import Contig
from genome_weaver_align_tpu_torch.utils.larray import PART_LIMIT as PART_LIMIT_DEFAULT
from genome_weaver_align_tpu_torch.utils.larray import check_device_indexable

from .build import build_fm_index
from .files import Genome, GenomeIndex


@dataclass
class IndexPart:
    gi: GenomeIndex
    global_offset: int  # position of this part's base 0 in the whole genome
    contig_range: tuple[int, int]  # [first, last) contig index in the whole


@dataclass
class MultiIndex:
    names: list[str]  # all contig names, global order
    lengths: list[int]
    parts: list[IndexPart]

    @property
    def n_total(self) -> int:
        return sum(self.lengths)

    def coord(self, global_pos: int) -> tuple[str, int]:
        off = 0
        for name, ln in zip(self.names, self.lengths):
            if global_pos < off + ln:
                return name, global_pos - off
            off += ln
        raise ValueError(global_pos)


def _pack_parts(contigs: list[Contig], part_limit: int) -> list[tuple[int, int, int]]:
    """Pack the contigs greedily, in order, into parts of at most
    ``part_limit`` bases -> [(first, last) contig range, part bases] a part.
    A contig longer than ``part_limit`` raises."""
    packed = []
    i = 0
    while i < len(contigs):
        j = i
        total = 0
        while j < len(contigs) and total + contigs[j].codes.size <= part_limit:
            total += contigs[j].codes.size
            j += 1
        if j == i:
            raise ValueError(f"contig {contigs[i].name} exceeds part_limit {part_limit}; split it")
        packed.append((i, j, total))
        i = j
    return packed


def build_multi_index(
    contigs: list[Contig],
    part_limit: int = PART_LIMIT_DEFAULT,
    sample_rate: int = 8,
    build_rev: bool = False,
) -> MultiIndex:
    """Pack the contigs into parts of at most ``part_limit`` bases, in
    order, and index each part (with the index of its reversed text when
    ``build_rev``).  A contig longer than ``part_limit`` raises."""
    names = [c.name for c in contigs]
    lengths = [int(c.codes.size) for c in contigs]
    parts = []
    global_off = 0
    for i, j, total in _pack_parts(contigs, part_limit):
        genome = Genome.from_contigs(contigs[i:j])
        # a part, with its $ row, must stay device-indexable whatever
        # part_limit the caller chose
        check_device_indexable(genome.codes.size + 1, "index part")
        fwd = build_fm_index(genome.codes, sample_rate=sample_rate)
        rev = (build_fm_index(genome.codes[::-1].copy(), sample_rate=sample_rate)
               if build_rev else None)
        parts.append(IndexPart(GenomeIndex(genome, fwd, rev), global_off, (i, j)))
        global_off += total
    return MultiIndex(names, lengths, parts)


class MultiIndexAligner:
    """Runs ``SuffixFilterAligner`` over every part; merges per read in the
    (dist, global_pos, strand) order."""

    def __init__(self, mi: MultiIndex, k: int = 2, device: str | torch.device = "cuda",
                 **aligner_kwargs):
        from ..models.pipeline import SuffixFilterAligner

        self.mi = mi
        self.k = k
        self.aligners = [
            SuffixFilterAligner(p.gi, k=k, device=device, **aligner_kwargs) for p in mi.parts
        ]

    def align_batch(self, reads):
        per_part = [al.align_batch(reads) for al in self.aligners]
        merged = []
        for ri in range(len(reads)):
            best = None
            for part, hits in zip(self.mi.parts, per_part):
                h = hits[ri]
                if h is None:
                    continue
                key = (h.dist, part.global_offset + h.pos, h.strand)
                if best is None or key < best[0]:
                    best = (key, dataclasses.replace(h, pos=part.global_offset + h.pos))
            merged.append(best[1] if best else None)
        return merged

    def to_sam(self, reads, hits):
        recs = []
        for r, h in zip(reads, hits):
            if h is None:
                recs.append(sam_mod.unmapped(r.name, r.codes, r.qual))
                continue
            name, local = self.mi.coord(h.pos)
            recs.append(sam_mod.mapped(
                r.name, r.codes, name, int(local), h.strand, h.cigar, edit_distance=h.dist,
                mapq=37 if h.n_good == 1 else 3, qual=r.qual,
            ))
        return recs

    def sam_header(self) -> str:
        return sam_mod.header(self.mi.names, self.mi.lengths, prog="gwa-torch")
