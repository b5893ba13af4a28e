"""FASTA/FASTQ parsing and read records (SURVEY.md §2 #14).

Reference parity: `ReadSequence`/`FastqRead` + the FASTA pull parser the Java
tool inherited from utgenome-core.  Host-side, streaming, no external deps.
"""

from __future__ import annotations

import gzip
import io
from dataclasses import dataclass
from typing import Iterator

import numpy as np

from . import dna


@dataclass
class Read:
    name: str
    codes: np.ndarray  # uint8, 0..3 with 4 = N
    qual: np.ndarray | None = None  # phred+33 already decoded to int, or None

    def __len__(self) -> int:
        return self.codes.size


@dataclass
class Contig:
    name: str
    codes: np.ndarray  # uint8, 0..4


def _open(path):
    if str(path).endswith(".gz"):
        return io.TextIOWrapper(gzip.open(path, "rb"))
    return open(path, "r")


def read_fasta(path) -> list[Contig]:
    contigs: list[Contig] = []
    name, chunks = None, []
    with _open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                if name is not None:
                    contigs.append(Contig(name, dna.encode("".join(chunks))))
                name = line[1:].split()[0]
                chunks = []
            else:
                chunks.append(line)
        if name is not None:
            contigs.append(Contig(name, dna.encode("".join(chunks))))
    return contigs


def write_fasta(path, contigs: list[Contig], width: int = 70) -> None:
    with open(path, "w") as fh:
        for c in contigs:
            fh.write(f">{c.name}\n")
            s = dna.decode(c.codes)
            for i in range(0, len(s), width):
                fh.write(s[i : i + width] + "\n")


def iter_fastq(path) -> Iterator[Read]:
    with _open(path) as fh:
        while True:
            header = fh.readline()
            if not header:
                return
            seq = fh.readline().strip()
            fh.readline()  # '+'
            qual = fh.readline().strip()
            q = np.frombuffer(qual.encode(), dtype=np.uint8).astype(np.int32) - 33
            yield Read(header.strip()[1:].split()[0], dna.encode(seq), q)


def iter_reads(path) -> Iterator[Read]:
    """Dispatch on extension: FASTQ (possibly .gz) or FASTA."""
    p = str(path)
    base = p[:-3] if p.endswith(".gz") else p
    if base.endswith((".fq", ".fastq")):
        yield from iter_fastq(path)
    else:
        for c in read_fasta(path):
            yield Read(c.name, c.codes, None)


_ENC_LUT = np.full(256, 4, np.uint8)
for _i, _c in enumerate("ACGT"):
    _ENC_LUT[ord(_c)] = _i
    _ENC_LUT[ord(_c.lower())] = _i


def _parse_fastq_lines(lines):
    """4-line FASTQ records -> (names, codes (B, L), quals (B, L), lengths).

    Vectorised: uniform-length records parse with two frombuffer/reshape
    calls; non-uniform lengths pad with 0 (qual 0).
    """
    if len(lines) % 4 != 0:
        raise ValueError(f"truncated FASTQ: {len(lines)} lines is not a multiple of 4")
    names = [l[1:].split()[0] for l in lines[0::4]]
    seqs = lines[1::4]
    quals = lines[3::4]
    B = len(seqs)
    lengths = np.fromiter((len(s) for s in seqs), np.int32, B)
    qlens = np.fromiter((len(q) for q in quals), np.int32, B)
    if not bool((qlens == lengths).all()):
        i = int(np.nonzero(qlens != lengths)[0][0])
        raise ValueError(
            f"FASTQ record {names[i]!r}: qual length {qlens[i]} != seq length "
            f"{lengths[i]} (truncated file?)"
        )
    L = int(lengths.max())
    if bool((lengths == L).all()):
        codes = _ENC_LUT[
            np.frombuffer("".join(seqs).encode(), np.uint8).reshape(B, L)
        ]
        qarr = (
            np.frombuffer("".join(quals).encode(), np.uint8)
            .reshape(B, L)
            .astype(np.int32)
            - 33
        )
    else:
        codes = np.zeros((B, L), np.uint8)
        qarr = np.zeros((B, L), np.int32)
        for i, (s, q) in enumerate(zip(seqs, quals)):
            codes[i, : len(s)] = _ENC_LUT[np.frombuffer(s.encode(), np.uint8)]
            qarr[i, : len(q)] = np.frombuffer(q.encode(), np.uint8).astype(np.int32) - 33
    return names, codes, qarr, lengths


def iter_fastq_array_batches(path, batch_size: int):
    """Bounded-memory vectorised FASTQ parse (ADVICE r1: the whole-file
    slurp needed several times the file size in host RAM).

    Reads 4*batch_size lines at a time and yields
    (names, codes (B, L) uint8, quals (B, L) int32, lengths (B,) int32)
    per batch — the streaming producer for the CLI array-native align loop.
    """
    import itertools

    with _open(path) as fh:
        while True:
            lines = [l.rstrip("\n") for l in itertools.islice(fh, 4 * batch_size)]
            if not lines:
                return
            yield _parse_fastq_lines(lines)


def read_fastq_arrays(path, batch_size: int = 1 << 18):
    """Whole-file vectorised FASTQ parse -> contiguous arrays.

    Returns (names list[str], codes (B, L) uint8 0..4, quals (B, L) int32
    or None, lengths (B,) int32).  Parses in bounded chunks (see
    ``iter_fastq_array_batches``); only the final arrays are whole-file.
    """
    parts = list(iter_fastq_array_batches(path, batch_size))
    if not parts:
        return [], np.zeros((0, 0), np.uint8), None, np.zeros(0, np.int32)
    if len(parts) == 1:
        return parts[0]
    names = [n for p in parts for n in p[0]]
    lengths = np.concatenate([p[3] for p in parts])
    L = int(max(p[1].shape[1] for p in parts))
    B = len(names)
    codes = np.zeros((B, L), np.uint8)
    qarr = np.zeros((B, L), np.int32)
    at = 0
    for _, c, q, ln in parts:
        codes[at : at + c.shape[0], : c.shape[1]] = c
        qarr[at : at + q.shape[0], : q.shape[1]] = q
        at += c.shape[0]
    return names, codes, qarr, lengths


def write_fastq(path, reads: list[Read]) -> None:
    with open(path, "w") as fh:
        for r in reads:
            q = r.qual if r.qual is not None else np.full(len(r), 30, np.int32)
            fh.write(
                f"@{r.name}\n{dna.decode(r.codes)}\n+\n"
                + (q + 33).astype(np.uint8).tobytes().decode("ascii")
                + "\n"
            )
