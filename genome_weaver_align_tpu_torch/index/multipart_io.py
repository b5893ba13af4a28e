"""On-disk parts and streaming alignment for genomes past the int32 limit.

Torch counterpart of ``genome_weaver_align_tpu.index.multipart_io``, with
the same files, so that either package reads what the other wrote.
``index.multi`` keeps every part in memory; here each part is written on
its own (FM arrays, CSR seed table, its slice of the contig table), and
alignment loops over parts outside and read batches inside: one part's
tables are on the device at a time, every batch is scanned against it, and
each read's best is improve-merged across parts in the (dist, global_pos,
strand) order of ``index.multi.MultiIndexAligner``, so the result equals
one over a single index of the whole genome.

Two layouts, both the JAX package's:

- **npz** (``save_part``/``load_part``, ``part{i}.npz``; the reverse-text
  index, which only the staircase rescue needs, in ``part{i}_rev.npz``,
  ``save_rev``/``load_rev``);
- **flat** (``part{i}.flat/`` with a ``manifest.json``): the device tables
  as raw arrays, exactly what ``ops.rank.DeviceFMIndex`` holds, written
  once by ``convert_part_to_flat``.  Loading is a sequential file read and
  an upload, with no host transformation, and a rescue pass can load the FM
  tables without the seed table.

``build_multipart`` writes a whole genome in parts; ``align_stream_multipart``
aligns a read stream against them.  Differences from the JAX package: the
budgets of ``_part_budgets`` count k + 1 pieces (the JAX code assumes 3),
and the flat streaming path raises when its reads are too short for the
seed table (the JAX path then searches a dummy FM index and unmaps them).
"""

from __future__ import annotations

import gc
import json
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from genome_weaver_align_tpu_torch.utils.bitvector import BitVector
from genome_weaver_align_tpu_torch.utils.fasta import Contig
from genome_weaver_align_tpu_torch.utils.larray import check_device_indexable
from genome_weaver_align_tpu_torch.utils.packing import popcount32

from ..models.pipeline import SuffixFilterAligner, prefetch_result
from ..ops import rank
from .build import FMIndexData, build_fm_index
from .multi import _pack_parts
from .files import Genome, GenomeIndex
from .seedtable import build_seed_table


@dataclass
class PartMeta:
    names: list[str]  # contig names in this part
    lengths: list[int]
    global_offset: int  # genome-global position of this part's base 0


def _fm_arrays(fm: FMIndexData) -> dict:
    """The npz fields of one FM index (forward or reverse text)."""
    marks = fm.ssa_marks.get(np.arange(fm.n + 1))
    return dict(
        n=fm.n, primary=fm.primary, counts=fm.counts, C=fm.C, bwt_words=fm.bwt_words,
        occ_cp_i32=fm.occ_cp.astype(np.int32), sample_rate=fm.sample_rate,
        mark_bits=np.packbits(marks), ssa_values_i32=fm.ssa_values.astype(np.int32),
        text_words=fm.text_words,
    )


def save_part(
    part_dir: Path,
    i: int,
    fm: FMIndexData,
    seed_offsets: np.ndarray,
    seed_positions: np.ndarray,
    seed_j: int,
    meta: PartMeta,
) -> int:
    """Write part i as ``part{i}.npz``; -> the bytes its tables take on the
    device while it is the active part."""
    part_dir = Path(part_dir)
    part_dir.mkdir(parents=True, exist_ok=True)
    arrays = _fm_arrays(fm)
    np.savez(
        part_dir / f"part{i}.npz",
        **arrays,
        seed_offsets=seed_offsets,
        seed_positions=seed_positions,
        seed_j=seed_j,
        names=np.array(meta.names),
        lengths=np.array(meta.lengths, dtype=np.int64),
        global_offset=np.int64(meta.global_offset),
    )
    return int(
        fm.bwt_words.nbytes
        + fm.occ_cp.size * 4  # int32 on the device
        + (fm.n + 1) // 8
        + fm.ssa_values.size * 4
        + fm.text_words.nbytes
        + seed_offsets.nbytes
        + seed_positions.nbytes
    )


def save_rev(part_dir: Path, i: int, rev: FMIndexData) -> None:
    """Write the index of part i's reversed text as ``part{i}_rev.npz``."""
    np.savez(Path(part_dir) / f"part{i}_rev.npz", **_fm_arrays(rev))


def _fm_from_npz(z) -> FMIndexData:
    n = int(z["n"])
    bits = np.unpackbits(z["mark_bits"])[: n + 1].astype(bool)
    return FMIndexData(
        n=n,
        primary=int(z["primary"]),
        counts=z["counts"],
        C=z["C"],
        bwt_words=z["bwt_words"],
        occ_cp=z["occ_cp_i32"].astype(np.int64),
        sample_rate=int(z["sample_rate"]),
        ssa_marks=BitVector(bits),
        ssa_values=z["ssa_values_i32"].astype(np.int64),
        text_words=z["text_words"],
    )


def _genome_meta(names, lengths) -> Genome:
    """A Genome with the contig table only: its codes are empty (windows and
    tracebacks read the packed text)."""
    lengths = np.asarray(lengths, np.int64)
    offsets = np.zeros(lengths.size + 1, dtype=np.int64)
    np.cumsum(lengths, out=offsets[1:])
    return Genome(names=[str(s) for s in names], offsets=offsets,
                  codes=np.zeros(0, dtype=np.uint8), n_mask_spans=np.zeros((0, 2), np.int64))


def load_part(part_dir: Path, i: int):
    """-> (GenomeIndex, (seed_offsets, seed_positions), seed_j, global_offset).

    The Genome's codes are empty: windows and tracebacks read the packed
    ``text_words``, and SAM needs only the contig table."""
    z = np.load(Path(part_dir) / f"part{i}.npz")
    gi = GenomeIndex(_genome_meta(z["names"], z["lengths"]), _fm_from_npz(z), None)
    return gi, (z["seed_offsets"], z["seed_positions"]), int(z["seed_j"]), int(z["global_offset"])


def load_rev(part_dir: Path, i: int) -> FMIndexData | None:
    """The reversed-text index of part i, or None when it was not written.
    Only the staircase rescue needs it."""
    p = Path(part_dir) / f"part{i}_rev.npz"
    return _fm_from_npz(np.load(p)) if p.exists() else None


def build_multipart(
    part_dir: Path,
    contigs: list[Contig],
    part_limit: int,
    seed_j: int,
    sample_rate: int = 8,
    flat: bool = True,
    log=lambda m: None,
) -> "MultiPartIndex":
    """Index a genome in parts of at most ``part_limit`` bases (contigs
    packed in order, as ``index.multi.build_multi_index`` packs them), each
    with its CSR seed table and its reversed-text index (the rescue's);
    write ``parts.json`` and, with ``flat``, the flat layout."""
    part_dir = Path(part_dir)
    part_dir.mkdir(parents=True, exist_ok=True)
    names = [c.name for c in contigs]
    lengths = [int(c.codes.size) for c in contigs]
    part_offsets = []
    goff = 0
    packed = _pack_parts(contigs, part_limit)
    for p, (i, j, total) in enumerate(packed):
        t0 = time.time()
        genome = Genome.from_contigs(contigs[i:j])
        check_device_indexable(genome.codes.size + 1, f"part {p}")
        fm = build_fm_index(genome.codes, sample_rate=sample_rate)
        so, sp = build_seed_table(genome.codes, seed_j)
        save_part(part_dir, p, fm, so, sp, seed_j, PartMeta(names[i:j], lengths[i:j], goff))
        del fm, so, sp
        save_rev(part_dir, p, build_fm_index(genome.codes[::-1].copy(), sample_rate=sample_rate))
        if flat:
            convert_part_to_flat(part_dir, p)
        log(f"part {p}: {total} bp in {time.time() - t0:.1f} s")
        part_offsets.append(goff)
        goff += total
    (part_dir / "parts.json").write_text(json.dumps(dict(
        n_parts=len(packed), names=names, lengths=lengths, part_offsets=part_offsets)))
    return load_multi_index(part_dir)


# ------------------------------------------------------------------ flat


def _marks_to_device(mark_bits: np.ndarray, n_rows: int):
    """np.packbits(bool marks) -> (mark_blocks (mb, 4) uint32, mark_cp (mb+1,) int32).

    Vectorised twin of ``BitVector`` + the ``rank.from_host`` reshape:
    unpack the big-endian bytes, repack them LSB first (little-endian bytes
    viewed as uint32 are the LSB-first words the device reads), then a
    popcount checkpoint every 128-bit block."""
    bits = np.unpackbits(mark_bits)[:n_rows]
    by = np.packbits(bits, bitorder="little")
    pad = (-by.size) % 16  # 128-bit blocks
    if pad or by.size == 0:
        by = np.concatenate([by, np.zeros(max(pad, 16 - by.size), np.uint8)])
    words = by.view("<u4")
    mb = words.size // 4
    per_block = popcount32(words).astype(np.int64).reshape(mb, 4).sum(axis=1)
    mark_cp = np.zeros(mb + 1, dtype=np.int32)
    mark_cp[1:] = np.cumsum(per_block)
    return words.reshape(mb, 4).copy(), mark_cp


_FLAT_FILES = {
    # name -> (filename, dtype); shapes are in the manifest
    "blocks": ("fwd.blocks.bin", "uint32"),
    "mark_blocks": ("fwd.mark_blocks.bin", "uint32"),
    "mark_cp": ("fwd.mark_cp.bin", "int32"),
    "ssa_values": ("fwd.ssa.bin", "int32"),
    "text_words": ("text.bin", "uint32"),
    "seed_offsets": ("seed_offsets.bin", "int32"),
    "seed_positions": ("seed_positions.bin", "int32"),
    "rev.blocks": ("rev.blocks.bin", "uint32"),
    "rev.mark_blocks": ("rev.mark_blocks.bin", "uint32"),
    "rev.mark_cp": ("rev.mark_cp.bin", "int32"),
    "rev.ssa_values": ("rev.ssa.bin", "int32"),
}


def flat_dir(part_dir: Path, i: int) -> Path:
    return Path(part_dir) / f"part{i}.flat"


def _flat_write(d: Path, manifest: dict, name: str, arr: np.ndarray):
    fname, dtype = _FLAT_FILES[name]
    arr = np.ascontiguousarray(arr, dtype=np.dtype(dtype))
    arr.tofile(d / fname)
    manifest["arrays"][name] = {"dtype": dtype, "shape": list(arr.shape)}


def _flat_write_fm(d: Path, manifest: dict, z, prefix: str) -> None:
    _flat_write(d, manifest, prefix + "blocks", rank.fuse_blocks(z["bwt_words"], z["occ_cp_i32"]))
    mb_arr, mcp = _marks_to_device(z["mark_bits"], int(z["n"]) + 1)
    _flat_write(d, manifest, prefix + "mark_blocks", mb_arr)
    _flat_write(d, manifest, prefix + "mark_cp", mcp)
    _flat_write(d, manifest, prefix + "ssa_values", z["ssa_values_i32"])


def convert_part_to_flat(part_dir: Path, i: int, log=lambda m: None) -> Path:
    """Write ``part{i}.flat/`` from ``part{i}.npz`` (and its reversed-text
    index, when there is one); does nothing when the manifest exists.  The
    flat arrays equal what ``rank.from_host`` uploads from the npz."""
    part_dir = Path(part_dir)
    d = flat_dir(part_dir, i)
    if (d / "manifest.json").exists():
        return d
    d.mkdir(parents=True, exist_ok=True)
    z = np.load(part_dir / f"part{i}.npz")
    manifest = {
        "version": 1,
        "n": int(z["n"]),
        "primary": int(z["primary"]),
        "sample_rate": int(z["sample_rate"]),
        "C": [int(x) for x in z["C"]],
        "counts": [int(x) for x in z["counts"]],
        "seed_j": int(z["seed_j"]),
        "global_offset": int(z["global_offset"]),
        "names": [str(s) for s in z["names"]],
        "lengths": [int(x) for x in z["lengths"]],
        "arrays": {},
    }
    t0 = time.time()
    _flat_write_fm(d, manifest, z, "")
    for name in ("text_words", "seed_offsets", "seed_positions"):
        _flat_write(d, manifest, name, z[name])
    del z
    gc.collect()
    rp = part_dir / f"part{i}_rev.npz"
    if rp.exists():
        zr = np.load(rp)
        manifest["rev"] = {
            "n": int(zr["n"]),
            "primary": int(zr["primary"]),
            "sample_rate": int(zr["sample_rate"]),
            "C": [int(x) for x in zr["C"]],
        }
        _flat_write_fm(d, manifest, zr, "rev.")
        del zr
        gc.collect()
    (d / "manifest.json").write_text(json.dumps(manifest))
    log(f"part {i}: flat conversion in {time.time() - t0:.1f}s -> {d}")
    return d


def _flat_read(d: Path, manifest: dict, name: str) -> np.ndarray:
    """Sequential read into process memory (``np.fromfile``): a writable
    array, which ``torch.from_numpy`` takes without a warning, unlike a
    read-only memmap."""
    fname, _ = _FLAT_FILES[name]
    spec = manifest["arrays"][name]
    return np.fromfile(d / fname, dtype=np.dtype(spec["dtype"])).reshape(tuple(spec["shape"]))


_STREAM_ARRAYS = ("text_words", "seed_offsets", "seed_positions")
_FM_ARRAYS = ("blocks", "mark_blocks", "mark_cp", "ssa_values")
_REV_ARRAYS = ("rev.blocks", "rev.mark_blocks", "rev.mark_cp", "rev.ssa_values")


def _manifest(part_dir: Path, i: int) -> dict:
    return json.loads((flat_dir(part_dir, i) / "manifest.json").read_text())


def _read_part_arrays(part_dir: Path, i: int, names) -> dict:
    """Read part i's flat arrays into host memory; reads files only (the
    prefetch thread runs it, and every upload stays on the caller's thread)."""
    d = flat_dir(part_dir, i)
    manifest = _manifest(part_dir, i)
    return {n: _flat_read(d, manifest, n) for n in names if n in manifest["arrays"]}


@dataclass
class FlatPart:
    """One flat part's device tables and host metadata."""

    fm: object  # DeviceFMIndex; 1-row dummy tables when loaded without the
    # FM (the seed streaming path reads only fm.n and fm.C)
    text_words: torch.Tensor  # (nw,) int32 packed text on the device
    text_host: np.ndarray  # (nw,) uint32 on the host (slow-path windows)
    seed_tab: tuple | None  # (offsets, positions) int32 on the device
    genome: Genome  # contig table only (empty codes)
    n: int
    seed_j: int
    global_offset: int
    has_rev: bool


def _device_fm(get, prefix: str, meta: dict, device):
    return rank.from_arrays(
        blocks=get(prefix + "blocks"), C=np.asarray(meta["C"], np.int64),
        primary=meta["primary"], mark_blocks=get(prefix + "mark_blocks"),
        mark_cp=get(prefix + "mark_cp"), ssa_values=get(prefix + "ssa_values"),
        n=meta["n"], sample_rate=meta["sample_rate"], device=device,
    )


def load_part_flat(
    part_dir: Path,
    i: int,
    *,
    want_seed: bool = True,
    want_fm: bool = True,
    arrays: dict | None = None,
    device: str | torch.device = "cuda",
) -> FlatPart:
    """Read and upload one flat part.  ``want_fm=False`` uploads 1-row
    dummy FM tables (the seed streaming step never reads them);
    ``want_seed=False`` leaves out the seed table (a rescue pass needs the
    FM tables and the text only).  ``arrays`` holds host arrays a prefetch
    thread already read (``_read_part_arrays``).  The uploads are queued
    without waiting; synchronise before timing them."""
    d = flat_dir(part_dir, i)
    manifest = _manifest(part_dir, i)
    arrays = arrays or {}

    def get(name):
        return arrays[name] if name in arrays else _flat_read(d, manifest, name)

    if want_fm:
        fm = _device_fm(get, "", manifest, device)
    else:
        fm = rank.from_arrays(
            blocks=np.zeros((1, 12), np.uint32), C=np.asarray(manifest["C"], np.int64),
            primary=manifest["primary"], mark_blocks=np.zeros((1, 4), np.uint32),
            mark_cp=np.zeros(2, np.int32), ssa_values=np.zeros(1, np.int32),
            n=manifest["n"], sample_rate=manifest["sample_rate"], device=device,
        )
    text_host = get("text_words")
    text = rank._upload(text_host, device)
    seed = None
    if want_seed:
        seed = (rank._upload(get("seed_offsets"), device),
                rank._upload(get("seed_positions"), device))
    return FlatPart(
        fm=fm,
        text_words=text,
        text_host=text_host,
        seed_tab=seed,
        genome=_genome_meta(manifest["names"], manifest["lengths"]),
        n=manifest["n"],
        seed_j=manifest["seed_j"],
        global_offset=manifest["global_offset"],
        has_rev="rev" in manifest,
    )


def load_rev_flat(part_dir: Path, i: int, arrays: dict | None = None,
                  device: str | torch.device = "cuda"):
    """DeviceFMIndex of part i's reversed text from the flat layout, or None."""
    d = flat_dir(part_dir, i)
    manifest = _manifest(part_dir, i)
    if "rev" not in manifest:
        return None
    arrays = arrays or {}

    def get(name):
        return arrays[name] if name in arrays else _flat_read(d, manifest, name)

    return _device_fm(get, "rev.", manifest["rev"], device)


def has_flat(part_dir: Path, n_parts: int) -> bool:
    return all((flat_dir(part_dir, p) / "manifest.json").exists() for p in range(n_parts))


# ------------------------------------------------------------ streaming


@dataclass
class MultiPartIndex:
    part_dir: Path
    n_parts: int
    names: list[str]  # all contig names, global order
    lengths: list[int]
    part_offsets: list[int]


def load_multi_index(part_dir: Path) -> MultiPartIndex:
    meta = json.loads((Path(part_dir) / "parts.json").read_text())
    return MultiPartIndex(part_dir=Path(part_dir), n_parts=meta["n_parts"], names=meta["names"],
                          lengths=meta["lengths"], part_offsets=meta["part_offsets"])


def _part_budgets(n: int, seed_j: int, k: int) -> tuple[int, int, int]:
    """(max_hits, max_cands, verify_slack) scaled to the part's size.

    The mean j-mer bucket holds n / 4^j positions, so the small-genome
    defaults (8 hits, 12 candidates) would send every read of a Gbp part
    into the tier-1 rerun.  ``max_cands`` covers the worst case of k + 1
    pieces x max_hits (capped at 128); the verify slack, the compact pool's
    mean lanes a read, covers the mean proposal count with a 20% margin.
    Small parts keep the 8 / 12 / 4 shapes."""
    P = k + 1
    mean_bucket = n / 4**seed_j
    max_hits = max(8, min(64, int(1.5 * mean_bucket)))
    max_cands = max(12, min(128, P * max_hits))
    slack = max(4, min(max_cands, int(0.9 * P * mean_bucket)))
    return max_hits, max_cands, slack


class _Best:
    """Each read's running best, improve-merged in the deterministic
    (dist, global_pos, strand) order of ``index.multi.MultiIndexAligner``."""

    INF = 1 << 20

    def __init__(self, n: int):
        self.dist = np.full(n, self.INF, np.int64)
        self.gpos = np.full(n, np.int64(1) << 62, np.int64)
        self.strand = np.zeros(n, np.int64)
        self.n_good = np.zeros(n, np.int64)
        self.overflow = np.zeros(n, bool)

    def merge(self, rows, ah, goff, m=None):
        """Improve-merge a batch's ArrayHits ``ah`` (its first m rows) at ``rows``."""
        m = len(rows) if m is None else m
        d = np.where(ah.mapped[:m], ah.dist[:m], self.INF)
        g = np.where(ah.mapped[:m], ah.pos[:m] + goff, np.int64(1) << 62)
        st = ah.strand[:m]
        cur_d, cur_g, cur_s = self.dist[rows], self.gpos[rows], self.strand[rows]
        better = (d < cur_d) | ((d == cur_d) & ((g < cur_g) | ((g == cur_g) & (st < cur_s))))
        self.dist[rows] = np.where(better, d, cur_d)
        self.gpos[rows] = np.where(better, g, cur_g)
        self.strand[rows] = np.where(better, st, cur_s)
        # n_good adds up over parts: a read unique in its winning part with
        # an equal copy in another part is ambiguous.  A rescue pass only
        # sees reads with no hit in the stream, so nothing counts twice.
        self.n_good[rows] = self.n_good[rows] + np.asarray(ah.n_good[:m], np.int64)
        self.overflow[rows] |= np.asarray(ah.overflow[:m], bool)
        return better


def _run_chunks(al, reads, cohort, L: int, chunk: int, on_hits) -> None:
    """Align ``reads[cohort]`` in chunks of ``chunk`` rows (a cohort of one
    chunk or less padded to a power of two of at least 128), submitting
    chunk N+1 before finishing chunk N; ``on_hits(rows, ah)`` takes each
    chunk's ArrayHits."""
    def submit(ch):
        P = chunk if cohort.size > chunk else max(128, 1 << (int(ch.size) - 1).bit_length())
        sel = np.concatenate([ch, np.full(P - ch.size, ch[0], ch.dtype)])
        return al.align_arrays_submit(reads[sel], np.full(P, L, np.int32))

    chunks = [cohort[o:o + chunk] for o in range(0, cohort.size, chunk)]
    pending = submit(chunks[0])
    prefetch_result(pending)
    for ci, ch in enumerate(chunks):
        nxt = submit(chunks[ci + 1]) if ci + 1 < len(chunks) else None
        prefetch_result(nxt)
        ah = al.align_arrays_finish(pending)
        pending = nxt
        on_hits(ch, ah)


def _rescue_with(al2, reads, un, best: _Best, goff: int, L: int, chunk=1024) -> int:
    """Staircase-rescue the reads at ``un`` against one part, improve-merged
    into ``best``; -> the reads it improved.  Chunks of 1,024 reads, the
    JAX package's shape (2,048 strand-stacked lanes)."""
    n = [0]

    def merge(ch, ah):
        n[0] += int(best.merge(ch, ah, goff, m=ch.size).sum())

    _run_chunks(al2, reads, un, L, chunk, merge)
    return n[0]


def _sync(device) -> None:
    """Wait for the uploads queued on ``device`` (the JAX code's
    ``block_until_ready``), so they bill to the load time."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _peak_bytes(device) -> int | None:
    """Peak device bytes allocated since the last reset, then reset."""
    if torch.device(device).type != "cuda":
        return None
    peak = torch.cuda.max_memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    return int(peak)


def align_stream_multipart(
    mi: MultiPartIndex,
    reads: np.ndarray,  # (N, L) int8 forward verify codes
    lengths_row: np.ndarray,  # (batch,) int32: one uniform batch shape
    batch: int,
    k: int = 2,
    log=lambda m: None,
    stats: dict | None = None,
    device: str | torch.device = "cuda",  # the CPU only when asked for
):
    """Align every read against every part, improve-merging each read's
    best.  -> (best_dist, best_gpos, best_strand, mapped, align_s, load_s)
    with genome-global positions.  Parts stream through the device one at
    a time.

    ``align_s`` counts alignment and merge time; ``load_s`` is the parts'
    read and upload time, a once-per-part cost that a real stream spreads
    over millions of reads.  ``stats`` (a dict) receives the layout, each
    batch's ms, the tier-1 rerun count, the rescue's cohort and the reads
    it improved, and on a CUDA device each part's and the rescue's peak
    device bytes (``peak_mem_bytes``, ``rescue_peak_mem_bytes``).

    Streaming passes run the seed search and tier 1 only.  The staircase
    (tier 2) is deferred to one rescue pass over the reads still unmapped
    after the merge over all parts: during the stream, a read whose locus
    lies in another part looks like a repeat-flooded one.  The rescue needs
    every part's reversed-text index and is skipped without them.  In the
    flat layout it loads every part's FM and reversed tables at once (no
    seed tables) and runs two tiers: the plain staircase over the whole
    cohort, then the narrow-left one over the reads the first left."""
    device = torch.device(device)
    if stats is None:
        stats = {}
    N = reads.shape[0]
    n_batches = -(-N // batch)  # a partial tail batch is padded, not dropped
    padN = n_batches * batch
    if padN != N:
        reads = np.concatenate([reads, np.broadcast_to(reads[:1], (padN - N, reads.shape[1]))])
    best = _Best(padN)
    L = reads.shape[1]
    flat = has_flat(mi.part_dir, mi.n_parts)
    stats["format"] = "flat" if flat else "npz"
    stats["batch_ms"] = []
    stats["n_overflow_rerun"] = 0
    stats["peak_mem_bytes"] = []
    align_s = 0.0
    load_s = 0.0
    last = mi.n_parts - 1
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    # one thread reads the next part's files ahead; leaving, a read still
    # queued is cancelled and a running one is not waited for (the rescue
    # tables' read, when no read is left to rescue)
    pool = ThreadPoolExecutor(1)
    try:
        def _stream_part(al, goff, p, deferred=None):
            nonlocal align_s
            t0 = time.time()

            def submit(b):
                return al.align_arrays_submit(reads[b * batch:(b + 1) * batch], lengths_row)

            pending = submit(0)
            prefetch_result(pending)
            for b in range(n_batches):
                tb = time.time()
                nxt = submit(b + 1) if b + 1 < n_batches else None
                prefetch_result(nxt)
                ah = al.align_arrays_finish(pending)
                pending = nxt
                dt = (time.time() - tb) * 1e3
                stats["batch_ms"].append(round(dt, 1))
                stats["n_overflow_rerun"] += al.last_stats.get("n_overflow_fallback", 0)
                log(f"part {p} batch {b}: {dt:.0f} ms, stats={al.last_stats}")
                sl = np.arange(b * batch, (b + 1) * batch)
                best.merge(sl, ah, goff)
                if deferred is not None:
                    deferred.append(sl[np.asarray(ah.overflow, bool) & ~np.asarray(ah.mapped, bool)])
            align_s += time.time() - t0

        def _deferred_tier1(al, goff, p, cohorts):
            """The bigger-budget rerun of the part's overflowed, unmapped reads,
            once a part instead of once a batch (results are per read, so only
            the schedule changes; the cohort is unmapped, so an improve-merge is
            the per-batch replace)."""
            nonlocal align_s
            cohort = np.concatenate(cohorts) if cohorts else np.zeros(0, np.int64)
            stats["n_overflow_rerun"] += int(cohort.size)
            if not cohort.size:
                return
            t0 = time.time()
            fb = al._get_fb()
            _run_chunks(fb, reads, cohort, L, fb.FB_CHUNK,
                        lambda ch, ah: best.merge(ch, ah, goff, m=ch.size))
            dt = time.time() - t0
            align_s += dt
            log(f"part {p} deferred tier-1: {cohort.size} overflow-unmapped reads in {dt:.2f}s")

        def _part_done(p):
            peak = _peak_bytes(device)
            stats["peak_mem_bytes"].append(peak)
            log(f"part {p}: streamed, peak device memory "
                + ("not measured (no CUDA device)" if peak is None else f"{peak} B"))

        # ---------------------------- flat path ----------------------------
        if flat:
            rescue_planned = all("rev" in _manifest(mi.part_dir, p) for p in range(mi.n_parts))
            # the next part's arrays are read into host memory while the
            # current part streams; uploads stay on this thread
            nxt_arrays = pool.submit(_read_part_arrays, mi.part_dir, 0, _STREAM_ARRAYS)
            for p in range(mi.n_parts):
                tp = time.time()
                # dummy FM tables for every part: the seed path never reads them
                fp = load_part_flat(mi.part_dir, p, want_seed=True, want_fm=False,
                                    arrays=nxt_arrays.result(), device=device)
                if int(np.min(lengths_row)) // (k + 1) < fp.seed_j:
                    raise ValueError(
                        f"reads of {int(np.min(lengths_row))} bases in k + 1 = {k + 1} pieces are "
                        f"shorter than the seed table's j = {fp.seed_j}: the flat streaming path "
                        "has no FM tables to search them")
                max_hits, max_cands, slack = _part_budgets(fp.n, fp.seed_j, k)
                al = SuffixFilterAligner(
                    GenomeIndex(fp.genome, None, None), k=k, max_hits_per_piece=max_hits,
                    max_cands=max_cands, verify_slack=slack,
                    overflow_fallback=False,  # tier 1 runs deferred, once a part
                    device=device,
                    device_tables={"fm": fp.fm, "text": fp.text_words, "text_host": fp.text_host},
                )
                al.seed_tab = fp.seed_tab
                al.seed_j = fp.seed_j
                _sync(device)
                if p + 1 < mi.n_parts:
                    nxt_arrays = pool.submit(_read_part_arrays, mi.part_dir, p + 1, _STREAM_ARRAYS)
                elif rescue_planned:
                    nxt_arrays = pool.submit(_read_part_arrays, mi.part_dir, last,
                                             _FM_ARRAYS + _REV_ARRAYS)
                dt = time.time() - tp
                load_s += dt
                log(f"part {p}: flat load+upload in {dt:.1f}s (n={fp.n}, max_hits={max_hits}, "
                    f"max_cands={max_cands}, slack={slack})")
                deferred: list = []
                _stream_part(al, fp.global_offset, p, deferred=deferred)
                _deferred_tier1(al, fp.global_offset, p, deferred)
                _part_done(p)
                # every tensor of the part goes: the aligner, its tier-1 copy
                # (dropped with it) and the FlatPart
                del al, fp
                gc.collect()
                if device.type == "cuda":
                    torch.cuda.empty_cache()

            # deferred tier 2: every part's FM and reversed tables at once (no
            # seed tables); tier A, the plain staircase, over the whole cohort,
            # then tier B, narrow-left, over the reads tier A could not place
            un = np.nonzero(best.dist[:N] > k)[0]
            stats["un_before_rescue"] = int(un.size)
            stats["rescued"] = 0
            if un.size and rescue_planned:
                order = [last] + list(range(mi.n_parts - 1))
                rescue_arrays = nxt_arrays  # read while the last part streamed
                parts_res = []
                tp = time.time()
                for ri, p in enumerate(order):
                    arrs = rescue_arrays.result()
                    if ri + 1 < len(order):
                        rescue_arrays = pool.submit(_read_part_arrays, mi.part_dir, order[ri + 1],
                                                    _FM_ARRAYS + _REV_ARRAYS)
                    fp_r = load_part_flat(mi.part_dir, p, want_seed=False, want_fm=True,
                                          arrays=arrs, device=device)
                    rev = load_rev_flat(mi.part_dir, p, arrays=arrs, device=device)
                    parts_res.append((p, fp_r, rev))
                _sync(device)
                load_s += time.time() - tp

                def _mk(fp_r, rev, narrow):
                    return SuffixFilterAligner(
                        GenomeIndex(fp_r.genome, None, None), k=k, max_hits_per_piece=8,
                        use_staircase=True, verify_slack=16, overflow_fallback=False,
                        staircase_slots=64, staircase_narrow_left=narrow, device=device,
                        device_tables={"fm": fp_r.fm, "text": fp_r.text_words, "rev": rev,
                                       "text_host": fp_r.text_host},
                    )

                for tier, narrow in (("A/plain", False), ("B/narrow", True)):
                    cohort = np.nonzero(best.dist[:N] > k)[0] if narrow else un
                    if not cohort.size:
                        break
                    for p, fp_r, rev in parts_res:
                        t0 = time.time()
                        n_r = _rescue_with(_mk(fp_r, rev, narrow), reads, cohort, best,
                                           fp_r.global_offset, L)
                        align_s += time.time() - t0
                        stats["rescued"] += n_r
                        log(f"rescue tier {tier} part {p}: {cohort.size} unmapped reads in "
                            f"{time.time() - t0:.1f}s, improved {n_r}")
                stats["rescue_peak_mem_bytes"] = _peak_bytes(device)
                del parts_res
                gc.collect()
            return _finish(best, N, k, align_s, load_s)

        # ----------------------------- npz path ----------------------------
        nxt_part = pool.submit(load_part, mi.part_dir, 0)
        for p in range(mi.n_parts):
            tp = time.time()
            # the host load of part p+1 overlaps part p's stream below; the
            # uploads stay on this thread, in the aligner's constructor
            gi, seed_tab, seed_j, goff = nxt_part.result()
            if p + 1 < mi.n_parts:
                nxt_part = pool.submit(load_part, mi.part_dir, p + 1)
            max_hits, max_cands, slack = _part_budgets(gi.fwd.n, seed_j, k)
            al = SuffixFilterAligner(gi, k=k, max_hits_per_piece=max_hits, seed_table=seed_tab,
                                     seed_j=seed_j, max_cands=max_cands, verify_slack=slack,
                                     device=device)
            _sync(device)
            load_s += time.time() - tp
            log(f"part {p}: loaded+uploaded in {time.time() - tp:.1f}s (n={gi.fwd.n}, "
                f"max_hits={max_hits}, max_cands={max_cands})")
            _stream_part(al, goff, p)
            _part_done(p)
            del al, gi, seed_tab
            gc.collect()
            if device.type == "cuda":
                torch.cuda.empty_cache()

        # deferred tier 2: the staircase over the still-unmapped reads, a part at a time
        un = np.nonzero(best.dist[:N] > k)[0]
        stats["un_before_rescue"] = int(un.size)
        stats["rescued"] = 0
        have_rev = all((Path(mi.part_dir) / f"part{p}_rev.npz").exists() for p in range(mi.n_parts))
        if un.size and have_rev:
            for p in range(mi.n_parts):
                tp = time.time()
                gi, _seed, _j, goff = load_part(mi.part_dir, p)
                gi = GenomeIndex(gi.genome, gi.fwd, load_rev(mi.part_dir, p))
                # a 64-slot pool: a high-copy family branches far past the
                # 16-slot default, and the rescue cohort is small
                al2 = SuffixFilterAligner(gi, k=k, max_hits_per_piece=8, use_staircase=True,
                                          verify_slack=16, overflow_fallback=False,
                                          staircase_slots=64, staircase_narrow_left=True,
                                          device=device)
                _sync(device)
                load_s += time.time() - tp
                t0 = time.time()
                n_r = _rescue_with(al2, reads, un, best, goff, L)
                align_s += time.time() - t0
                stats["rescued"] += n_r
                log(f"rescue part {p}: staircase over {un.size} unmapped reads in "
                    f"{time.time() - t0:.1f}s, improved {n_r}")
                del al2, gi
                gc.collect()
        return _finish(best, N, k, align_s, load_s)
    finally:
        pool.shutdown(wait=False, cancel_futures=True)


def _finish(best: _Best, N: int, k: int, align_s, load_s):
    dist, gpos, strand = best.dist[:N], best.gpos[:N], best.strand[:N]
    mapped = dist <= k
    return dist, gpos, strand, mapped, align_s, load_s
