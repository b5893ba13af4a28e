// FM-index occurrence counts and bidirectional extensions on one fused row,
// shared by fm_search.cu, locate.cu, staircase.cu, one_mismatch.cu and
// ring.cu, the owner lookup and row reads of the interval-sharded tables
// (one definition of the split: owner_of, load_row(ShardedFM); one base
// pointer a shard: ShardPtrs or a device table, ShardTable), and the
// block size of a launch of lane groups (block_threads).  No kernel.
//
// The tables are the port's DeviceFMIndex (ops/rank.py): `blocks` holds one
// 12-word row per 128-base block, [8 BWT words | occ checkpoints A, C, G, T],
// with base i of a word at bits 2i (low) and 2i + 1 (high).  Coordinates are
// sentinel-inclusive: k counts the `$` row, which the BWT words leave out,
// so a row is found at k - (k > primary).  These functions compute exactly
// rank.occ_all4 (ops/rank.py:193) and bidirectional._extend /
// _extend_all4 (models/bidirectional.py:75, :104), the torch versions of
// the JAX package's ops/rank.py:163 and models/bidirectional.py.
//
// What bounds a search step: one dependent 48-byte row load a coordinate,
// from the tables (24 MB a strand at chr20 scale: both strands stay in the
// 50 MB L2).  A row is read as three 16-byte loads; the lo and hi rows of an
// interval are both requested before either is used.  The counting is
// unsigned 32-bit arithmetic: per word two masks (low and high bit of every
// 2-bit slot, cut to the first r slots of the block) and three popcounts
// (codes 1, 2, 3); code 0's count is r less the other three, since every
// slot holds one code.  occ1 cuts every word with its own clamped mask;
// lf_below, the LF walk's step, counts the words below the coordinate's
// word in full and masks that one word only.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace gwa {

constexpr int kRowWords = 12;  // 8 BWT words + 4 checkpoints
constexpr int kRowBases = 128;

struct FMTable {
  const int* blocks;  // (nb + 1, 12) int32, 16-byte aligned
  int C[4];           // C[0..3] (C[4] is never read by a search)
  int primary;        // row of $ in the sentinel-inclusive BWT
};

struct FusedRow {
  uint4 w0, w1;  // BWT words 0-3, 4-7
  uint4 cp;      // checkpoints A, C, G, T
  int r;         // bases of the block before the coordinate, 0..127
};

__device__ __forceinline__ FusedRow load_row(const FMTable& t, int k) {
  const int k_adj = k - (k > t.primary ? 1 : 0);
  const uint4* p =
      reinterpret_cast<const uint4*>(t.blocks + static_cast<int64_t>(k_adj >> 7) * kRowWords);
  FusedRow row;
  row.w0 = __ldg(p);
  row.w1 = __ldg(p + 1);
  row.cp = __ldg(p + 2);
  row.r = k_adj & (kRowBases - 1);
  return row;
}

// Mask of the low bit of each of the first `r - 16 j` slots of word j.
__device__ __forceinline__ unsigned slot_mask(int r, int j) {
  const int allowed = min(max(r - 16 * j, 0), 16);
  return (allowed >= 16 ? 0xFFFFFFFFu : (1u << (2 * allowed)) - 1u) & 0x55555555u;
}

__device__ __forceinline__ void count_word(unsigned w, unsigned m, unsigned& c1, unsigned& c2,
                                           unsigned& c3) {
  const unsigned lo = w & m, hi = (w >> 1) & m;
  c1 += __popc(lo & ~hi);
  c2 += __popc(hi & ~lo);
  c3 += __popc(lo & hi);
}

// occ$(c, k) for the four codes at the row's coordinate.
__device__ __forceinline__ void occ4(const FusedRow& row, int (&occ)[4]) {
  const unsigned w[8] = {row.w0.x, row.w0.y, row.w0.z, row.w0.w,
                         row.w1.x, row.w1.y, row.w1.z, row.w1.w};
  unsigned c1 = 0, c2 = 0, c3 = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) count_word(w[j], slot_mask(row.r, j), c1, c2, c3);
  occ[0] = static_cast<int>(row.cp.x) + row.r - static_cast<int>(c1 + c2 + c3);
  occ[1] = static_cast<int>(row.cp.y + c1);
  occ[2] = static_cast<int>(row.cp.z + c2);
  occ[3] = static_cast<int>(row.cp.w + c3);
}

// a[c] for c in 0..3 without a local-memory array.
__device__ __forceinline__ int pick4(const int (&a)[4], int c) {
  return c == 0 ? a[0] : c == 1 ? a[1] : c == 2 ? a[2] : a[3];
}

// The BWT code at the row's coordinate (base r of the block): LF's
// character, read from the row that also gives its count (rank.lf_fused).
__device__ __forceinline__ int row_code(const FusedRow& row) {
  const int q = row.r >> 4;
  const uint4 h = q < 4 ? row.w0 : row.w1;
  const unsigned w = (q & 3) == 0 ? h.x : (q & 3) == 1 ? h.y : (q & 3) == 2 ? h.z : h.w;
  return static_cast<int>((w >> (2 * (row.r & 15))) & 3u);
}

// occ$(c, k) for one code: the backward exact search's update.
__device__ __forceinline__ int occ1(const FusedRow& row, int c) {
  const unsigned w[8] = {row.w0.x, row.w0.y, row.w0.z, row.w0.w,
                         row.w1.x, row.w1.y, row.w1.z, row.w1.w};
  const unsigned pattern = static_cast<unsigned>(c) * 0x55555555u;
  unsigned n = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const unsigned x = w[j] ^ pattern;
    n += __popc(~(x | (x >> 1)) & slot_mask(row.r, j));
  }
  const unsigned cp = c == 0 ? row.cp.x : c == 1 ? row.cp.y : c == 2 ? row.cp.z : row.cp.w;
  return static_cast<int>(cp + n);
}

// x[k] for k in 0..3 by the bits of k: two levels of selects, no branch.
__device__ __forceinline__ unsigned sel4(unsigned x0, unsigned x1, unsigned x2, unsigned x3,
                                         int k) {
  const unsigned lo = (k & 1) ? x1 : x0, hi = (k & 1) ? x3 : x2;
  return (k & 2) ? hi : lo;
}

// The word of the row's eight that holds the coordinate's base (word
// r >> 4): three levels of selects.
__device__ __forceinline__ unsigned row_word(const FusedRow& row) {
  const int q = row.r >> 4;
  const uint4 h = (q & 4) ? row.w1 : row.w0;
  return sel4(h.x, h.y, h.z, h.w, q);
}

// The BWT code at the row's coordinate, from its word (row_word).
__device__ __forceinline__ int word_code(unsigned wq, int r) {
  return static_cast<int>((wq >> (2 * (r & 15))) & 3u);
}

// LF's next row from the coordinate's fused row: C[c] + occ$(c, k), c the
// row's code at the coordinate (code 0 where `coded` is false: no owner of
// the code, as the sharded plain loop reads it), bit for bit C[c] +
// occ1(row, c).  The words below the coordinate's word (wq) count in full
// and wq is cut to its r & 15 slots: the words' predicates and the cut
// depend on r alone, ready before the row arrives.  The four C[c] + cp[c]
// sums do not wait on the code; one two-level select picks the code's.
__device__ __forceinline__ int lf_below(const FusedRow& row, const int (&C)[4],
                                        bool coded = true) {
  const unsigned wq = row_word(row);
  const int c = coded ? word_code(wq, row.r) : 0;
  const unsigned pattern = static_cast<unsigned>(c) * 0x55555555u;
  const unsigned w[7] = {row.w0.x, row.w0.y, row.w0.z, row.w0.w, row.w1.x, row.w1.y, row.w1.z};
  const int q = row.r >> 4;
  const unsigned cut = ((1u << (2 * (row.r & 15))) - 1u) & 0x55555555u;
  unsigned x = wq ^ pattern;
  unsigned n = __popc(~(x | (x >> 1)) & cut);
#pragma unroll
  for (int j = 0; j < 7; ++j) {
    x = w[j] ^ pattern;
    if (j < q) n += __popc(~(x | (x >> 1)) & 0x55555555u);
  }
  const unsigned base =
      sel4(row.cp.x + C[0], row.cp.y + C[1], row.cp.z + C[2], row.cp.w + C[3], c);
  return static_cast<int>(base + n);
}

// The children of one interval on `main` (coordinates mlo, mhi) whose
// synchronized interval on the other table starts at olo, for all four
// codes: (main lo, main hi, other lo, other hi) of each.  Codes in order,
// with the other side's offset  s + sum_{a < c} cnt[a],  where
// s = [mlo <= primary < mhi] counts the `$` suffix, which sorts first.
struct Children {
  int mlo[4], mhi[4], olo[4], ohi[4];
};

__device__ __forceinline__ void children_from_rows(const FMTable& tab, const FusedRow& a,
                                                   const FusedRow& b, int mlo, int mhi, int olo,
                                                   Children& ch) {
  int occ_lo[4], occ_hi[4];
  occ4(a, occ_lo);
  occ4(b, occ_hi);
  const int s = (mlo <= tab.primary && tab.primary < mhi) ? 1 : 0;
  int below = 0;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int cnt = occ_hi[c] - occ_lo[c];
    ch.mlo[c] = tab.C[c] + occ_lo[c];
    ch.mhi[c] = ch.mlo[c] + cnt;
    ch.olo[c] = olo + s + below;
    ch.ohi[c] = ch.olo[c] + cnt;
    below += cnt;
  }
}

__device__ __forceinline__ void extend_all4(const FMTable& tab, int mlo, int mhi, int olo,
                                            Children& ch) {
  const FusedRow a = load_row(tab, mlo);
  const FusedRow b = load_row(tab, mhi);
  children_from_rows(tab, a, b, mlo, mhi, olo, ch);
}

// A synchronized pair of SA intervals: [lo, hi) on the forward-text table
// (pattern P), [rlo, rhi) on the reverse-text table (rev(P)).
struct BiIv {
  int lo, hi, rlo, rhi;
};

// P -> cP: the character update on the forward table.
__device__ __forceinline__ BiIv extend_backward(const FMTable& fwd, const BiIv& v, int c) {
  Children ch;
  extend_all4(fwd, v.lo, v.hi, v.rlo, ch);
  return {pick4(ch.mlo, c), pick4(ch.mhi, c), pick4(ch.olo, c), pick4(ch.ohi, c)};
}

__device__ __forceinline__ FMTable load_table(const int* blocks, const int* C, int primary) {
  FMTable t;
  t.blocks = blocks;
#pragma unroll
  for (int c = 0; c < 4; ++c) t.C[c] = __ldg(C + c);
  t.primary = primary;
  return t;
}

// ---- interval shards (parallel/sharded_index.py).  S interval shards
// on one device, each coordinate space split into ranges [start[s],
// end[s]): the packed BWT coordinates (BWT words and checkpoints, two
// arrays) and the row coordinates (marks, sampled values).  A query reads
// its owner's table only; with no owner it is the plain version's sum of
// zeros.  Each table comes as one base pointer a shard, and every shard's
// table has the same rows.  Two layouts, one kernel template each
// (ShardTable): the shards are the rows of one stacked tensor (base + s *
// stride: arithmetic, nothing loaded), or each lies in an allocation of
// its own, this process's or a peer's mapped through CUDA IPC
// (parallel/peer.py), its S pointers a table in device memory that the
// binding uploads once for a set of shards (ops/fm_search_cuda.py
// device_table), read by the lane that needs one.  The binding decides
// the layout (no table: stacked), and what a split's bounds are
// (disjoint, in order: fm_search_cuda.split_facts, found once for a
// bounds tensor); the bounds are read from the bounds tensors through the
// owner guess.  Nothing is sized by S, and nothing but the card's memory
// limits S.  One kernel alone stages the bounds and pointers in shared
// memory at up to kMaxStaged shards (below).

// One table's shards in a kernel.
template <bool Stacked>
struct ShardTable {
  const int* base;        // Stacked: shard 0's rows, shard s at base + s * stride
  const int* const* ptr;  // else: each shard's base, in a device table (or staged)
  int64_t stride;
  __device__ __forceinline__ const int* operator[](int s) const {
    if constexpr (Stacked) {
      return base + s * stride;
    } else {
      return ptr[s];
    }
  }
};

// A table's shards, made on the host: stacked (shard 0's base and the
// stride in ints) or apart (`table`: the S device pointers in device
// memory).
template <bool Stacked>
inline ShardTable<Stacked> shard_table(const void* base, const uint64_t* table,
                                       int64_t stride) {
  return {static_cast<const int*>(base), reinterpret_cast<const int* const*>(table), stride};
}

// One coordinate space's split: the S bounds in device memory, whether
// they are disjoint and in order (start[0] <= end[0] <= start[1] <= end[1]
// ..., the split of shard_fm_index), and the division (x - base) / width
// (__umulhi(x - base, magic) >> shift, exact for 0 <= x - base < 2^31;
// ops/fm_search_cuda.py owner_divisor) that guesses the owner, base the
// first shard's start.  shard_fm_index splits each space into equal
// widths clamped to n + 1, so there the guess is the owner of every x in
// [0, n]; so it is over any run of consecutive shards of that split (the
// shards one process holds, which start at base), and an x below base
// wraps to a guess that the bounds refuse.
struct Split {
  const int* start;
  const int* end;
  int S;
  unsigned magic;
  int shift;
  bool disjoint;
  bool sorted;
  int base;  // read by the kernel (split_base)
};

// A split, made on the host: the bounds tensors and the binding's findings
// on them (facts bit 0: disjoint, bit 1: in order).
inline Split make_split(const void* start, const void* end, int S, unsigned magic, int shift,
                        int facts) {
  return {static_cast<const int*>(start), static_cast<const int*>(end), S, magic, shift,
          (facts & 1) != 0, (facts & 2) != 0, 0};
}

// Every thread of a sharded kernel calls it once: the guess's base, the
// first shard's start.
__device__ __forceinline__ void split_base(Split& sp) { sp.base = __ldg(sp.start); }

// ---- bounds and pointers staged in shared memory: the sharded locate at
// S <= kMaxStaged.  Its LF step finds two owners on a dependent chain, and
// there bounds in shared memory beat the same bounds read through L1
// (PERF.md section 6: 0.0613 against 0.0673 ms at [11]'s shape, S = 4).
// A block copies the S pointers (ShardPtrs, a kernel parameter) by
// constant index (a parameter indexed by the thread would be copied to
// each thread's stack first, 128 bytes a table) and the bounds, and checks
// the bounds for overlap once.
constexpr int kMaxStaged = 16;

// One table's S <= kMaxStaged base pointers, a kernel parameter.
struct ShardPtrs {
  const int* p[kMaxStaged];
};

// A table's shards, staged: thread 0 stores the S pointers to `smem`
// (kMaxStaged entries), visible to the block after its next __syncthreads
// (load_split's).  Every thread calls it.
template <bool Stacked>
__device__ __forceinline__ ShardTable<Stacked> load_shards(const ShardPtrs& src, int S,
                                                           int64_t stride, const int** smem) {
  if constexpr (!Stacked) {
    if (threadIdx.x == 0) {
#pragma unroll
      for (int d = 0; d < kMaxStaged; ++d) {
        if (d < S) smem[d] = src.p[d];
      }
    }
  }
  return {src.p[0], smem, stride};
}

// Every thread of the block calls it (it synchronises): the S <=
// kMaxStaged bounds copied into s_start / s_end (shared memory, S <=
// blockDim.x) and checked for overlap once a block.
__device__ __forceinline__ Split load_split(const int* start, const int* end, int S,
                                            unsigned magic, int shift, int* s_start,
                                            int* s_end) {
  const int t = threadIdx.x;
  if (t < S) {
    s_start[t] = start[t];
    s_end[t] = end[t];
  }
  __syncthreads();
  bool overlap = false;
  if (t < S) {
    for (int e = 0; e < S; ++e)
      overlap |= e != t && max(s_start[t], s_start[e]) < min(s_end[t], s_end[e]);
  }
  const bool disjoint = !__syncthreads_or(overlap);
  return {s_start, s_end, S, magic, shift, disjoint, false, s_start[0]};
}

// A bound (or base) d of a split: from shared memory (Staged) or read
// through L1.
template <bool Staged>
__device__ __forceinline__ int bound_at(const int* p, int d) {
  if constexpr (Staged) {
    return p[d];
  } else {
    return __ldg(p + d);
  }
}

// The shard whose [start, end) holds x, or -1 (the last such shard where
// ranges overlap), by arithmetic: the guess (x - base) / width, kept when
// its range holds x and the ranges are disjoint (then no other shard holds
// x), else (not staged) a bisection where the bounds are in order (the
// last shard whose start is at most x, kept when its end is above x: in
// order, no earlier shard can hold x), else a scan of every shard's bounds.
template <bool Staged = false>
__device__ __forceinline__ int owner_of(const Split& sp, int x) {
  const unsigned g = min(__umulhi(static_cast<unsigned>(x - sp.base), sp.magic) >> sp.shift,
                         static_cast<unsigned>(sp.S - 1));
  if (sp.disjoint && x >= bound_at<Staged>(sp.start, g) && x < bound_at<Staged>(sp.end, g))
    return static_cast<int>(g);
  if (!Staged && sp.sorted) {
    int lo = 0, hi = sp.S;  // lo: the shards whose start is at most x
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (bound_at<Staged>(sp.start, mid) <= x) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    return lo > 0 && x < bound_at<Staged>(sp.end, lo - 1) ? lo - 1 : -1;
  }
  int s = -1;
  for (int d = 0; d < sp.S; ++d) {
    if (x >= bound_at<Staged>(sp.start, d) && x < bound_at<Staged>(sp.end, d)) s = d;
  }
  return s;
}

// The packed-space tables: each shard's bwt (R, 8) words and occ_cp (R, 4)
// global checkpoint values, 16-byte aligned, and their split.
template <bool Stacked, bool Staged = false>
struct ShardedFM {
  ShardTable<Stacked> bwt, cp;
  Split pk;
  int R, primary;
  int C[4];
};

struct ShardRow {
  FusedRow row;
  bool own;  // some shard owns the coordinate
};

// Shard s's row at packed coordinate k_adj (sentinel removed; s's range
// holds it), split as sharded_index._block_split does: local block clamped
// to the shard's table, r the offset in it.
template <bool Stacked, bool Staged>
__device__ __forceinline__ FusedRow shard_row(const ShardedFM<Stacked, Staged>& t, int s,
                                              int k_adj) {
  const int local = k_adj - bound_at<Staged>(t.pk.start, s);  // >= 0: the shard's range holds k_adj
  const int b = min(local >> 7, t.R - 1);
  const uint4* w = reinterpret_cast<const uint4*>(t.bwt[s] + static_cast<int64_t>(b) * 8);
  FusedRow out;
  out.w0 = __ldg(w);
  out.w1 = __ldg(w + 1);
  out.cp = __ldg(reinterpret_cast<const uint4*>(t.cp[s] + static_cast<int64_t>(b) * 4));
  out.r = local - b * kRowBases;
  return out;
}

// The owner's row at sentinel-inclusive coordinate k (owner_of; where
// ranges overlap, the last shard that holds it).  Nothing is loaded
// without an owner.
template <bool Stacked, bool Staged>
__device__ __forceinline__ ShardRow load_row(const ShardedFM<Stacked, Staged>& t, int k) {
  const int k_adj = k - (k > t.primary ? 1 : 0);
  const int s = owner_of<Staged>(t.pk, k_adj);
  ShardRow out;
  out.own = s >= 0;
  if (out.own) out.row = shard_row(t, s, k_adj);
  return out;
}

// Read code at j clamped into [0, L - 1] (lanes past their read are masked
// by the caller); codes are 0..3, and & 3 keeps a stray code in the table.
__device__ __forceinline__ int code_at(const int* row, int L, int j) {
  return L > 0 ? (__ldg(row + min(max(j, 0), L - 1)) & 3) : 0;
}

// Threads a block for groups of `lanes` lanes needing `group_bytes` of
// shared memory each: `threads`, halved while the block's shared memory is
// more than the device allows a block, down to one warp; 0 when one warp's
// groups do not fit.  The shared memory is returned in `smem`.
inline int block_threads(int threads, int lanes, size_t group_bytes, size_t& smem) {
  int device = 0, most = 48 * 1024;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) !=
          cudaSuccess)
    most = 48 * 1024;
  for (; threads >= 32; threads /= 2) {
    smem = static_cast<size_t>(threads / lanes) * group_bytes;
    if (smem <= static_cast<size_t>(most)) return threads;
  }
  return 0;
}

__device__ __forceinline__ unsigned lanes_below() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

}  // namespace gwa
