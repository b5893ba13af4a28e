// Backward exact FM search on Hopper (sm_90a): one thread a lane, the whole
// search loop in one launch, over one index or over its interval shards.
//
// Replaces the JAX package's device loops
//   genome_weaver_align_tpu/models/exact.py:65          (exact_interval_search)
//   genome_weaver_align_tpu/models/suffix_filter.py:123 (piece_interval_search)
//   genome_weaver_align_tpu/parallel/sharded_pipeline.py:330
//                            (make_sharded_pigeonhole_align's piece search)
// (each a lax.fori_loop under jit) and computes exactly the port's plain
// versions, models/exact.py exact_interval_search_plain,
// models/suffix_filter.py piece_interval_search_plain and
// parallel/sharded_pipeline.py sharded_piece_search_plain.  A lane is a
// read (P = 1) or a (read, piece) of P equal pieces: lane i = b P + p
// searches read b over [floor(len p / P), floor(len (p + 1) / P)), last
// character first.  With a k-mer table (one index only) the last kmer_j
// characters of a lane at least kmer_j long resolve with one table lookup
// first.  The loop runs the plain version's trip count `trip`; a lane stops
// updating once its position passes its start or its interval empties, and
// neither ever recovers, so it leaves the loop there with the interval the
// plain loop ends with.
//
// One loop (search_lane) over a table accessor: OneIndex reads the fused
// rows of one DeviceFMIndex; gwa::ShardedFM finds the shard that owns each
// coordinate (fm_occ.cuh owner_of: x / width, confirmed against the bounds)
// and reads that shard's BWT words and checkpoints (fm_occ.cuh ShardTable:
// the stacked tables' rows, one instantiation, or shards in their own
// allocations, a peer process's mapped through CUDA IPC, through a device
// table of their pointers, the other), which equals the plain loop's sum over the shards of
// sharded_index.local_occ_codes (a coordinate of [0, n] always has one
// owner; a query without one counts 0, as the sum of zeros does).
//
// What bounds it: the rows' bytes at a path's batch (65,536 lanes: two
// 48-byte rows a lane a step, near the measured time), latency below it:
// each step waits on the two rows (lo and hi) that the previous step
// chose; both loads go out before either is used.  The tables stay in L2
// (fm_occ.cuh); the interval lives in registers.  Bytes a step a lane: 96
// from the rows plus 4 of read.
//
// Entries: gwa_backward_search (one index) and gwa_backward_search_sharded
// (any S >= 1 interval shards), plain C functions bound with ctypes; they
// launch on the caller's stream, do not synchronise, allocate nothing, and
// return the launch's CUDA error code.

#include <cuda_runtime.h>

#include <cstdint>

#include "fm_occ.cuh"

namespace {

constexpr int kThreads = 256;

struct SearchArgs {
  const int* reads;    // (B, L) int32 codes 0..3
  const int* lengths;  // (B,)
  const int* tab_lo;   // (4^kmer_j,) or null
  const int* tab_hi;
  int* out_lo;  // (B * P,)
  int* out_hi;
  int B, L, P, n, kmer_j, tab_size, trip;
};

// The fused rows of one index.
struct OneIndex {
  gwa::FMTable fm;
  __device__ __forceinline__ gwa::FusedRow load(int k) const { return gwa::load_row(fm, k); }
  __device__ __forceinline__ int occ(const gwa::FusedRow& row, int c) const {
    return gwa::occ1(row, c);
  }
  __device__ __forceinline__ int C(int c) const { return gwa::pick4(fm.C, c); }
};

// The interval shards' split tables.
template <bool Stacked>
struct Sharded {
  gwa::ShardedFM<Stacked> fm;
  __device__ __forceinline__ gwa::ShardRow load(int k) const { return gwa::load_row(fm, k); }
  __device__ __forceinline__ int occ(const gwa::ShardRow& row, int c) const {
    return row.own ? gwa::occ1(row.row, c) : 0;
  }
  __device__ __forceinline__ int C(int c) const { return gwa::pick4(fm.C, c); }
};

template <class Table>
__device__ __forceinline__ void search_lane(const SearchArgs& a, const Table& tab, int64_t i) {
  const int b = static_cast<int>(i / a.P), p = static_cast<int>(i % a.P);
  const int len = __ldg(a.lengths + b);
  const int start = len * p / a.P, end = len * (p + 1) / a.P;
  const int* read = a.reads + static_cast<int64_t>(b) * a.L;
  int lo = 0, hi = a.n + 1, skip = 0;
  if (a.tab_lo != nullptr && a.kmer_j > 0 && end - start >= a.kmer_j) {
    int idx = 0;
    for (int t = 0; t < a.kmer_j; ++t) {
      idx = (idx << 2) | gwa::code_at(read, a.L, end - a.kmer_j + t);
    }
    idx = min(max(idx, 0), a.tab_size - 1);
    lo = __ldg(a.tab_lo + idx);
    hi = __ldg(a.tab_hi + idx);
    skip = a.kmer_j;
  }
  for (int t = 0; t < a.trip; ++t) {
    const int j = end - 1 - skip - t;
    if (j < start || lo >= hi) break;
    const int c = gwa::code_at(read, a.L, j);
    const auto rl = tab.load(lo);
    const auto rh = tab.load(hi);
    const int base = tab.C(c);
    lo = base + tab.occ(rl, c);
    hi = base + tab.occ(rh, c);
  }
  a.out_lo[i] = lo;
  a.out_hi[i] = hi;
}

__global__ void __launch_bounds__(kThreads)
    backward_search_kernel(const SearchArgs a, const int* blocks, const int* C, int primary) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= static_cast<int64_t>(a.B) * a.P) return;
  search_lane(a, OneIndex{gwa::load_table(blocks, C, primary)}, i);
}

// `fm` comes whole from the host (the tables stacked or in a device table,
// the split's bounds in device memory with the binding's findings).
template <bool Stacked>
__global__ void __launch_bounds__(kThreads)
    backward_search_sharded_kernel(const SearchArgs a, gwa::ShardedFM<Stacked> fm,
                                   const int* C) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= static_cast<int64_t>(a.B) * a.P) return;
  gwa::split_base(fm.pk);
#pragma unroll
  for (int c = 0; c < 4; ++c) fm.C[c] = __ldg(C + c);
  search_lane(a, Sharded<Stacked>{fm}, i);
}

SearchArgs search_args(const void* reads, const void* lengths, int B, int L, int P, int n,
                       int trip, void* out_lo, void* out_hi) {
  SearchArgs a{};
  a.reads = static_cast<const int*>(reads);
  a.lengths = static_cast<const int*>(lengths);
  a.out_lo = static_cast<int*>(out_lo);
  a.out_hi = static_cast<int*>(out_hi);
  a.B = B;
  a.L = L;
  a.P = P;
  a.n = n;
  a.trip = trip;
  return a;
}

unsigned grid(const SearchArgs& a) {
  return static_cast<unsigned>((static_cast<int64_t>(a.B) * a.P + kThreads - 1) / kThreads);
}

template <bool Stacked>
int launch_sharded(const SearchArgs& a, int S, int R, int primary, const gwa::Split& pk,
                   const void* C, const void* bwt, const void* cp, const uint64_t* table,
                   cudaStream_t stream) {
  gwa::ShardedFM<Stacked> fm{};
  fm.bwt = gwa::shard_table<Stacked>(bwt, table, static_cast<int64_t>(R) * 8);
  fm.cp = gwa::shard_table<Stacked>(cp, table ? table + S : nullptr, static_cast<int64_t>(R) * 4);
  fm.pk = pk;
  fm.R = R;
  fm.primary = primary;
  backward_search_sharded_kernel<Stacked><<<grid(a), kThreads, 0, stream>>>(
      a, fm, static_cast<const int*>(C));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// reads (B, L), lengths (B,), blocks (nb + 1, 12) 16-byte aligned, C (5,),
// tab_lo / tab_hi (tab_size,) or null, out_lo / out_hi (B * P,): all int32.
extern "C" int gwa_backward_search(const void* reads, const void* lengths, int B, int L, int P,
                                   const void* blocks, const void* C, int primary, int n,
                                   const void* tab_lo, const void* tab_hi, int tab_size,
                                   int kmer_j, int trip, void* out_lo, void* out_hi,
                                   void* stream) {
  if (B < 0 || L < 0 || P < 1 || kmer_j < 0 || (tab_lo != nullptr && tab_size < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<int64_t>(B) * P == 0) return 0;
  SearchArgs a = search_args(reads, lengths, B, L, P, n, trip, out_lo, out_hi);
  a.tab_lo = static_cast<const int*>(tab_lo);
  a.tab_hi = static_cast<const int*>(tab_hi);
  a.kmer_j = kmer_j;
  a.tab_size = tab_size;
  backward_search_kernel<<<grid(a), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<const int*>(blocks), static_cast<const int*>(C), primary);
  return static_cast<int>(cudaGetLastError());
}

// reads (B, L), lengths (B,), the S interval shards' bwt (R, 8) and occ_cp
// (R, 4) 16-byte aligned, pk_start / pk_end (S,), C (5,), out_lo / out_hi
// (B * P,): all int32.  The shards are the rows of one stacked bwt and
// occ_cp (shard 0's at `bwt` and `cp`) where `table` is null, else each in
// its own allocation, `table` their 2 S pointers in device memory (bwt's,
// then occ_cp's).  The owner guess is (x - pk_start[0]) / width =
// __umulhi(x - pk_start[0], pk_magic) >> pk_shift
// (fm_search_cuda.owner_divisor); pk_facts is the binding's finding on the
// bounds (bit 0: disjoint, bit 1: in order).
extern "C" int gwa_backward_search_sharded(const void* reads, const void* lengths, int B, int L,
                                           int P, int S, int R, const void* bwt, const void* cp,
                                           const void* table, const void* pk_start,
                                           const void* pk_end, unsigned pk_magic, int pk_shift,
                                           int pk_facts, const void* C, int primary, int n,
                                           int trip, void* out_lo, void* out_hi, void* stream) {
  if (B < 0 || L < 0 || P < 1 || S < 1 || R < 1 || pk_shift < 0 || pk_shift > 31)
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<int64_t>(B) * P == 0) return 0;
  const SearchArgs a = search_args(reads, lengths, B, L, P, n, trip, out_lo, out_hi);
  const gwa::Split pk = gwa::make_split(pk_start, pk_end, S, pk_magic, pk_shift, pk_facts);
  const auto tab = static_cast<const uint64_t*>(table);
  const auto st = static_cast<cudaStream_t>(stream);
  if (tab == nullptr) return launch_sharded<true>(a, S, R, primary, pk, C, bwt, cp, tab, st);
  return launch_sharded<false>(a, S, R, primary, pk, C, bwt, cp, tab, st);
}
