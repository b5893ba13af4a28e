// Backward exact FM search on Hopper (sm_90a): one thread a lane, the whole
// search loop in one launch.
//
// Replaces the JAX package's device loops
//   genome_weaver_align_tpu/models/exact.py:65          (exact_interval_search)
//   genome_weaver_align_tpu/models/suffix_filter.py:123 (piece_interval_search)
// (each a lax.fori_loop under jit) and computes exactly the port's plain
// versions, models/exact.py exact_interval_search_plain and
// models/suffix_filter.py piece_interval_search_plain.  A lane is a read
// (P = 1) or a (read, piece) of P equal pieces: lane i = b P + p searches
// read b over [floor(len p / P), floor(len (p + 1) / P)), last character
// first.  With a k-mer table the last kmer_j characters of a lane at least
// kmer_j long resolve with one table lookup first.  The loop runs the plain
// version's trip count `trip`; a lane stops updating once its position
// passes its start or its interval empties, and neither ever recovers, so
// it leaves the loop there with the interval the plain loop ends with.
//
// What bounds it: the rows' bytes at a path's batch (65,536 lanes: two
// 48-byte rows a lane a step, near the measured time), latency below it:
// each step waits on the two rows (lo and hi) that the previous step
// chose; both loads go out before either is used.  The tables stay in L2
// (fm_occ.cuh); the interval lives in registers.  Bytes a step a lane: 96
// from the rows plus 4 of read.
//
// Entry: gwa_backward_search, a plain C function bound with ctypes; it
// launches on the caller's stream, does not synchronise, allocates
// nothing, and returns the launch's CUDA error code.

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

__global__ void __launch_bounds__(kThreads)
    backward_search_kernel(const SearchArgs a, const int* blocks, const int* C, int primary) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= static_cast<int64_t>(a.B) * a.P) return;
  const gwa::FMTable fm = gwa::load_table(blocks, C, primary);
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
    const gwa::FusedRow rl = gwa::load_row(fm, lo);
    const gwa::FusedRow rh = gwa::load_row(fm, hi);
    const int base = gwa::pick4(fm.C, c);
    lo = base + gwa::occ1(rl, c);
    hi = base + gwa::occ1(rh, c);
  }
  a.out_lo[i] = lo;
  a.out_hi[i] = hi;
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
  const int64_t lanes = static_cast<int64_t>(B) * P;
  if (lanes == 0) return 0;
  SearchArgs a{};
  a.reads = static_cast<const int*>(reads);
  a.lengths = static_cast<const int*>(lengths);
  a.tab_lo = static_cast<const int*>(tab_lo);
  a.tab_hi = static_cast<const int*>(tab_hi);
  a.out_lo = static_cast<int*>(out_lo);
  a.out_hi = static_cast<int*>(out_hi);
  a.B = B;
  a.L = L;
  a.P = P;
  a.n = n;
  a.kmer_j = kmer_j;
  a.tab_size = tab_size;
  a.trip = trip;
  const unsigned blocks_n = static_cast<unsigned>((lanes + kThreads - 1) / kThreads);
  backward_search_kernel<<<blocks_n, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<const int*>(blocks), static_cast<const int*>(C), primary);
  return static_cast<int>(cudaGetLastError());
}
