// Sparse-SA locate on Hopper (sm_90a): the LF walk of one BWT row to its
// nearest sampled row, one thread a row, the whole walk in one launch, over
// one index or over its interval shards.
//
// Replaces the JAX package's device loops
//   genome_weaver_align_tpu/ops/rank.py:234                 (locate)
//   genome_weaver_align_tpu/parallel/sharded_index.py:267   (locate)
// (each a lax.fori_loop of sample_rate steps under jit) and computes exactly
// the port's plain versions, ops/rank.py locate_plain and
// parallel/sharded_index.py locate_plain (default merge):
//   while the row is not marked (at most sample_rate times): row = LF(row), d++
//   position = ssa_values[rank1(marks, row)] + d
// The plain loops take LF sample_rate times and keep a marked row where it
// is; a marked row stays marked, so stopping at the first mark gives the
// same row and d.  Rows are in [0, n] (callers clamp); every table index is
// also clamped into its table, so no row reads outside the tables.
//
// One index (locate_kernel): a step reads the row's 16-byte mark block
// (rank.MARK_BLOCK_BITS = 128 rows) and its 48-byte fused row together, the
// row before the mark is known: one dependent round trip a step instead of
// two, for one row read in vain at the marked end.  LF's code comes from the
// row that gives its count (rank.lf_fused); the count is fm_occ.cuh's occ1.
// At the end, rank1 is the mark block's checkpoint plus the popcount of the
// block's bits below the row (the words masked as rank._mark_rank1 does),
// then one sampled value.
//
// Interval shards (locate_sharded_kernel): the same walk over the stacked
// ShardedFMIndex tables (parallel/sharded_index.py:56).  Each step finds the
// row's owner in the row coordinates (marks, sampled values) and in the
// packed coordinates (BWT words and checkpoints, two arrays), from the S
// bounds in shared memory, and reads only the owners' tables.  That equals
// the plain loop's sums over the shards, where non-owners add 0, including
// its quirks: the BWT code has an owner only below n (local_bwt_char), a
// coordinate with no owner adds 0, and the sampled slot is clamped to the
// shard's table (local_ssa_value).
//
// What bounds it: bytes and latency of the dependent chain.  A row walks
// about sample_rate / 2 steps; each reads a 48-byte row (two 32-byte
// sectors) and a 16-byte mark block, and the end one checkpoint and one
// sampled value.  The tables stay in L2 at the paths' index sizes except
// the sampled values.  The walk's latency is (steps + 2) dependent loads.
//
// Entries: gwa_locate (one index) and gwa_locate_sharded (S = 1..16
// interval shards), plain C functions bound with ctypes; they launch on the
// caller's stream, do not synchronise, allocate nothing, and return the
// launch's CUDA error code.

#include <cuda_runtime.h>

#include <cstdint>

#include "fm_occ.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMarkBits = 128;  // rows a mark block (4 words)

// The row's bit in its 16-byte mark block (bit at offset rem, 0..127).
__device__ __forceinline__ bool mark_bit(const uint4& m, int rem) {
  const int q = rem >> 5;
  const unsigned w = q == 0 ? m.x : q == 1 ? m.y : q == 2 ? m.z : m.w;
  return (w >> (rem & 31)) & 1u;
}

// Marked rows of the block before offset rem (0..128).
__device__ __forceinline__ int marks_below(const uint4& m, int rem) {
  const unsigned w[4] = {m.x, m.y, m.z, m.w};
  int n = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int allowed = min(max(rem - 32 * j, 0), 32);
    const unsigned mask = allowed >= 32 ? 0xFFFFFFFFu : (1u << allowed) - 1u;
    n += __popc(w[j] & mask);
  }
  return n;
}

__device__ __forceinline__ uint4 load4(const int* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

struct LocateArgs {
  const int* rows;  // (Q,)
  int* out;         // (Q,)
  int64_t Q;
  int n, sample_rate;
};

// One index: DeviceFMIndex's fused rows and marks.
struct OneMarks {
  const int* blocks;  // (mb, 4) mark words
  const int* cp;      // (mb + 1,) rank1 checkpoints
  const int* ssa;     // (n_ssa,) sampled values in row order
  int mb, n_ssa;
};

__global__ void __launch_bounds__(kThreads)
    locate_kernel(const LocateArgs a, const int* blocks, const int* C, int primary,
                  const OneMarks m) {
  const int64_t q = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (q >= a.Q) return;
  const gwa::FMTable fm = gwa::load_table(blocks, C, primary);
  int i = __ldg(a.rows + q), d = 0;
  int mblk = min(max(i >> 7, 0), m.mb - 1);
  uint4 marks = load4(m.blocks + static_cast<int64_t>(mblk) * 4);
  for (int t = 0; t < a.sample_rate; ++t) {
    const gwa::FusedRow row = gwa::load_row(fm, min(max(i, 0), a.n));
    if (mark_bit(marks, i & (kMarkBits - 1))) break;
    const int c = gwa::row_code(row);
    i = gwa::pick4(fm.C, c) + gwa::occ1(row, c);
    ++d;
    mblk = min(max(i >> 7, 0), m.mb - 1);
    marks = load4(m.blocks + static_cast<int64_t>(mblk) * 4);
  }
  const int rank = __ldg(m.cp + mblk) + marks_below(marks, i - mblk * kMarkBits);
  a.out[q] = __ldg(m.ssa + min(max(rank, 0), m.n_ssa - 1)) + d;
}

// Interval shards: ShardedFMIndex's stacked tables.
struct ShardMarks {
  const int* blocks;  // (S, mbs, 4) mark words
  const int* cp;      // (S, mbs + 1) global rank1 at the local block starts
  const int* ssa;     // (S, vmax) sampled values
  const int* row_start;  // (S,) row-coordinate bounds
  const int* row_end;
  const int* ssa_base;   // (S,) marked rows before each shard
  int mbs, vmax;
};

__global__ void __launch_bounds__(kThreads)
    locate_sharded_kernel(const LocateArgs a, gwa::ShardedFM fm, const int* C,
                          const int* pk_start, const int* pk_end, const ShardMarks m) {
  __shared__ int s_ps[gwa::kMaxShards], s_pe[gwa::kMaxShards];
  __shared__ int s_rs[gwa::kMaxShards], s_re[gwa::kMaxShards], s_base[gwa::kMaxShards];
  if (threadIdx.x < fm.S) {
    s_ps[threadIdx.x] = pk_start[threadIdx.x];
    s_pe[threadIdx.x] = pk_end[threadIdx.x];
    s_rs[threadIdx.x] = m.row_start[threadIdx.x];
    s_re[threadIdx.x] = m.row_end[threadIdx.x];
    s_base[threadIdx.x] = m.ssa_base[threadIdx.x];
  }
  __syncthreads();
  const int64_t q = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (q >= a.Q) return;
  fm.pk_start = s_ps;
  fm.pk_end = s_pe;
#pragma unroll
  for (int c = 0; c < 4; ++c) fm.C[c] = __ldg(C + c);

  int i = __ldg(a.rows + q), d = 0;
  int sr = -1, b = 0, rem = 0;  // the row's owner, its local mark block, the offset in it
  uint4 marks = make_uint4(0, 0, 0, 0);
  for (int t = 0;; ++t) {
    sr = gwa::shard_of(s_rs, s_re, fm.S, i);
    if (sr >= 0) {
      const int local = i - s_rs[sr];
      b = min(local / kMarkBits, m.mbs - 1);
      rem = local - b * kMarkBits;
      marks = load4(m.blocks + (static_cast<int64_t>(sr) * m.mbs + b) * 4);
    }
    if (t == a.sample_rate) break;
    const gwa::ShardRow row = gwa::load_row(fm, i);  // before the mark is known
    if (sr >= 0 && mark_bit(marks, rem)) break;
    const int k_adj = i - (i > fm.primary ? 1 : 0);
    const int c = row.own && k_adj < a.n ? gwa::row_code(row.row) : 0;
    i = gwa::pick4(fm.C, c) + (row.own ? gwa::occ1(row.row, c) : 0);
    ++d;
  }
  int value = 0;
  if (sr >= 0) {
    const int rank = __ldg(m.cp + static_cast<int64_t>(sr) * (m.mbs + 1) + b) +
                     marks_below(marks, rem);
    const int slot = min(max(rank - s_base[sr], 0), m.vmax - 1);
    value = __ldg(m.ssa + static_cast<int64_t>(sr) * m.vmax + slot);
  }
  a.out[q] = value + d;
}

unsigned grid(int64_t Q) { return static_cast<unsigned>((Q + kThreads - 1) / kThreads); }

}  // namespace

// rows and out (Q,), blocks (nb_rows, 12) 16-byte aligned, C (5,),
// mark_blocks (mb, 4) 16-byte aligned, mark_cp (mb + 1,), ssa_values
// (n_ssa,): all int32.
extern "C" int gwa_locate(const void* rows, int64_t Q, const void* blocks, int nb_rows,
                          const void* C, int primary, int n, const void* mark_blocks, int mb,
                          const void* mark_cp, const void* ssa_values, int n_ssa,
                          int sample_rate, void* out, void* stream) {
  // a row of [0, n] must find its fused row: n / 128 < nb_rows
  if (Q < 0 || (n >> 7) >= nb_rows || mb < 1 || n_ssa < 1 || sample_rate < 0 || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (Q == 0) return 0;
  const LocateArgs a{static_cast<const int*>(rows), static_cast<int*>(out), Q, n, sample_rate};
  const OneMarks m{static_cast<const int*>(mark_blocks), static_cast<const int*>(mark_cp),
                   static_cast<const int*>(ssa_values), mb, n_ssa};
  locate_kernel<<<grid(Q), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<const int*>(blocks), static_cast<const int*>(C), primary, m);
  return static_cast<int>(cudaGetLastError());
}

// rows and out (Q,); the S shards' bwt (S, R, 8) and occ_cp (S, R, 4)
// 16-byte aligned, pk_start / pk_end (S,), mark_blocks (S, mbs, 4) 16-byte
// aligned, mark_cp (S, mbs + 1), row_start / row_end (S,), ssa_values
// (S, vmax), ssa_base (S,), C (5,): all int32.
extern "C" int gwa_locate_sharded(const void* rows, int64_t Q, int S, int R, const void* bwt,
                                  const void* occ_cp, const void* pk_start, const void* pk_end,
                                  int mbs, const void* mark_blocks, const void* mark_cp,
                                  const void* row_start, const void* row_end, int vmax,
                                  const void* ssa_values, const void* ssa_base, const void* C,
                                  int primary, int n, int sample_rate, void* out,
                                  void* stream) {
  if (Q < 0 || S < 1 || S > gwa::kMaxShards || R < 1 || mbs < 1 || vmax < 1 ||
      sample_rate < 0 || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (Q == 0) return 0;
  const LocateArgs a{static_cast<const int*>(rows), static_cast<int*>(out), Q, n, sample_rate};
  gwa::ShardedFM fm{};
  fm.bwt = static_cast<const int*>(bwt);
  fm.cp = static_cast<const int*>(occ_cp);
  fm.S = S;
  fm.R = R;
  fm.primary = primary;
  const ShardMarks m{static_cast<const int*>(mark_blocks), static_cast<const int*>(mark_cp),
                     static_cast<const int*>(ssa_values), static_cast<const int*>(row_start),
                     static_cast<const int*>(row_end), static_cast<const int*>(ssa_base),
                     mbs, vmax};
  locate_sharded_kernel<<<grid(Q), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, fm, static_cast<const int*>(C), static_cast<const int*>(pk_start),
      static_cast<const int*>(pk_end), m);
  return static_cast<int>(cudaGetLastError());
}
