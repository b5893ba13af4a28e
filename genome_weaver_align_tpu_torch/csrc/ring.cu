// All-reduce over interval shards on Hopper (sm_90a): the plain sum and the
// fused occ-rank + shard sum, each one grid-stride pass.
//
// Replaces the two Pallas TPU kernels of genome_weaver_align_tpu/parallel/ring.py:
//   _ring_kernel             -> allreduce_kernel<T, S>  (int32, float32; S = 1..16)
//   _fused_rank_ring_kernel  -> fused_words_kernel      (the JAX contract: gathered rows)
//                               fused_occ_kernel        (rows read from the sharded tables)
// and computes exactly the plain versions in
// genome_weaver_align_tpu_torch/parallel/ring.py (ring_psum_plain,
// fused_rank_ring_plain) and parallel/sharded_index.py (fused_occ_plain):
// every shard d ends with
//   x_d + x_{d-1} + x_{d-2} + ... + x_{d-S+1}
// added in that order, so the float32 sum is bit-equal to the plain loop.
// Every shard's buffers come in as their own base pointers.
//
// No ring.  The TPU ran a ring because ICI moves data by remote DMA between
// neighbours.  On one card all S shards lie in the same device memory and a
// ring's S-1 dependent hops are pure latency (round trips across SMs), so
// each kernel is one pass that reads every shard's input once and writes
// every shard's output.  Stream order makes every input complete at launch:
// nothing to wait on, no scratch, nothing for the host to read back.  Across
// NVLink-joined cards the choice is between NCCL's all_reduce and this
// one-pass shape over peer pointers behind one ready barrier.
//
// allreduce_kernel: each thread reads the same 16-byte vector of every
// shard's input; int32 adds wrap, so one sum serves every shard; float32
// adds each shard's sum in its own ring order.  Bound: bytes (S inputs read
// and S outputs written once); the adds are S-1 an element (int32) or
// S(S-1) (float32).
//
// fused_words_kernel: one thread per (payload, query) walks the S shards.
// It reads own first and loads the 32-byte word row (two 16-byte loads),
// code, roff and base only where own != 0: own * x is 0 in wrapping int32
// when own is 0, so the skip is bit-exact.  It adds in int32 and writes the
// sum to every shard's output row.  roff can exceed 128 for a query the
// shard does not own (sharded_index.py _block_split); the mask clip
// saturates at the full block.  Bound: bytes (every shard's own read and
// sum written once, and the owner's 32-byte row, code, roff and base read
// once); the least work is 7 integer instructions a word (xor, shift,
// and-not with the mask, popcount, add, and the mask's clip and shift), 2
// for own * (base + count), and S-1 adds a query.
//
// fused_occ_kernel: the same sum, but each thread does the shards' block
// split itself (sharded_index.py _block_split: the sentinel adjustment, the
// owner test against each shard's [pk_start, pk_end), the clamped local
// block and roff), with the S bounds in shared memory, and loads only the
// owner's 32-byte row of bwt_blocks and one int32 of occ_cp; a non-owner
// adds 0 without a load.  No (S, M, Q, 8) word tensor is ever built.  At
// chr20 scale the shards' bwt_blocks are ~16 MB and stay in the 50 MB L2; a
// random row is one 32-byte sector.  Bound: bytes, k, code, row,
// checkpoint and out, 48 B a query.
//
// Entries: gwa_allreduce, gwa_fused_words and gwa_fused_occ, plain C
// functions bound with ctypes.  The launches run on the caller's stream, do
// not synchronise, allocate nothing, and return the launch's CUDA error
// code.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kMaxShards = 16;
constexpr int kThreads = 256;
constexpr int kBlockBases = 128;  // bases of one 8-word BWT row

__device__ __forceinline__ int add(int a, int b) {  // wraps like torch's int32 add
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}
__device__ __forceinline__ float add(float a, float b) { return a + b; }

template <typename T>
__device__ __forceinline__ T from_bits(unsigned u);
template <>
__device__ __forceinline__ int from_bits<int>(unsigned u) { return static_cast<int>(u); }
template <>
__device__ __forceinline__ float from_bits<float>(unsigned u) { return __uint_as_float(u); }
__device__ __forceinline__ unsigned to_bits(int v) { return static_cast<unsigned>(v); }
__device__ __forceinline__ unsigned to_bits(float v) { return __float_as_uint(v); }

// Blocks of a grid-stride pass over `items` work items: enough to cover
// them, at most 8 a multiprocessor.
int grid_blocks(int64_t items, unsigned* blocks) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t want = (items + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sms) * 8;
  *blocks = static_cast<unsigned>(want < cap ? want : cap);
  return 0;
}

// ---- one-pass all-reduce

struct ShardIO {
  const void* in[kMaxShards];
  void* out[kMaxShards];
};

// out[d] = x_d + x_{d-1} + ... + x_{d-S+1} for the E elements of x[0..S-1].
template <typename T, int S, int E>
__device__ __forceinline__ void ring_sums(const T (&x)[S][E], T (&out)[S][E]) {
  if constexpr (std::is_same<T, int>::value) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      int acc = x[0][e];
#pragma unroll
      for (int d = 1; d < S; ++d) acc = add(acc, x[d][e]);
#pragma unroll
      for (int d = 0; d < S; ++d) out[d][e] = acc;
    }
  } else {
#pragma unroll
    for (int d = 0; d < S; ++d) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        T acc = x[d][e];
#pragma unroll
        for (int t = 1; t < S; ++t) acc = add(acc, x[(d - t + S) % S][e]);
        out[d][e] = acc;
      }
    }
  }
}

// Elements [0, 4 n_vec) as 16-byte vectors (every pointer 16-byte aligned),
// then [4 n_vec, n) one at a time.
template <typename T, int S>
__global__ void __launch_bounds__(kThreads) allreduce_kernel(const ShardIO p, int64_t n,
                                                             int64_t n_vec) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  for (int64_t v = first; v < n_vec; v += stride) {
    T x[S][4], out[S][4];
#pragma unroll
    for (int d = 0; d < S; ++d) {
      const uint4 u = __ldg(static_cast<const uint4*>(p.in[d]) + v);
      x[d][0] = from_bits<T>(u.x);
      x[d][1] = from_bits<T>(u.y);
      x[d][2] = from_bits<T>(u.z);
      x[d][3] = from_bits<T>(u.w);
    }
    ring_sums<T, S, 4>(x, out);
#pragma unroll
    for (int d = 0; d < S; ++d) {
      uint4 u;
      u.x = to_bits(out[d][0]);
      u.y = to_bits(out[d][1]);
      u.z = to_bits(out[d][2]);
      u.w = to_bits(out[d][3]);
      static_cast<uint4*>(p.out[d])[v] = u;
    }
  }
  for (int64_t i = 4 * n_vec + first; i < n; i += stride) {
    T x[S][1], out[S][1];
#pragma unroll
    for (int d = 0; d < S; ++d) x[d][0] = static_cast<const T*>(p.in[d])[i];
    ring_sums<T, S, 1>(x, out);
#pragma unroll
    for (int d = 0; d < S; ++d) static_cast<T*>(p.out[d])[i] = out[d][0];
  }
}

template <typename T, int S>
int allreduce(const ShardIO& p, int64_t n, cudaStream_t stream) {
  bool aligned = true;
  for (int d = 0; d < S; ++d)
    aligned &= (reinterpret_cast<uintptr_t>(p.in[d]) | reinterpret_cast<uintptr_t>(p.out[d])) %
                   16 == 0;
  const int64_t n_vec = aligned ? n / 4 : 0;
  unsigned blocks = 0;
  const int rc = grid_blocks(n_vec > n - 4 * n_vec ? n_vec : n - 4 * n_vec, &blocks);
  if (rc != 0) return rc;
  allreduce_kernel<T, S><<<blocks, kThreads, 0, stream>>>(p, n, n_vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int allreduce_s(int S, const ShardIO& p, int64_t n, cudaStream_t s) {
  switch (S) {
    case 1: return allreduce<T, 1>(p, n, s);
    case 2: return allreduce<T, 2>(p, n, s);
    case 3: return allreduce<T, 3>(p, n, s);
    case 4: return allreduce<T, 4>(p, n, s);
    case 5: return allreduce<T, 5>(p, n, s);
    case 6: return allreduce<T, 6>(p, n, s);
    case 7: return allreduce<T, 7>(p, n, s);
    case 8: return allreduce<T, 8>(p, n, s);
    case 9: return allreduce<T, 9>(p, n, s);
    case 10: return allreduce<T, 10>(p, n, s);
    case 11: return allreduce<T, 11>(p, n, s);
    case 12: return allreduce<T, 12>(p, n, s);
    case 13: return allreduce<T, 13>(p, n, s);
    case 14: return allreduce<T, 14>(p, n, s);
    case 15: return allreduce<T, 15>(p, n, s);
    case 16: return allreduce<T, 16>(p, n, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---- fused occ rank + shard sum

// #bases equal to code in the first roff bases of one 128-base block: the 8
// words are one 16-byte-aligned 32-byte row; the code * 0x55555555 spread
// that ring.py:345 hoisted out for Mosaic is computed here.  roff above 128
// saturates at the full block.
__device__ __forceinline__ unsigned rank_partial(const int* row, int code, int roff) {
  const uint4* w4 = reinterpret_cast<const uint4*>(row);
  const uint4 lo = __ldg(w4), hi = __ldg(w4 + 1);
  const unsigned w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  const unsigned pattern = static_cast<unsigned>(code) * 0x55555555u;
  int cnt = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int allowed = min(max(roff - 16 * j, 0), 16);
    const unsigned mask = allowed >= 16 ? 0xFFFFFFFFu : (1u << (2 * allowed)) - 1u;
    const unsigned x = w[j] ^ pattern;
    cnt += __popc(~(x | (x >> 1)) & 0x55555555u & mask);
  }
  return static_cast<unsigned>(cnt);
}

// The words entry: per shard, (n, 8) word rows and (n,) codes, roff, base,
// own; out (n,) per shard.
struct WordsIO {
  const int* words[kMaxShards];
  const int* codes[kMaxShards];
  const int* roff[kMaxShards];
  const int* base[kMaxShards];
  const int* own[kMaxShards];
  int* out[kMaxShards];
};

__global__ void __launch_bounds__(kThreads) fused_words_kernel(const WordsIO p, int S, int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += stride) {
    unsigned acc = 0;
    for (int d = 0; d < S; ++d) {
      const int own = __ldg(p.own[d] + i);
      if (own != 0) {
        const unsigned cnt = rank_partial(p.words[d] + i * 8, __ldg(p.codes[d] + i),
                                          __ldg(p.roff[d] + i));
        acc += static_cast<unsigned>(own) * (static_cast<unsigned>(__ldg(p.base[d] + i)) + cnt);
      }
    }
    for (int d = 0; d < S; ++d) p.out[d][i] = static_cast<int>(acc);
  }
}

// The table entry: the stacked shard tables and n (code, coordinate)
// queries -> n merged occ values.
struct TableIO {
  const int* bwt;       // (S, R, 8) uint32 words as int32
  const int* occ_cp;    // (S, R, 4) global checkpoint values
  const int* pk_start;  // (S,)
  const int* pk_end;    // (S,)
  const int* codes;     // (n,) 0..3
  const int* k;         // (n,) sentinel-inclusive coordinates
  int* out;             // (n,)
  int64_t n;
  int S, R, primary;
};

__global__ void __launch_bounds__(kThreads) fused_occ_kernel(const TableIO a) {
  __shared__ int s_ps[kMaxShards], s_pe[kMaxShards];
  if (threadIdx.x < a.S) {
    s_ps[threadIdx.x] = a.pk_start[threadIdx.x];
    s_pe[threadIdx.x] = a.pk_end[threadIdx.x];
  }
  __syncthreads();
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < a.n;
       i += stride) {
    const int k = __ldg(a.k + i);
    const int k_adj = k - (k > a.primary ? 1 : 0);
    unsigned acc = 0;
    for (int d = 0; d < a.S; ++d) {
      const int ps = s_ps[d];
      if (k_adj >= ps && k_adj < s_pe[d]) {
        const int b = min((k_adj - ps) / kBlockBases, a.R - 1);
        const int roff = k_adj - ps - b * kBlockBases;
        const int code = __ldg(a.codes + i);
        const int64_t row = static_cast<int64_t>(d) * a.R + b;
        acc += static_cast<unsigned>(__ldg(a.occ_cp + row * 4 + (code & 3))) +
               rank_partial(a.bwt + row * 8, code, roff);
      }
    }
    a.out[i] = static_cast<int>(acc);
  }
}

}  // namespace

// dtype 0: int32, 1: float32.  in_ptrs, out_ptrs: S device pointers each, n
// elements a shard.
extern "C" int gwa_allreduce(int dtype, int S, int64_t n, const uint64_t* in_ptrs,
                             const uint64_t* out_ptrs, void* stream) {
  if (S < 1 || S > kMaxShards || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  ShardIO p{};
  for (int d = 0; d < S; ++d) {
    p.in[d] = reinterpret_cast<const void*>(in_ptrs[d]);
    p.out[d] = reinterpret_cast<void*>(out_ptrs[d]);
  }
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return allreduce_s<int>(S, p, n, s);
  if (dtype == 1) return allreduce_s<float>(S, p, n, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// ptrs: 6 x S device pointers, shard-major: words (16-byte aligned), codes,
// roff, base, own and out of shard d at ptrs[6 d .. 6 d + 5]; n queries a
// shard.
extern "C" int gwa_fused_words(int S, int64_t n, const uint64_t* ptrs, void* stream) {
  if (S < 1 || S > kMaxShards || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  WordsIO p{};
  for (int d = 0; d < S; ++d) {
    const uint64_t* q = ptrs + 6 * d;
    p.words[d] = reinterpret_cast<const int*>(q[0]);
    p.codes[d] = reinterpret_cast<const int*>(q[1]);
    p.roff[d] = reinterpret_cast<const int*>(q[2]);
    p.base[d] = reinterpret_cast<const int*>(q[3]);
    p.own[d] = reinterpret_cast<const int*>(q[4]);
    p.out[d] = reinterpret_cast<int*>(q[5]);
  }
  unsigned blocks = 0;
  const int rc = grid_blocks(n, &blocks);
  if (rc != 0) return rc;
  fused_words_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p, S, n);
  return static_cast<int>(cudaGetLastError());
}

// bwt (S, R, 8) 16-byte aligned, occ_cp (S, R, 4), pk_start and pk_end
// (S,), codes, k and out (n,), all int32.
extern "C" int gwa_fused_occ(int S, int R, int primary, int64_t n, const void* bwt,
                             const void* occ_cp, const void* pk_start, const void* pk_end,
                             const void* codes, const void* k, void* out, void* stream) {
  if (S < 1 || S > kMaxShards || R < 1 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  TableIO a{};
  a.bwt = static_cast<const int*>(bwt);
  a.occ_cp = static_cast<const int*>(occ_cp);
  a.pk_start = static_cast<const int*>(pk_start);
  a.pk_end = static_cast<const int*>(pk_end);
  a.codes = static_cast<const int*>(codes);
  a.k = static_cast<const int*>(k);
  a.out = static_cast<int*>(out);
  a.n = n;
  a.S = S;
  a.R = R;
  a.primary = primary;
  unsigned blocks = 0;
  const int rc = grid_blocks(n, &blocks);
  if (rc != 0) return rc;
  fused_occ_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
