// All-reduce over interval shards on Hopper (sm_90a): the plain sum and the
// fused occ-rank + ring sum.
//
// Replaces the two Pallas TPU kernels of genome_weaver_align_tpu/parallel/ring.py:
//   _ring_kernel             -> allreduce_kernel<T, S>  (int32, float32; S = 1..16)
//   _fused_rank_ring_kernel  -> ring_kernel<M>          (M = 1..8)
// and computes exactly the plain versions in
// genome_weaver_align_tpu_torch/parallel/ring.py (ring_psum_plain,
// fused_rank_ring_plain): every shard d ends with
//   x_d + x_{d-1} + x_{d-2} + ... + x_{d-S+1}
// added in that order, so the float32 sum is bit-equal to the plain loop.
// Every shard's buffers come in as their own base pointers.
//
// allreduce_kernel: one pass, no ring.  The TPU ran a ring because ICI moves
// data by remote DMA between neighbours.  On one card all S shards lie in
// the same device memory and the ring's S-1 dependent hops were pure
// latency (flag round trips across SMs), so a plain grid-stride kernel
// reads the same 16-byte vector of every shard's input once and writes
// every shard's output: int32 adds wrap, so one sum serves every shard;
// float32 adds each shard's sum in its own ring order.  Stream order makes
// every input complete at launch: no flags, no error word, nothing for the
// host to read back.  Bound: bytes (S inputs read and S outputs written
// once); the adds are S-1 an element (int32) or S(S-1) (float32).  Across
// NVLink-joined cards the choice is between NCCL's all_reduce, this
// one-shot pass over peer pointers behind one ready barrier, and the hop
// protocol below.
//
// ring_kernel (fused): the ring's multi-hop protocol.  The S shards are
// groups of G persistent thread blocks each; block b of every group owns
// the same tiles of the payload (tiles b, b+G, ...), and talks only to
// block b of the groups d-1 and d+1.  Per tile (ring.py:14-19, 87-121), for
// hop s in 0..S-2:
//   1. wait for a capacity grant from shard d+1 (cumulative count);
//   2. store the value in flight (this shard's partial at s = 0, else the
//      value received at hop s-1, held in registers) into shard d+1's slot
//      (s+1)%2, then publish shard d+1's recv flag;
//   3. wait for this shard's own recv flag from shard d-1, load the slot it
//      filled, add it into the sum, and grant shard d-1 capacity for the
//      slot it will fill at its hop s+2.
// Both slots start free, so each shard grants min(2, S-1) at the start of a
// tile.  Ordering rule kept from ring.py:102-105: every shard signals its
// grant before it blocks on one.  The value in flight stays in registers,
// and a shard never writes its own slots.  The TPU's token /
// optimization_barrier sequencing becomes stream order: launches on one
// stream never overlap, so one launch's flags never meet another's.
//   * Co-residency: blocks spin on flags that other blocks set, so every
//     block must be resident at once.  The grid is sized from
//     cudaOccupancyMaxActiveBlocksPerMultiprocessor x the SM count, split
//     over the S groups, and launched with cudaLaunchCooperativeKernel,
//     which refuses a grid that cannot be co-resident instead of hanging.
//   * No hang: every spin is bounded by %globaltimer (kTimeoutNs, 1 s).  On
//     expiry the block sets the error word and returns; blocks spinning
//     elsewhere see the word and return too.  The host reads the word when
//     it asks (ring_cuda.raise_if_failed) and raises.  ``stall_shard`` (-1
//     in use) makes one shard's blocks return at once, so the card tests can
//     show that its neighbours time out and raise instead of hanging.
//   * Visibility across SMs: the writer's threads store with __stcg, then
//     __syncthreads(), then thread 0 issues __threadfence() and a release
//     store of the flag (cuda::atomic_ref, thread_scope_device).  The reader's
//     thread 0 spins on an acquire load, then __syncthreads(), then every
//     thread loads the slot with __ldcg (L1 is not coherent across SMs).
//   * Stale flags: flags persist from launch to launch.  Each value is
//     (epoch << 32) | count, with a per-launch epoch from the host that only
//     grows, so a flag of an earlier launch never satisfies a wait.
//   * Ownership: roff can exceed 128 for a query this shard does not own
//     (sharded_index.py:171-173); the mask clip saturates at the full block
//     and own = 0 zeroes the partial.
//   Bound: bytes (the 32-byte word row and four int32 of every shard and
//   query read once, the sum written once); the least work is 7 integer
//   instructions a word (xor, shift, and-not with the mask, popcount, add,
//   and the mask's clip and shift), 2 for own * (base + count), and S-1
//   adds a query.  The S-1 hops add flag round trips across SMs.
//
// Entries: gwa_allreduce, gwa_ring_plan (grid and scratch sizes) and
// gwa_ring_launch, plain C functions bound with ctypes.  The launches run
// on the caller's stream, do not synchronise, allocate nothing, and return
// the launch's CUDA error code.

#include <cuda/atomic>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kMaxShards = 16;
constexpr int kInputs = 5;
constexpr int kThreads = 256;
constexpr unsigned long long kTimeoutNs = 1000000000ull;

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
  const int64_t items = n_vec > n - 4 * n_vec ? n_vec : n - 4 * n_vec;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t want = (items + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sms) * 8;
  const unsigned blocks = static_cast<unsigned>(want < cap ? want : cap);
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

// ---- fused rank + ring

struct ShardPtrs {
  const void* in[kMaxShards][kInputs];  // words, codes, roff, base, own
  void* out[kMaxShards];
  void* slots[kMaxShards];               // per block: 2 slots x M x kThreads elements
  unsigned long long* flags[kMaxShards];  // [0, G): recv from d-1; [G, 2G): grants from d+1
};

using Flag = cuda::atomic_ref<unsigned long long, cuda::thread_scope_device>;
using ErrWord = cuda::atomic_ref<int, cuda::thread_scope_device>;

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// All threads call it; thread 0 spins.  False when this wait timed out or
// another block already failed: the caller returns.
__device__ bool wait_at_least(unsigned long long* flag, unsigned long long target, int* err,
                              int code) {
  __shared__ int s_ok;
  if (threadIdx.x == 0) {
    Flag f(*flag);
    ErrWord e(*err);
    int ok = 1;
    if (f.load(cuda::memory_order_acquire) < target) {
      const unsigned long long t0 = globaltimer();
      while (f.load(cuda::memory_order_acquire) < target) {
        if (e.load(cuda::memory_order_relaxed) != 0) {
          ok = 0;
          break;
        }
        if (globaltimer() - t0 > kTimeoutNs) {
          int zero = 0;
          e.compare_exchange_strong(zero, code, cuda::memory_order_relaxed);
          ok = 0;
          break;
        }
        __nanosleep(64);
      }
    }
    s_ok = ok;
  }
  __syncthreads();
  return s_ok != 0;
}

// Thread 0 only, after a __syncthreads() that follows the block's stores.
__device__ __forceinline__ void publish(unsigned long long* flag, unsigned long long v) {
  __threadfence();
  Flag(*flag).store(v, cuda::memory_order_release);
}

// own * (base + #bases equal to code in the first roff of the 128-base
// block): the 8 words are one 32-byte row; the code * 0x55555555 spread
// that ring.py:345 hoisted out for Mosaic is computed here
__device__ __forceinline__ int rank_partial(const ShardPtrs& p, int d, int64_t r) {
  const uint4* w4 = reinterpret_cast<const uint4*>(static_cast<const int*>(p.in[d][0]) + r * 8);
  const uint4 lo = __ldg(w4), hi = __ldg(w4 + 1);
  const unsigned w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  const unsigned pattern =
      static_cast<unsigned>(static_cast<const int*>(p.in[d][1])[r]) * 0x55555555u;
  const int roff = static_cast<const int*>(p.in[d][2])[r];
  const int base = static_cast<const int*>(p.in[d][3])[r];
  const int own = static_cast<const int*>(p.in[d][4])[r];
  int cnt = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int allowed = min(max(roff - 16 * j, 0), 16);  // saturates for roff > 128
    const unsigned mask = allowed >= 16 ? 0xFFFFFFFFu : (1u << (2 * allowed)) - 1u;
    const unsigned x = w[j] ^ pattern;
    cnt += __popc(~(x | (x >> 1)) & 0x55555555u & mask);
  }
  return static_cast<int>(static_cast<unsigned>(own) *
                          (static_cast<unsigned>(base) + static_cast<unsigned>(cnt)));
}

// M payloads of Q elements per shard; each thread holds one element of every
// payload in a tile, so one hop moves all M payloads of the tile.
template <int M>
__global__ void __launch_bounds__(kThreads)
    ring_kernel(ShardPtrs p, int S, int G, int64_t Q, unsigned long long epoch, int* err,
                int stall_shard) {
  constexpr int64_t kTileQ = kThreads;
  const int d = blockIdx.x / G;
  const int b = blockIdx.x % G;
  if (d == stall_shard) return;
  const int right = (d + 1) % S;
  const int left = (d + S - 1) % S;
  const int tid = threadIdx.x;
  const size_t slot_stride = static_cast<size_t>(M) * kThreads;
  int* out = static_cast<int*>(p.out[d]);
  const int* my_slots = static_cast<const int*>(p.slots[d]) + b * 2 * slot_stride;
  int* right_slots = static_cast<int*>(p.slots[right]) + b * 2 * slot_stride;
  unsigned long long* my_recv = p.flags[d] + b;
  unsigned long long* my_cap = p.flags[d] + G + b;
  unsigned long long* right_recv = p.flags[right] + b;
  unsigned long long* left_cap = p.flags[left] + G + b;
  const unsigned long long tag = epoch << 32;
  const int hops = S - 1;
  unsigned long long n_cap = 0, n_sent = 0, n_recv = 0, n_granted = 0;
  const int64_t n_tiles = (Q + kTileQ - 1) / kTileQ;

  for (int64_t tile = b; tile < n_tiles; tile += G) {
    int cur[M], acc[M];
    int64_t idx[M];
#pragma unroll
    for (int i = 0; i < M; ++i) {
      const int64_t q = tile * kTileQ + tid;
      idx[i] = q < Q ? static_cast<int64_t>(i) * Q + q : -1;
      cur[i] = idx[i] >= 0 ? rank_partial(p, d, idx[i]) : 0;
      acc[i] = cur[i];
    }
    if (hops > 0) {
      n_granted += hops < 2 ? hops : 2;  // both slots free: grant before any wait
      if (tid == 0) publish(left_cap, tag | n_granted);
      for (int s = 0; s < hops; ++s) {
        const size_t slot = static_cast<size_t>((s + 1) & 1) * slot_stride;
        if (!wait_at_least(my_cap, tag | (n_cap + 1), err, 1)) return;
        ++n_cap;
#pragma unroll
        for (int i = 0; i < M; ++i) __stcg(right_slots + slot + i * kThreads + tid, cur[i]);
        __syncthreads();
        ++n_sent;
        if (tid == 0) publish(right_recv, tag | n_sent);
        if (!wait_at_least(my_recv, tag | (n_recv + 1), err, 2)) return;
        ++n_recv;
#pragma unroll
        for (int i = 0; i < M; ++i) {
          cur[i] = __ldcg(my_slots + slot + i * kThreads + tid);
          acc[i] = add(acc[i], cur[i]);
        }
        __syncthreads();  // the slot is read: shard d-1 may refill it at its hop s+2
        if (s + 2 < hops) {
          ++n_granted;
          if (tid == 0) publish(left_cap, tag | n_granted);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < M; ++i)
      if (idx[i] >= 0) out[idx[i]] = acc[i];
  }
}

template <int M>
int plan(int S, int64_t Q, int* G, int64_t* slot_elems) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ring_kernel<M>, kThreads, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t per_shard = static_cast<int64_t>(per_sm) * sms / S;
  if (per_shard < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const int64_t n_tiles = (Q + kThreads - 1) / kThreads;
  *G = static_cast<int>(n_tiles < per_shard ? n_tiles : per_shard);
  *slot_elems = static_cast<int64_t>(*G) * 2 * M * kThreads;
  return 0;
}

template <int M>
int launch(const ShardPtrs& p, int S, int G, int64_t Q, unsigned long long epoch, int* err,
           int stall_shard, cudaStream_t stream) {
  ShardPtrs pp = p;
  void* args[] = {&pp, &S, &G, &Q, &epoch, &err, &stall_shard};
  cudaError_t e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(ring_kernel<M>),
                                              dim3(static_cast<unsigned>(S * G)),
                                              dim3(kThreads), args, 0, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// Calls F<M>::run(args...) for M = 1..8.
template <template <int> class F, typename... A>
int dispatch(int M, A... a) {
  switch (M) {
    case 1: return F<1>::run(a...);
    case 2: return F<2>::run(a...);
    case 3: return F<3>::run(a...);
    case 4: return F<4>::run(a...);
    case 5: return F<5>::run(a...);
    case 6: return F<6>::run(a...);
    case 7: return F<7>::run(a...);
    case 8: return F<8>::run(a...);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int M>
struct Plan {
  static int run(int S, int64_t Q, int* G, int64_t* slot_elems) {
    return plan<M>(S, Q, G, slot_elems);
  }
};

template <int M>
struct Launch {
  static int run(const ShardPtrs* p, int S, int G, int64_t Q, unsigned long long epoch, int* err,
                 int stall_shard, cudaStream_t stream) {
    return launch<M>(*p, S, G, Q, epoch, err, stall_shard, stream);
  }
};

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

extern "C" int gwa_ring_plan(int M, int S, int64_t Q, int* G, int64_t* slot_elems) {
  if (S < 1 || S > kMaxShards || Q < 1) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<Plan>(M, S, Q, G, slot_elems);
}

// in_ptrs: S x 5 device pointers; out_ptrs, slot_ptrs, flag_ptrs: S each.
// G from gwa_ring_plan; epoch > every earlier epoch used with these flags,
// below 2^32; stall_shard -1 (or a shard, for the no-hang test).
extern "C" int gwa_ring_launch(int M, int S, int G, int64_t Q, const uint64_t* in_ptrs,
                               const uint64_t* out_ptrs, const uint64_t* slot_ptrs,
                               const uint64_t* flag_ptrs, uint64_t epoch, void* err,
                               int stall_shard, void* stream) {
  if (S < 1 || S > kMaxShards || G < 1 || Q < 1) return static_cast<int>(cudaErrorInvalidValue);
  ShardPtrs p{};
  for (int d = 0; d < S; ++d) {
    for (int i = 0; i < kInputs; ++i)
      p.in[d][i] = reinterpret_cast<const void*>(in_ptrs[d * kInputs + i]);
    p.out[d] = reinterpret_cast<void*>(out_ptrs[d]);
    p.slots[d] = reinterpret_cast<void*>(slot_ptrs[d]);
    p.flags[d] = reinterpret_cast<unsigned long long*>(flag_ptrs[d]);
  }
  return dispatch<Launch>(M, &p, S, G, Q, static_cast<unsigned long long>(epoch),
                          static_cast<int*>(err), stall_shard, static_cast<cudaStream_t>(stream));
}
