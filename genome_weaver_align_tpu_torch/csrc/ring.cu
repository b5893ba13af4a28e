// Ring all-reduce over interval shards on Hopper (sm_90a): the ring sum
// and the fused occ-rank + ring sum.
//
// Replaces the two Pallas TPU kernels of genome_weaver_align_tpu/parallel/ring.py:
//   _ring_kernel             -> ring_kernel<T, 1, 4, false>  (int32, float32)
//   _fused_rank_ring_kernel  -> ring_kernel<int, M, 1, true>  (M = 1..8)
// and computes exactly the plain versions in
// genome_weaver_align_tpu_torch/parallel/ring.py (ring_psum_plain,
// fused_rank_ring_plain): every shard d ends with
//   x_d + x_{d-1} + x_{d-2} + ... + x_{d-S+1}
// added in that order, so the float32 sum is bit-equal to the plain loop.
//
// Shards.  The S shards are groups of G persistent thread blocks each; block
// b of every group owns the same tiles of the payload (tiles b, b+G, ...),
// and talks only to block b of the groups d-1 and d+1.  Every shard's
// buffers (inputs, output, the two receive slots, the flags) come in as
// their own base pointers, so shards on other cards would change only the
// pointers and the flag scope.  All S groups run on one device here.
//
// Protocol per tile (ring.py:14-19, 87-121), for hop s in 0..S-2:
//   1. wait for a capacity grant from shard d+1 (cumulative count);
//   2. store the value in flight (this shard's partial at s = 0, else the
//      value received at hop s-1, held in registers) into shard d+1's slot
//      (s+1)%2, then publish shard d+1's recv flag;
//   3. wait for this shard's own recv flag from shard d-1, load the slot it
//      filled, add it into the sum, and grant shard d-1 capacity for the
//      slot it will fill at its hop s+2.
// Both slots start free, so each shard grants min(2, S-1) at the start of a
// tile.  Ordering rule kept from ring.py:102-105: every shard signals its
// grant before it blocks on one.  The TPU kernel forwards from a VMEM slot
// because its RDMA reads memory; here the value in flight stays in
// registers, and a shard never writes its own slots.  The TPU's token /
// optimization_barrier sequencing becomes stream order: launches on one
// stream never overlap, so one launch's flags never meet another's.
//
// Trouble spots:
//   * Co-residency: blocks spin on flags that other blocks set, so every
//     block must be resident at once.  The grid is sized from
//     cudaOccupancyMaxActiveBlocksPerMultiprocessor x the SM count, split
//     over the S groups, and launched with cudaLaunchCooperativeKernel,
//     which refuses a grid that cannot be co-resident instead of hanging.
//   * No hang: every spin is bounded by %globaltimer (kTimeoutNs, 1 s).  On
//     expiry the block sets the error word and returns; blocks spinning
//     elsewhere see the word and return too.  The wrapper reads the word
//     after the launch and raises.  ``stall_shard`` (-1 in use) makes one
//     shard's blocks return at once, so the card tests can show that its
//     neighbours time out and raise instead of hanging.
//   * Visibility across SMs: the writer's threads store with __stcg, then
//     __syncthreads(), then thread 0 issues __threadfence() and a release
//     store of the flag (cuda::atomic_ref, thread_scope_device).  The reader's
//     thread 0 spins on an acquire load, then __syncthreads(), then every
//     thread loads the slot with __ldcg (L1 is not coherent across SMs).
//   * Stale flags: flags persist from launch to launch.  Each value is
//     (epoch << 32) | count, with a per-launch epoch from the host that only
//     grows, so a flag of an earlier launch never satisfies a wait.
//   * Ownership (fused): roff can exceed 128 for a query this shard does
//     not own (sharded_index.py:171-173); the mask clip saturates at the
//     full block and own = 0 zeroes the partial.
//
// Bound: latency, not bytes.  The exact search's payload is 2 x 32,768
// int32 per shard: S-1 dependent hops, each a flag round trip across SMs
// (a few microseconds); the bytes (each input read once, each output
// written once) take about 1 us at 3.35 TB/s.
//
// Entries: gwa_ring_plan (grid and scratch sizes) and gwa_ring_launch, plain
// C functions bound with ctypes.  The launch runs on the caller's stream,
// does not synchronise, allocates nothing, and returns the launch's CUDA
// error code.

#include <cuda/atomic>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxShards = 16;
constexpr int kInputs = 5;
constexpr int kThreads = 256;
constexpr unsigned long long kTimeoutNs = 1000000000ull;

struct ShardPtrs {
  const void* in[kMaxShards][kInputs];  // ring: in[d][0] = x_d; fused: words, codes, roff, base, own
  void* out[kMaxShards];
  void* slots[kMaxShards];               // per block: 2 slots x E x kThreads elements
  unsigned long long* flags[kMaxShards];  // [0, G): recv from d-1; [G, 2G): grants from d+1
};

using Flag = cuda::atomic_ref<unsigned long long, cuda::thread_scope_device>;
using ErrWord = cuda::atomic_ref<int, cuda::thread_scope_device>;

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ int add(int a, int b) {  // wraps like torch's int32 add
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}
__device__ __forceinline__ float add(float a, float b) { return a + b; }

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

template <typename T, bool kFused>
__device__ __forceinline__ T partial_of(const ShardPtrs& p, int d, int64_t r) {
  if constexpr (!kFused) {
    return static_cast<const T*>(p.in[d][0])[r];
  } else {
    // own * (base + #bases equal to code in the first roff of the 128-base
    // block): the 8 words are one 32-byte row; the code * 0x55555555 spread
    // that ring.py:345 hoisted out for Mosaic is computed here
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
}

// M payloads of Q elements per shard; each thread holds EPT elements of
// every payload in a tile, so one hop moves all M payloads of the tile.
template <typename T, int M, int EPT, bool kFused>
__global__ void __launch_bounds__(kThreads)
    ring_kernel(ShardPtrs p, int S, int G, int64_t Q, unsigned long long epoch, int* err,
                int stall_shard) {
  constexpr int E = M * EPT;
  constexpr int64_t kTileQ = static_cast<int64_t>(kThreads) * EPT;
  const int d = blockIdx.x / G;
  const int b = blockIdx.x % G;
  if (d == stall_shard) return;
  const int right = (d + 1) % S;
  const int left = (d + S - 1) % S;
  const int tid = threadIdx.x;
  const size_t slot_stride = static_cast<size_t>(E) * kThreads;
  T* out = static_cast<T*>(p.out[d]);
  const T* my_slots = static_cast<const T*>(p.slots[d]) + b * 2 * slot_stride;
  T* right_slots = static_cast<T*>(p.slots[right]) + b * 2 * slot_stride;
  unsigned long long* my_recv = p.flags[d] + b;
  unsigned long long* my_cap = p.flags[d] + G + b;
  unsigned long long* right_recv = p.flags[right] + b;
  unsigned long long* left_cap = p.flags[left] + G + b;
  const unsigned long long tag = epoch << 32;
  const int hops = S - 1;
  unsigned long long n_cap = 0, n_sent = 0, n_recv = 0, n_granted = 0;
  const int64_t n_tiles = (Q + kTileQ - 1) / kTileQ;

  for (int64_t tile = b; tile < n_tiles; tile += G) {
    T cur[E], acc[E];
    int64_t idx[E];
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const int64_t q = tile * kTileQ + (i % EPT) * kThreads + tid;
      idx[i] = q < Q ? static_cast<int64_t>(i / EPT) * Q + q : -1;
      cur[i] = idx[i] >= 0 ? partial_of<T, kFused>(p, d, idx[i]) : T(0);
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
        for (int i = 0; i < E; ++i) __stcg(right_slots + slot + i * kThreads + tid, cur[i]);
        __syncthreads();
        ++n_sent;
        if (tid == 0) publish(right_recv, tag | n_sent);
        if (!wait_at_least(my_recv, tag | (n_recv + 1), err, 2)) return;
        ++n_recv;
#pragma unroll
        for (int i = 0; i < E; ++i) {
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
    for (int i = 0; i < E; ++i)
      if (idx[i] >= 0) out[idx[i]] = acc[i];
  }
}

template <typename T, int M, int EPT, bool kFused>
int plan(int S, int64_t Q, int* G, int64_t* slot_elems) {
  auto kernel = ring_kernel<T, M, EPT, kFused>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t per_shard = static_cast<int64_t>(per_sm) * sms / S;
  if (per_shard < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const int64_t tile_q = static_cast<int64_t>(kThreads) * EPT;
  const int64_t n_tiles = (Q + tile_q - 1) / tile_q;
  *G = static_cast<int>(n_tiles < per_shard ? n_tiles : per_shard);
  *slot_elems = static_cast<int64_t>(*G) * 2 * M * EPT * kThreads;
  return 0;
}

template <typename T, int M, int EPT, bool kFused>
int launch(const ShardPtrs& p, int S, int G, int64_t Q, unsigned long long epoch, int* err,
           int stall_shard, cudaStream_t stream) {
  auto kernel = ring_kernel<T, M, EPT, kFused>;
  ShardPtrs pp = p;
  void* args[] = {&pp, &S, &G, &Q, &epoch, &err, &stall_shard};
  cudaError_t e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                              dim3(static_cast<unsigned>(S * G)),
                                              dim3(kThreads), args, 0, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// kind 0: ring all-reduce, param = 0 (int32) or 1 (float32); kind 1: fused
// rank + ring, param = M (1..8).  Calls F<T, M, EPT, kFused>::run(args...).
template <template <typename, int, int, bool> class F, typename... A>
int dispatch(int kind, int param, A... a) {
  if (kind == 0) {
    if (param == 0) return F<int, 1, 4, false>::run(a...);
    if (param == 1) return F<float, 1, 4, false>::run(a...);
  } else if (kind == 1) {
    switch (param) {
      case 1: return F<int, 1, 1, true>::run(a...);
      case 2: return F<int, 2, 1, true>::run(a...);
      case 3: return F<int, 3, 1, true>::run(a...);
      case 4: return F<int, 4, 1, true>::run(a...);
      case 5: return F<int, 5, 1, true>::run(a...);
      case 6: return F<int, 6, 1, true>::run(a...);
      case 7: return F<int, 7, 1, true>::run(a...);
      case 8: return F<int, 8, 1, true>::run(a...);
      default: break;
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, int M, int EPT, bool kFused>
struct Plan {
  static int run(int S, int64_t Q, int* G, int64_t* slot_elems) {
    return plan<T, M, EPT, kFused>(S, Q, G, slot_elems);
  }
};

template <typename T, int M, int EPT, bool kFused>
struct Launch {
  static int run(const ShardPtrs* p, int S, int G, int64_t Q, unsigned long long epoch, int* err,
                 int stall_shard, cudaStream_t stream) {
    return launch<T, M, EPT, kFused>(*p, S, G, Q, epoch, err, stall_shard, stream);
  }
};

}  // namespace

extern "C" int gwa_ring_plan(int kind, int param, int S, int64_t Q, int* G, int64_t* slot_elems) {
  if (S < 1 || S > kMaxShards || Q < 1) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<Plan>(kind, param, S, Q, G, slot_elems);
}

// in_ptrs: S x 5 device pointers (unused entries 0); out_ptrs, slot_ptrs,
// flag_ptrs: S each.  G from gwa_ring_plan; epoch > every earlier epoch
// used with these flags, below 2^32; stall_shard -1 (or a shard, for the
// no-hang test).
extern "C" int gwa_ring_launch(int kind, int param, int S, int G, int64_t Q,
                               const uint64_t* in_ptrs, const uint64_t* out_ptrs,
                               const uint64_t* slot_ptrs, const uint64_t* flag_ptrs,
                               uint64_t epoch, void* err, int stall_shard, void* stream) {
  if (S < 1 || S > kMaxShards || G < 1 || Q < 1) return static_cast<int>(cudaErrorInvalidValue);
  ShardPtrs p{};
  for (int d = 0; d < S; ++d) {
    for (int i = 0; i < kInputs; ++i)
      p.in[d][i] = reinterpret_cast<const void*>(in_ptrs[d * kInputs + i]);
    p.out[d] = reinterpret_cast<void*>(out_ptrs[d]);
    p.slots[d] = reinterpret_cast<void*>(slot_ptrs[d]);
    p.flags[d] = reinterpret_cast<unsigned long long*>(flag_ptrs[d]);
  }
  return dispatch<Launch>(kind, param, &p, S, G, Q, static_cast<unsigned long long>(epoch),
                          static_cast<int*>(err), stall_shard, static_cast<cudaStream_t>(stream));
}
