// All-reduce over interval shards on Hopper (sm_90a): the plain sum and the
// fused occ-rank + shard sum, each one grid-stride pass.
//
// Replaces the two Pallas TPU kernels of genome_weaver_align_tpu/parallel/ring.py:
//   _ring_kernel             -> allreduce_kernel<T, S>   (int32, float32; S = 1..16),
//                               allreduce_split_kernel<Vec> (int32, past 16 shards),
//                               allreduce_ring_kernel<Vec> (float32, past 16 shards),
//                               push_wait_kernel<T, R, Vec> (across cards; R = 1..16,
//                                                        R = 0 past 16 ranks)
//   _fused_rank_ring_kernel  -> fused_words_kernel       (the JAX contract: gathered rows)
//                               fused_occ_kernel         (rows read from the sharded tables)
// and computes exactly the plain versions in
// genome_weaver_align_tpu_torch/parallel/ring.py (ring_psum_plain,
// fused_rank_ring_plain) and parallel/sharded_index.py (fused_occ_plain):
// every shard d ends with
//   x_d + x_{d-1} + x_{d-2} + ... + x_{d-S+1}
// added in that order, so the float32 sum is bit-equal to the plain loop.
// Every shard's buffers come in as their own base pointers: one stacked
// tensor's rows, or separate allocations, another process's mapped through
// CUDA IPC (parallel/peer.py: opened on this card with lazy peer access,
// so memory on another card is reached over NVLink).  Across processes
// each rank merges one partial, its held shards' sum (a row of its inbox,
// written there by the fused table entry), and the sum runs over the
// group's ranks in group order.  Two orders between the processes:
//   - ranks that share one card: the host orders the steps (a stream
//     synchronize and a barrier before the sum kernel reads every rank's
//     row, writing this rank's output only: a null output address is
//     skipped): kernels of two processes time-slice one card, so none may
//     wait on another's flag;
//   - ranks on separate cards: push_wait_kernel, the flag-wait entry
//     (gwa_allreduce_wait), the port of what _ring_kernel does with its
//     remote copies, barrier and capacity semaphores (ring.py:69-84,
//     :107-118).  It pushes as the TPU's remote DMA does and never pulls:
//     block b stores its chunk of this rank's partial into row me of every
//     peer's inbox over NVLink (posted 16-byte stores, no round trip), makes
//     them visible (the block's barrier, then a system fence) and publishes
//     the epoch into word [me][b] of every peer's flags (atomicMax over
//     NVLink).  It then waits with acquire loads of its own card's words
//     [q][b] and sums chunk b from its own inbox, this card's memory only.
//     One flag a block: chunk b depends only on block b of each peer, and
//     no block waits on a block of its own grid.  The grid is a function of
//     the payload alone (wait_blocks: the same on every rank, at most
//     kWaitBlocks blocks, one wave), so every block of every rank is
//     resident while it waits, whatever order the blocks start in.
//     Two inboxes taken in turn are enough, chunk by chunk: a rank pushes
//     chunk b into inbox i % 2 in merge i after its block b of merge i - 1
//     saw every peer's block b publish epoch i - 1; a peer publishes that
//     in its merge i - 1, which starts after its merge i - 2, the last
//     reader of inbox i % 2, has ended (stream order).
//     The wait is bounded, and a failure reaches every peer.  Past
//     `timeout_ns` of the card's global timer, or on finding a peer's word
//     poisoned, the block writes 1 to the error word and publishes the
//     poison (kPoison, above every epoch: the atomicMax keeps it) into
//     every word [me][*] of every peer; a launch that finds the error word
//     set pushes nothing, waits no more and publishes the poison, never an
//     epoch.  So a rank that has stopped waiting, and may push into an
//     inbox a slow peer still reads, has poisoned that peer's next wait at
//     the latest: the peer's error word is set before its search ends.  The
//     caller reads the error word once the merges are done and raises, so
//     a failed search never hangs and never returns its sums.
//
// No ring.  The TPU ran a ring because ICI moves data by remote DMA between
// neighbours.  On one card all S shards lie in the same device memory and a
// ring's S-1 dependent hops are pure latency (round trips across SMs), so
// each kernel is one pass that reads every shard's input once and writes
// every shard's output.  Stream order makes every input complete at launch:
// nothing to wait on, no scratch, nothing for the host to read back.  Across
// NVLink-joined cards each rank pushes its partial once to every peer (the
// bytes a ring would move) in one hop, not S-1 dependent ones.  Bound: the
// (P - 1) pushed rows over NVLink, or this card's P rows read and the sum
// written.  Its yardstick is NCCL's all_reduce on the same payload
// (chip_smoke.py [20]).
//
// allreduce_kernel (S <= 16): each thread reads the same 16-byte vector (or,
// where a shard's buffers are not 16-byte aligned or n is not a multiple
// of 4, the same element) of every shard's input, the loops over the
// shards unrolled over S; int32 adds wrap, so one sum serves every shard;
// float32 adds each shard's sum in its own ring order.
// allreduce_split_kernel (int32, past 16 shards): an item (a 16-byte
// vector of 4 elements where every pointer is 16-byte aligned and n a
// multiple of 4, else one element) is a group of up to a warp's lanes,
// each reading a slice of the shards with several independent loads in
// flight, combined by shuffles; int32 adds wrap, so one sum serves every
// shard.  The exact search's merge asks for one shard's sum (`only`): one
// output row written, not S.
// allreduce_ring_kernel (float32, past 16 shards): one thread an item adds
// each output in its own ring order, reading every input once for each
// output.  Bound:
// bytes (S inputs read and every output written once); the adds are S-1 an
// element (int32) or S(S-1) (float32).
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
// owner, the clamped local block and roff; the tables stacked, or one
// allocation a shard: fm_occ.cuh ShardTable) through fm_occ.cuh's one
// definition of the split, load_row(ShardedFM): the owner by division,
// confirmed against the S bounds in shared memory (owner_of), and only the
// owner's 32-byte row of bwt_blocks and 16 bytes of occ_cp read (one
// sector each); occ1 counts it.  A coordinate with no owner adds 0 without
// a load; where the ranges are disjoint (shard_fm_index's split; the
// binding finds it once for the bounds) the owner's value is the plain version's sum over
// the shards, and where they overlap the kernel sums every owner's partial
// as the plain version does.  No (S, M, Q, 8) word tensor is ever
// built.  At chr20 scale the shards' bwt_blocks are ~16 MB and stay in the
// 50 MB L2.  Bound: bytes, k, code, row, checkpoint and out, 48 B a query.
//
// Every entry takes any number of shards or ranks: their addresses are a
// stacked tensor's base and stride, or a device table the binding uploads
// once for a set of addresses (the binding decides which), and the bounds,
// with the binding's findings on them, are read from the bounds tensors
// (fm_occ.cuh): any count the card's memory holds.  The sum and the push
// keep a second kernel up to kMaxShards shards or ranks, their loops
// unrolled over a constant count and the addresses kernel parameters read
// at constant indices: at S = 4 the sum's one-row call takes 0.0023 ms
// against the int32 split's 0.0028, the push (4 ranks emulated on one
// card) 0.0060 against the loop over a runtime count's 0.0064, on an
// NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md section 6).
//
// Entries: gwa_allreduce, gwa_allreduce_wait (and its grid,
// gwa_allreduce_wait_blocks), gwa_fused_words and gwa_fused_occ, plain C
// functions bound with ctypes.  The launches run on the caller's stream,
// do not synchronise, allocate nothing, and return the launch's CUDA
// error code.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "fm_occ.cuh"

namespace {

constexpr int kMaxShards = 16;  // the unrolled sum's and push's shards or ranks
constexpr int kThreads = 256;

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
template <typename T>
__device__ __forceinline__ unsigned add_bits(unsigned a, unsigned b) {
  return to_bits(add(from_bits<T>(a), from_bits<T>(b)));
}
template <typename T>
__device__ __forceinline__ uint4 add_bits(uint4 a, uint4 b) {
  return make_uint4(add_bits<T>(a.x, b.x), add_bits<T>(a.y, b.y), add_bits<T>(a.z, b.z),
                    add_bits<T>(a.w, b.w));
}

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

// Up to kMaxShards shards: every shard's input and output a kernel
// parameter, the loops over the shards unrolled (S a template argument):
// at S = 4 a third faster than the loop over a runtime S below (PERF.md
// section 6).
struct ShardIO {
  const void* in[kMaxShards];
  void* out[kMaxShards];
};

// out[d] = x_d + x_{d-1} + ... + x_{d-S+1} for the E elements of x[0..S-1]
// (float32: only where want[d]).
template <typename T, int S, int E>
__device__ __forceinline__ void ring_sums(const T (&x)[S][E], T (&out)[S][E],
                                          const bool (&want)[S]) {
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
      if (!want[d]) continue;
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
// A null output pointer is not written: across processes on one card
// each writes its own shard's output only.
template <typename T, int S>
__global__ void __launch_bounds__(kThreads) allreduce_kernel(const ShardIO p, int64_t n,
                                                             int64_t n_vec) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  bool want[S];
#pragma unroll
  for (int d = 0; d < S; ++d) want[d] = p.out[d] != nullptr;
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
    ring_sums<T, S, 4>(x, out, want);
#pragma unroll
    for (int d = 0; d < S; ++d) {
      if (!want[d]) continue;
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
    ring_sums<T, S, 1>(x, out, want);
#pragma unroll
    for (int d = 0; d < S; ++d) {
      if (want[d]) static_cast<T*>(p.out[d])[i] = out[d][0];
    }
  }
}

template <typename T, int S>
int allreduce(const ShardIO& p, int64_t n, bool aligned, cudaStream_t stream) {
  const int64_t n_vec = aligned ? n / 4 : 0;
  unsigned blocks = 0;
  const int rc = grid_blocks(n_vec > n - 4 * n_vec ? n_vec : n - 4 * n_vec, &blocks);
  if (rc != 0) return rc;
  allreduce_kernel<T, S><<<blocks, kThreads, 0, stream>>>(p, n, n_vec);
  return static_cast<int>(cudaGetLastError());
}

// One item: a 16-byte vector of 4 elements, or one element.
template <bool Vec>
using Item = typename std::conditional<Vec, uint4, unsigned>::type;

__device__ __forceinline__ uint4 shfl_xor(uint4 v, int o, unsigned mask) {
  return make_uint4(__shfl_xor_sync(mask, v.x, o), __shfl_xor_sync(mask, v.y, o),
                    __shfl_xor_sync(mask, v.z, o), __shfl_xor_sync(mask, v.w, o));
}
__device__ __forceinline__ unsigned shfl_xor(unsigned v, int o, unsigned mask) {
  return __shfl_xor_sync(mask, v, o);
}
template <bool Vec>
__device__ __forceinline__ Item<Vec> zero_item();
template <>
__device__ __forceinline__ uint4 zero_item<true>() { return make_uint4(0u, 0u, 0u, 0u); }
template <>
__device__ __forceinline__ unsigned zero_item<false>() { return 0u; }

// Shard d's input at base + d * n elements (stacked) or at the d-th address
// of a device table; the outputs stacked (`only` < 0) or shard `only`'s
// alone.
struct SumIO {
  const char* in;
  char* out;
  int64_t stride;  // bytes a shard: n elements
  const uint64_t* in_tab;
  int S, only;
  __device__ __forceinline__ const void* in_at(int d) const {
    return in_tab ? reinterpret_cast<const void*>(__ldg(in_tab + d)) : in + d * stride;
  }
  __device__ __forceinline__ void* out_at(int d) const {
    if (only >= 0) return d == only ? out : nullptr;
    return out + d * stride;
  }
};

// int32: an item's S inputs split over a group of G = 2^g_log lanes of a
// warp.  Lane i of the group reads shards i, i + G, ..., kLoads of them at
// a time, every load independent of the others (kLoads loads in flight a
// lane), and the group adds its lanes' partials with __shfl_xor_sync.  Wrapping
// int32 adds are associative and commutative, so the sum is the ring's bit
// for bit in any order, and one sum serves every shard.  The group's lanes
// then write the outputs, lane i rows i, i + G, ... (lane 0 shard `only`'s
// alone).  A round of kLoads x G shards takes one load latency, so an item
// waits ceil(S / (kLoads G)) of them, and G lanes an item put S / kLoads
// loads in flight where one thread an item had kLoads.  Eight loads a
// lane: a warp's load of one shard then covers eight consecutive 16-byte
// vectors, a whole 128-byte line.
constexpr int kLoads = 8;

template <bool Vec>
__global__ void __launch_bounds__(kThreads) allreduce_split_kernel(const SumIO p, int64_t items,
                                                                   int g_log) {
  using It = Item<Vec>;
  const int G = 1 << g_log;
  const int i = static_cast<int>(threadIdx.x) & (G - 1);
  const int first = static_cast<int>(threadIdx.x) & 31 & ~(G - 1);  // the group's first lane
  const unsigned mask = G == 32 ? 0xFFFFFFFFu : ((1u << G) - 1u) << first;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * (kThreads >> g_log);
  for (int64_t v = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> g_log;
       v < items; v += stride) {
    It acc = zero_item<Vec>();
    for (int d0 = i; d0 < p.S; d0 += kLoads * G) {
      It x[kLoads];
#pragma unroll
      for (int l = 0; l < kLoads; ++l) {
        const int d = d0 + l * G;
        x[l] = d < p.S ? __ldg(static_cast<const It*>(p.in_at(d)) + v) : zero_item<Vec>();
      }
#pragma unroll
      for (int l = 0; l < kLoads; ++l) acc = add_bits<int>(acc, x[l]);
    }
    for (int o = 1; o < G; o <<= 1) acc = add_bits<int>(acc, shfl_xor(acc, o, mask));
    if (p.only >= 0) {
      if (i == 0) reinterpret_cast<It*>(p.out)[v] = acc;
    } else {
      for (int d = i; d < p.S; d += G) static_cast<It*>(p.out_at(d))[v] = acc;
    }
  }
}

// float32: one thread an item, every output in its own ring order,
// out[d] = x_d + x_{d-1} + ... + x_{d-S+1} (S^2 adds an item where every
// output is written, as the ring's order asks; S - 1 with `only`).
template <bool Vec>
__global__ void __launch_bounds__(kThreads) allreduce_ring_kernel(const SumIO p, int64_t items) {
  using It = Item<Vec>;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t v = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; v < items;
       v += stride) {
    const auto at = [&](int d) { return __ldg(static_cast<const It*>(p.in_at(d)) + v); };
    for (int d = 0; d < p.S; ++d) {
      void* o = p.out_at(d);
      if (o == nullptr) continue;
      It acc = at(d);
#pragma unroll 4
      for (int t = 1; t < p.S; ++t) acc = add_bits<float>(acc, at(d - t < 0 ? d - t + p.S : d - t));
      static_cast<It*>(o)[v] = acc;
    }
  }
}

// The int32 split past kMaxShards shards: G lanes an item, the power of
// two that covers S / kLoads shards, at most a warp.
inline int split_lanes_log(int S) {
  int g_log = 0;
  while (g_log < 5 && (kLoads << g_log) < S) ++g_log;
  return g_log;
}

template <bool Vec>
int launch_split(const SumIO& p, int64_t items, int g_log, cudaStream_t s) {
  unsigned blocks = 0;
  const int rc = grid_blocks(items << g_log, &blocks);
  if (rc != 0) return rc;
  allreduce_split_kernel<Vec><<<blocks, kThreads, 0, s>>>(p, items, g_log);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int allreduce_s(int S, const ShardIO& p, int64_t n, bool a, cudaStream_t s) {
  switch (S) {
    case 1: return allreduce<T, 1>(p, n, a, s);
    case 2: return allreduce<T, 2>(p, n, a, s);
    case 3: return allreduce<T, 3>(p, n, a, s);
    case 4: return allreduce<T, 4>(p, n, a, s);
    case 5: return allreduce<T, 5>(p, n, a, s);
    case 6: return allreduce<T, 6>(p, n, a, s);
    case 7: return allreduce<T, 7>(p, n, a, s);
    case 8: return allreduce<T, 8>(p, n, a, s);
    case 9: return allreduce<T, 9>(p, n, a, s);
    case 10: return allreduce<T, 10>(p, n, a, s);
    case 11: return allreduce<T, 11>(p, n, a, s);
    case 12: return allreduce<T, 12>(p, n, a, s);
    case 13: return allreduce<T, 13>(p, n, a, s);
    case 14: return allreduce<T, 14>(p, n, a, s);
    case 15: return allreduce<T, 15>(p, n, a, s);
    case 16: return allreduce<T, 16>(p, n, a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---- the flag-wait merge across cards (push)

// A rank's flag words: (ranks, kWaitBlocks) int32 on its card; word [q][b]
// is the last epoch that block b of rank q published to it, or kPoison
// once a wait of rank q has failed.  A grid has at most kWaitBlocks
// blocks of kThreads.
constexpr int kWaitBlocks = 128;
constexpr int kPoison = 0x7fffffff;

struct Push {
  void* inbox[kMaxShards];  // rank q's inbox (ranks, n), mapped on this card
  int* flags[kMaxShards];   // rank q's flag words, mapped on this card
  const uint64_t* table;    // past kMaxShards ranks: the inboxes' and flags' addresses in
                            // device memory (ranks each), in place of inbox and flags
  int ranks;
  const void* own_inbox;    // this rank's inbox: its partial is row me
  const int* own_flags;     // this rank's flag words
  void* out;                // (n,) this rank's sum
  int* error;               // this rank's error word
  int64_t n, items;         // items: n / 4 vectors, or n elements
  int me, epoch, blocks;
  long long timeout_ns;
};

// The grid of a merge of n elements: a function of n alone, the same on
// every rank, at most kWaitBlocks blocks (one wave on any card: no block
// may wait for a block that is not resident).
__host__ __device__ __forceinline__ int64_t wait_items(int64_t n) { return n % 4 ? n : n / 4; }
int wait_blocks(int64_t n) {
  const int64_t want = (wait_items(n) + kThreads - 1) / kThreads;
  return static_cast<int>(want < kWaitBlocks ? want : kWaitBlocks);
}

__device__ __forceinline__ int load_acquire_sys(const int* p) {
  int v;
  asm volatile("ld.acquire.sys.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ uint4 ld_cg(const uint4* p) { return __ldcg(p); }
__device__ __forceinline__ unsigned ld_cg(const unsigned* p) { return __ldcg(p); }


// Rank q's inbox and flag words: a parameter read at a constant index
// (R > 0: the loops over the ranks are unrolled), or past kMaxShards ranks
// (R = 0, the count p.ranks) an address from the device table.
template <int R>
__device__ __forceinline__ void* inbox_of(const Push& p, int q) {
  if constexpr (R > 0) {
    return p.inbox[q];
  } else {
    return reinterpret_cast<void*>(__ldg(p.table + q));
  }
}
template <int R>
__device__ __forceinline__ int* flags_of(const Push& p, int q) {
  if constexpr (R > 0) {
    return p.flags[q];
  } else {
    return reinterpret_cast<int*>(__ldg(p.table + p.ranks + q));
  }
}

// Block b of rank me: (1) stores its items of this rank's partial (row me
// of its own inbox) into row me of every peer's inbox, over NVLink;
// (2) thread 0 makes them visible (the block's barrier, then a system
// fence), publishes the epoch into word [me][b] of every peer's flags and
// waits, bounded, with acquire loads of this card's words [q][b] until
// every peer's block b has published it; (3) sums its items of the R rows
// of its own inbox, this card's memory only, in the ring's order: row me,
// me - 1, ..., me - R + 1.  A failure (the error word already set, a
// poisoned word, the timeout) sets the error word and publishes the poison
// into every word [me][*] of every peer; a launch that finds the error
// word set pushes nothing.  Up to kMaxShards ranks the rank loops run over
// constant indices: a kernel parameter indexed by a variable is copied to
// the stack.  Past it (R = 0) they run over p.ranks, each address read
// from the device table.
template <typename T, int R, bool Vec>
__global__ void __launch_bounds__(kThreads) push_wait_kernel(const Push p) {
  using It = Item<Vec>;
  constexpr bool kWide = R == 0;
  const int ranks = kWide ? p.ranks : R;
  __shared__ int s_failed;
  const int b = blockIdx.x;
  const int64_t stride = static_cast<int64_t>(p.blocks) * kThreads;
  const int64_t first = static_cast<int64_t>(b) * kThreads + threadIdx.x;
  const int64_t row = Vec ? p.n / 4 : p.n;  // items a row
  const It* own = static_cast<const It*>(p.own_inbox);
  if (threadIdx.x == 0) s_failed = load_acquire_sys(p.error) != 0;
  __syncthreads();
  if (!s_failed) {
    if constexpr (kWide) {
      for (int q = 0; q < ranks; ++q) {
        if (q == p.me) continue;
        It* dst = static_cast<It*>(inbox_of<R>(p, q));
        for (int64_t i = first; i < p.items; i += stride)
          dst[p.me * row + i] = __ldg(own + p.me * row + i);
      }
    } else {
      for (int64_t i = first; i < p.items; i += stride) {
        const It v = __ldg(own + p.me * row + i);
#pragma unroll
        for (int q = 0; q < R; ++q) {
          if (q != p.me) static_cast<It*>(inbox_of<R>(p, q))[p.me * row + i] = v;
        }
      }
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    bool failed = s_failed;
    if (!failed) {
      __threadfence_system();
#pragma unroll
      for (int q = 0; q < (kWide ? ranks : R); ++q) {
        if (q != p.me) atomicMax_system(flags_of<R>(p, q) + p.me * kWaitBlocks + b, p.epoch);
      }
      const long long t0 = global_ns();
#pragma unroll
      for (int q = 0; q < (kWide ? ranks : R); ++q) {
        while (q != p.me && !failed) {
          const int v = load_acquire_sys(p.own_flags + q * kWaitBlocks + b);
          if (v >= p.epoch && v != kPoison) break;
          failed = v == kPoison || global_ns() - t0 > p.timeout_ns ||
                   load_acquire_sys(p.error) != 0;
          if (!failed) __nanosleep(32);
        }
      }
      __threadfence();
    }
    if (failed) atomicExch(p.error, 1);
    s_failed = failed;
  }
  __syncthreads();
  if (s_failed) {
    for (int w = threadIdx.x; w < kWaitBlocks; w += kThreads) {
#pragma unroll
      for (int q = 0; q < (kWide ? ranks : R); ++q) {
        if (q != p.me) atomicMax_system(flags_of<R>(p, q) + p.me * kWaitBlocks + w, kPoison);
      }
    }
    return;
  }
  for (int64_t i = first; i < p.items; i += stride) {
    It acc = ld_cg(own + p.me * row + i);
#pragma unroll
    for (int t = 1; t < (kWide ? ranks : R); ++t) {
      const int q = p.me - t < 0 ? p.me - t + ranks : p.me - t;
      acc = add_bits<T>(acc, ld_cg(own + q * row + i));
    }
    static_cast<It*>(p.out)[i] = acc;
  }
}

template <typename T, int R>
void push_wait(const Push& p, cudaStream_t s) {
  if (p.items == p.n) {
    push_wait_kernel<T, R, false><<<p.blocks, kThreads, 0, s>>>(p);
  } else {
    push_wait_kernel<T, R, true><<<p.blocks, kThreads, 0, s>>>(p);
  }
}

template <typename T>
int push_wait_r(int R, const Push& p, cudaStream_t s) {
  switch (R) {
    case 1: push_wait<T, 1>(p, s); break;
    case 2: push_wait<T, 2>(p, s); break;
    case 3: push_wait<T, 3>(p, s); break;
    case 4: push_wait<T, 4>(p, s); break;
    case 5: push_wait<T, 5>(p, s); break;
    case 6: push_wait<T, 6>(p, s); break;
    case 7: push_wait<T, 7>(p, s); break;
    case 8: push_wait<T, 8>(p, s); break;
    case 9: push_wait<T, 9>(p, s); break;
    case 10: push_wait<T, 10>(p, s); break;
    case 11: push_wait<T, 11>(p, s); break;
    case 12: push_wait<T, 12>(p, s); break;
    case 13: push_wait<T, 13>(p, s); break;
    case 14: push_wait<T, 14>(p, s); break;
    case 15: push_wait<T, 15>(p, s); break;
    case 16: push_wait<T, 16>(p, s); break;
    default: push_wait<T, 0>(p, s); break;  // wider: the device table
  }
  return static_cast<int>(cudaGetLastError());
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

// The words entry: (S, n, 8) word rows and (S, n) codes, roff, base, own
// and out, each one stacked tensor: shard d's rows at base + d * n (words
// at words + d * 8 n).
struct WordsIO {
  const int* words;
  const int* codes;
  const int* roff;
  const int* base;
  const int* own;
  int* out;
};

__global__ void __launch_bounds__(kThreads) fused_words_kernel(const WordsIO p, int S, int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += stride) {
    unsigned acc = 0;
    for (int d = 0; d < S; ++d) {
      const int64_t j = d * n + i;
      const int own = __ldg(p.own + j);
      if (own != 0) {
        const unsigned cnt =
            rank_partial(p.words + j * 8, __ldg(p.codes + j), __ldg(p.roff + j));
        acc += static_cast<unsigned>(own) * (static_cast<unsigned>(__ldg(p.base + j)) + cnt);
      }
    }
    for (int d = 0; d < S; ++d) p.out[d * n + i] = static_cast<int>(acc);
  }
}

// The table entry: the stacked shard tables and n (code, coordinate)
// queries -> n merged occ values.
struct TableIO {
  const int* codes;     // (n,) 0..3
  const int* k;         // (n,) sentinel-inclusive coordinates
  int* out;             // (n,)
  int64_t n;
};

// `fm` comes whole from the host (the tables stacked or in a device table,
// the bounds in device memory with the binding's findings).
template <bool Stacked>
__global__ void __launch_bounds__(kThreads)
    fused_occ_kernel(const TableIO a, gwa::ShardedFM<Stacked> fm) {
  gwa::split_base(fm.pk);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < a.n;
       i += stride) {
    const int k = __ldg(a.k + i), c = __ldg(a.codes + i) & 3;
    if (fm.pk.disjoint) {  // one owner at most: shard_fm_index's split
      const gwa::ShardRow row = gwa::load_row(fm, k);
      a.out[i] = row.own ? gwa::occ1(row.row, c) : 0;
    } else {  // overlapping ranges: every owner's partial, summed as the plain version does
      const int k_adj = k - (k > fm.primary ? 1 : 0);
      unsigned acc = 0;
      for (int d = 0; d < fm.pk.S; ++d) {
        if (k_adj >= __ldg(fm.pk.start + d) && k_adj < __ldg(fm.pk.end + d))
          acc += static_cast<unsigned>(gwa::occ1(gwa::shard_row(fm, d, k_adj), c));
      }
      a.out[i] = static_cast<int>(acc);
    }
  }
}

template <bool Stacked>
int launch_occ(const TableIO& a, int S, int R, int primary, const gwa::Split& pk,
               const void* bwt, const void* cp, const uint64_t* table, unsigned blocks,
               cudaStream_t stream) {
  gwa::ShardedFM<Stacked> fm{};
  fm.bwt = gwa::shard_table<Stacked>(bwt, table, static_cast<int64_t>(R) * 8);
  fm.cp = gwa::shard_table<Stacked>(cp, table ? table + S : nullptr, static_cast<int64_t>(R) * 4);
  fm.pk = pk;
  fm.R = R;
  fm.primary = primary;
  fused_occ_kernel<Stacked><<<blocks, kThreads, 0, stream>>>(a, fm);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype 0: int32, 1: float32; n elements a shard.  in_ptrs, out_ptrs: S
// device pointers each (host memory); a null output pointer is not
// written, and `only` (-1: none) is the one output that is.  aligned: every
// pointer 16-byte aligned (the binding's finding).  Up to kMaxShards shards
// the pointers are the unrolled kernel's parameters; past it the inputs
// are the rows of one stacked tensor (shard 0's at in_ptrs[0]) where
// `in_table` is null, else their S addresses in device memory
// (`in_table`), and the outputs one stacked tensor or shard `only`'s.
extern "C" int gwa_allreduce(int dtype, int S, int64_t n, const uint64_t* in_ptrs,
                             const uint64_t* out_ptrs, const void* in_table, int aligned,
                             int only, void* stream) {
  if (S < 1 || n < 0 || (dtype != 0 && dtype != 1) || only < -1 || only >= S)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (S <= kMaxShards) {
    ShardIO p{};
    for (int d = 0; d < S; ++d) {
      p.in[d] = reinterpret_cast<const void*>(in_ptrs[d]);
      p.out[d] = reinterpret_cast<void*>(out_ptrs[d]);
    }
    return dtype == 0 ? allreduce_s<int>(S, p, n, aligned != 0, s)
                      : allreduce_s<float>(S, p, n, aligned != 0, s);
  }
  SumIO p{};
  p.S = S;
  p.only = only;
  p.in = reinterpret_cast<const char*>(in_ptrs[0]);
  p.out = reinterpret_cast<char*>(out_ptrs[only < 0 ? 0 : only]);
  p.stride = n * 4;  // int32 and float32 alike
  p.in_tab = static_cast<const uint64_t*>(in_table);
  const bool vec = aligned && n % 4 == 0;
  const int64_t items = vec ? n / 4 : n;
  if (dtype == 0) {
    const int g_log = split_lanes_log(S);
    return vec ? launch_split<true>(p, items, g_log, s) : launch_split<false>(p, items, g_log, s);
  }
  unsigned blocks = 0;
  const int rc = grid_blocks(items, &blocks);
  if (rc != 0) return rc;
  if (vec) {
    allreduce_ring_kernel<true><<<blocks, kThreads, 0, s>>>(p, items);
  } else {
    allreduce_ring_kernel<false><<<blocks, kThreads, 0, s>>>(p, items);
  }
  return static_cast<int>(cudaGetLastError());
}

// The grid of a flag-wait merge of n elements (the same on every rank).
extern "C" int gwa_allreduce_wait_blocks(int64_t n) { return n > 0 ? wait_blocks(n) : 0; }

// The flag-wait entry (ranks on separate cards), one merge with `epoch`
// (1 .. kPoison - 1): inbox_ptrs and flag_ptrs, `ranks` device pointers
// each (host memory), are rank q's (ranks, n) inbox and (ranks,
// kWaitBlocks) flag words (this rank's own at `me`, the others mapped on
// this card); this rank's partial is row me of its own inbox; out: this
// rank's (n,) sum; error: its error word.  Every pointer 16-byte aligned.
// `table` holds the same 2 ranks addresses in device memory (the
// inboxes', then the flags'), read past kMaxShards ranks.  Launches on
// `device` (made current for the launch if it is not).
extern "C" int gwa_allreduce_wait(int dtype, int64_t n, int ranks, int me,
                                  const uint64_t* inbox_ptrs, const uint64_t* flag_ptrs,
                                  void* out, void* error, int epoch, long long timeout_ns,
                                  int device, const void* table, void* stream) {
  if (n < 0 || ranks < 1 || me < 0 || me >= ranks || epoch < 1 || epoch >= kPoison ||
      error == nullptr || timeout_ns < 0 || (dtype != 0 && dtype != 1) ||
      (ranks > kMaxShards && table == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Push p{};
  uintptr_t bits = reinterpret_cast<uintptr_t>(out) | reinterpret_cast<uintptr_t>(error);
  for (int q = 0; q < ranks; ++q) {
    if (q < kMaxShards) {
      p.inbox[q] = reinterpret_cast<void*>(inbox_ptrs[q]);
      p.flags[q] = reinterpret_cast<int*>(flag_ptrs[q]);
    }
    bits |= inbox_ptrs[q] | flag_ptrs[q];
  }
  if (bits % 16) return static_cast<int>(cudaErrorMisalignedAddress);
  if (n == 0) return 0;
  p.table = ranks > kMaxShards ? static_cast<const uint64_t*>(table) : nullptr;
  p.ranks = ranks;
  p.own_inbox = reinterpret_cast<const void*>(inbox_ptrs[me]);
  p.own_flags = reinterpret_cast<const int*>(flag_ptrs[me]);
  p.out = out;
  p.error = static_cast<int*>(error);
  p.n = n;
  p.items = wait_items(n);
  p.me = me;
  p.epoch = epoch;
  p.blocks = wait_blocks(n);
  p.timeout_ns = timeout_ns;
  int current = 0;
  cudaError_t e = cudaGetDevice(&current);
  if (e == cudaSuccess && current != device) e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  auto s = static_cast<cudaStream_t>(stream);
  const int rc = dtype == 0 ? push_wait_r<int>(ranks, p, s) : push_wait_r<float>(ranks, p, s);
  if (current != device) cudaSetDevice(current);
  return rc;
}

// words (S, n, 8) 16-byte aligned, codes, roff, base, own and out (S, n):
// int32, each one stacked tensor.
extern "C" int gwa_fused_words(int S, int64_t n, const void* words, const void* codes,
                               const void* roff, const void* base, const void* own, void* out,
                               void* stream) {
  if (S < 1 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  unsigned blocks = 0;
  const int rc = grid_blocks(n, &blocks);
  if (rc != 0) return rc;
  const WordsIO p{static_cast<const int*>(words), static_cast<const int*>(codes),
                  static_cast<const int*>(roff),  static_cast<const int*>(base),
                  static_cast<const int*>(own),   static_cast<int*>(out)};
  fused_words_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p, S, n);
  return static_cast<int>(cudaGetLastError());
}

// Each of the S shards' bwt (R, 8) and occ_cp (R, 4) 16-byte aligned,
// pk_start and pk_end (S,), codes, k and out (n,), all int32.  The shards
// are the rows of one stacked bwt and occ_cp (shard 0's at `bwt` and `cp`)
// where `table` is null, else each in its own allocation, `table` their 2
// S pointers in device memory (bwt's, then occ_cp's).  The owner guess is
// (x - pk_start[0]) / width = __umulhi(x - pk_start[0], pk_magic) >>
// pk_shift (fm_search_cuda.owner_divisor): the shards need not start at 0
// (the held shards of one process, whose coordinates outside them add 0);
// pk_facts is the binding's finding on the bounds (bit 0: disjoint, bit 1:
// in order).
extern "C" int gwa_fused_occ(int S, int R, int primary, int64_t n, const void* bwt,
                             const void* cp, const void* table, const void* pk_start,
                             const void* pk_end, unsigned pk_magic, int pk_shift, int pk_facts,
                             const void* codes, const void* k, void* out, void* stream) {
  if (S < 1 || R < 1 || n < 0 || pk_shift < 0 || pk_shift > 31)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  TableIO a{};
  a.codes = static_cast<const int*>(codes);
  a.k = static_cast<const int*>(k);
  a.out = static_cast<int*>(out);
  a.n = n;
  unsigned blocks = 0;
  const int rc = grid_blocks(n, &blocks);
  if (rc != 0) return rc;
  const gwa::Split pk = gwa::make_split(pk_start, pk_end, S, pk_magic, pk_shift, pk_facts);
  const auto tab = static_cast<const uint64_t*>(table);
  const auto st = static_cast<cudaStream_t>(stream);
  if (tab == nullptr) return launch_occ<true>(a, S, R, primary, pk, bwt, cp, tab, blocks, st);
  return launch_occ<false>(a, S, R, primary, pk, bwt, cp, tab, blocks, st);
}
