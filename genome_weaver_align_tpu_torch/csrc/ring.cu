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
// Every shard's buffers come in as their own base pointers: one stacked
// tensor's rows, or separate allocations, another process's mapped through
// CUDA IPC (parallel/peer.py: opened on this card with lazy peer access,
// so memory on another card is read over NVLink).  Across processes the
// sum's inputs are the ranks' mapped partial slots, and each process writes
// its own output only (a null output pointer is skipped).  Two orders between the processes:
//   - ranks that share one card: the host orders the steps (a stream
//     synchronize and a barrier before the sum reads the peers' slots):
//     kernels of two processes time-slice one card, so none may wait on
//     another's flag;
//   - ranks on separate cards: allreduce_kernel<T, S, true>, the
//     flag-wait entry (gwa_allreduce_wait), the port of what _ring_kernel
//     does with its barrier and capacity semaphores (ring.py:69-84,
//     :107-118).  Each block's thread 0 publishes the merge's epoch into
//     every peer's flag word (a system-scope fence, then an atomicMax over
//     NVLink; every block publishes, so the first block to run does it
//     whatever the order of the blocks), then spins, reading this rank's
//     own flag words (acquire), until every peer has reached that epoch,
//     and the block sums as below.  A peer publishes after its slot write
//     (stream order: the copy precedes the launch), so the acquire makes
//     its slot complete.  Two slots taken in turn are enough: a rank
//     writes slot i % 2 after its merge i - 1 saw every peer reach epoch
//     i - 1, so every peer's merge i - 2, the last reader of that slot,
//     has ended.
//     The wait is bounded, and a failure reaches every peer.  Past
//     `timeout_ns` of the card's global timer, or on finding a peer's word
//     poisoned, the block writes 1 to the error word and publishes the
//     poison (kPoison, above every epoch: the atomicMax keeps it) into
//     every peer's word; a launch that finds the error word set waits no
//     more and publishes the poison, never an epoch.  So a rank that has
//     stopped waiting, and may reuse a slot a slow peer still reads, has
//     poisoned that peer's next wait at the latest: the peer's error word
//     is set before its search ends.  The caller reads the error word once
//     the merges are done and raises, so a failed search never hangs and
//     never returns its sums.
//
// No ring.  The TPU ran a ring because ICI moves data by remote DMA between
// neighbours.  On one card all S shards lie in the same device memory and a
// ring's S-1 dependent hops are pure latency (round trips across SMs), so
// each kernel is one pass that reads every shard's input once and writes
// every shard's output.  Stream order makes every input complete at launch:
// nothing to wait on, no scratch, nothing for the host to read back.  Across
// NVLink-joined cards the same one pass reads the peers' slots over NVLink
// behind the flag wait: each rank reads every other rank's partial once
// (the bytes a ring would move to it) in one hop, not S-1 dependent ones.
// Its yardstick is NCCL's all_reduce on the same payload (chip_smoke.py
// [20]).
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
// owner, the clamped local block and roff; the tables stacked, or one
// allocation a shard: fm_occ.cuh ShardTable) through fm_occ.cuh's one
// definition of the split, load_row(ShardedFM): the owner by division,
// confirmed against the S bounds in shared memory (owner_of), and only the
// owner's 32-byte row of bwt_blocks and 16 bytes of occ_cp read (one
// sector each); occ1 counts it.  A coordinate with no owner adds 0 without
// a load; where the ranges are disjoint (shard_fm_index's split; load_split
// tests it once a block) the owner's value is the plain version's sum over
// the shards, and where they overlap the kernel sums every owner's partial
// as the plain version does.  No (S, M, Q, 8) word tensor is ever
// built.  At chr20 scale the shards' bwt_blocks are ~16 MB and stay in the
// 50 MB L2.  Bound: bytes, k, code, row, checkpoint and out, 48 B a query.
//
// Entries: gwa_allreduce, gwa_allreduce_wait, gwa_fused_words and
// gwa_fused_occ, plain C functions bound with ctypes.  The launches run on the caller's stream, do
// not synchronise, allocate nothing, and return the launch's CUDA error
// code.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "fm_occ.cuh"

namespace {

constexpr int kMaxShards = 16;
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

// The flag words of a merge across cards: rank r's flags are `ranks` int32
// words on its card, word q the last epoch rank q published to it, or
// kPoison once rank q's wait has failed.
constexpr int kPoison = 0x7fffffff;
struct Flags {
  int* peer[kMaxShards];  // each rank's flag words, mapped (this rank's own at me)
  const int* own;         // this rank's flag words
  int* error;             // this rank's error word, on its card
  int ranks, me, epoch;
  long long timeout_ns;
};

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

// `v` into this rank's word of every peer's flags, after this rank's
// earlier writes.  The rank loop runs over constant indices (unrolled and
// masked): a parameter indexed by a variable is copied to the stack.
__device__ __forceinline__ void publish(const Flags& f, int v) {
  __threadfence_system();
#pragma unroll
  for (int q = 0; q < kMaxShards; ++q) {
    if (q < f.ranks && q != f.me) atomicMax_system(f.peer[q] + f.me, v);
  }
}

// Thread 0 of the block publishes the epoch to every peer, then waits
// (bounded) until every peer has published it here; on a failure (the
// error word already set, a poisoned peer, the timeout) it sets the error
// word and publishes the poison.  The block waits on thread 0.
__device__ __forceinline__ void publish_and_wait(const Flags& f) {
  if (threadIdx.x == 0) {
    bool failed = load_acquire_sys(f.error) != 0;  // an earlier merge or block failed
    publish(f, failed ? kPoison : f.epoch);
    const long long t0 = global_ns();
    for (int q = 0; q < f.ranks && !failed; ++q) {
      while (q != f.me) {
        const int v = load_acquire_sys(f.own + q);
        if (v >= f.epoch && v != kPoison) break;
        if (v == kPoison || global_ns() - t0 > f.timeout_ns ||
            load_acquire_sys(f.error) != 0) {
          failed = true;
          break;
        }
        __nanosleep(64);
      }
    }
    if (failed) {
      atomicExch(f.error, 1);
      publish(f, kPoison);
    }
  }
  __syncthreads();
}

template <bool Wait>
__device__ __forceinline__ uint4 load_vec(const void* p, int64_t v) {
  // across cards the peers' slots are read with plain loads after the
  // acquire: not through the read-only path
  if constexpr (Wait) {
    return static_cast<const uint4*>(p)[v];
  } else {
    return __ldg(static_cast<const uint4*>(p) + v);
  }
}

// Elements [0, 4 n_vec) as 16-byte vectors (every pointer 16-byte aligned),
// then [4 n_vec, n) one at a time.
// A null output pointer is not written: across processes each writes its
// own shard's output only.  With Wait, the flag wait first (Flags).
template <typename T, int S, bool Wait>
__global__ void __launch_bounds__(kThreads) allreduce_kernel(const ShardIO p, int64_t n,
                                                             int64_t n_vec, const Flags f) {
  if constexpr (Wait) publish_and_wait(f);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  bool want[S];
#pragma unroll
  for (int d = 0; d < S; ++d) want[d] = p.out[d] != nullptr;
  for (int64_t v = first; v < n_vec; v += stride) {
    T x[S][4], out[S][4];
#pragma unroll
    for (int d = 0; d < S; ++d) {
      const uint4 u = load_vec<Wait>(p.in[d], v);
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

template <typename T, int S, bool Wait>
int allreduce(const ShardIO& p, int64_t n, const Flags& f, cudaStream_t stream) {
  bool aligned = true;
  for (int d = 0; d < S; ++d)
    aligned &= (reinterpret_cast<uintptr_t>(p.in[d]) | reinterpret_cast<uintptr_t>(p.out[d])) %
                   16 == 0;
  const int64_t n_vec = aligned ? n / 4 : 0;
  unsigned blocks = 0;
  const int rc = grid_blocks(n_vec > n - 4 * n_vec ? n_vec : n - 4 * n_vec, &blocks);
  if (rc != 0) return rc;
  allreduce_kernel<T, S, Wait><<<blocks, kThreads, 0, stream>>>(p, n, n_vec, f);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool Wait = false>
int allreduce_s(int S, const ShardIO& p, int64_t n, cudaStream_t s, const Flags& f = Flags{}) {
  switch (S) {
    case 1: return allreduce<T, 1, Wait>(p, n, f, s);
    case 2: return allreduce<T, 2, Wait>(p, n, f, s);
    case 3: return allreduce<T, 3, Wait>(p, n, f, s);
    case 4: return allreduce<T, 4, Wait>(p, n, f, s);
    case 5: return allreduce<T, 5, Wait>(p, n, f, s);
    case 6: return allreduce<T, 6, Wait>(p, n, f, s);
    case 7: return allreduce<T, 7, Wait>(p, n, f, s);
    case 8: return allreduce<T, 8, Wait>(p, n, f, s);
    case 9: return allreduce<T, 9, Wait>(p, n, f, s);
    case 10: return allreduce<T, 10, Wait>(p, n, f, s);
    case 11: return allreduce<T, 11, Wait>(p, n, f, s);
    case 12: return allreduce<T, 12, Wait>(p, n, f, s);
    case 13: return allreduce<T, 13, Wait>(p, n, f, s);
    case 14: return allreduce<T, 14, Wait>(p, n, f, s);
    case 15: return allreduce<T, 15, Wait>(p, n, f, s);
    case 16: return allreduce<T, 16, Wait>(p, n, f, s);
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
  const int* pk_start;  // (S,)
  const int* pk_end;    // (S,)
  const int* codes;     // (n,) 0..3
  const int* k;         // (n,) sentinel-inclusive coordinates
  int* out;             // (n,)
  int64_t n;
};

template <bool Stacked>
__global__ void __launch_bounds__(kThreads)
    fused_occ_kernel(const TableIO a, gwa::ShardedFM<Stacked> fm, const gwa::ShardPtrs bwt,
                     const gwa::ShardPtrs cp) {
  __shared__ int s_ps[kMaxShards], s_pe[kMaxShards];
  __shared__ const int* s_bwt[kMaxShards];
  __shared__ const int* s_cp[kMaxShards];
  fm.bwt = gwa::load_shards<Stacked>(bwt, fm.pk.S, static_cast<int64_t>(fm.R) * 8, s_bwt);
  fm.cp = gwa::load_shards<Stacked>(cp, fm.pk.S, static_cast<int64_t>(fm.R) * 4, s_cp);
  fm.pk = gwa::load_split(a.pk_start, a.pk_end, fm.pk.S, fm.pk.magic, fm.pk.shift, s_ps, s_pe);
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
        if (k_adj >= fm.pk.start[d] && k_adj < fm.pk.end[d])
          acc += static_cast<unsigned>(gwa::occ1(gwa::shard_row(fm, d, k_adj), c));
      }
      a.out[i] = static_cast<int>(acc);
    }
  }
}

template <bool Stacked>
gwa::ShardedFM<Stacked> sharded_fm(int S, int R, int primary, unsigned pk_magic, int pk_shift) {
  gwa::ShardedFM<Stacked> fm{};
  fm.pk = {nullptr, nullptr, S, pk_magic, pk_shift, false, 0};
  fm.R = R;
  fm.primary = primary;
  return fm;
}

}  // namespace

// dtype 0: int32, 1: float32.  in_ptrs, out_ptrs: S device pointers each, n
// elements a shard; a null output pointer is not written.
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

// The flag-wait entry (ranks on separate cards): gwa_allreduce's sum after
// this rank publishes `epoch` (1 .. kPoison - 1) to every peer and waits,
// at most `timeout_ns`, until every peer has published it.  flag_ptrs: `ranks`
// device pointers, rank q's `ranks` flag words (this rank's at `me`, the
// others mapped); error: this rank's error word.
extern "C" int gwa_allreduce_wait(int dtype, int S, int64_t n, const uint64_t* in_ptrs,
                                  const uint64_t* out_ptrs, int ranks, int me,
                                  const uint64_t* flag_ptrs, int epoch, void* error,
                                  long long timeout_ns, void* stream) {
  if (S < 1 || S > kMaxShards || n < 0 || ranks < 1 || ranks > kMaxShards || me < 0 ||
      me >= ranks || epoch < 1 || epoch >= kPoison || error == nullptr || timeout_ns < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  ShardIO p{};
  for (int d = 0; d < S; ++d) {
    p.in[d] = reinterpret_cast<const void*>(in_ptrs[d]);
    p.out[d] = reinterpret_cast<void*>(out_ptrs[d]);
  }
  Flags f{};
  for (int q = 0; q < ranks; ++q) f.peer[q] = reinterpret_cast<int*>(flag_ptrs[q]);
  f.own = f.peer[me];
  f.error = static_cast<int*>(error);
  f.ranks = ranks;
  f.me = me;
  f.epoch = epoch;
  f.timeout_ns = timeout_ns;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return allreduce_s<int, true>(S, p, n, s, f);
  if (dtype == 1) return allreduce_s<float, true>(S, p, n, s, f);
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

// Each of the S shards' bwt (R, 8) and occ_cp (R, 4) 16-byte aligned
// (bwt_ptrs and cp_ptrs: S device pointers each), pk_start and pk_end (S,),
// codes, k and out (n,), all int32.  The owner guess is (x - pk_start[0]) /
// width = __umulhi(x - pk_start[0], pk_magic) >> pk_shift
// (fm_search_cuda.owner_divisor): the shards need not start at 0 (the held
// shards of one process, whose coordinates outside them add 0).
extern "C" int gwa_fused_occ(int S, int R, int primary, int64_t n, const uint64_t* bwt_ptrs,
                             const uint64_t* cp_ptrs, const void* pk_start, const void* pk_end,
                             unsigned pk_magic, int pk_shift, const void* codes, const void* k,
                             void* out, void* stream) {
  if (S < 1 || S > kMaxShards || R < 1 || n < 0 || pk_shift < 0 || pk_shift > 31)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  TableIO a{};
  a.pk_start = static_cast<const int*>(pk_start);
  a.pk_end = static_cast<const int*>(pk_end);
  a.codes = static_cast<const int*>(codes);
  a.k = static_cast<const int*>(k);
  a.out = static_cast<int*>(out);
  a.n = n;
  gwa::ShardPtrs bwt{}, cp{};
  for (int s = 0; s < S; ++s) {
    bwt.p[s] = reinterpret_cast<const int*>(bwt_ptrs[s]);
    cp.p[s] = reinterpret_cast<const int*>(cp_ptrs[s]);
  }
  unsigned blocks = 0;
  const int rc = grid_blocks(n, &blocks);
  if (rc != 0) return rc;
  const auto st = static_cast<cudaStream_t>(stream);
  if (gwa::evenly_spaced(bwt, S, static_cast<int64_t>(R) * 8) &&
      gwa::evenly_spaced(cp, S, static_cast<int64_t>(R) * 4)) {
    fused_occ_kernel<true><<<blocks, kThreads, 0, st>>>(a, sharded_fm<true>(S, R, primary,
                                                                            pk_magic, pk_shift),
                                                        bwt, cp);
  } else {
    fused_occ_kernel<false><<<blocks, kThreads, 0, st>>>(a, sharded_fm<false>(S, R, primary,
                                                                              pk_magic, pk_shift),
                                                         bwt, cp);
  }
  return static_cast<int>(cudaGetLastError());
}
