// Staircase suffix-filter search on Hopper (sm_90a): one group of G lanes a
// (piece, read) pool, the whole search in one launch, up to and including
// the compaction of each pool to its `keep` best slots.
//
// Replaces the JAX package's device loops of
// genome_weaver_align_tpu/models/staircase.py: the spine (:131), the forward
// staircase (:215), the left narrowing (:235) and the pool compaction
// (_compact_pool, :43), each a lax.fori_loop under jit, and computes exactly
// the port's plain version, models/staircase.py staircase_pools_plain:
//
//   spine   piece p of read b built backward on the forward table
//           (spine_steps steps);
//   pool    n_slots slots (lo, hi, rlo, rhi, mm); slot 0 the spine, mm 0;
//   forward fwd_steps steps at j = e_p + t while j < len: every live slot
//           makes its four children with one all-4 extension on the reverse
//           table; child c is kept when mm + (c != read[j]) <= piece_of(j)
//           - p and its interval is not empty; the kept children, in
//           slot-major, code-minor order, fill the slots, the rest are
//           zeroed, and the pool overflows when more than n_slots were kept;
//   narrow  (narrow_left) bwd_steps steps at j = s_p - 1 - t while j >= 0,
//           all-4 extensions on the forward table under budget k; each
//           parent's children ranked exact first, then by code, and taken
//           rank-major: every slot's rank-0 child, then every rank-1 child;
//   keep    the first `keep` live slots, in slot order, are the output; the
//           pool overflows when more were live.
//
// The pool is packed after every step (kept children have non-empty
// intervals), so its live slots are exactly [0, live), and the kernel keeps
// `live` instead of zeroing the rest: slots past it are never read, and the
// output writes zeros past it, as the plain version's zeroed slots give.  An
// inactive pool keeps its state, so a group leaves a phase at its first
// inactive step, and a pool with no live slot stays empty (a dead parent has
// only dead children), so it leaves the search there; a warp leaves a phase
// when all its pools have.  Either way the output is the plain version's.
//
// Where the lanes go: group lane 0 builds the spine (one lane, not 32
// alike); a step runs passes over the live slots only, H slots a lane
// (H = 2 only for a whole warp on more than 32 slots, so one pass covers
// them), and a lane past `live` issues no load and no count.  The children
// go to the pool's other buffer (two buffers of n_slots slots: lo, hi,
// rlo, mm; rhi = rlo + hi - lo), placed by a ballot and prefix popcount
// masked to the group: slot-major, a lane's kept children are consecutive
// (three ballots of its count); rank-major, one ballot a rank, and a
// rank's children start after every earlier rank's, so the step must see
// every parent in one pass: a narrowing pool always takes a whole warp.
//
// What bounds it: latency where the pools are few, instruction issue
// where they are many.  The binding gives a pool enough lanes for its slots
// in one pass (16 for a tier-2 call's 16 slots, a warp for the rescue's 64)
// and halves them as the launch outgrows the card, down to one lane a pool
// at --mode staircase's 98,304 pools (about one live slot a non-empty
// pool-step there: a warp counts 32 pools' rows at once); a narrowing pool
// always takes a warp (past 64 slots in the Wide kernel, whose narrowing
// step counts before it places).  Any count of slots: a pool takes more
// lanes where a warp's pools outgrow a block's shared memory (fit_lanes),
// and past 7,000 slots at a warp the pools move to global scratch (the
// Wide kernel).  Every step waits on the
// 48-byte rows the previous step chose: 2 a live slot, requested before
// either is counted.  Bytes a step a pool: 96 a live slot plus 4 of read.
//
// Entry: gwa_staircase, a plain C function bound with ctypes; it launches on
// the caller's stream, does not synchronise, allocates nothing, and returns
// the launch's CUDA error code.

#include <cuda_runtime.h>

#include <cstdint>

#include "fm_occ.cuh"

namespace {

constexpr int kThreads = 128;  // a block: 4 warps, fewer where shared memory runs short
constexpr int kMaxSlots = 64;  // slots of the one-pass narrowing step; past it the Wide kernel
constexpr int kMaxPieces = 32;
constexpr unsigned kAll = 0xFFFFFFFFu;

struct StairArgs {
  const int* reads;    // (B, L) int32 codes 0..3
  const int* lengths;  // (B,)
  int* out_lo;         // (P, B, keep)
  int* out_hi;
  unsigned char* overflow;  // (P, B) bool
  int* scratch;             // past kMaxSlots, where a warp's pool outgrows shared memory:
                            // 8 n_slots ints a pool (else null)
  int B, L, P, k, n_slots, keep, spine_steps, fwd_steps, bwd_steps, n, lanes;
  bool narrow_left;
};

// A group's lanes: its size, this lane's place in it, and ballot masks.
struct Group {
  int G, gl;
  unsigned mask, below;
};

// A pool buffer: lo, hi, rlo, mm of n slots, one array after another.
struct Slots {
  int* p;
  int n;
  __device__ int& lo(int s) const { return p[s]; }
  __device__ int& hi(int s) const { return p[n + s]; }
  __device__ int& rlo(int s) const { return p[2 * n + s]; }
  __device__ int& mm(int s) const { return p[3 * n + s]; }
};

// A parent slot as read from the pool, with its two rows requested.
struct Parent {
  int lo, hi, rlo, mm;
  gwa::FusedRow ra, rb;
};

// The children of a parent, by code (lo, hi, rlo), and the bits of those
// kept under the budget.
struct Kids {
  int lo[4], hi[4], rlo[4], mm;
  unsigned keep;
};

__device__ __forceinline__ void fetch(const Slots& src, int s, const gwa::FMTable& tab,
                                      bool forward, Parent& p) {
  p.lo = src.lo(s);
  p.hi = src.hi(s);
  p.rlo = src.rlo(s);
  p.mm = src.mm(s);
  p.ra = gwa::load_row(tab, forward ? p.rlo : p.lo);
  p.rb = gwa::load_row(tab, forward ? p.rlo + p.hi - p.lo : p.hi);
}

__device__ __forceinline__ Kids children_of(const Parent& p, const gwa::FMTable& tab,
                                            bool forward, int c, int budget) {
  gwa::Children m;
  if (forward) {
    gwa::children_from_rows(tab, p.ra, p.rb, p.rlo, p.rlo + p.hi - p.lo, p.lo, m);
  } else {
    gwa::children_from_rows(tab, p.ra, p.rb, p.lo, p.hi, p.rlo, m);
  }
  Kids k;
  k.mm = p.mm;
  k.keep = 0;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    k.lo[a] = forward ? m.olo[a] : m.mlo[a];
    k.hi[a] = forward ? m.ohi[a] : m.mhi[a];
    k.rlo[a] = forward ? m.mlo[a] : m.olo[a];
    const bool ok = k.mm + (a != c ? 1 : 0) <= budget && k.hi[a] > k.lo[a];
    k.keep |= (ok ? 1u : 0u) << a;
  }
  return k;
}

// The children of the H parents a lane takes in pass q, slots
// (q H + h) G + gl: every row of the pass is requested before any is
// counted.  A slot past `live` is no work (no children kept).
template <int H>
__device__ __forceinline__ void pass_children(const Slots& src, int live, int q,
                                              const gwa::FMTable& tab, bool forward, int c,
                                              int budget, const Group& g, Kids (&k)[H]) {
  Parent p[H];
#pragma unroll
  for (int h = 0; h < H; ++h) {
    const int s = (q * H + h) * g.G + g.gl;
    if (s < live) fetch(src, s, tab, forward, p[h]);
  }
#pragma unroll
  for (int h = 0; h < H; ++h) {
    const int s = (q * H + h) * g.G + g.gl;
    k[h] = Kids{};
    if (s < live) k[h] = children_of(p[h], tab, forward, c, budget);
  }
}

__device__ __forceinline__ void put(const Slots& dst, int dest, const Kids& k, int a, int mm) {
  if (dest < dst.n) {
    dst.lo(dest) = gwa::pick4(k.lo, a);
    dst.hi(dest) = gwa::pick4(k.hi, a);
    dst.rlo(dest) = gwa::pick4(k.rlo, a);
    dst.mm(dest) = mm;
  }
}

// Rank r's code: rank 0 is the read's code c, ranks 1..3 the other codes
// in order.
__device__ __forceinline__ int rank_code(int r, int c) {
  return r == 0 ? c : (r - 1) + (r - 1 >= c ? 1 : 0);
}

// One all-4 expansion of the live slots [0, live) of `src` into `dst` and
// the compaction of the kept children; returns the number kept (which may
// exceed n_slots).  A pass takes H G parents, H a lane.  Every lane of the
// warp calls it (the ballots are warp-wide); a group with live == 0 takes
// part with no work.  Wide (past kMaxSlots slots, a warp a pool): a
// rank-major step may take several passes, so it counts each rank's kept
// children over every pass first, then runs the passes again (their rows
// read a second time, from L2) and places each child after every earlier
// rank's and after its rank's children of earlier parents.
template <int H, bool Wide>
__device__ int expand_step(const Slots& src, const Slots& dst, int live, const gwa::FMTable& tab,
                           bool forward, int c, int budget, bool rank_major, const Group& g) {
  const int passes = (live + H * g.G - 1) / (H * g.G);  // the same in every lane of a group
  Kids k[H];
  int base = 0;
  if (!rank_major) {
    for (int q = 0; __any_sync(kAll, q < passes); ++q) {
      pass_children<H>(src, live, q, tab, forward, c, budget, g, k);
#pragma unroll
      for (int h = 0; h < H; ++h) {
        // a lane's kept children are consecutive: the prefix over the
        // group's lanes of their counts (0..4, three ballots of its bits)
        // places the first
        const int cnt = __popc(k[h].keep);
        const unsigned b0 = __ballot_sync(kAll, cnt & 1) & g.mask,
                       b1 = __ballot_sync(kAll, cnt & 2) & g.mask,
                       b2 = __ballot_sync(kAll, cnt & 4) & g.mask;
        int dest = base + __popc(b0 & g.below) + 2 * __popc(b1 & g.below) +
                   4 * __popc(b2 & g.below);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          if ((k[h].keep >> a) & 1u) put(dst, dest++, k[h], a, k[h].mm + (a != c ? 1 : 0));
        }
        base += __popc(b0) + 2 * __popc(b1) + 4 * __popc(b2);
      }
    }
    __syncwarp();
    return base;
  }
  if constexpr (Wide) {
    int total[4] = {0, 0, 0, 0};
    for (int q = 0; __any_sync(kAll, q < passes); ++q) {
      pass_children<H>(src, live, q, tab, forward, c, budget, g, k);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int a = rank_code(r, c);
#pragma unroll
        for (int h = 0; h < H; ++h)
          total[r] += __popc(__ballot_sync(kAll, (k[h].keep >> a) & 1u) & g.mask);
      }
    }
    int at[4];  // where rank r's next child goes
    at[0] = 0;
#pragma unroll
    for (int r = 1; r < 4; ++r) at[r] = at[r - 1] + total[r - 1];
    for (int q = 0; __any_sync(kAll, q < passes); ++q) {
      pass_children<H>(src, live, q, tab, forward, c, budget, g, k);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int a = rank_code(r, c);
#pragma unroll
        for (int h = 0; h < H; ++h) {
          const bool kept = (k[h].keep >> a) & 1u;
          const unsigned bal = __ballot_sync(kAll, kept) & g.mask;
          if (kept) put(dst, at[r] + __popc(bal & g.below), k[h], a, k[h].mm + (a != c));
          at[r] += __popc(bal);
        }
      }
    }
    __syncwarp();
    return at[3];
  }
  // rank-major: rank 0 is child c, ranks 1..3 the other codes in order; a
  // narrowing pool is a whole warp whose one pass covers every live slot
  // (the entry refuses fewer lanes), so the pass's ballots are the totals
  pass_children<H>(src, live, 0, tab, forward, c, budget, g, k);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int a = rank_code(r, c);
#pragma unroll
    for (int h = 0; h < H; ++h) {
      const bool kept = (k[h].keep >> a) & 1u;
      const unsigned bal = __ballot_sync(kAll, kept);
      if (kept) put(dst, base + __popc(bal & g.below), k[h], a, k[h].mm + (a != c));
      base += __popc(bal);  // placed so far: earlier ranks, then earlier parents
    }
  }
  __syncwarp();
  return base;
}

// H: parents a lane takes in one pass (2 for a whole warp on a pool of more
// than 32 slots, so that one pass requests every live slot's rows).  The
// minimum blocks an SM cap the registers: H = 1 at 5 blocks (96 registers;
// one lane a pool of 16 slots fits 3 blocks in shared memory anyway), H = 2
// at 3 (168: a rescue call's 1,536 warps in one wave).  Wide: past
// kMaxSlots slots (a warp a pool, H = 2), the rank-major step in two
// rounds of passes (expand_step), and the pool in global scratch where a
// warp's pool outgrows a block's shared memory.  Phase [2] of
// chip_smoke.py prints what ptxas used and spilled.
template <int H, bool Wide>
__global__ void __launch_bounds__(kThreads, H == 1 ? 5 : 3)
    staircase_kernel(const StairArgs a, const int* fwd_blocks, const int* fwd_C, int fwd_primary,
                     const int* rev_blocks, const int* rev_C, int rev_primary) {
  extern __shared__ int smem[];
  const int lane = threadIdx.x & 31;
  Group g;
  g.G = a.lanes;
  g.gl = lane & (g.G - 1);
  const int gbase = lane - g.gl;
  g.mask = g.G == 32 ? kAll : ((1u << g.G) - 1u) << gbase;
  g.below = gwa::lanes_below() & g.mask;
  const int group = threadIdx.x / g.G;
  const int64_t pool_id = static_cast<int64_t>(blockIdx.x) * (blockDim.x / g.G) + group;
  const bool valid = pool_id < static_cast<int64_t>(a.P) * a.B;  // else idle in the collectives
  const int n = a.n_slots;
  int* pool = smem + group * 8 * n;  // two buffers of n slots
  if constexpr (Wide) {
    if (a.scratch != nullptr) pool = a.scratch + (valid ? pool_id : 0) * 8 * n;
  }
  const gwa::FMTable fwd = gwa::load_table(fwd_blocks, fwd_C, fwd_primary);
  const gwa::FMTable rev = gwa::load_table(rev_blocks, rev_C, rev_primary);
  const int p = valid ? static_cast<int>(pool_id / a.B) : 0;
  const int b = valid ? static_cast<int>(pool_id % a.B) : 0;
  const int len = valid ? __ldg(a.lengths + b) : 0;
  const int s_p = len * p / a.P, e_p = len * (p + 1) / a.P;
  const int* read = a.reads + static_cast<int64_t>(b) * a.L;

  // ---- spine: piece p built backward by group lane 0; slot 0 when live
  int live = 0;
  if (g.gl == 0 && valid) {
    gwa::BiIv spine{0, a.n + 1, 0, a.n + 1};
    for (int t = 0; t < a.spine_steps; ++t) {
      const int j = e_p - 1 - t;
      if (j < s_p || spine.hi <= spine.lo) break;  // an empty spine stays empty
      spine = gwa::extend_backward(fwd, spine, gwa::code_at(read, a.L, j));
    }
    if (spine.hi > spine.lo) {
      const Slots first{pool, n};
      first.lo(0) = spine.lo;
      first.hi(0) = spine.hi;
      first.rlo(0) = spine.rlo;
      first.mm(0) = 0;
      live = 1;
    }
  }
  live = __shfl_sync(kAll, live, gbase);  // the same in every lane of a group
  __syncwarp();
  int cur = 0;
  bool overflow = false;

  // ---- forward staircase through the pieces after p
  int piece = p, next_bound = e_p;  // piece_of(j), and where piece + 1 starts
  for (int t = 0; t < a.fwd_steps; ++t) {
    const int j = e_p + t;
    const bool act = live > 0 && j < len;
    if (!__any_sync(kAll, act)) break;
    int c = 0;
    if (act) {
      c = gwa::code_at(read, a.L, j);
      while (next_bound <= j) next_bound = len * (++piece + 1) / a.P;
    }
    const int kept = expand_step<H, Wide>(Slots{pool + cur * 4 * n, n},
                                          Slots{pool + (cur ^ 1) * 4 * n, n}, act ? live : 0,
                                          rev, true, c, piece - p, a.narrow_left, g);
    if (act) {
      overflow |= kept > n;
      live = min(kept, n);
      cur ^= 1;
    }
  }

  // ---- left narrowing through the pieces before p, budget k
  if (a.narrow_left) {
    for (int t = 0; t < a.bwd_steps; ++t) {
      const int j = s_p - 1 - t;
      const bool act = live > 0 && j >= 0;
      if (!__any_sync(kAll, act)) break;
      const int c = act ? gwa::code_at(read, a.L, j) : 0;
      const int kept = expand_step<H, Wide>(Slots{pool + cur * 4 * n, n},
                                            Slots{pool + (cur ^ 1) * 4 * n, n}, act ? live : 0,
                                            fwd, false, c, a.k, true, g);
      if (act) {
        overflow |= kept > n;
        live = min(kept, n);
        cur ^= 1;
      }
    }
  }

  // ---- the first `keep` live slots, in slot order, zeros after them
  if (!valid) return;
  int* out_lo = a.out_lo + pool_id * a.keep;
  int* out_hi = a.out_hi + pool_id * a.keep;
  const Slots last{pool + cur * 4 * n, n};
  for (int i = g.gl; i < a.keep; i += g.G) {
    out_lo[i] = i < live ? last.lo(i) : 0;
    out_hi[i] = i < live ? last.hi(i) : 0;
  }
  if (g.gl == 0) a.overflow[pool_id] = (overflow || live > a.keep) ? 1 : 0;
}

// The lanes a pool takes: `lanes`, doubled while a warp's pools outgrow a
// block's shared memory, up to 32 (threads 0 there: the pools go to
// scratch); the block's threads and shared memory in threads and smem.
int fit_lanes(int lanes, int n_slots, size_t& smem, int& threads) {
  for (;; lanes *= 2) {
    threads = gwa::block_threads(kThreads, lanes, 8 * static_cast<size_t>(n_slots) * sizeof(int),
                                 smem);
    if (threads > 0 || lanes >= 32) return lanes;
  }
}

}  // namespace

// Scratch ints a launch of `pools` pools of n_slots slots at `lanes` lanes a
// pool needs (fit_lanes): 0 where a warp's pools fit a block's shared memory
// at some lanes up to 32 (always up to kMaxSlots), else 8 n_slots a pool.
extern "C" int64_t gwa_staircase_scratch_ints(int lanes, int n_slots, int64_t pools) {
  size_t smem = 0;
  int threads = 0;
  if (lanes < 1 || lanes > 32 || n_slots < 1) return 0;
  fit_lanes(lanes, n_slots, smem, threads);
  return threads > 0 ? 0 : pools * 8 * n_slots;
}

// reads (B, L), lengths (B,), the forward and reverse tables' blocks
// (nb + 1, 12, 16-byte aligned) and C (5,): int32; out_lo / out_hi
// (P, B, keep) int32, overflow (P, B) bytes; lanes a pool: a power of two,
// 1..32, and 32 under narrow_left (doubled here while a warp's pools
// outgrow shared memory: fit_lanes); scratch: gwa_staircase_scratch_ints
// ints (null where that is 0).
extern "C" int gwa_staircase(const void* reads, const void* lengths, int B, int L, int P, int k,
                             int n_slots, int keep, int spine_steps, int fwd_steps, int bwd_steps,
                             int narrow_left, const void* fwd_blocks, const void* fwd_C,
                             int fwd_primary, const void* rev_blocks, const void* rev_C,
                             int rev_primary, int n, void* out_lo, void* out_hi, void* overflow,
                             int lanes, void* scratch, int64_t scratch_ints, void* stream) {
  if (B < 0 || L < 0 || P < 1 || P > kMaxPieces || n_slots < 1 || keep < 0 || lanes < 1 ||
      lanes > 32 || (lanes & (lanes - 1)) != 0 || (narrow_left && lanes != 32))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t pools = static_cast<int64_t>(P) * B;
  if (pools == 0) return 0;
  StairArgs a{};
  a.reads = static_cast<const int*>(reads);
  a.lengths = static_cast<const int*>(lengths);
  a.out_lo = static_cast<int*>(out_lo);
  a.out_hi = static_cast<int*>(out_hi);
  a.overflow = static_cast<unsigned char*>(overflow);
  a.B = B;
  a.L = L;
  a.P = P;
  a.k = k;
  a.n_slots = n_slots;
  a.keep = keep;
  a.spine_steps = spine_steps;
  a.fwd_steps = fwd_steps;
  a.bwd_steps = bwd_steps;
  a.n = n;
  a.narrow_left = narrow_left != 0;
  size_t smem = 0;
  int threads = 0;
  a.lanes = lanes = fit_lanes(lanes, n_slots, smem, threads);
  if (threads == 0) {  // a warp's pool outgrows shared memory: the pools live in scratch
    if (scratch == nullptr || scratch_ints < pools * 8 * n_slots)
      return static_cast<int>(cudaErrorInvalidValue);
    a.scratch = static_cast<int*>(scratch);
    threads = kThreads;
    smem = 0;
  }
  // the Wide kernel: a narrowing step in two rounds of passes, or the pools
  // in scratch (a warp a pool either way)
  const bool wide = (narrow_left && n_slots > kMaxSlots) || a.scratch != nullptr;
  const bool two = lanes == 32 && n_slots > 32;  // a warp's pass covers every slot
  const auto kernel = wide ? staircase_kernel<2, true>
                           : two ? staircase_kernel<2, false> : staircase_kernel<1, false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int groups = threads / lanes;
  const unsigned grid = static_cast<unsigned>((pools + groups - 1) / groups);
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<const int*>(fwd_blocks), static_cast<const int*>(fwd_C), fwd_primary,
      static_cast<const int*>(rev_blocks), static_cast<const int*>(rev_C), rev_primary);
  return static_cast<int>(cudaGetLastError());
}
