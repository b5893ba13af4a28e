// Staircase suffix-filter search on Hopper (sm_90a): one warp a (piece,
// read) pool, the whole search in one launch, up to and including the
// compaction of each pool to its `keep` best slots.
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
// An inactive pool keeps its state, so a warp leaves a phase at its first
// inactive step; a pool with no live slot stays empty (a dead parent has only
// dead children), so it leaves the search there.  Either way the output is
// the plain version's.
//
// What bounds it: latency where the pools are few (a tier-2 call's 1,536),
// instruction issue where they are many (--mode staircase's 98,304 pools:
// every lane counts its slots' rows, live or not, so a pool of one live slot
// costs a whole warp's work a step).  Every step waits on the 48-byte rows
// that the previous step chose: 2 a live slot.  Lane l holds slots l and
// l + 32 (a pool of at most 32 slots skips the second half in every lane),
// and the rows of both go out before either is used.  The pool lives in shared
// memory between steps and in registers within one; compaction is a warp
// ballot and a prefix popcount per child rank, so a step has no block-wide
// barrier.  Bytes a step a pool: 96 a live slot plus 4 of read.
//
// Entry: gwa_staircase, a plain C function bound with ctypes; it launches on
// the caller's stream, does not synchronise, allocates nothing, and returns
// the launch's CUDA error code.

#include <cuda_runtime.h>

#include <cstdint>

#include "fm_occ.cuh"

namespace {

constexpr int kWarps = 4;  // pools a block
constexpr int kMaxSlots = 64;
constexpr int kMaxPieces = 32;
constexpr unsigned kAll = 0xFFFFFFFFu;

struct StairArgs {
  const int* reads;    // (B, L) int32 codes 0..3
  const int* lengths;  // (B,)
  int* out_lo;         // (P, B, keep)
  int* out_hi;
  unsigned char* overflow;  // (P, B) bool
  int B, L, P, k, n_slots, keep, spine_steps, fwd_steps, bwd_steps, n;
  bool narrow_left;
};

struct Pool {
  int lo[kMaxSlots], hi[kMaxSlots], rlo[kMaxSlots], rhi[kMaxSlots], mm[kMaxSlots];
};

// Stable compaction of a warp's children into the pool: writes each kept
// child to slot base + (its rank among the kept children of this round)
// when that is below n_slots, and returns the round's kept count.
__device__ __forceinline__ int place(Pool& pool, int n_slots, int base, bool keep, int lo, int hi,
                                     int rlo, int rhi, int mm) {
  const unsigned ballot = __ballot_sync(kAll, keep);
  const int dest = base + __popc(ballot & gwa::lanes_below());
  if (keep && dest < n_slots) {
    pool.lo[dest] = lo;
    pool.hi[dest] = hi;
    pool.rlo[dest] = rlo;
    pool.rhi[dest] = rhi;
    pool.mm[dest] = mm;
  }
  return __popc(ballot);
}

// One all-4 expansion of every live slot and the compaction of the kept
// children; returns the number kept (which may exceed n_slots).
__device__ int expand_step(Pool& pool, const gwa::FMTable& fwd, const gwa::FMTable& rev,
                           bool forward, int n_slots, int c, int budget, bool rank_major) {
  const int lane = threadIdx.x & 31;
  const int halves = n_slots > 32 ? 2 : 1;  // the same in every lane of the warp
  gwa::BiIv v[2];
  int mm[2];
  bool live[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int s = lane + 32 * h;
    live[h] = h < halves && s < n_slots && pool.hi[s] > pool.lo[s];
    v[h] = live[h] ? gwa::BiIv{pool.lo[s], pool.hi[s], pool.rlo[s], pool.rhi[s]}
                   : gwa::BiIv{0, 0, 0, 0};
    mm[h] = live[h] ? pool.mm[s] : 0;
  }
  // the rows of both slots are requested before any is counted
  const gwa::FMTable& tab = forward ? rev : fwd;
  gwa::FusedRow ra[2], rb[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (h < halves) {
      ra[h] = gwa::load_row(tab, forward ? v[h].rlo : v[h].lo);
      rb[h] = gwa::load_row(tab, forward ? v[h].rhi : v[h].hi);
    }
  }
  struct {
    int lo[4], hi[4], rlo[4], rhi[4];
  } ch[2] = {};  // the children of both slots, by code
  unsigned keep[2] = {0, 0};  // bit a: child a is kept
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (h >= halves) continue;
    gwa::Children m;
    if (forward) {
      gwa::children_from_rows(tab, ra[h], rb[h], v[h].rlo, v[h].rhi, v[h].lo, m);
    } else {
      gwa::children_from_rows(tab, ra[h], rb[h], v[h].lo, v[h].hi, v[h].rlo, m);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      ch[h].lo[a] = forward ? m.olo[a] : m.mlo[a];
      ch[h].hi[a] = forward ? m.ohi[a] : m.mhi[a];
      ch[h].rlo[a] = forward ? m.mlo[a] : m.olo[a];
      ch[h].rhi[a] = forward ? m.mhi[a] : m.ohi[a];
      const bool ok = mm[h] + (a != c ? 1 : 0) <= budget && ch[h].hi[a] > ch[h].lo[a];
      keep[h] |= (live[h] && ok ? 1u : 0u) << a;
    }
  }
  __syncwarp();  // every lane has read its parents before any child is written
  int base = 0;
  if (rank_major) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int a = r == 0 ? c : (r - 1) + (r - 1 >= c ? 1 : 0);
#pragma unroll
      for (int h = 0; h < halves; ++h) {
        const int kept = place(pool, n_slots, base, (keep[h] >> a) & 1u, gwa::pick4(ch[h].lo, a),
                               gwa::pick4(ch[h].hi, a), gwa::pick4(ch[h].rlo, a),
                               gwa::pick4(ch[h].rhi, a), mm[h] + (a != c ? 1 : 0));
        base += kept;
      }
    }
  } else {
#pragma unroll
    for (int h = 0; h < halves; ++h) {
      // a lane's kept children are consecutive: the prefix over lanes of
      // their counts (0..4, three ballots of its bits) places the first
      const int cnt = __popc(keep[h]);
      const unsigned below = gwa::lanes_below();
      const unsigned b0 = __ballot_sync(kAll, cnt & 1), b1 = __ballot_sync(kAll, cnt & 2),
                     b2 = __ballot_sync(kAll, cnt & 4);
      int dest = base + __popc(b0 & below) + 2 * __popc(b1 & below) + 4 * __popc(b2 & below);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        if ((keep[h] >> a) & 1u) {
          if (dest < n_slots) {
            pool.lo[dest] = ch[h].lo[a];
            pool.hi[dest] = ch[h].hi[a];
            pool.rlo[dest] = ch[h].rlo[a];
            pool.rhi[dest] = ch[h].rhi[a];
            pool.mm[dest] = mm[h] + (a != c ? 1 : 0);
          }
          ++dest;
        }
      }
      base += __popc(b0) + 2 * __popc(b1) + 4 * __popc(b2);
    }
  }
  // slots past the kept children are zeroed in all five fields
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int s = lane + 32 * h;
    if (s < n_slots && s >= base) {
      pool.lo[s] = pool.hi[s] = pool.rlo[s] = pool.rhi[s] = pool.mm[s] = 0;
    }
  }
  __syncwarp();
  return base;
}

__global__ void __launch_bounds__(kWarps * 32)
    staircase_kernel(const StairArgs a, const int* fwd_blocks, const int* fwd_C, int fwd_primary,
                     const int* rev_blocks, const int* rev_C, int rev_primary) {
  __shared__ Pool pools[kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t pool_id = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (pool_id >= static_cast<int64_t>(a.P) * a.B) return;  // whole warps only
  Pool& pool = pools[warp];
  const gwa::FMTable fwd = gwa::load_table(fwd_blocks, fwd_C, fwd_primary);
  const gwa::FMTable rev = gwa::load_table(rev_blocks, rev_C, rev_primary);
  const int p = static_cast<int>(pool_id / a.B), b = static_cast<int>(pool_id % a.B);
  const int len = __ldg(a.lengths + b);
  const int s_p = len * p / a.P, e_p = len * (p + 1) / a.P;
  const int* read = a.reads + static_cast<int64_t>(b) * a.L;

  // ---- spine: piece p built backward (every lane computes it alike)
  gwa::BiIv spine{0, a.n + 1, 0, a.n + 1};
  for (int t = 0; t < a.spine_steps; ++t) {
    const int j = e_p - 1 - t;
    if (j < s_p || spine.hi <= spine.lo) break;  // an empty spine stays empty
    spine = gwa::extend_backward(fwd, spine, gwa::code_at(read, a.L, j));
  }
  for (int s = lane; s < a.n_slots; s += 32) {
    const bool first = s == 0;
    pool.lo[s] = first ? spine.lo : 0;
    pool.hi[s] = first ? spine.hi : 0;
    pool.rlo[s] = first ? spine.rlo : 0;
    pool.rhi[s] = first ? spine.rhi : 0;
    pool.mm[s] = 0;
  }
  __syncwarp();
  bool overflow = false;

  // ---- forward staircase through the pieces after p
  bool empty = spine.hi <= spine.lo;
  for (int t = 0; t < a.fwd_steps && !empty; ++t) {
    const int j = e_p + t;
    if (j >= len) break;
    int piece_of_j = -1;
    for (int i = 0; i <= a.P; ++i) piece_of_j += (len * i / a.P <= j) ? 1 : 0;
    const int live = expand_step(pool, fwd, rev, true, a.n_slots, gwa::code_at(read, a.L, j),
                                 piece_of_j - p, a.narrow_left);
    overflow |= live > a.n_slots;
    empty = live == 0;
  }

  // ---- left narrowing through the pieces before p, budget k
  if (a.narrow_left) {
    for (int t = 0; t < a.bwd_steps && !empty; ++t) {
      const int j = s_p - 1 - t;
      if (j < 0) break;
      const int live = expand_step(pool, fwd, rev, false, a.n_slots,
                                   gwa::code_at(read, a.L, j), a.k, true);
      overflow |= live > a.n_slots;
      empty = live == 0;
    }
  }

  // ---- the first `keep` live slots, in slot order
  int* out_lo = a.out_lo + pool_id * a.keep;
  int* out_hi = a.out_hi + pool_id * a.keep;
  int base = 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int s = lane + 32 * h;
    const bool live = s < a.n_slots && pool.hi[s] > pool.lo[s];
    const unsigned ballot = __ballot_sync(kAll, live);
    const int dest = base + __popc(ballot & gwa::lanes_below());
    if (live && dest < a.keep) {
      out_lo[dest] = pool.lo[s];
      out_hi[dest] = pool.hi[s];
    }
    base += __popc(ballot);
  }
  for (int i = lane; i < a.keep; i += 32) {
    if (i >= base) out_lo[i] = out_hi[i] = 0;
  }
  if (lane == 0) a.overflow[pool_id] = (overflow || base > a.keep) ? 1 : 0;
}

}  // namespace

// reads (B, L), lengths (B,), the forward and reverse tables' blocks
// (nb + 1, 12, 16-byte aligned) and C (5,): int32; out_lo / out_hi
// (P, B, keep) int32, overflow (P, B) bytes.
extern "C" int gwa_staircase(const void* reads, const void* lengths, int B, int L, int P, int k,
                             int n_slots, int keep, int spine_steps, int fwd_steps, int bwd_steps,
                             int narrow_left, const void* fwd_blocks, const void* fwd_C,
                             int fwd_primary, const void* rev_blocks, const void* rev_C,
                             int rev_primary, int n, void* out_lo, void* out_hi, void* overflow,
                             void* stream) {
  if (B < 0 || L < 0 || P < 1 || P > kMaxPieces || n_slots < 1 || n_slots > kMaxSlots ||
      keep < 0)
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
  const unsigned grid = static_cast<unsigned>((pools + kWarps - 1) / kWarps);
  staircase_kernel<<<grid, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<const int*>(fwd_blocks), static_cast<const int*>(fwd_C), fwd_primary,
      static_cast<const int*>(rev_blocks), static_cast<const int*>(rev_C), rev_primary);
  return static_cast<int>(cudaGetLastError());
}
