// One-mismatch bidirectional FM search (acceptance config 2) on Hopper
// (sm_90a): one group of G lanes a (read, case), both cases in one launch.
//
// Replaces the JAX package's device loops of
// genome_weaver_align_tpu/models/one_mismatch.py: the spines (:101), case A
// (:127) and case B (:150), with their _compact (:40) and _spawn (:48), each
// a lax.fori_loop under jit, and computes exactly the port's plain version,
// models/one_mismatch.py one_mismatch_candidates_plain.  A read of length
// len splits at mid = len / 2:
//
//   case A  the spine is read[0, mid) built backward; then `steps` forward
//           steps at j = mid + t while j < len: every one of the S branch
//           slots is extended by read[j], the slots are compacted stably
//           (live first, then dead, each in slot order), the spine takes an
//           all-4 extension and keeps child read[j], and the three other
//           children that are live are spawned, in code order, into slots
//           count, count + 1, ...; a live spawn past slot S - 1 sets
//           overflow;
//   case B  the mirror: the spine is read[mid, len) built backward, then
//           backward steps at j = mid - 1 - t while j >= 0; only its
//           branches are output.
//
// The two cases share nothing but the read and the overflow flag, so each
// is a group of its own (grid.y picks the case): their dependent chains run
// side by side.  The output keeps every slot's interval, dead slots
// included, so the kernel rests on what a dead slot does:
//
//   - a dead slot has lo == hi, and rlo == rhi (a synchronized interval has
//     one width on both tables): slots start at (0, 0, 0, 0), spawns are
//     live, and a child with no occurrence has hi == lo;
//   - the pool is packed: live slots [0, n_live), then dead ones.  The
//     stable partition moves a slot that was already dead nowhere, so only
//     the live prefix is reordered, and a spawn overwrites a dead slot;
//   - case A, forward: the update reads the reverse table at rlo == rhi,
//     so no code occurs, the `$` offset is 0, and (lo, hi) stays: a dead
//     slot takes no row and no work.  Its rlo and rhi would move; nothing
//     reads them once it is dead (only lo and hi are output, and a spawn
//     rewrites all four), so the kernel leaves them stale;
//   - case B, backward: a dead slot's lo = hi becomes C[c] + occ(c, lo):
//     one row and one count, the same for every dead slot of that lo.
//
// So the work items of a step are: the spine (item 0, group lane 0; none
// once it is empty), the live slots, and in case B each distinct dead lo
// (a "chain").  The dead slots are the ones that died, [n_live, hw), and
// the never-spawned tail [hw, S), which is one chain kept in slot S - 1 (hw:
// one past the highest slot ever spawned into).  The distinct chains are
// found with __match_any_sync over chunks of G dead slots, checked against
// the chains of earlier chunks; each dead slot parks its chain's index in
// its hi (equal to its lo) until the step writes the new lo back.  The
// group takes its items G a pass (a pass reads all its operands before it
// writes: a live child lands at or below its parent's slot), places the live
// children by ballot and prefix popcount, stages the newly dead in `aux`
// until the live count is known, and group lane 0 spawns.  Case A leaves the
// read once its spine is empty and no slot lives: nothing moves after that.
//
// What bounds it: latency, and instruction issue where the reads are
// many.  A step waits on the rows its previous step chose: 2 for the spine
// and each live slot, 1 for each chain in case B, all requested before any
// is counted; a group's chain is `steps` spine builds and `steps` search
// steps, at about 0.46 us each.  Several groups a warp (G lanes each: the
// binding takes 4, and 2 once the launch outgrows the card; more where a
// warp's groups outgrow a block's shared memory) keep the card's issue
// slots on live work, not on dead slots.
// The pool lives in shared memory, sized by S: lo, hi and rlo of each slot
// (rhi = rlo + hi - lo), `aux` (S ints: the chains, then the newly dead; a
// step has at most hw + 1 of them, hw + 1 <= S when the tail exists) and
// the spine's children (12 ints); at S = 48 and 2 lanes a case, shared
// memory holds 4 blocks of 64 groups an SM.  Nothing in the search ties S
// to a size: a group takes more lanes where a warp's groups outgrow a
// block's shared memory (fit_lanes), and past 14,000 slots at a warp a
// case the pools live in global scratch (the Global kernel).
//
// Entry: gwa_one_mismatch, a plain C function bound with ctypes; it launches
// on the caller's stream, does not synchronise, allocates nothing, and
// returns the launch's CUDA error code.  `overflow` must hold zeros: a case
// writes 1 where it overflows.

#include <cuda_runtime.h>

#include <cstdint>

#include "fm_occ.cuh"

namespace {

constexpr int kThreads = 128;  // a block: 4 warps, fewer where shared memory runs short
constexpr unsigned kAll = 0xFFFFFFFFu;

struct MMArgs {
  const int* reads;    // (B, L) int32 codes 0..3
  const int* lengths;  // (B,)
  int* cand_lo;        // (B, 2 S + 1)
  int* cand_hi;
  unsigned char* overflow;  // (B,) bool, zeros on entry
  int* scratch;             // where a warp's groups outgrow shared memory: group_ints(S)
                            // ints a (read, case), else null
  int B, L, S, steps, n, lanes;
};

// Shared ints a group: lo, hi, rlo, aux (S each), the spine's children (12).
__host__ __device__ constexpr int group_ints(int S) { return 4 * S + 12; }

// Child c of an all-4 extension, as a synchronized interval.
__device__ __forceinline__ gwa::BiIv child(const gwa::Children& m, bool forward, int c) {
  return forward ? gwa::BiIv{gwa::pick4(m.olo, c), gwa::pick4(m.ohi, c), gwa::pick4(m.mlo, c),
                             gwa::pick4(m.mhi, c)}
                 : gwa::BiIv{gwa::pick4(m.mlo, c), gwa::pick4(m.mhi, c), gwa::pick4(m.olo, c),
                             gwa::pick4(m.ohi, c)};
}

// One (read, case) group: builds its spine, runs its steps, writes its
// slots (and case A its spine) and its overflow.  `rev` is read in case A.
// Global: the group's pool in a.scratch, not in shared memory.
template <bool kForward, bool Global>
__device__ __forceinline__ void search_case(const MMArgs& a, const gwa::FMTable& fwd,
                                            const gwa::FMTable& rev) {
  constexpr bool forward = kForward;
  extern __shared__ int smem[];
  const int lane = threadIdx.x & 31, G = a.lanes, gl = lane & (G - 1), gbase = lane - gl;
  const unsigned gmask = G == 32 ? kAll : ((1u << G) - 1u) << gbase;
  const unsigned below = gwa::lanes_below() & gmask;  // this group's lanes below this one
  const int group = threadIdx.x / G;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * (blockDim.x / G) + group;
  const bool valid = b < a.B;  // a group past the batch idles through the collectives
  const int S = a.S;
  int* lo = smem + group * group_ints(S);
  if constexpr (Global) {
    lo = a.scratch + ((valid ? b : 0) * 2 + (kForward ? 0 : 1)) * group_ints(S);
  }
  int* hi = lo + S;
  int* rlo = hi + S;
  int* aux = rlo + S;
  int* sch = aux + S;  // the spine's children: (lo, hi, rlo) by code
  const gwa::FMTable& tab = forward ? rev : fwd;  // the table of a step's character update
  const int len = valid ? __ldg(a.lengths + b) : 0;
  const int mid = len / 2;
  const int* read = a.reads + (valid ? b : 0) * a.L;

  // ---- the spine, built backward by group lane 0 (case B's is never
  // output, so it stops once empty; case A's moves on: it is output)
  gwa::BiIv spine{0, a.n + 1, 0, a.n + 1};
  if (gl == 0) {
    const int first = forward ? 0 : mid, last = forward ? mid : len;
    for (int t = 0; t < a.steps; ++t) {
      const int j = last - 1 - t;
      if (j < first || (!forward && spine.hi <= spine.lo)) break;
      spine = gwa::extend_backward(fwd, spine, gwa::code_at(read, a.L, j));
    }
    lo[S - 1] = hi[S - 1] = 0;  // the never-spawned tail
  }
  __syncwarp();

  int n_live = 0, hw = 0;  // the same in every lane of a group
  bool overflow = false;   // group lane 0's
  for (int t = 0; t < a.steps; ++t) {
    const int j = forward ? mid + t : mid - 1 - t;
    const bool spine_live = __shfl_sync(kAll, spine.hi > spine.lo ? 1 : 0, gbase) != 0;
    const bool act = (forward ? j < len : j >= 0) && (!forward || spine_live || n_live > 0);
    if (!__any_sync(kAll, act)) break;
    const int c = act ? gwa::code_at(read, a.L, j) : 0;

    // ---- case B: the distinct dead chains, in chunks of G dead entries
    const int n_died = hw - n_live;
    const int n_ent = !forward && act ? n_died + (hw < S ? 1 : 0) : 0;
    int D = 0;
    for (int e0 = 0; __any_sync(kAll, e0 < n_ent); e0 += G) {
      const int e = e0 + gl;
      const bool has = e < n_ent;
      const int slot = e < n_died ? n_live + e : S - 1;
      const int v = has ? lo[slot] : 0;
      int idx = -1;
      for (int i = 0; has && i < D; ++i) idx = aux[i] == v ? i : idx;  // an earlier chunk's
      const bool fresh = has && idx < 0;
      // lanes with nothing new carry a key no other lane has
      const unsigned long long key =
          fresh ? (static_cast<unsigned long long>(gbase) << 32) | static_cast<unsigned>(v)
                : (0xFFFFFFFFull << 32) | static_cast<unsigned>(lane);
      const int leader = __ffs(__match_any_sync(kAll, key)) - 1;
      const bool lead = fresh && leader == lane;
      const unsigned leaders = __ballot_sync(kAll, lead) & gmask;
      if (lead) {
        idx = D + __popc(leaders & below);
        aux[idx] = v;
      }
      const int led = __shfl_sync(kAll, idx, leader);
      if (has) hi[slot] = fresh ? led : idx;
      D += __popc(leaders);
      __syncwarp();
    }

    // ---- the work items, G a pass: spine, live slots, chains
    const int n_items = act ? 1 + n_live + D : 0;
    int count = 0, dead = 0;
    for (int i0 = 0; __any_sync(kAll, i0 < n_items); i0 += G) {
      const int i = i0 + gl;
      const bool is_spine = i == 0 && act && spine_live;
      const bool is_slot = i >= 1 && i <= n_live && i < n_items;
      const bool is_chain = i > n_live && i < n_items;
      gwa::BiIv v = spine;
      if (is_slot) {
        const int s = i - 1;
        v = gwa::BiIv{lo[s], hi[s], rlo[s], rlo[s] + hi[s] - lo[s]};
      }
      const int x = is_chain ? aux[i - 1 - n_live] : 0;
      const bool all4 = is_spine || is_slot;
      gwa::FusedRow ra, rb;  // both rows requested before either is counted
      if (all4 || is_chain) ra = gwa::load_row(tab, all4 ? (forward ? v.rlo : v.lo) : x);
      if (all4) rb = gwa::load_row(tab, forward ? v.rhi : v.hi);
      __syncwarp();  // every operand of the pass is read before anything is written
      gwa::BiIv w{0, 0, 0, 0};
      if (all4) {
        gwa::Children m;
        if (forward) {
          gwa::children_from_rows(tab, ra, rb, v.rlo, v.rhi, v.lo, m);
        } else {
          gwa::children_from_rows(tab, ra, rb, v.lo, v.hi, v.rlo, m);
        }
        if (is_spine) {
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const gwa::BiIv ch = child(m, forward, u);
            sch[3 * u] = ch.lo;
            sch[3 * u + 1] = ch.hi;
            sch[3 * u + 2] = ch.rlo;
          }
        }
        w = child(m, forward, c);
      }
      if (is_chain) aux[i - 1 - n_live] = gwa::pick4(tab.C, c) + gwa::occ1(ra, c);
      const bool alive = is_slot && w.hi > w.lo, died = is_slot && !alive;
      const unsigned ab = __ballot_sync(kAll, alive) & gmask;
      const unsigned db = __ballot_sync(kAll, died) & gmask;
      if (alive) {
        const int p = count + __popc(ab & below);
        lo[p] = w.lo;
        hi[p] = w.hi;
        rlo[p] = w.rlo;
      }
      if (died) aux[D + dead + __popc(db & below)] = w.lo;  // hi == lo
      count += __popc(ab);
      dead += __popc(db);
      __syncwarp();
    }
    // the newly dead after the live slots; case B's dead slots take their
    // chain's new lo (slots that died stay where they are)
    for (int e = gl; e < dead; e += G) lo[count + e] = hi[count + e] = aux[D + e];
    for (int e = gl; e < n_ent; e += G) {
      const int s = e < n_died ? n_live + e : S - 1;
      lo[s] = hi[s] = aux[hi[s]];
    }
    __syncwarp();
    // the spine's three wrong-code children that are live, in code order
    int spawned = 0;
    if (gl == 0 && act && spine_live) {
#pragma unroll
      for (int u = 0; u < 3; ++u) {
        const int wc = u + (u >= c ? 1 : 0);
        const int wlo = sch[3 * wc], whi = sch[3 * wc + 1];
        if (whi > wlo) {
          const int slot = count + spawned;
          if (slot >= S) {
            overflow = true;
          } else {
            lo[slot] = wlo;
            hi[slot] = whi;
            rlo[slot] = sch[3 * wc + 2];
          }
          ++spawned;
        }
      }
      spine = gwa::BiIv{sch[3 * c], sch[3 * c + 1], sch[3 * c + 2],
                        sch[3 * c + 2] + sch[3 * c + 1] - sch[3 * c]};
    }
    spawned = __shfl_sync(kAll, spawned, gbase);
    if (act) {
      n_live = min(S, count + spawned);
      hw = max(hw, n_live);
    }
    __syncwarp();
  }

  if (!valid) return;
  const int width = 2 * S + 1;
  int* out_lo = a.cand_lo + b * width + (forward ? 1 : 1 + S);
  int* out_hi = a.cand_hi + b * width + (forward ? 1 : 1 + S);
  for (int s = gl; s < S; s += G) {
    const int src = s < hw ? s : S - 1;
    out_lo[s] = lo[src];
    out_hi[s] = hi[src];
  }
  if (gl == 0) {
    if (forward) {
      a.cand_lo[b * width] = spine.lo;
      a.cand_hi[b * width] = spine.hi;
    }
    if (overflow) a.overflow[b] = 1;
  }
}

// 6 blocks an SM cap the registers at 80 (at 2 lanes a case shared memory
// holds 4); phase [2] of chip_smoke.py prints what ptxas used and spilled.
// Global: the pools in scratch (a warp's groups outgrow shared memory).
template <bool Global>
__global__ void __launch_bounds__(kThreads, 6)
    one_mismatch_kernel(const MMArgs a, const int* fwd_blocks, const int* fwd_C, int fwd_primary,
                        const int* rev_blocks, const int* rev_C, int rev_primary) {
  const gwa::FMTable fwd = gwa::load_table(fwd_blocks, fwd_C, fwd_primary);
  const gwa::FMTable rev = gwa::load_table(rev_blocks, rev_C, rev_primary);
  if (blockIdx.y == 0) {  // grid.y: the case
    search_case<true, Global>(a, fwd, rev);
  } else {
    search_case<false, Global>(a, fwd, rev);
  }
}

// The lanes a (read, case) takes: `lanes`, doubled while a warp's groups
// outgrow a block's shared memory, up to 32 (threads 0 there: the pools go
// to scratch); the block's threads and shared memory in threads and smem.
int fit_lanes(int lanes, int S, size_t& smem, int& threads) {
  for (;; lanes *= 2) {
    threads = gwa::block_threads(kThreads, lanes, group_ints(S) * sizeof(int), smem);
    if (threads > 0 || lanes >= 32) return lanes;
  }
}

}  // namespace

// Scratch ints a launch over B reads of S slots at `lanes` lanes a case
// needs (fit_lanes): 0 where a warp's groups fit a block's shared memory at
// some lanes up to 32, else group_ints(S) a (read, case).
extern "C" int64_t gwa_one_mismatch_scratch_ints(int lanes, int S, int64_t B) {
  size_t smem = 0;
  int threads = 0;
  if (lanes < 1 || lanes > 32 || S < 1) return 0;
  fit_lanes(lanes, S, smem, threads);
  return threads > 0 ? 0 : 2 * B * group_ints(S);
}

// reads (B, L), lengths (B,), the forward and reverse tables' blocks
// (nb + 1, 12, 16-byte aligned) and C (5,): int32; cand_lo / cand_hi
// (B, 2 S + 1) int32, overflow (B,) bytes, zeros on entry; lanes a group:
// a power of two, 1..32 (doubled here while a warp's groups outgrow shared
// memory: fit_lanes); scratch: gwa_one_mismatch_scratch_ints ints (null
// where that is 0).
extern "C" int gwa_one_mismatch(const void* reads, const void* lengths, int B, int L, int S,
                                int steps, const void* fwd_blocks, const void* fwd_C,
                                int fwd_primary, const void* rev_blocks, const void* rev_C,
                                int rev_primary, int n, void* cand_lo, void* cand_hi,
                                void* overflow, int lanes, void* scratch, int64_t scratch_ints,
                                void* stream) {
  if (B < 0 || L < 0 || S < 1 || lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  MMArgs a{};
  a.reads = static_cast<const int*>(reads);
  a.lengths = static_cast<const int*>(lengths);
  a.cand_lo = static_cast<int*>(cand_lo);
  a.cand_hi = static_cast<int*>(cand_hi);
  a.overflow = static_cast<unsigned char*>(overflow);
  a.B = B;
  a.L = L;
  a.S = S;
  a.steps = steps;
  a.n = n;
  size_t smem = 0;
  int threads = 0;
  a.lanes = lanes = fit_lanes(lanes, S, smem, threads);
  auto kernel = one_mismatch_kernel<false>;
  if (threads == 0) {  // a warp's group outgrows shared memory: the pools live in scratch
    if (scratch == nullptr || scratch_ints < 2 * static_cast<int64_t>(B) * group_ints(S))
      return static_cast<int>(cudaErrorInvalidValue);
    a.scratch = static_cast<int*>(scratch);
    threads = kThreads;
    smem = 0;
    kernel = one_mismatch_kernel<true>;
  }
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int groups = threads / lanes;
  const dim3 grid(static_cast<unsigned>((static_cast<int64_t>(B) + groups - 1) / groups), 2);
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<const int*>(fwd_blocks), static_cast<const int*>(fwd_C), fwd_primary,
      static_cast<const int*>(rev_blocks), static_cast<const int*>(rev_C), rev_primary);
  return static_cast<int>(cudaGetLastError());
}
