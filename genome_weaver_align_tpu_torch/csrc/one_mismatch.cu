// One-mismatch bidirectional FM search (acceptance config 2) on Hopper
// (sm_90a): one warp a read, both cases of the search in one launch.
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
//           slots is extended by read[j] (dead slots too: their stale
//           intervals are part of the output), the slots are compacted
//           stably (live first, then dead, each in slot order), the spine
//           takes an all-4 extension and keeps child read[j], and the three
//           other children that are live are spawned, in code order, into
//           slots count, count + 1, ...; a live spawn past slot S - 1 sets
//           overflow;
//   case B  the mirror: the spine is read[mid, len) built backward, then
//           backward steps at j = mid - 1 - t while j >= 0; only its
//           branches are output.
//
// An inactive read is frozen (its compaction of an already packed pool is
// the identity), and activity never returns within a case, so the warp
// leaves the case at its first inactive step.  `steps` is the plain
// version's min(max_len or L, (L + 1) / 2).
//
// What bounds it: latency and the rows it fetches.  A step waits on the
// rows its previous step chose, 2 a branch slot and 2 for the spine, all
// requested before any is counted.  Only live slots need their rows (96
// bytes a step, as the spine); the kernel fetches the dead slots' rows too,
// because their stale intervals are part of the output, and that work is
// above the bound, which counts live extensions only.  Lane l holds slots
// l and l + 32; the branches live in shared memory between steps, and
// compaction is four warp ballots.
//
// Entry: gwa_one_mismatch, a plain C function bound with ctypes; it launches
// on the caller's stream, does not synchronise, allocates nothing, and
// returns the launch's CUDA error code.

#include <cuda_runtime.h>

#include <cstdint>

#include "fm_occ.cuh"

namespace {

constexpr int kWarps = 4;  // reads a block
constexpr int kMaxSlots = 64;
constexpr unsigned kAll = 0xFFFFFFFFu;

struct MMArgs {
  const int* reads;    // (B, L) int32 codes 0..3
  const int* lengths;  // (B,)
  int* cand_lo;        // (B, 2 S + 1)
  int* cand_hi;
  unsigned char* overflow;  // (B,) bool
  int B, L, S, steps, n;
};

struct Branches {
  int lo[kMaxSlots], hi[kMaxSlots], rlo[kMaxSlots], rhi[kMaxSlots];
};

// Child c of an all-4 extension, as a synchronized interval.
__device__ __forceinline__ gwa::BiIv child(const gwa::Children& m, bool forward, int c) {
  return forward ? gwa::BiIv{gwa::pick4(m.olo, c), gwa::pick4(m.ohi, c), gwa::pick4(m.mlo, c),
                             gwa::pick4(m.mhi, c)}
                 : gwa::BiIv{gwa::pick4(m.mlo, c), gwa::pick4(m.mhi, c), gwa::pick4(m.olo, c),
                             gwa::pick4(m.ohi, c)};
}

// The rows of v's character update: on the reverse table going forward,
// on the forward table going backward.
__device__ __forceinline__ void load_rows(const gwa::FMTable& tab, bool forward,
                                          const gwa::BiIv& v, gwa::FusedRow& a,
                                          gwa::FusedRow& b) {
  a = gwa::load_row(tab, forward ? v.rlo : v.lo);
  b = gwa::load_row(tab, forward ? v.rhi : v.hi);
}

__device__ __forceinline__ void all4_from_rows(const gwa::FMTable& tab, bool forward,
                                               const gwa::FusedRow& a, const gwa::FusedRow& b,
                                               const gwa::BiIv& v, gwa::Children& m) {
  if (forward) {
    gwa::children_from_rows(tab, a, b, v.rlo, v.rhi, v.lo, m);
  } else {
    gwa::children_from_rows(tab, a, b, v.lo, v.hi, v.rlo, m);
  }
}

__device__ __forceinline__ void store(Branches& br, int s, const gwa::BiIv& v) {
  br.lo[s] = v.lo;
  br.hi[s] = v.hi;
  br.rlo[s] = v.rlo;
  br.rhi[s] = v.rhi;
}

// One case: builds its spine, runs its steps, leaves the branches in `br`;
// returns the overflow flag and the final spine.
__device__ bool search_case(Branches& br, gwa::BiIv& spine, const gwa::FMTable& fwd,
                            const gwa::FMTable& rev, bool forward, const int* read, int L,
                            int len, int mid, int S, int steps, int n) {
  const int lane = threadIdx.x & 31;
  const unsigned below = gwa::lanes_below();
  const gwa::FMTable& tab = forward ? rev : fwd;
  const int first = forward ? 0 : mid, last = forward ? mid : len;
  spine = gwa::BiIv{0, n + 1, 0, n + 1};
  for (int t = 0; t < steps; ++t) {  // an empty spine still moves: case A outputs it
    const int j = last - 1 - t;
    if (j < first) break;
    spine = gwa::extend_backward(fwd, spine, gwa::code_at(read, L, j));
  }
  for (int s = lane; s < S; s += 32) store(br, s, gwa::BiIv{0, 0, 0, 0});
  __syncwarp();
  bool overflow = false;
  for (int t = 0; t < steps; ++t) {
    const int j = forward ? mid + t : mid - 1 - t;
    if (forward ? j >= len : j < 0) break;
    const int c = gwa::code_at(read, L, j);
    gwa::BiIv v[2];
    bool valid[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int s = lane + 32 * h;
      valid[h] = s < S;
      v[h] = valid[h] ? gwa::BiIv{br.lo[s], br.hi[s], br.rlo[s], br.rhi[s]}
                      : gwa::BiIv{0, 0, 0, 0};
    }
    gwa::FusedRow ra[2], rb[2], sa, sb;  // every row of the step requested first
#pragma unroll
    for (int h = 0; h < 2; ++h) load_rows(tab, forward, v[h], ra[h], rb[h]);
    load_rows(tab, forward, spine, sa, sb);
    bool alive[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      gwa::Children m;
      all4_from_rows(tab, forward, ra[h], rb[h], v[h], m);
      v[h] = child(m, forward, c);
      alive[h] = valid[h] && v[h].hi > v[h].lo;
    }
    gwa::Children sm;
    all4_from_rows(tab, forward, sa, sb, spine, sm);
    __syncwarp();  // every lane has read its slots before any is rewritten
    // stable partition: live slots first, then dead ones, each in slot order
    const unsigned l0 = __ballot_sync(kAll, alive[0]), l1 = __ballot_sync(kAll, alive[1]);
    const unsigned d0 = __ballot_sync(kAll, valid[0] && !alive[0]),
                   d1 = __ballot_sync(kAll, valid[1] && !alive[1]);
    const int count = __popc(l0) + __popc(l1);
    if (valid[0])
      store(br, alive[0] ? __popc(l0 & below) : count + __popc(d0 & below), v[0]);
    if (valid[1])
      store(br, alive[1] ? __popc(l0) + __popc(l1 & below)
                         : count + __popc(d0) + __popc(d1 & below),
            v[1]);
    __syncwarp();
    // the three wrong-character children of the spine, in code order
    int spawned = 0;
#pragma unroll
    for (int u = 0; u < 3; ++u) {
      const int wc = u + (u >= c ? 1 : 0);
      const gwa::BiIv w = child(sm, forward, wc);
      if (w.hi > w.lo) {
        const int slot = count + spawned;
        if (slot >= S) {
          overflow = true;
        } else if (lane == 0) {
          store(br, slot, w);
        }
        ++spawned;
      }
    }
    spine = child(sm, forward, c);
    __syncwarp();
  }
  return overflow;
}

__global__ void __launch_bounds__(kWarps * 32)
    one_mismatch_kernel(const MMArgs a, const int* fwd_blocks, const int* fwd_C, int fwd_primary,
                        const int* rev_blocks, const int* rev_C, int rev_primary) {
  __shared__ Branches branches[kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (b >= a.B) return;  // whole warps only
  Branches& br = branches[warp];
  const gwa::FMTable fwd = gwa::load_table(fwd_blocks, fwd_C, fwd_primary);
  const gwa::FMTable rev = gwa::load_table(rev_blocks, rev_C, rev_primary);
  const int len = __ldg(a.lengths + b);
  const int mid = len / 2;
  const int* read = a.reads + b * a.L;
  const int width = 2 * a.S + 1;
  int* out_lo = a.cand_lo + b * width;
  int* out_hi = a.cand_hi + b * width;

  gwa::BiIv spine;
  bool overflow = search_case(br, spine, fwd, rev, true, read, a.L, len, mid, a.S, a.steps, a.n);
  if (lane == 0) {
    out_lo[0] = spine.lo;
    out_hi[0] = spine.hi;
  }
  for (int s = lane; s < a.S; s += 32) {
    out_lo[1 + s] = br.lo[s];
    out_hi[1 + s] = br.hi[s];
  }
  __syncwarp();  // case B reuses the branch slots
  overflow |= search_case(br, spine, fwd, rev, false, read, a.L, len, mid, a.S, a.steps, a.n);
  for (int s = lane; s < a.S; s += 32) {
    out_lo[1 + a.S + s] = br.lo[s];
    out_hi[1 + a.S + s] = br.hi[s];
  }
  if (lane == 0) a.overflow[b] = overflow ? 1 : 0;
}

}  // namespace

// reads (B, L), lengths (B,), the forward and reverse tables' blocks
// (nb + 1, 12, 16-byte aligned) and C (5,): int32; cand_lo / cand_hi
// (B, 2 S + 1) int32, overflow (B,) bytes.
extern "C" int gwa_one_mismatch(const void* reads, const void* lengths, int B, int L, int S,
                                int steps, const void* fwd_blocks, const void* fwd_C,
                                int fwd_primary, const void* rev_blocks, const void* rev_C,
                                int rev_primary, int n, void* cand_lo, void* cand_hi,
                                void* overflow, void* stream) {
  if (B < 0 || L < 0 || S < 1 || S > kMaxSlots) return static_cast<int>(cudaErrorInvalidValue);
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
  const unsigned grid = static_cast<unsigned>((static_cast<int64_t>(B) + kWarps - 1) / kWarps);
  one_mismatch_kernel<<<grid, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<const int*>(fwd_blocks), static_cast<const int*>(fwd_C), fwd_primary,
      static_cast<const int*>(rev_blocks), static_cast<const int*>(rev_C), rev_primary);
  return static_cast<int>(cudaGetLastError());
}
