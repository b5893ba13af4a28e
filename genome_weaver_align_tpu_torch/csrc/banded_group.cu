// The banded DP's group kernel (k = 17..127) on Hopper (sm_90a): a group of
// G threads a candidate lane, the band split over them; the same two
// entries as banded_dp.cu (the text entry, windows gathered from the 2-bit
// text in the kernel, and the windows entry), the same outputs (dist and
// end_b equal to genome_weaver_align_tpu_torch/ops/dp.py::banded_edit_distance
// on every lane), the same staging of read rows (stage_rows.cuh).  Its own
// source so that nvcc builds it beside banded_dp.cu.
//
// Replaces (with banded_dp.cu) the Pallas TPU kernel
// genome_weaver_align_tpu/ops/dp_pallas.py::_kernel.
//
// Entry: gwa_banded_group, a plain C function bound with ctypes (the binding
// calls it for k = 17..kMaxGroupK, gwa_banded_dp otherwise).  It launches
// on the caller's stream, does not synchronise, allocates nothing, and
// returns the launch's CUDA error code.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>
#include <utility>

#include "banded_dp.cuh"

namespace {

using namespace gwa::banded;

// ---- the group kernel (k = 17..kMaxGroupK)
//
// A lane is a group of G = 8, 16 or 32 threads (group_for), N = ceil((4k +
// 1) / G) band slots a thread (9..16, a template: the band padded by at
// most G - 1 slots, not to a power of two), slot b of the band in
// register b - base of thread j, base = j N - (G N - 4k - 1): the pads
// lie at the band's bottom, the top slot is the last thread's last
// register.  Window codes and read codes are compared as unsigned bytes
// (an off-text or window byte >= 4 is 256, a negative window byte its
// unsigned value: it matches only an equal read byte, as in the plain
// version), so x = wc ^ rc is 0 exactly on a match and below 512.  A
// row, for each thread:
//   - its top slot's insertion term D_old[b + 1] is the next thread's
//     slot 0 (one shuffle, issued first; INF past the band);
//   - every slot in order: D[s] = min(min(left, D_old[s], up) + 1,
//     D_old[s] + x), left the slot below's new value (none below the
//     thread's first slot): DPX __vimin3_s32 and __viaddmin_s32, 4
//     integer instructions a cell, the one-thread design's;
//   - the window deletion across threads: D_new[b] = min(local, c + b),
//     c the exclusive prefix min over the group's lower threads of (top
//     slot's value - its slot), log2(G) shuffles; one __viaddmin_s32 a
//     cell;
//   - no move: the body runs N rows unrolled and the window codes rotate
//     by register index (slot s of row i is code register (s + i) % N);
//     each row's new top code is the code register that slot 0 left,
//     decoded from the packed text 16 bases a 32-bit word pair, a block
//     of N rows at a time (TextBlocks); rows past the last whole block run
//     one at a time with the codes moved.
// No row past row 0 checks the window's bounds, and the pads are not
// reset: what the plain version computes there does not reach the outputs.
//   - A window position below 0 (a slot below the diagonal in the first
//     rows) reads only positions below 0 and pads past row 0 (row 0 sets
//     them to INF: the row before holds 0 at slot k, position -1): its
//     value stays at or above INF, where the plain version has INF; a
//     valid cell (position in [0, W)) always has a finite input, below
//     INF (W >= 1: the position's cell a row up, or the diagonal's), so
//     the min never takes either.
//   - A position at or past W reads nothing a valid cell reads (a valid
//     cell reads its own position a row up and the position below), so it
//     reaches no output: the last row's candidates lie in [-1, W).
//   - A pad never matches (x | 1) and starts at 2^30: a path that leaves
//     the band through the pads and comes back costs at least one more
//     than the band's own diagonal between the same two cells.
//   - The outputs take min(D, INF) of each candidate, which is the plain
//     version's value at the candidates below position 0.
// W = 0 (no valid cell) takes the plain version's all-INF row at once.
// Lanes of a warp may have different lengths: each group runs its own rows
// (its shuffles name its lanes alone).

// The window codes of one text-entry lane, by window position.
struct TextBlocks {
  const uint32_t* text;
  int32_t last;  // nw - 1
  int64_t p0, n;

  __device__ __forceinline__ void init(const Args& a, int64_t q) {
    text = a.text;
    last = a.nw - 1;
    p0 = a.starts[q];
    n = a.n_text;
  }
  __device__ __forceinline__ uint32_t word(int64_t w) const {
    return __ldg(text + (w < 0 ? 0 : w > last ? last : w));
  }
  __device__ __forceinline__ int32_t at(int32_t pos) const {
    const int64_t p = p0 + pos;
    if (p < 0 || p >= n) return kNoMatch;
    return static_cast<int32_t>((word(p >> 4) >> (2 * (p & 15))) & 3u);
  }
  // Positions pos .. pos + N - 1 (N <= 16): one pair of words shifted
  // into place, 2 bits a code.
  template <int N>
  __device__ __forceinline__ void block(int32_t pos, int32_t (&nc)[N]) const {
    const int64_t p = p0 + pos;
    const uint32_t v =
        __funnelshift_r(word(p >> 4), word((p >> 4) + 1), static_cast<uint32_t>(2 * (p & 15)));
#pragma unroll
    for (int t = 0; t < N; ++t) nc[t] = static_cast<int32_t>((v >> (2 * t)) & 3u);
    if (p < 0 || p + N > n) {
#pragma unroll
      for (int t = 0; t < N; ++t) {
        if (p + t < 0 || p + t >= n) nc[t] = kNoMatch;
      }
    }
  }
};

// The window codes of one windows-entry lane, by window position: a byte
// below 4 as its unsigned value, else (and off the window) 256.
struct WindowBlocks {
  const int8_t* w;
  int32_t W;

  __device__ __forceinline__ void init(const Args& a, int64_t q) {
    w = a.windows + q * a.W;
    W = a.W;
  }
  __device__ __forceinline__ static int32_t code(int8_t c) {
    return c < 4 ? static_cast<int32_t>(static_cast<uint8_t>(c)) : kNoMatch;
  }
  __device__ __forceinline__ int32_t at(int32_t pos) const {
    return pos >= 0 && pos < W ? code(w[pos]) : kNoMatch;
  }
  template <int N>
  __device__ __forceinline__ void block(int32_t pos, int32_t (&nc)[N]) const {
    if (pos >= 0 && pos + N <= W) {
#pragma unroll
      for (int t = 0; t < N; ++t) nc[t] = code(w[pos + t]);
    } else {
#pragma unroll
      for (int t = 0; t < N; ++t) nc[t] = at(pos + t);
    }
  }
};

// A group lane's registers: N band slots of D, their window codes
// (rotated) and the pads' no-match bits.
template <int N>
struct GroupBand {
  int32_t D[N];
  int32_t wc[N];
  int32_t pm[N];  // 1 on a pad (slot below 0), else 0
};

// One row of the group at rotation R: read code rc (an unsigned byte), the
// new top code for the next row (into code register R, which slot 0
// leaves).
template <int N, int R>
__device__ __forceinline__ void group_row(GroupBand<N>& g, int32_t rc, int32_t code, int j,
                                          int G, unsigned mask, int32_t base) {
  int32_t up_top = __shfl_down_sync(mask, g.D[0], 1, G);  // the next thread's slot 0, row i-1
  if (j == G - 1) up_top = kInf;                            // past the band's top
#pragma unroll
  for (int s = 0; s < N; ++s) {
    const int32_t x = (g.wc[(s + R) % N] ^ rc) | g.pm[s];
    const int32_t up = s + 1 < N ? g.D[s + 1 < N ? s + 1 : s] : up_top;
    const int32_t dx = g.D[s] + x;
    if (s == 0) {
      g.D[0] = __viaddmin_s32(min(g.D[0], up), 1, dx);
    } else {
      g.D[s] = __viaddmin_s32(__vimin3_s32(g.D[s > 0 ? s - 1 : 0], g.D[s], up), 1, dx);
    }
  }
  // the exclusive prefix min over the group's lower threads of (top - its
  // slot): shfl_up leaves a lane below d its own value
  int32_t v = g.D[N - 1] - (base + N - 1);
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    if (d < G) v = min(v, __shfl_up_sync(mask, v, d, G));
  }
  const int32_t cin = __shfl_up_sync(mask, v, 1, G);
  const int32_t c0 = (j == 0 ? kBig : cin) + base;
#pragma unroll
  for (int s = 0; s < N; ++s) g.D[s] = __viaddmin_s32(c0, s, g.D[s]);
  g.wc[R] = code;
}

// Row i alone, the codes moved down a register after it (row 0, and the
// rows past the last block of N).
template <int N, class Codes>
__device__ __forceinline__ void group_row_moved(GroupBand<N>& g, const int8_t* rrow, int32_t i,
                                                const Codes& cd, int j, int G, unsigned mask,
                                                int32_t base, int32_t K) {
  group_row<N, 0>(g, static_cast<uint8_t>(rrow[i]), cd.at(i + base + N - K), j, G, mask, base);
  const int32_t top = g.wc[0];
#pragma unroll
  for (int s = 0; s < N - 1; ++s) g.wc[s] = g.wc[s + 1];
  g.wc[N - 1] = top;
}

template <int N, class Codes, int... R>
__device__ __forceinline__ void group_block(GroupBand<N>& g, const Codes& cd,
                                            const int8_t* rrow, int32_t i0, int j, int G,
                                            unsigned mask, int32_t base, int32_t K,
                                            std::integer_sequence<int, R...>) {
  int32_t nc[N];
  cd.template block<N>(i0 + base + N - K, nc);
  (group_row<N, R>(g, static_cast<uint8_t>(rrow[i0 + R]), nc[R], j, G, mask, base), ...);
}

template <int N, bool kText>
__global__ void __launch_bounds__(kThreads) banded_group_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = a.group;
  const int64_t gt = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t q = gt / G;
  const bool live = q < a.Q;
  int32_t r = 0;
  if (live) r = a.rid ? min(max(a.rid[q], 0), a.B - 1) : static_cast<int32_t>(q);
  const int8_t* rrow = a.stage ? gwa::stage_rows(a.reads, a.L, r, live, smem, G)
                               : a.reads + static_cast<int64_t>(r) * a.L;
  if (!live) return;  // the whole group; no later __syncthreads

  const int j = static_cast<int>(threadIdx.x) & (G - 1);
  const unsigned mask = G == 32 ? kFull : ((1u << G) - 1u) << ((threadIdx.x & 31) & ~(G - 1));
  const int32_t K = a.k, BAND = 4 * K + 1, W = a.W;
  const int32_t base = j * N - (G * N - BAND);  // band slot of register 0
  const int32_t len = a.lengths[r];
  const int32_t steps = min(len, a.L);
  typename std::conditional<kText, TextBlocks, WindowBlocks>::type cd;
  cd.init(a, q);

  GroupBand<N> g;
#pragma unroll
  for (int s = 0; s < N; ++s) {
    const int32_t b = base + s;
    g.D[s] = b < 0 ? kBig : (b >= K ? 0 : kInf);
    g.pm[s] = b < 0 ? 1 : 0;
    g.wc[s] = cd.at(b - K);  // row 0's slot s: window position b - k
  }
  if (W == 0) {  // no valid cell: every row sets the band to INF
    if (steps > 0) {
#pragma unroll
      for (int s = 0; s < N; ++s) g.D[s] = kInf;
    }
  } else if (steps > 0) {
    // row 0 alone: its slots below the diagonal read the row before's 0 at
    // slot k, where the plain version has INF
    group_row_moved<N>(g, rrow, 0, cd, j, G, mask, base, K);
#pragma unroll
    for (int s = 0; s < N; ++s) {
      if (base + s >= 0 && base + s < K) g.D[s] = kInf;
    }
    int32_t i = 1;
    for (; i + N <= steps; i += N)
      group_block<N>(g, cd, rrow, i, j, G, mask, base, K, std::make_integer_sequence<int, N>{});
    for (; i < steps; ++i) group_row_moved<N>(g, rrow, i, cd, j, G, mask, base, K);
  }

  int32_t best = kBig, best_b = BAND;
#pragma unroll
  for (int s = 0; s < N; ++s) {
    const int32_t b = base + s;
    const int32_t j_end = len + b - K;
    const int32_t df = (j_end >= 0 && j_end <= W) ? min(g.D[s], kInf) : kInf;
    if (b >= 0 && df < best) {
      best = df;
      best_b = b;
    }
  }
  write_best(a, q, j == 0, best, best_b, G, mask);
}

template <int N, bool kText>
int launch_group(const Args& a, cudaStream_t s) {
  return gwa::launch_staged<int8_t>(banded_group_kernel<N, kText>, a, a.group, 0, s);
}

template <bool kText>
int dispatch(Args a, cudaStream_t s) {
  a.group = group_for(a.k);
  switch ((4 * a.k + 1 + a.group - 1) / a.group) {  // slots a thread
    case 9: return launch_group<9, kText>(a, s);
    case 10: return launch_group<10, kText>(a, s);
    case 11: return launch_group<11, kText>(a, s);
    case 12: return launch_group<12, kText>(a, s);
    case 13: return launch_group<13, kText>(a, s);
    case 14: return launch_group<14, kText>(a, s);
    case 15: return launch_group<15, kText>(a, s);
    case 16: return launch_group<16, kText>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// As gwa_banded_dp (banded_dp.cu) for 17 <= k <= kMaxGroupK: text != null,
// the text entry (rid, starts, text over nw words of n_text bases; windows
// unused); else the windows entry (rid and starts null, B = Q).  Reads (B,
// L) int8, lengths (B,), dist and end_b (Q,) int32.
extern "C" int gwa_banded_group(const void* reads, const void* lengths, const void* rid,
                                const void* windows, const void* text, const void* starts,
                                void* dist, void* end_b, int64_t Q, int32_t B, int32_t L,
                                int32_t W, int32_t nw, int32_t n_text, int32_t k, void* stream) {
  if (Q <= 0) return 0;
  if (B <= 0 || L < 0 || W < 0 || (text && nw <= 0) || k <= 16 || k > kMaxGroupK)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.reads = static_cast<const int8_t*>(reads);
  a.lengths = static_cast<const int32_t*>(lengths);
  a.rid = static_cast<const int32_t*>(rid);
  a.windows = static_cast<const int8_t*>(windows);
  a.text = static_cast<const uint32_t*>(text);
  a.starts = static_cast<const int32_t*>(starts);
  a.dist = static_cast<int32_t*>(dist);
  a.end_b = static_cast<int32_t*>(end_b);
  a.Q = Q;
  a.B = B;
  a.L = L;
  a.W = W;
  a.nw = nw;
  a.n_text = n_text;
  a.k = k;
  auto s = static_cast<cudaStream_t>(stream);
  return text ? dispatch<true>(a, s) : dispatch<false>(a, s);
}
