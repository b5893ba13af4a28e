// Myers bit-parallel semi-global edit distance on Hopper (sm_90a), one
// thread per lane, with the window streamed from the 2-bit packed text.
//
// Replaces the Pallas TPU kernel genome_weaver_align_tpu/ops/myers_pallas.py::_kernel
// and computes exactly genome_weaver_align_tpu_torch/ops/myers.py::myers_semiglobal_end
// (itself the twin of genome_weaver_align_tpu/ops/myers.py::myers_semiglobal_end):
// the read is a column bit-vector of NW 32-bit words (NW = 1..8, reads of at
// most 256 bases); each window step runs the search-variant recurrence
// (Myers 1999 / Hyyro 2003) with a free text start; window codes >= 4 have
// Peq = 0 and a negative code reads Peq[0], as the plain version's clamp
// does; the score row is one bit test on the word that holds bit len-1;
// best starts at len and end is the exclusive end of the first strict
// improvement, so a zero-length lane gives (0, 0).  Exactly `steps` window
// columns are consumed (a step past the row reads its last column, as the
// plain loop does); nothing is padded to the TPU's 8-step chunks.
//
// Two entries share one kernel body and differ in the window loader:
//   text     lane q runs read rid[q] of the (B, L) int8 reads against the W
//            bases of the packed text at starts[q]; bases off the text and
//            columns at or after valid[q] are code 4 (the paired insert
//            bound).  Equal to myers_semiglobal_end(reads[rid], lengths[rid],
//            where(col >= valid, 4, gather_windows(text, n, starts, W))).
//            No (Q, W) window tensor is ever written.
//   windows  lane q runs read row q against window row q of a (Q, W) int8
//            or int32 tensor (the JAX contract).
//
// What bounds it, and what the design does about it:
//   * The step chain.  Each window column is a few dozen dependent integer
//     instructions (the Peq pick, the NW-word carried add, the xor-or, HN,
//     HP, the carried shifts) whose result feeds the next column, so a lane
//     is bound by latency, not by issue: steps x the chain of one step.  A
//     2,048-lane rescue cohort cannot fill 132 SMs' issue slots, so the
//     design keeps everything else off the chain.
//   * Window loads.  The text entry streams the window from the packed
//     words: one 32-bit word per 16 columns (a funnel shift of two text
//     words by the start's in-word offset), prefetched a word ahead, with a
//     16-bit mask of the columns that are live (on the text and below
//     valid).  The step loop is unrolled by 16, so the decode is a constant
//     shift and mask, and the Peq pick depends on the text alone and is
//     scheduled off the chain.  The windows entry loads its row's 16 bytes
//     a group into the same (codes, live) pair.
//   * Peq build.  A block's lanes read a contiguous run of read rows (rid
//     does not decrease after compact_lanes, and is the identity for the
//     rescue), so the block copies them into shared memory with 16-byte
//     loads once (stage_rows.cuh) and builds Peq from shared bytes.
//   * Spread.  The host picks 128, 64 or 32 threads a block, the largest
//     that still gives two blocks a multiprocessor, so a 2,048-lane cohort
//     spreads over 64 SMs instead of 16.
//   The least arithmetic is 11 integer instructions a read word a step and
//   5 a step for the score, far below the card's issue rate at the rescue
//   shape; the latency floor is what chip_smoke.py prints beside it.
//
// Entries: gwa_myers (windows) and gwa_myers_text, plain C functions bound
// with ctypes.  They launch on the caller's stream, do not synchronise,
// allocate nothing, and return the launch's CUDA error code.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "stage_rows.cuh"

namespace {

constexpr int kMaxThreads = gwa::kMaxStageThreads;
constexpr uint32_t kGroup = 16;  // window columns a packed text word

struct Args {
  const void* reads;       // (B, L) int8, or the windows entry's (Q, L) int8 / int32
  const int32_t* lengths;  // (B,)
  const int32_t* rid;      // (Q,) the read of each lane; null: lane q reads row q
  const void* windows;     // (Q, W) for the windows entry
  const uint32_t* text;    // (nw,) packed text for the text entry
  const int32_t* starts;   // (Q,) window starts for the text entry
  const int32_t* valid;    // (Q,) live columns of each window for the text entry
  int32_t* best;
  int32_t* end;
  int64_t Q;
  int32_t B, L, W, steps, nw, n_text;
};

// Window columns of one lane from the packed text: 16 columns a group as
// (2-bit codes, live mask); base p at bits 2 (p & 15) of word p >> 4.
struct TextStream {
  const uint32_t* text;
  int32_t last, w0;
  uint32_t shift;
  int32_t t_lo, t_hi;  // live columns [t_lo, t_hi)
  uint32_t cur, nxt;

  __device__ __forceinline__ uint32_t word(int32_t w) const {
    return __ldg(text + min(max(w, 0), last));
  }
  __device__ __forceinline__ void init(const Args& a, int64_t q) {
    text = a.text;
    last = a.nw - 1;
    const int32_t p = a.starts[q];
    w0 = p >> 4;
    shift = 2u * static_cast<uint32_t>(p & 15);
    // live columns: on the text ([-p, n_text - p)) and below min(W, valid)
    const long long lo = p < 0 ? -static_cast<long long>(p) : 0;
    const long long cap = static_cast<long long>(min(a.W, a.valid[q]));
    long long hi = static_cast<long long>(a.n_text) - p;
    hi = hi < cap ? hi : cap;
    t_lo = static_cast<int32_t>(lo < INT_MAX ? lo : INT_MAX);
    t_hi = static_cast<int32_t>(hi > lo ? hi : lo);
    cur = word(w0);
    nxt = word(w0 + 1);
  }
  __device__ __forceinline__ void group(int32_t u, uint32_t& codes, uint32_t& live) {
    const uint32_t ahead = word(w0 + u + 2);
    codes = __funnelshift_r(cur, nxt, shift);
    cur = nxt;
    nxt = ahead;
    const int32_t base = static_cast<int32_t>(kGroup) * u;
    const int32_t lo = min(max(t_lo - base, 0), 16), hi = min(max(t_hi - base, 0), 16);
    live = ((1u << hi) - 1u) & ~((1u << lo) - 1u);
  }
};

// Window columns of one lane from a (Q, W) tensor; a column past W reads
// the last one.
template <typename T>
struct WindowStream {
  const T* w;
  int32_t last;

  __device__ __forceinline__ void init(const Args& a, int64_t q) {
    w = static_cast<const T*>(a.windows) + q * a.W;
    last = a.W - 1;
  }
  __device__ __forceinline__ void group(int32_t u, uint32_t& codes, uint32_t& live) {
    codes = 0;
    live = 0;
#pragma unroll
    for (int j = 0; j < static_cast<int>(kGroup); ++j) {
      const int32_t c = static_cast<int32_t>(w[min(static_cast<int32_t>(kGroup) * u + j, last)]);
      live |= static_cast<uint32_t>(c < 4) << j;
      codes |= static_cast<uint32_t>(min(max(c, 0), 3)) << (2 * j);
    }
  }
};

template <int NW>
struct Lane {
  uint32_t eq0[NW], eq1[NW], eq2[NW], eq3[NW], lmask[NW];
  uint32_t pv[NW], mv[NW];
  int32_t score, best, end;

  // one window column: code 0..3 (a text base or a clamped window code),
  // live false for a code >= 4 (Peq = 0)
  __device__ __forceinline__ void step(uint32_t code, bool live, int32_t t) {
    uint32_t up = 0u, dn = 0u;
    uint32_t carry = 0u;              // of the multi-word add (Peq & PV) + PV
    uint32_t hp_in = 0u, hn_in = 0u;  // bits shifted in from the word below
#pragma unroll
    for (int v = 0; v < NW; ++v) {
      const uint32_t e01 = (code & 1u) ? eq1[v] : eq0[v];
      const uint32_t e23 = (code & 1u) ? eq3[v] : eq2[v];
      const uint32_t peq = live ? ((code & 2u) ? e23 : e01) : 0u;
      const uint32_t x0 = peq | mv[v];
      const uint64_t sum = static_cast<uint64_t>(peq & pv[v]) + pv[v] + carry;
      carry = static_cast<uint32_t>(sum >> 32);
      const uint32_t d0 = (static_cast<uint32_t>(sum) ^ pv[v]) | x0;
      const uint32_t hn = pv[v] & d0;
      const uint32_t hp = mv[v] | ~(pv[v] | d0);
      up |= hp & lmask[v];
      dn |= hn & lmask[v];
      const uint32_t xs = (hp << 1) | hp_in;
      hp_in = hp >> 31;
      const uint32_t hns = (hn << 1) | hn_in;
      hn_in = hn >> 31;
      mv[v] = xs & d0;
      pv[v] = hns | ~(xs | d0);
    }
    score += (up != 0u) - (dn != 0u);
    if (score < best) {  // strict: ties keep the earliest end
      best = score;
      end = t + 1;
    }
  }
};

template <int NW, typename T, class Stream>
__global__ void __launch_bounds__(kMaxThreads) myers_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int64_t q = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool live_lane = q < a.Q;
  int32_t r = 0;
  if (live_lane) r = a.rid ? min(max(a.rid[q], 0), a.B - 1) : static_cast<int32_t>(q);
  const T* row = gwa::stage_rows(static_cast<const T*>(a.reads), a.L, r, live_lane, smem);
  if (!live_lane) return;

  const int32_t len = a.lengths[r];
  const int32_t n_in = len < a.L ? len : a.L;
  const int32_t last = len - 1;
  Lane<NW> s;
  // Peq[c][word]: bit b of word v set iff read[32 v + b] == c (i < len)
#pragma unroll
  for (int v = 0; v < NW; ++v) {
    uint32_t m0 = 0, m1 = 0, m2 = 0, m3 = 0;
    const int32_t base = 32 * v;
    const int32_t hi = n_in - base < 32 ? n_in - base : 32;
    for (int32_t b = 0; b < hi; ++b) {
      const int32_t c = static_cast<int32_t>(row[base + b]);
      const uint32_t bit = 1u << b;
      m0 |= c == 0 ? bit : 0u;
      m1 |= c == 1 ? bit : 0u;
      m2 |= c == 2 ? bit : 0u;
      m3 |= c == 3 ? bit : 0u;
    }
    s.eq0[v] = m0;
    s.eq1[v] = m1;
    s.eq2[v] = m2;
    s.eq3[v] = m3;
    s.lmask[v] = (last >= 0 && (last >> 5) == v) ? (1u << (last & 31)) : 0u;
    s.pv[v] = 0xFFFFFFFFu;
    s.mv[v] = 0u;
  }
  s.score = len;
  s.best = len;
  s.end = 0;

  Stream win;
  win.init(a, q);
  const int32_t full = a.steps / static_cast<int32_t>(kGroup);
  const int32_t rem = a.steps % static_cast<int32_t>(kGroup);
  uint32_t codes, live;
  for (int32_t u = 0; u < full; ++u) {
    win.group(u, codes, live);
    const int32_t t0 = static_cast<int32_t>(kGroup) * u;
#pragma unroll
    for (int j = 0; j < static_cast<int>(kGroup); ++j)
      s.step((codes >> (2 * j)) & 3u, (live >> j) & 1u, t0 + j);
  }
  if (rem) {
    win.group(full, codes, live);
    const int32_t t0 = static_cast<int32_t>(kGroup) * full;
    for (int32_t j = 0; j < rem; ++j) s.step((codes >> (2 * j)) & 3u, (live >> j) & 1u, t0 + j);
  }
  a.best[q] = s.best;
  a.end[q] = s.end;
}

template <int NW, typename T, class Stream>
int launch(const Args& a, cudaStream_t stream) {
  auto kernel = myers_kernel<NW, T, Stream>;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  int threads = kMaxThreads;
  while (threads > 32 && (a.Q + threads - 1) / threads < 2 * static_cast<int64_t>(sms)) threads /= 2;
  const size_t smem = static_cast<size_t>(threads) * a.L * sizeof(T) + 16;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const unsigned blocks = static_cast<unsigned>((a.Q + threads - 1) / threads);
  kernel<<<blocks, threads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, class Stream>
int dispatch(int32_t nwords, const Args& a, cudaStream_t s) {
  switch (nwords) {
    case 1: return launch<1, T, Stream>(a, s);
    case 2: return launch<2, T, Stream>(a, s);
    case 3: return launch<3, T, Stream>(a, s);
    case 4: return launch<4, T, Stream>(a, s);
    case 5: return launch<5, T, Stream>(a, s);
    case 6: return launch<6, T, Stream>(a, s);
    case 7: return launch<7, T, Stream>(a, s);
    case 8: return launch<8, T, Stream>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The windows entry.  elem_bytes: 1 for int8 reads and windows, 4 for int32.
extern "C" int gwa_myers(const void* reads, const void* lengths, const void* windows, void* best,
                         void* end, int64_t Q, int32_t L, int32_t W, int32_t nwords,
                         int32_t steps, int32_t elem_bytes, void* stream) {
  if (Q <= 0) return 0;
  if (L < 0 || steps < 0 || (steps > 0 && W <= 0) || Q > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.reads = reads;
  a.lengths = static_cast<const int32_t*>(lengths);
  a.windows = windows;
  a.best = static_cast<int32_t*>(best);
  a.end = static_cast<int32_t*>(end);
  a.Q = Q;
  a.B = static_cast<int32_t>(Q);
  a.L = L;
  a.W = W;
  a.steps = steps;
  auto s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 1) return dispatch<int8_t, WindowStream<int8_t>>(nwords, a, s);
  if (elem_bytes == 4) return dispatch<int32_t, WindowStream<int32_t>>(nwords, a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The text entry: reads (B, L) int8, lengths (B,), rid, starts and valid
// (Q,) int32 (rid clamped into [0, B)), text over nw words of n_text bases;
// W columns a window.
extern "C" int gwa_myers_text(const void* text, int32_t nw, int32_t n_text, const void* starts,
                              const void* reads, const void* lengths, const void* rid,
                              const void* valid, void* best, void* end, int64_t Q, int32_t B,
                              int32_t L, int32_t W, int32_t nwords, void* stream) {
  if (Q <= 0) return 0;
  if (B <= 0 || L < 0 || W < 0 || nw <= 0 || n_text < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.reads = reads;
  a.lengths = static_cast<const int32_t*>(lengths);
  a.rid = static_cast<const int32_t*>(rid);
  a.text = static_cast<const uint32_t*>(text);
  a.starts = static_cast<const int32_t*>(starts);
  a.valid = static_cast<const int32_t*>(valid);
  a.best = static_cast<int32_t*>(best);
  a.end = static_cast<int32_t*>(end);
  a.Q = Q;
  a.B = B;
  a.L = L;
  a.W = W;
  a.steps = W;
  a.nw = nw;
  a.n_text = n_text;
  return dispatch<int8_t, TextStream>(nwords, a, static_cast<cudaStream_t>(stream));
}
