// Myers bit-parallel semi-global edit distance on Hopper (sm_90a), one
// thread per lane up to 8 words and a group of threads per lane past them,
// with the window streamed from the 2-bit packed text.
//
// Replaces the Pallas TPU kernel genome_weaver_align_tpu/ops/myers_pallas.py::_kernel
// and computes exactly genome_weaver_align_tpu_torch/ops/myers.py::myers_semiglobal_end
// (itself the twin of genome_weaver_align_tpu/ops/myers.py::myers_semiglobal_end):
// the read is a column bit-vector of nwords 32-bit words (any nwords >= 1;
// the TPU kernel stops at 8, the jnp engine the JAX paths call does not);
// each window step runs the search-variant recurrence
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
// Past 8 words (reads past 256 bases: 2 x 300 bp mate rescue, long reads
// under verify_mode="myers") one thread would carry nwords words of six
// vectors in registers and a carry chain nwords adds long.  So a lane is a
// group of G threads (a power of two inside a warp), thread j holding P
// consecutive words j P .. j P + P - 1 (P = 1, 4, 8 or 16 in
// registers; the binding picks (G, P) from nwords, myers_cuda.group_shape;
// the group pads the top words, which nothing reads: carries and shifts
// only move up).  The group runs as a wavefront.  Both of a column's
// dependencies across words flow upwards (the carry of (Peq & PV) + PV and
// the shift by one of Ph and Mh), so at time step t thread j runs column
// t - j: it takes the add's carry-in and its top word's Ph and Mh that
// thread j - 1 computed for the same column one time step earlier (three
// __shfl_up_sync; thread 0 takes 0, the search variant's free text start),
// runs its P words (the shift by one a funnel shift with the word below),
// and keeps its own for thread j + 1.  No ballot and no lookahead: a time
// step is one thread's P-word chain, and a lane takes steps + G - 1 of
// them.  What sets the pace at the rescue's few warps a multiprocessor is
// the instructions a warp issues a step, not the shuffle's latency:
// handing up a block of 16 columns at a time (one handoff a block) took
// [8]'s first 300 bp rescue call 0.1103 ms against 0.0903 for a column at
// a time with one packed shuffle, on an NVIDIA H100 80GB HBM3 at 700.00 W:
// its 16 (G - 1) more columns a lane cost as much as the shuffles it saved
// (PERF.md section 6).  So a step keeps only the recurrence, three
// independent shuffles of whole words (nothing packed or unpacked) and one
// bit a step of the owner's Ph and Mh at len - 1; the score, best and the
// end of the first strict improvement are taken every 16 steps from those
// bits, at once where the run cannot beat best.  Each thread streams its own columns, j behind
// thread 0 (the window's start moved j bases left, its live columns j
// right), so before its column 0 a thread runs dead columns (Peq = 0),
// which leave the initial state (PV all ones, MV 0, nothing handed up) as
// it is; past its last column its state runs on and is never scored.  The
// thread that holds bit len - 1 keeps the score at its own column index
// and writes it.  The same recurrence in another order of time, so (best,
// end) equal the plain version's on every lane.
// Past 512 words (16,384 bases) the words live in a scratch buffer the
// binding allocates, a warp a lane, 6 x ceil(nwords / 32) words a thread,
// and the same code runs over them (slow, right, and no length refused).
// Rows are staged as above while lanes a block x L fits a block's shared
// memory (fewer threads a block down to a warp; past that each lane reads
// its row from global memory once, for the Peq build).
//
// Entries: gwa_myers (windows) and gwa_myers_text, plain C functions bound
// with ctypes.  They launch on the caller's stream, do not synchronise,
// allocate nothing (the binding allocates the scratch words past 512 words),
// and return the launch's CUDA error code.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "stage_rows.cuh"

namespace {

constexpr int kMaxThreads = gwa::kMaxStageThreads;
constexpr uint32_t kGroup = 16;  // window columns a packed text word

constexpr uint32_t kFull = 0xFFFFFFFFu;
constexpr int32_t kMemWords = 16 * 32;    // words past which a group's words live in scratch
constexpr int kScratchVectors = 6;        // Peq x 4, PV, MV

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
  uint32_t* scratch;       // kScratchVectors x wpt x stride words past kMemWords
  int64_t Q, stride;
  int32_t B, L, W, steps, nw, n_text;
  int32_t nwords, group, wpt;  // read words; threads a lane; words a thread (the binding's)
  int32_t stage;               // rows staged in shared memory (else read from global memory)
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
  // lag: the columns run `lag` behind the window's (a wavefront thread's
  // place in its group): column c is window column c - lag, dead below 0
  __device__ __forceinline__ void init(const Args& a, int64_t q, int32_t lag) {
    text = a.text;
    last = a.nw - 1;
    const long long start = a.starts[q];
    const long long p = start - lag;
    w0 = static_cast<int32_t>(p >> 4);
    shift = 2u * static_cast<uint32_t>(p & 15);
    // live columns: on the text ([-start, n_text - start)) and below
    // min(W, valid), moved by lag
    const long long lo = (start < 0 ? -start : 0) + lag;
    const long long cap = static_cast<long long>(min(a.W, a.valid[q])) + lag;
    long long hi = static_cast<long long>(a.n_text) - start + lag;
    hi = hi < cap ? hi : cap;
    t_lo = static_cast<int32_t>(lo < INT_MAX ? lo : INT_MAX);
    hi = hi > lo ? hi : lo;
    t_hi = static_cast<int32_t>(hi < INT_MAX ? hi : INT_MAX);
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
// the last one; `lag` as TextStream's.
template <typename T>
struct WindowStream {
  const T* w;
  int32_t last, lag;

  __device__ __forceinline__ void init(const Args& a, int64_t q, int32_t lag_) {
    w = static_cast<const T*>(a.windows) + q * a.W;
    last = a.W - 1;
    lag = lag_;
  }
  __device__ __forceinline__ void group(int32_t u, uint32_t& codes, uint32_t& live) {
    codes = 0;
    live = 0;
#pragma unroll
    for (int j = 0; j < static_cast<int>(kGroup); ++j) {
      const int32_t col = static_cast<int32_t>(kGroup) * u + j - lag;
      const int32_t c = static_cast<int32_t>(w[min(max(col, 0), last)]);
      live |= static_cast<uint32_t>(c < 4 && col >= 0) << j;
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
  const T* row = a.stage ? gwa::stage_rows(static_cast<const T*>(a.reads), a.L, r, live_lane, smem)
                         : static_cast<const T*>(a.reads) + static_cast<int64_t>(r) * a.L;
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
  win.init(a, q, 0);
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

// Two blocks a multiprocessor at least, so a small cohort spreads over the
// card (gwa::launch_staged halves the block down to a warp for it).
template <typename T, class Kernel>
int launch_spread(Kernel kernel, const Args& a, int group, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  return gwa::launch_staged<T>(kernel, a, group, 2 * static_cast<int64_t>(sms), stream);
}

template <int NW, typename T, class Stream>
int launch(const Args& a, cudaStream_t stream) {
  return launch_spread<T>(myers_kernel<NW, T, Stream>, a, 1, stream);
}

// ------------------------------------------------ a group of threads a lane

// P words of one thread in registers.
template <int P>
struct RegWords {
  // the 16 columns a text word are unrolled for 4 words a thread only: at 8
  // and 16 the unrolled step is so long that nvcc's build time, not the
  // loop overhead, is what it costs
  static constexpr bool kUnroll = P <= 4;
  uint32_t e0[P], e1[P], e2[P], e3[P], pv_[P], mv_[P];

  __device__ __forceinline__ void init(const Args&, int64_t) {}
  __device__ __forceinline__ int n() const { return P; }
  __device__ __forceinline__ uint32_t peq(uint32_t code, int u) const {
    const uint32_t e01 = (code & 1u) ? e1[u] : e0[u];
    const uint32_t e23 = (code & 1u) ? e3[u] : e2[u];
    return (code & 2u) ? e23 : e01;
  }
  __device__ __forceinline__ void set_eq(int u, uint32_t m0, uint32_t m1, uint32_t m2,
                                         uint32_t m3) {
    e0[u] = m0;
    e1[u] = m1;
    e2[u] = m2;
    e3[u] = m3;
  }
  __device__ __forceinline__ uint32_t& pv(int u) { return pv_[u]; }
  __device__ __forceinline__ uint32_t& mv(int u) { return mv_[u]; }
};

// wpt words of one thread in the scratch buffer: vector v's word u of
// thread t at (v wpt + u) stride + t, so a warp's threads touch consecutive
// words.
struct MemWords {
  static constexpr bool kUnroll = false;
  uint32_t* p;
  int64_t stride;
  int np;

  __device__ __forceinline__ void init(const Args& a, int64_t t) {
    p = a.scratch + t;
    stride = a.stride;
    np = a.wpt;
  }
  __device__ __forceinline__ int n() const { return np; }
  __device__ __forceinline__ uint32_t& at(int v, int u) const {
    return p[(static_cast<int64_t>(v) * np + u) * stride];
  }
  __device__ __forceinline__ uint32_t peq(uint32_t code, int u) const {
    return at(static_cast<int>(code), u);
  }
  __device__ __forceinline__ void set_eq(int u, uint32_t m0, uint32_t m1, uint32_t m2,
                                         uint32_t m3) {
    at(0, u) = m0;
    at(1, u) = m1;
    at(2, u) = m2;
    at(3, u) = m3;
  }
  __device__ __forceinline__ uint32_t& pv(int u) { return at(4, u); }
  __device__ __forceinline__ uint32_t& mv(int u) { return at(5, u); }
};

template <class Words>
struct WaveLane {
  Words w;
  int own;          // this thread's word holding bit len-1, or -1
  uint32_t own_bit;
  int own_pos;      // bit len-1's place in its word
  int j, G;         // index in the group, group size
  uint32_t from_below;  // 0 for thread 0 (the search variant's free text start), else all ones
  // of this thread's last column, from its top word: the add's carry out,
  // and Ph and Mh (bit 31 is what the shift by one carries up)
  uint32_t carry_top, hp_top, hn_top;
  // the owner's Ph and Mh bits at len-1, one bit a time step, the newest at
  // bit 0: scored a run of 16 time steps at a time (score_run)
  uint32_t up_run, dn_run;
  int32_t score, best, end;

  // time step: column t - j of this thread, whose code and liveness the
  // stream gave; what comes in from below is what thread j - 1 computed for
  // the same column at the time step before
  __device__ __forceinline__ void step(uint32_t code, bool live) {
    uint32_t carry = __shfl_up_sync(kFull, carry_top, 1, G) & from_below;
    uint32_t hp_lo = __shfl_up_sync(kFull, hp_top, 1, G) & from_below;
    uint32_t hn_lo = __shfl_up_sync(kFull, hn_top, 1, G) & from_below;
    uint32_t up = 0u, dn = 0u;
    const int n = w.n();
#pragma unroll
    for (int u = 0; u < n; ++u) {
      const uint32_t peq = live ? w.peq(code, u) : 0u;
      const uint32_t pv = w.pv(u), mv = w.mv(u);
      const uint64_t sum = static_cast<uint64_t>(peq & pv) + pv + carry;
      carry = static_cast<uint32_t>(sum >> 32);
      const uint32_t d0 = (static_cast<uint32_t>(sum) ^ pv) | peq | mv;
      const uint32_t hn = pv & d0;
      const uint32_t hp = mv | ~(pv | d0);
      const uint32_t m = u == own ? own_bit : 0u;
      up |= hp & m;
      dn |= hn & m;
      // (hp << 1) | the top bit of the word below, and the same for hn
      const uint32_t xs = __funnelshift_l(hp_lo, hp, 1);
      hp_lo = hp;
      const uint32_t hns = __funnelshift_l(hn_lo, hn, 1);
      hn_lo = hn;
      w.mv(u) = xs & d0;
      w.pv(u) = hns | ~(xs | d0);
    }
    carry_top = carry;
    hp_top = hp_lo;
    hn_top = hn_lo;
    up_run = (up_run << 1) | (up >> own_pos);
    dn_run = (dn_run << 1) | (dn >> own_pos);
  }

  // the last k time steps' bits (k <= 16), time step t_last the newest:
  // score += up - dn a step, best and the end of its first strict
  // improvement kept at this thread's column; steps at or past `stop`
  // (steps + j, past its last column) are not scored.  A run whose lowest
  // reachable score cannot beat best is added at once.
  __device__ __forceinline__ void score_run(int k, int32_t t_last, int32_t stop) {
    const int32_t t_first = t_last - k + 1;
    const int live = min(max(stop - t_first, 0), k);  // scored steps, the oldest first
    const uint32_t keep = ((1u << live) - 1u) << (k - live);
    const uint32_t u = up_run & keep, d = dn_run & keep;
    up_run = dn_run = 0u;
    if ((u | d) == 0u) return;
    if (score - __popc(d) >= best) {
      score += __popc(u) - __popc(d);
      return;
    }
    for (int i = k - 1; i >= 0; --i) {
      score += static_cast<int32_t>((u >> i) & 1u) - static_cast<int32_t>((d >> i) & 1u);
      if (score < best) {  // strict: ties keep the earliest end
        best = score;
        end = t_last - i - j + 1;
      }
    }
  }
};

template <class Words, typename T, class Stream>
__global__ void __launch_bounds__(kMaxThreads) myers_group_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = a.group;
  const int64_t gt = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t q = gt / G;
  const bool live_lane = q < a.Q;
  const int64_t qc = live_lane ? q : a.Q - 1;  // a lane past the end runs lane Q-1, unwritten
  const int32_t r = a.rid ? min(max(a.rid[qc], 0), a.B - 1) : static_cast<int32_t>(qc);
  const T* row = a.stage ? gwa::stage_rows(static_cast<const T*>(a.reads), a.L, r, live_lane,
                                           smem, G)
                         : static_cast<const T*>(a.reads) + static_cast<int64_t>(r) * a.L;
  if (__all_sync(kFull, !live_lane)) return;  // no later __syncthreads

  WaveLane<Words> s;
  s.w.init(a, gt);
  s.G = G;
  s.j = static_cast<int>(threadIdx.x) & (G - 1);
  const int n = s.w.n();
  const int32_t len = live_lane ? a.lengths[r] : 0;
  const int32_t n_in = len < a.L ? len : a.L;
  const int32_t last_word = len >= 1 ? (len - 1) >> 5 : -1;
  const bool has_owner = last_word >= 0 && last_word < a.nwords;
  s.own = has_owner ? last_word - s.j * n : -1;
  if (s.own >= n) s.own = -1;
  s.own_pos = len >= 1 ? (len - 1) & 31 : 0;
  s.own_bit = len >= 1 ? 1u << s.own_pos : 0u;
  const bool writer = has_owner ? (s.own >= 0) : (s.j == 0);
  // Peq[c][word]: bit b of word v set iff read[32 v + b] == c (i < len)
#pragma unroll
  for (int u = 0; u < n; ++u) {
    const int32_t v = s.j * n + u;
    const int32_t base = 32 * v;
    const int32_t hi = v < a.nwords ? min(max(n_in - base, 0), 32) : 0;
    uint32_t m0 = 0, m1 = 0, m2 = 0, m3 = 0;
    for (int32_t b = 0; b < hi; ++b) {
      const int32_t c = static_cast<int32_t>(row[base + b]);
      const uint32_t bit = 1u << b;
      m0 |= c == 0 ? bit : 0u;
      m1 |= c == 1 ? bit : 0u;
      m2 |= c == 2 ? bit : 0u;
      m3 |= c == 3 ? bit : 0u;
    }
    s.w.set_eq(u, m0, m1, m2, m3);
    s.w.pv(u) = kFull;
    s.w.mv(u) = 0u;
  }
  s.score = len;
  s.best = len;
  s.end = 0;
  s.from_below = s.j == 0 ? 0u : kFull;
  s.carry_top = s.hp_top = s.hn_top = 0u;
  s.up_run = s.dn_run = 0u;

  // thread j streams its columns j behind thread j - 1 (the window moved j
  // bases left); thread G - 1 runs the last column at time step steps + G - 2
  Stream win;
  win.init(a, qc, s.j);
  const int32_t span = a.steps > 0 ? a.steps + G - 1 : 0;
  const int32_t stop = a.steps + s.j;
  const int32_t full = span / static_cast<int32_t>(kGroup);
  const int32_t rem = span % static_cast<int32_t>(kGroup);
  constexpr int kG = static_cast<int>(kGroup);
  uint32_t codes, live;
  for (int32_t u = 0; u < full; ++u) {
    win.group(u, codes, live);
    if constexpr (Words::kUnroll) {
#pragma unroll
      for (int jj = 0; jj < kG; ++jj) s.step((codes >> (2 * jj)) & 3u, (live >> jj) & 1u);
    } else {
#pragma unroll 1
      for (int jj = 0; jj < kG; ++jj) s.step((codes >> (2 * jj)) & 3u, (live >> jj) & 1u);
    }
    s.score_run(kG, kG * u + kG - 1, stop);
  }
  if (rem) {
    win.group(full, codes, live);
    for (int32_t jj = 0; jj < rem; ++jj) s.step((codes >> (2 * jj)) & 3u, (live >> jj) & 1u);
    s.score_run(rem, kG * full + rem - 1, stop);
  }
  if (live_lane && writer) {
    a.best[q] = s.best;
    a.end[q] = s.end;
  }
}

template <class Words, typename T, class Stream>
int launch_group(const Args& a, cudaStream_t stream) {
  return launch_spread<T>(myers_group_kernel<Words, T, Stream>, a, a.group, stream);
}

template <typename T, class Stream>
int dispatch(int32_t nwords, Args a, int64_t scratch_words, cudaStream_t s) {
  switch (nwords) {
    case 1: return launch<1, T, Stream>(a, s);
    case 2: return launch<2, T, Stream>(a, s);
    case 3: return launch<3, T, Stream>(a, s);
    case 4: return launch<4, T, Stream>(a, s);
    case 5: return launch<5, T, Stream>(a, s);
    case 6: return launch<6, T, Stream>(a, s);
    case 7: return launch<7, T, Stream>(a, s);
    case 8: return launch<8, T, Stream>(a, s);
    default: break;
  }
  // a group: G a power of two inside a warp, G x P words covering nwords
  const int32_t G = a.group, P = a.wpt;
  if (nwords < 1 || G < 2 || G > 32 || (G & (G - 1)) != 0 || P < 1 ||
      static_cast<int64_t>(G) * P < nwords)
    return static_cast<int>(cudaErrorInvalidValue);
  a.nwords = nwords;
  if (nwords > kMemWords) {
    a.stride = a.Q * G;
    if (G != 32 || !a.scratch ||
        scratch_words < kScratchVectors * static_cast<int64_t>(P) * a.stride)
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_group<MemWords, T, Stream>(a, s);
  }
  switch (P) {
    case 1: return launch_group<RegWords<1>, T, Stream>(a, s);
    case 4: return launch_group<RegWords<4>, T, Stream>(a, s);
    case 8: return launch_group<RegWords<8>, T, Stream>(a, s);
    case 16: return launch_group<RegWords<16>, T, Stream>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The windows entry.  elem_bytes: 1 for int8 reads and windows, 4 for int32.
// Past 8 words a group of `group` threads of `wpt` words a lane (the
// binding's choice); past 512 words scratch_words >= 6 wpt Q group.
extern "C" int gwa_myers(const void* reads, const void* lengths, const void* windows, void* best,
                         void* end, int64_t Q, int32_t L, int32_t W, int32_t nwords,
                         int32_t group, int32_t wpt, int32_t steps, int32_t elem_bytes,
                         void* scratch, int64_t scratch_words, void* stream) {
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
  a.group = group;
  a.wpt = wpt;
  a.scratch = static_cast<uint32_t*>(scratch);
  auto s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 1) return dispatch<int8_t, WindowStream<int8_t>>(nwords, a, scratch_words, s);
  if (elem_bytes == 4) return dispatch<int32_t, WindowStream<int32_t>>(nwords, a, scratch_words, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The text entry: reads (B, L) int8, lengths (B,), rid, starts and valid
// (Q,) int32 (rid clamped into [0, B)), text over nw words of n_text bases;
// W columns a window; group and wpt as gwa_myers'.
extern "C" int gwa_myers_text(const void* text, int32_t nw, int32_t n_text, const void* starts,
                              const void* reads, const void* lengths, const void* rid,
                              const void* valid, void* best, void* end, int64_t Q, int32_t B,
                              int32_t L, int32_t W, int32_t nwords, int32_t group, int32_t wpt,
                              void* scratch, int64_t scratch_words, void* stream) {
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
  a.group = group;
  a.wpt = wpt;
  a.scratch = static_cast<uint32_t*>(scratch);
  return dispatch<int8_t, TextStream>(nwords, a, scratch_words, static_cast<cudaStream_t>(stream));
}
