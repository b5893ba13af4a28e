// Banded semi-global edit distance on Hopper (sm_90a), one thread per
// candidate lane, with the window gathered from the 2-bit packed text inside
// the kernel.
//
// Replaces the Pallas TPU kernel genome_weaver_align_tpu/ops/dp_pallas.py::_kernel
// and computes exactly genome_weaver_align_tpu_torch/ops/dp.py::banded_edit_distance
// (itself the twin of genome_weaver_align_tpu/ops/dp.py::banded_edit_distance):
// band slot b at read row i is window position j = i + b - k; leading and
// trailing window bases are free; codes >= 4 never match; the window-deletion
// dependency is the serial running min along the band, so cells above INF
// (unreachable lanes) carry the same garbage as the plain version and
// end_b, the first argmin of the unclamped last row, agrees on every lane.
// The arithmetic stays exact int32: 16-bit lanes could not hold INF = 2^20.
//
// Two entries share one kernel body and differ in the window loader (the
// template flag kText):
//   text     lane q verifies read rid[q] of the (B, L) int8 reads against the
//            W bases of the packed text at starts[q] (out-of-text bases are
//            code 4, as ops/window.py::gather_windows gives them).  Equal to
//            banded_edit_distance(reads[rid], lengths[rid],
//                                 gather_windows(text, n, starts, W), k).
//            No (Q, W) window or (Q, L) read tensor is ever written.
//   windows  lane q verifies read row q against window row q of a (Q, W)
//            int8 tensor (the sharded aligner's windows, sums of shard
//            partials).
//
// What bounds it, and what the design does about it:
//   * Read loads.  A block takes 128 consecutive lanes.  After
//     compact_lanes their rids do not decrease, so they cover a short run
//     of reads (about 21 at 6 lanes a read): the block copies those rows
//     (one contiguous span of the reads tensor) into shared memory once,
//     with 16-byte loads (stage_rows.cuh), and each row then costs one
//     shared-memory byte load.  A block whose lanes span more than 128 reads
//     copies each lane's row instead (a warp per row, coalesced bytes).  Lanes that share a read
//     read the same shared byte (a broadcast); rows L bytes apart fall in
//     different banks (L = 100: 25 words apart, coprime with 32).  The
//     byte load is one instruction a row; packing 4 codes a 32-bit load
//     would cost more instructions (a funnel shift and an extract a row,
//     rows are not 4-aligned) to save a load that is not the limit.
//   * Window loads.  The text entry streams its window from the packed
//     words (the text is 16 MB at chr20 scale and stays in L2): one 32-bit
//     word a 16 rows, prefetched a word ahead, decoded with a shift and a
//     mask in registers.
//   * Cell update: 4 integer instructions a cell, the least it needs, all in
//     registers (D and the band's window codes; E = D + 1 is never stored):
//        x    = (w ^ r) & 0x1FF                        LOP3: 0 iff the codes match
//        m    = min(D_old[b], D_old[b+1], D_new[b-1])   DPX __vimin3_s32
//        t    = D_old[b] + x                            IADD
//        D[b] = min(m + 1, t)                           DPX __viaddmin_s32
//     which is the plain version's min(D + x, D + 1, D_old[b+1] + 1,
//     D_new[b-1] + 1): a match (x = 0) is the diagonal, a mismatch costs 1
//     through m + 1.  A read code >= 4 needs no test: the window codes are
//     0..3 or 256 (an out-of-text base, or a window byte >= 4), which no
//     int8 read code equals, and a negative read code matches only an equal
//     window byte, as in the plain version.  The row loop is split into a
//     checked head (i < k), an unchecked body (every slot's j inside the
//     window; with the default W >= L + 3k that is every later row),
//     unrolled by 4k+1 rows so that the band's window codes rotate by
//     register renaming instead of moves, and a checked tail for narrow
//     windows.
//   So the kernel is bound by its integer issue rate: 4 instructions for
//   each of the (4k+1) cells of every live read row.
//   * k = 0..16 in one thread: the short-read aligners' k < 15 (their
//     4-bit dist field) and the long-read segment verify's default band,
//     kb = 16.  The band's D and window codes take 2 (4k+1) = 130 registers
//     at k = 16; storing E too would add 65 more.  What ptxas reports at
//     k = 14 and 16, chip_smoke.py prints.
//   * k = 17..127 (banded_group.cu, its own source, built beside this one):
//     a lane is a group of G = 8..32 threads (a power of two
//     inside a warp), each holding N = ceil((4k+1) / G) = 9..16
//     consecutive band slots of D and window codes in registers (a kernel
//     template a N: the band padded by fewer than G slots); a row is the
//     one-thread design's 4 instructions a cell in each thread's own slots,
//     then one __viaddmin_s32 a cell for the window deletion carried in
//     from the group's lower threads (an exclusive prefix min over the
//     threads, log2(G) + 1 shuffles) and one shuffle for the insertion
//     term across the thread boundary; the window codes rotate by register
//     index over N unrolled rows, decoded from the packed text a block of
//     N rows at a time.  No row checks the window's bounds (banded_group_
//     kernel says why the outputs equal the plain version's all the
//     same).  end_b is the group's first argmin of the last row (a
//     shuffle min of (value, slot)).  Lanes of one warp may have different
//     lengths: each group runs its own rows.
//   * k >= 128: a warp a lane, ceil((4k+1) / 32) slots a thread, D in a
//     scratch buffer the binding allocates (two rows, in turn) and the
//     window codes read per cell; the same scan.  Slow, right, no band
//     refused.
//   * Long reads: a block stages its lanes' rows while lanes x L fits a
//     block's shared memory, with fewer threads a block down to a warp
//     (L up to 7,231 at k <= 16); past that each lane reads its row from
//     global memory (one byte a row, from L2), the text still streamed
//     from the packed words.
//
// Entry: gwa_banded_dp, a plain C function bound with ctypes.  It launches
// on the caller's stream, does not synchronise, allocates nothing (the
// binding allocates gwa_banded_dp_scratch_words words of scratch for
// k >= 128), and returns the launch's CUDA error code.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <type_traits>
#include <utility>

#include "banded_dp.cuh"

namespace {

using namespace gwa::banded;

// The body's rows are unrolled by 4k+1 for k up to this; a wider band runs
// its body one row at a time with the window codes shifted by moves, so
// that the (4k+1)^2-cell unrolled body of every k up to 16 does not
// multiply the build time.
constexpr int kMaxUnrolledK = 8;

// Window codes j = 0, 1, 2, ... of one lane from the packed text: 2 bits a
// base, 16 bases a word, base p at bits 2 (p & 15) of word p >> 4.
struct TextStream {
  const uint32_t* text;
  int32_t last;  // nw - 1
  uint32_t n;
  int32_t p;
  uint32_t cur, nxt;

  __device__ __forceinline__ uint32_t word(int32_t w) const {
    return __ldg(text + min(max(w, 0), last));
  }
  __device__ __forceinline__ void init(const Args& a, int64_t q) {
    text = a.text;
    last = a.nw - 1;
    n = static_cast<uint32_t>(a.n_text);
    p = a.starts[q];
    cur = word(p >> 4) >> (2 * (p & 15));
    nxt = word((p >> 4) + 1);
  }
  __device__ __forceinline__ int32_t next() {
    const int32_t c = static_cast<uint32_t>(p) < n ? static_cast<int32_t>(cur & 3u) : kNoMatch;
    cur >>= 2;
    ++p;
    if ((p & 15) == 0) {
      cur = nxt;
      nxt = word((p >> 4) + 1);
    }
    return c;
  }
};

// Window codes of one lane from a (Q, W) int8 tensor; bytes >= 4 never match.
struct WindowStream {
  const int8_t* w;
  int32_t W, j;

  __device__ __forceinline__ void init(const Args& a, int64_t q) {
    w = a.windows + q * a.W;
    W = a.W;
    j = 0;
  }
  __device__ __forceinline__ int32_t next() {
    const int32_t c = j < W ? static_cast<int32_t>(w[j]) : kNoMatch;
    ++j;
    return c < 4 ? c : kNoMatch;
  }
};

// Random access to one lane's window codes (the group and scratch
// kernels): code of window position j, kNoMatch off the text, at a byte >= 4
// or past W.
struct TextCodes {
  const uint32_t* text;
  int64_t p0, n;

  __device__ __forceinline__ void init(const Args& a, int64_t q) {
    text = a.text;
    p0 = a.starts[q];
    n = a.n_text;
  }
  __device__ __forceinline__ int32_t at(int32_t j) const {
    const int64_t p = p0 + j;
    if (p < 0 || p >= n) return kNoMatch;
    return static_cast<int32_t>((__ldg(text + (p >> 4)) >> (2 * (p & 15))) & 3u);
  }
};

struct WindowCodes {
  const int8_t* w;
  int32_t W;

  __device__ __forceinline__ void init(const Args& a, int64_t q) {
    w = a.windows + q * a.W;
    W = a.W;
  }
  __device__ __forceinline__ int32_t at(int32_t j) const {
    if (j < 0 || j >= W) return kNoMatch;
    const int32_t c = static_cast<int32_t>(w[j]);
    return c < 4 ? c : kNoMatch;
  }
};

template <int K>
struct Band {
  static constexpr int kBand = 4 * K + 1;
  int32_t D[kBand];
  int32_t wc[kBand];  // window codes of the band's slots, rotated by R in the body
};

// A row whose slots may fall outside the window: the plain version's valid
// mask, then the window codes shift down one slot.
template <int K, class Stream>
__device__ __forceinline__ void checked_row(Band<K>& s, Stream& win, int32_t rc, int32_t i,
                                            int32_t W) {
  constexpr int BAND = Band<K>::kBand;
  s.wc[BAND - 1] = win.next();
#pragma unroll
  for (int b = 0; b < BAND; ++b) {
    const bool valid = static_cast<uint32_t>(i + b - K) < static_cast<uint32_t>(W);
    const int32_t x = (s.wc[b] ^ rc) & 0x1FF;
    const int32_t up = b + 1 < BAND ? s.D[b + 1] : kInf;  // not yet updated: row i-1
    const int32_t t = valid ? __viaddmin_s32(min(s.D[b], up), 1, s.D[b] + x) : kInf;
    s.D[b] = b == 0 ? t : __viaddmin_s32(s.D[b - 1], 1, t);  // D[b-1]: row i
  }
#pragma unroll
  for (int b = 0; b < BAND - 1; ++b) s.wc[b] = s.wc[b + 1];
}

// A row with every slot inside the window; slot b's code is wc[(b + R) % BAND].
template <int K, int R, class Stream>
__device__ __forceinline__ void body_row(Band<K>& s, Stream& win, const int8_t* rrow,
                                         int32_t i) {
  constexpr int BAND = Band<K>::kBand;
  s.wc[(BAND - 1 + R) % BAND] = win.next();
  const int32_t rc = rrow[i];
#pragma unroll
  for (int b = 0; b < BAND; ++b) {
    const int32_t x = (s.wc[(b + R) % BAND] ^ rc) & 0x1FF;
    // D[b + 1] still holds row i-1, D[b - 1] already row i; past the last
    // slot the plain version reads INF
    int32_t m;
    if (b == 0) {
      m = min(s.D[0], BAND > 1 ? s.D[BAND > 1 ? 1 : 0] : kInf);
    } else {
      m = __vimin3_s32(s.D[b], b + 1 < BAND ? s.D[b + 1] : kInf, s.D[b - 1]);
    }
    s.D[b] = __viaddmin_s32(m, 1, s.D[b] + x);
  }
}

template <int K, class Stream, int... R>
__device__ __forceinline__ void body_rows(Band<K>& s, Stream& win, const int8_t* rrow,
                                          int32_t i0, std::integer_sequence<int, R...>) {
  (body_row<K, R>(s, win, rrow, i0 + R), ...);
}

template <int K, bool kText>
__global__ void __launch_bounds__(kThreads) banded_dp_kernel(const Args a) {
  constexpr int BAND = 4 * K + 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int64_t q = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool live = q < a.Q;
  int32_t r = 0;
  if (live) r = a.rid ? min(max(a.rid[q], 0), a.B - 1) : static_cast<int32_t>(q);
  const int8_t* rrow = a.stage ? gwa::stage_rows(a.reads, a.L, r, live, smem)
                               : a.reads + static_cast<int64_t>(r) * a.L;
  if (!live) return;

  const int32_t len = a.lengths[r];
  const int32_t steps = min(len, a.L);
  const int32_t W = a.W;
  typename std::conditional<kText, TextStream, WindowStream>::type win;
  win.init(a, q);

  Band<K> s;
#pragma unroll
  for (int b = 0; b < BAND; ++b) {
    s.D[b] = b >= K ? 0 : kInf;
    s.wc[b] = kNoMatch;
  }
#pragma unroll
  for (int b = K; b < BAND - 1; ++b) s.wc[b] = win.next();  // j = 0 .. 3K-1

  // rows [0, head): slots below the window; [head, body): every slot inside
  // it; [body, steps): slots past its end
  const int32_t head = min(K, steps);
  const int32_t body = max(head, min(steps, W - 3 * K));
  int32_t i = 0;
  for (; i < head; ++i) checked_row<K>(s, win, rrow[i], i, W);
  if constexpr (K <= kMaxUnrolledK) {
    for (; i + BAND <= body; i += BAND)
      body_rows<K>(s, win, rrow, i, std::make_integer_sequence<int, BAND>{});
  }
  for (; i < body; ++i) {
    body_row<K, 0>(s, win, rrow, i);
#pragma unroll
    for (int b = 0; b < BAND - 1; ++b) s.wc[b] = s.wc[b + 1];
  }
  for (; i < steps; ++i) checked_row<K>(s, win, rrow[i], i, W);

  int32_t best = 0;
  int32_t best_b = 0;
#pragma unroll
  for (int b = 0; b < BAND; ++b) {
    const int32_t j_end = len + b - K;
    const int32_t df = (j_end >= 0 && j_end <= W) ? s.D[b] : kInf;
    if (b == 0 || df < best) {
      best = df;
      best_b = b;
    }
  }
  a.dist[q] = min(best, kInf);
  a.end_b[q] = best_b;
}

// The exclusive prefix min over the group's threads of v (kBig for the
// group's first thread).
__device__ __forceinline__ int32_t carried_min(int32_t v, int j, int G) {
  for (int d = 1; d < G; d <<= 1) {
    const int32_t o = __shfl_up_sync(kFull, v, d, G);
    if (j >= d) v = min(v, o);
  }
  const int32_t c = __shfl_up_sync(kFull, v, 1, G);
  return j == 0 ? kBig : c;
}

// k > kMaxGroupK: a warp a lane, a.slots band slots a thread, D in scratch
// (two rows in turn; slot register s of thread j at s * 32 + j).
template <bool kText>
__global__ void __launch_bounds__(kThreads) banded_mem_kernel(const Args a) {
  const int64_t gt = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t q = gt / 32;
  if (q >= a.Q) return;  // the whole warp
  const int32_t r = a.rid ? min(max(a.rid[q], 0), a.B - 1) : static_cast<int32_t>(q);
  const int8_t* rrow = a.reads + static_cast<int64_t>(r) * a.L;
  const int j = static_cast<int>(threadIdx.x) & 31;
  const int32_t K = a.k, BAND = 4 * K + 1, W = a.W, S = a.slots;
  const int32_t base = j * S - (32 * S - BAND);
  const int32_t len = a.lengths[r];
  const int32_t steps = min(len, a.L);
  typename std::conditional<kText, TextCodes, WindowCodes>::type cd;
  cd.init(a, q);
  int32_t* d_old = a.scratch + q * 64 * static_cast<int64_t>(S);
  int32_t* d_new = d_old + 32 * S;
  for (int32_t s = 0; s < S; ++s) {
    const int32_t b = base + s;
    d_old[s * 32 + j] = b < 0 ? kBig : (b >= K ? 0 : kInf);
  }
  __syncwarp();
  for (int32_t i = 0; i < steps; ++i) {
    const int32_t rc = static_cast<int32_t>(rrow[i]);
    int32_t run = kBig;
    for (int32_t s = 0; s < S; ++s) {
      const int32_t b = base + s;
      int32_t t = kBig;
      if (b >= 0) {
        const int32_t jp = i + b - K;
        if (static_cast<uint32_t>(jp) < static_cast<uint32_t>(W)) {
          const int32_t up = s + 1 < S ? d_old[(s + 1) * 32 + j] : (j < 31 ? d_old[j + 1] : kInf);
          const int32_t x = (cd.at(jp) ^ rc) & 0x1FF;
          const int32_t d = d_old[s * 32 + j];
          t = __viaddmin_s32(min(d, up), 1, d + x);
        } else {
          t = kInf;
        }
      }
      run = s == 0 ? t : __viaddmin_s32(run, 1, t);
      d_new[s * 32 + j] = run;
    }
    const int32_t cin = carried_min(run - (base + S - 1), j, 32);
    for (int32_t s = 0; s < S; ++s) d_new[s * 32 + j] = min(d_new[s * 32 + j], cin + base + s);
    __syncwarp();
    int32_t* t = d_old;
    d_old = d_new;
    d_new = t;
  }
  int32_t best = kBig, best_b = BAND;
  for (int32_t s = 0; s < S; ++s) {
    const int32_t b = base + s;
    const int32_t j_end = len + b - K;
    const int32_t df = (j_end >= 0 && j_end <= W) ? d_old[s * 32 + j] : kInf;
    if (b >= 0 && df < best) {
      best = df;
      best_b = b;
    }
  }
  write_best(a, q, j == 0, best, best_b, 32);
}

template <int K, bool kText>
int launch(const Args& a, cudaStream_t stream) {
  return gwa::launch_staged<int8_t>(banded_dp_kernel<K, kText>, a, 1, 0, stream);
}

int64_t slots_for(int32_t k) { return (4 * static_cast<int64_t>(k) + 1 + 31) / 32; }

template <bool kText>
int dispatch(int32_t k, Args a, int64_t scratch_words, cudaStream_t s) {
  switch (k) {
    case 0: return launch<0, kText>(a, s);
    case 1: return launch<1, kText>(a, s);
    case 2: return launch<2, kText>(a, s);
    case 3: return launch<3, kText>(a, s);
    case 4: return launch<4, kText>(a, s);
    case 5: return launch<5, kText>(a, s);
    case 6: return launch<6, kText>(a, s);
    case 7: return launch<7, kText>(a, s);
    case 8: return launch<8, kText>(a, s);
    case 9: return launch<9, kText>(a, s);
    case 10: return launch<10, kText>(a, s);
    case 11: return launch<11, kText>(a, s);
    case 12: return launch<12, kText>(a, s);
    case 13: return launch<13, kText>(a, s);
    case 14: return launch<14, kText>(a, s);
    case 15: return launch<15, kText>(a, s);
    case 16: return launch<16, kText>(a, s);
    default: break;
  }
  if (k < 0 || k >= kInf) return static_cast<int>(cudaErrorInvalidValue);
  a.k = k;
  if (k <= kMaxGroupK) return static_cast<int>(cudaErrorInvalidValue);  // banded_group.cu
  a.slots = static_cast<int32_t>(slots_for(k));
  if (!a.scratch || scratch_words < 64 * static_cast<int64_t>(a.slots) * a.Q)
    return static_cast<int>(cudaErrorInvalidValue);
  a.stage = 0;
  const unsigned blocks = static_cast<unsigned>((a.Q * 32 + kThreads - 1) / kThreads);
  banded_mem_kernel<kText><<<blocks, kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// text != null: the text entry (rid, starts, text over nw words of n_text
// bases; windows unused); else the windows entry (rid and starts null,
// B = Q).  Reads (B, L) int8, lengths (B,), dist and end_b (Q,) int32.
// Scratch words a launch over Q lanes at band half-width k needs (0 up to
// kMaxGroupK).
extern "C" int64_t gwa_banded_dp_scratch_words(int64_t Q, int32_t k) {
  return k <= kMaxGroupK ? 0 : 64 * slots_for(k) * Q;
}

extern "C" int gwa_banded_dp(const void* reads, const void* lengths, const void* rid,
                             const void* windows, const void* text, const void* starts,
                             void* dist, void* end_b, int64_t Q, int32_t B, int32_t L,
                             int32_t W, int32_t nw, int32_t n_text, int32_t k, void* scratch,
                             int64_t scratch_words, void* stream) {
  if (Q <= 0) return 0;
  if (B <= 0 || L < 0 || W < 0 || (text && nw <= 0)) return static_cast<int>(cudaErrorInvalidValue);
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
  a.scratch = static_cast<int32_t*>(scratch);
  auto s = static_cast<cudaStream_t>(stream);
  return text ? dispatch<true>(k, a, scratch_words, s) : dispatch<false>(k, a, scratch_words, s);
}
