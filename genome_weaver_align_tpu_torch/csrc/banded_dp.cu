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
//     registers (D, E = D + 1, and the band's window codes):
//        x    = (w ^ r) & 0x1FF                  LOP3: 0 iff the codes match
//        diag = min(D[b] + x, E[b])              DPX __viaddmin_s32
//        D[b] = min(diag, E_old[b+1], E_new[b-1]) DPX __vimin3_s32
//        E[b] = D[b] + 1                          IADD
//     A read code >= 4 needs no test: the window codes are 0..3 or 256 (an
//     out-of-text base, or a window byte >= 4), which no int8 read code
//     equals, and a negative read code matches only an equal window byte,
//     as in the plain version.  The row loop is split into a checked head
//     (i < k), an unchecked body (every slot's j inside the window; with the
//     default W >= L + 3k that is every later row), unrolled by 4k+1 rows so
//     that the band's window codes rotate by register renaming instead of
//     moves, and a checked tail for narrow windows.
//   So the kernel is bound by its integer issue rate: 4 instructions for
//   each of the (4k+1) cells of every live read row.
//   * k = 1..14, the aligner's whole range (k < 15: the 4-bit dist field).
//     The band's 3 (4k+1) registers reach 171 at k = 14; what ptxas spills
//     there, chip_smoke.py prints.
//
// Entry: gwa_banded_dp, a plain C function bound with ctypes.  It launches
// on the caller's stream, does not synchronise, allocates nothing, and
// returns the launch's CUDA error code.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <type_traits>
#include <utility>

#include "stage_rows.cuh"

namespace {

constexpr int32_t kInf = 1 << 20;
constexpr int32_t kNoMatch = 256;  // a window code no int8 read code equals
constexpr int kThreads = gwa::kMaxStageThreads;
// The body's rows are unrolled by 4k+1 for k up to this; a wider band runs
// its body one row at a time with the window codes shifted by moves, so
// that the (4k+1)^2-cell unrolled body of every k up to 14 (the aligner's
// k < 15) does not multiply the build time.
constexpr int kMaxUnrolledK = 8;

struct Args {
  const int8_t* reads;     // (B, L)
  const int32_t* lengths;  // (B,)
  const int32_t* rid;      // (Q,) the read of each lane; null: lane q reads row q
  const int8_t* windows;   // (Q, W) for the windows entry
  const uint32_t* text;    // (nw,) packed text for the text entry
  const int32_t* starts;   // (Q,) window starts for the text entry
  int32_t* dist;
  int32_t* end_b;
  int64_t Q;
  int32_t B, L, W, nw, n_text;
};

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

template <int K>
struct Band {
  static constexpr int kBand = 4 * K + 1;
  int32_t D[kBand];
  int32_t E[kBand];   // D + 1
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
    const int32_t ins = b + 1 < BAND ? s.E[b + 1] : kInf + 1;
    const int32_t t = valid ? min(__viaddmin_s32(s.D[b], x, s.E[b]), ins) : kInf;
    const int32_t d = b == 0 ? t : min(t, s.E[b - 1]);
    s.D[b] = d;
    s.E[b] = d + 1;
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
    const int32_t diag = __viaddmin_s32(s.D[b], x, s.E[b]);
    int32_t d;
    if (b == 0) {
      d = min(diag, s.E[1]);
    } else {
      d = __vimin3_s32(diag, b + 1 < BAND ? s.E[b + 1] : kInf + 1, s.E[b - 1]);
    }
    s.D[b] = d;
    s.E[b] = d + 1;
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
  const int64_t q = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const bool live = q < a.Q;
  int32_t r = 0;
  if (live) r = a.rid ? min(max(a.rid[q], 0), a.B - 1) : static_cast<int32_t>(q);
  const int8_t* rrow = gwa::stage_rows(a.reads, a.L, r, live, smem);
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
    s.E[b] = s.D[b] + 1;
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

size_t smem_bytes(int32_t L) { return static_cast<size_t>(kThreads) * L + 16; }

template <int K, bool kText>
int launch(const Args& a, cudaStream_t stream) {
  auto kernel = banded_dp_kernel<K, kText>;
  const size_t smem = smem_bytes(a.L);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const unsigned blocks = static_cast<unsigned>((a.Q + kThreads - 1) / kThreads);
  kernel<<<blocks, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool kText>
int dispatch(int32_t k, const Args& a, cudaStream_t s) {
  switch (k) {
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
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// text != null: the text entry (rid, starts, text over nw words of n_text
// bases; windows unused); else the windows entry (rid and starts null,
// B = Q).  Reads (B, L) int8, lengths (B,), dist and end_b (Q,) int32.
extern "C" int gwa_banded_dp(const void* reads, const void* lengths, const void* rid,
                             const void* windows, const void* text, const void* starts,
                             void* dist, void* end_b, int64_t Q, int32_t B, int32_t L,
                             int32_t W, int32_t nw, int32_t n_text, int32_t k, void* stream) {
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
  auto s = static_cast<cudaStream_t>(stream);
  return text ? dispatch<true>(k, a, s) : dispatch<false>(k, a, s);
}
