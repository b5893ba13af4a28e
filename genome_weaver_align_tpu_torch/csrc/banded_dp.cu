// Banded semi-global edit distance on Hopper (sm_90a), one thread per
// candidate lane.
//
// Replaces the Pallas TPU kernel genome_weaver_align_tpu/ops/dp_pallas.py::_kernel
// and computes exactly genome_weaver_align_tpu_torch/ops/dp.py::banded_edit_distance
// (itself the twin of genome_weaver_align_tpu/ops/dp.py::banded_edit_distance):
// band slot b at read row i is window position j = i + b - k; leading and
// trailing window bases are free; codes >= 4 never match; the window-deletion
// dependency is the serial running min along the band, so cells above INF
// (unreachable lanes) carry the same garbage as the plain version and
// end_b, the first argmin of the unclamped last row, agrees on every lane.
//
// Layout: the logical (Q, L) int8 reads, (Q,) int32 lengths and (Q, W) int8
// windows, read as they are.  The TPU kernel's transposes, pad-shift and
// 8-step aligned chunking existed only for Mosaic and are not carried over.
// The band's 4k+1 cells and the 4k+1 window codes it covers live in
// registers; each row loads one read code and one new window code.
//
// Bound: the bytes of reads and windows.  Each thread walks its own row, so
// neighbouring threads load bytes L (or W) apart: the loads are uncoalesced
// and each 32-byte sector fetched serves one lane.  A later version stages
// tiles of reads and windows through shared memory with coalesced 16-byte
// loads, or fuses the window gather from the 2-bit packed text so windows
// never reach device memory (ROADMAP queue 2 #1).
//
// Entry: gwa_banded_dp, a plain C function bound with ctypes.  It launches
// on the caller's stream, does not synchronise, allocates nothing, and
// returns cudaGetLastError() after the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kInf = 1 << 20;

template <int K>
__global__ void __launch_bounds__(128) banded_dp_kernel(
    const int8_t* __restrict__ reads, const int32_t* __restrict__ lengths,
    const int8_t* __restrict__ windows, int32_t* __restrict__ dist,
    int32_t* __restrict__ end_b, int64_t Q, int32_t L, int32_t W) {
  constexpr int BAND = 4 * K + 1;
  const int64_t q = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (q >= Q) return;
  const int8_t* r = reads + q * L;
  const int8_t* w = windows + q * W;
  const int32_t len = lengths[q];
  const int32_t steps = len < L ? len : L;

  int32_t D[BAND];
  int32_t wc[BAND];  // wc[b] = window code at j = i + b - K (4 off the window)
#pragma unroll
  for (int b = 0; b < BAND; ++b) D[b] = (b >= K) ? 0 : kInf;
#pragma unroll
  for (int b = 0; b < BAND - 1; ++b) {
    const int32_t j = b - K;
    wc[b] = (j >= 0 && j < W) ? static_cast<int32_t>(w[j]) : 4;
  }

  for (int32_t i = 0; i < steps; ++i) {
    {
      const int32_t j = i + BAND - 1 - K;
      wc[BAND - 1] = (j < W) ? static_cast<int32_t>(w[j]) : 4;
    }
    const int32_t rc = r[i];
    const bool rlive = rc < 4;
    int32_t run = 0;
#pragma unroll
    for (int b = 0; b < BAND; ++b) {
      const int32_t j = i + b - K;
      const bool valid = j >= 0 && j < W;
      const int32_t sub = (valid && rlive && wc[b] == rc) ? 0 : 1;
      const int32_t diag = D[b] + sub;
      // read insertion: slot b+1 of the previous row (still unmodified)
      const int32_t ins = (b + 1 < BAND ? D[b + 1] : kInf) + 1;
      const int32_t tmp = valid ? min(diag, ins) : kInf;
      // window deletion: serial running min along the band
      run = (b == 0) ? tmp : min(tmp, run + 1);
      D[b] = run;
    }
#pragma unroll
    for (int b = 0; b < BAND - 1; ++b) wc[b] = wc[b + 1];
  }

  int32_t best = 0;
  int32_t best_b = 0;
#pragma unroll
  for (int b = 0; b < BAND; ++b) {
    const int32_t j_end = len + b - K;
    const int32_t df = (j_end >= 0 && j_end <= W) ? D[b] : kInf;
    if (b == 0 || df < best) {
      best = df;
      best_b = b;
    }
  }
  dist[q] = min(best, kInf);
  end_b[q] = best_b;
}

template <int K>
void launch(const int8_t* reads, const int32_t* lengths, const int8_t* windows,
            int32_t* dist, int32_t* end_b, int64_t Q, int32_t L, int32_t W,
            cudaStream_t stream) {
  constexpr int kThreads = 128;
  const unsigned blocks = static_cast<unsigned>((Q + kThreads - 1) / kThreads);
  banded_dp_kernel<K><<<blocks, kThreads, 0, stream>>>(reads, lengths, windows,
                                                       dist, end_b, Q, L, W);
}

}  // namespace

extern "C" int gwa_banded_dp(const void* reads, const void* lengths,
                             const void* windows, void* dist, void* end_b,
                             int64_t Q, int32_t L, int32_t W, int32_t k,
                             void* stream) {
  if (Q <= 0) return 0;
  const auto* r = static_cast<const int8_t*>(reads);
  const auto* ln = static_cast<const int32_t*>(lengths);
  const auto* wn = static_cast<const int8_t*>(windows);
  auto* d = static_cast<int32_t*>(dist);
  auto* e = static_cast<int32_t*>(end_b);
  auto s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: launch<1>(r, ln, wn, d, e, Q, L, W, s); break;
    case 2: launch<2>(r, ln, wn, d, e, Q, L, W, s); break;
    case 3: launch<3>(r, ln, wn, d, e, Q, L, W, s); break;
    case 4: launch<4>(r, ln, wn, d, e, Q, L, W, s); break;
    case 5: launch<5>(r, ln, wn, d, e, Q, L, W, s); break;
    case 6: launch<6>(r, ln, wn, d, e, Q, L, W, s); break;
    case 7: launch<7>(r, ln, wn, d, e, Q, L, W, s); break;
    case 8: launch<8>(r, ln, wn, d, e, Q, L, W, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
