// Myers bit-parallel semi-global edit distance on Hopper (sm_90a), one
// thread per lane.
//
// Replaces the Pallas TPU kernel genome_weaver_align_tpu/ops/myers_pallas.py::_kernel
// and computes exactly genome_weaver_align_tpu_torch/ops/myers.py::myers_semiglobal_end
// (itself the twin of genome_weaver_align_tpu/ops/myers.py::myers_semiglobal_end):
// the read is a column bit-vector of NW 32-bit words (NW = 1..8, reads of at
// most 256 bases); each window step runs the search-variant recurrence
// (Myers 1999 / Hyyro 2003) with a free text start; window codes >= 4 have
// Peq = 0; the score row is one bit test on the word that holds bit len-1;
// best starts at len and end is the exclusive end of the first strict
// improvement, so a zero-length lane gives (0, 0).  Exactly `steps` window
// columns are consumed (a step past the row reads its last column, as the
// plain loop does); nothing is padded to the TPU's 8-step chunks.
//
// Layout: the logical (Q, L) reads, (Q,) int32 lengths and (Q, W) windows
// (int8 or int32, both the same), read as they are.  The TPU kernel's
// transposed eq/window planes, 512-lane tiles and sublane Kogge-Stone carry
// scan existed for Mosaic's (8, 128) tiling and are not carried over: here
// PV, MV, the 4 x NW Peq words and the score-row mask live in registers
// (about 8 NW + 10 of them), built from the lane's own read row, and the
// add carry runs serially over the NW words through a 64-bit sum.
//
// Bound: the window bytes and the serial dependency of the steps.  Each
// thread walks its own window row, one code per step, so neighbouring
// threads load bytes W apart: the loads are uncoalesced and each 32-byte
// sector fetched serves one lane.  The least arithmetic is 11 integer
// instructions a read word a step (the Peq pick, Eq | MV, Eq & PV, the
// carried add, the xor-or, HN, HP, the two carried shifts, MV, PV) and 5 a
// step for the score (two bit tests, the add, the compare and the select
// of best and end), which the card's integer units cover many times over at
// the rescue shape.  A later
// version stages window tiles through shared memory with coalesced 16-byte
// loads, or packs the windows 2 bits a base.
//
// Entry: gwa_myers, a plain C function bound with ctypes.  It launches on
// the caller's stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() after the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

template <int NW, typename T>
__global__ void __launch_bounds__(128) myers_kernel(
    const T* __restrict__ reads, const int32_t* __restrict__ lengths,
    const T* __restrict__ windows, int32_t* __restrict__ best_out,
    int32_t* __restrict__ end_out, int64_t Q, int32_t L, int32_t W,
    int32_t steps) {
  const int64_t q = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (q >= Q) return;
  const T* r = reads + q * L;
  const T* w = windows + q * W;
  const int32_t len = lengths[q];
  const int32_t n_in = len < L ? len : L;

  // Peq[c][word]: bit b of word v set iff read[32 v + b] == c (i < len)
  uint32_t eq0[NW], eq1[NW], eq2[NW], eq3[NW], lmask[NW];
  const int32_t last = len - 1;
#pragma unroll
  for (int v = 0; v < NW; ++v) {
    uint32_t m0 = 0, m1 = 0, m2 = 0, m3 = 0;
    const int32_t base = 32 * v;
    const int32_t hi = n_in - base < 32 ? n_in - base : 32;
    for (int32_t b = 0; b < hi; ++b) {
      const int32_t c = static_cast<int32_t>(r[base + b]);
      const uint32_t bit = 1u << b;
      m0 |= c == 0 ? bit : 0u;
      m1 |= c == 1 ? bit : 0u;
      m2 |= c == 2 ? bit : 0u;
      m3 |= c == 3 ? bit : 0u;
    }
    eq0[v] = m0;
    eq1[v] = m1;
    eq2[v] = m2;
    eq3[v] = m3;
    lmask[v] = (last >= 0 && (last >> 5) == v) ? (1u << (last & 31)) : 0u;
  }

  uint32_t pv[NW], mv[NW];
#pragma unroll
  for (int v = 0; v < NW; ++v) {
    pv[v] = 0xFFFFFFFFu;
    mv[v] = 0u;
  }
  int32_t score = len, best = len, end = 0;

  for (int32_t t = 0; t < steps; ++t) {
    const int32_t c = static_cast<int32_t>(w[t < W ? t : W - 1]);
    uint32_t up = 0u, dn = 0u;
    uint32_t carry = 0u;  // of the multi-word add (Peq & PV) + PV
    uint32_t hp_in = 0u, hn_in = 0u;  // bits shifted in from the word below
#pragma unroll
    for (int v = 0; v < NW; ++v) {
      // a negative code reads Peq[0], as the plain version's clamp does
      const uint32_t peq = c >= 4 ? 0u
                         : c == 3 ? eq3[v]
                         : c == 2 ? eq2[v]
                         : c == 1 ? eq1[v]
                                  : eq0[v];
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
  best_out[q] = best;
  end_out[q] = end;
}

template <int NW, typename T>
void launch(const void* reads, const int32_t* lengths, const void* windows,
            int32_t* best, int32_t* end, int64_t Q, int32_t L, int32_t W,
            int32_t steps, cudaStream_t stream) {
  constexpr int kThreads = 128;
  const unsigned blocks = static_cast<unsigned>((Q + kThreads - 1) / kThreads);
  myers_kernel<NW, T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(reads), lengths, static_cast<const T*>(windows),
      best, end, Q, L, W, steps);
}

template <typename T>
int dispatch(const void* reads, const int32_t* lengths, const void* windows,
             int32_t* best, int32_t* end, int64_t Q, int32_t L, int32_t W,
             int32_t nwords, int32_t steps, cudaStream_t s) {
  switch (nwords) {
    case 1: launch<1, T>(reads, lengths, windows, best, end, Q, L, W, steps, s); break;
    case 2: launch<2, T>(reads, lengths, windows, best, end, Q, L, W, steps, s); break;
    case 3: launch<3, T>(reads, lengths, windows, best, end, Q, L, W, steps, s); break;
    case 4: launch<4, T>(reads, lengths, windows, best, end, Q, L, W, steps, s); break;
    case 5: launch<5, T>(reads, lengths, windows, best, end, Q, L, W, steps, s); break;
    case 6: launch<6, T>(reads, lengths, windows, best, end, Q, L, W, steps, s); break;
    case 7: launch<7, T>(reads, lengths, windows, best, end, Q, L, W, steps, s); break;
    case 8: launch<8, T>(reads, lengths, windows, best, end, Q, L, W, steps, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// elem_bytes: 1 for int8 reads and windows, 4 for int32.
extern "C" int gwa_myers(const void* reads, const void* lengths,
                         const void* windows, void* best, void* end, int64_t Q,
                         int32_t L, int32_t W, int32_t nwords, int32_t steps,
                         int32_t elem_bytes, void* stream) {
  if (Q <= 0) return 0;
  if (steps > 0 && W <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto* ln = static_cast<const int32_t*>(lengths);
  auto* b = static_cast<int32_t*>(best);
  auto* e = static_cast<int32_t*>(end);
  auto s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 1)
    return dispatch<int8_t>(reads, ln, windows, b, e, Q, L, W, nwords, steps, s);
  if (elem_bytes == 4)
    return dispatch<int32_t>(reads, ln, windows, b, e, Q, L, W, nwords, steps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
