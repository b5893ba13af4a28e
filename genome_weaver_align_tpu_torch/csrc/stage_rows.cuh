// Staging of read rows in shared memory, shared by banded_dp.cu and myers.cu.
//
// A block's lanes read a contiguous run of rows of a (B, L) reads tensor
// (rid does not decrease after compact_lanes, and is the identity where a
// lane reads its own row), so the block copies that span into shared memory
// once, with 16-byte loads for its aligned middle and bytes for the ragged
// ends; each lane's row is then a shared-memory row.  A block whose lanes
// span more rows than it has threads copies each lane's row instead (a warp
// a row).  The caller gives at least blockDim.x * L * sizeof(T) + 16 bytes
// of dynamic shared memory, blockDim.x a multiple of 32, at most
// kMaxStageThreads.

#pragma once

#include <climits>
#include <cstdint>

namespace gwa {

constexpr int kMaxStageThreads = 128;

// Every thread of the block calls it, with r its lane's row and live false
// for a lane past the end; returns the lane's row in shared memory.
template <typename T>
__device__ __forceinline__ const T* stage_rows(const T* reads, int32_t L, int32_t r, bool live,
                                               unsigned char* smem) {
  __shared__ int32_t s_lo, s_hi;
  __shared__ int32_t s_rid[kMaxStageThreads];
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  if (tid == 0) {
    s_lo = INT_MAX;
    s_hi = INT_MIN;
  }
  s_rid[tid] = r;
  __syncthreads();
  const int32_t lo = __reduce_min_sync(0xFFFFFFFFu, live ? r : INT_MAX);
  const int32_t hi = __reduce_max_sync(0xFFFFFFFFu, live ? r : INT_MIN);
  if ((tid & 31) == 0) {
    atomicMin(&s_lo, lo);
    atomicMax(&s_hi, hi);
  }
  __syncthreads();
  const int32_t rlo = s_lo, rhi = s_hi;
  const int64_t row_bytes = static_cast<int64_t>(L) * sizeof(T);
  const unsigned char* src = reinterpret_cast<const unsigned char*>(reads);
  const unsigned char* row;
  if (rlo > rhi) {
    row = smem;  // no live lane in this block
  } else if (static_cast<int64_t>(rhi) - rlo < nt) {
    // one contiguous span [g0, g1); shared offset = address - base keeps
    // the middle's stores 16-byte aligned and the rows T-aligned
    using Addr = unsigned long long;
    constexpr Addr kAlign = 15;
    const Addr g0 = reinterpret_cast<Addr>(src + rlo * row_bytes);
    const Addr g1 = reinterpret_cast<Addr>(src + (rhi + 1) * row_bytes);
    const Addr base = g0 & ~kAlign;
    const Addr m0 = min((g0 + kAlign) & ~kAlign, g1);
    const Addr m1 = max(g1 & ~kAlign, m0);
    for (Addr g = g0 + tid; g < m0; g += nt)
      smem[g - base] = *reinterpret_cast<const unsigned char*>(g);
    for (Addr g = m0 + 16 * tid; g < m1; g += 16 * nt)
      *reinterpret_cast<uint4*>(smem + (g - base)) = __ldg(reinterpret_cast<const uint4*>(g));
    for (Addr g = m1 + tid; g < g1; g += nt)
      smem[g - base] = *reinterpret_cast<const unsigned char*>(g);
    row = smem + (g0 - base) + (r - rlo) * row_bytes;
  } else {
    const int warp = tid >> 5, lane = tid & 31;
    for (int t = warp; t < nt; t += nt / 32) {
      const T* s = reinterpret_cast<const T*>(src + s_rid[t] * row_bytes);
      T* d = reinterpret_cast<T*>(smem) + static_cast<int64_t>(t) * L;
      for (int32_t c = lane; c < L; c += 32) d[c] = s[c];
    }
    row = smem + tid * row_bytes;
  }
  __syncthreads();
  return reinterpret_cast<const T*>(row);
}

}  // namespace gwa
