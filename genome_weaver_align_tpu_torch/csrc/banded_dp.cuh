// The banded DP's shared definitions (banded_dp.cu: one thread a lane up to
// k = 16 and a warp over scratch past 127; banded_group.cu: a group of
// threads a lane for k = 17..127, its own source so that the two build in
// parallel): the launch arguments, the sentinels, the group's argmin and
// its size.  No kernel.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "stage_rows.cuh"

namespace gwa {
namespace banded {

constexpr int32_t kInf = 1 << 20;
constexpr int32_t kNoMatch = 256;  // a window code no int8 read code equals
constexpr int kThreads = kMaxStageThreads;
constexpr uint32_t kFull = 0xFFFFFFFFu;
constexpr int32_t kBig = 1 << 30;        // a padding slot's D: above every real cell
constexpr int kSlots = 16;               // the most band slots a thread of a group takes
constexpr int32_t kMaxGroupK = 127;      // 32 threads x 16 slots >= 4k + 1

struct Args {
  const int8_t* reads;     // (B, L)
  const int32_t* lengths;  // (B,)
  const int32_t* rid;      // (Q,) the read of each lane; null: lane q reads row q
  const int8_t* windows;   // (Q, W) for the windows entry
  const uint32_t* text;    // (nw,) packed text for the text entry
  const int32_t* starts;   // (Q,) window starts for the text entry
  int32_t* dist;
  int32_t* end_b;
  int32_t* scratch;        // 2 x 32 x slots words a lane for k > kMaxGroupK
  int64_t Q;
  int32_t B, L, W, nw, n_text;
  int32_t k, group, slots;  // band half-width; threads a lane; slots a thread
  int32_t stage;            // rows staged in shared memory (else read from global memory)
};

// The group's first argmin of (value, slot) over the last row, written by
// thread 0 of the group (`mask`: the group's lanes).
__device__ __forceinline__ void write_best(const Args& a, int64_t q, bool out, int32_t best,
                                           int32_t best_b, int G, unsigned mask = kFull) {
  unsigned long long key = (static_cast<unsigned long long>(static_cast<uint32_t>(best)) << 32) |
                           static_cast<uint32_t>(best_b);
  for (int d = G / 2; d >= 1; d >>= 1) {
    const unsigned long long other = __shfl_xor_sync(mask, key, d, G);
    key = other < key ? other : key;
  }
  if (out) {
    a.dist[q] = min(static_cast<int32_t>(key >> 32), kInf);
    a.end_b[q] = static_cast<int32_t>(key & 0xFFFFFFFFu);
  }
}

// Threads a lane for k = 17..kMaxGroupK: the power of two whose kSlots-slot
// threads cover the band (8..32); each thread then takes ceil((4k + 1) /
// G) slots, 9..16.
inline int group_for(int32_t k) {
  int g = 1;
  while (g * kSlots < 4 * k + 1) g *= 2;
  return g;
}

}  // namespace banded
}  // namespace gwa
