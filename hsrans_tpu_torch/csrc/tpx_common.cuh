// Shared constants of the tpx kernels (the wire's, see hsrans_tpu/ops/tpx.py).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace tpx {

constexpr int kLanes = 128;                 // interleaved rANS states per row
constexpr int kWarps = 4;                   // rows (one warp each) per block
constexpr int kGroupPositions = 4 * kLanes; // wire bytes of one step group of a row (4 steps x 128 lanes)
constexpr unsigned kFullMask = 0xFFFFFFFFu;
constexpr uint32_t kConsumePoint = 1u << 15;  // DECODE_CONSUME_POINT_16

// A warp holds one row: thread j owns lanes j, j+32, j+64, j+96 (k = 0..3).
// Lane-ascending order over the row is (k, j) order, so the rank of lane
// j+32k among the row's flagged lanes is the flagged count of groups 0..k-1
// plus __popc(ballot_k & lanemask_lt) — the warp's replacement for the TPU
// kernels' triangular-matmul prefix sums.
__device__ __forceinline__ uint32_t lanemask_lt() {
  return (1u << (threadIdx.x & 31)) - 1u;
}

// The megablock of a one-launch kernel that CTA `cta` works on: the last of
// the n descriptors (ascending cta0, the first 0) whose cta0 is <= cta.  A
// mega of R rows takes ceil(R / kWarps) CTAs, so a CTA's warps lie in one
// mega.
template <typename Desc>
__device__ __forceinline__ int find_mega(const Desc* __restrict__ desc, int n, long long cta) {
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (desc[mid].cta0 <= cta) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo;
}

// The step groups of a row that hold data: `full` groups wholly below the
// mega's vlen, then, when rem > 0, one group whose first rem positions are.
// `left` is vlen less the wire position of the row's first byte.
struct GroupSpan {
  int full, rem;
};

__device__ __forceinline__ GroupSpan group_span(long long left, int s4c) {
  if (left <= 0) return {0, 0};
  if (left >= static_cast<long long>(s4c) * kGroupPositions) return {s4c, 0};
  return {static_cast<int>(left / kGroupPositions), static_cast<int>(left % kGroupPositions)};
}

}  // namespace tpx
