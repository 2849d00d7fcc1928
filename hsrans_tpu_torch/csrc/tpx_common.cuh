// Shared constants of the tpx kernels (the wire's, see hsrans_tpu/ops/tpx.py).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace tpx {

constexpr int kLanes = 128;                 // interleaved rANS states per row
constexpr int kWarps = 4;                   // rows (one warp each) per block
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

}  // namespace tpx
