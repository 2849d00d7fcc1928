// A warp's window of a global byte array in shared memory, filled ahead of
// use by cp.async (the mt kernels' stream words and input bytes).
//
// The window is a ring of two halves.  Byte p of the array (a global byte
// offset) sits at window position p - base, where base is the first byte a
// block reads rounded down to a 16-byte address, and position r at ring byte
// r % (2 * half).  A fill copies one half: 16 bytes a thread, the 32 threads
// of the warp striding over its chunks.  A byte outside [0, hi) reads as 0,
// so the window keeps the kernels' clamp of every read to a block's region.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace window {

// 16 bytes from global `src` (16-byte aligned) to shared `dst`; the first
// `valid` bytes are copied and the rest are zero (cp.async's zero-fill form)
__device__ __forceinline__ void copy16(void* dst, const void* src, int valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(valid) : "memory");
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// every copy this thread issued has landed; the caller then __syncwarp()s so
// that each lane sees the other lanes' copies
__device__ __forceinline__ void wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// Fills `dst` (kHalf bytes of shared memory, 16-byte aligned) with the bytes
// [p0, p0 + kHalf) of `src`, each one outside [0, hi) as 0; (src + p0) is
// 16-byte aligned.  One warp, thread j; commits one group of copies.  Chunks
// wholly inside [0, hi) and those cut by hi go by cp.async; a chunk wholly
// past hi is stored as zeros; a chunk below byte 0 (a corrupt index only)
// goes byte by byte.
template <int kHalf>
__device__ __forceinline__ void fill(uint8_t* dst, const uint8_t* src, long long p0, long long hi, int j) {
  static_assert(kHalf % (16 * 32) == 0, "a half is a whole number of 16-byte chunks for each thread");
#pragma unroll
  for (int i = 0; i < kHalf / (16 * 32); ++i) {
    const int q = j + 32 * i;
    const long long at = p0 + 16 * q;
    uint8_t* d = dst + 16 * q;
    if (at < 0) {
      for (int k = 0; k < 16; ++k) d[k] = at + k >= 0 && at + k < hi ? src[at + k] : 0;
    } else if (at >= hi) {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    } else {
      copy16(d, src + at, static_cast<int>(min(hi - at, 16LL)));
    }
  }
  commit();
}

// the window position of `p`'s 16-byte aligned floor: base = p - phase(src, p)
__device__ __forceinline__ int phase(const void* src, long long p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(src) + static_cast<unsigned long long>(p)) & 15u);
}

}  // namespace window
