// Byte histograms of many segments, and their exact normalisation to 2^B,
// on Hopper: the histogram model of the encoders
// (hsrans_tpu_torch/models/device_hist.py).
//
// hist_count_kernel replaces hsrans_tpu/models/jax_hist.py::observe_device
// (a jnp.bincount per tile, which hsrans_tpu/kernels/tpx_encode.py's
// device_tables path calls once a tile); hist_normalize_kernel replaces
// ::normalize_device (the float32 scale and round, the heap sort, the steal
// and charity passes, lax loops per histogram).  Both are XLA in the JAX
// package, not Pallas.
//
// What bounds them: the count reads every byte of its segments once and
// writes 1 KB a segment: bound by memory traffic (64 MiB of input, 0.020 ms
// at 3.35 TB/s).  The normaliser reads 1 KB of counts and writes 1 KB of
// freqs and cumuls a row, also memory traffic, unless a row's rounded counts
// miss 2^B: then its fix-up is one heap sort of 256 entries, a serial chain
// of shared-memory loads on one lane, and a few passes over the sorted
// order.
//
// Design (count): the host cuts each segment into chunks of `chunk` bytes
// (one chunk for a segment of no bytes) and hands over one row (start, end,
// first chunk) a segment; one CTA a chunk, which finds its segment by a
// binary search over the rows' first chunks.  So the 16 tiles of a 64 MiB
// tpx call become 1,024 CTAs and the 16,384 4 KiB blocks of an mt call
// 16,384, and a 2^25-byte block 512.  Segments start at any byte: each CTA
// reads the 16-byte aligned middle of its chunk as uint4 loads, four in
// flight a thread, and its two ends byte by byte.  Each warp counts into its
// own 256-bin histogram in shared memory, so the shared atomics of skewed
// text (a few bins take most bytes) contend within a warp only; the CTA then
// sums its warps' bins.  A segment of one chunk stores its row; a chunk of a
// longer segment adds its non-zero bins to the row with global atomics (the
// wrapper zeroes the rows first).  An empty segment stores the 1-symbol
// count, bin 0 = 1, as ops/tpx.py::make_tile_hist takes it.
//
// Design (normalise): one warp a row, lane l holding bins 8l..8l+7.  The
// scale is mul = 2^B / divisor in float32, round to nearest, and each bin is
// count * mul + 0.5 with two roundings, as numpy computes it
// (models/histogram.py:73): the intrinsics keep nvcc from contracting the
// two into one FMA, which rounds once and would move a rare count by one.
// The result is truncated to a u16 and a present symbol gets at least 1.  If
// the warp's sum is 2^B the row is done (every mt block of 2^B bytes is: mul
// is exactly 1).  Otherwise lane 0 heap-sorts the 256 symbols by count in
// shared memory, sift-down with strict >, left child before right
// (hist.cpp:110-144): the sort is unstable and its tie order decides which
// of several equal counts is stolen from first, which the wire shows.  The
// steal and charity passes then run on the whole warp, as jax_hist.py's
// vectorised form has them: a pass starts at the first sorted position from
// the last start on whose count is >= 2 (a warp min), and takes one from
// (or gives one to) n consecutive sorted positions, n = min(256 - start,
// the sum's distance to 2^B), the last n positions for charity.  Counts
// wrap as u16s, as numpy's do.  Last, a warp scan gives the row's exclusive
// cumul mod 2^16, and each lane stores its 8 freqs and 8 cumuls as one
// 16-byte store each.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kCountWarps = 8;  // warps (and sub-histograms) per CTA of the count
constexpr int kCountThreads = kCountWarps * 32;
constexpr int kUnroll = 4;  // uint4 loads in flight a thread
constexpr int kNormWarps = 4;  // rows (one warp each) per CTA of the normaliser

struct Segment {  // kernels/../models/device_hist.py::segment_table
  long long start, end, chunk0;
};

__device__ __forceinline__ void count_word(uint32_t* h, uint32_t w) {
  atomicAdd(&h[w & 0xff], 1u);
  atomicAdd(&h[(w >> 8) & 0xff], 1u);
  atomicAdd(&h[(w >> 16) & 0xff], 1u);
  atomicAdd(&h[w >> 24], 1u);
}

__global__ void __launch_bounds__(kCountThreads)
hist_count_kernel(const uint8_t* __restrict__ data, const Segment* __restrict__ seg, int k, long long chunk,
                  uint32_t* __restrict__ counts) {
  __shared__ uint32_t sub[kCountWarps][256];
  const long long c = blockIdx.x;
  int lo = 0, hi = k - 1;  // the last segment whose first chunk is <= c
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (seg[mid].chunk0 <= c) lo = mid; else hi = mid - 1;
  }
  const Segment s = seg[lo];
  uint32_t* row = counts + 256LL * lo;
  const int t = threadIdx.x;
  if (s.end <= s.start) {  // the 1-symbol count of an empty segment
    for (int b = t; b < 256; b += kCountThreads) row[b] = b == 0;
    return;
  }
  const bool whole = s.end - s.start <= chunk;  // the segment is this chunk alone
  const long long a = s.start + (c - s.chunk0) * chunk;
  const long long e = min(a + chunk, s.end);
  for (int i = t; i < kCountWarps * 256; i += kCountThreads) (&sub[0][0])[i] = 0;
  __syncthreads();
  uint32_t* h = sub[t >> 5];
  const uintptr_t base = reinterpret_cast<uintptr_t>(data);
  long long m0 = static_cast<long long>(((base + a + 15) & ~uintptr_t(15)) - base);  // the aligned middle [m0, m1)
  long long m1 = static_cast<long long>(((base + e) & ~uintptr_t(15)) - base);
  if (m0 > m1) m0 = m1 = e;  // no whole 16 bytes: all of it byte by byte
  if (t < m0 - a) atomicAdd(&h[data[a + t]], 1u);
  if (t < e - m1) atomicAdd(&h[data[m1 + t]], 1u);
  const uint4* v = reinterpret_cast<const uint4*>(data + m0);
  const long long n16 = (m1 - m0) >> 4;
  for (long long i0 = t; i0 < n16; i0 += kUnroll * kCountThreads) {
    uint4 x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = i0 + u * kCountThreads;
      x[u] = i < n16 ? __ldg(v + i) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (i0 + u * kCountThreads < n16) {
        count_word(h, x[u].x);
        count_word(h, x[u].y);
        count_word(h, x[u].z);
        count_word(h, x[u].w);
      }
    }
  }
  __syncthreads();
  for (int b = t; b < 256; b += kCountThreads) {
    uint32_t sum = 0;
#pragma unroll
    for (int w = 0; w < kCountWarps; ++w) sum += sub[w][b];
    if (whole) row[b] = sum;
    else if (sum) atomicAdd(&row[b], sum);
  }
}

// hist.cpp's sift-down over the symbol indices `idx`, ordered by val[idx]
__device__ void sift_down(const uint32_t* val, uint8_t* idx, int n, int i) {
  while (true) {
    const int left = 2 * i + 1, right = 2 * i + 2;
    int largest = i;
    if (left < n && val[idx[left]] > val[idx[largest]]) largest = left;
    if (right < n && val[idx[right]] > val[idx[largest]]) largest = right;
    if (largest == i) return;
    const uint8_t x = idx[i];
    idx[i] = idx[largest];
    idx[largest] = x;
    i = largest;
  }
}

// the first sorted position p >= start whose count is >= 2, else start
__device__ __forceinline__ int min_two(const uint32_t* val, const uint8_t* ord, int start, int lane) {
  unsigned first = 256;
#pragma unroll
  for (int j = 7; j >= 0; --j) {
    const int p = 8 * lane + j;
    if (p >= start && val[ord[p]] >= 2) first = p;
  }
  first = __reduce_min_sync(kFullMask, first);
  return first == 256 ? start : static_cast<int>(first);
}

__global__ void __launch_bounds__(kNormWarps * 32)
hist_normalize_kernel(const uint32_t* __restrict__ counts, const long long* __restrict__ divisors, int k, int bits,
                      uint16_t* __restrict__ freq, uint16_t* __restrict__ cumul) {
  __shared__ uint32_t vals[kNormWarps][256];
  __shared__ uint8_t ords[kNormWarps][256];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long r = static_cast<long long>(blockIdx.x) * kNormWarps + w;
  if (r >= k) return;
  const int total = 1 << bits;
  const float mul = __fdiv_rn(static_cast<float>(total), __uint2float_rn(static_cast<uint32_t>(divisors[r])));
  const uint4* src = reinterpret_cast<const uint4*>(counts + 256 * r + 8 * lane);
  const uint4 c0 = src[0], c1 = src[1];
  const uint32_t c[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
  uint32_t cap[8];
  int sum = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint32_t v = __float2uint_rz(__fadd_rn(__fmul_rn(__uint2float_rn(c[i]), mul), 0.5f)) & 0xffffu;
    if (v == 0 && c[i] != 0) v = 1;
    cap[i] = v;
    sum += static_cast<int>(v);
  }
  sum = __reduce_add_sync(kFullMask, sum);
  if (sum != total) {
    uint32_t* val = vals[w];
    uint8_t* ord = ords[w];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      val[8 * lane + i] = cap[i];
      ord[8 * lane + i] = static_cast<uint8_t>(8 * lane + i);
    }
    __syncwarp();
    if (lane == 0) {  // hist.cpp:110-144, serial: its tie order is on the wire
      for (int i = 127; i >= 0; --i) sift_down(val, ord, 256, i);
      for (int i = 255; i >= 0; --i) {
        const uint8_t x = ord[0];
        ord[0] = ord[i];
        ord[i] = x;
        sift_down(val, ord, i, 0);
      }
    }
    __syncwarp();
    int mt = 0;
    while (sum > total) {  // steal: one from each of n sorted positions from mt on
      mt = min_two(val, ord, mt, lane);
      const int n = min(256 - mt, sum - total);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int p = 8 * lane + j;
        if (p >= mt && p < mt + n) val[ord[p]] = (val[ord[p]] - 1) & 0xffffu;
      }
      __syncwarp();
      sum -= n;
    }
    while (sum < total) {  // charity: one to each of the last n sorted positions
      mt = min_two(val, ord, mt, lane);
      const int n = min(256 - mt, total - sum);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int p = 8 * lane + j;
        if (p >= 256 - n) val[ord[p]] = (val[ord[p]] + 1) & 0xffffu;
      }
      __syncwarp();
      sum += n;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) cap[i] = val[8 * lane + i];
  }
  uint32_t local = 0, ex[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    ex[i] = local;
    local += cap[i];
  }
  uint32_t incl = local;  // inclusive scan of the lanes' sums
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t y = __shfl_up_sync(kFullMask, incl, d);
    if (lane >= d) incl += y;
  }
  const uint32_t before = incl - local;
  uint4 f, q;
  f.x = cap[0] | cap[1] << 16;
  f.y = cap[2] | cap[3] << 16;
  f.z = cap[4] | cap[5] << 16;
  f.w = cap[6] | cap[7] << 16;
  uint32_t cu[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) cu[i] = (before + ex[i]) & 0xffffu;
  q.x = cu[0] | cu[1] << 16;
  q.y = cu[2] | cu[3] << 16;
  q.z = cu[4] | cu[5] << 16;
  q.w = cu[6] | cu[7] << 16;
  reinterpret_cast<uint4*>(freq + 256 * r)[lane] = f;
  reinterpret_cast<uint4*>(cumul + 256 * r)[lane] = q;
}

}  // namespace

extern "C" int hsr_hist_count(const void* data, const void* segments, int k, long long chunks, long long chunk,
                              void* counts, void* cuda_stream) {
  if (k <= 0) return 0;
  if (chunks <= 0 || chunks > 0x7fffffffLL || chunk < 16) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t cs = static_cast<cudaStream_t>(cuda_stream);
  hist_count_kernel<<<static_cast<unsigned>(chunks), kCountThreads, 0, cs>>>(
      static_cast<const uint8_t*>(data), static_cast<const Segment*>(segments), k, chunk,
      static_cast<uint32_t*>(counts));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hsr_hist_normalize(const void* counts, const void* divisors, int k, int bits, void* freq, void* cumul,
                                  void* cuda_stream) {
  if (k <= 0) return 0;
  const bool aligned =
      (reinterpret_cast<uintptr_t>(counts) | reinterpret_cast<uintptr_t>(freq) | reinterpret_cast<uintptr_t>(cumul)) %
          16 == 0;
  if (bits < 1 || bits > 15 || !aligned) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t cs = static_cast<cudaStream_t>(cuda_stream);
  const int blocks = (k + kNormWarps - 1) / kNormWarps;
  hist_normalize_kernel<<<blocks, kNormWarps * 32, 0, cs>>>(
      static_cast<const uint32_t*>(counts), static_cast<const long long*>(divisors), k, bits,
      static_cast<uint16_t*>(freq), static_cast<uint16_t*>(cumul));
  return static_cast<int>(cudaGetLastError());
}
