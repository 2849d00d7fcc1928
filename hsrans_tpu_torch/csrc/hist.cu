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
// writes 1 KB a segment: memory traffic (64 MiB of input, 0.020 ms at 3.35
// TB/s), and the shared-memory atomics of skewed text, one a byte.  On many
// short segments (an mt call's 16,384 blocks of 4 KiB) a CTA a segment would
// pay its fixed work (zero 8 KB, two barriers, an 8-way sum, a 1 KB store)
// for one 16-byte load a thread.  The normaliser reads 1 KB of counts and
// writes 1 KB of freqs and cumuls a row, also memory traffic, unless a row's
// rounded counts miss 2^B: then its fix-up is hist.cpp's heap sort of 256
// entries, a serial chain whose every level waits on a shared-memory load.
//
// Design (count): the host sorts the segments into a table of four columns
// (start, end, row, first chunk; models/device_hist.py::segment_table,
// columns so that the host fills them with contiguous copies, in the same
// pinned buffer as the normaliser's divisors): first the short ones,
// up to COUNT_WARP_MAX bytes (16 KiB) and the empty ones, then the long ones.
// One launch: the first ceil(short / 8) CTAs give each short segment one
// warp, which zeroes its own 256 bins in shared memory, reads the 16-byte
// aligned middle of its bytes as uint4 loads, four in flight a lane (eight
// took more registers and ran slower), and its two ends byte by byte, counts
// with shared atomics, and stores its row as 16-byte stores: no CTA barrier,
// no cross-warp sum, no global atomic.  The CTAs after them cut each long
// segment into 64 KiB chunks, a CTA each, which finds its segment by a
// binary search over the first chunks; its warps count into their own
// sub-histograms (the atomics of skewed text contend within a warp only),
// the CTA sums them, and a segment of one chunk stores its row while a chunk
// of a longer one adds its non-zero bins with global atomics.  Those rows
// alone are zeroed first, by a small kernel in the same stream (a ticket
// among the chunks, the first zeroing the row inside the launch, was no
// faster on one segment of 512 chunks, which contend for the ticket: see
// PERF.md); every other row is written whole, so the wrapper allocates the
// counts uninitialised.
// An empty segment stores the 1-symbol count, bin 0 = 1, as
// ops/tpx.py::make_tile_hist takes it.
//
// Design (normalise): one warp a row, lane l holding bins 8l..8l+7.  The
// scale is mul = 2^B / divisor in float32, round to nearest, and each bin is
// count * mul + 0.5 with two roundings, as numpy computes it
// (models/histogram.py:73): the intrinsics keep nvcc from contracting the
// two into one FMA, which rounds once and would move a rare count by one.
// The result is truncated to a u16 and a present symbol gets at least 1.  If
// the warp's sum is 2^B the row is done (every mt block of 2^B bytes is: mul
// is exactly 1).  Otherwise the row is heap-sorted in shared memory exactly
// as hist.cpp:110-144 sorts it (sift-down with strict >, left child before
// right: the sort is unstable and its tie order decides which of several
// equal counts is stolen from first, which the wire shows):
//   * each entry is one u32 key, count << 8 | symbol, compared by count
//     alone (a whole-word compare would break ties by symbol), so a level of
//     a sift is one 64-bit load of both children, not an index load and then
//     a value load; a sift step issues the children's and the
//     grandchildren's loads together and decides two levels;
//   * a sift keeps the sinking key in a register and moves each larger child
//     up into the hole, one store a level, the permutation of the swaps;
//   * the heapify runs by depth, deepest first, one lane a node: the nodes of
//     one depth head disjoint subtrees, so this is the serial loop's result
//     in 8 warp-synchronous rounds;
//   * the extraction stays serial on lane 0, and stops once the sorted
//     positions from the first count >= 2 up are placed: the steal and
//     charity passes touch no position below it, and the entries left there
//     are the counts of 0 and 1 (all 256 are sorted when no count reaches 2).
// The passes then run on the warp over the sorted keys in registers, as
// jax_hist.py's vectorised form has them: a pass starts at the first sorted
// position from the last start on whose count is >= 2 (a warp min), and
// takes one from (or gives one to) n consecutive sorted positions, n =
// min(256 - start, the sum's distance to 2^B), the last n positions for
// charity.  Counts wrap as u16s, as numpy's do.  Last, a warp scan gives the
// row's exclusive cumul mod 2^16, and each lane stores its 8 freqs and 8
// cumuls as one 16-byte store each.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kCountWarps = 8;  // warps (and sub-histograms) per CTA of the count
constexpr int kCountThreads = kCountWarps * 32;
constexpr int kChunkUnroll = 4;  // uint4 loads in flight a thread of a chunk's CTA
constexpr int kWarpUnroll = 4;   // uint4 loads in flight a lane of a short segment's warp
constexpr int kNormWarps = 4;    // rows (one warp each) per CTA of the normaliser
constexpr int kHeapWords = 260;  // a warp's heap: 256 keys from word 1 (odd nodes 8-byte aligned), padding

struct Segments {  // the columns of models/device_hist.py::segment_table, k long each
  const long long *start, *end, *row, *chunk0;
};

__device__ __forceinline__ void count_word(uint32_t* h, uint32_t w) {
  atomicAdd(&h[w & 0xff], 1u);
  atomicAdd(&h[(w >> 8) & 0xff], 1u);
  atomicAdd(&h[(w >> 16) & 0xff], 1u);
  atomicAdd(&h[w >> 24], 1u);
}

// Counts data[a, e) into the shared histogram h, thread t of kThreads (>= 16):
// the 16-byte aligned middle as uint4 loads, kU in flight a thread, the
// ends byte by byte.
template <int kThreads, int kU>
__device__ __forceinline__ void count_range(uint32_t* h, const uint8_t* __restrict__ data, long long a, long long e,
                                            int t) {
  const uintptr_t base = reinterpret_cast<uintptr_t>(data);
  long long m0 = static_cast<long long>(((base + a + 15) & ~uintptr_t(15)) - base);  // the aligned middle [m0, m1)
  long long m1 = static_cast<long long>(((base + e) & ~uintptr_t(15)) - base);
  if (m0 > m1) m0 = m1 = e;  // no whole 16 bytes: all of it byte by byte
  if (t < m0 - a) atomicAdd(&h[data[a + t]], 1u);
  if (t < e - m1) atomicAdd(&h[data[m1 + t]], 1u);
  const uint4* v = reinterpret_cast<const uint4*>(data + m0);
  const long long n16 = (m1 - m0) >> 4;
  for (long long i0 = t; i0 < n16; i0 += kU * kThreads) {
    uint4 x[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const long long i = i0 + u * kThreads;
      x[u] = i < n16 ? __ldg(v + i) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (i0 + u * kThreads < n16) {
        count_word(h, x[u].x);
        count_word(h, x[u].y);
        count_word(h, x[u].z);
        count_word(h, x[u].w);
      }
    }
  }
}

__global__ void hist_zero_kernel(Segments seg, int n_short, long long chunk, uint32_t* __restrict__ counts) {
  const int i = n_short + blockIdx.x;  // a long segment: its chunks add into its row only if it has several
  if (seg.end[i] - seg.start[i] > chunk)
    reinterpret_cast<uint4*>(counts + 256LL * seg.row[i])[threadIdx.x] = make_uint4(0, 0, 0, 0);
}

__global__ void __launch_bounds__(kCountThreads)
hist_count_kernel(const uint8_t* __restrict__ data, Segments seg, int n_short, int n_long, int short_ctas,
                  long long chunk, uint32_t* __restrict__ counts) {
  __shared__ __align__(16) uint32_t sub[kCountWarps][256];
  const int t = threadIdx.x, w = t >> 5, lane = t & 31;
  if (static_cast<int>(blockIdx.x) < short_ctas) {  // one warp a short segment
    const long long i = static_cast<long long>(blockIdx.x) * kCountWarps + w;
    if (i >= n_short) return;
    const long long a = seg.start[i], e = seg.end[i];
    uint4* row = reinterpret_cast<uint4*>(counts + 256LL * seg.row[i]) + 2 * lane;
    uint4* hv = reinterpret_cast<uint4*>(sub[w]) + 2 * lane;
    const uint4 zero = make_uint4(0, 0, 0, 0);
    if (e <= a) {  // the 1-symbol count of an empty segment
      row[0] = make_uint4(lane == 0, 0, 0, 0);
      row[1] = zero;
      return;
    }
    hv[0] = zero;
    hv[1] = zero;
    __syncwarp();
    count_range<32, kWarpUnroll>(sub[w], data, a, e, lane);
    __syncwarp();
    row[0] = hv[0];
    row[1] = hv[1];
    return;
  }
  const long long c = static_cast<long long>(blockIdx.x) - short_ctas;  // one CTA a chunk of a long segment
  int lo = n_short, hi = n_short + n_long - 1;  // the last long segment whose first chunk is <= c
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (seg.chunk0[mid] <= c) lo = mid; else hi = mid - 1;
  }
  const long long start = seg.start[lo], end = seg.end[lo];
  uint32_t* row = counts + 256LL * seg.row[lo];
  const bool whole = end - start <= chunk;  // the segment is this chunk alone
  const long long a = start + (c - seg.chunk0[lo]) * chunk;
  const long long e = min(a + chunk, end);
  for (int i = t; i < kCountWarps * 256; i += kCountThreads) (&sub[0][0])[i] = 0;
  __syncthreads();
  count_range<kCountThreads, kChunkUnroll>(sub[w], data, a, e, t);
  __syncthreads();
  for (int b = t; b < 256; b += kCountThreads) {
    uint32_t sum = 0;
#pragma unroll
    for (int k = 0; k < kCountWarps; ++k) sum += sub[k][b];
    if (whole) row[b] = sum;
    else if (sum) atomicAdd(&row[b], sum);
  }
}

__device__ __forceinline__ uint2 pair_at(const uint32_t* h, int l) {  // nodes l, l + 1; l odd: 8-byte aligned
  return *reinterpret_cast<const uint2*>(h + l);
}

// hist.cpp's sift-down of `key` from node i of the n-key heap h, by count
// alone, strict >, left child before right, with a hole: each larger child
// moves up, the key is stored once where it stops.  That is: follow the
// larger child (the left one unless the right one's count is larger) while
// its count is larger than the key's.  Counts are compared as a > (b |
// 0xff): b's symbol bits at their maximum, so a tie of counts never wins and
// the symbols never decide.  Each step loads a node's children and both
// children's children together (three 64-bit loads, the unused one clamped
// inside the heap) and decides two levels.  Returns the key that ends at
// node i.
__device__ __forceinline__ uint32_t sift_down(uint32_t* h, int n, int i, uint32_t key) {
  const uint32_t kv = key | 0xffu;
  const int i0 = i;
  uint32_t at_i0 = key;
  for (int l = 2 * i + 1; l < n; l = 2 * i + 1) {
    const uint2 c = pair_at(h, l), g0 = pair_at(h, min(2 * l + 1, 255)), g1 = pair_at(h, min(2 * l + 3, 255));
    const bool right = l + 1 < n && c.y > (c.x | 0xffu);
    const uint32_t mk = right ? c.y : c.x;
    if (mk <= kv) break;
    h[i] = mk;
    if (i == i0) at_i0 = mk;
    i = l + right;
    const int l2 = 2 * i + 1;  // the next level, from the children's children already loaded
    if (l2 >= n) break;
    const uint2 g = right ? g1 : g0;
    const bool right2 = l2 + 1 < n && g.y > (g.x | 0xffu);
    const uint32_t mk2 = right2 ? g.y : g.x;
    if (mk2 <= kv) break;
    h[i] = mk2;
    i = l2 + right2;
  }
  h[i] = key;
  return at_i0;
}

__device__ __forceinline__ uint32_t bump(uint32_t key, uint32_t d) {  // count + d as a u16, the symbol kept
  return (((key >> 8) + d) & 0xffffu) << 8 | (key & 0xffu);
}

// the first sorted position p >= start whose count is >= 2, else start
__device__ __forceinline__ int min_two(const uint32_t (&key)[8], int start, int lane) {
  unsigned first = 256;
#pragma unroll
  for (int j = 7; j >= 0; --j) {
    const int p = 8 * lane + j;
    if (p >= start && (key[j] >> 8) >= 2) first = p;
  }
  first = __reduce_min_sync(kFullMask, first);
  return first == 256 ? start : static_cast<int>(first);
}

__global__ void __launch_bounds__(kNormWarps * 32)
hist_normalize_kernel(const uint32_t* __restrict__ counts, const long long* __restrict__ divisors, int k, int bits,
                      uint16_t* __restrict__ freq, uint16_t* __restrict__ cumul) {
  __shared__ __align__(16) uint32_t heaps[kNormWarps][kHeapWords];
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
    uint32_t* h = heaps[w] + 1;  // node p at word p + 1
    int small = 0;               // counts of 0 and 1, which sort below every position the passes touch
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      h[8 * lane + i] = cap[i] << 8 | static_cast<uint32_t>(8 * lane + i);
      small += cap[i] <= 1;
    }
    small = __reduce_add_sync(kFullMask, small);
    __syncwarp();
    for (int d = 7; d >= 0; --d) {  // heapify, deepest depth first: hist.cpp's for (i = 127; i >= 0; --i)
      const int first = (1 << d) - 1, last = min(2 * first + 1, 128);
      for (int i = first + lane; i < last; i += 32) sift_down(h, 256, i, h[i]);
      __syncwarp();
    }
    if (lane == 0) {  // the extraction, serial: its tie order is on the wire
      const int lo = small == 256 ? 1 : max(small, 1);
      uint32_t root = h[0];
      for (int i = 255; i >= lo; --i) {
        const uint32_t last = h[i];
        h[i] = root;
        root = sift_down(h, i, 0, last);
      }
    }
    __syncwarp();
    uint32_t key[8];  // sorted positions 8 lane .. 8 lane + 7
#pragma unroll
    for (int j = 0; j < 8; ++j) key[j] = h[8 * lane + j];
    int mt = 0;
    while (sum > total) {  // steal: one from each of n sorted positions from mt on
      mt = min_two(key, mt, lane);
      const int n = min(256 - mt, sum - total);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int p = 8 * lane + j;
        if (p >= mt && p < mt + n) key[j] = bump(key[j], 0xffffu);
      }
      sum -= n;
    }
    while (sum < total) {  // charity: one to each of the last n sorted positions
      mt = min_two(key, mt, lane);
      const int n = min(256 - mt, total - sum);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (8 * lane + j >= 256 - n) key[j] = bump(key[j], 1u);
      }
      sum += n;
    }
    __syncwarp();  // every lane has read its keys: the counts go back by symbol
#pragma unroll
    for (int j = 0; j < 8; ++j) h[key[j] & 0xffu] = key[j] >> 8;
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 8; ++i) cap[i] = h[8 * lane + i];
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

// segments: the table's four columns of n_short + n_long int64 each, the
// short segments first; chunks: the long ones' chunks of `chunk` bytes
extern "C" int hsr_hist_count(const void* data, const void* segments, int n_short, int n_long, long long chunks,
                              long long chunk, void* counts, void* cuda_stream) {
  const long long short_ctas = (static_cast<long long>(n_short) + kCountWarps - 1) / kCountWarps;
  if (n_short < 0 || n_long < 0 || n_short > 0x7fffffff - n_long || chunk < 16 || chunks < n_long ||
      (n_long == 0 && chunks != 0) || short_ctas + chunks > 0x7fffffffLL || reinterpret_cast<uintptr_t>(counts) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (short_ctas + chunks == 0) return 0;
  const cudaStream_t cs = static_cast<cudaStream_t>(cuda_stream);
  const long long* t = static_cast<const long long*>(segments);
  const long long k = static_cast<long long>(n_short) + n_long;
  const Segments seg{t, t + k, t + 2 * k, t + 3 * k};
  if (n_long) hist_zero_kernel<<<n_long, 64, 0, cs>>>(seg, n_short, chunk, static_cast<uint32_t*>(counts));
  hist_count_kernel<<<static_cast<unsigned>(short_ctas + chunks), kCountThreads, 0, cs>>>(
      static_cast<const uint8_t*>(data), seg, n_short, n_long, static_cast<int>(short_ctas), chunk,
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
