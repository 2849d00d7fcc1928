// mt encode on Hopper: every coded block of an mt_rANS32xN 16w blob in one
// launch, then one launch that lays the blocks out as the wire.
//
// mt_encode_kernel replaces hsrans_tpu/kernels/mt64_encode.py::
// _mt64_enc_kernel (launched by _encode_blocks once per block size and per
// 128-step segment); mt_place_kernel takes the place of the mt encoder's
// phase B there, the tpx concat kernel (tpx_encode.py::_concat_kernel run
// per 16-step segment) followed by the host's join of each block's words.
//
// What bounds them: the encode is one serial chain per lane (emit test ->
// shift -> magic divide -> state update) of ceil(size/n) links per block, run
// backward; the bytes (the input once, about as many bytes of words out) and
// the arithmetic are small, so the rate is set by the blocks in flight and
// the latency of one link.  A block is never split, so a plan of a few giant
// blocks (the reference planner's, up to 2^25 bytes) leaves the card few
// chains, as the TPU kernel's serial segment chain does.  A byte loaded from
// device memory inside the loop, right before the table lookup that needs
// it, put an L2 or HBM round trip on every link: the input is read backward
// (no prefetcher helps) and is larger than L2 at 64 MiB.  With the bytes in
// shared memory, loaded a group ahead, the link is its ~10 dependent integer
// operations and the rest of the warp's instructions a group, issued in
// order.  The placement is a copy of the emitted words plus a 0.8 KB header
// a block: bound by memory traffic.
//
// Design (encode): one warp per coded block, as csrc/mt_decode.cu.  With
// n=64 thread j holds lanes j and j+32, with n=32 lane j, starting from
// DECODE_CONSUME_POINT_16.  The warp builds its block's encode table in
// shared memory from the block's u16 freq row (the header's own): cumul by a
// warp scan, and per symbol, in one 16-byte entry, the emit threshold, the
// Granlund-Montgomery magic m of d = max(freq, 1) read from `magic` (a table
// of m by d for every d <= 2^15 that the host builds once and keeps on the
// card, in place of a 64-bit division per symbol and block), 2^B - d, cumul
// and l = ceil(log2 d): q = x / d is (m * x) >> (31 + l), exact for every
// x < 2^31 (the rANS32 state invariant).  The block's input bytes come
// through a window in shared memory (window.cuh: two halves of kWindowHalf
// bytes, 32 groups at n=64), which the warp refills by cp.async backward,
// far ahead of the chain: when its groups leave a half it copies the half
// below the next into that slot, and it waits for a half only when the next
// group could read into it.  A group's bytes and table entries depend on g
// alone and are loaded a group ahead, off the chain.  Each lane knows from
// the start the groups in which it takes part, and its words go out by one
// predicated store, so no 64-bit arithmetic, per-group bound or branch to
// reconverge is left on the lanes.  Per group, backward, lane j codes byte
// in_start + g*n + idx2idx[j]: it emits its low 16 bits when valid and
// state >= 2^(31-B) * e, then state = q * (2^B - d) + x + cumul, which is
// (q << B) + cumul + (x - q*d) modulo 2^32, so that a symbol of freq 0
// encodes exactly as the numpy oracle encodes it; e is freq (ops/reference.py::encode_groups) or d
// (ops/raw_jax.py::encode_section) by the caller's rule.  The two rules, and
// the two valid limits below, differ only on lanes that read a byte the
// block's freqs do not cover.
//
// Word order: the wire holds a block's words in (group ascending, lane
// ascending) order, and the encoder meets the groups descending.  So each
// block writes its words into its own scratch region from the region's end
// backward: a group's emitted words take the slots just below the previous
// group's, in lane order (a ballot over lanes 0..31, then one over lanes
// 32..63 offset by the first's popcount).  When the block ends its words are
// contiguous and in wire order at the region's end; the count of them and
// the final states come back.  Where the plan's block size is not a multiple
// of n, the last group is partial: its lanes past `byte_limit` read the byte
// 0 (the window zero-fills it) and take part while below `valid_limit` (the
// host route of mt64_encode_tpu: valid up to the input's end;
// mt_encode_device: up to the block's end).
//
// Design (placement): the launch writes the whole blob, every u16 of it
// once: its head (input length, blob bytes), and each plan row's part at the
// u16 offset the host computes from the counts, a coded block's (size,
// offset, n final states, 256 freqs, then its words) or a single-symbol
// indicator.  Every part is a whole number of u16, so the blob is one u16
// array.  The blob is cut into kChunkU16 chunks, one a warp, so the work is
// the same for every warp whatever the blocks' sizes (the reference
// planner's reach 2^25 bytes, one warp a block would copy 16 Mi words
// alone).  A warp finds the part at its chunk's start by a 32-way search
// over the parts' offsets (three rounds for 16 Ki parts), then takes the
// parts it overlaps 32 at a time, each lane loading one part's row, so a
// chunk of many small parts waits for one round of loads, not one a part.
// A part's states, freqs and words are copies of rows that meet the part's
// slots at any u16 phase: each 16-byte group of the chunk is built from
// aligned loads of the source (realigned by a funnel shift where the two
// phases differ by an odd u16) and written as one aligned 16-byte store;
// the size and offset fields, indicators and the partial groups at a
// copy's ends go u16 by u16.  Chunks of 4 KiB timed best over the plans
// against 8 and 16 KiB (16 KiB won only on the largest blocks), and against
// a lane building each 16-byte group on its own after finding its part in a
// shared list (PERF.md).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "window.cuh"

namespace {

constexpr int kWarps = 4;  // blocks (one warp each) per CTA
// bytes in each half of the encode's input window (a power of two, at least
// 512 and above 2n: a group reads n bytes); 2048 beat 1024 at plan (a) and
// on the 8 MiB plans and tied at (b) (PERF.md)
constexpr int kWindowHalf = 2048;
static_assert((kWindowHalf & (kWindowHalf - 1)) == 0 && kWindowHalf >= 512, "window half: a power of two >= 512");
constexpr int kMagicMax = 1 << 15;  // the magic table covers d = 0..2^15 (freqs sum to 2^B <= 2^15)
constexpr unsigned kFullMask = 0xFFFFFFFFu;
constexpr uint32_t kFreshState = 1u << 15;  // DECODE_CONSUME_POINT_16

// per-block index row (int64): the layout of kernels/mt_encode.py::INDEX_FIELDS
struct EncIndex {
  long long in_start, num_groups, byte_limit, valid_limit, region_end;
};

// per-part placement row (int64): kernels/mt_encode.py::PLACE_FIELDS.  The
// part of coded block `block` when block >= 0 (value: its u64 size field;
// bias: what its u64 offset field subtracts), else 8 literal bytes (value):
// the blob's two head fields and each single-symbol indicator
struct PlaceRow {
  long long dest, value, block, bias;
};

// u16s of the blob one warp of the placement writes (4 KiB)
constexpr int kChunkU16 = 2048;
static_assert(kChunkU16 % 8 == 0, "a chunk is whole 16-byte groups");

// idx2idx(32): lanes 8a + 4b + c -> byte 16b + 4a + c (hsrans_tpu/rans.py);
// idx2idx(64) is idx2idx(32) on each half, the upper half offset by 32
__device__ __forceinline__ int idx2idx32(int j) {
  return ((j >> 2) & 1) * 16 + (j >> 3) * 4 + (j & 3);
}

// ceil(a / n) for any sign of a, n > 0
__device__ __forceinline__ long long ceil_div(long long a, int n) { return a > 0 ? (a + n - 1) / n : -((-a) / n); }

// *p = v where `pred`: one predicated store, no branch for the warp to reconverge
__device__ __forceinline__ void store_if(uint16_t* p, uint32_t v, bool pred) {
  asm volatile("{\n .reg .pred q;\n setp.ne.b32 q, %2, 0;\n @q st.global.u16 [%0], %1;\n}\n" ::"l"(p),
               "h"(static_cast<uint16_t>(v)), "r"(static_cast<int>(pred)));
}

// 32 KiB of shared memory a CTA and ~74 registers a thread: either allows 6
// CTAs an SM (a 56-register cap timed within ~1 %, PERF.md)
template <int K>
__global__ void __launch_bounds__(kWarps * 32)
mt_encode_kernel(const uint8_t* __restrict__ data,     // [data_len] the input
                 const EncIndex* __restrict__ index,   // [nb]
                 const uint16_t* __restrict__ freqs,   // [nb, 256] the header's freqs (sum 2^bits)
                 const uint32_t* __restrict__ magic,   // [kMagicMax + 1] m of d, ceil(2^(31+l) / max(d, 1))
                 uint16_t* __restrict__ words,         // [words_cap] scratch; block b's region ends at region_end
                 uint32_t* __restrict__ fin,           // [nb, 32K] final (= header) states
                 long long* __restrict__ count,        // [nb] words emitted
                 int nb, int bits, int zero_freq_emits, long long data_len, long long words_cap) {
  // per symbol: x = emit threshold e << (15 - B) on state >> 16, y = magic m,
  // z = 2^B - d, w = cumul | l << 16
  __shared__ uint4 tab_all[kWarps][256];
  constexpr int kRing = 2 * kWindowHalf;  // bytes of a warp's window
  __shared__ __align__(16) uint8_t ring_all[kWarps][kRing];
  constexpr int n = 32 * K;
  static_assert(kWindowHalf >= 2 * n, "a half holds a group's bytes twice over");
  const int w = threadIdx.x >> 5;
  const int j = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + w;
  if (b >= nb) return;  // warp-uniform; the kernel syncs only within a warp
  uint4* tab = tab_all[w];
  uint8_t* ring = ring_all[w];
  const EncIndex ix = index[b];
  const long long byte_limit = min(ix.byte_limit, data_len);
  const int groups = static_cast<int>(min(max(ix.num_groups, 0LL), static_cast<long long>(INT32_MAX)));

  // ---- the window: byte p of the input at ring[(p - base) % kRing], base
  //      the block's first byte rounded down to a 16-byte address; bytes at
  //      or past byte_limit, or below 0, read as 0.  Group g reads window
  //      positions [g*n + ph, g*n + ph + n); the loop walks them downward.
  //      Its first two halves are on their way while the warp builds its table.
  const int ph = window::phase(data, ix.in_start);
  const long long base = ix.in_start - ph;
  long long next_half = groups > 0 ? (static_cast<long long>(groups) * n + ph - 1) / kWindowHalf : -1;
  auto fill_next = [&]() {  // the next half down, into slot next_half % 2
    window::fill<kWindowHalf>(ring + (next_half & 1) * kWindowHalf, data, base + next_half * kWindowHalf, byte_limit,
                              j);
    --next_half;
  };
  long long refill_at = (next_half + 1) * kWindowHalf;  // the top half is free once reads lie below next_half's top
  long long ready_lo = (next_half - 1) * kWindowHalf;   // the window holds positions from it up
  if (next_half >= 0) fill_next();
  if (next_half >= 0) fill_next();
  refill_at -= kWindowHalf;

  // ---- the block's table: thread j owns symbols 8j..8j+7
  uint32_t f[8], m[8];
  uint32_t sum = 0;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    f[q] = freqs[(size_t)b * 256 + 8 * j + q];
    m[q] = magic[min(f[q], static_cast<uint32_t>(kMagicMax))];
    sum += f[q];
  }
  uint32_t incl = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t v = __shfl_up_sync(kFullMask, incl, d);
    if (j >= d) incl += v;
  }
  uint32_t cum = incl - sum;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const uint32_t d = max(f[q], 1u);
    const uint32_t l = 32 - __clz(d - 1);  // ceil(log2 d); 0 for d = 1
    const uint32_t e = zero_freq_emits ? f[q] : d;
    // cumul is u16 on the wire
    tab[8 * j + q] = make_uint4(e << (15 - bits), m[q], (1u << bits) - d, (cum & 0xFFFFu) | l << 16);
    cum += f[q];
  }
  window::wait_all();
  __syncwarp();  // the table and the window's first halves

  // ---- the block's groups, backward, lanes j + 32k in registers.  Lane
  //      j + 32k takes part in group g while g < g_valid[k]: its byte lies
  //      below valid_limit.  The group's words go to [tail, tail + c); a
  //      block whose whole region lies in [0, words_cap) writes them unchecked.
  const uint32_t lt = (1u << j) - 1u;
  uint32_t st[K];
  int byte_of[K], g_valid[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    st[k] = kFreshState;
    byte_of[k] = idx2idx32(j) + 32 * k;
    const long long v = ceil_div(ix.valid_limit - ix.in_start - byte_of[k], n);
    g_valid[k] = static_cast<int>(min(max(v, 0LL), static_cast<long long>(groups)));
  }
  long long tail = ix.region_end;  // the block's words so far sit at [tail, region_end)
  const bool region_inside = ix.region_end <= words_cap && ix.region_end - static_cast<long long>(groups) * n >= 0;
  // group g's lanes read window positions lo + byte_of, lo = g*n + ph; each
  // group's bytes and table entries are loaded one group ahead, so their
  // shared-memory latency stays off the next group's chain
  long long lo = static_cast<long long>(groups - 1) * n + ph;
  uint4 t[K];
#pragma unroll
  for (int k = 0; k < K; ++k) t[k] = tab[ring[(static_cast<uint32_t>(lo) + byte_of[k]) & (kRing - 1)]];
  // the next lo at which a window half must be copied (lo <= refill_at) or
  // waited for (the next group reads below ready_lo)
  long long event = max(next_half >= 0 ? refill_at : LLONG_MIN, ready_lo + n - 1);
  for (int g = groups - 1; g >= 0; --g, lo -= n) {
    bool emit[K];
    uint32_t word[K];
    unsigned ballot[K];
    int c = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const bool valid = g < g_valid[k];
      const uint32_t hi16 = st[k] >> 16;
      emit[k] = valid && hi16 >= t[k].x;
      word[k] = st[k];
      const uint32_t x = emit[k] ? hi16 : st[k];
      // (m * x) >> (31 + l), and (m * x) >> 31 fits 32 bits: x < 2^31, as a lane
      // that does not emit has state < e << (31 - B) <= 2^31
      const uint64_t mx = static_cast<uint64_t>(t[k].y) * x;
      const uint32_t q =
          __funnelshift_l(static_cast<uint32_t>(mx), static_cast<uint32_t>(mx >> 32), 1) >> (t[k].w >> 16);
      if (valid) st[k] = q * t[k].z + x + (t[k].w & 0xFFFFu);
      ballot[k] = __ballot_sync(kFullMask, emit[k]);
      c += __popc(ballot[k]);
    }
    // the next group reads [lo - n, lo): once that lies below refill_at, the
    // half above it is free for next_half, which has ~kWindowHalf - 2n bytes
    // of reading to land before a group can reach it
    if (lo <= event) {
      if (lo <= refill_at && next_half >= 0) {
        __syncwarp();  // every lane's reads of the slot are done
        fill_next();
        refill_at -= kWindowHalf;
      }
      if (lo - n < ready_lo) {  // the next group may read into the half last copied
        window::wait_all();
        __syncwarp();
        ready_lo -= kWindowHalf;
      }
      event = max(next_half >= 0 ? refill_at : LLONG_MIN, ready_lo + n - 1);
    }
#pragma unroll
    for (int k = 0; k < K; ++k) t[k] = tab[ring[(static_cast<uint32_t>(lo - n) + byte_of[k]) & (kRing - 1)]];
    tail -= c;
    int o = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const long long at = tail + o + __popc(ballot[k] & lt);
      store_if(words + at, word[k], emit[k] && (region_inside || (at >= 0 && at < words_cap)));
      o += __popc(ballot[k]);
    }
  }
  window::wait_all();  // no copy may land after the warp leaves
#pragma unroll
  for (int k = 0; k < K; ++k) fin[(size_t)b * n + j + 32 * k] = st[k];
  if (j == 0) count[b] = ix.region_end - tail;
}

// out[x] = src[x + delta] for x in [a, b), the source inside [0, src_len):
// the 16-byte groups of out wholly inside as one aligned store each, built
// from aligned loads of the source (one 16-byte load where source and
// destination share their phase, four u32 where they differ by an even
// number of u16, five u32 and a funnel shift where by an odd one), the
// partial groups at the two ends u16 by u16.  src and out are 16-byte
// aligned.
__device__ __forceinline__ void copy_u16(uint16_t* __restrict__ out, const uint16_t* __restrict__ src, long long a,
                                         long long b, long long delta, long long src_len, int j) {
  if (a >= b) return;
  const int ph = static_cast<int>(delta & 7);
  long long g0 = (a + 7) >> 3, g1 = b >> 3;  // whole groups [g0, g1)
  if (ph & 1) {  // a group's fifth u32 holds the u16 after it, which must lie inside src
    const long long lim = src_len - 9 - delta;
    g1 = lim < 0 ? g0 : min(g1, (lim >> 3) + 1);
  }
  g1 = max(g1, g0);
  const long long head_end = min(b, g0 << 3);
  for (long long x = a + j; x < head_end; x += 32) out[x] = src[x + delta];
  for (long long x = max(g1 << 3, head_end) + j; x < b; x += 32) out[x] = src[x + delta];
  uint4* out4 = reinterpret_cast<uint4*>(out);
  const uint32_t* w32 = reinterpret_cast<const uint32_t*>(src);
  if (ph == 0) {
#pragma unroll 4
    for (long long g = g0 + j; g < g1; g += 32) out4[g] = reinterpret_cast<const uint4*>(src)[g + (delta >> 3)];
  } else if ((ph & 1) == 0) {
#pragma unroll 4
    for (long long g = g0 + j; g < g1; g += 32) {
      const uint32_t* q = w32 + (((g << 3) + delta) >> 1);
      out4[g] = make_uint4(q[0], q[1], q[2], q[3]);
    }
  } else {
#pragma unroll 4
    for (long long g = g0 + j; g < g1; g += 32) {
      const uint32_t* q = w32 + (((g << 3) + delta) >> 1);  // the u32 holding the group's first u16 in its high half
      const uint32_t q0 = q[0], q1 = q[1], q2 = q[2], q3 = q[3], q4 = q[4];
      out4[g] = make_uint4(__funnelshift_r(q0, q1, 16), __funnelshift_r(q1, q2, 16), __funnelshift_r(q2, q3, 16),
                           __funnelshift_r(q3, q4, 16));
    }
  }
}

template <int N>
__global__ void __launch_bounds__(kWarps * 32)
mt_place_kernel(const uint16_t* __restrict__ words,    // [words_cap] the encode's scratch
                const EncIndex* __restrict__ index,    // [nb]
                const long long* __restrict__ count,   // [nb]
                const uint32_t* __restrict__ fin,      // [nb, N]
                const uint16_t* __restrict__ freqs,    // [nb, 256]
                int nb,
                const PlaceRow* __restrict__ place,    // [n_rows] the blob's parts, dest ascending from 0
                int n_rows,
                uint16_t* __restrict__ out,            // [out_len] the blob as u16
                long long words_cap, long long out_len) {
  constexpr int n = N;  // lanes of the wire (16, 32 or 64): only the header's size depends on it
  constexpr int kHeader = 4 + 4 + 2 * n + 256;  // u16s of size, offset, states, freqs
  const int j = threadIdx.x & 31;
  const long long lo = (static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5)) * kChunkU16;
  if (lo >= out_len) return;  // warp-uniform
  const long long hi = min(lo + kChunkU16, out_len);
  // the last part that starts at or below lo, place[first].dest <= lo <
  // place[top].dest: a 32-way search, each lane testing one row a round
  int first = 0, top = n_rows;
  while (top - first > 1) {
    const int step = (top - first + 31) >> 5;
    const int at = first + j * step;
    const unsigned le = __ballot_sync(kFullMask, at < top && place[at].dest <= lo);  // lane 0's row is `first`
    if (le == 0) break;  // no part starts at or below lo: a layout whose first part is not at 0
    first += (31 - __clz(le)) * step;
    top = min(top, first + step);
  }
  // the parts from there, 32 at a time: each lane loads one part's row and
  // its block's count and scratch region; a literal part (the head's two
  // fields, an indicator) is written by its lane, a coded block's part by
  // the whole warp, one after the other
  for (int r0 = first; r0 < n_rows; r0 += 32) {
    const int r = r0 + j;
    PlaceRow p = {out_len, 0, -1, 0};
    long long end = out_len, w = 0, src = 0;
    if (r < n_rows) {
      p = place[r];
      end = r + 1 < n_rows ? place[r + 1].dest : out_len;  // the parts tile the blob
      if (p.block >= 0 && p.block < nb) {
        w = count[p.block];
        src = index[p.block].region_end - w;
      }
    }
    const bool coded = p.block >= 0 && p.block < nb;
    if (p.dest < hi && !coded) {
      for (long long x = max(lo, p.dest); x < min(hi, end); ++x) {
        const long long off = x - p.dest;
        out[x] = off < 4 ? static_cast<uint16_t>(static_cast<unsigned long long>(p.value) >> (16 * off)) : 0;
      }
    }
    for (unsigned todo = __ballot_sync(kFullMask, p.dest < hi && coded); todo; todo &= todo - 1) {
      const int k = __ffs(todo) - 1;
      const long long dest = __shfl_sync(kFullMask, p.dest, k), pend = __shfl_sync(kFullMask, end, k);
      const long long b = __shfl_sync(kFullMask, p.block, k), pw = __shfl_sync(kFullMask, w, k);
      const long long psrc = __shfl_sync(kFullMask, src, k);
      const long long size = __shfl_sync(kFullMask, p.value, k), bias = __shfl_sync(kFullMask, p.bias, k);
      const long long a = max(lo, dest), e = min(hi, pend);
      if (j < 8 && dest + j >= a && dest + j < e) {  // the u64 size and offset fields
        const unsigned long long v = j < 4 ? static_cast<unsigned long long>(size) : 2ull * n + 256 + pw - bias;
        out[dest + j] = static_cast<uint16_t>(v >> (16 * (j & 3)));
      }
      // the block's final states and freqs, copies of its rows
      copy_u16(out, reinterpret_cast<const uint16_t*>(fin), max(a, dest + 8), min(e, dest + 8 + 2 * n),
               2LL * n * b - (dest + 8), 2LL * n * nb, j);
      copy_u16(out, freqs, max(a, dest + 8 + 2 * n), min(e, dest + kHeader), 256LL * b - (dest + 8 + 2 * n),
               256LL * nb, j);
      const long long wa = max(a, dest + kHeader);
      if (psrc >= 0 && psrc + pw <= words_cap) {
        copy_u16(out, words, wa, e, psrc - (dest + kHeader), words_cap, j);
      } else {  // a count or region the scratch does not hold: its words read as 0 past it
        for (long long x = wa + j; x < e; x += 32) {
          const long long from = x - (dest + kHeader) + psrc;
          out[x] = from >= 0 && from < words_cap ? words[from] : 0;
        }
      }
    }
    if (__any_sync(kFullMask, end >= hi)) break;  // the parts after this batch start at or past hi
  }
}

}  // namespace

extern "C" int hsr_mt_encode(const void* data, const void* index, const void* freqs, const void* magic, void* words,
                             void* fin, void* count, int nb, int n, int bits, int zero_freq_emits, long long data_len,
                             long long words_cap, void* cuda_stream) {
  if (nb <= 0) return 0;
  if ((n != 32 && n != 64) || bits < 1 || bits > 15) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t cs = static_cast<cudaStream_t>(cuda_stream);
  const int blocks = (nb + kWarps - 1) / kWarps;
  const auto* d = static_cast<const uint8_t*>(data);
  const auto* ix = static_cast<const EncIndex*>(index);
  const auto* fq = static_cast<const uint16_t*>(freqs);
  const auto* mg = static_cast<const uint32_t*>(magic);
  auto* wd = static_cast<uint16_t*>(words);
  auto* fs = static_cast<uint32_t*>(fin);
  auto* ct = static_cast<long long*>(count);
  if (n == 64)
    mt_encode_kernel<2><<<blocks, kWarps * 32, 0, cs>>>(d, ix, fq, mg, wd, fs, ct, nb, bits, zero_freq_emits, data_len,
                                                        words_cap);
  else
    mt_encode_kernel<1><<<blocks, kWarps * 32, 0, cs>>>(d, ix, fq, mg, wd, fs, ct, nb, bits, zero_freq_emits, data_len,
                                                        words_cap);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hsr_mt_wire(const void* words, const void* index, const void* count, const void* fin,
                           const void* freqs, int nb, const void* place, int n_rows, void* out, int n,
                           long long words_cap, long long out_len, void* cuda_stream) {
  if (n_rows <= 0 || out_len <= 0) return 0;
  const bool aligned = (reinterpret_cast<uintptr_t>(out) | reinterpret_cast<uintptr_t>(words) |
                        reinterpret_cast<uintptr_t>(fin) | reinterpret_cast<uintptr_t>(freqs)) % 16 == 0;
  if ((n != 16 && n != 32 && n != 64) || !aligned) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t cs = static_cast<cudaStream_t>(cuda_stream);
  const long long chunks = (out_len + kChunkU16 - 1) / kChunkU16;
  const int blocks = static_cast<int>((chunks + kWarps - 1) / kWarps);
  const auto* wd = static_cast<const uint16_t*>(words);
  const auto* ix = static_cast<const EncIndex*>(index);
  const auto* ct = static_cast<const long long*>(count);
  const auto* fs = static_cast<const uint32_t*>(fin);
  const auto* fq = static_cast<const uint16_t*>(freqs);
  const auto* pl = static_cast<const PlaceRow*>(place);
  auto* o = static_cast<uint16_t*>(out);
  if (n == 64)
    mt_place_kernel<64><<<blocks, kWarps * 32, 0, cs>>>(wd, ix, ct, fs, fq, nb, pl, n_rows, o, words_cap, out_len);
  else if (n == 32)
    mt_place_kernel<32><<<blocks, kWarps * 32, 0, cs>>>(wd, ix, ct, fs, fq, nb, pl, n_rows, o, words_cap, out_len);
  else
    mt_place_kernel<16><<<blocks, kWarps * 32, 0, cs>>>(wd, ix, ct, fs, fq, nb, pl, n_rows, o, words_cap, out_len);
  return static_cast<int>(cudaGetLastError());
}
