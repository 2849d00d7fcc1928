// The XLA scan codecs on Hopper: the batched lane-group decode and encode of
// the raw 16w wire, each stream's lanes one serial rANS chain.
//
// They replace no Pallas kernel.  They replace the two `lax.scan` steps of
// hsrans_tpu/ops/raw_jax.py, which XLA compiles on the TPU:
//   raw_jax.py::decode_section  -> scan_decode_kernel
//   raw_jax.py::encode_section  -> scan_encode_kernel
// They run the raw wire (raw_decode_jax / raw_encode_jax), the batched
// decode behind parallel/sharded.py::mt_decode_device's last fallback, and
// mt_encode_device at the lane counts the mt kernels do not take (n = 16).
// The contracts are XLA's, bit for bit, including its edges:
//   * an out-of-range gather does not read 0: a stream index at or past W
//     reads 0xFFFF, one in [-W, 0) wraps to index + W (Python style), one
//     below -W reads 0xFFFF; a table slot at or past the table's length reads
//     255 (symbol) or 0xFFFF (freq, cumul).  The mt kernels read word 0 past
//     a block's words instead (window.cuh), so these are other kernels;
//   * with `tail`, lane j of step g decodes (and consumes) only while
//     g*n + idx2idx[j] < valid_count, at every step, in int32 arithmetic;
//   * all state arithmetic wraps in u32, so tables that are no rANS tables
//     (freq 1, cumul 0) give XLA's bytes too; the read position is int32;
//   * a group's consumed words go to its lanes in ascending lane order;
//   * encode takes freq = max(freq, 1) before the emit test
//     state >= emit_point * freq (a u32 product that wraps), then
//     state = ((x / f) << bits) + cumul + x % f.
//
// What bounds them: each stream's n states form one chain of num_steps
// links (decode: table lookup -> state update -> ballot -> stream read;
// encode: emit test -> division -> state update), so the streams in flight
// and one link's latency set the rate, not bytes or arithmetic.  A raw blob
// is one stream: its decode or encode is a single chain of ceil(length/n)
// links whatever the card, which is the format's nature.  So the design
// takes every device-memory round trip, every divergent branch and every
// long arithmetic sequence off the link.
//
// Decode: one warp a stream; at n = 64 thread t holds lanes t and t + 32, at
// n = 16 threads 16..31 hold no lane.
//   * Tables in shared memory.  A link's three table loads depend on the
//     state, so from device memory they put an L1 (or worse) round trip on
//     every link.  At B <= kSmemMaxBits the kernel stages the table's 2^B
//     slots in shared memory before the chain (freq and cumul u16, symbol
//     u8: 5 bytes a slot, 20 KiB at B=12, 160 KiB at B=15), the slots at or
//     past the table's length written as 255 / 0xFFFF, so a lookup is three
//     independent shared loads and no compare.  A table that every stream
//     shares (stride 0, the raw wire) is staged once a CTA of kScanWarps
//     warps by all its threads; per-stream tables run one warp a CTA, each
//     warp staging its own (9 CTAs an SM at B=12: the n=16 mt call's 1,024
//     streams fit one wave).  Above kSmemMaxBits (B >= 16, which no wire
//     makes but the contract takes) the same body reads the tables through
//     L1 with the compare: a second instance chosen by the table's shape.
//   * The stream through a per-warp cp.async ring (window.cuh's copies) of
//     two halves of kRingHalf words, refilled far ahead of the chain as in
//     mt_decode.cu: when the cursor leaves a half, the half after the next
//     goes into its slot, and the warp waits for a half only when the next
//     group could read into it.  The ring holds XLA's words, not the
//     stream's: a 16-byte chunk wholly inside [0, W) comes by cp.async, any
//     other chunk is written word by word by XLA's rule (0xFFFF at or past
//     W, a wrap in [-W, 0)), so no zero-fill is ever read as a word.  Ring
//     position r holds read position base + r (u32 arithmetic, so the int32
//     read position wraps as XLA's does), base the stream's first read
//     position rounded down to a 16-byte address.  Every lane reads the word
//     at its offset and a consuming lane keeps it, so the warp never splits.
//   * 32-bit offsets only on the link: the ring position, the tail index
//     (a running int32 g*n + idx2idx[j]) and the read cursor; the row
//     pointers are hoisted.  The symbol stores hang off the chain.
//
// Encode: one thread a (stream, lane), the 128 / n streams of a CTA side by
// side.
//   * Tables and magic in shared memory: per symbol one 16-byte entry
//     {emit_point * d, magic m, 2^B - d, cumul | l << 16}, d = max(freq, 1),
//     staged before the chain from the u16 tables and the host's magic table
//     (kernels/scan.py::magic_table, m of every d in [0, 2^16)).
//   * A division by a magic that is exact over all of u32: the contract
//     lets a state take any u32 value and a freq any u16 value, where
//     mt_encode.cu's magic holds only below 2^31 and 2^15.  With
//     l = ceil(log2 d) and m = floor(2^(32+l) / d) + 1 - 2^32 (a u32),
//     x / d == (x + umulhi(m, x)) >> l for every u32 x and every d in
//     [1, 65535] (Granlund-Montgomery's 33-bit multiplier), the sum taken in
//     64 bits.  Then state = q * (2^B - d) + x + cumul, which is
//     (q << B) + cumul + (x - q*d) modulo 2^32.
//   * Loads ahead of the chain: the group bytes and valid flags kAhead
//     groups ahead in registers (a batch in flight while the last runs) and
//     each entry a group ahead in shared memory, so the link is compare ->
//     select -> umulhi -> add -> shift -> multiply-add -> select.

#include <cstdint>
#include <cuda_runtime.h>

#include "window.cuh"

namespace {

constexpr unsigned kFullMask = 0xFFFFFFFFu;
constexpr uint32_t kConsumePoint = 1u << 15;  // DECODE_CONSUME_POINT_16

// decode
constexpr int kScanWarps = 4;     // streams (one warp each) a decode CTA where they share one table
// tables of at most 2^kSmemMaxBits slots go to shared memory (160 KiB at
// 15).  At B=15 a shared table decodes 4x faster there than through L1;
// per-stream tables leave one stream an SM there, 1.05x the L1 route's time
// at the n=16 mt call (PERF.md)
constexpr int kSmemMaxBits = 15;
constexpr int kRingHalf = 512;    // u16 words in each half of a warp's stream ring
constexpr int kRing = 2 * kRingHalf;
static_assert(kRingHalf % (8 * 32) == 0 && kRingHalf >= 2 * 64 && (kRing & (kRing - 1)) == 0,
              "ring half: whole 16-byte chunks for each thread, a group's reads twice over, a power of two");

// encode
constexpr int kEncodeThreads = 128;  // threads a CTA: 128 / n streams
// groups whose bytes and flags are in flight ahead of the chain (16 took 1.07x
// the time at the n=16 mt call and 1.23x on the raw chain, PERF.md)
constexpr int kAhead = 32;

// idx2idx(n)[j] (hsrans_tpu_torch/rans.py): within each 32-lane chunk, lanes
// 8a + 4b + c code byte 16b + 4a + c; n = 16 is one 16-lane chunk, lanes
// 8b + 4a + c coding byte 8a + 4b + c
template <int N>
__device__ __forceinline__ int idx2idx(int j) {
  if (N == 16) return ((j >> 2) & 1) * 8 + ((j >> 3) & 1) * 4 + (j & 3);
  return (j & 32) + ((j >> 2) & 1) * 16 + ((j >> 3) & 3) * 4 + (j & 3);
}

__host__ __device__ constexpr uint32_t pad16(uint32_t x) { return (x + 15u) & ~15u; }

// shared bytes of one staged decode table of 2^bits slots: freq and cumul
// (u16), then the symbols (u8), each array 16-byte aligned
__host__ __device__ constexpr uint32_t table_bytes(int bits) { return 2 * pad16(2u << bits) + pad16(1u << bits); }

// one u16 of the stream at a signed index, as XLA's fill-mode gather reads it
__device__ __forceinline__ uint16_t xla_word(const uint16_t* __restrict__ s, long long w, int32_t idx) {
  long long i = idx;
  if (i < 0) i += w;
  return (i >= 0 && i < w) ? s[i] : static_cast<uint16_t>(0xFFFFu);
}

// Ring slot `dst` (kRingHalf words) takes the words of read positions p0,
// p0 + 1, ... (u32, read as int32), each as xla_word reads it.  One warp,
// thread j; (s + p0) is 16-byte aligned.  A chunk of 8 positions wholly
// inside [0, W) goes by cp.async, any other word by word; commits one group.
__device__ __forceinline__ void ring_fill(uint16_t* dst, const uint16_t* __restrict__ s, long long w, uint32_t p0,
                                          int j) {
#pragma unroll
  for (int i = 0; i < kRingHalf / (8 * 32); ++i) {
    const int q = j + 32 * i;
    const uint32_t p = p0 + 8u * q;
    const int32_t v = static_cast<int32_t>(p);
    if (v >= 0 && v <= INT32_MAX - 7 && static_cast<long long>(v) + 8 <= w) {
      window::copy16(dst + 8 * q, s + v, 16);
    } else {
      for (int e = 0; e < 8; ++e) dst[8 * q + e] = xla_word(s, w, static_cast<int32_t>(p + e));
    }
  }
  window::commit();
}

// dst[0, copy) = src[0, copy) and dst[copy, count) = fill, threads t, t + nt,
// ...; 16-byte loads where src is 16-byte aligned (dst always is)
template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* __restrict__ src, uint32_t copy, uint32_t count, T fill, int t,
                                      int nt) {
  constexpr uint32_t kVec = 16 / sizeof(T);
  uint32_t done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15u) == 0) {
    const uint32_t vecs = copy / kVec;
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
#pragma unroll 4
    for (uint32_t i = t; i < vecs; i += nt) d4[i] = __ldg(s4 + i);
    done = vecs * kVec;
  }
  for (uint32_t i = done + t; i < copy; i += nt) dst[i] = src[i];
  for (uint32_t i = copy + t; i < count; i += nt) dst[i] = fill;
}

// N lanes a stream; kSmem: the tables staged in shared memory (B <=
// kSmemMaxBits), else read through L1.  blockDim.x = 32 * warps: one warp
// per CTA for per-stream tables in shared memory, kScanWarps otherwise.
template <int N, bool kSmem>
__global__ void __launch_bounds__(kScanWarps * 32)
    scan_decode_kernel(const uint32_t* __restrict__ states, const uint16_t* __restrict__ stream,
                       long long stream_stride, long long w, const int32_t* __restrict__ read_pos,
                       const uint8_t* __restrict__ tab_sym, const uint16_t* __restrict__ tab_freq,
                       const uint16_t* __restrict__ tab_cumul, long long tab_stride, long long tab_len,
                       const int32_t* __restrict__ valid_counts, uint8_t* __restrict__ syms,
                       uint32_t* __restrict__ fin, int32_t* __restrict__ pos_out, int nb, int bits,
                       long long num_steps, int tail) {
  extern __shared__ __align__(16) uint8_t dsmem[];
  constexpr int K = N > 32 ? 2 : 1;  // lanes a thread
  const int warps = blockDim.x >> 5;
  const int wi = threadIdx.x >> 5;
  const int j = threadIdx.x & 31;
  const long long b = static_cast<long long>(blockIdx.x) * warps + wi;
  const bool live = b < nb;  // warp-uniform
  const bool own = tab_stride != 0;  // per-stream tables
  const uint32_t mask = (1u << bits) - 1u;

  // ---- the ring: its first two halves are on their way while the tables
  //      are staged
  uint16_t* ring = reinterpret_cast<uint16_t*>(dsmem) + wi * kRing;
  const uint16_t* s = stream + (live ? b : 0) * stream_stride;
  const int32_t r0 = live ? read_pos[b] : 0;
  const int ph = static_cast<int>(((reinterpret_cast<uintptr_t>(s) + 2u * static_cast<uintptr_t>(static_cast<uint32_t>(r0))) &
                                   15u) >> 1);
  const uint32_t base = static_cast<uint32_t>(r0) - ph;  // read position of ring position 0
  uint32_t next_half = 0;  // the next half to copy, into slot next_half % 2
  auto fill_next = [&]() {
    ring_fill(ring + (next_half & 1) * kRingHalf, s, w, base + next_half * kRingHalf, j);
    ++next_half;
  };
  if (live) {
    fill_next();
    fill_next();
  }

  // ---- the tables
  const uint8_t* tsym;
  const uint16_t* tfreq;
  const uint16_t* tcum;
  if constexpr (kSmem) {
    uint8_t* t0 = dsmem + warps * kRing * 2 + (own ? wi : 0) * table_bytes(bits);
    uint16_t* sf = reinterpret_cast<uint16_t*>(t0);
    uint16_t* sc = reinterpret_cast<uint16_t*>(t0 + pad16(2u << bits));
    uint8_t* sy = t0 + 2 * pad16(2u << bits);
    const uint32_t slots = 1u << bits;
    const uint32_t copy = static_cast<uint32_t>(min(max(tab_len, 0LL), static_cast<long long>(slots)));
    if (!own || live) {
      const long long row = own ? b * tab_stride : 0;
      const int t = own ? j : static_cast<int>(threadIdx.x);
      const int nt = own ? 32 : static_cast<int>(blockDim.x);
      stage<uint16_t>(sf, tab_freq + row, copy, slots, 0xFFFFu, t, nt);
      stage<uint16_t>(sc, tab_cumul + row, copy, slots, 0xFFFFu, t, nt);
      stage<uint8_t>(sy, tab_sym + row, copy, slots, 0xFFu, t, nt);
    }
    if (own) {
      __syncwarp();
    } else {
      __syncthreads();  // tab_stride is the launch's: every thread takes this branch
    }
    tsym = sy;
    tfreq = sf;
    tcum = sc;
  } else {
    const long long row = live ? b * tab_stride : 0;
    tsym = tab_sym + row;
    tfreq = tab_freq + row;
    tcum = tab_cumul + row;
  }
  if (!live) return;  // after the CTA's only barrier
  window::wait_all();
  __syncwarp();

  // ---- the chain, lanes j + 32k in registers
  const unsigned lt = (1u << j) - 1u;
  const int32_t vc = valid_counts[b];
  uint32_t st[K];
  int32_t gi[K];  // g*N + idx2idx[lane] in int32, as XLA computes it
  uint8_t* o[K];
  bool has[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int lane = j + 32 * k;
    has[k] = N >= 32 || lane < N;
    st[k] = has[k] ? states[b * N + lane] : 0u;
    gi[k] = idx2idx<N>(lane);
    o[k] = syms + b * num_steps * N + lane;
  }
  uint32_t rel = ph;              // ring position of the next read
  uint32_t refill_at = kRingHalf;  // once rel reaches it, the half below it is free
  uint32_t ready_end = kRing;     // the ring holds positions below it
  uint32_t event = kRingHalf;     // the next rel at which either check fires
  for (long long g = 0; g < num_steps; ++g) {
    bool take[K], cons[K];
    uint32_t x[K];
    unsigned bal[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const uint32_t slot = st[k] & mask;
      uint32_t sym, f, c;
      if constexpr (kSmem) {
        sym = tsym[slot];
        f = tfreq[slot];
        c = tcum[slot];
      } else {
        const bool inside = slot < tab_len;
        sym = inside ? __ldg(tsym + slot) : 0xFFu;
        f = inside ? __ldg(tfreq + slot) : 0xFFFFu;
        c = inside ? __ldg(tcum + slot) : 0xFFFFu;
      }
      x[k] = (st[k] >> bits) * f + (slot - c);
      take[k] = has[k] && (!tail || gi[k] < vc);
      cons[k] = take[k] && x[k] < kConsumePoint;
      bal[k] = __ballot_sync(kFullMask, cons[k]);
      if (has[k]) *o[k] = static_cast<uint8_t>(sym);
      o[k] += N;
      gi[k] = static_cast<int32_t>(static_cast<uint32_t>(gi[k]) + N);
    }
    // every lane reads (no branch to reconverge); a consuming lane keeps the word
    uint32_t at = rel;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const uint32_t v = ring[(at + __popc(bal[k] & lt)) & (kRing - 1)];
      st[k] = cons[k] ? __byte_perm(v, x[k], 0x5410) : (take[k] ? x[k] : st[k]);  // (x << 16) | v
      at += __popc(bal[k]);
    }
    rel = at;
    if (static_cast<int32_t>(rel - event) >= 0) {
      if (static_cast<int32_t>(rel - refill_at) >= 0) {
        __syncwarp();  // every lane's reads of the slot are done
        fill_next();
        refill_at += kRingHalf;
      }
      if (static_cast<int32_t>(rel + N - ready_end) > 0) {  // the next group may read into the half last copied
        window::wait_all();
        __syncwarp();
        ready_end += kRingHalf;
      }
      const uint32_t ready_at = ready_end - N + 1;
      event = static_cast<int32_t>(refill_at - ready_at) < 0 ? refill_at : ready_at;
    }
  }
  window::wait_all();  // no copy may land after the warp leaves
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (has[k]) fin[b * N + j + 32 * k] = st[k];
  if (j == 0) pos_out[b] = static_cast<int32_t>(base + rel);
}

// one group of one lane: e the symbol's entry, v its valid flag
__device__ __forceinline__ void encode_step(uint32_t& st, const uint4 e, uint32_t v, uint16_t* word, uint8_t* emit_out) {
  const bool valid = v != 0;
  const bool emit = valid && st >= e.x;
  *word = emit ? static_cast<uint16_t>(st) : static_cast<uint16_t>(0);
  *emit_out = emit;
  const uint32_t x = emit ? st >> 16 : st;
  const uint32_t q = static_cast<uint32_t>((static_cast<unsigned long long>(x) + __umulhi(e.y, x)) >> (e.w >> 16));
  const uint32_t ns = q * e.z + x + (e.w & 0xFFFFu);
  st = valid ? ns : st;
}

template <int N>
__global__ void __launch_bounds__(kEncodeThreads)
    scan_encode_kernel(const uint32_t* __restrict__ states, const uint8_t* __restrict__ group_bytes,
                       const uint8_t* __restrict__ valid, const uint16_t* __restrict__ freq_tab,
                       const uint16_t* __restrict__ cumul_tab, long long tab_stride, const uint32_t* __restrict__ magic,
                       uint16_t* __restrict__ words, uint8_t* __restrict__ emits, uint32_t* __restrict__ fin, int nb,
                       int bits, uint32_t emit_point, long long num_steps) {
  constexpr int kStreams = kEncodeThreads / N;
  __shared__ uint4 etab[kStreams * 256];
  const long long b0 = static_cast<long long>(blockIdx.x) * kStreams;
  const int tabs = tab_stride ? static_cast<int>(min(static_cast<long long>(kStreams), nb - b0)) : 1;
  // ---- the entries: {emit_point * d, m, 2^B - d, cumul | l << 16}
#pragma unroll
  for (int r = 0; r < kStreams * 256 / kEncodeThreads; ++r) {
    const int i = threadIdx.x + r * kEncodeThreads;
    if (i < tabs * 256) {
      const long long row = tab_stride ? (b0 + (i >> 8)) * tab_stride : 0;
      const uint32_t d = max(static_cast<uint32_t>(freq_tab[row + (i & 255)]), 1u);
      const uint32_t l = 32 - __clz(d - 1);  // ceil(log2 d): 0 at d = 1
      etab[i] = make_uint4(emit_point * d, magic[d], (1u << bits) - d,
                           static_cast<uint32_t>(cumul_tab[row + (i & 255)]) | l << 16);
    }
  }
  __syncthreads();
  const int local = threadIdx.x / N;
  const int j = threadIdx.x % N;
  const long long b = b0 + local;
  if (b >= nb) return;
  const uint4* tab = etab + (tab_stride ? local * 256 : 0);
  const long long row = b * num_steps * N + j;  // element (b, 0, j)
  const uint8_t* gb = group_bytes + row;
  const uint8_t* vf = valid + row;
  uint16_t* wo = words + row;
  uint8_t* eo = emits + row;
  uint32_t st = states[b * N + j];

  // the bytes and flags of groups top, top - 1, ..., top - kAhead + 1 (those >= 0)
  auto load = [&](uint32_t (&by)[kAhead], uint32_t (&fl)[kAhead], long long top) {
    const uint8_t* pb = gb + top * N;
    const uint8_t* pv = vf + top * N;
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const bool in = top - u >= 0;
      by[u] = in ? pb[-u * N] : 0u;
      fl[u] = in ? pv[-u * N] : 0u;
    }
  };
  uint32_t cb[kAhead], cv[kAhead], nb_[kAhead], nv[kAhead];
  long long top = num_steps - 1;  // rANS is LIFO: the last group first
  load(cb, cv, top);
  for (; top >= kAhead - 1; top -= kAhead) {  // whole batches
    load(nb_, nv, top - kAhead);  // in flight while this batch runs
    uint16_t* pw = wo + top * N;
    uint8_t* pe = eo + top * N;
    uint4 e = tab[cb[0]];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const uint4 next = tab[u + 1 < kAhead ? cb[u + 1] : nb_[0]];  // a group ahead
      encode_step(st, e, cv[u], pw - u * N, pe - u * N);
      e = next;
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      cb[u] = nb_[u];
      cv[u] = nv[u];
    }
  }
  // the last top + 1 < kAhead groups, in cb
#pragma unroll
  for (int u = 0; u < kAhead; ++u) {
    if (u > top) break;
    encode_step(st, tab[cb[u]], cv[u], wo + (top - u) * N, eo + (top - u) * N);
  }
  fin[b * N + j] = st;
}

template <int N>
int launch_decode(const void* states, const void* stream, long long stream_stride, long long w, const void* read_pos,
                  const void* tab_sym, const void* tab_freq, const void* tab_cumul, long long tab_stride,
                  long long tab_len, const void* valid_counts, void* syms, void* fin, void* pos_out, int nb, int bits,
                  long long num_steps, int tail, cudaStream_t cs) {
  const bool smem_route = bits <= kSmemMaxBits;
  const auto kernel = smem_route ? scan_decode_kernel<N, true> : scan_decode_kernel<N, false>;
  const bool own = tab_stride != 0;
  const int warps = smem_route && own ? 1 : kScanWarps;
  const size_t smem = static_cast<size_t>(warps) * kRing * sizeof(uint16_t) +
                      (smem_route ? static_cast<size_t>(own ? warps : 1) * table_bytes(bits) : 0);  // <= 168 KiB
  if (smem > 48 * 1024) {
    const cudaError_t set =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (set != cudaSuccess) return static_cast<int>(set);
  }
  const long long ctas = (static_cast<long long>(nb) + warps - 1) / warps;
  kernel<<<static_cast<unsigned>(ctas), warps * 32, smem, cs>>>(
      static_cast<const uint32_t*>(states), static_cast<const uint16_t*>(stream), stream_stride, w,
      static_cast<const int32_t*>(read_pos), static_cast<const uint8_t*>(tab_sym),
      static_cast<const uint16_t*>(tab_freq), static_cast<const uint16_t*>(tab_cumul), tab_stride, tab_len,
      static_cast<const int32_t*>(valid_counts), static_cast<uint8_t*>(syms), static_cast<uint32_t*>(fin),
      static_cast<int32_t*>(pos_out), nb, bits, num_steps, tail);
  return static_cast<int>(cudaGetLastError());
}

template <int N>
int launch_encode(const void* states, const void* group_bytes, const void* valid, const void* freq_tab,
                  const void* cumul_tab, long long tab_stride, void* words, void* emits, void* fin, int nb, int bits,
                  long long emit_point, long long num_steps, const void* magic, cudaStream_t cs) {
  constexpr int kStreams = kEncodeThreads / N;
  const long long ctas = (static_cast<long long>(nb) + kStreams - 1) / kStreams;
  scan_encode_kernel<N><<<static_cast<unsigned>(ctas), kEncodeThreads, 0, cs>>>(
      static_cast<const uint32_t*>(states), static_cast<const uint8_t*>(group_bytes),
      static_cast<const uint8_t*>(valid), static_cast<const uint16_t*>(freq_tab),
      static_cast<const uint16_t*>(cumul_tab), tab_stride, static_cast<const uint32_t*>(magic),
      static_cast<uint16_t*>(words), static_cast<uint8_t*>(emits), static_cast<uint32_t*>(fin), nb, bits,
      static_cast<uint32_t>(emit_point), num_steps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// tab_stride / stream_stride: elements between streams' rows, 0 for one
// shared row
extern "C" int hsr_scan_decode(const void* states, const void* stream, long long stream_stride, long long w,
                               const void* read_pos, const void* tab_sym, const void* tab_freq, const void* tab_cumul,
                               long long tab_stride, long long tab_len, const void* valid_counts, void* syms,
                               void* fin, void* pos_out, int nb, int n, int bits, long long num_steps, int tail,
                               void* cuda_stream) {
  if (nb <= 0) return 0;
  if ((n != 16 && n != 32 && n != 64) || bits < 0 || bits > 31 || num_steps < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto cs = static_cast<cudaStream_t>(cuda_stream);
  const auto go = n == 16 ? launch_decode<16> : n == 32 ? launch_decode<32> : launch_decode<64>;
  return go(states, stream, stream_stride, w, read_pos, tab_sym, tab_freq, tab_cumul, tab_stride, tab_len,
            valid_counts, syms, fin, pos_out, nb, bits, num_steps, tail, cs);
}

// magic: [2^16] u32, kernels/scan.py::magic_table (the trailing argument)
extern "C" int hsr_scan_encode(const void* states, const void* group_bytes, const void* valid, const void* freq_tab,
                               const void* cumul_tab, long long tab_stride, void* words, void* emits, void* fin,
                               int nb, int n, int bits, long long emit_point, long long num_steps, const void* magic,
                               void* cuda_stream) {
  if (nb <= 0) return 0;
  if ((n != 16 && n != 32 && n != 64) || bits < 0 || bits > 31 || num_steps < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto cs = static_cast<cudaStream_t>(cuda_stream);
  const auto go = n == 16 ? launch_encode<16> : n == 32 ? launch_encode<32> : launch_encode<64>;
  return go(states, group_bytes, valid, freq_tab, cumul_tab, tab_stride, words, emits, fin, nb, bits, emit_point,
            num_steps, magic, cs);
}
