// mt decode on Hopper: every coded block of an mt_rANS32xN 16w blob in one
// launch, by one of two routes.
//
// The rank route, mt_decode_kernel<K, kFlat, uint16_t>, replaces four Pallas
// TPU kernels of hsrans_tpu/kernels/, which differ only in how they pack 32-
// or 64-lane blocks into 128-lane TPU rows:
//   mt64_decode.py::_mt64_kernel           (one block per row)
//   mt64_decode.py::_mt64_pair_kernel      (two n=64 blocks per row, B<=12)
//   mt64_decode.py::_mt64_pair_kernel_hb   (pairs at B=13..15)
//   mt32_quad.py::_mt32_quad_kernel        (four n=32 blocks per row, B<=12)
// A warp has no such width problem, so one kernel covers all four.
//
// The annotated-stream route replaces the two Pallas kernels of the JAX
// package's `_PAIR_V2` route (mt64_decode.py::_decode_pairs_v2):
//   mt64_decode.py::_annotate_pairs        -> mt_annotate_kernel
//   mt64_decode.py::_mt64_pair_kernel_v2   -> mt_decode_kernel<K, kFlat, uint32_t>
// At B <= 15 a lane that has just renormalised, st = (st << 16) | word, has
// next slot exactly word & mask, since (st << 16) & mask == 0.  So a fully
// parallel pass stamps every word of a block with rank(word & mask) in its
// bits 16..23 (ann = word | rank << 16), and the serial decode takes a
// consumed lane's next rank from the word it reads: the rank lookup leaves
// that lane's link.  A lane that does not consume still looks its rank up,
// but from its new state alone, off the ballot and the read.  A read past a
// block's words gives word 0 and rank 0, the rank of slot 0: slot 0 belongs
// to the first present symbol.  The route holds for n = 32 and 64 and any
// B <= 15, and gives the rank route's bytes.
//
// What bounds the decodes: each block's n states form one serial chain per
// lane (table lookup -> state update -> ballot -> renorm read) of
// ceil(size/n) links; the bytes and arithmetic are small, so the number of
// blocks in flight and the latency of one link set the rate.  A block is
// never split, so a blob of a few giant blocks (the reference planner's, up
// to 2^25 bytes) leaves the card with few chains.  The renorm read's address
// depends on the group's ballot, so nothing can issue it early: read from
// device memory it put an L2 or HBM round trip on about every other link.
// With the words in shared memory the link is the warp's own instructions,
// issued in order, with dependent shared loads and popcounts among them, so
// at one warp per scheduler a link is the chain's latency and at the 64 MiB
// main blob's ~5 warps per scheduler it nears their instruction
// throughput.  The annotated link is one dependent shared load shorter
// where a lane consumes.  The annotate pass is bound by bytes: it reads
// 2 B and writes 4 B a word.
//
// Design: one warp per coded block in the decodes, both routes in one
// kernel body: the word type (u16 words, or the u32 annotation) and the
// source of a consumed lane's next rank are all that differ.  With n=64
// thread j holds lanes j and j+32 (two independent chains per thread), with
// n=32 lane j.  The warp builds its block's decode table in shared memory
// from the block's freq | cumul << 16 row, packed so that each lookup is one
// 8-byte shared load: per 32-slot bucket the rank of the symbol that owns
// its first slot and a bitmask of the symbol starts inside it
// (hsrans_tpu/ops/tpx.py::make_rank_tables), per rank {symbol | freq << 8,
// cumul} (10.3 KiB a warp at B=15; a flat slot -> symbol table would take
// 33 KiB).  At B <= kFlatMaxBits it also spreads the bucket table into a
// flat slot -> rank byte map (4 KiB a warp at B=12), which takes the bucket
// load and a popcount off the rank route's link.  The renorm words of a
// group go to the lanes in ascending lane order over all n lanes: a ballot
// over lanes 0..31, then one over lanes 32..63 offset by the first's
// popcount.  Both routes read them from a window of the block's words in
// shared memory (window.cuh: two halves of 1 KiB, kWindowHalf u16 words or
// kAnnWindowHalf u32 annotated words, 2 KiB a warp) that the warp refills
// by cp.async far ahead of the chain: when its cursor leaves a half it
// copies the half after the next into that slot, and it waits for a half
// only when the next group could read into it, ~half - 2n words of reading
// after the copy began.  Every lane reads (a consuming lane keeps the word
// and, annotated, its rank), so the warp never splits to reconverge, and
// each lane knows from the start the groups whose byte it writes, so no
// 64-bit arithmetic or per-group bound is left on the lanes.  The window
// zero-fills every byte outside the block's [0, min(word_end, nwords)), so
// a read past a block's words reads word 0 (and rank 0) and a corrupt blob
// cannot read out of bounds.  Lane j's symbol of group g goes to byte
// out_start + g*n + idx2idx[j] when that byte is below the block's
// out_limit (its end, or the blob's length for the last block).  The final
// states and the words consumed come back, for the host's partial tail
// group.  The annotate pass runs one CTA per coded block: its first warp
// builds the packed table, then all its threads stride over the block's
// words, a few loads in flight each; it also zeroes the words between
// blocks, so every word of the annotation is written.

#include <cstdint>
#include <cuda_runtime.h>

#include "window.cuh"

namespace {

constexpr int kWarps = 4;  // blocks (one warp each) per CTA of the decodes
// u16 words in each half of the rank route's stream window (a power of two,
// at least 256 and above 2n: a group reads at most n words); 1024 costs the
// 64 MiB main blob a CTA an SM (PERF.md)
constexpr int kWindowHalf = 512;
// u32 words in each half of the annotated route's window: the rank route's
// 1 KiB a half, so that both keep the main blob in one wave (PERF.md)
constexpr int kAnnWindowHalf = 256;
// the decodes look a slot's rank up in a flat slot -> rank byte map at B up
// to this (2^B bytes a warp; faster than the bucket table at B=12,
// PERF.md), in the bucket table above it
constexpr int kFlatMaxBits = 12;
static_assert((kWindowHalf & (kWindowHalf - 1)) == 0 && kWindowHalf >= 256, "window half: a power of two >= 256");
static_assert((kAnnWindowHalf & (kAnnWindowHalf - 1)) == 0 && kAnnWindowHalf >= 128,
              "annotated window half: a power of two >= 128");
constexpr int kAnnThreads = 256;  // threads of an annotate CTA (one coded block)
constexpr int kAnnUnroll = 4;     // words in flight per annotate thread
constexpr unsigned kFullMask = 0xFFFFFFFFu;
constexpr uint32_t kConsumePoint = 1u << 15;  // DECODE_CONSUME_POINT_16

// per-block index row (int64): the layout of kernels/mt_decode.py::INDEX_FIELDS
struct BlockIndex {
  long long word_start, word_end, out_start, out_limit, num_groups;
};

// idx2idx(32): lanes 8a + 4b + c -> byte 16b + 4a + c (hsrans_tpu/rans.py);
// idx2idx(64) is idx2idx(32) on each half, the upper half offset by 32
__device__ __forceinline__ int idx2idx32(int j) {
  return ((j >> 2) & 1) * 16 + (j >> 3) * 4 + (j & 3);
}

// 32-slot buckets of a 2^bits-slot table (at least one)
__host__ __device__ constexpr int buckets(int bits) { return ((1 << bits) + 31) / 32; }

// Thread j of a warp loads symbols 8j..8j+7 of a freq | cumul << 16 row into
// fcs and returns the rank of its first: the present (freq > 0) symbols
// before it.
__device__ __forceinline__ int load_symbols(uint32_t (&fcs)[8], const uint32_t* __restrict__ fc_row, int j) {
  int present = 0;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    fcs[q] = fc_row[8 * j + q];
    present += (fcs[q] & 0xFFFFu) != 0;
  }
  int incl = present;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(kFullMask, incl, d);
    if (j >= d) incl += v;
  }
  return incl - present;
}

// A block's rank table, each lookup one 8-byte shared load: per bucket
// {start mask without bit 0, rank of the symbol that owns its first slot},
// per rank {symbol | freq << 8, cumul}.  At B=15 it takes 10.3 KiB.
struct PackedTable {
  uint2* bucket;
  uint2* entry;
};

// 256 ranks and 32 more: a bucket's rank plus its popcount stays inside the
// table whatever the freqs
__host__ __device__ constexpr int packed_table_bytes(int bits) { return 8 * (buckets(bits) + 256 + 32); }

// the table's arrays in `tab` (packed_table_bytes(bits) of shared memory,
// 8-byte aligned)
__device__ __forceinline__ PackedTable packed_table_at(uint2* tab, int bits) { return {tab, tab + buckets(bits)}; }

// The table of the block whose freq | cumul << 16 row is fc_row, built in
// `tab` by the 32 threads of one warp, thread j.  Ends with __syncwarp: the
// warp may read it on return.
__device__ __forceinline__ PackedTable build_packed_table(uint2* tab, const uint32_t* __restrict__ fc_row, int bits,
                                                          int j) {
  const uint32_t n_slots = 1u << bits;
  const PackedTable t = packed_table_at(tab, bits);
  for (int i = j; i < buckets(bits); i += 32) t.bucket[i] = make_uint2(0u, 0u);
  uint32_t fcs[8];
  int rank = load_symbols(fcs, fc_row, j);
  __syncwarp();  // buckets zeroed before any start bit is set
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const uint32_t f = fcs[q] & 0xFFFFu, c = fcs[q] >> 16;
    if (f == 0 || c >= n_slots) continue;
    t.entry[rank] = make_uint2(static_cast<uint32_t>(8 * j + q) | f << 8, c);
    if (c & 31) atomicOr(&t.bucket[c >> 5].x, 1u << (c & 31));  // a bucket's first slot counts in its rank
    // buckets whose first slot lies in [c, c + f) start inside this symbol
    const uint32_t end = min(c + f, n_slots);
    for (uint32_t bk = (c + 31) >> 5; (bk << 5) < end; ++bk) t.bucket[bk].y = static_cast<uint32_t>(rank);
    ++rank;
  }
  __syncwarp();
  return t;
}

// the rank of the symbol that owns `slot`: its bucket's first rank plus the
// symbols that start in bits 1..slot % 32 of its bucket
__device__ __forceinline__ uint32_t packed_rank(const PackedTable& t, uint32_t slot) {
  const uint2 b = t.bucket[slot >> 5];
  return b.y + __popc(b.x << (~slot & 31u));
}

// u16 words or u32 annotated words in each half of a warp's window
template <typename Word>
__host__ __device__ constexpr int window_half() {
  return sizeof(Word) == sizeof(uint16_t) ? kWindowHalf : kAnnWindowHalf;
}

// shared memory of one warp's tables in mt_decode_kernel: the packed table,
// then with kFlat the slot -> rank map (16-byte multiples)
__host__ __device__ constexpr int decode_table_bytes(int bits, bool flat) {
  return (packed_table_bytes(bits) + (flat ? 1 << bits : 0) + 15) / 16 * 16;
}

// shared memory of one CTA of mt_decode_kernel: the warps' windows, then
// their tables
template <typename Word>
__host__ __device__ constexpr size_t decode_smem_bytes(int bits, bool flat) {
  return kWarps * (2 * window_half<Word>() * sizeof(Word) + decode_table_bytes(bits, flat));
}

// ceil(a / n) for any sign of a, n > 0
__device__ __forceinline__ long long ceil_div(long long a, int n) { return a > 0 ? (a + n - 1) / n : -((-a) / n); }

// Word = uint16_t: the rank route, reading the blob's words.  Word =
// uint32_t: the annotated route, reading the annotation (word | rank << 16)
// in their place, each lane carrying the rank of its slot.
template <int K, bool kFlat, typename Word>
__global__ void __launch_bounds__(kWarps * 32)
mt_decode_kernel(const Word* __restrict__ stream,       // [nwords] words or annotation (Word-aligned)
                 const BlockIndex* __restrict__ index,  // [nb]
                 const uint32_t* __restrict__ init,     // [nb, 32K] header states
                 const uint32_t* __restrict__ fctab,    // [nb, 256] freq | cumul << 16
                 uint8_t* __restrict__ out,             // [length]
                 uint32_t* __restrict__ fin,            // [nb, 32K] states after the last group
                 long long* __restrict__ cursor,        // [nb] words consumed
                 int nb, int bits, long long nwords, long long length) {
  extern __shared__ __align__(16) uint32_t dsmem[];
  constexpr bool kAnnotated = sizeof(Word) == sizeof(uint32_t);
  constexpr int kW = sizeof(Word);             // bytes a word
  constexpr int kHalf = window_half<Word>();   // words of a window half
  constexpr int kRing = 2 * kHalf;             // words of a warp's window
  constexpr int n = 32 * K;
  static_assert(kHalf >= 2 * n, "a half holds a group's reads twice over");
  const int w = threadIdx.x >> 5;
  const int j = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + w;
  if (b >= nb) return;  // warp-uniform; the kernel syncs only within a warp
  // typed as Word*: a byte pointer here let ptxas recompute the ring's
  // offset and the lane mask inside the group loop (+2.7 % at n=32, PERF.md)
  Word* ring = reinterpret_cast<Word*>(dsmem) + w * kRing;
  const uint32_t slot_mask = (1u << bits) - 1u;

  // ---- the window: word p of the stream at ring word (p - wbase) % kRing,
  //      wbase the block's first word rounded down to a 16-byte address;
  //      words at or past min(word_end, nwords), or below 0, read as 0.  Its
  //      first two halves are on their way while the warp builds its table.
  const BlockIndex ix = index[b];
  const long long word_end = min(ix.word_end, nwords);
  const uint8_t* src = reinterpret_cast<const uint8_t*>(stream);
  const int ph = window::phase(src, kW * ix.word_start) / kW;  // the block's first word's window position
  const long long wbase = ix.word_start - ph;
  long long next_half = 0;  // the next half to copy, into slot next_half % 2
  auto fill_next = [&]() {
    window::fill<kW * kHalf>(reinterpret_cast<uint8_t*>(ring + (next_half & 1) * kHalf), src,
                             kW * (wbase + next_half * kHalf), kW * word_end, j);
    ++next_half;
  };
  fill_next();
  fill_next();
  uint8_t* tables = reinterpret_cast<uint8_t*>(dsmem) + kWarps * kRing * kW + w * decode_table_bytes(bits, kFlat);
  const PackedTable t = build_packed_table(reinterpret_cast<uint2*>(tables), fctab + (size_t)b * 256, bits, j);
  uint8_t* rank_map = tables + packed_table_bytes(bits);  // with kFlat: slot -> rank
  if (kFlat) {
    for (uint32_t slot = j; slot <= slot_mask; slot += 32) rank_map[slot] = static_cast<uint8_t>(packed_rank(t, slot));
  }
  auto rank_at = [&](uint32_t slot) -> uint32_t { return kFlat ? rank_map[slot] : packed_rank(t, slot); };
  window::wait_all();
  __syncwarp();
  long long rel = ph;                     // window position of the block's next word
  long long refill_at = kHalf;            // once rel reaches it, the half below it is free
  long long ready_end = kRing;            // the window holds positions below it
  long long event = min(refill_at, ready_end - n + 1);  // the next rel at which either check fires

  // ---- the block's groups, lanes j + 32k in registers.  Lane j + 32k's
  //      symbol of group g goes to lane_out[k] + g*n when g lies in
  //      [g_lo[k], g_lo[k] + g_span[k]): its byte is in [0, out_limit)
  const int groups = static_cast<int>(min(ix.num_groups, static_cast<long long>(INT32_MAX)));
  const long long out_limit = min(ix.out_limit, length);
  const uint32_t lt = (1u << j) - 1u;
  uint32_t st[K];
  uint32_t rank[K];  // annotated: the rank of the lane's slot
  uint8_t* lane_out[K];
  int g_lo[K];
  unsigned g_span[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    st[k] = init[(size_t)b * n + j + 32 * k];
    if (kAnnotated) rank[k] = rank_at(st[k] & slot_mask);
    const long long first = ix.out_start + idx2idx32(j) + 32 * k;  // the lane's byte of group 0
    lane_out[k] = out + first;
    const long long lo = min(max(ceil_div(-first, n), 0LL), static_cast<long long>(groups));
    const long long hi = min(max(ceil_div(out_limit - first, n), lo), static_cast<long long>(groups));
    g_lo[k] = static_cast<int>(lo);
    g_span[k] = static_cast<unsigned>(hi - lo);
  }
  for (int g = 0; g < groups; ++g) {
    bool consume[K];
    unsigned ballot[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const uint32_t slot = st[k] & slot_mask;
      const uint2 e = t.entry[kAnnotated ? rank[k] : rank_at(slot)];
      st[k] = (st[k] >> bits) * (e.x >> 8) + slot - e.y;
      if (static_cast<unsigned>(g - g_lo[k]) < g_span[k])
        lane_out[k][static_cast<size_t>(g) * n] = static_cast<uint8_t>(e.x);  // the symbol: e.x's low byte
      consume[k] = st[k] < kConsumePoint;
      ballot[k] = __ballot_sync(kFullMask, consume[k]);
      // annotated: the next rank if the lane keeps its state, which depends
      // on neither the ballot nor the read, so it overlaps them
      if (kAnnotated) rank[k] = rank_at(st[k] & slot_mask);
    }
    // every lane reads (no branch to reconverge); a lane that consumes keeps
    // the word, and annotated its rank.  Ring offsets in bytes wrap, so 32
    // bits do.
    uint32_t at = kW * static_cast<uint32_t>(rel);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const uint32_t v = *reinterpret_cast<const Word*>(reinterpret_cast<const uint8_t*>(ring) +
                                                        ((at + kW * __popc(ballot[k] & lt)) & (kW * kRing - 1)));
      st[k] = consume[k] ? __byte_perm(v, st[k], 0x5410) : st[k];  // (st << 16) | (v & 0xFFFF)
      if (kAnnotated) rank[k] = consume[k] ? (v >> 16) & 0xFFu : rank[k];
      at += kW * __popc(ballot[k]);
    }
    rel += (at - kW * static_cast<uint32_t>(rel)) / kW;
    if (rel >= event) {
      // every later read lies at or past rel: once rel leaves a half, its
      // slot takes the half after the next, which has ~kHalf - 2n words of
      // reading to land before a group can reach it
      if (rel >= refill_at) {
        __syncwarp();  // every lane's reads of the slot are done
        fill_next();
        refill_at += kHalf;
      }
      if (rel + n > ready_end) {  // the next group may read into the half last copied
        window::wait_all();
        __syncwarp();
        ready_end += kHalf;
      }
      event = min(refill_at, ready_end - n + 1);
    }
  }
  window::wait_all();  // no copy may land after the warp leaves
#pragma unroll
  for (int k = 0; k < K; ++k) fin[(size_t)b * n + j + 32 * k] = st[k];
  if (j == 0) cursor[b] = rel - ph;
}

// ann[w] = word | rank(word & mask) << 16 for every word w of coded block
// blockIdx.x's [word_start, min(word_end, nwords)); the words from the
// previous block's end to this block's start (from 0 for the first block,
// and to nwords after the last) are 0.  The host's index has ascending,
// disjoint word ranges, so every word is written once.
__global__ void __launch_bounds__(kAnnThreads)
mt_annotate_kernel(const uint16_t* __restrict__ stream,   // [nwords] the blob's word region
                   const BlockIndex* __restrict__ index,  // [nb]
                   const uint32_t* __restrict__ fctab,    // [nb, 256] freq | cumul << 16
                   uint32_t* __restrict__ ann,            // [nwords]
                   int nb, int bits, long long nwords) {
  extern __shared__ __align__(16) uint32_t dsmem[];
  const int b = blockIdx.x;
  const uint32_t slot_mask = (1u << bits) - 1u;
  const long long lo = min(max(index[b].word_start, 0LL), nwords);
  const long long hi = max(lo, min(index[b].word_end, nwords));
  const long long gap_lo = b == 0 ? 0 : min(max(index[b - 1].word_end, 0LL), lo);
  for (long long w = gap_lo + threadIdx.x; w < lo; w += kAnnThreads) ann[w] = 0u;
  if (b == nb - 1)
    for (long long w = hi + threadIdx.x; w < nwords; w += kAnnThreads) ann[w] = 0u;
  uint2* tab = reinterpret_cast<uint2*>(dsmem);
  if (threadIdx.x < 32) build_packed_table(tab, fctab + (size_t)b * 256, bits, threadIdx.x);
  __syncthreads();
  const PackedTable t = packed_table_at(tab, bits);
  for (long long w0 = lo + threadIdx.x; w0 < hi; w0 += kAnnThreads * kAnnUnroll) {
    uint32_t word[kAnnUnroll];
#pragma unroll
    for (int u = 0; u < kAnnUnroll; ++u) {
      const long long w = w0 + u * kAnnThreads;
      word[u] = w < hi ? static_cast<uint32_t>(stream[w]) : 0u;
    }
#pragma unroll
    for (int u = 0; u < kAnnUnroll; ++u) {
      const long long w = w0 + u * kAnnThreads;
      if (w < hi) ann[w] = word[u] | (packed_rank(t, word[u] & slot_mask) << 16);
    }
  }
}

// One launch of mt_decode_kernel over Word-typed words (see the C entries)
template <typename Word>
int launch_decode(const void* stream, const void* index, const void* init, const void* fctab, void* out, void* fin,
                  void* cursor, int nb, int n, int bits, long long nwords, long long length, void* cuda_stream) {
  if (nb <= 0) return 0;
  if ((n != 32 && n != 64) || bits < 0 || bits > 15 || reinterpret_cast<uintptr_t>(stream) % sizeof(Word) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool flat = bits <= kFlatMaxBits;
  const auto kernel = n == 64 ? (flat ? mt_decode_kernel<2, true, Word> : mt_decode_kernel<2, false, Word>)
                              : (flat ? mt_decode_kernel<1, true, Word> : mt_decode_kernel<1, false, Word>);
  const size_t smem = decode_smem_bytes<Word>(bits, flat);  // 49 KB at B=15
  if (smem > 48 * 1024) {
    const cudaError_t set = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (set != cudaSuccess) return static_cast<int>(set);
  }
  const int blocks = (nb + kWarps - 1) / kWarps;
  kernel<<<blocks, kWarps * 32, smem, static_cast<cudaStream_t>(cuda_stream)>>>(
      static_cast<const Word*>(stream), static_cast<const BlockIndex*>(index), static_cast<const uint32_t*>(init),
      static_cast<const uint32_t*>(fctab), static_cast<uint8_t*>(out), static_cast<uint32_t*>(fin),
      static_cast<long long*>(cursor), nb, bits, nwords, length);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int hsr_mt_decode(const void* stream, const void* index, const void* init, const void* fctab,
                             void* out, void* fin, void* cursor, int nb, int n, int bits, long long nwords,
                             long long length, void* cuda_stream) {
  return launch_decode<uint16_t>(stream, index, init, fctab, out, fin, cursor, nb, n, bits, nwords, length,
                                 cuda_stream);
}

extern "C" int hsr_mt_annotate(const void* stream, const void* index, const void* fctab, void* ann, int nb, int bits,
                               long long nwords, void* cuda_stream) {
  if (nb <= 0) return 0;
  if (bits < 0 || bits > 15) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = packed_table_bytes(bits);  // <= 10.3 KB
  mt_annotate_kernel<<<nb, kAnnThreads, smem, static_cast<cudaStream_t>(cuda_stream)>>>(
      static_cast<const uint16_t*>(stream), static_cast<const BlockIndex*>(index),
      static_cast<const uint32_t*>(fctab), static_cast<uint32_t*>(ann), nb, bits, nwords);
  return static_cast<int>(cudaGetLastError());
}

// the annotation must be 4-byte aligned
extern "C" int hsr_mt_decode_annotated(const void* ann, const void* index, const void* init, const void* fctab,
                                       void* out, void* fin, void* cursor, int nb, int n, int bits, long long nwords,
                                       long long length, void* cuda_stream) {
  return launch_decode<uint32_t>(ann, index, init, fctab, out, fin, cursor, nb, n, bits, nwords, length, cuda_stream);
}
