// mt decode on Hopper: every coded block of an mt_rANS32xN 16w blob in one
// launch, by one of two routes.
//
// The rank route, mt_decode_kernel, replaces four Pallas TPU kernels of
// hsrans_tpu/kernels/, which differ only in how they pack 32- or 64-lane
// blocks into 128-lane TPU rows:
//   mt64_decode.py::_mt64_kernel           (one block per row)
//   mt64_decode.py::_mt64_pair_kernel      (two n=64 blocks per row, B<=12)
//   mt64_decode.py::_mt64_pair_kernel_hb   (pairs at B=13..15)
//   mt32_quad.py::_mt32_quad_kernel        (four n=32 blocks per row, B<=12)
// A warp has no such width problem, so one kernel covers all four.
//
// The annotated-stream route replaces the two Pallas kernels of the JAX
// package's `_PAIR_V2` route (mt64_decode.py::_decode_pairs_v2):
//   mt64_decode.py::_annotate_pairs        -> mt_annotate_kernel
//   mt64_decode.py::_mt64_pair_kernel_v2   -> mt_decode_annotated_kernel
// At B <= 15 a lane that has just renormalised, st = (st << 16) | word, has
// next slot exactly word & mask, since (st << 16) & mask == 0.  So a fully
// parallel pass stamps every word of a block with rank(word & mask) in its
// bits 16..23 (ann = word | rank << 16), and the serial decode takes a
// consumed lane's next rank from the word it reads: the two shared-memory
// rank lookups leave that lane's link.  A lane that does not consume still
// looks its rank up, but from its new state alone, off the ballot and the
// load.  A read past a block's words gives word 0 and rank 0, which is
// rank_of(0): slot 0 belongs to the first present symbol.  The route holds
// for n = 32 and 64 and any B <= 15, and gives the rank route's bytes.
//
// What bounds the decodes: each block's n states form one serial chain per
// lane (table lookup -> state update -> renorm read) of ceil(size/n) links;
// the bytes and arithmetic are small, so the number of blocks in flight and
// the latency of one link set the rate.  A block is never split, so a blob
// of a few giant blocks (the reference planner's, up to 2^25 bytes) leaves
// the card with few chains.  The annotate pass is bound by bytes: it reads
// 2 B and writes 4 B a word.
//
// Design: one warp per coded block in the decodes.  With n=64 thread j holds
// lanes j and j+32 (two independent chains per thread), with n=32 lane j.
// The warp builds its block's decode table in shared memory from the block's
// freq | cumul << 16 row: the bucketed rank table of hsrans_tpu/ops/tpx.py::
// make_rank_tables (per 32-slot bucket the rank of its first slot's symbol
// and a bitmask of the symbol starts inside it; 6.3 KiB a warp at B=15
// where a flat slot -> symbol table takes 33 KiB, so a block of four warps
// keeps within the default 48 KiB of shared memory; on the H100 it also
// beat the flat table at B=10..12).  The renorm words of a group go to the
// lanes in ascending lane order over all n lanes: a ballot over lanes
// 0..31, then one over lanes 32..63 offset by the first's popcount.  The
// stream is the blob's u16 word region as it is (the rank route) or its
// annotation (the annotated route); every read is clamped to the block's
// [word_start, word_end) and a word past it reads as 0, so a corrupt blob
// cannot read out of bounds.  Lane j's symbol of group g goes to byte
// out_start + g*n + idx2idx[j] when that byte is below the block's
// out_limit (its end, or the blob's length for the last block).  The final
// states and the words consumed come back, for the host's partial tail
// group.  The annotate pass runs one CTA per coded block: its first warp
// builds the same table, then all its threads stride over the block's
// words, a few loads in flight each; it also zeroes the words between
// blocks, so every word of the annotation is written.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;  // blocks (one warp each) per CTA of the decodes
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

// 32-bit words of shared memory one warp's table takes: fc and symbol by
// rank, then per bucket a u8 rank (c0) and a u32 start mask (bm)
__host__ __device__ constexpr int table_words(int bits) {
  return 256 + 64 + (buckets(bits) + 3) / 4 + buckets(bits);
}

// one block's rank table in shared memory
struct RankTable {
  uint32_t* fc;  // by rank: freq | cumul << 16
  uint8_t* sym;  // by rank
  uint8_t* c0;   // by bucket: the rank of the symbol that owns its first slot
  uint32_t* bm;  // by bucket: a bit at each slot where a symbol starts
};

// the table's arrays in `tab` (table_words(bits) words of shared memory)
__device__ __forceinline__ RankTable rank_table_at(uint32_t* tab, int bits) {
  return {tab, reinterpret_cast<uint8_t*>(tab + 256), reinterpret_cast<uint8_t*>(tab + 256 + 64),
          tab + 256 + 64 + (buckets(bits) + 3) / 4};
}

// The table of the block whose freq | cumul << 16 row is fc_row, built in
// `tab` (table_words(bits) words) by the 32 threads of one warp, thread j.
// Ends with __syncwarp: the warp may read it on return.
__device__ __forceinline__ RankTable build_rank_table(uint32_t* tab, const uint32_t* __restrict__ fc_row, int bits,
                                                      int j) {
  const uint32_t n_slots = 1u << bits;
  const RankTable t = rank_table_at(tab, bits);
  for (int i = j; i < buckets(bits); i += 32) t.bm[i] = 0u;
  // thread j owns symbols 8j..8j+7; rank = present symbols before it
  uint32_t fcs[8];
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
  int rank = incl - present;
  __syncwarp();  // bm zeroed before any start bit is set
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const uint32_t f = fcs[q] & 0xFFFFu, c = fcs[q] >> 16;
    if (f == 0 || c >= n_slots) continue;
    t.fc[rank] = fcs[q];
    t.sym[rank] = static_cast<uint8_t>(8 * j + q);
    atomicOr(&t.bm[c >> 5], 1u << (c & 31));
    // buckets whose first slot lies in [c, c + f) start inside this symbol
    const uint32_t end = min(c + f, n_slots);
    for (uint32_t bk = (c + 31) >> 5; (bk << 5) < end; ++bk) t.c0[bk] = static_cast<uint8_t>(rank);
    ++rank;
  }
  __syncwarp();
  return t;
}

// the rank of the symbol that owns `slot`: its bucket's first rank plus the
// symbols that start after the bucket's first slot and at or before `slot`
__device__ __forceinline__ uint32_t rank_of(const RankTable& t, uint32_t slot) {
  const uint32_t bk = slot >> 5;
  return t.c0[bk] + __popc(t.bm[bk] & ((2u << (slot & 31)) - 2u));
}

template <int K>
__global__ void __launch_bounds__(kWarps * 32)
mt_decode_kernel(const uint16_t* __restrict__ stream,   // [nwords] the blob's word region
                 const BlockIndex* __restrict__ index,  // [nb]
                 const uint32_t* __restrict__ init,     // [nb, 32K] header states
                 const uint32_t* __restrict__ fctab,    // [nb, 256] freq | cumul << 16
                 uint8_t* __restrict__ out,             // [length]
                 uint32_t* __restrict__ fin,            // [nb, 32K] states after the last group
                 long long* __restrict__ cursor,        // [nb] words consumed
                 int nb, int bits, long long nwords, long long length) {
  extern __shared__ uint32_t smem[];
  constexpr int n = 32 * K;
  const int w = threadIdx.x >> 5;
  const int j = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + w;
  if (b >= nb) return;  // warp-uniform; the kernel syncs only within a warp
  const uint32_t slot_mask = (1u << bits) - 1u;
  const RankTable t = build_rank_table(smem + w * table_words(bits), fctab + (size_t)b * 256, bits, j);

  // ---- the block's groups, lanes j + 32k in registers
  const BlockIndex ix = index[b];
  // a corrupt index row stays inside the stream and the output all the same
  const long long word_end = min(ix.word_end, nwords);
  const long long out_limit = min(ix.out_limit, length);
  const uint32_t lt = (1u << j) - 1u;
  uint32_t st[K];
  int byte_of[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    st[k] = init[(size_t)b * n + j + 32 * k];
    byte_of[k] = idx2idx32(j) + 32 * k;
  }
  long long rw = 0;  // words of the block consumed so far
  for (long long g = 0; g < ix.num_groups; ++g) {
    const long long group_pos = ix.out_start + g * n;
    bool consume[K];
    unsigned ballot[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const uint32_t slot = st[k] & slot_mask;
      const uint32_t r = rank_of(t, slot);
      const uint32_t sym = t.sym[r], fc = t.fc[r];
      st[k] = (st[k] >> bits) * (fc & 0xFFFFu) + slot - (fc >> 16);
      const long long pos = group_pos + byte_of[k];
      if (pos >= 0 && pos < out_limit) out[pos] = static_cast<uint8_t>(sym);
      consume[k] = st[k] < kConsumePoint;
      ballot[k] = __ballot_sync(kFullMask, consume[k]);
    }
    long long base = rw;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (consume[k]) {
        const long long a = ix.word_start + base + __popc(ballot[k] & lt);
        st[k] = (st[k] << 16) | (a >= 0 && a < word_end ? static_cast<uint32_t>(stream[a]) : 0u);
      }
      base += __popc(ballot[k]);
    }
    rw = base;
  }
#pragma unroll
  for (int k = 0; k < K; ++k) fin[(size_t)b * n + j + 32 * k] = st[k];
  if (j == 0) cursor[b] = rw;
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
  extern __shared__ uint32_t smem[];
  const int b = blockIdx.x;
  const uint32_t slot_mask = (1u << bits) - 1u;
  const long long lo = min(max(index[b].word_start, 0LL), nwords);
  const long long hi = max(lo, min(index[b].word_end, nwords));
  const long long gap_lo = b == 0 ? 0 : min(max(index[b - 1].word_end, 0LL), lo);
  for (long long w = gap_lo + threadIdx.x; w < lo; w += kAnnThreads) ann[w] = 0u;
  if (b == nb - 1)
    for (long long w = hi + threadIdx.x; w < nwords; w += kAnnThreads) ann[w] = 0u;
  if (threadIdx.x < 32) build_rank_table(smem, fctab + (size_t)b * 256, bits, threadIdx.x);
  __syncthreads();
  const RankTable t = rank_table_at(smem, bits);
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
      if (w < hi) ann[w] = word[u] | (rank_of(t, word[u] & slot_mask) << 16);
    }
  }
}

// mt_decode_kernel's contract, reading the annotation in place of the words
template <int K>
__global__ void __launch_bounds__(kWarps * 32)
mt_decode_annotated_kernel(const uint32_t* __restrict__ ann,      // [nwords] word | rank << 16
                           const BlockIndex* __restrict__ index,  // [nb]
                           const uint32_t* __restrict__ init,     // [nb, 32K] header states
                           const uint32_t* __restrict__ fctab,    // [nb, 256] freq | cumul << 16
                           uint8_t* __restrict__ out,             // [length]
                           uint32_t* __restrict__ fin,            // [nb, 32K] states after the last group
                           long long* __restrict__ cursor,        // [nb] words consumed
                           int nb, int bits, long long nwords, long long length) {
  extern __shared__ uint32_t smem[];
  constexpr int n = 32 * K;
  const int w = threadIdx.x >> 5;
  const int j = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + w;
  if (b >= nb) return;  // warp-uniform; the kernel syncs only within a warp
  const uint32_t slot_mask = (1u << bits) - 1u;
  const RankTable t = build_rank_table(smem + w * table_words(bits), fctab + (size_t)b * 256, bits, j);

  const BlockIndex ix = index[b];
  const long long word_end = min(ix.word_end, nwords);
  const long long out_limit = min(ix.out_limit, length);
  const uint32_t lt = (1u << j) - 1u;
  uint32_t st[K], rank[K];
  int byte_of[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    st[k] = init[(size_t)b * n + j + 32 * k];
    rank[k] = rank_of(t, st[k] & slot_mask);
    byte_of[k] = idx2idx32(j) + 32 * k;
  }
  long long rw = 0;  // words of the block consumed so far
  for (long long g = 0; g < ix.num_groups; ++g) {
    const long long group_pos = ix.out_start + g * n;
    bool consume[K];
    unsigned ballot[K];
    uint32_t kept_rank[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const uint32_t sym = t.sym[rank[k]], fc = t.fc[rank[k]];
      st[k] = (st[k] >> bits) * (fc & 0xFFFFu) + (st[k] & slot_mask) - (fc >> 16);
      const long long pos = group_pos + byte_of[k];
      if (pos >= 0 && pos < out_limit) out[pos] = static_cast<uint8_t>(sym);
      consume[k] = st[k] < kConsumePoint;
      ballot[k] = __ballot_sync(kFullMask, consume[k]);
      // the next rank if the lane keeps its state: depends on neither the
      // ballot nor the load, so it overlaps them
      kept_rank[k] = rank_of(t, st[k] & slot_mask);
    }
    long long base = rw;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      rank[k] = kept_rank[k];
      if (consume[k]) {
        const long long a = ix.word_start + base + __popc(ballot[k] & lt);
        // a read past the block's words gives word 0 and rank 0: slot 0
        // belongs to the first present symbol, so rank_of(0) = 0
        const uint32_t v = a >= 0 && a < word_end ? ann[a] : 0u;
        st[k] = (st[k] << 16) | (v & 0xFFFFu);
        rank[k] = (v >> 16) & 0xFFu;
      }
      base += __popc(ballot[k]);
    }
    rw = base;
  }
#pragma unroll
  for (int k = 0; k < K; ++k) fin[(size_t)b * n + j + 32 * k] = st[k];
  if (j == 0) cursor[b] = rw;
}

template <typename Word>
using DecodeKernel = void (*)(const Word*, const BlockIndex*, const uint32_t*, const uint32_t*, uint8_t*, uint32_t*,
                              long long*, int, int, long long, long long);

template <typename Word>
cudaError_t launch_decode(DecodeKernel<Word> kernel, const void* stream, const void* index, const void* init,
                          const void* fctab, void* out, void* fin, void* cursor, int nb, int bits, long long nwords,
                          long long length, cudaStream_t cs) {
  const int blocks = (nb + kWarps - 1) / kWarps;
  const size_t smem = sizeof(uint32_t) * kWarps * table_words(bits);  // <= 25.6 KB
  kernel<<<blocks, kWarps * 32, smem, cs>>>(
      static_cast<const Word*>(stream), static_cast<const BlockIndex*>(index), static_cast<const uint32_t*>(init),
      static_cast<const uint32_t*>(fctab), static_cast<uint8_t*>(out), static_cast<uint32_t*>(fin),
      static_cast<long long*>(cursor), nb, bits, nwords, length);
  return cudaGetLastError();
}

}  // namespace

extern "C" int hsr_mt_decode(const void* stream, const void* index, const void* init, const void* fctab,
                             void* out, void* fin, void* cursor, int nb, int n, int bits, long long nwords,
                             long long length, void* cuda_stream) {
  if (nb <= 0) return 0;
  if ((n != 32 && n != 64) || bits < 0 || bits > 15) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t cs = static_cast<cudaStream_t>(cuda_stream);
  const cudaError_t err = launch_decode<uint16_t>(n == 64 ? mt_decode_kernel<2> : mt_decode_kernel<1>, stream, index,
                                                  init, fctab, out, fin, cursor, nb, bits, nwords, length, cs);
  return static_cast<int>(err);
}

extern "C" int hsr_mt_annotate(const void* stream, const void* index, const void* fctab, void* ann, int nb, int bits,
                               long long nwords, void* cuda_stream) {
  if (nb <= 0) return 0;
  if (bits < 0 || bits > 15) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(uint32_t) * table_words(bits);  // <= 6.3 KB
  mt_annotate_kernel<<<nb, kAnnThreads, smem, static_cast<cudaStream_t>(cuda_stream)>>>(
      static_cast<const uint16_t*>(stream), static_cast<const BlockIndex*>(index),
      static_cast<const uint32_t*>(fctab), static_cast<uint32_t*>(ann), nb, bits, nwords);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hsr_mt_decode_annotated(const void* ann, const void* index, const void* init, const void* fctab,
                                       void* out, void* fin, void* cursor, int nb, int n, int bits, long long nwords,
                                       long long length, void* cuda_stream) {
  if (nb <= 0) return 0;
  if ((n != 32 && n != 64) || bits < 0 || bits > 15) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t cs = static_cast<cudaStream_t>(cuda_stream);
  const cudaError_t err =
      launch_decode<uint32_t>(n == 64 ? mt_decode_annotated_kernel<2> : mt_decode_annotated_kernel<1>, ann, index,
                              init, fctab, out, fin, cursor, nb, bits, nwords, length, cs);
  return static_cast<int>(err);
}
