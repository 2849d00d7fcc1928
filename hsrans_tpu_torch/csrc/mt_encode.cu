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
// chains, as the TPU kernel's serial segment chain does.  The placement is a
// copy of the emitted words plus a 0.8 KB header a block: bound by memory
// traffic.
//
// Design (encode): one warp per coded block, as csrc/mt_decode.cu.  With
// n=64 thread j holds lanes j and j+32, with n=32 lane j, starting from
// DECODE_CONSUME_POINT_16.  The warp builds its block's encode table in
// shared memory from the block's u16 freq row (the header's own): cumul by a
// warp scan, and per symbol the Granlund-Montgomery magic m of d = max(freq,
// 1), so q = x / d is (m * x) >> (31 + l) with l = ceil(log2 d), exact for
// every x < 2^31 (the rANS32 state invariant).  Per group, backward, lane j
// codes byte in_start + g*n + idx2idx[j]: it emits its low 16 bits when valid
// and state >= 2^(31-B) * e, then state = (q << B) + cumul + (x - q*d).  The
// state update is written with the remainder, not as q*(2^B - freq) + cumul
// + x, so that a symbol of freq 0 encodes exactly as the numpy oracle
// encodes it; e is freq (ops/reference.py::encode_groups) or d
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
// 0 and take part while below `valid_limit` (the host route of
// mt64_encode_tpu: valid up to the input's end; mt_encode_device: up to the
// block's end).
//
// Design (placement): one warp per coded block writes the block's whole part
// of the blob (size, offset, n final states, 256 freqs, then its words) as
// u16 stores at the part's offset, which the host computes from the counts.
// Every part is a whole number of u16, so the blob is one u16 array.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;  // blocks (one warp each) per CTA
constexpr unsigned kFullMask = 0xFFFFFFFFu;
constexpr uint32_t kFreshState = 1u << 15;  // DECODE_CONSUME_POINT_16

// per-block index row (int64): the layout of kernels/mt_encode.py::INDEX_FIELDS
struct EncIndex {
  long long in_start, num_groups, byte_limit, valid_limit, region_end;
};

// per-block placement row (int64): kernels/mt_encode.py::PLACE_FIELDS
struct PlaceRow {
  long long dest, size_field, offset_bias;
};

// idx2idx(32): lanes 8a + 4b + c -> byte 16b + 4a + c (hsrans_tpu/rans.py);
// idx2idx(64) is idx2idx(32) on each half, the upper half offset by 32
__device__ __forceinline__ int idx2idx32(int j) {
  return ((j >> 2) & 1) * 16 + (j >> 3) * 4 + (j & 3);
}

template <int K>
__global__ void __launch_bounds__(kWarps * 32)
mt_encode_kernel(const uint8_t* __restrict__ data,     // [data_len] the input
                 const EncIndex* __restrict__ index,   // [nb]
                 const uint16_t* __restrict__ freqs,   // [nb, 256] the header's freqs (sum 2^bits)
                 uint16_t* __restrict__ words,         // [words_cap] scratch; block b's region ends at region_end
                 uint32_t* __restrict__ fin,           // [nb, 32K] final (= header) states
                 long long* __restrict__ count,        // [nb] words emitted
                 int nb, int bits, int zero_freq_emits, long long data_len, long long words_cap) {
  // per symbol: x = cumul | e << 16, y = magic m
  __shared__ uint2 tab_all[kWarps][256];
  constexpr int n = 32 * K;
  const int w = threadIdx.x >> 5;
  const int j = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + w;
  if (b >= nb) return;  // warp-uniform; the kernel syncs only within a warp
  uint2* tab = tab_all[w];

  // ---- the block's table: thread j owns symbols 8j..8j+7
  uint32_t f[8];
  uint32_t sum = 0;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    f[q] = freqs[(size_t)b * 256 + 8 * j + q];
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
    const uint32_t m = static_cast<uint32_t>(((1ull << (31 + l)) + d - 1) / d);
    const uint32_t e = zero_freq_emits ? f[q] : d;
    tab[8 * j + q] = make_uint2((cum & 0xFFFFu) | (e << 16), m);  // cumul is u16 on the wire
    cum += f[q];
  }
  __syncwarp();

  // ---- the block's groups, backward, lanes j + 32k in registers
  const EncIndex ix = index[b];
  const long long byte_limit = min(ix.byte_limit, data_len);
  const int emit_shift = 31 - bits;
  const uint32_t lt = (1u << j) - 1u;
  uint32_t st[K];
  int byte_of[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    st[k] = kFreshState;
    byte_of[k] = idx2idx32(j) + 32 * k;
  }
  long long tail = ix.region_end;  // the block's words so far sit at [tail, region_end)
  for (long long g = ix.num_groups - 1; g >= 0; --g) {
    const long long group_pos = ix.in_start + g * n;
    bool emit[K];
    uint32_t word[K];
    unsigned ballot[K];
    int c = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const long long pos = group_pos + byte_of[k];
      const uint32_t byte = pos >= 0 && pos < byte_limit ? data[pos] : 0u;
      const bool valid = pos < ix.valid_limit;
      const uint2 t = tab[byte];
      const uint32_t e = t.x >> 16;
      emit[k] = valid && st[k] >= (e << emit_shift);
      word[k] = st[k] & 0xFFFFu;
      if (valid) {
        const uint32_t x = emit[k] ? st[k] >> 16 : st[k];
        const uint32_t d = max(e, 1u);
        const uint32_t l = 32 - __clz(d - 1);
        const uint32_t q = static_cast<uint32_t>((static_cast<uint64_t>(t.y) * x) >> (31 + l));
        st[k] = (q << bits) + (t.x & 0xFFFFu) + (x - q * d);
      }
      ballot[k] = __ballot_sync(kFullMask, emit[k]);
      c += __popc(ballot[k]);
    }
    tail -= c;
    long long base = tail;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const long long at = base + __popc(ballot[k] & lt);
      if (emit[k] && at >= 0 && at < words_cap) words[at] = static_cast<uint16_t>(word[k]);
      base += __popc(ballot[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) fin[(size_t)b * n + j + 32 * k] = st[k];
  if (j == 0) count[b] = ix.region_end - tail;
}

template <int K>
__global__ void __launch_bounds__(kWarps * 32)
mt_place_kernel(const uint16_t* __restrict__ words,    // [words_cap] the encode's scratch
                const EncIndex* __restrict__ index,    // [nb]
                const long long* __restrict__ count,   // [nb]
                const uint32_t* __restrict__ fin,      // [nb, 32K]
                const uint16_t* __restrict__ freqs,    // [nb, 256]
                const PlaceRow* __restrict__ place,    // [nb]
                uint16_t* __restrict__ out,            // [out_len] the blob as u16
                int nb, long long words_cap, long long out_len) {
  constexpr int n = 32 * K;
  constexpr int kHeader = 4 + 4 + 2 * n + 256;  // u16s of size, offset, states, freqs
  const int j = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= nb) return;
  const PlaceRow p = place[b];
  const long long w = count[b];
  const long long src = index[b].region_end - w;
  const unsigned long long offset = 2ull * n + 256 + w - p.offset_bias;
  for (int i = j; i < kHeader; i += 32) {
    uint32_t v;
    if (i < 4) {
      v = static_cast<uint32_t>(static_cast<unsigned long long>(p.size_field) >> (16 * i));
    } else if (i < 8) {
      v = static_cast<uint32_t>(offset >> (16 * (i - 4)));
    } else if (i < 8 + 2 * n) {
      v = fin[(size_t)b * n + ((i - 8) >> 1)] >> (16 * ((i - 8) & 1));
    } else {
      v = freqs[(size_t)b * 256 + (i - 8 - 2 * n)];
    }
    const long long at = p.dest + i;
    if (at >= 0 && at < out_len) out[at] = static_cast<uint16_t>(v);
  }
  for (long long i = j; i < w; i += 32) {
    const long long at = p.dest + kHeader + i;
    const long long from = src + i;
    if (at >= 0 && at < out_len && from >= 0 && from < words_cap) out[at] = words[from];
  }
}

}  // namespace

extern "C" int hsr_mt_encode(const void* data, const void* index, const void* freqs, void* words, void* fin,
                             void* count, int nb, int n, int bits, int zero_freq_emits, long long data_len,
                             long long words_cap, void* cuda_stream) {
  if (nb <= 0) return 0;
  if ((n != 32 && n != 64) || bits < 1 || bits > 15) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t cs = static_cast<cudaStream_t>(cuda_stream);
  const int blocks = (nb + kWarps - 1) / kWarps;
  const auto* d = static_cast<const uint8_t*>(data);
  const auto* ix = static_cast<const EncIndex*>(index);
  const auto* fq = static_cast<const uint16_t*>(freqs);
  auto* wd = static_cast<uint16_t*>(words);
  auto* fs = static_cast<uint32_t*>(fin);
  auto* ct = static_cast<long long*>(count);
  if (n == 64)
    mt_encode_kernel<2><<<blocks, kWarps * 32, 0, cs>>>(d, ix, fq, wd, fs, ct, nb, bits, zero_freq_emits, data_len, words_cap);
  else
    mt_encode_kernel<1><<<blocks, kWarps * 32, 0, cs>>>(d, ix, fq, wd, fs, ct, nb, bits, zero_freq_emits, data_len, words_cap);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hsr_mt_place(const void* words, const void* index, const void* count, const void* fin,
                            const void* freqs, const void* place, void* out, int nb, int n, long long words_cap,
                            long long out_len, void* cuda_stream) {
  if (nb <= 0) return 0;
  if (n != 32 && n != 64) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t cs = static_cast<cudaStream_t>(cuda_stream);
  const int blocks = (nb + kWarps - 1) / kWarps;
  const auto* wd = static_cast<const uint16_t*>(words);
  const auto* ix = static_cast<const EncIndex*>(index);
  const auto* ct = static_cast<const long long*>(count);
  const auto* fs = static_cast<const uint32_t*>(fin);
  const auto* fq = static_cast<const uint16_t*>(freqs);
  const auto* pl = static_cast<const PlaceRow*>(place);
  auto* o = static_cast<uint16_t*>(out);
  if (n == 64)
    mt_place_kernel<2><<<blocks, kWarps * 32, 0, cs>>>(wd, ix, ct, fs, fq, pl, o, nb, words_cap, out_len);
  else
    mt_place_kernel<1><<<blocks, kWarps * 32, 0, cs>>>(wd, ix, ct, fs, fq, pl, o, nb, words_cap, out_len);
  return static_cast<int>(cudaGetLastError());
}
