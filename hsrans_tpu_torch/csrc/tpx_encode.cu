// tpx megablock encode on Hopper: the rANS state machine and the per-row
// stream concatenation, as two kernels.
//
// tpx_encode_kernel replaces hsrans_tpu/kernels/tpx_encode.py::_encode_kernel
// (launched by _encode_mega); tpx_concat_kernel replaces ::_concat_kernel
// (launched by _concat_mega), which the mt encoder reuses as its phase B.
//
// What bounds them: the encode is a serial dependent chain per rANS state
// (emit test -> shift -> divide by freq -> state update) over every step of
// every tile, run in reverse; the rate is set by chains in flight and the
// latency of one link, not by bytes or arithmetic throughput.  The concat is
// a copy of the emitted words (about 5 bytes read and 2 written per word
// kept), bounded by memory traffic and by the serial walk over each row's
// steps.
//
// Design (encode): one warp per tpx row, the same lane mapping as the decode
// (thread j owns lanes j+32k), walking tiles, step groups and steps backward
// with the four states per thread in registers, starting from
// DECODE_CONSUME_POINT_16.  The per-tile encode tables of
// make_enc_tables_batch (fc, division magic m, shift l) sit in shared
// memory; q = state / freq is the Granlund-Montgomery magic multiply
// (m * x) >> (31 + l), exact for every state < 2^31.  Each step's emitted
// words are compacted in lane order with the ballot + popc prefix
// (tpx_common.cuh) into the step's window; window slots past the count are
// written 0, as the TPU kernel leaves them.
//
// Design (concat): one warp per (tile, row).  It walks the row's steps in
// order, keeping the running word offset (the exclusive prefix of the step
// counts), and stores each word as one u16 at its offset of the row's
// [2 * w_slots] u16 view — two words per u32 slot, low half first, exactly
// the wire's slot layout — then zero-fills the rest of the row.  The 16-step
// segmentation and chunk passes of the TPU kernel were Mosaic workarounds and
// have no counterpart here.

#include "tpx_common.cuh"

namespace {

using tpx::kLanes;
using tpx::kWarps;

__global__ void __launch_bounds__(kWarps * 32)
tpx_encode_kernel(const uint32_t* __restrict__ packed,  // [T, R, S/4, 128] input bytes, 4 steps per u32
                  const uint32_t* __restrict__ fctab,   // [T, 256] B<=12: freq | cumul<<13 | l<<25; else freq | cumul<<16
                  const uint32_t* __restrict__ mtab,    // [T, 256] division magic
                  const uint32_t* __restrict__ ltab,    // [T, 256] division shift (read for B>=13)
                  uint32_t* __restrict__ win,           // [T, S, R, 128] per-step compacted words
                  uint32_t* __restrict__ cnt,           // [T, R, S] per-step word counts
                  uint32_t* __restrict__ states_out,    // [R, 128] final (decode-start) states
                  int rows, int steps, int n_tiles, int bits, long long vlen) {
  __shared__ uint32_t fc_s[256];
  __shared__ uint32_t m_s[256];
  __shared__ uint32_t l_s[256];
  const int j = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const bool active = r < rows;
  const uint32_t lt = tpx::lanemask_lt();
  const int s4c = steps >> 2;
  const uint32_t emit_point = 1u << (31 - bits);  // state >= emit_point * freq fits u32 even at freq = 2^B
  const uint32_t total = 1u << bits;

  uint32_t st[4] = {tpx::kConsumePoint, tpx::kConsumePoint, tpx::kConsumePoint, tpx::kConsumePoint};
  for (int t = n_tiles - 1; t >= 0; --t) {
    __syncthreads();  // every warp is done with the previous tile's tables
    for (int i = threadIdx.x; i < 256; i += blockDim.x) {
      fc_s[i] = fctab[(size_t)t * 256 + i];
      m_s[i] = mtab[(size_t)t * 256 + i];
      l_s[i] = ltab[(size_t)t * 256 + i];
    }
    __syncthreads();
    if (!active) continue;

    const size_t row_id = (size_t)t * rows + r;
    const long long row_pos = (long long)row_id * s4c * kLanes * 4;
    for (int s4 = s4c - 1; s4 >= 0; --s4) {
      uint32_t pk[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) pk[k] = packed[(row_id * s4c + s4) * kLanes + j + 32 * k];
      for (int i = 3; i >= 0; --i) {
        bool emit[4];
        uint32_t word[4];
        unsigned ballot[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const uint32_t byte = (pk[k] >> (8 * i)) & 0xFFu;
          const uint32_t fc = fc_s[byte];
          uint32_t freq, cum, shift;
          if (bits <= 12) {
            freq = fc & 0x1FFFu;
            cum = (fc >> 13) & 0xFFFu;
            shift = fc >> 25;
          } else {
            freq = fc & 0xFFFFu;
            cum = fc >> 16;
            shift = l_s[byte];
          }
          const long long pos = row_pos + ((long long)s4 * kLanes + j + 32 * k) * 4 + i;
          const bool valid = pos < vlen;  // past the data: nothing emitted, state kept
          emit[k] = valid && st[k] >= emit_point * freq;
          word[k] = st[k] & 0xFFFFu;
          if (valid) {
            const uint32_t x = emit[k] ? st[k] >> 16 : st[k];
            const uint32_t q = static_cast<uint32_t>((static_cast<uint64_t>(m_s[byte]) * x) >> (31 + shift));
            st[k] = q * (total - freq) + cum + x;  // == (q << B) + cum + x % freq
          }
          ballot[k] = __ballot_sync(tpx::kFullMask, emit[k]);
        }
        const int s = s4 * 4 + i;
        uint32_t* wrow = win + (((size_t)t * steps + s) * rows + r) * kLanes;
        int n = 0;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (emit[k]) wrow[n + __popc(ballot[k] & lt)] = word[k];
          n += __popc(ballot[k]);
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (j + 32 * k >= n) wrow[j + 32 * k] = 0u;
        }
        if (j == 0) cnt[row_id * steps + s] = n;
      }
    }
  }
  if (active) {
#pragma unroll
    for (int k = 0; k < 4; ++k) states_out[(size_t)r * kLanes + j + 32 * k] = st[k];
  }
}

__global__ void __launch_bounds__(kWarps * 32)
tpx_concat_kernel(const uint32_t* __restrict__ win,  // [T, S, R, 128] per-step compacted words
                  const uint32_t* __restrict__ cnt,  // [T, R, S] per-step word counts
                  uint16_t* __restrict__ out,        // [T, R, 2 * w_slots] (the u32 slots as u16 pairs)
                  int rows, int steps, int n_tiles, int w_slots) {
  const int j = threadIdx.x & 31;
  const long long g = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);  // = t * rows + r
  if (g >= (long long)n_tiles * rows) return;
  const int t = static_cast<int>(g / rows);
  const int r = static_cast<int>(g % rows);
  const uint32_t* c = cnt + g * steps;
  uint16_t* o = out + g * 2 * w_slots;
  const int cap = 2 * w_slots;
  int base = 0;  // words of the row placed so far
  for (int s = 0; s < steps; ++s) {
    const int n = min(static_cast<int>(c[s]), kLanes);
    const uint32_t* w = win + (((size_t)t * steps + s) * rows + r) * kLanes;
    for (int k = j; k < n; k += 32) {
      if (base + k < cap) o[base + k] = static_cast<uint16_t>(w[k]);
    }
    base += n;
  }
  for (int d = base + j; d < cap; d += 32) o[d] = 0;
}

}  // namespace

extern "C" int hsr_tpx_encode(const void* packed, const void* fctab, const void* mtab, const void* ltab,
                              void* win, void* cnt, void* states, int rows, int steps, int n_tiles,
                              int bits, long long vlen, void* cuda_stream) {
  const int blocks = (rows + kWarps - 1) / kWarps;
  tpx_encode_kernel<<<blocks, kWarps * 32, 0, static_cast<cudaStream_t>(cuda_stream)>>>(
      static_cast<const uint32_t*>(packed), static_cast<const uint32_t*>(fctab),
      static_cast<const uint32_t*>(mtab), static_cast<const uint32_t*>(ltab),
      static_cast<uint32_t*>(win), static_cast<uint32_t*>(cnt), static_cast<uint32_t*>(states),
      rows, steps, n_tiles, bits, vlen);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hsr_tpx_concat(const void* win, const void* cnt, void* out, int rows, int steps, int n_tiles,
                              int w_slots, void* cuda_stream) {
  const long long warps = (long long)n_tiles * rows;
  const int blocks = static_cast<int>((warps + kWarps - 1) / kWarps);
  tpx_concat_kernel<<<blocks, kWarps * 32, 0, static_cast<cudaStream_t>(cuda_stream)>>>(
      static_cast<const uint32_t*>(win), static_cast<const uint32_t*>(cnt), static_cast<uint16_t*>(out),
      rows, steps, n_tiles, w_slots);
  return static_cast<int>(cudaGetLastError());
}
