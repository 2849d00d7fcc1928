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
// links (decode: table loads -> state update -> ballot -> stream load;
// encode: table loads -> division -> state update), so the streams in flight
// and one link's latency set the rate, not bytes or arithmetic.  A raw blob
// is one stream: its decode or encode is a single chain of ceil(length/n)
// links whatever the card, which is the format's nature.
//
// Design (simple first): decode runs one warp per stream, kScanWarps streams
// a CTA; at n = 64 thread t holds lanes t and t + 32, at n = 16 threads 16..31
// hold no lane.  The consumed words' offsets come from one ballot per half
// and a popcount under the lane mask, the upper half offset by the lower
// half's count, so no shared memory or barrier is needed.  Tables and the
// stream are read through L1 (__ldg); a later PR can stage per-stream tables
// in shared memory.  Encode lanes never talk to each other, so encode runs
// one thread per (stream, lane), adjacent threads on adjacent lanes; it
// divides in plain u32 (mt_encode.cu's magic table is a later lever).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kScanWarps = 4;        // streams (one warp each) per decode CTA
constexpr int kEncodeThreads = 128;  // threads per encode CTA
constexpr unsigned kFullMask = 0xFFFFFFFFu;
constexpr uint32_t kConsumePoint = 1u << 15;  // DECODE_CONSUME_POINT_16

// idx2idx(n)[j] (hsrans_tpu_torch/rans.py): within each 32-lane chunk, lanes
// 8a + 4b + c code byte 16b + 4a + c; n = 16 is one 16-lane chunk, lanes
// 8b + 4a + c coding byte 8a + 4b + c
__device__ __forceinline__ int idx2idx(int n, int j) {
  if (n == 16) return ((j >> 2) & 1) * 8 + ((j >> 3) & 1) * 4 + (j & 3);
  return (j & 32) + ((j >> 2) & 1) * 16 + ((j >> 3) & 3) * 4 + (j & 3);
}

// one u16 of the stream at a signed index, as XLA's fill-mode gather reads it
__device__ __forceinline__ uint32_t stream_word(const uint16_t* __restrict__ s, long long w, int32_t idx) {
  long long i = idx;
  if (i < 0) i += w;
  return (i >= 0 && i < w) ? static_cast<uint32_t>(__ldg(s + i)) : 0xFFFFu;
}

__global__ void __launch_bounds__(kScanWarps * 32)
    scan_decode_kernel(const uint32_t* __restrict__ states, const uint16_t* __restrict__ stream,
                       long long stream_stride, long long w, const int32_t* __restrict__ read_pos,
                       const uint8_t* __restrict__ tab_sym, const uint16_t* __restrict__ tab_freq,
                       const uint16_t* __restrict__ tab_cumul, long long tab_stride, long long tab_len,
                       const int32_t* __restrict__ valid_counts, uint8_t* __restrict__ syms,
                       uint32_t* __restrict__ fin, int32_t* __restrict__ pos_out, int nb, int n, int bits,
                       long long num_steps, int tail) {
  const int lane = threadIdx.x & 31;
  const long long b = static_cast<long long>(blockIdx.x) * kScanWarps + (threadIdx.x >> 5);
  if (b >= nb) return;  // the whole warp leaves together
  const int halves = n > 32 ? 2 : 1;
  const uint16_t* s = stream + b * stream_stride;
  const uint8_t* tsym = tab_sym + b * tab_stride;
  const uint16_t* tfreq = tab_freq + b * tab_stride;
  const uint16_t* tcum = tab_cumul + b * tab_stride;
  const uint32_t mask = bits >= 32 ? 0xFFFFFFFFu : (1u << bits) - 1u;
  const int32_t vc = valid_counts[b];
  uint8_t* out = syms + b * num_steps * n;

  bool has[2];
  int perm[2];
  uint32_t st[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int j = lane + 32 * k;
    has[k] = k < halves && j < n;
    perm[k] = has[k] ? idx2idx(n, j) : 0;
    st[k] = has[k] ? states[b * n + j] : 0u;
  }
  int32_t r = read_pos[b];
  const unsigned below = (1u << lane) - 1u;

  for (long long g = 0; g < num_steps; ++g) {
    bool consume[2];
    uint32_t next[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const uint32_t slot = st[k] & mask;
      const bool inside = slot < tab_len;
      const uint8_t sym = inside ? __ldg(tsym + slot) : 0xFF;
      const uint32_t freq = inside ? __ldg(tfreq + slot) : 0xFFFFu;
      const uint32_t cumul = inside ? __ldg(tcum + slot) : 0xFFFFu;
      uint32_t ns = (st[k] >> bits) * freq + slot - cumul;
      // int32 byte index of the lane, as XLA computes step * n + perm
      const bool valid = !tail || static_cast<int32_t>(static_cast<uint32_t>(g) * n + perm[k]) < vc;
      ns = valid ? ns : st[k];
      consume[k] = has[k] && valid && ns < kConsumePoint;
      next[k] = ns;
      if (has[k]) out[g * n + lane + 32 * k] = sym;
    }
    const unsigned lo = __ballot_sync(kFullMask, consume[0]);
    const unsigned hi = __ballot_sync(kFullMask, consume[1]);
    const int offs[2] = {__popc(lo & below), __popc(lo) + __popc(hi & below)};
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int32_t at = static_cast<int32_t>(static_cast<uint32_t>(r) + offs[k]);
      st[k] = consume[k] ? (next[k] << 16) | stream_word(s, w, at) : next[k];
    }
    r = static_cast<int32_t>(static_cast<uint32_t>(r) + __popc(lo) + __popc(hi));
  }
#pragma unroll
  for (int k = 0; k < 2; ++k)
    if (has[k]) fin[b * n + lane + 32 * k] = st[k];
  if (lane == 0) pos_out[b] = r;
}

__global__ void __launch_bounds__(kEncodeThreads)
    scan_encode_kernel(const uint32_t* __restrict__ states, const uint8_t* __restrict__ group_bytes,
                       const uint8_t* __restrict__ valid, const uint16_t* __restrict__ freq_tab,
                       const uint16_t* __restrict__ cumul_tab, long long tab_stride, uint16_t* __restrict__ words,
                       uint8_t* __restrict__ emits, uint32_t* __restrict__ fin, long long lanes, int n, int bits,
                       uint32_t emit_point, long long num_steps) {
  const long long t = static_cast<long long>(blockIdx.x) * kEncodeThreads + threadIdx.x;
  if (t >= lanes) return;
  const long long b = t / n;
  const int j = static_cast<int>(t - b * n);
  const uint16_t* f = freq_tab + b * tab_stride;
  const uint16_t* c = cumul_tab + b * tab_stride;
  uint32_t st = states[t];
  for (long long g = num_steps - 1; g >= 0; --g) {  // rANS is LIFO: the last group first
    const long long at = (b * num_steps + g) * n + j;
    const uint8_t sym = group_bytes[at];
    const bool v = valid[at] != 0;
    const uint32_t freq = max(static_cast<uint32_t>(__ldg(f + sym)), 1u);
    const uint32_t cumul = __ldg(c + sym);
    const bool emit = v && st >= emit_point * freq;
    words[at] = emit ? static_cast<uint16_t>(st) : 0;
    emits[at] = emit;
    const uint32_t x = emit ? st >> 16 : st;
    const uint32_t q = x / freq;
    const uint32_t ns = (q << bits) + cumul + (x - q * freq);
    st = v ? ns : st;
  }
  fin[t] = st;
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
  const int ctas = (nb + kScanWarps - 1) / kScanWarps;
  scan_decode_kernel<<<ctas, kScanWarps * 32, 0, static_cast<cudaStream_t>(cuda_stream)>>>(
      static_cast<const uint32_t*>(states), static_cast<const uint16_t*>(stream), stream_stride, w,
      static_cast<const int32_t*>(read_pos), static_cast<const uint8_t*>(tab_sym),
      static_cast<const uint16_t*>(tab_freq), static_cast<const uint16_t*>(tab_cumul), tab_stride, tab_len,
      static_cast<const int32_t*>(valid_counts), static_cast<uint8_t*>(syms), static_cast<uint32_t*>(fin),
      static_cast<int32_t*>(pos_out), nb, n, bits, num_steps, tail);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hsr_scan_encode(const void* states, const void* group_bytes, const void* valid, const void* freq_tab,
                               const void* cumul_tab, long long tab_stride, void* words, void* emits, void* fin,
                               int nb, int n, int bits, long long emit_point, long long num_steps,
                               void* cuda_stream) {
  if (nb <= 0) return 0;
  if ((n != 16 && n != 32 && n != 64) || bits < 0 || bits > 31 || num_steps < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long lanes = static_cast<long long>(nb) * n;
  const long long ctas = (lanes + kEncodeThreads - 1) / kEncodeThreads;
  scan_encode_kernel<<<static_cast<unsigned>(ctas), kEncodeThreads, 0, static_cast<cudaStream_t>(cuda_stream)>>>(
      static_cast<const uint32_t*>(states), static_cast<const uint8_t*>(group_bytes),
      static_cast<const uint8_t*>(valid), static_cast<const uint16_t*>(freq_tab),
      static_cast<const uint16_t*>(cumul_tab), tab_stride, static_cast<uint16_t*>(words),
      static_cast<uint8_t*>(emits), static_cast<uint32_t*>(fin), lanes, n, bits,
      static_cast<uint32_t>(emit_point), num_steps);
  return static_cast<int>(cudaGetLastError());
}
