// tpx encode on Hopper: the rANS state machine over every megablock of the
// input in one launch, then one launch that writes every megablock's wire
// section.
//
// tpx_encode_kernel replaces hsrans_tpu/kernels/tpx_encode.py::_encode_kernel
// (launched once a mega by _encode_mega); tpx_wire_kernel replaces
// ::_concat_kernel (launched by _concat_mega, which lays each row's words out
// as a rectangular [T, R, Wcap] slot array) together with the host's
// hsrans_tpu/ops/tpx.py::_write_mega, which gathers the ragged wire from it.
//
// What bounds them: the encode is a serial dependent chain per rANS state
// (emit test -> shift -> divide by freq -> state update) over every step of
// every tile, run in reverse, and it writes each step's 128-word window whole
// (the Pallas kernel's contract: the emitted words compacted, 0 past the
// count): 4 bytes a coded byte, 256 MiB at 64 MiB of input, 0.080 ms at
// 3.35 TB/s.  That write is its floor; the chains in flight and one link's
// latency set the rest.  The wire writer is a copy: 4 bytes read (the window
// u32) and 2 written per word kept, plus the counts, states and freqs, about
// 128 MB at 64 MiB of input, 0.038 ms; bound by memory traffic.
//
// Design (encode): one warp per tpx row, the same lane mapping as the decode
// (thread j owns lanes j+32k), walking tiles, step groups and steps backward
// with the four states per thread in registers, starting from
// DECODE_CONSUME_POINT_16.  One launch covers every mega: each mega's
// descriptor (EncodeMega) names its geometry, its first CTA, where its input,
// tables, windows, counts and states are, and a CTA finds its mega by a
// binary search over the CTAs' prefix (tpx_common.cuh::find_mega).  The input
// is the whole data as it is: a group's four steps of a lane are one aligned
// u32 of it, loaded a group ahead of its use (a register double buffer); the
// row's partial last group reads its bytes one by one, and a group past the
// data reads nothing and writes zero windows and counts.  Whole groups take
// the plain path; only the partial group checks positions.  The per-tile
// encode tables of make_enc_tables_batch (fc, division magic m, shift l) sit
// in shared memory; q = state / freq is the Granlund-Montgomery magic multiply
// (m * x) >> (31 + l), exact for every state < 2^31, by one wide multiply and
// a funnel shift.  The B <= 12 packed fc layout and the B >= 13 one are two
// instances of the kernel.  Each step's emitted words are compacted in lane
// order with the ballot + popc prefix (tpx_common.cuh) into the step's window,
// and its slots past the count are written 0, as the TPU kernel leaves them.
// The windows are built in shared memory and a group's four go out as whole
// 512-byte rows, 16 bytes a lane: stored straight from the lanes, a step's
// window took eight partial, predicated stores.
//
// Design (wire): the kernel writes the blob's sections in place, every byte
// of them once, at the u16 offsets the host lays out from the rows' word
// totals (kernels/tpx_encode.py::wire_layout): each mega's [rows | steps |]
// n_tiles | w_slots, its states [R, 128], each tile's freqs and counts, then
// each (tile, row)'s ceil(words / 2) u32 slots, rows back to back.  Sections
// start at any even byte offset (a 13-row mega's ends at 2 mod 4), so the
// blob is written as one u16 array.  One warp per (tile, row), all megas in
// one launch (find_mega as above).  Lane s loads step s's count, a warp scan
// gives each step's offset in the row, and the windows are read 8 steps at a
// time, 16 bytes a lane and only where the lane's four words hold one the
// step emitted (the padded windows hold about three times the words kept).
// The low halves go into the warp's stage in shared memory at the row's
// 16-byte phase, so the row leaves as aligned 16-byte stores with its two
// partial end chunks written u16 by u16 (store_run); each word stored
// straight from its lane as one u16 took 1.27x as long (PERF.md).  The row's
// count, its tile's freqs (row 0's warp), its states (tile 0's warps,
// through the same stage) and the section's head (the mega's first warp)
// are written beside it.  The 16-step segmentation and chunk passes of the
// TPU kernel were Mosaic workarounds and have no counterpart here.

#include "tpx_common.cuh"

namespace {

using tpx::kGroupPositions;
using tpx::kLanes;
using tpx::kWarps;

// one megablock of the launch: the layout of kernels/tpx_encode.py::ENCODE_FIELDS
struct EncodeMega {
  long long cta0, rows, steps, n_tiles, in_off, tab0, vlen, cnt_off, state0;
};

// One step group of a row, its steps backward: lane j + 32k's four input
// bytes are pk[k] (step i in byte i).  Each step's window is built in the
// warp's `stage` (shared, 4 x 128 words), then the group's four windows go
// to wg + i * stride (i = 0..3) as whole 512-byte rows, 16 bytes a lane, and
// its four counts to cg[0..3] in one 16-byte store.  kCheck: only the
// group's first rem positions hold data (the rest emit nothing and keep
// their state).
template <bool kPacked, bool kCheck>
__device__ __forceinline__ void encode_group(uint32_t (&st)[4], const uint32_t (&pk)[4], uint32_t* stage, uint32_t* wg,
                                             size_t stride, uint32_t* cg, const uint32_t* fc_s, const uint32_t* m_s,
                                             const uint32_t* l_s, int bits, uint32_t lt, int j, int rem) {
  const uint32_t emit_point = 1u << (31 - bits);  // state >= emit_point * freq fits u32 even at freq = 2^B
  const uint32_t total = 1u << bits;
  uint32_t counts[4];
#pragma unroll
  for (int i = 3; i >= 0; --i) {
    bool emit[4];
    uint32_t word[4];
    unsigned ballot[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t byte = (pk[k] >> (8 * i)) & 0xFFu;
      const uint32_t fc = fc_s[byte];
      uint32_t freq, cum, shift;
      if (kPacked) {
        freq = fc & 0x1FFFu;
        cum = (fc >> 13) & 0xFFFu;
        shift = fc >> 25;
      } else {
        freq = fc & 0xFFFFu;
        cum = fc >> 16;
        shift = l_s[byte];
      }
      const bool valid = !kCheck || (j + 32 * k) * 4 + i < rem;  // past the data: nothing emitted, state kept
      emit[k] = valid && st[k] >= emit_point * freq;
      word[k] = st[k] & 0xFFFFu;
      const uint32_t x = emit[k] ? st[k] >> 16 : st[k];
      // (m * x) >> (31 + shift): m < 2^32 and x < 2^31, so m * x >> 31 fits 32 bits
      const uint64_t mx = static_cast<uint64_t>(m_s[byte]) * x;
      const uint32_t q = __funnelshift_l(static_cast<uint32_t>(mx), static_cast<uint32_t>(mx >> 32), 1) >> shift;
      const uint32_t next = q * (total - freq) + cum + x;  // == (q << B) + cum + x % freq
      st[k] = valid ? next : st[k];
      ballot[k] = __ballot_sync(tpx::kFullMask, emit[k]);
    }
    uint32_t* row = stage + i * kLanes;
    int n = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (emit[k]) row[n + __popc(ballot[k] & lt)] = word[k];
      n += __popc(ballot[k]);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (j + 32 * k >= n) row[j + 32 * k] = 0u;
    }
    counts[i] = n;
  }
  __syncwarp();  // the four windows are in the stage
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    reinterpret_cast<uint4*>(wg + i * stride)[j] = reinterpret_cast<const uint4*>(stage + i * kLanes)[j];
  }
  if (j == 0) *reinterpret_cast<uint4*>(cg) = make_uint4(counts[0], counts[1], counts[2], counts[3]);
  __syncwarp();  // every lane has read the stage before the next group writes it
}

template <bool kPacked>
__global__ void __launch_bounds__(kWarps * 32)
tpx_encode_kernel(const uint8_t* __restrict__ data,       // the whole input (4-byte aligned)
                  const EncodeMega* __restrict__ desc,    // [n_megas]
                  int n_megas,
                  const uint32_t* __restrict__ fctab,     // [sum tiles, 256] B<=12: freq | cumul<<13 | l<<25; else freq | cumul<<16
                  const uint32_t* __restrict__ mtab,      // [sum tiles, 256] division magic
                  const uint32_t* __restrict__ ltab,      // [sum tiles, 256] division shift (read for B>=13)
                  uint32_t* __restrict__ win,             // per mega [T, S, R, 128] per-step compacted words
                  uint32_t* __restrict__ cnt,             // per mega [T, R, S] per-step word counts
                  uint32_t* __restrict__ states_out,      // per mega [R, 128] final (decode-start) states
                  int bits) {
  __shared__ uint32_t fc_s[256];
  __shared__ uint32_t m_s[256];
  __shared__ uint32_t l_s[256];
  __shared__ __align__(16) uint32_t stages[kWarps][4 * kLanes];  // each warp's windows of one step group
  const int w = threadIdx.x >> 5;
  const int j = threadIdx.x & 31;
  const EncodeMega md = desc[tpx::find_mega(desc, n_megas, blockIdx.x)];
  const long long r0 = (blockIdx.x - md.cta0) * kWarps;
  if (r0 >= md.rows) return;  // past the last mega's rows: the whole CTA
  const int rows = static_cast<int>(md.rows);
  const int steps = static_cast<int>(md.steps);
  const int r = static_cast<int>(r0) + w;
  const bool active = r < rows;
  const uint32_t lt = tpx::lanemask_lt();
  const int s4c = steps >> 2;
  const size_t stride = static_cast<size_t>(rows) * kLanes;  // from one step's windows to the next's
  uint32_t* stage = stages[w];

  uint32_t st[4] = {tpx::kConsumePoint, tpx::kConsumePoint, tpx::kConsumePoint, tpx::kConsumePoint};
  for (int t = static_cast<int>(md.n_tiles) - 1; t >= 0; --t) {
    __syncthreads();  // every warp is done with the previous tile's tables
    const long long tab = (md.tab0 + t) * 256;
    for (int i = threadIdx.x; i < 256; i += blockDim.x) {
      fc_s[i] = fctab[tab + i];
      m_s[i] = mtab[tab + i];
      if (!kPacked) l_s[i] = ltab[tab + i];
    }
    __syncthreads();
    if (!active) continue;

    const long long row_id = static_cast<long long>(t) * rows + r;
    const long long row_pos = row_id * s4c * kGroupPositions;  // wire position of the row's first byte
    const tpx::GroupSpan span = tpx::group_span(md.vlen - row_pos, s4c);
    const uint8_t* in_row = data + md.in_off + row_pos;
    uint32_t* wt = win + md.cnt_off * kLanes + (static_cast<long long>(t) * steps * rows + r) * kLanes;
    uint32_t* ct = cnt + md.cnt_off + row_id * steps;
    // groups past the data: no word emitted, no state changed
    for (int s4 = s4c - 1; s4 >= span.full + (span.rem > 0); --s4) {
#pragma unroll
      for (int i = 0; i < 4; ++i) reinterpret_cast<uint4*>(wt + (4 * s4 + i) * stride)[j] = make_uint4(0u, 0u, 0u, 0u);
      if (j == 0) *reinterpret_cast<uint4*>(ct + 4 * s4) = make_uint4(0u, 0u, 0u, 0u);
    }
    if (span.rem > 0) {  // the partial group: its bytes one by one, those past the data as 0
      const int s4 = span.full;
      uint32_t pk[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        pk[k] = 0u;
        for (int i = 0; i < 4; ++i) {
          const int at = (j + 32 * k) * 4 + i;
          if (at < span.rem) pk[k] |= static_cast<uint32_t>(in_row[s4 * kGroupPositions + at]) << (8 * i);
        }
      }
      encode_group<kPacked, true>(st, pk, stage, wt + 4 * s4 * stride, stride, ct + 4 * s4, fc_s, m_s, l_s, bits, lt,
                                  j, span.rem);
    }
    // the whole groups, each one's input loaded while the group after it (the
    // one before in the walk) runs
    const uint32_t* in_words = reinterpret_cast<const uint32_t*>(in_row);
    uint32_t ahead[4];
    if (span.full > 0) {
#pragma unroll
      for (int k = 0; k < 4; ++k) ahead[k] = in_words[(span.full - 1) * kLanes + j + 32 * k];
    }
    for (int s4 = span.full - 1; s4 >= 0; --s4) {
      uint32_t pk[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) pk[k] = ahead[k];
      if (s4 > 0) {
#pragma unroll
        for (int k = 0; k < 4; ++k) ahead[k] = in_words[(s4 - 1) * kLanes + j + 32 * k];
      }
      encode_group<kPacked, false>(st, pk, stage, wt + 4 * s4 * stride, stride, ct + 4 * s4, fc_s, m_s, l_s, bits, lt,
                                   j, kGroupPositions);
    }
  }
  if (active) {
#pragma unroll
    for (int k = 0; k < 4; ++k) states_out[(md.state0 + r) * kLanes + j + 32 * k] = st[k];
  }
}

// one megablock of the wire writer's launch: kernels/tpx_encode.py::WIRE_FIELDS
struct WireMega {
  long long cta0, rows, steps, n_tiles, cnt_off, state0, tab0, row0, sec_off, w_slots;
};

// a warp stages a row's words kPieceSteps steps at a time: at most 128 words
// a step, the pad of an odd row and the run's 16-byte phase
constexpr int kPieceSteps = 32;
constexpr int kStageU16 = kPieceSteps * kLanes + 16;

// out[at, at + len) = stage[ph, ph + len), ph = at % 8: the run's whole
// 16-byte chunks one store each, the chunks at its two ends one u16 at a time
// (their other u16s are a neighbour's); u16s at or past out_len are dropped
__device__ __forceinline__ void store_run(uint16_t* __restrict__ out, long long at, const uint16_t* stage, int len,
                                          long long out_len, int j) {
  const int ph = static_cast<int>(at & 7);
  uint16_t* base = out + (at - ph);  // 16-byte aligned: out is
  const int end = ph + static_cast<int>(min(static_cast<long long>(len), out_len - at));
  for (int c = j; c < (end + 7) >> 3; c += 32) {
    const int lo = c << 3;
    if (lo >= ph && lo + 8 <= end) {
      reinterpret_cast<uint4*>(base)[c] = reinterpret_cast<const uint4*>(stage)[c];
    } else {
      for (int i = max(lo, ph); i < min(lo + 8, end); ++i) base[i] = stage[i];
    }
  }
}

__global__ void __launch_bounds__(kWarps * 32)
tpx_wire_kernel(const uint32_t* __restrict__ win,      // per mega [T, S, R, 128] per-step compacted words
                const uint32_t* __restrict__ cnt,      // per mega [T, R, S] per-step word counts
                const uint32_t* __restrict__ states,   // per mega [R, 128] final states
                const uint16_t* __restrict__ freqs,    // [sum tiles, 256] the wire freqs
                const WireMega* __restrict__ desc,     // [n_megas]
                int n_megas,
                const long long* __restrict__ row_at,  // [sum T * R] u16 offset in out of each row's first slot
                uint16_t* __restrict__ out,            // [out_len] the blob as u16, 16-byte aligned
                long long out_len, int v3) {
  __shared__ __align__(16) uint16_t stages[kWarps][kStageU16];
  const int w = threadIdx.x >> 5;
  const int j = threadIdx.x & 31;
  const WireMega md = desc[tpx::find_mega(desc, n_megas, blockIdx.x)];
  const long long g = (blockIdx.x - md.cta0) * kWarps + w;  // = t * rows + r
  if (g >= md.n_tiles * md.rows) return;  // warp-uniform; the kernel syncs only within a warp
  const int rows = static_cast<int>(md.rows);
  const int steps = static_cast<int>(md.steps);
  const int t = static_cast<int>(g / rows);
  const int r = static_cast<int>(g % rows);
  uint16_t* stage = stages[w];
  const int head = v3 ? 8 : 4;  // u16s before the states: [rows, steps,] n_tiles, w_slots, each a u32
  const long long states_at = md.sec_off + head;
  // tile t's 256 freqs, then its R counts
  const long long tile_at = states_at + 2LL * kLanes * rows + static_cast<long long>(t) * (256 + rows);

  // the section's head (warp 0), the tile's freqs (the warps of row 0) and
  // the row's states (those of tile 0)
  if (g == 0 && j < head) {
    const int f = (v3 ? 0 : 2) + (j >> 1);
    const long long v = f == 0 ? md.rows : f == 1 ? md.steps : f == 2 ? md.n_tiles : md.w_slots;
    out[md.sec_off + j] = static_cast<uint16_t>(static_cast<unsigned long long>(v) >> (16 * (j & 1)));
  }
  if (r == 0) {
    for (int i = j; i < 256; i += 32) out[tile_at + i] = freqs[(md.tab0 + t) * 256 + i];
  }
  if (t == 0) {
    const long long at = states_at + 2LL * kLanes * r;
    const int ph = static_cast<int>(at & 7);
    const uint4 v = reinterpret_cast<const uint4*>(states + (md.state0 + r) * kLanes)[j];
    const uint32_t q[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      stage[ph + 8 * j + 2 * i] = static_cast<uint16_t>(q[i]);
      stage[ph + 8 * j + 2 * i + 1] = static_cast<uint16_t>(q[i] >> 16);
    }
    __syncwarp();
    store_run(out, at, stage, 2 * kLanes, out_len, j);
    __syncwarp();  // every lane has read the stage before the words take it
  }

  // the row's words, a piece of up to 32 steps at a time: lane s holds step
  // s's count, a warp scan gives each step's offset in the row, and the
  // piece's windows are read 8 steps at a time, 16 bytes a lane where the
  // lane's four words hold one the step emitted
  const uint32_t* c_row = cnt + md.cnt_off + g * steps;
  const uint32_t* w_tile = win + (md.cnt_off + static_cast<long long>(t) * steps * rows) * kLanes;
  const long long at0 = row_at[md.row0 + g];
  int done = 0;  // the row's words written so far
  for (int s0 = 0; s0 < steps; s0 += kPieceSteps) {
    const int ns = min(kPieceSteps, steps - s0);
    const int n = j < ns ? min(static_cast<int>(c_row[s0 + j]), kLanes) : 0;
    int incl = n;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(tpx::kFullMask, incl, d);
      if (j >= d) incl += v;
    }
    const int piece = __shfl_sync(tpx::kFullMask, incl, 31);
    const int excl = incl - n;
    const long long at = at0 + done;
    const int ph = static_cast<int>(at & 7);
    for (int s = 0; s < ns; s += 8) {
      uint4 v[8];
      int m[8], o[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        m[k] = __shfl_sync(tpx::kFullMask, n, s + k);  // 0 past the piece's steps
        o[k] = __shfl_sync(tpx::kFullMask, excl, s + k);
        const uint32_t* step = w_tile + (static_cast<long long>(s0 + s + k) * rows + r) * kLanes;
        v[k] = 4 * j < m[k] ? reinterpret_cast<const uint4*>(step)[j] : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const uint32_t q[4] = {v[k].x, v[k].y, v[k].z, v[k].w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int x = 4 * j + i;
          if (x < m[k]) stage[ph + o[k] + x] = static_cast<uint16_t>(q[i]);
        }
      }
    }
    done += piece;
    const int pad = s0 + kPieceSteps >= steps && (done & 1);  // an odd row's last slot: its high half 0
    if (pad && j == 0) stage[ph + piece] = 0;
    __syncwarp();
    store_run(out, at, stage, piece + pad, out_len, j);
    __syncwarp();  // every lane has read the stage before the next piece
  }
  if (j == 0) out[tile_at + 256 + r] = static_cast<uint16_t>(done);
}

}  // namespace

extern "C" int hsr_tpx_encode(const void* data, const void* desc, int n_megas, int ctas, const void* fctab,
                              const void* mtab, const void* ltab, void* win, void* cnt, void* states, int bits,
                              void* cuda_stream) {
  if (n_megas <= 0 || ctas <= 0) return 0;
  if (bits < 10 || bits > 15 || reinterpret_cast<uintptr_t>(data) % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = bits <= 12 ? tpx_encode_kernel<true> : tpx_encode_kernel<false>;
  kernel<<<ctas, kWarps * 32, 0, static_cast<cudaStream_t>(cuda_stream)>>>(
      static_cast<const uint8_t*>(data), static_cast<const EncodeMega*>(desc), n_megas,
      static_cast<const uint32_t*>(fctab), static_cast<const uint32_t*>(mtab), static_cast<const uint32_t*>(ltab),
      static_cast<uint32_t*>(win), static_cast<uint32_t*>(cnt), static_cast<uint32_t*>(states), bits);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hsr_tpx_wire(const void* win, const void* cnt, const void* states, const void* freqs, const void* desc,
                            int n_megas, int ctas, const void* row_at, void* out, long long out_len, int v3,
                            void* cuda_stream) {
  if (n_megas <= 0 || ctas <= 0) return 0;
  if (reinterpret_cast<uintptr_t>(out) % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  tpx_wire_kernel<<<ctas, kWarps * 32, 0, static_cast<cudaStream_t>(cuda_stream)>>>(
      static_cast<const uint32_t*>(win), static_cast<const uint32_t*>(cnt), static_cast<const uint32_t*>(states),
      static_cast<const uint16_t*>(freqs), static_cast<const WireMega*>(desc), n_megas,
      static_cast<const long long*>(row_at), static_cast<uint16_t*>(out), out_len, v3);
  return static_cast<int>(cudaGetLastError());
}
