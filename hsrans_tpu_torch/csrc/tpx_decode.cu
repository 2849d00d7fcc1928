// tpx decode on Hopper: every megablock of a tpx blob (v1, v2 or v3 wire, with
// v3's per-mega geometry) in one launch, each row's slots read from the
// wire's own ragged layout.
//
// Replaces: hsrans_tpu/kernels/tpx_decode.py::_tile_kernel (launched once a
// mega by _decode_mega), the Pallas TPU kernel.
//
// What bounds it: each of a row's 128 rANS states is a serial dependent chain
// (table lookups -> state update -> ballot -> renorm read) of n_tiles * steps
// links.  The bytes (each row's words read once, the output written once)
// take ~0.01 ms at 64 MiB, so the chains in flight and one link's latency set
// the rate: the warp's own instructions, issued in order, with two dependent
// shared table loads and a shared word load on each link.
//
// Design: one warp per tpx row, walking the mega's tiles with its four
// states per thread in registers (the TPU kernel's VMEM scratch carried
// across grid steps); the four states of a thread are independent, so each
// step issues four chains' lookups before the first result is needed.  One
// launch covers every mega: each mega's small descriptor (DecodeMega) names
// its geometry, its first CTA, where its slots, row starts, tables and states
// are and where its bytes go, and a CTA finds its mega by a binary search
// over the CTAs' prefix (tpx_common.cuh::find_mega).  The megas' chains are
// independent, so the card holds all of them at once instead of one mega's
// ~8 warps an SM.
//
// A row (t, r) owns sc = row_start[i + 1] - row_start[i] u32 slots at byte
// slot_off + 4 * row_start[i] of the blob (i = t * rows + r), back to back
// with its neighbours on a v2/v3 wire (a v1 row's start is i * w_slots).  Its
// u16 word widx reads as slot min(widx >> 1, w_slots - 1), half widx & 1,
// when that slot is below sc, and as 0 otherwise: the numpy authority's clamp
// (hsrans_tpu/ops/tpx.py::tpx_decode) on the rectangular array the parser
// used to rebuild, so a corrupt blob cannot read out of bounds and decodes
// to the authority's bytes.  The warp reads its row's words from a window in
// shared memory (window.cuh: two halves of kWindowHalf bytes, 4 KiB a warp)
// filled by cp.async and zero-filled past the row's slots (and past the
// blob), refilled when the cursor leaves a half and waited for only when the
// next step group could reach the half in flight.  A row's streams for tiles
// t and t + 1 are not adjacent on the wire, so the window restarts at each
// tile: its first two halves and the tile's tables are copied by cp.async
// together, all in flight at once, with one wait between the CTA's barriers
// (loaded through registers, one 16-byte chunk after another, the 33 KiB of
// B=15 tables cost a sixth of the kernel).  The cursor and the window's
// bounds are 32-bit.  A
// group whose positions all lie below vlen and whose reads all lie below
// 2 * w_slots words takes the plain path; only a row's partial last group
// and a read that may pass w_slots (a corrupt blob, or the last groups of the
// mega's longest rows) take the checked one.  Per tile the slot -> symbol
// table (2^B bytes) and freq | cumul << 16 (256 u32) sit in shared memory.
// Output: one u32 per (tile, row, step group, lane) holding the group's four
// symbols, at out_base / 4 + ((t * rows + r) * steps / 4 + group) * 128 +
// lane, which is the wire byte order; a group that holds no data is not
// written, and a partial group's bytes past vlen are 0.

#include "tpx_common.cuh"
#include "window.cuh"

namespace {

using tpx::kGroupPositions;
using tpx::kLanes;
using tpx::kWarps;

// bytes in each half of a warp's window: a step group reads at most 4 steps
// x 128 words = 1 KiB, and a half holds a group's reads twice over
constexpr int kGroupBytes = 4 * kLanes * 2;
constexpr int kWindowHalf = 2048;
constexpr int kRing = 2 * kWindowHalf;  // bytes of a warp's window
static_assert(kWindowHalf >= 2 * kGroupBytes && (kWindowHalf & (kWindowHalf - 1)) == 0,
              "window half: a power of two that holds a group's reads twice over");

// one megablock of the launch: the layout of kernels/tpx_decode.py::DECODE_FIELDS
struct DecodeMega {
  long long cta0, rows, steps, n_tiles, w_slots, slot_off, row0, tab0, state0, out_base, vlen;
};

// One step group (4 steps of the warp's 128 lanes): each lane's four symbols
// into packed[k], renormalising from the window.  `at` is the window position
// (bytes) of the row's next word, ph that of its first.  kCheck: only the
// first rem positions of the group hold data (the rest keep their state and
// decode to 0), and a read at word widx >= w_words = 2 * w_slots is clamped
// to the last slot's half widx & 1.  Without it every position holds data and
// every read lies below w_words.
template <bool kCheck>
__device__ __forceinline__ void decode_group(uint32_t (&st)[4], uint32_t (&packed)[4], uint32_t& at,
                                             const uint8_t* ring, const uint8_t* sym_s, const uint32_t* fc_s,
                                             int bits, uint32_t lt, int j, int rem, uint32_t ph, uint32_t w_words) {
  const uint32_t slot_mask = (1u << bits) - 1u;
#pragma unroll
  for (int k = 0; k < 4; ++k) packed[k] = 0u;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    bool consume[4];
    unsigned ballot[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t slot = st[k] & slot_mask;
      const uint32_t sym = sym_s[slot];
      const uint32_t fc = fc_s[sym];
      const uint32_t next = (st[k] >> bits) * (fc & 0xFFFFu) + slot - (fc >> 16);
      const bool valid = !kCheck || (j + 32 * k) * 4 + i < rem;
      st[k] = valid ? next : st[k];
      packed[k] |= (valid ? sym : 0u) << (8 * i);
      consume[k] = valid && st[k] < tpx::kConsumePoint;
      ballot[k] = __ballot_sync(tpx::kFullMask, consume[k]);
    }
    // every lane reads (no branch to reconverge); a lane that consumes keeps
    // the word.  Window positions wrap in the ring, so 32 bits do.
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      uint32_t p = at + 2 * __popc(ballot[k] & lt);
      if (kCheck) {
        const uint32_t widx = (p - ph) >> 1;
        p = widx < w_words ? p : ph + 2 * ((w_words - 2) | (widx & 1));
      }
      const uint32_t word = *reinterpret_cast<const uint16_t*>(ring + (p & (kRing - 1)));
      st[k] = consume[k] ? __byte_perm(word, st[k], 0x5410) : st[k];  // (st << 16) | word
      at += 2 * __popc(ballot[k]);
    }
  }
}

__global__ void __launch_bounds__(kWarps * 32)
tpx_decode_kernel(const uint8_t* __restrict__ blob,        // [nbytes] the whole blob
                  long long nbytes,
                  const DecodeMega* __restrict__ desc,     // [n_megas]
                  int n_megas,
                  const long long* __restrict__ row_start, // each mega's [n_tiles * rows + 1] slot starts
                  const uint32_t* __restrict__ init,       // [sum rows, 128] decode-start states
                  const uint8_t* __restrict__ symtab,      // [sum tiles, 2^B] slot -> symbol
                  const uint32_t* __restrict__ fctab,      // [sum tiles, 256] freq | cumul << 16
                  uint32_t* __restrict__ out,              // the decoded bytes, 4 a u32
                  int bits) {
  extern __shared__ __align__(16) uint8_t dsmem[];
  const int w = threadIdx.x >> 5;
  const int j = threadIdx.x & 31;
  const DecodeMega md = desc[tpx::find_mega(desc, n_megas, blockIdx.x)];
  const long long r0 = (blockIdx.x - md.cta0) * kWarps;
  if (r0 >= md.rows) return;  // past the last mega's rows: the whole CTA
  const int rows = static_cast<int>(md.rows);
  const int r = static_cast<int>(r0) + w;
  const bool active = r < rows;
  uint8_t* ring = dsmem + w * kRing;
  uint32_t* fc_s = reinterpret_cast<uint32_t*>(dsmem + kWarps * kRing);
  uint8_t* sym_s = dsmem + kWarps * kRing + 256 * sizeof(uint32_t);
  const int n_slots = 1 << bits;
  const int s4c = static_cast<int>(md.steps >> 2);
  const uint32_t w_words = 2 * static_cast<uint32_t>(md.w_slots);
  const uint32_t lt = tpx::lanemask_lt();

  uint32_t st[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) st[k] = active ? init[(md.state0 + r) * kLanes + j + 32 * k] : 0u;

  for (int t = 0; t < md.n_tiles; ++t) {
    // ---- the row's slots of tile t are the blob's bytes [begin, hi); the
    //      window's first two halves are on their way while the CTA loads
    //      the tile's tables.  Window position p is blob byte wbase + p.
    const long long row_id = static_cast<long long>(t) * rows + r;
    long long wbase = 0, hi = 0;
    uint32_t ph = 0;
    int next_half = 0;  // the next half to copy, into ring slot next_half % 2
    auto fill_next = [&]() {
      window::fill<kWindowHalf>(ring + (next_half & 1) * kWindowHalf, blob,
                                wbase + static_cast<long long>(next_half) * kWindowHalf, hi, j);
      ++next_half;
    };
    if (active) {
      const long long begin = md.slot_off + 4 * row_start[md.row0 + row_id];
      hi = min(md.slot_off + 4 * row_start[md.row0 + row_id + 1], nbytes);  // bytes past the blob read as 0
      ph = static_cast<uint32_t>(window::phase(blob, begin));
      wbase = begin - ph;
      __syncwarp();  // every lane's reads of the previous tile's window are done
      fill_next();
      fill_next();
    }
    __syncthreads();  // every warp is done with the previous tile's tables
    // the tile's tables by cp.async too: every copy in flight at once (33 KiB
    // at B=15), one wait for them and the window's first halves
    const long long tab = md.tab0 + t;
    for (int i = threadIdx.x; i < n_slots / 16; i += blockDim.x)
      window::copy16(sym_s + 16 * i, symtab + tab * n_slots + 16 * i, 16);
    for (int i = threadIdx.x; i < 256 / 4; i += blockDim.x) window::copy16(fc_s + 4 * i, fctab + tab * 256 + 4 * i, 16);
    window::commit();
    window::wait_all();
    __syncthreads();
    if (!active) continue;

    // ---- the row's groups: wire position row_pos + 512 * group + 4 * lane + step
    const tpx::GroupSpan span = tpx::group_span(md.vlen - row_id * s4c * kGroupPositions, s4c);
    const int s4_end = span.full + (span.rem > 0);
    uint32_t* orow = out + md.out_base / 4 + row_id * s4c * kLanes;
    uint32_t at = ph;                  // window position of the row's next word
    uint32_t refill_at = kWindowHalf;  // once the cursor reaches it, the half below it is free
    uint32_t ready_end = kRing;        // the window holds positions below it
    for (int s4 = 0; s4 < s4_end; ++s4) {
      uint32_t packed[4];
      const bool whole = s4 < span.full;
      const int rem = whole ? kGroupPositions : span.rem;
      if (whole && ((at - ph) >> 1) + 4 * kLanes <= w_words) {
        decode_group<false>(st, packed, at, ring, sym_s, fc_s, bits, lt, j, rem, ph, w_words);
      } else {
        decode_group<true>(st, packed, at, ring, sym_s, fc_s, bits, lt, j, rem, ph, w_words);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if ((j + 32 * k) * 4 < rem) orow[s4 * kLanes + j + 32 * k] = packed[k];
      }
      // every later read lies at or past the (clamped) cursor: once it leaves
      // a half, that half's slot takes the half after the next, which has
      // ~kWindowHalf - kGroupBytes bytes of reading to land before a group
      // can reach it
      const uint32_t cur = ph + 2 * min((at - ph) >> 1, w_words - 2);
      if (cur >= refill_at) {
        __syncwarp();  // every lane's reads of the slot are done
        fill_next();
        refill_at += kWindowHalf;
      }
      if (cur + kGroupBytes > ready_end) {  // the next group may read into the half last copied
        window::wait_all();
        __syncwarp();
        ready_end += kWindowHalf;
      }
    }
    window::wait_all();  // no copy may land in the window after the row's tile
  }
}

}  // namespace

extern "C" int hsr_tpx_decode(const void* blob, long long nbytes, const void* desc, int n_megas, int ctas,
                              const void* row_start, const void* init, const void* symtab, const void* fctab,
                              void* out, int bits, void* cuda_stream) {
  if (n_megas <= 0 || ctas <= 0) return 0;
  if (bits < 10 || bits > 15) return static_cast<int>(cudaErrorInvalidValue);
  // the windows, then freq | cumul << 16 and the slot -> symbol table: 21 KiB
  // a CTA at B=12, 49 KiB at B=15 (above 48 KiB only when opted in)
  const size_t smem = kWarps * kRing + 256 * sizeof(uint32_t) + (size_t(1) << bits);
  if (smem > 48 * 1024) {
    const cudaError_t set =
        cudaFuncSetAttribute(tpx_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (set != cudaSuccess) return static_cast<int>(set);
  }
  tpx_decode_kernel<<<ctas, kWarps * 32, smem, static_cast<cudaStream_t>(cuda_stream)>>>(
      static_cast<const uint8_t*>(blob), nbytes, static_cast<const DecodeMega*>(desc), n_megas,
      static_cast<const long long*>(row_start), static_cast<const uint32_t*>(init),
      static_cast<const uint8_t*>(symtab), static_cast<const uint32_t*>(fctab), static_cast<uint32_t*>(out), bits);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* hsr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
