// tpx megablock decode on Hopper.
//
// Replaces: hsrans_tpu/kernels/tpx_decode.py::_tile_kernel (launched by
// _decode_mega), the Pallas TPU kernel.
//
// What bounds it: each of the R*128 rANS states is a serial dependent chain
// (table lookups -> state update -> renorm read) of rows*tiles*steps links;
// arithmetic and bytes are small, so the number of chains in flight and the
// latency of one link set the rate.
//
// Design: one warp per tpx row, walking every tile of the mega with its four
// states per thread kept in registers (the TPU kernel's VMEM scratch carried
// across grid steps).  The four states of a thread are independent, so each
// step issues four chains' lookups before the first result is needed.  The
// lane-ascending renorm prefix is a ballot + popc (tpx_common.cuh), and each
// row reads its u32 slots at its own cursor from the row-major [T, R, W]
// stream, clamped to the row's [0, W) as the numpy authority clamps
// (ops/tpx.py::tpx_decode), so a corrupt blob cannot read out of bounds.
// Per tile, the slot->symbol table (2^B bytes) and freq|cumul<<16 (256 u32)
// sit in shared memory, reloaded by the block's warps between barriers.
// Output is written as one u32 per (tile, row, step group, lane) holding the
// group's four symbols — the wire byte order.

#include "tpx_common.cuh"

namespace {

using tpx::kLanes;
using tpx::kWarps;

__global__ void __launch_bounds__(kWarps * 32)
tpx_decode_kernel(const uint32_t* __restrict__ stream,  // [T, R, W] u32 slots (two u16 words each)
                  const uint32_t* __restrict__ init,    // [R, 128] decode-start states
                  const uint8_t* __restrict__ symtab,   // [T, 2^B] slot -> symbol
                  const uint32_t* __restrict__ fctab,   // [T, 256] freq | cumul << 16
                  uint32_t* __restrict__ out,           // [T, R, S/4, 128] packed symbols
                  int rows, int steps, int n_tiles, int w_slots, int bits, long long vlen) {
  extern __shared__ uint32_t smem[];
  uint32_t* fc_s = smem;
  uint8_t* sym_s = reinterpret_cast<uint8_t*>(smem + 256);
  const int j = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const bool active = r < rows;
  const uint32_t lt = tpx::lanemask_lt();
  const int n_slots = 1 << bits;
  const uint32_t slot_mask = n_slots - 1;
  const int s4c = steps >> 2;

  uint32_t st[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) st[k] = active ? init[(size_t)r * kLanes + j + 32 * k] : 0u;

  for (int t = 0; t < n_tiles; ++t) {
    __syncthreads();  // every warp is done with the previous tile's tables
    for (int i = threadIdx.x; i < 256; i += blockDim.x) fc_s[i] = fctab[(size_t)t * 256 + i];
    const uint32_t* sym_w = reinterpret_cast<const uint32_t*>(symtab + (size_t)t * n_slots);
    for (int i = threadIdx.x; i < n_slots / 4; i += blockDim.x) reinterpret_cast<uint32_t*>(sym_s)[i] = sym_w[i];
    __syncthreads();
    if (!active) continue;

    const size_t row_id = (size_t)t * rows + r;
    const uint32_t* srow = stream + row_id * w_slots;
    uint32_t* orow = out + row_id * s4c * kLanes;
    // wire position of (tile t, row r, group 0, lane 0, step 0) in the mega
    const long long row_pos = (long long)row_id * s4c * kLanes * 4;
    // step groups holding a position below vlen; past them no state changes
    // and every byte is 0 (bounds the work on a short last mega)
    const long long with_data = (vlen - row_pos + kLanes * 4 - 1) / (kLanes * 4);
    const int s4_end = static_cast<int>(max(0LL, min((long long)s4c, with_data)));
    int rw = 0;  // words of this row's tile stream consumed so far
    for (int s4 = 0; s4 < s4c; ++s4) {
      uint32_t packed[4] = {0u, 0u, 0u, 0u};
      for (int i = 0; i < 4 && s4 < s4_end; ++i) {
        bool consume[4];
        unsigned ballot[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const uint32_t slot = st[k] & slot_mask;
          const uint32_t sym = sym_s[slot];
          const uint32_t fc = fc_s[sym];
          const long long pos = row_pos + ((long long)s4 * kLanes + j + 32 * k) * 4 + i;
          const bool valid = pos < vlen;  // past the data: state kept, byte 0
          if (valid) {
            st[k] = (st[k] >> bits) * (fc & 0xFFFFu) + slot - (fc >> 16);
            packed[k] |= sym << (8 * i);
          }
          consume[k] = valid && st[k] < tpx::kConsumePoint;
          ballot[k] = __ballot_sync(tpx::kFullMask, consume[k]);
        }
        int base = rw;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (consume[k]) {
            const int widx = base + __popc(ballot[k] & lt);
            const uint32_t v = srow[min(widx >> 1, w_slots - 1)];
            st[k] = (st[k] << 16) | ((v >> ((widx & 1) * 16)) & 0xFFFFu);
          }
          base += __popc(ballot[k]);
        }
        rw = base;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) orow[(size_t)s4 * kLanes + j + 32 * k] = packed[k];
    }
  }
}

}  // namespace

extern "C" int hsr_tpx_decode(const void* stream, const void* init, const void* symtab, const void* fctab,
                              void* out, int rows, int steps, int n_tiles, int w_slots, int bits,
                              long long vlen, void* cuda_stream) {
  const int blocks = (rows + kWarps - 1) / kWarps;
  const size_t smem = 256 * sizeof(uint32_t) + (size_t(1) << bits);  // <= 33 KiB at B=15
  tpx_decode_kernel<<<blocks, kWarps * 32, smem, static_cast<cudaStream_t>(cuda_stream)>>>(
      static_cast<const uint32_t*>(stream), static_cast<const uint32_t*>(init),
      static_cast<const uint8_t*>(symtab), static_cast<const uint32_t*>(fctab),
      static_cast<uint32_t*>(out), rows, steps, n_tiles, w_slots, bits, vlen);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* hsr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
