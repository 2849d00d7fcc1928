// hsrans_tpu native host codecs.
//
// The single-stream wire formats (raw rANS32xN, block_rANS32xN) are
// inherently serial: one interleaved word stream, one set of carried
// states, so a device kernel can only ever use N lanes of parallelism per
// blob (docs/PARITY.md).  The host tier therefore carries scalar C++
// codecs for them — the same division of labor as the reference, whose
// encoders are scalar C++ too (README.md:26).  These are *not* transcribed
// from the reference: they are table-driven, runtime-parameterized over the
// lane count (the reference instantiates C++ templates per B and
// hand-unrolls AVX variants per width), use reciprocal-multiply division
// (the reference's encoders divide), and share one section state machine
// across raw/block/mt.  Wire parity is enforced against the numpy authority
// (hsrans_tpu/ops/*.py) and reference golden vectors by tests/.
//
// Formats (semantics mirrored from ops/reference.py, ops/block.py,
// ops/mt.py; original layouts per rANS32x32_16w.cpp:130-158,
// block_rANS32x64_16w_decode.cpp:12-126, mt_rANS32x64_16w_encode.cpp:266-298):
//   raw:   u64 rawLen | u64 totalLen | 256*u16 freq | N*u32 states | words
//   block: u64 rawLen | u64 totalLen | N*u32 states |
//          per block: u64 size-or-RLE-indicator [| 256*u16 freq | words]
//   mt:    u64 rawLen | u64 totalLen | per block: indicator or
//          u64 size | u64 writeHeadOffset | N*u32 states | 256*u16 | words
//
// Build: make -C native  ->  libhsrans_native.so (single shared object with
// hsrans_native.cpp).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

// from hsrans_native.cpp (same shared object)
extern "C" {
void hsr_observe_hist(const uint8_t *data, uint64_t size, uint32_t hist[256]);
void hsr_normalize_hist(const uint32_t *hist, uint64_t data_bytes, uint32_t bits,
                        uint16_t out_freq[256], uint16_t out_cumul[256]);
struct SegPlanRow {
  uint64_t start, size;
  uint32_t is_single, symbol;
  uint16_t freq[256];
};
int64_t hsr_plan_blocks(const uint8_t *data, uint64_t length, uint32_t bits,
                        uint32_t mode, uint64_t state_count, SegPlanRow *rows,
                        int64_t max_rows);
void *hsr_pool_new(int32_t threads);
void hsr_pool_destroy(void *pool);
typedef void (*hsr_task_fn)(void *arg);
void hsr_pool_add(void *pool, hsr_task_fn fn, void *arg);
void hsr_pool_await(void *pool);
}

namespace {

constexpr uint32_t kConsumePoint = 1u << 15;
constexpr uint64_t kSingleBit = 1ull << 63;
constexpr uint32_t kSymShift = 54;
constexpr uint64_t kSizeMask = (1ull << 54) - 1;

// idx2idx lane->byte-offset permutation (rans.py:_interleave_perm): lane j
// of a group of N bytes encodes byte group_base + perm[j].  Compile-time so
// the templated lane loops see constant offsets.
template <uint32_t N>
struct Perm {
  uint8_t p[N];
  constexpr Perm() : p() {
    constexpr uint8_t p16[16] = {0, 1, 2, 3, 8, 9, 10, 11, 4, 5, 6, 7, 12, 13, 14, 15};
    for (uint32_t j = 0; j < N; j++) {
      if (N == 16) {
        p[j] = p16[j];
      } else {
        const uint32_t half = (j >> 5) << 5;  // 64 lanes = two 32-lane halves
        const uint32_t q = j & 31;            // 32-wide pattern from two 16s
        p[j] = (uint8_t)(half + ((q >> 3) << 2) + ((q & 4) << 2) + (q & 3));
      }
    }
  }
};

// One interleaved entry per symbol (a single cache line per 4 symbols):
// the emit threshold (2^(31-B) * freq < 2^31, so it fits u32) is
// precomputed to keep the lane step at two multiplies.
struct EncSym {
  uint16_t freq, cumul;
  uint32_t magic;  // ceil(2^(31+shift)/freq): q = ((m*s)>>31)>>shift
  uint32_t shift;
  uint32_t emit_at;  // (2^15 >> bits) << 16) * freq
};

struct EncTable {
  EncSym sym[256];
  // flat per-symbol tables for the AVX-512 path's gathers:
  // fc = freq | cumul<<16 (both < 2^16 for B <= 15); magic as above
  uint32_t fc[256];
  uint32_t magic[256];
  uint32_t bits;
};

void build_enc_table(const uint16_t freq[256], uint32_t bits, EncTable *t) {
  const uint32_t emit_point = (kConsumePoint >> bits) << 16;
  uint32_t c = 0;
  for (int i = 0; i < 256; i++) {
    const uint32_t d = freq[i] ? freq[i] : 1;
    uint32_t l = 0;
    while ((1u << l) < d) l++;
    t->sym[i].freq = freq[i];
    t->sym[i].cumul = (uint16_t)c;
    t->sym[i].magic = (uint32_t)(((((uint64_t)1 << (31 + l)) + d - 1) / d));
    t->sym[i].shift = l;
    t->sym[i].emit_at = emit_point * (uint32_t)freq[i];
    t->fc[i] = (uint32_t)freq[i] | (c << 16);
    t->magic[i] = t->sym[i].magic;
    c += freq[i];
  }
  t->bits = bits;
}

struct DecTable {
  // B<=12: one packed u32 per slot (sym | cumul<<8 | freq<<20).
  // B>=13: sym per slot + freq/cumul by symbol (fields fit u16 there);
  // fcsym = freq | cumul<<16 per symbol feeds the two-gather AVX-512 path
  // (the hist_dec2_t shape, hist.h:32-37, as one packed word).
  std::vector<uint32_t> pack;
  std::vector<uint8_t> sym;
  std::vector<uint32_t> fcslot;  // B>=13 slot-fc paths: fc per SLOT
  uint32_t freq[256];
  uint32_t cumul[256];
  uint32_t fcsym[256];
  uint32_t bits;
  bool packed;
  // packed-field layout: sym | cumul<<8 | (freq-1)<<freq_shift.  B<=12
  // uses the fixed 12-bit fields (mask 0xFFF, shift 20); the hi-bits
  // packing (B>=13 when max freq fits the 24-bits spare bits) widens the
  // cumul field to B bits and moves freq up.
  uint32_t cum_mask = 0xFFF;
  uint32_t freq_shift = 20;
};

bool build_dec_table(const uint16_t freq[256], uint32_t bits, DecTable *t,
                     bool d8_path = false, bool try_pack_hi = false) {
  const uint32_t total = 1u << bits;
  uint64_t sum = 0;
  uint32_t maxf = 0;
  for (int i = 0; i < 256; i++) {
    sum += freq[i];
    if (freq[i] > maxf) maxf = freq[i];
  }
  if (sum != total) return false;  // malformed histogram
  t->bits = bits;
  t->packed = bits <= 12;
  if (bits > 12 && try_pack_hi && maxf <= (1u << (24 - bits))) {
    // hi-bits packing: sym(8) | cumul(B) | freq-1(24-B) still fits one
    // u32 whenever no symbol's frequency exceeds 2^(24-B) — common on
    // real data at B=13/14 — restoring the single-gather decode the
    // B<=12 dec_pack layout gets (hist.h:46-50 rationale at depth)
    t->packed = true;
    t->cum_mask = total - 1;
    t->freq_shift = 8 + bits;
  }
  uint32_t c = 0;
  if (t->packed) {
    // sym | cumul<<8 | (freq-1)<<freq_shift: freq-1 keeps the full-mass
    // case inside the field.  The word is CONSTANT across a symbol's run
    // (cumul is the run start), so each run is one vector fill — the
    // block/mt codecs rebuild this table every ~32 KiB block, where a
    // scalar fill measured ~13% of the whole decode
    t->pack.resize(total);
    for (uint32_t s = 0; s < 256; s++) {
      const uint32_t w = s | (c << 8) | (((uint32_t)freq[s] - 1) << t->freq_shift);
      std::fill(t->pack.begin() + c, t->pack.begin() + c + freq[s], w);
      c += freq[s];
    }
  } else {
    t->sym.resize(total + 4);  // +4: the slot byte-gather reads 32 bits
    if (d8_path) t->fcslot.resize(total);
    for (uint32_t s = 0; s < 256; s++) {
      t->freq[s] = freq[s];
      t->cumul[s] = c;
      t->fcsym[s] = freq[s] | (c << 16);
      memset(t->sym.data() + c, (int)s, freq[s]);
      if (d8_path && freq[s]) {
        // fc duplicated per SLOT (constant across a symbol's run):
        // 16 states = 1 zmm, so the by-symbol fc gather CHAINED on the
        // slot-byte gather has nothing to overlap with — indexing both
        // tables by slot makes the two gathers independent and halves
        // the group's serial latency (the reference's hist_dec2_t
        // rationale, hist.h:32-37, for its 16-state codec)
        const uint32_t e = (uint32_t)freq[s] | (c << 16);
        std::fill(t->fcslot.begin() + c, t->fcslot.begin() + c + freq[s], e);
      }
      c += freq[s];
    }
  }
  return true;
}

// --- shared section state machines -----------------------------------------
//
// Encode runs BACKWARD over lane groups (rANS is LIFO), lanes descending,
// emitting words to a back-to-front cursor; the forward stream is then
// (group ascending, lane ascending), which is what decode consumes
// (ops/reference.py:encode_groups).  Templated on the lane count so the
// inner loops fully unroll with constant permutation offsets.

struct Coder {
  uint32_t n;
  uint32_t states[64];
};

inline void enc_lane(uint32_t &state, uint8_t b, const EncTable *t, uint16_t *&pw) {
  const EncSym e = t->sym[b];
  if (state >= e.emit_at) {
    *--pw = (uint16_t)state;
    state >>= 16;
  }
  const uint32_t q = (uint32_t)((((uint64_t)e.magic * state) >> 31) >> e.shift);
  state = (q << t->bits) + e.cumul + (state - q * e.freq);
}

#if defined(__x86_64__)
// AVX-512 fast paths (defined at end of TU; instantiated lazily)
template <uint32_t N>
uint16_t *encode_groups_avx512(Coder *co, const uint8_t *data, uint64_t start,
                               uint64_t num_groups, const EncTable *t, uint16_t *pw);
bool avx512cd_ok();
#endif

// Encode [start, end) (end == length may include the partial tail group).
// Words are written backward from *pw; returns the new cursor.
template <uint32_t N>
uint16_t *encode_span_t(Coder *co, const uint8_t *data, uint64_t start, uint64_t end,
                        uint64_t length, const EncTable *t, uint16_t *pw) {
  constexpr Perm<N> perm;
  const uint64_t span = end - start;
  const uint64_t total_groups = (span + N - 1) / N;
  if (!total_groups) return pw;
  uint32_t *st = co->states;
  // tail (last) group first when it is partial
  uint64_t g = total_groups;
  const uint64_t tail_base = start + (total_groups - 1) * N;
  if (tail_base + N > end || end > length) {
    g--;
    for (int64_t j = N - 1; j >= 0; j--) {
      const uint64_t pos = tail_base + perm.p[j];
      if (pos < (end < length ? end : length)) enc_lane(st[j], data[pos], t, pw);
    }
  }
#if defined(__x86_64__)
  if (g >= 4 && avx512cd_ok())
    return encode_groups_avx512<N>(co, data, start, g, t, pw);
#endif
  while (g--) {
    const uint8_t *base = data + start + g * N;
    for (int64_t j = N - 1; j >= 0; j--)
      enc_lane(st[j], base[perm.p[j]], t, pw);
  }
  return pw;
}

#if defined(__x86_64__)
// AVX-512 fast paths (defined below; instantiated at end of TU).  Both
// early-stop once the read cursor passes `safe_r` (returning the cursor,
// with *g_done = groups completed) so callers can run them directly on
// the unpadded wire bytes and only fall back to a copied tail when the
// cursor nears the end of the stream.
template <uint32_t N>
uint64_t decode_groups_avx512(Coder *co, const DecTable *t, const uint16_t *stream,
                              uint64_t safe_r, uint64_t r, uint8_t *out,
                              uint64_t out_pos, uint64_t num_groups, uint64_t *g_done);
template <uint32_t N>
uint64_t decode_groups_avx512_zmm(Coder *co, const DecTable *t, const uint16_t *stream,
                                  uint64_t safe_r, uint64_t r, uint8_t *out,
                                  uint64_t out_pos, uint64_t num_groups, uint64_t *g_done);
bool avx512vbmi2_ok();
void blk32_decode_avx512(const DecTable *t, const uint16_t *lanes_buf,
                         const uint8_t *lanes_buf8, const uint32_t *lane_off32,
                         uint32_t *r_io, uint32_t *states, uint8_t *out,
                         uint64_t full_groups, uint32_t word_bits);
void blk32_encode_chunk_avx512(const EncTable *t, const uint8_t *chunk, uint64_t groups,
                               uint32_t *states, uint32_t *scratch32, uint32_t *cnt_out,
                               uint32_t word_bits);
bool avx512_ok();
#endif

// Decode `num_groups` full groups into out[0..num_groups*N); then, if
// tail_start < length, the masked partial group.  Returns words consumed,
// or -1 if the stream would overrun (malformed input).
// With padded=true, `stream` must have >= 2N+8 words of readable zeroed
// slack past nwords (mid-renorm overreads land there).  With
// padded=false, `stream` is the raw wire bytes with NO slack: the vector
// kernels run directly on it while the cursor stays at least kGuard words
// clear of the end, then the remaining few words are copied to a small
// zero-padded thread-local tail and the span finishes there — this
// removes a full-stream padded memcpy, which measured ~15% of end-to-end
// decode.
template <uint32_t N>
int64_t decode_span_t(Coder *co, const DecTable *t, const uint16_t *stream,
                      uint64_t nwords, uint64_t r, uint8_t *out, uint64_t out_pos,
                      uint64_t num_groups, uint64_t tail_start, uint64_t length,
                      bool padded = true) {
  constexpr Perm<N> perm;
  // vector group: <= N words consumed, renorm reads <= 32 bytes at the
  // cursor, so stopping at nwords - (N + 16) keeps every access in-bounds
  constexpr uint64_t kGuard = N + 16;
  const uint32_t mask = (1u << t->bits) - 1;
  const uint32_t bits = t->bits;
  uint32_t *st = co->states;
  uint64_t g_done = 0;
  if (!padded) {
#if defined(__x86_64__)
    const uint64_t safe_r = nwords > kGuard ? nwords - kGuard : 0;
    if (num_groups >= 4 && r <= safe_r && avx512_ok()) {
      if (N != 32 && avx512vbmi2_ok())
        r = decode_groups_avx512_zmm<N>(co, t, stream, safe_r, r, out, out_pos, num_groups, &g_done);
      else
        r = decode_groups_avx512<N>(co, t, stream, safe_r, r, out, out_pos, num_groups, &g_done);
      out_pos += g_done * N;
      num_groups -= g_done;
    }
#endif
    if (num_groups == 0 && tail_start >= length) return (int64_t)r;
    static thread_local std::vector<uint16_t> tailbuf;
    const uint64_t r0 = r < nwords ? r : nwords;
    const uint64_t twords = nwords - r0;
    tailbuf.assign(twords + 2ull * N + 8, 0);
    memcpy(tailbuf.data(), stream + r0, twords * 2);
    const int64_t sub = decode_span_t<N>(co, t, tailbuf.data(), twords, r - r0, out,
                                         out_pos, num_groups, tail_start, length, true);
    return sub < 0 ? -1 : (int64_t)(r0 + (uint64_t)sub);
  }
#if defined(__x86_64__)
  if (num_groups >= 4 && avx512_ok()) {
    // padded: run to nwords; stopping short of num_groups means the
    // cursor overran the stream (malformed input)
    if (N != 32 && avx512vbmi2_ok())
      r = decode_groups_avx512_zmm<N>(co, t, stream, nwords, r, out, out_pos, num_groups, &g_done);
    else
      r = decode_groups_avx512<N>(co, t, stream, nwords, r, out, out_pos, num_groups, &g_done);
    if (g_done < num_groups) return -1;
    num_groups = 0;
  }
#endif
  if (t->packed) {
    const uint32_t *pk = t->pack.data();
    const uint32_t cmask = t->cum_mask, fshift = t->freq_shift;
    for (uint64_t g = 0; g < num_groups; g++) {
      uint8_t *og = out + out_pos + g * N;
      if (r + N > nwords + N) return -1;  // padded slack: one group max
      for (uint32_t j = 0; j < N; j++) {
        uint32_t s = st[j];
        const uint32_t v = pk[s & mask];
        og[perm.p[j]] = (uint8_t)v;
        s = (s >> bits) * ((v >> fshift) + 1) + (s & mask) - ((v >> 8) & cmask);
        // branchy renorm on purpose: a cmov makes the read cursor a data
        // dependency (each lane's load waits on the previous lane's r);
        // the predicted branch lets the cursor speculate ahead
        if (s < kConsumePoint) s = (s << 16) | stream[r++];
        st[j] = s;
      }
    }
  } else {
    const uint8_t *sy = t->sym.data();
    for (uint64_t g = 0; g < num_groups; g++) {
      uint8_t *og = out + out_pos + g * N;
      if (r + N > nwords + N) return -1;
      for (uint32_t j = 0; j < N; j++) {
        uint32_t s = st[j];
        const uint32_t slot = s & mask;
        const uint8_t b = sy[slot];
        og[perm.p[j]] = b;
        s = (s >> bits) * t->freq[b] + slot - t->cumul[b];
        if (s < kConsumePoint) s = (s << 16) | stream[r++];
        st[j] = s;
      }
    }
  }
  if (tail_start < length) {
    if (r + N > nwords + N) return -1;
    for (uint32_t j = 0; j < N; j++) {
      const uint64_t pos = tail_start + perm.p[j];
      if (pos >= length) continue;
      uint32_t s = st[j];
      const uint32_t slot = s & mask;
      uint32_t f, c;
      uint8_t b;
      if (t->packed) {
        const uint32_t v = t->pack[slot];
        b = (uint8_t)v;
        c = (v >> 8) & t->cum_mask;
        f = (v >> t->freq_shift) + 1;
      } else {
        b = t->sym[slot];
        f = t->freq[b];
        c = t->cumul[b];
      }
      out[pos] = b;
      s = (s >> bits) * f + slot - c;
      if (s < kConsumePoint) s = (s << 16) | stream[r++];
      st[j] = s;
    }
  }
  return (int64_t)r;
}

// runtime-n dispatch to the unrolled instantiations
uint16_t *encode_span(Coder *co, const uint8_t *data, uint64_t start, uint64_t end,
                      uint64_t length, const EncTable *t, uint16_t *pw) {
  switch (co->n) {
    case 16: return encode_span_t<16>(co, data, start, end, length, t, pw);
    case 32: return encode_span_t<32>(co, data, start, end, length, t, pw);
    default: return encode_span_t<64>(co, data, start, end, length, t, pw);
  }
}

int64_t decode_span(Coder *co, const DecTable *t, const uint16_t *stream,
                    uint64_t nwords, uint64_t r, uint8_t *out, uint64_t out_pos,
                    uint64_t num_groups, uint64_t tail_start, uint64_t length,
                    bool padded = true) {
  switch (co->n) {
    case 16: return decode_span_t<16>(co, t, stream, nwords, r, out, out_pos, num_groups, tail_start, length, padded);
    case 32: return decode_span_t<32>(co, t, stream, nwords, r, out, out_pos, num_groups, tail_start, length, padded);
    default: return decode_span_t<64>(co, t, stream, nwords, r, out, out_pos, num_groups, tail_start, length, padded);
  }
}

void init_coder(Coder *co, uint32_t n) {
  co->n = n;
  for (uint32_t j = 0; j < n; j++) co->states[j] = kConsumePoint;
}

inline void put_u64(uint8_t *p, uint64_t v) { memcpy(p, &v, 8); }
inline uint64_t get_u64(const uint8_t *p) { uint64_t v; memcpy(&v, p, 8); return v; }

}  // namespace

extern "C" {

// --- raw rANS32xN 16w --------------------------------------------------------

int64_t hsr_raw_encode(const uint8_t *data, uint64_t size, uint8_t *out,
                       uint64_t cap, uint32_t bits, uint32_t n) {
  if (bits < 10 || bits > 15 || (n != 16 && n != 32 && n != 64)) return -1;
  uint32_t counts[256] = {};
  uint16_t freq[256], cumul[256];
  if (size) {
    hsr_observe_hist(data, size, counts);
  } else {
    counts[0] = 1;
  }
  hsr_normalize_hist(counts, size ? size : 1, bits, freq, cumul);

  EncTable t;
  build_enc_table(freq, bits, &t);
  Coder co;
  init_coder(&co, n);

  // worst case: <= B (15) bits emitted per input byte + 16 bits/lane
  // of initial-state drain, so `size` words always suffice
  std::vector<uint16_t> scratch(size + 2 * n + 16);
  uint16_t *pend = scratch.data() + scratch.size();
  uint16_t *pw = encode_span(&co, data, 0, size, size, &t, pend);
  const uint64_t w_count = (uint64_t)(pend - pw);

  const uint64_t total = 16 + 512 + 4ull * n + 2 * w_count;
  if (total > cap) return -1;
  put_u64(out, size);
  put_u64(out + 8, total);
  memcpy(out + 16, freq, 512);
  memcpy(out + 16 + 512, co.states, 4ull * n);
  memcpy(out + 16 + 512 + 4ull * n, pw, 2 * w_count);
  return (int64_t)total;
}

int64_t hsr_raw_decode(const uint8_t *blob, uint64_t size, uint8_t *out,
                       uint64_t cap, uint32_t bits, uint32_t n) {
  if (bits < 10 || bits > 15 || (n != 16 && n != 32 && n != 64)) return -1;
  if (size < 16 + 512 + 4ull * n) return -1;
  const uint64_t length = get_u64(blob);
  if (get_u64(blob + 8) > size || length > cap) return -1;
  uint16_t freq[256];
  memcpy(freq, blob + 16, 512);
  DecTable t;
  if (!build_dec_table(freq, bits, &t, bits >= 13, bits >= 13)) return -1;
  Coder co;
  init_coder(&co, n);
  memcpy(co.states, blob + 16 + 512, 4ull * n);

  const uint64_t off = 16 + 512 + 4ull * n;
  // decode straight off the wire bytes (padded=false): the kernels stop a
  // guard short of the end and the tail finishes on a small padded copy
  const uint16_t *stream = (const uint16_t *)(blob + off);
  const uint64_t nwords = (size - off) / 2;

  const uint64_t full = length + 1 > n ? (length - n + 1 + n - 1) / n : 0;
  const uint64_t tail_start = full * n;
  if (decode_span(&co, &t, stream, nwords, 0, out, 0, full,
                  tail_start < length ? tail_start : length, length, false) < 0)
    return -1;
  return (int64_t)length;
}

// --- block_rANS32xN 16w ------------------------------------------------------

int64_t hsr_block_encode(const uint8_t *data, uint64_t size, uint8_t *out,
                         uint64_t cap, uint32_t bits, uint32_t n) {
  if (bits < 10 || bits > 15 || (n != 32 && n != 64)) return -1;
  const uint64_t hdr = 16 + 4ull * n;
  if (size == 0) {
    if (cap < hdr) return -1;
    put_u64(out, 0);
    put_u64(out + 8, hdr);
    for (uint64_t j = 0; j < n; j++) memcpy(out + 16 + 4 * j, &kConsumePoint, 4);
    return (int64_t)hdr;
  }
  const int64_t max_rows = (int64_t)(size >> 15) + 4;
  std::vector<SegPlanRow> rows(max_rows);
  const int64_t n_rows = hsr_plan_blocks(data, size, bits, 0, n, rows.data(), max_rows);
  if (n_rows <= 0) return -1;

  Coder co;
  init_coder(&co, n);
  EncTable t;
  // per-row word streams, encoded in planner order (= LIFO: last block
  // first); emitted backward into one scratch, sliced per row
  // worst case <= 15 bits/byte (the per-block lookahead histogram can
  // mismatch a block's true distribution), so `size` words suffice
  std::vector<uint16_t> scratch(size + 2ull * n * (uint64_t)n_rows + 16);
  uint16_t *pend = scratch.data() + scratch.size();
  uint16_t *pw = pend;
  std::vector<uint64_t> w_count(n_rows);
  for (int64_t k = 0; k < n_rows; k++) {
    const SegPlanRow &row = rows[k];
    if (row.is_single) {
      w_count[k] = 0;
      continue;
    }
    uint16_t *prev = pw;
    build_enc_table(row.freq, bits, &t);
    pw = encode_span(&co, data, row.start, row.start + row.size, size, &t, pw);
    w_count[k] = (uint64_t)(prev - pw);
  }

  // block k's words live at [pend - pre[k+1], pend - pre[k]) in the
  // back-to-front scratch (k in processing order = input-last first)
  std::vector<uint64_t> pre(n_rows + 1, 0);
  for (int64_t k = 0; k < n_rows; k++) pre[k + 1] = pre[k] + w_count[k];

  uint8_t *o = out + hdr;
  uint8_t *const oend = out + cap;
  for (int64_t k = n_rows - 1; k >= 0; k--) {  // forward input order
    const SegPlanRow &row = rows[k];
    if (row.is_single) {
      if (o + 8 > oend) return -1;
      put_u64(o, row.size | kSingleBit | ((uint64_t)row.symbol << kSymShift));
      o += 8;
      continue;
    }
    const uint16_t *pr = pend - pre[k + 1];
    if (o + 8 + 512 + 2 * w_count[k] > oend) return -1;
    put_u64(o, row.size);
    memcpy(o + 8, row.freq, 512);
    memcpy(o + 8 + 512, pr, 2 * w_count[k]);
    o += 8 + 512 + 2 * w_count[k];
  }
  put_u64(out, size);
  put_u64(out + 8, (uint64_t)(o - out));
  memcpy(out + 16, co.states, 4ull * n);
  return o - out;
}

int64_t hsr_block_decode(const uint8_t *blob, uint64_t size, uint8_t *out,
                         uint64_t cap, uint32_t bits, uint32_t n) {
  if (bits < 10 || bits > 15 || (n != 32 && n != 64)) return -1;
  if (size < 16 + 4ull * n + 8) return -1;
  const uint64_t length = get_u64(blob);
  if (get_u64(blob + 8) > size || length > cap) return -1;
  if (length == 0) return 0;
  Coder co;
  init_coder(&co, n);
  memcpy(co.states, blob + 16, 4ull * n);
  const uint16_t *stream = (const uint16_t *)(blob + 16 + 4ull * n);
  const uint64_t nwords = (size - 16 - 4ull * n) / 2;

  const uint64_t out_len_states = length + 1 > n ? length - n + 1 : 0;
  DecTable t;
  bool have_table = false;
  uint64_t i = 0, r = 0;
  while (true) {
    if (r + 4 > nwords) return -1;
    const uint64_t val = get_u64((const uint8_t *)(stream + r));
    r += 4;
    if (val & kSingleBit) {
      const uint64_t bs = val & kSizeMask;
      if (i + bs > length) return -1;
      memset(out + i, (int)((val >> kSymShift) & 0xFF), bs);
      i += bs;
    } else {
      if (r + 256 > nwords) return -1;
      uint16_t freq[256];
      memcpy(freq, stream + r, 512);
      r += 256;
      if (!build_dec_table(freq, bits, &t, bits >= 13, bits >= 13)) return -1;
      have_table = true;
      uint64_t block_end = i + val;
      if (block_end > out_len_states) block_end = out_len_states;
      else if (block_end & (n - 1)) return -1;
      const uint64_t groups = block_end > i ? (block_end - i + n - 1) / n : 0;
      const int64_t nr = decode_span(&co, &t, stream, nwords, r, out, i, groups, length, length, false);
      if (nr < 0) return -1;
      r = (uint64_t)nr;
      i += groups * n;
    }
    if (i >= out_len_states) break;
  }
  if (i < length) {
    if (!have_table) return -1;
    if (decode_span(&co, &t, stream, nwords, r, out, 0, 0, i, length, false) < 0) return -1;
  }
  return (int64_t)length;
}

// --- mt_rANS32xN 16w ---------------------------------------------------------

int64_t hsr_mt_encode(const uint8_t *data, uint64_t size, uint8_t *out,
                      uint64_t cap, uint32_t bits, uint32_t n) {
  if (bits < 10 || bits > 15 || (n != 32 && n != 64)) return -1;
  if (size == 0) {
    if (cap < 16) return -1;
    put_u64(out, 0);
    put_u64(out + 8, 16);
    return 16;
  }
  const int64_t max_rows = (int64_t)(size >> 15) + 4;
  std::vector<SegPlanRow> rows(max_rows);
  const int64_t n_rows = hsr_plan_blocks(data, size, bits, 1, n, rows.data(), max_rows);
  if (n_rows <= 0) return -1;

  Coder co;
  init_coder(&co, n);
  EncTable t;
  // worst case <= 15 bits/byte (the per-block lookahead histogram can
  // mismatch a block's true distribution), so `size` words suffice
  std::vector<uint16_t> scratch(size + 2ull * n * (uint64_t)n_rows + 16);
  uint16_t *pend = scratch.data() + scratch.size();
  uint16_t *pw = pend;
  std::vector<uint64_t> w_count(n_rows);
  // per-block state snapshots: block k's decoder starts from the encoder's
  // states *after* block k was (LIFO-)encoded (ops/mt.py)
  std::vector<uint32_t> snaps((uint64_t)n_rows * n);
  for (int64_t k = 0; k < n_rows; k++) {
    const SegPlanRow &row = rows[k];
    if (row.is_single) {
      w_count[k] = 0;
      continue;
    }
    uint16_t *prev = pw;
    build_enc_table(row.freq, bits, &t);
    pw = encode_span(&co, data, row.start, row.start + row.size, size, &t, pw);
    w_count[k] = (uint64_t)(prev - pw);
    memcpy(snaps.data() + (uint64_t)k * n, co.states, 4ull * n);
  }

  std::vector<uint64_t> pre(n_rows + 1, 0);
  for (int64_t k = 0; k < n_rows; k++) pre[k + 1] = pre[k] + w_count[k];

  uint8_t *o = out + 16;
  uint8_t *const oend = out + cap;
  for (int64_t k = n_rows - 1; k >= 0; k--) {
    const SegPlanRow &row = rows[k];
    if (row.is_single) {
      if (o + 8 > oend) return -1;
      put_u64(o, row.size | kSingleBit | ((uint64_t)row.symbol << kSymShift));
      o += 8;
      continue;
    }
    const uint16_t *pr = pend - pre[k + 1];
    if (o + 16 + 4ull * n + 512 + 2 * w_count[k] > oend) return -1;
    // words from the states field (+1) to the next block's size field; the
    // last input block's offset points at the stream end slot instead
    const uint64_t offset = 2ull * n + 256 + w_count[k] - (k == 0 ? 2 : 1);
    put_u64(o, row.size);
    put_u64(o + 8, offset);
    memcpy(o + 16, snaps.data() + (uint64_t)k * n, 4ull * n);
    memcpy(o + 16 + 4ull * n, row.freq, 512);
    memcpy(o + 16 + 4ull * n + 512, pr, 2 * w_count[k]);
    o += 16 + 4ull * n + 512 + 2 * w_count[k];
  }
  put_u64(out, size);
  put_u64(out + 8, (uint64_t)(o - out));
  return o - out;
}

namespace {

struct MtBlockTask {
  const uint16_t *stream;
  uint64_t nwords, word_start;
  uint64_t out_start, block_size, length;
  const uint16_t *freq;  // points into the padded stream
  const uint8_t *states_raw;
  uint8_t *out;
  uint32_t bits, n;
  bool is_last;
  std::atomic<int32_t> *fail;
};

void mt_block_worker(void *arg) {
  auto *b = (MtBlockTask *)arg;
  DecTable t;
  uint16_t freq[256];
  memcpy(freq, b->freq, 512);
  if (!build_dec_table(freq, b->bits, &t, b->bits >= 13, b->bits >= 13)) {
    b->fail->store(1);
    return;
  }
  Coder co;
  init_coder(&co, b->n);
  memcpy(co.states, b->states_raw, 4ull * b->n);
  const uint64_t out_len_states = b->length + 1 > b->n ? b->length - b->n + 1 : 0;
  uint64_t block_end = b->out_start + b->block_size;
  if (block_end > out_len_states) block_end = out_len_states;
  const uint64_t span = block_end > b->out_start ? block_end - b->out_start : 0;
  // Non-last blocks whose size isn't a multiple of n may NOT write the
  // ceil-group overshoot into the next block's output range: the sequential
  // oracle (ops/mt.py mt_decode_py) resolves the overlap by decode order
  // (later block wins), but here RLE memsets run during the header walk and
  // coded blocks run concurrently, so an overshoot would race with — or
  // clobber — the following block.  Decode floor(span/n) groups in place and
  // route the partial group through a scratch line, copying only the bytes
  // inside this block's range.
  uint64_t groups = (span + b->n - 1) / b->n;
  uint64_t rem = 0;
  if (!b->is_last) {
    groups = span / b->n;
    rem = span % b->n;
  }
  int64_t r = decode_span(&co, &t, b->stream, b->nwords, b->word_start, b->out,
                          b->out_start, groups, b->length, b->length, false);
  if (r < 0) {
    b->fail->store(1);
    return;
  }
  if (rem) {
    uint8_t scratch[64];
    r = decode_span(&co, &t, b->stream, b->nwords, (uint64_t)r, scratch, 0, 1,
                    b->length, b->length, false);
    if (r < 0) {
      b->fail->store(1);
      return;
    }
    memcpy(b->out + b->out_start + groups * b->n, scratch, rem);
  }
  if (b->is_last && b->out_start + groups * b->n < b->length) {
    // trailing partial lane group belongs to the last coded block's chain
    if (decode_span(&co, &t, b->stream, b->nwords, (uint64_t)r, b->out, 0, 0,
                    b->out_start + groups * b->n, b->length, false) < 0)
      b->fail->store(1);
  }
}

}  // namespace

int64_t hsr_mt_decode(const uint8_t *blob, uint64_t size, uint8_t *out,
                      uint64_t cap, uint32_t bits, uint32_t n, int32_t threads) {
  if (bits < 10 || bits > 15 || (n != 32 && n != 64)) return -1;
  if (size < 16) return -1;
  const uint64_t length = get_u64(blob);
  if (get_u64(blob + 8) > size || length > cap) return -1;
  if (length == 0) return 0;
  const uint16_t *stream = (const uint16_t *)(blob + 16);
  const uint64_t nwords = (size - 16) / 2;
  const uint64_t out_len_states = length + 1 > n ? length - n + 1 : 0;

  // header walk (the writeHeadOffset chain) -> independent block tasks
  std::vector<MtBlockTask> tasks;
  tasks.reserve(64);
  std::atomic<int32_t> fail{0};
  uint64_t i = 0, r = 0;
  int64_t last_coded = -1;
  while (i < length) {
    if (r + 4 > nwords) return -1;
    const uint64_t val = get_u64((const uint8_t *)(stream + r));
    r += 4;
    if (val & kSingleBit) {
      const uint64_t bs = val & kSizeMask;
      if (i + bs > length) return -1;
      memset(out + i, (int)((val >> kSymShift) & 0xFF), bs);
      i += bs;
      continue;
    }
    if (r + 4 + 2ull * n + 256 > nwords) return -1;  // unpadded stream: headers fully in-bounds
    const uint64_t offset = get_u64((const uint8_t *)(stream + r));
    r += 4;
    const uint64_t states_pos = r;
    const uint8_t *states_raw = (const uint8_t *)(stream + r);
    r += 2ull * n;
    const uint16_t *freq = stream + r;
    r += 256;
    MtBlockTask task;
    task.stream = stream;
    task.nwords = nwords;
    task.word_start = r;
    task.out_start = i;
    task.block_size = val < length - i ? val : length - i;
    task.length = length;
    task.freq = freq;
    task.states_raw = states_raw;
    task.out = out;
    task.bits = bits;
    task.n = n;
    task.is_last = i + val > out_len_states;
    task.fail = &fail;
    last_coded = (int64_t)tasks.size();
    tasks.push_back(task);
    i += val;
    if (task.is_last) break;
    // the forward skip must land inside the stream; an unchecked add would
    // wrap uint64 for crafted offsets and defeat the r+4 bound above
    if (offset > nwords || states_pos + offset + 1 > nwords) return -1;
    r = states_pos + offset + 1;
  }
  (void)last_coded;

  if (tasks.size() <= 1 || threads == 1) {
    for (auto &task : tasks) mt_block_worker(&task);
  } else {
    void *pool = hsr_pool_new(threads);
    for (auto &task : tasks) hsr_pool_add(pool, mt_block_worker, &task);
    hsr_pool_await(pool);
    hsr_pool_destroy(pool);
  }
  return fail.load() ? -1 : (int64_t)length;
}

// The card decoder's operands of an mt blob (the port's
// kernels/mt_decode.py), by one walk of the header chain over blob[16:]
// read where it lies as u16 words: index [coded][5] (word_start, word_end,
// out_start, out_limit, num_groups), states [coded][n], fc [coded][256]
// (freq | cumul << 16) and single [singles][3] (out_start, size, symbol),
// bit for bit what kernels/mt_decode.py::index_blocks + block_operands
// build.  counts gets (length, coded, singles, 1 if the last block is
// single-symbol).  A coded block's words end where the next header starts;
// the last coded block's run to the end of the words.  Returns 0; -1 where
// that pair gives None (a short blob, a total length past the blob, a
// header past the words, a coded block other than the last whose words end
// before they start, freqs not summing to 2^bits), for a length past
// int64, where it raises, and for bits over 15 or n other than 32 and 64;
// -2 where a table has fewer rows than counts gives: the walk ran to its
// end and wrote only the rows that fit, so a caller may count with tables
// of 0 rows, then walk again into tables of the size counted.
// Bounds rule: unlike hsr_mt_decode, which refuses a coded header not
// wholly inside the words, a header here only has to start 4 words before
// their end, and any word past it reads as 0.
int64_t hsr_mt_index(const uint8_t *blob, uint64_t size, uint32_t bits, uint32_t n, int64_t *index,
                     uint32_t *states, uint32_t *fc, int64_t max_coded, int64_t *single, int64_t max_single,
                     int64_t *counts) {
  counts[0] = counts[1] = counts[2] = counts[3] = 0;
  if (bits > 15 || (n != 32 && n != 64) || size < 16) return -1;
  const uint64_t length = get_u64(blob);
  if (get_u64(blob + 8) > size || length > (uint64_t)INT64_MAX) return -1;
  const uint8_t *words = blob + 16;
  const uint64_t nwords = (size - 16) / 2;
  // words [at, at + count) into out, 0 past the end of the words
  auto read = [&](uint64_t at, uint64_t count, void *out) {
    const uint64_t have = at < nwords ? (nwords - at < count ? nwords - at : count) : 0;
    if (have) memcpy(out, words + 2 * at, 2 * have);
    memset((uint8_t *)out + 2 * have, 0, 2 * (count - have));
  };
  const uint64_t out_len_states = length + 1 > n ? length - n + 1 : 0;
  int64_t nc = 0, ns = 0;
  uint64_t i = 0, r = 0;
  uint64_t prev_start = 0, prev_end = 0;  // the last coded block's word_start, and the next header's start
  bool after_coded = false, last_single = false;
  while (i < length) {
    if (r + 4 > nwords) return -1;
    if (after_coded) prev_end = r;
    after_coded = false;
    uint64_t val, offset;
    read(r, 4, &val);
    if (val & kSingleBit) {
      const uint64_t bs = val & kSizeMask;
      if (ns < max_single) {
        int64_t *row = single + 3 * ns;
        row[0] = (int64_t)i;
        row[1] = (int64_t)bs;
        row[2] = (int64_t)((val >> kSymShift) & 0xFF);
      }
      ns++;
      i += bs;
      r += 4;
      last_single = true;
      continue;
    }
    read(r + 4, 4, &offset);
    const uint64_t states_pos = r + 8;
    const uint64_t word_start = states_pos + 2ull * n + 256;
    if (nc > 0) {  // the previous coded block is not the last: its words end here
      if (prev_end < prev_start) return -1;
      if (nc <= max_coded) index[5 * (nc - 1) + 1] = (int64_t)prev_end;
    }
    uint16_t freq[256];
    read(word_start - 256, 256, freq);
    uint32_t sum = 0;
    for (uint32_t s = 0; s < 256; s++) sum += freq[s];
    if (sum != 1u << bits) return -1;
    if (nc < max_coded) {
      const uint64_t bsize = val < length - i ? val : length - i;
      const uint64_t end = i + bsize < out_len_states ? i + bsize : out_len_states;
      int64_t *row = index + 5 * nc;
      row[0] = (int64_t)word_start;
      row[1] = (int64_t)nwords;
      row[2] = (int64_t)i;
      row[3] = (int64_t)(i + bsize);
      row[4] = end > i ? (int64_t)((end - i + n - 1) / n) : 0;
      read(states_pos, 2ull * n, states + (uint64_t)n * nc);  // u32 states: low word first
      uint32_t *f = fc + 256ull * nc, cumul = 0;
      for (uint32_t s = 0; s < 256; s++) {
        f[s] = freq[s] | cumul << 16;
        cumul += freq[s];
      }
    }
    nc++;
    prev_start = word_start;
    after_coded = true;
    last_single = false;
    const bool is_last = i + val > out_len_states;
    i += val;
    if (is_last) break;
    r = offset < nwords ? states_pos + offset + 1 : nwords;  // past the words either way where offset is
  }
  if (nc > 0 && nc <= max_coded && !last_single) index[5 * (nc - 1) + 3] = (int64_t)length;
  counts[0] = (int64_t)length;
  counts[1] = nc;
  counts[2] = ns;
  counts[3] = last_single;
  return nc > max_coded || ns > max_single ? -2 : 0;
}

}  // extern "C"

// --- rANS32x32 32blk (independent per-lane streams, 16w and 8w) -------------
//
// 32 states, each with a PRIVATE stream (no cross-lane renorm coupling;
// rans32x32_32blk_16w.cpp:42-57, 160-175).  8w consumes/emits up to two
// 8-bit words per step (DecodeConsumePoint8 = 1<<23).  Semantics mirrored
// from ops/blk32.py; per-lane forward stream = (groups ascending, emission
// substep DESCENDING), which a backward writer produces naturally.

extern "C" int64_t hsr_blk32_encode(const uint8_t *data, uint64_t size, uint8_t *out,
                                    uint64_t cap, uint32_t bits, uint32_t word_bits) {
  if (bits < 10 || bits > 15 || (word_bits != 16 && word_bits != 8)) return -1;
  constexpr uint32_t N32 = 32;
  constexpr Perm<N32> perm;
  uint32_t counts[256] = {};
  uint16_t freq[256], cumul[256];
  if (size) hsr_observe_hist(data, size, counts);
  else counts[0] = 1;
  hsr_normalize_hist(counts, size ? size : 1, bits, freq, cumul);
  EncTable t;
  build_enc_table(freq, bits, &t);  // emit_at is 16w-specific; recompute for 8w
  const uint32_t emit_point8 = ((1u << 23) >> bits) << 8;

  const uint32_t init = word_bits == 16 ? kConsumePoint : (1u << 23);
  uint32_t st[N32];
  for (uint32_t j = 0; j < N32; j++) st[j] = init;

  // per-lane worst case: size/32 bytes/lane * 15 bits -> < size/17 words
  // even for 8w (one u16 slot per 8-bit word here); size/16 + slack is safe
  const uint64_t lane_cap = size / 16 + 64;
  std::vector<uint16_t> scratch(lane_cap * N32);
  uint16_t *cur[N32], *end_[N32];
  for (uint32_t j = 0; j < N32; j++)
    cur[j] = end_[j] = scratch.data() + lane_cap * (j + 1);

  const uint64_t total = size ? (size + N32 - 1) / N32 : 0;
  uint64_t g_rem = total;
  // the tail (partial) group must go scalar; it is encoded FIRST (rANS is
  // LIFO), then full groups run through the AVX-512 chunk kernel
  if (total && total * N32 > size) {
    const uint64_t base = (total - 1) * N32;
    for (int64_t j = N32 - 1; j >= 0; j--) {
      const uint64_t pos = base + perm.p[j];
      if (pos >= size) continue;
      const EncSym e = t.sym[data[pos]];
      uint32_t s = st[j];
      if (word_bits == 16) {
        if (s >= e.emit_at) { *--cur[j] = (uint16_t)s; s >>= 16; }
      } else {
        const uint32_t max_state = emit_point8 * (uint32_t)e.freq;
        while (s >= max_state) { *--cur[j] = (uint8_t)s; s >>= 8; }
      }
      const uint32_t q = (uint32_t)((((uint64_t)e.magic * s) >> 31) >> e.shift);
      st[j] = (q << bits) + e.cumul + (s - q * e.freq);
    }
    g_rem = total - 1;
  }
#if defined(__x86_64__)
  if (g_rem >= 64 && avx512cd_ok()) {
    constexpr uint64_t kChunk = 1 << 14;  // 512 KiB of input per pass
    const int mult = word_bits == 16 ? 1 : 2;
    std::vector<uint32_t> soa(kChunk * N32 * mult);
    uint32_t vcnt[N32];
    while (g_rem > 0) {
      const uint64_t c = g_rem < kChunk ? g_rem : kChunk;
      blk32_encode_chunk_avx512(&t, data + (g_rem - c) * N32, c, st, soa.data(), vcnt, word_bits);
      for (uint32_t j = 0; j < N32; j++)
        for (uint32_t k = 0; k < vcnt[j]; k++)
          *--cur[j] = (uint16_t)soa[(uint64_t)k * N32 + j];
      g_rem -= c;
    }
  }
#endif
  for (uint64_t gi = g_rem; gi-- > 0;) {
    const uint64_t base = gi * N32;
    for (int64_t j = N32 - 1; j >= 0; j--) {
      const uint64_t pos = base + perm.p[j];
      const EncSym e = t.sym[data[pos]];
      uint32_t s = st[j];
      if (word_bits == 16) {
        if (s >= e.emit_at) { *--cur[j] = (uint16_t)s; s >>= 16; }
      } else {
        const uint32_t max_state = emit_point8 * (uint32_t)e.freq;
        while (s >= max_state) { *--cur[j] = (uint8_t)s; s >>= 8; }
      }
      const uint32_t q = (uint32_t)((((uint64_t)e.magic * s) >> 31) >> e.shift);
      st[j] = (q << bits) + e.cumul + (s - q * e.freq);
    }
  }

  const uint64_t wb = word_bits == 16 ? 2 : 1;
  uint64_t payload = 0;
  for (uint32_t j = 0; j < N32; j++) payload += (uint64_t)(end_[j] - cur[j]) * wb;
  const uint64_t hdr = 16 + 512 + 4 * N32 + 4 * (N32 - 1);
  if (hdr + payload > cap) return -1;
  put_u64(out, size);
  put_u64(out + 8, hdr + payload);
  memcpy(out + 16, freq, 512);
  memcpy(out + 16 + 512, st, 4 * N32);
  uint8_t *o = out + 16 + 512 + 4 * N32;
  for (uint32_t j = 0; j < N32 - 1; j++) {
    const uint32_t bytes_j = (uint32_t)((end_[j] - cur[j]) * wb);
    memcpy(o, &bytes_j, 4);
    o += 4;
  }
  for (uint32_t j = 0; j < N32; j++) {
    const uint64_t nw = (uint64_t)(end_[j] - cur[j]);
    if (word_bits == 16) {
      memcpy(o, cur[j], nw * 2);
      o += nw * 2;
    } else {
      for (uint64_t k = 0; k < nw; k++) o[k] = (uint8_t)cur[j][k];
      o += nw;
    }
  }
  return (int64_t)(o - out);
}

extern "C" int64_t hsr_blk32_decode(const uint8_t *blob, uint64_t size, uint8_t *out,
                                    uint64_t cap, uint32_t bits, uint32_t word_bits) {
  if (bits < 10 || bits > 15 || (word_bits != 16 && word_bits != 8)) return -1;
  constexpr uint32_t N32 = 32;
  constexpr Perm<N32> perm;
  const uint64_t hdr = 16 + 512 + 4 * N32 + 4 * (N32 - 1);
  if (size < hdr) return -1;
  const uint64_t length = get_u64(blob);
  if (get_u64(blob + 8) > size || length > cap) return -1;
  uint16_t freq[256];
  memcpy(freq, blob + 16, 512);
  DecTable t;
  // d8_path (slot-fc fallback) only at B=13/14: the 2^B*4-byte fcslot
  // stops paying at B=15 (128 KiB blows past L2; measured no gain over
  // the dependent sym->fc chain there).  try_pack_hi at any B>=13.
  if (!build_dec_table(freq, bits, &t, bits >= 13, bits >= 13)) return -1;
  uint32_t st[N32];
  memcpy(st, blob + 16 + 512, 4 * N32);

  // per-lane stream cursors; a padded copy gives renorm slack per lane
  const uint64_t wb = word_bits == 16 ? 2 : 1;
  uint64_t starts[N32 + 1];
  starts[0] = hdr;
  for (uint32_t j = 0; j < N32 - 1; j++) {
    uint32_t b32;
    memcpy(&b32, blob + 16 + 512 + 4 * N32 + 4 * j, 4);
    if (b32 % wb) return -1;
    starts[j + 1] = starts[j] + b32;
  }
  starts[N32] = size;
  if (starts[N32 - 1] > size) return -1;
  const uint64_t slack = 2 * ((length + N32 - 1) / N32) + 8;
  uint64_t lane_len[N32], lane_off[N32], r[N32];
  uint64_t tot = 0;
  for (uint32_t j = 0; j < N32; j++) {
    lane_len[j] = (starts[j + 1] - starts[j]) / wb;
    lane_off[j] = tot;
    tot += lane_len[j] + slack;
    r[j] = 0;
  }
  // Per-lane streams copied to slack-padded regions so renorm reads past a
  // lane's end stay in-bounds on malformed input.  The slack is left
  // uninitialized (a zero-fill pass measured ~10% of decode), and no word
  // of it is ever decoded: a read past a lane's payload yields 0, as the
  // numpy decoder's zero-padded lanes do, so a corrupted blob decodes to
  // bytes of the blob alone.  The scalar loop clamps each read; the vector
  // loop reads unbounded, so a lane that consumed past its payload there
  // sends the whole decode through the scalar loop (a valid blob never
  // does).  16w keeps u16 words; 8w keeps a tight byte mirror (the vector
  // path's scale-1 gather needs 4 real bytes per fetch).
  std::unique_ptr<uint16_t[]> lanes16;
  std::unique_ptr<uint8_t[]> lanes8;
  if (word_bits == 16) {
    lanes16.reset(new uint16_t[tot + 2]);
    for (uint32_t j = 0; j < N32; j++)
      memcpy(lanes16.get() + lane_off[j], blob + starts[j], lane_len[j] * 2);
  } else {
    lanes8.reset(new uint8_t[tot + 4]);
    for (uint32_t j = 0; j < N32; j++)
      memcpy(lanes8.get() + lane_off[j], blob + starts[j], lane_len[j]);
  }

  const uint32_t mask = (1u << bits) - 1;
  const uint32_t consume = word_bits == 16 ? kConsumePoint : (1u << 23);
  const uint32_t shift = word_bits == 16 ? 16 : 8;
  const int max_consumes = word_bits == 16 ? 1 : 2;
  if (length == 0) return 0;
  const uint64_t total = (length + N32 - 1) / N32;
  const uint64_t out_len_states = length + 1 > N32 ? length - N32 + 1 : 0;
  const uint64_t full = out_len_states ? (out_len_states + N32 - 1) / N32 : 0;

  uint64_t g0 = 0;
#if defined(__x86_64__)
  // _mm256_i32gather_epi32 sign-extends its 32-bit indices: off32+rr must
  // stay in signed-positive i32 range (max index is lane_off+r <= tot), so
  // payloads where tot would reach 2^31 take the 64-bit-index scalar loop.
  if (avx512_ok() && full >= 8 && tot + 8 < (1ull << 31)) {
    uint32_t r32[N32], off32[N32];
    for (uint32_t j = 0; j < N32; j++) {
      r32[j] = (uint32_t)r[j];
      off32[j] = (uint32_t)lane_off[j];
    }
    blk32_decode_avx512(&t, lanes16.get(), lanes8.get(), off32, r32, st, out, full, word_bits);
    // The vector loop carries no per-consume cursor bound; restore the
    // scalar tier's error contract (reject lane-cursor overrun past
    // lane_len+slack on malformed input) with one post-pass check.
    for (uint32_t j = 0; j < N32; j++)
      if (r32[j] > lane_len[j] + slack) return -1;
    bool past = false;
    for (uint32_t j = 0; j < N32; j++) past |= r32[j] > lane_len[j];
    if (past) {
      memcpy(st, blob + 16 + 512, 4 * N32);  // start over, scalar
    } else {
      for (uint32_t j = 0; j < N32; j++) r[j] = r32[j];
      g0 = full;
    }
  }
#endif
  for (uint64_t g = g0; g < total; g++) {
    const uint64_t base = g * N32;
    for (uint32_t j = 0; j < N32; j++) {
      const uint64_t pos = base + perm.p[j];
      if (g >= full && pos >= length) continue;
      uint32_t s = st[j];
      const uint32_t slot = s & mask;
      uint32_t f, c;
      uint8_t b;
      if (t.packed) {
        const uint32_t v = t.pack[slot];
        b = (uint8_t)v; c = (v >> 8) & t.cum_mask; f = (v >> t.freq_shift) + 1;
      } else {
        b = t.sym[slot]; f = t.freq[b]; c = t.cumul[b];
      }
      out[pos] = b;
      s = (s >> bits) * f + slot - c;
      for (int e = 0; e < max_consumes && s < consume; e++) {
        if (r[j] >= lane_len[j] + slack) return -1;
        const uint64_t k = r[j]++;
        const uint64_t at = lane_off[j] + k;
        const uint32_t w = k >= lane_len[j] ? 0u : word_bits == 16 ? lanes16[at] : (uint32_t)lanes8[at];
        s = (s << shift) | w;
      }
      st[j] = s;
    }
  }
  return (int64_t)length;
}

// --- AVX-512 decode fast path ------------------------------------------------
//
// The interleaved decode's per-step work is data-parallel across the N
// lanes; on x86 hosts with AVX-512 the whole step vectorizes with THREE
// modern primitives the reference's 2022-era LUT designs don't use:
//   * vpgatherdd   — packed slot->sym|cumul|freq table lookup (B<=12);
//   * vpexpandd    — renorm: distributes the next k stream words to the
//     k lanes whose state dropped below 2^15, in lane order, replacing
//     the movemask -> 256-entry shuffle-LUT -> popcount idiom entirely;
//   * vpermb       — one byte-permute applies the idx2idx output order
//     for a whole lane group.
// Falls back to the scalar path for B>12, partial tails, and non-AVX512
// hosts (runtime __builtin_cpu_supports check).

#if defined(__x86_64__)
#include <immintrin.h>

namespace {

template <uint32_t N>
__attribute__((target("avx2,avx512f,avx512bw,avx512vbmi,avx512vl")))
uint64_t decode_groups_avx512(Coder *co, const DecTable *t, const uint16_t *stream,
                              uint64_t safe_r, uint64_t r, uint8_t *out,
                              uint64_t out_pos, uint64_t num_groups, uint64_t *g_done) {
  // N/8 independent 8-lane (ymm) chains: the group-to-group critical path
  // is state -> slot -> table gather -> renorm -> state per sub-vector
  // (the shared read cursor only links the cheap popcount adds), and ymm
  // vpgatherdd has roughly half the 16-lane form's latency — measured the
  // difference between 0.7x and parity against the reference's AVX2
  // decoders on this core (same finding as the 32blk kernel).
  constexpr int NV = N / 8;
  constexpr Perm<N> perm;
  alignas(64) uint8_t inv[64] = {};
  for (uint32_t j = 0; j < N; j++) inv[perm.p[j]] = (uint8_t)j;
  const __m512i inv_idx = _mm512_loadu_si512(inv);
  const __m256i slot_mask = _mm256_set1_epi32((1 << t->bits) - 1);
  const __m256i cmask = _mm256_set1_epi32((int)t->cum_mask);
  const __m128i fshift = _mm_cvtsi32_si128((int)t->freq_shift);
  const __m256i lo16 = _mm256_set1_epi32(0xFFFF);
  const __m256i lo8 = _mm256_set1_epi32(0xFF);
  const __m256i one = _mm256_set1_epi32(1);
  const __m256i consume_lim = _mm256_set1_epi32(kConsumePoint);
  const bool packed = t->packed;
  const int *pk = packed ? (const int *)t->pack.data() : nullptr;
  const int *sym_tab = packed ? nullptr : (const int *)t->sym.data();
  const int *fc_tab = packed ? nullptr : (const int *)t->fcsym;
  const uint32_t bits = t->bits;

  __m256i st[NV];
  for (int v = 0; v < NV; v++) st[v] = _mm256_loadu_si256((const __m256i *)(co->states + 8 * v));

  alignas(64) uint8_t symbuf[64];
  __m256i symq[NV];
  uint64_t g = 0;
  for (; g < num_groups; g++) {
    if (r > safe_r) break;  // caller handles tail / malformed
    // phase 1: every sub-vector's table gather issues before the renorm
    // chain (slots come from last group's states)
    __m256i slot[NV], pck[NV], symv[NV];
    for (int v = 0; v < NV; v++) slot[v] = _mm256_and_si256(st[v], slot_mask);
    if (packed) {
      for (int v = 0; v < NV; v++) pck[v] = _mm256_i32gather_epi32(pk, slot[v], 4);
    } else {
      for (int v = 0; v < NV; v++)
        symv[v] = _mm256_and_si256(_mm256_i32gather_epi32(sym_tab, slot[v], 1), lo8);
      for (int v = 0; v < NV; v++) pck[v] = _mm256_i32gather_epi32(fc_tab, symv[v], 4);
    }
    for (int v = 0; v < NV; v++) {
      const __m256i sym = packed ? _mm256_and_si256(pck[v], lo8) : symv[v];
      const __m256i cum = packed ? _mm256_and_si256(_mm256_srli_epi32(pck[v], 8), cmask)
                                 : _mm256_srli_epi32(pck[v], 16);
      const __m256i freq = packed ? _mm256_add_epi32(_mm256_srl_epi32(pck[v], fshift), one)
                                  : _mm256_and_si256(pck[v], lo16);
      __m256i s = _mm256_add_epi32(
          _mm256_sub_epi32(slot[v], cum),
          _mm256_mullo_epi32(_mm256_srli_epi32(st[v], bits), freq));
      const __mmask8 k = _mm256_cmplt_epu32_mask(s, consume_lim);
      // next 8 stream words, distributed in lane order to the k lanes
      const __m256i words = _mm256_cvtepu16_epi32(_mm_loadu_si128((const __m128i *)(stream + r)));
      const __m256i renorm = _mm256_or_si256(_mm256_slli_epi32(s, 16),
                                             _mm256_maskz_expand_epi32(k, words));
      s = _mm256_mask_mov_epi32(s, k, renorm);
      r += (uint64_t)_mm_popcnt_u32((uint32_t)k);
      st[v] = s;
      if (N >= 32)
        symq[v] = sym;
      else
        _mm_storel_epi64((__m128i *)(symbuf + 8 * v), _mm256_cvtepi32_epi8(sym));
    }
    uint8_t *og = out + out_pos + g * N;
    if (N >= 32) {
      // idx2idx was designed so packus lands bytes in wire order per
      // 32-lane half (rANS32x32_16w.cpp:1182) — no permute, no bounce
      // through a byte buffer (8 narrow stores + one wide reload stall
      // store-forwarding every group)
      for (uint32_t h = 0; h < N / 32; h++) {
        const __m256i p01 = _mm256_packus_epi32(symq[4 * h + 0], symq[4 * h + 1]);
        const __m256i p23 = _mm256_packus_epi32(symq[4 * h + 2], symq[4 * h + 3]);
        _mm256_storeu_si256((__m256i *)(og + 32 * h), _mm256_packus_epi16(p01, p23));
      }
    } else {
      const __m512i wire = _mm512_permutexvar_epi8(inv_idx, _mm512_load_si512(symbuf));
      _mm_storeu_si128((__m128i *)og, _mm512_castsi512_si128(wire));
    }
  }
  for (int v = 0; v < NV; v++) _mm256_storeu_si256((__m256i *)(co->states + 8 * v), st[v]);
  *g_done = g;
  return r;
}

bool avx512vbmi2_ok() {
  static const bool ok = avx512_ok() && __builtin_cpu_supports("avx512vbmi2") &&
                         getenv("HSRANS_RAW_KERNEL_YMM") == nullptr;
  return ok;
}

// zmm variant: 16-lane state vectors — N/16 slot gathers per group instead
// of the ymm path's N/8.  The reference's best same-core x64 decoder
// ("avx512 ymm shfl2" = rANS32x64_16w_decode_avx512fdqbw_varC,
// rANS32x64_16w.cpp:3674-3900) holds states in zmm for the same reason:
// the slot gather dominates the group's critical cycle and the gather
// ports see half the traffic at 16 lanes/fetch; once all NV compare masks
// resolve, the shared read-cursor walk is only popcount adds.  Where the
// reference distributes renorm words via its 256-entry shuffle LUTs, this
// uses one load + vpexpandd per 16 lanes: no LUT cache line, mask order =
// lane order as the wire demands.  (A vpexpandd *from memory* off a
// u32-widened stream measured slower end-to-end: the widening pass costs
// more than the fused load saves.)  Measured on Sapphire Rapids: N=64
// 2.33 GB/s vs 2.0 ymm / 1.9 reference; N=16 also faster; N=32 slower
// (two chains can't hide the gather latency), so x32 keeps the ymm path.
template <uint32_t N, bool kPacked, bool kD8 = false>
__attribute__((target("avx2,avx512f,avx512bw,avx512vbmi,avx512vbmi2,avx512vl")))
uint64_t decode_groups_avx512_zmm_t(Coder *co, const DecTable *t, const uint16_t *stream16,
                                    uint64_t safe_r, uint64_t r, uint8_t *out,
                                    uint64_t out_pos, uint64_t num_groups, uint64_t *g_done) {
  constexpr int NV = N / 16;
  constexpr Perm<N> perm;
  // After packus(packus(sym0..3)) the byte of state j sits at a fixed
  // position (packus interleaves per 128-bit lane); one vpermb maps the
  // packed register straight to wire order (perm.p = idx2idx analog).
  //   N=64: packed[16*((j%16)/4) + 4*(j/16) + j%4] = sym[j]
  //   N=32 (packus_epi32 + vpmovwb): packed[8*((j%16)/4) + 4*(j/16) + j%4]
  //   N=16 (vpmovdb): packed[j]
  alignas(64) uint8_t pat[64] = {};
  for (uint32_t j = 0; j < N; j++) {
    uint32_t pb;
    if (N == 64) pb = 16 * ((j % 16) / 4) + 4 * (j / 16) + (j % 4);
    else if (N == 32) pb = 8 * ((j % 16) / 4) + 4 * (j / 16) + (j % 4);
    else pb = j;
    pat[perm.p[j]] = (uint8_t)pb;
  }
  const __m512i wire_pat = _mm512_load_si512(pat);
  const __m512i slot_mask = _mm512_set1_epi32((1 << t->bits) - 1);
  const __m512i cmask = _mm512_set1_epi32((int)t->cum_mask);
  const __m128i fshift = _mm_cvtsi32_si128((int)t->freq_shift);
  const __m512i lo16 = _mm512_set1_epi32(0xFFFF);
  const __m512i lo8 = _mm512_set1_epi32(0xFF);
  const __m512i one = _mm512_set1_epi32(1);
  const __m512i consume_lim = _mm512_set1_epi32((int)kConsumePoint);
  const int *pk = kPacked ? (const int *)t->pack.data() : nullptr;
  const int *sym_tab = kPacked ? nullptr : (const int *)t->sym.data();
  const int *fc_tab = kPacked ? nullptr : (const int *)t->fcsym;
  const uint32_t bits = t->bits;

  __m512i st[NV];
  for (int v = 0; v < NV; v++) st[v] = _mm512_loadu_si512(co->states + 16 * v);

  uint64_t g = 0;
  for (; g < num_groups; g++) {
    if (r > safe_r) break;  // caller handles tail / malformed
    __m512i slot[NV], pck[NV], symv[NV], sym[NV];
    for (int v = 0; v < NV; v++) slot[v] = _mm512_and_si512(st[v], slot_mask);
    if constexpr (kD8) {
      // fc duplicated per slot: both table gathers index by slot and issue
      // in PARALLEL — the group's serial latency drops by a gather.  Vital
      // at n=16 (one zmm of states leaves the chained fc gather nothing to
      // overlap with) and still a measured win for the multi-vector widths.
      const int *fcs = (const int *)t->fcslot.data();
      for (int v = 0; v < NV; v++) pck[v] = _mm512_i32gather_epi32(slot[v], fcs, 4);
      for (int v = 0; v < NV; v++)
        symv[v] = _mm512_and_si512(_mm512_i32gather_epi32(slot[v], sym_tab, 1), lo8);
    } else if (kPacked) {
      for (int v = 0; v < NV; v++) pck[v] = _mm512_i32gather_epi32(slot[v], pk, 4);
    } else {
      for (int v = 0; v < NV; v++)
        symv[v] = _mm512_and_si512(_mm512_i32gather_epi32(slot[v], sym_tab, 1), lo8);
      for (int v = 0; v < NV; v++) pck[v] = _mm512_i32gather_epi32(symv[v], fc_tab, 4);
    }
    __mmask16 k[NV];
    for (int v = 0; v < NV; v++) {
      sym[v] = kPacked ? _mm512_and_si512(pck[v], lo8) : symv[v];
      const __m512i cum = kPacked ? _mm512_and_si512(_mm512_srli_epi32(pck[v], 8), cmask)
                                  : _mm512_srli_epi32(pck[v], 16);
      const __m512i freq = kPacked ? _mm512_add_epi32(_mm512_srl_epi32(pck[v], fshift), one)
                                   : _mm512_and_si512(pck[v], lo16);
      const __m512i s = _mm512_add_epi32(
          _mm512_sub_epi32(slot[v], cum),
          _mm512_mullo_epi32(_mm512_srli_epi32(st[v], bits), freq));
      k[v] = _mm512_cmplt_epu32_mask(s, consume_lim);
      st[v] = s;
    }
    // read-cursor walk: each expand load's address depends only on the
    // previous popcount adds, so all NV loads issue as soon as the masks
    // resolve
    for (int v = 0; v < NV; v++) {
      const __m512i words = _mm512_cvtepu16_epi32(
          _mm256_loadu_si256((const __m256i *)(stream16 + r)));
      const __m512i w = _mm512_maskz_expand_epi32(k[v], words);
      r += (uint64_t)_mm_popcnt_u32((uint32_t)k[v]);
      st[v] = _mm512_or_si512(_mm512_mask_slli_epi32(st[v], k[v], st[v], 16), w);
    }
    uint8_t *og = out + out_pos + g * N;
    if constexpr (N == 64) {
      const __m512i p01 = _mm512_packus_epi32(sym[0], sym[NV > 1 ? 1 : 0]);
      const __m512i p23 = _mm512_packus_epi32(sym[NV > 2 ? 2 : 0], sym[NV > 3 ? 3 : 0]);
      const __m512i packedb = _mm512_packus_epi16(p01, p23);
      _mm512_storeu_si512((__m512i *)og, _mm512_permutexvar_epi8(wire_pat, packedb));
    } else if constexpr (N == 32) {
      const __m512i p01 = _mm512_packus_epi32(sym[0], sym[NV > 1 ? 1 : 0]);
      const __m256i b = _mm512_cvtepi16_epi8(p01);
      _mm256_storeu_si256((__m256i *)og,
                          _mm256_permutexvar_epi8(_mm512_castsi512_si256(wire_pat), b));
    } else {
      const __m128i b = _mm512_cvtepi32_epi8(sym[0]);
      _mm_storeu_si128((__m128i *)og, _mm_shuffle_epi8(b, _mm512_castsi512_si128(wire_pat)));
    }
  }
  for (int v = 0; v < NV; v++) _mm512_storeu_si512(co->states + 16 * v, st[v]);
  *g_done = g;
  return r;
}

// runtime table-layout dispatch to the compile-time-specialized kernels
// (a runtime branch inside the gather loop measured 2.5x slower)
template <uint32_t N>
uint64_t decode_groups_avx512_zmm(Coder *co, const DecTable *t, const uint16_t *stream,
                                  uint64_t safe_r, uint64_t r, uint8_t *out,
                                  uint64_t out_pos, uint64_t num_groups, uint64_t *g_done) {
  if (t->packed)
    return decode_groups_avx512_zmm_t<N, true>(co, t, stream, safe_r, r, out, out_pos, num_groups, g_done);
  if (!t->fcslot.empty())
    return decode_groups_avx512_zmm_t<N, false, true>(co, t, stream, safe_r, r, out, out_pos, num_groups, g_done);
  return decode_groups_avx512_zmm_t<N, false>(co, t, stream, safe_r, r, out, out_pos, num_groups, g_done);
}

// 32blk encode: emissions scatter to a [slot, lane] SOA scratch (each
// lane's streams are private, so slot = per-lane running count and the
// scatter indices never collide); the caller drains the scratch into the
// per-lane backward stream writers chunk by chunk.  The reference has no
// vector encoder at all (README.md:26).
template <bool kW16>
__attribute__((target("avx2,avx512f,avx512bw,avx512vbmi,avx512vl,avx512cd")))
void blk32_encode_chunk_avx512_t(const EncTable *t, const uint8_t *chunk, uint64_t groups,
                                 uint32_t *states, uint32_t *scratch32, uint32_t *cnt_out) {
  constexpr uint32_t N32 = 32;
  constexpr Perm<N32> perm;
  alignas(64) uint8_t pvec[64] = {};
  for (uint32_t j = 0; j < N32; j++) pvec[j] = perm.p[j];
  const __m512i perm_idx = _mm512_loadu_si512(pvec);
  const __m512i lo16z = _mm512_set1_epi32(0xFFFF);
  const uint32_t bits = t->bits;
  const __m512i ep = _mm512_set1_epi32(
      kW16 ? (int)((kConsumePoint >> bits) << 16) : (int)(((1u << 23) >> bits) << 8));
  const __m512i ktot = _mm512_set1_epi32(1 << bits);
  const __m512i one = _mm512_set1_epi32(1);
  const __m512i vmask = _mm512_set1_epi32(kW16 ? 0xFFFF : 0xFF);
  constexpr uint32_t wshift = kW16 ? 16 : 8;
  constexpr int rounds = kW16 ? 1 : 2;
  const int *fc_tab = (const int *)t->fc;
  const int *mg_tab = (const int *)t->magic;

  __m512i st[2], cnt[2], lid[2];
  alignas(64) int ids[16] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15};
  lid[0] = _mm512_load_si512(ids);
  lid[1] = _mm512_add_epi32(lid[0], _mm512_set1_epi32(16));
  for (int v = 0; v < 2; v++) {
    st[v] = _mm512_loadu_si512(states + 16 * v);
    cnt[v] = _mm512_setzero_si512();
  }

  for (uint64_t g = groups; g-- > 0;) {
    const __m512i grp = _mm512_permutexvar_epi8(
        perm_idx, _mm512_castsi256_si512(_mm256_loadu_si256((const __m256i *)(chunk + g * N32))));
    __m512i sym[2], fc[2], mg[2];
    for (int v = 0; v < 2; v++)
      sym[v] = _mm512_cvtepu8_epi32(_mm512_extracti32x4_epi32(grp, v));
    for (int v = 0; v < 2; v++) fc[v] = _mm512_i32gather_epi32(sym[v], fc_tab, 4);
    for (int v = 0; v < 2; v++) mg[v] = _mm512_i32gather_epi32(sym[v], mg_tab, 4);

    for (int v = 1; v >= 0; v--) {  // lanes descending like the scalar path
      const __m512i freq = _mm512_and_si512(fc[v], lo16z);
      const __m512i cum = _mm512_srli_epi32(fc[v], 16);
      __m512i s = st[v];
      for (int e = 0; e < rounds; e++) {
        const __mmask16 k =
            _mm512_cmpge_epu32_mask(s, _mm512_mullo_epi32(ep, freq));
        const __m512i idx = _mm512_add_epi32(
            _mm512_slli_epi32(cnt[v], 5), lid[v]);
        _mm512_mask_i32scatter_epi32(scratch32, k, idx, _mm512_and_si512(s, vmask), 4);
        s = _mm512_mask_srli_epi32(s, k, s, wshift);
        cnt[v] = _mm512_mask_add_epi32(cnt[v], k, cnt[v], one);
      }
      // q = ((magic * s) >> 31) >> shift, shift = 32 - lzcnt(freq-1)
      const __m512i pe = _mm512_mul_epu32(mg[v], s);
      const __m512i po = _mm512_mul_epu32(_mm512_srli_epi64(mg[v], 32),
                                          _mm512_srli_epi64(s, 32));
      const __m512i q31 = _mm512_mask_blend_epi32(
          0xAAAA, _mm512_srli_epi64(pe, 31),
          _mm512_slli_epi64(_mm512_srli_epi64(po, 31), 32));
      const __m512i shift = _mm512_sub_epi32(
          _mm512_set1_epi32(32),
          _mm512_lzcnt_epi32(_mm512_sub_epi32(_mm512_max_epu32(freq, one), one)));
      const __m512i q = _mm512_srlv_epi32(q31, shift);
      st[v] = _mm512_add_epi32(
          _mm512_add_epi32(_mm512_mullo_epi32(q, _mm512_sub_epi32(ktot, freq)), cum), s);
    }
  }
  for (int v = 0; v < 2; v++) {
    _mm512_storeu_si512(states + 16 * v, st[v]);
    _mm512_storeu_si512(cnt_out + 16 * v, cnt[v]);
  }
}

void blk32_encode_chunk_avx512(const EncTable *t, const uint8_t *chunk, uint64_t groups,
                               uint32_t *states, uint32_t *scratch32, uint32_t *cnt_out,
                               uint32_t word_bits) {
  if (word_bits == 16)
    blk32_encode_chunk_avx512_t<true>(t, chunk, groups, states, scratch32, cnt_out);
  else
    blk32_encode_chunk_avx512_t<false>(t, chunk, groups, states, scratch32, cnt_out);
}

bool avx512_ok() {
  static const bool ok = __builtin_cpu_supports("avx512f") && __builtin_cpu_supports("avx512bw") &&
                         __builtin_cpu_supports("avx512vbmi") && __builtin_cpu_supports("avx512vl");
  return ok;
}

// 32blk: 32 states with PRIVATE streams (no cross-lane renorm coupling,
// rans32x32_32blk_16w.cpp:222-231) — the easy vector case: the renorm is
// one gather by per-lane cursor instead of an expand from a shared head.
// The reference ships AVX2 variants; this is the AVX-512 dual with the
// packed table at B<=12 and, at B=13/14, a slot-indexed fc copy so the
// two table gathers issue in PARALLEL (the reference's "sym idp gthr"
// layouts, rans32x32_32blk_16w.cpp dispatch; fcslot is 2^B*4 bytes, which
// stops paying at B=15 where it blows past L2 — B15 keeps the dependent
// sym->fc chain, same switch the reference makes to its "sym dep" path).
template <bool kPacked, bool kW16, bool kSlotFc = false>
__attribute__((target("avx2,avx512f,avx512bw,avx512vbmi,avx512vl")))
void blk32_decode_avx512_t(const DecTable *t, const uint16_t *lanes_buf,
                           const uint8_t *lanes_buf8, const uint32_t *lane_off32,
                           uint32_t *r_io, uint32_t *states, uint8_t *out,
                           uint64_t full_groups) {
  // Four independent 8-lane (ymm) chains: the per-group critical path is
  // state -> slot -> table gather -> renorm -> state, and ymm vpgatherdd
  // has roughly half the latency of the 16-lane form, which dominates
  // that chain.  The idx2idx(32) interleave order was chosen by the
  // reference so that packus(packus(s0,s1),packus(s2,s3)) lands bytes in
  // wire order directly (rANS32x32_16w.cpp:1182) — no final permute.
  // Compile-time table layout / word width: a runtime branch per gather
  // measured 2.5x slower than this specialization.
  constexpr uint32_t N32 = 32;
  const __m256i slot_mask = _mm256_set1_epi32((1 << t->bits) - 1);
  const __m256i cmask = _mm256_set1_epi32((int)t->cum_mask);
  const __m128i fshift = _mm_cvtsi32_si128((int)t->freq_shift);
  const __m256i lo16 = _mm256_set1_epi32(0xFFFF);
  const __m256i lo8 = _mm256_set1_epi32(0xFF);
  const __m256i one = _mm256_set1_epi32(1);
  const int *pk = kPacked ? (const int *)t->pack.data() : nullptr;
  const int *sym_tab = kPacked ? nullptr : (const int *)t->sym.data();
  const int *fc_tab = kPacked ? nullptr : (const int *)t->fcsym;
  const int *fcs = kSlotFc ? (const int *)t->fcslot.data() : nullptr;
  const uint32_t bits = t->bits;
  const __m256i consume_lim = _mm256_set1_epi32(kW16 ? (int)kConsumePoint : (1 << 23));
  const __m256i wmask = kW16 ? lo16 : lo8;
  constexpr uint32_t wshift = kW16 ? 16 : 8;
  constexpr int max_consumes = kW16 ? 1 : 2;

  __m256i st[4], rr[4], off[4];
  for (int v = 0; v < 4; v++) {
    st[v] = _mm256_loadu_si256((const __m256i *)(states + 8 * v));
    rr[v] = _mm256_loadu_si256((const __m256i *)(r_io + 8 * v));
    off[v] = _mm256_loadu_si256((const __m256i *)(lane_off32 + 8 * v));
  }

  // Two groups per iteration share ONE u32 word fetch per lane (the
  // reference's varC2 idiom, rans32x32_32blk_16w.cpp:1962+): 16w scale-2
  // returns the next TWO words; 8w reads four bytes from the tight byte
  // mirror — the exact double-consume budget of two steps.
  for (uint64_t g = 0; g < full_groups; g += 2) {
    const int subs = (g + 2 <= full_groups) ? 2 : 1;
    __m256i wrd[4];
    for (int v = 0; v < 4; v++) {
      const __m256i idx = _mm256_add_epi32(off[v], rr[v]);
      wrd[v] = kW16 ? _mm256_i32gather_epi32((const int *)lanes_buf, idx, 2)
                    : _mm256_i32gather_epi32((const int *)lanes_buf8, idx, 1);
    }
    for (int sub = 0; sub < subs; sub++) {
      __m256i slot[4], pck[4], symv[4];
      for (int v = 0; v < 4; v++) slot[v] = _mm256_and_si256(st[v], slot_mask);
      if (kPacked) {
        for (int v = 0; v < 4; v++) pck[v] = _mm256_i32gather_epi32(pk, slot[v], 4);
      } else if (kSlotFc) {
        // both gathers index by slot -> no sym->fc dependency; all eight
        // issue as soon as the slots resolve
        for (int v = 0; v < 4; v++) pck[v] = _mm256_i32gather_epi32(fcs, slot[v], 4);
        for (int v = 0; v < 4; v++)
          symv[v] = _mm256_and_si256(_mm256_i32gather_epi32(sym_tab, slot[v], 1), lo8);
      } else {
        for (int v = 0; v < 4; v++)
          symv[v] = _mm256_and_si256(_mm256_i32gather_epi32(sym_tab, slot[v], 1), lo8);
        for (int v = 0; v < 4; v++) pck[v] = _mm256_i32gather_epi32(fc_tab, symv[v], 4);
      }
      __m256i symq[4];
      for (int v = 0; v < 4; v++) {
        const __m256i sym = kPacked ? _mm256_and_si256(pck[v], lo8) : symv[v];
        const __m256i cum = kPacked ? _mm256_and_si256(_mm256_srli_epi32(pck[v], 8), cmask)
                                    : _mm256_srli_epi32(pck[v], 16);
        const __m256i freq = kPacked ? _mm256_add_epi32(_mm256_srl_epi32(pck[v], fshift), one)
                                     : _mm256_and_si256(pck[v], lo16);
        __m256i s = _mm256_add_epi32(
            _mm256_sub_epi32(slot[v], cum),
            _mm256_mullo_epi32(_mm256_srli_epi32(st[v], bits), freq));
        for (int e = 0; e < max_consumes; e++) {
          const __mmask8 k = _mm256_cmplt_epu32_mask(s, consume_lim);
          s = _mm256_mask_mov_epi32(
              s, k,
              _mm256_or_si256(_mm256_slli_epi32(s, wshift),
                              _mm256_and_si256(wrd[v], wmask)));
          wrd[v] = _mm256_mask_srli_epi32(wrd[v], k, wrd[v], wshift);
          rr[v] = _mm256_mask_add_epi32(rr[v], k, rr[v], one);
        }
        st[v] = s;
        symq[v] = sym;
      }
      const __m256i p01 = _mm256_packus_epi32(symq[0], symq[1]);
      const __m256i p23 = _mm256_packus_epi32(symq[2], symq[3]);
      const __m256i wire = _mm256_packus_epi16(p01, p23);
      _mm256_storeu_si256((__m256i *)(out + (g + sub) * N32), wire);
    }
  }
  for (int v = 0; v < 4; v++) {
    _mm256_storeu_si256((__m256i *)(states + 8 * v), st[v]);
    _mm256_storeu_si256((__m256i *)(r_io + 8 * v), rr[v]);
  }
}

void blk32_decode_avx512(const DecTable *t, const uint16_t *lanes_buf,
                         const uint8_t *lanes_buf8, const uint32_t *lane_off32,
                         uint32_t *r_io, uint32_t *states, uint8_t *out,
                         uint64_t full_groups, uint32_t word_bits) {
  if (t->packed) {
    if (word_bits == 16)
      blk32_decode_avx512_t<true, true>(t, lanes_buf, lanes_buf8, lane_off32, r_io, states, out, full_groups);
    else
      blk32_decode_avx512_t<true, false>(t, lanes_buf, lanes_buf8, lane_off32, r_io, states, out, full_groups);
  } else if (!t->fcslot.empty()) {
    if (word_bits == 16)
      blk32_decode_avx512_t<false, true, true>(t, lanes_buf, lanes_buf8, lane_off32, r_io, states, out, full_groups);
    else
      blk32_decode_avx512_t<false, false, true>(t, lanes_buf, lanes_buf8, lane_off32, r_io, states, out, full_groups);
  } else {
    if (word_bits == 16)
      blk32_decode_avx512_t<false, true>(t, lanes_buf, lanes_buf8, lane_off32, r_io, states, out, full_groups);
    else
      blk32_decode_avx512_t<false, false>(t, lanes_buf, lanes_buf8, lane_off32, r_io, states, out, full_groups);
  }
}

}  // namespace
#endif  // __x86_64__

// --- AVX-512 encode fast path ------------------------------------------------
//
// The reference ships no vector encoder at all ("All encoders are currently
// scalar", README.md:26).  The encode step vectorizes the same way the
// decode does, with the dual primitives:
//   * vpcompressd  — emission compaction: the k lanes whose state crossed
//     the emit threshold write their low 16 bits, packed in lane order
//     (a masked store keeps the backward stream write exact);
//   * paired vpmuludq — the Granlund-Montgomery reciprocal division
//     ((magic*s)>>31)>>shift without integer division;
//   * vplzcntd     — the per-symbol shift recomputed as 32-lzcnt(freq-1),
//     saving a third gather (tables: fc = freq|cumul<<16, magic).

#if defined(__x86_64__)
namespace {

template <uint32_t N>
__attribute__((target("avx512f,avx512bw,avx512vbmi,avx512vl,avx512cd")))
uint16_t *encode_groups_avx512(Coder *co, const uint8_t *data, uint64_t start,
                               uint64_t num_groups, const EncTable *t, uint16_t *pw) {
  constexpr int NV = N / 16;
  constexpr Perm<N> perm;
  alignas(64) uint8_t pvec[64] = {};
  for (uint32_t j = 0; j < N; j++) pvec[j] = perm.p[j];
  const __m512i perm_idx = _mm512_loadu_si512(pvec);
  const __m512i lo16 = _mm512_set1_epi32(0xFFFF);
  const __m512i ep = _mm512_set1_epi32((int)((kConsumePoint >> t->bits) << 16));
  const __m512i ktot = _mm512_set1_epi32(1 << t->bits);
  const __m512i one = _mm512_set1_epi32(1);
  const int *fc_tab = (const int *)t->fc;
  const int *mg_tab = (const int *)t->magic;

  __m512i st[NV];
  for (int v = 0; v < NV; v++) st[v] = _mm512_loadu_si512(co->states + 16 * v);

  for (uint64_t g = num_groups; g-- > 0;) {
    // 64 input bytes -> lane order (one byte-permute), then 16-byte quarters
    __m512i grp;
    if (N == 64) grp = _mm512_loadu_si512(data + start + g * N);
    else if (N == 32) grp = _mm512_castsi256_si512(_mm256_loadu_si256((const __m256i *)(data + start + g * N)));
    else grp = _mm512_castsi128_si512(_mm_loadu_si128((const __m128i *)(data + start + g * N)));
    grp = _mm512_permutexvar_epi8(perm_idx, grp);

    __m512i sym[NV], fc[NV], mg[NV];
    for (int v = 0; v < NV; v++)
      sym[v] = _mm512_cvtepu8_epi32(_mm512_extracti32x4_epi32(grp, v));
    for (int v = 0; v < NV; v++) fc[v] = _mm512_i32gather_epi32(sym[v], fc_tab, 4);
    for (int v = 0; v < NV; v++) mg[v] = _mm512_i32gather_epi32(sym[v], mg_tab, 4);

    for (int v = NV - 1; v >= 0; v--) {  // lanes descending; stream backward
      const __m512i freq = _mm512_and_si512(fc[v], lo16);
      const __m512i cum = _mm512_srli_epi32(fc[v], 16);
      const __mmask16 k =
          _mm512_cmpge_epu32_mask(st[v], _mm512_mullo_epi32(ep, freq));
      const unsigned kc = _mm_popcnt_u32((uint32_t)k);
      const __m256i words =
          _mm512_cvtepi32_epi16(_mm512_maskz_compress_epi32(k, st[v]));
      pw -= kc;
      _mm256_mask_storeu_epi16(pw, (__mmask16)((1u << kc) - 1), words);
      __m512i s = _mm512_mask_srli_epi32(st[v], k, st[v], 16);

      // q = ((magic * s) >> 31) >> shift, shift = 32 - lzcnt(freq-1)
      const __m512i pe = _mm512_mul_epu32(mg[v], s);
      const __m512i po = _mm512_mul_epu32(_mm512_srli_epi64(mg[v], 32),
                                          _mm512_srli_epi64(s, 32));
      const __m512i q31 = _mm512_mask_blend_epi32(
          0xAAAA, _mm512_srli_epi64(pe, 31),
          _mm512_slli_epi64(_mm512_srli_epi64(po, 31), 32));
      const __m512i shift = _mm512_sub_epi32(
          _mm512_set1_epi32(32),
          _mm512_lzcnt_epi32(_mm512_sub_epi32(_mm512_max_epu32(freq, one), one)));
      const __m512i q = _mm512_srlv_epi32(q31, shift);
      // s' = q*(2^B - freq) + cumul + s
      st[v] = _mm512_add_epi32(
          _mm512_add_epi32(_mm512_mullo_epi32(q, _mm512_sub_epi32(ktot, freq)), cum), s);
    }
  }
  for (int v = 0; v < NV; v++) _mm512_storeu_si512(co->states + 16 * v, st[v]);
  return pw;
}

bool avx512cd_ok() {
  static const bool ok = avx512_ok() && __builtin_cpu_supports("avx512cd");
  return ok;
}

}  // namespace
#endif  // __x86_64__
