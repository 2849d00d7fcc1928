/* The raw 16w wire's state chain: n interleaved 32-bit rANS states over
   the input's groups of n bytes, 16-bit renormalisation words.  Scalar C
   for the benchmark's frozen reference (gpubench/reference/raw.py builds it
   with the system's cc and calls it through ctypes); it shares no code
   with the program under test.

   Lane j codes byte g * n + lane[j] of group g; a byte at or past `length`
   leaves its lane untouched.  The encoder runs the groups last to first
   and each group's lanes last to first, so that it can write the words
   backward from the end of `words` and leave them in the wire's forward
   order (group ascending, lane ascending); the decoder reads them forward
   in that order. */

#include <stdint.h>

/* Encode `length` bytes of `data` with the table freq/cumul at 2^bits, the
   states (n of them, in and out) carried from their given values; the
   emitted words end at words[cap].  Returns how many were written, or -1
   where `cap` is too small. */
int64_t raw16w_encode(const uint8_t *data, int64_t length, int32_t n, const int32_t *lane,
                      const uint32_t *freq, const uint32_t *cumul, int32_t bits, uint32_t *states,
                      uint16_t *words, int64_t cap)
{
    const uint32_t emit_point = ((UINT32_C(1) << 15) >> bits) << 16; /* 2^(31 - bits) */
    const int64_t groups = (length + n - 1) / n;
    int64_t at = cap;
    for (int64_t g = groups - 1; g >= 0; --g) {
        for (int32_t j = n - 1; j >= 0; --j) {
            const int64_t pos = g * n + lane[j];
            if (pos >= length)
                continue;
            const uint8_t sym = data[pos];
            const uint32_t f = freq[sym] ? freq[sym] : 1;
            uint32_t x = states[j];
            if (x >= emit_point * f) {
                if (at == 0)
                    return -1;
                words[--at] = (uint16_t)(x & 0xFFFF);
                x >>= 16;
            }
            states[j] = ((x / f) << bits) + cumul[sym] + x % f;
        }
    }
    return cap - at;
}

/* Decode `length` bytes into `out` from the states (n of them, in and out)
   and the `n_words` words, slot_sym mapping each of the 2^bits slots to its
   symbol; a word past the last reads as 0.  Returns the words read. */
int64_t raw16w_decode(const uint16_t *words, int64_t n_words, int64_t length, int32_t n, const int32_t *lane,
                      const uint8_t *slot_sym, const uint32_t *freq, const uint32_t *cumul, int32_t bits,
                      uint32_t *states, uint8_t *out)
{
    const uint32_t mask = (UINT32_C(1) << bits) - 1;
    const int64_t groups = (length + n - 1) / n;
    int64_t r = 0;
    for (int64_t g = 0; g < groups; ++g) {
        for (int32_t j = 0; j < n; ++j) {
            const int64_t pos = g * n + lane[j];
            if (pos >= length)
                continue;
            uint32_t x = states[j];
            const uint32_t slot = x & mask;
            const uint8_t sym = slot_sym[slot];
            x = (x >> bits) * freq[sym] + slot - cumul[sym];
            if (x < (UINT32_C(1) << 15)) {
                x = (x << 16) | (r < n_words ? words[r] : 0);
                ++r;
            }
            states[j] = x;
            out[pos] = sym;
        }
    }
    return r;
}
