"""Host-side (numpy) scalar-semantics oracle of the 16-bit-word rANS codec:
the lane-group encode and decode steps that the mt wire chains per block.

The port's copy of the pieces of `hsrans_tpu/ops/reference.py` that the mt
codec runs (`encode_groups` for the host encoder, `decode_full_groups` and
`decode_tail_group` for the reference decode and the trailing partial lane
group) and of its raw 16w wire (`raw_encode_16w`, `raw_decode_16w`, the numpy
authority; `raw_encode`, `raw_decode` on the native C++ codec of
`runtime/native.py`), so that the port loads no module of the JAX package;
`tests/test_torch_mt_decode.py`, `tests/test_torch_raw_scan.py` and
`tests/test_torch_host_codecs.py` hold each equal to its original, the raw
wire also to the C++ reference's golden blobs.

Raw wire format: u64 rawLength | u64 compressedLength | 256*u16 freq |
N*u32 states | u16 word stream (rANS32x32_16w.cpp:130-158).

Decode processes groups of n lanes forward, lane j of a group coding the
byte at offset IDX2IDX[n][j]; a lane whose state drops below 2^15 shifts in
one u16 word, the group's words taken in lane-ascending order (the
exclusive prefix sum of the consume mask).  Encode runs the groups in
reverse with carried states, so the forward stream is its emission order
reversed.
"""

from __future__ import annotations

import numpy as np

from ..models.histogram import Hist, complete_hist, make_cumul_inv, make_hist
from ..rans import DECODE_CONSUME_POINT_16, IDX2IDX, INV_IDX2IDX, encode_emit_point_16
from ..runtime import native

_U32 = np.uint32
_HDR_FIXED = 16 + 512  # two u64 + 256 u16 freqs


def _as_array(data: bytes | np.ndarray) -> np.ndarray:
    if isinstance(data, (bytes, bytearray, memoryview)):
        return np.frombuffer(data, dtype=np.uint8)
    return np.asarray(data, dtype=np.uint8)


def raw_capacity(input_size: int, n_lanes: int) -> int:
    """Worst-case compressed size (rANS32x32_16w.cpp:10-13)."""
    return input_size + n_lanes + 512 + 4 * n_lanes + 16


def _group_layout(length: int, n: int) -> tuple[int, int]:
    """(full groups, total groups with the possibly partial one): the
    reference's decode main loop runs while i < length - n + 1, the tail
    group (lanes masked by i + idx2idx[j] < length) takes the rest."""
    if length <= 0:
        return 0, 0
    total = -(-length // n)
    out_len_in_states = length - n + 1
    full = 0 if out_len_in_states <= 0 else -(-out_len_in_states // n)
    return full, total


def _gather_group_bytes(data: np.ndarray, length: int, n: int) -> tuple[np.ndarray, np.ndarray]:
    """[G, n] byte matrix in lane order and the validity mask of the tail."""
    perm = IDX2IDX[n]
    _, total = _group_layout(length, n)
    padded = np.zeros(total * n, dtype=np.uint8)
    padded[:length] = data
    pos = (np.arange(total, dtype=np.int64)[:, None] * n) + perm[None, :]
    return padded[pos % max(total * n, 1)], pos < length


def encode_groups(
    states: np.ndarray,
    groups: np.ndarray,  # u8[G, n] in lane order
    valid: np.ndarray,  # bool[G, n]
    hist: Hist,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Encode groups in reverse order (rANS is LIFO) with carried states.

    Returns (words u16[G, n], emit mask bool[G, n], states); the forward
    wire stream of the section is words[emits] flattened (group ascending,
    lane ascending)."""
    bits = hist.total_symbol_count_bits
    emit_point = _U32(encode_emit_point_16(bits))
    freq_tab = hist.symbol_count.astype(_U32)
    cumul_tab = hist.cumul.astype(_U32)
    total_groups = groups.shape[0]
    n = groups.shape[1]
    words = np.zeros((total_groups, n), dtype=np.uint16)
    emits = np.zeros((total_groups, n), dtype=bool)

    for g in range(total_groups - 1, -1, -1):
        v = valid[g]
        b = groups[g]
        freq = freq_tab[b]
        max_state = emit_point * freq
        emit = (states >= max_state) & v
        words[g] = np.where(emit, (states & _U32(0xFFFF)).astype(np.uint16), 0)
        states = np.where(emit, states >> _U32(16), states)
        new_states = ((states // np.maximum(freq, 1)) << _U32(bits)) + cumul_tab[b] + (states % np.maximum(freq, 1))
        states = np.where(v, new_states, states)
        emits[g] = emit
    return words, emits, states


def decode_full_groups(
    states: np.ndarray,
    stream: np.ndarray,
    read_pos: int,
    hist: Hist,
    n: int,
    num_groups: int,
) -> tuple[np.ndarray, np.ndarray, int]:
    """Decode `num_groups` full lane groups with carried states; returns
    (symbols [num_groups, n] in lane order, states, read_pos)."""
    bits = hist.total_symbol_count_bits
    mask_slot = _U32((1 << bits) - 1)
    inv_tab = make_cumul_inv(hist)
    freq_of = hist.symbol_count.astype(_U32)
    cumul_of = hist.cumul.astype(_U32)
    syms = np.zeros((num_groups, n), dtype=np.uint8)
    r = read_pos
    for g in range(num_groups):
        slot = states & mask_slot
        sym = inv_tab[slot]
        syms[g] = sym
        s64 = sym.astype(np.int64)
        states = (states >> _U32(bits)) * freq_of[s64] + slot - cumul_of[s64]
        consume = states < _U32(DECODE_CONSUME_POINT_16)
        offs = np.cumsum(consume) - consume
        w = stream[r + offs].astype(_U32)
        states = np.where(consume, (states << _U32(16)) | w, states)
        r += int(consume.sum())
    return syms, states, r


def decode_tail_group(
    states: np.ndarray,
    stream: np.ndarray,
    read_pos: int,
    hist: Hist,
    n: int,
    start: int,
    length: int,
) -> tuple[np.ndarray, np.ndarray, int]:
    """Decode the final partial group: lane j takes part (and consumes)
    only if start + idx2idx[j] < length."""
    bits = hist.total_symbol_count_bits
    mask_slot = _U32((1 << bits) - 1)
    inv_tab = make_cumul_inv(hist)
    freq_of = hist.symbol_count.astype(_U32)
    cumul_of = hist.cumul.astype(_U32)
    perm = IDX2IDX[n]
    v = (start + perm) < length
    slot = states & mask_slot
    sym = inv_tab[slot]
    s64 = sym.astype(np.int64)
    new_states = (states >> _U32(bits)) * freq_of[s64] + slot - cumul_of[s64]
    states_t = np.where(v, new_states, states)
    consume = (states_t < _U32(DECODE_CONSUME_POINT_16)) & v
    offs = np.cumsum(consume) - consume
    w = stream[read_pos + offs].astype(_U32)
    states = np.where(consume, (states_t << _U32(16)) | w, states_t)
    return np.where(v, sym, 0), states, read_pos + int(consume.sum())


def raw_encode(data: bytes | np.ndarray, bits: int, n_lanes: int) -> bytes:
    """Raw encode with a whole-input histogram on the native codec; the
    numpy encoder where the native one takes no such call (B outside
    10..15, n outside 16, 32, 64), as the original."""
    arr = _as_array(data)
    if 10 <= bits <= 15 and n_lanes in IDX2IDX:
        out = native.raw_encode(arr, bits, n_lanes)
        if out is None:
            raise RuntimeError("native raw encode refused a call it takes")
        return out
    return raw_encode_16w(arr, make_hist(arr, bits), n_lanes)


def raw_decode(blob: bytes | np.ndarray, bits: int, n_lanes: int) -> bytes | None:
    """Raw decode on the native codec; None on malformed input."""
    return native.raw_decode(blob, bits, n_lanes)


def raw_encode_16w(data: bytes | np.ndarray, hist: Hist, n_lanes: int) -> bytes:
    """Encode one buffer with a static histogram; returns the wire blob."""
    arr = _as_array(data)
    length = arr.size
    n = n_lanes
    states = np.full(n, DECODE_CONSUME_POINT_16, dtype=_U32)
    groups, valid = _gather_group_bytes(arr, length, n)
    words, emits, states = encode_groups(states, groups, valid, hist)
    stream = words[emits]  # forward wire stream: (group ascending, lane ascending)

    out = bytearray()
    out += int(length).to_bytes(8, "little")
    out += b"\0" * 8  # total length patched below
    out += hist.symbol_count.astype("<u2").tobytes()
    out += states.astype("<u4").tobytes()
    out += stream.astype("<u2").tobytes()
    out[8:16] = len(out).to_bytes(8, "little")
    return bytes(out)


def raw_decode_16w(blob: bytes | np.ndarray, total_symbol_count_bits: int, n_lanes: int) -> bytes | None:
    """Decode a raw 16w wire blob; None on malformed input."""
    buf = _as_array(blob)
    n = n_lanes
    bits = total_symbol_count_bits
    if buf.size < _HDR_FIXED + 4 * n:
        return None
    length = int.from_bytes(buf[0:8].tobytes(), "little")
    expected_in = int.from_bytes(buf[8:16].tobytes(), "little")
    if buf.size < expected_in:
        return None
    hist = complete_hist(buf[16 : 16 + 512].view("<u2").astype(np.uint16), bits)
    if hist is None:
        return None
    off = _HDR_FIXED
    states = buf[off : off + 4 * n].view("<u4").astype(_U32)
    off += 4 * n
    stream = np.zeros(((buf.size - off) // 2) + 2 * n, dtype=np.uint16)
    raw_words = buf[off : off + ((buf.size - off) // 2) * 2].view("<u2")
    stream[: raw_words.size] = raw_words
    out, _ = _decode_section_16w(states, stream, 0, length, 0, hist, n)
    return out.tobytes()


def _decode_section_16w(
    states: np.ndarray,
    stream: np.ndarray,
    read_pos: int,
    length: int,
    start: int,
    hist: Hist,
    n: int,
) -> tuple[np.ndarray, tuple[np.ndarray, int]]:
    """Decode symbols [start, length): full groups, then the masked tail.
    Returns (the span's bytes in output order, (states, read pos))."""
    span = length - start
    if span <= 0:
        return np.zeros(0, dtype=np.uint8), (states, read_pos)
    total = -(-span // n)
    out_len_in_states = length - n + 1
    full = 0 if out_len_in_states <= start else -(-(out_len_in_states - start) // n)
    syms, states, r = decode_full_groups(states, stream, read_pos, hist, n, full)
    parts = [syms]
    if total > full:
        tail, states, r = decode_tail_group(states, stream, r, hist, n, start + full * n, length)
        parts.append(tail[None, :])
    out = np.concatenate(parts, axis=0)[:, INV_IDX2IDX[n]].reshape(-1)[:span]
    return out, (states, r)
