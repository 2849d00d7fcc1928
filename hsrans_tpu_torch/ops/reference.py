"""Host-side (numpy) scalar-semantics oracle of the 16-bit-word rANS codec:
the lane-group encode and decode steps that the mt wire chains per block.

The port's copy of the pieces of `hsrans_tpu/ops/reference.py` that the mt
codec runs (`encode_groups` for the host encoder, `decode_full_groups` and
`decode_tail_group` for the reference decode and the trailing partial lane
group), so that the port loads no module of the JAX package;
`tests/test_torch_mt_decode.py` holds each equal to its original.

Decode processes groups of n lanes forward, lane j of a group coding the
byte at offset IDX2IDX[n][j]; a lane whose state drops below 2^15 shifts in
one u16 word, the group's words taken in lane-ascending order (the
exclusive prefix sum of the consume mask).  Encode runs the groups in
reverse with carried states, so the forward stream is its emission order
reversed.
"""

from __future__ import annotations

import numpy as np

from ..models.histogram import Hist, make_cumul_inv
from ..rans import DECODE_CONSUME_POINT_16, IDX2IDX, encode_emit_point_16

_U32 = np.uint32


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
