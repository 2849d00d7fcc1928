"""block_rANS32xN 16w — the adaptive-histogram block codec.

The port's copy of `hsrans_tpu/ops/block.py`, so that the port loads no
module of the JAX package; `tests/test_torch_host_codecs.py` holds each
function here equal to its original and to the C++ reference's golden
blobs.  The input is split into variable-size blocks by the greedy
backward planner (`ops/planner.py`, block mode); each block carries its own
normalized histogram in-stream, single-symbol blocks become RLE markers,
and the rANS states and word stream flow continuously across blocks: only
the table switches.

Wire format (block_rANS32x64_16w_{encode,decode}.cpp):
  u64 rawLength | u64 compressedLength | N*u32 final states |
  per block, embedded in the u16 word stream:
      u64 blockSize            (bit63 set => single-symbol:
                                size | 1<<63 | sym<<54, no hist, no words)
      256*u16 freq             (only for coded blocks)
      u16 words...             (continuous, consumed by the state machine)

Block starts are N-aligned; the final (possibly partial) lane group belongs
to the last block and takes the usual tail mask.  `block_encode_py` and
`block_decode_py` are the numpy wire authority; `block_encode` and
`block_decode` run the native C++ codec (`runtime/native.py`) at n = 32 and
64, the reference's widths, and the numpy codec at any other n.
"""

from __future__ import annotations

import numpy as np

from ..models.histogram import Hist, complete_hist
from ..rans import DECODE_CONSUME_POINT_16, IDX2IDX, INV_IDX2IDX
from ..runtime import native
from .planner import BlockPlan, plan_blocks_py
from .reference import _as_array, decode_full_groups, decode_tail_group, encode_groups

_U32 = np.uint32
_SINGLE_BIT = 1 << 63
_SYM_SHIFT = 54
_SIZE_MASK = (1 << 54) - 1


def block_capacity(input_size: int, n: int) -> int:
    """Worst-case blob size (block_rANS32x64_16w_encode.cpp:47-54)."""
    base = 16 + 512 + input_size + n * 4
    block_count = (input_size + (1 << 15)) // (1 << 15) + 1
    return base + block_count * (8 + 512)


def _lane_groups(arr: np.ndarray, start: int, end: int, length: int, n: int) -> tuple[np.ndarray, np.ndarray]:
    """Byte matrix [G, n] in lane order covering [start, end) (end == length
    may include the partial tail group)."""
    perm = IDX2IDX[n]
    total = -(-(end - start) // n)
    padded = np.zeros(max(total * n, 1), dtype=np.uint8)
    padded[: min(end, length) - start] = arr[start : min(end, length)]
    pos = np.arange(total, dtype=np.int64)[:, None] * n + perm[None, :]
    return padded[pos], (start + pos) < length


def native_takes(data_len: int, bits: int, n: int) -> bool:
    """Whether the native block and mt encoders take the call: n of 32 or
    64, 10 <= B <= 15, and a non-empty input (they plan no block of an
    empty one, where the numpy encoder writes the bare header)."""
    return n in (32, 64) and 10 <= bits <= 15 and data_len > 0


def block_encode(data: bytes | np.ndarray, bits: int, n: int, plan: list[BlockPlan] | None = None) -> bytes:
    """Encode with adaptive per-block histograms: the native codec, or the
    numpy encoder with a given `plan` or where the native one takes no
    such call (`native_takes`), as the original."""
    arr = _as_array(data)
    if plan is None and native_takes(arr.size, bits, n):
        out = native.block_encode(arr, bits, n)
        if out is None:
            raise RuntimeError("native block encode refused a call it takes")
        return out
    return block_encode_py(arr, bits, n, plan)


def block_encode_py(data: bytes | np.ndarray, bits: int, n: int, plan: list[BlockPlan] | None = None) -> bytes:
    """numpy encoder (the wire authority), on the Python planner."""
    arr = _as_array(data)
    length = arr.size
    if plan is None:
        plan = plan_blocks_py(arr, bits, "block", n)

    states = np.full(n, DECODE_CONSUME_POINT_16, dtype=_U32)
    parts: list[bytes] = [b""] * len(plan)

    # encode blocks backward (rANS is LIFO); assemble parts in forward order
    for k in range(len(plan) - 1, -1, -1):
        row = plan[k]
        if row.is_single:
            indicator = row.size | _SINGLE_BIT | (row.symbol << _SYM_SHIFT)
            parts[k] = indicator.to_bytes(8, "little")
            continue
        hist = complete_hist(row.freq, bits)
        if hist is None:
            raise ValueError(f"plan row {k}: freqs do not sum to 2^{bits}")
        groups, valid = _lane_groups(arr, row.start, row.start + row.size, length, n)
        words, emits, states = encode_groups(states, groups, valid, hist)
        parts[k] = int(row.size).to_bytes(8, "little") + row.freq.astype("<u2").tobytes() + words[emits].astype("<u2").tobytes()

    out = bytearray()
    out += int(length).to_bytes(8, "little")
    out += b"\0" * 8
    out += states.astype("<u4").tobytes()
    for p in parts:
        out += p
    out[8:16] = len(out).to_bytes(8, "little")
    return bytes(out)


def block_decode(blob: bytes | np.ndarray, bits: int, n: int) -> bytes | None:
    """Decode on the native codec at n = 32 and 64, where the numpy decoder
    runs any other n (the native one refuses it, and its -1 must not read as
    a malformed blob); None on malformed input."""
    if n in (32, 64):
        return native.block_decode(blob, bits, n)
    return block_decode_py(blob, bits, n)


def block_decode_py(blob: bytes | np.ndarray, bits: int, n: int) -> bytes | None:
    """numpy decoder (the wire authority); None on malformed input."""
    buf = _as_array(blob)
    # the reference rejects anything under the header and one histogram
    # (block_rANS32x64_16w_decode.cpp:15), which makes its own all-RLE tiny
    # blobs undecodable; only the structural minimum is required here
    if buf.size < 16 + 4 * n + 8:
        return None
    length = int.from_bytes(buf[0:8].tobytes(), "little")
    expected_in = int.from_bytes(buf[8:16].tobytes(), "little")
    if buf.size < expected_in:
        return None
    states = buf[16 : 16 + 4 * n].view("<u4").astype(_U32)
    word_region = buf[16 + 4 * n :]
    nwords = word_region.size // 2
    stream = np.zeros(nwords + 2 * n + 4, dtype=np.uint16)
    stream[:nwords] = word_region[: nwords * 2].view("<u2")

    if length == 0:
        return b""
    out = np.zeros(length, dtype=np.uint8)
    out_len_states = max(length - n + 1, 0)
    inv_perm = INV_IDX2IDX[n]
    i = 0
    r = 0
    hist: Hist | None = None

    while True:
        if r + 4 > nwords:
            return None
        block_size_val = int.from_bytes(stream[r : r + 4].tobytes(), "little")
        r += 4
        if block_size_val & _SINGLE_BIT:
            sym = (block_size_val >> _SYM_SHIFT) & 0xFF
            size = block_size_val & _SIZE_MASK
            if i + size > length:
                return None
            out[i : i + size] = sym
            i += size
        else:
            if r + 256 > nwords:
                return None
            hist = complete_hist(stream[r : r + 256].copy(), bits)
            r += 256
            if hist is None:
                return None
            block_end = i + block_size_val
            if block_end > out_len_states:
                block_end = out_len_states
            elif block_end & (n - 1):
                return None
            num_groups = max(0, -(-(block_end - i) // n))
            syms, states, r = decode_full_groups(states, stream, r, hist, n, num_groups)
            out[i : i + num_groups * n] = syms[:, inv_perm].reshape(-1)
            i += num_groups * n
        if i > out_len_states:
            if i >= length:
                return out.tobytes()
            break
        if i >= out_len_states:
            break

    if i < length:
        if hist is None:
            return None
        tail, states, r = decode_tail_group(states, stream, r, hist, n, i, length)
        k = np.arange(n)
        sel = (i + IDX2IDX[n]) < length
        out[i + IDX2IDX[n][sel]] = tail[k[sel]]
    return out.tobytes()
