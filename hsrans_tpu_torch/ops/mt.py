"""mt_rANS32xN 16w — the C++ reference's self-contained block wire, on the host.

The port's copy of the host tier of `hsrans_tpu/ops/mt.py` (the wire format
is documented there): `block_index`, the O(blocks) walk of the header chain
that the decoder starts from, `mt_encode_py`, the numpy encoder that is the
wire authority, `mt_decode_py`, its sequential decoder, and `mt_encode` and
`mt_decode` on the native C++ codec of `runtime/native.py` (the decode also
the host step of `parallel/sharded.py::mt_decode_device`).  The port loads no module of the JAX package;
`tests/test_torch_mt_decode.py` holds each function here equal to its
original.

Wire format:  u64 rawLength | u64 compressedLength | per block:
  single-symbol:  u64 (size | 1<<63 | sym<<54)
  coded:          u64 blockSize | u64 writeHeadOffset | N*u32 states |
                  256*u16 freq | u16 words...
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..models.histogram import complete_hist
from ..rans import DECODE_CONSUME_POINT_16, IDX2IDX, INV_IDX2IDX
from ..runtime import native
from .block import native_takes
from .planner import BlockPlan, plan_blocks_py
from .reference import _as_array, decode_full_groups, decode_tail_group, encode_groups

_U32 = np.uint32
_SINGLE_BIT = 1 << 63
_SYM_SHIFT = 54
_SIZE_MASK = (1 << 54) - 1


def mt_capacity(input_size: int, n: int) -> int:
    """Worst-case blob size (mt_rANS32x64_16w_encode.cpp:50-57)."""
    base = 16 + 512 + input_size + n * 4
    block_count = (input_size + (1 << 15)) // (1 << 15) + 1
    return base + block_count * (16 + 512 + n * 4)


def _lane_groups(arr, start, end, length, n):
    perm = IDX2IDX[n]
    total = -(-(end - start) // n)
    padded = np.zeros(max(total * n, 1), dtype=np.uint8)
    padded[: min(end, length) - start] = arr[start : min(end, length)]
    pos = np.arange(total, dtype=np.int64)[:, None] * n + perm[None, :]
    return padded[pos], (start + pos) < length


def mt_encode(data: bytes | np.ndarray, bits: int, n: int, plan: list[BlockPlan] | None = None) -> bytes:
    """mt encode on the native codec (its own planner, the same bytes), or
    the numpy encoder with a given `plan` or where the native one takes no
    such call (`ops/block.py::native_takes`), as the original."""
    arr = _as_array(data)
    if plan is None and native_takes(arr.size, bits, n):
        out = native.mt_encode(arr, bits, n)
        if out is None:
            raise RuntimeError("native mt encode refused a call it takes")
        return out
    return mt_encode_py(arr, bits, n, plan)


def mt_encode_py(data: bytes | np.ndarray, bits: int, n: int, plan: list[BlockPlan] | None = None) -> bytes:
    """numpy mt encode (the wire authority): blocks encoded last to first
    with carried states; each coded block stores the states its decoder
    starts from."""
    arr = _as_array(data)
    length = arr.size
    if plan is None:
        plan = plan_blocks_py(arr, bits, "mt", n)

    states = np.full(n, DECODE_CONSUME_POINT_16, dtype=_U32)
    parts: list[bytes] = [b""] * len(plan)

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
        w_count = int(emits.sum())
        # words from the states field (+1) to the next block's size field;
        # the last input block's offset points at the stream end slot instead
        # (pEnd), one word less (mt_rANS32x64_16w_encode.cpp:280-283).
        offset = 2 * n + 256 + w_count - (2 if k == len(plan) - 1 else 1)
        parts[k] = (
            int(row.size).to_bytes(8, "little")
            + int(offset).to_bytes(8, "little")
            + states.astype("<u4").tobytes()
            + row.freq.astype("<u2").tobytes()
            + words[emits].astype("<u2").tobytes()
        )

    out = bytearray()
    out += int(length).to_bytes(8, "little")
    out += b"\0" * 8
    for p in parts:
        out += p
    out[8:16] = len(out).to_bytes(8, "little")
    return bytes(out)


@dataclass
class MtBlock:
    """One entry of the O(1)-seek block index."""

    out_start: int  # first output byte
    size: int  # output bytes
    is_single: bool
    symbol: int
    states: np.ndarray | None  # u32[n]
    freq: np.ndarray | None  # u16[256] (shorter where the stream ran out)
    word_start: int  # index into the u16 stream where this block's words begin
    is_last: bool


def block_index(blob: bytes | np.ndarray, n: int) -> tuple[int, np.ndarray, list[MtBlock]] | None:
    """Walk the header chain once; returns (rawLength, u16 stream, blocks).
    The stream is the blob's word region plus 2n + 4 zero words."""
    buf = _as_array(blob)
    if buf.size < 16:
        return None
    length = int.from_bytes(buf[0:8].tobytes(), "little")
    expected_in = int.from_bytes(buf[8:16].tobytes(), "little")
    if buf.size < expected_in:
        return None
    word_region = buf[16:]
    nwords = word_region.size // 2
    stream = np.zeros(nwords + 2 * n + 4, dtype=np.uint16)
    stream[:nwords] = word_region[: nwords * 2].view("<u2")

    blocks: list[MtBlock] = []
    i = 0
    r = 0
    out_len_states = max(length - n + 1, 0)
    while i < length:
        if r + 4 > nwords:
            return None
        val = int.from_bytes(stream[r : r + 4].tobytes(), "little")
        r += 4
        if val & _SINGLE_BIT:
            size = val & _SIZE_MASK
            blocks.append(MtBlock(i, size, True, (val >> _SYM_SHIFT) & 0xFF, None, None, r, False))
            i += size
        else:
            offset = int.from_bytes(stream[r : r + 4].tobytes(), "little")
            r += 4
            states_pos = r
            states = np.frombuffer(stream[r : r + 2 * n].tobytes(), dtype="<u4").astype(_U32)
            r += 2 * n
            freq = stream[r : r + 256].copy()
            r += 256
            is_last = i + val > out_len_states
            blocks.append(MtBlock(i, min(val, length - i), False, 0, states, freq, r, is_last))
            i += val
            if not is_last:
                r = states_pos + offset + 1
        if i >= length:
            break
        if blocks[-1].is_last:
            break
    return length, stream, blocks


def mt_decode(blob: bytes | np.ndarray, bits: int, n: int) -> bytes | None:
    """mt decode on the native codec (the blocks fanned out to its thread
    pool) at n = 32 and 64, the numpy decoder at any other n (the native one
    refuses it, and its -1 must not read as a malformed blob); None on
    malformed input."""
    if n in (32, 64):
        return native.mt_decode(blob, bits, n)
    return mt_decode_py(blob, bits, n)


def mt_decode_py(blob: bytes | np.ndarray, bits: int, n: int) -> bytes | None:
    """Sequential (single-stream) numpy decode, the correctness oracle: the
    blocks in order, each from its state snapshot, the trailing partial
    lane group from the last coded block's chain; None where the header
    chain breaks, a block's freqs do not sum to 2^B, or a partial group
    follows a single-symbol block."""
    idx = block_index(blob, n)
    if idx is None:
        return None
    length, stream, blocks = idx
    if length == 0:
        return b""
    out = np.zeros(length, dtype=np.uint8)
    inv_perm = INV_IDX2IDX[n]
    out_len_states = max(length - n + 1, 0)

    last_states = last_hist = last_r = None
    i = 0
    for blk in blocks:
        i = blk.out_start
        if blk.is_single:
            out[i : i + blk.size] = blk.symbol
            i += blk.size
            continue
        hist = complete_hist(blk.freq, bits)
        if hist is None:
            return None
        block_end = min(blk.out_start + blk.size, out_len_states)
        num_groups = max(0, -(-(block_end - i) // n))
        syms, states, r = decode_full_groups(blk.states.copy(), stream, blk.word_start, hist, n, num_groups)
        out[i : i + num_groups * n] = syms[:, inv_perm].reshape(-1)
        i += num_groups * n
        last_states, last_hist, last_r = states, hist, r

    if i < length:
        if last_hist is None:
            return None  # a trailing partial group after a single-symbol block
        tail, _, _ = decode_tail_group(last_states, stream, last_r, last_hist, n, i, length)
        perm = IDX2IDX[n]
        sel = (i + perm) < length
        out[i + perm[sel]] = tail[np.arange(n)[sel]]
    return out.tobytes()
