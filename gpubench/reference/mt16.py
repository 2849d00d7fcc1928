"""The mt wire at 16 states, every block encoded from fresh states, in plain
NumPy: the benchmark's own frozen codec, independent of the code under
test.  The blocks and their freqs are a plan's (`planner.py`).

The upstream ships the mt wire (mt_rANS32x64_16w_encode.cpp:266-298) at 32
and 64 states; this is its block framing at the width of the upstream's
rANS32x16_16w codec (StateCount 16, rANS32x16_16w.cpp:6).

Wire (little-endian): u64 raw length | u64 blob length, then per block:
a single-symbol block is one u64 (size | 1 << 63 | symbol << 54); a coded
block is u64 size | u64 offset | 16 u32 states | 256 u16 freqs | its u16
words.  The offset counts u16 words from the states field + 1 to the next
block's size field (2 n + 256 + words - 1; the last block's one less).

A block codes its bytes in groups of 16, lane j of a group taking byte
LANES[j] of it (rANS32x16_16w.cpp:51: the two 8-byte halves of the group
interleaved in runs of 4).  A lane takes part while its byte lies inside
the block and the input; the others of a block's partial last group keep
their state and emit nothing.  The encoder starts every block from the
states 2^15, runs backward over its groups and, where a lane takes part,
emits its low 16 bits where its state is at or above 2^(31-B) x max(freq,
1); the words go on the wire forward, group by group and lane by lane, and
the states it ends with are the block's snapshot, where its decoder starts.
A coded row of size 0 is a header with no words.
"""

from __future__ import annotations

import numpy as np

from .hist import cumul_of, normalize_rows

N = 16
CONSUME_POINT = 1 << 15
M32 = 0xFFFFFFFF
SINGLE = 1 << 63
HEAD_U16 = 4 + 4 + 2 * N + 256  # size, offset, states, freqs
LANES = np.array([0, 1, 2, 3, 8, 9, 10, 11, 4, 5, 6, 7, 12, 13, 14, 15], np.int64)
LANE_STEPS = 1 << 24  # lanes x groups a batch of blocks encodes side by side


def _encode_blocks(arr: np.ndarray, starts: np.ndarray, sizes: np.ndarray, freqs: np.ndarray,
                   bits: int) -> tuple[np.ndarray, ...]:
    """Blocks side by side, each from fresh states with its own freqs:
    (states [nb, 16], words [nb, groups, 16], emits [nb, groups, 16])."""
    length = arr.size
    nb = len(starts)
    groups = -(-sizes // N)
    ends = np.minimum(starts + sizes, length)[:, None]
    # freq | cumul << 16 of each block's symbols, gathered once a step (u32 arithmetic throughout)
    fc = (freqs.astype(np.int64) | cumul_of(freqs) << 16).astype(np.uint32).reshape(-1)
    row0 = (np.arange(nb) * 256)[:, None]
    emit_point = np.uint32((CONSUME_POINT >> bits) << 16)
    state = np.full((nb, N), CONSUME_POINT, np.uint32)
    words = np.zeros((nb, int(groups.max(initial=0)), N), np.uint16)
    emits = np.zeros(words.shape, bool)
    for g in range(words.shape[1] - 1, -1, -1):
        pos = starts[:, None] + g * N + LANES[None, :]
        v = pos < ends
        e = fc[row0 + arr[np.minimum(pos, length - 1)]]
        f = np.maximum(e & 0xFFFF, 1)
        emit = (state >= emit_point * f) & v
        words[:, g] = state
        emits[:, g] = emit
        x = np.where(emit, state >> 16, state)
        q, r = np.divmod(x, f)
        state = np.where(v, (q << bits) + (e >> 16) + r, state)
    return state, words, emits


def encode(data: bytes | np.ndarray, bits: int, rows: list) -> bytes:
    """The 16-state mt blob of `data` in the blocks `rows` (`planner.Row`s),
    every coded block encoded from fresh states with its row's freqs."""
    arr = np.frombuffer(data, np.uint8) if isinstance(data, (bytes, bytearray, memoryview)) else np.asarray(data, np.uint8)
    parts: list[bytes] = [b""] * len(rows)
    for k, (_, size, symbol, _) in enumerate(rows):
        if symbol is not None:
            parts[k] = np.array([size | SINGLE | symbol << 54], "<u8").tobytes()
    coded = sorted((k for k, r in enumerate(rows) if r[2] is None), key=lambda k: rows[k][1])
    groups = [-(-rows[k][1] // N) for k in coded]
    i = 0
    while i < len(coded):  # blocks of like size together, up to LANE_STEPS lanes x groups at a time
        j = i + 1
        while j < len(coded) and (j + 1 - i) * groups[j] * N <= LANE_STEPS:
            j += 1
        ks = coded[i:j]
        state, words, emits = _encode_blocks(arr, np.array([rows[k][0] for k in ks], np.int64),
                                             np.array([rows[k][1] for k in ks], np.int64),
                                             np.stack([rows[k][3] for k in ks]), bits)
        for m, k in enumerate(ks):
            w = words[m][emits[m]]
            offset = 2 * N + 256 + w.size - (2 if k == len(rows) - 1 else 1)
            parts[k] = (np.array([rows[k][1], offset], "<u8").tobytes() + state[m].astype("<u4").tobytes()
                        + rows[k][3].astype("<u2").tobytes() + w.astype("<u2").tobytes())
        i = j
    blob = bytearray(np.array([arr.size, 0], "<u8").tobytes() + b"".join(parts))
    blob[8:16] = len(blob).to_bytes(8, "little")
    return bytes(blob)


def parse(blob: bytes | np.ndarray) -> tuple[int, np.ndarray, list[tuple]] | None:
    """(raw length, u16 words of the blob past its head, blocks): a block
    is (out_start, size, symbol, None, None, None) if single-symbol, else
    (out_start, size, None, states [16], freqs [256], first word).  None
    where the blob is shorter than its head says or the header chain runs
    past it.  The walk ends at the coded block that holds the input's last
    partial group."""
    buf = np.frombuffer(blob, np.uint8) if isinstance(blob, (bytes, bytearray, memoryview)) else np.asarray(blob, np.uint8)
    if buf.size < 16 or buf.size < int(buf[8:16].view("<u8")[0]):
        return None
    length = int(buf[:8].view("<u8")[0])
    stream = buf[16 : 16 + (buf.size - 16) // 2 * 2].view("<u2")
    blocks, i, r = [], 0, 0
    while i < length:
        if r + 4 > stream.size:
            return None
        val = int(stream[r : r + 4].view("<u8")[0])
        if val & SINGLE:
            size = val & ((1 << 54) - 1)
            blocks.append((i, size, (val >> 54) & 0xFF, None, None, None))
            r += 4
        else:
            head = stream[r : r + HEAD_U16]
            if head.size < HEAD_U16:
                return None
            offset = int(head[4:8].view("<u8")[0])
            size = min(val, length - i)
            blocks.append((i, size, None, head[8 : 8 + 2 * N].view("<u4").astype(np.int64),
                           head[8 + 2 * N :].astype(np.int64), r + HEAD_U16))
            r = r + 8 + offset + 1
            if i + val > max(length - N + 1, 0):
                break
        i += size
    return length, stream, blocks


def decode(blob: bytes | np.ndarray, bits: int = 12, table_bits: int | None = None) -> bytes | None:
    """The raw bytes of a 16-state mt blob at 2^bits; None where the header
    chain breaks or a coded block's freqs do not sum to 2^bits.
    `table_bits` below `bits` decodes with each block's freqs renormalised
    to 2^table_bits and the state arithmetic at that depth: the
    lower-precision decode that the benchmark's control runs in place of
    the program."""
    parsed = parse(blob)
    if parsed is None:
        return None
    length, stream, blocks = parsed
    out = np.zeros(length, np.uint8)
    coded = [blk for blk in blocks if blk[3] is not None]
    for start, size, sym, *_ in blocks:
        if sym is not None:
            out[start : start + size] = sym
    if not coded:
        return out.tobytes()
    freqs = np.stack([blk[4] for blk in coded])
    if (freqs.sum(axis=1) != 1 << bits).any():
        return None
    b = bits if table_bits is None else table_bits
    if b != bits:
        freqs = normalize_rows(freqs, np.full(len(freqs), 1 << bits), b).astype(np.int64)
    f_tab, c_tab = freqs, cumul_of(freqs)
    inv = np.stack([np.repeat(np.arange(256), f) for f in f_tab])
    start = np.array([blk[0] for blk in coded], np.int64)
    end = (start + np.array([blk[1] for blk in coded], np.int64))[:, None]
    groups = -(-(end[:, 0] - start) // N)
    state = np.stack([blk[3] for blk in coded])
    read = np.array([blk[5] for blk in coded], np.int64)[:, None]
    rows = np.arange(len(coded))[:, None]
    words = np.append(stream.astype(np.int64), 0)
    last = words.size - 1
    for g in range(int(groups.max())):
        pos = start[:, None] + g * N + LANES[None, :]
        v = pos < end
        slot = state & ((1 << b) - 1)
        sym = inv[rows, slot]
        out[pos[v]] = sym[v]
        state = np.where(v, (state >> b) * f_tab[rows, sym] + slot - c_tab[rows, sym], state)
        take = (state < CONSUME_POINT) & v
        k = take.astype(np.int64)
        at = np.minimum(read + np.cumsum(k, axis=1) - k, last)
        state = np.where(take, ((state << 16) | words[at]) & M32, state)
        read += k.sum(axis=1, keepdims=True)
    return out.tobytes()


def tables(blob: bytes | np.ndarray) -> int:
    """The blob's frequency tables: one a coded block."""
    return sum(blk[3] is not None for blk in parse(blob)[2])
