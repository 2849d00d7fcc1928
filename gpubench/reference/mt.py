"""The mt_rANS32x64 16w wire of hypersonic-rANS, with every block encoded
from fresh states, in plain NumPy: the benchmark's own frozen codec,
independent of the code under test.  The blocks and their freqs are a
plan's (`planner.py`).

Wire (little-endian): u64 raw length | u64 blob length, then per block:
a single-symbol block is one u64 (size | 1 << 63 | symbol << 54); a coded
block is u64 size | u64 offset | 64 u32 states | 256 u16 freqs | its u16
words.  The offset counts u16 words from the states field + 1 to the next
block's size field (2 n + 256 + words - 1; the last block's one less).

A block codes its bytes in groups of 64, lane j of a group taking byte
IDX2IDX[j] of it; lanes of the block's partial last group that lie past
the input take no part.  The encoder starts every block from the states
2^15, runs backward over its groups and emits a lane's low 16 bits where
its state is at or above 2^(31-B) x freq; the words go on the wire
forward, group by group and lane by lane, and the states it ends with are
the block's snapshot, where its decoder starts.  Lanes of a block's partial
last group past its end and within the input code the byte 0.
"""

from __future__ import annotations

import numpy as np

from .hist import cumul_of, normalize_rows

N = 64
CONSUME_POINT = 1 << 15
M32 = 0xFFFFFFFF
SINGLE = 1 << 63


def _perm32() -> list[int]:
    """idx2idx of 32 lanes: two 16-lane halves interleaved in 4-byte runs."""
    return [h * 16 + q * 4 + k for q in range(4) for h in range(2) for k in range(4)]


IDX2IDX = np.array(_perm32() + [p + 32 for p in _perm32()], np.int64)


def _encode_blocks(arr: np.ndarray, starts: np.ndarray, sizes: np.ndarray, freqs: np.ndarray,
                   bits: int) -> tuple[np.ndarray, ...]:
    """Blocks side by side, each from fresh states with its own freqs:
    (states [nb, 64], words [nb, groups, 64], emits [nb, groups, 64])."""
    length = arr.size
    nb = len(starts)
    groups = -(-sizes // N)
    ends = np.minimum(starts + sizes, length)[:, None]
    # freq | cumul << 16 of each block's symbols, gathered once a step (u32 arithmetic throughout)
    fc = (freqs.astype(np.int64) | cumul_of(freqs) << 16).astype(np.uint32).reshape(-1)
    row0 = (np.arange(nb) * 256)[:, None]
    emit_point = np.uint32((CONSUME_POINT >> bits) << 16)
    state = np.full((nb, N), CONSUME_POINT, np.uint32)
    words = np.zeros((nb, int(groups.max()), N), np.uint16)
    emits = np.zeros(words.shape, bool)
    for g in range(words.shape[1] - 1, -1, -1):
        pos = starts[:, None] + g * N + IDX2IDX[None, :]
        v = (g < groups)[:, None] & (pos < length)
        sym = np.where(pos < ends, arr[np.minimum(pos, length - 1)], 0)  # lanes past a block's end code byte 0
        e = fc[row0 + sym]
        f = e & 0xFFFF
        emit = (state >= emit_point * f) & v
        words[:, g] = state
        emits[:, g] = emit
        state = np.where(emit, state >> 16, state)
        q, r = np.divmod(state, np.maximum(f, 1))
        state = np.where(v, (q << bits) + (e >> 16) + r, state)
    return state.astype(np.int64), words, emits


def encode(data: bytes | np.ndarray, bits: int, rows: list) -> bytes:
    """The mt blob of `data` in the blocks `rows` (`planner.Row`s), every
    coded block encoded from fresh states with its row's freqs."""
    arr = np.frombuffer(data, np.uint8) if isinstance(data, (bytes, bytearray, memoryview)) else np.asarray(data, np.uint8)
    parts: list[bytes] = [b""] * len(rows)
    for k, (_, size, symbol, _) in enumerate(rows):
        if symbol is not None:
            parts[k] = np.array([size | SINGLE | symbol << 54], "<u8").tobytes()
    coded = sorted((k for k, r in enumerate(rows) if r[2] is None and r[1]), key=lambda k: rows[k][1])
    groups = [-(-rows[k][1] // N) for k in coded]
    i = 0
    while i < len(coded):  # blocks of like size together, up to 2^18 lane groups at a time
        j = i + 1
        while j < len(coded) and (j + 1 - i) * groups[j] <= 1 << 18:
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


def parse(blob: bytes | np.ndarray) -> tuple[int, np.ndarray, list[tuple]]:
    """(raw length, u16 words of the blob past its head, blocks): a block
    is (out_start, size, symbol, None, None, None) if single-symbol, else
    (out_start, size, None, states [64], freqs [256], first word).
    ValueError where the header chain breaks."""
    buf = np.frombuffer(blob, np.uint8) if isinstance(blob, (bytes, bytearray, memoryview)) else np.asarray(blob, np.uint8)
    if buf.size < 16:
        raise ValueError("mt blob shorter than its head")
    length = int(buf[:8].view("<u8")[0])
    stream = buf[16 : 16 + (buf.size - 16) // 2 * 2].view("<u2")
    blocks, i, r = [], 0, 0
    while i < length:
        if r + 4 > stream.size:
            raise ValueError("mt header chain runs past the blob")
        val = int(stream[r : r + 4].view("<u8")[0])
        if val & SINGLE:
            size = val & ((1 << 54) - 1)
            blocks.append((i, size, (val >> 54) & 0xFF, None, None, None))
            r += 4
        else:
            offset = int(stream[r + 4 : r + 8].view("<u8")[0])
            states = stream[r + 8 : r + 8 + 2 * N].view("<u4").astype(np.int64)
            freqs = stream[r + 8 + 2 * N : r + 8 + 2 * N + 256].astype(np.int64)
            if states.size != N or freqs.size != 256:
                raise ValueError("mt block header truncated")
            size = min(val, length - i)
            blocks.append((i, size, None, states, freqs, r + 8 + 2 * N + 256))
            r = r + 8 + offset + 1
            if i + val > max(length - N + 1, 0):
                break  # the last coded block holds the partial group
        i += size
    return length, stream, blocks


def decode(blob: bytes | np.ndarray, bits: int = 12, table_bits: int | None = None) -> bytes:
    """The raw bytes of an mt blob at 2^bits.  `table_bits` below `bits`
    decodes with each block's freqs renormalised to 2^table_bits and the
    state arithmetic at that depth: the lower-precision decode that the
    benchmark's control runs in place of the program."""
    length, stream, blocks = parse(blob)
    out = np.zeros(length, np.uint8)
    coded = [blk for blk in blocks if blk[3] is not None]
    for start, size, sym, *_ in blocks:
        if sym is not None:
            out[start : start + size] = sym
    if not coded:
        return out.tobytes()
    b = bits if table_bits is None else table_bits
    freqs = np.stack([blk[4] for blk in coded])
    if b != bits:
        freqs = normalize_rows(freqs, np.full(len(freqs), 1 << bits), b).astype(np.int64)
    f_tab, c_tab = freqs, cumul_of(freqs)
    inv = np.stack([np.repeat(np.arange(256), f) for f in f_tab])
    start = np.array([blk[0] for blk in coded], np.int64)
    # every lane group of a block, the partial one at the input's end with it
    groups = np.array([-(-min(blk[1], length - blk[0]) // N) for blk in coded], np.int64)
    end = (start + np.array([blk[1] for blk in coded], np.int64))[:, None]
    state = np.stack([blk[3] for blk in coded])
    read = np.array([blk[5] for blk in coded], np.int64)[:, None]
    rows = np.arange(len(coded))[:, None]
    words = np.append(stream.astype(np.int64), 0)
    last = words.size - 1
    for g in range(int(groups.max())):
        pos = start[:, None] + g * N + IDX2IDX[None, :]
        v = (g < groups)[:, None] & (pos < length)
        slot = state & ((1 << b) - 1)
        sym = inv[rows, slot]
        mine = v & (pos < end)  # a partial group's lanes past its block decode zeros
        out[pos[mine]] = sym[mine]
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
