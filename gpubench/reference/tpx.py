"""The tpx v2 wire, encoded and decoded in plain NumPy: the benchmark's own
frozen codec, independent of the code under test.

Wire (little-endian): "HSRTPX02" | u64 raw length | u64 blob length |
u32 bits | u32 rows R | u32 lanes (128) | u32 steps S | u32 tiles T, then
one section a megablock: u32 n_tiles | u32 w_slots | R x 128 u32 states |
n_tiles x (256 u16 freqs | R u16 word counts) | each row's words, tile by
tile and row by row, padded to whole u32 slots.

A megablock's byte at wire position (((t R + r) S/4 + s // 4) 128 + l) 4 +
s % 4 is step s of lane l of row r in tile t.  Each row is 128 interleaved
32-bit rANS states with 16-bit renormalisation words; the states run on
from tile to tile of a mega, each tile with its own histogram of its bytes.
The encoder runs backward from the state 2^15 and emits a lane's low 16
bits where the state is at or above 2^(31-B) x freq; the decoder reads
words forward in lane order.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .hist import cumul_of, normalize_rows, segment_freqs

MAGIC2 = b"HSRTPX02"
LANES = 128
ROWS, STEPS, TILES = 1024, 32, 4
CONSUME_POINT = 1 << 15
M32 = 0xFFFFFFFF


@dataclass(frozen=True)
class Geometry:
    rows: int
    steps: int
    tiles: int

    @property
    def mega_bytes(self) -> int:
        return self.rows * self.tiles * self.steps * LANES


def geometry(length: int) -> Geometry:
    """The encoder's geometry for an input of `length` bytes ("balanced"):
    1024 rows x 32 steps x 4 tiles from 32 MiB up, below it rows ~ length /
    85,000 (8 to 128, a multiple of 8) and tiles to cover the input (1 to
    64)."""
    if length >= 32 << 20:
        return Geometry(ROWS, STEPS, TILES)
    rows = -(-max(8, min(128, length // 85000)) // 8) * 8
    return Geometry(rows, STEPS, max(1, min(64, -(-length // (rows * STEPS * LANES)))))


def mega_layout(length: int, g: Geometry) -> list[tuple[int, int, int]]:
    """[(base, n_tiles, valid bytes)] of the megablocks covering the input."""
    out, base = [], 0
    while base < length or (length == 0 and not out):
        rem = length - base
        if rem >= g.mega_bytes:
            out.append((base, g.tiles, g.mega_bytes))
            base += g.mega_bytes
        else:
            out.append((base, max(1, -(-rem // (g.rows * g.steps * LANES))), max(rem, 0)))
            base = length
    return out


def _symbol_view(flat: np.ndarray, rows: int, n_tiles: int, steps: int) -> np.ndarray:
    """Wire-ordered bytes -> [n_tiles, steps, rows, 128] (tile, step, row, lane)."""
    return flat.reshape(n_tiles, rows, steps // 4, LANES, 4).transpose(0, 2, 4, 1, 3).reshape(n_tiles, steps, rows, LANES)


def _encode_mega(arr: np.ndarray, base: int, n_tiles: int, valid: int, bits: int, g: Geometry) -> list[bytes]:
    rows, steps = g.rows, g.steps
    tile_bytes = rows * steps * LANES
    flat = np.zeros(n_tiles * tile_bytes, np.uint8)
    n_valid = min(valid, flat.size)
    flat[:n_valid] = arr[base : base + n_valid]
    starts = np.arange(n_tiles, dtype=np.int64) * tile_bytes
    freqs = segment_freqs(flat, starts, np.minimum(starts + tile_bytes, n_valid), bits)
    # freq | cumul << 16 of each tile's symbols (u32 arithmetic throughout)
    fc = (freqs.astype(np.int64) | cumul_of(freqs) << 16).astype(np.uint32)
    sym = _symbol_view(flat, rows, n_tiles, steps)
    pos = _symbol_view(np.arange(flat.size, dtype=np.int64), rows, n_tiles, steps)
    emit_point = np.uint32((CONSUME_POINT >> bits) << 16)
    state = np.full((rows, LANES), CONSUME_POINT, np.uint32)
    words = np.zeros((n_tiles, steps, rows, LANES), np.uint16)
    emits = np.zeros((n_tiles, steps, rows, LANES), bool)
    for t in range(n_tiles - 1, -1, -1):
        for s in range(steps - 1, -1, -1):
            e = fc[t][sym[t, s]]
            v = pos[t, s] < n_valid
            f = np.maximum(e & 0xFFFF, 1)
            emit = (state >= emit_point * f) & v
            words[t, s] = state
            emits[t, s] = emit
            state = np.where(emit, state >> 16, state)
            q, r = np.divmod(state, f)
            state = np.where(v, (q << bits) + (e >> 16) + r, state)
    # each row's words forward (step, lane ascending), padded to whole u32 slots
    w = words.transpose(0, 2, 1, 3).reshape(n_tiles * rows, steps * LANES)
    e = emits.transpose(0, 2, 1, 3).reshape(n_tiles * rows, steps * LANES)
    counts = e.sum(axis=1)
    w = np.concatenate([w, np.zeros((w.shape[0], 1), np.uint16)], axis=1)
    e = np.concatenate([e, (counts % 2 == 1)[:, None]], axis=1)
    max_words = int(counts.max()) if counts.size else 0
    w_slots = max(128, -(-(-(-max_words // 2)) // 128) * 128)
    head = np.array([n_tiles, w_slots], "<u4").tobytes() + state.astype("<u4").tobytes()
    tables = b"".join(
        freqs[t].astype("<u2").tobytes() + counts[t * rows : (t + 1) * rows].astype("<u2").tobytes()
        for t in range(n_tiles)
    )
    return [head, tables, w[e].astype("<u2").tobytes()]


def encode(data: bytes | np.ndarray, bits: int = 12) -> bytes:
    """The tpx v2 blob of `data` at 2^bits, the geometry of `geometry`."""
    arr = np.frombuffer(data, np.uint8) if isinstance(data, (bytes, bytearray, memoryview)) else np.asarray(data, np.uint8)
    g = geometry(arr.size)
    parts = [MAGIC2, arr.size.to_bytes(8, "little"), bytes(8),
             np.array([bits, g.rows, LANES, g.steps, g.tiles], "<u4").tobytes()]
    for base, n_tiles, valid in mega_layout(arr.size, g):
        parts += _encode_mega(arr, base, n_tiles, valid, bits, g)
    blob = bytearray(b"".join(parts))
    blob[16:24] = len(blob).to_bytes(8, "little")
    return bytes(blob)


@dataclass
class Mega:
    base: int
    n_tiles: int
    states: np.ndarray  # u32 [R, 128] as int64
    freqs: np.ndarray  # u16 [n_tiles, 256]
    counts: np.ndarray  # [n_tiles, R]
    words: np.ndarray  # u16: every row's padded words, tile by tile, row by row


def parse(blob: bytes | np.ndarray) -> tuple[int, int, Geometry, list[Mega]]:
    """(raw length, bits, geometry, megablocks) of a v2 blob; ValueError
    where it is not one."""
    buf = np.frombuffer(blob, np.uint8) if isinstance(blob, (bytes, bytearray, memoryview)) else np.asarray(blob, np.uint8)
    if buf.size < 44 or buf[:8].tobytes() != MAGIC2:
        raise ValueError("not a tpx v2 blob")
    length = int(buf[8:16].view("<u8")[0])
    bits, rows, lanes, steps, tiles = (int(x) for x in buf[24:44].view("<u4"))
    if lanes != LANES or not 10 <= bits <= 15 or steps % 4 or rows < 1 or tiles < 1:
        raise ValueError("tpx v2 header out of range")
    g = Geometry(rows, steps, tiles)
    megas, off, base = [], 44, 0
    while base < length or (length == 0 and not megas):
        n_tiles = int(buf[off : off + 4].view("<u4")[0])
        off += 8
        states = buf[off : off + 4 * rows * LANES].view("<u4").reshape(rows, LANES).astype(np.int64)
        off += 4 * rows * LANES
        freqs = np.zeros((n_tiles, 256), np.uint16)
        counts = np.zeros((n_tiles, rows), np.int64)
        for t in range(n_tiles):
            freqs[t] = buf[off : off + 512].view("<u2")
            counts[t] = buf[off + 512 : off + 512 + 2 * rows].view("<u2")
            off += 512 + 2 * rows
        n_words = int(((counts + 1) // 2).sum()) * 2
        if off + 2 * n_words > buf.size:
            raise ValueError("tpx v2 blob truncated")
        megas.append(Mega(base, n_tiles, states, freqs, counts, buf[off : off + 2 * n_words].view("<u2")))
        off += 2 * n_words
        base += g.mega_bytes
    return length, bits, g, megas


def decode(blob: bytes | np.ndarray, table_bits: int | None = None) -> bytes:
    """The raw bytes of a v2 blob.  `table_bits` below the blob's depth
    decodes with each tile's freqs renormalised to 2^table_bits and the
    state arithmetic at that depth: the lower-precision decode that the
    benchmark's control runs in place of the program."""
    length, bits, g, megas = parse(blob)
    out = np.zeros(length, np.uint8)
    rows, steps = g.rows, g.steps
    tile_bytes = rows * steps * LANES
    for m in megas:
        freqs = m.freqs
        b = bits
        if table_bits is not None and table_bits != bits:
            freqs = normalize_rows(freqs.astype(np.int64), np.full(len(freqs), 1 << bits), table_bits)
            b = table_bits
        f_tab = freqs.astype(np.int64)
        c_tab = cumul_of(freqs)
        n_valid = min(length - m.base, m.n_tiles * tile_bytes)
        pos = _symbol_view(np.arange(m.n_tiles * tile_bytes, dtype=np.int64), rows, m.n_tiles, steps)
        sc = (m.counts.reshape(-1) + 1) // 2
        row_word0 = (2 * (np.cumsum(sc) - sc)).reshape(m.n_tiles, rows, 1)
        state = m.states.copy()
        syms = np.zeros((m.n_tiles, steps, rows, LANES), np.uint8)
        last = max(m.words.size - 1, 0)
        words = m.words.astype(np.int64) if m.words.size else np.zeros(1, np.int64)
        for t in range(m.n_tiles):
            inv = np.repeat(np.arange(256), f_tab[t])
            read = np.zeros((rows, 1), np.int64)
            for s in range(steps):
                v = pos[t, s] < n_valid
                slot = state & ((1 << b) - 1)
                sym = inv[slot]
                syms[t, s] = np.where(v, sym, 0)
                state = np.where(v, (state >> b) * f_tab[t][sym] + slot - c_tab[t][sym], state)
                take = (state < CONSUME_POINT) & v
                k = take.astype(np.int64)
                at = np.minimum(row_word0[t] + read + np.cumsum(k, axis=1) - k, last)
                state = np.where(take, ((state << 16) | words[at]) & M32, state)
                read += k.sum(axis=1, keepdims=True)
        wire = syms.reshape(m.n_tiles, steps // 4, 4, rows, LANES).transpose(0, 3, 1, 4, 2).reshape(-1)
        out[m.base : m.base + n_valid] = wire[:n_valid]
    return out.tobytes()


def tables(blob: bytes | np.ndarray) -> int:
    """The blob's frequency tables: one a tile."""
    return sum(m.n_tiles for m in parse(blob)[3])
