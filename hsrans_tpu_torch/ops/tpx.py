"""The tpx wire on the host: geometry, header, per-tile histograms, mega
writers, parser, and the numpy codec.

The port's copy of `hsrans_tpu/ops/tpx.py` (the wire format is documented
there), so that the port loads no module of the JAX package:
`tpx_encode`, `tpx_encode_adaptive` and `tpx_decode` are the numpy wire
authority, reached by their own names and by the CLI's `--backend numpy`,
never by a `*_torch` entry point.  `tests/test_torch_host_tier.py` and
`tests/test_torch_tpx_numpy.py` hold each function here equal to its
original.  The parser differs in its output only: it leaves each mega's
slots where the wire keeps them (`TpxMega.slot_off`, `row_start`), and
`tpx_decode` rebuilds the rectangular stream the original's parser gives.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..models.histogram import Hist, complete_hist, make_cumul_inv, normalize_hist, observe_hist
from ..rans import encode_emit_point_16
from .planner import plan_blocks_py

_U32 = np.uint32

MAGIC = b"HSRTPX01"  # v1: rectangular per-mega [T, R, W] stream section
MAGIC2 = b"HSRTPX02"  # v2: ragged streams (each row's exact slots); encoders emit v2
MAGIC3 = b"HSRTPX03"  # v3: per-megablock geometry (u32 rows | u32 steps before each mega)

# default geometry; part of the wire (the header carries it), never retuned
R = 1024  # rows (independent sub-streams) per tile
L = 128  # interleaved rANS lanes per row
S = 32  # lane-group steps per tile
T = 4  # tiles per megablock (mega covers R*T*S*L = 16 MiB)

DECODE_CONSUME_POINT_16 = 1 << 15  # rANS32 16-bit renorm lower bound


def make_tile_hist(tile_bytes: np.ndarray, bits: int) -> Hist:
    """Per-tile adaptive histogram.  Empty tiles (wholly past the input)
    get the 1-symbol histogram."""
    if tile_bytes.size == 0:
        counts = np.zeros(256, np.uint32)
        counts[0] = 1
        return normalize_hist(counts, 1, bits)
    return normalize_hist(observe_hist(tile_bytes), tile_bytes.size, bits)


@dataclass
class TpxParams:
    bits: int = 12
    rows: int = R
    lanes: int = L
    steps: int = S
    tiles: int = T

    @property
    def mega_bytes(self) -> int:
        return self.rows * self.tiles * self.steps * self.lanes

    @classmethod
    def auto(cls, length: int, bits: int = 12, goal: str = "balanced") -> "TpxParams":
        """Geometry scaled to the input and the speed/ratio goal: inputs of
        32 MiB or more take the default geometry; below that the rows (the
        chain count) follow the length and the goal, and tiles per mega rise
        so one mega covers the input."""
        if length >= 32 << 20:
            return cls(bits=bits)
        if goal == "speed":
            rows = max(8, min(R, -(-length // (T * S * L))))
        elif goal == "ratio":
            rows = max(8, min(96, length // 200000))
        else:
            rows = max(8, min(128, length // 85000))
        rows = -(-rows // 8) * 8
        tiles = max(1, min(64, -(-length // (rows * S * L))))
        return cls(bits=bits, rows=rows, tiles=tiles)


def _mega_layout(length: int, p: TpxParams) -> list[tuple[int, int, int]]:
    """[(mega_base, n_tiles, valid_bytes)] covering the input."""
    out = []
    base = 0
    while base < length or (length == 0 and not out):
        rem = length - base
        if rem >= p.mega_bytes:
            out.append((base, p.tiles, p.mega_bytes))
            base += p.mega_bytes
        else:
            per_row = p.steps * p.lanes
            n_tiles = max(1, -(-rem // (p.rows * per_row)))
            out.append((base, n_tiles, max(rem, 0)))
            base = length
    return out


def make_rank_tables(hist: Hist) -> dict[str, np.ndarray]:
    """Bucketed-rank decode tables (the Pallas kernel's lookup):
    rank = c0[slot >> 5] + popcount(bm[slot >> 5] & ((2 << (slot & 31)) - 2))
    indexes the present symbols, t1[rank] = sym | freq << 8 and
    t2[rank] = cumul; at B <= 12 also `tp` (sym | (freq - 1) << 8 |
    cumul << 20), at B <= 11 `cb16` (16-slot buckets, bm | c0 << 16)."""
    inv = make_cumul_inv(hist)
    total = 1 << hist.total_symbol_count_bits
    n_buckets = total // 32
    present = np.nonzero(hist.symbol_count)[0]
    rank_of_sym = np.zeros(256, dtype=np.int64)
    rank_of_sym[present] = np.arange(present.size)
    inv_rank = rank_of_sym[inv]
    c0 = inv_rank[::32].astype(np.int32)
    first = np.zeros(total, dtype=bool)
    first[0] = True
    first[1:] = inv[1:] != inv[:-1]
    bits = first.reshape(n_buckets, 32)
    bm = (bits.astype(np.uint64) << np.arange(32, dtype=np.uint64)[None, :]).sum(axis=1).astype(np.uint32)
    t1 = np.zeros(256, dtype=np.uint32)
    t2 = np.zeros(256, dtype=np.uint32)
    t1[: present.size] = present.astype(np.uint32) | (hist.symbol_count[present].astype(np.uint32) << np.uint32(8))
    t2[: present.size] = hist.cumul[present].astype(np.uint32)
    out = {"c0": c0, "bm": bm.view(np.int32), "t1": t1.view(np.int32), "t2": t2.view(np.int32)}
    if hist.total_symbol_count_bits <= 12:
        # freq - 1 keeps the single-symbol table (freq = 2^12) in 12 bits
        tp = np.zeros(256, dtype=np.uint32)
        tp[: present.size] = (
            present.astype(np.uint32)
            | ((hist.symbol_count[present].astype(np.uint32) - np.uint32(1)) << np.uint32(8))
            | (hist.cumul[present].astype(np.uint32) << np.uint32(20))
        )
        out["tp"] = tp.view(np.int32)
    if hist.total_symbol_count_bits <= 11:
        n16 = total // 16
        c0_16 = inv_rank[::16].astype(np.uint32)
        bits16 = first.reshape(n16, 16)
        bm16 = (bits16.astype(np.uint32) << np.arange(16, dtype=np.uint32)[None, :]).sum(axis=1)
        out["cb16"] = (bm16 | (c0_16 << np.uint32(16))).astype(np.uint32).view(np.int32)
    return out


def _encode_mega_into(
    out: bytearray,
    arr: np.ndarray,
    mega_base: int,
    n_tiles: int,
    valid_bytes: int,
    bits: int,
    rows: int,
    steps: int,
    lanes: int = L,
) -> None:
    """Encode one megablock of `arr` at the given geometry and append its
    wire section (n_tiles | W | states | tables | ragged streams) to `out`;
    the uniform (v2) and adaptive (v3) encoders share it."""
    emit_point = _U32(encode_emit_point_16(bits))
    s4c = steps // 4
    row_span = n_tiles * steps * lanes
    flat = np.zeros(rows * row_span, dtype=np.uint8)
    n_valid = min(valid_bytes, rows * row_span)
    flat[:n_valid] = arr[mega_base : mega_base + n_valid]
    # wire byte mapping [t, r, s4, l, b] -> symbol layout [r, t, s, l]
    view = flat.reshape(n_tiles, rows, s4c, lanes, 4).transpose(1, 0, 2, 4, 3).reshape(rows, n_tiles, steps, lanes)
    r_ = np.arange(rows)[:, None, None, None]
    t_ = np.arange(n_tiles)[None, :, None, None]
    s_ = np.arange(steps)[None, None, :, None]
    l_ = np.arange(lanes)[None, None, None, :]
    pos = (((t_ * rows + r_) * s4c + s_ // 4) * lanes + l_) * 4 + s_ % 4
    valid = pos < n_valid

    # tile t's valid bytes are the wire range [t * rows * steps * L, ...)
    tile_bytes = rows * steps * lanes
    hists = [make_tile_hist(flat[t * tile_bytes : min((t + 1) * tile_bytes, n_valid)], bits) for t in range(n_tiles)]

    states = np.full((rows, lanes), DECODE_CONSUME_POINT_16, dtype=_U32)
    words = np.zeros((n_tiles, steps, rows, lanes), dtype=np.uint16)
    emits = np.zeros((n_tiles, steps, rows, lanes), dtype=bool)

    for t in range(n_tiles - 1, -1, -1):
        freq_tab = hists[t].symbol_count.astype(_U32)
        cumul_tab = hists[t].cumul.astype(_U32)
        for s in range(steps - 1, -1, -1):
            b = view[:, t, s]
            v = valid[:, t, s]
            freq = freq_tab[b]
            emit = (states >= emit_point * np.maximum(freq, 1)) & v
            words[t, s] = np.where(emit, (states & _U32(0xFFFF)).astype(np.uint16), 0)
            emits[t, s] = emit
            states = np.where(emit, states >> _U32(16), states)
            new_states = ((states // np.maximum(freq, 1)) << _U32(bits)) + cumul_tab[b] + (states % np.maximum(freq, 1))
            states = np.where(v, new_states, states)

    # per-row per-tile forward streams = reversed emission order
    counts = emits.transpose(0, 2, 1, 3).reshape(n_tiles, rows, -1).sum(axis=2)
    max_words = int(counts.max()) if counts.size else 0
    w_slots = max(128, -(-(-(-max_words // 2)) // 128) * 128)
    stream = np.zeros((n_tiles, rows, w_slots), dtype=np.uint32)
    for t in range(n_tiles):
        wt = words[t].transpose(1, 0, 2).reshape(rows, -1)  # [rows, steps*lanes] fwd order
        et = emits[t].transpose(1, 0, 2).reshape(rows, -1)
        for r in range(rows):
            rw = wt[r][et[r]].astype(np.uint32)
            if rw.size & 1:
                rw = np.concatenate([rw, [np.uint32(0)]])
            stream[t, r, : rw.size // 2] = rw[0::2] | (rw[1::2] << np.uint32(16))

    _write_mega(out, n_tiles, w_slots, states, [h.symbol_count for h in hists], counts, stream)


def tpx_encode(data: bytes | np.ndarray, bits: int = 12, p: TpxParams | None = None, goal: str = "balanced") -> bytes:
    """The numpy tpx encoder (v2 wire): `p`, or `TpxParams.auto` of the
    length, the depth and the goal."""
    arr = np.frombuffer(data, dtype=np.uint8) if isinstance(data, (bytes, bytearray, memoryview)) else np.asarray(data, dtype=np.uint8)
    length = arr.size
    p = p or TpxParams.auto(length, bits, goal)
    bits = p.bits

    out = tpx_header(length, p)
    for mega_base, n_tiles, valid_bytes in _mega_layout(length, p):
        _encode_mega_into(out, arr, mega_base, n_tiles, valid_bytes, bits, p.rows, p.steps, p.lanes)

    out[16:24] = len(out).to_bytes(8, "little")
    return bytes(out)


@dataclass
class MegaGeom:
    """One v3 megablock's geometry: covers rows * n_tiles * steps * 128
    bytes from `base` (the last mega may be partial)."""

    base: int
    rows: int
    steps: int
    n_tiles: int

    @property
    def span(self) -> int:
        return self.rows * self.n_tiles * self.steps * L


def tpx_plan_geometry(arr: np.ndarray, bits: int) -> list[MegaGeom]:
    """`tpx_geometry` of the Python planner's rows: the numpy tier's, no native library."""
    return tpx_geometry(arr.size, plan_blocks_py(arr, bits, "mt", 64))


def tpx_geometry(length: int, plan: list) -> list[MegaGeom]:
    """Per-region geometry of the v3 wire over `length` bytes from the
    planner's mt rows (n = 64): each run of similarly-sized planner blocks
    becomes one megablock whose tile span tracks the block size, with rows
    x steps from the table below (span = rows*steps*128).

      region block size   tile span   rows x steps
      >= 4 MiB              4 MiB     1024 x 32
      >= 1 MiB              1 MiB     1024 x 8
      >= 256 KiB          256 KiB      256 x 8
      else                128 KiB      128 x 8
    """
    if length == 0:
        return [MegaGeom(0, 8, 4, 1)]

    def geom_of(block_size: int) -> tuple[int, int]:
        if block_size >= 4 << 20:
            return 1024, 32
        if block_size >= 1 << 20:
            return 1024, 8
        if block_size >= 256 << 10:
            return 256, 8
        return 128, 8

    out: list[MegaGeom] = []
    base = 0
    i = 0
    while base < length:
        # geometry of the region starting here: the plan block covering base
        while i + 1 < len(plan) and plan[i + 1].start <= base:
            i += 1
        rows, steps = geom_of(plan[i].size)
        # small-input clamp: rows scale down until the tile span fits the
        # remaining data (same floor as TpxParams.auto)
        rows = min(rows, max(8, (length - base) // (steps * L) // 8 * 8))
        tile_span = rows * steps * L
        # extend the mega while following plan blocks keep the same geometry
        end = min(plan[i].start + plan[i].size, length)
        j = i + 1
        while j < len(plan) and geom_of(plan[j].size) == (rows, steps):
            end = min(plan[j].start + plan[j].size, length)
            j += 1
        n_tiles = max(1, (end - base) // tile_span)
        if base + n_tiles * tile_span >= length:
            n_tiles = max(1, -(-(length - base) // tile_span))
        n_tiles = min(n_tiles, 64)  # TpxParams.auto's bound
        out.append(MegaGeom(base, rows, steps, n_tiles))
        base += n_tiles * tile_span
    return out


def tpx_encode_adaptive(data: bytes | np.ndarray, bits: int = 12) -> bytes:
    """The numpy v3 encoder: each megablock at the geometry
    `tpx_plan_geometry` gives its region."""
    arr = np.frombuffer(data, dtype=np.uint8) if isinstance(data, (bytes, bytearray, memoryview)) else np.asarray(data, dtype=np.uint8)
    length = arr.size
    geoms = tpx_plan_geometry(arr, bits)

    out = bytearray()
    out += MAGIC3
    out += length.to_bytes(8, "little")
    out += b"\0" * 8
    g0 = geoms[0]
    for v in (bits, g0.rows, L, g0.steps, g0.n_tiles):
        out += int(v).to_bytes(4, "little")
    for g in geoms:
        out += int(g.rows).to_bytes(4, "little")
        out += int(g.steps).to_bytes(4, "little")
        _encode_mega_into(out, arr, g.base, g.n_tiles, max(0, min(length - g.base, g.span)), bits, g.rows, g.steps)

    out[16:24] = len(out).to_bytes(8, "little")
    return bytes(out)


def tpx_header(length: int, p: TpxParams) -> bytearray:
    """v2 wire header; the total length at [16:24] is filled in last."""
    out = bytearray()
    out += MAGIC2
    out += length.to_bytes(8, "little")
    out += b"\0" * 8
    for v in (p.bits, p.rows, p.lanes, p.steps, p.tiles):
        out += int(v).to_bytes(4, "little")
    return out


def _write_mega_segs(out, n_tiles, w_slots, states, freqs, counts, seg_streams, seg_words) -> None:
    """v2 mega writer from per-segment pieces: each row's wire stream is the
    byte-level join of its segments' words, zero-padded to the row's slot
    count, the bytes `_write_mega` writes from a row-contiguous stream.

    seg_streams: u32/int32 [T, S, R, Wc] slot matrices; seg_words: [T, R, S]
    words per piece."""
    out += int(n_tiles).to_bytes(4, "little")
    out += int(w_slots).to_bytes(4, "little")
    out += states.astype("<u4").tobytes()
    for t in range(n_tiles):
        out += np.asarray(freqs[t]).astype("<u2").tobytes()
        out += np.asarray(counts[t]).astype("<u2").tobytes()
    T, S, R, WC = seg_streams.shape
    src = np.ascontiguousarray(seg_streams, dtype=np.uint32).view(np.uint8).reshape(T * S * R, WC * 4)
    sw = np.asarray(seg_words, dtype=np.int64)  # [T, R, S]
    plen = (sw * 2).reshape(-1)  # bytes per piece, (t, r, s) order
    piece_row = ((np.arange(T)[:, None, None] * S + np.arange(S)[None, None, :]) * R
                 + np.arange(R)[None, :, None]).reshape(-1)  # source row of piece (t, r, s)
    sc = (np.asarray(counts, dtype=np.int64) + 1) // 2  # [T, R] row slot counts
    row_start = (np.cumsum(sc.reshape(-1)) - sc.reshape(-1)) * 4  # row byte starts
    in_row = np.cumsum(sw, axis=2) - sw  # words before piece within its row
    dest_start = (row_start.reshape(T, R, 1) + in_row * 2).reshape(-1)
    total = int(plen.sum())
    ar = np.arange(total, dtype=np.int64)
    starts = np.cumsum(plen) - plen
    within = ar - np.repeat(starts, plen)
    dest = np.zeros(int(sc.sum()) * 4, dtype=np.uint8)
    dest[np.repeat(dest_start, plen) + within] = src.reshape(-1)[np.repeat(piece_row * (WC * 4), plen) + within]
    out += dest.tobytes()


def _write_mega(out, n_tiles, w_slots, states, freqs, counts, stream) -> None:
    """Append one megablock to `out`: header fields, then (v2) each row's
    exact ceil(words/2) stream slots back to back."""
    out += int(n_tiles).to_bytes(4, "little")
    out += int(w_slots).to_bytes(4, "little")
    out += states.astype("<u4").tobytes()
    for t in range(n_tiles):
        out += np.asarray(freqs[t]).astype("<u2").tobytes()
        out += np.asarray(counts[t]).astype("<u2").tobytes()
    flat = np.ascontiguousarray(stream, dtype=np.uint32).reshape(-1, stream.shape[-1])
    sc = (np.asarray(counts, dtype=np.int64).reshape(-1) + 1) // 2
    starts = np.cumsum(sc) - sc
    total = int(sc.sum())
    row_of = np.repeat(np.arange(flat.shape[0]), sc)
    col_of = np.arange(total) - np.repeat(starts, sc)
    out += flat[row_of, col_of].astype("<u4").tobytes()


@dataclass
class TpxMega:
    base: int
    n_tiles: int
    w_slots: int
    states: np.ndarray  # u32[R, L]
    freqs: np.ndarray  # u16[n_tiles, 256]
    counts: np.ndarray  # u16[n_tiles, R]
    slot_off: int  # blob byte offset of the mega's u32 slots (even, not always a multiple of 4)
    row_start: np.ndarray  # i64[n_tiles * R + 1]: row (t, r)'s first slot, t * R + r, counted from slot_off; then the end
    rows: int = 0
    steps: int = 0

    @property
    def span(self) -> int:
        return self.rows * self.n_tiles * self.steps * L


def tpx_parse(blob: bytes | np.ndarray) -> tuple[TpxParams, int, list[TpxMega]] | None:
    """Parse the container (v1, v2 or v3); None on malformed or truncated
    input.  The slots stay where the wire keeps them: each mega records
    where its slot region starts and where each row's slots start in it
    (back to back on the ragged v2/v3 wire, row * w_slots on the rectangular
    v1 one)."""
    buf = np.frombuffer(blob, dtype=np.uint8) if isinstance(blob, (bytes, bytearray, memoryview)) else np.asarray(blob, dtype=np.uint8)
    if buf.size < 44 or buf[:8].tobytes() not in (MAGIC, MAGIC2, MAGIC3):
        return None
    ragged = buf[:8].tobytes() in (MAGIC2, MAGIC3)
    per_mega_geom = buf[:8].tobytes() == MAGIC3
    length = int.from_bytes(buf[8:16].tobytes(), "little")
    bits, rows, lanes, steps, tiles = (int.from_bytes(buf[24 + 4 * i : 28 + 4 * i].tobytes(), "little") for i in range(5))
    if not (10 <= bits <= 15) or rows < 1 or lanes < 1 or steps < 1 or tiles < 1:
        return None
    if steps % 4 or rows * lanes > (1 << 24) or steps * tiles > (1 << 20):
        return None  # implausible header: refuse before allocating
    p = TpxParams(bits=bits, rows=rows, lanes=lanes, steps=steps, tiles=tiles)
    megas = []
    off = 44
    base = 0
    while base < length or (length == 0 and not megas):
        if per_mega_geom:
            # v3: u32 rows | u32 steps precede each mega's n_tiles
            if off + 8 > buf.size:
                return None
            rows = int.from_bytes(buf[off : off + 4].tobytes(), "little")
            steps = int.from_bytes(buf[off + 4 : off + 8].tobytes(), "little")
            if rows < 1 or steps < 1 or steps % 4 or rows * lanes > (1 << 24):
                return None
            off += 8
        if off + 8 > buf.size:
            return None
        n_tiles = int.from_bytes(buf[off : off + 4].tobytes(), "little")
        w_slots = int.from_bytes(buf[off + 4 : off + 8].tobytes(), "little")
        max_tiles = (1 << 20) // steps if per_mega_geom else tiles
        if n_tiles < 1 or n_tiles > max_tiles or w_slots < 1 or w_slots > steps * lanes:
            return None
        need_hdr = 4 * rows * lanes + n_tiles * (512 + 2 * rows)
        if off + 8 + need_hdr > buf.size:
            return None
        off += 8
        states = buf[off : off + 4 * rows * lanes].view("<u4").reshape(rows, lanes).astype(np.uint32)
        off += 4 * rows * lanes
        freqs = np.zeros((n_tiles, 256), dtype=np.uint16)
        counts = np.zeros((n_tiles, rows), dtype=np.uint16)
        for t in range(n_tiles):
            freqs[t] = buf[off : off + 512].view("<u2")
            off += 512
            counts[t] = buf[off : off + 2 * rows].view("<u2")
            off += 2 * rows
        if ragged:
            sc = (counts.astype(np.int64).reshape(-1) + 1) // 2
            if sc.max(initial=0) > w_slots:
                return None
            row_start = np.concatenate([np.zeros(1, np.int64), np.cumsum(sc)])
        else:
            row_start = np.arange(n_tiles * rows + 1, dtype=np.int64) * w_slots
        total = int(row_start[-1])
        if off + 4 * total > buf.size:
            return None
        slot_off = off
        off += 4 * total
        megas.append(TpxMega(base, n_tiles, w_slots, states, freqs, counts, slot_off, row_start, rows, steps))
        base += rows * n_tiles * steps * lanes
    return p, length, megas


def _mega_stream(buf: np.ndarray, mega: TpxMega) -> np.ndarray:
    """The mega's slots as the rectangular u32 [n_tiles, rows, w_slots]
    stream, each row left-aligned and zero-padded (the original parser's
    `TpxMega.stream`)."""
    sc = np.diff(mega.row_start)
    total = int(mega.row_start[-1])
    flat = buf[mega.slot_off : mega.slot_off + 4 * total].view("<u4")
    stream = np.zeros((sc.size, mega.w_slots), dtype=np.uint32)
    row_of = np.repeat(np.arange(sc.size), sc)
    col_of = np.arange(total) - np.repeat(mega.row_start[:-1], sc)
    stream[row_of, col_of] = flat
    return stream.reshape(mega.n_tiles, mega.rows, mega.w_slots)


def tpx_decode(blob: bytes | np.ndarray, use_rank_tables: bool = False) -> bytes | None:
    """The numpy tpx decoder (v1, v2 and v3 wires); None on malformed
    input.  `use_rank_tables` looks symbols up by `make_rank_tables` (the
    Pallas kernel's route) instead of the slot -> symbol table."""
    parsed = tpx_parse(blob)
    if parsed is None:
        return None
    p, length, megas = parsed
    buf = np.frombuffer(blob, dtype=np.uint8) if isinstance(blob, (bytes, bytearray, memoryview)) else np.asarray(blob, dtype=np.uint8)
    bits = p.bits
    mask_slot = _U32((1 << bits) - 1)
    max_span = max((m.span for m in megas), default=0)
    out = np.zeros(length + max_span, dtype=np.uint8)

    for mega in megas:
        n_tiles, rows, steps = mega.n_tiles, mega.rows, mega.steps
        row_span = n_tiles * steps * p.lanes
        streams = _mega_stream(buf, mega)
        states = mega.states.copy()
        n_valid = min(length - mega.base, rows * row_span)
        syms_all = np.zeros((n_tiles, steps, rows, p.lanes), dtype=np.uint8)
        lanes_idx = np.arange(p.lanes)

        for t in range(n_tiles):
            hist = complete_hist(mega.freqs[t], bits)
            if hist is None:
                return None
            freq_of = hist.symbol_count.astype(_U32)
            cumul_of = hist.cumul.astype(_U32)
            if use_rank_tables:
                rt = make_rank_tables(hist)
                c0, bm = rt["c0"], rt["bm"].view(np.uint32)
                t1, t2 = rt["t1"].view(np.uint32), rt["t2"].view(np.uint32)
            else:
                inv = make_cumul_inv(hist)
            stream = streams[t]
            r_word = np.zeros((rows, 1), dtype=np.int64)
            s4c = steps // 4
            base_pos = ((t * rows + np.arange(rows)[:, None]) * s4c * p.lanes + lanes_idx[None, :]) * 4
            for s in range(steps):
                slot = states & mask_slot
                if use_rank_tables:
                    k = (slot >> _U32(5)).astype(np.int64)
                    tbit = slot & _U32(31)
                    m = (_U32(2) << tbit) - _U32(2)
                    rank = (c0[k].astype(_U32) + _popcount(bm[k] & m)).astype(np.int64)
                    v1 = t1[rank]
                    sym = (v1 & _U32(0xFF)).astype(np.int64)
                    freq = v1 >> _U32(8)
                    cumul = t2[rank]
                else:
                    sym = inv[slot].astype(np.int64)
                    freq = freq_of[sym]
                    cumul = cumul_of[sym]
                v = (base_pos + ((s // 4) * p.lanes * 4 + s % 4)) < n_valid
                syms_all[t, s] = np.where(v, sym, 0)
                new_states = (states >> _U32(bits)) * freq + slot - cumul
                states_t = np.where(v, new_states, states)
                consume = (states_t < _U32(DECODE_CONSUME_POINT_16)) & v
                offs = np.cumsum(consume, axis=1) - consume
                widx = r_word + offs
                slot_val = np.take_along_axis(stream, np.minimum((widx >> 1).astype(np.int64), stream.shape[1] - 1), axis=1)
                word = (slot_val >> ((widx & 1) * 16).astype(np.uint32)) & _U32(0xFFFF)
                states = np.where(consume, (states_t << _U32(16)) | word, states_t)
                r_word = r_word + consume.sum(axis=1, keepdims=True)

        # [t, s, r, l] -> wire order [t, r, s4, l, b]
        mega_out = syms_all.reshape(n_tiles, steps // 4, 4, rows, p.lanes).transpose(0, 3, 1, 4, 2).reshape(-1)
        span = min(rows * row_span, out.size - mega.base)
        if span < 0:
            return None  # inconsistent (corrupted) header geometry
        out[mega.base : mega.base + span] = mega_out[:span]
    return out[:length].tobytes()


def _popcount(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint32)
    x = x - ((x >> np.uint32(1)) & np.uint32(0x55555555))
    x = (x & np.uint32(0x33333333)) + ((x >> np.uint32(2)) & np.uint32(0x33333333))
    x = (x + (x >> np.uint32(4))) & np.uint32(0x0F0F0F0F)
    return (x * np.uint32(0x01010101)) >> np.uint32(24)
