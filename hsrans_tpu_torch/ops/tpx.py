"""The tpx wire on the host: geometry, header, per-tile histograms, mega
writer and parser.

The port's copy of the jax-free host tier of `hsrans_tpu/ops/tpx.py` (the
wire format is documented there), so that the port loads no module of the
JAX package.  Only what the port's encoders and decoder use is here; the
numpy encoders and decoder stay in the original, which the tests hold the
port against.  `tests/test_torch_host_tier.py` holds each function here
equal to its original.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..models.histogram import Hist, normalize_hist, observe_hist

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
    """Per-region geometry of the v3 wire: each run of similarly-sized
    planner blocks becomes one megablock whose tile span tracks the block
    size, with rows x steps from the table below (span = rows*steps*128).

      region block size   tile span   rows x steps
      >= 4 MiB              4 MiB     1024 x 32
      >= 1 MiB              1 MiB     1024 x 8
      >= 256 KiB          256 KiB      256 x 8
      else                128 KiB      128 x 8
    """
    from .planner import plan_blocks_py

    length = arr.size
    if length == 0:
        return [MegaGeom(0, 8, 4, 1)]
    plan = plan_blocks_py(arr, bits, "mt", 64)

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


def tpx_header(length: int, p: TpxParams) -> bytearray:
    """v2 wire header; the total length at [16:24] is filled in last."""
    out = bytearray()
    out += MAGIC2
    out += length.to_bytes(8, "little")
    out += b"\0" * 8
    for v in (p.bits, p.rows, p.lanes, p.steps, p.tiles):
        out += int(v).to_bytes(4, "little")
    return out


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
