"""The yardstick of the kernels: the card's published peaks and the bytes a
codec call must move, counted from the sizes of its object and its blob,
whatever kernels the program runs for it.

A call reads its input once and writes its output once (a decode: the blob
in, the raw bytes out; an encode: the raw bytes in, the blob out), and reads
one frequency table of 256 u32 entries a tile or block once.  The least
time the card could take is those bytes over its memory bandwidth; the
codecs do a few integer operations a byte, far below the card's integer
rate, so bytes bound them.
"""

from __future__ import annotations

TABLE_BYTES = 256 * 4

# NVIDIA H100 data sheet, SXM part: 3.35 TB/s of HBM3, at a power limit of 700 W
PEAK_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}


def call_bytes(raw_bytes: int, blob_bytes: int, tables: int) -> int:
    """Bytes one encode or decode call must move: raw and blob bytes once
    each, and its tables once."""
    return raw_bytes + blob_bytes + tables * TABLE_BYTES


def least_seconds(nbytes: int, device_kind: str) -> float | None:
    """The least time `nbytes` take at the card's published bandwidth;
    None for a card not in the table."""
    peak = PEAK_BYTES_PER_S.get(device_kind)
    return nbytes / peak if peak else None
