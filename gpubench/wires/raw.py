"""The raw 16w wire, the upstream's rANS32xN 16w file: the program's
`raw_encode_torch` with the whole input's histogram (`make_hist`), as a
user encodes with a static model, and `raw_decode_torch`; and the
benchmark's frozen codec of the same wire (`reference/raw.py`, its chain
in C).  A configuration gives `bits` and `lanes`."""

from __future__ import annotations

import numpy as np

from gpubench.reference import raw as ref


def encode(data: bytes, cfg: dict, device, layers) -> bytes:
    from hsrans_tpu_torch import make_hist, raw_encode_torch

    arr = np.frombuffer(data, np.uint8)
    return raw_encode_torch(arr, make_hist(arr, cfg["bits"]), cfg["lanes"], device=device, layers=layers)


def decode(blob: bytes, cfg: dict, device, layers) -> bytes | None:
    from hsrans_tpu_torch import raw_decode_torch

    return raw_decode_torch(blob, cfg["bits"], cfg["lanes"], device=device, layers=layers)


def ref_encode(data, cfg: dict, bits: int | None = None) -> bytes:
    return ref.encode(data, cfg["bits"] if bits is None else bits, cfg["lanes"])


def ref_decode(blob, cfg: dict, table_bits: int | None = None) -> bytes | None:
    return ref.decode(blob, cfg["bits"], cfg["lanes"], table_bits)


tables = ref.tables
