"""The tpx v2 wire: the program's `tpx_encode_torch` and `tpx_decode_torch`,
and the benchmark's frozen NumPy codec of the same wire.  A configuration
gives `bits`."""

from __future__ import annotations

from gpubench.reference import tpx as ref


def encode(data: bytes, cfg: dict, device, layers) -> bytes:
    from hsrans_tpu_torch import tpx_encode_torch

    return tpx_encode_torch(data, cfg["bits"], device=device, layers=layers)


def decode(blob: bytes, cfg: dict, device, layers) -> bytes | None:
    from hsrans_tpu_torch import tpx_decode_torch

    return tpx_decode_torch(blob, device=device, layers=layers)


def ref_encode(data, cfg: dict, bits: int | None = None) -> bytes:
    return ref.encode(data, cfg["bits"] if bits is None else bits)


def ref_decode(blob, cfg: dict, table_bits: int | None = None) -> bytes:
    return ref.decode(blob, table_bits)


tables = ref.tables
