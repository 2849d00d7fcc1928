"""The mt wire at 16 states in the program's device layout: each object
planned by the program's `parallel.sharded.device_plan` (the reference's
greedy planner, coded blocks cut to `max_block`) and encoded by
`mt_encode_device` with that plan, decoded by `mt_decode_device` (at 16
states, its batched scan decode); and the benchmark's frozen NumPy planner
and 16-state codec of the same layout and wire.  A configuration gives
`bits`, `lanes` (16) and `max_block`.

An encode call is the plan and the encode, as a user encodes: with
`layers`, the plan's seconds go under the key `plan` beside the
program's own layer clocks."""

from __future__ import annotations

import time

import numpy as np

from gpubench.reference import mt16 as ref
from gpubench.reference import planner


def encode(data: bytes, cfg: dict, device, layers) -> bytes:
    from hsrans_tpu_torch.parallel.sharded import device_plan, mt_encode_device

    arr = np.frombuffer(data, np.uint8)
    t0 = time.perf_counter()
    plan = device_plan(arr, cfg["bits"], cfg["lanes"], cfg["max_block"])
    if layers is not None:
        layers["plan"] = layers.get("plan", 0.0) + time.perf_counter() - t0
    return mt_encode_device(arr, cfg["bits"], cfg["lanes"], plan=plan, device=device, layers=layers)


def decode(blob: bytes, cfg: dict, device, layers) -> bytes | None:
    from hsrans_tpu_torch.parallel.sharded import mt_decode_device

    return mt_decode_device(blob, cfg["bits"], cfg["lanes"], device=device, layers=layers)


def ref_encode(data, cfg: dict, bits: int | None = None) -> bytes:
    bits = cfg["bits"] if bits is None else bits
    arr = np.frombuffer(data, np.uint8)
    return ref.encode(arr, bits, planner.device_layout(arr, bits, cfg["lanes"], cfg["max_block"]))


def ref_decode(blob, cfg: dict, table_bits: int | None = None) -> bytes | None:
    return ref.decode(blob, cfg["bits"], table_bits)


tables = ref.tables
