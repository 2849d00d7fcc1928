"""tpx encode and decode with the megablocks split over several devices: the
port of `hsrans_tpu/parallel/tpx_sharded.py`.

tpx megablocks are self-contained (own state snapshots, per-tile
histograms, rows' own streams), so where the JAX package shards the mega
axis over a mesh with `shard_map`, `tpx_encode_torch` and `tpx_decode_torch`
take `devices=` (a flat list, or a nested list of hosts x cards for the JAX
package's ("dcn", "ici") axis tuple, flattened host-major): each device
takes a contiguous share of the megas
(`runtime/device.py::shares`) through the same one-launch kernels, and the
sections and the decoded bytes are gathered in order, so the bytes are the
same for every device count.  The functions here keep the JAX package's
names and defaults.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.tpx_decode import tpx_decode_torch
from ..kernels.tpx_encode import tpx_encode_torch
from ..ops.tpx import TpxParams


def tpx_decode_device(blob: bytes | np.ndarray, device: str | torch.device = "cuda", devices: list | None = None) -> bytes | None:
    """Decode a tpx blob (v1, v2 or v3 wire) with its megablocks split over
    `devices` (or on `device`); None if malformed.  The bytes of
    `tpx_decode_torch`, which follows the numpy authority: it takes any row
    and step count, where the JAX package's `tpx_decode_device` gives None
    unless rows % 8 == 0, rows >= 8, steps % 4 == 0 and 2^B / 32 <= 1024."""
    return tpx_decode_torch(blob, device=device, devices=devices)


def tpx_encode_device(
    data: bytes | np.ndarray,
    bits: int = 12,
    p: TpxParams | None = None,
    device: str | torch.device = "cuda",
    devices: list | None = None,
) -> bytes:
    """tpx encode with the megablocks split over `devices` (or on
    `device`); bit-identical to `hsrans_tpu.ops.tpx.tpx_encode` and to the
    JAX package's `tpx_encode_device` for every mesh.  Without `p`, the
    JAX function's default geometry `TpxParams(bits)`."""
    return tpx_encode_torch(data, bits, p or TpxParams(bits=bits), device=device, devices=devices)
