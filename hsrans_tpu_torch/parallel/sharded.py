"""Block plans of the mt wire made for a batched device decoder, and the
batched device encoder of `hsrans_tpu/parallel/sharded.py`.

The port's copy of `uniform_plan` and `device_plan` from
`hsrans_tpu/parallel/sharded.py`, on the port's planner and tile histogram,
so that the port loads no module of the JAX package;
`tests/test_torch_mt_decode.py` holds the plans equal.  Any segmentation is
valid on the wire, so both plans' blobs stay decodable by the reference.
`mt_encode_device` is the port of its namesake on one device (its XLA scan
becomes the mt encode kernel); the mesh fan-out is still to port.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.mt_encode import encode_plan
from ..ops.mt import _as_array
from ..ops.planner import BlockPlan, plan_blocks_mt
from ..ops.tpx import make_tile_hist
from ..runtime.device import resolve


def uniform_plan(data: np.ndarray, bits: int, n: int, block_size: int = 1 << 16) -> list[BlockPlan]:
    """Fixed-size segmentation: every coded block has the same size, the
    last one takes the remainder."""
    length = data.size
    starts = list(range(0, length, block_size))
    # the trailing partial lane group must belong to the last block's chain
    # (the decoder's tail continues the last block's stream), so a remainder
    # shorter than n joins the final block rather than getting its own
    if len(starts) > 1 and length - starts[-1] < n:
        starts.pop()
    rows = []
    for i, start in enumerate(starts):
        end = starts[i + 1] if i + 1 < len(starts) else length
        freq = make_tile_hist(data[start:end], bits).symbol_count
        rows.append(BlockPlan(start, end - start, False, 0, freq))
    return rows


def device_plan(data: np.ndarray, bits: int, n: int = 64, max_block: int = 32 << 10) -> list[BlockPlan]:
    """The reference's greedy plan with coded blocks capped at `max_block`.

    The greedy planner coalesces homogeneous spans into blocks of up to
    2^25 bytes, which leaves a batched decoder few independent chains.  This
    keeps its content cuts and its single-symbol rows and splits each
    oversized coded block into 512-aligned pieces; consecutive piece pairs
    share one histogram taken over their joint span."""
    out: list[BlockPlan] = []
    for r in plan_blocks_mt(data, bits, n):
        if r.is_single or r.size <= max_block:
            out.append(r)
            continue
        n_pieces = -(-r.size // max_block)
        base = r.size // n_pieces // 512 * 512
        if base == 0:
            out.append(r)
            continue
        starts = [r.start + i * base for i in range(n_pieces)]
        ends = starts[1:] + [r.start + r.size]
        for p in range(0, n_pieces, 2):
            s0, e_last = starts[p], ends[min(p + 1, n_pieces - 1)]
            freq = make_tile_hist(data[s0:e_last], bits).symbol_count
            for s, e in zip(starts[p : p + 2], ends[p : p + 2]):
                out.append(BlockPlan(s, e - s, False, 0, freq))
    return out


def mt_encode_device(
    data: bytes | np.ndarray,
    bits: int,
    n: int,
    plan: list[BlockPlan] | None = None,
    uniform_block: int | None = None,
    device: str | torch.device = "cuda",
) -> bytes:
    """Encode to the mt wire (n in {32, 64}) with every coded block encoded
    from fresh states on `device`; equal to the JAX package's
    `mt_encode_device(data, bits, n, mesh=None, plan=plan,
    uniform_block=uniform_block)`.  Without `plan`: `uniform_plan` blocks of
    `uniform_block` bytes if it is given, else the reference planner's."""
    dev = resolve(device)
    arr = _as_array(data)
    if plan is None:
        plan = uniform_plan(arr, bits, n, uniform_block) if uniform_block else plan_blocks_mt(arr, bits, n)
    return encode_plan(arr, plan, bits, n, "section", dev)
