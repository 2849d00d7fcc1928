"""Data-parallel mt decode and encode over several devices: the port of
`hsrans_tpu/parallel/sharded.py`.

`mt_decode_device` keeps the JAX package's chain step for step: the mt
decode kernel (`mt_decode_torch`), then the native host decode
(`runtime/native.py`), then every coded block batched through the
scan decode kernel (`kernels/scan.py`) on the shared word stream.
`mt_encode_device` encodes every coded block from fresh states through
`kernels/mt_encode.py::encode_plan`: the mt encode kernel at n = 32 and 64,
the scan encode kernel at n = 16, one placement of the wire for both.
`shard_map` over a mesh axis becomes `devices=`, a list of torch devices:
the block batch is padded to a multiple of its length, each device takes
its contiguous share and runs the same kernels, and the outputs are
gathered in order, so the bytes are the same for every device count.
`uniform_plan` and `device_plan` are copies of the JAX package's on
the port's planner and tile histogram; the tests hold every function here
equal to its original.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..kernels.mt_decode import mt_decode_torch
from ..kernels.mt_encode import encode_plan
from ..kernels.scan import decode_section_kernel
from ..models.histogram import complete_hist
from ..models.tables import make_dec3
from ..ops.mt import MtBlock, _as_array, block_index
from ..ops.planner import BlockPlan, plan_blocks_py
from ..ops.tpx import make_tile_hist
from ..rans import IDX2IDX, INV_IDX2IDX
from ..runtime import native
from ..runtime.device import resolve_all, shares

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
    for r in plan_blocks_py(data, bits, "mt", n):
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


@dataclass
class BatchedBlocks:
    """Host-side SoA view of the coded blocks of an mt blob."""

    states: np.ndarray  # u32[B, n]
    read_pos: np.ndarray  # i32[B]
    sizes: np.ndarray  # i64[B] output bytes per block
    out_starts: np.ndarray  # i64[B]
    tab_sym: np.ndarray  # u8 [B, 2^bits]
    tab_freq: np.ndarray  # u16[B, 2^bits]
    tab_cumul: np.ndarray  # u16[B, 2^bits]
    max_steps: int


def gather_blocks(blocks: list[MtBlock], bits: int, n: int) -> BatchedBlocks | None:
    """The coded blocks' operands of the batched scan decode, each with its
    slot-indexed tables; None where there is no coded block or a block's
    freqs do not sum to 2^B."""
    coded = [b for b in blocks if not b.is_single]
    if not coded:
        return None
    nb = len(coded)
    t = 1 << bits
    out = BatchedBlocks(
        states=np.stack([b.states for b in coded]).astype(np.uint32),
        read_pos=np.asarray([b.word_start for b in coded], dtype=np.int32),
        sizes=np.asarray([b.size for b in coded], dtype=np.int64),
        out_starts=np.asarray([b.out_start for b in coded], dtype=np.int64),
        tab_sym=np.zeros((nb, t), dtype=np.uint8),
        tab_freq=np.zeros((nb, t), dtype=np.uint16),
        tab_cumul=np.zeros((nb, t), dtype=np.uint16),
        max_steps=int(max(-(-b.size // n) for b in coded)),
    )
    for i, b in enumerate(coded):
        hist = complete_hist(b.freq, bits)
        if hist is None:
            return None
        tabs = make_dec3(hist)
        out.tab_sym[i] = tabs["sym"]
        out.tab_freq[i] = tabs["freq"].astype(np.uint16)
        out.tab_cumul[i] = tabs["cumul"].astype(np.uint16)
    return out


def batch_operands(bb: BatchedBlocks, stream: np.ndarray, rows: slice, dev: torch.device) -> tuple[torch.Tensor, ...]:
    """The scan decode's operands of the batch's `rows` on `dev`: states,
    the shared stream, read positions, the three tables, the sizes as valid
    counts."""
    def on(a, dtype=None):
        t = torch.from_numpy(np.ascontiguousarray(a[rows]))
        return (t.view(dtype) if dtype is not None else t).to(dev)

    return (on(bb.states, torch.int32), torch.from_numpy(stream.view(np.int16)).to(dev), on(bb.read_pos),
            on(bb.tab_sym), on(bb.tab_freq, torch.int16), on(bb.tab_cumul, torch.int16), on(bb.sizes.astype(np.int32)))


def _decode_batched(bb: BatchedBlocks, stream: np.ndarray, bits: int, devices: list[torch.device]) -> np.ndarray:
    """The scan decode of every block of the batch, `tail` on and each
    block's size its valid count: the batch split over the devices
    (`shares`, as the JAX package pads it to a multiple of the mesh axis and
    shards it), one launch on each (the stream copied to every device), the
    symbols gathered in order; uint8 [B, max_steps, n] in lane order."""
    out = []
    for dev, lo, hi in shares(devices, bb.states.shape[0]):
        ops = batch_operands(bb, stream, slice(lo, hi), dev)
        syms, _, _ = decode_section_kernel(*ops, bits=bits, num_steps=bb.max_steps, tail=True)
        out.append(syms.cpu().numpy())
    return np.concatenate(out)


def scan_decode_blob(blob: bytes | np.ndarray, bits: int, n: int, devices: list[torch.device]) -> bytes | None:
    """The last step of mt_decode_device alone: the block index, every coded
    block batched through the scan decode on the shared stream, then the
    single-symbol blocks filled.  None where the header chain breaks or a
    coded block's freqs do not sum to 2^B (where the JAX package's
    `mt_decode_device` gives zeros for the coded blocks instead)."""
    idx = block_index(blob, n)
    if idx is None:
        return None
    length, stream, blocks = idx
    if length == 0:
        return b""
    bb = gather_blocks(blocks, bits, n)
    if bb is None and any(not b.is_single for b in blocks):
        return None
    out = np.zeros(length, dtype=np.uint8)
    if bb is not None:
        byte_mat = _decode_batched(bb, stream, bits, devices)[:, :, INV_IDX2IDX[n]].reshape(len(bb.sizes), -1)
        for i in range(len(bb.sizes)):
            size, start = int(bb.sizes[i]), int(bb.out_starts[i])
            out[start : start + size] = byte_mat[i, :size]
    for b in blocks:
        if b.is_single:
            out[b.out_start : b.out_start + b.size] = b.symbol
    return out.tobytes()


def mt_decode_device(
    blob: bytes | np.ndarray,
    bits: int,
    n: int,
    device: str | torch.device = "cuda",
    devices: list | None = None,
) -> bytes | None:
    """Decode an mt blob (n in {16, 32, 64}) on `device`, or split over
    `devices`; `hsrans_tpu.parallel.sharded.mt_decode_device`'s chain:

      (a) n of 32 or 64 and B <= 15: `mt_decode_torch`, if it gives bytes;
      (b) the native host decode (`runtime/native.py::mt_decode`, which
          refuses n = 16 and B outside 10..15), if it gives bytes;
      (c) `scan_decode_blob`: every coded block batched through the scan
          decode kernel.

    Equal to the JAX function's bytes, but None where a coded block's freqs
    do not sum to 2^B, as the host decoders give, where the JAX function
    returns the coded blocks as zeros."""
    devs = resolve_all(device, devices)
    if n in (32, 64) and bits <= 15:
        fast = mt_decode_torch(blob, bits, n, devices=devs)
        if fast is not None:
            return fast
    host = native.mt_decode(blob, bits, n)
    if host is not None:
        return host
    return scan_decode_blob(blob, bits, n, devs)


def mt_encode_device(
    data: bytes | np.ndarray,
    bits: int,
    n: int,
    plan: list[BlockPlan] | None = None,
    uniform_block: int | None = None,
    device: str | torch.device = "cuda",
    devices: list | None = None,
) -> bytes:
    """Encode to the mt wire (n in {16, 32, 64}) with every coded block
    encoded from fresh states on `device`, or split over `devices`; equal
    to the JAX package's `mt_encode_device(data, bits, n, mesh=...,
    plan=plan, uniform_block=uniform_block)` for every mesh, through
    `encode_plan`: the mt encode kernel at n = 32 and 64, the scan encode
    kernel at n = 16, then the placement kernel.  Without `plan`:
    `uniform_plan` blocks of `uniform_block` bytes if it is given, else the
    reference planner's."""
    devs = resolve_all(device, devices)
    if n not in IDX2IDX or not 1 <= bits <= 15:
        raise ValueError("mt encode needs n in (16, 32, 64) and 1 <= bits <= 15")
    arr = _as_array(data)
    if plan is None:
        plan = uniform_plan(arr, bits, n, uniform_block) if uniform_block else plan_blocks_py(arr, bits, "mt", n)
    return encode_plan(arr, plan, bits, n, "section", devs)
