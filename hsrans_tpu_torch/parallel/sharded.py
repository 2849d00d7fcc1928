"""Data-parallel mt decode and encode over several devices: the port of
`hsrans_tpu/parallel/sharded.py`.

`mt_decode_device` keeps the JAX package's chain step for step: the mt
decode kernel (`mt_decode_torch`), then the native host decode
(`runtime/native.py`), then every coded block batched through the
scan decode kernel (`kernels/scan.py`) on the shared word stream, each
symbol stored at its output byte.
`mt_encode_device` encodes every coded block from fresh states through
`kernels/mt_encode.py::encode_plan`: the mt encode kernel at n = 32 and 64,
the scan encode kernel at n = 16, one placement of the wire for both.
`shard_map` over a mesh axis becomes `devices=`, a list of torch devices,
or a nested list of hosts x cards for the JAX package's two-level ("dcn",
"ici") axis, flattened host-major (`runtime/device.py::flatten_devices`):
the block batch is padded to a multiple of its length, each device takes
its contiguous share and runs the same kernels, and the outputs are
gathered in order, so the bytes are the same for every device count.
`uniform_plan` and `device_plan` are copies of the JAX package's on
the port's planner and tile histogram (`device_plan` on the native runtime's
planner and span histograms); the tests hold every function here equal to
its original.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..kernels.mt_decode import mt_decode_torch
from ..kernels.mt_encode import encode_plan
from ..models.histogram import complete_hist
from ..models.tables import make_dec3
from ..ops.mt import MtBlock, _as_array, block_index
from ..ops.planner import BlockPlan, plan_blocks
from ..ops.raw_scan import decode_placed
from ..ops.tpx import make_tile_hist
from ..rans import IDX2IDX
from ..runtime import native
from ..runtime.device import Output, entry_span, flatten_devices, layer_clock, resolve_all, shares, span, to_card

# mt_decode_device's calls by the route that answered ("none": no route
# did), and route (c)'s coded and single-symbol blocks, the bytes of the
# per-block tables it uploaded and the coded blocks' bytes that the scan
# decode wrote straight to their place in the output (all of them)
MT_DEVICE_COUNTS: dict[str, int] = {"a": 0, "b": 0, "c": 0, "none": 0, "coded": 0, "single": 0, "table_bytes": 0,
                                    "placed_bytes": 0}


def axis_size(devices) -> int:
    """The number of devices a call splits over: 1 for None or an empty
    list, else the length of the flat list or of the nested hosts x cards
    one flattened (the JAX package's `axis_size` over one mesh axis name or
    a ("dcn", "ici") tuple)."""
    return len(flatten_devices(devices)) or 1


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


@entry_span
def device_plan(data: np.ndarray, bits: int, n: int = 64, max_block: int = 32 << 10) -> list[BlockPlan]:
    """The reference's greedy plan with coded blocks capped at `max_block`.

    The greedy planner coalesces homogeneous spans into blocks of up to
    2^25 bytes, which leaves a batched decoder few independent chains.  This
    keeps its content cuts and its single-symbol rows and splits each
    oversized coded block into 512-aligned pieces; consecutive piece pairs
    share one histogram taken over their joint span, all pairs' histograms
    taken in one threaded native call."""
    with span("plan_greedy"):
        rows = plan_blocks(data, bits, "mt", n)
    out: list[BlockPlan] = []
    pair_of: list[int] = []  # for each row of `out`, the pair whose histogram it takes, or -1
    pairs: list[tuple[int, int]] = []
    for r in rows:
        n_pieces = -(-r.size // max_block)
        base = r.size // n_pieces // 512 * 512
        if r.is_single or r.size <= max_block or base == 0:
            out.append(r)
            pair_of.append(-1)
            continue
        starts = [r.start + i * base for i in range(n_pieces)]
        ends = starts[1:] + [r.start + r.size]
        for p in range(0, n_pieces, 2):
            pairs.append((starts[p], ends[min(p + 1, n_pieces - 1)]))
            for s, e in zip(starts[p : p + 2], ends[p : p + 2]):
                out.append(BlockPlan(s, e - s, False, 0, None))
                pair_of.append(len(pairs) - 1)
    with span("plan_hist"):
        freqs = native.hist_spans(data, pairs, bits)
    for row, p in zip(out, pair_of):
        if p >= 0:
            row.freq = freqs[p]
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
    return tuple(to_card(a, dev) for a in (bb.states[rows], stream, bb.read_pos[rows], bb.tab_sym[rows],
                                           bb.tab_freq[rows], bb.tab_cumul[rows], bb.sizes[rows].astype(np.int32)))


def placed_operands(bb: BatchedBlocks, stream: np.ndarray, rows: slice,
                    dev: torch.device) -> tuple[tuple[torch.Tensor, ...], torch.Tensor, int, int]:
    """The placed scan decode's operands of the batch's `rows` on `dev`:
    batch_operands, the rows' output starts (int64) from the first row's,
    and the output range [first, end) the rows code (block outputs ascend
    and do not overlap)."""
    first, end = int(bb.out_starts[rows][0]), int((bb.out_starts[rows] + bb.sizes[rows]).max())
    return batch_operands(bb, stream, rows, dev), to_card(bb.out_starts[rows] - first, dev), first, end


def _decode_batched(bb: BatchedBlocks, stream: np.ndarray, bits: int, devices: list[torch.device], out: Output,
                    layers: dict[str, float] | None = None) -> None:
    """The scan decode of every block of the batch into `out`, `tail` on and
    each block's size its valid count: the batch split over the devices
    (`shares`, as the JAX package pads it to a multiple of the mesh axis and
    shards it), one launch on each (the stream copied to every device).
    The share's blocks code the bytes [first, end) of the output (block
    outputs ascend and do not overlap): the launch stores each symbol at its
    byte of a buffer of that range on its device, which is copied to its
    place in `out`.  The bytes between the share's blocks (single-symbol
    blocks) are left for the caller to write after."""
    for dev, lo, hi in shares(devices, bb.states.shape[0]):
        with layer_clock(layers, "h2d", dev):
            ops, starts, first, end = placed_operands(bb, stream, slice(lo, hi), dev)
        MT_DEVICE_COUNTS["table_bytes"] += sum(t.numel() * t.element_size() for t in ops[3:6])
        with layer_clock(layers, "kernel_scan", dev):
            buf = torch.empty(end - first, dtype=torch.uint8, device=dev)
            decode_placed(*ops, starts, buf, bits=bits, num_steps=bb.max_steps, tail=True)
        with layer_clock(layers, "d2h", dev):
            out.put(first, buf)
        MT_DEVICE_COUNTS["placed_bytes"] += int(bb.sizes[lo:hi].sum())


def scan_decode_blob(blob: bytes | np.ndarray, bits: int, n: int, devices: list[torch.device],
                     layers: dict[str, float] | None = None) -> bytes | None:
    """The last step of mt_decode_device alone: the block index, every coded
    block batched through the scan decode on the shared stream, each symbol
    stored by the kernel at its byte of the share's output range and each
    range copied once to its place, then the single-symbol blocks filled.
    None where the header chain breaks or a coded block's freqs do not sum
    to 2^B (where the JAX package's `mt_decode_device` gives zeros for the
    coded blocks instead).  With `layers`, the seconds of host_index (the
    header walk), host_tables (each coded block's tables), h2d, kernel_scan,
    d2h and host_assemble (the output's creation, the single-symbol fills
    and its close)."""
    dev = devices[0]
    with layer_clock(layers, "host_index", dev):
        idx = block_index(blob, n)
    if idx is None:
        return None
    length, stream, blocks = idx
    if length == 0:
        return b""
    with layer_clock(layers, "host_tables", dev):
        bb = gather_blocks(blocks, bits, n)
    singles = [b for b in blocks if b.is_single]
    if bb is None and len(singles) < len(blocks):
        return None
    MT_DEVICE_COUNTS["coded"] += len(blocks) - len(singles)
    MT_DEVICE_COUNTS["single"] += len(singles)
    with layer_clock(layers, "host_assemble", dev):
        out = Output(length)
    with out:
        if bb is not None:
            _decode_batched(bb, stream, bits, devices, out, layers)
        with layer_clock(layers, "host_assemble", dev):
            for b in singles:
                out.part(b.out_start, b.out_start + b.size)[:] = b.symbol
            out.close()
    return out.result


@entry_span
def mt_decode_device(
    blob: bytes | np.ndarray,
    bits: int,
    n: int,
    device: str | torch.device = "cuda",
    devices: list | None = None,
    layers: dict[str, float] | None = None,
) -> bytes | None:
    """Decode an mt blob (n in {16, 32, 64}) on `device`, or split over
    `devices`; `hsrans_tpu.parallel.sharded.mt_decode_device`'s chain:

      (a) n of 32 or 64 and B <= 15: `mt_decode_torch`, if it gives bytes;
      (b) n of 32 or 64 and B in 10..15: the native host decode
          (`runtime/native.py::mt_decode`, which refuses every other n and
          B), if it gives bytes;
      (c) `scan_decode_blob`: every coded block batched through the scan
          decode kernel.

    Equal to the JAX function's bytes, but None where a coded block's freqs
    do not sum to 2^B, as the host decoders give, where the JAX function
    returns the coded blocks as zeros.  Each call counts its route in
    `MT_DEVICE_COUNTS` ("none" where it gives None).  With `layers`, adds
    the seconds of each layer of this call to it: route (a)'s
    (`mt_decode_torch`'s), and route (c)'s (`scan_decode_blob`'s)."""
    devs = resolve_all(device, devices)
    out = None
    if n in (32, 64) and bits <= 15:
        out, route = mt_decode_torch(blob, bits, n, devices=devs, layers=layers), "a"
    if out is None and n in (32, 64) and 10 <= bits <= 15:
        out, route = native.mt_decode(blob, bits, n), "b"
    if out is None:
        out, route = scan_decode_blob(blob, bits, n, devs, layers), "c"
    MT_DEVICE_COUNTS["none" if out is None else route] += 1
    return out


@entry_span
def mt_encode_device(
    data: bytes | np.ndarray,
    bits: int,
    n: int,
    plan: list[BlockPlan] | None = None,
    uniform_block: int | None = None,
    device: str | torch.device = "cuda",
    devices: list | None = None,
    layers: dict[str, float] | None = None,
) -> bytes:
    """Encode to the mt wire (n in {16, 32, 64}) with every coded block
    encoded from fresh states on `device`, or split over `devices`; equal
    to the JAX package's `mt_encode_device(data, bits, n, mesh=...,
    plan=plan, uniform_block=uniform_block)` for every mesh, through
    `encode_plan`: the mt encode kernel at n = 32 and 64, the scan encode
    kernel at n = 16, then the placement kernel.  Without `plan`:
    `uniform_plan` blocks of `uniform_block` bytes if it is given, else the
    reference planner's.  With `layers`, adds the seconds of each layer of
    `encode_plan` to it."""
    devs = resolve_all(device, devices)
    if n not in IDX2IDX or not 1 <= bits <= 15:
        raise ValueError("mt encode needs n in (16, 32, 64) and 1 <= bits <= 15")
    arr = _as_array(data)
    if plan is None:
        plan = uniform_plan(arr, bits, n, uniform_block) if uniform_block else plan_blocks(arr, bits, "mt", n)
    return encode_plan(arr, plan, bits, n, "section", devs, layers)
