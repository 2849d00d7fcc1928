"""tpx decode: the port of `hsrans_tpu/kernels/tpx_decode.py` to PyTorch and
CUDA (`csrc/tpx_decode.cu`).

The host tier (parse, per-tile tables, wire layout) is the port's numpy copy
in `..ops.tpx` and `..models.histogram`; the megablock decode runs here, as
the CUDA kernel on a CUDA tensor or as its plain PyTorch version on a CPU
tensor.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.histogram import complete_hist, make_cumul_inv
from ..ops.tpx import L, tpx_parse
from ..runtime import build
from ..runtime.device import layer_clock, resolve

_M32 = 0xFFFFFFFF


def to_u32(x: torch.Tensor) -> torch.Tensor:
    """int32 storage of u32 values -> int64 holding the unsigned value (the
    plain versions' state type: CPU UInt32 has no shifts or compares)."""
    return x.to(torch.int64) & _M32


def from_u32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding u32 values -> int32 storage of the same bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def dec_tables(freqs: np.ndarray, bits: int) -> tuple[np.ndarray, np.ndarray] | None:
    """Per-tile decode tables from wire freqs [T, 256]: slot -> symbol
    u8[T, 2^B] and freq | cumul << 16 as int32 [T, 256].  None if a tile's
    freqs do not sum to 2^B (a malformed blob)."""
    n_tiles = freqs.shape[0]
    sym = np.empty((n_tiles, 1 << bits), np.uint8)
    fc = np.empty((n_tiles, 256), np.uint32)
    for t in range(n_tiles):
        hist = complete_hist(freqs[t], bits)
        if hist is None:
            return None
        sym[t] = make_cumul_inv(hist)
        fc[t] = hist.symbol_count.astype(np.uint32) | (hist.cumul.astype(np.uint32) << np.uint32(16))
    return sym, fc.view(np.int32)


def decode_mega_plain(stream, states, symtab, fctab, *, bits: int, steps: int, vlen: int) -> torch.Tensor:
    """Plain PyTorch version of the decode kernel, on any device.

    stream int32 [T, R, W] (u32 slots), states int32 [R, 128], symtab uint8
    [T, 2^B], fctab int32 [T, 256] -> int32 [T, R, S/4 * 128]: one u32 per
    (tile, row, step group, lane) holding the group's four symbols, which is
    the megablock's bytes in wire order.  Positions >= vlen keep their state
    and decode to 0."""
    n_tiles, rows, w_slots = stream.shape
    dev = stream.device
    s4c = steps // 4
    mask = (1 << bits) - 1
    st = to_u32(states)
    lane = torch.arange(L, device=dev)
    row = torch.arange(rows, device=dev)[:, None]
    out = torch.zeros((n_tiles, rows, s4c, L), dtype=torch.int64, device=dev)
    for t in range(n_tiles):
        sym_of = symtab[t].to(torch.int64)
        fc = to_u32(fctab[t])
        freq_of, cum_of = fc & 0xFFFF, fc >> 16
        srow = to_u32(stream[t])
        rw = torch.zeros((rows, 1), dtype=torch.int64, device=dev)
        base_pos = ((t * rows + row) * s4c * L + lane) * 4
        for s in range(4 * _groups_with_data(vlen, t * rows, s4c)):
            slot = st & mask
            sym = sym_of[slot]
            valid = base_pos + ((s // 4) * L * 4 + s % 4) < vlen
            new = ((st >> bits) * freq_of[sym] + slot - cum_of[sym]) & _M32
            st = torch.where(valid, new, st)
            consume = (st < (1 << 15)) & valid
            c = consume.to(torch.int64)
            widx = rw + torch.cumsum(c, dim=1) - c  # lane-ascending consume order
            v = torch.gather(srow, 1, torch.clamp(widx >> 1, max=w_slots - 1))
            word = (v >> ((widx & 1) * 16)) & 0xFFFF
            st = torch.where(consume, ((st << 16) | word) & _M32, st)
            rw = rw + c.sum(dim=1, keepdim=True)
            out[t, :, s // 4] |= torch.where(valid, sym, 0) << (8 * (s % 4))
    return from_u32(out.reshape(n_tiles, rows, s4c * L))


def _groups_with_data(vlen: int, row_id: int, s4c: int) -> int:
    """Step groups of row `row_id` (= t * R + r) that hold a position below
    vlen: past them no state changes and every byte is 0."""
    return max(0, min(s4c, -(-(vlen - row_id * s4c * L * 4) // (L * 4))))


def decode_mega_cuda(stream, states, symtab, fctab, *, bits: int, steps: int, vlen: int) -> torch.Tensor:
    """The CUDA kernel (`csrc/tpx_decode.cu`) on CUDA tensors; same contract
    as decode_mega_plain.  Raises for any other tensor."""
    dev = build.check_cuda("decode_mega_cuda", stream, states, symtab, fctab, uint8=(2,))
    n_tiles, rows, w_slots = stream.shape
    if (
        steps % 4
        or states.shape != (rows, L)
        or symtab.shape != (n_tiles, 1 << bits)
        or fctab.shape != (n_tiles, 256)
    ):
        raise ValueError("decode_mega_cuda: operand shapes do not match the megablock geometry")
    out = torch.empty((n_tiles, rows, steps // 4 * L), dtype=torch.int32, device=dev)
    if out.numel():
        build.launch(
            "tpx_decode", "hsr_tpx_decode", dev,
            stream.data_ptr(), states.data_ptr(), symtab.data_ptr(), fctab.data_ptr(), out.data_ptr(),
            rows, steps, n_tiles, w_slots, bits, int(vlen),
        )
    return out


def decode_mega(stream, states, symtab, fctab, *, bits: int, steps: int, vlen: int) -> torch.Tensor:
    """The kernel for CUDA operands, its plain version for CPU operands."""
    fn = decode_mega_plain if stream.device.type == "cpu" else decode_mega_cuda
    return fn(stream, states, symtab, fctab, bits=bits, steps=steps, vlen=vlen)


def tpx_decode_torch(
    blob: bytes | np.ndarray, device: str | torch.device = "cuda", layers: dict[str, float] | None = None
) -> bytes | None:
    """Decode a tpx blob (v1, v2 or v3 wire) on `device`; None if malformed.

    With `layers`, adds the seconds of each layer of this call to it
    (host_parse, host_tables, h2d, kernel, d2h, host_assemble), the device
    synchronized at each boundary."""
    dev = resolve(device)
    with layer_clock(layers, "host_parse", dev):
        parsed = tpx_parse(blob)
    if parsed is None:
        return None
    p, length, megas = parsed
    if p.lanes != L:
        return None
    out = np.zeros(length, dtype=np.uint8)
    for mega in megas:
        with layer_clock(layers, "host_tables", dev):
            tabs = dec_tables(mega.freqs, p.bits)
        if tabs is None:
            return None
        vlen = min(length - mega.base, mega.span)
        # tiles wholly past the data change no state and write no byte
        n_tiles = min(mega.n_tiles, -(-vlen // (mega.rows * mega.steps * L)))
        if n_tiles <= 0:
            continue
        sym, fc = tabs
        with layer_clock(layers, "h2d", dev):
            ops = (
                torch.from_numpy(mega.stream[:n_tiles].view(np.int32)).to(dev),
                torch.from_numpy(mega.states.view(np.int32)).to(dev),
                torch.from_numpy(sym[:n_tiles]).to(dev),
                torch.from_numpy(np.ascontiguousarray(fc[:n_tiles])).to(dev),
            )
        with layer_clock(layers, "kernel", dev):
            packed = decode_mega(*ops, bits=p.bits, steps=mega.steps, vlen=vlen)
        with layer_clock(layers, "d2h", dev):
            mega_bytes = packed.cpu().numpy().reshape(-1).view(np.uint8)
        with layer_clock(layers, "host_assemble", dev):
            n_valid = min(vlen, mega_bytes.size)
            out[mega.base : mega.base + n_valid] = mega_bytes[:n_valid]
    with layer_clock(layers, "host_assemble", dev):
        return out.tobytes()
