"""tpx decode: the port of `hsrans_tpu/kernels/tpx_decode.py` to PyTorch and
CUDA (`csrc/tpx_decode.cu`).

The host tier (parse, per-tile tables, wire layout) is the port's numpy copy
in `..ops.tpx`; the decode runs here, every megablock of the blob in one
call, as the CUDA kernel on CUDA tensors or as its plain PyTorch version on
CPU tensors.  The blob goes to the device as it is: each row's slots are
read where the ragged v2/v3 wire keeps them, so no rectangular [T, R, W]
stream is built.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.mt import _as_array
from ..ops.tpx import L, TpxMega, tpx_parse
from ..runtime import build
from ..runtime.device import layer_clock, resolve_all, shares

_M32 = 0xFFFFFFFF
WARPS = 4  # rows (one warp each) of a CTA: csrc/tpx_common.cuh kWarps
# columns of the int64 per-mega descriptor; csrc/tpx_decode.cu::DecodeMega
DECODE_FIELDS = ("cta0", "rows", "steps", "n_tiles", "w_slots", "slot_off", "row0", "tab0", "state0", "out_base", "vlen")


def to_u32(x: torch.Tensor) -> torch.Tensor:
    """int32 storage of u32 values -> int64 holding the unsigned value (the
    plain versions' state type: CPU UInt32 has no shifts or compares)."""
    return x.to(torch.int64) & _M32


def from_u32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding u32 values -> int32 storage of the same bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def dec_tables(freqs: np.ndarray, bits: int) -> tuple[np.ndarray, np.ndarray] | None:
    """Decode tables of every tile from wire freqs [T, 256] (all megas'
    tiles stacked): slot -> symbol u8 [T, 2^B] and freq | cumul << 16 as
    int32 [T, 256].  None if a tile's freqs do not sum to 2^B (a malformed
    blob)."""
    f = freqs.astype(np.int64)
    if (f.sum(axis=1) != 1 << bits).any():
        return None
    sym = np.repeat(np.tile(np.arange(256, dtype=np.uint8), len(f)), f.reshape(-1)).reshape(len(f), 1 << bits)
    fc = f | (np.cumsum(f, axis=1) - f) << 16
    return sym, fc.astype(np.uint32).view(np.int32)


def decode_operands(megas: list[TpxMega], length: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host side of the one-call decode of a parsed blob: (desc int64 [M, 11]
    (DECODE_FIELDS), row starts int64, states u32 [sum rows, 128]) for the M
    megas that hold data, their tiles wholly past it left out.  tab0 counts
    the tiles of every mega, as `dec_tables` stacks them."""
    desc, starts, states = [], [], []
    cta = row0 = tab0 = state0 = 0
    for m in megas:
        vlen = min(length - m.base, m.span)
        n_tiles = min(m.n_tiles, -(-vlen // (m.rows * m.steps * L)))
        if n_tiles > 0:
            desc.append((cta, m.rows, m.steps, n_tiles, m.w_slots, m.slot_off, row0, tab0, state0, m.base, vlen))
            starts.append(m.row_start)
            states.append(m.states)
            cta += -(-m.rows // WARPS)
            row0 += m.row_start.size
            state0 += m.rows
        tab0 += m.n_tiles
    return (
        np.array(desc, np.int64).reshape(-1, len(DECODE_FIELDS)),
        np.concatenate(starts) if starts else np.zeros(0, np.int64),
        np.concatenate(states) if states else np.zeros((0, L), np.uint32),
    )


def _check_desc(name: str, desc: np.ndarray, out_len: int, n_states: int, n_tabs: int) -> None:
    """Every mega's states and tables lie inside the operands, and the
    megas' outputs tile the output: each starts where the previous one's
    vlen bytes end, and the last one's u32 ends the output."""
    cta0, rows, steps, n_tiles, w_slots, _, _, tab0, state0, out_base, vlen = desc.T
    span = rows * n_tiles * steps * L
    if (
        (steps % 4).any() or (rows < 1).any() or (n_tiles < 1).any() or (w_slots < 1).any()
        or (vlen < 0).any() or (vlen > span).any() or (out_base != np.cumsum(vlen) - vlen).any()
        or (out_base % 4).any() or out_len != -(-int(vlen.sum()) // 4) * 4
        or (state0 + rows > n_states).any() or (tab0 + n_tiles > n_tabs).any()
        or (cta0 != np.cumsum(-(-rows // WARPS)) - -(-rows // WARPS)).any()
    ):
        raise ValueError(f"{name}: a mega descriptor does not fit the operands")


def decode_mega_plain(blob, desc, row_start, states, symtab, fctab, *, bits: int, out_len: int) -> torch.Tensor:
    """Plain PyTorch version of the decode kernel, on any device.

    blob uint8 [nbytes] (the whole blob), desc int64 [M, 11] host array
    (DECODE_FIELDS), row_start int64, states int32 [sum rows, 128] (u32
    bits), symtab uint8 [sum tiles, 2^B], fctab int32 [sum tiles, 256] ->
    uint8 [out_len]: mega m's decoded bytes in wire order at out_base, its
    first vlen positions decoded and the rest of the u32 that holds the last
    one 0 (the megas' outputs tile the output, `_check_desc`).  Row (t, r)
    of a mega (i = t * rows + r) owns sc = row_start[row0 + i + 1] -
    row_start[row0 + i] u32 slots at blob byte slot_off + 4 *
    row_start[row0 + i]; its u16 word widx reads as slot
    min(widx >> 1, w_slots - 1), half widx & 1, when that slot is below sc,
    and as 0 otherwise (as does a byte outside the blob).  That is the numpy
    authority's clamp on the rectangular [T, R, W] array of the v1 wire."""
    _check_desc("decode_mega_plain", desc, out_len, states.shape[0], symtab.shape[0])
    dev = blob.device
    out = torch.zeros(out_len, dtype=torch.uint8, device=dev)
    nbytes = blob.numel()
    padded = torch.cat([blob, blob.new_zeros(1)])
    mask = (1 << bits) - 1
    lane = torch.arange(L, device=dev)

    def byte_at(pos):  # blob bytes at int64 positions, 0 outside the blob
        return padded[torch.where((pos >= 0) & (pos < nbytes), pos, nbytes)].to(torch.int64)

    for _, rows, steps, n_tiles, w_slots, slot_off, row0, tab0, state0, out_base, vlen in desc.tolist():
        s4c = steps // 4
        row = torch.arange(rows, device=dev)[:, None]
        st = to_u32(states[state0 : state0 + rows])
        packed = torch.zeros((n_tiles, rows, s4c, L), dtype=torch.int64, device=dev)
        for t in range(n_tiles):
            sym_of = symtab[tab0 + t].to(torch.int64)
            fc = to_u32(fctab[tab0 + t])
            freq_of, cum_of = fc & 0xFFFF, fc >> 16
            rs = row_start[row0 + t * rows : row0 + (t + 1) * rows + 1]
            start, sc = rs[:-1, None], (rs[1:] - rs[:-1])[:, None]
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
                i = torch.clamp(widx >> 1, max=w_slots - 1)
                pos = slot_off + 4 * (start + i) + 2 * (widx & 1)
                word = torch.where(i < sc, byte_at(pos) | byte_at(pos + 1) << 8, 0)
                st = torch.where(consume, ((st << 16) | word) & _M32, st)
                rw = rw + c.sum(dim=1, keepdim=True)
                packed[t, :, s // 4] |= torch.where(valid, sym, 0) << (8 * (s % 4))
        n = -(-vlen // 4) * 4
        out[out_base : out_base + n] = from_u32(packed.reshape(-1)).view(torch.uint8)[:n]
    return out


def _groups_with_data(vlen: int, row_id: int, s4c: int) -> int:
    """Step groups of row `row_id` (= t * R + r) that hold a position below
    vlen: past them no state changes and every byte is 0."""
    return max(0, min(s4c, -(-(vlen - row_id * s4c * L * 4) // (L * 4))))


def decode_mega_cuda(blob, desc, row_start, states, symtab, fctab, *, bits: int, out_len: int) -> torch.Tensor:
    """The CUDA kernel (`csrc/tpx_decode.cu`) on CUDA tensors, every mega of
    `desc` in one launch; same contract as decode_mega_plain.  Raises for any
    other tensor."""
    dev = build.check_cuda("decode_mega_cuda", blob, row_start, states, symtab, fctab, uint8=(0, 3), int64=(1,))
    if not 10 <= bits <= 15 or states.shape[1:] != (L,) or symtab.shape[1:] != (1 << bits,) or fctab.shape != (
        symtab.shape[0], 256
    ):
        raise ValueError("decode_mega_cuda: operand shapes do not match the depth")
    _check_desc("decode_mega_cuda", desc, out_len, states.shape[0], symtab.shape[0])
    out = torch.empty(out_len, dtype=torch.uint8, device=dev)  # the kernel writes every u32
    if len(desc):
        launch_decode(blob, desc_on(desc, dev), row_start, states, symtab, fctab, out, bits=bits, ctas=ctas_of(desc))
    return out


def ctas_of(desc: np.ndarray) -> int:
    """CTAs of a one-launch tpx kernel: ceil(rows / WARPS) for each mega."""
    return int((-(-desc[:, 1] // WARPS)).sum())


def desc_on(desc: np.ndarray, dev: torch.device) -> torch.Tensor:
    """The host's mega descriptors on the card, copied from pinned memory
    so that the host does not wait for the card."""
    return torch.from_numpy(desc).pin_memory().to(dev, non_blocking=True)


def launch_decode(blob, desc_t, row_start, states, symtab, fctab, out, *, bits: int, ctas: int) -> None:
    """One launch of the decode kernel with the descriptors on the card
    (`desc_t`) into the output given; decode_mega_cuda's checks are the
    caller's."""
    build.launch(
        "tpx_decode", "hsr_tpx_decode", blob.device,
        blob.data_ptr(), blob.numel(), desc_t.data_ptr(), desc_t.shape[0], ctas, row_start.data_ptr(),
        states.data_ptr(), symtab.data_ptr(), fctab.data_ptr(), out.data_ptr(), bits,
    )


def decode_mega(blob, desc, row_start, states, symtab, fctab, *, bits: int, out_len: int) -> torch.Tensor:
    """The kernel for CUDA operands, its plain version for CPU operands."""
    fn = decode_mega_plain if blob.device.type == "cpu" else decode_mega_cuda
    return fn(blob, desc, row_start, states, symtab, fctab, bits=bits, out_len=out_len)


def tpx_decode_torch(
    blob: bytes | np.ndarray,
    device: str | torch.device = "cuda",
    layers: dict[str, float] | None = None,
    devices: list | None = None,
) -> bytes | None:
    """Decode a tpx blob (v1, v2 or v3 wire) on `device`; None if malformed.

    With `devices`, the megablocks are split over them (`shares`: each a
    contiguous run), one launch on each, and each share's bytes copied back
    to their place in the output; the bytes do not depend on the split.
    With `layers`, adds the seconds of each layer of this call to it
    (host_parse, host_tables, h2d, kernel, d2h, host_assemble), the device
    synchronized at each boundary."""
    devs = resolve_all(device, devices)
    dev = devs[0]
    with layer_clock(layers, "host_parse", dev):
        buf = _as_array(blob)
        parsed = tpx_parse(buf)
    if parsed is None:
        return None
    p, length, megas = parsed
    if p.lanes != L:
        return None
    with layer_clock(layers, "host_tables", dev):
        tabs = dec_tables(np.concatenate([m.freqs for m in megas]), p.bits)
    if tabs is None:
        return None
    tab0 = np.cumsum([0] + [m.n_tiles for m in megas])
    out = np.zeros(length, dtype=np.uint8)
    for d, lo, hi in shares(devs, len(megas)):
        with layer_clock(layers, "host_tables", d):
            # the share's megas that hold data, their output from its first byte
            desc, row_start, states = decode_operands(megas[lo:hi], length)
        if not len(desc):
            continue
        base = int(desc[0, 9])
        desc[:, 9] -= base
        n_out = int(desc[:, 10].sum())
        with layer_clock(layers, "h2d", d):
            share_tabs = (t[tab0[lo] : tab0[hi]] for t in tabs)
            ops = [torch.from_numpy(a).to(d) for a in (buf, row_start, states.view(np.int32), *share_tabs)]
        with layer_clock(layers, "kernel", d):
            got = decode_mega(ops[0], desc, *ops[1:], bits=p.bits, out_len=-(-n_out // 4) * 4)
        with layer_clock(layers, "d2h", d):
            torch.from_numpy(out[base : base + n_out]).copy_(got[:n_out])
    with layer_clock(layers, "host_assemble", dev):
        return out.tobytes()
