"""tpx encode: the port of `hsrans_tpu/kernels/tpx_encode.py` to PyTorch and
CUDA (`csrc/tpx_encode.cu`).

Phase A (`encode_mega`) runs the rANS state machine backward over every
megablock of the input in one call (one kernel launch on the card) and
leaves each step's emitted words compacted in lane order; phase B
(`write_wire`, one launch for every mega) writes each mega's wire section
into the blob on the card, the rows' ragged slots included, at the offsets
that `wire_layout` computes on the host from the rows' word totals.
The per-tile histograms and encode tables are made on the device
(`mega_operands`: `models/device_hist.py`'s one count launch and one
normalise launch for every tile, then the tables in torch, the freqs left
on the card for the wire writer), as the JAX package's `device_tables`
path makes them on the TPU; its host path gives the same bytes, so the
port has no other.  The 44-byte blob header stays on the host, and the
blobs equal the JAX package's `hsrans_tpu.ops.tpx.tpx_encode` and
`tpx_encode_adaptive` byte for byte.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.device_hist import segment_hists
from ..ops.planner import plan_blocks
from ..ops.reference import _as_array
from ..ops.tpx import (
    DECODE_CONSUME_POINT_16,
    MAGIC3,
    L,
    TpxParams,
    _mega_layout,
    tpx_geometry,
    tpx_header,
)
from ..runtime import build
from ..runtime.device import Output, entry_span, layer_clock, resolve, resolve_all, shares, span, table_to_card, to_card
from .mt_encode import magic_tensor, shift_tensor
from .tpx_decode import WARPS, ctas_of, from_u32, to_u32

_M32 = 0xFFFFFFFF
# columns of the int64 per-mega descriptor; csrc/tpx_encode.cu::EncodeMega
ENCODE_FIELDS = ("cta0", "rows", "steps", "n_tiles", "in_off", "tab0", "vlen", "cnt_off", "state0")
# columns of the int64 per-mega descriptor of the wire writer; csrc/tpx_encode.cu::WireMega
WIRE_FIELDS = ("cta0", "rows", "steps", "n_tiles", "cnt_off", "state0", "tab0", "row0", "sec_off", "w_slots")


def _check_desc(name: str, desc: np.ndarray, n_data: int, n_tabs: int) -> tuple[int, int]:
    """Every mega's input and tables lie inside the operands, and its
    outputs follow the previous mega's; returns (counts, state rows) of all
    megas, the sizes of the outputs."""
    cta0, rows, steps, n_tiles, in_off, tab0, vlen, cnt_off, state0 = desc.T
    n_cnt = n_tiles * rows * steps
    if (
        (steps % 4).any() or (steps < 4).any() or (rows < 1).any() or (n_tiles < 1).any() or (in_off % 4).any()
        or (in_off < 0).any() or (vlen < 0).any() or (vlen > n_cnt * L).any() or (in_off + vlen > n_data).any()
        or (tab0 < 0).any() or (tab0 + n_tiles > n_tabs).any()
        or (cta0 != np.cumsum(-(-rows // WARPS)) - -(-rows // WARPS)).any()
        or (cnt_off != np.cumsum(n_cnt) - n_cnt).any() or (state0 != np.cumsum(rows) - rows).any()
    ):
        raise ValueError(f"{name}: a mega descriptor does not fit the operands")
    return int(n_cnt.sum()), int(rows.sum())


def _encode_one_plain(packed, fc, m, l, *, bits: int, steps: int, vlen: int):
    """One mega of encode_mega_plain: packed int32 [T, R, S/4 * 128] (its
    bytes in wire order, 4 steps per u32), fc/m/l int32 [T, 256] -> (win
    int64 [T, S, R, 128], cnt int64 [T, R, S], states int64 [R, 128])."""
    n_tiles, rows, _ = packed.shape
    dev = packed.device
    s4c = steps // 4
    lane = torch.arange(L, device=dev)
    row = torch.arange(rows, device=dev)[:, None]
    win = torch.zeros((n_tiles, steps, rows, L), dtype=torch.int64, device=dev)
    cnt = torch.zeros((n_tiles, rows, steps), dtype=torch.int64, device=dev)
    st = torch.full((rows, L), DECODE_CONSUME_POINT_16, dtype=torch.int64, device=dev)
    for t in range(n_tiles - 1, -1, -1):
        fc_t, m_t, l_t = to_u32(fc[t]), to_u32(m[t]), to_u32(l[t])
        pk = to_u32(packed[t]).reshape(rows, s4c, L)
        base_pos = ((t * rows + row) * s4c * L + lane) * 4
        for s in range(steps - 1, -1, -1):
            byte = (pk[:, s // 4] >> (8 * (s % 4))) & 0xFF
            f = fc_t[byte]
            if bits <= 12:
                freq, cum, shift = f & 0x1FFF, (f >> 13) & 0xFFF, f >> 25
            else:
                freq, cum, shift = f & 0xFFFF, f >> 16, l_t[byte]
            valid = base_pos + ((s // 4) * L * 4 + s % 4) < vlen
            emit = valid & (st >= (1 << (31 - bits)) * freq)
            word = st & 0xFFFF
            x = torch.where(emit, st >> 16, st)
            q = (m_t[byte] * x) >> (31 + shift)  # < 2^63: m < 2^32, x < 2^31
            st = torch.where(valid, (q * ((1 << bits) - freq) + cum + x) & _M32, x)
            e = emit.to(torch.int64)
            dest = torch.where(emit, torch.cumsum(e, dim=1) - e, L)  # non-emitters go to a spare column
            step_win = torch.zeros((rows, L + 1), dtype=torch.int64, device=dev)
            step_win.scatter_(1, dest, word)
            win[t, s] = step_win[:, :L]
            cnt[t, :, s] = e.sum(dim=1)
    return win, cnt, st


def encode_mega_plain(data, desc, fc, m, l, *, bits: int):
    """Plain PyTorch version of the encode kernel, on any device.

    data uint8 [n] (the whole input), desc int64 [M, 9] host array
    (ENCODE_FIELDS), fc/m/l int32 [sum tiles, 256] (enc_tables_device)
    -> (win, cnt, states), int32, each the megas' outputs back to back (see
    `mega_views`): mega m's windows [T, S, R, 128] from cnt_off * 128, each
    step's emitted words in lane order and 0 past its count; its counts
    [T, R, S] from cnt_off, words per step; its final states [R, 128] from
    state0 * 128, which the decoder starts from.  Mega m encodes data[in_off
    : in_off + vlen] in wire order, the positions past vlen as absent."""
    n_cnt, n_rows = _check_desc("encode_mega_plain", desc, data.numel(), fc.shape[0])
    dev = data.device
    win = torch.zeros(n_cnt * L, dtype=torch.int32, device=dev)
    cnt = torch.zeros(n_cnt, dtype=torch.int32, device=dev)
    states = torch.zeros(n_rows * L, dtype=torch.int32, device=dev)
    for _, rows, steps, n_tiles, in_off, tab0, vlen, cnt_off, state0 in desc.tolist():
        flat = torch.zeros(n_tiles * rows * steps * L, dtype=torch.uint8, device=dev)
        flat[:vlen] = data[in_off : in_off + vlen]
        tabs = (x[tab0 : tab0 + n_tiles] for x in (fc, m, l))
        w, c, st = _encode_one_plain(flat.view(torch.int32).reshape(n_tiles, rows, -1), *tabs, bits=bits, steps=steps,
                                     vlen=vlen)
        win[cnt_off * L : cnt_off * L + w.numel()] = w.reshape(-1).to(torch.int32)
        cnt[cnt_off : cnt_off + c.numel()] = c.reshape(-1).to(torch.int32)
        states[state0 * L : (state0 + rows) * L] = from_u32(st.reshape(-1))
    return win, cnt, states


def encode_mega_cuda(data, desc, fc, m, l, *, bits: int):
    """The CUDA encode kernel (`csrc/tpx_encode.cu`) on CUDA tensors, every
    mega of `desc` in one launch; same contract as encode_mega_plain.
    Raises for any other tensor."""
    dev = build.check_cuda("encode_mega_cuda", data, fc, m, l, uint8=(0,))
    if not 10 <= bits <= 15 or any(x.shape != (fc.shape[0], 256) for x in (fc, m, l)) or data.data_ptr() % 4:
        raise ValueError("encode_mega_cuda: the tables must be [tiles, 256] and the input 4-byte aligned")
    n_cnt, n_rows = _check_desc("encode_mega_cuda", desc, data.numel(), fc.shape[0])
    win = torch.empty(n_cnt * L, dtype=torch.int32, device=dev)  # the kernel writes every word
    cnt = torch.empty(n_cnt, dtype=torch.int32, device=dev)
    states = torch.empty(n_rows * L, dtype=torch.int32, device=dev)
    if len(desc):
        launch_encode(data, table_to_card(desc, dev), fc, m, l, win, cnt, states, bits=bits, ctas=ctas_of(desc))
    return win, cnt, states


def launch_encode(data, desc_t, fc, m, l, win, cnt, states, *, bits: int, ctas: int) -> None:
    """One launch of the encode kernel with the descriptors on the card
    (`desc_t`) into the outputs given; encode_mega_cuda's checks are the
    caller's."""
    build.launch(
        "tpx_encode", "hsr_tpx_encode", data.device,
        data.data_ptr(), desc_t.data_ptr(), desc_t.shape[0], ctas, fc.data_ptr(), m.data_ptr(), l.data_ptr(),
        win.data_ptr(), cnt.data_ptr(), states.data_ptr(), bits,
    )


def encode_mega(data, desc, fc, m, l, *, bits: int):
    """The kernel for CUDA operands, its plain version for CPU operands."""
    fn = encode_mega_plain if data.device.type == "cpu" else encode_mega_cuda
    return fn(data, desc, fc, m, l, bits=bits)


def mega_views(win, cnt, states, desc: np.ndarray) -> list[tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """Each mega's (windows [T, S, R, 128], counts [T, R, S], final states
    [R, 128]) in the one-call encode's outputs."""
    views = []
    for _, rows, steps, n_tiles, _, _, _, cnt_off, state0 in desc.tolist():
        n = n_tiles * rows * steps
        views.append((
            win[cnt_off * L : (cnt_off + n) * L].view(n_tiles, steps, rows, L),
            cnt[cnt_off : cnt_off + n].view(n_tiles, rows, steps),
            states[state0 * L : (state0 + rows) * L].view(rows, L),
        ))
    return views


def wire_layout(desc: np.ndarray, row_words: np.ndarray, *, v3: bool, base: int) -> tuple[np.ndarray, np.ndarray, int]:
    """Where the wire writer puts each mega's section, from the encode's
    descriptors (ENCODE_FIELDS) and each (tile, row)'s word total (int64,
    every mega's rows in order): (the wire descriptors int64 [M, 10]
    (WIRE_FIELDS), each row's first slot as a u16 offset int64 [sum T * R],
    the u16 length of the blob).  The sections follow one another from u16
    `base` on, each [u32 rows | u32 steps (v3) |] u32 n_tiles | u32 w_slots,
    the states [R, 128] u32, each tile's 256 freqs and R counts (u16), then
    every row's ceil(words / 2) u32 slots, rows back to back."""
    _, rows, steps, n_tiles, _, tab0, _, cnt_off, state0 = desc.T
    tr = n_tiles * rows
    row0 = np.cumsum(tr) - tr
    mega = np.repeat(np.arange(len(desc)), tr)
    slots = 2 * ((row_words + 1) // 2)  # u16s of each row's slots
    fixed = (8 if v3 else 4) + 2 * L * rows + n_tiles * (256 + rows)
    size = fixed + np.add.reduceat(slots, row0)
    sec_off = base + np.cumsum(size) - size
    excl = np.cumsum(slots) - slots
    row_at = (sec_off + fixed)[mega] + excl - excl[row0][mega]
    w_slots = [wire_w_slots(int(m)) for m in np.maximum.reduceat(row_words, row0)]
    ctas = -(-tr // WARPS)
    wdesc = np.stack([np.cumsum(ctas) - ctas, rows, steps, n_tiles, cnt_off, state0, tab0, row0, sec_off, w_slots], axis=1)
    return wdesc.astype(np.int64), row_at.astype(np.int64), base + int(size.sum())


def wire_ctas(wdesc: np.ndarray) -> int:
    """CTAs of the wire writer's launch: a warp a (tile, row) of each mega."""
    return int((-(-(wdesc[:, 3] * wdesc[:, 1]) // WARPS)).sum())


def _check_wire(name: str, win, cnt, states, freqs, wdesc: np.ndarray, row_at: np.ndarray, *, v3: bool,
                out_u16: int) -> int:
    """Every mega's operands lie inside the tensors and its section's fields
    and rows inside the blob; returns the launch's CTAs."""
    cta0, rows, steps, n_tiles, cnt_off, state0, tab0, row0, sec_off, _ = wdesc.T
    tr = n_tiles * rows
    ctas = -(-tr // WARPS)
    fixed_end = sec_off + (8 if v3 else 4) + 2 * L * rows + n_tiles * (256 + rows)
    bad = (
        win.numel() != cnt.numel() * L or freqs.shape[1:] != (256,)
        or (rows < 1).any() or (n_tiles < 1).any() or (steps < 1).any() or (cta0 != np.cumsum(ctas) - ctas).any()
        or (cnt_off < 0).any() or (cnt_off + tr * steps > cnt.numel()).any()
        or (state0 < 0).any() or ((state0 + rows) * L > states.numel()).any()
        or (tab0 < 0).any() or (tab0 + n_tiles > freqs.shape[0]).any()
        or (row0 != np.cumsum(tr) - tr).any() or row_at.shape != (int(tr.sum()),)
        or (sec_off < 0).any() or (fixed_end > out_u16).any()
        or (row_at < np.repeat(fixed_end, tr)).any() or (row_at > out_u16).any()
    )
    if bad:
        raise ValueError(f"{name}: the wire layout does not fit the operands")
    return wire_ctas(wdesc)


def write_wire_plain(win, cnt, states, freqs, wdesc: np.ndarray, row_at: np.ndarray, *, v3: bool, out_u16: int):
    """Plain PyTorch version of the wire writer kernel, on any device.

    win, cnt, states int32: the encode's outputs in its one-call layout
    (`mega_views`); freqs int16 [sum tiles, 256] (the wire's u16 freqs);
    wdesc int64 [M, 10] and row_at int64 [sum T * R], host arrays
    (`wire_layout`) -> uint8 [2 * out_u16]: each mega's wire section at u16
    sec_off, as `hsrans_tpu.ops.tpx._write_mega` writes it after v3's u32
    rows | u32 steps: each row's words are its steps' first count words of
    their windows (the low 16 bits), two a slot, the earlier in the low
    half, a 0 after the last of an odd row.  Bytes below the first section
    are 0."""
    dev = win.device
    out = torch.zeros(out_u16, dtype=torch.int32, device=dev)
    head = 8 if v3 else 4
    halves = torch.tensor([0, 16], device=dev)
    lane = torch.arange(L, device=dev)
    for _, rows, steps, n_tiles, cnt_off, state0, tab0, row0, sec_off, w_slots in wdesc.tolist():
        n = n_tiles * rows * steps
        fields = torch.tensor([rows, steps, n_tiles, w_slots][4 - head // 2 :], device=dev)
        out[sec_off : sec_off + head] = ((fields[:, None] >> halves) & 0xFFFF).reshape(-1).to(torch.int32)
        at = sec_off + head
        st = to_u32(states[state0 * L : (state0 + rows) * L])
        out[at : at + 2 * L * rows] = torch.stack([st & 0xFFFF, st >> 16], dim=1).reshape(-1).to(torch.int32)
        at += 2 * L * rows
        c = torch.clamp(cnt[cnt_off : cnt_off + n].view(n_tiles, rows, steps), max=L)
        tot = c.sum(dim=2)  # words of each row
        tiles = torch.cat([freqs[tab0 : tab0 + n_tiles].to(torch.int32) & 0xFFFF, tot.to(torch.int32) & 0xFFFF], dim=1)
        out[at : at + tiles.numel()] = tiles.reshape(-1)
        w = win[cnt_off * L : (cnt_off + n) * L].view(n_tiles, steps, rows, L).permute(0, 2, 1, 3)
        words = torch.masked_select(w, lane < c[..., None]) & 0xFFFF  # rows back to back, (step, lane) order within
        tot = tot.reshape(-1).to(torch.int64)
        start = to_card(row_at[row0 : row0 + n_tiles * rows], dev) - (torch.cumsum(tot, 0) - tot)
        out[torch.arange(words.numel(), device=dev) + torch.repeat_interleave(start, tot)] = words
    return out.to(torch.int16).view(torch.uint8)


def write_wire_cuda(win, cnt, states, freqs, wdesc: np.ndarray, row_at: np.ndarray, *, v3: bool, out_u16: int):
    """The CUDA wire writer (`csrc/tpx_encode.cu`) on CUDA tensors, every
    mega in one launch; same contract as write_wire_plain, except that the
    u16s below the first section are left as they were (unwritten).  Raises
    for any other tensor."""
    dev = build.check_cuda("write_wire_cuda", win, cnt, states, freqs, int16=(3,))
    ctas = _check_wire("write_wire_cuda", win, cnt, states, freqs, wdesc, row_at, v3=v3, out_u16=out_u16)
    out = torch.empty(out_u16, dtype=torch.int16, device=dev)  # the kernel writes every u16 of the sections
    if len(wdesc):
        launch_wire(win, cnt, states, freqs, table_to_card(wdesc, dev), table_to_card(row_at, dev), out, v3=v3, ctas=ctas)
    return out.view(torch.uint8)


def launch_wire(win, cnt, states, freqs, wdesc_t, row_at_t, out, *, v3: bool, ctas: int) -> None:
    """One launch of the wire writer with its layout on the card into `out`
    (int16, 16-byte aligned); write_wire_cuda's checks are the caller's."""
    build.launch(
        "tpx_concat", "hsr_tpx_wire", win.device,
        win.data_ptr(), cnt.data_ptr(), states.data_ptr(), freqs.data_ptr(), wdesc_t.data_ptr(), wdesc_t.shape[0], ctas,
        row_at_t.data_ptr(), out.data_ptr(), out.numel(), int(v3),
    )


def write_wire(win, cnt, states, freqs, wdesc: np.ndarray, row_at: np.ndarray, *, v3: bool, out_u16: int):
    """The kernel for CUDA operands, its plain version for CPU operands."""
    fn = write_wire_plain if win.device.type == "cpu" else write_wire_cuda
    return fn(win, cnt, states, freqs, wdesc, row_at, v3=v3, out_u16=out_u16)


def mega_segments(geoms: list[tuple[int, int, int, int, int]]) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The one-call encode's descriptors of the megas [(base, rows, steps,
    n_tiles, valid bytes)] and each tile's bytes: (desc int64 [M, 9]
    (ENCODE_FIELDS), starts and ends int64 [sum tiles]): each tile's
    contiguous wire range of valid bytes, empty for a tile wholly past
    them."""
    desc, starts, ends = [], [], []
    cta = tab0 = cnt_off = state0 = 0
    for base, rows, steps, n_tiles, valid in geoms:
        tile_bytes = rows * steps * L
        vlen = min(valid, n_tiles * tile_bytes)
        desc.append((cta, rows, steps, n_tiles, base, tab0, vlen, cnt_off, state0))
        first = base + tile_bytes * np.arange(n_tiles, dtype=np.int64)
        starts.append(first)
        ends.append(np.minimum(first + tile_bytes, base + vlen))
        cta += -(-rows // WARPS)
        tab0 += n_tiles
        cnt_off += n_tiles * rows * steps
        state0 += rows
    return np.array(desc, np.int64).reshape(-1, len(ENCODE_FIELDS)), np.concatenate(starts), np.concatenate(ends)


def enc_tables_device(freqs: torch.Tensor, cumuls: torch.Tensor, bits: int) -> tuple[torch.Tensor, ...]:
    """The JAX package's `make_enc_tables_batch` (fc, m, l) as int32 [T,
    256] tensors on the freqs' device, from freqs and cumuls int16 [T, 256]
    (u16): m and l gathered by d = max(freq, 1) from the mt encoder's tables
    of every divisor up to 2^15 (freqs sum to 2^B <= 2^15), so no division
    runs.  fc by depth: B <= 12 packs freq (13 bits) | cumul << 13 (12) |
    shift << 25 into one u32, an absent symbol's freq and cumul fields
    zeroed (its cumul can be 2^B, which would spill into the shift); B >= 13
    packs freq | cumul << 16 beside the separate shift table l.  The tables
    `hsrans_tpu/kernels/tpx_encode.py::_device_tile_tables` makes on the
    TPU."""
    dev = freqs.device
    f = freqs.to(torch.int32) & 0xFFFF
    cum = cumuls.to(torch.int32) & 0xFFFF
    d = torch.clamp(f, min=1)
    l = shift_tensor(dev)[d]
    # every fc fits 31 bits (B <= 12: shift <= 12 at bit 25; else cumul < 2^15), so int32 holds it as it is
    fc = f | (torch.where(f > 0, cum, 0) << 13) | (l << 25) if bits <= 12 else f | (cum << 16)
    return fc, magic_tensor(dev)[d], l


def mega_operands(data: torch.Tensor, geoms: list[tuple[int, int, int, int, int]], *, bits: int):
    """The one-call encode's operands of the megas [(base, rows, steps,
    n_tiles, valid bytes)] over the input `data` (uint8 on its device):
    (desc int64 [M, 9] (ENCODE_FIELDS), the wire freqs int16 [sum tiles,
    256] (u16) and the encode tables fc, m, l int32 [sum tiles, 256] on
    data's device), exactly as the JAX encoder prepares them: each tile's
    histogram over its contiguous wire range of valid bytes, the 1-symbol
    histogram for a tile wholly past them.  On the card, one launch of
    each histogram kernel."""
    desc, starts, ends = mega_segments(geoms)
    freqs, cumuls = segment_hists(data, starts, ends, bits)
    return desc, freqs, *enc_tables_device(freqs, cumuls, bits)


def _encode_megas(
    head: bytes,
    arr: np.ndarray,
    geoms: list[tuple[int, int, int, int, int]],
    *,
    bits: int,
    v3: bool,
    devices: list[torch.device],
    layers: dict[str, float] | None,
) -> bytes:
    """The blob: `head` (the 44-byte header; the total length at [16:24]
    filled in here), then the wire sections of the megas [(base, rows,
    steps, n_tiles, valid bytes)], with v3 each after its u32 rows | u32
    steps.  The megas are split over `devices` (`shares`: each a contiguous
    run); on each, one launch of each histogram kernel, of the encode and
    of the wire writer for its share, and the shares' sections follow one
    another in mega order, each copied from its device once, into its
    place in the `bytes` returned (`Output`).  Bytes equal
    `hsrans_tpu.ops.tpx._encode_mega_into`'s mega by mega."""
    sections = []
    for dev, lo, hi in shares(devices, len(geoms)):
        first = geoms[lo][0]
        end = max(base + valid for base, *_, valid in geoms[lo:hi])
        share = [(base - first, *rest) for base, *rest in geoms[lo:hi]]
        with layer_clock(layers, "h2d", dev):
            data = to_card(arr[first:end], dev)
        with layer_clock(layers, "kernel_hist", dev):
            desc, freqs_t, fc, m, l = mega_operands(data, share, bits=bits)  # the freqs stay on the card for the writer
        with layer_clock(layers, "kernel_encode", dev):
            win, cnt, states = encode_mega(data, desc, fc, m, l, bits=bits)
        with layer_clock(layers, "host_layout", dev):
            views = mega_views(win, cnt, states, desc)
            row_words = torch.cat([torch.clamp(c, max=L).sum(dim=2).reshape(-1) for _, c, _ in views]).cpu().numpy()
            wdesc, row_at, out_u16 = wire_layout(desc, row_words.astype(np.int64), v3=v3, base=len(head) // 2)
        with layer_clock(layers, "kernel_concat", dev):
            # every share's sections are written after a head's room
            sections.append(write_wire(win, cnt, states, freqs_t, wdesc, row_at, v3=v3, out_u16=out_u16)[len(head) :])
    with layer_clock(layers, "host_mux", devices[0]):
        total = len(head) + sum(t.numel() for t in sections)
        out = Output(total)
        out.part(0, len(head))[:] = np.frombuffer(head[:16] + total.to_bytes(8, "little") + head[24:], np.uint8)
    with out:
        at = len(head)
        for t in sections:
            with layer_clock(layers, "d2h", t.device):
                out.put(at, t)
            at += t.numel()
    return out.result


def wire_w_slots(max_words: int) -> int:
    """The mega's u32 slots per row on the wire (the JAX encoder's formula):
    ceil(max_words / 2) rounded up to a multiple of 128, at least 128."""
    return max(128, -(-(-(-max_words // 2)) // 128) * 128)


@entry_span
def tpx_encode_torch(
    data: bytes | np.ndarray,
    bits: int = 12,
    p: TpxParams | None = None,
    goal: str = "balanced",
    device: str | torch.device = "cuda",
    layers: dict[str, float] | None = None,
    device_tables: bool = False,
    devices: list | None = None,
) -> bytes:
    """Encode to the tpx v2 wire on `device`, or with the megablocks split
    over `devices` (`_encode_megas`); equal to the JAX package's
    `ops.tpx.tpx_encode` and `kernels.tpx_encode.tpx_encode_tpu`, and to its
    `parallel.tpx_sharded.tpx_encode_device` for every mesh.

    The per-tile histograms, their exact normalization to 2^B and the
    encode tables are made on `device` (`mega_operands`).
    `device_tables` keeps the JAX signature and changes nothing: the JAX
    package's host and device tables give the same bytes, and the port
    has only the device's.  With `layers`, adds the seconds of each layer
    of this call to it (h2d, kernel_hist, kernel_encode, host_layout,
    kernel_concat, host_mux, d2h), the device synchronized at each
    boundary."""
    devs = resolve_all(device, devices)
    arr = _as_array(data)
    length = arr.size
    p = p or TpxParams.auto(length, bits, goal)
    if p.lanes != L or p.steps % 4 or not 10 <= p.bits <= 15:
        raise ValueError("tpx encode requires lanes == 128, steps % 4 == 0 and 10 <= bits <= 15")
    with span("host_geometry"):
        geoms = [(base, p.rows, p.steps, n_tiles, valid) for base, n_tiles, valid in _mega_layout(length, p)]
    return _encode_megas(bytes(tpx_header(length, p)), arr, geoms, bits=p.bits, v3=False, devices=devs, layers=layers)


@entry_span
def tpx_encode_adaptive_torch(
    data: bytes | np.ndarray,
    bits: int = 12,
    device: str | torch.device = "cuda",
    layers: dict[str, float] | None = None,
    device_tables: bool = False,
) -> bytes:
    """Encode to the v3 adaptive wire (per-megablock geometry from
    `tpx_geometry` of the native planner's rows) on `device`; equal to the JAX package's
    `ops.tpx.tpx_encode_adaptive` and `kernels.tpx_encode.tpx_encode_adaptive_tpu`.
    `layers` and `device_tables` as in tpx_encode_torch."""
    dev = resolve(device)
    if not 10 <= bits <= 15:
        raise ValueError("tpx encode requires 10 <= bits <= 15")
    arr = _as_array(data)
    length = arr.size
    with span("host_geometry"):
        geoms = tpx_geometry(length, plan_blocks(arr, bits, "mt", 64))
        g0 = geoms[0]
        head = MAGIC3 + length.to_bytes(8, "little") + bytes(8)
        head += b"".join(int(v).to_bytes(4, "little") for v in (bits, g0.rows, L, g0.steps, g0.n_tiles))
        megas = [(g.base, g.rows, g.steps, g.n_tiles, max(0, min(length - g.base, g.span))) for g in geoms]
    return _encode_megas(head, arr, megas, bits=bits, v3=True, devices=[dev], layers=layers)
