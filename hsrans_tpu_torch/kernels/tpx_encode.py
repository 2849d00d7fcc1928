"""tpx encode: the port of `hsrans_tpu/kernels/tpx_encode.py` to PyTorch and
CUDA (`csrc/tpx_encode.cu`).

Phase A (`encode_mega`) runs the rANS state machine backward over every
megablock of the input in one call (one kernel launch on the card) and
leaves each step's emitted words compacted in lane order; phase B
(`concat`, once a mega) lays each (tile, row)'s words out as its u32-slot
stream.
Per-tile histograms, the encode tables and the wire mux stay on the host
(the port's copy of the wire in `..ops.tpx`), and the blobs equal the JAX
package's `hsrans_tpu.ops.tpx.tpx_encode` and `tpx_encode_adaptive` byte for
byte.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.tpx import (
    DECODE_CONSUME_POINT_16,
    MAGIC3,
    L,
    TpxParams,
    _mega_layout,
    _write_mega,
    make_tile_hist,
    tpx_header,
    tpx_plan_geometry,
)
from ..runtime import build
from ..runtime.device import layer_clock, resolve
from .tpx_decode import WARPS, ctas_of, desc_on, from_u32, to_u32

_M32 = 0xFFFFFFFF
# columns of the int64 per-mega descriptor; csrc/tpx_encode.cu::EncodeMega
ENCODE_FIELDS = ("cta0", "rows", "steps", "n_tiles", "in_off", "tab0", "vlen", "cnt_off", "state0")


def div_magic(freq: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-symbol (magic, shift) with floor(n/d) == (umul64(m,n)>>31)>>l for
    all n < 2^31 (Granlund-Montgomery round-up magic, p = 31 + ceil(log2 d);
    the n<2^31 bound is the rANS32 state invariant, states < EncodeEmitPoint
    * freq <= 2^31).  freq == 0 entries get the d=1 identity.

    Copy of `hsrans_tpu.kernels.tpx_encode.div_magic`, whose module imports
    jax; tests hold the two equal."""
    d = np.maximum(freq.astype(np.int64), 1)
    l = np.zeros(256, dtype=np.int64)
    for k in range(16):
        l = np.where(d > (1 << k), k + 1, l)
    m = -(-(np.int64(1) << (31 + l)) // d)  # ceil(2^(31+l) / d)
    assert int(m.max()) < 1 << 32 and int(m.min()) >= 1 << 31
    return m.astype(np.uint32), l.astype(np.uint32)


def make_enc_tables_batch(freqs: np.ndarray, cumuls: np.ndarray, bits: int) -> dict[str, np.ndarray]:
    """Vectorized symbol-indexed encode tables over a block batch [B, 256].

    fc layout by depth: B<=12 packs freq(13) | cumul<<13 (12) | shift<<25
    into one u32 (one gather in the kernels); B>=13 uses
    freq | cumul<<16 plus the separate shift table l.

    Copy of `hsrans_tpu.kernels.tpx_encode.make_enc_tables_batch`, whose
    module imports jax; tests hold the two equal.
    """
    d = np.maximum(freqs.astype(np.int64), 1)
    l = np.zeros_like(d)
    for k in range(16):
        l = np.where(d > (1 << k), k + 1, l)
    m = -(-(np.int64(1) << (31 + l)) // d)
    assert int(m.max()) < 1 << 32 and int(m.min()) >= 1 << 31  # q31 invariant
    if bits <= 12:
        # absent symbols (freq 0) can carry cumul == 2^bits, which would
        # overflow the 12-bit field into the shift; they are never gathered
        # by an unmasked lane, so zero their freq/cumul fields entirely
        cum_field = np.where(freqs > 0, cumuls.astype(np.uint32), np.uint32(0))
        frq_field = freqs.astype(np.uint32)
        fc = frq_field | (cum_field << np.uint32(13)) | (l.astype(np.uint32) << np.uint32(25))
    else:
        fc = freqs.astype(np.uint32) | (cumuls.astype(np.uint32) << np.uint32(16))
    return {
        "fc": fc.view(np.int32),
        "m": m.astype(np.uint32).view(np.int32),
        "l": l.astype(np.int32),
    }


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
    (ENCODE_FIELDS), fc/m/l int32 [sum tiles, 256] (make_enc_tables_batch)
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
        launch_encode(data, desc_on(desc, dev), fc, m, l, win, cnt, states, bits=bits, ctas=ctas_of(desc))
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


def concat_plain(win, cnt, w_slots: int) -> torch.Tensor:
    """Plain PyTorch version of the concat kernel, on any device.

    win int32 [T, S, R, 128], cnt int32 [T, R, S] -> int32 [T, R, w_slots]:
    each (tile, row)'s words in (step, lane) order, two per u32 slot with
    the earlier word in the low half, 0 past the last word."""
    n_tiles, steps, rows, _ = win.shape
    dev = win.device
    words = win.permute(0, 2, 1, 3).reshape(n_tiles, rows, steps * L).to(torch.int64) & 0xFFFF
    keep = (torch.arange(L, device=dev) < cnt.to(torch.int64)[..., None]).reshape(n_tiles, rows, steps * L)
    k = keep.to(torch.int64)
    cap = 2 * w_slots
    dest = torch.cumsum(k, dim=2) - k
    dest = torch.where(keep & (dest < cap), dest, cap)  # dropped words go to a spare column
    half = torch.zeros((n_tiles, rows, cap + 1), dtype=torch.int64, device=dev)
    half.scatter_(2, dest, words)
    return from_u32(half[..., 0:cap:2] | (half[..., 1:cap:2] << 16))


def concat_cuda(win, cnt, w_slots: int) -> torch.Tensor:
    """The CUDA concat kernel (`csrc/tpx_encode.cu`) on CUDA tensors; same
    contract as concat_plain.  Raises for any other tensor."""
    dev = build.check_cuda("concat_cuda", win, cnt)
    n_tiles, steps, rows, lanes = win.shape
    if lanes != L or cnt.shape != (n_tiles, rows, steps):
        raise ValueError("concat_cuda: operand shapes do not match")
    out = torch.empty((n_tiles, rows, w_slots), dtype=torch.int32, device=dev)
    if out.numel():
        build.launch(
            "tpx_concat", "hsr_tpx_concat", dev,
            win.data_ptr(), cnt.data_ptr(), out.data_ptr(), rows, steps, n_tiles, w_slots,
        )
    return out


def concat(win, cnt, w_slots: int) -> torch.Tensor:
    """The kernel for CUDA operands, its plain version for CPU operands."""
    fn = concat_plain if win.device.type == "cpu" else concat_cuda
    return fn(win, cnt, w_slots)


def _as_array(data: bytes | np.ndarray) -> np.ndarray:
    if isinstance(data, (bytes, bytearray, memoryview)):
        return np.frombuffer(data, dtype=np.uint8)
    return np.ascontiguousarray(data, dtype=np.uint8)


def mega_operands(
    arr: np.ndarray, geoms: list[tuple[int, int, int, int, int]], *, bits: int
) -> tuple[np.ndarray, np.ndarray, dict[str, np.ndarray]]:
    """Host side of the one-call encode of the megas [(base, rows, steps,
    n_tiles, valid bytes)]: (desc int64 [M, 9] (ENCODE_FIELDS), wire freqs
    u16 [sum tiles, 256], make_enc_tables_batch tables [sum tiles, 256]),
    exactly as the JAX encoder prepares them: each tile's histogram over its
    contiguous wire range of valid bytes, the 1-symbol histogram for a tile
    wholly past them.  (`make_tile_hists`, batched for the mt encoder's
    small blocks, is slower on these 4 MiB tiles: one bincount of int32 keys
    against one of the tile's bytes each.)"""
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
    hists = [make_tile_hist(arr[s:e], bits) for s, e in zip(np.concatenate(starts), np.concatenate(ends))]
    freqs = np.stack([h.symbol_count for h in hists])
    return np.array(desc, np.int64), freqs, make_enc_tables_batch(freqs, np.stack([h.cumul for h in hists]), bits)


def _encode_megas(
    out: bytearray,
    arr: np.ndarray,
    geoms: list[tuple[int, int, int, int, int]],
    *,
    bits: int,
    v3: bool,
    device: torch.device,
    layers: dict[str, float] | None,
) -> None:
    """Encode the megas [(base, rows, steps, n_tiles, valid bytes)] on
    `device`, one kernel launch for all of them, and append their wire
    sections (with v3 each after its u32 rows | u32 steps); bytes equal
    `hsrans_tpu.ops.tpx._encode_mega_into`'s mega by mega."""
    with layer_clock(layers, "host_hist_tables", device):
        desc, freqs, tabs = mega_operands(arr, geoms, bits=bits)
    with layer_clock(layers, "h2d", device):
        ops = [torch.from_numpy(a).to(device) for a in (arr, tabs["fc"], tabs["m"], tabs["l"])]
    with layer_clock(layers, "kernel_encode", device):
        views = mega_views(*encode_mega(ops[0], desc, *ops[1:], bits=bits), desc)
    with layer_clock(layers, "kernel_concat", device):
        streams = []
        for win, cnt, _ in views:
            counts = cnt.sum(dim=2)  # words per (tile, row)
            streams.append((counts, concat(win, cnt, wire_w_slots(int(counts.max())))))
    with layer_clock(layers, "d2h", device):
        host = [
            (st.cpu().numpy().view(np.uint32), counts.cpu().numpy().astype(np.uint16), stream.cpu().numpy().view(np.uint32))
            for (_, _, st), (counts, stream) in zip(views, streams)
        ]
    with layer_clock(layers, "host_mux", device):
        for (_, rows, steps, n_tiles, _, tab0, *_), (states, counts, stream) in zip(desc.tolist(), host):
            if v3:
                out += int(rows).to_bytes(4, "little") + int(steps).to_bytes(4, "little")
            _write_mega(out, n_tiles, stream.shape[2], states, freqs[tab0 : tab0 + n_tiles], counts, stream)


def wire_w_slots(max_words: int) -> int:
    """The mega's u32 slots per row on the wire (the JAX encoder's formula):
    ceil(max_words / 2) rounded up to a multiple of 128, at least 128."""
    return max(128, -(-(-(-max_words // 2)) // 128) * 128)


def tpx_encode_torch(
    data: bytes | np.ndarray,
    bits: int = 12,
    p: TpxParams | None = None,
    goal: str = "balanced",
    device: str | torch.device = "cuda",
    layers: dict[str, float] | None = None,
) -> bytes:
    """Encode to the tpx v2 wire on `device`; equal to the JAX package's
    `ops.tpx.tpx_encode`.

    With `layers`, adds the seconds of each layer of this call to it
    (host_hist_tables, h2d, kernel_encode, kernel_concat, d2h, host_mux),
    the device synchronized at each boundary."""
    dev = resolve(device)
    arr = _as_array(data)
    length = arr.size
    p = p or TpxParams.auto(length, bits, goal)
    if p.lanes != L or p.steps % 4 or not 10 <= p.bits <= 15:
        raise ValueError("tpx encode requires lanes == 128, steps % 4 == 0 and 10 <= bits <= 15")
    out = tpx_header(length, p)
    geoms = [(base, p.rows, p.steps, n_tiles, valid) for base, n_tiles, valid in _mega_layout(length, p)]
    _encode_megas(out, arr, geoms, bits=p.bits, v3=False, device=dev, layers=layers)
    out[16:24] = len(out).to_bytes(8, "little")
    return bytes(out)


def tpx_encode_adaptive_torch(data: bytes | np.ndarray, bits: int = 12, device: str | torch.device = "cuda") -> bytes:
    """Encode to the v3 adaptive wire (per-megablock geometry from
    `tpx_plan_geometry`) on `device`; equal to the JAX package's
    `ops.tpx.tpx_encode_adaptive`."""
    dev = resolve(device)
    if not 10 <= bits <= 15:
        raise ValueError("tpx encode requires 10 <= bits <= 15")
    arr = _as_array(data)
    length = arr.size
    geoms = tpx_plan_geometry(arr, bits)
    out = bytearray(MAGIC3)
    out += length.to_bytes(8, "little")
    out += b"\0" * 8
    g0 = geoms[0]
    for v in (bits, g0.rows, L, g0.steps, g0.n_tiles):
        out += int(v).to_bytes(4, "little")
    megas = [(g.base, g.rows, g.steps, g.n_tiles, max(0, min(length - g.base, g.span))) for g in geoms]
    _encode_megas(out, arr, megas, bits=bits, v3=True, device=dev, layers=None)
    out[16:24] = len(out).to_bytes(8, "little")
    return bytes(out)
