"""The XLA scan codecs: the port of `hsrans_tpu/ops/raw_jax.py`'s
`decode_section` and `encode_section` to PyTorch and CUDA (`csrc/scan.cu`).

In the JAX package these are `lax.scan` loops that XLA compiles; here each is
one hand-written CUDA kernel, with a plain PyTorch version beside it for CPU
tensors.  Operands have one batch axis of B streams (`ops/raw_scan.py` maps
the JAX shapes onto it): u32 values travel as int32 storage of their bits,
u16 values as int16, bools as bool.  Both kernels keep XLA's contract bit for
bit, out-of-range gathers included (`csrc/scan.cu` lists it): a stream index
at or past W reads 0xFFFF, one in [-W, 0) wraps, a table slot past the
table's length reads 255 or 0xFFFF.  The encode kernel divides by a magic
from `magic_table` (built here once a device), exact for every u32 state
and every u16 freq.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..rans import DECODE_CONSUME_POINT_16, IDX2IDX, encode_emit_point_16
from ..runtime import build
from .tpx_decode import from_u32, to_u32

_M32 = 0xFFFFFFFF
LANES = (16, 32, 64)
MAGIC_SIZE = 1 << 16  # the encode's divisors: every u16 freq (d = max(freq, 1))


def magic_shift(d: np.ndarray) -> np.ndarray:
    """l = ceil(log2 d) of int64 d >= 1 (0 at d = 1): the bit length of
    d - 1, which the encode kernel takes as 32 - __clz(d - 1)."""
    d = np.asarray(d, dtype=np.int64)
    l = np.zeros_like(d)
    for k in range(32):
        l += (d - 1) >> k > 0
    return l


def magic_table() -> np.ndarray:
    """uint32 [MAGIC_SIZE]: at d the encode's magic of max(d, 1),
    m = floor(2^(32 + l) / d) + 1 - 2^32 with l = magic_shift(d), so that
    magic_quotient(x, d) == x // d for every u32 x and every d in
    [1, 2^16) (Granlund-Montgomery's 33-bit multiplier 2^32 + m)."""
    d = np.maximum(np.arange(MAGIC_SIZE, dtype=np.int64), 1)
    return ((np.int64(1) << (32 + magic_shift(d))) // d + 1 - (np.int64(1) << 32)).astype(np.uint32)


def magic_quotient(x: np.ndarray, d: np.ndarray) -> np.ndarray:
    """The encode kernel's division written out in numpy uint64: x // d as
    (x + umulhi(m, x)) >> l, m and l from magic_table and magic_shift, the
    sum in 64 bits."""
    x = np.asarray(x, dtype=np.uint64)
    m = magic_table()[d].astype(np.uint64)
    l = magic_shift(d).astype(np.uint64)
    return (x + ((m * x) >> np.uint64(32))) >> l


@functools.cache
def magic_tensor(dev: torch.device) -> torch.Tensor:
    """magic_table() as int32 (u32 bits) on `dev`, made once per device."""
    return torch.from_numpy(magic_table().view(np.int32)).to(dev)


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values taken modulo 2^32 into int32's range (XLA's int32 add)."""
    return ((x + (1 << 31)) & _M32) - (1 << 31)


def _gather_rows(tab: torch.Tensor, idx: torch.Tensor, fill: int) -> torch.Tensor:
    """tab [T] (shared) or [B, T] (one row a stream) at int64 idx [B, N]; a
    fill-mode gather: idx in [-T, 0) wraps, anything else outside [0, T)
    reads `fill`."""
    t = tab.shape[-1]
    idx = torch.where(idx < 0, idx + t, idx)
    inside = (idx >= 0) & (idx < t)
    safe = torch.clamp(idx, 0, max(t - 1, 0))
    if t == 0:
        return torch.full(idx.shape, fill, dtype=torch.int64, device=idx.device)
    got = tab[safe] if tab.dim() == 1 else torch.gather(tab.expand(idx.shape[0], t), 1, safe)
    return torch.where(inside, got, fill)


def decode_section_plain(states, stream, read_pos, tab_sym, tab_freq, tab_cumul, valid_counts, *, bits: int,
                         num_steps: int, tail: bool):
    """Plain PyTorch version of the decode kernel, on any device.

    states int32 [B, N] (u32 bits, N in LANES), stream int16 [B, W] or
    shared [W] (u16 bits), read_pos int32 [B], tab_sym uint8 and tab_freq,
    tab_cumul int16 (u16 bits), each [B, T] or shared [T], valid_counts
    int32 [B] -> (symbols uint8 [B, num_steps, N] in lane order, final states
    int32 [B, N], read_pos int32 [B]).  Step g of stream b: slot = state &
    (2^bits - 1), symbol/freq/cumul gathered at the slot, state =
    (state >> bits) * freq + slot - cumul (u32); with `tail` lane j keeps
    its state unless g*N + IDX2IDX[N][j] < valid_counts[b]; a lane whose new
    state is below 2^15 (and that took part) shifts in one stream word, the
    group's words taken at read_pos + the exclusive lane-ascending count
    (a fill-mode gather), and read_pos moves on by the count.  A symbol is
    output for every lane, the lanes that kept their state included."""
    dev = states.device
    nb, n = states.shape
    st = to_u32(states)
    r = read_pos.to(torch.int64)
    words = stream.to(torch.int64) & 0xFFFF
    sym_t = tab_sym.to(torch.int64)
    freq_t = tab_freq.to(torch.int64) & 0xFFFF
    cum_t = tab_cumul.to(torch.int64) & 0xFFFF
    vc = valid_counts.to(torch.int64)[:, None]
    perm = torch.from_numpy(IDX2IDX[n]).to(dev)[None, :]
    mask = (1 << bits) - 1
    syms = torch.zeros((nb, num_steps, n), dtype=torch.uint8, device=dev)
    for g in range(num_steps):
        slot = st & mask
        sym = _gather_rows(sym_t, slot, 0xFF)
        new = ((st >> bits) * _gather_rows(freq_t, slot, 0xFFFF) + slot - _gather_rows(cum_t, slot, 0xFFFF)) & _M32
        valid = _wrap_i32(g * n + perm) < vc if tail else torch.ones_like(st, dtype=torch.bool)
        new = torch.where(valid, new, st)
        consume = valid & (new < DECODE_CONSUME_POINT_16)
        c = consume.to(torch.int64)
        at = _wrap_i32(r[:, None] + torch.cumsum(c, dim=1) - c)  # lane-ascending consume order
        st = torch.where(consume, ((new << 16) | _gather_rows(words, at, 0xFFFF)) & _M32, new)
        r = _wrap_i32(r + c.sum(dim=1))
        syms[:, g] = sym.to(torch.uint8)
    return syms, from_u32(st), r.to(torch.int32)


def encode_section_plain(states, group_bytes, valid, freq_tab, cumul_tab, *, bits: int, num_steps: int):
    """Plain PyTorch version of the encode kernel, on any device.

    states int32 [B, N] (u32 bits), group_bytes uint8 [B, num_steps, N] in
    lane order, valid bool [B, num_steps, N], freq_tab and cumul_tab int16
    (u16 bits) [B, 256] or shared [256] -> (words int16 [B, num_steps, N]
    (u16 bits), emit bool [B, num_steps, N], final states int32 [B, N]).
    Groups run last to first: f = max(freq, 1); a valid lane emits its low
    16 bits (word, else 0) if state >= emit_point * f (u32), then state =
    ((x // f) << bits) + cumul + x % f of x = state (>> 16 if it emitted);
    an invalid lane keeps its state.  The forward wire stream is
    words[emit] in (group, lane) order."""
    dev = states.device
    nb, n = states.shape
    emit_point = encode_emit_point_16(bits) & _M32
    st = to_u32(states)
    f_t = freq_tab.to(torch.int64) & 0xFFFF
    c_t = cumul_tab.to(torch.int64) & 0xFFFF
    words = torch.zeros((nb, num_steps, n), dtype=torch.int64, device=dev)
    emits = torch.zeros((nb, num_steps, n), dtype=torch.bool, device=dev)
    for g in range(num_steps - 1, -1, -1):
        b = group_bytes[:, g].to(torch.int64)
        v = valid[:, g]
        f = torch.clamp(_gather_rows(f_t, b, 0xFFFF), min=1)
        emit = v & (st >= (emit_point * f) & _M32)
        words[:, g] = torch.where(emit, st & 0xFFFF, 0)
        emits[:, g] = emit
        x = torch.where(emit, st >> 16, st)
        new = (((x // f) << bits) + _gather_rows(c_t, b, 0xFFFF) + x % f) & _M32
        st = torch.where(v, new, st)
    return words.to(torch.int16), emits, from_u32(st)


def _shared_or_rows(name: str, tabs: tuple[torch.Tensor, ...], nb: int) -> tuple[tuple[torch.Tensor, ...], int]:
    """The tables as the kernel takes them: all shared (stride 0) or all one
    row a stream (stride T); a mix is expanded to rows."""
    t = tabs[0].shape[-1]
    if any(x.shape[-1] != t for x in tabs) or any(x.dim() not in (1, 2) for x in tabs):
        raise ValueError(f"{name}: the tables must share their length and be [T] or [B, T]")
    if all(x.dim() == 1 for x in tabs):
        return tabs, 0
    out = tuple(x.expand(nb, t).contiguous() if x.dim() == 1 else x for x in tabs)
    if any(x.shape[0] != nb for x in out):
        raise ValueError(f"{name}: per-stream tables must have one row a stream")
    return out, t


def decode_section_cuda(states, stream, read_pos, tab_sym, tab_freq, tab_cumul, valid_counts, *, bits: int,
                        num_steps: int, tail: bool):
    """The decode kernel (`csrc/scan.cu`) on CUDA tensors; same contract as
    decode_section_plain.  Raises for any other tensor."""
    nb = states.shape[0] if states.dim() == 2 else -1
    (tab_sym, tab_freq, tab_cumul), tab_stride = _shared_or_rows("decode_section_cuda", (tab_sym, tab_freq, tab_cumul), nb)
    dev = build.check_cuda("decode_section_cuda", states, stream, read_pos, tab_sym, tab_freq, tab_cumul, valid_counts,
                           int16=(1, 4, 5), uint8=(3,))
    if states.dim() != 2 or states.shape[1] not in LANES or not 0 <= bits < 32 or num_steps < 0:
        raise ValueError("decode_section_cuda: states must be [B, N] with N in (16, 32, 64), bits in 0..31")
    if read_pos.shape != (nb,) or valid_counts.shape != (nb,) or stream.dim() not in (1, 2) or (
        stream.dim() == 2 and stream.shape[0] != nb
    ):
        raise ValueError("decode_section_cuda: operand shapes do not match the stream count")
    n = states.shape[1]
    syms = torch.empty((nb, num_steps, n), dtype=torch.uint8, device=dev)
    fin = torch.empty((nb, n), dtype=torch.int32, device=dev)
    pos = torch.empty(nb, dtype=torch.int32, device=dev)
    if nb:
        launch_decode(states, stream, read_pos, tab_sym, tab_freq, tab_cumul, tab_stride, valid_counts, syms, fin, pos,
                      bits=bits, tail=tail)
    return syms, fin, pos


def launch_decode(states, stream, read_pos, tab_sym, tab_freq, tab_cumul, tab_stride: int, valid_counts, syms, fin,
                  pos, *, bits: int, tail: bool) -> None:
    """One launch of the decode kernel into the outputs given (syms uint8
    [B, S, N], fin int32 [B, N], pos int32 [B]); decode_section_cuda's
    checks are the caller's."""
    nb, num_steps, n = syms.shape
    w = stream.shape[-1]
    build.launch(
        "scan_decode", "hsr_scan_decode", states.device,
        states.data_ptr(), stream.data_ptr(), w if stream.dim() == 2 else 0, w, read_pos.data_ptr(),
        tab_sym.data_ptr(), tab_freq.data_ptr(), tab_cumul.data_ptr(), tab_stride, tab_sym.shape[-1],
        valid_counts.data_ptr(), syms.data_ptr(), fin.data_ptr(), pos.data_ptr(), nb, n, bits, num_steps, int(tail),
    )


def decode_section_kernel(states, stream, read_pos, tab_sym, tab_freq, tab_cumul, valid_counts, *, bits: int,
                          num_steps: int, tail: bool):
    """The kernel for CUDA operands, its plain version for CPU operands."""
    fn = decode_section_plain if states.device.type == "cpu" else decode_section_cuda
    return fn(states, stream, read_pos, tab_sym, tab_freq, tab_cumul, valid_counts, bits=bits, num_steps=num_steps,
              tail=tail)


def encode_section_cuda(states, group_bytes, valid, freq_tab, cumul_tab, *, bits: int, num_steps: int):
    """The encode kernel (`csrc/scan.cu`) on CUDA tensors; same contract as
    encode_section_plain.  Raises for any other tensor."""
    nb = states.shape[0] if states.dim() == 2 else -1
    (freq_tab, cumul_tab), tab_stride = _shared_or_rows("encode_section_cuda", (freq_tab, cumul_tab), nb)
    if valid.dtype != torch.bool:
        raise ValueError("encode_section_cuda: valid must be bool")
    dev = build.check_cuda("encode_section_cuda", states, group_bytes, valid.view(torch.uint8), freq_tab, cumul_tab,
                           uint8=(1, 2), int16=(3, 4))
    if states.dim() != 2 or states.shape[1] not in LANES or not 0 <= bits < 32 or num_steps < 0:
        raise ValueError("encode_section_cuda: states must be [B, N] with N in (16, 32, 64), bits in 0..31")
    n = states.shape[1]
    if group_bytes.shape != (nb, num_steps, n) or valid.shape != (nb, num_steps, n) or freq_tab.shape[-1] != 256:
        raise ValueError("encode_section_cuda: operand shapes do not match [B, num_steps, N] and 256-entry tables")
    words = torch.empty((nb, num_steps, n), dtype=torch.int16, device=dev)
    emits = torch.empty((nb, num_steps, n), dtype=torch.bool, device=dev)
    fin = torch.empty((nb, n), dtype=torch.int32, device=dev)
    if nb:
        launch_encode(states, group_bytes, valid, freq_tab, cumul_tab, tab_stride, words, emits, fin, bits=bits)
    return words, emits, fin


def launch_encode(states, group_bytes, valid, freq_tab, cumul_tab, tab_stride: int, words, emits, fin, *,
                  bits: int) -> None:
    """One launch of the encode kernel into the outputs given (words int16
    [B, S, N], emits bool [B, S, N], fin int32 [B, N]);
    encode_section_cuda's checks are the caller's."""
    nb, num_steps, n = words.shape
    build.launch(
        "scan_encode", "hsr_scan_encode", states.device,
        states.data_ptr(), group_bytes.data_ptr(), valid.data_ptr(), freq_tab.data_ptr(), cumul_tab.data_ptr(),
        tab_stride, words.data_ptr(), emits.data_ptr(), fin.data_ptr(), nb, n, bits,
        encode_emit_point_16(bits) & _M32, num_steps, magic_tensor(states.device).data_ptr(),
    )


def encode_section_kernel(states, group_bytes, valid, freq_tab, cumul_tab, *, bits: int, num_steps: int):
    """The kernel for CUDA operands, its plain version for CPU operands."""
    fn = encode_section_plain if states.device.type == "cpu" else encode_section_cuda
    return fn(states, group_bytes, valid, freq_tab, cumul_tab, bits=bits, num_steps=num_steps)
