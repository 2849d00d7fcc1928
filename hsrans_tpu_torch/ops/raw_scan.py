"""The raw 16w wire on the device: the port of `hsrans_tpu/ops/raw_jax.py`.

`decode_section` and `encode_section` take the JAX functions' shapes (any
leading batch axes, or none; the stream and the tables shared by every
stream or one row a stream) and run `kernels/scan.py`'s two kernels on the
tensors' device, or their plain versions where the tensors lie on the CPU.
`raw_decode_torch` and `raw_encode_torch` take the place of `raw_decode_jax`
and `raw_encode_jax`: the same host checks and the same bytes, the wire's
lane groups gathered, coded and compacted on the card.  A raw blob is one
stream, so its decode and its encode are each one chain of ceil(length / n)
links (csrc/scan.cu).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..kernels.scan import decode_section_kernel, encode_section_kernel
from ..models.histogram import Hist, complete_hist
from ..models.tables import make_dec3
from ..rans import DECODE_CONSUME_POINT_16, IDX2IDX, INV_IDX2IDX
from ..runtime.device import resolve
from .reference import _as_array

_STORAGE = {torch.uint32: torch.int32, torch.uint16: torch.int16}


def _tensor(x) -> torch.Tensor:
    """A tensor, a numpy array or scalar as a tensor, u32 and u16 as int32
    and int16 storage of the same bits."""
    if not isinstance(x, torch.Tensor):
        a = np.asarray(x)
        x = torch.from_numpy(a if a.flags.c_contiguous else np.ascontiguousarray(a))
    t = x
    return t.view(_STORAGE[t.dtype]) if t.dtype in _STORAGE else t


def _rows(x, lead: tuple[int, ...], nb: int, dev: torch.device) -> torch.Tensor:
    """A stream or a table as the kernels take it: one row a stream where
    it has the states' leading axes ([..., T] -> [B, T]), else shared [T]."""
    t = _tensor(x).to(dev)
    if t.dim() == len(lead) + 1:
        return t.reshape(nb, t.shape[-1]).contiguous()
    if t.dim() != 1:
        raise ValueError("a shared stream or table must be one-dimensional")
    return t.contiguous()


def decode_section(states, stream, read_pos, tab_sym, tab_freq, tab_cumul, valid_counts, *, bits: int,
                   num_steps: int, tail: bool):
    """`hsrans_tpu.ops.raw_jax.decode_section` on tensors: decode `num_steps`
    lane groups of every stream; returns (symbols uint8 [..., S, N] in lane
    order, final states [..., N] in the states' dtype, read_pos int32 [...]).

    states u32 (or int32 bits) [..., N], stream u16 [..., W] or shared [W],
    read_pos int32 [...], tab_sym u8 and tab_freq, tab_cumul u16 [..., 2^B]
    or shared, valid_counts int32 [...] (or broadcast to it); numpy arrays
    are taken too.  Runs on the states' device (the CUDA kernel, or its
    plain version on the CPU); the contract is kernels/scan.py's."""
    st = _tensor(states)
    dev, lead, n = st.device, tuple(st.shape[:-1]), st.shape[-1]
    nb = math.prod(lead)
    syms, fin, pos = decode_section_kernel(
        st.to(torch.int32).reshape(nb, n).contiguous(),
        _rows(stream, lead, nb, dev),
        _tensor(read_pos).to(dev, torch.int32).reshape(nb).contiguous(),
        *(_rows(t, lead, nb, dev) for t in (tab_sym, tab_freq, tab_cumul)),
        torch.broadcast_to(_tensor(valid_counts).to(dev, torch.int32), lead).reshape(nb).contiguous(),
        bits=bits, num_steps=num_steps, tail=tail,
    )
    fin = fin.reshape(*lead, n)
    return syms.reshape(*lead, num_steps, n), fin.view(torch.uint32) if _is_u32(states) else fin, pos.reshape(lead)


def encode_section(states, group_bytes, valid, freq_tab, cumul_tab, *, bits: int, num_steps: int):
    """`hsrans_tpu.ops.raw_jax.encode_section` on tensors: encode
    `num_steps` groups last to first; returns (words u16 [..., S, N], emit
    bool [..., S, N], final states [..., N] in the states' dtype).

    states u32 (or int32 bits) [..., N], group_bytes u8 [..., S, N] in lane
    order, valid bool [..., S, N], freq_tab and cumul_tab u16 [256] or
    [..., 256]; numpy arrays are taken too.  Runs on the states' device; the
    contract is kernels/scan.py's.  The forward wire stream is
    words[emit]."""
    st = _tensor(states)
    dev, lead, n = st.device, tuple(st.shape[:-1]), st.shape[-1]
    nb = math.prod(lead)
    words, emits, fin = encode_section_kernel(
        st.to(torch.int32).reshape(nb, n).contiguous(),
        _tensor(group_bytes).to(dev).reshape(nb, num_steps, n).contiguous(),
        _tensor(valid).to(dev, torch.bool).reshape(nb, num_steps, n).contiguous(),
        *(_rows(t, lead, nb, dev) for t in (freq_tab, cumul_tab)),
        bits=bits, num_steps=num_steps,
    )
    fin = fin.reshape(*lead, n)
    return (words.view(torch.uint16).reshape(*lead, num_steps, n), emits.reshape(*lead, num_steps, n),
            fin.view(torch.uint32) if _is_u32(states) else fin)


def _is_u32(x) -> bool:
    return x.dtype == torch.uint32 if isinstance(x, torch.Tensor) else np.asarray(x).dtype == np.uint32


def raw_decode_operands(blob: bytes | np.ndarray, bits: int, n: int, dev: torch.device):
    """The scan decode's operands of a raw 16w blob on `dev`, with the JAX
    decoder's host checks: None below 16 + 512 + 4n bytes, where the
    header's size exceeds the blob's, or where the freqs do not sum to
    2^bits; else (length, (states [1, n], the word stream padded with 2n
    zero words, an odd last byte dropped, read_pos, the three shared
    slot-indexed tables, valid count [1]) or None where length is 0)."""
    buf = _as_array(blob)
    if buf.size < 16 + 512 + 4 * n:
        return None
    length = int.from_bytes(buf[0:8].tobytes(), "little")
    expected_in = int.from_bytes(buf[8:16].tobytes(), "little")
    if buf.size < expected_in:
        return None
    hist = complete_hist(buf[16:528].view("<u2"), bits)
    if hist is None:
        return None
    states = buf[528 : 528 + 4 * n].view("<u4").astype(np.uint32)
    word_bytes = (buf.size - 528 - 4 * n) // 2 * 2
    stream = np.zeros(word_bytes // 2 + 2 * n, dtype=np.uint16)
    stream[: word_bytes // 2] = buf[528 + 4 * n : 528 + 4 * n + word_bytes].view("<u2")
    if length == 0:
        return length, None
    tab = make_dec3(hist)
    host = (states.view(np.int32)[None], stream.view(np.int16), np.zeros(1, np.int32), tab["sym"],
            tab["freq"].astype(np.uint16).view(np.int16), tab["cumul"].astype(np.uint16).view(np.int16),
            np.array([length], np.int32))
    return length, tuple(torch.from_numpy(a).to(dev) for a in host)


def raw_decode_torch(blob: bytes | np.ndarray, bits: int, n_lanes: int, device: str | torch.device = "cuda") -> bytes | None:
    """Decode a raw 16w wire blob on `device`; None on malformed input,
    exactly where `hsrans_tpu.ops.raw_jax.raw_decode_jax` gives None, and
    its bytes everywhere else: one scan decode of the whole blob, one
    stream of ceil(length / n) groups with its tail masked."""
    dev = resolve(device)
    got = raw_decode_operands(blob, bits, n_lanes, dev)
    if got is None:
        return None
    length, ops = got
    if ops is None:
        return b""
    syms, _, _ = decode_section_kernel(*ops, bits=bits, num_steps=-(-length // n_lanes), tail=True)
    inv = torch.from_numpy(INV_IDX2IDX[n_lanes]).to(dev)
    return syms[0][:, inv].reshape(-1)[:length].cpu().numpy().tobytes()


def raw_encode_torch(data: bytes | np.ndarray, hist: Hist, n_lanes: int, device: str | torch.device = "cuda") -> bytes:
    """Encode one buffer with a static histogram on `device`; the bytes of
    `hsrans_tpu.ops.raw_jax.raw_encode_jax` and of the reference's scalar
    encoder.  The lane groups are gathered on the device, coded by one
    `encode_section`, and their emitted words compacted there."""
    dev = resolve(device)
    arr = _as_array(data)
    n = n_lanes
    length = arr.size
    bits = hist.total_symbol_count_bits
    total = -(-length // n) if length else 0
    states = torch.full((n,), DECODE_CONSUME_POINT_16, dtype=torch.int32, device=dev)
    if total:
        padded = torch.zeros(total * n, dtype=torch.uint8, device=dev)
        padded[:length] = torch.from_numpy(arr).to(dev)
        perm = torch.from_numpy(IDX2IDX[n]).to(dev)
        valid = torch.arange(total, device=dev)[:, None] * n + perm[None, :] < length
        words, emits, states = encode_section(
            states, padded.view(total, n)[:, perm], valid,
            torch.from_numpy(hist.symbol_count.astype(np.uint16)), torch.from_numpy(hist.cumul.astype(np.uint16)),
            bits=bits, num_steps=total,
        )
        stream = torch.masked_select(words.view(torch.int16), emits).cpu().numpy()
    else:
        stream = np.zeros(0, dtype=np.int16)
    out = bytearray()
    out += int(length).to_bytes(8, "little")
    out += b"\0" * 8
    out += hist.symbol_count.astype("<u2").tobytes()
    out += states.cpu().numpy().astype("<i4").tobytes()
    out += stream.astype("<i2").tobytes()
    out[8:16] = len(out).to_bytes(8, "little")
    return bytes(out)
