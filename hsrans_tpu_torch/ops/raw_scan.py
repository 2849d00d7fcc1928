"""The raw 16w wire on the device: the port of `hsrans_tpu/ops/raw_jax.py`.

`decode_section` and `encode_section` take the JAX functions' shapes (any
leading batch axes, or none; the stream and the tables shared by every
stream or one row a stream) and run `kernels/scan.py`'s two kernels on the
tensors' device, or their plain versions where the tensors lie on the CPU.
`raw_decode_torch` and `raw_encode_torch` take the place of `raw_decode_jax`
and `raw_encode_jax`: the same host checks and the same bytes, the wire's
lane groups gathered, coded and compacted on the card.  A raw blob is one
stream, so its decode and its encode are each one chain of ceil(length / n)
links (csrc/scan.cu).  Both open their root range and their layers'
ranges under a profiler (`runtime/device.py`), the kernel's as
`kernel_scan`; `SCAN_COUNTS` counts what the two sections ran, and what
`decode_placed` ran (the decode with each symbol stored at its output
byte, which mt's batched blocks take).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..kernels.scan import decode_placed_kernel, decode_section_kernel, encode_section_kernel
from ..models.histogram import Hist, complete_hist
from ..models.tables import make_dec3
from ..rans import DECODE_CONSUME_POINT_16, IDX2IDX, INV_IDX2IDX
from ..runtime.device import Output, entry_span, layer_clock, resolve, span, tensor_of, to_card
from .reference import _as_array

# The scan kernels' runs through `decode_section` and `encode_section` in
# this process, by operation: the calls, the streams and the chain links
# (num_steps x streams).  A raw blob's decode or encode is 1 call, 1 stream
# and ceil(length / n) links.
SCAN_COUNTS: dict[str, dict[str, int]] = {op: {"calls": 0, "streams": 0, "links": 0} for op in ("decode", "encode")}


def _count(op: str, streams: int, num_steps: int) -> None:
    c = SCAN_COUNTS[op]
    c["calls"] += 1
    c["streams"] += streams
    c["links"] += streams * num_steps


def _rows(x, lead: tuple[int, ...], nb: int, dev: torch.device) -> torch.Tensor:
    """A stream or a table as the kernels take it: one row a stream where
    it has the states' leading axes ([..., T] -> [B, T]), else shared [T]."""
    t = to_card(x, dev)
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
    st = tensor_of(states)
    dev, lead, n = st.device, tuple(st.shape[:-1]), st.shape[-1]
    nb = math.prod(lead)
    _count("decode", nb, num_steps)
    syms, fin, pos = decode_section_kernel(
        st.to(torch.int32).reshape(nb, n).contiguous(),
        _rows(stream, lead, nb, dev),
        to_card(read_pos, dev).to(torch.int32).reshape(nb).contiguous(),
        *(_rows(t, lead, nb, dev) for t in (tab_sym, tab_freq, tab_cumul)),
        torch.broadcast_to(to_card(valid_counts, dev).to(torch.int32), lead).reshape(nb).contiguous(),
        bits=bits, num_steps=num_steps, tail=tail,
    )
    fin = fin.reshape(*lead, n)
    return syms.reshape(*lead, num_steps, n), fin.view(torch.uint32) if _is_u32(states) else fin, pos.reshape(lead)


def decode_placed(states, stream, read_pos, tab_sym, tab_freq, tab_cumul, valid_counts, out_starts, out, *,
                  bits: int, num_steps: int, tail: bool):
    """The scan decode with each symbol placed: stream b's symbol of lane j
    in group g goes to out[out_starts[b] + g*N + IDX2IDX[N][j]] (uint8 out,
    int64 out_starts [B]) where the lane takes it, in place of
    decode_section's lane-order matrix; no other byte of `out` is written.
    The operands are the kernels' own ([B, ...] tensors on one device,
    `kernels/scan.py`); returns (final states int32 [B, N], read_pos int32
    [B]).  Counted in SCAN_COUNTS as a decode."""
    _count("decode", states.shape[0], num_steps)
    return decode_placed_kernel(states, stream, read_pos, tab_sym, tab_freq, tab_cumul, valid_counts, out_starts, out,
                                bits=bits, num_steps=num_steps, tail=tail)


def encode_section(states, group_bytes, valid, freq_tab, cumul_tab, *, bits: int, num_steps: int):
    """`hsrans_tpu.ops.raw_jax.encode_section` on tensors: encode
    `num_steps` groups last to first; returns (words u16 [..., S, N], emit
    bool [..., S, N], final states [..., N] in the states' dtype).

    states u32 (or int32 bits) [..., N], group_bytes u8 [..., S, N] in lane
    order, valid bool [..., S, N], freq_tab and cumul_tab u16 [256] or
    [..., 256]; numpy arrays are taken too.  Runs on the states' device; the
    contract is kernels/scan.py's.  The forward wire stream is
    words[emit]."""
    st = tensor_of(states)
    dev, lead, n = st.device, tuple(st.shape[:-1]), st.shape[-1]
    nb = math.prod(lead)
    _count("encode", nb, num_steps)
    words, emits, fin = encode_section_kernel(
        st.to(torch.int32).reshape(nb, n).contiguous(),
        to_card(group_bytes, dev).reshape(nb, num_steps, n).contiguous(),
        to_card(valid, dev).to(torch.bool).reshape(nb, num_steps, n).contiguous(),
        *(_rows(t, lead, nb, dev) for t in (freq_tab, cumul_tab)),
        bits=bits, num_steps=num_steps,
    )
    fin = fin.reshape(*lead, n)
    return (words.view(torch.uint16).reshape(*lead, num_steps, n), emits.reshape(*lead, num_steps, n),
            fin.view(torch.uint32) if _is_u32(states) else fin)


def _is_u32(x) -> bool:
    return x.dtype == torch.uint32 if isinstance(x, torch.Tensor) else np.asarray(x).dtype == np.uint32


def raw_parse(blob: bytes | np.ndarray, bits: int, n: int):
    """The header of a raw 16w blob, with the JAX decoder's host checks:
    None below 16 + 512 + 4n bytes, where the header's size exceeds the
    blob's, or where the freqs do not sum to 2^bits; else (length, hist,
    the n states u32, the blob as u8)."""
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
    return length, hist, buf[528 : 528 + 4 * n].view("<u4").astype(np.uint32), buf


def raw_host_operands(length: int, hist: Hist, states: np.ndarray, buf: np.ndarray, n: int) -> tuple[np.ndarray, ...]:
    """The scan decode's operands on the host: states [1, n], the word stream
    padded with 2n zero words (an odd last byte dropped), read_pos, the
    three shared slot-indexed tables, valid count [1]."""
    word_bytes = (buf.size - 528 - 4 * n) // 2 * 2
    stream = np.zeros(word_bytes // 2 + 2 * n, dtype=np.uint16)
    stream[: word_bytes // 2] = buf[528 + 4 * n : 528 + 4 * n + word_bytes].view("<u2")
    tab = make_dec3(hist)
    return (states[None], stream, np.zeros(1, np.int32), tab["sym"], tab["freq"].astype(np.uint16),
            tab["cumul"].astype(np.uint16), np.array([length], np.int32))


@entry_span
def raw_decode_torch(blob: bytes | np.ndarray, bits: int, n_lanes: int, device: str | torch.device = "cuda",
                     layers: dict[str, float] | None = None) -> bytes | None:
    """Decode a raw 16w wire blob on `device`; None on malformed input,
    exactly where `hsrans_tpu.ops.raw_jax.raw_decode_jax` gives None, and
    its bytes everywhere else: one scan decode of the whole blob, one
    stream of ceil(length / n) groups with its tail masked.

    With `layers`, adds the seconds of each layer of this call to it
    (host_parse, host_tables, h2d, kernel_scan, gather, d2h,
    host_assemble), the device synchronized at each boundary."""
    dev = resolve(device)
    with layer_clock(layers, "host_parse", dev):
        parsed = raw_parse(blob, bits, n_lanes)
    if parsed is None:
        return None
    length, hist, states, buf = parsed
    if length == 0:
        return b""
    with layer_clock(layers, "host_tables", dev):
        host = raw_host_operands(length, hist, states, buf, n_lanes)
    with layer_clock(layers, "h2d", dev):
        ops = tuple(to_card(a, dev) for a in host)
        inv = to_card(INV_IDX2IDX[n_lanes], dev)
    with layer_clock(layers, "kernel_scan", dev):
        syms, _, _ = decode_section(*ops, bits=bits, num_steps=-(-length // n_lanes), tail=True)
    with layer_clock(layers, "gather", dev):
        got = syms[0][:, inv].reshape(-1)[:length]
    with layer_clock(layers, "host_assemble", dev):
        out = Output(length)
    with out, layer_clock(layers, "d2h", dev):
        out.put(0, got)
    with span("host_release"):  # the padded word stream's pages, returned here rather than as the frame ends
        del host
    return out.result


@entry_span
def raw_encode_torch(data: bytes | np.ndarray, hist: Hist, n_lanes: int, device: str | torch.device = "cuda",
                     layers: dict[str, float] | None = None) -> bytes:
    """Encode one buffer with a static histogram on `device`; the bytes of
    `hsrans_tpu.ops.raw_jax.raw_encode_jax` and of the reference's scalar
    encoder.  The lane groups are gathered on the device, coded by one
    `encode_section`, and their emitted words compacted there.

    With `layers`, adds the seconds of each layer of this call to it
    (host_layout, h2d, gather: the lane groups and the compaction,
    kernel_scan, d2h, host_mux), the device synchronized at each
    boundary."""
    dev = resolve(device)
    n = n_lanes
    with layer_clock(layers, "host_layout", dev):
        arr = _as_array(data)
        length = arr.size
        bits = hist.total_symbol_count_bits
        total = -(-length // n) if length else 0
        tabs = (hist.symbol_count.astype(np.uint16), hist.cumul.astype(np.uint16))
    if total:
        with layer_clock(layers, "h2d", dev):
            src = to_card(arr, dev)
            perm = to_card(IDX2IDX[n], dev)
            freq, cumul = (to_card(t, dev) for t in tabs)
        with layer_clock(layers, "gather", dev):
            padded = torch.zeros(total * n, dtype=torch.uint8, device=dev)
            padded[:length] = src
            valid = torch.arange(total, device=dev)[:, None] * n + perm[None, :] < length
            groups = padded.view(total, n)[:, perm]
            states = torch.full((n,), DECODE_CONSUME_POINT_16, dtype=torch.int32, device=dev)
        with layer_clock(layers, "kernel_scan", dev):
            words, emits, states = encode_section(states, groups, valid, freq, cumul, bits=bits, num_steps=total)
        with layer_clock(layers, "gather", dev):
            kept = torch.masked_select(words.view(torch.int16), emits)
    else:
        kept = torch.zeros(0, dtype=torch.int16)
        states = torch.full((n,), DECODE_CONSUME_POINT_16, dtype=torch.int32)
    with layer_clock(layers, "host_mux", dev):
        # u64 length, u64 blob size, the 256 u16 freqs; then the n u32 states and the u16 words
        size = 528 + 4 * n + 2 * kept.numel()
        out = Output(size)
        fields = (np.array([length, size], "<u8"), hist.symbol_count.astype("<u2"))
        out.part(0, 528)[:] = np.concatenate([f.view(np.uint8) for f in fields])
    with out, layer_clock(layers, "d2h", dev):
        out.put(528, states.view(torch.uint8))
        out.put(528 + 4 * n, kept.view(torch.uint8))
    return out.result
