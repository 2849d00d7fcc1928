"""mt encode: the port of `hsrans_tpu/kernels/mt64_encode.py::mt64_encode_tpu`
to PyTorch and CUDA (`csrc/mt_encode.cu`).

Every coded block is encoded from fresh states, as the JAX package's device
encoders do: each mt block carries its own state snapshot, so the blob is
valid wire that the C++ reference and `mt_decode_torch` decode, byte-
different from the carried-state oracle `ops.mt.mt_encode_py`.  The host
makes one small index row per coded block and the input goes to the card as
it is; the histograms of plan rows without freqs are taken there, by the
two kernels of `models/device_hist.py` (one launch each), and stay there.
One launch encodes every coded block
(`encode_blocks`), each block's words landing in wire order at the end of
its own scratch region; the host turns the word counts into the blob's part
offsets, and one more launch writes the whole blob (`place_blocks`): its
head, each coded block's part, header and words, and each single-symbol
indicator, at its offset.  Unlike the JAX package, no coded block goes to a
host encoder (the final block, and sizes off its kernel's 512-byte grid,
included); the bytes are the same.  At n = 16, where the JAX package's
`mt_encode_device` runs the XLA scan `encode_section`, the blocks go
through the scan encode kernel of `kernels/scan.py` instead
(`encode_blocks_scan`), and the same placement writes the wire.
"""

from __future__ import annotations

import functools
import warnings

import numpy as np
import torch

from ..models.device_hist import segment_hists
from ..ops.mt import _as_array
from ..ops.planner import BlockPlan
from ..rans import DECODE_CONSUME_POINT_16, IDX2IDX
from ..runtime import build
from ..runtime.device import layer_clock, resolve, shares
from .scan import encode_section_kernel
from .tpx_decode import from_u32, to_u32

_M32 = 0xFFFFFFFF
_SINGLE_BIT = 1 << 63
_SYM_SHIFT = 54
# columns of the int64 per-block index; csrc/mt_encode.cu::EncIndex
INDEX_FIELDS = ("in_start", "num_groups", "byte_limit", "valid_limit", "region_end")
# columns of the int64 per-part placement rows; csrc/mt_encode.cu::PlaceRow
PLACE_FIELDS = ("dest", "value", "block", "bias")
# the two encoders of the JAX package differ in how a symbol of freq 0 emits
# (only where a lane reads a byte that its block's freqs do not cover):
# ops/reference.py::encode_groups emits always, ops/raw_jax.py::encode_section
# tests the state against the emit point of freq 1
RULES = ("groups", "section")
# the encode kernel's magic table covers every divisor a block can have:
# freqs sum to 2^B <= 2^15
MAGIC_D_MAX = 1 << 15


def coded_header_u16(n: int) -> int:
    """u16s of a coded block's header: size, offset, n states, 256 freqs."""
    return 4 + 4 + 2 * n + 256


def encode_tables(freqs: torch.Tensor, bits: int, rule: str) -> tuple[torch.Tensor, ...]:
    """Per-symbol encode operands of the kernel's shared-memory table, as the
    kernel builds them from freqs int16 [nb, 256] (u16 bits): (e, cumul, d,
    magic m, shift l), each int64 [nb, 256].  d = max(freq, 1) and
    q = (m * x) >> (31 + l) == x // d for every x < 2^31 (Granlund-
    Montgomery); e is the freq the emit test scales (RULES)."""
    f = freqs.to(torch.int64) & 0xFFFF
    cum = (torch.cumsum(f, dim=1) - f) & 0xFFFF  # u16 on the wire
    d = torch.clamp(f, min=1)
    l = shift_tensor(f.device)[d].to(torch.int64)
    m = magic_tensor(f.device)[d].to(torch.int64) & _M32
    e = f if rule == "groups" else d
    return e, cum, d, m, l


def shift_table() -> np.ndarray:
    """int32 [MAGIC_D_MAX + 1]: at d the shift l = ceil(log2 max(d, 1))."""
    d = np.maximum(np.arange(MAGIC_D_MAX + 1, dtype=np.int64), 1)
    l = np.zeros_like(d)
    for k in range(16):
        l = np.where(d > (1 << k), k + 1, l)
    return l.astype(np.int32)


def magic_table() -> np.ndarray:
    """uint32 [MAGIC_D_MAX + 1]: at d the Granlund-Montgomery magic of
    max(d, 1), m = ceil(2^(31 + l) / d) with l = shift_table()[d], so that
    (m * x) >> (31 + l) == x // d for every x < 2^31.  The encode kernel
    reads a block's m from it by freq, in place of a 64-bit division per
    symbol and block."""
    d = np.maximum(np.arange(MAGIC_D_MAX + 1, dtype=np.int64), 1)
    return (-(-(np.int64(1) << (31 + shift_table().astype(np.int64))) // d)).astype(np.uint32)


@functools.cache
def magic_tensor(dev: torch.device) -> torch.Tensor:
    """magic_table() as int32 (u32 bits) on `dev`, made once per device."""
    return torch.from_numpy(magic_table().view(np.int32)).to(dev)


@functools.cache
def shift_tensor(dev: torch.device) -> torch.Tensor:
    """shift_table() on `dev`, made once per device."""
    return torch.from_numpy(shift_table()).to(dev)


def encode_blocks_plain(data, index, freqs, *, bits: int, n: int, rule: str, words_cap: int):
    """Plain PyTorch version of the encode kernel, on any device.

    data uint8 [length] (the input), index int64 [nb, 5] (INDEX_FIELDS),
    freqs int16 [nb, 256] (u16, summing to 2^B) -> (words int16 [words_cap]:
    block b's emitted words, u16, in wire order (group ascending, lane
    ascending) at the end of its region, i.e. at [region_end - count,
    region_end), 0 elsewhere; count int64 [nb]; final states int32 [nb, n]
    (u32 bits), the block header's).  Block b encodes num_groups groups
    backward from DECODE_CONSUME_POINT_16; lane j of group g codes byte
    in_start + g*n + IDX2IDX[n][j], read as 0 from byte_limit (or the input's
    end) on, and takes part while that position is below valid_limit.
    Vectorized over blocks, looping to the largest num_groups."""
    dev = data.device
    nb = index.shape[0]
    words = torch.zeros(words_cap, dtype=torch.int64, device=dev)
    st = torch.full((nb, n), DECODE_CONSUME_POINT_16, dtype=torch.int64, device=dev)
    tail = index[:, 4].clone()
    if nb == 0:
        return words.to(torch.int16), torch.zeros(0, dtype=torch.int64, device=dev), from_u32(st)
    e_t, cum_t, d_t, m_t, l_t = encode_tables(freqs, bits, rule)
    in_start, num_groups, byte_limit, valid_limit, _ = (c[:, None] for c in index.unbind(1))
    byte_limit = torch.clamp(byte_limit, max=data.numel())
    perm = torch.from_numpy(IDX2IDX[n]).to(dev)[None, :]
    src = data.to(torch.int64) if data.numel() else torch.zeros(1, dtype=torch.int64, device=dev)
    for g in range(int(index[:, 1].max()) - 1, -1, -1):
        pos = in_start + g * n + perm
        inside = (pos >= 0) & (pos < byte_limit)
        byte = torch.where(inside, src[torch.clamp(pos, 0, src.numel() - 1)], 0)
        valid = (g < num_groups) & (pos < valid_limit)
        e, cum, d, m, l = (torch.gather(t, 1, byte) for t in (e_t, cum_t, d_t, m_t, l_t))
        emit = valid & (st >= e << (31 - bits))
        word = st & 0xFFFF
        x = torch.where(emit, st >> 16, st)
        q = (m * x) >> (31 + l)  # < 2^63: m < 2^32, x < 2^31
        st = torch.where(valid, ((q << bits) + cum + x - q * d) & _M32, st)
        c = emit.to(torch.int64)
        tail = tail - c.sum(dim=1)
        at = tail[:, None] + torch.cumsum(c, dim=1) - c  # lane-ascending within the group
        words[at[emit]] = word[emit]
    return words.to(torch.int16), index[:, 4] - tail, from_u32(st)


def encode_blocks_cuda(data, index, freqs, *, bits: int, n: int, rule: str, words_cap: int):
    """The CUDA encode kernel (`csrc/mt_encode.cu`) on CUDA tensors; same
    contract as encode_blocks_plain, except that a region's slots below its
    words are left as they were (unwritten scratch).  Raises for any other
    tensor."""
    dev = build.check_cuda("encode_blocks_cuda", data, index, freqs, uint8=(0,), int64=(1,), int16=(2,))
    nb = index.shape[0]
    if n not in (32, 64) or not 1 <= bits <= 15 or rule not in RULES:
        raise ValueError("encode_blocks_cuda: n must be 32 or 64, bits 1..15 and rule one of RULES")
    if index.shape != (nb, len(INDEX_FIELDS)) or freqs.shape != (nb, 256):
        raise ValueError("encode_blocks_cuda: operand shapes do not match the block count")
    words = torch.empty(words_cap, dtype=torch.int16, device=dev)
    count = torch.empty(nb, dtype=torch.int64, device=dev)
    fin = torch.empty((nb, n), dtype=torch.int32, device=dev)
    if nb:
        launch_encode(data, index, freqs, words, count, fin, bits=bits, n=n, rule=rule)
    return words, count, fin


def launch_encode(data, index, freqs, words, count, fin, *, bits: int, n: int, rule: str) -> None:
    """One launch of the encode kernel into the outputs given (words int16
    [words_cap], count int64 [nb], fin int32 [nb, n] on the operands'
    device); encode_blocks_cuda's checks are the caller's."""
    dev = data.device
    build.launch(
        "mt_encode", "hsr_mt_encode", dev,
        data.data_ptr(), index.data_ptr(), freqs.data_ptr(), magic_tensor(dev).data_ptr(), words.data_ptr(),
        fin.data_ptr(), count.data_ptr(), index.shape[0], n, bits, int(rule == "groups"), data.numel(), words.numel(),
    )


def encode_blocks(data, index, freqs, *, bits: int, n: int, rule: str, words_cap: int):
    """The kernel for CUDA operands, its plain version for CPU operands."""
    fn = encode_blocks_plain if data.device.type == "cpu" else encode_blocks_cuda
    return fn(data, index, freqs, bits=bits, n=n, rule=rule, words_cap=words_cap)


def scan_operands(data, index, freqs, n: int):
    """The scan encode's operands of the coded blocks (index int64 [nb, 5]
    (INDEX_FIELDS), freqs int16 [nb, 256] on data's device): fresh states,
    each block's lane groups in lane order (a byte read as 0 from
    byte_limit on; a lane valid while its group is one of the block's and
    its position below valid_limit), its freqs and their cumuls (u16 wrap),
    and the step count, the longest block's groups."""
    dev = data.device
    f = freqs.to(torch.int64) & 0xFFFF
    cumul = ((torch.cumsum(f, dim=1) - f) & 0xFFFF).to(torch.int16)
    start, num_groups, byte_limit, valid_limit = (index[:, c, None, None] for c in range(4))
    steps = int(index[:, 1].max())
    g = torch.arange(steps, device=dev)[None, :, None]
    pos = start + g * n + torch.from_numpy(IDX2IDX[n]).to(dev)[None, None, :]
    src = data if data.numel() else torch.zeros(1, dtype=torch.uint8, device=dev)
    inside = (pos >= 0) & (pos < torch.clamp(byte_limit, max=data.numel()))
    group_bytes = torch.where(inside, src[torch.clamp(pos, 0, src.numel() - 1)], 0).to(torch.uint8)
    valid = (g < num_groups) & (pos < valid_limit)
    init = torch.full((index.shape[0], n), DECODE_CONSUME_POINT_16, dtype=torch.int32, device=dev)
    return init, group_bytes, valid, freqs, cumul, steps


def encode_blocks_scan(data, index, freqs, *, bits: int, n: int, rule: str, words_cap: int):
    """encode_blocks' contract at any lane count under the "section" rule,
    through the scan encode kernel (`kernels/scan.py`: the kernel for CUDA
    operands, its plain version for CPU operands): every block's lane
    groups gathered from the input (`scan_operands`), one call, and each
    block's emitted words, compacted in wire order, moved to the end of its
    region.  The scan encode is the JAX package's `encode_section`, whose
    emit test scales max(freq, 1): the "section" rule."""
    if rule != "section":
        raise ValueError("the scan encode follows the section rule")
    dev = data.device
    nb = index.shape[0]
    words = torch.zeros(words_cap, dtype=torch.int16, device=dev)
    if nb == 0:
        return words, torch.zeros(0, dtype=torch.int64, device=dev), torch.zeros((0, n), dtype=torch.int32, device=dev)
    *ops, steps = scan_operands(data, index, freqs, n)
    got, emits, fin = encode_section_kernel(*ops, bits=bits, num_steps=steps)
    count = emits.sum(dim=(1, 2))
    flat = torch.masked_select(got, emits)  # blocks in order, each in (group, lane) order
    shift = index[:, 4] - count - (torch.cumsum(count, 0) - count)
    words[torch.arange(flat.numel(), device=dev) + torch.repeat_interleave(shift, count, output_size=flat.numel())] = flat
    return words, count, fin


def emitted_words(words: torch.Tensor, index: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """Every block's emitted words, blocks in order: the part of the encode's
    scratch that its contract defines (the words of all coded blocks as the
    wire holds them, headers aside)."""
    end = index[:, 4]
    lens = count
    starts = torch.repeat_interleave(end - lens, lens)
    offs = torch.arange(int(lens.sum()), device=words.device) - torch.repeat_interleave(torch.cumsum(lens, 0) - lens, lens)
    return words[starts + offs]


def place_blocks_plain(words, index, count, fin, freqs, place, *, n: int, out_u16: int) -> torch.Tensor:
    """Plain PyTorch version of the placement kernel, on any device.

    words int16 [words_cap], index int64 [nb, 5], count int64 [nb], fin int32
    [nb, n], freqs int16 [nb, 256] (the encode's operands and results),
    place int64 [parts, 4] (PLACE_FIELDS, dest ascending, the parts tiling
    [0, out_u16)) -> uint8 [2 * out_u16], the blob: a part of block b >= 0
    at u16 dest is the u64 size field `value`, the u64 offset (2n + 256 +
    count - bias), the n final states as u32, the freqs as u16, then its
    words; a part of block -1 is the u64 `value` (the blob's head fields,
    the single-symbol indicators)."""
    dev = words.device
    out = torch.zeros(out_u16, dtype=torch.int64, device=dev)
    dest, value, block, bias = place.unbind(1)
    sh = torch.arange(4, device=dev) * 16
    lit = block < 0
    out[dest[lit][:, None] + torch.arange(4, device=dev)] = (value[lit][:, None] >> sh) & 0xFFFF
    coded = ~lit
    if coded.any():
        hdr = coded_header_u16(n)
        b = block[coded]
        offset = 2 * n + 256 + count[b] - bias[coded]
        st = to_u32(fin[b])
        fields = torch.cat(
            [
                (value[coded][:, None] >> sh) & 0xFFFF,
                (offset[:, None] >> sh) & 0xFFFF,
                torch.stack([st & 0xFFFF, st >> 16], dim=2).reshape(-1, 2 * n),
                freqs[b].to(torch.int64) & 0xFFFF,
            ],
            dim=1,
        )
        out[dest[coded][:, None] + torch.arange(hdr, device=dev)] = fields
        c = count[b]
        word_dest = torch.repeat_interleave(dest[coded] + hdr - (torch.cumsum(c, 0) - c), c)
        word_dest = word_dest + torch.arange(word_dest.numel(), device=dev)
        out[word_dest] = emitted_words(words, index[b], c).to(torch.int64) & 0xFFFF
    return out.to(torch.int16).view(torch.uint8)


def place_blocks_cuda(words, index, count, fin, freqs, place, *, n: int, out_u16: int) -> torch.Tensor:
    """The CUDA placement kernel (`csrc/mt_encode.cu`) on CUDA tensors; same
    contract as place_blocks_plain.  Raises for any other tensor."""
    dev = build.check_cuda(
        "place_blocks_cuda", words, index, count, fin, freqs, place, int16=(0, 4), int64=(1, 2, 5)
    )
    nb = index.shape[0]
    if n not in (16, 32, 64):
        raise ValueError("place_blocks_cuda: n must be 16, 32 or 64")
    if count.shape != (nb,) or fin.shape != (nb, n) or freqs.shape != (nb, 256) or place.shape[1:] != (len(PLACE_FIELDS),):
        raise ValueError("place_blocks_cuda: operand shapes do not match the block count")
    out = torch.empty(out_u16, dtype=torch.int16, device=dev)  # the parts tile the blob: the kernel writes every u16
    if place.shape[0]:
        launch_place(words, index, count, fin, freqs, place, out, n=n)
    return out.view(torch.uint8)


def launch_place(words, index, count, fin, freqs, place, out, *, n: int) -> None:
    """One launch of the placement kernel into `out` (int16 [out_u16], on
    the operands' device); place_blocks_cuda's checks are the caller's."""
    build.launch(
        "mt_place", "hsr_mt_wire", words.device,
        words.data_ptr(), index.data_ptr(), count.data_ptr(), fin.data_ptr(), freqs.data_ptr(), index.shape[0],
        place.data_ptr(), place.shape[0], out.data_ptr(), n, words.numel(), out.numel(),
    )


def place_blocks(words, index, count, fin, freqs, place, *, n: int, out_u16: int) -> torch.Tensor:
    """The kernel for CUDA operands, its plain version for CPU operands."""
    fn = place_blocks_plain if words.device.type == "cpu" else place_blocks_cuda
    return fn(words, index, count, fin, freqs, place, n=n, out_u16=out_u16)


def _input_tensor(arr: np.ndarray, dev: torch.device) -> torch.Tensor:
    """The input on `dev`, without a host copy where it is contiguous; it is
    only read, so a read-only buffer (bytes) is taken as it is."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="The given NumPy array is not writable")
        return torch.from_numpy(np.ascontiguousarray(arr)).to(dev)


def plan_rows(arr: np.ndarray, plan: list[BlockPlan], bits: int, n: int, rule: str):
    """The host's walk of the plan: (kinds int8 [rows]: 0 empty part, 1
    single-symbol indicator, 2 coded block; coded rows' plan positions int64
    [nb]; index int64 [nb, 5]; given bool [nb], the coded rows that carry
    their freqs; freqs uint16 [nb, 256], theirs and 0 for the others; offset
    bias int64 [nb]).  Raises ValueError for a row whose given freqs do not
    sum to 2^B.  Under the "groups" rule (mt64_encode_tpu) a coded row of
    size 0 writes nothing and a partial last group's lanes take part up to
    the input's end; under "section" (mt_encode_device) a size-0 row writes
    a header of no words and lanes take part up to the block's end."""
    length = arr.size
    kinds = np.zeros(len(plan), np.int8)
    coded = []
    for k, row in enumerate(plan):
        if row.is_single:
            kinds[k] = 1
        elif row.size or rule == "section":
            kinds[k] = 2
            coded.append(k)
    nb = len(coded)
    ks = np.asarray(coded, np.int64)
    start = np.fromiter((plan[k].start for k in coded), np.int64, nb)
    size = np.fromiter((plan[k].size for k in coded), np.int64, nb)
    byte_limit = np.minimum(start + size, length)
    freqs = np.zeros((nb, 256), np.uint16)
    given = np.fromiter((plan[k].freq is not None for k in coded), bool, nb)
    if given.any():
        freqs[given] = np.stack([plan[k].freq for k in ks[given]])
    bad = np.nonzero(given & (freqs.sum(axis=1, dtype=np.int64) != 1 << bits))[0]
    if bad.size:
        raise ValueError(f"plan row {coded[int(bad[0])]}: freqs do not sum to 2^{bits}")
    num_groups = -(-size // n)
    valid_limit = np.full(nb, length, np.int64) if rule == "groups" else byte_limit
    region_end = np.cumsum(num_groups * n)
    index = np.stack([start, num_groups, byte_limit, valid_limit, region_end], axis=1).reshape(nb, 5)
    bias = np.where(ks == len(plan) - 1, 2, 1).astype(np.int64)  # the final row points at the stream's end
    return kinds, ks, index, given, freqs, bias


def plan_freqs(data_t: torch.Tensor, ks: np.ndarray, index: np.ndarray, given: np.ndarray, freqs: np.ndarray,
               bits: int, n: int) -> torch.Tensor:
    """Every coded block's freqs as int16 [nb, 256] (u16) on data_t's device
    (data_t: the input there): the given rows' as they are, the others the
    histogram of the block's bytes within the input, as both JAX encoders
    take it, by `models/device_hist.py::segment_hists` over data_t (on the
    card one count launch and one normalise launch, the freqs left there).
    Raises ValueError, under "groups", for a row whose lanes past its end
    code the byte 0 while its freqs give 0 no slot: the decoder would read
    another symbol there, so the blob would not decode (mt64_encode_tpu
    returns that blob; the port refuses it)."""
    dev = data_t.device
    miss = np.nonzero(~given)[0]
    found = segment_hists(data_t, index[miss, 0], index[miss, 2], bits)[0] if miss.size else None
    if miss.size and miss.size == given.size:
        freqs_t = found  # no given freqs to send
    else:
        freqs_t = torch.from_numpy(freqs.view(np.int16)).to(dev)
        if miss.size:
            freqs_t[torch.from_numpy(miss).to(dev)] = found
    # the partial last group of a non-final block: under "groups" its lanes
    # past byte_limit code the byte 0 up to the input's end (ops/mt.py::_lane_groups)
    start, num_groups, byte_limit, valid_limit = index[:, :4].T
    lanes = np.nonzero(byte_limit < np.minimum(start + num_groups * n, valid_limit))[0]
    if lanes.size:
        zero = freqs_t[torch.from_numpy(lanes).to(freqs_t.device), 0].cpu().numpy() == 0
        if zero.any():
            raise ValueError(
                f"plan row {int(ks[lanes[np.argmax(zero)]])}: its last group's lanes past the block's end code "
                "the byte 0, which its freqs give no slot; the blob would not decode"
            )
    return freqs_t


def plan_operands(arr: np.ndarray, plan: list[BlockPlan], bits: int, n: int, rule: str):
    """Host side of one encode: (kinds, coded rows' plan positions, index,
    freqs uint16 [nb, 256], offset bias) of `plan_rows`, every coded row's
    freqs filled in on the CPU (`plan_freqs`, whose checks it makes)."""
    kinds, ks, index, given, freqs, bias = plan_rows(arr, plan, bits, n, rule)
    freqs_t = plan_freqs(_input_tensor(arr, torch.device("cpu")), ks, index, given, freqs, bits, n)
    return kinds, ks, index, freqs_t.numpy().view(np.uint16), bias


def part_layout(plan: list[BlockPlan], kinds: np.ndarray, ks: np.ndarray, bias: np.ndarray, count: np.ndarray, n: int,
                length: int) -> tuple[np.ndarray, int]:
    """Where each part of the blob goes, from the coded blocks' word counts:
    (the placement rows int64 [parts, 4] (PLACE_FIELDS), dest ascending, the
    blob's length in u16).  The blob is its head, two u64 (the input's
    length, the blob's bytes), then each plan row's part, in u16: an
    indicator 4, a coded block its header and words, an empty row none."""
    part = np.where(kinds == 1, 4, 0).astype(np.int64)
    part[ks] = coded_header_u16(n) + count
    dest = 8 + np.cumsum(part) - part
    out_u16 = 8 + int(part.sum())
    value = np.zeros(len(plan), np.uint64)
    block = np.full(len(plan), -1, np.int64)
    row_bias = np.zeros(len(plan), np.int64)
    value[ks] = np.fromiter((plan[k].size for k in ks), np.uint64, len(ks))
    block[ks] = np.arange(len(ks))
    row_bias[ks] = bias
    singles = np.nonzero(kinds == 1)[0]
    value[singles] = np.fromiter(
        (plan[k].size | _SINGLE_BIT | (plan[k].symbol << _SYM_SHIFT) for k in singles), np.uint64, singles.size
    )
    used = part > 0
    head = np.array([[0, length, -1, 0], [4, 2 * out_u16, -1, 0]], np.int64)
    rows = np.stack([dest[used], value[used].view(np.int64), block[used], row_bias[used]], axis=1)
    return np.concatenate([head, rows.reshape(-1, len(PLACE_FIELDS))]), out_u16


def encode_plan(
    arr: np.ndarray,
    plan: list[BlockPlan],
    bits: int,
    n: int,
    rule: str,
    devices: list[torch.device],
    layers: dict[str, float] | None = None,
) -> bytes:
    """The mt blob of `plan` over `arr` (n of 16, 32 or 64), every coded
    block encoded from fresh states (plan_rows says what `rule` changes),
    the histograms of rows without freqs too (`plan_freqs`).  The coded
    blocks are split over `devices` (`shares`: each a contiguous run); on
    each, their histograms and one encode launch, by the mt encode kernel
    at n = 32 and 64 (`encode_blocks`) and by the scan encode kernel at
    n = 16 (`encode_blocks_scan`); the words, counts and states are gathered
    in order on the first device, which writes the blob (`place_blocks`).
    The bytes do not depend on the split.  With `layers`, the host's walk
    of the plan counts as host_index and those histograms as
    kernel_hist."""
    if n not in (16, 32, 64) or not 1 <= bits <= 15:
        raise ValueError("mt encode needs n in (16, 32, 64) and 1 <= bits <= 15")
    encode = encode_blocks if n in (32, 64) else encode_blocks_scan
    dev = devices[0]
    length = arr.size
    with layer_clock(layers, "host_index", dev):
        kinds, ks, index, given, freqs, bias = plan_rows(arr, plan, bits, n, rule)
    outs = []
    for d, lo, hi in shares(devices, len(ks)):
        # a share's scratch regions start at 0 on its device; laid end to end
        # in order they are the whole call's
        sub = index[lo:hi].copy()
        sub[:, 4] -= index[lo - 1, 4] if lo else 0
        with layer_clock(layers, "h2d", d):
            data_t = _input_tensor(arr, d)
            index_t = torch.from_numpy(sub).to(d)
        with layer_clock(layers, "kernel_hist", d):
            freqs_t = plan_freqs(data_t, ks[lo:hi], sub, given[lo:hi], freqs[lo:hi], bits, n)
        with layer_clock(layers, "kernel_encode", d):
            words_cap = int(sub[-1, 4]) if hi > lo else 0
            outs.append((freqs_t, *encode(data_t, index_t, freqs_t, bits=bits, n=n, rule=rule, words_cap=words_cap)))
    if len(outs) > 1:
        with layer_clock(layers, "gather", dev):
            freqs_t, words_t, count_t, fin_t = (torch.cat([o[i].to(dev) for o in outs]) for i in range(4))
            index_t = torch.from_numpy(index).to(dev)
    else:
        freqs_t, words_t, count_t, fin_t = outs[0]
    with layer_clock(layers, "host_layout", dev):
        place, out_u16 = part_layout(plan, kinds, ks, bias, count_t.cpu().numpy(), n, length)
        place_t = torch.from_numpy(place).to(dev)
    with layer_clock(layers, "kernel_place", dev):
        blob_t = place_blocks(words_t, index_t, count_t, fin_t, freqs_t, place_t, n=n, out_u16=out_u16)
    with layer_clock(layers, "d2h", dev):
        blob = blob_t.cpu().numpy()
    with layer_clock(layers, "host_mux", dev):
        return blob.tobytes()


def _kernel_block_ok(size: int) -> bool:
    """mt64_encode_tpu's uniform block sizes: a multiple of 512, and of 8 KiB
    above 8 KiB."""
    return size % 512 == 0 and (size <= 8192 or size % 8192 == 0)


def uniform_rows(length: int, block_size: int) -> list[BlockPlan]:
    """mt64_encode_tpu's plan without one: `block_size` blocks, a remainder
    shorter than a lane group joined to the final block, freqs left to the
    encoder."""
    starts = list(range(0, length, block_size)) or [0]
    if len(starts) > 1 and length - starts[-1] < 64:
        starts.pop()
    ends = starts[1:] + [length]
    return [BlockPlan(s, e - s, False, 0, None) for s, e in zip(starts, ends)]


def mt_encode_torch(
    data: bytes | np.ndarray,
    bits: int,
    block_size: int = 4096,
    plan: list[BlockPlan] | None = None,
    device: str | torch.device = "cuda",
    layers: dict[str, float] | None = None,
) -> bytes:
    """Encode to the mt_rANS32x64 16w wire on `device`; equal to the JAX
    package's `mt64_encode_tpu(data, bits, block_size, plan=plan)`.

    Without `plan`: uniform `block_size` blocks (a multiple of 512, and of
    8 KiB above 8 KiB; ValueError otherwise).  With `plan` (the reference
    planner's rows, `parallel.sharded.device_plan`'s, ...): its blocks as
    they are, single-symbol rows as RLE indicators.

    With `layers`, adds the seconds of each layer of this call to it
    (host_index, h2d, kernel_hist, kernel_encode, host_layout,
    kernel_place, d2h, host_mux), the device synchronized at each
    boundary."""
    if plan is None and not _kernel_block_ok(block_size):
        raise ValueError("block_size must be a multiple of 512 (of 8192 above 8 KiB)")
    dev = resolve(device)
    arr = _as_array(data)
    if plan is None:
        plan = uniform_rows(arr.size, block_size)
    return encode_plan(arr, plan, bits, 64, "groups", [dev], layers)
