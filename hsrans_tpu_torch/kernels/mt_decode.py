"""mt decode: the port of `hsrans_tpu/kernels/mt64_decode.py::mt64_decode_tpu`
to PyTorch and CUDA (`csrc/mt_decode.cu`).

It decodes the C++ reference's own mt wire (n = 32 or 64 lanes, B <= 15).
One native walk of the header chain over the blob where it lies
(`..runtime.native.mt_index`) writes one small index row, the states and
one freq | cumul << 16 table row per coded block; the blob's u16 word
region goes to the card as it is.  `index_blocks` and `block_operands`,
the same rows from `..ops.mt.block_index` in Python, are the tests' oracle
for that walk.  One launch decodes every coded symbol of the blob, each
block's groups written straight to their output bytes.  The host then fills the single-symbol
blocks and decodes the trailing partial lane group (fewer than n bytes) from
the last block's final states.  Unlike the JAX package, no coded block goes
to a host decoder, so the work splits differently; the output bytes are the
same.

With the module flag `_PAIR_V2` set (the JAX package's name and default,
off), the decode takes the annotated-stream route, the port of the JAX
package's `_decode_pairs_v2` (Pallas `_annotate_pairs` and
`_mt64_pair_kernel_v2`): one launch stamps every word of every coded block
with rank(word & mask) in bits 16..23 (`annotate`), and a second decodes
from that annotation (`decode_blocks_annotated`), taking a consumed lane's
next rank from the word it reads.  That is exact at B <= 15: after a renorm
the state is (state << 16) | word, so its slot is word & mask.  A read past
a block's words gives word 0 and rank 0, which is rank_of(0): slot 0
belongs to the first present symbol.  The route covers every blob the rank
route does (n = 32 or 64, B <= 15) and gives its bytes.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.histogram import complete_hist
from ..ops.mt import MtBlock, _as_array, block_index
from ..ops.reference import decode_tail_group
from ..rans import DECODE_CONSUME_POINT_16, IDX2IDX
from ..runtime import build, native
from ..runtime.device import Output, entry_span, layer_clock, resolve_all, shares, span, to_card
from .tpx_decode import from_u32, to_u32

_M32 = 0xFFFFFFFF
_PAIR_V2 = False  # the annotated-stream route; read at each call of mt_decode_torch
# columns of the int64 per-block index; csrc/mt_decode.cu::BlockIndex
INDEX_FIELDS = ("word_start", "word_end", "out_start", "out_limit", "num_groups")


def block_word_counts(blocks: list, kernel_blocks: list, stream: np.ndarray, n: int = 64) -> list[int] | None:
    """Exact per-block word counts: a block's words end where the next
    block's header begins (single-symbol header = 4 words; coded header
    = 8 + 2n + 256 words before its word_start); None if one is negative.

    Copy of `hsrans_tpu.kernels.mt64_decode.block_word_counts`, whose module
    imports jax; tests hold the two equal."""
    pos_of = {id(b): j for j, b in enumerate(blocks)}
    w_counts = []
    for b in kernel_blocks:
        j = pos_of[id(b)] + 1
        if j < len(blocks):
            nxt = blocks[j]
            end = nxt.word_start - (4 if nxt.is_single else 8 + 2 * n + 256)
        else:
            end = stream.size
        w_counts.append(end - b.word_start)
    if w_counts and min(w_counts) < 0:
        return None
    return w_counts


def decode_blocks_plain(stream, index, states, fctab, *, bits: int, n: int, length: int):
    """Plain PyTorch version of the decode kernel, on any device.

    stream uint8 [2 * nwords] (the blob's u16 word region), index int64
    [nb, 5] (INDEX_FIELDS), states int32 [nb, n] (u32 bits), fctab int32
    [nb, 256] (freq | cumul << 16, sums 2^B) -> (out uint8 [length], final
    states int32 [nb, n], words consumed int64 [nb]).  Block b decodes
    num_groups groups; lane j's symbol of group g goes to byte out_start +
    g*n + IDX2IDX[n][j] if that is below out_limit and length; words are
    read at word_start + the block's cursor, as 0 outside [0, word_end) or
    past the stream.  Vectorized over blocks, looping to the largest
    num_groups."""
    dev = stream.device
    nb = index.shape[0]
    out = torch.zeros(length, dtype=torch.uint8, device=dev)
    st = to_u32(states)
    rw = torch.zeros(nb, dtype=torch.int64, device=dev)
    if nb == 0:
        return out, states.clone(), rw
    words = stream.view(torch.int16).to(torch.int64) & 0xFFFF if stream.numel() >= 2 else torch.zeros(1, dtype=torch.int64, device=dev)
    word_start, word_end, out_start, out_limit, num_groups = (c[:, None] for c in index.unbind(1))
    word_end = torch.clamp(word_end, max=stream.numel() // 2)
    out_limit = torch.clamp(out_limit, max=length)
    fc = to_u32(fctab)
    freq_of, cum_of = fc & 0xFFFF, fc >> 16
    perm = to_card(IDX2IDX[n], dev)[None, :]
    mask = (1 << bits) - 1
    for g in range(int(index[:, 4].max())):
        active = g < num_groups
        slot = st & mask
        # slot -> symbol: the last symbol whose cumul is <= slot (the zero-freq
        # symbols before it share its cumul), as make_cumul_inv lays it out
        sym = torch.searchsorted(cum_of, slot, right=True) - 1
        new = ((st >> bits) * torch.gather(freq_of, 1, sym) + slot - torch.gather(cum_of, 1, sym)) & _M32
        st = torch.where(active, new, st)
        pos = out_start + g * n + perm
        put = active & (pos >= 0) & (pos < out_limit)
        out[pos[put]] = sym[put].to(torch.uint8)
        consume = active & (st < DECODE_CONSUME_POINT_16)
        c = consume.to(torch.int64)
        at = word_start + rw[:, None] + torch.cumsum(c, dim=1) - c  # lane-ascending consume order
        word = torch.where((at >= 0) & (at < word_end), words[torch.clamp(at, 0, words.numel() - 1)], 0)
        st = torch.where(consume, ((st << 16) | word) & _M32, st)
        rw = rw + c.sum(dim=1)
    return out, from_u32(st), rw


def decode_blocks_cuda(stream, index, states, fctab, *, bits: int, n: int, length: int):
    """The CUDA kernel (`csrc/mt_decode.cu`) on CUDA tensors; same contract
    as decode_blocks_plain.  Raises for any other tensor."""
    dev = build.check_cuda("decode_blocks_cuda", stream, index, states, fctab, uint8=(0,), int64=(1,))
    nb = index.shape[0]
    if n not in (32, 64) or not 0 <= bits <= 15:
        raise ValueError("decode_blocks_cuda: n must be 32 or 64 and bits at most 15")
    if index.shape != (nb, len(INDEX_FIELDS)) or states.shape != (nb, n) or fctab.shape != (nb, 256):
        raise ValueError("decode_blocks_cuda: operand shapes do not match the block count")
    if stream.data_ptr() % 2:
        raise ValueError("decode_blocks_cuda: the word region must start at an even address (u16 words)")
    out = torch.zeros(length, dtype=torch.uint8, device=dev)
    fin = torch.empty((nb, n), dtype=torch.int32, device=dev)
    cursor = torch.empty(nb, dtype=torch.int64, device=dev)
    if nb:
        launch_decode(stream, index, states, fctab, out, fin, cursor, bits=bits, n=n)
    return out, fin, cursor


def launch_decode(stream, index, states, fctab, out, fin, cursor, *, bits: int, n: int) -> None:
    """One launch of the decode kernel into the outputs given (out uint8
    [length], fin int32 [nb, n], cursor int64 [nb] on the operands'
    device); decode_blocks_cuda's checks are the caller's.  The kernel
    writes only the bytes its blocks cover."""
    build.launch(
        "mt_decode", "hsr_mt_decode", stream.device,
        stream.data_ptr(), index.data_ptr(), states.data_ptr(), fctab.data_ptr(),
        out.data_ptr(), fin.data_ptr(), cursor.data_ptr(), index.shape[0], n, bits, stream.numel() // 2, out.numel(),
    )


def decode_blocks(stream, index, states, fctab, *, bits: int, n: int, length: int):
    """The kernel for CUDA operands, its plain version for CPU operands."""
    fn = decode_blocks_plain if stream.device.type == "cpu" else decode_blocks_cuda
    return fn(stream, index, states, fctab, bits=bits, n=n, length=length)


def _rank_lookup(fctab):
    """(fc, rank of each symbol) of int32 [nb, 256] freq | cumul << 16 rows:
    fc as int64 u32, the rank the number of present (freq > 0) symbols
    before the symbol."""
    fc = to_u32(fctab)
    return fc, torch.cumsum((fc & 0xFFFF) != 0, dim=1) - 1


def annotate_plain(stream, index, fctab, *, bits: int):
    """Plain PyTorch version of the annotate kernel, on any device.

    stream uint8 [2 * nwords] (the blob's u16 word region), index int64
    [nb, 5] (INDEX_FIELDS), fctab int32 [nb, 256] -> ann int32 [nwords]
    (u32 bits): word | rank(word & mask) << 16 for every word of block b's
    [word_start, min(word_end, nwords)), with block b's table; rank is the
    index of the present symbol that owns the slot (`make_rank_tables`).
    Every other word is 0.  The blocks' word ranges are disjoint, as
    `block_operands` makes them."""
    dev = stream.device
    nwords = stream.numel() // 2
    ann = torch.zeros(nwords, dtype=torch.int32, device=dev)
    nb = index.shape[0]
    if nb == 0 or nwords == 0:
        return ann
    lo = torch.clamp(index[:, 0], 0, nwords)
    hi = torch.maximum(lo, torch.clamp(index[:, 1], max=nwords))
    count = hi - lo
    blk = torch.repeat_interleave(torch.arange(nb, device=dev), count)
    pos = lo[blk] + torch.arange(blk.numel(), device=dev) - (torch.cumsum(count, 0) - count)[blk]
    words = stream.view(torch.int16).to(torch.int64)[pos] & 0xFFFF
    fc, rank_of_sym = _rank_lookup(fctab)
    # slot -> symbol by one search over every block's cumuls at once: block b's
    # keys b << 16 | cumul ascend, and lie below block b + 1's
    keys = ((torch.arange(nb, device=dev)[:, None] << 16) | (fc >> 16)).reshape(-1)
    sym = torch.searchsorted(keys, (blk << 16) | (words & ((1 << bits) - 1)), right=True) - 1
    ann[pos] = (words | (rank_of_sym.reshape(-1)[sym] << 16)).to(torch.int32)
    return ann


def annotate_cuda(stream, index, fctab, *, bits: int):
    """The annotate kernel (`csrc/mt_decode.cu`) on CUDA tensors; same
    contract as annotate_plain.  Raises for any other tensor."""
    dev = build.check_cuda("annotate_cuda", stream, index, fctab, uint8=(0,), int64=(1,))
    nb = index.shape[0]
    if not 0 <= bits <= 15:
        raise ValueError("annotate_cuda: bits must be at most 15")
    if index.shape != (nb, len(INDEX_FIELDS)) or fctab.shape != (nb, 256):
        raise ValueError("annotate_cuda: operand shapes do not match the block count")
    nwords = stream.numel() // 2
    if nb == 0:
        return torch.zeros(nwords, dtype=torch.int32, device=dev)
    ann = torch.empty(nwords, dtype=torch.int32, device=dev)  # the kernel writes every word
    build.launch("mt_annotate", "hsr_mt_annotate", dev, stream.data_ptr(), index.data_ptr(), fctab.data_ptr(),
                 ann.data_ptr(), nb, bits, nwords)
    return ann


def annotate(stream, index, fctab, *, bits: int):
    """The kernel for CUDA operands, its plain version for CPU operands."""
    fn = annotate_plain if stream.device.type == "cpu" else annotate_cuda
    return fn(stream, index, fctab, bits=bits)


def decode_blocks_annotated_plain(ann, index, states, fctab, *, bits: int, n: int, length: int):
    """Plain PyTorch version of the annotated decode kernel, on any device.

    decode_blocks_plain's contract, with the annotation int32 [nwords]
    (`annotate`) in place of the word region.  Each lane carries the rank
    of its state's slot: a lane that consumes takes word and rank from the
    annotation (0 and 0 outside [0, word_end)), any other lane looks its
    rank up from its new state."""
    dev = ann.device
    nb = index.shape[0]
    out = torch.zeros(length, dtype=torch.uint8, device=dev)
    st = to_u32(states)
    rw = torch.zeros(nb, dtype=torch.int64, device=dev)
    if nb == 0:
        return out, states.clone(), rw
    vals = ann.to(torch.int64) & _M32 if ann.numel() else torch.zeros(1, dtype=torch.int64, device=dev)
    word_start, word_end, out_start, out_limit, num_groups = (c[:, None] for c in index.unbind(1))
    word_end = torch.clamp(word_end, max=ann.numel())
    out_limit = torch.clamp(out_limit, max=length)
    fc, rank_of_sym = _rank_lookup(fctab)
    cum_of = fc >> 16
    # fc and symbol by rank: the present symbols first, in symbol order
    sym_of_rank = torch.sort(((fc & 0xFFFF) == 0).to(torch.int32), dim=1, stable=True).indices
    fc_of_rank = torch.gather(fc, 1, sym_of_rank)
    mask = (1 << bits) - 1

    def rank_of(slot):
        return torch.gather(rank_of_sym, 1, torch.searchsorted(cum_of, slot, right=True) - 1)

    perm = to_card(IDX2IDX[n], dev)[None, :]
    rank = rank_of(st & mask)
    for g in range(int(index[:, 4].max())):
        active = g < num_groups
        sym = torch.gather(sym_of_rank, 1, rank)
        f = torch.gather(fc_of_rank, 1, rank)
        new = ((st >> bits) * (f & 0xFFFF) + (st & mask) - (f >> 16)) & _M32
        st = torch.where(active, new, st)
        pos = out_start + g * n + perm
        put = active & (pos >= 0) & (pos < out_limit)
        out[pos[put]] = sym[put].to(torch.uint8)
        consume = active & (st < DECODE_CONSUME_POINT_16)
        c = consume.to(torch.int64)
        at = word_start + rw[:, None] + torch.cumsum(c, dim=1) - c  # lane-ascending consume order
        v = torch.where((at >= 0) & (at < word_end), vals[torch.clamp(at, 0, vals.numel() - 1)], 0)
        rank = torch.where(consume, (v >> 16) & 0xFF, rank_of(st & mask))
        st = torch.where(consume, ((st << 16) | (v & 0xFFFF)) & _M32, st)
        rw = rw + c.sum(dim=1)
    return out, from_u32(st), rw


def decode_blocks_annotated_cuda(ann, index, states, fctab, *, bits: int, n: int, length: int):
    """The annotated decode kernel (`csrc/mt_decode.cu`) on CUDA tensors;
    same contract as decode_blocks_annotated_plain.  Raises for any other
    tensor."""
    dev = build.check_cuda("decode_blocks_annotated_cuda", ann, index, states, fctab, int64=(1,))
    nb = index.shape[0]
    if n not in (32, 64) or not 0 <= bits <= 15:
        raise ValueError("decode_blocks_annotated_cuda: n must be 32 or 64 and bits at most 15")
    if index.shape != (nb, len(INDEX_FIELDS)) or states.shape != (nb, n) or fctab.shape != (nb, 256):
        raise ValueError("decode_blocks_annotated_cuda: operand shapes do not match the block count")
    if ann.data_ptr() % 4:
        raise ValueError("decode_blocks_annotated_cuda: the annotation must start at a 4-byte aligned address")
    out = torch.zeros(length, dtype=torch.uint8, device=dev)
    fin = torch.empty((nb, n), dtype=torch.int32, device=dev)
    cursor = torch.empty(nb, dtype=torch.int64, device=dev)
    if nb:
        launch_decode_annotated(ann, index, states, fctab, out, fin, cursor, bits=bits, n=n)
    return out, fin, cursor


def launch_decode_annotated(ann, index, states, fctab, out, fin, cursor, *, bits: int, n: int) -> None:
    """One launch of the annotated decode kernel into the outputs given, as
    launch_decode; decode_blocks_annotated_cuda's checks are the caller's."""
    build.launch(
        "mt_decode_annotated", "hsr_mt_decode_annotated", ann.device,
        ann.data_ptr(), index.data_ptr(), states.data_ptr(), fctab.data_ptr(),
        out.data_ptr(), fin.data_ptr(), cursor.data_ptr(), index.shape[0], n, bits, ann.numel(), out.numel(),
    )


def decode_blocks_annotated(ann, index, states, fctab, *, bits: int, n: int, length: int):
    """The kernel for CUDA operands, its plain version for CPU operands."""
    fn = decode_blocks_annotated_plain if ann.device.type == "cpu" else decode_blocks_annotated_cuda
    return fn(ann, index, states, fctab, bits=bits, n=n, length=length)


def index_blocks(blob: bytes | np.ndarray, n: int) -> tuple[int, np.ndarray, list[MtBlock], list[int]] | None:
    """block_index, then the word count of every coded block: the JAX
    decoder's `block_word_counts` for all of them but the last, whose words
    run to the stream's end as the JAX decoder reads them.  Returns (length,
    u16 stream, blocks, word counts of the coded blocks); None where either
    step fails.  With `block_operands`, the tests' oracle for
    `runtime/native.py::mt_index`, which `mt_decode_torch` calls."""
    idx = block_index(_as_array(blob), n)
    if idx is None:
        return None
    length, stream, blocks = idx
    coded = [b for b in blocks if not b.is_single]
    w_counts = block_word_counts(blocks, coded[:-1], stream, n)
    if w_counts is None:
        return None
    if coded:
        w_counts.append(stream.size - coded[-1].word_start)
    return length, stream, blocks, w_counts


def block_operands(
    length: int, stream: np.ndarray, blocks: list[MtBlock], w_counts: list[int], bits: int, n: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray] | None:
    """Kernel operands of the coded blocks: (index int64 [nb, 5], states
    uint32 [nb, n], fc uint32 [nb, 256]); None if a block's freqs do not sum
    to 2^B.  Vectorized over blocks.  With `index_blocks`, the tests' oracle
    for `runtime/native.py::mt_index`."""
    coded = [b for b in blocks if not b.is_single]
    nb = len(coded)
    freqs = np.zeros((nb, 256), np.uint32)
    for i, b in enumerate(coded):
        freqs[i, : b.freq.size] = b.freq  # shorter only where the blob ran out
    if nb and (freqs.sum(axis=1) != 1 << bits).any():
        return None
    cumul = np.cumsum(freqs, axis=1, dtype=np.uint32) - freqs
    fc = freqs | (cumul << np.uint32(16))
    states = np.stack([b.states for b in coded]) if nb else np.zeros((0, n), np.uint32)

    word_start = np.fromiter((b.word_start for b in coded), np.int64, nb)
    out_start = np.fromiter((b.out_start for b in coded), np.int64, nb)
    size = np.fromiter((b.size for b in coded), np.int64, nb)
    # bytes a block decodes: up to its end or, for the last block, up to the
    # blob's length (its overflow past a short last block is what the
    # reference decoder writes there); later blocks overwrite the rest
    out_limit = np.minimum(out_start + size, length)
    if nb and coded[-1] is blocks[-1]:
        out_limit[-1] = length
    out_len_states = max(length - n + 1, 0)
    num_groups = np.maximum(0, -(-(np.minimum(out_start + size, out_len_states) - out_start) // n))
    word_end = np.minimum(word_start + np.asarray(w_counts, np.int64), stream.size - 2 * n - 4)
    index = np.stack([word_start, word_end, out_start, out_limit, num_groups], axis=1)
    return index, states.astype(np.uint32), fc


def device_operands(stream: np.ndarray, index, states, fc, n: int, dev: torch.device) -> tuple[torch.Tensor, ...]:
    """The kernel's operands on `dev`: the blob's word region (the block
    index's stream less its 2n + 4 padding words) as bytes, as it is."""
    nwords = stream.size - 2 * n - 4
    return tuple(to_card(a, dev) for a in (stream[:nwords].view(np.uint8), index, states, fc))


def _decode_share(words: np.ndarray, index, states, fc, *, bits: int, n: int, length: int, dev: torch.device,
                  layers: dict[str, float] | None):
    """One device's coded blocks (rows of the blob's index, their outputs
    counted from the first block's) decoded on `dev` by the route
    `_PAIR_V2` picks, `words` the blob's word region as bytes: (out uint8
    [length], final states, words consumed), tensors on `dev`."""
    with layer_clock(layers, "h2d", dev):
        args = tuple(to_card(a, dev) for a in (words, index, states, fc))
    if _PAIR_V2:
        stream_t, index_t, states_t, fc_t = args
        with layer_clock(layers, "kernel_annotate", dev):
            ann = annotate(stream_t, index_t, fc_t, bits=bits)
        with layer_clock(layers, "kernel", dev):
            return decode_blocks_annotated(ann, index_t, states_t, fc_t, bits=bits, n=n, length=length)
    with layer_clock(layers, "kernel", dev):
        return decode_blocks(*args, bits=bits, n=n, length=length)


@entry_span
def mt_decode_torch(
    blob: bytes | np.ndarray,
    bits: int,
    n: int = 64,
    device: str | torch.device = "cuda",
    layers: dict[str, float] | None = None,
    devices: list | None = None,
) -> bytes | None:
    """Decode an mt_rANS32xN 16w blob (n in {32, 64}, B <= 15) on `device`;
    None where `hsrans_tpu.kernels.mt64_decode.mt64_decode_tpu` gives None
    (bits > 15 or another n, a broken header chain, a negative word count, a
    coded block whose freqs do not sum to 2^B).

    With `devices`, the coded blocks are split over them (`shares`: each a
    contiguous run of ceil(blocks / len(devices))), one launch on each, and
    each share's byte range copied back to its place in the output; the
    bytes do not depend on the split.
    With `layers`, adds the seconds of each layer of this call to it
    (host_index, h2d, kernel, d2h, host_assemble, and kernel_annotate on
    the annotated route), the device synchronized at each boundary."""
    devs = resolve_all(device, devices)
    dev = devs[-1]
    if bits > 15 or n not in (32, 64):
        return None
    with layer_clock(layers, "host_index", dev):
        indexed = native.mt_index(blob, bits, n)
    if indexed is None:
        return None
    length, words, index, states, fc, single, last_single = indexed
    if length == 0:
        return b""
    with layer_clock(layers, "host_assemble", dev):
        out = Output(length)
    with out:
        for dev, lo, hi in shares(devs, len(index)):
            # the share's blocks write the bytes [first, end) of the output (block
            # outputs ascend and do not overlap): it decodes into a buffer of
            # that range on its device, copied back to its place
            with span("host_shares"):
                sub = index[lo:hi].copy()
                first = int(sub[0, 2]) if hi > lo else 0
                end = max(first, min(int(sub[:, 3].max()), length)) if hi > lo else 0
                sub[:, 2:4] -= first
            out_t, fin_t, cursor_t = _decode_share(words, sub, states[lo:hi], fc[lo:hi], bits=bits, n=n,
                                                   length=end - first, dev=dev, layers=layers)
            with layer_clock(layers, "d2h", dev):
                out.put(first, out_t)
        # the trailing partial group (fewer than n bytes) continues the chain of
        # the last block, where that block is coded; fin_t and cursor_t are the
        # last share's
        tail_from = int(index[-1, 2] + index[-1, 4] * n) if not last_single else length
        with layer_clock(layers, "d2h", dev):
            if tail_from < length:
                fin = fin_t[-1].cpu().numpy().view(np.uint32)
                read_pos = int(index[-1, 0]) + int(cursor_t[-1])
        with layer_clock(layers, "host_assemble", dev):
            for start, size, symbol in single.tolist():
                out.part(start, start + size)[:] = symbol
            if tail_from < length:
                tail_words = np.zeros(n, np.uint16)  # read as 0 past the block's words
                got = words.view("<u2")[read_pos : min(read_pos + n, int(index[-1, 1]))]
                tail_words[: got.size] = got
                hist = complete_hist((fc[-1] & 0xFFFF).astype(np.uint16), bits)
                tail, _, _ = decode_tail_group(fin, tail_words, 0, hist, n, tail_from, length)
                perm = IDX2IDX[n]
                sel = (tail_from + perm) < length
                out.part(tail_from, tail_from + n)[perm[sel]] = tail[np.arange(n)[sel]]
            out.close()
    return out.result
