"""The block layout of the mt wire, in plain NumPy: the benchmark's own
frozen copy of the hypersonic-rANS reference's greedy planner in its mt
mode, and of the device layout that caps its coded blocks, independent of
the code under test.

The greedy planner walks the input backward.  A block starts as the last
whole 2^16-byte window before its end; while the window before it costs
less than HistReplaceMul x 2^B / 4096 bits more under the block's
provisional histogram than under its own (float32 costs, accumulated in
symbol order, the block's header bias included), the block grows by that
window, up to 2^25 bytes.  A window of one symbol becomes a single-symbol
block, run back to that symbol's first byte and rounded up to a lane
group.  A coded block's freqs are the histogram of its span and the block
after it (the reference's look-ahead).

The device layout keeps the planner's cuts and single-symbol blocks and
splits each coded block longer than `max_block` into near-equal pieces of
whole 512 bytes; each pair of pieces shares the histogram of its joint
span.

A row is (start, size, symbol, freqs): `symbol` for a single-symbol block
(freqs None), `freqs` uint16 [256] for a coded one (symbol None).
"""

from __future__ import annotations

import numpy as np

from .hist import normalize_rows, segment_freqs

MIN_BLOCK = 1 << 16  # 2^16 at every B from 10 to 15
MAX_BLOCK = 1 << 25
REPLACE_MUL = {10: 500, 11: 500, 12: 500, 13: 500, 14: 500, 15: 50}

Row = tuple[int, int, "int | None", "np.ndarray | None"]


def _normalize(counts: np.ndarray, size: int, bits: int) -> np.ndarray:
    return normalize_rows(counts[None], np.array([size]), bits)[0]


def _counts(arr: np.ndarray) -> np.ndarray:
    return np.bincount(arr, minlength=256)


def _grows(arr: np.ndarray, off: int, freq: np.ndarray, bits: int, bias: np.float32) -> bool:
    """Whether the block takes the window at `off`: the window coded with the
    block's freqs costs less than the replace point more than with its own."""
    counts = _counts(arr[off : off + MIN_BLOCK])
    own = _normalize(counts, MIN_BLOCK, bits)
    total = np.float32(1 << bits)
    nz = counts != 0
    c = counts[nz].astype(np.float32)
    before = (c - np.float32(1.0)) * np.log2(freq[nz].astype(np.float32) / total)
    after = c * np.log2(own[nz].astype(np.float32) / total)
    # float32 sums in symbol order: 0 - x0 - x1 ..., bias - y0 - y1 ...
    cost_before = np.subtract.accumulate(np.concatenate([np.zeros(1, np.float32), before]))[-1]
    cost_after = np.subtract.accumulate(np.concatenate([np.full(1, bias, np.float32), after]))[-1]
    return bool(np.float32(cost_before - cost_after) < np.float32(((1 << bits) * REPLACE_MUL[bits]) >> 12))


def greedy(arr: np.ndarray, bits: int, n: int = 64) -> list[Row]:
    """The reference planner's mt blocks of `arr` for `n` lanes, in input
    order."""
    length = arr.size
    if length == 0:
        return []
    bias = np.float32((512 + n * 4 + 16) * 0.5)
    target = ((length - 1) & ~(n - 1)) & ~(MIN_BLOCK - 1)
    if target > MIN_BLOCK:
        target -= MIN_BLOCK
    block_end = lookahead_end = length
    counts = _counts(arr[target:block_end])
    first = True
    rows: list[Row] = []
    while True:
        present = np.nonzero(counts)[0]
        if present.size == 1:
            symbol = int(present[-1])
            other = np.nonzero(arr[:target][::-1] != symbol)[0]
            last_other = target - 1 - (int(other[0]) if other.size else target)
            target = (last_other + n) & ~(n - 1)
            rows.append((target, block_end - target, symbol, None))
        else:
            filled = np.where(counts == 0, 1, counts)
            divisor = block_end - target + int((counts == 0).sum()) if first else MIN_BLOCK
            provisional = _normalize(filled, divisor, bits)
            while target > 0 and lookahead_end - target < MAX_BLOCK:
                if not _grows(arr, target - MIN_BLOCK, provisional, bits, bias):
                    break
                target -= MIN_BLOCK
            freq = _normalize(_counts(arr[target:lookahead_end]), lookahead_end - target, bits)
            rows.append((target, block_end - target, None, freq))
        if target == 0:
            break
        prev_end, lookahead_end = target, block_end
        target = (target - 1) & ~(MIN_BLOCK - 1)
        if target > 0 and prev_end - target < MIN_BLOCK * 2 // 3:
            target -= MIN_BLOCK
        counts = _counts(arr[target:prev_end])
        block_end = prev_end
        first = False
    rows.reverse()
    return rows


def device_layout(arr: np.ndarray, bits: int, n: int = 64, max_block: int = 32 << 10) -> list[Row]:
    """The greedy plan with every coded block longer than `max_block` cut
    into pieces of whole 512 bytes, a piece pair sharing one histogram."""
    out: list[Row] = []
    pairs: list[tuple[int, int, list[int]]] = []  # (span start, span end, the rows of out it gives freqs)
    for start, size, symbol, freq in greedy(arr, bits, n):
        pieces = -(-size // max_block)
        base = size // pieces // 512 * 512 if symbol is None else 0
        if symbol is not None or size <= max_block or base == 0:
            out.append((start, size, symbol, freq))
            continue
        starts = [start + i * base for i in range(pieces)]
        ends = starts[1:] + [start + size]
        for p in range(0, pieces, 2):
            q = min(p + 1, pieces - 1)
            pairs.append((starts[p], ends[q], list(range(len(out), len(out) + q - p + 1))))
            out.extend((s, e - s, None, None) for s, e in zip(starts[p : q + 1], ends[p : q + 1]))
    if pairs:
        freqs = segment_freqs(arr, np.array([p[0] for p in pairs]), np.array([p[1] for p in pairs]), bits)
        for (_, _, at), f in zip(pairs, freqs):
            for i in at:
                out[i] = (*out[i][:3], f)
    return out
