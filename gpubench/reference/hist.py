"""Byte histograms normalised to 2^B, many rows at once, in plain NumPy.

The normalisation is the hypersonic-rANS reference's (hist.cpp): each count
scaled in float32 and truncated, a present symbol kept at 1 or more, then,
where the sum is not 2^B, the symbols heap-sorted by that value (the
reference's own unstable heap sort, whose order decides ties) and 1 taken
from or given to each of them in passes until the sum is 2^B.  Every row's
heap sort runs side by side here, or one row at a time in plain Python where
there are few (a planner normalises one row at a time); the steal and gift
passes go a whole pass at a time.
"""

from __future__ import annotations

import numpy as np


def _sift_down(idx: np.ndarray, val: np.ndarray, rows: np.ndarray, n: int, cur: np.ndarray) -> None:
    """Sift the entries at `cur` (one position a row) down the first `n`
    places of each row's max-heap of indices `idx`, keyed by `val`."""
    cur = cur.copy()
    live = np.ones(len(rows), bool)
    while live.any():
        left, right = 2 * cur + 1, 2 * cur + 2
        largest = cur.copy()
        key = val[rows, idx[rows, largest]]
        lv = val[rows, idx[rows, np.minimum(left, 255)]]
        take = (left < n) & (lv > key)
        largest = np.where(take, left, largest)
        key = np.where(take, lv, key)
        rv = val[rows, idx[rows, np.minimum(right, 255)]]
        largest = np.where((right < n) & (rv > key), right, largest)
        live &= largest != cur
        sel = rows[live]
        a, b = cur[live], largest[live]
        idx[sel, a], idx[sel, b] = idx[sel, b], idx[sel, a].copy()
        cur = np.where(live, largest, cur)


def _heap_sort_row(values: list[int]) -> list[int]:
    """One row's heap sort, as `heap_sort_indices` does it, on Python
    lists."""
    idx = list(range(256))

    def sift(n: int, cur: int) -> None:
        while True:
            left, right, largest = 2 * cur + 1, 2 * cur + 2, cur
            if left < n and values[idx[left]] > values[idx[largest]]:
                largest = left
            if right < n and values[idx[right]] > values[idx[largest]]:
                largest = right
            if largest == cur:
                return
            idx[cur], idx[largest] = idx[largest], idx[cur]
            cur = largest

    for i in range(127, -1, -1):
        sift(256, i)
    for i in range(255, -1, -1):
        idx[0], idx[i] = idx[i], idx[0]
        sift(i, 0)
    return idx


def heap_sort_indices(values: np.ndarray) -> np.ndarray:
    """Each row's 256 symbol indices sorted ascending by value, in the
    order of the reference's in-place heap sort (hist.cpp:110-144)."""
    if values.shape[0] <= 4:
        return np.array([_heap_sort_row(v) for v in values.astype(np.int64).tolist()], np.int64).reshape(-1, 256)
    nrows = values.shape[0]
    rows = np.arange(nrows)
    idx = np.tile(np.arange(256, dtype=np.int64), (nrows, 1))
    val = values.astype(np.int64)
    for i in range(127, -1, -1):
        _sift_down(idx, val, rows, 256, np.full(nrows, i))
    for i in range(255, -1, -1):
        idx[:, 0], idx[:, i] = idx[:, i], idx[:, 0].copy()
        _sift_down(idx, val, rows, i, np.zeros(nrows, np.int64))
    return idx


def _first_two(v: np.ndarray, start: int) -> int:
    """The first sorted position from `start` whose value is 2 or more;
    `start` where there is none (the reference's find_min_two)."""
    hit = np.nonzero(v[start:] >= 2)[0]
    return start + int(hit[0]) if hit.size else start


def normalize_rows(counts: np.ndarray, sizes: np.ndarray, bits: int) -> np.ndarray:
    """Counts [rows, 256] of rows of `sizes` bytes -> freqs uint16 [rows,
    256] that sum to 2^bits, as the reference's normalize_hist gives them
    row by row (`sizes` is the divisor of the float scale)."""
    total = 1 << bits
    mul = (np.float32(total) / np.asarray(sizes, np.float32))[:, None]
    capped = (counts.astype(np.float32) * mul + np.float32(0.5)).astype(np.uint16)
    capped = np.where((capped == 0) & (counts != 0), np.uint16(1), capped)
    sums = capped.sum(axis=1, dtype=np.int64)
    off = np.nonzero(sums != total)[0]
    if off.size:
        order = heap_sort_indices(capped[off])
        for j, r in enumerate(off):
            v = capped[r, order[j]].astype(np.int64)
            excess = int(sums[r]) - total
            min_two = _first_two(v, 0)
            while excess > 0:  # steal 1 from each from min_two up
                m = 256 - min_two
                if excess <= m:
                    v[min_two : min_two + excess] -= 1
                    break
                v[min_two:] -= 1
                excess -= m
                min_two = _first_two(v, min_two)
            while excess < 0:  # give 1 to each from the top down to min_two
                m = 256 - min_two
                if -excess <= m:
                    v[256 + excess :] += 1
                    break
                v[min_two:] += 1
                excess += m
                min_two = _first_two(v, min_two)
            capped[r, order[j]] = (v & 0xFFFF).astype(np.uint16)
    return capped


def row_counts(data: np.ndarray, starts: np.ndarray, ends: np.ndarray) -> np.ndarray:
    """Byte counts int64 [rows, 256] of data[starts[i]:ends[i]]."""
    out = np.zeros((len(starts), 256), np.int64)
    for i, (a, b) in enumerate(zip(starts.tolist(), ends.tolist())):
        out[i] = np.bincount(data[a:b], minlength=256)
    return out


def segment_freqs(data: np.ndarray, starts: np.ndarray, ends: np.ndarray, bits: int) -> np.ndarray:
    """Freqs uint16 [rows, 256] of each segment [start, end) of `data`; an
    empty segment gets the 1-symbol histogram of byte 0, as the wires'
    encoders give a tile wholly past the input."""
    counts = row_counts(data, starts, ends)
    sizes = np.asarray(ends, np.int64) - np.asarray(starts, np.int64)
    empty = sizes <= 0
    counts[empty] = 0
    counts[empty, 0] = 1
    return normalize_rows(counts, np.where(empty, 1, sizes), bits)


def cumul_of(freqs: np.ndarray) -> np.ndarray:
    """Exclusive prefix sums of freqs [rows, 256], as int64."""
    f = freqs.astype(np.int64)
    return np.cumsum(f, axis=1) - f
