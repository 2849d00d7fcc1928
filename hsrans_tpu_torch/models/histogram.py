"""Byte-frequency model of the wires: observe, normalize to 2^B, and
rebuild cumul from wire freqs.

The port's copy of `hsrans_tpu/models/histogram.py` (and of
`models/tables.py::make_cumul_inv`), so that the port loads no module of the
JAX package.  The normalization is written into the wire and must stay
bit-identical to the reference's hist.cpp; `tests/test_torch_host_tier.py`
holds every function here equal to its original, including the native C++
path the original takes when it builds.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class Hist:
    """Normalized histogram: freq + exclusive prefix sums (cumul), with
    sum(freq) == 2^total_symbol_count_bits."""

    symbol_count: np.ndarray  # uint16[256]
    cumul: np.ndarray  # uint16[256]
    total_symbol_count_bits: int


def observe_hist(data: np.ndarray) -> np.ndarray:
    """Count byte frequencies -> uint32[256] (torch's CPU bincount takes
    uint8 as is; numpy's widens every byte first and is ~4x slower)."""
    arr = np.ascontiguousarray(data, dtype=np.uint8)
    return torch.bincount(torch.from_numpy(arr), minlength=256).numpy().astype(np.uint32)


def _heap_sort_indices(values: np.ndarray) -> np.ndarray:
    """Heap-sort 256 symbol indices ascending by value, with the reference's
    exact (unstable) tie order (hist.cpp:110-144): it decides which of
    several equal-frequency symbols is stolen from first.  Python lists,
    not numpy scalars: the sort is ~4x faster and the order the same."""
    idx = list(range(256))
    val = values.tolist()

    def sift_down(n: int, i: int) -> None:
        while True:
            left = 2 * i + 1
            right = 2 * i + 2
            largest = i
            if left < n and val[idx[left]] > val[idx[largest]]:
                largest = left
            if right < n and val[idx[right]] > val[idx[largest]]:
                largest = right
            if largest == i:
                return
            idx[i], idx[largest] = idx[largest], idx[i]
            i = largest

    for i in range(256 // 2 - 1, -1, -1):
        sift_down(256, i)
    for i in range(255, -1, -1):
        idx[0], idx[i] = idx[i], idx[0]
        sift_down(i, 0)
    return np.asarray(idx, dtype=np.int64)


def normalize_hist(hist: np.ndarray, data_bytes: int, total_symbol_count_bits: int) -> Hist:
    """Normalize raw counts so they sum exactly to 2^B (hist.cpp:16-215):
    float32 scale-and-round, then steal from / gift to symbols in heap-sort
    order until the sum is exact."""
    total = np.uint32(1) << np.uint32(total_symbol_count_bits)
    mul = np.float32(total) / np.float32(data_bytes)

    capped = (hist.astype(np.float32) * mul + np.float32(0.5)).astype(np.uint16)
    capped = np.where((capped == 0) & (hist != 0), np.uint16(1), capped)
    capped_sum = int(capped.sum(dtype=np.uint64))

    if capped_sum != int(total):
        sorted_idx = _heap_sort_indices(capped)

        def find_min_two(start: int) -> int:
            for i in range(start, 256):
                if capped[sorted_idx[i]] >= 2:
                    return i
            return start

        min_two = find_min_two(0)

        while capped_sum > int(total):  # steal
            done = False
            for i in range(min_two, 256):
                capped[sorted_idx[i]] -= 1
                capped_sum -= 1
                if capped_sum == int(total):
                    done = True
                    break
            if done:
                break
            min_two = find_min_two(min_two)

        while capped_sum < int(total):  # charity
            done = False
            for i in range(255, min_two - 1, -1):
                capped[sorted_idx[i]] += 1
                capped_sum += 1
                if capped_sum == int(total):
                    done = True
                    break
            if done:
                break
            min_two = find_min_two(min_two)

    cumul = np.zeros(256, dtype=np.uint16)
    cumul[1:] = np.cumsum(capped[:-1].astype(np.uint64)).astype(np.uint16)
    return Hist(symbol_count=capped, cumul=cumul, total_symbol_count_bits=total_symbol_count_bits)


def make_hist(data: np.ndarray | bytes, total_symbol_count_bits: int) -> Hist:
    """observe + normalize (hist.cpp:217-222)."""
    arr = np.frombuffer(data, dtype=np.uint8) if isinstance(data, (bytes, bytearray, memoryview)) else data
    return normalize_hist(observe_hist(arr), int(np.asarray(arr).size), total_symbol_count_bits)


def complete_hist(symbol_count: np.ndarray, total_symbol_count_bits: int) -> Hist | None:
    """Rebuild cumul from freqs read off the wire; None if the sum is wrong
    (hist.cpp:308-324)."""
    sc = np.asarray(symbol_count, dtype=np.uint16)
    if int(sc.sum(dtype=np.uint64)) != (1 << total_symbol_count_bits):
        return None
    cumul = np.zeros(256, dtype=np.uint16)
    cumul[1:] = np.cumsum(sc[:-1].astype(np.uint64)).astype(np.uint16)
    return Hist(symbol_count=sc, cumul=cumul, total_symbol_count_bits=total_symbol_count_bits)


def make_cumul_inv(hist: Hist) -> np.ndarray:
    """slot -> symbol table, uint8[2^B] (hist.cpp:240-246)."""
    return np.repeat(np.arange(256, dtype=np.uint8), hist.symbol_count.astype(np.int64))
