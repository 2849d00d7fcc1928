"""Greedy backward block-segmentation planner, in its two modes: "block"
(the blocks of the block wire, whose states flow across blocks) and "mt"
(the self-contained blocks of the mt wire, and the cuts of the v3 adaptive
tpx wire).

The port's copy of `hsrans_tpu/ops/planner.py`, so that the port loads no
module of the JAX package: `plan_blocks_py`, the pure-Python planner (the
per-B HistReplaceMul and MinBlockSize tables of each mode; mt adds the
2^25 block cap and the header-amortization bias), and `plan_blocks`, the
same plan from native/hsrans_native.cpp:hsr_plan_blocks on the port's
native loader.  `tests/test_torch_host_tier.py`,
`tests/test_torch_mt_decode.py` and `tests/test_torch_host_codecs.py` hold
the plans equal to the original's.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..models.histogram import normalize_hist, observe_hist
from ..runtime import native

HIST_REPLACE_MUL_BLOCK64 = {10: 4000, 11: 7730, 12: 5600, 13: 2500, 14: 1500, 15: 850}
HIST_REPLACE_MUL_BLOCK32 = {10: 4000, 11: 7730, 12: 5600, 13: 3120, 14: 2087, 15: 822}
HIST_REPLACE_MUL_MT = {10: 500, 11: 500, 12: 500, 13: 500, 14: 500, 15: 50}
MIN_BLOCK_BITS_BLOCK64 = {10: 20, 11: 19, 12: 16, 13: 17, 14: 17, 15: 16}
MIN_BLOCK_BITS_BLOCK32 = {10: 20, 11: 19, 12: 15, 13: 17, 14: 17, 15: 18}
MIN_BLOCK_BITS_MT = {10: 16, 11: 16, 12: 16, 13: 16, 14: 16, 15: 16}
MAX_BLOCK_SIZE_MT = 1 << 25


@dataclass
class BlockPlan:
    start: int
    size: int
    is_single: bool
    symbol: int
    freq: np.ndarray | None  # uint16[256] (None for single-symbol blocks)


def _params(bits: int, mode: str, n: int) -> tuple[int, int, bool, float]:
    """(HistReplaceMul, MinBlockSize, whether blocks are capped, cost bias)."""
    if mode == "mt":
        return HIST_REPLACE_MUL_MT[bits], 1 << MIN_BLOCK_BITS_MT[bits], True, np.float32((512 + n * 4 + 16) * 0.5)
    table_mul = HIST_REPLACE_MUL_BLOCK32 if n == 32 else HIST_REPLACE_MUL_BLOCK64
    table_bits = MIN_BLOCK_BITS_BLOCK32 if n == 32 else MIN_BLOCK_BITS_BLOCK64
    return table_mul[bits], 1 << table_bits[bits], False, np.float32(0.0)


def _can_extend(data, off, minb, old_freq, bits, replace_mul, bias) -> bool:
    counts = observe_hist(data[off : off + minb])
    new = normalize_hist(counts, minb, bits)
    total = np.float32(1 << bits)
    replace_point = ((1 << bits) * replace_mul) >> 12

    nz = counts != 0
    lb = np.log2(old_freq[nz].astype(np.float32) / total)
    la = np.log2(new.symbol_count[nz].astype(np.float32) / total)
    cb = (counts[nz].astype(np.float32) - np.float32(1.0)) * lb
    ca = counts[nz].astype(np.float32) * la
    # sequential float32 accumulation in symbol order, as the reference
    cost_before = np.float32(0.0)
    cost_after = np.float32(bias)
    for x in cb:
        cost_before = np.float32(cost_before - x)
    for x in ca:
        cost_after = np.float32(cost_after - x)
    return bool(np.float32(cost_before - cost_after) < np.float32(replace_point))


def plan_blocks_py(data: np.ndarray, bits: int, mode: str, n: int) -> list[BlockPlan]:
    """Plan blocks in input order for n lanes in `mode` ("block" or "mt");
    a coded block carries the normalized histogram of its span plus the
    following block (the reference's look-ahead quirk), which the wires
    write."""
    length = data.size
    if length == 0:
        return []
    replace_mul, minb, has_max, bias = _params(bits, mode, n)
    sc_mask = n - 1

    target = ((length - 1) & ~sc_mask) & ~(minb - 1)
    if target > minb:
        target -= minb
    block_end = length
    lookahead_end = length
    sym_count = observe_hist(data[target:block_end])
    first = True
    rows: list[BlockPlan] = []

    while True:
        nz = np.nonzero(sym_count)[0]
        num_symbols = nz.size
        selected = int(nz[-1]) if num_symbols else 0

        if num_symbols == 1:
            run = data[:target][::-1]
            not_sym = np.nonzero(run != selected)[0]
            idx = target - 1 - (int(not_sym[0]) if not_sym.size else target)
            target = (idx + 1 + n - 1) & ~sc_mask
            freq = None
        else:
            injected = sym_count.copy()
            extra = int((injected == 0).sum())
            injected[injected == 0] = 1
            divisor = (block_end - target + extra) if first else minb
            prov = normalize_hist(injected, divisor, bits)
            while target > 0 and (not has_max or lookahead_end - target < MAX_BLOCK_SIZE_MT):
                if not _can_extend(data, target - minb, minb, prov.symbol_count, bits, replace_mul, bias):
                    break
                target -= minb
            final_counts = observe_hist(data[target:lookahead_end])
            freq = normalize_hist(final_counts, lookahead_end - target, bits).symbol_count

        rows.append(BlockPlan(target, block_end - target, num_symbols == 1, selected, freq))
        if target == 0:
            break

        prev_end = target
        lookahead_end = block_end
        target = (target - 1) & ~(minb - 1)
        if target > 0 and prev_end - target < minb * 2 // 3:
            target -= minb
        sym_count = observe_hist(data[target:prev_end])
        block_end = prev_end
        first = False

    rows.reverse()
    return rows


def plan_blocks(data: np.ndarray, bits: int, mode: str, n: int) -> list[BlockPlan]:
    """`plan_blocks_py`'s plan from the native planner (equal rows); the
    Python planner where the native one plans nothing (empty input, B
    outside 10..15)."""
    rows = native.plan_blocks(data, bits, mode, n)
    if rows is None:
        return plan_blocks_py(data, bits, mode, n)
    return [BlockPlan(r["start"], r["size"], r["is_single"], r["symbol"], None if r["is_single"] else r["freq"])
            for r in rows]
