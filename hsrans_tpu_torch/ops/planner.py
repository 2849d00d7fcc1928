"""Greedy backward block-segmentation planner, mt mode: the blocks of the mt
wire and the cuts of the v3 adaptive tpx wire.

The port's copy of the pure-Python planner of `hsrans_tpu/ops/planner.py`
(`plan_blocks_py` with the mt parameters: n = 32 or 64 lanes, the mt
HistReplaceMul and MinBlockSize tables, the 2^25 block cap and the
header-amortization bias), so that the port loads no module of the JAX
package.  It mirrors native/hsrans_native.cpp:hsr_plan_blocks, which the
original uses when it builds; `tests/test_torch_host_tier.py` and
`tests/test_torch_mt_decode.py` hold the plans equal.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..models.histogram import normalize_hist, observe_hist

HIST_REPLACE_MUL_MT = {10: 500, 11: 500, 12: 500, 13: 500, 14: 500, 15: 50}
MIN_BLOCK_BITS_MT = 16
MAX_BLOCK_SIZE_MT = 1 << 25


@dataclass
class BlockPlan:
    start: int
    size: int
    is_single: bool
    symbol: int
    freq: np.ndarray | None  # uint16[256] (None for single-symbol blocks)


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


def plan_blocks_mt(data: np.ndarray, bits: int, n: int = 64) -> list[BlockPlan]:
    """Plan blocks in input order for n lanes; a coded block carries the
    normalized histogram of its span plus the following block (the
    reference's look-ahead quirk), which the mt wire writes."""
    length = data.size
    if length == 0:
        return []
    replace_mul = HIST_REPLACE_MUL_MT[bits]
    minb = 1 << MIN_BLOCK_BITS_MT
    bias = np.float32((512 + n * 4 + 16) * 0.5)
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
            while target > 0 and lookahead_end - target < MAX_BLOCK_SIZE_MT:
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
