"""The scan decode's placed instance (`kernels/scan.py::decode_placed_*`,
`csrc/scan.cu::hsr_scan_decode_placed`) on the CPU tier: each symbol
written to the output byte it codes equals the lane-order decode followed
by the host's un-permutation and the copy of each row, and no other byte
is written; and route (c) of `mt_decode_device`, which stores through it,
against the numpy decoder and the JAX package's chain."""

from functools import cache

import numpy as np
import pytest
import torch

import chip_smoke
import hsrans_tpu.parallel.sharded as jsh
from hsrans_tpu.ops.mt import mt_encode_py
from hsrans_tpu_torch.kernels import scan
from hsrans_tpu_torch.ops.mt import mt_decode_py
from hsrans_tpu_torch.ops.planner import BlockPlan
from hsrans_tpu_torch.ops.tpx import make_tile_hist
from hsrans_tpu_torch.parallel import sharded as psh
from hsrans_tpu_torch.rans import INV_IDX2IDX
from tools.gen_inputs import text_like

POISON = 0xA5
CPU = torch.device("cpu")
LAYOUTS = chip_smoke.SCAN_PLACED_LAYOUTS


def operands(layout: str, n: int, bits: int):
    return chip_smoke.scan_placed_operands(layout, n, bits, CPU)


def lane_order_then_rows(ops, starts, length: int, steps: int, n: int, bits: int, tail: bool):
    """The placed decode's bytes as the host made them before: the lane-order
    decode, its lanes un-permuted, each block's row copied to its start."""
    syms, fin, pos = scan.decode_section_plain(*ops, bits=bits, num_steps=steps, tail=tail)
    rows = syms.numpy()[:, :, INV_IDX2IDX[n]].reshape(len(starts), -1)
    out = np.full(length, POISON, np.uint8)
    counts = ops[6].tolist() if tail else [steps * n] * len(starts)
    for row, start, count in zip(rows, starts.tolist(), counts):
        out[start : start + count] = row[:count]
    return out, fin, pos


@pytest.mark.parametrize("bits", (10, 12, 15))
@pytest.mark.parametrize("n", (16, 32, 64))
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_placed_plain_equals_lane_order_then_rows(layout, n, bits):
    """Into an output of 0xA5: every block's bytes where the host's copy of
    its un-permuted row put them, each final state and read position as the
    lane-order decode gives them, and every other byte still 0xA5."""
    ops, starts, length, steps = operands(layout, n, bits)
    want, fin_w, pos_w = lane_order_then_rows(ops, starts, length, steps, n, bits, tail=True)
    out = torch.full((length,), POISON, dtype=torch.uint8)
    fin, pos = scan.decode_placed_plain(*ops, starts, out, bits=bits, num_steps=steps, tail=True)
    assert np.array_equal(out.numpy(), want)
    assert torch.equal(fin, fin_w) and torch.equal(pos, pos_w)


@pytest.mark.parametrize("n", (16, 32, 64))
def test_placed_plain_without_tail_writes_every_lane(n):
    """Without `tail` every lane of every group takes its symbol: each
    stream writes its num_steps * N bytes, as the lane-order rows give."""
    ops, _, _, steps = operands("mixed", n, 12)
    starts = torch.arange(len(LAYOUTS["mixed"][0]), dtype=torch.int64) * (steps * n + 5) + 3
    length = int(starts[-1]) + steps * n + 2
    want, fin_w, pos_w = lane_order_then_rows(ops, starts, length, steps, n, 12, tail=False)
    out = torch.full((length,), POISON, dtype=torch.uint8)
    fin, pos = scan.decode_placed_plain(*ops, starts, out, bits=12, num_steps=steps, tail=False)
    assert np.array_equal(out.numpy(), want) and torch.equal(fin, fin_w) and torch.equal(pos, pos_w)


def test_placed_plain_refuses_a_byte_outside_the_output():
    ops, starts, length, steps = operands("mixed", 16, 12)
    with pytest.raises(ValueError, match="outside"):
        scan.decode_placed_plain(*ops, starts, torch.zeros(length - 14, dtype=torch.uint8), bits=12, num_steps=steps,
                                 tail=True)
    with pytest.raises(ValueError, match="outside"):
        scan.decode_placed_plain(*ops, starts - 1, torch.zeros(length, dtype=torch.uint8), bits=12, num_steps=steps,
                                 tail=True)


def test_dispatch_takes_the_placed_plain_version_for_cpu_operands(monkeypatch):
    seen = []
    monkeypatch.setattr(scan, "decode_placed_plain", lambda *a, **k: seen.append(a[0].device.type))
    ops, starts, length, steps = operands("one stream", 16, 12)
    scan.decode_placed_kernel(*ops, starts, torch.zeros(length, dtype=torch.uint8), bits=12, num_steps=steps, tail=True)
    assert seen == ["cpu"]


@cache
def mt16_case(n: int) -> tuple[np.ndarray, bytes]:
    """Single-symbol runs that open and split the coded stretches, coded
    blocks of 2 KiB and less (the last off the lane grid), mt-encoded by
    the numpy encoder."""
    rng = np.random.default_rng(70 + n)
    parts = [(3, 700), (None, 9 * 1024), (7, 3000), (None, 4 * 2048 + 77)]
    data = np.concatenate([np.full(size, sym, np.uint8) if sym is not None else text_like(rng, size)
                           for sym, size in parts])
    plan, at = [], 0
    for sym, size in parts:
        if sym is not None:
            plan.append(BlockPlan(at, size, True, sym, None))
        else:
            cut = list(range(at, at + size, 2048))
            for s, e in zip(cut, cut[1:] + [at + size]):
                plan.append(BlockPlan(s, e - s, False, 0, make_tile_hist(data[s:e], 12).symbol_count))
        at += size
    return data, mt_encode_py(data, 12, n, plan)


@pytest.mark.parametrize("k", (1, 2, 3))
@pytest.mark.parametrize("n", (16, 32, 64))
def test_scan_decode_blob_split_equals_mt_decode_py_and_jax(n, k):
    """Route (c) over `["cpu"] * k` == the numpy decoder == the JAX
    package's mt_decode_device == the input, on blocks with single runs
    between them and on uniform blocks."""
    data, blob = mt16_case(n)
    uniform = mt_encode_py(data, 12, n, jsh.uniform_plan(data, 12, n, 4096))
    for b in (blob, uniform):
        want = mt_decode_py(b, 12, n)
        assert want == data.tobytes() == jsh.mt_decode_device(b, 12, n)
        assert psh.scan_decode_blob(b, 12, n, ["cpu"] * k) == want


def test_placed_bytes_count_every_coded_byte():
    """One 16-state mt_decode_device call adds the coded blocks' summed size
    to MT_DEVICE_COUNTS["placed_bytes"], and its single runs nothing."""
    data, blob = mt16_case(16)
    _, _, blocks = psh.block_index(blob, 16)
    coded = sum(b.size for b in blocks if not b.is_single)
    assert 0 < coded < data.size
    before = psh.MT_DEVICE_COUNTS["placed_bytes"]
    assert psh.mt_decode_device(blob, 12, 16, device="cpu") == data.tobytes()
    assert psh.MT_DEVICE_COUNTS["placed_bytes"] - before == coded


def test_placed_cuda_refuses_cpu_operands():
    """The kernel's wrapper takes CUDA tensors alone; the CPU tier goes
    through the plain version."""
    ops, starts, length, steps = operands("one stream", 16, 12)
    with pytest.raises(ValueError, match="CUDA"):
        scan.decode_placed_cuda(*ops, starts, torch.zeros(length, dtype=torch.uint8), bits=12, num_steps=steps,
                                tail=True)
