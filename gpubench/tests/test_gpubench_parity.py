"""The benchmark's frozen reference planner and codecs against the
program's host codecs and planner, on the CPU at small sizes: the numpy tpx
codec, the numpy mt codec, the plain PyTorch tier of `mt_encode_torch`,
the greedy planner and `device_plan`.  The repository's own tests hold each
of those equal to the JAX package's original, so the reference equals the
original through them; this file, like the rest of the benchmark, loads no
module of the JAX package."""

import numpy as np
import pytest
import torch

from gpubench.data import text_like, xray
from gpubench.reference import hist, mt, planner, tpx
from hsrans_tpu_torch import mt_encode_torch
from hsrans_tpu_torch import tpx_decode as port_tpx_decode
from hsrans_tpu_torch import tpx_encode as port_tpx_encode
from hsrans_tpu_torch.kernels.mt_encode import uniform_rows
from hsrans_tpu_torch.models.histogram import normalize_hist
from hsrans_tpu_torch.ops.mt import mt_decode_py, mt_encode_py
from hsrans_tpu_torch.ops.planner import plan_blocks_py
from hsrans_tpu_torch.ops.tpx import tpx_parse
from hsrans_tpu_torch.parallel.sharded import device_plan

CPU = torch.device("cpu")


def text(n: int, seed: int) -> bytes:
    gen = torch.Generator()
    gen.manual_seed(seed)
    return text_like.make(gen, n, CPU, {}).numpy().tobytes()


def radiograph(n: int, seed: int, side: int = 128) -> bytes:
    gen = torch.Generator()
    gen.manual_seed(seed)
    return xray.make(gen, n, CPU, {"side": side}).numpy().tobytes()


def count_rows(rng: np.random.Generator) -> list[np.ndarray]:
    """Byte counts of every shape the normalisation branches on: one
    symbol, a few, all 256, flat, Zipf, many rare ones."""
    rows = [np.bincount([7], minlength=256), np.bincount(rng.integers(0, 3, 5000), minlength=256),
            np.bincount(rng.integers(0, 256, 100000), minlength=256), np.full(256, 4)]
    for _ in range(40):
        n = int(rng.integers(1, 200000))
        rows.append(np.bincount((rng.zipf(float(rng.uniform(1.05, 2.5)), n) - 1) % 256, minlength=256))
    return rows


@pytest.mark.parametrize("rows_at_once", [1, 44])
@pytest.mark.parametrize("bits", [10, 11, 12, 15])
def test_normalize_rows_equals_the_programs(bits, rows_at_once):
    """Both heap sorts: one row at a time, and all rows side by side."""
    counts = np.stack(count_rows(np.random.default_rng(bits)))
    sizes = counts.sum(axis=1)
    got = np.concatenate([hist.normalize_rows(counts[i : i + rows_at_once], sizes[i : i + rows_at_once], bits)
                          for i in range(0, len(counts), rows_at_once)])
    for r, c, n in zip(got, counts, sizes):
        assert (r == normalize_hist(c.astype(np.uint32), int(n), bits).symbol_count).all()


@pytest.mark.parametrize("n", [0, 1, 130, 64001, (1 << 20) + 3])
@pytest.mark.parametrize("bits", [11, 12])
def test_tpx_reference_equals_the_programs_numpy_codec(n, bits):
    data = text(n, n + bits)
    blob = tpx.encode(data, bits)
    assert blob == port_tpx_encode(data, bits)
    assert tpx.decode(blob) == data
    assert port_tpx_decode(blob) == data
    assert tpx.tables(blob) == sum(m.n_tiles for m in tpx_parse(blob)[2])


def as_rows(plan) -> list[tuple]:
    return [(r.start, r.size, r.symbol if r.is_single else None, None if r.is_single else r.freq) for r in plan]


def same_rows(got, want) -> bool:
    return len(got) == len(want) and all(
        g[:3] == w[:3] and (g[3] is None) == (w[3] is None) and (g[3] is None or (g[3] == w[3]).all())
        for g, w in zip(got, want))


def mixed(seed: int) -> np.ndarray:
    """Radiographs, text and runs of one byte, the runs long enough to make
    single-symbol blocks and the rest coded blocks of many sizes."""
    rng = np.random.default_rng(seed)
    parts = [np.frombuffer(radiograph(300_000, seed, 256), np.uint8), np.full(200_000, 9, np.uint8),
             np.frombuffer(text(250_001, seed), np.uint8), np.zeros(140_000, np.uint8)]
    return np.concatenate([parts[i] for i in rng.permutation(4)])


@pytest.mark.parametrize("bits", [11, 12])
@pytest.mark.parametrize("seed", [1, 2])
def test_planner_equals_the_programs(seed, bits):
    arr = mixed(seed)
    assert same_rows(planner.greedy(arr, bits), as_rows(plan_blocks_py(arr, bits, "mt", 64)))
    for cap in (32 << 10, 8 << 10):
        assert same_rows(planner.device_layout(arr, bits, 64, cap), as_rows(device_plan(arr, bits, 64, cap)))


@pytest.mark.parametrize("bits", [11, 12])
@pytest.mark.parametrize("seed", [1, 2])
def test_mt_reference_equals_the_programs_encoder_in_the_device_layout(seed, bits):
    arr = mixed(seed)
    blob = mt.encode(arr, bits, planner.device_layout(arr, bits, 64, 32 << 10))
    assert blob == mt_encode_torch(arr, bits, plan=device_plan(arr, bits, 64, 32 << 10), device=CPU)
    assert mt.decode(blob, bits) == arr.tobytes()
    assert mt_decode_py(blob, bits, 64) == arr.tobytes()
    assert mt.tables(blob) == sum(r[2] is None for r in planner.device_layout(arr, bits, 64, 32 << 10))


@pytest.mark.parametrize("n, block", [(70001, 4096), (3 * 32768 + 100, 32768), (32768 + 30, 32768), (5000, 512)])
@pytest.mark.parametrize("kind", ["text", "xray"])
def test_mt_reference_equals_the_programs_encoder_in_uniform_blocks(n, block, kind):
    """Blocks of two sizes, a partial last group and a remainder joined to
    the last block, each block with its own histogram."""
    data = (text if kind == "text" else radiograph)(n, n)
    arr = np.frombuffer(data, np.uint8)
    spans = [(r.start, r.size) for r in uniform_rows(n, block)]
    freqs = hist.segment_freqs(arr, np.array([s for s, _ in spans]), np.array([s + z for s, z in spans]), 12)
    blob = mt.encode(arr, 12, [(s, z, None, f) for (s, z), f in zip(spans, freqs)])
    assert blob == mt_encode_torch(data, 12, block_size=block, device=CPU)
    assert mt.decode(blob, 12) == data
    assert mt_decode_py(blob, 12, 64) == data
    assert mt.tables(blob) == len(spans)


def test_mt_reference_decodes_carried_state_blobs_with_single_symbol_blocks():
    """The program's sequential numpy encoder: planned blocks of many sizes,
    states carried from block to block, runs of one byte as single-symbol
    blocks; the reference decoder reads them all."""
    rng = np.random.default_rng(3)
    parts = [np.frombuffer(text(40000, 1), np.uint8), np.full(70000, 9, np.uint8),
             np.frombuffer(radiograph(50001, 2), np.uint8), np.full(3000, 200, np.uint8)]
    data = np.concatenate([parts[i] for i in rng.permutation(4)]).tobytes()
    blob = mt_encode_py(data, 12, 64)
    assert mt.decode(blob, 12) == data
