"""The port's copy of the tpx host tier (`hsrans_tpu_torch/ops`, `/models`)
against its originals in the JAX package: histograms (the original takes the
native C++ path where it builds), the v3 planner and geometry, the default
geometry, the header, the mega writer and the parser, on valid and corrupt
blobs.  Exact equality: everything here is written into the wire."""

from pathlib import Path

import numpy as np
import pytest
import torch

from hsrans_tpu.models import histogram as jh
from hsrans_tpu.models import tables as jtab
from hsrans_tpu.ops import planner as jplan
from hsrans_tpu.ops import tpx as jt
from hsrans_tpu_torch.models import histogram as ph
from hsrans_tpu_torch.ops import planner as pplan
from hsrans_tpu_torch.ops import tpx as pt
from tools.gen_inputs import mixed, rle, skewed, text_like, uniform

CORPUS = Path(__file__).parent / "corpus" / "corpus.bin"
GEN = {"text": text_like, "skewed": skewed, "uniform": uniform, "rle": rle, "mixed": mixed}


def _hist_equal(a, b) -> None:
    assert a.total_symbol_count_bits == b.total_symbol_count_bits
    assert a.symbol_count.dtype == b.symbol_count.dtype and np.array_equal(a.symbol_count, b.symbol_count)
    assert np.array_equal(a.cumul, b.cumul)


@pytest.mark.parametrize("bits", range(10, 16))
@pytest.mark.parametrize("kind", sorted(GEN))
def test_tile_hist_equals_original(kind, bits):
    rng = np.random.default_rng(bits)
    for n in (1, 300, 70_000):
        data = GEN[kind](rng, n)
        _hist_equal(pt.make_tile_hist(data, bits), jt.make_tile_hist(data, bits))
    _hist_equal(pt.make_tile_hist(np.zeros(0, np.uint8), bits), jt.make_tile_hist(np.zeros(0, np.uint8), bits))


@pytest.mark.parametrize("bits", (10, 12, 15))
def test_batched_tile_hists_equal_make_tile_hist(bits):
    """The encoders' batched tile histograms (`models/device_hist.py::
    segment_hists` on the CPU) == make_tile_hist (the port's and the
    original) tile by tile: uniform 4 KiB tiles (no fix-up at B=12), odd
    sizes (the steal and gift passes), empty tiles, tiles past the input's
    end, and tiles out of order."""
    from hsrans_tpu_torch.models.device_hist import segment_hists

    rng = np.random.default_rng(bits)
    data = np.concatenate([text_like(rng, 40_000), skewed(rng, 30_000), np.full(5000, 7, np.uint8)])
    starts = np.concatenate([np.arange(0, 40_960, 4096), [40_960, 41_000, 41_000, 50_017, 75_000, 74_990, 100]])
    ends = np.concatenate([starts[:10] + 4096, [41_000, 41_000, 50_017, 74_990, 75_000, 75_000, 33]])
    ends = np.minimum(ends, data.size)
    freq, cumul = segment_hists(torch.from_numpy(data), starts, ends, bits)
    got = freq.numpy().view(np.uint16)
    assert got.shape == (starts.size, 256)
    for row, cum, s, e in zip(got, cumul.numpy().view(np.uint16), starts, ends):
        want = pt.make_tile_hist(data[s:e], bits)
        assert np.array_equal(row, want.symbol_count) and np.array_equal(cum, want.cumul)
        assert np.array_equal(row, jt.make_tile_hist(data[s:e], bits).symbol_count)


def test_normalize_and_complete_equal_original():
    """Random counts with the divisor off the count's sum on purpose (the
    steal and the gift passes both run), and wire freqs that do or do not
    sum to 2^B."""
    rng = np.random.default_rng(2)
    for i in range(60):
        bits = 10 + i % 6
        counts = (rng.integers(0, 50, 256) * (rng.random(256) < 0.4)).astype(np.uint32)
        counts[rng.integers(0, 256)] += 1
        divisor = int(counts.sum()) + int(rng.integers(-int(counts.sum()) // 2, 200))
        _hist_equal(ph.normalize_hist(counts, max(divisor, 1), bits), jh.normalize_hist(counts, max(divisor, 1), bits))
        assert np.array_equal(ph.observe_hist(counts.astype(np.uint8)), jh.observe_hist(counts.astype(np.uint8)))
        freqs = ph.normalize_hist(counts, int(counts.sum()), bits).symbol_count
        _hist_equal(ph.complete_hist(freqs, bits), jh.complete_hist(freqs, bits))
        bad = freqs.copy()
        bad[0] += 1
        assert ph.complete_hist(bad, bits) is None and jh.complete_hist(bad, bits) is None
        assert np.array_equal(ph.make_cumul_inv(ph.complete_hist(freqs, bits)), jtab.make_cumul_inv(jh.complete_hist(freqs, bits)))


def _corpus_cases():
    arr = np.fromfile(CORPUS, np.uint8)
    rng = np.random.default_rng(5)
    return {
        "corpus-1MiB": arr[: 1 << 20],
        "corpus-tail": arr[-(3 << 18) :],
        "mixed": mixed(rng, 1 << 20),
        "rle": rle(rng, 300_000),
        "tiny": text_like(rng, 5000),
        "empty": np.zeros(0, np.uint8),
    }


@pytest.mark.parametrize("bits", (10, 12, 15))
def test_planner_and_geometry_equal_original(bits):
    for name, arr in _corpus_cases().items():
        want = jplan.plan_blocks(arr, bits, "mt", 64)
        got = pplan.plan_blocks_py(arr, bits, "mt", 64)
        assert [(b.start, b.size, b.is_single, b.symbol) for b in got] == [
            (b.start, b.size, b.is_single, b.symbol) for b in want
        ], name
        g_p, g_j = pt.tpx_plan_geometry(arr, bits), jt.tpx_plan_geometry(arr, bits)
        assert [(g.base, g.rows, g.steps, g.n_tiles, g.span) for g in g_p] == [
            (g.base, g.rows, g.steps, g.n_tiles, g.span) for g in g_j
        ], name


def test_params_layout_and_header_equal_original():
    lengths = [0, 1, 777, 85_000, 1 << 20, 6 << 20, (32 << 20) - 1, 32 << 20, (64 << 20) + 5]
    for goal in ("speed", "balanced", "ratio"):
        for n in lengths:
            a, b = pt.TpxParams.auto(n, 12, goal), jt.TpxParams.auto(n, 12, goal)
            assert (a.bits, a.rows, a.lanes, a.steps, a.tiles, a.mega_bytes) == (b.bits, b.rows, b.lanes, b.steps, b.tiles, b.mega_bytes)
            assert pt._mega_layout(n, a) == jt._mega_layout(n, b)
            assert pt.tpx_header(n, a) == jt.tpx_header(n, b)
    assert (pt.MAGIC, pt.MAGIC2, pt.MAGIC3, pt.L) == (jt.MAGIC, jt.MAGIC2, jt.MAGIC3, jt.L)
    from hsrans_tpu.rans import DECODE_CONSUME_POINT_16

    assert pt.DECODE_CONSUME_POINT_16 == DECODE_CONSUME_POINT_16


def test_write_mega_equals_original():
    rng = np.random.default_rng(9)
    n_tiles, rows, w_slots = 3, 16, 128
    states = rng.integers(0, 1 << 32, (rows, 128), dtype=np.uint64).astype(np.uint32)
    freqs = rng.integers(0, 1 << 16, (n_tiles, 256)).astype(np.uint16)
    counts = rng.integers(0, 2 * w_slots + 1, (n_tiles, rows)).astype(np.uint16)
    stream = rng.integers(0, 1 << 32, (n_tiles, rows, w_slots), dtype=np.uint64).astype(np.uint32)
    a, b = bytearray(b"x"), bytearray(b"x")
    pt._write_mega(a, n_tiles, w_slots, states, freqs, counts, stream)
    jt._write_mega(b, n_tiles, w_slots, states, freqs, counts, stream)
    assert a == b


def _parsed(res, blob=None):
    """The parse's fields; with `blob` (the port's parse) each mega's
    rectangular [T, R, W] stream is rebuilt from its ragged fields: row i's
    row_start[i + 1] - row_start[i] slots at blob byte slot_off + 4 *
    row_start[i], then 0 up to w_slots."""
    if res is None:
        return None
    p, length, megas = res
    rows = []
    for m in megas:
        if blob is None:
            stream = m.stream
        else:
            slots = np.frombuffer(blob[m.slot_off : m.slot_off + 4 * int(m.row_start[-1])], "<u4")
            sc = np.diff(m.row_start)
            stream = np.zeros((m.n_tiles * m.rows, m.w_slots), np.uint32)
            stream[np.repeat(np.arange(sc.size), sc), np.arange(slots.size) - np.repeat(m.row_start[:-1], sc)] = slots
            stream = stream.reshape(m.n_tiles, m.rows, m.w_slots)
        rows.append(
            (m.base, m.n_tiles, m.w_slots, m.rows, m.steps, m.span, m.states.tobytes(), m.freqs.tobytes(),
             m.counts.tobytes(), stream.dtype.str, stream.shape, stream.tobytes())
        )
    return (p.bits, p.rows, p.lanes, p.steps, p.tiles), length, rows


def test_parse_equals_original_on_valid_and_corrupt_blobs():
    rng = np.random.default_rng(13)
    data = text_like(rng, 60_000)
    blobs = [
        jt.tpx_encode(data, 12),
        jt.tpx_encode(data, p=jt.TpxParams(bits=13, rows=8, steps=8, tiles=2)),
        jt.tpx_encode_adaptive(data, 12),
        jt.tpx_encode(np.zeros(0, np.uint8), 12),
    ]
    v1 = bytearray(blobs[1])  # a v2 body under the v1 magic: the rectangular reader's path
    v1[:8] = jt.MAGIC
    cases = list(blobs)
    for blob in blobs:
        cases += [blob[:cut] for cut in (0, 43, 44, 60, len(blob) // 2, len(blob) - 1)]
        for _ in range(25):
            b = bytearray(blob)
            b[int(rng.integers(0, len(b)))] ^= int(rng.integers(1, 256))
            cases.append(bytes(b))
    cases.append(bytes(v1))
    for blob in cases:
        assert _parsed(pt.tpx_parse(blob), blob) == _parsed(jt.tpx_parse(blob))
    assert pt.tpx_parse(blobs[2]) is not None
