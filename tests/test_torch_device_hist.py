"""The port's on-device histogram model (`hsrans_tpu_torch/models/
device_hist.py`) on its CPU tier, the kernels' plain versions, against the
JAX package's `models/jax_hist.py` (jit on the CPU), the numpy authority
(`models/histogram.py`, `models/tables.py`, `ops/tpx.py`), and the tpx
encoder's tables made from its freqs against `make_enc_tables_batch`.
Exact equality: the histograms are written into the wire, so the tolerance
is zero."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from hsrans_tpu.kernels import tpx_encode as jx
from hsrans_tpu.models import jax_hist as jh
from hsrans_tpu.models.histogram import _heap_sort_indices, make_hist, normalize_hist, observe_hist
from hsrans_tpu.models.tables import make_dec3
from hsrans_tpu.ops.tpx import make_rank_tables, make_tile_hist
from hsrans_tpu_torch.kernels import tpx_encode as pt
from hsrans_tpu_torch.models import device_hist as dh
from tools.gen_inputs import skewed, text_like

CPU = torch.device("cpu")
# the cases of tests/test_jax_hist.py::_cases
CASES = ("single symbol", "flat", "uniform", "skewed", "very skewed", "3 symbols", "binary")


def _case(name: str) -> np.ndarray:
    rng = np.random.default_rng(CASES.index(name))
    return {
        "single symbol": lambda: np.zeros(100, np.uint8),
        "flat": lambda: np.arange(256, dtype=np.uint8),
        "uniform": lambda: rng.integers(0, 256, 10_000).astype(np.uint8),
        "skewed": lambda: np.minimum(rng.geometric(0.07, 50_000) - 1, 255).astype(np.uint8),
        "very skewed": lambda: np.minimum(rng.geometric(0.60, 30_000) - 1, 255).astype(np.uint8),
        "3 symbols": lambda: rng.choice([0, 3, 200], 7_777).astype(np.uint8),
        "binary": lambda: rng.integers(0, 2, 65_536).astype(np.uint8),
    }[name]()


def _u16(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint16)


@pytest.mark.parametrize("name", CASES)
def test_observe_device_equals_jax_and_host(name):
    data = _case(name)
    got = dh.observe_device(torch.from_numpy(data)).numpy().view(np.uint32)
    assert np.array_equal(got, np.asarray(jh.observe_device(data)))
    assert np.array_equal(got, observe_hist(data))


@pytest.mark.parametrize("bits", (10, 12, 15))
@pytest.mark.parametrize("name", CASES)
def test_make_hist_device_equals_jax_and_host(name, bits):
    data = _case(name)
    freq, cumul = dh.make_hist_device(torch.from_numpy(data), bits)
    ref = make_hist(data, bits)
    jf, jc = jh.make_hist_device(data, bits=bits)
    assert np.array_equal(_u16(freq), ref.symbol_count) and np.array_equal(_u16(freq), np.asarray(jf))
    assert np.array_equal(_u16(cumul), ref.cumul) and np.array_equal(_u16(cumul), np.asarray(jc))


@pytest.mark.parametrize("divisor", ("2^16", "12345", "sum"))
@pytest.mark.parametrize("bits", (10, 12))
def test_normalize_device_divisor_override(bits, divisor):
    """A divisor other than the counts' sum (the block codecs pass one), as
    tests/test_jax_hist.py::test_normalize_device_divisor_override has it."""
    counts = np.random.default_rng(2).integers(0, 5000, 256).astype(np.uint32)
    d = {"2^16": 1 << 16, "12345": 12345, "sum": int(counts.sum())}[divisor]
    freq, cumul = dh.normalize_device(torch.from_numpy(counts.view(np.int32)), d, bits)
    ref = normalize_hist(counts, d, bits)
    jf, jc = jh.normalize_device(counts, np.int32(d), bits=bits)
    assert np.array_equal(_u16(freq), ref.symbol_count) and np.array_equal(_u16(freq), np.asarray(jf))
    assert np.array_equal(_u16(cumul), ref.cumul) and np.array_equal(_u16(cumul), np.asarray(jc))


@pytest.mark.parametrize("bits", (10, 12, 15))
@pytest.mark.parametrize("name", CASES[:4])
def test_decode_tables_equal_host(name, bits):
    """make_dec3_device and make_rank_tables_device == models/tables.py::
    make_dec3 and ops/tpx.py::make_rank_tables (and the JAX module's)."""
    ref = make_hist(_case(name), bits)
    f, c = torch.from_numpy(ref.symbol_count.view(np.int16)), torch.from_numpy(ref.cumul.view(np.int16))
    dec3, jdec3 = dh.make_dec3_device(f, c, bits), jh.make_dec3_device(ref.symbol_count, ref.cumul, bits=bits)
    for k, want in make_dec3(ref).items():
        assert np.array_equal(dec3[k].numpy().astype(np.int64), want.astype(np.int64)), k
        assert np.array_equal(dec3[k].numpy().astype(np.int64), np.asarray(jdec3[k]).astype(np.int64)), k
    rt, jrt = dh.make_rank_tables_device(f, c, bits), jh.make_rank_tables_device(ref.symbol_count, ref.cumul, bits=bits)
    host = make_rank_tables(ref)
    for k in ("c0", "bm", "t1", "t2"):
        assert rt[k].dtype == torch.int32 and np.array_equal(rt[k].numpy(), host[k].view(np.int32)), k
        assert np.array_equal(rt[k].numpy().view(np.uint32), np.asarray(jrt[k]).astype(np.uint32)), k


@pytest.mark.parametrize("bits", (4, 10, 12, 15))
def test_segments_equal_make_tile_hists(bits):
    """observe_segments + normalize_rows over ragged segments (any start,
    empty, an end below its start, one byte, one past several count
    chunks) == the JAX package's `make_tile_hist` segment by segment,
    cumuls included."""
    rng = np.random.default_rng(bits)
    data = np.concatenate([text_like(rng, 150_000), skewed(rng, 60_000)])
    starts = np.array([0, 3, 4096, 77, 200_000, 100, 9, 1, 209_999, 1000], np.int64)
    ends = np.array([4096, 4099, 8192, 77, 210_000, 50, 10, 2 * dh.COUNT_CHUNK + 7, 210_000, 150_000], np.int64)
    freq, cumul = dh.segment_hists(torch.from_numpy(data), starts, ends, bits)
    assert freq.dtype == cumul.dtype == torch.int16 and freq.shape == (starts.size, 256)
    for i, (s, e) in enumerate(zip(starts, ends)):
        want = make_tile_hist(data[s:e], bits)
        assert np.array_equal(_u16(freq[i]), want.symbol_count) and np.array_equal(_u16(cumul[i]), want.cumul)


def _passes(capped: np.ndarray, total: int) -> int:
    """A lower bound of the steal or charity passes that `normalize_hist`
    makes on one row of rounded counts: each pass covers the sorted
    positions from the first count >= 2 on, and that start only moves
    up (models/histogram.py:80-111)."""
    ge2 = int((capped >= 2).sum())
    return -(-abs(int(capped.sum()) - total) // (ge2 or 256))


@pytest.mark.parametrize("bits", (10, 12, 15))
@pytest.mark.parametrize("case", chip_smoke.HIST_EDGES)
def test_hist_edges_plain_equal_authority(case, bits):
    """chip_smoke.py's HIST_EDGES, which the card holds each kernel to its
    plain version on: the plain count == numpy's per segment (the 1-symbol
    count for an empty one), the plain normaliser == `normalize_hist` row by
    row, and the edges reach what they name: every byte phase, several
    count chunks, rows that take the fix-up, and several passes."""
    data_t, starts, ends, divisors = chip_smoke.hist_edge_operands(case, CPU)
    data = data_t.numpy()
    counts = dh.observe_segments(data_t, starts, ends)
    for row, s, e in zip(counts.numpy().view(np.uint32), starts, ends):
        want = observe_hist(data[s:e]) if e > s else np.eye(1, 256, dtype=np.uint32)[0]
        assert np.array_equal(row, want)
    div = dh.segment_divisors(starts, ends) if divisors is None else divisors
    freq, cumul = dh.normalize_rows(counts, torch.from_numpy(div), bits)
    for i, row in enumerate(counts.numpy().view(np.uint32)):
        ref = normalize_hist(row, int(div[i]), bits)
        assert np.array_equal(_u16(freq[i]), ref.symbol_count) and np.array_equal(_u16(cumul[i]), ref.cumul)
    rounded = dh.round_rows(counts, torch.from_numpy(div), bits).numpy()
    passes = max(_passes(r, 1 << bits) for r in rounded)
    if case == chip_smoke.HIST_EDGES[0]:
        assert set((starts % 16).tolist()) == set(range(16))
        assert (dh.segment_sizes(starts, ends) > 2 * dh.COUNT_CHUNK).any()
    elif case in chip_smoke.HIST_EDGES[1:2]:
        assert (ends <= starts).sum() >= 3 and (ends - starts == 1).sum() >= 3
    elif case in chip_smoke.HIST_EDGES[4:6]:
        assert passes >= 10
    elif case == chip_smoke.HIST_EDGES[6]:
        sizes = dh.segment_sizes(starts, ends)
        t = dh.COUNT_WARP_MAX
        for size in (t - 1, t, t + 1):
            assert set((starts[sizes == size] % 16).tolist()) == set(range(16))
        short = sizes <= t
        assert short.any() and (sizes > 2 * dh.COUNT_CHUNK).any() and (short[1:] != short[:-1]).sum() >= 16


@pytest.mark.parametrize("bits", (10, 12, 13, 15))
def test_enc_tables_device_equal_batch(bits):
    """The tpx encoder's tables made from freqs and cumuls on the device
    (`enc_tables_device`: m and l gathered by freq) == the JAX package's
    make_enc_tables_batch, freqs of every divisor of
    tests/test_tpx_encode_kernel.py and an absent symbol among them."""
    rng = np.random.default_rng(bits)
    hists = [make_hist(text_like(rng, 30_000), bits), make_hist(np.arange(256, dtype=np.uint8).repeat(7), bits)]
    divisors = [1, 2, 3, 4, 5, 7, 8, 15, 16, 17, 255, 256, 257, 1023, 1024, 4095, 4096, 32767, 32768]
    odd = np.zeros(256, np.uint16)
    odd[: len(divisors)] = [min(d, 1 << bits) for d in divisors]
    freqs = np.stack([h.symbol_count for h in hists] + [odd])
    cumuls = np.stack([h.cumul for h in hists] + [(np.cumsum(odd) - odd).astype(np.uint16)])
    got = pt.enc_tables_device(torch.from_numpy(freqs.view(np.int16)), torch.from_numpy(cumuls.view(np.int16)), bits)
    want = jx.make_enc_tables_batch(freqs, cumuls, bits)
    for k, t in zip(("fc", "m", "l"), got):
        assert t.dtype == torch.int32 and np.array_equal(t.numpy(), want[k]), k


def test_rows_and_segments_are_checked():
    counts = torch.zeros((2, 256), dtype=torch.int32)
    with pytest.raises(ValueError):
        dh.normalize_rows(counts, torch.ones(3, dtype=torch.int64), 12)
    with pytest.raises(ValueError):
        dh.normalize_rows(counts, torch.ones(2, dtype=torch.int64), 16)
    with pytest.raises(ValueError):
        dh.normalize_rows(counts, torch.tensor([1, 0]), 12)
    with pytest.raises(ValueError):
        dh.observe_segments(torch.zeros(10, dtype=torch.uint8), np.array([0]), np.array([11]))
    table, n_short, chunks = dh.segment_table(np.array([0, 5, 9]), np.array([dh.COUNT_CHUNK + 1, 5, 3]))
    assert table.T.tolist() == [[5, 5, 1, 0], [9, 3, 2, 0], [0, dh.COUNT_CHUNK + 1, 0, 0]]
    assert (n_short, chunks) == (2, 2)


# rows of counts whose rounded values tie heavily, for the heap sort's tie order
TIE_ROWS = ("all equal", "two values only", "sparse text", "zipf")


def _tie_rows(kind: str, bits: int) -> tuple[np.ndarray, np.ndarray]:
    """(counts uint32 [r, 256], divisors int64 [r]) of one TIE_ROWS kind at
    depth `bits`: each row once with its own sum as divisor and once with
    one that moves the rounded sum off 2^B, so that every row sorts."""
    rng = np.random.default_rng(60 + TIE_ROWS.index(kind) * 16 + bits)
    if kind == "all equal":
        rows = [np.full(256, c, np.uint32) for c in (0, 1, 3, (1 << bits) >> 8, 1000)]
    elif kind == "two values only":
        rows = [np.where(rng.random(256) < p, hi, lo).astype(np.uint32)
                for p, lo, hi in ((0.1, 1, 5), (0.5, 2, 3), (0.9, 0, 40), (0.5, 7, 7000))]
    elif kind == "sparse text":
        rows = [observe_hist(text_like(rng, n)) for n in (300, 2000, 20_000)]
    else:
        rows = [np.bincount(np.minimum(rng.zipf(a, n) - 1, 255), minlength=256).astype(np.uint32)
                for a, n in ((1.1, 100_000), (1.5, 30_000), (2.5, 5_000))]
    sums = np.stack(rows).sum(axis=1, dtype=np.int64)
    return np.stack(rows + rows), np.concatenate([np.maximum(sums, 1), sums * 3 // 2 + 7])


_jax_heap_sort = jax.jit(jh._heap_sort_indices)


@pytest.mark.parametrize("bits", (10, 12, 15))
@pytest.mark.parametrize("kind", TIE_ROWS)
def test_heap_keys_equal_reference_sorts(kind, bits):
    """The plain form of the normalise kernel's heap sort (`heap_keys`:
    packed keys compared on count alone, the heapify by depth, a serial
    extraction) gives the order of the numpy authority's and of the JAX
    module's `_heap_sort_indices` on rows of heavy ties, sorted whole; cut
    where the kernel cuts it (at the first count >= 2), the positions from
    there up are the same."""
    counts, divisors = _tie_rows(kind, bits)
    capped = dh.round_rows(torch.from_numpy(counts.view(np.int32)), torch.from_numpy(divisors), bits)
    small = (capped <= 1).sum(dim=1)
    whole = dh.heap_keys(capped)
    cut = dh.heap_keys(capped, torch.where(small == 256, 1, small.clamp(min=1)))
    for row, w, c, z in zip(capped.numpy(), whole.numpy(), cut.numpy(), small.tolist()):
        ref = _heap_sort_indices(row.astype(np.uint16))
        assert np.array_equal(np.asarray(_jax_heap_sort(jnp.asarray(row.astype(np.int32)))), ref)
        assert np.array_equal(w & 0xFF, ref) and np.array_equal(w >> 8, row[ref])
        lo = 0 if z == 256 else z
        assert np.array_equal(c[lo:] & 0xFF, ref[lo:]) and (row[c[:lo] & 0xFF] <= 1).all()


@pytest.mark.parametrize("bits", (10, 12, 15))
@pytest.mark.parametrize("kind", TIE_ROWS)
def test_normalize_rows_plain_equal_normalize_hist(kind, bits):
    """normalize_rows_plain (every row at once through the kernel's
    schedule) == `normalize_hist` row for row on the tie-heavy rows."""
    counts, divisors = _tie_rows(kind, bits)
    freq, cumul = dh.normalize_rows_plain(torch.from_numpy(counts.view(np.int32)), torch.from_numpy(divisors), bits)
    fixed = 0
    for i, row in enumerate(counts):
        ref = normalize_hist(row, int(divisors[i]), bits)
        assert np.array_equal(_u16(freq[i]), ref.symbol_count) and np.array_equal(_u16(cumul[i]), ref.cumul)
        fixed += int(dh.round_rows(torch.from_numpy(row[None].view(np.int32)), torch.tensor([divisors[i]]),
                                   bits).sum()) != 1 << bits
    assert fixed >= len(counts) // 2


def _count_pieces(table: np.ndarray, n_short: int, chunks: int) -> list[tuple[str, int, int, int]]:
    """What each warp and CTA of the count kernel reads, by its addressing
    (csrc/hist.cu::hist_count_kernel): (path, row, first byte, end)."""
    pieces = [("warp", int(r), int(s), int(e)) for s, e, r, _ in table.T[:n_short]]
    long_rows = table.T[n_short:]
    for c in range(chunks):
        s, e, r, c0 = long_rows[np.searchsorted(long_rows[:, 3], c, side="right") - 1]
        a = s + (c - c0) * dh.COUNT_CHUNK
        pieces.append(("chunk", int(r), int(a), int(min(a + dh.COUNT_CHUNK, e))))
    return pieces


SEGMENT_CASES = ("at the threshold", "one below", "one above", "empty and one byte", "mixed")


@pytest.mark.parametrize("case", SEGMENT_CASES)
def test_segment_table_puts_each_segment_on_one_path(case):
    """The count's segment table: each segment on exactly one path, a warp
    for up to COUNT_WARP_MAX bytes (empty ones too), 64 KiB chunks of a CTA
    above; the pieces cover each segment's bytes once, so summing their
    counts gives numpy's; the rows zeroed before the count (those of the
    long segments of more than COUNT_CHUNK bytes) are those that take
    atomics, of several chunks."""
    t = dh.COUNT_WARP_MAX
    lens = {"at the threshold": [t], "one below": [t - 1], "one above": [t + 1], "empty and one byte": [0, 1],
            "mixed": [t - 1, t, t + 1, 0, 1, 4096, 2 * dh.COUNT_CHUNK + 5, dh.COUNT_CHUNK, dh.COUNT_CHUNK + 1]}[case]
    rng = np.random.default_rng(SEGMENT_CASES.index(case))
    sizes = rng.permutation(np.repeat(np.array(lens, np.int64), 16))
    starts = (np.arange(sizes.size, dtype=np.int64) * (3 * dh.COUNT_CHUNK)) + np.tile(np.arange(16), len(lens))
    ends = starts + sizes
    if case == "empty and one byte":
        ends[:3] = starts[:3] - 5  # an end below its start is empty
    data = rng.integers(0, 256, int(ends.max()) + 16).astype(np.uint8)
    table, n_short, chunks = dh.segment_table(starts, ends)
    pieces = _count_pieces(table, n_short, chunks)
    paths = {}
    for path, r, a, e in pieces:
        assert paths.setdefault(r, path) == path
    assert sorted(paths) == list(range(starts.size))
    got = np.zeros((starts.size, 256), np.int64)
    covered = {r: [] for r in paths}
    for path, r, a, e in pieces:
        covered[r].append((a, e))
        got[r] += np.bincount(data[a:e], minlength=256) if e > a else np.eye(1, 256, dtype=np.int64)[0]
    for r, (s, e) in enumerate(zip(starts, ends)):
        want_path = "warp" if e - s <= t else "chunk"
        assert paths[r] == want_path
        spans = sorted(covered[r])
        assert spans[0][0] == s and all(x[1] == y[0] for x, y in zip(spans, spans[1:]))
        assert spans[-1][1] == e if e > s else spans == [(s, e)]
    assert np.array_equal(got, dh.observe_segments(torch.from_numpy(data), starts, ends).numpy())
    zeroed = {int(r) for s, e, r, _ in table.T[n_short:] if e - s > dh.COUNT_CHUNK}
    assert zeroed == {r for r in paths if len(covered[r]) > 1}
