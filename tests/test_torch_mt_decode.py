"""mt decode in the PyTorch port (`hsrans_tpu_torch.mt_decode_torch` on the
CPU tier, i.e. the kernel's plain version) and the port's copy of the mt
host tier, each against the JAX package: the numpy authority
(`hsrans_tpu.ops.mt`), the Pallas decoder in interpret mode
(`mt64_decode_tpu(..., interpret=True)`), and the C++ reference's golden
blobs.  Exact equality throughout: the codec is lossless, so the tolerance
is zero."""

from pathlib import Path

import numpy as np
import pytest
import torch

from hsrans_tpu import rans as jrans
from hsrans_tpu.kernels import mt64_decode as jdec
from hsrans_tpu.models.histogram import complete_hist as j_complete_hist
from hsrans_tpu.ops import mt as jmt
from hsrans_tpu.ops import planner as jplan
from hsrans_tpu.ops import reference as jref
from hsrans_tpu.parallel import sharded as jsh
from hsrans_tpu_torch import mt_decode_torch
from hsrans_tpu_torch import rans as prans
from hsrans_tpu_torch.kernels import mt_decode as pdec
from hsrans_tpu_torch.ops import mt as pmt
from hsrans_tpu_torch.ops import planner as pplan
from hsrans_tpu_torch.ops import reference as pref
from hsrans_tpu_torch.ops.tpx import make_tile_hist
from hsrans_tpu_torch.parallel import sharded as psh
from hsrans_tpu_torch.runtime import native as pn
from tools.gen_inputs import CASES, rle, text_like

from .conftest import runs_off_chunks

TESTS = Path(__file__).parent
GOLDEN = TESTS / "golden"
CORPUS = TESTS / "corpus" / "corpus.bin"
XRAY = TESTS / "corpus" / "xray.bin"


def _plan_rows(plan):
    return [(b.start, b.size, b.is_single, b.symbol, None if b.freq is None else b.freq.tobytes()) for b in plan]


def _rle_between_text(rng, n: int) -> np.ndarray:
    """Text with single-symbol runs between its stretches: the planner makes
    single-symbol blocks of the runs."""
    parts = [text_like(rng, n // 4), np.full(n // 4, 7, np.uint8), text_like(rng, n // 4), np.full(n - 3 * (n // 4), 200, np.uint8)]
    return np.concatenate(parts)


# ---------------------------------------------------------------- host tier


def test_rans_constants_equal_original():
    for n in (16, 32, 64):
        assert np.array_equal(prans.IDX2IDX[n], jrans.IDX2IDX[n])
        assert np.array_equal(prans.INV_IDX2IDX[n], jrans.INV_IDX2IDX[n])
    assert prans.DECODE_CONSUME_POINT_16 == jrans.DECODE_CONSUME_POINT_16
    for bits in range(10, 16):
        assert prans.encode_emit_point_16(bits) == jrans.encode_emit_point_16(bits)


def _slices():
    rng = np.random.default_rng(3)
    corpus = np.fromfile(CORPUS, np.uint8)
    return {
        "text": text_like(rng, 300_001),
        "rle": rle(rng, 400_000),
        "rle-between-text": _rle_between_text(rng, 300_000),
        "corpus-head": corpus[: 400_000],
        "corpus-tail": corpus[-300_000:],
        "tiny": text_like(rng, 70),
        "below-min-block": text_like(rng, 50_001),
        "one-symbol": np.full(300_001, 9, np.uint8),
        "runs-off-chunks": runs_off_chunks(rng),
    }


@pytest.mark.parametrize("n", (32, 64))
@pytest.mark.parametrize("bits", (10, 12, 15))
def test_planner_mt_equals_original(bits, n):
    """The port's plan_blocks_py(..., "mt", n) and its native plan_blocks
    == the original's plan_blocks_py, freqs included."""
    for name, arr in _slices().items():
        want = _plan_rows(jplan.plan_blocks_py(arr, bits, "mt", n))
        assert _plan_rows(pplan.plan_blocks_py(arr, bits, "mt", n)) == want, name
        assert _plan_rows(pplan.plan_blocks(arr, bits, "mt", n)) == want, name


@pytest.mark.parametrize("bits", (10, 12, 15))
def test_uniform_and_device_plan_equal_original(bits):
    xr = np.fromfile(XRAY, np.uint8)
    rng = np.random.default_rng(bits)
    for n in (32, 64):
        for arr in (xr[: 600_000], xr[-1_500_017:], _rle_between_text(rng, 250_000), runs_off_chunks(rng),
                    np.full(200_003, 3, np.uint8), xr[-40_000:], xr[:0]):
            for cap in (16 << 10, 32 << 10):
                assert _plan_rows(psh.device_plan(arr, bits, n, cap)) == _plan_rows(jsh.device_plan(arr, bits, n, cap))
            for block in (4096, 65536):
                assert _plan_rows(psh.uniform_plan(arr[: 100_017], bits, n, block)) == _plan_rows(
                    jsh.uniform_plan(arr[: 100_017], bits, n, block)
                )


def _counted(fn):
    """`fn()` and how much it moved each of `native.PLAN_COUNTS`."""
    before = dict(pn.PLAN_COUNTS)
    out = fn()
    return out, {k: pn.PLAN_COUNTS[k] - before[k] for k in before}


@pytest.mark.parametrize("case", ("xray-b12", "xray-b9", "empty"))
def test_device_plan_route_and_counter(case):
    """`device_plan` takes the native route wherever the native planner
    plans (one call, every span histogram but a few edges from the chunk
    table) and the Python route where it plans nothing (B outside 10..15,
    an empty input), with the original's answer on both: the same rows, or
    the same KeyError for B=9."""
    xr = np.fromfile(XRAY, np.uint8)
    arr, bits = {"xray-b12": (xr, 12), "xray-b9": (xr[:300_000], 9), "empty": (xr[:0], 12)}[case]
    if case == "xray-b9":
        _, moved = _counted(lambda: pytest.raises(KeyError, psh.device_plan, arr, bits, 64, 32 << 10))
        pytest.raises(KeyError, jsh.device_plan, arr, bits, 64, 32 << 10)
    else:
        got, moved = _counted(lambda: psh.device_plan(arr, bits, 64, 32 << 10))
        assert _plan_rows(got) == _plan_rows(jsh.device_plan(arr, bits, 64, 32 << 10))
    if case == "xray-b12":
        assert len(got) > 200 and moved["native"] == 1 and moved["python"] == 0
        assert moved["span_bytes"] > arr.size and 1 - moved["edge_bytes"] / moved["span_bytes"] >= 0.95
    else:
        assert moved == {"native": 0, "python": 1, "span_bytes": 0, "edge_bytes": 0}


def _short_rows(rng, chunk: int) -> np.ndarray:
    """Coded stretches of a little over the 2/3 of a chunk that the
    planner's window holds at the least, each from a chunk edge, between
    single-symbol runs (bytes no stretch holds) to the next-but-one edge:
    a row to a chunk."""
    coded = chunk * 2 // 3 + 64
    parts = []
    for i in range(24):
        parts += [text_like(rng, coded), np.full(2 * chunk - coded, 200 + i, np.uint8)]
    return np.concatenate(parts)


@pytest.mark.parametrize("mode,n,bits", [("block", 32, 12), ("block", 64, 15), ("mt", 64, 12), ("mt", 32, 10)])
def test_native_plan_rows_within_its_bound(mode, n, bits):
    """Every row holds the start of its window, a chunk edge, so the native
    planner's rows never outnumber the input's chunks; short runs between
    coded rows reach that bound, and it plans them natively, with the
    Python planner's rows, on one thread as on many."""
    chunk = 1 << (pplan.MIN_BLOCK_BITS_MT if mode == "mt" else pplan.MIN_BLOCK_BITS_BLOCK32 if n == 32
                  else pplan.MIN_BLOCK_BITS_BLOCK64)[bits]
    arr = _short_rows(np.random.default_rng(bits), chunk)
    got, moved = _counted(lambda: pplan.plan_blocks(arr, bits, mode, n))
    assert moved["native"] == 1 and moved["python"] == 0
    assert _plan_rows(got) == _plan_rows(pplan.plan_blocks_py(arr, bits, mode, n))
    one, many = pn.plan_blocks(arr, bits, mode, n, threads=1), pn.plan_blocks(arr, bits, mode, n, threads=8)
    assert len(one) == len(got) and all(np.array_equal(one[f], many[f]) for f in one.dtype.names)
    bound = pn.load().hsr_plan_max_rows(arr.size, bits, int(mode == "mt"), n)
    assert bound == -(-arr.size // chunk) and bound - 1 <= len(got) <= bound  # the first window spans two chunks
    assert sum(r.is_single for r in got) >= 23


def _golden_blobs():
    return sorted(GOLDEN.glob("*.mt*_*.bin"))


def _golden_case(path: Path) -> tuple[np.ndarray, int, int]:
    """(input, bits, n) of a golden mt blob, the input made as tools/gen_inputs.py makes it."""
    case, tag = path.stem.split(".")
    width, bits = tag[2:].split("_")
    fn, size = CASES[case]
    return fn(np.random.default_rng(sum(ord(c) for c in case)), size), int(bits), int(width)


@pytest.mark.parametrize("path", _golden_blobs(), ids=lambda p: p.stem)
def test_mt_encode_py_equals_golden_and_original(path):
    """The port's numpy encoder writes the C++ reference's golden blob."""
    data, bits, n = _golden_case(path)
    blob = pmt.mt_encode_py(data, bits, n)
    assert blob == path.read_bytes()
    assert blob == jmt.mt_encode_py(data, bits, n)


def test_mt_encode_py_equals_original_on_given_plans():
    rng = np.random.default_rng(5)
    data = _rle_between_text(rng, 200_000)
    for bits, n in ((12, 64), (14, 32)):
        for plan in (psh.uniform_plan(data, bits, n, 4096), psh.device_plan(data, bits, n, 16 << 10)):
            assert pmt.mt_encode_py(data, bits, n, plan) == jmt.mt_encode_py(data, bits, n, plan)
    assert pmt.mt_capacity(1 << 20, 64) == jmt.mt_capacity(1 << 20, 64)


def _index_rows(idx):
    if idx is None:
        return None
    length, stream, blocks = idx
    rows = [
        (b.out_start, b.size, b.is_single, b.symbol, b.word_start, b.is_last,
         None if b.states is None else b.states.tobytes(), None if b.freq is None else b.freq.tobytes())
        for b in blocks
    ]
    return length, stream.dtype.str, stream.tobytes(), rows


def test_block_index_and_word_counts_equal_original():
    """block_index and block_word_counts on valid, truncated and corrupt blobs."""
    rng = np.random.default_rng(7)
    data = _rle_between_text(rng, 150_000)
    blobs = []
    for bits, n in ((12, 64), (15, 32)):
        blob = pmt.mt_encode_py(data, bits, n, psh.device_plan(data, bits, n, 16 << 10))
        blobs.append((blob, n))
        blobs += [(blob[:cut], n) for cut in (0, 15, 16, 600, len(blob) // 2, len(blob) - 1)]
        for _ in range(30):
            b = bytearray(blob)
            b[int(rng.integers(0, min(len(b), 3000)))] ^= int(rng.integers(1, 256))
            blobs.append((bytes(b), n))
    for blob, n in blobs:
        got, want = pmt.block_index(blob, n), jmt.block_index(blob, n)
        assert _index_rows(got) == _index_rows(want)
        if got is not None:
            for kernel_blocks in (lambda bl: [b for b in bl if not b.is_single][:-1], lambda bl: list(bl)):
                pk, jk = kernel_blocks(got[2]), kernel_blocks(want[2])
                assert pdec.block_word_counts(got[2], pk, got[1], n) == jdec.block_word_counts(want[2], jk, want[1], n)


def test_encode_groups_and_decode_groups_equal_original():
    rng = np.random.default_rng(11)
    for bits, n in ((10, 64), (12, 32), (15, 64)):
        data = text_like(rng, 5000)
        hist = make_tile_hist(data, bits)
        jhist = j_complete_hist(hist.symbol_count, bits)
        groups, valid = pmt._lane_groups(data, 0, data.size, data.size, n)
        jgroups, jvalid = jmt._lane_groups(data, 0, data.size, data.size, n)
        assert np.array_equal(groups, jgroups) and np.array_equal(valid, jvalid)
        init = rng.integers(1 << 16, 1 << 31, n, dtype=np.int64).astype(np.uint32)
        got = pref.encode_groups(init.copy(), groups, valid, hist)
        want = jref.encode_groups(init.copy(), groups, valid, jhist)
        for g, w in zip(got, want):
            assert np.array_equal(g, w)
        words, emits, states = got
        stream = np.concatenate([words[emits], np.zeros(2 * n, np.uint16)])
        full = (data.size - n + 1 + n - 1) // n
        got = pref.decode_full_groups(states.copy(), stream, 0, hist, n, full)
        want = jref.decode_full_groups(states.copy(), stream, 0, jhist, n, full)
        assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1]) and got[2] == want[2]
        tail = pref.decode_tail_group(got[1], stream, got[2], hist, n, full * n, data.size)
        jtail = jref.decode_tail_group(want[1], stream, want[2], jhist, n, full * n, data.size)
        assert np.array_equal(tail[0], jtail[0]) and np.array_equal(tail[1], jtail[1]) and tail[2] == jtail[2]


# ------------------------------------------------------- the kernel's plain version


def _operands(blob: bytes, bits: int, n: int):
    length, stream, blocks, w_counts = pdec.index_blocks(blob, n)
    index, states, fc = pdec.block_operands(length, stream, blocks, w_counts, bits, n)
    coded = [b for b in blocks if not b.is_single]
    return length, stream, coded, index, pdec.device_operands(stream, index, states, fc, n, torch.device("cpu"))


@pytest.mark.parametrize("bits,n", [(10, 64), (12, 32), (13, 64), (15, 32)])
def test_decode_blocks_plain_equals_decode_full_groups(bits, n):
    """Block by block: the plain version's bytes, final states and cursors
    equal `decode_full_groups` from each block's header states."""
    rng = np.random.default_rng(bits)
    data = _rle_between_text(rng, 120_000)
    blob = pmt.mt_encode_py(data, bits, n, psh.device_plan(data, bits, n, 8 << 10))
    length, stream, coded, index, args = _operands(blob, bits, n)
    out, fin, cursor = pdec.decode_blocks_plain(*args, bits=bits, n=n, length=length)
    out = out.numpy()
    fin = fin.numpy().view(np.uint32)
    assert len(coded) > 4
    for i, b in enumerate(coded):
        word_start, _, out_start, out_limit, num_groups = (int(v) for v in index[i])
        syms, states, r = jref.decode_full_groups(
            b.states.copy(), stream, b.word_start, j_complete_hist(b.freq, bits), n, num_groups
        )
        want = syms[:, jrans.INV_IDX2IDX[n]].reshape(-1)[: out_limit - out_start]
        assert np.array_equal(out[out_start : out_start + want.size], want), i
        assert np.array_equal(fin[i], states), i
        assert int(cursor[i]) == r - word_start, i


def test_decode_blocks_dispatch_and_empty():
    """decode_blocks takes the plain version for CPU operands; a blob of
    single-symbol blocks only has no coded block to decode."""
    data = np.full(300_000, 42, np.uint8)
    blob = pmt.mt_encode_py(data, 12, 64)
    assert all(b.is_single for b in pmt.block_index(blob, 64)[2])
    assert mt_decode_torch(blob, 12, 64, device="cpu") == data.tobytes()
    z = torch.zeros(0, dtype=torch.uint8)
    out, fin, cursor = pdec.decode_blocks(
        z, torch.zeros((0, 5), dtype=torch.int64), torch.zeros((0, 64), dtype=torch.int32),
        torch.zeros((0, 256), dtype=torch.int32), bits=12, n=64, length=10,
    )
    assert out.shape == (10,) and not out.any() and fin.shape == (0, 64) and cursor.shape == (0,)


# ------------------------------------------------------------- mt_decode_torch


@pytest.mark.parametrize("path", _golden_blobs(), ids=lambda p: p.stem)
def test_decode_golden_blobs(path):
    """The C++ reference's own blobs decode to their input, as mt_decode_py decodes them."""
    data, bits, n = _golden_case(path)
    blob = path.read_bytes()
    got = mt_decode_torch(blob, bits, n, device="cpu")
    assert got == data.tobytes()
    assert got == jmt.mt_decode_py(blob, bits, n)


def _case_input(kind: str, rng) -> np.ndarray:
    if kind == "odd-tail":
        return text_like(rng, 64 * 1100 + 17)
    if kind == "planner":
        return np.fromfile(CORPUS, np.uint8)[200_000:350_000]
    if kind == "rle":
        return _rle_between_text(rng, 150_000)
    if kind == "device-plan":
        return np.fromfile(XRAY, np.uint8)[:70_000]
    return text_like(rng, 70_000)


def _case_plan(kind: str, data: np.ndarray, bits: int, n: int):
    if kind in ("uniform", "odd-tail"):
        return psh.uniform_plan(data, bits, n, 4096)
    if kind == "device-plan":
        return psh.device_plan(data, bits, n, 8 << 10)
    return None  # the reference planner


@pytest.mark.parametrize("n", (32, 64))
@pytest.mark.parametrize("kind", ("uniform", "odd-tail", "rle", "planner", "device-plan"))
@pytest.mark.parametrize("bits", range(10, 16))
def test_decode_equals_input_and_oracle(bits, kind, n):
    data = _case_input(kind, np.random.default_rng(bits * 7 + n))
    blob = pmt.mt_encode_py(data, bits, n, _case_plan(kind, data, bits, n))
    got = mt_decode_torch(blob, bits, n, device="cpu")
    assert got == data.tobytes()
    assert got == jmt.mt_decode_py(blob, bits, n)


# one small blob per routing class of the JAX dispatcher (mt64_decode_tpu):
# an odd number of same-size kernel blocks at n=64 B<=12 pairs into #5 and
# leaves one for #4; B=13..15 pairs go to #8 (n=64, and n=32 per half);
# n=32 B<=12 quads go to #9
ROUTES = {
    "#4+#5 n64 B12": (12, 64, 15 * 4096 + 300),
    "#8 n64 B15": (15, 64, 9 * 4096 + 100),
    "#8 n32 B14": (14, 32, 9 * 4096 + 100),
    "#9 n32 B12": (12, 32, 9 * 4096 + 100),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_decode_equals_pallas_interpret(route):
    bits, n, size = ROUTES[route]
    data = text_like(np.random.default_rng(size), size)
    blob = jmt.mt_encode_py(data, bits, n, jsh.uniform_plan(data, bits, n, 4096))
    want = jdec.mt64_decode_tpu(blob, bits, interpret=True, n=n)
    assert want == data.tobytes()
    assert mt_decode_torch(blob, bits, n, device="cpu") == want


def _malformed(blob: bytes, n: int, rng) -> list[tuple[str, bytes]]:
    """Truncations, a bad freq sum, a word count driven negative, and flips
    of header, state and word bytes."""
    length, _, blocks = pmt.block_index(blob, n)
    coded = [b for b in blocks if not b.is_single]
    cases = [(f"cut{cut}", blob[:cut]) for cut in (0, 15, 16, 200, len(blob) // 2, len(blob) - 1)]
    for k in (0, len(coded) - 1):  # a kernel block and the last block
        b = bytearray(blob)
        at = 16 + 2 * (coded[k].word_start - 256)  # first freq entry
        b[at] ^= 1
        cases.append((f"freq{k}", bytes(b)))
    b = bytearray(blob)  # offset of block 0 pointing into its own freqs
    off_at = 16 + 2 * (coded[0].word_start - 256 - 2 * n - 4)
    b[off_at : off_at + 8] = (2 * n + 100).to_bytes(8, "little")
    cases.append(("offset", bytes(b)))
    for name, lo, hi in (("size", 16, 24), ("state", 32, 32 + 4 * n), ("words", len(blob) // 2, len(blob))):
        for _ in range(3):
            b = bytearray(blob)
            b[int(rng.integers(lo, hi))] ^= int(rng.integers(1, 256))
            cases.append((name, bytes(b)))
    return cases


@pytest.mark.parametrize("bits,n", [(12, 64), (14, 32)])
def test_malformed_none_where_pallas_none(bits, n):
    """None wherever mt64_decode_tpu gives None, else bytes of the right length."""
    rng = np.random.default_rng(bits)
    data = text_like(rng, 9 * 4096 + 50)
    blob = jmt.mt_encode_py(data, bits, n, jsh.uniform_plan(data, bits, n, 4096))
    seen = set()
    for name, bad in _malformed(blob, n, rng):
        want = jdec.mt64_decode_tpu(bad, bits, interpret=True, n=n)
        got = mt_decode_torch(bad, bits, n, device="cpu")
        assert (got is None) == (want is None), name
        if got is not None:
            assert len(got) == len(want), name
        seen.add((name[:3], got is None))
    assert ("off", True) in seen and ("fre", True) in seen  # the negative count and the bad sum
    for bad_bits, bad_n in ((16, n), (bits, 16)):
        assert mt_decode_torch(blob, bad_bits, bad_n, device="cpu") is None
        assert jdec.mt64_decode_tpu(blob, bad_bits, interpret=True, n=bad_n) is None


def test_layers_and_array_input():
    """`layers=` adds each layer's seconds and changes no byte; bytes and
    uint8 arrays decode alike, one whose word region sits at an odd
    address through one aligned copy of that region."""
    data = text_like(np.random.default_rng(2), 50_000)
    blob = pmt.mt_encode_py(data, 12, 64)
    layers = {}
    assert mt_decode_torch(blob, 12, 64, device="cpu", layers=layers) == data.tobytes()
    assert set(layers) == {"host_index", "h2d", "kernel", "d2h", "host_assemble"}
    assert all(v >= 0 for v in layers.values())
    assert mt_decode_torch(np.frombuffer(blob, np.uint8), 12, 64, device="cpu") == data.tobytes()
    odd = np.empty(len(blob) + 1, np.uint8)[1:]
    odd[:] = np.frombuffer(blob, np.uint8)
    copied = pn.MT_INDEX_COUNTS["copied"]
    assert mt_decode_torch(odd, 12, 64, device="cpu") == data.tobytes()
    assert odd.ctypes.data % 2 and pn.MT_INDEX_COUNTS["copied"] == copied + 1
    assert mt_decode_torch(pmt.mt_encode_py(b"", 12, 64), 12, 64, device="cpu") == b""


def test_tail_is_the_last_blocks_chain():
    """A uniform plan with an odd tail (size = 17 mod 64): the last block's
    partial group is decoded on the host from the kernel's final states."""
    data = text_like(np.random.default_rng(9), 4096 * 5 + 64 * 3 + 17)
    for n in (32, 64):
        blob = pmt.mt_encode_py(data, 12, n, psh.uniform_plan(data, 12, n, 4096))
        length, _, coded, index, _ = _operands(blob, 12, n)
        tail_from = int(index[-1, 2] + index[-1, 4] * n)
        assert 0 < length - tail_from < n
        assert mt_decode_torch(blob, 12, n, device="cpu") == data.tobytes()


def test_corrupted_payload_reads_word_0_past_a_block_as_the_pallas_decoder_does():
    """A deliberate difference, pinned on its recorded input: a flipped bit
    sends block 2's chain past its words.  The port reads word 0 there, as
    `mt64_decode_tpu` does (the kernels' zero-filled windows rely on it, and
    `mt_decode_device` returns step (a)'s bytes before any host decode);
    the numpy authority reads on into block 3's header, so the two first
    differ at byte 12267."""
    data = text_like(np.random.default_rng(114), 5 * 4096 + 77)
    blob = bytearray(jmt.mt_encode_py(data, 14, 32, jsh.uniform_plan(data, 14, 32, 4096)))
    blob[7036] ^= 1 << 2
    blob = bytes(blob)
    got = mt_decode_torch(blob, 14, 32, device="cpu")
    assert got == jdec.mt64_decode_tpu(blob, 14, interpret=True, n=32)
    oracle = jmt.mt_decode_py(blob, 14, 32)
    assert pmt.mt_decode_py(blob, 14, 32) == oracle
    diff = np.nonzero(np.frombuffer(got, np.uint8) != np.frombuffer(oracle, np.uint8))[0]
    assert diff[0] == 12267
    assert psh.mt_decode_device(blob, 14, 32, device="cpu") == got


@pytest.mark.parametrize("bits", (10, 14))
@pytest.mark.parametrize("n", (16, 32, 64))
def test_mt_decode_py_equals_original(bits, n):
    """The port's copy of the sequential decoder == the JAX package's, on
    valid blobs and on truncations and flips (None outcomes and errors
    included)."""
    rng = np.random.default_rng(bits + n)
    data = np.concatenate([text_like(rng, 6000), np.full(900, 5, np.uint8), text_like(rng, 1234)])
    blob = jmt.mt_encode_py(data, bits, n)
    cases = [blob, blob[:len(blob) // 2], blob[:15]]
    for pos in rng.integers(0, len(blob), 8).tolist():
        b = bytearray(blob)
        b[pos] ^= 0x10
        cases.append(bytes(b))
    def outcome(fn, b):  # a corrupted chain can index past the stream: both raise alike
        try:
            return fn(b, bits, n)
        except IndexError as e:
            return type(e)

    for b in cases:
        assert outcome(pmt.mt_decode_py, b) == outcome(jmt.mt_decode_py, b)
    assert pmt.mt_decode_py(blob, bits, n) == data.tobytes()
