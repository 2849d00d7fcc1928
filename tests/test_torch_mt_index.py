"""mt decode's native index (`runtime/native.py::mt_index`, the C++
`hsr_mt_index`) against its oracle, `kernels/mt_decode.py::index_blocks` +
`block_operands`: the same rows array for array, and a refusal exactly where
the pair gives None; and the route `mt_decode_torch` takes to it, counted in
`MT_INDEX_COUNTS`.  Exact equality throughout."""

from functools import cache

import numpy as np
import pytest

from hsrans_tpu_torch import mt_decode_torch
from hsrans_tpu_torch.kernels import mt_decode as pdec
from hsrans_tpu_torch.ops import mt as pmt
from hsrans_tpu_torch.ops.planner import MIN_BLOCK_BITS_MT
from hsrans_tpu_torch.parallel import sharded as psh
from hsrans_tpu_torch.runtime import native
from tools.gen_inputs import text_like

from .test_torch_mt_decode import _golden_blobs, _golden_case, _malformed


def oracle(blob, bits: int, n: int):
    """(length, index, states, fc, single table, last block single) from
    index_blocks + block_operands; None where either gives None."""
    indexed = pdec.index_blocks(blob, n)
    if indexed is None:
        return None
    length, stream, blocks, w_counts = indexed
    ops = pdec.block_operands(length, stream, blocks, w_counts, bits, n)
    if ops is None:
        return None
    single = np.array([(b.out_start, b.size, b.symbol) for b in blocks if b.is_single], np.int64).reshape(-1, 3)
    return (length, *ops, single, bool(blocks) and blocks[-1].is_single)


def assert_same(blob, bits: int, n: int):
    """The native index equals the oracle's, dtypes included, and its word
    region is the blob's; returns the index (None where both refuse)."""
    got, want = native.mt_index(blob, bits, n), oracle(blob, bits, n)
    assert (got is None) == (want is None)
    if got is None:
        return None
    fields = (got.length, got.index, got.states, got.fc, got.single, got.last_single)
    for name, g, w in zip(("length", "index", "states", "fc", "single", "last_single"), fields, want):
        assert np.asarray(g).dtype == np.asarray(w).dtype and np.array_equal(g, w), name
    buf = np.frombuffer(blob, np.uint8) if isinstance(blob, bytes) else blob
    assert np.array_equal(got.words, buf[16 : 16 + 2 * ((buf.size - 16) // 2)])
    return got


def singles_blob(sizes, symbols) -> bytes:
    """A blob of single-symbol blocks only, one of each size and symbol."""
    heads = b"".join((s | 1 << 63 | c << 54).to_bytes(8, "little") for s, c in zip(sizes, symbols))
    body = sum(sizes).to_bytes(8, "little") + (16 + len(heads)).to_bytes(8, "little") + heads
    return body


def runs_between_text(rng) -> np.ndarray:
    """Text stretches of 2/3 of the mt planner's chunk and a little more,
    each followed by a run to the next-but-one chunk edge, which the
    planner makes a single-symbol block, then 1,037 bytes of text."""
    chunk = 1 << MIN_BLOCK_BITS_MT[12]
    coded = chunk * 2 // 3 + 64
    parts = []
    for i in range(3):
        parts += [text_like(rng, coded), np.full(2 * chunk - coded, 200 + i, np.uint8)]
    return np.concatenate([*parts, text_like(rng, 1037)])


@cache
def valid_blobs() -> dict[str, tuple[bytes, int, int]]:
    cases = {}
    for path in _golden_blobs():
        _, bits, n = _golden_case(path)
        cases[f"golden-{path.stem}"] = (path.read_bytes(), bits, n)
    rng = np.random.default_rng(25)
    data = text_like(rng, 20_000 + 37)
    for n in (32, 64):
        for bits in range(10, 16):
            cases[f"py-n{n}-b{bits}"] = (pmt.mt_encode_py(data, bits, n), bits, n)
    runs = runs_between_text(rng)
    for bits, n in ((12, 64), (15, 32)):
        cases[f"device-plan-n{n}-b{bits}"] = (pmt.mt_encode_py(runs, bits, n, psh.device_plan(runs, bits, n, 16 << 10)),
                                              bits, n)
    cases["empty"] = (pmt.mt_encode_py(b"", 12, 64), 12, 64)
    cases["singles-only"] = (singles_blob([100, 0, 7, 300, 1, 64, 5, 9, 2, 1000, 3], list(range(11))), 12, 64)
    return cases


@pytest.mark.parametrize("name", [
    *(f"golden-{p.stem}" for p in _golden_blobs()), *(f"py-n{n}-b{b}" for n in (32, 64) for b in range(10, 16)),
    "device-plan-n64-b12", "device-plan-n32-b15", "empty", "singles-only",
])
def test_native_index_equals_oracle(name):
    blob, bits, n = valid_blobs()[name]
    got = assert_same(blob, bits, n)
    assert got is not None
    if name.startswith("device-plan"):
        assert len(got.single) >= 2 and (got.length - int(got.index[-1, 2])) % n  # single rows, an odd tail
    if name == "empty":
        assert got.length == 0 and got.index.shape == (0, 5) and got.single.shape == (0, 3)
    if name == "singles-only":
        assert got.index.shape == (0, 5) and len(got.single) == 11 and got.last_single


def crossed_chain(single_size: int, coded_after: bool) -> bytes:
    """n = 32, B = 12, 1,000 bytes: coded block A (100 bytes, writeHeadOffset
    0, so the next header starts inside A's own states), a single-symbol
    block there, then, with `coded_after`, a last coded block B whose header
    lies in A's states and whose freqs are A's, shifted.  A's word count is
    negative: the oracle refuses that only where a coded block follows."""
    words = np.zeros(361, np.uint16)
    words[0:4] = np.frombuffer((100).to_bytes(8, "little"), np.uint16)  # A: val, offset 0
    words[9:13] = np.frombuffer((single_size | 1 << 63 | 7 << 54).to_bytes(8, "little"), np.uint16)
    words[13:17] = np.frombuffer((2000).to_bytes(8, "little"), np.uint16)  # B's val (read only with coded_after)
    words[72 + 20] = 1 << 12  # A's freqs (words 72..327), all on symbol 20: B's symbol 7
    blob = (1000).to_bytes(8, "little") + (16 + 2 * words.size).to_bytes(8, "little") + words.tobytes()
    assert coded_after == (single_size < 900)
    return blob


def short_last(blob: bytes, n: int) -> bytes:
    """The blob with its last coded block 3 bytes shorter than the length
    left: still the last block (it ends past length - n + 1)."""
    length, _, blocks = pmt.block_index(blob, n)
    last = blocks[-1]
    at = 16 + 2 * (last.word_start - 256 - 2 * n - 8)
    bad = bytearray(blob)
    bad[at : at + 8] = (length - last.out_start - 3).to_bytes(8, "little")
    return bytes(bad)


@pytest.mark.parametrize("case", ("crossed-refused", "crossed-last", "short-last"))
def test_native_index_on_crafted_chains(case):
    """A negative word count refused for a coded block with a coded block
    after it, kept for the last (its words run to the end); a short last
    block decodes up to the length."""
    if case == "short-last":
        blob, n = short_last(valid_blobs()["py-n64-b12"][0], 64), 64
    else:
        blob, n = crossed_chain(50 if case == "crossed-refused" else 900, case == "crossed-refused"), 32
    got = assert_same(blob, 12, n)
    assert (got is None) == (case == "crossed-refused")
    if case == "crossed-last":
        assert got.index.tolist() == [[328, 361, 0, 100, 4]] and got.single.tolist() == [[100, 900, 7]]
    if case == "short-last":
        assert got.index[-1, 3] == got.length and not got.last_single


@cache
def refusal_cases() -> list[tuple[str, bytes, int, int]]:
    """`_malformed`'s cases on two blobs, then blobs cut inside a coded
    header, their total length set to the cut so that the walk reaches it
    (the states or freqs run into the words past the end, read as 0)."""
    cases = []
    for bits, n in ((12, 64), (14, 32)):
        rng = np.random.default_rng(bits)
        data = text_like(rng, 9 * 4096 + 50)
        blob = pmt.mt_encode_py(data, bits, n, psh.uniform_plan(data, bits, n, 4096))
        cases += [(f"n{n}-{name}", bad, bits, n) for name, bad in _malformed(blob, n, rng)]
        coded = [b for b in pmt.block_index(blob, n)[2] if not b.is_single]
        for k, which in ((0, "first"), (len(coded) - 1, "last")):
            start = 16 + 2 * (coded[k].word_start - 256 - 2 * n - 8)  # the block's header
            for name, at in (("val", 4), ("offset", 12), ("states", 16 + 2 * n), ("freq-lo", 16 + 4 * n + 3),
                             ("freq-mid", 16 + 4 * n + 300), ("freq-hi", 16 + 4 * n + 400), ("freq-end", 16 + 4 * n + 511),
                             ("words", 16 + 4 * n + 512)):
                cut = bytearray(blob[: start + at])
                cut[8:16] = len(cut).to_bytes(8, "little")
                cases.append((f"n{n}-cut-{which}-{name}", bytes(cut), bits, n))
    huge = bytearray(cases[0][1])
    huge[0:8] = (1 << 63).to_bytes(8, "little")
    cases.append(("length-past-int64", bytes(huge), 12, 64))
    return cases


@pytest.mark.parametrize("case", range(2 * (18 + 16) + 1))
def test_native_index_refuses_where_oracle_does(case):
    name, blob, bits, n = refusal_cases()[case]
    assert_same(blob, bits, n)


def test_refusal_cases_cover_both_outcomes():
    """The cases above reach both outcomes, cut headers among the accepted."""
    cases = refusal_cases()
    assert len(cases) == 2 * (18 + 16) + 1
    outcomes = {name: native.mt_index(blob, bits, n) is None for name, blob, bits, n in cases}
    assert outcomes["length-past-int64"] and outcomes["n64-offset"] and outcomes["n32-freq0"]
    for n in (32, 64):  # the last block's freqs cut where only zeros follow: past the Python walk's padding too
        assert outcomes[f"n{n}-cut-last-freq-lo"] and not outcomes[f"n{n}-cut-last-freq-mid"]
        assert all(outcomes[f"n{n}-cut-first-{name}"] for name in ("val", "offset", "states", "freq-hi", "words"))


def test_bad_arguments_raise():
    blob = valid_blobs()["py-n64-b12"][0]
    for bits, n in ((16, 64), (12, 16), (-1, 32)):
        with pytest.raises(ValueError):
            native.mt_index(blob, bits, n)


def test_route_counts_in_place_and_copied():
    """A `bytes` blob's word region is read where it lies; one at an odd
    address is copied once, aligned, and decodes to the same bytes."""
    data = text_like(np.random.default_rng(3), 30_000)
    blob = pmt.mt_encode_py(data, 12, 64)
    before = dict(native.MT_INDEX_COUNTS)
    assert mt_decode_torch(blob, 12, 64, device="cpu") == data.tobytes()
    got = native.mt_index(blob, 12, 64)
    assert np.shares_memory(got.words, np.frombuffer(blob, np.uint8))
    odd = np.empty(len(blob) + 1, np.uint8)[1:]
    odd[:] = np.frombuffer(blob, np.uint8)
    assert odd.ctypes.data % 2
    assert mt_decode_torch(odd, 12, 64, device="cpu") == data.tobytes()
    moved = {k: v - before[k] for k, v in native.MT_INDEX_COUNTS.items()}
    assert moved == {"calls": 3, "in_place": 2, "copied": 1, "coded": 3 * len(got.index), "single": 0, "refused": 0}
    assert mt_decode_torch(blob[:100], 12, 64, device="cpu") is None
    assert native.MT_INDEX_COUNTS["refused"] == before["refused"] + 1
