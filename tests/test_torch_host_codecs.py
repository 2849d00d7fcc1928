"""The port's host codecs against the JAX package's and the C++ reference's
golden blobs: the 32blk wire (`ops/blk32.py`), the block wire
(`ops/block.py`), the planner in both modes (`ops/planner.py`), the raw and
mt wires' native forms (`ops/reference.py::raw_encode`, `ops/mt.py::mt_encode`),
and the native loader (`runtime/native.py`) they run on.  Exact equality:
every byte is the wire, and a malformed blob gives the same None or bytes."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from hsrans_tpu import rans as jrans
from hsrans_tpu.models import histogram as jh
from hsrans_tpu.ops import blk32 as jb
from hsrans_tpu.ops import block as jk
from hsrans_tpu.ops import mt as jm
from hsrans_tpu.ops import planner as jplan
from hsrans_tpu.ops import reference as jr
from hsrans_tpu.runtime import native as jn
from hsrans_tpu_torch import rans as prans
from hsrans_tpu_torch.models import histogram as ph
from hsrans_tpu_torch.ops import blk32 as pb
from hsrans_tpu_torch.ops import block as pk
from hsrans_tpu_torch.ops import mt as pm
from hsrans_tpu_torch.ops import planner as pplan
from hsrans_tpu_torch.ops import reference as pr
from hsrans_tpu_torch.runtime import native as pn
from tools.gen_inputs import text_like

from .conftest import fnv1a, read_meta, runs_off_chunks

REPO = Path(__file__).resolve().parent.parent
CORPUS = REPO / "tests" / "corpus" / "corpus.bin"
BLK32_CASES = ("text_63k", "uniform_8k", "tiny_130", "skew_50k")
ADAPTIVE_CASES = ("mixed_2m", "rle_1m", "text_1m", "text_63k", "tiny_130", "skew_50k", "uniform_8k")


def _corpus(size: int, off: int = 0) -> np.ndarray:
    return np.fromfile(CORPUS, np.uint8)[off : off + size]


def _malformed():
    """test_malformed.py's truncations and byte flips of one blob."""
    cuts = (0, 7, 8, 15, 16, 43, 44, 100, 800, 1000, -1)

    def variants(blob, seed, n_flips=40):
        out = [blob[: c if c >= 0 else len(blob) - 1] for c in cuts]
        rng = np.random.default_rng(seed)
        for _ in range(n_flips):
            b = bytearray(blob)
            b[int(rng.integers(0, len(blob)))] ^= int(rng.integers(1, 256))
            out.append(bytes(b))
        for pos in (len(blob) // 2, len(blob) - 3):
            for val in (0x00, 0xFF):
                b = bytearray(blob)
                b[pos] = val
                out.append(bytes(b))
        return out

    return variants


def _plan_rows(plan):
    return [(r.start, r.size, r.is_single, r.symbol, None if r.freq is None else r.freq.tolist()) for r in plan]


def test_constants_and_make_hist_equal_original():
    assert prans.DECODE_CONSUME_POINT_8 == jrans.DECODE_CONSUME_POINT_8
    assert list(prans.HIST_BITS_RANGE) == list(jrans.HIST_BITS_RANGE)
    for bits in range(1, 16):
        assert prans.encode_emit_point_8(bits) == jrans.encode_emit_point_8(bits)
    data = text_like(np.random.default_rng(2), 30_000)
    for arg in (data, data.tobytes()):
        for bits in (10, 12, 15):
            a, b = ph.make_hist(arg, bits), jh.make_hist(arg, bits)
            assert np.array_equal(a.symbol_count, b.symbol_count) and np.array_equal(a.cumul, b.cumul)


@pytest.mark.parametrize("bits", (10, 12, 15))
@pytest.mark.parametrize("word_bits,tag", [(16, "32blk16w"), (8, "32blk8w")])
def test_blk32_golden_and_original(golden_dir, golden_inputs, word_bits, tag, bits):
    """numpy and native 32blk blobs equal the reference's and the JAX
    package's; both decoders return the input."""
    for case in BLK32_CASES:
        data = golden_inputs[case]
        size, ref_hash = read_meta(golden_dir / f"{case}.{tag}_{bits}.meta")
        blob = pb.blk32_encode(data, ph.make_hist(data, bits), word_bits)
        assert len(blob) == size and fnv1a(blob) == ref_hash, case
        assert blob == jb.blk32_encode(data, jh.make_hist(data, bits), word_bits), case
        assert pb.blk32_encode_host(data, bits, word_bits) == blob == jb.blk32_encode_host(data, bits, word_bits), case
        assert pb.blk32_decode(blob, bits, word_bits) == data.tobytes() == pb.blk32_decode_host(blob, bits, word_bits)


@pytest.mark.parametrize("word_bits", (16, 8))
def test_blk32_edge_lengths(word_bits):
    rng = np.random.default_rng(5)
    for length in (1, 31, 32, 33, 4096, 65537):
        data = np.minimum(rng.geometric(0.15, size=length) - 1, 255).astype(np.uint8)
        blob = pb.blk32_encode(data, ph.make_hist(data, 12), word_bits)
        assert blob == jb.blk32_encode(data, jh.make_hist(data, 12), word_bits), length
        assert len(blob) <= pb.blk32_capacity(length, word_bits) == jb.blk32_capacity(length, word_bits)
        assert pb.blk32_encode_host(data, 12, word_bits) == blob
        assert pb.blk32_decode(blob, 12, word_bits) == data.tobytes() == pb.blk32_decode_host(blob, 12, word_bits)
    empty = np.zeros(0, np.uint8)
    assert pb.blk32_encode_host(empty, 12, word_bits) == jb.blk32_encode_host(empty, 12, word_bits)


def _decode_host_over_heap(blob: bytes, word_bits: int, fill: int) -> bytes | None:
    """The port's native 32blk decode of `blob` copied into a buffer filled
    with `fill` past its end, right after a `fill`-filled block the size of
    the decoder's lane buffer was freed (so the heap it allocates from is
    likely to hold `fill`)."""
    buf = np.full(len(blob) + 4096, fill, np.uint8)
    buf[: len(blob)] = np.frombuffer(blob, np.uint8)
    junk = np.full(400_000, fill, np.uint8)
    del junk
    return pb.blk32_decode_host(buf[: len(blob)], 12, word_bits)


def _lanes_past_the_blob(blob: bytes) -> bool:
    """The header's 31 lane sizes put lane 31's start past the blob's end
    (the native decoder's refusal, ROADMAP queue 3)."""
    sizes = np.frombuffer(blob[656:780], "<u4").astype(np.int64)
    return 780 + int(sizes.sum()) > len(blob)


@pytest.mark.parametrize("word_bits", (16, 8))
def test_blk32_malformed_equals_original(word_bits):
    """Short blobs, truncations and byte flips: the port's numpy decoder
    gives what the JAX package's gives, None or the same bytes, and the
    port's native decoder gives the numpy decoder's bytes, under a heap
    filled with 0x00 and with 0xFF: its copy of the C++ reads every word
    past a lane's payload as 0, as the numpy decoder's zero-padded lanes
    do, where the original reads slack it leaves uninitialized."""
    for short in (b"\0" * 10, b"\0" * 2000):
        assert pb.blk32_decode(short, 12, word_bits) is None is jb.blk32_decode(short, 12, word_bits)
        assert pb.blk32_decode_host(short, 12, word_bits) == jb.blk32_decode_host(short, 12, word_bits)
    data = text_like(np.random.default_rng(21), 40_000)
    blob = pb.blk32_encode(data, ph.make_hist(data, 12), word_bits)
    variants = _malformed()(blob, 34 + word_bits)
    outcomes = set()
    for i, b in enumerate(variants):
        want = pb.blk32_decode(b, 12, word_bits)
        assert want == jb.blk32_decode(b, 12, word_bits)
        for fill in (0x00, 0xFF):
            assert _decode_host_over_heap(b, word_bits, fill) == want, (i, fill)
        if i < 11:  # the truncations
            assert jn.blk32_decode(b, 12, word_bits) == want
        outcomes.add(None if want is None else want == data.tobytes())
    assert outcomes >= {None, False}  # refusals and bytes that differ from the input


@pytest.mark.parametrize("word_bits", (16, 8))
def test_blk32_corrupted_blob_decodes_to_bytes_of_the_blob_alone(word_bits):
    """300 blobs, each one byte XORed (position, then value, from
    `default_rng(50)`): the port's native decoder gives the numpy decoder's
    bytes under both heap fills.  The one class that differs is recorded in
    ROADMAP queue 3 and held here: lane sizes that run past the blob, which
    the native decoder refuses and the numpy one decodes as zero-padded."""
    data = text_like(np.random.default_rng(21), 40_000)
    blob = pb.blk32_encode(data, ph.make_hist(data, 12), word_bits)
    rng = np.random.default_rng(50)
    refused = differ = 0
    for i in range(300):
        b = bytearray(blob)
        b[int(rng.integers(0, len(blob)))] ^= int(rng.integers(1, 256))
        b = bytes(b)
        want = pb.blk32_decode(b, 12, word_bits)
        for fill in (0x00, 0xFF):
            got = _decode_host_over_heap(b, word_bits, fill)
            if got is None and want is not None and _lanes_past_the_blob(b):
                refused += 1
                continue
            assert got == want, (i, fill)
        differ += want is not None and want != data.tobytes()
    assert refused == 2 and differ > 100


def test_blk32_header_residue_against_numpy():
    """Corrupted 32blk headers where the native decoders (both packages')
    and the numpy ones (both packages') part, ROADMAP queue 3: lane sizes
    past the blob (native None, numpy bytes); a compressed length below the
    blob's (the native decoders read the last lane to the blob's end and
    give the input back, the numpy ones stop it at the header's length);
    an odd lane size on the 16w wire (native None, numpy raises
    ValueError, a fault of the reference's numpy decoder)."""
    data = text_like(np.random.default_rng(21), 40_000)
    for word_bits in (16, 8):
        blob = pb.blk32_encode(data, ph.make_hist(data, 12), word_bits)
        past = bytearray(blob)
        past[779] ^= 0x40  # lane 30's size + 2^30
        assert _lanes_past_the_blob(bytes(past))
        short = bytearray(blob)
        short[8] ^= 6  # the compressed length 2 or 6 bytes short
        for b, native_want, numpy_first_diff in ((past, None, None), (short, data.tobytes(), 39_807)):
            b = bytes(b)
            assert pb.blk32_decode_host(b, 12, word_bits) == jn.blk32_decode(b, 12, word_bits) == native_want
            got = pb.blk32_decode(b, 12, word_bits)
            assert got == jb.blk32_decode(b, 12, word_bits) and len(got) == data.size
            if numpy_first_diff is not None:
                diff = np.nonzero(np.frombuffer(got, np.uint8) != data)[0]
                assert diff[0] == numpy_first_diff
    odd = bytearray(pb.blk32_encode(data, ph.make_hist(data, 12), 16))
    odd[700] ^= 1  # lane 11's size odd
    assert pb.blk32_decode_host(bytes(odd), 12, 16) is None is jn.blk32_decode(bytes(odd), 12, 16)
    for decode in (pb.blk32_decode, jb.blk32_decode):
        with pytest.raises(ValueError):
            decode(bytes(odd), 12, 16)


@pytest.mark.parametrize("tag,n,bits_list", [("block64", 64, (10, 12, 15)), ("block32", 32, (12,))])
def test_block_golden_and_original(golden_dir, golden_inputs, tag, n, bits_list):
    """The native block blobs equal the reference's and the JAX package's
    on every golden input, the numpy encoder's on those under 64 KiB; the
    numpy and native decoders return the input."""
    for case in ADAPTIVE_CASES:
        data = golden_inputs[case]
        for bits in bits_list:
            meta = golden_dir / f"{case}.{tag}_{bits}.meta"
            if not meta.exists():
                continue
            size, ref_hash = read_meta(meta)
            blob = pk.block_encode(data, bits, n)
            assert len(blob) == size and fnv1a(blob) == ref_hash, (case, bits)
            assert blob == jk.block_encode(data, bits, n), (case, bits)
            assert pk.block_decode(blob, bits, n) == data.tobytes(), (case, bits)
            if data.size < 1 << 16:
                assert pk.block_encode_py(data, bits, n) == blob == jk.block_encode_py(data, bits, n), (case, bits)
                assert pk.block_decode_py(blob, bits, n) == data.tobytes(), (case, bits)


@pytest.mark.parametrize("n", (16, 32, 64))
def test_block_round_trip_edges(n):
    """Odd lengths at every width (n = 16 on the numpy codec, as the
    original), the capacity, and an explicit plan."""
    rng = np.random.default_rng(17)
    for length in (0, 1, 63, 64, 65, 100_000):
        data = np.minimum(rng.geometric(0.3, size=length) - 1, 255).astype(np.uint8)
        blob = pk.block_encode(data, 12, n)
        assert blob == jk.block_encode(data, 12, n), length
        assert pk.block_decode(blob, 12, n) == jk.block_decode(blob, 12, n), length
        if length:
            assert pk.block_decode(blob, 12, n) == data.tobytes(), length
        assert len(blob) <= pk.block_capacity(length, n) == jk.block_capacity(length, n)
    plan = pplan.plan_blocks_py(data, 12, "block", n)
    assert pk.block_encode(data, 12, n, plan=plan) == jk.block_encode_py(data, 12, n) == blob


def test_block_malformed_equals_original():
    data = text_like(np.random.default_rng(21), 40_000)
    blob = pk.block_encode(data, 12, 64)
    for short in (b"\0" * 4, b"\0" * 300):
        assert pk.block_decode(short, 12, 64) == jk.block_decode(short, 12, 64)
    for b in _malformed()(blob, 33):
        assert pk.block_decode_py(b, 12, 64) == jk.block_decode_py(b, 12, 64)
        assert pk.block_decode(b, 12, 64) == jn.block_decode(b, 12, 64)


@pytest.mark.parametrize("bits", (10, 12, 15))
@pytest.mark.parametrize("mode,n", [("block", 64), ("block", 32), ("mt", 64), ("mt", 32)])
def test_planner_modes_equal_original(mode, n, bits):
    """Both modes of the Python planner and the native one against the JAX
    package's, freqs included."""
    rng = np.random.default_rng(bits)
    cases = {"corpus": _corpus(600_000, 3 << 20), "text": text_like(rng, 150_001), "empty": np.zeros(0, np.uint8),
             "one-symbol": np.full(150_001, 9, np.uint8), "below-min-block": text_like(rng, 20_000),
             "runs-off-chunks": runs_off_chunks(rng)}
    for name, data in cases.items():
        want = _plan_rows(jplan.plan_blocks_py(data, bits, mode, n))
        assert _plan_rows(pplan.plan_blocks_py(data, bits, mode, n)) == want, name
        assert _plan_rows(pplan.plan_blocks(data, bits, mode, n)) == _plan_rows(jplan.plan_blocks(data, bits, mode, n)) == want, name


def test_planner_native_equals_python_on_golden(golden_inputs):
    data = golden_inputs["mixed_2m"]
    for mode, n in (("block", 64), ("mt", 64), ("block", 32)):
        assert _plan_rows(pplan.plan_blocks(data, 12, mode, n)) == _plan_rows(jplan.plan_blocks(data, 12, mode, n)), mode


@pytest.mark.parametrize("bits", (10, 12, 15))
@pytest.mark.parametrize("n", (16, 32, 64))
def test_native_raw_equals_original(n, bits):
    """The port's native raw wire against the JAX package's native and numpy
    wires and its own numpy copy, sizes 0 to 200,000."""
    for size in (0, 63, 70_001, 200_000):
        d = _corpus(size)
        blob = pr.raw_encode(d, bits, n)
        assert blob == jr.raw_encode(d, bits, n), size
        if size:
            assert blob == pr.raw_encode_16w(d, ph.make_hist(d, bits), n), size
        assert pr.raw_decode(blob, bits, n) == d.tobytes() == jr.raw_decode(blob, bits, n), size
        assert pr.raw_decode_16w(blob, bits, n) == d.tobytes(), size


@pytest.mark.parametrize("bits", (10, 12, 13, 15))
@pytest.mark.parametrize("n", (32, 64))
def test_native_block_and_mt_equal_original(n, bits):
    """The native block and mt wires (200,000 bytes over the corpus's RLE
    run, so single-symbol blocks too) against the JAX package's native and
    numpy wires and the port's numpy copies; the decoders return the input."""
    d = _corpus(200_001, off=3 << 20)
    blob = pk.block_encode(d, bits, n)
    assert blob == jn.block_encode(d, bits, n) == pk.block_encode_py(d, bits, n)
    assert pk.block_decode(blob, bits, n) == d.tobytes() == pk.block_decode_py(blob, bits, n)
    blob = pm.mt_encode(d, bits, n)
    assert blob == jn.mt_encode(d, bits, n) == pm.mt_encode_py(d, bits, n)
    assert pm.mt_decode(blob, bits, n) == d.tobytes() == pm.mt_decode_py(blob, bits, n)
    assert pn.mt_decode(blob, bits, n, threads=1) == d.tobytes()


def test_mt_dispatch_equals_original():
    """n = 16 and empty inputs take the numpy codecs, as the original; a
    plan given takes the numpy encoder; malformed blobs give the JAX
    package's outcome."""
    data = text_like(np.random.default_rng(71), 60_000)
    for n in (16, 32, 64):
        blob = pm.mt_encode(data, 12, n)
        assert blob == jm.mt_encode(data, 12, n)
        assert pm.mt_decode(blob, 12, n) == data.tobytes() == jm.mt_decode(blob, 12, n)
        empty = np.zeros(0, np.uint8)
        assert pm.mt_encode(empty, 12, n) == jm.mt_encode(empty, 12, n)
    plan = pplan.plan_blocks_py(data, 12, "mt", 64)
    assert pm.mt_encode(data, 12, 64, plan=plan) == jm.mt_encode_py(data, 12, 64)
    blob = pm.mt_encode(data[:40_000], 12, 64)
    for b in _malformed()(blob, 32):
        assert pm.mt_decode(b, 12, 64) == jn.mt_decode(b, 12, 64)


def test_native_library_is_built_beside_the_kernels_not_in_native():
    """The loader builds into the CUDA library's directory under a name
    keyed by the sources, the flags and the compiler, never into native/."""
    from hsrans_tpu_torch.runtime import build

    before = sorted(p.name for p in (REPO / "native").iterdir())
    pn.load()
    so = pn.library_path()
    assert so.exists() and so.parent == build.build_dir() and so.name.startswith("libhsrans_native_")
    assert sorted(p.name for p in (REPO / "native").iterdir()) == before
    for flag in ("-O3", "-march=native", "-std=c++20", "-fPIC", "-fno-exceptions", "-fno-rtti"):
        assert flag in (REPO / "native" / "Makefile").read_text() and flag in pn.CXX_FLAGS


# The one change of the port's copy of the C++ host runtime: in
# hsr_blk32_decode, every word past a lane's payload reads as 0 (the scalar
# loop's read clamped; a vector-loop decode that consumed past a lane
# restarts in the scalar loop).  (original text, the copy's text) pairs.
BLK32_HUNKS = (
    ("""  // lane's end stay in-bounds on malformed input.  Deliberately left
  // UNINITIALIZED outside the copied payload (a zero-fill pass measured
  // ~10% of decode); slack reads yield garbage bytes, never UB.  16w keeps
  // u16 words; 8w keeps a tight byte mirror (the vector path's scale-1
  // gather needs 4 real bytes per fetch).
""", """  // lane's end stay in-bounds on malformed input.  The slack is left
  // uninitialized (a zero-fill pass measured ~10% of decode), and no word
  // of it is ever decoded: a read past a lane's payload yields 0, as the
  // numpy decoder's zero-padded lanes do, so a corrupted blob decodes to
  // bytes of the blob alone.  The scalar loop clamps each read; the vector
  // loop reads unbounded, so a lane that consumed past its payload there
  // sends the whole decode through the scalar loop (a valid blob never
  // does).  16w keeps u16 words; 8w keeps a tight byte mirror (the vector
  // path's scale-1 gather needs 4 real bytes per fetch).
"""),
    ("""    for (uint32_t j = 0; j < N32; j++) r[j] = r32[j];
    g0 = full;
  }
""", """    bool past = false;
    for (uint32_t j = 0; j < N32; j++) past |= r32[j] > lane_len[j];
    if (past) {
      memcpy(st, blob + 16 + 512, 4 * N32);  // start over, scalar
    } else {
      for (uint32_t j = 0; j < N32; j++) r[j] = r32[j];
      g0 = full;
    }
  }
"""),
    ("""        const uint64_t at = lane_off[j] + r[j]++;
        s = (s << shift) | (word_bits == 16 ? lanes16[at] : (uint16_t)lanes8[at]);
""", """        const uint64_t k = r[j]++;
        const uint64_t at = lane_off[j] + k;
        const uint32_t w = k >= lane_len[j] ? 0u : word_bits == 16 ? lanes16[at] : (uint32_t)lanes8[at];
        s = (s << shift) | w;
"""),
)


def test_native_builds_from_the_packages_own_sources():
    """The loader compiles only `hsrans_tpu_torch/csrc/host/`, which
    pyproject.toml ships as package data, and names no file outside the
    package in its build command."""
    import tomllib

    src = pn.source_dir()
    assert src.is_relative_to(REPO / "hsrans_tpu_torch") and src.name == "host"
    assert sorted(p.name for p in src.glob("*.cpp")) == sorted(pn._SOURCES)
    shipped = tomllib.loads((REPO / "pyproject.toml").read_text())["tool"]["setuptools"]["package-data"]
    assert "csrc/host/*.cpp" in shipped["hsrans_tpu_torch"]
    pn.load()
    cmd = pn.library_path().with_suffix(".log").read_text().splitlines()[0]
    assert all(str(src / name) in cmd for name in pn._SOURCES) and str(REPO / "native") not in cmd


def _outside_planner(text: str) -> tuple[str, str]:
    """hsrans_native.cpp before the planner's code (its row struct included)
    and from the thread pool on."""
    start = text.index("};\n", text.index("struct SegPlanRow {")) + 3
    return text[:start], text[text.index("// Thread pool (") :]


def _without_mt_index(text: str) -> str:
    """hsrans_codec.cpp less `hsr_mt_index` and the comment above it, the
    copy's own function beside `hsr_mt_decode` (tests/test_torch_mt_index.py
    holds it to its Python oracle)."""
    start = text.index("// The card decoder's operands of an mt blob")
    end = text.index("\n}\n", text.index("int64_t hsr_mt_index(")) + 3
    assert text[end] == "\n"
    return text[:start] + text[end + 1 :]


def test_native_copy_equals_original_but_the_blk32_hunk():
    """`csrc/host/hsrans_native.cpp` is `native/hsrans_native.cpp` outside
    the planner's code, which the copy rewrote over a chunk table with the
    same rows (the planner tests hold them equal), and `hsrans_codec.cpp`
    is the original with `BLK32_HUNKS` applied, each once, and with
    `hsr_mt_index` added after `hsr_mt_decode`: any other drift fails."""
    host = REPO / "hsrans_tpu_torch" / "csrc" / "host"
    copy, original = (host / "hsrans_native.cpp").read_text(), (REPO / "native" / "hsrans_native.cpp").read_text()
    assert _outside_planner(copy) == _outside_planner(original)
    assert "int64_t hsr_plan_blocks(" in copy and "void hsr_hist_spans(" in copy
    text = (REPO / "native" / "hsrans_codec.cpp").read_text()
    for old, new in BLK32_HUNKS:
        assert text.count(old) == 1 and "hsr_blk32_decode" in text[: text.index(old)]
        text = text.replace(old, new)
    codec = (host / "hsrans_codec.cpp").read_text()
    assert codec.index("int64_t hsr_mt_decode(") < codec.index("int64_t hsr_mt_index(")
    assert _without_mt_index(codec) == text
    assert not (host / "micro_decode.cpp").exists()


@pytest.mark.parametrize("bits", (10, 12, 15))
def test_native_hist_bindings_equal_original(bits):
    """`fnv1a`, `observe_hist`, `normalize_hist`, `hist_blocks` (threads 1
    and all, a remainder block and blocks past the data) and
    `codec_call_len` equal the JAX package's bindings of the original."""
    data = text_like(np.random.default_rng(bits), 50_001)
    for chunk in (b"", b"a", data[:1000].tobytes(), data.tobytes()):
        assert pn.fnv1a(chunk) == jn.fnv1a(chunk)
    hist = pn.observe_hist(data)
    assert hist.dtype == np.uint32 and np.array_equal(hist, jn.observe_hist(data))
    assert np.array_equal(pn.observe_hist(data[:0]), jn.observe_hist(data[:0]))
    for h, size in ((hist, data.size), (np.eye(1, 256, 7, dtype=np.uint32)[0] * 5, 5)):
        got, want = pn.normalize_hist(h, size, bits), jn.normalize_hist(h, size, bits)
        assert all(np.array_equal(g, w) and g.dtype == np.uint16 for g, w in zip(got, want))
        assert int(got[0].sum()) == 1 << bits
    for threads in (1, 0):
        got, want = pn.hist_blocks(data, 4096, bits, 15, threads), jn.hist_blocks(data, 4096, bits, 15, threads)
        assert got[0].shape == (15, 256) and all(np.array_equal(g, w) for g, w in zip(got, want))
    blob = pr.raw_encode(data, bits, 32)
    for fn, src, dst in (("hsr_raw_encode", data, np.zeros(data.size * 2, np.uint8)),
                         ("hsr_raw_decode", np.frombuffer(blob, np.uint8), np.zeros(data.size, np.uint8))):
        other = dst.copy()
        got = pn.codec_call_len(fn, src, dst, bits, 32)
        assert got == jn.codec_call_len(fn, src, other, bits, 32) and np.array_equal(dst, other)
    assert got == data.size and np.array_equal(dst, data)


@pytest.mark.parametrize("threads", (1, 8))
def test_hist_spans_equal_make_tile_hist(threads):
    """`hist_spans` gives each span `make_tile_hist`'s freqs: empty spans
    (the 1-symbol histogram), one-byte spans, 512-aligned spans, the whole
    input; spans outside the data, and reversed spans, raise."""
    from hsrans_tpu_torch.ops.tpx import make_tile_hist

    data = text_like(np.random.default_rng(5), 200_003)
    spans = [(0, 0), (7, 7), (data.size, data.size), (0, 1), (99_999, 100_000), (data.size - 1, data.size)]
    spans += [(512 * k, 512 * (k + 3 * k + 1)) for k in range(40)] + [(0, data.size), (1_000, 33_768)]
    for bits in (10, 12, 15):
        got = pn.hist_spans(data, spans, bits, threads)
        assert got.shape == (len(spans), 256) and got.dtype == np.uint16
        for (s, e), freq in zip(spans, got):
            assert np.array_equal(freq, make_tile_hist(data[s:e], bits).symbol_count), (s, e, bits)
    assert pn.hist_spans(data, [], 12, threads).shape == (0, 256)
    for bad in ([(0, data.size + 1)], [(-1, 5)], [(0, 5), (9, 8)]):
        with pytest.raises(ValueError):
            pn.hist_spans(data, bad, 12, threads)


def test_failed_build_raises(tmp_path, monkeypatch):
    """A compiler that fails, or none at all, raises: no numpy fallback."""
    monkeypatch.setenv("HSRANS_TPU_TORCH_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(pn, "_lib", None)
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        pn.load()
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        pk.block_encode(text_like(np.random.default_rng(1), 5000), 12, 64)
    assert not list(tmp_path.glob("*.so"))
    monkeypatch.delenv("CXX")
    monkeypatch.setattr(pn.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        pn.load()


def test_concurrent_loads_link_once(tmp_path):
    """Two processes that load at once into an empty build directory run the
    compiler once (the second waits on the lock and finds the library)."""
    real = pn.library_path()
    pn.load()
    fake = tmp_path / "cxx"
    calls = tmp_path / "calls"
    fake.write_text(
        "#!/bin/sh\n"
        'case "$*" in *-shared*) echo x >> "$CALLS"; sleep 1; for a; do [ "$prev" = -o ] && cp "$REAL" "$a"; '
        'prev="$a"; done ;; *) echo fake ;; esac\n'
    )
    fake.chmod(0o755)
    env = {**os.environ, "CXX": str(fake), "CALLS": str(calls), "REAL": str(real),
           "HSRANS_TPU_TORCH_BUILD_DIR": str(tmp_path / "b")}
    code = "from hsrans_tpu_torch.runtime import native; native.load(); print('ok')"
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    assert calls.read_text().count("x") == 1
