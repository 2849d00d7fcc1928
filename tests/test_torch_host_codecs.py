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

from .conftest import fnv1a, read_meta

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


@pytest.mark.parametrize("word_bits", (16, 8))
def test_blk32_malformed_equals_original(word_bits):
    """Short blobs, truncations and byte flips: the port's numpy decoder
    gives what the JAX package's gives, None or the same bytes, and so does
    its native decoder on the short and truncated blobs.  On a flipped
    payload the native decoder (both packages' build of one source) reads
    the renormalization slack it leaves uninitialized on purpose
    (native/hsrans_codec.cpp::hsr_blk32_decode), so its bytes there depend
    on the heap, not on the blob: only the outcome and its length are held."""
    for short in (b"\0" * 10, b"\0" * 2000):
        assert pb.blk32_decode(short, 12, word_bits) is None is jb.blk32_decode(short, 12, word_bits)
        assert pb.blk32_decode_host(short, 12, word_bits) == jb.blk32_decode_host(short, 12, word_bits)
    data = text_like(np.random.default_rng(21), 40_000)
    blob = pb.blk32_encode(data, ph.make_hist(data, 12), word_bits)
    variants = _malformed()(blob, 34 + word_bits)
    for i, b in enumerate(variants):
        assert pb.blk32_decode(b, 12, word_bits) == jb.blk32_decode(b, 12, word_bits)
        got, want = pb.blk32_decode_host(b, 12, word_bits), jn.blk32_decode(b, 12, word_bits)
        if i < 11:  # the truncations
            assert got == want
        assert (got is None) == (want is None) and (got is None or len(got) == len(want))


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
    cases = {"corpus": _corpus(600_000, 3 << 20), "text": text_like(rng, 150_001), "empty": np.zeros(0, np.uint8)}
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
