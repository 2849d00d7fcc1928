"""The port's XLA scan codecs (`hsrans_tpu_torch.ops.raw_scan`, the plain
tier of `kernels/scan.py`) against the JAX package's `ops/raw_jax.py`, its
numpy raw wire and the C++ reference's golden blobs, and the port's copies
of `make_dec3` and of the raw wire against their originals.  Exact
equality throughout; inputs are made from numpy seeds."""

import numpy as np
import pytest
import torch

import hsrans_tpu.ops.reference as ref
from hsrans_tpu.models.histogram import make_hist
from hsrans_tpu.models.tables import make_dec3 as jax_make_dec3
from hsrans_tpu.ops import raw_jax
from hsrans_tpu_torch import raw_decode_torch, raw_encode_torch
from hsrans_tpu_torch.kernels import scan
from hsrans_tpu_torch.models.histogram import complete_hist
from hsrans_tpu_torch.models.tables import make_dec3
from hsrans_tpu_torch.ops import raw_scan
from hsrans_tpu_torch.ops import reference as port_ref

from .conftest import fnv1a, read_meta

LANES = (16, 32, 64)
DEPTHS = (10, 12, 15)
STEPS = 24  # one num_steps for every decode case: XLA compiles once a shape


def _hist_freqs(rng, bits: int, rows: int) -> np.ndarray:
    """rows normalized histograms of skewed random data, uint16 [rows, 256]."""
    out = []
    for _ in range(rows):
        data = np.minimum(rng.geometric(rng.uniform(0.02, 0.3), 3000) - 1, 255).astype(np.uint8)
        out.append(make_hist(data, bits).symbol_count)
    return np.stack(out)


def _dec3_rows(freqs: np.ndarray, bits: int) -> tuple[np.ndarray, ...]:
    tabs = [make_dec3(complete_hist(f, bits)) for f in freqs]
    return tuple(np.stack([t[k] for t in tabs]).astype(dt) for k, dt in (("sym", np.uint8), ("freq", np.uint16),
                                                                         ("cumul", np.uint16)))


def _decode_operands(rng, nb: int, n: int, bits: int, w: int):
    """Random states and words, per-stream tables of real histograms, read
    positions that start below 0, inside and past the stream, valid counts
    that end at every step."""
    states = rng.integers(0, 1 << 32, (nb, n), dtype=np.uint64).astype(np.uint32)
    states[: nb // 2] = rng.integers(1 << 15, 1 << 31, (nb // 2, n), dtype=np.uint32)
    stream = rng.integers(0, 1 << 16, (nb, w), dtype=np.uint32).astype(np.uint16)
    read_pos = rng.integers(-w - 3, w + 3, nb).astype(np.int32)
    read_pos[0] = 0
    valid = rng.integers(0, STEPS * n + 2, nb).astype(np.int32)
    return states, stream, read_pos, *_dec3_rows(_hist_freqs(rng, bits, nb), bits), valid


def _same(jax_out, port_out) -> None:
    for j, p in zip(jax_out, port_out):
        j = np.asarray(j)
        p = p.numpy()
        assert p.shape == j.shape
        assert np.array_equal(p.view(j.dtype) if p.dtype.itemsize == j.dtype.itemsize else p, j)


@pytest.mark.parametrize("bits", DEPTHS)
@pytest.mark.parametrize("n", LANES)
def test_decode_section_batched_per_stream(n, bits):
    """Batched, per-stream stream and tables, tail on: the stream is short,
    so reads run past W (0xFFFF) and below 0 (wrapped)."""
    ops = _decode_operands(np.random.default_rng(100 * n + bits), 5, n, bits, 40)
    kw = dict(bits=bits, num_steps=STEPS, tail=True)
    _same(raw_jax.decode_section(*ops, **kw), raw_scan.decode_section(*ops, **kw))


@pytest.mark.parametrize("n", LANES)
def test_decode_section_shared_stream_and_tables(n):
    """Batched over a shared stream and shared tables, tail off, at B=12;
    and the tables shared while the stream is per-stream."""
    rng = np.random.default_rng(7 + n)
    states, stream, read_pos, sym, freq, cumul, valid = _decode_operands(rng, 4, n, 12, 300)
    kw = dict(bits=12, num_steps=STEPS, tail=False)
    shared = (states, stream[0], read_pos, sym[1], freq[1], cumul[1], valid)
    _same(raw_jax.decode_section(*shared, **kw), raw_scan.decode_section(*shared, **kw))
    mixed = (states, stream, read_pos, sym[2], freq[2], cumul[2], valid)
    _same(raw_jax.decode_section(*mixed, **kw), raw_scan.decode_section(*mixed, **kw))


@pytest.mark.parametrize("n", LANES)
def test_decode_section_unbatched(n):
    """One stream with no batch axis, tail on with a scalar valid count."""
    states, stream, read_pos, sym, freq, cumul, _ = _decode_operands(np.random.default_rng(n), 2, n, 15, 64)
    ops = (states[0], stream[0], np.int32(3), sym[0], freq[0], cumul[0], np.int32(STEPS * n - 5))
    kw = dict(bits=15, num_steps=STEPS, tail=True)
    _same(raw_jax.decode_section(*ops, **kw), raw_scan.decode_section(*ops, **kw))


def test_decode_section_entry_tables():
    """`__graft_entry__.entry`'s shapes and random tables (B=8, n=64,
    bits=12, 32 steps; freq 1 and cumul 0, no rANS tables): u32 wrap."""
    nb, n, bits, steps = 8, 64, 12, 32
    rng = np.random.default_rng(0)
    states = rng.integers(1 << 15, 1 << 31, (nb, n), dtype=np.uint32)
    stream = rng.integers(0, 1 << 16, (nb, 4096), dtype=np.uint32).astype(np.uint16)
    read_pos = np.zeros((nb,), np.int32)
    sym = rng.integers(0, 256, (nb, 1 << bits), dtype=np.int64).astype(np.uint8)
    freq = np.ones((nb, 1 << bits), np.uint16)
    cumul = np.zeros((nb, 1 << bits), np.uint16)
    sizes = np.full((nb,), steps * n, np.int32)
    ops = (states, stream, read_pos, sym, freq, cumul, sizes)
    kw = dict(bits=bits, num_steps=steps, tail=True)
    _same(raw_jax.decode_section(*ops, **kw), raw_scan.decode_section(*ops, **kw))


def _encode_operands(rng, nb: int, n: int, bits: int, steps: int):
    states = rng.integers(0, 1 << 32, (nb, n), dtype=np.uint64).astype(np.uint32)
    group_bytes = rng.integers(0, 256, (nb, steps, n)).astype(np.uint8)
    valid = rng.random((nb, steps, n)) < 0.9
    freq = _hist_freqs(rng, bits, nb)  # zero freqs among them: max(freq, 1)
    cumul = (np.cumsum(freq, axis=1, dtype=np.uint64) - freq).astype(np.uint16)
    return states, group_bytes, valid, freq, cumul


@pytest.mark.parametrize("bits", DEPTHS)
@pytest.mark.parametrize("n", LANES)
def test_encode_section_batched_per_stream(n, bits):
    ops = _encode_operands(np.random.default_rng(200 * n + bits), 3, n, bits, 20)
    kw = dict(bits=bits, num_steps=20)
    _same(raw_jax.encode_section(*ops, **kw), raw_scan.encode_section(*ops, **kw))


@pytest.mark.parametrize("n", LANES)
def test_encode_section_shared_and_unbatched(n):
    states, gb, valid, freq, cumul = _encode_operands(np.random.default_rng(300 + n), 3, n, 12, 20)
    kw = dict(bits=12, num_steps=20)
    shared = (states, gb, valid, freq[0], cumul[0])
    _same(raw_jax.encode_section(*shared, **kw), raw_scan.encode_section(*shared, **kw))
    one = (states[1], gb[1], valid[1], freq[1], cumul[1])
    _same(raw_jax.encode_section(*one, **kw), raw_scan.encode_section(*one, **kw))


def test_plain_versions_take_torch_tensors():
    """The kernel-level plain versions on torch tensors (u32 as int32 bits)
    equal the tensor API on numpy arrays."""
    states, stream, read_pos, sym, freq, cumul, valid = _decode_operands(np.random.default_rng(9), 3, 32, 12, 50)
    want = raw_scan.decode_section(states, stream, read_pos, sym, freq, cumul, valid, bits=12, num_steps=8, tail=True)
    got = scan.decode_section_plain(
        torch.from_numpy(states.view(np.int32)), torch.from_numpy(stream.view(np.int16)), torch.from_numpy(read_pos),
        torch.from_numpy(sym), torch.from_numpy(freq.view(np.int16)), torch.from_numpy(cumul.view(np.int16)),
        torch.from_numpy(valid), bits=12, num_steps=8, tail=True,
    )
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1].view(torch.int32))
    assert torch.equal(got[2], want[2])


@pytest.mark.parametrize("bits", DEPTHS)
def test_make_dec3_equals_original(bits):
    from hsrans_tpu.models.histogram import complete_hist as jax_complete_hist

    for f in _hist_freqs(np.random.default_rng(bits), bits, 3):
        want = jax_make_dec3(jax_complete_hist(f, bits))
        got = make_dec3(complete_hist(f, bits))
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k])


@pytest.mark.parametrize("n", LANES)
def test_raw_wire_copies_equal_originals(n):
    """raw_capacity, _group_layout, _gather_group_bytes, raw_encode_16w,
    raw_decode_16w and _decode_section_16w of the port == the JAX package's."""
    rng = np.random.default_rng(n)
    for length in (0, 1, n - 1, n, n + 1, 777, 5000):
        data = np.minimum(rng.geometric(0.08, length) - 1, 255).astype(np.uint8)
        assert port_ref.raw_capacity(length, n) == ref.raw_capacity(length, n)
        assert port_ref._group_layout(length, n) == ref._group_layout(length, n)
        for a, b in zip(port_ref._gather_group_bytes(data, length, n), ref._gather_group_bytes(data, length, n)):
            assert np.array_equal(a, b)
        hist = make_hist(data if length else np.zeros(1, np.uint8), 12)
        blob = ref.raw_encode_16w(data, hist, n)
        assert port_ref.raw_encode_16w(data, hist, n) == blob
        assert port_ref.raw_decode_16w(blob, 12, n) == ref.raw_decode_16w(blob, 12, n) == data.tobytes()
        if length:
            states = np.frombuffer(blob[528 : 528 + 4 * n], "<u4").astype(np.uint32)
            stream = np.zeros((len(blob) - 528 - 4 * n) // 2 + 2 * n, np.uint16)
            stream[: (len(blob) - 528 - 4 * n) // 2] = np.frombuffer(blob[528 + 4 * n :], "<u2")
            h = complete_hist(hist.symbol_count, 12)
            got, (st, r) = port_ref._decode_section_16w(states, stream, 0, length, 0, h, n)
            want, (st2, r2) = ref._decode_section_16w(states, stream, 0, length, 0, hist, n)
            assert np.array_equal(got, want) and np.array_equal(st, st2) and r == r2


def test_raw_wire_copies_equal_golden(golden_dir, golden_inputs):
    """The port's numpy raw wire == the C++ reference's blobs, every
    lane count and depth of the small golden inputs."""
    for name in ("tiny_130", "uniform_8k"):
        data = golden_inputs[name]
        for n in LANES:
            for bits in range(10, 16):
                path = golden_dir / f"{name}.raw{n}_{bits}.bin"
                blob = port_ref.raw_encode_16w(data, make_hist(data, bits), n)
                assert blob == path.read_bytes()
                assert port_ref.raw_decode_16w(blob, bits, n) == data.tobytes()


@pytest.mark.parametrize("n", LANES)
@pytest.mark.parametrize("bits", DEPTHS)
def test_raw_encode_torch_equals_jax_and_oracle(n, bits):
    rng = np.random.default_rng(11)
    for length in (1, n - 1, n, 1000, 3001):
        data = np.minimum(rng.geometric(0.1, size=length) - 1, 255).astype(np.uint8)
        hist = make_hist(data, bits)
        blob = raw_encode_torch(data, hist, n, device="cpu")
        assert blob == raw_jax.raw_encode_jax(data, hist, n) == ref.raw_encode_16w(data, hist, n)
        assert raw_decode_torch(blob, bits, n, device="cpu") == data.tobytes()
    assert raw_encode_torch(b"", make_hist(np.zeros(1, np.uint8), bits), n, device="cpu") == raw_jax.raw_encode_jax(
        b"", make_hist(np.zeros(1, np.uint8), bits), n)


@pytest.mark.parametrize(("n", "bits"), ((64, 12), (32, 12), (16, 14)))
def test_raw_torch_golden_parity(golden_dir, golden_inputs, n, bits):
    """raw_encode_torch is bit-identical to the C++ reference on text_63k,
    and raw_decode_torch returns the reference's own blob's input."""
    data = golden_inputs["text_63k"]
    size, ref_hash = read_meta(golden_dir / f"text_63k.raw{n}_{bits}.meta")
    blob = raw_encode_torch(data, make_hist(data, bits), n, device="cpu")
    assert len(blob) == size and fnv1a(blob) == ref_hash
    assert raw_decode_torch((golden_dir / f"text_63k.raw{n}_{bits}.bin").read_bytes(), bits, n, device="cpu") == (
        data.tobytes()
    )


@pytest.mark.parametrize("n", LANES)
def test_raw_decode_torch_malformed_equals_jax(golden_dir, golden_inputs, n):
    """On truncations and bit flips of a golden blob, raw_decode_torch gives
    raw_decode_jax's outcome, None or bytes, byte for byte: an odd last
    byte dropped, short streams read as 0 then 0xFFFF past their end, bad
    histograms and short headers None."""
    blob = (golden_dir / f"uniform_8k.raw{n}_12.bin").read_bytes()
    rng = np.random.default_rng(40 + n)
    cases = [blob[:cut] for cut in (0, 527, 528 + 4 * n - 1, 528 + 4 * n, len(blob) // 2, len(blob) // 2 + 1,
                                    len(blob) - 1)]
    for cut in (len(blob) // 3, len(blob) // 2 + 1, len(blob) - 7):  # cut, the header's size patched to match
        b = bytearray(blob[:cut])
        b[8:16] = cut.to_bytes(8, "little")
        cases.append(bytes(b))
    for pos in (0, 9, 16, 17, 300, *rng.integers(528, len(blob), 5).tolist()):
        b = bytearray(blob)
        b[pos] ^= 1 << int(rng.integers(0, 8)) if pos >= 9 else 0x01
        cases.append(bytes(b))
    outcomes = set()
    for b in cases:
        want = raw_jax.raw_decode_jax(b, 12, n)
        got = raw_decode_torch(b, 12, n, device="cpu")
        assert got == want
        outcomes.add(got is None)
    assert outcomes == {True, False}
