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


@pytest.mark.parametrize("bits", DEPTHS)
@pytest.mark.parametrize("n", LANES)
def test_decode_section_short_tables(n, bits):
    """Tables shorter than 2^bits slots by a length off the 16-byte grid,
    per-stream and shared: a slot at or past the length reads 255 and
    0xFFFF (the slots the kernel stages in shared memory past the table)."""
    states, stream, read_pos, sym, freq, cumul, valid = _decode_operands(np.random.default_rng(500 + n + bits), 4, n,
                                                                         bits, 300)
    states[:2] = np.random.default_rng(bits).integers(1 << 15, 1 << 31, (2, n), dtype=np.uint32)
    kw = dict(bits=bits, num_steps=STEPS, tail=True)
    cut, cut1 = (5 << bits) // 8 + 3, (1 << bits) - 7
    rows = (states, stream, read_pos, sym[:, :cut], freq[:, :cut], cumul[:, :cut], valid)
    _same(raw_jax.decode_section(*rows, **kw), raw_scan.decode_section(*rows, **kw))
    shared = (states, stream[0], read_pos, sym[1, :cut1], freq[1, :cut1], cumul[1, :cut1], valid)
    _same(raw_jax.decode_section(*shared, **kw), raw_scan.decode_section(*shared, **kw))


@pytest.mark.parametrize("n", LANES)
def test_decode_section_wide_tables(n):
    """Tables of 2^16 random slots (above the kernel's shared-memory
    constant: its L1 route), per-stream and shared and cut short, states
    over all of u32."""
    rng = np.random.default_rng(600 + n)
    nb, bits = 3, 16
    states = rng.integers(0, 1 << 32, (nb, n), dtype=np.uint64).astype(np.uint32)
    stream = rng.integers(0, 1 << 16, (nb, 200), dtype=np.uint32).astype(np.uint16)
    read_pos = rng.integers(-50, 150, nb).astype(np.int32)
    sym = rng.integers(0, 256, (nb, 1 << bits)).astype(np.uint8)
    freq, cumul = (rng.integers(0, 1 << 16, (nb, 1 << bits)).astype(np.uint16) for _ in range(2))
    valid = rng.integers(0, STEPS * n + 2, nb).astype(np.int32)
    kw = dict(bits=bits, num_steps=STEPS, tail=True)
    rows = (states, stream, read_pos, sym, freq, cumul, valid)
    _same(raw_jax.decode_section(*rows, **kw), raw_scan.decode_section(*rows, **kw))
    shared = (states, stream, read_pos, sym[0, :-5], freq[0, :-5], cumul[0, :-5], valid)
    _same(raw_jax.decode_section(*shared, **kw), raw_scan.decode_section(*shared, **kw))


@pytest.mark.parametrize("bits", (10, 15, 31))
@pytest.mark.parametrize("n", LANES)
def test_encode_section_wide_divisors(n, bits):
    """Freqs over all of u16 and 0 (max(freq, 1)), cumuls over all of u16,
    states over all of u32 (2^31 - 1, 2^31 and 2^32 - 1 among them): the
    divisions the kernel's magic must take exactly, per-stream and shared."""
    rng = np.random.default_rng(700 + n + bits)
    nb, steps = 3, 20
    states = rng.integers(0, 1 << 32, (nb, n), dtype=np.uint64).astype(np.uint32)
    states[:, :4] = (0, (1 << 31) - 1, 1 << 31, (1 << 32) - 1)
    group_bytes = rng.integers(0, 256, (nb, steps, n)).astype(np.uint8)
    valid = rng.random((nb, steps, n)) < 0.9
    freq = rng.integers(0, 1 << 16, (nb, 256)).astype(np.uint16)
    freq[:, :10] = (0, 1, 2, 3, 255, 0x7FFF, 0x8000, 0x8001, 0xFFFE, 0xFFFF)
    group_bytes[:, :, :10] = np.arange(10, dtype=np.uint8)  # every edge freq coded
    cumul = rng.integers(0, 1 << 16, (nb, 256)).astype(np.uint16)
    kw = dict(bits=bits, num_steps=steps)
    rows = (states, group_bytes, valid, freq, cumul)
    _same(raw_jax.encode_section(*rows, **kw), raw_scan.encode_section(*rows, **kw))
    shared = (states, group_bytes, valid, freq[2], cumul[2])
    _same(raw_jax.encode_section(*shared, **kw), raw_scan.encode_section(*shared, **kw))


def _magic_edges(d: np.ndarray) -> np.ndarray:
    """uint64 [d.size, 15]: for each d the edge values of a u32 dividend: 0,
    d - 1, d, d + 1, the largest multiple of d in u32 and its neighbours, the
    multiple nearest 2^31 and its neighbours, 2^31 - 1, 2^31, 2^31 + 1 and
    2^32 - 1."""
    d = d.astype(np.uint64)[:, None]
    top = (np.uint64((1 << 32) - 1) // d) * d
    mid = (np.uint64(1 << 31) // d) * d
    one = np.uint64(1)
    cols = [np.zeros_like(d), d - one, d, d + one, top - one, top, top + one, mid - one, mid, mid + one,
            np.full_like(d, (1 << 31) - 1), np.full_like(d, 1 << 31), np.full_like(d, (1 << 31) + 1),
            np.full_like(d, (1 << 32) - 1), np.full_like(d, (1 << 32) - 2)]
    x = np.concatenate(cols, axis=1)
    return np.minimum(x, np.uint64((1 << 32) - 1))  # top + 1 may pass 2^32 - 1


def test_magic_table_exact_at_edges():
    """The encode's magic table (kernels/scan.py::magic_table), with the
    kernel's arithmetic (x + umulhi(m, x)) >> l written out in numpy
    uint64, equals x // d for every d in 1..65535 at every edge value of
    a u32 dividend; d = 0 takes d = 1's magic (the kernel divides by
    max(freq, 1))."""
    d = np.arange(1, 1 << 16)
    x = _magic_edges(d)
    assert np.array_equal(scan.magic_quotient(x, d[:, None]), x // d[:, None].astype(np.uint64))
    table = scan.magic_table()
    assert table.dtype == np.uint32 and table.shape == (1 << 16,) and table[0] == table[1]
    assert np.array_equal(scan.magic_shift(d), np.array([(int(v) - 1).bit_length() for v in d]))


def test_magic_table_exact_on_random_dividends():
    """As above on a seeded random sample: 64 u32 dividends for every d in
    1..65535, and every d at 4,096 dividends spread over all of u32."""
    rng = np.random.default_rng(2024)
    d = np.arange(1, 1 << 16)
    x = rng.integers(0, 1 << 32, (d.size, 64), dtype=np.uint64)
    assert np.array_equal(scan.magic_quotient(x, d[:, None]), x // d[:, None].astype(np.uint64))
    for lo in range(1, 1 << 16, 8192):
        dd = np.arange(lo, min(lo + 8192, 1 << 16))
        xs = np.linspace(0, (1 << 32) - 1, 4096, dtype=np.uint64)[None] + rng.integers(0, 2, (dd.size, 1),
                                                                                     dtype=np.uint64)
        xs = np.minimum(xs, np.uint64((1 << 32) - 1))
        assert np.array_equal(scan.magic_quotient(xs, dd[:, None]), xs // dd[:, None].astype(np.uint64))


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
