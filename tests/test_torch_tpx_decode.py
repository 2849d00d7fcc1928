"""tpx decode of the PyTorch port (CPU tier: the kernel's plain version)
against the JAX package's Pallas kernel in interpret mode and the numpy
wire authority.  Exact byte equality: the codec is lossless, so the
tolerance is zero.  The plain version reads each row's slots from the
ragged wire itself; the malformed blobs here hold it to the authority's
clamp where a row reads past its slots."""

from pathlib import Path

import numpy as np
import pytest
import torch

from hsrans_tpu.kernels.tpx_decode import _decode_mega, chunk_major, mega_dec_tables, tpx_decode_tpu
from hsrans_tpu.models.histogram import complete_hist
from hsrans_tpu.ops.tpx import (
    MAGIC3,
    TpxParams,
    _encode_mega_into,
    _popcount,
    _write_mega,
    make_rank_tables,
    tpx_decode,
    tpx_encode,
    tpx_encode_adaptive,
    tpx_header,
    tpx_parse,
)
from hsrans_tpu_torch.kernels import tpx_decode as pd
from hsrans_tpu_torch.kernels import tpx_encode as pe
from hsrans_tpu_torch.kernels.tpx_decode import dec_tables, tpx_decode_torch
from hsrans_tpu_torch.ops import tpx as pt
from tools.gen_inputs import text_like

CORPUS = Path(__file__).parent / "corpus" / "corpus.bin"


def small(bits: int) -> TpxParams:
    return TpxParams(bits=bits, rows=8, lanes=128, steps=8, tiles=2)


def _all_tiers_equal(blob: bytes, data: np.ndarray) -> None:
    want = data.tobytes()
    assert tpx_decode(blob) == want
    assert tpx_decode_tpu(blob, interpret=True) == want
    assert tpx_decode_torch(blob, device="cpu") == want


@pytest.mark.parametrize("bits", (10, 12, 13, 15))
def test_decode_multi_mega_all_tiers(bits):
    """Two megas of two tiles, the second mega partial."""
    p = small(bits)
    data = text_like(np.random.default_rng(bits), 2 * p.mega_bytes + 333)
    _all_tiers_equal(tpx_encode(data, p=p), data)


@pytest.mark.parametrize("size", (0, 777), ids=("empty", "partial-tile"))
def test_decode_edge_sizes_all_tiers(size):
    data = text_like(np.random.default_rng(7), size) if size else np.zeros(0, np.uint8)
    _all_tiers_equal(tpx_encode(data, p=small(12)), data)


def test_decode_v3_adaptive_all_tiers():
    arr = np.fromfile(CORPUS, np.uint8)[: 1 << 18]
    blob = tpx_encode_adaptive(arr, 12)
    assert blob[:8] == b"HSRTPX03"
    _all_tiers_equal(blob, arr)


def _one_call(blob: bytes) -> tuple[np.ndarray, np.ndarray, int]:
    """The port's plain decode of every mega of a blob in one call: (its
    output bytes, the mega descriptors, the blob's length)."""
    p, length, megas = pt.tpx_parse(blob)
    sym, fc = dec_tables(np.concatenate([m.freqs for m in megas]), p.bits)
    desc, row_start, states = pd.decode_operands(megas, length)
    out = pd.decode_mega_plain(
        torch.frombuffer(bytearray(blob), dtype=torch.uint8), desc, torch.from_numpy(row_start),
        torch.from_numpy(states.view(np.int32)), torch.from_numpy(sym), torch.from_numpy(fc),
        bits=p.bits, out_len=-(-length // 4) * 4,
    )
    return out.numpy(), desc, length


@pytest.mark.parametrize("bits", (10, 12, 13, 15))
@pytest.mark.parametrize("cut", (0, 1000), ids=("full", "partial"))
def test_decode_mega_plain_equals_pallas_kernel(bits, cut):
    """One mega of two tiles (states carried from tile 0 into tile 1): the
    plain version, reading the ragged slots where the wire keeps them,
    gives the Pallas kernel's packed output on the rectangular stream the
    JAX parser rebuilds, each side building its tables from the same wire
    freqs.  The Pallas kernel leaves the symbols of positions past the data
    in place, so only the valid bytes are compared."""
    p = small(bits)
    data = text_like(np.random.default_rng(100 + bits), p.mega_bytes - cut)
    blob = tpx_encode(data, p=p)
    _, length, (mega,) = tpx_parse(blob)
    vlen = min(length, mega.span)
    want = _decode_mega(
        np.array([[vlen]], np.int32),
        *mega_dec_tables(mega.freqs, bits),
        chunk_major(mega.stream.view(np.int32)),
        mega.states,
        rows=mega.rows, n_tiles=mega.n_tiles, w_slots=mega.w_slots, steps=mega.steps, bits=bits, interpret=True,
    )
    got, desc, _ = _one_call(blob)
    want_bytes = np.asarray(want).reshape(-1).view(np.uint8)
    assert len(desc) == 1 and got.size == -(-vlen // 4) * 4
    assert np.array_equal(got[:vlen], want_bytes[:vlen])
    assert not got[vlen:].any()  # past the data: 0
    assert got[:vlen].tobytes() == data.tobytes()


def _rewritten(blob: bytes, counts_of, w_slots_of) -> bytes:
    """The v2 blob rebuilt by the authority's own writer with each mega's
    counts and w_slots replaced; each row keeps the first ceil(count / 2)
    slots of its stream, so a row whose count drops reads past its slots."""
    p, length, megas = tpx_parse(blob)
    out = tpx_header(length, p)
    for m in megas:
        w = w_slots_of(m)
        stream = np.zeros((m.n_tiles, m.rows, w), np.uint32)
        stream[..., : min(w, m.w_slots)] = m.stream[..., :w]
        _write_mega(out, m.n_tiles, w, m.states, m.freqs, counts_of(m.counts.copy()), stream)
    out[16:24] = len(out).to_bytes(8, "little")
    return bytes(out)


@pytest.mark.parametrize("bits", (10, 12, 15))
def test_ragged_overread_at_w_slots_gives_last_slot(bits):
    """Rows cut to exactly w_slots slots (w_slots set below the longest
    rows' needs) read past their last slot: the read clamps to that slot,
    as the authority's min(widx >> 1, w_slots - 1) does."""
    data = text_like(np.random.default_rng(200 + bits), 2 * small(bits).mega_bytes - 3000)
    blob = tpx_encode(data, p=small(bits))
    w = int(np.median((tpx_parse(blob)[2][0].counts.astype(np.int64) + 1) // 2))
    bad = _rewritten(blob, lambda c: np.minimum(c, 2 * w).astype(np.uint16), lambda m: w)
    megas = pt.tpx_parse(bad)[2]
    assert all(m.w_slots == w and (np.diff(m.row_start) == w).any() for m in megas)
    got, _, length = _one_call(bad)
    want = tpx_decode(bad)
    assert want is not None and want != data.tobytes()
    assert got[:length].tobytes() == want
    assert tpx_decode_torch(bad, device="cpu") == want


@pytest.mark.parametrize("bits", (10, 12, 15))
def test_ragged_overread_below_w_slots_gives_zero(bits):
    """Rows whose count is cut to half keep w_slots: their reads past the
    count, below w_slots, give word 0, as the authority's rebuilt array
    holds 0 there."""
    data = text_like(np.random.default_rng(300 + bits), small(bits).mega_bytes + 5000)
    blob = tpx_encode(data, p=small(bits))
    bad = _rewritten(blob, lambda c: c // 2, lambda m: m.w_slots)
    megas = pt.tpx_parse(bad)[2]
    assert all((np.diff(m.row_start) < m.w_slots).all() for m in megas)
    got, _, length = _one_call(bad)
    want = tpx_decode(bad)
    assert want is not None and want != data.tobytes()
    assert got[:length].tobytes() == want


@pytest.mark.parametrize("bits", (10, 15))
def test_one_call_multi_mega_v2(bits, monkeypatch):
    """Three v2 megas, the last partial, through one call of each plain
    version: the blob equals the authority's and decodes to the input."""
    calls = []
    for mod, name in ((pd, "decode_mega_plain"), (pe, "encode_mega_plain")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, fn=fn, name=name, **k: calls.append((name, len(a[1]))) or fn(*a, **k))
    p = small(bits)
    data = text_like(np.random.default_rng(400 + bits), 2 * p.mega_bytes + 5000)
    blob = pe.tpx_encode_torch(data, p=p, device="cpu")
    assert blob == tpx_encode(data, p=p)
    assert tpx_decode_torch(blob, device="cpu") == data.tobytes()
    assert calls == [("encode_mega_plain", 3), ("decode_mega_plain", 3)]


# (rows, steps, n_tiles) of a hand-made v3 wire: odd rows, and a first mega
# whose slots start off a 4-byte boundary
V3_GEOMS = ((13, 8, 3), (8, 4, 2), (5, 12, 1))


@pytest.mark.parametrize("bits", (10, 12, 15))
def test_one_call_v3_mixed_geometry_odd_rows(bits):
    """A v3 wire whose megas differ in rows and steps, with odd rows, the
    last mega partial: the authority's blob decodes through one call of the
    plain version, and the port's one-call encode writes the same blob."""
    spans = [rows * steps * 128 * n for rows, steps, n in V3_GEOMS]
    data = text_like(np.random.default_rng(500 + bits), sum(spans) - 777)
    bases = np.cumsum([0, *spans[:-1]]).tolist()
    blob = bytearray(MAGIC3)
    blob += data.size.to_bytes(8, "little") + b"\0" * 8
    for v in (bits, V3_GEOMS[0][0], 128, V3_GEOMS[0][1], V3_GEOMS[0][2]):
        blob += v.to_bytes(4, "little")
    geoms = []
    for base, (rows, steps, n_tiles) in zip(bases, V3_GEOMS):
        blob += rows.to_bytes(4, "little") + steps.to_bytes(4, "little")
        _encode_mega_into(blob, data, base, n_tiles, data.size - base, bits, rows, steps)
        geoms.append((base, rows, steps, n_tiles, min(data.size - base, rows * steps * 128 * n_tiles)))
    blob[16:24] = len(blob).to_bytes(8, "little")
    blob = bytes(blob)
    assert pt.tpx_parse(blob)[2][0].slot_off % 4 == 2
    assert tpx_decode(blob) == data.tobytes()
    got, desc, length = _one_call(blob)
    assert len(desc) == 3 and got[:length].tobytes() == data.tobytes()
    assert pe._encode_megas(blob[:44], data, geoms, bits=bits, v3=True, devices=[torch.device("cpu")], layers=None) == blob
    for k in (2, 3):  # the megas split over k devices: the same bytes each way
        cpus = [torch.device("cpu")] * k
        assert pe._encode_megas(blob[:44], data, geoms, bits=bits, v3=True, devices=cpus, layers=None) == blob
        assert tpx_decode_torch(blob, devices=cpus) == data.tobytes()


@pytest.mark.parametrize("bits", (10, 12, 15))
def test_dec_tables_match_rank_tables(bits):
    """For every slot, (sym, freq, cumul) from the port's flat tables equals
    the bucketed-rank lookup of ops/tpx.py::make_rank_tables."""
    data = text_like(np.random.default_rng(bits), 50_000)
    freqs = np.stack([tpx_encode_freqs(data, bits), np.eye(256, dtype=np.uint16)[3] << bits])
    sym, fc = dec_tables(freqs, bits)
    fc = fc.view(np.uint32)
    slot = np.arange(1 << bits, dtype=np.uint32)
    for t in range(freqs.shape[0]):
        rt = make_rank_tables(complete_hist(freqs[t], bits))
        k = (slot >> np.uint32(5)).astype(np.int64)
        rank = (rt["c0"][k].astype(np.uint32) + _popcount(rt["bm"].view(np.uint32)[k] & ((np.uint32(2) << (slot & np.uint32(31))) - np.uint32(2)))).astype(np.int64)
        t1 = rt["t1"].view(np.uint32)[rank]
        s = sym[t].astype(np.uint32)
        assert np.array_equal(s, t1 & np.uint32(0xFF))
        assert np.array_equal(fc[t][s] & np.uint32(0xFFFF), t1 >> np.uint32(8))
        assert np.array_equal(fc[t][s] >> np.uint32(16), rt["t2"].view(np.uint32)[rank])


def tpx_encode_freqs(data: np.ndarray, bits: int) -> np.ndarray:
    """The wire freqs of the first tile of `data` encoded at `small(bits)`."""
    _, _, megas = tpx_parse(tpx_encode(data, p=small(bits)))
    return megas[0].freqs[0]


def test_decode_rejects_malformed_freqs():
    """A tile whose wire freqs do not sum to 2^B makes the blob malformed."""
    blob = bytearray(tpx_encode(text_like(np.random.default_rng(1), 5000), p=small(12)))
    off = 44 + 8 + 4 * 8 * 128  # first mega: n_tiles | W | states, then tile 0's freqs
    blob[off : off + 2] = (0xFFFF).to_bytes(2, "little")
    assert tpx_decode(bytes(blob)) is None
    assert tpx_decode_torch(bytes(blob), device="cpu") is None
