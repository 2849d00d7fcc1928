"""tpx decode of the PyTorch port (CPU tier: the kernel's plain version)
against the JAX package's Pallas kernel in interpret mode and the numpy
wire authority.  Exact byte equality: the codec is lossless, so the
tolerance is zero."""

from pathlib import Path

import numpy as np
import pytest
import torch

from hsrans_tpu.kernels.tpx_decode import _decode_mega, chunk_major, mega_dec_tables, tpx_decode_tpu
from hsrans_tpu.models.histogram import complete_hist
from hsrans_tpu.ops.tpx import TpxParams, _popcount, make_rank_tables, tpx_decode, tpx_encode, tpx_encode_adaptive, tpx_parse
from hsrans_tpu_torch.kernels.tpx_decode import dec_tables, decode_mega_plain, tpx_decode_torch
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


@pytest.mark.parametrize("bits", (10, 12, 13, 15))
@pytest.mark.parametrize("cut", (0, 1000), ids=("full", "partial"))
def test_decode_mega_plain_equals_pallas_kernel(bits, cut):
    """One parsed mega of two tiles (states carried from tile 0 into tile
    1): the plain version's packed output equals the Pallas kernel's, each
    side building its tables from the same wire freqs.  The Pallas kernel
    leaves the symbols of positions past the data in place, so only the
    valid bytes are compared."""
    p = small(bits)
    data = text_like(np.random.default_rng(100 + bits), p.mega_bytes - cut)
    _, length, (mega,) = tpx_parse(tpx_encode(data, p=p))
    vlen = min(length, mega.span)
    want = _decode_mega(
        np.array([[vlen]], np.int32),
        *mega_dec_tables(mega.freqs, bits),
        chunk_major(mega.stream.view(np.int32)),
        mega.states,
        rows=mega.rows, n_tiles=mega.n_tiles, w_slots=mega.w_slots, steps=mega.steps, bits=bits, interpret=True,
    )
    sym, fc = dec_tables(mega.freqs, bits)
    got = decode_mega_plain(
        torch.from_numpy(mega.stream.view(np.int32)),
        torch.from_numpy(mega.states.view(np.int32)),
        torch.from_numpy(sym),
        torch.from_numpy(fc),
        bits=bits, steps=mega.steps, vlen=vlen,
    )
    got_bytes = got.numpy().reshape(-1).view(np.uint8)
    want_bytes = np.asarray(want).reshape(-1).view(np.uint8)
    assert got.shape == tuple(want.shape)
    assert np.array_equal(got_bytes[:vlen], want_bytes[:vlen])
    assert not got_bytes[vlen:].any()  # past the data: 0
    assert got_bytes[:vlen].tobytes() == data.tobytes()


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
