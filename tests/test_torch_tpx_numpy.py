"""The port's numpy tpx codec (`hsrans_tpu_torch/ops/tpx.py`: `tpx_encode`,
`tpx_encode_adaptive`, `tpx_decode` on both lookup routes, `make_rank_tables`,
`_write_mega_segs`, `_popcount`) and its table copies (`models/tables.py`:
`make_enc_table`, `make_dec_pack`) against the JAX package's originals,
byte for byte: the golden inputs at B = 10, 12 and 15, both wires, odd
tails and lengths 0 to 70,001, and the malformed blobs of
`test_torch_tpx_malformed.py` (the same None or the same bytes)."""

import numpy as np
import pytest

from hsrans_tpu.models import histogram as jh
from hsrans_tpu.models import tables as jtab
from hsrans_tpu.ops import tpx as jt
from hsrans_tpu_torch import tpx_decode, tpx_encode
from hsrans_tpu_torch.models import histogram as ph
from hsrans_tpu_torch.models import tables as ptab
from hsrans_tpu_torch.ops import tpx as pt
from tools.gen_inputs import text_like

from .test_torch_tpx_malformed import _data, _payload_flips, _truncations

LENGTHS = (0, 1, 127, 128, 4095, 4096 * 32 + 5, 70_001)


def _same(blob: bytes) -> None:
    """Both decoders on both routes: the same None or the same bytes."""
    for rank in (False, True):
        assert pt.tpx_decode(blob, use_rank_tables=rank) == jt.tpx_decode(blob, use_rank_tables=rank), rank


@pytest.mark.parametrize("bits", (10, 12, 15))
def test_golden_inputs_equal_original(golden_inputs, bits):
    """v2 and v3 blobs of every golden input equal the original's, and both
    decoders, on both routes, return the input."""
    assert len(golden_inputs) >= 7
    for name, data in golden_inputs.items():
        for enc in ("tpx_encode", "tpx_encode_adaptive"):
            blob = getattr(pt, enc)(data, bits)
            assert blob == getattr(jt, enc)(data, bits), (name, enc)
            for rank in (False, True):
                assert pt.tpx_decode(blob, use_rank_tables=rank) == data.tobytes(), (name, enc, rank)


@pytest.mark.parametrize("length", LENGTHS)
def test_lengths_and_odd_tails_equal_original(length):
    """Empty, one byte, partial lane groups and tiles, several megas of a
    small geometry: encoders equal the original's, decoders the input."""
    data = text_like(np.random.default_rng(length), length)
    small = {"bits": 11, "rows": 8, "steps": 8, "tiles": 2}
    for blob, want in ((pt.tpx_encode(data, 12), jt.tpx_encode(data, 12)),
                       (pt.tpx_encode(data, p=pt.TpxParams(**small)), jt.tpx_encode(data, p=jt.TpxParams(**small))),
                       (pt.tpx_encode(data, 13, goal="speed"), jt.tpx_encode(data, 13, goal="speed")),
                       (pt.tpx_encode_adaptive(data, 14), jt.tpx_encode_adaptive(data, 14))):
        assert blob == want
        _same(blob)
        assert pt.tpx_decode(blob) == data.tobytes()


def test_top_level_exports():
    """`hsrans_tpu_torch.tpx_encode` and `tpx_decode` are the numpy codec,
    as `hsrans_tpu.tpx_encode` and `tpx_decode` are the JAX package's."""
    assert tpx_encode is pt.tpx_encode and tpx_decode is pt.tpx_decode
    data = text_like(np.random.default_rng(3), 9000)
    assert tpx_decode(tpx_encode(data)) == data.tobytes()


@pytest.mark.parametrize("wire", ("v2", "v3"))
def test_malformed_equal_original(wire):
    """The truncations, header stomps and payload flips of
    `test_torch_tpx_malformed.py`: the same None or the same bytes."""
    data = _data()
    blob = jt.tpx_encode(data, 12) if wire == "v2" else jt.tpx_encode_adaptive(data, 12)
    bad = list(_truncations(blob)) + list(_payload_flips(blob, np.random.default_rng(31 if wire == "v2" else 61), 16))
    if wire == "v2":
        for pos in (8, 24, 28, 32, 36, 40, 44, 48):
            for val in (0x00, 0xFF, 0x7F):
                b = bytearray(blob)
                b[pos] = val
                bad.append(bytes(b))
    else:
        b = bytearray(blob)
        b[44:48] = (13).to_bytes(4, "little")  # rows = 13
        bad.append(bytes(b))
    outcomes = set()
    for b in bad:
        _same(b)
        outcomes.add(pt.tpx_decode(b) is None)
    assert outcomes == {True, False}


@pytest.mark.parametrize("bits", (10, 11, 12, 13, 15))
def test_tables_equal_original(bits):
    """`make_rank_tables` (every key, incl. `tp` at B <= 12 and `cb16` at
    B <= 11), `make_enc_table` and `make_dec_pack` (B <= 12; above, the
    same ValueError) equal the originals, on skewed and single-symbol
    histograms."""
    rng = np.random.default_rng(bits)
    for data in (np.minimum(rng.geometric(0.2, 5000) - 1, 255).astype(np.uint8), np.full(300, 7, np.uint8),
                 rng.integers(0, 256, 20_000).astype(np.uint8)):
        ph_, jh_ = ph.make_hist(data, bits), jh.make_hist(data, bits)
        got, want = pt.make_rank_tables(ph_), jt.make_rank_tables(jh_)
        assert got.keys() == want.keys() and ("tp" in got) == (bits <= 12) and ("cb16" in got) == (bits <= 11)
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
        assert np.array_equal(ptab.make_enc_table(ph_), jtab.make_enc_table(jh_))
        if bits <= 12:
            assert np.array_equal(ptab.make_dec_pack(ph_), jtab.make_dec_pack(jh_))
        else:
            with pytest.raises(ValueError):
                ptab.make_dec_pack(ph_)


def test_write_mega_segs_and_popcount_equal_original():
    """The segment writer on random pieces equals the original's and
    `_write_mega` over the joined rows; `_popcount` over edge words."""
    rng = np.random.default_rng(7)
    T, S, R, WC = 2, 3, 8, 6
    seg_words = rng.integers(0, 2 * WC + 1, (T, R, S))
    seg_streams = rng.integers(0, 2**32, (T, S, R, WC), dtype=np.uint64).astype(np.uint32)
    counts = seg_words.sum(axis=2).astype(np.uint16)
    states = rng.integers(0, 2**32, (R, 128), dtype=np.uint64).astype(np.uint32)
    freqs = rng.integers(0, 2**16, (T, 256)).astype(np.uint16)
    w_slots = -(-int(counts.max()) // 2)
    a, b = bytearray(), bytearray()
    pt._write_mega_segs(a, T, w_slots, states, freqs, counts, seg_streams, seg_words)
    jt._write_mega_segs(b, T, w_slots, states, freqs, counts, seg_streams, seg_words)
    assert a == b
    # the same rows joined word by word, then the rectangular writer
    words = seg_streams.view(np.uint16).reshape(T, S, R, 2 * WC)
    rect = np.zeros((T, R, w_slots * 2), np.uint16)
    for t in range(T):
        for r in range(R):
            row = np.concatenate([words[t, s, r, : seg_words[t, r, s]] for s in range(S)])
            rect[t, r, : row.size] = row
    c = bytearray()
    pt._write_mega(c, T, w_slots, states, freqs, counts, rect.view(np.uint32))
    assert a == c
    x = np.array([0, 1, 0xFFFFFFFF, 0x80000000, 0x55555555, 0x12345678], np.uint32)
    x = np.concatenate([x, rng.integers(0, 2**32, 1000, dtype=np.uint64).astype(np.uint32)])
    assert np.array_equal(pt._popcount(x), jt._popcount(x))
    assert pt._popcount(x).tolist() == [bin(int(v)).count("1") for v in x]
