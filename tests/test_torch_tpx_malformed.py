"""Malformed tpx blobs through the port's decode (CPU tier): None or bytes,
never an exception — the cases of tests/test_malformed.py.  The plain
version reads the stream clamped exactly as the numpy authority does, so
where the wire's lanes field still says 128 the two agree byte for byte
even on corrupt input."""

import numpy as np
import pytest

from hsrans_tpu.ops.tpx import tpx_decode, tpx_encode, tpx_encode_adaptive
from hsrans_tpu_torch.kernels.tpx_decode import tpx_decode_torch
from tools.gen_inputs import text_like

CUTS = (0, 7, 8, 15, 16, 43, 44, 100, 800, 1000, -1)


def _data():
    return text_like(np.random.default_rng(21), 40_000)


def _truncations(blob):
    for cut in CUTS:
        yield blob[: cut if cut >= 0 else len(blob) - 1]


def _payload_flips(blob, rng, n_flips):
    for _ in range(n_flips):
        b = bytearray(blob)
        b[int(rng.integers(0, len(blob)))] ^= int(rng.integers(1, 256))
        yield bytes(b)
    for pos in (len(blob) // 2, len(blob) - 3):
        for val in (0x00, 0xFF):
            b = bytearray(blob)
            b[pos] = val
            yield bytes(b)


def _check(blob: bytes, against_authority: bool = True) -> None:
    out = tpx_decode_torch(blob, device="cpu")
    assert out is None or isinstance(out, bytes)
    if against_authority and len(blob) >= 36 and int.from_bytes(blob[32:36], "little") == 128:
        assert out == tpx_decode(blob)


@pytest.fixture(scope="module")
def v2_blob():
    blob = tpx_encode(_data(), 12)
    assert tpx_decode_torch(blob, device="cpu") == _data().tobytes()
    return blob


@pytest.fixture(scope="module")
def v3_blob():
    blob = tpx_encode_adaptive(_data(), 12)
    assert tpx_decode_torch(blob, device="cpu") == _data().tobytes()
    return blob


@pytest.mark.parametrize("wire", ("v2", "v3"))
def test_truncations_safe(wire, v2_blob, v3_blob):
    for t in _truncations(v2_blob if wire == "v2" else v3_blob):
        _check(t)


def test_header_bitflips_safe(v2_blob):
    for pos in (8, 24, 28, 32, 36, 40, 44, 48):
        for val in (0x00, 0xFF, 0x7F):
            b = bytearray(v2_blob)
            b[pos] = val
            _check(bytes(b))


@pytest.mark.parametrize("wire,seed,n_flips", (("v2", 31, 120), ("v3", 61, 80)))
def test_payload_bitflips_safe(wire, seed, n_flips, v2_blob, v3_blob):
    rng = np.random.default_rng(seed)
    for b in _payload_flips(v2_blob if wire == "v2" else v3_blob, rng, n_flips):
        _check(b)


def test_v3_geometry_stomps_safe(v3_blob):
    """The per-mega rows/steps fields right after the global header.  A
    stomped steps field of ~2^16 makes the authority walk every step (tens
    of seconds), so these are held to the None-or-bytes contract alone."""
    for pos in (44, 45, 48, 49):
        for val in (0x00, 0xFF, 0x80):
            b = bytearray(v3_blob)
            b[pos] = val
            _check(bytes(b), against_authority=False)


def test_rows_13_stomp(v3_blob):
    """rows = 13, which the Pallas kernel refuses (not a sublane multiple):
    the port has no such limit and answers as the authority does."""
    b = bytearray(v3_blob)
    b[44:48] = (13).to_bytes(4, "little")
    _check(bytes(b))
