"""The raw 16w wire as the benchmark's configuration `raw64_b12_text` runs
it: the benchmark's frozen codec (`gpubench/reference/raw.py`, its chain in
`raw16w.c`) against the C++ reference's golden blobs, and the port's
`raw_encode_torch` and `raw_decode_torch` on the CPU tier against that
codec on seeded `text_like` data, malformed blobs included.  Exact
equality throughout."""

import numpy as np
import pytest
import torch

from gpubench.data import text_like
from gpubench.reference import raw as frozen
from hsrans_tpu_torch import make_hist, raw_decode_torch, raw_encode_torch

N = 64


def text(n: int, seed: int) -> np.ndarray:
    gen = torch.Generator()
    gen.manual_seed(seed)
    return text_like.make(gen, n, torch.device("cpu"), {}).numpy()


def port_hist(data: np.ndarray, bits: int):
    """The whole input's histogram as a user of the port builds it; the
    1-symbol histogram of byte 0 for no input, as the frozen codec's."""
    return make_hist(data if data.size else np.zeros(1, np.uint8), bits)


@pytest.mark.parametrize("bits", range(10, 16))
@pytest.mark.parametrize("name", ["text_63k", "skew_50k", "uniform_8k", "tiny_130"])
def test_frozen_codec_equals_the_golden_blobs(golden_dir, golden_inputs, name, bits):
    data = golden_inputs[name]
    want = (golden_dir / f"{name}.raw64_{bits}.bin").read_bytes()
    assert frozen.encode(data, bits, N) == want
    assert frozen.decode(want, bits, N) == data.tobytes()


@pytest.mark.parametrize(("length", "bits"), [(0, 12), (1, 12), (63, 12), (64, 12), (65, 12), (4095, 12), (65537, 12),
                                              (4095, 10), (4095, 15)])
def test_port_equals_the_frozen_codec(length, bits):
    data = text(length, 1000 + length + bits)
    blob = raw_encode_torch(data, port_hist(data, bits), N, device="cpu")
    assert blob == frozen.encode(data, bits, N)
    assert raw_decode_torch(blob, bits, N, device="cpu") == frozen.decode(blob, bits, N) == data.tobytes()


def malformed(blob: bytes) -> list[bytes]:
    """Truncated headers, a blob shorter than the size its header gives,
    and freqs that do not sum to 2^B."""
    cases = [blob[:cut] for cut in (0, 16, 527, 528, 528 + 4 * N - 1)]
    cases.append(blob[: len(blob) - 3])
    for pos, delta in ((16, 1), (16 + 2 * 97, -1), (16 + 2 * 255, 7)):
        b = bytearray(blob)
        freq = int.from_bytes(b[pos : pos + 2], "little")
        b[pos : pos + 2] = ((freq + delta) & 0xFFFF).to_bytes(2, "little")
        cases.append(bytes(b))
    return cases


@pytest.mark.parametrize("bits", [10, 12, 15])
def test_both_give_none_on_the_same_malformed_blobs(bits):
    data = text(5000, bits)
    blob = frozen.encode(data, bits, N)
    for case in malformed(blob):
        assert raw_decode_torch(case, bits, N, device="cpu") is None
        assert frozen.decode(case, bits, N) is None
    assert frozen.decode(blob, bits + 1, N) is None and raw_decode_torch(blob, bits + 1, N, device="cpu") is None


def test_the_control_depth_decodes_other_bytes():
    """The benchmark's control: the frozen decode with the table one depth
    below the blob's gives bytes other than the input."""
    data = text(20000, 5)
    blob = frozen.encode(data, 12, N)
    got = frozen.decode(blob, 12, N, table_bits=11)
    assert len(got) == data.size and got != data.tobytes()


def test_lane_layout():
    """Each lane's byte of its group: a permutation, two halves of each 32
    (16) interleaved in runs of 4."""
    for n in (16, 32, 64):
        lanes = frozen.lanes(n)
        assert sorted(lanes.tolist()) == list(range(n))
    assert frozen.lanes(16).tolist() == [0, 1, 2, 3, 8, 9, 10, 11, 4, 5, 6, 7, 12, 13, 14, 15]
    assert frozen.lanes(64)[32:].tolist() == (frozen.lanes(32) + 32).tolist()
    with pytest.raises(ValueError):
        frozen.lanes(8)
