"""The 16-state mt wire as the benchmark's configuration `mt16_b12_xray` runs
it: the benchmark's frozen codec (`gpubench/reference/mt16.py`) against the
JAX package's encoders, and the port's `mt_encode_device` /
`mt_decode_device` at n = 16 on the CPU tier against that codec on seeded
x-ray in the device layout, malformed blobs included; then the cell itself
at a small size.  Exact equality throughout."""

import numpy as np
import pytest
import torch

import hsrans_tpu.parallel.sharded as jsh
from gpubench import run
from gpubench.data import xray
from gpubench.reference import mt16 as frozen
from gpubench.reference import planner
from hsrans_tpu.ops.mt import mt_decode_py, mt_encode_py
from hsrans_tpu.ops.planner import BlockPlan as JaxBlockPlan
from hsrans_tpu.rans import IDX2IDX as JAX_IDX2IDX
from hsrans_tpu_torch.parallel import sharded as psh
from hsrans_tpu_torch.rans import IDX2IDX

N = 16
CPU = torch.device("cpu")


def radiograph(nbytes: int, seed: int, side: int) -> np.ndarray:
    gen = torch.Generator()
    gen.manual_seed(seed)
    return xray.make(gen, nbytes, CPU, {"side": side}).numpy()


def as_rows(plan) -> list[tuple]:
    return [(r.start, r.size, r.symbol if r.is_single else None, None if r.is_single else r.freq) for r in plan]


def same_rows(got, want) -> bool:
    return len(got) == len(want) and all(
        g[:3] == w[:3] and (g[3] is None) == (w[3] is None) and (g[3] is None or (g[3] == w[3]).all())
        for g, w in zip(got, want))


def jax_plan(rows) -> list:
    return [JaxBlockPlan(s, z, sym is not None, sym or 0, f) for s, z, sym, f in rows]


# (name, input, max_block): seeded x-ray of 64 KiB to 1 MiB and its edges
CASES = {
    "empty": (lambda: np.zeros(0, np.uint8), 4096),
    "under_a_group": (lambda: radiograph(1 << 16, 1, 128)[30_001:30_014], 4096),
    "one_group": (lambda: radiograph(1 << 16, 2, 128)[20_000:20_016], 4096),
    "partial_last_group": (lambda: radiograph((1 << 16) + 37, 3, 128), 4096),
    "borders_single_symbol": (lambda: radiograph(1 << 20, 4, 1024), 2048),
    "many_blocks": (lambda: radiograph(1 << 18, 5, 256), 1024),
}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The plain tier's scans run a few small ops a link: one thread each,
    beside the other test processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def case(name: str, bits: int) -> tuple[np.ndarray, list, list[tuple]]:
    make, max_block = CASES[name]
    arr = make()
    plan = psh.device_plan(arr, bits, N, max_block)
    return arr, plan, planner.device_layout(arr, bits, N, max_block)


def test_lane_order_is_the_programs_and_the_jax_packages():
    assert frozen.LANES.tolist() == IDX2IDX[N].tolist() == np.asarray(JAX_IDX2IDX[N]).tolist()


@pytest.mark.parametrize("bits", [10, 12, 15])
@pytest.mark.parametrize("name", ["partial_last_group", "borders_single_symbol"])
def test_frozen_codec_equals_the_jax_packages_encoders(name, bits):
    """The whole blob is the JAX package's `mt_encode_device` (every block
    from fresh states) on the same rows.  Its numpy authority
    `mt_encode_py` carries the states from block to block, so the two
    blobs agree block by block: each coded block's states, freqs and words
    are `mt_encode_py`'s of that block alone.  Each decoder reads the
    other's blob."""
    arr, plan, rows = case(name, bits)
    assert same_rows(rows, as_rows(plan))
    blob = frozen.encode(arr, bits, rows)
    assert blob == jsh.mt_encode_device(arr, bits, N, plan=jax_plan(rows))
    assert mt_decode_py(blob, bits, N) == arr.tobytes()
    assert frozen.decode(mt_encode_py(arr, bits, N, jax_plan(rows)), bits) == arr.tobytes()
    _, stream, blocks = frozen.parse(blob)
    coded = [(r, b) for r, b in zip(rows, blocks) if r[2] is None]
    assert len(coded) == frozen.tables(blob) > 1
    for (start, size, _, freq), (_, _, _, states, freqs, at) in coded[:: max(len(coded) // 12, 1)]:
        # one coded block alone: head, size, offset, then its states, freqs and words
        alone = mt_encode_py(arr[start : start + size], bits, N, [JaxBlockPlan(0, size, False, 0, freq)])
        words = np.frombuffer(alone, "<u2", offset=32 + 4 * N + 512)
        assert (np.frombuffer(alone, "<u4", N, 32) == states).all()
        assert (np.frombuffer(alone, "<u2", 256, 32 + 4 * N) == freqs).all()
        assert (words == stream[at : at + words.size]).all()


@pytest.mark.parametrize("name", list(CASES))
def test_port_equals_the_frozen_codec(name):
    arr, plan, rows = case(name, 12)
    assert same_rows(rows, as_rows(plan))
    blob = psh.mt_encode_device(arr, 12, N, plan=plan, device="cpu")
    assert blob == frozen.encode(arr, 12, rows)
    assert psh.mt_decode_device(blob, 12, N, device="cpu") == frozen.decode(blob, 12) == arr.tobytes()


@pytest.mark.parametrize("bits", range(10, 16))
def test_port_equals_the_frozen_codec_at_every_depth(bits):
    arr, plan, rows = case("many_blocks", bits)
    assert same_rows(rows, as_rows(plan))
    blob = psh.mt_encode_device(arr, bits, N, plan=plan, device="cpu")
    assert blob == frozen.encode(arr, bits, rows)
    assert psh.mt_decode_device(blob, bits, N, device="cpu") == frozen.decode(blob, bits) == arr.tobytes()


def test_the_borders_make_single_symbol_blocks():
    _, _, rows = case("borders_single_symbol", 12)
    assert any(r[2] == 0 for r in rows) and sum(r[2] is None for r in rows) > 100


def malformed(blob: bytes) -> list[bytes]:
    """Blobs cut short (inside the head, the first block's header, its
    words, and 3 bytes short of the length the head gives), a first block's
    freq off by one (the sum no longer 2^B), and a first block's offset
    pointing past the blob."""
    head = 16 + 2 * frozen.HEAD_U16
    cases = [blob[:cut] for cut in (0, 8, 15, 16, 23, head - 1, head + 40)] + [blob[: len(blob) - 3]]
    b = bytearray(blob)
    b[16 + 2 * (8 + 2 * N + 40)] ^= 1
    cases.append(bytes(b))
    b = bytearray(blob)
    b[24:32] = (len(blob)).to_bytes(8, "little")
    cases.append(bytes(b))
    return cases


@pytest.mark.parametrize("bits", [10, 12, 15])
def test_both_give_none_on_the_same_malformed_blobs(bits):
    arr, plan, _ = case("partial_last_group", bits)
    blob = psh.mt_encode_device(arr, bits, N, plan=plan, device="cpu")
    assert int.from_bytes(blob[16:24], "little") >> 63 == 0  # the first block is coded
    before = dict(psh.MT_DEVICE_COUNTS)
    cases = malformed(blob)
    for bad in cases:
        assert psh.mt_decode_device(bad, bits, N, device="cpu") is None
        assert frozen.decode(bad, bits) is None
    assert psh.MT_DEVICE_COUNTS["none"] - before["none"] == len(cases)
    assert psh.MT_DEVICE_COUNTS["c"] == before["c"]


def test_the_control_depth_decodes_other_bytes():
    """The benchmark's control: the frozen decode with each table one depth
    below the blob's gives bytes other than the input, and so does the
    frozen encode one depth down give another blob."""
    arr, _, rows = case("many_blocks", 12)
    blob = frozen.encode(arr, 12, rows)
    got = frozen.decode(blob, 12, table_bits=11)
    assert len(got) == arr.size and got != arr.tobytes()
    assert frozen.encode(arr, 11, planner.device_layout(arr, 11, N, CASES["many_blocks"][1])) != blob


SMALL = {"object_bytes": 1 << 17, "generator_params": {"side": 256}, "max_block": 1024}
SPAN_METRICS = {"host_prep_ms", "copy_ms", "assemble_ms", "prep_span_ms", "copy_span_ms", "assemble_span_ms",
                "scan_kernel_ms", "call_p95_ms"}


@pytest.mark.parametrize("traced", [False, True])
def test_the_cell_runs_the_wire_and_judges_no_byte_off(traced):
    cell = run.Cell.load("mt16_xray_decode_64m", config=SMALL)
    assert cell.config["lanes"] == N and cell.wire.decode.__module__.endswith("mt16")
    before = dict(psh.MT_DEVICE_COUNTS)
    result, _ = run.run_cell(cell, 2**33 + 26, 0.3, traced, CPU, t0=0.0)
    assert result["correct"] is True and result["failed"] == 0
    assert result["checks"] == {name: {"value": 0, "limit": 0}
                                for name in ("output_bytes_off", "wire_bytes_off", "failed_calls")}
    assert psh.MT_DEVICE_COUNTS["c"] - before["c"] >= result["attempted"]
    assert psh.MT_DEVICE_COUNTS["a"] == before["a"] and psh.MT_DEVICE_COUNTS["b"] == before["b"]
    if traced:
        assert SPAN_METRICS <= set(result["metrics"])
        assert all(result["metrics"][m]["value"] > 0 for m in SPAN_METRICS)
    else:
        assert set(result["metrics"]) == {"throughput_MiBps", "setup_s"}
