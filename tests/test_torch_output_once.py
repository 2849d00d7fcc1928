"""The seven card entry points write their output once, into the `bytes`
they return (`runtime/device.py::Output`), on the CPU tier.

A fresh output's contents are undefined, so every byte of it has to be
written by the call: with every fresh output starting as 0xA5 instead of
zeros, each entry point gives the bytes it gives from a zeroed one, equal
to the authorities where they exist, and None exactly where it gave None
(the truncated and bit-flipped tpx blobs that still decode among them).
`OUTPUT_COUNTS` counts one output a call, of the result's length."""

import ctypes
import sys
from functools import cache

import numpy as np
import pytest

import hsrans_tpu.parallel.sharded as jsh
from hsrans_tpu.ops.tpx import TpxParams, tpx_decode, tpx_encode, tpx_encode_adaptive
from hsrans_tpu_torch import (
    make_hist,
    mt_decode_torch,
    mt_encode_torch,
    raw_decode_torch,
    raw_encode_torch,
    tpx_decode_torch,
    tpx_encode_adaptive_torch,
    tpx_encode_torch,
)
from hsrans_tpu_torch.ops.mt import mt_decode_py, mt_encode_py
from hsrans_tpu_torch.ops.planner import BlockPlan
from hsrans_tpu_torch.ops.reference import raw_encode_16w
from hsrans_tpu_torch.ops.tpx import make_tile_hist
from hsrans_tpu_torch.parallel.sharded import device_plan, scan_decode_blob
from hsrans_tpu_torch.runtime import device
from tools.gen_inputs import text_like

PAYLOAD = ctypes.PYFUNCTYPE(ctypes.c_void_p, ctypes.py_object)(("PyBytes_AsString", ctypes.pythonapi))
NEW_BYTES = device._new_bytes  # the constructor every Output takes its `bytes` from
SMALL = TpxParams(bits=12, rows=8, lanes=128, steps=8, tiles=2)  # several megas from a few KiB
CUTS = (0, 7, 8, 15, 16, 43, 44, 100, 800, 1000, -1)
UNKNOWN = object()  # no authority's answer for the case


@cache
def text() -> np.ndarray:
    return text_like(np.random.default_rng(21), 40_000)


@cache
def multi_mega() -> np.ndarray:
    return text_like(np.random.default_rng(5), 9 * SMALL.mega_bytes + 777)


@cache
def tpx_blob(wire: str) -> bytes:
    if wire == "v2":
        return tpx_encode(text(), 12)
    if wire == "v3":
        return tpx_encode_adaptive(text(), 12)
    return tpx_encode(multi_mega(), p=SMALL)


@cache
def mt_data(tail: bool) -> tuple[np.ndarray, list[BlockPlan]]:
    """Single-symbol runs that open, split and close the coded stretches (2
    KiB blocks), and with `tail` a last coded block whose length leaves a
    partial lane group: the decode's single-symbol fills and tail group."""
    rng = np.random.default_rng(130)
    parts = [(9, 5000), (None, 7 * 1024), (2, 4000), (None, 6 * 1024)]
    parts.append((None, 2048 + 37) if tail else (4, 3000))
    data = np.concatenate([np.full(size, sym, np.uint8) if sym is not None else text_like(rng, size)
                           for sym, size in parts])
    plan, at = [], 0
    for sym, size in parts:
        if sym is not None:
            plan.append(BlockPlan(at, size, True, sym, None))
        else:
            cut = list(range(at, at + size, 2048))
            if at + size - cut[-1] < 64:
                cut.pop()
            for s, e in zip(cut, cut[1:] + [at + size]):
                plan.append(BlockPlan(s, e - s, False, 0, make_tile_hist(data[s:e], 12).symbol_count))
        at += size
    return data, plan


@cache
def mt_blob(tail: bool, n: int) -> bytes:
    data, plan = mt_data(tail)
    return mt_encode_py(data, 12, n, plan)


@cache
def raw_blob(n: int) -> tuple[np.ndarray, bytes]:
    data = text_like(np.random.default_rng(40 + n), 5_001)
    return data, raw_encode_16w(data, make_hist(data, 12), n)


def truncated(wire: str, cut: int) -> bytes:
    blob = tpx_blob(wire)
    return blob[: cut if cut >= 0 else len(blob) - 1]


def flipped(wire: str, pos: int, val: int) -> bytes:
    b = bytearray(tpx_blob(wire))
    b[pos % len(b)] = val
    return bytes(b)


def tpx_authority(blob: bytes):
    """The numpy authority's answer where the wire's lanes field says 128
    (where the port's decode follows it byte for byte), else no answer."""
    if len(blob) >= 36 and int.from_bytes(blob[32:36], "little") == 128:
        return tpx_decode(blob)
    return UNKNOWN


def _cases() -> dict:
    """name -> (the call, the authority's answer as a function, or None)."""
    cases = {
        "tpx_decode.v2": (lambda: tpx_decode_torch(tpx_blob("v2"), device="cpu"), lambda: text().tobytes()),
        "tpx_decode.v3": (lambda: tpx_decode_torch(tpx_blob("v3"), device="cpu"), lambda: text().tobytes()),
    }
    for k in (1, 2, 3):
        cases[f"tpx_decode.split{k}"] = (lambda k=k: tpx_decode_torch(tpx_blob("multi"), devices=["cpu"] * k),
                                         lambda: multi_mega().tobytes())
    for wire in ("v2", "v3"):
        for cut in CUTS:
            cases[f"tpx_decode.{wire}.cut{cut}"] = (lambda w=wire, c=cut: tpx_decode_torch(truncated(w, c), device="cpu"),
                                                    lambda w=wire, c=cut: tpx_authority(truncated(w, c)))
    for pos in (8, 24, 28, 32, 36, 40, 44, 48):
        for val in (0x00, 0xFF, 0x7F):
            cases[f"tpx_decode.v2.head{pos}={val}"] = (
                lambda p=pos, v=val: tpx_decode_torch(flipped("v2", p, v), device="cpu"),
                lambda p=pos, v=val: tpx_authority(flipped("v2", p, v)))
    rng = np.random.default_rng(31)
    for wire in ("v2", "v3"):
        for pos, val in [(int(rng.integers(0, 1 << 20)), int(rng.integers(0, 256))) for _ in range(6)] + [
            (-3, 0x00), (-3, 0xFF)
        ]:
            cases[f"tpx_decode.{wire}.byte{pos}={val}"] = (
                lambda w=wire, p=pos, v=val: tpx_decode_torch(flipped(w, p, v), device="cpu"),
                lambda w=wire, p=pos, v=val: tpx_authority(flipped(w, p, v)))
    for tail in (True, False):
        for n in (32, 64):
            for k in (1, 3):
                cases[f"mt_decode.{'tail' if tail else 'singles'}.n{n}.split{k}"] = (
                    lambda t=tail, n=n, k=k: mt_decode_torch(mt_blob(t, n), 12, n, devices=["cpu"] * k),
                    lambda t=tail, n=n: mt_decode_py(mt_blob(t, n), 12, n))
    for n in (16, 32, 64):
        cases[f"raw_decode.n{n}"] = (lambda n=n: raw_decode_torch(raw_blob(n)[1], 12, n, device="cpu"),
                                     lambda n=n: raw_blob(n)[0].tobytes())
        cases[f"raw_encode.n{n}"] = (lambda n=n: raw_encode_torch(raw_blob(n)[0], make_hist(raw_blob(n)[0], 12), n,
                                                                  device="cpu"),
                                     lambda n=n: raw_encode_16w(raw_blob(n)[0], make_hist(raw_blob(n)[0], 12), n))
    empty = np.zeros(0, np.uint8)
    cases["raw_encode.empty"] = (lambda: raw_encode_torch(empty, make_hist(text(), 12), 64, device="cpu"),
                                 lambda: raw_encode_16w(empty, make_hist(text(), 12), 64))
    for tail in (True, False):
        for n in (16, 32, 64):
            for k in (1, 2, 3):
                cases[f"scan_decode_blob.{'tail' if tail else 'singles'}.n{n}.split{k}"] = (
                    lambda t=tail, n=n, k=k: scan_decode_blob(mt_blob(t, n), 12, n, ["cpu"] * k),
                    lambda t=tail, n=n: mt_decode_py(mt_blob(t, n), 12, n))
    for k in (1, 3):
        cases[f"tpx_encode.split{k}"] = (lambda k=k: tpx_encode_torch(multi_mega(), p=SMALL, devices=["cpu"] * k),
                                         lambda: tpx_encode(multi_mega(), p=SMALL))
    cases["tpx_encode.default"] = (lambda: tpx_encode_torch(text(), 12, device="cpu"), lambda: tpx_encode(text(), 12))
    cases["tpx_encode_adaptive"] = (lambda: tpx_encode_adaptive_torch(text(), 12, device="cpu"),
                                    lambda: tpx_encode_adaptive(text(), 12))
    uniform = lambda: jsh.mt_encode_device(text(), 12, 64, plan=jsh.uniform_plan(text(), 12, 64, 4096))  # noqa: E731
    for k in (1, 2):
        cases[f"mt_encode.uniform.split{k}"] = (lambda k=k: mt_encode_torch(text(), 12, devices=["cpu"] * k), uniform)
    cases["mt_encode.singles"] = (lambda: mt_encode_torch(mt_data(True)[0], 12, plan=mt_data(True)[1], device="cpu"),
                                  None)
    cases["mt_encode.device_plan"] = (
        lambda: mt_encode_torch(mt_data(False)[0], 12, plan=device_plan(mt_data(False)[0], 12, 64, 4096), device="cpu"),
        None)
    return cases


CASES = _cases()


def filled_with(value: int):
    def new_bytes(_, n: int):
        obj = NEW_BYTES(None, n)
        ctypes.memset(PAYLOAD(obj), value, n)
        return obj

    return new_bytes


def run(monkeypatch, name: str, value: int):
    monkeypatch.setattr(device, "_new_bytes", filled_with(value))
    return CASES[name][0]()


@pytest.mark.parametrize("name", list(CASES))
def test_every_byte_of_the_output_is_written(name, monkeypatch):
    """From a fresh output of 0xA5 and from a zeroed one (the parent's
    `np.zeros`), the same bytes, the authority's; None exactly where the
    authority (or the zeroed call, where it has none) gives None."""
    poisoned = run(monkeypatch, name, 0xA5)
    zeroed = run(monkeypatch, name, 0)
    assert poisoned == zeroed
    assert poisoned is None or type(poisoned) is bytes
    authority = CASES[name][1]
    want = authority() if authority else UNKNOWN
    if want is not UNKNOWN:
        assert poisoned == want
    if name.startswith("mt_encode"):
        data = mt_data(name.endswith("singles"))[0] if "uniform" not in name else text()
        assert mt_decode_py(poisoned, 12, 64) == data.tobytes()


SEVEN = {
    "tpx_decode_torch": "tpx_decode.split3",
    "mt_decode_torch": "mt_decode.tail.n64.split3",
    "raw_decode_torch": "raw_decode.n64",
    "tpx_encode_torch": "tpx_encode.split3",
    "mt_encode_torch": "mt_encode.uniform.split2",
    "raw_encode_torch": "raw_encode.n64",
    "scan_decode_blob": "scan_decode_blob.tail.n16.split2",
}


@pytest.mark.parametrize("entry", list(SEVEN))
def test_output_counts_one_output_a_call(entry):
    """A call, split over devices or not, makes one Output, of the result's
    length."""
    before = dict(device.OUTPUT_COUNTS)
    res = CASES[SEVEN[entry]][0]()
    assert {k: device.OUTPUT_COUNTS[k] - before[k] for k in before} == {"in_place": 1, "in_place_bytes": len(res)}


def test_fresh_output_of_nothing_is_the_empty_bytes():
    with device.Output(0) as out:
        assert out.view.size == 0
    assert out.result == b"" and type(out.result) is bytes and out.view is None


def test_a_filled_output_equals_and_hashes_like_a_copy():
    with device.Output(1000) as out:
        out.part(0, 1000)[:] = np.random.default_rng(2).integers(0, 256, 1000, dtype=np.uint8)
        want = bytes(out.view.copy())
    res = out.result
    assert type(res) is bytes and res == want and hash(res) == hash(want)


def test_the_view_is_the_payload_and_holds_it():
    """The view's memory is the object's own payload (PyBytes_AsString), a
    write through it shows in the object, and the view holds the object."""
    with device.Output(64) as out:
        view = out.view
        address, holder = view.ctypes.data, view.base
        assert view.flags.writeable and view.size == 64
        out.part(0, 64)[:] = 3
        out.part(5, 6)[:] = 200
        del view
    res = out.result
    assert address == PAYLOAD(res) and len(res) == 64
    assert res == bytes([3] * 5 + [200] + [3] * 58)
    assert holder.obj is res


@pytest.mark.parametrize("seed", range(4))
def test_zero_outside_writes_exactly_the_uncovered_bytes(seed):
    """Leaving the block writes 0 to exactly the bytes no range covered,
    against a loop over the ranges: ranges that overlap, nest, come in any
    order, run past either end of the output or are empty."""
    rng = np.random.default_rng(seed)
    for _ in range(500):
        size = int(rng.integers(0, 40))
        ranges = rng.integers(-5, 45, (int(rng.integers(0, 6)), 2))
        want = np.zeros(size, np.uint8)
        with device.Output(size) as out:
            out.view[:] = 7
            for a, b in ranges.tolist():
                want[max(a, 0) : max(b, 0)] = 7
                assert out.part(a, b).size == max(0, min(b, size) - max(a, 0))
        assert out.result == want.tobytes(), (size, ranges)


def test_a_raising_body_releases_the_view_and_gives_no_bytes():
    """A raise inside the block drops the view and the `bytes` (the payload
    is freed, nothing holds it) and leaves no `result`."""
    before = dict(device.OUTPUT_COUNTS)
    out = device.Output(1 << 20)
    holder = out.view.base
    refs = sys.getrefcount(holder)
    with pytest.raises(ValueError, match="inside"):
        with out:
            out.part(0, 10)[:] = 1
            raise ValueError("inside")
    assert out.view is None and not hasattr(out, "result")
    assert sys.getrefcount(holder) == refs - 1  # the view was the only other reference
    del out
    obj = holder.obj
    refs = sys.getrefcount(obj)
    assert refs == 3  # `holder`, this name and the call's argument: nothing else holds the `bytes`
    assert device.OUTPUT_COUNTS["in_place"] - before["in_place"] == 1
