"""The port's profiler ranges (`runtime/device.py::layer_clock`, `span`,
`entry_span`).  Under `torch.profiler` each public call leaves one root
range `hsrans.<entry point>` with every `hsrans.*` range of the call inside
it and a range `hsrans.<key>` for each key that `layers=` reports, and the
card is never synchronized; with no profiler and no `layers=`, no range is
entered.  All on the CPU tier."""

import json
from functools import cache

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from hsrans_tpu_torch import make_hist, mt_decode_torch, mt_encode_torch, raw_decode_torch, raw_encode_torch
from hsrans_tpu_torch import raw_decode_16w, raw_encode_16w, tpx_decode_torch, tpx_encode_adaptive_torch, tpx_encode_torch
from hsrans_tpu_torch.ops import raw_scan
from hsrans_tpu_torch.parallel import sharded
from hsrans_tpu_torch.parallel.sharded import device_plan, mt_decode_device, mt_encode_device
from hsrans_tpu_torch.runtime.device import layer_clock


@cache
def data() -> bytes:
    """Text-like bytes: the greedy planner's coded rows are longer than
    `MAX_BLOCK`, so `device_plan` cuts them and takes the pieces'
    histograms."""
    rng = np.random.default_rng(19)
    return (rng.zipf(1.3, 60_000).clip(1, 60).astype(np.uint8) + 32).tobytes()


MAX_BLOCK = 4096


@cache
def plan():
    return device_plan(np.frombuffer(data(), np.uint8), 12, 64, MAX_BLOCK)


@cache
def tpx_blob() -> bytes:
    return tpx_encode_torch(data(), 12, device="cpu")


@cache
def mt_blob() -> bytes:
    return mt_encode_torch(data(), 12, plan=plan(), device="cpu")


def raw_data() -> bytes:
    """The raw calls' input: a short prefix, since the plain scan runs one
    group of torch ops a link, each recorded under the profiler."""
    return data()[:6000]


@cache
def hist():
    return make_hist(np.frombuffer(raw_data(), np.uint8), 12)


@cache
def raw_blob() -> bytes:
    return raw_encode_torch(raw_data(), hist(), 64, device="cpu")


def mt16_data() -> bytes:
    """The 16-state mt calls' input: one greedy block cut into four pieces
    of 128 links each (the plain scans, like the raw calls', record one
    group of torch ops a link)."""
    return data()[:8192]


@cache
def plan16():
    return device_plan(np.frombuffer(mt16_data(), np.uint8), 12, 16, MAX_BLOCK // 2)


@cache
def mt16_blob() -> bytes:
    return mt_encode_device(mt16_data(), 12, 16, plan=plan16(), device="cpu")


def rows(plan) -> list[tuple]:
    """A plan's rows as comparable tuples."""
    return [(r.start, r.size, r.is_single, r.symbol, None if r.freq is None else r.freq.tolist()) for r in plan]


# each entry point on the CPU tier, with `layers` where it takes them
CALLS = {
    "tpx_encode_torch": lambda layers: tpx_encode_torch(data(), 12, device="cpu", layers=layers),
    "tpx_encode_adaptive_torch": lambda layers: tpx_encode_adaptive_torch(data(), 12, device="cpu", layers=layers),
    "tpx_decode_torch": lambda layers: tpx_decode_torch(tpx_blob(), device="cpu", layers=layers),
    "mt_encode_torch": lambda layers: mt_encode_torch(data(), 12, plan=plan(), device="cpu", layers=layers),
    "mt_decode_torch": lambda layers: mt_decode_torch(mt_blob(), 12, 64, device="cpu", layers=layers),
    "device_plan": lambda layers: rows(device_plan(np.frombuffer(data(), np.uint8), 12, 64, MAX_BLOCK)),
    "raw_encode_torch": lambda layers: raw_encode_torch(raw_data(), hist(), 64, device="cpu", layers=layers),
    "raw_decode_torch": lambda layers: raw_decode_torch(raw_blob(), 12, 64, device="cpu", layers=layers),
    "mt_encode_device": lambda layers: mt_encode_device(mt16_data(), 12, 16, plan=plan16(), device="cpu", layers=layers),
    "mt_decode_device": lambda layers: mt_decode_device(mt16_blob(), 12, 16, device="cpu", layers=layers),
}
# ranges a call must open beside the keys `layers=` reports
MORE = {"device_plan": {"hsrans.plan_greedy", "hsrans.plan_hist"},
        "tpx_encode_adaptive_torch": {"hsrans.host_geometry"},
        "raw_decode_torch": {"hsrans.host_release"}}
# the layers each raw entry point reports, and so the ranges it opens
RAW_LAYERS = {"raw_encode_torch": {"host_layout", "h2d", "gather", "kernel_scan", "d2h", "host_mux"},
              "raw_decode_torch": {"host_parse", "host_tables", "h2d", "kernel_scan", "gather", "d2h", "host_assemble"}}
# the layers of the 16-state mt device calls: encode_plan's, and the batched scan route's
MT16_LAYERS = {"mt_encode_device": {"host_index", "h2d", "kernel_hist", "kernel_encode", "host_layout", "kernel_place",
                                    "d2h", "host_mux"},
               "mt_decode_device": {"host_index", "host_tables", "h2d", "kernel_scan", "d2h", "host_assemble"}}


def expected(name: str):
    """The call's answer with no profiler (its operands made first, outside
    any profiler)."""
    return CALLS[name](None)


def ranges(prof) -> list[tuple[str, float, float]]:
    """The `hsrans.*` ranges the profiler recorded: (name, start, end)."""
    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events() if e.name.startswith("hsrans.")]


def profiled(name: str, layers):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = CALLS[name](layers)
    return out, ranges(prof)


def boom(*args, **kwargs):
    raise RuntimeError("not to be called here")


@pytest.mark.parametrize("name", list(CALLS))
def test_one_root_holds_every_range_and_each_layer(name):
    want, layers = expected(name), {}
    out, got = profiled(name, layers)
    assert out == want
    roots = [r for r in got if not any(o is not r and o[1] <= r[1] and r[2] <= o[2] for o in got)]
    assert [r[0] for r in roots] == [f"hsrans.{name}"]
    assert len(got) > 1
    names = {r[0] for r in got}
    assert {f"hsrans.{k}" for k in layers} | MORE.get(name, set()) <= names
    if name != "device_plan":
        assert layers


@pytest.mark.parametrize("name", list(CALLS))
def test_profiled_call_never_synchronizes(name, monkeypatch):
    want = expected(name)
    _, with_clocks = profiled(name, {})
    monkeypatch.setattr(torch.cuda, "synchronize", boom)
    out, got = profiled(name, None)
    assert out == want
    assert sorted({r[0] for r in got}) == sorted({r[0] for r in with_clocks})


def test_layer_clock_under_the_profiler_never_waits_for_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", boom)
    card = torch.device("cuda", 0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with layer_clock(None, "d2h", card):
            pass
        with layer_clock(None, "count", card, "hist_count"):
            pass
    assert [r[0] for r in ranges(prof)] == ["hsrans.d2h", "hsrans.hist_count"]
    with pytest.raises(RuntimeError, match="not to be called"), layer_clock({}, "d2h", card):
        pass  # the `layers=` split synchronizes, so the patch above is live


@pytest.mark.parametrize("name", list(CALLS))
def test_no_range_without_the_profiler(name, monkeypatch):
    want = expected(name)
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", boom)
    assert CALLS[name](None) == want


def test_the_profiling_scope_writes_the_ranges(tmp_path):
    from hsrans_tpu_torch.utils.profiling import trace

    want = expected("tpx_decode_torch")
    with trace(tmp_path) as t:
        assert CALLS["tpx_decode_torch"](None) == want
    names = {e.get("name") for e in json.loads(t.path.read_text())["traceEvents"] if e.get("cat") == "user_annotation"}
    assert {"hsrans.tpx_decode_torch", "hsrans.host_parse", "hsrans.d2h", "hsrans.host_assemble"} <= names


@pytest.mark.parametrize("name", list(RAW_LAYERS))
def test_raw_entry_points_report_their_layers(name):
    """`layers={}` gets exactly the raw layers; under the profiler the call
    opens its root, a range for each of them and its gaps, and no other."""
    layers = {}
    CALLS[name](layers)
    assert set(layers) == RAW_LAYERS[name]
    _, got = profiled(name, None)
    want = {f"hsrans.{k}" for k in RAW_LAYERS[name]} | MORE.get(name, set()) | {f"hsrans.{name}"}
    assert {r[0] for r in got} == want


@pytest.mark.parametrize("length", [1, 64, 65, 4097])
def test_scan_counts_count_one_chain_a_call(length):
    """Each raw call runs its scan kernel once: 1 call, 1 stream and
    ceil(length / 64) links."""
    payload = data()[:length]
    h = make_hist(np.frombuffer(payload, np.uint8), 12)
    before = {op: dict(c) for op, c in raw_scan.SCAN_COUNTS.items()}
    blob = raw_encode_torch(payload, h, 64, device="cpu")
    assert raw_decode_torch(blob, 12, 64, device="cpu", layers={}) == payload
    links = -(-length // 64)
    for op in ("encode", "decode"):
        c = raw_scan.SCAN_COUNTS[op]
        assert {k: c[k] - before[op][k] for k in c} == {"calls": 1, "streams": 1, "links": links}


@pytest.mark.parametrize("n", [16, 32, 64])
def test_raw_bytes_unchanged_without_profiler_or_layers(n, monkeypatch):
    """With no profiler and `layers=None` the raw entry points enter no
    range and give the numpy wire's bytes."""
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", boom)
    payload = np.frombuffer(data()[: 3001 + n], np.uint8)
    h = make_hist(payload, 12)
    blob = raw_encode_torch(payload, h, n, device="cpu")
    assert blob == raw_encode_16w(payload, h, n)
    assert raw_decode_torch(blob, 12, n, device="cpu") == raw_decode_16w(blob, 12, n) == payload.tobytes()


@pytest.mark.parametrize("name", list(MT16_LAYERS))
def test_mt_device_entry_points_report_their_layers(name):
    """At n = 16 `layers={}` gets exactly the call's layers and the same
    bytes; under the profiler the call opens its root and a range for each
    layer, and no other, the scan decode's launch under kernel_scan."""
    want, layers = expected(name), {}
    assert CALLS[name](layers) == want
    assert set(layers) == MT16_LAYERS[name] and all(v >= 0 for v in layers.values())
    out, got = profiled(name, None)
    assert out == want
    assert {r[0] for r in got} == {f"hsrans.{k}" for k in MT16_LAYERS[name]} | {f"hsrans.{name}"}
    root = next(r for r in got if r[0] == f"hsrans.{name}")
    assert all(root[1] <= r[1] and r[2] <= root[2] for r in got)
    assert want == (mt16_blob() if name == "mt_encode_device" else mt16_data())


def test_mt_device_counts_count_the_batched_scan_route():
    """A 16-state decode takes route (c): one scan launch over every coded
    block, each with its own table of 2^12 slots of 5 bytes, every block
    max_steps links long, every coded byte placed by the kernel; a 64-state
    blob takes route (a); a broken one counts as none."""
    rng = np.random.default_rng(26)
    arr = np.concatenate([(rng.zipf(1.3, 1 << 16).clip(1, 60) + 32).astype(np.uint8), np.zeros(1 << 18, np.uint8),
                          rng.integers(0, 256, 1 << 16).astype(np.uint8)])
    layout = device_plan(arr, 12, 16, MAX_BLOCK)
    coded, single = sum(not r.is_single for r in layout), sum(r.is_single for r in layout)
    coded_bytes = sum(r.size for r in layout if not r.is_single)
    steps = max(-(-r.size // 16) for r in layout if not r.is_single)
    blob = mt_encode_device(arr, 12, 16, plan=layout, device="cpu")
    blob64 = mt_encode_torch(data(), 12, plan=plan(), device="cpu")
    before = dict(sharded.MT_DEVICE_COUNTS), dict(raw_scan.SCAN_COUNTS["decode"])
    assert mt_decode_device(blob, 12, 16, device="cpu") == arr.tobytes()
    assert mt_decode_device(blob64, 12, 64, device="cpu") == data()
    assert mt_decode_device(blob[:-1], 12, 16, device="cpu") is None
    moved = {k: v - before[0][k] for k, v in sharded.MT_DEVICE_COUNTS.items()}
    assert single >= 1 and coded >= 2
    assert moved == {"a": 1, "b": 0, "c": 1, "none": 1, "coded": coded, "single": single,
                     "table_bytes": coded * (1 << 12) * 5, "placed_bytes": coded_bytes}
    scanned = {k: v - before[1][k] for k, v in raw_scan.SCAN_COUNTS["decode"].items()}
    assert scanned == {"calls": 1, "streams": coded, "links": coded * steps}
