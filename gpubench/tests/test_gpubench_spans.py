"""The reader of the program's ranges (`gpubench/spans.py`), the four
metrics that read it and its `gpubench spans:` line: on a hand-made trace on the CPU, and on the card
each cell's traced run at a small size (marked `cuda`: run with
`python -m pytest gpubench/tests -m cuda` on a machine with an NVIDIA
card; elsewhere it skips)."""

import json
from pathlib import Path

import pytest
import torch

from gpubench import run, spans, trace

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
SPAN_METRICS = ["prep_span_ms", "copy_span_ms", "assemble_span_ms", "plan_span_ms"]
CARD_ONLY = ["copy_GBps", "launches_per_call"]  # on the `gpubench spans:` line
WINDOW = "gpubench.window"


def write_trace(path: Path, program: bool = True) -> None:
    """A window of two harness calls: the first a decode with nested program
    ranges, a copy each way and a kernel, each linked to its launch by
    `correlation`; the second with no program range, a kernel launched in
    it and one whose launch the trace lacks.  Without `program`, the same
    with no `hsrans.*` range (a program that opens none)."""
    host = dict(ph="X", pid=1, tid=7)
    card = dict(ph="X", pid=0, tid=3)
    ranges = [
        dict(host, name="hsrans.tpx_decode_torch", cat="user_annotation", ts=10, dur=480),
        dict(host, name="hsrans.host_parse", cat="user_annotation", ts=20, dur=30),
        dict(host, name="hsrans.h2d", cat="user_annotation", ts=60, dur=100),
        dict(host, name="hsrans.kernel", cat="user_annotation", ts=170, dur=20),
        dict(host, name="hsrans.d2h", cat="user_annotation", ts=200, dur=200),
        dict(host, name="hsrans.inner", cat="user_annotation", ts=350, dur=40),
        dict(host, name="hsrans.host_assemble", cat="user_annotation", ts=410, dur=70),
        dict(card, name="hsrans.h2d", cat="gpu_user_annotation", ts=80, dur=60),
    ]
    ev = [
        dict(host, name=WINDOW, cat="user_annotation", ts=0, dur=1000),
        dict(host, name="gpubench.call.decode", cat="user_annotation", ts=0, dur=500),
        dict(host, name="cudaMemcpyAsync", cat="cuda_runtime", ts=70, dur=80, args={"correlation": 1}),
        dict(host, name="cudaLaunchKernel", cat="cuda_runtime", ts=175, dur=5, args={"correlation": 2}),
        dict(host, name="cudaMemcpyAsync", cat="cuda_runtime", ts=210, dur=100, args={"correlation": 3}),
        dict(host, name="cudaStreamSynchronize", cat="cuda_runtime", ts=311, dur=1, args={"correlation": 5}),
        dict(host, name="gpubench.call.decode", cat="user_annotation", ts=500, dur=500),
        dict(host, name="cudaLaunchKernel", cat="cuda_runtime", ts=600, dur=5, args={"correlation": 4}),
        dict(card, name="Memcpy HtoD (Pageable -> Device)", cat="gpu_memcpy", ts=80, dur=60,
             args={"correlation": 1, "bytes": 6000}),
        dict(card, name="decode_kernel", cat="kernel", ts=185, dur=10, args={"correlation": 2}),
        dict(card, name="Memcpy DtoH (Device -> Pageable)", cat="gpu_memcpy", ts=220, dur=80,
             args={"correlation": 3, "bytes": 8000}),
        dict(card, name="decode_kernel", cat="kernel", ts=610, dur=20, args={"correlation": 4}),
        dict(card, name="decode_kernel", cat="kernel", ts=700, dur=30, args={}),
    ]
    path.write_text(json.dumps({"traceEvents": ev + (ranges if program else [])}))


def readings(path: Path) -> run.Readings:
    return run.Readings([], trace.read(path, WINDOW), [], 0, "cpu")


def reader(name: str):
    return run.load_module(ROOT / "gpubench" / "metrics" / f"{name}.py")


def test_spans_read_a_hand_made_trace(tmp_path):
    write_trace(tmp_path / "t.json")
    s = spans.read(tmp_path / "t.json", WINDOW)
    assert [(c[0], len(c[3])) for c in s.calls] == [("gpubench.call.decode", 7), ("gpubench.call.decode", 0)]
    assert s.roots == 1
    assert s.self_us == {"hsrans.tpx_decode_torch": 60, "hsrans.host_parse": 30, "hsrans.h2d": 100,
                         "hsrans.kernel": 20, "hsrans.d2h": 160, "hsrans.inner": 40, "hsrans.host_assemble": 70}
    assert s.dur_us["hsrans.tpx_decode_torch"] == 480 and s.dur_us["hsrans.d2h"] == 200
    assert s.device_us == {"hsrans.h2d": 60, "hsrans.kernel": 10, "hsrans.d2h": 80, "outside_program": 20}
    assert (s.device_total_us, s.unattributed_us, s.unattributed_pct()) == (200, 30, 15.0)
    assert s.launches == 1  # the second call's kernel was launched outside every program range
    assert s.syncs == 1 and s.call_ms() == pytest.approx(0.5)
    assert s.copy_bytes == {"hsrans.h2d": 6000, "hsrans.d2h": 8000}
    assert s.copy_us == {"hsrans.h2d": 60, "hsrans.d2h": 80}
    assert s.idle_us == {"outside_program": 470, "hsrans.tpx_decode_torch": 55, "hsrans.host_parse": 30,
                         "hsrans.h2d": 40, "hsrans.kernel": 15, "hsrans.d2h": 80, "hsrans.inner": 40,
                         "hsrans.host_assemble": 70}
    assert sum(s.idle_us.values()) == 1000 - 200
    assert s.idle_ms_by_span()["outside_program"] == pytest.approx(0.235)
    assert spans.read(tmp_path / "t.json", "no such range") is None


def test_trace_read_carries_the_spans_and_prints_the_idle_split(tmp_path, capsys):
    write_trace(tmp_path / "t.json")
    reading = trace.read(tmp_path / "t.json", WINDOW)
    assert reading.busy_us == 200 and reading.spans.roots == 1
    line = [x for x in capsys.readouterr().err.splitlines() if x.startswith("gpubench spans: ")]
    got = json.loads(line[-1][len("gpubench spans: "):])
    assert got["calls"] == 2 and got["syncs_per_call"] == 0.5
    assert got["idle_ms_by_span"]["hsrans.host_assemble"] == pytest.approx(0.035)
    assert got["device_ms_by_span"] == pytest.approx({"hsrans.d2h": 0.04, "hsrans.h2d": 0.03, "outside_program": 0.01,
                                                      "hsrans.kernel": 0.005})
    assert (got["copy_GBps"], got["launches_per_call"]) == pytest.approx((0.1, 0.5))


def test_the_span_metrics_on_a_hand_made_trace(tmp_path):
    write_trace(tmp_path / "t.json")
    r = readings(tmp_path / "t.json")
    got = {name: reader(name).read(r) for name in SPAN_METRICS}
    assert got == pytest.approx({"prep_span_ms": 0.015, "copy_span_ms": 0.13, "assemble_span_ms": 0.035,
                                 "plan_span_ms": None})
    assert not set(CARD_ONLY) & {m["name"] for m in BENCH["per_layer"]}  # a run without a card fills every listed one


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_each_span_metric_reads_none_without_its_spans(tmp_path, name):
    write_trace(tmp_path / "t.json", program=False)
    assert reader(name).read(readings(tmp_path / "t.json")) is None
    assert reader(name).read(run.Readings([], None, [], 0, "cpu")) is None
    entry = next(m for m in BENCH["per_layer"] if m["name"] == name)
    assert entry["moves"] == "throughput_MiBps" and entry["source"] in ("program_span", "device_trace")


@pytest.mark.parametrize("name", CARD_ONLY)
def test_each_card_reading_is_none_without_the_programs_ranges_or_the_card(tmp_path, name):
    write_trace(tmp_path / "t.json", program=False)
    assert getattr(spans.read(tmp_path / "t.json", WINDOW), name)() is None
    write_trace(tmp_path / "t.json")
    s = spans.read(tmp_path / "t.json", WINDOW)
    s.device_total_us, s.copy_bytes, s.copy_us = 0.0, {}, {}  # a run without a card: no event on it
    assert getattr(s, name)() is None


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_each_cells_traced_run_reads_its_span_metrics(card, name, capsys):
    cell = run.Cell.load(name, config={"object_bytes": 3 << 20, "generator_params": {"side": 512}})
    result, info = run.run_cell(cell, 2**32 + 19, 1.0, True, card, t0=0.0)
    assert result["correct"] is True, (result["checks"], info["errors"])
    want = [m for m in SPAN_METRICS if m in cell.per_layer]
    assert want and all(result["metrics"].get(m, {}).get("value") is not None for m in want), result["metrics"]
    line = [x for x in capsys.readouterr().err.splitlines() if x.startswith("gpubench spans: ")]
    got = json.loads(line[-1][len("gpubench spans: "):])
    assert got["launches_per_call"] >= 1 and got["copy_GBps"] > 0, got
