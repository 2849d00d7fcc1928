"""The harness on the CPU: what it loads by name, what it makes from a
seed, how it reads a trace and counts bytes, the line it prints, and that
`correct` comes out false for the control and for a broken timed path.

Runs go through the program's plain PyTorch tier (device "cpu") at small
sizes; the card's runs are `test_gpubench_card.py`'s."""

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from gpubench import control, guard, roofline, run, trace
from gpubench.judge import bytes_off

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
SMALL = {"object_bytes": 1 << 16, "generator_params": {"side": 64}}
CPU = torch.device("cpu")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def small(name: str) -> run.Cell:
    return run.Cell.load(name, config=SMALL)


def one_run(name: str, traced: bool = False, fault=None, seed: int = 2**33 + 5) -> dict:
    result, _ = run.run_cell(small(name), seed, 0.3, traced, CPU, fault=fault, t0=0.0)
    return result


@pytest.mark.parametrize("generator, params", [("text_like", {}), ("xray", {"side": 64})])
def test_generators_give_the_same_bytes_for_a_seed(generator, params):
    gen = run.load_module(ROOT / "gpubench" / "data" / f"{generator}.py")

    def make(seed, n=50001):
        g = torch.Generator()
        g.manual_seed(seed)
        return gen.make(g, n, CPU, params).numpy().tobytes()

    a, b, c = make(7), make(7), make(8)
    assert len(a) == 50001 and a == b and a != c


def test_objects_and_schedule_follow_the_seed():
    cell = small("tpx_text_encode_100m")
    big = 2**40 + 11
    assert run.make_objects(cell, big, CPU) == run.make_objects(cell, big, CPU)
    assert run.make_objects(cell, big, CPU) != run.make_objects(cell, big + 1, CPU)
    s1, s2 = run.schedule(cell, 1), run.schedule(cell, 2)
    assert sorted(s1) == sorted(s2) == [("encode", k) for k in range(4)]
    assert run.schedule(cell, 1) == s1


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_loads_what_it_names(name):
    cell = run.Cell.load(name)
    w = next(w for w in BENCH["workloads"] if w["name"] == name)
    cfg_entry = next(c for c in BENCH["configs"] if c["name"] == w["config"])
    assert cell.config["name"] == w["config"]
    assert sorted(cell.config["reduced"]) == sorted(cfg_entry["reduced"])
    assert Path(ROOT / cfg_entry["file"]).is_file()
    assert all(hasattr(cell.wire, f) for f in ("encode", "decode", "ref_encode", "ref_decode", "tables"))
    assert hasattr(cell.generator, "make")
    assert set(cell.traffic["ops"]) <= {"encode", "decode"}
    assert cell.end_to_end == [m["name"] for m in BENCH["end_to_end"]] == ["throughput_MiBps", "setup_s"]
    assert cell.per_layer and all(callable(m.read) for m in cell.per_layer.values())
    assert len(cell.sizes()) == cell.traffic["objects"] >= 4


def test_benchmark_json_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"][1].startswith(BENCH["paths"][0] + "/")
    cells = len(BENCH["workloads"])
    assert 1 <= BENCH["run_seconds"] <= 51
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert 1 <= cells <= 24 and all(w["chips"] == 1 for w in BENCH["workloads"])
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer") for x in BENCH[key]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == cells
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and c["file"].startswith("gpubench/")
        assert len(c["source"]) <= 200 and len(c["why"]) <= 200
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and len(w["why"]) <= 200
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"] if "workloads" in m else CELLS) <= set(CELLS)
        assert (ROOT / "gpubench" / "metrics" / f"{m['name']}.py").is_file()
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 << 10


def test_import_guard_compares_whole_top_level_names():
    assert guard.forbidden(["hsrans_tpu_torch", "hsrans_tpu_torch.kernels.tpx_decode", "numpy", "jaxtyping"]) == []
    assert guard.forbidden(["hsrans_tpu.ops", "jax", "jaxlib", "jax.numpy", "hsrans_tpu_torch"]) == [
        "hsrans_tpu.ops", "jax", "jax.numpy", "jaxlib"]
    assert guard.forbidden(["hsrans_tpu"]) == ["hsrans_tpu"]


def test_roofline_counts_each_byte_once():
    assert roofline.call_bytes(64 << 20, 41_000_000, 16) == (64 << 20) + 41_000_000 + 16 * 1024
    assert roofline.least_seconds(3_350_000_000, "NVIDIA H100 80GB HBM3") == pytest.approx(1e-3)
    assert roofline.least_seconds(1, "cpu") is None


def write_trace(path: Path) -> None:
    """A hand-made Chrome trace: a window on the host thread, two calls,
    kernels and copies on the card, one copy partly outside the window."""
    host = dict(ph="X", pid=1, tid=7)
    ev = [
        dict(host, name="gpubench.window", cat="user_annotation", ts=100, dur=100),
        dict(host, name="gpubench.call.decode", cat="user_annotation", ts=100, dur=50),
        dict(host, name="aten::copy_", cat="cpu_op", ts=110, dur=20),
        dict(host, name="cudaMemcpyAsync", cat="cuda_runtime", ts=112, dur=15),
        dict(host, name="gpubench.call.decode", cat="user_annotation", ts=150, dur=50),
        dict(ph="X", pid=0, tid=3, name="Memcpy HtoD", cat="gpu_memcpy", ts=90, dur=20),
        dict(ph="X", pid=0, tid=3, name="decode_kernel", cat="kernel", ts=120, dur=10),
        dict(ph="X", pid=0, tid=3, name="decode_kernel", cat="kernel", ts=125, dur=10),
        dict(ph="X", pid=0, tid=3, name="Memset", cat="gpu_memset", ts=170, dur=5),
        dict(ph="X", pid=0, tid=3, name="gpubench.call.decode", cat="gpu_user_annotation", ts=100, dur=100),
    ]
    path.write_text(json.dumps({"traceEvents": ev}))


def test_trace_reading_on_a_hand_made_trace(tmp_path):
    write_trace(tmp_path / "t.json")
    r = trace.read(tmp_path / "t.json", "gpubench.window")
    assert r.window_us == 100
    assert r.busy_us == 10 + 15 + 5  # [100, 110) clipped, [120, 135) once, [170, 175)
    assert r.kernel_us == 20
    assert r.device_ops == {"Memcpy HtoD": 10, "decode_kernel": 20, "Memset": 5}
    assert r.idle == {"gpubench.call.decode": 15 + 20 + 25, "cudaMemcpyAsync": 8, "aten::copy_": 2}
    assert sum(r.idle.values()) == r.window_us - r.busy_us
    assert trace.top({"a": 2e6, "b": 3e6, "c": 1e6}, k=2) == [["b", 3.0], ["a", 2.0]]
    assert trace.read(tmp_path / "t.json", "no such range") is None
    assert trace.union_us([(0, 10), (5, 20), (30, 31)]) == 21


def test_sampler_keeps_a_seeded_sample_and_the_last_call():
    def drawn(seed):
        s = run.Sampler(2, seed)
        for i in range(50):
            s.offer("decode", i % 4, i)
        return [x[0] for x in s.sample()]

    assert drawn(3) == drawn(3) and drawn(3)[-1] == 49 and len(drawn(3)) == 3
    assert len({tuple(drawn(s)) for s in range(20)}) > 5


def test_bytes_off_counts_every_differing_byte():
    assert bytes_off(b"abcd", b"abcd") == 0
    assert bytes_off(b"abXd", b"abcd") == 1
    assert bytes_off(b"ab", b"abcd") == 2
    assert bytes_off(None, b"abcd") == 4


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_the_result_line_has_exactly_the_contracts_keys(name, traced):
    r = one_run(name, traced)
    assert list(r) == RESULT_KEYS[:5] + (["breakdown"] if traced else []) + RESULT_KEYS[5:]
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    cell = run.Cell.load(name)
    want = set(cell.per_layer) if traced else set(cell.end_to_end)
    assert set(r["metrics"]) <= want and all(set(m) == {"value", "unit"} for m in r["metrics"].values())
    if not traced:
        assert set(r["metrics"]) == want
    else:  # all but the card's readings, which the CPU has none of
        assert want - {"kernels_roofline", "device_idle_pct"} <= set(r["metrics"])
    dev = {"platform", "kind", "count", "memory_peak_bytes"} | ({"busy_s", "window_s"} if traced else set())
    assert dev <= set(r["device"])
    if traced:
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in r["breakdown"].values())
    assert all(set(c) == {"value", "limit"} for c in r["checks"].values())
    json.dumps(r)


def flip(op, given, out):
    b = bytearray(out)
    b[len(b) // 2] ^= 1
    return bytes(b)


def half(op, given, out):
    return out[: len(out) // 2] + bytes(len(out) - len(out) // 2)


def unchanged(op, given, out):
    return given


@pytest.mark.parametrize("fault", [flip, half, unchanged], ids=["answer_altered", "half_left_out", "input_returned"])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_reads_incorrect(name, fault):
    r = one_run(name, fault=fault)
    assert r["correct"] is False
    assert max(c["value"] - c["limit"] for c in r["checks"].values()) > 0


@pytest.mark.parametrize("name", CELLS)
def test_the_control_reads_incorrect_where_the_program_reads_correct(name):
    line = control.readings(small(name), 2**31 + 9, 0.2, CPU)
    assert all(v == 0 for v in line["program"].values())
    assert any(v > line["limit"][n] for n, v in line["control"].items())


def test_no_card_no_result(capsys):
    assert run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"]) == 2
    assert capsys.readouterr().out == ""


def test_the_benchmark_alone_fails_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "gpubench", tmp_path / "gpubench", ignore=shutil.ignore_patterns("__pycache__"))
    res = subprocess.run([sys.executable, "gpubench/run.py", "--workload", CELLS[0], "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and res.stdout == ""
