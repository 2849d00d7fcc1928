"""The port's CLI (`hsrans_tpu_torch/cli.py`) against the JAX package's
(`hsrans_tpu/cli.py`): the same parse for the same argv, the same rows and
the same bytes row for row, its deliberate differences (no card means no
table; the mt dev row without a host fallback), the numpy tier's tpx rows
on the numpy tpx codec as the JAX CLI's, and the profiler
(`utils/profiling.py`)."""

import json

import numpy as np
import pytest
import torch

from hsrans_tpu import cli as jcli
from hsrans_tpu_torch import cli as pcli
from tools.gen_inputs import text_like

ARGVS = [
    [],
    ["f.bin"],
    ["f.bin", "--test"],
    ["f.bin", "--all", "--runs", "5"],
    ["f.bin", "--test", "--hist-min", "11", "--hist-max", "13", "--runs-enc", "2", "--runs-dec", "4"],
    ["f.bin", "--exclude-raw", "--include-32blk", "--include-mt", "--exclude-block", "--exclude-tpx"],
    ["f.bin", "--exclude-16", "--exclude-32", "--exclude-dev", "--include-64"],
    ["--no-sleep", "--low-mem", "--cpu-core", "3", "f.bin"],
    ["f.bin", "--test", "--exclude-blk32", "--runs", "7"],  # --test forces runs=1 only where it comes later
    ["f.bin", "--runs", "7", "--test"],
    ["f.bin", "--backend", "numpy"],
    ["f.bin", "--backend", "interpret"],
    ["f.bin", "--backend", "device"],
] + [
    order
    for level in ("none", "scalar", "sse2", "sse4.1", "avx", "avx2", "avx512f", "avx512bw")
    for backend in ("auto", "device", "interpret", "numpy")
    for order in (["f.bin", "--backend", backend, "--max-simd", level], ["f.bin", "--max-simd", level, "--backend", backend])
]


@pytest.mark.parametrize("argv", ARGVS, ids=" ".join)
def test_parse_args_equals_original(argv, capsys):
    """Every flag, the key mangling of --include-/--exclude-, --test's
    forcing and the order-independent --max-simd downgrade, warnings
    included."""
    want = jcli.parse_args(list(argv))
    want_err = capsys.readouterr().err
    assert pcli.parse_args(list(argv)) == want
    assert capsys.readouterr().err == want_err


@pytest.fixture(scope="module")
def small_file(tmp_path_factory):
    f = tmp_path_factory.mktemp("cli") / "t.bin"
    text_like(np.random.default_rng(0), 20_000).tofile(f)
    return f


@pytest.mark.parametrize("backend", ("numpy", "interpret"))
def test_cli_test_mode_round_trips(small_file, backend, capsys):
    """`--test` at B=12 on a 20 KB file: every row OK, exit 0; the same row
    names and ratios as the JAX CLI at its numpy tier."""
    rows = []
    assert pcli.main([str(small_file), "--test", "--backend", backend, "--hist-min", "12", "--hist-max", "12"],
                     on_row=rows.append) == 0
    out = capsys.readouterr().out
    assert "--test: ALL OK" in out and all(r["ok"] for r in rows)
    assert jcli.main([str(small_file), "--test", "--backend", "numpy", "--hist-min", "12", "--hist-max", "12"]) == 0
    want = {line[:28].strip(): line[28:38].strip() for line in capsys.readouterr().out.splitlines() if line.endswith("  OK")}
    got = {line[:28].strip(): line[28:38].strip() for line in out.splitlines() if line.endswith("  OK")}
    extra = {"mt rANS32x64 16w dev 12"} if backend == "interpret" else set()
    assert set(got) == set(want) | extra and len(want) == 11
    assert all(got[k] == want[k] for k in want)


@pytest.mark.parametrize("bits", (10, 12, 15))
def test_rows_encode_equal_original(bits):
    """Each row's blob at the torch tier (and the port's numpy tier) equals
    the JAX CLI's row of the same name at its numpy tier, and decodes back;
    the torch tier adds the mt dev row, which round-trips."""
    data = text_like(np.random.default_rng(bits), 9000)
    argv = ["f", "--test", "--hist-min", str(bits), "--hist-max", str(bits), "--backend"]
    want = {c["name"]: c["enc"](data) for c in jcli._build_codecs(jcli.parse_args(argv + ["numpy"]))}
    for backend in ("interpret", "numpy"):
        got = {c["name"]: c for c in pcli._build_codecs(pcli.parse_args(argv + [backend]))}
        for name, blob in want.items():
            assert got[name]["enc"](data) == blob, (backend, name)
            assert got[name]["dec"](blob) == data.tobytes(), (backend, name)
        assert set(got) - set(want) == ({f"mt rANS32x64 16w dev {bits}"} if backend == "interpret" else set())
    torch_rows = {c["name"]: c for c in pcli._build_codecs(pcli.parse_args(argv + ["interpret"]))}
    dev = torch_rows[f"mt rANS32x64 16w dev {bits}"]
    assert dev["dec"](dev["enc"](data)) == data.tobytes()


@pytest.mark.parametrize("backend", ("auto", "device"))
def test_no_card_exits_nonzero_without_a_table(small_file, backend, capsys):
    """Deliberate difference: where the JAX CLI picks its numpy tier off a
    TPU, the port's `auto` and `device` need the card and print no table."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert pcli.main([str(small_file), "--test", "--backend", backend]) != 0
    cap = capsys.readouterr()
    assert "CUDA card" in cap.err and "codec" not in cap.out and "%" not in cap.out


def test_numpy_tier_runs_tpx_rows_on_the_torch_tier(small_file, monkeypatch, capsys):
    """No longer a difference (the name is kept): at the numpy tier the tpx
    rows run the port's numpy tpx codec, as the JAX CLI's run its own
    (`hsrans_tpu/cli.py:110-117`), never the torch tier, and the banner
    carries no note; the host rows run the numpy codecs, not native."""
    from hsrans_tpu_torch.kernels import tpx_decode, tpx_encode
    from hsrans_tpu_torch.ops import reference, tpx
    from hsrans_tpu_torch.runtime import native

    calls = []
    for mod, name in ((tpx_encode, "tpx_encode_torch"), (tpx_encode, "tpx_encode_adaptive_torch"),
                      (tpx_decode, "tpx_decode_torch")):
        monkeypatch.setattr(mod, name, lambda *a, **kw: pytest.fail("a tpx row ran the torch tier at the numpy tier"))
    for name in ("tpx_encode", "tpx_encode_adaptive", "tpx_decode"):
        real = getattr(tpx, name)
        monkeypatch.setattr(tpx, name, lambda *a, real=real, name=name, **kw: calls.append(name) or real(*a, **kw))
    monkeypatch.setattr(native, "load", lambda: pytest.fail("the numpy tier loaded the native library"))
    monkeypatch.setattr(reference, "raw_encode", lambda *a: pytest.fail("native raw row at the numpy tier"))
    assert pcli.main([str(small_file), "--test", "--backend", "numpy", "--hist-min", "12", "--hist-max", "12"]) == 0
    out = capsys.readouterr().out
    assert "tier 'numpy'" in out and "tpx rows" not in out and "torch" not in out.splitlines()[0]
    assert sorted(calls) == ["tpx_decode", "tpx_decode", "tpx_encode", "tpx_encode_adaptive"]
    assert "dev 12" not in out and "tpx rANS32x128x1024 12" in out and "tpx adaptive (v3) 12" in out


def test_mt_dev_row_has_no_host_fallback(small_file, monkeypatch, capsys):
    """Where the JAX row decodes with the oracle when its kernel path gives
    None, the port's row reports a MISMATCH and exits 1."""
    from hsrans_tpu_torch.kernels import mt_decode
    from hsrans_tpu_torch.ops import mt

    monkeypatch.setattr(mt_decode, "mt_decode_torch", lambda *a, **kw: None)
    host_calls = []
    real = mt.mt_decode
    monkeypatch.setattr(mt, "mt_decode", lambda *a: host_calls.append(a[2]) or real(*a))
    argv = [str(small_file), "--test", "--backend", "interpret", "--hist-min", "12", "--hist-max", "12",
            "--exclude-raw", "--exclude-32blk", "--exclude-block", "--exclude-tpx", "--exclude-32"]
    rows = []
    assert pcli.main(argv, on_row=rows.append) == 1
    out = capsys.readouterr().out
    assert [(r["name"], r["ok"]) for r in rows] == [("mt rANS32x64 16w 12", True), ("mt rANS32x64 16w dev 12", False)]
    assert host_calls == [64]  # the host row's decode only
    assert "MISMATCH" in out and "1 FAILURES" in out


def test_width_filters_and_exclude_dev():
    a = pcli.parse_args(["f", "--test", "--hist-min", "12", "--hist-max", "12", "--exclude-16", "--exclude-32",
                         "--exclude-tpx", "--backend", "numpy"])
    names = [c["name"] for c in pcli._build_codecs(a)]
    assert names and all("x64" in n for n in names)
    a = pcli.parse_args(["f", "--test", "--hist-min", "12", "--hist-max", "13", "--backend", "interpret"])
    names = [c["name"] for c in pcli._build_codecs(a)]
    assert len(names) == 24 and names.count("mt rANS32x64 16w dev 13") == 1
    a["dev"] = False
    assert "mt rANS32x64 16w dev 12" not in [c["name"] for c in pcli._build_codecs(a)]


def test_usage_without_a_file(capsys):
    assert pcli.main([]) == 2 == jcli.main([])
    assert "--backend" in capsys.readouterr().out


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path, capsys):
    """`trace()` records CPU activity where there is no card, says so, and
    writes a Chrome trace that `device_busy` reads (no device events on the
    CPU: busy 0 over the traced span)."""
    from hsrans_tpu_torch import tpx_decode_torch, tpx_encode_torch
    from hsrans_tpu_torch.utils.profiling import device_busy, trace

    data = text_like(np.random.default_rng(3), 5000)
    with trace(tmp_path / "tr") as t:
        assert tpx_decode_torch(tpx_encode_torch(data, device="cpu"), device="cpu") == data.tobytes()
    assert t.path.exists() and t.path.parent == tmp_path / "tr" and t.wall_s > 0
    events = json.loads(t.path.read_text())["traceEvents"]
    assert any(e.get("ph") == "X" for e in events)
    if not torch.cuda.is_available():
        assert "CPU activity only" in capsys.readouterr().err and not t.cuda
        busy = device_busy(t.path)
        assert busy["busy_us"] == 0 and busy["events"] == 0 and busy["span_us"] > 0


def test_device_busy_counts_overlaps_once(tmp_path):
    trace = {"traceEvents": [
        {"ph": "X", "cat": "kernel", "ts": 100, "dur": 50},
        {"ph": "X", "cat": "gpu_memcpy", "ts": 120, "dur": 60},  # overlaps the kernel by 30
        {"ph": "X", "cat": "gpu_memset", "ts": 300, "dur": 10},
        {"ph": "X", "cat": "cpu_op", "ts": 0, "dur": 400},
        {"ph": "i", "cat": "kernel", "ts": 500},
    ]}
    path = tmp_path / "t.json"
    path.write_text(json.dumps(trace))
    from hsrans_tpu_torch.utils.profiling import device_busy

    got = device_busy(path)
    assert got["busy_us"] == 90 and got["span_us"] == 400 and got["events"] == 3
    assert (got["kernel_us"], got["gpu_memcpy_us"], got["gpu_memset_us"]) == (50, 60, 10)


def test_timing_helpers_equal_original():
    from hsrans_tpu.utils import profiling as jp
    from hsrans_tpu_torch.utils import profiling as pp

    calls = []
    t = pp.time_min(lambda: calls.append(1), runs=4, warmup=2)
    assert len(calls) == 6 and t.runs == 4 and 0 <= t.min_s <= t.mean_s
    assert t.mib_s(1 << 20) == 1 / t.min_s
    assert pp.Timing.__dataclass_fields__.keys() == jp.Timing.__dataclass_fields__.keys()
    slope = pp.slope_per_pass(lambda n: (lambda: sum(range(n * 20000))), lo=1, hi=5, runs=2)
    assert slope > 0
