"""The benchmark of `hsrans_tpu_torch` on one NVIDIA H100: one cell, one run.

    python3 gpubench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

A cell (an entry of `workloads` in BENCHMARK.json) names a configuration
(`gpubench/configs/<config>.json`: the wire and its parameters, the data
generator `gpubench/data/<generator>.py` and the object size) and a traffic
mix (`gpubench/traffic/<traffic>.json`: the operations, how many distinct
objects, how many calls the reference judges).  The wire's calls into the program and its
frozen reference codec are `gpubench/wires/<wire>.py`; each per-layer metric
is read by `gpubench/metrics/<metric>.py`.

Set-up makes the objects on the card from the seed and copies them to host
memory as the callers' bytes, makes the decode traffic's blobs with the
program's encoder, and warms every call once.  Then one client calls the
cell's entry point back to back, host bytes in and host bytes out, for
`--seconds`: `--trace 0` times every call (the end-to-end metrics);
`--trace 1` does the same (the tail of those calls), then gives another
`--seconds`, half to calls with the program's layer clocks and half to
calls under `torch.profiler` (the other per-layer metrics).  After
the window the frozen reference judges a sample of the calls' answers drawn
from the seed, with the last call's, and the run prints one JSON line.

A run with no CUDA card, or fewer than the cell asks for, fails and prints
no result; so does one that finds a module of JAX or of the JAX package
loaded once the window has closed.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# every cache of the program at a fixed place inside the checkout
os.environ["HSRANS_TPU_TORCH_BUILD_DIR"] = str(ROOT / "build" / "hsrans_tpu_torch")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["CUDA_CACHE_PATH"] = str(ROOT / "build" / "cuda_cache")
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from gpubench import guard, roofline, trace  # noqa: E402
from gpubench.judge import judge  # noqa: E402

WINDOW = "gpubench.window"


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def load_module(path: Path):
    """A module from its file, under a name of its own (file names may hold
    dots)."""
    name = "gpubench._by_name." + path.parent.name + "." + path.stem.replace(".", "_").replace("-", "_")
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


@dataclass
class Cell:
    """One workload of BENCHMARK.json with everything it names loaded."""

    name: str
    chips: int
    config: dict
    traffic: dict
    wire: object
    generator: object
    end_to_end: list[str]
    per_layer: dict[str, object]  # metric name -> its reader module

    @classmethod
    def load(cls, name: str, bench: dict | None = None, config: dict | None = None) -> "Cell":
        """The cell `name`; `config` entries replace the configuration's
        (the tests' small sizes)."""
        bench = bench or load_json(ROOT / "BENCHMARK.json")
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        w = cells[name]
        cfg = {**load_json(HERE / "configs" / f"{w['config']}.json"), **(config or {})}
        mix = load_json(HERE / "traffic" / f"{w['traffic']}.json")
        return cls(
            name, int(w["chips"]), cfg, mix,
            load_module(HERE / "wires" / f"{cfg['wire']}.py"),
            load_module(HERE / "data" / f"{cfg['generator']}.py"),
            [m["name"] for m in bench["end_to_end"] if applies(m, name)],
            {m["name"]: load_module(HERE / "metrics" / f"{m['name']}.py") for m in bench["per_layer"] if applies(m, name)},
        )

    def sizes(self) -> list[int]:
        """Each distinct object's size: the configuration's."""
        return [int(self.config["object_bytes"])] * int(self.traffic["objects"])


def sub_seed(seed: int, *path: int) -> int:
    """A 63-bit seed for `path` under the run's seed."""
    state = np.random.SeedSequence([seed % (1 << 64), *path]).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def make_objects(cell: Cell, seed: int, device: torch.device) -> list[bytes]:
    """The distinct objects as host bytes, each made on `device` from its own
    seed under the run's seed."""
    gen = torch.Generator(device=device)
    out = []
    for k, size in enumerate(cell.sizes()):
        gen.manual_seed(sub_seed(seed, k))
        out.append(cell.generator.make(gen, size, device, cell.config.get("generator_params", {})).cpu().numpy().tobytes())
    return out


def schedule(cell: Cell, seed: int) -> list[tuple[str, int]]:
    """The calls a client cycles through: every object under each
    operation as often as the mix weighs it, in an order drawn from the
    seed (every seed the same set of calls)."""
    ops = cell.traffic["ops"]
    calls = [(op, k) for op, weight in sorted(ops.items()) for _ in range(int(weight)) for k in range(len(cell.sizes()))]
    random.Random(sub_seed(seed, 1 << 20)).shuffle(calls)
    return calls


@dataclass
class Window:
    """What a window's calls leave: its seconds, each call's seconds, the
    raw bytes of the calls that answered, the failures, the layer clocks of
    each clocked call, and the roofline bytes of the profiled calls."""

    seconds: float = 0.0
    latency: list[float] = field(default_factory=list)
    raw_bytes: int = 0
    failed: int = 0
    errors: list[str] = field(default_factory=list)
    layer_calls: list[dict] = field(default_factory=list)
    traced_bytes: int = 0


class Sampler:
    """A uniform sample, drawn from the seed, of `k` of the window's calls,
    with the last call beside it (reservoir sampling: O(1) a call)."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.seen = k, random.Random(sub_seed(seed, 1 << 21)), 0
        self.kept: list[tuple[int, str, int, object]] = []
        self.last = None

    def offer(self, op: str, obj: int, out) -> None:
        item = (self.seen, op, obj, out)
        if len(self.kept) < self.k:
            self.kept.append(item)
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.k:
                self.kept[j] = item
        self.last = item
        self.seen += 1

    def sample(self) -> list[tuple[int, str, int, object]]:
        return sorted({i[0]: i for i in [*self.kept, *([self.last] if self.last else [])]}.values(), key=lambda i: i[0])


class Runner:
    """One cell's calls into the program on `device`; `fault` (the tests')
    rewrites each answer where it is produced."""

    def __init__(self, cell: Cell, seed: int, device: torch.device, fault=None):
        self.cell, self.seed, self.device, self.fault = cell, seed, device, fault
        self.objects = make_objects(cell, seed, device)
        self.calls = schedule(cell, seed)
        ops = {op for op, _ in self.calls}
        self.blobs = [cell.wire.encode(o, cell.config, device, None) for o in self.objects] if "decode" in ops else []
        self.tables: dict[tuple[str, int], int] = {}

    def call(self, op: str, k: int, layers=None):
        if op == "encode":
            given = self.objects[k]
            out = self.cell.wire.encode(given, self.cell.config, self.device, layers)
        elif op == "decode":
            given = self.blobs[k]
            out = self.cell.wire.decode(given, self.cell.config, self.device, layers)
        else:
            raise ValueError(f"unknown operation {op!r}")
        return self.fault(op, given, out) if self.fault else out

    def warm(self, count_tables: bool) -> None:
        """Every call of the schedule once; with `count_tables`, each call's
        frequency tables counted from its blob for the roofline."""
        for op, k in sorted(set(self.calls)):
            out = self.call(op, k)
            if count_tables:
                self.tables[(op, k)] = self.cell.wire.tables(out if op == "encode" else self.blobs[k])
        sync(self.device)

    def loop(self, w: Window, sampler: Sampler, seconds: float, *, clocked: bool = False, traced: bool = False) -> None:
        """Calls back to back until `seconds` have passed; the last call ends
        the window."""
        start = time.perf_counter()
        i = len(w.latency)
        while True:
            op, k = self.calls[i % len(self.calls)]
            layers = {} if clocked else None
            t0 = time.perf_counter()
            try:
                with torch.profiler.record_function(f"gpubench.call.{op}") if traced else contextlib.nullcontext():
                    out = self.call(op, k, layers)
            except Exception as e:  # a failed call counts, and the run goes on
                out = None
                if len(w.errors) < 3:
                    w.errors.append(f"{op} of object {k}: {e!r}")
            t1 = time.perf_counter()
            w.latency.append(t1 - t0)
            if out is None:
                w.failed += 1
            else:
                raw = len(self.objects[k])
                w.raw_bytes += raw
                if traced:
                    w.traced_bytes += roofline.call_bytes(raw, len(out) if op == "encode" else len(self.blobs[k]),
                                                          self.tables[(op, k)])
            if clocked:
                w.layer_calls.append(layers)
            sampler.offer(op, k, out)
            i += 1
            if t1 - start >= seconds:
                w.seconds += t1 - start
                return


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class Readings:
    """What a per-layer metric's reader reads."""

    layer_calls: list[dict]
    trace: trace.TraceReading | None
    latency: list[float]  # seconds of each call of the untraced window
    traced_bytes: int  # roofline.call_bytes of every profiled call
    device_kind: str

    def layer_ms(self, keys: tuple[str, ...]) -> float | None:
        """Mean ms a clocked call spent in the program's layers `keys`; None
        where no call has any of them."""
        if not any(k in c for c in self.layer_calls for k in keys):
            return None
        return 1e3 * sum(sum(c.get(k, 0.0) for k in keys) for c in self.layer_calls) / len(self.layer_calls)


def power_limit() -> str | None:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return res.stdout.strip() or None


def profile_window(runner: Runner, w: Window, sampler: Sampler, seconds: float) -> trace.TraceReading | None:
    """Calls under torch.profiler for `seconds`; the trace's reading."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if runner.device.type == "cuda" else [])
    sync(runner.device)
    with tempfile.TemporaryDirectory() as tmp:
        with profile(activities=acts) as prof:
            with torch.profiler.record_function(WINDOW):
                runner.loop(w, sampler, seconds, traced=True)
                sync(runner.device)
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        return trace.read(path, WINDOW)


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device: torch.device, *, fault=None,
             t0: float | None = None) -> tuple[dict, dict]:
    """One run of `cell`: set-up, the window, the judgement.  The result
    (the line that `main` prints) and what else the run saw (its stderr
    line).  `fault(op, given, answer)`, the tests', rewrites each answer
    where it is produced."""
    t0 = T0 if t0 is None else t0
    runner = Runner(cell, seed, device, fault)
    runner.warm(count_tables=traced)
    if traced:  # the profiler's own start-up, once, outside the window
        profile_window(runner, Window(), Sampler(0, seed), 0.0)
    setup_s = time.perf_counter() - t0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    w, sampler = Window(), Sampler(int(cell.traffic.get("checked_calls", 2)), seed)
    reading = None
    runner.loop(w, sampler, seconds)
    plain_calls = len(w.latency)
    if traced:
        runner.loop(w, sampler, seconds / 2, clocked=True)
        reading = profile_window(runner, w, sampler, seconds / 2)
    sync(device)
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": kind, "count": cell.chips,
           "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0}
    if device.type == "cuda":
        torch.cuda.empty_cache()
        dev["power_limit"] = power_limit()
    metrics, breakdown = {}, None
    if traced:
        r = Readings(w.layer_calls, reading, w.latency[:plain_calls], w.traced_bytes, kind)
        units = {m["name"]: m["unit"] for m in load_json(ROOT / "BENCHMARK.json")["per_layer"]}
        for name, reader in cell.per_layer.items():
            v = reader.read(r)
            if v is not None:
                metrics[name] = {"value": v, "unit": units.get(name, "")}
        if reading is not None:
            dev["busy_s"] = reading.busy_us * 1e-6
            dev["window_s"] = reading.window_us * 1e-6
            breakdown = {"device_ops": trace.top(reading.device_ops), "idle_gaps": trace.top(reading.idle)}
    else:
        values = {"throughput_MiBps": (w.raw_bytes / (1 << 20) / w.seconds, "MiB/s"), "setup_s": (setup_s, "s")}
        metrics = {name: {"value": values[name][0], "unit": values[name][1]} for name in cell.end_to_end if name in values}
    t_ref = time.perf_counter()
    checks = judge(cell, runner, sampler.sample(), w.failed)
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    out = {"correct": correct, "attempted": len(w.latency), "failed": w.failed, "metrics": metrics, "device": dev}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    q = np.percentile(np.array(w.latency), [0, 10, 50, 90, 99, 100]) if w.latency else []
    blobs = [(len(runner.blobs[k]) if op == "decode" else len(out or b""), len(runner.objects[k]))
             for _, op, k, out in sampler.sample()]
    info = {"window_s": w.seconds, "calls": len(w.latency), "judge_s": time.perf_counter() - t_ref,
            "errors": w.errors, "build_s": build_seconds(), "latency_ms_q0_10_50_90_99_100": [1e3 * x for x in q],
            "ratio": [b / n for b, n in blobs if n]}
    return out, info


def build_seconds() -> float | None:
    build = sys.modules.get("hsrans_tpu_torch.runtime.build")
    return getattr(build, "build_seconds", None)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = Cell.load(args.workload)
    importlib.import_module("hsrans_tpu_torch")  # the program under test, beside the benchmark
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"gpubench: {args.workload} needs {cell.chips} CUDA card(s), found {n}", file=sys.stderr)
        return 2
    result, info = run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0))
    found = guard.forbidden()
    if found:
        print(f"gpubench: modules of JAX or the JAX package were loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    print(f"gpubench info: {json.dumps(info)}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
