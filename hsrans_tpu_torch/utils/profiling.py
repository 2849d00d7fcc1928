"""Benchmark timing and profiling helpers.

The port's copy of `hsrans_tpu/utils/profiling.py`: `time_min` (min-of-N
wall time, the reference's method, main.cpp:72-118) and `slope_per_pass`
(seconds a pass from the slope of wall time against the number of chained
passes) as they are.  `trace` is a `torch.profiler` scope in place of
`jax.profiler`: it records the host's and the card's activity (kernels,
copies) and writes a Chrome trace, which `device_busy` reads back into the
card's busy time over the traced window.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable

import torch


@dataclass
class Timing:
    min_s: float
    mean_s: float
    runs: int

    def mib_s(self, nbytes: int) -> float:
        return nbytes / (1 << 20) / self.min_s


def time_min(fn: Callable[[], object], runs: int = 3, warmup: int = 1) -> Timing:
    """min/mean wall time of fn() over `runs` (reference: min-of-N runs)."""
    for _ in range(warmup):
        fn()
    ts = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return Timing(min(ts), sum(ts) / len(ts), runs)


def slope_per_pass(
    make_chain: Callable[[int], Callable[[], object]],
    lo: int = 1,
    hi: int = 9,
    runs: int = 3,
) -> float:
    """Seconds per pass from the slope of wall(hi) - wall(lo).

    `make_chain(n)` must return a zero-arg callable that executes n
    serially-dependent passes and waits on a small readback, so that the
    fixed dispatch and readback cost cancels.
    """
    f_lo, f_hi = make_chain(lo), make_chain(hi)
    f_lo()
    f_hi()  # compile + warm
    t_lo = min(time_min(f_lo, runs=1, warmup=0).min_s for _ in range(runs))
    t_hi = min(time_min(f_hi, runs=1, warmup=0).min_s for _ in range(runs))
    return (t_hi - t_lo) / (hi - lo)


@dataclass
class Trace:
    """What `trace` yields: where the Chrome trace goes (`path`, written
    when the scope ends), whether the card was traced, and the scope's
    wall seconds (set when it ends)."""

    log_dir: Path
    cuda: bool
    path: Path = field(init=False)
    wall_s: float = 0.0

    def __post_init__(self):
        self.path = self.log_dir / f"trace_{os.getpid()}_{time.time_ns()}.json"


@contextlib.contextmanager
def trace(log_dir: str | os.PathLike | None = None):
    """`torch.profiler` scope over the host (CPU) and, where there is a card,
    the card (CUDA: kernels, copies, memsets); the Chrome trace goes to a
    new file in `log_dir` (default: `hsrans_trace` in the temporary
    directory), viewable in chrome://tracing or Perfetto.  Without a card
    it records CPU activity only, and says so on stderr."""
    from torch.profiler import ProfilerActivity, profile

    out = Trace(Path(log_dir or Path(tempfile.gettempdir()) / "hsrans_trace"), torch.cuda.is_available())
    out.log_dir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if out.cuda:
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    else:
        print("trace: no CUDA device, recording CPU activity only", file=sys.stderr)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        try:
            yield out
        finally:
            if out.cuda:
                torch.cuda.synchronize()
            out.wall_s = time.perf_counter() - t0
    prof.export_chrome_trace(str(out.path))


DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def device_busy(trace_path: str | os.PathLike) -> dict:
    """The card's activity in a Chrome trace of `trace`: the microseconds of
    each category of device event (kernels, copies, memsets), their union
    (`busy_us`: time with at least one of them running, overlaps counted
    once) and the span from the first to the last event of any kind
    (`span_us`)."""
    events = json.loads(Path(trace_path).read_text())
    events = events.get("traceEvents", []) if isinstance(events, dict) else events
    spans = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e.get("cat", "")) for e in events
             if e.get("ph") == "X" and "ts" in e]
    by_cat = {c: 0.0 for c in DEVICE_CATEGORIES}
    device = sorted((lo, hi) for lo, hi, cat in spans if cat in by_cat)
    for lo, hi, cat in spans:
        if cat in by_cat:
            by_cat[cat] += hi - lo
    busy, end = 0.0, float("-inf")
    for lo, hi in device:
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    span = max(hi for _, hi, _ in spans) - min(lo for lo, _, _ in spans) if spans else 0.0
    return {"busy_us": busy, "span_us": span, "events": len(device), **{f"{c}_us": v for c, v in by_cat.items()}}
