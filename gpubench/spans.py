"""Reading the program's own ranges from the profiled window's Chrome trace.

While `torch.profiler` records, the program opens a range `hsrans.<name>`
around each of its layers (`hsrans_tpu_torch/runtime/device.py::layer_clock`)
with no synchronization, one root range a public call, named after the
entry point, and the planner's and the gaps' ranges inside it.  They lie on
the host thread beside the harness's `gpubench.call.<op>` ranges, in the
same trace and on the same clock as the card's kernels and copies.  This
reads, over the harness's window:

  - each harness call and the `hsrans.*` ranges that lie inside it;
  - each range's self time: its duration less that of the `hsrans.*`
    ranges nested in it;
  - the card's events, each attributed to the innermost `hsrans.*` range
    around the runtime call that launched it (linked by the trace's
    `correlation` argument); an event whose launch the trace lacks is
    unattributed, one launched outside every range is `outside_program`;
  - the card's idle time under each innermost `hsrans.*` range, and
    `outside_program` for idle time under none;
  - the kernels launched inside a root range, and the host's calls that
    wait for the card (`cudaDeviceSynchronize`, `cudaStreamSynchronize`).

`gpubench/run.py` reads the trace with `trace.read` inside `profile_window`
and deletes it there, and hands the metric readers only what `Readings`
holds.  So importing this module (each reader of a span metric does) wraps
`trace.read` for the whole process: the wrapper reads the same file again
with `read` below, hangs the reading on the `TraceReading` as `spans`, and
prints on stderr a `gpubench spans:` line: the calls, their mean ms, the
waits a call, the idle ms and the card's ms a call by span, the copies'
GB/s (`copy_GBps`) and the kernels launched a call (`launches_per_call`).
Those two read only the card's events, so they stay on that line rather
than in the result line, which a run without a card must fill.  What
`trace.read` returns is otherwise unchanged.  A trace with no `hsrans.*`
range (a program without them) reads as no range, and every span metric
as None.  The wrapper goes once `run.py::profile_window` calls `read`
itself and `Readings` has a `spans` field; no further reader should come
to depend on it until then.
"""

from __future__ import annotations

import bisect
import json
import sys
from dataclasses import dataclass, field
from pathlib import Path

from gpubench import trace

PREFIX = "hsrans."
CALL = "gpubench.call."
OUTSIDE = "outside_program"
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")
SYNCS = ("cudaDeviceSynchronize", "cudaStreamSynchronize")


@dataclass
class SpanReading:
    calls: list[tuple[str, float, float, list[tuple[str, float, float]]]]  # harness call, its hsrans.* ranges
    roots: int  # outermost hsrans.* ranges
    self_us: dict[str, float] = field(default_factory=dict)  # range name -> summed self time
    dur_us: dict[str, float] = field(default_factory=dict)  # range name -> summed duration
    device_us: dict[str, float] = field(default_factory=dict)  # innermost range -> card time attributed
    copy_bytes: dict[str, float] = field(default_factory=dict)  # innermost range -> bytes of its memcpy events
    copy_us: dict[str, float] = field(default_factory=dict)  # innermost range -> card time of those events
    idle_us: dict[str, float] = field(default_factory=dict)  # innermost range or OUTSIDE -> card idle time
    launches: int = 0  # kernel events launched inside a root range
    syncs: int = 0  # the host's cudaDeviceSynchronize and cudaStreamSynchronize calls
    device_total_us: float = 0.0  # card time of every event in the window
    unattributed_us: float = 0.0  # card time of events whose launch the trace lacks

    def ms_a_call(self, us: dict[str, float]) -> dict[str, float]:
        """`us` in ms a harness call, largest first."""
        n = max(len(self.calls), 1)
        return {k: v / n / 1e3 for k, v in sorted(us.items(), key=lambda kv: -kv[1])}

    def idle_ms_by_span(self) -> dict[str, float]:
        """Idle ms a harness call under each innermost program range."""
        return self.ms_a_call(self.idle_us)

    def call_ms(self) -> float | None:
        """A harness call's mean duration, ms."""
        return sum(hi - lo for _, lo, hi, _ in self.calls) / len(self.calls) / 1e3 if self.calls else None

    def unattributed_pct(self) -> float | None:
        return 100.0 * self.unattributed_us / self.device_total_us if self.device_total_us else None

    def copy_GBps(self) -> float | None:
        """The bytes of the memcpy events that `hsrans.h2d` and `hsrans.d2h`
        launched over those events' card time; None where they launched none."""
        keys = [PREFIX + "h2d", PREFIX + "d2h"]
        nbytes, us = sum(self.copy_bytes.get(k, 0.0) for k in keys), sum(self.copy_us.get(k, 0.0) for k in keys)
        return nbytes / us / 1e3 if nbytes and us > 0 else None

    def launches_per_call(self) -> float | None:
        """Kernel events launched inside a root range a harness call, torch's
        own included; None where the window holds no event on the card or
        the program opened no range."""
        return self.launches / len(self.calls) if self.calls and self.roots and self.device_total_us else None


def read(path: str | Path, window: str) -> SpanReading | None:
    """The program's ranges in the window range `window`; None if the trace
    has no such range."""
    events = trace._x_events(Path(path))
    wins = [e for e in events if e.get("name") == window and e.get("cat") == "user_annotation"]
    if not wins:
        return None
    w = wins[0]
    w0, w1 = float(w["ts"]), float(w["ts"]) + float(w.get("dur", 0.0))
    thread = (w.get("pid"), w.get("tid"))

    def span(e: dict) -> tuple[float, float, str]:
        return float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"]

    host = [e for e in events if (e.get("pid"), e.get("tid")) == thread and w0 <= float(e["ts"]) < w1]
    marks = [span(e) for e in host if e.get("cat") == "user_annotation"]
    ranges = sorted((m for m in marks if m[2].startswith(PREFIX)), key=lambda m: (m[0], -m[1]))
    calls = sorted(m for m in marks if m[2].startswith(CALL))
    out = SpanReading([(name, lo, hi, [(n, a, b) for a, b, n in ranges if lo <= a and b <= hi])
                       for lo, hi, name in calls], 0)

    # self times, from the nesting of the ranges (one thread: they nest)
    stack: list[list] = []  # [lo, hi, name, children's us]
    for lo, hi, name in ranges:
        while stack and stack[-1][1] <= lo:
            _close(stack.pop(), out)
        if stack:
            stack[-1][3] += hi - lo
        else:
            out.roots += 1
        stack.append([lo, hi, name, 0.0])
    while stack:
        _close(stack.pop(), out)

    # the card's events, each to the innermost range around its launch
    segs = trace.innermost(ranges)
    starts = [s[0] for s in segs]

    def under(t: float) -> str:
        i = bisect.bisect_right(starts, t) - 1
        return segs[i][2] if i >= 0 and t < segs[i][1] else OUTSIDE

    launched = {}
    for e in host:
        out.syncs += e.get("cat") == "cuda_runtime" and e["name"] in SYNCS
        corr = (e.get("args") or {}).get("correlation")
        if e.get("cat") in LAUNCH_CATEGORIES and corr is not None:
            launched[corr] = float(e["ts"])
    busy = []
    for e in events:
        if e.get("cat") not in trace.DEVICE_CATEGORIES:
            continue
        lo, hi = max(float(e["ts"]), w0), min(float(e["ts"]) + float(e.get("dur", 0.0)), w1)
        if hi <= lo:
            continue
        busy.append((lo, hi))
        out.device_total_us += hi - lo
        at = launched.get((e.get("args") or {}).get("correlation"))
        if at is None:
            out.unattributed_us += hi - lo
            continue
        label = under(at)
        out.device_us[label] = out.device_us.get(label, 0.0) + hi - lo
        if e["cat"] == "kernel" and label != OUTSIDE:
            out.launches += 1
        if e["cat"] == "gpu_memcpy" and "bytes" in e.get("args", {}):
            out.copy_bytes[label] = out.copy_bytes.get(label, 0.0) + float(e["args"]["bytes"])
            out.copy_us[label] = out.copy_us.get(label, 0.0) + hi - lo
    idle = trace.label_gaps(trace.gaps(busy, w0, w1), ranges)
    out.idle_us = {OUTSIDE if k == "host: none" else k: v for k, v in idle.items()}
    return out


def _close(item: list, out: SpanReading) -> None:
    lo, hi, name, children = item
    out.dur_us[name] = out.dur_us.get(name, 0.0) + hi - lo
    out.self_us[name] = out.self_us.get(name, 0.0) + hi - lo - children


def of(r) -> SpanReading | None:
    """The span reading of a metric reader's `Readings`, where its window
    had harness calls and the program opened ranges in it."""
    s = getattr(r.trace, "spans", None)
    return s if s is not None and s.calls and s.roots else None


def self_ms(r, names: tuple[str, ...]) -> float | None:
    """Mean ms a harness call spent in the self time of the ranges
    `hsrans.<name>`; None where none of them was opened."""
    s = of(r)
    keys = [PREFIX + n for n in names]
    if s is None or not any(k in s.self_us for k in keys):
        return None
    return sum(s.self_us.get(k, 0.0) for k in keys) / len(s.calls) / 1e3


def dur_ms(r, names: tuple[str, ...]) -> float | None:
    """Mean ms a harness call spent in the ranges `hsrans.<name>`, nested
    ranges included; None where none of them was opened."""
    s = of(r)
    keys = [PREFIX + n for n in names]
    if s is None or not any(k in s.dur_us for k in keys):
        return None
    return sum(s.dur_us.get(k, 0.0) for k in keys) / len(s.calls) / 1e3


def _read_with_spans(path, window):
    reading = _trace_read(path, window)
    if reading is not None:
        reading.spans = read(path, window)
        s = reading.spans
        if s is not None:
            n = max(len(s.calls), 1)
            line = {"calls": len(s.calls), "call_ms": s.call_ms(), "syncs_per_call": s.syncs / n,
                    "idle_ms_by_span": s.idle_ms_by_span(), "device_ms_by_span": s.ms_a_call(s.device_us),
                    "unattributed_device_pct": s.unattributed_pct(), "copy_GBps": s.copy_GBps(),
                    "launches_per_call": s.launches_per_call()}
            print(f"gpubench spans: {json.dumps(line)}", file=sys.stderr, flush=True)
    return reading


if getattr(trace.read, "__module__", None) != __name__:
    _trace_read = trace.read
    trace.read = _read_with_spans
