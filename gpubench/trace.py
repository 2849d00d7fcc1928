"""Reading a `torch.profiler` Chrome trace: the card's busy time, each
device operation's time, and the card's idle gaps labelled by what the host
was doing.

The busy time is the union of the card's kernel, copy and memset events,
overlaps counted once (the arithmetic of the program's
`utils/profiling.py::device_busy`, copied here so that the yardstick stays
in the benchmark).  Only events inside the harness's window range count,
clipped to it.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


def union_us(spans: list[tuple[float, float]]) -> float:
    """Length of the union of [lo, hi) spans."""
    busy, end = 0.0, float("-inf")
    for lo, hi in sorted(spans):
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    return busy


@dataclass
class TraceReading:
    window_us: float
    busy_us: float
    kernel_us: float  # summed kernel time (overlaps counted in full)
    device_ops: dict[str, float] = field(default_factory=dict)  # name -> us
    idle: dict[str, float] = field(default_factory=dict)  # host label -> us of device idle under it


def _x_events(path: Path) -> list[dict]:
    events = json.loads(Path(path).read_text())
    events = events.get("traceEvents", []) if isinstance(events, dict) else events
    return [e for e in events if e.get("ph") == "X" and "ts" in e]


def read(path: str | Path, window: str) -> TraceReading | None:
    """The reading of the trace between the start and end of the host range
    named `window`; None if the trace has no such range."""
    events = _x_events(Path(path))
    wins = [e for e in events if e.get("name") == window and e.get("cat") == "user_annotation"]
    if not wins:
        return None
    w = wins[0]
    w0, w1 = float(w["ts"]), float(w["ts"]) + float(w.get("dur", 0.0))
    spans, ops, kernel = [], {}, 0.0
    for e in events:
        if e.get("cat") not in DEVICE_CATEGORIES:
            continue
        lo, hi = max(float(e["ts"]), w0), min(float(e["ts"]) + float(e.get("dur", 0.0)), w1)
        if hi <= lo:
            continue
        spans.append((lo, hi))
        ops[e["name"]] = ops.get(e["name"], 0.0) + hi - lo
        if e["cat"] == "kernel":
            kernel += hi - lo
    host = sorted(
        (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"])
        for e in events
        if e.get("cat") in HOST_CATEGORIES and e.get("tid") == w.get("tid") and e.get("pid") == w.get("pid")
    )
    return TraceReading(w1 - w0, union_us(spans), kernel, ops, label_gaps(gaps(spans, w0, w1), host))


def gaps(spans: list[tuple[float, float]], w0: float, w1: float) -> list[tuple[float, float]]:
    """The parts of [w0, w1) that no span covers."""
    out, at = [], w0
    for lo, hi in sorted(spans):
        if lo > at:
            out.append((at, lo))
        at = max(at, hi)
    if w1 > at:
        out.append((at, w1))
    return out


def innermost(host: list[tuple[float, float, str]]) -> list[tuple[float, float, str]]:
    """The host ranges of one thread (which nest) flattened into segments,
    each named by the innermost range that holds it."""
    segs: list[tuple[float, float, str]] = []
    stack: list[tuple[float, float, str]] = []
    at = float("-inf")

    def close_until(t: float) -> None:
        nonlocal at
        while stack and stack[-1][1] <= t:
            _, hi, name = stack.pop()
            if hi > at:
                segs.append((at, hi, name))
                at = hi

    for lo, hi, name in sorted(host, key=lambda e: (e[0], -e[1])):
        close_until(lo)
        if stack and lo > at:
            segs.append((at, lo, stack[-1][2]))
        at = max(at, lo)
        stack.append((lo, min(hi, stack[-1][1]) if stack else hi, name))
    close_until(float("inf"))
    return segs


def label_gaps(idle: list[tuple[float, float]], host: list[tuple[float, float, str]]) -> dict[str, float]:
    """The idle time under each innermost host range (`innermost`), summed
    by its name; "host: none" where no range is open."""
    segs = innermost(host)
    out: dict[str, float] = {}
    j = 0
    for lo, hi in idle:
        covered = 0.0
        while j < len(segs) and segs[j][1] <= lo:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < hi:
            part = min(hi, segs[k][1]) - max(lo, segs[k][0])
            if part > 0:
                out[segs[k][2]] = out.get(segs[k][2], 0.0) + part
                covered += part
            k += 1
        if hi - lo - covered > 1e-9:
            out["host: none"] = out.get("host: none", 0.0) + hi - lo - covered
    return out


def top(d: dict[str, float], k: int = 10, scale: float = 1e-6) -> list[list]:
    """The k largest entries as [name, value * scale], largest first."""
    return [[name, v * scale] for name, v in sorted(d.items(), key=lambda kv: -kv[1])[:k]]
