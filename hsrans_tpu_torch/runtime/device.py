"""Device probe and `device=` resolution for the PyTorch/CUDA port.

Counterpart of `hsrans_tpu/runtime/device.py`.  Tiers:

  cuda   — the hand-written kernels of `hsrans_tpu_torch/csrc` on the card
  torch  — their plain PyTorch versions on the CPU (the analog of Pallas
           interpret mode)

The numpy tier is the host codecs of `ops/` (`ops/tpx.py` for the tpx
wire), reached by their own names.  Asking for `cuda` where there is no
card raises: nothing here degrades silently to another tier.
"""

from __future__ import annotations

import ctypes
import time
from contextlib import contextmanager
from dataclasses import dataclass
from functools import lru_cache, wraps

import numpy as np
import torch

# outputs `fresh_output` made: how many, and their bytes
OUTPUT_COUNTS = {"in_place": 0, "in_place_bytes": 0}

# the C API's own constructor and payload pointer, bound privately (the
# interpreter's lock held), so no other user of ctypes.pythonapi is touched
_new_bytes = ctypes.PYFUNCTYPE(ctypes.py_object, ctypes.c_char_p, ctypes.c_ssize_t)(
    ("PyBytes_FromStringAndSize", ctypes.pythonapi))
_bytes_payload = ctypes.PYFUNCTYPE(ctypes.c_void_p, ctypes.py_object)(("PyBytes_AsString", ctypes.pythonapi))


@dataclass(frozen=True)
class Capabilities:
    platform: str  # 'cuda' | 'cpu'
    device_kind: str  # e.g. 'NVIDIA H100 80GB HBM3'
    num_devices: int
    tier: str  # 'cuda' | 'torch'


@lru_cache(maxsize=1)
def detect() -> Capabilities:
    """Probe once for a CUDA card."""
    if torch.cuda.is_available():
        n = torch.cuda.device_count()
        return Capabilities("cuda", torch.cuda.get_device_name(0), n, "cuda")
    return Capabilities("cpu", "cpu", 1, "torch")


def banner(cap: Capabilities | None = None) -> str:
    """One-line capability report."""
    cap = cap or detect()
    return f"backend: {cap.platform} ({cap.device_kind} x{cap.num_devices}) -> tier '{cap.tier}'"


def resolve(device: str | torch.device) -> torch.device:
    """`device=` argument -> torch.device; raises for a card that is absent."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device={device!r} asked for, but no CUDA device is available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev


def flatten_devices(devices) -> list:
    """`devices=` as one flat list: a flat list as it is, a nested list of
    hosts x cards host-major (host 0's cards, then host 1's, ...), so that
    consecutive shares land on one host, as the JAX package's ("dcn",
    "ici") axis tuple shards its outer name slowest."""
    out = []
    for d in devices or ():
        out.extend(flatten_devices(d) if isinstance(d, (list, tuple)) else [d])
    return out


def resolve_all(device: str | torch.device, devices=None) -> list[torch.device]:
    """The devices a call splits its batch over: each of `devices` (flat, or
    nested hosts x cards, `flatten_devices`) resolved, or
    `[resolve(device)]` when it names none (the counterpart of a mesh axis;
    a list may name one device more than once)."""
    flat = flatten_devices(devices)
    return [resolve(d) for d in flat] if flat else [resolve(device)]


def shares(devices: list[torch.device], count: int) -> list[tuple[torch.device, int, int]]:
    """(device, lo, hi): contiguous shares of `count` rows over the devices,
    as a batch padded to a multiple of len(devices) and cut into equal
    parts, ceil(count / len(devices)) rows each, the pad rows dropped.
    Devices whose share would be empty are left out; with no rows the
    first device takes the empty share."""
    size = -(-count // len(devices))
    out = [(d, i * size, min((i + 1) * size, count)) for i, d in enumerate(devices) if i * size < count]
    return out or [(devices[0], 0, 0)]


def profiling() -> bool:
    """True while a `torch.profiler` records on this thread."""
    return torch._C._autograd._profiler_enabled()


@contextmanager
def span(name: str):
    """The block as the range `hsrans.<name>` while a profiler records, on
    the same timeline and clock as the card's kernels and copies; without
    a profiler, one check and nothing else.  Never waits for the card."""
    if not profiling():
        yield
        return
    with torch.profiler.record_function("hsrans." + name):
        yield


def entry_span(fn):
    """`fn` as a root range `hsrans.<its name>` while a profiler records:
    every range a call opens on its thread nests inside it, so the root
    is the call's identifier and each range's parent is the one around
    it.  Without a profiler, one check and the call."""
    name = "hsrans." + fn.__name__

    @wraps(fn)
    def call(*args, **kwargs):
        if not profiling():
            return fn(*args, **kwargs)
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)

    return call


@contextmanager
def layer_clock(acc: dict[str, float] | None, key: str, dev: torch.device, name: str | None = None):
    """One layer of a call.  While a profiler records, the block is the
    range `hsrans.<name>` (`name` defaults to `key`), with no
    synchronization: the card's work it launches is linked to it through
    the trace's correlation ids.  With `acc`, also adds the host-clock
    seconds of the block to `acc[key]`, the device synchronized at both
    ends so the layer's device work falls inside it.  With neither, one
    check and nothing else."""
    if acc is None and not profiling():
        yield
        return
    with span(name or key):
        if acc is None:
            yield
            return
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        yield
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        acc[key] = acc.get(key, 0.0) + time.perf_counter() - t0


class _Payload:
    """The payload of a `bytes` as a numpy array interface; the array made
    from it holds this object, and so the `bytes`, alive."""

    def __init__(self, obj: bytes):
        self.obj = obj
        self.__array_interface__ = {
            "shape": (len(obj),), "typestr": "|u1", "data": (_bytes_payload(obj), False), "version": 3,
        }


def fresh_output(n: int) -> tuple[bytes, np.ndarray]:
    """A call's output, written once where it is returned: a new `bytes` of
    `n` bytes whose contents are undefined, and a writable uint8 view of
    its payload.  The caller writes every byte through the view, then drops
    the view before it returns the `bytes`, on an error path too; nothing
    may hash, share or return the `bytes` before it is full.  Nothing here
    fills the payload (CPython writes only the object's header and the
    trailing NUL), so the caller's copy is the first to touch its pages."""
    OUTPUT_COUNTS["in_place"] += 1
    OUTPUT_COUNTS["in_place_bytes"] += n
    if n == 0:
        return b"", np.zeros(0, np.uint8)
    obj = _new_bytes(None, n)
    return obj, np.asarray(_Payload(obj))


def zero_outside(view: np.ndarray, ranges) -> None:
    """Write 0 to every byte of `view` that none of `ranges` ([start, end)
    pairs, each clipped to the view) covers, and to no other byte: a fresh
    output holds zeros where nothing else writes, as a zeroed buffer
    would, without a pass over the bytes that are written."""
    reach = 0  # every byte below it is covered by a range or zeroed
    for start, end in sorted(ranges):
        if start > reach:
            view[reach:start] = 0
        reach = max(reach, end)
    view[reach:] = 0
