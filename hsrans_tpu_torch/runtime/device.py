"""Device probe and `device=` resolution for the PyTorch/CUDA port.

Counterpart of `hsrans_tpu/runtime/device.py`.  Tiers:

  cuda   — the hand-written kernels of `hsrans_tpu_torch/csrc` on the card
  torch  — their plain PyTorch versions on the CPU (the analog of Pallas
           interpret mode)

The numpy tier is the host codecs of `ops/` (`ops/tpx.py` for the tpx
wire), reached by their own names.  Asking for `cuda` where there is no
card raises: nothing here degrades silently to another tier.  Every byte
that crosses between host and card crosses here: `to_card` (pageable, the
host waits), `table_to_card` (a small int64 table from pinned memory, no
host wait) and `Output` (a call's returned `bytes`).
"""

from __future__ import annotations

import ctypes
import time
import warnings
from contextlib import contextmanager
from dataclasses import dataclass
from functools import lru_cache, wraps

import numpy as np
import torch

# outputs `Output` made: how many, and their bytes
OUTPUT_COUNTS = {"in_place": 0, "in_place_bytes": 0}

# u32 and u16 data as the signed storage of the same bits that the kernels take
_STORAGE = {np.dtype(np.uint32): np.int32, np.dtype(np.uint16): np.int16}
_TORCH_STORAGE = {torch.uint32: torch.int32, torch.uint16: torch.int16}

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


def tensor_of(x) -> torch.Tensor:
    """A tensor, or a numpy array or scalar, as a tensor where it lies, with
    no host copy where it is contiguous (read-only memory taken as it is);
    u32 and u16 data as int32 and int16 storage of the same bits."""
    if isinstance(x, torch.Tensor):
        return x.view(_TORCH_STORAGE[x.dtype]) if x.dtype in _TORCH_STORAGE else x
    a = np.ascontiguousarray(x) if np.ndim(x) else np.asarray(x)
    a = a.view(_STORAGE[a.dtype]) if a.dtype in _STORAGE else a
    if a.flags.writeable:
        return torch.from_numpy(a)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="The given NumPy array is not writable")
        return torch.from_numpy(a)


def to_card(x, dev: torch.device) -> torch.Tensor:
    """`x` (as `tensor_of` takes it) on `dev` by a pageable copy that the
    host waits for; a tensor already there as it is."""
    return tensor_of(x).to(dev)


def pinned_table(shape) -> torch.Tensor:
    """An int64 host table of `shape` in pinned memory, to fill in place
    (through `.numpy()`) and send with `table_to_card`."""
    return torch.empty(shape, dtype=torch.int64, pin_memory=True)


def table_to_card(table, dev: torch.device) -> torch.Tensor:
    """A small int64 table on `dev`, copied from pinned memory without a
    host wait: a `pinned_table` as it is, a host array copied into pinned
    memory first."""
    t = table if isinstance(table, torch.Tensor) else torch.from_numpy(table).pin_memory()
    return t.to(dev, non_blocking=True)


class _Payload:
    """The payload of a `bytes` as a numpy array interface; the array made
    from it holds this object, and so the `bytes`, alive."""

    def __init__(self, obj: bytes):
        self.obj = obj
        self.__array_interface__ = {
            "shape": (len(obj),), "typestr": "|u1", "data": (_bytes_payload(obj), False), "version": 3,
        }


class Output:
    """A call's returned `bytes` of `n` bytes, written once, in place (its
    payload unfilled until then; counted in `OUTPUT_COUNTS`): `put` copies a
    tensor (the D2H) into its place, `part` hands out a range for the host
    to write.  `close`, or leaving the `with` block, writes 0 where neither
    reached; leaving it drops the view on every path.  Only after a block
    that did not raise is the `bytes` its `result`."""

    def __init__(self, n: int):
        OUTPUT_COUNTS["in_place"] += 1
        OUTPUT_COUNTS["in_place_bytes"] += n
        self._res = _new_bytes(None, n)
        self.view = np.asarray(_Payload(self._res))
        self._ranges: list[tuple[int, int]] = []

    def put(self, at: int, t: torch.Tensor) -> None:
        """Copy uint8 `t` into the bytes [at, at + t.numel())."""
        torch.from_numpy(self.part(at, at + t.numel())).copy_(t)

    def part(self, start: int, end: int) -> np.ndarray:
        """The bytes [start, end) (clipped to the output) as a writable view,
        recorded as written: the caller writes every byte of it."""
        self._ranges.append((start, end))
        return self.view[max(start, 0) : max(end, 0)]

    def close(self) -> None:
        """Write 0 to every byte no range covers, drop the view; once."""
        if self.view is None:
            return
        view, self.view = self.view, None
        reach = 0  # every byte below it is covered by a range or zeroed
        for start, end in sorted(self._ranges):
            if start > reach:
                view[reach:start] = 0
            reach = max(reach, end)
        view[reach:] = 0
        self.result = self._res

    def __enter__(self) -> Output:
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.close()
        self.view = self._res = None
