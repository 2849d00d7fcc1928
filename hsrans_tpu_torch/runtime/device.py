"""Device probe and `device=` resolution for the PyTorch/CUDA port.

Counterpart of `hsrans_tpu/runtime/device.py`.  Tiers:

  cuda   — the hand-written kernels of `hsrans_tpu_torch/csrc` on the card
  torch  — their plain PyTorch versions on the CPU (the analog of Pallas
           interpret mode)

The numpy tier stays in the JAX package (`hsrans_tpu.ops.tpx`).  Asking for
`cuda` where there is no card raises: nothing here degrades silently to
another tier.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass
from functools import lru_cache

import torch


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


def resolve_all(device: str | torch.device, devices=None) -> list[torch.device]:
    """The devices a call splits its batch over: each of `devices`
    resolved, or `[resolve(device)]` when it is None or empty (the
    counterpart of a mesh axis; a list may name one device more than
    once)."""
    return [resolve(d) for d in devices] if devices else [resolve(device)]


def shares(devices: list[torch.device], count: int) -> list[tuple[torch.device, int, int]]:
    """(device, lo, hi): contiguous shares of `count` rows over the devices,
    as a batch padded to a multiple of len(devices) and cut into equal
    parts, ceil(count / len(devices)) rows each, the pad rows dropped.
    Devices whose share would be empty are left out; with no rows the
    first device takes the empty share."""
    size = -(-count // len(devices))
    out = [(d, i * size, min((i + 1) * size, count)) for i, d in enumerate(devices) if i * size < count]
    return out or [(devices[0], 0, 0)]


@contextmanager
def layer_clock(acc: dict[str, float] | None, key: str, dev: torch.device):
    """Add the host-clock seconds of the block to `acc[key]`, the device
    synchronized at both ends so the layer's device work falls inside it.
    Does nothing, and adds no synchronization, when `acc` is None."""
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
