"""Zipf text over 80 symbols, made on the device from a seed.

The distribution of `tools/gen_inputs.py::text_like` (symbol k of 80 drawn
with probability proportional to k^-1.1: space, a-z, A-Z, then ! to ;),
drawn by inverting its distribution function on uniform float32 draws, in
chunks of 8 MiB so that the draws stay small beside the output.
"""

from __future__ import annotations

import numpy as np
import torch

CHUNK = 8 << 20


def make(gen: torch.Generator, nbytes: int, device: torch.device, params: dict) -> torch.Tensor:
    ranks = np.arange(1, 81, dtype=np.float64)
    p = 1.0 / ranks**1.1
    cdf = torch.tensor(np.cumsum(p / p.sum())[:-1], dtype=torch.float32, device=device)
    symbols = np.concatenate([[32], np.arange(97, 123), np.arange(65, 91), np.arange(33, 60)])[:80]
    lut = torch.tensor(symbols, dtype=torch.uint8, device=device)
    out = torch.empty(nbytes, dtype=torch.uint8, device=device)
    for lo in range(0, nbytes, CHUNK):
        u = torch.rand(min(CHUNK, nbytes - lo), generator=gen, device=device)
        out[lo : lo + u.numel()] = lut[torch.searchsorted(cdf, u, right=True)]
    return out
