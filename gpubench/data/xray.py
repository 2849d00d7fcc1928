"""Radiograph-like 14-bit images, made on the device from a seed.

The model of `tools/make_corpus.py::make_xray`: a square image of
`params["side"]` pixels (2048 by default) with a beam vignette, 40 soft
elliptical "bones", sensor noise that grows as the square root of the
signal plus read noise, clipped to 14 bits, and zeroed collimator borders,
stored as little-endian u16.  Each image takes the next draws of the
generator; an object is as many whole images as it needs, cut to its size.
"""

from __future__ import annotations

import torch


def _image(gen: torch.Generator, side: int, device: torch.device) -> torch.Tensor:
    axis = torch.arange(side, dtype=torch.float32, device=device)
    c = side / 2
    vy = torch.exp(-1.8 * ((axis - c) / c) ** 2)
    img = 3600.0 * torch.outer(vy, vy)  # exp(-1.8 r^2) is separable
    u = torch.rand(40, 5, generator=gen, device=device)
    centre = (0.15 + 0.7 * u[:, :2]) * side
    spread = (0.02 + 0.2 * u[:, 2:4]) * side
    amp = 600.0 + 3000.0 * u[:, 4]
    for k in range(40):
        ey = torch.exp(-(((axis - centre[k, 0]) / spread[k, 0]) ** 2))
        ex = torch.exp(-(((axis - centre[k, 1]) / spread[k, 1]) ** 2))
        img += amp[k] * torch.outer(ey, ex)
    noise = torch.randn(side, side, generator=gen, device=device)
    img += noise * (torch.sqrt(img + 64.0) * 5.2 + 24.0)
    img = torch.clamp(img, 0, 16383).to(torch.int16)
    m = side // 16
    img[:m] = 0
    img[-m:] = 0
    img[:, : m // 2] = 0
    img[:, -(m // 2) :] = 0
    return img.reshape(-1).view(torch.uint8)  # little-endian u16


def make(gen: torch.Generator, nbytes: int, device: torch.device, params: dict) -> torch.Tensor:
    side = int(params.get("side", 2048))
    per = 2 * side * side
    images = [_image(gen, side, device) for _ in range(-(-nbytes // per))]
    return torch.cat(images)[:nbytes] if images else torch.empty(0, dtype=torch.uint8, device=device)
