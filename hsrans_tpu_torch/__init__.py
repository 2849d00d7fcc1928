"""hsrans_tpu_torch — the PyTorch/CUDA port of `hsrans_tpu`.

Every wire of the JAX package with the same bytes for the same input.  The
tpx round trip and the mt round trip run on an NVIDIA Hopper card:
hand-written CUDA kernels (`csrc/*.cu`, built by `nvcc` for sm_90a at first
use) behind plain functions on bytes, each with an explicit `device`:

  * `tpx_encode_torch`, `tpx_encode_adaptive_torch` — `kernels.tpx_encode`
  * `tpx_decode_torch` — `kernels.tpx_decode`
  * `mt_decode_torch` — `kernels.mt_decode` (the C++ reference's mt wire)
  * `mt_encode_torch` — `kernels.mt_encode` (the same wire, every block
    encoded from fresh states)
  * `raw_encode_torch`, `raw_decode_torch` — `ops.raw_scan` (the raw 16w
    wire, n = 16, 32 or 64, on the scan kernels of `kernels.scan`, the port
    of the JAX package's XLA scans `decode_section` and `encode_section`)
  * `parallel.sharded.mt_decode_device`, `mt_encode_device` (the mt wire
    at n = 16, 32 and 64, the decode with the JAX package's fallback chain)
    and `parallel.tpx_sharded.tpx_decode_device`, `tpx_encode_device`, each
    split over a list of devices with `devices=` (flat, or a nested list of
    hosts x cards for the JAX package's two-level mesh axis)

`device="cuda"` runs the kernels and raises where there is no card;
`device="cpu"` runs their plain PyTorch versions.  The JAX package's
`tpx_encode_tpu`, `tpx_decode_tpu`, `mt64_encode_tpu` and `mt64_decode_tpu`
are the `*_torch` functions above, under their own names.

The host codecs, as in the JAX package: the raw (`raw_encode`,
`raw_decode`), 32blk (`blk32_encode_host`, `blk32_decode_host`), block
(`block_encode`, `block_decode`) and mt (`mt_encode`, `mt_decode`) wires on
the native C++ runtime (`runtime/native.py`, built by `g++` at first use),
and their numpy authorities (`raw_encode_16w`, `raw_decode_16w`,
`blk32_encode`, `blk32_decode`, `tpx_encode`, `tpx_decode`, and
`ops.block`'s and `ops.mt`'s `*_py` functions); the histogram model
(`Hist`, `make_hist`, `normalize_hist`, `observe_hist`).  The host tier of
the wires is a numpy copy of the JAX package's in `ops/`, `models/` and
`parallel/`, and the native runtime a copy of its C++ in `csrc/host/`, each
held equal to the original by the tests, so the port imports neither jax
nor any module of `hsrans_tpu`.

`python -m hsrans_tpu_torch.cli <file> --test` is the hsrans-compatible CLI.
"""

from .kernels.mt_decode import mt_decode_torch
from .kernels.mt_encode import mt_encode_torch
from .kernels.tpx_decode import tpx_decode_torch
from .kernels.tpx_encode import tpx_encode_adaptive_torch, tpx_encode_torch
from .models.histogram import Hist, make_hist, normalize_hist, observe_hist
from .ops.blk32 import blk32_decode, blk32_decode_host, blk32_encode, blk32_encode_host
from .ops.block import block_decode, block_encode
from .ops.mt import mt_decode, mt_encode
from .ops.raw_scan import raw_decode_torch, raw_encode_torch
from .ops.reference import raw_decode, raw_decode_16w, raw_encode, raw_encode_16w
from .ops.tpx import TpxParams, tpx_decode, tpx_encode
from .runtime.device import banner, detect

__all__ = [
    "Hist", "make_hist", "normalize_hist", "observe_hist",
    "raw_encode", "raw_decode", "raw_encode_16w", "raw_decode_16w",
    "blk32_encode", "blk32_decode", "blk32_encode_host", "blk32_decode_host",
    "block_encode", "block_decode", "mt_encode", "mt_decode", "TpxParams", "tpx_encode", "tpx_decode",
    "mt_decode_torch", "mt_encode_torch", "raw_decode_torch", "raw_encode_torch", "tpx_decode_torch",
    "tpx_encode_torch", "tpx_encode_adaptive_torch", "banner", "detect",
]
