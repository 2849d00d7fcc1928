"""hsrans_tpu_torch — the PyTorch/CUDA port of `hsrans_tpu`.

The tpx round trip and the mt round trip on an NVIDIA Hopper card: hand-written
CUDA kernels (`csrc/*.cu`, built by `nvcc` for sm_90a at first use) behind
plain functions on bytes, each with an explicit `device`:

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
    split over a list of devices with `devices=`

`device="cuda"` runs the kernels and raises where there is no card;
`device="cpu"` runs their plain PyTorch versions.  The host tier of the
wires (tpx parse and mux, per-tile histograms, the planner, the mt block
index and numpy encoder, the mt device plans) is a numpy copy of the JAX
package's in `ops/`, `models/` and `parallel/`, held equal to it by the
tests, so the port imports neither jax nor any module of `hsrans_tpu`.
"""

from .kernels.mt_decode import mt_decode_torch
from .kernels.mt_encode import mt_encode_torch
from .kernels.tpx_decode import tpx_decode_torch
from .kernels.tpx_encode import tpx_encode_adaptive_torch, tpx_encode_torch
from .ops.raw_scan import raw_decode_torch, raw_encode_torch
from .runtime.device import banner, detect

__all__ = [
    "mt_decode_torch", "mt_encode_torch", "raw_decode_torch", "raw_encode_torch", "tpx_decode_torch",
    "tpx_encode_torch", "tpx_encode_adaptive_torch", "banner", "detect",
]
