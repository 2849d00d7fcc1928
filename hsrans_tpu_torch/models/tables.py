"""Slot-indexed decode tables of a normalized histogram.

The port's copy of `hsrans_tpu/models/tables.py::make_dec3`, the layout the
scan decode (`kernels/scan.py`) gathers from, so that the port loads no
module of the JAX package; `tests/test_torch_raw_scan.py` holds it equal to
the original.
"""

from __future__ import annotations

import numpy as np

from .histogram import Hist, make_cumul_inv


def make_dec3(hist: Hist) -> dict[str, np.ndarray]:
    """Flat slot-indexed tables (hist.cpp:272-289): the symbol, its freq and
    its cumul at every one of the 2^B slots, one gather per field."""
    inv = make_cumul_inv(hist)
    return {
        "sym": inv,
        "freq": hist.symbol_count[inv].astype(np.uint32),
        "cumul": hist.cumul[inv].astype(np.uint32),
    }
