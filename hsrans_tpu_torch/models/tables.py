"""Encode and decode tables of a normalized histogram.

The port's copy of `hsrans_tpu/models/tables.py`, so that the port loads no
module of the JAX package: the packed encode table, `make_dec3` (the layout
the scan decode, `kernels/scan.py`, gathers from) and the one-u32-a-slot
`make_dec_pack`.  `tests/test_torch_raw_scan.py` and
`tests/test_torch_tpx_numpy.py` hold each equal to its original; the slot
-> symbol table `make_cumul_inv` is `models/histogram.py`'s.
"""

from __future__ import annotations

import numpy as np

from .histogram import Hist, make_cumul_inv


def make_enc_table(hist: Hist) -> np.ndarray:
    """Packed encode table u32: cumul << 16 | freq (hist.cpp:224-228)."""
    return (hist.cumul.astype(np.uint32) << np.uint32(16)) | hist.symbol_count.astype(np.uint32)


def make_dec3(hist: Hist) -> dict[str, np.ndarray]:
    """Flat slot-indexed tables (hist.cpp:272-289): the symbol, its freq and
    its cumul at every one of the 2^B slots, one gather per field."""
    inv = make_cumul_inv(hist)
    return {
        "sym": inv,
        "freq": hist.symbol_count[inv].astype(np.uint32),
        "cumul": hist.cumul[inv].astype(np.uint32),
    }


def make_dec_pack(hist: Hist) -> np.ndarray:
    """One u32 a slot, sym | cumul << 8 | freq << 20 (hist.cpp:291-306);
    needs B <= 12."""
    if hist.total_symbol_count_bits > 12:
        raise ValueError("dec_pack layout requires TotalSymbolCountBits <= 12")
    inv = make_cumul_inv(hist)
    return (
        inv.astype(np.uint32)
        | (hist.cumul[inv].astype(np.uint32) << np.uint32(8))
        | (hist.symbol_count[inv].astype(np.uint32) << np.uint32(20))
    )
