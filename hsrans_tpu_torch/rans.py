"""Core rANS constants and the lane-interleave permutations of the wires.

The port's copy of `hsrans_tpu/rans.py`, so that the port loads no module
of the JAX package; `tests/test_torch_mt_decode.py` and
`tests/test_torch_host_codecs.py` hold it equal to the original.  `IDX2IDX[n][j]` is the byte offset, within
a group of n input bytes, of the symbol that lane j codes (the reference's
idx2idx tables, part of the wire).
"""

from __future__ import annotations

import numpy as np

# a decode state below this shifts in one renormalization word (16-bit, or
# 8-bit for the 32blk 8w wire)
DECODE_CONSUME_POINT_16 = 1 << 15
DECODE_CONSUME_POINT_8 = 1 << 23

# the histogram depths (TotalSymbolCountBits) the wires support
HIST_BITS_RANGE = range(10, 16)


def encode_emit_point_16(total_symbol_count_bits: int) -> int:
    """A lane emits its low 16 bits iff state >= emit_point * freq."""
    return (DECODE_CONSUME_POINT_16 >> total_symbol_count_bits) << 16


def encode_emit_point_8(total_symbol_count_bits: int) -> int:
    """The same threshold for 8-bit-word renormalization."""
    return (DECODE_CONSUME_POINT_8 >> total_symbol_count_bits) << 8


def _interleave_perm(n: int) -> np.ndarray:
    """idx2idx for n lanes: within each 32-lane chunk, two 16-lane halves
    interleave in 4-byte runs (00-03, 10-13, 04-07, 14-17, ...)."""
    if n == 16:
        perm = [0x00, 0x01, 0x02, 0x03, 0x08, 0x09, 0x0A, 0x0B,
                0x04, 0x05, 0x06, 0x07, 0x0C, 0x0D, 0x0E, 0x0F]
    elif n == 32:
        perm = [0x00, 0x01, 0x02, 0x03, 0x10, 0x11, 0x12, 0x13,
                0x04, 0x05, 0x06, 0x07, 0x14, 0x15, 0x16, 0x17,
                0x08, 0x09, 0x0A, 0x0B, 0x18, 0x19, 0x1A, 0x1B,
                0x0C, 0x0D, 0x0E, 0x0F, 0x1C, 0x1D, 0x1E, 0x1F]
    elif n == 64:
        base = _interleave_perm(32)
        perm = list(base) + [p + 0x20 for p in base]
    else:
        raise ValueError(f"unsupported lane count {n}")
    return np.asarray(perm, dtype=np.int64)


IDX2IDX = {n: _interleave_perm(n) for n in (16, 32, 64)}
INV_IDX2IDX = {n: np.argsort(p) for n, p in IDX2IDX.items()}
