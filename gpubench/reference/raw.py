"""The raw 16w wire (the upstream's rANS32xN 16w file), encoded and decoded
by the benchmark's own frozen codec, independent of the code under test:
header, histogram and lane layout in NumPy, the state chain in
`raw16w.c`, built with the system's `cc` at first use into
`build/gpubench/` and called through ctypes.

Wire (little-endian): u64 raw length | u64 blob length | 256 u16 freqs
(the whole input's histogram, summing to 2^B) | n u32 final states | the
16-bit words.  The input is cut into groups of n bytes; lane j codes byte
g n + lane[j] of group g, where in each 32 lanes (all 16 at n = 16) the two
halves interleave in runs of 4 (lanes 0-3 take bytes 0-3, lanes 4-7 bytes
16-19 at n = 32, lanes 8-11 bytes 4-7, ...), and a lane whose byte lies
past the input's end is left out of the last group.  The n states are
interleaved 32-bit rANS states.  The encoder runs backward from the state
2^15 and emits a lane's low 16 bits where the state is at or above
freq x 2^(31-B); the words lie in the decode's order, group ascending and
lane ascending, and the decoder reads them forward in lane order.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from .hist import cumul_of, normalize_rows, segment_freqs

HEADER = 16 + 512
CONSUME_POINT = 1 << 15
SOURCE = Path(__file__).resolve().with_name("raw16w.c")
BUILD = Path(__file__).resolve().parents[2] / "build" / "gpubench"

_lib = None
_lock = threading.Lock()

_U8 = ctypes.POINTER(ctypes.c_uint8)
_U16 = ctypes.POINTER(ctypes.c_uint16)
_I32 = ctypes.POINTER(ctypes.c_int32)
_U32 = ctypes.POINTER(ctypes.c_uint32)
_I64 = ctypes.c_int64


def chain():
    """The state chain's library, built from `raw16w.c` the first time
    (one file a version of the source, written whole before it is used)."""
    global _lib
    with _lock:
        if _lib is None:
            src = SOURCE.read_bytes()
            lib = BUILD / f"raw16w-{hashlib.sha256(src).hexdigest()[:16]}.so"
            if not lib.exists():
                BUILD.mkdir(parents=True, exist_ok=True)
                tmp = lib.with_suffix(f".{os.getpid()}.tmp")
                subprocess.run(["cc", "-O2", "-shared", "-fPIC", "-o", str(tmp), str(SOURCE)], check=True)
                os.replace(tmp, lib)
            cdll = ctypes.CDLL(str(lib))
            cdll.raw16w_encode.argtypes = [_U8, _I64, ctypes.c_int32, _I32, _U32, _U32, ctypes.c_int32, _U32, _U16, _I64]
            cdll.raw16w_encode.restype = _I64
            cdll.raw16w_decode.argtypes = [_U16, _I64, _I64, ctypes.c_int32, _I32, _U8, _U32, _U32, ctypes.c_int32,
                                           _U32, _U8]
            cdll.raw16w_decode.restype = _I64
            _lib = cdll
        return _lib


def lanes(n: int) -> np.ndarray:
    """int32 [n]: the byte of its group that each lane codes."""
    if n not in (16, 32, 64):
        raise ValueError(f"the raw 16w wire has 16, 32 or 64 lanes, not {n}")
    block = min(n, 32)
    j = np.arange(n)
    run, k = (j % block) // 4, j % 4
    return ((j // block) * block + (run // 2) * 4 + k + (run % 2) * (block // 2)).astype(np.int32)


def _ptr(a: np.ndarray, kind):
    return a.ctypes.data_as(kind)


def encode(data: bytes | np.ndarray, bits: int, n: int) -> bytes:
    """The raw 16w blob of `data` at 2^bits with n lanes, the whole input's
    histogram its model."""
    arr = np.frombuffer(data, np.uint8) if isinstance(data, (bytes, bytearray, memoryview)) else np.asarray(data, np.uint8)
    arr = np.ascontiguousarray(arr)
    freqs = segment_freqs(arr, np.array([0]), np.array([arr.size]), bits)[0]
    freq = freqs.astype(np.uint32)
    cumul = cumul_of(freqs[None])[0].astype(np.uint32)
    states = np.full(n, CONSUME_POINT, np.uint32)
    words = np.empty(arr.size + 1, np.uint16)  # a lane emits at most once a byte
    count = chain().raw16w_encode(_ptr(arr, _U8), arr.size, n, _ptr(lanes(n), _I32), _ptr(freq, _U32),
                                  _ptr(cumul, _U32), bits, _ptr(states, _U32), _ptr(words, _U16), words.size)
    if count < 0:
        raise RuntimeError("raw16w_encode: the word buffer is too small")
    body = [freqs.astype("<u2").tobytes(), states.astype("<u4").tobytes(), words[words.size - count :].astype("<u2").tobytes()]
    total = 16 + sum(len(b) for b in body)
    return b"".join([arr.size.to_bytes(8, "little"), total.to_bytes(8, "little"), *body])


def decode(blob: bytes | np.ndarray, bits: int, n: int, table_bits: int | None = None) -> bytes | None:
    """The raw bytes of a raw 16w blob at 2^bits with n lanes; None where
    the blob is shorter than its header and states or than the size its
    header gives, or where its freqs do not sum to 2^bits.  `table_bits`
    below `bits` decodes with the freqs renormalised to 2^table_bits and
    the state arithmetic at that depth: the lower-precision decode that
    the benchmark's control runs in place of the program."""
    buf = np.frombuffer(blob, np.uint8) if isinstance(blob, (bytes, bytearray, memoryview)) else np.asarray(blob, np.uint8)
    if buf.size < HEADER + 4 * n:
        return None
    length = int(buf[0:8].view("<u8")[0])
    if buf.size < int(buf[8:16].view("<u8")[0]):
        return None
    freqs = buf[16:HEADER].view("<u2").astype(np.uint16)
    if int(freqs.sum(dtype=np.int64)) != 1 << bits:
        return None
    b = bits
    if table_bits is not None and table_bits != bits:
        freqs = normalize_rows(freqs[None].astype(np.int64), np.array([1 << bits]), table_bits)[0]
        b = table_bits
    states = buf[HEADER : HEADER + 4 * n].view("<u4").astype(np.uint32)
    words = np.ascontiguousarray(buf[HEADER + 4 * n : HEADER + 4 * n + (buf.size - HEADER - 4 * n) // 2 * 2].view("<u2"))
    slot_sym = np.repeat(np.arange(256, dtype=np.uint8), freqs.astype(np.int64))
    freq = freqs.astype(np.uint32)
    cumul = cumul_of(freqs[None])[0].astype(np.uint32)
    out = np.zeros(length, np.uint8)
    chain().raw16w_decode(_ptr(words, _U16), words.size, length, n, _ptr(lanes(n), _I32), _ptr(slot_sym, _U8),
                          _ptr(freq, _U32), _ptr(cumul, _U32), b, _ptr(states, _U32), _ptr(out, _U8))
    return out.tobytes()


def tables(blob: bytes | np.ndarray) -> int:
    """The blob's frequency tables: one."""
    return 1
