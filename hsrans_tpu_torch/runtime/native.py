"""Build-on-demand of the native host runtime and its ctypes bindings.

The port's loader for its own copy of the JAX package's C++ host runtime,
`csrc/host/` (`hsrans_native.cpp`: histograms, normalization, the block
planner, FNV-1a; `hsrans_codec.cpp`: the raw, 32blk, block and mt codecs on
AVX-512), the counterpart of `hsrans_tpu/runtime/native.py` with the same
functions and signatures.  The copy differs from the original in one place:
`hsr_blk32_decode` reads every word past a lane's payload as 0, as the
numpy 32blk decoder does, where the original reads uninitialized slack
(`tests/test_torch_host_codecs.py` holds the rest of both files equal).

`g++` builds both sources with the original's Makefile flags, at first use
(never at import), into the same directory as the CUDA library
(`runtime/build.py::build_dir`, `build/hsrans_tpu_torch/` in a checkout).
The library's name carries a hash of the sources, the flags, the
compiler's version and what `-march=native` expands to on this host, so
an edit or another CPU rebuilds.  The build runs under an
`fcntl` lock beside the library, so concurrent processes (the workers of a
test run) link it once and none loads a half-written file.  A missing
compiler or a failed build raises: nothing here falls back to the numpy
codecs, which the callers reach only by their own names.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

from .build import build_dir

_SOURCES = ("hsrans_native.cpp", "hsrans_codec.cpp")
CXX_FLAGS = ["-O3", "-march=native", "-std=c++20", "-fPIC", "-Wall", "-Wextra", "-fno-exceptions", "-fno-rtti"]

_lib = None
_lock = threading.Lock()


class PlanRow(ctypes.Structure):
    _fields_ = [
        ("start", ctypes.c_uint64),
        ("size", ctypes.c_uint64),
        ("is_single", ctypes.c_uint32),
        ("symbol", ctypes.c_uint32),
        ("freq", ctypes.c_uint16 * 256),
    ]


def source_dir() -> Path:
    """The package's own copy of the C++ host runtime, `csrc/host/`."""
    return Path(__file__).resolve().parent.parent / "csrc" / "host"


def _cxx() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found (PATH, $CXX): cannot build the native host codecs")
    return cxx


def _key(cxx: str) -> str:
    """Hash of the sources, the flags, the compiler's version and the
    target `-march=native` resolves to here."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for cmd in ([cxx, "--version"], [cxx, "-march=native", "-###", "-E", "-"]):
        res = subprocess.run(cmd, capture_output=True, text=True, stdin=subprocess.DEVNULL, timeout=60)
        h.update((res.stdout + res.stderr).encode())
    for name in _SOURCES:
        h.update(name.encode())
        h.update((source_dir() / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return build_dir() / f"libhsrans_native_{_key(_cxx())}.so"


def _compile(so: Path) -> None:
    cxx = _cxx()
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [cxx, *CXX_FLAGS, "-shared", "-o", str(tmp), *(str(source_dir() / s) for s in _SOURCES), "-lpthread"]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    so.with_suffix(".log").write_text(f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({res.returncode}): {' '.join(cmd)}\n{res.stderr[-4000:]}")
    os.replace(tmp, so)  # atomic: a reader sees the whole library or none


def _bind(lib) -> None:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u16p = ctypes.POINTER(ctypes.c_uint16)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    lib.hsr_fnv1a.restype = ctypes.c_uint64
    lib.hsr_fnv1a.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
    lib.hsr_observe_hist.restype = None
    lib.hsr_observe_hist.argtypes = [u8p, ctypes.c_uint64, u32p]
    lib.hsr_normalize_hist.restype = None
    lib.hsr_normalize_hist.argtypes = [u32p, ctypes.c_uint64, ctypes.c_uint32, u16p, u16p]
    lib.hsr_hist_blocks.restype = None
    lib.hsr_hist_blocks.argtypes = [u8p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint32, ctypes.c_int64, u16p, u16p,
                                    ctypes.c_int32]
    lib.hsr_plan_blocks.restype = ctypes.c_int64
    lib.hsr_plan_blocks.argtypes = [u8p, ctypes.c_uint64, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint64,
                                    ctypes.POINTER(PlanRow), ctypes.c_int64]
    buf_sig = [u8p, ctypes.c_uint64, u8p, ctypes.c_uint64, ctypes.c_uint32, ctypes.c_uint32]
    for fn in ("hsr_raw_encode", "hsr_raw_decode", "hsr_block_encode", "hsr_block_decode", "hsr_mt_encode",
               "hsr_blk32_encode", "hsr_blk32_decode"):
        getattr(lib, fn).restype = ctypes.c_int64
        getattr(lib, fn).argtypes = buf_sig
    lib.hsr_mt_decode.restype = ctypes.c_int64
    lib.hsr_mt_decode.argtypes = buf_sig + [ctypes.c_int32]


def load():
    """The native library, built first (under the lock) if this host has no
    build of these sources."""
    global _lib
    with _lock:
        if _lib is None:
            so = library_path()
            if not so.exists():
                so.parent.mkdir(parents=True, exist_ok=True)
                with open(so.with_suffix(".lock"), "w") as fh:
                    fcntl.flock(fh, fcntl.LOCK_EX)  # released when fh closes
                    if not so.exists():
                        _compile(so)
            lib = ctypes.CDLL(str(so))
            _bind(lib)
            _lib = lib
        return _lib


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _u16p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16))


def _u32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


def _as_u8(data) -> np.ndarray:
    if isinstance(data, (bytes, bytearray, memoryview)):
        return np.frombuffer(data, dtype=np.uint8)
    return np.ascontiguousarray(data, dtype=np.uint8)


def fnv1a(data: bytes) -> int:
    """64-bit FNV-1a of `data`."""
    return int(load().hsr_fnv1a(bytes(data), len(data)))


def observe_hist(data: np.ndarray) -> np.ndarray:
    """Byte counts, u32[256]."""
    data = _as_u8(data)
    out = np.zeros(256, dtype=np.uint32)
    load().hsr_observe_hist(_u8p(data), data.size, _u32p(out))
    return out


def normalize_hist(hist: np.ndarray, data_bytes: int, bits: int) -> tuple[np.ndarray, np.ndarray]:
    """(freq u16[256], cumul u16[256]) of counts normalized to 2^bits."""
    hist = np.ascontiguousarray(hist, dtype=np.uint32)
    freq = np.zeros(256, dtype=np.uint16)
    cumul = np.zeros(256, dtype=np.uint16)
    load().hsr_normalize_hist(_u32p(hist), data_bytes, bits, _u16p(freq), _u16p(cumul))
    return freq, cumul


def hist_blocks(data: np.ndarray, block_size: int, bits: int, n_blocks: int, threads: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Observe and normalize uniform blocks on the library's threads:
    (freq u16[n_blocks, 256], cumul u16[n_blocks, 256]); the last block
    takes the remainder, blocks past the data the 1-symbol histogram."""
    data = _as_u8(data)
    freq = np.zeros((n_blocks, 256), dtype=np.uint16)
    cumul = np.zeros((n_blocks, 256), dtype=np.uint16)
    load().hsr_hist_blocks(_u8p(data), data.size, block_size, bits, n_blocks, _u16p(freq), _u16p(cumul), threads)
    return freq, cumul


def plan_blocks(data: np.ndarray, bits: int, mode: str, state_count: int) -> list[dict] | None:
    """The native greedy planner's rows in input order (it emits the last
    block first); None where it plans nothing (empty input, B outside
    10..15).  mode: "block" or "mt"."""
    lib = load()
    data = _as_u8(data)
    max_rows = int(data.size // (1 << 15)) + 16
    rows = (PlanRow * max_rows)()
    n = lib.hsr_plan_blocks(_u8p(data), data.size, bits, 1 if mode == "mt" else 0, state_count, rows, max_rows)
    if n <= 0:
        return None
    out = []
    for i in range(n - 1, -1, -1):
        r = rows[i]
        out.append({"start": int(r.start), "size": int(r.size), "is_single": bool(r.is_single),
                    "symbol": int(r.symbol), "freq": np.ctypeslib.as_array(r.freq).copy()})
    return out


def _encode(fn_name: str, data, bits: int, n: int, capacity: int) -> bytes | None:
    lib = load()
    data = _as_u8(data)
    out = np.zeros(capacity, dtype=np.uint8)
    got = getattr(lib, fn_name)(_u8p(data), data.size, _u8p(out), out.size, bits, n)
    return out[:got].tobytes() if got >= 0 else None


def codec_call_len(fn_name: str, src: np.ndarray, dst: np.ndarray, bits: int, n: int, *extra) -> int:
    """One codec call on caller-owned buffers, reused across timed runs
    (the reference bench preallocates both): the native return value, no
    copy of the output."""
    return int(getattr(load(), fn_name)(_u8p(src), src.size, _u8p(dst), dst.size, bits, n, *extra))


def _decode(fn_name: str, blob, bits: int, n: int, *extra) -> bytes | None:
    lib = load()
    buf = _as_u8(blob)
    if buf.size < 16:
        return None
    length = int.from_bytes(buf[:8].tobytes(), "little")
    if length > (1 << 40):
        return None  # an implausible header; no huge allocation
    try:
        # the header's length is untrusted: a forged one under the cap can
        # still exceed memory, and a malformed blob gives None, never raises
        out = np.zeros(max(length, 1), dtype=np.uint8)
    except MemoryError:
        return None
    got = getattr(lib, fn_name)(_u8p(buf), buf.size, _u8p(out), out.size, bits, n, *extra)
    return out[:got].tobytes() if got >= 0 else None


def raw_encode(data, bits: int, n: int) -> bytes | None:
    """rANS32xN 16w raw encode, the histogram taken inside."""
    size = _as_u8(data).size
    return _encode("hsr_raw_encode", data, bits, n, size + n * 8 + 1024 + (size >> 2))


def raw_decode(blob, bits: int, n: int) -> bytes | None:
    return _decode("hsr_raw_decode", blob, bits, n)


def block_encode(data, bits: int, n: int) -> bytes | None:
    size = _as_u8(data).size
    return _encode("hsr_block_encode", data, bits, n, size + (size >> 2) + ((size >> 15) + 4) * (8 + 512) + n * 8 + 1024)


def block_decode(blob, bits: int, n: int) -> bytes | None:
    return _decode("hsr_block_decode", blob, bits, n)


def mt_encode(data, bits: int, n: int) -> bytes | None:
    size = _as_u8(data).size
    cap = size + (size >> 2) + ((size >> 15) + 4) * (16 + 512 + 4 * n) + n * 8 + 1024
    return _encode("hsr_mt_encode", data, bits, n, cap)


def mt_decode(blob, bits: int, n: int, threads: int = 0) -> bytes | None:
    """mt decode, the blocks fanned out to the library's thread pool
    (`threads` 0: one a core)."""
    return _decode("hsr_mt_decode", blob, bits, n, threads)


def blk32_encode(data, bits: int, word_bits: int) -> bytes | None:
    """32blk encode (16w or 8w), the histogram taken inside."""
    size = _as_u8(data).size
    return _encode("hsr_blk32_encode", data, bits, word_bits, size + (size >> 2) + 32 * 8 + 1024)


def blk32_decode(blob, bits: int, word_bits: int) -> bytes | None:
    return _decode("hsr_blk32_decode", blob, bits, word_bits)
