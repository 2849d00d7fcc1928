"""Build-on-demand of the native host runtime and its ctypes bindings.

The port's loader for its own copy of the JAX package's C++ host runtime,
`csrc/host/` (`hsrans_native.cpp`: histograms, normalization, the block
planner, FNV-1a; `hsrans_codec.cpp`: the raw, 32blk, block and mt codecs on
AVX-512), the counterpart of `hsrans_tpu/runtime/native.py` with the same
functions.  The copy differs from the original in three places:
`hsr_blk32_decode` reads every word past a lane's payload as 0, as the
numpy 32blk decoder does, where the original reads uninitialized slack;
the planner, `hsr_plan_blocks` (and `hsr_plan_blocks_counted`, the same
with its thread count and its byte counts), counts every `min_block` chunk
once on the library's threads before its walk, which then reads each
histogram from that table (the same rows), and sits beside
`hsr_hist_spans`, many spans' histograms in one threaded call; and
`hsr_mt_index`, beside `hsr_mt_decode`, indexes an mt blob in place for
the card decoder (`mt_index`)
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
from typing import NamedTuple

import numpy as np

from .build import build_dir

_SOURCES = ("hsrans_native.cpp", "hsrans_codec.cpp")
CXX_FLAGS = ["-O3", "-march=native", "-std=c++20", "-fPIC", "-Wall", "-Wextra", "-fno-exceptions", "-fno-rtti"]

_lib = None
_lock = threading.Lock()

# The native planner's engagement in this process:
# `native` and `python` count the calls of `plan_blocks` by route (`python`:
# it planned nothing, so its caller plans in Python); `span_bytes` the bytes
# of every histogram the native walks used, `edge_bytes` those they counted
# outside the chunk pass.  The chunk table's hit share is
# 1 - edge_bytes / span_bytes.
PLAN_COUNTS: dict[str, int] = {"native": 0, "python": 0, "span_bytes": 0, "edge_bytes": 0}

# mt decode's native index (`mt_index`) in this process: its calls, those
# whose word region goes on as it lies in the blob (`in_place`) or as one
# aligned copy (`copied`, a region at an odd address), the coded and
# single-symbol blocks indexed, and the blobs refused.
MT_INDEX_COUNTS: dict[str, int] = {"calls": 0, "in_place": 0, "copied": 0, "coded": 0, "single": 0, "refused": 0}


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
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.hsr_plan_max_rows.restype = ctypes.c_int64
    lib.hsr_plan_max_rows.argtypes = [ctypes.c_uint64, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint64]
    lib.hsr_plan_blocks.restype = ctypes.c_int64
    lib.hsr_plan_blocks.argtypes = [u8p, ctypes.c_uint64, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint64,
                                    ctypes.POINTER(PlanRow), ctypes.c_int64]
    lib.hsr_plan_blocks_counted.restype = ctypes.c_int64
    lib.hsr_plan_blocks_counted.argtypes = lib.hsr_plan_blocks.argtypes + [ctypes.c_int32, u64p]
    lib.hsr_hist_spans.restype = None
    lib.hsr_hist_spans.argtypes = [u8p, u64p, ctypes.c_int64, ctypes.c_uint32, u16p, ctypes.c_int32]
    buf_sig = [u8p, ctypes.c_uint64, u8p, ctypes.c_uint64, ctypes.c_uint32, ctypes.c_uint32]
    for fn in ("hsr_raw_encode", "hsr_raw_decode", "hsr_block_encode", "hsr_block_decode", "hsr_mt_encode",
               "hsr_blk32_encode", "hsr_blk32_decode"):
        getattr(lib, fn).restype = ctypes.c_int64
        getattr(lib, fn).argtypes = buf_sig
    lib.hsr_mt_decode.restype = ctypes.c_int64
    lib.hsr_mt_decode.argtypes = buf_sig + [ctypes.c_int32]
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.hsr_mt_index.restype = ctypes.c_int64
    lib.hsr_mt_index.argtypes = [u8p, ctypes.c_uint64, ctypes.c_uint32, ctypes.c_uint32, i64p, u32p, u32p,
                                 ctypes.c_int64, i64p, ctypes.c_int64, i64p]


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


def plan_blocks(data: np.ndarray, bits: int, mode: str, state_count: int, threads: int = 0) -> np.ndarray | None:
    """The native greedy planner's rows in input order (it emits the last
    block first), a structured array with `PlanRow`'s fields (`freq` all 0 in
    single-symbol rows); None where it plans nothing (empty input, B outside
    10..15).  mode: "block" or "mt"; `threads` run the chunk pass (0: one a
    core; the program leaves it so, and the tests set it to hold the rows
    the same on any count).  Counted in `PLAN_COUNTS`."""
    lib = load()
    data = _as_u8(data)
    m = 1 if mode == "mt" else 0
    max_rows = lib.hsr_plan_max_rows(data.size, bits, m, state_count)
    if max_rows <= 0:
        PLAN_COUNTS["python"] += 1
        return None
    rows = np.zeros(max_rows, dtype=np.dtype(PlanRow))
    counted = np.zeros(2, dtype=np.uint64)
    n = lib.hsr_plan_blocks_counted(_u8p(data), data.size, bits, m, state_count,
                                    rows.ctypes.data_as(ctypes.POINTER(PlanRow)), max_rows, threads,
                                    counted.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)))
    if n <= 0:
        raise RuntimeError(f"hsr_plan_blocks_counted planned no row of {data.size} bytes within its bound of {max_rows}")
    PLAN_COUNTS["native"] += 1
    PLAN_COUNTS["span_bytes"] += int(counted[0])
    PLAN_COUNTS["edge_bytes"] += int(counted[1])
    return rows[:n][::-1]


class MtIndex(NamedTuple):
    """An mt blob indexed for the card decoder (`mt_index`)."""

    length: int  # the blob's raw length
    words: np.ndarray  # uint8 [2 * nwords]: the blob's word region, at an even address
    index: np.ndarray  # int64 [coded, 5], kernels/mt_decode.py's INDEX_FIELDS
    states: np.ndarray  # uint32 [coded, n]
    fc: np.ndarray  # uint32 [coded, 256], freq | cumul << 16
    single: np.ndarray  # int64 [singles, 3]: out_start, size, symbol
    last_single: bool  # the last block is single-symbol


def mt_index(blob, bits: int, n: int) -> MtIndex | None:
    """The card decoder's operands of an mt blob by a native walk of its
    header chain (once to count the rows, once to write them), the blob
    read where it lies: the rows
    `kernels/mt_decode.py::index_blocks` + `block_operands` build (their
    single-symbol blocks as the `single` table), and the word region the
    kernel reads, a view of the blob unless it starts at an odd address,
    then one aligned copy of it.  None where that pair gives None (and for
    a length past int64, where it raises).  n is 32 or 64 and bits at most
    15, else ValueError.  Counted in `MT_INDEX_COUNTS`."""
    if n not in (32, 64) or not 0 <= bits <= 15:
        raise ValueError(f"mt_index: n must be 32 or 64 and bits in 0..15, not n={n}, bits={bits}")
    lib = load()
    buf = _as_u8(blob)
    MT_INDEX_COUNTS["calls"] += 1
    counts = np.zeros(4, np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)

    def walk(coded: int, singles: int):
        """The tables (index, states, fc, single) of that many rows, and the
        walk's return value."""
        tables = (np.empty((coded, 5), np.int64), np.empty((coded, n), np.uint32), np.empty((coded, 256), np.uint32),
                  np.empty((singles, 3), np.int64))
        index, states, fc, single = tables
        got = lib.hsr_mt_index(_u8p(buf), buf.size, bits, n, index.ctypes.data_as(i64p), _u32p(states), _u32p(fc),
                               coded, single.ctypes.data_as(i64p), singles, counts.ctypes.data_as(i64p))
        return tables, got

    # the first walk counts the rows, the second writes them into tables of
    # exactly that size (small enough to come from memory the process reuses)
    tables, got = walk(0, 0)
    if got == -2:
        tables, got = walk(int(counts[1]), int(counts[2]))
    if got < 0:
        MT_INDEX_COUNTS["refused"] += 1
        return None
    length, coded, singles, last_single = (int(v) for v in counts)
    words = buf[16 : 16 + 2 * ((buf.size - 16) // 2)]
    if words.ctypes.data % 2:
        words = words.copy()
        MT_INDEX_COUNTS["copied"] += 1
    else:
        MT_INDEX_COUNTS["in_place"] += 1
    MT_INDEX_COUNTS["coded"] += coded
    MT_INDEX_COUNTS["single"] += singles
    return MtIndex(length, words, *tables, bool(last_single))


def hist_spans(data: np.ndarray, spans, bits: int, threads: int = 0) -> np.ndarray:
    """`make_tile_hist(data[start:end], bits)`'s freqs for each (start, end)
    of `spans` in one call on the library's threads (0: one a core; the
    program leaves it so, and the tests set it to hold the result the same on
    any count): u16[k, 256]; an empty span gets the 1-symbol histogram.  A
    span outside the data, or one that ends before it starts, raises."""
    data = _as_u8(data)
    spans = np.ascontiguousarray(np.asarray(spans, dtype=np.int64).reshape(-1, 2))
    if spans.size and (spans.min() < 0 or spans.max() > data.size):
        raise ValueError(f"a span lies outside the {data.size} bytes of data")
    if (spans[:, 0] > spans[:, 1]).any():
        raise ValueError("a span ends before it starts")
    spans = spans.view(np.uint64)
    out = np.zeros((spans.shape[0], 256), dtype=np.uint16)
    load().hsr_hist_spans(_u8p(data), spans.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), spans.shape[0], bits,
                          _u16p(out), threads)
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
