"""Build-on-demand of the CUDA kernels and their ctypes bindings.

Every `hsrans_tpu_torch/csrc/*.cu` is compiled by `nvcc` (one process per
source, all started together, then one link) into one shared library with a
plain C interface, at first use (never at import), into
`build/hsrans_tpu_torch/` at the repo root (see `build_dir` for an installed
package and the override).  The library's name carries a
hash of the sources and flags, so an edit rebuilds and an unchanged tree
reuses it.  Unlike `hsrans_tpu/runtime/native.py`, a missing `nvcc` or a
failed build raises: there is no fallback for the `cuda` tier.

Every C entry point returns `cudaGetLastError()` after its launch;
`launch()` raises when that is not 0 and otherwise counts the launch in
`LAUNCHES`, so a run can show which kernels it went through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# kernel name -> successful launches since the last reset_launches()
LAUNCHES: dict[str, int] = {
    "tpx_decode": 0, "tpx_encode": 0, "tpx_concat": 0, "mt_decode": 0, "mt_annotate": 0, "mt_decode_annotated": 0,
    "mt_encode": 0, "mt_place": 0, "hist_count": 0, "hist_normalize": 0, "scan_decode": 0, "scan_encode": 0,
}

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_SIGNATURES = {
    # blob, blob bytes, mega descriptors, megas, CTAs, row starts, init states, sym table, fc table, out, bits,
    # cuda stream
    "hsr_tpx_decode": [_P, ctypes.c_longlong, _P, _I, _I, _P, _P, _P, _P, _P, _I, _P],
    # data, mega descriptors, megas, CTAs, fc, m, l, win, cnt, states, bits, cuda stream
    "hsr_tpx_encode": [_P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _I, _P],
    # win, cnt, states, freqs, wire descriptors, megas, CTAs, row starts, out, out u16s, v3, cuda stream
    "hsr_tpx_wire": [_P, _P, _P, _P, _P, _I, _I, _P, _P, ctypes.c_longlong, _I, _P],
    # stream, index, init states, fc table, out, final states, cursors, nb, n, bits, nwords, length, cuda stream
    "hsr_mt_decode": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, ctypes.c_longlong, ctypes.c_longlong, _P],
    # stream, index, fc table, annotation, nb, bits, nwords, cuda stream
    "hsr_mt_annotate": [_P, _P, _P, _P, _I, _I, ctypes.c_longlong, _P],
    # annotation, then as hsr_mt_decode
    "hsr_mt_decode_annotated": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, ctypes.c_longlong, ctypes.c_longlong, _P],
    # data, index, freqs, magic table, words, final states, counts, nb, n, bits, zero_freq_emits, data_len,
    # words_cap, cuda stream
    "hsr_mt_encode": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_longlong, ctypes.c_longlong, _P],
    # words, index, counts, final states, freqs, nb, place rows, rows, out, n, words_cap, out u16s, cuda stream
    "hsr_mt_wire": [_P, _P, _P, _P, _P, _I, _P, _I, _P, _I, ctypes.c_longlong, ctypes.c_longlong, _P],
    # data, segment rows, short segments, long segments, chunks, chunk bytes, counts, cuda stream
    "hsr_hist_count": [_P, _P, _I, _I, ctypes.c_longlong, ctypes.c_longlong, _P, _P],
    # counts, divisors, rows, bits, freq, cumul, cuda stream
    "hsr_hist_normalize": [_P, _P, _I, _I, _P, _P, _P],
    # states, stream, stream stride, stream words, read_pos, sym, freq, cumul tables, table stride, table length,
    # valid counts, symbols, final states, final read_pos, streams, n, bits, steps, tail, cuda stream
    "hsr_scan_decode": [_P, _P, _LL, _LL, _P, _P, _P, _P, _LL, _LL, _P, _P, _P, _P, _I, _I, _I, _LL, _I, _P],
    # states, group bytes, valid, freq, cumul tables, table stride, words, emits, final states, streams, n, bits,
    # emit point, steps, magic table, cuda stream
    "hsr_scan_encode": [_P, _P, _P, _P, _P, _LL, _P, _P, _P, _I, _I, _I, _LL, _LL, _P, _P],
}

_lib = None
_lock = threading.Lock()
build_seconds: float | None = None  # wall time of this process's nvcc run (None: reused a cached build)


def _nvcc() -> str:
    cand = [shutil.which("nvcc")]
    if os.environ.get("CUDA_HOME"):
        cand.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cand.append("/usr/local/cuda/bin/nvcc")
    for c in cand:
        if c and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): cannot build the CUDA kernels")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(_CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    """Where the library is built: `$HSRANS_TPU_TORCH_BUILD_DIR` if set,
    else `build/hsrans_tpu_torch/` beside the package (the repo root of a
    checkout) where that can be written, else a per-user cache (an
    installed package whose site-packages is read-only or shared)."""
    if os.environ.get("HSRANS_TPU_TORCH_BUILD_DIR"):
        return Path(os.environ["HSRANS_TPU_TORCH_BUILD_DIR"])
    local = _PKG.parent / "build" / "hsrans_tpu_torch"
    existing = local
    while not existing.exists():
        existing = existing.parent
    if os.access(existing, os.W_OK):
        return local
    return Path.home() / ".cache" / "hsrans_tpu_torch"


def library_path() -> Path:
    return build_dir() / f"libhsrans_tpu_torch_{_source_hash()}.so"


def _compile(so: Path) -> None:
    global build_seconds
    so.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}.tmp"
    tmp = so.with_suffix(f".{tag}")
    objs = {src: so.with_suffix(f".{src.stem}.{tag}.o") for src in sorted(_CSRC.glob("*.cu"))}
    t0 = time.perf_counter()
    procs = [
        subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for src, obj in objs.items()
    ]
    runs = []
    for p in procs:
        out, err = p.communicate()  # waits for every process
        runs.append((" ".join(p.args), p.returncode, out, err))
    if all(rc == 0 for _, rc, _, _ in runs):
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", str(tmp), *map(str, objs.values())]
        res = subprocess.run(cmd, capture_output=True, text=True)
        runs.append((" ".join(cmd), res.returncode, res.stdout, res.stderr))
    build_seconds = time.perf_counter() - t0
    for obj in objs.values():
        obj.unlink(missing_ok=True)
    so.with_suffix(".log").write_text("".join(f"{cmd}\n{out}{err}" for cmd, _, out, err in runs))
    failed = [(cmd, rc, err) for cmd, rc, _, err in runs if rc != 0]
    if failed:
        tmp.unlink(missing_ok=True)
        cmd, rc, err = failed[0]
        raise RuntimeError(f"nvcc failed ({rc}): {cmd}\n{err[-4000:]}")
    os.replace(tmp, so)  # atomic: a concurrent process sees the whole library or none


def load():
    """The kernel library, built first if this tree's sources have no build."""
    global _lib
    with _lock:
        if _lib is None:
            so = library_path()
            if not so.exists():
                _compile(so)
            lib = ctypes.CDLL(str(so))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.hsr_cuda_error_string.argtypes = [ctypes.c_int]
            lib.hsr_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def build_log() -> str:
    """nvcc's command line and ptxas report of the current build."""
    log = library_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""


def launch(kernel: str, fn_name: str, device: torch.device, *args) -> None:
    """Call one C entry point on `device`'s current stream; raise on a CUDA
    error, count the launch otherwise."""
    lib = load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, fn_name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{fn_name}: CUDA error {rc} ({lib.hsr_cuda_error_string(rc).decode()})")
    LAUNCHES[kernel] += 1


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def check_cuda(
    name: str,
    *tensors: torch.Tensor,
    uint8: tuple[int, ...] = (),
    int16: tuple[int, ...] = (),
    int64: tuple[int, ...] = (),
) -> torch.device:
    """Wrapper-side validation: every operand a contiguous CUDA tensor on one
    device, int32 except the positions listed in `uint8`, `int16` and
    `int64`."""
    dev = tensors[0].device
    for i, t in enumerate(tensors):
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: every operand must lie on one CUDA device (got {t.device})")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
        want = torch.uint8 if i in uint8 else torch.int16 if i in int16 else torch.int64 if i in int64 else torch.int32
        if t.dtype != want:
            raise ValueError(f"{name}: operand {i} must be {want} (got {t.dtype})")
    return dev
