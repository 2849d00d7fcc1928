#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (`hsrans_tpu_torch`).

    python3 chip_smoke.py        # from the repo root, on a machine with one CUDA card

Builds the port's CUDA kernels from `hsrans_tpu_torch/csrc` with nvcc, holds
each kernel against its plain PyTorch version on the same CUDA tensors
(exact equality: a lossless integer codec has zero tolerance), drives the
tpx round trip through the public entry points on 64 MiB of enwik8-like
text at the full 1024-row geometry, checks other depths, the v3 adaptive
wire and malformed blobs, and times the kernels and the round trip with
CUDA events and the host clock.  Every blob the card writes must equal the
port's CPU tier (the kernels' plain versions, which the CPU tests hold
byte-equal to the JAX package's encoders) and decode back to its input.
The script loads neither jax nor any module of the JAX package
(`hsrans_tpu`), and fails if one was loaded.  Every phase prints one JSON
line; any failure raises and exits non-zero.  The last three lines are the
card's name and power limit, the per-kernel summary, and
`{"ok": true, "device": {...}}`.

Exits non-zero, printing no result, where there is no CUDA card or when
the script stands outside a checkout of the repo.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

MIB = 1 << 20
GEOM = {"rows": 1024, "steps": 32, "n_tiles": 4}  # the default megablock (ops/tpx.py R, S, T)
KERNELS = {
    "tpx_decode": ("hsrans_tpu_torch/csrc/tpx_decode.cu", "hsrans_tpu/kernels/tpx_decode.py:41"),
    "tpx_encode": ("hsrans_tpu_torch/csrc/tpx_encode.cu", "hsrans_tpu/kernels/tpx_encode.py:128"),
    "tpx_concat": ("hsrans_tpu_torch/csrc/tpx_encode.cu", "hsrans_tpu/kernels/tpx_encode.py:260"),
}


def card() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return res.stdout.strip().splitlines()[0]


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields, "card": CARD}), flush=True)


def cuda_ms(fn, reps: int, queue_ahead: bool = False) -> float:
    """Mean milliseconds per call over `reps` calls after one warm-up, by
    CUDA events on the current stream.  With `queue_ahead` the card first
    spins for ~5 ms while the host queues the calls, so back-to-back kernels
    are timed without the host's per-launch cost in the gaps."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if queue_ahead:
        torch.cuda._sleep(10_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def host_s(fn, reps: int) -> list[float]:
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out


def max_abs_err(got, want) -> int:
    if isinstance(got, tuple):
        return max(max_abs_err(g, w) for g, w in zip(got, want))
    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)} != {tuple(want.shape)}")
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max().item())


def kernels_vs_plain(bits: int, data: np.ndarray, dev: torch.device) -> dict:
    """Each kernel against its plain version on the same CUDA tensors of one
    full megablock; times both."""
    from hsrans_tpu_torch.kernels import tpx_decode as dec
    from hsrans_tpu_torch.kernels import tpx_encode as enc

    rows, steps, n_tiles = GEOM["rows"], GEOM["steps"], GEOM["n_tiles"]
    packed, freqs, tabs, n_valid = enc.mega_operands(data, 0, n_tiles, data.size, bits=bits, rows=rows, steps=steps)
    ops = [torch.from_numpy(a).to(dev) for a in (packed, tabs["fc"], tabs["m"], tabs["l"])]
    res = {}

    def check(name, run_kernel, run_plain, reps_plain=2):
        got = run_kernel()
        torch.cuda.synchronize()
        want = run_plain()
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        if err:
            raise AssertionError(f"{name} B={bits}: kernel differs from its plain version (max abs err {err})")
        res[name] = {
            "max_abs_err": err,
            "ms": cuda_ms(run_kernel, 20, queue_ahead=True),
            "ms_host_paced": cuda_ms(run_kernel, 20),
            "plain_ms": cuda_ms(run_plain, reps_plain),
        }
        return got

    kw = {"bits": bits, "steps": steps, "vlen": n_valid}
    win, cnt, states = check(
        "tpx_encode", lambda: enc.encode_mega_cuda(*ops, **kw), lambda: enc.encode_mega_plain(*ops, **kw)
    )
    w_slots = enc.wire_w_slots(int(cnt.sum(dim=2).max()))
    stream = check(
        "tpx_concat", lambda: enc.concat_cuda(win, cnt, w_slots), lambda: enc.concat_plain(win, cnt, w_slots)
    )
    sym, fc = dec.dec_tables(freqs, bits)
    dops = (stream, states, torch.from_numpy(sym).to(dev), torch.from_numpy(fc).to(dev))
    out = check("tpx_decode", lambda: dec.decode_mega_cuda(*dops, **kw), lambda: dec.decode_mega_plain(*dops, **kw))
    if out.cpu().numpy().reshape(-1).view(np.uint8)[:n_valid].tobytes() != data.tobytes():
        raise AssertionError(f"B={bits}: the decode kernel does not return the encoded megablock")
    emit("kernels_vs_plain", bits=bits, geometry=GEOM, w_slots=w_slots, **res)
    return res


def main() -> int:
    global CARD
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 1
    repo = Path(__file__).resolve().parent
    sys.path.insert(0, str(repo))
    from hsrans_tpu_torch import banner, tpx_decode_torch, tpx_encode_adaptive_torch, tpx_encode_torch
    from hsrans_tpu_torch.runtime import build
    from tools.gen_inputs import text_like

    CARD = card()
    dev = torch.device("cuda", 0)

    def round_trip(name: str, data: np.ndarray, encode) -> bytes:
        """Encode on the card, hold the blob against the CPU tier's, and
        decode it back on the card."""
        blob = encode(data, "cuda")
        t0 = time.perf_counter()
        want = encode(data, "cpu")
        cpu_s = time.perf_counter() - t0
        if blob != want:
            raise AssertionError(f"{name}: the card's blob differs from the CPU tier's")
        if tpx_decode_torch(blob, device="cuda") != data.tobytes():
            raise AssertionError(f"{name}: decode on the card does not return the input")
        emit("round_trip", case=name, bytes=data.size, ratio=len(blob) / data.size, cpu_tier_encode_s=cpu_s)
        return blob

    # 1. probe: build the kernels from this checkout's sources and load them
    t0 = time.perf_counter()
    build.load()
    ptxas = [ln.strip() for ln in build.build_log().splitlines() if "Used" in ln or "entry function" in ln]
    emit("probe", banner=banner(), torch=torch.__version__, cuda=torch.version.cuda,
         build_s=build.build_seconds, load_s=time.perf_counter() - t0, ptxas=ptxas)

    # 2. each kernel against its plain version at the default geometry, B=12 and B=15
    mega = text_like(np.random.default_rng(8), 16 * MIB)
    per_bits = {bits: kernels_vs_plain(bits, mega, dev) for bits in (12, 15)}

    # 3. the main path at a size users run: 64 MiB enwik8-like text (bench.py's seed
    #    and size), four 16 MiB megas at the full 1024-row geometry
    data = text_like(np.random.default_rng(8), 64 * MIB)
    build.reset_launches()
    blob = tpx_encode_torch(data, 12, device="cuda")
    back = tpx_decode_torch(blob, device="cuda")
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    if back != data.tobytes():
        raise AssertionError("64 MiB: tpx_decode_torch does not return the input")
    if min(launches.values()) <= 0:
        raise AssertionError(f"the main path missed a kernel: {launches}")
    t0 = time.perf_counter()
    if blob != tpx_encode_torch(data, 12, device="cpu"):
        raise AssertionError("64 MiB: the card's blob differs from the CPU tier's")
    emit("main_path", bytes=data.size, ratio=len(blob) / data.size, launches=launches,
         cpu_tier_encode_s=time.perf_counter() - t0)

    # 4. other depths and the v3 adaptive wire
    for bits in (10, 15):
        round_trip(f"B={bits}", text_like(np.random.default_rng(bits), 16 * MIB),
                   lambda d, device, bits=bits: tpx_encode_torch(d, bits, device=device))
    corpus = np.fromfile(repo / "tests" / "corpus" / "corpus.bin", np.uint8)
    b3 = round_trip("v3 corpus", corpus, lambda d, device: tpx_encode_adaptive_torch(d, 12, device=device))

    # 5. malformed blobs: None or bytes, and no CUDA fault afterwards
    rng = np.random.default_rng(31)
    small_data = text_like(rng, MIB)
    small = round_trip("1 MiB", small_data, lambda d, device: tpx_encode_torch(d, 12, device=device))
    bad = [small[:cut] for cut in (0, 43, 44, 1000, len(small) // 2, len(small) - 1)]
    for pos, val in ((32, 0x7F), (36, 0xFF), (44, 0x00), (48, 0xFF)):
        b = bytearray(small)
        b[pos] = val
        bad.append(bytes(b))
    for src in (small, b3):
        for _ in range(6):
            b = bytearray(src)
            b[int(rng.integers(44, len(b)))] ^= int(rng.integers(1, 256))
            bad.append(bytes(b))
    outcomes = {"none": 0, "bytes": 0}
    for b in bad:
        out = tpx_decode_torch(b, device="cuda")
        if out is not None and not isinstance(out, bytes):
            raise AssertionError("malformed blob gave neither None nor bytes")
        outcomes["none" if out is None else "bytes"] += 1
    torch.cuda.synchronize()
    if tpx_decode_torch(small, device="cuda") != small_data.tobytes():
        raise AssertionError("decode after the malformed blobs failed")
    emit("malformed", blobs=len(bad), **outcomes)

    # 6. times: end to end on the 64 MiB main path, then one pass of each
    #    entry point split into its layers
    enc_s = host_s(lambda: tpx_encode_torch(data, 12, device="cuda"), 3)
    dec_s = host_s(lambda: tpx_decode_torch(blob, device="cuda"), 3)
    layers = {"decode_s": {}, "encode_s": {}}
    if tpx_decode_torch(blob, device="cuda", layers=layers["decode_s"]) != data.tobytes():
        raise AssertionError("64 MiB: the layer-timed decode does not return the input")
    if tpx_encode_torch(data, 12, device="cuda", layers=layers["encode_s"]) != blob:
        raise AssertionError("64 MiB: the layer-timed encode differs")
    emit(
        "times", bytes=data.size,
        encode_MiBps=data.size / MIB / statistics.median(enc_s), encode_s=enc_s,
        decode_MiBps=data.size / MIB / statistics.median(dec_s), decode_s=dec_s,
        layers=layers, kernels_B15=per_bits[15],
    )

    foreign = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "hsrans_tpu"))
    if foreign:
        raise AssertionError(f"the run loaded modules of JAX or of the JAX package: {foreign}")

    print(CARD)
    summary = []
    for name, (source, replaces) in KERNELS.items():
        r12 = per_bits[12][name]
        summary.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": max(per_bits[b][name]["max_abs_err"] for b in per_bits),
            "ms": r12["ms"], "plain_ms": r12["plain_ms"],
        })
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


CARD = ""

if __name__ == "__main__":
    sys.exit(main())
