#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (`hsrans_tpu_torch`).

    python3 chip_smoke.py        # from the repo root, on a machine with one CUDA card

Builds the port's CUDA kernels from `hsrans_tpu_torch/csrc` with nvcc, holds
each kernel against its plain PyTorch version on the same CUDA tensors
(exact equality: a lossless integer codec has zero tolerance), and drives
the port's two paths through their public entry points:

  * tpx: the round trip on 64 MiB of enwik8-like text at the full 1024-row
    geometry (four megas: one launch each of the encode, the wire writer,
    which writes the blob's ragged sections on the card, and the decode,
    which reads them as they are), other depths, the v3 adaptive wire,
    malformed blobs, and the decode kernel's ragged reads and window at
    their edges (`TPX_DECODE_EDGES`, which the card tests run too);
  * mt: decode of the C++ reference's mt wire on 64 MiB of x-ray
    (`device_plan` blocks, B=12, n=64), other depths, n=32, the reference
    planner's blocks, odd tails, single-symbol runs and malformed blobs, on
    blobs made by the port's numpy copy of the reference's carried-state
    encoder;
  * mt annotated: the same decode through the annotated-stream route
    (`kernels/mt_decode.py::_PAIR_V2`: an annotate launch, then the
    annotated decode), its two kernels timed against the rank route's on
    the same operands at B=10..15, n=32 and 64, through the wrappers and
    by the launches alone;
  * mt encode: the same 64 MiB of x-ray and 64 MiB of enwik8-like text in
    uniform 4 KiB blocks encoded on the card and decoded on the card, other
    depths, n=32 (`mt_encode_device`), the reference planner's blocks, odd
    tails, single-symbol runs and block sizes off the 64-byte grid, and
    the reference planner's blocks (up to 2^25 bytes) on a homogeneous
    input;
  * the histogram model (`models/device_hist.py`): its count and
    normalise kernels on mt encode (b)'s 16,384 blocks of 4 KiB, the 64 MiB
    tpx main path's 16 tiles, the reference planner's 2^25-byte block and
    at their edges (`HIST_EDGES`, which the card tests run too), with the
    segmented `torch.bincount` of the same segments as the count's
    yardstick; tpx encode and mt encode (b) take their histograms on the
    card, one launch of each kernel a call, with no wait on the card, and
    their `kernel_hist` layer is split into its steps;
  * the XLA scan codecs (`kernels/scan.py`, the port of `ops/raw_jax.py`'s
    `decode_section` and `encode_section`): both kernels against their plain
    versions (`SCAN_EDGES`: per-stream and shared streams and tables,
    streams cut short so that reads run past their end, `__graft_entry__.entry`'s
    random tables, tables cut short and of 2^16 slots, streams whose reads
    run into the ring's refills past their end, encode divisors over all of
    u16 and states over all of u32; n = 16, 32, 64 at B = 10, 12, 15 and
    more), the raw wire's round
    trip on 64 MiB of enwik8-like text at n = 64, 32 and 16 (one chain
    each), `mt_decode_device`'s chain on the 64 MiB x-ray blob (step (a),
    then the batched scan decode of step (c) alone), the n=16 mt round trip
    on 64 MiB of x-ray (both scan kernels batched at full width), the split
    of mt and tpx over two devices (one card named twice), and malformed
    mt blobs through the whole chain;
  * the CLI (`python -m hsrans_tpu_torch.cli`, phase 13) in process at the
    cuda tier: `--test` over B 10-15 on a prefix of the 64 MiB text (all
    72 rows OK; the host rows on the native C++ codecs launch no kernel,
    the tpx and mt dev rows launch theirs), every row's blob on a 1 MiB
    prefix equal to the torch tier's, the B=12 table of three runs (one
    JSON line a row), and `utils/profiling.trace` (`torch.profiler`)
    around one 64 MiB tpx decode and one mt dev round trip: the card's
    busy share of each window;
  * the mt decode and encode kernels' shared-memory windows at their edges
    (`DECODE_EDGES`, `ENCODE_EDGES`; the annotated route's two kernels on
    `DECODE_EDGES` too), and the two wire writers, tpx and
    mt, at theirs (`TPX_WIRE_EDGES`, `MT_PLACE_EDGES`), which the card tests
    run too;

and times the kernels and the paths with CUDA events and the host clock.
The tpx and mt decode and encode kernels and the two wire writers are
timed twice (the annotated decode too): through their wrappers (`ms`,
which allocate their outputs) and by their launch alone on outputs
allocated once (`launch_ms`; for the chains also `link_us`, that over the
chain's links: a tpx row's 4 tiles x 32 steps, an mt block's groups).  The
wire writers' launches alone also write into outputs filled with 0xAA
first, to show that they write every byte.
Every blob the card writes must equal the port's CPU tier (the kernels'
plain versions, which the CPU tests hold byte-equal to the JAX package) and
decode back to its input.
The script loads neither jax nor any module of the JAX package
(`hsrans_tpu`), and fails if one was loaded.  Every phase prints one JSON
line; any failure raises and exits non-zero.  The last three lines are the
card's name and power limit, the per-kernel summary, and
`{"ok": true, "device": {...}}`.

Exits non-zero, printing no result, where there is no CUDA card or when
the script stands outside a checkout of the repo.
"""

from __future__ import annotations

import functools
import json
import multiprocessing
import statistics
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np
import torch

MIB = 1 << 20
HEAD_U16 = 22  # the tpx blob's 44-byte header, which the wire writer's sections follow
GEOM = {"rows": 1024, "steps": 32, "n_tiles": 4}  # the default megablock (ops/tpx.py R, S, T)
KERNELS = {
    "tpx_decode": ("hsrans_tpu_torch/csrc/tpx_decode.cu", "hsrans_tpu/kernels/tpx_decode.py:41"),
    "tpx_encode": ("hsrans_tpu_torch/csrc/tpx_encode.cu", "hsrans_tpu/kernels/tpx_encode.py:128"),
    "tpx_concat": ("hsrans_tpu_torch/csrc/tpx_encode.cu", "hsrans_tpu/kernels/tpx_encode.py:260"),
    "mt_decode": (
        "hsrans_tpu_torch/csrc/mt_decode.cu",
        [
            "hsrans_tpu/kernels/mt64_decode.py:127",
            "hsrans_tpu/kernels/mt64_decode.py:680",
            "hsrans_tpu/kernels/mt64_decode.py:1552",
            "hsrans_tpu/kernels/mt32_quad.py:46",
        ],
    ),
    "mt_annotate": ("hsrans_tpu_torch/csrc/mt_decode.cu", "hsrans_tpu/kernels/mt64_decode.py:1260"),
    "mt_decode_annotated": ("hsrans_tpu_torch/csrc/mt_decode.cu", "hsrans_tpu/kernels/mt64_decode.py:1282"),
    "mt_encode": ("hsrans_tpu_torch/csrc/mt_encode.cu", "hsrans_tpu/kernels/mt64_encode.py:52"),
    # the mt encoder's phase B: the tpx concat kernel run per segment, then the host's join of the words
    "mt_place": ("hsrans_tpu_torch/csrc/mt_encode.cu", "hsrans_tpu/kernels/tpx_encode.py:260"),
    # the on-device histogram model, XLA in the JAX package and not Pallas
    "hist_count": ("hsrans_tpu_torch/csrc/hist.cu", "hsrans_tpu/models/jax_hist.py:31"),
    "hist_normalize": ("hsrans_tpu_torch/csrc/hist.cu", "hsrans_tpu/models/jax_hist.py:68"),
    # the XLA scan codecs (lax.scan in the JAX package, not Pallas)
    "scan_decode": ("hsrans_tpu_torch/csrc/scan.cu", "hsrans_tpu/ops/raw_jax.py:48"),
    "scan_encode": ("hsrans_tpu_torch/csrc/scan.cu", "hsrans_tpu/ops/raw_jax.py:161"),
}
# the least time the card could take for a kernel's work: the bytes this
# run's data needs (each input read once, each output written once: the
# emitted words, not the padded windows that hold them) over the H100's
# 3.35 TB/s, or its integer operations over the card's INT32 rate
# (int32_ops_per_s), whichever is larger.  Operations per coded symbol as the
# algorithm states them: decode 8 (mask, shift, multiply, add, subtract,
# compare, shift, or), encode 10 (shift, compare, shift, select, multiply,
# shift, shift, add, multiply, subtract); the compactions count their bytes
# only.
HBM_BYTES_PER_S = 3.35e12
OPS_PER_SYMBOL = {"decode": 8, "encode": 10}
# the annotate pass per word of a coded block: mask, shift, shift, subtract,
# and, popcount, add (the rank), shift, or; plus the bucket's index, 10
ANNOTATE_OPS_PER_WORD = 10
INT32_LANES_PER_SM = 64  # a Hopper SM's INT32 units (NVIDIA's H100 architecture whitepaper)
# bench.py's device_plan caps of the mt x-ray rows, by depth
MT_CAPS = {10: 16 << 10, 12: 24 << 10, 13: 16 << 10, 14: 24 << 10, 15: 32 << 10}


def card() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return res.stdout.strip().splitlines()[0]


def int32_ops_per_s() -> float:
    """The card's INT32 operations a second outside the tensor cores: its SMs
    × INT32_LANES_PER_SM × its maximum SM clock (132 × 64 × 1.98 GHz = 16.7
    T/s on an H100 SXM)."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    mhz = float(res.stdout.strip().splitlines()[0])
    return torch.cuda.get_device_properties(0).multi_processor_count * INT32_LANES_PER_SM * mhz * 1e6


def emit(phase: str, **fields) -> None:
    """One phase's JSON line, with the seconds since the script started."""
    print(json.dumps({"phase": phase, **fields, "elapsed_s": time.perf_counter() - START, "card": CARD}), flush=True)


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


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(moved: int, ops: int) -> dict:
    moved, ops = int(moved), int(ops)
    by_bytes, by_ops = moved / HBM_BYTES_PER_S * 1e3, ops / OPS_PER_S * 1e3
    return {"bound_ms": max(by_bytes, by_ops), "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bytes_moved": moved, "int_ops": ops}


def launch_times(launch, max_groups: int) -> dict:
    """A kernel's launch alone (no allocation, no fill of its outputs) by
    CUDA events over 20 launches queued ahead, and that time over the
    longest block's groups: one link of a lane's chain, in microseconds."""
    ms = cuda_ms(launch, 20, queue_ahead=True)
    return {"launch_ms": ms, "link_us": ms * 1e3 / max(max_groups, 1)}


def max_abs_err(got, want) -> int:
    if isinstance(got, tuple):
        return max(max_abs_err(g, w) for g, w in zip(got, want))
    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)} != {tuple(want.shape)}")
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max().item())


def kernels_vs_plain(bits: int, data: np.ndarray, dev: torch.device) -> dict:
    """Each tpx kernel against its plain version on the same CUDA tensors of
    the main path's call: every mega of `data` at the default geometry in
    one launch of the encode, one of the wire writer and one of the decode;
    times each through its wrapper and by its launch alone on outputs
    allocated once."""
    from hsrans_tpu_torch import tpx_encode_torch
    from hsrans_tpu_torch.kernels import tpx_decode as dec
    from hsrans_tpu_torch.kernels import tpx_encode as enc
    from hsrans_tpu_torch.ops.tpx import TpxParams, _mega_layout

    p = TpxParams(bits=bits)
    geoms = [(base, p.rows, p.steps, n_tiles, valid) for base, n_tiles, valid in _mega_layout(data.size, p)]
    data_t = torch.from_numpy(data).to(dev)
    desc, freqs_t, *ops = enc.mega_operands(data_t, geoms, bits=bits)
    res = {}
    links = p.tiles * p.steps  # one lane's chain: every step of every tile of its row

    def check(name, run_kernel, run_plain, moved, ops, reps_plain=2, launch=None, per=1):
        got = run_kernel()
        torch.cuda.synchronize()
        want = run_plain()
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        if err:
            raise AssertionError(f"{name} B={bits}: kernel differs from its plain version (max abs err {err})")
        b = bound(moved(got) / per, ops / per)
        res[name] = {
            "max_abs_err": err,
            "ms": cuda_ms(run_kernel, 20, queue_ahead=True) / per,
            "ms_host_paced": cuda_ms(run_kernel, 20) / per,
            "plain_ms": cuda_ms(run_plain, reps_plain) / per,
            **b,
        }
        if launch is not None:
            res[name] |= launch_times(launch, links)
        return got

    n_valid = int(desc[:, enc.ENCODE_FIELDS.index("vlen")].sum())
    eouts = tuple(torch.empty_like(t) for t in enc.encode_mega_cuda(data_t, desc, *ops, bits=bits))
    desc_t = torch.from_numpy(desc).to(dev)
    # the encode writes, and the wire writer reads, only the emitted u32 words of each padded window
    outs = check(
        "tpx_encode", lambda: enc.encode_mega_cuda(data_t, desc, *ops, bits=bits),
        lambda: enc.encode_mega_plain(data_t, desc, *ops, bits=bits),
        lambda got: nbytes(data_t, *ops, got[1], got[2]) + 4 * int(got[1].sum()), OPS_PER_SYMBOL["encode"] * n_valid,
        launch=lambda: enc.launch_encode(data_t, desc_t, *ops, *eouts, bits=bits, ctas=enc.ctas_of(desc)),
    )
    # the wire writer behind the blob's 44-byte header, as tpx_encode_torch
    # calls it: it reads the kept words' u32s, the counts, states, freqs and
    # the layout, and writes the sections
    row_words = torch.cat([c.sum(dim=2).reshape(-1) for _, c, _ in enc.mega_views(*outs, desc)]).cpu().numpy()
    wdesc, row_at, out_u16 = enc.wire_layout(desc, row_words, v3=False, base=HEAD_U16)
    wargs, wkw = (*outs, freqs_t, wdesc, row_at), {"v3": False, "out_u16": out_u16}
    wout = torch.empty(out_u16, dtype=torch.int16, device=dev)
    wlaunch = wire_launch(wargs, wkw, wout, dev)
    check(
        "tpx_concat", lambda: enc.write_wire_cuda(*wargs, **wkw)[2 * HEAD_U16 :],
        lambda: enc.write_wire_plain(*wargs, **wkw)[2 * HEAD_U16 :],
        lambda got: 4 * int(row_words.sum()) + nbytes(*outs[1:], wargs[3]) + row_at.nbytes + wdesc.nbytes + got.numel(),
        0, launch=wlaunch,
    )
    del res["tpx_concat"]["link_us"]  # the writer runs no chain
    res["tpx_concat"]["every_byte_written"] = prefilled_equal(wlaunch, wout, enc.write_wire_plain(*wargs, **wkw), HEAD_U16)
    w_slots = wdesc[:, enc.WIRE_FIELDS.index("w_slots")].tolist()
    blob = tpx_encode_torch(data, bits, device="cuda")
    args, kw = tpx_decode_args(blob, dev)
    blob_t, ddesc, *dops = args
    dout = torch.empty(kw["out_len"], dtype=torch.uint8, device=dev)
    ddesc_t = torch.from_numpy(ddesc).to(dev)
    words = 2 * int(row_words.sum())  # the decode reads each row's words (u16), not the wire's rest
    out = check(
        "tpx_decode", lambda: dec.decode_mega_cuda(*args, **kw), lambda: dec.decode_mega_plain(*args, **kw),
        lambda got: words + nbytes(*dops) + data.size, OPS_PER_SYMBOL["decode"] * data.size,
        launch=lambda: dec.launch_decode(blob_t, ddesc_t, *dops, dout, bits=bits, ctas=dec.ctas_of(ddesc)),
    )
    if out[: data.size].cpu().numpy().tobytes() != data.tobytes():
        raise AssertionError(f"B={bits}: the decode kernel does not return the encoded input")
    emit("kernels_vs_plain", bits=bits, bytes=data.size, megas=len(desc), geometry=GEOM, w_slots=w_slots, **res)
    return res


def wire_launch(wargs: tuple, wkw: dict, out: torch.Tensor, dev: torch.device):
    """The wire writer's launch alone into `out`, its layout on the card."""
    from hsrans_tpu_torch.kernels import tpx_encode as enc

    win, cnt, states, freqs, wdesc, row_at = wargs
    wdesc_t, row_at_t = torch.from_numpy(wdesc).to(dev), torch.from_numpy(row_at).to(dev)
    ctas = enc.wire_ctas(wdesc)
    return lambda: enc.launch_wire(win, cnt, states, freqs, wdesc_t, row_at_t, out, v3=wkw["v3"], ctas=ctas)


def prefilled_equal(launch, out: torch.Tensor, want: torch.Tensor, skip_u16: int) -> bool:
    """`out` filled with the byte 0xAA, then one launch that writes it: from
    u16 `skip_u16` on it must equal `want` (uint8), so the launch wrote
    every byte there, and below it nothing."""
    out.fill_(-0x5556)  # 0xAAAA
    launch()
    torch.cuda.synchronize()
    got = out.view(torch.uint8)
    err = max_abs_err(got[2 * skip_u16 :], want[2 * skip_u16 :])
    if err or (got[: 2 * skip_u16] != 0xAA).any():
        raise AssertionError(f"a launch into a 0xAA-filled output left a byte unwritten or wrote outside (err {err})")
    return True


def tpx_decode_args(blob: bytes, dev: torch.device, shift: int = 0) -> tuple[tuple, dict]:
    """The decode kernel's operands and keywords for `blob`, placed `shift`
    bytes into the buffer that goes to the card."""
    from hsrans_tpu_torch.kernels import tpx_decode as dec
    from hsrans_tpu_torch.ops.tpx import tpx_parse

    p, length, megas = tpx_parse(blob)
    sym, fc = dec.dec_tables(np.concatenate([m.freqs for m in megas]), p.bits)
    desc, row_start, states = dec.decode_operands(megas, length)
    desc[:, dec.DECODE_FIELDS.index("slot_off")] += shift
    buf = np.concatenate([np.zeros(shift, np.uint8), np.frombuffer(blob, np.uint8)])
    args = (torch.from_numpy(buf).to(dev), desc,
            *(torch.from_numpy(a).to(dev) for a in (row_start, states.view(np.int32), sym, fc)))
    return args, {"bits": p.bits, "out_len": -(-length // 4) * 4}


def mt_kernel_vs_plain(name: str, blob: bytes, bits: int, n: int, dev: torch.device) -> dict:
    """The mt kernel against its plain version on the same CUDA tensors of
    one blob; times both."""
    from hsrans_tpu_torch.kernels import mt_decode as mtd

    length, stream, blocks, w_counts = mtd.index_blocks(blob, n)
    ops = mtd.block_operands(length, stream, blocks, w_counts, bits, n)
    args = mtd.device_operands(stream, *ops, n, dev)
    kw = {"bits": bits, "n": n, "length": length}
    got = mtd.decode_blocks_cuda(*args, **kw)
    torch.cuda.synchronize()
    want = mtd.decode_blocks_plain(*args, **kw)
    err = max_abs_err(got, want)
    if err:
        raise AssertionError(f"mt {name}: kernel differs from its plain version (max abs err {err})")
    outs = tuple(torch.empty_like(t) for t in got)  # the launch alone: outputs allocated once
    max_groups = int(ops[0][:, 4].max())
    res = {
        "case": name, "bits": bits, "n": n, "blocks": int(ops[0].shape[0]), "max_abs_err": err,
        "max_groups": max_groups,
        "ms": cuda_ms(lambda: mtd.decode_blocks_cuda(*args, **kw), 20, queue_ahead=True),
        **launch_times(lambda: mtd.launch_decode(*args, *outs, bits=bits, n=n), max_groups),
        "ms_host_paced": cuda_ms(lambda: mtd.decode_blocks_cuda(*args, **kw), 20),
        "plain_ms": cuda_ms(lambda: mtd.decode_blocks_plain(*args, **kw), 1),
        **bound(nbytes(*args, *got), OPS_PER_SYMBOL["decode"] * length),
    }
    emit("mt_kernels_vs_plain", **res)
    return res


def mt_phases(repo: Path, dev: torch.device) -> tuple[list[dict], int, dict]:
    """mt decode on the card: the kernel against its plain version per
    routing class of the JAX dispatcher and at the 64 MiB main path's
    launch, the main path, round trips, malformed blobs and times.  Returns
    the kernel rows (the main path's first), the main path's launch count,
    and the inputs and plans made here, which the mt encode phases reuse."""
    from hsrans_tpu_torch import mt_decode_torch
    from hsrans_tpu_torch.ops.mt import mt_encode_py
    from hsrans_tpu_torch.ops.planner import plan_blocks_py
    from hsrans_tpu_torch.parallel.sharded import device_plan, uniform_plan
    from hsrans_tpu_torch.runtime import build
    from tools.gen_inputs import text_like

    xray = np.fromfile(repo / "tests" / "corpus" / "xray.bin", np.uint8)
    encode_s: dict[str, float] = {}
    plans: dict = {}

    def encode(name: str, data: np.ndarray, bits: int, n: int, plan) -> bytes:
        t0 = time.perf_counter()
        blob = mt_encode_py(data, bits, n, plan)
        encode_s[name] = time.perf_counter() - t0
        return blob

    def dp(bits: int, n: int) -> tuple[str, np.ndarray, int, int, bytes]:
        name = f"x-ray n={n} B={bits} device_plan {MT_CAPS[bits] >> 10} KiB"
        plans[(bits, n)] = device_plan(xray, bits, n, MT_CAPS[bits])
        return name, xray, bits, n, encode(name, xray, bits, n, plans[(bits, n)])

    # 1. the kernel against its plain version, one 8 MiB x-ray blob per
    #    routing class of mt64_decode_tpu: #5, #8 (n=64 and n=32 halves),
    #    #9, and #4 (the odd leftover of 511 same-size kernel blocks)
    classes = [dp(12, 64), dp(15, 64), dp(12, 32), dp(14, 32)]
    name = "x-ray n=64 B=12 uniform 16 KiB"
    classes.append((name, xray, 12, 64, encode(name, xray, 12, 64, uniform_plan(xray, 12, 64, 16 << 10))))
    rows = [mt_kernel_vs_plain(name, blob, bits, n, dev) for name, _, bits, n, blob in classes]

    # 2. the main path: 64 MiB of x-ray (bench.py's mt_dp_xray rows), B=12,
    #    n=64, device_plan with a 24 KiB cap
    data = np.tile(xray, 8)
    t0 = time.perf_counter()
    plan = device_plan(data, 12, 64, MT_CAPS[12])
    plan_s = time.perf_counter() - t0
    blob = encode("main", data, 12, 64, plan)
    build.reset_launches()
    back = mt_decode_torch(blob, 12, 64, device="cuda")
    torch.cuda.synchronize()
    launches = build.LAUNCHES["mt_decode"]
    if back != data.tobytes():
        raise AssertionError("mt 64 MiB: mt_decode_torch does not return the input")
    if launches != 1:
        raise AssertionError(f"mt 64 MiB: {launches} mt_decode launches for one decode call")
    emit("mt_main_path", bytes=data.size, ratio=len(blob) / data.size, blocks=len(plan),
         coded_blocks=sum(not r.is_single for r in plan), launches=launches, plan_s=plan_s,
         cpu_tier_encode_s=encode_s["main"])
    # the kernel against its plain version at the main path's own launch
    rows.insert(0, mt_kernel_vs_plain("x-ray 64 MiB main path", blob, 12, 64, dev))

    # 3. round trips, each held against the input and the CPU tier
    rng = np.random.default_rng(21)
    trips = [dp(10, 64), dp(13, 64), dp(14, 64), classes[1], classes[2], classes[3]]
    corpus = np.fromfile(repo / "tests" / "corpus" / "corpus.bin", np.uint8)
    name = "corpus.bin reference planner"
    plans["corpus"] = plan_blocks_py(corpus, 12, "mt", 64)
    planner_blob = encode(name, corpus, 12, 64, plans["corpus"])
    trips.append((name, corpus, 12, 64, planner_blob))
    odd = text_like(rng, (1 << 20) + 64 * 5 + 17)  # the last block's tail: 17 bytes past a group
    for n in (32, 64):
        name = f"uniform 64 KiB odd tail n={n}"
        trips.append((name, odd, 12, n, encode(name, odd, 12, n, uniform_plan(odd, 12, n, 64 << 10))))
    runs = np.concatenate([text_like(rng, 300_000), np.full(200_000, 9, np.uint8), text_like(rng, 300_000), np.full(150_001, 200, np.uint8)])
    name = "single-symbol runs between coded blocks"
    plans["runs"] = device_plan(runs, 12, 64, 24 << 10)
    trips.append((name, runs, 12, 64, encode(name, runs, 12, 64, plans["runs"])))
    for name, src, bits, n, b in trips:
        got = mt_decode_torch(b, bits, n, device="cuda")
        if got != src.tobytes():
            raise AssertionError(f"mt {name}: decode on the card does not return the input")
        t0 = time.perf_counter()
        if mt_decode_torch(b, bits, n, device="cpu") != got:
            raise AssertionError(f"mt {name}: the card's output differs from the CPU tier's")
        emit("mt_round_trip", case=name, bits=bits, n=n, bytes=src.size, ratio=len(b) / src.size,
             encode_s=encode_s.get(name), cpu_tier_decode_s=time.perf_counter() - t0)

    # 4. malformed blobs: None or bytes, and no CUDA fault afterwards
    small_data = text_like(rng, 1 << 20)
    small = mt_encode_py(small_data, 12, 64, uniform_plan(small_data, 12, 64, 16 << 10))
    bad = [small[:cut] for cut in (0, 15, 16, 1000, len(small) // 2, len(small) - 1)]
    # flips of the length's low bytes (its high bytes would ask for petabytes
    # of output), the block headers, the states, the freqs and the words
    for lo, hi in ((0, 3), (16, 32), (32, 288), (288, 800), (800, len(small))):
        for _ in range(4):
            b = bytearray(small)
            b[int(rng.integers(lo, hi))] ^= int(rng.integers(1, 256))
            bad.append(bytes(b))
    outcomes = {"none": 0, "bytes": 0}
    for b in bad:
        out = mt_decode_torch(b, 12, 64, device="cuda")
        if out is not None and not isinstance(out, bytes):
            raise AssertionError("mt: a malformed blob gave neither None nor bytes")
        outcomes["none" if out is None else "bytes"] += 1
    torch.cuda.synchronize()
    if mt_decode_torch(small, 12, 64, device="cuda") != small_data.tobytes():
        raise AssertionError("mt: decode after the malformed blobs failed")
    emit("mt_malformed", blobs=len(bad), **outcomes)

    # 5. times: the 64 MiB decode end to end and split into its layers, and
    #    the reference planner's blob (few, large blocks)
    dec_s = host_s(lambda: mt_decode_torch(blob, 12, 64, device="cuda"), 3)
    layers: dict[str, float] = {}
    if mt_decode_torch(blob, 12, 64, device="cuda", layers=layers) != data.tobytes():
        raise AssertionError("mt 64 MiB: the layer-timed decode does not return the input")
    planner_s = host_s(lambda: mt_decode_torch(planner_blob, 12, 64, device="cuda"), 3)
    emit("mt_times", bytes=data.size, decode_MiBps=data.size / MIB / statistics.median(dec_s), decode_s=dec_s,
         layers=layers, planner_blob={"bytes": corpus.size, "decode_s": planner_s,
                                      "decode_MiBps": corpus.size / MIB / statistics.median(planner_s)})
    ctx = {"xray": xray, "plans": plans, "main": (data, plan), "corpus": corpus, "odd": odd, "runs": runs,
           "main_blob": blob, "classes": classes, "trips": trips, "malformed": (small_data, small, bad)}
    return rows, launches, ctx


def mt_annotated_kernels(name: str, blob: bytes, bits: int, n: int, dev: torch.device) -> dict:
    """The annotated route's two kernels against their plain versions (and
    the annotated decode against the rank kernel) on the same CUDA tensors
    of one blob; times them and the rank kernel on those operands in turns
    (rank, annotate, annotated decode, then back), each by CUDA events over
    20 launches queued ahead: through the wrappers (`ab`), and by the
    decodes' launches alone on outputs allocated once (`ab.launch`; the
    annotate wrapper allocates its output uninitialised, so it is its launch
    alone)."""
    from hsrans_tpu_torch.kernels import mt_decode as mtd

    length, stream, blocks, w_counts = mtd.index_blocks(blob, n)
    ops = mtd.block_operands(length, stream, blocks, w_counts, bits, n)
    words, index, states, fc = mtd.device_operands(stream, *ops, n, dev)
    kw = {"bits": bits, "n": n, "length": length}
    ann = mtd.annotate_cuda(words, index, fc, bits=bits)
    torch.cuda.synchronize()
    err_ann = max_abs_err(ann, mtd.annotate_plain(words, index, fc, bits=bits))
    got = mtd.decode_blocks_annotated_cuda(ann, index, states, fc, **kw)
    torch.cuda.synchronize()
    err_dec = max_abs_err(got, mtd.decode_blocks_annotated_plain(ann, index, states, fc, **kw))
    err_rank = max_abs_err(got, mtd.decode_blocks_cuda(words, index, states, fc, **kw))
    if err_ann or err_dec or err_rank:
        raise AssertionError(f"mt annotated {name}: a kernel differs (annotate {err_ann}, decode {err_dec}, "
                             f"against the rank kernel {err_rank})")
    outs = tuple(torch.empty_like(t) for t in got)
    fns = {
        "rank": lambda: mtd.decode_blocks_cuda(words, index, states, fc, **kw),
        "mt_annotate": lambda: mtd.annotate_cuda(words, index, fc, bits=bits),
        "mt_decode_annotated": lambda: mtd.decode_blocks_annotated_cuda(ann, index, states, fc, **kw),
    }
    launches = {
        "rank": lambda: mtd.launch_decode(words, index, states, fc, *outs, bits=bits, n=n),
        "mt_annotate": fns["mt_annotate"],
        "mt_decode_annotated": lambda: mtd.launch_decode_annotated(ann, index, states, fc, *outs, bits=bits, n=n),
    }
    turns: dict[str, list[float]] = {k: [] for k in fns}
    launch_turns: dict[str, list[float]] = {k: [] for k in fns}
    for k in [*fns, *reversed(fns)]:
        turns[k].append(cuda_ms(fns[k], 20, queue_ahead=True))
        launch_turns[k].append(cuda_ms(launches[k], 20, queue_ahead=True))
    ms = {k: statistics.mean(v) for k, v in turns.items()}
    lms = {k: statistics.mean(v) for k, v in launch_turns.items()}
    max_groups = int(ops[0][:, 4].max())
    nwords = ann.numel()
    coded_words = int((torch.clamp(index[:, 1], max=nwords) - torch.clamp(index[:, 0], 0, nwords)).clamp(min=0).sum())
    plains = {
        "mt_annotate": lambda: mtd.annotate_plain(words, index, fc, bits=bits),
        "mt_decode_annotated": lambda: mtd.decode_blocks_annotated_plain(ann, index, states, fc, **kw),
    }
    bounds = {
        # the coded blocks' words read once, every word's annotation written once
        "mt_annotate": bound(2 * coded_words + 4 * nwords + nbytes(index, fc), ANNOTATE_OPS_PER_WORD * coded_words),
        "mt_decode_annotated": bound(nbytes(ann, index, states, fc, *got), OPS_PER_SYMBOL["decode"] * length),
    }
    res = {"case": name, "bits": bits, "n": n, "blocks": int(ops[0].shape[0]), "max_groups": max_groups,
           "coded_words": coded_words}
    errs = {"mt_annotate": err_ann, "mt_decode_annotated": err_dec}
    for k in plains:
        res[k] = {"max_abs_err": errs[k], "ms": ms[k], "launch_ms": lms[k], "ms_host_paced": cuda_ms(fns[k], 20),
                  "plain_ms": cuda_ms(plains[k], 1), **bounds[k]}
    res["mt_decode_annotated"]["link_us"] = lms["mt_decode_annotated"] * 1e3 / max(max_groups, 1)
    both, both_launch = ms["mt_annotate"] + ms["mt_decode_annotated"], lms["mt_annotate"] + lms["mt_decode_annotated"]
    res["ab"] = {"rank_ms": ms["rank"], "rank_ms_turns": turns["rank"], "annotate_ms": ms["mt_annotate"],
                 "annotated_decode_ms": ms["mt_decode_annotated"], "annotated_route_ms": both,
                 "annotated_route_over_rank": both / ms["rank"],
                 "annotated_decode_over_rank": ms["mt_decode_annotated"] / ms["rank"],
                 "launch": {"rank_ms": lms["rank"], "annotate_ms": lms["mt_annotate"],
                            "annotated_decode_ms": lms["mt_decode_annotated"], "turns": launch_turns,
                            "annotated_route_over_rank": both_launch / lms["rank"],
                            "annotated_decode_over_rank": lms["mt_decode_annotated"] / lms["rank"]}}
    emit("mt_annotated_kernels", **res)
    return res


def mt_annotated_phases(dev: torch.device, ctx: dict) -> tuple[list[dict], dict]:
    """mt decode through the annotated-stream route (the module flag
    `_PAIR_V2`, restored at the end): its kernels against their plain
    versions and timed against the rank kernel at B=10..15, n=32 and 64, and
    at the main path's 64 MiB blob; the main path; round trips; malformed
    blobs; both routes end to end.  Returns the kernel rows (the main
    path's first) and the main path's launches."""
    from hsrans_tpu_torch import mt_decode_torch, mt_encode_torch
    from hsrans_tpu_torch.kernels import mt_decode as mtd
    from hsrans_tpu_torch.parallel.sharded import device_plan, mt_encode_device
    from hsrans_tpu_torch.runtime import build

    xray, plans = ctx["xray"], ctx["plans"]
    data, _ = ctx["main"]
    main_blob = ctx["main_blob"]
    # one 8 MiB x-ray blob per depth and width: those the mt decode phases
    # made, the rest encoded on the card (B=11 takes B=10's 16 KiB cap:
    # bench.py has no B=11 row)
    blobs = {(bits, n): (name, blob) for name, src, bits, n, blob in ctx["classes"] + ctx["trips"]
             if src is xray and "device_plan" in name}
    for bits in range(10, 16):
        for n in (32, 64):
            if (bits, n) not in blobs:
                cap = MT_CAPS.get(bits, 16 << 10)
                plan = plans.get((bits, n)) or device_plan(xray, bits, n, cap)
                blob = (mt_encode_torch(xray, bits, plan=plan, device="cuda") if n == 64
                        else mt_encode_device(xray, bits, n, plan=plan, device="cuda"))
                blobs[(bits, n)] = (f"x-ray n={n} B={bits} device_plan {cap >> 10} KiB", blob)
    cases = [("x-ray 64 MiB main path", main_blob, 12, 64)]
    cases += [(name, blob, bits, n) for (bits, n), (name, blob) in sorted(blobs.items())]
    cases += [(name, blob, bits, n) for name, _, bits, n, blob in ctx["classes"] if "uniform" in name]

    old = mtd._PAIR_V2
    try:
        # 1 and 5. the kernels against their plain versions, and the A/B of
        #    the two routes' kernels on the same operands
        rows = [mt_annotated_kernels(name, blob, bits, n, dev) for name, blob, bits, n in cases]

        # 2. the main path: 64 MiB x-ray, B=12, n=64, device_plan 24 KiB
        mtd._PAIR_V2 = True
        build.reset_launches()
        back = mt_decode_torch(main_blob, 12, 64, device="cuda")
        torch.cuda.synchronize()
        launches = {k: build.LAUNCHES[k] for k in ("mt_annotate", "mt_decode_annotated", "mt_decode")}
        if back != data.tobytes():
            raise AssertionError("mt annotated 64 MiB: mt_decode_torch does not return the input")
        if launches != {"mt_annotate": 1, "mt_decode_annotated": 1, "mt_decode": 0}:
            raise AssertionError(f"mt annotated 64 MiB: launches {launches}, one of each annotated kernel expected")
        emit("mt_annotated_main_path", bytes=data.size, launches=launches)

        # 3. round trips, each held against the input and the CPU tier
        for name, src, bits, n, b in ctx["trips"]:
            got = mt_decode_torch(b, bits, n, device="cuda")
            if got != src.tobytes():
                raise AssertionError(f"mt annotated {name}: decode on the card does not return the input")
            t0 = time.perf_counter()
            if mt_decode_torch(b, bits, n, device="cpu") != got:
                raise AssertionError(f"mt annotated {name}: the card's output differs from the CPU tier's")
            emit("mt_annotated_round_trip", case=name, bits=bits, n=n, bytes=src.size,
                 cpu_tier_decode_s=time.perf_counter() - t0)

        # 4. malformed blobs: the rank route's outcome, and no CUDA fault
        small_data, small, bad = ctx["malformed"]
        outcomes = {"none": 0, "bytes": 0}
        for b in bad:
            out = mt_decode_torch(b, 12, 64, device="cuda")
            mtd._PAIR_V2 = False
            if out != mt_decode_torch(b, 12, 64, device="cuda"):
                raise AssertionError("mt annotated: a malformed blob decodes otherwise than on the rank route")
            mtd._PAIR_V2 = True
            outcomes["none" if out is None else "bytes"] += 1
        torch.cuda.synchronize()
        if mt_decode_torch(small, 12, 64, device="cuda") != small_data.tobytes():
            raise AssertionError("mt annotated: decode after the malformed blobs failed")
        emit("mt_annotated_malformed", blobs=len(bad), **outcomes)

        # 5. end to end, host bytes to host bytes, both routes in turns,
        #    median of 3; one pass of each split by layer at 64 MiB
        e2e = []
        for name, blob, bits, n in cases:
            secs: dict[bool, list[float]] = {False: [], True: []}
            for _ in range(3):
                for flag in (False, True):
                    mtd._PAIR_V2 = flag
                    secs[flag] += host_s(lambda: mt_decode_torch(blob, bits, n, device="cuda"), 1)
            e2e.append({"case": name, "rank_s": secs[False], "annotated_s": secs[True],
                        "annotated_over_rank": statistics.median(secs[True]) / statistics.median(secs[False])})
        layers: dict[bool, dict[str, float]] = {False: {}, True: {}}
        for flag in (False, True):
            mtd._PAIR_V2 = flag
            if mt_decode_torch(main_blob, 12, 64, device="cuda", layers=layers[flag]) != data.tobytes():
                raise AssertionError("mt annotated 64 MiB: the layer-timed decode does not return the input")
        emit("mt_annotated_ab", kernels=[{"case": r["case"], "bits": r["bits"], "n": r["n"], **r["ab"]} for r in rows],
             end_to_end=e2e, layers_rank=layers[False], layers_annotated=layers[True])
    finally:
        mtd._PAIR_V2 = old
    return rows, launches


def mt_encode_kernel_vs_plain(name: str, data: np.ndarray, plan, bits: int, n: int, rule: str, dev: torch.device) -> dict:
    """The mt encode and placement kernels against their plain versions on
    the same CUDA tensors of one plan, as `encode_plan` drives them; times
    both."""
    from hsrans_tpu_torch.kernels import mt_encode as mte

    kinds, ks, index, freqs, bias = mte.plan_operands(data, plan, bits, n, rule)
    data_t = torch.from_numpy(data).to(dev)
    index_t, freqs_t = torch.from_numpy(index).to(dev), torch.from_numpy(freqs.view(np.int16)).to(dev)
    kw = {"bits": bits, "n": n, "rule": rule, "words_cap": int(index[-1, 4])}
    got = mte.encode_blocks_cuda(data_t, index_t, freqs_t, **kw)
    torch.cuda.synchronize()
    want = mte.encode_blocks_plain(data_t, index_t, freqs_t, **kw)
    # the kernel leaves a region's slots below its words unwritten: compare the words the contract defines
    err = max_abs_err((got[1], got[2], mte.emitted_words(got[0], index_t, got[1])),
                      (want[1], want[2], mte.emitted_words(want[0], index_t, want[1])))
    if err:
        raise AssertionError(f"mt encode {name}: kernel differs from its plain version (max abs err {err})")
    words_t, count_t, fin_t = got
    count = count_t.cpu().numpy()
    pargs, pkw = place_operands(plan, kinds, ks, bias, words_t, index_t, count_t, fin_t, freqs_t, n, data.size)
    place = place_check(f"mt place {name}", pargs, pkw)
    coded_bytes = int(np.maximum(index[:, 2] - index[:, 0], 0).sum())
    words = 2 * int(count.sum())
    enc_moved = coded_bytes + nbytes(index_t, freqs_t, count_t, fin_t) + words
    outs = tuple(torch.empty_like(t) for t in got)  # the launch alone: outputs allocated once
    max_groups = int(index[:, 1].max())
    res = {
        "case": name, "bits": bits, "n": n, "rule": rule, "blocks": len(ks), "max_groups": max_groups,
        "coded_bytes": coded_bytes,
        "mt_encode": {
            "max_abs_err": err,
            "ms": cuda_ms(lambda: mte.encode_blocks_cuda(data_t, index_t, freqs_t, **kw), 20, queue_ahead=True),
            **launch_times(lambda: mte.launch_encode(data_t, index_t, freqs_t, *outs, bits=bits, n=n, rule=rule),
                           max_groups),
            "ms_host_paced": cuda_ms(lambda: mte.encode_blocks_cuda(data_t, index_t, freqs_t, **kw), 20),
            "plain_ms": cuda_ms(lambda: mte.encode_blocks_plain(data_t, index_t, freqs_t, **kw), 1),
            **bound(enc_moved, OPS_PER_SYMBOL["encode"] * coded_bytes),
        },
        "mt_place": place,
    }
    emit("mt_encode_kernels_vs_plain", **res)
    return res


def mt_planner_blocks(dev: torch.device) -> dict:
    """The reference planner's largest block on a homogeneous input: 64 MiB
    of independent bytes of one Zipf distribution (seed 8), which
    `plan_blocks_py(..., "mt", 64)` cuts into blocks up to its 2^25-byte cap.  The encode
    kernel's launch alone on that plan (one chain of 512 Ki groups for the
    largest block), the placement against its plain version and timed, and
    `mt_encode_torch` end to end, its blob decoded on the card back to the
    input.  The encode's plain version would walk those groups one at a
    time, so the decode holds the encode here."""
    from hsrans_tpu_torch import mt_decode_torch, mt_encode_torch
    from hsrans_tpu_torch.kernels import mt_encode as mte

    data, plan, plan_s = zipf_input()
    kinds, ks, index, freqs, bias = mte.plan_operands(data, plan, 12, 64, "groups")
    data_t = torch.from_numpy(data).to(dev)
    index_t, freqs_t = torch.from_numpy(index).to(dev), torch.from_numpy(freqs.view(np.int16)).to(dev)
    kw = {"bits": 12, "n": 64, "rule": "groups", "words_cap": int(index[-1, 4])}
    outs = mte.encode_blocks_cuda(data_t, index_t, freqs_t, **kw)
    max_groups = int(index[:, 1].max())
    encode = launch_times(lambda: mte.launch_encode(data_t, index_t, freqs_t, *outs, bits=12, n=64, rule="groups"),
                          max_groups)
    pargs, pkw = place_operands(plan, kinds, ks, bias, *outs[:1], index_t, *outs[1:], freqs_t, 64, data.size)
    place = place_check("mt place, the reference planner's blocks", pargs, pkw)
    blob = mt_encode_torch(data, 12, plan=plan, device="cuda")
    if mt_decode_torch(blob, 12, 64, device="cuda") != data.tobytes():
        raise AssertionError("mt encode, the reference planner's blocks: decode on the card does not return the input")
    enc_s = host_s(lambda: mt_encode_torch(data, 12, plan=plan, device="cuda"), 3)
    res = {"bytes": data.size, "blocks": len(plan), "block_sizes": [r.size for r in plan], "max_groups": max_groups,
           "plan_s": plan_s, "ratio": len(blob) / data.size, "mt_encode": encode, "mt_place": place,
           "encode_s": enc_s, "encode_MiBps": data.size / MIB / statistics.median(enc_s)}
    emit("mt_encode_planner_blocks", **res)
    return res


@functools.cache
def zipf_input() -> tuple[np.ndarray, list, float]:
    """64 MiB of independent bytes of one Zipf distribution (seed 8), the
    reference planner's plan of it (n=64, B=12) and the seconds it took."""
    from hsrans_tpu_torch.ops.planner import plan_blocks_py

    zipf = 1.0 / np.arange(1, 257)
    data = np.random.default_rng(8).choice(256, size=64 * MIB, p=zipf / zipf.sum()).astype(np.uint8)
    t0 = time.perf_counter()
    plan = plan_blocks_py(data, 12, "mt", 64)
    return data, plan, time.perf_counter() - t0


def place_operands(plan, kinds, ks, bias, words_t, index_t, count_t, fin_t, freqs_t, n: int, length: int):
    """The placement kernel's operands and keywords for the encode's outputs
    on `plan`, as `encode_plan` lays the blob out."""
    from hsrans_tpu_torch.kernels import mt_encode as mte

    place, out_u16 = mte.part_layout(plan, kinds, ks, bias, count_t.cpu().numpy(), n, length)
    place_t = torch.from_numpy(place).to(words_t.device)
    return (words_t, index_t, count_t, fin_t, freqs_t, place_t), {"n": n, "out_u16": out_u16}


def place_check(name: str, pargs: tuple, pkw: dict, timed: bool = True) -> dict:
    """The placement kernel against its plain version, through its wrapper
    and by its launch alone into a 0xAA-filled blob (every byte written);
    with `timed`, the times of both and the launch alone, and the bound:
    the words (2 bytes each), the operands and the blob."""
    from hsrans_tpu_torch.kernels import mt_encode as mte

    words_t, index_t, count_t, fin_t, freqs_t, place_t = pargs
    n = pkw["n"]
    got = mte.place_blocks_cuda(*pargs, **pkw)
    torch.cuda.synchronize()
    want = mte.place_blocks_plain(*pargs, **pkw)
    err = max_abs_err(got, want)
    if err:
        raise AssertionError(f"{name}: kernel differs from its plain version (max abs err {err})")
    out = torch.empty(pkw["out_u16"], dtype=torch.int16, device=words_t.device)
    launch = lambda: mte.launch_place(*pargs, out, n=n)  # noqa: E731
    res = {"max_abs_err": err, "every_byte_written": prefilled_equal(launch, out, want, 0)}
    if timed:
        words = 2 * int(count_t.sum())
        res |= {
            "ms": cuda_ms(lambda: mte.place_blocks_cuda(*pargs, **pkw), 20, queue_ahead=True),
            "launch_ms": cuda_ms(launch, 20, queue_ahead=True),
            "ms_host_paced": cuda_ms(lambda: mte.place_blocks_cuda(*pargs, **pkw), 20),
            "plain_ms": cuda_ms(lambda: mte.place_blocks_plain(*pargs, **pkw), 1),
            "parts": int(place_t.shape[0]),
            **bound(words + nbytes(index_t, count_t, fin_t, freqs_t, place_t, got), 0),
        }
    return res


def mt_encode_phases(repo: Path, dev: torch.device, ctx: dict) -> tuple[list[dict], dict]:
    """mt encode on the card: the kernels against their plain versions, the
    main path (encode on the card, decode on the card), round trips and
    times.  Returns the kernel rows (the main path (a)'s first) and the
    launches of one round trip of each main path, {"a": ..., "b": ...}."""
    from hsrans_tpu_torch import mt_decode_torch, mt_encode_torch
    from hsrans_tpu_torch.kernels.mt_encode import uniform_rows
    from hsrans_tpu_torch.ops.planner import BlockPlan
    from hsrans_tpu_torch.ops.tpx import make_tile_hist
    from hsrans_tpu_torch.parallel.sharded import mt_encode_device
    from hsrans_tpu_torch.runtime import build
    from tools.gen_inputs import text_like

    xray, plans = ctx["xray"], ctx["plans"]
    xray64, plan64 = ctx["main"]
    text64 = text_like(np.random.default_rng(8), 64 * MIB)

    # 1. the kernels against their plain versions: the main path (a)'s own
    #    launch, 8 MiB x-ray classes, uniform 4 KiB blocks and (b)'s launch;
    #    then the reference planner's largest block
    rows = [mt_encode_kernel_vs_plain("x-ray 64 MiB main path (a)", xray64, plan64, 12, 64, "groups", dev)]
    for bits, n in ((12, 64), (15, 64), (12, 32)):
        rule = "groups" if n == 64 else "section"  # n=32 runs through mt_encode_device
        rows.append(mt_encode_kernel_vs_plain(f"x-ray n={n} B={bits} device_plan {MT_CAPS[bits] >> 10} KiB",
                                              xray, plans[(bits, n)], bits, n, rule, dev))
    rows.append(mt_encode_kernel_vs_plain("x-ray n=64 B=12 uniform 4 KiB", xray, uniform_rows(xray.size, 4096), 12, 64,
                                          "groups", dev))
    rows.append(mt_encode_kernel_vs_plain("text 64 MiB main path (b)", text64, uniform_rows(text64.size, 4096), 12, 64,
                                          "groups", dev))
    mt_planner_blocks(dev)

    # 2. the main path: (a) 64 MiB x-ray, device_plan 24 KiB, and (b) 64 MiB
    #    enwik8-like text in uniform 4 KiB blocks (mt64_encode_tpu's
    #    default); each encoded on the card, held against the CPU tier, and
    #    decoded on the card
    launches = {}
    for case, data, plan in (("a", xray64, plan64), ("b", text64, None)):
        build.reset_launches()
        blob = mt_encode_torch(data, 12, plan=plan, device="cuda")
        back = mt_decode_torch(blob, 12, 64, device="cuda")
        torch.cuda.synchronize()
        got = {k: build.LAUNCHES[k] for k in ("mt_encode", "mt_place", "mt_decode", "hist_count", "hist_normalize")}
        # (a)'s plan carries its freqs; (b)'s rows have none, so the card takes their histograms
        hist = int(case == "b")
        if got != {"mt_encode": 1, "mt_place": 1, "mt_decode": 1, "hist_count": hist, "hist_normalize": hist}:
            raise AssertionError(f"mt encode ({case}): launches {got}: one of each mt kernel and {hist} of each "
                                 "histogram kernel expected")
        if back != data.tobytes():
            raise AssertionError(f"mt encode ({case}): decode on the card does not return the input")
        t0 = time.perf_counter()
        if mt_encode_torch(data, 12, plan=plan, device="cpu") != blob:
            raise AssertionError(f"mt encode ({case}): the card's blob differs from the CPU tier's")
        cpu_s = time.perf_counter() - t0
        rows_ = plan if plan is not None else uniform_rows(data.size, 4096)
        emit("mt_encode_main_path", case=case, bytes=data.size, ratio=len(blob) / data.size, blocks=len(rows_),
             coded_blocks=sum(not r.is_single for r in rows_), launches=got, cpu_tier_encode_s=cpu_s)
        launches[case] = got

    # 3. round trips, each held against the CPU tier and decoded on the card
    odd, runs = ctx["odd"], ctx["runs"]
    cuts = [0, 10_003, 25_000, 33_333, 100_000, 104_097, 1 << 18]  # every block of x-ray holds the byte 0
    odd_rows = [(cuts[i], cuts[i + 1] - cuts[i]) for i in range(len(cuts) - 1)]

    def torch_enc(plan=None, bits=12):
        return lambda d, device: mt_encode_torch(d, bits, plan=plan, device=device)

    def device_enc(n, plan=None, bits=12):
        return lambda d, device: mt_encode_device(d, bits, n, plan=plan, device=device)

    xr2 = xray[1 << 19 : (1 << 19) + (1 << 18)]  # past x-ray's leading 512 KiB run of zeros
    odd_plan = [BlockPlan(s, z, False, 0, make_tile_hist(xr2[s : s + z], 12).symbol_count) for s, z in odd_rows]
    trips = [(f"x-ray n=64 B={b} device_plan {MT_CAPS[b] >> 10} KiB", xray, b, 64, torch_enc(plans[(b, 64)], b))
             for b in (10, 13, 14, 15)]
    trips += [
        ("x-ray n=32 B=12 device_plan 24 KiB (mt_encode_device)", xray, 12, 32, device_enc(32, plans[(12, 32)])),
        ("x-ray n=32 B=12 uniform 64 KiB (mt_encode_device)", xray, 12, 32,
         lambda d, device: mt_encode_device(d, 12, 32, uniform_block=64 << 10, device=device)),
        ("corpus.bin reference planner", ctx["corpus"], 12, 64, torch_enc(plans["corpus"])),
        ("uniform 4 KiB odd tail", odd, 12, 64, torch_enc()),
        ("single-symbol runs between coded blocks", runs, 12, 64, torch_enc(plans["runs"])),
        ("block sizes off the 64-byte grid", xr2, 12, 64, torch_enc(odd_plan)),
        ("block sizes off the 64-byte grid (mt_encode_device)", xr2, 12, 64, device_enc(64, odd_plan)),
        # every other row without its freqs: the card's histograms fill those rows in among the given ones
        ("plan rows with and without freqs", xr2, 12, 64,
         torch_enc([r if i % 2 else BlockPlan(r.start, r.size, False, 0, None) for i, r in enumerate(odd_plan)])),
    ]
    for name, src, bits, n, encode in trips:
        t0 = time.perf_counter()
        blob = encode(src, "cuda")
        card_s = time.perf_counter() - t0
        if mt_decode_torch(blob, bits, n, device="cuda") != src.tobytes():
            raise AssertionError(f"mt encode {name}: decode on the card does not return the input")
        t0 = time.perf_counter()
        if encode(src, "cpu") != blob:
            raise AssertionError(f"mt encode {name}: the card's blob differs from the CPU tier's")
        emit("mt_encode_round_trip", case=name, bits=bits, n=n, bytes=src.size, ratio=len(blob) / src.size,
             encode_s=card_s, cpu_tier_encode_s=time.perf_counter() - t0)

    # 4. times: (a) and (b) end to end, host bytes to host bytes, median of
    #    3, then one pass split by layer; the reference planner's plan
    times = {}
    for case, data, plan in (("a", xray64, plan64), ("b", text64, None)):
        enc_s = host_s(lambda: mt_encode_torch(data, 12, plan=plan, device="cuda"), 3)
        layers: dict[str, float] = {}
        mt_encode_torch(data, 12, plan=plan, device="cuda", layers=layers)
        times[case] = {"encode_MiBps": data.size / MIB / statistics.median(enc_s), "encode_s": enc_s, "layers": layers}
    planner_s = host_s(lambda: mt_encode_torch(ctx["corpus"], 12, plan=plans["corpus"], device="cuda"), 3)
    emit("mt_encode_times", bytes=xray64.size, **times,
         planner_plan={"bytes": ctx["corpus"].size, "encode_s": planner_s,
                       "encode_MiBps": ctx["corpus"].size / MIB / statistics.median(planner_s)})
    return rows, launches


# the cases that hold the mt kernels' shared-memory windows at their edges
# (tests/test_torch_cuda_kernels.py runs them too); the decode's at B=10, 12
# and 15, n=32 and 64, the encode's at B=12, n=32 and 64, under both rules
DECODE_EDGES = ("word_start residues", "blocks shorter than a half", "word regions cut mid-group", "one 1 MiB block")
ENCODE_EDGES = ("in_start residues", "block sizes off the 64-byte grid", "one 1 MiB block")
# the 1 MiB block at two of the six (B, n): the flat table at n=64 and the
# rank table at n=32, each read through many window refills.  Its plain
# versions (rank and annotated routes, host-paced) were most of this
# phase's 254 s in PR 12's run, which the CLI's phase would have pushed past
# half the script's time limit (PERF.md, PR 13)
DECODE_EDGE_DEPTHS = {"one 1 MiB block": [(12, 64), (15, 32)]}


# the cases that hold the tpx decode kernel's ragged reads and window at its
# edges (tests/test_torch_cuda_kernels.py runs them too), at B=10, 12 and 15
TPX_DECODE_EDGES = ("slot regions at every even byte phase", "sc == w_slots overreads", "rows shorter than a half",
                    "one mega of one tile", "the v1 wire")


def tpx_rewrite(blob: bytes, w_of, magic: bytes | None = None) -> bytes:
    """A tpx v2 blob written anew by the port's mega writer with each mega's
    w_slots set to w_of(mega): a row with more slots keeps its first
    w_slots, and its count drops to 2 * w_slots, so its decode reads past
    its last slot.  With `magic` (the v1 one) the rows go to the wire
    rectangular, w_slots apart."""
    from hsrans_tpu_torch.ops.tpx import TpxParams, _write_mega, tpx_header, tpx_parse

    p, length, megas = tpx_parse(blob)
    out = tpx_header(length, p)
    buf = np.frombuffer(blob, np.uint8)
    for m in megas:
        w = w_of(m)
        start, sc = m.row_start[:-1], np.diff(m.row_start)
        keep = np.minimum(sc, w)
        slots = buf[m.slot_off : m.slot_off + 4 * int(m.row_start[-1])].copy().view("<u4")
        rect = np.zeros((sc.size, w), np.uint32)
        col = np.arange(int(keep.sum())) - np.repeat(np.cumsum(keep) - keep, keep)
        rect[np.repeat(np.arange(sc.size), keep), col] = slots[np.repeat(start, keep) + col]
        counts = np.minimum(m.counts.astype(np.int64), 2 * w).astype(np.uint16)
        if magic is None:
            _write_mega(out, m.n_tiles, w, m.states, m.freqs, counts, rect.reshape(m.n_tiles, m.rows, w))
        else:
            out += int(m.n_tiles).to_bytes(4, "little") + int(w).to_bytes(4, "little") + m.states.astype("<u4").tobytes()
            for t in range(m.n_tiles):
                out += m.freqs[t].astype("<u2").tobytes() + counts[t].astype("<u2").tobytes()
            out += rect.astype("<u4").tobytes()
    if magic is not None:
        out[:8] = magic
    out[16:24] = len(out).to_bytes(8, "little")
    return bytes(out)


def tpx_decode_edge_operands(case: str, bits: int, dev: torch.device) -> list[tuple[str, tuple, dict]]:
    """(name, decode kernel operands, keywords) of one TPX_DECODE_EDGES case
    on enwik8-like text encoded by the CPU tier.  Phases: three megas of 40
    rows (the last partial), the blob placed 0, 2, ..., 14 bytes into the
    buffer, so that with the rows' 4-byte starts every slot region meets
    every even 16-byte phase.  Overreads: the same blob with w_slots cut to
    the median row's slots (at least 1; tpx_rewrite).  Short rows: 37 rows of 4 steps,
    a few hundred bytes of slots a row against a 2 KiB window half.  One mega of one tile: 13 rows of 32 steps, partial.  The
    v1 wire: the three megas written rectangular."""
    from hsrans_tpu_torch import tpx_encode_torch
    from hsrans_tpu_torch.ops.tpx import MAGIC, TpxParams
    from tools.gen_inputs import text_like

    rng = np.random.default_rng(bits)
    if case == "rows shorter than a half":
        p = TpxParams(bits=bits, rows=37, steps=4, tiles=3)
        data = text_like(rng, 2 * p.mega_bytes - 999)
    elif case == "one mega of one tile":
        p = TpxParams(bits=bits, rows=13, steps=32, tiles=1)
        data = text_like(rng, p.mega_bytes - 1001)
    else:
        p = TpxParams(bits=bits, rows=40, steps=8, tiles=2)
        data = text_like(rng, 2 * p.mega_bytes + 3333)
    blob = tpx_encode_torch(data, p=p, device="cpu")
    if case == "slot regions at every even byte phase":
        return [(f"shift {2 * r}", *tpx_decode_args(blob, dev, 2 * r)) for r in range(8)]
    if case == "sc == w_slots overreads":
        blob = tpx_rewrite(blob, lambda m: max(1, int(np.median(np.diff(m.row_start)))))
    elif case == "the v1 wire":
        blob = tpx_rewrite(blob, lambda m: m.w_slots, MAGIC)
    return [(case, *tpx_decode_args(blob, dev))]


def tpx_window_edges(dev: torch.device) -> list[dict]:
    """The tpx decode kernel against its plain version on the
    TPX_DECODE_EDGES cases, exact."""
    from hsrans_tpu_torch.kernels import tpx_decode as dec

    rows = []
    for case in TPX_DECODE_EDGES:
        for bits in (10, 12, 15):
            for name, args, kw in tpx_decode_edge_operands(case, bits, dev):
                got = dec.decode_mega_cuda(*args, **kw)
                torch.cuda.synchronize()
                err = max_abs_err(got, dec.decode_mega_plain(*args, **kw))
                if err:
                    raise AssertionError(f"tpx decode {case}, {name}, B={bits}: kernel differs (max abs err {err})")
                rows.append({"case": case, "sub": name, "bits": bits, "megas": len(args[1]), "max_abs_err": err})
    emit("tpx_window_edges", cases=len(rows), max_abs_err=max(r["max_abs_err"] for r in rows))
    return rows


def decode_edge_operands(case: str, bits: int, n: int, dev: torch.device) -> list[tuple[str, tuple, dict]]:
    """(name, decode kernel operands, keywords) of one DECODE_EDGES case:
    uniform blocks of 4 KiB (512 bytes for blocks shorter than one window
    half, 1 MiB for the one large block: ~16 Ki groups at n=64) of
    enwik8-like text with an odd tail.  Residues: the word region shifted
    by 0..7 words, so that each block's first word meets every 16-byte
    phase.  Cut: each block's word region ends in the middle of its words,
    and the whole region is cut to half."""
    from hsrans_tpu_torch.kernels import mt_decode as mtd
    from hsrans_tpu_torch.ops.mt import mt_encode_py
    from hsrans_tpu_torch.parallel.sharded import uniform_plan
    from tools.gen_inputs import text_like

    block = {"blocks shorter than a half": 512, "one 1 MiB block": 1 << 20}.get(case, 4096)
    data = text_like(np.random.default_rng(64 * bits + n), (1 << 20) + 4099 if block == 1 << 20 else 6 * block - 37)
    blob = mt_encode_py(data, bits, n, uniform_plan(data, bits, n, block))
    length, stream, blocks, w_counts = mtd.index_blocks(blob, n)
    words, index, states, fc = mtd.device_operands(stream, *mtd.block_operands(length, stream, blocks, w_counts, bits, n),
                                                   n, dev)
    kw = {"bits": bits, "n": n, "length": length}
    if case == "word_start residues":
        shifted = []
        for r in range(8):
            ix = index.clone()
            ix[:, :2] += r
            shifted.append((f"shift {r}", (torch.cat([torch.zeros(2 * r, dtype=torch.uint8, device=dev), words]), ix,
                                           states, fc), kw))
        return shifted
    if case == "word regions cut mid-group":
        ix = index.clone()
        ix[:, 1] = ix[:, 0] + (ix[:, 1] - ix[:, 0]) // 2 + 3
        return [("block ends", (words, ix, states, fc), kw),
                ("region cut to half", (words[: words.numel() // 4 * 2], index, states, fc), kw)]
    return [(case, (words, index, states, fc), kw)]


def encode_edge_operands(case: str, n: int, rule: str, dev: torch.device) -> list[tuple[str, tuple, dict]]:
    """(name, encode kernel operands, keywords) of one ENCODE_EDGES case at
    B=12 on enwik8-like text with the byte 0 in every block (so that the
    "groups" rule's lanes past a block's end decode).  Residues: the input
    shifted by 0..15 bytes under rows off the 64-byte grid, so that each
    block's first byte meets every 16-byte phase."""
    from hsrans_tpu_torch.kernels import mt_encode as mte
    from hsrans_tpu_torch.ops.planner import BlockPlan
    from tools.gen_inputs import text_like

    if case == "one 1 MiB block":
        cuts = [0, 1 << 20, (1 << 20) + 3001]
    else:
        cuts = [0, 1000, 5003, 9000, 20001, 33333, 40961]
    data = text_like(np.random.default_rng(n + len(rule)), cuts[-1])
    data[::31] = 0
    out = []
    for r in range(16) if case == "in_start residues" else (0,):
        shifted = np.concatenate([np.zeros(r, np.uint8), data])
        plan = [BlockPlan(r + cuts[i], cuts[i + 1] - cuts[i], False, 0, None) for i in range(len(cuts) - 1)]
        _, _, index, freqs, _ = mte.plan_operands(shifted, plan, 12, n, rule)
        ops = tuple(torch.from_numpy(a).to(dev) for a in (shifted, index, freqs.view(np.int16)))
        out.append((f"shift {r}", ops, {"bits": 12, "n": n, "rule": rule, "words_cap": int(index[-1, 4])}))
    return out


def mt_window_edges(dev: torch.device) -> dict[str, list[dict]]:
    """The mt decode and encode kernels, and the annotated route's two
    kernels, against their plain versions on the DECODE_EDGES and
    ENCODE_EDGES cases, exact (decode: bytes, final states, cursors;
    annotate: every word; encode: counts, final states, emitted words)."""
    from hsrans_tpu_torch.kernels import mt_decode as mtd
    from hsrans_tpu_torch.kernels import mt_encode as mte

    rows: dict[str, list[dict]] = {"mt_decode": [], "mt_decode_annotated": [], "mt_encode": []}
    for case in DECODE_EDGES:
        for bits, n in DECODE_EDGE_DEPTHS.get(case, [(b, n) for b in (10, 12, 15) for n in (32, 64)]):
            for name, args, kw in decode_edge_operands(case, bits, n, dev):
                got = mtd.decode_blocks_cuda(*args, **kw)
                torch.cuda.synchronize()
                err = max_abs_err(got, mtd.decode_blocks_plain(*args, **kw))
                if err:
                    raise AssertionError(f"mt decode {case}, {name}, B={bits} n={n}: kernel differs (max abs err {err})")
                rows["mt_decode"].append({"case": case, "sub": name, "bits": bits, "n": n, "max_abs_err": err})
                words, index, states, fc = args
                ann = mtd.annotate_cuda(words, index, fc, bits=bits)
                got = mtd.decode_blocks_annotated_cuda(ann, index, states, fc, **kw)
                torch.cuda.synchronize()
                err = max(max_abs_err(ann, mtd.annotate_plain(words, index, fc, bits=bits)),
                          max_abs_err(got, mtd.decode_blocks_annotated_plain(ann, index, states, fc, **kw)))
                if err:
                    raise AssertionError(f"mt annotated {case}, {name}, B={bits} n={n}: a kernel differs "
                                         f"(max abs err {err})")
                rows["mt_decode_annotated"].append({"case": case, "sub": name, "bits": bits, "n": n,
                                                    "max_abs_err": err})
    for case in ENCODE_EDGES:
        for n in (32, 64):
            for rule in ("groups", "section"):
                for name, (data, index, freqs), kw in encode_edge_operands(case, n, rule, dev):
                    got = mte.encode_blocks_cuda(data, index, freqs, **kw)
                    torch.cuda.synchronize()
                    want = mte.encode_blocks_plain(data, index, freqs, **kw)
                    err = max_abs_err((got[1], got[2], mte.emitted_words(got[0], index, got[1])),
                                      (want[1], want[2], mte.emitted_words(want[0], index, want[1])))
                    if err:
                        raise AssertionError(f"mt encode {case}, {name}, n={n} {rule}: kernel differs (max abs err {err})")
                    rows["mt_encode"].append({"case": case, "sub": name, "n": n, "rule": rule, "max_abs_err": err})
    emit("mt_window_edges", decode_cases=len(rows["mt_decode"]), annotated_cases=len(rows["mt_decode_annotated"]),
         encode_cases=len(rows["mt_encode"]), max_abs_err=max(r["max_abs_err"] for v in rows.values() for r in v))
    return rows


# the cases that hold the two wire writers at their edges
# (tests/test_torch_cuda_kernels.py runs them too): the tpx wire writer on
# random windows and counts, the mt placement at n=32 and 64
TPX_WIRE_EDGES = ("sections at every even 16-byte phase", "rows with no words and rows of every word",
                  "one mega of one tile")
MT_PLACE_EDGES = ("parts at every u16 phase", "one 1 MiB block")


def tpx_wire_edge_operands(case: str, dev: torch.device) -> list[tuple[str, tuple, dict, int]]:
    """(name, wire writer operands, keywords, the u16 its sections start
    at) of one TPX_WIRE_EDGES case, on random windows, counts, states and
    freqs (the writer copies what the windows hold, so a word past its
    step's count must not reach the wire).  Phases: v3 megas of 13 rows × 8
    steps, 40 × 4 and 5 × 36 (two pieces of steps), the sections from the
    header's end and 1..7 u16 past it.  No words and every word: rows whose
    counts are all 0 or all 128 (4,096 words, 2,048 slots at 32 steps).  One
    mega of one tile: 13 rows × 32 steps, v2."""
    from hsrans_tpu_torch.kernels import tpx_encode as enc

    rng = np.random.default_rng(len(case))
    geom, v3 = {
        "sections at every even 16-byte phase": ([(13, 8, 2), (40, 4, 1), (5, 36, 1)], True),
        "rows with no words and rows of every word": ([(37, 32, 2), (8, 4, 3)], True),
        "one mega of one tile": ([(13, 32, 1)], False),
    }[case]
    desc, cnt_off, state0, tab0 = [], 0, 0, 0
    for rows, steps, n_tiles in geom:
        desc.append((0, rows, steps, n_tiles, 0, tab0, 0, cnt_off, state0))
        cnt_off, state0, tab0 = cnt_off + n_tiles * rows * steps, state0 + rows, tab0 + n_tiles
    desc = np.array(desc, np.int64)
    cnt = rng.integers(0, 129, cnt_off).astype(np.int32)
    if case == "rows with no words and rows of every word":
        rows_cnt = cnt[: 2 * 37 * 32].reshape(-1, 32)
        rows_cnt[::3] = 0
        rows_cnt[1::3] = 128
    win = rng.integers(-(1 << 31), 1 << 31, cnt_off * 128).astype(np.int32)
    states = rng.integers(-(1 << 31), 1 << 31, state0 * 128).astype(np.int32)
    freqs = rng.integers(-(1 << 15), 1 << 15, (tab0, 256)).astype(np.int16)
    row_words = np.concatenate([cnt[o : o + t * r * s].reshape(-1, s).sum(axis=1)
                                for (_, r, s, t, _, _, _, o, _) in desc.tolist()]).astype(np.int64)
    ops = tuple(torch.from_numpy(a).to(dev) for a in (win, cnt, states, freqs))
    out = []
    for shift in range(8) if case.startswith("sections") else (0,):
        wdesc, row_at, out_u16 = enc.wire_layout(desc, row_words, v3=v3, base=HEAD_U16 + shift)
        out.append((f"shift {shift}", (*ops, wdesc, row_at), {"v3": v3, "out_u16": out_u16}, HEAD_U16 + shift))
    return out


def place_edge_operands(case: str, n: int, dev: torch.device) -> list[tuple[str, tuple, dict]]:
    """(name, placement operands, keywords) of one MT_PLACE_EDGES case.
    Phases: 600 coded blocks of random regions (the scratch ends at an odd
    u16) and word counts, single-symbol rows between them, random words,
    states and freqs, so that a part's words and their source in the
    scratch meet at each of the 64 pairs of u16 phases.  One 1 MiB block:
    ENCODE_EDGES' case (1 MiB + 3,001 bytes in two blocks) encoded by the
    kernel, under both rules: a part of 16 chunks and more."""
    from hsrans_tpu_torch.kernels import mt_encode as mte
    from hsrans_tpu_torch.ops.planner import BlockPlan

    if case == "one 1 MiB block":
        out = []
        for rule in ("groups", "section"):
            ((_, (data, index, freqs), kw),) = encode_edge_operands(case, n, rule, dev)
            outs = mte.encode_blocks_cuda(data, index, freqs, **kw)
            ix = index.cpu().numpy()
            plan = [BlockPlan(int(a), int(c - a), False, 0, None) for a, c in ix[:, [0, 2]]]
            nb = len(plan)
            kinds, ks, bias = np.full(nb, 2, np.int8), np.arange(nb), np.array([1] * (nb - 1) + [2])
            out.append((rule, *place_operands(plan, kinds, ks, bias, outs[0], index, *outs[1:], freqs, n, int(ix[-1, 2]))))
        return out
    rng = np.random.default_rng(n)
    nb = 600
    region = rng.integers(1, 3000, nb)
    region[-1] |= 1  # the scratch ends at an odd u16
    count = np.minimum(rng.integers(0, 3000, nb), region)
    count[-1] = region[-1]  # the last block's words end at the scratch's end
    count[::50] = 0
    end = np.cumsum(region)
    index = np.zeros((nb, 5), np.int64)
    index[:, 4] = end
    plan, kinds, ks = [], [], []
    for b in range(nb):
        if b % 7 == 3:
            plan.append(BlockPlan(0, 4096, True, b % 256, None))
            kinds.append(1)
        plan.append(BlockPlan(0, int(count[b]) * 2 + 1, False, 0, None))
        kinds.append(2)
        ks.append(len(plan) - 1)
    ops = [torch.from_numpy(a).to(dev) for a in (
        rng.integers(-(1 << 15), 1 << 15, int(end[-1])).astype(np.int16), index, count,
        rng.integers(-(1 << 31), 1 << 31, (nb, n)).astype(np.int32),
        rng.integers(-(1 << 15), 1 << 15, (nb, 256)).astype(np.int16))]
    bias = np.where(np.arange(nb) == nb - 1, 2, 1)
    pargs, pkw = place_operands(plan, np.array(kinds, np.int8), np.array(ks), bias, *ops, n, 123_456_789)
    dest = pargs[5][:, 0].cpu().numpy()[2:][pargs[5][2:, 2].cpu().numpy() >= 0] + mte.coded_header_u16(n)
    pairs = {(int(d) % 8, int(e - c) % 8) for d, e, c in zip(dest, end, count)}
    if len(pairs) != 64:
        raise AssertionError(f"place edges: {len(pairs)} of the 64 phase pairs")
    return [("phases", pargs, pkw)]


def wire_edges(dev: torch.device) -> dict[str, list[dict]]:
    """The tpx wire writer and the mt placement against their plain
    versions on TPX_WIRE_EDGES and MT_PLACE_EDGES, exact, each also
    launched alone into a 0xAA-filled output: every byte of the sections
    (the blob) written, none below them."""
    from hsrans_tpu_torch.kernels import tpx_encode as enc

    rows: dict[str, list[dict]] = {"tpx_concat": [], "mt_place": []}
    for case in TPX_WIRE_EDGES:
        for name, wargs, wkw, base in tpx_wire_edge_operands(case, dev):
            got = enc.write_wire_cuda(*wargs, **wkw)
            torch.cuda.synchronize()
            want = enc.write_wire_plain(*wargs, **wkw)
            err = max_abs_err(got[2 * base :], want[2 * base :])
            if err:
                raise AssertionError(f"tpx wire {case}, {name}: kernel differs (max abs err {err})")
            out = torch.empty(wkw["out_u16"], dtype=torch.int16, device=dev)
            prefilled_equal(wire_launch(wargs, wkw, out, dev), out, want, base)
            rows["tpx_concat"].append({"case": case, "sub": name, "max_abs_err": err})
    for case in MT_PLACE_EDGES:
        for n in (32, 64):
            for name, pargs, pkw in place_edge_operands(case, n, dev):
                res = place_check(f"mt place {case}, {name}, n={n}", pargs, pkw, timed=False)
                rows["mt_place"].append({"case": case, "sub": name, "n": n, **res})
    emit("wire_edges", tpx_cases=len(rows["tpx_concat"]), mt_cases=len(rows["mt_place"]),
         max_abs_err=max(r["max_abs_err"] for r in rows["tpx_concat"] + rows["mt_place"]))
    return rows


# the cases that hold the two histogram kernels at their edges
# (tests/test_torch_cuda_kernels.py runs them too), each normalised at B=10,
# 12 and 15
HIST_EDGES = ("segment starts at every byte phase mod 16", "empty and one-byte segments", "single-symbol data",
              "the cases of tests/test_jax_hist.py", "several steal passes", "divisor != size, several charity passes",
              "short and long segments mixed, at the warp threshold and one either side, every byte phase")


def hist_edge_operands(case: str, dev: torch.device) -> tuple[torch.Tensor, np.ndarray, np.ndarray, np.ndarray | None]:
    """One HIST_EDGES case: (the input, uint8 on `dev`; segment starts and
    ends; the normaliser's divisors, None for the segments' own sizes)."""
    from tools.gen_inputs import text_like

    rng = np.random.default_rng(40 + HIST_EDGES.index(case))
    divisors = None
    if case == HIST_EDGES[0]:
        # at each phase of a 16-byte load, lengths that leave the aligned
        # middle empty, one load long, or several chunks long
        lens = np.array([1, 15, 16, 17, 31, 33, 4096, 100_003, 3 * (64 << 10) + 5], np.int64)
        data = text_like(rng, lens.size << 18)
        starts = (np.arange(lens.size, dtype=np.int64)[:, None] * (256 << 10) + np.arange(16)).reshape(-1)
        ends = starts + np.repeat(lens, 16)
    elif case == HIST_EDGES[1]:
        data = text_like(rng, 1 << 16)
        n = data.size
        starts = np.array([0, 5, 100, n, 7, 33, 4095, n - 1, 0, 17], np.int64)
        ends = np.array([0, 5, 50, n, 8, 34, 4096, n, n, 18], np.int64)
    elif case == HIST_EDGES[2]:
        data = np.full(3 << 20, 7, np.uint8)
        starts = np.array([0, 3, 1, 0, 5], np.int64)
        ends = np.array([1, 4099, 1 + (1 << 15), 3 << 20, 5 + (2 << 20)], np.int64)
    elif case == HIST_EDGES[3]:
        parts = [
            np.zeros(100, np.uint8),
            np.arange(256, dtype=np.uint8),
            rng.integers(0, 256, 10_000).astype(np.uint8),
            np.minimum(rng.geometric(0.07, 50_000) - 1, 255).astype(np.uint8),
            np.minimum(rng.geometric(0.60, 30_000) - 1, 255).astype(np.uint8),
            rng.choice([0, 3, 200], 7_777).astype(np.uint8),  # 3 symbols, rebalance heavy
            rng.integers(0, 2, 65_536).astype(np.uint8),  # binary
        ]
        data = np.concatenate(parts)
        ends = np.cumsum([p.size for p in parts]).astype(np.int64)
        starts = ends - [p.size for p in parts]
    elif case == HIST_EDGES[4]:
        # many symbols of one byte each, each rounded up to 1, and a few
        # large ones: the sum exceeds 2^B by ~250, the passes start past the
        # ones and take a few positions each
        rows = []
        for ones, big, reps in ((250, 6, 100_000), (128, 128, 3_000), (200, 56, 20_000)):
            syms = rng.permutation(256)
            rows.append(rng.permutation(np.concatenate([syms[:ones], np.repeat(syms[ones : ones + big], reps)])))
        data = np.concatenate(rows).astype(np.uint8)
        ends = np.cumsum([r.size for r in rows]).astype(np.int64)
        starts = ends - [r.size for r in rows]
    elif case == HIST_EDGES[5]:
        # divisors off the segments' sizes: twice the size leaves the rounded
        # sum near 2^(B-1), so the charity passes run many times over
        data = text_like(rng, 200_000)
        starts = np.array([0, 50_000, 90_000, 150_000], np.int64)
        ends = np.array([50_000, 90_000, 150_000, 160_000], np.int64)
        divisors = np.array([100_000, 30_000, 1 << 16, 12_345], np.int64)
    else:
        # one launch of both count paths, the segments in no order: a warp
        # each up to COUNT_WARP_MAX bytes, 64 KiB chunks of a CTA above; each
        # size at every byte phase
        from hsrans_tpu_torch.models.device_hist import COUNT_CHUNK, COUNT_WARP_MAX

        t = COUNT_WARP_MAX
        lens = [t - 1, t, t + 1, 0, 1, 4096, COUNT_CHUNK, COUNT_CHUNK + 1, 3 * COUNT_CHUNK + 5]
        sizes, phase = rng.permutation(np.array([(n, p) for n in lens for p in range(16)], np.int64)).T
        slot = (sizes + 31) // 16 * 16
        starts = np.cumsum(slot) - slot + phase
        ends = starts + sizes
        data = text_like(rng, int(slot.sum()))
    return torch.from_numpy(np.ascontiguousarray(data, np.uint8)).to(dev), starts, ends, divisors


def segmented_bincount(data_t: torch.Tensor, starts: np.ndarray, ends: np.ndarray):
    """One PyTorch call that computes the count kernel's segmented function
    (a segment with no bytes aside): `torch.bincount(segment * 256 + byte,
    minlength=k * 256)`, its keys built here, outside any timed window."""
    sizes = torch.from_numpy(np.maximum(ends - starts, 0)).to(data_t.device)
    first = torch.from_numpy(np.asarray(starts, np.int64)).to(data_t.device)
    seg = torch.repeat_interleave(torch.arange(len(starts), device=data_t.device), sizes)
    pos = torch.arange(seg.numel(), device=data_t.device) - torch.repeat_interleave(torch.cumsum(sizes, 0) - sizes, sizes)
    keys = seg * 256 + data_t[first[seg] + pos].to(torch.int64)
    return lambda: torch.bincount(keys, minlength=len(starts) * 256)


def hist_check(name: str, data_t: torch.Tensor, starts: np.ndarray, ends: np.ndarray, divisors: np.ndarray | None,
               bits_list: tuple[int, ...], timed: bool) -> dict:
    """The count kernel against its plain version on one input's segments,
    then the normaliser against its plain version on those counts at each
    depth (divisors: the segments' own unless given), exact.  With `timed`,
    each through its wrapper, by its launch alone and its plain version,
    the count's segmented `torch.bincount` (library_ms), and the bounds:
    the count's bytes (the segments read once, the table and counts) and
    one operation a byte; the normaliser's operands' bytes and 6 operations
    a bin, plus for each row whose rounded counts miss 2^B its heap sort
    (256 x 8 sift steps of 4 operations)."""
    from hsrans_tpu_torch.models import device_hist as dh

    dev = data_t.device
    sizes = dh.segment_sizes(starts, ends)
    got = dh.observe_segments_cuda(data_t, starts, ends)
    torch.cuda.synchronize()
    err = max_abs_err(got, dh.observe_segments_plain(data_t, starts, ends))
    if err:
        raise AssertionError(f"hist_count {name}: kernel differs from its plain version (max abs err {err})")
    table, n_short, chunks = dh.segment_table(starts, ends)
    res = {"case": name, "segments": len(starts), "bytes": int(sizes.sum()),
           "hist_count": {"max_abs_err": err, "warp_segments": n_short, "chunks": chunks}}
    if timed:
        table_t, out = torch.from_numpy(table).to(dev), torch.empty_like(got)
        library = segmented_bincount(data_t, starts, ends)
        full = torch.from_numpy(sizes > 0).to(dev)
        if not torch.equal(library().view(-1, 256).to(torch.int32)[full], got[full]):
            raise AssertionError(f"hist_count {name}: the segmented torch.bincount differs from the kernel")
        res["hist_count"] |= {
            "ms": cuda_ms(lambda: dh.observe_segments_cuda(data_t, starts, ends), 20, queue_ahead=True),
            "launch_ms": cuda_ms(lambda: dh.launch_count(data_t, table_t, out, n_short=n_short, chunks=chunks), 20,
                                 queue_ahead=True),
            "ms_host_paced": cuda_ms(lambda: dh.observe_segments_cuda(data_t, starts, ends), 20),
            "plain_ms": cuda_ms(lambda: dh.observe_segments_plain(data_t, starts, ends), 1),
            "library_ms": cuda_ms(library, 5, queue_ahead=True),
            **bound(int(sizes.sum()) + nbytes(table_t, got), int(sizes.sum())),
        }
        del library
        if not torch.equal(out, got):
            raise AssertionError(f"hist_count {name}: the timed launches differ from the kernel's first")
    div = dh.segment_divisors(starts, ends) if divisors is None else divisors
    div_t = torch.from_numpy(np.asarray(div, np.int64)).to(dev)
    for bits in bits_list:
        freq = dh.normalize_rows_cuda(got, div_t, bits)
        torch.cuda.synchronize()
        err = max_abs_err(freq, dh.normalize_rows_plain(got, div_t, bits))
        if err:
            raise AssertionError(f"hist_normalize {name} B={bits}: kernel differs from its plain version (max abs err {err})")
        fixed = int((dh.round_rows(got, div_t, bits).sum(dim=1) != 1 << bits).sum())
        row = {"max_abs_err": err, "rows_fixed": fixed}
        if timed:
            outs = tuple(torch.empty_like(x) for x in freq)
            row |= {
                "ms": cuda_ms(lambda: dh.normalize_rows_cuda(got, div_t, bits), 20, queue_ahead=True),
                "launch_ms": cuda_ms(lambda: dh.launch_normalize(got, div_t, *outs, bits=bits), 20, queue_ahead=True),
                "ms_host_paced": cuda_ms(lambda: dh.normalize_rows_cuda(got, div_t, bits), 20),
                "plain_ms": cuda_ms(lambda: dh.normalize_rows_plain(got, div_t, bits), 1),
                **bound(nbytes(got, div_t, *freq), 6 * got.numel() + fixed * 256 * 8 * 4),
            }
        res[f"hist_normalize_B{bits}"] = row
    return res


def hist_split(data_t: torch.Tensor, starts: np.ndarray, ends: np.ndarray, tables: bool, reps: int = 5) -> dict:
    """The `kernel_hist` layer of one path split into its steps, the median
    of `reps` passes after a warm one: segment_hists's own (checks, table,
    h2d, count, normalize) and, for tpx, the encode tables in torch
    (`enc_tables_device`), each with the card synchronized at its ends; and
    the whole call unsplit (`segment_hists` and the tables), which must
    make no wait on the card (torch's sync debug mode raises on one)."""
    from hsrans_tpu_torch.kernels.tpx_encode import enc_tables_device
    from hsrans_tpu_torch.models import device_hist as dh
    from hsrans_tpu_torch.runtime.device import layer_clock

    passes = []
    for _ in range(reps + 1):
        split: dict[str, float] = {}
        freq, cumul = dh.segment_hists(data_t, starts, ends, 12, split=split)
        if tables:
            with layer_clock(split, "enc_tables", data_t.device):
                enc_tables_device(freq, cumul, 12)
        passes.append(split)

    def whole():
        freq, cumul = dh.segment_hists(data_t, starts, ends, 12)
        if tables:
            enc_tables_device(freq, cumul, 12)

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        whole()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return {**{k: statistics.median(p[k] for p in passes[1:]) for k in passes[0]},
            "whole_s": statistics.median(host_s(whole, reps + 1)[1:]), "no_wait_on_the_card": True}


def hist_kernels_vs_plain(data: np.ndarray, dev: torch.device) -> tuple[list[dict], list[dict], float]:
    """Both histogram kernels against their plain versions on the same CUDA
    tensors: mt encode (b)'s 16,384 blocks of 4 KiB of the 64 MiB text at
    B=12 (the launch of its main path), the 64 MiB tpx main path's 16 tiles
    at B=12 and B=15, the reference planner's largest block of the Zipf
    input (2^25 bytes) at B=12, each timed, and HIST_EDGES at B=10, 12 and
    15; the `kernel_hist` layer of tpx encode and of mt encode (b) split
    into its steps; and one `torch.bincount` over the whole 64 MiB (the
    parent's library_ms, one histogram; the port never calls it).  Returns
    the timed rows (mt (b)'s, then the tiles'), the edge rows and that
    time."""
    from hsrans_tpu_torch.kernels import tpx_encode as enc
    from hsrans_tpu_torch.ops.tpx import TpxParams, _mega_layout

    data_t = torch.from_numpy(data).to(dev)
    p = TpxParams()
    _, tstarts, tends = enc.mega_segments([(b, p.rows, p.steps, n, v) for b, n, v in _mega_layout(data.size, p)])
    mstarts = np.arange(0, data.size, 4096, dtype=np.int64)
    mends = np.minimum(mstarts + 4096, data.size)
    zipf, plan, _ = zipf_input()
    big = max(plan, key=lambda r: r.size)
    rows = [
        hist_check(f"mt encode (b): 64 MiB text, {mstarts.size} blocks of 4 KiB", data_t, mstarts, mends, None, (12,),
                   True),
        hist_check(f"tpx 64 MiB main path: {tstarts.size} tiles", data_t, tstarts, tends, None, (12, 15), True),
        hist_check(f"the reference planner's largest block of the Zipf input ({big.size} bytes)",
                   torch.from_numpy(zipf).to(dev), np.array([big.start]), np.array([big.start + big.size]), None, (12,),
                   True),
    ]
    for r in rows:
        emit("hist_kernels_vs_plain", **r)
    edges = [hist_check(case, *hist_edge_operands(case, dev), (10, 12, 15), False) for case in HIST_EDGES]
    emit("hist_edges", cases=edges)
    emit("hist_layer_split", tpx_encode=hist_split(data_t, tstarts, tends, True),
         mt_encode_b=hist_split(data_t, mstarts, mends, False))
    library_ms = cuda_ms(lambda: torch.bincount(data_t, minlength=256), 20, queue_ahead=True)
    emit("hist_library", bytes=data.size, torch_bincount_ms=library_ms)
    return rows, edges, library_ms


# The scan kernels' edge cases, each exact against its plain version
# (tests/test_torch_cuda_kernels.py runs them too): every stream its own
# stream and tables, one stream and one table set shared by all, streams cut
# short (reads from before their start, which wrap, and past their end,
# which read 0xFFFF), `__graft_entry__.entry`'s shapes and tables (freq 1,
# cumul 0: no rANS tables, so the state arithmetic wraps); and the decode's
# shared-memory tables and stream ring at their edges: tables shorter than
# 2^B slots by a length off the 16-byte grid (the staged slots past them
# read 255 / 0xFFFF), tables of 2^16 slots (above the shared-memory
# constant: the L1 route), streams of a few hundred words on rows at every
# 16-byte phase whose reads run into the ring's refills past W; and the
# encode's division at its edges (freqs up to 0xFFFF and 0, states over all
# of u32).
SCAN_EDGES = ("per-stream", "shared", "short streams", "entry tables", "short tables", "wide tables",
              "wide divisors", "refills past W")
SCAN_STEPS = 256  # groups of each case: the plain versions take ~0.1 s a case on the card
SCAN_RING_HALF = 512  # csrc/scan.cu's kRingHalf: the ring's first refill starts 1,024 words in


def scan_case_shapes(case: str) -> list[tuple[int, int]]:
    """The (n, bits) pairs at which a SCAN_EDGES case runs."""
    if case == "entry tables":
        return [(64, 12)]
    if case == "wide tables":
        return [(n, 16) for n in (16, 32, 64)]
    if case == "refills past W":
        return [(n, 12) for n in (16, 32, 64)]
    if case == "wide divisors":
        return [(n, b) for n in (16, 32, 64) for b in (10, 15, 31)]
    return [(n, b) for n in (16, 32, 64) for b in (10, 12, 15)]


def scan_edge_operands(case: str, n: int, bits: int, dev: torch.device) -> list[tuple[str, tuple, dict]]:
    """[("decode" | "encode", operands, keywords)] of one SCAN_EDGES case at
    one of its scan_case_shapes on `dev` ("entry tables": B=8, n=64,
    bits=12, 32 steps), made with numpy from a seed: random states, the
    stream words and tail counts, tables of real histograms of enwik8-like
    text (random tables at 2^16 slots).  The first four cases give one
    decode and one encode; "short tables", "wide tables" and "refills past
    W" two decodes (per-stream and shared rows), "wide divisors" two encodes
    (per-stream and shared tables)."""
    from hsrans_tpu_torch.models.histogram import complete_hist, normalize_hist, observe_hist
    from hsrans_tpu_torch.models.tables import make_dec3
    from tools.gen_inputs import text_like

    rng = np.random.default_rng(SCAN_EDGES.index(case) * 1000 + n * 16 + bits)
    nb, steps, w = 64, SCAN_STEPS, SCAN_STEPS * n

    def t(a, dtype=None):
        x = torch.from_numpy(np.ascontiguousarray(a))
        return (x.view(dtype) if dtype is not None else x).to(dev)

    def text_freqs(rows: int, b: int) -> list[np.ndarray]:
        out = []
        for _ in range(rows):
            src = text_like(rng, int(rng.integers(2000, 40000)))
            out.append(normalize_hist(observe_hist(src), src.size, b).symbol_count)
        return out

    def dec_tables(freqs: list[np.ndarray], b: int) -> tuple[np.ndarray, ...]:
        tabs = [make_dec3(complete_hist(f, b)) for f in freqs]
        return tuple(np.stack([tab[k] for tab in tabs]).astype(dt)
                     for k, dt in (("sym", np.uint8), ("freq", np.uint16), ("cumul", np.uint16)))

    def dec(states, stream, read_pos, sym, tfreq, tcum, valid, tail=True):
        return ("decode", (t(states, torch.int32), t(stream, torch.int16), t(read_pos), t(sym), t(tfreq, torch.int16),
                           t(tcum, torch.int16), t(valid)), {"bits": bits, "num_steps": steps, "tail": tail})

    def enc(states, group_bytes, evalid, efreq, ecum):
        return ("encode", (t(states, torch.int32), t(group_bytes), t(evalid), t(efreq.astype(np.uint16), torch.int16),
                           t(ecum.astype(np.uint16), torch.int16)), {"bits": bits, "num_steps": steps})

    def tails(k: int) -> np.ndarray:
        return rng.integers(0, steps * n + 2, k).astype(np.int32)

    if case in ("short tables", "refills past W"):
        sym, tfreq, tcum = dec_tables(text_freqs(nb, bits), bits)
        states = rng.integers(1 << 15, 1 << 31, (nb, n), dtype=np.uint32)
        if case == "short tables":  # lengths off the 16-byte grid, per-stream and shared
            cut, cut1 = (5 << bits) // 8 + 3, (1 << bits) - 7
            stream = rng.integers(0, 1 << 16, (nb, w), dtype=np.uint32).astype(np.uint16)
            read_pos = np.zeros(nb, np.int32)
            return [dec(states, stream, read_pos, sym[:, :cut], tfreq[:, :cut], tcum[:, :cut], tails(nb)),
                    dec(states, stream[0], read_pos, sym[0, :cut1], tfreq[0, :cut1], tcum[0, :cut1], tails(nb))]
        # a stream of an odd number of words under the ring's first refill
        w = SCAN_RING_HALF + 89 + 2 * n
        stream = rng.integers(0, 1 << 16, (nb, w), dtype=np.uint32).astype(np.uint16)
        read_pos = rng.integers(0, w, nb).astype(np.int32)
        read_pos[:4] = (0, 1, w - 1, w)
        return [dec(states, stream, read_pos, sym, tfreq, tcum, tails(nb)),
                dec(states, stream[0], read_pos, sym[0], tfreq[0], tcum[0], tails(nb), tail=False)]
    if case == "wide tables":  # 2^16 random slots: the L1 route, per-stream and shared (cut short)
        nb = 16
        states = rng.integers(0, 1 << 32, (nb, n), dtype=np.uint64).astype(np.uint32)
        stream = rng.integers(0, 1 << 16, (nb, w), dtype=np.uint32).astype(np.uint16)
        sym = rng.integers(0, 256, (nb, 1 << bits), dtype=np.int64).astype(np.uint8)
        tfreq, tcum = (rng.integers(0, 1 << 16, (nb, 1 << bits), dtype=np.uint32).astype(np.uint16) for _ in range(2))
        read_pos = np.zeros(nb, np.int32)
        cut = (1 << bits) - 5
        return [dec(states, stream, read_pos, sym, tfreq, tcum, tails(nb)),
                dec(states, stream[0], read_pos, sym[0, :cut], tfreq[0, :cut], tcum[0, :cut], tails(nb))]
    if case == "wide divisors":  # freqs over all of u16 and 0, states over all of u32
        edges = np.array([0, 1, 2, 3, 255, 0x7FFF, 0x8000, 0x8001, 0xFFFE, 0xFFFF], np.uint32)
        efreq = rng.integers(0, 1 << 16, (nb, 256), dtype=np.uint32)
        efreq[:, : edges.size] = edges
        efreq = np.take_along_axis(efreq, rng.permuted(np.tile(np.arange(256), (nb, 1)), axis=1), axis=1)
        ecum = rng.integers(0, 1 << 16, (nb, 256), dtype=np.uint32)
        states = rng.integers(0, 1 << 32, (nb, n), dtype=np.uint64).astype(np.uint32)
        states[:, :4] = (0, (1 << 31) - 1, 1 << 31, (1 << 32) - 1)
        group_bytes = rng.integers(0, 256, (nb, steps, n), dtype=np.int64).astype(np.uint8)
        evalid = rng.random((nb, steps, n)) < 0.9
        return [enc(states, group_bytes, evalid, efreq, ecum), enc(states, group_bytes, evalid, efreq[1], ecum[1])]

    if case == "entry tables":
        nb, n, bits, steps, w = 8, 64, 12, 32, 4096
    freqs = text_freqs(nb, bits)
    sym, tfreq, tcum = dec_tables(freqs, bits)
    if case == "entry tables":
        sym = rng.integers(0, 256, (nb, 1 << bits), dtype=np.int64).astype(np.uint8)
        tfreq, tcum = np.ones((nb, 1 << bits), np.uint16), np.zeros((nb, 1 << bits), np.uint16)
    states = rng.integers(1 << 15, 1 << 31, (nb, n), dtype=np.uint32)
    if case == "short streams":
        w = 3 * n
    stream = rng.integers(0, 1 << 16, (nb, w), dtype=np.uint32).astype(np.uint16)
    read_pos = np.zeros(nb, np.int32)
    valid = np.full(nb, steps * n, np.int32) if case == "entry tables" else rng.integers(0, steps * n + 2, nb).astype(np.int32)
    if case == "short streams":
        read_pos = rng.integers(-w - 2, w, nb).astype(np.int32)
    if case == "shared":
        stream, sym, tfreq, tcum = stream[0], sym[0], tfreq[0], tcum[0]
    efreq = np.stack(freqs) if case != "shared" else freqs[0]
    ecum = (np.cumsum(efreq, axis=-1, dtype=np.uint64) - efreq).astype(np.uint16)
    group_bytes = text_like(rng, nb * steps * n).reshape(nb, steps, n)
    evalid = np.arange(steps * n).reshape(steps, n)[None] < rng.integers(0, steps * n + 1, nb)[:, None, None]
    # tail off in one decode case a depth; on, every lane's count is checked at every step
    return [dec(states, stream, read_pos, sym, tfreq, tcum, valid, tail=not (case == "per-stream" and bits == 12)),
            enc(states, group_bytes, evalid, efreq, ecum)]


def scan_check(kind: str, args: tuple, kw: dict) -> dict:
    """One scan kernel against its plain version on the same CUDA tensors,
    exact; decode also reports the streams whose reads ran past the stream
    (final read position at or past W)."""
    from hsrans_tpu_torch.kernels import scan

    cuda, plain = ((scan.decode_section_cuda, scan.decode_section_plain) if kind == "decode"
                   else (scan.encode_section_cuda, scan.encode_section_plain))
    got = cuda(*args, **kw)
    torch.cuda.synchronize()
    err = max_abs_err(got, plain(*args, **kw))
    if err:
        raise AssertionError(f"scan {kind} {kw}: kernel differs from its plain version (max abs err {err})")
    res = {"max_abs_err": err}
    if kind == "decode":
        res["streams_read_past_w"] = int((got[2] >= args[1].shape[-1]).sum())
    return res


def scan_kernel_row(kind: str, args: tuple, kw: dict, symbols: int, dev: torch.device) -> dict:
    """The kernel at a main path's launch: against its plain version, timed
    through its wrapper (queued and host-paced), by its launch alone and
    over its chain's links (num_steps), beside the plain version and the
    bound (a chain: the bound is the bytes and operations, not the links)."""
    from hsrans_tpu_torch.kernels import scan

    res = scan_check(kind, args, kw)
    steps = kw["num_steps"]
    if kind == "decode":
        wrapper, plain = scan.decode_section_cuda, scan.decode_section_plain
        outs = wrapper(*args, **kw)
        stride = args[3].shape[-1] if args[3].dim() == 2 else 0
        launch = lambda: scan.launch_decode(*args[:6], stride, args[6], *outs, bits=kw["bits"], tail=kw["tail"])  # noqa: E731
        # every operand but the stream, of which the words consumed; the outputs
        moved = nbytes(*args, *outs) - nbytes(args[1]) + 2 * int((outs[2].to(torch.int64) - args[2]).sum())
    else:
        wrapper, plain = scan.encode_section_cuda, scan.encode_section_plain
        outs = wrapper(*args, **kw)
        stride = 256 if args[3].dim() == 2 else 0
        launch = lambda: scan.launch_encode(*args, stride, *outs, bits=kw["bits"])  # noqa: E731
        moved = nbytes(*args, *outs)
    res |= {
        "ms": cuda_ms(lambda: wrapper(*args, **kw), 5, queue_ahead=True),
        "ms_host_paced": cuda_ms(lambda: wrapper(*args, **kw), 5),
        **launch_times(launch, steps),
        "plain_ms": cuda_ms(lambda: plain(*args, **kw), 1),
        **bound(moved, OPS_PER_SYMBOL[kind] * symbols),
        "streams": int(args[0].shape[0]), "lanes": int(args[0].shape[1]), "steps": steps,
        "bound_note": "a chain per stream: the links, not bytes or operations, set its time",
    }
    return res


# the prefix of the 64 MiB raw input that the port's numpy raw wire encodes
# to check the card's blob, by lane count: one that loop (one Python step a
# lane group, 0.42, 0.74 and 1.35 s a MiB at n = 64, 32 and 16 on the H100
# machine's host, its numpy_encode_s) encodes in under a minute: the whole
# input at n = 64 and 32, half of it at n = 16.  The three run at once in
# worker processes while the card runs its round trips.
RAW_COMPARE_MIB = {64: 64, 32: 64, 16: 32}


def numpy_raw_blob(data: np.ndarray, hist, n: int) -> tuple[bytes, float]:
    """The port's numpy raw wire of `data` and its seconds (in a worker)."""
    from hsrans_tpu_torch.ops.reference import raw_encode_16w

    t0 = time.perf_counter()
    blob = raw_encode_16w(data, hist, n)
    return blob, time.perf_counter() - t0


def timed_s(fn):
    """(fn(), its seconds on the host's clock)."""
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def once_ms(fn) -> float:
    """One call's milliseconds by CUDA events (a chain that takes seconds)."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def scan_phases(repo: Path, dev: torch.device, ctx: dict, tpx_data: np.ndarray, tpx_blob: bytes) -> tuple[dict, dict]:
    """The XLA scan codecs and the device fan-out on the card: the two scan
    kernels against their plain versions (SCAN_EDGES at n = 16, 32, 64 and
    B = 10, 12, 15), the raw wire's 64 MiB round trips, mt_decode_device's
    chain and the n=16 mt round trip at 64 MiB, the split over two devices,
    and malformed mt blobs.  Returns the kernel rows (at the n=16 round
    trip's launches) and the launches of each path."""
    from hsrans_tpu_torch import raw_decode_torch, raw_encode_torch, tpx_encode_torch
    from hsrans_tpu_torch.kernels import scan
    from hsrans_tpu_torch.kernels.mt_encode import plan_freqs, plan_rows, scan_operands
    from hsrans_tpu_torch.models.histogram import normalize_hist, observe_hist
    from hsrans_tpu_torch.ops.raw_scan import raw_decode_operands
    from hsrans_tpu_torch.ops.tpx import TpxParams
    from hsrans_tpu_torch.ops.mt import block_index, mt_encode_py
    from hsrans_tpu_torch.parallel import sharded as psh
    from hsrans_tpu_torch.parallel.tpx_sharded import tpx_decode_device, tpx_encode_device
    from hsrans_tpu_torch.runtime import build
    from tools.gen_inputs import text_like

    # 1. each kernel against its plain version on SCAN_EDGES
    cases = []
    for case in SCAN_EDGES:
        for n, bits in scan_case_shapes(case):
            for kind, args, kw in scan_edge_operands(case, n, bits, dev):
                cases.append({"case": case, "kind": kind, "n": n, "bits": bits, **scan_check(kind, args, kw)})
    past = {c: sum(r.get("streams_read_past_w", 0) for r in cases if r["case"] == c)
            for c in ("short streams", "refills past W")}
    if not all(past.values()):
        raise AssertionError(f"scan decode: streams read past their end {past}, some in each case expected")
    emit("scan_kernels_vs_plain", cases=len(cases), max_abs_err=max(c["max_abs_err"] for c in cases),
         streams_read_past_w=past, by_case={c: sum(r["case"] == c for r in cases) for c in SCAN_EDGES})

    # 2. the raw wire: 64 MiB of enwik8-like text (seed 8) at B=12 and n = 64,
    #    32, 16, each one stream: a single chain of ceil(length / n) links.
    #    The card's blob is checked against the port's numpy copy of the wire
    #    on RAW_COMPARE_MIB's prefix, encoded in worker processes meanwhile
    data = tpx_data
    hist = normalize_hist(observe_hist(data), data.size, 12)
    raw = {}
    raw_launches = {}
    card_blobs = {}
    spawn = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=len(RAW_COMPARE_MIB), mp_context=spawn) as pool:
        numpy_runs = {n: pool.submit(numpy_raw_blob, data[: mib * MIB], hist, n) for n, mib in RAW_COMPARE_MIB.items()}
        for n in RAW_COMPARE_MIB:
            build.reset_launches()
            blob, enc_s = timed_s(lambda: raw_encode_torch(data, hist, n, device="cuda"))
            back, dec_s = timed_s(lambda: raw_decode_torch(blob, 12, n, device="cuda"))
            raw_launches[n] = {k: build.LAUNCHES[k] for k in ("scan_decode", "scan_encode")}
            if back != data.tobytes():
                raise AssertionError(f"raw n={n}: raw_decode_torch does not return the 64 MiB input")
            if raw_launches[n] != {"scan_decode": 1, "scan_encode": 1}:
                raise AssertionError(f"raw n={n}: launches {raw_launches[n]}, one of each scan kernel expected")
            # the decode's launch alone: one chain of the whole blob
            steps = -(-data.size // n)
            dargs = raw_decode_operands(blob, 12, n, dev)[1]
            outs = (torch.empty((1, steps, n), dtype=torch.uint8, device=dev),
                    torch.empty((1, n), dtype=torch.int32, device=dev), torch.empty(1, dtype=torch.int32, device=dev))
            dec_ms = once_ms(lambda: scan.launch_decode(*dargs[:6], 0, dargs[6], *outs, bits=12, tail=True))
            card_blobs[n] = blob
            raw[n] = {"bytes": data.size, "ratio": len(blob) / data.size, "encode_s": enc_s, "decode_s": dec_s,
                      "encode_MiBps": data.size / MIB / enc_s, "decode_MiBps": data.size / MIB / dec_s,
                      "decode_launch_ms": dec_ms, "decode_link_us": dec_ms * 1e3 / steps, "links": steps,
                      "launches": raw_launches[n]}
        for n, mib in RAW_COMPARE_MIB.items():
            want, numpy_s = numpy_runs[n].result()
            part = data[: mib * MIB]
            got = card_blobs[n] if part.size == data.size else raw_encode_torch(part, hist, n, device="cuda")
            if got != want:
                raise AssertionError(f"raw n={n}: the card's blob of {mib} MiB differs from raw_encode_16w's")
            raw[n].update(numpy_compare_MiB=mib, numpy_encode_s=numpy_s)
    emit("raw_round_trip", bits=12, **{f"n={n}": v for n, v in raw.items()})

    # 3. mt_decode_device's chain on the 64 MiB x-ray device_plan blob: step
    #    (a), then step (c) alone on its 2,472 coded blocks
    xray_data, _ = ctx["main"]
    main_blob = ctx["main_blob"]
    build.reset_launches()
    t0 = time.perf_counter()
    if psh.mt_decode_device(main_blob, 12, 64, device="cuda") != xray_data.tobytes():
        raise AssertionError("mt_decode_device: the 64 MiB x-ray blob does not decode to its input")
    chain_s = time.perf_counter() - t0
    step_a = {k: build.LAUNCHES[k] for k in ("mt_decode", "scan_decode")}
    if step_a != {"mt_decode": 1, "scan_decode": 0}:
        raise AssertionError(f"mt_decode_device: launches {step_a}, step (a) alone expected")
    build.reset_launches()
    t0 = time.perf_counter()
    if psh.scan_decode_blob(main_blob, 12, 64, [dev]) != xray_data.tobytes():
        raise AssertionError("step (c): the batched scan decode does not return the 64 MiB x-ray input")
    step_c_s = time.perf_counter() - t0
    if build.LAUNCHES["scan_decode"] != 1:
        raise AssertionError(f"step (c): {build.LAUNCHES['scan_decode']} scan_decode launches, 1 expected")
    _, stream, blocks = block_index(main_blob, 64)
    bb_main = psh.gather_blocks(blocks, 12, 64)
    step_c_row = scan_kernel_row("decode", psh.batch_operands(bb_main, stream, slice(None), dev),
                                 {"bits": 12, "num_steps": bb_main.max_steps, "tail": True}, int(bb_main.sizes.sum()), dev)

    # 4. n=16: mt_encode_device and mt_decode_device on 64 MiB of x-ray in
    #    uniform 64 KiB blocks (1,024 blocks x 4,096 groups), both scan
    #    kernels batched at full width; the blob == the CPU tier's
    plan16 = psh.uniform_plan(xray_data, 12, 16, 64 << 10)
    build.reset_launches()
    t0 = time.perf_counter()
    blob16 = psh.mt_encode_device(xray_data, 12, 16, plan=plan16, device="cuda")
    enc16_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back16 = psh.mt_decode_device(blob16, 12, 16, device="cuda")
    dec16_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = {k: build.LAUNCHES[k] for k in ("scan_encode", "scan_decode", "mt_decode", "mt_encode")}
    if back16 != xray_data.tobytes():
        raise AssertionError("mt n=16: the 64 MiB round trip does not return the input")
    if launches != {"scan_encode": 1, "scan_decode": 1, "mt_decode": 0, "mt_encode": 0}:
        raise AssertionError(f"mt n=16: launches {launches}, one of each scan kernel expected")
    t0 = time.perf_counter()
    if psh.mt_encode_device(xray_data, 12, 16, plan=plan16, device="cpu") != blob16:
        raise AssertionError("mt n=16: the card's blob differs from the CPU tier's")
    cpu16_s = time.perf_counter() - t0
    data_t = torch.from_numpy(xray_data).to(dev)
    _, ks, index, given, freqs, _ = plan_rows(xray_data, plan16, 12, 16, "section")
    freqs_t = plan_freqs(data_t, ks, index, given, freqs, 12, 16)
    *eops, esteps = scan_operands(data_t, torch.from_numpy(index).to(dev), freqs_t, 16)
    rows = {"scan_encode": scan_kernel_row("encode", tuple(eops), {"bits": 12, "num_steps": esteps}, xray_data.size, dev)}
    _, stream, blocks = block_index(blob16, 16)
    bb = psh.gather_blocks(blocks, 12, 16)
    rows["scan_decode"] = scan_kernel_row("decode", psh.batch_operands(bb, stream, slice(None), dev),
                                          {"bits": 12, "num_steps": bb.max_steps, "tail": True}, xray_data.size, dev)
    for name in rows:
        rows[name]["max_abs_err"] = max([rows[name]["max_abs_err"], *(c["max_abs_err"] for c in cases
                                                                       if c["kind"] == name[5:])])

    # 5. the split over two devices (one card, named twice): the bytes of one,
    #    and each call's seconds on one device and on two (host clock, the
    #    call's whole time: bytes in, bytes out)
    split, split_s = {}, {}
    two = [dev, dev]
    plan64 = psh.uniform_plan(xray_data, 12, 64, 64 << 10)
    blob64 = psh.mt_encode_device(xray_data, 12, 64, plan=plan64, device="cuda")  # warm
    tpx_params = TpxParams(bits=12)
    calls = {
        "mt n=64 encode": lambda devs: psh.mt_encode_device(xray_data, 12, 64, plan=plan64, devices=devs),
        "mt n=64 decode, step (a)": lambda devs: psh.mt_decode_device(blob64, 12, 64, devices=devs),
        "mt n=16 encode": lambda devs: psh.mt_encode_device(xray_data, 12, 16, plan=plan16, devices=devs),
        "mt n=16 decode, step (c)": lambda devs: psh.mt_decode_device(blob16, 12, 16, devices=devs),
        "tpx encode": lambda devs: tpx_encode_device(tpx_data, 12, devices=devs),
        "tpx decode": lambda devs: tpx_decode_device(tpx_blob, devices=devs),
    }
    want = {"mt n=64 encode": blob64, "mt n=64 decode, step (a)": xray_data.tobytes(), "mt n=16 encode": blob16,
            "mt n=16 decode, step (c)": xray_data.tobytes(), "tpx decode": tpx_data.tobytes(),
            # the JAX default geometry, as tpx_encode_torch's at 64 MiB
            "tpx encode": tpx_encode_torch(tpx_data, p=tpx_params, device="cuda")}
    for name, call in calls.items():
        one, one_s = timed_s(lambda: call([dev]))
        got, two_s = timed_s(lambda: call(two))
        split[name] = one == want[name] and got == one
        split_s[name] = {"one_device_s": one_s, "two_devices_s": two_s}
    if not all(split.values()):
        raise AssertionError(f"the split over two devices changed bytes: {split}")

    # 6. malformed mt blobs through the whole chain, n=64 (mt decode's
    #    malformed blobs, the bad-freq blob) and n=16 (step (c)): None or
    #    bytes, the CPU tier's outcome, no CUDA fault afterwards
    small_data, small, bad = ctx["malformed"]
    bad = list(bad)
    rng = np.random.default_rng(111)
    freq_data = text_like(np.random.default_rng(1), 3 * 4096 + 100)
    fb = bytearray(mt_encode_py(freq_data, 12, 64, psh.uniform_plan(freq_data, 12, 64, 4096)))
    f = np.frombuffer(bytes(fb[288:800]), "<u2").copy()  # the first block's freqs, summed to 2^12 + 1
    f[np.argmax(f)] += 1
    fb[288:800] = f.astype("<u2").tobytes()
    bad.append(bytes(fb))
    small16 = mt_encode_py(small_data[: 1 << 18], 12, 16, psh.uniform_plan(small_data[: 1 << 18], 12, 16, 16 << 10))
    bad16 = [small16[:cut] for cut in (0, 16, 1000, len(small16) // 2, len(small16) - 1)]
    for lo, hi in ((0, 3), (16, 32), (32, 96), (96, 608), (608, len(small16))):
        for _ in range(3):
            b = bytearray(small16)
            b[int(rng.integers(lo, hi))] ^= int(rng.integers(1, 256))
            bad16.append(bytes(b))
    outcomes = {"none": 0, "bytes": 0}
    for n, blobs in ((64, bad), (16, bad16)):
        for b in blobs:
            out = psh.mt_decode_device(b, 12, n, device="cuda")
            if out != psh.mt_decode_device(b, 12, n, device="cpu"):
                raise AssertionError(f"mt_decode_device n={n}: a malformed blob's outcome differs from the CPU tier's")
            outcomes["none" if out is None else "bytes"] += 1
    torch.cuda.synchronize()
    if psh.mt_decode_device(bad[-1], 12, 64, device="cuda") is not None:
        raise AssertionError("mt_decode_device: the bad-freq blob did not give None")
    if psh.mt_decode_device(small16, 12, 16, device="cuda") != small_data[: 1 << 18].tobytes():
        raise AssertionError("mt_decode_device n=16: decode after the malformed blobs failed")
    emit("mt_device_chain", bytes=xray_data.size, step_a_launches=step_a, chain_s=chain_s, step_c_s=step_c_s,
         step_c_blocks=int(bb_main.states.shape[0]),
         step_c_kernel=step_c_row, n16={"blocks": len(plan16), "groups": int(index[:, 1].max()), "encode_s": enc16_s,
                                        "decode_s": dec16_s, "cpu_tier_encode_s": cpu16_s, "launches": launches},
         split=split, split_s=split_s, malformed=outcomes)
    emit("scan_kernels_main_path", **rows)
    return rows, {"n16": launches, "raw": raw_launches}


CLI_COMPARE_BYTES = 1 << 20  # (d)'s prefix
# the kernels each kind of device row must launch
CLI_ROW_KERNELS = {"tpx": {"tpx_encode", "tpx_concat", "tpx_decode", "hist_count", "hist_normalize"},
                   "dev": {"mt_encode", "mt_place", "mt_decode"}}


def cli_row_kind(name: str) -> str | None:
    """"tpx" or "dev" for the CLI's device rows, None for its host rows."""
    return "tpx" if name.startswith("tpx ") else "dev" if " dev " in name else None


def cli_run(argv: list[str]) -> tuple[int, list[dict], str]:
    """`hsrans_tpu_torch.cli.main(argv)` in this process, its table captured:
    the exit code, each row's figures with the seconds and the kernel
    launches since the row before (the counts set to 0 just before), and
    the table."""
    import contextlib
    import io

    from hsrans_tpu_torch import cli
    from hsrans_tpu_torch.runtime import build

    rows = []
    build.reset_launches()
    last = [dict(build.LAUNCHES), time.perf_counter()]

    def on_row(row: dict) -> None:
        now, t = dict(build.LAUNCHES), time.perf_counter()
        rows.append({**row, "s": t - last[1], "launches": {k: v - last[0][k] for k, v in now.items() if v != last[0][k]}})
        last[:] = [now, t]

    table = io.StringIO()
    with contextlib.redirect_stdout(table):
        rc = cli.main(argv, on_row=on_row)
    return rc, rows, table.getvalue()


def torch_tier_blob(path: str, nbytes: int, name: str) -> tuple[str, bytes]:
    """A CLI row's blob at the torch tier (`--backend interpret`: the plain
    PyTorch versions on the CPU) on the file's first `nbytes` (in a worker)."""
    from hsrans_tpu_torch import cli

    torch.set_num_threads(1)
    data = np.fromfile(path, np.uint8, count=nbytes)
    rows = {c["name"]: c for c in cli._build_codecs(cli.parse_args([path, "--test", "--backend", "interpret"]))}
    return name, rows[name]["enc"](data)


def cli_phases(repo: Path, data: np.ndarray) -> dict[str, int]:
    """Phase 13, the port's CLI at the cuda tier on the card, on the 64 MiB
    text in a file: (a) `--test` over B 10-15, every row OK; (b) the B=12 table of 3 runs, one JSON line
    a row; (c) the device rows' kernel launches, none for the host rows;
    (d) every row's blob on a 1 MiB prefix equal to the torch tier's; (e)
    `utils/profiling.trace` around one 64 MiB tpx decode and one mt dev
    round trip, the card's busy share of each window.  Returns the device
    kernels' launches in (a)."""
    import tempfile

    from hsrans_tpu_torch import cli, mt_decode_torch, mt_encode_torch, tpx_decode_torch, tpx_encode_torch
    from hsrans_tpu_torch.utils.profiling import device_busy, trace

    out_dir = repo / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (repo / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=repo / "build") as tmp:
        path = Path(tmp) / "text_64mib.bin"
        data.tofile(path)
        spawn = multiprocessing.get_context("spawn")
        names = [c["name"] for c in cli._build_codecs(cli.parse_args([str(path), "--test"]))]
        with ProcessPoolExecutor(max_workers=6, mp_context=spawn) as pool:
            # (d)'s torch tier on the host's cores while the card runs (a)
            cpu_runs = [pool.submit(torch_tier_blob, str(path), CLI_COMPARE_BYTES, name) for name in names]

            # (a) --test over B 10-15 at the default (cuda) tier
            t0 = time.perf_counter()
            rc, rows, table = cli_run([str(path), "--test"])
            test_s = time.perf_counter() - t0
            (out_dir / "cli_test_table.txt").write_text(table)
            bad = [r["name"] for r in rows if not r["ok"]]
            if rc != 0 or bad or len(rows) != 72 or "--test: ALL OK" not in table:
                raise AssertionError(f"cli --test: exit {rc}, {len(rows)} rows, not OK: {bad}\n{table[-3000:]}")

            # (c) the device rows went through their kernels, the host rows through none
            launches: dict[str, int] = {}
            for r in rows:
                kind = cli_row_kind(r["name"])
                if kind is None and r["launches"]:
                    raise AssertionError(f"cli host row {r['name']} launched {r['launches']}")
                if kind and not CLI_ROW_KERNELS[kind] <= set(r["launches"]):
                    raise AssertionError(f"cli device row {r['name']} launched only {r['launches']}")
                for k, v in r["launches"].items():
                    launches[k] = launches.get(k, 0) + v
            slowest = sorted(rows, key=lambda r: -r["s"])[:6]
            emit("cli_test", file_bytes=data.size, rows=len(rows), all_ok=True, exit_code=rc, test_s=test_s, launches=launches,
                 slowest_rows={r["name"]: r["s"] for r in slowest},
                 device_row_s={r["name"]: r["s"] for r in rows if cli_row_kind(r["name"])})

            # (d) every row's blob at the cuda tier == the torch tier's, 1 MiB prefix
            head = data[:CLI_COMPARE_BYTES]
            card_rows = cli._build_codecs(cli.parse_args([str(path), "--test"]))
            card_blobs = {c["name"]: c["enc"](head) for c in card_rows}
            cpu_blobs = dict(f.result() for f in cpu_runs)
        differ = [name for name in names if card_blobs[name] != cpu_blobs[name]]
        if differ or len(card_blobs) != 72:
            raise AssertionError(f"cli rows whose cuda-tier blob differs from the torch tier's: {differ}")
        emit("cli_tiers_equal", rows=len(names), bytes=CLI_COMPARE_BYTES, device_rows=sum(map(bool, map(cli_row_kind, names))))

        # (b) the B=12 table, 3 runs, one JSON line a row (--all: every
        #     family, the same 12 rows as --test's at B=12)
        t0 = time.perf_counter()
        rc, rows_b, table = cli_run([str(path), "--all", "--runs", "3", "--hist-min", "12", "--hist-max", "12"])
        (out_dir / "cli_table_B12.txt").write_text(table)
        if rc != 0 or len(rows_b) != 12 or not all(r["ok"] for r in rows_b):
            raise AssertionError(f"cli --runs 3 at B=12: exit {rc}\n{table[-3000:]}")
        for r in rows_b:
            emit("cli_row", bytes=data.size, runs=3, **{k: r[k] for k in (
                "name", "ratio", "encode_MiBps", "decode_max_MiBps", "decode_avg_MiBps", "decode_min_MiBps",
                "decode_sigma_pct")}, launches=r["launches"])
        emit("cli_table", rows=len(rows_b), table_s=time.perf_counter() - t0)

    # (e) the card's busy share under torch.profiler: one 64 MiB tpx decode,
    #     one mt dev round trip (each warmed once, untraced)
    blob = tpx_encode_torch(data, 12, device="cuda")
    if tpx_decode_torch(blob, device="cuda") != data.tobytes():
        raise AssertionError("cli trace: tpx decode does not return the input")
    mt_blob = mt_encode_torch(data, 12, device="cuda")
    if mt_decode_torch(mt_blob, 12, 64, device="cuda") != data.tobytes():
        raise AssertionError("cli trace: the mt dev round trip does not return the input")
    shares = {}
    for name, fn in (("tpx_decode_64MiB", lambda: tpx_decode_torch(blob, device="cuda")),
                     ("mt_dev_round_trip_64MiB",
                      lambda: mt_decode_torch(mt_encode_torch(data, 12, device="cuda"), 12, 64, device="cuda"))):
        with trace(out_dir / "traces") as t:
            back = fn()
        if back != data.tobytes():
            raise AssertionError(f"cli trace {name}: the traced call does not return the input")
        busy = device_busy(t.path)
        shares[name] = {"window_s": t.wall_s, "device_busy_s": busy["busy_us"] / 1e6,
                        "busy_share": busy["busy_us"] / 1e6 / t.wall_s, "kernel_s": busy["kernel_us"] / 1e6,
                        "memcpy_s": busy["gpu_memcpy_us"] / 1e6, "memset_s": busy["gpu_memset_us"] / 1e6,
                        "device_events": busy["events"], "trace_span_s": busy["span_us"] / 1e6,
                        "trace": str(t.path.relative_to(repo))}
        if not busy["events"]:
            raise AssertionError(f"cli trace {name}: torch.profiler recorded no device activity")
    emit("cli_trace", **shares)
    return launches


def main() -> int:
    global CARD, OPS_PER_S
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 1
    repo = Path(__file__).resolve().parent
    sys.path.insert(0, str(repo))
    from hsrans_tpu_torch import banner, tpx_decode_torch, tpx_encode_adaptive_torch, tpx_encode_torch
    from hsrans_tpu_torch.runtime import build
    from tools.gen_inputs import text_like

    CARD = card()
    OPS_PER_S = int32_ops_per_s()
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

    # 1. probe: build the kernels from this checkout's sources and load them,
    #    and the native host codecs (g++) meanwhile
    from concurrent.futures import ThreadPoolExecutor

    from hsrans_tpu_torch.runtime import native

    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as host_build:
        native_built = host_build.submit(timed_s, native.load)
        build.load()
        native_s = native_built.result()[1]
    ptxas = [ln.strip() for ln in build.build_log().splitlines() if "Used" in ln or "entry function" in ln]
    emit("probe", banner=banner(), torch=torch.__version__, cuda=torch.version.cuda,
         build_s=build.build_seconds, load_s=time.perf_counter() - t0, ptxas=ptxas, int32_ops_per_s=OPS_PER_S,
         native_load_s=native_s, native_library=native.library_path().name)

    # 2. each kernel against its plain version on the main path's operands
    #    (64 MiB enwik8-like text, bench.py's seed and size: four 16 MiB megas
    #    at the full 1024-row geometry, one launch), B=12 and B=15
    data = text_like(np.random.default_rng(8), 64 * MIB)
    per_bits = {bits: kernels_vs_plain(bits, data, dev) for bits in (12, 15)}

    # 3. the main path at a size users run: one encode and one decode call
    build.reset_launches()
    blob = tpx_encode_torch(data, 12, device="cuda")
    back = tpx_decode_torch(blob, device="cuda")
    torch.cuda.synchronize()
    launches = {k: build.LAUNCHES[k] for k in ("tpx_decode", "tpx_encode", "tpx_concat", "hist_count", "hist_normalize")}
    if back != data.tobytes():
        raise AssertionError("64 MiB: tpx_decode_torch does not return the input")
    if launches != dict.fromkeys(launches, 1):
        raise AssertionError(f"the main path's launches {launches}: one decode, one encode, one wire writer and one of "
                             "each histogram kernel expected")
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

    # 5b. the decode kernel's ragged reads and window at their edges
    tpx_edge_rows = tpx_window_edges(dev)

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

    # 6b. the histogram kernels against their plain versions (mt encode
    #     (b)'s blocks, the tpx main path's tiles, the planner's largest
    #     block, HIST_EDGES)
    hist_rows, hist_edges, bincount_ms = hist_kernels_vs_plain(data, dev)

    # 7. mt decode: kernel classes, main path, round trips, malformed, times
    mt_rows, mt_launches, ctx = mt_phases(repo, dev)

    # 8. mt decode's annotated route: kernels vs plain and against the rank
    #    kernel, main path, round trips, malformed, both routes end to end
    ann_rows, ann_launches = mt_annotated_phases(dev, ctx)

    # 9. mt encode: kernels vs plain, main path (a) and (b), round trips, times
    enc_rows, enc_launches = mt_encode_phases(repo, dev, ctx)

    # 10. the mt kernels' shared-memory windows at their edges, against the
    #     plain versions
    edge_rows = mt_window_edges(dev)

    # 11. the tpx wire writer and the mt placement at their edges, against
    #     the plain versions, every byte written
    wire_rows = wire_edges(dev)

    # 12. the XLA scan codecs and the device fan-out: the scan kernels
    #     against their plain versions, the raw wire at 64 MiB, the mt chain
    #     and the n=16 round trip at 64 MiB, the split over two devices
    scan_rows, scan_launches = scan_phases(repo, dev, ctx, data, blob)

    # 13. the CLI (`python -m hsrans_tpu_torch.cli`): --test over B 10-15 on
    #     the card, the B=12 table, its kernels, the tiers' blobs, a trace
    cli_launches = cli_phases(repo, data)

    foreign = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "hsrans_tpu"))
    if foreign:
        raise AssertionError(f"the run loaded modules of JAX or of the JAX package: {foreign}")

    print(CARD)
    summary = []
    keys = ("ms", "plain_ms", "bound_ms", "bound_by")
    for name, (source, replaces) in KERNELS.items():
        # each timed at its main path's launch: the 64 MiB B=12 call (tpx),
        # the 64 MiB x-ray n=64 B=12 device_plan blob (mt decode, both
        # routes) and plan (mt encode); the histogram kernels as below
        library_ms = None  # no single PyTorch call runs a rANS state chain or writes the wire's layout
        if name in ("hist_count", "hist_normalize"):
            # the count at mt encode (b)'s 16,384 blocks, the normaliser at the
            # tpx main path's tiles (B=12, which sort); each beside the other
            # path's figures.  The count's library_ms: the segmented
            # torch.bincount; no PyTorch call normalises
            key = "hist_count" if name == "hist_count" else "hist_normalize_B12"
            main, other = (0, 1) if name == "hist_count" else (1, 0)
            paths = {0: ("mt_encode_b", enc_launches["b"][name]), 1: ("tpx_encode", launches[name])}
            fields = (*keys, "launch_ms", "ms_host_paced")
            row = {"launches": paths[main][1], "path": paths[main][0],
                   "max_abs_err": max(r[key]["max_abs_err"] for r in hist_rows + hist_edges),
                   **{k: hist_rows[main][key][k] for k in fields},
                   paths[other][0]: {"launches": paths[other][1], **{k: hist_rows[other][key][k] for k in fields},
                                     **({"library_ms": hist_rows[other][key]["library_ms"]} if main == 0 else {})},
                   "xla_not_pallas": True}
            if name == "hist_count":
                library_ms = hist_rows[0][key]["library_ms"]
                row["library_whole_input_ms"] = bincount_ms  # one torch.bincount of the 64 MiB, one histogram
        elif name in scan_rows:
            # at the n=16 mt round trip of 64 MiB x-ray, the path that launches each once
            row = {"launches": scan_launches["n16"][name], "path": "mt n=16 64 MiB x-ray, 1,024 blocks",
                   **{k: scan_rows[name][k] for k in (*keys, "max_abs_err", "launch_ms", "link_us", "ms_host_paced")},
                   "raw_round_trip_launches": {n: v[name] for n, v in scan_launches["raw"].items()},
                   "bound_note": scan_rows[name]["bound_note"], "xla_not_pallas": True}
        elif name == "mt_decode":
            row = {"launches": mt_launches, "max_abs_err": max(r["max_abs_err"] for r in mt_rows + edge_rows["mt_decode"]),
                   **{k: mt_rows[0][k] for k in (*keys, "launch_ms", "link_us")}}
        elif name in ann_launches:
            edges = edge_rows["mt_decode_annotated"]  # annotate and decode held together on each
            row = {"launches": ann_launches[name],
                   "max_abs_err": max([*(r[name]["max_abs_err"] for r in ann_rows), *(r["max_abs_err"] for r in edges)]),
                   **{k: ann_rows[0][name][k] for k in (*keys, "launch_ms", "link_us") if k in ann_rows[0][name]}}
        elif name in enc_launches["a"]:
            row = {"launches": enc_launches["a"][name], "max_abs_err": max(r[name]["max_abs_err"] for r in enc_rows),
                   **{k: enc_rows[0][name][k] for k in keys}}
            edges = edge_rows["mt_encode"] if name == "mt_encode" else wire_rows["mt_place"]
            row["max_abs_err"] = max([row["max_abs_err"], *(r["max_abs_err"] for r in edges)])
            row |= {k: enc_rows[0][name][k] for k in ("launch_ms", "link_us") if k in enc_rows[0][name]}
        else:
            row = {"launches": launches[name], "max_abs_err": max(per_bits[b][name]["max_abs_err"] for b in per_bits),
                   **{k: per_bits[12][name][k] for k in (*keys, "launch_ms", "link_us") if k in per_bits[12][name]}}
            edges = {"tpx_decode": tpx_edge_rows, "tpx_concat": wire_rows["tpx_concat"]}.get(name, [])
            row["max_abs_err"] = max([row["max_abs_err"], *(r["max_abs_err"] for r in edges)])
        if name in cli_launches:
            row["cli_launches"] = cli_launches[name]  # phase 13 (a): the CLI's --test, every depth
        summary.append({"name": name, "route": "cuda", "source": source, "replaces": replaces, **row,
                        "library_ms": library_ms})
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


START = time.perf_counter()
CARD = ""
OPS_PER_S = 0.0  # int32_ops_per_s() of the card, set by main

if __name__ == "__main__":
    sys.exit(main())
