#!/usr/bin/env python3
"""Launch A/B of the mt and tpx kernels of several source trees, side by
side in one process on the same operands.

    python3 chip_ab.py NAME=DIR [NAME=DIR ...] [--mt-decode | --scan] [--out FILE]

Each DIR holds a copy of the port's package (`DIR/hsrans_tpu_torch/`): this
checkout (`.`), a parent commit unpacked by `git archive`, or a copy whose
kernel sources were edited to try another constant.  Each tree's own
`runtime/build.py` builds that tree's kernel library (all trees at once)
and binds it.  The operands are made by this checkout's Python: the 64 MiB
x-ray `device_plan` blob and plan (a), the 8 MiB x-ray blobs of
`chip_smoke.py`'s kernel phases (the decode: B=10..15 x n=32/64 and a
uniform 16 KiB plan; the encode: its classes), 64 MiB of enwik8-like text in uniform
4 KiB blocks (plan (b)), and the tpx main path's call (the same 64 MiB of
text at B=12 and B=15, four megas in one launch); the decode blobs are
encoded on the card.  A tree whose tpx kernels take another argument list
(one launch a mega, before the one-launch design) runs the mt cases only.
The two histogram kernels are timed on mt encode (b)'s 16,384 blocks, the
tpx main path's 16 tiles (B=12 and B=15) and a 2^25-byte Zipf block; a
tree from before the count's warp path takes its own segment table.
The two wire writers are timed on this checkout's encode outputs: a tree
with the one-launch writers (`hsr_tpx_wire`, `hsr_mt_wire`) writes every
mega's section, or the whole mt blob, in one launch; a tree from before
them runs its concat once a mega (the rectangular streams, which the host
then gathered into the wire) and its placement of the coded parts (the
host then wrote the head and the indicators), and is held against this
checkout's wire by that host step.  On each decode case the annotated
route follows the rank kernel: each tree's annotate, then its annotated
decode of its own annotation, timed with the rank kernel in the same turns
(the route over the rank kernel, per tree).  Every tree's outputs must
equal the plain version's.  Each case times every tree's launch alone
(`chip_smoke.launch_times`: CUDA events over 20 launches queued behind a
spin) in turns, each tree and then back in reverse order, and prints one
JSON line with the card's name and power limit; `--out` also appends the
lines to FILE.  `--mt-decode` runs the decode cases alone.  `--scan` runs
the two scan kernels of `csrc/scan.cu` alone (`run_scan`): the n=16 mt
round trip's calls on 64 MiB of x-ray, step (c) of `mt_decode_device` on the
64 MiB x-ray blob and the raw wire's single chain on 64 MiB of text at
n=64 (one launch a turn), at B=12, and the decodes again at B=15.

    python3 chip_ab.py NAME=DIR [NAME=DIR ...] --e2e REPS [--out FILE]

times the trees' entry points end to end instead: each DIR a whole
checkout (`git archive`), each tree's own package and kernels in a process
of its own, in turns (each tree, then back in reverse order): mt encode
(a) (64 MiB of x-ray, its `device_plan` of 24 KiB blocks, B=12), mt encode
(b) (64 MiB of enwik8-like text, seed 8, uniform 4 KiB blocks, B=12) and
tpx encode (the same text, B=12), REPS calls each by the host's clock
after one warm call, and one more call of each split by layer; then the
tree's histogram wrappers on the histogram kernels' cases, by CUDA events.
The trees' blobs, freqs and cumuls must be equal.

    python3 chip_ab.py NAME=DIR [NAME=DIR ...] --blk32 REPS [--out FILE]

times the trees' native 32blk decoders on the host instead: each tree's
own `runtime/native.py` builds its native library (in a process of its
own, all trees at once), and this process loads every library and calls
each `hsr_blk32_decode` on the CLI table's B=12 rows (64 MiB of
enwik8-like text, seed 8, 16w and 8w, the blobs of this checkout's native
encoder), each call on the same input and output buffers, REPS rounds in
turns (each tree, then back in reverse order); every call must return the
input.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import importlib.util
import json
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

import chip_smoke
from chip_smoke import MIB, MT_CAPS

REPO = Path(__file__).resolve().parent


def load_tree(name: str, root: Path):
    """`root`'s kernel library, built by `root`'s own build.py."""
    spec = importlib.util.spec_from_file_location(f"chip_ab_build_{name}", root / "hsrans_tpu_torch" / "runtime" / "build.py")
    build = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(build)
    return build


def decode_cases(dev: torch.device) -> list[tuple[str, int, int, tuple, int]]:
    """(name, bits, n, kernel operands, output length) of the decode blobs."""
    from hsrans_tpu_torch.kernels import mt_decode as mtd
    from hsrans_tpu_torch.kernels.mt_encode import mt_encode_torch
    from hsrans_tpu_torch.parallel.sharded import device_plan, mt_encode_device, uniform_plan

    xray = np.fromfile(REPO / "tests" / "corpus" / "xray.bin", np.uint8)
    main = np.tile(xray, 8)
    specs = [("x-ray 64 MiB main path", main, 12, 64, device_plan(main, 12, 64, MT_CAPS[12]))]
    # chip_smoke.mt_annotated_phases' 8 MiB blobs: B=10..15 x n=32/64 (B=11 with B=10's cap)
    caps = {b: MT_CAPS.get(b, 16 << 10) for b in range(10, 16)}
    specs += [(f"x-ray n={n} B={b} device_plan {caps[b] >> 10} KiB", xray, b, n, device_plan(xray, b, n, caps[b]))
              for b in caps for n in (32, 64)]
    specs.append(("x-ray n=64 B=12 uniform 16 KiB", xray, 12, 64, uniform_plan(xray, 12, 64, 16 << 10)))
    cases = []
    for name, src, bits, n, plan in specs:
        blob = (mt_encode_torch(src, bits, plan=plan, device=dev) if n == 64
                else mt_encode_device(src, bits, n, plan=plan, device=dev))
        length, stream, blocks, w_counts = mtd.index_blocks(blob, n)
        ops = mtd.device_operands(stream, *mtd.block_operands(length, stream, blocks, w_counts, bits, n), n, dev)
        cases.append((name, bits, n, ops, length))
    return cases


def encode_cases(dev: torch.device) -> list[tuple[str, int, int, str, tuple, tuple]]:
    """(name, bits, n, rule, kernel operands, (plan, kinds, ks, bias)) of
    the encode plans."""
    from hsrans_tpu_torch.kernels import mt_encode as mte
    from hsrans_tpu_torch.parallel.sharded import device_plan
    from tools.gen_inputs import text_like

    xray = np.fromfile(REPO / "tests" / "corpus" / "xray.bin", np.uint8)
    main = np.tile(xray, 8)
    text = text_like(np.random.default_rng(8), 64 * MIB)
    specs = [("x-ray 64 MiB main path (a)", main, device_plan(main, 12, 64, MT_CAPS[12]), 12, 64, "groups")]
    specs += [(f"x-ray n={n} B={b} device_plan {MT_CAPS[b] >> 10} KiB", xray, device_plan(xray, b, n, MT_CAPS[b]), b, n,
               "groups" if n == 64 else "section") for b, n in ((12, 64), (15, 64), (12, 32))]
    specs.append(("x-ray n=64 B=12 uniform 4 KiB", xray, mte.uniform_rows(xray.size, 4096), 12, 64, "groups"))
    specs.append(("text 64 MiB main path (b)", text, mte.uniform_rows(text.size, 4096), 12, 64, "groups"))
    cases = []
    for name, src, plan, bits, n, rule in specs:
        kinds, ks, index, freqs, bias = mte.plan_operands(src, plan, bits, n, rule)
        cases.append((name, bits, n, rule, tuple(torch.from_numpy(a).to(dev) for a in (src, index, freqs.view(np.int16))),
                      (plan, kinds, ks, bias)))
    return cases


def tpx_cases(dev: torch.device) -> list[tuple[int, tuple, tuple, np.ndarray]]:
    """(bits, encode operands, decode operands and keywords, wire freqs) of
    the tpx main path's call at B=12 and B=15."""
    from hsrans_tpu_torch import tpx_encode_torch
    from hsrans_tpu_torch.kernels import tpx_encode as enc
    from hsrans_tpu_torch.ops.tpx import TpxParams, _mega_layout
    from tools.gen_inputs import text_like

    data = text_like(np.random.default_rng(8), 64 * MIB)
    cases = []
    for bits in (12, 15):
        p = TpxParams(bits=bits)
        geoms = [(base, p.rows, p.steps, n_tiles, valid) for base, n_tiles, valid in _mega_layout(data.size, p)]
        data_t = torch.from_numpy(data).to(dev)
        desc, freqs_t, *tabs = enc.mega_operands(data_t, geoms, bits=bits)
        cases.append((bits, (data_t, desc, *tabs), chip_smoke.tpx_decode_args(tpx_encode_torch(data, bits, device=dev), dev),
                      freqs_t.cpu().numpy().view(np.uint16)))
    return cases


def in_turns(launches: dict, max_groups: int) -> dict:
    """Each tree's launch timed once, then again in reverse order."""
    turns: dict[str, list[float]] = {k: [] for k in launches}
    for k in [*launches, *reversed(launches)]:
        turns[k].append(chip_smoke.launch_times(launches[k], max_groups)["launch_ms"])
    ms = {k: statistics.mean(t) for k, t in turns.items()}
    return {"max_groups": max_groups, "launch_ms": ms, "turns": turns,
            "link_us": {k: t * 1e3 / max_groups for k, t in ms.items()}}


def run_tpx(libs: dict, dev: torch.device, sink) -> None:
    """The tpx encode and decode kernels of the trees with the one-launch
    argument list, on the main path's call."""
    from hsrans_tpu_torch.kernels import tpx_decode as dec
    from hsrans_tpu_torch.kernels import tpx_encode as enc

    all_libs = libs
    libs = {k: lib for k, lib in libs.items() if lib.hsr_tpx_decode.argtypes[1] is ctypes.c_longlong}
    cs = torch.cuda.current_stream(dev).cuda_stream
    links = 4 * 32  # a row's chain: 4 tiles x 32 steps
    for bits, (data, desc, *tabs), ((blob, ddesc, *dops), kw), freqs in tpx_cases(dev):
        desc_t, ddesc_t, ctas = torch.from_numpy(desc).to(dev), torch.from_numpy(ddesc).to(dev), enc.ctas_of(desc)
        eouts = {k: tuple(torch.empty_like(t) for t in enc.encode_mega_cuda(data, desc, *tabs, bits=bits)) for k in libs}
        douts = {k: torch.zeros(kw["out_len"], dtype=torch.uint8, device=dev) for k in libs}

        def encode(k: str) -> None:
            rc = libs[k].hsr_tpx_encode(data.data_ptr(), desc_t.data_ptr(), len(desc), ctas, *(t.data_ptr() for t in tabs),
                                        *(t.data_ptr() for t in eouts[k]), bits, cs)
            if rc:
                raise RuntimeError(f"{k} tpx encode: CUDA error {rc}")

        def decode(k: str) -> None:
            rc = libs[k].hsr_tpx_decode(blob.data_ptr(), blob.numel(), ddesc_t.data_ptr(), len(ddesc), ctas,
                                        *(t.data_ptr() for t in dops), douts[k].data_ptr(), bits, cs)
            if rc:
                raise RuntimeError(f"{k} tpx decode: CUDA error {rc}")

        for k in libs:
            encode(k)
            decode(k)
        torch.cuda.synchronize()
        want_enc = enc.encode_mega_plain(data, desc, *tabs, bits=bits)
        want_dec = dec.decode_mega_plain(blob, ddesc, *dops, **kw)
        for k in libs:
            if chip_smoke.max_abs_err(eouts[k], want_enc) or chip_smoke.max_abs_err(douts[k], want_dec):
                raise AssertionError(f"{k} tpx, B={bits}: differs from the plain version")
        for name, fn in (("tpx_encode", encode), ("tpx_decode", decode)):
            sink({"kernel": name, "case": "text 64 MiB main path", "bits": bits, "megas": len(desc),
                  **in_turns({k: (lambda k=k: fn(k)) for k in libs}, links)})
        run_tpx_wire(all_libs, enc.encode_mega_cuda(data, desc, *tabs, bits=bits), desc, freqs, bits, dev, sink)


def run_tpx_wire(libs: dict, outs: tuple, desc: np.ndarray, freqs: np.ndarray, bits: int, dev: torch.device,
                 sink) -> None:
    """The tpx wire writer of each tree on this checkout's encode outputs:
    one launch of `hsr_tpx_wire`, or a tree's concat once a mega, whose
    rectangular streams the host then gathered (`ops/tpx.py::_write_mega`)
    into the same sections."""
    from hsrans_tpu_torch.kernels import tpx_encode as enc
    from hsrans_tpu_torch.ops.tpx import _write_mega

    cs = torch.cuda.current_stream(dev).cuda_stream
    head = chip_smoke.HEAD_U16
    views = enc.mega_views(*outs, desc)
    row_words = torch.cat([c.sum(dim=2).reshape(-1) for _, c, _ in views]).cpu().numpy()
    wdesc, row_at, out_u16 = enc.wire_layout(desc, row_words, v3=False, base=head)
    freqs_t = torch.from_numpy(freqs.view(np.int16)).to(dev)
    want = enc.write_wire_plain(*outs, freqs_t, wdesc, row_at, v3=False, out_u16=out_u16)
    wdesc_t, row_at_t = torch.from_numpy(wdesc).to(dev), torch.from_numpy(row_at).to(dev)
    w_slots = wdesc[:, enc.WIRE_FIELDS.index("w_slots")].tolist()
    rects = {k: [torch.empty((t, r, w), dtype=torch.int32, device=dev) for (t, r), w in
                 zip(desc[:, [3, 1]].tolist(), w_slots)] for k in libs}
    wires = {k: torch.empty(out_u16, dtype=torch.int16, device=dev) for k in libs}

    def write(k: str) -> None:
        lib = libs[k]
        if hasattr(lib, "hsr_tpx_wire"):
            rc = lib.hsr_tpx_wire(*(t.data_ptr() for t in outs), freqs_t.data_ptr(), wdesc_t.data_ptr(), len(wdesc),
                                  enc.wire_ctas(wdesc), row_at_t.data_ptr(), wires[k].data_ptr(), out_u16, 0, cs)
        else:
            for (win, cnt, _), rect, (_, rows, steps, n_tiles, *_) in zip(views, rects[k], desc.tolist()):
                rc = lib.hsr_tpx_concat(win.data_ptr(), cnt.data_ptr(), rect.data_ptr(), rows, steps, n_tiles,
                                        rect.shape[2], cs)
                if rc:
                    break
        if rc:
            raise RuntimeError(f"{k} tpx wire: CUDA error {rc}")

    for k in libs:
        write(k)
    torch.cuda.synchronize()
    for k, lib in libs.items():
        if hasattr(lib, "hsr_tpx_wire"):
            got = wires[k].view(torch.uint8)[2 * head :].cpu().numpy().tobytes()
        else:
            sections = bytearray()
            for (_, c, st), rect, (_, _, _, n_tiles, _, tab0, *_) in zip(views, rects[k], desc.tolist()):
                _write_mega(sections, n_tiles, rect.shape[2], st.cpu().numpy().view(np.uint32), freqs[tab0 : tab0 + n_tiles],
                            c.sum(dim=2).cpu().numpy().astype(np.uint16), rect.cpu().numpy().view(np.uint32))
            got = bytes(sections)
        if got != want[2 * head :].cpu().numpy().tobytes():
            raise AssertionError(f"{k} tpx wire, B={bits}: differs from the plain version")
    sink({"kernel": "tpx_concat", "case": "text 64 MiB main path", "bits": bits, "megas": len(desc),
          "launches": {k: 1 if hasattr(lib, "hsr_tpx_wire") else len(desc) for k, lib in libs.items()},
          **in_turns({k: (lambda k=k: write(k)) for k in libs}, 1)})


def checked(name: str, rc: int) -> None:
    if rc:
        raise RuntimeError(f"{name}: CUDA error {rc}")


def run_mt_decode(libs: dict, dev: torch.device, sink) -> None:
    """The mt decode kernels of each tree on decode_cases: the rank kernel,
    then the annotated route (each tree's annotate, then its annotated
    decode of its own annotation) timed with the rank kernel in the same
    turns."""
    from hsrans_tpu_torch.kernels import mt_decode as mtd

    cs = torch.cuda.current_stream(dev).cuda_stream
    for name, bits, n, ops, length in decode_cases(dev):
        stream, index, states, fc = ops
        nb = index.shape[0]
        outs = {k: (torch.zeros(length, dtype=torch.uint8, device=dev), torch.empty((nb, n), dtype=torch.int32, device=dev),
                    torch.empty(nb, dtype=torch.int64, device=dev)) for k in libs}

        def decode(k: str) -> None:
            out, fin, cursor = outs[k]
            checked(k, libs[k].hsr_mt_decode(stream.data_ptr(), index.data_ptr(), states.data_ptr(), fc.data_ptr(),
                                             out.data_ptr(), fin.data_ptr(), cursor.data_ptr(), nb, n, bits,
                                             stream.numel() // 2, length, cs))

        for k in libs:
            decode(k)
        torch.cuda.synchronize()
        want = mtd.decode_blocks_plain(*ops, bits=bits, n=n, length=length)
        for k in libs:
            if chip_smoke.max_abs_err(outs[k], want):
                raise AssertionError(f"{k} mt decode, {name}: differs from the plain version")
        max_groups = int(index[:, 4].max())
        sink({"kernel": "mt_decode", "case": name, "bits": bits, "n": n, "blocks": nb,
              **in_turns({k: (lambda k=k: decode(k)) for k in libs}, max_groups)})

        nwords = stream.numel() // 2
        anns = {k: torch.empty(nwords, dtype=torch.int32, device=dev) for k in libs}

        def annotate(k: str) -> None:
            checked(k, libs[k].hsr_mt_annotate(stream.data_ptr(), index.data_ptr(), fc.data_ptr(), anns[k].data_ptr(),
                                               nb, bits, nwords, cs))

        def decode_annotated(k: str) -> None:
            out, fin, cursor = outs[k]
            checked(k, libs[k].hsr_mt_decode_annotated(anns[k].data_ptr(), index.data_ptr(), states.data_ptr(),
                                                       fc.data_ptr(), out.data_ptr(), fin.data_ptr(), cursor.data_ptr(),
                                                       nb, n, bits, nwords, length, cs))

        for k in libs:
            outs[k][0].zero_()
            annotate(k)
            decode_annotated(k)
        torch.cuda.synchronize()
        want_ann = mtd.annotate_plain(stream, index, fc, bits=bits)
        want_dec = mtd.decode_blocks_annotated_plain(want_ann, index, states, fc, bits=bits, n=n, length=length)
        for k in libs:
            if chip_smoke.max_abs_err(anns[k], want_ann) or chip_smoke.max_abs_err(outs[k], want_dec):
                raise AssertionError(f"{k} mt annotated route, {name}: differs from the plain version")
        fns = {}
        for k in libs:
            fns[f"{k} rank"] = lambda k=k: decode(k)
            fns[f"{k} annotate"] = lambda k=k: annotate(k)
            fns[f"{k} annotated"] = lambda k=k: decode_annotated(k)
        timed = in_turns(fns, max_groups)
        ms = timed["launch_ms"]
        sink({"kernel": "mt_annotated_route", "case": name, "bits": bits, "n": n, "blocks": nb, **timed,
              "annotated_over_rank": {k: ms[f"{k} annotated"] / ms[f"{k} rank"] for k in libs},
              "route_over_rank": {k: (ms[f"{k} annotate"] + ms[f"{k} annotated"]) / ms[f"{k} rank"] for k in libs}})


def run(libs: dict, dev: torch.device, sink) -> None:
    from hsrans_tpu_torch.kernels import mt_encode as mte

    cs = torch.cuda.current_stream(dev).cuda_stream
    run_mt_decode(libs, dev, sink)
    magic = mte.magic_tensor(dev)
    for name, bits, n, rule, (data, index, freqs), layout in encode_cases(dev):
        nb, cap = index.shape[0], int(index[-1, 4])
        outs = {k: (torch.zeros(cap, dtype=torch.int16, device=dev), torch.empty(nb, dtype=torch.int64, device=dev),
                    torch.empty((nb, n), dtype=torch.int32, device=dev)) for k in libs}

        def encode(k: str) -> None:
            words, count, fin = outs[k]
            fn = libs[k].hsr_mt_encode
            # a tree from before the magic table takes one pointer less
            mg = (magic.data_ptr(),) if len(fn.argtypes) == 14 else ()
            checked(k, fn(data.data_ptr(), index.data_ptr(), freqs.data_ptr(), *mg, words.data_ptr(), fin.data_ptr(),
                          count.data_ptr(), nb, n, bits, int(rule == "groups"), data.numel(), cap, cs))

        for k in libs:
            encode(k)
        torch.cuda.synchronize()
        want = mte.encode_blocks_plain(data, index, freqs, bits=bits, n=n, rule=rule, words_cap=cap)
        for k in libs:
            words, count, fin = outs[k]
            got = (count, fin, mte.emitted_words(words, index, count))
            if chip_smoke.max_abs_err(got, (want[1], want[2], mte.emitted_words(want[0], index, want[1]))):
                raise AssertionError(f"{k} mt encode, {name}: differs from the plain version")
        sink({"kernel": "mt_encode", "case": name, "bits": bits, "n": n, "rule": rule, "blocks": nb,
              **in_turns({k: (lambda k=k: encode(k)) for k in libs}, int(index[:, 1].max()))})
        run_mt_place(libs, name, want, index, freqs, layout, n, data.numel(), dev, sink)


def run_mt_place(libs: dict, name: str, outs: tuple, index: torch.Tensor, freqs: torch.Tensor, layout: tuple, n: int,
                 length: int, dev: torch.device, sink) -> None:
    """The mt placement of each tree on the encode's outputs `outs`: one
    launch of `hsr_mt_wire` writing the whole blob, or a tree's placement
    of the coded parts alone, the head and indicators then written as its
    host wrote them."""
    from hsrans_tpu_torch.kernels import mt_encode as mte

    cs = torch.cuda.current_stream(dev).cuda_stream
    words, count, fin = outs
    plan, kinds, ks, bias = layout
    place, out_u16 = mte.part_layout(plan, kinds, ks, bias, count.cpu().numpy(), n, length)
    coded = place[:, 2] >= 0
    old_place = torch.from_numpy(np.ascontiguousarray(place[coded][:, [0, 1, 3]])).to(dev)
    place_t = torch.from_numpy(place).to(dev)
    want = mte.place_blocks_plain(words, index, count, fin, freqs, place_t, n=n, out_u16=out_u16)
    blobs = {k: torch.zeros(out_u16, dtype=torch.int16, device=dev) for k in libs}
    nb = index.shape[0]

    def write(k: str) -> None:
        lib = libs[k]
        if hasattr(lib, "hsr_mt_wire"):
            rc = lib.hsr_mt_wire(words.data_ptr(), index.data_ptr(), count.data_ptr(), fin.data_ptr(), freqs.data_ptr(),
                                 nb, place_t.data_ptr(), len(place), blobs[k].data_ptr(), n, words.numel(), out_u16, cs)
        else:
            rc = lib.hsr_mt_place(words.data_ptr(), index.data_ptr(), count.data_ptr(), fin.data_ptr(), freqs.data_ptr(),
                                  old_place.data_ptr(), blobs[k].data_ptr(), nb, n, words.numel(), out_u16, cs)
        if rc:
            raise RuntimeError(f"{k} mt place, {name}: CUDA error {rc}")

    for k in libs:
        write(k)
    torch.cuda.synchronize()
    literal = torch.from_numpy(2 * place[~coded][:, :1] + np.arange(8)).to(dev).reshape(-1)
    for k, lib in libs.items():
        got = blobs[k].view(torch.uint8)
        if not hasattr(lib, "hsr_mt_wire"):
            got[literal] = want[literal]  # the head and indicators, which that tree's host wrote
        if not torch.equal(got, want):
            raise AssertionError(f"{k} mt place, {name}: differs from the plain version")
    sink({"kernel": "mt_place", "case": name, "n": n, "blocks": nb, "parts": len(place),
          **in_turns({k: (lambda k=k: write(k)) for k in libs}, 1)})


def hist_cases(dev: torch.device) -> list[tuple[str, torch.Tensor, np.ndarray, np.ndarray, tuple[int, ...]]]:
    """(name, input on the card, segment starts and ends, depths) of the
    histogram kernels' cases: mt encode (b)'s 16,384 blocks of 4 KiB of the
    64 MiB text, the tpx main path's 16 tiles of it (B=12 and B=15), and
    `chip_smoke.zipf_input`'s first 2^25 bytes as one segment (the reference
    planner's block size on that input, without its plan)."""
    from hsrans_tpu_torch.kernels import tpx_encode as enc
    from hsrans_tpu_torch.ops.tpx import TpxParams, _mega_layout
    from tools.gen_inputs import text_like

    text = text_like(np.random.default_rng(8), 64 * MIB)
    p = TpxParams()
    _, tstarts, tends = enc.mega_segments([(b, p.rows, p.steps, n, v) for b, n, v in _mega_layout(text.size, p)])
    mstarts = np.arange(0, text.size, 4096, dtype=np.int64)
    zipf = 1.0 / np.arange(1, 257)
    block = np.random.default_rng(8).choice(256, size=64 * MIB, p=zipf / zipf.sum()).astype(np.uint8)[: 1 << 25]
    text_t = torch.from_numpy(text).to(dev)
    return [("mt encode (b): 16,384 blocks of 4 KiB", text_t, mstarts, mstarts + 4096, (12,)),
            ("tpx main path: 16 tiles", text_t, tstarts, tends, (12, 15)),
            ("a 2^25-byte Zipf block", torch.from_numpy(block).to(dev), np.array([0]), np.array([block.size]), (12,))]


def run_hist(libs: dict, dev: torch.device, sink) -> None:
    """The two histogram kernels of each tree that has them, launch alone,
    on hist_cases' operands: a tree from before the count's warp path
    takes rows (start, end, first chunk) of 64 KiB chunks and counts zeroed
    where a segment has several; every tree's counts, freqs and cumuls must
    equal this checkout's plain versions."""
    from hsrans_tpu_torch.models import device_hist as dh

    libs = {k: lib for k, lib in libs.items() if hasattr(lib, "hsr_hist_count")}
    cs = torch.cuda.current_stream(dev).cuda_stream
    for name, data, starts, ends, bits_list in hist_cases(dev):
        k = len(starts)
        want = dh.observe_segments_plain(data, starts, ends)
        table, n_short, chunks = dh.segment_table(starts, ends)
        old_chunks = np.maximum(-(-dh.segment_sizes(starts, ends) // dh.COUNT_CHUNK), 1)
        old = np.stack([starts, np.maximum(ends, starts), np.cumsum(old_chunks) - old_chunks], axis=1)
        table_t, old_t = torch.from_numpy(table).to(dev), torch.from_numpy(np.ascontiguousarray(old)).to(dev)
        counts = {t: torch.zeros((k, 256), dtype=torch.int32, device=dev) for t in libs}

        def count(t: str) -> None:
            fn = libs[t].hsr_hist_count
            if len(fn.argtypes) == 7:
                rc = fn(data.data_ptr(), old_t.data_ptr(), k, int(old_chunks.sum()), dh.COUNT_CHUNK, counts[t].data_ptr(), cs)
            else:
                rc = fn(data.data_ptr(), table_t.data_ptr(), n_short, k - n_short, chunks, dh.COUNT_CHUNK,
                        counts[t].data_ptr(), cs)
            if rc:
                raise RuntimeError(f"{t} hist count: CUDA error {rc}")

        for t in libs:
            count(t)
        torch.cuda.synchronize()
        for t in libs:
            if not torch.equal(counts[t], want):
                raise AssertionError(f"{t} hist count, {name}: differs from the plain version")
        sink({"kernel": "hist_count", "case": name, "segments": k, "warp_segments": n_short, "chunks": chunks,
              **in_turns({t: (lambda t=t: count(t)) for t in libs}, 1)})
        div_t = torch.from_numpy(dh.segment_divisors(starts, ends)).to(dev)
        for bits in bits_list:
            outs = {t: (torch.empty_like(want, dtype=torch.int16), torch.empty_like(want, dtype=torch.int16)) for t in libs}

            def normalize(t: str) -> None:
                rc = libs[t].hsr_hist_normalize(want.data_ptr(), div_t.data_ptr(), k, bits, *(o.data_ptr() for o in outs[t]),
                                                cs)
                if rc:
                    raise RuntimeError(f"{t} hist normalize: CUDA error {rc}")

            for t in libs:
                normalize(t)
            torch.cuda.synchronize()
            ref = dh.normalize_rows_plain(want, div_t, bits)
            for t in libs:
                if chip_smoke.max_abs_err(outs[t], ref):
                    raise AssertionError(f"{t} hist normalize, {name}, B={bits}: differs from the plain version")
            fixed = int((dh.round_rows(want, div_t, bits).sum(dim=1) != 1 << bits).sum())
            sink({"kernel": "hist_normalize", "case": name, "bits": bits, "rows": k, "rows_fixed": fixed,
                  **in_turns({t: (lambda t=t: normalize(t)) for t in libs}, 1)})


def scan_cases(dev: torch.device) -> list[tuple[str, str, tuple, dict]]:
    """(name, "decode" | "encode", kernel operands, keywords) of the scan
    kernels' calls: the n=16 mt round trip on 64 MiB of x-ray in uniform 64
    KiB blocks (1,024 streams x 4,096 groups, per-stream tables), step (c)
    of mt_decode_device on the 64 MiB x-ray device_plan blob (2,472 streams,
    n=64), and the raw wire's single chain on 64 MiB of enwik8-like text at
    n=64 (seed 8), all at B=12; then the decodes of the n=16 call and the
    raw chain at B=15 (the largest tables the decode stages in shared
    memory: 160 KiB a stream)."""
    from hsrans_tpu_torch import raw_encode_torch
    from hsrans_tpu_torch.kernels.mt_encode import mt_encode_torch, plan_freqs, plan_rows, scan_operands
    from hsrans_tpu_torch.models.histogram import normalize_hist, observe_hist
    from hsrans_tpu_torch.ops.mt import block_index
    from hsrans_tpu_torch.ops.raw_scan import raw_host_operands, raw_parse
    from hsrans_tpu_torch.parallel import sharded as psh
    from hsrans_tpu_torch.rans import DECODE_CONSUME_POINT_16, IDX2IDX
    from hsrans_tpu_torch.runtime.device import to_card
    from tools.gen_inputs import text_like

    def mt_decode_case(name: str, blob: bytes, bits: int, n: int) -> tuple:
        _, stream, blocks = block_index(blob, n)
        bb = psh.gather_blocks(blocks, bits, n)
        return (name, "decode", psh.batch_operands(bb, stream, slice(None), dev),
                {"bits": bits, "num_steps": bb.max_steps, "tail": True})

    xray = np.tile(np.fromfile(REPO / "tests" / "corpus" / "xray.bin", np.uint8), 8)
    text = text_like(np.random.default_rng(8), 64 * MIB)
    data_t = torch.from_numpy(xray).to(dev)
    n = 64
    total = -(-text.size // n)
    perm = torch.from_numpy(IDX2IDX[n]).to(dev)
    padded = torch.zeros(total * n, dtype=torch.uint8, device=dev)
    padded[: text.size] = torch.from_numpy(text).to(dev)
    valid = torch.arange(total, device=dev)[:, None] * n + perm[None, :] < text.size
    cases = []
    for bits in (12, 15):
        plan16 = psh.uniform_plan(xray, bits, 16, 64 << 10)
        mt16 = f"mt n=16 x-ray 64 MiB, 64 KiB blocks, B={bits}"
        hist = normalize_hist(observe_hist(text), text.size, bits)
        raw = f"raw x64 64 MiB text, one chain, B={bits}"
        if bits == 12:
            _, ks, index, given, freqs, _ = plan_rows(xray, plan16, bits, 16, "section")
            freqs_t = plan_freqs(data_t, ks, index, given, freqs, bits, 16)
            *eops, esteps = scan_operands(data_t, torch.from_numpy(index).to(dev), freqs_t, 16)
            cases.append((mt16, "encode", tuple(eops), {"bits": bits, "num_steps": esteps}))
        cases.append(mt_decode_case(mt16, psh.mt_encode_device(xray, bits, 16, plan=plan16, device=dev), bits, 16))
        if bits == 12:
            main = mt_encode_torch(xray, bits, plan=psh.device_plan(xray, bits, 64, MT_CAPS[bits]), device=dev)
            cases.append(mt_decode_case(f"step (c), x-ray 64 MiB device_plan 24 KiB, B={bits}", main, bits, 64))
            cases.append((raw, "encode",
                          (torch.full((1, n), DECODE_CONSUME_POINT_16, dtype=torch.int32, device=dev),
                           padded.view(total, n)[:, perm][None].contiguous(), valid[None].contiguous(),
                           torch.from_numpy(hist.symbol_count.astype(np.uint16).view(np.int16)).to(dev),
                           torch.from_numpy(hist.cumul.astype(np.uint16).view(np.int16)).to(dev)),
                          {"bits": bits, "num_steps": total}))
        blob = raw_encode_torch(text, hist, n, device=dev)
        cases.append((raw, "decode", tuple(to_card(a, dev) for a in raw_host_operands(*raw_parse(blob, bits, n), n)),
                      {"bits": bits, "num_steps": total, "tail": True, "input": text}))
    return cases


def run_scan(libs: dict, dev: torch.device, sink) -> None:
    """Each tree's scan decode and encode launch alone, in turns, on
    scan_cases' operands: the mt calls by launch_times (20 launches queued
    ahead, each tree then back), the raw chain one launch a turn.  Every
    tree's outputs equal the plain version's (mt calls), or the first
    tree's, and the raw decode the input (the raw chain, a million steps
    of the plain version's Python loop).  A tree whose encode takes the magic table (16 arguments)
    gets this checkout's."""
    from hsrans_tpu_torch.kernels import scan
    from hsrans_tpu_torch.rans import INV_IDX2IDX

    cs = torch.cuda.current_stream(dev).cuda_stream
    magic = scan.magic_tensor(dev)
    for name, kind, args, kw in scan_cases(dev):
        kw = dict(kw)
        want_input = kw.pop("input", None)
        nb, n = args[0].shape
        steps = kw["num_steps"]
        if kind == "decode":
            (sym, freq, cum), tab_stride = scan._shared_or_rows("chip_ab", args[3:6], nb)
            states, stream, read_pos, valid = args[0], args[1], args[2], args[6]
            w = stream.shape[-1]
            outs = {k: (torch.empty((nb, steps, n), dtype=torch.uint8, device=dev),
                        torch.empty((nb, n), dtype=torch.int32, device=dev),
                        torch.empty(nb, dtype=torch.int32, device=dev)) for k in libs}

            def launch(k: str) -> None:
                checked(k, libs[k].hsr_scan_decode(
                    states.data_ptr(), stream.data_ptr(), w if stream.dim() == 2 else 0, w, read_pos.data_ptr(),
                    sym.data_ptr(), freq.data_ptr(), cum.data_ptr(), tab_stride, sym.shape[-1], valid.data_ptr(),
                    *(t.data_ptr() for t in outs[k]), nb, n, kw["bits"], steps, int(kw["tail"]), cs))
        else:
            (freq, cum), tab_stride = scan._shared_or_rows("chip_ab", args[3:5], nb)
            states, gb, valid = args[0], args[1], args[2]
            outs = {k: (torch.empty((nb, steps, n), dtype=torch.int16, device=dev),
                        torch.empty((nb, steps, n), dtype=torch.bool, device=dev),
                        torch.empty((nb, n), dtype=torch.int32, device=dev)) for k in libs}

            def launch(k: str) -> None:
                extra = (magic.data_ptr(),) if len(libs[k].hsr_scan_encode.argtypes) == 16 else ()
                checked(k, libs[k].hsr_scan_encode(
                    states.data_ptr(), gb.data_ptr(), valid.data_ptr(), freq.data_ptr(), cum.data_ptr(), tab_stride,
                    *(t.data_ptr() for t in outs[k]), nb, n, kw["bits"], scan.encode_emit_point_16(kw["bits"]) & 0xFFFFFFFF,
                    steps, *extra, cs))

        for k in libs:
            launch(k)
        torch.cuda.synchronize()
        first = next(iter(libs))
        chain = nb == 1  # the raw wire's single chain
        if not chain:
            plain = scan.decode_section_plain if kind == "decode" else scan.encode_section_plain
            want = plain(*args, **kw)
        else:
            want = outs[first]
            if want_input is not None:
                got = want[0][0][:, torch.from_numpy(INV_IDX2IDX[n]).to(dev)].reshape(-1)[: want_input.size]
                if not torch.equal(got, torch.from_numpy(want_input).to(dev)):
                    raise AssertionError(f"{first} {name}: the raw decode does not return the input")
        for k in libs:
            if chip_smoke.max_abs_err(outs[k], want):
                raise AssertionError(f"{k} scan {kind}, {name}: differs from the plain version or the first tree")
        row = {"kernel": f"scan_{kind}", "case": name, "streams": nb, "lanes": n, "steps": steps,
               "tab_stride": tab_stride}
        if not chain:
            sink({**row, **in_turns({k: (lambda k=k: launch(k)) for k in libs}, steps)})
        else:  # one chain of seconds: one launch a turn
            turns = {k: [] for k in libs}
            for k in [*libs, *reversed(libs)]:
                turns[k].append(chip_smoke.once_ms(lambda: launch(k)))
            ms = {k: statistics.mean(t) for k, t in turns.items()}
            sink({**row, "max_groups": steps, "launch_ms": ms, "turns": turns,
                  "link_us": {k: t * 1e3 / steps for k, t in ms.items()}})


def hist_wrappers(dev: torch.device) -> dict:
    """This process's tree's histogram wrappers on hist_cases' operands, by
    CUDA events over 20 calls, queued ahead (`ms`: a burst of calls in
    flight, each with its own pinned table) and host-paced (each call after
    the last has finished, as the encoders call them): the count alone
    (`observe_segments_cuda`), the normaliser alone (`normalize_rows_cuda`,
    which checks its divisors on the card) and `segment_hists` (both, as
    the encoders call them), with a digest of the freqs and cumuls."""
    from hsrans_tpu_torch.models import device_hist as dh

    def timed(fn) -> dict:
        return {"ms": chip_smoke.cuda_ms(fn, 20, queue_ahead=True), "host_paced_ms": chip_smoke.cuda_ms(fn, 20)}

    out = {}
    for name, data, starts, ends, bits_list in hist_cases(dev):
        counts = dh.observe_segments_cuda(data, starts, ends)
        div_t = torch.from_numpy(dh.segment_divisors(starts, ends)).to(dev)
        row = {"count": timed(lambda: dh.observe_segments_cuda(data, starts, ends))}
        for bits in bits_list:
            row[f"normalize_B{bits}"] = timed(lambda: dh.normalize_rows_cuda(counts, div_t, bits))
            row[f"segment_hists_B{bits}"] = timed(lambda: dh.segment_hists(data, starts, ends, bits))
            freq, cumul = dh.segment_hists(data, starts, ends, bits)
            row[f"B{bits}_sha256"] = hashlib.sha256(torch.cat([freq, cumul]).cpu().numpy().tobytes()).hexdigest()
        out[name] = row
    return out


def e2e_worker(root: Path, reps: int) -> dict:
    """One tree's end-to-end times in this process, its package imported
    from `root` (see the module's doc)."""
    sys.path.insert(0, str(root))
    import hsrans_tpu_torch
    from hsrans_tpu_torch import mt_encode_torch, tpx_encode_torch
    from hsrans_tpu_torch.parallel.sharded import device_plan
    from tools.gen_inputs import text_like

    if not Path(hsrans_tpu_torch.__file__).resolve().is_relative_to(root):
        raise AssertionError(f"{hsrans_tpu_torch.__file__} is not {root}'s package")
    data = text_like(np.random.default_rng(8), 64 * MIB)
    xray = np.tile(np.fromfile(REPO / "tests" / "corpus" / "xray.bin", np.uint8), 8)
    plan = device_plan(xray, 12, 64, MT_CAPS[12])
    paths = {"mt_encode_a": (xray.size, lambda **kw: mt_encode_torch(xray, 12, plan=plan, device="cuda", **kw)),
             "mt_encode_b": (data.size, lambda **kw: mt_encode_torch(data, 12, device="cuda", **kw)),
             "tpx_encode": (data.size, lambda **kw: tpx_encode_torch(data, 12, device="cuda", **kw))}
    res = {}
    for name, (size, fn) in paths.items():
        blob = fn()  # builds the kernels and warms the path
        secs = chip_smoke.host_s(fn, reps)
        layers = {}
        fn(layers=layers)
        res[name] = {"s": secs, "MiBps": size / MIB / statistics.median(secs), "layers": layers,
                     "blob_sha256": hashlib.sha256(blob).hexdigest()}
    res["hist_wrappers"] = hist_wrappers(torch.device("cuda", 0))
    return res


def end_to_end(trees: dict[str, str], reps: int, sink) -> None:
    """Each tree's e2e_worker in a process of its own, in turns; fails if
    a tree's blobs differ from the first tree's."""
    blobs = {}
    for k in [*trees, *reversed(trees)]:
        r = subprocess.run([sys.executable, str(REPO / "chip_ab.py"), f"{k}={trees[k]}", "--e2e", str(reps), "--worker"],
                           capture_output=True, text=True, check=False)
        if r.returncode:
            raise RuntimeError(f"{k}: exit {r.returncode}: {r.stderr[-3000:]}")
        res = json.loads(r.stdout.strip().splitlines()[-1])
        blobs.setdefault(k, {p: v["blob_sha256"] for p, v in res.items() if p != "hist_wrappers"}
                         | {(c, b): v[b] for c, v in res["hist_wrappers"].items() for b in v if b.endswith("sha256")})
        sink({"phase": "end_to_end", "tree": k, **res})
    first = next(iter(blobs.values()))
    if any(b != first for b in blobs.values()):
        raise AssertionError(f"the trees' blobs differ: {blobs}")


def blk32_library(root: Path) -> str:
    """The path of `root`'s native library, built by `root`'s own loader."""
    code = "import sys; sys.path.insert(0, sys.argv[1]); from hsrans_tpu_torch.runtime import native; " \
           "native.load(); print(native.library_path())"
    r = subprocess.run([sys.executable, "-c", code, str(root)], capture_output=True, text=True, check=False, cwd=root)
    if r.returncode:
        raise RuntimeError(f"{root}: native build failed: {r.stderr[-3000:]}")
    return r.stdout.strip().splitlines()[-1]


def run_blk32(trees: dict[str, str], reps: int, sink) -> None:
    """Each tree's native 32blk decode in turns (see the module's doc)."""
    import time

    from hsrans_tpu_torch.ops.blk32 import blk32_encode_host
    from tools.gen_inputs import text_like

    with ThreadPoolExecutor(len(trees)) as pool:
        paths = dict(zip(trees, pool.map(lambda d: blk32_library(Path(d).resolve()), trees.values())))
    u8p = ctypes.POINTER(ctypes.c_uint8)
    libs = {}
    for k, path in paths.items():
        lib = ctypes.CDLL(path)
        lib.hsr_blk32_decode.restype = ctypes.c_int64
        lib.hsr_blk32_decode.argtypes = [u8p, ctypes.c_uint64, u8p, ctypes.c_uint64, ctypes.c_uint32, ctypes.c_uint32]
        libs[k] = lib.hsr_blk32_decode
    sink({"phase": "blk32_build", "trees": trees, "libraries": paths})
    data = text_like(np.random.default_rng(8), 64 * MIB)
    for wb in (16, 8):
        src = np.frombuffer(blk32_encode_host(data, 12, wb), np.uint8)
        dst = np.zeros(data.size, np.uint8)
        secs = {k: [] for k in libs}
        for i in range(reps):
            for k in (libs if i % 2 == 0 else reversed(libs)):
                dst[:] = 0
                t0 = time.perf_counter()
                got = libs[k](src.ctypes.data_as(u8p), src.size, dst.ctypes.data_as(u8p), dst.size, 12, wb)
                secs[k].append(time.perf_counter() - t0)
                if got != data.size or not np.array_equal(dst, data):
                    raise AssertionError(f"{k}: the 32blk {wb}w decode does not return the input")
        sink({"phase": "blk32_decode", "word_bits": wb, "bits": 12, "bytes": data.size, "reps": reps,
              **{k: {"s": v, "median_s": statistics.median(v), "min_s": min(v),
                     "MiBps": data.size / MIB / statistics.median(v)} for k, v in secs.items()}})


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+", metavar="NAME=DIR", help="a name and a directory holding hsrans_tpu_torch/")
    ap.add_argument("--out", type=Path, help="a file to which the JSON lines are appended")
    ap.add_argument("--e2e", type=int, metavar="REPS", help="time the entry points end to end, REPS calls each")
    ap.add_argument("--mt-decode", action="store_true", help="time the mt decode kernels only (both routes)")
    ap.add_argument("--scan", action="store_true", help="time the scan kernels only (csrc/scan.cu)")
    ap.add_argument("--blk32", type=int, metavar="REPS", help="time the trees' native 32blk decodes, REPS rounds")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device", file=sys.stderr)
        return 1
    trees = dict(t.split("=", 1) for t in args.trees)
    if args.worker:
        ((root,),) = [trees.values()]
        print(json.dumps(e2e_worker(Path(root).resolve(), args.e2e)))
        return 0
    card = chip_smoke.card()
    log = open(args.out, "a") if args.out else None

    def sink(row: dict) -> None:
        line = json.dumps({**row, "card": card})
        print(line, flush=True)
        if log:
            log.write(line + "\n")

    if args.blk32:
        try:
            run_blk32(trees, args.blk32, sink)
        finally:
            if log:
                log.close()
        return 0
    builds = {k: load_tree(k, Path(d).resolve()) for k, d in trees.items()}
    with ThreadPoolExecutor(len(builds)) as pool:  # nvcc runs in subprocesses: the trees build at once
        libs = dict(zip(builds, pool.map(lambda b: b.load(), builds.values())))
    try:
        if args.e2e:
            end_to_end(trees, args.e2e, sink)
            return 0
        sink({"phase": "build", "trees": trees, "libraries": {k: str(b.library_path()) for k, b in builds.items()}})
        if args.mt_decode:
            run_mt_decode(libs, torch.device("cuda", 0), sink)
            return 0
        if args.scan:
            run_scan(libs, torch.device("cuda", 0), sink)
            return 0
        run_tpx(libs, torch.device("cuda", 0), sink)
        run(libs, torch.device("cuda", 0), sink)
        run_hist(libs, torch.device("cuda", 0), sink)
    finally:
        if log:
            log.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
