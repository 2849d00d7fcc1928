"""hsrans-compatible benchmark/test CLI of the PyTorch/CUDA port.

The port of `hsrans_tpu/cli.py`, with the same flags, rows, table and exit
codes (the reference binary's interface, main.cpp:367-399):

  python -m hsrans_tpu_torch.cli <file> [flags]

    --test              run every codec/variant once and validate roundtrips
    --all               include all variants (default: relevant set)
    --hist-min N        minimum TotalSymbolCountBits (default 10)
    --hist-max N        maximum TotalSymbolCountBits (default 15)
    --include-raw/--exclude-raw, --include-mt/--exclude-mt,
    --include-32blk/--exclude-32blk, --include-block/--exclude-block,
    --include-tpx/--exclude-tpx, --include-dev/--exclude-dev,
    --exclude-16/-32/-64 (state widths)
    --runs N            timed runs per codec (default 3)
    --runs-enc/--runs-dec N   separate encode/decode run counts
    --max-simd <level>  capability downgrade (reference main.cpp:463-618):
                        'none' -> numpy tier; other levels below avx512f ->
                        the interpret (torch) tier
    --backend {auto,device,interpret,numpy}
                        device: the CUDA kernels on the card (auto means
                        device; without a card the CLI exits 2);
                        interpret: the kernels' plain PyTorch versions on
                        the CPU; numpy: the numpy host codecs, the tpx
                        rows on the numpy tpx codec
    --no-sleep / --low-mem    accepted for flag parity
    --cpu-core N        pin the process to core N

The raw, 32blk, block and mt rows run on the host: the native C++ codecs
(`runtime/native.py`), or their numpy copies at the numpy tier.  The tpx
rows and the mt dev row run the port's entry points (`tpx_encode_torch`,
`tpx_encode_adaptive_torch`, `tpx_decode_torch`; `mt_encode_torch` in
uniform 4096-byte blocks and `mt_decode_torch` at n=64) on the card, or on
the CPU at the interpret tier; at the numpy tier the tpx rows run the
numpy tpx codec (`ops/tpx.py`) and there is no mt dev row.  The mt dev
row has no host fallback: a decode that gives None is a MISMATCH.

Output mirrors the reference's table: ratio, encode MiB/s (best run),
decode max/avg/min MiB/s and per-run σ (main.cpp:72-118's stat set).
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time

import numpy as np

# --backend -> the port's tier (runtime/device.py): where each row runs
TIERS = {"auto": "cuda", "device": "cuda", "interpret": "torch", "numpy": "numpy"}


def _build_codecs(args) -> list[dict]:
    from .kernels.mt_decode import mt_decode_torch
    from .kernels.mt_encode import mt_encode_torch
    from .kernels.tpx_decode import tpx_decode_torch
    from .kernels.tpx_encode import tpx_encode_adaptive_torch, tpx_encode_torch
    from .models.histogram import make_hist
    from .ops import blk32, block, mt, reference, tpx

    bits_range = range(args["hist_min"], args["hist_max"] + 1)
    codecs = []
    tier = TIERS[args["backend"]]
    # the numpy tier downgrades the host rows too: the numpy codecs run in
    # place of the native AVX-512 ones (the reference's --max-simd cascade)
    scalar = tier == "numpy"
    dev = "cuda" if tier == "cuda" else "cpu"

    def add(name, enc, dec, bits):
        codecs.append({"name": f"{name} {bits}", "enc": enc, "dec": dec})

    widths = [n for n in (16, 32, 64) if args[f"w{n}"]]
    for bits in bits_range:
        if args["raw"]:
            for n in widths:
                if scalar:
                    enc = (lambda b, n=n: lambda d: reference.raw_encode_16w(d, make_hist(d, b), n))(bits)
                    dec = (lambda b, n=n: lambda c: reference.raw_decode_16w(c, b, n))(bits)
                else:
                    enc = (lambda b, n=n: lambda d: reference.raw_encode(d, b, n))(bits)
                    dec = (lambda b, n=n: lambda c: reference.raw_decode(c, b, n))(bits)
                add(f"rANS32x{n} 16w", enc, dec, bits)
        if args["blk32"] and 32 in widths:
            for wb in (16, 8):
                if scalar:
                    enc = (lambda b, wb=wb: lambda d: blk32.blk32_encode(d, make_hist(d, b), wb))(bits)
                    dec = (lambda b, wb=wb: lambda c: blk32.blk32_decode(c, b, wb))(bits)
                else:
                    enc = (lambda b, wb=wb: lambda d: blk32.blk32_encode_host(d, b, wb))(bits)
                    dec = (lambda b, wb=wb: lambda c: blk32.blk32_decode_host(c, b, wb))(bits)
                add(f"rANS32x32 32blk {wb}w", enc, dec, bits)
        if args["block"]:
            for n in [n for n in (32, 64) if n in widths]:
                enc_fn = block.block_encode_py if scalar else block.block_encode
                dec_fn = block.block_decode_py if scalar else block.block_decode
                add(
                    f"block rANS32x{n} 16w",
                    (lambda b, n=n, f=enc_fn: lambda d: f(d, b, n))(bits),
                    (lambda b, n=n, f=dec_fn: lambda c: f(c, b, n))(bits),
                    bits,
                )
        if args["mt"]:
            for n in [n for n in (32, 64) if n in widths]:
                enc_fn = mt.mt_encode_py if scalar else mt.mt_encode
                dec_fn = mt.mt_decode_py if scalar else mt.mt_decode
                add(
                    f"mt rANS32x{n} 16w",
                    (lambda b, n=n, f=enc_fn: lambda d: f(d, b, n))(bits),
                    (lambda b, n=n, f=dec_fn: lambda c: f(c, b, n))(bits),
                    bits,
                )
            if not scalar and args["dev"] and 64 in widths and bits <= 15:
                add(
                    "mt rANS32x64 16w dev",
                    (lambda b: lambda d: mt_encode_torch(d, b, device=dev))(bits),
                    (lambda b: lambda c: mt_decode_torch(c, b, 64, device=dev))(bits),
                    bits,
                )
        if args["tpx"]:
            if scalar:
                dec = tpx.tpx_decode
                enc = (lambda b: lambda d: tpx.tpx_encode(d, b))(bits)
                enc_a = (lambda b: lambda d: tpx.tpx_encode_adaptive(d, b))(bits)
            else:
                dec = lambda c: tpx_decode_torch(c, device=dev)  # noqa: E731
                enc = (lambda b: lambda d: tpx_encode_torch(d, b, device=dev))(bits)
                enc_a = (lambda b: lambda d: tpx_encode_adaptive_torch(d, b, device=dev))(bits)
            add("tpx rANS32x128x1024", enc, dec, bits)
            add("tpx adaptive (v3)", enc_a, dec, bits)
    return codecs


def parse_args(argv: list[str]) -> dict:
    args = {
        "file": None,
        "test": False,
        "runs": 3,
        "runs_enc": None,
        "runs_dec": None,
        "hist_min": 10,
        "hist_max": 15,
        "raw": True,
        "blk32": False,
        "mt": False,
        "block": True,
        "tpx": True,
        "dev": True,  # --exclude-dev drops the device mt row
        # state-width filters (reference --exclude-16/-32/-64, main.cpp:247-249)
        "w16": True,
        "w32": True,
        "w64": True,
        "backend": "auto",
        "max_simd": None,
        "cpu_core": None,
    }
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "--test":
            args.update(test=True, runs=1, raw=True, blk32=True, mt=True, block=True, tpx=True)
        elif a == "--all":
            args.update(raw=True, blk32=True, mt=True, block=True, tpx=True)
        elif a in ("--runs", "--runs-enc", "--runs-dec"):
            key = {"--runs": "runs", "--runs-enc": "runs_enc", "--runs-dec": "runs_dec"}[a]
            i += 1
            args[key] = int(argv[i])
        elif a == "--hist-min":
            i += 1
            args["hist_min"] = int(argv[i])
        elif a == "--hist-max":
            i += 1
            args["hist_max"] = int(argv[i])
        elif a.startswith("--include-") or a.startswith("--exclude-"):
            # the reference spells the 32blk family "--include-32blk"
            # (main.cpp flag table); the key is "blk32".  Bare width numbers
            # are the state-width filters (--exclude-16/-32/-64).
            key = a[10:].replace("-", "")
            key = {"32blk": "blk32", "16": "w16", "32": "w32", "64": "w64"}.get(key, key)
            args[key] = a.startswith("--include-")
        elif a == "--max-simd":
            i += 1
            args["max_simd"] = argv[i]
        elif a == "--backend":
            i += 1
            args["backend"] = argv[i]
        elif a in ("--no-sleep", "--low-mem"):
            pass  # thermal and memory hygiene flags of the reference: accepted
        elif a == "--cpu-core":
            i += 1
            args["cpu_core"] = int(argv[i])
        elif not a.startswith("-"):
            args["file"] = a
        i += 1
    # Capability downgrade (reference: main.cpp:463-618), resolved once after
    # all flags so the result is argument-order independent.  Only ever
    # downgrades: the full level is a no-op, mid levels force the interpret
    # tier, none forces the numpy tier — even over an explicit --backend
    # device (warned), never upgrading an explicit numpy.
    level = args.pop("max_simd")
    if level == "none":
        if args["backend"] == "device":
            print("warning: --max-simd none overrides --backend device", file=sys.stderr)
        args["backend"] = "numpy"
    elif level is not None and level not in ("avx512bw", "avx512f"):
        if args["backend"] in ("auto", "device"):
            if args["backend"] == "device":
                print(f"warning: --max-simd {level} overrides --backend device", file=sys.stderr)
            args["backend"] = "interpret"
    return args


def _print_mismatch(want: np.ndarray, got: bytes | None) -> None:
    """Hex context around the first differing byte (the reference's Validate
    diff dump, main.cpp:949-1039)."""
    if got is None:
        print("  decode returned None (malformed-input path)", file=sys.stderr)
        return
    g = np.frombuffer(got, dtype=np.uint8)
    if g.size != want.size:
        print(f"  length mismatch: expected {want.size}, got {g.size}", file=sys.stderr)
    n = min(g.size, want.size)
    diffs = np.nonzero(g[:n] != want[:n])[0]
    at = int(diffs[0]) if diffs.size else n
    lo, hi = max(0, at - 16), min(n, at + 16)
    print(f"  first mismatch at offset {at} ({diffs.size} differing bytes)", file=sys.stderr)
    print("  expected: " + want[lo:hi].tobytes().hex(" "), file=sys.stderr)
    print("  got:      " + g[lo:hi].tobytes().hex(" "), file=sys.stderr)


def main(argv: list[str] | None = None, on_row=None) -> int:
    """Run the CLI; `on_row`, if given, is called with each row's figures
    (a dict: name, ratio, MiB/s, ok) as the row is printed."""
    args = parse_args(argv if argv is not None else sys.argv[1:])
    if not args["file"]:
        print(__doc__)
        return 2

    import torch

    from .runtime.device import banner, detect

    tier = TIERS[args["backend"]]
    if tier == "cuda" and not torch.cuda.is_available():
        print(f"error: --backend {args['backend']} runs on a CUDA card, and there is none; "
              "--backend interpret or numpy runs on the CPU", file=sys.stderr)
        return 2
    core = args.pop("cpu_core")
    if core is not None:
        # pin the process for stable host-tier timing (the reference pins its
        # bench thread the same way, main.cpp --cpu-core)
        try:
            os.sched_setaffinity(0, {core})
        except (AttributeError, OSError) as e:
            print(f"warning: --cpu-core {core} not applied: {e}", file=sys.stderr)
    cap = detect() if tier == "cuda" else dataclasses.replace(detect(), platform="cpu", device_kind="cpu",
                                                             num_devices=1)
    print(banner(dataclasses.replace(cap, tier=tier)))

    data = np.fromfile(args["file"], dtype=np.uint8)
    want = data.tobytes()
    print(f"file: {args['file']} ({data.size} bytes)")
    print(
        f"{'codec':<28} {'ratio':>8} {'enc MiB/s':>10} "
        f"{'dec max':>9} {'dec avg':>9} {'dec min':>9} {'dec σ%':>7}  status"
    )

    runs_enc = args["runs_enc"] or args["runs"]
    runs_dec = args["runs_dec"] or args["runs"]
    failed = 0
    for codec in _build_codecs(args):
        try:
            blob = None
            enc_dt = float("inf")
            for _ in range(runs_enc):
                t0 = time.perf_counter()
                blob = codec["enc"](data)
                enc_dt = min(enc_dt, time.perf_counter() - t0)
            dts = []
            out = None
            for _ in range(runs_dec):
                t0 = time.perf_counter()
                out = codec["dec"](blob)
                dts.append(time.perf_counter() - t0)
            ok = out == want
            if not ok:
                failed += 1
                _print_mismatch(data, out)
            mib = data.size / (1 << 20)
            # per-run spread, reference main.cpp:72-118 (avg/min/max/std dev);
            # rates: best run = mib/min(dts), worst = mib/max(dts)
            rates = [mib / dt for dt in dts]
            avg = sum(rates) / len(rates)
            sigma = (sum((r - avg) ** 2 for r in rates) / len(rates)) ** 0.5
            row = {"name": codec["name"], "ratio": len(blob) / max(data.size, 1), "encode_MiBps": mib / enc_dt,
                   "decode_max_MiBps": max(rates), "decode_avg_MiBps": avg, "decode_min_MiBps": min(rates),
                   "decode_sigma_pct": 100 * sigma / avg if avg else 0.0, "ok": ok}
            print(
                f"{codec['name']:<28} {row['ratio']*100:7.2f}% "
                f"{row['encode_MiBps']:>10.2f} {max(rates):>9.2f} {avg:>9.2f} "
                f"{min(rates):>9.2f} {row['decode_sigma_pct']:>6.1f}%  "
                f"{'OK' if ok else 'MISMATCH'}"
            )
        except Exception as e:  # mirror reference: any failure is a test failure
            failed += 1
            row = {"name": codec["name"], "ok": False, "error": f"{type(e).__name__}: {e}"}
            print(f"{codec['name']:<28} ERROR: {type(e).__name__}: {e}")
        if on_row is not None:
            on_row(row)

    if args["test"]:
        print(f"--test: {'ALL OK' if failed == 0 else f'{failed} FAILURES'}")
        return 1 if failed else 0
    return 0


if __name__ == "__main__":
    sys.exit(main())
