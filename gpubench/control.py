"""The control of `correct`: the frozen reference put in the program's place
one precision below the configuration's, which the check has to refuse.

    python3 gpubench/control.py --workload <name> --seeds <n> [<n> ...] [--seconds <s>]

The configuration states the depth of the probability model, 2^bits.  The
control encodes at 2^(bits-1), and decodes the program's blobs with each
table renormalised to 2^(bits-1) and the state arithmetic at that depth:
the step down that would tempt a later change.  For each seed, set-up is
the run's (the same objects and blobs); a short window of the program's
calls at the cell's own load gives the sampled calls, which are judged
once with the program's answers and once with the control's answers to the
same calls.  One JSON line a seed, then a summary of the largest reading
of the program and the smallest of the control for each number.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from gpubench import run  # noqa: E402
from gpubench.judge import judge  # noqa: E402


def control_answer(cell: run.Cell, runner: run.Runner, op: str, k: int) -> bytes:
    """The reference's answer one precision below the configuration's."""
    bits = int(cell.config["bits"]) - 1
    if op == "encode":
        return cell.wire.ref_encode(runner.objects[k], cell.config, bits=bits)
    return cell.wire.ref_decode(runner.blobs[k], cell.config, table_bits=bits)


def readings(cell: run.Cell, seed: int, seconds: float, device: torch.device) -> dict:
    """The program's and the control's readings of one seed's sampled calls."""
    runner = run.Runner(cell, seed, device)
    runner.warm(count_tables=False)
    w, sampler = run.Window(), run.Sampler(int(cell.traffic.get("checked_calls", 2)), seed)
    runner.loop(w, sampler, seconds)
    sample = sampler.sample()
    ref: dict[int, bytes] = {}
    program = judge(cell, runner, sample, w.failed, ref)
    t0 = time.perf_counter()
    swapped = [(i, op, k, control_answer(cell, runner, op, k)) for i, op, k, _ in sample]
    control = judge(cell, runner, swapped, 0, ref)
    return {"seed": seed, "calls": len(w.latency), "sampled": [(op, k) for _, op, k, _ in sample],
            "program": {n: c["value"] for n, c in program.items()},
            "control": {n: c["value"] for n, c in control.items()},
            "limit": {n: c["limit"] for n, c in program.items()}, "control_s": time.perf_counter() - t0}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    cell = run.Cell.load(args.workload)
    lines = [readings(cell, s, args.seconds, torch.device("cuda", 0)) for s in args.seeds]
    for line in lines:
        print(json.dumps(line), flush=True)
    summary = {
        n: {"program_max": max(x["program"][n] for x in lines), "control_min": min(x["control"][n] for x in lines),
            "limit": lines[0]["limit"][n]}
        for n in lines[0]["program"]
    }
    print(json.dumps({"workload": args.workload, "seeds": args.seeds, "summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
