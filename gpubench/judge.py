"""What decides `correct`: the frozen reference codec's answer for each
sampled call, compared byte for byte with the program's.

An encode is judged by its whole blob against the reference encoder's blob
of the same object: the header, every tile's or block's freqs (the
histogram model), the final states and words (the kernels) and their
offsets (the host layout and the wire writer).  A decode is judged by every
byte it returns against the object itself, and the blob it decoded, which
the program's encoder made in set-up, against the reference encoder's.
Each number is a count of bytes that differ (a missing answer: every byte
of it), and its limit is 0; so is the count of calls that failed.
"""

from __future__ import annotations

import numpy as np


def bytes_off(got: bytes | None, want: bytes) -> int:
    """Bytes of `got` that differ from `want`, a length's difference
    counted in full; all of `want` for no answer."""
    if got is None:
        return len(want)
    n = min(len(got), len(want))
    a = np.frombuffer(got, np.uint8, n)
    b = np.frombuffer(want, np.uint8, n)
    return int(np.count_nonzero(a != b)) + abs(len(got) - len(want))


def judge(cell, runner, sample: list[tuple[int, str, int, object]], failed: int, ref: dict | None = None) -> dict:
    """The checks of the sampled calls [(call, op, object, answer)]: each
    compared number with its limit.  `ref` keeps the reference's blobs by
    object between calls."""
    ref = {} if ref is None else ref

    def ref_blob(k: int) -> bytes:
        if k not in ref:
            ref[k] = cell.wire.ref_encode(runner.objects[k], cell.config)
        return ref[k]

    checks = {}
    for _, op, k, out in sample:
        if op == "encode":
            off = bytes_off(out, ref_blob(k))
        else:
            off = bytes_off(runner.blobs[k], ref_blob(k))
            dec = bytes_off(out, runner.objects[k])
            checks["output_bytes_off"] = max(checks.get("output_bytes_off", 0), dec)
        checks["wire_bytes_off"] = max(checks.get("wire_bytes_off", 0), off)
    checks["failed_calls"] = failed
    return {name: {"value": v, "limit": 0} for name, v in checks.items()}
