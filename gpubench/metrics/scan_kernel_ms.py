"""The scan chain's kernel, ms a call: the card time that
`gpubench/spans.py` attributes to the program's range hsrans.kernel_scan
(the scan decode or encode kernel of `ops/raw_scan.py`) in the profiled
window, over its harness calls.  Over a raw blob's ceil(length / 64)
links it is the chain's time a link.  Where the calls ran on the CPU (the
program's plain tier, in the harness's tests) the kernel's plain version
runs on the host inside the range, and the range's duration stands in
for the card time that such a run has none of."""

from gpubench import spans

NAME = spans.PREFIX + "kernel_scan"


def read(r):
    s = spans.of(r)
    us = None if s is None else (s.dur_us if r.device_kind == "cpu" else s.device_us).get(NAME)
    return None if us is None else us / len(s.calls) / 1e3
