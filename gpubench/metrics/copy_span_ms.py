"""Copies between host and card on the profiler's clock, ms a call: the self
time of the program's ranges hsrans.h2d and hsrans.d2h in the profiled
window, over its harness calls (the layers `copy_ms` reads, with no
synchronization at their ends)."""

from gpubench import spans

NAMES = ("h2d", "d2h")


def read(r):
    return spans.self_ms(r, NAMES)
