"""The planner on the profiler's clock, ms a call: the duration of the
program's root range hsrans.device_plan (`parallel.sharded.device_plan`,
its greedy planner and the pieces' histograms) in the profiled window,
over its harness calls; the program's own span where `plan_ms` is the
harness's clock."""

from gpubench import spans

NAMES = ("device_plan",)


def read(r):
    return spans.dur_ms(r, NAMES)
