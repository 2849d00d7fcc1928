"""Host assembly on the profiler's clock, ms a call: the self time of the
program's ranges hsrans.host_mux (the encoders' blob to bytes) and
hsrans.host_assemble (the decoders' output to bytes) in the profiled
window, over its harness calls (the layers `assemble_ms` reads, with no
synchronization at their ends)."""

from gpubench import spans

NAMES = ("host_mux", "host_assemble")


def read(r):
    return spans.self_ms(r, NAMES)
