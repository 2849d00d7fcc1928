"""Host preparation on the profiler's clock, ms a call: the self time of the
program's ranges hsrans.host_parse, host_tables, host_index and
host_layout in the profiled window, over its harness calls (the layers
`host_prep_ms` reads, with no synchronization at their ends)."""

from gpubench import spans

NAMES = ("host_parse", "host_tables", "host_index", "host_layout")


def read(r):
    return spans.self_ms(r, NAMES)
