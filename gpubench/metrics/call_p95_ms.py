"""The 95th percentile of a call's host-clock latency, ms, over every call
of the traced run's untraced window: the same window as a `--trace 0`
run's, with neither the layer clocks nor the profiler.  The tail moves
with the host's load from run to run by more than any bound could hold
(PERF.md §2), so it stands here, without a bound, beside
`throughput_MiBps`."""

import numpy as np


def read(r):
    return 1e3 * float(np.percentile(r.latency, 95)) if r.latency else None
