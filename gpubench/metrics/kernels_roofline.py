"""The kernels' share of their roofline, %: the least time the profiled
calls' bytes (`roofline.call_bytes`) take at the card's published
bandwidth, over the summed time of every kernel in the profiled window."""

from gpubench import roofline


def read(r):
    t = r.trace
    if t is None or t.kernel_us <= 0 or not r.traced_bytes:
        return None
    least = roofline.least_seconds(r.traced_bytes, r.device_kind)
    return None if least is None else 100.0 * least / (t.kernel_us * 1e-6)
