"""The card's idle share of the profiled window, %: 100 x (1 - the union of
its kernel, copy and memset events / the window)."""


def read(r):
    t = r.trace
    if t is None or t.window_us <= 0 or t.busy_us <= 0:
        return None
    return 100.0 * (1.0 - t.busy_us / t.window_us)
