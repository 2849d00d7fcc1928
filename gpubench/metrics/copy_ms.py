"""Copies between host and card, ms a call: the program's layer clocks h2d
and d2h."""

KEYS = ("h2d", "d2h")


def read(r):
    return r.layer_ms(KEYS)
