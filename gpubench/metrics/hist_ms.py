"""The histogram model, ms a call: the program's layer clock kernel_hist
(the encoders' per-tile or per-block histograms and encode tables)."""

KEYS = ("kernel_hist",)


def read(r):
    return r.layer_ms(KEYS)
