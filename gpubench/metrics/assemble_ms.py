"""Host assembly, ms a call: the program's layer clocks host_mux (the
encoders' blob to bytes) and host_assemble (the decoders' output to
bytes)."""

KEYS = ("host_mux", "host_assemble")


def read(r):
    return r.layer_ms(KEYS)
