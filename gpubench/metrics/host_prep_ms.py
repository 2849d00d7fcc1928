"""Host preparation, ms a call: the program's own layer clocks host_parse
(the tpx header walk), host_tables (decode tables), host_index (the mt
header or plan walk) and host_layout (the encoders' wire offsets)."""

KEYS = ("host_parse", "host_tables", "host_index", "host_layout")


def read(r):
    return r.layer_ms(KEYS)
