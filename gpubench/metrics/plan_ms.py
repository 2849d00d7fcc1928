"""The planner, ms a call: the harness's host clock around the program's
`parallel.sharded.device_plan` in an encode call that plans its blocks
(the key `plan` the wire adds beside the program's layer clocks)."""

KEYS = ("plan",)


def read(r):
    return r.layer_ms(KEYS)
