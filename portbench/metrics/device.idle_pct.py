"""device.idle_pct: the share of the traced window in which the card ran
nothing.

One less the union of the profiler's device operations (kernels, copies,
memsets) within the window over the window's length.
"""

UNIT = "%"
LAYER = "device"
MOVES = "proofs_per_s"


def read(record):
    if record["busy_s"] <= 0:
        return None
    return (1 - record["busy_s"] / record["window_s"]) * 100
