"""host.gc_pause_pct: the share of the window that the collector's pauses
took.

The seconds between each collection's start and stop callbacks
(``gc.callbacks``), over every generation, over the window's length. The
heap that set-up made is frozen out of the collector's walks before the
window opens, so this is the window's own garbage.
"""

UNIT = "%"
LAYER = "host (CPython runtime)"
MOVES = "proofs_per_s"


def read(record):
    return record["host"]["gc_pause_s"] / record["window_s"] * 100
