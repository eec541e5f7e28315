"""range.scan_ms: the range engine's scan stage, wall milliseconds a pass.

The ``range_scan`` stage's ``wall_s`` (the union of its intervals) over the
window, from the ``Metrics`` the benchmark hands the range engine, divided
by the passes (units) in the window.
"""

UNIT = "ms"
LAYER = "proofs/range.py range engine (host)"
MOVES = "kernel_us_per_kproof"


def read(record):
    stage = record["stages"].get("range_scan")
    if not stage or not record["units"]:
        return None
    return stage["wall_s"] / record["units"] * 1e3
