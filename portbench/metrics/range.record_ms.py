"""range.record_ms: the range engine's record stage, wall milliseconds a
pass.

The ``range_record`` stage's ``wall_s`` over the window, from the
``Metrics`` the benchmark hands the range engine, divided by the passes.
"""

UNIT = "ms"
LAYER = "proofs/range.py range engine (host)"
MOVES = "kernel_us_per_kproof"


def read(record):
    stage = record["stages"].get("range_record")
    if not stage or not record["units"]:
        return None
    return stage["wall_s"] / record["units"] * 1e3
