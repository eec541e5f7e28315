"""storage.slot_hash_ms: the slot keccaks, wall milliseconds a pass.

The union of the benchmark's ``keccak256_batch`` spans (a wrapper on the
backend's entry, traced runs only) over the window, divided by the passes.
"""

from portbench.bench.trace import union_seconds

UNIT = "ms"
LAYER = "proofs/storage_batch.py storage leg"
MOVES = "proofs_per_s"


def read(record):
    spans = record["spans"].get("keccak256_batch")
    if not spans or not record["units"]:
        return None
    return union_seconds(spans) / record["units"] * 1e3
