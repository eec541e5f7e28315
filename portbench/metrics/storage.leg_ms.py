"""storage.leg_ms: the storage leg, wall milliseconds a pass.

The ``range_storage`` stage's ``wall_s`` over the window: the slot keccaks
on the card plus the batched HAMT walks of
``generate_storage_proofs_for_pairs``, divided by the passes.
"""

UNIT = "ms"
LAYER = "proofs/storage_batch.py storage leg"
MOVES = "proofs_per_s"


def read(record):
    stage = record["stages"].get("range_storage")
    if not stage or not record["units"]:
        return None
    return stage["wall_s"] / record["units"] * 1e3
