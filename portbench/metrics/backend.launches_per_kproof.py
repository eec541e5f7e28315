"""backend.launches_per_kproof: kernel launches a thousand proofs.

Launches in the window, from the program's ``LAUNCHES`` counters of
``ops/blake2b.py``, ``ops/keccak.py`` and ``ops/match.py``, a thousand
proofs completed.
"""

UNIT = "launches/kproof"
LAYER = "backend/gpu.py (size classes)"
MOVES = "proofs_per_s"


def read(record):
    if not record["proofs"]:
        return None
    return record["launches"] / record["proofs"] * 1e3
