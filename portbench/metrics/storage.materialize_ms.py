"""storage.materialize_ms: the witness materialization of a storage
bundle, wall milliseconds a unit.

The ``range_record`` stage's ``wall_s`` over the window, from the
``Metrics`` the benchmark hands the range engine, divided by the units: in
a range with no event spec's matches to record, the stage is the bundle's
witness materialization alone.
"""

from portbench.bench.registry import reader_beside

UNIT = "ms"
LAYER = "proofs/storage_batch.py storage leg"
MOVES = "proofs_per_s"

read = reader_beside(__file__, "range.record_ms").read
