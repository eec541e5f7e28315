"""proofs_per_s (end to end): every proof completed in the window over the
window's time.

The proofs of every whole unit completed in the window whose bundle reads
true on every verdict, over the window's seconds (its opening to the end
of its last unit), on the host's clock.
"""

UNIT = "proofs/s"


def read(record):
    return record["proofs"] / record["window_s"]
