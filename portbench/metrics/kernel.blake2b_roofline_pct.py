"""kernel.blake2b_roofline_pct: the blake2b kernels' share of their roofline.

The least time the card needs for the messages handed to the backend's
``blake2b256_batch`` in the traced window (`portbench.bench.roofline`),
over the summed device time of the blake2b kernels there. None where no
blake2b kernel ran.
"""

from portbench.bench.roofline import blake2b_work, bound_seconds

UNIT = "%"
LAYER = "csrc/blake2b.cu"
MOVES = "proofs_per_s"


def read(record):
    device_s = sum(end - start for name, start, end in record["device_ops"] if "blake2b" in name)
    lengths = record["hashed"].get("blake2b")
    if device_s <= 0 or not lengths:
        return None
    return bound_seconds(*blake2b_work(lengths)) / device_s * 100
