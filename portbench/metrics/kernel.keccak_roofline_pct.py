"""kernel.keccak_roofline_pct: the keccak kernels' share of their roofline.

The least time the card needs for the messages handed to the backend's
``keccak256_batch`` in the traced window (`portbench.bench.roofline`),
over the summed device time of the keccak kernels there. None where no
keccak kernel ran.
"""

from portbench.bench.roofline import bound_seconds, keccak_work

UNIT = "%"
LAYER = "csrc/keccak.cu"
MOVES = "proofs_per_s"


def read(record):
    device_s = sum(end - start for name, start, end in record["device_ops"] if "keccak" in name)
    lengths = record["hashed"].get("keccak")
    if device_s <= 0 or not lengths:
        return None
    return bound_seconds(*keccak_work(lengths)) / device_s * 100
