"""verify.cids_ms: the witness-CID recompute, milliseconds a unit.

The benchmark's ``verify_block_cids`` spans (a wrapper on the backend's
entry, traced runs only): packing, launches, copy-back and compare, not the
replay's TxMeta hashing. With one client, the union of the spans over the
window a pass; with several (one bundle a unit, calls overlapping), the
spans' summed time a bundle.
"""

from portbench.bench.trace import union_seconds

UNIT = "ms"
LAYER = "proofs/verifier.py + ops/verify.py verifier"
MOVES = "proofs_per_s"


def read(record):
    spans = record["spans"].get("verify_block_cids")
    if not spans or not record["units"]:
        return None
    if record["clients"] == 1:
        seconds = union_seconds(spans)
    else:
        seconds = sum(end - start for start, end in spans)
    return seconds / record["units"] * 1e3
