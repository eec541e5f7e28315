"""verify.cids_ms.range: what ``verify.cids_ms`` reads, in the range cell.

The range cell's end-to-end metric is ``kernel_us_per_kproof`` (its
proofs a second stand per layer there), so its per-layer metrics name that
one under ``moves``.
"""

from portbench.bench.registry import reader_beside

UNIT = "ms"
LAYER = "proofs/verifier.py + ops/verify.py verifier"
MOVES = "kernel_us_per_kproof"

read = reader_beside(__file__, "verify.cids_ms").read
