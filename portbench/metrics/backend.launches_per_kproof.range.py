"""backend.launches_per_kproof.range: what ``backend.launches_per_kproof`` reads, in the range cell.

The range cell's end-to-end metric is ``kernel_us_per_kproof`` (its
proofs a second stand per layer there), so its per-layer metrics name that
one under ``moves``.
"""

from portbench.bench.registry import reader_beside

UNIT = "launches/kproof"
LAYER = "backend/gpu.py (size classes)"
MOVES = "kernel_us_per_kproof"

read = reader_beside(__file__, "backend.launches_per_kproof").read
