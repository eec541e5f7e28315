"""host.gc_pause_pct.range: what ``host.gc_pause_pct`` reads, in the range cell.

The range cell's end-to-end metric is ``kernel_us_per_kproof`` (its
proofs a second stand per layer there), so its per-layer metrics name that
one under ``moves``.
"""

from portbench.bench.registry import reader_beside

UNIT = "%"
LAYER = "host (CPython runtime)"
MOVES = "kernel_us_per_kproof"

read = reader_beside(__file__, "host.gc_pause_pct").read
