"""proofs_per_s.range: the range cell's proofs a second, read per layer.

What ``proofs_per_s`` reads, in the traced run of a cell whose end-to-end
metric is ``kernel_us_per_kproof``: the host's speed moves this rate from
run to run by more than a bound may allow, so there it stands unbounded.
"""

from portbench.bench.registry import reader_beside

UNIT = "proofs/s"
LAYER = "proofs/range.py range engine (host)"
MOVES = "kernel_us_per_kproof"

read = reader_beside(__file__, "proofs_per_s").read
