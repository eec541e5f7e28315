"""Device-mesh parallelism for the batch proof pipeline, and the host
parallelism of the range drivers.

The proof workload is data-parallel over independent items: (tipset ×
receipt × event) for event proofs, (block) for witness CID recomputation.
The mesh (`parallel.mesh`) maps those axes onto devices:

- ``dp`` (data)     — tipsets / witness blocks shard here;
- ``sp`` (sequence) — the flattened event axis shards here; the per-receipt
  any-reduce is the only cross-device communication (an OR over ``sp``).

There is deliberately no tp/pp: there are no weight matrices to shard and
no layered model to pipeline. `parallel.multihost` spans ``dp`` across
processes on ``torch.distributed``. `parallel.pipeline` also holds the
bounded-queue stage executor and the fingerprint-mask coalescer of the
range drivers.
"""

from ipc_proofs_tpu_torch.parallel.mesh import Mesh, make_mesh
from ipc_proofs_tpu_torch.parallel.pipeline import (
    EventBatch,
    match_pipeline,
    sharded_match_pipeline,
    synthetic_event_batch,
)

__all__ = [
    "Mesh",
    "make_mesh",
    "EventBatch",
    "match_pipeline",
    "sharded_match_pipeline",
    "synthetic_event_batch",
]
