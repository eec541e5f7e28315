"""Bulk backfill: prove deep history as a durable, streaming batch job.

Interactive serving and standing-query pushes answer
"prove THIS tipset"; backfill answers "prove every matching event over
the last 100k epochs" — the one workload big enough to saturate a
device mesh. The design follows the parallel-EVM-with-async-storage
blueprint (PAPERS.md, arxiv 2503.04595): epoch-partitioned execution
fed by a work-ahead storage scheduler instead of one demand-driven
chunk spine, streaming verified chunks to clients as they land
(stateless-client line, arxiv 2504.14069) rather than holding results
until job completion.

- `scheduler.py` — epoch windows on ring arcs (`cluster/hashring.py`
  placement) + the `WorkAheadFeeder` that primes the fetch plane's
  speculative lanes from the schedule across window boundaries;
- `engine.py`   — `BackfillEngine`/`BackfillJob`: IPJ1 journal
  durability per job (SIGKILL-resumable, byte-identical by
  construction), incremental `BundleFold` merge, cursor-protocol chunk
  streaming, standing-query catch-up landing, and a pluggable
  ``run_window`` so execution rides the serve plane's low-priority
  micro-batcher lane or the cluster router's steal-aware dispatch.

HTTP surface (`serve/httpd.py`, mirrored by the cluster router):
``POST /v1/backfill`` submits, ``GET /v1/backfill/<id>`` reports
status, ``GET /v1/backfill/<id>/chunks?cursor=N&wait_s=S`` long-polls
chunks with ack-through-cursor semantics. See README "Bulk backfill".
"""

from ipc_proofs_tpu_torch.backfill.engine import (
    BackfillChunk,
    BackfillEngine,
    BackfillError,
    BackfillJob,
    local_window_runner,
)
from ipc_proofs_tpu_torch.backfill.scheduler import (
    EpochWindow,
    WorkAheadFeeder,
    plan_windows,
    window_ring_key,
)

__all__ = [
    "BackfillChunk",
    "BackfillEngine",
    "BackfillError",
    "BackfillJob",
    "EpochWindow",
    "WorkAheadFeeder",
    "local_window_runner",
    "plan_windows",
    "window_ring_key",
]
