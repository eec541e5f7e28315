"""Proof-serving plane: dynamic micro-batching over the batch engines.

The counterpart of ``ipc_proofs_tpu.serve``, its in-process half: the
inference-serving shape — continuous batching, bounded admission with
backpressure, per-request deadlines, graceful drain, tenant fairness and
rate limits, latency-percentile observability — over the proof engines,
whose kernels run on the card. See `serve/batcher.py` (coalescing +
admission), `serve/qos.py` (tenant QoS) and `serve/service.py` (the
service proper). The HTTP front end, durable admission and replication
are not ported yet.
"""

from ipc_proofs_tpu_torch.serve.batcher import (
    DeadlineExceededError,
    MicroBatcher,
    PendingResult,
    QueueFullError,
    ServiceClosedError,
)
from ipc_proofs_tpu_torch.serve.service import (
    GenerateResponse,
    ProofService,
    ServiceConfig,
    VerifyResponse,
    sequential_verify_baseline,
)

__all__ = [
    "DeadlineExceededError",
    "GenerateResponse",
    "MicroBatcher",
    "PendingResult",
    "ProofService",
    "QueueFullError",
    "ServiceClosedError",
    "ServiceConfig",
    "VerifyResponse",
    "sequential_verify_baseline",
]
