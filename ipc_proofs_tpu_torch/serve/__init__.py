"""Proof-serving plane: dynamic micro-batching over the batch engines.

The counterpart of ``ipc_proofs_tpu.serve``: the inference-serving shape — continuous batching, bounded admission with
backpressure, per-request deadlines, graceful drain, tenant fairness and
rate limits, latency-percentile observability — over the proof engines,
whose kernels run on the card. See `serve/batcher.py` (coalescing +
admission), `serve/qos.py` (tenant QoS), `serve/service.py` (the
service proper, with the replication plane's methods), `serve/durable.py`
(journaled, idempotent admission) and `serve/httpd.py` (the JSON-over-HTTP
front end and the IPBS stream).
"""

from ipc_proofs_tpu_torch.serve.batcher import (
    DeadlineExceededError,
    MicroBatcher,
    PendingResult,
    QueueFullError,
    ServiceClosedError,
)
from ipc_proofs_tpu_torch.serve.durable import DurableAdmission
from ipc_proofs_tpu_torch.serve.httpd import ProofHTTPServer
from ipc_proofs_tpu_torch.serve.service import (
    GenerateResponse,
    ProofService,
    ServiceConfig,
    VerifyResponse,
    sequential_verify_baseline,
)

__all__ = [
    "DeadlineExceededError",
    "DurableAdmission",
    "GenerateResponse",
    "MicroBatcher",
    "PendingResult",
    "ProofHTTPServer",
    "ProofService",
    "QueueFullError",
    "ServiceClosedError",
    "ServiceConfig",
    "VerifyResponse",
    "sequential_verify_baseline",
]
