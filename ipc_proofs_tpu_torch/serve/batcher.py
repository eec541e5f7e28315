"""Dynamic micro-batcher: bounded admission, flush-on-size-or-deadline.

The counterpart of ``ipc_proofs_tpu.serve.batcher``: the serving half of
the inference-serving shape grafted onto the proof pipeline (request
admission decoupled from batched execution). Individual requests arrive
one at a time; the batch
engines (`proofs/event_verifier.py` grouped replay, `proofs/range.py`)
only pay off when fed many proofs per call. The `MicroBatcher` bridges
them:

- **admission** is a bounded queue. A full queue REJECTS immediately with
  a retry hint (`QueueFullError.retry_after_s`) — it never blocks the
  caller and never grows without bound, so a traffic spike degrades into
  fast 503s instead of memory exhaustion and collapse.
- **coalescing** flushes a batch when it reaches ``max_batch`` requests OR
  the oldest queued request has waited ``max_wait_ms`` — whichever comes
  first. Under load, batches fill instantly and the wait bound never
  binds; at low traffic, a lone request pays at most ``max_wait_ms`` of
  extra latency.
- **deadlines** are per request: a request whose deadline passed while it
  sat in the queue is completed with `DeadlineExceededError` at dequeue
  time rather than wasting batch capacity on an answer nobody is waiting
  for.
- **drain** (`close(drain=True)`) stops admission, flushes everything
  already accepted, and joins the batcher thread — an accepted request is
  never dropped by shutdown.
- **priority** is three lanes, drained strictly in order: ``push`` >
  ``interactive`` > ``low``. The PUSH lane carries standing-query
  fan-out work (`subs/matcher.py` riding `submit_range_window`'s push
  lane) and is assembled greedily — a subscriber notification never
  waits a batching window behind interactive traffic. The LOW lane
  (backfill windows) is only drained when both others are empty and is
  abandoned mid-fill the moment higher work appears — a 100k-epoch job
  queues forever behind live ``/v1/verify`` traffic, never in front of
  it. ``submit(..., low_priority=True)`` remains the low-lane spelling.
- **fairness** inside the interactive lane is deficit round-robin across
  per-tenant sub-queues (`serve/qos.py::FairQueue`): one hot client's
  backlog no longer monopolizes batch assembly — tenants take turns,
  FIFO within each tenant, exact FIFO overall when only one tenant is
  talking.

The batcher owns one assembly thread; the flush callback may optionally be
dispatched to a shared executor so batch *assembly* overlaps batch
*execution* (the service's worker pool).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Optional

from ipc_proofs_tpu_torch.obs.trace import current_context
from ipc_proofs_tpu_torch.serve.qos import FairQueue
from ipc_proofs_tpu_torch.utils.deadline import CancelledError, DeadlineError
from ipc_proofs_tpu_torch.utils.metrics import Metrics
from ipc_proofs_tpu_torch.utils.lockdep import named_condition

__all__ = [
    "DeadlineExceededError",
    "MicroBatcher",
    "PendingResult",
    "QueueFullError",
    "ServiceClosedError",
]


class QueueFullError(RuntimeError):
    """Admission queue is full; retry after ``retry_after_s`` seconds."""

    def __init__(self, retry_after_s: float):
        super().__init__(
            f"admission queue full; retry after {retry_after_s:.3f}s"
        )
        self.retry_after_s = retry_after_s


class ServiceClosedError(RuntimeError):
    """The service is draining or stopped; no new requests are admitted."""


class DeadlineExceededError(DeadlineError):
    """The request's deadline passed before it could be processed.

    Subclasses `utils.deadline.DeadlineError`, so it carries
    ``error_type == "deadline"`` and every typed-deadline door (504
    mapping, IPBS in-band abort, scatter merge) renders it uniformly."""


class PendingResult:
    """A slot for one request's eventual result (a minimal future).

    ``threading.Event`` + result/error pair rather than
    `concurrent.futures.Future` so completion stays allocation-light and
    the batcher controls exactly who may complete it.

    Carries the submitter's `TraceContext` (``trace_ctx``) across the
    queue hop so batch execution can parent its spans into the request's
    trace, and the dispatch instant (``dispatched_at``) so the per-request
    ``server_timing`` breakdown can attribute pure queue wait separately
    from batch execution.
    """

    __slots__ = (
        "payload",
        "deadline",
        "enqueued_at",
        "dispatched_at",
        "trace_ctx",
        "tenant",
        "cancel_scope",
        "_done",
        "_result",
        "_error",
    )

    def __init__(self, payload, deadline: Optional[float], enqueued_at: float):
        self.payload = payload
        self.deadline = deadline  # absolute time.monotonic() instant, or None
        self.enqueued_at = enqueued_at
        self.dispatched_at: Optional[float] = None
        self.trace_ctx = None  # obs.trace.TraceContext captured at submit
        self.tenant: Optional[str] = None  # sanitized accounting label
        # utils.deadline.CancelScope carried across the queue hop: the
        # batcher drops cancelled members at dispatch time and batch
        # execution installs it so chunk/stage checkpoints fire
        self.cancel_scope = None
        self._done = threading.Event()
        self._result = None
        self._error: Optional[BaseException] = None

    def complete(self, result) -> None:
        self._result = result
        self._done.set()

    def fail(self, error: BaseException) -> None:
        self._error = error
        self._done.set()

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None):
        """Block until the request completes; raise its error if it failed."""
        if not self._done.wait(timeout):
            raise TimeoutError("request not complete within wait timeout")
        if self._error is not None:
            raise self._error
        return self._result


class MicroBatcher:
    """Coalesce individual submissions into bounded, deadline-aware batches.

    ``flush_fn(batch)`` receives a non-empty ``list[PendingResult]`` and
    must complete (or fail) every element. If it raises instead, the
    batcher fails every still-pending element with that exception — a
    buggy flush can never strand callers in ``result()`` forever.
    """

    def __init__(
        self,
        flush_fn: Callable[[list[PendingResult]], None],
        max_batch: int = 32,
        max_wait_ms: float = 4.0,
        capacity: int = 256,
        name: str = "batch",
        metrics: Optional[Metrics] = None,
        executor=None,
        tenant_weights: Optional[dict] = None,
    ):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self._flush_fn = flush_fn
        self._max_batch = max_batch
        self._max_wait_s = max_wait_ms / 1000.0
        self._capacity = capacity
        self._name = name
        self._metrics = metrics if metrics is not None else Metrics()
        self._executor = executor
        self._cond = named_condition("MicroBatcher._cond")
        # interactive lane: deficit-round-robin across tenant sub-queues
        # (per-tenant quanta from --tenant-weight; unlisted tenants = 1)
        self._queue: FairQueue = FairQueue(weights=tenant_weights)  # guarded-by: _cond
        # push lane (standing-query fan-out): drained FIRST, greedily
        self._push: deque[PendingResult] = deque()  # guarded-by: _cond
        # low-priority lane (backfill windows): drained only when both
        # other lanes are empty, bounded by the same capacity
        self._low: deque[PendingResult] = deque()  # guarded-by: _cond
        self._closed = False  # guarded-by: _cond
        # EWMA of recent flush wall times, seeding the retry-after hint for
        # rejected requests: "queue depth / batch size" flushes still ahead
        # of you, each costing roughly this long
        self._avg_flush_s = self._max_wait_s  # guarded-by: _cond
        self._thread = threading.Thread(
            target=self._run, name=f"micro-batcher-{name}", daemon=True
        )
        self._thread.start()

    # --- admission ---------------------------------------------------------

    def submit(
        self,
        payload,
        timeout_s: Optional[float] = None,
        tenant: Optional[str] = None,
        low_priority: bool = False,
        lane: Optional[str] = None,
        cancel_scope=None,
    ) -> PendingResult:
        """Admit one request; never blocks.

        Raises `ServiceClosedError` after `close()`, `QueueFullError` when
        the bounded lane is at capacity. ``lane`` is ``"push"`` |
        ``"interactive"`` (default) | ``"low"``; ``low_priority=True``
        remains the low-lane spelling. ``tenant`` keys the interactive
        lane's deficit-round-robin sub-queue (untenanted requests share
        one round-robin slot). ``cancel_scope`` rides the queue hop: a
        member whose scope is cancelled by dispatch time is dropped
        (typed) without spending batch capacity.
        """
        if lane is None:
            lane = "low" if low_priority else "interactive"
        if lane not in ("push", "interactive", "low"):
            raise ValueError(f"unknown batcher lane {lane!r}")
        now = time.monotonic()
        deadline = (now + timeout_s) if timeout_s is not None else None
        with self._cond:
            if self._closed:
                self._metrics.count(f"serve.rejected_closed.{self._name}")
                raise ServiceClosedError(f"{self._name} batcher is draining")
            q = {"push": self._push, "interactive": self._queue, "low": self._low}[lane]
            if len(q) >= self._capacity:
                self._metrics.count(f"serve.rejected_full.{self._name}")
                batches_ahead = max(1, len(q) // self._max_batch)
                raise QueueFullError(
                    retry_after_s=max(0.001, batches_ahead * self._avg_flush_s)
                )
            pending = PendingResult(payload, deadline, now)
            pending.trace_ctx = current_context()
            pending.tenant = tenant
            pending.cancel_scope = cancel_scope
            q.append(pending)
            if lane == "low":
                self._metrics.set_gauge(
                    f"serve.queue_depth_low.{self._name}", len(self._low)
                )
                self._metrics.count(f"serve.accepted_low.{self._name}")
            elif lane == "push":
                self._metrics.set_gauge(
                    f"serve.queue_depth_push.{self._name}", len(self._push)
                )
                self._metrics.count(f"serve.accepted_push.{self._name}")
            else:
                self._metrics.set_gauge(
                    f"serve.queue_depth.{self._name}", len(self._queue)
                )
                self._metrics.set_gauge(
                    "qos.tenant_queues", self._queue.tenants()
                )
                self._metrics.count(f"serve.accepted.{self._name}")
            self._cond.notify_all()
        return pending

    def depth(self) -> int:
        with self._cond:
            return len(self._queue)

    def low_depth(self) -> int:
        with self._cond:
            return len(self._low)

    # --- batch assembly ----------------------------------------------------

    def _run(self) -> None:
        while True:
            with self._cond:
                while (
                    not self._push
                    and not self._queue
                    and not self._low
                    and not self._closed
                ):
                    self._cond.wait()
                if (
                    not self._push
                    and not self._queue
                    and not self._low
                    and self._closed
                ):
                    return
                if self._push:
                    # push lane first, assembled greedily: a standing-query
                    # fan-out never waits a batching window
                    batch = [self._push.popleft()]
                    while self._push and len(batch) < self._max_batch:
                        batch.append(self._push.popleft())
                    self._metrics.set_gauge(
                        f"serve.queue_depth_push.{self._name}", len(self._push)
                    )
                elif self._queue:
                    # interactive lane: members pop in deficit-round-robin
                    # order, so the window opens at the FIRST POPPED
                    # member's arrival — a request's queueing latency is
                    # bounded by max_wait plus however many fair-share
                    # turns its own tenant's backlog costs it (that wait
                    # is the fairness, not a regression)
                    batch = [self._queue.popleft()]
                    window_end = batch[0].enqueued_at + self._max_wait_s
                    while len(batch) < self._max_batch:
                        if self._queue:
                            batch.append(self._queue.popleft())
                            continue
                        remaining = window_end - time.monotonic()
                        if remaining <= 0 or self._closed:
                            break
                        self._cond.wait(remaining)
                        if not self._queue and (
                            self._closed or time.monotonic() >= window_end
                        ):
                            break
                    self._metrics.set_gauge(
                        f"serve.queue_depth.{self._name}", len(self._queue)
                    )
                    self._metrics.set_gauge(
                        "qos.tenant_queues", self._queue.tenants()
                    )
                else:
                    # low lane: only reached with both other lanes EMPTY,
                    # assembled greedily (no wait window — waiting would
                    # delay any interactive arrival), and abandoned
                    # mid-fill the moment higher-priority work appears
                    batch = [self._low.popleft()]
                    while (
                        self._low
                        and len(batch) < self._max_batch
                        and not self._queue
                        and not self._push
                    ):
                        batch.append(self._low.popleft())
                    self._metrics.set_gauge(
                        f"serve.queue_depth_low.{self._name}", len(self._low)
                    )
            self._dispatch(batch)

    def _dispatch(self, batch: list[PendingResult]) -> None:
        now = time.monotonic()
        with self._cond:
            est_flush_s = self._avg_flush_s
        live: list[PendingResult] = []
        for pending in batch:
            pending.dispatched_at = now
            scope = pending.cancel_scope
            if scope is not None and scope.cancelled:
                # abandoned while queued: drop it HERE, before it costs a
                # worker anything — the whole flush estimate is reclaimed
                self._metrics.count("serve.cancelled_inflight")
                self._metrics.count(
                    "deadline.reclaimed_ms", max(1, int(est_flush_s * 1000.0))
                )
                pending.fail(
                    CancelledError(
                        scope.reason or "request cancelled while queued"
                    )
                )
            elif pending.deadline is not None and now > pending.deadline:
                self._metrics.count(f"serve.deadline_exceeded.{self._name}")
                self._metrics.count("serve.deadline_rejects")
                self._metrics.count("deadline.rejects.batcher")
                pending.fail(
                    DeadlineExceededError(
                        f"deadline exceeded after "
                        f"{now - pending.enqueued_at:.3f}s in queue"
                    )
                )
            elif (
                pending.deadline is not None
                and pending.deadline - now < est_flush_s * 0.5
            ):
                # remaining budget cannot plausibly cover even half a
                # typical flush: refuse typed rather than produce an
                # answer after the client stopped waiting
                self._metrics.count(f"serve.deadline_exceeded.{self._name}")
                self._metrics.count("serve.deadline_rejects")
                self._metrics.count("deadline.rejects.batcher")
                pending.fail(
                    DeadlineExceededError(
                        "remaining budget %.0fms below batch execution floor"
                        % ((pending.deadline - now) * 1000.0)
                    )
                )
            else:
                live.append(pending)
        if not live:
            return
        self._metrics.observe(f"serve.batch_size.{self._name}", len(live))
        if self._executor is not None:
            self._executor.submit(self._flush, live)
        else:
            self._flush(live)

    def _flush(self, batch: list[PendingResult]) -> None:
        start = time.monotonic()
        try:
            self._flush_fn(batch)
        except BaseException as exc:  # fail-soft: strand no caller — the error reaches every waiter via pending.fail()
            for pending in batch:
                if not pending.done():
                    pending.fail(exc)
        finally:
            elapsed = time.monotonic() - start
            with self._cond:
                self._avg_flush_s = 0.8 * self._avg_flush_s + 0.2 * elapsed
            for pending in batch:
                if not pending.done():
                    pending.fail(
                        RuntimeError(
                            f"{self._name} flush returned without completing "
                            "this request (bug in flush_fn)"
                        )
                    )

    # --- shutdown ----------------------------------------------------------

    def close(self, drain: bool = True, timeout: Optional[float] = None) -> None:
        """Stop admitting. ``drain=True`` flushes everything accepted and
        joins the batcher thread; ``drain=False`` fails queued requests
        with `ServiceClosedError` (in-flight flushes still finish)."""
        with self._cond:
            self._closed = True
            if not drain:
                while self._queue:
                    self._queue.popleft().fail(
                        ServiceClosedError(f"{self._name} batcher stopped")
                    )
                while self._push:
                    self._push.popleft().fail(
                        ServiceClosedError(f"{self._name} batcher stopped")
                    )
                while self._low:
                    self._low.popleft().fail(
                        ServiceClosedError(f"{self._name} batcher stopped")
                    )
            self._cond.notify_all()
        self._thread.join(timeout)

    @property
    def closed(self) -> bool:
        with self._cond:
            return self._closed
