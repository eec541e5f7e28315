"""The host stage pipeline of the range drivers.

The counterpart of the host half of ``ipc_proofs_tpu.parallel.pipeline``:

1. `PipelineStage` / `run_pipeline`: a bounded-queue, order-preserving,
   multi-worker staged executor for the chunked proof drivers. Stage k+1
   of chunk i runs concurrently with stage k of chunk i+1 (scan ∥ record ∥
   merge ∥ verify), each stage with its own worker count, with
   backpressure (``depth`` buffered results per inter-stage queue) so a
   fast scan can't balloon memory ahead of a slow record, and fail-fast
   cancellation: the first worker exception cancels all pending work and
   re-raises in the caller. The caller's `utils.deadline.CancelScope` hops
   to every stage worker; the reference's trace context waits for the
   port's ``obs/`` (ROADMAP Queue 1 item 5).
2. `MatchCoalescer`: concurrent scan workers' fingerprint-mask calls on the
   unfused path combine into one call on the card.

The device match pipelines (``match_pipeline``, ``sharded_match_pipeline``,
``EventBatch``) wait for the multi-device slice (ROADMAP Queue 1 item 4).
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence

import numpy as np

from ipc_proofs_tpu_torch.utils.deadline import current_scope, use_scope
from ipc_proofs_tpu_torch.utils.lockdep import named_lock

__all__ = ["MatchCoalescer", "PipelineStage", "run_pipeline"]


# --------------------------------------------------------------------------
# device-call coalescing across concurrent pipeline workers
# --------------------------------------------------------------------------


class _MatchReq:
    """One worker's parked fp-match request inside a `MatchCoalescer`."""

    __slots__ = ("fp", "n_topics", "emitters", "valid", "key", "done", "result", "exc")

    def __init__(self, fp, n_topics, emitters, valid, key):
        self.fp = fp
        self.n_topics = n_topics
        self.emitters = emitters
        self.valid = valid
        self.key = key  # (topic0, topic1, actor_id) — only equal keys combine
        self.done = threading.Event()
        self.result = None
        self.exc: Optional[BaseException] = None


class MatchCoalescer:
    """Combine concurrent ``event_match_mask_fp`` calls from in-flight scan
    workers into one larger device call.

    Leader-based combining with NO added latency window: every caller
    parks its request, then queues on the device lock. Whoever gets the
    lock claims everything parked so far and issues one concatenated call
    for each distinct (topic0, topic1, actor) key; callers whose request
    was serviced by an earlier leader skip the call entirely. While a
    leader is inside the device call, later arrivals pile up behind the
    lock — so batches grow exactly when the device is the bottleneck and
    a lone call proceeds immediately.

    Bit-identity: the fp predicate is elementwise per event, so a mask
    computed over a concatenation, split back at the input offsets,
    equals the per-request masks — same contract the sharded device
    pipeline relies on. Counted as ``range_match_coalesced`` (requests
    that rode another caller's device call).

    Dispatch discipline: every batch goes to the card at its own length.
    (The reference pads each dispatch to a power-of-two bucket so that XLA
    traces O(log n) shapes; the port's eager mask compiles nothing per
    shape, so padding would only copy filler rows.)
    """

    def __init__(self, backend, metrics=None):
        self._backend = backend
        self._metrics = metrics
        self._lock = named_lock("MatchCoalescer._lock")
        self._call_lock = named_lock("MatchCoalescer._call_lock")  # serializes device dispatch
        self._pending: "list[_MatchReq]" = []  # guarded-by: _lock

    def match_fp(self, fp, n_topics, emitters, valid, topic0, topic1, actor_id):
        """Drop-in for ``backend.event_match_mask_fp`` (same signature,
        same return contract: a mask at least as long as the input)."""
        req = _MatchReq(fp, n_topics, emitters, valid, (topic0, topic1, actor_id))
        with self._lock:
            self._pending.append(req)
        # lock-order: MatchCoalescer._call_lock < MatchCoalescer._lock
        with self._call_lock:
            if req.done.is_set():
                batch: "list[_MatchReq]" = []
            else:
                with self._lock:
                    batch = self._pending
                    self._pending = []
            if batch:
                self._run(batch)
        if req.exc is not None:
            raise req.exc
        return req.result

    def _run(self, batch: "list[_MatchReq]") -> None:
        groups: "dict[tuple, list[_MatchReq]]" = {}
        for r in batch:
            groups.setdefault(r.key, []).append(r)
        for key, reqs in groups.items():
            topic0, topic1, actor_id = key
            try:
                if len(reqs) == 1:
                    r = reqs[0]
                    fp, n_topics, emitters, valid = (
                        r.fp, r.n_topics, r.emitters, r.valid,
                    )
                else:
                    fp = np.concatenate([r.fp for r in reqs])
                    n_topics = np.concatenate([r.n_topics for r in reqs])
                    emitters = np.concatenate([r.emitters for r in reqs])
                    valid = np.concatenate([r.valid for r in reqs])
                out = self._backend.event_match_mask_fp(
                    fp, n_topics, emitters, valid, topic0, topic1, actor_id
                )
                off = 0
                for r in reqs:
                    n = len(r.fp)
                    r.result = out[off : off + n]
                    off += n
                if self._metrics is not None and len(reqs) > 1:
                    self._metrics.count("range_match_coalesced", len(reqs) - 1)
            except BaseException as exc:  # fail-soft: every parked waiter re-raises this from its own match_fp call — nothing is swallowed
                for r in reqs:
                    r.exc = exc
            finally:
                for r in reqs:
                    r.done.set()


# --------------------------------------------------------------------------
# host stage pipeline: bounded-queue, order-preserving staged executor
# --------------------------------------------------------------------------


@dataclass
class PipelineStage:
    """One stage of a host pipeline: ``fn(item) -> result`` applied by
    ``workers`` threads. Results are forwarded downstream in INPUT order
    regardless of worker completion order, so a multi-worker stage feeding
    an order-sensitive consumer (e.g. chunk-ordered claim emission) stays
    deterministic. ``metrics_stage``, if set, times every ``fn`` call under
    that `Metrics` stage name (the caller passes the `Metrics` to
    `run_pipeline`).

    ``drain_on_cancel``: when another stage's failure cancels the
    pipeline, this stage's queued-but-unclaimed inputs still run
    (inline, best-effort, exceptions swallowed) before the original
    exception re-raises in the caller. For a stage whose ``fn`` has
    durable side effects — e.g. the range driver's record stage
    journaling completed chunks — this salvages work upstream stages
    already paid for, so a resume after the abort doesn't redo it.
    Results are discarded; only the side effects matter."""

    name: str
    fn: Callable[[Any], Any]
    workers: int = 1
    metrics_stage: Optional[str] = None
    drain_on_cancel: bool = False


class _Cancel:
    """First-exception-wins cancellation token shared by every worker."""

    __slots__ = ("_event", "_lock", "exc")

    def __init__(self):
        self._event = threading.Event()
        self._lock = named_lock("_Cancel._lock")
        self.exc: Optional[BaseException] = None  # guarded-by: _lock

    def fail(self, exc: BaseException) -> None:
        with self._lock:
            if self.exc is None:
                self.exc = exc
        self._event.set()

    def is_set(self) -> bool:
        return self._event.is_set()


_STOP = object()  # end-of-stream sentinel (one per downstream worker)
_POLL_S = 0.05  # queue poll granularity; bounds cancellation latency


def _put(q: "queue.Queue", item, cancel: _Cancel) -> bool:
    """Blocking put that aborts (returns False) once the pipeline cancels —
    no worker can stay wedged against a full queue whose consumer died."""
    while not cancel.is_set():
        try:
            q.put(item, timeout=_POLL_S)
            return True
        except queue.Full:
            continue
    return False


def _get(q: "queue.Queue", cancel: _Cancel):
    while not cancel.is_set():
        try:
            return q.get(timeout=_POLL_S)
        except queue.Empty:
            continue
    return _STOP


class _OrderedEmitter:
    """Reorder buffer between a stage's workers and the next queue: workers
    finish out of order, downstream receives strict input order. Emitting a
    result may block on the bounded downstream queue — that IS the
    backpressure (at most ``depth`` results buffered ahead of the
    consumer, plus what the workers hold in flight)."""

    def __init__(self, n_items: int, out_q: "queue.Queue", n_stops: int, cancel: _Cancel):
        self._lock = named_lock("_OrderedEmitter._lock")
        self._buffer: dict[int, Any] = {}  # guarded-by: _lock
        self._next = 0  # guarded-by: _lock
        self._n = n_items
        self._out_q = out_q
        self._n_stops = n_stops  # sentinels owed downstream (0 = caller-consumed)
        self._cancel = cancel

    def emit(self, seq: int, value) -> bool:
        with self._lock:
            self._buffer[seq] = value
            while self._next in self._buffer:
                if not _put(self._out_q, (self._next, self._buffer.pop(self._next)), self._cancel):
                    return False
                self._next += 1
            if self._next == self._n:
                for _ in range(self._n_stops):
                    if not _put(self._out_q, _STOP, self._cancel):
                        return False
        return True


def _stage_worker(
    stage: PipelineStage, in_q, emit, cancel: _Cancel, metrics, cancel_scope=None,
) -> None:
    with use_scope(cancel_scope):
        while True:
            task = _get(in_q, cancel)
            if task is _STOP:
                return
            seq, item = task
            try:
                # stage boundary = cancellation boundary: an abandoned or
                # expired request stops consuming workers before the next
                # stage fn runs (checkpoints inside fns fire too — the
                # ambient scope is installed on this worker thread)
                if cancel_scope is not None:
                    cancel_scope.check(stage=f"pipeline.{stage.name}")
                if metrics is not None and stage.metrics_stage:
                    with metrics.stage(stage.metrics_stage):
                        result = stage.fn(item)
                else:
                    result = stage.fn(item)
            except BaseException as exc:  # fail-soft: worker strands no one — the failure cancels the pipeline and re-raises in the driver
                cancel.fail(exc)
                return
            if not emit(seq, result):
                return


def run_pipeline(
    items: Sequence,
    stages: Sequence[PipelineStage],
    depth: int = 2,
    metrics=None,
) -> list:
    """Run every item through ``stages`` with inter-stage overlap: item i's
    stage k+1 runs while item i+1 is still in stage k. Returns the final
    stage's results in input order.

    - Each inter-stage queue buffers at most ``depth`` completed results;
      peak memory is ~``depth + workers`` items per stage, regardless of
      ``len(items)``.
    - A worker exception cancels the whole pipeline (pending work is
      dropped, in-flight work is abandoned at the next queue operation)
      and re-raises the ORIGINAL exception in the caller — never a
      deadlock (tests/test_torch_pipeline.py).
    - ``metrics``: a `Metrics` whose ``stage(...)`` times each stage's
      ``fn`` calls under the stage's ``metrics_stage`` name (thread-safe;
      overlapped stages report busy + union wall separately).
    """
    items = list(items)
    stages = list(stages)
    if not stages:
        raise ValueError("run_pipeline needs at least one stage")
    n = len(items)
    if n == 0:
        return []
    depth = max(1, int(depth))
    cancel = _Cancel()
    queues: list[queue.Queue] = [queue.Queue(maxsize=depth) for _ in range(len(stages) + 1)]

    # the caller's CancelScope hops the bounded queues with the work: every
    # stage worker re-installs it and checks it at each stage boundary, so
    # a cancelled/expired request tears the whole pipeline down typed
    cancel_scope = current_scope()

    threads: list[threading.Thread] = []
    for i, stage in enumerate(stages):
        workers = max(1, int(stage.workers))
        # sentinels owed to the NEXT stage's workers; the final queue is
        # consumed by the caller, who counts results instead
        n_stops = max(1, int(stages[i + 1].workers)) if i + 1 < len(stages) else 0
        emitter = _OrderedEmitter(n, queues[i + 1], n_stops, cancel)
        for w in range(workers):
            t = threading.Thread(
                target=_stage_worker,
                args=(stage, queues[i], emitter.emit, cancel, metrics, cancel_scope),
                name=f"pipeline-{stage.name}-{w}",
                daemon=True,
            )
            threads.append(t)
            t.start()

    def _feed():
        for seq, item in enumerate(items):
            if not _put(queues[0], (seq, item), cancel):
                return
        for _ in range(max(1, int(stages[0].workers))):
            if not _put(queues[0], _STOP, cancel):
                return

    feeder = threading.Thread(target=_feed, name="pipeline-feeder", daemon=True)
    feeder.start()

    results: list = []
    final_q = queues[-1]
    while len(results) < n:
        task = _get(final_q, cancel)
        if task is _STOP:  # cancelled mid-stream
            break
        _seq, value = task
        results.append(value)  # emitters guarantee seq order

    feeder.join()
    for t in threads:
        t.join()
    if cancel.exc is not None:
        _drain_cancelled(stages, queues)
        raise cancel.exc
    return results


def _drain_cancelled(stages: "list[PipelineStage]", queues: "list[queue.Queue]") -> None:
    """Post-cancellation salvage: run ``drain_on_cancel`` stages' queued
    inputs inline (all workers have exited, so the queues are frozen).
    Best-effort — a drain failure must not mask the original exception."""
    for i, stage in enumerate(stages):
        if not stage.drain_on_cancel:
            continue
        q = queues[i]
        while True:
            try:
                task = q.get_nowait()
            except queue.Empty:
                break
            if task is _STOP:
                continue
            _seq, item = task
            try:
                stage.fn(item)
            except BaseException:  # fail-soft: drain-after-cancel salvage — the original failure is already propagating to the driver
                pass
