"""Durable admission queue: serve requests journaled before ACK.

The counterpart of ``ipc_proofs_tpu.serve.durable``, record for record: a
queue directory written by either package resumes in the other. A bare
service loses every queued request on restart; this wraps
`ProofService` with the jobs journal (`jobs.journal`) so
an accepted request survives process death:

- **admit record** appended (fsync'd) BEFORE the request executes — the
  client's ACK therefore implies durable intent;
- **done record** appended with the rendered result once the batcher
  answers — replay skips finished work and serves retried clients from
  the cache;
- on restart, admits without a matching done **re-execute** through the
  fresh service (``serve.requests_replayed`` counter; `/healthz` reports
  ``resumed_jobs`` / ``journal_bytes``).

Idempotency keys: a client that retries a timed-out request with the
same ``idempotency_key`` gets the cached result instead of a second
execution; concurrent duplicates coalesce onto one in-flight execution.
Keys are client-chosen; omitted keys get a server-generated UUID (no
dedup across retries — the key IS the dedup handle). The result cache is
byte-bounded (`_ResultCache`): hot payloads live in an LRU capped by
``results_max_bytes`` and cold ones are re-read from their own ``done``
frame in the journal, so dedup survives restart without unbounded RSS.

At-least-once semantics: a request that failed *admission* (queue full /
draining / deadline) keeps its admit record but writes no done record —
the next restart re-executes it. Semantic failures (bad request) write a
done-with-error record so a poison request can't crash-loop the replay.

Device faults (`ops.build.is_device_fault`: a kernel or launch fault of
the card, the verify lane's `VerifyLaneError`, CUDA out of memory) are
never a request's result: like an admission failure the admit stays
pending for replay and the fault re-raises to the caller, and a device
fault during the replay at open raises out of the constructor instead of
journaling as the request's error.

Journal I/O is fail-soft end-to-end (`JournalWriter` degrades to
in-memory on ENOSPC/EROFS with ``jobs.journal_failures``): the service
keeps answering, it just stops being able to resume.

Streaming contract: the journal always stores the PLAIN canonical
result object — never a stream framing and never a compressed/delta
witness encoding. A streamed response (``"stream": true``) re-encodes
from the journaled plain bundle at send time (`_stream_durable` in the
HTTP layer), so an idempotent retry may freely switch between buffered
and streamed transports, or between witness encodings, and always
reassembles byte-identical canonical fields from the same done record.
"""

from __future__ import annotations

import os
import threading
import time
import uuid
from collections import OrderedDict
from typing import Any, Optional, Sequence

from ipc_proofs_tpu_torch.ops.build import is_device_fault
from ipc_proofs_tpu_torch.jobs.journal import (
    JournalError,
    JournalWriter,
    encode_record,
    read_journal_entries,
    read_record_at,
)
from ipc_proofs_tpu_torch.proofs.bundle import UnifiedProofBundle
from ipc_proofs_tpu_torch.utils.threads import locked
from ipc_proofs_tpu_torch.serve.batcher import (
    QueueFullError,
    ServiceClosedError,
)
from ipc_proofs_tpu_torch.utils.deadline import DeadlineError, current_scope
from ipc_proofs_tpu_torch.utils.log import get_logger
from ipc_proofs_tpu_torch.utils.lockdep import named_lock

__all__ = ["DurableAdmission", "QUEUE_JOURNAL_NAME"]

QUEUE_JOURNAL_NAME = "queue.bin"

logger = get_logger(__name__)

# admission-layer failures: the request never (finishably) executed, so
# its admit record stays pending and the next restart re-executes it.
# DeadlineError covers the batcher's DeadlineExceededError plus every
# propagated deadline/cancel hop (rpc retry, range chunk, pipeline
# stage) — a budget that ran out must NOT journal as a durable error, or
# an idempotent retry with fresh budget would be served the stale failure
_ADMISSION_ERRORS = (QueueFullError, ServiceClosedError, DeadlineError)


class _Inflight:
    __slots__ = ("event", "result", "error")

    def __init__(self):
        self.event = threading.Event()
        self.result: Optional[dict] = None
        self.error: Optional[BaseException] = None


class _ResultCache:
    """Completed-request results: bounded hot LRU over a journal spill.

    The ``done`` record every result already writes to ``queue.bin`` IS
    the disk copy — this cache never writes a second one. In memory it
    keeps only ``key → frame offset`` plus a byte-bounded hot LRU of
    payloads, so idempotency dedup survives restart while RSS stays
    bounded no matter how many requests the process has answered.

    A spilled hit re-reads its frame through `read_record_at`
    (CRC-verified); a corrupt or unreadable frame drops the entry
    fail-soft and the caller re-executes the request (at-least-once) —
    the cache never serves bytes the journal can't vouch for.
    """

    def __init__(self, path: str, max_bytes: int, metrics=None):
        self._path = path
        self._max_bytes = max(1, int(max_bytes))
        self._metrics = metrics
        self._lock = named_lock("_ResultCache._lock")
        # offset None = result was never durably framed (degraded journal):
        # once it ages out of the hot tier it is gone and re-executes
        self._offsets: "dict[str, Optional[int]]" = {}  # guarded-by: _lock
        # key → (payload, encoded size); coldest first
        self._hot: "OrderedDict[str, tuple]" = OrderedDict()  # guarded-by: _lock
        self._hot_bytes = 0  # guarded-by: _lock

    def seed(self, key: str, offset: int) -> None:
        """Index a replayed done record without loading its payload."""
        with self._lock:
            self._offsets[key] = offset

    def put(self, key: str, offset: "Optional[int]", payload: dict) -> None:
        with self._lock:
            self._offsets[key] = offset
            self._insert_hot_locked(key, payload)

    @locked
    def _insert_hot_locked(self, key: str, payload: dict) -> None:
        size = len(encode_record(payload))
        old = self._hot.pop(key, None)
        if old is not None:
            self._hot_bytes -= old[1]
        if size <= self._max_bytes:
            self._hot[key] = (payload, size)
            self._hot_bytes += size
        evicted = 0
        while self._hot_bytes > self._max_bytes and self._hot:
            _, (_, esize) = self._hot.popitem(last=False)
            self._hot_bytes -= esize
            evicted += 1
        metrics = self._metrics
        if metrics is not None:
            if evicted:
                metrics.count("serve.result_cache_evictions", evicted)
            metrics.set_gauge("serve.result_cache_bytes", self._hot_bytes)

    def get(self, key: str) -> Optional[dict]:
        with self._lock:
            entry = self._hot.get(key)
            if entry is not None:
                self._hot.move_to_end(key)
                return entry[0]
            if key not in self._offsets:
                return None
            offset = self._offsets[key]
        if offset is None:
            return None
        try:
            rec = read_record_at(self._path, offset)
        except (JournalError, OSError) as exc:
            logger.warning(
                "result cache: spilled frame for %s unreadable (%s) — "
                "dropping entry; the request will re-execute", key, exc,
            )
            self._drop(key, offset)
            return None
        if not isinstance(rec, dict) or rec.get("key") != key:
            logger.warning(
                "result cache: frame at %d does not belong to %s — "
                "dropping entry; the request will re-execute", offset, key,
            )
            self._drop(key, offset)
            return None
        payload = rec.get("payload")
        with self._lock:
            self._insert_hot_locked(key, payload)
        return payload

    def _drop(self, key: str, offset: "Optional[int]") -> None:
        with self._lock:
            if self._offsets.get(key) == offset:
                del self._offsets[key]

    def __contains__(self, key: str) -> bool:
        with self._lock:
            return key in self._offsets

    def __len__(self) -> int:
        with self._lock:
            return len(self._offsets)

    def hot_bytes(self) -> int:
        with self._lock:
            return self._hot_bytes


class DurableAdmission:
    """Journal-backed idempotent request layer over one `ProofService`."""

    def __init__(
        self,
        service,
        queue_dir: str,
        pairs: Sequence = (),
        metrics=None,
        replay: bool = True,
        results_max_bytes: int = 64 * 1024 * 1024,
    ):
        self.service = service
        self.pairs = list(pairs)
        self.metrics = metrics if metrics is not None else service.metrics
        os.makedirs(queue_dir, exist_ok=True)
        self._path = os.path.join(queue_dir, QUEUE_JOURNAL_NAME)
        self._lock = named_lock("DurableAdmission._lock")
        # serializes journal appends AND makes (offset, append) atomic so a
        # done record's spill offset is exact even under concurrent submits
        self._jlock = named_lock("DurableAdmission._jlock")
        self._results = _ResultCache(
            self._path, results_max_bytes, metrics=self.metrics
        )
        self._inflight: "dict[str, _Inflight]" = {}  # guarded-by: _lock
        self.resumed_jobs = 0  # admitted-but-unfinished requests re-executed

        pending: "list[dict]" = []
        if os.path.exists(self._path):
            entries, good_offset, torn = read_journal_entries(self._path)
            if torn:
                logger.warning(
                    "serve queue journal %s has a torn tail — truncating to "
                    "%d bytes", self._path, good_offset,
                )
                with open(self._path, "r+b") as fh:
                    fh.truncate(good_offset)
                    fh.flush()
                    os.fsync(fh.fileno())
            admits: "dict[str, dict]" = {}
            order: "list[str]" = []
            for pos, (rec, offset, _end) in enumerate(entries):
                if not isinstance(rec, dict) or not isinstance(rec.get("key"), str):
                    raise JournalError(
                        f"malformed serve queue record {pos} in {self._path}"
                    )
                kind = rec.get("t")
                if kind == "admit":
                    if rec["key"] not in admits:
                        admits[rec["key"]] = rec
                        order.append(rec["key"])
                elif kind == "done":
                    # index only — the payload stays on disk until asked for
                    self._results.seed(rec["key"], offset)
                else:
                    raise JournalError(
                        f"unknown serve queue record type {kind!r} ({pos})"
                    )
            pending = [admits[k] for k in order if k not in self._results]
        self._writer = JournalWriter(self._path, metrics=self.metrics)
        if replay and pending:
            self._replay(pending)

    # --- restart replay ----------------------------------------------------

    def _replay(self, pending: "list[dict]") -> None:
        for rec in pending:
            self.resumed_jobs += 1
            self.metrics.count("serve.requests_replayed")
            key, kind, payload = rec["key"], rec["kind"], rec["payload"]
            try:
                result = self._execute(
                    kind, payload, timeout_s=None, tenant=rec.get("tenant")
                )
                done = {"ok": True, "result": result}
            except Exception as exc:  # fail-soft: replay must terminate — a poison request journals as an error result, not a restart crash-loop
                if is_device_fault(exc):
                    # the card failed, not the request: leave the admit
                    # pending and refuse to come up on a faulty device
                    self._writer.close()
                    raise
                # any other failure (even admission) finishes with an error
                # here: a poison request must not crash-loop every restart
                done = {"ok": False, "error": f"{type(exc).__name__}: {exc}"}
            self._finish(key, done)

    # --- execution ---------------------------------------------------------

    def _execute(
        self,
        kind: str,
        payload: Any,
        timeout_s: "float | None",
        tenant: "str | None" = None,
    ) -> dict:
        # the HTTP layer installs the request's CancelScope as ambient
        # before calling submit(); forwarding it into the batcher keeps
        # cooperative cancellation working through the durable hop (replay
        # runs scope-less: current_scope() is None on the restart thread)
        scope = current_scope()
        if kind == "verify":
            bundle = UnifiedProofBundle.from_json_obj(payload)
            resp = self.service.verify(
                bundle, timeout_s=timeout_s, tenant=tenant, cancel_scope=scope
            )
            return {
                "storage_results": resp.storage_results,
                "event_results": resp.event_results,
                "all_valid": resp.all_valid(),
                "batch_size": resp.batch_size,
                "trace_id": resp.trace_id,
                "server_timing": dict(resp.server_timing),
            }
        if kind == "generate":
            if not isinstance(payload, int) or not (0 <= payload < len(self.pairs)):
                raise ValueError(
                    f"pair_index {payload!r} outside [0, {len(self.pairs)})"
                )
            resp = self.service.generate(
                self.pairs[payload],
                timeout_s=timeout_s,
                tenant=tenant,
                cancel_scope=scope,
            )
            return {
                "bundle": resp.bundle.to_json_obj(),
                "n_event_proofs": resp.n_event_proofs,
                "batch_size": resp.batch_size,
                "trace_id": resp.trace_id,
                "server_timing": dict(resp.server_timing),
            }
        if kind == "generate_range":
            if not isinstance(payload, dict):
                raise ValueError("generate_range payload must be an object")
            idxs = payload.get("pair_indexes")
            n = len(self.pairs)
            if (
                not isinstance(idxs, list)
                or not idxs
                or not all(
                    isinstance(i, int)
                    and not isinstance(i, bool)
                    and 0 <= i < n
                    for i in idxs
                )
            ):
                raise ValueError(
                    f"pair_indexes must be a non-empty list of ints in [0, {n})"
                )
            bundle = self.service.generate_range(
                [self.pairs[i] for i in idxs],
                chunk_size=payload.get("chunk_size"),
            )
            return {
                "bundle": bundle.to_json_obj(),
                "n_event_proofs": len(bundle.event_proofs),
                "n_pairs": len(idxs),
            }
        raise ValueError(f"unknown request kind {kind!r}")

    def _finish(self, key: str, done_payload: dict) -> None:
        with self._jlock:
            offset = self._writer.journal_bytes
            ok = self._writer.append(  # ipclint: disable=lock-held-blocking (durability: done-frames serialize under the journal lock)
                {"t": "done", "key": key, "payload": done_payload}
            )
        # a degraded (in-memory) append has no frame to point at — the hot
        # tier is then the only copy and the entry dies with eviction
        self._results.put(key, offset if ok else None, done_payload)
        with self._lock:
            flight = self._inflight.pop(key, None)
        if flight is not None:
            flight.result = done_payload
            flight.event.set()

    # --- public API --------------------------------------------------------

    def submit(
        self,
        kind: str,
        payload: Any,
        idempotency_key: "str | None" = None,
        timeout_s: "float | None" = None,
        tenant: "str | None" = None,
    ) -> "tuple[str, dict, bool]":
        """Admit one request; returns ``(key, done_payload, cached)``.

        ``done_payload`` is ``{"ok": True, "result": ...}`` or
        ``{"ok": False, "error": ...}``; ``cached`` is True when the
        answer came from the idempotency cache (or a concurrent duplicate
        execution) instead of a fresh one. Admission errors re-raise.
        """
        key = idempotency_key or f"auto-{uuid.uuid4().hex}"
        # fast path outside _lock: a spilled hit may touch disk
        hit = self._results.get(key)
        if hit is not None:
            self.metrics.count("serve.idempotent_hits")
            return key, hit, True
        with self._lock:
            flight = self._inflight.get(key)
            if flight is None:
                # re-check under _lock: _finish publishes the result before
                # dropping the inflight entry, so a miss-then-no-flight race
                # must look again before re-executing
                hit = self._results.get(key)
                if hit is not None:
                    self.metrics.count("serve.idempotent_hits")
                    return key, hit, True
                owner = True
                flight = self._inflight[key] = _Inflight()
            else:
                owner = False
        if not owner:
            # duplicate of an in-flight request: one execution, shared result
            flight.event.wait()
            self.metrics.count("serve.idempotent_hits")
            if flight.error is not None:
                raise flight.error
            return key, flight.result, True

        # durable intent BEFORE execution: the ACK implies the journal has it
        j0 = time.perf_counter()
        admit = {"t": "admit", "key": key, "kind": kind, "payload": payload}
        if tenant:
            admit["tenant"] = tenant
        with self._jlock:
            self._writer.append(admit)  # ipclint: disable=lock-held-blocking (durability: admit-frames serialize under the journal lock)
        journal_ms = round((time.perf_counter() - j0) * 1e3, 3)
        try:
            result = self._execute(kind, payload, timeout_s=timeout_s, tenant=tenant)
            # surface the admission fsync in this request's latency
            # breakdown (the done-record append overlaps the response)
            timing = result.get("server_timing")
            if isinstance(timing, dict):
                timing["journal_ms"] = journal_ms
        except Exception as exc:  # fail-soft: semantic failure — journalled as the request's durable (idempotent) error result
            if isinstance(exc, _ADMISSION_ERRORS) or is_device_fault(exc):
                # never executed (or the card failed it): leave the admit
                # pending for restart replay, release any coalesced waiters
                # with the same failure
                with self._lock:
                    self._inflight.pop(key, None)
                flight.error = exc
                flight.event.set()
                raise
            done = {"ok": False, "error": f"{type(exc).__name__}: {exc}"}
            self._finish(key, done)
            return key, done, False
        done = {"ok": True, "result": result}
        self._finish(key, done)
        return key, done, False

    # --- observability / lifecycle ----------------------------------------

    @property
    def journal_bytes(self) -> int:
        return self._writer.journal_bytes

    def health_fields(self) -> dict:
        """Merged into `/healthz` by the HTTP front end."""
        with self._lock:
            inflight = len(self._inflight)
        return {
            "durable_queue": True,
            "resumed_jobs": self.resumed_jobs,
            "journal_bytes": self.journal_bytes,
            "completed_requests": len(self._results),
            "result_cache_hot_bytes": self._results.hot_bytes(),
            "inflight_requests": inflight,
            "journal_degraded": self._writer.degraded,
        }

    def close(self) -> None:
        self._writer.close()
