"""Durable backfill jobs: prove deep history as a resumable batch job.

`BackfillEngine` answers "prove every matching event for this service's
filter over epochs [start, end)" as a first-class job rather than one
giant interactive request:

- **planning** — the range splits into epoch windows on ring arcs
  (`backfill/scheduler.py`); a `WorkAheadFeeder` primes the fetch
  plane's speculative lanes from the schedule so device-side batches
  never drain at window boundaries.
- **durability** — each job owns one IPJ1 write-ahead journal
  (`ipc_proofs_tpu_torch.jobs`): the manifest binds the directory to the
  exact request (spec + pair range + window size, the same
  ``_request_spec_repr`` discipline the chunked driver uses), and every
  completed window commits one fsync'd chunk record under its window
  index. A SIGKILL at any instant loses at most the in-flight windows;
  re-submitting the same range resumes from the journal and produces
  the same final bytes — window bundles are pure functions of their
  pairs, so replayed and regenerated windows are interchangeable.
- **streaming** — window bundles fold through
  `cluster/gather.py::BundleFold` (one CID map, one sort at seal) AND
  stream to the caller as verified chunks under monotonic cursors, the
  `subs/delivery.py` long-poll contract: polling from cursor N acks
  everything ≤ N (payloads dropped from memory; the journal keeps the
  bytes) and returns what's above it. The first chunk is available as
  soon as the first window commits — long before job completion.
- **priority** — the engine never executes proofs itself; it calls a
  ``run_window`` callable. The serve wiring passes the micro-batcher's
  LOW-priority lane (`ProofService.submit_range_window`), the cluster
  wiring the router's steal-aware dispatch, so a 100k-epoch job shares
  devices with interactive traffic instead of starving it.

Byte identity: the sealed result equals
`generate_event_proofs_for_range_chunked` over the same pairs for ANY
window size, shard count, or completion order — the gather merge law
(pair-ordered proof buckets + one sorted witness-CID union) is
partition-independent, which the differential grid in
``tests/test_torch_backfill.py`` pins against the reference.

The counterpart of ``ipc_proofs_tpu.backfill.engine``: the same job ids,
journals (a job directory written by either package resumes in the
other), chunks and sealed bytes, with every window's event mask on the
port's `GpuBackend`. One departure, by design: a fault of the card
(`ops.build.is_device_fault`) is not a failed job. The job leaves
``running`` as ``faulted`` (its status carries ``error_type: device``;
``backfill.device_faults`` counts it, never ``backfill.window_failures``),
`BackfillJob.result` re-raises the fault itself rather than a
`BackfillError`, and the committed windows stay journalled, so the
identical re-submit resumes once the card is sound. Nothing falls back to
the host.
"""

from __future__ import annotations

import hashlib
import threading
import time
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from typing import Callable, Optional, Sequence

from ipc_proofs_tpu_torch.backfill.scheduler import (
    EpochWindow,
    WorkAheadFeeder,
    plan_windows,
)
from ipc_proofs_tpu_torch.cluster.gather import BundleFold
from ipc_proofs_tpu_torch.ops.build import is_device_fault
from ipc_proofs_tpu_torch.proofs.bundle import UnifiedProofBundle
from ipc_proofs_tpu_torch.proofs.range import (
    _chunk_checkpoint_digest,
    _request_spec_repr,
    generate_event_proofs_for_range_chunked,
)
from ipc_proofs_tpu_torch.utils.lockdep import named_condition, named_lock
from ipc_proofs_tpu_torch.utils.log import get_logger
from ipc_proofs_tpu_torch.utils.threads import locked
from ipc_proofs_tpu_torch.utils.metrics import Metrics, get_metrics

log = get_logger(__name__)

__all__ = [
    "BackfillChunk",
    "BackfillEngine",
    "BackfillError",
    "BackfillJob",
    "local_window_runner",
]


class BackfillError(RuntimeError):
    """The job failed (a window runner raised) or was cancelled by
    shutdown; committed windows stay journalled for resume."""


class BackfillChunk:
    """One streamed result chunk: a window's bundle under its cursor.

    ``bundle_obj`` (the canonical JSON object) is dropped when the
    cursor is acked — the journal keeps the bytes; the in-memory entry
    keeps only the digest and window metadata for status/history.
    """

    __slots__ = ("cursor", "window", "digest", "n_event_proofs", "bundle_obj")

    def __init__(
        self,
        cursor: int,
        window: EpochWindow,
        digest: str,
        n_event_proofs: int,
        bundle_obj: Optional[dict],
    ):
        self.cursor = cursor
        self.window = window
        self.digest = digest
        self.n_event_proofs = n_event_proofs
        self.bundle_obj = bundle_obj

    def to_json_obj(self, with_bundle: bool = True) -> dict:
        obj = {
            "cursor": self.cursor,
            "window": self.window.to_json_obj(),
            "digest": self.digest,
            "n_event_proofs": self.n_event_proofs,
        }
        if with_bundle and self.bundle_obj is not None:
            obj["bundle"] = self.bundle_obj
        return obj


class BackfillJob:
    """One submitted backfill: windows, cursor log, final sealed bundle.

    State machine: ``running`` → ``complete`` | ``failed`` | ``faulted``
    (a fault of the card). A failed, faulted or shutdown-interrupted job
    is resumable — re-submitting the identical
    range lands on the same journal directory and replays committed
    windows instead of regenerating them.
    """

    def __init__(
        self,
        job_id: str,
        start: int,
        end: int,
        window_size: int,
        windows: Sequence[EpochWindow],
        sub_id: Optional[str] = None,
    ):
        self.job_id = job_id
        self.start = start
        self.end = end
        self.window_size = window_size
        self.windows = list(windows)
        self.sub_id = sub_id
        self.submitted_at = time.monotonic()
        # lock-order: BackfillJob._cond is leaf — nothing else is
        # acquired while it is held (journal/fold/runner calls all
        # happen outside it)
        self._cond = named_condition("BackfillJob._cond")
        self.state = "running"  # guarded-by: _cond
        self.error: Optional[str] = None  # guarded-by: _cond
        # the card's fault that stopped the job (state "faulted")
        self.fault: Optional[BaseException] = None  # guarded-by: _cond
        self._chunks: "list[BackfillChunk]" = []  # guarded-by: _cond
        self._acked = 0  # highest acked cursor; guarded-by: _cond
        self._replayed = 0  # windows satisfied from the journal; guarded-by: _cond
        self._first_chunk_s: Optional[float] = None  # guarded-by: _cond
        self._result: Optional[UnifiedProofBundle] = None  # guarded-by: _cond
        # proving seconds summed across runner threads (replayed windows
        # add none) — busy_s / (lanes × wall_s) is lane occupancy
        self._busy_s = 0.0  # guarded-by: _cond
        self._wall_s: Optional[float] = None  # guarded-by: _cond

    # --- mutation (engine runner thread only) ------------------------------

    def _emit(self, chunk: BackfillChunk, replayed: bool) -> None:
        with self._cond:
            chunk.cursor = len(self._chunks) + 1
            self._chunks.append(chunk)
            if replayed:
                self._replayed += 1
            if self._first_chunk_s is None:
                self._first_chunk_s = time.monotonic() - self.submitted_at
            self._cond.notify_all()

    def _finish(self, result: UnifiedProofBundle) -> None:
        with self._cond:
            self._result = result
            self.state = "complete"
            self._wall_s = time.monotonic() - self.submitted_at
            self._cond.notify_all()

    def _fail(self, error: str, fault: Optional[BaseException] = None) -> None:
        """End the job ``failed``, or ``faulted`` when ``fault`` is the
        card's fault that stopped it."""
        with self._cond:
            self.error = error
            self.fault = fault
            self.state = "failed" if fault is None else "faulted"
            self._wall_s = time.monotonic() - self.submitted_at
            self._cond.notify_all()

    def _add_busy(self, seconds: float) -> None:
        with self._cond:
            self._busy_s += seconds

    # --- cursor protocol ----------------------------------------------------

    def chunks_after(
        self, cursor: int, wait_s: float = 0.0, limit: int = 64
    ) -> dict:
        """Long-poll chunk fetch, the `subs/delivery.py` contract: a
        client asking from cursor N owns everything ≤ N (those chunk
        payloads are dropped from memory — the journal keeps the bytes)
        and receives up to ``limit`` chunks above it, blocking up to
        ``wait_s`` for the first one. Returns immediately once the job
        left ``running`` — a finished job has nothing more to wait for.
        """
        deadline = time.monotonic() + max(0.0, wait_s)
        with self._cond:
            self._ack_locked(cursor)
            while True:
                fresh = [c for c in self._chunks if c.cursor > cursor][:limit]
                if fresh or self.state != "running":
                    break
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(timeout=remaining)
            return {
                "job_id": self.job_id,
                "state": self.state,
                "cursor": len(self._chunks),
                "acked": self._acked,
                "chunks": [c.to_json_obj() for c in fresh],
            }

    def ack_through(self, cursor: int) -> int:
        """Drop streamed payloads with cursor ≤ ``cursor``; returns how
        many were dropped (idempotent — already-acked cursors skip)."""
        with self._cond:
            return self._ack_locked(cursor)

    @locked  # every caller holds self._cond
    def _ack_locked(self, cursor: int) -> int:
        dropped = 0
        for c in self._chunks:
            if c.cursor > cursor:
                break
            if c.bundle_obj is not None:
                c.bundle_obj = None
                dropped += 1
        if cursor > self._acked:
            self._acked = min(cursor, len(self._chunks))
        return dropped

    # --- status / result ----------------------------------------------------

    def status(self) -> dict:
        with self._cond:
            done = len(self._chunks)
            out = {
                "job_id": self.job_id,
                "state": self.state,
                "error": self.error,
                "pair_start": self.start,
                "pair_end": self.end,
                "n_pairs": self.end - self.start,
                "window_size": self.window_size,
                "windows_total": len(self.windows),
                "windows_done": done,
                "windows_replayed": self._replayed,
                "epochs_done": sum(
                    c.window.n_epochs for c in self._chunks
                ),
                "cursor": done,
                "acked": self._acked,
                "first_chunk_s": self._first_chunk_s,
                "busy_s": self._busy_s,
                "wall_s": (
                    self._wall_s
                    if self._wall_s is not None
                    else time.monotonic() - self.submitted_at
                ),
                "sub_id": self.sub_id,
                "nodes": sorted({w.node for w in self.windows}),
            }
            if self.fault is not None:
                out["error_type"] = "device"
            return out

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the job leaves ``running``; True when it did."""
        deadline = (
            (time.monotonic() + timeout) if timeout is not None else None
        )
        with self._cond:
            while self.state == "running":
                remaining = (
                    (deadline - time.monotonic()) if deadline is not None else None
                )
                if remaining is not None and remaining <= 0:
                    return False
                self._cond.wait(timeout=remaining)
            return True

    def result(self, timeout: Optional[float] = None) -> UnifiedProofBundle:
        """The sealed final bundle — byte-identical to the chunked range
        driver over the same pairs. Raises `BackfillError` on failure or
        `TimeoutError` if the job is still running after ``timeout``; a
        faulted job re-raises the card's fault itself."""
        if not self.wait(timeout):
            raise TimeoutError(
                f"backfill job {self.job_id} still running after wait"
            )
        with self._cond:
            if self.fault is not None:
                raise self.fault
            if self.state != "complete":
                raise BackfillError(
                    f"backfill job {self.job_id} {self.state}: {self.error}"
                )
            return self._result


def local_window_runner(
    store,
    spec,
    chunk_size: Optional[int] = None,
    match_backend=None,
    metrics: Optional[Metrics] = None,
) -> "Callable[[EpochWindow, list], UnifiedProofBundle]":
    """Window runner for a standalone engine (CLI, tests): each window
    runs the canonical chunked driver directly. ``chunk_size`` defaults
    to the whole window (one chunk per window)."""

    def run(window: EpochWindow, pairs: list) -> UnifiedProofBundle:
        return generate_event_proofs_for_range_chunked(
            store,
            pairs,
            spec,
            chunk_size=chunk_size or len(pairs),
            metrics=metrics,
            match_backend=match_backend,
        )

    return run


class BackfillEngine:
    """Plan, journal, execute, and stream backfill jobs.

    ``run_window(window, pairs) -> UnifiedProofBundle`` is the only
    execution dependency — the engine itself never touches a device,
    which is what lets the same core drive the CLI (direct driver), the
    serve daemon (low-priority micro-batcher lane) and the cluster
    router (steal-aware shard dispatch).
    """

    def __init__(
        self,
        pairs: Sequence,
        spec,
        run_window: "Callable[[EpochWindow, list], UnifiedProofBundle]",
        jobs_dir: Optional[str] = None,
        window_size: int = 8,
        work_ahead: int = 2,
        window_parallelism: int = 1,
        nodes: Sequence[str] = ("local",),
        plane=None,
        metrics: Optional[Metrics] = None,
        delivery=None,
        fsync: bool = True,
    ):
        if window_size < 1:
            raise ValueError("window_size must be >= 1")
        self.pairs = list(pairs)
        self.spec = spec
        self.run_window = run_window
        self.jobs_dir = jobs_dir
        self.window_size = int(window_size)
        self.work_ahead = max(0, int(work_ahead))
        self.window_parallelism = max(1, int(window_parallelism))
        self.nodes = list(nodes)
        self.plane = plane
        self.metrics = metrics if metrics is not None else get_metrics()
        self.delivery = delivery  # subs.DeliveryLog for catch-up landing
        self.fsync = fsync
        self._lock = named_lock("BackfillEngine._lock")
        self._jobs: "dict[str, BackfillJob]" = {}  # guarded-by: _lock
        self._threads: "dict[str, threading.Thread]" = {}  # guarded-by: _lock
        self._closed = False  # guarded-by: _lock

    # --- submission ---------------------------------------------------------

    def _job_id(self, manifest: dict) -> str:
        ident = manifest["params_digest"] + manifest["range_digest"]
        return "bf-" + hashlib.sha256(ident.encode()).hexdigest()[:12]

    def submit(
        self,
        start: int,
        end: int,
        window_size: Optional[int] = None,
        sub_id: Optional[str] = None,
    ) -> BackfillJob:
        """Plan and launch one job over global pairs ``[start, end)``.

        Idempotent: the job id derives from the journal manifest (spec +
        pair range + window size), so re-submitting an identical range
        returns the live job if one is running, or resumes the journal
        of a finished/crashed one.
        """
        wsize = int(window_size or self.window_size)
        windows = plan_windows(self.pairs, start, end, wsize, self.nodes)
        job_pairs = self.pairs[start:end]
        from ipc_proofs_tpu_torch.jobs import job_manifest

        # a spec-less engine (the cluster router: one deployment serves
        # one spec, fixed on the shards) still binds the manifest to the
        # window size; pair identity rides the manifest's range_digest
        spec_repr = (
            _request_spec_repr(self.spec, wsize, None)
            if self.spec is not None
            else repr(("backfill-opaque-spec", wsize)).encode()
        )
        manifest = job_manifest(spec_repr, job_pairs, wsize)
        job_id = self._job_id(manifest)
        with self._lock:
            if self._closed:
                raise BackfillError("backfill engine is closed")
            existing = self._jobs.get(job_id)
            if existing is not None and existing.state == "running":
                return existing
            job = BackfillJob(job_id, start, end, wsize, windows, sub_id=sub_id)
            self._jobs[job_id] = job
            thread = threading.Thread(
                target=self._run_job,
                args=(job, manifest, spec_repr),
                name=f"backfill-{job_id}",
                daemon=True,
            )
            self._threads[job_id] = thread
            n_active = sum(
                1 for j in self._jobs.values() if j.state == "running"
            )
        self.metrics.count("backfill.jobs")
        self.metrics.set_gauge("backfill.active_jobs", n_active)
        thread.start()
        return job

    def job(self, job_id: str) -> Optional[BackfillJob]:
        with self._lock:
            return self._jobs.get(job_id)

    def jobs(self) -> "list[dict]":
        with self._lock:
            jobs = list(self._jobs.values())
        return [j.status() for j in jobs]

    # --- execution ----------------------------------------------------------

    def _open_journal(self, job: BackfillJob, manifest: dict):
        if self.jobs_dir is None:
            return None
        import os

        from ipc_proofs_tpu_torch.jobs import resume_or_create

        job_dir = os.path.join(self.jobs_dir, job.job_id)
        os.makedirs(job_dir, exist_ok=True)
        return resume_or_create(
            job_dir, manifest, metrics=self.metrics, fsync=self.fsync
        )

    def _run_job(self, job: BackfillJob, manifest: dict, spec_repr: bytes) -> None:
        journal = None
        try:
            journal = self._open_journal(job, manifest)
            fold = BundleFold(
                self.pairs, list(range(job.start, job.end)), metrics=self.metrics
            )
            digests = {
                w.index: _chunk_checkpoint_digest(
                    spec_repr, self.pairs[w.lo : w.hi]
                )
                for w in job.windows
            }
            done: "set[int]" = set()
            # resume: replay committed windows straight into the fold and
            # the cursor log — a reconnecting client streams them from
            # cursor 0 exactly like fresh ones
            if journal is not None:
                resumed = False
                for w in job.windows:
                    if not journal.has_chunk(w.index):
                        continue
                    obj = journal.bundle_obj(w.index, digests[w.index])
                    bundle = UnifiedProofBundle.from_json_obj(obj)
                    fold.fold(bundle)
                    done.add(w.index)
                    self._emit_chunk(job, w, digests[w.index], bundle, obj, True)
                    resumed = True
                if resumed:
                    self.metrics.count("backfill.jobs_resumed")
            feeder = WorkAheadFeeder(
                self.plane, self.pairs, job.windows, work_ahead=self.work_ahead
            )
            pending = [w for w in job.windows if w.index not in done]
            self._run_windows(job, journal, fold, digests, done, feeder, pending)
            job._finish(fold.seal())
        except BaseException as exc:  # fail-soft: the job records its failure; committed windows stay journalled for resume
            if is_device_fault(exc):
                # the card's fault, not the job's: no failure recorded
                self.metrics.count("backfill.device_faults")
                log.error("backfill job %s stopped on a device fault: %s", job.job_id, exc)
                job._fail(f"{type(exc).__name__}: {exc}", fault=exc)
                return
            self.metrics.count("backfill.window_failures")
            log.warning("backfill job %s failed: %s", job.job_id, exc)
            job._fail(f"{type(exc).__name__}: {exc}")
        finally:
            if journal is not None:
                journal.close()
            with self._lock:
                n_active = sum(
                    1 for j in self._jobs.values() if j.state == "running"
                )
            self.metrics.set_gauge("backfill.active_jobs", n_active)

    def _run_windows(
        self, job, journal, fold, digests, done, feeder, pending
    ) -> None:
        """Execute pending windows at ``window_parallelism``, committing
        and streaming each in COMPLETION order (the fold is
        order-independent; the journal keys records by window index)."""

        def _commit(w: EpochWindow, bundle: UnifiedProofBundle) -> None:
            if journal is not None:
                journal.commit_chunk(w.index, digests[w.index], bundle)
            fold.fold(bundle)
            self._emit_chunk(job, w, digests[w.index], bundle, None, False)

        if self.window_parallelism == 1:
            for w in pending:
                self._check_open(job)
                feeder.on_window_start(w.index, done)
                _commit(w, self._timed_run(job, w))
            return
        executor = ThreadPoolExecutor(
            max_workers=self.window_parallelism,
            thread_name_prefix=f"backfill-{job.job_id}",
        )
        try:
            queue = list(pending)
            futures: dict = {}

            def _launch() -> None:
                if not queue:
                    return
                w = queue.pop(0)
                feeder.on_window_start(w.index, done)
                futures[executor.submit(self._timed_run, job, w)] = w
            for _ in range(self.window_parallelism):
                _launch()
            while futures:
                self._check_open(job)
                finished, _ = wait(futures, return_when=FIRST_COMPLETED)
                for fut in finished:
                    w = futures.pop(fut)
                    _commit(w, fut.result())  # a window error fails the job
                    _launch()
        finally:
            executor.shutdown(wait=True, cancel_futures=True)

    def _timed_run(self, job: BackfillJob, w: EpochWindow) -> UnifiedProofBundle:
        t0 = time.monotonic()
        try:
            return self.run_window(w, self.pairs[w.lo : w.hi])
        finally:
            job._add_busy(time.monotonic() - t0)

    def _check_open(self, job: BackfillJob) -> None:
        with self._lock:
            closed = self._closed
        if closed:
            raise BackfillError(
                f"backfill engine closed with job {job.job_id} in flight "
                "(journalled windows resume on the next submit)"
            )

    def _emit_chunk(
        self, job, window, digest, bundle, bundle_obj, replayed
    ) -> None:
        obj = bundle_obj if bundle_obj is not None else bundle.to_json_obj()
        chunk = BackfillChunk(
            cursor=0,  # assigned by _emit under the job lock
            window=window,
            digest=digest,
            n_event_proofs=len(bundle.event_proofs),
            bundle_obj=obj,
        )
        job._emit(chunk, replayed)
        self.metrics.count(
            "backfill.windows_replayed" if replayed else "backfill.windows"
        )
        self.metrics.count("backfill.epochs", window.n_epochs)
        self.metrics.count("backfill.chunks_streamed")
        if job.sub_id is not None and self.delivery is not None:
            # standing-query catch-up: the window lands as a normal
            # delivery (idempotency dedup absorbs resume replays)
            tipset = int(
                getattr(self.pairs[window.hi - 1].child, "height", 0) or 0
            )
            landed = self.delivery.append(
                job.sub_id,
                tipset,
                digest,
                {
                    "type": "backfill_chunk",
                    "job_id": job.job_id,
                    "cursor": chunk.cursor,
                    "window": window.to_json_obj(),
                    "bundle": obj,
                },
            )
            if landed is not None:
                self.metrics.count("backfill.catchup_deliveries")

    # --- lifecycle ----------------------------------------------------------

    def close(self, timeout: Optional[float] = None) -> None:
        """Stop accepting jobs; running jobs abort at their next window
        boundary (committed windows are already journalled). Idempotent."""
        with self._lock:
            if self._closed:
                threads = []
            else:
                self._closed = True
                threads = list(self._threads.values())
        for t in threads:
            t.join(timeout)

    def __enter__(self) -> "BackfillEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
