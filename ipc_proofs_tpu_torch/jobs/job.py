"""Resumable range jobs on top of the write-ahead journal.

The counterpart of ``ipc_proofs_tpu.jobs.job``: the same manifest, record
vocabulary and compaction, so a job directory written by either package
resumes in the other.

Job directory layout::

    <job_dir>/
      manifest.json   request identity: params digest, range digest,
                      n_pairs / n_chunks / chunk_size  (written once,
                      atomically; a resume against a different request
                      raises JournalError instead of resuming stale state)
      journal.bin     append-only chunk records (journal.py framing)

Record vocabulary (one JSON object per record):

    {"t": "chunk",   "chunk": i, "digest": d, "bundle": <bundle obj>,
                     "verify": <verdict or null>}
    {"t": "verdict", "chunk": i, "digest": d, "verify": <verdict>}

A ``chunk`` record is THE commit point: once fsync'd, chunk ``i`` is
never regenerated. ``verdict`` records attach a later verify result to
an already-committed chunk (the verify stage runs behind the record
stage in the pipelined driver). `resume_or_create` replays the journal,
truncates a torn tail, and seeds the completed-chunk map that the range
drivers consult to skip work.

Counters: ``jobs.chunks_replayed`` (records recovered on resume), ``jobs.resume_ms``
(replay wall time), ``jobs.commit_us`` (microseconds spent serializing +
fsync'ing commit records — the journal's attributable cost),
``jobs.journal_failures`` (records that failed to persist, fail-soft),
plus the ``jobs.journal_bytes`` gauge.
"""

from __future__ import annotations

import hashlib
import json
import os
import signal
import time
from typing import Any, Optional

from ipc_proofs_tpu_torch.jobs.journal import (
    JournalError,
    JournalWriter,
    frame_record,
    read_journal,
)
from ipc_proofs_tpu_torch.utils.lockdep import named_lock
from ipc_proofs_tpu_torch.utils.log import get_logger
from ipc_proofs_tpu_torch.utils.threads import locked

__all__ = [
    "JOBS_MANIFEST_NAME",
    "JOBS_JOURNAL_NAME",
    "RangeJob",
    "job_manifest",
    "resume_or_create",
]

JOBS_MANIFEST_NAME = "manifest.json"
JOBS_JOURNAL_NAME = "journal.bin"

logger = get_logger(__name__)


def job_manifest(spec_repr: bytes, pairs, chunk_size: int) -> dict:
    """Build the request-identity manifest for one range job.

    ``params_digest`` covers the proof request (event spec, storage
    specs, chunk size — `proofs.range._request_spec_repr`); the range
    digest covers every tipset CID in order, so a job dir can never
    resume a DIFFERENT range or request (same contract as the per-chunk
    checkpoint digests, lifted to the whole job).
    """
    h = hashlib.sha256(spec_repr)
    for pair in pairs:
        for cid in pair.parent.cids:
            h.update(cid.to_bytes())
        for cid in pair.child.cids:
            h.update(cid.to_bytes())
    chunk_size = max(1, int(chunk_size))
    n = len(pairs)
    return {
        "format": 1,
        "params_digest": hashlib.sha256(spec_repr).hexdigest(),
        "range_digest": h.hexdigest(),
        "n_pairs": n,
        "chunk_size": chunk_size,
        "n_chunks": (n + chunk_size - 1) // chunk_size,
    }


class RangeJob:
    """One resumable range job: completed-chunk map + journal appender.

    Commit methods are thread-safe: the pipelined driver's record and
    verify stages run several workers, and `JournalWriter.append` is NOT
    safe to call concurrently (interleaved frames would tear the journal,
    and the ``IPC_JOURNAL_CRASH_AT`` record-count clock in the crash
    harness must tick one append at a time). One lock serializes every
    append together with its completed-map update, so a journal record
    and the in-memory map can never disagree mid-commit.
    """

    def __init__(
        self,
        job_dir: str,
        manifest: dict,
        completed: "dict[int, dict]",
        writer: JournalWriter,
        metrics=None,
        compact_threshold_bytes: "Optional[int]" = None,
    ):
        self.job_dir = job_dir
        self.manifest = manifest
        self._lock = named_lock("RangeJob._lock")
        self.completed = completed  # guarded-by: _lock
        self._writer = writer  # guarded-by: _lock
        self._metrics = metrics
        # auto-compaction trigger (None/0 = manual `compact()` only)
        self._compact_threshold = compact_threshold_bytes
        self.compactions = 0  # guarded-by: _lock
        self._last_compact_bytes = 0  # guarded-by: _lock

    # -- resume side -----------------------------------------------------

    def has_chunk(self, index: int) -> bool:
        with self._lock:
            return index in self.completed

    def bundle_obj(self, index: int, expect_digest: "str | None" = None) -> Any:
        """The committed bundle JSON object for chunk ``index``; verifies
        the stored per-chunk digest when the caller knows it — a mismatch
        means the journal belongs to different data and must never be
        spliced into this run's bundle."""
        with self._lock:
            rec = self.completed[index]
        if expect_digest is not None and rec.get("digest") != expect_digest:
            raise JournalError(
                f"journal chunk {index} digest {rec.get('digest')!r} != "
                f"expected {expect_digest!r} (job dir holds a different range)"
            )
        return rec["bundle"]

    # -- commit side -----------------------------------------------------

    def commit_chunk(self, index: int, digest: "str | None", bundle, verify=None) -> bool:
        """Durably record chunk ``index`` as complete (fail-soft)."""
        t0 = time.thread_time()
        w0 = time.perf_counter()
        rec = {
            "t": "chunk",
            "chunk": index,
            "digest": digest,
            "bundle": bundle.to_json_obj(),
            "verify": verify,
        }
        with self._lock:
            ok = self._writer.append(rec)  # durability: appends serialize under the job lock
            self.completed[index] = rec
            self._maybe_compact_locked()
            jb = self._writer.journal_bytes
        self._commit_done(t0, w0, jb)
        return ok

    def commit_verdict(self, index: int, digest: "str | None", verify) -> bool:
        """Attach a verify verdict to an already-committed chunk."""
        t0 = time.thread_time()
        w0 = time.perf_counter()
        with self._lock:
            ok = self._writer.append(  # durability: appends serialize under the job lock
                {"t": "verdict", "chunk": index, "digest": digest, "verify": verify}
            )
            if index in self.completed:
                self.completed[index]["verify"] = verify
            self._maybe_compact_locked()
            jb = self._writer.journal_bytes
        self._commit_done(t0, w0, jb)
        return ok

    # -- compaction ------------------------------------------------------

    def compact(self) -> bool:
        """Snapshot the committed prefix into a fresh journal and swap it
        in atomically, bounding replay time.

        The fresh journal holds ONE merged chunk record per completed
        chunk (verdicts already folded into their chunk record in
        `completed`), in chunk order — replaying it reconstructs exactly
        the current completed map, so a crash at ANY byte is safe:

        - before the `os.replace`: the original journal is untouched (the
          snapshot is built in a ``.compact`` sidecar, which a later open
          simply overwrites);
        - after the `os.replace`: the journal IS the snapshot and replays
          to the same state.

        Returns True when the swap happened; False when skipped (degraded
        writer, nothing committed) or failed fail-soft (OSError — the
        original journal keeps appending as before).
        """
        with self._lock:
            return self._compact_locked()

    @locked
    def _maybe_compact_locked(self) -> None:
        threshold = self._compact_threshold
        if not threshold:
            return
        size = self._writer.journal_bytes
        if size < threshold:
            return
        # require real growth since the last snapshot, or every commit past
        # the threshold would re-snapshot an already-compact journal
        if self._last_compact_bytes and size < int(1.5 * self._last_compact_bytes):
            return
        self._compact_locked()

    @locked
    def _compact_locked(self) -> bool:
        if self._writer.degraded or not self.completed:
            return False
        jpath = self._writer.path
        tmp = jpath + ".compact"
        snapshot = b"".join(
            frame_record(self.completed[index]) for index in sorted(self.completed)
        )
        crash_bytes = os.environ.get("IPC_COMPACT_CRASH_BYTES", "")
        try:
            with open(tmp, "wb") as fh:
                if crash_bytes:
                    # crash hook: persist only the first
                    # K bytes of the snapshot, then die by real SIGKILL — the
                    # swap never happened, the live journal must be untouched
                    k = max(0, min(int(crash_bytes), len(snapshot) - 1))
                    fh.write(snapshot[:k])
                    fh.flush()
                    os.fsync(fh.fileno())  # the sidecar must be durable before the swap
                    os.kill(os.getpid(), signal.SIGKILL)
                fh.write(snapshot)
                fh.flush()
                os.fsync(fh.fileno())  # the sidecar must be durable before the swap
        except OSError as exc:
            logger.warning(
                "journal compaction of %s failed pre-swap (%s) — continuing "
                "on the uncompacted journal", jpath, exc,
            )
            return False
        fsync = self._writer._fsync
        self._writer.close()
        try:
            os.replace(tmp, jpath)
        except OSError as exc:
            self._writer = JournalWriter(jpath, metrics=self._metrics, fsync=fsync)
            logger.warning(
                "journal compaction of %s failed at swap (%s) — continuing "
                "on the uncompacted journal", jpath, exc,
            )
            return False
        if os.environ.get("IPC_COMPACT_CRASH_POST", ""):
            # crash hook: die right after the atomic swap — the journal IS
            # the snapshot now and must replay to the same completed map
            os.kill(os.getpid(), signal.SIGKILL)
        self._writer = JournalWriter(jpath, metrics=self._metrics, fsync=fsync)
        self.compactions += 1
        self._last_compact_bytes = self._writer.journal_bytes
        metrics = self._metrics
        if metrics is not None:
            metrics.count("jobs.compactions")
            metrics.set_gauge("jobs.journal_bytes", self._last_compact_bytes)
        logger.info(
            "journal %s compacted: %d chunks, %d bytes", jpath,
            len(self.completed), self._last_compact_bytes,
        )
        return True

    def _commit_done(self, t0: float, w0: float, journal_bytes: int) -> None:
        # Two clocks on purpose. jobs.commit_us is thread CPU time:
        # commits run in the pipelined driver's record stage, where wall
        # time would also count GIL/IO waits spent productively scanning
        # the NEXT chunk — CPU time is the part a commit actually steals
        # from compute. jobs.chunk_journal_us is wall time: the fsync
        # latency a waiting request experiences, surfaced per-request as
        # `journal_ms` in the serve plane's Server-Timing breakdown.
        if self._metrics is not None:
            self._metrics.count(
                "jobs.commit_us", int((time.thread_time() - t0) * 1e6)
            )
            self._metrics.count(
                "jobs.chunk_journal_us", int((time.perf_counter() - w0) * 1e6)
            )
            self._metrics.set_gauge("jobs.journal_bytes", journal_bytes)

    @property
    def journal_bytes(self) -> int:
        with self._lock:
            return self._writer.journal_bytes

    @property
    def degraded(self) -> bool:
        with self._lock:
            return self._writer.degraded

    def close(self) -> None:
        with self._lock:
            self._writer.close()

    def __enter__(self) -> "RangeJob":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _write_manifest_atomic(path: str, manifest: dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(manifest, fh, sort_keys=True, indent=1)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


def resume_or_create(
    job_dir: str,
    manifest: dict,
    metrics=None,
    fsync: bool = True,
    compact_threshold_bytes: "Optional[int]" = None,
) -> RangeJob:
    """Open (resuming) or initialize a job directory.

    Fresh dir: writes ``manifest.json`` atomically and starts an empty
    journal. Existing dir: the on-disk manifest must equal ``manifest``
    (JournalError otherwise — a job dir is bound to exactly one request),
    then the journal replays: complete records seed the completed-chunk
    map, a torn tail is truncated away, duplicate or malformed chunk
    records raise `JournalError`. Replay cost surfaces as
    ``jobs.chunks_replayed`` / ``jobs.resume_ms``.

    ``compact_threshold_bytes`` arms auto-compaction: once the journal
    grows past it, commits snapshot the committed prefix and swap it in
    (`RangeJob.compact`). Defaults to the ``IPC_JOURNAL_COMPACT_BYTES``
    env var; unset/0 means manual compaction only.
    """
    if compact_threshold_bytes is None:
        raw = os.environ.get("IPC_JOURNAL_COMPACT_BYTES", "")
        if raw:
            try:
                compact_threshold_bytes = int(raw)
            except ValueError:
                logger.warning("ignoring non-integer IPC_JOURNAL_COMPACT_BYTES=%r", raw)
    t0 = time.perf_counter()
    os.makedirs(job_dir, exist_ok=True)
    mpath = os.path.join(job_dir, JOBS_MANIFEST_NAME)
    if os.path.exists(mpath):
        try:
            with open(mpath) as fh:
                on_disk = json.load(fh)
        except ValueError as exc:
            raise JournalError(f"unreadable job manifest {mpath}: {exc}") from exc
        if on_disk != manifest:
            diff = sorted(
                k
                for k in set(on_disk) | set(manifest)
                if on_disk.get(k) != manifest.get(k)
            )
            raise JournalError(
                f"job dir {job_dir} was created for a different request "
                f"(manifest mismatch on {diff}); use a fresh --job-dir"
            )
    else:
        _write_manifest_atomic(mpath, manifest)

    jpath = os.path.join(job_dir, JOBS_JOURNAL_NAME)
    completed: "dict[int, dict]" = {}
    n_replayed = 0
    if os.path.exists(jpath):
        records, good_offset, torn = read_journal(jpath)
        n_chunks = int(manifest.get("n_chunks", 0))
        for pos, rec in enumerate(records):
            if not isinstance(rec, dict) or not isinstance(rec.get("chunk"), int):
                raise JournalError(f"malformed journal record {pos} in {jpath}")
            index = rec["chunk"]
            if index < 0 or index >= n_chunks:
                raise JournalError(
                    f"journal record {pos} names chunk {index}, outside "
                    f"[0, {n_chunks}) for this job"
                )
            kind = rec.get("t")
            if kind == "chunk":
                if index in completed:
                    raise JournalError(
                        f"duplicate journal record for chunk {index} "
                        f"(record {pos}) — journal is corrupt"
                    )
                completed[index] = rec
                n_replayed += 1
            elif kind == "verdict":
                if index not in completed:
                    raise JournalError(
                        f"verdict record {pos} for chunk {index} precedes "
                        f"its chunk record"
                    )
                completed[index]["verify"] = rec.get("verify")
            else:
                raise JournalError(f"unknown journal record type {kind!r} ({pos})")
        if torn:
            # crash residue: drop the partial frame so appends restart on a
            # record boundary (the chunk it described was never committed)
            logger.warning(
                "journal %s has a torn tail record — truncating to %d bytes "
                "(%d committed chunks survive)", jpath, good_offset, n_replayed,
            )
            with open(jpath, "r+b") as fh:
                fh.truncate(good_offset)
                fh.flush()
                os.fsync(fh.fileno())
    writer = JournalWriter(jpath, metrics=metrics, fsync=fsync)
    if metrics is not None:
        if n_replayed:
            metrics.count("jobs.chunks_replayed", n_replayed)
        metrics.count("jobs.resume_ms", int((time.perf_counter() - t0) * 1000))
        metrics.set_gauge("jobs.journal_bytes", writer.journal_bytes)
    return RangeJob(
        job_dir, manifest, completed, writer, metrics=metrics,
        compact_threshold_bytes=compact_threshold_bytes,
    )
