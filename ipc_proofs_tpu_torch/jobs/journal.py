"""Append-only write-ahead journal: the durability primitive.

The counterpart of ``ipc_proofs_tpu.jobs.journal``, frame for frame: a
journal written by either package replays in the other.

Record framing (all integers little-endian)::

    MAGIC   4 bytes   b"IPJ1"
    LEN     4 bytes   u32 payload length
    CRC     4 bytes   u32 crc32(payload)
    PAYLOAD LEN bytes UTF-8 canonical JSON

Every append is write → flush → ``os.fsync`` before the caller is told
the record is durable, so a committed record survives SIGKILL and power
loss (up to the filesystem's own guarantees). A crash mid-append leaves
a *torn tail*: fewer bytes on disk than one full frame. The reader
detects that (frame extends past EOF) and reports the byte offset of the
last good record so the caller can truncate and resume — a torn tail is
an expected artifact of crashing, not corruption. A CRC mismatch on a
*complete* frame, a bad magic, or undecodable JSON can only come from
bit corruption or interleaved writers and raises the typed
`JournalError` instead of ever yielding a silently wrong record.

Fail-soft (ENOSPC / EROFS mid-run): `JournalWriter.append` returns
``False`` instead of raising once the backing file stops accepting
writes — the writer permanently degrades to in-memory (a half-written
frame may sit at the tail; appending after it would corrupt mid-file),
counts ``jobs.journal_failures`` per unpersisted record, and warns once.
The job keeps its completed set in memory, so the run still finishes
with a correct bundle — it just can't resume. Each append is one trace
span, ``journal.append`` (with its frame's byte count).

Crash fault hook (the crash tests drive it): when
``IPC_JOURNAL_CRASH_AT=N`` is set, the writer SIGKILLs its own process
at its N-th append (0-based) — after the full frame is fsync'd
(chunk-boundary kill), or, with ``IPC_JOURNAL_CRASH_TORN=K``, after
only the first K bytes of the frame reach disk (torn mid-record write).
A real SIGKILL, not an exception: no destructor, no atexit, no flush
runs, exactly like an OOM kill or a preemption.
"""

from __future__ import annotations

import json
import os
import signal
import struct
import zlib
from typing import Any, Optional

from ipc_proofs_tpu_torch.obs.trace import span
from ipc_proofs_tpu_torch.utils.log import get_logger

__all__ = [
    "JOURNAL_MAGIC",
    "FRAME_HEADER",
    "JournalError",
    "JournalWriter",
    "frame_record",
    "read_journal",
    "read_journal_entries",
    "read_record_at",
]

JOURNAL_MAGIC = b"IPJ1"
_HEADER = struct.Struct("<4sII")  # magic, payload length, crc32(payload)
# the framing contract, exported: the reference's segment store reuses the
# same header layout (with its own magic)
FRAME_HEADER = _HEADER

logger = get_logger(__name__)


class JournalError(ValueError):
    """Typed journal integrity failure: CRC mismatch on a complete frame,
    bad magic, undecodable payload, duplicate or out-of-range chunk
    records, or a manifest that doesn't match the request. Never raised
    for a torn tail — that's normal crash residue and is recovered."""


def _frame(payload: bytes) -> bytes:
    return _HEADER.pack(JOURNAL_MAGIC, len(payload), zlib.crc32(payload)) + payload


def encode_record(obj: Any) -> bytes:
    """Canonical (sorted-key, compact) JSON — byte-stable framing for a
    given record object, so replay → re-journal round-trips identically."""
    return json.dumps(obj, sort_keys=True, separators=(",", ":")).encode("utf-8")


def frame_record(obj: Any) -> bytes:
    """One complete journal frame for ``obj`` — the exact bytes `append`
    would write. Exported for the compaction path, which rebuilds a
    journal offline and atomically swaps it in."""
    return _frame(encode_record(obj))


def read_journal_entries(path: str) -> "tuple[list[tuple[Any, int, int]], int, bool]":
    """Like `read_journal` but each entry carries its frame location:
    ``(record, offset, end)`` with ``offset`` the frame start and ``end``
    one past the payload — so callers (the serve result spill) can later
    re-read a single record with `read_record_at` instead of pinning
    every payload in memory."""
    with open(path, "rb") as fh:
        data = fh.read()
    entries: "list[tuple[Any, int, int]]" = []
    off = 0
    size = len(data)
    while off < size:
        if size - off < _HEADER.size:
            return entries, off, True  # torn header at the tail
        magic, length, crc = _HEADER.unpack_from(data, off)
        if magic != JOURNAL_MAGIC:
            raise JournalError(f"bad journal magic at offset {off}: {magic!r}")
        end = off + _HEADER.size + length
        if end > size:
            return entries, off, True  # torn payload at the tail
        payload = data[off + _HEADER.size : end]
        if zlib.crc32(payload) != crc:
            raise JournalError(
                f"journal record checksum mismatch at offset {off} "
                f"(record {len(entries)})"
            )
        try:
            entries.append((json.loads(payload), off, end))
        except ValueError as exc:
            raise JournalError(
                f"journal record at offset {off} is not valid JSON: {exc}"
            ) from exc
        off = end
    return entries, off, False


def read_journal(path: str) -> "tuple[list[Any], int, bool]":
    """Replay every record in ``path``.

    Returns ``(records, good_offset, torn_tail)``: ``good_offset`` is the
    byte offset just past the last complete, CRC-verified record;
    ``torn_tail`` is True when trailing bytes past it don't form a full
    frame (crash mid-append) — the caller truncates to ``good_offset``
    before appending again. Raises `JournalError` on anything that is
    not explainable by a torn sequential append: bad magic, CRC mismatch
    on a fully-present frame, or a payload that isn't valid JSON.
    """
    entries, good_offset, torn = read_journal_entries(path)
    return [rec for rec, _, _ in entries], good_offset, torn


def read_record_at(path: str, offset: int) -> Any:
    """Re-read ONE record whose frame starts at ``offset`` (as reported by
    `read_journal_entries`). Full integrity discipline applies: bad magic,
    CRC mismatch, a frame extending past EOF, or undecodable JSON all
    raise `JournalError` — a spilled result is either byte-verified or
    reported corrupt, never silently wrong."""
    with open(path, "rb") as fh:
        fh.seek(offset)
        header = fh.read(_HEADER.size)
        if len(header) < _HEADER.size:
            raise JournalError(f"record at offset {offset} extends past EOF")
        magic, length, crc = _HEADER.unpack(header)
        if magic != JOURNAL_MAGIC:
            raise JournalError(f"bad journal magic at offset {offset}: {magic!r}")
        payload = fh.read(length)
    if len(payload) < length:
        raise JournalError(f"record at offset {offset} extends past EOF")
    if zlib.crc32(payload) != crc:
        raise JournalError(f"journal record checksum mismatch at offset {offset}")
    try:
        return json.loads(payload)
    except ValueError as exc:
        raise JournalError(
            f"journal record at offset {offset} is not valid JSON: {exc}"
        ) from exc


class JournalWriter:
    """fsync-per-record appender with permanent fail-soft degrade.

    ``fsync=False`` drops the per-record fsync (write+flush only) for
    callers that explicitly trade durability for throughput — the bench
    measures both; the default is the durable contract.
    """

    def __init__(self, path: str, metrics=None, fsync: bool = True):
        self.path = path
        self._metrics = metrics
        self._fsync = fsync
        self._fh: Optional[Any] = open(path, "ab")
        self._records = 0  # appends attempted by THIS writer (crash-hook clock)
        self.degraded = False
        self._warned = False
        crash_at = os.environ.get("IPC_JOURNAL_CRASH_AT", "")
        self._crash_at = int(crash_at) if crash_at else None
        torn = os.environ.get("IPC_JOURNAL_CRASH_TORN", "")
        self._crash_torn = int(torn) if torn else None

    @property
    def journal_bytes(self) -> int:
        try:
            return os.path.getsize(self.path)
        except OSError:
            return 0

    def _crash(self, frame: bytes) -> None:
        """Fault hook: die by real signal mid-append (see module doc).

        ``IPC_JOURNAL_CRASH_SIGNAL=TERM`` swaps the SIGKILL for SIGTERM —
        the orchestrator-preemption flavor (k8s eviction, spot reclaim):
        still abrupt when nothing catches it, but deliverable to a process
        with a drain handler installed."""
        if self._crash_torn is not None:
            # tear the frame: persist only the first K bytes (clamped so at
            # least one byte is missing — a full frame wouldn't be torn)
            k = max(0, min(self._crash_torn, len(frame) - 1))
            self._fh.write(frame[:k])
        else:
            self._fh.write(frame)  # boundary kill: record fully committed
        self._fh.flush()
        os.fsync(self._fh.fileno())
        sig = (
            signal.SIGTERM
            if os.environ.get("IPC_JOURNAL_CRASH_SIGNAL", "").upper() == "TERM"
            else signal.SIGKILL
        )
        os.kill(os.getpid(), sig)

    def append(self, obj: Any) -> bool:
        """Durably append one record; True iff it reached disk."""
        if self.degraded or self._fh is None:
            if self._metrics is not None:
                self._metrics.count("jobs.journal_failures")
            return False
        with span("journal.append") as sp:
            return self._append_framed(obj, sp)

    def _append_framed(self, obj: Any, sp) -> bool:
        frame = _frame(encode_record(obj))
        sp.set_attr("bytes", len(frame))
        if self._crash_at is not None and self._records == self._crash_at:
            self._crash(frame)
        self._records += 1
        try:
            self._fh.write(frame)
            self._fh.flush()
            if self._fsync:
                os.fsync(self._fh.fileno())
        except OSError as exc:
            # ENOSPC/EROFS/…: a partial frame may now sit at the tail, so
            # never write again (it would corrupt mid-file); the torn tail
            # is discarded by the next resume like any crash residue
            self.degraded = True
            if self._metrics is not None:
                self._metrics.count("jobs.journal_failures")
            if not self._warned:
                self._warned = True
                logger.warning(
                    "journal %s unwritable (%s) — degrading to in-memory; "
                    "this run completes but cannot resume", self.path, exc,
                )
            return False
        return True

    def close(self) -> None:
        if self._fh is not None:
            try:
                self._fh.close()
            except OSError:
                pass
            self._fh = None
