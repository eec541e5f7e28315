"""Hash-linked registry log: IPJ1 framing discipline, IPR1 magic.

Record framing (all integers little-endian, the exported
``jobs.journal.FRAME_HEADER`` layout)::

    MAGIC   4 bytes   b"IPR1"
    LEN     4 bytes   u32 payload length
    CRC     4 bytes   u32 crc32(payload)
    PAYLOAD LEN bytes UTF-8 canonical JSON

On top of the per-frame CRC each payload carries ``prev`` — the SHA-256
of the *previous* record's payload bytes — so the log is a hash chain:
rewriting any historical record breaks every link after it. The reader
applies the journal's exact torn-tail discipline: a frame extending past
EOF is normal crash residue (truncate and resume), while a CRC mismatch
on a complete frame, a bad magic, undecodable JSON, or a broken prev
link can only be corruption or tampering and raises the typed
`RegistryError` — never a silently wrong record.

Crash fault hooks mirror the journal's:
``IPC_REGISTRY_CRASH_AT=N`` SIGKILLs at the N-th append after the full
frame is fsync'd; ``IPC_REGISTRY_CRASH_TORN=K`` persists only the first
K bytes of that frame first. ``IPC_JOURNAL_CRASH_SIGNAL=TERM`` swaps in
SIGTERM, same as the journal.
"""

from __future__ import annotations

import hashlib
import os
import signal
import struct
import zlib
from typing import Any, List, Optional, Tuple

from ipc_proofs_tpu_torch.jobs.journal import FRAME_HEADER, encode_record
from ipc_proofs_tpu_torch.utils.log import get_logger

__all__ = [
    "REGISTRY_MAGIC",
    "RegistryError",
    "RegistryWriter",
    "frame_registry_record",
    "read_registry_frames",
    "record_digest",
    "verify_chain",
]

REGISTRY_MAGIC = b"IPR1"
_HEADER: struct.Struct = FRAME_HEADER

logger = get_logger(__name__)


class RegistryError(ValueError):
    """Typed registry integrity failure: CRC mismatch on a complete
    frame, bad magic, undecodable payload, or a prev-link that doesn't
    match the preceding record's digest. Never raised for a torn tail —
    that's normal crash residue and is truncated on open."""


def record_digest(payload: bytes) -> str:
    """The chain link: hex SHA-256 of one record's payload bytes."""
    return hashlib.sha256(payload).hexdigest()


def frame_registry_record(obj: Any) -> bytes:
    """One complete IPR1 frame for ``obj`` (canonical sorted-key JSON)."""
    payload = encode_record(obj)
    return _HEADER.pack(REGISTRY_MAGIC, len(payload), zlib.crc32(payload)) + payload


def read_registry_frames(
    path: str, offset: int = 0
) -> "Tuple[List[Tuple[Any, bytes, int]], int, bool]":
    """Scan complete frames from ``offset``; returns
    ``([(record, payload_bytes, frame_offset), ...], good_offset, torn)``.

    ``good_offset`` is one past the last complete CRC-verified frame;
    ``torn`` is True when trailing bytes past it don't form a full frame
    (crash mid-append — the caller truncates before appending again).
    A missing file reads as empty. Integrity failures raise the typed
    `RegistryError`; prev-link verification is the caller's job (it
    spans frames, and a sibling scan may start mid-chain).
    """
    import json

    try:
        with open(path, "rb") as fh:
            fh.seek(offset)
            data = fh.read()
    except FileNotFoundError:
        return [], offset, False
    entries: "List[Tuple[Any, bytes, int]]" = []
    off = 0
    size = len(data)
    while off < size:
        if size - off < _HEADER.size:
            return entries, offset + off, True  # torn header at the tail
        magic, length, crc = _HEADER.unpack_from(data, off)
        if magic != REGISTRY_MAGIC:
            raise RegistryError(
                f"bad registry magic at offset {offset + off}: {magic!r}"
            )
        end = off + _HEADER.size + length
        if end > size:
            return entries, offset + off, True  # torn payload at the tail
        payload = data[off + _HEADER.size : end]
        if zlib.crc32(payload) != crc:
            raise RegistryError(
                f"registry record checksum mismatch at offset {offset + off}"
            )
        try:
            entries.append((json.loads(payload), payload, offset + off))
        except ValueError as exc:
            raise RegistryError(
                f"registry record at offset {offset + off} is not valid "
                f"JSON: {exc}"
            ) from exc
        off = end
    return entries, offset + off, False


def verify_chain(
    entries: "List[Tuple[Any, bytes, int]]", prev: str = ""
) -> str:
    """Walk the prev-links across ``entries`` (as returned by
    `read_registry_frames`), starting from ``prev`` (empty = chain
    head). Returns the digest of the last payload — the new chain tip —
    or raises `RegistryError` at the first broken link."""
    for rec, payload, off in entries:
        got = rec.get("prev") if isinstance(rec, dict) else None
        if got != prev:
            raise RegistryError(
                f"registry chain broken at offset {off}: record links "
                f"prev={got!r}, expected {prev!r}"
            )
        prev = record_digest(payload)
    return prev


class RegistryWriter:
    """Append-only frame writer with permanent fail-soft degrade.

    ``fsync=False`` (the serve-path default) writes+flushes per record
    without the per-record fsync — registry appends ride the response
    seal and must cost well under 1% of serve wall; the OS page cache
    makes loss on power-cut bounded, and a torn tail is recovered like
    any crash residue. ``fsync=True`` restores the journal's durable
    contract for audit-critical deployments.
    """

    def __init__(self, path: str, metrics=None, fsync: bool = False):
        self.path = path
        self._metrics = metrics
        self._fsync = fsync
        self._fh: Optional[Any] = open(path, "ab")
        self._records = 0  # appends attempted by THIS writer (crash-hook clock)
        self.degraded = False
        self._warned = False
        crash_at = os.environ.get("IPC_REGISTRY_CRASH_AT", "")
        self._crash_at = int(crash_at) if crash_at else None
        torn = os.environ.get("IPC_REGISTRY_CRASH_TORN", "")
        self._crash_torn = int(torn) if torn else None

    @property
    def log_bytes(self) -> int:
        try:
            return os.path.getsize(self.path)
        except OSError:
            return 0

    def truncate(self, good_offset: int) -> None:
        """Drop crash residue past the last complete frame before the
        first append (exactly the journal's resume discipline)."""
        if self._fh is None:
            return
        self._fh.truncate(good_offset)
        self._fh.seek(good_offset)

    def _crash(self, frame: bytes) -> None:
        """Fault hook: die by real signal mid-append (see module doc)."""
        if self._crash_torn is not None:
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

    def append_frame(self, frame: bytes) -> bool:
        """Append one pre-built frame; True iff it reached the file."""
        if self.degraded or self._fh is None:
            if self._metrics is not None:
                self._metrics.count("registry.append_failures")
            return False
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
            # never write again; serving continues — the registry degrades,
            # it never blocks a response
            self.degraded = True
            if self._metrics is not None:
                self._metrics.count("registry.append_failures")
            if not self._warned:
                self._warned = True
                logger.warning(
                    "registry log %s unwritable (%s) — degrading; serving "
                    "continues without new provenance records", self.path, exc,
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
