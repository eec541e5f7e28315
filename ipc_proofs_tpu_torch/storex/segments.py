"""Disk tier: CID → bytes in append-only CRC-framed segment files.

The counterpart of ``ipc_proofs_tpu.storex.segments``, file format and all:
the two packages open each other's segment directories. The multihash
half of `get_many` and of the sweep at open (``verify_scan=True``) runs
through `ops.verify.verify_blocks_batch` on ``backend`` (default the card),
whose routing sends one-block and sub-crossover batches to hashlib with
identical verdicts; a kernel or launch fault raises. `read_frame_slice`
is the streaming wire's zero-copy read (CRC-checked on the mapped bytes).
The replication surface (`segment_files`, `segment_path`,
`ingest_segment_file`, `drop_segment`) moves whole segment files between
stores for `storex/replica.py`: an ingest CRC-scans the frames only, and
the multihash half of each ingested block is checked when it is read, a
batch read through one `verify_blocks_batch` call on ``backend``.

Layout (``<root>/seg-00000001.blk``, ``seg-00000002.blk``, …; in shared
mode ``seg-<owner>.00000001.blk`` — see below)::

    MAGIC   4 bytes   b"IPS1"
    LEN     4 bytes   u32 payload length
    CRC     4 bytes   u32 crc32(payload)
    PAYLOAD           u16 cid_len | cid raw bytes | block bytes

Same ``len|CRC32`` framing discipline as the write-ahead journal
(`jobs.journal.FRAME_HEADER` — the header struct is literally shared),
with the segment store's own magic so a journal can never be mistaken
for a segment. The in-memory offset index is rebuilt by scanning every
segment on open; a torn tail (crash mid-append) is truncated away like
journal crash residue, and a corrupt frame mid-file truncates the
segment at that point — the dropped blocks refetch on demand, so
corruption only ever costs availability.

Reads re-verify TWICE: the frame CRC (did the disk return what was
written?) and the block multihash against the requested CID (is what was
written actually this block?). Either mismatch evicts the entry, counts
``storex.integrity_evictions``, and reports a miss so the caller
refetches from the inner store — corrupt bytes are never served.

Eviction is byte-capped LRU at *segment* granularity: the store tracks
per-segment last-touch recency and deletes whole cold segment files when
the cap is exceeded (content-addressed data never goes stale, so this is
purely a disk-budget policy). The active tail segment is never evicted.

**Shared mode** (``owner="s0"``): N processes — the cluster's shard
daemons — share ONE store directory. Each writer appends only to its own
``seg-<owner>.<id>.blk`` segments (so appends never interleave), while
the rebuild scan indexes EVERY owner's segments (a block any shard
fetched is warm for all of them). Eviction then coordinates through an
``fcntl.flock`` on ``<root>/evict.lock``: the evicting process computes
the real directory total, never deletes ANY owner's highest-id segment
(that is some process's active tail), prefers its own LRU-cold segments
and falls back to other owners' oldest non-tail segments, and counts
each removal as ``storex.evictions`` + ``storex.shared_evictions``. A
reader racing a removal sees a vanished file and degrades to a plain
miss — availability, never correctness. Because each process only
re-checks the directory when it rolls a segment, the shared cap can
transiently overshoot by ~(writers × segment_max_bytes); that bound is
the price of not stat-ing the directory on every put.

Writes are flush-only (no per-block fsync): the disk tier is a cache of
refetchable chain data, not a durability log — a lost tail costs a
refetch, and the rebuild scan already handles any torn residue.
Write errors (ENOSPC/EROFS) degrade the store to read-only fail-soft,
counted as ``storex.write_failures``.
"""

from __future__ import annotations

import mmap
import os
import struct
import zlib
from collections import OrderedDict
from typing import Optional

try:
    import fcntl
except ImportError:  # pragma: no cover - non-POSIX: shared eviction degrades to local
    fcntl = None

from ipc_proofs_tpu_torch.core.cid import CID
from ipc_proofs_tpu_torch.jobs.journal import FRAME_HEADER
from ipc_proofs_tpu_torch.ops.verify import verify_blocks_batch
from ipc_proofs_tpu_torch.store.rpc import verify_block_bytes
from ipc_proofs_tpu_torch.utils.lockdep import flock_frame, named_lock
from ipc_proofs_tpu_torch.utils.log import get_logger
from ipc_proofs_tpu_torch.utils.threads import locked

__all__ = ["SEGMENT_MAGIC", "SegmentStore", "SegmentStoreError"]

SEGMENT_MAGIC = b"IPS1"
_CID_LEN = struct.Struct("<H")
_SEGMENT_GLOB_PREFIX = "seg-"
_SEGMENT_SUFFIX = ".blk"
_EVICT_LOCK_NAME = "evict.lock"

logger = get_logger(__name__)


class SegmentStoreError(ValueError):
    """Typed segment-store misuse: the root path is not usable as a store
    directory, a segment file name lies about its id, or an owner token
    is not filename-safe. Frame-level corruption never raises this — it
    is handled by truncate/evict + refetch (availability, not
    correctness)."""


class _Segment:
    __slots__ = ("key", "owner", "seg_id", "path", "size", "raws")

    def __init__(self, key: str, owner: str, seg_id: int, path: str, size: int = 0):
        self.key = key  # basename — unique across owners (seg ids are not)
        self.owner = owner
        self.seg_id = seg_id
        self.path = path
        self.size = size
        self.raws: "list[bytes]" = []  # raw CIDs indexed into this segment


def _segment_name(owner: str, seg_id: int) -> str:
    if owner:
        return f"{_SEGMENT_GLOB_PREFIX}{owner}.{seg_id:08d}{_SEGMENT_SUFFIX}"
    return f"{_SEGMENT_GLOB_PREFIX}{seg_id:08d}{_SEGMENT_SUFFIX}"


def _parse_segment_name(name: str) -> "tuple[str, int] | None":
    """``(owner, seg_id)`` of a segment file name (owner ``""`` for the
    legacy single-writer form), or None when it is not a segment file."""
    if not (name.startswith(_SEGMENT_GLOB_PREFIX) and name.endswith(_SEGMENT_SUFFIX)):
        return None
    rem = name[len(_SEGMENT_GLOB_PREFIX) : -len(_SEGMENT_SUFFIX)]
    if "." in rem:
        owner, _, id_str = rem.rpartition(".")
    else:
        owner, id_str = "", rem
    try:
        return owner, int(id_str)
    except ValueError:
        raise SegmentStoreError(f"segment file name {name!r} has no id") from None


def _scan_segment(path: str) -> "tuple[list[tuple[bytes, int, int]], int, bool]":
    """Scan one segment file: ``([(cid_raw, offset, frame_len)], good_size,
    dirty)``. Stops at the first torn OR corrupt frame; ``good_size`` is
    the byte offset to truncate to and ``dirty`` says truncation is
    needed. Pure function of the file — no store state touched."""
    with open(path, "rb") as fh:
        data = fh.read()
    entries: "list[tuple[bytes, int, int]]" = []
    off = 0
    size = len(data)
    while off < size:
        if size - off < FRAME_HEADER.size:
            return entries, off, True  # torn header at the tail
        magic, length, crc = FRAME_HEADER.unpack_from(data, off)
        end = off + FRAME_HEADER.size + length
        if magic != SEGMENT_MAGIC:
            logger.warning(
                "segment %s: bad magic at offset %d — truncating (blocks "
                "past it refetch on demand)", path, off,
            )
            return entries, off, True
        if end > size:
            return entries, off, True  # torn payload at the tail
        payload = data[off + FRAME_HEADER.size : end]
        if zlib.crc32(payload) != crc or length < _CID_LEN.size:
            logger.warning(
                "segment %s: corrupt frame at offset %d — truncating (blocks "
                "past it refetch on demand)", path, off,
            )
            return entries, off, True
        (cid_len,) = _CID_LEN.unpack_from(payload, 0)
        if _CID_LEN.size + cid_len > length:
            logger.warning(
                "segment %s: malformed frame at offset %d — truncating", path, off,
            )
            return entries, off, True
        cid_raw = payload[_CID_LEN.size : _CID_LEN.size + cid_len]
        entries.append((cid_raw, off, end - off))
        off = end
    return entries, off, False


class SegmentStore:
    """Byte-capped disk block store over append-only segment files.

    Thread-safe: one lock guards the index, the segment LRU, and the
    active tail writer (appends are short buffered writes). Frame reads
    happen outside the lock against immutable committed bytes; a read
    racing an eviction sees a vanished file and reports a plain miss.

    ``owner`` switches on shared mode: this process appends only to its
    own ``seg-<owner>.*`` segments and eviction coordinates with the
    other owners through the ``evict.lock`` flock (see module docstring).
    """

    def __init__(
        self,
        root: str,
        cap_bytes: int = 1 << 30,
        segment_max_bytes: int = 64 * 1024 * 1024,
        metrics=None,
        owner: Optional[str] = None,
        verify_scan: bool = False,
        backend=None,
    ):
        if cap_bytes <= 0:
            raise SegmentStoreError("cap_bytes must be positive")
        if owner is not None and (
            not owner
            or not all(ch.isalnum() or ch in "-_" for ch in owner)
        ):
            raise SegmentStoreError(
                f"owner token {owner!r} must be non-empty [A-Za-z0-9_-]"
            )
        os.makedirs(root, exist_ok=True)
        if not os.path.isdir(root):
            raise SegmentStoreError(f"segment store root {root!r} is not a directory")
        self.root = root
        self._cap_bytes = cap_bytes
        self._segment_max_bytes = max(1, segment_max_bytes)
        self._metrics = metrics
        # multi-block reads (get_many) and the optional open sweep verify
        # multihashes through ops.verify on this backend; a single-block
        # get() is the lane's one-block case, hashlib, so it calls that
        # directly
        if backend is None:
            from ipc_proofs_tpu_torch.backend import get_backend

            backend = get_backend("gpu")
        self._backend = backend
        self._owner = owner or ""
        self.shared = owner is not None
        self._lock = named_lock("SegmentStore._lock")
        # raw CID bytes -> (segment key, frame offset, frame length)
        self._index: "dict[bytes, tuple[str, int, int]]" = {}  # guarded-by: _lock
        # segment key (basename) -> _Segment, ordered coldest-first (LRU)
        self._segments: "OrderedDict[str, _Segment]" = OrderedDict()  # guarded-by: _lock
        self._total_bytes = 0  # guarded-by: _lock
        self._active: Optional[_Segment] = None  # guarded-by: _lock
        self._active_fh = None  # guarded-by: _lock
        self.degraded = False  # guarded-by: _lock
        self._warned = False  # guarded-by: _lock

        # -- index rebuild: scan every owner's segments, truncate
        #    torn/corrupt tails (only our own — another owner's tail may
        #    be mid-append right now and is theirs to repair on reopen)
        next_id = 1
        for name in sorted(os.listdir(root)):
            parsed = _parse_segment_name(name)
            if parsed is None:
                continue
            seg_owner, seg_id = parsed
            path = os.path.join(root, name)
            try:
                entries, good_size, dirty = _scan_segment(path)
            except OSError:
                continue  # vanished under a concurrent shared eviction
            if dirty and seg_owner == self._owner:
                with open(path, "r+b") as fh:
                    fh.truncate(good_size)
            seg = _Segment(name, seg_owner, seg_id, path, good_size)
            for cid_raw, off, frame_len in entries:
                if cid_raw in self._index:
                    # duplicate insert across segments (two writers raced a
                    # miss); keep the first, the bytes verify identically
                    continue
                self._index[cid_raw] = (name, off, frame_len)
                seg.raws.append(cid_raw)
            self._segments[name] = seg
            self._total_bytes += seg.size
            if seg_owner == self._owner:
                next_id = max(next_id, seg_id + 1)
        self._next_id = next_id  # guarded-by: _lock
        if verify_scan:
            self._verify_scan()

    # -- internals (call with _lock HELD) ---------------------------------

    @locked
    def _open_active_locked(self) -> None:
        name = _segment_name(self._owner, self._next_id)
        seg = _Segment(
            name, self._owner, self._next_id, os.path.join(self.root, name)
        )
        self._next_id += 1
        self._active_fh = open(seg.path, "ab")
        self._active = seg
        self._segments[name] = seg  # newest == hottest end

    @locked
    def _forget_segment_locked(self, key: str) -> None:
        """Drop one segment from the in-memory view (deleted on disk —
        by us or by another owner's eviction pass)."""
        seg = self._segments.pop(key, None)
        if seg is None:
            return
        self._total_bytes -= seg.size
        for cid_raw in seg.raws:
            entry = self._index.get(cid_raw)
            if entry is not None and entry[0] == key:
                del self._index[cid_raw]

    @locked
    def _evict_locked(self) -> None:
        if self.shared:
            self._evict_shared_locked()
            return
        while self._total_bytes > self._cap_bytes and len(self._segments) > 1:
            key, seg = next(iter(self._segments.items()))
            if self._active is not None and key == self._active.key:
                # the tail is somehow the coldest — never evict it; move it
                # to the hot end and stop
                self._segments.move_to_end(key)
                return
            self._forget_segment_locked(key)
            try:
                os.remove(seg.path)
            except OSError:
                pass  # fail-soft: the index entry is gone either way; a leftover file is reclaimed on next open
            metrics = self._metrics
            if metrics is not None:
                metrics.count("storex.evictions")
            self._gauge_locked()

    @locked
    def _evict_shared_locked(self) -> None:
        """Cross-process eviction: serialize with the other owners via the
        ``evict.lock`` flock, then evict against the DIRECTORY total (our
        in-memory total only sees segments we know about)."""
        if fcntl is None:  # pragma: no cover - non-POSIX
            # no POSIX file locks: behave like the single-writer store
            # (honest degradation — still never evicts our own tail)
            self.shared = False
            self._evict_locked()
            self.shared = True
            return
        try:
            # lock-order: SegmentStore._lock < flock:storex.evict
            with flock_frame(
                os.path.join(self.root, _EVICT_LOCK_NAME), "storex.evict"
            ):
                self._evict_shared_under_flock_locked()
        except OSError:
            return  # fail-soft: an unopenable lock file skips this pass; the next roll retries

    @locked
    def _evict_shared_under_flock_locked(self) -> None:
        # directory truth: every owner's segments, sizes/ages from disk
        files: "dict[str, tuple[str, int, int, float]]" = {}
        for name in os.listdir(self.root):
            try:
                parsed = _parse_segment_name(name)
            except SegmentStoreError:
                continue  # foreign residue is not ours to judge here
            if parsed is None:
                continue
            try:
                st = os.stat(os.path.join(self.root, name))
            except OSError:
                continue
            files[name] = (parsed[0], parsed[1], st.st_size, st.st_mtime)

        # reconcile: segments we indexed that another owner already
        # evicted (their pass counted it; we only fix our accounting)
        for key in [k for k in self._segments if k not in files]:
            if self._active is not None and key == self._active.key:
                continue
            self._forget_segment_locked(key)

        total = sum(size for _, _, size, _ in files.values())
        if total <= self._cap_bytes:
            self._gauge_locked()
            return

        # never evict ANY owner's highest-id segment: ids grow
        # monotonically per owner, so that is some process's active tail
        per_owner_max: "dict[str, tuple[int, str]]" = {}
        for name, (owner, seg_id, _, _) in files.items():
            cur = per_owner_max.get(owner)
            if cur is None or seg_id > cur[0]:
                per_owner_max[owner] = (seg_id, name)
        protected = {name for _, name in per_owner_max.values()}
        if self._active is not None:
            protected.add(self._active.key)

        # victims: our own LRU-cold segments first (we know their heat),
        # then other owners' oldest-mtime segments (mtime is the only
        # cross-process recency signal we have)
        own = [
            key
            for key in self._segments
            if key in files and files[key][0] == self._owner
        ]
        foreign = sorted(
            (name for name, meta in files.items() if meta[0] != self._owner),
            key=lambda name: (files[name][3], name),
        )
        metrics = self._metrics
        for name in [*own, *foreign]:
            if total <= self._cap_bytes:
                break
            if name in protected:
                continue
            try:
                os.remove(os.path.join(self.root, name))
            except OSError:
                continue  # fail-soft: an unremovable file just stays; the cap re-checks next roll
            total -= files[name][2]
            self._forget_segment_locked(name)
            if metrics is not None:
                metrics.count("storex.evictions")
                metrics.count("storex.shared_evictions")
        self._gauge_locked()

    @locked
    def _gauge_locked(self) -> None:
        metrics = self._metrics
        if metrics is not None:
            metrics.set_gauge("storex.disk_bytes", self._total_bytes)

    def _drop_entry(self, cid_raw: bytes, entry: "tuple[str, int, int]") -> None:
        with self._lock:
            if self._index.get(cid_raw) == entry:
                del self._index[cid_raw]

    # -- public API -------------------------------------------------------

    def get(self, cid: CID) -> Optional[bytes]:
        """Verified read: frame CRC + multihash (scalar lane), or a counted
        miss; a corrupt frame is evicted so the caller's refetch repopulates
        a clean copy."""
        return self.get2(cid)[0]

    def get2(self, cid: CID) -> "tuple[Optional[bytes], str]":
        """`get` plus the miss reason: ``(data, "hit")``, ``(None, "miss")``
        (never indexed, or evicted under us) or ``(None, "corrupt")`` (the
        frame was here, failed CRC or multihash and was just evicted). The
        tiered store tries a replica repair on ``"corrupt"`` only: a plain
        miss has no reason to exist on a peer, a corrupt frame's bytes
        almost certainly do."""
        cid_raw = cid.to_bytes()
        entry, path = self._lookup_entry(cid_raw)
        metrics = self._metrics
        if entry is None:
            if metrics is not None:
                metrics.count("storex.disk_misses")
            return None, "miss"
        _key, off, frame_len = entry
        data = self._read_verified(cid, cid_raw, path, off, frame_len)
        if data is None:
            self._drop_entry(cid_raw, entry)
            if metrics is not None:
                metrics.count("storex.integrity_evictions")
                metrics.count("storex.disk_misses")
            return None, "corrupt"
        if metrics is not None:
            metrics.count("storex.disk_hits")
        return data, "hit"

    def _read_frame(
        self, cid_raw: bytes, path: str, off: int, frame_len: int
    ) -> Optional[bytes]:
        """Frame half of the verify-twice read: CRC + cid-raw match. The
        multihash half runs in the caller (scalar in `get`, one fused
        batch in `get_many`/`_verify_scan`)."""
        try:
            with open(path, "rb") as fh:
                fh.seek(off)
                frame = fh.read(frame_len)
        except OSError:
            return None  # segment evicted/unreadable under us: plain miss
        return self._frame_payload(cid_raw, frame, frame_len)

    @staticmethod
    def _frame_payload(cid_raw: bytes, frame, frame_len: int):
        """Validate one framed block (magic, length, CRC, cid match) and
        return its payload slice, or None."""
        if len(frame) != frame_len or frame_len < FRAME_HEADER.size + _CID_LEN.size:
            return None
        magic, length, crc = FRAME_HEADER.unpack_from(frame, 0)
        if magic != SEGMENT_MAGIC or FRAME_HEADER.size + length != frame_len:
            return None
        payload = frame[FRAME_HEADER.size :]
        if zlib.crc32(payload) != crc:
            return None
        (cid_len,) = _CID_LEN.unpack_from(payload, 0)
        if _CID_LEN.size + cid_len > length:
            return None
        if payload[_CID_LEN.size : _CID_LEN.size + cid_len] != cid_raw:
            return None
        return payload[_CID_LEN.size + cid_len :]

    def read_frame_slice(self, cid: CID) -> "Optional[memoryview]":
        """Zero-copy read: a CRC-verified ``memoryview`` over the block's
        bytes inside an mmap of its segment file, or None (the caller
        falls back to the copying ``get`` path — availability, never
        correctness).

        Eviction-safe without holding any lock across the read: the
        mapping is established while the segment file still exists (an
        open/mmap racing a foreign eviction fails and reports a miss), and
        once mapped the pages stay valid even after the file is unlinked;
        the returned memoryview pins the mmap object through the buffer
        protocol. The frame CRC is verified against the mapped bytes
        BEFORE the slice is returned, so a reader never observes torn
        bytes: the whole committed frame or a miss. The multihash is not
        re-run here: every ingest path already verified the bytes against
        the CID, and re-hashing would force the copy this read avoids.
        """
        cid_raw = cid.to_bytes()
        entry, path = self._lookup_entry(cid_raw)
        metrics = self._metrics
        if entry is None:
            if metrics is not None:
                metrics.count("storex.slice_misses")
            return None
        _key, off, frame_len = entry
        try:
            with open(path, "rb") as fh:
                mm = mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_READ)
        except (OSError, ValueError):
            # vanished (foreign eviction) or empty under us: plain miss
            if metrics is not None:
                metrics.count("storex.slice_misses")
            return None
        view = memoryview(mm)
        payload = None
        if off + frame_len <= len(mm):
            payload = self._frame_payload(cid_raw, view[off : off + frame_len], frame_len)
        if payload is None:
            view.release()
            mm.close()
            self._drop_entry(cid_raw, entry)
            if metrics is not None:
                metrics.count("storex.integrity_evictions")
                metrics.count("storex.slice_misses")
            return None
        if metrics is not None:
            metrics.count("storex.slice_hits")
        return payload

    def _read_verified(
        self, cid: CID, cid_raw: bytes, path: str, off: int, frame_len: int
    ) -> Optional[bytes]:
        data = self._read_frame(cid_raw, path, off, frame_len)
        if data is None or not verify_block_bytes(cid, data):
            return None
        return data

    def _lookup_entry(self, cid_raw: bytes) -> "tuple[tuple, str] | tuple[None, None]":
        """Index lookup + LRU touch + tail flush for one raw CID; returns
        (entry, segment path) or (None, None) on a miss."""
        with self._lock:
            entry = self._index.get(cid_raw)
            path = None
            if entry is not None:
                seg = self._segments.get(entry[0])
                if seg is not None:
                    self._segments.move_to_end(entry[0])
                    path = seg.path
                # an active-tail read must see buffered bytes
                if (
                    self._active is not None
                    and entry[0] == self._active.key
                    and self._active_fh is not None
                ):
                    self._active_fh.flush()
        if entry is None or path is None:
            return None, None
        return entry, path

    def get_many(self, cids) -> "dict[CID, bytes]":
        """Batched verified read: per-frame CRC exactly as `get`, then the
        multihash half of every surviving payload in ONE
        `verify_blocks_batch` call. Per-cid miss/eviction accounting
        matches N scalar `get` calls tick for tick."""
        metrics = self._metrics
        pending: "list[tuple[CID, bytes, tuple, bytes]]" = []
        for cid in cids:
            cid_raw = cid.to_bytes()
            entry, path = self._lookup_entry(cid_raw)
            if entry is None:
                if metrics is not None:
                    metrics.count("storex.disk_misses")
                continue
            _key, off, frame_len = entry
            data = self._read_frame(cid_raw, path, off, frame_len)
            if data is None:
                self._drop_entry(cid_raw, entry)
                if metrics is not None:
                    metrics.count("storex.integrity_evictions")
                    metrics.count("storex.disk_misses")
                continue
            pending.append((cid, cid_raw, entry, data))
        if not pending:
            return {}
        oks = verify_blocks_batch(
            [p[0] for p in pending], [p[3] for p in pending], metrics=metrics,
            backend=self._backend,
        )
        out: "dict[CID, bytes]" = {}
        for (cid, cid_raw, entry, data), ok in zip(pending, oks):
            if not ok:
                self._drop_entry(cid_raw, entry)
                if metrics is not None:
                    metrics.count("storex.integrity_evictions")
                    metrics.count("storex.disk_misses")
                continue
            out[cid] = data
            if metrics is not None:
                metrics.count("storex.disk_hits")
        return out

    def _verify_scan(self) -> None:
        """Open-time integrity sweep (``verify_scan=True``): re-verify every
        rebuilt index entry's multihash, one fused batch per segment (the
        rebuild scan itself only proves frame CRCs). Corrupt entries drop
        from the index — the availability-not-correctness rule at startup
        granularity."""
        with self._lock:
            segments = [
                (seg.path, list(seg.raws)) for seg in self._segments.values()
            ]
        for path, raws in segments:
            todo: "list[tuple[CID, bytes, tuple, bytes]]" = []
            for cid_raw in raws:
                with self._lock:
                    entry = self._index.get(cid_raw)
                if entry is None:
                    continue
                data = self._read_frame(cid_raw, path, entry[1], entry[2])
                try:
                    cid = CID.from_bytes(cid_raw)
                except Exception:  # fail-soft: unparseable cid drops below
                    data = None  # unverifiable entry: treat as corrupt
                    cid = None
                if data is None:
                    self._drop_entry(cid_raw, entry)
                    if self._metrics is not None:
                        self._metrics.count("storex.integrity_evictions")
                    continue
                todo.append((cid, cid_raw, entry, data))
            if not todo:
                continue
            oks = verify_blocks_batch(
                [t[0] for t in todo], [t[3] for t in todo], metrics=self._metrics,
                backend=self._backend,
            )
            for (cid, cid_raw, entry, _data), ok in zip(todo, oks):
                if not ok:
                    self._drop_entry(cid_raw, entry)
                    if self._metrics is not None:
                        self._metrics.count("storex.integrity_evictions")

    def put(self, cid: CID, data: bytes) -> bool:
        """Append one block (True iff it reached the segment tail)."""
        data = bytes(data)
        cid_raw = cid.to_bytes()
        payload = _CID_LEN.pack(len(cid_raw)) + cid_raw + data
        frame = (
            FRAME_HEADER.pack(SEGMENT_MAGIC, len(payload), zlib.crc32(payload))
            + payload
        )
        with self._lock:
            if self.degraded:
                return False
            if cid_raw in self._index:
                return True  # content-addressed: already present, identical
            try:
                if self._active_fh is None:
                    self._open_active_locked()
                off = self._active.size
                self._active_fh.write(frame)
                self._active_fh.flush()
            except OSError as exc:
                # ENOSPC/EROFS: degrade to read-only — the warm tier keeps
                # serving what it has, new blocks just stop spilling
                self.degraded = True
                metrics = self._metrics
                if metrics is not None:
                    metrics.count("storex.write_failures")
                if not self._warned:
                    self._warned = True
                    logger.warning(
                        "segment store %s unwritable (%s) — degrading to "
                        "read-only", self.root, exc,
                    )
                return False
            key = self._active.key
            self._index[cid_raw] = (key, off, len(frame))
            self._active.raws.append(cid_raw)
            self._active.size += len(frame)
            self._total_bytes += len(frame)
            self._segments.move_to_end(key)
            rolled = False
            if self._active.size >= self._segment_max_bytes:
                try:
                    self._active_fh.close()
                except OSError:
                    pass  # fail-soft: the bytes are flushed; a close error does not lose them
                self._active_fh = None
                self._active = None
                rolled = True
            # shared mode re-checks the directory only on a roll (or when
            # our own view is over cap): stat-ing N owners' files per put
            # would put a syscall storm on the hot path
            if not self.shared or rolled or self._total_bytes > self._cap_bytes:
                self._evict_locked()
            self._gauge_locked()
        return True

    def contains(self, cid: CID) -> bool:
        with self._lock:
            return cid.to_bytes() in self._index

    @property
    def owner(self) -> str:
        """This writer's owner token (``""`` for a single-writer store)."""
        return self._owner

    def __len__(self) -> int:
        with self._lock:
            return len(self._index)

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._index),
                "bytes": self._total_bytes,
                "cap_bytes": self._cap_bytes,
                "segments": len(self._segments),
                "degraded": self.degraded,
                "owner": self._owner or None,
                "shared": self.shared,
            }

    def close(self) -> None:
        with self._lock:
            if self._active_fh is not None:
                try:
                    self._active_fh.close()
                except OSError:
                    pass  # fail-soft: flushed bytes survive; rebuild handles any residue
                self._active_fh = None
                self._active = None

    def __enter__(self) -> "SegmentStore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- replication surface ---------------------------------------------
    #
    # Segments are append-only CRC-framed files, so replicating one is a
    # whole-file copy plus an index scan — no re-serialization. These are
    # the primitives `storex.replica` and the shard HTTP pull route build
    # on: list what exists, hand out raw file bytes, ingest a peer's file.

    def segment_files(self) -> "list[dict]":
        """The current segment inventory: ``{name, owner, size, active}``
        per segment, sorted by name. ``active`` marks a tail some process
        may still be appending to — replication pulls skip those (their
        bytes move once they roll)."""
        with self._lock:
            active_key = self._active.key if self._active is not None else None
            out = []
            for key, seg in self._segments.items():
                out.append({
                    "name": key,
                    "owner": seg.owner or None,
                    "size": seg.size,
                    "active": key == active_key,
                })
        out.sort(key=lambda d: d["name"])
        return out

    def segment_path(self, name: str) -> Optional[str]:
        """Absolute path of a segment this store currently indexes, or
        None. Validates the name shape so a traversal-y request string
        can never address outside the root."""
        if _parse_segment_name(name) is None:
            return None
        with self._lock:
            seg = self._segments.get(name)
            if seg is None:
                return None
            if (
                self._active is not None
                and name == self._active.key
                and self._active_fh is not None
            ):
                self._active_fh.flush()  # serve committed tail bytes
            return seg.path

    def ingest_segment_file(self, name: str, data: bytes) -> int:
        """Adopt a peer's whole segment file: atomic tmp-write +
        ``os.replace`` into the root, then index its frames. Returns the
        number of blocks newly indexed (frames whose CID we already hold
        index nowhere — content-addressed, the bytes are identical).

        The file keeps its origin name, so the owner token stays truthful
        (``seg-s0.*`` on s1's disk is visibly a replica of s0's data) and
        a re-ingest of the same name is a no-op. Ingesting under our OWN
        owner token is refused — it would collide with our append id
        space."""
        parsed = _parse_segment_name(name)
        if parsed is None:
            raise SegmentStoreError(f"{name!r} is not a segment file name")
        if parsed[0] == self._owner:
            raise SegmentStoreError(
                f"refusing to ingest {name!r} under our own owner token"
            )
        path = os.path.join(self.root, name)
        tmp = path + ".ingest.tmp"
        with self._lock:
            if name in self._segments:
                return 0  # already replicated (or raced another pull)
            if self.degraded:
                return 0
            try:
                with open(tmp, "wb") as fh:
                    fh.write(data)
                    fh.flush()
                entries, good_size, _dirty = _scan_segment(tmp)
                os.replace(tmp, path)
            except OSError as exc:
                try:
                    os.remove(tmp)
                except OSError:
                    pass
                logger.warning("segment ingest of %s failed: %s", name, exc)
                return 0
            seg = _Segment(name, parsed[0], parsed[1], path, good_size)
            fresh = 0
            for cid_raw, off, frame_len in entries:
                if cid_raw in self._index:
                    continue
                self._index[cid_raw] = (name, off, frame_len)
                seg.raws.append(cid_raw)
                fresh += 1
            self._segments[name] = seg
            self._total_bytes += seg.size
            self._evict_locked()
            self._gauge_locked()
        return fresh

    def drop_segment(self, name: str) -> bool:
        """Forget + delete one non-active segment (the post-handoff half
        of a rebalance: once the new owner holds the bytes, the old
        owner's copy is just cap pressure). Never drops the active tail."""
        with self._lock:
            if self._active is not None and name == self._active.key:
                return False
            seg = self._segments.get(name)
            if seg is None:
                return False
            self._forget_segment_locked(name)
            try:
                os.remove(seg.path)
            except OSError:
                pass  # fail-soft: the index entry is gone either way
            self._gauge_locked()
        return True
