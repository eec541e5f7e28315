"""Provenance registry: the append-only audit log + fleet base directory.

One `ProvenanceRegistry` per serving process. It owns exactly one log
file, ``reg-<owner>.log`` in a directory the whole fleet shares — the
same multi-writer layout as the shared segment tier: every writer has a
single-writer file, readers scan siblings. Each log is independently a
hash chain (every record links the digest of its predecessor) *and*
feeds an RFC 6962 Merkle tree, so the process can publish a checkpoint
root and answer inclusion / consistency proofs about everything it ever
served.

Two record kinds share the chain:

``serve``
    Sealed at response time for every bundle that left this process —
    bundle digest, trace id, tenant, pair/filter key, verdict summary,
    wall time, and the bundle's canonical CID set. The CID set is what
    turns the audit log into a **delta base directory**: any shard that
    knows a digest can recover the base's CID set from whichever shard
    served it, without having held the bundle itself.

``base``
    A subscriber-fleet ack: (fleet, filter key, subscriber, digest,
    cursor). Fed by the delivery log's ack path, these let any shard
    compute the newest base digest acked by *every* member of a fleet —
    the base a post-failover delta can safely build on.

Fail-soft is absolute: a write failure degrades the registry
(``registry.append_failures``, `/healthz` reports it) but the in-memory
head never advances on a failed write and serving continues
bit-identical. A torn tail on open is crash residue — truncated and
counted, exactly like the jobs journal. Anything else wrong with the
bytes raises the typed `RegistryError`.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, List, Optional, Tuple

from ipc_proofs_tpu_torch.registry.log import (
    RegistryError,
    RegistryWriter,
    frame_registry_record,
    read_registry_frames,
    record_digest,
)
from ipc_proofs_tpu_torch.registry.mmr import MerkleLog, leaf_hash
from ipc_proofs_tpu_torch.utils.lockdep import named_lock
from ipc_proofs_tpu_torch.utils.log import get_logger
from ipc_proofs_tpu_torch.utils.threads import locked

__all__ = ["ProvenanceRegistry"]

logger = get_logger(__name__)

_LOG_PREFIX = "reg-"
_LOG_SUFFIX = ".log"


def _log_name(owner: str) -> str:
    safe = "".join(c if (c.isalnum() or c in "-_.") else "_" for c in owner)
    return f"{_LOG_PREFIX}{safe}{_LOG_SUFFIX}"


class ProvenanceRegistry:
    """Thread-safe provenance log + fleet-wide base directory.

    ``owner`` names this process's log file; every other ``reg-*.log``
    in ``root`` is a sibling shard's chain, folded into the directory
    lazily (on a base-lookup miss) and incrementally (from the last
    verified offset). Sibling trouble is fail-soft:
    ``registry.fleet_refresh_errors`` counts it, lookups just miss.
    """

    def __init__(
        self,
        root: str,
        owner: str = "main",
        metrics=None,
        *,
        fsync: bool = False,
        record_cids: bool = True,
    ):
        self.root = root
        self.owner = owner
        self.record_cids = record_cids
        self._metrics = metrics
        os.makedirs(root, exist_ok=True)
        self.path = os.path.join(root, _log_name(owner))
        # lock-order: ProvenanceRegistry._lock is leaf — nothing else is
        # acquired while held (Metrics._lock is declared globally-last
        # and exempt)
        self._lock = named_lock("ProvenanceRegistry._lock")
        self._records: List[Dict[str, Any]] = []  # guarded-by: _lock
        self._mmr = MerkleLog()  # guarded-by: _lock
        self._tip = ""  # guarded-by: _lock — digest of last payload
        self._digest_seq: Dict[str, int] = {}  # guarded-by: _lock
        # fleet base directory (own records + verified sibling records):
        self._base_cids: Dict[str, frozenset] = {}  # guarded-by: _lock
        # (fleet, key) -> sub -> (cursor, digest)  [latest ack per member]
        self._acks: Dict[Tuple[str, str], Dict[str, Tuple[int, str]]] = {}  # guarded-by: _lock
        # (fleet, key) -> digest -> set of subs that ever acked it
        self._ack_sets: Dict[Tuple[str, str], Dict[str, set]] = {}  # guarded-by: _lock
        # (fleet, key) -> digest -> monotonic ingest order (newest wins)
        self._ack_order: Dict[Tuple[str, str], Dict[str, int]] = {}  # guarded-by: _lock
        self._order = 0  # guarded-by: _lock
        # sibling owner -> [verified offset, chain tip]
        self._siblings: Dict[str, List] = {}  # guarded-by: _lock

        entries, good, torn = read_registry_frames(self.path)
        prev = ""
        for rec, payload, off in entries:
            got = rec.get("prev") if isinstance(rec, dict) else None
            if got != prev:
                raise RegistryError(
                    f"registry chain broken at offset {off} in {self.path}: "
                    f"record links prev={got!r}, expected {prev!r}"
                )
            prev = record_digest(payload)
            self._ingest_locked(rec, payload)
        if torn:
            if metrics is not None:
                metrics.count("registry.torn_tails")
            logger.warning(
                "registry log %s: torn tail truncated at offset %d "
                "(crash residue)", self.path, good,
            )
        self._writer = RegistryWriter(self.path, metrics=metrics, fsync=fsync)
        self._writer.truncate(good)

    # -- ingest ------------------------------------------------------------

    @locked  # construction-time callers run before the registry is published
    def _ingest_locked(self, rec: Dict[str, Any], payload: bytes) -> None:
        """Fold one verified own-log record into chain + tree + directory.
        Caller holds _lock (or is the single-threaded constructor)."""
        seq = len(self._records)
        self._records.append(rec)
        self._mmr.append(leaf_hash(payload))
        self._tip = record_digest(payload)
        self._fold_directory_locked(rec)
        digest = rec.get("digest")
        if rec.get("kind") == "serve" and digest:
            self._digest_seq[digest] = seq

    @locked
    def _fold_directory_locked(self, rec: Dict[str, Any]) -> None:
        """Directory-only ingest — used for both own and sibling records."""
        kind = rec.get("kind")
        digest = rec.get("digest") or ""
        if kind == "serve":
            cids = rec.get("cids")
            if digest and isinstance(cids, list) and cids:
                try:
                    self._base_cids[digest] = frozenset(
                        bytes.fromhex(c) for c in cids
                    )
                except (TypeError, ValueError):
                    pass  # malformed CID list: directory miss, never a fault
        elif kind == "base":
            fleet = rec.get("fleet") or ""
            key = rec.get("key") or ""
            sub = rec.get("sub") or ""
            if not (digest and sub):
                return
            self._order += 1
            fk = (fleet, key)
            try:
                cursor = int(rec.get("cursor") or 0)
            except (TypeError, ValueError):
                cursor = 0
            latest = self._acks.setdefault(fk, {})
            have = latest.get(sub)
            if have is None or cursor >= have[0]:
                latest[sub] = (cursor, digest)
            self._ack_sets.setdefault(fk, {}).setdefault(digest, set()).add(sub)
            self._ack_order.setdefault(fk, {})[digest] = self._order

    # -- append ------------------------------------------------------------

    @locked
    def _append_locked(self, rec: Dict[str, Any]) -> Optional[int]:
        rec["prev"] = self._tip
        frame = frame_registry_record(rec)
        if not self._writer.append_frame(frame):  # ipclint: disable=lock-held-blocking (durability: the frame lands before the head advances)
            return None  # head does NOT advance on a failed write
        payload = frame[12:]
        seq = len(self._records)
        self._ingest_locked(rec, payload)
        if self._metrics is not None:
            self._metrics.count("registry.appends")
        return seq

    def append_served(
        self,
        digest: str,
        *,
        trace: str = "",
        tenant: str = "",
        key: str = "",
        verdict: str = "",
        cids: Optional[frozenset] = None,
        t: Optional[float] = None,
    ) -> Optional[int]:
        """Seal one served bundle into the chain; returns its sequence
        number, or None when the registry is degraded (fail-soft)."""
        rec: Dict[str, Any] = {
            "kind": "serve",
            "digest": digest,
            "trace": trace,
            "tenant": tenant,
            "key": key,
            "verdict": verdict,
            "t": round(time.time() if t is None else t, 3),
        }
        if self.record_cids and cids:
            rec["cids"] = sorted(c.hex() for c in cids)
        with self._lock:
            return self._append_locked(rec)

    def append_base_ack(
        self, fleet: str, key: str, sub: str, digest: str, cursor: int
    ) -> Optional[int]:
        """Record one subscriber's delta-base advance for the fleet.
        Idempotent per (sub, cursor, digest) — replaying acked state after
        a restart doesn't grow the chain."""
        rec = {
            "kind": "base",
            "fleet": fleet,
            "key": key,
            "sub": sub,
            "digest": digest,
            "cursor": int(cursor),
            "t": round(time.time(), 3),
        }
        with self._lock:
            have = self._acks.get((fleet, key), {}).get(sub)
            if have == (int(cursor), digest):
                return None  # already on the chain (restart replay)
            return self._append_locked(rec)

    # -- proofs ------------------------------------------------------------

    @property
    def degraded(self) -> bool:
        return self._writer.degraded

    def __len__(self) -> int:
        with self._lock:
            return len(self._records)

    def head(self) -> Dict[str, Any]:
        """The published checkpoint: owner, size, tree root, chain tip."""
        with self._lock:
            return {
                "owner": self.owner,
                "size": self._mmr.size,
                "root": self._mmr.root().hex(),
                "tip": self._tip,
                "log_bytes": self._writer.log_bytes,
                "degraded": self._writer.degraded,
            }

    def entry(self, seq: int) -> Optional[Dict[str, Any]]:
        with self._lock:
            if not 0 <= seq < len(self._records):
                return None
            return dict(self._records[seq], seq=seq)

    def seq_of(self, digest: str) -> Optional[int]:
        """The sequence of the (latest) serve record for a bundle digest."""
        with self._lock:
            return self._digest_seq.get(digest)

    def inclusion_proof(self, seq: int) -> Optional[Dict[str, Any]]:
        """O(log n) proof that record ``seq`` is under the current root."""
        with self._lock:
            if not 0 <= seq < self._mmr.size:
                return None
            out = {
                "seq": seq,
                "size": self._mmr.size,
                "root": self._mmr.root().hex(),
                "leaf": self._mmr.leaves[seq].hex(),
                "path": [h.hex() for h in self._mmr.inclusion_path(seq)],
                "record": dict(self._records[seq]),
            }
        if self._metrics is not None:
            self._metrics.count("registry.proofs")
        return out

    def consistency(self, old_size: int) -> Optional[Dict[str, Any]]:
        """Proof that the current tree extends the ``old_size`` checkpoint."""
        with self._lock:
            if not 0 <= old_size <= self._mmr.size:
                return None
            out = {
                "old_size": old_size,
                "size": self._mmr.size,
                "old_root": self._mmr.root_at(old_size).hex(),
                "root": self._mmr.root().hex(),
                "path": [
                    h.hex()
                    for h in (
                        self._mmr.consistency_path(old_size) if old_size else []
                    )
                ],
            }
        if self._metrics is not None:
            self._metrics.count("registry.proofs")
        return out

    # -- fleet base directory ----------------------------------------------

    def lookup_base(self, digest: str) -> Optional[frozenset]:
        """CID set of a base digest, from ANY shard's serve records.
        A miss triggers one incremental sibling rescan before giving up."""
        with self._lock:
            cids = self._base_cids.get(digest)
            if cids is not None:
                return cids
            self._refresh_fleet_locked()
            return self._base_cids.get(digest)

    def fleet_acked_base(
        self, fleet: str, key: str, sub: str
    ) -> Optional[str]:
        """The base digest ``sub`` last acked under ``(fleet, key)`` — as
        recorded by WHICHEVER shard served it. A replacement shard with a
        fresh delivery log uses this instead of its (empty) local acked
        state, so subscriber deltas survive the shard that held them.

        Always rescans the sibling logs first (incremental — per-sibling
        offsets): unlike ``lookup_base`` (content-addressed, a hit can't
        be stale) an ack is latest-wins, and this shard's own records may
        predate the ack another shard sealed after taking the sub over."""
        with self._lock:
            self._refresh_fleet_locked()
            have = self._acks.get((fleet, key), {}).get(sub)
            return have[1] if have else None

    def newest_common_base(self, fleet: str, key: str) -> Optional[str]:
        """The newest digest acked by EVERY observed member of
        ``(fleet, key)`` — the base a post-failover delta can build on.
        None when the fleet has no common base (serve full)."""
        with self._lock:
            self._refresh_fleet_locked()
            fk = (fleet, key)
            latest = self._acks.get(fk)
            if not latest:
                return None
            members = set(latest)
            common = [
                d
                for d, subs in self._ack_sets.get(fk, {}).items()
                if members <= subs
            ]
            if not common:
                return None
            order = self._ack_order.get(fk, {})
            return max(common, key=lambda d: order.get(d, -1))

    def refresh_fleet(self) -> None:
        """Fold new sibling-log records into the base directory."""
        with self._lock:
            self._refresh_fleet_locked()

    @locked
    def _refresh_fleet_locked(self) -> None:
        try:
            names = sorted(os.listdir(self.root))
        except OSError:
            if self._metrics is not None:
                self._metrics.count("registry.fleet_refresh_errors")
            return
        own = _log_name(self.owner)
        for name in names:
            if (
                not name.startswith(_LOG_PREFIX)
                or not name.endswith(_LOG_SUFFIX)
                or name == own
            ):
                continue
            state = self._siblings.setdefault(name, [0, ""])
            try:
                entries, good, _torn = read_registry_frames(
                    os.path.join(self.root, name), state[0]
                )
                prev = state[1]
                for rec, payload, off in entries:
                    got = rec.get("prev") if isinstance(rec, dict) else None
                    if got != prev:
                        raise RegistryError(
                            f"sibling chain broken at offset {off} in {name}"
                        )
                    prev = record_digest(payload)
                    self._fold_directory_locked(rec)
                state[0] = good
                state[1] = prev
            except (RegistryError, OSError) as exc:
                # a sibling's corruption must not take this shard down:
                # count it, stop ingesting that log, keep serving
                if self._metrics is not None:
                    self._metrics.count("registry.fleet_refresh_errors")
                logger.warning(
                    "registry sibling scan failed for %s: %s", name, exc
                )

    def close(self) -> None:
        self._writer.close()
