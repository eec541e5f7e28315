"""Durable standing-query subscription registry.

A subscription is a (filter, delivery target) pair keyed by a caller- or
server-assigned subscription id. Filters are the same shape the proof
planes already serve — an event leg ``(signature, topic1, actor_id)``
plus an optional storage-slot leg ``(actor_id, slot)`` — so the matcher
can compile them straight into `EventProofSpec` / `StorageProofSpec`.

Durability rides the existing ``IPJ1`` journal framing
(`jobs.journal.JournalWriter`): every subscribe/unsubscribe appends one
CRC-framed record to ``<root>/subs.bin`` and a restart replays the log,
so registrations survive SIGKILL. Re-subscribing an existing id with the
same filter is a no-op (``subs.replays_absorbed``) — that idempotence is
what lets cluster shard failover re-register arcs under their ORIGINAL
subscription ids without duplicating state.

Journal write failures (ENOSPC/EROFS) are fail-soft like the serve
queue's: the append is counted (``subs.log_failures``), the registry
keeps serving from memory, and only durability degrades — never the run.
"""

from __future__ import annotations

import hashlib
import json
import os
import uuid
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from ipc_proofs_tpu_torch.jobs.journal import JournalWriter, read_journal_entries
from ipc_proofs_tpu_torch.utils.lockdep import named_lock
from ipc_proofs_tpu_torch.utils.log import get_logger
from ipc_proofs_tpu_torch.utils.metrics import Metrics, get_metrics
from ipc_proofs_tpu_torch.utils.threads import locked

__all__ = [
    "Subscription",
    "SubscriptionRegistry",
    "filter_key",
    "normalize_filter",
    "normalize_target",
    "subscription_ring_key",
]

logger = get_logger(__name__)

REGISTRY_JOURNAL = "subs.bin"


def normalize_filter(obj: Any) -> dict:
    """Validate and canonicalize a subscription filter.

    Required: ``signature`` (event signature string) and ``topic1``
    (the subnet topic — `EventMatcher` matches both topics uncondition-
    ally). Optional: ``actor_id`` (int emitter filter), ``slot``
    (64-char hex of the 32-byte storage-slot preimage digest; requires
    ``actor_id`` because a slot proves against a specific actor's state).
    Unknown keys are rejected so a typo'd filter fails loudly at
    registration instead of silently never matching.
    """
    if not isinstance(obj, dict):
        raise ValueError("filter must be a JSON object")
    unknown = set(obj) - {"signature", "topic1", "actor_id", "slot"}
    if unknown:
        raise ValueError(f"unknown filter keys: {sorted(unknown)}")
    sig = obj.get("signature")
    if not isinstance(sig, str) or not sig:
        raise ValueError("filter.signature (event signature string) is required")
    topic1 = obj.get("topic1")
    if not isinstance(topic1, str) or not topic1:
        raise ValueError("filter.topic1 (subnet topic string) is required")
    out: dict = {"signature": sig, "topic1": topic1}
    actor_id = obj.get("actor_id")
    if actor_id is not None:
        if isinstance(actor_id, bool) or not isinstance(actor_id, int):
            raise ValueError("filter.actor_id must be an integer")
        out["actor_id"] = actor_id
    slot = obj.get("slot")
    if slot is not None:
        if not isinstance(slot, str):
            raise ValueError("filter.slot must be a hex string")
        try:
            raw = bytes.fromhex(slot)
        except ValueError:
            raise ValueError("filter.slot must be valid hex")
        if len(raw) != 32:
            raise ValueError("filter.slot must be 32 bytes (64 hex chars)")
        if "actor_id" not in out:
            raise ValueError("filter.slot requires filter.actor_id")
        out["slot"] = slot.lower()
    return out


def normalize_target(obj: Any) -> dict:
    """Validate a delivery target: webhook POST or long-poll fallback."""
    if obj is None:
        return {"mode": "poll"}
    if not isinstance(obj, dict):
        raise ValueError("target must be a JSON object")
    mode = obj.get("mode") or ("webhook" if obj.get("url") else "poll")
    if mode == "poll":
        return {"mode": "poll"}
    if mode == "webhook":
        url = obj.get("url")
        if not isinstance(url, str) or "://" not in url:
            raise ValueError("webhook target needs a url")
        return {"mode": "webhook", "url": url}
    raise ValueError(f"unknown target mode {mode!r}")


def filter_key(filt: dict) -> str:
    """Canonical identity of a filter — the matcher's amortization unit.

    Two subscriptions with equal ``filter_key`` share ONE generation per
    tipset pair; the bundle fans out to both.
    """
    return json.dumps(filt, sort_keys=True, separators=(",", ":"))


def subscription_ring_key(filt: dict) -> str:
    """Ring placement key for a subscription, by its canonical filter.

    Plays the role `cluster.hashring.pair_ring_key` plays for proof
    requests: a stable string the `HashRing` sha256-hashes onto an arc.
    Keying by filter (not sub id) lands every subscriber of one filter on
    the same shard, so the per-shard matcher still generates once per
    distinct filter — fan-out amortization survives sharding.
    """
    return "subs:" + hashlib.sha256(filter_key(filt).encode("utf-8")).hexdigest()


@dataclass(frozen=True)
class Subscription:
    """One registered standing query."""

    sub_id: str
    filter: dict
    target: dict

    def to_json_obj(self) -> dict:
        return {"sub_id": self.sub_id, "filter": self.filter, "target": self.target}


class SubscriptionRegistry:
    """IPJ1-journaled subscription table; survives SIGKILL via replay."""

    def __init__(self, root: str, metrics: Optional[Metrics] = None, fsync: bool = True):
        os.makedirs(root, exist_ok=True)
        self.path = os.path.join(root, REGISTRY_JOURNAL)
        self._metrics = metrics if metrics is not None else get_metrics()
        self._lock = named_lock("SubscriptionRegistry._lock")
        self._subs: Dict[str, Subscription] = {}  # guarded-by: _lock
        self.replayed = 0
        if os.path.exists(self.path):
            entries, good_offset, torn = read_journal_entries(self.path)
            if torn:
                logger.warning(
                    "subscription journal %s has a torn tail — truncating to "
                    "last good frame at %d",
                    self.path,
                    good_offset,
                )
                with open(self.path, "r+b") as fh:
                    fh.truncate(good_offset)
            for rec, _off, _end in entries:
                self._replay(rec)
            self.replayed = len(entries)
        self._writer = JournalWriter(self.path, metrics=self._metrics, fsync=fsync)
        self._metrics.set_gauge("subs.active", len(self._subs))

    @locked  # construction-time only: runs before the registry is published
    def _replay(self, rec: Any) -> None:
        if not isinstance(rec, dict):
            return
        op = rec.get("op")
        if op == "sub":
            try:
                sub = Subscription(
                    sub_id=str(rec["id"]),
                    filter=normalize_filter(rec["filter"]),
                    target=normalize_target(rec.get("target")),
                )
            except (KeyError, ValueError):
                return  # fail-soft: a bad frame degrades one record, not the replay
            self._subs[sub.sub_id] = sub
        elif op == "unsub":
            self._subs.pop(str(rec.get("id")), None)

    @property
    def degraded(self) -> bool:
        return self._writer.degraded

    @property
    def journal_bytes(self) -> int:
        return self._writer.journal_bytes

    @locked
    def _append(self, rec: dict) -> None:
        """Journal one frame; a registration is only durable if the frame
        lands before the caller is acked, hence under the lock."""
        if not self._writer.append(rec):  # ipclint: disable=lock-held-blocking (durability: frame lands before the caller is acked)
            self._metrics.count("subs.log_failures")

    def subscribe(
        self, filt: Any, target: Any = None, sub_id: Optional[str] = None
    ) -> "tuple[Subscription, bool]":
        """Register a standing query; returns ``(subscription, created)``.

        Re-registering an existing ``sub_id`` is absorbed idempotently
        (``created=False``) — the durable dedup that makes cluster
        failover re-registration and journal replays safe.
        """
        filt = normalize_filter(filt)
        target = normalize_target(target)
        sub_id = str(sub_id) if sub_id else uuid.uuid4().hex
        with self._lock:
            existing = self._subs.get(sub_id)
            if existing is not None:
                self._metrics.count("subs.replays_absorbed")
                return existing, False
            sub = Subscription(sub_id=sub_id, filter=filt, target=target)
            self._subs[sub_id] = sub
            self._append({"op": "sub", "id": sub_id, "filter": filt, "target": target})
            self._metrics.count("subs.registered")
            self._metrics.set_gauge("subs.active", len(self._subs))
        return sub, True

    def unsubscribe(self, sub_id: str) -> bool:
        with self._lock:
            sub = self._subs.pop(str(sub_id), None)
            if sub is None:
                return False
            self._append({"op": "unsub", "id": sub.sub_id})
            self._metrics.count("subs.unsubscribed")
            self._metrics.set_gauge("subs.active", len(self._subs))
        return True

    def get(self, sub_id: str) -> Optional[Subscription]:
        with self._lock:
            return self._subs.get(str(sub_id))

    def active(self) -> List[Subscription]:
        with self._lock:
            return list(self._subs.values())

    def __len__(self) -> int:
        with self._lock:
            return len(self._subs)

    def close(self) -> None:
        self._writer.close()
