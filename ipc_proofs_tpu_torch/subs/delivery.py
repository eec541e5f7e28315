"""At-least-once proof delivery: append-only log + webhook push.

`DeliveryLog` is the durable half: one shared ``IPJ1`` journal
(``<root>/deliveries.bin``) holding every subscription's deliveries with
per-subscription **monotonic cursors**. A delivery's idempotency key is
derived from ``(sub_id, tipset, proof digest)``, so re-running the
matcher over a tipset it already served (follower restart, cluster
failover replay) dedups instead of double-delivering. Acks journal too:
unacked deliveries survive SIGKILL and are re-pushed after restart.

Payloads are content-addressed: the bundle JSON journals ONCE per proof
digest (a ``pay`` frame) and every subscriber's ``dlv`` frame references
it by digest — the on-disk fan-out cost of a 10k-subscriber filter is
10k tiny cursor frames plus one bundle, mirroring the matcher's
generate-once amortization. A payload is dropped from memory (and from
the next compaction) only when no unacked delivery references it.

Byte-capped truncation: when the journal exceeds ``cap_bytes`` it is
compacted to per-sub state records plus the still-unacked deliveries —
truncation only ever drops entries **below the acked cursor**, so an
unacked delivery is never lost to the cap. Journal write failures
(ENOSPC/EROFS) degrade fail-soft (``subs.log_failures``): the log keeps
serving from memory and the run completes.

`PushDelivery` is the webhook half: bounded full-jitter retry with the
same injectable ``opener``/``sleep``/``rng`` seams as
`obs.export.post_otlp_trace`, acking on 2xx. A push that exhausts its
retries leaves the delivery unacked — the long-poll
``/v1/deliveries?sub=<id>&cursor=<n>`` fallback and the next matcher
cycle's re-push both converge on it later (at-least-once, never
at-most-once).
"""

from __future__ import annotations

import hashlib
import json
import os
import random
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Set, Tuple
from urllib.error import HTTPError

from ipc_proofs_tpu_torch.jobs.journal import (
    JournalWriter,
    frame_record,
    read_journal_entries,
)
from ipc_proofs_tpu_torch.utils.lockdep import named_condition, named_lock
from ipc_proofs_tpu_torch.utils.log import get_logger
from ipc_proofs_tpu_torch.utils.threads import locked
from ipc_proofs_tpu_torch.utils.metrics import Metrics, get_metrics

__all__ = [
    "Delivery",
    "DeliveryLog",
    "PushDelivery",
    "delivery_idempotency_key",
]

logger = get_logger(__name__)

DELIVERY_JOURNAL = "deliveries.bin"
DEFAULT_LOG_CAP_BYTES = 64 << 20

# Retry policy mirrors obs.export.post_otlp_trace: retry throttle/server
# errors, fail fast on 4xx client errors.
_RETRYABLE_STATUSES = frozenset({429, 500, 502, 503, 504})


def delivery_idempotency_key(sub_id: str, tipset: int, digest: str) -> str:
    """Stable identity of one delivery: (sub_id, tipset, proof digest)."""
    raw = f"{sub_id}|{int(tipset)}|{digest}".encode("utf-8")
    return hashlib.sha256(raw).hexdigest()[:32]


@dataclass(frozen=True)
class Delivery:
    """One appended (not-yet-acked) proof delivery.

    ``digest`` is always the FULL canonical bundle digest (the client's
    post-expansion identity and the idempotency-key ingredient);
    ``payload_digest`` names the bytes actually shipped — identical to
    ``digest`` for full bundles, distinct for delta payloads, so the
    content-addressed payload store never conflates a delta with the
    full bundle it reconstructs."""

    sub_id: str
    cursor: int
    key: str
    tipset: int
    digest: str
    payload: dict
    payload_digest: str = ""

    def __post_init__(self):
        if not self.payload_digest:
            object.__setattr__(self, "payload_digest", self.digest)

    def to_json_obj(self) -> dict:
        return {
            "cursor": self.cursor,
            "idempotency_key": self.key,
            "tipset": self.tipset,
            "digest": self.digest,
            "payload": self.payload,
        }


@dataclass
class _SubLog:
    """Per-subscription delivery state (guarded by DeliveryLog._cond)."""

    next_cursor: int = 1
    acked: int = 0  # contiguous ack watermark: every cursor <= acked is acked
    acked_extra: Set[int] = field(default_factory=set)  # acks above the watermark
    entries: Dict[int, Delivery] = field(default_factory=dict)  # unacked, by cursor
    keys: Set[str] = field(default_factory=set)  # idempotency keys ever appended
    # delta-witness cursor hygiene: the FULL-bundle digest of the highest
    # acked delivery — the bundle this subscriber provably holds, i.e. the
    # only sound delta base. Persisted in sstate frames so compaction
    # dropping the acked entry (and its pay frame) never leaves a delta
    # referencing a base the log no longer knows about.
    base_digest: Optional[str] = None
    base_cursor: int = 0  # cursor whose ack set base_digest


class DeliveryLog:
    """Shared append-only delivery journal with per-sub monotonic cursors."""

    def __init__(
        self,
        root: str,
        metrics: Optional[Metrics] = None,
        cap_bytes: int = DEFAULT_LOG_CAP_BYTES,
        fsync: bool = True,
    ):
        os.makedirs(root, exist_ok=True)
        self.path = os.path.join(root, DELIVERY_JOURNAL)
        self.cap_bytes = max(1 << 16, int(cap_bytes))
        self._fsync = fsync
        self._metrics = metrics if metrics is not None else get_metrics()
        # The condition's lock guards ALL log state; long-poll waiters
        # block on it until an append lands for their subscription.
        self._cond = named_condition("DeliveryLog._cond")
        self._subs: Dict[str, _SubLog] = {}  # guarded-by: _cond
        # content-addressed payload store: digest → bundle payload, with a
        # refcount of unacked deliveries pointing at it
        self._payloads: Dict[str, dict] = {}  # guarded-by: _cond
        self._payload_refs: Dict[str, int] = {}  # guarded-by: _cond
        # running count of unacked entries across all subs — the gauges
        # publish on every append/ack, so this must be O(1), not a sweep
        self._pending = 0  # guarded-by: _cond
        # idempotency key → append monotonic time, for the delivery-lag
        # histogram; replayed deliveries have no entry (lag across a
        # restart would be measuring downtime, not delivery)
        self._append_ts: Dict[str, float] = {}  # guarded-by: _cond
        # fleet base-directory feed (set_base_reporter): called AFTER the
        # lock is released with (sub_id, base_digest, base_cursor) whenever
        # an ack advances a sub's delta base — the callback may take its
        # own locks (provenance registry) so it must never run under _cond
        self._base_reporter = None
        self.replayed = 0
        if os.path.exists(self.path):
            entries, good_offset, torn = read_journal_entries(self.path)
            if torn:
                logger.warning(
                    "delivery journal %s has a torn tail — truncating to "
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
        self._publish_gauges_locked()

    # ------------------------------------------------------------------ replay

    @locked
    def _sub(self, sub_id: str) -> _SubLog:
        sl = self._subs.get(sub_id)
        if sl is None:
            sl = self._subs[sub_id] = _SubLog()
        return sl

    @locked  # construction-time only: runs before the log is published
    def _replay(self, rec: Any) -> None:
        if not isinstance(rec, dict):
            return
        op = rec.get("op")
        try:
            if op == "pay":
                self._payloads[str(rec["digest"])] = rec.get("payload") or {}
            elif op == "dlv":
                sl = self._sub(str(rec["sub"]))
                cursor = int(rec["cursor"])
                digest = str(rec["digest"])
                # dlv frames reference their payload by payload digest
                # (== digest for full bundles); an inline "payload" key is
                # the pre-content-addressing format
                pdigest = str(rec.get("pdigest") or digest)
                payload = (
                    rec["payload"]
                    if "payload" in rec
                    else self._payloads.get(pdigest, {})
                )
                d = Delivery(
                    sub_id=str(rec["sub"]),
                    cursor=cursor,
                    key=str(rec["key"]),
                    tipset=int(rec["tipset"]),
                    digest=digest,
                    payload=payload or {},
                    payload_digest=pdigest,
                )
                if cursor not in sl.entries:
                    self._pending += 1
                sl.entries[cursor] = d
                sl.keys.add(d.key)
                sl.next_cursor = max(sl.next_cursor, cursor + 1)
                self._payloads.setdefault(pdigest, d.payload)
                self._payload_refs[pdigest] = self._payload_refs.get(pdigest, 0) + 1
            elif op == "ack":
                sl = self._sub(str(rec["sub"]))
                self._ack_entry(sl, int(rec["cursor"]))
            elif op == "sstate":
                sl = self._sub(str(rec["sub"]))
                sl.next_cursor = max(sl.next_cursor, int(rec["next"]))
                sl.acked = max(sl.acked, int(rec["acked"]))
                sl.acked_extra.update(int(c) for c in rec.get("acked_extra", []))
                sl.keys.update(str(k) for k in rec.get("keys", []))
                if int(rec.get("base_cursor", 0)) >= sl.base_cursor and rec.get(
                    "base_digest"
                ):
                    sl.base_digest = str(rec["base_digest"])
                    sl.base_cursor = int(rec.get("base_cursor", 0))
        except (KeyError, ValueError, TypeError):
            return  # fail-soft: one bad frame, not the whole replay

    @staticmethod
    def _apply_ack(sl: _SubLog, cursor: int) -> None:
        sl.entries.pop(cursor, None)
        if cursor > sl.acked:
            sl.acked_extra.add(cursor)
        while (sl.acked + 1) in sl.acked_extra:
            sl.acked += 1
            sl.acked_extra.discard(sl.acked)

    @locked
    def _ack_entry(self, sl: _SubLog, cursor: int) -> None:
        """Ack + payload-refcount bookkeeping: the last unacked reference
        to a payload digest releases it from the content store. An ack
        also advances the sub's delta base: the acked delivery's FULL
        digest is a bundle the subscriber now provably holds."""
        d = sl.entries.get(cursor)
        self._apply_ack(sl, cursor)
        if d is None:
            return
        self._pending -= 1
        t0 = self._append_ts.pop(d.key, None)
        if t0 is not None:
            self._metrics.observe(
                "subs.delivery_lag_ms", (time.monotonic() - t0) * 1000.0
            )
        if cursor >= sl.base_cursor:
            sl.base_digest = d.digest
            sl.base_cursor = cursor
        n = self._payload_refs.get(d.payload_digest, 0) - 1
        if n <= 0:
            self._payload_refs.pop(d.payload_digest, None)
            self._payloads.pop(d.payload_digest, None)
        else:
            self._payload_refs[d.payload_digest] = n

    # ---------------------------------------------------------------- mutation

    @locked
    def _append_rec(self, rec: dict) -> None:
        """Journal one frame; the delivery / ack frame must land before
        the cursor becomes observable, hence under the lock."""
        if not self._writer.append(rec):  # ipclint: disable=lock-held-blocking (durability: frame lands before the cursor is observable)
            self._metrics.count("subs.log_failures")

    @locked
    def _publish_gauges_locked(self) -> None:
        self._metrics.set_gauge("subs.pending_deliveries", self._pending)
        self._metrics.set_gauge("subs.log_bytes", self._writer.journal_bytes)

    def append(
        self,
        sub_id: str,
        tipset: int,
        digest: str,
        payload: dict,
        payload_digest: Optional[str] = None,
    ) -> Optional[Delivery]:
        """Append one delivery; returns ``None`` if its idempotency key was
        already seen (matcher replay absorbed, nothing to deliver twice).

        ``payload_digest`` names the shipped bytes when they differ from
        the full bundle (a delta payload); idempotency stays keyed on the
        FULL digest, so a delta re-delivery of an already-served proof
        still dedups."""
        key = delivery_idempotency_key(sub_id, tipset, digest)
        pdigest = payload_digest or digest
        with self._cond:
            sl = self._sub(sub_id)
            if key in sl.keys:
                self._metrics.count("subs.delivery_dedup")
                return None
            cursor = sl.next_cursor
            sl.next_cursor = cursor + 1
            d = Delivery(
                sub_id=sub_id,
                cursor=cursor,
                key=key,
                tipset=int(tipset),
                digest=digest,
                payload=payload,
                payload_digest=pdigest,
            )
            sl.entries[cursor] = d
            sl.keys.add(key)
            self._pending += 1
            self._append_ts[key] = time.monotonic()
            if pdigest not in self._payloads:
                # first subscriber of this payload journals it; the other
                # 9,999 journal a reference
                self._payloads[pdigest] = payload
                self._append_rec({"op": "pay", "digest": pdigest, "payload": payload})
            self._payload_refs[pdigest] = self._payload_refs.get(pdigest, 0) + 1
            rec = {
                "op": "dlv",
                "sub": sub_id,
                "cursor": cursor,
                "key": key,
                "tipset": int(tipset),
                "digest": digest,
            }
            if pdigest != digest:
                rec["pdigest"] = pdigest
            self._append_rec(rec)
            self._metrics.count("subs.deliveries")
            self._maybe_compact_locked()
            self._publish_gauges_locked()
            self._cond.notify_all()
        return d

    def set_base_reporter(self, reporter) -> None:
        """Install the fleet base-directory feed: ``reporter(sub_id,
        base_digest, base_cursor)`` fires outside the log lock whenever an
        ack advances a sub's delta base."""
        self._base_reporter = reporter

    def _report_base(self, sub_id: str, before, sl: _SubLog) -> None:
        """Fire the reporter if the (digest, cursor) base moved past
        ``before``. Called WITHOUT _cond held; fail-soft."""
        if self._base_reporter is None:
            return
        after = (sl.base_digest, sl.base_cursor)
        if after == before or after[0] is None:
            return
        try:
            self._base_reporter(sub_id, after[0], after[1])
        except Exception as exc:  # fail-soft: the reporter is observability; the ack itself already committed
            logger.warning("delta-base reporter failed for %s: %s", sub_id, exc)

    def ack(self, sub_id: str, cursor: int) -> bool:
        """Ack one delivery; ``False`` if unknown or already acked — the
        duplicate-ack guard the push retry loop relies on."""
        with self._cond:
            sl = self._subs.get(sub_id)
            if sl is None or cursor not in sl.entries:
                self._metrics.count("subs.duplicate_acks")
                return False
            base_before = (sl.base_digest, sl.base_cursor)
            self._ack_entry(sl, cursor)
            self._append_rec({"op": "ack", "sub": sub_id, "cursor": cursor})
            self._metrics.count("subs.acks")
            self._maybe_compact_locked()
            self._publish_gauges_locked()
        self._report_base(sub_id, base_before, sl)
        return True

    def ack_through(self, sub_id: str, cursor: int) -> int:
        """Ack every unacked delivery with cursor <= ``cursor`` (the
        long-poll contract: a client asking from cursor N owns all <= N)."""
        acked = 0
        with self._cond:
            sl = self._subs.get(sub_id)
            if sl is None:
                return 0
            base_before = (sl.base_digest, sl.base_cursor)
            for c in sorted(sl.entries):
                if c > cursor:
                    break
                self._ack_entry(sl, c)
                self._append_rec({"op": "ack", "sub": sub_id, "cursor": c})
                self._metrics.count("subs.acks")
                acked += 1
            if acked:
                self._maybe_compact_locked()
                self._publish_gauges_locked()
        if acked:
            self._report_base(sub_id, base_before, sl)
        return acked

    def bases(self) -> "Dict[str, Tuple[str, int]]":
        """Every sub's current acked base ``{sub_id: (digest, cursor)}`` —
        the restart sweep that re-seeds the fleet base directory from
        replayed sstate/ack frames (the registry dedups replays)."""
        with self._cond:
            return {
                sub_id: (sl.base_digest, sl.base_cursor)
                for sub_id, sl in self._subs.items()
                if sl.base_digest is not None
            }

    # ------------------------------------------------------------------- reads

    def pending(self, sub_id: str) -> List[Delivery]:
        """Unacked deliveries for one subscription, in cursor order."""
        with self._cond:
            sl = self._subs.get(sub_id)
            if sl is None:
                return []
            return [sl.entries[c] for c in sorted(sl.entries)]

    def pending_total(self) -> int:
        with self._cond:
            return self._pending

    def entries_after(
        self, sub_id: str, cursor: int, wait_s: float = 0.0
    ) -> List[Delivery]:
        """Unacked deliveries with cursor > ``cursor``; blocks up to
        ``wait_s`` for one to arrive (the long-poll primitive)."""
        deadline = time.monotonic() + max(0.0, wait_s)
        with self._cond:
            while True:
                sl = self._subs.get(sub_id)
                if sl is not None:
                    out = [sl.entries[c] for c in sorted(sl.entries) if c > cursor]
                    if out:
                        return out
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return []
                self._cond.wait(timeout=remaining)

    def cursor(self, sub_id: str) -> int:
        """Highest assigned cursor for a subscription (0 if none)."""
        with self._cond:
            sl = self._subs.get(sub_id)
            return (sl.next_cursor - 1) if sl is not None else 0

    def acked_base(self, sub_id: str) -> Optional[str]:
        """FULL-bundle digest of this sub's highest acked delivery — the
        only bundle a delta may be cut against (the subscriber provably
        expanded it). None until the first ack (or for unknown subs);
        survives compaction via the sstate cursor record."""
        with self._cond:
            sl = self._subs.get(sub_id)
            return sl.base_digest if sl is not None else None

    @property
    def degraded(self) -> bool:
        return self._writer.degraded

    @property
    def journal_bytes(self) -> int:
        return self._writer.journal_bytes

    # -------------------------------------------------------------- compaction

    @locked
    def _maybe_compact_locked(self) -> None:
        # Degraded writers skip compaction: the rewrite would hit the same
        # failing filesystem, and in-memory state is already authoritative.
        if self._writer.degraded or self._writer.journal_bytes <= self.cap_bytes:
            return
        self._compact_locked()

    @locked
    def _compact_locked(self) -> None:
        """Rewrite the journal as per-sub state + unacked deliveries.

        Drops only acked history (entries below/at the ack watermark and
        their ack frames); every unacked delivery and every idempotency
        key survives byte-for-byte state-wise, so the cap can never lose
        an undelivered proof or re-open a dedup window.
        """
        tmp = self.path + ".compact"
        try:
            with open(tmp, "wb") as fh:
                # payloads first (once per digest still referenced by an
                # unacked delivery) so replaying dlv frames can resolve them
                live: Dict[str, dict] = {}
                for sl in self._subs.values():
                    for d in sl.entries.values():
                        live.setdefault(d.payload_digest, d.payload)
                for dg in sorted(live):
                    fh.write(
                        frame_record(
                            {"op": "pay", "digest": dg, "payload": live[dg]}
                        )
                    )
                for sub_id in sorted(self._subs):
                    sl = self._subs[sub_id]
                    # the sstate frame is the cursor record: it carries the
                    # sub's delta base digest precisely BECAUSE this rewrite
                    # drops the acked delivery (and possibly its pay frame)
                    # that established it — after replay the base identity
                    # survives even though its bytes are gone, so the delta
                    # path falls back to a full bundle instead of
                    # referencing a vanished base
                    srec = {
                        "op": "sstate",
                        "sub": sub_id,
                        "next": sl.next_cursor,
                        "acked": sl.acked,
                        "acked_extra": sorted(sl.acked_extra),
                        "keys": sorted(sl.keys),
                    }
                    if sl.base_digest is not None:
                        srec["base_digest"] = sl.base_digest
                        srec["base_cursor"] = sl.base_cursor
                    fh.write(frame_record(srec))
                    for c in sorted(sl.entries):
                        d = sl.entries[c]
                        drec = {
                            "op": "dlv",
                            "sub": sub_id,
                            "cursor": d.cursor,
                            "key": d.key,
                            "tipset": d.tipset,
                            "digest": d.digest,
                        }
                        if d.payload_digest != d.digest:
                            drec["pdigest"] = d.payload_digest
                        fh.write(frame_record(drec))
                if self._fsync:
                    fh.flush()
                    os.fsync(fh.fileno())  # ipclint: disable=lock-held-blocking (durability: compaction must not race concurrent appends)
            self._writer.close()
            os.replace(tmp, self.path)  # atomic: a crash keeps old or new, never half
            self._writer = JournalWriter(
                self.path, metrics=self._metrics, fsync=self._fsync
            )
            self._metrics.count("subs.log_compactions")
        except OSError as exc:
            # fail-soft: compaction is an optimization; the oversized (or
            # unwritable) journal keeps appending and memory stays correct
            self._metrics.count("subs.log_failures")
            logger.warning("delivery journal compaction failed: %s", exc)
            try:
                os.unlink(tmp)
            except OSError:
                pass

    def close(self) -> None:
        self._writer.close()


def _default_opener(url: str, body: bytes, timeout_s: float) -> int:
    req = urllib.request.Request(
        url, data=body, headers={"Content-Type": "application/json"}, method="POST"
    )
    with urllib.request.urlopen(req, timeout=timeout_s) as resp:
        return resp.status


class PushDelivery:
    """Bounded webhook push workers over a `DeliveryLog`.

    Each push POSTs the delivery envelope and acks the log on 2xx.
    Retries are bounded full-jitter exponential backoff — the same shape
    (and the same injectable ``opener``/``sleep``/``rng`` seams) as
    `obs.export.post_otlp_trace` — so tests and the bench drive it with
    zero sockets and zero real sleeps. Exhausted pushes stay unacked;
    `repush_pending` (called by the matcher each tipset cycle) converges
    them, and the log's single-ack contract makes the retries safe.
    """

    def __init__(
        self,
        log: DeliveryLog,
        metrics: Optional[Metrics] = None,
        max_inflight: int = 4,
        max_attempts: int = 4,
        base_delay_s: float = 0.25,
        max_delay_s: float = 4.0,
        timeout_s: float = 10.0,
        opener=None,
        sleep=time.sleep,
        rng: Optional[random.Random] = None,
    ):
        self._log = log
        self._metrics = metrics if metrics is not None else get_metrics()
        self.max_attempts = max(1, int(max_attempts))
        self.base_delay_s = base_delay_s
        self.max_delay_s = max_delay_s
        self.timeout_s = timeout_s
        self._opener = opener if opener is not None else _default_opener
        self._sleep = sleep
        self._rng = rng if rng is not None else random.Random()
        self._executor = ThreadPoolExecutor(
            max_workers=max(1, int(max_inflight)), thread_name_prefix="subs-push"
        )
        self._lock = named_lock("PushDelivery._lock")
        self._closed = False  # guarded-by: _lock
        self._inflight = 0  # guarded-by: _lock
        self._active: Set[str] = set()  # guarded-by: _lock (in-flight delivery keys)
        # payload digest → serialized payload JSON: fanning one proof out
        # to 10k subscribers serializes the bundle (or delta) once, not
        # 10k times. A tipset cycle touches at most a few digests per
        # distinct filter, so a tiny bound suffices.
        self._bundle_json: Dict[str, str] = {}  # guarded-by: _lock
        self._bundle_json_cap = 32

    def push(self, sub, delivery: Delivery):
        """Enqueue one webhook push; no-op for poll-mode targets, closed
        pushers, and deliveries already in flight (duplicate-push guard —
        at-least-once still holds because the delivery stays logged)."""
        if sub.target.get("mode") != "webhook":
            return None
        with self._lock:
            if self._closed or delivery.key in self._active:
                return None
            self._active.add(delivery.key)
            self._inflight += 1
            self._metrics.set_gauge("subs.push_inflight", self._inflight)
        return self._executor.submit(self._push_one, sub.target["url"], delivery)

    def repush_pending(self, registry) -> int:
        """Re-enqueue every unacked webhook delivery (retry convergence
        across tipset cycles and across restarts)."""
        n = 0
        for sub in registry.active():
            if sub.target.get("mode") != "webhook":
                continue
            for d in self._log.pending(sub.sub_id):
                if self.push(sub, d) is not None:
                    n += 1
        return n

    def _serialized_payload(self, delivery: Delivery) -> "tuple[str, str]":
        """(envelope key, serialized JSON) for this delivery's payload —
        ``bundle`` for full bundles, ``bundle_delta`` for delta payloads.
        Cached by PAYLOAD digest: a delta and the full bundle it expands
        to share a full digest but never a cache slot."""
        kind = "bundle_delta" if "bundle_delta" in delivery.payload else "bundle"
        with self._lock:
            cached = self._bundle_json.get(delivery.payload_digest)
        if cached is not None:
            return kind, cached
        raw = json.dumps(delivery.payload.get(kind), sort_keys=True)
        with self._lock:
            if len(self._bundle_json) >= self._bundle_json_cap:
                self._bundle_json.clear()
            self._bundle_json[delivery.payload_digest] = raw
        return kind, raw

    def _push_one(self, url: str, delivery: Delivery) -> bool:
        envelope = json.dumps(
            {
                "sub_id": delivery.sub_id,
                "cursor": delivery.cursor,
                "idempotency_key": delivery.key,
                "tipset": delivery.tipset,
                "digest": delivery.digest,
            },
            sort_keys=True,
        )
        kind, raw = self._serialized_payload(delivery)
        body = (envelope[:-1] + f', "{kind}": ' + raw + "}").encode("utf-8")
        try:
            for attempt in range(self.max_attempts):
                if attempt:
                    cap = min(
                        self.max_delay_s, self.base_delay_s * (2 ** (attempt - 1))
                    )
                    self._sleep(self._rng.uniform(0.0, cap))  # full jitter
                    self._metrics.count("subs.push_retries")
                try:
                    status = int(self._opener(url, body, self.timeout_s))
                except HTTPError as exc:
                    status = exc.code
                except Exception:  # fail-soft: transport errors are retryable; the delivery stays logged
                    continue
                if 200 <= status < 300:
                    # ack() returning False means someone acked first
                    # (long-poll raced us) — never a second ack frame
                    self._log.ack(delivery.sub_id, delivery.cursor)
                    self._metrics.count("subs.pushes")
                    return True
                if status not in _RETRYABLE_STATUSES:
                    break
            self._metrics.count("subs.push_failures")
            logger.warning(
                "webhook push for sub %s cursor %d failed after %d attempts "
                "— left unacked for long-poll/re-push",
                delivery.sub_id,
                delivery.cursor,
                self.max_attempts,
            )
            return False
        finally:
            with self._lock:
                self._active.discard(delivery.key)
                self._inflight -= 1
                self._metrics.set_gauge("subs.push_inflight", self._inflight)

    def drain(self) -> None:
        """Stop accepting pushes and wait for in-flight webhooks to land."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._executor.shutdown(wait=True)
