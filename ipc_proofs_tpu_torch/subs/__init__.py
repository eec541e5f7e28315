"""Standing queries: register once, stream proofs as tipsets finalize.

The subsystem that turns the serve daemon from request/response into a
proof *streaming* service. Lifecycle:

    register → follow → match → generate-once → fan-out → ack

- `registry.SubscriptionRegistry` — IPJ1-journaled (filter, target)
  table; registrations survive restart, duplicate ids absorb idempotently.
- `matcher.StandingQueryMatcher` — the `ChainFollower` finalized-tipset
  hook; one generation per distinct (pair, filter) shared by every
  subscriber, byte-identical to the request/response path.
- `delivery.DeliveryLog` / `delivery.PushDelivery` — at-least-once
  fan-out: per-sub monotonic cursors, idempotency keys, webhook push
  with bounded full-jitter retry, long-poll fallback, byte-capped
  truncation only below the acked cursor.

`StandingQueries` is the facade the CLI/HTTP layers wire: one object
owning all four pieces, with `on_tipset` as the follower hook and
`drain()` ordered so delivery workers finish before the store tiers
close.
"""

from __future__ import annotations

import random
import time
from typing import Any, Optional

from ipc_proofs_tpu_torch.subs.delivery import (
    Delivery,
    DeliveryLog,
    PushDelivery,
    delivery_idempotency_key,
)
from ipc_proofs_tpu_torch.subs.matcher import StandingQueryMatcher
from ipc_proofs_tpu_torch.subs.registry import (
    Subscription,
    SubscriptionRegistry,
    filter_key,
    normalize_filter,
    normalize_target,
    subscription_ring_key,
)
from ipc_proofs_tpu_torch.utils.metrics import Metrics, get_metrics

__all__ = [
    "Delivery",
    "DeliveryLog",
    "PushDelivery",
    "StandingQueries",
    "StandingQueryMatcher",
    "Subscription",
    "SubscriptionRegistry",
    "delivery_idempotency_key",
    "filter_key",
    "normalize_filter",
    "normalize_target",
    "subscription_ring_key",
]


class StandingQueries:
    """Facade owning registry + delivery log + push workers + matcher."""

    def __init__(
        self,
        root: str,
        store,
        metrics: Optional[Metrics] = None,
        *,
        chunk_size: int = 8,
        match_backend=None,
        fsync: bool = True,
        log_cap_bytes: int = 64 << 20,
        push_max_inflight: int = 4,
        retry_attempts: int = 4,
        retry_base_s: float = 0.25,
        retry_max_s: float = 4.0,
        push_timeout_s: float = 10.0,
        gen_workers: int = 2,
        delta: bool = True,
        service=None,
        provenance=None,
        fleet: str = "default",
        opener=None,
        sleep=time.sleep,
        rng: Optional[random.Random] = None,
    ):
        self._metrics = metrics if metrics is not None else get_metrics()
        self.registry = SubscriptionRegistry(root, metrics=self._metrics, fsync=fsync)
        self.log = DeliveryLog(
            root, metrics=self._metrics, cap_bytes=log_cap_bytes, fsync=fsync
        )
        self.push = PushDelivery(
            self.log,
            metrics=self._metrics,
            max_inflight=push_max_inflight,
            max_attempts=retry_attempts,
            base_delay_s=retry_base_s,
            max_delay_s=retry_max_s,
            timeout_s=push_timeout_s,
            opener=opener,
            sleep=sleep,
            rng=rng,
        )
        self.matcher = StandingQueryMatcher(
            self.registry,
            self.log,
            self.push,
            store,
            metrics=self._metrics,
            chunk_size=chunk_size,
            match_backend=match_backend,
            gen_workers=gen_workers,
            delta=delta,
            service=service,
            provenance=provenance,
            fleet=fleet,
        )
        # fleet base directory: acked-base advances flow
        # into the provenance registry keyed (fleet, filter key, sub), so
        # a base survives failover AND compaction fleet-wide — any shard
        # can cut a delta against the newest base this fleet acked
        self.provenance = provenance
        self.fleet = fleet
        if provenance is not None:
            self.log.set_base_reporter(self._report_base)
            # restart sweep: re-seed the directory from replayed acked
            # state (the registry dedups (sub, cursor, digest) replays)
            for sub_id, (digest, cursor) in self.log.bases().items():
                self._report_base(sub_id, digest, cursor)
        # Restart convergence: deliveries that were unacked at the last
        # shutdown/crash re-push as soon as the daemon is back.
        if self.log.pending_total():
            self.push.repush_pending(self.registry)

    def _report_base(self, sub_id: str, digest: str, cursor: int) -> None:
        """DeliveryLog base-advance hook → registry base record. Fail-soft:
        directory trouble never blocks the ack path."""
        sub = self.registry.get(sub_id)
        if sub is None:
            return
        try:
            self.provenance.append_base_ack(
                self.fleet, filter_key(sub.filter), sub_id, digest, cursor
            )
        except Exception:  # fail-soft: losing one base ack only costs a future delta, never the push
            self._metrics.count("registry.append_failures")

    # ---------------------------------------------------------- follower hook

    def on_tipset(self, tipset) -> int:
        return self.matcher.on_tipset(tipset)

    # ------------------------------------------------------------- HTTP plane

    def subscribe(self, body: Any) -> dict:
        """``POST /v1/subscribe`` — body: {filter, target?, sub_id?}."""
        if not isinstance(body, dict):
            raise ValueError("body must be a JSON object")
        sub, created = self.registry.subscribe(
            body.get("filter"), body.get("target"), sub_id=body.get("sub_id")
        )
        return {"sub_id": sub.sub_id, "created": created}

    def unsubscribe(self, body: Any) -> dict:
        """``POST /v1/unsubscribe`` — body: {sub_id}."""
        if not isinstance(body, dict) or not body.get("sub_id"):
            raise ValueError("body.sub_id is required")
        return {"removed": self.registry.unsubscribe(str(body["sub_id"]))}

    def subscriptions(self) -> dict:
        """``GET /v1/subscriptions``."""
        subs = sorted(self.registry.active(), key=lambda s: s.sub_id)
        return {
            "count": len(subs),
            "subscriptions": [s.to_json_obj() for s in subs],
        }

    def deliveries(
        self, sub_id: str, cursor: int = 0, wait_s: float = 0.0
    ) -> Optional[dict]:
        """``GET /v1/deliveries?sub=<id>&cursor=<n>`` — the long-poll
        fallback. A client at cursor N owns everything ≤ N (acked here),
        and blocks up to ``wait_s`` for entries above it. Returns None
        for an unknown subscription."""
        if self.registry.get(sub_id) is None:
            return None
        cursor = max(0, int(cursor))
        if cursor:
            self.log.ack_through(sub_id, cursor)
        entries = self.log.entries_after(sub_id, cursor, wait_s=wait_s)
        return {
            "sub_id": sub_id,
            "cursor": max([e.cursor for e in entries], default=cursor),
            "deliveries": [e.to_json_obj() for e in entries],
        }

    # ------------------------------------------------------------ diagnostics

    def health_fields(self) -> dict:
        """Merged into ``/healthz`` beside the durable queue's fields."""
        return {
            "subscriptions": len(self.registry),
            "pending_deliveries": self.log.pending_total(),
            "delivery_log_bytes": self.log.journal_bytes,
            "subs_degraded": bool(self.registry.degraded or self.log.degraded),
        }

    def drain(self) -> None:
        """Matcher first (stop producing), then push workers (finish
        delivering — they read proof payloads, so this MUST complete
        before the serve plane closes its store tiers), then the logs."""
        self.matcher.drain()
        self.push.drain()
        self.log.close()
        self.registry.close()
