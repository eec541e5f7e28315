"""Per-tenant QoS enforcement: token buckets at admission + fair queuing.

The counterpart of ``ipc_proofs_tpu.serve.qos``: the enforcement half of
tenant QoS (the accounting half, who is using what, is the HTTP front
end's tenant ledger):

- `TenantQoS` — per-tenant token buckets checked at HTTP admission,
  BEFORE a request touches the micro-batcher. An exhausted bucket is a
  typed 429 (`TenantThrottledError` → ``error_type: tenant_throttled``
  with a ``Retry-After`` hint computed from the refill rate), counted as
  ``qos.throttled`` + ``tenant.throttled.<slot>``. Buckets are bounded:
  at most ``max_tenants`` live buckets, coldest evicted first — a
  million distinct tenant strings cannot balloon server memory, and an
  evicted bucket resurrects full (brief over-admission, never
  over-rejection of a tenant that was within its rate).

- `FairQueue` — deficit round-robin across per-tenant sub-queues, the
  `MicroBatcher`'s interactive lane ordering. Every request costs one
  unit and every tenant's quantum is one unit per turn, so DRR reduces
  to strict round-robin across tenants while staying FIFO within each
  tenant — one hot client can no longer monopolize a flush: with T
  active tenants a light tenant's request sits behind at most ~queue/T
  of the heavy tenant's backlog instead of all of it. Single-tenant
  traffic degenerates to the exact FIFO order the batcher always had.

Admission throttling and queue fairness compose: the bucket bounds a
tenant's admitted RATE, the fair queue bounds the LATENCY a burst that
did get admitted can impose on everyone else.
"""

from __future__ import annotations

import time
from collections import OrderedDict, deque
from typing import Optional

from ipc_proofs_tpu_torch.utils.lockdep import named_lock
from ipc_proofs_tpu_torch.utils.metrics import Metrics, get_metrics
from ipc_proofs_tpu_torch.utils.threads import locked

__all__ = [
    "AdmitRejectedError",
    "FairQueue",
    "GradientLimiter",
    "TenantQoS",
    "TenantThrottledError",
    "TokenBucket",
]


class TenantThrottledError(RuntimeError):
    """A tenant's token bucket is exhausted; mapped to a typed 429 with
    ``Retry-After: retry_after_s`` at the HTTP front door."""

    def __init__(self, tenant: Optional[str], retry_after_s: float):
        super().__init__(
            f"tenant {tenant or 'anonymous'!s} exceeded its admission rate"
        )
        self.tenant = tenant
        self.retry_after_s = retry_after_s


class TokenBucket:
    """One tenant's admission budget: ``rate`` tokens/s, ``burst`` cap.

    Lazy refill on take (no timer thread); not thread-safe on its own —
    `TenantQoS` serializes access under its lock."""

    __slots__ = ("rate", "burst", "tokens", "stamp")

    def __init__(self, rate: float, burst: float, now: float):
        self.rate = rate
        self.burst = burst
        self.tokens = burst
        self.stamp = now

    def take(self, now: float) -> "tuple[bool, float]":
        """(admitted, retry_after_s). Refills from elapsed wall, spends
        one token when available; otherwise says how long until one
        token exists."""
        elapsed = max(0.0, now - self.stamp)
        self.stamp = now
        self.tokens = min(self.burst, self.tokens + elapsed * self.rate)
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True, 0.0
        needed = (1.0 - self.tokens) / self.rate if self.rate > 0 else float("inf")
        return False, needed


class TenantQoS:
    """Per-tenant token-bucket admission control (``--tenant-rate`` /
    ``--tenant-burst``). One bucket per tenant label (anonymous traffic
    shares one bucket), LRU-bounded at ``max_tenants``."""

    def __init__(
        self,
        rate: float,
        burst: Optional[float] = None,
        metrics: Optional[Metrics] = None,
        ledger=None,
        max_tenants: int = 1024,
        clock=time.monotonic,
    ):
        if rate <= 0:
            raise ValueError("tenant rate must be positive (omit to disable QoS)")
        self.rate = float(rate)
        self.burst = float(burst) if burst is not None else max(1.0, 2.0 * self.rate)
        if self.burst < 1.0:
            raise ValueError("tenant burst must admit at least one request")
        self._metrics = metrics if metrics is not None else get_metrics()
        self._ledger = ledger
        self._max_tenants = max(1, int(max_tenants))
        self._clock = clock
        self._lock = named_lock("TenantQoS._lock")
        self._buckets: "OrderedDict[str, TokenBucket]" = OrderedDict()  # guarded-by: _lock

    def admit(self, tenant: Optional[str]) -> None:
        """Spend one token for ``tenant`` or raise `TenantThrottledError`."""
        key = tenant or "anonymous"
        now = self._clock()
        with self._lock:
            bucket = self._buckets.get(key)
            if bucket is None:
                bucket = TokenBucket(self.rate, self.burst, now)
                self._buckets[key] = bucket
                while len(self._buckets) > self._max_tenants:
                    self._buckets.popitem(last=False)  # coldest bucket out
            else:
                self._buckets.move_to_end(key)
            ok, retry_after = bucket.take(now)
        if ok:
            return
        self._metrics.count("qos.throttled")
        slot = self._ledger.slot_for(tenant) if self._ledger is not None else key
        self._metrics.count(f"tenant.throttled.{slot}")
        raise TenantThrottledError(tenant, retry_after)


class FairQueue:
    """Deficit round-robin across per-tenant FIFO sub-queues.

    Unit cost per request, quantum = the tenant's WEIGHT per turn
    (``--tenant-weight name=N``; unlisted tenants weigh 1): the scheduler
    visits tenants in arrival-of-first-request order, takes up to
    ``weight`` requests, and rotates — weighted round-robin across
    tenants, FIFO within a tenant. All-default weights reduce to strict
    round-robin; single-tenant traffic degenerates to the exact FIFO
    order the batcher always had. NOT thread-safe: the `MicroBatcher`
    owns it under its condition lock, exactly like the deque it
    replaces."""

    __slots__ = ("_queues", "_len", "_weights", "_credit")

    def __init__(self, weights: "Optional[dict[str, int]]" = None):
        self._queues: "OrderedDict[str, deque]" = OrderedDict()
        self._len = 0
        self._weights = dict(weights or {})
        # the head tenant's remaining quantum this turn; 0 forces a
        # refill from its weight on the next pop
        self._credit = 0

    def __len__(self) -> int:
        return self._len

    def append(self, pending) -> None:
        key = getattr(pending, "tenant", None) or ""
        q = self._queues.get(key)
        if q is None:
            q = deque()
            self._queues[key] = q
        q.append(pending)
        self._len += 1

    def popleft(self):
        """Next request under weighted-DRR order; a tenant rotates to the
        back of the round once its quantum (= weight) is spent, so its
        remaining backlog waits its turn."""
        if self._len == 0:
            raise IndexError("pop from empty FairQueue")
        while True:
            key, q = next(iter(self._queues.items()))
            if not q:
                del self._queues[key]  # drained tenant leaves the round
                self._credit = 0
                continue
            if self._credit <= 0:
                self._credit = max(1, int(self._weights.get(key, 1)))
            out = q.popleft()
            self._len -= 1
            self._credit -= 1
            if not q:
                del self._queues[key]
                self._credit = 0
            elif self._credit <= 0:
                self._queues.move_to_end(key)
            return out

    def tenants(self) -> int:
        """Live sub-queues (the ``qos.tenant_queues`` gauge)."""
        return sum(1 for q in self._queues.values() if q)


class AdmitRejectedError(RuntimeError):
    """The adaptive admission limiter shed this request; mapped to a
    typed 429 whose ``Retry-After`` is the limiter's drain estimate —
    honest backpressure, not a constant the client learns to ignore."""

    error_type = "admit_rejected"

    def __init__(self, retry_after_s: float, tenant: Optional[str] = None):
        super().__init__(
            "admission limit reached; retry in %.2fs" % retry_after_s
        )
        self.retry_after_s = retry_after_s
        self.tenant = tenant


class _AdmitSlot:
    """One held admission: returned by `GradientLimiter.acquire`, handed
    back to `release`. Carries the acquire stamp so the limiter can
    measure true service time without a side table."""

    __slots__ = ("tenant", "started", "released")

    def __init__(self, tenant: Optional[str], started: float):
        self.tenant = tenant
        self.started = started
        self.released = False


class GradientLimiter:
    """AIMD concurrency limiter driven by observed queue delay.

    Replaces the static ``queue_capacity`` as the serve plane's first
    gate (the batcher capacity stays as a hard backstop). The limit
    GROWS additively (+1) while recent queue delay sits comfortably
    under the SLO-derived budget, and SHRINKS multiplicatively
    (× ``shrink``) the moment the window's p99 queue delay crosses it —
    the classic gradient/AIMD response that keeps a fast host admitting
    near its true capacity and walks a melting host back down instead of
    letting a fixed bound choose wrong in both directions.

    Shedding is tenant-aware: tenants named in ``tenant_weights`` (the
    top-K by deficit weight, the same vocabulary the fair queue uses)
    ride a grace headroom of ``grace`` × limit before they shed, so
    under overload the anonymous/`other` pool sheds FIRST and paying
    tenants keep their latency (counted ``admit.shed_other``).

    429s carry an honest ``Retry-After``: the drain estimate
    ``excess_requests × avg_service_time / limit`` from the limiter's
    own EWMA of acquire→release service time.
    """

    WINDOW = 32  # completions per AIMD evaluation window
    GROW_FRACTION = 0.5  # grow while p99 delay < this fraction of budget

    def __init__(
        self,
        initial: int = 8,
        min_limit: int = 2,
        max_limit: int = 1024,
        delay_budget_ms: float = 250.0,
        shrink: float = 0.8,
        grace: float = 1.25,
        tenant_weights: "Optional[dict[str, int]]" = None,
        metrics: Optional[Metrics] = None,
        clock=time.monotonic,
    ):
        self.min_limit = max(1, int(min_limit))
        self.max_limit = max(self.min_limit, int(max_limit))
        self.delay_budget_ms = float(delay_budget_ms)
        self.shrink = float(shrink)
        self.grace = max(1.0, float(grace))
        self._named = frozenset(tenant_weights or ())
        self._metrics = metrics if metrics is not None else get_metrics()
        self._clock = clock
        self._lock = named_lock("GradientLimiter._lock")
        self._limit = float(min(self.max_limit, max(self.min_limit, initial)))  # guarded-by: _lock
        self._inflight = 0  # guarded-by: _lock
        self._delays: "deque[float]" = deque(maxlen=self.WINDOW)  # guarded-by: _lock
        self._avg_service_s = 0.05  # EWMA acquire→release; guarded-by: _lock
        self._completions = 0  # completions since last AIMD step; guarded-by: _lock

    @property
    def limit(self) -> int:
        with self._lock:
            return int(self._limit)

    @property
    def inflight(self) -> int:
        with self._lock:
            return self._inflight

    def acquire(self, tenant: Optional[str] = None) -> _AdmitSlot:
        """Take one concurrency slot or raise `AdmitRejectedError`.

        Named (top-K weighted) tenants shed only past ``grace`` × limit;
        everyone else sheds at the limit — the `other` pool first.
        """
        named = tenant is not None and tenant in self._named
        now = self._clock()
        with self._lock:
            ceiling = self._limit * self.grace if named else self._limit
            if self._inflight >= ceiling:
                retry_after = self._drain_estimate_locked()
                shed_other = not named
            else:
                self._inflight += 1
                slot = _AdmitSlot(tenant, now)
                inflight = self._inflight
                retry_after = None
        if retry_after is not None:
            self._metrics.count("admit.rejects")
            if shed_other:
                self._metrics.count("admit.shed_other")
            raise AdmitRejectedError(retry_after, tenant)
        self._metrics.count("admit.accepted")
        self._metrics.set_gauge("admit.inflight", inflight)
        return slot

    def release(self, slot: _AdmitSlot, queue_delay_ms: float = 0.0) -> None:
        """Return a slot, feeding the AIMD window with this request's
        observed queue delay. Idempotent per slot (error paths may race
        a finally block)."""
        if slot.released:
            return
        slot.released = True
        now = self._clock()
        grew = shrank = False
        with self._lock:
            self._inflight = max(0, self._inflight - 1)
            inflight = self._inflight
            service_s = max(0.0, now - slot.started)
            self._avg_service_s = 0.8 * self._avg_service_s + 0.2 * service_s
            self._delays.append(max(0.0, float(queue_delay_ms)))
            self._completions += 1
            if self._completions >= min(self.WINDOW, max(4, int(self._limit))):
                p99 = self._p99_locked()
                if p99 > self.delay_budget_ms:
                    new = max(self.min_limit, int(self._limit * self.shrink))
                    shrank = new < int(self._limit)
                    self._limit = float(new)
                elif p99 < self.delay_budget_ms * self.GROW_FRACTION:
                    new = min(self.max_limit, int(self._limit) + 1)
                    grew = new > int(self._limit)
                    self._limit = float(new)
                self._completions = 0
                self._delays.clear()
            limit = int(self._limit)
        if grew:
            self._metrics.count("admit.grows")
        if shrank:
            self._metrics.count("admit.shrinks")
        self._metrics.set_gauge("admit.limit", limit)
        self._metrics.set_gauge("admit.inflight", inflight)

    def retry_after_s(self) -> float:
        """Current drain estimate (what a shed request should wait)."""
        with self._lock:
            return self._drain_estimate_locked()

    @locked
    def _p99_locked(self) -> float:
        if not self._delays:
            return 0.0
        ordered = sorted(self._delays)
        return ordered[min(len(ordered) - 1, int(len(ordered) * 0.99))]

    @locked
    def _drain_estimate_locked(self) -> float:
        # How long until a slot frees: the excess queue over the limit
        # drains at limit/avg_service_time requests per second.
        excess = max(1.0, self._inflight - self._limit + 1.0)
        rate = max(1e-6, self._limit / max(1e-3, self._avg_service_s))
        return max(0.05, excess / rate)
