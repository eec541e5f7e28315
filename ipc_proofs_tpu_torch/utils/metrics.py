"""Stage timers, counters, gauges and latency histograms.

The counterpart of ``ipc_proofs_tpu.utils.metrics``: the same ``stage()`` /
``count()`` / ``set_gauge()`` / ``observe()`` calls and names
(``range_scan``, ``range_match``, ``range_record``, ``range_merge``,
``range_verify``; the ``rpc.*``, ``pool.*``, ``fetch.*``, ``storex.*``,
``follow.*``, ``trace.*`` and ``verify.*`` names, each one the reference
declares in its vocabularies, as ``tests/test_torch_rpc.py`` checks), so a
caller reads both packages alike and `obs.prom.render_prometheus` renders
the same text for both. Times are host wall-clock seconds.

Each stage keeps its busy seconds (``total_s``: the sum over every entry,
so 8 workers × 1 s is 8 s) and its wall seconds (``wall_s``: the union of
its entry intervals, ~1 s for the same 8 overlapping workers). A union wall
runs across all stages, and ``overlap_efficiency`` is busy over that union
wall: 1.0 for serial code, towards N for N stages that overlap. Every
outermost stage entry is also a trace span (`obs.trace.span`), parented by
the context ambient on the calling thread; a span times host work only and
never synchronises the card.

Histograms are bounded rings (the latest ``maxlen`` observations), so a
long-lived process snapshots in O(maxlen).
"""

from __future__ import annotations

import json
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass

from ipc_proofs_tpu_torch.utils.lockdep import named_lock

__all__ = [
    "BACKFILL_COUNTERS",
    "BACKFILL_GAUGES",
    "DEGRADED_COUNTERS",
    "FOLLOW_COUNTERS",
    "FOLLOW_GAUGES",
    "Histogram",
    "Metrics",
    "OBSERVABILITY_COUNTERS",
    "RESILIENCE_COUNTERS",
    "SLO_COUNTERS",
    "SUBS_COUNTERS",
    "SUBS_GAUGES",
    "SUBS_HISTOGRAMS",
    "StageTimer",
    "get_metrics",
]

# Counter vocabulary of the fault-tolerance layer (store/failover.py,
# store/rpc.py, proofs/range.py), the reference's names:
#   rpc.calls               — JSON-RPC requests issued (all methods, before
#                             retries); a disk-warm request shows a delta of 0
#   rpc.retries             — transport/rate-limit retries inside LotusClient
#   rpc.failures            — requests that exhausted their retry budget
#   rpc.integrity_failures  — fetched block bytes failed CID verification
#   rpc.prefetch_failures   — per-CID failures absorbed by fail-soft prefetch
#   rpc.hedges              — hedged secondary fetches fired
#   rpc.hedge_wins          — races the hedge answered first
#   rpc.probe_suppressed    — half-open probes deferred while every breaker
#                             is open and another endpoint holds the
#                             pool-wide probe slot
#   rpc.retry_budget_exhausted — retries skipped because the pool-wide
#                             retry budget was dry
#   failover.breaker_open   — circuit-breaker open transitions
#   range_scan_retries      — chunk re-scans after transient store errors
#   range_pipeline_serial_fallback — pipelined driver ran inline
RESILIENCE_COUNTERS = (
    "rpc.calls",
    "rpc.retries",
    "rpc.failures",
    "rpc.integrity_failures",
    "rpc.prefetch_failures",
    "rpc.hedges",
    "rpc.hedge_wins",
    "rpc.probe_suppressed",
    "rpc.retry_budget_exhausted",
    "failover.breaker_open",
    "range_scan_retries",
    "range_pipeline_serial_fallback",
)

# Counter vocabulary of the trace spine and its exporters (obs/):
#   trace.spans_recorded    — spans kept by the opt-in collector
#   trace.spans_dropped     — spans dropped at the collector's capacity
#   trace.spans_sampled_out — spans of traces that lost the head-sampling draw
#   serve.slow_requests     — requests over the service's slow-request
#                             threshold, logged with their span tree
#   trace.otlp_posts        — OTLP/JSON batches POSTed to a collector
#   trace.otlp_post_failures — collector POSTs that exhausted their retries
OBSERVABILITY_COUNTERS = (
    "trace.spans_recorded",
    "trace.spans_dropped",
    "trace.spans_sampled_out",
    "serve.slow_requests",
    "trace.otlp_posts",
    "trace.otlp_post_failures",
)

# The chain follower's part of the reference's STOREX_COUNTERS
# (storex/follower.py):
#   follow.tipsets           — heights whose spine was warmed
#   follow.blocks_prefetched — blocks verified and put into the local tiers
#   follow.errors            — store errors, rejected blocks and raising
#                              hooks, each absorbed and retried next poll
#   follow.leader_elections  — leader-lock elections won
#   follow.polls             — head polls
FOLLOW_COUNTERS = (
    "follow.tipsets",
    "follow.blocks_prefetched",
    "follow.errors",
    "follow.leader_elections",
    "follow.polls",
)
FOLLOW_GAUGES = ("follow.last_finalized_epoch",)  # the last height warmed

# The endpoint pool's all-breakers-open posture (store/failover.py):
#   degraded.entered / degraded.exited — transitions into and out of it
#   degraded.warm_served    — requests the service answered from the warm
#                             tiers alone while degraded
#   degraded.fail_fast      — cold reads refused typed instead of retried
DEGRADED_COUNTERS = (
    "degraded.entered",
    "degraded.exited",
    "degraded.warm_served",
    "degraded.fail_fast",
)

# Counter vocabulary of the standing-query subsystem (subs/):
#   subs.registered        — subscriptions accepted into the registry
#   subs.unsubscribed      — subscriptions removed
#   subs.replays_absorbed  — duplicate subscribe(sub_id) calls absorbed
#                            idempotently (journal replays, cluster
#                            failover re-registration)
#   subs.tipsets_matched   — finalized tipset pairs the matcher compiled
#                            the active filter set against
#   subs.generations       — proof generations run, one per distinct
#                            (pair, filter) — the fan-out amortization
#                            counter (≤ distinct filters per tipset,
#                            NEVER per subscriber)
#   subs.notifications     — deliveries fanned out to subscribers
#   subs.empty_matches     — (pair, filter) generations with zero proofs
#                            (nothing to deliver — not an error)
#   subs.errors            — per-filter generation failures absorbed
#                            fail-soft (other filters still deliver)
#   subs.deliveries        — delivery-log appends (monotonic cursors)
#   subs.delivery_dedup    — appends absorbed by an already-seen
#                            idempotency key (matcher replays)
#   subs.acks              — deliveries acked (push 2xx or long-poll
#                            cursor advance)
#   subs.duplicate_acks    — ack attempts for unknown/already-acked
#                            cursors, refused (the no-duplicate-ack guard)
#   subs.pushes            — webhook pushes that landed (2xx)
#   subs.push_retries      — webhook attempts after the first (full-jitter
#                            backoff)
#   subs.push_failures     — pushes that exhausted retries (delivery stays
#                            unacked for long-poll / next-cycle re-push)
#   subs.log_failures      — registry/delivery journal writes or
#                            compactions that failed (ENOSPC/EROFS
#                            fail-soft: the run completes in-memory)
#   subs.log_compactions   — delivery-journal rewrites under the byte cap
#                            (drops only acked history)
SUBS_COUNTERS = (
    "subs.registered",
    "subs.unsubscribed",
    "subs.replays_absorbed",
    "subs.tipsets_matched",
    "subs.generations",
    "subs.notifications",
    "subs.empty_matches",
    "subs.errors",
    "subs.deliveries",
    "subs.delivery_dedup",
    "subs.acks",
    "subs.duplicate_acks",
    "subs.pushes",
    "subs.push_retries",
    "subs.push_failures",
    "subs.log_failures",
    "subs.log_compactions",
)

SUBS_GAUGES = (
    "subs.active",  # registered subscriptions
    "subs.pending_deliveries",  # unacked deliveries across all subscriptions
    "subs.push_inflight",  # webhook pushes currently in flight
    "subs.log_bytes",  # bytes in the delivery journal (cap trigger)
)

SUBS_HISTOGRAMS = (
    "subs.delivery_lag_ms",  # append→ack latency of webhook/long-poll acks
)

# Counter vocabulary of the bulk backfill engine (backfill/):
#   backfill.jobs            — jobs submitted (fresh threads launched; an
#                              idempotent resubmit of a RUNNING job does
#                              not count)
#   backfill.jobs_resumed    — submits that replayed ≥1 committed window
#                              from the job's IPJ1 journal
#   backfill.windows         — windows proved fresh and committed
#   backfill.windows_replayed— windows satisfied from the journal on resume
#   backfill.epochs          — epochs covered by emitted windows (fresh +
#                              replayed; the epochs/s numerator)
#   backfill.chunks_streamed — chunks entered into jobs' cursor logs
#   backfill.catchup_deliveries — windows landed on a standing-query
#                              delivery log (sub_id catch-up; dedup
#                              absorbs resume replays without a count)
#   backfill.window_failures — jobs failed by a window-runner error or
#                              engine shutdown (journal keeps committed
#                              windows for resume)
#   backfill.device_faults   — jobs stopped by a fault of the card (state
#                              "faulted", never counted as a failure;
#                              the port's own, the reference has none)
BACKFILL_COUNTERS = (
    "backfill.jobs",
    "backfill.jobs_resumed",
    "backfill.windows",
    "backfill.windows_replayed",
    "backfill.epochs",
    "backfill.chunks_streamed",
    "backfill.catchup_deliveries",
    "backfill.window_failures",
    "backfill.device_faults",
)

BACKFILL_GAUGES = (
    "backfill.active_jobs",  # jobs currently in the running state
)

# SLO burn-rate watchdog (obs/slo.py): multi-window availability/latency/
# integrity targets evaluated from periodic metric snapshots.
#   slo.evaluations      — watchdog sample passes (manual or timed)
#   slo.warn_transitions — target entered `warn` (fast or slow window hot)
#   slo.burn_transitions — target entered `burning` (both windows over page
#                          rate, or an integrity zero-tolerance tick)
#   slo.recoveries       — target stepped back to `ok` after the hysteresis
#                          window of consecutive clean evaluations
#   slo.anomalies        — anomaly signatures observed (breaker flap storm,
#                          eviction storm, speculation-waste spike)
SLO_COUNTERS = (
    "slo.evaluations",
    "slo.warn_transitions",
    "slo.burn_transitions",
    "slo.recoveries",
    "slo.anomalies",
)

# `obs.trace.span`, bound at first use: obs imports this module (its
# collector counts into a `Metrics`), so the import is deferred
_span_factory = None


def _stage_span(name: str):
    """The trace span that an outermost `Metrics.stage` entry opens."""
    global _span_factory
    factory = _span_factory
    if factory is None:
        from ipc_proofs_tpu_torch.obs.trace import span as factory

        _span_factory = factory
    return factory(name)


@dataclass
class StageTimer:
    """One named stage's busy time and the union of its entry intervals."""

    total_s: float = 0.0
    calls: int = 0
    wall_s: float = 0.0
    _active: int = 0  # concurrent (outermost) entries right now
    _wall_start: float = 0.0  # perf_counter when _active went 0 -> 1


class Histogram:
    """Bounded reservoir of observations with percentile snapshots.

    Keeps the most recent ``maxlen`` observations in a ring, so percentiles
    describe recent behaviour. Not thread-safe on its own; `Metrics` and
    `store.failover.EndpointPool` serialise access."""

    __slots__ = ("_ring", "_maxlen", "_next", "count", "total")

    def __init__(self, maxlen: int = 8192):
        self._ring: "list[float]" = []
        self._maxlen = maxlen
        self._next = 0  # ring insertion cursor once full
        self.count = 0  # lifetime observations
        self.total = 0.0  # lifetime sum

    def observe(self, value: float) -> None:
        self.count += 1
        self.total += value
        if len(self._ring) < self._maxlen:
            self._ring.append(value)
        else:
            self._ring[self._next] = value
            self._next = (self._next + 1) % self._maxlen

    def percentiles(self, qs=(0.5, 0.9, 0.99)) -> "dict[str, float]":
        """Nearest-rank percentiles over the retained window ({} if empty)."""
        if not self._ring:
            return {}
        ordered = sorted(self._ring)
        n = len(ordered)
        out = {}
        for q in qs:
            rank = min(n - 1, max(0, int(q * n + 0.5) - 1))
            out[f"p{int(q * 100)}"] = ordered[rank]
        return out

    def snapshot(self) -> dict:
        out = {"count": self.count, "mean": (self.total / self.count) if self.count else 0.0}
        out.update(self.percentiles())
        return out


class Metrics:
    """Thread-safe stage timers, counters, gauges and histograms.

    ``stage()`` is re-entrant per thread: nesting the SAME stage name on one
    thread counts only the outermost entry. Pipeline workers timing one
    stage from N threads add their busy time while ``wall_s`` tracks the
    interval union.
    """

    def __init__(self):
        # every subsystem counts while holding its own lock, so this lock
        # is a terminal leaf of the acquisition order
        self._lock = named_lock("Metrics._lock")
        self._tls = threading.local()
        self.timers: "dict[str, StageTimer]" = {}  # guarded-by: _lock
        self.counters: "dict[str, int]" = {}  # guarded-by: _lock
        self.gauges: "dict[str, float]" = {}  # guarded-by: _lock
        self.histograms: "dict[str, Histogram]" = {}  # guarded-by: _lock
        self.created_at = time.time()
        self._union_active = 0  # guarded-by: _lock
        self._union_start = 0.0  # guarded-by: _lock
        self.union_wall_s = 0.0  # guarded-by: _lock

    def reset(self) -> None:
        """Drop every timer, counter and gauge (a driver that runs several
        commands in one process reads each command's own counts)."""
        with self._lock:
            self.timers.clear()
            self.counters.clear()
            self.gauges.clear()
            self.histograms.clear()
            self._union_active = 0
            self._union_start = 0.0
            self.union_wall_s = 0.0

    @property
    def stage_s(self) -> "dict[str, float]":
        """Busy seconds per stage (a copy)."""
        with self._lock:
            return {name: timer.total_s for name, timer in self.timers.items()}

    @contextmanager
    def stage(self, name: str):
        depths = getattr(self._tls, "depths", None)
        if depths is None:
            depths = self._tls.depths = {}
        if depths.get(name, 0):
            # same-thread re-entry: the outermost entry covers this interval
            depths[name] += 1
            try:
                yield
            finally:
                depths[name] -= 1
            return
        depths[name] = 1
        try:
            with _stage_span(name):
                start = time.perf_counter()
                with self._lock:
                    timer = self.timers.setdefault(name, StageTimer())
                    if timer._active == 0:
                        timer._wall_start = start
                    timer._active += 1
                    if self._union_active == 0:
                        self._union_start = start
                    self._union_active += 1
                try:
                    yield
                finally:
                    end = time.perf_counter()
                    with self._lock:
                        timer.total_s += end - start
                        timer.calls += 1
                        timer._active -= 1
                        if timer._active == 0:
                            timer.wall_s += end - timer._wall_start
                        self._union_active -= 1
                        if self._union_active == 0:
                            self.union_wall_s += end - self._union_start
        finally:
            depths[name] -= 1
            if not depths[name]:
                del depths[name]

    def overlap_efficiency(self) -> "float | None":
        """Busy over union wall across all stages; None before any stage
        completed."""
        with self._lock:
            busy = sum(t.total_s for t in self.timers.values())
            wall = self.union_wall_s
        return (busy / wall) if wall > 0 else None

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def counter_value(self, name: str) -> int:
        with self._lock:
            return self.counters.get(name, 0)

    def set_gauge(self, name: str, value: float) -> None:
        """Instantaneous state; last write wins."""
        with self._lock:
            self.gauges[name] = value

    def observe(self, name: str, value: float) -> None:
        """Record one histogram observation (latency ms, batch size, …)."""
        with self._lock:
            hist = self.histograms.get(name)
            if hist is None:
                hist = self.histograms[name] = Histogram()
            hist.observe(value)

    def snapshot(self) -> dict:
        with self._lock:
            out = {
                "timers": {
                    k: {"total_s": round(v.total_s, 6), "calls": v.calls, "wall_s": round(v.wall_s, 6)}
                    for k, v in self.timers.items()
                },
                "counters": dict(self.counters),
                "uptime_s": round(time.time() - self.created_at, 3),
            }
            busy = sum(t.total_s for t in self.timers.values())
            if self.union_wall_s > 0:
                out["overlap_efficiency"] = round(busy / self.union_wall_s, 4)
            if self.gauges:
                out["gauges"] = dict(self.gauges)
            if self.histograms:
                out["histograms"] = {
                    k: {
                        key: (round(val, 6) if isinstance(val, float) else val)
                        for key, val in h.snapshot().items()
                    }
                    for k, h in self.histograms.items()
                }
            return out

    def to_json(self) -> str:
        return json.dumps(self.snapshot(), indent=2)


_global = Metrics()


def get_metrics() -> Metrics:
    """The process-global `Metrics` that the RPC client, the fetch plane and
    the blockstores count into when no instance is passed."""
    return _global
