"""SLO burn-rate watchdog: declarative targets evaluated as multi-window
burn rates over periodic `Metrics` snapshots.

A target's **burn rate** is the fraction of the error budget consumed per
unit budget: ``bad_fraction / (1 - objective)``. Burn 1.0 means the
budget is being spent exactly as fast as allowed; the watchdog follows the
classic multi-window recipe — a **fast** window (~5 min) catching sharp
regressions and a **slow** window (~1 h) filtering blips:

- ``warn``    — either window's burn ≥ ``burn_warn`` (default 2×)
- ``burning`` — the fast window ≥ ``burn_page`` (default 10×) AND the slow
  window ≥ ``burn_warn`` — i.e. the regression is both sharp and sustained
- zero-tolerance targets (integrity events) go straight to ``burning`` on
  the FIRST bad tick inside the fast window

Escalation is immediate; de-escalation is hysteretic (``recovery_samples``
consecutive clean evaluations), so a flapping signal can't melt a pager.
Quantile targets are evaluated conservatively from reservoir snapshots:
the bad fraction is lower-bounded by the highest published quantile over
the limit (p50 over → ≥ 50 % bad, p90 → ≥ 10 %, p99 → ≈ 2 %) — enough to
rank severity without per-request streaming.

Everything is deterministic under an injected ``clock`` and manual
``sample()`` calls — the tests drive whole burn-rate grids without a
single real sleep; `start()` wraps the same loop in a daemon thread.

Anomaly signatures ride the same snapshots: breaker flap storms
(`failover.breaker_open`), eviction storms (`storex.*evictions`), and
speculation-waste spikes (`fetch.speculative_wasted` vs wants) each fire
once per onset into the flight ring and ``slo.anomalies``.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ipc_proofs_tpu_torch.obs.flight import get_flight_recorder
from ipc_proofs_tpu_torch.utils.lockdep import named_lock
from ipc_proofs_tpu_torch.utils.log import get_logger
from ipc_proofs_tpu_torch.utils.metrics import Metrics, get_metrics
from ipc_proofs_tpu_torch.utils.threads import locked

__all__ = [
    "SloTarget",
    "SloWatchdog",
    "default_targets",
]

logger = get_logger(__name__)

# severity ladder for state comparisons
_RANK = {"ok": 0, "warn": 1, "burning": 2}


@dataclass(frozen=True)
class SloTarget:
    """One declarative objective.

    kind="ratio"    — ``bad``/``total`` counter-sum lists (names ending
                      ``.*`` sum every counter with that prefix); the bad
                      fraction per window is Δbad/Δtotal.
    kind="quantile" — ``hist`` + ``limit_ms``: the named quantile of the
                      histogram must stay under ``limit_ms``; ``objective``
                      is the allowed good fraction (0.99 → 1 % budget).
    kind="zero"     — any increment of the ``bad`` counters is a breach
                      (objective is ignored; first tick → burning).
    """

    name: str
    kind: str
    objective: float = 0.999
    bad: Tuple[str, ...] = ()
    total: Tuple[str, ...] = ()
    hist: str = ""
    quantile: str = "p99"
    limit_ms: float = 0.0


def default_targets(
    availability: float = 0.999,
    generate_p99_ms: float = 2000.0,
    delivery_lag_p99_ms: float = 5000.0,
) -> Tuple[SloTarget, ...]:
    """The stock fleet objectives. Counters a process never ticks read as
    zero, so the same table works on a shard daemon and on the router."""
    return (
        SloTarget(
            name="availability",
            kind="ratio",
            objective=availability,
            bad=(
                "serve.rejected_full.*",
                "serve.rejected_closed.*",
                "rpc.failures",
                "cluster.shard_errors",
            ),
            total=(
                "serve.accepted.*",
                "serve.rejected_full.*",
                "serve.rejected_closed.*",
                "cluster.requests",
            ),
        ),
        SloTarget(
            name="generate_p99",
            kind="quantile",
            objective=0.99,
            hist="serve.latency_ms.generate",
            quantile="p99",
            limit_ms=generate_p99_ms,
        ),
        SloTarget(
            name="delivery_lag_p99",
            kind="quantile",
            objective=0.99,
            hist="subs.delivery_lag_ms",
            quantile="p99",
            limit_ms=delivery_lag_p99_ms,
        ),
        SloTarget(
            name="integrity",
            kind="zero",
            bad=("rpc.integrity_failures", "storex.integrity_evictions"),
        ),
    )


def _counter_sum(counters: Dict[str, float], names: Sequence[str]) -> float:
    """Sum the named counters; a name ending ``.*`` sums the prefix."""
    total = 0.0
    for name in names:
        if name.endswith(".*"):
            prefix = name[:-1]  # keep the trailing dot
            total += sum(v for k, v in counters.items() if k.startswith(prefix))
        else:
            total += counters.get(name, 0)
    return total


@dataclass
class _TargetState:
    """Mutable per-target evaluation state (guarded by SloWatchdog._lock)."""

    samples: deque = field(default_factory=deque)  # (t, bad, total, quantiles)
    state: str = "ok"
    fast_burn: float = 0.0
    slow_burn: float = 0.0
    downshift_streak: int = 0  # consecutive evals quieter than `state`


# anomaly signature table: name → (description, fast-window predicate)
_ANOMALY_BREAKER_FLAPS = 5
_ANOMALY_EVICTIONS = 100
_ANOMALY_WASTE_RATIO = 0.5
_ANOMALY_WASTE_MIN_WANTS = 20


class SloWatchdog:
    """Multi-window burn-rate evaluation over periodic metric snapshots.

    ``sample()`` is the whole engine — tests call it directly with an
    injected clock; ``start()`` just runs it every ``interval_s`` on a
    daemon thread. ``status()`` renders the ``slo`` healthz block.
    """

    def __init__(
        self,
        metrics: Optional[Metrics] = None,
        targets: Optional[Sequence[SloTarget]] = None,
        fast_window_s: float = 300.0,
        slow_window_s: float = 3600.0,
        interval_s: float = 5.0,
        clock: Callable[[], float] = time.monotonic,
        burn_warn: float = 2.0,
        burn_page: float = 10.0,
        recovery_samples: int = 3,
    ):
        self._metrics = metrics if metrics is not None else get_metrics()
        self.targets = tuple(targets if targets is not None else default_targets())
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self.interval_s = float(interval_s)
        self.burn_warn = float(burn_warn)
        self.burn_page = float(burn_page)
        self.recovery_samples = max(1, int(recovery_samples))
        self._clock = clock
        self._lock = named_lock("SloWatchdog._lock")
        self._states: Dict[str, _TargetState] = {
            t.name: _TargetState() for t in self.targets
        }  # guarded-by: _lock
        self._anomaly_samples: deque = deque()  # guarded-by: _lock
        self._active_anomalies: Dict[str, str] = {}  # guarded-by: _lock
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- evaluation

    def sample(self, now: Optional[float] = None) -> dict:
        """Take one snapshot, advance every target's burn-rate state, and
        return the rendered status block (same shape as `status()`)."""
        t = self._clock() if now is None else float(now)
        snap = self._metrics.snapshot()
        counters = snap.get("counters", {})
        hists = snap.get("histograms", {})
        with self._lock:
            for target in self.targets:
                self._eval_target_locked(target, t, counters, hists)
            self._eval_anomalies_locked(t, counters)
            status = self._render_locked()
        self._metrics.count("slo.evaluations")
        return status

    def _eval_target_locked(
        self, target: SloTarget, t: float, counters: dict, hists: dict
    ) -> None:
        st = self._states[target.name]
        if target.kind == "quantile":
            h = hists.get(target.hist) or {}
            point = (t, 0.0, float(h.get("count", 0)), dict(h))
        else:
            bad = _counter_sum(counters, target.bad)
            total = _counter_sum(counters, target.total) if target.total else bad
            point = (t, bad, total, None)
        st.samples.append(point)
        while st.samples and st.samples[0][0] < t - self.slow_window_s:
            st.samples.popleft()

        st.fast_burn = self._window_burn(target, st.samples, t, self.fast_window_s)
        st.slow_burn = self._window_burn(target, st.samples, t, self.slow_window_s)

        if target.kind == "zero":
            # zero tolerance: a single bad tick in the fast window pages
            desired = "burning" if st.fast_burn > 0 else "ok"
        elif (
            st.fast_burn >= self.burn_page and st.slow_burn >= self.burn_warn
        ):
            desired = "burning"
        elif st.fast_burn >= self.burn_warn or st.slow_burn >= self.burn_warn:
            desired = "warn"
        else:
            desired = "ok"
        self._transition_locked(target.name, st, desired)

    def _window_burn(
        self, target: SloTarget, samples: deque, t: float, window_s: float
    ) -> float:
        """Burn rate over the trailing window (oldest in-window sample vs
        newest). One sample — or a window with no new activity — burns 0."""
        newest = samples[-1]
        oldest = None
        for p in samples:
            if p[0] >= t - window_s:
                oldest = p
                break
        if oldest is None or oldest is newest:
            return 0.0
        budget = max(1e-9, 1.0 - target.objective)
        if target.kind == "quantile":
            d_count = newest[2] - oldest[2]
            if d_count <= 0:
                return 0.0
            quantiles = newest[3] or {}
            value = float(quantiles.get(target.quantile, 0.0))
            if value <= target.limit_ms:
                return 0.0
            # conservative lower bound on the bad fraction from which
            # published quantiles sit over the limit
            if float(quantiles.get("p50", 0.0)) > target.limit_ms:
                bad_fraction = 0.5
            elif float(quantiles.get("p90", 0.0)) > target.limit_ms:
                bad_fraction = 0.1
            else:
                bad_fraction = 0.02
            # rounded so a budget like 1-0.99 (binary ≈ 0.010000…009)
            # can't push an exactly-threshold burn a ULP under it
            return round(bad_fraction / budget, 9)
        d_bad = newest[1] - oldest[1]
        d_total = newest[2] - oldest[2]
        if target.kind == "zero":
            return 1.0 if d_bad > 0 else 0.0
        if d_total <= 0:
            return 0.0
        return round((d_bad / d_total) / budget, 9)

    def _transition_locked(self, name: str, st: _TargetState, desired: str) -> None:
        if _RANK[desired] > _RANK[st.state]:
            # escalate immediately
            st.state = desired
            st.downshift_streak = 0
            if desired == "burning":
                self._metrics.count("slo.burn_transitions")
            else:
                self._metrics.count("slo.warn_transitions")
            entry = {
                "ts": round(time.time(), 3),
                "level": "WARNING",
                "logger": "ipc_proofs_tpu_torch.obs.slo",
                "msg": (
                    f"SLO target {name} -> {desired} "
                    f"(fast burn {st.fast_burn:.2f}x, slow {st.slow_burn:.2f}x)"
                ),
            }
            get_flight_recorder().record_log(entry)
            logger.warning("%s", entry["msg"])
        elif _RANK[desired] < _RANK[st.state]:
            # de-escalate only after `recovery_samples` consecutive quiet evals
            st.downshift_streak += 1
            if st.downshift_streak >= self.recovery_samples:
                previous = st.state
                st.state = desired
                st.downshift_streak = 0
                if desired == "ok":
                    self._metrics.count("slo.recoveries")
                logger.info(
                    "SLO target %s recovered: %s -> %s", name, previous, desired
                )
        else:
            st.downshift_streak = 0

    # --------------------------------------------------------------- anomalies

    @locked
    def _eval_anomalies_locked(self, t: float, counters: dict) -> None:
        keys = (
            "failover.breaker_open",
            "storex.evictions",
            "storex.integrity_evictions",
            "storex.shared_evictions",
            "fetch.speculative_wasted",
            "fetch.speculative_wants",
            "degraded.entered",
            "registry.append_failures",
        )
        point = (t, {k: counters.get(k, 0) for k in keys})
        self._anomaly_samples.append(point)
        while self._anomaly_samples and self._anomaly_samples[0][0] < (
            t - self.fast_window_s
        ):
            self._anomaly_samples.popleft()
        oldest = self._anomaly_samples[0][1]
        newest = point[1]
        if self._anomaly_samples[0] is point:
            # single sample: no deltas — and no evidence an earlier storm
            # is still going, so a fully-drained window clears it
            self._active_anomalies = {}
            return

        def delta(k: str) -> float:
            return newest[k] - oldest[k]

        active: Dict[str, str] = {}
        flaps = delta("failover.breaker_open")
        if flaps >= _ANOMALY_BREAKER_FLAPS:
            active["breaker_flap_storm"] = (
                f"{flaps:.0f} breaker-open transitions in the fast window"
            )
        evictions = (
            delta("storex.evictions")
            + delta("storex.integrity_evictions")
            + delta("storex.shared_evictions")
        )
        if evictions >= _ANOMALY_EVICTIONS:
            active["eviction_storm"] = (
                f"{evictions:.0f} store-tier evictions in the fast window"
            )
        wants = delta("fetch.speculative_wants")
        wasted = delta("fetch.speculative_wasted")
        if wants >= _ANOMALY_WASTE_MIN_WANTS and (
            wasted / max(1.0, wants) >= _ANOMALY_WASTE_RATIO
        ):
            active["speculation_waste_spike"] = (
                f"{wasted:.0f}/{wants:.0f} speculative fetches wasted"
            )
        entered = delta("degraded.entered")
        if entered >= 1:
            # a single entry is always page-worthy: the daemon lost its
            # LAST upstream endpoint and now serves warm-tier traffic only
            active["degraded_lotus_down"] = (
                f"entered degraded serve mode {entered:.0f}x in the fast "
                "window (all upstream breakers open)"
            )
        dropped = delta("registry.append_failures")
        if dropped >= 1:
            # any dropped provenance record means the audit chain and the
            # served-response history have DIVERGED — serving is fine
            # (fail-soft contract) but the registry can no longer attest
            # to every response, which is page-worthy on its own
            active["registry_divergence"] = (
                f"{dropped:.0f} provenance appends dropped in the fast "
                "window (audit chain diverging from served responses)"
            )
        for name, detail in active.items():
            if name not in self._active_anomalies:
                self._metrics.count("slo.anomalies")
                entry = {
                    "ts": round(time.time(), 3),
                    "level": "WARNING",
                    "logger": "ipc_proofs_tpu_torch.obs.slo",
                    "msg": f"anomaly {name}: {detail}",
                }
                get_flight_recorder().record_log(entry)
                logger.warning("%s", entry["msg"])
        self._active_anomalies = active

    # ------------------------------------------------------------------ status

    @locked
    def _render_locked(self) -> dict:
        targets = {}
        worst = "ok"
        for target in self.targets:
            st = self._states[target.name]
            targets[target.name] = {
                "state": st.state,
                "fast_burn": round(st.fast_burn, 3),
                "slow_burn": round(st.slow_burn, 3),
            }
            if _RANK[st.state] > _RANK[worst]:
                worst = st.state
        return {
            "status": worst,
            "targets": targets,
            "anomalies": sorted(self._active_anomalies),
        }

    def status(self) -> dict:
        """Current states without taking a new sample (the healthz path)."""
        with self._lock:
            return self._render_locked()

    # --------------------------------------------------------------- lifecycle

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def _run():
            while not self._stop.wait(self.interval_s):
                try:
                    self.sample()
                except Exception:  # fail-soft: a watchdog crash must never take the daemon down
                    logger.exception("slo watchdog sample failed")

        self._thread = threading.Thread(  # ipclint: disable=race-unannotated
            target=_run, name="slo-watchdog", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
        self._thread = None
