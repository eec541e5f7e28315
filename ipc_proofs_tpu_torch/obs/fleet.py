"""Fleet observability plane: metrics federation, flight-ring merging,
cross-process trace grafting, and bounded per-tenant accounting.

One process has eyes (obs/trace, obs/prom, obs/flight); a fleet —
router + N serve-shard subprocesses — needs them JOINED:

- `FleetFederation` scrapes every shard's ``GET /metrics.json`` and
  ``/healthz`` on a short bounded timeout, fail-soft per shard (a dead
  shard becomes a counted gap, never a scrape failure), and caches the
  latest pass for the router's fleet surfaces.
- `render_fleet_prometheus` renders those per-shard snapshots plus the
  router's own as ONE exposition: every sample labelled
  ``shard="s<k>"`` / ``shard="router"``, with fleet-level aggregates
  (counter/gauge sums, merged histograms) under ``shard="fleet"``.
- `merge_flight_snapshots` joins per-shard flight rings newest-first
  with shard labels — the router's ``/debug/flight``.
- `graft_spans` re-roots shard-shipped span subtrees into THIS process's
  trace spine: span ids are remapped ``<shard>:<id>`` (ids are only
  process-locally unique), monotonic timestamps are rebased via wall
  clocks, and the re-built spans are recorded as if local — so
  ``--trace-out`` exports one tree spanning router → shards → workers.
- `TenantLedger` is the bounded-cardinality tenant accounting of the
  HTTP front end: the first ``top_k`` tenants get their own counter
  label, everyone else pools into ``other``, so a label-cardinality
  attack can't grow the metric space.

The counterpart of ``ipc_proofs_tpu.obs.fleet``, host code only: its
expositions and grafted spans equal the reference's for the same
snapshots.
"""

from __future__ import annotations

import json
import re
import threading
import time
import urllib.request
from typing import Callable, Dict, Iterable, List, Optional, Sequence

from ipc_proofs_tpu_torch.obs.prom import _fmt, _label_escape, _name
from ipc_proofs_tpu_torch.obs.trace import Span, _record
from ipc_proofs_tpu_torch.utils.lockdep import named_lock
from ipc_proofs_tpu_torch.utils.log import get_logger
from ipc_proofs_tpu_torch.utils.metrics import Metrics, get_metrics

__all__ = [
    "FleetFederation",
    "TenantLedger",
    "extract_tenant",
    "graft_spans",
    "merge_counters",
    "merge_flight_snapshots",
    "merge_gauges",
    "merge_histograms",
    "render_fleet_prometheus",
    "subtree_for_response",
]

logger = get_logger(__name__)

_TENANT_BAD = re.compile(r"[^a-zA-Z0-9_.-]")
_TENANT_MAX_LEN = 64


# --------------------------------------------------------------------------
# per-tenant accounting
# --------------------------------------------------------------------------


def extract_tenant(body, headers) -> Optional[str]:
    """Tenant identity of one request: the body ``tenant`` field wins,
    falling back to the ``X-IPC-Tenant`` header. Sanitized to a bounded
    label-safe token; None when the request is untenanted."""
    raw = None
    if isinstance(body, dict):
        raw = body.get("tenant")
    if not raw and headers is not None:
        raw = headers.get("X-IPC-Tenant")
    if not isinstance(raw, str) or not raw.strip():
        return None
    return _TENANT_BAD.sub("_", raw.strip())[:_TENANT_MAX_LEN]


class TenantLedger:
    """Bounded top-K per-tenant request/byte counters.

    The first ``top_k`` distinct tenants observed each get their own
    counter slot; every later tenant accumulates into ``other``. First
    come, first labelled — the point is a hard cardinality bound, not
    fairness (ROADMAP item 6's QoS layer decides fairness)."""

    def __init__(self, metrics: Optional[Metrics] = None, top_k: int = 8):
        self._metrics = metrics if metrics is not None else get_metrics()
        self.top_k = max(0, int(top_k))
        self._lock = named_lock("TenantLedger._lock")
        self._known: set = set()  # guarded-by: _lock

    def account(self, tenant: Optional[str], nbytes: int = 0) -> str:
        """Attribute one admitted request (and its body bytes) to a tenant
        slot; returns the slot actually charged (``other`` on overflow)."""
        if not tenant:
            tenant = "anonymous"
        with self._lock:
            if tenant in self._known:
                slot = tenant
            elif len(self._known) < self.top_k:
                self._known.add(tenant)
                slot = tenant
            else:
                slot = "other"
        self._metrics.count(f"tenant.requests.{slot}")
        if nbytes > 0:
            self._metrics.count(f"tenant.bytes.{slot}", int(nbytes))
        return slot

    def slot_for(self, tenant: Optional[str]) -> str:
        """The counter slot a tenant would be charged to, WITHOUT counting
        anything — the label half of `account`, for callers attributing
        send-time bytes or throttles to an already-admitted request."""
        if not tenant:
            tenant = "anonymous"
        with self._lock:
            if tenant in self._known:
                return tenant
            if len(self._known) < self.top_k:
                self._known.add(tenant)
                return tenant
        return "other"

    def account_bytes(self, tenant: Optional[str], nbytes: int) -> str:
        """Attribute wire bytes (request body or response, measured at
        SEND time so streamed chunks count what actually moved) to a
        tenant slot without incrementing its request counter."""
        slot = self.slot_for(tenant)
        if nbytes > 0:
            self._metrics.count(f"tenant.bytes.{slot}", int(nbytes))
        return slot

    def known(self) -> List[str]:
        with self._lock:
            return sorted(self._known)


# --------------------------------------------------------------------------
# snapshot merging
# --------------------------------------------------------------------------


def merge_counters(snaps: Iterable[dict]) -> Dict[str, float]:
    """Fleet counter view: plain sums across member snapshots."""
    out: Dict[str, float] = {}
    for counters in snaps:
        for k, v in (counters or {}).items():
            out[k] = out.get(k, 0) + v
    return out


def merge_gauges(snaps: Iterable[dict]) -> Dict[str, float]:
    """Fleet gauge view: sums (queue depths, inflight, bytes — every gauge
    in the vocabulary is additive across members)."""
    return merge_counters(snaps)


def merge_histograms(snaps: Iterable[dict]) -> Dict[str, dict]:
    """Fleet histogram view from wire snapshots (``{count, mean, p50,
    p90, p99}`` — the raw reservoirs never cross the wire): counts sum,
    means combine count-weighted, and each quantile takes the MAX across
    members — a conservative fleet tail (the true fleet p99 cannot
    exceed the worst member p99)."""
    out: Dict[str, dict] = {}
    for hists in snaps:
        for name, h in (hists or {}).items():
            count = int(h.get("count", 0))
            if count <= 0:
                continue
            agg = out.setdefault(name, {"count": 0, "_sum": 0.0})
            agg["count"] += count
            agg["_sum"] += float(h.get("mean", 0.0)) * count
            for q in ("p50", "p90", "p99"):
                if q in h:
                    agg[q] = max(agg.get(q, 0.0), float(h[q]))
    for agg in out.values():
        agg["mean"] = agg.pop("_sum") / agg["count"]
    return out


# --------------------------------------------------------------------------
# federation scrape loop
# --------------------------------------------------------------------------


def _get_json(url: str, timeout_s: float):
    """Tiny standalone GET→JSON (no ShardClient import: cluster.router
    imports THIS module). Raises on transport failure or non-2xx."""
    req = urllib.request.Request(url, method="GET")
    with urllib.request.urlopen(req, timeout=timeout_s) as resp:
        if not (200 <= resp.status < 300):
            raise OSError(f"HTTP {resp.status} from {url}")
        return json.loads(resp.read().decode("utf-8"))


class FleetFederation:
    """Scrape every shard's metrics snapshot + health on a short, bounded
    timeout; fail-soft per shard; cache the latest pass.

    ``shard_urls`` is a callable returning the CURRENT ``{name: base_url}``
    map (the router's ring membership changes when shards die), so the
    loop always scrapes live topology."""

    def __init__(
        self,
        shard_urls: Callable[[], Dict[str, str]],
        metrics: Optional[Metrics] = None,
        interval_s: float = 5.0,
        timeout_s: float = 2.0,
        fetch=None,
    ):
        self._shard_urls = shard_urls
        self._metrics = metrics if metrics is not None else get_metrics()
        self.interval_s = float(interval_s)
        self.timeout_s = float(timeout_s)
        self._fetch = fetch if fetch is not None else _get_json
        self._lock = named_lock("FleetFederation._lock")
        self._latest: Optional[dict] = None  # guarded-by: _lock
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def scrape(self) -> dict:
        """One federation pass over the current topology. Never raises:
        a dead or slow shard becomes ``{"error": ...}`` in the result
        (and a ``fleet.scrape_errors`` tick) — the fleet view keeps
        serving degraded."""
        shards: Dict[str, dict] = {}
        for sname, base_url in sorted(self._shard_urls().items()):
            self._metrics.count("fleet.scrapes")
            entry: dict = {"metrics": None, "healthz": None, "error": None}
            try:
                entry["metrics"] = self._fetch(
                    base_url.rstrip("/") + "/metrics.json", self.timeout_s
                )
                entry["healthz"] = self._fetch(
                    base_url.rstrip("/") + "/healthz", self.timeout_s
                )
            except Exception as exc:  # fail-soft: one dead shard must not darken the fleet view
                entry["error"] = str(exc) or exc.__class__.__name__
                self._metrics.count("fleet.scrape_errors")
            shards[sname] = entry
        result = {"captured_at": round(time.time(), 3), "shards": shards}
        with self._lock:
            self._latest = result
        return result

    def latest(self, max_age_s: Optional[float] = None) -> dict:
        """Most recent scrape, refreshing inline when stale (or when the
        loop has never run — the pull-through path for one-shot callers)."""
        with self._lock:
            cached = self._latest
        if cached is not None and (
            max_age_s is None
            or time.time() - cached["captured_at"] <= max_age_s
        ):
            return cached
        return self.scrape()

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def _run():
            while not self._stop.wait(self.interval_s):
                try:
                    self.scrape()
                except Exception:  # fail-soft: the scrape loop must outlive any surprise
                    logger.exception("fleet scrape pass failed")

        self._thread = threading.Thread(  # ipclint: disable=race-unannotated
            target=_run, name="fleet-scrape", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
        self._thread = None


# --------------------------------------------------------------------------
# fleet prometheus exposition
# --------------------------------------------------------------------------


def render_fleet_prometheus(
    shard_snaps: Dict[str, Optional[dict]], router_snap: Optional[dict] = None
) -> str:
    """One exposition for the whole fleet: every member's samples under a
    ``shard=`` label plus ``shard="fleet"`` aggregates. ``shard_snaps``
    maps shard name → `Metrics.snapshot()` dict (None for a shard whose
    scrape failed — it simply contributes no samples)."""
    members: List[tuple] = [
        (sname, snap) for sname, snap in sorted(shard_snaps.items()) if snap
    ]
    if router_snap is not None:
        members.append(("router", router_snap))
    lines: List[str] = []

    def sample(family: str, shard: str, value, suffix: str = "", extra: str = "") -> None:
        labels = f'shard="{_label_escape(shard)}"{extra}'
        lines.append(f"{family}{suffix}{{{labels}}} {_fmt(value)}")

    # counters
    families: Dict[str, Dict[str, float]] = {}
    for sname, snap in members:
        for raw, v in (snap.get("counters") or {}).items():
            families.setdefault(raw, {})[sname] = v
    for raw in sorted(families):
        fam = _name(raw) + "_total"
        lines.append(f"# HELP {fam} Counter {raw}")
        lines.append(f"# TYPE {fam} counter")
        per = families[raw]
        for sname in per:
            sample(fam, sname, per[sname])
        sample(fam, "fleet", sum(per.values()))

    # gauges (+ uptime treated as a per-member gauge)
    gfamilies: Dict[str, Dict[str, float]] = {}
    for sname, snap in members:
        gauges = dict(snap.get("gauges") or {})
        if snap.get("uptime_s") is not None:
            gauges["uptime_seconds"] = snap["uptime_s"]
        for raw, v in gauges.items():
            gfamilies.setdefault(raw, {})[sname] = v
    for raw in sorted(gfamilies):
        fam = _name(raw)
        lines.append(f"# HELP {fam} Gauge {raw}")
        lines.append(f"# TYPE {fam} gauge")
        per = gfamilies[raw]
        for sname in per:
            sample(fam, sname, per[sname])
        sample(fam, "fleet", sum(per.values()))

    # histograms as summaries: per-member quantiles/_sum/_count plus the
    # merged fleet series
    hfamilies: Dict[str, Dict[str, dict]] = {}
    for sname, snap in members:
        for raw, h in (snap.get("histograms") or {}).items():
            hfamilies.setdefault(raw, {})[sname] = h
    for raw in sorted(hfamilies):
        fam = _name(raw)
        lines.append(f"# HELP {fam} Summary {raw} (ring-buffer percentiles)")
        lines.append(f"# TYPE {fam} summary")
        per = hfamilies[raw]
        merged = merge_histograms([{raw: h} for h in per.values()]).get(raw)
        for sname, h in list(per.items()) + [("fleet", merged or {})]:
            for pkey, q in (("p50", "0.5"), ("p90", "0.9"), ("p99", "0.99")):
                if pkey in h:
                    sample(fam, sname, h[pkey], extra=f',quantile="{q}"')
            count = h.get("count", 0)
            sample(fam, sname, h.get("mean", 0.0) * count, suffix="_sum")
            sample(fam, sname, count, suffix="_count")
    return "\n".join(lines) + "\n"


# --------------------------------------------------------------------------
# flight-ring federation
# --------------------------------------------------------------------------


def merge_flight_snapshots(
    shard_snaps: Dict[str, Optional[dict]], local_snap: Optional[dict] = None
) -> dict:
    """Join per-member flight snapshots into one shard-labelled, newest-
    first view. A member mapped to None contributes nothing but is listed
    under ``failed`` — the post-incident reader must know the ring had a
    blind spot, not infer silence as health."""
    members = dict(shard_snaps)
    if local_snap is not None:
        members["router"] = local_snap
    spans: List[dict] = []
    logs: List[dict] = []
    failed: List[str] = []
    for sname in sorted(members):
        snap = members[sname]
        if not snap:
            failed.append(sname)
            continue
        for sp in snap.get("spans", ()):
            d = dict(sp)
            d["shard"] = sname
            spans.append(d)
        for e in snap.get("logs", ()):
            d = dict(e)
            d["shard"] = sname
            logs.append(d)
    spans.sort(key=lambda d: d.get("wall_ts", 0.0), reverse=True)
    logs.sort(key=lambda d: d.get("ts", 0.0), reverse=True)
    return {
        "captured_at": round(time.time(), 3),
        "shards": sorted(k for k in members if k != "router"),
        "failed": failed,
        "spans": spans,
        "logs": logs,
    }


# --------------------------------------------------------------------------
# cross-process trace stitching
# --------------------------------------------------------------------------


def subtree_for_response(sp, max_spans: int = 128) -> List[dict]:
    """The span subtree rooted at ``sp`` (this request's adopted span),
    as dicts ready to ship in a response body. ``sp`` is still OPEN when
    the response renders, so it is included with its duration so far —
    the router grafts the closed picture it has. Restricting to sp's
    DESCENDANTS (not the whole trace) keeps a second dispatch of the
    same trace to this shard from re-shipping earlier subtrees."""
    from ipc_proofs_tpu_torch.obs.trace import spans_for_trace

    recorded = spans_for_trace(sp.trace_id)
    children: Dict[str, List] = {}
    for s in recorded:
        children.setdefault(s.parent_id, []).append(s)
    out: List[dict] = []
    head = dict(sp.to_dict())
    head["dur_us"] = max(0, time.perf_counter_ns() // 1000 - sp.ts_us)
    out.append(head)
    queue = [sp.span_id]
    while queue and len(out) < max_spans:
        pid = queue.pop(0)
        for s in children.get(pid, ()):
            if len(out) >= max_spans:
                break
            out.append(s.to_dict())
            queue.append(s.span_id)
    return out


def graft_spans(
    span_dicts: Sequence[dict],
    shard: str,
    metrics: Optional[Metrics] = None,
    max_spans: int = 256,
) -> int:
    """Re-root shard-shipped spans into THIS process's spine.

    Span ids are process-local counters, so every shipped id is remapped
    to ``<shard>:<id>`` (parents too, when the parent shipped alongside;
    a parent OUTSIDE the set is the router's own dispatch span id from
    the carrier and is kept verbatim — that's the graft point). ``ts_us``
    is the shard's monotonic timebase, meaningless here: rebased through
    ``wall_ts`` into the local perf-counter timebase so one exported
    tree timelines coherently. Returns the number of spans grafted."""
    m = metrics if metrics is not None else get_metrics()
    span_dicts = list(span_dicts)[:max_spans]
    shipped = {
        d.get("span_id") for d in span_dicts if isinstance(d, dict)
    }
    offset_us = time.perf_counter_ns() // 1000 - int(time.time() * 1e6)
    grafted = 0
    for d in span_dicts:
        if not isinstance(d, dict):
            continue
        try:
            parent = d.get("parent_id") or ""
            if parent in shipped:
                parent = f"{shard}:{parent}"
            sp = Span(
                str(d["name"]),
                str(d["trace_id"]),
                f"{shard}:{d['span_id']}",
                parent,
            )
            wall_ts = float(d.get("wall_ts", 0.0))
            sp.wall_ts = wall_ts
            sp.ts_us = int(wall_ts * 1e6) + offset_us
            sp.dur_us = int(d.get("dur_us", 0))
            sp.thread_name = f"{shard}/{d.get('thread', '')}"
            attrs = dict(d.get("attrs") or {})
            attrs["shard"] = shard
            sp.attrs = attrs
            sp.sampled = True  # only sampled traces ship subtrees
        except (KeyError, TypeError, ValueError):
            continue  # fail-soft: one malformed shipped span, not the graft
        _record(sp)
        grafted += 1
    if grafted:
        m.count("fleet.spans_grafted", grafted)
    return grafted
