"""Consistent-hash front-end router over N shard daemons.

The counterpart of ``ipc_proofs_tpu.cluster.router``: the same placement,
failover, scatter-gather bytes, streams and routes. The router is host
code and launches no kernel; the kernels run in the shards, each a full
`ProofService` on one `GpuBackend`. A shard's answer passes through as
the shard gave it, so a fault of the card on a shard (500 ``error_type:
device``, or a ``device`` abort chunk in a stream) reaches the client
verbatim and marks no shard dead. One departure, by design: the router's
backfill window runner raises `ops.build.DeviceFaultError` for a shard's
``device`` answer (the reference raises `ShardUnavailable` for every
non-200), so such a job ends ``faulted`` with its windows journalled, and
the router's backfill door answers it 500 ``error_type: device`` (its
chunk stream ends in a ``device`` abort chunk), as a daemon's door does.
And a fix the reference lacks: a deadline that runs out at a relay's own
dispatch, after a streamed scatter has begun, ends the stream in a
``deadline`` abort chunk (the reference's says ``internal``, which breaks
its own rule that a deadline loss is typed on every door). The door's
listener keeps a backlog of 128 connections, as the port's daemon does
(the stdlib's 5 resets a burst of clients connecting together).

The router is the cluster's single client-facing door. Placement is a
two-layer decision:

1. **Affinity** — the hash ring (`cluster/hashring.py`) maps a request's
   pair key onto a shard, so repeated traffic for one tipset pair lands
   where its witness blocks are already cached. Affinity is a CACHE hint.
2. **Stealing** — if the affine shard's in-flight depth exceeds the
   least-loaded shard's by ``steal_threshold``, the request is stolen by
   the least-loaded shard instead (``cluster.steals``). Any shard can
   serve any key, so stealing can never be wrong — it only trades cache
   warmth for queue latency.

Failover follows from the same property: a shard that stops answering is
marked dead, its ring arc redistributes to the survivors
(``cluster.shard_failovers``), and the in-flight request is re-dispatched
to the next shard **with the same idempotency key** it was first sent
with. Delivery is at-least-once; the durable queue's idempotency dedup
(`serve/durable.py`) absorbs the retry, so a request that executed on a shard that died
mid-response is served from that shard's journal on recovery rather than
double-executed — and without durable queues the replay merely
regenerates a deterministic (identical) response.

Range requests scatter-gather: pairs partition by per-pair affinity
(steal-aware), each group dispatches concurrently as one
``/v1/generate_range`` sub-request carrying the router span's trace
carrier (one trace covers the fan-out), and the sub-bundles fold
incrementally through `cluster.gather.BundleFold` — one CID map, one
seal-time sort — into bytes identical to a single-daemon run.

Standing queries shard differently: a subscription is STATE, not a
request, so it must live on exactly the shard that owns its filter's
ring arc (`subscription_ring_key` — all subscribers of one filter
colocate, preserving the generate-once amortization). Subscription
routes therefore use `_dispatch_affine`, which never steals. The router
mirrors ``sub_id → (ring_key, register body)`` so that when a shard
dies, `_mark_dead` re-registers the dead arc's subscriptions on their
new affine shards under the ORIGINAL subscription ids
(``cluster.subs_rearced``) — the registry's durable dedup absorbs
replays, and unacked deliveries re-push from the surviving shard's
journal on recovery.
"""

from __future__ import annotations

import hashlib
import http.client
import json
import os
import threading
import time
import urllib.error
import urllib.request
import uuid
from concurrent.futures import ThreadPoolExecutor, as_completed
from http.server import BaseHTTPRequestHandler
from typing import Dict, List, Optional, Sequence, Tuple
from urllib.parse import parse_qs, urlencode, urlsplit

from ipc_proofs_tpu_torch.cluster.gather import BundleFold, partition_indexes
from ipc_proofs_tpu_torch.cluster.hashring import HashRing, pair_ring_key
from ipc_proofs_tpu_torch.obs.fleet import (
    FleetFederation,
    TenantLedger,
    extract_tenant,
    graft_spans,
    merge_flight_snapshots,
    render_fleet_prometheus,
)
from ipc_proofs_tpu_torch.obs.flight import get_flight_recorder
from ipc_proofs_tpu_torch.obs.prom import CONTENT_TYPE as _PROM_CONTENT_TYPE
from ipc_proofs_tpu_torch.obs.trace import (
    carrier_from_context,
    current_context,
    root_span,
    span,
    use_context,
)
from ipc_proofs_tpu_torch.ops.build import DeviceFaultError
from ipc_proofs_tpu_torch.proofs.bundle import UnifiedProofBundle
from ipc_proofs_tpu_torch.serve.httpd import _Listener
from ipc_proofs_tpu_torch.serve.qos import TenantQoS, TenantThrottledError
from ipc_proofs_tpu_torch.witness.errors import (
    StreamAbortError,
    WitnessEncodingError,
    WitnessIntegrityError,
)
from ipc_proofs_tpu_torch.subs.registry import normalize_filter, subscription_ring_key
from ipc_proofs_tpu_torch.witness.stream import (
    CHUNK_BLOCK,
    CHUNK_ERROR,
    CHUNK_TRAILER,
    CHUNKED_TERMINATOR,
    STREAM_CONTENT_TYPE,
    BundleStreamWriter,
    iter_stream_chunks,
    negotiate_stream,
    parse_block_chunk,
    send_buffers,
    stream_backfill_chunks,
)
from ipc_proofs_tpu_torch.utils.deadline import (
    CancelScope,
    Deadline,
    DeadlineError,
    current_scope,
    remaining_budget_s,
    use_scope,
)
from ipc_proofs_tpu_torch.utils.log import get_logger
from ipc_proofs_tpu_torch.utils.threads import locked
from ipc_proofs_tpu_torch.utils.metrics import Metrics
from ipc_proofs_tpu_torch.utils.lockdep import named_lock

__all__ = [
    "ClusterRouter",
    "NoShardsError",
    "RouterHTTPServer",
    "ShardClient",
    "ShardUnavailable",
]

logger = get_logger(__name__)


class ShardUnavailable(RuntimeError):
    """Transport-level shard failure (refused, reset, timed out) — the
    signal that triggers failover. An HTTP error status is NOT this:
    a shard that answers 4xx/5xx is alive and its answer is authoritative."""


class NoShardsError(RuntimeError):
    """Every shard is dead (or was born dead) — nothing to route to."""


class ShardClient:
    """Minimal stdlib HTTP client for one shard base URL.

    Returns ``(status, json_obj)`` for whatever the shard answered;
    raises `ShardUnavailable` only for transport failures. No retries
    here — retry/failover policy belongs to the router, which must
    preserve idempotency keys across attempts.
    """

    def __init__(self, name: str, base_url: str, timeout_s: float = 120.0):
        self.name = name
        self.base_url = base_url.rstrip("/")
        self.timeout_s = timeout_s

    def post(self, path: str, body: dict) -> "tuple[int, dict]":
        data = json.dumps(body).encode("utf-8")
        req = urllib.request.Request(
            self.base_url + path,
            data=data,
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        return self._roundtrip(req)

    def get(self, path: str) -> "tuple[int, dict]":
        req = urllib.request.Request(self.base_url + path, method="GET")
        return self._roundtrip(req)

    def post_stream(self, path: str, body: dict):
        """POST asking for the IPBS streamed form (``Accept``). Returns
        ``("stream", resp)`` with the LIVE response object when the shard
        streamed — the caller reads chunks incrementally and must close
        it — or ``("json", (status, obj))`` when the shard answered
        buffered JSON (error statuses, or doors that don't stream).
        Transport failure raises `ShardUnavailable`, exactly like `post`.
        """
        data = json.dumps(body).encode("utf-8")
        req = urllib.request.Request(
            self.base_url + path,
            data=data,
            headers={
                "Content-Type": "application/json",
                "Accept": STREAM_CONTENT_TYPE,
            },
            method="POST",
        )
        try:
            resp = urllib.request.urlopen(req, timeout=self.timeout_s)
        except urllib.error.HTTPError as exc:
            try:
                obj = json.loads(exc.read())
            except (ValueError, OSError):
                obj = {"error": f"shard returned {exc.code}"}
            return "json", (exc.code, obj)
        except (urllib.error.URLError, ConnectionError, TimeoutError, OSError) as exc:
            raise ShardUnavailable(f"shard {self.name}: {exc}") from exc
        ctype = resp.headers.get("Content-Type", "")
        if STREAM_CONTENT_TYPE not in ctype:
            try:
                with resp:
                    return "json", (resp.status, json.loads(resp.read()))
            except (
                ValueError,
                ConnectionError,
                TimeoutError,
                OSError,
                http.client.HTTPException,
            ) as exc:
                raise ShardUnavailable(f"shard {self.name}: {exc}") from exc
        return "stream", resp

    def _roundtrip(self, req) -> "tuple[int, dict]":
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
                return resp.status, json.loads(resp.read())
        except urllib.error.HTTPError as exc:
            # an HTTP status IS an answer from a live shard — pass it up
            try:
                obj = json.loads(exc.read())
            except (ValueError, OSError):
                obj = {"error": f"shard returned {exc.code}"}
            return exc.code, obj
        except (urllib.error.URLError, ConnectionError, TimeoutError, OSError) as exc:
            raise ShardUnavailable(f"shard {self.name}: {exc}") from exc


def _abort_type(exc: BaseException) -> str:
    """The abort chunk's type for a scatter that failed on the router's
    side once its stream had begun: a budget that ran out at a relay's
    dispatch stays typed (``deadline`` / ``cancelled``, the contract of
    `DeadlineError`), anything else is ``internal``. The reference writes
    ``internal`` for both."""
    return exc.error_type if isinstance(exc, DeadlineError) else "internal"


class _ShardState:
    __slots__ = ("client", "alive", "inflight", "latency_ewma_s")

    def __init__(self, client: ShardClient):
        self.client = client
        self.alive = True
        self.inflight = 0
        # EWMA of observed dispatch latency (s). Starts at 0 so a shard
        # is judged purely on queue depth until it has been measured —
        # remote members earn their latency penalty from real traffic.
        self.latency_ewma_s = 0.0


class ClusterRouter:
    """Route requests across shard daemons; steal, fail over, gather.

    ``shards`` maps shard name → base URL (or pre-built `ShardClient`).
    ``pairs`` is the shared pair table every shard was built with — the
    router speaks pair indexes on the wire exactly like the single-daemon
    HTTP API, so a cluster of one is protocol-identical to plain serve.
    """

    def __init__(
        self,
        shards: "Dict[str, str] | Dict[str, ShardClient]",
        pairs: Sequence,
        steal_threshold: int = 4,
        steal_latency_unit_s: float = 0.25,
        deadline_floor_ms: float = 5.0,
        replication_factor: int = 1,
        cut_through: bool = True,
        vnodes: int = 64,
        metrics: Optional[Metrics] = None,
        request_timeout_s: float = 120.0,
        max_workers: int = 16,
        scrape_interval_s: float = 5.0,
        scrape_timeout_s: float = 2.0,
        slo=None,
        tenant_top_k: int = 8,
        tenant_rate: Optional[float] = None,
        tenant_burst: Optional[float] = None,
        spec=None,
        backfill_jobs_dir: Optional[str] = None,
        backfill_window_size: int = 8,
        backfill_window_parallelism: Optional[int] = None,
    ):
        if not shards:
            raise NoShardsError("a cluster needs at least one shard")
        self.pairs = list(pairs)
        self.steal_threshold = max(1, int(steal_threshold))
        # latency-penalty term for placement: a shard's observed dispatch
        # EWMA counts as `ewma / unit` phantom queue entries, so a slow
        # (remote, cross-host) shard loses steals it would win on queue
        # depth alone. The unit is "one queue slot's worth of latency".
        self.steal_latency_unit_s = max(1e-6, float(steal_latency_unit_s))
        # hop floor for deadline propagation: a forwarded request whose
        # remaining budget is at/below this is refused typed rather than
        # dispatched to a shard that can only fail it late
        self.deadline_floor_ms = max(0.0, float(deadline_floor_ms))
        # R-way replication of the segment tier (1 = off): every owner's
        # segment files are mirrored onto the next R-1 distinct ring
        # successors so a corrupt frame repairs peer-first and a dead
        # host's arcs survive elsewhere. Supervised by `replicate_now`.
        self.replication_factor = max(1, int(replication_factor))
        # streamed scatters relay shard B chunks as they arrive instead
        # of buffering each shard's JSON sub-response (`post_stream`)
        self.cut_through = bool(cut_through)
        self.metrics = metrics if metrics is not None else Metrics()
        self._lock = named_lock("ClusterRouter._lock")
        self._shards: "Dict[str, _ShardState]" = {}  # guarded-by: _lock
        self._ring = HashRing(vnodes=vnodes)  # guarded-by: _lock
        for name, target in shards.items():
            client = (
                target
                if isinstance(target, ShardClient)
                else ShardClient(name, target, timeout_s=request_timeout_s)
            )
            self._shards[name] = _ShardState(client)
            self._ring.add(name)
        self._keys = [pair_ring_key(p) for p in self.pairs]
        # sub_id → (ring_key, register body): the failover mirror that lets
        # _mark_dead re-home a dead shard's subscription arc.
        self._standing: "Dict[str, Tuple[str, dict]]" = {}  # guarded-by: _lock
        # last replication supervision pass (see replicate_now)
        self._replication_last: Optional[dict] = None  # guarded-by: _lock
        self._executor = ThreadPoolExecutor(
            max_workers=max_workers, thread_name_prefix="cluster-scatter"
        )
        # Fleet observability plane: a short-timeout scraper federating
        # every shard's metrics/health into one router-side view, a
        # per-tenant accounting ledger, and an optional SLO watchdog
        # (owned by the caller; the router only surfaces its status).
        self.federation = FleetFederation(
            self._alive_shard_urls,
            metrics=self.metrics,
            interval_s=scrape_interval_s,
            timeout_s=scrape_timeout_s,
        )
        self.tenants = TenantLedger(metrics=self.metrics, top_k=tenant_top_k)
        # per-tenant QoS at the cluster door (--tenant-rate/--tenant-burst):
        # the ONE front door throttles, so shard-side buckets aren't also
        # needed — a router-admitted request must not 429 halfway through
        # its scatter
        self.qos = (
            TenantQoS(
                tenant_rate,
                burst=tenant_burst,
                metrics=self.metrics,
                ledger=self.tenants,
            )
            if tenant_rate
            else None
        )
        self.slo = slo
        # bulk backfill over the whole cluster: windows fan out to their
        # arc shards through the steal-aware dispatch below. The engine
        # is built lazily on first submit (it snapshots alive shards for
        # planning); `spec` binds journal manifests to the deployment's
        # filter when the caller has it (optional — one cluster serves
        # one spec, so an opaque manifest is still unambiguous)
        self._backfill_spec = spec
        self._backfill_jobs_dir = backfill_jobs_dir
        self._backfill_window_size = int(backfill_window_size)
        self._backfill_parallelism = backfill_window_parallelism
        self._backfill = None  # guarded-by: _lock
        self._gauge_alive_locked()

    # --- placement (all under _lock) --------------------------------------

    @locked
    def _gauge_alive_locked(self) -> None:
        self.metrics.set_gauge(
            "cluster.shards_alive",
            sum(1 for s in self._shards.values() if s.alive),
        )

    @locked
    def _affinity_locked(self, key: str) -> str:
        return self._ring.node_for(key)

    def _effective_load_locked(self, state: _ShardState) -> float:
        """Queue depth plus the latency penalty: the shard's dispatch
        EWMA expressed in queue-slot units (`steal_latency_unit_s`). A
        cross-host member with a slow link looks busier than its raw
        inflight count, so stealing doesn't flood the slowest shard."""
        return state.inflight + state.latency_ewma_s / self.steal_latency_unit_s

    @locked
    def _place_locked(self, key: str) -> str:
        """Affinity shard unless stealing wins (see module docstring)."""
        if not len(self._ring):
            raise NoShardsError("all shards are dead")
        affine = self._affinity_locked(key)
        least_state = min(
            (s for s in self._shards.values() if s.alive),
            key=lambda s: (self._effective_load_locked(s), s.client.name),
        )
        least = least_state.client.name
        if (
            least != affine
            and self._effective_load_locked(self._shards[affine])
            - self._effective_load_locked(least_state)
            >= self.steal_threshold
        ):
            self.metrics.count("cluster.steals")
            affine_state = self._shards[affine]
            if (
                affine_state.inflight - least_state.inflight
                < self.steal_threshold
            ):
                # raw queue depth alone would NOT have stolen — the
                # latency-EWMA penalty drove placement off the affine
                # shard. That's the slow-not-dead quarantine: a shard
                # answering slowly sheds traffic without being marked dead
                self.metrics.count("cluster.slow_quarantines")
            return least
        return affine

    def _acquire(self, key: str) -> "tuple[str, ShardClient]":
        with self._lock:
            name = self._place_locked(key)
            state = self._shards[name]
            state.inflight += 1
            self.metrics.set_gauge(f"cluster.inflight.{name}", state.inflight)
            return name, state.client

    def _release(self, name: str) -> None:
        with self._lock:
            state = self._shards.get(name)
            if state is not None and state.inflight > 0:
                state.inflight -= 1
                self.metrics.set_gauge(
                    f"cluster.inflight.{name}", state.inflight
                )

    def _note_latency(self, name: str, elapsed_s: float) -> None:
        """Fold one observed dispatch latency into the shard's EWMA
        (alpha 0.2 — a few requests to converge, one slow blip decays)."""
        with self._lock:
            state = self._shards.get(name)
            if state is not None:
                state.latency_ewma_s = (
                    0.8 * state.latency_ewma_s + 0.2 * elapsed_s
                )

    def _alive_shard_urls(self) -> "Dict[str, str]":
        """Scrape targets for the federation: live shards' base URLs."""
        with self._lock:
            return {
                name: state.client.base_url
                for name, state in self._shards.items()
                if state.alive
            }

    def _mark_dead(self, name: str) -> None:
        rearc: "List[Tuple[str, str, dict]]" = []
        with self._lock:
            state = self._shards.get(name)
            if state is None or not state.alive:
                return  # concurrent requests race to report one death once
            # Collect the dying shard's subscription arc BEFORE the ring
            # mutates — node_for() must still see the old topology to know
            # which subscriptions lived there.
            for sid, (key, body) in self._standing.items():
                if len(self._ring) and self._ring.node_for(key) == name:
                    rearc.append((sid, key, body))
            state.alive = False
            self._ring.remove(name)
            self._gauge_alive_locked()
        self.metrics.count("cluster.shard_errors")
        logger.warning(
            "cluster: shard %s unreachable — ring arc redistributed", name
        )
        self._rearc_subscriptions(name, rearc)
        if self.replication_factor > 1:
            # a death drops some arcs below R — re-replicate onto the
            # survivors in the background (tests call replicate_now()
            # synchronously instead; the pass is idempotent)
            try:
                self._executor.submit(self._replicate_after_death)
            except RuntimeError:
                pass  # executor already shut down (router closing)

    def _rearc_subscriptions(
        self, dead: str, rearc: "List[Tuple[str, str, dict]]"
    ) -> None:
        """Re-register a dead shard's subscriptions on their new affine
        shards under the ORIGINAL sub ids — the registries' durable dedup
        absorbs replays, so this is safe to repeat."""
        for sid, key, body in rearc:
            try:
                status, _obj = self._dispatch_affine(
                    key, "/v1/subscribe", dict(body)
                )
            except NoShardsError:
                logger.warning(
                    "cluster: no shard left to re-home subscriptions from %s",
                    dead,
                )
                return
            if status == 200:
                self.metrics.count("cluster.subs_rearced")
            else:  # fail-soft: a live shard rejected the replay — log & go on
                logger.warning(
                    "cluster: re-registering %s after %s died failed: %s",
                    sid,
                    dead,
                    status,
                )

    def revive(self, name: str) -> None:
        """Re-admit a recovered shard (ops action / test hook): its ring
        arc comes back and traffic re-affinitizes on the next request."""
        with self._lock:
            state = self._shards.get(name)
            if state is None or state.alive:
                return
            state.alive = True
            self._ring.add(name)
            self._gauge_alive_locked()

    def alive_shards(self) -> "List[str]":
        with self._lock:
            return sorted(n for n, s in self._shards.items() if s.alive)

    # --- replicated segment tier (storex.replica) ---------------------------

    @locked
    def _replication_plan_locked(self) -> "Dict[str, List[str]]":
        """Owner token → replica shard names. A LIVE owner's segments
        mirror onto the next R-1 distinct ring successors; a DEAD
        owner's token still walks the (survivor) ring but needs R full
        copies — its own copy died with it. Deterministic in membership,
        so every supervision pass converges to the same placement."""
        plan: "Dict[str, List[str]]" = {}
        want = self.replication_factor
        if not len(self._ring):
            return plan
        for owner, state in self._shards.items():
            nodes = [
                n
                for n in self._ring.nodes_for(owner, want + 1)
                if n != owner
            ]
            plan[owner] = nodes[: want - 1] if state.alive else nodes[:want]
        return plan

    def _replicate_after_death(self) -> None:
        try:
            self.replicate_now()
        except Exception:  # fail-soft: a failed supervision pass must not poison the failover path; the next periodic pass retries and under_replicated_arcs stays raised
            logger.exception("cluster: replication pass after death failed")

    def replicate_now(self) -> dict:
        """One replication supervision pass (idempotent, safe to repeat):

        1. compute the owner → replicas plan from the ring;
        2. install every live shard's read-repair peer set
           (``POST /v1/replica_peers`` — all OTHER live shards: segments
           are content-addressed, so over-asking is merely wasted probes);
        3. tell each replica shard to pull its assigned owners' segment
           files (``POST /v1/replicate``).

        Runs at boot, after any `_mark_dead`, and on demand. Gauges:
        ``cluster.under_replicated_arcs`` (owners whose plan didn't fully
        sync this pass) and ``cluster.replication_lag_segments`` (segment
        pulls still pending under the per-pass byte budget)."""
        summary: dict = {
            "factor": self.replication_factor,
            "plan": {},
            "shards": {},
            "errors": [],
        }
        if self.replication_factor <= 1:
            with self._lock:
                self._replication_last = summary
            return summary
        self.metrics.count("cluster.replications_triggered")
        with self._lock:
            plan = self._replication_plan_locked()
            live = {
                n: s.client for n, s in self._shards.items() if s.alive
            }
        summary["plan"] = {o: list(r) for o, r in plan.items()}
        pull: "Dict[str, List[str]]" = {n: [] for n in live}
        for owner, replicas in plan.items():
            for name in replicas:
                if name in pull:
                    pull[name].append(owner)
        lag = 0
        failed_owners: "set[str]" = set()
        for name in sorted(live):
            client = live[name]
            peers = [
                {"name": n, "url": c.base_url}
                for n, c in sorted(live.items())
                if n != name
            ]
            owners = sorted(pull[name])
            try:
                status, _obj = client.post(
                    "/v1/replica_peers", {"peers": peers}
                )
                if status != 200:
                    # shard without a disk tier: can't hold replicas
                    if owners:
                        failed_owners.update(owners)
                    continue
                if not owners:
                    continue
                status, obj = client.post(
                    "/v1/replicate", {"sources": peers, "owners": owners}
                )
            except ShardUnavailable:
                self._mark_dead(name)
                failed_owners.update(owners)
                summary["errors"].append(f"{name}: unreachable")
                continue
            if status != 200 or not isinstance(obj, dict):
                failed_owners.update(owners)
                summary["errors"].append(f"{name}: http {status}")
                continue
            if obj.get("errors"):
                failed_owners.update(owners)
                summary["errors"].extend(
                    f"{name}: {e}" for e in obj["errors"]
                )
            lag += int(obj.get("pending") or 0)
            summary["shards"][name] = {
                k: obj.get(k) for k in ("pulled", "bytes", "blocks", "pending")
            }
        summary["under_replicated"] = sorted(failed_owners)
        summary["lag_segments"] = lag
        self.metrics.set_gauge(
            "cluster.under_replicated_arcs", len(failed_owners)
        )
        self.metrics.set_gauge("cluster.replication_lag_segments", lag)
        with self._lock:
            self._replication_last = summary
        return summary

    # --- dispatch with failover -------------------------------------------

    def _stamp_deadline(self, body: dict, path: str) -> None:
        """Re-emit the ambient deadline budget on a forwarded body.

        The ambient `Deadline` is absolute-monotonic, so reading it here
        yields the budget ALREADY decremented by router time (parse,
        placement, earlier failover attempts). A budget at/below the
        router floor refuses the hop typed (``deadline.rejects.router``)
        instead of dispatching work a shard can only fail late."""
        rem_s = remaining_budget_s()
        if rem_s is None:
            return
        rem_ms = rem_s * 1000.0
        if rem_ms <= self.deadline_floor_ms:
            self.metrics.count("serve.deadline_rejects")
            self.metrics.count("deadline.rejects.router")
            raise DeadlineError(
                f"remaining budget {rem_ms:.0f}ms at/below router floor "
                f"({self.deadline_floor_ms:.0f}ms) forwarding {path}",
                stage="router.dispatch",
            )
        body["deadline_ms"] = rem_ms

    def _dispatch(self, key: str, path: str, body: dict) -> "tuple[int, dict]":
        """Send one request, failing over (same idempotency key) until a
        live shard answers or none remain. At-least-once by construction:
        a shard that died after executing leaves a journaled result the
        retry's dedup key recovers instead of re-executing."""
        body = dict(body)
        body.setdefault("idempotency_key", uuid.uuid4().hex)
        carrier = carrier_from_context()
        if carrier is not None:
            body["trace"] = carrier
        attempted: "set[str]" = set()
        while True:
            # re-read the budget each attempt: failover retries burn it
            self._stamp_deadline(body, path)
            name, client = self._acquire(key)
            if name in attempted:
                # the ring only has shards we already failed against —
                # give up rather than hot-loop on a flapping shard
                self._release(name)
                raise NoShardsError(
                    f"no shard answered {path} (tried {sorted(attempted)})"
                )
            attempted.add(name)
            self.metrics.count("cluster.sub_requests")
            try:
                t0 = time.monotonic()
                with span(
                    "cluster.dispatch", {"shard": name, "path": path}
                ):
                    status, obj = client.post(path, body)
                self._note_latency(name, time.monotonic() - t0)
                if isinstance(obj, dict):
                    self._graft_shard_spans(name, obj)
                return status, obj
            except ShardUnavailable:
                self._mark_dead(name)
                # every re-dispatch after a death is a failover — including
                # the first attempt finding a corpse
                self.metrics.count("cluster.shard_failovers")
            finally:
                self._release(name)

    def _graft_shard_spans(self, shard: str, obj: dict) -> None:
        """Stitch a shard's shipped span subtree into this process's trace.

        Shards attach a bounded ``spans`` field to sampled responses (see
        ``httpd._attach_spans``); the router grafts those spans under its
        own dispatch spans so one scatter-gather renders as ONE tree. The
        field is stripped either way — clients never see the plumbing.
        In-process shards (tests' LocalShard) share our span store, so a
        matching ``spans_pid`` means the subtree is already recorded.
        """
        shipped = obj.pop("spans", None)
        shipped_pid = obj.pop("spans_pid", None)
        if not shipped or shipped_pid == os.getpid():
            return
        graft_spans(shipped, shard, metrics=self.metrics)

    def _dispatch_affine(
        self, key: str, path: str, body: Optional[dict] = None
    ) -> "tuple[int, dict]":
        """Affinity-PINNED dispatch for subscription state. Unlike
        `_dispatch` this never steals: the registry shard owning ``key``'s
        arc is the only one holding that filter's subscriptions, so the
        request must land there. Failover recomputes the arc owner after
        `_mark_dead` shrinks the ring (which also re-homes the dead arc's
        subscriptions — see `_rearc_subscriptions`)."""
        attempted: "set[str]" = set()
        while True:
            with self._lock:
                if not len(self._ring):
                    raise NoShardsError("all shards are dead")
                name = self._affinity_locked(key)
                client = self._shards[name].client
            if name in attempted:
                raise NoShardsError(
                    f"no shard answered {path} (tried {sorted(attempted)})"
                )
            attempted.add(name)
            self.metrics.count("cluster.sub_requests")
            try:
                if body is None:
                    return client.get(path)
                return client.post(path, dict(body))
            except ShardUnavailable:
                self._mark_dead(name)
                self.metrics.count("cluster.shard_failovers")

    # --- standing-query routes ---------------------------------------------

    def subscribe(self, body: dict) -> "tuple[int, dict]":
        """Route ``POST /v1/subscribe`` to the filter arc's owning shard
        and mirror the registration for failover re-homing."""
        self.metrics.count("cluster.subscribe_requests")
        try:
            filt = normalize_filter((body or {}).get("filter"))
        except ValueError as exc:
            return 400, {"error": str(exc)}
        key = subscription_ring_key(filt)
        send = dict(body)
        send["filter"] = filt
        status, obj = self._dispatch_affine(key, "/v1/subscribe", send)
        if status == 200 and isinstance(obj, dict) and obj.get("sub_id"):
            mirrored = dict(send)
            mirrored["sub_id"] = obj["sub_id"]
            with self._lock:
                self._standing[obj["sub_id"]] = (key, mirrored)
        return status, obj

    def unsubscribe(self, body: dict) -> "tuple[int, dict]":
        """Route ``POST /v1/unsubscribe`` via the mirror when the sub is
        known; broadcast to every live shard otherwise (a router restart
        loses the in-memory mirror, not the shards' durable registries)."""
        sub_id = str((body or {}).get("sub_id") or "")
        if not sub_id:
            return 400, {"error": "body.sub_id is required"}
        with self._lock:
            entry = self._standing.pop(sub_id, None)
        if entry is not None:
            return self._dispatch_affine(
                entry[0], "/v1/unsubscribe", {"sub_id": sub_id}
            )
        removed = False
        for name in self.alive_shards():
            with self._lock:
                state = self._shards.get(name)
                if state is None or not state.alive:
                    continue
                client = state.client
            try:
                status, obj = client.post(
                    "/v1/unsubscribe", {"sub_id": sub_id}
                )
            except ShardUnavailable:
                self._mark_dead(name)
                continue
            if status == 200 and isinstance(obj, dict) and obj.get("removed"):
                removed = True
        return 200, {"removed": removed}

    def subscriptions(self) -> "tuple[int, dict]":
        """Aggregate ``GET /v1/subscriptions`` across live shards."""
        subs: "List[dict]" = []
        per_shard: "Dict[str, int]" = {}
        for name in self.alive_shards():
            with self._lock:
                state = self._shards.get(name)
                if state is None or not state.alive:
                    continue
                client = state.client
            try:
                status, obj = client.get("/v1/subscriptions")
            except ShardUnavailable:
                self._mark_dead(name)
                continue
            if status != 200 or not isinstance(obj, dict):
                continue
            got = obj.get("subscriptions") or []
            per_shard[name] = len(got)
            subs.extend(got)
        subs.sort(key=lambda s: s.get("sub_id", ""))
        return 200, {
            "count": len(subs),
            "subscriptions": subs,
            "shards": per_shard,
        }

    def deliveries(
        self, sub_id: str, cursor: int = 0, wait_s: float = 0.0
    ) -> "tuple[int, dict]":
        """Proxy the long-poll fallback to the sub's owning shard. Falls
        back to probing every live shard when the mirror doesn't know the
        sub (router restarted; the shards' registries are the truth)."""
        qs = f"/v1/deliveries?sub={sub_id}&cursor={int(cursor)}"
        if wait_s:
            qs += f"&wait_s={float(wait_s)}"
        with self._lock:
            entry = self._standing.get(sub_id)
        if entry is not None:
            return self._dispatch_affine(entry[0], qs)
        for name in self.alive_shards():
            with self._lock:
                state = self._shards.get(name)
                if state is None or not state.alive:
                    continue
                client = state.client
            try:
                status, obj = client.get(qs)
            except ShardUnavailable:
                self._mark_dead(name)
                continue
            if status == 200:
                return status, obj
        return 404, {"error": f"no such subscription: {sub_id}"}

    # --- public request API ------------------------------------------------

    def generate(
        self,
        pair_index: int,
        timeout_s: Optional[float] = None,
        idempotency_key: Optional[str] = None,
        tenant: Optional[str] = None,
    ) -> "tuple[int, dict]":
        """Route one single-pair generate to its affine shard."""
        if not (
            isinstance(pair_index, int)
            and not isinstance(pair_index, bool)
            and 0 <= pair_index < len(self.pairs)
        ):
            return 400, {
                "error": f"pair_index must be an int in [0, {len(self.pairs)})"
            }
        self.metrics.count("cluster.requests")
        body: dict = {"pair_index": pair_index}
        if timeout_s is not None:
            body["timeout_s"] = timeout_s
        if idempotency_key is not None:
            body["idempotency_key"] = idempotency_key
        if tenant is not None:
            body["tenant"] = tenant
        with root_span("cluster.generate", {"pair_index": pair_index}):
            return self._dispatch(self._keys[pair_index], "/v1/generate", body)

    def verify(self, body: dict) -> "tuple[int, dict]":
        """Route one verify. Verification has no data affinity (the bundle
        travels with the request), so the key is the bundle digest — it
        spreads uniformly and repeats of the same bundle reuse a shard's
        verify-side caches."""
        self.metrics.count("cluster.requests")
        bundle_obj = body.get("bundle", body)
        key = hashlib.sha256(
            json.dumps(bundle_obj, sort_keys=True).encode()
        ).hexdigest()
        with root_span("cluster.verify"):
            return self._dispatch(key, "/v1/verify", dict(body))

    def generate_range(
        self,
        pair_indexes: Sequence[int],
        chunk_size: Optional[int] = None,
        timeout_s: Optional[float] = None,
        aggregate: bool = False,
        tenant: Optional[str] = None,
        writer_factory=None,
    ) -> "Optional[tuple[int, dict]]":
        """Scatter a multi-pair range across shards, gather one canonical
        bundle (byte-identical to a single-daemon run over the same list).

        Sub-bundles fold into a `cluster.gather.BundleFold` AS EACH SHARD
        ANSWERS — one CID map, one sort at seal (``witness.merge_sorts``)
        — instead of buffering every response and re-sorting per arrival.
        With ``aggregate=True`` the index list may repeat (K co-tipset
        claims); the scatter covers the distinct pairs once and the
        response carries the witness-plane ``claims`` span table.

        With ``writer_factory`` (the streamed door) the fold never
        buffers a sealed response: the factory is called once, after
        validation and partition — the HTTP handler commits its 200 +
        chunked headers there and hands back a `BundleStreamWriter` —
        then every shard sub-bundle's blocks go out as ``B`` chunks the
        moment that shard answers; the trailer carries the merged proof
        sections and the sealed digest. Returns None once streaming has
        begun (errors after that point travel as in-band ``E`` chunks);
        pre-stream failures still return ``(status, obj)``.
        """
        n = len(self.pairs)
        idxs = list(pair_indexes)
        if not idxs or not all(
            isinstance(i, int) and not isinstance(i, bool) and 0 <= i < n
            for i in idxs
        ):
            return 400, {
                "error": f"pair_indexes must be non-empty ints in [0, {n})"
            }
        claim_idxs = idxs
        if aggregate:
            idxs = list(dict.fromkeys(idxs))
        self.metrics.count("cluster.requests")
        self.metrics.count("cluster.scatter_requests")
        with root_span(
            "cluster.generate_range", {"n_pairs": len(idxs)}
        ) as sp:
            with self._lock:
                if not len(self._ring):
                    raise NoShardsError("all shards are dead")
                assign = {
                    idx: self._affinity_locked(self._keys[idx]) for idx in idxs
                }
            groups = partition_indexes(idxs, assign)
            sp.set_attr("n_groups", len(groups))
            ctx = current_context()  # scatter threads parent under this span
            scope = current_scope()  # deadline/cancel hops with the scatter
            if writer_factory is not None and self.cut_through:
                # cut-through relay: shard B chunks forward the moment
                # they arrive — the router never holds a shard's whole
                # JSON sub-response in memory
                return self._scatter_cut_through(
                    groups,
                    idxs,
                    claim_idxs,
                    aggregate,
                    chunk_size,
                    timeout_s,
                    tenant,
                    writer_factory,
                    sp,
                    ctx,
                )

            def one(group: "List[int]") -> "tuple[int, dict]":
                body: dict = {"pair_indexes": group}
                if chunk_size is not None:
                    body["chunk_size"] = chunk_size
                if timeout_s is not None:
                    body["timeout_s"] = timeout_s
                if tenant is not None:
                    body["tenant"] = tenant
                # group affinity = first member's key: the whole group was
                # binned by that shard's arc, and failover re-keys anyway
                with use_context(ctx), use_scope(scope):
                    return self._dispatch(
                        self._keys[group[0]], "/v1/generate_range", body
                    )

            futures = {
                self._executor.submit(one, group): name
                for name, group in groups.items()
            }
            writer = None
            if writer_factory is not None:
                # commit the streamed response now: validation and
                # placement are done, so everything past this point is
                # in-band (a shard failure becomes an E chunk)
                writer = writer_factory()
                writer.begin(
                    {
                        "witness_encoding": "identity",
                        "n_pairs": len(idxs),
                        "n_groups": len(groups),
                        "trace_id": sp.trace_id,
                    }
                )
            fold = BundleFold(self.pairs, idxs, metrics=self.metrics)
            try:
                for fut in as_completed(futures):
                    name = futures[fut]
                    status, obj = fut.result()  # NoShardsError propagates
                    if status != 200:
                        # a shard's error verdict is the scatter's verdict
                        # — partial bundles are never silently merged
                        if writer is None:
                            return status, obj
                        writer.error(
                            str(obj.get("error", f"shard group {name} failed")),
                            str(obj.get("error_type", "shard_error")),
                        )
                        return None
                    payload = (
                        obj.get("result", obj) if obj.get("ok", True) else obj
                    )
                    if "bundle" not in payload:
                        if writer is None:
                            return 502, {
                                "error": f"shard group {name} returned no bundle",
                                "shard_response": obj,
                            }
                        writer.error(
                            f"shard group {name} returned no bundle",
                            "shard_error",
                        )
                        return None
                    sub = UnifiedProofBundle.from_json_obj(payload["bundle"])
                    fresh = fold.fold(sub)
                    if writer is not None:
                        # blocks leave NOW, in arrival order, and only on
                        # first sight — a block several shards shipped
                        # crosses the client wire once; the decoder
                        # restores canonical order (the merge law), so no
                        # sealed bundle is ever buffered
                        for b in fresh:
                            writer.block(b.cid.to_bytes(), b.data)
                        if len(fresh) != len(sub.blocks):
                            self.metrics.count(
                                "cluster.stream_blocks_deduped",
                                len(sub.blocks) - len(fresh),
                            )
            except Exception as exc:
                if writer is None:
                    raise
                writer.error(str(exc), _abort_type(exc))
                return None
            merged = fold.seal()
            claims = None
            if aggregate:
                from ipc_proofs_tpu_torch.witness import aggregate_range_bundle

                claims = aggregate_range_bundle(
                    merged,
                    self.pairs,
                    idxs,
                    claim_indexes=claim_idxs,
                    metrics=self.metrics,
                ).claims_json()
            if writer is not None:
                tail = {
                    "storage_proofs": [
                        p.to_json_obj() for p in merged.storage_proofs
                    ],
                    "event_proofs": [
                        p.to_json_obj() for p in merged.event_proofs
                    ],
                    "digest": merged.digest(),
                    "n_event_proofs": len(merged.event_proofs),
                }
                if claims is not None:
                    tail["claims"] = claims
                writer.end(tail)
                return None
            out = {
                "bundle": merged.to_json_obj(),
                "n_event_proofs": len(merged.event_proofs),
                "n_pairs": len(idxs),
                "n_groups": len(groups),
                "trace_id": sp.trace_id,
            }
            if claims is not None:
                out["claims"] = claims
            return 200, out

    # --- cut-through streamed scatter ---------------------------------------

    def _relay_stream(self, resp, fold, writer, relay_lock, aborted) -> None:
        """Relay ONE shard's IPBS stream chunk-by-chunk: each ``B`` chunk
        folds (first-sight dedup) and forwards under ``relay_lock`` the
        moment it arrives; the ``T`` chunk folds the shard's proof
        sections and ENDS the relay without waiting for stream EOF (so a
        connection death after the trailer can never re-fold proofs on a
        failover retry). Transport faults and truncation surface as
        `ShardUnavailable` (→ failover, same idempotency key — the fold's
        dedup absorbs re-sent blocks); an in-band ``E`` chunk is the
        authoritative answer of a LIVE shard and raises `StreamAbortError`
        (→ typed abort, never failover)."""
        try:
            for kind, payload in iter_stream_chunks(resp):
                if aborted.is_set():
                    return
                if kind == CHUNK_BLOCK:
                    cid_raw, data = parse_block_chunk(payload)
                    with relay_lock:
                        if aborted.is_set():
                            return
                        if fold.fold_block(cid_raw, data):
                            writer.block(bytes(cid_raw), data)
                        else:
                            self.metrics.count("cluster.stream_blocks_deduped")
                elif kind == CHUNK_TRAILER:
                    tail = json.loads(payload)
                    sub = UnifiedProofBundle.from_json_obj(
                        {
                            "storage_proofs": tail.get("storage_proofs") or [],
                            "event_proofs": tail.get("event_proofs") or [],
                            "blocks": [],
                        }
                    )
                    with relay_lock:
                        if not aborted.is_set():
                            fold.fold(sub)
                    return
                elif kind == CHUNK_ERROR:
                    try:
                        err = json.loads(payload)
                    except ValueError:
                        err = {}
                    raise StreamAbortError(
                        str(err.get("error", "shard aborted its stream")),
                        str(err.get("error_type", "internal")),
                    )
            raise ShardUnavailable("shard stream ended without a trailer")
        except (ConnectionError, TimeoutError, OSError) as exc:
            raise ShardUnavailable(f"shard stream failed mid-relay: {exc}") from exc
        except http.client.HTTPException as exc:
            # chunked-transfer truncation (IncompleteRead): the shard died
            # with chunks in flight
            raise ShardUnavailable(f"shard stream failed mid-relay: {exc}") from exc
        except WitnessIntegrityError as exc:
            raise ShardUnavailable(f"shard stream truncated: {exc}") from exc

    def _scatter_cut_through(
        self,
        groups: "Dict[str, List[int]]",
        idxs: "List[int]",
        claim_idxs: "List[int]",
        aggregate: bool,
        chunk_size: Optional[int],
        timeout_s: Optional[float],
        tenant: Optional[str],
        writer_factory,
        sp,
        ctx,
    ) -> None:
        """The streamed scatter, cut-through flavor: sub-requests ask the
        shards for THEIR streamed form (`ShardClient.post_stream`) and
        relay blocks as they arrive instead of buffering per-shard JSON
        sub-responses. Peak router memory per scatter drops from
        O(largest sub-response) to O(one chunk) per shard; byte identity
        is unchanged because the same `BundleFold` merge law runs, one
        block at a time. Always returns None — the writer is committed
        before any sub-request, so failures travel as in-band E chunks."""
        writer = writer_factory()
        writer.begin(
            {
                "witness_encoding": "identity",
                "n_pairs": len(idxs),
                "n_groups": len(groups),
                "trace_id": sp.trace_id,
            }
        )
        fold = BundleFold(self.pairs, idxs, metrics=self.metrics)
        # serializes fold mutation + writer chunk emission across the
        # scatter's relay threads (the writer's socket is one wire)
        relay_lock = named_lock("ClusterRouter._relay_lock")
        aborted = threading.Event()
        scope = current_scope()  # deadline/cancel hops with the relay threads

        def one_stream(group: "List[int]") -> "tuple[int, Optional[dict]]":
            body: dict = {"pair_indexes": group}
            if chunk_size is not None:
                body["chunk_size"] = chunk_size
            if timeout_s is not None:
                body["timeout_s"] = timeout_s
            if tenant is not None:
                body["tenant"] = tenant
            # failover retries reuse this key (at-least-once + dedup)
            body["idempotency_key"] = uuid.uuid4().hex
            key = self._keys[group[0]]
            attempted: "set[str]" = set()
            with use_context(ctx), use_scope(scope):
                carrier = carrier_from_context()
                if carrier is not None:
                    body["trace"] = carrier
                while True:
                    # re-read the budget each attempt: failovers burn it
                    self._stamp_deadline(body, "/v1/generate_range")
                    name, client = self._acquire(key)
                    if name in attempted:
                        self._release(name)
                        raise NoShardsError(
                            "no shard answered /v1/generate_range "
                            f"(tried {sorted(attempted)})"
                        )
                    attempted.add(name)
                    self.metrics.count("cluster.sub_requests")
                    t0 = time.monotonic()
                    try:
                        with span(
                            "cluster.dispatch",
                            {"shard": name, "path": "/v1/generate_range"},
                        ):
                            kind, payload = client.post_stream(
                                "/v1/generate_range", dict(body)
                            )
                            if kind == "json":
                                # buffered fallback: a shard that didn't
                                # stream still folds + forwards (its error
                                # verdict stays authoritative)
                                status, obj = payload
                                if isinstance(obj, dict):
                                    self._graft_shard_spans(name, obj)
                                if status != 200:
                                    return status, obj
                                pl = (
                                    obj.get("result", obj)
                                    if obj.get("ok", True)
                                    else obj
                                )
                                if "bundle" not in pl:
                                    return 502, {
                                        "error": (
                                            f"shard group {name} "
                                            "returned no bundle"
                                        ),
                                        "shard_response": obj,
                                    }
                                sub = UnifiedProofBundle.from_json_obj(
                                    pl["bundle"]
                                )
                                with relay_lock:
                                    if not aborted.is_set():
                                        fresh = fold.fold(sub)
                                        for b in fresh:
                                            writer.block(
                                                b.cid.to_bytes(), b.data
                                            )
                                        if len(fresh) != len(sub.blocks):
                                            self.metrics.count(
                                                "cluster.stream_blocks_deduped",
                                                len(sub.blocks) - len(fresh),
                                            )
                            else:
                                resp = payload
                                try:
                                    self._relay_stream(
                                        resp, fold, writer,
                                        relay_lock, aborted,
                                    )
                                finally:
                                    try:
                                        resp.close()
                                    except OSError:
                                        pass
                                self.metrics.count("cluster.stream_cut_through")
                        self._note_latency(name, time.monotonic() - t0)
                        return 200, None
                    except ShardUnavailable:
                        self._mark_dead(name)
                        self.metrics.count("cluster.shard_failovers")
                    finally:
                        self._release(name)

        futures = {
            self._executor.submit(one_stream, group): name
            for name, group in groups.items()
        }
        failure = None
        # drain EVERY future before touching the writer from this thread:
        # lagging relays write chunks until they observe the abort flag,
        # and the terminator must be the last thing on the wire
        for fut in as_completed(futures):
            name = futures[fut]
            try:
                status, obj = fut.result()
            except Exception as exc:  # fail-soft: first failure becomes the typed in-band E chunk below; later ones lose the race but every relay still drains
                if failure is None:
                    failure = exc
                    aborted.set()
                continue
            if status != 200 and failure is None:
                failure = (status, obj, name)
                aborted.set()
        if failure is not None:
            with relay_lock:
                if isinstance(failure, StreamAbortError):
                    writer.error(str(failure), failure.remote_error_type)
                elif isinstance(failure, tuple):
                    _status, obj, name = failure
                    writer.error(
                        str(obj.get("error", f"shard group {name} failed")),
                        str(obj.get("error_type", "shard_error")),
                    )
                else:
                    writer.error(str(failure), _abort_type(failure))
            return None
        merged = fold.seal()
        claims = None
        if aggregate:
            from ipc_proofs_tpu_torch.witness import aggregate_range_bundle

            claims = aggregate_range_bundle(
                merged,
                self.pairs,
                idxs,
                claim_indexes=claim_idxs,
                metrics=self.metrics,
            ).claims_json()
        tail = {
            "storage_proofs": [p.to_json_obj() for p in merged.storage_proofs],
            "event_proofs": [p.to_json_obj() for p in merged.event_proofs],
            "digest": merged.digest(),
            "n_event_proofs": len(merged.event_proofs),
        }
        if claims is not None:
            tail["claims"] = claims
        writer.end(tail)
        return None

    # --- bulk backfill ------------------------------------------------------

    def _backfill_engine(self):
        """The router's `BackfillEngine`, built lazily on first use:
        windows are planned onto the arcs of the shards alive NOW and
        executed at shard-count parallelism through the same steal-aware,
        at-least-once dispatch every interactive request uses."""
        from ipc_proofs_tpu_torch.backfill import BackfillEngine

        with self._lock:
            if self._backfill is None:
                nodes = [
                    name
                    for name, s in self._shards.items()
                    if s.alive
                ] or sorted(self._shards)
                self._backfill = BackfillEngine(
                    self.pairs,
                    self._backfill_spec,
                    self._run_backfill_window,
                    jobs_dir=self._backfill_jobs_dir,
                    window_size=self._backfill_window_size,
                    window_parallelism=(
                        self._backfill_parallelism or max(1, len(nodes))
                    ),
                    nodes=nodes,
                    metrics=self.metrics,
                )
            return self._backfill

    def _run_backfill_window(self, window, pairs):
        """Window runner: one `/v1/generate_range` sub-request to the
        window's arc shard (work stealing and failover come free from
        `_dispatch`; the stable idempotency key lets a durable shard
        dedup a failover replay). A shard's ``error_type: device`` answer
        raises `DeviceFaultError`, which ends the job ``faulted``."""
        del pairs  # shards hold the pair table; the wire speaks indexes
        self.metrics.count("cluster.sub_requests")
        body = {
            "pair_indexes": list(range(window.lo, window.hi)),
            "idempotency_key": f"backfill-{window.lo}-{window.hi}",
        }
        status, obj = self._dispatch(
            self._keys[window.lo], "/v1/generate_range", body
        )
        if status != 200:
            message = (
                f"backfill window {window.index} failed with {status}: "
                f"{obj.get('error', obj)}"
            )
            if obj.get("error_type") == "device":
                raise DeviceFaultError(message)
            raise ShardUnavailable(message)
        payload = obj.get("result", obj) if obj.get("ok", True) else obj
        if "bundle" not in payload:
            raise ShardUnavailable(
                f"backfill window {window.index}: shard returned no bundle"
            )
        return UnifiedProofBundle.from_json_obj(payload["bundle"])

    def backfill_submit(self, body: dict) -> "tuple[int, dict]":
        """``POST /v1/backfill`` (router door): same contract as the
        single-daemon handler — rows ``[pair_start, pair_end)`` of the
        shared pair table, idempotent by journal manifest."""
        n = len(self.pairs)
        start, end = body.get("pair_start"), body.get("pair_end")

        def _row(v) -> bool:
            return isinstance(v, int) and not isinstance(v, bool)

        if not (_row(start) and _row(end) and 0 <= start < end <= n):
            return 400, {
                "error": "pair_start/pair_end must be ints with "
                f"0 <= start < end <= {n} (cluster pair table)"
            }
        wsize = body.get("window_size")
        if wsize is not None and (not _row(wsize) or wsize < 1):
            return 400, {"error": "window_size must be a positive int"}
        sub_id = body.get("sub_id")
        if sub_id is not None and not isinstance(sub_id, str):
            return 400, {"error": "sub_id must be a string"}
        try:
            job = self._backfill_engine().submit(
                start, end, window_size=wsize, sub_id=sub_id
            )
        except (ValueError, RuntimeError) as exc:
            return 400, {"error": str(exc)}
        return 200, job.status()

    def _backfill_job(self, job_id: str):
        with self._lock:
            engine = self._backfill
        return engine.job(job_id) if engine is not None else None

    def backfill_status(self, job_id: str) -> "tuple[int, dict]":
        """A job's status; a job the card's fault stopped (``faulted``)
        answers 500 ``error_type: device``, as a daemon's door does."""
        job = self._backfill_job(job_id)
        if job is None:
            return 404, {"error": f"no such backfill job: {job_id}"}
        status = job.status()
        if status.get("error_type") == "device":
            return 500, {"error": status["error"], "error_type": "device"}
        return 200, status

    def _backfill_poll(self, job_id: str, cursor: int, wait_s: float):
        """(job, its chunks after ``cursor``), or (None, None) for an
        unknown job."""
        job = self._backfill_job(job_id)
        if job is None:
            return None, None
        return job, job.chunks_after(cursor, wait_s=wait_s)

    def backfill_chunks(
        self, job_id: str, cursor: int, wait_s: float = 0.0
    ) -> "tuple[int, dict]":
        job, out = self._backfill_poll(job_id, cursor, wait_s)
        if job is None:
            return 404, {"error": f"no such backfill job: {job_id}"}
        if job.fault is not None:
            return 500, {"error": str(job.fault), "error_type": "device"}
        return 200, out

    def backfill_jobs(self) -> "tuple[int, dict]":
        with self._lock:
            engine = self._backfill
        return 200, {"jobs": engine.jobs() if engine is not None else []}

    # --- cluster health / metrics -----------------------------------------

    def healthz(self) -> "tuple[int, dict]":
        """Aggregate shard health: ``ok`` iff every live shard says ok,
        ``degraded`` when any shard is dead or degraded but at least one
        serves, 503 ``unavailable`` when none do."""
        with self._lock:
            states = {n: s.alive for n, s in self._shards.items()}
            clients = {n: s.client for n, s in self._shards.items()}
        shard_health: "Dict[str, dict]" = {}
        n_ok = 0
        for name, alive in states.items():
            if not alive:
                shard_health[name] = {"status": "dead"}
                continue
            try:
                _status, obj = clients[name].get("/healthz")
            except ShardUnavailable:
                self._mark_dead(name)
                shard_health[name] = {"status": "dead"}
                continue
            shard_health[name] = obj
            if obj.get("status") == "ok":
                n_ok += 1
        serving = sum(
            1
            for h in shard_health.values()
            if h.get("status") not in ("dead", "draining")
        )
        if serving == 0:
            out: dict = {"status": "unavailable", "shards": shard_health}
            if self.slo is not None:
                out["slo"] = self.slo.status()
            return 503, out
        status = "ok" if n_ok == len(shard_health) else "degraded"
        out = {
            "status": status,
            "shards": shard_health,
            "shards_alive": serving,
        }
        # degraded serve mode is worth naming explicitly: these shards have
        # EVERY upstream breaker open and serve warm-tier traffic only
        lotus_down = sorted(
            name
            for name, h in shard_health.items()
            if h.get("mode") == "lotus_down"
        )
        if lotus_down:
            out["lotus_down"] = lotus_down
        if self.slo is not None:
            out["slo"] = self.slo.status()
        return 200, out

    def metrics_snapshot(self) -> dict:
        return self.metrics.snapshot()

    # --- fleet observability plane ----------------------------------------

    def fleet_prom(self) -> str:
        """One Prometheus exposition for the whole fleet: every shard's
        counters/gauges/histograms labelled ``shard="s<k>"``, the router's
        own labelled ``shard="router"``, plus ``shard="fleet"`` aggregates
        (counter sums, merged histograms). Dead shards simply drop out of
        the exposition — scraping keeps working while degraded."""
        latest = self.federation.latest(max_age_s=2.0 * self.federation.interval_s)
        shard_snaps = {
            name: entry.get("metrics")
            for name, entry in latest.get("shards", {}).items()
        }
        return render_fleet_prometheus(
            shard_snaps, router_snap=self.metrics.snapshot()
        )

    def cluster_status(self) -> "tuple[int, dict]":
        """The live cluster view: ring topology joined with each shard's
        scraped health/queue depths, follower finalization progress,
        delivery backlog, and store-tier bytes — one JSON document."""
        latest = self.federation.latest(max_age_s=2.0 * self.federation.interval_s)
        with self._lock:
            ring = {
                name: {
                    "alive": state.alive,
                    "inflight": state.inflight,
                    "url": state.client.base_url,
                }
                for name, state in self._shards.items()
            }
        shards: "Dict[str, dict]" = {}
        max_epoch: Optional[int] = None
        backlog = 0
        disk_bytes = 0
        registry_heads: "Dict[str, dict]" = {}
        registry_degraded = 0
        for name, entry in latest.get("shards", {}).items():
            health = entry.get("healthz") or {}
            snap = entry.get("metrics") or {}
            gauges = snap.get("gauges") or {}
            depths = {
                key[len("serve.queue_depth.") :]: val
                for key, val in gauges.items()
                if key.startswith("serve.queue_depth.")
            }
            epoch = health.get("last_finalized_epoch")
            pending = health.get("pending_deliveries")
            shard_disk = gauges.get("storex.disk_bytes")
            shards[name] = {
                "status": health.get("status")
                or ("unreachable" if entry.get("error") else "unknown"),
                # "lotus_down" when the shard serves degraded (all its
                # upstream breakers open, warm-tier-only); None otherwise
                "mode": health.get("mode"),
                "scrape_error": entry.get("error"),
                "queue_depth": depths,
                "pending_deliveries": pending,
                "last_finalized_epoch": epoch,
                "disk_bytes": shard_disk,
                "registry": health.get("registry"),
            }
            head = health.get("registry_head")
            if isinstance(head, dict):
                registry_heads[name] = head
                if health.get("registry") == "degraded":
                    registry_degraded += 1
            if isinstance(epoch, int):
                max_epoch = epoch if max_epoch is None else max(max_epoch, epoch)
            if isinstance(pending, (int, float)):
                backlog += int(pending)
            if isinstance(shard_disk, (int, float)):
                disk_bytes += int(shard_disk)
        counters = self.metrics.snapshot().get("counters", {})
        out: dict = {
            "captured_at": latest.get("captured_at"),
            "ring": ring,
            "shards": shards,
            "router": {
                "requests": counters.get("cluster.requests", 0),
                "steals": counters.get("cluster.steals", 0),
                "slow_quarantines": counters.get("cluster.slow_quarantines", 0),
                "deadline_rejects": counters.get("deadline.rejects.router", 0),
                "shard_failovers": counters.get("cluster.shard_failovers", 0),
                "scrape_errors": counters.get("fleet.scrape_errors", 0),
            },
            "last_finalized_epoch": max_epoch,
            "delivery_backlog": backlog,
            "store_disk_bytes": disk_bytes,
        }
        with self._lock:
            replication_last = self._replication_last
        out["replication"] = {
            "factor": self.replication_factor,
            "last_pass": replication_last,
        }
        if registry_heads:
            # per-shard provenance checkpoints: each shard's chain is
            # independent, so the fleet head is the set of (size, root)
            # checkpoints — an auditor pins each and asks any shard for
            # consistency proofs against its own pin
            out["registry"] = {
                "heads": registry_heads,
                "total_records": sum(
                    int(h.get("size") or 0) for h in registry_heads.values()
                ),
                "degraded_shards": registry_degraded,
            }
        if self.slo is not None:
            out["slo"] = self.slo.status()
        return 200, out

    def registry_query(self, sub_path: str, qs: dict) -> "tuple[int, dict]":
        """Fleet audit surface over the per-shard provenance chains.

        ``head`` with no ``?shard=`` aggregates every live shard's
        checkpoint (each chain is independent — the fleet head is the set
        of per-shard (size, root) pins). ``entry`` / ``proof`` /
        ``consistency`` (and ``head?shard=``) proxy to the named shard:
        proofs only verify against the chain that sealed the record.
        ``base`` (the fleet delta-base directory) needs no shard — the
        registry dir is shared, so any live shard answers for the fleet."""
        shard = (qs.get("shard") or [""])[0]
        with self._lock:
            clients = {
                name: st.client for name, st in self._shards.items() if st.alive
            }
        if sub_path == "head" and not shard:
            heads: dict = {}
            errors: dict = {}
            for name, client in sorted(clients.items()):
                try:
                    status, obj = client.get("/v1/registry/head")
                except ShardUnavailable as exc:
                    errors[name] = str(exc)
                    continue
                if status == 200:
                    heads[name] = obj
                else:
                    errors[name] = obj.get("error", f"status {status}")
            return 200, {
                "heads": heads,
                "errors": errors,
                "total_records": sum(
                    int(h.get("size") or 0) for h in heads.values()
                ),
                "degraded_shards": sum(
                    1 for h in heads.values() if h.get("degraded")
                ),
            }
        if sub_path not in ("head", "entry", "proof", "consistency", "base"):
            return 404, {"error": f"no such registry path: {sub_path}"}
        if not shard and sub_path == "base" and clients:
            shard = sorted(clients)[0]  # shared dir: any live shard answers
        if not shard:
            return 400, {"error": f"registry/{sub_path} requires ?shard=<name>"}
        client = clients.get(shard)
        if client is None:
            return 404, {"error": f"unknown or dead shard: {shard}"}
        pairs = [
            (k, v)
            for k, vals in qs.items()
            if k != "shard"
            for v in vals
        ]
        tail = ("?" + urlencode(pairs)) if pairs else ""
        try:
            return client.get(f"/v1/registry/{sub_path}{tail}")
        except ShardUnavailable as exc:
            return 503, {"error": f"shard {shard} unreachable: {exc}"}

    def flight(self) -> dict:
        """Aggregate the fleet's flight rings (shards' ``/debug/flight``
        plus the router's own) into one shard-labelled, newest-first
        snapshot. Unreachable shards land in ``failed`` — fail-soft."""
        shard_flights: "Dict[str, Optional[dict]]" = {}
        for name, url in sorted(self._alive_shard_urls().items()):
            probe = ShardClient(name, url, timeout_s=self.federation.timeout_s)
            try:
                status, obj = probe.get("/debug/flight")
                shard_flights[name] = obj if status == 200 else None
            except ShardUnavailable:
                shard_flights[name] = None
        return merge_flight_snapshots(
            shard_flights, local_snap=get_flight_recorder().snapshot()
        )

    def close(self) -> None:
        self.federation.stop()
        if self.slo is not None:
            self.slo.stop()
        with self._lock:
            backfill = self._backfill
        if backfill is not None:
            # first: running windows hold shard dispatches in flight and
            # must wind down while shard clients are still usable
            backfill.close()
        self._executor.shutdown(wait=True)


class _RouterHandler(BaseHTTPRequestHandler):
    router: ClusterRouter

    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # silence per-request stderr noise
        pass

    def _send_json(self, status: int, obj: dict, headers=None):
        body = json.dumps(obj).encode("utf-8")
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)
        # response bytes charge the tenant at send time, mirroring the
        # single-daemon door — tenant.bytes.* is what crossed the wire
        if getattr(self, "_account_response", False):
            self.router.tenants.account_bytes(self._tenant, len(body))

    # --- streamed responses (application/x-ipc-bundle-stream) -------------

    def _start_stream(self) -> None:
        self.send_response(200)
        self.send_header("Content-Type", STREAM_CONTENT_TYPE)
        self.send_header("Transfer-Encoding", "chunked")
        self.send_header("Witness-Encoding", "identity")
        self.end_headers()
        self.wfile.flush()

    def _finish_stream(self, writer) -> None:
        try:
            self.connection.sendall(CHUNKED_TERMINATOR)
        except OSError:
            pass
        self.router.metrics.count("serve.stream.responses")
        if getattr(self, "_account_response", False):
            self.router.tenants.account_bytes(self._tenant, writer.bytes_sent)
        # one stream per connection: don't risk framing drift poisoning a
        # keep-alive successor request
        self.close_connection = True

    def _stream_generate_range(self, body: dict) -> None:
        """Streamed scatter-gather: the router commits its 200 the moment
        placement succeeds (the writer factory below), then re-emits each
        shard's blocks as that shard answers — no sealed bundle is ever
        buffered router-side. Pre-stream failures (validation, all shards
        dead) still map to plain JSON statuses."""
        made: dict = {}

        def factory():
            self._start_stream()
            made["w"] = BundleStreamWriter(
                self._send_buffers, metrics=self.router.metrics
            )
            return made["w"]

        try:
            out = self.router.generate_range(
                body.get("pair_indexes") or [],
                chunk_size=body.get("chunk_size"),
                timeout_s=body.get("timeout_s"),
                aggregate=body.get("aggregate", False) is True,
                tenant=body.get("tenant"),
                writer_factory=factory,
            )
        except NoShardsError as exc:
            if "w" not in made:
                self._send_json(503, {"error": str(exc)})
                return
            out = None
        if out is not None:
            status, obj = out
            self._send_json(status, obj)
            return
        self._finish_stream(made["w"])

    def _send_buffers(self, buffers) -> None:
        send_buffers(self.connection, buffers)

    def _stream_backfill_chunks(self, out: dict, fault) -> None:
        """Multi-document IPBS stream of one poll: no segment tier at the
        router, so block payloads re-emit as copied bytes. A job the
        card's fault stopped ends in the ``device`` abort chunk in place
        of the envelope."""
        self._start_stream()
        writer = BundleStreamWriter(
            self._send_buffers, metrics=self.router.metrics
        )
        try:
            stream_backfill_chunks(writer, out, envelope=fault is None)
            if fault is not None:
                writer.error(str(fault), "device")
        except Exception as exc:  # fail-soft: headers are already on the wire — the only sound exit is an in-band typed abort chunk, never a half-document
            writer.error(str(exc), "internal")
        self._finish_stream(writer)

    def _send_text(self, status: int, text: str, content_type: str):
        body = text.encode("utf-8")
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        parts = urlsplit(self.path)
        if parts.path == "/healthz":
            status, obj = self.router.healthz()
            self._send_json(status, obj)
        elif parts.path in ("/metrics", "/metrics.json"):
            self._send_json(200, self.router.metrics_snapshot())
        elif parts.path == "/metrics.prom":
            self._send_text(200, self.router.fleet_prom(), _PROM_CONTENT_TYPE)
        elif parts.path == "/v1/cluster/status":
            status, obj = self.router.cluster_status()
            self._send_json(status, obj)
        elif parts.path == "/debug/flight":
            self._send_json(200, self.router.flight())
        elif parts.path == "/v1/subscriptions":
            status, obj = self.router.subscriptions()
            self._send_json(status, obj)
        elif parts.path == "/v1/backfill":
            status, obj = self.router.backfill_jobs()
            self._send_json(status, obj)
        elif parts.path.startswith("/v1/backfill/"):
            rest = parts.path[len("/v1/backfill/") :]
            job_id, _, tail = rest.partition("/")
            if tail == "":
                status, obj = self.router.backfill_status(job_id)
            elif tail == "chunks":
                try:
                    qs = parse_qs(parts.query)
                    cursor = int((qs.get("cursor") or ["0"])[0])
                    wait_s = min(30.0, float((qs.get("wait_s") or ["0"])[0]))
                except ValueError as exc:
                    self._send_json(400, {"error": f"bad query: {exc}"})
                    return
                if negotiate_stream({}, headers=self.headers):
                    job, out = self.router._backfill_poll(job_id, cursor, wait_s)
                    if job is not None:
                        self._stream_backfill_chunks(out, job.fault)
                        return
                    status, obj = 404, {"error": f"no such backfill job: {job_id}"}
                else:
                    status, obj = self.router.backfill_chunks(
                        job_id, cursor=cursor, wait_s=wait_s
                    )
            else:
                status, obj = 404, {"error": f"no such path: {self.path}"}
            self._send_json(status, obj)
        elif parts.path == "/v1/deliveries":
            try:
                qs = parse_qs(parts.query)
                sub_id = (qs.get("sub") or [""])[0]
                if not sub_id:
                    raise ValueError("query param 'sub' is required")
                cursor = int((qs.get("cursor") or ["0"])[0])
                wait_s = min(30.0, float((qs.get("wait_s") or ["0"])[0]))
            except ValueError as exc:
                self._send_json(400, {"error": f"bad query: {exc}"})
                return
            try:
                status, obj = self.router.deliveries(
                    sub_id, cursor=cursor, wait_s=wait_s
                )
            except NoShardsError as exc:
                status, obj = 503, {"error": str(exc)}
            self._send_json(status, obj)
        elif parts.path.startswith("/v1/registry/"):
            sub_path = parts.path[len("/v1/registry/") :]
            status, obj = self.router.registry_query(
                sub_path, parse_qs(parts.query)
            )
            self._send_json(status, obj)
        else:
            self._send_json(404, {"error": f"no such path: {self.path}"})

    def do_POST(self):
        try:
            length = int(self.headers.get("Content-Length", 0))
            if length <= 0 or length > 64 * 1024 * 1024:
                raise ValueError("Content-Length required")
            body = json.loads(self.rfile.read(length))
            if not isinstance(body, dict):
                raise ValueError("request body must be a JSON object")
        except (ValueError, json.JSONDecodeError) as exc:
            self._send_json(400, {"error": f"bad request body: {exc}"})
            return
        self._account_response = False
        self._scope = None  # CancelScope carrying this request's deadline
        if self.path in ("/v1/generate", "/v1/verify", "/v1/generate_range"):
            # Per-tenant accounting at the front door, and the (sanitized)
            # tenant rides the forwarded body so shards account it too.
            tenant = extract_tenant(body, self.headers)
            self._tenant = tenant
            self._account_response = True
            self.router.tenants.account(tenant, nbytes=length)
            if tenant is not None:
                body["tenant"] = tenant
            # QoS throttles at the cluster door, before any scatter work
            if self.router.qos is not None:
                try:
                    self.router.qos.admit(tenant)
                except TenantThrottledError as exc:
                    self._send_json(
                        429,
                        {
                            "error": str(exc),
                            "error_type": "tenant_throttled",
                            "retry_after_s": exc.retry_after_s,
                        },
                        headers={
                            "Retry-After": f"{max(1, round(exc.retry_after_s))}"
                        },
                    )
                    return
            # deadline propagation at the cluster door: same contract as
            # the single-daemon door (body deadline_ms wins over the
            # X-IPC-Deadline-Ms header; both mean budget REMAINING)
            raw = body.get("deadline_ms", None)
            if raw is None:
                raw = self.headers.get("X-IPC-Deadline-Ms")
            if raw is not None:
                try:
                    ms = float(raw)
                except (TypeError, ValueError):
                    self._send_json(
                        400,
                        {"error": "deadline_ms must be a number of milliseconds"},
                    )
                    return
                deadline = Deadline.from_ms(max(0.0, ms))
                if deadline.remaining_ms() <= self.router.deadline_floor_ms:
                    self.router.metrics.count("serve.deadline_rejects")
                    self.router.metrics.count("deadline.rejects.router")
                    self._send_json(
                        504,
                        {
                            "error": f"deadline budget {ms:.0f}ms at/below "
                            f"the router floor "
                            f"({self.router.deadline_floor_ms:.0f}ms)",
                            "error_type": "deadline",
                        },
                    )
                    return
                self._scope = CancelScope(deadline)
        if self.path == "/v1/generate_range":
            try:
                stream = negotiate_stream(body, headers=self.headers)
            except WitnessEncodingError as exc:
                self._send_json(
                    400,
                    {"error": str(exc), "error_type": "witness_encoding"},
                )
                return
            if stream:
                try:
                    with use_scope(self._scope):
                        self._stream_generate_range(body)
                except NoShardsError as exc:
                    self._send_json(503, {"error": str(exc)})
                except DeadlineError as exc:
                    self._send_json(
                        504, {"error": str(exc), "error_type": exc.error_type}
                    )
                return
        try:
            with use_scope(self._scope):
                if self.path == "/v1/generate":
                    status, obj = self.router.generate(
                        body.get("pair_index"),
                        timeout_s=body.get("timeout_s"),
                        idempotency_key=body.get("idempotency_key"),
                        tenant=body.get("tenant"),
                    )
                elif self.path == "/v1/verify":
                    status, obj = self.router.verify(body)
                elif self.path == "/v1/generate_range":
                    status, obj = self.router.generate_range(
                        body.get("pair_indexes") or [],
                        chunk_size=body.get("chunk_size"),
                        timeout_s=body.get("timeout_s"),
                        aggregate=body.get("aggregate", False) is True,
                        tenant=body.get("tenant"),
                    )
                elif self.path == "/v1/subscribe":
                    status, obj = self.router.subscribe(body)
                elif self.path == "/v1/unsubscribe":
                    status, obj = self.router.unsubscribe(body)
                elif self.path == "/v1/backfill":
                    status, obj = self.router.backfill_submit(body)
                else:
                    status, obj = 404, {"error": f"no such path: {self.path}"}
        except NoShardsError as exc:
            status, obj = 503, {"error": str(exc)}
        except DeadlineError as exc:
            # a budget that ran out mid-scatter: typed, never partial
            status, obj = 504, {"error": str(exc), "error_type": exc.error_type}
        self._send_json(status, obj)


class RouterHTTPServer:
    """The cluster's client-facing HTTP door (same wire protocol as the
    single-daemon `ProofHTTPServer`, so clients don't know it's a cluster)."""

    def __init__(
        self, router: ClusterRouter, host: str = "127.0.0.1", port: int = 0
    ):
        self.router = router
        handler = type("_BoundRouterHandler", (_RouterHandler,), {"router": router})
        self._httpd = _Listener((host, port), handler)
        self._httpd.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def address(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    def serve_forever(self) -> None:
        self._httpd.serve_forever(poll_interval=0.1)

    def start(self) -> "RouterHTTPServer":
        # start()/shutdown() are owner-thread lifecycle calls with a
        # happens-before edge through Thread.start()/join(); no lock needed
        self._thread = threading.Thread(  # ipclint: disable=race-unannotated
            target=self.serve_forever, name="cluster-router-httpd", daemon=True
        )
        self._thread.start()
        # background scrape loop + SLO watchdog ride the server lifecycle;
        # router.close() (via shutdown) stops both
        self.router.federation.start()
        if self.router.slo is not None:
            self.router.slo.start()
        return self

    def shutdown(self, timeout: Optional[float] = None) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout)
        self.router.close()
