"""Multi-endpoint Lotus failover: health scoring, circuit breakers, hedged
block fetches, and content-addressed integrity verification.

A single Lotus endpoint is a single point of failure *and* a single point
of trust. `EndpointPool` wraps N `LotusClient`s and gives the proof
pipeline three guarantees:

- **Availability** — requests fail over across endpoints, ordered by a
  health score (EWMA of recent success). A circuit breaker per endpoint
  opens after ``breaker_threshold`` consecutive failures (stops hammering a
  dead node), then admits a single half-open probe after
  ``breaker_reset_s``; a successful probe closes the breaker.
- **Tail latency** — optional hedged block fetches: if the primary fetch
  has not answered within a p99-based hedge delay, a second fetch fires on
  the next-healthiest endpoint and the first *valid* answer wins
  (``rpc.hedge_wins`` counts races the hedge won).
- **Integrity** — every block fetched through the pool is re-hashed
  against the requested CID. A mismatch is a `IntegrityError`: the
  endpoint answered confidently with wrong bytes, so it is demoted
  immediately (breaker opens) and the fetch retries elsewhere. Corrupt
  bytes can therefore never enter a witness bundle.

The counterpart of ``ipc_proofs_tpu.store.failover``, verdict for verdict,
demotion for demotion and counter for counter, with one change of lane: a
batch attempt (`chain_read_obj_many`) verifies its landed blocks with ONE
`ops.verify.verify_blocks_batch` call on ``backend`` (default the card,
`get_backend("gpu")`, which raises without CUDA), where the reference
re-hashes each block on the host; a single read stays
`store.rpc.verify_block_bytes`, the lane's one-block case. A kernel or
launch fault of that call is not an endpoint's failure: it raises
`ops.verify.VerifyLaneError` out of the read, past every failover net, and
never demotes an endpoint. The batch attempt's latency, which feeds the
p99 hedge delay, includes the lane call.

Determinism: the pool takes an injectable ``clock`` so breaker timing is
testable without sleeping; all fault-injection lives in `store.faults`.
"""

from __future__ import annotations

import random
import time
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor
from concurrent.futures import TimeoutError as FutureTimeoutError
from concurrent.futures import wait as futures_wait
from typing import Any, Optional

from ipc_proofs_tpu_torch.core.cid import CID
from ipc_proofs_tpu_torch.obs.trace import current_context, span, use_context
from ipc_proofs_tpu_torch.ops.verify import VerifyLaneError, verify_blocks_batch
from ipc_proofs_tpu_torch.store.rpc import IntegrityError, LotusClient, RpcError, verify_block_bytes
from ipc_proofs_tpu_torch.utils.lockdep import named_lock
from ipc_proofs_tpu_torch.utils.metrics import Histogram

__all__ = ["DegradedError", "EndpointPool", "EndpointState", "IntegrityError", "is_store_error"]


class DegradedError(RuntimeError):
    """Every endpoint's breaker is open (``lotus_down``): the pool fails
    RPC-needing work fast and typed instead of stacking retry timeouts.

    Warm-tier reads never see this — the tiered store answers before the
    pool is consulted; only genuinely cold requests surface it."""

    error_type = "degraded"

    def __init__(self, detail: str = ""):
        super().__init__(
            "all Lotus endpoints unavailable (degraded=lotus_down)"
            + (f": {detail}" if detail else "")
        )


# what a store raises when a node, a transport or a disk fails it
STORE_ERRORS = (ConnectionError, TimeoutError, OSError, RpcError, IntegrityError, DegradedError)


def is_store_error(exc: BaseException, also: tuple = ()) -> bool:
    """True for a store error (`STORE_ERRORS` or ``also``) and for a
    `RuntimeError` raised from one (a client's exhausted retries, a pool
    whose every endpoint failed): walks the ``__cause__`` chain. False for a
    verify-lane fault (`VerifyLaneError`) and for any other exception, such
    as a kernel or launch fault on the card, which callers re-raise instead
    of retrying or counting."""
    kinds = STORE_ERRORS + tuple(also)
    for _ in range(16):
        if exc is None or isinstance(exc, VerifyLaneError):
            return False
        if isinstance(exc, kinds):
            return True
        exc = exc.__cause__
    return False


# Breaker states
_CLOSED = "closed"
_OPEN = "open"
_HALF_OPEN = "half_open"

# EWMA smoothing for the per-endpoint health score (higher alpha = reacts
# faster to the latest outcome).
_SCORE_ALPHA = 0.2


class EndpointState:
    """Mutable per-endpoint health record (guarded by the pool's lock)."""

    __slots__ = (
        "client", "index", "score", "consecutive_failures", "breaker",
        "opened_at", "probe_in_flight", "successes", "failures", "demotions",
    )

    def __init__(self, client: LotusClient, index: int):
        self.client = client
        self.index = index
        self.score = 1.0  # EWMA success rate; 1.0 = perfectly healthy
        self.consecutive_failures = 0
        self.breaker = _CLOSED
        self.opened_at = 0.0
        self.probe_in_flight = False
        self.successes = 0
        self.failures = 0
        self.demotions = 0  # integrity-mismatch demotions

    @property
    def endpoint(self) -> str:
        return getattr(self.client, "endpoint", f"endpoint-{self.index}")

    def snapshot(self) -> dict:
        return {
            "endpoint": self.endpoint,
            "breaker": self.breaker,
            "score": round(self.score, 4),
            "consecutive_failures": self.consecutive_failures,
            "successes": self.successes,
            "failures": self.failures,
            "integrity_demotions": self.demotions,
        }


class EndpointPool:
    """N `LotusClient`s behind one client-shaped facade.

    Duck-types the client surface the blockstore and proof drivers use
    (``request``, ``chain_read_obj``, ``chain_get_parent_receipts``), so an
    `EndpointPool` drops in anywhere a `LotusClient` goes. Exposes
    ``verifies_integrity = True`` so `RpcBlockstore` skips its own
    (redundant) hash check — verification must happen *here*, per
    endpoint, so the pool knows which endpoint lied.
    """

    verifies_integrity = True

    def __init__(
        self,
        clients: "list[LotusClient]",
        breaker_threshold: int = 5,
        breaker_reset_s: float = 30.0,
        hedge_ms: Optional[float] = None,
        metrics=None,
        clock=time.monotonic,
        retry_budget_per_s: Optional[float] = None,
        backend=None,
    ):
        """``breaker_threshold`` consecutive failures open an endpoint's
        breaker; after ``breaker_reset_s`` one half-open probe is admitted.
        ``hedge_ms`` enables hedged block fetches with that floor delay in
        milliseconds (the effective delay is the larger of the floor and
        the observed p99 fetch latency); ``None`` disables hedging.
        ``clock`` injects a monotonic time source for deterministic breaker
        tests. ``retry_budget_per_s`` caps the POOL-WIDE rate of
        `LotusClient` retry attempts (token bucket shared across every
        endpoint, burst 2×): during a brownout the clients stop amplifying
        load instead of multiplying it by max_retries × endpoints
        (``rpc.retry_budget_exhausted``). ``None`` leaves retries
        unbudgeted. ``backend`` hashes the batch attempts' landed blocks
        (default the card)."""
        if not clients:
            raise ValueError("EndpointPool needs at least one client")
        if backend is None:
            from ipc_proofs_tpu_torch.backend import get_backend

            backend = get_backend("gpu")
        self._backend = backend
        backend.warm()  # nvcc now, before a plane dispatcher or hedge racer reads
        self._endpoints = [EndpointState(c, i) for i, c in enumerate(clients)]
        self.breaker_threshold = max(1, int(breaker_threshold))
        self.breaker_reset_s = breaker_reset_s
        self.hedge_ms = hedge_ms
        self._clock = clock
        self._lock = named_lock("EndpointPool._lock")
        # pool-wide block-fetch seconds
        self._latency = Histogram(maxlen=512)  # guarded-by: _lock
        self._executor: Optional[ThreadPoolExecutor] = None  # guarded-by: _lock
        # --- degraded (lotus_down) posture + synchronized probing ---
        self._degraded = False  # all breakers open right now; guarded-by: _lock
        self._probe_holder: Optional[int] = None  # endpoint index holding the pool probe slot; guarded-by: _lock
        self._probe_not_before = 0.0  # full-jitter gate for the next pool probe; guarded-by: _lock
        self._probe_wave = 0  # consecutive failed pool probes; guarded-by: _lock
        self._probe_rng = random.Random(0x19C0)  # guarded-by: _lock
        # --- pool-wide client retry budget ---
        self._retry_rate = float(retry_budget_per_s) if retry_budget_per_s else 0.0
        self._retry_tokens = 2.0 * self._retry_rate  # guarded-by: _lock
        self._retry_stamp = clock()  # guarded-by: _lock
        if metrics is None:
            from ipc_proofs_tpu_torch.utils.metrics import get_metrics

            metrics = get_metrics()
        self._metrics = metrics
        if self._retry_rate > 0:
            for ep in self._endpoints:
                # the clients consult the shared budget before each retry
                # sleep; a client without the hook retries as before
                ep.client.retry_gate = self.allow_retry

    # ------------------------------------------------------------------
    # client facade

    @property
    def endpoint(self) -> str:
        return ",".join(ep.endpoint for ep in self._endpoints)

    @property
    def endpoints(self) -> "list[str]":
        return [ep.endpoint for ep in self._endpoints]

    def request(self, method: str, params: Any, timeout_s: Optional[float] = None) -> Any:
        """Issue one JSON-RPC request with failover.

        Transport failures (and exhausted-retry `RuntimeError`s from the
        underlying client) rotate to the next endpoint; a semantic
        `RpcError` is the *node answering* — it propagates immediately,
        because every replica would say the same thing. In the
        ``lotus_down`` posture (every breaker open) a request that did not
        win the pool's probe slot raises `DegradedError` without touching
        any endpoint — fail fast, never a stacked retry timeout."""
        last: Optional[Exception] = None
        attempted = 0
        for ep in self._candidates():
            if not self._begin_attempt(ep):
                continue
            attempted += 1
            t0 = self._clock()
            try:
                result = ep.client.request(method, params, timeout_s=timeout_s)
            except RpcError:
                # the endpoint is up and talking protocol; its answer is
                # authoritative even when it is an error
                self._record_success(ep, self._clock() - t0, observe_latency=False)
                raise
            except Exception as exc:  # fail-soft: failover — failure feeds the breaker; re-raised below once every endpoint has been tried
                self._record_failure(ep)
                last = exc
                continue
            self._record_success(ep, self._clock() - t0, observe_latency=False)
            return result
        if self.lotus_down:
            if attempted == 0:
                self._metrics.count("degraded.fail_fast")
            raise DegradedError(method) from last
        raise RuntimeError(
            f"all {len(self._endpoints)} endpoints failed for {method}"
        ) from last

    def chain_get_parent_receipts(self, block_cid: CID) -> "Optional[list[dict]]":
        return self.request("Filecoin.ChainGetParentReceipts", [{"/": str(block_cid)}])

    def chain_read_obj(self, cid: CID) -> Optional[bytes]:
        """Fetch one block with failover, integrity verification, and
        (when enabled) hedging. Returns the verified bytes, ``None`` when
        the chain has no such block, or raises: `IntegrityError` if every
        endpoint returned corrupt bytes, `RuntimeError` if every endpoint
        failed."""
        candidates = self._candidates()
        with span("pool.read") as sp:
            if self.hedge_ms is not None and len(candidates) >= 2:
                sp.set_attr("hedged", True)
                return self._hedged_read(cid, candidates)
            last: Optional[Exception] = None
            attempted = 0
            for ep in candidates:
                if not self._begin_attempt(ep):
                    continue
                attempted += 1
                try:
                    return self._read_one(ep, cid)
                except Exception as exc:  # fail-soft: failover — _read_one already recorded the failure (and demoted on corruption); re-raised below after the last endpoint
                    last = exc
                    continue
            if isinstance(last, IntegrityError):
                raise last  # every endpoint returned corrupt bytes — say so
            if self.lotus_down:
                if attempted == 0:
                    self._metrics.count("degraded.fail_fast")
                raise DegradedError(str(cid)) from last
            raise RuntimeError(
                f"all {len(self._endpoints)} endpoints failed reading {cid}"
            ) from last

    def chain_read_obj_many(self, cids: "list[CID]") -> "list[Optional[bytes]]":
        """Batched `chain_read_obj` with the pool's semantics intact:

        - **breaker/failover** — each batch attempt runs against one
          endpoint through the same `_begin_attempt` admission and
          `_record_success`/`_record_failure` accounting as single reads;
          a transport failure rotates the WHOLE remaining batch to the
          next candidate.
        - **integrity demux** — every returned block verifies against its
          CID *per endpoint*. Blocks that verify are kept even when
          neighbors in the same response do not (content addressing makes
          them trustworthy regardless of who served them); the corrupt
          remainder demotes the endpoint and retries elsewhere.
        - **hedging** — when enabled, the first attempt races a second
          endpoint after the usual p99-based delay, first answer wins
          (counted `rpc.hedges`/`rpc.hedge_wins` like single reads).

        Whatever is still unresolved after every candidate has been tried
        falls back to per-CID `chain_read_obj`, so the error taxonomy
        (`IntegrityError` when every endpoint lied, `RuntimeError` when
        every endpoint failed) is exactly the single-read one. A fault of
        the verify lane raises `VerifyLaneError` at once."""
        cids = list(cids)
        if not cids:
            return []
        results: "dict[int, Optional[bytes]]" = {}
        todo = list(range(len(cids)))
        candidates = self._candidates()
        with span("pool.read_many") as sp:
            sp.set_attr("n", len(cids))
            hedged_first = self.hedge_ms is not None and len(candidates) >= 2
            for pos, ep in enumerate(candidates):
                if not todo:
                    break
                subset = [cids[i] for i in todo]
                if hedged_first and pos == 0:
                    ok = self._hedged_read_many(subset, candidates)
                    if ok is None:
                        continue  # both racers failed; keep walking
                else:
                    if not self._begin_attempt(ep):
                        continue
                    try:
                        ok = self._read_many_one(ep, subset)
                    except VerifyLaneError:
                        raise  # the card's fault, not the endpoint's: no failover
                    except Exception:  # fail-soft: failover — _read_many_one recorded the failure; the remaining cids walk to the next endpoint, stragglers re-raise typed errors via chain_read_obj below
                        continue
                still = []
                for k, i in enumerate(todo):
                    if k in ok:
                        results[i] = ok[k]
                    else:
                        still.append(i)
                todo = still
            # stragglers (or a pool whose every batch attempt failed):
            # per-CID reads carry the canonical failover/hedge/error path
            for i in todo:
                results[i] = self.chain_read_obj(cids[i])
        return [results[i] for i in range(len(cids))]

    def _read_many_one(self, ep: EndpointState, subset: "list[CID]") -> "dict[int, Optional[bytes]]":
        """One endpoint's batch attempt: fetch ``subset`` and verify its
        landed blocks in one lane call, recording the outcome. Returns
        verified results keyed by subset index (missing keys = corrupt
        blocks from this endpoint, which demoted it). A lane fault raises
        `VerifyLaneError` and records nothing against the endpoint."""
        t0 = self._clock()
        try:
            blocks = ep.client.chain_read_obj_many(subset)
        except RpcError:
            # the endpoint is up and talking protocol; its per-id answer
            # is authoritative even when it is an error
            self._record_success(ep, self._clock() - t0, observe_latency=False)
            raise
        except Exception:
            self._record_failure(ep)
            raise
        landed = [k for k, data in enumerate(blocks) if data is not None]
        verdicts: "list[bool]" = []
        if landed:
            try:
                verdicts = verify_blocks_batch(
                    [subset[k] for k in landed], [blocks[k] for k in landed],
                    metrics=self._metrics, backend=self._backend,
                )
            except Exception as exc:  # not fail-soft: a kernel or launch fault leaves the pool typed, past every failover net
                raise VerifyLaneError(
                    f"verify lane failed on a {len(landed)}-block wave: {exc}"
                ) from exc
        ok: "dict[int, Optional[bytes]]" = {k: None for k, data in enumerate(blocks) if data is None}
        corrupt = 0
        for k, good in zip(landed, verdicts):
            if not good:
                self._metrics.count("rpc.integrity_failures")
                corrupt += 1
                continue
            ok[k] = blocks[k]
        if corrupt:
            with self._lock:
                ep.demotions += 1
            self._record_failure(ep, demote=True)
        else:
            self._record_success(ep, self._clock() - t0)
        return ok

    def _read_many_one_traced(self, ctx, ep: EndpointState, subset: "list[CID]"):
        with use_context(ctx):
            return self._read_many_one(ep, subset)

    def _hedged_read_many(
        self, subset: "list[CID]", candidates: "list[EndpointState]"
    ) -> "Optional[dict[int, Optional[bytes]]]":
        """Primary batch with a delayed hedge on the next endpoint; first
        completed attempt wins. Returns None when both racers failed (the
        caller keeps walking the candidate list)."""
        primary: Optional[EndpointState] = None
        rest: list[EndpointState] = []
        for i, ep in enumerate(candidates):
            if self._begin_attempt(ep):
                primary, rest = ep, candidates[i + 1:]
                break
        if primary is None:
            return None
        pool = self._get_executor()
        ctx = current_context()
        fut_primary = pool.submit(self._read_many_one_traced, ctx, primary, subset)
        try:
            return fut_primary.result(timeout=self._hedge_delay_s())
        except FutureTimeoutError:
            pass  # primary is slow — fire the hedge
        except VerifyLaneError:
            raise
        except Exception:  # fail-soft: primary failed fast (recorded) — the caller's candidate walk is the failover
            return None
        secondary: Optional[EndpointState] = None
        for ep in rest:
            if self._begin_attempt(ep):
                secondary = ep
                break
        if secondary is None:
            try:
                return fut_primary.result()
            except VerifyLaneError:
                raise
            except Exception:  # fail-soft: recorded by _read_many_one; caller walks on
                return None
        self._metrics.count("rpc.hedges")
        fut_hedge = pool.submit(self._read_many_one_traced, ctx, secondary, subset)
        pending = {fut_primary, fut_hedge}
        while pending:
            done, pending = futures_wait(pending, return_when=FIRST_COMPLETED)
            for fut in done:
                try:
                    result = fut.result()
                except VerifyLaneError:
                    raise
                except Exception:  # fail-soft: hedge race — one racer losing is expected and recorded
                    continue
                if fut is fut_hedge:
                    self._metrics.count("rpc.hedge_wins")
                return result
        return None

    # ------------------------------------------------------------------
    # health reporting

    def health(self) -> dict:
        """Status summary for `/healthz`: ``"ok"`` when every breaker is
        closed, ``"degraded"`` when any endpoint is open/half-open; the
        all-breakers-open posture additionally reports
        ``"mode": "lotus_down"`` so operators (and the router) can tell
        partial endpoint loss from a full Lotus outage."""
        with self._lock:
            eps = [ep.snapshot() for ep in self._endpoints]
            lotus_down = self._degraded
        degraded = any(e["breaker"] != _CLOSED for e in eps)
        out = {"status": "degraded" if degraded else "ok", "endpoints": eps}
        if lotus_down:
            out["mode"] = "lotus_down"
        return out

    @property
    def degraded(self) -> bool:
        return self.health()["status"] == "degraded"

    @property
    def lotus_down(self) -> bool:
        """True while EVERY endpoint's breaker is open (degraded mode)."""
        with self._lock:
            return self._degraded

    def allow_retry(self) -> bool:
        """Spend one token from the pool-wide client retry budget.

        `LotusClient._backoff` consults this before every retry sleep; a
        dry bucket means the retry ladder stops HERE for all endpoints at
        once — the anti-storm governor. Unbudgeted pools always allow."""
        if self._retry_rate <= 0:
            return True
        now = self._clock()
        with self._lock:
            elapsed = max(0.0, now - self._retry_stamp)
            self._retry_stamp = now
            self._retry_tokens = min(
                2.0 * self._retry_rate, self._retry_tokens + elapsed * self._retry_rate
            )
            if self._retry_tokens >= 1.0:
                self._retry_tokens -= 1.0
                return True
        self._metrics.count("rpc.retry_budget_exhausted")
        return False

    # ------------------------------------------------------------------
    # internals

    def _candidates(self) -> "list[EndpointState]":
        """Every endpoint, ordered by how much we trust it right now.

        Open breakers past their reset window transition to half-open
        (probe admission happens per-attempt in `_begin_attempt`). An open
        breaker inside the window is ordered LAST rather than excluded:
        callers walk the list front to back, so a tripped endpoint is only
        tried after everything healthier has failed — the breaker still
        sheds routine load off a failing endpoint, but a request that only
        it could serve (the others just failed too) is never refused
        outright. Excluding it entirely let one bad block on the sole
        remaining endpoint fail a whole read while a recovered-but-tripped
        replica sat idle. (In the ``lotus_down`` posture that last-resort
        attempt additionally contends for the pool-wide probe slot — see
        `_begin_attempt` — so one caller probes and the rest fail fast.)"""
        now = self._clock()
        eligible: list[EndpointState] = []
        tripped: list[EndpointState] = []
        with self._lock:
            for ep in self._endpoints:
                if ep.breaker == _OPEN:
                    if now - ep.opened_at >= self.breaker_reset_s:
                        ep.breaker = _HALF_OPEN
                        ep.probe_in_flight = False
                    else:
                        tripped.append(ep)
                        continue
                eligible.append(ep)
            eligible.sort(key=lambda e: (-e.score, e.index))
            tripped.sort(key=lambda e: (-e.score, e.index))
        return eligible + tripped

    def _begin_attempt(self, ep: EndpointState) -> bool:
        """Admission check right before an actual attempt: a half-open
        breaker admits exactly one in-flight probe (cleared by the
        attempt's `_record_success`/`_record_failure`).

        In the ``lotus_down`` posture the rules tighten: EVERY attempt —
        open-in-window last resorts and half-open probes alike — funnels
        through ONE pool-wide probe slot + full-jitter backoff. The first
        request after entry becomes the pool's probe (the gate starts
        open, so the `_candidates` last-resort contract survives: work
        that only a tripped endpoint could serve is still tried); the
        rest fail fast typed instead of stacking timeouts on known-dead
        nodes. N endpoints recovering together must not greet the
        gateway with N simultaneous probes (``rpc.probe_suppressed``)."""
        suppressed = False
        with self._lock:
            if self._degraded:
                now = self._clock()
                if (
                    now < self._probe_not_before
                    or (
                        self._probe_holder is not None
                        and self._probe_holder != ep.index
                    )
                    or ep.probe_in_flight
                ):
                    suppressed = True
                else:
                    self._probe_holder = ep.index
                    ep.probe_in_flight = True
                    return True
            if not suppressed:
                if ep.breaker == _HALF_OPEN:
                    if ep.probe_in_flight:
                        return False
                    ep.probe_in_flight = True
                return True
        self._metrics.count("rpc.probe_suppressed")
        return False

    def _record_success(self, ep: EndpointState, latency_s: float, observe_latency: bool = True) -> None:
        recovered = False
        with self._lock:
            ep.successes += 1
            ep.consecutive_failures = 0
            ep.probe_in_flight = False
            if self._probe_holder == ep.index:
                self._probe_holder = None
            if ep.breaker != _CLOSED:
                ep.breaker = _CLOSED
            ep.score = (1.0 - _SCORE_ALPHA) * ep.score + _SCORE_ALPHA
            if observe_latency:
                self._latency.observe(latency_s)
            if self._degraded:
                # one endpoint answering ends lotus_down — no restart,
                # no operator action, just the probe succeeding
                self._degraded = False
                self._probe_wave = 0
                self._probe_not_before = 0.0
                recovered = True
        if recovered:
            self._metrics.count("degraded.exited")

    def _record_failure(self, ep: EndpointState, demote: bool = False) -> None:
        entered = False
        with self._lock:
            now = self._clock()
            was_probe = self._degraded and self._probe_holder == ep.index
            ep.failures += 1
            ep.consecutive_failures += 1
            ep.probe_in_flight = False
            if self._probe_holder == ep.index:
                self._probe_holder = None
            ep.score = (1.0 - _SCORE_ALPHA) * ep.score
            tripped = demote or ep.breaker == _HALF_OPEN or (
                ep.consecutive_failures >= self.breaker_threshold
            )
            if tripped and ep.breaker != _OPEN:
                ep.breaker = _OPEN
                ep.opened_at = now
                self._metrics.count("failover.breaker_open")
            elif tripped:
                ep.opened_at = now
            if was_probe:
                # failed pool probe: back the next wave off with full
                # jitter, capped at the breaker window (never slower to
                # recover than the per-endpoint reset already is)
                self._probe_wave += 1
                cap = min(
                    max(0.0, self.breaker_reset_s),
                    0.25 * (2.0 ** min(self._probe_wave, 8)),
                )
                self._probe_not_before = now + self._probe_rng.uniform(0.0, cap)
            if not self._degraded and all(
                e.breaker == _OPEN for e in self._endpoints
            ):
                self._degraded = True
                entered = True
        if entered:
            self._metrics.count("degraded.entered")

    def _read_one(self, ep: EndpointState, cid: CID) -> Optional[bytes]:
        """Fetch + verify one block from one endpoint, recording outcome."""
        t0 = self._clock()
        try:
            data = ep.client.chain_read_obj(cid)
        except RpcError:
            self._record_success(ep, self._clock() - t0, observe_latency=False)
            raise
        except Exception:
            self._record_failure(ep)
            raise
        if data is not None and not verify_block_bytes(cid, data):
            self._metrics.count("rpc.integrity_failures")
            with self._lock:
                ep.demotions += 1
            self._record_failure(ep, demote=True)
            raise IntegrityError(cid, ep.endpoint)
        self._record_success(ep, self._clock() - t0)
        return data

    def _read_one_traced(self, ctx, ep: EndpointState, cid: CID) -> Optional[bytes]:
        with use_context(ctx):
            return self._read_one(ep, cid)

    def _hedge_delay_s(self) -> float:
        floor = (self.hedge_ms or 0.0) / 1000.0
        with self._lock:
            pcts = self._latency.percentiles((0.99,)) if self._latency.count >= 16 else {}
        return max(floor, pcts.get("p99", 0.0))

    def _get_executor(self) -> ThreadPoolExecutor:
        with self._lock:
            if self._executor is None:
                self._executor = ThreadPoolExecutor(
                    max_workers=max(8, 2 * len(self._endpoints)),
                    thread_name_prefix="hedge",
                )
            return self._executor

    def _hedged_read(self, cid: CID, candidates: "list[EndpointState]") -> Optional[bytes]:
        """Primary fetch with a delayed hedge on the next endpoint; first
        valid (verified) answer wins. Endpoints beyond the first two serve
        as failover if both racers fail."""
        primary: Optional[EndpointState] = None
        rest: list[EndpointState] = []
        for i, ep in enumerate(candidates):
            if self._begin_attempt(ep):
                primary, rest = ep, candidates[i + 1:]
                break
        if primary is None:
            if self.lotus_down:
                self._metrics.count("degraded.fail_fast")
                raise DegradedError(str(cid))
            raise RuntimeError(f"no endpoint admits a read for {cid}")
        pool = self._get_executor()
        # racer threads inherit the caller's trace context so their RPC
        # spans stay inside the request's tree
        ctx = current_context()
        fut_primary = pool.submit(self._read_one_traced, ctx, primary, cid)
        try:
            return fut_primary.result(timeout=self._hedge_delay_s())
        except FutureTimeoutError:
            pass  # primary is slow — fire the hedge
        except Exception:
            # primary failed fast: plain failover, not a hedge race
            for ep in rest:
                if not self._begin_attempt(ep):
                    continue
                try:
                    return self._read_one(ep, cid)
                except Exception:  # fail-soft: failover — recorded by _read_one; the primary's error re-raises below when no endpoint answers
                    continue
            raise
        secondary: Optional[EndpointState] = None
        fallback: list[EndpointState] = []
        for i, ep in enumerate(rest):
            if self._begin_attempt(ep):
                secondary, fallback = ep, rest[i + 1:]
                break
        if secondary is None:
            # nowhere to hedge to — just wait for the primary
            return fut_primary.result()
        self._metrics.count("rpc.hedges")
        fut_hedge = pool.submit(self._read_one_traced, ctx, secondary, cid)
        pending = {fut_primary, fut_hedge}
        last: Optional[Exception] = None
        while pending:
            done, pending = futures_wait(pending, return_when=FIRST_COMPLETED)
            for fut in done:
                try:
                    result = fut.result()
                except Exception as exc:  # fail-soft: hedge race — one racer losing is expected; surfaced via `from last` if both lose
                    last = exc
                    continue
                if fut is fut_hedge:
                    self._metrics.count("rpc.hedge_wins")
                return result
        # both racers failed — try any remaining endpoints before giving up
        for ep in fallback:
            if not self._begin_attempt(ep):
                continue
            try:
                return self._read_one(ep, cid)
            except Exception as exc:  # fail-soft: failover — recorded by _read_one; re-raised below after the last fallback
                last = exc
        if isinstance(last, IntegrityError):
            raise last  # every endpoint returned corrupt bytes — say so
        raise RuntimeError(
            f"all {len(self._endpoints)} endpoints failed reading {cid} (hedged)"
        ) from last

    def close(self) -> None:
        with self._lock:
            executor, self._executor = self._executor, None
        if executor is not None:
            executor.shutdown(wait=False)
