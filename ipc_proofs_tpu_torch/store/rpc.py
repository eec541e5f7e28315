"""Lotus JSON-RPC client and the RPC-backed blockstore.

The counterpart of ``ipc_proofs_tpu.store.rpc``: `LotusClient` (JSON-RPC
2.0, bearer auth, bounded retries with full-jitter backoff, retryable
rate-limit codes, the JSON-RPC batch framing with its one-time capability
probe) and `RpcBlockstore` (raw IPLD blocks via `Filecoin.ChainReadObj`,
every block multihash-verified before anything observes it). Each call
is one trace span, ``rpc.<method>`` (all its attempts) or ``rpc.batch``
(one batch round-trip), parented by whatever context is ambient on the
calling thread; the endpoint pool (``store/failover.py``) sets each
client's ``retry_gate``, the pool-wide retry budget.

``requests`` is imported only when no session is injected, so the module
imports without it; the hermetic path (`store.faults.LocalLotusSession`)
needs no ``requests`` at all.
"""

from __future__ import annotations

import base64
import hashlib
import json
import random
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Iterable, Optional

from ipc_proofs_tpu_torch.core.cid import BLAKE2B_256, CID, IDENTITY, KECCAK_256, SHA2_256
from ipc_proofs_tpu_torch.core.hashes import blake2b_256, keccak256
from ipc_proofs_tpu_torch.obs.trace import current_context, span, use_context
from ipc_proofs_tpu_torch.ops.verify import VerifyLaneError
from ipc_proofs_tpu_torch.utils.lockdep import named_lock
from ipc_proofs_tpu_torch.utils.log import get_logger

__all__ = [
    "LotusClient",
    "RpcBlockstore",
    "RpcError",
    "IntegrityError",
    "verify_block_bytes",
    "DEFAULT_RETRYABLE_RPC_CODES",
]

logger = get_logger(__name__)

DEFAULT_TIMEOUT_S = 250.0

# JSON-RPC error codes worth retrying with backoff: gateways surface rate
# limiting as a protocol-level error rather than an HTTP 429. Semantic
# errors (method not found, actor not found, bad params) stay fail-fast.
DEFAULT_RETRYABLE_RPC_CODES = frozenset({429, -429})
_TRANSIENT_RPC_MARKERS = ("too many requests", "rate limit", "try again")

# HTTP statuses that mean "this endpoint rejects JSON-RPC batch framing":
# the capability probe concludes negative on these ONLY; 5xx, 429 and auth
# failures are transient and retry.
_BATCH_REJECT_STATUSES = frozenset({400, 404, 405, 501})


class RpcError(RuntimeError):
    """JSON-RPC level error (the `error` member of the response)."""

    def __init__(self, code: int, message: str):
        super().__init__(f"RPC error {code}: {message}")
        self.code = code
        self.message = message


class IntegrityError(RuntimeError):
    """Fetched block bytes do not hash to the requested CID.

    A *trust* failure, not a transport failure: the endpoint answered
    confidently with wrong bytes, so re-asking the same endpoint is
    pointless (and dangerous).
    """

    def __init__(self, cid, endpoint: str = "?", reason: str = "failed multihash verification"):
        super().__init__(f"block bytes for {cid} {reason} (endpoint {endpoint})")
        self.cid = cid
        self.endpoint = endpoint


def verify_block_bytes(cid: CID, data: bytes) -> bool:
    """Recompute ``data``'s multihash against ``cid``'s digest.

    True when the digest matches, or when the multihash function is one
    this code cannot compute: unknown codes are accepted rather than
    rejected, since they cannot be proven wrong. The batch form is
    `ops.verify.verify_blocks_batch`, verdict for verdict the same.
    """
    mh = cid.mh_code
    if mh == BLAKE2B_256:
        return blake2b_256(bytes(data)) == cid.digest
    if mh == SHA2_256:
        return hashlib.sha256(bytes(data)).digest() == cid.digest
    if mh == KECCAK_256:
        return keccak256(bytes(data)) == cid.digest
    if mh == IDENTITY:
        return bytes(data) == bytes(cid.digest)
    return True


class LotusClient:
    """Minimal JSON-RPC 2.0 client for a Lotus node over HTTP(S)."""

    def __init__(
        self,
        endpoint: str,
        bearer_token: Optional[str] = None,
        timeout_s: float = DEFAULT_TIMEOUT_S,
        max_retries: int = 3,
        block_timeout_s: float = 30.0,
        backoff_base_s: float = 0.25,
        backoff_max_s: float = 10.0,
        session=None,
        metrics=None,
        rng: Optional[random.Random] = None,
        retryable_rpc_codes: frozenset[int] = DEFAULT_RETRYABLE_RPC_CODES,
    ):
        """``timeout_s`` bounds general RPC calls; ``block_timeout_s`` bounds
        single-block fetches, which are small and must fail fast.

        Retry sleeps use full jitter: ``uniform(0, min(backoff_max_s,
        backoff_base_s * 2**attempt))``; ``rng`` injects the jitter source
        for deterministic tests. Every retry counts ``rpc.retries`` on
        ``metrics`` (default: the process-global `Metrics`).

        ``retryable_rpc_codes`` names JSON-RPC error codes that get the same
        backoff as transport errors; a message matching a rate-limit marker
        is retried whatever its code. Any other `RpcError` fails fast.

        ``session`` injects any object with ``.post`` (tests and the
        hermetic node; no ``requests`` needed)."""
        self.endpoint = endpoint
        self.timeout_s = timeout_s
        self.max_retries = max_retries
        self.block_timeout_s = block_timeout_s
        self.backoff_base_s = backoff_base_s
        self.backoff_max_s = backoff_max_s
        self.retryable_rpc_codes = retryable_rpc_codes
        # optional pool-wide retry governor (EndpointPool.allow_retry):
        # consulted before every retry sleep; None = retries unbudgeted
        self.retry_gate = None
        self._rng = rng if rng is not None else random.Random()
        self._headers = {"Content-Type": "application/json"}
        if bearer_token:
            self._headers["Authorization"] = f"Bearer {bearer_token}"
        self._id_lock = named_lock("LotusClient._id_lock")
        self._next_id = 1  # guarded-by: _id_lock
        # batch-capability probe: None = unknown (probe on the first batch
        # call), True = the endpoint answers batch arrays, False = it
        # rejected the framing and every batch read goes sequential
        self._batch_ok: Optional[bool] = None  # guarded-by: _id_lock
        if metrics is None:
            from ipc_proofs_tpu_torch.utils.metrics import get_metrics

            metrics = get_metrics()
        self._metrics = metrics
        if session is not None:
            self._session = session
        else:
            import importlib

            self._session = importlib.import_module("requests").Session()

    def request(self, method: str, params: Any, timeout_s: Optional[float] = None) -> Any:
        """Issue one JSON-RPC request; returns the `result` member."""
        with self._id_lock:
            req_id = self._next_id
            self._next_id += 1
        # one tick per logical call (not per retry): a disk-warm request must
        # leave this at a delta of zero
        self._metrics.count("rpc.calls")
        payload = {"jsonrpc": "2.0", "method": method, "params": params, "id": req_id}
        deadline = self.timeout_s if timeout_s is None else timeout_s
        last_err: Exception | None = None
        # one span per RPC call (all attempts), parented by whatever
        # request/stage context is ambient on the calling thread
        with span(f"rpc.{method}", {"endpoint": self.endpoint}) as sp:
            for attempt in range(self.max_retries):
                try:
                    resp = self._session.post(
                        self.endpoint, data=json.dumps(payload), headers=self._headers, timeout=deadline
                    )
                    resp.raise_for_status()
                    body = resp.json()
                    if "error" in body and body["error"] is not None:
                        err = body["error"]
                        raise RpcError(err.get("code", -1), err.get("message", "unknown"))
                    if attempt:
                        sp.set_attr("retries", attempt)
                    return body.get("result")
                except RpcError as exc:
                    if not self._rpc_error_retryable(exc):
                        sp.set_attr("error", str(exc))
                        raise  # semantic protocol errors are not retryable
                    last_err = exc
                    if attempt + 1 >= self.max_retries or not self._backoff(method, attempt, exc):
                        break
                except Exception as exc:  # fail-soft: transport errors retry with backoff; exhausted retries re-raise below `from last_err`
                    last_err = exc
                    if attempt + 1 >= self.max_retries or not self._backoff(method, attempt, exc):
                        break
            self._metrics.count("rpc.failures")
            sp.set_attr("retries", self.max_retries - 1)
            sp.set_attr("error", str(last_err))
        raise RuntimeError(f"RPC {method} failed after {self.max_retries} attempts") from last_err

    def _rpc_error_retryable(self, exc: RpcError) -> bool:
        if exc.code in self.retryable_rpc_codes:
            return True
        message = (exc.message or "").lower()
        return any(marker in message for marker in _TRANSIENT_RPC_MARKERS)

    def _backoff(self, method: str, attempt: int, exc: Exception) -> bool:
        """Sleep with full jitter before the next attempt. Returns False
        (the retry ladder stops, the original error surfaces) when the
        pool-wide retry budget is dry. Raises a typed `DeadlineError` when
        the ambient request budget cannot cover the sleep."""
        from ipc_proofs_tpu_torch.utils.deadline import DeadlineError, checkpoint, remaining_budget_s

        checkpoint("rpc.retry")
        gate = self.retry_gate
        if gate is not None and not gate():
            logger.warning("RPC %s retry stopped: pool retry budget exhausted", method)
            return False
        bound = min(self.backoff_max_s, self.backoff_base_s * 2.0**attempt)
        sleep_s = self._rng.uniform(0.0, bound)
        remaining = remaining_budget_s()
        if remaining is not None and remaining <= sleep_s:
            raise DeadlineError(
                "RPC %s retry abandoned: %.0fms budget cannot cover %.0fms backoff"
                % (method, remaining * 1000.0, sleep_s * 1000.0),
                stage="rpc.retry",
            ) from exc
        logger.warning(
            "RPC %s attempt %d/%d failed (%s) — retrying", method, attempt + 1, self.max_retries, exc
        )
        self._metrics.count("rpc.retries")
        time.sleep(sleep_s)
        return True

    def chain_read_obj(self, cid: CID) -> Optional[bytes]:
        """Fetch one raw IPLD block (`Filecoin.ChainReadObj`) under the
        fail-fast ``block_timeout_s``."""
        result = self.request("Filecoin.ChainReadObj", [{"/": str(cid)}], timeout_s=self.block_timeout_s)
        if result is None:
            return None
        try:
            return base64.b64decode(result)
        except (ValueError, TypeError) as exc:
            # a payload that does not decode is corrupt data from the node:
            # the same trust failure as a multihash mismatch
            raise IntegrityError(cid, self.endpoint, reason=f"are undecodable ({exc})") from exc

    @property
    def supports_batch(self) -> "Optional[bool]":
        """Batch-capability probe state (None until the first batch call)."""
        with self._id_lock:
            return self._batch_ok

    def chain_read_obj_many(self, cids: "list[CID]") -> "list[Optional[bytes]]":
        """Fetch many raw IPLD blocks in ONE JSON-RPC batch round-trip.

        The response array is demuxed by request id (servers may answer out
        of order). Entries align with ``cids``: decodable bytes or None for
        absent blocks. An id the server answered with an ``error`` (or did
        not answer) is refetched through `chain_read_obj`, so its typed error
        surfaces exactly as without batching.

        Capability is probed ONCE: the first response that is not a JSON
        array, or a framing-style HTTP 4xx (400/404/405/501), marks the
        endpoint batch-incapable and this and every later call read
        sequentially. Transient failures retry and never conclude the probe,
        and an endpoint whose batch calls have succeeded is never demoted.
        Bytes are NOT verified here; the callers that know whom to blame
        verify (`RpcBlockstore`, the fetch plane)."""
        cids = list(cids)
        if not cids:
            return []
        with self._id_lock:
            batch_ok = self._batch_ok
        if batch_ok is False or len(cids) == 1:
            return [self.chain_read_obj(c) for c in cids]
        entries = self._post_batch_read(cids)
        if entries is None:
            return [self.chain_read_obj(c) for c in cids]
        out: "list[Optional[bytes]]" = []
        retried = 0
        for cid, entry in zip(cids, entries):
            if entry is None or ("error" in entry and entry["error"] is not None):
                retried += 1
                out.append(self.chain_read_obj(cid))
                continue
            result = entry.get("result")
            if result is None:
                out.append(None)
                continue
            try:
                out.append(base64.b64decode(result))
            except (ValueError, TypeError) as exc:
                raise IntegrityError(cid, self.endpoint, reason=f"are undecodable ({exc})") from exc
        if retried:
            self._metrics.count("rpc.batch_item_retries", retried)
        return out

    def _post_batch_read(self, cids: "list[CID]") -> "Optional[list[Optional[dict]]]":
        """POST one ChainReadObj batch array; returns per-cid response
        entries (None for unanswered ids), or None when the endpoint rejects
        batch framing. Transport failures retry with the standard backoff."""
        with self._id_lock:
            first_id = self._next_id
            self._next_id += len(cids)
            batch_confirmed = self._batch_ok is True
        payload = [
            {"jsonrpc": "2.0", "method": "Filecoin.ChainReadObj", "params": [{"/": str(cid)}], "id": first_id + i}
            for i, cid in enumerate(cids)
        ]
        # one round-trip = one rpc.calls tick, as for a single request
        self._metrics.count("rpc.calls")
        last_err: Exception | None = None
        with span("rpc.batch", {"endpoint": self.endpoint, "n": len(cids)}) as sp:
            for attempt in range(self.max_retries):
                try:
                    resp = self._session.post(
                        self.endpoint, data=json.dumps(payload), headers=self._headers,
                        timeout=self.block_timeout_s,
                    )
                    resp.raise_for_status()
                    body = resp.json()
                except Exception as exc:  # fail-soft: a framing 4xx concludes the probe below; transport errors retry, exhausted retries re-raise `from last_err`
                    status = getattr(getattr(exc, "response", None), "status_code", None)
                    if status in _BATCH_REJECT_STATUSES and not batch_confirmed:
                        self._mark_batch_unsupported(sp)
                        return None
                    last_err = exc
                    if attempt + 1 < self.max_retries:
                        self._backoff("ChainReadObj[batch]", attempt, exc)
                    continue
                if not isinstance(body, list):
                    if not batch_confirmed:
                        # old gateways answer a batch array with one "invalid
                        # request" object: the probe concludes negative
                        self._mark_batch_unsupported(sp)
                        return None
                    # a batch-confirmed endpoint answered non-array: a proxy
                    # blip, retried like a transport failure
                    last_err = RuntimeError(f"non-array response to JSON-RPC batch from {self.endpoint}")
                    if attempt + 1 < self.max_retries:
                        self._backoff("ChainReadObj[batch]", attempt, last_err)
                    continue
                with self._id_lock:
                    self._batch_ok = True
                self._metrics.count("rpc.batch_calls")
                self._metrics.count("rpc.batched_reads", len(cids))
                if attempt:
                    sp.set_attr("retries", attempt)
                by_id = {e.get("id"): e for e in body if isinstance(e, dict)}
                return [by_id.get(first_id + i) for i in range(len(cids))]
            self._metrics.count("rpc.failures")
            sp.set_attr("error", str(last_err))
        raise RuntimeError(f"RPC ChainReadObj[batch] failed after {self.max_retries} attempts") from last_err

    def _mark_batch_unsupported(self, sp) -> None:
        with self._id_lock:
            already = self._batch_ok is False
            self._batch_ok = False
        sp.set_attr("batch_unsupported", True)
        if not already:
            self._metrics.count("rpc.batch_unsupported")
            logger.info("endpoint %s rejects JSON-RPC batch framing — using sequential reads", self.endpoint)

    def chain_get_parent_receipts(self, block_cid: CID) -> Optional[list[dict]]:
        """A block's parent receipts as API JSON
        (`Filecoin.ChainGetParentReceipts`); convert each with
        `proofs.chain.receipt_from_api_json`."""
        return self.request("Filecoin.ChainGetParentReceipts", [{"/": str(block_cid)}])


class RpcBlockstore:
    """Read-only blockstore over `Filecoin.ChainReadObj`.

    Every `get()` verifies the returned bytes against the requested CID's
    multihash: a lying or bit-rotted endpoint raises `IntegrityError`
    instead of poisoning a witness (a client that sets
    ``verifies_integrity`` verifies per endpoint itself, and the store
    skips the second hash).

    `prefetch()` fills a shared cache dict with a wave of blocks: through an
    attached `FetchPlane` (``attach_plane``) when there is one, else as
    batch round-trips when the client speaks batch framing, else over a
    thread pool, one call per block. All three fail SOFT: per-CID failures
    are collected and returned, since the demand path refetches (and
    re-raises) on a miss.
    """

    def __init__(self, client: LotusClient, prefetch_workers: int = 16, metrics=None):
        self._client = client
        self._prefetch_workers = prefetch_workers
        self._plane = None  # optional FetchPlane (attach_plane)
        if metrics is None:
            metrics = getattr(client, "_metrics", None)
        if metrics is None:
            from ipc_proofs_tpu_torch.utils.metrics import get_metrics

            metrics = get_metrics()
        self._metrics = metrics

    def get(self, cid: CID) -> Optional[bytes]:
        data = self._client.chain_read_obj(cid)
        if data is None:
            return None
        if not getattr(self._client, "verifies_integrity", False):
            if not verify_block_bytes(cid, data):
                self._metrics.count("rpc.integrity_failures")
                raise IntegrityError(cid, getattr(self._client, "endpoint", "?"))
        return data

    def get_many(self, cids: "list[CID]") -> "list[Optional[bytes]]":
        """Batched `get`: one (or few) round-trips when the client speaks
        batch framing, sequential otherwise; every returned block verified."""
        reader = getattr(self._client, "chain_read_obj_many", None)
        if reader is not None:
            blocks = reader(list(cids))
        else:
            blocks = [self._client.chain_read_obj(c) for c in cids]
        if not getattr(self._client, "verifies_integrity", False):
            for cid, data in zip(cids, blocks):
                if data is not None and not verify_block_bytes(cid, data):
                    self._metrics.count("rpc.integrity_failures")
                    raise IntegrityError(cid, getattr(self._client, "endpoint", "?"))
        return blocks

    def put_keyed(self, cid: CID, data: bytes) -> None:
        raise NotImplementedError("RpcBlockstore is read-only")

    def has(self, cid: CID) -> bool:
        return self.get(cid) is not None

    @property
    def client(self):
        """The underlying client: the fetch-plane wiring needs the client,
        not this store wrapper."""
        return self._client

    def attach_plane(self, plane) -> None:
        """Route future `prefetch` waves through a `FetchPlane`'s want-queue
        (so they batch and coalesce with demand fetches)."""
        self._plane = plane

    def offer_links(self, links: "Iterable[CID]") -> None:
        """Walker speculation hook: meaningful only with an attached plane
        (otherwise the links are dropped: this store has no queue)."""
        if self._plane is not None:
            self._plane.offer_links(links)

    def prefetch(self, cids: Iterable[CID], into: dict) -> "dict[CID, Exception]":
        """Fetch ``cids`` into the shared cache dict ``into``; returns a
        (possibly empty) map of CID → exception for the fetches that failed."""
        todo = [c for c in cids if c not in into]
        if not todo:
            return {}
        if self._plane is not None:
            failures = self._plane.fetch_into(todo, into)
        elif getattr(self._client, "chain_read_obj_many", None) is not None:
            failures = self._prefetch_batched(todo, into)
        else:
            failures = self._prefetch_pooled(todo, into)
        if failures:
            self._metrics.count("rpc.prefetch_failures", len(failures))
            logger.warning(
                "prefetch: %d/%d block fetches failed (demand path will re-fetch)", len(failures), len(todo)
            )
        return failures

    # blocks per batched prefetch round-trip: large enough to amortise the
    # round-trip, small enough that one bad id cannot stall a whole wave
    _PREFETCH_BATCH = 64

    def _prefetch_batched(self, todo: "list[CID]", into: dict) -> "dict[CID, Exception]":
        """Prefetch as batch round-trips on the calling thread."""
        failures: dict = {}
        for start in range(0, len(todo), self._PREFETCH_BATCH):
            chunk = todo[start : start + self._PREFETCH_BATCH]
            try:
                blocks = self.get_many(chunk)
            except VerifyLaneError:
                raise  # the pool's lane faulted: the card's fault, not a fetch error
            except Exception:  # fail-soft: prefetch is advisory — retry the chunk per CID so one bad block only fails itself
                blocks = None
            if blocks is not None:
                for cid, data in zip(chunk, blocks):
                    if data is not None:
                        into[cid] = data
                continue
            for cid in chunk:
                try:
                    data = self.get(cid)
                except Exception as exc:  # fail-soft: prefetch is advisory — collected, refetched on demand
                    failures[cid] = exc
                    continue
                if data is not None:
                    into[cid] = data
        return failures

    def _prefetch_pooled(self, todo: "list[CID]", into: dict) -> "dict[CID, Exception]":
        """One call per block over a thread pool (clients without
        `chain_read_obj_many`, e.g. bare test fakes). The caller's trace
        context hops to the pool's threads, so their ``rpc.*`` spans stay
        in the caller's tree."""
        lock = named_lock("rpc.prefetch_failures")
        failures: dict = {}
        ctx = current_context()

        def fetch(cid: CID) -> None:
            try:
                with use_context(ctx):
                    data = self.get(cid)
            except Exception as exc:  # fail-soft: prefetch is advisory — collected, refetched on demand
                with lock:
                    failures[cid] = exc
                return
            if data is not None:
                with lock:
                    into[cid] = data

        with ThreadPoolExecutor(max_workers=self._prefetch_workers) as pool:
            list(pool.map(fetch, todo))
        return failures
