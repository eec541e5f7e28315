"""Seeded, deterministic fault injection for the RPC/blockstore stack.

The counterpart of ``ipc_proofs_tpu.store.faults``, and the hermetic Lotus
node that the port's tests and its smoke run on the card serve from.

The chaos methodology here is *differential*: run the same proof request
twice — once fault-free, once under a seeded `FaultPlan` — and assert the
faulted run either produces a bundle byte-identical to the clean run or
raises a typed error (`IntegrityError` / `RpcError` / `RuntimeError` /
transport errors). A silently *different* bundle is the one unacceptable
outcome, because a wrong witness verifies locally and lies remotely.

Layers:

- `FaultPlan` — a seed mapped to a per-call schedule of fault kinds
  (transport error, timeout, added latency, truncated result, bit-flipped
  block bytes). Deterministic given seed + call order.
- `FaultySession` — wraps any ``.post``-shaped session and applies the
  plan at the HTTP boundary, so the REAL `LotusClient` retry/backoff and
  the fetch plane's integrity code paths are exercised.
- `LocalLotusSession` — a hermetic in-process "Lotus node": serves
  `Filecoin.ChainReadObj` (and canned responses) straight from a
  `Blockstore`, JSON-RPC-shaped, no sockets. Compose with `FaultySession`
  for offline chaos runs against the production client stack.
- `FaultyBlockstore` — store-level injection for components that take a
  blockstore rather than a session.
"""

from __future__ import annotations

import base64
import json
import random
import time
from typing import Optional

from ipc_proofs_tpu_torch.core.cid import CID
from ipc_proofs_tpu_torch.utils.lockdep import named_lock

__all__ = [
    "FAULT_KINDS",
    "FaultPlan",
    "FaultySession",
    "FaultyBlockstore",
    "LocalLotusSession",
]

FAULT_KINDS = ("transport", "timeout", "latency", "truncate", "bitflip")


class FaultPlan:
    """Seed → deterministic per-call fault schedule.

    Each call site asks ``draw()`` whether this call is faulted and with
    what kind. The sequence of answers is a pure function of the seed and
    the draw order (thread-safe, but concurrent callers race for positions
    in the sequence — single-threaded drivers get bit-reproducible
    schedules, which is what the differential tests use).
    """

    def __init__(
        self,
        seed: int,
        fault_rate: float = 0.1,
        kinds: "tuple[str, ...]" = FAULT_KINDS,
        latency_s: float = 0.001,
        max_faults: Optional[int] = None,
    ):
        for k in kinds:
            if k not in FAULT_KINDS:
                raise ValueError(f"unknown fault kind {k!r}")
        self.seed = seed
        self.fault_rate = fault_rate
        self.kinds = tuple(kinds)
        self.latency_s = latency_s
        self.max_faults = max_faults
        self._lock = named_lock("FaultPlan._lock")
        self.faults_injected = 0  # guarded-by: _lock
        self.calls_seen = 0  # guarded-by: _lock
        self.by_kind: dict[str, int] = {}  # guarded-by: _lock
        self._rng = random.Random(f"faultplan:{seed}")  # guarded-by: _lock

    def draw(self) -> Optional[str]:
        """One schedule step: returns a fault kind or None (no fault)."""
        with self._lock:
            self.calls_seen += 1
            if self.max_faults is not None and self.faults_injected >= self.max_faults:
                return None
            if self._rng.random() >= self.fault_rate:
                return None
            kind = self._rng.choice(self.kinds)
            self.faults_injected += 1
            self.by_kind[kind] = self.by_kind.get(kind, 0) + 1
            return kind

    def randrange(self, n: int) -> int:
        """Deterministic index draw (bit positions, byte offsets)."""
        with self._lock:
            return self._rng.randrange(n)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "seed": self.seed,
                "fault_rate": self.fault_rate,
                "calls_seen": self.calls_seen,
                "faults_injected": self.faults_injected,
                "by_kind": dict(self.by_kind),
            }


def _flip_bit(b64: str, plan: FaultPlan) -> str:
    """Flip one deterministic bit inside a base64 block payload."""
    raw = bytearray(base64.b64decode(b64))
    if not raw:
        return b64
    raw[plan.randrange(len(raw))] ^= 1 << plan.randrange(8)
    return base64.b64encode(bytes(raw)).decode("ascii")


class _Response:
    """Minimal requests.Response stand-in."""

    def __init__(self, body: dict):
        self._body = body

    def raise_for_status(self) -> None:
        pass

    def json(self) -> dict:
        return self._body


class FaultySession:
    """``.post`` wrapper that applies a `FaultPlan` at the HTTP boundary.

    Transport/timeout faults raise before the inner session is consulted;
    latency sleeps then passes through; truncate/bitflip mutate the
    *result* of a successful inner call (block reads get corrupted bytes —
    exactly what a lying node looks like to the client).
    """

    def __init__(self, inner, plan: FaultPlan, sleep=time.sleep):
        self._inner = inner
        self.plan = plan
        self._sleep = sleep

    def post(self, url, data=None, headers=None, timeout=None):
        method = ""
        is_batch = False
        try:
            req = json.loads(data) if data else {}
            if isinstance(req, list):
                is_batch = True
                method = req[0].get("method", "") if req else ""
            else:
                method = req.get("method", "")
        except (ValueError, AttributeError):
            pass
        fault = self.plan.draw()
        if fault == "transport":
            raise ConnectionError(f"injected transport fault ({method})")
        if fault == "timeout":
            raise TimeoutError(f"injected timeout ({method})")
        if fault == "latency":
            self._sleep(self.plan.latency_s)
        resp = self._inner.post(url, data=data, headers=headers, timeout=timeout)
        if fault not in ("truncate", "bitflip"):
            return resp
        if is_batch:
            body = resp.json()
            if not isinstance(body, list) or not body:
                return resp  # endpoint rejected the batch — nothing to corrupt
            # corrupt ONE deterministic entry of the batch: what a lying or
            # mid-body-dropped connection does to batch framing, and what
            # exercises the client's per-id error demux
            entries = [dict(e) for e in body]
            self._corrupt_entry(entries[self.plan.randrange(len(entries))], fault, method)
            return _Response(entries)
        body = dict(resp.json())
        self._corrupt_entry(body, fault, method)
        return _Response(body)

    def _corrupt_entry(self, body: dict, fault: str, method: str) -> None:
        result = body.get("result")
        if fault == "truncate":
            # half the payload for strings, else a null result — both are
            # what a connection dropped mid-body looks like after decode
            body["result"] = result[: len(result) // 2] if isinstance(result, str) else None
        elif isinstance(result, str) and method == "Filecoin.ChainReadObj":
            body["result"] = _flip_bit(result, self.plan)


class FaultyBlockstore:
    """Store-level fault injection for blockstore-shaped consumers.

    ``transport``/``timeout`` raise, ``latency`` sleeps, ``truncate``
    returns None (miss), ``bitflip`` returns corrupted bytes — the last
    one deliberately UNVERIFIED, to prove that a verifying layer above
    (RpcBlockstore, the fetch plane) catches it.
    """

    def __init__(self, inner, plan: FaultPlan, sleep=time.sleep):
        self._inner = inner
        self.plan = plan
        self._sleep = sleep

    def get(self, cid: CID) -> Optional[bytes]:
        fault = self.plan.draw()
        if fault == "transport":
            raise ConnectionError(f"injected transport fault ({cid})")
        if fault == "timeout":
            raise TimeoutError(f"injected timeout ({cid})")
        if fault == "latency":
            self._sleep(self.plan.latency_s)
        data = self._inner.get(cid)
        if data is None:
            return None
        if fault == "truncate":
            return None
        if fault == "bitflip":
            raw = bytearray(data)
            raw[self.plan.randrange(len(raw))] ^= 1 << self.plan.randrange(8)
            return bytes(raw)
        return data

    def has(self, cid: CID) -> bool:
        return self._inner.has(cid)

    def put_keyed(self, cid: CID, data: bytes) -> None:
        self._inner.put_keyed(cid, data)


class LocalLotusSession:
    """Hermetic in-process Lotus node speaking ``.post``-shaped JSON-RPC.

    Serves `Filecoin.ChainReadObj` from ``store`` (base64, like the real
    API) and anything in ``responses``: a value verbatim, or a callable
    ``handler(params)``'s result (e.g. `Filecoin.ChainGetTipSetByHeight`
    answered per height); unknown methods return a
    JSON-RPC "method not found" error. JSON-RPC batch arrays are answered
    with a response array (shuffled deterministically — real servers answer
    out of id order, which is what the client's demux must survive) unless
    ``batch=False``, which models an old gateway: array payloads get a
    single "invalid request" error object, concluding the client's
    capability probe negative. Lets chaos tests drive the REAL
    `LotusClient` → `FetchPlane` / `RpcBlockstore` stack with zero
    network.
    """

    def __init__(self, store, responses: Optional[dict] = None, batch: bool = True):
        self._store = store
        self._responses = dict(responses or {})
        self._batch = batch
        self.calls = 0
        self.batch_calls = 0
        self._shuffle = random.Random("locallotus:batch-order")

    def post(self, url, data=None, headers=None, timeout=None):
        self.calls += 1
        req = json.loads(data)
        if isinstance(req, list):
            if not self._batch:
                return _Response({
                    "jsonrpc": "2.0",
                    "error": {"code": -32600, "message": "batch requests not supported"},
                    "id": None,
                })
            self.batch_calls += 1
            replies = [self._answer(one) for one in req]
            self._shuffle.shuffle(replies)
            return _Response(replies)
        return _Response(self._answer(req))

    def _answer(self, req: dict) -> dict:
        method, params, req_id = req.get("method"), req.get("params", []), req.get("id")
        if method == "Filecoin.ChainReadObj":
            cid = CID.from_string(params[0]["/"])
            block = self._store.get(cid)
            result = base64.b64encode(block).decode("ascii") if block is not None else None
            return {"jsonrpc": "2.0", "result": result, "id": req_id}
        if method in self._responses:
            handler = self._responses[method]
            result = handler(params) if callable(handler) else handler
            return {"jsonrpc": "2.0", "result": result, "id": req_id}
        return {
            "jsonrpc": "2.0",
            "error": {"code": -32601, "message": f"method '{method}' not found"},
            "id": req_id,
        }
