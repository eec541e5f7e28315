"""Chaos differential driver: the byte-identity-or-typed-error invariant.

Runs the pipelined range driver through the REAL client stack —
`LotusClient` (retries, jitter, retryable codes) → `EndpointPool`
(failover, breakers, integrity verification) → `RpcBlockstore` — against
hermetic in-process "Lotus nodes" (`store.faults.LocalLotusSession`)
wrapped in seeded fault injectors (`FaultySession`). For every fault seed
the run must either:

- produce a bundle **byte-identical** to the fault-free reference, or
- raise a **typed error** (`IntegrityError` / `RpcError` / `RuntimeError`
  / transport errors).

A bundle that differs from the reference ("divergent") or an exception
outside the typed set ("untyped") is a real bug — most critically, a
bit-flipped block that slipped past CID verification into a witness.

The counterpart of the reference's ``tools/chaos.py``, fault schedule for
fault schedule, with two changes. A fault of the card (`ops.build.is_device_fault`: a refused
launch, a verify-lane fault, a CUDA error) is its own outcome,
``device_fault``, which fails the grid: the reference's ``RuntimeError``
entry of `TYPED_ERRORS` would otherwise count it as a typed error. And
``fetch_plane=True`` puts a `store.fetchplane.FetchPlane` between the
driver and the pool, so the pool's batch reads land and verify on the
card's lane (`ops.verify.verify_blocks_batch`): the reference's wiring
reads block by block, each verified on the host, in both packages. The
plane's dispatcher threads draw faults in a scheduling-dependent order,
so only the reference wiring reproduces the reference's outcome per seed.

``main`` derives the wiring from the device: on the card it reads through
the fetch plane with the lane's crossover at 0 bytes (unless
``IPC_VERIFY_MIN_BYTES`` is set), so every landed wave's CIDs are
recomputed on the card; with ``--device cpu`` it keeps the reference's
wiring and its outcome per seed.

Usage:
    python -m ipc_proofs_tpu_torch.tools.chaos SEED [--runs N] [--pairs P]
        [--fault-rate R ...] [--quick] [--shards | --slow-shard]
        [--device cuda|cpu]

Importable: `tools.soak` registers `phase_chaos`, and
tests/test_torch_chaos.py drives `chaos_run` / `run_grid` over a pinned
seed grid against the reference's.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import random
import sys
import time

from ipc_proofs_tpu_torch.backend import get_backend
from ipc_proofs_tpu_torch.cluster import (
    ClusterRouter,
    LocalShard,
    ShardClient,
    ShardUnavailable,
)
from ipc_proofs_tpu_torch.fixtures import build_range_world
from ipc_proofs_tpu_torch.ops.build import is_device_fault
from ipc_proofs_tpu_torch.proofs.generator import EventProofSpec
from ipc_proofs_tpu_torch.proofs.range import (
    generate_event_proofs_for_range,
    generate_event_proofs_for_range_chunked,
    generate_event_proofs_for_range_pipelined,
)
from ipc_proofs_tpu_torch.serve.service import ServiceConfig
from ipc_proofs_tpu_torch.store.failover import EndpointPool
from ipc_proofs_tpu_torch.store.faults import FaultPlan, FaultySession, LocalLotusSession
from ipc_proofs_tpu_torch.store.fetchplane import FetchPlane, PlaneBlockstore
from ipc_proofs_tpu_torch.store.rpc import IntegrityError, LotusClient, RpcBlockstore, RpcError
from ipc_proofs_tpu_torch.tools import add_device_flag, backend_for, service_device
from ipc_proofs_tpu_torch.utils.metrics import Metrics
from ipc_proofs_tpu_torch.witness.errors import StreamAbortError
from ipc_proofs_tpu_torch.witness.stream import BundleStreamWriter, decode_bundle_stream

SIG, SUBNET, ACTOR = "NewTopDownMessage(bytes32,uint256)", "calib-subnet-1", 1001

# The complete set of acceptable failure types under fault injection.
# Anything else escaping the driver is an invariant violation — and so is
# a fault of the card, which `classify` asks about first.
TYPED_ERRORS = (
    IntegrityError,
    RpcError,
    RuntimeError,
    ConnectionError,
    TimeoutError,
    OSError,
)

OUTCOMES = ("identical", "typed_error", "divergent", "untyped_error", "device_fault")
VIOLATIONS = ("divergent", "untyped_error", "device_fault")


def classify(exc: BaseException, also: tuple = ()) -> "tuple[str, str]":
    """(outcome, error) for an exception that escaped a run: a fault of the
    card first, then the typed set (plus ``also``), else untyped."""
    if is_device_fault(exc):
        return "device_fault", f"{type(exc).__name__}: {exc}"
    if isinstance(exc, also + TYPED_ERRORS):
        return "typed_error", type(exc).__name__
    return "untyped_error", f"{type(exc).__name__}: {exc}"


def build_world(n_pairs: int = 12, receipts_per_pair: int = 4,
                events_per_receipt: int = 2, match_rate: float = 0.2, backend=None):
    """Hermetic range world + spec + fault-free reference bundle JSON.
    ``backend`` defaults to the card."""
    backend = backend if backend is not None else get_backend("gpu")
    store, pairs, _ = build_range_world(
        n_pairs, receipts_per_pair, events_per_receipt, match_rate,
        signature=SIG, topic1=SUBNET, actor_id=ACTOR,
    )
    spec = EventProofSpec(event_signature=SIG, topic_1=SUBNET, actor_id_filter=ACTOR)
    reference = generate_event_proofs_for_range(store, pairs, spec, match_backend=backend).to_json()
    return store, pairs, spec, reference


def chaos_run(
    store,
    pairs,
    spec,
    reference: str,
    seed: int,
    fault_rate: float = 0.2,
    n_endpoints: int = 2,
    chunk_size: int = 4,
    hedge_ms: "float | None" = None,
    max_retries: int = 3,
    backend=None,
    fetch_plane: bool = False,
) -> dict:
    """One seeded chaos run; returns {"outcome": ..., ...} where outcome is
    "identical" | "typed_error" | "divergent" | "untyped_error" |
    "device_fault" (the last three are invariant violations). ``backend``
    (default the card) runs the match and, with ``fetch_plane``, the
    pool's batch verification."""
    backend = backend if backend is not None else get_backend("gpu")
    metrics = Metrics()
    plans = [
        FaultPlan(seed * 101 + i, fault_rate=fault_rate) for i in range(n_endpoints)
    ]
    clients = [
        LotusClient(
            f"http://chaos-{i}",
            session=FaultySession(LocalLotusSession(store), plans[i], sleep=lambda s: None),
            metrics=metrics,
            max_retries=max_retries,
            backoff_base_s=0.0005,
            backoff_max_s=0.002,
            rng=random.Random(seed + i),
        )
        for i in range(n_endpoints)
    ]
    pool = EndpointPool(
        clients,
        breaker_threshold=3,
        breaker_reset_s=0.01,
        hedge_ms=hedge_ms,
        metrics=metrics,
        backend=backend,
    )
    plane = FetchPlane(pool, backend=backend, metrics=metrics) if fetch_plane else None
    reader = PlaneBlockstore(plane) if plane is not None else RpcBlockstore(pool, metrics=metrics)
    try:
        bundle = generate_event_proofs_for_range_pipelined(
            reader,
            pairs,
            spec,
            chunk_size=chunk_size,
            match_backend=backend,
            metrics=metrics,
            # one scan worker; over several chunks the record stage still
            # reads while the next chunk scans, so only a one-chunk run
            # draws its faults in a fixed order (in both packages)
            scan_threads=1,
            scan_retries=2,
            force_pipeline=True,
        )
    except Exception as exc:  # fail-soft: an escape IS the harness's finding, classified into the outcome
        outcome, error = classify(exc)
        out = {"outcome": outcome, "error": error, "faults": [p.snapshot() for p in plans]}
        if outcome == "typed_error":
            out["counters"] = metrics.snapshot()["counters"]
        return out
    finally:
        if plane is not None:
            plane.close()
        pool.close()
    outcome = "identical" if bundle.to_json() == reference else "divergent"
    return {
        "outcome": outcome,
        "faults": [p.snapshot() for p in plans],
        "counters": metrics.snapshot()["counters"],
    }


def run_grid(
    base_seed: int,
    runs: int = 20,
    fault_rates=(0.05, 0.3, 0.6),
    n_pairs: int = 12,
    log=lambda msg: None,
    receipts_per_pair: int = 4,
    events_per_receipt: int = 2,
    match_rate: float = 0.2,
    backend=None,
    fetch_plane: bool = False,
) -> dict:
    """Seed × fault-rate grid; returns a summary with per-outcome counts.

    ``ok`` is True iff no run was divergent, untyped or a device fault AND
    at least one run in each regime occurred somewhere (identical +
    typed/absorbed), so a vacuous all-crash or all-clean grid does not
    silently pass."""
    backend = backend if backend is not None else get_backend("gpu")
    store, pairs, spec, reference = build_world(
        n_pairs, receipts_per_pair, events_per_receipt, match_rate, backend=backend
    )
    counts = dict.fromkeys(OUTCOMES, 0)
    violations = []
    total_faults = 0
    bitflips = 0
    for rate in fault_rates:
        for k in range(runs):
            seed = base_seed + k
            res = chaos_run(store, pairs, spec, reference, seed, fault_rate=rate,
                            backend=backend, fetch_plane=fetch_plane)
            counts[res["outcome"]] += 1
            for f in res["faults"]:
                total_faults += f["faults_injected"]
                bitflips += f["by_kind"].get("bitflip", 0)
            if res["outcome"] in VIOLATIONS:
                violations.append({"seed": seed, "fault_rate": rate, **res})
            log(
                f"chaos seed={seed} rate={rate}: {res['outcome']} "
                f"({sum(f['faults_injected'] for f in res['faults'])} faults)"
            )
    ok = (
        not violations
        and counts["identical"] > 0  # faults absorbed at least once
        and total_faults > 0  # the schedule actually injected something
    )
    return {
        "ok": ok,
        "runs": runs * len(fault_rates),
        "counts": counts,
        "total_faults_injected": total_faults,
        "bitflips_injected": bitflips,
        "violations": violations,
    }


# ---------------------------------------------------------------------------
# Remote shard transport chaos: the same identical-or-typed invariant,
# pushed through the CLUSTER stack — ClusterRouter scatter/gather (both
# the buffered and the cut-through streamed door) over shard HTTP with a
# seeded schedule of drops, delays, and mid-chunk-stream truncations.
# ---------------------------------------------------------------------------


class ShardFaultPlan:
    """Seeded fault schedule for one shard's HTTP transport.

    Draw kinds: ``drop`` (connection never completes), ``delay`` (slow
    but correct answer), ``truncate`` (the response dies mid-flight —
    for a chunk stream, cut at a seeded byte offset so the router sees a
    torn frame or a missing trailer)."""

    KINDS = ("drop", "delay", "truncate")

    def __init__(self, seed: int, fault_rate: float = 0.2):
        self._rng = random.Random(seed)
        self.fault_rate = fault_rate
        self.faults_injected = 0
        self.by_kind: "dict[str, int]" = {}

    def draw(self) -> "str | None":
        if self._rng.random() >= self.fault_rate:
            return None
        kind = self._rng.choice(self.KINDS)
        self.faults_injected += 1
        self.by_kind[kind] = self.by_kind.get(kind, 0) + 1
        return kind

    def cut_point(self, n: int) -> int:
        # land INSIDE the stream (never 0 = before the magic, never n =
        # clean EOF at the trailer) so the relay must detect the tear
        return self._rng.randrange(1, n) if n > 1 else 0

    def snapshot(self) -> dict:
        return {
            "faults_injected": self.faults_injected,
            "by_kind": dict(self.by_kind),
        }


class ChaosShardClient(ShardClient):
    """`ShardClient` with a seeded fault plan on every round-trip.

    Faults surface exactly the way the real transport surfaces them:
    drops and buffered-body truncations raise `ShardUnavailable` (what
    `ShardClient` maps refused/reset/short-read sockets to); a streamed
    truncation hands the router a prefix of the real chunk stream, which
    the relay must classify as torn (integrity error or missing
    trailer), never forward as a complete document."""

    def __init__(self, name, base_url, plan: ShardFaultPlan, **kw):
        super().__init__(name, base_url, **kw)
        self.plan = plan

    def _pre(self, path: str) -> None:
        kind = self.plan.draw()
        if kind == "drop":
            raise ShardUnavailable(f"shard {self.name}: chaos drop {path}")
        if kind == "delay":
            time.sleep(0.002)
        self._pending_truncate = kind == "truncate"

    def post(self, path, body):
        self._pre(path)
        if self._pending_truncate:
            raise ShardUnavailable(
                f"shard {self.name}: chaos truncated response body {path}"
            )
        return super().post(path, body)

    def post_stream(self, path, body):
        self._pre(path)
        kind, payload = super().post_stream(path, body)
        if kind != "stream" or not self._pending_truncate:
            return kind, payload
        raw = payload.read()
        try:
            payload.close()
        except OSError:
            pass
        return "stream", io.BytesIO(raw[: self.plan.cut_point(len(raw))])


def build_shard_world(n_pairs: int = 6, n_shards: int = 2, backend=None):
    """Hermetic cluster world: live in-process shards (each a
    `ProofService` on ``backend``'s device, default the card) + the
    fault-free chunked reference (canonical JSON)."""
    backend = backend if backend is not None else get_backend("gpu")
    store, pairs, _ = build_range_world(
        n_pairs, 4, 2, 0.3, signature=SIG, topic1=SUBNET, actor_id=ACTOR,
    )
    spec = EventProofSpec(
        event_signature=SIG, topic_1=SUBNET, actor_id_filter=ACTOR
    )
    shards = [
        LocalShard(f"s{i}", store, pairs, spec, config=ServiceConfig(device=service_device(backend))).start()
        for i in range(n_shards)
    ]
    reference = json.dumps(
        generate_event_proofs_for_range_chunked(
            store, list(pairs), spec, chunk_size=3, match_backend=backend
        ).to_json_obj(),
        sort_keys=True,
    )
    return shards, pairs, reference


def chaos_shard_run(
    shards, pairs, reference: str, seed: int,
    fault_rate: float = 0.2, door: str = "buffered",
) -> dict:
    """One seeded run through a fresh router over the live shards.

    ``door`` is "buffered" (JSON scatter/gather) or "streamed" (the
    cut-through relay door, reassembled with the digest-checking client
    decoder). A shard's ``device`` answer — a 500 with ``error_type:
    device``, or a ``device`` abort chunk — is a ``device_fault``."""
    metrics = Metrics()
    plans = {
        s.name: ShardFaultPlan(seed * 211 + i, fault_rate=fault_rate)
        for i, s in enumerate(shards)
    }
    router = ClusterRouter(
        {s.name: ChaosShardClient(s.name, s.url, plans[s.name]) for s in shards},
        pairs, metrics=metrics, scrape_interval_s=60.0,
    )
    faults = [p.snapshot for p in plans.values()]  # bound methods: late snap
    idxs = list(range(len(pairs)))
    try:
        if door == "buffered":
            status, obj = router.generate_range(idxs, chunk_size=3)
            if status != 200:
                # the router typed the failure on the wire (503 + error)
                outcome = "device_fault" if obj.get("error_type") == "device" else "typed_error"
                return {
                    "outcome": outcome,
                    "error": f"http {status}: {obj.get('error', '?')}",
                    "faults": [f() for f in faults],
                }
            got = json.dumps(obj["bundle"], sort_keys=True)
        else:
            chunks: "list[bytes]" = []
            out = router.generate_range(
                idxs, chunk_size=3,
                writer_factory=lambda: BundleStreamWriter(
                    lambda bufs: chunks.extend(bytes(b) for b in bufs),
                    metrics=metrics,
                ),
            )
            assert out is None
            fields = decode_bundle_stream(b"".join(chunks))
            got = json.dumps(fields["bundle"], sort_keys=True)
    except Exception as exc:  # fail-soft: an escape IS the harness's finding, classified into the outcome
        outcome, error = classify(exc, also=(StreamAbortError,))
        if isinstance(exc, StreamAbortError) and exc.remote_error_type == "device":
            outcome, error = "device_fault", f"{type(exc).__name__}: {exc}"
        return {"outcome": outcome, "error": error, "faults": [f() for f in faults]}
    finally:
        router.close()
    outcome = "identical" if got == reference else "divergent"
    return {
        "outcome": outcome,
        "faults": [f() for f in faults],
        "counters": metrics.snapshot()["counters"],
    }


def run_shard_grid(
    base_seed: int,
    runs: int = 5,
    fault_rates=(0.1, 0.3, 0.6),
    n_pairs: int = 6,
    log=lambda msg: None,
    backend=None,
) -> dict:
    """Seed × fault-rate × door grid over the cluster transport."""
    shards, pairs, reference = build_shard_world(n_pairs=n_pairs, backend=backend)
    counts = dict.fromkeys(OUTCOMES, 0)
    violations = []
    total_faults = 0
    try:
        for rate in fault_rates:
            for k in range(runs):
                for door in ("buffered", "streamed"):
                    seed = base_seed + k
                    res = chaos_shard_run(
                        shards, pairs, reference, seed,
                        fault_rate=rate, door=door,
                    )
                    counts[res["outcome"]] += 1
                    n = sum(f["faults_injected"] for f in res["faults"])
                    total_faults += n
                    if res["outcome"] in VIOLATIONS:
                        violations.append(
                            {"seed": seed, "fault_rate": rate, "door": door,
                             **res}
                        )
                    log(
                        f"shard-chaos seed={seed} rate={rate} door={door}: "
                        f"{res['outcome']} ({n} faults)"
                    )
    finally:
        for s in shards:
            try:
                s.stop(timeout=10)
            except Exception:  # fail-soft: best-effort teardown; a shard that won't stop must not mask the grid verdict
                pass
    ok = (
        not violations
        and counts["identical"] > 0  # failover absorbed faults at least once
        and total_faults > 0  # the schedule actually injected something
    )
    return {
        "ok": ok,
        "runs": runs * len(fault_rates) * 2,
        "counts": counts,
        "total_faults_injected": total_faults,
        "violations": violations,
    }


# ---------------------------------------------------------------------------
# Slow-not-dead shard: a member that answers CORRECTLY but slowly must be
# quarantined by the router's latency-EWMA placement penalty (traffic
# steered away, `cluster.slow_quarantines` counted) without ever being
# marked dead — and every response must stay byte-identical (no faults
# are injected, only delay).
# ---------------------------------------------------------------------------


class SlowShardClient(ShardClient):
    """`ShardClient` that answers correctly after a fixed delay —
    slow-not-dead. The router must learn this through its dispatch-latency
    EWMA, not through failures (there are none)."""

    def __init__(self, name, base_url, delay_s: float, **kw):
        super().__init__(name, base_url, **kw)
        self.delay_s = delay_s
        self.calls = 0

    def post(self, path, body):
        self.calls += 1
        time.sleep(self.delay_s)
        return super().post(path, body)

    def post_stream(self, path, body):
        self.calls += 1
        time.sleep(self.delay_s)
        return super().post_stream(path, body)


def run_slow_shard_grid(
    base_seed: int,
    rounds: int = 10,
    n_pairs: int = 6,
    delay_s: float = 0.02,
    log=lambda msg: None,
    backend=None,
) -> dict:
    """Repeated buffered range requests against a 2-shard cluster where one
    shard is slow-not-dead. Verdict requires all three:

    - every response byte-identical to the fault-free reference (delay is
      not a fault — nothing may diverge or error),
    - ``cluster.slow_quarantines`` > 0 (the latency-EWMA term, not raw
      queue depth, drove placement off the slow shard at least once),
    - the slow shard is still alive at the end (quarantine ≠ death)."""
    shards, pairs, reference = build_shard_world(n_pairs=n_pairs, n_shards=2, backend=backend)
    metrics = Metrics()
    slow_name = shards[0].name
    clients = {
        s.name: (
            SlowShardClient(s.name, s.url, delay_s)
            if s.name == slow_name
            else ShardClient(s.name, s.url)
        )
        for s in shards
    }
    router = ClusterRouter(
        clients,
        pairs,
        metrics=metrics,
        scrape_interval_s=60.0,
        # one queue slot ≈ 2ms of latency: a 20ms-slow shard looks ~10
        # slots deep, comfortably past the steal threshold, while its raw
        # inflight stays 0 in this sequential driver — exactly the
        # EWMA-driven quarantine signature
        steal_threshold=3,
        steal_latency_unit_s=delay_s / 10.0,
    )
    idxs = list(range(len(pairs)))
    divergent = 0
    errors = []
    try:
        for r in range(rounds):
            try:
                status, obj = router.generate_range(idxs, chunk_size=2)
            except TYPED_ERRORS as exc:
                if is_device_fault(exc):
                    raise
                errors.append(f"{type(exc).__name__}: {exc}")
                continue
            if status != 200:
                errors.append(f"http {status}: {obj.get('error', '?')}")
                continue
            if json.dumps(obj["bundle"], sort_keys=True) != reference:
                divergent += 1
            snap = metrics.snapshot()["counters"]
            log(
                f"slow-shard round={r}: quarantines="
                f"{snap.get('cluster.slow_quarantines', 0)} "
                f"steals={snap.get('cluster.steals', 0)}"
            )
        _, health = router.cluster_status()
        slow_alive = bool(health["ring"].get(slow_name, {}).get("alive"))
    finally:
        router.close()
        for s in shards:
            try:
                s.stop(timeout=10)
            except Exception:  # fail-soft: best-effort teardown must not mask the verdict
                pass
    counters = metrics.snapshot()["counters"]
    quarantines = counters.get("cluster.slow_quarantines", 0)
    ok = (
        divergent == 0
        and not errors
        and quarantines > 0
        and slow_alive
    )
    return {
        "ok": ok,
        "rounds": rounds,
        "divergent": divergent,
        "errors": errors,
        "slow_quarantines": quarantines,
        "steals": counters.get("cluster.steals", 0),
        "slow_shard_alive": slow_alive,
        "slow_shard_calls": clients[slow_name].calls,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("seed", type=int, help="base seed for the fault grid")
    ap.add_argument("--runs", type=int, default=20, help="seeds per fault rate")
    ap.add_argument("--pairs", type=int, default=12)
    ap.add_argument(
        "--fault-rate", type=float, action="append", default=None,
        help="fault rates to sweep (repeatable; default 0.05 0.3 0.6)",
    )
    ap.add_argument("--quick", action="store_true", help="small world, fewer runs")
    ap.add_argument(
        "--shards", action="store_true",
        help="chaos the CLUSTER shard transport (drop/delay/truncate over "
        "shard HTTP, buffered and streamed doors) instead of the RPC stack",
    )
    ap.add_argument(
        "--slow-shard", action="store_true",
        help="slow-not-dead shard: verify the router's latency-EWMA "
        "quarantine steers traffic away (cluster.slow_quarantines) while "
        "every response stays byte-identical and the shard stays alive",
    )
    add_device_flag(ap)
    args = ap.parse_args(argv)
    backend = backend_for(args.device)
    on_card = backend.device.type == "cuda"
    if on_card:
        # the lane's default crossover keeps every wave of a world this
        # small on the host
        os.environ.setdefault("IPC_VERIFY_MIN_BYTES", "0")

    runs = 5 if args.quick and args.runs == 20 else args.runs
    n_pairs = 6 if args.quick else args.pairs
    rates = tuple(args.fault_rate) if args.fault_rate else (0.05, 0.3, 0.6)

    t0 = time.time()
    if args.slow_shard:
        summary = run_slow_shard_grid(
            args.seed, rounds=max(4, min(runs, 10)), n_pairs=6,
            log=lambda m: print(f"[{time.time()-t0:6.1f}s] {m}", flush=True),
            backend=backend,
        )
    elif args.shards:
        summary = run_shard_grid(
            args.seed, runs=min(runs, 5), fault_rates=rates, n_pairs=6,
            log=lambda m: print(f"[{time.time()-t0:6.1f}s] {m}", flush=True),
            backend=backend,
        )
    else:
        summary = run_grid(
            args.seed, runs=runs, fault_rates=rates, n_pairs=n_pairs,
            log=lambda m: print(f"[{time.time()-t0:6.1f}s] {m}", flush=True),
            backend=backend, fetch_plane=on_card,
        )
    print(json.dumps(summary, indent=2))
    if not summary["ok"]:
        print("CHAOS INVARIANT VIOLATED", file=sys.stderr)
        return 1
    print("CHAOS CLEAN")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
