"""The port's in-process serve plane (`serve/`) against the JAX package.

The port runs on ``device="cpu"`` (the kernels' plain versions); the JAX
package on its host paths. Batching is checked by counters, never by wall
time.

- verify micro-batching: concurrent mixed requests get the reference
  service's verdicts and the sequential baseline's, with CIDs off and on;
  the CID batches are one per merged batch; a tampered request poisons no
  neighbour; conflicting witnesses split into counted sub-merges;
- admission: backpressure, drain, deadlines and cancellation are typed as
  in the reference; the three lanes and the tenants' fair queue drain in
  the reference's order;
- QoS: `FairQueue` order, `TokenBucket` / `TenantQoS` refusals and
  `GradientLimiter` steps under an injected clock equal the reference's;
- generate: responses equal the reference service's bundle JSON per pair,
  equal generating each pair alone, and verify; a job dir adds
  ``journal_ms``; range windows (with storage specs: the slot keccaks) and
  ``generate_range`` give the reference's bytes, and a failing window
  reaches only its own caller;
- wiring: the fetch plane in memory and disk modes, one backend for every
  engine, the autotune rule (an ``OSError`` lets the service start, a
  ``RuntimeError`` propagates), the card as the default;
- the registry: a registry-backed service seals the reference's leaf
  hashes, and its base cache is the fleet directory.
"""

import ast
import dataclasses
import json
import sys
import threading
import time
from pathlib import Path

import pytest
import torch

jax = pytest.importorskip("jax")

import ipc_proofs_tpu.serve.qos as ref_qos  # noqa: E402
import ipc_proofs_tpu_torch.serve.qos as port_qos  # noqa: E402
from ipc_proofs_tpu.fixtures import ContractFixture as RefContract  # noqa: E402
from ipc_proofs_tpu.fixtures import EventFixture as RefEvent  # noqa: E402
from ipc_proofs_tpu.fixtures import build_chain as ref_build_chain  # noqa: E402
from ipc_proofs_tpu.fixtures import build_range_world as ref_build_range_world  # noqa: E402
from ipc_proofs_tpu.proofs.bundle import UnifiedProofBundle as RefBundle  # noqa: E402
from ipc_proofs_tpu.proofs.generator import EventProofSpec as RefSpec  # noqa: E402
from ipc_proofs_tpu.proofs.generator import StorageProofSpec as RefStorageSpec  # noqa: E402
from ipc_proofs_tpu.proofs.generator import generate_proof_bundle as ref_generate_proof_bundle  # noqa: E402
from ipc_proofs_tpu.proofs.range import TipsetPair as RefPair  # noqa: E402
from ipc_proofs_tpu.proofs.storage_batch import MappingSlotSpec as RefSlotSpec  # noqa: E402
from ipc_proofs_tpu.serve.batcher import MicroBatcher as RefMicroBatcher  # noqa: E402
from ipc_proofs_tpu.serve.service import ProofService as RefProofService  # noqa: E402
from ipc_proofs_tpu.serve.service import ServiceConfig as RefServiceConfig  # noqa: E402
from ipc_proofs_tpu.serve.service import sequential_verify_baseline as ref_sequential  # noqa: E402
from ipc_proofs_tpu.utils.metrics import Metrics as RefMetrics  # noqa: E402
from ipc_proofs_tpu.witness import WitnessOptions as RefWitnessOptions  # noqa: E402
from ipc_proofs_tpu.witness import encode_bundle_fields as ref_encode_bundle_fields  # noqa: E402
from ipc_proofs_tpu_torch.backend import get_backend  # noqa: E402
from ipc_proofs_tpu_torch.fixtures import ContractFixture, EventFixture, build_chain, build_range_world  # noqa: E402
from ipc_proofs_tpu_torch.ops import verify as verify_mod  # noqa: E402
from ipc_proofs_tpu_torch.proofs.bundle import EventProof, ProofBlock, UnifiedProofBundle  # noqa: E402
from ipc_proofs_tpu_torch.proofs.generator import EventProofSpec, StorageProofSpec, generate_proof_bundle  # noqa: E402
from ipc_proofs_tpu_torch.proofs.range import (  # noqa: E402
    TipsetPair,
    generate_event_proofs_for_range,
    generate_event_proofs_for_range_chunked,
)
from ipc_proofs_tpu_torch.proofs.storage_batch import MappingSlotSpec  # noqa: E402
from ipc_proofs_tpu_torch.proofs.trust import TrustPolicy  # noqa: E402
from ipc_proofs_tpu_torch.proofs.verifier import verify_proof_bundle  # noqa: E402
from ipc_proofs_tpu_torch.serve import (  # noqa: E402
    DeadlineExceededError,
    MicroBatcher,
    ProofService,
    QueueFullError,
    ServiceClosedError,
    ServiceConfig,
    sequential_verify_baseline,
)
from ipc_proofs_tpu_torch.state.storage import calculate_storage_slot  # noqa: E402
from ipc_proofs_tpu_torch.store.blockstore import CachedBlockstore  # noqa: E402
from ipc_proofs_tpu_torch.store.faults import LocalLotusSession  # noqa: E402
from ipc_proofs_tpu_torch.store.rpc import LotusClient, RpcBlockstore  # noqa: E402
from ipc_proofs_tpu_torch.storex import TieredBlockstore  # noqa: E402
from ipc_proofs_tpu_torch.utils.deadline import CancelledError, CancelScope, DeadlineError  # noqa: E402
from ipc_proofs_tpu_torch.utils.metrics import Metrics  # noqa: E402
from ipc_proofs_tpu_torch.witness import WitnessOptions, encode_bundle_fields  # noqa: E402
from ipc_proofs_tpu_torch.witness.bases import FleetBaseCache as PortFleetBaseCache  # noqa: E402

SIG = "NewTopDownMessage(bytes32,uint256)"
SUBNET = "calib-subnet-1"
ACTOR = 1001
SLOT = calculate_storage_slot(SUBNET, 0)
CPU = dict(device="cpu")
T0 = 1_700_000_000.0
ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def cpu():
    return get_backend("gpu", device="cpu")


@pytest.fixture(scope="module")
def chains():
    def make(contract, event, build):
        return build(
            [contract(actor_id=ACTOR, storage={SLOT: (42).to_bytes(2, "big")})],
            [[event(emitter=ACTOR, signature=SIG, topic1=SUBNET, data=i.to_bytes(32, "big"))] for i in range(16)],
        )

    return make(ContractFixture, EventFixture, build_chain), make(RefContract, RefEvent, ref_build_chain)


@pytest.fixture(scope="module")
def full(chains, cpu):
    world, ref_world = chains
    port = generate_proof_bundle(
        world.store, world.parent, world.child,
        [StorageProofSpec(actor_id=ACTOR, slot=SLOT)],
        [EventProofSpec(event_signature=SIG, topic_1=SUBNET, actor_id_filter=ACTOR)],
        match_backend=cpu,
    )
    ref = ref_generate_proof_bundle(
        ref_world.store, ref_world.parent, ref_world.child,
        [RefStorageSpec(actor_id=ACTOR, slot=SLOT)],
        [RefSpec(event_signature=SIG, topic_1=SUBNET, actor_id_filter=ACTOR)],
    )
    assert port.to_json() == ref.to_json()
    return port


def _to_ref(bundle):
    return RefBundle.from_json_obj(bundle.to_json_obj())


def _requests(full, n):
    """n single-proof request bundles (the per-client request shape), mixing
    event and storage proofs, all sharing the generated witness."""
    reqs = []
    for i in range(n):
        if i % 5 == 4:
            reqs.append(UnifiedProofBundle(list(full.storage_proofs), [], full.blocks))
        else:
            reqs.append(UnifiedProofBundle([], [full.event_proofs[i % len(full.event_proofs)]], full.blocks))
    return reqs


def _verdicts(responses):
    return [(r.storage_results, r.event_results) for r in responses]


def _concurrently(fn, n):
    out = [None] * n

    def client(i):
        out[i] = fn(i)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
        assert not t.is_alive()
    return out


class _CountingBackend:
    """Counts the CID batches (witness recompute) and blake2b batches of
    the service's own backend instance."""

    def __init__(self, monkeypatch, backend):
        self.cid_batches = 0
        self.blake2b_batches = 0
        verify_block_cids, blake2b256_batch = backend.verify_block_cids, backend.blake2b256_batch

        def counted_cids(digests, blocks):
            self.cid_batches += 1
            return verify_block_cids(digests, blocks)

        def counted_blake2b(messages):
            self.blake2b_batches += 1
            return blake2b256_batch(messages)

        monkeypatch.setattr(backend, "verify_block_cids", counted_cids)
        monkeypatch.setattr(backend, "blake2b256_batch", counted_blake2b)


# --------------------------------------------------------------------------
# verify micro-batching
# --------------------------------------------------------------------------


@pytest.mark.parametrize("cids", [False, True], ids=["cids-off", "cids-on"])
def test_concurrent_mixed_requests_equal_reference_and_sequential(monkeypatch, full, cpu, cids):
    reqs = _requests(full, 24)
    ref_reqs = [_to_ref(r) for r in reqs]
    expected = _verdicts(sequential_verify_baseline(reqs, cid_backend=cpu))
    assert expected == _verdicts(ref_sequential(ref_reqs))
    counting = _CountingBackend(monkeypatch, cpu)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # more thread interleavings than the default
    try:
        with ProofService(config=ServiceConfig(max_batch=8, max_wait_ms=50.0, workers=2,
                                               verify_witness_cids=cids, **CPU)) as svc:
            got = _concurrently(lambda i: svc.verify(reqs[i]), len(reqs))
            batches = svc.metrics.counter_value("serve.batches.verify")
    finally:
        sys.setswitchinterval(switch)
    with RefProofService(config=RefServiceConfig(max_batch=8, max_wait_ms=50.0, workers=2,
                                                 verify_witness_cids=cids)) as ref_svc:
        ref_got = _concurrently(lambda i: ref_svc.verify(ref_reqs[i]), len(reqs))
    assert _verdicts(got) == expected == _verdicts(ref_got)
    assert any(r.batch_size > 1 for r in got) and batches < len(reqs)
    # one witness CID batch per merged batch, one TxMeta batch at most
    assert counting.cid_batches == (batches if cids else 0)
    txmeta = counting.blake2b_batches - counting.cid_batches
    assert 1 <= txmeta <= batches


def test_tampered_request_poisons_no_neighbour(full):
    bad_obj = json.loads(json.dumps(full.event_proofs[1].to_json_obj()))
    bad_obj["event_data"]["data"] = "0x" + "ff" * 32
    good = UnifiedProofBundle([], [full.event_proofs[0]], full.blocks)
    bad = UnifiedProofBundle([], [EventProof.from_json_obj(bad_obj)], full.blocks)
    outcomes = []
    for service, cfg, conv in ((ProofService, ServiceConfig, lambda b: b),
                               (RefProofService, RefServiceConfig, _to_ref)):
        kw = CPU if service is ProofService else {}
        with service(config=cfg(max_batch=3, max_wait_ms=500.0, **kw)) as svc:
            pendings = [svc.submit_verify(conv(b)) for b in (good, bad, good)]
            got = [p.result(timeout=60) for p in pendings]
        assert {r.batch_size for r in got} == {3}
        outcomes.append([r.event_results for r in got])
    assert outcomes[0] == outcomes[1] == [[True], [False], [True]]


def _outcome(pending):
    try:
        return ("ok", pending.result(timeout=60).event_results)
    except Exception as exc:  # noqa: BLE001 — the class is the outcome
        return ("raise", type(exc).__name__)


@pytest.mark.parametrize("cids", [False, True], ids=["cids-off", "cids-on"])
def test_conflicting_witnesses_split_into_counted_sub_merges(full, cids):
    honest = UnifiedProofBundle([], [full.event_proofs[0]], full.blocks)
    liar = UnifiedProofBundle(
        [], [full.event_proofs[0]],
        [ProofBlock._make(b.cid, b"\x00" * len(b.data)) if i == 0 else b for i, b in enumerate(full.blocks)],
    )
    results = []
    for service, cfg, conv in ((ProofService, ServiceConfig, lambda b: b),
                               (RefProofService, RefServiceConfig, _to_ref)):
        kw = CPU if service is ProofService else {}
        with service(config=cfg(max_batch=3, max_wait_ms=500.0, verify_witness_cids=cids, **kw)) as svc:
            pendings = [svc.submit_verify(conv(b)) for b in (honest, liar, honest)]
            outcomes = [_outcome(p) for p in pendings]
            merges = svc.metrics.snapshot()["timers"]["serve.verify_batch"]["calls"]
            results.append((outcomes, merges, svc.metrics.counter_value("serve.batches.verify")))
    assert results[0] == results[1]
    outcomes, merges, batches = results[0]
    assert outcomes[0] == outcomes[2] == ("ok", [True])
    assert merges == 2  # [honest, honest] and [liar]
    if cids:
        # the liar's sub-merge fails its CID recompute: its caller gets the
        # error, and the merge is not counted as a served batch
        assert outcomes[1] == ("raise", "ValueError") and batches == 1
    else:
        assert batches == 2


# --------------------------------------------------------------------------
# admission: backpressure, drain, deadlines, lanes
# --------------------------------------------------------------------------


def _gated(batcher_cls, metrics_cls, **kw):
    gate = threading.Event()
    order = []

    def flush(batch):
        gate.wait(30)
        for p in batch:
            order.append(p.payload)
            p.complete(p.payload)

    metrics = metrics_cls()
    batcher = batcher_cls(flush, metrics=metrics, **kw)
    return batcher, gate, order, metrics


def _wait_drained(batcher):
    deadline = time.monotonic() + 10
    while batcher.depth() > 0 and time.monotonic() < deadline:
        time.sleep(0.005)


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_full_queue_rejects_typed_and_never_blocks(pkg):
    cls, metrics_cls = (MicroBatcher, Metrics) if pkg == "port" else (RefMicroBatcher, RefMetrics)
    batcher, gate, _, metrics = _gated(cls, metrics_cls, max_batch=1, max_wait_ms=0.0, capacity=2, name="bp")
    first = batcher.submit("r0")
    _wait_drained(batcher)
    queued = [batcher.submit(f"r{i}") for i in (1, 2)]
    t0 = time.monotonic()
    for _ in range(3):
        with pytest.raises(Exception) as info:
            batcher.submit("r3")
        assert type(info.value).__name__ == "QueueFullError" and info.value.retry_after_s > 0
    assert time.monotonic() - t0 < 1.0
    assert metrics.counter_value("serve.rejected_full.bp") == 3
    gate.set()
    batcher.close(drain=True, timeout=30)
    assert [p.result(timeout=5) for p in [first] + queued] == ["r0", "r1", "r2"]
    with pytest.raises(Exception) as info:
        batcher.submit("late")
    assert type(info.value).__name__ == "ServiceClosedError"
    assert metrics.counter_value("serve.rejected_closed.bp") == 1


def test_port_errors_are_the_reference_shapes():
    assert issubclass(QueueFullError, RuntimeError) and issubclass(ServiceClosedError, RuntimeError)
    assert issubclass(DeadlineExceededError, DeadlineError)
    assert DeadlineExceededError("x").error_type == "deadline"
    assert issubclass(port_qos.TenantThrottledError, RuntimeError)
    assert port_qos.AdmitRejectedError(1.0).error_type == "admit_rejected"


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_lanes_drain_push_then_interactive_then_low(pkg):
    cls, metrics_cls = (MicroBatcher, Metrics) if pkg == "port" else (RefMicroBatcher, RefMetrics)
    batcher, gate, order, _ = _gated(cls, metrics_cls, max_batch=4, max_wait_ms=0.0, capacity=16, name="lanes")
    blocker = batcher.submit("blocker")
    _wait_drained(batcher)
    pendings = [batcher.submit(f"low{i}", lane="low") for i in range(3)]
    pendings += [batcher.submit(f"int{i}", tenant=f"t{i % 2}") for i in range(5)]
    pendings += [batcher.submit(f"push{i}", lane="push") for i in range(2)]
    with pytest.raises(ValueError):
        batcher.submit("x", lane="bulk")
    gate.set()
    batcher.close(drain=True, timeout=30)
    assert all(p.done() for p in pendings + [blocker])
    assert order == ["blocker", "push0", "push1", "int0", "int1", "int2", "int3", "int4", "low0", "low1", "low2"]


def test_lane_and_tenant_order_equals_the_reference():
    orders = []
    for cls, metrics_cls in ((MicroBatcher, Metrics), (RefMicroBatcher, RefMetrics)):
        batcher, gate, order, _ = _gated(cls, metrics_cls, max_batch=3, max_wait_ms=0.0, capacity=64,
                                         name="fair", tenant_weights={"heavy": 2})
        batcher.submit("blocker")
        _wait_drained(batcher)
        for i in range(8):
            batcher.submit(f"h{i}", tenant="heavy")
        for i in range(3):
            batcher.submit(f"l{i}", tenant="light")
            batcher.submit(f"a{i}")
        batcher.submit("p0", lane="push")
        batcher.submit("w0", low_priority=True)
        gate.set()
        batcher.close(drain=True, timeout=30)
        orders.append(order)
    assert orders[0] == orders[1]
    assert orders[0][:2] == ["blocker", "p0"] and orders[0][-1] == "w0"


def test_closed_service_rejects_and_drain_loses_nothing(full, cpu):
    svc = ProofService(config=ServiceConfig(max_batch=4, **CPU))
    svc.drain()
    svc.drain()  # idempotent
    with pytest.raises(ServiceClosedError):
        svc.submit_verify(UnifiedProofBundle([], [], full.blocks))
    assert svc.health() == {"status": "draining"}
    reqs = _requests(full, 20)
    expected = _verdicts(sequential_verify_baseline(reqs, cid_backend=cpu))
    svc = ProofService(config=ServiceConfig(max_batch=64, max_wait_ms=5000.0, workers=2, **CPU))
    pendings = [svc.submit_verify(r) for r in reqs]
    svc.drain(timeout=60)
    assert _verdicts(p.result(timeout=1) for p in pendings) == expected


def test_deadlines_and_cancellation_are_typed(full):
    req = UnifiedProofBundle([], [full.event_proofs[0]], full.blocks)
    with ProofService(config=ServiceConfig(max_batch=64, max_wait_ms=300.0, **CPU)) as svc:
        pending = svc.submit_verify(req, timeout_s=0.01)
        with pytest.raises(DeadlineExceededError) as info:
            pending.result(timeout=30)
        assert info.value.error_type == "deadline"
        scope = CancelScope()
        cancelled = svc.submit_verify(req, cancel_scope=scope)
        scope.cancel("client went away")
        with pytest.raises(CancelledError, match="client went away"):
            cancelled.result(timeout=30)
        assert svc.metrics.counter_value("serve.deadline_exceeded.verify") == 1
        assert svc.metrics.counter_value("serve.cancelled_inflight") == 1
    with ProofService(config=ServiceConfig(max_batch=4, max_wait_ms=30.0, **CPU)) as svc:
        assert svc.verify(req).event_results == [True]


# --------------------------------------------------------------------------
# QoS primitives under an injected clock
# --------------------------------------------------------------------------


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def test_fair_queue_order_equals_the_reference():
    class P:
        def __init__(self, tenant, i):
            self.tenant, self.i = tenant, i

    weights = {"a": 3, "b": 1}
    queues = (port_qos.FairQueue(weights), ref_qos.FairQueue(weights))
    pattern = ["a"] * 7 + ["b"] * 4 + ["c"] * 3 + [None] * 2 + ["a", "b"]
    out = ([], [])
    for i, tenant in enumerate(pattern):
        for q in queues:
            q.append(P(tenant, i))
        if i % 5 == 4:
            for q, o in zip(queues, out):
                o.append(q.popleft().i)
    for q, o in zip(queues, out):
        o.append(q.tenants())
        while len(q):
            o.append(q.popleft().i)
        with pytest.raises(IndexError):
            q.popleft()
    assert out[0] == out[1]


def test_token_buckets_refuse_alike():
    outcomes = []
    for qos in (port_qos, ref_qos):
        clock, metrics = _Clock(), (Metrics() if qos is port_qos else RefMetrics())
        limiter = qos.TenantQoS(rate=2.0, burst=3.0, metrics=metrics, max_tenants=2, clock=clock)
        got = []
        for step, tenant in enumerate(["x", "x", "x", "x", "y", "x", "z", "x", None, None, None, None]):
            clock.t += 0.1 if step % 4 else 0.6
            try:
                limiter.admit(tenant)
                got.append("ok")
            except qos.TenantThrottledError as exc:
                got.append(round(exc.retry_after_s, 9))
        bucket = qos.TokenBucket(rate=0.0, burst=1.0, now=0.0)
        got.append(bucket.take(0.0))
        got.append(bucket.take(5.0))
        got.append(metrics.snapshot()["counters"])
        outcomes.append(got)
        with pytest.raises(ValueError):
            qos.TenantQoS(rate=0.0)
        with pytest.raises(ValueError):
            qos.TenantQoS(rate=1.0, burst=0.5)
    assert outcomes[0] == outcomes[1]
    assert "ok" in outcomes[0] and any(isinstance(o, float) for o in outcomes[0])


def test_gradient_limiter_steps_equal_the_reference():
    traces = []
    for qos in (port_qos, ref_qos):
        clock, metrics = _Clock(), (Metrics() if qos is port_qos else RefMetrics())
        limiter = qos.GradientLimiter(initial=6, min_limit=2, max_limit=12, delay_budget_ms=100.0,
                                      tenant_weights={"paying": 1}, metrics=metrics, clock=clock)
        trace, held = [], []
        for step in range(160):
            clock.t += 0.003
            tenant = "paying" if step % 3 == 0 else None
            try:
                held.append(limiter.acquire(tenant))
            except qos.AdmitRejectedError as exc:
                trace.append(("shed", tenant, round(exc.retry_after_s, 9)))
            if len(held) > 4 or step % 7 == 0:
                slot = held.pop(0)
                # calm for 60 steps, overloaded for 60, calm again
                delay = 400.0 if 60 <= step < 120 else 5.0
                limiter.release(slot, queue_delay_ms=delay)
                limiter.release(slot, queue_delay_ms=delay)  # idempotent
            trace.append((limiter.limit, limiter.inflight))
        trace.append(round(limiter.retry_after_s(), 9))
        trace.append(metrics.snapshot()["counters"])
        traces.append(trace)
    assert traces[0] == traces[1]
    limits = [t[0] for t in traces[0] if isinstance(t, tuple) and t[0] != "shed"]
    assert max(limits) > 6 and min(limits) < 6  # it grew, then shrank


# --------------------------------------------------------------------------
# generate
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def range_worlds():
    kw = dict(receipts_per_pair=8, events_per_receipt=2, match_rate=0.2)
    return build_range_world(6, **kw), ref_build_range_world(6, **kw)


def _pair(pair, cls=TipsetPair):
    return cls(parent=pair.parent, child=pair.child)


def test_generate_responses_equal_the_reference_service(range_worlds, cpu):
    (bs, pairs, _), (ref_bs, ref_pairs, _) = range_worlds
    spec, ref_spec = EventProofSpec(SIG, SUBNET), RefSpec(SIG, SUBNET)
    with ProofService(store=bs, spec=spec, config=ServiceConfig(max_batch=8, max_wait_ms=1.0, **CPU)) as svc:
        solo_responses = [svc.generate(_pair(p)) for p in pairs]
    with RefProofService(store=ref_bs, spec=ref_spec, config=RefServiceConfig(max_batch=8, max_wait_ms=1.0)) as ref:
        ref_responses = [ref.generate(_pair(p, RefPair)) for p in ref_pairs]
    for got, want in zip(solo_responses, ref_responses):
        assert got.bundle.to_json() == want.bundle.to_json() and got.batch_size == want.batch_size == 1
    # concurrent clients: coalesced batches, each pair's claims as alone
    with ProofService(store=bs, spec=spec, config=ServiceConfig(max_batch=8, max_wait_ms=50.0, workers=2,
                                                                **CPU)) as svc:
        results = _concurrently(lambda i: svc.generate(_pair(pairs[i])), len(pairs))
        assert svc.metrics.counter_value("serve.batches.generate") < len(pairs)
    assert any(r.batch_size > 1 for r in results)
    for i, resp in enumerate(results):
        solo = generate_event_proofs_for_range(bs, [pairs[i]], spec, match_backend=cpu)
        assert [p.to_json_obj() for p in resp.bundle.event_proofs] == [p.to_json_obj() for p in solo.event_proofs]
        assert resp.bundle.event_proofs == solo_responses[i].bundle.event_proofs
        verdict = verify_proof_bundle(resp.bundle, TrustPolicy.accept_all(), verify_witness_cids=True,
                                      cid_backend=cpu)
        assert verdict.all_valid() and len(verdict.event_results) == len(solo.event_proofs)


def test_generate_disabled_without_store():
    with ProofService(config=ServiceConfig(**CPU)) as svc:
        for call in (lambda: svc.submit_generate(None), lambda: svc.submit_range_window([]),
                     lambda: svc.generate_range([])):
            with pytest.raises(RuntimeError, match="generate path disabled"):
                call()


def test_job_dir_generate_reports_journal_ms(tmp_path, range_worlds, cpu):
    (bs, pairs, _), _ = range_worlds
    spec = EventProofSpec(SIG, SUBNET)
    with ProofService(store=bs, spec=spec, config=ServiceConfig(
            max_batch=8, max_wait_ms=5.0, workers=1, range_job_dir=str(tmp_path), **CPU)) as svc:
        resp = svc.generate(_pair(pairs[0]))
        assert resp.server_timing.get("journal_ms", 0) > 0
        assert svc.metrics.counter_value("jobs.chunk_journal_us") > 0
        results = _concurrently(lambda i: svc.generate(_pair(pairs[i])), 4)
    assert len([p for p in tmp_path.iterdir() if p.name.startswith("batch-")]) >= 2
    for i, r in enumerate(results):
        solo = generate_event_proofs_for_range(bs, [pairs[i]], spec, match_backend=cpu)
        assert r.bundle.event_proofs == solo.event_proofs


@pytest.fixture(scope="module")
def mixed_worlds():
    kw = dict(receipts_per_pair=4, events_per_receipt=2, match_rate=0.25, base_height=7_000)
    return build_range_world(5, **kw), ref_build_range_world(5, **kw)


def test_range_windows_and_generate_range_equal_the_reference(mixed_worlds, range_worlds, cpu):
    (bs, pairs, _), (ref_bs, ref_pairs, _) = mixed_worlds
    # pairs of another world: their blocks are not in this store
    (_, stray, _), (_, ref_stray, _) = range_worlds
    specs = [MappingSlotSpec(ACTOR, SUBNET, 0), MappingSlotSpec(ACTOR, SUBNET, 1)]
    ref_specs = [RefSlotSpec(ACTOR, SUBNET, 0), RefSlotSpec(ACTOR, SUBNET, 1)]
    out = []
    for service, cfg, store, spec, world_pairs, strays, slot_specs, kw in (
        (ProofService, ServiceConfig, bs, EventProofSpec(SIG, SUBNET), pairs, stray, specs, CPU),
        (RefProofService, RefServiceConfig, ref_bs, RefSpec(SIG, SUBNET), ref_pairs, ref_stray, ref_specs, {}),
    ):
        with service(store=store, spec=spec, config=cfg(max_batch=8, max_wait_ms=5.0, **kw)) as svc:
            windows = [
                svc.submit_range_window(world_pairs[:3], storage_specs=slot_specs),
                svc.submit_range_window(strays[:1], lane="push"),
                svc.submit_range_window(world_pairs[2:], chunk_size=2),
            ]
            outcomes = []
            for w in windows:
                try:
                    outcomes.append(w.result(timeout=120).to_json())
                except Exception as exc:  # noqa: BLE001 — the class is the outcome
                    outcomes.append(type(exc).__name__)
            outcomes.append(svc.generate_range(world_pairs, chunk_size=2).to_json())
        out.append(outcomes)
    assert out[0] == out[1]
    assert out[0][1] == "KeyError"  # only the stray window failed
    first = UnifiedProofBundle.from_json(out[0][0])
    assert len(first.storage_proofs) == 6
    assert first.to_json() == generate_event_proofs_for_range_chunked(
        bs, pairs[:3], EventProofSpec(SIG, SUBNET), chunk_size=3, match_backend=cpu, storage_specs=specs
    ).to_json()


# --------------------------------------------------------------------------
# wiring: fetch plane, disk tier, autotune, the card
# --------------------------------------------------------------------------


def _rpc_world():
    bs, pairs, _ = build_range_world(3, receipts_per_pair=4, events_per_receipt=2, match_rate=0.5)
    metrics = Metrics()
    session = LocalLotusSession(bs)
    store = RpcBlockstore(LotusClient("http://serve-plane", session=session, metrics=metrics), metrics=metrics)
    return bs, pairs, EventProofSpec(SIG, SUBNET), store, session


@pytest.fixture
def autotune_calls(monkeypatch):
    calls = []
    monkeypatch.setattr(verify_mod, "autotune_crossover", lambda store_dir, **kw: calls.append((store_dir, kw)))
    monkeypatch.setattr(verify_mod, "_tuned_min_bytes", verify_mod._tuned_min_bytes)
    return calls


@pytest.mark.parametrize("mode", ["memory", "disk"])
def test_fetch_plane_wiring(tmp_path, autotune_calls, cpu, mode):
    bs, pairs, spec, store, session = _rpc_world()
    store_dir = str(tmp_path) if mode == "disk" else None
    with ProofService(store=store, spec=spec, config=ServiceConfig(
            max_batch=8, max_wait_ms=5.0, workers=1, store_dir=store_dir, **CPU)) as svc:
        assert svc.fetch_plane is not None and svc.fetch_plane._local is svc.blockstore
        assert isinstance(svc.blockstore, TieredBlockstore if store_dir else CachedBlockstore)
        # one backend for every engine of the service
        assert svc.match_backend is cpu and svc.fetch_plane._backend is cpu
        if store_dir:
            assert svc.disk_store._backend is cpu
            assert autotune_calls == [(store_dir, {"backend": cpu})]
        else:
            assert svc.disk_store is None and autotune_calls == []
        resp = svc.generate(_pair(pairs[0]))
        solo = generate_event_proofs_for_range(bs, [pairs[0]], spec, match_backend=cpu)
        assert resp.bundle.event_proofs == solo.event_proofs
        cold_calls = session.calls
        assert cold_calls > 0
        again = svc.generate(_pair(pairs[0]))
        assert session.calls == cold_calls  # landings deposited: a warm repeat makes no RPC call
        assert again.bundle.to_json() == resp.bundle.to_json()
        if store_dir:
            assert svc.disk_store.stats()["entries"] > 0
            block = resp.bundle.blocks[0]
            view = svc.read_block_slice(block.cid)
            assert view is not None and bytes(view) == block.data
            view.release()
        snap = svc.metrics_snapshot()
        assert "block_cache" in snap and ("disk_store" in snap) == bool(store_dir)


def test_batch_rpc_false_keeps_the_direct_path(autotune_calls):
    _, pairs, spec, store, _ = _rpc_world()
    with ProofService(store=store, spec=spec, config=ServiceConfig(
            max_batch=8, max_wait_ms=5.0, workers=1, batch_rpc=False, **CPU)) as svc:
        assert svc.fetch_plane is None
        assert svc.generate(_pair(pairs[0])).bundle.event_proofs
        assert svc.read_block_slice(pairs[0].child.cids[0]) is None  # no disk tier


def test_autotune_os_error_lets_the_service_start(tmp_path, monkeypatch, full):
    def unwritable(store_dir, **kw):
        raise PermissionError(13, "read-only store dir")

    monkeypatch.setattr(verify_mod, "autotune_crossover", unwritable)
    with ProofService(config=ServiceConfig(store_dir=str(tmp_path), max_wait_ms=1.0, **CPU)) as svc:
        assert svc.verify(UnifiedProofBundle([], [full.event_proofs[0]], full.blocks)).all_valid()


def test_autotune_device_fault_propagates(tmp_path, monkeypatch):
    def faulted(store_dir, **kw):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(verify_mod, "autotune_crossover", faulted)
    before = set(threading.enumerate())
    with pytest.raises(RuntimeError, match="illegal memory access"):
        ProofService(config=ServiceConfig(store_dir=str(tmp_path), **CPU))
    assert set(threading.enumerate()) <= before  # nothing of the service started


def test_autotune_persists_the_port_record(tmp_path, monkeypatch, cpu):
    monkeypatch.setattr(verify_mod, "_tuned_min_bytes", verify_mod._tuned_min_bytes)
    record = {"version": verify_mod._AUTOTUNE_VERSION, "min_bytes": 12345, "scalar_only": False, "samples": []}
    (tmp_path / "verify_autotune_cuda.json").write_text(json.dumps(record))
    with ProofService(config=ServiceConfig(store_dir=str(tmp_path), **CPU)):
        assert verify_mod._tuned_min_bytes == 12345  # loaded, not measured again


def test_the_service_defaults_to_the_card(monkeypatch, full):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    before = set(threading.enumerate())
    with pytest.raises(RuntimeError, match="CUDA"):
        ProofService()
    # the baseline's TxMeta recompute runs on the card unless given a backend
    with pytest.raises(RuntimeError, match="CUDA"):
        sequential_verify_baseline([UnifiedProofBundle([], [full.event_proofs[0]], full.blocks)])
    assert set(threading.enumerate()) <= before


def test_unknown_backend_name_raises():
    with pytest.raises(ValueError, match="unknown backend"):
        ProofService(config=ServiceConfig(match_backend="tpu", **CPU))


# --------------------------------------------------------------------------
# the registry
# --------------------------------------------------------------------------


def test_a_registry_backed_service_seals_the_reference_leaves(tmp_path, range_worlds):
    (bs, pairs, _), (ref_bs, ref_pairs, _) = range_worlds
    heads, logs, leaves = [], [], []
    for name, service, cfg, spec, world_pairs, pair_cls, encode, opts, kw in (
        ("port", ProofService, ServiceConfig, EventProofSpec(SIG, SUBNET), pairs, TipsetPair,
         encode_bundle_fields, WitnessOptions, CPU),
        ("ref", RefProofService, RefServiceConfig, RefSpec(SIG, SUBNET), ref_pairs, RefPair,
         ref_encode_bundle_fields, RefWitnessOptions, {}),
    ):
        reg_dir = tmp_path / name
        with service(store=(bs if name == "port" else ref_bs), spec=spec, config=cfg(
                max_batch=8, max_wait_ms=1.0, registry_dir=str(reg_dir), registry_owner="shard-0", **kw)) as svc:
            assert type(svc.witness_bases).__name__ == "FleetBaseCache"
            first = None
            for i, pair in enumerate(world_pairs):
                resp = svc.generate(_pair(pair, pair_cls))
                fields = encode(resp.bundle, opts(), bases=svc.witness_bases, metrics=svc.metrics)
                seq = svc.registry.append_served(
                    fields["digest"], key=f"pair:{i}", verdict="served", cids=resp.bundle.cid_set(), t=T0 + i,
                )
                assert seq == i
                first = first or (resp.bundle, fields["digest"])
            # a later request may name the first served bundle as its base
            delta = encode(first[0], opts(base_digest=first[1]), bases=svc.witness_bases, metrics=svc.metrics)
            assert "bundle_delta" in delta
            health = svc.health()
            assert health["registry"] == "ok" and health["registry_head"]["size"] == len(world_pairs)
            heads.append(svc.registry.head())
            leaves.append([svc.registry.inclusion_proof(s)["leaf"] for s in range(len(world_pairs))])
        logs.append((reg_dir / "reg-shard-0.log").read_bytes())
    assert heads[0] == heads[1] and leaves[0] == leaves[1] and logs[0] == logs[1]


def test_a_sibling_shard_resolves_the_base(tmp_path, range_worlds):
    (bs, pairs, _), _ = range_worlds
    spec = EventProofSpec(SIG, SUBNET)
    with ProofService(store=bs, spec=spec, config=ServiceConfig(
            max_wait_ms=1.0, registry_dir=str(tmp_path), registry_owner="s0", **CPU)) as s0:
        resp = s0.generate(_pair(pairs[1]))
        digest = resp.bundle.digest()
        s0.registry.append_served(digest, key="pair:1", cids=resp.bundle.cid_set(), t=T0)
        with ProofService(store=bs, spec=spec, config=ServiceConfig(
                max_wait_ms=1.0, registry_dir=str(tmp_path), registry_owner="s1", **CPU)) as s1:
            assert isinstance(s1.witness_bases, PortFleetBaseCache)
            assert s1.witness_bases.lookup(digest) == resp.bundle.cid_set()
            assert s1.metrics.counter_value("witness.fleet_base_hits") == 1
            assert s1.witness_bases.lookup("00" * 32) is None


# --------------------------------------------------------------------------
# names
# --------------------------------------------------------------------------


def test_counter_names_are_the_references():
    """Every counter and gauge name the port's serve, witness and registry
    modules emit as a constant is one the reference declares."""
    import ipc_proofs_tpu.utils.metrics as ref_metrics
    import ipc_proofs_tpu_torch

    root = Path(ipc_proofs_tpu_torch.__file__).resolve().parent
    emitted = set()
    for path in sorted((root / "serve").glob("*.py")) + sorted((root / "witness").glob("*.py")) + sorted(
            (root / "registry").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in ("count", "set_gauge", "observe")
                and node.args
                and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)
            ):
                emitted.add(node.args[0].value)
    declared = {
        n for name in dir(ref_metrics) if name.endswith(("_COUNTERS", "_GAUGES", "_HISTOGRAMS"))
        for n in getattr(ref_metrics, name)
    }
    assert emitted and emitted <= declared, sorted(emitted - declared)


def test_service_config_fields_are_the_references_but_one():
    port = {f.name for f in dataclasses.fields(ServiceConfig)}
    ref = {f.name for f in dataclasses.fields(RefServiceConfig)}
    assert port - ref == {"device"} and ref - port == {"batch_verify"}
