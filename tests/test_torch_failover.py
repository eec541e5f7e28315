"""The port's endpoint pool (``store/failover.py``) held against the JAX
package's, over the same hermetic nodes and fault plans.

Each scenario runs once per package on the same sessions (dead, corrupt,
slow or honest endpoints, seeded `FaultySession` plans) with an injected
clock, and returns what a caller sees: blocks, typed errors, breaker
states, demotions and the ``rpc.*`` / ``failover.*`` / ``degraded.*``
counters. The two logs must be equal. The port verifies a batch attempt's
landed blocks with one `verify_blocks_batch` call (here on the CPU plain
versions, the lane forced with ``IPC_VERIFY_MIN_BYTES=0``); its verdicts
must be the per-block ones. A lane fault raises `VerifyLaneError` out of
the pool, the fetch plane and the blockstore's prefetch, and demotes no
endpoint. A pool behind `RpcBlockstore` or the fetch plane gives the
reference's bundle byte for byte, faults or none.
"""

import base64
import json
import random
import time

import pytest
import torch

jax = pytest.importorskip("jax")

from ipc_proofs_tpu.core.cid import CID as RefCID  # noqa: E402
from ipc_proofs_tpu.fixtures import build_range_world as ref_build_range_world  # noqa: E402
from ipc_proofs_tpu.obs import trace as ref_trace  # noqa: E402
from ipc_proofs_tpu.proofs.generator import EventProofSpec as RefSpec  # noqa: E402
from ipc_proofs_tpu.proofs.range import generate_event_proofs_for_range as ref_generate  # noqa: E402
from ipc_proofs_tpu.store import blockstore as ref_blockstore  # noqa: E402
from ipc_proofs_tpu.store import failover as ref_failover  # noqa: E402
from ipc_proofs_tpu.store import faults as ref_faults  # noqa: E402
from ipc_proofs_tpu.store import rpc as ref_rpc  # noqa: E402
from ipc_proofs_tpu.utils.metrics import Metrics as RefMetrics  # noqa: E402
from ipc_proofs_tpu_torch.backend import get_backend  # noqa: E402
from ipc_proofs_tpu_torch.core.cid import CID, RAW, SHA2_256  # noqa: E402
from ipc_proofs_tpu_torch.fixtures import build_range_world  # noqa: E402
from ipc_proofs_tpu_torch.obs import trace  # noqa: E402
from ipc_proofs_tpu_torch.ops.verify import VerifyLaneError  # noqa: E402
from ipc_proofs_tpu_torch.proofs.generator import EventProofSpec  # noqa: E402
from ipc_proofs_tpu_torch.proofs.range import (  # noqa: E402
    generate_event_proofs_for_range,
    generate_event_proofs_for_range_pipelined,
)
from ipc_proofs_tpu_torch.store import blockstore, failover, faults, rpc  # noqa: E402
from ipc_proofs_tpu_torch.store.fetchplane import FetchPlane, PlaneBlockstore  # noqa: E402
from ipc_proofs_tpu_torch.utils import lockdep  # noqa: E402
from ipc_proofs_tpu_torch.utils.metrics import Metrics  # noqa: E402

from _torch_trace import PORT_ONLY_SPANS  # noqa: E402

CPU = get_backend("gpu", device="cpu")
SIG, SUBNET, ACTOR = "NewTopDownMessage(bytes32,uint256)", "calib-subnet-1", 1001
COUNTED = ("rpc.", "failover.", "degraded.")


class Pkg:
    def __init__(self, name, cid, bs, fo, fa, rp, metrics, backend):
        self.name, self.CID, self.bs, self.fo, self.fa, self.rpc = name, cid, bs, fo, fa, rp
        self.Metrics, self.backend = metrics, backend

    def pool(self, clients, **kw):
        if self.backend is not None:
            kw["backend"] = self.backend
        return self.fo.EndpointPool(clients, **kw)


PORT = Pkg("port", CID, blockstore, failover, faults, rpc, Metrics, CPU)
REF = Pkg("ref", RefCID, ref_blockstore, ref_failover, ref_faults, ref_rpc, RefMetrics, None)


@pytest.fixture(autouse=True)
def _lane_forced_lockdep_on(monkeypatch):
    """Every landed wave of two or more blocks goes to the backend; the
    port's locks run under lockdep and must show no inversion."""
    monkeypatch.setenv("IPC_VERIFY_MIN_BYTES", "0")
    lockdep.enable(strict=True)
    lockdep.reset()
    try:
        yield
    finally:
        lockdep.disable()
    assert not lockdep.violations()


class _Resp:
    def __init__(self, body):
        self._body = body

    def raise_for_status(self):
        pass

    def json(self):
        return self._body


def _flip(b64: str) -> str:
    raw = bytearray(base64.b64decode(b64))
    raw[len(raw) // 2] ^= 1
    return base64.b64encode(bytes(raw)).decode("ascii")


class _Switchable:
    """A hermetic node whose mode can change mid-test: ``ok``, ``dead``
    (transport error), ``corrupt`` (every block bit-flipped), ``lying``
    (only the blocks named in ``lies`` flipped, single and batch reads
    alike) or ``slow``."""

    def __init__(self, pkg, store, mode="ok", slow_s=0.3, lies=()):
        self._inner = pkg.fa.LocalLotusSession(store)
        self.mode, self.slow_s, self.lies = mode, slow_s, {str(c) for c in lies}
        self.calls = 0

    def post(self, url, data=None, headers=None, timeout=None):
        self.calls += 1
        if self.mode == "dead":
            raise ConnectionError("endpoint down")
        if self.mode == "slow":
            time.sleep(self.slow_s)
        resp = self._inner.post(url, data=data, headers=headers, timeout=timeout)
        if self.mode not in ("corrupt", "lying"):
            return resp
        reqs, body = json.loads(data), resp.json()
        by_id = {r["id"]: r for r in (reqs if isinstance(reqs, list) else [reqs])}
        out = []
        for entry in body if isinstance(body, list) else [body]:
            entry = dict(entry)  # a batch may answer out of order: match by id
            req, result = by_id[entry["id"]], entry.get("result")
            wanted = req["params"][0]["/"] if req.get("method") == "Filecoin.ChainReadObj" else None
            if isinstance(result, str) and (self.mode == "corrupt" or wanted in self.lies):
                entry["result"] = _flip(result)
            out.append(entry)
        return _Resp(out if isinstance(body, list) else out[0])


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _world(pkg, n: int = 6):
    store = pkg.bs.MemoryBlockstore()
    cids = [pkg.bs.put_cbor(store, {"k": b"value-%d" % i, "n": i, "pad": b"x" * (40 * i)}) for i in range(n)]
    return store, cids


def _client(pkg, session, **kw):
    kw.setdefault("max_retries", 1)  # failover is the pool's job here
    return pkg.rpc.LotusClient("http://ep", session=session, **kw)


def _outcome(fn):
    try:
        value = fn()
    except Exception as exc:  # the type is the outcome
        return ("raise", type(exc).__name__)
    if isinstance(value, list):
        return ("ok", [None if v is None else bytes(v).hex() for v in value])
    return ("ok", None if value is None else bytes(value).hex())


def _health(pool) -> dict:
    return pool.health()


def _counters(m) -> dict:
    return {k: v for k, v in m.snapshot()["counters"].items() if k.startswith(COUNTED)}


# --- scenarios: each returns the caller's view ---------------------------


def _dead_primary(pkg):
    store, cids = _world(pkg)
    m, clock = pkg.Metrics(), _Clock()
    pool = pkg.pool([_client(pkg, _Switchable(pkg, store, "dead")), _client(pkg, _Switchable(pkg, store))],
                    breaker_threshold=2, clock=clock, metrics=m)
    log = [_outcome(lambda: pool.chain_read_obj(cids[0])), _health(pool)]
    log.append(_outcome(lambda: pool.chain_read_obj_many(cids)))
    return log + [_health(pool), _counters(m)]


def _breaker_lifecycle(pkg):
    store, cids = _world(pkg)
    flaky = _Switchable(pkg, store, "dead")
    m, clock = pkg.Metrics(), _Clock()
    pool = pkg.pool([_client(pkg, flaky)], breaker_threshold=2, clock=clock, metrics=m)
    log = [_outcome(lambda: pool.chain_read_obj(cids[0])) for _ in range(3)] + [_health(pool)]
    clock.advance(31.0)
    flaky.mode = "ok"
    log += [_outcome(lambda: pool.chain_read_obj_many(cids)), _health(pool)]
    flaky.mode = "dead"
    log += [_outcome(lambda: pool.chain_read_obj(cids[1])) for _ in range(2)]
    clock.advance(31.0)
    log += [_outcome(lambda: pool.chain_read_obj(cids[1])), _health(pool)]
    return log + [_counters(m)]


def _last_resort(pkg):
    store, cids = _world(pkg)
    dead, healthy = _Switchable(pkg, store, "dead"), _Switchable(pkg, store)
    pool = pkg.pool([_client(pkg, dead), _client(pkg, healthy)], breaker_threshold=1, clock=_Clock())
    log = [_outcome(lambda: pool.chain_read_obj(cids[0])), dead.calls]
    log += [_outcome(lambda: pool.chain_read_obj_many(cids[1:])) for _ in range(2)] + [dead.calls]
    healthy.mode, dead.mode = "dead", "ok"
    log += [_outcome(lambda: pool.chain_read_obj_many(cids)), dead.calls, _health(pool)]
    return log


def _corrupt(pkg):
    store, cids = _world(pkg)
    m = pkg.Metrics()
    corrupt = _client(pkg, _Switchable(pkg, store, "corrupt"))
    pool = pkg.pool([corrupt, _client(pkg, _Switchable(pkg, store))], clock=_Clock(), metrics=m)
    log = [_outcome(lambda: pool.chain_read_obj(cids[0])), _health(pool)]
    log += [_outcome(lambda: pool.chain_read_obj_many(cids)), _health(pool)]
    both = pkg.pool([_client(pkg, _Switchable(pkg, store, "corrupt")) for _ in range(2)], clock=_Clock())
    log += [_outcome(lambda: both.chain_read_obj(cids[0])), _outcome(lambda: both.chain_read_obj_many(cids))]
    return log + [_counters(m)]


def _lying_in_a_batch(pkg):
    """The primary lies about two blocks of a batch: the honest blocks of
    its answer are kept, the liar is demoted, the rest comes from the
    honest endpoint."""
    store, cids = _world(pkg, 8)
    m = pkg.Metrics()
    liar = _Switchable(pkg, store, "lying", lies=(cids[2], cids[5]))
    honest = _Switchable(pkg, store)
    pool = pkg.pool([_client(pkg, liar), _client(pkg, honest)], clock=_Clock(), metrics=m)
    log = [_outcome(lambda: pool.chain_read_obj_many(cids)), liar.calls, honest.calls, _health(pool)]
    return log + [_counters(m)]


def _degraded(pkg):
    store, cids = _world(pkg)
    s0, s1 = _Switchable(pkg, store, "dead"), _Switchable(pkg, store, "dead")
    m, clock = pkg.Metrics(), _Clock()
    pool = pkg.pool([_client(pkg, s0), _client(pkg, s1)], breaker_threshold=1, clock=clock, metrics=m)
    log = [_outcome(lambda: pool.chain_read_obj(cids[0])), pool.lotus_down, _health(pool)]
    log += [_outcome(lambda: pool.chain_read_obj_many(cids)), s0.calls + s1.calls]
    log += [_outcome(lambda: pool.chain_read_obj(cids[0])), s0.calls + s1.calls]
    log += [_outcome(lambda: pool.request("Filecoin.ChainHead", []))]
    s0.mode = s1.mode = "ok"
    clock.advance(31.0)
    log += [_outcome(lambda: pool.chain_read_obj_many(cids)), pool.lotus_down, _health(pool)]
    return log + [_counters(m)]


def _retry_budget(pkg):
    store, cids = _world(pkg)
    dead = _Switchable(pkg, store, "dead")
    m, clock = pkg.Metrics(), _Clock()
    client = pkg.rpc.LotusClient("http://ep", session=dead, max_retries=4, backoff_base_s=0.0, backoff_max_s=0.0,
                                 metrics=m)
    pool = pkg.pool([client], clock=clock, breaker_threshold=10, retry_budget_per_s=1.0, metrics=m)
    log = [_outcome(lambda: pool.chain_read_obj(cids[0])), dead.calls]
    log += [_outcome(lambda: pool.chain_read_obj_many(cids)), dead.calls]
    clock.advance(2.0)  # refills two tokens
    log += [_outcome(lambda: pool.chain_read_obj(cids[0])), dead.calls]
    return log + [_counters(m)]


def _faulted_reads(pkg):
    """Seeded fault plans on two endpoints: the same sequence of single and
    batch reads gives the same blocks, errors, breakers and counters."""
    store, cids = _world(pkg, 12)
    m, clock = pkg.Metrics(), _Clock()
    clients = [
        pkg.rpc.LotusClient(
            "http://ep", session=pkg.fa.FaultySession(pkg.fa.LocalLotusSession(store),
                                                      pkg.fa.FaultPlan(7 * 101 + i, fault_rate=0.3),
                                                      sleep=lambda s: None),
            max_retries=2, backoff_base_s=0.0, backoff_max_s=0.0, rng=random.Random(i), metrics=m,
        )
        for i in range(2)
    ]
    pool = pkg.pool(clients, breaker_threshold=2, breaker_reset_s=1.0, clock=clock, metrics=m)
    log = []
    for step in range(12):
        log.append(_outcome(lambda: pool.chain_read_obj_many(cids[step % 4:])))
        log.append(_outcome(lambda: pool.chain_read_obj(cids[step])))
        clock.advance(0.4)
    return log + [_health(pool), _counters(m)]


SCENARIOS = {
    "dead-primary": _dead_primary,
    "breaker-lifecycle": _breaker_lifecycle,
    "last-resort": _last_resort,
    "corrupt": _corrupt,
    "lying-in-a-batch": _lying_in_a_batch,
    "degraded": _degraded,
    "retry-budget": _retry_budget,
    "faulted-reads": _faulted_reads,
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_pool_matches_the_reference(scenario):
    ours, ref = SCENARIOS[scenario](PORT), SCENARIOS[scenario](REF)
    assert ours == ref


def test_lying_endpoint_is_demoted_once():
    log = _lying_in_a_batch(PORT)
    blocks, counters = log[0], log[-1]
    assert blocks[0] == "ok" and None not in blocks[1]
    assert log[3]["endpoints"][0]["integrity_demotions"] == 1
    assert log[3]["endpoints"][0]["breaker"] == "open"
    assert counters["rpc.integrity_failures"] == 2


@pytest.mark.parametrize("pkg", [PORT, REF], ids=["port", "ref"])
def test_hedged_reads_race_the_same_way(pkg):
    """A slow primary (wall clock: the hedge delay is real time inside the
    racers): the hedge fires and wins, single and batch reads alike."""
    store, cids = _world(pkg)
    m = pkg.Metrics()
    pool = pkg.pool([_client(pkg, _Switchable(pkg, store, "slow", slow_s=0.4)), _client(pkg, _Switchable(pkg, store))],
                    hedge_ms=1.0, metrics=m)
    try:
        t0 = time.perf_counter()
        assert pool.chain_read_obj(cids[0]) == store.get(cids[0])
        assert pool.chain_read_obj_many(cids) == [store.get(c) for c in cids]
        assert time.perf_counter() - t0 < 0.75  # did not wait out the primary twice
    finally:
        pool.close()
    counters = _counters(m)
    assert counters["rpc.hedges"] == 2 and counters["rpc.hedge_wins"] == 2


def test_hedge_racers_keep_the_callers_trace():
    """The racers' RPC spans nest under the pool's read span, in both
    packages alike."""
    shapes = []
    for pkg, tr in ((PORT, trace), (REF, ref_trace)):
        store, cids = _world(pkg)
        collector = tr.enable_tracing()
        pool = pkg.pool([_client(pkg, _Switchable(pkg, store, "slow", slow_s=0.2)),
                         _client(pkg, _Switchable(pkg, store))], hedge_ms=1.0)
        try:
            with tr.root_span("request"):
                pool.chain_read_obj(cids[0])
                pool.chain_read_obj_many(cids)
            # the losing racers finish and record: two RPC spans per read
            deadline = time.monotonic() + 10.0
            while time.monotonic() < deadline and sum(
                sp.name in ("rpc.Filecoin.ChainReadObj", "rpc.batch") for sp in collector.snapshot()
            ) < 4:
                time.sleep(0.01)
        finally:
            pool.close()
            tr.disable_tracing()
        spans = collector.snapshot()
        by_id = {sp.span_id: sp for sp in spans}
        assert len({sp.trace_id for sp in spans}) == 1
        shape = sorted((sp.name, by_id[sp.parent_id].name if sp.parent_id in by_id else "") for sp in spans)
        # the port's backend phases (the blocks' CIDs checked on the GPU
        # backend) nest under the pool's reads; the reference makes none
        assert {parent for name, parent in shape if name.startswith("gpu.")} <= {"pool.read", "pool.read_many"}
        shapes.append([s for s in shape if not s[0].startswith(PORT_ONLY_SPANS)])
    assert shapes[0] == shapes[1]
    assert ("rpc.Filecoin.ChainReadObj", "pool.read") in shapes[0]
    assert ("rpc.batch", "pool.read_many") in shapes[0]


def test_lane_verdicts_equal_per_block_verification():
    """A batch attempt's landed blocks go through one lane call whose
    verdicts equal `verify_block_bytes` block for block: seeded lies over
    blake2b blocks of every size class, a sha2-256 block and absent ones."""
    rng = random.Random(11)
    store = blockstore.MemoryBlockstore()
    cids = [blockstore.put_cbor(store, {"i": i, "pad": bytes(rng.randrange(300))}) for i in range(40)]
    raw = b"raw sha2 block"
    sha = CID.hash_of(raw, codec=RAW, mh_code=SHA2_256)
    store.put_keyed(sha, raw)
    cids.append(sha)
    absent = CID.hash_of(b"absent")
    lies = rng.sample(cids, 9)
    m = Metrics()
    liar = _client(PORT, _Switchable(PORT, store, "lying", lies=lies))
    pool = PORT.pool([liar], metrics=m, clock=_Clock())
    ep = pool._endpoints[0]
    ok = pool._read_many_one(ep, cids + [absent])
    blocks = liar.chain_read_obj_many(cids + [absent])
    want = {k for k, (c, d) in enumerate(zip(cids + [absent], blocks)) if d is None or rpc.verify_block_bytes(c, d)}
    assert set(ok) == want and len(want) == len(cids) + 1 - len(lies)
    assert m.counter_value("verify.device_blocks") > 0
    assert m.counter_value("rpc.integrity_failures") == len(lies)
    assert ep.demotions == 1


class _FaultyBackend:
    """The CPU backend whose blake2b lane raises, as a refused launch does."""

    def warm(self):
        pass

    def blake2b256_batch(self, messages):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    def keccak256_batch(self, messages):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")


def test_lane_fault_raises_out_of_the_pool_and_demotes_nobody():
    store, cids = _world(PORT)
    m = Metrics()
    pool = failover.EndpointPool([_client(PORT, _Switchable(PORT, store)), _client(PORT, _Switchable(PORT, store))],
                                 backend=_FaultyBackend(), metrics=m, clock=_Clock())
    with pytest.raises(VerifyLaneError, match="illegal memory access") as err:
        pool.chain_read_obj_many(cids)
    assert isinstance(err.value.__cause__, RuntimeError)
    assert pool.health()["status"] == "ok"
    assert all(e["integrity_demotions"] == 0 and e["failures"] == 0 for e in pool.health()["endpoints"])
    assert m.counter_value("rpc.integrity_failures") == 0
    assert pool.chain_read_obj(cids[0]) == store.get(cids[0])  # the scalar read never uses the lane
    # through the blockstore's batched prefetch: no fail-soft swallow
    with pytest.raises(VerifyLaneError):
        rpc.RpcBlockstore(pool).prefetch(cids, {})
    # through a hedged batch read
    hedged = failover.EndpointPool([_client(PORT, _Switchable(PORT, store)), _client(PORT, _Switchable(PORT, store))],
                                   backend=_FaultyBackend(), hedge_ms=50.0)
    try:
        with pytest.raises(VerifyLaneError):
            hedged.chain_read_obj_many(cids)
    finally:
        hedged.close()


def test_lane_fault_in_the_pool_latches_the_fetch_plane():
    store, cids = _world(PORT)
    pool = failover.EndpointPool([_client(PORT, _Switchable(PORT, store))], backend=_FaultyBackend(), clock=_Clock())
    plane = FetchPlane(pool, backend=CPU)
    try:
        with pytest.raises(VerifyLaneError):
            plane.fetch_into(cids, {})
        with pytest.raises(VerifyLaneError):
            plane.get(cids[0])  # latched: every later read re-raises
    finally:
        plane.close()


def test_pool_defaults_to_the_card(monkeypatch):
    store, _ = _world(PORT)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        failover.EndpointPool([_client(PORT, _Switchable(PORT, store))])


def _range(pkg, store, pairs, seed, plane=False):
    spec = (EventProofSpec if pkg is PORT else RefSpec)(SIG, SUBNET, ACTOR)
    m = pkg.Metrics()
    clients = [
        pkg.rpc.LotusClient(
            "http://ep",
            session=pkg.fa.FaultySession(pkg.fa.LocalLotusSession(store),
                                         pkg.fa.FaultPlan(seed * 101 + i, fault_rate=0.1, kinds=("transport", "bitflip")),
                                         sleep=lambda s: None),
            max_retries=3, backoff_base_s=0.0, backoff_max_s=0.0, rng=random.Random(seed + i), metrics=m,
        )
        for i in range(2)
    ]
    pool = pkg.pool(clients, breaker_threshold=3, breaker_reset_s=0.05, metrics=m, clock=_Clock())
    kw = {"match_backend": CPU} if pkg is PORT else {}
    try:
        if plane:  # the CLI's stack: chunk spines and speculation batch the wants
            fp = FetchPlane(pool, backend=CPU, metrics=m)
            try:
                bundle = generate_event_proofs_for_range_pipelined(
                    PlaneBlockstore(fp), pairs, spec, metrics=m, chunk_size=2, scan_threads=2,
                    force_pipeline=True, **kw,
                )
            finally:
                fp.close()
        else:
            run = generate_event_proofs_for_range if pkg is PORT else ref_generate
            bundle = run(pkg.rpc.RpcBlockstore(pool, metrics=m), pairs, spec, metrics=m, **kw)
    finally:
        pool.close()
    return bundle.to_json(), m


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pool_behind_the_blockstore_gives_the_reference_bundle(seed):
    store, pairs, n = build_range_world(6, 4, 2, 0.3, signature=SIG, topic1=SUBNET, actor_id=ACTOR)
    ref_store, ref_pairs, _ = ref_build_range_world(6, 4, 2, 0.3, signature=SIG, topic1=SUBNET, actor_id=ACTOR)
    clean = generate_event_proofs_for_range(store, pairs, EventProofSpec(SIG, SUBNET, ACTOR), match_backend=CPU)
    ours, m = _range(PORT, store, pairs, seed)
    ref, ref_m = _range(REF, ref_store, ref_pairs, seed)
    assert ours == ref == clean.to_json() and n > 0
    assert _counters(m) == _counters(ref_m)
    plane_json, plane_m = _range(PORT, store, pairs, seed, plane=True)
    assert plane_json == ours
    assert plane_m.counter_value("verify.device_blocks") > 0  # the pool's waves reached the lane
