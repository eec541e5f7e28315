"""The port's cluster router and shards (`cluster/router.py`,
`cluster/shard.py`) against the JAX package's.

The reference's ``tests/test_cluster.py`` classes that need a router run on
both packages over one seeded range world (`build_range_world`, equal pair
tables and blocks): the reference on its host paths, the port's shards on
``device="cpu"`` (the plain versions of its kernels). Every scatter is
compared with the single daemon's bytes (the reference's chunked driver),
in four wirings: each package's router over its own `LocalShard`s, the
port's router over the reference's shards and the reference's router over
the port's:

- the scatter-gather grid (1–3 shards × chunk 1, 3, 8), a permuted subset,
  a shard with seeded store faults (typed error or the exact bytes);
- failover (kill a shard, every request still answers the single daemon's
  bytes), every shard dead (typed), revive; work stealing (the same
  placements and counters in both packages); leader election and the
  shared segment store; durable ``generate_range`` idempotency and its
  400s; one trace over a scatter (per package: span grafting skips a
  subtree of this process);
- the router's own answers (validation, routes of `RouterHTTPServer`) equal
  the reference's;
- a fault of the card on a shard (500 ``error_type: device``, or a
  ``device`` abort chunk in its stream) reaches the client verbatim on
  every route and marks no shard dead, and the router's backfill job ends
  ``faulted`` (the port's departure: the reference's runner fails it).
"""

import json
import os
import threading
import time
import types

import pytest

pytest.importorskip("jax")

import ipc_proofs_tpu.cluster as ref_cluster  # noqa: E402
import ipc_proofs_tpu.obs as ref_obs  # noqa: E402
import ipc_proofs_tpu.storex as ref_storex  # noqa: E402
import ipc_proofs_tpu_torch.cluster as port_cluster  # noqa: E402
import ipc_proofs_tpu_torch.obs as port_obs  # noqa: E402
import ipc_proofs_tpu_torch.storex as port_storex  # noqa: E402
from ipc_proofs_tpu.core.cid import CID as RefCID  # noqa: E402
from ipc_proofs_tpu.fixtures import build_range_world as ref_build_range_world  # noqa: E402
from ipc_proofs_tpu.proofs.generator import EventProofSpec as RefSpec  # noqa: E402
from ipc_proofs_tpu.proofs.range import (  # noqa: E402
    generate_event_proofs_for_range_chunked as ref_chunked,
)
from ipc_proofs_tpu.serve.service import ServiceConfig as RefServiceConfig  # noqa: E402
from ipc_proofs_tpu.store import faults as ref_faults  # noqa: E402
from ipc_proofs_tpu.utils.metrics import Metrics as RefMetrics  # noqa: E402
from ipc_proofs_tpu_torch.backend import get_backend  # noqa: E402
from ipc_proofs_tpu_torch.core.cid import CID  # noqa: E402
from ipc_proofs_tpu_torch.fixtures import build_range_world  # noqa: E402
from ipc_proofs_tpu_torch.ops.build import DeviceFaultError  # noqa: E402
from ipc_proofs_tpu_torch.proofs.generator import EventProofSpec  # noqa: E402
from ipc_proofs_tpu_torch.serve import ServiceConfig  # noqa: E402
from ipc_proofs_tpu_torch.store import faults as port_faults  # noqa: E402
from ipc_proofs_tpu_torch.utils.metrics import Metrics  # noqa: E402
from ipc_proofs_tpu_torch.witness.errors import StreamAbortError  # noqa: E402
from ipc_proofs_tpu_torch.witness.stream import (  # noqa: E402
    STREAM_CONTENT_TYPE,
    decode_bundle_stream,
    decode_bundle_stream_docs,
)

from _torch_http import get, post, request, strip  # noqa: E402

SIG = "NewTopDownMessage(bytes32,uint256)"
SUBNET = "calib-subnet-1"
ACTOR = 1001
CPU = get_backend("gpu", device="cpu")
WORLD_ARGS = (6, 6, 3, 0.3)
WORLD_KW = dict(signature=SIG, topic1=SUBNET, actor_id=ACTOR, base_height=51_000)

PKGS = {
    "port": types.SimpleNamespace(
        cluster=port_cluster, Spec=EventProofSpec, Metrics=Metrics, obs=port_obs,
        storex=port_storex, faults=port_faults, CID=CID, store_kw={"backend": CPU},
        config=lambda **kw: ServiceConfig(device="cpu", **kw),
    ),
    "ref": types.SimpleNamespace(
        cluster=ref_cluster, Spec=RefSpec, Metrics=RefMetrics, obs=ref_obs,
        storex=ref_storex, faults=ref_faults, CID=RefCID, store_kw={},
        config=lambda **kw: RefServiceConfig(**kw),
    ),
}
# (router package, shard package)
WIRINGS = {
    "port": ("port", "port"),
    "ref": ("ref", "ref"),
    "port-router/ref-shards": ("port", "ref"),
    "ref-router/port-shards": ("ref", "port"),
}


@pytest.fixture(scope="module")
def worlds():
    return {
        "port": build_range_world(*WORLD_ARGS, **WORLD_KW),
        "ref": ref_build_range_world(*WORLD_ARGS, **WORLD_KW),
    }


def _spec(pkg):
    return PKGS[pkg].Spec(event_signature=SIG, topic_1=SUBNET, actor_id_filter=ACTOR)


def _canonical(obj) -> str:
    return json.dumps(obj, sort_keys=True)


def _direct(worlds, idxs, chunk_size=3) -> str:
    """The single daemon's bytes: the reference's chunked driver."""
    store, pairs, _ = worlds["ref"]
    bundle = ref_chunked(store, [pairs[i] for i in idxs], _spec("ref"), chunk_size=chunk_size)
    return _canonical(bundle.to_json_obj())


@pytest.fixture(scope="module")
def direct(worlds):
    return _direct(worlds, range(WORLD_ARGS[0]))


def shards_up(worlds, pkg, n, wrapper_for=None, queue_root=None, **cfg):
    """N started `LocalShard`s of ``pkg`` over its world."""
    store, pairs, _ = worlds[pkg]
    out = []
    for i in range(n):
        out.append(
            PKGS[pkg].cluster.LocalShard(
                f"s{i}", store, pairs, _spec(pkg), config=PKGS[pkg].config(**cfg),
                queue_dir=os.path.join(queue_root, f"s{i}") if queue_root else None,
                store_wrapper=wrapper_for(i) if wrapper_for else None,
            ).start()
        )
    return out


def router_over(worlds, pkg, shards, **kw):
    kw.setdefault("scrape_interval_s", 60.0)
    return PKGS[pkg].cluster.ClusterRouter({s.name: s.url for s in shards}, worlds[pkg][1], **kw)


def teardown(router, shards):
    router.close()
    for s in shards:
        try:
            s.stop(timeout=10)
        except Exception:
            pass


def _n_groups(n_shards, idxs, worlds):
    ring = ref_cluster.HashRing([f"s{i}" for i in range(n_shards)])
    pairs = worlds["ref"][1]
    return len({ring.node_for(ref_cluster.pair_ring_key(pairs[i])) for i in idxs})


# --------------------------------------------------------------------------
# scatter-gather identity
# --------------------------------------------------------------------------


def test_both_packages_direct_runs_agree(worlds, direct):
    from ipc_proofs_tpu_torch.proofs.range import generate_event_proofs_for_range_chunked

    store, pairs, _ = worlds["port"]
    bundle = generate_event_proofs_for_range_chunked(store, list(pairs), _spec("port"), chunk_size=3,
                                                     match_backend=CPU)
    assert _canonical(bundle.to_json_obj()) == direct


@pytest.mark.parametrize("chunk_size", [1, 3, 8])
@pytest.mark.parametrize("n_shards", [1, 2, 3])
@pytest.mark.parametrize("wiring", sorted(WIRINGS))
def test_grid_is_the_single_daemons_bytes(worlds, direct, wiring, n_shards, chunk_size):
    """Any shard partition × any chunking merges to the exact bytes the
    single daemon produces — the cluster's correctness law — in every
    wiring of the two packages."""
    router_pkg, shard_pkg = WIRINGS[wiring]
    shards = shards_up(worlds, shard_pkg, n_shards)
    router = router_over(worlds, router_pkg, shards)
    try:
        idxs = list(range(WORLD_ARGS[0]))
        status, obj = router.generate_range(idxs, chunk_size=chunk_size)
        assert status == 200, obj
        assert _canonical(obj["bundle"]) == direct
        assert obj["n_groups"] == _n_groups(n_shards, idxs, worlds)
        if n_shards > 1:
            assert obj["n_groups"] > 1
    finally:
        teardown(router, shards)


@pytest.mark.parametrize("wiring", sorted(WIRINGS))
def test_subset_and_order_identity(worlds, wiring):
    """A permuted subset merges to the single daemon's run over the same
    list — order comes from the request, not the shards."""
    router_pkg, shard_pkg = WIRINGS[wiring]
    idxs = [4, 1, 3]
    shards = shards_up(worlds, shard_pkg, 2)
    router = router_over(worlds, router_pkg, shards)
    try:
        status, obj = router.generate_range(idxs, chunk_size=2)
        assert status == 200, obj
        assert _canonical(obj["bundle"]) == _direct(worlds, idxs, chunk_size=2)
    finally:
        teardown(router, shards)


@pytest.mark.parametrize("seed", [7, 23])
@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_identity_with_a_faulty_shard(worlds, direct, pkg, seed):
    """One shard's store injects seeded faults: every scatter ends in a
    typed error or the exact single-daemon bytes, in both packages."""
    faults = PKGS[pkg].faults

    def wrapper_for(i):
        if i != 0:
            return None
        plan = faults.FaultPlan(seed, fault_rate=0.15)
        return lambda s: faults.FaultyBlockstore(s, plan)

    shards = shards_up(worlds, pkg, 2, wrapper_for=wrapper_for)
    router = router_over(worlds, pkg, shards, metrics=PKGS[pkg].Metrics())
    try:
        for _ in range(3):
            try:
                status, obj = router.generate_range(list(range(WORLD_ARGS[0])), chunk_size=3)
            except PKGS[pkg].cluster.NoShardsError:
                continue  # both shards condemned — a typed outcome
            if status == 200:
                assert _canonical(obj["bundle"]) == direct
            else:
                assert status in (400, 500, 502, 503, 504) and "error" in obj
    finally:
        teardown(router, shards)


# --------------------------------------------------------------------------
# failover, revive, stealing
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def single_daemon_generates(worlds):
    """``/v1/generate`` bodies of one reference daemon, per pair index."""
    (shard,) = shards_up(worlds, "ref", 1)
    client = ref_cluster.ShardClient("s0", shard.url)
    try:
        out = {}
        for idx in range(WORLD_ARGS[0]):
            status, obj = client.post("/v1/generate", {"pair_index": idx})
            assert status == 200
            out[idx] = _canonical(obj["bundle"])
        return out
    finally:
        shard.stop(timeout=10)


@pytest.mark.parametrize("wiring", sorted(WIRINGS))
def test_kill_a_shard_requests_still_succeed(worlds, direct, single_daemon_generates, wiring):
    router_pkg, shard_pkg = WIRINGS[wiring]
    shards = shards_up(worlds, shard_pkg, 2)
    m = PKGS[router_pkg].Metrics()
    router = router_over(worlds, router_pkg, shards, metrics=m)
    try:
        status, _ = router.generate_range(list(range(WORLD_ARGS[0])))
        assert status == 200
        victim = router.alive_shards()[0]
        next(s for s in shards if s.name == victim).kill()
        for idx in range(WORLD_ARGS[0]):
            status, obj = router.generate(idx)
            assert status == 200, obj
            assert _canonical(obj["bundle"]) == single_daemon_generates[idx]
        status, obj = router.generate_range(list(range(WORLD_ARGS[0])))
        assert status == 200, obj
        assert _canonical(obj["bundle"]) == direct
        assert m.counter_value("cluster.shard_failovers") > 0
        assert router.alive_shards() == sorted(s.name for s in shards if s.name != victim)
    finally:
        teardown(router, shards)


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_all_shards_dead_is_typed(worlds, pkg):
    shards = shards_up(worlds, pkg, 1)
    router = router_over(worlds, pkg, shards)
    try:
        shards[0].kill()
        with pytest.raises(PKGS[pkg].cluster.NoShardsError, match="all shards are dead|no shard answered"):
            router.generate_range([0, 1])
        with pytest.raises(PKGS[pkg].cluster.NoShardsError, match="all shards are dead"):
            router.generate(0)
        assert router.alive_shards() == []
    finally:
        teardown(router, shards)


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_revive_restores_routing(worlds, pkg):
    shards = shards_up(worlds, pkg, 2)
    m = PKGS[pkg].Metrics()
    router = router_over(worlds, pkg, shards, metrics=m)
    try:
        router._mark_dead("s0")
        assert router.alive_shards() == ["s1"]
        assert m.snapshot()["gauges"]["cluster.shards_alive"] == 1
        router.revive("s0")
        assert router.alive_shards() == ["s0", "s1"]
        status, _ = router.generate(0)
        assert status == 200
    finally:
        teardown(router, shards)


def _steal_trace(pkg, worlds):
    """Placement decisions and counters of one steal scenario (URLs never
    dialed: placement is decided before any I/O)."""
    m = PKGS[pkg].Metrics()
    router = PKGS[pkg].cluster.ClusterRouter(
        {"s0": "http://127.0.0.1:1", "s1": "http://127.0.0.1:2"}, worlds[pkg][1],
        steal_threshold=3, metrics=m, scrape_interval_s=60.0,
    )
    try:
        key = PKGS[pkg].cluster.pair_ring_key(worlds[pkg][1][0])
        with router._lock:
            affine = router._affinity_locked(key)
        other = "s1" if affine == "s0" else "s0"
        trace = [affine]
        with router._lock:
            router._shards[affine].inflight = 2
        trace.append(router._acquire(key)[0])  # below threshold: affinity
        router._release(trace[-1])
        with router._lock:
            router._shards[affine].inflight = 3
        trace.append(router._acquire(key)[0])  # at threshold: stolen
        assert trace[1:] == [affine, other]
        # a slow shard sheds traffic on its latency EWMA alone
        with router._lock:
            router._shards[affine].inflight = 0
            router._shards[other].inflight = 0
        router._note_latency(affine, 10.0)
        trace.append(router._acquire(key)[0])
        snap = m.snapshot()
        return trace, snap["counters"], snap["gauges"]
    finally:
        router.close()


def test_steal_placements_and_counters_match_the_reference(worlds):
    port, ref = _steal_trace("port", worlds), _steal_trace("ref", worlds)
    assert port == ref
    trace, counters, _ = port
    assert counters["cluster.steals"] == 2 and counters["cluster.slow_quarantines"] == 1
    assert trace[-1] != trace[0]


# --------------------------------------------------------------------------
# leader election, the shared store
# --------------------------------------------------------------------------


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_single_winner_and_succession(tmp_path, pkg):
    m = PKGS[pkg].Metrics()
    a = PKGS[pkg].storex.FollowLeaderLock(str(tmp_path))
    b = PKGS[pkg].storex.FollowLeaderLock(str(tmp_path))
    assert a.try_acquire(metrics=m) is True and a.held
    assert b.try_acquire(metrics=m) is False and not b.held
    assert a.try_acquire(metrics=m) is True
    assert m.counter_value("follow.leader_elections") == 1
    a.release()
    assert b.try_acquire(metrics=m) is True
    assert m.counter_value("follow.leader_elections") == 2
    b.release()


def _block(pkg, tag: bytes, i: int):
    data = (b"%s-%04d-" % (tag, i)) * 40
    return PKGS[pkg].CID.hash_of(data), data


def _two_owner_run(pkg, root):
    m = PKGS[pkg].Metrics()
    kw = dict(cap_bytes=4000, segment_max_bytes=800, metrics=m, **PKGS[pkg].store_kw)
    a = PKGS[pkg].storex.SegmentStore(str(root), owner="sa", **kw)
    b = PKGS[pkg].storex.SegmentStore(str(root), owner="sb", **kw)
    written = []
    try:
        for i in range(12):
            for store, tag in ((a, b"aa"), (b, b"bb")):
                c, d = _block(pkg, tag, i)
                assert store.put(c, d)
                written.append((store, c, d))
        names = sorted(n for n in os.listdir(str(root)) if n.endswith(".blk"))
        reads = []
        for store, c, d in written:
            got = store.get(c)
            assert got is None or got == d
            reads.append(got is not None)
        sizes = [os.path.getsize(os.path.join(str(root), n)) for n in names]
        return names, sizes, reads, m.counter_value("storex.shared_evictions")
    finally:
        a.close()
        b.close()


def test_two_owners_coordinate_eviction_as_the_reference(tmp_path):
    port = _two_owner_run("port", tmp_path / "port")
    ref = _two_owner_run("ref", tmp_path / "ref")
    assert port == ref
    names, sizes, _, evictions = port
    assert evictions > 0
    assert {n.split(".")[0] for n in names} == {"seg-sa", "seg-sb"}
    assert sum(sizes) <= 4000 + 2 * 800


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_reopen_indexes_all_owners(tmp_path, pkg):
    storex, kw = PKGS[pkg].storex, PKGS[pkg].store_kw
    a, b = storex.SegmentStore(str(tmp_path), owner="sa", **kw), storex.SegmentStore(str(tmp_path), owner="sb", **kw)
    ca, da = _block(pkg, b"aa", 1)
    cb, db = _block(pkg, b"bb", 1)
    a.put(ca, da)
    b.put(cb, db)
    a.close()
    b.close()
    c = storex.SegmentStore(str(tmp_path), owner="sc", **kw)
    try:
        assert c.get(ca) == da and c.get(cb) == db
        assert c.stats()["shared"] is True
    finally:
        c.close()


@pytest.mark.parametrize("owner", ["bad/owner", ""])
def test_owner_token_validation_matches_the_reference(tmp_path, owner):
    messages = []
    for pkg in sorted(PKGS):
        with pytest.raises(PKGS[pkg].storex.SegmentStoreError, match="owner token") as info:
            PKGS[pkg].storex.SegmentStore(str(tmp_path / pkg), owner=owner, **PKGS[pkg].store_kw)
        messages.append(str(info.value).replace(str(tmp_path / pkg), "DIR"))
    assert messages[0] == messages[1]


# --------------------------------------------------------------------------
# durable shards, validation, tracing
# --------------------------------------------------------------------------


@pytest.mark.parametrize("wiring", sorted(WIRINGS))
def test_generate_range_idempotency(worlds, tmp_path, wiring):
    """The property failover leans on: a retried ``generate_range`` with
    the same idempotency key is served from the journal, not re-run."""
    client_pkg, shard_pkg = WIRINGS[wiring]
    shards = shards_up(worlds, shard_pkg, 1, queue_root=str(tmp_path))
    client = PKGS[client_pkg].cluster.ShardClient("s0", shards[0].url)
    try:
        body = {"pair_indexes": [0, 2], "idempotency_key": "retry-1"}
        st1, first = client.post("/v1/generate_range", body)
        st2, second = client.post("/v1/generate_range", body)
        assert st1 == st2 == 200
        assert first["cached"] is False and second["cached"] is True
        assert first["result"] == second["result"]
        assert _canonical(first["result"]["bundle"]) == _direct(worlds, [0, 2], chunk_size=3)
    finally:
        for s in shards:
            s.stop(timeout=10)


BAD_RANGE_BODIES = {
    "empty": {"pair_indexes": []},
    "out-of-range": {"pair_indexes": [999]},
    "bool": {"pair_indexes": [True]},
    "string": {"pair_indexes": ["0"]},
    "none": {"pair_indexes": None},
    "chunk-0": {"pair_indexes": [0], "chunk_size": 0},
}


@pytest.mark.parametrize("case", sorted(BAD_RANGE_BODIES))
def test_shard_generate_range_validation_matches_the_reference(worlds, case):
    answers = []
    for pkg in sorted(PKGS):
        shards = shards_up(worlds, pkg, 1)
        try:
            answers.append(PKGS[pkg].cluster.ShardClient("s0", shards[0].url).post(
                "/v1/generate_range", BAD_RANGE_BODIES[case]))
        finally:
            shards[0].stop(timeout=10)
    assert answers[0][0] == 400
    assert answers[0] == answers[1]


ROUTER_CALLS = {
    "generate-bool": lambda r: r.generate(True),
    "generate-negative": lambda r: r.generate(-1),
    "generate-past-end": lambda r: r.generate(99),
    "range-empty": lambda r: r.generate_range([]),
    "range-string": lambda r: r.generate_range(["1"]),
    "range-past-end": lambda r: r.generate_range([0, 6]),
    "backfill-missing-end": lambda r: r.backfill_submit({"pair_start": 0}),
    "backfill-window-0": lambda r: r.backfill_submit({"pair_start": 0, "pair_end": 2, "window_size": 0}),
    "backfill-sub-id": lambda r: r.backfill_submit({"pair_start": 0, "pair_end": 2, "sub_id": 7}),
    "backfill-unknown": lambda r: r.backfill_status("bf-nope"),
    "backfill-chunks-unknown": lambda r: r.backfill_chunks("bf-nope", 0),
    "backfill-jobs": lambda r: r.backfill_jobs(),
    "subscribe-bad-filter": lambda r: r.subscribe({"filter": {"topic1": 7}}),
    "unsubscribe-no-id": lambda r: r.unsubscribe({}),
    "registry-unknown-path": lambda r: r.registry_query("nope", {}),
    "registry-entry-no-shard": lambda r: r.registry_query("entry", {}),
    "registry-dead-shard": lambda r: r.registry_query("entry", {"shard": ["zz"]}),
    "replicate-factor-1": lambda r: (200, r.replicate_now()),
}


@pytest.mark.parametrize("case", sorted(ROUTER_CALLS))
def test_router_answers_match_the_reference(worlds, case):
    """The router's own answers (before any shard is dialed) equal the
    reference's, status and body."""
    answers = []
    for pkg in sorted(PKGS):
        router = PKGS[pkg].cluster.ClusterRouter(
            {"s0": "http://127.0.0.1:9", "s1": "http://127.0.0.1:10"}, worlds[pkg][1], scrape_interval_s=60.0
        )
        try:
            answers.append(ROUTER_CALLS[case](router))
        finally:
            router.close()
    assert answers[0] == answers[1]


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_one_trace_covers_the_scatter(worlds, pkg):
    """Shard-side spans adopt the router's carrier: the whole scatter
    shares one trace id (spans compared within one package: a subtree of
    this process is never grafted twice)."""
    obs = PKGS[pkg].obs
    shards = shards_up(worlds, pkg, 2)
    router = router_over(worlds, pkg, shards)
    collector = obs.enable_tracing(metrics=PKGS[pkg].Metrics())
    try:
        status, obj = router.generate_range(list(range(WORLD_ARGS[0])))
        assert status == 200
        names = {s.name for s in collector.snapshot() if s.trace_id == obj["trace_id"]}
        assert {"cluster.generate_range", "cluster.dispatch", "http.generate_range"} <= names
    finally:
        obs.disable_tracing()
        teardown(router, shards)


# --------------------------------------------------------------------------
# RouterHTTPServer: routes
# --------------------------------------------------------------------------

ROUTES = [
    ("GET", "/nope", None),
    ("POST", "/nope", {"x": 1}),
    ("POST", "/v1/generate", {"pair_index": 99}),
    ("POST", "/v1/generate", {"pair_index": 1}),
    ("POST", "/v1/generate_range", {"pair_indexes": [5, 0, 2], "chunk_size": 2}),
    ("POST", "/v1/generate_range", {"pair_indexes": [0, 1], "aggregate": True}),
    ("POST", "/v1/generate_range", {"pair_indexes": [0], "witness_encoding": "bogus", "stream": True}),
    ("POST", "/v1/generate_range", {"pair_indexes": [0], "deadline_ms": "soon"}),
    ("POST", "/v1/generate_range", {"pair_indexes": [0], "deadline_ms": 1}),
    ("GET", "/v1/subscriptions", None),
    ("GET", "/v1/deliveries", None),
    ("GET", "/v1/deliveries?sub=x&cursor=q", None),
    ("GET", "/v1/deliveries?sub=nope", None),
    ("GET", "/v1/backfill", None),
    ("GET", "/v1/backfill/bf-nope", None),
    ("GET", "/v1/backfill/bf-nope/chunks?cursor=z", None),
    ("GET", "/v1/backfill/bf-nope/x", None),
    ("POST", "/v1/backfill", {"pair_start": 3, "pair_end": 2}),
    ("GET", "/v1/registry/nope", None),
    ("GET", "/healthz", None),
]


def test_router_http_routes_match_the_reference(worlds):
    servers = []
    for pkg in sorted(PKGS):
        shards = shards_up(worlds, pkg, 2)
        router = router_over(worlds, pkg, shards)
        servers.append((PKGS[pkg].cluster.RouterHTTPServer(router).start(), shards))
    try:
        for method, path, body in ROUTES:
            answers = [
                post(s.port, path, body) if method == "POST" else get(s.port, path) for s, _ in servers
            ]
            (ps, _, pb), (rs, _, rb) = answers
            assert ps == rs, (path, pb, rb)
            if path == "/healthz":
                assert pb["status"] == rb["status"] == "ok" and pb["shards_alive"] == rb["shards_alive"] == 2
            elif isinstance(pb, bytes):  # a stream: its head carries the trace id
                assert strip(decode_bundle_stream(pb)) == strip(decode_bundle_stream(rb)), path
            elif isinstance(pb, dict) and "bundle" in pb:
                assert _canonical(strip(pb)) == _canonical(strip(rb)), path
            else:
                assert pb == rb, path
        # a bad Content-Length / non-object body
        answers = [request(s.port, "POST", "/v1/generate", b"[1]",
                           {"Content-Type": "application/json"}) for s, _ in servers]
        assert answers[0][0] == answers[1][0] == 400 and answers[0][2] == answers[1][2]
    finally:
        for server, shards in servers:
            server.shutdown(timeout=10)
            for s in shards:
                s.stop(timeout=10)


# --------------------------------------------------------------------------
# a fault of the card on a shard
# --------------------------------------------------------------------------


def _fault_mask(monkeypatch):
    """Every port shard's range generation launches the event mask on the
    shared CPU backend (unfused scan), which now faults like the card."""
    def broken(*args, **kwargs):
        raise DeviceFaultError("event_match_mask_fp: CUDA launch failed with error 700")

    monkeypatch.setenv("IPC_SCAN_FUSED_MATCH", "0")
    monkeypatch.setattr(CPU, "event_match_mask_fp", broken)


def _fault_blake2b(monkeypatch):
    def broken(messages):
        raise DeviceFaultError("blake2b256_two_block: CUDA launch failed with error 700")

    monkeypatch.setattr(CPU, "blake2b256_batch", broken)


@pytest.fixture()
def port_cluster_http(worlds):
    shards = shards_up(worlds, "port", 2, max_wait_ms=1.0)
    m = Metrics()
    routers = {on: router_over(worlds, "port", shards, metrics=m, cut_through=on) for on in (True, False)}
    servers = {on: port_cluster.RouterHTTPServer(r).start() for on, r in routers.items()}
    yield servers, routers, shards, m
    for server in servers.values():
        server.shutdown(timeout=10)
    for s in shards:
        s.stop(timeout=10)


def _assert_no_shard_died(routers, m):
    for router in routers.values():
        assert router.alive_shards() == ["s0", "s1"]
    c = m.snapshot()["counters"]
    assert c.get("cluster.shard_failovers", 0) == 0 and c.get("cluster.shard_errors", 0) == 0


@pytest.mark.parametrize("route", ["verify", "generate", "generate_range"])
def test_a_device_fault_reaches_a_buffered_client_verbatim(worlds, direct, port_cluster_http, monkeypatch, route):
    servers, routers, _, m = port_cluster_http
    port = servers[True].port
    body = {
        "verify": {"bundle": json.loads(direct)},
        "generate": {"pair_index": 1},
        "generate_range": {"pair_indexes": list(range(WORLD_ARGS[0])), "chunk_size": 2},
    }[route]
    with monkeypatch.context() as patch:
        (_fault_blake2b if route == "verify" else _fault_mask)(patch)
        status, _, obj = post(port, f"/v1/{route}", body)
    assert status == 500 and obj["error_type"] == "device", obj
    assert "CUDA launch failed" in obj["error"]
    _assert_no_shard_died(routers, m)
    status, _, obj = post(port, f"/v1/{route}", body)  # the card back: served
    assert status == 200, obj


@pytest.mark.parametrize(
    "where,cut_through",
    [("before-stream", True), ("before-stream", False), ("mid-stream", True)],
    ids=["before-stream-cut-through", "before-stream-buffered-relay", "mid-stream-cut-through"],
)
def test_a_device_fault_reaches_a_streamed_client_verbatim(worlds, port_cluster_http, monkeypatch, where, cut_through):
    """Before the shard's stream starts it answers 500 ``device``; after
    (a cut-through relay asks the shards for their streams), its stream
    ends in a ``device`` abort chunk, relayed as the router's own ``E``
    chunk. Either way the client's stream ends in a ``device``
    abort and no shard is marked dead."""
    servers, routers, shards, m = port_cluster_http
    body = {"pair_indexes": list(range(WORLD_ARGS[0])), "chunk_size": 2, "stream": True}
    with monkeypatch.context() as patch:
        if where == "before-stream":
            _fault_mask(patch)
        else:
            for shard in shards:
                patch.setattr(shard.service, "read_block_slice", lambda cid: (_ for _ in ()).throw(
                    RuntimeError("CUDA error: an illegal memory access was encountered")))
        status, hdrs, raw = request(servers[cut_through].port, "POST", "/v1/generate_range", body)
    assert status == 200 and hdrs["Content-Type"] == STREAM_CONTENT_TYPE
    with pytest.raises(StreamAbortError) as info:
        decode_bundle_stream(raw)
    assert info.value.remote_error_type == "device"
    _assert_no_shard_died(routers, m)


def _poll_job(router, job_id, timeout_s=60.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        status = router._backfill_job(job_id).status()
        if status["state"] != "running":
            return status
        time.sleep(0.02)
    raise AssertionError("backfill job did not settle")


def test_a_device_fault_ends_a_router_backfill_job_faulted(worlds, tmp_path, monkeypatch):
    """The router's window runner raises `DeviceFaultError` for a shard's
    ``device`` answer: the job ends ``faulted`` (never ``failed``), its
    door answers 500 ``device`` and its chunk stream ends in a ``device``
    abort chunk."""
    shards = shards_up(worlds, "port", 2)
    m = Metrics()
    router = router_over(worlds, "port", shards, metrics=m, backfill_jobs_dir=str(tmp_path / "jobs"),
                         backfill_window_size=2, spec=_spec("port"))
    server = port_cluster.RouterHTTPServer(router).start()
    try:
        with monkeypatch.context() as patch:
            _fault_mask(patch)
            status, _, job = post(server.port, "/v1/backfill", {"pair_start": 0, "pair_end": 6})
            assert status == 200
            settled = _poll_job(router, job["job_id"])
        assert settled["state"] == "faulted" and settled["error_type"] == "device", settled
        assert m.counter_value("backfill.window_failures") == 0
        status, _, obj = get(server.port, f"/v1/backfill/{job['job_id']}")
        assert status == 500 and obj["error_type"] == "device"
        status, _, obj = get(server.port, f"/v1/backfill/{job['job_id']}/chunks?cursor=0")
        assert status == 500 and obj["error_type"] == "device"
        status, hdrs, raw = request(server.port, "GET", f"/v1/backfill/{job['job_id']}/chunks?cursor=0",
                                    headers={"Accept": STREAM_CONTENT_TYPE})
        assert status == 200 and hdrs["Content-Type"] == STREAM_CONTENT_TYPE
        with pytest.raises(StreamAbortError) as info:
            decode_bundle_stream_docs(raw)
        assert info.value.remote_error_type == "device"
        assert router.alive_shards() == ["s0", "s1"]
    finally:
        server.shutdown(timeout=10)
        for s in shards:
            s.stop(timeout=10)


def test_a_reference_router_fails_the_same_backfill_job(worlds, tmp_path, monkeypatch):
    """The departure pinned: the reference's runner turns the shard's 500
    into `ShardUnavailable`, so its job ends ``failed``."""
    shards = shards_up(worlds, "port", 2)
    router = router_over(worlds, "ref", shards, backfill_jobs_dir=str(tmp_path / "jobs"),
                         backfill_window_size=2)
    try:
        with monkeypatch.context() as patch:
            _fault_mask(patch)
            status, job = router.backfill_submit({"pair_start": 0, "pair_end": 6})
            assert status == 200
            deadline = time.monotonic() + 60
            while router.backfill_status(job["job_id"])[1]["state"] == "running" and time.monotonic() < deadline:
                time.sleep(0.02)
        assert router.backfill_status(job["job_id"])[1]["state"] == "failed"
    finally:
        teardown(router, shards)


# --------------------------------------------------------------------------
# spawned shards
# --------------------------------------------------------------------------


def test_a_child_dying_before_binding_names_its_cause():
    """A ``serve`` child that exits before it binds puts the end of its
    stderr (kept in a log beside its port file) into the error."""
    with pytest.raises(RuntimeError) as info:
        port_cluster.spawn_serve_shard("s0", 4, SIG, SUBNET, extra_args=["--backend", "cpu", "--no-such-flag"])
    message = str(info.value)
    assert "shard 's0' exited with 2 before binding" in message
    assert "unrecognized arguments: --no-such-flag" in message
    log_path = message.split("the end of its stderr (", 1)[1].split(")", 1)[0]
    assert log_path.endswith(".log") and os.path.basename(log_path).startswith("shard-s0-")
    os.remove(log_path)


def test_router_door_answers_a_burst_of_connects(worlds):
    """32 clients connecting together all get their answer (the door's
    listener backlog is 128, not the stdlib's 5)."""
    shards = shards_up(worlds, "port", 1)
    router = router_over(worlds, "port", shards)
    server = port_cluster.RouterHTTPServer(router).start()
    answers = []
    try:
        barrier = threading.Barrier(32)

        def client():
            barrier.wait(10)
            answers.append(get(server.port, "/metrics.json")[0])

        threads = [threading.Thread(target=client) for _ in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert answers == [200] * 32
        assert server._httpd.request_queue_size == 128
    finally:
        server.shutdown(timeout=10)
        for s in shards:
            s.stop(timeout=10)
