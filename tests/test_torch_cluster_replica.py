"""The multi-host cluster of the port against the JAX package's: the
reference's ``tests/test_cluster_replica.py``, whole, on both packages.

Both run over one seeded range world (equal pair tables and blocks): the
reference on its host paths, the port's shards on ``device="cpu"``. Every
bundle is compared with the single daemon's bytes (the reference's chunked
driver), and where a case takes a router the four wirings run it: each
package's router over its own `LocalShard`s, and each over the other's.

- kill a host (R=2, three hosts, any victim): the next scatter fails over
  to the exact bytes, and a supervision pass restores R full copies of the
  dead owner's rolled segments on both survivors;
- read-repair: every rolled frame of one shard corrupted, the scatter stays
  byte-identical with no new RPC call, repairs equal integrity evictions;
- the replication plan: deterministic, a dead owner needs R full copies,
  R=1 is off — equal in both packages;
- the cut-through relay: the streamed scatter decodes to the buffered one's
  bytes, every group relayed (not buffered); its router peaks below the
  store-and-forward router's (tracemalloc, one package at a time);
- a shard dying after its first block: a deduped failover retry (exact
  bytes) or, with no survivor, a typed abort chunk;
- remote members (`RemoteShard`): probed, then a full ring member.
"""

import io
import json
import os
import tracemalloc
import types

import pytest

pytest.importorskip("jax")

import ipc_proofs_tpu.cluster as ref_cluster  # noqa: E402
import ipc_proofs_tpu_torch.cluster as port_cluster  # noqa: E402
import ipc_proofs_tpu_torch.ops.verify as verify_mod  # noqa: E402
from ipc_proofs_tpu.fixtures import build_range_world as ref_build_range_world  # noqa: E402
from ipc_proofs_tpu.proofs.generator import EventProofSpec as RefSpec  # noqa: E402
from ipc_proofs_tpu.proofs.range import (  # noqa: E402
    generate_event_proofs_for_range_chunked as ref_chunked,
)
from ipc_proofs_tpu.serve.service import ServiceConfig as RefServiceConfig  # noqa: E402
from ipc_proofs_tpu.store.faults import LocalLotusSession as RefLocalLotusSession  # noqa: E402
from ipc_proofs_tpu.store.rpc import LotusClient as RefLotusClient  # noqa: E402
from ipc_proofs_tpu.store.rpc import RpcBlockstore as RefRpcBlockstore  # noqa: E402
from ipc_proofs_tpu.utils.metrics import Metrics as RefMetrics  # noqa: E402
from ipc_proofs_tpu.witness import stream as ref_stream  # noqa: E402
from ipc_proofs_tpu.witness.errors import StreamAbortError as RefStreamAbortError  # noqa: E402
from ipc_proofs_tpu_torch.fixtures import build_range_world  # noqa: E402
from ipc_proofs_tpu_torch.proofs.generator import EventProofSpec  # noqa: E402
from ipc_proofs_tpu_torch.serve import ServiceConfig  # noqa: E402
from ipc_proofs_tpu_torch.store.faults import LocalLotusSession  # noqa: E402
from ipc_proofs_tpu_torch.store.rpc import LotusClient, RpcBlockstore  # noqa: E402
from ipc_proofs_tpu_torch.utils.metrics import Metrics  # noqa: E402
from ipc_proofs_tpu_torch.witness import stream as port_stream  # noqa: E402
from ipc_proofs_tpu_torch.witness.errors import StreamAbortError  # noqa: E402

from _torch_http import request  # noqa: E402

SIG = "NewTopDownMessage(bytes32,uint256)"
SUBNET = "calib-subnet-1"
ACTOR = 1001
WORLD_KW = dict(signature=SIG, topic1=SUBNET, actor_id=ACTOR, base_height=51_000)

PKGS = {
    "port": types.SimpleNamespace(
        cluster=port_cluster, Spec=EventProofSpec, Metrics=Metrics, stream=port_stream,
        Abort=StreamAbortError, LotusClient=LotusClient, RpcBlockstore=RpcBlockstore,
        Session=LocalLotusSession, config=lambda **kw: ServiceConfig(device="cpu", **kw),
    ),
    "ref": types.SimpleNamespace(
        cluster=ref_cluster, Spec=RefSpec, Metrics=RefMetrics, stream=ref_stream,
        Abort=RefStreamAbortError, LotusClient=RefLotusClient, RpcBlockstore=RefRpcBlockstore,
        Session=RefLocalLotusSession, config=lambda **kw: RefServiceConfig(**kw),
    ),
}
WIRINGS = {
    "port": ("port", "port"),
    "ref": ("ref", "ref"),
    "port-router/ref-shards": ("port", "ref"),
    "ref-router/port-shards": ("ref", "port"),
}


@pytest.fixture(autouse=True)
def _no_autotune(monkeypatch):
    """A store_dir shard measures the lane crossover at start; the tests
    keep the default one (the autotune rule has its own tests)."""
    monkeypatch.setattr(verify_mod, "autotune_crossover", lambda store_dir, **kw: None)


@pytest.fixture(scope="module")
def worlds():
    return {
        "port": build_range_world(6, 6, 3, 0.3, **WORLD_KW),
        "ref": ref_build_range_world(6, 6, 3, 0.3, **WORLD_KW),
    }


def _spec(pkg):
    return PKGS[pkg].Spec(event_signature=SIG, topic_1=SUBNET, actor_id_filter=ACTOR)


def _canonical_obj(obj) -> str:
    return json.dumps(obj, sort_keys=True)


@pytest.fixture(scope="module")
def direct(worlds):
    store, pairs, _ = worlds["ref"]
    return _canonical_obj(ref_chunked(store, list(pairs), _spec("ref"), chunk_size=3).to_json_obj())


def _disk_shards_up(worlds, pkg, root, n):
    """N shards of ``pkg``, each with its OWN disk tier (1-byte roll
    threshold: every spilled block is a pullable rolled segment at once), a
    tiny tier-1 cache (repeat reads hit disk), and its own RPC-counted
    inner store — the Lotus stand-in whose ``rpc.calls`` the repair test
    pins."""
    ns = PKGS[pkg]
    bs, pairs, _ = worlds[pkg]
    shards, metrics = [], []
    for i in range(n):
        m = ns.Metrics()
        inner = ns.RpcBlockstore(
            ns.LotusClient("http://test-cluster-replica", session=ns.Session(bs), metrics=m)
        )
        shards.append(
            ns.cluster.LocalShard(
                f"s{i}", inner, pairs, _spec(pkg),
                config=ns.config(
                    max_batch=8, max_wait_ms=5.0, workers=1,
                    store_dir=os.path.join(str(root), f"s{i}"), store_owner=f"s{i}",
                    store_segment_max_bytes=1, cache_max_bytes=1, batch_rpc=False,
                ),
                metrics=m,
            ).start()
        )
        metrics.append(m)
    return shards, metrics


def _plain_shards_up(worlds, pkg, n, prefix="s"):
    store, pairs, _ = worlds[pkg]
    return [
        PKGS[pkg].cluster.LocalShard(f"{prefix}{i}", store, pairs, _spec(pkg), config=PKGS[pkg].config()).start()
        for i in range(n)
    ]


def _teardown(router, shards):
    router.close()
    for s in shards:
        try:
            s.stop(timeout=10)
        except Exception:
            pass


def _rpc_calls(m) -> int:
    return m.snapshot()["counters"].get("rpc.calls", 0)


def _owned_segments(shard, owner: str) -> "set[str]":
    return {
        d["name"] for d in shard.service.disk_store.segment_files() if d["owner"] == owner and not d["active"]
    }


# --------------------------------------------------------------------------
# kill a host
# --------------------------------------------------------------------------


@pytest.mark.parametrize("victim_idx", [0, 1, 2])
@pytest.mark.parametrize("wiring", sorted(WIRINGS))
def test_kill_any_host_yields_identical_bytes_and_restores_r(worlds, direct, tmp_path, wiring, victim_idx):
    """R=2, three hosts: warm, replicate, kill ONE host — the next scatter
    fails over to the exact bytes, and a supervision pass re-replicates
    the dead owner's arcs onto BOTH survivors (a dead owner needs R full
    copies: its own died with it)."""
    router_pkg, shard_pkg = WIRINGS[wiring]
    _, pairs, _ = worlds[router_pkg]
    shards, _metrics = _disk_shards_up(worlds, shard_pkg, tmp_path, 3)
    m = PKGS[router_pkg].Metrics()
    router = PKGS[router_pkg].cluster.ClusterRouter(
        {s.name: s.url for s in shards}, pairs, replication_factor=2, metrics=m, scrape_interval_s=60.0,
    )
    try:
        status, obj = router.generate_range(list(range(len(pairs))), chunk_size=3)
        assert status == 200, obj
        summary = router.replicate_now()
        assert not summary["errors"], summary
        victim = shards[victim_idx]
        victim_segs = _owned_segments(victim, victim.name)
        assert victim_segs
        victim.kill()

        status, obj = router.generate_range(list(range(len(pairs))), chunk_size=3)
        assert status == 200, obj
        assert _canonical_obj(obj["bundle"]) == direct
        assert m.counter_value("cluster.shard_failovers") > 0
        assert router.alive_shards() == sorted(s.name for s in shards if s is not victim)

        summary = router.replicate_now()
        assert not summary["errors"], summary
        for survivor in shards:
            if survivor is not victim:
                assert victim_segs <= _owned_segments(survivor, victim.name)
    finally:
        _teardown(router, shards)


def _flip_last_byte(path: str) -> None:
    size = os.path.getsize(path)
    with open(path, "r+b") as fh:
        fh.seek(size - 1)
        b = fh.read(1)
        fh.seek(size - 1)
        fh.write(bytes([b[0] ^ 0x40]))


@pytest.mark.parametrize("wiring", sorted(WIRINGS))
def test_corrupt_frames_repair_from_replica_with_zero_rpc(worlds, direct, tmp_path, wiring):
    """Corrupt EVERY rolled frame on one shard: the next scatter stays
    byte-identical, every integrity eviction repairs from the replica peer,
    and the RPC (Lotus) call count moves on neither shard."""
    router_pkg, shard_pkg = WIRINGS[wiring]
    _, pairs, _ = worlds[router_pkg]
    shards, metrics = _disk_shards_up(worlds, shard_pkg, tmp_path, 2)
    m = PKGS[router_pkg].Metrics()
    router = PKGS[router_pkg].cluster.ClusterRouter(
        {s.name: s.url for s in shards}, pairs, replication_factor=2, metrics=m, scrape_interval_s=60.0,
    )
    try:
        status, _obj = router.generate_range(list(range(len(pairs))), chunk_size=3)
        assert status == 200
        summary = router.replicate_now()
        assert not summary["errors"], summary
        assert summary["under_replicated"] == []
        assert summary["plan"] == {"s0": ["s1"], "s1": ["s0"]}
        rpc_before = [_rpc_calls(mm) for mm in metrics]

        s0_dir = os.path.join(str(tmp_path), "s0")
        flipped = 0
        for name in sorted(os.listdir(s0_dir)):
            if name.endswith(".blk"):
                _flip_last_byte(os.path.join(s0_dir, name))
                flipped += 1
        assert flipped > 0

        status, obj = router.generate_range(list(range(len(pairs))), chunk_size=3)
        assert status == 200, obj
        assert _canonical_obj(obj["bundle"]) == direct
        assert [_rpc_calls(mm) for mm in metrics] == rpc_before
        c0 = metrics[0].snapshot()["counters"]
        assert c0.get("storex.integrity_evictions", 0) > 0
        assert c0.get("storex.replica_repairs", 0) == c0.get("storex.integrity_evictions", 0)
        assert "storex.replica_repair_misses" not in c0
        status, cs = router.cluster_status()
        assert status == 200
        assert cs["replication"]["factor"] == 2
        assert cs["replication"]["last_pass"]["plan"] == summary["plan"]
    finally:
        _teardown(router, shards)


# --------------------------------------------------------------------------
# the replication plan
# --------------------------------------------------------------------------


def _plans(pkg, worlds):
    router = PKGS[pkg].cluster.ClusterRouter(
        {f"s{i}": f"http://127.0.0.1:{9000 + i}" for i in range(3)}, worlds[pkg][1],
        replication_factor=2, scrape_interval_s=60.0,
    )
    try:
        with router._lock:
            plan1 = router._replication_plan_locked()
            plan2 = router._replication_plan_locked()
        router._shards["s0"].alive = False
        with router._lock:
            plan3 = router._replication_plan_locked()
        return plan1, plan2, plan3
    finally:
        router.close()


def test_plan_deterministic_and_dead_owner_needs_full_r(worlds):
    port, ref = _plans("port", worlds), _plans("ref", worlds)
    assert port == ref
    plan1, plan2, plan3 = port
    assert plan1 == plan2
    for owner, replicas in plan1.items():
        assert len(replicas) == 1 and owner not in replicas
    assert len(plan3["s0"]) == 2 and "s0" not in plan3["s0"]


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_factor_one_is_off(worlds, pkg):
    router = PKGS[pkg].cluster.ClusterRouter({"s0": "http://127.0.0.1:9000"}, worlds[pkg][1], scrape_interval_s=60.0)
    try:
        summary = router.replicate_now()
        assert summary == {"factor": 1, "plan": {}, "shards": {}, "errors": []}
    finally:
        router.close()


# --------------------------------------------------------------------------
# the cut-through relay
# --------------------------------------------------------------------------

STREAM = {"Accept": "application/x-ipc-bundle-stream"}


@pytest.mark.parametrize("wiring", sorted(WIRINGS))
def test_streamed_scatter_is_byte_identical_and_cut_through(worlds, direct, wiring):
    router_pkg, shard_pkg = WIRINGS[wiring]
    ns = PKGS[router_pkg]
    _, pairs, _ = worlds[router_pkg]
    shards = _plain_shards_up(worlds, shard_pkg, 2)
    m = ns.Metrics()
    router = ns.cluster.ClusterRouter({s.name: s.url for s in shards}, pairs, metrics=m, scrape_interval_s=60.0)
    server = ns.cluster.RouterHTTPServer(router).start()
    try:
        idxs = list(range(len(pairs)))
        st, _, raw = request(server.port, "POST", "/v1/generate_range", {"pair_indexes": idxs})
        assert st == 200
        buffered = json.loads(raw)
        st, hdrs, raw = request(server.port, "POST", "/v1/generate_range", {"pair_indexes": idxs}, headers=STREAM)
        assert st == 200 and hdrs.get("Content-Type") == ns.stream.STREAM_CONTENT_TYPE
        fields = ns.stream.decode_bundle_stream(raw)
        assert _canonical_obj(fields["bundle"]) == _canonical_obj(buffered["bundle"]) == direct
        assert m.counter_value("cluster.stream_cut_through") == fields["n_groups"]
    finally:
        server.shutdown(timeout=10)
        _teardown(router, shards)


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_cut_through_drops_router_peak_memory(pkg):
    """The same streamed scatter, relayed cut-through, peaks below the
    store-and-forward router (which buffers each shard's whole
    sub-response): by at least 10 % of the whole process's peak, the
    in-process shards' bundle build being a floor under both."""
    ns = PKGS[pkg]
    build = build_range_world if pkg == "port" else ref_build_range_world
    store, pairs, _ = build(8, 12, 6, 0.6, **WORLD_KW)
    shards = [
        ns.cluster.LocalShard(f"s{i}", store, pairs, _spec(pkg), config=ns.config()).start() for i in range(2)
    ]
    routers = {
        on: ns.cluster.ClusterRouter(
            {s.name: s.url for s in shards}, pairs, cut_through=on, scrape_interval_s=60.0
        )
        for on in (False, True)
    }
    idxs = list(range(len(pairs)))

    def run(router):
        out = router.generate_range(
            idxs, chunk_size=3,
            writer_factory=lambda: ns.stream.BundleStreamWriter(lambda buffers: None, metrics=ns.Metrics()),
        )
        assert out is None

    def peak(router):
        run(router)  # warm outside the window
        tracemalloc.start()
        run(router)
        _cur, peak_bytes = tracemalloc.get_traced_memory()
        tracemalloc.stop()
        return peak_bytes

    try:
        peak_buffered = peak(routers[False])
        peak_cut = peak(routers[True])
        assert peak_cut < peak_buffered * 0.9, (peak_cut, peak_buffered)
    finally:
        for router in routers.values():
            router.close()
        for s in shards:
            s.stop(timeout=10)


# --------------------------------------------------------------------------
# a shard dying mid-stream
# --------------------------------------------------------------------------


class _Tee:
    """File-like wrapper that records every byte read through it."""

    def __init__(self, fp):
        self.fp = fp
        self.buf = bytearray()

    def read(self, n=-1):
        got = self.fp.read(n)
        if got:
            self.buf.extend(got)
        return got


def _dies_after_first_block(pkg):
    """A `ShardClient` of ``pkg`` whose stream cleanly dies right after its
    first Block chunk: the wire shape of a host killed mid-stream."""
    ns = PKGS[pkg]

    class DiesAfterFirstBlock(ns.cluster.ShardClient):
        def post_stream(self, path, body):
            kind, payload = super().post_stream(path, body)
            if kind != "stream":
                return kind, payload
            tee = _Tee(payload)
            for chunk_kind, _chunk in ns.stream.iter_stream_chunks(tee):
                if chunk_kind == ns.stream.CHUNK_BLOCK:
                    break
            try:
                payload.close()
            except OSError:
                pass
            return "stream", io.BytesIO(bytes(tee.buf))

    return DiesAfterFirstBlock


@pytest.mark.parametrize("wiring", sorted(WIRINGS))
def test_death_after_first_block_fails_over_deduped(worlds, direct, wiring):
    router_pkg, shard_pkg = WIRINGS[wiring]
    ns = PKGS[router_pkg]
    _, pairs, _ = worlds[router_pkg]
    shards = _plain_shards_up(worlds, shard_pkg, 2)
    m = ns.Metrics()
    router = ns.cluster.ClusterRouter(
        {"s0": _dies_after_first_block(router_pkg)("s0", shards[0].url), "s1": ns.cluster.ShardClient("s1", shards[1].url)},
        pairs, metrics=m, scrape_interval_s=60.0,
    )
    server = ns.cluster.RouterHTTPServer(router).start()
    try:
        st, hdrs, raw = request(server.port, "POST", "/v1/generate_range",
                                {"pair_indexes": list(range(len(pairs)))}, headers=STREAM)
        assert st == 200 and hdrs.get("Content-Type") == ns.stream.STREAM_CONTENT_TYPE
        fields = ns.stream.decode_bundle_stream(raw)
        assert _canonical_obj(fields["bundle"]) == direct
        assert m.counter_value("cluster.shard_failovers") >= 1
        assert m.counter_value("cluster.stream_blocks_deduped") >= 1
    finally:
        server.shutdown(timeout=10)
        _teardown(router, shards)


@pytest.mark.parametrize("wiring", sorted(WIRINGS))
def test_death_with_no_survivor_is_a_typed_error_chunk(worlds, wiring):
    router_pkg, shard_pkg = WIRINGS[wiring]
    ns = PKGS[router_pkg]
    _, pairs, _ = worlds[router_pkg]
    shards = _plain_shards_up(worlds, shard_pkg, 1)
    router = ns.cluster.ClusterRouter(
        {"s0": _dies_after_first_block(router_pkg)("s0", shards[0].url)}, pairs, scrape_interval_s=60.0,
    )
    server = ns.cluster.RouterHTTPServer(router).start()
    try:
        st, hdrs, raw = request(server.port, "POST", "/v1/generate_range",
                                {"pair_indexes": list(range(len(pairs)))}, headers=STREAM)
        assert st == 200 and hdrs.get("Content-Type") == ns.stream.STREAM_CONTENT_TYPE
        with pytest.raises(ns.Abort) as info:
            ns.stream.decode_bundle_stream(raw)
        assert info.value.remote_error_type == "internal"
        assert str(info.value) == "all shards are dead"
    finally:
        server.shutdown(timeout=10)
        _teardown(router, shards)


# --------------------------------------------------------------------------
# remote members
# --------------------------------------------------------------------------


@pytest.mark.parametrize("wiring", sorted(WIRINGS))
def test_remote_member_probes_and_serves(worlds, direct, wiring):
    router_pkg, shard_pkg = WIRINGS[wiring]
    ns = PKGS[router_pkg]
    _, pairs, _ = worlds[router_pkg]
    backing = _plain_shards_up(worlds, shard_pkg, 2, prefix="b")
    try:
        remote = ns.cluster.RemoteShard(backing[0].url)
        health = remote.probe()
        assert isinstance(health, dict) and health["status"] == "ok"
        assert remote.alive and remote.name == backing[0].url.split("//", 1)[1]
        router = ns.cluster.ClusterRouter(
            {remote.name: remote.url, "s1": backing[1].url}, pairs, scrape_interval_s=60.0
        )
        try:
            status, obj = router.generate_range(list(range(len(pairs))), chunk_size=3)
            assert status == 200, obj
            assert _canonical_obj(obj["bundle"]) == direct
        finally:
            router.close()
        remote.stop()
        assert not remote.alive
    finally:
        for s in backing:
            s.stop(timeout=10)


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_dead_remote_probe_is_none(pkg):
    assert PKGS[pkg].cluster.RemoteShard("http://127.0.0.1:1", timeout_s=0.5).probe() is None
