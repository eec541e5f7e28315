"""The port's fleet observability (`obs/fleet.py`) against the JAX
package's.

The reference's ``tests/test_fleet.py`` classes run on both packages
(``fleet`` = the port's module or the reference's) with the same
assertions, and the outputs are compared: the same snapshots render
byte-equal expositions, the same flight rings merge equal, the same shipped
spans graft the same subtree. A federation scrapes live daemons of both
packages, and a traced, carried request to the port's daemon ships the span
subtree the grafting expects. The router's fleet surfaces
(``TestRouterFleetSurfaces``: tenant accounting at the door and on the
shards, ``/metrics.json``, ``/metrics.prom``, ``/v1/cluster/status``,
``/debug/flight``, a dead shard dropping out) run over each package's
`ClusterRouter` and `LocalShard`s, and ``TestEndToEndStitch`` runs the
port's router over two ``serve --backend cpu`` children from
`spawn_serve_shard`: one sampled scatter is one rooted span tree.
"""

import os
import re
import time
from types import SimpleNamespace

import pytest

jax = pytest.importorskip("jax")

import ipc_proofs_tpu.obs as ref_obs  # noqa: E402
import ipc_proofs_tpu.obs.fleet as ref_fleet  # noqa: E402
import ipc_proofs_tpu.utils.metrics as ref_metrics  # noqa: E402
import ipc_proofs_tpu_torch.obs as port_obs  # noqa: E402
import ipc_proofs_tpu_torch.obs.fleet as port_fleet  # noqa: E402
import ipc_proofs_tpu_torch.utils.metrics as port_metrics  # noqa: E402

from _torch_http import port_server, post, ref_server, shutdown, worlds  # noqa: E402

PACKAGES = {
    "port": (port_fleet, port_obs, port_metrics.Metrics),
    "ref": (ref_fleet, ref_obs, ref_metrics.Metrics),
}


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


_PROM_SAMPLE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*"
    r"(\{[a-zA-Z_][a-zA-Z0-9_]*=\"(?:[^\"\\\n]|\\.)*\""
    r"(,[a-zA-Z_][a-zA-Z0-9_]*=\"(?:[^\"\\\n]|\\.)*\")*\})?"
    r" -?[0-9.e+-]+(\.[0-9]+)?$"
)


def _check_prom_text(text):
    types = {}
    for line in text.splitlines():
        if not line:
            continue
        if line.startswith("# HELP "):
            assert len(line.split(" ", 3)) == 4, line
        elif line.startswith("# TYPE "):
            _, _, family, kind = line.split(" ")
            assert kind in ("counter", "gauge", "summary") and family not in types, line
            types[family] = kind
        else:
            assert _PROM_SAMPLE.fullmatch(line), f"malformed sample: {line!r}"
            name = line.split("{", 1)[0].split(" ", 1)[0]
            assert name in types or re.sub(r"_(total|sum|count)$", "", name) in types, line
    return types


def _snap(counters=None, gauges=None, hists=None, uptime=1.0):
    out = {"counters": dict(counters or {}), "uptime_s": uptime}
    if gauges:
        out["gauges"] = dict(gauges)
    if hists:
        out["histograms"] = dict(hists)
    return out


# --------------------------------------------------------------------------
# TestTenantLedger
# --------------------------------------------------------------------------


@pytest.mark.parametrize(
    "body,headers,expect",
    [
        ({"tenant": "acme"}, {"X-IPC-Tenant": "other"}, "acme"),
        ({}, {"X-IPC-Tenant": "acme-2"}, "acme-2"),
        ({"tenant": 'a b/c"d'}, {}, "a_b_c_d"),
        ({"tenant": "x" * 200}, {}, "x" * 64),
        ({}, {}, None),
        ({"tenant": ""}, {}, None),
        ({"tenant": "   "}, {}, None),
        ({"tenant": 7}, {}, None),
        (None, None, None),
    ],
    ids=["body-wins", "header", "sanitized", "bounded", "none", "empty", "blank", "not-a-string", "no-body"],
)
def test_extract_tenant_equals_reference(body, headers, expect):
    assert port_fleet.extract_tenant(body, headers) == ref_fleet.extract_tenant(body, headers) == expect


def test_top_k_overflow_pools_into_other(pkg):
    fleet, _, Metrics = pkg
    m = Metrics()
    ledger = fleet.TenantLedger(metrics=m, top_k=2)
    assert ledger.account("a", nbytes=10) == "a"
    assert ledger.account("b") == "b"
    assert ledger.account("c", nbytes=5) == "other"
    assert ledger.account("a") == "a"
    assert ledger.account(None) == "other"
    assert ledger.known() == ["a", "b"]
    assert m.counter_value("tenant.requests.a") == 2
    assert m.counter_value("tenant.requests.other") == 2
    assert m.counter_value("tenant.bytes.a") == 10
    assert m.counter_value("tenant.bytes.other") == 5
    assert m.counter_value("tenant.bytes.b") == 0
    assert ledger.slot_for("b") == "b" and ledger.slot_for("zz") == "other"
    assert ledger.account_bytes("b", 7) == "b" and m.counter_value("tenant.requests.b") == 1


# --------------------------------------------------------------------------
# TestMergeMath
# --------------------------------------------------------------------------


def test_counters_and_gauges_sum(pkg):
    fleet, _, _ = pkg
    assert fleet.merge_counters([{"a": 1, "b": 2}, {"a": 3}, None, {}]) == {"a": 4, "b": 2}
    assert fleet.merge_gauges([{"depth": 2}, {"depth": 5}]) == {"depth": 7}


def test_histograms_weighted_mean_and_max_tail(pkg):
    fleet, _, _ = pkg
    merged = fleet.merge_histograms([
        {"lat": {"count": 2, "mean": 10.0, "p50": 10.0, "p99": 20.0}},
        {"lat": {"count": 6, "mean": 30.0, "p50": 25.0, "p99": 90.0}},
        {"lat": {"count": 0, "mean": 999.0, "p99": 999.0}},
    ])
    assert merged["lat"]["count"] == 8
    assert merged["lat"]["mean"] == pytest.approx((10 * 2 + 30 * 6) / 8)
    assert (merged["lat"]["p50"], merged["lat"]["p99"]) == (25.0, 90.0)
    assert fleet.merge_histograms([{"lat": {"count": 0, "mean": 1.0}}]) == {}


# --------------------------------------------------------------------------
# TestFleetPrometheus
# --------------------------------------------------------------------------

_SHARDS = {
    "s0": _snap({"serve.requests": 3}, gauges={"serve.queue_depth.http": 2},
                hists={"latency_ms": {"count": 2, "mean": 10.0, "p50": 10.0, "p99": 20.0}}),
    "s1": _snap({"serve.requests": 5}, gauges={"serve.queue_depth.http": 1},
                hists={"latency_ms": {"count": 2, "mean": 20.0, "p50": 18.0, "p99": 40.0}}),
}


def test_shard_labels_and_fleet_aggregates(pkg):
    fleet, _, _ = pkg
    text = fleet.render_fleet_prometheus(_SHARDS, router_snap=_snap({"cluster.requests": 4}))
    types = _check_prom_text(text)
    assert types["ipc_serve_requests_total"] == "counter"
    assert types["ipc_uptime_seconds"] == "gauge"
    assert types["ipc_latency_ms"] == "summary"
    for sample in (
        'ipc_serve_requests_total{shard="s0"} 3', 'ipc_serve_requests_total{shard="s1"} 5',
        'ipc_serve_requests_total{shard="fleet"} 8', 'ipc_cluster_requests_total{shard="router"} 4',
        'ipc_cluster_requests_total{shard="fleet"} 4', 'ipc_serve_queue_depth_http{shard="fleet"} 3',
        'ipc_latency_ms{shard="fleet",quantile="0.99"} 40', 'ipc_latency_ms_sum{shard="fleet"} 60',
        'ipc_latency_ms_count{shard="fleet"} 4',
    ):
        assert sample in text, sample


def test_dead_shard_drops_out_but_fleet_serves(pkg):
    fleet, _, _ = pkg
    text = fleet.render_fleet_prometheus({"s0": _snap({"serve.requests": 3}), "s1": None})
    _check_prom_text(text)
    assert 'shard="s0"' in text and 'shard="s1"' not in text
    assert 'ipc_serve_requests_total{shard="fleet"} 3' in text


@pytest.mark.parametrize("router", [False, True], ids=["shards", "with-router"])
def test_fleet_exposition_byte_equal(router):
    router_snap = _snap({"cluster.requests": 4, "weird name-x": 2}, gauges={"g": 1.5}) if router else None
    shards = dict(_SHARDS, s2=None, s3=_snap({"serve.requests": 0}, uptime=2.5))
    assert port_fleet.render_fleet_prometheus(shards, router_snap=router_snap) == ref_fleet.render_fleet_prometheus(
        shards, router_snap=router_snap
    )


def test_merge_flight_snapshots_equal_reference(monkeypatch):
    # both packages stamp the merge with round(time.time(), 3): one wall
    # clock for both calls, or a millisecond boundary between them differs
    clock = SimpleNamespace(time=lambda now=time.time(): now)
    for module in (port_fleet, ref_fleet):
        monkeypatch.setattr(module, "time", clock)
    rings = {
        "s0": {"spans": [{"name": "a", "wall_ts": 3.0}, {"name": "b", "wall_ts": 1.0}],
               "logs": [{"msg": "w", "ts": 2.0, "level": "WARNING"}]},
        "s1": None,
        "s2": {"spans": [{"name": "c", "wall_ts": 2.0}], "logs": []},
    }
    local = {"spans": [{"name": "r", "wall_ts": 4.0}], "logs": [{"msg": "e", "ts": 1.0, "level": "ERROR"}]}
    assert port_fleet.merge_flight_snapshots(rings, local_snap=local) == ref_fleet.merge_flight_snapshots(
        rings, local_snap=local
    )


# --------------------------------------------------------------------------
# TestFleetFederation
# --------------------------------------------------------------------------


class _FakeShardNet:
    def __init__(self):
        self.calls = []
        self.requests = 2

    def fetch(self, url, timeout_s):
        self.calls.append(url)
        if "dead" in url:
            raise OSError("connection refused")
        if url.endswith("/metrics.json"):
            return _snap({"serve.requests": self.requests})
        return {"status": "ok"}


def test_scrape_is_fail_soft_per_shard(pkg):
    fleet, _, Metrics = pkg
    net = _FakeShardNet()
    m = Metrics()
    fed = fleet.FleetFederation(lambda: {"s0": "http://h/s0", "s1": "http://dead:1"}, metrics=m,
                                interval_s=60.0, fetch=net.fetch)
    result = fed.scrape()
    good, bad = result["shards"]["s0"], result["shards"]["s1"]
    assert good["error"] is None and good["metrics"]["counters"]["serve.requests"] == 2
    assert good["healthz"]["status"] == "ok"
    assert bad["metrics"] is None and bad["error"]
    assert m.counter_value("fleet.scrapes") == 2 and m.counter_value("fleet.scrape_errors") == 1


def test_latest_caches_until_rescraped(pkg):
    fleet, _, Metrics = pkg
    net = _FakeShardNet()
    fed = fleet.FleetFederation(lambda: {"s0": "http://h/s0"}, metrics=Metrics(), interval_s=60.0, fetch=net.fetch)
    first = fed.latest()
    n_calls = len(net.calls)
    assert fed.latest() is first and len(net.calls) == n_calls
    net.requests = 9
    fed.scrape()
    assert fed.latest()["shards"]["s0"]["metrics"]["counters"]["serve.requests"] == 9


def test_scrape_thread_lifecycle(pkg):
    fleet, _, Metrics = pkg
    net = _FakeShardNet()
    fed = fleet.FleetFederation(lambda: {"s0": "http://h/s0"}, metrics=Metrics(), interval_s=0.01, fetch=net.fetch)
    fed.start()
    fed.start()
    deadline = time.time() + 5.0
    while not net.calls and time.time() < deadline:
        time.sleep(0.01)
    fed.stop()
    assert net.calls and fed._thread is None


def test_federation_scrapes_live_daemons_of_both_packages():
    """The port's federation over a port daemon and a reference daemon
    (stdlib HTTP, the shards' ``/metrics.json`` and ``/healthz``), rendered
    as one fleet exposition with both shards and their sum."""
    port_world, ref_world = worlds(2, receipts=2, events=2)
    servers = port_server(port_world, max_wait_ms=1.0), ref_server(ref_world, max_wait_ms=1.0)
    try:
        for httpd, n in zip(servers, (2, 3)):
            for i in range(n):
                assert post(httpd.port, "/v1/generate", {"pair_index": i % 2, "tenant": "acme"})[0] == 200
        m = port_metrics.Metrics()
        fed = port_fleet.FleetFederation(
            lambda: {"s0": f"http://127.0.0.1:{servers[0].port}", "s1": f"http://127.0.0.1:{servers[1].port}"},
            metrics=m, interval_s=60.0,
        )
        result = fed.scrape()
        snaps = {name: shard["metrics"] for name, shard in result["shards"].items()}
        assert all(shard["error"] is None and shard["healthz"]["status"] == "ok" for shard in result["shards"].values())
        text = port_fleet.render_fleet_prometheus(snaps)
        _check_prom_text(text)
        assert 'ipc_tenant_requests_acme_total{shard="s0"} 2' in text
        assert 'ipc_tenant_requests_acme_total{shard="s1"} 3' in text
        assert 'ipc_tenant_requests_acme_total{shard="fleet"} 5' in text
        assert text == ref_fleet.render_fleet_prometheus(snaps)
    finally:
        shutdown(*servers)


# --------------------------------------------------------------------------
# TestGraftSpans
# --------------------------------------------------------------------------


@pytest.fixture()
def _clean_flight_rings():
    for _, obs, _ in PACKAGES.values():
        obs.get_flight_recorder().clear()
    yield
    for _, obs, _ in PACKAGES.values():
        obs.get_flight_recorder().clear()


def _shipped():
    return [
        {"name": "http.generate", "trace_id": "t9", "span_id": "1", "parent_id": "77", "ts_us": 5, "dur_us": 10,
         "wall_ts": 1000.0, "thread": "srv", "attrs": {"pair": 3}},
        {"name": "serve.generate", "trace_id": "t9", "span_id": "2", "parent_id": "1", "ts_us": 6, "dur_us": 5,
         "wall_ts": 1000.1, "thread": "wkr"},
        "not-a-dict",
        {"trace_id": "t9", "span_id": "9"},
    ]


def test_remap_rebase_and_graft_point(pkg, _clean_flight_rings):
    fleet, obs, Metrics = pkg
    m = Metrics()
    collector = obs.enable_tracing(metrics=m)
    try:
        assert fleet.graft_spans(_shipped(), "s0", metrics=m) == 2
        spans = {s.span_id: s for s in collector.snapshot()}
        assert set(spans) == {"s0:1", "s0:2"}
        assert spans["s0:1"].parent_id == "77" and spans["s0:2"].parent_id == "s0:1"
        assert spans["s0:1"].attrs == {"pair": 3, "shard": "s0"}
        assert spans["s0:1"].thread_name == "s0/srv" and spans["s0:1"].dur_us == 10
        assert all(s.sampled for s in spans.values())
        assert m.counter_value("fleet.spans_grafted") == 2
    finally:
        obs.disable_tracing()


def test_grafted_spans_equal_reference(_clean_flight_rings):
    grafted = {}
    for name, (fleet, obs, Metrics) in PACKAGES.items():
        collector = obs.enable_tracing(metrics=Metrics())
        try:
            fleet.graft_spans(_shipped(), "s3")
            grafted[name] = sorted(
                (s.name, s.trace_id, s.span_id, s.parent_id, s.dur_us, s.thread_name, tuple(sorted(s.attrs.items())))
                for s in collector.snapshot()
            )
        finally:
            obs.disable_tracing()
    assert grafted["port"] == grafted["ref"] and len(grafted["port"]) == 2


def test_carried_request_ships_its_subtree_for_grafting(_clean_flight_rings):
    """A sampled request carrying a remote trace context gets its span
    subtree (``spans``, ``spans_pid``) in the response; grafting it under
    the caller's span re-roots it, as the router does."""
    port_world, _ = worlds(2, receipts=2, events=2)
    collector = port_obs.enable_tracing(metrics=port_metrics.Metrics())
    httpd = port_server(port_world, max_wait_ms=1.0)
    try:
        carrier = {"trace_id": "feedfacecafebeef", "span_id": "4242", "sampled": True}
        status, _, out = post(httpd.port, "/v1/generate", {"pair_index": 1, "trace": carrier})
        assert status == 200 and out["spans_pid"] == os.getpid()
        names = {s["name"] for s in out["spans"]}
        assert "http.generate" in names
        assert all(s["trace_id"] == carrier["trace_id"] for s in out["spans"])
        roots = [s for s in out["spans"] if s["parent_id"] == carrier["span_id"]]
        assert [s["name"] for s in roots] == ["http.generate"]
        before = {s.span_id for s in collector.snapshot()}
        assert port_fleet.graft_spans(out["spans"], "s7") == len(out["spans"])
        grafted = {s.span_id: s for s in collector.snapshot() if s.span_id not in before}
        assert len(grafted) == len(out["spans"]) and all(sid.startswith("s7:") for sid in grafted)
        assert [s.parent_id for s in grafted.values() if s.name == "http.generate"] == [carrier["span_id"]]
    finally:
        httpd.shutdown(timeout=30)
        port_obs.disable_tracing()


# --------------------------------------------------------------------------
# TestRouterFleetSurfaces: the router's fleet surfaces over LocalShards
# --------------------------------------------------------------------------

import ipc_proofs_tpu.cluster as ref_cluster  # noqa: E402
import ipc_proofs_tpu_torch.cluster as port_cluster  # noqa: E402
from ipc_proofs_tpu.proofs.generator import EventProofSpec as RefSpec  # noqa: E402
from ipc_proofs_tpu.serve.service import ServiceConfig as RefServiceConfig  # noqa: E402
from ipc_proofs_tpu_torch.proofs.generator import EventProofSpec  # noqa: E402
from ipc_proofs_tpu_torch.serve import ServiceConfig  # noqa: E402

from _torch_http import SIG, SUBNET, get, request  # noqa: E402

CLUSTERS = {
    "port": (port_cluster, port_fleet, EventProofSpec, lambda: ServiceConfig(device="cpu")),
    "ref": (ref_cluster, ref_fleet, RefSpec, RefServiceConfig),
}


@pytest.fixture(params=sorted(CLUSTERS))
def fleet_cluster(request):
    cluster, fleet, Spec, config = CLUSTERS[request.param]
    port_world, ref_world = worlds(4, receipts=4, events=2, match_rate=0.3, base_height=61_000)
    store, pairs, _ = port_world if request.param == "port" else ref_world
    shards = [
        cluster.LocalShard(f"s{i}", store, pairs, Spec(event_signature=SIG, topic_1=SUBNET), config=config()).start()
        for i in range(2)
    ]
    router = cluster.ClusterRouter(
        {s.name: s.url for s in shards}, pairs, scrape_interval_s=60.0, scrape_timeout_s=5.0
    )
    server = cluster.RouterHTTPServer(router).start()
    yield server.port, router, shards, fleet
    server.shutdown(timeout=10)
    for s in shards:
        try:
            s.stop(timeout=10)
        except Exception:
            pass


def _shard_json(shard, path):
    return get(int(shard.url.rsplit(":", 1)[1]), path)[2]


def test_tenant_accounting_front_door_and_forwarded(fleet_cluster):
    port, router, shards, fleet = fleet_cluster
    assert post(port, "/v1/generate", {"pair_index": 0, "tenant": "acme corp!"})[0] == 200
    assert post(port, "/v1/generate", {"pair_index": 1}, headers={"X-IPC-Tenant": "beta"})[0] == 200
    assert post(port, "/v1/generate", {"pair_index": 2})[0] == 200
    assert router.metrics.counter_value("tenant.requests.acme_corp_") == 1
    assert router.metrics.counter_value("tenant.requests.beta") == 1
    assert router.metrics.counter_value("tenant.requests.anonymous") >= 1
    assert router.metrics.counter_value("tenant.bytes.acme_corp_") > 0
    shard_counters = fleet.merge_counters(_shard_json(s, "/metrics.json").get("counters", {}) for s in shards)
    assert shard_counters.get("tenant.requests.acme_corp_", 0) == 1
    assert shard_counters.get("tenant.requests.beta", 0) == 1


def test_metrics_json_and_prom_surfaces(fleet_cluster):
    port, _router, _shards, _fleet = fleet_cluster
    assert post(port, "/v1/generate", {"pair_index": 0})[0] == 200
    status, _, snap = get(port, "/metrics.json")
    assert status == 200 and snap["counters"]["cluster.requests"] >= 1
    status, _, snap2 = get(port, "/metrics")
    assert status == 200 and "counters" in snap2
    status, hdrs, raw = request(port, "GET", "/metrics.prom")
    assert status == 200 and hdrs["Content-Type"].startswith("text/plain; version=0.0.4")
    text = raw.decode()
    _check_prom_text(text)
    for label in ('shard="s0"', 'shard="s1"', 'shard="router"', 'shard="fleet"'):
        assert label in text, label
    assert 'ipc_serve_accepted_generate_total{shard="fleet"}' in text


def test_cluster_status_and_flight_surfaces(fleet_cluster):
    port, _router, _shards, _fleet = fleet_cluster
    assert post(port, "/v1/generate", {"pair_index": 0})[0] == 200
    status, _, obj = get(port, "/v1/cluster/status")
    assert status == 200
    assert set(obj["ring"]) == set(obj["shards"]) == {"s0", "s1"}
    assert all(e["alive"] for e in obj["ring"].values())
    assert all(e["status"] == "ok" and e["scrape_error"] is None for e in obj["shards"].values())
    assert obj["router"]["requests"] >= 1
    assert isinstance(obj["delivery_backlog"], int) and isinstance(obj["store_disk_bytes"], int)
    assert "last_finalized_epoch" in obj and obj["replication"] == {"factor": 1, "last_pass": None}
    status, _, obj = get(port, "/debug/flight")
    assert status == 200 and obj["shards"] == ["s0", "s1"] and obj["failed"] == []
    assert obj["spans"] and all("shard" in sp for sp in obj["spans"])
    walls = [sp.get("wall_ts", 0.0) for sp in obj["spans"]]
    assert walls == sorted(walls, reverse=True)


def test_fleet_keeps_serving_when_a_shard_dies(fleet_cluster):
    port, router, shards, _fleet = fleet_cluster
    shards[1].kill()
    result = router.federation.scrape()
    assert result["shards"]["s1"]["error"] and result["shards"]["s1"]["metrics"] is None
    assert router.metrics.counter_value("fleet.scrape_errors") >= 1
    status, _, raw = request(port, "GET", "/metrics.prom")
    assert status == 200
    _check_prom_text(raw.decode())
    assert 'shard="s0"' in raw.decode()
    status, _, obj = get(port, "/v1/cluster/status")
    assert status == 200
    assert obj["shards"]["s1"]["status"] == "unreachable" and obj["shards"]["s1"]["scrape_error"]
    assert obj["shards"]["s0"]["status"] == "ok"


def test_router_skips_same_pid_subtrees(_clean_flight_rings):
    """A LocalShard lives in the router's process: its spans are already
    on the spine, so grafting its shipped subtree would record each twice;
    either way the plumbing fields never reach the client."""
    port_world, _ = worlds(2, receipts=2, events=2)
    router = port_cluster.ClusterRouter({"s0": "http://127.0.0.1:9"}, port_world[1], scrape_interval_s=60.0)
    collector = port_obs.enable_tracing(metrics=port_metrics.Metrics())
    try:
        ship = {"name": "http.generate", "trace_id": "t1", "span_id": "4", "parent_id": "", "ts_us": 0,
                "dur_us": 1, "wall_ts": 1.0, "thread": "srv"}
        same = {"ok": 1, "spans": [dict(ship)], "spans_pid": os.getpid()}
        router._graft_shard_spans("s0", same)
        assert same == {"ok": 1} and collector.snapshot() == []
        other = {"ok": 1, "spans": [dict(ship)], "spans_pid": os.getpid() + 1}
        router._graft_shard_spans("s0", other)
        assert [s.span_id for s in collector.snapshot()] == ["s0:4"]
    finally:
        port_obs.disable_tracing()
        router.close()


# --------------------------------------------------------------------------
# TestEndToEndStitch: subprocess shards → one rooted tree
# --------------------------------------------------------------------------


def test_sampled_scatter_collapses_into_one_rooted_tree(_clean_flight_rings):
    """A sampled ``generate_range`` through two real ``serve --backend
    cpu`` children ships each shard's span subtree back in-band, and the
    port's router grafts every one under its scatter spans: exactly ONE
    rooted tree, no orphans."""
    n_pairs, receipts, match_rate = 4, 4, 0.5
    from ipc_proofs_tpu_torch.fixtures import build_range_world

    # the children's world: `serve --demo-world` builds it with these arguments
    _, pairs, _ = build_range_world(n_pairs, receipts_per_pair=receipts, match_rate=match_rate,
                                    signature=SIG, topic1=SUBNET)
    m = port_metrics.Metrics()
    collector = port_obs.enable_tracing(metrics=m)
    shards = []
    try:
        shards = [
            port_cluster.spawn_serve_shard(
                f"s{k}", n_pairs, SIG, SUBNET,
                extra_args=["--demo-receipts", str(receipts), "--demo-match-rate", str(match_rate),
                            "--trace-out", os.devnull, "--trace-sample", "1.0", "--backend", "cpu"],
            )
            for k in range(2)
        ]
        assert all(os.path.exists(s.log_path) for s in shards)
        router = port_cluster.ClusterRouter({s.name: s.url for s in shards}, pairs, metrics=m)
        try:
            status, obj = router.generate_range(list(range(n_pairs)), chunk_size=2)
            assert status == 200, obj
            spans = [s for s in collector.snapshot() if s.trace_id == obj["trace_id"]]
            ids = {s.span_id for s in spans}
            roots = [s for s in spans if not s.parent_id or s.parent_id not in ids]
            assert len(roots) == 1, sorted((s.name, s.span_id, s.parent_id) for s in roots)
            assert roots[0].name == "cluster.generate_range"
            grafted = [s for s in spans if ":" in s.span_id]
            assert grafted and {s.span_id.split(":", 1)[0] for s in grafted} <= {"s0", "s1"}
            assert {s.attrs.get("shard") for s in grafted} <= {"s0", "s1"}
            assert any(s.name == "http.generate_range" for s in grafted)
            assert m.counter_value("fleet.spans_grafted") >= len(grafted)
        finally:
            router.close()
    finally:
        port_obs.disable_tracing()
        for s in shards:
            try:
                s.stop(timeout_s=20.0)
            except Exception:
                s.kill()
    for s in shards:
        assert s.proc.returncode == 0
        with open(s.log_path) as fh:
            assert "kernel launches:" in fh.read()
        os.remove(s.log_path)
