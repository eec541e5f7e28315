"""The port's HTTP front end (`serve/httpd.py`) against the JAX package's.

Both packages' `ProofHTTPServer`s run over one seeded range world (the port
on ``device="cpu"``, the plain versions of its kernels; the reference on its
host paths) and receive the same requests over loopback. Compared:

- every route's status code, JSON body (trace ids, timings and span
  subtrees aside), ``Witness-Encoding`` / ``Retry-After`` headers and the
  ``Server-Timing`` shape: verify (plain, ``blocks_frame``, a ``claims``
  table), generate and generate_range with witness negotiation (identity,
  zlib, delta, aggregation, typed 400s), the 404s of the mounts that come
  with the subscription and cluster plane, the replication routes without a
  disk tier, deadlines at the door, draining, metrics, health and flight;
- the IPBS stream: decoded documents equal the buffered ones and the
  reference's, a disk-warm stream copies no block byte, an evicted store
  falls back to copies, and ``stream_ms`` rides the trailer;
- the registry: sealed logs byte-equal under fixed clocks and every
  ``/v1/registry/*`` answer equal;
- tenant QoS, honest ``Retry-After``, the deadline grid, disconnect
  cancellation and degraded serve as the reference's tests pin them.

A fault of the card is a 500 ``error_type: device`` (never a 400), and in
a stream already under way an in-band abort chunk of that type. No test
asserts a wall-time ratio.
"""

import json
import socket
import time

import pytest
import torch

jax = pytest.importorskip("jax")

import ipc_proofs_tpu.registry.registry as ref_registry_mod  # noqa: E402
import ipc_proofs_tpu_torch.ops.verify as verify_mod  # noqa: E402
import ipc_proofs_tpu_torch.registry.registry as port_registry_mod  # noqa: E402
from ipc_proofs_tpu.witness.stream import decode_bundle_stream as ref_decode_stream  # noqa: E402
from ipc_proofs_tpu_torch.backend import get_backend  # noqa: E402
from ipc_proofs_tpu_torch.ops.build import DeviceFaultError  # noqa: E402
from ipc_proofs_tpu_torch.ops.verify import VerifyLaneError  # noqa: E402
from ipc_proofs_tpu_torch.proofs.bundle import UnifiedProofBundle  # noqa: E402
from ipc_proofs_tpu_torch.proofs.generator import EventProofSpec  # noqa: E402
from ipc_proofs_tpu_torch.proofs.range import generate_event_proofs_for_range  # noqa: E402
from ipc_proofs_tpu_torch.serve import ProofHTTPServer, ProofService, ServiceConfig  # noqa: E402
from ipc_proofs_tpu_torch.store.blockstore import CachedBlockstore, RecordingBlockstore  # noqa: E402
from ipc_proofs_tpu_torch.store.failover import DegradedError, EndpointPool  # noqa: E402
from ipc_proofs_tpu_torch.store.faults import LocalLotusSession  # noqa: E402
from ipc_proofs_tpu_torch.store.rpc import LotusClient, RpcBlockstore  # noqa: E402
from ipc_proofs_tpu_torch.utils.metrics import Metrics  # noqa: E402
from ipc_proofs_tpu_torch.witness import WitnessOptions, aggregate_range_bundle, encode_bundle_fields  # noqa: E402
from ipc_proofs_tpu_torch.witness.stream import (  # noqa: E402
    STREAM_CONTENT_TYPE,
    StreamAbortError,
    decode_bundle_stream,
)

from _torch_http import (  # noqa: E402
    SIG,
    SUBNET,
    fixed_clocks,
    get,
    port_server,
    post,
    ref_server,
    request,
    shutdown,
    strip,
    timing_shape,
    worlds,
)

CPU = get_backend("gpu", device="cpu")
SPEC = EventProofSpec(event_signature=SIG, topic_1=SUBNET)


@pytest.fixture(scope="module")
def both_worlds():
    return worlds(4, receipts=4, events=2, match_rate=0.5)


@pytest.fixture(scope="module")
def served(both_worlds):
    """The 4-pair range bundle (the canonical bytes every daemon serves)."""
    (store, pairs, _), _ = both_worlds
    bundle = generate_event_proofs_for_range(store, pairs, SPEC, match_backend=CPU)
    assert len(bundle.event_proofs) >= 4
    return bundle


@pytest.fixture(autouse=True)
def _no_autotune(monkeypatch):
    """A store_dir daemon measures the lane crossover at start; the tests
    keep the default one (the autotune rule has its own tests)."""
    monkeypatch.setattr(verify_mod, "autotune_crossover", lambda store_dir, **kw: None)


@pytest.fixture()
def daemons(both_worlds):
    port_world, ref_world = both_worlds
    cfg = dict(max_batch=8, max_wait_ms=2.0, workers=2)
    servers = port_server(port_world, **cfg), ref_server(ref_world, **cfg)
    yield servers
    shutdown(*servers)


def _single(served, i=0):
    return UnifiedProofBundle([], [served.event_proofs[i]], served.blocks)


def _request_bodies(served, pairs):
    """The route grid's request bodies, by case id."""
    single = _single(served).to_json_obj()
    framed = encode_bundle_fields(_single(served, 1), WitnessOptions(encoding="zlib"))["bundle"]
    agg = aggregate_range_bundle(served, pairs, list(range(len(pairs))), claim_indexes=[0, 0, 1, 3])
    tampered = json.loads(json.dumps(single))
    tampered["event_proofs"][0]["event_data"]["emitter"] += 1
    return {
        "verify": ("POST", "/v1/verify", {"bundle": single}, None),
        "verify-unwrapped": ("POST", "/v1/verify", single, None),
        "verify-tampered": ("POST", "/v1/verify", {"bundle": tampered}, None),
        "verify-blocks-frame": ("POST", "/v1/verify", {"bundle": framed}, None),
        "verify-claims": ("POST", "/v1/verify", {"bundle": agg.bundle.to_json_obj(), "claims": agg.claims_json()}, None),
        "verify-malformed": ("POST", "/v1/verify", {"bundle": {"nonsense": 1}}, None),
        "verify-bad-claims": ("POST", "/v1/verify", {"bundle": single, "claims": [{"pair": 99}]}, None),
        "generate-0": ("POST", "/v1/generate", {"pair_index": 0}, None),
        "generate-3": ("POST", "/v1/generate", {"pair_index": 3}, None),
        "generate-zlib": ("POST", "/v1/generate", {"pair_index": 1, "witness_encoding": "zlib"}, None),
        "generate-accept-zlib": ("POST", "/v1/generate", {"pair_index": 2}, {"Accept-Witness-Encoding": "zlib"}),
        "generate-unknown-encoding": ("POST", "/v1/generate", {"pair_index": 0, "witness_encoding": "lz4"}, None),
        "generate-accept-unknown": ("POST", "/v1/generate", {"pair_index": 0}, {"Accept-Witness-Encoding": "snappy"}),
        "generate-bad-stream-field": ("POST", "/v1/generate", {"pair_index": 0, "stream": "yes"}, None),
        "generate-index-5": ("POST", "/v1/generate", {"pair_index": 5}, None),
        "generate-index-negative": ("POST", "/v1/generate", {"pair_index": -1}, None),
        "generate-index-string": ("POST", "/v1/generate", {"pair_index": "x"}, None),
        "generate-unknown-base": ("POST", "/v1/generate", {"pair_index": 0, "base_digest": "0" * 64}, None),
        "generate-tenant": ("POST", "/v1/generate", {"pair_index": 1, "tenant": "acme"}, None),
        "range": ("POST", "/v1/generate_range", {"pair_indexes": [0, 1]}, None),
        "range-chunked": ("POST", "/v1/generate_range", {"pair_indexes": [3, 1, 2], "chunk_size": 1}, None),
        "range-aggregate": ("POST", "/v1/generate_range", {"pair_indexes": [0, 0, 2, 1, 2], "aggregate": True}, None),
        "range-aggregate-zlib": ("POST", "/v1/generate_range", {"pair_indexes": [1, 1], "aggregate": True, "witness_encoding": "zlib"}, None),
        "range-empty": ("POST", "/v1/generate_range", {"pair_indexes": []}, None),
        "range-bool-index": ("POST", "/v1/generate_range", {"pair_indexes": [True]}, None),
        "range-bad-chunk": ("POST", "/v1/generate_range", {"pair_indexes": [0], "chunk_size": 0}, None),
        "range-aggregate-not-bool": ("POST", "/v1/generate_range", {"pair_indexes": [0], "aggregate": 1}, None),
        "range-unknown-encoding": ("POST", "/v1/generate_range", {"pair_indexes": [0], "witness_encoding": "lz4"}, None),
        "deadline-tight": ("POST", "/v1/generate", {"pair_index": 0, "deadline_ms": 1}, None),
        "deadline-header-tight": ("POST", "/v1/generate", {"pair_index": 0}, {"X-IPC-Deadline-Ms": "1"}),
        "deadline-not-a-number": ("POST", "/v1/generate", {"pair_index": 0, "deadline_ms": "soon"}, None),
        "deadline-ample": ("POST", "/v1/generate", {"pair_index": 2, "deadline_ms": 60_000}, None),
        "body-not-object": ("POST", "/v1/verify", [1, 2], None),
        "post-unknown": ("POST", "/v1/nope", {}, None),
        "subscribe-unmounted": ("POST", "/v1/subscribe", {"filter": {}}, None),
        "unsubscribe-unmounted": ("POST", "/v1/unsubscribe", {"sub": "x"}, None),
        "backfill-submit-unmounted": ("POST", "/v1/backfill", {"pair_start": 0, "pair_end": 1}, None),
        "post-subscriptions": ("POST", "/v1/subscriptions", {}, None),
        "post-backfill-job": ("POST", "/v1/backfill/abc", {}, None),
        "replica-peers-bad": ("POST", "/v1/replica_peers", {"peers": [{"name": 1}]}, None),
        "replica-peers-no-disk": ("POST", "/v1/replica_peers", {"peers": [{"name": "a", "url": "http://x"}]}, None),
        "replicate-bad": ("POST", "/v1/replicate", {"sources": "a"}, None),
        "replicate-bad-owners": ("POST", "/v1/replicate", {"sources": [], "owners": [1]}, None),
        "replicate-no-disk": ("POST", "/v1/replicate", {"sources": []}, None),
        "segment-put-no-disk": ("POST", "/v1/segments/seg-a.00000001.blk", b"\x00" * 8, None),
        "get-unknown": ("GET", "/nope", None, None),
        "get-subscriptions": ("GET", "/v1/subscriptions", None, None),
        "get-deliveries": ("GET", "/v1/deliveries?sub=x", None, None),
        "get-backfill": ("GET", "/v1/backfill", None, None),
        "get-backfill-job": ("GET", "/v1/backfill/abc/chunks", None, None),
        "get-backfill-status": ("GET", "/v1/backfill/abc", None, None),
        "get-subscribe": ("GET", "/v1/subscribe", None, None),
        "get-segments-no-disk": ("GET", "/v1/segments", None, None),
        "get-segment-no-disk": ("GET", "/v1/segments/seg-a.00000001.blk", None, None),
        "get-block-unparsable": ("GET", "/v1/blocks/not-a-cid", None, None),
        "get-block-missing": ("GET", f"/v1/blocks/{served.blocks[0].cid}x", None, None),
        "get-registry-disabled": ("GET", "/v1/registry/head", None, None),
    }


def _grid_ids():
    # the keys of `_request_bodies`, listed without building a world
    # (test_grid_ids_cover_every_case keeps the two in step)
    return [
        "verify", "verify-unwrapped", "verify-tampered", "verify-blocks-frame", "verify-claims",
        "verify-malformed", "verify-bad-claims", "generate-0", "generate-3", "generate-zlib",
        "generate-accept-zlib", "generate-unknown-encoding", "generate-accept-unknown",
        "generate-bad-stream-field", "generate-index-5", "generate-index-negative",
        "generate-index-string", "generate-unknown-base", "generate-tenant", "range", "range-chunked",
        "range-aggregate", "range-aggregate-zlib", "range-empty", "range-bool-index", "range-bad-chunk",
        "range-aggregate-not-bool", "range-unknown-encoding", "deadline-tight", "deadline-header-tight",
        "deadline-not-a-number", "deadline-ample", "body-not-object", "post-unknown",
        "subscribe-unmounted", "unsubscribe-unmounted", "backfill-submit-unmounted",
        "post-subscriptions", "post-backfill-job",
        "replica-peers-bad", "replica-peers-no-disk", "replicate-bad", "replicate-bad-owners",
        "replicate-no-disk", "segment-put-no-disk", "get-unknown", "get-subscriptions",
        "get-deliveries", "get-backfill", "get-backfill-job", "get-backfill-status",
        "get-subscribe", "get-segments-no-disk",
        "get-segment-no-disk", "get-block-unparsable", "get-block-missing", "get-registry-disabled",
    ]


def _send(port, method, path, body, headers):
    if method == "POST" and body is not None and not isinstance(body, (dict, bytes)):
        return request(port, method, path, json.dumps(body).encode(), dict(headers or {}, **{"Content-Type": "application/json"}))
    return request(port, method, path, body, headers)


def _decoded(raw):
    try:
        return json.loads(raw)
    except ValueError:
        return raw


def test_grid_ids_cover_every_case(served, both_worlds):
    (_, pairs, _), _ = both_worlds
    assert sorted(_grid_ids()) == sorted(_request_bodies(served, pairs))


@pytest.mark.parametrize("case", _grid_ids())
def test_route_equals_reference(daemons, served, both_worlds, case):
    (_, pairs, _), _ = both_worlds
    method, path, body, headers = _request_bodies(served, pairs)[case]
    port, ref = (_send(h.port, method, path, body, headers) for h in daemons)
    (ps, ph, pb), (rs, rh, rb) = port, ref
    assert ps == rs, (case, ps, rs, pb[:300], rb[:300])
    assert ps in (200, 400, 404, 503, 504), ps
    assert strip(_decoded(pb)) == strip(_decoded(rb)), case
    for header in ("Witness-Encoding", "Retry-After", "Content-Type"):
        assert ph.get(header) == rh.get(header), header
    assert timing_shape(ph.get("Server-Timing")) == timing_shape(rh.get("Server-Timing"))


@pytest.mark.parametrize("engine", ["subs", "slo", "backfill"])
def test_unported_engines_are_refused(engine):
    """The standing-query, SLO and backfill engines mount on the server as
    in the reference: built with one, its routes answer from the engine
    (not the 404 of a server without it) and shutdown stops it."""
    from types import SimpleNamespace

    calls = []
    engines = {
        "subs": SimpleNamespace(subscriptions=lambda: {"count": 0, "subscriptions": []},
                                health_fields=lambda: {"subscriptions": 0}, drain=lambda: calls.append("subs")),
        "slo": SimpleNamespace(status=lambda: {"status": "ok", "targets": {}, "anomalies": []},
                               stop=lambda: calls.append("slo")),
        "backfill": SimpleNamespace(jobs=lambda: [], close=lambda timeout=None: calls.append("backfill")),
    }
    path = {"subs": "/v1/subscriptions", "slo": "/healthz", "backfill": "/v1/backfill"}[engine]
    service = ProofService(config=ServiceConfig(device="cpu"))
    httpd = ProofHTTPServer(service, **{engine: engines[engine]}).start()
    try:
        status, _, body = get(httpd.port, path)
    finally:
        httpd.shutdown(timeout=30)
    assert status == 200, body
    assert calls == [engine]
    if engine == "slo":
        assert body["slo"]["status"] == "ok"


def test_verify_verdicts_and_claims(daemons, served, both_worlds):
    """The claims table's per-claim verdicts come out of one shared
    replay; a tampered proof poisons only its own claim."""
    (_, pairs, _), _ = both_worlds
    agg = aggregate_range_bundle(served, pairs, list(range(len(pairs))), claim_indexes=[0, 1, 2, 3, 3])
    status, _, out = post(daemons[0].port, "/v1/verify", {"bundle": agg.bundle.to_json_obj(), "claims": agg.claims_json()})
    assert status == 200 and out["all_valid"] is True
    assert [c["all_valid"] for c in out["claim_results"]] == [True] * 5
    status, _, single = post(daemons[0].port, "/v1/verify", {"bundle": _single(served).to_json_obj()})
    assert (status, single["event_results"], single["batch_size"]) == (200, [True], 1)


@pytest.mark.parametrize("encoding", ["identity", "zlib"])
@pytest.mark.parametrize("route", ["generate", "range", "range-aggregate"])
def test_stream_equals_buffered_and_reference(daemons, route, encoding):
    """{stream, buffered} × encodings: every streamed document reassembles
    to its buffered twin, and to the reference daemon's stream."""
    path, body = {
        "generate": ("/v1/generate", {"pair_index": 1}),
        "range": ("/v1/generate_range", {"pair_indexes": [2, 0]}),
        "range-aggregate": ("/v1/generate_range", {"pair_indexes": [0, 0, 3], "aggregate": True}),
    }[route]
    body = dict(body, witness_encoding=encoding)
    port, ref = daemons
    _, _, buffered = post(port.port, path, body)
    status, hdrs, raw = request(port.port, "POST", path, dict(body, stream=True))
    assert status == 200 and hdrs["Content-Type"] == STREAM_CONTENT_TYPE
    assert hdrs["Transfer-Encoding"] == "chunked" and hdrs["Witness-Encoding"] == encoding
    doc = decode_bundle_stream(raw)
    rstatus, rhdrs, rraw = request(ref.port, "POST", path, dict(body, stream=True))
    assert rstatus == 200 and rhdrs["Witness-Encoding"] == encoding
    assert strip(doc) == strip(ref_decode_stream(rraw))
    assert ref_decode_stream(raw)["bundle"] == doc["bundle"]  # the reference decodes the port's bytes
    assert doc["bundle"] == buffered.get("bundle", doc["bundle"])
    assert doc["digest"] == buffered["digest"]


def test_delta_roundtrip_and_missing_base_fallback(daemons):
    """A base the daemon served earlier yields the reference's delta; one
    it never saw degrades to a full bundle."""
    outs = []
    for httpd in daemons:
        _, _, first = post(httpd.port, "/v1/generate_range", {"pair_indexes": [0, 1]})
        status, hdrs, delta = post(
            httpd.port, "/v1/generate_range", {"pair_indexes": [0, 1, 2]}, headers={"If-Witness-Base": first["digest"]}
        )
        assert status == 200 and hdrs["Witness-Encoding"] == "identity"
        assert delta["witness_base"] == first["digest"] and "bundle_delta" in delta
        status, _, stream_raw = request(
            httpd.port, "POST", "/v1/generate_range", {"pair_indexes": [0, 1, 2], "base_digest": first["digest"], "stream": True}
        )
        assert status == 200
        _, _, fallback = post(httpd.port, "/v1/generate_range", {"pair_indexes": [0, 1], "base_digest": "0" * 64})
        assert "bundle" in fallback
        outs.append((strip(first), strip(delta), strip(fallback), len(stream_raw) > 0))
    assert outs[0] == outs[1]


def test_metrics_healthz_prom_and_flight(daemons, served):
    port, ref = daemons
    for httpd in daemons:
        assert post(httpd.port, "/v1/verify", {"bundle": _single(served).to_json_obj()})[0] == 200
    snaps = [get(h.port, "/metrics")[2] for h in daemons]
    for snap in snaps:
        assert "serve.queue_depth.verify" in snap["gauges"]
        assert "serve.latency_ms.verify" in snap["histograms"]
        assert "block_cache" in snap
    assert get(port.port, "/metrics.json")[2].keys() == snaps[0].keys()
    assert snaps[0].keys() == snaps[1].keys()
    assert [get(h.port, "/healthz")[:1] + (get(h.port, "/healthz")[2]["status"],) for h in daemons] == [(200, "ok")] * 2
    proms = [request(h.port, "GET", "/metrics.prom") for h in daemons]
    assert proms[0][0] == proms[1][0] == 200
    assert proms[0][1]["Content-Type"] == proms[1][1]["Content-Type"]
    families = [
        {line.split()[2] for line in raw.decode().splitlines() if line.startswith("# TYPE ipc_serve")}
        for _, _, raw in proms
    ]
    assert families[1] <= families[0] and families[0]
    flights = [get(h.port, "/debug/flight") for h in daemons]
    assert flights[0][0] == flights[1][0] == 200
    assert flights[0][2].keys() == flights[1][2].keys()


def test_draining_healthz_and_503(served):
    servers = [port_server((None, [], 0), pairs=False), ref_server((None, [], 0), pairs=False)]
    try:
        out = []
        for httpd in servers:
            httpd.service.drain()
            status, _, health = get(httpd.port, "/healthz")
            vstatus, _, body = post(httpd.port, "/v1/verify", {"bundle": _single(served).to_json_obj()})
            out.append((status, health["status"], vstatus, body))
        assert out[0] == out[1] == (503, "draining", 503, {"error": "service draining"})
    finally:
        shutdown(*servers)


def test_streamed_timing_gains_stream_ms(daemons):
    t0 = time.monotonic()
    status, _, raw = request(daemons[0].port, "POST", "/v1/generate", {"pair_index": 0, "stream": True})
    wall_ms = (time.monotonic() - t0) * 1000.0
    assert status == 200
    timing = decode_bundle_stream(raw)["server_timing"]
    assert set(timing) >= {"queue_ms", "batch_wait_ms", "generate_ms", "stream_ms"}
    assert all(v >= 0 for v in timing.values())
    assert sum(timing.values()) <= wall_ms


# --------------------------------------------------------------------------
# disk-warm streams: zero copy, and copies once the segments are gone
# --------------------------------------------------------------------------


def test_warm_stream_is_zero_copy_and_evicted_store_copies(both_worlds, tmp_path):
    port_world, ref_world = both_worlds
    servers = (
        port_server(port_world, store_dir=str(tmp_path / "p"), max_wait_ms=2.0),
        ref_server(ref_world, store_dir=str(tmp_path / "r"), max_wait_ms=2.0),
    )
    try:
        docs = []
        for httpd in servers:
            svc = httpd.service
            assert post(httpd.port, "/v1/generate", {"pair_index": 1})[0] == 200
            c0 = svc.metrics_snapshot()["counters"]
            status, _, raw = request(httpd.port, "POST", "/v1/generate", {"pair_index": 1, "stream": True})
            assert status == 200
            c1 = svc.metrics_snapshot()["counters"]
            zc = c1.get("serve.stream.zero_copy_bytes", 0) - c0.get("serve.stream.zero_copy_bytes", 0)
            copied = c1.get("serve.stream.copied_bytes", 0) - c0.get("serve.stream.copied_bytes", 0)
            assert zc > 0 and copied == 0
            assert c1.get("storex.slice_hits", 0) > c0.get("storex.slice_hits", 0)
            docs.append(strip(ref_decode_stream(raw)))
        assert docs[0] == docs[1]
        # every segment unlinked under the port's warm daemon: copies, same bytes
        port = servers[0]
        seg_root = tmp_path / "p"
        for name in list(seg_root.iterdir()):
            if name.name.startswith("seg-"):
                name.unlink()
        c0 = port.service.metrics_snapshot()["counters"]
        status, _, raw = request(port.port, "POST", "/v1/generate", {"pair_index": 1, "stream": True})
        assert status == 200 and strip(decode_bundle_stream(raw)) == docs[0]
        c1 = port.service.metrics_snapshot()["counters"]
        assert c1.get("serve.stream.copied_bytes", 0) > c0.get("serve.stream.copied_bytes", 0)
        assert c1.get("serve.stream.zero_copy_bytes", 0) == c0.get("serve.stream.zero_copy_bytes", 0)
    finally:
        shutdown(*servers)


# --------------------------------------------------------------------------
# the registry over HTTP
# --------------------------------------------------------------------------


def test_registry_logs_and_routes_equal_reference(both_worlds, served, tmp_path, monkeypatch):
    """Under fixed clocks and trace ids the same request sequence seals
    byte-equal IPR1 logs, and every `/v1/registry/*` answer is equal."""
    fixed_clocks(monkeypatch, port_registry_mod, ref_registry_mod)
    port_world, ref_world = both_worlds
    servers = (
        port_server(port_world, registry_dir=str(tmp_path / "p"), max_wait_ms=1.0, workers=1),
        ref_server(ref_world, registry_dir=str(tmp_path / "r"), max_wait_ms=1.0, workers=1),
    )
    try:
        sequence = [
            ("/v1/generate", {"pair_index": 0}),
            ("/v1/generate", {"pair_index": 2, "stream": True}),
            ("/v1/verify", {"bundle": _single(served).to_json_obj()}),
            ("/v1/generate_range", {"pair_indexes": [1, 3]}),
            ("/v1/generate_range", {"pair_indexes": [0, 0, 1], "aggregate": True, "witness_encoding": "zlib"}),
            ("/v1/generate", {"pair_index": 1, "tenant": "acme"}),
        ]
        digests = []
        for path, body in sequence:
            answers = [request(h.port, "POST", path, body)[0] for h in servers]
            assert answers == [200, 200], (path, answers)
        _, _, first = post(servers[0].port, "/v1/generate_range", {"pair_indexes": [1, 3]})
        assert post(servers[1].port, "/v1/generate_range", {"pair_indexes": [1, 3]})[2]["digest"] == first["digest"]
        digests.append(first["digest"])
        routes = [
            "/v1/registry/head", "/v1/registry/entry?seq=0", "/v1/registry/entry?seq=4",
            "/v1/registry/entry?seq=99", "/v1/registry/entry?seq=x", "/v1/registry/proof?seq=2",
            f"/v1/registry/proof?digest={digests[0]}", "/v1/registry/proof?digest=00",
            "/v1/registry/consistency?old_size=3", "/v1/registry/consistency?old_size=999",
            "/v1/registry/consistency", f"/v1/registry/base?key=pair:0", "/v1/registry/base",
            "/v1/registry/nope",
        ]
        for route in routes:
            (ps, _, pb), (rs, _, rb) = (get(h.port, route) for h in servers)
            assert (ps, pb) == (rs, rb), route
        assert get(servers[0].port, "/v1/registry/head")[2]["size"] == 7
        logs = [
            sorted(p.read_bytes() for p in (tmp_path / d).iterdir() if p.name.startswith("reg-"))
            for d in ("p", "r")
        ]
        assert logs[0] == logs[1] and logs[0]
    finally:
        shutdown(*servers)


# --------------------------------------------------------------------------
# tenant QoS at the door
# --------------------------------------------------------------------------


def test_429_with_retry_after_and_counters(both_worlds):
    port_world, ref_world = both_worlds
    cfg = dict(max_batch=8, max_wait_ms=2.0, workers=2, tenant_rate=0.001, tenant_burst=2.0)
    servers = port_server(port_world, **cfg), ref_server(ref_world, **cfg)
    try:
        seen = []
        for httpd in servers:
            answers = [post(httpd.port, "/v1/generate", {"pair_index": 0, "tenant": "acme"}) for _ in range(3)]
            assert [a[0] for a in answers] == [200, 200, 429]
            _, hdrs, out = answers[2]
            assert out["error_type"] == "tenant_throttled" and out["retry_after_s"] > 0
            assert int(hdrs["Retry-After"]) >= 1
            c = httpd.service.metrics_snapshot()["counters"]
            assert c["qos.throttled"] >= 1 and c["tenant.throttled.acme"] >= 1
            assert post(httpd.port, "/v1/generate", {"pair_index": 0, "tenant": "globex"})[0] == 200
            seen.append((hdrs["Retry-After"], strip(dict(out, retry_after_s=None))))
        assert seen[0] == seen[1]
    finally:
        shutdown(*servers)


def test_response_bytes_charge_tenant_at_send_time(both_worlds):
    port_world, _ = both_worlds
    httpd = port_server(port_world, tenant_rate=100.0, tenant_burst=100.0)
    try:
        svc = httpd.service
        c0 = svc.metrics_snapshot()["counters"].get("tenant.bytes.ledgerco", 0)
        status, _, raw = request(httpd.port, "POST", "/v1/generate", {"pair_index": 0, "tenant": "ledgerco", "stream": True})
        assert status == 200
        deadline = time.monotonic() + 5.0
        c1 = c0
        while time.monotonic() < deadline:
            c1 = svc.metrics_snapshot()["counters"].get("tenant.bytes.ledgerco", 0)
            if c1 - c0 > len(raw) // 2:
                break
            time.sleep(0.01)
        assert c1 - c0 > len(raw) // 2
    finally:
        httpd.shutdown(timeout=30)


def test_http_door_retry_after_admits_when_honored(both_worlds):
    port_world, _ = both_worlds
    httpd = port_server(port_world, max_wait_ms=2.0, tenant_rate=5.0, tenant_burst=1.0)
    try:
        assert post(httpd.port, "/v1/generate", {"pair_index": 0, "tenant": "honest"})[0] == 200
        status, hdrs, out = post(httpd.port, "/v1/generate", {"pair_index": 0, "tenant": "honest"})
        assert status == 429 and out["error_type"] == "tenant_throttled"
        assert 0.0 < out["retry_after_s"] <= 1.0 / 5.0 + 0.05
        assert int(hdrs["Retry-After"]) >= 1
        time.sleep(out["retry_after_s"] + 0.02)
        assert post(httpd.port, "/v1/generate", {"pair_index": 0, "tenant": "honest"})[0] == 200
    finally:
        httpd.shutdown(timeout=30)


def test_admit_gradient_sheds_typed(both_worlds):
    """With ``admit_gradient`` a request past the AIMD limit is a typed 429
    with an honest Retry-After in both packages."""
    port_world, ref_world = both_worlds
    cfg = dict(max_wait_ms=50.0, workers=1, admit_gradient=True, admit_initial=1, admit_min=1, admit_max=1)
    servers = port_server(port_world, **cfg), ref_server(ref_world, **cfg)
    try:
        for httpd in servers:
            slot = httpd.admit.acquire("hog")  # the one slot, held
            try:
                status, hdrs, out = post(httpd.port, "/v1/generate", {"pair_index": 0})
            finally:
                httpd.admit.release(slot, queue_delay_ms=0.0)
            assert status == 429 and out["error_type"] == "admit_rejected"
            assert out["retry_after_s"] > 0 and int(hdrs["Retry-After"]) >= 1
            assert post(httpd.port, "/v1/generate", {"pair_index": 0})[0] == 200
    finally:
        shutdown(*servers)


# --------------------------------------------------------------------------
# deadlines, disconnects, degraded upstream
# --------------------------------------------------------------------------


def _classify(status, hdrs, raw, reference):
    if STREAM_CONTENT_TYPE in hdrs.get("Content-Type", ""):
        try:
            doc = decode_bundle_stream(raw)
        except StreamAbortError as exc:
            return "typed" if exc.remote_error_type in ("deadline", "cancelled") else exc.remote_error_type
        return "identical" if strip(doc)["bundle"] == reference else "divergent"
    body = json.loads(raw)
    if status == 200:
        return "identical" if body["bundle"] == reference else "divergent"
    if status == 504 and body.get("error_type") in ("deadline", "cancelled"):
        return "typed"
    return f"untyped {status}"


@pytest.mark.parametrize("door", ["buffered", "stream"])
@pytest.mark.parametrize(
    "deadline_ms,expect",
    [(60_000.0, {"identical"}), (1.0, {"typed"}), (25.0, {"identical", "typed"})],
    ids=["ample", "tight", "mid-expiry"],
)
def test_deadline_grid_identical_or_typed(daemons, door, deadline_ms, expect):
    port, ref = daemons
    for i in range(2):
        _, _, reference = post(ref.port, "/v1/generate", {"pair_index": i})
        body = {"pair_index": i, "deadline_ms": deadline_ms}
        if door == "stream":
            body["stream"] = True
        status, hdrs, raw = request(port.port, "POST", "/v1/generate", body)
        verdict = _classify(status, hdrs, raw, reference["bundle"])
        assert verdict in expect, (door, deadline_ms, i, verdict)


def test_disconnect_while_queued_reclaims_the_slot(both_worlds):
    port_world, _ = both_worlds
    httpd = port_server(port_world, max_batch=8, max_wait_ms=400.0, workers=1)
    try:
        body = json.dumps({"pair_index": 0}).encode()
        sock = socket.create_connection(("127.0.0.1", httpd.port), timeout=10)
        sock.sendall(
            b"POST /v1/generate HTTP/1.1\r\nHost: localhost\r\nContent-Type: application/json\r\n"
            b"Content-Length: %d\r\n\r\n%s" % (len(body), body)
        )
        time.sleep(0.05)
        sock.close()
        deadline = time.monotonic() + 10
        c = {}
        while time.monotonic() < deadline:
            c = httpd.service.metrics_snapshot()["counters"]
            if c.get("serve.cancelled_inflight", 0) >= 1:
                break
            time.sleep(0.02)
        assert c.get("serve.cancelled_inflight", 0) >= 1
        assert c.get("deadline.reclaimed_ms", 0) >= 1
    finally:
        httpd.shutdown(timeout=30)


class _FlippableSession:
    def __init__(self, store, dead=True):
        self._inner = LocalLotusSession(store)
        self.dead = dead
        self.calls = 0

    def post(self, url, data=None, headers=None, timeout=None):
        self.calls += 1
        if self.dead:
            raise ConnectionError("endpoint down")
        return self._inner.post(url, data=data, headers=headers, timeout=timeout)


def test_degraded_serve_warm_identical_cold_typed_then_recovery(both_worlds):
    (full_store, pairs, _), _ = both_worlds
    recording = RecordingBlockstore(full_store)
    probe = ProofService(store=recording, spec=SPEC, config=ServiceConfig(device="cpu"))
    try:
        reference = probe.submit_generate(pairs[0]).result(timeout=60)
    finally:
        probe.drain()
    warm = {cid: full_store.get(cid) for cid in recording.take_seen()}
    sessions = [_FlippableSession(full_store), _FlippableSession(full_store)]
    metrics = Metrics()
    pool = EndpointPool(
        [LotusClient("http://ep", session=s, max_retries=1) for s in sessions],
        breaker_threshold=1, breaker_reset_s=0.05, metrics=metrics, backend=CPU,
    )
    service = ProofService(
        store=CachedBlockstore(RpcBlockstore(pool, metrics=metrics), shared_cache=dict(warm)),
        spec=SPEC, metrics=metrics, endpoint_pool=pool,
        config=ServiceConfig(max_batch=2, max_wait_ms=1.0, workers=1, device="cpu"),
    )
    httpd = ProofHTTPServer(service, pairs=pairs).start()
    try:
        with pytest.raises((DegradedError, RuntimeError)):
            pool.chain_read_obj(next(iter(warm)))
        assert pool.lotus_down
        _, _, health = get(httpd.port, "/healthz")
        assert health["status"] == "degraded" and health.get("mode") == "lotus_down"
        calls0 = sum(s.calls for s in sessions)
        status, _, got = post(httpd.port, "/v1/generate", {"pair_index": 0})
        assert status == 200
        assert got["bundle"] == reference.bundle.to_json_obj()
        assert sum(s.calls for s in sessions) == calls0
        assert service.metrics_snapshot()["counters"].get("degraded.warm_served", 0) >= 1
        status, _, cold = post(httpd.port, "/v1/generate", {"pair_index": 1})
        assert status == 503 and cold["error_type"] == "degraded"
        for s in sessions:
            s.dead = False
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            status, _, _ = post(httpd.port, "/v1/generate", {"pair_index": 1})
            if status == 200:
                break
            time.sleep(0.05)
        assert status == 200 and not pool.lotus_down
        c = service.metrics_snapshot()["counters"]
        assert c.get("degraded.entered", 0) >= 1 and c.get("degraded.exited", 0) >= 1
    finally:
        httpd.shutdown(timeout=30)
        pool.close()


# --------------------------------------------------------------------------
# device faults: 500, never 400; in-band abort in a started stream
# --------------------------------------------------------------------------

FAULTS = {
    "verify-lane": lambda: VerifyLaneError("lane fault"),
    "launch": lambda: DeviceFaultError("blake2b256_two_block: CUDA launch failed with error 700"),
    "cuda-runtime": lambda: RuntimeError("CUDA error: an illegal memory access was encountered"),
    "oom": lambda: torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"),
}


def _break_backend(monkeypatch, make):
    def broken(messages):
        raise make()

    monkeypatch.setattr(CPU, "blake2b256_batch", broken)


@pytest.mark.parametrize("cids", [False, True], ids=["cids-off", "cids-on"])
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_verify_device_fault_is_500_not_400(both_worlds, served, monkeypatch, fault, cids):
    port_world, _ = both_worlds
    httpd = port_server(port_world, verify_witness_cids=cids, max_wait_ms=1.0)
    try:
        with monkeypatch.context() as m:
            _break_backend(m, FAULTS[fault])
            status, _, body = post(httpd.port, "/v1/verify", {"bundle": _single(served).to_json_obj()})
        assert status == 500 and body["error_type"] == "device", body
        # the card back: the same request verifies
        status, _, body = post(httpd.port, "/v1/verify", {"bundle": _single(served).to_json_obj()})
        assert status == 200 and body["all_valid"] is True
    finally:
        httpd.shutdown(timeout=30)


def test_other_runtime_error_stays_400_as_in_the_reference(both_worlds, served, monkeypatch):
    port_world, _ = both_worlds
    httpd = port_server(port_world, max_wait_ms=1.0)
    try:
        with monkeypatch.context() as m:
            _break_backend(m, lambda: RuntimeError("no device involved"))
            status, _, body = post(httpd.port, "/v1/verify", {"bundle": _single(served).to_json_obj()})
        assert (status, body) == (400, {"error": "no device involved"})
    finally:
        httpd.shutdown(timeout=30)


@pytest.mark.parametrize("fault", ["verify-lane", "cuda-runtime"])
def test_started_stream_ends_in_a_device_abort_chunk(both_worlds, monkeypatch, fault):
    port_world, _ = both_worlds
    httpd = port_server(port_world, max_wait_ms=1.0)
    try:
        def broken_slice(cid):
            raise FAULTS[fault]()

        monkeypatch.setattr(httpd.service, "read_block_slice", broken_slice)
        status, hdrs, raw = request(httpd.port, "POST", "/v1/generate", {"pair_index": 1, "stream": True})
        assert status == 200 and hdrs["Content-Type"] == STREAM_CONTENT_TYPE
        with pytest.raises(StreamAbortError) as info:
            decode_bundle_stream(raw)
        assert info.value.remote_error_type == "device"
    finally:
        httpd.shutdown(timeout=30)
