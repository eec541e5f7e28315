"""A streamed response is counted before the client can see its end.

The daemon's ``_stream_ok`` and the router's ``_finish_stream`` count
``serve.stream.responses`` (and the tenant's bytes) before the chunked
terminator goes out. Here the server thread is held for a while after the
terminator is sent, so a count taken after it would still be missing when
the client, having read the whole body, reads the counters: the test fails
on that order without depending on load.
"""

import time

import pytest

import ipc_proofs_tpu_torch.cluster.router as port_router
from _torch_http import port_server, request, worlds, with_end_hook
from ipc_proofs_tpu_torch.cluster import ClusterRouter, LocalShard, RouterHTTPServer
from ipc_proofs_tpu_torch.proofs.generator import EventProofSpec
from ipc_proofs_tpu_torch.serve import ServiceConfig
from ipc_proofs_tpu_torch.serve import httpd as port_httpd
from ipc_proofs_tpu_torch.utils.metrics import Metrics
from ipc_proofs_tpu_torch.witness.stream import decode_bundle_stream

HOLD_S = 0.5  # the server thread's pause after the terminator


def _send_then_hold(sock, data):
    sock.sendall(data)
    time.sleep(HOLD_S)


@pytest.fixture(scope="module")
def world():
    return worlds()[0]


def test_daemon_counts_a_stream_before_its_terminator(world, monkeypatch):
    handler = port_httpd._Handler
    monkeypatch.setattr(handler, "_stream_ok", with_end_hook(handler._stream_ok, _send_then_hold))
    httpd = port_server(world, max_wait_ms=1.0, tenant_rate=100.0, tenant_burst=100.0)
    try:
        status, _, raw = request(httpd.port, "POST", "/v1/generate", {"pair_index": 0, "stream": True, "tenant": "acme"})
        counters = httpd.service.metrics_snapshot()["counters"]
        assert status == 200 and decode_bundle_stream(raw)
        assert counters.get("serve.stream.responses", 0) == 1
        assert counters.get("tenant.bytes.acme", 0) > len(raw) // 2
    finally:
        httpd.shutdown(timeout=30)


def test_router_counts_a_stream_before_its_terminator(world, monkeypatch):
    handler = port_router._RouterHandler
    monkeypatch.setattr(handler, "_finish_stream", with_end_hook(handler._finish_stream, _send_then_hold))
    store, table, _ = world
    spec = EventProofSpec(event_signature="NewTopDownMessage(bytes32,uint256)", topic_1="calib-subnet-1")
    shard = LocalShard("s0", store, table, spec, config=ServiceConfig(device="cpu", max_wait_ms=1.0)).start()
    metrics = Metrics()
    router = ClusterRouter({shard.name: shard.url}, table, metrics=metrics, scrape_interval_s=60.0)
    server = RouterHTTPServer(router).start()
    try:
        status, _, raw = request(server.port, "POST", "/v1/generate_range", {"pair_indexes": [0, 1], "stream": True})
        responses = metrics.snapshot()["counters"].get("serve.stream.responses", 0)
        assert status == 200 and decode_bundle_stream(raw)
        assert responses == 1
    finally:
        server.shutdown(timeout=30)
        shard.stop(timeout=10)
