"""Shared plumbing of the HTTP-plane differential tests (not a test module).

Both packages' `ProofHTTPServer`s over one seeded range world: the JAX
package on its host paths, the port on ``device="cpu"`` (the kernels' plain
versions). Requests go to both over loopback (port 0); responses are
compared after `strip` drops what is per process (trace ids, timings,
span subtrees).
"""

import http.client
import itertools
import json
import time
import types

from ipc_proofs_tpu.fixtures import build_range_world as ref_build_range_world
from ipc_proofs_tpu.proofs.generator import EventProofSpec as RefSpec
from ipc_proofs_tpu.serve.httpd import ProofHTTPServer as RefHTTPServer
from ipc_proofs_tpu.serve.service import ProofService as RefProofService
from ipc_proofs_tpu.serve.service import ServiceConfig as RefServiceConfig
from ipc_proofs_tpu_torch.fixtures import build_range_world
from ipc_proofs_tpu_torch.proofs.generator import EventProofSpec
from ipc_proofs_tpu_torch.serve import ProofHTTPServer, ProofService, ServiceConfig

SIG = "NewTopDownMessage(bytes32,uint256)"
SUBNET = "calib-subnet-1"
T0 = 1_700_000_000.0
# per-process fields of a response body
VOLATILE = ("trace_id", "server_timing", "spans", "spans_pid", "journal_ms")


def worlds(n_pairs=4, receipts=4, events=2, match_rate=0.5, base_height=1000):
    """(port world, reference world): equal pair tables and blocks."""
    kw = dict(
        receipts_per_pair=receipts, events_per_receipt=events, match_rate=match_rate,
        signature=SIG, topic1=SUBNET, base_height=base_height,
    )
    return build_range_world(n_pairs, **kw), ref_build_range_world(n_pairs, **kw)


def port_server(world, pairs=True, durable=None, start=True, **cfg):
    """A port daemon (plain versions on the CPU) over ``world``."""
    store, table, _ = world
    svc = ProofService(
        store=store, spec=EventProofSpec(event_signature=SIG, topic_1=SUBNET),
        config=ServiceConfig(device="cpu", **cfg),
    )
    httpd = ProofHTTPServer(svc, pairs=table if pairs else None, durable=durable(svc, table) if durable else None)
    return httpd.start() if start else httpd


def ref_server(world, pairs=True, durable=None, start=True, **cfg):
    """The reference daemon (host paths) over ``world``."""
    store, table, _ = world
    svc = RefProofService(
        store=store, spec=RefSpec(event_signature=SIG, topic_1=SUBNET),
        config=RefServiceConfig(**cfg),
    )
    httpd = RefHTTPServer(svc, pairs=table if pairs else None, durable=durable(svc, table) if durable else None)
    return httpd.start() if start else httpd


def request(port, method, path, body=None, headers=None, timeout=60):
    """(status, headers dict, raw body bytes). ``body``: a dict (sent as
    JSON), bytes (sent raw) or None."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    hdrs = dict(headers or {})
    if isinstance(body, dict):
        body = json.dumps(body).encode()
        hdrs.setdefault("Content-Type", "application/json")
    try:
        conn.request(method, path, body, hdrs)
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def post(port, path, obj, headers=None):
    status, hdrs, raw = request(port, "POST", path, obj, headers)
    return status, hdrs, _json(raw)


def get(port, path, headers=None):
    status, hdrs, raw = request(port, "GET", path, None, headers)
    return status, hdrs, _json(raw)


def _json(raw):
    try:
        return json.loads(raw)
    except ValueError:
        return raw


def strip(obj):
    """``obj`` without the per-process fields, recursively."""
    if isinstance(obj, dict):
        return {k: strip(v) for k, v in obj.items() if k not in VOLATILE}
    if isinstance(obj, list):
        return [strip(v) for v in obj]
    return obj


def timing_shape(header):
    """The metric names of a Server-Timing header, in order."""
    return [part.split(";")[0].strip() for part in header.split(",")] if header else []


def fixed_clocks(monkeypatch, *modules):
    """Deterministic trace ids (a counter per trace module) and a fixed
    wall clock in each registry module, so two packages' registry logs are
    byte-comparable for the same request sequence."""
    import ipc_proofs_tpu.obs.trace as ref_trace
    import ipc_proofs_tpu_torch.obs.trace as port_trace

    for mod in (ref_trace, port_trace):
        ids = itertools.count(1)
        monkeypatch.setattr(mod, "_new_trace_id", lambda ids=ids: f"{next(ids):016x}")
    clock = types.SimpleNamespace(**{k: getattr(time, k) for k in dir(time) if not k.startswith("_")})
    clock.time = lambda: T0
    for mod in modules:
        monkeypatch.setattr(mod, "time", clock)


def shutdown(*servers):
    for httpd in servers:
        httpd.shutdown(timeout=30)
