"""The deadline grid through the port's cluster router, against the JAX
package's (the reference's ``tests/test_overload.py::TestDeadlineGridRouter``).

The law: a ``/v1/generate_range`` with a deadline, buffered or streamed,
answers either the single daemon's bytes or a typed ``deadline`` refusal
(a 504, or an in-band abort chunk), never a partial or untyped one. The
reference's grid draws its middle deadline from the host's speed; here every
case is placed by construction, so no outcome depends on timing:

- ``ample`` (60 s) answers the bytes; ``tight`` (1 ms) is refused at the
  router's door;
- ``router-dispatch``: a stepped clock (each read 10 ms later) lets a 20 ms
  budget pass the door and run out at the router's own dispatch;
- ``shard-door``: a stepped clock (5 ms a read) forwards 25–35 ms to shards
  whose floor is 50 ms, which refuse it typed.

Both packages run the grid (the reference's router over its own shards, the
port's over the port's on ``device="cpu"``) and their buffered answers and
decoded streams are compared. One case departs: a budget that runs out at
the router's dispatch after a streamed scatter began ends the port's stream
in a ``deadline`` abort chunk; the reference's says ``internal``.
"""

import itertools
import json
import threading
import types

import pytest

pytest.importorskip("jax")

import ipc_proofs_tpu.cluster.router as ref_router  # noqa: E402
import ipc_proofs_tpu_torch.cluster.router as port_router  # noqa: E402
from ipc_proofs_tpu.cluster import LocalShard as RefLocalShard  # noqa: E402
from ipc_proofs_tpu.fixtures import build_range_world as ref_build_range_world  # noqa: E402
from ipc_proofs_tpu.proofs.generator import EventProofSpec as RefSpec  # noqa: E402
from ipc_proofs_tpu.serve.service import ServiceConfig as RefServiceConfig  # noqa: E402
from ipc_proofs_tpu.witness.errors import StreamAbortError as RefStreamAbortError  # noqa: E402
from ipc_proofs_tpu.witness.stream import decode_bundle_stream as ref_decode  # noqa: E402
from ipc_proofs_tpu_torch.cluster import LocalShard  # noqa: E402
from ipc_proofs_tpu_torch.fixtures import build_range_world  # noqa: E402
from ipc_proofs_tpu_torch.proofs.generator import EventProofSpec  # noqa: E402
from ipc_proofs_tpu_torch.serve import ServiceConfig  # noqa: E402
from ipc_proofs_tpu_torch.utils.deadline import Deadline  # noqa: E402
from ipc_proofs_tpu_torch.witness.errors import StreamAbortError  # noqa: E402
from ipc_proofs_tpu_torch.witness.stream import STREAM_CONTENT_TYPE, decode_bundle_stream  # noqa: E402

from _torch_http import request  # noqa: E402

SIG = "NewTopDownMessage(bytes32,uint256)"
SUBNET = "calib-subnet-1"
ACTOR = 1001
WORLD_KW = dict(receipts_per_pair=6, events_per_receipt=3, match_rate=0.5, signature=SIG, topic1=SUBNET,
                actor_id=ACTOR, base_height=61_000)
# per-request envelope fields, not part of the proof payload
ENVELOPE = ("trace_id", "server_timing", "batch_size")
TYPED = {"deadline", "cancelled"}
BODY = {"pair_indexes": [0, 1, 2, 3], "chunk_size": 2}

PKGS = {
    "port": types.SimpleNamespace(
        router=port_router, LocalShard=LocalShard, Spec=EventProofSpec, decode=decode_bundle_stream,
        Abort=StreamAbortError, config=lambda **kw: ServiceConfig(device="cpu", **kw),
    ),
    "ref": types.SimpleNamespace(
        router=ref_router, LocalShard=RefLocalShard, Spec=RefSpec, decode=ref_decode,
        Abort=RefStreamAbortError, config=lambda **kw: RefServiceConfig(**kw),
    ),
}

# shape → (deadline_ms, stepped clock's ms per read or None, shard floor ms)
SHAPES = {
    "ample": (60_000.0, None, 5.0),
    "tight": (1.0, None, 5.0),
    "router-dispatch": (20.0, 10.0, 5.0),
    "shard-door": (40.0, 5.0, 50.0),
}
EXPECT = {"ample": "identical", "tight": "typed", "router-dispatch": "typed", "shard-door": "typed"}


@pytest.fixture(scope="module")
def worlds():
    return {"port": build_range_world(4, **WORLD_KW), "ref": ref_build_range_world(4, **WORLD_KW)}


def _canon(doc: dict) -> str:
    return json.dumps({k: v for k, v in doc.items() if k not in ENVELOPE}, sort_keys=True, separators=(",", ":"))


def _stepped(step_ms: float):
    """A clock that reads ``step_ms`` later on every read (the first reads
    0): how many reads a path makes, not how fast the host is, decides
    when a budget runs out."""
    ticks = itertools.count()
    lock = threading.Lock()

    def clock():
        with lock:
            return next(ticks) * step_ms / 1000.0

    return clock


class _Cluster:
    def __init__(self, pkg, world, floor_ms, monkeypatch=None, step_ms=None):
        ns = PKGS[pkg]
        store, pairs, _ = world
        spec = ns.Spec(event_signature=SIG, topic_1=SUBNET, actor_id_filter=ACTOR)
        self.shards = [
            ns.LocalShard(f"s{i}", store, pairs, spec, config=ns.config(deadline_floor_ms=floor_ms)).start()
            for i in range(2)
        ]
        self.router = ns.router.ClusterRouter({s.name: s.url for s in self.shards}, pairs, scrape_interval_s=60.0)
        self.server = ns.router.RouterHTTPServer(self.router).start()
        if step_ms is not None:
            clock = _stepped(step_ms)
            real = ns.router.Deadline
            monkeypatch.setattr(ns.router, "Deadline", types.SimpleNamespace(
                from_ms=lambda ms: real.from_ms(ms, clock=clock)))

    def post(self, body):
        status, hdrs, raw = request(self.server.port, "POST", "/v1/generate_range", body)
        return status, hdrs.get("Content-Type", ""), raw

    def shard_counters(self):
        return [s.service.metrics_snapshot()["counters"] for s in self.shards]

    def close(self):
        self.server.shutdown(timeout=30)
        for s in self.shards:
            s.stop(timeout=10)


@pytest.fixture(scope="module")
def references(worlds):
    """The fault-free answers, buffered and streamed, of the reference's
    cluster (the single daemon's bytes)."""
    cluster = _Cluster("ref", worlds["ref"], 5.0)
    try:
        status, _, raw = cluster.post(BODY)
        assert status == 200
        refs = {"buffered": _canon(json.loads(raw)["bundle"])}
        status, ctype, raw = cluster.post(dict(BODY, stream=True))
        assert status == 200 and STREAM_CONTENT_TYPE in ctype
        refs["stream"] = _canon(ref_decode(raw))
        return refs
    finally:
        cluster.close()


def _classify(pkg, status, ctype, raw, reference):
    """``identical``, ``typed`` or a violation string, and the refusal's
    type (None when identical)."""
    if STREAM_CONTENT_TYPE in ctype:
        try:
            doc = PKGS[pkg].decode(raw)
        except PKGS[pkg].Abort as exc:
            kind = exc.remote_error_type
            return ("typed" if kind in TYPED else f"stream abort with wrong type: {kind}"), kind
        return ("identical" if _canon(doc) == reference else "divergent streamed bundle"), None
    obj = json.loads(raw)
    if status == 200:
        return ("identical" if _canon(obj["bundle"]) == reference else "divergent buffered bundle"), None
    if status == 504 and obj.get("error_type") in TYPED:
        return "typed", obj["error_type"]
    return f"untyped refusal: {status} {obj}", None


def _run(pkg, worlds, references, monkeypatch, door, shape):
    deadline_ms, step_ms, floor_ms = SHAPES[shape]
    with monkeypatch.context() as patch:
        cluster = _Cluster(pkg, worlds[pkg], floor_ms, patch, step_ms)
        try:
            body = dict(BODY, deadline_ms=deadline_ms)
            if door == "stream":
                body["stream"] = True
            verdict = _classify(pkg, *cluster.post(body), references[door])
            counters = cluster.router.metrics.snapshot()["counters"], cluster.shard_counters()
        finally:
            cluster.close()
    return verdict, counters


@pytest.mark.parametrize("door", ["buffered", "stream"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_grid_identical_or_typed(worlds, references, monkeypatch, door, shape):
    (verdict, kind), (router_c, shard_c) = _run("port", worlds, references, monkeypatch, door, shape)
    assert verdict == EXPECT[shape], (door, shape, verdict)
    rejects_router = router_c.get("deadline.rejects.router", 0)
    rejects_shards = sum(c.get("deadline.rejects.httpd", 0) for c in shard_c)
    if shape == "ample":
        assert rejects_router == rejects_shards == 0
    elif shape == "shard-door":
        assert kind == "deadline" and rejects_router == 0 and rejects_shards >= 1
    else:
        assert kind == "deadline" and rejects_router >= 1 and rejects_shards == 0
    # the reference's router, the same case: the same verdict and type,
    # except its untyped abort of a stream whose budget ran out at dispatch
    (ref_verdict, ref_kind), _ = _run("ref", worlds, references, monkeypatch, door, shape)
    if (door, shape) == ("stream", "router-dispatch"):
        assert (ref_verdict, ref_kind) == ("stream abort with wrong type: internal", "internal")
    else:
        assert (ref_verdict, ref_kind) == (verdict, kind)


def test_router_floor_reject_is_counted(worlds):
    answers = []
    for pkg in ("port", "ref"):
        cluster = _Cluster(pkg, worlds[pkg], 5.0)
        try:
            status, _, raw = cluster.post({"pair_indexes": [0], "deadline_ms": 1})
            c = cluster.router.metrics.snapshot()["counters"]
            answers.append((status, json.loads(raw)["error_type"], c.get("serve.deadline_rejects", 0),
                            c.get("deadline.rejects.router", 0)))
        finally:
            cluster.close()
    assert answers[0] == answers[1] == (504, "deadline", 1, 1)


def test_header_budget_is_the_body_budget(worlds, references):
    """``X-IPC-Deadline-Ms`` is the same contract at the cluster door."""
    cluster = _Cluster("port", worlds["port"], 5.0)
    try:
        status, _, raw = request(cluster.server.port, "POST", "/v1/generate_range", BODY,
                                 headers={"X-IPC-Deadline-Ms": "1"})
        assert status == 504 and json.loads(raw)["error_type"] == "deadline"
        status, _, raw = request(cluster.server.port, "POST", "/v1/generate_range", BODY,
                                 headers={"X-IPC-Deadline-Ms": "60000"})
        assert status == 200 and _canon(json.loads(raw)["bundle"]) == references["buffered"]
    finally:
        cluster.close()


def test_stepped_clock_reads_the_real_deadline_type():
    """The stepped clock rides the real `Deadline` (only its clock is
    replaced): 20 ms with 10 ms a read has 10 ms left at its second read."""
    d = Deadline.from_ms(20.0, clock=_stepped(10.0))
    assert d.remaining_ms() == pytest.approx(10.0)
    assert d.remaining_ms() == pytest.approx(0.0)
