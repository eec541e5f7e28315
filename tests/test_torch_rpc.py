"""The port's Lotus JSON-RPC client (`store/rpc.py`) against the JAX
package's, scenario for scenario.

Each scenario runs once through each package's `LotusClient` /
`RpcBlockstore` with the same injected session, jitter source and blocks,
and returns what a caller can observe: the result or the exception class,
the posts the session saw, the sleeps and the counters. The two packages'
observations must be equal, and equal to the values the reference's own
tests pin (`tests/test_rpc_retry.py`, `tests/test_fetchplane.py::TestBatchFraming`).

Also: the synchronous range walker through `RpcBlockstore` makes as many
`rpc.calls` as the reference's for the same bundle, and importing
`store/rpc.py` does not import ``requests``.
"""

import base64
import json
import random
import subprocess
import sys
import types
from types import SimpleNamespace

import pytest

jax = pytest.importorskip("jax")

import ipc_proofs_tpu.store.faults as ref_faults  # noqa: E402
import ipc_proofs_tpu.store.rpc as ref_rpc  # noqa: E402
import ipc_proofs_tpu_torch.store.faults as port_faults  # noqa: E402
import ipc_proofs_tpu_torch.store.rpc as port_rpc  # noqa: E402
from ipc_proofs_tpu.core.cid import CID as RefCID  # noqa: E402
from ipc_proofs_tpu.fixtures import build_range_world as ref_build_range_world  # noqa: E402
from ipc_proofs_tpu.proofs.generator import EventProofSpec as RefSpec  # noqa: E402
from ipc_proofs_tpu.proofs.range import (  # noqa: E402
    generate_event_proofs_for_range_chunked as ref_chunked,
)
from ipc_proofs_tpu.store.blockstore import MemoryBlockstore as RefStore  # noqa: E402
from ipc_proofs_tpu.utils.metrics import Metrics as RefMetrics  # noqa: E402
from ipc_proofs_tpu_torch.backend import get_backend  # noqa: E402
from ipc_proofs_tpu_torch.core.cid import CID  # noqa: E402
from ipc_proofs_tpu_torch.fixtures import build_range_world  # noqa: E402
from ipc_proofs_tpu_torch.proofs.generator import EventProofSpec  # noqa: E402
from ipc_proofs_tpu_torch.proofs.range import generate_event_proofs_for_range_chunked  # noqa: E402
from ipc_proofs_tpu_torch.store.blockstore import MemoryBlockstore  # noqa: E402
from ipc_proofs_tpu_torch.utils.metrics import Metrics  # noqa: E402

SIG = "NewTopDownMessage(bytes32,uint256)"
SUBNET = "calib-subnet-1"
ACTOR = 1001

PORT = SimpleNamespace(rpc=port_rpc, faults=port_faults, CID=CID, Store=MemoryBlockstore, Metrics=Metrics)
REF = SimpleNamespace(rpc=ref_rpc, faults=ref_faults, CID=RefCID, Store=RefStore, Metrics=RefMetrics)


class _MaxJitterRng:
    """Always draws the upper bound: the exact exponential envelope."""

    def uniform(self, lo, hi):
        return hi


class _Response:
    def __init__(self, result=None, error=None):
        self._body = {"jsonrpc": "2.0", "result": result, "id": 1}
        if error is not None:
            self._body["error"] = error

    def raise_for_status(self):
        pass

    def json(self):
        return self._body


class _ScriptedSession:
    """Transport error for the first ``fail_times`` posts, then a JSON-RPC
    ``error`` for the next ``error_times``, then ``result``. Records the
    timeout of every post."""

    def __init__(self, fail_times=0, error=None, error_times=0, result="ok"):
        self.fail_times, self.error, self.error_times, self.result = fail_times, error, error_times, result
        self.posts = 0
        self.timeouts: list = []

    def post(self, endpoint, data=None, headers=None, timeout=None):
        self.posts += 1
        self.timeouts.append(timeout)
        if self.posts <= self.fail_times:
            raise ConnectionError(f"transport down (post {self.posts})")
        if self.posts <= self.fail_times + self.error_times:
            return _Response(error=self.error)
        return _Response(result=self.result)


def _request(pkg, monkeypatch, session, method="Filecoin.Thing", **kw) -> dict:
    sleeps: list = []
    monkeypatch.setattr(pkg.rpc.time, "sleep", sleeps.append)
    m = pkg.Metrics()
    kw.setdefault("max_retries", 4)
    kw.setdefault("rng", _MaxJitterRng())
    client = pkg.rpc.LotusClient("http://fake", session=session, metrics=m, **kw)
    try:
        outcome = client.request(method, [])
    except Exception as exc:  # the observation is the exception's class and text
        outcome = (type(exc).__name__, str(exc))
    counters = m.snapshot()["counters"]
    return {"outcome": outcome, "posts": session.posts, "sleeps": sleeps, "counters": counters}


def _both(monkeypatch, make_session, **kw) -> dict:
    port = _request(PORT, monkeypatch, make_session(), **kw)
    ref = _request(REF, monkeypatch, make_session(), **kw)
    assert port == ref
    return port


class TestRetries:
    def test_transport_errors_retry_then_succeed(self, monkeypatch):
        got = _both(monkeypatch, lambda: _ScriptedSession(fail_times=2), backoff_base_s=0.25)
        assert got["outcome"] == "ok" and got["posts"] == 3
        assert got["sleeps"] == [0.25, 0.5]  # base * 2**attempt
        assert got["counters"]["rpc.retries"] == 2 and got["counters"]["rpc.calls"] == 1

    def test_backoff_is_bounded(self, monkeypatch):
        got = _both(
            monkeypatch, lambda: _ScriptedSession(fail_times=5),
            max_retries=6, backoff_base_s=1.0, backoff_max_s=3.0,
        )
        assert got["sleeps"] == [1.0, 2.0, 3.0, 3.0, 3.0]

    def test_backoff_is_full_jitter(self, monkeypatch):
        # a seeded rng: every sleep within its envelope, not all at it, and
        # the same draws in both packages
        sleeps = [
            _request(
                pkg, monkeypatch, _ScriptedSession(fail_times=5), max_retries=6,
                backoff_base_s=1.0, backoff_max_s=3.0, rng=random.Random(7),
            )["sleeps"]
            for pkg in (PORT, REF)
        ]
        assert sleeps[0] == sleeps[1]
        envelopes = [1.0, 2.0, 3.0, 3.0, 3.0]
        assert all(0.0 <= s <= e for s, e in zip(sleeps[0], envelopes)) and sleeps[0] != envelopes

    def test_exhaustion_raises_and_counts_failure(self, monkeypatch):
        got = _both(monkeypatch, lambda: _ScriptedSession(fail_times=99), max_retries=3)
        assert got["outcome"][0] == "RuntimeError" and "failed after 3 attempts" in got["outcome"][1]
        assert got["posts"] == 3
        assert got["counters"]["rpc.retries"] == 2 and got["counters"]["rpc.failures"] == 1

    @pytest.mark.parametrize(
        "error, retried",
        [
            ({"code": -32601, "message": "no such method"}, False),
            ({"code": 1, "message": "actor not found"}, False),
            ({"code": 429, "message": "slow down"}, True),
            ({"code": -429, "message": "slow down"}, True),
            ({"code": 1, "message": "Too Many Requests, try later"}, True),
        ],
    )
    def test_rpc_error_codes(self, monkeypatch, error, retried):
        got = _both(monkeypatch, lambda: _ScriptedSession(error=error, error_times=2))
        if retried:
            assert got["outcome"] == "ok" and got["posts"] == 3 and got["counters"]["rpc.retries"] == 2
        else:
            assert got["outcome"][0] == "RpcError" and got["posts"] == 1 and got["sleeps"] == []

    def test_rate_limit_exhaustion_raises_runtime_error(self, monkeypatch):
        got = _both(
            monkeypatch, lambda: _ScriptedSession(error={"code": 429, "message": "x"}, error_times=99),
            max_retries=3,
        )
        assert got["outcome"][0] == "RuntimeError" and got["counters"]["rpc.failures"] == 1

    def test_custom_retryable_code_set(self, monkeypatch):
        got = _both(
            monkeypatch, lambda: _ScriptedSession(error={"code": -777, "message": "custom"}, error_times=2),
            retryable_rpc_codes=frozenset({-777}),
        )
        assert got["outcome"] == "ok" and got["posts"] == 3


class TestTimeouts:
    @pytest.mark.parametrize("call, want", [("block", [30.0]), ("general", [250.0]), ("override", [5.0])])
    def test_deadlines(self, call, want):
        raw = b"\x01\x02\x03"
        for pkg in (PORT, REF):
            session = _ScriptedSession(result=base64.b64encode(raw).decode())
            client = pkg.rpc.LotusClient(
                "http://fake", session=session, metrics=pkg.Metrics(), timeout_s=250.0, block_timeout_s=30.0
            )
            if call == "block":
                assert client.chain_read_obj(pkg.CID.hash_of(b"block")) == raw
            elif call == "general":
                client.request("Filecoin.StateLookupID", [])
            else:
                client.request("Filecoin.Thing", [], timeout_s=5.0)
            assert session.timeouts == want


class _HttpStatusError(Exception):
    """requests.HTTPError stand-in: carries .response.status_code."""

    def __init__(self, status: int):
        super().__init__(f"HTTP {status}")
        self.response = types.SimpleNamespace(status_code=status)


def _blocks(pkg, n: int, tag: bytes = b"blk"):
    out = []
    for i in range(n):
        data = (tag + b"-%04d-" % i) * (i % 5 + 2)
        out.append((pkg.CID.hash_of(data), data))
    return out


def _store_with(pkg, blocks):
    bs = pkg.Store()
    for cid, data in blocks:
        bs.put_keyed(cid, data)
    return bs


def _session_class(pkg, mode: str):
    """A `LocalLotusSession` of ``pkg`` that misbehaves in one of the ways
    the batch framing must survive."""
    base = pkg.faults.LocalLotusSession

    class _Session(base):
        flaked = False
        reject_next = False

        def post(self, url, data=None, headers=None, timeout=None):
            body = json.loads(data) if data else {}
            is_batch = isinstance(body, list)
            if is_batch and mode == "5xx-once" and not self.flaked:
                self.flaked = True
                raise _HttpStatusError(503)
            if is_batch and mode == "405":
                raise _HttpStatusError(405)
            if is_batch and mode == "late-400" and self.reject_next:
                self.reject_next = False
                raise _HttpStatusError(400)
            resp = super().post(url, data=data, headers=headers, timeout=timeout)
            reply = resp.json()
            if isinstance(reply, list) and mode == "one-error":
                reply[0] = {"jsonrpc": "2.0", "error": {"code": -32000, "message": "flake"}, "id": reply[0]["id"]}
            if isinstance(reply, list) and mode == "drop-one" and len(reply) > 1:
                reply.pop()
            return resp

    return _Session


def _framing(pkg, mode: str, n: int = 8, present: "int | None" = None) -> dict:
    blocks = _blocks(pkg, n)
    bs = _store_with(pkg, blocks[: n if present is None else present])
    m = pkg.Metrics()
    session = _session_class(pkg, mode)(bs, batch=(mode != "no-batch"))
    client = pkg.rpc.LotusClient(
        "http://framing", session=session, metrics=m, max_retries=3,
        backoff_base_s=0.0, backoff_max_s=0.0,
    )
    cids = [c for c, _ in blocks]
    waves = [client.chain_read_obj_many(cids)]
    probe_after_first = client.supports_batch
    if mode == "late-400":
        session.reject_next = True
    waves.append(client.chain_read_obj_many(cids))
    want = [d for _, d in blocks[: n if present is None else present]]
    want += [None] * (n - len(want))
    assert waves == [want, want]
    return {
        "probe": (probe_after_first, client.supports_batch),
        "posts": session.calls,
        "batch_posts": session.batch_calls,
        "counters": m.snapshot()["counters"],
    }


class TestBatchFraming:
    @pytest.mark.parametrize(
        "mode, probe, counters",
        [
            ("ok", (True, True), {"rpc.calls": 2, "rpc.batch_calls": 2, "rpc.batched_reads": 16}),
            ("one-error", (True, True), {"rpc.batch_item_retries": 2, "rpc.calls": 4}),
            ("drop-one", (True, True), {"rpc.batch_item_retries": 2}),
            ("5xx-once", (True, True), {"rpc.batch_calls": 2, "rpc.retries": 1}),
            ("405", (False, False), {"rpc.batch_unsupported": 1, "rpc.calls": 17}),
            ("late-400", (True, True), {"rpc.batch_calls": 2, "rpc.retries": 1}),
            ("no-batch", (False, False), {"rpc.batch_unsupported": 1, "rpc.calls": 17}),
        ],
    )
    def test_framing_equals_reference(self, mode, probe, counters):
        port, ref = _framing(PORT, mode), _framing(REF, mode)
        assert port == ref
        assert port["probe"] == probe
        for name, value in counters.items():
            assert port["counters"][name] == value, name
        if mode in ("405", "no-batch"):
            assert port["counters"].get("rpc.batch_calls", 0) == 0

    def test_missing_block_is_none_in_place(self):
        assert _framing(PORT, "ok", n=4, present=3) == _framing(REF, "ok", n=4, present=3)

    def test_empty_and_singleton_skip_batch_framing(self):
        blocks = _blocks(PORT, 2)
        client = port_rpc.LotusClient(
            "http://one", session=port_faults.LocalLotusSession(_store_with(PORT, blocks)), metrics=Metrics()
        )
        assert client.chain_read_obj_many([]) == []
        assert client.chain_read_obj_many([blocks[0][0]]) == [blocks[0][1]]
        assert client._session.batch_calls == 0 and client.supports_batch is None

    def test_undecodable_payload_is_an_integrity_error(self):
        cid = CID.hash_of(b"x")

        class _Garbage:
            def post(self, url, data=None, headers=None, timeout=None):
                body = json.loads(data)
                if isinstance(body, list):
                    return _Response_list([{"jsonrpc": "2.0", "result": "a", "id": e["id"]} for e in body])
                return _Response(result="a")

        client = port_rpc.LotusClient("http://garbage", session=_Garbage(), metrics=Metrics())
        with pytest.raises(port_rpc.IntegrityError, match="undecodable"):
            client.chain_read_obj(cid)
        with pytest.raises(port_rpc.IntegrityError, match="undecodable"):
            client.chain_read_obj_many([cid, CID.hash_of(b"y")])


class _Response_list(_Response):
    def __init__(self, body):
        self._body = body


class TestRpcBlockstore:
    def _store(self, pkg, lie: bool = False):
        blocks = _blocks(pkg, 12, tag=b"pf")
        bs = _store_with(pkg, blocks)
        if lie:
            bs.put_keyed(blocks[3][0], b"lie " + blocks[3][1])
        m = pkg.Metrics()
        client = pkg.rpc.LotusClient("http://pf", session=pkg.faults.LocalLotusSession(bs), metrics=m)
        return pkg.rpc.RpcBlockstore(client, metrics=m), blocks, m

    def test_prefetch_ships_one_batch_like_the_reference(self):
        out = []
        for pkg in (PORT, REF):
            store, blocks, m = self._store(pkg)
            into: dict = {}
            assert store.prefetch([c for c, _ in blocks], into) == {}
            assert into == dict(blocks)
            out.append(m.snapshot()["counters"])
        assert out[0] == out[1] and out[0]["rpc.calls"] == 1 and out[0]["rpc.batch_calls"] == 1

    def test_a_lying_endpoint_raises_and_prefetch_collects(self):
        out = []
        for pkg in (PORT, REF):
            store, blocks, m = self._store(pkg, lie=True)
            with pytest.raises(pkg.rpc.IntegrityError):
                store.get(blocks[3][0])
            with pytest.raises(pkg.rpc.IntegrityError):
                store.get_many([c for c, _ in blocks])
            into: dict = {}
            failures = store.prefetch([c for c, _ in blocks], into)
            assert list(failures) == [blocks[3][0]]
            assert len(into) == 11
            out.append(m.snapshot()["counters"])
        assert out[0] == out[1]

    def test_offer_links_without_a_plane_is_dropped(self):
        store, blocks, m = self._store(PORT)
        store.offer_links([c for c, _ in blocks])
        assert m.snapshot()["counters"] == {}
        with pytest.raises(NotImplementedError):
            store.put_keyed(*blocks[0])


@pytest.fixture(scope="module")
def worlds():
    kw = dict(signature=SIG, topic1=SUBNET, actor_id=ACTOR)
    return build_range_world(6, 4, 2, 0.2, **kw), ref_build_range_world(6, 4, 2, 0.2, **kw)


@pytest.mark.parametrize("chunk_size", [3, 8])
def test_synchronous_walker_makes_the_references_rpc_calls(worlds, chunk_size):
    """The chunked driver over `RpcBlockstore` (one ChainReadObj per block,
    no plane): the same bundle and the same `rpc.calls` as the reference."""
    (bs, pairs, _), (ref_bs, ref_pairs, _) = worlds
    m, ref_m = Metrics(), RefMetrics()
    got = generate_event_proofs_for_range_chunked(
        port_rpc.RpcBlockstore(port_rpc.LotusClient("http://w", session=port_faults.LocalLotusSession(bs), metrics=m)),
        pairs, EventProofSpec(SIG, SUBNET, ACTOR), chunk_size=chunk_size, metrics=m,
        match_backend=get_backend("gpu", device="cpu"),
    )
    want = ref_chunked(
        ref_rpc.RpcBlockstore(
            ref_rpc.LotusClient("http://w", session=ref_faults.LocalLotusSession(ref_bs), metrics=ref_m)
        ),
        ref_pairs, RefSpec(SIG, SUBNET, ACTOR), chunk_size=chunk_size, metrics=ref_m,
    )
    assert got.to_json() == want.to_json()
    calls = m.counter_value("rpc.calls")
    assert calls > 0 and calls == ref_m.snapshot()["counters"]["rpc.calls"]


def test_importing_rpc_does_not_import_requests():
    code = (
        "import sys, ipc_proofs_tpu_torch.store.rpc, ipc_proofs_tpu_torch.store.faults, "
        "ipc_proofs_tpu_torch.store.fetchplane, ipc_proofs_tpu_torch.storex; "
        "print('requests' in sys.modules)"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "False"


@pytest.mark.parametrize("kinds", [("bitflip",), ("truncate", "latency"), ("transport", "timeout")])
def test_faulty_blockstore_draws_as_the_reference(kinds):
    """`FaultPlan` + `FaultyBlockstore`: the same seed gives the same
    schedule of faults and the same corrupted bytes in both packages."""
    outcomes = []
    for pkg in (PORT, REF):
        blocks = _blocks(pkg, 40, tag=b"fb")
        plan = pkg.faults.FaultPlan(7, fault_rate=0.5, kinds=kinds, latency_s=0.0)
        store = pkg.faults.FaultyBlockstore(_store_with(pkg, blocks), plan, sleep=lambda s: None)
        seen = []
        for cid, _ in blocks:
            try:
                seen.append(store.get(cid))
            except (ConnectionError, TimeoutError) as exc:
                seen.append(type(exc).__name__)
        outcomes.append((seen, plan.snapshot()))
    assert outcomes[0] == outcomes[1]
    assert outcomes[0][1]["faults_injected"] > 0


def test_counter_names_are_the_references():
    """Every counter and gauge the port's cold read path, endpoint pool,
    chain follower and trace spine emit is a name the reference declares
    in its vocabularies."""
    import ast
    from pathlib import Path

    import ipc_proofs_tpu.utils.metrics as ref_metrics
    import ipc_proofs_tpu_torch

    root = Path(ipc_proofs_tpu_torch.__file__).resolve().parent
    emitted = set()
    for rel in ("store/rpc.py", "store/fetchplane.py", "storex/segments.py", "ops/verify.py",
                "store/failover.py", "storex/follower.py", "obs/trace.py", "obs/export.py"):
        for node in ast.walk(ast.parse((root / rel).read_text())):
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in ("count", "set_gauge")
                and node.args
                and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)  # not itertools.count(1)
            ):
                emitted.add(node.args[0].value)
    vocab = ("RESILIENCE_COUNTERS", "ASYNCFETCH_COUNTERS", "STOREX_COUNTERS", "STOREX_GAUGES", "VERIFY_COUNTERS",
             "DEGRADED_COUNTERS", "OBSERVABILITY_COUNTERS")
    ref_names = {n for v in vocab for n in getattr(ref_metrics, v)}
    assert emitted and emitted <= ref_names, sorted(emitted - ref_names)
    # the port's own vocabularies are the reference's names
    import ipc_proofs_tpu_torch.utils.metrics as port_metrics

    for name in ("RESILIENCE_COUNTERS", "OBSERVABILITY_COUNTERS", "DEGRADED_COUNTERS"):
        assert getattr(port_metrics, name) == getattr(ref_metrics, name)
    assert set(port_metrics.FOLLOW_COUNTERS) <= set(ref_metrics.STOREX_COUNTERS)
    assert set(port_metrics.FOLLOW_GAUGES) <= set(ref_metrics.STOREX_GAUGES)
