"""The port's durable admission queue (`serve/durable.py`) against the JAX
package's.

Every case of the reference's ``tests/test_serve_durable.py`` runs on both
packages (``pkg`` = port on ``device="cpu"``, or the reference on its host
path) with the same assertions, and the journals they write are compared
record for record (trace ids and timings aside). Queue directories cross
packages both ways: admits the reference journaled resume in the port and
the reverse. A fault of the card (`ops.build.is_device_fault`) is never a
request's result: the admit stays pending, the fault reaches the caller,
a replay that meets one raises out of the constructor, and over HTTP it is
a 500, never a 400.
"""

import json
import threading
import types

import pytest
import torch

jax = pytest.importorskip("jax")

import ipc_proofs_tpu.jobs.journal as ref_journal  # noqa: E402
import ipc_proofs_tpu.serve as ref_serve  # noqa: E402
import ipc_proofs_tpu.utils.metrics as ref_metrics  # noqa: E402
import ipc_proofs_tpu_torch.jobs.journal as port_journal  # noqa: E402
import ipc_proofs_tpu_torch.serve as port_serve  # noqa: E402
import ipc_proofs_tpu_torch.utils.metrics as port_metrics  # noqa: E402
from ipc_proofs_tpu.proofs.generator import EventProofSpec as RefSpec  # noqa: E402
from ipc_proofs_tpu.proofs.trust import TrustPolicy as RefTrust  # noqa: E402
from ipc_proofs_tpu_torch.backend import get_backend  # noqa: E402
from ipc_proofs_tpu_torch.ops.build import DeviceFaultError  # noqa: E402
from ipc_proofs_tpu_torch.ops.verify import VerifyLaneError  # noqa: E402
from ipc_proofs_tpu_torch.proofs.generator import EventProofSpec  # noqa: E402
from ipc_proofs_tpu_torch.proofs.trust import TrustPolicy  # noqa: E402

from _torch_http import SIG, SUBNET, get, post, strip, worlds  # noqa: E402

PKGS = ("port", "ref")


@pytest.fixture(scope="module")
def both_worlds():
    return worlds(4, receipts=2, events=2, match_rate=0.5)


def _pkg(name, both_worlds):
    port_world, ref_world = both_worlds
    if name == "port":
        return types.SimpleNamespace(
            name=name, serve=port_serve, journal=port_journal, Metrics=port_metrics.Metrics,
            world=port_world, spec=EventProofSpec(event_signature=SIG, topic_1=SUBNET),
            trust=TrustPolicy, config=dict(device="cpu"),
        )
    return types.SimpleNamespace(
        name=name, serve=ref_serve, journal=ref_journal, Metrics=ref_metrics.Metrics,
        world=ref_world, spec=RefSpec(event_signature=SIG, topic_1=SUBNET),
        trust=RefTrust, config={},
    )


@pytest.fixture(params=PKGS)
def pkg(request, both_worlds):
    return _pkg(request.param, both_worlds)


def _service(pkg, metrics=None):
    store, _, _ = pkg.world
    return pkg.serve.ProofService(
        store=store, spec=pkg.spec, trust_policy=pkg.trust.accept_all(), event_filter=None,
        config=pkg.serve.ServiceConfig(workers=1, max_wait_ms=1.0, **pkg.config), metrics=metrics,
    )


def _durable(pkg, svc, path, **kw):
    return pkg.serve.DurableAdmission(svc, str(path), pairs=pkg.world[1], **kw)


def _records(pkg, path):
    records, _, torn = pkg.journal.read_journal(str(path / "queue.bin"))
    assert not torn
    return records


def _tampered(bundle_obj):
    """A verify payload whose first event proof claims another emitter."""
    out = json.loads(json.dumps(bundle_obj))
    out["event_proofs"][0]["event_data"]["emitter"] += 1
    return out


# --------------------------------------------------------------------------
# the reference's TestDurableAdmission, on both packages
# --------------------------------------------------------------------------


def test_journaled_before_ack_and_idempotent(tmp_path, pkg):
    svc = _service(pkg)
    d = _durable(pkg, svc, tmp_path)
    try:
        key, done, cached = d.submit("generate", 0, idempotency_key="g-1")
        assert key == "g-1" and done["ok"] and not cached
        records = _records(pkg, tmp_path)
        assert [r["t"] for r in records] == ["admit", "done"]
        assert records[0]["key"] == records[1]["key"] == "g-1"
        _, done2, cached2 = d.submit("generate", 0, idempotency_key="g-1")
        assert cached2 and done2 == done
        assert len(_records(pkg, tmp_path)) == 2
    finally:
        d.close()
        svc.drain()


def test_verify_and_semantic_failure_roundtrip(tmp_path, pkg):
    svc = _service(pkg)
    d = _durable(pkg, svc, tmp_path)
    try:
        _, gen, _ = d.submit("generate", 1, idempotency_key="g")
        _, ver, _ = d.submit("verify", gen["result"]["bundle"], idempotency_key="v")
        assert ver["ok"] and ver["result"]["all_valid"] is True
        _, bad, cached = d.submit("generate", 99, idempotency_key="bad")
        assert not bad["ok"] and "pair_index" in bad["error"] and not cached
        _, bad2, cached2 = d.submit("generate", 99, idempotency_key="bad")
        assert cached2 and bad2 == bad
    finally:
        d.close()
        svc.drain()


def test_cache_survives_restart(tmp_path, pkg):
    svc = _service(pkg)
    d = _durable(pkg, svc, tmp_path)
    _, done, _ = d.submit("generate", 0, idempotency_key="g-1")
    d.close()
    svc.drain()
    svc2 = _service(pkg)
    d2 = _durable(pkg, svc2, tmp_path)
    try:
        assert d2.resumed_jobs == 0
        _, done2, cached = d2.submit("generate", 0, idempotency_key="g-1")
        assert cached and done2 == done
    finally:
        d2.close()
        svc2.drain()


def test_unfinished_admit_replayed_on_restart(tmp_path, pkg):
    w = pkg.journal.JournalWriter(str(tmp_path / "queue.bin"))
    w.append({"t": "admit", "key": "crashed", "kind": "generate", "payload": 1})
    w.close()
    metrics = pkg.Metrics()
    svc = _service(pkg, metrics=metrics)
    d = _durable(pkg, svc, tmp_path)
    try:
        assert d.resumed_jobs == 1
        assert metrics.snapshot()["counters"]["serve.requests_replayed"] == 1
        _, done, cached = d.submit("generate", 1, idempotency_key="crashed")
        assert cached and done["ok"]
    finally:
        d.close()
        svc.drain()
    svc2 = _service(pkg)
    d2 = _durable(pkg, svc2, tmp_path)
    try:
        assert d2.resumed_jobs == 0
    finally:
        d2.close()
        svc2.drain()


def test_poison_admit_finishes_with_error_once(tmp_path, pkg):
    w = pkg.journal.JournalWriter(str(tmp_path / "queue.bin"))
    w.append({"t": "admit", "key": "poison", "kind": "generate", "payload": 999})
    w.close()
    svc = _service(pkg)
    _durable(pkg, svc, tmp_path).close()
    svc.drain()
    svc2 = _service(pkg)
    d2 = _durable(pkg, svc2, tmp_path)
    try:
        assert d2.resumed_jobs == 0
        _, done, cached = d2.submit("generate", 999, idempotency_key="poison")
        assert cached and not done["ok"]
    finally:
        d2.close()
        svc2.drain()


def test_torn_queue_tail_truncated(tmp_path, pkg):
    w = pkg.journal.JournalWriter(str(tmp_path / "queue.bin"))
    w.append({"t": "admit", "key": "k1", "kind": "generate", "payload": 0})
    w.append({"t": "done", "key": "k1", "payload": {"ok": True, "result": {}}})
    w.close()
    with open(tmp_path / "queue.bin", "ab") as fh:
        fh.write(b"IPJ1\x99")
    svc = _service(pkg)
    d = _durable(pkg, svc, tmp_path)
    try:
        _, done, cached = d.submit("verify", {}, idempotency_key="k1")
        assert cached and done == {"ok": True, "result": {}}
        assert len(_records(pkg, tmp_path)) == 2
    finally:
        d.close()
        svc.drain()


def test_concurrent_same_key_coalesces(tmp_path, pkg):
    svc = _service(pkg)
    d = _durable(pkg, svc, tmp_path)
    results = []

    def go():
        results.append(d.submit("generate", 0, idempotency_key="same"))

    try:
        threads = [threading.Thread(target=go) for _ in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
            assert not t.is_alive()
        assert len(results) == 6
        dones = [r[1] for r in results]
        assert all(done == dones[0] and done["ok"] for done in dones)
        assert [r["t"] for r in _records(pkg, tmp_path)] == ["admit", "done"]
        assert sum(1 for _, _, cached in results if not cached) == 1
    finally:
        d.close()
        svc.drain()


def test_journal_degrade_keeps_serving(tmp_path, pkg):
    metrics = pkg.Metrics()
    svc = _service(pkg, metrics=metrics)
    d = _durable(pkg, svc, tmp_path)

    class _Broken:
        def write(self, data):
            raise OSError(28, "No space left on device")

        def flush(self):
            pass

        def close(self):
            pass

    d._writer._fh.close()
    d._writer._fh = _Broken()
    try:
        _, done, _ = d.submit("generate", 0, idempotency_key="g")
        assert done["ok"]
        assert d.health_fields()["journal_degraded"] is True
        assert metrics.snapshot()["counters"]["jobs.journal_failures"] >= 1
    finally:
        d.close()
        svc.drain()


# --------------------------------------------------------------------------
# the reference's TestResultSpill, on both packages
# --------------------------------------------------------------------------


def test_evicted_result_served_from_disk(tmp_path, pkg):
    svc = _service(pkg)
    d = _durable(pkg, svc, tmp_path, results_max_bytes=1)
    try:
        _, done, cached = d.submit("generate", 0, idempotency_key="g-1")
        assert done["ok"] and not cached
        assert d.health_fields()["result_cache_hot_bytes"] == 0
        _, done2, cached2 = d.submit("generate", 0, idempotency_key="g-1")
        assert cached2 and done2 == done
        assert [r["t"] for r in _records(pkg, tmp_path)] == ["admit", "done"]
    finally:
        d.close()
        svc.drain()


def test_hot_tier_bounded_and_evictions_counted(tmp_path, pkg):
    metrics = pkg.Metrics()
    svc = _service(pkg, metrics=metrics)
    cap = 4096
    d = _durable(pkg, svc, tmp_path, results_max_bytes=cap)
    try:
        for i in range(6):
            assert d.submit("generate", i % 2, idempotency_key=f"g-{i}")[1]["ok"]
        assert d.health_fields()["result_cache_hot_bytes"] <= cap
        snap = metrics.snapshot()
        assert snap["counters"]["serve.result_cache_evictions"] >= 1
        assert snap["gauges"]["serve.result_cache_bytes"] <= cap
        for i in range(6):
            _, done, cached = d.submit("generate", i % 2, idempotency_key=f"g-{i}")
            assert cached and done["ok"]
    finally:
        d.close()
        svc.drain()


def test_spilled_dedup_survives_restart(tmp_path, pkg):
    svc = _service(pkg)
    d = _durable(pkg, svc, tmp_path, results_max_bytes=1)
    _, done, _ = d.submit("generate", 1, idempotency_key="g-r")
    d.close()
    d2 = _durable(pkg, svc, tmp_path, results_max_bytes=1)
    try:
        assert d2.health_fields()["result_cache_hot_bytes"] == 0
        _, done2, cached = d2.submit("generate", 1, idempotency_key="g-r")
        assert cached and done2 == done
        assert len(_records(pkg, tmp_path)) == 2
    finally:
        d2.close()
        svc.drain()


def test_corrupt_spilled_frame_reexecutes(tmp_path, pkg):
    svc = _service(pkg)
    d = _durable(pkg, svc, tmp_path, results_max_bytes=1)
    try:
        _, done, _ = d.submit("generate", 0, idempotency_key="g-c")
        jpath = str(tmp_path / "queue.bin")
        entries, _, _ = pkg.journal.read_journal_entries(jpath)
        (end,) = [e for rec, _, e in entries if rec.get("t") == "done"]
        with open(jpath, "r+b") as fh:
            fh.seek(end - 2)
            b = fh.read(1)
            fh.seek(end - 2)
            fh.write(bytes([b[0] ^ 0x40]))
        _, done2, cached = d.submit("generate", 0, idempotency_key="g-c")
        assert not cached and done2["ok"]
        assert done2["result"]["bundle"] == done["result"]["bundle"]
        _, done3, cached3 = d.submit("generate", 0, idempotency_key="g-c")
        assert cached3 and done3 == done2
    finally:
        d.close()
        svc.drain()


# --------------------------------------------------------------------------
# journals across packages
# --------------------------------------------------------------------------


def _workload(d, bundle_obj):
    d.submit("generate", 0, idempotency_key="g0")
    d.submit("generate", 3, idempotency_key="g3")
    d.submit("verify", bundle_obj, idempotency_key="v")
    d.submit("verify", _tampered(bundle_obj), idempotency_key="vt")
    d.submit("generate", 99, idempotency_key="bad")


def test_journals_equal_record_for_record(tmp_path, both_worlds):
    """The same request sequence journals the same admit and done records
    in both packages (per-process trace ids and timings aside)."""
    out = {}
    for name in PKGS:
        pkg = _pkg(name, both_worlds)
        svc = _service(pkg)
        d = _durable(pkg, svc, tmp_path / name)
        try:
            bundle = d.submit("generate", 1, idempotency_key="g1")[1]["result"]["bundle"]
            _workload(d, bundle)
        finally:
            d.close()
            svc.drain()
        out[name] = strip(_records(pkg, tmp_path / name))
    assert out["port"] == out["ref"]
    assert [r["t"] for r in out["port"]] == ["admit", "done"] * 6
    assert [r["payload"]["ok"] for r in out["port"][1::2]] == [True] * 5 + [False]


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")], ids=["ref-to-port", "port-to-ref"])
def test_queue_directory_resumes_across_packages(tmp_path, both_worlds, writer, reader):
    """Admits one package journaled and never finished re-execute in the
    other at open, with the results a clean run gives; finished keys are
    served from the other package's done frames."""
    w, r = _pkg(writer, both_worlds), _pkg(reader, both_worlds)
    svc = _service(w)
    d = _durable(w, svc, tmp_path)
    try:
        _, finished, _ = d.submit("generate", 2, idempotency_key="finished")
        bundle = finished["result"]["bundle"]
    finally:
        d.close()
        svc.drain()
    jw = w.journal.JournalWriter(str(tmp_path / "queue.bin"))
    jw.append({"t": "admit", "key": "crashed-g", "kind": "generate", "payload": 1})
    jw.append({"t": "admit", "key": "crashed-v", "kind": "verify", "payload": bundle})
    jw.close()

    clean_svc = _service(r)
    clean = _durable(r, clean_svc, tmp_path / "clean")
    try:
        expect_g = clean.submit("generate", 1)[1]
        expect_v = clean.submit("verify", bundle)[1]
    finally:
        clean.close()
        clean_svc.drain()

    metrics = r.Metrics()
    svc = _service(r, metrics=metrics)
    d = _durable(r, svc, tmp_path)
    try:
        assert d.resumed_jobs == 2
        assert metrics.snapshot()["counters"]["serve.requests_replayed"] == 2
        _, got_g, cached_g = d.submit("generate", 1, idempotency_key="crashed-g")
        _, got_v, cached_v = d.submit("verify", bundle, idempotency_key="crashed-v")
        _, got_f, cached_f = d.submit("generate", 2, idempotency_key="finished")
        assert cached_g and cached_v and cached_f
        assert strip(got_g) == strip(expect_g) and strip(got_v) == strip(expect_v)
        assert strip(got_f) == strip(finished)
    finally:
        d.close()
        svc.drain()


# --------------------------------------------------------------------------
# the reference's TestDurableHTTP, against both daemons
# --------------------------------------------------------------------------


@pytest.fixture()
def daemons(tmp_path, both_worlds):
    servers = {}
    for name in PKGS:
        pkg = _pkg(name, both_worlds)
        svc = _service(pkg)
        d = _durable(pkg, svc, tmp_path / name)
        servers[name] = pkg.serve.ProofHTTPServer(svc, pairs=pkg.world[1], durable=d).start()
    yield servers
    for httpd in servers.values():
        httpd.shutdown(timeout=30)


def _both(daemons, path, body):
    out = {name: post(httpd.port, path, body) for name, httpd in daemons.items()}
    (ps, ph, pb), (rs, rh, rb) = out["port"], out["ref"]
    assert ps == rs
    assert ph.get("Witness-Encoding") == rh.get("Witness-Encoding")
    if isinstance(pb, dict) and pb.get("idempotency_key", "").startswith("auto-"):
        pb, rb = dict(pb, idempotency_key="auto"), dict(rb, idempotency_key="auto")
    assert strip(pb) == strip(rb)
    return ps, pb


def test_http_generate_verify_with_keys(daemons):
    status, resp = _both(daemons, "/v1/generate", {"pair_index": 0, "idempotency_key": "g-1"})
    assert status == 200 and resp["ok"] and resp["cached"] is False
    status2, resp2 = _both(daemons, "/v1/generate", {"pair_index": 0, "idempotency_key": "g-1"})
    assert status2 == 200 and resp2["cached"] is True and resp2["result"] == resp["result"]
    status3, resp3 = _both(daemons, "/v1/verify", {"bundle": resp["result"]["bundle"], "idempotency_key": "v-1"})
    assert status3 == 200 and resp3["ok"] and resp3["result"]["all_valid"] is True


@pytest.mark.parametrize("encoding", ["identity", "zlib"])
def test_http_witness_treatments_reencode_the_journaled_result(daemons, encoding):
    """The journal holds the plain result; the response re-encodes it per
    request, aggregated claims included."""
    _, resp = _both(daemons, "/v1/generate", {"pair_index": 1, "witness_encoding": encoding, "idempotency_key": "w"})
    assert resp["result"]["witness_encoding"] == encoding
    _, agg = _both(daemons, "/v1/generate_range", {"pair_indexes": [0, 0, 2], "aggregate": True, "idempotency_key": "a"})
    assert agg["ok"] and len(agg["result"]["claims"]) == 3


def test_http_omitted_key_gets_auto_key(daemons):
    _, gen = _both(daemons, "/v1/generate", {"pair_index": 1})
    status, _, resp = post(daemons["port"].port, "/v1/verify", {"bundle": gen["result"]["bundle"]})
    assert status == 200 and resp["idempotency_key"].startswith("auto-")


def test_http_non_string_key_rejected(daemons):
    status, resp = _both(daemons, "/v1/generate", {"pair_index": 0, "idempotency_key": 5})
    assert status == 400 and "idempotency_key" in resp["error"]


def test_http_malformed_bundle_still_400(daemons):
    status, _ = _both(daemons, "/v1/verify", {"bundle": {"nope": 1}, "idempotency_key": "bad"})
    assert status == 400
    records, _, _ = port_journal.read_journal(str(daemons["port"].durable._writer.path))
    assert all(r["key"] != "bad" for r in records)


def test_http_healthz_reports_durable_fields(daemons):
    bodies = {}
    for name, httpd in daemons.items():
        status, _, health = get(httpd.port, "/healthz")
        assert status == 200
        bodies[name] = health
    for health in bodies.values():
        assert health["durable_queue"] is True and health["resumed_jobs"] == 0
        assert isinstance(health["journal_bytes"], int) and health["journal_degraded"] is False
    assert bodies["port"] == bodies["ref"]


# --------------------------------------------------------------------------
# device faults: never a request's result
# --------------------------------------------------------------------------


def _faults():
    return {
        "verify-lane": lambda: VerifyLaneError("lane fault"),
        "launch": lambda: DeviceFaultError("blake2b256_single_block: CUDA launch failed with error 700"),
        "cuda-runtime": lambda: RuntimeError("CUDA error: an illegal memory access was encountered"),
        "oom": lambda: torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"),
    }


def _break_backend(monkeypatch, make):
    backend = get_backend("gpu", device="cpu")

    def broken(messages):
        raise make()

    monkeypatch.setattr(backend, "blake2b256_batch", broken)


@pytest.mark.parametrize("fault", sorted(_faults()))
def test_device_fault_stays_pending_and_replays(tmp_path, both_worlds, monkeypatch, fault):
    pkg = _pkg("port", both_worlds)
    svc = _service(pkg)
    d = _durable(pkg, svc, tmp_path)
    try:
        bundle = d.submit("generate", 1, idempotency_key="g")[1]["result"]["bundle"]
        with monkeypatch.context() as m:
            _break_backend(m, _faults()[fault])
            with pytest.raises(RuntimeError) as info:
                d.submit("verify", bundle, idempotency_key="v")
            assert type(info.value) is type(_faults()[fault]())
        # admitted, never finished: no done record, nothing cached
        assert [(r["t"], r["key"]) for r in _records(pkg, tmp_path)] == [
            ("admit", "g"), ("done", "g"), ("admit", "v"),
        ]
        assert "v" not in d._results
    finally:
        d.close()
        svc.drain()
    svc2 = _service(pkg)
    d2 = _durable(pkg, svc2, tmp_path)
    try:
        assert d2.resumed_jobs == 1
        _, done, cached = d2.submit("verify", bundle, idempotency_key="v")
        assert cached and done["ok"] and done["result"]["all_valid"] is True
    finally:
        d2.close()
        svc2.drain()


@pytest.mark.parametrize("fault", ["verify-lane", "cuda-runtime"])
def test_device_fault_during_replay_raises_at_open(tmp_path, both_worlds, monkeypatch, fault):
    pkg = _pkg("port", both_worlds)
    svc = _service(pkg)
    d = _durable(pkg, svc, tmp_path)
    try:
        bundle = d.submit("generate", 1, idempotency_key="g")[1]["result"]["bundle"]
    finally:
        d.close()
    w = port_journal.JournalWriter(str(tmp_path / "queue.bin"))
    w.append({"t": "admit", "key": "v", "kind": "verify", "payload": bundle})
    w.close()
    before = (tmp_path / "queue.bin").read_bytes()
    try:
        with monkeypatch.context() as m:
            _break_backend(m, _faults()[fault])
            with pytest.raises(RuntimeError, match="lane fault|CUDA error"):
                _durable(pkg, svc, tmp_path)
    finally:
        svc.drain()
    assert (tmp_path / "queue.bin").read_bytes() == before  # nothing journaled


def test_semantic_runtime_error_is_still_the_requests_result(tmp_path, both_worlds, monkeypatch):
    """A `RuntimeError` that is no device fault keeps the reference's
    contract: journaled as the request's error, served cached."""
    pkg = _pkg("port", both_worlds)
    svc = _service(pkg)
    d = _durable(pkg, svc, tmp_path)
    try:
        bundle = d.submit("generate", 1, idempotency_key="g")[1]["result"]["bundle"]
        with monkeypatch.context() as m:
            _break_backend(m, lambda: RuntimeError("not a device fault"))
            _, done, cached = d.submit("verify", bundle, idempotency_key="v")
        assert not done["ok"] and "not a device fault" in done["error"] and not cached
        assert d.submit("verify", bundle, idempotency_key="v")[2] is True
    finally:
        d.close()
        svc.drain()


@pytest.mark.parametrize("fault", ["verify-lane", "cuda-runtime"])
def test_http_device_fault_is_500_and_stays_pending(tmp_path, both_worlds, monkeypatch, fault):
    pkg = _pkg("port", both_worlds)
    svc = _service(pkg)
    d = _durable(pkg, svc, tmp_path)
    httpd = pkg.serve.ProofHTTPServer(svc, pairs=pkg.world[1], durable=d).start()
    try:
        _, _, gen = post(httpd.port, "/v1/generate", {"pair_index": 1})
        with monkeypatch.context() as m:
            _break_backend(m, _faults()[fault])
            status, _, body = post(httpd.port, "/v1/verify", {"bundle": gen["result"]["bundle"], "idempotency_key": "v"})
        assert status == 500 and body["error_type"] == "device"
        assert [r["t"] for r in _records(pkg, tmp_path) if r["key"] == "v"] == ["admit"]
    finally:
        httpd.shutdown(timeout=30)
