"""The port's segment replication (`storex/replica.py`, the segment store's
replication surface, the tier's read-repair) against the JAX package's.

Every case of the reference's ``tests/test_replica.py`` runs with the port's
client, sets and stores, against a shard of either package (``peer`` = a
port daemon on ``device="cpu"`` or a reference daemon): segment files
travel both ways byte for byte, blocks a port store ingested from a
reference shard are multihash-checked on read (a batch read in one lane
call), a corrupt local frame repairs from a peer of either package before
the inner store is asked, and a rebalance journal is frame-equal to the
reference's and resumes to the same placement after a SIGKILL at every
append boundary.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

jax = pytest.importorskip("jax")

import ipc_proofs_tpu.storex as ref_storex  # noqa: E402
import ipc_proofs_tpu_torch.ops.verify as verify_mod  # noqa: E402
from ipc_proofs_tpu.core.cid import CID as RefCID  # noqa: E402
from ipc_proofs_tpu.jobs.journal import read_journal as ref_read_journal  # noqa: E402
from ipc_proofs_tpu_torch.backend import get_backend  # noqa: E402
from ipc_proofs_tpu_torch.core.cid import CID  # noqa: E402
from ipc_proofs_tpu_torch.jobs.journal import read_journal  # noqa: E402
from ipc_proofs_tpu_torch.storex import (  # noqa: E402
    RebalanceJob,
    ReplicaClient,
    ReplicaError,
    ReplicaSet,
    Replicator,
    SegmentStore,
    SegmentStoreError,
    TieredBlockstore,
)
from ipc_proofs_tpu_torch.utils.metrics import Metrics  # noqa: E402

from _torch_http import port_server, post, ref_server, worlds  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CPU = get_backend("gpu", device="cpu")
PEERS = ("port", "ref")


def _block(i: int):
    data = (b"replica-%04d-" % i) * (i + 2)
    return CID.hash_of(data), data


def _flip_last_byte(path: str) -> None:
    size = os.path.getsize(path)
    with open(path, "r+b") as fh:
        fh.seek(size - 1)
        b = fh.read(1)
        fh.seek(size - 1)
        fh.write(bytes([b[0] ^ 0x40]))


class _CountingInner:
    """The Lotus stand-in: a read-repair that touches it is the bug."""

    def __init__(self, mapping=None):
        self.mapping = dict(mapping or {})
        self.gets = 0

    def get(self, cid):
        self.gets += 1
        return self.mapping.get(cid)

    def put_keyed(self, cid, data):
        self.mapping[cid] = bytes(data)

    def has(self, cid):
        return cid in self.mapping


@pytest.fixture(scope="module")
def both_worlds():
    return worlds(2, receipts=2, events=2, match_rate=0.5, base_height=51_000)


@pytest.fixture(autouse=True)
def _no_autotune(monkeypatch):
    monkeypatch.setattr(verify_mod, "autotune_crossover", lambda store_dir, **kw: None)


def _shard(peer, both_worlds, store_dir, owner, seg_max=1):
    """One daemon of package ``peer`` exposing the replication routes over a
    private disk tier (1-byte roll threshold: every put rolls a segment)."""
    port_world, ref_world = both_worlds
    cfg = dict(max_batch=4, max_wait_ms=5.0, workers=1, store_dir=str(store_dir), store_owner=owner,
               store_segment_max_bytes=seg_max)
    httpd = port_server(port_world, **cfg) if peer == "port" else ref_server(ref_world, **cfg)
    return httpd, httpd.service


def _put(svc, cid, data):
    """Put through the daemon's own disk tier (either package's CID type)."""
    if isinstance(svc.disk_store, ref_storex.SegmentStore):
        cid = RefCID.parse(str(cid))
    return svc.disk_store.put(cid, data)


def _url(httpd):
    return f"http://127.0.0.1:{httpd.port}"


# --------------------------------------------------------------------------
# the segment store's replication surface
# --------------------------------------------------------------------------


def test_segment_inventory_and_paths_equal_reference(tmp_path):
    port = SegmentStore(str(tmp_path / "p"), owner="a", segment_max_bytes=1, backend=CPU)
    ref = ref_storex.SegmentStore(str(tmp_path / "r"), owner="a", segment_max_bytes=1)
    try:
        for i in range(3):
            cid, data = _block(i)
            assert port.put(cid, data) and ref.put(RefCID.parse(str(cid)), data)
        assert port.segment_files() == ref.segment_files()
        for seg in port.segment_files():
            a, b = port.segment_path(seg["name"]), ref.segment_path(seg["name"])
            assert Path(a).read_bytes() == Path(b).read_bytes()
        for bad in ("../x", "nope", "seg-zz.00000009.blk", "seg-a.00000001.blk/../../etc"):
            assert port.segment_path(bad) is None and ref.segment_path(bad) is None
    finally:
        port.close()
        ref.close()


def test_get2_reasons_and_integrity_eviction(tmp_path):
    m = Metrics()
    store = SegmentStore(str(tmp_path), segment_max_bytes=1, metrics=m, backend=CPU)
    try:
        good, bad = _block(1), _block(2)
        for cid, data in (good, bad):
            store.put(cid, data)
        assert store.get2(good[0]) == (good[1], "hit")
        assert store.get2(_block(3)[0]) == (None, "miss")
        seg = [s["name"] for s in store.segment_files() if s["size"]][1]  # the second put's segment
        _flip_last_byte(store.segment_path(seg))
        assert store.get2(bad[0]) == (None, "corrupt")
        assert store.get2(bad[0]) == (None, "miss")  # evicted: the next read is a plain miss
        assert store.get(good[0]) == good[1]
        assert m.snapshot()["counters"]["storex.integrity_evictions"] == 1
    finally:
        store.close()


def test_ingest_refuses_own_owner_and_bad_names(tmp_path):
    store = SegmentStore(str(tmp_path), owner="b", backend=CPU)
    try:
        with pytest.raises(SegmentStoreError):
            store.ingest_segment_file("seg-b.00000001.blk", b"")
        with pytest.raises(SegmentStoreError):
            store.ingest_segment_file("../evil", b"")
    finally:
        store.close()


def test_ingested_blocks_checked_on_read_in_one_lane_call(tmp_path, monkeypatch):
    """An ingest CRC-scans only; the multihash half is checked when a block
    is read. A batch read is one `verify_blocks_batch` call on the backend,
    which rejects a frame whose CRC is sound but whose bytes lie."""
    monkeypatch.setenv("IPC_VERIFY_MIN_BYTES", "0")
    src = ref_storex.SegmentStore(str(tmp_path / "src"), owner="a", segment_max_bytes=1)
    blocks = [_block(i) for i in range(5)]
    liar_cid = _block(99)[0]
    for cid, data in blocks:
        src.put(RefCID.parse(str(cid)), data)
    src.put(RefCID.parse(str(liar_cid)), b"these bytes hash to something else")
    files = {s["name"]: Path(src.segment_path(s["name"])).read_bytes() for s in src.segment_files()}
    src.close()
    m = Metrics()
    calls = []
    real = verify_mod.verify_blocks_batch

    def counted(*args, **kw):
        calls.append(len(args[0]))
        return real(*args, **kw)

    store = SegmentStore(str(tmp_path / "dst"), owner="b", metrics=m, backend=CPU)
    try:
        import ipc_proofs_tpu_torch.storex.segments as seg_mod

        monkeypatch.setattr(seg_mod, "verify_blocks_batch", counted)
        assert sum(store.ingest_segment_file(name, raw) for name, raw in sorted(files.items())) == 6
        got = store.get_many([cid for cid, _ in blocks] + [liar_cid])
        assert got == dict(blocks)
        assert calls == [6]
        assert m.snapshot()["counters"]["verify.device_blocks"] == 6
        assert m.snapshot()["counters"]["storex.integrity_evictions"] == 1
    finally:
        store.close()


def test_drop_segment_never_drops_the_active_tail(tmp_path):
    store = SegmentStore(str(tmp_path), owner="a", segment_max_bytes=1 << 20, backend=CPU)
    try:
        cid, data = _block(1)
        store.put(cid, data)
        (active,) = store.segment_files()
        assert active["active"] and not store.drop_segment(active["name"])
        assert not store.drop_segment("seg-a.99999999.blk")
        assert store.get(cid) == data
    finally:
        store.close()


# --------------------------------------------------------------------------
# the reference's TestReplicaClient, against a shard of either package
# --------------------------------------------------------------------------


@pytest.mark.parametrize("source,dest", [(a, b) for a in PEERS for b in PEERS])
def test_segment_and_block_round_trip(both_worlds, tmp_path, source, dest):
    httpd_a, svc_a = _shard(source, both_worlds, tmp_path / "a", "a")
    httpd_b, svc_b = _shard(dest, both_worlds, tmp_path / "b", "b")
    try:
        blocks = [_block(i) for i in range(3)]
        for cid, data in blocks:
            _put(svc_a, cid, data)
        client_a = ReplicaClient("a", _url(httpd_a))
        rolled = [s for s in client_a.list_segments() if not s["active"]]
        assert len(rolled) == 3 and all(s["owner"] == "a" for s in rolled)
        name = rolled[0]["name"]
        raw = client_a.fetch_segment(name)
        assert raw == Path(svc_a.disk_store.segment_path(name)).read_bytes()
        client_b = ReplicaClient("b", _url(httpd_b))
        assert client_b.push_segment(name, raw) == {"segment": name, "blocks": 1}
        assert client_b.push_segment(name, raw) == {"segment": name, "blocks": 0}
        cid0, data0 = blocks[0]
        assert client_b.fetch_block(cid0) == data0
        assert client_a.fetch_block(cid0) == data0
        assert client_a.fetch_block(_block(999)[0]) is None
        with pytest.raises(ReplicaError):
            client_b.push_segment("seg-b.00000001.blk", raw)  # its own owner token: 400
    finally:
        httpd_a.shutdown(timeout=30)
        httpd_b.shutdown(timeout=30)


@pytest.mark.parametrize("peer", PEERS)
def test_active_tail_is_listed_but_never_pulled(both_worlds, tmp_path, peer):
    httpd, svc = _shard(peer, both_worlds, tmp_path / "a", "a", seg_max=1 << 20)
    try:
        cid, data = _block(1)
        _put(svc, cid, data)
        client = ReplicaClient("a", _url(httpd))
        segs = client.list_segments()
        assert [s["active"] for s in segs] == [True]
        assert len(client.fetch_segment(segs[0]["name"])) > 0
        local = SegmentStore(str(tmp_path / "b"), owner="b", backend=CPU)
        try:
            assert Replicator(local).sync_from(client)["pulled"] == 0
            assert local.get(cid) is None
        finally:
            local.close()
    finally:
        httpd.shutdown(timeout=30)


def test_unreachable_peer_is_typed():
    client = ReplicaClient("ghost", "http://127.0.0.1:1", timeout_s=0.5)
    with pytest.raises(ReplicaError):
        client.list_segments()
    assert isinstance(ReplicaError("x"), OSError)


# --------------------------------------------------------------------------
# the reference's TestReadRepair
# --------------------------------------------------------------------------


def _corrupt_local(tmp_path, m, cid, data):
    local = SegmentStore(str(tmp_path / "local"), metrics=m, backend=CPU)
    local.put(cid, data)
    seg = [d["name"] for d in local.segment_files()][0]
    _flip_last_byte(os.path.join(str(tmp_path / "local"), seg))
    return local


@pytest.mark.parametrize("peer", PEERS)
def test_corrupt_frame_repairs_from_replica_not_inner(both_worlds, tmp_path, peer):
    httpd, svc = _shard(peer, both_worlds, tmp_path / "peer", "peer")
    try:
        cid, data = _block(7)
        _put(svc, cid, data)
        m = Metrics()
        local = _corrupt_local(tmp_path, m, cid, data)
        try:
            inner = _CountingInner()
            tiered = TieredBlockstore(
                inner, local, metrics=m,
                replicas=ReplicaSet([ReplicaClient("peer", _url(httpd))], metrics=m),
            )
            assert tiered.get(cid) == data and inner.gets == 0
            counters = m.snapshot()["counters"]
            assert counters["storex.integrity_evictions"] == 1
            assert counters["storex.replica_repairs"] == 1
            assert "storex.replica_repair_misses" not in counters
            inner2 = _CountingInner()
            assert TieredBlockstore(inner2, local, metrics=m).get(cid) == data
            assert inner2.gets == 0
        finally:
            local.close()
    finally:
        httpd.shutdown(timeout=30)


@pytest.mark.parametrize("peer", PEERS)
def test_repair_miss_falls_back_to_inner(both_worlds, tmp_path, peer):
    httpd, _svc = _shard(peer, both_worlds, tmp_path / "peer", "peer")
    try:
        cid, data = _block(9)
        m = Metrics()
        local = _corrupt_local(tmp_path, m, cid, data)
        try:
            inner = _CountingInner({cid: data})
            tiered = TieredBlockstore(
                inner, local, metrics=m,
                replicas=ReplicaSet([ReplicaClient("peer", _url(httpd))], metrics=m),
            )
            assert tiered.get(cid) == data and inner.gets == 1
            counters = m.snapshot()["counters"]
            assert counters["storex.replica_repair_misses"] == 1
            assert "storex.replica_repairs" not in counters
        finally:
            local.close()
    finally:
        httpd.shutdown(timeout=30)


def test_lying_replica_is_a_miss():
    class _Liar(ReplicaClient):
        def fetch_block(self, cid):
            return b"not the bytes you wanted"

    m = Metrics()
    rs = ReplicaSet([_Liar("liar", "http://127.0.0.1:1")], metrics=m)
    assert rs.repair(_block(3)[0]) is None
    counters = m.snapshot()["counters"]
    assert counters["storex.replica_repair_misses"] == 1
    assert "storex.replica_repairs" not in counters


def test_plain_miss_never_consults_replicas(tmp_path):
    calls = []

    class _Recorder(ReplicaClient):
        def fetch_block(self, cid):
            calls.append(cid)
            return None

    m = Metrics()
    local = SegmentStore(str(tmp_path / "local"), metrics=m, backend=CPU)
    try:
        cid, data = _block(5)
        inner = _CountingInner({cid: data})
        tiered = TieredBlockstore(
            inner, local, metrics=m, replicas=ReplicaSet([_Recorder("peer", "http://127.0.0.1:1")], metrics=m)
        )
        assert tiered.get(cid) == data and inner.gets == 1 and calls == []
    finally:
        local.close()


def test_set_replicas_arrives_late(tmp_path):
    m = Metrics()
    cid, data = _block(4)
    local = _corrupt_local(tmp_path, m, cid, data)
    try:
        class _Peer(ReplicaClient):
            def fetch_block(self, want):
                return data if want == cid else None

        inner = _CountingInner({cid: data})
        tiered = TieredBlockstore(inner, local, metrics=m)
        tiered.set_replicas(ReplicaSet([_Peer("p", "http://127.0.0.1:1")], metrics=m))
        assert tiered.get(cid) == data and inner.gets == 0
    finally:
        local.close()


# --------------------------------------------------------------------------
# the reference's TestReplicatorSync, both directions
# --------------------------------------------------------------------------


@pytest.mark.parametrize("peer", PEERS)
def test_pull_sync_rolled_foreign_segments(both_worlds, tmp_path, peer):
    httpd, svc = _shard(peer, both_worlds, tmp_path / "a", "a")
    try:
        blocks = [_block(i) for i in range(4)]
        for cid, data in blocks:
            _put(svc, cid, data)
        client = ReplicaClient("a", _url(httpd))
        m = Metrics()
        local = SegmentStore(str(tmp_path / "b"), owner="b", metrics=m, backend=CPU)
        try:
            r = Replicator(local, metrics=m).sync_from(client)
            assert r == {"pulled": 4, "bytes": r["bytes"], "blocks": 4, "pending": 0} and r["bytes"] > 0
            for cid, data in blocks:
                assert local.get(cid) == data
            for seg in local.segment_files():
                theirs = svc.disk_store.segment_path(seg["name"])
                assert Path(local.segment_path(seg["name"])).read_bytes() == Path(theirs).read_bytes()
            assert Replicator(local, metrics=m).sync_from(client)["pulled"] == 0
            counters = m.snapshot()["counters"]
            assert counters["storex.replica_segments_pulled"] == 4
            assert counters["storex.replica_bytes_pulled"] == r["bytes"]
        finally:
            local.close()
    finally:
        httpd.shutdown(timeout=30)


@pytest.mark.parametrize("peer", PEERS)
def test_owner_filter_and_own_segments_skipped(both_worlds, tmp_path, peer):
    httpd, svc = _shard(peer, both_worlds, tmp_path / "a", "a")
    try:
        cid, data = _block(1)
        _put(svc, cid, data)
        client = ReplicaClient("a", _url(httpd))
        other = SegmentStore(str(tmp_path / "c"), owner="c", backend=CPU)
        try:
            assert Replicator(other).sync_from(client, owners=["zzz"])["pulled"] == 0
            assert Replicator(other).sync_from(client, owners=["a"])["pulled"] == 1
        finally:
            other.close()
        mine = SegmentStore(str(tmp_path / "a2"), owner="a", backend=CPU)
        try:
            assert Replicator(mine).sync_from(client)["pulled"] == 0
        finally:
            mine.close()
    finally:
        httpd.shutdown(timeout=30)


@pytest.mark.parametrize("source,dest", [("ref", "port"), ("port", "ref")], ids=["ref-to-port", "port-to-ref"])
def test_replicate_route_between_packages(both_worlds, tmp_path, source, dest):
    """``POST /v1/replicate`` on one package's daemon pulls another
    package's segments; ``/v1/replica_peers`` installs the repair set; a
    dead source is fail-soft in the response's ``errors``."""
    httpd_s, svc_s = _shard(source, both_worlds, tmp_path / "s", "s0")
    httpd_d, svc_d = _shard(dest, both_worlds, tmp_path / "d", "s1")
    try:
        blocks = [_block(i) for i in range(3)]
        for cid, data in blocks:
            _put(svc_s, cid, data)
        sources = [{"name": "s0", "url": _url(httpd_s)}, {"name": "ghost", "url": "http://127.0.0.1:1"}]
        status, _, out = post(httpd_d.port, "/v1/replicate", {"sources": sources})
        assert status == 200 and (out["pulled"], out["blocks"], out["pending"]) == (3, 3, 0)
        assert len(out["errors"]) == 1 and "ghost" in out["errors"][0]
        status, _, again = post(httpd_d.port, "/v1/replicate", {"sources": sources[:1], "owners": ["s0"]})
        assert status == 200 and again["pulled"] == 0
        status, _, out = post(httpd_d.port, "/v1/replica_peers", {"peers": sources[:1]})
        assert (status, out) == (200, {"peers": 1})
        client = ReplicaClient("s1", _url(httpd_d))
        for cid, data in blocks:
            assert client.fetch_block(cid) == data
    finally:
        httpd_s.shutdown(timeout=30)
        httpd_d.shutdown(timeout=30)


# --------------------------------------------------------------------------
# the reference's TestRebalanceJob
# --------------------------------------------------------------------------


def _src(tmp_path, m=None, n=3):
    src = SegmentStore(str(tmp_path / "src"), owner="a", segment_max_bytes=1, metrics=m, backend=CPU)
    blocks = [_block(i) for i in range(n)]
    for cid, data in blocks:
        src.put(cid, data)
    return src, blocks


def _reader(src):
    def read_segment(name):
        return Path(src.segment_path(name)).read_bytes()

    return read_segment


def test_handoff_commits_and_source_drops_after(tmp_path):
    m = Metrics()
    src, blocks = _src(tmp_path, m)
    dest = SegmentStore(str(tmp_path / "dest"), owner="b", metrics=m, backend=CPU)
    try:
        segments = [d["name"] for d in src.segment_files() if not d["active"]]
        assert len(segments) == 3
        journal = str(tmp_path / "rebalance.journal")
        job = RebalanceJob(journal, "dest", segments, dest.ingest_segment_file, _reader(src), metrics=m)
        assert job.run() is True and job.committed
        records, _off, torn = read_journal(journal)
        assert not torn
        assert [r["kind"] for r in records] == ["plan"] + ["pushed"] * 3 + ["commit"]
        assert ref_read_journal(journal)[0] == records  # the reference reads the port's journal
        counters = m.snapshot()["counters"]
        assert counters["storex.rebalance_segments_pushed"] == 3
        assert "storex.rebalance_resumes" not in counters
        for name in segments:
            assert src.drop_segment(name)
        for cid, data in blocks:
            assert src.get(cid) is None and dest.get(cid) == data
        assert RebalanceJob(journal, "dest", segments, dest.ingest_segment_file, _reader(src)).run() is True
    finally:
        src.close()
        dest.close()


def test_resume_skips_pushed_prefix(tmp_path):
    src, _blocks = _src(tmp_path)
    try:
        segments = [d["name"] for d in src.segment_files() if not d["active"]]
        pushed = {}

        def flaky_push(name, data):
            if pushed:
                raise ReplicaError("dest went away")
            pushed[name] = data

        journal = str(tmp_path / "rebalance.journal")
        with pytest.raises(ReplicaError):
            RebalanceJob(journal, "dest", segments, flaky_push, _reader(src)).run()
        assert len(pushed) == 1
        m2 = Metrics()
        job = RebalanceJob(journal, "dest", segments, pushed.__setitem__, _reader(src), metrics=m2)
        assert job.run() is True and sorted(pushed) == segments
        counters = m2.snapshot()["counters"]
        assert counters["storex.rebalance_resumes"] == 1
        assert counters["storex.rebalance_segments_pushed"] == 2
    finally:
        src.close()


def test_journal_refuses_a_different_plan(tmp_path):
    src, _blocks = _src(tmp_path)
    try:
        segments = [d["name"] for d in src.segment_files() if not d["active"]]
        journal = str(tmp_path / "rebalance.journal")
        RebalanceJob(journal, "dest", segments, lambda n, d: None, _reader(src)).run()
        with pytest.raises(ReplicaError):
            RebalanceJob(journal, "other-dest", segments, lambda n, d: None, _reader(src)).run()
    finally:
        src.close()


def test_rebalance_journal_equals_reference(tmp_path):
    """The same handoff writes the same journal bytes in both packages."""
    src, _blocks = _src(tmp_path)
    try:
        segments = [d["name"] for d in src.segment_files() if not d["active"]]
        paths = {}
        for name, cls in (("port", RebalanceJob), ("ref", ref_storex.RebalanceJob)):
            paths[name] = tmp_path / f"{name}.journal"
            assert cls(str(paths[name]), "dest", segments, lambda n, d: None, _reader(src)).run()
        assert paths["port"].read_bytes() == paths["ref"].read_bytes()
    finally:
        src.close()


_KILL_CHILD = """
import os, sys
from pathlib import Path
from ipc_proofs_tpu_torch.backend import get_backend
from ipc_proofs_tpu_torch.storex import RebalanceJob, SegmentStore
root = Path(sys.argv[1])
src = SegmentStore(str(root / "src"), owner="a", segment_max_bytes=1, backend=get_backend("gpu", device="cpu"))
dest = root / "dest"
dest.mkdir(exist_ok=True)
segments = sorted(d["name"] for d in src.segment_files() if not d["active"])
def push(name, data):
    (dest / name).write_bytes(data)
RebalanceJob(str(root / "rebalance.journal"), "dest", segments, push,
             lambda name: Path(src.segment_path(name)).read_bytes()).run()
src.close()
"""


def test_sigkill_at_every_append_resumes_to_the_same_placement(tmp_path):
    """A SIGKILL at every append boundary (plan, each push, commit) and a
    torn mid-record write: every run resumes to the same placement."""
    points = [(at, None) for at in range(5)] + [(2, 7)]
    children = []
    for i, (crash_at, torn) in enumerate(points):
        root = tmp_path / f"p{i}"
        src, _ = _src(root)
        src.close()
        env = dict(os.environ, PYTHONPATH=str(ROOT), IPC_JOURNAL_CRASH_AT=str(crash_at))
        if torn is not None:
            env["IPC_JOURNAL_CRASH_TORN"] = str(torn)
        children.append((root, subprocess.Popen([sys.executable, "-c", _KILL_CHILD, str(root)], env=env,
                                                stdout=subprocess.PIPE, stderr=subprocess.PIPE)))
    for root, child in children:
        _, err = child.communicate(timeout=120)
        assert child.returncode == -9, err.decode()[-2000:]
        src = SegmentStore(str(root / "src"), owner="a", segment_max_bytes=1, backend=CPU)
        try:
            segments = sorted(d["name"] for d in src.segment_files() if not d["active"])
            placed = {}
            job = RebalanceJob(str(root / "rebalance.journal"), "dest", segments, placed.__setitem__, _reader(src))
            assert job.run() is True
            files = {p.name: p.read_bytes() for p in (root / "dest").iterdir()} if (root / "dest").exists() else {}
            files.update(placed)
            assert sorted(files) == segments
            assert all(files[n] == _reader(src)(n) for n in segments)
            records, _, torn = read_journal(str(root / "rebalance.journal"))
            assert not torn and records[-1] == {"kind": "commit"}
        finally:
            src.close()
