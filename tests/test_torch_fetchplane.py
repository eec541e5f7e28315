"""The port's fetch plane (`store/fetchplane.py`) over its Lotus client,
and bundles read through it against the JAX package's.

- the plane's own tests, as the reference's `tests/test_fetchplane.py`
  states them (speculation accounting, verify-before-use, the tier
  short-circuit, coalescing, close, the facade, the prefetch reroute),
  plus `prime`, adaptive depth and the batch-verify wiring;
- the bit-identity grid: the chunked driver at speculate depth 0/1/2 ×
  chunk 3/8, the pipelined driver, a no-batch endpoint — every port bundle
  equals the reference's in-memory bundle's ``to_json()``, byte for byte;
- seeded chaos in batched mode: a faulted run gives the reference's bytes
  or a typed error, and every flipped block is caught.

Every plane here is built with lockdep on (``IPC_LOCKDEP=1`` semantics):
the dispatcher threads, the pipelined driver's workers and the batch
verify all take tracked locks, and an observed order inversion raises.
"""

import random
import threading
import time

import pytest

jax = pytest.importorskip("jax")

from ipc_proofs_tpu.fixtures import build_range_world as ref_build_range_world  # noqa: E402
from ipc_proofs_tpu.proofs.generator import EventProofSpec as RefSpec  # noqa: E402
from ipc_proofs_tpu.proofs.range import generate_event_proofs_for_range as ref_generate  # noqa: E402
from ipc_proofs_tpu_torch.backend import get_backend  # noqa: E402
from ipc_proofs_tpu_torch.core.cid import CID  # noqa: E402
from ipc_proofs_tpu_torch.core.dagcbor import encode as dagcbor_encode  # noqa: E402
from ipc_proofs_tpu_torch.fixtures import build_range_world  # noqa: E402
from ipc_proofs_tpu_torch.proofs.generator import EventProofSpec  # noqa: E402
from ipc_proofs_tpu_torch.proofs.range import (  # noqa: E402
    generate_event_proofs_for_range_chunked,
    generate_event_proofs_for_range_pipelined,
)
from ipc_proofs_tpu_torch.store.blockstore import MemoryBlockstore  # noqa: E402
from ipc_proofs_tpu_torch.store.faults import FaultPlan, FaultySession, LocalLotusSession  # noqa: E402
from ipc_proofs_tpu_torch.store.fetchplane import FetchPlane, PlaneBlockstore, _child_links  # noqa: E402
from ipc_proofs_tpu_torch.store.rpc import (  # noqa: E402
    IntegrityError,
    LotusClient,
    RpcBlockstore,
    RpcError,
)
from ipc_proofs_tpu_torch.storex import SegmentStore, TieredBlockstore  # noqa: E402
from ipc_proofs_tpu_torch.utils import lockdep  # noqa: E402
from ipc_proofs_tpu_torch.utils.metrics import Metrics  # noqa: E402

SIG = "NewTopDownMessage(bytes32,uint256)"
SUBNET = "calib-subnet-1"
ACTOR = 1001
CPU = get_backend("gpu", device="cpu")

# errors the batched stack may surface under faults; anything else escaping
# is a finding
TYPED_ERRORS = (IntegrityError, RpcError, RuntimeError, ConnectionError, TimeoutError, OSError)


@pytest.fixture(autouse=True)
def _lockdep_on():
    lockdep.enable(strict=True)
    lockdep.reset()
    try:
        yield
    finally:
        lockdep.disable()
    assert not lockdep.violations()


def _blocks(n: int, tag: bytes = b"blk") -> "list[tuple[CID, bytes]]":
    out = []
    for i in range(n):
        data = (tag + b"-%04d-" % i) * (i % 5 + 2)
        out.append((CID.hash_of(data), data))
    return out


def _store_with(blocks) -> MemoryBlockstore:
    bs = MemoryBlockstore()
    for cid, data in blocks:
        bs.put_keyed(cid, data)
    return bs


def _client(bs, metrics=None, **kw):
    return LotusClient(
        "http://fetchplane-test", session=LocalLotusSession(bs, **kw), metrics=metrics or Metrics(),
    )


def _wait_until(cond, timeout_s: float = 5.0) -> bool:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.005)
    return cond()


@pytest.fixture(scope="module")
def world():
    kw = dict(signature=SIG, topic1=SUBNET, actor_id=ACTOR)
    bs, pairs, _ = build_range_world(6, 4, 2, 0.2, **kw)
    ref_bs, ref_pairs, _ = ref_build_range_world(6, 4, 2, 0.2, **kw)
    reference = ref_generate(ref_bs, ref_pairs, RefSpec(SIG, SUBNET, ACTOR)).to_json()
    return bs, pairs, EventProofSpec(SIG, SUBNET, ACTOR), reference


# ---------------------------------------------------------------------------
# the fetch plane itself


class TestFetchPlane:
    def test_demand_gets_are_correct_and_batched(self):
        blocks = _blocks(10)
        bs = _store_with(blocks)
        m = Metrics()
        with FetchPlane(_client(bs, m), local={}, metrics=m, backend=CPU) as plane:
            into: dict = {}
            fails = plane.fetch_into([c for c, _ in blocks], into)
            assert fails == {}
            assert into == dict(blocks)
            # a second demand hits the local tier, no new RPC
            calls_before = m.snapshot()["counters"]["rpc.calls"]
            assert plane.get(blocks[0][0]) == blocks[0][1]
            assert m.snapshot()["counters"]["rpc.calls"] == calls_before
        counters = m.snapshot()["counters"]
        assert counters["fetch.batches"] >= 1
        assert counters["fetch.batched_blocks"] == 10

    def test_tier_short_circuit_never_touches_rpc(self):
        blocks = _blocks(3)
        bs = _store_with(blocks)
        client = _client(bs)
        with FetchPlane(client, local=dict(blocks), backend=CPU) as plane:
            for cid, data in blocks:
                assert plane.get(cid) == data
        assert client._session.calls == 0

    def test_speculation_lands_and_demand_consumes(self):
        blocks = _blocks(6, tag=b"spec")
        bs = _store_with(blocks)
        m = Metrics()
        with FetchPlane(_client(bs, m), local={}, speculate_depth=1, metrics=m, backend=CPU) as plane:
            plane.offer_links([c for c, _ in blocks])
            assert _wait_until(
                lambda: plane.stats()["speculative_fetched"]
                + m.snapshot()["counters"].get("fetch.speculative_used", 0) >= 6
            )
            for cid, data in blocks:
                assert plane.get(cid) == data
            stats = plane.stats()
            # every speculative fetch was consumed — whether via promotion,
            # landing, or a tier hit on the landed block
            assert stats["waste_pct"] == 0.0
            assert stats["in_flight"] == 0
        assert m.snapshot()["counters"].get("fetch.speculative_wasted", 0) == 0

    def test_mis_speculation_is_counted_never_raised(self):
        blocks = _blocks(5, tag=b"waste")
        bs = _store_with(blocks)
        m = Metrics()
        plane = FetchPlane(_client(bs, m), local={}, speculate_depth=1, metrics=m, backend=CPU)
        plane.speculate([c for c, _ in blocks])
        assert _wait_until(lambda: plane.stats()["speculative_fetched"] == 5)
        plane.close()
        stats = plane.stats()
        assert stats["speculative_wasted"] == 5
        assert stats["waste_pct"] == 100.0
        assert m.snapshot()["counters"]["fetch.speculative_wasted"] == 5

    def test_speculate_depth_zero_disables_offers(self):
        blocks = _blocks(4)
        bs = _store_with(blocks)
        client = _client(bs)
        with FetchPlane(client, local={}, speculate_depth=0, backend=CPU) as plane:
            plane.offer_links([c for c, _ in blocks])
            time.sleep(0.05)
            assert plane.stats()["speculative_fetched"] == 0
        assert client._session.calls == 0

    def test_plane_chases_links_to_speculate_depth(self):
        # root -> {a, b} -> c: at depth 2 the plane fetches root, a and b
        # on its own, but never chases into c (depth 3)
        leaf_c = dagcbor_encode({"leaf": "c"})
        cid_c = CID.hash_of(leaf_c)
        node_a = dagcbor_encode([cid_c])
        cid_a = CID.hash_of(node_a)
        node_b = dagcbor_encode({"x": 1})
        cid_b = CID.hash_of(node_b)
        root = dagcbor_encode({"kids": [cid_a, cid_b]})
        cid_root = CID.hash_of(root)
        bs = _store_with([])
        for cid, data in ((cid_c, leaf_c), (cid_a, node_a), (cid_b, node_b), (cid_root, root)):
            bs.put_keyed(cid, data)
        assert _child_links(root) == [cid_a, cid_b]
        local: dict = {}
        plane = FetchPlane(_client(bs), local=local, speculate_depth=2, backend=CPU)
        plane.speculate([cid_root])
        assert _wait_until(lambda: plane.stats()["speculative_fetched"] == 3)
        plane.close()
        assert cid_root in local and cid_a in local and cid_b in local
        assert cid_c not in local  # depth 3 is past the budget

    def test_speculative_integrity_failure_discards_then_demand_raises(self):
        # a lying endpoint serves corrupt bytes: the speculative copy is
        # discarded before anything observes it; the demand refetch gets
        # the same lie and raises the typed IntegrityError
        good = b"honest block bytes"
        cid = CID.hash_of(good)
        bs = MemoryBlockstore()
        bs.put_keyed(cid, b"corrupt " + good)
        m = Metrics()
        plane = FetchPlane(_client(bs, m), local={}, speculate_depth=1, metrics=m, backend=CPU)
        plane.speculate([cid])
        assert _wait_until(
            lambda: m.snapshot()["counters"].get(
                "fetch.speculative_integrity_drops", 0
            ) == 1
        )
        with pytest.raises(IntegrityError):
            plane.get(cid)
        plane.close()
        counters = m.snapshot()["counters"]
        assert counters["fetch.speculative_integrity_drops"] == 1
        assert counters["rpc.integrity_failures"] >= 1

    def test_demand_on_inflight_failed_speculation_raises_not_hangs(self):
        # THE coalesce race: a demand get attaches to a speculative want
        # that has already drained into a dispatcher batch; the fetch then
        # fails verification. The waiter must get the typed IntegrityError
        # via a demand-lane rerun — never wait forever on a want the plane
        # silently forgot.
        good = b"honest bytes for the in-flight race"
        cid = CID.hash_of(good)
        bs = MemoryBlockstore()
        bs.put_keyed(cid, b"corrupt " + good)  # the endpoint always lies
        m = Metrics()
        inner = _client(bs, m)
        gate = threading.Event()
        entered = threading.Event()

        class _GatedClient:
            verifies_integrity = False
            endpoint = "http://gated"

            def chain_read_obj_many(self, cids):
                entered.set()
                assert gate.wait(5.0)
                return inner.chain_read_obj_many(cids)

            def chain_read_obj(self, c):
                return inner.chain_read_obj(c)

        plane = FetchPlane(
            _GatedClient(), local={}, speculate_depth=1, workers=1, metrics=m, backend=CPU,
        )
        try:
            plane.speculate([cid])
            assert entered.wait(5.0)  # the speculative fetch is in flight
            outcome: list = []

            def _demand():
                try:
                    outcome.append(plane.get(cid))
                except Exception as exc:
                    outcome.append(exc)

            t = threading.Thread(target=_demand)
            t.start()
            time.sleep(0.05)  # let the demand coalesce onto the want
            gate.set()
            t.join(timeout=10.0)
            assert not t.is_alive(), "demand get hung on a failed speculative want"
            assert isinstance(outcome[0], IntegrityError)
        finally:
            gate.set()
            plane.close()

    def test_transient_failure_during_coalesced_speculation_recovers(self):
        # same race, transient flavor: the in-flight speculative batch dies
        # with a transport error while a demand waiter is attached. The
        # want re-lanes to demand and the retry delivers the actual bytes —
        # not None (which would read as "block absent") and not a hang.
        blocks = _blocks(1, tag=b"tr")
        cid, data = blocks[0]
        bs = _store_with(blocks)
        m = Metrics()
        inner = _client(bs, m)
        gate = threading.Event()
        entered = threading.Event()
        fail_state = {"batch": True, "scalar": 1}

        class _FlakyGatedClient:
            verifies_integrity = False
            endpoint = "http://flaky-gated"

            def chain_read_obj_many(self, cids):
                entered.set()
                assert gate.wait(5.0)
                if fail_state["batch"]:
                    fail_state["batch"] = False
                    raise ConnectionError("injected batch outage")
                return inner.chain_read_obj_many(cids)

            def chain_read_obj(self, c):
                if fail_state["scalar"] > 0:
                    fail_state["scalar"] -= 1
                    raise ConnectionError("injected scalar outage")
                return inner.chain_read_obj(c)

        plane = FetchPlane(
            _FlakyGatedClient(), local={}, speculate_depth=1, workers=1, metrics=m, backend=CPU,
        )
        try:
            plane.speculate([cid])
            assert entered.wait(5.0)
            outcome: list = []

            def _demand():
                try:
                    outcome.append(plane.get(cid))
                except Exception as exc:
                    outcome.append(exc)

            t = threading.Thread(target=_demand)
            t.start()
            time.sleep(0.05)
            gate.set()
            t.join(timeout=10.0)
            assert not t.is_alive(), "demand get hung after transient batch failure"
            assert outcome[0] == data
        finally:
            gate.set()
            plane.close()

    def test_demand_integrity_failure_is_typed(self):
        good = b"another honest block"
        cid = CID.hash_of(good)
        bs = MemoryBlockstore()
        bs.put_keyed(cid, good + b" tampered")
        with FetchPlane(_client(bs), local={}, backend=CPU) as plane:
            with pytest.raises(IntegrityError):
                plane.get(cid)

    def test_concurrent_demands_coalesce_into_batches(self):
        blocks = _blocks(32, tag=b"conc")
        bs = _store_with(blocks)
        m = Metrics()
        plane = FetchPlane(_client(bs, m), local={}, batch_max=64, metrics=m, backend=CPU)
        results: dict = {}
        errors: list = []

        def _worker(chunk):
            try:
                for cid, data in chunk:
                    results[cid] = plane.get(cid) == data
            except Exception as exc:  # pragma: no cover - surfaced below
                errors.append(exc)

        threads = [
            threading.Thread(target=_worker, args=(blocks[i::4],)) for i in range(4)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        plane.close()
        assert not errors
        assert len(results) == 32 and all(results.values())
        counters = m.snapshot()["counters"]
        # concurrent walkers rode shared round-trips: strictly fewer
        # round-trips than blocks
        assert counters["rpc.calls"] < 32

    def test_close_fails_outstanding_and_rejects_new_wants(self):
        blocks = _blocks(2)
        bs = _store_with(blocks)
        plane = FetchPlane(_client(bs), local={}, backend=CPU)
        assert plane.get(blocks[0][0]) == blocks[0][1]
        plane.close()
        with pytest.raises(RuntimeError):
            plane.get(blocks[1][0])
        plane.close()  # idempotent

    def test_plane_blockstore_facade(self):
        blocks = _blocks(3)
        bs = _store_with(blocks)
        store = PlaneBlockstore(FetchPlane(_client(bs), local={}, backend=CPU))
        try:
            assert store.get(blocks[0][0]) == blocks[0][1]
            assert store.has(blocks[1][0])
            into: dict = {}
            assert store.prefetch([c for c, _ in blocks], into) == {}
            assert into == dict(blocks)
            with pytest.raises(NotImplementedError):
                store.put_keyed(blocks[0][0], blocks[0][1])
        finally:
            store.close()



# ---------------------------------------------------------------------------
# prefetch reroute (RpcBlockstore.prefetch)


class TestPrefetchReroute:
    def test_prefetch_without_plane_ships_one_batch(self):
        blocks = _blocks(12, tag=b"pf")
        bs = _store_with(blocks)
        m = Metrics()
        store = RpcBlockstore(_client(bs, m), metrics=m)
        into: dict = {}
        assert store.prefetch([c for c, _ in blocks], into) == {}
        assert into == dict(blocks)
        counters = m.snapshot()["counters"]
        assert counters["rpc.batch_calls"] == 1  # ONE wave, not 12 calls
        assert counters["rpc.calls"] == 1

    def test_prefetch_with_attached_plane_rides_the_want_queue(self):
        blocks = _blocks(9, tag=b"pfp")
        bs = _store_with(blocks)
        m = Metrics()
        store = RpcBlockstore(_client(bs, m), metrics=m)
        plane = FetchPlane(store.client, local={}, metrics=m, backend=CPU)
        store.attach_plane(plane)
        try:
            into: dict = {}
            assert store.prefetch([c for c, _ in blocks], into) == {}
            assert into == dict(blocks)
        finally:
            plane.close()
        counters = m.snapshot()["counters"]
        assert counters["fetch.wants"] >= 9  # went through the plane
        assert counters["rpc.calls"] < 9  # and rode batched round-trips

    def test_offer_links_forwards_only_with_plane(self):
        blocks = _blocks(3, tag=b"ol")
        bs = _store_with(blocks)
        m = Metrics()
        store = RpcBlockstore(_client(bs, m), metrics=m)
        store.offer_links([c for c, _ in blocks])  # no plane: dropped, no error
        plane = FetchPlane(store.client, local={}, speculate_depth=1, metrics=m, backend=CPU)
        store.attach_plane(plane)
        try:
            store.offer_links([c for c, _ in blocks])
            assert _wait_until(lambda: plane.stats()["speculative_fetched"] == 3)
        finally:
            plane.close()




class TestPlaneExtras:
    def test_prime_is_exempt_from_the_depth_gate(self):
        blocks = _blocks(4, tag=b"prime")
        bs = _store_with(blocks)
        m = Metrics()
        local: dict = {}
        with FetchPlane(_client(bs, m), local=local, speculate_depth=0, metrics=m, backend=CPU) as plane:
            plane.offer_links([blocks[0][0]])  # gated at depth 0
            plane.prime([c for c, _ in blocks])
            assert _wait_until(lambda: len(local) == 4)
        assert m.counter_value("fetch.schedule_primed") == 4
        assert local == dict(blocks)

    def test_adaptive_depth_downshifts_on_waste(self):
        """``speculate_depth="auto"`` starts at 2 and lowers the depth once a
        window of speculative fetches is mostly wasted."""
        blocks = _blocks(20, tag=b"auto")
        bs = _store_with(blocks)
        m = Metrics()
        plane = FetchPlane(_client(bs, m), local={}, speculate_depth="auto", auto_window=8, metrics=m, backend=CPU)
        try:
            assert plane.adaptive_depth and plane.speculate_depth == FetchPlane.AUTO_START_DEPTH
            plane.speculate([c for c, _ in blocks])  # never demanded: all waste
            assert _wait_until(lambda: plane.stats()["speculative_fetched"] == 20)
            assert plane.speculate_depth < FetchPlane.AUTO_START_DEPTH
            assert m.counter_value("fetch.speculate_depth_downshifts") >= 1
        finally:
            plane.close()

    @pytest.mark.parametrize("lane", ["device", "scalar"])
    def test_landed_waves_batch_verify(self, lane, monkeypatch):
        """Every landed wave is one `verify_blocks_batch` call on the
        backend; a lying block inside a multi-block wave raises the typed
        IntegrityError on demand."""
        monkeypatch.setenv("IPC_VERIFY_MIN_BYTES", "0" if lane == "device" else "999999999")
        blocks = _blocks(12, tag=b"bv")
        bs = _store_with(blocks)
        liar = blocks[5][0]
        bs.put_keyed(liar, b"lie " + blocks[5][1])
        m = Metrics()
        plane = FetchPlane(_client(bs, m), local={}, backend=CPU, metrics=m)
        try:
            into: dict = {}
            failures = plane.fetch_into([c for c, _ in blocks], into)
        finally:
            plane.close()
        assert list(failures) == [liar] and isinstance(failures[liar], IntegrityError)
        assert into == {c: d for c, d in blocks if c != liar}
        counters = m.snapshot()["counters"]
        # one verify call per landed wave, over every block of the wave
        assert counters["verify.batch_calls"] == counters["fetch.batches"]
        assert counters["verify.batch_blocks"] == counters["fetch.batched_blocks"] >= 12
        if lane == "device":
            assert counters["verify.device_blocks"] >= 2
        else:
            assert counters.get("verify.device_calls", 0) == 0

    def test_small_waves_verify_on_the_scalar_lane(self, monkeypatch):
        """At the default crossover a wave of a few small blocks still goes
        through the lane, whose routing verifies it with hashlib."""
        monkeypatch.delenv("IPC_VERIFY_MIN_BYTES", raising=False)
        blocks = _blocks(6, tag=b"off")
        m = Metrics()
        with FetchPlane(_client(_store_with(blocks), m), local={}, metrics=m, backend=CPU) as plane:
            assert plane.fetch_into([c for c, _ in blocks], {}) == {}
        assert m.counter_value("verify.batch_calls") == m.counter_value("fetch.batches") > 0
        assert m.counter_value("verify.scalar_blocks") == m.counter_value("fetch.batched_blocks") == 6
        assert m.counter_value("verify.device_calls") == 0


# ---------------------------------------------------------------------------
# bit-identity grid: sync walker vs fetch plane × speculate-depth × chunk


def _plane(bs, m, depth, **kw):
    return FetchPlane(_client(bs, m, **kw), local={}, speculate_depth=depth, metrics=m, backend=CPU)


class TestBitIdentityGrid:
    @pytest.mark.parametrize("depth", [0, 1, 2])
    @pytest.mark.parametrize("chunk_size", [3, 8])
    def test_grid_bundles_equal_the_reference(self, world, depth, chunk_size):
        bs, pairs, spec, reference = world
        m_sync = Metrics()
        sync = generate_event_proofs_for_range_chunked(
            RpcBlockstore(_client(bs, m_sync), metrics=m_sync), pairs, spec,
            chunk_size=chunk_size, metrics=m_sync, match_backend=CPU,
        )
        assert sync.to_json() == reference
        m = Metrics()
        plane = _plane(bs, m, depth)
        try:
            got = generate_event_proofs_for_range_chunked(
                PlaneBlockstore(plane), pairs, spec, chunk_size=chunk_size, metrics=m, match_backend=CPU,
            )
        finally:
            plane.close()
        assert got.to_json() == reference
        if depth >= 1:
            # fewer round-trips than one call per block, same bytes
            assert m.counter_value("rpc.calls") < m_sync.counter_value("rpc.calls")

    @pytest.mark.parametrize("lane", ["host", "device"])
    def test_pipelined_driver_through_plane_and_tier(self, world, lane, tmp_path, monkeypatch):
        """The cold path's stack: plane (verifying each landed wave on the
        backend, at the default crossover or with every wave of two or more
        blocks forced onto the device lane) under a tier over a segment
        store; then a warm rerun from a reopened store makes no RPC call."""
        if lane == "device":
            monkeypatch.setenv("IPC_VERIFY_MIN_BYTES", "0")
        else:
            monkeypatch.delenv("IPC_VERIFY_MIN_BYTES", raising=False)
        bs, pairs, spec, reference = world
        for run in ("cold", "warm"):
            m = Metrics()
            plane = FetchPlane(_client(bs, m), speculate_depth=1, backend=CPU, metrics=m)
            seg = SegmentStore(str(tmp_path), verify_scan=(run == "warm"), backend=CPU, metrics=m)
            tier = TieredBlockstore(PlaneBlockstore(plane), seg, metrics=m)
            plane.set_local(tier)
            try:
                got = generate_event_proofs_for_range_pipelined(
                    tier, pairs, spec, chunk_size=3, metrics=m, scan_threads=2,
                    force_pipeline=True, match_backend=CPU,
                )
            finally:
                plane.close()
                seg.close()
            assert got.to_json() == reference
            if run == "cold":
                assert m.counter_value("rpc.calls") > 0
                assert m.counter_value("verify.batch_blocks") == m.counter_value("fetch.batched_blocks")
                assert (m.counter_value("verify.device_blocks") > 0) == (lane == "device")
            else:
                assert m.counter_value("rpc.calls") == 0
                assert m.counter_value("storex.integrity_evictions") == 0

    def test_no_batch_endpoint_still_equal(self, world):
        bs, pairs, spec, reference = world
        m = Metrics()
        client = _client(bs, m, batch=False)
        plane = FetchPlane(client, local={}, speculate_depth=1, metrics=m, backend=CPU)
        try:
            got = generate_event_proofs_for_range_chunked(
                PlaneBlockstore(plane), pairs, spec, chunk_size=4, metrics=m, match_backend=CPU,
            )
        finally:
            plane.close()
        assert got.to_json() == reference
        assert client.supports_batch is False
        assert m.counter_value("rpc.batch_unsupported") == 1


class _RecordingNode:
    """The node's blockstore, recording every block it serves."""

    def __init__(self, inner):
        self.inner, self.served = inner, []

    def get(self, cid):
        self.served.append(cid.to_bytes())
        return self.inner.get(cid)

    def __getattr__(self, name):
        return getattr(self.inner, name)


# a world whose receipts and events AMTs have interior nodes, so walkers
# offer links (BASELINE config 2's shape at 8 tipset pairs)
WARM_WORLD = (8, 16, 4, 0.01)


def _warm_read(package: str, store_dir: str, depth: int):
    """One chunked run of ``package``'s stack (its node, client, plane,
    tier and segment store over ``store_dir``): (bundle JSON, raw CIDs the
    node served, the plane's and client's counters)."""
    kw = dict(signature=SIG, topic1=SUBNET, actor_id=ACTOR)
    if package == "jax":
        from ipc_proofs_tpu.proofs.range import generate_event_proofs_for_range_chunked as chunked
        from ipc_proofs_tpu.store.faults import LocalLotusSession as Session
        from ipc_proofs_tpu.store.fetchplane import FetchPlane as Plane
        from ipc_proofs_tpu.store.fetchplane import PlaneBlockstore as Facade
        from ipc_proofs_tpu.store.rpc import LotusClient as Client
        from ipc_proofs_tpu.storex import SegmentStore as Disk
        from ipc_proofs_tpu.storex import TieredBlockstore as Tier
        from ipc_proofs_tpu.utils.metrics import Metrics as Counters

        bs, pairs, _ = ref_build_range_world(*WARM_WORLD, **kw)
        spec, lane, match = RefSpec(SIG, SUBNET, ACTOR), {}, {}
    else:
        chunked, Session, Plane, Facade = (
            generate_event_proofs_for_range_chunked, LocalLotusSession, FetchPlane, PlaneBlockstore,
        )
        Client, Disk, Tier, Counters = LotusClient, SegmentStore, TieredBlockstore, Metrics
        bs, pairs, _ = build_range_world(*WARM_WORLD, **kw)
        spec, lane, match = EventProofSpec(SIG, SUBNET, ACTOR), {"backend": CPU}, {"match_backend": CPU}
    m = Counters()
    node = _RecordingNode(bs)
    plane = Plane(Client("http://warm", session=Session(node), metrics=m), speculate_depth=depth, metrics=m, **lane)
    disk = Disk(store_dir, metrics=m, **lane)
    tier = Tier(Facade(plane), disk, metrics=m)
    plane.set_local(tier)
    try:
        out = chunked(tier, pairs, spec, chunk_size=3, metrics=m, **match).to_json()
        _drain(plane)
    finally:
        plane.close()
        disk.close()
    counters = m.snapshot()["counters"]
    return out, node.served, {k: v for k, v in counters.items() if k.startswith(("rpc.", "fetch."))}


def _drain(plane, timeout_s: float = 60.0) -> None:
    """Wait until ``plane`` (either package's) has fetched every want it
    queued. The walk ends as soon as its own blocks are read; closing the
    plane then drops the speculative wants its dispatchers have not taken
    yet, and how many that is follows thread scheduling, in both
    packages."""
    deadline = time.monotonic() + timeout_s
    while True:
        with plane._cond:
            if not plane._demand_q and not plane._spec_q and all(w.done for w in plane._wants.values()):
                return
        if time.monotonic() > deadline:
            raise AssertionError("the fetch plane did not drain its queued wants")
        time.sleep(0.005)


class TestWarmRestartSpeculation:
    def test_warm_speculation_fetches_what_the_reference_fetches(self, tmp_path):
        """A disk written by a run that speculated nothing (as if the cold
        plane had dropped every offered link at its queue cap) holds only
        the demanded blocks. A warm rerun at depth 0 never reaches the node;
        at depth 1 the walkers offer the links no walk reads, and the plane
        fetches them: the same blocks, and as many wants, as the reference
        plane fetches over a copy of the same directory."""
        import shutil

        ref_bs, ref_pairs, _ = ref_build_range_world(*WARM_WORLD, signature=SIG, topic1=SUBNET, actor_id=ACTOR)
        reference = ref_generate(ref_bs, ref_pairs, RefSpec(SIG, SUBNET, ACTOR)).to_json()
        cold = str(tmp_path / "cold")
        out, served, counters = _warm_read("port", cold, depth=0)
        assert out == reference and counters["rpc.calls"] > 0
        got = {}
        for package in ("port", "jax"):
            for depth in (0, 1):
                store_dir = str(tmp_path / f"{package}-{depth}")
                shutil.copytree(cold, store_dir)
                got[package, depth] = _warm_read(package, store_dir, depth)
                assert got[package, depth][0] == reference
        for package in ("port", "jax"):
            assert got[package, 0][1] == [] and got[package, 0][2] == {}
        port_served, jax_served = got["port", 1][1], got["jax", 1][1]
        assert port_served and sorted(port_served) == sorted(jax_served)
        assert not set(port_served) & set(served)  # none of them a block any walk reads
        for name in ("fetch.wants", "fetch.speculative_wants", "fetch.speculative_wasted", "rpc.batched_reads"):
            assert got["port", 1][2][name] == got["jax", 1][2][name] == len(port_served), name


# ---------------------------------------------------------------------------
# seeded chaos in batched mode


def _faulty_plane(bs, plan, m, seed, depth=1):
    client = LotusClient(
        "http://chaos", session=FaultySession(LocalLotusSession(bs), plan, sleep=lambda s: None),
        metrics=m, max_retries=3, backoff_base_s=0.0005, backoff_max_s=0.002, rng=random.Random(seed),
    )
    return FetchPlane(client, local={}, speculate_depth=depth, metrics=m, backend=CPU)


class TestChaosBatched:
    def test_identical_or_typed_error_under_faults(self, world):
        bs, pairs, spec, reference = world
        outcomes = {"identical": 0, "typed_error": 0}
        for seed in range(6):
            for rate in (0.05, 0.3):
                m = Metrics()
                plane = _faulty_plane(bs, FaultPlan(seed * 77, fault_rate=rate), m, seed,
                                      depth="auto" if seed % 2 else 1)
                try:
                    bundle = generate_event_proofs_for_range_pipelined(
                        PlaneBlockstore(plane), pairs, spec, chunk_size=3, metrics=m,
                        scan_threads=1, scan_retries=2, force_pipeline=True, match_backend=CPU,
                    )
                except TYPED_ERRORS:
                    outcomes["typed_error"] += 1
                    continue
                finally:
                    plane.close()
                # a completed run is byte-identical: a faulty wire never
                # changes what a proof says
                assert bundle.to_json() == reference, f"seed {seed} diverged"
                outcomes["identical"] += 1
        assert outcomes["identical"] > 0

    def test_every_flipped_block_is_caught(self, world, monkeypatch):
        """Bit-flip-only plans with the landed waves verified on the
        backend: a completed run has the reference's bytes, and each flip
        was counted as an integrity failure or a speculative drop."""
        monkeypatch.setenv("IPC_VERIFY_MIN_BYTES", "0")
        bs, pairs, spec, reference = world
        completed = flips = 0
        for seed in range(6):
            m = Metrics()
            # at most two lies a run: one endpoint, no failover, so each
            # demand-wave lie costs a scan retry
            plan = FaultPlan(seed * 13, fault_rate=0.2, kinds=("bitflip",), max_faults=2)
            plane = _faulty_plane(bs, plan, m, seed)
            try:
                bundle = generate_event_proofs_for_range_pipelined(
                    PlaneBlockstore(plane), pairs, spec, chunk_size=3, metrics=m,
                    scan_threads=1, scan_retries=3, force_pipeline=True, match_backend=CPU,
                )
            except IntegrityError:
                continue
            finally:
                plane.close()
            completed += 1
            assert bundle.to_json() == reference, f"seed {seed} diverged"
            injected = plan.snapshot()["by_kind"].get("bitflip", 0)
            caught = m.counter_value("rpc.integrity_failures") + m.counter_value(
                "fetch.speculative_integrity_drops"
            )
            flips += injected
            assert caught == injected
        assert completed > 0 and flips > 0
