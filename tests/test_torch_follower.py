"""The port's chain follower (``storex/follower.py``) held against the JAX
package's over the same fixture chain and hermetic node.

Both followers tail the same heights through a `LotusClient` (or a
two-endpoint pool) into a recording tier and must warm the same CIDs,
count the same ``follow.*`` counters, stay idle on an unchanged head, fire
each finalized hook once per height and shrug off a raising hook. The
port verifies each landed wave with one `verify_blocks_batch` call (here
on the CPU plain versions, the lane forced with ``IPC_VERIFY_MIN_BYTES=0``).
Its fail-soft net holds store errors only: an RPC fault counts
``follow.errors``, a backend whose lane raises makes `poll_once` raise,
and without CUDA the default follower refuses to start. The leader lock
elects one follower per directory, under lockdep.
"""

import base64
import json
import random
import time

import pytest
import torch

jax = pytest.importorskip("jax")

from ipc_proofs_tpu.fixtures import build_range_world as ref_build_range_world  # noqa: E402
from ipc_proofs_tpu.storex import follower as ref_follower  # noqa: E402
from ipc_proofs_tpu.store import failover as ref_failover  # noqa: E402
from ipc_proofs_tpu.store import faults as ref_faults  # noqa: E402
from ipc_proofs_tpu.store import rpc as ref_rpc  # noqa: E402
from ipc_proofs_tpu.storex import SegmentStore as RefSegmentStore  # noqa: E402
from ipc_proofs_tpu.storex import TieredBlockstore as RefTieredBlockstore  # noqa: E402
from ipc_proofs_tpu.utils.metrics import Metrics as RefMetrics  # noqa: E402
from ipc_proofs_tpu_torch.backend import get_backend  # noqa: E402
from ipc_proofs_tpu_torch.fixtures import build_range_world  # noqa: E402
from ipc_proofs_tpu_torch.ops.verify import VerifyLaneError  # noqa: E402
from ipc_proofs_tpu_torch.store import failover, faults, rpc  # noqa: E402
from ipc_proofs_tpu_torch.storex import SegmentStore, TieredBlockstore, follower  # noqa: E402
from ipc_proofs_tpu_torch.utils import lockdep  # noqa: E402
from ipc_proofs_tpu_torch.utils.metrics import Metrics  # noqa: E402

CPU = get_backend("gpu", device="cpu")
N_PAIRS = 4


class Pkg:
    def __init__(self, name, world, fol, fa, rp, fo, metrics, seg, tier, backend):
        self.name, self.world, self.follower, self.fa, self.rpc, self.fo = name, world, fol, fa, rp, fo
        self.Metrics, self.SegmentStore, self.Tiered, self.backend = metrics, seg, tier, backend

    def chain_follower(self, client, store, **kw):
        if self.backend is not None:
            kw.setdefault("backend", self.backend)
        return self.follower.ChainFollower(client, store, **kw)

    def pool(self, clients, **kw):
        if self.backend is not None:
            kw["backend"] = self.backend
        return self.fo.EndpointPool(clients, **kw)


PORT = Pkg("port", build_range_world, follower, faults, rpc, failover, Metrics, SegmentStore, TieredBlockstore, CPU)
REF = Pkg("ref", ref_build_range_world, ref_follower, ref_faults, ref_rpc, ref_failover, RefMetrics,
          RefSegmentStore, RefTieredBlockstore, None)


@pytest.fixture(autouse=True)
def _lane_forced_lockdep_on(monkeypatch):
    monkeypatch.setenv("IPC_VERIFY_MIN_BYTES", "0")
    lockdep.enable(strict=True)
    lockdep.reset()
    try:
        yield
    finally:
        lockdep.disable()
    assert not lockdep.violations()


def _tipset_json(tipset) -> dict:
    return {
        "Cids": [{"/": str(c)} for c in tipset.cids],
        "Blocks": [
            {
                "Parents": [{"/": str(p)} for p in h.parents],
                "Height": h.height,
                "ParentStateRoot": {"/": str(h.parent_state_root)},
                "ParentMessageReceipts": {"/": str(h.parent_message_receipts)},
                "Messages": {"/": str(h.messages)},
                "Timestamp": h.timestamp,
            }
            for h in tipset.blocks
        ],
        "Height": tipset.height,
    }


class Chain:
    """A fixture chain behind a hermetic node whose head can move."""

    def __init__(self, pkg):
        self.pkg = pkg
        self.store, pairs, _ = pkg.world(N_PAIRS, 8, 2, 0.25, base_height=5000)
        self.by_height = {}
        for pair in pairs:
            self.by_height[pair.parent.height] = pair.parent
            self.by_height[pair.child.height] = pair.child
        self.lo, self.hi = min(self.by_height), max(self.by_height)
        self.head = self.hi

    def session(self, flip=None):
        session = _ChainNode(self, self.pkg.fa.LocalLotusSession(self.store))
        return _Flipping(session, flip) if flip is not None else session

    def client(self, session=None, **kw):
        return self.pkg.rpc.LotusClient("http://node", session=session or self.session(), max_retries=1, **kw)


class _Resp:
    def __init__(self, body):
        self._body = body

    def raise_for_status(self):
        pass

    def json(self):
        return self._body


class _ChainNode:
    """The node's chain methods, answered from the `Chain` at call time (the
    head moves); blocks from the wrapped hermetic node."""

    def __init__(self, chain, inner):
        self._chain, self._inner = chain, inner

    def post(self, url, data=None, headers=None, timeout=None):
        req = json.loads(data)
        if isinstance(req, dict) and req["method"] == "Filecoin.ChainHead":
            return _Resp({"jsonrpc": "2.0", "id": req["id"], "result": {"Height": self._chain.head}})
        if isinstance(req, dict) and req["method"] == "Filecoin.ChainGetTipSetByHeight":
            tipset = self._chain.by_height[req["params"][0]]
            return _Resp({"jsonrpc": "2.0", "id": req["id"], "result": _tipset_json(tipset)})
        return self._inner.post(url, data=data, headers=headers, timeout=timeout)


class _Flipping:
    """The node serving one block bit-flipped (single and batch reads)."""

    def __init__(self, inner, cid):
        self._inner, self._cid = inner, str(cid)

    def post(self, url, data=None, headers=None, timeout=None):
        resp = self._inner.post(url, data=data, headers=headers, timeout=timeout)
        reqs, body = json.loads(data), resp.json()
        by_id = {r["id"]: r for r in (reqs if isinstance(reqs, list) else [reqs])}
        out = []
        for entry in body if isinstance(body, list) else [body]:
            entry = dict(entry)
            req = by_id[entry["id"]]
            if req["method"] == "Filecoin.ChainReadObj" and req["params"][0]["/"] == self._cid and entry.get("result"):
                raw = bytearray(base64.b64decode(entry["result"]))
                raw[-1] ^= 1
                entry["result"] = base64.b64encode(bytes(raw)).decode()
            out.append(entry)
        return _Resp(out if isinstance(body, list) else out[0])


class _Tier:
    """A recording local tier: every block the follower puts, in order."""

    def __init__(self):
        self.blocks: dict = {}
        self.order: list = []

    def put_local(self, cid, data):
        self.blocks[cid] = bytes(data)
        self.order.append(str(cid))

    def has_local(self, cid):
        return cid in self.blocks

    def get_local(self, cid):
        return self.blocks.get(cid)

    def get(self, cid):
        return self.blocks.get(cid)


def _counters(m) -> dict:
    return {k: v for k, v in m.snapshot()["counters"].items() if k.startswith("follow.")}


def _follow(pkg, client_factory=None, **kw):
    chain = Chain(pkg)
    m, tier = pkg.Metrics(), _Tier()
    client = (client_factory or (lambda c, m: c.client(metrics=m)))(chain, m)
    fol = pkg.chain_follower(client, tier, metrics=m, lag=1, start_height=chain.lo, **kw)
    warmed = [fol.poll_once(), fol.poll_once()]  # the second poll is idle
    chain.head += 1  # one more height finalizes
    chain.by_height[chain.head] = chain.by_height[chain.hi]  # the node answers it
    warmed.append(fol.poll_once())
    return warmed, tier.order, _counters(m), m


@pytest.mark.parametrize("cap", [16, 3], ids=["one-poll", "capped-polls"])
def test_follower_warms_what_the_reference_warms(cap):
    ours = _follow(PORT, max_tipsets_per_poll=cap)
    ref = _follow(REF, max_tipsets_per_poll=cap)
    assert ours[:3] == ref[:3]
    warmed, order, counters, m = ours
    if cap == 16:
        assert warmed == [2 * N_PAIRS - 1, 0, 1]  # lag 1; an unchanged head is idle
    assert counters.get("follow.errors", 0) == 0 and counters["follow.blocks_prefetched"] == len(order)
    assert m.counter_value("verify.device_blocks") > 0  # the waves reached the lane


def test_follower_over_a_pool_trusts_its_verification():
    def pooled(pkg):
        def make(chain, m):
            return pkg.pool([chain.client(metrics=m), chain.client(metrics=m)], metrics=m)
        return make

    ours, ref = _follow(PORT, pooled(PORT)), _follow(REF, pooled(REF))
    assert ours[:3] == ref[:3]
    assert ours[3].counter_value("verify.device_blocks") > 0  # verified by the pool's lane


def test_follower_fills_a_real_tier_like_the_reference(tmp_path):
    seen = []
    for pkg in (PORT, REF):
        chain = Chain(pkg)
        m = pkg.Metrics()
        kw = {"backend": CPU} if pkg is PORT else {}
        disk = pkg.SegmentStore(str(tmp_path / pkg.name), metrics=m, **kw)
        tier = pkg.Tiered(pkg.rpc.RpcBlockstore(chain.client(metrics=m)), disk, metrics=m)
        try:
            fol = pkg.chain_follower(chain.client(metrics=m), tier, metrics=m, lag=0, start_height=chain.lo)
            assert fol.poll_once() == 2 * N_PAIRS
            seen.append((len(disk), disk.stats()["bytes"], _counters(m)))
        finally:
            disk.close()
    assert seen[0] == seen[1]


def test_hooks_fire_once_per_height_and_a_raising_hook_is_fail_soft():
    logs = []
    for pkg in (PORT, REF):
        chain = Chain(pkg)
        m = pkg.Metrics()
        fol = pkg.chain_follower(chain.client(metrics=m), _Tier(), metrics=m, lag=0, start_height=chain.lo)
        heights = []
        fol.add_finalized_hook(lambda ts: heights.append(ts.height))
        fol.add_finalized_hook(lambda ts: 1 / 0)
        fol.poll_once()
        fol.poll_once()
        logs.append((heights, _counters(m)))
    assert logs[0] == logs[1]
    heights, counters = logs[0]
    assert len(heights) == len(set(heights)) == 2 * N_PAIRS
    assert counters["follow.errors"] == 2 * N_PAIRS  # one per raising hook call
    assert counters["follow.tipsets"] == 2 * N_PAIRS


def test_rpc_faults_count_follow_errors_like_the_reference():
    def faulty(pkg):
        def make(chain, m):
            plan = pkg.fa.FaultPlan(3, fault_rate=0.4, kinds=("transport", "timeout"))
            session = pkg.fa.FaultySession(chain.session(), plan, sleep=lambda s: None)
            return chain.client(session=session, metrics=m, rng=random.Random(0))
        return make

    ours, ref = _follow(PORT, faulty(PORT)), _follow(REF, faulty(REF))
    assert ours[:3] == ref[:3]
    assert ours[2]["follow.errors"] > 0


def test_a_corrupt_spine_block_is_one_error_and_never_stored():
    chain = Chain(PORT)
    spine = chain.by_height[chain.lo].blocks[0].parent_message_receipts
    logs = []
    for pkg in (PORT, REF):
        chain = Chain(pkg)
        m, tier = pkg.Metrics(), _Tier()
        fol = pkg.chain_follower(chain.client(session=chain.session(flip=spine), metrics=m), tier, metrics=m,
                                 lag=chain.hi - chain.lo, start_height=chain.lo)
        assert fol.poll_once() == 1
        logs.append((tier.order, _counters(m)))
    assert logs[0] == logs[1]
    order, counters = logs[0]
    assert counters["follow.errors"] == 1 and str(spine) not in order


class _FaultyBackend:
    def warm(self):
        pass

    def blake2b256_batch(self, messages):
        raise RuntimeError("CUDA error: unspecified launch failure")

    def keccak256_batch(self, messages):
        raise RuntimeError("CUDA error: unspecified launch failure")


def test_a_lane_fault_raises_out_of_poll_once():
    chain = Chain(PORT)
    m = Metrics()
    fol = follower.ChainFollower(chain.client(metrics=m), _Tier(), metrics=m, lag=0, start_height=chain.lo,
                                 backend=_FaultyBackend())
    with pytest.raises(RuntimeError, match="launch failure"):
        fol.poll_once()
    assert m.counter_value("follow.errors") == 0 and m.counter_value("follow.tipsets") == 0


def test_a_pool_lane_fault_raises_out_of_poll_once():
    chain = Chain(PORT)
    m = Metrics()
    pool = failover.EndpointPool([chain.client(metrics=m), chain.client(metrics=m)], backend=_FaultyBackend(),
                                 metrics=m)
    try:
        fol = follower.ChainFollower(pool, _Tier(), metrics=m, lag=0, start_height=chain.lo, backend=CPU)
        with pytest.raises(VerifyLaneError):
            fol.poll_once()
    finally:
        pool.close()
    assert m.counter_value("follow.errors") == 0


def test_the_daemon_stops_on_a_lane_fault():
    chain = Chain(PORT)
    m = Metrics()
    fol = follower.ChainFollower(chain.client(metrics=m), _Tier(), metrics=m, poll_s=0.01, poll_jitter=0.0,
                                 lag=0, start_height=chain.lo, backend=_FaultyBackend())
    fol.start()
    try:
        for _ in range(200):
            if fol.fault is not None:
                break
            time.sleep(0.01)
    finally:
        fol.stop()
    assert isinstance(fol.fault, RuntimeError)
    assert m.counter_value("follow.errors") == 0


def test_the_follower_defaults_to_the_card(monkeypatch):
    chain = Chain(PORT)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        follower.ChainFollower(chain.client(), _Tier())


def test_store_errors_are_classified_by_their_cause():
    assert follower._is_store_error(ConnectionError("x"))
    chained = RuntimeError("RPC failed after 3 attempts")
    chained.__cause__ = TimeoutError("slow")
    assert follower._is_store_error(chained)
    assert follower._is_store_error(failover.DegradedError("cid"))
    assert not follower._is_store_error(RuntimeError("CUDA error"))
    lane = VerifyLaneError("lane")
    lane.__cause__ = OSError("inner")
    assert not follower._is_store_error(lane)


def test_the_leader_lock_elects_one_follower(tmp_path):
    logs = []
    for pkg in (PORT, REF):
        m = pkg.Metrics()
        first = pkg.follower.FollowLeaderLock(str(tmp_path / pkg.name))
        second = pkg.follower.FollowLeaderLock(str(tmp_path / pkg.name))
        steps = [first.try_acquire(m), second.try_acquire(m), first.try_acquire(m)]
        first.release()
        steps += [second.try_acquire(m), second.held, first.held]
        with second:
            pass
        steps.append(second.held)
        logs.append((steps, _counters(m)))
    assert logs[0] == logs[1]
    assert logs[0][0] == [True, False, True, True, True, False, False]
    assert logs[0][1]["follow.leader_elections"] == 2
