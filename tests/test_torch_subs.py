"""The port's standing queries (`subs/`) against the JAX package's.

Both packages run over one seeded range world (`build_range_world`, equal
pair tables and blocks): the reference on its host paths, the port on
``device="cpu"`` (the plain versions of its kernels). Byte equality
throughout:

- filter and target validation: the same canonical filter, or the same
  exception type and message; `filter_key` and the ring key;
- the subscription registry and the delivery log: for one sequence of
  operations, the same return values and journal bytes (compaction under
  the byte cap included), and each package replays the other's journals
  (registrations, cursors, acks, bases, content-addressed payloads);
- webhook push: the same request bodies, retries, backoff delays (seeded
  ``rng``) and counters for transient, terminal and exhausted-then-repushed
  deliveries;
- the matcher fed finalized tipsets: one generation per distinct (pair,
  filter), every push body and digest equal to the reference's and to a
  direct chunked-driver run, with delta delivery on and off, directly and
  on the service's PUSH lane; a filter with a storage leg fails in both
  packages alike (``subs.errors``);
- a restart replays the registry and re-pushes unacked deliveries, across
  packages;
- the HTTP routes (``/v1/subscribe``, ``/v1/unsubscribe``,
  ``/v1/subscriptions``, ``/v1/deliveries``) and the ``/healthz`` fields;
- a fault of the card in a push: it raises out of the matcher before any
  delivery of the tipset is appended (no ``subs.errors``), and the
  follower stops on it instead of counting ``follow.errors``;
- cluster failover (the reference's ``TestClusterStandingFailover``): each
  package's router over two `LocalShard`s with standing queries; the dead
  shard's arc re-registers on the survivor under the original ids and its
  matcher serves them, with the same deliveries in both packages.
"""

import json
import os
import random
import threading
import time

import pytest

pytest.importorskip("jax")

import ipc_proofs_tpu.subs as ref_subs  # noqa: E402
import ipc_proofs_tpu_torch.proofs.range as port_range  # noqa: E402
import ipc_proofs_tpu_torch.subs as port_subs  # noqa: E402
from ipc_proofs_tpu.fixtures import build_range_world as ref_build_range_world  # noqa: E402
from ipc_proofs_tpu.jobs.journal import frame_record as ref_frame_record  # noqa: E402
from ipc_proofs_tpu.serve.httpd import ProofHTTPServer as RefHTTPServer  # noqa: E402
from ipc_proofs_tpu.serve.service import ProofService as RefProofService  # noqa: E402
from ipc_proofs_tpu.serve.service import ServiceConfig as RefServiceConfig  # noqa: E402
from ipc_proofs_tpu.proofs.generator import EventProofSpec as RefSpec  # noqa: E402
from ipc_proofs_tpu.utils.metrics import Metrics as RefMetrics  # noqa: E402
from ipc_proofs_tpu_torch.backend import get_backend  # noqa: E402
from ipc_proofs_tpu_torch.fixtures import build_range_world  # noqa: E402
from ipc_proofs_tpu_torch.ops.build import DeviceFaultError  # noqa: E402
from ipc_proofs_tpu_torch.proofs.bundle import bundle_obj_digest  # noqa: E402
from ipc_proofs_tpu_torch.proofs.generator import EventProofSpec  # noqa: E402
from ipc_proofs_tpu_torch.proofs.range import generate_event_proofs_for_range_chunked  # noqa: E402
from ipc_proofs_tpu_torch.serve import ProofHTTPServer, ProofService, ServiceConfig  # noqa: E402
from ipc_proofs_tpu_torch.state.storage import calculate_storage_slot  # noqa: E402
from ipc_proofs_tpu_torch.storex import ChainFollower  # noqa: E402
from ipc_proofs_tpu_torch.utils.metrics import Metrics  # noqa: E402

from _torch_http import get, post, strip  # noqa: E402

SIG = "NewTopDownMessage(bytes32,uint256)"
SUBNET = "calib-subnet-1"
ACTOR = 1001
CPU = get_backend("gpu", device="cpu")
FILTER_A = {"signature": SIG, "topic1": SUBNET}
FILTER_B = {"signature": SIG, "topic1": SUBNET, "actor_id": ACTOR}
FILTER_SLOT = dict(FILTER_B, slot=calculate_storage_slot(SUBNET, 0).hex())
NOSLEEP = lambda s: None  # noqa: E731
WORLD_KW = dict(receipts_per_pair=6, events_per_receipt=3, match_rate=0.5, signature=SIG, topic1=SUBNET,
                actor_id=ACTOR, base_height=41_000)


@pytest.fixture(scope="module")
def both():
    """(port world, reference world): 5 pairs, each on its own two heights."""
    return build_range_world(5, **WORLD_KW), ref_build_range_world(5, **WORLD_KW)


def _counters(m, prefix="subs."):
    return {k: v for k, v in m.snapshot()["counters"].items() if k.startswith(prefix)}


def _wait_until(cond, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.01)
    return False


class _Opener:
    """Webhook seam: records every POST, answers via ``behavior(obj)``."""

    def __init__(self, behavior=None):
        self._lock = threading.Lock()
        self.calls = []
        self._behavior = behavior

    def __call__(self, url, body, timeout_s):
        obj = json.loads(body)
        with self._lock:
            self.calls.append((url, body, obj))
        return 200 if self._behavior is None else self._behavior(obj)

    def bodies(self):
        with self._lock:
            return sorted((obj["sub_id"], obj["cursor"], body) for _, body, obj in self.calls)


# --- validation -----------------------------------------------------------

FILTERS = {
    "minimal": FILTER_A,
    "actor": FILTER_B,
    "slot-upper": dict(FILTER_B, slot="AB" * 32),
    "no-signature": {"topic1": SUBNET},
    "no-topic1": {"signature": SIG},
    "empty-signature": dict(FILTER_A, signature=""),
    "bool-actor": dict(FILTER_A, actor_id=True),
    "str-actor": dict(FILTER_A, actor_id="1001"),
    "slot-without-actor": dict(FILTER_A, slot="ab" * 32),
    "slot-not-hex": dict(FILTER_B, slot="xyz"),
    "slot-short": dict(FILTER_B, slot="ab" * 31),
    "slot-int": dict(FILTER_B, slot=7),
    "unknown-key": dict(FILTER_A, surprise=1),
    "not-a-dict": "not a dict",
    "none": None,
}


def _outcome(fn, arg):
    try:
        return ("ok", fn(arg))
    except Exception as exc:  # the outcome under comparison
        return (type(exc).__name__, str(exc))


@pytest.mark.parametrize("case", sorted(FILTERS))
def test_filter_validation_matches_the_reference(case):
    port = _outcome(port_subs.normalize_filter, FILTERS[case])
    ref = _outcome(ref_subs.normalize_filter, FILTERS[case])
    assert port == ref
    if port[0] == "ok":
        assert port_subs.filter_key(port[1]) == ref_subs.filter_key(ref[1])
        assert port_subs.subscription_ring_key(port[1]) == ref_subs.subscription_ring_key(ref[1])


TARGETS = {
    "none": None,
    "url": {"url": "http://hooks/x"},
    "poll": {"mode": "poll", "url": "http://ignored"},
    "webhook-no-url": {"mode": "webhook"},
    "webhook-no-scheme": {"mode": "webhook", "url": "no-scheme"},
    "unknown-mode": {"mode": "carrier-pigeon"},
    "list": ["http://x"],
}


@pytest.mark.parametrize("case", sorted(TARGETS))
def test_target_validation_matches_the_reference(case):
    assert _outcome(port_subs.normalize_target, TARGETS[case]) == _outcome(ref_subs.normalize_target, TARGETS[case])


def test_filter_key_is_order_canonical():
    a = {"signature": SIG, "topic1": SUBNET, "actor_id": ACTOR}
    b = {"actor_id": ACTOR, "topic1": SUBNET, "signature": SIG}
    keys = {port_subs.filter_key(port_subs.normalize_filter(f)) for f in (a, b)}
    assert keys == {ref_subs.filter_key(ref_subs.normalize_filter(a))}


# --- the registry and the delivery log ------------------------------------


def _registry_ops(pkg, root):
    m = Metrics() if pkg is port_subs else RefMetrics()
    reg = pkg.SubscriptionRegistry(root, metrics=m, fsync=False)
    out = []
    for i in range(4):
        sub, created = reg.subscribe(FILTER_A if i % 2 else FILTER_B, {"url": f"http://h/{i}"} if i else None,
                                     sub_id=f"s{i}")
        out.append((sub.to_json_obj(), created))
    out.append(reg.subscribe(FILTER_SLOT, None, sub_id="s0")[1])  # absorbed
    out += [reg.unsubscribe("s1"), reg.unsubscribe("s1"), len(reg)]
    reg.close()
    return out, _counters(m)


def _replayed(pkg, root):
    reg = pkg.SubscriptionRegistry(root, metrics=Metrics() if pkg is port_subs else RefMetrics(), fsync=False)
    try:
        return sorted(json.dumps(s.to_json_obj(), sort_keys=True) for s in reg.active()), reg.replayed
    finally:
        reg.close()


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_registry_journal_is_byte_equal_and_replays_across_packages(tmp_path, writer):
    port_out = _registry_ops(port_subs, str(tmp_path / "port"))
    ref_out = _registry_ops(ref_subs, str(tmp_path / "ref"))
    assert port_out == ref_out
    path = port_subs.registry.REGISTRY_JOURNAL
    assert (tmp_path / "port" / path).read_bytes() == (tmp_path / "ref" / path).read_bytes()
    src = tmp_path / writer
    # a torn tail (a crash mid-write) is truncated by either reader
    half = ref_frame_record({"op": "sub", "id": "lost", "filter": FILTER_A})
    with open(src / path, "ab") as fh:
        fh.write(half[: len(half) // 2])
    reader = ref_subs if writer == "port" else port_subs
    active, replayed = _replayed(reader, str(src))
    assert replayed == 5 and [json.loads(a)["sub_id"] for a in active] == ["s0", "s2", "s3"]
    assert _replayed(port_subs if reader is ref_subs else ref_subs, str(src)) == (active, replayed)


def _delivery_ops(pkg, root, cap_bytes=64 << 20):
    m = Metrics() if pkg is port_subs else RefMetrics()
    log = pkg.DeliveryLog(root, metrics=m, cap_bytes=cap_bytes, fsync=False)
    shared = {"bundle": {"blocks": ["cc" * 64], "n": 7}}
    out = []
    for step in range(3):
        for sub in ("s1", "s2", "s3"):
            d = log.append(sub, 100 + step, f"{step:02d}" * 16, shared if step != 1 else {"bundle": {"n": step}})
            out.append(None if d is None else d.to_json_obj())
    out.append(log.append("s1", 100, "00" * 16, shared))  # idempotent replay
    delta = log.append("s2", 103, "03" * 16, {"bundle_delta": {"base": "x"}}, payload_digest="delta:x:03")
    out.append(delta.to_json_obj())
    out += [log.ack("s1", 1), log.ack("s1", 1), log.ack("nope", 1), log.ack_through("s2", 2),
            log.ack_through("s3", 9), log.acked_base("s2"), log.cursor("s2"), log.pending_total()]
    out.append(sorted(log.bases().items()))
    log.close()
    return out, _counters(m)


def _log_state(pkg, root):
    log = pkg.DeliveryLog(root, metrics=Metrics() if pkg is port_subs else RefMetrics(), fsync=False)
    try:
        return (
            {s: [d.to_json_obj() for d in log.pending(s)] for s in ("s1", "s2", "s3")},
            sorted(log.bases().items()),
            [log.cursor(s) for s in ("s1", "s2", "s3")],
            log.append("s1", 101, "01" * 16, {"bundle": {"n": 1}}),  # dedup survives replay
        )
    finally:
        log.close()


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_delivery_journal_is_byte_equal_and_replays_across_packages(tmp_path, writer):
    port_out = _delivery_ops(port_subs, str(tmp_path / "port"))
    ref_out = _delivery_ops(ref_subs, str(tmp_path / "ref"))
    assert port_out == ref_out
    path = port_subs.delivery.DELIVERY_JOURNAL
    assert (tmp_path / "port" / path).read_bytes() == (tmp_path / "ref" / path).read_bytes()
    src = str(tmp_path / writer)
    assert _log_state(port_subs, src) == _log_state(ref_subs, src)


def test_compaction_under_the_cap_matches_the_reference(tmp_path):
    blob = {"bundle": {"x": "ab" * 2048}}
    journals = []
    for pkg in (port_subs, ref_subs):
        m = Metrics() if pkg is port_subs else RefMetrics()
        root = str(tmp_path / pkg.__name__)
        log = pkg.DeliveryLog(root, metrics=m, cap_bytes=1, fsync=False)
        for i in range(40):
            d = log.append("s1", i, f"{i:02d}" * 16, blob)
            if i < 37:
                log.ack("s1", d.cursor)
        log.close()
        assert _counters(m)["subs.log_compactions"] >= 1
        journals.append((tmp_path / pkg.__name__ / pkg.delivery.DELIVERY_JOURNAL).read_bytes())
        again = pkg.DeliveryLog(root, metrics=m, fsync=False)
        assert [d.cursor for d in again.pending("s1")] == [38, 39, 40]
        assert again.append("s1", 5, "05" * 16, blob) is None
        again.close()
    assert journals[0] == journals[1]


def test_long_poll_wakes_on_append(tmp_path):
    log = port_subs.DeliveryLog(str(tmp_path), metrics=Metrics(), fsync=False)
    out = {}

    def waiter():
        out["entries"] = log.entries_after("s1", 0, wait_s=10.0)

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.1)
    log.append("s1", 1, "aa" * 16, {"bundle": {"n": 1}})
    t.join(timeout=8.0)
    assert not t.is_alive() and [e.cursor for e in out["entries"]] == [1]
    log.close()


# --- webhook push ---------------------------------------------------------

PUSH_CASES = {
    "transient": (lambda: iter([503, 503, 200]), 4),
    "terminal-400": (lambda: iter([400]), 4),
    "exhausted": (lambda: iter([503, 500, 502, 504]), 4),
}


@pytest.mark.parametrize("case", sorted(PUSH_CASES))
def test_push_bodies_retries_and_delays_match_the_reference(tmp_path, case):
    """Seeded full-jitter backoff (the delays in milliseconds): the same
    bodies, delays, verdicts and counters; an exhausted push converges on
    the next re-push."""
    results = []
    for pkg in (port_subs, ref_subs):
        m = Metrics() if pkg is port_subs else RefMetrics()
        root = str(tmp_path / pkg.__name__)
        codes, attempts = PUSH_CASES[case][0](), PUSH_CASES[case][1]
        opener = _Opener(lambda obj, codes=codes: next(codes, 200))
        delays = []
        log = pkg.DeliveryLog(root, metrics=m, fsync=False)
        push = pkg.PushDelivery(log, metrics=m, max_attempts=attempts, base_delay_s=0.001, max_delay_s=0.004,
                                opener=opener, sleep=delays.append, rng=random.Random(7))
        reg = pkg.SubscriptionRegistry(root, metrics=m, fsync=False)
        sub, _ = reg.subscribe(FILTER_A, {"url": "http://hooks/w1"}, sub_id="w1")
        poll, _ = reg.subscribe(FILTER_A, None, sub_id="p1")
        d = log.append("w1", 7, "aa" * 16, {"bundle": {"n": 1, "x": [1, 2]}})
        verdict = push.push(sub, d).result(timeout=30)
        assert push.push(poll, log.append("p1", 7, "aa" * 16, {"bundle": {"n": 1}})) is None
        repushed = push.repush_pending(reg)
        assert _wait_until(lambda: not log.pending("w1"))
        push.drain()
        log.close()
        reg.close()
        results.append((verdict, repushed, delays, opener.bodies(), _counters(m)))
    assert results[0] == results[1]


# --- the matcher ----------------------------------------------------------


def _tipsets(world):
    """The finalized feed: each pair's parent, then its child (the matcher
    also pairs one pair's child with the next one's parent, a gap pair
    without receipts)."""
    _, pairs, _ = world
    return [ts for p in pairs for ts in (p.parent, p.child)]


def _drive_matcher(pkg, world, root, delta=True, service=None):
    """Subscribe a mixed set, feed every finalized tipset, ack polls
    between tipsets; returns (push bodies, polled deliveries, counters)."""
    store, _, _ = world
    m = service.metrics if service is not None else (Metrics() if pkg is port_subs else RefMetrics())
    opener = _Opener()
    kw = dict(match_backend=CPU) if pkg is port_subs else {}
    sq = pkg.StandingQueries(root, store=store, metrics=m, fsync=False, delta=delta, service=service,
                             opener=opener, sleep=NOSLEEP, rng=random.Random(0), **kw)
    subs = [("w-a1", FILTER_A, True), ("w-a2", FILTER_A, True), ("w-b1", FILTER_B, True), ("p-a", FILTER_A, False),
            ("p-b", FILTER_B, False), ("w-slot", FILTER_SLOT, True)]
    try:
        for sub_id, filt, hook in subs:
            body = {"filter": filt, "sub_id": sub_id}
            if hook:
                body["target"] = {"url": f"http://hooks/{sub_id}"}
            sq.subscribe(body)
        polled = []
        cursors = {"p-a": 0, "p-b": 0}
        for ts in _tipsets(world):
            sq.on_tipset(ts)
            assert _wait_until(lambda: m.snapshot().get("gauges", {}).get("subs.push_inflight", 0) == 0
                               and all(not sq.log.pending(s) for s, _, h in subs if h))
            for sub_id in cursors:
                out = sq.deliveries(sub_id, cursor=cursors[sub_id])
                polled.append(out)
                cursors[sub_id] = out["cursor"]
        return opener.bodies(), polled, _counters(m), _counters(m, "witness.delta")
    finally:
        sq.drain()


def _expected(world, pair, filt):
    store, _, _ = world
    spec = EventProofSpec(filt["signature"], filt["topic1"], filt.get("actor_id"))
    obj = generate_event_proofs_for_range_chunked(store, [pair], spec, chunk_size=8, match_backend=CPU).to_json_obj()
    return obj, bundle_obj_digest(obj)


@pytest.mark.parametrize("delta", [True, False], ids=["delta", "full"])
def test_matcher_pushes_match_the_reference(both, tmp_path, delta):
    port = _drive_matcher(port_subs, both[0], str(tmp_path / "port"), delta=delta)
    ref = _drive_matcher(ref_subs, both[1], str(tmp_path / "ref"), delta=delta)
    assert port == ref
    bodies, polled, counters, _ = port
    n_pairs = 2 * len(both[0][1]) - 1  # the real pairs and the gaps between them
    # one generation per distinct (pair, filter); the storage leg fails in
    # both packages (the reference hands the chunked driver a pre-hashed
    # StorageProofSpec), counted, never delivered
    assert counters["subs.generations"] == 2 * n_pairs
    assert counters["subs.errors"] == n_pairs
    assert counters["subs.tipsets_matched"] == n_pairs
    assert counters["subs.empty_matches"] == 2 * (n_pairs - len(both[0][1]))
    assert not [b for b in bodies if b[0] == "w-slot"]
    _, pairs, _ = both[0]
    heights = {p.child.height: p for p in pairs}
    for sub_id, _cursor, body in bodies:
        env = json.loads(body)
        obj, digest = _expected(both[0], heights[env["tipset"]], FILTER_A if "-a" in sub_id else FILTER_B)
        assert env["digest"] == digest
        if "bundle" in env:
            assert body.decode().endswith(', "bundle": ' + json.dumps(obj, sort_keys=True) + "}")
    assert any("bundle_delta" in json.loads(b) for _, _, b in bodies) == delta


def test_matcher_on_the_push_lane_matches_the_reference(both, tmp_path):
    (store, pairs, _), (ref_store, ref_pairs, _) = both
    spec, ref_spec = EventProofSpec(SIG, SUBNET), RefSpec(SIG, SUBNET)
    svc = ProofService(store=store, spec=spec, config=ServiceConfig(device="cpu", workers=1))
    ref_svc = RefProofService(store=ref_store, spec=ref_spec, config=RefServiceConfig(workers=1))
    try:
        port = _drive_matcher(port_subs, both[0], str(tmp_path / "port"), service=svc)
        ref = _drive_matcher(ref_subs, both[1], str(tmp_path / "ref"), service=ref_svc)
        lanes = svc.metrics.snapshot()["timers"]["serve.backfill_window"]["calls"]
    finally:
        svc.drain()
        ref_svc.drain()
    assert port == ref
    assert lanes == 3 * (2 * len(pairs) - 1)  # every distinct filter, every pair: on the lane
    direct = _drive_matcher(port_subs, both[0], str(tmp_path / "direct"))
    assert port[0] == direct[0]


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_restart_replays_the_registry_and_repushes_unacked(both, tmp_path, writer):
    """The writer's webhook is down for the daemon's first life; the other
    package restarts over its journals and re-pushes the same bodies."""
    worlds = {"port": (port_subs, both[0]), "ref": (ref_subs, both[1])}
    pkg, world = worlds[writer]
    other, other_world = worlds["ref" if writer == "port" else "port"]
    root = str(tmp_path / "subs")
    down = _Opener(lambda obj: 503)
    kw = dict(match_backend=CPU) if pkg is port_subs else {}
    sq = pkg.StandingQueries(root, store=world[0], fsync=False, retry_attempts=2, retry_base_s=0.001,
                             retry_max_s=0.002, opener=down, sleep=NOSLEEP, rng=random.Random(0), **kw)
    for sub_id, filt in (("w-a", FILTER_A), ("w-b", FILTER_B)):
        sq.subscribe({"filter": filt, "sub_id": sub_id, "target": {"url": f"http://hooks/{sub_id}"}})
    sq.subscribe({"filter": FILTER_A, "sub_id": "p-a"})
    for ts in _tipsets(world)[:4]:
        sq.on_tipset(ts)
    sq.drain()
    pending = sq.log.pending_total()
    assert pending >= 3
    first_bodies = sorted(set((s, c, b) for s, c, b in down.bodies()))
    up = _Opener()
    kw = dict(match_backend=CPU) if other is port_subs else {}
    m = Metrics() if other is port_subs else RefMetrics()
    again = other.StandingQueries(root, store=other_world[0], metrics=m, fsync=False, opener=up,
                                  sleep=NOSLEEP, rng=random.Random(1), **kw)
    try:
        assert len(again.registry) == 3
        assert _wait_until(lambda: again.log.pending_total() == len(again.log.pending("p-a")))
        assert sorted(up.bodies()) == first_bodies
        assert "subs.duplicate_acks" not in _counters(m)
        assert again.health_fields()["subscriptions"] == 3
    finally:
        again.drain()


def test_a_device_fault_in_a_push_raises_and_stops_the_follower(both, tmp_path, monkeypatch):
    """The card faults in one filter's generation: `match_pair` raises it
    (no ``subs.errors``, no delivery of the tipset appended, not even for
    the healthy filter); the follower's hook wrapper re-raises it out of
    `poll_once` rather than counting ``follow.errors``."""
    store, pairs, _ = both[0]
    real = port_range.generate_event_proofs_for_range_chunked

    def faulty(store_, pairs_, spec, **kw):
        if spec.actor_id_filter is not None:
            raise DeviceFaultError("launch of event_match_mask_fp failed: an illegal memory access")
        return real(store_, pairs_, spec, **kw)

    monkeypatch.setattr(port_range, "generate_event_proofs_for_range_chunked", faulty)
    m = Metrics()
    sq = port_subs.StandingQueries(str(tmp_path), store=store, metrics=m, fsync=False, match_backend=CPU,
                                   opener=_Opener(), sleep=NOSLEEP)
    try:
        sq.subscribe({"filter": FILTER_A, "sub_id": "p-a"})
        sq.subscribe({"filter": FILTER_B, "sub_id": "p-b"})
        with pytest.raises(DeviceFaultError):
            sq.matcher.match_pair(pairs[0])
        assert "subs.errors" not in _counters(m) and sq.log.pending_total() == 0
        follower = ChainFollower(object(), store, metrics=m, backend=CPU)
        follower.add_finalized_hook(sq.on_tipset)
        follower._fire_hooks(pairs[1].parent)
        with pytest.raises(DeviceFaultError):
            follower._fire_hooks(pairs[1].child)
        assert "follow.errors" not in _counters(m, "follow.")
        # an ordinary hook failure stays fail-soft
        follower.add_finalized_hook(lambda ts: 1 / 0)
        monkeypatch.setattr(port_range, "generate_event_proofs_for_range_chunked", real)
        follower._fire_hooks(pairs[2].child)
        assert _counters(m, "follow.")["follow.errors"] == 1
    finally:
        sq.drain()


# --- the HTTP routes ------------------------------------------------------


def _daemon(pkg, world, root):
    store, pairs, _ = world
    if pkg is port_subs:
        svc = ProofService(store=store, spec=EventProofSpec(SIG, SUBNET), config=ServiceConfig(device="cpu"))
        sq = port_subs.StandingQueries(root, store=store, metrics=svc.metrics, fsync=False, match_backend=CPU,
                                       opener=_Opener(), sleep=NOSLEEP, rng=random.Random(0))
        return ProofHTTPServer(svc, pairs=pairs, subs=sq).start()
    svc = RefProofService(store=store, spec=RefSpec(SIG, SUBNET), config=RefServiceConfig())
    sq = ref_subs.StandingQueries(root, store=store, metrics=svc.metrics, fsync=False,
                                  opener=_Opener(), sleep=NOSLEEP, rng=random.Random(0))
    return RefHTTPServer(svc, pairs=pairs, subs=sq).start()


ROUTES = [
    ("POST", "/v1/subscribe", {"filter": FILTER_A, "sub_id": "h-a"}),
    ("POST", "/v1/subscribe", {"filter": FILTER_B, "sub_id": "h-b", "target": {"url": "http://hooks/b"}}),
    ("POST", "/v1/subscribe", {"filter": FILTER_A, "sub_id": "h-a"}),
    ("POST", "/v1/subscribe", {"filter": {"topic1": SUBNET}}),
    ("POST", "/v1/subscribe", {"filter": FILTER_A, "target": {"mode": "webhook"}}),
    ("GET", "/v1/subscriptions", None),
    ("MATCH", 0, None),
    ("MATCH", 1, None),
    ("GET", "/v1/deliveries?sub=h-a&cursor=0", None),
    ("GET", "/v1/deliveries?sub=h-a&cursor=1", None),
    ("GET", "/v1/deliveries?sub=h-a&cursor=2&wait_s=0.05", None),
    ("GET", "/v1/deliveries?sub=nope", None),
    ("GET", "/v1/deliveries", None),
    ("GET", "/v1/deliveries?sub=h-a&cursor=x", None),
    ("GET", "/healthz", None),
    ("POST", "/v1/unsubscribe", {"sub_id": "h-a"}),
    ("POST", "/v1/unsubscribe", {"sub_id": "h-a"}),
    ("POST", "/v1/unsubscribe", {}),
    ("GET", "/v1/subscriptions", None),
]


def test_http_routes_match_the_reference(both, tmp_path):
    daemons = [_daemon(port_subs, both[0], str(tmp_path / "port")), _daemon(ref_subs, both[1], str(tmp_path / "ref"))]
    try:
        for method, path, body in ROUTES:
            if method == "MATCH":
                for d, world in zip(daemons, both):
                    d.subs.matcher.match_pair(world[1][path])
                    assert _wait_until(lambda d=d: not d.subs.log.pending("h-b"))
                continue
            answers = [post(d.port, path, body) if method == "POST" else get(d.port, path) for d in daemons]
            (ps, _, pb), (rs, _, rb) = answers
            assert ps == rs, (path, pb, rb)
            if path == "/healthz":
                for key in ("subscriptions", "pending_deliveries", "delivery_log_bytes", "subs_degraded"):
                    assert pb[key] == rb[key], key
            else:
                assert strip(pb) == strip(rb), path
    finally:
        for d in daemons:
            d.shutdown(timeout=60)


def test_sigterm_mid_push_drains_workers_before_the_service(both, tmp_path):
    """A webhook POST in flight at shutdown lands and acks before the
    service closes its store tiers."""
    store, pairs, _ = both[0]
    entered, release = threading.Event(), threading.Event()

    def blocking(url, body, timeout_s):
        entered.set()
        assert release.wait(timeout=30)
        return 200

    m = Metrics()
    svc = ProofService(store=store, spec=EventProofSpec(SIG, SUBNET), config=ServiceConfig(device="cpu"))
    sq = port_subs.StandingQueries(str(tmp_path), store=store, metrics=m, fsync=False, match_backend=CPU,
                                   opener=blocking, sleep=NOSLEEP)
    httpd = ProofHTTPServer(svc, pairs=pairs, subs=sq).start()
    order = []
    subs_drain, svc_drain = sq.drain, svc.drain
    sq.drain = lambda: (order.append("subs"), subs_drain())[-1]
    svc.drain = lambda *a, **k: (order.append("service"), svc_drain(*a, **k))[-1]
    sub, _ = sq.registry.subscribe(FILTER_A, {"url": "http://hooks/block"}, sub_id="wh-block")
    sq.push.push(sub, sq.log.append("wh-block", 41_001, "aa" * 16, {"bundle": {"n": 1}}))
    assert entered.wait(timeout=10)
    threading.Timer(0.2, release.set).start()
    httpd.shutdown(timeout=30)
    assert order == ["subs", "service"]
    assert sq.log.pending("wh-block") == [] and _counters(m)["subs.pushes"] == 1


def test_registry_failures_are_fail_soft(tmp_path):
    class _Broken:
        """A file on a full disk (ENOSPC)."""

        def write(self, data):
            raise OSError(28, os.strerror(28))

        def flush(self):
            raise OSError(28, os.strerror(28))

        def fileno(self):
            raise OSError(28, os.strerror(28))

        def close(self):
            pass

    m = Metrics()
    reg = port_subs.SubscriptionRegistry(str(tmp_path), metrics=m, fsync=False)
    reg._writer._fh.close()
    reg._writer._fh = _Broken()
    sub, created = reg.subscribe(FILTER_A, None, sub_id="mem-only")
    assert created and reg.get("mem-only") is sub and reg.degraded
    assert _counters(m)["subs.log_failures"] >= 1
    reg.close()


# --- cluster failover -----------------------------------------------------


def _cluster_failover(pkg, world, root):
    """Six subscriptions over two shards of ``pkg``; kill the shard that
    owns FILTER_A's arc; what the router and the survivor then serve."""
    import ipc_proofs_tpu.cluster as ref_cluster
    import ipc_proofs_tpu_torch.cluster as port_cluster

    port = pkg is port_subs
    cluster = port_cluster if port else ref_cluster
    store, pairs, _ = world
    shards, sqs = [], []
    for i in range(2):
        kw = dict(match_backend=CPU) if port else {}
        sq = pkg.StandingQueries(os.path.join(root, f"subs{i}"), store=store, fsync=False, opener=_Opener(),
                                 sleep=NOSLEEP, rng=random.Random(i), **kw)
        config = (ServiceConfig(max_batch=4, max_wait_ms=5.0, workers=1, device="cpu") if port
                  else RefServiceConfig(max_batch=4, max_wait_ms=5.0, workers=1))
        spec = (EventProofSpec if port else RefSpec)(SIG, SUBNET)
        shards.append(cluster.LocalShard(f"s{i}", store, pairs, spec, config=config, subs=sq).start())
        sqs.append(sq)
    rm = (Metrics if port else RefMetrics)()
    router = cluster.ClusterRouter({s.name: s.url for s in shards}, pairs, metrics=rm, scrape_interval_s=60.0)
    out = {}
    try:
        sub_ids = [f"sub-{i}" for i in range(6)]
        filters = {sid: (FILTER_A if i % 2 == 0 else FILTER_B) for i, sid in enumerate(sub_ids)}
        for sid in sub_ids:
            status, obj = router.subscribe({"filter": filters[sid], "sub_id": sid})
            assert status == 200 and obj["sub_id"] == sid
        status, obj = router.subscriptions()
        assert status == 200 and obj["count"] == 6
        out["placed"] = obj["shards"]
        ring = cluster.HashRing(["s0", "s1"])
        owner = {sid: ring.node_for(pkg.subscription_ring_key(pkg.normalize_filter(filters[sid]))) for sid in sub_ids}
        dead_idx = int(owner["sub-0"][1:])
        surv_idx = 1 - dead_idx

        sqs[dead_idx].matcher.match_pair(pairs[0])
        status, obj = router.deliveries("sub-0", cursor=0)
        assert status == 200
        out["before"] = [(e["tipset"], e["digest"]) for e in obj["deliveries"]]
        out["before_payload"] = obj["deliveries"][0]["payload"]["bundle"]

        shards[dead_idx].kill()

        def _recovered():
            status, obj = router.subscriptions()
            return status == 200 and obj["count"] == 6

        assert _wait_until(_recovered, timeout=30.0)
        status, obj = router.subscriptions()
        assert sorted(s["sub_id"] for s in obj["subscriptions"]) == sub_ids
        assert obj["shards"] == {f"s{surv_idx}": 6}
        out["moved"] = sum(1 for sid in sub_ids if owner[sid] == owner["sub-0"])
        out["rearced"] = rm.snapshot()["counters"].get("cluster.subs_rearced", 0)

        sqs[surv_idx].matcher.match_pair(pairs[1])
        status, obj = router.deliveries("sub-0", cursor=0)
        assert status == 200
        out["after"] = sorted((e["tipset"], e["digest"]) for e in obj["deliveries"])
        out["dead"], out["surv_height"] = owner["sub-0"], pairs[1].child.height
        return out
    finally:
        router.close()
        for s in shards:
            try:
                s.stop(timeout=10)
            except Exception:
                pass
        for sq in sqs:
            try:
                sq.drain()
            except Exception:
                pass


def test_dead_shard_arc_rearcs_under_original_ids(both, tmp_path):
    port = _cluster_failover(port_subs, both[0], str(tmp_path / "port"))
    ref = _cluster_failover(ref_subs, both[1], str(tmp_path / "ref"))
    assert port == ref
    expect, digest = _expected(both[0], both[0][1][0], port_subs.normalize_filter(FILTER_A))
    assert [d for _, d in port["before"]] == [digest] and port["before_payload"] == expect
    assert port["rearced"] == port["moved"] > 0
    assert port["surv_height"] in [t for t, _ in port["after"]]
