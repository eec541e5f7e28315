"""The port's backfill plane against the JAX package's: the hash ring, the
bundle fold, the window scheduler and the durable backfill engine.

Both packages run over one seeded range world (`build_range_world`, equal
pair tables and blocks): the reference on its host paths, the port on
``device="cpu"`` (the plain versions of its kernels). Byte equality
throughout:

- `HashRing` placement of a seeded key set (numpy) before and after a
  membership change, `pair_ring_key`, `partition_indexes`, and the error
  messages;
- `BundleFold` / `merge_range_bundles` over seeded partitions of a range
  bundle, first-sight folding (the reference's ``TestFoldFirstSight``) and
  the conflict errors;
- `plan_windows` and the `WorkAheadFeeder`'s primes;
- the engine: job ids, the sealed bundle (equal to the reference's and to
  ``range`` over the same pairs for every window size, placement and
  parallelism), journal files, resume across packages in both directions,
  resume after a SIGKILL of a child mid-job, the cursor protocol and the
  standing-query catch-up deliveries;
- the HTTP door (``POST /v1/backfill``, ``GET /v1/backfill[/<id>[/chunks]]``
  buffered and streamed), its 400s and 404s;
- the doors of a `LocalShard` built with ``backfill_jobs_dir`` (and its
  404 without one), and the router's door over two shards: the same job,
  the same polled chunks, folding to the sealed bundle;
- a fault of the card: the job is ``faulted`` (never ``failed``, never
  ``backfill.window_failures``), its committed windows stay journalled and
  resume, and over HTTP it is a 500 ``error_type: device`` and a ``device``
  abort chunk at the end of a stream.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

pytest.importorskip("jax")

from ipc_proofs_tpu import backfill as ref_bf  # noqa: E402
from ipc_proofs_tpu.backfill import scheduler as ref_sched  # noqa: E402
from ipc_proofs_tpu.cluster import gather as ref_gather  # noqa: E402
from ipc_proofs_tpu.cluster import hashring as ref_ring  # noqa: E402
from ipc_proofs_tpu.fixtures import build_range_world as ref_build_range_world  # noqa: E402
from ipc_proofs_tpu.proofs.bundle import ProofBlock as RefProofBlock  # noqa: E402
from ipc_proofs_tpu.proofs.bundle import UnifiedProofBundle as RefBundle  # noqa: E402
from ipc_proofs_tpu.proofs.generator import EventProofSpec as RefSpec  # noqa: E402
from ipc_proofs_tpu.core.cid import CID as RefCID  # noqa: E402
from ipc_proofs_tpu.subs import DeliveryLog as RefDeliveryLog  # noqa: E402
from ipc_proofs_tpu.utils.metrics import Metrics as RefMetrics  # noqa: E402
from ipc_proofs_tpu.witness.stream import decode_bundle_stream_docs as ref_decode_docs  # noqa: E402
from ipc_proofs_tpu_torch import backfill as port_bf  # noqa: E402
from ipc_proofs_tpu_torch.backend import get_backend  # noqa: E402
from ipc_proofs_tpu_torch.backfill import scheduler as port_sched  # noqa: E402
from ipc_proofs_tpu_torch.cluster import gather as port_gather  # noqa: E402
from ipc_proofs_tpu_torch.cluster import hashring as port_ring  # noqa: E402
from ipc_proofs_tpu_torch.core.cid import CID  # noqa: E402
from ipc_proofs_tpu_torch.fixtures import build_range_world  # noqa: E402
from ipc_proofs_tpu_torch.ops.build import DeviceFaultError  # noqa: E402
from ipc_proofs_tpu_torch.proofs.bundle import ProofBlock, UnifiedProofBundle  # noqa: E402
from ipc_proofs_tpu_torch.proofs.generator import EventProofSpec  # noqa: E402
from ipc_proofs_tpu_torch.proofs.range import generate_event_proofs_for_range  # noqa: E402
from ipc_proofs_tpu_torch.serve import ProofHTTPServer, ProofService, ServiceConfig  # noqa: E402
from ipc_proofs_tpu_torch.subs import DeliveryLog  # noqa: E402
from ipc_proofs_tpu_torch.utils.metrics import Metrics  # noqa: E402
from ipc_proofs_tpu_torch.witness.stream import (  # noqa: E402
    STREAM_CONTENT_TYPE,
    StreamAbortError,
    decode_bundle_stream_docs,
)

from _torch_http import get, post, request, strip  # noqa: E402

SIG = "NewTopDownMessage(bytes32,uint256)"
SUBNET = "calib-subnet-1"
ACTOR = 1001
N_PAIRS = 24
CPU = get_backend("gpu", device="cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# per-run fields of a job status
TIMES = ("first_chunk_s", "busy_s", "wall_s")
WORLD_KW = dict(signature=SIG, topic1=SUBNET, actor_id=ACTOR, base_height=42_000)


@pytest.fixture(scope="module")
def both():
    """(port world, reference world): 24 pairs, equal tables and blocks."""
    return (
        build_range_world(N_PAIRS, 3, 2, 0.3, **WORLD_KW),
        ref_build_range_world(N_PAIRS, 3, 2, 0.3, **WORLD_KW),
    )


def _spec(filtered=True):
    return EventProofSpec(event_signature=SIG, topic_1=SUBNET, actor_id_filter=ACTOR if filtered else None)


def _ref_spec(filtered=True):
    return RefSpec(event_signature=SIG, topic_1=SUBNET, actor_id_filter=ACTOR if filtered else None)


def _status(job):
    return {k: v for k, v in job.status().items() if k not in TIMES}


def _port_engine(world, filtered=True, runner=None, **kw):
    store, pairs, _ = world
    spec = _spec(filtered)
    return port_bf.BackfillEngine(
        pairs, spec, runner or port_bf.local_window_runner(store, spec, match_backend=CPU), **kw
    )


def _ref_engine(world, filtered=True, runner=None, **kw):
    store, pairs, _ = world
    spec = _ref_spec(filtered)
    return ref_bf.BackfillEngine(pairs, spec, runner or ref_bf.local_window_runner(store, spec), **kw)


def _run(engine, start=0, end=N_PAIRS, **kw):
    try:
        job = engine.submit(start, end, **kw)
        return job, job.result(timeout=300.0)
    finally:
        engine.close(timeout=60.0)


# --- the hash ring --------------------------------------------------------


def _keys(seed, n=200):
    rng = np.random.default_rng(seed)
    return [rng.bytes(16).hex() for _ in range(n)]


@pytest.mark.parametrize("vnodes", [1, 16, 64])
def test_hash_ring_assignments_match_the_reference(vnodes):
    nodes = [f"s{i}" for i in range(5)]
    rings = port_ring.HashRing(nodes, vnodes=vnodes), ref_ring.HashRing(nodes, vnodes=vnodes)
    keys = _keys(vnodes)

    def placement(ring):
        return [(ring.node_for(k), ring.nodes_for(k, 3)) for k in keys]

    assert placement(rings[0]) == placement(rings[1])
    for ring in rings:
        ring.remove("s2")
        ring.add("s5")
        ring.add("s5")  # idempotent
    assert placement(rings[0]) == placement(rings[1])
    assert list(rings[0].nodes()) == list(rings[1].nodes())
    assert len(rings[0]) == len(rings[1]) == 5 and "s5" in rings[0] and "s2" not in rings[0]
    assert rings[0].nodes_for(keys[0], 9) == rings[1].nodes_for(keys[0], 9)


@pytest.mark.parametrize(
    "case",
    ["empty-node_for", "empty-nodes_for", "vnodes-0", "empty-name"],
)
def test_hash_ring_errors_match_the_reference(case):
    def run(mod):
        if case == "vnodes-0":
            return mod.HashRing(vnodes=0)
        ring = mod.HashRing()
        if case == "empty-name":
            return ring.add("")
        if case == "empty-node_for":
            return ring.node_for("k")
        return ring.nodes_for("k", 2)

    errors = []
    for mod in (port_ring, ref_ring):
        with pytest.raises(ValueError) as info:
            run(mod)
        errors.append(str(info.value))
    assert errors[0] == errors[1]


def test_pair_ring_keys_and_partitions_match_the_reference(both):
    (_, pairs, _), (_, ref_pairs, _) = both
    keys = [port_ring.pair_ring_key(p) for p in pairs]
    assert keys == [ref_ring.pair_ring_key(p) for p in ref_pairs]
    rng = np.random.default_rng(7)
    assign = {i: f"s{int(rng.integers(0, 3))}" for i in range(N_PAIRS)}
    order = [int(i) for i in rng.permutation(N_PAIRS)]
    assert port_gather.partition_indexes(order, assign) == ref_gather.partition_indexes(order, assign)


# --- the bundle fold ------------------------------------------------------


@pytest.fixture(scope="module")
def range_bundles(both):
    """The whole range's bundle, each package's own, equal bytes."""
    (store, pairs, _), (ref_store, ref_pairs, _) = both
    port = generate_event_proofs_for_range(store, pairs, _spec(False), match_backend=CPU)
    from ipc_proofs_tpu.proofs.range import generate_event_proofs_for_range as ref_range

    ref = ref_range(ref_store, ref_pairs, _ref_spec(False))
    assert port.to_json() == ref.to_json()
    return port, ref


def _sub_bundles(world, spec, groups, generate):
    store, pairs, _ = world
    return [generate(store, [pairs[i] for i in g], spec) for g in groups]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bundle_fold_matches_the_reference(both, range_bundles, seed):
    """Seeded shard partitions of the range: each shard's sub-bundle folds
    in, the sealed bundle is the whole range's bytes in both packages, and
    each fold returns the same first-sight blocks."""
    from ipc_proofs_tpu.proofs.range import generate_event_proofs_for_range as ref_range

    rng = np.random.default_rng(seed)
    assign = {i: f"s{int(rng.integers(0, 3))}" for i in range(N_PAIRS)}
    groups = list(port_gather.partition_indexes(range(N_PAIRS), assign).values())
    port_world, ref_world = both
    port_subs = _sub_bundles(port_world, _spec(False), groups,
                             lambda s, p, sp: generate_event_proofs_for_range(s, p, sp, match_backend=CPU))
    ref_subs = _sub_bundles(ref_world, _ref_spec(False), groups, ref_range)
    order = [int(i) for i in rng.permutation(len(groups))]
    folds = (port_gather.BundleFold(port_world[1], range(N_PAIRS), metrics=Metrics()),
             ref_gather.BundleFold(ref_world[1], range(N_PAIRS), metrics=RefMetrics()))
    for k in order:
        fresh = [[str(b.cid) for b in fold.fold(sub[k])] for fold, sub in zip(folds, (port_subs, ref_subs))]
        assert fresh[0] == fresh[1]
    sealed = [fold.seal() for fold in folds]
    assert sealed[0].to_json() == sealed[1].to_json() == range_bundles[0].to_json()
    merged = port_gather.merge_range_bundles([port_subs[k] for k in order], port_world[1], range(N_PAIRS))
    assert merged.to_json() == range_bundles[1].to_json()


def test_fold_returns_only_first_sight_blocks():
    """The reference's ``TestFoldFirstSight``, on both packages."""
    out = []
    for gather, cid_cls, block_cls, bundle_cls in (
        (port_gather, CID, ProofBlock, UnifiedProofBundle),
        (ref_gather, RefCID, RefProofBlock, RefBundle),
    ):
        def blk(data):
            return block_cls(cid=cid_cls.hash_of(data), data=data)

        shared, only_a, only_b = blk(b"shared"), blk(b"only-a"), blk(b"only-b")
        fold = gather.BundleFold([], [])
        a = fold.fold(bundle_cls(storage_proofs=[], event_proofs=[], blocks=[shared, only_a]))
        b = fold.fold(bundle_cls(storage_proofs=[], event_proofs=[], blocks=[only_b, shared]))
        assert [x.data for x in a] == [b"shared", b"only-a"]
        assert [x.data for x in b] == [b"only-b"]
        assert fold.fold_block(blk(b"raw").cid.to_bytes(), b"raw") is True
        assert fold.fold_block(shared.cid.to_bytes(), b"shared") is False
        out.append(fold.seal().to_json())
    assert out[0] == out[1]


@pytest.mark.parametrize("case", ["conflict", "conflict-block", "unknown-child", "sealed"])
def test_fold_errors_match_the_reference(both, range_bundles, case):
    errors = []
    for gather, world, bundle, cid_cls, block_cls in (
        (port_gather, both[0], range_bundles[0], CID, ProofBlock),
        (ref_gather, both[1], range_bundles[1], RefCID, RefProofBlock),
    ):
        _, pairs, _ = world
        first = bundle.blocks[0]
        fold = gather.BundleFold(pairs, [0, 1])
        try:
            if case == "conflict":
                fold.fold_block(first.cid.to_bytes(), first.data)
                fold.fold(type(bundle)(storage_proofs=[], event_proofs=[],
                                       blocks=[block_cls(cid=first.cid, data=first.data + b"!")]))
            elif case == "conflict-block":
                fold.fold_block(first.cid.to_bytes(), first.data)
                fold.fold_block(first.cid.to_bytes(), b"other")
            elif case == "unknown-child":
                fold.fold(bundle)  # proofs of pairs outside [0, 1]
            else:
                fold.seal()
                fold.seal()
        except (ValueError, RuntimeError) as exc:
            errors.append((type(exc).__name__, str(exc)))
    assert len(errors) == 2 and errors[0] == errors[1]


# --- the scheduler --------------------------------------------------------


@pytest.mark.parametrize("window_size", [1, 5, 8, 24])
@pytest.mark.parametrize("nodes", [("local",), ("s0", "s1", "s2")], ids=["one", "three"])
def test_plan_windows_matches_the_reference(both, window_size, nodes):
    (_, pairs, _), (_, ref_pairs, _) = both
    port = [w.to_json_obj() for w in port_sched.plan_windows(pairs, 2, 23, window_size, nodes)]
    ref = [w.to_json_obj() for w in ref_sched.plan_windows(ref_pairs, 2, 23, window_size, nodes)]
    assert port == ref
    assert port_sched.window_ring_key(pairs, 3) == ref_sched.window_ring_key(ref_pairs, 3)


@pytest.mark.parametrize("args", [(0, 8, 0, ("a",)), (5, 5, 2, ("a",)), (0, 99, 2, ("a",)), (0, 8, 2, ())],
                         ids=["window-0", "empty-range", "out-of-bounds", "no-nodes"])
def test_plan_validation_matches_the_reference(both, args):
    errors = []
    for sched, world in ((port_sched, both[0]), (ref_sched, both[1])):
        with pytest.raises(ValueError) as info:
            sched.plan_windows(world[1], *args)
        errors.append(str(info.value))
    assert errors[0] == errors[1]


class _Plane:
    def __init__(self):
        self.primed = []

    def prime(self, cids):
        self.primed.append([str(c) for c in cids])


def test_feeder_primes_match_the_reference(both):
    primes = []
    for sched, world in ((port_sched, both[0]), (ref_sched, both[1])):
        _, pairs, _ = world
        windows = sched.plan_windows(pairs, 0, N_PAIRS, 4, ("local",))
        plane = _Plane()
        feeder = sched.WorkAheadFeeder(plane, pairs, windows, work_ahead=2)
        counts = [feeder.on_window_start(i, {3}) for i in range(len(windows))]
        assert sched.WorkAheadFeeder(None, pairs, windows).on_window_start(0) == 0
        primes.append((counts, plane.primed))
    assert primes[0] == primes[1]


# --- the engine -----------------------------------------------------------


@pytest.mark.parametrize("filtered", [True, False], ids=["actor", "any"])
@pytest.mark.parametrize("window_size,parallelism,nodes", [
    (1, 1, ("local",)), (8, 1, ("s0", "s1", "s2")), (5, 3, ("local",)), (24, 1, ("a", "b")),
])
def test_sealed_bundle_matches_the_reference_and_range(both, window_size, parallelism, nodes, filtered):
    port_world, ref_world = both
    kw = dict(window_size=window_size, window_parallelism=parallelism, nodes=nodes)
    job, sealed = _run(_port_engine(port_world, filtered, metrics=Metrics(), **kw))
    ref_job, ref_sealed = _run(_ref_engine(ref_world, filtered, metrics=RefMetrics(), **kw))
    assert sealed.to_json() == ref_sealed.to_json()
    whole = generate_event_proofs_for_range(port_world[0], port_world[1], _spec(filtered), match_backend=CPU)
    assert sealed.to_json() == whole.to_json()
    assert job.job_id == ref_job.job_id
    assert _status(job) == _status(ref_job)
    assert job.status()["state"] == "complete" and "error_type" not in job.status()


def test_journals_are_byte_equal_and_resume_across_packages(both, tmp_path):
    """One job, journalled by each package: the same directory name and
    journal bytes; each package then resumes the other's journal, replays
    every window and seals the same bytes, regenerating nothing."""
    port_world, ref_world = both
    job, sealed = _run(_port_engine(port_world, jobs_dir=str(tmp_path / "port"), fsync=False))
    ref_job, _ = _run(_ref_engine(ref_world, jobs_dir=str(tmp_path / "ref"), fsync=False))
    journal = os.path.join(job.job_id, "journal.bin")
    assert (tmp_path / "port" / journal).read_bytes() == (tmp_path / "ref" / journal).read_bytes()
    m, rm = Metrics(), RefMetrics()
    again, port_resumed = _run(_port_engine(port_world, jobs_dir=str(tmp_path / "ref"), metrics=m))
    ref_again, ref_resumed = _run(_ref_engine(ref_world, jobs_dir=str(tmp_path / "port"), metrics=rm))
    assert port_resumed.to_json() == ref_resumed.to_json() == sealed.to_json()
    for j, metrics in ((again, m), (ref_again, rm)):
        st = j.status()
        assert st["windows_replayed"] == st["windows_total"] == 3
        counters = metrics.snapshot()["counters"]
        assert counters["backfill.jobs_resumed"] == 1 and "backfill.windows" not in counters


_KILL_CHILD = r"""
import os, signal, sys
sys.path.insert(0, sys.argv[1])
from ipc_proofs_tpu_torch import backfill
from ipc_proofs_tpu_torch.backend import get_backend
from ipc_proofs_tpu_torch.fixtures import build_range_world
from ipc_proofs_tpu_torch.proofs.generator import EventProofSpec

kill_at = int(sys.argv[3])
store, pairs, _ = build_range_world(24, 3, 2, 0.3, signature="NewTopDownMessage(bytes32,uint256)",
                                    topic1="calib-subnet-1", actor_id=1001, base_height=42_000)
spec = EventProofSpec("NewTopDownMessage(bytes32,uint256)", "calib-subnet-1", 1001)
inner = backfill.local_window_runner(store, spec, match_backend=get_backend("gpu", device="cpu"))

def runner(window, wpairs):
    if window.index == kill_at:
        os.kill(os.getpid(), signal.SIGKILL)  # windows < kill_at are committed
    return inner(window, wpairs)

engine = backfill.BackfillEngine(pairs, spec, runner, jobs_dir=sys.argv[2], window_size=3)
engine.submit(0, 24).result(timeout=300)
"""


@pytest.mark.parametrize("resumer", ["port", "ref"])
def test_a_killed_job_resumes_from_its_journal(both, tmp_path, resumer):
    """A child process running the port's engine is SIGKILLed as window 5
    starts; resumed (by either package) from its journal, the job replays
    the five committed windows and seals the uninterrupted job's bytes."""
    port_world, ref_world = both
    jobs = str(tmp_path / "jobs")
    proc = subprocess.run([sys.executable, "-c", _KILL_CHILD, ROOT, jobs, "5"],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == -signal.SIGKILL, proc.stderr[-2000:]
    _, want = _run(_port_engine(port_world, window_size=3))
    if resumer == "port":
        job, sealed = _run(_port_engine(port_world, jobs_dir=jobs, window_size=3, metrics=Metrics()))
    else:
        job, sealed = _run(_ref_engine(ref_world, jobs_dir=jobs, window_size=3, metrics=RefMetrics()))
    assert sealed.to_json() == want.to_json()
    st = job.status()
    assert (st["windows_replayed"], st["windows_total"]) == (5, 8)


def test_a_closed_engine_stops_at_a_window_boundary_and_resumes(both, tmp_path):
    port_world, _ = both
    store, pairs, _ = port_world
    inner = port_bf.local_window_runner(store, _spec(), match_backend=CPU)
    gate = threading.Event()

    def gated(window, wpairs):
        if window.index == 2:
            gate.wait(timeout=60)
        return inner(window, wpairs)

    engine = _port_engine(port_world, runner=gated, jobs_dir=str(tmp_path), window_size=4)
    job = engine.submit(0, N_PAIRS)
    assert job.chunks_after(1, wait_s=30)["cursor"] >= 2
    closer = threading.Thread(target=engine.close, kwargs={"timeout": 60})
    closer.start()
    time.sleep(0.1)
    gate.set()
    closer.join(60)
    with pytest.raises(port_bf.BackfillError, match="closed"):
        job.result(timeout=30)
    assert job.status()["state"] == "failed"
    with pytest.raises(port_bf.BackfillError, match="closed"):
        engine.submit(0, 4)
    again, sealed = _run(_port_engine(port_world, jobs_dir=str(tmp_path), window_size=4))
    assert again.status()["windows_replayed"] == 3
    _, want = _run(_port_engine(port_world, window_size=4))
    assert sealed.to_json() == want.to_json()


def test_cursor_protocol_matches_the_reference(both):
    port_world, ref_world = both
    polls = []
    for make in (_port_engine, _ref_engine):
        world = port_world if make is _port_engine else ref_world
        engine = make(world, window_size=6)
        try:
            job = engine.submit(0, N_PAIRS)
            job.wait(timeout=300)
            seen = [job.chunks_after(2, wait_s=0.0), job.chunks_after(0, wait_s=0.0),
                    job.chunks_after(4, wait_s=0.0, limit=1), job.ack_through(4), job.ack_through(4)]
            polls.append(seen)
        finally:
            engine.close(timeout=60)
    assert polls[0] == polls[1]
    assert [c["cursor"] for c in polls[0][0]["chunks"]] == [3, 4]


def test_catch_up_deliveries_match_the_reference(both, tmp_path):
    """A job with a ``sub_id`` lands each window on the delivery log: the
    same deliveries and the same journal bytes in both packages, and a
    resumed job's replays dedup."""
    port_world, ref_world = both
    logs = {}
    for name, make, world, log_cls, metrics in (
        ("port", _port_engine, port_world, DeliveryLog, Metrics()),
        ("ref", _ref_engine, ref_world, RefDeliveryLog, RefMetrics()),
    ):
        log = log_cls(str(tmp_path / name), metrics=metrics, fsync=False)
        try:
            for _ in range(2):  # the second run replays from the journal
                _run(make(world, window_size=8, delivery=log, metrics=metrics,
                          jobs_dir=str(tmp_path / f"{name}-jobs")), sub_id="catch-up")
            logs[name] = [d.to_json_obj() for d in log.pending("catch-up")]
            assert metrics.snapshot()["counters"]["backfill.catchup_deliveries"] == 3
        finally:
            log.close()
    assert logs["port"] == logs["ref"] and len(logs["port"]) == 3
    assert (tmp_path / "port" / "deliveries.bin").read_bytes() == (tmp_path / "ref" / "deliveries.bin").read_bytes()


def test_runner_failure_is_a_typed_job_failure_as_in_the_reference(both):
    def broken(window, wpairs):
        raise RuntimeError("runner fell over")

    failures = []
    for make, world, metrics in ((_port_engine, both[0], Metrics()), (_ref_engine, both[1], RefMetrics())):
        engine = make(world, runner=broken, window_size=8, metrics=metrics)
        try:
            job = engine.submit(0, 16)
            with pytest.raises(Exception) as info:
                job.result(timeout=60)
            failures.append((type(info.value).__name__, str(info.value), _status(job),
                             metrics.snapshot()["counters"].get("backfill.window_failures")))
        finally:
            engine.close(timeout=30)
    assert failures[0] == failures[1]
    assert failures[0][0] == "BackfillError" and failures[0][2]["state"] == "failed"


def test_a_device_fault_stops_the_job_without_failing_it(both, tmp_path):
    """A window whose kernels fault: the job is ``faulted`` with
    ``error_type: device``, `result` re-raises the fault itself, nothing
    counts as a window failure, and the windows committed before it stay
    journalled — the identical re-submit resumes them and seals the
    uninterrupted bytes."""
    port_world, _ = both
    store, pairs, _ = port_world
    inner = port_bf.local_window_runner(store, _spec(), match_backend=CPU)

    def faulty(window, wpairs):
        if window.index == 2:
            raise DeviceFaultError("launch of event_match_mask_fp failed: unspecified launch failure")
        return inner(window, wpairs)

    m = Metrics()
    engine = _port_engine(port_world, runner=faulty, jobs_dir=str(tmp_path), window_size=4, metrics=m)
    try:
        job = engine.submit(0, N_PAIRS)
        with pytest.raises(DeviceFaultError):
            job.result(timeout=60)
    finally:
        engine.close(timeout=30)
    st = job.status()
    assert st["state"] == "faulted" and st["error_type"] == "device" and st["windows_done"] == 2
    assert "DeviceFaultError" in st["error"]
    counters = m.snapshot()["counters"]
    assert counters["backfill.device_faults"] == 1 and "backfill.window_failures" not in counters
    assert job.chunks_after(0)["state"] == "faulted"
    again, sealed = _run(_port_engine(port_world, jobs_dir=str(tmp_path), window_size=4))
    assert again.status()["windows_replayed"] == 2
    _, want = _run(_port_engine(port_world, window_size=4))
    assert sealed.to_json() == want.to_json()


# --- the HTTP door --------------------------------------------------------


def _daemon(world, jobs_dir, pkg):
    store, pairs, _ = world
    if pkg == "port":
        svc = ProofService(store=store, spec=_spec(), config=ServiceConfig(device="cpu", workers=1))
        engine = port_bf.BackfillEngine(
            pairs, _spec(), lambda w, p: svc.submit_range_window(p).result(),
            jobs_dir=jobs_dir, window_size=8, plane=svc.fetch_plane, metrics=svc.metrics,
        )
        return ProofHTTPServer(svc, pairs=pairs, backfill=engine).start()
    from ipc_proofs_tpu.serve.httpd import ProofHTTPServer as RefHTTPServer
    from ipc_proofs_tpu.serve.service import ProofService as RefService
    from ipc_proofs_tpu.serve.service import ServiceConfig as RefConfig

    svc = RefService(store=store, spec=_ref_spec(), config=RefConfig(workers=1))
    engine = ref_bf.BackfillEngine(
        pairs, _ref_spec(), lambda w, p: svc.submit_range_window(p).result(),
        jobs_dir=jobs_dir, window_size=8, plane=svc.fetch_plane, metrics=svc.metrics,
    )
    return RefHTTPServer(svc, pairs=pairs, backfill=engine).start()


@pytest.fixture
def daemons(both, tmp_path):
    servers = [_daemon(both[0], str(tmp_path / "port"), "port"), _daemon(both[1], str(tmp_path / "ref"), "ref")]
    yield servers
    for httpd in servers:
        httpd.shutdown(timeout=60)


def _poll_to_end(port, job_id):
    chunks, cursor = [], 0
    deadline = time.monotonic() + 300
    while time.monotonic() < deadline:
        status, _, out = get(port, f"/v1/backfill/{job_id}/chunks?cursor={cursor}&wait_s=10")
        assert status == 200, out
        chunks += out["chunks"]
        cursor = out["cursor"]
        if not out["chunks"] and out["state"] != "running":
            return chunks, out
    raise AssertionError("backfill job did not finish")


def test_http_submit_poll_and_stream_match_the_reference(daemons, both):
    (store, pairs, _), _ = both
    submitted = [post(d.port, "/v1/backfill", {"pair_start": 0, "pair_end": N_PAIRS}) for d in daemons]
    assert [s for s, _, _ in submitted] == [200, 200]
    port_st, ref_st = (strip({k: v for k, v in st.items() if k not in TIMES + ("windows_done", "epochs_done", "cursor", "state")}) for _, _, st in submitted)
    assert port_st == ref_st
    job_id = submitted[0][2]["job_id"]
    assert job_id == submitted[1][2]["job_id"]
    polled = [_poll_to_end(d.port, job_id) for d in daemons]
    assert polled[0][0] == polled[1][0] and polled[0][1] == polled[1][1]
    fold = port_gather.BundleFold(pairs, range(N_PAIRS))
    for chunk in polled[0][0]:
        fold.fold(UnifiedProofBundle.from_json_obj(chunk["bundle"]))
    whole = generate_event_proofs_for_range(store, pairs, _spec(), match_backend=CPU)
    assert fold.seal().to_json() == whole.to_json()
    # acked by the polls: the stream from cursor 0 carries metadata only;
    # a re-submit (journal replay) streams every window's blocks again
    streamed = []
    for d in daemons:
        status, hdrs, raw = request(d.port, "GET", f"/v1/backfill/{job_id}/chunks?cursor=0",
                                    headers={"Accept": STREAM_CONTENT_TYPE})
        assert status == 200 and hdrs["Content-Type"] == STREAM_CONTENT_TYPE
        streamed.append(raw)
    assert decode_bundle_stream_docs(streamed[0]) == ref_decode_docs(streamed[1])
    for path in ("/v1/backfill", f"/v1/backfill/{job_id}"):
        (ps, _, pb), (rs, _, rb) = (get(d.port, path) for d in daemons)
        assert ps == rs == 200

        def drop(obj):
            if isinstance(obj, dict):
                return {k: drop(v) for k, v in obj.items() if k not in TIMES}
            return [drop(v) for v in obj] if isinstance(obj, list) else obj

        assert drop(pb) == drop(rb)


def test_http_stream_of_a_resumed_job_folds_to_the_sealed_bundle(both, tmp_path):
    """The port's stream of fresh chunks decodes to the reference stream's
    documents, and folding its documents gives the sealed bundle."""
    (store, pairs, _), _ = both
    daemons = [_daemon(both[0], str(tmp_path / "p"), "port"), _daemon(both[1], str(tmp_path / "r"), "ref")]
    try:
        job_ids = [post(d.port, "/v1/backfill", {"pair_start": 0, "pair_end": 16})[2]["job_id"] for d in daemons]
        for d, job_id in zip(daemons, job_ids):
            deadline = time.monotonic() + 300
            while get(d.port, f"/v1/backfill/{job_id}")[2]["state"] == "running" and time.monotonic() < deadline:
                time.sleep(0.05)
        raws = [request(d.port, "GET", f"/v1/backfill/{j}/chunks?cursor=0", headers={"Accept": STREAM_CONTENT_TYPE})[2]
                for d, j in zip(daemons, job_ids)]
        docs = decode_bundle_stream_docs(raws[0])
        assert docs == ref_decode_docs(raws[1])
        fold = port_gather.BundleFold(pairs, range(16))
        for doc in docs[:-1]:
            fold.fold(UnifiedProofBundle.from_json_obj(doc["bundle"]))
        want = generate_event_proofs_for_range(store, pairs[:16], _spec(), match_backend=CPU)
        assert fold.seal().to_json() == want.to_json()
        assert docs[-1]["state"] == "complete"
    finally:
        for d in daemons:
            d.shutdown(timeout=60)


@pytest.mark.parametrize("body", [
    {"pair_start": 0}, {"pair_start": 3, "pair_end": 2}, {"pair_start": 0, "pair_end": N_PAIRS + 1},
    {"pair_start": True, "pair_end": 4}, {"pair_start": 0, "pair_end": 4, "window_size": 0},
    {"pair_start": 0, "pair_end": 4, "sub_id": 7},
], ids=["no-end", "reversed", "past-the-table", "bool-start", "window-0", "int-sub"])
def test_http_submit_refusals_match_the_reference(daemons, body):
    (ps, _, pb), (rs, _, rb) = (post(d.port, "/v1/backfill", body) for d in daemons)
    assert ps == rs == 400 and pb == rb


@pytest.mark.parametrize("path", ["/v1/backfill/bf-nope", "/v1/backfill/bf-nope/chunks?cursor=0"])
def test_http_unknown_job_matches_the_reference(daemons, path):
    (ps, _, pb), (rs, _, rb) = (get(d.port, path) for d in daemons)
    assert ps == rs == 404 and pb == rb


def test_http_bad_cursor_and_path_match_the_reference(daemons):
    job_id = [post(d.port, "/v1/backfill", {"pair_start": 0, "pair_end": 8})[2]["job_id"] for d in daemons][0]
    for path in (f"/v1/backfill/{job_id}/chunks?cursor=x", f"/v1/backfill/{job_id}/nope"):
        (ps, _, pb), (rs, _, rb) = (get(d.port, path) for d in daemons)
        assert (ps, pb) == (rs, rb) and ps in (400, 404)


def test_http_device_fault_is_a_500_and_a_device_abort_chunk(both, tmp_path, monkeypatch):
    """The service's mask faults on the card (injected into the cached CPU
    backend, unfused scan so the mask runs on it): the job is faulted, its
    status and its chunk poll answer 500 ``error_type: device``, and its
    stream ends in a ``device`` abort chunk."""
    monkeypatch.setenv("IPC_SCAN_FUSED_MATCH", "0")
    monkeypatch.setattr(CPU, "event_match_mask_fp", lambda *a, **k: (_ for _ in ()).throw(
        DeviceFaultError("launch of event_match_mask_fp failed: an illegal memory access")))
    httpd = _daemon(both[0], str(tmp_path), "port")
    try:
        status, _, st = post(httpd.port, "/v1/backfill", {"pair_start": 0, "pair_end": 8})
        assert status == 200
        job = httpd.backfill.job(st["job_id"])
        job.wait(timeout=60)
        status, _, body = get(httpd.port, f"/v1/backfill/{st['job_id']}")
        assert status == 500 and body["error_type"] == "device"
        status, _, body = get(httpd.port, f"/v1/backfill/{st['job_id']}/chunks?cursor=0")
        assert status == 500 and body["error_type"] == "device"
        status, _, raw = request(httpd.port, "GET", f"/v1/backfill/{st['job_id']}/chunks?cursor=0",
                                 headers={"Accept": STREAM_CONTENT_TYPE})
        assert status == 200
        with pytest.raises(StreamAbortError) as info:
            decode_bundle_stream_docs(raw)
        assert info.value.remote_error_type == "device"
        counters = httpd.service.metrics.snapshot()["counters"]
        assert counters["backfill.device_faults"] == 1 and "backfill.window_failures" not in counters
    finally:
        httpd.shutdown(timeout=60)


def test_shutdown_stops_slo_then_backfill_then_subs_then_service(both):
    order = []

    class _Rec:
        def __init__(self, name, method):
            setattr(self, method, lambda *a, **k: order.append(name))

    (store, pairs, _), _ = both
    svc = ProofService(store=store, spec=_spec(), config=ServiceConfig(device="cpu"))
    real_drain = svc.drain
    svc.drain = lambda *a, **k: (order.append("service"), real_drain(*a, **k))
    httpd = ProofHTTPServer(svc, pairs=pairs, slo=_Rec("slo", "stop"), backfill=_Rec("backfill", "close"),
                            subs=_Rec("subs", "drain")).start()
    httpd.shutdown(timeout=30)
    assert order == ["slo", "backfill", "subs", "service"]


# --- the LocalShard and router doors -----------------------------------------


def _shards(both, pkg, n, jobs_root=None):
    import ipc_proofs_tpu.cluster as ref_cluster
    import ipc_proofs_tpu_torch.cluster as port_cluster
    from ipc_proofs_tpu.serve.service import ServiceConfig as RefConfig

    store, pairs, _ = both[0] if pkg == "port" else both[1]
    cluster = port_cluster if pkg == "port" else ref_cluster
    spec, config = (_spec(), ServiceConfig(device="cpu")) if pkg == "port" else (_ref_spec(), RefConfig())
    return [
        cluster.LocalShard(
            f"bf{i}", store, pairs, spec, config=config,
            backfill_jobs_dir=os.path.join(jobs_root, f"bf{i}") if jobs_root else None, backfill_window_size=8,
        ).start()
        for i in range(n)
    ]


def _fold_polled(both, chunks):
    (store, pairs, _), _ = both
    fold = port_gather.BundleFold(pairs, range(N_PAIRS))
    for chunk in chunks:
        fold.fold(UnifiedProofBundle.from_json_obj(chunk["bundle"]))
    whole = generate_event_proofs_for_range(store, pairs, _spec(), match_backend=CPU)
    assert fold.seal().to_json() == whole.to_json()


def test_local_shard_door_matches_the_reference(both, tmp_path):
    """The reference's ``TestHTTPDoor`` over `LocalShard` with
    ``backfill_jobs_dir``: submit, poll to the end, fold, status, listing
    and an idempotent re-submit, equal in both packages."""
    shards = [_shards(both, pkg, 1, str(tmp_path / pkg))[0] for pkg in ("port", "ref")]
    try:
        ports = [s.httpd.port for s in shards]
        submitted = [post(p, "/v1/backfill", {"pair_start": 0, "pair_end": N_PAIRS})[2] for p in ports]
        job_id = submitted[0]["job_id"]
        assert submitted[1]["job_id"] == job_id and submitted[0]["windows_total"] == N_PAIRS // 8
        polled = [_poll_to_end(p, job_id) for p in ports]
        assert polled[0] == polled[1] and len(polled[0][0]) == N_PAIRS // 8
        assert polled[0][1]["state"] == "complete"
        _fold_polled(both, polled[0][0])
        for p in ports:
            status, _, st = get(p, f"/v1/backfill/{job_id}")
            assert status == 200 and st["state"] == "complete"
            status, _, listing = get(p, "/v1/backfill")
            assert status == 200 and [j["job_id"] for j in listing["jobs"]] == [job_id]
            status, _, again = post(p, "/v1/backfill", {"pair_start": 0, "pair_end": N_PAIRS})
            assert status == 200 and again["job_id"] == job_id
    finally:
        for s in shards:
            s.stop(timeout=60)


def test_local_shard_without_jobs_dir_answers_the_references_404s(both):
    shards = [_shards(both, pkg, 1)[0] for pkg in ("port", "ref")]
    try:
        answers = []
        for s in shards:
            answers.append((get(s.httpd.port, "/v1/backfill")[::2],
                            post(s.httpd.port, "/v1/backfill", {"pair_start": 0, "pair_end": 2})[::2]))
        assert answers[0] == answers[1]
        (status, body), _ = answers[0]
        assert status == 404 and "disabled" in body["error"]
    finally:
        for s in shards:
            s.stop(timeout=60)


def test_router_door_matches_the_reference(both, tmp_path):
    """``POST /v1/backfill`` through each package's router over two shards:
    the same job id and windows, chunks folding to the sealed bundle."""
    import ipc_proofs_tpu.cluster as ref_cluster
    import ipc_proofs_tpu_torch.cluster as port_cluster

    results = []
    for pkg, cluster in (("port", port_cluster), ("ref", ref_cluster)):
        shards = _shards(both, pkg, 2)
        pairs = (both[0] if pkg == "port" else both[1])[1]
        router = cluster.ClusterRouter({s.name: s.url for s in shards}, pairs, scrape_interval_s=60.0,
                                       backfill_jobs_dir=str(tmp_path / pkg), backfill_window_size=8)
        server = cluster.RouterHTTPServer(router).start()
        try:
            status, _, job = post(server.port, "/v1/backfill", {"pair_start": 0, "pair_end": N_PAIRS})
            assert status == 200
            chunks, last = _poll_to_end(server.port, job["job_id"])
            # two windows run at once: their commit order (the cursor) is the host's
            chunks = sorted(({k: v for k, v in c.items() if k != "cursor"} for c in chunks),
                            key=lambda c: c["window"]["index"])
            status, _, listing = get(server.port, "/v1/backfill")
            results.append((job["job_id"], job["windows_total"], chunks, last["state"],
                            [j["job_id"] for j in listing["jobs"]]))
        finally:
            server.shutdown(timeout=60)
            for s in shards:
                s.stop(timeout=60)
    assert results[0] == results[1]
    assert results[0][3] == "complete" and len(results[0][2]) == results[0][1] == N_PAIRS // 8
    _fold_polled(both, results[0][2])
