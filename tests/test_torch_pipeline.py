"""The port's host stage pipeline, fingerprint-mask coalescer, thread budget,
deadlines and lockdep, against the JAX package's.

- `run_pipeline`: input order under out-of-order completion, bounded-queue
  backpressure, error propagation without deadlock, ``drain_on_cancel``
  salvage, stage metrics, the caller's `CancelScope` on every worker;
  modelled on tests/test_pipeline_executor.py, whose classes become
  parametrised cases here.
- `MatchCoalescer`: its masks equal the JAX package's `MatchCoalescer` over
  the same seeded fingerprint arrays (numpy, seed 0), each over its own
  package's backend (the port's on ``device="cpu"``), called in sequence
  and from concurrent threads.
- `resolve_thread_budget` equals the reference's over a table of flags and
  env values.
"""

import dataclasses
import threading
import time

import numpy as np
import pytest

from ipc_proofs_tpu.backend import get_backend as ref_get_backend
from ipc_proofs_tpu.parallel.pipeline import MatchCoalescer as RefCoalescer
from ipc_proofs_tpu.proofs.scan_native import topic_fingerprint as ref_topic_fingerprint
from ipc_proofs_tpu.utils.metrics import Metrics as RefMetrics
from ipc_proofs_tpu.utils.threads import resolve_thread_budget as ref_resolve
from ipc_proofs_tpu_torch.backend import get_backend
from ipc_proofs_tpu_torch.parallel.pipeline import MatchCoalescer, PipelineStage, run_pipeline
from ipc_proofs_tpu_torch.utils import deadline, lockdep
from ipc_proofs_tpu_torch.utils.metrics import Metrics
from ipc_proofs_tpu_torch.utils.threads import resolve_thread_budget

BACKEND = get_backend("gpu", device="cpu")


def _run_with_deadline(fn, seconds=30.0):
    """Run fn on a thread with a join deadline: a deadlocked pipeline fails
    the test instead of hanging the suite."""
    out: dict = {}

    def target():
        try:
            out["result"] = fn()
        except BaseException as exc:  # noqa: BLE001 - handed back to the test thread
            out["exc"] = exc

    t = threading.Thread(target=target, daemon=True)
    t.start()
    t.join(seconds)
    assert not t.is_alive(), "pipeline deadlocked (join deadline hit)"
    if "exc" in out:
        raise out["exc"]
    return out["result"]


def _no_pipeline_threads_left():
    return not [t for t in threading.enumerate() if t.name.startswith("pipeline-") and t.is_alive()]


# --- ordering --------------------------------------------------------------


def _jitter(v):
    time.sleep(0.002 * (20 - v) if v < 20 else 0)
    return v


ORDERING = {
    "single_stage": (list(range(50)), [PipelineStage("x", lambda v: v * 2)], 2, [v * 2 for v in range(50)]),
    "multi_worker_jitter": (
        list(range(20)),
        [PipelineStage("jitter", _jitter, workers=4), PipelineStage("record", lambda v: v)],
        3,
        list(range(20)),
    ),
    "three_stages": (
        list(range(10)),
        [
            PipelineStage("a", lambda v: v + 1, workers=3),
            PipelineStage("b", lambda v: v * 10, workers=2),
            PipelineStage("c", lambda v: v - 5),
        ],
        1,
        [(v + 1) * 10 - 5 for v in range(10)],
    ),
    "empty": ([], [PipelineStage("x", lambda v: v)], 2, []),
    "more_workers_than_items": ([7], [PipelineStage("x", lambda v: v + 1, workers=8)], 1, [8]),
}


@pytest.mark.parametrize("case", sorted(ORDERING))
def test_ordering(case):
    items, stages, depth, expected = ORDERING[case]
    assert _run_with_deadline(lambda: run_pipeline(items, stages, depth=depth)) == expected
    assert _no_pipeline_threads_left()


def test_downstream_stage_sees_input_order():
    seen = []
    run_pipeline(
        list(range(20)),
        [PipelineStage("jitter", _jitter, workers=4), PipelineStage("record", lambda v: seen.append(v) or v)],
        depth=3,
    )
    assert seen == list(range(20))


def test_no_stages_raises():
    with pytest.raises(ValueError):
        run_pipeline([1, 2], [])


# --- backpressure ----------------------------------------------------------


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_bounded_depth_limits_readahead(depth):
    """A fast producer runs at most depth + workers items ahead of a slow
    consumer: 1 in the producer, ``depth`` buffered, 1 in the consumer (+1
    slack)."""
    lock = threading.Lock()
    produced: list = []
    consumed: list = []
    max_lead = 0

    def produce(v):
        nonlocal max_lead
        with lock:
            produced.append(v)
            max_lead = max(max_lead, len(produced) - len(consumed))
        return v

    def consume(v):
        time.sleep(0.003)
        with lock:
            consumed.append(v)
        return v

    run_pipeline(
        list(range(30)), [PipelineStage("fast", produce), PipelineStage("slow", consume)], depth=depth
    )
    assert max_lead <= depth + 3
    assert consumed == list(range(30))


# --- error propagation -----------------------------------------------------


class Boom(RuntimeError):
    pass


def _boom_at_7(v):
    if v == 7:
        raise Boom("worker died")
    return v


def _slow_fail(v):
    time.sleep(0.01)
    raise ValueError("sink failed")


def _key_error(v):
    raise KeyError(v)


ERRORS = {
    "worker_exception": (
        list(range(100)),
        [PipelineStage("scan", _boom_at_7, workers=4), PipelineStage("record", lambda v: v)],
        2, Boom, "worker died",
    ),
    # a failure in the LAST stage must unwedge producers blocked on the
    # bounded queue (the classic pipeline deadlock)
    "downstream_cancels_blocked_producers": (
        list(range(200)),
        [PipelineStage("produce", lambda v: bytes(1000), workers=2), PipelineStage("sink", _slow_fail)],
        1, ValueError, "sink failed",
    ),
    "first_exception_wins": (list(range(10)), [PipelineStage("boom", _key_error, workers=3)], 2, KeyError, None),
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_error_propagation(case):
    items, stages, depth, exc_type, match = ERRORS[case]

    def run():
        with pytest.raises(exc_type, match=match):
            run_pipeline(items, stages, depth=depth)

    _run_with_deadline(run)
    assert _no_pipeline_threads_left()


# --- drain_on_cancel ---------------------------------------------------------


def _drain_case(kind):
    """Scan fails after the sink started; returns (items, scan, sink, flag,
    expected exception, what the sink ran)."""
    gate = threading.Event()
    ran: list = []
    if kind == "salvage":

        def scan(v):
            if v == 6:
                gate.wait(10)
                raise RuntimeError("scan died")
            return v

        def sink(v):
            ran.append(v)
            gate.set()  # the sink is alive: now fail scan
            time.sleep(0.05)  # pin the worker so later items stay queued
            return v

        return list(range(7)), scan, sink, True, (RuntimeError, "scan died"), ran
    if kind == "no_drain_without_flag":

        def scan(v):
            if v == 0:
                return v
            gate.wait(10)
            raise RuntimeError("boom")

        def sink(v):
            ran.append(v)
            gate.set()
            time.sleep(0.2)  # keep the worker busy past the cancellation
            return v

        return list(range(6)), scan, sink, False, (RuntimeError, "boom"), ran

    def scan(v):
        if v == 3:
            gate.wait(10)
            raise KeyError("original")
        return v

    def sink(v):
        ran.append(v)
        gate.set()
        time.sleep(0.05)
        if v > 0:
            raise ValueError("sink broken during drain")
        return v

    return list(range(4)), scan, sink, True, (KeyError, "original"), ran


@pytest.mark.parametrize("kind", ["salvage", "no_drain_without_flag", "drain_swallows_sink_errors"])
def test_drain_on_cancel(kind):
    items, scan, sink, flag, (exc_type, match), ran = _drain_case(kind)

    def run():
        with pytest.raises(exc_type, match=match):
            run_pipeline(
                items,
                [PipelineStage("scan", scan, workers=2), PipelineStage("sink", sink, drain_on_cancel=flag)],
                depth=4,
            )

    _run_with_deadline(run)
    assert ran and ran[0] == 0
    if kind == "salvage":
        assert ran == sorted(ran)  # what was queued ran, in order
    elif kind == "no_drain_without_flag":
        assert len(ran) <= 2  # nothing salvaged beyond what was in flight


# --- metrics -------------------------------------------------------------------


def test_stage_timers_and_overlap_efficiency():
    m = Metrics()
    run_pipeline(
        list(range(8)),
        [
            PipelineStage("a", lambda v: time.sleep(0.005) or v, workers=4, metrics_stage="pipe_a"),
            PipelineStage("b", lambda v: v, metrics_stage="pipe_b"),
        ],
        depth=2,
        metrics=m,
    )
    snap = m.snapshot()
    assert snap["timers"]["pipe_a"]["calls"] == snap["timers"]["pipe_b"]["calls"] == 8
    # 4 workers sleeping concurrently: busy exceeds the stage's union wall
    assert snap["timers"]["pipe_a"]["total_s"] > snap["timers"]["pipe_a"]["wall_s"]
    assert snap["overlap_efficiency"] > 1.0
    assert m.stage_s["pipe_a"] == pytest.approx(snap["timers"]["pipe_a"]["total_s"], abs=1e-5)


@pytest.mark.parametrize("package", ["port", "reference"])
def test_metrics_stage_reentry_counts_outermost_only(package):
    m = Metrics() if package == "port" else RefMetrics()
    with m.stage("s"):
        with m.stage("s"):
            time.sleep(0.002)
    m.count("c", 2)
    m.set_gauge("g", 3)
    snap = m.snapshot()
    assert snap["timers"]["s"]["calls"] == 1
    assert snap["counters"] == {"c": 2} and snap["gauges"] == {"g": 3}
    assert m.counter_value("c") == 2 and m.overlap_efficiency() == pytest.approx(1.0, rel=0.05)


# --- deadlines -------------------------------------------------------------


def test_cancel_scope_hops_to_every_worker():
    scope = deadline.CancelScope()
    seen = []

    def stage(v):
        seen.append(deadline.current_scope() is scope)
        if v == 3:
            scope.cancel("client went away")
        deadline.checkpoint("test")
        return v

    def run():
        with deadline.use_scope(scope), pytest.raises(deadline.CancelledError, match="client went away"):
            run_pipeline(list(range(50)), [PipelineStage("s", stage, workers=3), PipelineStage("t", lambda v: v)])

    _run_with_deadline(run)
    assert seen and all(seen) and len(seen) < 50
    assert deadline.current_scope() is None


def test_expired_deadline_raises_typed():
    scope = deadline.CancelScope(deadline.Deadline(0.0))
    with deadline.use_scope(scope), pytest.raises(deadline.DeadlineError):
        run_pipeline([1, 2], [PipelineStage("s", lambda v: v)])
    assert deadline.remaining_budget_s(7.0) == 7.0
    with deadline.use_scope(deadline.CancelScope(deadline.Deadline.from_ms(60_000))):
        assert 0 < deadline.remaining_budget_s() <= 60


# --- MatchCoalescer ----------------------------------------------------------

T0, T1 = b"\x11" * 32, b"\x22" * 32
KEYS = [(T0, T1, 7), (T0, T1, None), (T0, b"\x33" * 32, 7)]


def _fp_requests(n_requests=6, seed=0):
    """Seeded fingerprint arrays: about a quarter of the rows carry a
    key's target fingerprint."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n_requests):
        key = KEYS[k % len(KEYS)]
        n = int(rng.integers(1, 400))
        fp = rng.integers(0, 2**63, size=n, dtype=np.uint64)
        hit = rng.random(n) < 0.25
        fp[hit] = ref_topic_fingerprint(key[0], key[1])
        n_topics = rng.integers(0, 4, size=n).astype(np.int32)
        emitters = rng.integers(6, 9, size=n).astype(np.uint64)
        valid = rng.random(n) < 0.9
        out.append((fp, n_topics, emitters, valid, key))
    return out


def _masks(coalescer_cls, backend, requests, metrics, concurrent):
    coalescer = coalescer_cls(backend, metrics=metrics)
    results: dict = {}

    def call(i):
        fp, n_topics, emitters, valid, key = requests[i]
        results[i] = np.asarray(coalescer.match_fp(fp, n_topics, emitters, valid, *key))[: len(fp)]

    if concurrent:
        threads = [threading.Thread(target=call, args=(i,)) for i in range(len(requests))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(15)
            assert not t.is_alive(), "coalescer deadlocked"
    else:
        for i in range(len(requests)):
            call(i)
    return [results[i] for i in range(len(requests))]


@pytest.mark.parametrize("concurrent", [False, True], ids=["sequential", "threads"])
def test_coalescer_masks_equal_reference(concurrent):
    requests = _fp_requests()
    ours = _masks(MatchCoalescer, BACKEND, requests, Metrics(), concurrent)
    ref = _masks(RefCoalescer, ref_get_backend("cpu"), requests, RefMetrics(), concurrent)
    for i, (a, b) in enumerate(zip(ours, ref)):
        assert np.array_equal(a, b), i
        fp, n_topics, emitters, valid, key = requests[i]
        direct = BACKEND.event_match_mask_fp(fp, n_topics, emitters, valid, *key)
        assert np.array_equal(a, direct), i
    assert any(m.any() for m in ours) and not all(m.all() for m in ours)


def test_batched_run_splits_identically_and_counts_like_reference():
    """One call per key over the concatenation, split at input offsets:
    the same masks as the reference's coalescer and the same coalescing
    count (the reference also counts the XLA retraces of its padded
    dispatch shapes, which the port's unpadded dispatch does not have)."""
    from ipc_proofs_tpu.parallel.pipeline import _MatchReq as RefReq
    from ipc_proofs_tpu_torch.parallel.pipeline import _MatchReq

    requests = _fp_requests(7, seed=0)
    ours, ref = Metrics(), RefMetrics()
    port_reqs = [_MatchReq(*r) for r in requests]
    ref_reqs = [RefReq(*r) for r in requests]
    MatchCoalescer(BACKEND, metrics=ours)._run(list(port_reqs))
    RefCoalescer(ref_get_backend("cpu"), metrics=ref)._run(list(ref_reqs))
    for a, b in zip(port_reqs, ref_reqs):
        assert a.done.is_set() and a.exc is None
        assert np.array_equal(np.asarray(a.result), np.asarray(b.result))
    ref_counters = dict(ref.snapshot()["counters"])
    ref_counters.pop("range_match_retraces")
    assert ours.snapshot()["counters"] == ref_counters
    assert ours.counter_value("range_match_coalesced") == len(requests) - len(KEYS)


def test_concurrent_callers_coalesce():
    """The first caller holds the device call until three more have
    parked, so one follower-leader claims all three in one call."""
    requests = _fp_requests(4, seed=0)
    requests = [(fp, nt, em, va, KEYS[0]) for fp, nt, em, va, _ in requests]
    holder: dict = {}
    calls: list = []

    class Backend:
        def event_match_mask_fp(self, fp, *args):
            calls.append(len(fp))
            if len(calls) == 1:
                deadline_at = time.time() + 10
                while len(holder["c"]._pending) < 3 and time.time() < deadline_at:
                    time.sleep(0.001)
            return BACKEND.event_match_mask_fp(fp, *args)

    m = Metrics()
    coalescer = holder["c"] = MatchCoalescer(Backend(), metrics=m)
    results: dict = {}

    def call(i):
        fp, n_topics, emitters, valid, key = requests[i]
        results[i] = coalescer.match_fp(fp, n_topics, emitters, valid, *key)[: len(fp)]

    threads = [threading.Thread(target=call, args=(i,)) for i in range(4)]
    threads[0].start()
    deadline_at = time.time() + 10
    while not calls and time.time() < deadline_at:
        time.sleep(0.001)
    for t in threads[1:]:
        t.start()
    for t in threads:
        t.join(15)
        assert not t.is_alive(), "coalescer deadlocked"
    for i, (fp, n_topics, emitters, valid, key) in enumerate(requests):
        assert np.array_equal(results[i], BACKEND.event_match_mask_fp(fp, n_topics, emitters, valid, *key))
    # unpadded: the lone call, then the other three concatenated
    assert calls == [len(requests[0][0]), sum(len(r[0]) for r in requests[1:])]
    assert m.counter_value("range_match_coalesced") == 2


def test_backend_exception_reaches_every_waiter():
    from ipc_proofs_tpu_torch.parallel.pipeline import _MatchReq

    class Broken:
        def event_match_mask_fp(self, *args):
            raise RuntimeError("device fell over")

    requests = _fp_requests(2)
    reqs = [_MatchReq(*r[:4], KEYS[0]) for r in requests]
    coalescer = MatchCoalescer(Broken())
    coalescer._run(list(reqs))
    assert all(isinstance(r.exc, RuntimeError) and r.done.is_set() for r in reqs)
    with pytest.raises(RuntimeError, match="device fell over"):
        coalescer.match_fp(*requests[0][:4], *KEYS[0])


@pytest.mark.parametrize("n", [0, 1, 255, 256, 257, 4096, 5000])
def test_dispatch_is_unpadded(n):
    """Each dispatch reaches the backend at its own length (no filler
    rows), and its mask equals the reference coalescer's."""
    rng = np.random.default_rng(n)
    key = KEYS[0]
    fp = rng.integers(0, 2**63, size=n, dtype=np.uint64)
    fp[rng.random(n) < 0.25] = ref_topic_fingerprint(key[0], key[1])
    args = (fp, rng.integers(0, 4, size=n).astype(np.int32),
            rng.integers(6, 9, size=n).astype(np.uint64), rng.random(n) < 0.9)
    seen: list = []

    class Recording:
        def event_match_mask_fp(self, fp, *rest):
            seen.append(len(fp))
            return BACKEND.event_match_mask_fp(fp, *rest)

    ours = MatchCoalescer(Recording()).match_fp(*args, *key)
    ref = RefCoalescer(ref_get_backend("cpu")).match_fp(*args, *key)
    assert seen == [n]
    assert np.array_equal(np.asarray(ours), np.asarray(ref)[:n])


# --- the thread budget ---------------------------------------------------------

BUDGETS = [
    # (threads flag, scan_threads flag, env)
    (None, None, {}),
    (6, None, {"IPC_THREADS": "3", "IPC_SCAN_THREADS": "2"}),
    (None, None, {"IPC_THREADS": "5", "IPC_SCAN_THREADS": "2"}),
    (None, 3, {"IPC_SCAN_THREADS": "7"}),
    (None, None, {"IPC_SCAN_THREADS": "7"}),
    (None, None, {"IPC_THREADS": "many"}),
    (8, 2, {}),
    (1, None, {}),
    (2, None, {}),
    (3, None, {}),
    (7, None, {}),
    (8, None, {}),
    (500, None, {}),
    (0, 0, {"IPC_THREADS": "-2"}),
    (None, 100, {}),
]


@pytest.mark.parametrize("threads,scan_threads,env", BUDGETS)
def test_thread_budget_equals_reference(threads, scan_threads, env):
    ours = resolve_thread_budget(threads=threads, scan_threads=scan_threads, env=env, log=False)
    ref = ref_resolve(threads=threads, scan_threads=scan_threads, env=env, log=False)
    assert dataclasses.astuple(ours) == dataclasses.astuple(ref)
    assert 1 <= ours.total <= 64
    if scan_threads is None:  # the oversubscription fix
        assert ours.scan_workers * ours.native_scan_threads <= ours.total


# --- lockdep -------------------------------------------------------------------


def test_lockdep_tracks_the_port_locks():
    """With lockdep on, the port's new locks are tracked and the coalescer's
    nesting is witnessed in its declared order."""
    lockdep.enable(strict=True)
    lockdep.reset()
    try:
        m = Metrics()
        assert type(m._lock).__name__ == "_TrackedLock"
        _masks(MatchCoalescer, BACKEND, _fp_requests(3), m, concurrent=False)
        # a leader's coalesced dispatch counts under its call lock
        from ipc_proofs_tpu_torch.parallel.pipeline import _MatchReq

        coalescer = MatchCoalescer(BACKEND, metrics=m)
        with coalescer._call_lock:
            coalescer._run([_MatchReq(*r[:4], KEYS[0]) for r in _fp_requests(3)])
        graph = lockdep.order_graph()
    finally:
        lockdep.disable()
    assert ("MatchCoalescer._call_lock", "MatchCoalescer._lock") in graph
    assert ("MatchCoalescer._call_lock", "Metrics._lock") in graph
    assert not lockdep.violations()
