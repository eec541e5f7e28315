"""The port's stage-overlapped range drivers against the JAX package's.

- The native scanner's per-call ``threads`` (restored in the port's copy of
  ``scan_ext.c``) gives arrays and hits identical to the JAX package's
  extension at 1, 2 and 8 threads.
- Over scan_threads {1, 4} × pipeline depth {1, 3} × chunk {1, 7, 512},
  fused and unfused (``IPC_SCAN_FUSED_MATCH=0``), with and without
  ``storage_specs``: the port's pipelined and overlapped bundles
  (``to_json()``) equal the JAX package's chunked and pipelined bundles on
  the same ``build_range_world``, and the overlapped driver's per-chunk
  verdicts, concatenated, equal whole-bundle verification (the port's and
  the reference's).
- Record/verify worker grids on a ``build_chain`` world with real slot
  values, the thread-budget knob, the single-core fallback, worker
  failures (no deadlock; the original exception re-raised), metrics.

The port runs on ``get_backend("gpu", device="cpu")`` (the kernels' plain
versions), the reference on its ``cpu`` backend; every driver call passes
``force_pipeline=True`` so a one-core host still runs the threaded executor.
"""

import threading

import numpy as np
import pytest

import ipc_proofs_tpu.fixtures as ref_fixtures
from ipc_proofs_tpu.backend import get_backend as ref_get_backend
from ipc_proofs_tpu.backend.native import load_scan_ext as ref_load_scan
from ipc_proofs_tpu.proofs import range as ref_range
from ipc_proofs_tpu.proofs.generator import EventProofSpec as RefSpec
from ipc_proofs_tpu.proofs.scan_native import scan_events_flat as ref_scan_flat
from ipc_proofs_tpu.proofs.scan_native import scan_match_hits as ref_scan_hits
from ipc_proofs_tpu.proofs.storage_batch import MappingSlotSpec as RefSlotSpec
from ipc_proofs_tpu.proofs.trust import TrustPolicy
from ipc_proofs_tpu.proofs.verifier import verify_proof_bundle as ref_verify
from ipc_proofs_tpu.store.blockstore import MemoryBlockstore as RefMemoryBlockstore
import ipc_proofs_tpu_torch.fixtures as fixtures
import ipc_proofs_tpu_torch.proofs.range as range_mod
from ipc_proofs_tpu_torch.backend import get_backend
from ipc_proofs_tpu_torch.backend.native import load_scan_ext
from ipc_proofs_tpu_torch.proofs.generator import EventProofSpec
from ipc_proofs_tpu_torch.proofs.range import (
    TipsetPair,
    generate_and_verify_range_overlapped,
    generate_event_proofs_for_range_chunked,
    generate_event_proofs_for_range_pipelined,
)
from ipc_proofs_tpu_torch.proofs.scan_native import scan_events_flat, scan_match_hits
from ipc_proofs_tpu_torch.proofs.storage_batch import MappingSlotSpec
from ipc_proofs_tpu_torch.proofs.trust import TrustPolicy as PortTrustPolicy
from ipc_proofs_tpu_torch.proofs.verifier import verify_proof_bundle
from ipc_proofs_tpu_torch.state.events import ascii_to_bytes32, hash_event_signature
from ipc_proofs_tpu_torch.state.storage import calculate_storage_slot
from ipc_proofs_tpu_torch.store.blockstore import MemoryBlockstore
from ipc_proofs_tpu_torch.store.failover import DegradedError
from ipc_proofs_tpu_torch.store.rpc import IntegrityError
from ipc_proofs_tpu_torch.utils.metrics import Metrics

SIG, TOPIC1, ACTOR = "NewTopDownMessage(bytes32,uint256)", "calib-subnet-1", 1001
WORLD = dict(n_pairs=9, receipts_per_pair=6, events_per_receipt=3, match_rate=0.25)
STORAGE_SPECS = [(ACTOR, TOPIC1, 0), (ACTOR, "calib-subnet-2", 1)]
BACKEND = get_backend("gpu", device="cpu")


@pytest.fixture(scope="module")
def worlds():
    store, pairs, n_matching = fixtures.build_range_world(**WORLD)
    ref_store, ref_pairs, _ = ref_fixtures.build_range_world(**WORLD)
    assert n_matching > 2
    return store, pairs, n_matching, ref_store, ref_pairs


def _port_specs(with_storage):
    return [MappingSlotSpec(*s) for s in STORAGE_SPECS] if with_storage else None


def _ref_specs(with_storage):
    return [RefSlotSpec(*s) for s in STORAGE_SPECS] if with_storage else None


# --- the scanner's per-call threads ---------------------------------------------


@pytest.fixture(scope="module")
def scan_worlds():
    """Enough roots (≥ 64 and ≥ 2 × threads) for the scanner to fan out."""
    shape = dict(n_pairs=80, receipts_per_pair=3, events_per_receipt=2, match_rate=0.2)
    store, pairs, _ = fixtures.build_range_world(**shape)
    ref_store, ref_pairs, _ = ref_fixtures.build_range_world(**shape)
    roots = [p.child.blocks[0].parent_message_receipts for p in pairs]
    ref_roots = [p.child.blocks[0].parent_message_receipts for p in ref_pairs]
    return store, roots, ref_store, ref_roots


def test_scanner_takes_the_threads_keyword():
    ext, ref = load_scan_ext(), ref_load_scan()
    assert ext.SCAN_BATCH_THREADS_KW == ref.SCAN_BATCH_THREADS_KW == 1
    for threads in (None, 3):  # None keeps the scanner's default fan-out
        assert ext.scan_events_batch({}, [], None, threads=threads)["n_events"] == 0
    with pytest.raises(TypeError):
        ext.scan_events_batch({}, [], None, threads="eight")


@pytest.mark.parametrize("threads", [1, 2, 8])
def test_scanner_threads_equal_reference(scan_worlds, threads):
    store, roots, ref_store, ref_roots = scan_worlds
    ours = scan_events_flat(store, roots, want_payload=True, threads=threads)
    ref = ref_scan_flat(ref_store, ref_roots, want_payload=True, threads=threads)
    default = scan_events_flat(store, roots, want_payload=True)
    assert ours.n_events == ref.n_events == default.n_events == 80 * 3 * 2
    for name in ("topics", "fp", "n_topics", "emitters", "valid", "pair_ids", "exec_idx",
                 "event_idx", "topics_off", "data_off", "data_len"):
        assert np.array_equal(getattr(ours, name), getattr(ref, name)), name
        assert np.array_equal(getattr(ours, name), getattr(default, name)), name
    assert ours.topics_pool == ref.topics_pool and ours.data_pool == ref.data_pool
    t0, t1 = hash_event_signature(SIG), ascii_to_bytes32(TOPIC1)
    n, hp, he = scan_match_hits(store, roots, t0, t1, ACTOR, threads=threads)
    rn, rhp, rhe = ref_scan_hits(ref_store, ref_roots, t0, t1, ACTOR, threads=threads)
    assert n == rn and np.array_equal(hp, rhp) and np.array_equal(he, rhe) and len(hp) > 0


# --- the differential grid -----------------------------------------------------

_REFERENCE: dict = {}


def _reference(worlds, chunk_size, with_storage):
    """The JAX package's chunked and pipelined bundles (equal to each other)
    and its whole-bundle verdicts, once per (chunk size, storage)."""
    key = (chunk_size, with_storage)
    if key not in _REFERENCE:
        _, _, _, ref_store, ref_pairs = worlds
        kw = dict(
            chunk_size=chunk_size, match_backend=ref_get_backend("cpu"),
            storage_specs=_ref_specs(with_storage),
        )
        chunked = ref_range.generate_event_proofs_for_range_chunked(
            ref_store, ref_pairs, RefSpec(SIG, TOPIC1, ACTOR), **kw
        )
        piped = ref_range.generate_event_proofs_for_range_pipelined(
            ref_store, ref_pairs, RefSpec(SIG, TOPIC1, ACTOR), scan_threads=2, force_pipeline=True, **kw
        )
        assert piped.to_json() == chunked.to_json()
        verdicts = ref_verify(chunked, TrustPolicy.accept_all()).event_results
        _REFERENCE[key] = (chunked.to_json(), verdicts)
    return _REFERENCE[key]


class _CountingBackend:
    """The CPU backend, counting fingerprint-mask calls."""

    def __init__(self):
        self.mask_calls = 0
        self._lock = threading.Lock()

    def __getattr__(self, name):
        return getattr(BACKEND, name)

    def event_match_mask_fp(self, *args):
        with self._lock:
            self.mask_calls += 1
        return BACKEND.event_match_mask_fp(*args)


def _verify_chunk(bundle):
    return verify_proof_bundle(bundle, PortTrustPolicy.accept_all(), cid_backend=BACKEND).event_results


@pytest.mark.parametrize("with_storage", [False, True], ids=["events", "events+storage"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("chunk_size", [1, 7, 512])
@pytest.mark.parametrize("pipeline_depth", [1, 3])
@pytest.mark.parametrize("scan_threads", [1, 4])
def test_pipelined_and_overlapped_equal_reference(
    worlds, monkeypatch, scan_threads, pipeline_depth, chunk_size, fused, with_storage
):
    store, pairs, n_matching, _, _ = worlds
    ref_json, ref_verdicts = _reference(worlds, chunk_size, with_storage)
    if not fused:
        monkeypatch.setenv("IPC_SCAN_FUSED_MATCH", "0")
    kw = dict(
        chunk_size=chunk_size, match_backend=BACKEND, storage_specs=_port_specs(with_storage),
        scan_threads=scan_threads, pipeline_depth=pipeline_depth, force_pipeline=True,
    )
    metrics = Metrics()
    counting = _CountingBackend()
    piped = generate_event_proofs_for_range_pipelined(
        store, pairs, EventProofSpec(SIG, TOPIC1, ACTOR), metrics=metrics,
        **dict(kw, match_backend=counting),
    )
    assert piped.to_json() == ref_json
    merged, chunk_verdicts = generate_and_verify_range_overlapped(
        store, pairs, EventProofSpec(SIG, TOPIC1, ACTOR), verify_chunk=_verify_chunk, **kw
    )
    assert merged.to_json() == ref_json
    flat = [v for chunk in chunk_verdicts for v in chunk]
    assert flat == _verify_chunk(merged) == ref_verdicts
    assert all(flat) and len(flat) == n_matching
    assert len(chunk_verdicts) == -(-len(pairs) // chunk_size)
    assert metrics.counters["range_proofs"] == n_matching
    assert metrics.counter_value("range_pipeline_serial_fallback") == 0
    # the unfused scan ran the mask, at most once a chunk (coalesced calls
    # are fewer); the fused scan folds it into the C walk
    n_chunks = -(-len(pairs) // chunk_size)
    assert (1 <= counting.mask_calls <= n_chunks) if not fused else counting.mask_calls == 0


@pytest.mark.parametrize("chunk_size", [1, 7])
def test_chunked_equals_reference(worlds, chunk_size):
    store, pairs, _, _, _ = worlds
    ref_json, _ = _reference(worlds, chunk_size, True)
    ours = generate_event_proofs_for_range_chunked(
        store, pairs, EventProofSpec(SIG, TOPIC1, ACTOR), chunk_size=chunk_size,
        match_backend=BACKEND, storage_specs=_port_specs(True),
    )
    assert ours.to_json() == ref_json


@pytest.mark.parametrize("artifact", ["checkpoint", "journal", "both"])
def test_chunked_refuses_event_only_chunks_of_the_pipelined_driver(worlds, tmp_path, artifact):
    """The pipelined driver checkpoints and journals event proofs only; the
    chunked driver resuming them with storage specs raises instead of
    dropping the storage proofs. Without storage specs it resumes them."""
    store, pairs, _, _, _ = worlds
    spec = EventProofSpec(SIG, TOPIC1, ACTOR)
    for storage in (True, False):
        # a job dir is bound to one request: one dir per storage setting
        where = tmp_path / f"{artifact}-{storage}"
        dirs = {
            "checkpoint": {"checkpoint_dir": str(where)},
            "journal": {"job_dir": str(where)},
            "both": {"checkpoint_dir": str(where / "ckpt"), "job_dir": str(where / "job")},
        }[artifact]
        kw = dict(chunk_size=4, match_backend=BACKEND, storage_specs=_port_specs(storage), **dirs)
        piped = generate_event_proofs_for_range_pipelined(
            store, pairs, spec, scan_threads=2, force_pipeline=True, **kw
        )
        if storage:
            with pytest.raises(ValueError, match="storage proofs"):
                generate_event_proofs_for_range_chunked(store, pairs, spec, **kw)
        else:
            metrics = Metrics()
            chunked = generate_event_proofs_for_range_chunked(store, pairs, spec, metrics=metrics, **kw)
            assert chunked.to_json() == piped.to_json()
            assert metrics.counter_value("range_chunks_resumed") == 3


# --- worker grids on a build_chain world ---------------------------------------

PIPE_SUBNET, PIPE_ACTOR = "pipe-subnet", 777


def _chain_range(package, n_pairs=5):
    """``n_pairs`` build_chain worlds in one store, one slot value each."""
    if package == "port":
        fx, store, pair_cls = fixtures, MemoryBlockstore(), TipsetPair
    else:
        fx, store, pair_cls = ref_fixtures, RefMemoryBlockstore(), ref_range.TipsetPair
    pairs = []
    for p in range(n_pairs):
        events = [
            [fx.EventFixture(emitter=PIPE_ACTOR, signature=SIG, topic1=PIPE_SUBNET,
                             data=p.to_bytes(32, "big"))] if p % 2 == 0 else [],
            [fx.EventFixture(emitter=PIPE_ACTOR, signature="Noise()", topic1=PIPE_SUBNET)],
        ]
        world = fx.build_chain(
            [fx.ContractFixture(
                actor_id=PIPE_ACTOR, storage={calculate_storage_slot("subnet-x", 0): bytes([p + 1])}
            )],
            events, parent_height=100 + 2 * p, store=store,
        )
        pairs.append(pair_cls(parent=world.parent, child=world.child))
    return store, pairs


@pytest.fixture(scope="module")
def chain_worlds():
    store, pairs = _chain_range("port")
    ref_store, ref_pairs = _chain_range("reference")
    ref = ref_range.generate_event_proofs_for_range_chunked(
        ref_store, ref_pairs, RefSpec(SIG, PIPE_SUBNET, PIPE_ACTOR), chunk_size=2,
        match_backend=ref_get_backend("cpu"),
        storage_specs=[RefSlotSpec(PIPE_ACTOR, "subnet-x", 0)],
    )
    return store, pairs, ref


@pytest.mark.parametrize("verify_workers", [1, 2])
@pytest.mark.parametrize("record_workers", [1, 3])
def test_worker_grid_with_storage_values(chain_worlds, record_workers, verify_workers):
    store, pairs, ref = chain_worlds
    results: list = []
    piped = generate_event_proofs_for_range_pipelined(
        store, pairs, EventProofSpec(SIG, PIPE_SUBNET, PIPE_ACTOR), chunk_size=2,
        match_backend=BACKEND, storage_specs=[MappingSlotSpec(PIPE_ACTOR, "subnet-x", 0)],
        record_workers=record_workers, verify_workers=verify_workers, scan_threads=2,
        verify_chunk=lambda b: len(b.event_proofs), verify_results=results, force_pipeline=True,
    )
    assert piped.to_json() == ref.to_json()
    assert [int(p.value, 16) for p in piped.storage_proofs] == [1, 2, 3, 4, 5]
    assert results == [1, 1, 1] and sum(results) == len(piped.event_proofs) == 3
    assert verify_proof_bundle(
        piped, PortTrustPolicy.accept_all(), verify_witness_cids=True, cid_backend=BACKEND
    ).all_valid()


def test_threads_knob_drives_workers(worlds):
    store, pairs, _, _, _ = worlds
    ref_json, _ = _reference(worlds, 7, False)
    piped = generate_event_proofs_for_range_pipelined(
        store, pairs, EventProofSpec(SIG, TOPIC1, ACTOR), chunk_size=7, match_backend=BACKEND,
        threads=4, force_pipeline=True,
    )
    assert piped.to_json() == ref_json


def test_single_core_host_runs_inline_and_counts_it(worlds, monkeypatch):
    store, pairs, _, _, _ = worlds
    ref_json, ref_verdicts = _reference(worlds, 7, True)
    monkeypatch.setattr(range_mod.os, "cpu_count", lambda: 1)
    monkeypatch.delenv("IPC_FORCE_PIPELINE", raising=False)
    metrics = Metrics()
    before = {t.name for t in threading.enumerate()}
    merged, chunk_verdicts = generate_and_verify_range_overlapped(
        store, pairs, EventProofSpec(SIG, TOPIC1, ACTOR), chunk_size=7, verify_chunk=_verify_chunk,
        match_backend=BACKEND, metrics=metrics, storage_specs=_port_specs(True),
    )
    assert merged.to_json() == ref_json
    assert [v for c in chunk_verdicts for v in c] == ref_verdicts
    assert metrics.counters["range_pipeline_serial_fallback"] == 1
    assert not {t.name for t in threading.enumerate()} - before


def test_empty_range(worlds):
    store, _, _, _, _ = worlds
    spec = EventProofSpec(SIG, TOPIC1, ACTOR)
    bundle = generate_event_proofs_for_range_pipelined(
        store, [], spec, match_backend=BACKEND, scan_threads=4, pipeline_depth=3, force_pipeline=True
    )
    assert bundle.event_proofs == [] and bundle.blocks == []
    results: list = []
    bundle = generate_event_proofs_for_range_pipelined(
        store, [], spec, match_backend=BACKEND, verify_chunk=lambda b: ["ran"],
        verify_results=results, force_pipeline=True,
    )
    assert bundle.event_proofs == [] and results == []


# --- worker failures -------------------------------------------------------------


def _drive_with_deadline(fn, seconds=30.0):
    out: dict = {}

    def target():
        try:
            out["result"] = fn()
        except BaseException as exc:  # noqa: BLE001 - handed back to the test thread
            out["exc"] = exc

    t = threading.Thread(target=target, daemon=True)
    t.start()
    t.join(seconds)
    assert not t.is_alive(), "pipelined driver deadlocked on a worker failure"
    if "exc" in out:
        raise out["exc"]
    return out["result"]


def _flaky_scan(monkeypatch, fail_calls, exc=RuntimeError):
    real = range_mod._scan_and_match
    calls: list = []

    def flaky(cached, chunk, *a, **kw):
        calls.append(chunk)
        if len(calls) in fail_calls:
            raise exc("scan worker died")
        return real(cached, chunk, *a, **kw)

    monkeypatch.setattr(range_mod, "_scan_and_match", flaky)
    return calls


def test_scan_worker_exception_propagates(worlds, monkeypatch):
    store, pairs, _, _, _ = worlds
    _flaky_scan(monkeypatch, {3})

    def run():
        with pytest.raises(RuntimeError, match="scan worker died"):
            generate_event_proofs_for_range_pipelined(
                store, pairs, EventProofSpec(SIG, TOPIC1, ACTOR), chunk_size=1, match_backend=BACKEND,
                scan_threads=4, pipeline_depth=2, scan_retries=0, force_pipeline=True,
            )

    _drive_with_deadline(run)


def _exhausted_retries(message):
    """A client's exhausted retries: a RuntimeError raised from a transport error."""
    exc = RuntimeError(message)
    exc.__cause__ = ConnectionError("injected")
    return exc


@pytest.mark.parametrize("exc", [ConnectionError, TimeoutError, IntegrityError, DegradedError, _exhausted_retries])
def test_transient_scan_failure_is_retried(worlds, monkeypatch, exc):
    """A store error is transient: the chunk re-scans. So are an endpoint
    pool's lotus_down posture and a client's exhausted retries, as the
    reference retries them."""
    store, pairs, _, _, _ = worlds
    ref_json, _ = _reference(worlds, 1, False)
    calls = _flaky_scan(monkeypatch, {3}, exc)
    metrics = Metrics()
    bundle = _drive_with_deadline(
        lambda: generate_event_proofs_for_range_pipelined(
            store, pairs, EventProofSpec(SIG, TOPIC1, ACTOR), chunk_size=1, match_backend=BACKEND,
            scan_threads=4, pipeline_depth=2, metrics=metrics, force_pipeline=True,
        )
    )
    assert bundle.to_json() == ref_json
    assert len(calls) == len(pairs) + 1 and metrics.counters["range_scan_retries"] == 1


@pytest.mark.parametrize("scan_threads", [1, 4], ids=["direct", "coalesced"])
def test_kernel_failure_in_the_mask_is_not_retried(worlds, monkeypatch, scan_threads):
    """A failed launch of the unfused scan's fingerprint mask (a
    RuntimeError, as `ops.build.launch` raises) re-raises from the first
    attempt: no stage retries a kernel failure."""
    store, pairs, _, _, _ = worlds
    monkeypatch.setenv("IPC_SCAN_FUSED_MATCH", "0")

    class Refusing(_CountingBackend):
        def event_match_mask_fp(self, *args):
            super().event_match_mask_fp(*args)
            raise RuntimeError("kernel launch refused")

    backend, metrics = Refusing(), Metrics()

    def run():
        with pytest.raises(RuntimeError, match="kernel launch refused"):
            generate_event_proofs_for_range_pipelined(
                store, pairs, EventProofSpec(SIG, TOPIC1, ACTOR), chunk_size=1, match_backend=backend,
                scan_threads=scan_threads, pipeline_depth=2, metrics=metrics, force_pipeline=True,
            )

    _drive_with_deadline(run)
    assert metrics.counter_value("range_scan_retries") == 0
    assert 1 <= backend.mask_calls <= len(pairs)


def test_semantic_rpc_error_fails_fast(worlds, monkeypatch):
    from ipc_proofs_tpu_torch.store.rpc import RpcError

    store, pairs, _, _, _ = worlds
    calls: list = []

    def refuse(*a, **kw):
        calls.append(1)
        raise RpcError(-32601, "method not found")

    monkeypatch.setattr(range_mod, "_scan_and_match", refuse)
    with pytest.raises(RpcError):
        generate_event_proofs_for_range_pipelined(
            store, pairs, EventProofSpec(SIG, TOPIC1, ACTOR), chunk_size=9, match_backend=BACKEND,
            scan_threads=1, force_pipeline=True,
        )
    assert calls == [1]


@pytest.mark.parametrize("stage", ["record", "verify"])
def test_record_and_verify_exceptions_propagate(worlds, monkeypatch, stage):
    store, pairs, _, _, _ = worlds

    def boom(*a, **kw):
        raise KeyError(f"{stage} stage died")

    if stage == "record":
        monkeypatch.setattr(range_mod, "_record_chunk", boom)

    def run():
        with pytest.raises(KeyError, match=f"{stage} stage died"):
            generate_event_proofs_for_range_pipelined(
                store, pairs, EventProofSpec(SIG, TOPIC1, ACTOR), chunk_size=2, match_backend=BACKEND,
                scan_threads=2, verify_chunk=boom if stage == "verify" else None, force_pipeline=True,
            )

    _drive_with_deadline(run)


def test_stage_metrics_and_overlap_efficiency(worlds):
    store, pairs, n_matching, _, _ = worlds
    m = Metrics()
    results: list = []
    generate_event_proofs_for_range_pipelined(
        store, pairs, EventProofSpec(SIG, TOPIC1, ACTOR), chunk_size=2, scan_threads=2,
        match_backend=BACKEND, verify_chunk=lambda b: len(b.event_proofs), verify_results=results,
        metrics=m, force_pipeline=True,
    )
    assert sum(results) == n_matching
    snap = m.snapshot()
    for stage in ("range_scan", "range_record", "range_merge", "range_verify"):
        assert stage in snap["timers"], stage
        assert snap["timers"][stage]["wall_s"] <= snap["timers"][stage]["total_s"] + 1e-6
    assert snap["counters"]["range_proofs"] == n_matching
    assert snap["overlap_efficiency"] > 0


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_drivers_keep_lock_order_under_lockdep(worlds, tmp_path, monkeypatch, fused):
    """With lockdep on, a journaled overlapped run (coalescer, merge fold,
    job, executor, metrics locks) observes no inversion and gives the
    reference's bytes."""
    from ipc_proofs_tpu_torch.utils import lockdep

    store, pairs, _, _, _ = worlds
    ref_json, _ = _reference(worlds, 1, True)
    if not fused:
        monkeypatch.setenv("IPC_SCAN_FUSED_MATCH", "0")
    lockdep.enable(strict=True)
    lockdep.reset()
    try:
        merged, _ = generate_and_verify_range_overlapped(
            store, pairs, EventProofSpec(SIG, TOPIC1, ACTOR), chunk_size=1, verify_chunk=_verify_chunk,
            match_backend=BACKEND, storage_specs=_port_specs(True), scan_threads=4, record_workers=2,
            verify_workers=2, force_pipeline=True, job_dir=str(tmp_path / "job"),
        )
        graph = lockdep.order_graph()
        violations = lockdep.violations()
    finally:
        lockdep.disable()
    assert merged.to_json() == ref_json
    assert not violations
    if not fused:
        assert ("MatchCoalescer._call_lock", "MatchCoalescer._lock") in graph


_PURE_UNIVERSE = """
import hashlib, sys
from ipc_proofs_tpu_torch.backend import get_backend
from ipc_proofs_tpu_torch.backend.native import load_scan_ext
from ipc_proofs_tpu_torch.fixtures import build_range_world
from ipc_proofs_tpu_torch.proofs.generator import EventProofSpec
from ipc_proofs_tpu_torch.proofs import range as r
from ipc_proofs_tpu_torch.proofs.storage_batch import MappingSlotSpec

assert load_scan_ext() is None
store, pairs, _ = build_range_world({n_pairs}, {receipts_per_pair}, {events_per_receipt}, {match_rate})
spec = EventProofSpec({sig!r}, {topic1!r}, {actor})
kw = dict(match_backend=get_backend("gpu", device="cpu"), storage_specs=[MappingSlotSpec(*s) for s in {storage!r}])
out = [
    r.generate_event_proofs_for_range_chunked(store, pairs, spec, chunk_size=4, **kw),
    r.generate_event_proofs_for_range_pipelined(store, pairs, spec, chunk_size=4, scan_threads=3,
                                                force_pipeline=True, **kw),
]
for bundle in out:
    print(hashlib.sha256(bundle.to_json().encode()).hexdigest())
"""


def test_pure_python_universe_drivers_equal_reference(worlds):
    """The ``IPC_PROOFS_NO_NATIVE=1`` universe (a child process): the chunked
    and pipelined drivers give the reference's bytes."""
    import hashlib
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    ref_json, _ = _reference(worlds, 4, True)
    script = _PURE_UNIVERSE.format(**WORLD, sig=SIG, topic1=TOPIC1, actor=ACTOR, storage=STORAGE_SPECS)
    env = dict(os.environ, PYTHONPATH=str(root), IPC_PROOFS_NO_NATIVE="1")
    proc = subprocess.run(
        [sys.executable, "-c", script], cwd=root, env=env, capture_output=True, text=True, timeout=180
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    digest = hashlib.sha256(ref_json.encode()).hexdigest()
    assert proc.stdout.split() == [digest, digest]
