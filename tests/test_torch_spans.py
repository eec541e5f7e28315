"""The port's spans at its layer boundaries, on the host clock the card's
timeline is put on.

- One pass of the serial range engine with storage specs, then
  ``verify_proof_bundle(..., verify_witness_cids=True)``, on
  ``GpuBackend(device="cpu")``: every layer's span opens under the parent
  its layer gives, and a pass opens as many spans over 8 pairs as over 32
  (a span wraps a phase or one size-class call, never an item); a
  size-class call's ``gpu.call`` span carries its four phases' times. With
  the collector off, the always-on flight ring sees the same spans. Outside
  every trace the phases open no span (`phase_span`); the stages still do.
- A span's ``[ts_us, ts_us + dur_us]`` in seconds holds a
  ``time.perf_counter()`` read inside it.
- While the collector is installed, a full collection inside a span is a
  ``host.gc`` span under it, and a young one adds its pause to the
  ``gc_us`` attribute of the span it interrupted (a ``host.gc`` span where
  that span is another thread's); outside every span, or once the
  collector is gone, nothing is recorded; the hook never waits on the
  collector's lock.
- ``ROWS`` counts the rows each launch took, by kernel, beside
  ``LAUNCHES``.
"""

import contextlib
import gc
import threading
import time
from collections import Counter
from types import SimpleNamespace

import pytest
import torch

from ipc_proofs_tpu_torch.backend import get_backend
from ipc_proofs_tpu_torch.fixtures import build_range_world
from ipc_proofs_tpu_torch.obs import flight, trace
from ipc_proofs_tpu_torch.ops import blake2b, build, keccak, match
from ipc_proofs_tpu_torch.proofs.generator import EventProofSpec
from ipc_proofs_tpu_torch.proofs.range import generate_event_proofs_for_range
from ipc_proofs_tpu_torch.proofs.storage_batch import MappingSlotSpec
from ipc_proofs_tpu_torch.proofs.trust import TrustPolicy
from ipc_proofs_tpu_torch.proofs.verifier import verify_proof_bundle
from ipc_proofs_tpu_torch.utils.metrics import Metrics

from _torch_trace import no_collections

SPEC = EventProofSpec("NewTopDownMessage(bytes32,uint256)", "calib-subnet-1", 1001)
SLOTS = [MappingSlotSpec(1001, "calib-subnet-1", i) for i in range(3)]

# (span, its parent) that one pass opens, with how many: the GPU backend's
# call once a non-empty size class of each batch (the slot keccaks' one
# class, the witness's three, the event replay's TxMeta one)
LAYERS = {
    ("range_scan", "unit"): 1,
    ("range_match", "range_scan"): 1,
    ("range_record", "unit"): 2,
    ("range_materialize", "range_record"): 1,
    ("range_storage", "unit"): 1,
    ("storage.slot_hash", "range_storage"): 1,
    ("storage.actor_walk", "range_storage"): 1,
    ("storage.slot_walk", "range_storage"): 1,
    ("storage.claims", "range_storage"): 1,
    ("verify.cids", "unit"): 1,
    ("verify.load", "unit"): 1,
    ("verify.storage", "unit"): 1,
    ("verify.events", "unit"): 1,
    ("gpu.compare", "verify.cids"): 1,
    ("gpu.call", "storage.slot_hash"): 1,
    ("gpu.call", "verify.cids"): 3,
    ("gpu.call", "verify.events"): 1,
}
GPU_PHASES = ("pack_us", "copy_us", "wait_us", "unpack_us")


@pytest.fixture(autouse=True)
def _tracing_off():
    yield
    trace.disable_tracing()


def _pass(n_pairs: int, root: str = "unit") -> None:
    """One unit of the relayer's work: the range with its slot grid, then
    the bundle verified with every witness CID recomputed; under a root
    span ``root``, or none."""
    store, pairs, n_matching = build_range_world(n_pairs, 8, 4, 0.125)
    backend = get_backend("gpu", device="cpu")
    with trace.root_span(root) if root else contextlib.nullcontext():
        bundle = generate_event_proofs_for_range(
            store, pairs, SPEC, match_backend=backend, metrics=Metrics(), storage_specs=SLOTS
        )
        result = verify_proof_bundle(
            bundle, TrustPolicy.accept_all(), verify_witness_cids=True, cid_backend=backend
        )
    assert result.all_valid() and len(result.event_results) == n_matching > 0
    assert len(result.storage_results) == n_pairs * len(SLOTS)


def _tree(spans) -> Counter:
    by_id = {sp.span_id: sp for sp in spans}
    return Counter(
        (sp.name, by_id[sp.parent_id].name if sp.parent_id in by_id else "") for sp in spans
    )


def _traced_pass(n_pairs: int) -> list:
    collector = trace.enable_tracing(metrics=Metrics())
    with no_collections():
        _pass(n_pairs)
    return collector.drain()


@pytest.mark.parametrize("n_pairs", [8, 32])
def test_every_layer_opens_its_spans_under_its_parent(n_pairs):
    tree = _tree(_traced_pass(n_pairs))
    assert tree.pop(("unit", "")) == 1
    assert dict(tree) == LAYERS


def test_a_size_class_call_carries_its_phases_in_order():
    calls = [sp for sp in _traced_pass(8) if sp.name == "gpu.call"]
    assert {sp.attrs["kernel"] for sp in calls} >= {"keccak256_single_block", "blake2b256_blocks"}
    for sp in calls:
        assert set(sp.attrs) == {"kernel", "messages", *GPU_PHASES} and sp.attrs["messages"] > 0
        assert all(sp.attrs[phase] >= 0 for phase in GPU_PHASES)
        assert sum(sp.attrs[phase] for phase in GPU_PHASES) <= sp.dur_us + 1


def test_a_pass_opens_as_many_spans_over_more_pairs():
    assert len(_traced_pass(8)) == len(_traced_pass(32)) == sum(LAYERS.values()) + 1


def test_with_the_collector_off_the_flight_ring_sees_the_same_spans():
    ring = flight.get_flight_recorder()
    ring.clear()
    trace.disable_tracing()
    _pass(8)
    snap = ring.snapshot()
    spans = [SimpleNamespace(**sp) for sp in snap["spans"]]
    assert len(spans) < snap["span_capacity"]
    tree = _tree(spans)
    assert tree.pop(("unit", "")) == 1
    assert dict(tree) == LAYERS


def test_outside_every_trace_the_phases_open_no_span():
    ring = flight.get_flight_recorder()
    ring.clear()
    trace.disable_tracing()
    _pass(8, root="")
    names = Counter(sp["name"] for sp in ring.snapshot()["spans"])
    # the range's stages are spans, so its phases still nest under them;
    # the bare verify call's phases (and the backend calls in them) open none
    assert names == {
        "range_scan": 1, "range_match": 1, "range_record": 2, "range_materialize": 1, "range_storage": 1,
        "storage.slot_hash": 1, "storage.actor_walk": 1, "storage.slot_walk": 1, "storage.claims": 1,
        "gpu.call": 1,  # the slot keccaks, under range_storage
    }


def test_a_phase_span_is_a_span_only_inside_a_trace():
    with trace.phase_span("alone", {"k": 1}) as alone:
        alone.attrs.update(more=2)
    assert not isinstance(alone, trace.Span)
    with trace.span("operation") as operation:
        with trace.phase_span("phase", {"k": 1}) as phase:
            pass
    assert isinstance(phase, trace.Span) and phase.attrs == {"k": 1}
    assert (phase.trace_id, phase.parent_id) == (operation.trace_id, operation.span_id)


def test_a_span_is_on_the_perf_counter_clock():
    for _ in range(20):
        with trace.span("probe") as sp:
            inside = time.perf_counter()
        start, end = sp.ts_us * 1e-6, (sp.ts_us + sp.dur_us) * 1e-6
        assert start - 2e-6 <= inside <= end + 2e-6


def _collect_inside(name: str, generation: int = 2) -> trace.Span:
    with trace.span(name) as sp:
        gc.collect(generation)
    return sp


def test_a_full_collection_inside_a_span_is_a_host_gc_span_under_it():
    collector = trace.enable_tracing(metrics=Metrics())
    with trace.root_span("request"):
        _collect_inside("stage")
    spans = collector.snapshot()
    by_id = {sp.span_id: sp for sp in spans}
    stage = next(sp for sp in spans if sp.name == "stage")
    collected = [sp for sp in spans if sp.name == "host.gc" and sp.parent_id == stage.span_id]
    assert {"generation": 2} in [sp.attrs for sp in collected]
    assert all(set(sp.attrs) == {"generation"} for sp in collected)
    assert all(sp.trace_id == stage.trace_id for sp in collected)
    for sp in collected:  # inside the stage's interval, on its clock
        assert stage.ts_us <= sp.ts_us and sp.ts_us + sp.dur_us <= stage.ts_us + stage.dur_us + 1
    assert all(by_id[sp.parent_id].name != "host.gc" for sp in spans if sp.parent_id in by_id)


@pytest.mark.parametrize("generation", [0, 1])
def test_a_young_collection_adds_its_pause_to_the_span_it_interrupted(generation):
    collector = trace.enable_tracing(metrics=Metrics())
    with trace.root_span("request"):
        with no_collections():
            stage = _collect_inside("stage", generation)
    assert not [sp for sp in collector.snapshot() if sp.name == "host.gc"]
    assert 0 < stage.attrs["gc_us"] <= stage.dur_us + 1
    assert stage in collector.snapshot()


def test_a_young_collection_under_another_threads_span_is_a_host_gc_span():
    collector = trace.enable_tracing(metrics=Metrics())
    with trace.span("submitter") as submitter:
        ctx = trace.current_context()

        def worker():
            with trace.use_context(ctx):
                collector.on_gc("start", {"generation": 0})
                collector.on_gc("stop", {"generation": 0})

        t = threading.Thread(target=worker)
        t.start()
        t.join()
    collected = [sp for sp in collector.snapshot() if sp.name == "host.gc"]
    assert [(sp.parent_id, sp.attrs) for sp in collected] == [(submitter.span_id, {"generation": 0})]
    assert "gc_us" not in (submitter.attrs or {})


def test_no_host_gc_span_outside_spans_or_without_the_collector():
    collector = trace.enable_tracing(metrics=Metrics())
    gc.collect()
    assert [sp for sp in collector.snapshot() if sp.name == "host.gc"] == []
    trace.disable_tracing()
    assert collector.on_gc not in gc.callbacks
    after = _collect_inside("after", 0)
    _collect_inside("after")
    assert [sp for sp in collector.snapshot() if sp.name == "host.gc"] == []
    assert "gc_us" not in (after.attrs or {})


def test_a_replaced_collector_takes_its_hook_with_it():
    first = trace.enable_tracing(metrics=Metrics())
    second = trace.enable_tracing(metrics=Metrics())
    assert first.on_gc not in gc.callbacks and gc.callbacks.count(second.on_gc) == 1
    _collect_inside("stage")
    assert not [sp for sp in first.snapshot() if sp.name == "host.gc"]
    assert [sp for sp in second.snapshot() if sp.name == "host.gc"]


def test_the_hook_never_waits_on_the_collectors_lock():
    """A collection can start inside the collector's own locked section:
    the hook only queues its span, or adds to the open span's attribute,
    and the next call takes the span in."""
    metrics = Metrics()
    collector = trace.enable_tracing(metrics=metrics)
    with trace.span("stage") as stage:
        with collector._lock:
            for generation in (2, 0):
                collector.on_gc("start", {"generation": generation})
                collector.on_gc("stop", {"generation": generation})
    spans = collector.snapshot()
    assert [sp.attrs for sp in spans if sp.name == "host.gc"] == [{"generation": 2}]
    assert "gc_us" in stage.attrs
    assert metrics.counter_value("trace.spans_recorded") == 2


def test_a_full_collector_drops_and_counts_host_gc_spans():
    metrics = Metrics()
    collector = trace.enable_tracing(capacity=1, metrics=metrics)
    with trace.span("stage"):
        collector.on_gc("start", {"generation": 2})
        collector.on_gc("stop", {"generation": 2})
    assert [sp.name for sp in collector.snapshot()] == ["host.gc"]
    assert collector.dropped == 1  # the stage itself
    assert metrics.counter_value("trace.spans_dropped") == 1


@contextlib.contextmanager
def _fake_launches(monkeypatch):
    """Launches that reach a stand-in C entry instead of the card."""
    monkeypatch.setattr(build, "_entry", lambda library, name, argtypes: lambda *args: 0)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: type("S", (), {"cuda_stream": 0}))
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    for module in (blake2b, keccak, match):
        module.reset_launch_counts()
    try:
        yield
    finally:
        for module in (blake2b, keccak, match):
            module.reset_launch_counts()


@pytest.mark.parametrize("module, name", [
    (blake2b, "blake2b256_single_block"),
    (blake2b, "blake2b256_two_block"),
    (blake2b, "blake2b256_blocks"),
    (keccak, "keccak256_single_block"),
    (keccak, "keccak256_blocks"),
])
def test_rows_count_each_hash_launch_by_kernel(monkeypatch, module, name):
    cpu = torch.device("cpu")
    with _fake_launches(monkeypatch):
        module._launch(name, [], 2048, cpu)
        module._launch(name, [], 256, cpu)
        module._launch(name, [], 0, cpu)  # no rows: no launch
        assert module.LAUNCHES[name] == 2 and module.ROWS[name] == 2304
        assert sum(module.ROWS.values()) == 2304
        module.reset_launch_counts()
        assert set(module.ROWS.values()) == {0}


def test_rows_count_each_match_launch_under_its_count_as(monkeypatch):
    cpu = torch.device("cpu")
    with _fake_launches(monkeypatch):
        match._launch("event_match_mask_fp", [], [], cpu, "event_match_mask_fp_sharded", 512)
        match._launch("event_match_mask_fp", [], [], cpu, "event_match_mask_fp_sharded", 512)
        match._launch("receipts_with_match", [], [], cpu, "receipts_with_match", 96)
        assert match.ROWS == {**dict.fromkeys(match.LAUNCHES, 0),
                              "event_match_mask_fp_sharded": 1024, "receipts_with_match": 96}
        assert match.LAUNCHES["event_match_mask_fp_sharded"] == 2
