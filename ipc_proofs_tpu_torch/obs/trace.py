"""Contextvar-propagated trace spine: one `TraceContext` threads a CLI
command through the range drivers, `run_pipeline` stage workers, RPC
calls, the endpoint pool's hedge racers and journal commits.

The counterpart of ``ipc_proofs_tpu.obs.trace``, name for name. A span
times host work (``time.perf_counter_ns``): it never synchronises the card,
so a span around a kernel launch measures the launch, not the kernel.

Spans are always recorded into the in-process flight recorder (a tiny
bounded ring, see `obs/flight.py`) so post-hoc diagnosis works without
having turned anything on. Full-fidelity retention for Perfetto export is
opt-in: `enable_tracing()` installs a bounded `SpanCollector`, and
`--trace-out` on the CLI writes its contents as Chrome trace-event JSON
(`obs/export.py`). While it is installed, the garbage collector's pauses
inside a span are kept too (`SpanCollector.on_gc`): a full collection as a
``host.gc`` span under the span it interrupted, a young one as time added
to that span's ``gc_us`` attribute, so time the interpreter spent
collecting never reads as the work it stopped.

A phase of an operation opens a `phase_span`: a span inside a trace,
nothing outside every trace, so a hot path's calls made outside any
operation leave no traces of one span each behind.

Context propagation is explicit at thread hops: `current_context()`
captures the ambient context where work is *submitted* and `use_context()`
re-installs it where the work *executes* (pipeline stage workers, the
micro-batcher's flush path). Within one thread, `span()` nests naturally
via a `contextvars.ContextVar`.
"""

from __future__ import annotations

import gc
import itertools
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from contextvars import ContextVar
from dataclasses import dataclass, field

from ipc_proofs_tpu_torch.obs.flight import get_flight_recorder
from ipc_proofs_tpu_torch.utils.lockdep import named_lock

__all__ = [
    "TraceContext",
    "Span",
    "SpanCollector",
    "span",
    "phase_span",
    "root_span",
    "current_context",
    "use_context",
    "enable_tracing",
    "disable_tracing",
    "get_collector",
    "tracing_enabled",
    "spans_for_trace",
    "format_span_tree",
    "carrier_from_context",
    "context_from_carrier",
    "adopted_span",
]

_CTX: ContextVar["TraceContext | None"] = ContextVar("ipc_trace_ctx", default=None)

# span ids only need process-local uniqueness; itertools.count is atomic
# under the GIL so no lock is needed on this hot path
_span_ids = itertools.count(1)


def _new_trace_id() -> str:
    return os.urandom(8).hex()


@dataclass(frozen=True)
class TraceContext:
    """The propagated identity: which trace we are in, which span is the
    ambient parent for anything opened next, and whether this trace won
    the head-sampling draw (decided ONCE at the root and carried with the
    context, so every pipeline stage worker and batcher flush inherits
    the same verdict via `use_context`)."""

    trace_id: str
    span_id: str
    sampled: bool = True
    # the `Span` of ``span_id`` where this process opened it (None for a
    # context parsed from a carrier): `SpanCollector.on_gc` adds young
    # collections to it; never compared or carried
    span: "Span | None" = field(default=None, compare=False, repr=False)


class Span:
    """One completed (or in-flight) timed operation.

    ``ts_us``/``dur_us`` come from the monotonic clock (consistent across
    threads, what Perfetto wants); ``wall_ts`` is epoch seconds for humans
    reading a flight-recorder dump.
    """

    __slots__ = (
        "name",
        "trace_id",
        "span_id",
        "parent_id",
        "ts_us",
        "dur_us",
        "wall_ts",
        "thread_id",
        "thread_name",
        "attrs",
        "sampled",
    )

    def __init__(self, name: str, trace_id: str, span_id: str, parent_id: str):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.ts_us = 0
        self.dur_us = 0
        self.wall_ts = 0.0
        self.thread_id = 0
        self.thread_name = ""
        self.attrs: dict | None = None
        self.sampled = True

    def set_attr(self, key: str, value) -> None:
        if self.attrs is None:
            self.attrs = {}
        self.attrs[key] = value

    def to_dict(self) -> dict:
        out = {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "ts_us": self.ts_us,
            "dur_us": self.dur_us,
            "wall_ts": round(self.wall_ts, 6),
            "thread": self.thread_name,
        }
        if self.attrs:
            out["attrs"] = dict(self.attrs)
        return out


class SpanCollector:
    """Bounded, lock-protected sink for completed spans.

    Drops (and counts) once ``capacity`` is reached rather than growing
    without bound — a long serve run with tracing left on stays O(capacity).
    """

    def __init__(self, capacity: int = 100_000, metrics=None):
        self.capacity = capacity
        self._lock = named_lock("SpanCollector._lock")
        self._spans: list[Span] = []  # guarded-by: _lock
        self._dropped = 0  # guarded-by: _lock
        self._metrics = metrics
        # host.gc spans `on_gc` made and no call has taken in yet: a deque,
        # whose appends and pops need no lock (see `on_gc`)
        self._gc_spans: deque = deque()
        self._gc_start = 0  # perf_counter_ns at the running collection's start

    def record(self, sp: Span) -> None:
        self._admit(sp)

    def _admit(self, sp: "Span | None") -> None:
        """Keep the waiting host.gc spans, then ``sp``, while there is room;
        count each kept or dropped."""
        kept = dropped = 0
        with self._lock:
            while True:
                if self._gc_spans:
                    one = self._gc_spans.popleft()
                elif sp is not None:
                    one, sp = sp, None
                else:
                    break
                if len(self._spans) >= self.capacity:
                    self._dropped += 1
                    dropped += 1
                else:
                    self._spans.append(one)
                    kept += 1
        m = self._metrics
        if m is not None:
            if kept:
                m.count("trace.spans_recorded", kept)
            if dropped:
                m.count("trace.spans_dropped", dropped)

    def on_gc(self, phase: str, info: dict) -> None:
        """The ``gc.callbacks`` hook `enable_tracing` installs, for each
        collection inside a span: a young one (generation 0 or 1) adds its
        pause, in us, to the ``gc_us`` attribute of the span it interrupted
        when that span is open on this thread; a full one, or one under a
        context another thread's span holds, becomes a ``host.gc`` span
        (``generation`` attribute) under it, in its trace. One outside every
        span, or in a trace that lost the sampling draw, is not recorded.
        A collection starts inside whatever allocation set it off, this
        collector's or the metrics' locked sections included, so the hook
        takes no lock and counts nothing: it appends to a deque that the
        next `record`, `drain` or `snapshot` takes in."""
        if phase == "start":
            self._gc_start = time.perf_counter_ns()
            return
        start, self._gc_start = self._gc_start, 0
        if not start:
            return  # installed while a collection ran
        end = time.perf_counter_ns()
        parent = _CTX.get()
        if parent is None or not parent.sampled:
            return
        generation = info.get("generation")
        t = threading.current_thread()
        held = parent.span
        if generation != 2 and held is not None and held.thread_id == t.ident:
            if held.attrs is None:
                held.attrs = {}
            held.attrs["gc_us"] = held.attrs.get("gc_us", 0) + (end - start) / 1000
            return
        sp = Span("host.gc", parent.trace_id, f"{next(_span_ids):x}", parent.span_id)
        sp.attrs = {"generation": generation}
        sp.thread_id = t.ident or 0
        sp.thread_name = t.name
        sp.wall_ts = time.time()
        sp.ts_us = start // 1000
        sp.dur_us = (end - start) // 1000
        self._gc_spans.append(sp)

    def drain(self) -> list[Span]:
        """Return and clear everything collected so far."""
        self._admit(None)
        with self._lock:
            out = self._spans
            self._spans = []
            return out

    def snapshot(self) -> list[Span]:
        self._admit(None)
        with self._lock:
            return list(self._spans)

    def sampled_out(self) -> None:
        """Count a span skipped because its trace lost the sampling draw
        (the flight ring still holds it)."""
        m = self._metrics
        if m is not None:
            m.count("trace.spans_sampled_out")

    @property
    def dropped(self) -> int:
        self._admit(None)
        with self._lock:
            return self._dropped

    def __len__(self) -> int:
        self._admit(None)
        with self._lock:
            return len(self._spans)


# Module-global collector; None when full-fidelity tracing is off. The
# flight recorder is separate and always on.
_collector: "SpanCollector | None" = None

# Head-sampling rate for NEW traces (decided once per trace at its root
# span; children inherit the verdict through TraceContext.sampled).
_sample_rate: float = 1.0


def enable_tracing(
    capacity: int = 100_000, metrics=None, sample: float = 1.0
) -> SpanCollector:
    """Install (and return) the global span collector. Idempotent-ish: a
    second call replaces the collector, which is what tests want.

    ``sample`` is the head-sampling rate in [0, 1]: each new trace draws
    once, deterministically from its trace id, and the whole trace keeps
    or loses collector retention together (no torn trees). The always-on
    flight ring ignores sampling — crash/slow-request forensics never go
    dark.

    The collector's `SpanCollector.on_gc` joins ``gc.callbacks`` (a
    replaced collector's leaves), so each pause of the garbage collector
    inside a span is kept, a full one as a ``host.gc`` span and a young one
    in the ``gc_us`` attribute of the span it interrupted, until
    `disable_tracing`."""
    global _collector, _sample_rate
    if metrics is None:
        from ipc_proofs_tpu_torch.utils.metrics import get_metrics

        metrics = get_metrics()
    _sample_rate = min(1.0, max(0.0, float(sample)))
    _drop_gc_hook()
    _collector = SpanCollector(capacity=capacity, metrics=metrics)
    gc.callbacks.append(_collector.on_gc)
    return _collector


def disable_tracing() -> None:
    global _collector, _sample_rate
    _drop_gc_hook()
    _collector = None
    _sample_rate = 1.0


def _drop_gc_hook() -> None:
    if _collector is not None and _collector.on_gc in gc.callbacks:
        gc.callbacks.remove(_collector.on_gc)


def _sample_decision(trace_id: str) -> bool:
    """Deterministic per-trace draw: the leading 32 trace-id bits as a
    uniform in [0, 1) compared against the rate — the same trace id gets
    the same verdict in every process (OTLP-style head sampling)."""
    rate = _sample_rate
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    return int(trace_id[:8], 16) / 0x100000000 < rate


def get_collector() -> "SpanCollector | None":
    return _collector


def tracing_enabled() -> bool:
    return _collector is not None


def current_context() -> "TraceContext | None":
    """Capture the ambient context (call where work is submitted)."""
    return _CTX.get()


@contextmanager
def use_context(ctx: "TraceContext | None"):
    """Re-install a captured context on another thread (call where work
    executes). A None context is a no-op so call sites stay unconditional."""
    if ctx is None:
        yield
        return
    token = _CTX.set(ctx)
    try:
        yield
    finally:
        _CTX.reset(token)


def _record(sp: Span) -> None:
    # flight ring first (always on, sampling-blind), then the opt-in
    # collector — which only keeps spans of traces that won the draw
    get_flight_recorder().record_span(sp)
    col = _collector
    if col is not None:
        if sp.sampled:
            col.record(sp)
        else:
            col.sampled_out()


class span:
    """Open a span under the ambient context (starting a fresh trace if
    there is none), give it to the ``with`` block for attribute attachment,
    record on exit. A class, not a generator context manager: hot paths
    open many (a traced range, a size-class call of the GPU backend each),
    and on an H100 host this way a span costs 12–37 % less."""

    __slots__ = ("_name", "_attrs", "_sp", "_token", "_start")

    def __init__(self, name: str, attrs: "dict | None" = None):
        self._name, self._attrs = name, attrs

    def __enter__(self) -> Span:
        parent = _CTX.get()
        if parent is None:
            trace_id, parent_id = _new_trace_id(), ""
            sampled = _sample_decision(trace_id)
        else:
            trace_id, parent_id = parent.trace_id, parent.span_id
            sampled = parent.sampled
        sp = self._sp = Span(self._name, trace_id, f"{next(_span_ids):x}", parent_id)
        if self._attrs:
            sp.attrs = dict(self._attrs)
        t = threading.current_thread()
        sp.thread_id = t.ident or 0
        sp.thread_name = t.name
        sp.wall_ts = time.time()
        sp.sampled = sampled
        self._token = _CTX.set(TraceContext(trace_id, sp.span_id, sampled, sp))
        self._start = start = time.perf_counter_ns()
        sp.ts_us = start // 1000
        return sp

    def __exit__(self, *exc) -> None:
        sp = self._sp
        sp.dur_us = (time.perf_counter_ns() - self._start) // 1000
        _CTX.reset(self._token)
        _record(sp)


class _Untraced:
    """What `phase_span` gives outside every trace: a stand-in whose
    attributes go nowhere."""

    __slots__ = ("attrs",)

    def __init__(self):
        self.attrs: dict = {}

    def __enter__(self) -> "_Untraced":
        return self

    def __exit__(self, *exc) -> None:
        return None


def phase_span(name: str, attrs: "dict | None" = None):
    """A `span` for one phase of a traced operation: under an ambient
    context a span like any other, outside every trace none at all. Alone
    it would be a trace of one span, and a hot path's calls outside any
    operation (the follower verifies every height's blocks, a bare
    ``verify_proof_bundle`` call has four phases) would fill the flight
    ring with them."""
    if _CTX.get() is None:
        return _Untraced()
    return span(name, attrs)


def spans_for_trace(trace_id: str, spans=None) -> list[Span]:
    """Spans belonging to one trace, start-ordered. Defaults to searching
    the always-on flight ring, so it works with the collector disabled."""
    if spans is None:
        with get_flight_recorder()._lock:
            spans = list(get_flight_recorder()._spans)
    return sorted(
        (sp for sp in spans if sp.trace_id == trace_id), key=lambda s: s.ts_us
    )


def format_span_tree(spans) -> str:
    """Indented single-trace tree (children under parents, start-ordered) —
    what the slow-request log and the crash dump print."""
    spans = sorted(spans, key=lambda s: s.ts_us)
    children: dict[str, list[Span]] = {}
    ids = {sp.span_id for sp in spans}
    roots: list[Span] = []
    for sp in spans:
        if sp.parent_id and sp.parent_id in ids:
            children.setdefault(sp.parent_id, []).append(sp)
        else:
            roots.append(sp)
    lines: list[str] = []

    def walk(sp: Span, depth: int) -> None:
        lines.append(
            f"{'  ' * depth}{sp.name} {sp.dur_us / 1000.0:.2f}ms"
            f" [{sp.thread_name}]"
        )
        for child in children.get(sp.span_id, ()):
            walk(child, depth + 1)

    for root in roots:
        walk(root, 0)
    return "\n".join(lines)


@contextmanager
def root_span(name: str, attrs: "dict | None" = None):
    """Open a span that FORCES a new trace, ignoring any ambient context —
    the request boundary (HTTP admission, a CLI invocation)."""
    token = _CTX.set(None)
    try:
        with span(name, attrs) as sp:
            yield sp
    finally:
        _CTX.reset(token)


def carrier_from_context(ctx: "TraceContext | None" = None) -> "dict | None":
    """The wire form of a trace context: a JSON-able dict a request body
    can carry across a process boundary (the cluster router → shard hop).
    Defaults to the ambient context; None when there is none to carry."""
    if ctx is None:
        ctx = _CTX.get()
    if ctx is None:
        return None
    return {
        "trace_id": ctx.trace_id,
        "span_id": ctx.span_id,
        "sampled": ctx.sampled,
    }


def context_from_carrier(carrier) -> "TraceContext | None":
    """Parse a `carrier_from_context` dict back into a `TraceContext`.
    Carriers arrive in untrusted request bodies, so anything malformed is
    simply no context — tracing must never make a request fail."""
    if not isinstance(carrier, dict):
        return None
    trace_id = carrier.get("trace_id")
    span_id = carrier.get("span_id")
    if not (isinstance(trace_id, str) and trace_id):
        return None
    if not (isinstance(span_id, str) and span_id):
        return None
    return TraceContext(trace_id, span_id, bool(carrier.get("sampled", True)))


@contextmanager
def adopted_span(name: str, carrier=None, attrs: "dict | None" = None):
    """The cross-process request boundary: open a span parented under a
    remote ``carrier`` (so a shard's spans nest under the router's dispatch
    span and one trace covers the whole scatter-gather), or fall back to
    `root_span` when no valid carrier came with the request."""
    ctx = context_from_carrier(carrier)
    if ctx is None:
        with root_span(name, attrs) as sp:
            yield sp
        return
    token = _CTX.set(ctx)
    try:
        with span(name, attrs) as sp:
            yield sp
    finally:
        _CTX.reset(token)
