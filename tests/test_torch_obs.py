"""The port's observability (``ipc_proofs_tpu_torch/obs/``) held against
the JAX package's ``obs/``.

- Span trees: the same call sequence (nesting, `root_span`, `use_context`
  hops to other threads, `run_pipeline` stage workers, `Metrics.stage`)
  gives the same tree of names in both packages. Ids come from ``uuid``
  and a counter, so trees compare by shape and names, never by id.
- The carrier round trip and head sampling at a fixed rate decide alike.
- The flight ring keeps its bound; the crash hook dumps it.
- `render_prometheus` renders the same bytes for the same counters,
  gauges, histograms and stage timers.
- The Chrome trace-event and OTLP/JSON exports are the reference's up to
  ids, times, pid, thread ids and the instrumentation scope's name.
- `post_otlp_trace` reaches an HTTP collector on 127.0.0.1 served inside
  the test, retries a 503 and fails soft on a dead port.
- JSON log lines carry the active trace and span ids.
"""

import http.server
import io
import json
import logging
import random
import socket
import sys
import threading

import pytest

jax = pytest.importorskip("jax")

from ipc_proofs_tpu.obs import export as ref_export  # noqa: E402
from ipc_proofs_tpu.obs import prom as ref_prom  # noqa: E402
from ipc_proofs_tpu.obs import trace as ref_trace  # noqa: E402
from ipc_proofs_tpu.parallel.pipeline import PipelineStage as RefStage  # noqa: E402
from ipc_proofs_tpu.parallel.pipeline import run_pipeline as ref_run_pipeline  # noqa: E402
from ipc_proofs_tpu.utils.metrics import Metrics as RefMetrics  # noqa: E402
from ipc_proofs_tpu_torch.obs import export, flight, prom, trace  # noqa: E402
from ipc_proofs_tpu_torch.parallel.pipeline import PipelineStage, run_pipeline  # noqa: E402
from ipc_proofs_tpu_torch.utils import log as port_log  # noqa: E402
from ipc_proofs_tpu_torch.utils.metrics import Histogram, Metrics  # noqa: E402

from _torch_trace import no_collections  # noqa: E402

PACKAGES = {
    "port": (trace, Metrics, PipelineStage, run_pipeline, export, prom),
    "ref": (ref_trace, RefMetrics, RefStage, ref_run_pipeline, ref_export, ref_prom),
}


@pytest.fixture(autouse=True)
def _tracing_off():
    yield
    trace.disable_tracing()
    ref_trace.disable_tracing()


def _shape(spans) -> "list[tuple[str, str, int]]":
    """(name, parent's name, depth) per span, in a canonical order: the
    tree without ids or times."""
    by_id = {sp.span_id: sp for sp in spans}

    def depth(sp):
        d = 0
        while sp.parent_id in by_id:
            sp, d = by_id[sp.parent_id], d + 1
        return d

    return sorted(
        (sp.name, by_id[sp.parent_id].name if sp.parent_id in by_id else "", depth(sp))
        for sp in spans
    )


def _traces(spans) -> int:
    return len({sp.trace_id for sp in spans})


def _call_sequence(pkg: str) -> list:
    """Nested spans, a root span, a context hop to a plain thread, a
    pipeline under a span and stage timers; returns the collected spans."""
    tr, metrics_cls, stage_cls, run, _, _ = PACKAGES[pkg]
    with no_collections():
        return _call_sequence_spans(tr, metrics_cls, stage_cls, run)


def _call_sequence_spans(tr, metrics_cls, stage_cls, run) -> list:
    collector = tr.enable_tracing()
    m = metrics_cls()
    with tr.root_span("request") as root:
        root.set_attr("k", 1)
        with tr.span("parse"):
            with m.stage("decode"):
                pass
        ctx = tr.current_context()
        hopped = threading.Thread(target=lambda: _in_context(tr, ctx, "worker"), name="hop")
        hopped.start()
        hopped.join()
        lost = threading.Thread(target=lambda: _in_context(tr, None, "orphan"), name="lost")
        lost.start()
        lost.join()
        run(
            list(range(4)),
            [
                stage_cls("scan", lambda v: v, workers=2, metrics_stage="range_scan"),
                stage_cls("record", lambda v: v, metrics_stage="range_record"),
            ],
            depth=2,
            metrics=m,
        )
    with tr.root_span("second"):
        with tr.span("child"):
            pass
    return collector.snapshot()


def _in_context(tr, ctx, name):
    with tr.use_context(ctx):
        with tr.span(name):
            with tr.span(name + ".inner"):
                pass


def test_span_trees_match_the_reference():
    port, ref = _call_sequence("port"), _call_sequence("ref")
    assert _shape(port) == _shape(ref)
    # the hop keeps "worker" in the request's trace; the thread without a
    # context starts its own; the second root is a third trace
    assert _traces(port) == _traces(ref) == 3
    names = {sp.name: sp for sp in port}
    assert names["worker"].parent_id == names["request"].span_id
    assert names["orphan"].parent_id == ""
    stages = [sp for sp in port if sp.name in ("range_scan", "range_record")]
    assert len(stages) == 8 and {sp.trace_id for sp in stages} == {names["request"].trace_id}
    assert all(sp.thread_name.startswith(("pipeline-scan-", "pipeline-record-")) for sp in stages)


@pytest.mark.parametrize(
    "carrier",
    [
        None,
        "not a dict",
        {},
        {"trace_id": "", "span_id": "1"},
        {"trace_id": "ab", "span_id": 3},
        {"trace_id": "ab", "span_id": "cd"},
        {"trace_id": "ab", "span_id": "cd", "sampled": False},
    ],
)
def test_carrier_round_trip_matches_the_reference(carrier):
    ours, ref = trace.context_from_carrier(carrier), ref_trace.context_from_carrier(carrier)
    assert (ours is None) == (ref is None)
    if ours is not None:
        assert (ours.trace_id, ours.span_id, ours.sampled) == (ref.trace_id, ref.span_id, ref.sampled)
        assert trace.carrier_from_context(ours) == ref_trace.carrier_from_context(ref)


def test_adopted_span_parents_under_the_carrier():
    trace.enable_tracing()
    with trace.root_span("router") as router:
        carrier = trace.carrier_from_context()
    with trace.adopted_span("shard", carrier) as shard:
        pass
    with trace.adopted_span("fresh", {"bogus": 1}) as fresh:
        pass
    assert shard.trace_id == router.trace_id and shard.parent_id == router.span_id
    assert fresh.trace_id != router.trace_id and fresh.parent_id == ""


@pytest.mark.parametrize("rate", [0.0, 0.1, 0.5, 1.0])
def test_head_sampling_matches_the_reference(rate):
    rng = random.Random(1234)
    ids = [f"{rng.getrandbits(64):016x}" for _ in range(2000)]
    trace.enable_tracing(sample=rate)
    ref_trace.enable_tracing(sample=rate)
    ours = [trace._sample_decision(t) for t in ids]
    assert ours == [ref_trace._sample_decision(t) for t in ids]
    if 0.0 < rate < 1.0:
        assert abs(sum(ours) / len(ours) - rate) < 0.05


def test_sampled_out_traces_skip_the_collector_not_the_flight_ring():
    m = Metrics()
    collector = trace.enable_tracing(metrics=m, sample=0.0)
    with trace.root_span("dropped") as sp:
        with trace.span("child"):
            pass
    assert len(collector) == 0
    assert m.counter_value("trace.spans_sampled_out") == 2
    assert [s.name for s in trace.spans_for_trace(sp.trace_id)] == ["dropped", "child"]


def test_flight_ring_is_bounded_and_dumps():
    recorder = flight.FlightRecorder(span_capacity=8, log_capacity=2)
    spans = []
    for i in range(20):
        sp = trace.Span(f"s{i}", "t", str(i), "")
        recorder.record_span(sp)
        spans.append(sp)
    for i in range(5):
        recorder.record_log({"level": "WARNING", "logger": "x", "msg": f"m{i}"})
    snap = recorder.snapshot()
    assert [s["name"] for s in snap["spans"]] == [f"s{i}" for i in range(12, 20)]
    assert [e["msg"] for e in snap["logs"]] == ["m3", "m4"]
    out = io.StringIO()
    recorder.dump(out)
    text = out.getvalue()
    assert text.startswith("---- flight recorder ----") and "[span] s19" in text and "m4" in text


def test_crash_dump_hook_writes_the_ring_before_the_traceback(monkeypatch):
    seen = []
    monkeypatch.setattr(sys, "excepthook", lambda *exc: seen.append(exc[0]))
    monkeypatch.setattr(flight, "_hook_installed", False)  # a CLI run in this process installed it
    err = io.StringIO()
    monkeypatch.setattr(sys, "stderr", err)
    flight.install_crash_dump()
    flight.install_crash_dump()  # once per process: the ring dumps once
    with trace.span("before-crash"):
        pass
    try:
        raise ValueError("boom")
    except ValueError:
        sys.excepthook(*sys.exc_info())
    assert seen == [ValueError]
    assert err.getvalue().count("---- flight recorder ----") == 1
    assert "[span] before-crash" in err.getvalue()


def test_warnings_mirror_into_the_flight_ring():
    flight.get_flight_recorder().clear()
    port_log.get_logger("ipc_proofs_tpu_torch.tests").warning("mirrored %d", 7)
    logs = flight.get_flight_recorder().snapshot()["logs"]
    assert any(e["msg"] == "mirrored 7" and e["level"] == "WARNING" for e in logs)


def _fill(m) -> None:
    for name, n in (("rpc.calls", 41), ("follow.errors", 1), ("weird-name.x", 3)):
        m.count(name, n)
    m.set_gauge("follow.last_finalized_epoch", 4097)
    m.set_gauge("ratio", 0.125)
    rng = random.Random(5)
    for _ in range(300):
        m.observe("pool.read_ms", rng.expovariate(0.5))
    m.observe("batch", 3)
    with m.stage('stage "quoted"\\x'):
        pass
    with m.stage("range_scan"):
        pass


def test_prometheus_text_is_byte_equal():
    ours, ref = Metrics(), RefMetrics()
    _fill(ours)
    _fill(ref)
    snap, ref_snap = ours.snapshot(), ref.snapshot()
    # wall times differ run to run: give the reference's snapshot ours
    ref_snap["uptime_s"] = snap["uptime_s"]
    ref_snap["timers"] = snap["timers"]
    ref_snap["overlap_efficiency"] = snap["overlap_efficiency"]
    assert snap == ref_snap
    text = prom.render_prometheus(snap)
    assert text == ref_prom.render_prometheus(ref_snap)
    assert "ipc_rpc_calls_total 41\n" in text
    assert 'ipc_pool_read_ms{quantile="0.99"}' in text
    assert prom.CONTENT_TYPE == ref_prom.CONTENT_TYPE


def test_histogram_percentiles_match_the_reference():
    from ipc_proofs_tpu.utils.metrics import Histogram as RefHistogram

    ours, ref = Histogram(maxlen=64), RefHistogram(maxlen=64)
    rng = random.Random(9)
    for _ in range(500):
        v = rng.random()
        ours.observe(v)
        ref.observe(v)
    assert ours.snapshot() == ref.snapshot()
    assert ours.percentiles((0.99,)) == ref.percentiles((0.99,))


def _normalize_chrome(obj) -> dict:
    ids: dict = {}
    tids: dict = {}

    def norm(value):
        if value == "":
            return ""
        return ids.setdefault(value, f"id{len(ids)}")

    for event in obj["traceEvents"]:
        event["pid"] = 0
        event["tid"] = tids.setdefault(event["tid"], len(tids))
        if event["ph"] == "X":
            event["ts"] = event["dur"] = 0
            for key in ("trace_id", "span_id", "parent_id"):
                event["args"][key] = norm(event["args"][key])
    return obj


def _normalize_otlp(obj) -> dict:
    ids: dict = {}
    scope = obj["resourceSpans"][0]["scopeSpans"][0]
    scope["scope"]["name"] = "obs"
    for sp in scope["spans"]:
        for key in ("traceId", "spanId", "parentSpanId"):
            if key in sp:
                sp[key] = ids.setdefault(sp[key], f"id{len(ids)}")
        sp["startTimeUnixNano"] = sp["endTimeUnixNano"] = "0"
    return obj


def _exported(pkg: str, tmp_path) -> "tuple[dict, dict, int]":
    tr, _, _, _, exp, _ = PACKAGES[pkg]
    collector = tr.enable_tracing()
    with no_collections(), tr.root_span("cli.range", {"pairs": 4}):
        for i in range(3):
            with tr.span(f"rpc.m{i}", {"endpoint": "http://node"}):
                pass
    spans = sorted(collector.snapshot(), key=lambda s: int(s.span_id, 16))
    chrome, otlp = tmp_path / f"{pkg}.json", tmp_path / f"{pkg}.otlp.json"
    n_chrome = exp.write_chrome_trace(str(chrome), spans)
    n_otlp = exp.write_otlp_trace(str(otlp), spans)
    assert n_chrome == n_otlp == len(spans) == 4
    return json.loads(chrome.read_text()), json.loads(otlp.read_text()), len(spans)


def test_chrome_and_otlp_exports_match_the_reference(tmp_path):
    chrome, otlp, _ = _exported("port", tmp_path)
    ref_chrome, ref_otlp, _ = _exported("ref", tmp_path)
    assert _normalize_chrome(chrome) == _normalize_chrome(ref_chrome)
    assert otlp["resourceSpans"][0]["scopeSpans"][0]["scope"]["name"] == "ipc_proofs_tpu_torch.obs"
    assert _normalize_otlp(otlp) == _normalize_otlp(ref_otlp)


class _Collector(http.server.BaseHTTPRequestHandler):
    """An OTLP/HTTP collector: answers each POST with the next scripted
    status and keeps the bodies."""

    def do_POST(self):  # noqa: N802 - http.server's name
        body = self.rfile.read(int(self.headers["Content-Length"]))
        server = self.server
        status = server.script.pop(0) if server.script else 200
        server.bodies.append((status, self.headers["Content-Type"], body))
        self.send_response(status)
        self.end_headers()

    def log_message(self, *args):
        pass


@pytest.fixture
def collector_server():
    server = http.server.HTTPServer(("127.0.0.1", 0), _Collector)
    server.script, server.bodies = [], []
    thread = threading.Thread(target=server.serve_forever, name="otlp-collector", daemon=True)
    thread.start()
    try:
        yield server
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=5)


def _spans(n: int = 3) -> list:
    collector = trace.enable_tracing()
    with trace.root_span("root"):
        for i in range(n - 1):
            with trace.span(f"child{i}"):
                pass
    return collector.snapshot()


def test_otlp_post_reaches_a_local_collector(collector_server):
    spans = _spans()
    m = Metrics()
    url = f"http://127.0.0.1:{collector_server.server_port}/v1/traces"
    assert export.post_otlp_trace(url, spans, metrics=m, sleep=lambda s: None)
    [(status, ctype, body)] = collector_server.bodies
    assert status == 200 and ctype == "application/json"
    posted = json.loads(body)
    assert posted == json.loads(json.dumps(export.otlp_trace_obj(spans)))
    assert len(posted["resourceSpans"][0]["scopeSpans"][0]["spans"]) == len(spans)
    assert m.counter_value("trace.otlp_posts") == 1


def test_otlp_post_retries_a_503_then_succeeds(collector_server):
    collector_server.script[:] = [503, 429]
    m, sleeps = Metrics(), []
    url = f"http://127.0.0.1:{collector_server.server_port}/v1/traces"
    assert export.post_otlp_trace(url, _spans(), metrics=m, sleep=sleeps.append, rng=random.Random(1))
    assert [s for s, _, _ in collector_server.bodies] == [503, 429, 200]
    assert len(sleeps) == 2 and all(0.0 <= s <= 0.5 for s in sleeps)
    assert m.counter_value("trace.otlp_posts") == 1


def test_otlp_post_fails_soft(collector_server):
    m = Metrics()
    collector_server.script[:] = [400]
    url = f"http://127.0.0.1:{collector_server.server_port}/v1/traces"
    assert not export.post_otlp_trace(url, _spans(), metrics=m, sleep=lambda s: None)
    assert len(collector_server.bodies) == 1  # a 4xx is terminal: no resend
    # a port nothing listens on: connection refused on every attempt
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        dead = f"http://127.0.0.1:{sock.getsockname()[1]}/v1/traces"
    sleeps = []
    assert not export.post_otlp_trace(dead, _spans(), metrics=m, sleep=sleeps.append, timeout_s=2.0)
    assert len(sleeps) == 3
    assert m.counter_value("trace.otlp_post_failures") == 2
    assert m.counter_value("trace.otlp_posts") == 0


def test_json_log_lines_carry_the_trace_ids():
    formatter = port_log.JsonLineFormatter()
    record = logging.LogRecord("ipc_proofs_torch.x", logging.INFO, __file__, 1, "hello", (), None)
    assert "trace_id" not in json.loads(formatter.format(record))
    with trace.root_span("logged") as sp:
        line = json.loads(formatter.format(record))
    assert line["trace_id"] == sp.trace_id and line["span_id"] == sp.span_id
    assert line["msg"] == "hello"


def test_format_span_tree_matches_the_reference():
    port = _call_sequence("port")
    ref = _call_sequence("ref")

    def strip(text):  # (indent, name) per line, without times and threads
        return sorted((len(line) - len(line.lstrip()), line.split()[0]) for line in text.splitlines())

    assert strip(trace.format_span_tree(port)) == strip(ref_trace.format_span_tree(ref))
