"""Observability of the port: the trace spine, its exporters, Prometheus
text and the always-on flight recorder.

The counterpart of ``ipc_proofs_tpu.obs``:

- `obs/trace.py`  — contextvar-propagated `TraceContext` + `span()`,
  bounded `SpanCollector` (opt-in via `enable_tracing()` / ``--trace-out``)
- `obs/export.py` — Chrome trace-event JSON for ui.perfetto.dev, OTLP/JSON
  for OpenTelemetry collectors (``--trace-otlp``) and its HTTP POST
  (``--trace-otlp-url``)
- `obs/prom.py`   — Prometheus text exposition over `Metrics` snapshots
- `obs/flight.py` — bounded ring of recent spans + WARN/ERROR log records,
  served at ``/debug/flight``, dumped to stderr on an unhandled error
  (`install_crash_dump`)
- `obs/fleet.py`  — per-tenant accounting, metrics federation, flight-ring
  merging and cross-process span grafting
- `obs/slo.py`    — the multi-window burn-rate watchdog (``--slo on``) and
  its anomaly signatures
"""

from ipc_proofs_tpu_torch.obs.export import (
    chrome_trace_events,
    chrome_trace_obj,
    otlp_trace_obj,
    post_otlp_trace,
    write_chrome_trace,
    write_otlp_trace,
)
from ipc_proofs_tpu_torch.obs.fleet import (
    FleetFederation,
    TenantLedger,
    extract_tenant,
    graft_spans,
    merge_counters,
    merge_flight_snapshots,
    merge_gauges,
    merge_histograms,
    render_fleet_prometheus,
    subtree_for_response,
)
from ipc_proofs_tpu_torch.obs.flight import (
    FlightLogHandler,
    FlightRecorder,
    get_flight_recorder,
    install_crash_dump,
)
from ipc_proofs_tpu_torch.obs.prom import CONTENT_TYPE, render_prometheus
from ipc_proofs_tpu_torch.obs.slo import SloTarget, SloWatchdog, default_targets
from ipc_proofs_tpu_torch.obs.trace import (
    Span,
    SpanCollector,
    TraceContext,
    adopted_span,
    carrier_from_context,
    context_from_carrier,
    current_context,
    disable_tracing,
    enable_tracing,
    format_span_tree,
    get_collector,
    root_span,
    span,
    spans_for_trace,
    tracing_enabled,
    use_context,
)

__all__ = [
    "CONTENT_TYPE",
    "FleetFederation",
    "FlightLogHandler",
    "FlightRecorder",
    "Span",
    "SloTarget",
    "SloWatchdog",
    "SpanCollector",
    "TenantLedger",
    "TraceContext",
    "adopted_span",
    "carrier_from_context",
    "chrome_trace_events",
    "chrome_trace_obj",
    "context_from_carrier",
    "current_context",
    "default_targets",
    "disable_tracing",
    "enable_tracing",
    "extract_tenant",
    "format_span_tree",
    "get_collector",
    "get_flight_recorder",
    "graft_spans",
    "install_crash_dump",
    "merge_counters",
    "merge_flight_snapshots",
    "merge_gauges",
    "merge_histograms",
    "otlp_trace_obj",
    "post_otlp_trace",
    "render_fleet_prometheus",
    "render_prometheus",
    "root_span",
    "span",
    "spans_for_trace",
    "subtree_for_response",
    "tracing_enabled",
    "use_context",
    "write_chrome_trace",
    "write_otlp_trace",
]
