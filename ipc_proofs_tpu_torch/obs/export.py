"""Trace export: Chrome trace-event JSON for Perfetto, and OTLP-shaped
JSON for OpenTelemetry tooling. The counterpart of
``ipc_proofs_tpu.obs.export``: the same objects, with this package's name
as the OTLP instrumentation scope.

Chrome export — load the file into ui.perfetto.dev (or chrome://tracing)
and every worker thread gets its own lane of complete ("ph":"X") events,
with trace/span/parent ids in args for correlation. Format reference: the
Trace Event Format doc (Google, "JSON Array Format" / object form with a
``traceEvents`` key). We emit:
  - one ``M`` (metadata) event per thread naming its lane, plus a process
    name, and
  - one ``X`` (complete) event per span with ``ts``/``dur`` in
    microseconds on the monotonic clock.

OTLP export — the OTLP/JSON `ExportTraceServiceRequest` shape
(``resourceSpans`` → ``scopeSpans`` → ``spans``) so the file can be
POSTed to any collector's ``/v1/traces`` endpoint or inspected with
OTel-aware tooling. Ids are hex, zero-padded to the protocol widths
(32-char traceId, 16-char spanId); timestamps are epoch nanoseconds
reconstructed from the span's wall clock plus its monotonic duration.

`post_otlp_trace` ships the same object over HTTP to a live collector
(``--trace-otlp-url``): retried with bounded full-jitter exponential
backoff on 5xx/429/connection errors, never retried on other 4xx (the
payload won't get better), and fail-soft throughout — a dead collector
costs a warning and a ``trace.otlp_post_failures`` tick, never the run.
"""

from __future__ import annotations

import json
import os
import random
import time
import urllib.error
import urllib.request

from ipc_proofs_tpu_torch.utils.log import get_logger

__all__ = [
    "chrome_trace_events",
    "chrome_trace_obj",
    "write_chrome_trace",
    "otlp_trace_obj",
    "write_otlp_trace",
    "post_otlp_trace",
]

logger = get_logger(__name__)


def chrome_trace_events(spans) -> list[dict]:
    """Render spans (obs.trace.Span) as a Chrome trace-event list."""
    pid = os.getpid()
    events: list[dict] = [
        {
            "ph": "M",
            "pid": pid,
            "tid": 0,
            "name": "process_name",
            "args": {"name": "ipc-proofs-tpu"},
        }
    ]
    named_threads: set[int] = set()
    for sp in spans:
        tid = sp.thread_id or 0
        if tid not in named_threads:
            named_threads.add(tid)
            events.append(
                {
                    "ph": "M",
                    "pid": pid,
                    "tid": tid,
                    "name": "thread_name",
                    "args": {"name": sp.thread_name or f"thread-{tid}"},
                }
            )
        args = {
            "trace_id": sp.trace_id,
            "span_id": sp.span_id,
            "parent_id": sp.parent_id,
        }
        if sp.attrs:
            args.update(sp.attrs)
        events.append(
            {
                "ph": "X",
                "pid": pid,
                "tid": tid,
                "name": sp.name,
                "cat": "span",
                "ts": sp.ts_us,
                "dur": max(1, sp.dur_us),  # Perfetto hides zero-width slices
                "args": args,
            }
        )
    return events


def chrome_trace_obj(spans) -> dict:
    return {
        "traceEvents": chrome_trace_events(spans),
        "displayTimeUnit": "ms",
    }


def write_chrome_trace(path: str, spans) -> int:
    """Write the export; returns the number of span events written."""
    obj = chrome_trace_obj(spans)
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(obj, fh)
        fh.write("\n")
    return sum(1 for e in obj["traceEvents"] if e.get("ph") == "X")


def _otlp_attr(key: str, value) -> dict:
    """One OTLP KeyValue; everything non-stringy stringifies — the
    exporter carries diagnostics, not typed telemetry."""
    return {"key": key, "value": {"stringValue": str(value)}}


def otlp_trace_obj(spans) -> dict:
    """Render spans (obs.trace.Span) as one OTLP/JSON
    ExportTraceServiceRequest object."""
    otlp_spans: list[dict] = []
    for sp in spans:
        start_ns = int(sp.wall_ts * 1e9)
        attrs = [_otlp_attr("thread.name", sp.thread_name or "")]
        if sp.attrs:
            attrs.extend(_otlp_attr(k, v) for k, v in sp.attrs.items())
        rec = {
            "traceId": sp.trace_id.zfill(32),
            "spanId": sp.span_id.zfill(16),
            "name": sp.name,
            "kind": 1,  # SPAN_KIND_INTERNAL
            "startTimeUnixNano": str(start_ns),
            "endTimeUnixNano": str(start_ns + sp.dur_us * 1000),
            "attributes": attrs,
        }
        if sp.parent_id:
            rec["parentSpanId"] = sp.parent_id.zfill(16)
        otlp_spans.append(rec)
    return {
        "resourceSpans": [
            {
                "resource": {
                    "attributes": [_otlp_attr("service.name", "ipc-proofs-tpu")]
                },
                "scopeSpans": [
                    {
                        "scope": {"name": "ipc_proofs_tpu_torch.obs"},
                        "spans": otlp_spans,
                    }
                ],
            }
        ]
    }


def write_otlp_trace(path: str, spans) -> int:
    """Write the OTLP export; returns the number of spans written."""
    obj = otlp_trace_obj(spans)
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(obj, fh)
        fh.write("\n")
    return len(obj["resourceSpans"][0]["scopeSpans"][0]["spans"])


def _default_opener(url: str, body: bytes, timeout_s: float) -> int:
    """POST ``body`` as OTLP/JSON; returns the HTTP status code."""
    req = urllib.request.Request(
        url, data=body, headers={"Content-Type": "application/json"}, method="POST"
    )
    with urllib.request.urlopen(req, timeout=timeout_s) as resp:
        return resp.status


# statuses worth a retry: the collector is overloaded or briefly down,
# not rejecting the payload
_RETRYABLE_STATUSES = frozenset({429, 500, 502, 503, 504})


def post_otlp_trace(
    url: str,
    spans,
    metrics=None,
    max_attempts: int = 4,
    base_delay_s: float = 0.25,
    max_delay_s: float = 4.0,
    timeout_s: float = 10.0,
    opener=None,
    sleep=time.sleep,
    rng=None,
) -> bool:
    """POST spans to an OTLP/JSON collector endpoint; True on 2xx.

    Bounded full-jitter exponential backoff between attempts (same
    discipline as the RPC client): ``delay = uniform(0, min(max_delay,
    base * 2**attempt))``. Connection errors and 5xx/429 retry up to
    ``max_attempts``; any other HTTP status is terminal — re-sending an
    unacceptable payload can't fix it. Every failure path returns False
    after counting ``trace.otlp_post_failures`` (fail-soft: trace export
    must never take down the work it describes). ``opener``/``sleep``/
    ``rng`` are injectable so tests exercise the retry schedule without a
    network or a clock.
    """
    if metrics is None:
        from ipc_proofs_tpu_torch.utils.metrics import get_metrics

        metrics = get_metrics()
    if opener is None:
        opener = _default_opener
    if rng is None:
        rng = random.Random()
    body = json.dumps(otlp_trace_obj(spans)).encode("utf-8")
    last_reason = "no attempts made"
    for attempt in range(max(1, int(max_attempts))):
        if attempt:
            cap = min(max_delay_s, base_delay_s * (2 ** (attempt - 1)))
            sleep(rng.uniform(0.0, cap))
        try:
            status = opener(url, body, timeout_s)
        except urllib.error.HTTPError as exc:
            status = exc.code
        except Exception as exc:  # fail-soft: connection-level failure — retry, then give up with a counter, never raise
            last_reason = f"{type(exc).__name__}: {exc}"
            continue
        if 200 <= status < 300:
            metrics.count("trace.otlp_posts")
            return True
        last_reason = f"HTTP {status}"
        if status not in _RETRYABLE_STATUSES:
            break  # terminal: the payload won't get better on a resend
    metrics.count("trace.otlp_post_failures")
    logger.warning("OTLP trace POST to %s failed (%s)", url, last_reason)
    return False
