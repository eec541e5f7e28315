"""Prometheus text exposition (format version 0.0.4) over a `Metrics`
snapshot: the counterpart of ``ipc_proofs_tpu.obs.prom``, byte for byte
the same text for the same snapshot.

Mapping:
  - counters   → ``counter`` families named ``ipc_<name>_total``
  - gauges     → ``gauge`` families (plus ``ipc_uptime_seconds``)
  - histograms → ``summary`` families with ``quantile`` labels from the
    ring-buffer percentiles and lifetime ``_sum``/``_count``
  - stage timers → three counter families labeled by ``stage`` (busy
    seconds, interval-union wall seconds, entry calls)

Metric names are sanitized to ``[a-zA-Z_:][a-zA-Z0-9_:]*`` (dots and
dashes become underscores); label values are escaped per the spec.
"""

from __future__ import annotations

import re

__all__ = ["render_prometheus", "CONTENT_TYPE"]

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_NAME_BAD = re.compile(r"[^a-zA-Z0-9_:]")


def _name(raw: str) -> str:
    out = _NAME_BAD.sub("_", raw)
    if not out or not (out[0].isalpha() or out[0] in "_:"):
        out = "_" + out
    return "ipc_" + out


def _fmt(value) -> str:
    if isinstance(value, bool):
        return "1" if value else "0"
    if isinstance(value, int):
        return str(value)
    return format(float(value), ".10g")


def _label_escape(value: str) -> str:
    return value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def render_prometheus(snapshot: dict) -> str:
    """Render a `Metrics.snapshot()` dict as Prometheus exposition text."""
    lines: list[str] = []

    def family(name: str, kind: str, help_text: str) -> None:
        lines.append(f"# HELP {name} {help_text}")
        lines.append(f"# TYPE {name} {kind}")

    counters = snapshot.get("counters", {})
    for raw in sorted(counters):
        name = _name(raw) + "_total"
        family(name, "counter", f"Counter {raw}")
        lines.append(f"{name} {_fmt(counters[raw])}")

    gauges = dict(snapshot.get("gauges", {}))
    uptime = snapshot.get("uptime_s")
    if uptime is not None:
        family("ipc_uptime_seconds", "gauge", "Seconds since Metrics creation")
        lines.append(f"ipc_uptime_seconds {_fmt(uptime)}")
    for raw in sorted(gauges):
        name = _name(raw)
        family(name, "gauge", f"Gauge {raw}")
        lines.append(f"{name} {_fmt(gauges[raw])}")

    timers = snapshot.get("timers", {})
    if timers:
        specs = (
            ("ipc_stage_busy_seconds_total", "total_s", "Per-stage busy seconds"),
            ("ipc_stage_wall_seconds_total", "wall_s", "Per-stage union wall seconds"),
            ("ipc_stage_calls_total", "calls", "Per-stage entry count"),
        )
        for fam, key, help_text in specs:
            family(fam, "counter", help_text)
            for raw in sorted(timers):
                stage = _label_escape(raw)
                lines.append(f'{fam}{{stage="{stage}"}} {_fmt(timers[raw][key])}')

    hists = snapshot.get("histograms", {})
    for raw in sorted(hists):
        h = hists[raw]
        name = _name(raw)
        family(name, "summary", f"Summary {raw} (ring-buffer percentiles)")
        for pkey, q in (("p50", "0.5"), ("p90", "0.9"), ("p99", "0.99")):
            if pkey in h:
                lines.append(f'{name}{{quantile="{q}"}} {_fmt(h[pkey])}')
        count = h.get("count", 0)
        mean = h.get("mean", 0.0)
        lines.append(f"{name}_sum {_fmt(mean * count)}")
        lines.append(f"{name}_count {_fmt(count)}")

    return "\n".join(lines) + "\n"
