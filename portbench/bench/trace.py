"""What a traced run records: the benchmark's host spans and the card's
timeline.

`Spans` keeps ``(name, start, end)`` host intervals (``time.perf_counter``
seconds) from any thread. `DeviceTimeline` runs ``torch.profiler`` with
CUDA activity only (recording every host op would slow the host path that
sets the pace) and returns each device operation (kernel, copy, memset) as
``(name, start, end)`` on the host's clock: one marker kernel (PyTorch's
``spin_kernel``, which the program never launches), launched and
synchronised just before the window opens, ties the two clocks. A profiler
run whose trace lacks the marker raises: a late session that saw nothing,
or only part of the window, never yields a share read from an empty trace.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict

__all__ = ["Spans", "DeviceTimeline", "MARKER", "align", "union", "union_seconds", "busy_and_gaps", "breakdown"]


class Spans:
    def __init__(self):
        self._lock = threading.Lock()
        self.items: "list[tuple[str, float, float]]" = []

    def add(self, name: str, start: float, end: float) -> None:
        with self._lock:
            self.items.append((name, start, end))

    def by_name(self) -> "dict[str, list[tuple[float, float]]]":
        out: dict = defaultdict(list)
        for name, start, end in self.items:
            out[name].append((start, end))
        return dict(out)


def union(intervals) -> "list[tuple[float, float]]":
    """Disjoint, sorted intervals covering the same time."""
    out: list = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            if end > out[-1][1]:
                out[-1] = (out[-1][0], end)
        else:
            out.append((start, end))
    return out


def union_seconds(intervals) -> float:
    return sum(end - start for start, end in union(intervals))


def busy_and_gaps(ops, window: "tuple[float, float]"):
    """Busy seconds of the device ops clipped to ``window``, and the idle
    gaps between them there."""
    lo, hi = window
    merged = union((max(s, lo), min(e, hi)) for _, s, e in ops if e > lo and s < hi)
    gaps, cursor = [], lo
    for start, end in merged:
        if start > cursor:
            gaps.append((cursor, start))
        cursor = end
    if cursor < hi:
        gaps.append((cursor, hi))
    return sum(e - s for s, e in merged), gaps


def breakdown(ops, gaps, spans: Spans, limit: int = 10) -> dict:
    """The device ops that took most time, by name, and the idle time by
    the innermost benchmark span the host was in at each gap's midpoint
    (``host`` where it was in none)."""
    by_op: dict = defaultdict(float)
    for name, start, end in ops:
        by_op[name] += end - start
    by_span: dict = defaultdict(float)
    items = sorted(spans.items, key=lambda s: s[1])
    active: list = []  # spans begun by the current midpoint, not yet known to have ended
    nxt = 0
    for g0, g1 in sorted(gaps):
        mid = (g0 + g1) / 2
        while nxt < len(items) and items[nxt][1] <= mid:
            active.append(items[nxt])
            nxt += 1
        active = [s for s in active if s[2] >= mid]
        name = max(active, key=lambda s: s[1])[0] if active else "host"
        by_span[name] += g1 - g0

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:limit]]

    return {"device_ops": top(by_op), "idle_gaps": top(by_span)}


MARKER = "spin_kernel"  # torch.cuda._sleep's kernel


def align(events, host_mark: float) -> "list[tuple[str, float, float]]":
    """Profiler events ``(name, start_ns, end_ns)`` on the host's clock,
    the marker left out: the first marker kernel ends as the host's
    synchronise returns at ``host_mark``. Raises without a marker."""
    markers = sorted((e for e in events if MARKER in e[0]), key=lambda e: e[1])
    if not markers:
        raise RuntimeError(f"the profiler's trace lacks the marker kernel ({MARKER}): "
                           f"{len(events)} device operations seen")
    offset = host_mark - markers[0][2] * 1e-9
    return [(name, s * 1e-9 + offset, e * 1e-9 + offset)
            for name, s, e in events if MARKER not in name]


class DeviceTimeline:
    """One ``torch.profiler`` run over the measured window."""

    def __init__(self):
        import torch

        self._torch = torch
        self._prof = None
        self._host_mark = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.start()
        self._torch.cuda._sleep(1000)
        self._torch.cuda.synchronize()
        self._host_mark = time.perf_counter()

    def stop(self) -> "list[tuple[str, float, float]]":
        self._torch.cuda.synchronize()
        self._prof.stop()
        from torch.autograd import DeviceType

        events = [
            (e.name(), e.start_ns(), e.end_ns())
            for e in self._prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA
        ]
        return align(events, self._host_mark)
