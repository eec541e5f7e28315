"""Stage timers, counters and gauges for the range drivers and the cold
read path.

The counterpart of ``ipc_proofs_tpu.utils.metrics.Metrics`` (its stage
timers, counters, gauges, snapshot and process-global `get_metrics`; not
its histograms or the trace span each stage opens there, which waits for
the port's ``obs/``). The same ``stage()`` / ``count()`` calls and names
(``range_scan``, ``range_match``, ``range_record``, ``range_merge``,
``range_verify``; the ``rpc.*``, ``fetch.*``, ``storex.*`` and
``verify.*`` counters of the cold read path, each a name the reference
declares in its vocabularies, as ``tests/test_torch_rpc.py`` checks), so a
caller reads both packages alike.
Times are host wall-clock seconds.

Each stage keeps its busy seconds (``total_s``: the sum over every entry,
so 8 workers × 1 s is 8 s) and its wall seconds (``wall_s``: the union of
its entry intervals, ~1 s for the same 8 overlapping workers). A union wall
runs across all stages, and ``overlap_efficiency`` is busy over that union
wall: 1.0 for serial code, towards N for N stages that overlap.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass

from ipc_proofs_tpu_torch.utils.lockdep import named_lock

__all__ = [
    "Metrics",
    "StageTimer",
    "get_metrics",
]


@dataclass
class StageTimer:
    """One named stage's busy time and the union of its entry intervals."""

    total_s: float = 0.0
    calls: int = 0
    wall_s: float = 0.0
    _active: int = 0  # concurrent (outermost) entries right now
    _wall_start: float = 0.0  # perf_counter when _active went 0 -> 1


class Metrics:
    """Thread-safe stage timers, counters and gauges.

    ``stage()`` is re-entrant per thread: nesting the SAME stage name on one
    thread counts only the outermost entry. Pipeline workers timing one
    stage from N threads add their busy time while ``wall_s`` tracks the
    interval union.
    """

    def __init__(self):
        # every subsystem counts while holding its own lock, so this lock
        # is a terminal leaf of the acquisition order
        self._lock = named_lock("Metrics._lock")
        self._tls = threading.local()
        self.timers: "dict[str, StageTimer]" = {}  # guarded-by: _lock
        self.counters: "dict[str, int]" = {}  # guarded-by: _lock
        self.gauges: "dict[str, float]" = {}  # guarded-by: _lock
        self._union_active = 0  # guarded-by: _lock
        self._union_start = 0.0  # guarded-by: _lock
        self.union_wall_s = 0.0  # guarded-by: _lock

    @property
    def stage_s(self) -> "dict[str, float]":
        """Busy seconds per stage (a copy)."""
        with self._lock:
            return {name: timer.total_s for name, timer in self.timers.items()}

    @contextmanager
    def stage(self, name: str):
        depths = getattr(self._tls, "depths", None)
        if depths is None:
            depths = self._tls.depths = {}
        if depths.get(name, 0):
            # same-thread re-entry: the outermost entry covers this interval
            depths[name] += 1
            try:
                yield
            finally:
                depths[name] -= 1
            return
        depths[name] = 1
        try:
            start = time.perf_counter()
            with self._lock:
                timer = self.timers.setdefault(name, StageTimer())
                if timer._active == 0:
                    timer._wall_start = start
                timer._active += 1
                if self._union_active == 0:
                    self._union_start = start
                self._union_active += 1
            try:
                yield
            finally:
                end = time.perf_counter()
                with self._lock:
                    timer.total_s += end - start
                    timer.calls += 1
                    timer._active -= 1
                    if timer._active == 0:
                        timer.wall_s += end - timer._wall_start
                    self._union_active -= 1
                    if self._union_active == 0:
                        self.union_wall_s += end - self._union_start
        finally:
            depths[name] -= 1
            if not depths[name]:
                del depths[name]

    def overlap_efficiency(self) -> "float | None":
        """Busy over union wall across all stages; None before any stage
        completed."""
        with self._lock:
            busy = sum(t.total_s for t in self.timers.values())
            wall = self.union_wall_s
        return (busy / wall) if wall > 0 else None

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def counter_value(self, name: str) -> int:
        with self._lock:
            return self.counters.get(name, 0)

    def set_gauge(self, name: str, value: float) -> None:
        """Instantaneous state; last write wins."""
        with self._lock:
            self.gauges[name] = value

    def snapshot(self) -> dict:
        with self._lock:
            out = {
                "timers": {
                    k: {"total_s": round(v.total_s, 6), "calls": v.calls, "wall_s": round(v.wall_s, 6)}
                    for k, v in self.timers.items()
                },
                "counters": dict(self.counters),
            }
            busy = sum(t.total_s for t in self.timers.values())
            if self.union_wall_s > 0:
                out["overlap_efficiency"] = round(busy / self.union_wall_s, 4)
            if self.gauges:
                out["gauges"] = dict(self.gauges)
            return out


_global = Metrics()


def get_metrics() -> Metrics:
    """The process-global `Metrics` that the RPC client, the fetch plane and
    the blockstores count into when no instance is passed."""
    return _global
