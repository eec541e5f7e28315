"""What the host did over the window, read in every run: the process's CPU
seconds (all its threads), the CPU seconds of the thread that opened the
window and of the busiest others alive at its close, the collector's
pauses by generation, and the seconds a fixed pure-Python loop takes just
after the window (`calibrate`: the host core's speed at that moment, the
same work in every run).

The thread readings are Linux only (``/proc/self/task``), and left out
elsewhere. Nothing here changes what it watches; the collector's callback
only reads the clock.
"""

from __future__ import annotations

import gc
import os
import threading
import time
from collections import defaultdict

__all__ = ["HostWatch", "calibrate"]


def _threads() -> "dict[int, tuple[str, float]]":
    """Each thread of this process: ``tid -> (name, CPU seconds)``."""
    out = {}
    tick = os.sysconf("SC_CLK_TCK")
    try:
        tids = os.listdir("/proc/self/task")
    except OSError:
        return out
    for tid in tids:
        try:
            with open(f"/proc/self/task/{tid}/stat") as f:
                raw = f.read()
        except OSError:
            continue
        name = raw[raw.index("(") + 1 : raw.rindex(")")]
        fields = raw[raw.rindex(")") + 2 :].split()
        out[int(tid)] = (name, (int(fields[11]) + int(fields[12])) / tick)
    return out


def calibrate(n: int = 2_000_000) -> float:
    """Seconds of a fixed pure-Python loop (integer arithmetic, no
    allocation that outlives an iteration)."""
    t0 = time.perf_counter()
    acc = 0
    for i in range(n):
        acc = (acc + i * i) & 0xFFFFFFFF
    return time.perf_counter() - t0


class HostWatch:
    def __init__(self):
        self.pauses: dict = defaultdict(float)  # generation -> seconds
        self.counts: dict = defaultdict(int)
        self._gc_t0 = None

    def _on_gc(self, phase, info) -> None:
        if phase == "start":
            self._gc_t0 = time.perf_counter()
        elif self._gc_t0 is not None:
            self.pauses[info["generation"]] += time.perf_counter() - self._gc_t0
            self.counts[info["generation"]] += 1
            self._gc_t0 = None

    def start(self) -> None:
        self._t0 = time.perf_counter()
        self._cpu0 = os.times()
        self._threads0 = _threads()
        self._tid = threading.get_native_id()
        gc.callbacks.append(self._on_gc)

    def stop(self) -> dict:
        gc.callbacks.remove(self._on_gc)
        wall = time.perf_counter() - self._t0
        cpu1, threads1 = os.times(), _threads()
        used = {tid: s - self._threads0.get(tid, (name, 0.0))[1]
                for tid, (name, s) in threads1.items()}
        others = sorted(((threads1[t][0], s) for t, s in used.items() if t != self._tid),
                        key=lambda t: -t[1])[:4]
        return {
            "wall_s": wall,
            "cpu_s": (cpu1.user - self._cpu0.user) + (cpu1.system - self._cpu0.system),
            "window_thread_cpu_s": used.get(self._tid),
            "others": [[name, round(s, 2)] for name, s in others],
            "threads": len(threads1),
            "gc_pause_s": sum(self.pauses.values()),
            "gc_pause_by_generation": dict(self.pauses),
            "gc_collections": dict(self.counts),
        }
