"""Always-on flight recorder: a bounded ring of the last N completed spans
plus recent WARN/ERROR log records.

The point is post-hoc diagnosis *without* having had tracing turned on:
the ring costs a lock + deque append per span (microseconds, bounded
memory) so it runs unconditionally, and when an unhandled exception
escapes a CLI command (`install_crash_dump`) the recent past is right
there. The counterpart of ``ipc_proofs_tpu.obs.flight``.
"""

from __future__ import annotations

import json
import logging
import sys
import time
import traceback
from collections import deque

from ipc_proofs_tpu_torch.utils.lockdep import named_lock

__all__ = [
    "FlightRecorder",
    "FlightLogHandler",
    "get_flight_recorder",
    "install_crash_dump",
]

DEFAULT_SPAN_CAPACITY = 256
DEFAULT_LOG_CAPACITY = 128


class FlightRecorder:
    """Two bounded rings (spans, WARN+ log records) behind one lock."""

    def __init__(
        self,
        span_capacity: int = DEFAULT_SPAN_CAPACITY,
        log_capacity: int = DEFAULT_LOG_CAPACITY,
    ):
        self._lock = named_lock("FlightRecorder._lock")
        self._spans: deque = deque(maxlen=span_capacity)  # guarded-by: _lock
        self._logs: deque = deque(maxlen=log_capacity)  # guarded-by: _lock

    def record_span(self, sp) -> None:
        with self._lock:
            self._spans.append(sp)

    def record_log(self, entry: dict) -> None:
        with self._lock:
            self._logs.append(entry)

    def snapshot(self) -> dict:
        """JSON-ready dump: newest-last spans and log records."""
        with self._lock:
            spans = [sp.to_dict() for sp in self._spans]
            logs = [dict(e) for e in self._logs]
            capacity = self._spans.maxlen
        return {
            "captured_at": round(time.time(), 3),
            "span_capacity": capacity,
            "spans": spans,
            "logs": logs,
        }

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self._logs.clear()

    def dump(self, stream=None) -> None:
        """Human-oriented dump to ``stream`` (default stderr) — called from
        the crash hook, so it must never raise."""
        try:
            stream = stream or sys.stderr
            snap = self.snapshot()
            stream.write("---- flight recorder ----\n")
            for e in snap["logs"]:
                stream.write(
                    f"[log] {e.get('level', '?')} {e.get('logger', '?')}: "
                    f"{e.get('msg', '')}\n"
                )
            for s in snap["spans"][-32:]:
                stream.write(
                    f"[span] {s['name']} trace={s['trace_id']} "
                    f"dur={s['dur_us'] / 1000.0:.2f}ms thread={s['thread']}\n"
                )
            stream.write("---- end flight recorder ----\n")
            stream.flush()
        except Exception:  # fail-soft: the crash dump runs inside an excepthook — it must never mask the original crash
            pass


_flight = FlightRecorder()


def get_flight_recorder() -> FlightRecorder:
    return _flight


class FlightLogHandler(logging.Handler):
    """Mirrors WARN/ERROR records into the flight ring (alongside whatever
    stderr handler is configured — this never formats to a stream)."""

    def __init__(self, recorder: "FlightRecorder | None" = None):
        super().__init__(level=logging.WARNING)
        self._recorder = recorder or _flight

    def emit(self, record: logging.LogRecord) -> None:
        try:
            entry = {
                "ts": round(record.created, 3),
                "level": record.levelname,
                "logger": record.name,
                "msg": record.getMessage(),
            }
            if record.exc_info and record.exc_info[0] is not None:
                entry["exc"] = "".join(
                    traceback.format_exception_only(
                        record.exc_info[0], record.exc_info[1]
                    )
                ).strip()
            self._recorder.record_log(entry)
        except Exception:  # fail-soft: a diagnostic channel must never take the app down
            pass


_hook_installed = False


def install_crash_dump() -> None:
    """Chain an excepthook that dumps the flight ring to stderr before the
    default traceback, so a crashing CLI run leaves its recent history.
    Once per process: a driver that calls the CLI's ``main`` many times
    dumps the ring once per crash, not once per call."""
    global _hook_installed
    if _hook_installed:
        return
    _hook_installed = True
    previous = sys.excepthook

    def _hook(exc_type, exc, tb):
        if not issubclass(exc_type, KeyboardInterrupt):
            _flight.dump(sys.stderr)
        previous(exc_type, exc, tb)

    sys.excepthook = _hook


def flight_to_json() -> str:
    return json.dumps(_flight.snapshot(), indent=2)
