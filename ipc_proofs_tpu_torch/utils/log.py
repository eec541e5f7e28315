"""Leveled logging for the port.

The counterpart of ``ipc_proofs_tpu.utils.log``: every module logs through
one logger tree,

    from ipc_proofs_tpu_torch.utils.log import get_logger
    log = get_logger(__name__)
    log.info("range: %d pairs", n)

under its own root, ``ipc_proofs_torch``, so a process that imports both
packages (the tests) gets one handler per package and no doubled lines.
Level comes from ``IPC_LOG_LEVEL`` (DEBUG/INFO/WARNING/ERROR, default INFO);
output is one stderr line per record with timestamp, level and logger name,
or, with ``IPC_LOG_FORMAT=json``, one JSON object per line carrying the
trace and span ids of the span open on the emitting thread
(`obs.trace.current_context`), so log lines correlate with exported spans.
The stderr handler attaches once to the root, and not at all when the
embedding application configured logging itself; whatever formats stderr,
WARN/ERROR records are mirrored into the always-on flight recorder
(`obs.flight`).
"""

from __future__ import annotations

import json
import logging
import os
import sys
import threading
import time

__all__ = ["get_logger", "JsonLineFormatter"]

_ROOT = "ipc_proofs_torch"
_configure_lock = threading.Lock()
_configured = False  # guarded-by: _configure_lock


class JsonLineFormatter(logging.Formatter):
    """One JSON object per record: ts/level/logger/msg, the active trace
    and span ids when a span is open on the emitting thread, and the
    exception text."""

    def format(self, record: logging.LogRecord) -> str:
        obj: dict = {
            "ts": round(record.created, 3),
            "time": time.strftime("%Y-%m-%dT%H:%M:%S", time.localtime(record.created)),
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
        }
        try:  # lazy import: log is imported by everything, obs only here
            from ipc_proofs_tpu_torch.obs.trace import current_context

            ctx = current_context()
            if ctx is not None:
                obj["trace_id"] = ctx.trace_id
                obj["span_id"] = ctx.span_id
        except Exception:  # fail-soft: trace decoration is best-effort — a log line without trace_id beats no log line
            pass
        if record.exc_info and record.exc_info[0] is not None:
            obj["exc"] = self.formatException(record.exc_info)
        return json.dumps(obj, separators=(",", ":"), default=str)


def _configure() -> None:
    global _configured
    with _configure_lock:
        if _configured:
            return
        _configured = True
    root = logging.getLogger(_ROOT)
    # the flight recorder mirrors WARN/ERROR records whatever handles
    # stderr; it never writes to a stream, so it composes with any setup
    from ipc_proofs_tpu_torch.obs.flight import FlightLogHandler

    root.addHandler(FlightLogHandler())
    # an application that configured the package's root or the process
    # root logger keeps its own handlers; records propagate through them
    app_handlers = [h for h in root.handlers if not isinstance(h, FlightLogHandler)]
    if app_handlers or logging.getLogger().handlers:
        if "IPC_LOG_LEVEL" in os.environ:
            level = os.environ["IPC_LOG_LEVEL"].upper()
            root.setLevel(getattr(logging, level, logging.INFO))
        return
    handler = logging.StreamHandler(sys.stderr)
    if os.environ.get("IPC_LOG_FORMAT", "").lower() == "json":
        handler.setFormatter(JsonLineFormatter())
    else:
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s", datefmt="%H:%M:%S")
        )
    root.addHandler(handler)
    level = os.environ.get("IPC_LOG_LEVEL", "INFO").upper()
    root.setLevel(getattr(logging, level, logging.INFO))
    root.propagate = False


def get_logger(name: str) -> logging.Logger:
    """A logger under the ``ipc_proofs_torch`` tree; ``name`` is typically
    ``__name__`` (the package prefix is normalized away)."""
    _configure()
    short = name.removeprefix("ipc_proofs_tpu_torch.")
    return logging.getLogger(f"{_ROOT}.{short}")
