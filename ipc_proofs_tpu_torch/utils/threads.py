"""One shared thread budget for the range drivers.

The counterpart of ``ipc_proofs_tpu.utils.threads``. Three knobs would
otherwise multiply into oversubscription: the scan *stage* worker count,
the native scanner's *per-C-call* pthread fan-out (``IPC_SCAN_THREADS``),
and the record/verify stage workers. With 8 scan workers each fanning a C
call out to 8 pthreads, an 8-CPU host runs 64 scanner threads.

`resolve_thread_budget` collapses all of it into ONE total (`--threads`
flag > ``IPC_THREADS`` env > legacy ``--scan-threads`` flag > legacy
``IPC_SCAN_THREADS`` env > CPU affinity) and partitions that total over
the pipeline stages: roughly half to scan (the walk-heavy stage), the
rest split between record and verify. The native per-call fan-out is the
budget DIVIDED by the scan workers, so ``scan_workers ×
native_scan_threads`` never exceeds the total — the oversubscription
fix. The effective budget is logged once per distinct resolution so an
operator can read the actual parallelism out of any run's log.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Mapping, Optional

from ipc_proofs_tpu_torch.utils.lockdep import named_lock
from ipc_proofs_tpu_torch.utils.log import get_logger

__all__ = ["ThreadBudget", "locked", "resolve_thread_budget"]


def locked(fn):
    """Document that a method's CALLER must already hold the instance lock
    guarding the attributes it touches. Pure annotation: no runtime
    behavior."""
    return fn


# after `locked`: the first logger configures logging, which imports
# `obs`, whose `slo` imports `locked` from this module
logger = get_logger(__name__)


_log_lock = named_lock("threads._log_lock")
_logged: "set[tuple]" = set()  # guarded-by: _log_lock


@dataclass(frozen=True)
class ThreadBudget:
    """The resolved, partitioned thread budget for one range run."""

    total: int  # the shared budget every count below divides
    scan_workers: int  # scan+match stage workers
    record_workers: int  # record stage workers
    verify_workers: int  # verify stage workers (used only with a verify stage)
    native_scan_threads: int  # per-C-call pthread fan-out inside one scan
    source: str  # which knob set `total` (for the log line)


def _read_int(env: Mapping[str, str], key: str) -> Optional[int]:
    raw = env.get(key, "")
    if not raw:
        return None
    try:
        return int(raw)
    except ValueError:
        logger.warning("ignoring non-integer %s=%r", key, raw)
        return None


def _affinity_cores() -> int:
    try:
        return len(os.sched_getaffinity(0)) or 1
    except (AttributeError, OSError):
        return os.cpu_count() or 1


def resolve_thread_budget(
    threads: Optional[int] = None,
    scan_threads: Optional[int] = None,
    env: Optional[Mapping[str, str]] = None,
    log: bool = True,
) -> ThreadBudget:
    """Resolve the shared budget and its per-stage partition.

    ``threads`` is the ``--threads`` flag (highest precedence),
    ``scan_threads`` the legacy ``--scan-threads`` flag. The legacy flag
    beats the legacy ``IPC_SCAN_THREADS`` env (flag wins, env is the
    fallback) but loses to both unified knobs. When the legacy scan knob
    decides the total, it also pins the scan stage to exactly that many
    workers — its historical meaning.
    """
    env = os.environ if env is None else env
    scan_override: Optional[int] = None
    if threads is not None and int(threads) > 0:
        total, source = int(threads), "--threads"
    elif (v := _read_int(env, "IPC_THREADS")) is not None and v > 0:
        total, source = v, "IPC_THREADS"
    elif scan_threads is not None and int(scan_threads) > 0:
        total, source = int(scan_threads), "--scan-threads"
        scan_override = int(scan_threads)
    elif (v := _read_int(env, "IPC_SCAN_THREADS")) is not None and v > 0:
        total, source = v, "IPC_SCAN_THREADS"
        scan_override = v
    else:
        total, source = _affinity_cores(), "cpu-affinity"
    total = max(1, min(64, total))
    # an explicit --scan-threads alongside a unified knob still pins the
    # scan stage; the unified total only governs the rest of the split
    if scan_threads is not None and int(scan_threads) > 0:
        scan_override = int(scan_threads)

    scan = max(1, min(64, scan_override)) if scan_override else max(1, (total + 1) // 2)
    rest = max(0, total - scan)
    record = max(1, (rest + 1) // 2)
    verify = max(1, rest - (rest + 1) // 2)
    native = max(1, total // scan)
    budget = ThreadBudget(
        total=total,
        scan_workers=scan,
        record_workers=record,
        verify_workers=verify,
        native_scan_threads=native,
        source=source,
    )
    if log:
        key = (total, scan, record, verify, native, source)
        with _log_lock:
            first = key not in _logged
            if first:
                _logged.add(key)
        if first:
            logger.info(
                "thread budget: total=%d (%s) scan=%d record=%d verify=%d "
                "native_scan=%d",
                total, source, scan, record, verify, native,
            )
    return budget
