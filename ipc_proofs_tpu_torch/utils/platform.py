"""Benchmark platform selection for ``bench_torch.py``.

The counterpart of ``ipc_proofs_tpu.utils.platform``. A CUDA driver or
card can fail to come up, or hang while it does, so 'auto' probes the
card in a subprocess with a timeout — a hung probe cannot hang the
caller — and RETRIES the probe several times with spacing before giving
up. A success is cached for the process.

One departure from the reference: when the retries run out, the reference
falls back to the CPU; here `pick_platform` raises `PlatformProbeError`,
naming each attempt's outcome. A bench that was meant for the card never
moves to the CPU behind the caller's back; the CPU runs only when it is
asked for by name.

Environment overrides:

* ``IPC_BENCH_PLATFORM=cpu|cuda|gpu|tpu|default`` — skip the probe entirely
  and use this platform (every name but ``cpu`` means the card).
* ``IPC_BENCH_PROBE_ATTEMPTS`` / ``IPC_BENCH_PROBE_SPACING`` — override the
  retry count / sleep between attempts (seconds).
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from typing import Callable, Optional

__all__ = ["PlatformProbeError", "pick_platform", "probed_platform_name"]

# the probe's child: it must see a card and prints its name (no JAX)
PROBE_CODE = "import torch; assert torch.cuda.is_available(); print(torch.cuda.get_device_name(0))"

# every platform name a caller may ask for, and what it runs on: the card
# ('cuda'), or the CPU only when asked for as 'cpu'
_ALIASES = {"cpu": "cpu", "cuda": "cuda", "gpu": "cuda", "tpu": "cuda", "default": "cuda"}


class PlatformProbeError(RuntimeError):
    """The 'auto' probe found no card within its attempts."""


def _default_log(*args) -> None:
    from ipc_proofs_tpu_torch.utils.log import get_logger

    get_logger(__name__).info(" ".join(str(a) for a in args))


# process-level cache: (resolved, device name) after a successful probe. A
# failed probe is not cached: it raised, and a later call probes again.
_cache: Optional[tuple[str, str]] = None


def probed_platform_name() -> Optional[str]:
    """The card's name (``torch.cuda.get_device_name(0)``) the last
    successful 'auto' probe reported, or None if no probe has succeeded."""
    return _cache[1] if _cache else None


def _resolve(name: str) -> str:
    try:
        return _ALIASES[name]
    except KeyError:
        raise ValueError(f"unknown platform {name!r} (expected auto, {', '.join(_ALIASES)})") from None


def pick_platform(
    requested: str,
    probe_timeout: float = 150.0,
    log: Callable[..., None] = _default_log,
    attempts: Optional[int] = None,
    spacing: Optional[float] = None,
) -> str:
    """Resolve a platform name to 'cuda' (the card) or 'cpu'.

    An explicit request passes through ('cpu' stays 'cpu'; 'cuda', 'gpu',
    'tpu' and 'default' are the card). The IPC_BENCH_PLATFORM env var
    short-circuits the probe. An 'auto' probe runs up to ``attempts``
    times (default 3, env-overridable), sleeping ``spacing`` seconds
    between failures (default 20), so one transient failure does not
    forfeit the card; when every attempt fails it raises
    `PlatformProbeError` with each attempt's outcome.
    """
    global _cache
    if requested != "auto":
        return _resolve(requested)
    if os.environ.get("IPC_BENCH_PLATFORM"):
        return _resolve(os.environ["IPC_BENCH_PLATFORM"])
    if _cache is not None:
        return _cache[0]

    if attempts is None:
        attempts = int(os.environ.get("IPC_BENCH_PROBE_ATTEMPTS", "3"))
    if spacing is None:
        spacing = float(os.environ.get("IPC_BENCH_PROBE_SPACING", "20"))

    outcomes: list[str] = []
    for attempt in range(1, max(attempts, 1) + 1):
        t0 = time.monotonic()
        name, outcome = _probe_once(probe_timeout, log, attempt, attempts)
        if name is not None:
            log(f"bench: card probe OK → {name!r}")
            _cache = ("cuda", name)
            return "cuda"
        outcomes.append(f"attempt {attempt}: {outcome}")
        if attempt < attempts:
            # a probe that failed FAST (no driver, no card — not a hang)
            # won't be fixed by waiting; still space retries out a little
            elapsed = time.monotonic() - t0
            delay = spacing if elapsed >= probe_timeout * 0.5 else min(spacing, 5.0)
            log(f"bench: retrying card probe in {delay:.0f}s "
                f"(attempt {attempt}/{attempts} failed)")
            time.sleep(delay)
    raise PlatformProbeError(
        "bench: the card probe failed on every attempt (no CPU fallback; pass "
        "--platform cpu to run on the CPU): " + "; ".join(outcomes)
    )


def _probe_once(
    probe_timeout: float, log: Callable[..., None], attempt: int, attempts: int
) -> "tuple[Optional[str], str]":
    """One subprocess probe; returns (the card's name or None, outcome)."""
    try:
        probe = subprocess.run(
            [sys.executable, "-c", PROBE_CODE],
            capture_output=True,
            timeout=probe_timeout,
            text=True,
        )
        if probe.returncode == 0 and probe.stdout.strip():
            return probe.stdout.strip().splitlines()[-1], "ok"
        tail = (probe.stderr.strip().splitlines() or [""])[-1]
        outcome = f"exited rc={probe.returncode}" + (f" ({tail})" if tail else "")
    except subprocess.TimeoutExpired:
        outcome = f"timed out after {probe_timeout:.0f}s"
    except Exception as exc:  # fail-soft: an attempt that cannot start is recorded; the exhausted probe raises
        outcome = f"failed ({exc})"
    log(f"bench: probe {attempt}/{attempts} {outcome}")
    return None, outcome
