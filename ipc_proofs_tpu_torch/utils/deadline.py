"""Request deadlines and cooperative cancellation.

The counterpart of ``ipc_proofs_tpu.utils.deadline``: the serve plane's
overload-survival primitives, which the range drivers already honour.

- `Deadline` — an absolute monotonic-clock budget. Every hop of a
  request (router -> shard -> durable queue -> micro-batcher -> range
  driver -> pipeline stage -> fetch plane -> RPC retry) derives its
  remaining budget from the SAME absolute instant, so elapsed time at
  one hop is automatically subtracted from every later hop. A hop that
  cannot cover its own floor refuses the work with a typed
  `DeadlineError` instead of producing a partial bundle.

- `CancelScope` — a contextvar-carried cancellation token checked
  cooperatively at chunk/stage/retry boundaries. Cancelling a scope
  (client disconnect, deadline expiry) makes every `checkpoint()` call
  under it raise, so abandoned in-flight generation stops consuming
  workers instead of running to completion.

Both are ambient: code deep in the drivers calls `checkpoint()` with no
arguments and pays nothing when no scope is installed (the common path
for library users and the test suite). `use_scope` installs a scope for
a `with` block; `current_scope()` reads it.

The module lives in `utils` (not `serve`) because `parallel/` and
`proofs/` import it and must not depend on a serve plane.
"""

from __future__ import annotations

import contextlib
import contextvars
import time
from typing import Iterator, Optional

__all__ = [
    "CancelledError",
    "CancelScope",
    "Deadline",
    "DeadlineError",
    "checkpoint",
    "current_scope",
    "remaining_budget_s",
    "use_scope",
]


class DeadlineError(RuntimeError):
    """A request's remaining budget cannot cover the work.

    Typed (`error_type == "deadline"`) so every door — buffered JSON,
    IPBS stream in-band abort, router scatter merge — renders the same
    contract: a deadline loss is a whole typed error, never a partial
    or silently-truncated bundle.
    """

    error_type = "deadline"

    def __init__(self, message: str = "deadline exceeded", *, stage: str = ""):
        super().__init__(message)
        self.stage = stage


class CancelledError(DeadlineError):
    """The request was abandoned (client disconnect / explicit cancel).

    Subclasses `DeadlineError` so every existing typed-deadline handler
    (504 mapping, in-band stream abort, admission replay filter) treats
    an abandoned request exactly like an expired one: the work is dead
    either way and must stop, not finish.
    """

    error_type = "cancelled"

    def __init__(self, message: str = "request cancelled", *, stage: str = ""):
        super().__init__(message, stage=stage)


class Deadline:
    """Absolute monotonic-clock deadline with per-hop floor checks."""

    __slots__ = ("expires_at", "_clock")

    def __init__(self, budget_s: float, clock=time.monotonic):
        self._clock = clock
        self.expires_at = clock() + max(0.0, float(budget_s))

    @classmethod
    def from_ms(cls, budget_ms: float, clock=time.monotonic) -> "Deadline":
        return cls(float(budget_ms) / 1000.0, clock=clock)

    def remaining_s(self) -> float:
        return self.expires_at - self._clock()

    def remaining_ms(self) -> float:
        return self.remaining_s() * 1000.0

    def expired(self) -> bool:
        return self.remaining_s() <= 0.0

    def check(self, floor_s: float = 0.0, stage: str = "") -> float:
        """Return the remaining budget; raise typed if it is below ``floor_s``.

        The floor is the hop's own minimum useful budget — admitting work
        it cannot finish just burns capacity that on-time requests need.
        """
        remaining = self.remaining_s()
        if remaining <= floor_s:
            raise DeadlineError(
                "deadline exceeded: %.0fms remaining < %.0fms floor%s"
                % (
                    remaining * 1000.0,
                    floor_s * 1000.0,
                    f" at {stage}" if stage else "",
                ),
                stage=stage,
            )
        return remaining


class CancelScope:
    """Cooperative cancellation token, optionally deadline-backed.

    Thread-safe by construction: ``_cancelled`` flips False->True once
    and is only ever read afterwards, so checks need no lock (benign
    race: a checkpoint concurrent with cancel() may run one extra
    chunk, which cooperative cancellation permits by definition).
    """

    __slots__ = ("deadline", "_cancelled", "_reason")

    def __init__(self, deadline: Optional[Deadline] = None):
        self.deadline = deadline
        self._cancelled = False
        self._reason = ""

    def cancel(self, reason: str = "cancelled") -> None:
        self._reason = reason
        self._cancelled = True

    @property
    def cancelled(self) -> bool:
        return self._cancelled

    @property
    def reason(self) -> str:
        return self._reason

    def expired(self) -> bool:
        return self.deadline is not None and self.deadline.expired()

    def check(self, stage: str = "") -> None:
        """Raise typed if this scope is cancelled or its deadline passed."""
        if self._cancelled:
            raise CancelledError(
                self._reason or "request cancelled", stage=stage
            )
        if self.deadline is not None:
            self.deadline.check(0.0, stage=stage)


_SCOPE: contextvars.ContextVar[Optional[CancelScope]] = contextvars.ContextVar(
    "ipc_cancel_scope", default=None
)


def current_scope() -> Optional[CancelScope]:
    """The ambient `CancelScope`, or None outside any request."""
    return _SCOPE.get()


@contextlib.contextmanager
def use_scope(scope: Optional[CancelScope]) -> Iterator[Optional[CancelScope]]:
    """Install ``scope`` as the ambient cancel scope for the block.

    ``None`` explicitly clears the ambient scope — a worker thread that
    serves many requests uses this to shed a previous request's scope.
    """
    token = _SCOPE.set(scope)
    try:
        yield scope
    finally:
        _SCOPE.reset(token)


def checkpoint(stage: str = "") -> None:
    """Raise typed `deadline`/`cancelled` if the ambient scope says stop.

    No-op (one contextvar read) when no scope is installed — drivers
    sprinkle this at chunk/stage/retry boundaries unconditionally.
    """
    scope = _SCOPE.get()
    if scope is not None:
        scope.check(stage=stage)


def remaining_budget_s(default: Optional[float] = None) -> Optional[float]:
    """Remaining seconds on the ambient scope's deadline, else ``default``.

    Lets budget-aware hops (RPC retry backoff, fetch-plane waits) bound
    their sleeps without threading a deadline parameter through every
    signature.
    """
    scope = _SCOPE.get()
    if scope is not None and scope.deadline is not None:
        return scope.deadline.remaining_s()
    return default
