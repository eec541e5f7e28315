"""Runtime lock-order witness (opt-in lockdep).

The counterpart of ``ipc_proofs_tpu.utils.lockdep``, so that one knob
covers the port's locks too: run any workload with ``IPC_LOCKDEP=1`` and
every lock the port constructs through the ``named_lock`` / ``named_rlock`` /
``named_condition`` factories (plus the ``flock_frame`` file-lock
wrapper) feeds per-thread acquisition stacks into one process-wide order
graph.  The first *observed* inversion — thread 1 witnessed ``A < B``,
thread 2 now tries ``B`` then ``A`` — raises :class:`LockOrderError` at
the acquisition site of the second lock, BEFORE the process can actually
deadlock; the same witness catches cross-process ``flock`` ordering
against in-process locks, which no thread-only detector can see.

Knobs (all read at import; tests drive :func:`enable` directly):

- ``IPC_LOCKDEP`` — ``1``/``strict``/``on``: raise on violations.
  ``soft``/``record``: record into :func:`violations` and keep running.
  Unset/empty: the factories return *plain* ``threading`` primitives — zero overhead,
  which is why every construction site goes through them
  unconditionally.
- ``IPC_LOCKDEP_HOLD_MS`` — hold-time budget in milliseconds; a lock
  held longer is a ``hold`` violation at release.  0/unset disables the
  budget (CI boxes stall arbitrarily; the budget is a profiling tool,
  not a default gate).

Lock names are ``ClassName.attr`` / ``modbase.var`` / ``flock:<name>``,
the ids the reference's static checker derives.

Violation kinds: ``inversion`` (raises in strict mode only),
``hold`` (raises in strict mode only), and ``reentry`` — a
non-reentrant lock re-acquired by its holding thread, which ALWAYS
raises, even fail-soft: proceeding would deadlock the thread on itself,
and a hung process out-reports no recorder.

``Condition.wait()`` releases the underlying lock for the duration of
the wait, so the tracked condition pops itself from the holder's stack
around the wait and re-pushes after — waiting is not holding.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

try:
    import fcntl
except ImportError:  # pragma: no cover - non-POSIX: flock degrades to a plain open file
    fcntl = None

from ipc_proofs_tpu_torch.utils.log import get_logger

__all__ = [
    "LockOrderError",
    "enable",
    "disable",
    "enabled",
    "flock_frame",
    "named_condition",
    "named_lock",
    "named_rlock",
    "note_flock_acquired",
    "order_graph",
    "reset",
    "violations",
]


def _logger():
    """This module's logger, resolved at first use: configuring logging
    builds the flight recorder, whose lock this module makes."""
    return get_logger(__name__)


_MAX_VIOLATIONS = 256


class LockOrderError(RuntimeError):
    """A lock-order inversion / re-entry / hold-budget violation."""


def _caller_site() -> str:
    """First stack frame outside this module — the acquisition site."""
    frame = sys._getframe(1)
    while frame is not None and frame.f_globals.get("__name__") in (
        __name__, "contextlib",
    ):
        frame = frame.f_back
    if frame is None:  # pragma: no cover - only if called from module top level
        return "<unknown>"
    return f"{os.path.basename(frame.f_code.co_filename)}:{frame.f_lineno}"


class _State:
    """The process-wide order graph + per-thread acquisition stacks."""

    def __init__(self, strict: bool, hold_budget_ms: float):
        self.strict = strict
        self.hold_budget_s = max(0.0, hold_budget_ms) / 1000.0
        # the bookkeeping lock is a PLAIN threading.Lock on purpose: it
        # is internal, leaf-by-construction, and must never feed itself
        self._glock = threading.Lock()
        # (held, acquired) -> site where that order was first witnessed
        self._edges: Dict[Tuple[str, str], str] = {}  # guarded-by: _glock
        self._violations: deque = deque(maxlen=_MAX_VIOLATIONS)  # guarded-by: _glock
        self._reported: set = set()  # guarded-by: _glock
        self._tls = threading.local()

    # -- per-thread stack --------------------------------------------------

    def _stack(self) -> List[Tuple[str, float]]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = []
            self._tls.stack = stack
        return stack

    # -- violation plumbing ------------------------------------------------

    def _violation(
        self,
        kind: str,
        lock: str,
        other: Optional[str],
        detail: str,
        always_raise: bool = False,
    ) -> None:
        rec = {
            "kind": kind,
            "lock": lock,
            "other": other,
            "thread": threading.current_thread().name,
            "detail": detail,
        }
        key = (kind, lock, other)
        with self._glock:
            if key in self._reported:
                return
            self._reported.add(key)
            self._violations.append(rec)
        _logger().warning("lockdep %s: %s", kind, detail)
        if always_raise or self.strict:
            raise LockOrderError(detail)

    # -- acquisition protocol ----------------------------------------------

    def before_acquire(self, name: str, reentrant: bool, will_block: bool) -> None:
        stack = self._stack()
        held = [h for h, _ in stack]
        if name in held and not reentrant:
            self._violation(
                "reentry", name, name,
                f"non-reentrant lock '{name}' re-acquired by its holder "
                f"({threading.current_thread().name}) at {_caller_site()} — "
                f"guaranteed self-deadlock",
                always_raise=True,
            )
            return
        if not will_block or not held:
            return  # a trylock never waits, so it can never deadlock
        inverted: Optional[Tuple[str, str]] = None
        with self._glock:
            for h in held:
                if (name, h) in self._edges:
                    inverted = (h, self._edges[(name, h)])
                    break
        if inverted is not None:
            other, first_site = inverted
            self._violation(
                "inversion", name, other,
                f"acquiring '{name}' while holding '{other}' at "
                f"{_caller_site()}, but the opposite order "
                f"('{name}' before '{other}') was witnessed at {first_site} "
                f"— ABBA deadlock",
            )

    def after_acquire(self, name: str, add_edges: bool = True) -> None:
        stack = self._stack()
        if add_edges and stack:
            with self._glock:
                missing = [h for h, _ in stack if (h, name) not in self._edges]
            if missing:
                site = _caller_site()
                with self._glock:
                    for h in missing:
                        self._edges.setdefault((h, name), site)
        stack.append((name, time.perf_counter()))

    def note_release(self, name: str, check_hold: bool = True) -> None:
        stack = self._stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i][0] == name:
                _, t0 = stack.pop(i)
                if check_hold and self.hold_budget_s > 0.0:
                    held_s = time.perf_counter() - t0
                    if held_s > self.hold_budget_s:
                        self._violation(
                            "hold", name, None,
                            f"lock '{name}' held {held_s * 1000.0:.1f} ms "
                            f"(budget {self.hold_budget_s * 1000.0:.0f} ms), "
                            f"released at {_caller_site()}",
                        )
                return
        # releasing something this thread never tracked (acquired before
        # enable(), or handed across threads): nothing to unwind

    def touch(self, name: str) -> None:
        """Witness a non-scoped acquisition (a lease held for the process
        lifetime): edges from everything held, no stack entry."""
        stack = self._stack()
        if stack:
            with self._glock:
                missing = [h for h, _ in stack if (h, name) not in self._edges]
            if missing:
                site = _caller_site()
                with self._glock:
                    for h in missing:
                        self._edges.setdefault((h, name), site)


_state: Optional[_State] = None


def _env_hold_ms() -> float:
    raw = os.environ.get("IPC_LOCKDEP_HOLD_MS", "").strip()
    if not raw:
        return 0.0
    try:
        return float(raw)
    except ValueError:
        _logger().warning("ignoring non-numeric IPC_LOCKDEP_HOLD_MS=%r", raw)
        return 0.0


def enable(strict: bool = True, hold_budget_ms: Optional[float] = None) -> None:
    """Switch lockdep on (tests; the env path calls this at import)."""
    global _state
    _state = _State(strict, _env_hold_ms() if hold_budget_ms is None else hold_budget_ms)


def disable() -> None:
    global _state
    _state = None


def enabled() -> bool:
    return _state is not None


def reset() -> None:
    """Clear the order graph and recorded violations (test isolation)."""
    state = _state
    if state is not None:
        with state._glock:
            state._edges.clear()
            state._violations.clear()
            state._reported.clear()


def violations() -> List[dict]:
    state = _state
    if state is None:
        return []
    with state._glock:
        return list(state._violations)


def order_graph() -> Dict[Tuple[str, str], str]:
    """Copy of the witnessed (held, acquired) -> first-site edge map."""
    state = _state
    if state is None:
        return {}
    with state._glock:
        return dict(state._edges)


# -- tracked primitives ----------------------------------------------------


class _TrackedLock:
    """threading.Lock with named lockdep bookkeeping."""

    def __init__(self, name: str):
        self._name = name
        self._inner = threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        state = _state
        will_block = blocking and timeout == -1
        if state is not None:
            state.before_acquire(self._name, reentrant=False, will_block=will_block)
        ok = self._inner.acquire(blocking, timeout)
        if ok and state is not None:
            state.after_acquire(self._name, add_edges=will_block)
        return ok

    def release(self) -> None:
        state = _state
        if state is not None:
            state.note_release(self._name)
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<_TrackedLock {self._name!r} {self._inner!r}>"


class _TrackedRLock:
    """threading.RLock with named lockdep bookkeeping (re-entry is legal
    and tracked as depth, not as a new acquisition)."""

    def __init__(self, name: str):
        self._name = name
        self._inner = threading.RLock()
        self._owner: Optional[int] = None
        self._depth = 0

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        me = threading.get_ident()
        if self._owner == me:  # re-entry: depth only, no graph events
            self._inner.acquire()
            self._depth += 1
            return True
        state = _state
        will_block = blocking and timeout == -1
        if state is not None:
            state.before_acquire(self._name, reentrant=True, will_block=will_block)
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            self._owner = me
            self._depth = 1
            if state is not None:
                state.after_acquire(self._name, add_edges=will_block)
        return ok

    def release(self) -> None:
        if self._owner == threading.get_ident() and self._depth > 1:
            self._depth -= 1
            self._inner.release()
            return
        self._owner = None
        self._depth = 0
        state = _state
        if state is not None:
            state.note_release(self._name)
        self._inner.release()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<_TrackedRLock {self._name!r} depth={self._depth}>"


class _TrackedCondition:
    """threading.Condition with named lockdep bookkeeping.

    Wraps a private *real* Condition rather than accepting a tracked
    lock: the stock ``Condition._is_owned`` probes ``lock.acquire(False)``
    internally, which would feed phantom trylock events into the graph.
    """

    def __init__(self, name: str):
        self._name = name
        self._cond = threading.Condition()

    def acquire(self, *args) -> bool:
        state = _state
        if state is not None:
            state.before_acquire(self._name, reentrant=False, will_block=not args)
        ok = self._cond.acquire(*args)
        if ok and state is not None:
            state.after_acquire(self._name, add_edges=not args)
        return ok

    def release(self) -> None:
        state = _state
        if state is not None:
            state.note_release(self._name)
        self._cond.release()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def wait(self, timeout: Optional[float] = None) -> bool:
        # wait() releases the condition for its duration: pop around it
        # so "waiting" never reads as "holding" (no hold-budget hit, no
        # edges from a lock we do not actually hold)
        state = _state
        if state is not None:
            state.note_release(self._name, check_hold=False)
        try:
            return self._cond.wait(timeout)
        finally:
            if state is not None:
                state.after_acquire(self._name, add_edges=False)

    def wait_for(self, predicate, timeout: Optional[float] = None):
        state = _state
        if state is not None:
            state.note_release(self._name, check_hold=False)
        try:
            return self._cond.wait_for(predicate, timeout)
        finally:
            if state is not None:
                state.after_acquire(self._name, add_edges=False)

    def notify(self, n: int = 1) -> None:
        self._cond.notify(n)

    def notify_all(self) -> None:
        self._cond.notify_all()

    def __repr__(self) -> str:
        return f"<_TrackedCondition {self._name!r}>"


# -- construction-site factories -------------------------------------------


def named_lock(name: str):
    """A ``threading.Lock`` (plain when lockdep is off, tracked when on)."""
    if _state is None:
        return threading.Lock()
    return _TrackedLock(name)


def named_rlock(name: str):
    if _state is None:
        return threading.RLock()
    return _TrackedRLock(name)


def named_condition(name: str):
    if _state is None:
        return threading.Condition()
    return _TrackedCondition(name)


@contextmanager
def flock_frame(path: str, name: str, exclusive: bool = True, blocking: bool = True):
    """Open ``path`` and hold an ``fcntl.flock`` on it for the block.

    The flock joins the SAME order graph as the thread locks under the id
    ``flock:<name>``: a thread lock taken around a file lock in one process
    and the opposite nesting in another is a cross-process deadlock no
    thread-local detector can witness.  Raises ``OSError`` when
    ``blocking=False`` and the lock is busy.  On platforms without
    ``fcntl`` the file is opened unlocked.
    """
    fh = open(path, "ab")
    lname = f"flock:{name}"
    acquired = False
    try:
        if fcntl is not None:
            op = fcntl.LOCK_EX if exclusive else fcntl.LOCK_SH
            if not blocking:
                op |= fcntl.LOCK_NB
            state = _state
            if state is not None:
                state.before_acquire(lname, reentrant=False, will_block=blocking)
            fcntl.flock(fh.fileno(), op)
            acquired = True
            if state is not None:
                state.after_acquire(lname, add_edges=blocking)
        yield fh
    finally:
        state = _state
        if acquired and state is not None:
            state.note_release(lname)
        fh.close()  # closing the fd releases the flock


def note_flock_acquired(name: str) -> None:
    """Witness a non-scoped flock acquisition (a lifetime lease like the
    follower's leader election): edges from currently held locks, no stack
    entry, since the lease outlives the acquiring frame and may be released
    by another thread."""
    state = _state
    if state is not None:
        state.touch(f"flock:{name}")


# read the env exactly once, at import: construction sites call the
# factories unconditionally, so enablement must be decided before the
# first lock is built
_env = os.environ.get("IPC_LOCKDEP", "").strip().lower()
if _env in ("1", "true", "on", "strict"):
    enable(strict=True)
elif _env in ("soft", "record", "2"):
    enable(strict=False)
