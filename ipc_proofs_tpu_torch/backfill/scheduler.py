"""Work-ahead epoch scheduler: windows on ring arcs, lanes kept full.

The backfill engine proves deep history window by window. This module
owns the *shape* of that work:

- `plan_windows` partitions a contiguous pair range into fixed-size
  **epoch windows** and places each window on a ring arc via the same
  `cluster/hashring.py` consistent hashing the serve router uses for
  pair placement. Placement is derived from the window's FIRST pair
  identity (`window_ring_key`), so every process — engine, router,
  offline test — computes the identical window → node map, and a
  cluster backfill lands each window on the shard whose BlockCache is
  already warm for that arc. Like all ring affinity in this repo it is
  a cache hint, never a correctness constraint: the router's
  steal-aware dispatch may override it under imbalance.

- `WorkAheadFeeder` replaces the chunked driver's one-chunk-ahead
  spine offer (`proofs/range.py::_offer_chunk_spine`) with a
  *schedule-driven* feed: when window ``i`` starts executing, the
  headers of the next ``work_ahead`` not-yet-proven windows enter the
  fetch plane through `FetchPlane.prime` — the depth-gate-free lane —
  so the plane's speculative batches stay full ACROSS window
  boundaries even after adaptive backoff has lowered
  ``speculate_depth`` for link-chasing. The feeder never blocks and
  never raises; against a store without a plane it is a no-op.

Windows are the journal's unit of durability (window index == chunk
index in the IPJ1 record stream — see `backfill/engine.py`), so the
planner is deliberately deterministic: same range + window size →
same windows, byte for byte, on every run.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

from ipc_proofs_tpu_torch.cluster.hashring import HashRing, pair_ring_key

__all__ = [
    "EpochWindow",
    "WorkAheadFeeder",
    "plan_windows",
    "window_ring_key",
]


@dataclass(frozen=True)
class EpochWindow:
    """One schedulable slice of the backfill range.

    ``lo``/``hi`` are *global* pair-table indexes (half-open), so a
    window names the same epochs on the engine, the router, and every
    shard. ``index`` is the window ordinal within its job — also the
    journal chunk index its bundle commits under. ``node`` is the
    ring-arc owner chosen at planning time.
    """

    index: int
    lo: int
    hi: int
    node: str

    @property
    def n_epochs(self) -> int:
        return self.hi - self.lo

    def to_json_obj(self) -> dict:
        return {
            "index": self.index,
            "lo": self.lo,
            "hi": self.hi,
            "node": self.node,
            "n_epochs": self.n_epochs,
        }


def window_ring_key(pairs: Sequence, lo: int) -> str:
    """Ring key of the window starting at global pair index ``lo``.

    Deliberately THE SAME key interactive traffic for that pair routes
    under (`pair_ring_key`, content-derived): re-submitting the same
    epoch range always lands each window on the same arc, and the
    planned owner is exactly the shard whose BlockCache interactive
    requests for the window's leading pair have already warmed — the
    router's steal-aware dispatch under this key agrees with the plan
    unless imbalance says otherwise.
    """
    return pair_ring_key(pairs[lo])


def plan_windows(
    pairs: Sequence,
    start: int,
    end: int,
    window_size: int,
    nodes: Sequence[str],
    vnodes: int = 64,
) -> "list[EpochWindow]":
    """Partition ``pairs[start:end]`` into windows placed on ring arcs.

    Every caller with the same arguments computes the identical plan
    (sha256 ring points, no process state), which is what lets the
    crash-resume path re-derive window boundaries from the journal
    manifest alone.
    """
    if window_size < 1:
        raise ValueError("window_size must be >= 1")
    if not (0 <= start < end <= len(pairs)):
        raise ValueError(
            f"pair range [{start}, {end}) out of bounds for table of "
            f"{len(pairs)}"
        )
    if not nodes:
        raise ValueError("backfill plan needs at least one node")
    ring = HashRing(nodes, vnodes=vnodes)
    windows: "list[EpochWindow]" = []
    for index, lo in enumerate(range(start, end, window_size)):
        hi = min(lo + window_size, end)
        windows.append(
            EpochWindow(
                index=index,
                lo=lo,
                hi=hi,
                node=ring.node_for(window_ring_key(pairs, lo)),
            )
        )
    return windows


class WorkAheadFeeder:
    """Feed the fetch plane's speculative lanes from the schedule.

    ``plane`` needs a ``prime(cids)`` method (`store.fetchplane
    .FetchPlane`); anything else (including ``None``) disables the
    feeder. ``work_ahead`` is how many future windows' tipset headers
    are primed when a window starts — the plane chases receipt/state
    links from those headers on its own, so this keeps
    ``--speculate-depth`` lanes busy across the boundary where the
    per-chunk spine offer would have gone quiet.
    """

    def __init__(
        self,
        plane,
        pairs: Sequence,
        windows: Sequence[EpochWindow],
        work_ahead: int = 2,
    ):
        self._prime = getattr(plane, "prime", None)
        self._pairs = pairs
        self._windows = list(windows)
        self._work_ahead = max(0, int(work_ahead))
        self._offered: "set[int]" = set()  # window indexes already primed

    def on_window_start(self, index: int, done: Optional[set] = None) -> int:
        """Window ``index`` is about to execute: prime the headers of the
        next ``work_ahead`` windows that are neither done nor already
        primed. Returns the number of windows primed (observability and
        tests; 0 without a plane)."""
        if self._prime is None or self._work_ahead == 0:
            return 0
        primed = 0
        links: list = []
        for w in self._windows[index + 1 :]:
            if primed >= self._work_ahead:
                break
            if w.index in self._offered or (done and w.index in done):
                continue
            for pair in self._pairs[w.lo : w.hi]:
                links.extend(pair.parent.cids)
                links.extend(pair.child.cids)
            self._offered.add(w.index)
            primed += 1
        if links:
            self._prime(links)
        return primed
