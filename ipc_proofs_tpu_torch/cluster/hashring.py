"""Deterministic consistent-hash ring for shard affinity.

The router hashes each request's key — for proof traffic, the tipset
pair identity ``(parent cids, child cids)``; the contract is fixed
per-deployment (one service serves one spec), so the pair IS the
``(tipset, contract)`` key — onto a ring of shard
names. Each shard owns ``vnodes`` points on the ring (classic virtual
nodes: removing one shard redistributes only its own arc, spread evenly
over the survivors, so every other shard's BlockCache stays hot for its
key range).

Determinism matters here the same way it does on the proof path: the
router and every test must agree on placement across processes and
Python invocations, so points come from sha256, never from Python's
salted ``hash()``. Affinity is a cache hint only — any shard can serve
any key — which is what makes work stealing and failover re-routing
safe (see ``cluster/router.py``).
"""

from __future__ import annotations

import bisect
import hashlib
from typing import Iterable, Sequence

__all__ = ["HashRing", "pair_ring_key"]


def _point(token: str) -> int:
    """64-bit ring position of one token (process-independent)."""
    return int.from_bytes(
        hashlib.sha256(token.encode("utf-8")).digest()[:8], "big"
    )


def pair_ring_key(pair) -> str:
    """The routing key of one tipset pair: its parent+child block CIDs.

    Pure function of the pair (duck-typed: anything with ``parent.cids``
    / ``child.cids``), so the router and an offline test partition a pair
    table identically.
    """
    parent = "|".join(str(c) for c in pair.parent.cids)
    child = "|".join(str(c) for c in pair.child.cids)
    return f"{parent}->{child}"


class HashRing:
    """Sorted-points consistent-hash ring over string node names.

    Not thread-safe on its own: the router serializes membership changes
    and lookups under its routing lock.
    """

    def __init__(self, nodes: Iterable[str] = (), vnodes: int = 64):
        if vnodes < 1:
            raise ValueError("vnodes must be >= 1")
        self._vnodes = int(vnodes)
        # parallel sorted arrays: point -> node; ties broken by node name
        # (the tuple sort) so ring order is total and deterministic
        self._points: "list[tuple[int, str]]" = []
        self._nodes: "set[str]" = set()
        for node in nodes:
            self.add(node)

    def add(self, node: str) -> None:
        if not node:
            raise ValueError("node name must be non-empty")
        if node in self._nodes:
            return
        self._nodes.add(node)
        for i in range(self._vnodes):
            entry = (_point(f"{node}#{i}"), node)
            bisect.insort(self._points, entry)

    def remove(self, node: str) -> None:
        if node not in self._nodes:
            return
        self._nodes.discard(node)
        self._points = [(p, n) for p, n in self._points if n != node]

    def node_for(self, key: str) -> str:
        """The node owning ``key``'s arc (clockwise successor point)."""
        if not self._points:
            raise ValueError("hash ring is empty (no shards)")
        point = _point(key)
        # "￿" sorts above any node name: land after every entry
        # sharing `point` exactly, then wrap to the successor
        idx = bisect.bisect_right(self._points, (point, "￿"))
        if idx == len(self._points):
            idx = 0  # wrap around the ring
        return self._points[idx][1]

    def nodes_for(self, key: str, n: int) -> "list[str]":
        """The first ``n`` DISTINCT nodes clockwise from ``key``'s point:
        ``[primary, replica 1, replica 2, ...]`` — the replica-placement
        walk (R-way replication puts a key's bytes on its arc owner plus
        the next ``n - 1`` distinct successors). Returns fewer than ``n``
        when the ring holds fewer nodes."""
        if not self._points:
            raise ValueError("hash ring is empty (no shards)")
        point = _point(key)
        idx = bisect.bisect_right(self._points, (point, "￿"))
        out: "list[str]" = []
        seen: "set[str]" = set()
        for step in range(len(self._points)):
            _, node = self._points[(idx + step) % len(self._points)]
            if node not in seen:
                seen.add(node)
                out.append(node)
                if len(out) >= n:
                    break
        return out

    def nodes(self) -> Sequence[str]:
        return sorted(self._nodes)

    def __len__(self) -> int:
        return len(self._nodes)

    def __contains__(self, node: str) -> bool:
        return node in self._nodes
