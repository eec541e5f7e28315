"""`TieredBlockstore`: tier-1 memory cache over tier-2 disk segments.

The counterpart of ``ipc_proofs_tpu.storex.tiered``.

Drop-in where `CachedBlockstore` sits today — same `Blockstore` protocol
and the same observability surface (`hits`/`misses` ints,
`cache_stats()`, `shared_cache()`), plus `disk_stats()` for the segment
tier. Read path::

    tier 1 (BlockCache / dict)  →  tier 2 (SegmentStore, verified)  →  inner

A disk hit promotes into tier 1; an inner-store hit populates BOTH tiers
so the next restart (fresh process, same ``--store-dir``) starts warm.
Disk reads are multihash-verified inside `SegmentStore.get2`, so a
corrupt frame reads as a miss and the refetched clean bytes re-spill. With
read-repair peers (`set_replicas`, a `storex.replica.ReplicaSet`) a corrupt
frame is first refetched from a replica, before the inner store is asked.

`put_local` / `get_local` / `has_local` touch the two local tiers only,
never the inner store: the fetch plane binds this store as its local tiers
(`FetchPlane.set_local`), so landed blocks spill to disk and warm wants
never reach the node.
"""

from __future__ import annotations

from typing import Optional

from ipc_proofs_tpu_torch.core.cid import CID
from ipc_proofs_tpu_torch.store.blockstore import BlockCache, Blockstore
from ipc_proofs_tpu_torch.storex.segments import SegmentStore
from ipc_proofs_tpu_torch.utils.lockdep import named_lock

__all__ = ["TieredBlockstore"]


class TieredBlockstore:
    """Two-tier memoizing wrapper: memory cache + disk segments + inner.

    ``cache`` may be a plain dict (short-lived runs) or a `BlockCache`
    (serving daemons: byte-capped + TTL, carries its own lock — the
    wrapper's dict lock is skipped for it, mirroring `CachedBlockstore`).
    """

    def __init__(
        self,
        inner: Blockstore,
        disk: SegmentStore,
        cache: "Optional[dict[CID, bytes] | BlockCache]" = None,
        metrics=None,
        replicas=None,
    ):
        self._inner = inner
        self._disk = disk
        # read-repair peers (storex.replica.ReplicaSet): consulted ONLY
        # when the disk tier reports a frame as corrupt — a plain miss
        # has no reason to exist on a peer, but a corrupt frame's bytes
        # almost certainly do, and repairing there keeps the upstream
        # (Lotus) out of the loop entirely
        self._replicas = replicas
        self._cache = cache if cache is not None else {}
        self._evicting = isinstance(self._cache, BlockCache)
        self._lock = named_lock("TieredBlockstore._lock")
        self._metrics = metrics
        self.hits = 0  # tier-1 hits, same meaning as CachedBlockstore.hits
        self.misses = 0

    def set_replicas(self, replicas) -> None:
        """Install/replace the read-repair `ReplicaSet` (peers are only
        known after the whole cluster is up, so this arrives late)."""
        self._replicas = replicas

    def _disk_get_repaired(self, cid: CID) -> Optional[bytes]:
        """Tier-2 read with read-repair: a corrupt frame (integrity
        eviction) refetches from a replica peer BEFORE the caller ever
        considers the inner store; repaired bytes re-spill to disk."""
        data, status = self._disk.get2(cid)
        if data is not None:
            return data
        if status == "corrupt" and self._replicas is not None and len(self._replicas):
            data = self._replicas.repair(cid)  # verified inside
            if data is not None:
                self._disk.put(cid, data)
        return data

    # -- tier-1 plumbing (CachedBlockstore-compatible) --------------------

    def shared_cache(self):
        return self._cache

    def _cache_get(self, cid: CID) -> Optional[bytes]:
        if self._evicting:
            return self._cache.get(cid)
        with self._lock:
            return self._cache.get(cid)

    def _cache_put(self, cid: CID, data: bytes) -> None:
        if self._evicting:
            self._cache.put(cid, data)
        else:
            with self._lock:
                self._cache[cid] = data

    def cache_stats(self) -> "tuple[int, int]":
        """(entries, total bytes) of tier 1 — `CachedBlockstore` parity."""
        if self._evicting:
            stats = self._cache.stats()
            return stats["entries"], stats["bytes"]
        with self._lock:
            return len(self._cache), sum(len(v) for v in self._cache.values())

    def disk_stats(self) -> dict:
        return self._disk.stats()

    # -- Blockstore protocol ----------------------------------------------

    def get(self, cid: CID) -> Optional[bytes]:
        cached = self._cache_get(cid)
        if cached is not None:
            self.hits += 1
            return cached
        self.misses += 1
        data = self._disk_get_repaired(cid)  # verified; corrupt frames try replicas
        if data is not None:
            self._cache_put(cid, data)
            return data
        data = self._inner.get(cid)
        if data is not None:
            self._cache_put(cid, data)
            self._disk.put(cid, data)
        return data

    def put_keyed(self, cid: CID, data: bytes) -> None:
        data = bytes(data)
        self._cache_put(cid, data)
        self._disk.put(cid, data)
        self._inner.put_keyed(cid, data)

    def put_local(self, cid: CID, data: bytes) -> None:
        """Populate tier 1 + tier 2 only — never the inner store: the fetch
        plane's landing path (the inner store is read-only over RPC)."""
        data = bytes(data)
        self._cache_put(cid, data)
        self._disk.put(cid, data)

    def get_local(self, cid: CID) -> Optional[bytes]:
        """Read from the LOCAL tiers only — never the inner store. The
        fetch plane's tier short-circuit: a want satisfiable here never
        enters the want-queue, so warm requests stay at zero RPC."""
        cached = self._cache_get(cid)
        if cached is not None:
            self.hits += 1
            return cached
        data = self._disk_get_repaired(cid)  # verified; corrupt frames try replicas
        if data is not None:
            self._cache_put(cid, data)
        return data

    def has_local(self, cid: CID) -> bool:
        """Membership in the LOCAL tiers only — no inner-store (RPC)
        traffic, so the fetch plane can skip links it already holds."""
        if self._evicting:
            if cid in self._cache:
                return True
        else:
            with self._lock:
                if cid in self._cache:
                    return True
        return self._disk.contains(cid)

    def read_frame_slice(self, cid: CID) -> "Optional[memoryview]":
        """Zero-copy disk-tier read for the streaming wire: a CRC-verified
        ``memoryview`` straight out of the segment frame, or None. Goes
        directly to tier 2, skipping the tier-1 promotion a `get` would
        do: promoting would materialize the copy this read avoids."""
        return self._disk.read_frame_slice(cid)

    def has(self, cid: CID) -> bool:
        return self.has_local(cid) or self._inner.has(cid)

    def offer_links(self, links) -> None:
        """Forward walker speculation to the fetch plane below, if any
        (the plane's own tier short-circuit consults `has_local`, so links
        already on disk never become wants)."""
        offer = getattr(self._inner, "offer_links", None)
        if offer is not None:
            offer(links)
