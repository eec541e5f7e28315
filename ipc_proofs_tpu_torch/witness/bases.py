"""Served-bundle base registry: digest → canonical CID set.

To cut a delta the server only needs to know WHICH CIDs the client's
base holds — never the bytes (the client has those). Every bundle the
serve plane ships registers here under its canonical digest; a later
request carrying ``If-Witness-Base: <digest>`` (or ``base_digest`` in
the body) resolves to that CID set, and a miss falls back to a full
bundle with ``witness.delta_fallbacks`` counted — delta serving degrades,
it never errors.

Bounded LRU: a base is a frozenset of ~36-byte keys, so even thousands
are cheap, but the registry is still capped (eviction = that base now
falls back to full, which is always sound).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional

from ipc_proofs_tpu_torch.utils.lockdep import named_lock

__all__ = ["FleetBaseCache", "WitnessBaseCache"]


class WitnessBaseCache:
    """Thread-safe bounded LRU of ``digest → frozenset(raw CID bytes)``."""

    def __init__(self, cap: int = 64):
        self.cap = max(1, int(cap))
        self._lock = named_lock("WitnessBaseCache._lock")
        self._bases: "OrderedDict[str, frozenset]" = OrderedDict()  # guarded-by: _lock

    def register(self, digest: str, cid_set: frozenset) -> None:
        with self._lock:
            self._bases[digest] = cid_set
            self._bases.move_to_end(digest)
            while len(self._bases) > self.cap:
                self._bases.popitem(last=False)

    def lookup(self, digest: str) -> Optional[frozenset]:
        """The base's CID set, refreshing its LRU position; None = unknown
        (the delta fallback path)."""
        with self._lock:
            cids = self._bases.get(digest)
            if cids is not None:
                self._bases.move_to_end(digest)
            return cids

    def __len__(self) -> int:
        with self._lock:
            return len(self._bases)


class FleetBaseCache:
    """`WitnessBaseCache` front-ended by the fleet-wide registry directory.

    Same interface as the local cache, so the whole serve plane inherits
    fleet behavior by swapping the ``witness_bases`` seat. ``lookup``
    tries the local LRU first (hot path unchanged); on a miss it asks
    the provenance registry's base directory — which sees every shard's
    serve records — and, on a hit, populates the local cache so the next
    request for the same base is local again. After a failover the new
    shard thus recovers bases it never served itself
    (``witness.fleet_base_hits`` vs ``witness.fleet_base_misses``);
    directory trouble is a plain miss (delta falls back to full, sound).

    Holds no lock of its own: the local cache and the registry each
    guard their state, and no call here nests one inside the other.
    """

    def __init__(self, local: WitnessBaseCache, directory, metrics=None):
        self._local = local
        self._directory = directory  # ProvenanceRegistry (lookup_base)
        self._metrics = metrics

    def register(self, digest: str, cid_set: frozenset) -> None:
        self._local.register(digest, cid_set)

    def lookup(self, digest: str) -> Optional[frozenset]:
        cids = self._local.lookup(digest)
        if cids is not None:
            return cids
        try:
            cids = self._directory.lookup_base(digest)
        except Exception:  # fail-soft: directory trouble degrades to a miss, never an error
            cids = None
        if self._metrics is not None:
            self._metrics.count(
                "witness.fleet_base_hits"
                if cids is not None
                else "witness.fleet_base_misses"
            )
        if cids is not None:
            self._local.register(digest, cids)
        return cids

    def __len__(self) -> int:
        return len(self._local)
