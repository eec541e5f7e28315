"""Blockstore protocol and the memory / recording / cached implementations.

The counterpart of ``ipc_proofs_tpu.store.blockstore``:

- `MemoryBlockstore` — the isolated store for offline verification;
  ``put_keyed`` optionally recomputes the CID. It also keeps a map keyed by
  raw CID bytes, which the native walkers probe from C, and a mutation
  counter that invalidates their cached probe table (`proofs.scan_native`).
- `RecordingBlockstore` — the witness mechanism: records every CID fetched
  through it.
- `CachedBlockstore` — memoizing wrapper; lock-protected so it may be
  shared across threads, over a dict or a `BlockCache`, with the local-tier
  surface (`get_local` / `has_local` / `put_local`) of the fetch plane.
- `BlockCache` — size-capped, TTL-evicting LRU block cache, the memory
  tier of `storex.TieredBlockstore` and a local tier of the fetch plane.

The recording and cached wrappers forward ``offer_links`` (the walkers'
speculation hook) to the store below, so a fetch plane underneath sees
the links however many wrappers sit between it and the walker.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Iterable, Optional, Protocol, runtime_checkable

from ipc_proofs_tpu_torch.core.cid import CID
from ipc_proofs_tpu_torch.core.dagcbor import encode
from ipc_proofs_tpu_torch.utils.lockdep import named_lock

__all__ = [
    "Blockstore",
    "MemoryBlockstore",
    "RecordingBlockstore",
    "CachedBlockstore",
    "BlockCache",
    "put_cbor",
]


@runtime_checkable
class Blockstore(Protocol):
    """The plugin boundary: content-addressed block storage."""

    def get(self, cid: CID) -> Optional[bytes]:
        """Return the raw block bytes for ``cid``, or None if absent."""
        ...

    def put_keyed(self, cid: CID, data: bytes) -> None:
        """Store ``data`` under an externally supplied ``cid``."""
        ...

    def has(self, cid: CID) -> bool:
        return self.get(cid) is not None


def put_cbor(store: Blockstore, obj, codec: int = 0x71, mh_code: int = 0xB220) -> CID:
    """Encode ``obj`` as DAG-CBOR, store it, and return its CID."""
    data = encode(obj)
    cid = CID.hash_of(data, codec=codec, mh_code=mh_code)
    store.put_keyed(cid, data)
    return cid


class MemoryBlockstore:
    """In-memory blockstore; the isolated store for offline verification."""

    def __init__(self, verify_cids: bool = False):
        self._blocks: dict[CID, bytes] = {}
        self._raw: dict[bytes, bytes] = {}  # cid.to_bytes() -> data
        self._verify = verify_cids
        # bumped on EVERY write (same-CID overwrites included, which leave
        # len() unchanged): the native scan snapshot invalidates on it, so an
        # overwrite with other bytes is never served stale from a probe table
        self._mutations = 0
        # serializes THIS store's snapshot builds (independent stores never
        # wait on each other's O(|store|) build)
        self._snapshot_lock = threading.Lock()

    def get(self, cid: CID) -> Optional[bytes]:
        return self._blocks.get(cid)

    def put_keyed(self, cid: CID, data: bytes) -> None:
        if self._verify:
            recomputed = CID.hash_of(data, codec=cid.codec, mh_code=cid.mh_code)
            if recomputed != cid:
                raise ValueError(f"block bytes do not hash to claimed CID {cid}")
        data = bytes(data)
        self._blocks[cid] = data
        self._raw[cid.to_bytes()] = data
        self._mutations += 1

    def has(self, cid: CID) -> bool:
        return cid in self._blocks

    def __len__(self) -> int:
        return len(self._blocks)

    def items(self) -> Iterable[tuple[CID, bytes]]:
        return self._blocks.items()

    def put_many_trusted(self, blocks: "Iterable") -> None:
        """Bulk load of ``ProofBlock``-shaped items (``.cid``/``.data``)
        WITHOUT per-block CID verification — the witness loader's path when
        verification happens elsewhere (or is explicitly skipped). One C
        pass (``bulk_load_blocks``) fills both maps; the pure-Python
        universe loops."""
        from ipc_proofs_tpu_torch.backend.native import load_scan_ext

        # bump AFTER the inserts (finally: even a partial load invalidates):
        # a pre-bump would let a concurrently built snapshot cache the new
        # version over the pre-insert map
        try:
            ext = load_scan_ext()
            if ext is not None:
                ext.bulk_load_blocks(blocks, self._blocks, self._raw)
                return
            cid_map, raw_map = self._blocks, self._raw
            for block in blocks:
                data = block.data
                if isinstance(data, int):
                    # bytes(int) would mean "n zero bytes" — a malformed
                    # block, which the C path's PyBytes_FromObject rejects
                    raise TypeError("block data must be bytes-like, not int")
                data = bytes(data)
                cid_map[block.cid] = data
                raw_map[block.cid.to_bytes()] = data
        finally:
            self._mutations += 1

    def raw_map(self) -> "dict[bytes, bytes]":
        """Live view keyed by raw CID bytes. Counts as a WRITE for snapshot
        purposes: a caller may mutate the returned dict (tests model
        corruption that way), which the mutation counter cannot see.
        Internal readers use `_raw_readonly()`."""
        self._mutations += 1
        return self._raw

    def _raw_readonly(self) -> "dict[bytes, bytes]":
        """`raw_map()` for readers that promise not to mutate it; does not
        invalidate the cached scan snapshot."""
        return self._raw


class RecordingBlockstore:
    """Wraps any blockstore and records every CID fetched through it; the
    recorded set becomes the proof's witness after materialization."""

    def __init__(self, inner: Blockstore):
        self._inner = inner
        self._seen: set[CID] = set()  # guarded-by: _lock
        self._lock = threading.Lock()

    def get(self, cid: CID) -> Optional[bytes]:
        with self._lock:
            self._seen.add(cid)
        return self._inner.get(cid)

    def put_keyed(self, cid: CID, data: bytes) -> None:
        self._inner.put_keyed(cid, data)

    def has(self, cid: CID) -> bool:
        return self._inner.has(cid)

    def offer_links(self, links) -> None:
        """Forward walker speculation to the fetch plane below, if any.
        Not recorded: offered links are hints, only blocks a walk actually
        `get`s belong in a witness."""
        offer = getattr(self._inner, "offer_links", None)
        if offer is not None:
            offer(links)

    def take_seen(self) -> set[CID]:
        """Drain and return the set of recorded CIDs."""
        with self._lock:
            seen, self._seen = self._seen, set()
        return seen

    def peek_seen(self) -> frozenset[CID]:
        """The recorded CIDs so far, without draining them."""
        with self._lock:
            return frozenset(self._seen)


class CachedBlockstore:
    """Memoizing wrapper over any blockstore. Several wrappers may share one
    cache (`shared_cache` / `with_shared_cache`), as the unified generator's
    per-spec views do.

    ``shared_cache`` may be a plain dict (one pipeline run's cache: it grows
    for the run and dies with it) or a `BlockCache` (the serve plane's:
    size-capped + TTL). A `BlockCache` carries its own lock, so the wrapper
    skips its dict lock for it. ``hits`` / ``misses`` count cache lookups
    (unlocked increments: observability, not accounting)."""

    def __init__(
        self,
        inner: Blockstore,
        shared_cache: "Optional[dict[CID, bytes] | BlockCache]" = None,
    ):
        self._inner = inner
        self._cache = shared_cache if shared_cache is not None else {}  # guarded-by: _lock
        self._evicting = isinstance(self._cache, BlockCache)
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    @classmethod
    def with_shared_cache(cls, inner: Blockstore, cache: "dict[CID, bytes]") -> "CachedBlockstore":
        return cls(inner, shared_cache=cache)

    def shared_cache(self) -> "dict[CID, bytes] | BlockCache":
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

    def get(self, cid: CID) -> Optional[bytes]:
        cached = self._cache_get(cid)
        if cached is not None:
            self.hits += 1
            return cached
        self.misses += 1
        data = self._inner.get(cid)
        if data is not None:
            self._cache_put(cid, data)
        return data

    def put_keyed(self, cid: CID, data: bytes) -> None:
        self._cache_put(cid, bytes(data))
        self._inner.put_keyed(cid, data)

    def has(self, cid: CID) -> bool:
        return self.has_local(cid) or self._inner.has(cid)

    def offer_links(self, links) -> None:
        """Forward walker speculation to the fetch plane below, if any."""
        offer = getattr(self._inner, "offer_links", None)
        if offer is not None:
            offer(links)

    # -- local-tier surface (`storex.TieredBlockstore` parity) ------------
    # The fetch plane's short-circuit binds the store above it as its local
    # tiers; these read and populate the memory cache only and never touch
    # the inner store, which may itself sit over the plane.

    def get_local(self, cid: CID) -> Optional[bytes]:
        cached = self._cache_get(cid)
        if cached is not None:
            self.hits += 1
        return cached

    def has_local(self, cid: CID) -> bool:
        if self._evicting:
            return cid in self._cache
        with self._lock:
            return cid in self._cache

    def put_local(self, cid: CID, data: bytes) -> None:
        self._cache_put(cid, bytes(data))

    def cache_stats(self) -> "tuple[int, int]":
        """(entries, total bytes)."""
        if self._evicting:
            stats = self._cache.stats()
            return stats["entries"], stats["bytes"]
        with self._lock:
            return len(self._cache), sum(len(v) for v in self._cache.values())


class BlockCache:
    """Size-capped, TTL-evicting LRU block cache for long-lived processes.

    - ``max_bytes``: total cached block bytes; least-recently-used entries
      evict first (content-addressed data never goes stale, so eviction is
      a memory policy, never a correctness one);
    - ``ttl_s``: optional per-entry time-to-live; older entries read as
      misses and are dropped.

    Thread-safe; duck-compatible with the dict operations the tiers perform
    (get/put/contains/len).
    """

    def __init__(
        self,
        max_bytes: int = 256 * 1024 * 1024,
        ttl_s: Optional[float] = None,
        clock=time.monotonic,
    ):
        if max_bytes <= 0:
            raise ValueError("max_bytes must be positive")
        self._lock = named_lock("BlockCache._lock")
        self._entries: "OrderedDict[CID, tuple[bytes, float]]" = OrderedDict()  # guarded-by: _lock
        self._max_bytes = max_bytes
        self._ttl_s = ttl_s
        self._clock = clock
        self._bytes = 0  # guarded-by: _lock
        self.evictions = 0  # guarded-by: _lock
        self.expirations = 0  # guarded-by: _lock

    def get(self, cid: CID) -> Optional[bytes]:
        now = self._clock()
        with self._lock:
            entry = self._entries.get(cid)
            if entry is None:
                return None
            data, stored_at = entry
            if self._ttl_s is not None and now - stored_at > self._ttl_s:
                del self._entries[cid]
                self._bytes -= len(data)
                self.expirations += 1
                return None
            self._entries.move_to_end(cid)
            return data

    def put(self, cid: CID, data: bytes) -> None:
        data = bytes(data)
        if len(data) > self._max_bytes:
            return  # a block larger than the whole budget is never cached
        with self._lock:
            old = self._entries.pop(cid, None)
            if old is not None:
                self._bytes -= len(old[0])
            self._entries[cid] = (data, self._clock())
            self._bytes += len(data)
            while self._bytes > self._max_bytes:
                _, (evicted, _) = self._entries.popitem(last=False)
                self._bytes -= len(evicted)
                self.evictions += 1

    def __contains__(self, cid: CID) -> bool:
        return self.get(cid) is not None  # TTL-respecting membership

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._entries),
                "bytes": self._bytes,
                "max_bytes": self._max_bytes,
                "ttl_s": self._ttl_s,
                "evictions": self.evictions,
                "expirations": self.expirations,
            }
