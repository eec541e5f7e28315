"""Blockstore protocol and the memory / recording / cached implementations.

The counterpart of ``ipc_proofs_tpu.store.blockstore`` without its native
scan-snapshot machinery and its size-capped serving cache:

- `MemoryBlockstore` — the isolated store for offline verification;
  ``put_keyed`` optionally recomputes the CID.
- `RecordingBlockstore` — the witness mechanism: records every CID fetched
  through it.
- `CachedBlockstore` — memoizing wrapper; lock-protected so it may be
  shared across threads.
"""

from __future__ import annotations

import threading
from typing import Iterable, Optional, Protocol, runtime_checkable

from ipc_proofs_tpu_torch.core.cid import CID
from ipc_proofs_tpu_torch.core.dagcbor import encode

__all__ = [
    "Blockstore",
    "MemoryBlockstore",
    "RecordingBlockstore",
    "CachedBlockstore",
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
        self._verify = verify_cids

    def get(self, cid: CID) -> Optional[bytes]:
        return self._blocks.get(cid)

    def put_keyed(self, cid: CID, data: bytes) -> None:
        if self._verify:
            recomputed = CID.hash_of(data, codec=cid.codec, mh_code=cid.mh_code)
            if recomputed != cid:
                raise ValueError(f"block bytes do not hash to claimed CID {cid}")
        self._blocks[cid] = bytes(data)

    def has(self, cid: CID) -> bool:
        return cid in self._blocks

    def __len__(self) -> int:
        return len(self._blocks)

    def items(self) -> Iterable[tuple[CID, bytes]]:
        return self._blocks.items()

    def put_many_trusted(self, blocks: "Iterable") -> None:
        """Bulk load of ``ProofBlock``-shaped items (``.cid``/``.data``)
        WITHOUT per-block CID verification — the witness loader's path when
        verification happens elsewhere (or is explicitly skipped)."""
        cid_map = self._blocks
        for block in blocks:
            data = block.data
            if isinstance(data, int):
                # bytes(int) would mean "n zero bytes" — a malformed block
                raise TypeError("block data must be bytes-like, not int")
            cid_map[block.cid] = bytes(data)


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

    def take_seen(self) -> set[CID]:
        """Drain and return the set of recorded CIDs."""
        with self._lock:
            seen, self._seen = self._seen, set()
        return seen


class CachedBlockstore:
    """Memoizing wrapper over any blockstore (one pipeline run's cache: it
    grows for the run and dies with it). Several wrappers may share one
    cache dict (`shared_cache` / `with_shared_cache`), as the unified
    generator's per-spec views do."""

    def __init__(self, inner: Blockstore, shared_cache: "Optional[dict[CID, bytes]]" = None):
        self._inner = inner
        self._cache: dict[CID, bytes] = (  # guarded-by: _lock
            shared_cache if shared_cache is not None else {}
        )
        self._lock = threading.Lock()

    @classmethod
    def with_shared_cache(cls, inner: Blockstore, cache: "dict[CID, bytes]") -> "CachedBlockstore":
        return cls(inner, shared_cache=cache)

    def shared_cache(self) -> "dict[CID, bytes]":
        return self._cache

    def get(self, cid: CID) -> Optional[bytes]:
        with self._lock:
            cached = self._cache.get(cid)
        if cached is not None:
            return cached
        data = self._inner.get(cid)
        if data is not None:
            with self._lock:
                self._cache[cid] = data
        return data

    def put_keyed(self, cid: CID, data: bytes) -> None:
        with self._lock:
            self._cache[cid] = bytes(data)
        self._inner.put_keyed(cid, data)

    def has(self, cid: CID) -> bool:
        with self._lock:
            if cid in self._cache:
                return True
        return self._inner.has(cid)
