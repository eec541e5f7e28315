"""Hash Array Mapped Trie (HAMT) over a blockstore, reader and writer.

Wire format:
- Node = ``[bitfield(bytes), [pointer, ...]]``
- ``bitfield``: big-endian minimal bytes of the 2^bit_width-bit occupancy map
  (zero encodes as the empty byte string).
- Pointer = a CID link (tag 42) to a child node, or an inline bucket
  ``[[key_bytes, value], ...]`` of at most ``MAX_BUCKET`` (3) KV pairs,
  sorted by key bytes.
- Key hash: sha256(key), bits consumed MSB-first, ``bit_width`` at a time.

The counterpart of ``ipc_proofs_tpu.ipld.hamt``'s scalar reader (`HAMT`)
and writer (`hamt_build`). Left out: the reader's ``offer_links`` prefetch
hook (a no-op against these stores) and the native batched walkers
``hamt_get_batch`` / ``hamt_get_batch_touched``.
"""

from __future__ import annotations

import hashlib
from typing import Any, Callable, Iterator, Optional

from ipc_proofs_tpu_torch.core.cid import CID
from ipc_proofs_tpu_torch.core.dagcbor import decode as cbor_decode
from ipc_proofs_tpu_torch.store.blockstore import Blockstore, put_cbor

__all__ = ["HAMT", "hamt_build", "HAMT_BIT_WIDTH", "MAX_BUCKET"]

HAMT_BIT_WIDTH = 5  # fvm_shared::HAMT_BIT_WIDTH
MAX_BUCKET = 3  # fvm_ipld_hamt MAX_ARRAY_WIDTH


def _hash_bits(key: bytes, depth: int, bit_width: int) -> int:
    """The ``depth``-th group of ``bit_width`` bits of sha256(key), MSB-first."""
    shift = 256 - bit_width * (depth + 1)
    if shift < 0:
        raise ValueError("HAMT max depth exceeded (hash bits exhausted)")
    digest = int.from_bytes(hashlib.sha256(key).digest(), "big")
    return (digest >> shift) & ((1 << bit_width) - 1)


def _bitfield_decode(data: bytes) -> int:
    return int.from_bytes(data, "big")


def _bitfield_encode(bits: int) -> bytes:
    if bits == 0:
        return b""
    return bits.to_bytes((bits.bit_length() + 7) // 8, "big")


class HAMT:
    """Reader for a HAMT rooted at a CID.

    A missing node raises KeyError; a malformed node, a bitmap that claims
    more entries than the pointer list holds, or a bad bucket raises
    ValueError — the two families every verify caller maps to a verdict."""

    def __init__(self, store: Blockstore, root_cid: CID, bit_width: int = HAMT_BIT_WIDTH):
        self._store = store
        self.root_cid = root_cid
        self.bit_width = bit_width
        self._root = self._load_node(root_cid)

    @classmethod
    def load(
        cls, store: Blockstore, root_cid: CID, bit_width: int = HAMT_BIT_WIDTH
    ) -> "HAMT":
        return cls(store, root_cid, bit_width)

    def _load_node(self, cid: CID) -> list:
        raw = self._store.get(cid)
        if raw is None:
            raise KeyError(f"missing HAMT node {cid}")
        node = cbor_decode(raw)
        if not (
            isinstance(node, list)
            and len(node) == 2
            and isinstance(node[0], bytes)
            and isinstance(node[1], list)
        ):
            raise ValueError("malformed HAMT node")
        return node

    def get(self, key: bytes) -> Optional[Any]:
        """Value for ``key`` or None; walks one root-to-bucket path."""
        node = self._root
        depth = 0
        while True:
            bitfield = _bitfield_decode(node[0])
            pointers = node[1]
            idx = _hash_bits(key, depth, self.bit_width)
            if not (bitfield >> idx) & 1:
                return None
            pos = (bitfield & ((1 << idx) - 1)).bit_count()
            if pos >= len(pointers):
                raise ValueError("malformed HAMT node: bitmap exceeds pointers")
            ptr = pointers[pos]
            if isinstance(ptr, CID):
                node = self._load_node(ptr)
                depth += 1
                continue
            if isinstance(ptr, list):
                for kv in ptr:
                    if not (isinstance(kv, list) and len(kv) == 2):
                        raise ValueError("malformed HAMT bucket entry")
                    if kv[0] == key:
                        return kv[1]
                return None
            raise ValueError(f"malformed HAMT pointer {type(ptr)}")

    def for_each(self, fn: Callable[[bytes, Any], None]) -> None:
        for key, value in self.items():
            fn(key, value)

    def items(self) -> Iterator[tuple[bytes, Any]]:
        yield from self._walk(self._root)

    def _walk(self, node: list) -> Iterator[tuple[bytes, Any]]:
        for ptr in node[1]:
            if isinstance(ptr, CID):
                yield from self._walk(self._load_node(ptr))
            elif isinstance(ptr, list):
                for kv in ptr:
                    if not (isinstance(kv, list) and len(kv) == 2):
                        raise ValueError("malformed HAMT bucket entry")
                    yield kv[0], kv[1]
            else:
                raise ValueError(f"malformed HAMT pointer {type(ptr)}")


def _build_node(
    store: Blockstore,
    entries: list[tuple[bytes, Any]],
    depth: int,
    bit_width: int,
) -> list:
    """Build one HAMT node from ``entries`` (all distinct keys)."""
    by_idx: dict[int, list[tuple[bytes, Any]]] = {}
    for key, value in entries:
        by_idx.setdefault(_hash_bits(key, depth, bit_width), []).append((key, value))

    bitfield = 0
    pointers: list[Any] = []
    for idx in sorted(by_idx):
        group = by_idx[idx]
        bitfield |= 1 << idx
        if len(group) <= MAX_BUCKET:
            bucket = [[k, v] for k, v in sorted(group, key=lambda kv: kv[0])]
            pointers.append(bucket)
        else:
            child = _build_node(store, group, depth + 1, bit_width)
            pointers.append(put_cbor(store, child))
    return [_bitfield_encode(bitfield), pointers]


def hamt_build(
    store: Blockstore,
    entries: dict[bytes, Any],
    bit_width: int = HAMT_BIT_WIDTH,
) -> CID:
    """Build a HAMT over ``entries`` and return its root CID.

    Deterministic for a given key set: buckets split exactly when more than
    ``MAX_BUCKET`` keys share a slot, matching incremental-insert semantics.
    """
    node = _build_node(store, list(entries.items()), 0, bit_width)
    return put_cbor(store, node)
