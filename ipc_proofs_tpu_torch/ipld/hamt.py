"""Hash Array Mapped Trie (HAMT) over a blockstore, reader and writer.

Wire format:
- Node = ``[bitfield(bytes), [pointer, ...]]``
- ``bitfield``: big-endian minimal bytes of the 2^bit_width-bit occupancy map
  (zero encodes as the empty byte string).
- Pointer = a CID link (tag 42) to a child node, or an inline bucket
  ``[[key_bytes, value], ...]`` of at most ``MAX_BUCKET`` (3) KV pairs,
  sorted by key bytes.
- Key hash: sha256(key), bits consumed MSB-first, ``bit_width`` at a time.

The counterpart of ``ipc_proofs_tpu.ipld.hamt``: the scalar reader
(`HAMT`), the writer (`hamt_build`) and the batched C walkers
`hamt_get_batch` / `hamt_get_batch_touched`. The reader offers each
decoded node's child links to ``store.offer_links`` (the fetch plane's
speculation hook), a no-op against stores without a plane below.
"""

from __future__ import annotations

import hashlib
from typing import Any, Callable, Iterator, Optional

from ipc_proofs_tpu_torch.core.cid import CID
from ipc_proofs_tpu_torch.core.dagcbor import decode as cbor_decode
from ipc_proofs_tpu_torch.store.blockstore import Blockstore, put_cbor

__all__ = [
    "HAMT",
    "hamt_build",
    "hamt_get_batch",
    "hamt_get_batch_touched",
    "HAMT_BIT_WIDTH",
    "MAX_BUCKET",
]

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


def hamt_get_batch(
    store: Blockstore,
    roots: "list[CID]",
    owners: "list[int]",
    keys: "list[bytes]",
    bit_width: int = HAMT_BIT_WIDTH,
    skip_missing: bool = False,
    validate_blocks: bool = False,
) -> "Optional[list[Optional[Any]]]":
    """Batched ``HAMT.get``: ONE C call walks a root→bucket path per
    (owner root, key) — the storage-side analog of the native receipts
    scanner, sized for BASELINE config 3 (65k slots × 256 contract roots)
    and the range driver's storage legs. ``owners[i]`` selects the root for
    ``keys[i]``. Returns decoded values (None for absent keys), or None
    overall in the pure-Python universe (callers loop scalar).
    Missing node blocks raise KeyError, malformed nodes ValueError — the
    scalar reader's behavior; ``skip_missing=True`` instead treats a
    missing node as an absent key (the batch verifiers' tolerant mode,
    mirroring the scalar caller's caught-KeyError → unverified). Value
    decoding is the shared DAG-CBOR path. ``validate_blocks`` full-validates
    every fetched node block (verify-side callers — adversarial witness
    bytes in positions the targeted walk skips must fail like the scalar
    reader's full decode)."""
    from ipc_proofs_tpu_torch.backend.native import load_scan_ext
    from ipc_proofs_tpu_torch.proofs.scan_native import (
        _raw_view,
        _snap_kw,
        split_pooled,
    )

    ext = load_scan_ext()
    if ext is None:
        return None
    raw, fallback = _raw_view(store)
    out = ext.hamt_lookup_batch(
        raw,
        [c.to_bytes() for c in roots],
        owners,
        keys,
        bit_width=bit_width,
        fallback=fallback,
        skip_missing=skip_missing,
        validate_blocks=validate_blocks,
        **_snap_kw(store, raw, len(keys)),
    )
    found = out["found"]
    spans = split_pooled(out["val_pool"], out["val_off"], out["val_len"])
    return [
        cbor_decode(spans[i]) if found[i] else None for i in range(len(keys))
    ]


def hamt_get_batch_touched(
    store: Blockstore,
    roots: "list[CID]",
    owners: "list[int]",
    keys: "list[bytes]",
    bit_width: int = HAMT_BIT_WIDTH,
) -> "Optional[tuple[list[Optional[Any]], list[list[bytes]]]]":
    """:func:`hamt_get_batch` with per-item witness recording: also returns,
    per (root, key), the raw CID bytes of every node the walk fetched —
    the generation-side analog of walking under a RecordingBlockstore.
    Returns None in the pure-Python universe."""
    import numpy as np

    from ipc_proofs_tpu_torch.backend.native import load_scan_ext
    from ipc_proofs_tpu_torch.proofs.scan_native import (
        _raw_view,
        _snap_kw,
        split_pooled,
    )

    ext = load_scan_ext()
    if ext is None:
        return None
    raw, fallback = _raw_view(store)
    out = ext.hamt_lookup_batch(
        raw,
        [c.to_bytes() for c in roots],
        owners,
        keys,
        bit_width=bit_width,
        fallback=fallback,
        want_touched=True,
        **_snap_kw(store, raw, len(keys)),
    )
    found = out["found"]
    spans = split_pooled(out["val_pool"], out["val_off"], out["val_len"])
    values = [cbor_decode(spans[i]) if found[i] else None for i in range(len(keys))]
    titems = split_pooled(out["touch_pool"], out["touch_off"], out["touch_len"])
    goff = np.frombuffer(out["touch_goff"], "<i4")
    touched = [titems[goff[i] : goff[i + 1]] for i in range(len(keys))]
    return values, touched


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
        # fetch plane: the moment an interior node decodes, its child links
        # become speculative wants
        offer = getattr(self._store, "offer_links", None)
        if offer is not None:
            links = [p for p in node[1] if isinstance(p, CID)]
            if links:
                offer(links)
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
