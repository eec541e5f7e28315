"""Plain AMT and HAMT: the chain's writers, and readers over a block map.

Writers put each node through a `BlockSink` (DAG-CBOR bytes, blake2b-256
CID) and return the root's CID. Readers take a `BlockView`: a mapping from
binary CID to bytes with a cache of decoded nodes, which the reference
verifier builds over a bundle's witness alone.

AMT v0 roots are ``[height, count, node]`` with bit width 3; v3 roots are
``[bit_width, height, count, node]``. A node is ``[bitmap, links,
values]``, bit ``i`` of the bitmap at ``bmap[i // 8] & (1 << (i % 8))``.
A HAMT node is ``[bitfield, pointers]``: the bitfield big-endian and
minimal, a pointer a link or a bucket of at most three ``[key, value]``
pairs sorted by key; the key's sha256 is read ``bit_width`` bits at a time
from the top.
"""

from __future__ import annotations

import hashlib

from portbench.reference.cbor import Link, decode, encode
from portbench.reference.hashes import DAG_CBOR, cid_of

__all__ = ["BlockSink", "BlockView", "amt_build", "amt_get", "amt_items", "hamt_build", "hamt_get"]

HAMT_MAX_BUCKET = 3


class BlockSink:
    """Collects written blocks: binary CID → bytes."""

    def __init__(self):
        self.blocks: "dict[bytes, bytes]" = {}

    def put(self, obj) -> Link:
        data = encode(obj)
        cid = cid_of(data, DAG_CBOR)
        self.blocks[cid] = data
        return Link(cid)


class BlockView:
    """Decoded blocks of a map, decoded once each; a missing block raises
    KeyError."""

    def __init__(self, blocks: "dict[bytes, bytes]"):
        self.blocks = blocks
        self._decoded: dict = {}

    def get(self, cid: bytes):
        cid = bytes(cid)
        out = self._decoded.get(cid)
        if out is None:
            out = decode(self.blocks[cid])
            self._decoded[cid] = out
        return out


# --- AMT --------------------------------------------------------------------


def _amt_node(sink: BlockSink, entries: list, height: int, bit_width: int) -> list:
    width = 1 << bit_width
    bits, links, values = [], [], []
    if height == 0:
        for index, value in sorted(entries, key=lambda kv: kv[0]):
            bits.append(index)
            values.append(value)
    else:
        span = width**height
        by_slot: dict = {}
        for index, value in entries:
            by_slot.setdefault(index // span, []).append((index % span, value))
        for slot in sorted(by_slot):
            bits.append(slot)
            links.append(sink.put(_amt_node(sink, by_slot[slot], height - 1, bit_width)))
    bmap = bytearray((width + 7) // 8)
    for i in bits:
        bmap[i // 8] |= 1 << (i % 8)
    return [bytes(bmap), links, values]


def amt_build(sink: BlockSink, values, version: int = 3, bit_width: int = 5) -> Link:
    """An AMT over a list (dense) or a dict (sparse); version 0 has bit
    width 3."""
    entries = dict(enumerate(values)) if isinstance(values, list) else dict(values)
    if version == 0:
        bit_width = 3
    width = 1 << bit_width
    top = max(entries) if entries else 0
    height = 0
    while top >= width ** (height + 1):
        height += 1
    node = _amt_node(sink, list(entries.items()), height, bit_width)
    root = [height, len(entries), node] if version == 0 else [bit_width, height, len(entries), node]
    return sink.put(root)


def _amt_root(view: BlockView, root: bytes, version: int):
    fields = view.get(root)
    if version == 0 and len(fields) == 3:
        return 3, fields[0], fields[2]
    if version == 3 and len(fields) == 4:
        return fields[0], fields[1], fields[3]
    raise ValueError(f"not an AMT v{version} root")


def amt_get(view: BlockView, root: bytes, index: int, version: int):
    """The value at ``index``, or None."""
    bit_width, height, node = _amt_root(view, root, version)
    width = 1 << bit_width
    if index >= width ** (height + 1):
        return None
    for h in range(height, 0, -1):
        bits = int.from_bytes(node[0], "little")
        slot = (index >> (bit_width * h)) & (width - 1)
        if not (bits >> slot) & 1:
            return None
        node = view.get(node[1][(bits & ((1 << slot) - 1)).bit_count()])
    bits = int.from_bytes(node[0], "little")
    slot = index & (width - 1)
    if not (bits >> slot) & 1:
        return None
    return node[2][(bits & ((1 << slot) - 1)).bit_count()]


def amt_items(view: BlockView, root: bytes, version: int) -> list:
    """Every ``(index, value)`` in index order."""
    bit_width, height, node = _amt_root(view, root, version)
    width = 1 << bit_width
    out: list = []

    def walk(node, h, base):
        bits = int.from_bytes(node[0], "little")
        pos = 0
        for slot in range(width):
            if (bits >> slot) & 1:
                if h == 0:
                    out.append((base + slot, node[2][pos]))
                else:
                    walk(view.get(node[1][pos]), h - 1, base + slot * width**h)
                pos += 1

    walk(node, height, 0)
    return out


# --- HAMT -------------------------------------------------------------------


def _hash_index(digest: int, depth: int, bit_width: int) -> int:
    return (digest >> (256 - bit_width * (depth + 1))) & ((1 << bit_width) - 1)


def _hamt_node(sink: BlockSink, entries: list, depth: int, bit_width: int) -> list:
    by_idx: dict = {}
    for key, value, digest in entries:
        by_idx.setdefault(_hash_index(digest, depth, bit_width), []).append((key, value, digest))
    bitfield, pointers = 0, []
    for idx in sorted(by_idx):
        group = by_idx[idx]
        bitfield |= 1 << idx
        if len(group) <= HAMT_MAX_BUCKET:
            pointers.append([[k, v] for k, v, _ in sorted(group, key=lambda e: e[0])])
        else:
            pointers.append(sink.put(_hamt_node(sink, group, depth + 1, bit_width)))
    field = bitfield.to_bytes((bitfield.bit_length() + 7) // 8, "big") if bitfield else b""
    return [field, pointers]


def hamt_build(sink: BlockSink, entries: dict, bit_width: int = 5) -> Link:
    keyed = [(k, v, int.from_bytes(hashlib.sha256(k).digest(), "big")) for k, v in entries.items()]
    return sink.put(_hamt_node(sink, keyed, 0, bit_width))


def hamt_get(view: BlockView, root: bytes, key: bytes, bit_width: int = 5):
    """The value under ``key``, or None."""
    digest = int.from_bytes(hashlib.sha256(key).digest(), "big")
    node = view.get(root)
    depth = 0
    while True:
        bits = int.from_bytes(node[0], "big")
        idx = _hash_index(digest, depth, bit_width)
        if not (bits >> idx) & 1:
            return None
        ptr = node[1][(bits & ((1 << idx) - 1)).bit_count()]
        if isinstance(ptr, Link):
            node = view.get(ptr)
            depth += 1
            continue
        for k, v in ptr:
            if k == key:
                return v
        return None
