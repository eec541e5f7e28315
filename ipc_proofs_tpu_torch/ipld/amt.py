"""Array Mapped Trie (AMT) over a blockstore — both on-disk versions.

Two wire versions exist on the Filecoin chain (reference
`src/proofs/events/utils.rs:76-90`, `events/generator.rs:196-259`):

- **v0** (`Amtv0`): root = ``[height, count, node]``, fixed bit width 3
  (branching 8). Used for message-CID lists and the receipts array.
- **v3** (`Amt`): root = ``[bit_width, height, count, node]``. Used for the
  per-receipt events array.

Node = ``[bmap(bytes), links([CID]), values([any])]`` where bit ``i`` of the
bitmap is ``bmap[i // 8] & (1 << (i % 8))`` (LSB-first within each byte).
Internal nodes carry ``links`` in set-bit order; leaves carry ``values``.
Slot addressing at height ``h``: ``(index >> (bit_width * h)) & (width - 1)``.

Blocks are DAG-CBOR / blake2b-256, like everything on the Filecoin chain.
"""

from __future__ import annotations

from typing import Any, Iterator, Optional

from ipc_proofs_tpu_torch.core.cid import CID
from ipc_proofs_tpu_torch.core.dagcbor import decode as cbor_decode
from ipc_proofs_tpu_torch.store.blockstore import Blockstore, put_cbor

__all__ = ["AMT", "amt_build", "amt_build_v0"]

_V0_BIT_WIDTH = 3
_MAX_HEIGHT = 64


def _width(bit_width: int) -> int:
    return 1 << bit_width


def _bmap_int(bmap: bytes) -> int:
    """Bitmap bytes → int with bit i == slot i (LSB-first byte layout)."""
    return int.from_bytes(bmap, "little")


def _bmap_make(bits: list[int], bit_width: int) -> bytes:
    out = bytearray((_width(bit_width) + 7) // 8)
    for i in bits:
        out[i // 8] |= 1 << (i % 8)
    return bytes(out)


def _offer_node_links(store, node: list) -> None:
    """Offer an AMT node's child links to ``store.offer_links``, where the
    store (or a wrapper's inner store) has one."""
    offer = getattr(store, "offer_links", None)
    if offer is not None and isinstance(node[1], list):
        links = [p for p in node[1] if isinstance(p, CID)]
        if links:
            offer(links)


class AMT:
    """Reader for an AMT rooted at a CID; version auto-detected from the root.

    ``get`` and ordered ``items`` mirror `fvm_ipld_amt`'s API surface the
    proof engines rely on. All node fetches go through the supplied
    blockstore, so wrapping it in a `RecordingBlockstore` records the touched
    path exactly like the reference's witness mechanism.
    """

    def __init__(
        self,
        store: Blockstore,
        root_cid: CID,
        bit_width: int,
        height: int,
        count: int,
        root_node: list,
        version: int,
    ):
        self._store = store
        self.root_cid = root_cid
        self.bit_width = bit_width
        self.height = height
        self.count = count
        self._root_node = root_node
        self.version = version

    @classmethod
    def load(
        cls, store: Blockstore, root_cid: CID, expected_version: Optional[int] = None
    ) -> "AMT":
        raw = store.get(root_cid)
        if raw is None:
            raise KeyError(f"missing AMT root {root_cid}")
        root = cbor_decode(raw)
        if not isinstance(root, list):
            raise ValueError("AMT root must be a CBOR array")
        if len(root) == 4:
            version = 3
            bit_width, height, count, node = root
        elif len(root) == 3:
            version = 0
            bit_width = _V0_BIT_WIDTH
            height, count, node = root
        else:
            raise ValueError(f"unrecognized AMT root arity {len(root)}")
        if expected_version is not None and version != expected_version:
            raise ValueError(f"expected AMT v{expected_version}, found v{version}")
        # u64-serde parity: the reference's root fields deserialize as
        # unsigned integers (fvm_ipld_amt), so a CBOR negint / bool / bytes
        # in any of them must fail the load
        for field_name, value in (
            ("bit width", bit_width), ("height", height), ("count", count)
        ):
            if not isinstance(value, int) or isinstance(value, bool):
                raise ValueError(f"AMT root {field_name} must be an unsigned int")
        if not 1 <= bit_width <= 8:
            raise ValueError(f"invalid AMT bit width {bit_width}")
        if not 0 <= height <= _MAX_HEIGHT:
            raise ValueError(f"invalid AMT height {height}")
        if not 0 <= count < 1 << 64:
            raise ValueError(f"invalid AMT count {count}")
        # the INLINE root node must pass the same shape check _load_node
        # applies to fetched nodes, or _node_parts leaks TypeError on a
        # non-list node — outside the (KeyError, ValueError) family the
        # verify paths map to verdicts
        if not (isinstance(node, list) and len(node) == 3):
            raise ValueError("malformed AMT node")
        # the root node is INLINE in the root block (it never passes
        # through _load_node): expose its links to the fetch plane here
        _offer_node_links(store, node)
        return cls(store, root_cid, bit_width, height, count, node, version)

    # -- node access --------------------------------------------------------

    def _load_node(self, cid: CID) -> list:
        raw = self._store.get(cid)
        if raw is None:
            raise KeyError(f"missing AMT node {cid}")
        node = cbor_decode(raw)
        if not (isinstance(node, list) and len(node) == 3):
            raise ValueError("malformed AMT node")
        # fetch plane: an interior node's child links become speculative
        # wants the moment it decodes (no-op without a plane below)
        _offer_node_links(self._store, node)
        return node

    def _node_parts(self, node: list) -> tuple[bytes, list, list]:
        bmap, links, values = node
        if not isinstance(bmap, bytes):
            raise ValueError("AMT node bitmap must be bytes")
        # malformed witness nodes must fail as ValueError, never leak
        # IndexError/TypeError from downstream indexing — the verify paths
        # map the (KeyError, ValueError) family to verdicts uniformly
        if not isinstance(links, list) or not isinstance(values, list):
            raise ValueError("AMT node links/values must be lists")
        # at least `width` bitmap bits: reading absent bytes as zero would
        # verify nodes the JAX package's native walker rejects
        if len(bmap) * 8 < _width(self.bit_width):
            raise ValueError("AMT bitmap too short")
        return bmap, links, values

    def get(self, index: int) -> Optional[Any]:
        """Value at ``index`` or None; walks exactly one root-to-leaf path."""
        if index < 0:
            raise ValueError("negative AMT index")
        width = _width(self.bit_width)
        if index >= width ** (self.height + 1):
            return None
        node = self._root_node
        for h in range(self.height, 0, -1):
            bmap, links, _ = self._node_parts(node)
            if len(links) > width:
                raise ValueError("too many AMT links")
            bits = _bmap_int(bmap)
            slot = (index >> (self.bit_width * h)) & (width - 1)
            if not (bits >> slot) & 1:
                return None
            link_pos = (bits & ((1 << slot) - 1)).bit_count()
            if link_pos >= len(links):
                raise ValueError("malformed AMT node: bitmap exceeds links")
            node = self._load_node(links[link_pos])
        bmap, _, values = self._node_parts(node)
        bits = _bmap_int(bmap)
        slot = index & (width - 1)
        # EXACT leaf count: a leaf padded with extra values is non-canonical
        # and the reference's serde rejects it. Masked to width bits: only
        # slots below width are read
        if (bits & ((1 << width) - 1)).bit_count() != len(values):
            raise ValueError("malformed AMT node: bitmap/values mismatch")
        if not (bits >> slot) & 1:
            return None
        return values[(bits & ((1 << slot) - 1)).bit_count()]

    def items(self) -> Iterator[tuple[int, Any]]:
        yield from self._walk(self._root_node, self.height, 0)

    def _walk(self, node: list, height: int, base: int) -> Iterator[tuple[int, Any]]:
        width = _width(self.bit_width)
        bmap, links, values = self._node_parts(node)
        if len(links) > width:
            raise ValueError("too many AMT links")
        bits = _bmap_int(bmap)
        # EXACT leaf count (see get())
        if height == 0 and (bits & ((1 << width) - 1)).bit_count() != len(values):
            raise ValueError("malformed AMT node: bitmap/values mismatch")
        pos = 0
        span = width**height
        for slot in range(width):
            if not (bits >> slot) & 1:
                continue
            if height == 0:
                yield base + slot, values[pos]
            else:
                if pos >= len(links):
                    raise ValueError("malformed AMT node: bitmap exceeds links")
                child = self._load_node(links[pos])
                yield from self._walk(child, height - 1, base + slot * span)
            pos += 1


def _build_node(
    store: Blockstore,
    entries: list[tuple[int, Any]],
    height: int,
    bit_width: int,
) -> list:
    """Recursively build one node covering ``entries`` (relative indices)."""
    width = _width(bit_width)
    bits: list[int] = []
    links: list[CID] = []
    values: list[Any] = []
    if height == 0:
        for index, value in sorted(entries):
            bits.append(index)
            values.append(value)
    else:
        span = width**height
        by_slot: dict[int, list[tuple[int, Any]]] = {}
        for index, value in entries:
            by_slot.setdefault(index // span, []).append((index % span, value))
        for slot in sorted(by_slot):
            child = _build_node(store, by_slot[slot], height - 1, bit_width)
            bits.append(slot)
            links.append(put_cbor(store, child))
    return [_bmap_make(bits, bit_width), links, values]


def amt_build(
    store: Blockstore,
    values: "dict[int, Any] | list[Any]",
    bit_width: int = 5,
    version: int = 3,
) -> CID:
    """Build an AMT over ``values`` and return its root CID.

    ``values`` may be a dense list (indices 0..n-1) or a sparse dict.
    ``version=0`` forces the legacy 3-tuple root with bit width 3.
    """
    if isinstance(values, list):
        entries = {i: v for i, v in enumerate(values)}
    else:
        entries = dict(values)
    if any(i < 0 for i in entries):
        raise ValueError("negative AMT index")
    if version == 0:
        bit_width = _V0_BIT_WIDTH
    elif version != 3:
        raise ValueError(f"unsupported AMT version {version}")

    width = _width(bit_width)
    max_index = max(entries) if entries else 0
    height = 0
    while max_index >= width ** (height + 1):
        height += 1

    node = _build_node(store, list(entries.items()), height, bit_width)
    count = len(entries)
    if version == 0:
        root = [height, count, node]
    else:
        root = [bit_width, height, count, node]
    return put_cbor(store, root)


def amt_build_v0(store: Blockstore, values: "dict[int, Any] | list[Any]") -> CID:
    """Legacy AMT (message-CID lists, receipts arrays)."""
    return amt_build(store, values, version=0)
