"""FEVM contract storage: slot math and the five on-disk slot encodings.

`read_storage_slot` tries, in order:

- A1 inline ``[params, [SmallMap]]``
- A2 inline ``[params, SmallMap]``
- A3 bare ``SmallMap`` (= ``{"v": [[k, v], ...]}``)
- B1 wrapper ``[root_cid, bitwidth]`` → HAMT
- B2 wrapper ``{"root": cid, "bitwidth": n}`` → HAMT
- C  direct HAMT at the root CID, protocol bit width 5

and `compute_mapping_slot` implements Solidity mapping slot addressing
``keccak(key32 ++ be_pad32(slot_index))``. The counterpart of
``ipc_proofs_tpu.state.storage``; batch drivers hash slots on the card
(`proofs.storage_batch.hash_slot_specs`), the scalar `compute_mapping_slot`
on the host.
"""

from __future__ import annotations

from typing import Optional

from ipc_proofs_tpu_torch.core.cid import CID
from ipc_proofs_tpu_torch.core.dagcbor import decode as cbor_decode
from ipc_proofs_tpu_torch.core.hashes import keccak256
from ipc_proofs_tpu_torch.ipld.hamt import HAMT, HAMT_BIT_WIDTH
from ipc_proofs_tpu_torch.state.events import ascii_to_bytes32
from ipc_proofs_tpu_torch.store.blockstore import Blockstore

__all__ = [
    "read_storage_slot",
    "classify_storage_root",
    "slot_read_route",
    "compute_mapping_slot",
    "calculate_storage_slot",
]


def _small_map_lookup(obj, slot_key: bytes) -> "tuple[bool, Optional[bytes]]":
    """Try to interpret ``obj`` as SmallMap ``{"v": [[k, v], ...]}``.

    Returns (matched_shape, value_or_None).
    """
    if not _small_map_shape(obj):
        return False, None
    for key, value in obj["v"]:
        if key == slot_key:
            return True, value
    return True, None


def read_storage_slot(
    store: Blockstore, contract_state_root: CID, slot_key: bytes
) -> Optional[bytes]:
    """Read a 32-byte FEVM storage slot; ``slot_key`` is the 32-byte preimage
    digest (already keccak'd for mappings). Missing key → None (= zero)."""
    if len(slot_key) != 32:
        raise ValueError("slot key must be 32 bytes")
    raw = store.get(contract_state_root)
    if raw is None:
        raise KeyError(f"missing contract_state root {contract_state_root}")
    obj = cbor_decode(raw)

    # A1) [params, [SmallMap]]
    if (
        isinstance(obj, list)
        and len(obj) == 2
        and isinstance(obj[0], bytes)
        and isinstance(obj[1], list)
        and obj[1]
    ):
        matched, value = _small_map_lookup(obj[1][0], slot_key)
        if matched:
            return value

    # A2) [params, SmallMap]
    if isinstance(obj, list) and len(obj) == 2 and isinstance(obj[0], bytes):
        matched, value = _small_map_lookup(obj[1], slot_key)
        if matched:
            return value

    # A3) bare SmallMap
    matched, value = _small_map_lookup(obj, slot_key)
    if matched:
        return value

    # B1) [root_cid, bitwidth] wrapper
    if (
        isinstance(obj, list)
        and len(obj) == 2
        and isinstance(obj[0], CID)
        and isinstance(obj[1], int)
    ):
        hamt = HAMT.load(store, obj[0], bit_width=obj[1])
        return _slot_bytes(hamt.get(slot_key))

    # B2) {"root": cid, "bitwidth": n} wrapper
    if isinstance(obj, dict) and isinstance(obj.get("root"), CID) and "bitwidth" in obj:
        hamt = HAMT.load(store, obj["root"], bit_width=obj["bitwidth"])
        return _slot_bytes(hamt.get(slot_key))

    # C) direct HAMT at the root, protocol default bit width
    hamt = HAMT.load(store, contract_state_root, bit_width=HAMT_BIT_WIDTH)
    return _slot_bytes(hamt.get(slot_key))


def _slot_bytes(value) -> Optional[bytes]:
    """A slot HAMT's values are byte buffers; any other CBOR type is a
    decode error in the selected arm (no further fallback)."""
    if value is not None and not isinstance(value, bytes):
        raise ValueError("storage slot value must be bytes")
    return value


def classify_storage_root(obj) -> "tuple[str, object, int]":
    """Resolve which arm of :func:`read_storage_slot`'s five-encoding
    cascade a DECODED storage-root object takes — the arms are purely
    type-directed (a SmallMap is a ``{"v": [...]}`` dict, so HAMT nodes
    ``[bytes, list]`` can never shape-match an A-case), which lets a batch
    driver resolve the encoding once per root. Returns:

    - ``("smallmap", map_obj, 0)`` — A1/A2/A3: every key resolves against
      ``map_obj`` (value or None), nothing beyond the root is touched;
    - ``("hamt", root_or_cid, bit_width)`` — B1/B2/C: walk a HAMT.
    """
    if (
        isinstance(obj, list)
        and len(obj) == 2
        and isinstance(obj[0], bytes)
        and isinstance(obj[1], list)
        and obj[1]
        and _small_map_shape(obj[1][0])
    ):
        return ("smallmap", obj[1][0], 0)
    if isinstance(obj, list) and len(obj) == 2 and isinstance(obj[0], bytes):
        if _small_map_shape(obj[1]):
            return ("smallmap", obj[1], 0)
    if _small_map_shape(obj):
        return ("smallmap", obj, 0)
    if (
        isinstance(obj, list)
        and len(obj) == 2
        and isinstance(obj[0], CID)
        and isinstance(obj[1], int)
    ):
        return ("hamt", obj[0], obj[1])
    if isinstance(obj, dict) and isinstance(obj.get("root"), CID) and "bitwidth" in obj:
        return ("hamt", obj["root"], obj["bitwidth"])
    return ("hamt", None, HAMT_BIT_WIDTH)  # C: direct HAMT at the root itself


def slot_read_route(root: CID, obj) -> tuple:
    """How a batch driver reads the slots under the storage root ``root``
    whose block decoded to ``obj``, by :func:`classify_storage_root`'s arm:

    - ``("map", {key: value})`` — a SmallMap; the first pair of a key wins,
      as `_small_map_lookup`'s list scan;
    - ``("walk", hamt_root, bit_width)`` — a HAMT of bit width 1-8, which
      the batched C walk takes (``hamt_root`` is ``root`` itself for C);
    - ``("scalar", None)`` — a HAMT of any other bit width: the cascade.
    """
    kind, payload, bw = classify_storage_root(obj)
    if kind == "smallmap":
        first_wins: dict[bytes, bytes] = {}
        for key, value in payload["v"]:
            first_wins.setdefault(key, value)
        return ("map", first_wins)
    if type(bw) is int and 1 <= bw <= 8:
        return ("walk", root if payload is None else payload, bw)
    return ("scalar", None)


def _small_map_shape(obj) -> bool:
    """SmallMap *shape* check — exactly `_small_map_lookup`'s acceptance,
    key-independent (the cascade's matched/fall-through is type-driven).
    Values must be CBOR bytes: a text-valued map fails that arm and the
    cascade falls through."""
    if not (isinstance(obj, dict) and set(obj) == {"v"} and isinstance(obj["v"], list)):
        return False
    for pair in obj["v"]:
        if not (
            isinstance(pair, list)
            and len(pair) == 2
            and isinstance(pair[0], bytes)
            and isinstance(pair[1], bytes)
        ):
            return False
    return True


def compute_mapping_slot(key32: bytes, slot_index: int) -> bytes:
    """Solidity mapping slot: ``keccak256(key32 ++ uint256_be(slot_index))``."""
    if len(key32) != 32:
        raise ValueError("mapping key must be 32 bytes")
    return keccak256(key32 + slot_index.to_bytes(32, "big"))


def calculate_storage_slot(subnet_ascii: str, slot_index: int) -> bytes:
    """Mapping slot for an ASCII subnet id."""
    return compute_mapping_slot(ascii_to_bytes32(subnet_ascii), slot_index)
