"""Storage bundles for the port's slot re-read tests, and the witness
surgery they apply.

`storage_bundle` builds one chain over contracts whose storage roots take
one of the fixtures' encodings or ``wrapper_bw<n>``: a ``[root, n]``
wrapper over a HAMT of bit width ``n``, which the fixtures do not write
(bit width 3 splits 64 slots into child nodes on every path; 9 lies
outside the 1-8 the batched walk takes). `slot_path` lists the blocks the
scalar cascade fetches for one claim, and the helpers below damage them.
"""

import pytest

from ipc_proofs_tpu_torch import fixtures
from ipc_proofs_tpu_torch.core.cid import CID
from ipc_proofs_tpu_torch.core.dagcbor import decode, encode
from ipc_proofs_tpu_torch.fixtures import ContractFixture, EventFixture, build_chain
from ipc_proofs_tpu_torch.ipld.hamt import hamt_build
from ipc_proofs_tpu_torch.proofs.bundle import ProofBlock
from ipc_proofs_tpu_torch.proofs.generator import StorageProofSpec, generate_proof_bundle
from ipc_proofs_tpu_torch.proofs.witness import load_witness_store
from ipc_proofs_tpu_torch.state.storage import calculate_storage_slot, read_storage_slot
from ipc_proofs_tpu_torch.store.blockstore import MemoryBlockstore, put_cbor

ZERO = "0x" + "00" * 32


def _storage_root(original):
    def storage_root(store, contract):
        enc = contract.storage_encoding
        if enc.startswith("wrapper_bw"):
            bw = int(enc.removeprefix("wrapper_bw"))
            return put_cbor(store, [hamt_build(store, dict(contract.storage), bit_width=bw), bw])
        return original(store, contract)

    return storage_root


def storage_bundle(encodings, n_slots: int, n_absent: int, match_backend=None):
    """(proofs, blocks): contract ``100 + c`` holds ``n_slots`` slots in
    ``encodings[c]``; each contract's proofs claim its slots, then
    ``n_absent`` slots it does not hold (value zero)."""
    contracts, specs = [], []
    for c, enc in enumerate(encodings):
        storage = {
            calculate_storage_slot(f"r-{c}-{i}", 0): (c * 100 + i + 1).to_bytes(2, "big")
            for i in range(n_slots)
        }
        contracts.append(ContractFixture(actor_id=100 + c, storage=storage, storage_encoding=enc))
        specs += [StorageProofSpec(100 + c, slot) for slot in storage]
        specs += [
            StorageProofSpec(100 + c, calculate_storage_slot(f"r-{c}-absent-{i}", 7))
            for i in range(n_absent)
        ]
    store = MemoryBlockstore()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fixtures, "_storage_root", _storage_root(fixtures._storage_root))
        world = build_chain(
            contracts, [[EventFixture(emitter=100, signature="E()", topic1="x")]], store=store
        )
    bundle = generate_proof_bundle(
        store, world.parent, world.child, specs, [], match_backend=match_backend
    )
    assert len(bundle.storage_proofs) == len(specs)
    return bundle.storage_proofs, bundle.blocks


class _PathStore:
    """A witness store that lists the blocks a read fetches, in order."""

    def __init__(self, blocks):
        self._store = load_witness_store(blocks)
        self.path: list[CID] = []

    def get(self, cid):
        self.path.append(cid)
        return self._store.get(cid)


def slot_path(blocks, proof) -> "list[CID]":
    """The blocks the scalar cascade fetches to re-read ``proof``'s slot,
    the storage root first, as far as the read gets."""
    store = _PathStore(blocks)
    try:
        slot = bytes.fromhex(proof.slot.removeprefix("0x"))
        read_storage_slot(store, CID.from_string(proof.storage_root), slot)
    except (KeyError, ValueError):
        pass
    return store.path


def without(blocks, cid: CID) -> list:
    return [b for b in blocks if b.cid != cid]


def replaced(blocks, cid: CID, data: bytes) -> list:
    """``blocks`` with ``cid``'s bytes swapped for ``data`` under the same
    CID (the witness store does not recompute CIDs)."""
    return [ProofBlock(b.cid, data) if b.cid == cid else b for b in blocks]


def _block(blocks, cid: CID) -> bytes:
    return next(b.data for b in blocks if b.cid == cid)


def _is_hamt_node(node) -> bool:
    return (
        isinstance(node, list)
        and len(node) == 2
        and isinstance(node[0], bytes)
        and isinstance(node[1], list)
    )


def _entries(node) -> list:
    """The [key, value] pairs of a HAMT node's buckets or of a SmallMap
    root (bare, ``[params, map]`` or ``[params, [map]]``)."""
    if _is_hamt_node(node):
        return [kv for ptr in node[1] if isinstance(ptr, list) for kv in ptr]
    if isinstance(node, list):
        node = node[1][0] if isinstance(node[1], list) else node[1]
    return node["v"]


def with_value(blocks, cid: CID, slot: bytes, value) -> list:
    """The node ``cid`` re-encoded with ``slot``'s value set to ``value``."""
    node = decode(_block(blocks, cid))
    hits = [kv for kv in _entries(node) if kv[0] == slot]
    assert len(hits) == 1
    hits[0][1] = value
    return replaced(blocks, cid, encode(node))


def damaged_outside(blocks, cid: CID, slot: bytes) -> "list | None":
    """The node ``cid`` with a 2-byte value that the walk to ``slot`` never
    reaches rewritten as a text string of bytes that are not UTF-8: invalid
    DAG-CBOR that only a full decode of the node sees. In a HAMT node the
    value lies in a bucket after the one the walk takes, which the walk
    neither reads nor skips over. None where the node holds no such value."""
    data = _block(blocks, cid)
    node = decode(data)
    if _is_hamt_node(node):
        taken = next(
            i for i, ptr in enumerate(node[1])
            if isinstance(ptr, list) and any(kv[0] == slot for kv in ptr)
        )
        others = [kv for ptr in node[1][taken + 1 :] if isinstance(ptr, list) for kv in ptr]
    else:
        others = [kv for kv in _entries(node) if kv[0] != slot]
    for key, value in others:
        old = key + b"\x42" + value
        if len(value) == 2 and data.count(old) == 1:
            bad = data.replace(old, key + b"\x62\xff\xff")
            with pytest.raises(ValueError):
                decode(bad)
            return replaced(blocks, cid, bad)
    return None
