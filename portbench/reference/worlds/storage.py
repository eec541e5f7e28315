"""The storage world: the chain of one parent→child pair over EVM contracts
whose mapping slots sit in direct HAMTs, beside filler account actors.

A frozen, plain copy of the program's ``fixtures.build_chain`` over
``ContractFixture`` storage, written with this folder's own DAG-CBOR, AMT,
HAMT and CID code. With ``seed=None`` the blocks are byte for byte the
fixture's for the same sizes; a seed varies contents only, never the shape.
"""

from __future__ import annotations

import numpy as np

from portbench.reference.chain import (
    World,
    ascii_to_bytes32,
    bigint,
    header,
    id_address,
    raw_link,
    seeded_rng,
)
from portbench.reference.hashes import cid_str, keccak256_many
from portbench.reference.ipld import BlockSink, amt_build, hamt_build

__all__ = ["build"]


def build(shape: dict, seed=None) -> World:
    """One parent(H)→child(H+1) pair over ``n_contracts`` EVM contracts
    (actor ids from ``first_actor_id``) with ``n_slots`` mapping slots each,
    keyed ``keccak(ascii32(name) ‖ be32(i))`` and holding
    ``value_bytes``-byte values, in direct HAMTs, beside
    ``n_filler_actors`` account actors; no messages. Unseeded, contract c's
    name is ``subnet-<c>`` and slot i's value ``i % 251``; a seed tags the
    names and draws the values."""
    n_contracts = shape["n_contracts"]
    n_slots = shape["n_slots"]
    first = shape["first_actor_id"]
    width = shape["hamt_bit_width"]
    height = shape["parent_height"]
    vbytes = shape["value_bytes"]
    rng = seeded_rng(seed)
    tag = "" if rng is None else f"{int(rng.integers(0, 1 << 30)):x}-"
    names = [f"subnet-{tag}{c}" for c in range(n_contracts)]
    preimages = [ascii_to_bytes32(name) + i.to_bytes(32, "big") for name in names
                 for i in range(n_slots)]
    keys = keccak256_many(preimages)
    if rng is None:
        values = [(i % 251).to_bytes(vbytes, "big") for _ in names for i in range(n_slots)]
    else:
        # the first byte nonzero: a value reads back as these bytes, never shorter
        raw = rng.integers(0, 256, size=(len(keys), vbytes), dtype=np.uint8)
        raw[:, 0] |= 1
        values = [row.tobytes() for row in raw]

    sink = BlockSink()
    actors, evm_states, storage_roots = {}, [], []
    for c in range(n_contracts):
        actor_id = first + c
        storage = {keys[c * n_slots + i]: values[c * n_slots + i] for i in range(n_slots)}
        root = hamt_build(sink, storage, width)
        evm_state = sink.put([raw_link(f"bytecode-{actor_id}".encode()), b"\xbc" * 32, root,
                              None, 1, None])
        actors[id_address(actor_id)] = [raw_link(b"fil/evm"), evm_state, 1, bigint(0), None]
        evm_states.append(evm_state)
        storage_roots.append(root)
    for i in range(shape["n_filler_actors"]):
        filler = sink.put([i, f"filler-{i}"])
        actors[id_address(10_000 + i)] = [raw_link(b"fil/account"), filler, 0, bigint(i), None]
    actors_root = hamt_build(sink, actors, width)
    info = sink.put("state-info")
    state_root = sink.put([5, actors_root, info])

    bls_root = amt_build(sink, {}, version=0)
    secp_root = amt_build(sink, {}, version=0)
    txmeta = sink.put([bls_root, secp_root])
    receipts_root = amt_build(sink, [], version=0)
    grandparents = [raw_link(b"grandparent-block")]
    old_state = sink.put([5, hamt_build(sink, {}, width), info])
    empty_amt = amt_build(sink, [], version=0)
    old_receipts = amt_build(sink, [], version=0)
    parent = sink.put(header(grandparents, height, old_state, old_receipts, txmeta,
                                       "f01000"))
    child_txmeta = sink.put([empty_amt, empty_amt])
    child = sink.put(header([parent], height + 1, state_root, receipts_root,
                                      child_txmeta, "f02000"))

    specs, expected = [], []
    child_s, state_root_s = cid_str(child), cid_str(state_root)
    for c, name in enumerate(names):
        evm_state_s, storage_root_s = cid_str(evm_states[c]), cid_str(storage_roots[c])
        for i in range(n_slots):
            k = c * n_slots + i
            specs.append((first + c, name, i))
            expected.append({
                "child_epoch": height + 1,
                "child_block_cid": child_s,
                "parent_state_root": state_root_s,
                "actor_id": first + c,
                "actor_state_cid": evm_state_s,
                "storage_root": storage_root_s,
                "slot": "0x" + keys[k].hex(),
                "value": "0x" + values[k].rjust(32, b"\x00").hex(),
            })
    return World(blocks=sink.blocks, pairs=[(bytes(parent), bytes(child))],
                 event_spec=(shape["event_signature"], shape["event_topic1"], first),
                 storage_specs=specs, expected_storage=expected)
