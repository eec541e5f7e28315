"""The range world: parent→child tipset pairs sharing one state tree, each
child's receipts holding stamped EVM events, a few of them the ones to
prove.

A frozen, plain copy of the program's ``fixtures.build_range_world``,
written with this folder's own DAG-CBOR, AMT, HAMT and CID code. With
``seed=None`` the blocks are byte for byte the fixture's for the same
sizes; a seed varies contents only, never the shape.
"""

from __future__ import annotations

from portbench.reference.cbor import Encoded, encode
from portbench.reference.chain import (
    IPLD_RAW,
    World,
    ascii_to_bytes32,
    bigint,
    header,
    id_address,
    raw_link,
    seeded_rng,
)
from portbench.reference.hashes import cid_str, keccak256
from portbench.reference.ipld import BlockSink, amt_build, hamt_build

__all__ = ["build"]


def build(shape: dict, seed=None) -> World:
    """``n_pairs`` parent→child pairs, each on its own two heights, with
    ``receipts_per_pair`` receipts of ``events_per_receipt`` events. Every
    ``round(1 / match_rate)``-th receipt (from a seeded offset) holds one
    event of ``signature`` with topic1 ``topic1`` from ``actor_id``; every
    other event is noise. The seed picks the offset among those that keep
    the number of matches, XORs a 32-byte mask into every payload (payloads
    stay distinct) and picks topic1's number."""
    n_pairs = shape["n_pairs"]
    per_pair = shape["receipts_per_pair"]
    per_receipt = shape["events_per_receipt"]
    signature = shape["signature"]
    topic1 = shape["topic1"]
    actor_id = shape["actor_id"]
    base = shape["base_height"]
    every = max(int(round(1.0 / shape["match_rate"])), 1)
    rng = seeded_rng(seed)
    offset, mask = 0, 0
    if rng is not None:
        n_gids = n_pairs * per_pair
        offset = int(rng.integers(0, (n_gids % every) or every))
        mask = int.from_bytes(rng.bytes(32), "big")
        topic1 = topic1.rsplit("-", 1)[0] + "-" + str(int(rng.integers(1, 1_000_000)))

    sink = BlockSink()
    storage_root = hamt_build(sink, {})
    evm_state = sink.put([raw_link(b"range-bytecode"), b"\xbc" * 32, storage_root, None, 1, None])
    actor = [raw_link(b"fil/evm"), evm_state, 1, bigint(0), None]
    actors_root = hamt_build(sink, {id_address(actor_id): actor})
    info = sink.put("state-info")
    state_root = sink.put([5, actors_root, info])
    grandparents = [raw_link(b"range-grandparent")]
    old_receipts = amt_build(sink, [], version=0)
    empty_amt = amt_build(sink, [], version=0)
    child_txmeta = sink.put([empty_amt, empty_amt])

    topic0 = keccak256(signature.encode("utf-8"))
    t1 = ascii_to_bytes32(topic1)
    noise0 = keccak256(b"Noise(uint256)")
    # a stamped event [actor, [[0, "t1", raw, a], [0, "t2", raw, b], [0, "d", raw, c]]]
    # of 32-byte a, b, c, encoded by splicing the values into fixed pieces
    opening = b"\x82" + encode(actor_id) + b"\x83"
    p1, p2, p3 = (encode([0, key, IPLD_RAW, bytes(32)])[:-32] for key in ("t1", "t2", "d"))

    def stamped_event(a: bytes, b: bytes, c: bytes) -> Encoded:
        return Encoded(opening + p1 + a + p2 + b + p3 + c)

    pairs, expected = [], []
    for p in range(n_pairs):
        receipts, msg_cids, hits = [], [], []
        for r in range(per_pair):
            gid = p * per_pair + r
            msg = raw_link(b"msg-%d" % gid)
            msg_cids.append(msg)
            stamped = []
            for e in range(per_receipt):
                uniq = ((gid * per_receipt + e) ^ mask).to_bytes(32, "big")
                if gid % every == offset and e == 0:
                    stamped.append(stamped_event(topic0, t1, uniq))
                    hits.append((r, e, msg, uniq))
                else:
                    stamped.append(stamped_event(noise0, uniq, uniq))
            events_root = amt_build(sink, stamped, version=3, bit_width=5)
            receipts.append([0, b"", 1_000_000 + gid, events_root])
        receipts_root = amt_build(sink, receipts, version=0)
        bls_root = amt_build(sink, dict(enumerate(msg_cids)), version=0)
        txmeta = sink.put([bls_root, empty_amt])
        height = base + 2 * p
        parent = sink.put(header(grandparents, height, state_root, old_receipts,
                                           txmeta, "f01000"))
        child = sink.put(header([parent], height + 1, state_root, receipts_root,
                                          child_txmeta, "f02000"))
        pairs.append((bytes(parent), bytes(child)))
        for r, e, msg, uniq in hits:
            expected.append({
                "parent_epoch": height,
                "child_epoch": height + 1,
                "parent_tipset_cids": [cid_str(parent)],
                "child_block_cid": cid_str(child),
                "message_cid": cid_str(msg),
                "exec_index": r,
                "event_index": e,
                "event_data": {
                    "emitter": actor_id,
                    "topics": ["0x" + topic0.hex(), "0x" + t1.hex()],
                    "data": "0x" + uniq.hex(),
                },
            })
    return World(blocks=sink.blocks, pairs=pairs, event_spec=(signature, topic1, actor_id),
                 expected_events=expected)
