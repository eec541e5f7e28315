"""Synthetic Filecoin worlds: hermetic test and smoke-run inputs.

With the package's own AMT/HAMT/header writers, byte-identical to
``ipc_proofs_tpu.fixtures`` for the same arguments:

- `build_chain` writes one parent(H) → child(H+1) world: a state tree of
  EVM contracts (`ContractFixture`, storage in any of four encodings) and
  filler actors, and the messages, receipts and events
  (`EventFixture`) of the parent tipset;
- `build_range_world` writes a range of parent→child tipset pairs sharing
  one state tree.

`world_from_blocks` loads a world built elsewhere (as plain bytes) into this
package's types. `seeded_power_table` and `finality_certificates` sign
synthetic F3 certificates over a world's tipsets (with `certificate_json_obj`
and `power_table_json`, the Forest JSON the CLI reads).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, Optional

from ipc_proofs_tpu_torch.core.cid import CID, RAW
from ipc_proofs_tpu_torch.ipld.amt import amt_build, amt_build_v0
from ipc_proofs_tpu_torch.ipld.hamt import hamt_build
from ipc_proofs_tpu_torch.proofs.chain import Tipset
from ipc_proofs_tpu_torch.proofs.range import TipsetPair
from ipc_proofs_tpu_torch.state.actors import ActorState, StateRoot
from ipc_proofs_tpu_torch.state.address import Address
from ipc_proofs_tpu_torch.state.events import (
    IPLD_RAW,
    ActorEvent,
    EventEntry,
    Receipt,
    StampedEvent,
    ascii_to_bytes32,
    hash_event_signature,
)
from ipc_proofs_tpu_torch.state.header import BlockHeader
from ipc_proofs_tpu_torch.store.blockstore import Blockstore, MemoryBlockstore, put_cbor

__all__ = [
    "ContractFixture",
    "EventFixture",
    "ChainFixture",
    "build_chain",
    "build_range_world",
    "world_from_blocks",
    "seeded_power_table",
    "finality_certificates",
    "certificate_json_obj",
    "power_table_json",
]


@dataclass
class ContractFixture:
    """An EVM contract actor with a storage map (slot digest → raw value)."""

    actor_id: int
    storage: dict[bytes, bytes] = field(default_factory=dict)
    nonce: int = 1
    storage_encoding: str = "direct"  # direct | wrapper_tuple | wrapper_map | inline


@dataclass
class EventFixture:
    """One EVM event emitted by a message."""

    emitter: int
    signature: str
    topic1: str
    extra_topics: list[bytes] = field(default_factory=list)
    data: bytes = b"\x00" * 32
    encoding: str = "compact"  # compact (t1..t4 + d) | concat (topics + data)

    def to_stamped(self) -> StampedEvent:
        topics = [
            hash_event_signature(self.signature),
            ascii_to_bytes32(self.topic1),
            *self.extra_topics,
        ]
        if self.encoding == "compact":
            entries = [
                EventEntry(0, f"t{i + 1}", IPLD_RAW, t) for i, t in enumerate(topics[:4])
            ]
            entries.append(EventEntry(0, "d", IPLD_RAW, self.data))
        elif self.encoding == "concat":
            entries = [
                EventEntry(0, "topics", IPLD_RAW, b"".join(topics)),
                EventEntry(0, "data", IPLD_RAW, self.data),
            ]
        else:
            raise ValueError(f"unknown event encoding {self.encoding}")
        return StampedEvent(emitter=self.emitter, event=ActorEvent(entries=entries))


@dataclass
class ChainFixture:
    store: MemoryBlockstore
    parent: Tipset
    child: Tipset
    state_root_cid: CID
    receipts_root: CID
    message_cids: list[CID]  # canonical execution order
    contracts: dict[int, ContractFixture]


def _storage_root(store: Blockstore, contract: ContractFixture) -> CID:
    """Write the contract's storage in the requested on-disk encoding (the
    arms `state.storage.read_storage_slot` reads)."""
    if contract.storage_encoding == "direct":
        return hamt_build(store, dict(contract.storage))
    if contract.storage_encoding == "wrapper_tuple":
        inner = hamt_build(store, dict(contract.storage))
        return put_cbor(store, [inner, 5])
    if contract.storage_encoding == "wrapper_map":
        inner = hamt_build(store, dict(contract.storage))
        return put_cbor(store, {"root": inner, "bitwidth": 5})
    if contract.storage_encoding == "inline":
        small_map = {"v": [[k, v] for k, v in sorted(contract.storage.items())]}
        return put_cbor(store, [b"params", small_map])
    raise ValueError(f"unknown storage encoding {contract.storage_encoding}")


def build_chain(
    contracts: list[ContractFixture],
    events_per_message: list[list[EventFixture]],
    parent_height: int = 100,
    n_parent_blocks: int = 1,
    n_filler_actors: int = 50,
    store: Optional[MemoryBlockstore] = None,
    failed_message_indices: Optional[set[int]] = None,
) -> ChainFixture:
    """Build a full synthetic parent(H) → child(H+1) world.

    ``events_per_message[i]`` lists the events emitted by message i (in
    canonical execution order). Messages are spread in contiguous chunks
    across ``n_parent_blocks`` parent blocks, the first half of each chunk
    in the block's BLS list and the rest in its secp list.
    """
    bs = store if store is not None else MemoryBlockstore()
    failed = failed_message_indices or set()

    # --- state tree ---------------------------------------------------------
    actors: dict[bytes, list] = {}
    for contract in contracts:
        storage_root = _storage_root(bs, contract)
        bytecode_cid = CID.hash_of(f"bytecode-{contract.actor_id}".encode(), codec=RAW)
        evm_state_cid = put_cbor(
            bs,
            [bytecode_cid, b"\xbc" * 32, storage_root, None, contract.nonce, None],
        )
        actor = ActorState(
            code=CID.hash_of(b"fil/evm", codec=RAW),
            state=evm_state_cid,
            call_seq_num=contract.nonce,
            balance=0,
        )
        actors[Address.new_id(contract.actor_id).to_bytes()] = actor.to_tuple()

    for i in range(n_filler_actors):
        filler_state = put_cbor(bs, [i, f"filler-{i}"])
        actor = ActorState(
            code=CID.hash_of(b"fil/account", codec=RAW),
            state=filler_state,
            call_seq_num=0,
            balance=i,
        )
        actors[Address.new_id(10_000 + i).to_bytes()] = actor.to_tuple()

    actors_root = hamt_build(bs, actors)
    info_cid = put_cbor(bs, "state-info")
    state_root_cid = put_cbor(bs, StateRoot(version=5, actors=actors_root, info=info_cid).to_tuple())

    # --- messages: contiguous chunks per parent block, BLS then secp -------
    # canonical execution order (per block, BLS list then secp list) is then
    # message_cids order, so events_per_message[i] is the i-th executed
    # message's
    n_messages = len(events_per_message)
    message_cids = [
        CID.hash_of(f"message-{i}".encode(), codec=RAW) for i in range(n_messages)
    ]
    per_block_bls: list[dict[int, CID]] = [dict() for _ in range(n_parent_blocks)]
    per_block_secp: list[dict[int, CID]] = [dict() for _ in range(n_parent_blocks)]
    chunk = (n_messages + n_parent_blocks - 1) // max(n_parent_blocks, 1)
    for block in range(n_parent_blocks):
        block_msgs = message_cids[block * chunk : (block + 1) * chunk]
        split = (len(block_msgs) + 1) // 2
        for cid in block_msgs[:split]:
            per_block_bls[block][len(per_block_bls[block])] = cid
        for cid in block_msgs[split:]:
            per_block_secp[block][len(per_block_secp[block])] = cid

    txmeta_cids = []
    for block in range(n_parent_blocks):
        bls_root = amt_build_v0(bs, per_block_bls[block])
        secp_root = amt_build_v0(bs, per_block_secp[block])
        txmeta_cids.append(put_cbor(bs, [bls_root, secp_root]))

    exec_order: list[CID] = []
    seen: set[CID] = set()
    for block in range(n_parent_blocks):
        for group in (per_block_bls[block], per_block_secp[block]):
            for _, cid in sorted(group.items()):
                if cid not in seen:
                    seen.add(cid)
                    exec_order.append(cid)

    # --- receipts + events (indexed by canonical execution position) --------
    events_by_cid = {message_cids[i]: events_per_message[i] for i in range(n_messages)}
    failed_cids = {message_cids[i] for i in failed}
    receipts: list[list] = []
    for position, msg_cid in enumerate(exec_order):
        events = events_by_cid[msg_cid]
        events_root = None
        if events and msg_cid not in failed_cids:
            stamped = [e.to_stamped().to_cbor() for e in events]
            events_root = amt_build(bs, stamped, bit_width=5, version=3)
        receipt = Receipt(
            exit_code=1 if msg_cid in failed_cids else 0,
            return_data=b"",
            gas_used=1_000_000 + position,
            events_root=events_root,
        )
        receipts.append(receipt.to_cbor())
    receipts_root = amt_build_v0(bs, receipts)

    # --- headers ------------------------------------------------------------
    grandparent_cids = [CID.hash_of(b"grandparent-block", codec=RAW)]
    old_state = put_cbor(bs, StateRoot(version=5, actors=hamt_build(bs, {}), info=info_cid).to_tuple())
    empty_amt = amt_build_v0(bs, [])
    old_receipts = amt_build_v0(bs, [])

    parent_headers = [
        BlockHeader(
            parents=grandparent_cids,
            height=parent_height,
            parent_state_root=old_state,
            parent_message_receipts=old_receipts,
            messages=txmeta_cids[block],
            timestamp=1_700_000_000 + parent_height * 30,
            miner=f"f0{1000 + block}",
        )
        for block in range(n_parent_blocks)
    ]
    parent_cids = []
    for header in parent_headers:
        raw = header.encode()
        cid = CID.hash_of(raw)
        bs.put_keyed(cid, raw)
        parent_cids.append(cid)
    parent = Tipset(cids=parent_cids, blocks=parent_headers, height=parent_height)

    child_txmeta = put_cbor(bs, [empty_amt, empty_amt])
    child_header = BlockHeader(
        parents=parent_cids,
        height=parent_height + 1,
        parent_state_root=state_root_cid,
        parent_message_receipts=receipts_root,
        messages=child_txmeta,
        timestamp=1_700_000_000 + (parent_height + 1) * 30,
        miner="f02000",
    )
    child_raw = child_header.encode()
    child_cid = CID.hash_of(child_raw)
    bs.put_keyed(child_cid, child_raw)
    child = Tipset(cids=[child_cid], blocks=[child_header], height=parent_height + 1)

    return ChainFixture(
        store=bs,
        parent=parent,
        child=child,
        state_root_cid=state_root_cid,
        receipts_root=receipts_root,
        message_cids=exec_order,
        contracts={c.actor_id: c for c in contracts},
    )


def world_from_blocks(
    items: "Iterable[tuple[bytes, bytes]]",
    pair_header_cids: "Iterable[tuple[bytes, bytes]]" = (),
) -> "tuple[MemoryBlockstore, list[TipsetPair]]":
    """A `MemoryBlockstore` from ``(cid_bytes, data)`` pairs, plus one
    `TipsetPair` per ``(parent_header_cid_bytes, child_header_cid_bytes)``
    (single-block tipsets, headers decoded from the store)."""
    store = MemoryBlockstore()
    for cid_bytes, data in items:
        store.put_keyed(CID.from_bytes(cid_bytes), data)
    pairs = [
        TipsetPair(
            parent=Tipset.from_blockstore(store, [CID.from_bytes(parent)]),
            child=Tipset.from_blockstore(store, [CID.from_bytes(child)]),
        )
        for parent, child in pair_header_cids
    ]
    return store, pairs


def build_range_world(
    n_pairs: int,
    receipts_per_pair: int = 16,
    events_per_receipt: int = 4,
    match_rate: float = 0.01,
    signature: str = "NewTopDownMessage(bytes32,uint256)",
    topic1: str = "calib-subnet-1",
    actor_id: int = 1001,
    base_height: int = 1000,
    store: Optional[MemoryBlockstore] = None,
    chained: bool = False,
):
    """A benchmark-scale range of parent→child pairs sharing one state tree.

    The state tree is written once; each pair gets only its own messages,
    receipts, events AMTs, and headers. Event payloads embed (pair, receipt,
    event) indices so blocks are unique across the range.

    By default pair p sits at heights ``base_height + 2p`` (parent) and
    ``+ 1`` (child), its own two tipsets, as in the reference. ``chained``
    makes the pairs one chain of ``n_pairs + 1`` tipsets at consecutive
    heights instead: pair p's child is pair p+1's parent, carrying pair p's
    receipts and pair p+1's messages, so a client that pairs consecutive
    heights (the CLI's ``range``) sees exactly ``n_pairs`` pairs.

    A fraction ``match_rate`` of receipts (evenly spread) contain exactly one
    event matching ``(signature, topic1, actor_id)``; all other events are
    noise with a different signature. Returns ``(store, pairs,
    n_matching_receipts)``.
    """
    bs = store if store is not None else MemoryBlockstore()

    # --- shared state tree (one contract actor, written once) ---------------
    storage_root = hamt_build(bs, {})
    bytecode_cid = CID.hash_of(b"range-bytecode", codec=RAW)
    evm_state_cid = put_cbor(bs, [bytecode_cid, b"\xbc" * 32, storage_root, None, 1, None])
    actor = ActorState(
        code=CID.hash_of(b"fil/evm", codec=RAW), state=evm_state_cid,
        call_seq_num=1, balance=0,
    )
    actors_root = hamt_build(bs, {Address.new_id(actor_id).to_bytes(): actor.to_tuple()})
    info_cid = put_cbor(bs, "state-info")
    state_root_cid = put_cbor(bs, StateRoot(version=5, actors=actors_root, info=info_cid).to_tuple())
    grandparent_cids = [CID.hash_of(b"range-grandparent", codec=RAW)]
    old_receipts = amt_build_v0(bs, [])
    empty_amt = amt_build_v0(bs, [])
    child_txmeta = put_cbor(bs, [empty_amt, empty_amt])

    # pre-encoded topics shared by every event
    topic0 = hash_event_signature(signature)
    t1 = ascii_to_bytes32(topic1)
    noise_topic0 = hash_event_signature("Noise(uint256)")

    every = max(int(round(1.0 / match_rate)), 1) if match_rate > 0 else 0
    n_matching = 0
    pairs = []
    links = []  # chained: (receipts root, TxMeta) per pair
    for p in range(n_pairs):
        receipts = []
        msg_cids = []
        for r in range(receipts_per_pair):
            gid = p * receipts_per_pair + r
            msg_cids.append(CID.hash_of(b"msg-%d" % gid, codec=RAW))
            stamped = []
            for e in range(events_per_receipt):
                uniq = (gid * events_per_receipt + e).to_bytes(32, "big")
                if every and gid % every == 0 and e == 0:
                    entries = [[0, "t1", IPLD_RAW, topic0], [0, "t2", IPLD_RAW, t1],
                               [0, "d", IPLD_RAW, uniq]]
                else:
                    entries = [[0, "t1", IPLD_RAW, noise_topic0], [0, "t2", IPLD_RAW, uniq],
                               [0, "d", IPLD_RAW, uniq]]
                stamped.append([actor_id, entries])
            if every and gid % every == 0:
                n_matching += 1
            events_root = amt_build(bs, stamped, bit_width=5, version=3)
            receipts.append([0, b"", 1_000_000 + gid, events_root])
        receipts_root = amt_build_v0(bs, receipts)
        bls_root = amt_build_v0(bs, {i: c for i, c in enumerate(msg_cids)})
        txmeta = put_cbor(bs, [bls_root, empty_amt])
        if chained:
            links.append((receipts_root, txmeta))
            continue

        height = base_height + 2 * p
        parent_header = BlockHeader(
            parents=grandparent_cids, height=height,
            parent_state_root=state_root_cid, parent_message_receipts=old_receipts,
            messages=txmeta, timestamp=1_700_000_000 + height * 30, miner="f01000",
        )
        parent_raw = parent_header.encode()
        parent_cid = CID.hash_of(parent_raw)
        bs.put_keyed(parent_cid, parent_raw)
        child_header = BlockHeader(
            parents=[parent_cid], height=height + 1,
            parent_state_root=state_root_cid, parent_message_receipts=receipts_root,
            messages=child_txmeta, timestamp=1_700_000_000 + (height + 1) * 30, miner="f02000",
        )
        child_raw = child_header.encode()
        child_cid = CID.hash_of(child_raw)
        bs.put_keyed(child_cid, child_raw)
        pairs.append(
            TipsetPair(
                parent=Tipset(cids=[parent_cid], blocks=[parent_header], height=height),
                child=Tipset(cids=[child_cid], blocks=[child_header], height=height + 1),
            )
        )
    if chained:
        pairs = _chain_tipsets(bs, links, grandparent_cids, state_root_cid, old_receipts,
                               child_txmeta, base_height)
    return bs, pairs, n_matching


def _chain_tipsets(bs, links, grandparent_cids, state_root_cid, old_receipts, last_txmeta,
                   base_height: int) -> "list[TipsetPair]":
    """One single-block tipset per height: tipset k carries pair k-1's
    receipts and pair k's messages (the last one an empty TxMeta)."""
    tipsets = []
    parents = grandparent_cids
    for k in range(len(links) + 1):
        height = base_height + k
        header = BlockHeader(
            parents=parents, height=height, parent_state_root=state_root_cid,
            parent_message_receipts=links[k - 1][0] if k else old_receipts,
            messages=links[k][1] if k < len(links) else last_txmeta,
            timestamp=1_700_000_000 + height * 30, miner="f01000",
        )
        raw = header.encode()
        cid = CID.hash_of(raw)
        bs.put_keyed(cid, raw)
        tipsets.append(Tipset(cids=[cid], blocks=[header], height=height))
        parents = [cid]
    return [TipsetPair(parent=a, child=b) for a, b in zip(tipsets, tipsets[1:])]


def seeded_power_table(n: int, seed: int):
    """``n`` F3 participants drawn from ``seed``: ``(secret_keys, table)``,
    each `PowerTableEntry` with power 1–100, its base64 G1 key and its
    proof of possession (one hash-to-G2 each)."""
    import base64
    import random

    from ipc_proofs_tpu_torch.crypto import bls
    from ipc_proofs_tpu_torch.proofs.cert import PowerTableEntry

    rng = random.Random(seed)
    sks = [rng.randrange(1, bls.CURVE_ORDER) for _ in range(n)]
    table = [
        PowerTableEntry(
            participant_id=i,
            power=rng.randint(1, 100),
            signing_key=base64.b64encode(bls.g1_compress(bls.sk_to_pk(sk))).decode(),
            pop=base64.b64encode(bls.g2_compress(bls.pop_prove(sk))).decode(),
        )
        for i, sk in enumerate(sks)
    ]
    return sks, table


def finality_certificates(tipsets, secret_keys, table, per_cert: int):
    """Consecutive certificates finalizing ``tipsets`` (height order),
    ``per_cert`` new tipsets each; every certificate's EC chain starts at
    the previous one's head. All of ``table`` signs, and the aggregate
    signature is the signature of the secret keys' sum (the same G2 point
    as the sum of the signers' signatures, for one hash-to-G2 a
    certificate). No power-table deltas: every commitment is ``table``'s
    CID."""
    from ipc_proofs_tpu_torch.crypto import bls
    from ipc_proofs_tpu_torch.crypto.rleplus import encode_rleplus
    from ipc_proofs_tpu_torch.proofs.cert import (
        ECTipSet,
        FinalityCertificate,
        SupplementalData,
        power_table_cid,
    )

    table_cid = str(power_table_cid(table))
    chain = [ECTipSet(key=[str(c) for c in ts.cids], epoch=ts.height, power_table=table_cid)
             for ts in tipsets]
    aggregate_sk = sum(secret_keys) % bls.CURVE_ORDER
    certs = []
    for k, start in enumerate(range(0, max(len(chain) - 1, 1), per_cert)):
        cert = FinalityCertificate(
            instance=k,
            ec_chain=chain[start : start + per_cert + 1],
            supplemental_data=SupplementalData(power_table=table_cid),
            signers=encode_rleplus(list(range(len(table)))),
        )
        cert.signature = bls.g2_compress(bls.sign(aggregate_sk, cert.signing_payload()))
        certs.append(cert)
    return certs


def certificate_json_obj(cert) -> dict:
    """A `FinalityCertificate` as the Forest JSON object the CLI reads."""
    import base64

    def b64(raw: bytes) -> str:
        return base64.b64encode(bytes(raw)).decode()

    return {
        "GPBFTInstance": cert.instance,
        "ECChain": [
            {
                "Key": [{"/": c} for c in ts.key],
                "Epoch": ts.epoch,
                "PowerTable": {"/": ts.power_table},
                "Commitments": b64(ts.commitments),
            }
            for ts in cert.ec_chain
        ],
        "SupplementalData": {
            "Commitments": b64(cert.supplemental_data.commitments),
            "PowerTable": {"/": cert.supplemental_data.power_table},
        },
        "Signers": list(cert.signers) if isinstance(cert.signers, list) else b64(cert.signers),
        "Signature": b64(cert.signature),
        "PowerTableDelta": [
            {"ParticipantID": d.participant_id, "PowerDelta": d.power_delta,
             "SigningKey": d.signing_key, "Pop": d.pop}
            for d in cert.power_table_delta
        ],
    }


def power_table_json(table) -> list:
    """A power table as the rows ``cert --power-table`` reads."""
    return [
        {"ParticipantID": e.participant_id, "Power": e.power, "SigningKey": e.signing_key,
         "Pop": e.pop}
        for e in table
    ]
