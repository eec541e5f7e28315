"""Event proof generation: the two-pass filter over receipts × events.

1. matcher = (keccak(event_signature), ascii_to_bytes32(topic_1));
2. base witness: parent header CIDs + child header + receipts root + TxMeta
   CIDs; full TxMeta AMT walks recorded (execution-order witness);
3. canonical execution order (BLS-before-secp, first-seen dedup);
4. PASS 1: scan every receipt's events AMT without recording, then the
   batched predicate — only *indices* survive;
5. PASS 2: re-touch only matching receipts and their event AMTs under
   recording stores, emitting claims.

The phases are composable functions so the range driver
(`proofs/range.py`) batches pass 1 of many tipset pairs into one device
call. The counterpart of ``ipc_proofs_tpu.proofs.event_generator``.
"""

from __future__ import annotations

from typing import Optional

from ipc_proofs_tpu_torch.backend import get_backend
from ipc_proofs_tpu_torch.core.cid import CID
from ipc_proofs_tpu_torch.ipld.amt import AMT
from ipc_proofs_tpu_torch.proofs.bundle import EventData, EventProof, EventProofBundle
from ipc_proofs_tpu_torch.proofs.chain import Tipset, receipt_from_api_json
from ipc_proofs_tpu_torch.proofs.exec_order import decode_txmeta
from ipc_proofs_tpu_torch.proofs.witness import WitnessCollector
from ipc_proofs_tpu_torch.state.events import (
    Receipt,
    StampedEvent,
    ascii_to_bytes32,
    extract_evm_log,
    hash_event_signature,
)
from ipc_proofs_tpu_torch.store.blockstore import Blockstore, RecordingBlockstore

__all__ = [
    "EventMatcher",
    "collect_base_witness_and_exec_order",
    "scan_receipt_events",
    "scan_receipts_from_api",
    "match_receipt_indices",
    "mask_receipt_indices",
    "record_matching_receipts",
    "generate_event_proof",
]


class EventMatcher:
    """topic0/topic1 equality matcher."""

    def __init__(self, event_signature: str, topic_1: str):
        self.topic0 = hash_event_signature(event_signature)
        self.topic1 = ascii_to_bytes32(topic_1)

    def matches_log(self, log) -> bool:
        return (
            len(log.topics) >= 2
            and log.topics[0] == self.topic0
            and log.topics[1] == self.topic1
        )


def collect_base_witness_and_exec_order(
    collector: WitnessCollector, store: Blockstore, parent: Tipset, child: Tipset
) -> list[CID]:
    """Seed the witness (headers, receipts root, TxMeta CIDs, the recorded
    TxMeta AMT walks) and return the canonical execution order from the
    same walks: per block, BLS before secp, first-seen dedup."""
    child_cid = child.cids[0]
    receipts_root = child.blocks[0].parent_message_receipts
    for parent_cid in parent.cids:
        collector.add_cid(parent_cid)
    collector.add_cid(child_cid)
    collector.add_cid(receipts_root)
    for header in parent.blocks:
        collector.add_cid(header.messages)

    exec_order: list[CID] = []
    seen: set[CID] = set()
    tx_recorder = RecordingBlockstore(store)
    for header in parent.blocks:
        tx_raw = tx_recorder.get(header.messages)
        if tx_raw is None:
            raise KeyError(f"missing TxMeta {header.messages}")
        bls_root, secp_root = decode_txmeta(tx_raw)
        for root in (bls_root, secp_root):
            for _, msg_cid in AMT.load(tx_recorder, root, expected_version=0).items():
                if not isinstance(msg_cid, CID):
                    raise ValueError("message list AMT must hold CIDs")
                if msg_cid not in seen:
                    seen.add(msg_cid)
                    exec_order.append(msg_cid)
    collector.collect_from_recording(tx_recorder)
    return exec_order


def scan_receipt_events(
    store: Blockstore, receipts_root: CID
) -> list[tuple[int, Receipt, list[StampedEvent]]]:
    """PASS 1 decode leg: enumerate (exec_index, receipt, events) without
    recording anything. Receipts without an events root are skipped."""
    scanned = []
    receipts_amt = AMT.load(store, receipts_root, expected_version=0)
    for i, receipt_cbor in receipts_amt.items():
        receipt = Receipt.from_cbor(receipt_cbor)
        if receipt.events_root is None:
            continue
        events_amt = AMT.load(store, receipt.events_root, expected_version=3)
        events = [StampedEvent.from_cbor(v) for _, v in events_amt.items()]
        scanned.append((i, receipt, events))
    return scanned


def scan_receipts_from_api(
    store: Blockstore, client, child: Tipset
) -> list[tuple[int, Receipt, list[StampedEvent]]]:
    """PASS 1 decode leg via the `Filecoin.ChainGetParentReceipts` JSON API:
    the receipt list arrives in execution order as JSON, so pass 1 never
    walks the receipts AMT. Events AMTs are still read from ``store``, and
    pass 2 still walks the receipts AMT (the witness must hold it)."""
    api_receipts = client.chain_get_parent_receipts(child.cids[0])
    if api_receipts is None:
        # null result = the node does not know the block; the AMT path
        # raises in the same situation, so no empty bundle is emitted
        raise KeyError(f"ChainGetParentReceipts returned null for {child.cids[0]}")
    scanned = []
    for i, obj in enumerate(api_receipts):
        receipt = receipt_from_api_json(obj)
        if receipt.events_root is None:
            continue
        events_amt = AMT.load(store, receipt.events_root, expected_version=3)
        events = [StampedEvent.from_cbor(v) for _, v in events_amt.items()]
        scanned.append((i, receipt, events))
    return scanned


def match_receipt_indices(
    scanned: list[tuple[int, Receipt, list[StampedEvent]]],
    matcher: EventMatcher,
    actor_id_filter: Optional[int],
) -> list[int]:
    """PASS 1 predicate leg without a backend: which receipt indices contain
    ≥1 matching event, short-circuiting per receipt. The reference the
    batched `mask_receipt_indices` is tested against."""
    matching = []
    for i, _, events in scanned:
        for stamped in events:
            if actor_id_filter is not None and stamped.emitter != actor_id_filter:
                continue
            log = extract_evm_log(stamped.event)
            if log is not None and matcher.matches_log(log):
                matching.append(i)
                break
    return matching


def mask_receipt_indices(
    scans: "list[list[tuple[int, Receipt, list[StampedEvent]]]]",
    matcher: EventMatcher,
    actor_id_filter: Optional[int],
    match_backend,
) -> "list[list[int]]":
    """PASS 1 predicate leg on a backend: every event of every scan (one
    scan per tipset pair) in ONE mask call; returns each scan's matching
    receipt indices."""
    flat: list[StampedEvent] = []
    owners: list[tuple[int, int]] = []  # (scan_pos, receipt_pos)
    for scan_pos, scanned in enumerate(scans):
        for receipt_pos, (_, _, events) in enumerate(scanned):
            flat.extend(events)
            owners.extend([(scan_pos, receipt_pos)] * len(events))
    mask = (
        match_backend.event_match_mask(flat, matcher.topic0, matcher.topic1, actor_id_filter)
        if flat
        else []
    )
    hits: dict[int, set[int]] = {}
    for k, hit in enumerate(mask):
        if hit:
            scan_pos, receipt_pos = owners[k]
            hits.setdefault(scan_pos, set()).add(receipt_pos)
    return [
        [scanned[r][0] for r in sorted(hits.get(p, ()))] for p, scanned in enumerate(scans)
    ]


def record_matching_receipts(
    store: Blockstore,
    parent: Tipset,
    child: Tipset,
    exec_order: list[CID],
    matching_indices: list[int],
    matcher: EventMatcher,
    actor_id_filter: Optional[int],
) -> tuple[list[EventProof], list[RecordingBlockstore]]:
    """PASS 2: touch only matching receipts under recording stores; emit
    claims for each matching event."""
    child_cid = child.cids[0]
    receipts_root = child.blocks[0].parent_message_receipts

    proofs: list[EventProof] = []
    recordings: list[RecordingBlockstore] = []

    receipts_recorder = RecordingBlockstore(store)
    receipts_amt = AMT.load(receipts_recorder, receipts_root, expected_version=0)

    for i in matching_indices:
        if i >= len(exec_order):
            raise KeyError(f"missing message at execution index {i}")
        msg_cid = exec_order[i]
        receipt_cbor = receipts_amt.get(i)  # records the receipt path
        if receipt_cbor is None:
            continue
        receipt = Receipt.from_cbor(receipt_cbor)
        if receipt.events_root is None:
            continue

        events_recorder = RecordingBlockstore(store)
        events_amt = AMT.load(events_recorder, receipt.events_root, expected_version=3)
        for j, stamped_cbor in events_amt.items():
            stamped = StampedEvent.from_cbor(stamped_cbor)
            if actor_id_filter is not None and stamped.emitter != actor_id_filter:
                continue
            log = extract_evm_log(stamped.event)
            if log is None or not matcher.matches_log(log):
                continue
            proofs.append(
                EventProof(
                    parent_epoch=parent.height,
                    child_epoch=child.height,
                    parent_tipset_cids=[str(c) for c in parent.cids],
                    child_block_cid=str(child_cid),
                    message_cid=str(msg_cid),
                    exec_index=i,
                    event_index=j,
                    event_data=EventData(
                        emitter=stamped.emitter,
                        topics=["0x" + t.hex() for t in log.topics],
                        data="0x" + log.data.hex(),
                    ),
                )
            )
        recordings.append(events_recorder)

    recordings.append(receipts_recorder)
    return proofs, recordings


def generate_event_proof(
    store: Blockstore,
    parent: Tipset,
    child: Tipset,
    event_signature: str,
    topic_1: str,
    actor_id_filter: Optional[int] = None,
    match_backend=None,
    receipts_client=None,
) -> EventProofBundle:
    """Generate proofs for every event matching (signature, topic_1,
    emitter) in one parent/child pair. Pass 1's predicate runs as one mask
    call on ``match_backend``, which defaults to ``get_backend("gpu")``, the
    card (raises without CUDA; pass ``get_backend("gpu", device="cpu")`` for
    the plain versions).

    ``receipts_client``: optional `LotusClient`; when given, pass 1
    enumerates receipts via `Filecoin.ChainGetParentReceipts` instead of
    walking the receipts AMT (`scan_receipts_from_api`)."""
    if match_backend is None:
        match_backend = get_backend("gpu")
    matcher = EventMatcher(event_signature, topic_1)
    receipts_root = child.blocks[0].parent_message_receipts

    collector = WitnessCollector(store)
    exec_order = collect_base_witness_and_exec_order(collector, store, parent, child)
    if receipts_client is not None:
        scanned = scan_receipts_from_api(store, receipts_client, child)
    else:
        scanned = scan_receipt_events(store, receipts_root)
    [matching_indices] = mask_receipt_indices([scanned], matcher, actor_id_filter, match_backend)
    proofs, recordings = record_matching_receipts(
        store, parent, child, exec_order, matching_indices, matcher, actor_id_filter
    )
    collector.collect_from_recordings(recordings)
    return EventProofBundle(proofs=proofs, blocks=collector.materialize())
