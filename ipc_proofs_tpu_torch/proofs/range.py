"""Multi-tipset range driver: batch proof generation over many epoch pairs.

- Phase A (host):   decode receipts + events for EVERY pair;
- Phase B (device): ONE batched predicate call over all events in the range
                    (``match_backend.event_match_mask``);
- Phase C (host):   per-pair pass-2 recording only for matching receipts;
- Phase D:          one merged, CID-deduplicated, CID-sorted witness.

Optional ``storage_specs`` (`MappingSlotSpec`s) are proved at every pair:
their slot digests hash ONCE range-wide on the backend's keccak kernel, then
`generate_storage_proofs_batch` runs per pair and its blocks merge into the
one witness.

The counterpart of ``ipc_proofs_tpu.proofs.range.generate_event_proofs_for_range``
on its pure-Python branches (Python scan, scalar record, per-pair storage
batches, pure witness materialization) with the mask and the slot hashing
always on the backend.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

from ipc_proofs_tpu_torch.backend import get_backend
from ipc_proofs_tpu_torch.proofs.bundle import ProofBlock, UnifiedProofBundle
from ipc_proofs_tpu_torch.proofs.chain import Tipset
from ipc_proofs_tpu_torch.proofs.event_generator import (
    EventMatcher,
    collect_base_witness_and_exec_order,
    mask_receipt_indices,
    record_matching_receipts,
    scan_receipt_events,
)
from ipc_proofs_tpu_torch.proofs.generator import EventProofSpec
from ipc_proofs_tpu_torch.proofs.storage_batch import (
    MappingSlotSpec,
    generate_storage_proofs_batch,
    hash_slot_specs,
)
from ipc_proofs_tpu_torch.proofs.witness import WitnessCollector
from ipc_proofs_tpu_torch.store.blockstore import Blockstore, CachedBlockstore
from ipc_proofs_tpu_torch.utils.metrics import Metrics

__all__ = ["TipsetPair", "generate_event_proofs_for_range"]


@dataclass
class TipsetPair:
    parent: Tipset
    child: Tipset


def generate_event_proofs_for_range(
    store: Blockstore,
    pairs: Sequence[TipsetPair],
    spec: EventProofSpec,
    match_backend=None,
    metrics: Optional[Metrics] = None,
    storage_specs: "Optional[Sequence[MappingSlotSpec]]" = None,
) -> UnifiedProofBundle:
    """Generate event proofs for ``spec`` across a whole range of tipset
    pairs, with one device mask call for the entire range, plus the
    ``storage_specs`` grid proved at every pair (e.g. a subnet's nonce slot
    tracked across the range). ``match_backend`` runs the mask and the slot
    keccaks; it defaults to ``get_backend("gpu")``, the card (raises without
    CUDA); pass ``get_backend("gpu", device="cpu")`` for the plain versions."""
    if match_backend is None:
        match_backend = get_backend("gpu")
    metrics = metrics if metrics is not None else Metrics()
    matcher = EventMatcher(spec.event_signature, spec.topic_1)
    cached = CachedBlockstore(store)
    matching_per_pair = _scan_and_match(cached, pairs, spec, matcher, match_backend, metrics)
    with metrics.stage("range_record"):
        event_proofs, blocks = _record_chunk(cached, pairs, matching_per_pair, matcher, spec)
    metrics.count("range_proofs", len(event_proofs))
    storage_proofs: list = []
    if storage_specs:
        with metrics.stage("range_storage"):
            storage_proofs, storage_blocks = _storage_for_pairs(
                cached, pairs, storage_specs, match_backend
            )
        metrics.count("range_storage_proofs", len(storage_proofs))
        blocks |= storage_blocks
    return UnifiedProofBundle(
        storage_proofs=storage_proofs,
        event_proofs=event_proofs,
        blocks=sorted(blocks, key=lambda b: b.cid.to_bytes()),
    )


def _storage_for_pairs(
    cached: Blockstore,
    pairs: Sequence[TipsetPair],
    storage_specs: Sequence[MappingSlotSpec],
    hash_backend,
) -> "tuple[list, set[ProofBlock]]":
    """Prove every storage spec at every pair, claims in (pair, spec) order:
    slot digests hash once for the whole range, then one storage batch per
    pair. Returns ``(proofs, witness_blocks)``."""
    slots = hash_slot_specs(storage_specs, hash_backend)
    proofs = []
    blocks: set[ProofBlock] = set()
    for pair in pairs:
        bundle = generate_storage_proofs_batch(
            cached, pair.parent, pair.child, storage_specs, precomputed_slots=slots
        )
        proofs.extend(bundle.storage_proofs)
        blocks.update(bundle.blocks)
    return proofs, blocks


def _scan_and_match(
    cached: Blockstore,
    pairs: Sequence[TipsetPair],
    spec: EventProofSpec,
    matcher: EventMatcher,
    match_backend,
    metrics: Metrics,
) -> "list[list[int]]":
    """Phases A+B: scan every pair's receipts/events, run the match
    predicate, return the matching receipt indices per pair."""
    with metrics.stage("range_scan"):
        scans = [
            scan_receipt_events(cached, pair.child.blocks[0].parent_message_receipts)
            for pair in pairs
        ]

    with metrics.stage("range_match"):
        metrics.count(
            "range_events", sum(len(events) for scanned in scans for _, _, events in scanned)
        )
        return mask_receipt_indices(scans, matcher, spec.actor_id_filter, match_backend)


def _record_chunk(
    cached: Blockstore,
    pairs: Sequence[TipsetPair],
    matching_per_pair: "list[list[int]]",
    matcher: EventMatcher,
    spec: EventProofSpec,
) -> "tuple[list, set[ProofBlock]]":
    """Phase C: pass 2. Pairs with no matching receipts contribute no
    proofs, so their base witness (headers, TxMeta walks) is skipped: a
    range bundle's witness only needs to cover the proofs it carries.
    Returns ``(event_proofs, witness_blocks)``; the blocks of adjacent pairs
    overlap and dedup in the set."""
    event_proofs = []
    all_blocks: set[ProofBlock] = set()
    for pair, matching in zip(pairs, matching_per_pair):
        if not matching:
            continue
        collector = WitnessCollector(cached)
        # one set of TxMeta walks yields both the recorded base
        # witness and the execution order (they touch the same blocks)
        exec_order = collect_base_witness_and_exec_order(
            collector, cached, pair.parent, pair.child
        )
        proofs, recordings = record_matching_receipts(
            cached,
            pair.parent,
            pair.child,
            exec_order,
            matching,
            matcher,
            spec.actor_id_filter,
        )
        collector.collect_from_recordings(recordings)
        event_proofs.extend(proofs)
        all_blocks.update(collector.materialize())
    return event_proofs, all_blocks
