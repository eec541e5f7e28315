"""Unified proof generation over shared-cache blockstores.

`generate_proof_bundle`: N storage specs + M event specs for one
parent/child pair over one shared block cache; witness blocks deduplicated
across all proofs and CID-sorted. The counterpart of
``ipc_proofs_tpu.proofs.generator`` without its ``receipts_client`` (RPC)
pathway.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ipc_proofs_tpu_torch.proofs.bundle import ProofBlock, UnifiedProofBundle
from ipc_proofs_tpu_torch.proofs.chain import Tipset
from ipc_proofs_tpu_torch.proofs.event_generator import generate_event_proof
from ipc_proofs_tpu_torch.proofs.storage_generator import generate_storage_proof
from ipc_proofs_tpu_torch.store.blockstore import Blockstore, CachedBlockstore

__all__ = ["StorageProofSpec", "EventProofSpec", "generate_proof_bundle"]


@dataclass
class StorageProofSpec:
    """(actor, slot) to prove."""

    actor_id: int
    slot: bytes  # 32-byte slot preimage digest


@dataclass
class EventProofSpec:
    """(signature, topic1, emitter filter) to prove."""

    event_signature: str
    topic_1: str
    actor_id_filter: Optional[int] = None


def generate_proof_bundle(
    store: Blockstore,
    parent: Tipset,
    child: Tipset,
    storage_specs: "list[StorageProofSpec]",
    event_specs: "list[EventProofSpec]",
    match_backend=None,
) -> UnifiedProofBundle:
    """Generate all requested proofs; witness deduplicated across proofs.

    Every generator reads through its own `CachedBlockstore` view of one
    shared cache. ``match_backend`` (the event predicate's mask) defaults to
    the card, as in `generate_event_proof`."""
    shared = CachedBlockstore(store).shared_cache()

    storage_proofs = []
    event_proofs = []
    all_blocks: set[ProofBlock] = set()

    for storage_spec in storage_specs:
        view = CachedBlockstore.with_shared_cache(store, shared)
        proof, blocks = generate_storage_proof(
            view, parent, child, storage_spec.actor_id, storage_spec.slot
        )
        storage_proofs.append(proof)
        all_blocks.update(blocks)

    for event_spec in event_specs:
        view = CachedBlockstore.with_shared_cache(store, shared)
        bundle = generate_event_proof(
            view,
            parent,
            child,
            event_spec.event_signature,
            event_spec.topic_1,
            event_spec.actor_id_filter,
            match_backend=match_backend,
        )
        event_proofs.extend(bundle.proofs)
        all_blocks.update(bundle.blocks)

    return UnifiedProofBundle(
        storage_proofs=storage_proofs,
        event_proofs=event_proofs,
        blocks=sorted(all_blocks, key=lambda b: b.cid.to_bytes()),
    )
