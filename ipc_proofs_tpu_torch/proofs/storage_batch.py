"""Batch storage-proof driver: many (contract × slot) claims in one bundle.

- mapping-slot preimages for ALL slots hash in one `keccak256_batch` call
  on the backend (the card) instead of one scalar keccak per spec;
- the child-header extraction and each contract's state-tree walk happen
  ONCE per contract, not once per slot;
- per-slot storage-HAMT walks record independently (host pointer-chasing);
- the witness is deduplicated across the whole grid — slots of the same
  contract share almost their entire path.

The counterpart of ``ipc_proofs_tpu.proofs.storage_batch`` (`MappingSlotSpec`,
`hash_slot_specs`, `generate_storage_proofs_batch`); its range-batched
``generate_storage_proofs_for_pairs`` needs the native HAMT walker and is
not ported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

from ipc_proofs_tpu_torch.backend import get_backend
from ipc_proofs_tpu_torch.proofs.bundle import StorageProof, UnifiedProofBundle
from ipc_proofs_tpu_torch.proofs.chain import Tipset
from ipc_proofs_tpu_torch.proofs.witness import WitnessCollector
from ipc_proofs_tpu_torch.state.actors import get_actor_state, parse_evm_state
from ipc_proofs_tpu_torch.state.address import Address
from ipc_proofs_tpu_torch.state.events import ascii_to_bytes32, left_pad_32
from ipc_proofs_tpu_torch.state.header import extract_parent_state_root
from ipc_proofs_tpu_torch.state.storage import read_storage_slot
from ipc_proofs_tpu_torch.store.blockstore import Blockstore, CachedBlockstore, RecordingBlockstore
from ipc_proofs_tpu_torch.utils.metrics import Metrics

__all__ = ["MappingSlotSpec", "generate_storage_proofs_batch", "hash_slot_specs"]


@dataclass
class MappingSlotSpec:
    """A Solidity mapping slot to prove: keccak(key32 ‖ be32(slot_index))."""

    actor_id: int
    key: "bytes | str"  # 32-byte mapping key, or an ASCII subnet id
    slot_index: int = 0

    def key32(self) -> bytes:
        if isinstance(self.key, str):
            return ascii_to_bytes32(self.key)
        if len(self.key) != 32:
            raise ValueError("mapping key must be 32 bytes")
        return self.key


def hash_slot_specs(specs: Sequence[MappingSlotSpec], hash_backend=None) -> "list[bytes]":
    """Every spec's storage-slot digest from one `keccak256_batch` call on
    ``hash_backend``, which defaults to ``get_backend("gpu")``, the card
    (raises without CUDA; pass ``get_backend("gpu", device="cpu")`` for the
    plain versions). Range drivers hash once and reuse the digests across
    every pair."""
    if hash_backend is None:
        hash_backend = get_backend("gpu")
    preimages = [s.key32() + s.slot_index.to_bytes(32, "big") for s in specs]
    return hash_backend.keccak256_batch(preimages)


def generate_storage_proofs_batch(
    store: Blockstore,
    parent: Tipset,
    child: Tipset,
    specs: Sequence[MappingSlotSpec],
    hash_backend=None,
    metrics: Optional[Metrics] = None,
    precomputed_slots: "Optional[Sequence[bytes]]" = None,
) -> UnifiedProofBundle:
    """Generate storage proofs for a grid of mapping slots.

    All slot preimages hash in one batch call on ``hash_backend`` (default
    the card, as `hash_slot_specs`). ``precomputed_slots`` skips the hashing
    phase entirely (range drivers hash the grid once for all pairs)."""
    metrics = metrics if metrics is not None else Metrics()
    cached = CachedBlockstore(store)

    # Phase 1: derive all slot digests in one batch.
    with metrics.stage("slot_hash"):
        if precomputed_slots is not None:
            if len(precomputed_slots) != len(specs):
                raise ValueError("precomputed_slots length must match specs")
            slots = list(precomputed_slots)
        else:
            slots = hash_slot_specs(specs, hash_backend)
    metrics.count("batch_slots", len(slots))

    # Phase 2: child header extraction + cross-check (once for the batch).
    child_cid = child.cids[0]
    header_recorder = RecordingBlockstore(cached)
    child_header_raw = header_recorder.get(child_cid)
    if child_header_raw is None:
        raise KeyError(f"missing child header {child_cid}")
    parent_state_root = extract_parent_state_root(child_header_raw)
    if parent_state_root != child.blocks[0].parent_state_root:
        raise ValueError("ParentStateRoot mismatch between header CBOR and tipset view")

    collector = WitnessCollector(cached)
    collector.add_cid(child_cid)
    collector.add_cid(parent_state_root)
    collector.collect_from_recording(header_recorder)

    # Phase 3: one state-tree walk per distinct contract.
    with metrics.stage("actor_walks"):
        contract_info: dict[int, tuple] = {}
        for actor_id in sorted({s.actor_id for s in specs}):
            recorder = RecordingBlockstore(cached)
            actor = get_actor_state(recorder, parent_state_root, Address.new_id(actor_id))
            evm_state_raw = recorder.get(actor.state)
            if evm_state_raw is None:
                raise KeyError(f"missing EVM state {actor.state}")
            storage_root = parse_evm_state(evm_state_raw).contract_state
            collector.add_cid(actor.state)
            collector.add_cid(storage_root)
            collector.collect_from_recording(recorder)
            contract_info[actor_id] = (actor.state, storage_root)
    metrics.count("batch_contracts", len(contract_info))

    # Phase 4: per-slot storage reads under recording (host pointer-chasing).
    proofs: list[StorageProof] = []
    with metrics.stage("slot_reads"):
        for spec, slot in zip(specs, slots):
            actor_state_cid, storage_root = contract_info[spec.actor_id]
            recorder = RecordingBlockstore(cached)
            raw_value = read_storage_slot(recorder, storage_root, slot) or b""
            collector.collect_from_recording(recorder)
            proofs.append(
                StorageProof(
                    child_epoch=child.height,
                    child_block_cid=str(child_cid),
                    parent_state_root=str(parent_state_root),
                    actor_id=spec.actor_id,
                    actor_state_cid=str(actor_state_cid),
                    storage_root=str(storage_root),
                    slot="0x" + slot.hex(),
                    value="0x" + left_pad_32(raw_value).hex(),
                )
            )

    with metrics.stage("materialize"):
        blocks = collector.materialize()
    return UnifiedProofBundle(storage_proofs=proofs, event_proofs=[], blocks=blocks)
