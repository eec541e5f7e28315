"""Storage proof generation: 6 steps, every touched block recorded.

1. extract the parent state root from the child header's raw CBOR and
   cross-check it against the tipset view;
2. seed the witness with the child header + state root CIDs;
3. walk state tree → actor → EVM state under a recording store;
4. read the storage slot (missing ⇒ zero) under a recording store;
5. materialize the witness;
6. emit the claim.

The counterpart of ``ipc_proofs_tpu.proofs.storage_generator``.
"""

from __future__ import annotations

from ipc_proofs_tpu_torch.proofs.bundle import ProofBlock, StorageProof
from ipc_proofs_tpu_torch.proofs.chain import Tipset
from ipc_proofs_tpu_torch.proofs.witness import WitnessCollector
from ipc_proofs_tpu_torch.state.actors import get_actor_state, parse_evm_state
from ipc_proofs_tpu_torch.state.address import Address
from ipc_proofs_tpu_torch.state.events import left_pad_32
from ipc_proofs_tpu_torch.state.header import extract_parent_state_root
from ipc_proofs_tpu_torch.state.storage import read_storage_slot
from ipc_proofs_tpu_torch.store.blockstore import Blockstore, RecordingBlockstore

__all__ = ["generate_storage_proof"]


def generate_storage_proof(
    store: Blockstore,
    parent: Tipset,
    child: Tipset,
    actor_id: int,
    slot: bytes,
) -> tuple[StorageProof, list[ProofBlock]]:
    """Generate one storage-slot proof plus its witness blocks."""
    if len(slot) != 32:
        raise ValueError("storage slot must be 32 bytes")

    # Step 1: parent state root from the child header CBOR, cross-checked
    # against the tipset's own view.
    child_cid = child.cids[0]
    header_recorder = RecordingBlockstore(store)
    child_header_raw = header_recorder.get(child_cid)
    if child_header_raw is None:
        raise KeyError(f"missing child header {child_cid}")
    parent_state_root = extract_parent_state_root(child_header_raw)
    if parent_state_root != child.blocks[0].parent_state_root:
        raise ValueError(
            f"ParentStateRoot mismatch: header {parent_state_root} "
            f"vs tipset {child.blocks[0].parent_state_root}"
        )

    # Step 2: seed witness.
    collector = WitnessCollector(store)
    collector.add_cid(child_cid)
    collector.add_cid(parent_state_root)
    collector.collect_from_recording(header_recorder)

    # Step 3: state tree walk under recording.
    state_recorder = RecordingBlockstore(store)
    actor = get_actor_state(state_recorder, parent_state_root, Address.new_id(actor_id))
    actor_state_cid = actor.state
    evm_state_raw = state_recorder.get(actor_state_cid)
    if evm_state_raw is None:
        raise KeyError(f"missing EVM state {actor_state_cid}")
    storage_root = parse_evm_state(evm_state_raw).contract_state
    collector.add_cid(actor_state_cid)
    collector.add_cid(storage_root)
    collector.collect_from_recording(state_recorder)

    # Step 4: storage slot read under recording (missing key ⇒ zero).
    storage_recorder = RecordingBlockstore(store)
    raw_value = read_storage_slot(storage_recorder, storage_root, slot) or b""
    collector.collect_from_recording(storage_recorder)

    # Steps 5-6: materialize the witness, emit the claim.
    blocks = collector.materialize()
    proof = StorageProof(
        child_epoch=child.height,
        child_block_cid=str(child_cid),
        parent_state_root=str(parent_state_root),
        actor_id=actor_id,
        actor_state_cid=str(actor_state_cid),
        storage_root=str(storage_root),
        slot="0x" + slot.hex(),
        value="0x" + left_pad_32(raw_value).hex(),
    )
    return proof, blocks
