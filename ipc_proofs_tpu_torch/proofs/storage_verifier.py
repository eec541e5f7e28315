"""Storage proof verification: fully offline 6-step replay.

Load witness → trust anchor → parent-state-root check → actor-state check →
storage-root check → re-read the slot and compare (hex, case-insensitive).
Returns False on any mismatch; raises only on malformed inputs.

The counterpart of ``ipc_proofs_tpu.proofs.storage_verifier``'s scalar
`verify_storage_proof`, without its host-hash ``verify_witness_cids`` flag
(the recompute runs on the card in `verify_proof_bundle`); its
``verify_storage_proofs_batch`` needs the native HAMT walker and is not
ported.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

from ipc_proofs_tpu_torch.core.cid import CID
from ipc_proofs_tpu_torch.proofs.bundle import ProofBlock, StorageProof
from ipc_proofs_tpu_torch.proofs.witness import load_witness_store
from ipc_proofs_tpu_torch.state.actors import get_actor_state, parse_evm_state
from ipc_proofs_tpu_torch.state.address import Address
from ipc_proofs_tpu_torch.state.events import left_pad_32
from ipc_proofs_tpu_torch.state.header import extract_parent_state_root
from ipc_proofs_tpu_torch.state.storage import read_storage_slot
from ipc_proofs_tpu_torch.store.blockstore import MemoryBlockstore

__all__ = ["verify_storage_proof"]


def verify_storage_proof(
    proof: StorageProof,
    blocks: Iterable[ProofBlock],
    is_trusted_child_header: Callable[[int, CID], bool],
    store: Optional[MemoryBlockstore] = None,
) -> bool:
    """Replay one storage proof against its witness. A caller verifying many
    proofs of one bundle passes a pre-loaded ``store`` so the witness loads
    once. The witness CID recompute is ``verify_proof_bundle(...,
    verify_witness_cids=True)``, on the card."""
    # Step 1: isolated witness store.
    if store is None:
        store = load_witness_store(blocks)

    # Step 2: trust anchor on (child_epoch, child CID).
    child_cid = CID.from_string(proof.child_block_cid)
    if not is_trusted_child_header(proof.child_epoch, child_cid):
        return False

    # Step 3: parent state root matches the child header in the witness.
    child_header_raw = store.get(child_cid)
    if child_header_raw is None:
        raise KeyError(f"missing child header {child_cid} in witness")
    if str(extract_parent_state_root(child_header_raw)) != proof.parent_state_root:
        return False

    # Step 4: actor state CID matches the state-tree lookup.
    parent_state_root = CID.from_string(proof.parent_state_root)
    try:
        actor = get_actor_state(store, parent_state_root, Address.new_id(proof.actor_id))
    except KeyError:
        return False
    if str(actor.state) != proof.actor_state_cid:
        return False

    # Step 5: storage root matches the EVM state.
    actor_state_cid = CID.from_string(proof.actor_state_cid)
    evm_state_raw = store.get(actor_state_cid)
    if evm_state_raw is None:
        raise KeyError(f"missing EVM state {actor_state_cid} in witness")
    if str(parse_evm_state(evm_state_raw).contract_state) != proof.storage_root:
        return False

    # Step 6: re-read the slot from the witness and compare values.
    return _verify_slot_value(store, CID.from_string(proof.storage_root), proof)


def _verify_slot_value(store, storage_root: CID, proof: StorageProof) -> bool:
    """Step 6: re-read the slot from the witness (the full five-encoding
    cascade) and compare values."""
    slot_hex = proof.slot.removeprefix("0x")
    if len(slot_hex) != 64:
        raise ValueError("slot must be 32 bytes of hex")
    slot = bytes.fromhex(slot_hex)
    try:
        raw_value = read_storage_slot(store, storage_root, slot) or b""
    except KeyError:
        return False
    actual = "0x" + left_pad_32(raw_value).hex()
    return actual.lower() == proof.value.lower()
