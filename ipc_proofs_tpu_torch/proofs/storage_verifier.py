"""Storage proof verification: fully offline 6-step replay.

Load witness → trust anchor → parent-state-root check → actor-state check →
storage-root check → re-read the slot and compare (hex, case-insensitive).
Returns False on any mismatch; raises only on malformed inputs.

`verify_storage_proofs_batch` is the range-scale formulation: proofs
sharing a child header decode it once, unique (state root, actor) pairs
resolve through ONE batched C HAMT walk, and EVM states parse once each —
verdicts identical to the scalar loop, per-proof raise behavior preserved.
The slot re-read (step 6) stays scalar per proof.

The counterpart of ``ipc_proofs_tpu.proofs.storage_verifier``, without the
scalar verifier's host-hash ``verify_witness_cids`` flag (the recompute
runs on the card in `verify_proof_bundle`).
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

from ipc_proofs_tpu_torch.core.cid import CID, cids_from_strings
from ipc_proofs_tpu_torch.ipld.hamt import HAMT_BIT_WIDTH, hamt_get_batch
from ipc_proofs_tpu_torch.proofs.bundle import ProofBlock, StorageProof
from ipc_proofs_tpu_torch.proofs.witness import load_witness_store
from ipc_proofs_tpu_torch.state.actors import (
    ActorState,
    StateRoot,
    get_actor_state,
    parse_evm_state,
)
from ipc_proofs_tpu_torch.state.address import Address
from ipc_proofs_tpu_torch.state.events import left_pad_32
from ipc_proofs_tpu_torch.state.header import decode_header_lite, extract_parent_state_root
from ipc_proofs_tpu_torch.state.storage import read_storage_slot
from ipc_proofs_tpu_torch.store.blockstore import MemoryBlockstore

__all__ = ["verify_storage_proof", "verify_storage_proofs_batch"]


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
    """Step 6, shared by the scalar and batch paths: re-read the slot from
    the witness (the full five-encoding cascade) and compare values."""
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


def verify_storage_proofs_batch(
    store,
    proofs: "list[StorageProof]",
    is_trusted_child_header: Callable[[int, CID], bool],
) -> "Optional[list[bool]]":
    """Verify many storage proofs against ONE pre-loaded witness store,
    batching the shared work. Verdicts are identical to looping
    `verify_storage_proof`, and each proof raises exactly where its scalar
    verification would (enforced by tests/test_storage_batch_verifier) —
    though with several independently faulty proofs in one bundle, the
    phase ordering can surface a different faulty proof's exception first
    than the scalar loop's strict proof order would (both always raise):

    - child headers decode once per CID (steps 2-3);
    - unique (parent state root, actor id) pairs resolve through one
      batched C HAMT walk over the actors tree (step 4) — tolerant mode,
      so a proof whose path is missing is False, like the scalar caught
      KeyError;
    - EVM actor states parse once per CID (step 5);
    - the slot re-read (step 6) runs the scalar per-proof cascade.

    Returns None in the pure-Python universe (callers run the scalar
    loop).
    """
    if hamt_get_batch(store, [], [], []) is None:
        return None
    results = [False] * len(proofs)

    # Steps 2-3 per proof: trust anchor, then child-header consistency.
    # Headers decode once per CID; the claimed parent_state_root is a
    # string compare against the decoded root's canonical string.
    child_cids = cids_from_strings([p.child_block_cid for p in proofs])
    root_str_cache: dict[CID, str] = {}
    survivors: list[int] = []  # indices past steps 2-3
    for k, proof in enumerate(proofs):
        child_cid = child_cids[k]
        if not is_trusted_child_header(proof.child_epoch, child_cid):
            continue
        root_str = root_str_cache.get(child_cid)
        if root_str is None:
            raw = store.get(child_cid)
            if raw is None:
                raise KeyError(f"missing child header {child_cid} in witness")
            root_str = str(decode_header_lite(raw).parent_state_root)
            root_str_cache[child_cid] = root_str
        if root_str != proof.parent_state_root:
            continue
        survivors.append(k)
    if not survivors:
        return results

    # Step 4, batched: unique (state root, actor id) → ActorState via one
    # C HAMT walk over the actors tree. A missing StateRoot block is the
    # scalar caught-KeyError → False; a malformed StateRoot raises.
    pair_index: dict[tuple[str, int], int] = {}
    pair_order: list[tuple[str, int]] = []
    for k in survivors:
        key = (proofs[k].parent_state_root, proofs[k].actor_id)
        if key not in pair_index:
            pair_index[key] = len(pair_order)
            pair_order.append(key)
    root_strs = sorted({r for r, _ in pair_order})
    root_cids = dict(zip(root_strs, cids_from_strings(root_strs)))
    actors_roots: dict[str, Optional[CID]] = {}
    for root_str in root_strs:
        raw = store.get(root_cids[root_str])
        # missing StateRoot → every dependent proof False (scalar parity)
        actors_roots[root_str] = (
            StateRoot.decode(raw).actors if raw is not None else None
        )
    walk_roots: list[CID] = []
    walk_root_pos: dict[str, int] = {}
    owners: list[int] = []
    keys: list[bytes] = []
    live_pairs: list[int] = []  # positions in pair_order that reach the walk
    for pos, (root_str, actor_id) in enumerate(pair_order):
        # address builds FIRST — the scalar step 4 evaluates
        # Address.new_id(actor_id) as an argument before get_actor_state
        # can hit (and catch) a missing StateRoot, so an invalid actor id
        # must raise here even when the pair's walk would be skipped
        key = Address.new_id(actor_id).to_bytes()
        actors_root = actors_roots[root_str]
        if actors_root is None:
            continue
        rpos = walk_root_pos.setdefault(root_str, len(walk_roots))
        if rpos == len(walk_roots):
            walk_roots.append(actors_root)
        owners.append(rpos)
        keys.append(key)
        live_pairs.append(pos)
    # tolerant mode: a missing actors-tree node makes the dependent proofs
    # False (the scalar path's caught KeyError), never aborts the batch.
    # validate_blocks: witness bytes are adversarial here — any fetched
    # node must be a fully well-formed DAG-CBOR item, as the scalar
    # reader's cbor_decode of the same node establishes.
    values = hamt_get_batch(
        store, walk_roots, owners, keys, bit_width=HAMT_BIT_WIDTH,
        skip_missing=True, validate_blocks=True,
    )
    assert values is not None  # availability probed above
    pair_actor: list[Optional[ActorState]] = [None] * len(pair_order)
    for pos, value in zip(live_pairs, values):
        if value is not None:
            # malformed ActorState raises, like the scalar from_tuple
            pair_actor[pos] = ActorState.from_tuple(value)

    # Steps 5-6 per surviving proof, with EVM states parsed once per CID.
    evm_cache: dict[str, "object"] = {}
    storage_root_cache: dict[str, CID] = {}
    for k in survivors:
        proof = proofs[k]
        actor = pair_actor[pair_index[(proof.parent_state_root, proof.actor_id)]]
        if actor is None or str(actor.state) != proof.actor_state_cid:
            continue
        evm_state = evm_cache.get(proof.actor_state_cid)
        if evm_state is None:
            actor_state_cid = CID.from_string(proof.actor_state_cid)
            evm_state_raw = store.get(actor_state_cid)
            if evm_state_raw is None:
                raise KeyError(f"missing EVM state {actor_state_cid} in witness")
            evm_state = parse_evm_state(evm_state_raw)
            evm_cache[proof.actor_state_cid] = evm_state
        if str(evm_state.contract_state) != proof.storage_root:
            continue
        storage_root = storage_root_cache.get(proof.storage_root)
        if storage_root is None:
            storage_root = CID.from_string(proof.storage_root)
            storage_root_cache[proof.storage_root] = storage_root
        results[k] = _verify_slot_value(store, storage_root, proof)
    return results
