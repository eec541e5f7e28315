"""Storage proof verification: fully offline 6-step replay.

Load witness → trust anchor → parent-state-root check → actor-state check →
storage-root check → re-read the slot and compare (hex, case-insensitive).
Returns False on any mismatch; raises only on malformed inputs.

`verify_storage_proofs_batch` is the range-scale formulation: proofs
sharing a child header decode it once, unique (state root, actor) pairs
resolve through ONE batched C HAMT walk, EVM states parse once each, and
the slot re-reads (step 6) classify each storage root once and walk the
HAMT-encoded ones in one C call per bit width — verdicts identical to the
scalar loop, per-proof raise behavior preserved. `SLOT_READS` counts the
slot re-reads by the route they took.

The counterpart of ``ipc_proofs_tpu.proofs.storage_verifier``, without the
scalar verifier's host-hash ``verify_witness_cids`` flag (the recompute
runs on the card in `verify_proof_bundle`).
"""

from __future__ import annotations

import threading
from typing import Callable, Iterable, Optional

from ipc_proofs_tpu_torch.core.cid import CID, cids_from_strings
from ipc_proofs_tpu_torch.core.dagcbor import decode as cbor_decode
from ipc_proofs_tpu_torch.ipld.hamt import HAMT_BIT_WIDTH, hamt_get_batch
from ipc_proofs_tpu_torch.obs.trace import current_context
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
from ipc_proofs_tpu_torch.state.storage import read_storage_slot, slot_read_route
from ipc_proofs_tpu_torch.store.blockstore import MemoryBlockstore

__all__ = ["SLOT_READS", "verify_storage_proof", "verify_storage_proofs_batch"]

# route -> slot re-reads of `verify_storage_proofs_batch` in this process:
# "walk" resolved by the batched C walk, "map" against a SmallMap root on
# the host, "scalar" through the per-proof cascade (odd bit widths and the
# keys the walk did not find)
SLOT_READS = {"walk": 0, "map": 0, "scalar": 0}
_reads_lock = threading.Lock()  # guards SLOT_READS


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


def _slot_key(proof: StorageProof) -> bytes:
    """The proof's 32-byte slot key; malformed hex raises ValueError."""
    slot_hex = proof.slot.removeprefix("0x")
    if len(slot_hex) != 64:
        raise ValueError("slot must be 32 bytes of hex")
    slot = bytes.fromhex(slot_hex)
    if len(slot) != 32:  # fromhex skips whitespace
        raise ValueError("slot key must be 32 bytes")
    return slot


def _slot_matches(raw_value: Optional[bytes], proof: StorageProof) -> bool:
    actual = "0x" + left_pad_32(raw_value or b"").hex()
    return actual.lower() == proof.value.lower()


def _verify_slot_value(store, storage_root: CID, proof: StorageProof) -> bool:
    """Step 6 of one proof: re-read the slot from the witness (the full
    five-encoding cascade) and compare values."""
    slot = _slot_key(proof)
    try:
        raw_value = read_storage_slot(store, storage_root, slot)
    except KeyError:
        return False
    return _slot_matches(raw_value, proof)


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
    - the slot re-reads (step 6): each storage root decodes and classifies
      once; SmallMap roots resolve on the host, HAMT roots of bit width 1-8
      walk in one tolerant, validating C call per bit width; odd bit widths,
      and every key the walk did not find (absent, which reads as zero, or
      under a node missing from the witness, which is False: only the
      scalar cascade tells them apart), run the scalar per-proof cascade.

    Adds the step-6 routes to `SLOT_READS`, and sets them as attributes
    ``slot_walk``, ``slot_map``, ``slot_scalar`` on the innermost open span
    (``verify.storage`` under `verify_proof_bundle`). Returns None in the
    pure-Python universe (callers run the scalar loop).
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

    # Step 5 per surviving proof, with EVM states parsed once per CID; the
    # proofs that pass it go on to step 6 with their slot keys.
    evm_cache: dict[str, "object"] = {}
    reads: list[tuple[int, CID, bytes]] = []  # (proof index, storage root, slot)
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
        reads.append((k, evm_state.contract_state, _slot_key(proof)))
    counts = _read_slots(store, proofs, reads, results)
    with _reads_lock:
        for route, n in counts.items():
            SLOT_READS[route] += n
    ctx = current_context()
    if ctx is not None and ctx.span is not None:
        for route, n in counts.items():
            ctx.span.set_attr(f"slot_{route}", n)
    return results


def _read_slots(store, proofs, reads, results) -> "dict[str, int]":
    """Step 6, batched: settle ``results[k]`` for every (k, storage root,
    slot) of ``reads``; returns the reads by route. Each storage root
    decodes once and takes its `slot_read_route`: a missing root block is
    False (the scalar's caught KeyError), a malformed one raises."""
    counts = dict.fromkeys(SLOT_READS, 0)
    routes: dict[CID, tuple] = {}
    walks: dict[int, tuple[list, dict, list, list, list]] = {}  # by bit width
    for k, root, slot in reads:
        route = routes.get(root)
        if route is None:
            raw = store.get(root)
            route = ("missing",) if raw is None else slot_read_route(root, cbor_decode(raw))
            routes[root] = route
        if route[0] == "map":
            counts["map"] += 1
            results[k] = _slot_matches(route[1].get(slot), proofs[k])
        elif route[0] == "walk":
            _, walk_root, bw = route
            w_roots, w_pos, w_owners, w_keys, w_items = walks.setdefault(
                bw, ([], {}, [], [], [])
            )
            pos = w_pos.setdefault(walk_root, len(w_roots))
            if pos == len(w_roots):
                w_roots.append(walk_root)
            w_owners.append(pos)
            w_keys.append(slot)
            w_items.append((k, root))
        elif route[0] == "scalar":
            counts["scalar"] += 1
            results[k] = _verify_slot_value(store, root, proofs[k])
        # "missing": the proof stays False
    for bw, (w_roots, _, w_owners, w_keys, w_items) in sorted(walks.items()):
        # tolerant: a missing node reads as not found, and a not-found key
        # goes to the scalar cascade, which alone tells an absent key (zero)
        # from a missing witness node (False). validate_blocks: witness
        # bytes are adversarial, and a fetched node must fail as the
        # scalar's full decode of it does.
        values = hamt_get_batch(
            store, w_roots, w_owners, w_keys, bit_width=bw,
            skip_missing=True, validate_blocks=True,
        )
        for (k, root), value in zip(w_items, values):
            if value is None:
                counts["scalar"] += 1
                results[k] = _verify_slot_value(store, root, proofs[k])
                continue
            if not isinstance(value, bytes):
                raise ValueError("storage slot value must be bytes")
            counts["walk"] += 1
            results[k] = _slot_matches(value, proofs[k])
    return counts
