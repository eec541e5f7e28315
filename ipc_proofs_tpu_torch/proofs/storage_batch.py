"""Batch storage-proof driver: many (contract × slot) claims in one bundle.

- mapping-slot preimages for ALL slots hash in one `keccak256_batch` call
  on the backend (the card) instead of one scalar keccak per spec;
- the child-header extraction and each contract's state-tree walk happen
  ONCE per contract, not once per slot;
- per-slot storage-HAMT walks record independently (host pointer-chasing);
- the witness is deduplicated across the whole grid — slots of the same
  contract share almost their entire path.

The counterpart of ``ipc_proofs_tpu.proofs.storage_batch``:
`MappingSlotSpec`, `hash_slot_specs`, the scalar-walk
`generate_storage_proofs_batch` and the range-batched
`generate_storage_proofs_for_pairs` over the native HAMT walker.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

from ipc_proofs_tpu_torch.backend import get_backend
from ipc_proofs_tpu_torch.core.cid import CID
from ipc_proofs_tpu_torch.core.dagcbor import decode as cbor_decode
from ipc_proofs_tpu_torch.ipld.hamt import hamt_get_batch_touched
from ipc_proofs_tpu_torch.obs.trace import phase_span
from ipc_proofs_tpu_torch.proofs.bundle import StorageProof, UnifiedProofBundle
from ipc_proofs_tpu_torch.proofs.chain import Tipset
from ipc_proofs_tpu_torch.proofs.witness import WitnessCollector
from ipc_proofs_tpu_torch.state.actors import (
    ActorState,
    StateRoot,
    get_actor_state,
    parse_evm_state,
)
from ipc_proofs_tpu_torch.state.address import Address
from ipc_proofs_tpu_torch.state.events import ascii_to_bytes32, left_pad_32
from ipc_proofs_tpu_torch.state.header import decode_header_lite, extract_parent_state_root
from ipc_proofs_tpu_torch.state.storage import read_storage_slot, slot_read_route
from ipc_proofs_tpu_torch.store.blockstore import Blockstore, CachedBlockstore, RecordingBlockstore
from ipc_proofs_tpu_torch.utils.metrics import Metrics

__all__ = [
    "MappingSlotSpec",
    "generate_storage_proofs_batch",
    "generate_storage_proofs_for_pairs",
    "hash_slot_specs",
]


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
    with phase_span("storage.slot_hash"):
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


def generate_storage_proofs_for_pairs(
    cached: Blockstore,
    pairs: Sequence,
    specs: Sequence[MappingSlotSpec],
    slots: Sequence[bytes],
) -> "Optional[tuple[list[StorageProof], set[bytes]]]":
    """Range-batched storage generation: every (pair × spec) claim in one
    pass — child headers decode once per pair, unique (state root, actor)
    pairs resolve through ONE batched C actors-tree walk (with per-item
    witness recording), storage roots classify once
    (`slot_read_route`) and the HAMT-encoded ones walk in one more
    batched C call. Returns ``(proofs, witness_cid_bytes)`` with claims in
    (pair, spec) order — field-identical to looping
    `generate_storage_proofs_batch` per pair (tested differentially) —
    or None in the pure-Python universe. Error types match the
    scalar loop per claim, though batch phase ordering can surface a
    different claim's error first.
    """
    if hamt_get_batch_touched(cached, [], [], []) is None:
        return None
    witness: set[bytes] = set()

    # Phases A-C are the actors' walk, D the slots' walk, E the claims:
    # one span each
    with phase_span("storage.actor_walk"):
        # Phase A: per pair — child header decode + parent-state-root cross-check.
        pair_psr: list[CID] = []
        for pair in pairs:
            child_cid = pair.child.cids[0]
            raw = cached.get(child_cid)
            if raw is None:
                raise KeyError(f"missing child header {child_cid}")
            psr = decode_header_lite(raw).parent_state_root
            if psr != pair.child.blocks[0].parent_state_root:
                raise ValueError(
                    "ParentStateRoot mismatch between header CBOR and tipset view"
                )
            pair_psr.append(psr)
            witness.add(child_cid.to_bytes())
            witness.add(psr.to_bytes())

        # Phase B: unique state roots → actors roots (StateRoot block is part
        # of the witness; missing → the scalar get_actor_state KeyError).
        actors_root: dict[CID, CID] = {}
        # dict.fromkeys = dedup in first-seen pair order (set order is salted)
        for psr in dict.fromkeys(pair_psr):
            raw = cached.get(psr)
            if raw is None:
                raise KeyError(f"missing StateRoot {psr}")
            actors_root[psr] = StateRoot.decode(raw).actors

        # Phase C: unique (state root, actor) → ActorState via one batched
        # recorded walk; then EVM state per unique actor-state CID.
        actor_ids = sorted({s.actor_id for s in specs})
        walk_roots: list[CID] = []
        root_pos: dict[CID, int] = {}
        owners: list[int] = []
        keys: list[bytes] = []
        pairs_keys: list[tuple[CID, int]] = []
        for psr in sorted(set(pair_psr), key=CID.to_bytes):
            for actor_id in actor_ids:
                pos = root_pos.setdefault(actors_root[psr], len(walk_roots))
                if pos == len(walk_roots):
                    walk_roots.append(actors_root[psr])
                owners.append(pos)
                keys.append(Address.new_id(actor_id).to_bytes())
                pairs_keys.append((psr, actor_id))
        walk = hamt_get_batch_touched(cached, walk_roots, owners, keys)
        assert walk is not None  # availability probed above
        values, touched = walk
        contract_info: dict[tuple[CID, int], tuple[CID, CID]] = {}
        evm_cache: dict[CID, CID] = {}
        for (psr, actor_id), value, item_touched in zip(pairs_keys, values, touched):
            if value is None:
                raise KeyError(f"actor not found for {Address.new_id(actor_id)}")
            witness.update(item_touched)
            actor = ActorState.from_tuple(value)
            storage_root = evm_cache.get(actor.state)
            if storage_root is None:
                evm_state_raw = cached.get(actor.state)
                if evm_state_raw is None:
                    raise KeyError(f"missing EVM state {actor.state}")
                storage_root = parse_evm_state(evm_state_raw).contract_state
                evm_cache[actor.state] = storage_root
            witness.add(actor.state.to_bytes())
            witness.add(storage_root.to_bytes())
            contract_info[(psr, actor_id)] = (actor.state, storage_root)

    with phase_span("storage.slot_walk"):
        # Phase D: classify each unique storage root once; HAMT-encoded roots
        # batch their slot walks (grouped by bit width), SmallMap roots resolve
        # host-side against the root block alone.
        unique_roots = sorted(
            {info[1] for info in contract_info.values()}, key=CID.to_bytes
        )
        resolver: dict[CID, tuple] = {}
        for root in unique_roots:
            raw = cached.get(root)
            if raw is None:
                raise KeyError(f"missing contract_state root {root}")
            witness.add(root.to_bytes())
            resolver[root] = slot_read_route(root, cbor_decode(raw))

        # batched HAMT slot walks, grouped by bit width; distinct (state root,
        # actor) pairs often share one storage root across a range, so walks
        # dedup on (storage_root, slot) — slot_values carries the shared result
        needed: dict[int, tuple[list, dict, list, list, list]] = {}
        walk_seen: set[tuple[CID, bytes]] = set()
        for (psr, actor_id), (_, storage_root) in contract_info.items():
            kind = resolver[storage_root][0]
            if kind != "walk":
                continue
            _, walk_root, bw = resolver[storage_root]
            group = needed.setdefault(bw, ([], {}, [], [], []))
            g_roots, g_pos, g_owner, g_keys, g_ident = group
            for spec, slot in zip(specs, slots):
                if spec.actor_id != actor_id:
                    continue
                ident = (storage_root, slot)
                if ident in walk_seen:
                    continue
                walk_seen.add(ident)
                pos = g_pos.setdefault(walk_root, len(g_roots))
                if pos == len(g_roots):
                    g_roots.append(walk_root)
                g_owner.append(pos)
                g_keys.append(slot)
                g_ident.append(ident)
        slot_values: dict[tuple[CID, bytes], bytes] = {}
        for bw, (g_roots, _, g_owner, g_keys, g_ident) in sorted(needed.items()):
            walk = hamt_get_batch_touched(cached, g_roots, g_owner, g_keys, bit_width=bw)
            assert walk is not None
            for ident, value, item_touched in zip(g_ident, walk[0], walk[1]):
                witness.update(item_touched)
                slot_values[ident] = value

    with phase_span("storage.claims"):
        # Phase E: claims in (pair, spec) order — strings cached per CID.
        str_cache: dict[CID, str] = {}

        def _s(cid: CID) -> str:
            out = str_cache.get(cid)
            if out is None:
                out = str(cid)
                str_cache[cid] = out
            return out

        slot_hex = ["0x" + s.hex() for s in slots]
        proofs: list[StorageProof] = []
        for pair, psr in zip(pairs, pair_psr):
            child_cid = pair.child.cids[0]
            child_str = _s(child_cid)
            psr_str = _s(psr)
            for j, spec in enumerate(specs):
                actor_state_cid, storage_root = contract_info[(psr, spec.actor_id)]
                kind = resolver[storage_root]
                if kind[0] == "map":
                    raw_value = kind[1].get(slots[j])
                elif kind[0] == "walk":
                    raw_value = slot_values[(storage_root, slots[j])]
                else:  # odd bit width: the scalar cascade, recorded
                    recorder = RecordingBlockstore(cached)
                    raw_value = read_storage_slot(recorder, storage_root, slots[j])
                    witness.update(c.to_bytes() for c in recorder.take_seen())
                proofs.append(
                    StorageProof(
                        child_epoch=pair.child.height,
                        child_block_cid=child_str,
                        parent_state_root=psr_str,
                        actor_id=spec.actor_id,
                        actor_state_cid=_s(actor_state_cid),
                        storage_root=_s(storage_root),
                        slot=slot_hex[j],
                        value="0x" + left_pad_32(raw_value or b"").hex(),
                    )
                )
    return proofs, witness
