"""Multi-tipset range driver: batch proof generation over many epoch pairs.

- Phase A (host):   decode receipts + events for EVERY pair;
- Phase B (device): ONE batched predicate over all events in the range;
- Phase C (host):   pass-2 recording only for matching receipts;
- Phase D:          one merged, CID-deduplicated, CID-sorted witness.

Phases A and B run fused by default: the native scanner evaluates the
fingerprint predicate inside its C walk (`scan_match_hits`), exactly as the
reference does for a single-device backend that offers
``event_match_mask_fp``. ``IPC_SCAN_FUSED_MATCH=0`` takes the unfused
branch: the scanner emits flat arrays and ``GpuBackend.event_match_mask_fp``
runs the mask on the card. Phase C runs two C walkers over every matching
pair (exec order + base witness, then the receipts paths), and Phase D
materializes the witness in one C pass; a group the C side fails on is
redone on the scalar path, so errors surface identically.

Optional ``storage_specs`` (`MappingSlotSpec`s) are proved at every pair:
their slot digests hash ONCE range-wide on the backend's keccak kernel, then
`generate_storage_proofs_for_pairs` proves the whole grid through the
batched HAMT walker, and its blocks merge into the one witness.

The counterpart of ``ipc_proofs_tpu.proofs.range.generate_event_proofs_for_range``.
Under ``IPC_PROOFS_NO_NATIVE=1`` it runs the reference's pure-Python
branches (Python scan with the flat mask on the card, scalar record,
per-pair storage batches, pure witness materialization). The mask and the
slot hashing always run on the backend.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from ipc_proofs_tpu_torch.backend import get_backend
from ipc_proofs_tpu_torch.backend.native import load_dagcbor_ext, load_scan_ext
from ipc_proofs_tpu_torch.core.cid import CID
from ipc_proofs_tpu_torch.proofs.bundle import (
    EventData,
    EventProof,
    ProofBlock,
    UnifiedProofBundle,
)
from ipc_proofs_tpu_torch.proofs.chain import Tipset
from ipc_proofs_tpu_torch.proofs.event_generator import (
    EventMatcher,
    collect_base_witness_and_exec_order,
    mask_receipt_indices,
    record_matching_receipts,
    scan_receipt_events,
)
from ipc_proofs_tpu_torch.proofs.exec_order import collect_exec_orders_for_pairs
from ipc_proofs_tpu_torch.proofs.generator import EventProofSpec
from ipc_proofs_tpu_torch.proofs.scan_native import (
    _raw_view,
    _snap_kw,
    has_raw_map,
    match_mask_flat_np,
    record_receipt_paths,
    scan_events_flat,
    scan_match_hits,
)
from ipc_proofs_tpu_torch.proofs.storage_batch import (
    MappingSlotSpec,
    generate_storage_proofs_batch,
    generate_storage_proofs_for_pairs,
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
    pairs, with one predicate evaluation for the entire range, plus the
    ``storage_specs`` grid proved at every pair (e.g. a subnet's nonce slot
    tracked across the range). ``match_backend`` runs the unfused mask and
    the slot keccaks; it defaults to ``get_backend("gpu")``, the card
    (raises without CUDA); pass ``get_backend("gpu", device="cpu")`` for the
    plain versions."""
    if match_backend is None:
        match_backend = get_backend("gpu")
    metrics = metrics if metrics is not None else Metrics()
    matcher = EventMatcher(spec.event_signature, spec.topic_1)
    cached = CachedBlockstore(store)
    matching_per_pair, native_ok = _scan_and_match(
        cached, pairs, spec, matcher, match_backend, metrics
    )
    with metrics.stage("range_record"):
        event_proofs, witness_bytes, fallback_blocks = _record_chunk(
            cached, pairs, matching_per_pair, matcher, spec, native_ok
        )
    metrics.count("range_proofs", len(event_proofs))

    storage_proofs: list = []
    if storage_specs:
        with metrics.stage("range_storage"):
            storage_proofs, storage_witness, storage_blocks = _storage_for_pairs(
                cached, pairs, storage_specs, match_backend
            )
        metrics.count("range_storage_proofs", len(storage_proofs))
        witness_bytes = witness_bytes | storage_witness
        fallback_blocks = list(fallback_blocks) + list(storage_blocks)

    with metrics.stage("range_record"):
        blocks = _materialize_witness(cached, witness_bytes, fallback_blocks)
    return UnifiedProofBundle(
        storage_proofs=storage_proofs, event_proofs=event_proofs, blocks=blocks
    )


def _storage_for_pairs(
    cached: Blockstore,
    pairs: Sequence[TipsetPair],
    storage_specs: Sequence[MappingSlotSpec],
    hash_backend,
) -> "tuple[list, set[bytes], list[ProofBlock]]":
    """Prove every storage spec at every pair, claims in (pair, spec) order,
    slot digests hashed once for the whole range. Returns ``(proofs,
    witness_cid_bytes, fallback_blocks)``: the batched generator gives raw
    CID bytes for the shared end-of-bundle materialization; the per-pair
    scalar batches of the pure-Python universe give materialized blocks."""
    slots = hash_slot_specs(storage_specs, hash_backend)
    batched = generate_storage_proofs_for_pairs(cached, pairs, storage_specs, slots)
    if batched is not None:
        proofs, witness_bytes = batched
        return proofs, witness_bytes, []
    proofs = []
    blocks: set[ProofBlock] = set()
    for pair in pairs:
        bundle = generate_storage_proofs_batch(
            cached, pair.parent, pair.child, storage_specs, precomputed_slots=slots
        )
        proofs.extend(bundle.storage_proofs)
        blocks.update(bundle.blocks)
    return proofs, set(), sorted(blocks, key=lambda b: b.cid.to_bytes())


def _scan_and_match(
    cached: Blockstore,
    pairs: Sequence[TipsetPair],
    spec: EventProofSpec,
    matcher: EventMatcher,
    match_backend,
    metrics: Metrics,
) -> "tuple[list[list[int]], bool]":
    """Phases A+B: scan every pair's receipts/events, run the match
    predicate; return (matching receipt indices per pair, whether the
    native scan ran — the record phase then uses the same fast block
    access)."""
    scan_batch = None
    scans = None
    with metrics.stage("range_scan"):
        roots = [pair.child.blocks[0].parent_message_receipts for pair in pairs]
        native = has_raw_map(cached)
        # Fused scan+match: a single-device backend with the fp mask folds
        # the predicate into the C walk; IPC_SCAN_FUSED_MATCH=0 forces the
        # unfused flat-array path (the mask then runs on the card).
        if (
            native
            and getattr(match_backend, "mesh", None) is None
            and os.environ.get("IPC_SCAN_FUSED_MATCH", "1") != "0"
        ):
            hits = scan_match_hits(
                cached, roots, matcher.topic0, matcher.topic1, spec.actor_id_filter
            )
            if hits is not None:
                n_events, hit_pairs, hit_exec = hits
                metrics.count("range_events", n_events)
                # the match leg collapsed into the scan: record it as a
                # (near-)zero stage so per-stage accounting stays complete
                with metrics.stage("range_match"):
                    matching_per_pair: list[list[int]] = [[] for _ in pairs]
                    prev = None
                    # walk order ⇒ (pair, exec) ascending, dups adjacent
                    for p, e in zip(hit_pairs.tolist(), hit_exec.tolist()):
                        if (p, e) != prev:
                            matching_per_pair[p].append(e)
                            prev = (p, e)
                return matching_per_pair, True
        if native:
            scan_batch = scan_events_flat(cached, roots)
        if scan_batch is None:
            scans = [scan_receipt_events(cached, root) for root in roots]

    # Phase B: one batched predicate over all events in the range.
    with metrics.stage("range_match"):
        if scan_batch is None:
            metrics.count(
                "range_events", sum(len(events) for scanned in scans for _, _, events in scanned)
            )
            return mask_receipt_indices(scans, matcher, spec.actor_id_filter, match_backend), False
        metrics.count("range_events", scan_batch.n_events)
        matching_per_pair = [[] for _ in pairs]
        if scan_batch.n_events:
            # fingerprint mask on the card: one u64 per event crosses;
            # pass 2 confirms every hit exactly
            mask = match_backend.event_match_mask_fp(
                scan_batch.fp,
                scan_batch.n_topics,
                scan_batch.emitters,
                scan_batch.valid,
                matcher.topic0,
                matcher.topic1,
                spec.actor_id_filter,
            )[: scan_batch.n_events]
            sel = np.nonzero(mask)[0]
            hits = sorted(
                set(zip(scan_batch.pair_ids[sel].tolist(), scan_batch.exec_idx[sel].tolist()))
            )
            for pair_pos, exec_index in hits:
                matching_per_pair[pair_pos].append(exec_index)
    return matching_per_pair, True


def _record_chunk(
    cached: Blockstore,
    pairs: Sequence[TipsetPair],
    matching_per_pair: "list[list[int]]",
    matcher: EventMatcher,
    spec: EventProofSpec,
    native_ok: bool,
) -> "tuple[list, set[bytes], list[ProofBlock]]":
    """Phase C: pass 2. Pairs with no matching receipts contribute no
    proofs, so their base witness (headers, TxMeta walks) is skipped: a
    range bundle's witness only needs to cover the proofs it carries.

    Returns ``(event_proofs, witness_cid_bytes, fallback_blocks)``: the
    native walkers give raw CID bytes, materialized once for the whole
    bundle (`_materialize_witness`); the scalar pass 2 of the pure-Python
    universe gives materialized blocks."""
    matching_pairs = [
        (pair, matching) for pair, matching in zip(pairs, matching_per_pair) if matching
    ]
    if matching_pairs and native_ok:
        native = _record_pass2_native(cached, matching_pairs, matcher, spec.actor_id_filter)
        if native is not None:
            event_proofs, witness_bytes = native
            return event_proofs, witness_bytes, []
    event_proofs = []
    all_blocks: set[ProofBlock] = set()
    for pair, matching in matching_pairs:
        collector = WitnessCollector(cached)
        proofs = _record_pair_scalar(collector, cached, pair, matching, matcher, spec.actor_id_filter)
        event_proofs.extend(proofs)
        all_blocks.update(collector.materialize())
    return event_proofs, set(), sorted(all_blocks, key=lambda b: b.cid.to_bytes())


def _record_pair_scalar(
    collector: WitnessCollector,
    cached: Blockstore,
    pair: TipsetPair,
    matching: "list[int]",
    matcher: EventMatcher,
    actor_id_filter: Optional[int],
) -> list:
    """Scalar pass 2 of one pair into ``collector``: one set of TxMeta
    walks yields both the recorded base witness and the execution order
    (they touch the same blocks)."""
    exec_order = collect_base_witness_and_exec_order(collector, cached, pair.parent, pair.child)
    proofs, recordings = record_matching_receipts(
        cached, pair.parent, pair.child, exec_order, matching, matcher, actor_id_filter
    )
    collector.collect_from_recordings(recordings)
    return proofs


def _materialize_witness(
    cached: Blockstore,
    witness_bytes: "set[bytes]",
    extra_blocks: "Sequence[ProofBlock]" = (),
) -> "list[ProofBlock]":
    """Phase D: ONE materialization for the whole bundle. ``extra_blocks``
    (scalar-fallback and storage blocks, already materialized) dedup
    against the byte set by CID bytes. Output is CID-byte-sorted — the
    bundle's canonical witness order.

    ``materialize_blocks`` does the sort, the probes (persistent snapshot
    table first) and the ProofBlock construction in one C pass, with CIDs
    from the dagcbor extension's batched ``make_cids``; the pure-Python
    universe parses and probes in a loop."""
    by_cid: "dict[bytes, ProofBlock]" = {}
    for block in extra_blocks:
        by_cid[block.cid.to_bytes()] = block
    todo_set = witness_bytes - by_cid.keys() if by_cid else witness_bytes
    raw_map, _ = _raw_view(cached)
    scan_ext = load_scan_ext()
    if scan_ext is not None:
        todo_list = list(todo_set)
        blocks = scan_ext.materialize_blocks(
            raw_map,
            todo_list,
            load_dagcbor_ext().make_cids,
            ProofBlock,
            lambda cid: cached.get(cid),
            **_snap_kw(cached, raw_map, len(todo_list)),
        )
        if not by_cid:
            return blocks  # already CID-byte-sorted
        for block in blocks:
            by_cid[block.cid.to_bytes()] = block
        return [by_cid[k] for k in sorted(by_cid)]
    for cid_bytes in sorted(todo_set):
        cid = CID.from_bytes(cid_bytes)
        raw = raw_map.get(cid_bytes)
        if raw is None:
            raw = cached.get(cid)
        if raw is None:
            raise KeyError(f"missing witness block {cid}")
        by_cid[cid_bytes] = ProofBlock(cid, raw)
    return [by_cid[k] for k in sorted(by_cid)]


def _record_pass2_native(
    cached: Blockstore,
    matching_pairs: "list[tuple[TipsetPair, list[int]]]",
    matcher: EventMatcher,
    actor_id_filter: Optional[int],
) -> "Optional[tuple[list, set[bytes]]]":
    """Phase C over the native walkers: returns (event_proofs,
    witness_cid_bytes), or None in the pure-Python universe. Byte-identical
    to the scalar pass 2; groups the C side fails on are redone scalar.

    TWO C calls cover every matching pair — the batched TxMeta/message-AMT
    walker (exec order + base witness) and the batched pass-2 recorder
    (receipts paths + events AMTs + payload-mode event arrays); the claims
    are one numpy mask over the recorded rows and one C call
    (``build_event_claims``) that builds the EventProof objects."""
    walks = collect_exec_orders_for_pairs(
        cached, [[h.messages for h in pair.parent.blocks] for pair, _ in matching_pairs]
    )
    if walks is None:
        return None
    rec = record_receipt_paths(
        cached,
        [pair.child.blocks[0].parent_message_receipts for pair, _ in matching_pairs],
        [matching for _, matching in matching_pairs],
    )
    if rec is None:
        return None

    sb = rec.batch
    # claim mask over ALL recorded events at once: THE shared host predicate
    # (extract_evm_log validity + matches_log + actor filter)
    if sb.n_events:
        mask = match_mask_flat_np(
            sb.topics, sb.n_topics, sb.emitters, sb.valid,
            matcher.topic0, matcher.topic1, actor_id_filter,
        )
    else:
        mask = np.zeros(0, dtype=bool)

    # Pass A over the groups collects witness bytes, redoes failed groups
    # scalar and gathers the raw CID bytes each native claim needs, so every
    # CID string renders in ONE batched C call (cid_strs); the C claim
    # builder then reads them. Per-group proof lists keep the emission
    # order of the scalar formulation (group order, row order).
    witness: set[bytes] = set()
    witness_items: list[bytes] = []  # good-group flat appends; one union below
    goff = rec.row_offsets(len(matching_pairs))
    # ONE vectorized pass resolves every claim row's group: side="right"
    # minus 1 maps a row to the unique group whose [goff[g], goff[g+1])
    # span holds it, including through runs of empty groups
    rows_by_group: "dict[int, tuple[list[int], list[int]]]" = {}
    sel = np.nonzero(mask)[0]
    if len(sel):
        sel_group = (np.searchsorted(goff, sel, side="right") - 1).tolist()
        sel_exec = sb.exec_idx[sel].tolist()
        for g_, r_, e_ in zip(sel_group, sel.tolist(), sel_exec):
            entry = rows_by_group.setdefault(g_, ([], []))
            entry[0].append(r_)
            entry[1].append(e_)
    per_group_proofs: "list[list]" = [[] for _ in matching_pairs]
    claim_rows: "list[tuple[int, int]]" = []  # (group, row)
    str_bytes: "list[bytes]" = []  # cid bytes to render, in claim order
    group_str_base: "dict[int, int]" = {}  # group → offset of its parents+child
    good: "list[int]" = []  # native-handled groups
    for g, (pair, matching) in enumerate(matching_pairs):
        walk = walks[g]
        if walk is None or rec.failed[g]:
            collector = WitnessCollector(cached)
            per_group_proofs[g] = _record_pair_scalar(
                collector, cached, pair, matching, matcher, actor_id_filter
            )
            witness.update(c.to_bytes() for c in collector.needed_cids())
            continue

        exec_msgs, exec_touched = walk
        for i in matching:
            if i >= len(exec_msgs):
                raise KeyError(f"missing message at execution index {i}")
        good.append(g)
        witness_items.extend(exec_touched)

        grp = rows_by_group.get(g)
        if grp is None:
            continue
        rows, execs = grp
        group_str_base[g] = len(str_bytes)
        str_bytes.extend(c.to_bytes() for c in pair.parent.cids)
        str_bytes.append(pair.child.cids[0].to_bytes())
        for row, exec_i in zip(rows, execs):
            claim_rows.append((g, row))
            str_bytes.append(exec_msgs[exec_i])

    # header-derived witness CIDs for every good group, plus the recorder's
    # touched blocks — ALL of them when no group fell back
    good_pairs = [matching_pairs[g][0] for g in good]
    witness_items += [c.to_bytes() for p in good_pairs for c in p.parent.cids]
    witness_items += [p.child.cids[0].to_bytes() for p in good_pairs]
    witness_items += [p.child.blocks[0].parent_message_receipts.to_bytes() for p in good_pairs]
    witness_items += [h.messages.to_bytes() for p in good_pairs for h in p.parent.blocks]
    if len(good) == len(matching_pairs):
        witness_items.extend(rec.all_touched())
    else:
        for g in good:
            witness_items.extend(rec.touched(g))
    witness.update(witness_items)

    if claim_rows:
        strs = load_dagcbor_ext().cid_strs(str_bytes)
        # message-CID string positions are laid out per group after its
        # parents+child block; claims of one group are contiguous
        msg_pos: "list[int]" = []
        pos = 0
        for g, _row in claim_rows:
            base = group_str_base[g] + len(matching_pairs[g][0].parent.cids) + 1
            pos = base if pos < base else pos
            msg_pos.append(pos)
            pos += 1
        n_groups = len(matching_pairs)
        claims = load_scan_ext().build_event_claims(
            strs=strs,
            rows=np.fromiter((row for _, row in claim_rows), np.int64, count=len(claim_rows)),
            group_of=np.fromiter((g for g, _ in claim_rows), np.int64, count=len(claim_rows)),
            msg_pos=np.asarray(msg_pos, np.int64),
            str_base=np.fromiter(
                (group_str_base.get(g, 0) for g in range(n_groups)), np.int64, count=n_groups
            ),
            n_parents=np.fromiter(
                (len(p.parent.cids) for p, _ in matching_pairs), np.int64, count=n_groups
            ),
            parent_epoch=np.fromiter(
                (p.parent.height for p, _ in matching_pairs), np.int64, count=n_groups
            ),
            child_epoch=np.fromiter(
                (p.child.height for p, _ in matching_pairs), np.int64, count=n_groups
            ),
            exec_idx=sb.exec_idx,
            event_idx=sb.event_idx,
            emitters=sb.emitters,
            n_topics=sb.n_topics,
            topics_off=sb.topics_off,
            data_off=sb.data_off,
            data_len=sb.data_len,
            topics_pool=sb.topics_pool,
            data_pool=sb.data_pool,
            proof_cls=EventProof,
            data_cls=EventData,
        )
        for (g, _row), proof in zip(claim_rows, claims):
            per_group_proofs[g].append(proof)

    proofs: list = []
    for group_proofs in per_group_proofs:
        proofs.extend(group_proofs)
    return proofs, witness
