"""Event proof verification: fully offline 4-step replay per proof.

Per proof — trust anchors; header consistency (child.parents == claimed
tipset, heights match); execution order (reconstructed from the witness
with TxMeta CID recompute, claimed message at exec_index); receipt + event
replay (receipts AMT → events AMT → emitter/topics/data compare, optional
semantic predicate). Returns one boolean per proof. The counterpart of
``ipc_proofs_tpu.proofs.event_verifier``: ``batch="auto"`` takes the
grouped batch replay over the native walkers (the scalar per-proof loop in
the pure-Python universe), whose TxMeta CID recompute runs on a hash
backend, the card by default.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from ipc_proofs_tpu_torch.core.cid import CID, cids_from_strings
from ipc_proofs_tpu_torch.ipld.amt import AMT
from ipc_proofs_tpu_torch.proofs.bundle import EventData, EventProof, EventProofBundle
from ipc_proofs_tpu_torch.proofs.exec_order import (
    reconstruct_execution_order,
    reconstruct_execution_orders_batch,
)
from ipc_proofs_tpu_torch.proofs.scan_native import native_scan_available, scan_events_flat
from ipc_proofs_tpu_torch.proofs.witness import load_witness_store
from ipc_proofs_tpu_torch.state.events import (
    ActorEvent,
    Receipt,
    StampedEvent,
    extract_evm_log,
)
from ipc_proofs_tpu_torch.state.header import BlockHeader, LiteHeader, decode_header_lite
from ipc_proofs_tpu_torch.store.blockstore import MemoryBlockstore

__all__ = ["verify_event_proof"]


def verify_event_proof(
    bundle: EventProofBundle,
    is_trusted_parent_ts: Callable[[int, list[CID]], bool],
    is_trusted_child_header: Callable[[int, CID], bool],
    check_event: Optional[Callable[[ActorEvent], bool]] = None,
    store: Optional[MemoryBlockstore] = None,
    batch: "bool | str" = "auto",
    hash_backend=None,
) -> list[bool]:
    """Verify every proof in ``bundle``; one bool per proof.

    ``batch="auto"`` routes through the grouped batch replay (native
    scanner + pooled byte compares) when the scan extension is loaded;
    ``False`` forces the scalar per-proof loop. Both give identical
    results — the batch path falls back to the scalar step for any group
    whose witness scan errors, and for the semantic ``check_event``
    predicate. The batch path's TxMeta CID recompute runs on
    ``hash_backend``, which defaults to ``get_backend("gpu")``, the card
    (raises without CUDA once a recompute is due). The witness CID
    recompute is ``verify_proof_bundle(..., verify_witness_cids=True)``."""
    if store is None:
        store = load_witness_store(bundle.blocks)
    if batch == "auto":
        batch = native_scan_available()
    if batch:
        return _verify_proofs_batch(
            store,
            bundle.proofs,
            is_trusted_parent_ts,
            is_trusted_child_header,
            check_event,
            hash_backend,
        )
    # proofs of the same parent tipset share one exec-order reconstruction
    exec_cache: dict[tuple[str, ...], list[CID]] = {}
    return [
        _verify_single_proof(
            store, proof, is_trusted_parent_ts, is_trusted_child_header, check_event, exec_cache
        )
        for proof in bundle.proofs
    ]


def _verify_proofs_batch(
    store: MemoryBlockstore,
    proofs: list[EventProof],
    is_trusted_parent_ts: Callable[[int, list[CID]], bool],
    is_trusted_child_header: Callable[[int, CID], bool],
    check_event: Optional[Callable[[ActorEvent], bool]],
    hash_backend=None,
) -> list[bool]:
    """Grouped batch replay: proofs sharing (parent tipset, child header) do
    header decode, execution-order reconstruction, and the receipts/events
    walk ONCE; per-proof work shrinks to integer checks and pooled byte
    compares. The reference redoes all of it per proof
    (`events/verifier.rs:92-121`)."""
    results = [False] * len(proofs)
    groups: dict[tuple[tuple[str, ...], str], list[int]] = {}
    for k, proof in enumerate(proofs):
        key = (tuple(proof.parent_tipset_cids), proof.child_block_cid)
        groups.setdefault(key, []).append(k)

    # Phase 1: steps 1-2 per group (shared pieces computed lazily, at the
    # FIRST proof whose earlier steps pass — so raise/False behavior is
    # exactly the scalar path's: a proof rejected by the trust policy never
    # touches the witness beyond the headers step 2 itself reads; a missing
    # child header raises only after trust passes, as in
    # `_verify_single_proof`). Groups with survivors proceed to the batched
    # step 3 — reconstruction runs ONLY for groups some proof actually
    # reached, preserving the lazy cost model against adversarial bundles.
    # headers decoded once per CID across ALL phases (phase 1 shares its
    # decodes with step 3's strict re-validation leg); LiteHeader carries
    # exactly the fields any phase reads, with full-decode acceptance
    header_cache: dict[CID, LiteHeader] = {}

    def _decoded_header(cid: CID, kind: str) -> LiteHeader:
        header = header_cache.get(cid)
        if header is None:
            raw = store.get(cid)
            if raw is None:
                raise KeyError(f"missing {kind} header in witness")
            header = decode_header_lite(raw)
            header_cache[cid] = header
        return header

    # every group's (parents..., child) CID strings parse in ONE batched C
    # call — same per-string acceptance as the scalar CID.from_string loop,
    # and a malformed string aborts the whole verify in both formulations
    group_items = list(groups.items())
    flat_strs: list[str] = []
    spans: list[tuple[int, int]] = []
    for (parent_strs, _child_str), _idxs in group_items:
        spans.append((len(flat_strs), len(parent_strs)))
        flat_strs.extend(parent_strs)
        flat_strs.append(_child_str)
    flat_cids = cids_from_strings(flat_strs)

    step3: list[tuple[list[int], list[CID], "LiteHeader"]] = []
    for ((parent_strs, child_str), idxs), (base, n_parents) in zip(
        group_items, spans
    ):
        parent_cids = flat_cids[base : base + n_parents]
        child_cid = flat_cids[base + n_parents]
        child_header: Optional[LiteHeader] = None
        parents_match = False
        parent_height: Optional[int] = None
        survivors: list[int] = []

        for k in idxs:
            proof = proofs[k]
            # Step 1: trust anchors (per proof — policies see each claim).
            if not is_trusted_parent_ts(proof.parent_epoch, parent_cids):
                continue
            if not is_trusted_child_header(proof.child_epoch, child_cid):
                continue
            # Step 2: header consistency (decode once per group).
            if child_header is None:
                child_header = _decoded_header(child_cid, "child")
                parents_match = child_header.parents == parent_cids
            if not parents_match:
                continue
            if child_header.height != proof.child_epoch:
                continue
            if parent_height is None:
                parent_height = _decoded_header(parent_cids[0], "parent").height
            if parent_height != proof.parent_epoch:
                continue
            survivors.append(k)
        if survivors:
            step3.append((survivors, parent_cids, child_header))

    if not step3:
        return results

    # Step 3, batched: ONE native walk reconstructs the surviving groups'
    # execution orders (scalar per group when the extension is absent).
    batch_exec = reconstruct_execution_orders_batch(
        store,
        [parent_cids for _, parent_cids, _ in step3],
        header_cache=header_cache,
        hash_backend=hash_backend,
    )

    pending: list[tuple[int, "LiteHeader"]] = []
    pending_roots: list[CID] = []  # one receipts root per group with survivors
    root_pos: dict[CID, int] = {}  # receipts-root cid → position in ^
    pending_pair: list[int] = []  # pending[i] → its root position

    # resolve each group's exec mapping first, then batch-parse the live
    # groups' claimed message CIDs in one C call (a malformed message_cid
    # string raises only if its group's reconstruction succeeded — the
    # scalar path's step-3 ordering); each group records its explicit
    # (start, count) span into the parsed list
    group_exec: list = []
    msg_spans: list[tuple[int, int]] = []
    msg_strs: list[str] = []
    for gi, (survivors, parent_cids, child_header) in enumerate(step3):
        if batch_exec is not None:
            exec_list = batch_exec[gi]
        else:
            try:
                exec_order = reconstruct_execution_order(store, parent_cids)
                exec_list = [c.to_bytes() for c in exec_order]
            except (KeyError, ValueError):
                exec_list = None
        group_exec.append(exec_list)
        msg_spans.append((len(msg_strs), len(survivors)))
        if exec_list is not None:
            msg_strs.extend(proofs[k].message_cid for k in survivors)
    msg_cids = cids_from_strings(msg_strs)

    for gi, (survivors, parent_cids, child_header) in enumerate(step3):
        exec_list = group_exec[gi]
        if exec_list is None:
            continue
        msg_base = msg_spans[gi][0]
        for j, k in enumerate(survivors):
            proof = proofs[k]
            # exec_list entries are unique (first-seen deduped), so "the
            # claimed message sits at the claimed index" is one indexing.
            # Non-int indices (float 3.0 from a JSON bundle) are rejected
            # up front in BOTH paths — serde parity: the reference's u64
            # claim fields reject non-integers at deserialization
            # (`events/bundle.rs:14-23`) — so claims that could never
            # deserialize there verify False here, identically.
            ei = proof.exec_index
            if (
                not _claim_index_ok(ei)
                or not _claim_index_ok(proof.event_index)
                or not 0 <= ei < len(exec_list)
                or exec_list[ei] != msg_cids[msg_base + j].to_bytes()
            ):
                continue
            root = child_header.parent_message_receipts
            pos = root_pos.setdefault(root, len(pending_roots))
            if pos == len(pending_roots):
                pending_roots.append(root)
            pending.append((k, child_header))
            pending_pair.append(pos)

    if not pending:
        return results

    # Phase 2: ONE tolerant scan over every pending group's receipts AMT —
    # the walk visits each receipts/events path present in the (pruned)
    # witness once; a proof whose path is missing finds no row → False,
    # matching the scalar KeyError → False. A scan *error* (malformed block)
    # falls back to scalar replay so per-proof error semantics hold.
    try:
        scan = scan_events_flat(
            store, pending_roots, skip_missing=True, want_payload=True,
            validate_blocks=True,
        )
    except (KeyError, ValueError):
        scan = None
    row_for: Optional[list] = None
    if scan is not None:
        # Rows are emitted in (pair, exec, event) walk order, i.e. sorted —
        # vectorized searchsorted over 12-byte big-endian keys replaces a
        # Python dict over every scanned event.
        scan_keys = np.empty((scan.n_events, 3), dtype=">i4")
        scan_keys[:, 0] = scan.pair_ids
        scan_keys[:, 1] = scan.exec_idx
        scan_keys[:, 2] = scan.event_idx
        flat_keys = np.ascontiguousarray(scan_keys).view("S12").ravel()
        def _q(v: int) -> int:
            # forged claims can carry indices outside int32; those matched
            # nothing in the dict formulation and must match nothing here
            # (-1 is unreachable: scanned indices are non-negative)
            return v if 0 <= v <= 0x7FFFFFFF else -1

        query = np.empty((len(pending), 3), dtype=">i4")
        query[:, 0] = pending_pair
        query[:, 1] = [_q(proofs[k].exec_index) for k, _ in pending]
        query[:, 2] = [_q(proofs[k].event_index) for k, _ in pending]
        flat_query = np.ascontiguousarray(query).view("S12").ravel()
        pos = np.searchsorted(flat_keys, flat_query)
        in_range = pos < scan.n_events
        found = np.zeros(len(pending), dtype=bool)
        found[in_range] = flat_keys[pos[in_range]] == flat_query[in_range]
        row_for = [int(p) if f else None for p, f in zip(pos, found)]

    # Phase 3: step 4 per pending proof.
    for j, ((k, child_header), pair) in enumerate(zip(pending, pending_pair)):
        proof = proofs[k]
        if row_for is None:
            results[k] = _verify_receipt_and_event(
                store, child_header, proof, check_event
            )
            continue
        row = row_for[j]
        if row is None:
            continue
        if not _row_matches_claim(scan, row, proof.event_data):
            continue
        if check_event is not None:
            # Semantic predicates inspect the decoded ActorEvent — replay
            # just this proof's event scalar (sparse path).
            stamped = _replay_stamped_event(
                store,
                child_header.parent_message_receipts,
                proof.exec_index,
                proof.event_index,
            )
            if stamped is None or not check_event(stamped.event):
                continue
        results[k] = True
    return results


def _claim_index_ok(v) -> bool:
    """Claim indices must be ints (the reference's u64 fields reject
    non-integers at deserialization); a float/str index verifies False."""
    return isinstance(v, int)


def _row_matches_claim(scan, row: int, stored: EventData) -> bool:
    """Pooled-bytes equivalent of `_event_data_matches`, using the SAME
    string comparison as the scalar path (``("0x" + actual.hex()).lower() ==
    claimed.lower()``) so malformed claims — whitespace, odd length, missing
    prefix — are rejected identically."""
    if not scan.valid[row]:
        return False
    if int(scan.emitters[row]) != stored.emitter:
        return False
    if int(scan.n_topics[row]) != len(stored.topics):
        return False
    actual_topics = scan.event_topics(row)
    for k, topic_hex in enumerate(stored.topics):
        actual = "0x" + actual_topics[32 * k : 32 * k + 32].hex()
        if actual != topic_hex.lower():
            return False
    return ("0x" + scan.event_data(row).hex()) == stored.data.lower()


def _verify_single_proof(
    store: MemoryBlockstore,
    proof: EventProof,
    is_trusted_parent_ts: Callable[[int, list[CID]], bool],
    is_trusted_child_header: Callable[[int, CID], bool],
    check_event: Optional[Callable[[ActorEvent], bool]],
    exec_cache: dict,
) -> bool:
    child_cid = CID.from_string(proof.child_block_cid)
    parent_cids = [CID.from_string(c) for c in proof.parent_tipset_cids]

    # Step 1: trust anchors.
    if not is_trusted_parent_ts(proof.parent_epoch, parent_cids):
        return False
    if not is_trusted_child_header(proof.child_epoch, child_cid):
        return False

    # Step 2: header consistency.
    child_raw = store.get(child_cid)
    if child_raw is None:
        raise KeyError("missing child header in witness")
    child_header = BlockHeader.decode(child_raw)
    if child_header.parents != parent_cids:
        return False
    if child_header.height != proof.child_epoch:
        return False
    parent_raw = store.get(parent_cids[0])
    if parent_raw is None:
        raise KeyError("missing parent header in witness")
    if BlockHeader.decode(parent_raw).height != proof.parent_epoch:
        return False

    # Non-int claim indices reject before any walk (an AMT walk on a float
    # would raise, not verify).
    if not _claim_index_ok(proof.exec_index) or not _claim_index_ok(proof.event_index):
        return False

    # Step 3: execution order (with TxMeta CID recompute), memoized per
    # parent tipset across the bundle's proofs.
    cache_key = tuple(proof.parent_tipset_cids)
    exec_order = exec_cache.get(cache_key)
    if exec_order is None:
        try:
            exec_order = reconstruct_execution_order(store, parent_cids)
        except (KeyError, ValueError):
            return False
        exec_cache[cache_key] = exec_order
    msg_cid = CID.from_string(proof.message_cid)
    try:
        position = exec_order.index(msg_cid)
    except ValueError:
        return False
    if position != proof.exec_index:
        return False

    # Step 4: receipt + event replay.
    return _verify_receipt_and_event(store, child_header, proof, check_event)


def _replay_stamped_event(
    store: MemoryBlockstore, receipts_root: CID, exec_index: int, event_index: int
) -> Optional[StampedEvent]:
    """Walk receipts AMT → events AMT → StampedEvent, or None on any gap."""
    try:
        receipts_amt = AMT.load(store, receipts_root, expected_version=0)
        receipt_cbor = receipts_amt.get(exec_index)
        if receipt_cbor is None:
            return None
        receipt = Receipt.from_cbor(receipt_cbor)
        if receipt.events_root is None:
            return None
        events_amt = AMT.load(store, receipt.events_root, expected_version=3)
        stamped_cbor = events_amt.get(event_index)
    except (KeyError, ValueError):
        return None
    if stamped_cbor is None:
        return None
    return StampedEvent.from_cbor(stamped_cbor)


def _verify_receipt_and_event(
    store: MemoryBlockstore,
    child_header: BlockHeader,
    proof: EventProof,
    check_event: Optional[Callable[[ActorEvent], bool]],
) -> bool:
    stamped = _replay_stamped_event(
        store, child_header.parent_message_receipts, proof.exec_index, proof.event_index
    )
    if stamped is None:
        return False
    if not _event_data_matches(stamped, proof.event_data):
        return False
    if check_event is not None and not check_event(stamped.event):
        return False
    return True


def _event_data_matches(stamped: StampedEvent, stored: EventData) -> bool:
    """Compare the replayed event against the stored claim (hex
    case-insensitive)."""
    if stamped.emitter != stored.emitter:
        return False
    log = extract_evm_log(stamped.event)
    if log is None:
        return False
    if len(log.topics) != len(stored.topics):
        return False
    for actual, claimed in zip(log.topics, stored.topics):
        if ("0x" + actual.hex()).lower() != claimed.lower():
            return False
    return ("0x" + log.data.hex()).lower() == stored.data.lower()
