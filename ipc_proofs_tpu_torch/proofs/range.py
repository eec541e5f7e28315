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

Three more drivers split a range into chunks:

- `generate_event_proofs_for_range_chunked` runs the serial driver (or a
  ``generate_fn``: the CLI passes the pipelined one) chunk by chunk,
  resumable from per-chunk checkpoint files and a write-ahead job journal
  (`jobs`);
- `generate_event_proofs_for_range_pipelined` runs scan+match → record →
  merge → optional verify on the bounded-queue stage executor
  (`parallel.pipeline`), several workers a stage, under one shared thread
  budget (`utils.threads`);
- `generate_and_verify_range_overlapped` verifies chunk k on the card
  while chunks k+1… scan and record on the host.

Every driver's bundle is byte-identical to the serial driver's over the
same chunking, and checkpoint files and journals are interchangeable with
the reference's.

The counterpart of ``ipc_proofs_tpu.proofs.range``. Under
``IPC_PROOFS_NO_NATIVE=1`` it runs the reference's pure-Python branches
(Python scan with the flat mask on the card, scalar record, per-pair
storage batches, pure witness materialization). The mask and the slot
hashing always run on the backend.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from concurrent.futures import ThreadPoolExecutor
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
from ipc_proofs_tpu_torch.store.failover import is_store_error
from ipc_proofs_tpu_torch.store.rpc import RpcError
from ipc_proofs_tpu_torch.utils.deadline import checkpoint, remaining_budget_s
from ipc_proofs_tpu_torch.utils.lockdep import named_lock
from ipc_proofs_tpu_torch.utils.log import get_logger
from ipc_proofs_tpu_torch.utils.metrics import Metrics
from ipc_proofs_tpu_torch.utils.threads import resolve_thread_budget

__all__ = [
    "TipsetPair",
    "generate_event_proofs_for_range",
    "generate_event_proofs_for_range_chunked",
    "generate_event_proofs_for_range_pipelined",
    "generate_and_verify_range_overlapped",
]

logger = get_logger(__name__)


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
    scan_workers: int = 0,
) -> UnifiedProofBundle:
    """Generate event proofs for ``spec`` across a whole range of tipset
    pairs, with one predicate evaluation for the entire range, plus the
    ``storage_specs`` grid proved at every pair (e.g. a subnet's nonce slot
    tracked across the range). ``match_backend`` runs the unfused mask and
    the slot keccaks; it defaults to ``get_backend("gpu")``, the card
    (raises without CUDA); pass ``get_backend("gpu", device="cpu")`` for the
    plain versions.

    ``scan_workers > 0`` runs the Python scan (a store without a raw map:
    RPC, the fetch plane, the disk tier) over a thread pool, so block
    fetches of different pairs overlap."""
    if match_backend is None:
        match_backend = get_backend("gpu")
    metrics = metrics if metrics is not None else Metrics()
    matcher = EventMatcher(spec.event_signature, spec.topic_1)
    cached = CachedBlockstore(store)
    matching_per_pair, native_ok = _scan_and_match(
        cached, pairs, spec, matcher, match_backend, metrics, scan_workers=scan_workers
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

    with metrics.stage("range_record"), metrics.stage("range_materialize"):
        blocks = _materialize_witness(cached, witness_bytes, fallback_blocks)
    return UnifiedProofBundle(
        storage_proofs=storage_proofs, event_proofs=event_proofs, blocks=blocks
    )


def _storage_for_pairs(
    cached: Blockstore,
    pairs: Sequence[TipsetPair],
    storage_specs: Sequence[MappingSlotSpec],
    hash_backend,
    slots: "Optional[Sequence[bytes]]" = None,
) -> "tuple[list, set[bytes], list[ProofBlock]]":
    """Prove every storage spec at every pair, claims in (pair, spec) order,
    slot digests hashed once for the whole range (``slots`` carries them
    when the pipelined driver proves chunk by chunk). Returns ``(proofs,
    witness_cid_bytes, fallback_blocks)``: the batched generator gives raw
    CID bytes for the shared end-of-bundle materialization; the per-pair
    scalar batches of the pure-Python universe give materialized blocks."""
    if slots is None:
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
    match_call=None,
    native_threads: "int | None" = None,
    scan_workers: int = 0,
) -> "tuple[list[list[int]], bool]":
    """Phases A+B: scan every pair's receipts/events, run the match
    predicate; return (matching receipt indices per pair, whether the
    native scan ran — the record phase then uses the same fast block
    access).

    ``match_call`` stands in for ``match_backend.event_match_mask_fp`` on
    the unfused path (the pipelined driver passes a
    `parallel.pipeline.MatchCoalescer`, so concurrent chunks share one call
    on the card). ``native_threads`` caps the native scanner's per-call
    pthread fan-out (the caller's share of the process thread budget)."""
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
                cached, roots, matcher.topic0, matcher.topic1, spec.actor_id_filter,
                threads=native_threads,
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
            scan_batch = scan_events_flat(cached, roots, threads=native_threads)
        if scan_batch is None:
            if scan_workers > 0:
                with ThreadPoolExecutor(max_workers=scan_workers) as pool:
                    scans = list(pool.map(lambda r: scan_receipt_events(cached, r), roots))
            else:
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
            fp_call = match_call if match_call is not None else match_backend.event_match_mask_fp
            mask = fp_call(
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


# --------------------------------------------------------------------------
# chunked, pipelined and generate ∥ verify drivers
# --------------------------------------------------------------------------


def _offer_chunk_spine(store, chunk) -> None:
    """Offer a chunk's tipset header CIDs to a fetch plane as speculative
    wants before its scan needs them: the plane batch-fetches the headers
    and chases their links while earlier chunks still record. A no-op
    against stores without a plane underneath."""
    offer = getattr(store, "offer_links", None)
    if offer is None:
        return
    links: list = []
    for pair in chunk:
        links.extend(pair.parent.cids)
        links.extend(pair.child.cids)
    if links:
        offer(links)


def _request_spec_repr(spec: EventProofSpec, chunk_size: int, storage_specs) -> bytes:
    """Byte identity of one range request for checkpoint keying.

    Checkpoints are only valid for the exact request that wrote them: the
    digest covers the event spec, storage specs and chunk size, so a re-run
    with different specs regenerates instead of resuming stale bundles. The
    same bytes as the reference's, so the two packages' checkpoints and
    journals are interchangeable.
    """
    return repr(
        (
            spec.event_signature,
            spec.topic_1,
            spec.actor_id_filter,
            chunk_size,
            [(s.actor_id, s.key32().hex(), s.slot_index) for s in (storage_specs or [])],
        )
    ).encode()


def _chunk_checkpoint_digest(spec_repr: bytes, chunk) -> str:
    """Digest of (request identity, chunk tipset identity): a chunk of a
    DIFFERENT epoch range never resumes from a shared checkpoint dir."""
    h = hashlib.sha256(spec_repr)
    for pair in chunk:
        for cid in pair.parent.cids:
            h.update(cid.to_bytes())
        for cid in pair.child.cids:
            h.update(cid.to_bytes())
    return h.hexdigest()[:12]


def _checkpoint_path(checkpoint_dir: "str | None", digest: "str | None", index: int) -> "str | None":
    if checkpoint_dir is None:
        return None
    return os.path.join(checkpoint_dir, f"chunk_{digest}_{index:04d}.json")


def _write_checkpoint(path: str, bundle: UnifiedProofBundle) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        fh.write(bundle.to_json())
    os.replace(tmp, path)  # atomic: partial writes never count


def _read_checkpoint(path: str) -> UnifiedProofBundle:
    with open(path) as fh:
        return UnifiedProofBundle.from_json(fh.read())


def _open_job(job_dir: "str | None", spec_repr: bytes, pairs, chunk_size: int, metrics):
    if job_dir is None:
        return None
    from ipc_proofs_tpu_torch.jobs import job_manifest, resume_or_create

    return resume_or_create(job_dir, job_manifest(spec_repr, pairs, chunk_size), metrics=metrics)


def generate_event_proofs_for_range_chunked(
    store: Blockstore,
    pairs: Sequence[TipsetPair],
    spec: EventProofSpec,
    chunk_size: int,
    checkpoint_dir: "str | None" = None,
    match_backend=None,
    metrics: Optional[Metrics] = None,
    storage_specs=None,
    scan_workers: int = 0,
    generate_fn=None,
    on_chunk=None,
    job_dir: "str | None" = None,
) -> UnifiedProofBundle:
    """Chunked, resumable range generation.

    Splits ``pairs`` into chunks of ``chunk_size``; each finished chunk's
    bundle is written to ``checkpoint_dir/chunk_<digest>_<NNNN>.json`` and
    skipped on re-run. The merged bundle deduplicates witness blocks across
    chunks. ``storage_specs`` prove at every pair of every chunk and ride
    the same checkpoints.

    ``generate_fn`` overrides the per-chunk generator (the signature of
    `generate_event_proofs_for_range` without ``scan_workers``; the CLI
    passes the pipelined driver, whose chunk bundles carry their storage
    proofs here, as the checkpoints are written by this driver).
    ``scan_workers`` goes to the default generator. ``on_chunk(bundle)`` is
    called with every chunk bundle as it becomes available (generated OR
    resumed).

    ``job_dir`` adds write-ahead journaling (`jobs`): each completed chunk
    commits one fsync'd journal record, and a re-run with the same job dir
    resumes from the last committed chunk even after SIGKILL mid-write
    (torn tails are discarded). Checkpoint hits are re-committed into the
    journal so either artifact alone can resume the run. The pipelined
    driver writes the same files with event proofs only (its storage items
    re-prove on every run), so with ``storage_specs`` a resumed chunk that
    lacks its ``len(chunk) × len(storage_specs)`` storage proofs raises
    ValueError rather than drop them from the merged bundle.

    ``match_backend`` defaults to ``get_backend("gpu")``, the card (raises
    without CUDA).
    """
    if match_backend is None:
        match_backend = get_backend("gpu")
    metrics = metrics if metrics is not None else Metrics()
    if checkpoint_dir is not None:
        os.makedirs(checkpoint_dir, exist_ok=True)
    spec_repr = _request_spec_repr(spec, chunk_size, storage_specs)
    job = _open_job(job_dir, spec_repr, pairs, chunk_size, metrics)

    storage_proofs: list = []
    event_proofs: list = []
    all_blocks: "set[ProofBlock]" = set()
    try:
        for chunk_index, start in enumerate(range(0, len(pairs), chunk_size)):
            # chunk boundary = cancellation/deadline boundary: committed
            # chunks stay in the checkpoint/journal for a re-run to resume
            checkpoint("range.chunk")
            chunk = pairs[start : start + chunk_size]
            digest = (
                _chunk_checkpoint_digest(spec_repr, chunk)
                if (checkpoint_dir is not None or job is not None)
                else None
            )
            path = _checkpoint_path(checkpoint_dir, digest, chunk_index)
            if job is not None and job.has_chunk(chunk_index):
                bundle = UnifiedProofBundle.from_json_obj(job.bundle_obj(chunk_index, digest))
                _require_storage(bundle, chunk, storage_specs, chunk_index)
                metrics.count("range_chunks_resumed")
            elif path is not None and os.path.exists(path):
                bundle = _read_checkpoint(path)
                _require_storage(bundle, chunk, storage_specs, chunk_index)
                metrics.count("range_chunks_resumed")
                if job is not None:  # a checkpoint hit the journal missed
                    job.commit_chunk(chunk_index, digest, bundle)
            else:
                _offer_chunk_spine(store, chunk)
                _offer_chunk_spine(store, pairs[start + chunk_size : start + 2 * chunk_size])
                if generate_fn is not None:
                    bundle = generate_fn(
                        store, chunk, spec, match_backend=match_backend, metrics=metrics,
                        storage_specs=storage_specs,
                    )
                else:
                    bundle = generate_event_proofs_for_range(
                        store, chunk, spec, match_backend=match_backend, metrics=metrics,
                        storage_specs=storage_specs, scan_workers=scan_workers,
                    )
                if path is not None:
                    _write_checkpoint(path, bundle)
                if job is not None:
                    job.commit_chunk(chunk_index, digest, bundle)
                metrics.count("range_chunks_generated")
            if on_chunk is not None:
                on_chunk(bundle)
            storage_proofs.extend(bundle.storage_proofs)
            event_proofs.extend(bundle.event_proofs)
            all_blocks.update(bundle.blocks)
    finally:
        if job is not None:
            job.close()

    return UnifiedProofBundle(
        storage_proofs=storage_proofs,
        event_proofs=event_proofs,
        blocks=sorted(all_blocks, key=lambda b: b.cid.to_bytes()),
    )


def _require_storage(bundle, chunk, storage_specs, chunk_index: int) -> None:
    """A resumed chunk must carry the storage proofs the request asks for:
    the pipelined driver's files hold event proofs only."""
    want = len(chunk) * len(storage_specs or ())
    if len(bundle.storage_proofs) < want:
        raise ValueError(
            f"resumed chunk {chunk_index} holds {len(bundle.storage_proofs)} storage proofs, "
            f"the request needs {want}: it was written by the pipelined driver, which "
            "checkpoints and journals event proofs only; resume it with that driver"
        )


_SKIP = object()
"""Merge-stage sentinel: "folded; nothing for the verify stage"."""


class _MergeFold:
    """Merge-on-arrival accumulator for the pipelined driver.

    The merge stage folds each chunk's output the moment the ordered
    emitter delivers it (input order), materializing only the CIDs no
    earlier chunk already contributed, so the step after the pipeline is one
    final sort over already-materialized blocks.

    Byte identity with one range-wide materialization holds by
    construction: the store is content-addressed (one CID ⇒ one byte
    string), the per-chunk ``todo`` sets partition exactly the CID set a
    single pass would cover, and `finish` emits the same canonical
    CID-byte-sorted order.

    The merge stage runs one worker, but the accumulator is lock-guarded
    all the same: the driver thread reads the proof counts after the
    pipeline drains, and the serial fallback folds from the caller thread.
    """

    def __init__(self, cached: Blockstore, metrics: Metrics):
        self._cached = cached
        self._metrics = metrics
        self._lock = named_lock("_MergeFold._lock")
        self.event_proofs: list = []  # guarded-by: _lock
        self.storage_proofs: list = []  # guarded-by: _lock
        self._by_cid: "dict[bytes, ProofBlock]" = {}  # guarded-by: _lock

    def fold(self, proofs, witness_bytes, extra_blocks, storage: bool = False) -> None:
        """Fold one chunk's output: proofs concatenate in arrival order,
        materialized ``extra_blocks`` register by CID bytes, and only the
        not-yet-seen ``witness_bytes`` CIDs materialize from the store."""
        with self._lock:
            (self.storage_proofs if storage else self.event_proofs).extend(proofs)
            for block in extra_blocks:
                self._by_cid.setdefault(block.cid.to_bytes(), block)
            todo = set(witness_bytes) - self._by_cid.keys()
            if todo:
                with self._metrics.stage("range_materialize"):
                    for block in _materialize_witness(self._cached, todo):
                        self._by_cid.setdefault(block.cid.to_bytes(), block)

    def finish(self) -> UnifiedProofBundle:
        """One final CID-byte sort over the materialized union."""
        with self._lock:
            return UnifiedProofBundle(
                storage_proofs=self.storage_proofs,
                event_proofs=self.event_proofs,
                blocks=[self._by_cid[k] for k in sorted(self._by_cid)],
            )

    @property
    def n_event_proofs(self) -> int:
        with self._lock:
            return len(self.event_proofs)

    @property
    def n_storage_proofs(self) -> int:
        with self._lock:
            return len(self.storage_proofs)


def generate_event_proofs_for_range_pipelined(
    store: Blockstore,
    pairs: Sequence[TipsetPair],
    spec: EventProofSpec,
    chunk_size: int = 512,
    match_backend=None,
    metrics: Optional[Metrics] = None,
    storage_specs=None,
    scan_threads: "int | None" = None,
    pipeline_depth: int = 2,
    verify_chunk=None,
    verify_results: "list | None" = None,
    checkpoint_dir: "str | None" = None,
    scan_retries: int = 2,
    force_pipeline: "bool | None" = None,
    job_dir: "str | None" = None,
    record_workers: "int | None" = None,
    verify_workers: "int | None" = None,
    threads: "int | None" = None,
) -> UnifiedProofBundle:
    """Stage-overlapped range generation on the bounded-queue executor
    (`parallel.pipeline.run_pipeline`): chunks flow scan+match → record →
    merge → optional verify with at most ``pipeline_depth`` chunks buffered
    between stages. Every stage except merge runs several workers. The
    shared thread budget (`utils.threads.resolve_thread_budget`:
    ``threads`` > ``IPC_THREADS`` > ``scan_threads`` > ``IPC_SCAN_THREADS``
    > CPU affinity) partitions into scan/record/verify workers plus the
    native scanner's per-call pthread fan-out, so ``scan_workers ×
    native_scan_threads`` never exceeds the budget; ``record_workers`` /
    ``verify_workers`` override their shares.

    Record is chunk-local (no shared state), and the single-worker merge
    stage folds outputs in input order (`_MergeFold`). Storage specs prove
    chunk by chunk as tagged items of the SAME pipeline (slot keccaks
    hashed once up front, on the card), so storage proving overlaps the
    event scan/record. With several scan workers on the unfused path
    (``IPC_SCAN_FUSED_MATCH=0``), their fingerprint-mask calls coalesce
    into fewer, larger calls on the card (`parallel.pipeline.MatchCoalescer`)
    with the same masks.

    The bundle is byte-identical to the chunked driver's over the same
    chunking for ANY worker/depth/chunk-size combination: the ordered
    emitter hands the merge stage chunk outputs in input order. A worker
    exception cancels pending work and re-raises here; no stage swallows a
    failure.

    **Single-core fallback:** where ``os.cpu_count() == 1`` the driver runs
    the same stage functions inline per chunk (counted as
    ``range_pipeline_serial_fallback``), as the reference does;
    ``force_pipeline=True`` (or ``IPC_FORCE_PIPELINE=1``) keeps the
    threaded pipeline.

    ``verify_chunk(bundle) -> result`` makes the record stage emit a
    self-contained bundle per chunk (its witness covers exactly its
    proofs) for the verify stage; results append to ``verify_results`` in
    chunk order. Storage proofs appear only in the merged bundle.

    ``checkpoint_dir`` makes the run resumable with the per-chunk files of
    `generate_event_proofs_for_range_chunked` (the same names and
    digests): finished chunks load from disk in the record stage and new
    chunk bundles are written atomically. ``scan_retries`` bounds re-scans
    of a chunk after a transient store error (``ConnectionError``,
    ``TimeoutError``, ``OSError``, `IntegrityError`, an endpoint pool's
    `DegradedError`, or a ``RuntimeError`` raised from one of them, as a
    client's exhausted retries are: `store.failover.is_store_error`; a
    scan is a pure read), after a backoff that spans the pool's breaker
    window. Anything else fails fast: an `RpcError`, and a kernel failure
    (the ``RuntimeError`` of a refused launch or of PyTorch's CUDA calls)
    in the unfused scan's fingerprint mask.

    ``job_dir`` journals every completed chunk (`jobs`): one fsync'd
    write-ahead record each, so a SIGKILL at ANY byte resumes to a
    byte-identical bundle. Concurrent record workers may commit out of
    index order; `jobs.RangeJob` serializes the appends. On a worker
    failure the journaling stage's queued inputs are drained
    (`PipelineStage.drain_on_cancel`) before the exception re-raises.

    ``match_backend`` defaults to ``get_backend("gpu")``, the card (raises
    without CUDA). Its kernels are built before the pipeline starts, so no
    worker compiles; every launch goes to its thread's current stream.
    """
    from ipc_proofs_tpu_torch.parallel.pipeline import (
        MatchCoalescer,
        PipelineStage,
        run_pipeline,
    )

    if match_backend is None:
        match_backend = get_backend("gpu")
    metrics = metrics if metrics is not None else Metrics()
    matcher = EventMatcher(spec.event_signature, spec.topic_1)
    cached = CachedBlockstore(store)
    chunks = [pairs[k : k + chunk_size] for k in range(0, len(pairs), chunk_size)]
    budget = resolve_thread_budget(threads=threads, scan_threads=scan_threads)
    scan_workers = budget.scan_workers
    rec_workers = max(1, int(record_workers)) if record_workers else budget.record_workers
    ver_workers = max(1, int(verify_workers)) if verify_workers else budget.verify_workers
    if force_pipeline is None:
        force_pipeline = os.environ.get("IPC_FORCE_PIPELINE", "") == "1"
    serial_fallback = (os.cpu_count() or 1) == 1 and not force_pipeline

    spec_repr = None
    if checkpoint_dir is not None or job_dir is not None:
        spec_repr = _request_spec_repr(spec, chunk_size, storage_specs)
    if checkpoint_dir is not None:
        os.makedirs(checkpoint_dir, exist_ok=True)
    job = _open_job(job_dir, spec_repr, pairs, chunk_size, metrics)

    def _chunk_digest(chunk) -> "str | None":
        return None if spec_repr is None else _chunk_checkpoint_digest(spec_repr, chunk)

    def _ckpt_path(index: int, chunk) -> "str | None":
        return _checkpoint_path(checkpoint_dir, _chunk_digest(chunk), index)

    # verify/checkpoint/journal mode materializes self-contained per-chunk
    # bundles; the shared-witness path needs none of them
    per_chunk_bundles = verify_chunk is not None or checkpoint_dir is not None or job is not None

    warm = getattr(match_backend, "warm", None)
    if warm is not None:
        warm()  # build the kernels now: no worker compiles

    storage_slots = None
    if storage_specs:
        # one keccak batch covers every chunk's storage leg
        with metrics.stage("range_storage"):
            storage_slots = hash_slot_specs(storage_specs, match_backend)

    fold = _MergeFold(cached, metrics)
    match_call = None
    if not serial_fallback and scan_workers > 1:
        match_call = MatchCoalescer(match_backend, metrics=metrics).match_fp

    def _scan(item):
        kind, index, chunk = item
        if kind == "storage":
            return item  # storage proves in the record stage; nothing to scan
        if job is not None and job.has_chunk(index):
            return kind, index, chunk, None  # journal-committed: record replays it
        path = _ckpt_path(index, chunk)
        if path is not None and os.path.exists(path):
            return kind, index, chunk, None  # resumed: record loads it from disk
        _offer_chunk_spine(cached, chunk)
        attempt = 0
        while True:
            try:
                # _scan_and_match times itself (range_scan / range_match)
                return kind, index, chunk, _scan_and_match(
                    cached, chunk, spec, matcher, match_backend, metrics,
                    match_call=match_call, native_threads=budget.native_scan_threads,
                )
            except RpcError:
                raise  # a semantic protocol error: retrying re-asks the same question
            except Exception as exc:  # not fail-soft: store errors retry below, anything else re-raises
                # store errors only (a pool's lotus_down `DegradedError` and a
                # client's exhausted retries included): a kernel failure on
                # the card raises a RuntimeError of its own, not retried
                if not is_store_error(exc):
                    raise
                attempt += 1
                if attempt > max(0, scan_retries):
                    raise
                metrics.count("range_scan_retries")
                logger.warning(
                    "scan of chunk %d failed (%s) — retry %d/%d", index, exc, attempt, scan_retries
                )
                # back off before rescanning; a deadline that cannot cover
                # the wait re-raises now instead of sleeping past it
                delay = min(0.05 * (2.0 ** (attempt - 1)), 0.5)  # ipclint: disable=det-float (retry backoff is wall-clock, not a proof value)
                remaining = remaining_budget_s()
                if remaining is not None and remaining <= delay:
                    raise
                checkpoint("range.scan_retry")
                time.sleep(delay)

    def _record(scanned):
        # chunk-local: every branch returns a tagged tuple for the merge
        # stage and touches NO shared accumulator, so the stage can run
        # several workers and stay byte-identical
        if scanned[0] == "storage":
            _, index, chunk = scanned
            with metrics.stage("range_storage"):
                proofs, witness, blocks = _storage_for_pairs(
                    cached, chunk, storage_specs, match_backend, slots=storage_slots
                )
            metrics.count("range_storage_proofs", len(proofs))
            return "storage", proofs, witness, blocks
        _, index, chunk, scan_out = scanned
        path = _ckpt_path(index, chunk)
        if scan_out is None:
            with metrics.stage("range_record"):
                if job is not None and job.has_chunk(index):
                    bundle = UnifiedProofBundle.from_json_obj(
                        job.bundle_obj(index, _chunk_digest(chunk))
                    )
                else:
                    bundle = _read_checkpoint(path)
                metrics.count("range_chunks_resumed")
            return "bundle", index, chunk, bundle, False  # already journaled
        matching_per_pair, native_ok = scan_out
        with metrics.stage("range_record"):
            proofs, chunk_witness, chunk_fallback = _record_chunk(
                cached, chunk, matching_per_pair, matcher, spec, native_ok
            )
            if not per_chunk_bundles:
                return "chunk", proofs, chunk_witness, chunk_fallback
            # a self-contained chunk bundle, to verify off-thread or persist
            with metrics.stage("range_materialize"):
                blocks = _materialize_witness(cached, chunk_witness, chunk_fallback)
            bundle = UnifiedProofBundle(storage_proofs=[], event_proofs=proofs, blocks=blocks)
            if path is not None:
                _write_checkpoint(path, bundle)
            if path is not None or job is not None:
                metrics.count("range_chunks_generated")
            if job is not None and verify_chunk is None:
                # no verify stage: the record stage IS the commit point
                job.commit_chunk(index, _chunk_digest(chunk), bundle)
        return "bundle", index, chunk, bundle, True

    def _merge(recorded):
        kind = recorded[0]
        with metrics.stage("range_merge"):
            if kind in ("storage", "chunk"):
                _, proofs, witness, blocks = recorded
                fold.fold(proofs, witness, blocks, storage=kind == "storage")
                return _SKIP
            _, index, chunk, bundle, fresh = recorded
            fold.fold(bundle.event_proofs, (), bundle.blocks)
        if verify_chunk is not None:
            return index, chunk, bundle, fresh
        return _SKIP

    stages = [
        PipelineStage("scan", _scan, workers=scan_workers),
        # with a journal and no verify stage, record is the commit point:
        # drain its queue on abort so finished scans still journal
        PipelineStage(
            "record", _record, workers=rec_workers,
            drain_on_cancel=job is not None and verify_chunk is None,
        ),
        PipelineStage("merge", _merge),
    ]
    stage_fns = [_scan, _record, _merge]
    if verify_chunk is not None:

        def _verify(recorded):
            if recorded is _SKIP:
                return _SKIP  # a storage item or a folded chunk: nothing to replay
            index, chunk, bundle, fresh = recorded
            with metrics.stage("range_verify"):
                result = verify_chunk(bundle)
            if job is not None and fresh:
                # chunk + verdict in ONE record; resumed chunks re-verify
                # but do not re-commit
                job.commit_chunk(index, _chunk_digest(chunk), bundle, verify=_verdict_obj(result))
            return result

        stages.append(
            PipelineStage("verify", _verify, workers=ver_workers, drain_on_cancel=job is not None)
        )
        stage_fns.append(_verify)

    # storage items interleave with their event chunk, so both legs of
    # chunk k are in flight together; merge still folds in input order
    items: list = []
    for index, chunk in enumerate(chunks):
        items.append(("event", index, chunk))
        if storage_specs:
            items.append(("storage", index, chunk))
    try:
        if items:
            if serial_fallback:
                metrics.count("range_pipeline_serial_fallback")
                results = []
                for item in items:
                    checkpoint("range.chunk")  # the threaded stages' boundary
                    out = item
                    for fn in stage_fns:
                        out = fn(out)
                    results.append(out)
            else:
                results = run_pipeline(items, stages, depth=max(1, pipeline_depth))
            if verify_chunk is not None and verify_results is not None:
                verify_results.extend(r for r in results if r is not _SKIP)
        metrics.count("range_proofs", fold.n_event_proofs)
        with metrics.stage("range_merge"):
            return fold.finish()
    finally:
        if job is not None:
            job.close()


def generate_and_verify_range_overlapped(
    store: Blockstore,
    pairs: Sequence[TipsetPair],
    spec: EventProofSpec,
    chunk_size: int,
    verify_chunk,
    match_backend=None,
    metrics: Optional[Metrics] = None,
    storage_specs=None,
    scan_threads: "int | None" = None,
    pipeline_depth: int = 2,
    checkpoint_dir: "str | None" = None,
    scan_retries: int = 2,
    force_pipeline: "bool | None" = None,
    job_dir: "str | None" = None,
    record_workers: "int | None" = None,
    verify_workers: "int | None" = None,
    threads: "int | None" = None,
) -> "tuple[UnifiedProofBundle, list]":
    """Overlap verification with generation across chunks: chunk k's bundle
    verifies (the witness CID recompute and the replay's TxMeta recompute
    on the card) while chunks k+1… scan and record on the host.

    Scan ∥ record ∥ merge ∥ verify run in ONE bounded-queue executor
    (`generate_event_proofs_for_range_pipelined` with its verify stage);
    storage specs flow through the same pipeline. (The reference also
    takes a ``generate_fn`` that composes over the chunked driver; the
    port adds it with the CLI that calls it.)

    ``verify_chunk(bundle) -> result`` is the caller's verification closure;
    per-chunk results come back in chunk order. Each chunk bundle is
    self-contained, so the per-chunk verdicts equal whole-bundle
    verification verdict for verdict, and the merged bundle is
    byte-identical to the chunked driver's over the same ``chunk_size``.
    ``match_backend`` defaults to the card, as the other drivers.
    """
    verify_results: list = []
    merged = generate_event_proofs_for_range_pipelined(
        store, pairs, spec, chunk_size=chunk_size, match_backend=match_backend,
        metrics=metrics, storage_specs=storage_specs, scan_threads=scan_threads,
        pipeline_depth=pipeline_depth, verify_chunk=verify_chunk,
        verify_results=verify_results, checkpoint_dir=checkpoint_dir,
        scan_retries=scan_retries, force_pipeline=force_pipeline, job_dir=job_dir,
        record_workers=record_workers, verify_workers=verify_workers, threads=threads,
    )
    return merged, verify_results


def _verdict_obj(result):
    """JSON projection of a caller's verify verdict for the journal record
    (informational: resumed chunks re-verify live)."""
    try:
        json.dumps(result)
        return result
    except (TypeError, ValueError):
        return repr(result)
