"""Scatter partitioning + byte-identical merge of per-shard range bundles.

The canonical range bundle (what every range driver in
``proofs/range.py`` emits, and what the chunk-grid bit-identity tests
pin) is:

- **event proofs** in pair order — pair ``i``'s proofs before pair
  ``i+1``'s, each pair's proofs in deterministic scan order;
- **storage proofs** likewise in pair order;
- **witness blocks** deduplicated by CID and sorted by
  ``cid.to_bytes()`` (the ``_MergeFold.finish()`` / chunked-driver
  ordering).

Because each pair's proof bytes depend only on that pair, and the
witness-block *set* depends only on the pair set, a range request split
across N shards in ANY partition merges back to the exact bytes the
single-daemon run produces: re-interleave the proofs into the request's
global pair order (a proof names its pair via ``child_block_cid``) and
re-sort the CID-union of the witness blocks. That is the whole
correctness story of the scatter-gather path — no shard coordination,
no merge ambiguity, bit-identity by construction.

`BundleFold` is the incremental form: the router folds each shard's
sub-bundle into ONE CID-keyed map as its future completes and sorts the
union exactly once at `seal()` (``witness.merge_sorts`` counts seals, so
the bench can prove one sort per scatter rather than one per arrival).
`merge_range_bundles` stays as the fold-everything-then-seal wrapper.
The witness plane's cross-request aggregation
(`ipc_proofs_tpu_torch/witness/aggregate.py`) layers per-claim spans over the
same canonical bundle — this module owns the merge law, that one the
claim table.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from ipc_proofs_tpu_torch.core.cid import CID
from ipc_proofs_tpu_torch.proofs.bundle import ProofBlock, UnifiedProofBundle
from ipc_proofs_tpu_torch.utils.metrics import Metrics, get_metrics

__all__ = [
    "BundleFold",
    "MergeConflictError",
    "merge_range_bundles",
    "partition_indexes",
]


class MergeConflictError(ValueError):
    """Two shards shipped different bytes for the same witness CID — one
    of them is lying or corrupt. Never silently picks a side."""


def partition_indexes(
    indexes: Sequence[int], assign: Dict[int, str]
) -> "Dict[str, List[int]]":
    """Group request pair-indexes by their assigned shard, preserving the
    request's relative order inside each group (``assign`` maps pair index
    → shard name; the router builds it from the hash ring + steal state).
    """
    groups: "Dict[str, List[int]]" = {}
    for idx in indexes:
        groups.setdefault(assign[idx], []).append(idx)
    return groups


class BundleFold:
    """Incremental canonical merge: fold sub-bundles as they arrive, sort
    the witness-CID union ONCE at seal.

    ``pairs`` is the full pair table; ``indexes`` the requested global
    pair indexes in request order (the order the single-daemon comparator
    would generate them in). Every proof in every folded bundle must map
    to one of ``indexes`` via its ``child_block_cid``.
    """

    def __init__(
        self,
        pairs: Sequence,
        indexes: Sequence[int],
        metrics: Optional[Metrics] = None,
    ):
        self._metrics = metrics if metrics is not None else get_metrics()
        self.indexes = list(indexes)
        # child block CID -> global pair index (a child block cid identifies
        # its pair — the same mapping the micro-batcher splits batches with)
        self._child_to_idx: "Dict[str, int]" = {}
        for idx in self.indexes:
            for c in pairs[idx].child.cids:
                self._child_to_idx[str(c)] = idx
        self._event_buckets: "Dict[int, list]" = {i: [] for i in self.indexes}
        self._storage_buckets: "Dict[int, list]" = {i: [] for i in self.indexes}
        self._by_cid: "Dict[bytes, ProofBlock]" = {}
        self._sealed = False

    def fold(self, bundle: UnifiedProofBundle) -> "List[ProofBlock]":
        """Fold one sub-bundle: bucket its proofs by pair, union its
        witness blocks into the single CID map (conflict-checked, never
        sorted here — sorting N times over an ever-growing map is the
        quadratic arrival cost `seal()` exists to avoid).

        Returns the blocks this fold saw for the FIRST time, in the
        sub-bundle's order — the streamed door sends exactly these as
        ``B`` chunks, so a block shared by several shards' sub-bundles
        crosses the client wire once even though each shard shipped it.
        """
        if self._sealed:
            raise RuntimeError("BundleFold already sealed")
        for proof in bundle.event_proofs:
            idx = self._child_to_idx.get(proof.child_block_cid)
            if idx is None:
                raise MergeConflictError(
                    f"event proof for unknown child block "
                    f"{proof.child_block_cid} (not in this request)"
                )
            self._event_buckets[idx].append(proof)
        for proof in bundle.storage_proofs:
            idx = self._child_to_idx.get(proof.child_block_cid)
            if idx is None:
                raise MergeConflictError(
                    f"storage proof for unknown child block "
                    f"{proof.child_block_cid} (not in this request)"
                )
            self._storage_buckets[idx].append(proof)
        fresh: "List[ProofBlock]" = []
        for block in bundle.blocks:
            raw = block.cid.to_bytes()
            prior = self._by_cid.get(raw)
            if prior is None:
                self._by_cid[raw] = block
                fresh.append(block)
            elif prior.data != block.data:
                raise MergeConflictError(
                    f"witness block {block.cid} has conflicting bytes "
                    "across shards"
                )
        return fresh

    def fold_block(self, cid_raw: bytes, data: bytes) -> bool:
        """Fold ONE raw witness block — the cut-through relay's door: a
        shard's ``B`` chunk folds the moment it arrives, without ever
        materializing that shard's sub-bundle. Returns True on first
        sight (exactly the blocks the relay forwards downstream, so the
        dedup guarantee of `fold` holds chunk-by-chunk); conflicting
        bytes for a seen CID raise `MergeConflictError`, same law as
        whole-bundle folding."""
        if self._sealed:
            raise RuntimeError("BundleFold already sealed")
        raw = bytes(cid_raw)
        prior = self._by_cid.get(raw)
        if prior is None:
            self._by_cid[raw] = ProofBlock(cid=CID.from_bytes(raw), data=data)
            return True
        if prior.data != data:
            raise MergeConflictError(
                f"witness block {CID.from_bytes(raw)} has conflicting bytes "
                "across shards"
            )
        return False

    def seal(self) -> UnifiedProofBundle:
        """One canonical sort over the folded CID union → the exact
        single-daemon bytes. Counted (``witness.merge_sorts``) so tests
        and the bench can assert one sort per scatter."""
        if self._sealed:
            raise RuntimeError("BundleFold already sealed")
        self._sealed = True
        self._metrics.count("witness.merge_sorts")
        by_cid = self._by_cid
        return UnifiedProofBundle(
            storage_proofs=[
                p for idx in self.indexes for p in self._storage_buckets[idx]
            ],
            event_proofs=[
                p for idx in self.indexes for p in self._event_buckets[idx]
            ],
            blocks=[by_cid[raw] for raw in sorted(by_cid)],
        )


def merge_range_bundles(
    bundles: Sequence[UnifiedProofBundle],
    pairs: Sequence,
    indexes: Sequence[int],
    metrics: Optional[Metrics] = None,
) -> UnifiedProofBundle:
    """Merge per-shard sub-bundles into the canonical single-daemon bundle
    (the all-at-once wrapper over `BundleFold`)."""
    fold = BundleFold(pairs, indexes, metrics=metrics)
    for bundle in bundles:
        fold.fold(bundle)
    return fold.seal()
