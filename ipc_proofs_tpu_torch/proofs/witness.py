"""Witness collection: the set of IPLD blocks a verifier will need.

`WitnessCollector` accumulates CIDs, drains `RecordingBlockstore`s, and
materializes to `ProofBlock`s by re-fetching bytes (cache hits in
practice); `load_witness_store` loads a bundle's blocks into an isolated
store for offline replay.
"""

from __future__ import annotations

from typing import Iterable

from ipc_proofs_tpu_torch.core.cid import CID
from ipc_proofs_tpu_torch.proofs.bundle import ProofBlock
from ipc_proofs_tpu_torch.store.blockstore import (
    Blockstore,
    MemoryBlockstore,
    RecordingBlockstore,
)

__all__ = ["WitnessCollector", "load_witness_store"]


class WitnessCollector:
    def __init__(self, store: Blockstore):
        self._store = store
        self._needed: set[CID] = set()

    def add_cid(self, cid: CID) -> None:
        self._needed.add(cid)

    def collect_from_recording(self, recorder: RecordingBlockstore) -> None:
        self._needed.update(recorder.take_seen())

    def collect_from_recordings(self, recorders: Iterable[RecordingBlockstore]) -> None:
        for recorder in recorders:
            self.collect_from_recording(recorder)

    def needed_cids(self) -> set[CID]:
        """The CIDs collected so far (a copy)."""
        return set(self._needed)

    def materialize(self) -> list[ProofBlock]:
        """Fetch every needed CID's bytes, CID-sorted."""
        blocks = []
        for cid in sorted(self._needed):
            raw = self._store.get(cid)
            if raw is None:
                raise KeyError(f"missing witness block {cid}")
            blocks.append(ProofBlock(cid=cid, data=raw))
        return blocks


def load_witness_store(
    blocks: Iterable[ProofBlock], verify_cids: bool = False
) -> MemoryBlockstore:
    """Load witness blocks into an isolated MemoryBlockstore.

    ``verify_cids=True`` recomputes every CID on load (scalar, on the
    host: for multihashes without a kernel); the batched blake2b-256
    recompute on the card is ``verify_proof_bundle(..., verify_witness_cids=True)``.
    """
    store = MemoryBlockstore(verify_cids=verify_cids)
    if not verify_cids:
        store.put_many_trusted(blocks)
        return store
    for block in blocks:
        store.put_keyed(block.cid, block.data)
    return store
