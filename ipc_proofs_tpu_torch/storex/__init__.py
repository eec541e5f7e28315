"""storex: tiered content-addressed block storage.

The counterpart of ``ipc_proofs_tpu.storex``: two storage tiers under one
`Blockstore`-shaped wrapper,

- tier 1: the in-memory `BlockCache` (or a plain dict) — hot, per-process;
- tier 2: `SegmentStore` — a disk-resident CID → bytes store in
  append-only segment files with the journal's CRC framing, an in-memory
  offset index rebuilt on open, and byte-capped LRU segment eviction. It
  survives restarts, and its files open in either package.

`ChainFollower` tails finalized tipsets and pre-populates the spine
blocks (headers, receipts-AMT root, state-HAMT root and the rings below
them) before the first request asks, each landed wave verified on the
card; `FollowLeaderLock` elects one follower per shared store directory.

Every disk read is multihash re-verified, so disk corruption is an
availability event (evict + refetch from the inner store), never a
correctness one. The replication plane (``replica``) copies whole segment
files between shards and repairs a corrupt frame from a peer.
"""

from ipc_proofs_tpu_torch.storex.follower import ChainFollower, FollowLeaderLock
from ipc_proofs_tpu_torch.storex.segments import SEGMENT_MAGIC, SegmentStore, SegmentStoreError
from ipc_proofs_tpu_torch.storex.replica import (
    RebalanceJob,
    ReplicaClient,
    ReplicaError,
    ReplicaSet,
    Replicator,
)
from ipc_proofs_tpu_torch.storex.tiered import TieredBlockstore

__all__ = [
    "ChainFollower",
    "FollowLeaderLock",
    "RebalanceJob",
    "ReplicaClient",
    "ReplicaError",
    "ReplicaSet",
    "Replicator",
    "SEGMENT_MAGIC",
    "SegmentStore",
    "SegmentStoreError",
    "TieredBlockstore",
]
