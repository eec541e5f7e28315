"""Placement and the merge law of the sharded serve plane.

The counterpart of ``ipc_proofs_tpu.cluster``'s two leaf modules, the
ones the backfill engine stands on:

- `hashring.py` — deterministic sha256 consistent hashing of pair keys
  onto node names (vnodes; affinity = cache hint, never correctness);
- `gather.py`   — the byte-identity merge law: per-window or per-shard
  range bundles union back into exactly the single-daemon bundle bytes
  (`BundleFold`, one sort at seal).

The router and the shards (``cluster/router.py``, ``cluster/shard.py``)
and the CLI's ``cluster`` are not ported yet.
"""

from ipc_proofs_tpu_torch.cluster.gather import (
    BundleFold,
    MergeConflictError,
    merge_range_bundles,
    partition_indexes,
)
from ipc_proofs_tpu_torch.cluster.hashring import HashRing, pair_ring_key

__all__ = [
    "BundleFold",
    "HashRing",
    "MergeConflictError",
    "merge_range_bundles",
    "pair_ring_key",
    "partition_indexes",
]
