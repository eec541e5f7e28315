"""Sharded serve plane: consistent-hash router over N full serve daemons.

The counterpart of ``ipc_proofs_tpu.cluster``, with its whole ``__all__``.
The cluster scales the serve plane horizontally without weakening any
single-daemon guarantee, because a shard IS a complete serve daemon
(micro-batching, bounded admission, durable-queue crash recovery, tiered
disk store, its kernels on its service's one `GpuBackend`) and the router
adds only placement; the router itself is host code and launches nothing:

- `hashring.py` — deterministic sha256 consistent hashing of pair keys
  onto shard names (vnodes; affinity = cache hint, never correctness);
- `shard.py`    — shard lifecycle: in-process `LocalShard` for tests,
  `spawn_serve_shard` subprocess children for real parallelism,
  `RemoteShard` for a daemon someone else runs;
- `router.py`   — `ClusterRouter`: steal-aware placement, at-least-once
  failover under stable idempotency keys, scatter-gather ranges, health
  aggregation; `RouterHTTPServer` speaks the single-daemon wire protocol;
- `gather.py`   — the byte-identity merge law: per-shard range bundles
  union back into exactly the single-daemon bundle bytes.

Shards can share one ``--store-dir`` disk tier (per-owner segment files,
flock-coordinated eviction — `storex/segments.py`) and elect one chain
follower (`storex.FollowLeaderLock`). See the ``cluster`` CLI subcommand.
"""

from ipc_proofs_tpu_torch.cluster.gather import (
    BundleFold,
    MergeConflictError,
    merge_range_bundles,
    partition_indexes,
)
from ipc_proofs_tpu_torch.cluster.hashring import HashRing, pair_ring_key
from ipc_proofs_tpu_torch.cluster.router import (
    ClusterRouter,
    NoShardsError,
    RouterHTTPServer,
    ShardClient,
    ShardUnavailable,
)
from ipc_proofs_tpu_torch.cluster.shard import (
    LocalShard,
    RemoteShard,
    SubprocessShard,
    spawn_serve_shard,
)

__all__ = [
    "BundleFold",
    "ClusterRouter",
    "HashRing",
    "LocalShard",
    "MergeConflictError",
    "NoShardsError",
    "RemoteShard",
    "RouterHTTPServer",
    "ShardClient",
    "ShardUnavailable",
    "SubprocessShard",
    "merge_range_bundles",
    "pair_ring_key",
    "partition_indexes",
    "spawn_serve_shard",
]
