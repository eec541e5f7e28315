"""Blockstores: the content-addressed storage boundary, the Lotus RPC
client and the fetch plane.

The counterpart of ``ipc_proofs_tpu.store`` (the endpoint pool of
``store/failover.py`` is not ported yet).
"""

from ipc_proofs_tpu_torch.store.blockstore import (
    BlockCache,
    Blockstore,
    CachedBlockstore,
    MemoryBlockstore,
    RecordingBlockstore,
)
from ipc_proofs_tpu_torch.store.faults import (
    FaultPlan,
    FaultyBlockstore,
    FaultySession,
    LocalLotusSession,
)
from ipc_proofs_tpu_torch.store.fetchplane import FetchPlane, PlaneBlockstore
from ipc_proofs_tpu_torch.store.rpc import (
    IntegrityError,
    LotusClient,
    RpcBlockstore,
    RpcError,
    verify_block_bytes,
)

__all__ = [
    "Blockstore",
    "MemoryBlockstore",
    "RecordingBlockstore",
    "CachedBlockstore",
    "BlockCache",
    "LotusClient",
    "RpcBlockstore",
    "RpcError",
    "IntegrityError",
    "verify_block_bytes",
    "FetchPlane",
    "PlaneBlockstore",
    "FaultPlan",
    "FaultySession",
    "FaultyBlockstore",
    "LocalLotusSession",
]
