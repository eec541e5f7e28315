"""Proof provenance plane: hash-linked audit registry + inclusion proofs.

The counterpart of ``ipc_proofs_tpu.registry``: the same IPR1 log files
(each package opens the other's, with the same head) and the same RFC 6962
trees and proofs, sha256 on the host (no kernel computes them). See
`ipc_proofs_tpu_torch.registry.registry` for the full contract. The short
version: every served bundle seals one ``IPR1`` frame into an
append-only, content-addressed log; the log is simultaneously a linear
hash chain (tamper breaks every later link) and an RFC 6962 Merkle tree
(O(1) amortized append, O(log n) inclusion and consistency proofs);
and its records double as the fleet-wide delta base directory.
"""

from ipc_proofs_tpu_torch.registry.log import (
    REGISTRY_MAGIC,
    RegistryError,
    RegistryWriter,
    frame_registry_record,
    read_registry_frames,
    record_digest,
    verify_chain,
)
from ipc_proofs_tpu_torch.registry.mmr import (
    MerkleLog,
    consistency_path,
    inclusion_path,
    leaf_hash,
    merkle_root,
    node_hash,
    verify_consistency,
    verify_inclusion,
)
from ipc_proofs_tpu_torch.registry.registry import ProvenanceRegistry

__all__ = [
    "MerkleLog",
    "ProvenanceRegistry",
    "REGISTRY_MAGIC",
    "RegistryError",
    "RegistryWriter",
    "consistency_path",
    "frame_registry_record",
    "inclusion_path",
    "leaf_hash",
    "merkle_root",
    "node_hash",
    "read_registry_frames",
    "record_digest",
    "verify_chain",
    "verify_consistency",
    "verify_inclusion",
]
