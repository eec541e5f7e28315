"""Cryptographic primitives with no external dependencies.

`bls` implements BLS12-381 aggregate signatures for F3 finality-certificate
verification (reference gap: `src/proofs/trust/mod.rs:58,72` leaves
signature/quorum as TODOs; `src/cert.rs:52-64` is a placeholder).
"""

from ipc_proofs_tpu_torch.crypto import bls  # noqa: F401
