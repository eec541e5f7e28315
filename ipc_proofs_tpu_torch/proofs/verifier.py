"""Unified proof verification under a trust policy.

The counterpart of ``ipc_proofs_tpu.proofs.verifier.verify_proof_bundle``:
the `TrustPolicy` becomes two fail-soft closures; storage proofs replay
through the batched verifier (one C walk of the actors tree for the
bundle; the scalar loop in the pure-Python universe), then the events
through the batched event verifier, whose TxMeta CID recompute runs on the
card. Each phase is a span: ``verify.cids`` (the witness-CID recompute),
``verify.load`` (the shared witness store), ``verify.storage`` and
``verify.events`` (the two replays).
"""

from __future__ import annotations

from typing import Callable, Optional

from ipc_proofs_tpu_torch.backend import get_backend
from ipc_proofs_tpu_torch.core.cid import BLAKE2B_256
from ipc_proofs_tpu_torch.obs.trace import phase_span
from ipc_proofs_tpu_torch.proofs.bundle import (
    EventProofBundle,
    UnifiedProofBundle,
    UnifiedVerificationResult,
)
from ipc_proofs_tpu_torch.proofs.event_verifier import verify_event_proof
from ipc_proofs_tpu_torch.proofs.storage_verifier import (
    verify_storage_proof,
    verify_storage_proofs_batch,
)
from ipc_proofs_tpu_torch.proofs.trust import TrustPolicy
from ipc_proofs_tpu_torch.proofs.witness import load_witness_store
from ipc_proofs_tpu_torch.state.events import ActorEvent

__all__ = ["verify_proof_bundle"]


def verify_proof_bundle(
    bundle: UnifiedProofBundle,
    trust_policy: TrustPolicy,
    event_filter: Optional[Callable[[ActorEvent], bool]] = None,
    verify_witness_cids: bool = False,
    cid_backend=None,
) -> UnifiedVerificationResult:
    """Verify all proofs in ``bundle`` under ``trust_policy``.

    ``verify_witness_cids`` recomputes every witness block's CID: the
    blake2b-256 blocks as ONE batch on ``cid_backend``, which defaults to
    ``get_backend("gpu")``, the card (raises without CUDA; pass
    ``get_backend("gpu", device="cpu")`` for the plain versions). Raises
    ValueError on any mismatching block. The event replay's TxMeta CID
    recompute runs on ``cid_backend`` too, with the same default, whether
    or not ``verify_witness_cids`` is set.
    """
    if verify_witness_cids:
        with phase_span("verify.cids"):
            _verify_witness_cids(
                bundle.blocks, cid_backend if cid_backend is not None else get_backend("gpu")
            )

    with phase_span("verify.load"):
        shared_store = load_witness_store(bundle.blocks)

    def child_verifier(epoch, cid):
        try:
            return trust_policy.verify_child_header(epoch, cid)
        except Exception:  # fail-soft: a throwing trust policy is a rejection — the proof verdict reports invalid, never crashes verify
            return False

    def parent_verifier(epoch, cids):
        try:
            return trust_policy.verify_parent_tipset(epoch, cids)
        except Exception:  # fail-soft: a throwing trust policy is a rejection — the proof verdict reports invalid, never crashes verify
            return False

    with phase_span("verify.storage"):
        storage_results = None
        if bundle.storage_proofs:
            storage_results = verify_storage_proofs_batch(
                shared_store, bundle.storage_proofs, child_verifier
            )
        if storage_results is None:
            storage_results = [
                verify_storage_proof(proof, bundle.blocks, child_verifier, store=shared_store)
                for proof in bundle.storage_proofs
            ]
    with phase_span("verify.events"):
        event_bundle = EventProofBundle(proofs=bundle.event_proofs, blocks=bundle.blocks)
        event_results = verify_event_proof(
            event_bundle,
            parent_verifier,
            child_verifier,
            check_event=event_filter,
            store=shared_store,
            hash_backend=cid_backend,
        )
    return UnifiedVerificationResult(storage_results=storage_results, event_results=event_results)


def _verify_witness_cids(blocks, backend) -> None:
    chain = [b for b in blocks if b.cid.mh_code == BLAKE2B_256]
    if chain and not backend.verify_block_cids(
        [b.cid.digest for b in chain], [b.data for b in chain]
    ):
        raise ValueError("witness block bytes do not hash to their claimed CIDs")
    # other multihashes (no chain witness carries one) have no kernel:
    # they recompute on the host as they load
    load_witness_store((b for b in blocks if b.cid.mh_code != BLAKE2B_256), verify_cids=True)
