"""Delta witnesses: ship only the blocks the base epoch does not hold.

A *base* is any full bundle the client already expanded — named on the
wire by its canonical content digest (`proofs.bundle.bundle_obj_digest`,
the same identity standing-query deliveries and idempotency keys use).
The delta bundle carries the new bundle's proofs verbatim plus only the
witness blocks whose raw CID is absent from the base's canonical CID
set, and ``drop_cids`` — the base CIDs the new bundle no longer needs —
so the expansion is an exact set reconstruction, not a superset overlay.

Expansion (`apply_delta`) rebuilds the full bundle:

    blocks(full) = sort(base.blocks − drop_cids ∪ delta_blocks)

and then REQUIRES the declared full-bundle digest to match the rebuilt
bytes: a stale/truncated/wrong base raises `DeltaBaseMismatchError` —
byte-identity or a typed error, never a silently different bundle.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence

from ipc_proofs_tpu_torch.core.cid import CID
from ipc_proofs_tpu_torch.proofs.bundle import (
    EventProof,
    ProofBlock,
    StorageProof,
    UnifiedProofBundle,
    bundle_obj_digest,
)
from ipc_proofs_tpu_torch.utils.jsonstrict import strict_fields
from ipc_proofs_tpu_torch.utils.metrics import Metrics, get_metrics
from ipc_proofs_tpu_torch.witness.errors import (
    DeltaBaseMismatchError,
    DeltaBaseMissingError,
)
from ipc_proofs_tpu_torch.witness.framing import decompress_blocks

__all__ = ["apply_delta", "apply_delta_obj", "encode_delta"]

_S = strict_fields("malformed delta bundle")


def encode_delta(
    bundle: UnifiedProofBundle,
    base_cids: "frozenset[bytes]",
    base_digest: str,
    digest: Optional[str] = None,
    metrics: Optional[Metrics] = None,
) -> dict:
    """Encode ``bundle`` as a delta against a base identified by
    ``base_digest`` whose canonical CID set is ``base_cids``.

    ``digest`` is the bundle's canonical digest if the caller already
    computed it (the serve plane always has — it registered the bundle as
    a future base); recomputed otherwise.
    """
    metrics = metrics if metrics is not None else get_metrics()
    if digest is None:
        digest = bundle.digest()
    new_cids = set()
    delta_blocks: List[ProofBlock] = []
    for b in bundle.blocks:  # canonical order in, canonical order out
        raw = b.cid.to_bytes()
        new_cids.add(raw)
        if raw not in base_cids:
            delta_blocks.append(b)
    drop = sorted(raw for raw in base_cids if raw not in new_cids)
    metrics.count(
        "witness.delta_blocks_dropped",
        len(bundle.blocks) - len(delta_blocks),
    )
    return {
        "base_digest": base_digest,
        "digest": digest,
        "storage_proofs": [p.to_json_obj() for p in bundle.storage_proofs],
        "event_proofs": [p.to_json_obj() for p in bundle.event_proofs],
        "drop_cids": [str(CID.from_bytes(raw)) for raw in drop],
        "delta_blocks": [b.to_json_obj() for b in delta_blocks],
    }


def _base_block_index(
    base: "UnifiedProofBundle | Iterable[ProofBlock]",
) -> "Dict[bytes, ProofBlock]":
    blocks = base.blocks if isinstance(base, UnifiedProofBundle) else base
    return {b.cid.to_bytes(): b for b in blocks}


def apply_delta_obj(
    delta_obj: dict,
    base: "UnifiedProofBundle | Sequence[ProofBlock] | None",
    base_digest: Optional[str] = None,
) -> UnifiedProofBundle:
    """Expand one wire-form delta object against the caller's base.

    ``base_digest`` is the digest of the base the caller actually holds
    (computed from ``base`` when it is a full bundle) — an early mismatch
    check that makes a stale base deterministic; the authoritative check is
    always the full-bundle digest of the rebuilt bytes. ``delta_blocks``
    may arrive as a compressed ``delta_blocks_frame`` (composition with
    the framing layer); either way the rebuilt bundle must hash to the
    declared ``digest``.
    """
    obj = _S.as_map(delta_obj, "delta bundle")
    declared_base = _S.as_str(
        _S.get(obj, "base_digest", "delta bundle"), "base_digest"
    )
    declared = _S.as_str(_S.get(obj, "digest", "delta bundle"), "digest")
    if base is None:
        raise DeltaBaseMissingError(
            f"delta bundle requires base {declared_base}, but no base "
            "blocks were provided"
        )
    if base_digest is None and isinstance(base, UnifiedProofBundle):
        base_digest = base.digest()
    if base_digest is not None and base_digest != declared_base:
        raise DeltaBaseMismatchError(
            f"delta was encoded against base {declared_base}, caller "
            f"holds {base_digest}"
        )
    if "delta_blocks_frame" in obj:
        delta_blocks = decompress_blocks(obj["delta_blocks_frame"])
    else:
        delta_blocks = [
            ProofBlock.from_json_obj(b)
            for b in _S.as_list(
                _S.get(obj, "delta_blocks", "delta bundle"), "delta_blocks"
            )
        ]
    drop = set()
    for text in _S.as_str_list(
        _S.get(obj, "drop_cids", "delta bundle"), "drop_cids"
    ):
        drop.add(CID.from_string(text).to_bytes())

    by_cid = _base_block_index(base)
    for raw in drop:
        by_cid.pop(raw, None)
    for b in delta_blocks:
        by_cid[b.cid.to_bytes()] = b
    expanded = UnifiedProofBundle(
        storage_proofs=[
            StorageProof.from_json_obj(p)
            for p in _S.as_list(
                _S.get(obj, "storage_proofs", "delta bundle"), "storage_proofs"
            )
        ],
        event_proofs=[
            EventProof.from_json_obj(p)
            for p in _S.as_list(
                _S.get(obj, "event_proofs", "delta bundle"), "event_proofs"
            )
        ],
        blocks=[by_cid[raw] for raw in sorted(by_cid)],
    )
    if bundle_obj_digest(expanded.to_json_obj()) != declared:
        raise DeltaBaseMismatchError(
            f"expanding delta against the provided base did not reproduce "
            f"digest {declared} (stale or wrong base {declared_base})"
        )
    return expanded


def apply_delta(
    delta_obj: dict,
    base: "UnifiedProofBundle | Sequence[ProofBlock] | None",
    base_digest: Optional[str] = None,
) -> UnifiedProofBundle:
    """Alias of `apply_delta_obj` under the verb the docs use."""
    return apply_delta_obj(delta_obj, base, base_digest=base_digest)
