"""Cross-request aggregation: one witness for K claims, verdicts split
per claim.

K co-tipset requests (a batch of ``/v1/generate`` calls, or a
``/v1/generate_range`` with per-pair claims) re-ship near-identical
HAMT/AMT interiors when answered separately. The aggregated form is the
CANONICAL merged bundle — the range drivers' merge law: pair-ordered
proofs, CID-sorted deduplicated witness — plus a *claim table*:
per claim, the half-open spans of the flat proof arrays that belong to
it. Claims for the same pair share spans, which is the whole point — the
witness (and the proofs) serialize once no matter how many claims
reference them.

Expansion drops the claim table and yields the plain canonical bundle,
byte-identical by construction; `split_claim` / `verify_aggregated`
recover per-claim views and per-claim verdicts from ONE shared verify
replay (the same span-split the micro-batcher does for verify batches).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from ipc_proofs_tpu_torch.proofs.bundle import (
    UnifiedProofBundle,
    UnifiedVerificationResult,
)
from ipc_proofs_tpu_torch.utils.jsonstrict import strict_fields
from ipc_proofs_tpu_torch.utils.metrics import Metrics, get_metrics
from ipc_proofs_tpu_torch.witness.errors import WitnessError

__all__ = [
    "AggregatedBundle",
    "ClaimSpan",
    "aggregate_range_bundle",
    "verify_aggregated",
]

_S = strict_fields("malformed aggregated bundle")


@dataclass(frozen=True)
class ClaimSpan:
    """One claim's slice of the flat proof arrays (half-open spans)."""

    pair_index: int
    storage_lo: int
    storage_hi: int
    event_lo: int
    event_hi: int

    def to_json_obj(self) -> dict:
        return {
            "pair_index": self.pair_index,
            "storage_proofs": [self.storage_lo, self.storage_hi],
            "event_proofs": [self.event_lo, self.event_hi],
        }

    @classmethod
    def from_json_obj(cls, obj: dict) -> "ClaimSpan":
        obj = _S.as_map(obj, "claim")
        s = _S.as_list(_S.get(obj, "storage_proofs", "claim"), "storage_proofs")
        e = _S.as_list(_S.get(obj, "event_proofs", "claim"), "event_proofs")
        if len(s) != 2 or len(e) != 2:
            raise ValueError("malformed aggregated bundle: claim spans must be [lo, hi]")
        return cls(
            pair_index=_S.as_int(_S.get(obj, "pair_index", "claim"), "pair_index"),
            storage_lo=_S.as_int(s[0], "storage span"),
            storage_hi=_S.as_int(s[1], "storage span"),
            event_lo=_S.as_int(e[0], "event span"),
            event_hi=_S.as_int(e[1], "event span"),
        )


@dataclass
class AggregatedBundle:
    """The canonical merged bundle plus its claim table."""

    bundle: UnifiedProofBundle
    claims: List[ClaimSpan]

    def expand(self) -> UnifiedProofBundle:
        """Drop the claim table → the plain canonical bundle (the byte-
        identity anchor of the differential grid)."""
        return self.bundle

    def split_claim(self, i: int) -> UnifiedProofBundle:
        """One claim's proofs over the SHARED witness (a sound superset:
        the claim verifies independently against it)."""
        c = self.claims[i]
        return UnifiedProofBundle(
            storage_proofs=self.bundle.storage_proofs[c.storage_lo : c.storage_hi],
            event_proofs=self.bundle.event_proofs[c.event_lo : c.event_hi],
            blocks=self.bundle.blocks,
        )

    def claims_json(self) -> List[dict]:
        return [c.to_json_obj() for c in self.claims]

    @staticmethod
    def claims_from_json(
        claims_obj: Sequence[dict], bundle: UnifiedProofBundle
    ) -> "AggregatedBundle":
        """Parse a wire claim table against an already-parsed bundle,
        validating every span lies inside the proof arrays."""
        claims = [
            ClaimSpan.from_json_obj(c)
            for c in _S.as_list(claims_obj, "claims")
        ]
        ns, ne = len(bundle.storage_proofs), len(bundle.event_proofs)
        for c in claims:
            if not (0 <= c.storage_lo <= c.storage_hi <= ns):
                raise WitnessError(
                    f"claim storage span [{c.storage_lo}, {c.storage_hi}) "
                    f"outside bundle ({ns} storage proofs)"
                )
            if not (0 <= c.event_lo <= c.event_hi <= ne):
                raise WitnessError(
                    f"claim event span [{c.event_lo}, {c.event_hi}) "
                    f"outside bundle ({ne} event proofs)"
                )
        return AggregatedBundle(bundle=bundle, claims=claims)


def aggregate_range_bundle(
    bundle: UnifiedProofBundle,
    pairs: Sequence,
    indexes: Sequence[int],
    claim_indexes: Optional[Sequence[int]] = None,
    metrics: Optional[Metrics] = None,
) -> AggregatedBundle:
    """Layer a claim table over a canonical range bundle.

    ``bundle`` is the canonical bundle for the DISTINCT pair indexes
    ``indexes`` (in request order) — straight from the chunked driver.
    ``claim_indexes`` is the per-
    claim pair index list and may repeat entries: K co-tipset claims for
    one pair all map onto that pair's single span, so the aggregate
    serializes its proofs and witness once for all K.
    """
    metrics = metrics if metrics is not None else get_metrics()
    idxs = list(indexes)
    claim_idxs = list(claim_indexes) if claim_indexes is not None else idxs
    child_to_idx: "Dict[str, int]" = {}
    for idx in idxs:
        for c in pairs[idx].child.cids:
            child_to_idx[str(c)] = idx

    # Pair-major contiguity is the merge law's promise; walk the flat
    # arrays once and record each distinct pair's half-open spans.
    def spans(proofs) -> "Dict[int, tuple]":
        out: "Dict[int, tuple]" = {}
        pos = 0
        for idx in idxs:
            lo = pos
            while pos < len(proofs):
                at = child_to_idx.get(proofs[pos].child_block_cid)
                if at != idx:
                    break
                pos += 1
            out[idx] = (lo, pos)
        if pos != len(proofs):
            raise WitnessError(
                "bundle proofs are not in canonical pair-major order "
                "(cannot aggregate a non-canonical bundle)"
            )
        return out

    storage_spans = spans(bundle.storage_proofs)
    event_spans = spans(bundle.event_proofs)
    claims: List[ClaimSpan] = []
    for idx in claim_idxs:
        if idx not in storage_spans:
            raise WitnessError(
                f"claim pair index {idx} is not covered by this bundle"
            )
        s_lo, s_hi = storage_spans[idx]
        e_lo, e_hi = event_spans[idx]
        claims.append(ClaimSpan(idx, s_lo, s_hi, e_lo, e_hi))
    metrics.count("witness.aggregated_requests")
    metrics.count("witness.aggregated_claims", len(claims))
    return AggregatedBundle(bundle=bundle, claims=claims)


def verify_aggregated(
    agg: AggregatedBundle,
    trust_policy,
    event_filter=None,
    verify_witness_cids: bool = False,
    cid_backend=None,
) -> List[UnifiedVerificationResult]:
    """Per-claim verdicts from ONE shared verify replay.

    The merged bundle verifies once (one witness load, one grouped event
    replay); each claim's verdict is its span's slice of the flat result
    vectors — the same split the serve plane's verify micro-batcher does.
    """
    from ipc_proofs_tpu_torch.proofs.verifier import verify_proof_bundle

    flat = verify_proof_bundle(
        agg.bundle,
        trust_policy,
        event_filter=event_filter,
        verify_witness_cids=verify_witness_cids,
        cid_backend=cid_backend,
    )
    out: List[UnifiedVerificationResult] = []
    for c in agg.claims:
        out.append(
            UnifiedVerificationResult(
                storage_results=list(flat.storage_results[c.storage_lo : c.storage_hi]),
                event_results=list(flat.event_results[c.event_lo : c.event_hi]),
            )
        )
    return out
