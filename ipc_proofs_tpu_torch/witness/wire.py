"""Witness-plane wire negotiation and response encoding.

Request side (``/v1/generate`` / ``/v1/generate_range`` bodies):

- ``witness_encoding`` — ``identity`` (default) | ``zlib`` | ``zstd``
  (when the host has the optional codec). Unknown names are a typed 400
  (`WitnessEncodingError` → ``error_type: witness_encoding``), NEVER a
  silent plain response.
- ``base_digest`` / ``base_epoch`` (or the ``If-Witness-Base`` header) —
  "I already hold the bundle with this canonical digest; ship me a
  delta". A base the server doesn't know (evicted, restarted, or never
  served here) falls back to a FULL bundle and counts
  ``witness.delta_fallbacks`` — delta is an optimization with a sound
  degradation, unlike encoding which is a contract.

Response side: the chosen encoding is always echoed (``witness_encoding``
JSON field; the HTTP front end mirrors it into a ``Witness-Encoding``
header), the bundle's canonical ``digest`` always rides along (it is the
client's NEXT ``base_digest``), and a delta response names its base in
``witness_base``.

`expand_response_fields` is the client half: given the response fields
and (for deltas) the base bundle the client holds, it reproduces the
plain canonical bundle byte-identically or raises a typed error — the
differential grid in the tests pins every combination.

Transport is orthogonal to encoding: the same negotiated fields ride
either one buffered JSON body or the chunked binary stream wire
(`ipc_proofs_tpu_torch.witness.stream`, opted into with ``"stream": true`` or
``Accept: application/x-ipc-bundle-stream``). A streamed document
reassembles to exactly the fields this module would have emitted
buffered, so `expand_response_fields` is the single client-side expander
for both transports.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

from ipc_proofs_tpu_torch.proofs.bundle import (
    EventProof,
    ProofBlock,
    StorageProof,
    UnifiedProofBundle,
)
from ipc_proofs_tpu_torch.utils.jsonstrict import strict_fields
from ipc_proofs_tpu_torch.utils.metrics import Metrics, get_metrics
from ipc_proofs_tpu_torch.witness.bases import WitnessBaseCache
from ipc_proofs_tpu_torch.witness.delta import apply_delta_obj, encode_delta
from ipc_proofs_tpu_torch.witness.errors import WitnessEncodingError
from ipc_proofs_tpu_torch.witness.framing import (
    IDENTITY,
    compress_blocks,
    decompress_blocks,
    supported_encodings,
)

__all__ = [
    "WitnessOptions",
    "encode_bundle_fields",
    "expand_response_fields",
    "negotiate_witness",
    "parse_bundle_obj",
]

_S = strict_fields("malformed witness response")


@dataclass
class WitnessOptions:
    """One request's negotiated witness treatment."""

    encoding: str = IDENTITY
    base_digest: Optional[str] = None
    base_epoch: Optional[int] = None

    @property
    def plain(self) -> bool:
        return self.encoding == IDENTITY and self.base_digest is None


def negotiate_witness(
    body: dict,
    headers=None,
    allow_compress: bool = True,
    allow_delta: bool = True,
) -> WitnessOptions:
    """Resolve one request's witness options from body fields + headers.

    Raises `WitnessEncodingError` for unknown/unavailable/disabled
    encodings (the serve plane maps it to a typed 400). A requested delta
    base is carried through even when ``allow_delta`` is off — the
    encoder will fall back to full and count it, which is the documented
    delta degradation.
    """
    enc = body.get("witness_encoding")
    if enc is None and headers is not None:
        enc = headers.get("Accept-Witness-Encoding")
    if enc is None:
        enc = IDENTITY
    if not isinstance(enc, str) or enc not in supported_encodings():
        raise WitnessEncodingError(
            f"unsupported witness encoding {enc!r} "
            f"(supported: {', '.join(supported_encodings())})"
        )
    if enc != IDENTITY and not allow_compress:
        raise WitnessEncodingError(
            f"witness encoding {enc!r} is disabled on this server "
            "(--witness-compress off)"
        )
    base = body.get("base_digest")
    if base is None and headers is not None:
        base = headers.get("If-Witness-Base")
    if base is not None and not isinstance(base, str):
        raise WitnessEncodingError("base_digest must be a string digest")
    epoch = body.get("base_epoch")
    if epoch is not None and (isinstance(epoch, bool) or not isinstance(epoch, int)):
        raise WitnessEncodingError("base_epoch must be an integer epoch")
    if not allow_delta:
        base = None  # documented fallback: delta disabled ⇒ always full
    return WitnessOptions(encoding=enc, base_digest=base, base_epoch=epoch)


def encode_bundle_fields(
    bundle: UnifiedProofBundle,
    opts: WitnessOptions,
    bases: Optional[WitnessBaseCache] = None,
    metrics: Optional[Metrics] = None,
    digest: Optional[str] = None,
    claims: Optional[Sequence[dict]] = None,
) -> dict:
    """Encode one bundle for the wire under the negotiated options.

    Returns the response fields: ``bundle`` or ``bundle_delta``, plus
    ``witness_encoding`` / ``digest`` / ``witness_base`` / ``claims``.
    Every served bundle registers in ``bases`` as a future delta base.
    """
    metrics = metrics if metrics is not None else get_metrics()
    if digest is None:
        digest = bundle.digest()
    if bases is not None:
        bases.register(digest, bundle.cid_set())
    fields: dict = {"witness_encoding": opts.encoding, "digest": digest}
    if claims is not None:
        fields["claims"] = list(claims)

    base_cids = None
    if opts.base_digest is not None:
        base_cids = bases.lookup(opts.base_digest) if bases is not None else None
        if base_cids is None:
            # unknown/evicted/restarted base — the sound degradation
            metrics.count("witness.delta_fallbacks")

    if base_cids is not None:
        dobj = encode_delta(
            bundle, base_cids, opts.base_digest, digest=digest, metrics=metrics
        )
        metrics.count("witness.delta_hits")
        if opts.encoding != IDENTITY:
            frame = compress_blocks(
                [ProofBlock.from_json_obj(b) for b in dobj.pop("delta_blocks")],
                opts.encoding,
                metrics=metrics,
            )
            dobj["delta_blocks_frame"] = frame
        fields["bundle_delta"] = dobj
        fields["witness_base"] = opts.base_digest
        return fields

    obj = bundle.to_json_obj()
    if opts.encoding != IDENTITY:
        obj.pop("blocks")
        obj["blocks_frame"] = compress_blocks(
            bundle.blocks, opts.encoding, metrics=metrics
        )
    fields["bundle"] = obj
    return fields


def parse_bundle_obj(obj: dict) -> UnifiedProofBundle:
    """Parse a wire bundle object in either plain (``blocks``) or
    compressed (``blocks_frame``) form — digest-checked decompression,
    typed errors throughout."""
    obj = _S.as_map(obj, "bundle")
    if "blocks_frame" not in obj:
        return UnifiedProofBundle.from_json_obj(obj)
    return UnifiedProofBundle(
        storage_proofs=[
            StorageProof.from_json_obj(p)
            for p in _S.as_list(_S.get(obj, "storage_proofs", "bundle"), "storage_proofs")
        ],
        event_proofs=[
            EventProof.from_json_obj(p)
            for p in _S.as_list(_S.get(obj, "event_proofs", "bundle"), "event_proofs")
        ],
        blocks=decompress_blocks(obj["blocks_frame"]),
    )


def expand_response_fields(
    fields: dict,
    base: "UnifiedProofBundle | Sequence[ProofBlock] | None" = None,
    base_digest: Optional[str] = None,
) -> UnifiedProofBundle:
    """Client-side expansion: response fields → the plain canonical
    bundle, byte-identical, or a typed error.

    ``base`` is the full bundle (or its blocks) the client holds for the
    delta's ``base_digest``; unused for full responses.
    """
    fields = _S.as_map(fields, "witness response")
    if "bundle_delta" in fields:
        return apply_delta_obj(fields["bundle_delta"], base, base_digest=base_digest)
    return parse_bundle_obj(_S.get(fields, "bundle", "witness response"))
