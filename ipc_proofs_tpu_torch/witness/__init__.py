"""The witness plane: cross-request aggregation, delta witnesses,
compressed framing and the chunked stream codec over the canonical bundle
format.

The counterpart of ``ipc_proofs_tpu.witness``, module for module and byte
for byte: a frame, a delta, a claim table or a stream chunk written by
either package decodes in the other. Three composable layers over the SAME
canonical bundle (pair-ordered proofs, CID-sorted deduplicated witness):

- `aggregate` — one witness for K co-tipset claims, per-claim verdict
  split on verify (`AggregatedBundle`, `verify_aggregated`; the shared
  replay's CID batches run on the card);
- `delta`     — ship only blocks absent from a client-declared base
  epoch's canonical CID set; the verifier overlays base + delta
  (`encode_delta`, `apply_delta`);
- `framing`   — optional zlib/zstd frame over the canonical CID
  ordering, always carrying the uncompressed digest
  (`compress_blocks`, `decompress_blocks`).

`stream` carries the same response fields as a chunked binary stream.

System invariant: any aggregated/delta/compressed response, expanded
client-side (`wire.expand_response_fields`), is byte-identical to the
plain bundle — or fails with a typed error (`errors`), never a silently
different bundle.
"""

from ipc_proofs_tpu_torch.witness.aggregate import (
    AggregatedBundle,
    ClaimSpan,
    aggregate_range_bundle,
    verify_aggregated,
)
from ipc_proofs_tpu_torch.witness.bases import WitnessBaseCache
from ipc_proofs_tpu_torch.witness.delta import apply_delta, apply_delta_obj, encode_delta
from ipc_proofs_tpu_torch.witness.errors import (
    DeltaBaseMismatchError,
    DeltaBaseMissingError,
    WitnessEncodingError,
    WitnessError,
    WitnessIntegrityError,
)
from ipc_proofs_tpu_torch.witness.framing import (
    IDENTITY,
    compress_blocks,
    decompress_blocks,
    pack_blocks,
    supported_encodings,
)
from ipc_proofs_tpu_torch.witness.wire import (
    WitnessOptions,
    encode_bundle_fields,
    expand_response_fields,
    negotiate_witness,
    parse_bundle_obj,
)

__all__ = [
    "AggregatedBundle",
    "ClaimSpan",
    "DeltaBaseMismatchError",
    "DeltaBaseMissingError",
    "IDENTITY",
    "WitnessBaseCache",
    "WitnessEncodingError",
    "WitnessError",
    "WitnessIntegrityError",
    "WitnessOptions",
    "aggregate_range_bundle",
    "apply_delta",
    "apply_delta_obj",
    "compress_blocks",
    "decompress_blocks",
    "encode_bundle_fields",
    "encode_delta",
    "expand_response_fields",
    "negotiate_witness",
    "pack_blocks",
    "parse_bundle_obj",
    "supported_encodings",
    "verify_aggregated",
]
