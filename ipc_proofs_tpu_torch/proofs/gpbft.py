"""go-f3 gpbft signing payloads (wire-level certificate interop).

A finality certificate's aggregate signature covers the DECIDE payload of
the gpbft instance that produced it. go-f3 marshals that payload with a
custom binary layout (NOT cbor) — ``gpbft.Payload.MarshalForSigning`` —
over a domain-separation prefix, the instance/round/phase numbers, the
supplemental data, and the EC chain's canonical key. This module
reconstructs that layout field-for-field:

    "GPBFT" ":" network_name ":"            (ASCII, no terminator)
    instance  — uint64 BE
    round     — uint64 BE
    phase     — uint8   (DECIDE = 5)
    supplemental_data.commitments — 32 raw bytes
    ec_chain.Key()                — see below
    supplemental_data.power_table — raw CID bytes

where ``ECChain.Key()`` concatenates, per tipset:

    epoch        — int64 BE
    commitments  — 32 raw bytes
    len(key)     — uint32 BE
    key          — the tipset key: the blocks' CID bytes, concatenated
    power_table  — raw CID bytes

Derivation note: the layout is reconstructed from the public go-f3 source
(``gpbft/types.go``: ``Payload.MarshalForSigning`` + ``ECChain.Key``);
byte-level fixtures from a live go-f3 node are unfetchable in this
zero-egress environment (NOTES_r05.md), so the one residual interop risk
is a field-order memory error here — each field is written by one line
below, so any future vector mismatch is a one-line fix. The reference
leaves this entire boundary as TODO stubs (`src/proofs/trust/mod.rs:58,72`).
"""

from __future__ import annotations

import struct
from typing import Sequence

__all__ = [
    "DOMAIN_SEPARATION_TAG",
    "DECIDE_PHASE",
    "DEFAULT_NETWORK",
    "ec_chain_key",
    "payload_marshal_for_signing",
]

DOMAIN_SEPARATION_TAG = "GPBFT"

# gpbft phase numbering (go-f3 gpbft/gpbft.go): INITIAL=0, QUALITY=1,
# CONVERGE=2, PREPARE=3, COMMIT=4, DECIDE=5, TERMINATED=6
DECIDE_PHASE = 5

DEFAULT_NETWORK = "filecoin"


def commitments32(raw: bytes, what: str, strict: bool = False) -> bytes:
    """Commitments are a fixed [32]byte in go-f3; empty means all-zero on
    the ENCODE side (the dataclass default). ``strict`` (wire decode)
    requires exactly 32 bytes — cborgen rejects any other length, and
    tolerating b"" there would create a second wire form."""
    if not raw and not strict:
        return bytes(32)
    if len(raw) != 32:
        raise ValueError(f"{what} commitments must be 32 bytes, got {len(raw)}")
    return bytes(raw)


_commitments32 = commitments32  # internal alias


def tipset_key_bytes(key: "Sequence[str]") -> bytes:
    """Lotus ``TipSetKey.Bytes()``: the blocks' binary CIDs concatenated."""
    from ipc_proofs_tpu_torch.core.cid import CID

    return b"".join(CID.from_string(c).to_bytes() for c in key)


def ec_chain_key(tipsets: Sequence) -> bytes:
    """``ECChain.Key()``: the canonical byte key of an EC chain.

    ``tipsets``: objects with ``epoch`` (int), ``key`` (list of CID
    strings), ``power_table`` (CID string), ``commitments`` (bytes).
    """
    from ipc_proofs_tpu_torch.core.cid import CID

    out = bytearray()
    for ts in tipsets:
        out += struct.pack(">q", ts.epoch)
        out += _commitments32(ts.commitments, "ECTipSet")
        key_bytes = tipset_key_bytes(ts.key)
        out += struct.pack(">I", len(key_bytes))
        out += key_bytes
        out += CID.from_string(ts.power_table).to_bytes()
    return bytes(out)


def payload_marshal_for_signing(
    instance: int,
    ec_chain: Sequence,
    supplemental_commitments: bytes,
    supplemental_power_table: str,
    round_: int = 0,
    phase: int = DECIDE_PHASE,
    network: str = DEFAULT_NETWORK,
) -> bytes:
    """``Payload.MarshalForSigning``: the exact byte string the committee's
    aggregate BLS signature covers. For a finality certificate the payload
    is the instance's DECIDE (round 0, phase 5) over its EC chain."""
    from ipc_proofs_tpu_torch.core.cid import CID

    out = bytearray()
    out += DOMAIN_SEPARATION_TAG.encode("ascii")
    out += b":"
    out += network.encode("utf-8")
    out += b":"
    out += struct.pack(">Q", instance)
    out += struct.pack(">Q", round_)
    out += struct.pack(">B", phase)
    out += _commitments32(supplemental_commitments, "SupplementalData")
    out += ec_chain_key(ec_chain)
    if supplemental_power_table:
        out += CID.from_string(supplemental_power_table).to_bytes()
    return bytes(out)
