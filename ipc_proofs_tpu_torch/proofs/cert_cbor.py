"""go-f3 certexchange CBOR codec for finality certificates.

go-f3 nodes exchange finality certificates as cborgen-tuple-encoded CBOR
(``f3/certs`` + ``gen/main.go``): each struct is a definite-length CBOR
array of its fields in declaration order, CIDs are tag-42 links, the
signers bitfield is a byte string of Filecoin RLE+ (`crypto/rleplus.py`),
and power values use Filecoin's big.Int byte-string form (empty = zero,
else a sign byte — 0x00 positive / 0x01 negative — plus the big-endian
magnitude). Layouts, one line per field below:

    FinalityCertificate = [GPBFTInstance, ECChain, SupplementalData,
                           Signers, Signature, PowerTableDelta]
    TipSet              = [Epoch, Key, PowerTable, Commitments]
    SupplementalData    = [Commitments, PowerTable]
    PowerTableDelta     = [ParticipantID, PowerDelta, SigningKey]

where ``Key`` is the tipset key: the blocks' binary CIDs concatenated
(lotus ``TipSetKey.Bytes()``).

Derivation note (same status as `proofs/gpbft.py`): reconstructed from
the public go-f3 cborgen source; live fixtures are unfetchable offline
(NOTES_r05.md), so field order rests on that reconstruction — every field
is encoded by one line here, making any future vector disagreement a
one-line fix. The local ``pop`` extension on power-table rows is NOT part
of the wire format and is dropped on encode / empty on decode.

Reference gap closed: the Rust reference has no certificate codec at all
(its trust boundary is TODO stubs, `src/proofs/trust/mod.rs:58,72`).
"""

from __future__ import annotations

import base64
from typing import Sequence

from ipc_proofs_tpu_torch.core.cid import CID
from ipc_proofs_tpu_torch.core.dagcbor import decode as cbor_decode, encode as cbor_encode
from ipc_proofs_tpu_torch.core.varint import decode_uvarint
from ipc_proofs_tpu_torch.crypto.rleplus import decode_rleplus, encode_rleplus
from ipc_proofs_tpu_torch.proofs.cert import (
    ECTipSet,
    FinalityCertificate,
    PowerTableDelta,
    SupplementalData,
    decode_signing_key,
)
from ipc_proofs_tpu_torch.proofs.gpbft import commitments32, tipset_key_bytes

__all__ = [
    "certificate_to_cbor",
    "certificate_from_cbor",
    "split_tipset_key",
    "bigint_to_bytes",
    "bigint_from_bytes",
]


def bigint_to_bytes(value: int) -> bytes:
    """Filecoin big.Int byte form: b"" for zero, sign byte + magnitude."""
    if value == 0:
        return b""
    sign = b"\x00" if value > 0 else b"\x01"
    mag = abs(value)
    return sign + mag.to_bytes((mag.bit_length() + 7) // 8, "big")


def bigint_from_bytes(raw: bytes) -> int:
    if raw == b"":
        return 0
    if raw[0] not in (0, 1):
        raise ValueError(f"invalid big.Int sign byte {raw[0]:#x}")
    if len(raw) == 1 or raw[1] == 0:
        # zero magnitude must be b"", and leading magnitude zeros are
        # non-canonical — reject both (go big.Int never emits them)
        raise ValueError("non-canonical big.Int encoding")
    mag = int.from_bytes(raw[1:], "big")
    return mag if raw[0] == 0 else -mag


def split_tipset_key(raw: bytes) -> list[CID]:
    """Split a lotus TipSetKey (concatenated binary CIDs) into CIDs."""
    out = []
    pos = 0
    n = len(raw)
    while pos < n:
        start = pos
        version, pos = decode_uvarint(raw, pos)
        if version != 1:
            raise ValueError(f"unsupported CID version {version} in tipset key")
        _codec, pos = decode_uvarint(raw, pos)
        _mh, pos = decode_uvarint(raw, pos)
        mh_len, pos = decode_uvarint(raw, pos)
        end = pos + mh_len
        if end > n:
            raise ValueError("truncated CID in tipset key")
        cid = CID.from_bytes(raw[start:end])
        # belt-and-braces: from_bytes itself rejects non-minimal varints,
        # so any accepted decode re-encodes to the same bytes; the compare
        # stays as defense in depth at this trust boundary (a second wire
        # form here would be certificate malleability)
        if cid.to_bytes() != raw[start:end]:
            raise ValueError("non-canonical CID encoding in tipset key")
        out.append(cid)
        pos = end
    return out


def _tipset_to_obj(ts: ECTipSet):
    return [
        ts.epoch,
        tipset_key_bytes(ts.key),
        CID.from_string(ts.power_table),
        commitments32(ts.commitments, "ECTipSet"),
    ]


def _tipset_from_obj(obj) -> ECTipSet:
    if not (isinstance(obj, list) and len(obj) == 4):
        raise ValueError("TipSet must be a 4-tuple")
    epoch, key, power_table, commitments = obj
    if not isinstance(epoch, int) or isinstance(epoch, bool):
        raise ValueError("TipSet.Epoch must be an integer")
    if not isinstance(key, bytes) or not isinstance(commitments, bytes):
        raise ValueError("TipSet.Key/Commitments must be byte strings")
    if not isinstance(power_table, CID):
        raise ValueError("TipSet.PowerTable must be a CID link")
    return ECTipSet(
        key=[str(c) for c in split_tipset_key(key)],
        epoch=epoch,
        power_table=str(power_table),
        commitments=commitments32(commitments, "TipSet", strict=True),
    )


def _delta_to_obj(d: PowerTableDelta):
    return [
        d.participant_id,
        bigint_to_bytes(int(d.power_delta)),
        decode_signing_key(d.signing_key) if d.signing_key else b"",
    ]


def _delta_from_obj(obj) -> PowerTableDelta:
    if not (isinstance(obj, list) and len(obj) == 3):
        raise ValueError("PowerTableDelta must be a 3-tuple")
    pid, delta, key = obj
    if not isinstance(pid, int) or isinstance(pid, bool) or pid < 0:
        raise ValueError("PowerTableDelta.ParticipantID must be a non-negative int")
    if not isinstance(delta, bytes) or not isinstance(key, bytes):
        raise ValueError("PowerTableDelta.PowerDelta/SigningKey must be byte strings")
    return PowerTableDelta(
        participant_id=pid,
        power_delta=str(bigint_from_bytes(delta)),
        signing_key=base64.b64encode(key).decode() if key else "",
    )


def certificate_to_cbor(cert: FinalityCertificate) -> bytes:
    """Encode a certificate in go-f3's certexchange tuple layout."""
    signers = cert.signers
    if isinstance(signers, list):
        signers = encode_rleplus(sorted(signers))
    elif not signers:
        signers = encode_rleplus([])
    return cbor_encode(
        [
            cert.instance,
            [_tipset_to_obj(ts) for ts in cert.ec_chain],
            [
                commitments32(cert.supplemental_data.commitments, "SupplementalData"),
                CID.from_string(cert.supplemental_data.power_table),
            ],
            bytes(signers),
            bytes(cert.signature),
            [_delta_to_obj(d) for d in cert.power_table_delta],
        ]
    )


def certificate_from_cbor(raw: bytes) -> FinalityCertificate:
    """Decode a go-f3 certexchange certificate; strict (canonical CBOR,
    the RLE+ signers validated, big.Ints canonical)."""
    obj = cbor_decode(raw)
    if not (isinstance(obj, list) and len(obj) == 6):
        raise ValueError("FinalityCertificate must be a 6-tuple")
    instance, chain, supp, signers, signature, deltas = obj
    if not isinstance(instance, int) or isinstance(instance, bool) or instance < 0:
        raise ValueError("GPBFTInstance must be a non-negative integer")
    if not isinstance(chain, list):
        raise ValueError("ECChain must be a list")
    if not (isinstance(supp, list) and len(supp) == 2):
        raise ValueError("SupplementalData must be a 2-tuple")
    if not isinstance(supp[0], bytes) or not isinstance(supp[1], CID):
        raise ValueError("SupplementalData fields must be (bytes, CID)")
    if not isinstance(signers, bytes) or not isinstance(signature, bytes):
        raise ValueError("Signers/Signature must be byte strings")
    if not isinstance(deltas, list):
        raise ValueError("PowerTableDelta must be a list")
    decode_rleplus(signers)  # validate the bitfield at the trust boundary
    cert = FinalityCertificate(
        instance=instance,
        ec_chain=[_tipset_from_obj(t) for t in chain],
        supplemental_data=SupplementalData(
            commitments=commitments32(supp[0], "SupplementalData", strict=True),
            power_table=str(supp[1]),
        ),
        signers=signers,
        signature=signature,
        power_table_delta=[_delta_from_obj(d) for d in deltas],
    )
    # whole-certificate canonicality: re-encode and require byte equality.
    # This closes every residual second-wire-form path in one check — the
    # round-5 soak caught a tag-42 link with a non-minimal multihash-code
    # varint that the block-level CID tolerance accepts and re-encodes
    # one byte shorter (cborgen emits only canonical forms, so a
    # non-canonical certificate is never a go-f3 artifact).
    if certificate_to_cbor(cert) != raw:
        raise ValueError("non-canonical certificate encoding")
    return cert
