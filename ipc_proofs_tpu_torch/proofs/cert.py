"""F3 finality certificate types (Forest-aligned JSON shapes).

Reference parity: `src/cert.rs`. `is_valid_for_epoch` preserves the
reference's placeholder semantics (epoch within the EC chain's [first, last]
range, `cert.rs:52-64`); on top of that this module implements the two
structural checks the reference leaves as TODOs (`trust/mod.rs:58,72`):

* **tipset binding** — `validates_parent_tipset` / `validates_child_header`
  require the *claimed CIDs*, not just the epoch, to appear in the cert's EC
  chain (exact key match for the parent tipset; member-block match for a
  single child header). A forged proof carrying real epochs but fabricated
  tipsets now fails the trust anchor.
* **power-table chaining** — `apply_power_table_delta` +
  `FinalityCertificateChain.validate` replay each certificate's
  `PowerTableDelta` onto the previous table and check instance continuity,
  so a certificate sequence must be self-consistent before it is trusted.

The in-repo BLS12-381 implementation (`ipc_proofs_tpu_torch.crypto.bls`)
closes the remaining trust boundary:

* **aggregate-signature verification** — `verify_signature` resolves the
  ``signers`` (bitmap bytes or index list) through the power table,
  aggregates their G1 public keys, and checks the 96-byte G2 ``signature``
  over the certificate's decide payload with two pairings;
* **>2/3 power quorum** — signers' summed power must strictly exceed 2/3 of
  the table total (gpbft strong quorum);
* **power-table commitment** — `power_table_cid` canonically encodes the
  table (dag-cbor ``[[id, power, key], …]``, Filecoin positive-BigInt byte
  form) and `FinalityCertificateChain.validate(verify_table_cids=True)`
  compares the post-delta table's CID against each cert's
  ``supplemental_data.power_table``.

Three wire-interop details follow go-f3: the signing payload is go-f3's
``Payload.MarshalForSigning`` binary layout (`proofs/gpbft.py` — DECIDE phase over the EC chain key),
hash-to-G2 is RFC 9380 SSWU with the standard BLS POP ciphersuite DSTs
(`crypto/bls.py`), and ``signers`` bytes are a strict Filecoin RLE+
bitfield (`crypto/rleplus.py`), exactly go-bitfield's serialization. The
residual risk, recorded in each module's docstring: byte-level fixtures
from a live go-f3 node are unfetchable offline (NOTES_r05.md), so field
order in the payload layout rests on the public go-f3 source as
reconstructed, with every field isolated to one line for a one-line fix
should a vector ever disagree. The trust semantics — forged, under-quorum,
or wrong-table certificates are rejected — are pinned by tests either way.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

from ipc_proofs_tpu_torch.utils.jsonstrict import strict_fields

__all__ = [
    "FinalityCertificate",
    "FinalityCertificateChain",
    "ECTipSet",
    "SupplementalData",
    "PowerTableDelta",
    "PowerTableEntry",
    "apply_power_table_delta",
    "power_table_cid",
    "decode_signing_key",
]


# strict JSON field accessors for this trust boundary (shared helpers —
# see utils/jsonstrict.py for the threat model they encode)
_S = strict_fields("malformed F3 certificate")
_as_map, _get, _as_int = _S.as_map, _S.get, _S.as_int
_as_str, _as_list, _as_bytes, _as_cid_str = (
    _S.as_str, _S.as_list, _S.as_bytes, _S.as_cid_str
)


def _decode_point_str(value: str, n_bytes: int, what: str) -> bytes:
    """Decode a compressed-point string (base64 — Forest JSON's byte
    encoding — or 0x-hex) to exactly ``n_bytes``. The two forms are
    disambiguated by LENGTH, not prefix: a base64 encoding can legitimately
    begin with the characters "0x"."""
    import base64

    hex_len = 2 + 2 * n_bytes
    if len(value) == hex_len and value.startswith("0x"):
        raw = bytes.fromhex(value[2:])
    else:
        raw = base64.b64decode(value, validate=True)
    if len(raw) != n_bytes:
        raise ValueError(f"{what} must be {n_bytes} bytes, got {len(raw)}")
    return raw


def decode_signing_key(key: str) -> bytes:
    """Decode a power-table signing key string to the 48-byte compressed
    G1 form."""
    return _decode_point_str(key, 48, "signing key")


# (signing_key bytes, pop bytes) pairs that verified — PoP validity is a
# pure function of the two byte strings, so caching process-wide is sound
_POP_OK: "set[tuple[bytes, bytes]]" = set()


def _check_pop(instance: int, entry: "PowerTableEntry", pk) -> None:
    """Require a valid proof of possession for a signer's key (rogue-key
    defense — see `PowerTableEntry.pop`). Raises ValueError otherwise."""
    from ipc_proofs_tpu_torch.crypto import bls

    if not entry.pop:
        raise ValueError(
            f"certificate {instance}: signer {entry.participant_id} has no "
            f"proof of possession for its key"
        )
    key_raw = decode_signing_key(entry.signing_key)
    pop_raw = _decode_point_str(entry.pop, 96, "proof of possession")
    if (key_raw, pop_raw) in _POP_OK:
        return
    try:
        pop_point = bls.g2_decompress(pop_raw)
    except ValueError as exc:
        raise ValueError(
            f"certificate {instance}: signer {entry.participant_id}: {exc}"
        ) from exc
    if not bls.pop_verify(pk, pop_point):
        raise ValueError(
            f"certificate {instance}: signer {entry.participant_id} proof of "
            f"possession is invalid"
        )
    _POP_OK.add((key_raw, pop_raw))


def power_table_cid(table: "Sequence[PowerTableEntry]"):
    """Canonical CID of a power table: dag-cbor ``[[id, power, key], …]``
    rows in participant-id order, power in Filecoin's positive-BigInt byte
    form (empty for zero, 0x00 sign prefix + big-endian magnitude), key as
    the raw 48-byte compressed G1 bytes; blake2b-256 dag-cbor CIDv1.

    This is the table commitment `FinalityCertificateChain.validate`
    compares against ``supplemental_data.power_table`` (go-f3 hashes the
    next instance's table the same way structurally; byte-level parity
    pending vectors — module docstring).
    """
    from ipc_proofs_tpu_torch.core.cid import CID
    from ipc_proofs_tpu_torch.core.dagcbor import encode as cbor_encode

    rows = []
    for entry in sorted(table, key=lambda e: e.participant_id):
        if entry.power < 0:
            raise ValueError("power table entries cannot be negative")
        power = b"" if entry.power == 0 else b"\x00" + entry.power.to_bytes(
            (entry.power.bit_length() + 7) // 8, "big"
        )
        rows.append([entry.participant_id, power, decode_signing_key(entry.signing_key)])
    return CID.hash_of(cbor_encode(rows))


@dataclass
class ECTipSet:
    key: list[str]  # tipset CIDs as strings
    epoch: int
    power_table: str
    commitments: bytes = b""

    @classmethod
    def from_json_obj(cls, obj: dict) -> "ECTipSet":
        obj = _as_map(obj, "ECTipSet")
        key = [
            _as_cid_str(c, "ECTipSet.Key entry")
            for c in _as_list(_get(obj, "Key", "ECTipSet"), "ECTipSet.Key")
        ]
        return cls(
            key=key,
            epoch=_as_int(_get(obj, "Epoch", "ECTipSet"), "ECTipSet.Epoch"),
            power_table=_as_cid_str(
                _get(obj, "PowerTable", "ECTipSet"), "ECTipSet.PowerTable"
            ),
            commitments=_as_bytes(obj.get("Commitments", b""), "ECTipSet.Commitments"),
        )


@dataclass
class SupplementalData:
    commitments: bytes = b""
    power_table: str = ""

    @classmethod
    def from_json_obj(cls, obj: dict) -> "SupplementalData":
        obj = _as_map(obj, "SupplementalData")
        pt = obj.get("PowerTable", "")
        return cls(
            commitments=_as_bytes(
                obj.get("Commitments", b""), "SupplementalData.Commitments"
            ),
            power_table=_as_cid_str(pt, "SupplementalData.PowerTable"),
        )


@dataclass
class PowerTableDelta:
    participant_id: int
    power_delta: str
    signing_key: str
    # proof of possession accompanying a new or rotated key — without it the
    # (new) key can never satisfy the signer PoP requirement, so committee
    # churn would make later certificates unverifiable
    pop: str = ""

    @classmethod
    def from_json_obj(cls, obj: dict) -> "PowerTableDelta":
        obj = _as_map(obj, "PowerTableDelta")
        return cls(
            participant_id=_as_int(
                _get(obj, "ParticipantID", "PowerTableDelta"),
                "PowerTableDelta.ParticipantID",
            ),
            power_delta=_as_str(
                _get(obj, "PowerDelta", "PowerTableDelta"),
                "PowerTableDelta.PowerDelta",
            ),
            signing_key=_as_str(
                _get(obj, "SigningKey", "PowerTableDelta"),
                "PowerTableDelta.SigningKey",
            ),
            pop=_as_str(obj.get("Pop", ""), "PowerTableDelta.Pop"),
        )


@dataclass
class FinalityCertificate:
    instance: int
    ec_chain: list[ECTipSet] = field(default_factory=list)
    supplemental_data: SupplementalData = field(default_factory=SupplementalData)
    # signers: Filecoin RLE+ bitfield bytes over power-table rows (sorted
    # by participant id) — go-bitfield's wire format, what go-f3
    # certificates carry — or an explicit list of row indices
    signers: "bytes | list[int]" = b""
    signature: bytes = b""
    power_table_delta: list[PowerTableDelta] = field(default_factory=list)

    @classmethod
    def from_json_obj(cls, obj: dict) -> "FinalityCertificate":
        obj = _as_map(obj, "FinalityCertificate")
        raw_signers = obj.get("Signers", b"")
        if isinstance(raw_signers, list):  # explicit row indices
            signers: "bytes | list[int]" = [
                _as_int(i, "Signers entry") for i in raw_signers
            ]
        else:  # bytes / Forest base64 string (strict)
            signers = _as_bytes(raw_signers, "Signers")
        signature = _as_bytes(obj.get("Signature", b""), "Signature")
        return cls(
            instance=_as_int(
                _get(obj, "GPBFTInstance", "FinalityCertificate"), "GPBFTInstance"
            ),
            ec_chain=[
                ECTipSet.from_json_obj(t)
                for t in _as_list(
                    _get(obj, "ECChain", "FinalityCertificate"), "ECChain"
                )
            ],
            supplemental_data=SupplementalData.from_json_obj(
                obj.get("SupplementalData", {})
            ),
            signers=signers,
            signature=signature,
            power_table_delta=[
                PowerTableDelta.from_json_obj(d)
                for d in _as_list(
                    obj.get("PowerTableDelta", []), "PowerTableDelta"
                )
            ],
        )

    def signer_indices(self, max_index: Optional[int] = None) -> list[int]:
        """Power-table row indices of the signers: the explicit list form,
        or the set bits of the RLE+ bitfield (strict go-bitfield decode —
        `crypto/rleplus.py`). Sorted, duplicates rejected.

        ``max_index`` bounds the decoded bitfield width (callers that know
        the table size pass it, so a crafted few-byte certificate cannot
        force materializing millions of indices before the range check)."""
        if isinstance(self.signers, list):
            idxs = list(self.signers)
            if len(set(idxs)) != len(idxs):
                raise ValueError("duplicate signer indices")
            if any(i < 0 for i in idxs):
                raise ValueError("negative signer index")
            return sorted(idxs)
        raw = bytes(self.signers)
        if not raw:
            return []  # unset optional field (wire empty bitfield is b"\x00")
        from ipc_proofs_tpu_torch.crypto import rleplus

        max_bits = rleplus.MAX_BITS_DEFAULT if max_index is None else max_index
        return rleplus.decode_rleplus(raw, max_bits=max_bits)

    def signing_payload(self, network: str | None = None) -> bytes:
        """The byte string the aggregate signature covers: go-f3's
        ``Payload.MarshalForSigning`` for this instance's DECIDE over the
        certificate's EC chain (`proofs/gpbft.py` documents the layout and
        its derivation)."""
        from ipc_proofs_tpu_torch.proofs import gpbft

        kwargs = {} if network is None else {"network": network}
        return gpbft.payload_marshal_for_signing(
            self.instance,
            self.ec_chain,
            self.supplemental_data.commitments,
            self.supplemental_data.power_table,
            **kwargs,
        )

    def verify_signature(
        self, table: "Sequence[PowerTableEntry]", network: Optional[str] = None
    ) -> None:
        """Verify the aggregate BLS signature and the >2/3 power quorum
        against ``table`` (the committee for this instance — the power
        table BEFORE this certificate's delta is applied).

        Raises ValueError describing the first failure; returns None on
        success. Checks, in order: signers resolve to table rows; strong
        quorum (3·signer_power > 2·total_power); every signer's key carries
        a valid proof of possession (same-message aggregation is rogue-key
        forgeable without PoP — a participant registering
        pk = t·G1 − Σ pk_others could otherwise forge the aggregate alone);
        signature bytes decode to a G2 subgroup point; the aggregate
        verifies over `signing_payload`. PoP results are cached per
        (key, pop) process-wide — re-verifying a certificate chain does not
        re-pair every signer.
        """
        from ipc_proofs_tpu_torch.crypto import bls

        rows = sorted(table, key=lambda e: e.participant_id)
        if not rows:
            raise ValueError("empty power table")
        idxs = self.signer_indices(max_index=len(rows))
        if not idxs:
            raise ValueError(f"certificate {self.instance} has no signers")
        if idxs[-1] >= len(rows):
            raise ValueError(
                f"signer index {idxs[-1]} out of range for {len(rows)}-row table"
            )
        signer_rows = [rows[i] for i in idxs]
        signer_power = sum(e.power for e in signer_rows)
        total_power = sum(e.power for e in rows)
        if total_power <= 0:
            raise ValueError("power table has no power")
        if 3 * signer_power <= 2 * total_power:
            raise ValueError(
                f"certificate {self.instance} signers hold {signer_power} of "
                f"{total_power} power — not a strong (>2/3) quorum"
            )
        try:
            pks = [bls.g1_decompress(decode_signing_key(e.signing_key)) for e in signer_rows]
            sig = bls.g2_decompress(bytes(self.signature))
        except ValueError as exc:
            raise ValueError(f"certificate {self.instance}: {exc}") from exc
        if any(pk is None for pk in pks):
            # BLS KeyValidate: an identity pubkey contributes nothing to the
            # aggregate — accepting it would count its power toward quorum
            # without any signature behind it
            raise ValueError(
                f"certificate {self.instance} has a signer with an identity "
                f"public key"
            )
        for entry, pk in zip(signer_rows, pks):
            _check_pop(self.instance, entry, pk)
        payload = self.signing_payload(network=network) if network else self.signing_payload()
        if not bls.verify_aggregate_same_message(pks, payload, sig):
            raise ValueError(
                f"certificate {self.instance} aggregate BLS signature is invalid"
            )

    def is_valid_for_epoch(self, epoch: int) -> bool:
        """Placeholder check: epoch within the EC-chain range
        (matches reference `cert.rs:52-64`, including empty-chain → False)."""
        if not self.ec_chain:
            return False
        return self.ec_chain[0].epoch <= epoch <= self.ec_chain[-1].epoch

    def tipset_at_epoch(self, epoch: int) -> Optional[ECTipSet]:
        for ts in self.ec_chain:
            if ts.epoch == epoch:
                return ts
        return None

    def validates_parent_tipset(self, epoch: int, cids: Sequence[str]) -> bool:
        """True iff the EC chain finalizes exactly ``cids`` at ``epoch``.

        The tipset key is order-sensitive (Filecoin orders blocks by ticket),
        so this is an exact-sequence comparison — the strictest reading, and
        the one a forged-tipset proof cannot satisfy. Beats the reference's
        epoch-only stub (`trust/mod.rs:53-64`).
        """
        ts = self.tipset_at_epoch(epoch)
        return ts is not None and list(ts.key) == list(cids)

    def validates_child_header(self, epoch: int, cid: str) -> bool:
        """True iff block ``cid`` is a member of the finalized tipset at
        ``epoch``. A child *header* is one block of the child tipset, so
        membership (not whole-key equality) is the correct predicate.
        Beats the reference's epoch-only stub (`trust/mod.rs:67-78`).
        """
        ts = self.tipset_at_epoch(epoch)
        return ts is not None and cid in ts.key


@dataclass
class PowerTableEntry:
    """One row of an F3 power table: participant id → (power, BLS key).

    ``pop`` is the key's proof of possession (96-byte compressed G2,
    base64 or 0x-hex) — REQUIRED for signature verification: same-message
    BLS aggregation is rogue-key forgeable against keys without a verified
    PoP (go-f3 uses the POP ciphersuite for exactly this reason). Not part
    of the table's CID commitment (go-f3 commits (id, power, key))."""

    participant_id: int
    power: int
    signing_key: str
    pop: str = ""


def apply_power_table_delta(
    table: Sequence[PowerTableEntry], deltas: Sequence[PowerTableDelta]
) -> list[PowerTableEntry]:
    """Replay a certificate's ``PowerTableDelta`` onto ``table``.

    Semantics (go-f3 `certs.ApplyPowerTableDiffs`): a delta adds the signed
    ``power_delta`` to the participant's power, creating the entry if new
    (its ``signing_key`` must then be non-empty) and removing it when power
    reaches zero; negative resulting power is invalid. A non-empty
    ``signing_key`` on an existing participant replaces the key. Output is
    sorted by participant id (the canonical table order).

    Raises ValueError on any inconsistency — a certificate whose delta does
    not apply cleanly must not be trusted. Like go-f3, the delta list must be
    strictly sorted by participant id (which also forbids duplicates).
    """
    ids = [d.participant_id for d in deltas]
    if ids != sorted(set(ids)):
        raise ValueError("power table delta not strictly sorted by participant id")
    rows = {
        e.participant_id: PowerTableEntry(e.participant_id, e.power, e.signing_key, e.pop)
        for e in table
    }
    for d in deltas:
        delta = int(d.power_delta)
        row = rows.get(d.participant_id)
        if row is None:
            if delta <= 0:
                raise ValueError(
                    f"delta for unknown participant {d.participant_id} must be positive"
                )
            if not d.signing_key:
                raise ValueError(
                    f"new participant {d.participant_id} is missing a signing key"
                )
            rows[d.participant_id] = PowerTableEntry(
                d.participant_id, delta, d.signing_key, d.pop
            )
            continue
        if delta == 0 and not d.signing_key and not d.pop:
            raise ValueError(f"no-op delta for participant {d.participant_id}")
        new_power = row.power + delta
        if new_power < 0:
            raise ValueError(f"participant {d.participant_id} power would go negative")
        if new_power == 0:
            del rows[d.participant_id]
        else:
            row.power = new_power
            if d.signing_key:
                # a replaced key invalidates the old proof of possession:
                # take the delta's accompanying PoP (empty until the
                # participant registers one for the new key)
                if d.signing_key != row.signing_key:
                    row.pop = d.pop
                elif d.pop:
                    row.pop = d.pop
                row.signing_key = d.signing_key
            elif d.pop:
                row.pop = d.pop  # PoP (re-)registration without a key change
    return [rows[pid] for pid in sorted(rows)]


@dataclass
class FinalityCertificateChain:
    """A consecutive run of finality certificates, validated as a unit.

    ``validate`` checks what can be checked without BLS (see module
    docstring for the remaining gap): instances strictly consecutive, every
    cert's EC chain non-empty, base continuity across certs (below), and —
    when ``initial_power_table`` is given — each cert's delta applies
    cleanly in sequence. Returns the final power table (or None when no
    initial table was provided).

    **Base continuity (go-f3 ``certs.ValidateFinalityCertificates``):**
    every certificate's EC chain starts with a *base* tipset — the head of
    the previous instance's chain — and only the suffix is newly finalized.
    For each cert after the first, the base must BE the previous head:
    same epoch, same key, same power table. Any deviation (different key or
    power table at the same epoch = fork; different epoch = a chain that
    does not descend from the finalized head) is rejected. A chain of just
    the repeated base is a valid *stall* certificate — an instance that
    decided the base with no EC progress — and finalizes nothing new.
    """

    certificates: list[FinalityCertificate] = field(default_factory=list)

    def validate(
        self,
        initial_power_table: Optional[Sequence[PowerTableEntry]] = None,
        verify_signatures: bool = False,
        verify_table_cids: bool = False,
        network: Optional[str] = None,
    ) -> Optional[list[PowerTableEntry]]:
        """Validate the chain; returns the final power table (None when no
        initial table was given).

        ``verify_signatures`` additionally checks each certificate's
        aggregate BLS signature and >2/3 quorum against the table in force
        for its instance (the table BEFORE its delta — requires
        ``initial_power_table``), AND the post-delta table commitment: the
        signature payload covers ``supplemental_data.power_table`` but not
        the delta itself, so the delta is only authenticated through the
        commitment — it is therefore mandatory here (an empty commitment is
        rejected), mirroring go-f3's ValidateFinalityCertificates.
        ``verify_table_cids`` runs the same commitment comparison without
        signatures (structural-only validation; certs without a commitment
        are skipped).
        """
        if (verify_signatures or verify_table_cids) and initial_power_table is None:
            raise ValueError(
                "signature/table-CID verification requires initial_power_table"
            )
        table = list(initial_power_table) if initial_power_table is not None else None
        prev_instance: Optional[int] = None
        prev_head: Optional[ECTipSet] = None
        for cert in self.certificates:
            if not cert.ec_chain:
                raise ValueError(f"certificate {cert.instance} has an empty EC chain")
            if prev_instance is not None and cert.instance != prev_instance + 1:
                raise ValueError(
                    f"instance gap: {prev_instance} followed by {cert.instance}"
                )
            epochs = [ts.epoch for ts in cert.ec_chain]
            if epochs != sorted(epochs) or len(set(epochs)) != len(epochs):
                raise ValueError(
                    f"certificate {cert.instance} EC chain epochs not strictly increasing"
                )
            if prev_head is not None:
                base = cert.ec_chain[0]
                if (
                    base.epoch != prev_head.epoch
                    or list(base.key) != list(prev_head.key)
                    or base.power_table != prev_head.power_table
                ):
                    raise ValueError(
                        f"certificate {cert.instance} base tipset (epoch "
                        f"{base.epoch}) must equal the previous cert's head "
                        f"(epoch {prev_head.epoch}) — forked or gapped chain"
                    )
            if verify_signatures:
                cert.verify_signature(table, network=network)
                if not cert.supplemental_data.power_table:
                    raise ValueError(
                        f"certificate {cert.instance} carries no power-table "
                        f"commitment — its delta would be unauthenticated"
                    )
            if table is not None:
                table = apply_power_table_delta(table, cert.power_table_delta)
                if (verify_signatures or verify_table_cids) and cert.supplemental_data.power_table:
                    computed = str(power_table_cid(table))
                    if computed != cert.supplemental_data.power_table:
                        raise ValueError(
                            f"certificate {cert.instance} power table commitment "
                            f"mismatch: replayed deltas give {computed}, cert "
                            f"claims {cert.supplemental_data.power_table}"
                        )
            prev_instance, prev_head = cert.instance, cert.ec_chain[-1]
        return table

    def tipset_at_epoch(self, epoch: int) -> Optional[ECTipSet]:
        for cert in self.certificates:
            ts = cert.tipset_at_epoch(epoch)
            if ts is not None:
                return ts
        return None
