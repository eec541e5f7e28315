"""Proof claim types and the serializable bundle wire format.

Wire format: JSON with snake_case fields, hex strings 0x-prefixed, CIDs as
base32 strings, witness block data base64-encoded. A bundle written by
``ipc_proofs_tpu`` and one written here are byte-identical for the same
proofs.
"""

from __future__ import annotations

import base64
import hashlib
import json
from dataclasses import dataclass, field

from ipc_proofs_tpu_torch.core.cid import CID
from ipc_proofs_tpu_torch.utils.jsonstrict import strict_fields

__all__ = [
    "ProofBlock",
    "StorageProof",
    "EventData",
    "EventProof",
    "EventProofBundle",
    "UnifiedProofBundle",
    "UnifiedVerificationResult",
    "bundle_obj_digest",
]


def bundle_obj_digest(bundle_obj: dict) -> str:
    """Canonical content digest of a bundle's JSON object: sha256 over the
    sort-keys/compact-separators serialization."""
    canon = json.dumps(bundle_obj, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(canon.encode("utf-8")).hexdigest()


# strict JSON field accessors for this trust boundary — bundles are THE
# untrusted input (a verifier's whole job is checking one)
_S = strict_fields("malformed proof bundle")
_as_map, _get, _as_int, _as_str = _S.as_map, _S.get, _S.as_int, _S.as_str
_as_list, _as_str_list, _b64_strict = _S.as_list, _S.as_str_list, _S.b64_strict


@dataclass(frozen=True)
class ProofBlock:
    """One witness block: a CID and its raw DAG-CBOR bytes."""

    cid: CID
    data: bytes

    def to_json_obj(self) -> dict:
        return {"cid": str(self.cid), "data": base64.b64encode(self.data).decode("ascii")}

    @classmethod
    def from_json_obj(cls, obj: dict) -> "ProofBlock":
        obj = _as_map(obj, "block")
        return cls(
            cid=CID.from_string(_as_str(_get(obj, "cid", "block"), "block cid")),
            data=_b64_strict(
                _as_str(_get(obj, "data", "block"), "block data"), "block data"
            ),
        )


@dataclass
class StorageProof:
    """Claim: actor ``actor_id`` had ``value`` at storage ``slot`` in the
    state root committed by child block ``child_block_cid`` at ``child_epoch``."""

    child_epoch: int
    child_block_cid: str
    parent_state_root: str
    actor_id: int
    actor_state_cid: str
    storage_root: str
    slot: str  # 0x-hex 32 bytes
    value: str  # 0x-hex 32 bytes

    def to_json_obj(self) -> dict:
        return dict(self.__dict__)

    @classmethod
    def from_json_obj(cls, obj: dict) -> "StorageProof":
        obj = _as_map(obj, "storage proof")
        w = "storage proof"
        return cls(
            child_epoch=_as_int(_get(obj, "child_epoch", w), "child_epoch"),
            child_block_cid=_as_str(_get(obj, "child_block_cid", w), "child_block_cid"),
            parent_state_root=_as_str(
                _get(obj, "parent_state_root", w), "parent_state_root"
            ),
            actor_id=_as_int(_get(obj, "actor_id", w), "actor_id"),
            actor_state_cid=_as_str(_get(obj, "actor_state_cid", w), "actor_state_cid"),
            storage_root=_as_str(_get(obj, "storage_root", w), "storage_root"),
            slot=_as_str(_get(obj, "slot", w), "slot"),
            value=_as_str(_get(obj, "value", w), "value"),
        )


@dataclass
class EventData:
    emitter: int
    topics: list[str]  # 0x-hex, 32 bytes each
    data: str  # 0x-hex

    def to_json_obj(self) -> dict:
        return dict(self.__dict__)

    @classmethod
    def from_json_obj(cls, obj: dict) -> "EventData":
        obj = _as_map(obj, "event data")
        return cls(
            emitter=_as_int(_get(obj, "emitter", "event data"), "emitter"),
            topics=_as_str_list(_get(obj, "topics", "event data"), "topics"),
            data=_as_str(_get(obj, "data", "event data"), "data"),
        )


@dataclass
class EventProof:
    """Claim: message ``message_cid`` at execution index ``exec_index`` in the
    parent tipset emitted ``event_data`` at ``event_index``."""

    parent_epoch: int
    child_epoch: int
    parent_tipset_cids: list[str]
    child_block_cid: str
    message_cid: str
    exec_index: int
    event_index: int
    event_data: EventData

    def to_json_obj(self) -> dict:
        obj = dict(self.__dict__)
        obj["event_data"] = self.event_data.to_json_obj()
        return obj

    @classmethod
    def from_json_obj(cls, obj: dict) -> "EventProof":
        obj = _as_map(obj, "event proof")
        w = "event proof"
        return cls(
            parent_epoch=_as_int(_get(obj, "parent_epoch", w), "parent_epoch"),
            child_epoch=_as_int(_get(obj, "child_epoch", w), "child_epoch"),
            parent_tipset_cids=_as_str_list(
                _get(obj, "parent_tipset_cids", w), "parent_tipset_cids"
            ),
            child_block_cid=_as_str(_get(obj, "child_block_cid", w), "child_block_cid"),
            message_cid=_as_str(_get(obj, "message_cid", w), "message_cid"),
            exec_index=_as_int(_get(obj, "exec_index", w), "exec_index"),
            event_index=_as_int(_get(obj, "event_index", w), "event_index"),
            event_data=EventData.from_json_obj(_get(obj, "event_data", w)),
        )


@dataclass
class EventProofBundle:
    proofs: list[EventProof]
    blocks: list[ProofBlock]


@dataclass
class UnifiedProofBundle:
    storage_proofs: list[StorageProof]
    event_proofs: list[EventProof]
    blocks: list[ProofBlock]  # deduplicated, CID-sorted

    def to_json_obj(self) -> dict:
        return {
            "storage_proofs": [p.to_json_obj() for p in self.storage_proofs],
            "event_proofs": [p.to_json_obj() for p in self.event_proofs],
            "blocks": [b.to_json_obj() for b in self.blocks],
        }

    def to_json(self, indent: int | None = None) -> str:
        return json.dumps(self.to_json_obj(), indent=indent)

    @classmethod
    def from_json_obj(cls, obj: dict) -> "UnifiedProofBundle":
        obj = _as_map(obj, "bundle")
        return cls(
            storage_proofs=[
                StorageProof.from_json_obj(p)
                for p in _as_list(_get(obj, "storage_proofs", "bundle"), "storage_proofs")
            ],
            event_proofs=[
                EventProof.from_json_obj(p)
                for p in _as_list(_get(obj, "event_proofs", "bundle"), "event_proofs")
            ],
            blocks=[
                ProofBlock.from_json_obj(b)
                for b in _as_list(_get(obj, "blocks", "bundle"), "blocks")
            ],
        )

    @classmethod
    def from_json(cls, text: str) -> "UnifiedProofBundle":
        return cls.from_json_obj(json.loads(text))

    def digest(self) -> str:
        """Canonical content digest (see `bundle_obj_digest`)."""
        return bundle_obj_digest(self.to_json_obj())


@dataclass
class UnifiedVerificationResult:
    storage_results: list[bool] = field(default_factory=list)
    event_results: list[bool] = field(default_factory=list)

    def all_valid(self) -> bool:
        return all(self.storage_results) and all(self.event_results)
