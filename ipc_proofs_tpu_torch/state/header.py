"""Filecoin block headers: the 16-field tuple, decode + fixture builder.

Verification reads fields 5 (parents), 7 (height), 8 (parent_state_root),
9 (parent_message_receipts) and 10 (messages). The builder emits a full
16-field tuple so fixture headers round-trip through the same decoder the
proof engines use. The counterpart of ``ipc_proofs_tpu.state.header``:
`decode_header_lite` runs the C ``decode_header_lite`` of the port's
dagcbor extension, with `BlockHeader.decode`'s exact acceptance.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, NamedTuple

from ipc_proofs_tpu_torch.core import _cid_native
from ipc_proofs_tpu_torch.core.cid import CID
from ipc_proofs_tpu_torch.core.dagcbor import decode as cbor_decode
from ipc_proofs_tpu_torch.core.dagcbor import encode as cbor_encode

__all__ = ["BlockHeader", "LiteHeader", "decode_header_lite", "extract_parent_state_root"]


def _validate_core_fields(fields: list) -> None:
    """Type checks on the fields verification reads."""
    parents = fields[5]
    if not isinstance(parents, list):
        raise ValueError("header parents must be a CID list")
    for c in parents:
        if not isinstance(c, CID):
            raise ValueError("header parents must be a CID list")
    for idx, name in (
        (8, "parent_state_root"),
        (9, "parent_message_receipts"),
        (10, "messages"),
    ):
        if not isinstance(fields[idx], CID):
            raise ValueError(f"header field {name} must be a CID")


class LiteHeader(NamedTuple):
    """The five header fields verification reads, and nothing else (the
    batch verifiers decode two headers per proof group). Shares attribute
    names with :class:`BlockHeader`, so the verifiers and the batched
    exec-order walker accept either."""

    parents: "list[CID]"
    height: int
    parent_state_root: CID
    parent_message_receipts: CID
    messages: CID


def decode_header_lite(raw: bytes) -> LiteHeader:
    """Verification-only header decode with :meth:`BlockHeader.decode`'s
    exact acceptance. The C ``decode_header_lite`` walks the full grammar in
    validating-skip mode (strict UTF-8, map keys, tag-42 CID bytes), folds
    in the core-field type checks and returns just the five fields; the
    pure-Python universe decodes the whole header."""
    ext = _cid_native.load()
    if ext is not None:
        return LiteHeader._make(ext.decode_header_lite(raw))
    h = BlockHeader.decode(raw)
    return LiteHeader(h.parents, h.height, h.parent_state_root, h.parent_message_receipts, h.messages)


@dataclass
class BlockHeader:
    """The fields the proof system reads, plus opaque padding for the rest."""

    parents: list[CID]
    height: int
    parent_state_root: CID
    parent_message_receipts: CID
    messages: CID
    timestamp: int = 0
    fork_signaling: int = 0
    miner: Any = None
    parent_weight: bytes = b""
    # Opaque fields kept only so decode(encode(h)) is byte-stable.
    _ticket: Any = None
    _election_proof: Any = None
    _beacon_entries: Any = field(default_factory=list)
    _winpost_proof: Any = field(default_factory=list)
    _bls_aggregate: Any = None
    _block_sig: Any = None
    _parent_base_fee: bytes = b""

    @classmethod
    def decode(cls, raw: bytes) -> "BlockHeader":
        fields = cbor_decode(raw)
        if not (isinstance(fields, list) and len(fields) == 16):
            raise ValueError(f"block header must be a 16-tuple, got {type(fields)}")
        _validate_core_fields(fields)
        return cls(
            miner=fields[0],
            _ticket=fields[1],
            _election_proof=fields[2],
            _beacon_entries=fields[3],
            _winpost_proof=fields[4],
            parents=fields[5],
            parent_weight=fields[6],
            height=fields[7],
            parent_state_root=fields[8],
            parent_message_receipts=fields[9],
            messages=fields[10],
            _bls_aggregate=fields[11],
            timestamp=fields[12],
            _block_sig=fields[13],
            fork_signaling=fields[14],
            _parent_base_fee=fields[15],
        )

    def encode(self) -> bytes:
        return cbor_encode(
            [
                self.miner,
                self._ticket,
                self._election_proof,
                self._beacon_entries,
                self._winpost_proof,
                self.parents,
                self.parent_weight,
                self.height,
                self.parent_state_root,
                self.parent_message_receipts,
                self.messages,
                self._bls_aggregate,
                self.timestamp,
                self._block_sig,
                self.fork_signaling,
                self._parent_base_fee,
            ]
        )


def extract_parent_state_root(raw: bytes) -> CID:
    """Parent state root straight from raw header CBOR."""
    return BlockHeader.decode(raw).parent_state_root
