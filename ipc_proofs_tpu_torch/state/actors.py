"""State tree: StateRoot, ActorState, and the EVM actor's state tuple.

`get_actor_state` walks StateRoot → actors HAMT (bit width 5) → ActorState
keyed by the ID address bytes; `parse_evm_state` tries the 6-field layout
then the 5-field one. The counterpart of ``ipc_proofs_tpu.state.actors``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ipc_proofs_tpu_torch.core.bigint import bigint_from_bytes, bigint_to_bytes
from ipc_proofs_tpu_torch.core.cid import CID
from ipc_proofs_tpu_torch.core.dagcbor import decode as cbor_decode
from ipc_proofs_tpu_torch.ipld.hamt import HAMT, HAMT_BIT_WIDTH
from ipc_proofs_tpu_torch.state.address import Address
from ipc_proofs_tpu_torch.store.blockstore import Blockstore

__all__ = ["StateRoot", "ActorState", "EvmStateLite", "get_actor_state", "parse_evm_state"]


@dataclass
class StateRoot:
    """v5 state-root wrapper: ``[version, actors_root, info]``."""

    version: int
    actors: CID
    info: CID

    @classmethod
    def decode(cls, raw: bytes) -> "StateRoot":
        fields = cbor_decode(raw)
        if not (isinstance(fields, list) and len(fields) == 3 and isinstance(fields[1], CID)):
            raise ValueError("malformed StateRoot")
        return cls(version=fields[0], actors=fields[1], info=fields[2])

    def to_tuple(self) -> list:
        return [self.version, self.actors, self.info]


@dataclass
class ActorState:
    """``[code, head(state), call_seq_num, balance, delegated_address?]``.

    Decode takes both the 4-field (pre-v10) and the 5-field layout."""

    code: CID
    state: CID
    call_seq_num: int
    balance: int
    delegated_address: Optional[bytes] = None  # raw address bytes or None

    @classmethod
    def from_tuple(cls, fields: list) -> "ActorState":
        if not isinstance(fields, list) or len(fields) not in (4, 5):
            raise ValueError(f"ActorState must be a 4/5-tuple, got {fields!r}")
        delegated = fields[4] if len(fields) == 5 else None
        return cls(
            code=fields[0],
            state=fields[1],
            call_seq_num=fields[2],
            balance=bigint_from_bytes(fields[3]),
            delegated_address=delegated,
        )

    def to_tuple(self) -> list:
        return [
            self.code,
            self.state,
            self.call_seq_num,
            bigint_to_bytes(self.balance),
            self.delegated_address,
        ]


def get_actor_state(store: Blockstore, state_root_cid: CID, address: Address) -> ActorState:
    """StateRoot → actors HAMT → ActorState for an ID address. Every block
    touched goes through ``store``, so a recording store captures the exact
    witness path."""
    raw = store.get(state_root_cid)
    if raw is None:
        raise KeyError(f"missing StateRoot {state_root_cid}")
    state_root = StateRoot.decode(raw)
    actors = HAMT.load(store, state_root.actors, bit_width=HAMT_BIT_WIDTH)
    value = actors.get(address.to_bytes())
    if value is None:
        raise KeyError(f"actor not found for {address}")
    return ActorState.from_tuple(value)


@dataclass
class EvmStateLite:
    """The slice of EVM actor state the proofs need."""

    bytecode: CID
    bytecode_hash: bytes
    contract_state: CID  # the storage HAMT root
    nonce: int


def parse_evm_state(raw: bytes) -> EvmStateLite:
    """Parse the EVM actor state tuple; 6-field first, 5-field fallback.

    v6: ``[bytecode, bytecode_hash, contract_state, reserved, nonce, tombstone]``
    v5: ``[bytecode, bytecode_hash, contract_state, nonce, tombstone]``
    """
    fields = cbor_decode(raw)
    if not isinstance(fields, list) or len(fields) not in (5, 6):
        raise ValueError(f"EVM state must be a 5/6-tuple, got {type(fields)}")
    if not (isinstance(fields[0], CID) and isinstance(fields[2], CID)):
        raise ValueError("EVM state fields 0/2 must be CIDs")
    if not (isinstance(fields[1], bytes) and len(fields[1]) == 32):
        raise ValueError("EVM state bytecode_hash must be 32 bytes")
    nonce = fields[4] if len(fields) == 6 else fields[3]
    if not isinstance(nonce, int):
        raise ValueError("EVM state nonce must be an int")
    return EvmStateLite(
        bytecode=fields[0],
        bytecode_hash=fields[1],
        contract_state=fields[2],
        nonce=nonce,
    )
