"""Actor events, receipts, and EVM log extraction.

The counterpart of ``ipc_proofs_tpu.state.events``:
- `StampedEvent{emitter, event}` / `ActorEvent{entries}` / entry tuples;
- `Receipt`, the nv18+ 4-tuple with optional `events_root`;
- `extract_evm_log` for both on-chain encodings: Case A explicit
  concatenated ``topics``+``data``; Case B compact ``t1..t4``+``d``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache
from typing import Optional

from ipc_proofs_tpu_torch.core.cid import CID
from ipc_proofs_tpu_torch.core.hashes import keccak256

__all__ = [
    "EventEntry",
    "ActorEvent",
    "StampedEvent",
    "Receipt",
    "EvmLog",
    "extract_evm_log",
    "hash_event_signature",
    "ascii_to_bytes32",
    "left_pad_32",
    "IPLD_RAW",
]

IPLD_RAW = 0x55  # codec used for event entry values


@dataclass
class EventEntry:
    """``[flags, key, codec, value]``."""

    flags: int
    key: str
    codec: int
    value: bytes

    @classmethod
    def from_tuple(cls, fields: list) -> "EventEntry":
        if not (isinstance(fields, list) and len(fields) == 4):
            raise ValueError("event entry must be a 4-tuple")
        # fvm_shared's Entry is {flags: u64, key: String, codec: u64,
        # value: RawBytes}: every field's CBOR major must match or serde
        # rejects the block
        flags, key, codec, value = fields
        if not isinstance(flags, int) or isinstance(flags, bool) or flags < 0:
            raise ValueError("event entry flags must be an unsigned int")
        if not isinstance(key, str):
            raise ValueError("event entry key must be text")
        if not isinstance(codec, int) or isinstance(codec, bool) or codec < 0:
            raise ValueError("event entry codec must be an unsigned int")
        if not isinstance(value, bytes):
            raise ValueError("event entry value must be bytes")
        return cls(flags=flags, key=key, codec=codec, value=value)

    def to_tuple(self) -> list:
        return [self.flags, self.key, self.codec, self.value]


@dataclass
class ActorEvent:
    """Transparent wrapper over the entry list."""

    entries: list[EventEntry] = field(default_factory=list)

    @classmethod
    def from_cbor(cls, value: list) -> "ActorEvent":
        if not isinstance(value, list):
            raise ValueError("ActorEvent entries must be an array")
        return cls(entries=[EventEntry.from_tuple(e) for e in value])

    def to_cbor(self) -> list:
        return [e.to_tuple() for e in self.entries]


@dataclass
class StampedEvent:
    """``[emitter_actor_id, actor_event]``."""

    emitter: int
    event: ActorEvent

    @classmethod
    def from_cbor(cls, value: list) -> "StampedEvent":
        if not (isinstance(value, list) and len(value) == 2):
            raise ValueError("StampedEvent must be a 2-tuple")
        emitter = value[0]
        # ActorID is u64 (CBOR major 0): a text/bytes/negative emitter must
        # reject exactly like serde's u64
        if not isinstance(emitter, int) or isinstance(emitter, bool) or emitter < 0:
            raise ValueError("StampedEvent emitter must be an unsigned int")
        return cls(emitter=emitter, event=ActorEvent.from_cbor(value[1]))

    def to_cbor(self) -> list:
        return [self.emitter, self.event.to_cbor()]


@dataclass
class Receipt:
    """nv18+ message receipt: ``[exit_code, return_data, gas_used, events_root]``."""

    exit_code: int
    return_data: bytes
    gas_used: int
    events_root: Optional[CID] = None

    @classmethod
    def from_cbor(cls, value: list) -> "Receipt":
        if not isinstance(value, list) or len(value) not in (3, 4):
            raise ValueError("receipt must be a 3/4-tuple")
        events_root = value[3] if len(value) == 4 else None
        if events_root is not None and not isinstance(events_root, CID):
            raise ValueError("receipt events_root must be a CID or null")
        return cls(
            exit_code=value[0],
            return_data=value[1],
            gas_used=value[2],
            events_root=events_root,
        )

    def to_cbor(self) -> list:
        return [self.exit_code, self.return_data, self.gas_used, self.events_root]


@dataclass
class EvmLog:
    topics: list[bytes]  # each exactly 32 bytes
    data: bytes


def extract_evm_log(event: ActorEvent) -> Optional[EvmLog]:
    """Extract an EVM log from an actor event, or None if it isn't EVM-shaped.

    Case A: a ``topics`` entry holding concatenated 32-byte topics plus an
    optional ``data`` entry. Case B: compact ``t1``..``t4`` entries (each 32
    bytes) plus optional ``d``.
    """
    entries = {e.key: e.value for e in event.entries}

    if "topics" in entries:
        topics_bytes = entries["topics"]
        if len(topics_bytes) % 32 != 0:
            return None
        topics = [topics_bytes[i : i + 32] for i in range(0, len(topics_bytes), 32)]
        return EvmLog(topics=topics, data=entries.get("data", b""))

    topics = []
    for key in ("t1", "t2", "t3", "t4"):
        if key not in entries:
            break
        value = entries[key]
        if len(value) != 32:
            return None
        topics.append(value)
    if not topics:
        return None
    return EvmLog(topics=topics, data=entries.get("d", b""))


@lru_cache(maxsize=4096)
def hash_event_signature(signature: str) -> bytes:
    """keccak256 of the Solidity event signature → topic0 (memoized: the
    scalar keccak is ~40 µs and callers hash the same few signatures)."""
    return keccak256(signature.encode("utf-8"))


def ascii_to_bytes32(text: str) -> bytes:
    """Right-pad an ASCII string to 32 bytes (subnet-id topics)."""
    raw = text.encode("utf-8")[:32]
    return raw + b"\x00" * (32 - len(raw))


def left_pad_32(value: bytes) -> bytes:
    """Left-pad (or left-truncate) to 32 bytes — EVM storage value form."""
    if len(value) >= 32:
        return value[-32:]
    return b"\x00" * (32 - len(value)) + value
