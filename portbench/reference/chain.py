"""What the benchmark's worlds share: the `World` a builder returns, and the
chain objects both kinds write (ID addresses, headers, raw links).

A `World` holds every block (binary CID → bytes), the tipset pairs, what is
to be proved, and the claims a correct prover returns for it, worked out
from how the world was written.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from portbench.reference.cbor import Link
from portbench.reference.hashes import RAW, cid_of

__all__ = ["World", "ascii_to_bytes32", "id_address", "raw_link", "bigint", "header", "seeded_rng"]

IPLD_RAW = 0x55
TIMESTAMP_BASE = 1_700_000_000


@dataclass
class World:
    """Blocks, pairs and the claims a correct prover gives over them."""

    blocks: "dict[bytes, bytes]"
    pairs: "list[tuple[bytes, bytes]]"  # (parent header CID, child header CID)
    event_spec: tuple  # (signature, topic1, actor id)
    storage_specs: list = field(default_factory=list)  # (actor id, key, slot index)
    expected_events: list = field(default_factory=list)  # claim objects, in range order
    expected_storage: list = field(default_factory=list)


def ascii_to_bytes32(text: str) -> bytes:
    raw = text.encode("utf-8")[:32]
    return raw + b"\x00" * (32 - len(raw))


def raw_link(data: bytes) -> Link:
    return Link(cid_of(data, RAW))


def _uvarint(n: int) -> bytes:
    out = bytearray()
    while True:
        byte = n & 0x7F
        n >>= 7
        if n:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def id_address(actor_id: int) -> bytes:
    return b"\x00" + _uvarint(actor_id)


def bigint(value: int) -> bytes:
    if value == 0:
        return b""
    return b"\x00" + value.to_bytes((value.bit_length() + 7) // 8, "big")


def header(parents, height, state_root, receipts, messages, miner) -> list:
    """The 16-field block header, opaque fields at their fixture values."""
    return [miner, None, None, [], [], list(parents), b"", height, state_root, receipts,
            messages, None, TIMESTAMP_BASE + height * 30, None, 0, b""]


def seeded_rng(seed):
    return None if seed is None else np.random.default_rng(int(seed))


