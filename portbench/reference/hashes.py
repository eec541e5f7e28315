"""Plain hashes and CIDs: blake2b-256 from ``hashlib``, keccak-256 in NumPy.

`keccak256_many` hashes a batch of equal-length messages (shorter than one
136-byte rate block) as 25 lanes of ``uint64`` arrays, one row a message;
`keccak256` is the same function over one message. A CID here is its
binary form: CIDv1, a codec varint, and the blake2b-256 multihash; strings
are multibase base32-lower, as the chain writes them.
"""

from __future__ import annotations

import base64
import hashlib

import numpy as np

__all__ = [
    "DAG_CBOR",
    "RAW",
    "CID_PREFIX",
    "blake2b_256",
    "cid_of",
    "cid_str",
    "cid_from_str",
    "cid_digest_ok",
    "keccak256",
    "keccak256_many",
]

DAG_CBOR = 0x71
RAW = 0x55
# CIDv1, codec, blake2b-256 (0xb220 as a varint), 32-byte digest
CID_PREFIX = {DAG_CBOR: b"\x01\x71\xa0\xe4\x02\x20", RAW: b"\x01\x55\xa0\xe4\x02\x20"}


def blake2b_256(data: bytes) -> bytes:
    return hashlib.blake2b(data, digest_size=32).digest()


def cid_of(data: bytes, codec: int = DAG_CBOR) -> bytes:
    """The binary CID of a block's bytes."""
    return CID_PREFIX[codec] + blake2b_256(data)


def cid_str(cid: bytes) -> str:
    return "b" + base64.b32encode(cid).decode("ascii").lower().rstrip("=")


def cid_from_str(text: str) -> bytes:
    if not text.startswith("b"):
        raise ValueError(f"not base32 CID {text!r}")
    body = text[1:].upper()
    return base64.b32decode(body + "=" * (-len(body) % 8))


def cid_digest_ok(cid: bytes, data: bytes) -> bool:
    """True when ``cid`` is a blake2b-256 CID whose digest is ``data``'s."""
    prefix = cid[:6]
    return prefix in CID_PREFIX.values() and cid[6:] == blake2b_256(data)


_RC = np.array(
    [
        0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
        0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
        0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
        0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
        0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
        0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
    ],
    dtype=np.uint64,
)
# rotation of lane (x, y), lane index x + 5 y
_ROT = (
    (0, 36, 3, 41, 18),
    (1, 44, 10, 45, 2),
    (62, 6, 43, 15, 61),
    (28, 55, 25, 21, 56),
    (27, 20, 39, 8, 14),
)
_RATE = 136


def _rotl(v: np.ndarray, s: int) -> np.ndarray:
    if s == 0:
        return v
    return (v << np.uint64(s)) | (v >> np.uint64(64 - s))


def _keccak_f(a: list) -> list:
    for rc in _RC:
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        a = [a[i] ^ d[i % 5] for i in range(25)]
        b = [None] * 25
        for x in range(5):
            for y in range(5):
                b[y + 5 * ((2 * x + 3 * y) % 5)] = _rotl(a[x + 5 * y], _ROT[x][y])
        a = [b[x + 5 * y] ^ (~b[(x + 1) % 5 + 5 * y] & b[(x + 2) % 5 + 5 * y])
             for y in range(5) for x in range(5)]
        a[0] = a[0] ^ rc
    return a


def keccak256_many(messages: "list[bytes]") -> "list[bytes]":
    """Keccak-256 (the EVM's, padding 0x01 … 0x80) of equal-length messages
    under one rate block."""
    if not messages:
        return []
    n, length = len(messages), len(messages[0])
    if length >= _RATE or any(len(m) != length for m in messages):
        raise ValueError("keccak256_many takes equal lengths under 136 bytes")
    block = np.zeros((n, _RATE), dtype=np.uint8)
    block[:, :length] = np.frombuffer(b"".join(messages), dtype=np.uint8).reshape(n, length)
    block[:, length] ^= 0x01
    block[:, _RATE - 1] ^= 0x80
    lanes = block.view("<u8")  # (n, 17)
    state = [lanes[:, i].copy() for i in range(17)] + [np.zeros(n, np.uint64) for _ in range(8)]
    state = _keccak_f(state)
    out = np.stack(state[:4], axis=1).astype("<u8")
    return [row.tobytes() for row in out]


def keccak256(message: bytes) -> bytes:
    return keccak256_many([message])[0]
