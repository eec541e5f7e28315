"""Filecoin BigInt (TokenAmount) byte serialization.

Matches ``fvm_shared::bigint`` CBOR form: a byte string that is empty for
zero, else a sign byte (0x00 positive / 0x01 negative) followed by the
big-endian magnitude (no leading zero bytes).
"""

from __future__ import annotations

__all__ = ["bigint_to_bytes", "bigint_from_bytes"]


def bigint_to_bytes(value: int) -> bytes:
    if value == 0:
        return b""
    sign = b"\x00" if value > 0 else b"\x01"
    magnitude = abs(value)
    return sign + magnitude.to_bytes((magnitude.bit_length() + 7) // 8, "big")


def bigint_from_bytes(data: bytes) -> int:
    if not data:
        return 0
    sign = data[0]
    magnitude = int.from_bytes(data[1:], "big")
    if sign == 0x00:
        return magnitude
    if sign == 0x01:
        return -magnitude
    raise ValueError(f"invalid BigInt sign byte {sign:#x}")
