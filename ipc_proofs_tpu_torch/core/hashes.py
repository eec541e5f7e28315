"""Host hash golden models: blake2b-256 (Filecoin CIDs) and keccak-256 (EVM).

The scalar paths here are the reference implementations the batch kernels
in :mod:`ipc_proofs_tpu_torch.ops` are tested against. ``keccak256`` feeds
``hash_event_signature`` and the scalar slot math; its batch kernels are in
:mod:`ipc_proofs_tpu_torch.ops.keccak`.
"""

from __future__ import annotations

import hashlib

__all__ = ["blake2b_256", "keccak256", "keccak_f1600"]


def blake2b_256(data: bytes) -> bytes:
    """Blake2b with a 32-byte digest — Filecoin's chain CID hash function."""
    return hashlib.blake2b(data, digest_size=32).digest()


# --- Keccak-256 (the pre-NIST sha3 variant used by Ethereum/EVM) -----------

_MASK = (1 << 64) - 1

_ROUND_CONSTANTS = (
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
    0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
    0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
    0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
    0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
)

# Rotation offsets r[x][y] for lane A[x, y] (state index x + 5*y).
_ROTATION = (
    (0, 36, 3, 41, 18),
    (1, 44, 10, 45, 2),
    (62, 6, 43, 15, 61),
    (28, 55, 25, 21, 56),
    (27, 20, 39, 8, 14),
)


def _rotl64(value: int, shift: int) -> int:
    if shift == 0:
        return value
    return ((value << shift) | (value >> (64 - shift))) & _MASK


def keccak_f1600(state: list[int]) -> list[int]:
    """Apply the 24-round keccak-f[1600] permutation to 25 u64 lanes
    (lane layout ``state[x + 5 * y]``)."""
    a = state
    for rc in _ROUND_CONSTANTS:
        # theta
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl64(c[(x + 1) % 5], 1) for x in range(5)]
        a = [a[i] ^ d[i % 5] for i in range(25)]
        # rho + pi
        b = [0] * 25
        for x in range(5):
            for y in range(5):
                b[y + 5 * ((2 * x + 3 * y) % 5)] = _rotl64(a[x + 5 * y], _ROTATION[x][y])
        # chi
        a = [
            b[x + 5 * y] ^ ((~b[(x + 1) % 5 + 5 * y] & _MASK) & b[(x + 2) % 5 + 5 * y])
            for y in range(5)
            for x in range(5)
        ]
        # iota
        a[0] ^= rc
    return a


_RATE = 136  # bytes; 1088-bit rate for 256-bit output


def keccak256(data: bytes) -> bytes:
    """Keccak-256 of ``data`` (EVM event-signature / storage-slot hashing)."""
    # multi-rate padding 0x01 .. 0x80 (keccak, NOT the 0x06 sha3 variant)
    padded = bytearray(data)
    pad_len = _RATE - (len(data) % _RATE)
    padded += b"\x00" * pad_len
    padded[len(data)] |= 0x01
    padded[-1] |= 0x80

    state = [0] * 25
    for block_start in range(0, len(padded), _RATE):
        block = padded[block_start : block_start + _RATE]
        for i in range(_RATE // 8):
            state[i] ^= int.from_bytes(block[8 * i : 8 * i + 8], "little")
        state = keccak_f1600(state)

    out = bytearray()
    for i in range(4):  # 32 bytes = 4 lanes
        out += state[i].to_bytes(8, "little")
    return bytes(out)
