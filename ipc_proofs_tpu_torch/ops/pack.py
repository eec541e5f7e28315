"""Host-side packing: variable-length byte messages → padded u32 arrays.

Byte-identical copies of the ``ipc_proofs_tpu`` packers, so both packages'
kernels take the same arrays:

- `pad_blake2b` — zero-padded 128-byte blocks ``[N, B, 32]`` with per-row
  block counts and lengths (the multi-block kernel's layout);
- `pack_single_block_blake2b` / `pack_two_block_blake2b` — de-interleaved
  lo/hi u32 planes ``[Np, 16]`` / ``[Np, 32]``, rows padded to a multiple
  of ``TILE`` (the single- and two-block kernels' layout);
- `pad_keccak` — keccak rate blocks ``[N, B, 34]`` with the ``0x01 … 0x80``
  multi-rate padding applied and per-row block counts (the multi-block
  keccak kernel's layout);
- `pack_single_block_keccak` — one padded rate block per message as
  de-interleaved lo/hi planes ``[Np, 17]`` (the single-block keccak
  kernel's layout);
- `digests_to_bytes` — ``[N, 8]`` little-endian digest words → bytes.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "TILE",
    "BLOCK_BYTES",
    "RATE_BYTES",
    "pad_blake2b",
    "pack_single_block_blake2b",
    "pack_two_block_blake2b",
    "pad_keccak",
    "pack_single_block_keccak",
    "digests_to_bytes",
]

TILE = 256
BLOCK_BYTES = 128  # blake2b block
RATE_BYTES = 136  # keccak-256 rate


def pad_blake2b(messages: "list[bytes]", max_blocks: "int | None" = None):
    """Pack messages into zero-padded 128-byte blake2b blocks.

    Returns (blocks u32[N, B, 32], n_blocks i32[N], lengths i32[N]).
    """
    n = len(messages)
    lengths = np.array([len(m) for m in messages], dtype=np.int32)
    counts = np.maximum((lengths + BLOCK_BYTES - 1) // BLOCK_BYTES, 1).astype(np.int32)
    b = int(counts.max()) if n else 1
    if max_blocks is not None:
        if counts.size and counts.max() > max_blocks:
            raise ValueError(f"message needs {counts.max()} blocks > cap {max_blocks}")
        b = max_blocks
    raw = np.zeros((n, b * BLOCK_BYTES), dtype=np.uint8)
    for i, msg in enumerate(messages):
        raw[i, : len(msg)] = np.frombuffer(msg, dtype=np.uint8)
    blocks = raw.reshape(n, b, BLOCK_BYTES).view(np.uint32).reshape(n, b, BLOCK_BYTES // 4)
    return np.ascontiguousarray(blocks), counts, lengths


def _pack_split(messages: "list[bytes]", n_bytes: int, what: str):
    n = len(messages)
    n_pad = ((n + TILE - 1) // TILE) * TILE
    raw = np.zeros((n_pad, n_bytes), dtype=np.uint8)
    lengths = np.zeros((n_pad, 1), dtype=np.int32)
    for i, msg in enumerate(messages):
        if len(msg) > n_bytes:
            raise ValueError(f"{what} blake2b kernel requires len <= {n_bytes}")
        raw[i, : len(msg)] = np.frombuffer(msg, dtype=np.uint8)
        lengths[i, 0] = len(msg)
    words = raw.view(np.uint32).reshape(n_pad, n_bytes // 4)
    return (
        np.ascontiguousarray(words[:, 0::2]),
        np.ascontiguousarray(words[:, 1::2]),
        lengths,
        n,
    )


def pack_single_block_blake2b(messages: "list[bytes]"):
    """Pad ≤128-byte messages into de-interleaved blake2b blocks.

    Returns (m_lo u32[Np, 16], m_hi u32[Np, 16], lengths i32[Np, 1], n).
    """
    return _pack_split(messages, 128, "single-block")


def pack_two_block_blake2b(messages: "list[bytes]"):
    """Pad ≤256-byte messages into de-interleaved 2×128-byte blake2b blocks.

    Returns (m_lo u32[Np, 32], m_hi u32[Np, 32], lengths i32[Np, 1], n).
    """
    return _pack_split(messages, 256, "two-block")


def pad_keccak(messages: "list[bytes]", max_blocks: "int | None" = None):
    """Pack messages into keccak rate blocks with multi-rate padding applied.

    Returns (blocks u32[N, B, 34], n_blocks i32[N]); row ``i`` needs
    ``len // 136 + 1`` blocks.
    """
    n = len(messages)
    counts = np.array([len(m) // RATE_BYTES + 1 for m in messages], dtype=np.int32)
    b = int(counts.max()) if n else 1
    if max_blocks is not None:
        if counts.size and counts.max() > max_blocks:
            raise ValueError(f"message needs {counts.max()} blocks > cap {max_blocks}")
        b = max_blocks
    raw = np.zeros((n, b * RATE_BYTES), dtype=np.uint8)
    for i, msg in enumerate(messages):
        raw[i, : len(msg)] = np.frombuffer(msg, dtype=np.uint8)
        raw[i, len(msg)] ^= 0x01
        raw[i, counts[i] * RATE_BYTES - 1] ^= 0x80
    # u32 words are (lo, hi) interleaved little-endian: word 2i = lane i lo
    blocks = raw.reshape(n, b, RATE_BYTES).view(np.uint32).reshape(n, b, RATE_BYTES // 4)
    return np.ascontiguousarray(blocks), counts


def pack_single_block_keccak(messages: "list[bytes]"):
    """Pad messages under 136 bytes into de-interleaved keccak rate blocks.

    Returns (blocks_lo u32[Np, 17], blocks_hi u32[Np, 17], n), Np being n
    rounded up to ``TILE``.
    """
    n = len(messages)
    n_pad = ((n + TILE - 1) // TILE) * TILE
    raw = np.zeros((n_pad, RATE_BYTES), dtype=np.uint8)
    for i, msg in enumerate(messages):
        if len(msg) >= RATE_BYTES:
            raise ValueError("single-block keccak kernel requires len < 136")
        raw[i, : len(msg)] = np.frombuffer(msg, dtype=np.uint8)
        raw[i, len(msg)] ^= 0x01
        raw[i, RATE_BYTES - 1] ^= 0x80
    words = raw.view(np.uint32).reshape(n_pad, RATE_BYTES // 4)
    return np.ascontiguousarray(words[:, 0::2]), np.ascontiguousarray(words[:, 1::2]), n


def digests_to_bytes(digests) -> "list[bytes]":
    """uint32 [N, 8] little-endian words → 32-byte digests."""
    raw = np.asarray(digests).view(np.uint32).astype("<u4").tobytes()
    return [raw[i : i + 32] for i in range(0, len(raw), 32)]
