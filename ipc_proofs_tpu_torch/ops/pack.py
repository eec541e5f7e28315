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
- `digests_to_bytes` — ``[N, 8]`` little-endian digest words → bytes;
- `to_int32` — a u32 (or int32) array onto a device as an int32 bit view,
  the kernels' input type (CPU PyTorch lacks most uint32 ops).
"""

from __future__ import annotations

import numpy as np
import torch

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
    "to_int32",
]

TILE = 256
BLOCK_BYTES = 128  # blake2b block
RATE_BYTES = 136  # keccak-256 rate


def _rows(messages: "list[bytes]", row_bytes: int, n_rows: int) -> np.ndarray:
    """Each message at the start of its own zeroed row of ``row_bytes``:
    uint8 ``[n_rows, row_bytes]``, writable. One C-level slice copy a
    message into a ``bytearray`` (a numpy slice assignment a row cost more
    than hashing the row on the host, at witness-block sizes)."""
    buf = bytearray(n_rows * row_bytes)
    off = 0
    for msg in messages:
        buf[off : off + len(msg)] = msg
        off += row_bytes
    return np.frombuffer(buf, dtype=np.uint8).reshape(n_rows, row_bytes)


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
    raw = _rows(messages, b * BLOCK_BYTES, n)
    blocks = raw.reshape(n, b, BLOCK_BYTES).view(np.uint32).reshape(n, b, BLOCK_BYTES // 4)
    return np.ascontiguousarray(blocks), counts, lengths


def _pack_split(messages: "list[bytes]", n_bytes: int, what: str):
    n = len(messages)
    n_pad = ((n + TILE - 1) // TILE) * TILE
    lengths = np.zeros((n_pad, 1), dtype=np.int32)
    lengths[:n, 0] = [len(m) for m in messages]
    if n and lengths.max() > n_bytes:
        raise ValueError(f"{what} blake2b kernel requires len <= {n_bytes}")
    raw = _rows(messages, n_bytes, n_pad)
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
    raw = _rows(messages, b * RATE_BYTES, n)
    rows = np.arange(n)
    raw[rows, [len(m) for m in messages]] ^= 0x01
    raw[rows, counts * RATE_BYTES - 1] ^= 0x80
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
    lengths = [len(m) for m in messages]
    if n and max(lengths) >= RATE_BYTES:
        raise ValueError("single-block keccak kernel requires len < 136")
    raw = _rows(messages, RATE_BYTES, n_pad)
    raw[np.arange(n), lengths] ^= 0x01
    raw[:n, RATE_BYTES - 1] ^= 0x80
    words = raw.view(np.uint32).reshape(n_pad, RATE_BYTES // 4)
    return np.ascontiguousarray(words[:, 0::2]), np.ascontiguousarray(words[:, 1::2]), n


def digests_to_bytes(digests) -> "list[bytes]":
    """uint32 [N, 8] little-endian words → 32-byte digests."""
    raw = np.asarray(digests).view(np.uint32).astype("<u4").tobytes()
    return [raw[i : i + 32] for i in range(0, len(raw), 32)]


def to_int32(array: np.ndarray, device) -> torch.Tensor:
    """``array`` (4-byte words) on ``device`` as an int32 tensor of the same
    bits."""
    return torch.from_numpy(np.ascontiguousarray(array).view(np.int32)).to(device)
