"""keccak-256 batch hashing: the CUDA kernels' wrappers and plain versions.

Two wrappers, one per kernel of ``csrc/keccak.cu``, each with the JAX
package's layout at its boundary (u32 data passed as int32 bit views) and
returning ``[N, 8]`` int32 digest words ``[lo0, hi0, lo1, hi1, ...]``:

==========================  =========================================  ===========================
wrapper                     replaces (TPU device function)             input
==========================  =========================================  ===========================
`keccak256_single_block`    ``ops/pallas_kernels.py:305`` (Pallas)     blocks_lo, blocks_hi [N,17]
`keccak256_blocks`          ``ops/keccak_jax.py:123`` (XLA scan)       blocks [N,B,34]; n_blocks [N]
==========================  =========================================  ===========================

A wrapper launches its kernel for CUDA tensors (counting the launch in
`LAUNCHES`) and runs the plain PyTorch version only for CPU tensors; any
other device raises. What bounds the kernels on an H100 and how their
design answers it is set out at the top of ``csrc/keccak.cu``.

The plain versions compute on ``int64`` lanes: on CPU PyTorch, shifts and
``~`` are not implemented for ``uint64``. A left shift drops the high bits
like u64, and a logical right shift is an arithmetic one masked to
``64 - n`` bits.
"""

from __future__ import annotations

import ctypes

import torch

from ipc_proofs_tpu_torch.ops.build import check_words, launch_digests, reset_counts, runs_plain

__all__ = [
    "LAUNCHES",
    "reset_launch_counts",
    "keccak256_single_block",
    "keccak256_blocks",
    "keccak256_single_block_plain",
    "keccak256_blocks_plain",
]

# kernel name -> launches since the last reset; bumped only where a wrapper
# launches its kernel
LAUNCHES = {"keccak256_single_block": 0, "keccak256_blocks": 0}


def reset_launch_counts() -> None:
    reset_counts(LAUNCHES)


# --- plain PyTorch versions (int64 lanes) ----------------------------------

RATE_LANES = 17  # 136-byte rate = 17 u64 lanes

_ROUND_CONSTANTS = (
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
    0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
    0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
    0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
    0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
)
# Rotation offsets r[x][y] for lane (x, y); flat lane index x + 5y.
_ROTATION = (
    (0, 36, 3, 41, 18),
    (1, 44, 10, 45, 2),
    (62, 6, 43, 15, 61),
    (28, 55, 25, 21, 56),
    (27, 20, 39, 8, 14),
)
# rho+pi as one permutation: lane dest takes rotl(lane src, rot)
_RHO_PI = tuple(
    sorted(
        (y + 5 * ((2 * x + 3 * y) % 5), x + 5 * y, _ROTATION[x][y])
        for x in range(5)
        for y in range(5)
    )
)


def _s64(value: int) -> int:
    """A u64 constant as the int64 with the same bits."""
    return value - (1 << 64) if value >= 1 << 63 else value


def _rotl(x: torch.Tensor, n: int) -> torch.Tensor:
    if n == 0:
        return x
    return (x << n) | ((x >> (64 - n)) & ((1 << n) - 1))


def _keccak_f1600(a: "list[torch.Tensor]") -> "list[torch.Tensor]":
    """keccak-f[1600] over the batch: 25 int64 [N] lanes."""
    for rc in _ROUND_CONSTANTS:
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20] for x in range(5)]
        d = [c[(x + 4) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        a = [a[i] ^ d[i % 5] for i in range(25)]
        b = [_rotl(a[src], rot) for _, src, rot in _RHO_PI]
        a = [
            b[i] ^ (~b[(i + 1) % 5 + i - i % 5] & b[(i + 2) % 5 + i - i % 5])
            for i in range(25)
        ]
        a[0] = a[0] ^ _s64(rc)
    return a


def _absorb(lanes: torch.Tensor, n_blocks: torch.Tensor) -> torch.Tensor:
    """keccak-256 over ``lanes`` int64 [N, B, 17]: rows absorb blocks
    0..n_blocks-1 (at most B). Returns int32 [N, 8] digest words."""
    n, n_max = lanes.shape[0], lanes.shape[1]
    zero = torch.zeros(n, dtype=torch.int64, device=lanes.device)
    a = [zero] * 25
    nb = n_blocks.to(torch.int64)
    for i in range(n_max):
        block = lanes[:, i].unbind(1)
        new = _keccak_f1600([a[j] ^ block[j] for j in range(RATE_LANES)] + a[RATE_LANES:])
        active = i < nb
        a = [torch.where(active, new[j], a[j]) for j in range(25)]
    return torch.stack(a[:4], dim=1).contiguous().view(torch.int32)


def keccak256_single_block_plain(blocks_lo, blocks_hi) -> torch.Tensor:
    """Plain version of `keccak256_single_block`."""
    lanes = torch.stack([blocks_lo, blocks_hi], dim=-1).contiguous().view(torch.int64)
    ones = torch.ones(lanes.shape[0], dtype=torch.int32, device=lanes.device)
    return _absorb(lanes.reshape(lanes.shape[0], 1, RATE_LANES), ones)


def keccak256_blocks_plain(blocks, n_blocks) -> torch.Tensor:
    """Plain version of `keccak256_blocks`."""
    return _absorb(blocks.contiguous().view(torch.int64), n_blocks)


# --- kernel wrappers --------------------------------------------------------

_ARGTYPES = {
    "keccak256_single_block": [ctypes.c_void_p] * 2 + [ctypes.c_longlong] + [ctypes.c_void_p] * 2,
    "keccak256_blocks": [ctypes.c_void_p] * 2
    + [ctypes.c_longlong, ctypes.c_int]
    + [ctypes.c_void_p] * 2,
}


def _launch(name: str, args: list, n: int, device: torch.device) -> torch.Tensor:
    return launch_digests("keccak", name, _ARGTYPES[name], args, n, device, LAUNCHES)


def keccak256_single_block(blocks_lo, blocks_hi) -> torch.Tensor:
    """keccak-256 of messages under 136 bytes, each one pre-padded rate
    block (`pack_single_block_keccak` layout): blocks_lo/blocks_hi int32
    [N, 17] → [N, 8]."""
    name = "keccak256_single_block"
    n = blocks_lo.shape[0]
    device = blocks_lo.device
    check_words(name, blocks_lo, (n, RATE_LANES), device)
    check_words(name, blocks_hi, (n, RATE_LANES), device)
    if runs_plain(name, device):
        return keccak256_single_block_plain(blocks_lo, blocks_hi)
    return _launch(name, [blocks_lo.data_ptr(), blocks_hi.data_ptr(), n], n, device)


def keccak256_blocks(blocks, n_blocks) -> torch.Tensor:
    """keccak-256 over pre-padded rate blocks: int32 [N, B, 34]
    (`pad_keccak` layout) and per-row block counts int32 [N] → [N, 8]. A
    row with ``n_blocks <= 0`` hashes to 32 zero bytes; one with more than
    B absorbs B blocks (the XLA kernel's masked scan)."""
    name = "keccak256_blocks"
    if blocks.dim() != 3 or blocks.shape[2] != 2 * RATE_LANES:
        raise ValueError(f"{name}: expected blocks [N, B, 34], got {tuple(blocks.shape)}")
    n, n_max = blocks.shape[0], blocks.shape[1]
    device = blocks.device
    check_words(name, blocks, (n, n_max, 2 * RATE_LANES), device)
    check_words(name, n_blocks, (n,), device)
    if runs_plain(name, device):
        return keccak256_blocks_plain(blocks, n_blocks)
    return _launch(name, [blocks.data_ptr(), n_blocks.data_ptr(), n, n_max], n, device)
