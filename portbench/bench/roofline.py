"""The yardstick of the hash kernels: the card's peaks and the work a batch
of messages needs.

Peak rates of one H100 SXM at its 700 W limit (NVIDIA's data sheet and the
CUDA C++ Programming Guide's throughput table for compute capability 9.0):
HBM3 at 3.35 TB/s; 64 results a clock of each SM's ALU pipe (32-bit add,
logic, shift, funnel shift, compare), with the SM clocks a second taken
from the data sheet's 67 TFLOP/s fp32 (128 FMA lanes × 2 flops an SM
clock). A 64-bit operation is two 32-bit halves.

Work is counted from the messages handed to the backend, never from the
rows the program pads or launches: blake2b compresses ``max(1, ceil(n /
128))`` blocks of an n-byte message, 1,360 ALU operations each (96 G mixes
of 14 ALU operations, 8 xors of 64-bit halves, plus 16 folding the state
into h); keccak absorbs ``n // 136 + 1`` blocks, 4,354 ALU operations each
(24 rounds of 180, plus 34 absorbing xors). Bytes are each message read
once and its 32-byte digest written once.
"""

from __future__ import annotations

__all__ = ["HBM_BYTES_PER_S", "ALU_OPS_PER_S", "blake2b_work", "keccak_work", "bound_seconds"]

HBM_BYTES_PER_S = 3.35e12
SM_CLOCKS_PER_S = 67e12 / (2 * 128)
ALU_OPS_PER_S = SM_CLOCKS_PER_S * 64
BLAKE2B_ALU_OPS = 1360
KECCAK_ALU_OPS = 4354
DIGEST_BYTES = 32


def blake2b_work(lengths) -> "tuple[int, int]":
    """(ALU operations, bytes) to hash messages of these lengths."""
    blocks = sum(max(1, -(-n // 128)) for n in lengths)
    return blocks * BLAKE2B_ALU_OPS, sum(lengths) + DIGEST_BYTES * len(lengths)


def keccak_work(lengths) -> "tuple[int, int]":
    blocks = sum(n // 136 + 1 for n in lengths)
    return blocks * KECCAK_ALU_OPS, sum(lengths) + DIGEST_BYTES * len(lengths)


def bound_seconds(ops: int, nbytes: int) -> float:
    """The least time the card could take: the larger of its two bounds."""
    return max(ops / ALU_OPS_PER_S, nbytes / HBM_BYTES_PER_S)
