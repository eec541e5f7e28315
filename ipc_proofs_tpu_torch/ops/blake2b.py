"""blake2b-256 batch hashing: the CUDA kernels' wrappers and plain versions.

Three wrappers, one per kernel of ``csrc/blake2b.cu``, each with the JAX
package's layout at its boundary (u32 data passed as int32 bit views) and
returning ``[N, 8]`` int32 digest words ``[lo0, hi0, lo1, hi1, ...]``:

=============================  =========================================  ================================
wrapper                        replaces (TPU device function)             input
=============================  =========================================  ================================
`blake2b256_single_block`      ``ops/pallas_kernels.py:338`` (Pallas)     m_lo, m_hi [N,16]; lengths [N,1]
`blake2b256_two_block`         ``ops/pallas_kernels.py:364`` (Pallas)     m_lo, m_hi [N,32]; lengths [N,1]
`blake2b256_blocks`            ``ops/blake2b_jax.py:140`` (XLA scan)      blocks [N,B,32]; n_blocks, lengths [N]
=============================  =========================================  ================================

Each wrapper puts a message over four lanes up to its kernel's crossover
(`quad_rows_max`: `SINGLE_BLOCK_QUAD_ROWS_MAX`, `TWO_BLOCK_QUAD_ROWS_MAX`,
`QUAD_ROWS_MAX` rows) and over one lane above (`lanes_for_rows`); its
caller does not choose. ``<wrapper>_on_lanes`` takes the lanes (1 or 4)
for the tests and ``chip_smoke.py``'s measurements; the digests do not
depend on them.

At the row counts the paths send, one lane a message leaves most of the
H100's 528 warp schedulers without a warp, and each warp issues its
row's whole chain of compressions alone on a sub-partition's 16-lane ALU
pipe; four lanes a message run a quarter of that chain on four times the
warps. Above a crossover the card is full either way and four lanes'
extra instructions lose. The measurements behind each crossover are
beside its constant below.

A wrapper launches its kernel for CUDA tensors (counting the launch in
`LAUNCHES`) and runs the plain PyTorch version only for CPU tensors; any
other device raises. What bounds the kernels on an H100 and how their
design answers it is set out at the top of ``csrc/blake2b.cu``.

The plain versions compute on ``int64`` lanes: on CPU PyTorch, add, shift
and ``~`` are not implemented for ``uint32``/``uint64``. ``int64``
addition wraps like u64, a left shift drops the high bits like u64, and a
logical right shift is an arithmetic one masked to ``64 - n`` bits.
"""

from __future__ import annotations

import ctypes

import torch

from ipc_proofs_tpu_torch.ops.build import check_words, launch_digests, reset_counts, runs_plain

__all__ = [
    "LAUNCHES",
    "reset_launch_counts",
    "blake2b256_single_block",
    "blake2b256_single_block_on_lanes",
    "blake2b256_two_block",
    "blake2b256_two_block_on_lanes",
    "blake2b256_blocks",
    "blake2b256_blocks_on_lanes",
    "lanes_for_rows",
    "quad_rows_max",
    "blake2b256_single_block_plain",
    "blake2b256_two_block_plain",
    "blake2b256_blocks_plain",
]

# kernel name -> launches since the last reset; bumped only where a wrapper
# launches its kernel
LAUNCHES = {
    "blake2b256_single_block": 0,
    "blake2b256_two_block": 0,
    "blake2b256_blocks": 0,
}


def reset_launch_counts() -> None:
    reset_counts(LAUNCHES)


# --- plain PyTorch versions (int64 lanes) ----------------------------------

_IV = (
    0x6A09E667F3BCC908, 0xBB67AE8584CAA73B, 0x3C6EF372FE94F82B, 0xA54FF53A5F1D36F1,
    0x510E527FADE682D1, 0x9B05688C2B3E6C1F, 0x1F83D9ABFB41BD6B, 0x5BE0CD19137E2179,
)
_PARAM_WORD0 = 0x01010020  # digest_length=32, key=0, fanout=1, depth=1
_SIGMA = (
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15),
    (14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3),
    (11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4),
    (7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8),
    (9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13),
    (2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9),
    (12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11),
    (13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10),
    (6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5),
    (10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0),
)
_U32 = 0xFFFFFFFF


def _s64(value: int) -> int:
    """A u64 constant as the int64 with the same bits."""
    return value - (1 << 64) if value >= 1 << 63 else value


def _rotr(x: torch.Tensor, n: int) -> torch.Tensor:
    return ((x >> n) & ((1 << (64 - n)) - 1)) | (x << (64 - n))


def _mix(v, a, b, c, d, x, y):
    v[a] = v[a] + v[b] + x
    v[d] = _rotr(v[d] ^ v[a], 32)
    v[c] = v[c] + v[d]
    v[b] = _rotr(v[b] ^ v[c], 24)
    v[a] = v[a] + v[b] + y
    v[d] = _rotr(v[d] ^ v[a], 16)
    v[c] = v[c] + v[d]
    v[b] = _rotr(v[b] ^ v[c], 63)


def _compress(h, m, t, last):
    """One compression over the batch: ``h`` 8 and ``m`` 16 int64 [N]
    columns, ``t`` the int64 [N] byte counter, ``last`` bool [N]."""
    iv = [torch.full_like(t, _s64(w)) for w in _IV]
    v = list(h) + iv
    v[12] = v[12] ^ t
    v[14] = torch.where(last, ~v[14], v[14])
    for r in range(12):
        s = _SIGMA[r % 10]
        _mix(v, 0, 4, 8, 12, m[s[0]], m[s[1]])
        _mix(v, 1, 5, 9, 13, m[s[2]], m[s[3]])
        _mix(v, 2, 6, 10, 14, m[s[4]], m[s[5]])
        _mix(v, 3, 7, 11, 15, m[s[6]], m[s[7]])
        _mix(v, 0, 5, 10, 15, m[s[8]], m[s[9]])
        _mix(v, 1, 6, 11, 12, m[s[10]], m[s[11]])
        _mix(v, 2, 7, 8, 13, m[s[12]], m[s[13]])
        _mix(v, 3, 4, 9, 14, m[s[14]], m[s[15]])
    return [h[i] ^ v[i] ^ v[i + 8] for i in range(8)]


def _hash_words(words: torch.Tensor, n_blocks: torch.Tensor, lengths: torch.Tensor):
    """blake2b-256 over ``words`` int64 [N, B, 16] (16 u64 message words per
    block): rows compress blocks 0..n_blocks-1, the last with counter
    ``lengths`` (as u32) and the final flag. Returns int32 [N, 8]."""
    n, n_max = words.shape[0], words.shape[1]
    t_len = lengths.to(torch.int64) & _U32
    nb = n_blocks.to(torch.int64)
    h = [torch.full((n,), _s64(w), dtype=torch.int64, device=words.device) for w in _IV]
    h[0] = h[0] ^ _PARAM_WORD0
    for i in range(n_max):
        active = i < nb
        last = nb == i + 1
        t = torch.where(last, t_len, torch.full_like(t_len, 128 * (i + 1)))
        new = _compress(h, words[:, i].unbind(1), t, last)
        h = [torch.where(active, new[j], h[j]) for j in range(8)]
    return torch.stack(h[:4], dim=1).contiguous().view(torch.int32)


def _split_words(m_lo: torch.Tensor, m_hi: torch.Tensor) -> torch.Tensor:
    """lo/hi u32 planes [N, 16k] → int64 message words [N, k, 16]."""
    pairs = torch.stack([m_lo, m_hi], dim=-1).contiguous().view(torch.int64)
    return pairs.reshape(m_lo.shape[0], m_lo.shape[1] // 16, 16)


def _split_counts(lengths: torch.Tensor, n_max: int) -> torch.Tensor:
    """Block count from the u32 length, clamped to [1, n_max] — one block
    at ≤128 bytes, two above (the Pallas kernels' semantics)."""
    need = ((lengths.to(torch.int64) & _U32) + 127) // 128
    return need.clamp(1, n_max)


def blake2b256_single_block_plain(m_lo, m_hi, lengths) -> torch.Tensor:
    """Plain version of `blake2b256_single_block`."""
    return _hash_words(_split_words(m_lo, m_hi), _split_counts(lengths[:, 0], 1), lengths[:, 0])


def blake2b256_two_block_plain(m_lo, m_hi, lengths) -> torch.Tensor:
    """Plain version of `blake2b256_two_block`."""
    return _hash_words(_split_words(m_lo, m_hi), _split_counts(lengths[:, 0], 2), lengths[:, 0])


def blake2b256_blocks_plain(blocks, n_blocks, lengths) -> torch.Tensor:
    """Plain version of `blake2b256_blocks`."""
    words = blocks.contiguous().view(torch.int64)  # [N, B, 32] u32 → [N, B, 16] u64
    return _hash_words(words, n_blocks, lengths)


# --- kernel wrappers --------------------------------------------------------

_ARGTYPES = {
    "blake2b256_single_block": [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int] + [ctypes.c_void_p] * 2,
    "blake2b256_two_block": [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int] + [ctypes.c_void_p] * 2,
    "blake2b256_blocks": [ctypes.c_void_p] * 3
    + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
    + [ctypes.c_void_p] * 2,
}


def _launch(name: str, args: list, n: int, device: torch.device) -> torch.Tensor:
    return launch_digests("blake2b", name, _ARGTYPES[name], args, n, device, LAUNCHES)


# Up to this many rows `blake2b256_blocks` puts a message over four lanes,
# above over one: one thread a message cannot fill the card with few rows,
# and four lanes issue 1.35x the instructions of one. 8,448 rows are two
# 32-message blocks of the four-lane kernel on each of the H100's 132 SMs;
# one block more on an SM costs it a third more time. On the H100 (700 W),
# rows of 257-520 B in random order, four lanes took 13.3 us against one
# lane's 16.8 up to 8,448 rows and 17.1-18.2 against 16.8 from 8,576 to
# 10,240 (chip_smoke.py's kernel phase, ``blocks_crossover``; PERF.md
# section 6).
QUAD_ROWS_MAX = 8448
# Up to this many rows `blake2b256_single_block` puts a message over four
# lanes, above over one: 4,224 rows are one 32-message block of the
# four-lane kernel on each of the H100's 132 SMs, one warp a scheduler; a
# second block on an SM gives its schedulers two warps to take turns on.
# On the H100 (700 W), rows of 0-128 B in random order (chip_smoke.py's
# kernel phase, ``split_crossover``; PERF.md section 6): from 256 to
# 4,224 rows four lanes took 3.13-3.34 us on the device against one
# lane's 3.84-4.64, and 4.28-4.35 against 4.71-5.26 by warm CUDA events;
# from 4,352 to 8,448 rows the device times were level (4.63-4.73 against
# 4.46-4.72) and four lanes slower by events (5.59-5.69 against
# 5.21-5.31).
SINGLE_BLOCK_QUAD_ROWS_MAX = 4224
# The same for `blake2b256_two_block`, rows of 129-256 B. A row's two
# compressions make each lane's chain twice as long, so four lanes still
# win with two blocks an SM: device 4.21-4.58 us against 6.68-7.73 up to
# 4,224 rows and 6.59-6.86 against 7.59-7.89 from 4,352 to 8,448 (events
# 5.45-5.56 against 7.66-8.28, and 7.59-7.75 against 8.25-8.41); from
# 8,576 rows on, 8.79-8.93 against 7.73-7.80 (events 9.69-9.81 against
# 8.28-8.42).
TWO_BLOCK_QUAD_ROWS_MAX = 8448


def quad_rows_max(name: str = "blake2b256_blocks") -> int:
    """The most rows at which the kernel ``name`` puts a message over four
    lanes."""
    return {
        "blake2b256_single_block": SINGLE_BLOCK_QUAD_ROWS_MAX,
        "blake2b256_two_block": TWO_BLOCK_QUAD_ROWS_MAX,
        "blake2b256_blocks": QUAD_ROWS_MAX,
    }[name]


def lanes_for_rows(rows: int, name: str = "blake2b256_blocks") -> int:
    """The lanes a message that the kernel ``name`` takes at ``rows`` rows."""
    return 4 if rows <= quad_rows_max(name) else 1


def _lanes(name: str, rows: int, lanes: "int | None") -> int:
    lanes = lanes_for_rows(rows, name) if lanes is None else lanes
    if lanes not in (1, 4):
        raise ValueError(f"{name}: lanes {lanes}, expected 1 or 4")
    return lanes


def _split_call(name, plain, words, m_lo, m_hi, lengths, lanes) -> torch.Tensor:
    n = m_lo.shape[0]
    device = m_lo.device
    check_words(name, m_lo, (n, words), device)
    check_words(name, m_hi, (n, words), device)
    check_words(name, lengths, (n, 1), device)
    lanes = _lanes(name, n, lanes)
    if runs_plain(name, device):
        return plain(m_lo, m_hi, lengths)
    args = [m_lo.data_ptr(), m_hi.data_ptr(), lengths.data_ptr(), n, lanes]
    return _launch(name, args, n, device)


def blake2b256_single_block(m_lo, m_hi, lengths) -> torch.Tensor:
    """blake2b-256 of ≤128-byte messages: one compression, counter = length,
    final flag set. m_lo/m_hi int32 [N, 16], lengths int32 [N, 1] → [N, 8]."""
    return blake2b256_single_block_on_lanes(m_lo, m_hi, lengths, None)


def blake2b256_single_block_on_lanes(m_lo, m_hi, lengths, lanes: "int | None") -> torch.Tensor:
    """`blake2b256_single_block` with its lanes a message given: 1 or 4, or
    None for `lanes_for_rows`. The digests do not depend on it."""
    return _split_call(
        "blake2b256_single_block", blake2b256_single_block_plain, 16, m_lo, m_hi, lengths, lanes
    )


def blake2b256_two_block(m_lo, m_hi, lengths) -> torch.Tensor:
    """blake2b-256 of ≤256-byte messages: block 0 with counter
    min(len, 128), final only at len ≤ 128; block 1 (len > 128) with
    counter len, final. m_lo/m_hi int32 [N, 32], lengths int32 [N, 1]."""
    return blake2b256_two_block_on_lanes(m_lo, m_hi, lengths, None)


def blake2b256_two_block_on_lanes(m_lo, m_hi, lengths, lanes: "int | None") -> torch.Tensor:
    """`blake2b256_two_block` with its lanes a message given: 1 or 4, or
    None for `lanes_for_rows`. The digests do not depend on it."""
    return _split_call(
        "blake2b256_two_block", blake2b256_two_block_plain, 32, m_lo, m_hi, lengths, lanes
    )


def blake2b256_blocks(blocks, n_blocks, lengths) -> torch.Tensor:
    """blake2b-256 over pre-padded blocks: int32 [N, B, 32] (`pad_blake2b`
    layout), per-row block counts and byte lengths int32 [N] → [N, 8]."""
    return blake2b256_blocks_on_lanes(blocks, n_blocks, lengths, None)


def blake2b256_blocks_on_lanes(blocks, n_blocks, lengths, lanes: "int | None") -> torch.Tensor:
    """`blake2b256_blocks` with its lanes a message given: 1 or 4, or None
    for `lanes_for_rows`. The digests do not depend on it."""
    name = "blake2b256_blocks"
    if blocks.dim() != 3 or blocks.shape[2] != 32:
        raise ValueError(f"{name}: expected blocks [N, B, 32], got {tuple(blocks.shape)}")
    n, n_max = blocks.shape[0], blocks.shape[1]
    device = blocks.device
    check_words(name, blocks, (n, n_max, 32), device)
    check_words(name, n_blocks, (n,), device)
    check_words(name, lengths, (n,), device)
    lanes = _lanes(name, n, lanes)
    if runs_plain(name, device):
        return blake2b256_blocks_plain(blocks, n_blocks, lengths)
    args = [blocks.data_ptr(), n_blocks.data_ptr(), lengths.data_ptr(), n, n_max, lanes]
    return _launch(name, args, n, device)
