#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ipc_proofs_tpu_torch``) on one card.

    python3 chip_smoke.py [--seed N] [--pairs N] [--messages N]
                          [--pure-pairs N] [--pure-contracts N]

Phases, none of which may fail:

1. probe — a CUDA device is required (exit 1 without one); prints the
   card's name and power limit as ``nvidia-smi`` reports them;
2. build — the host C extensions (``backend/native/*.c``) build with gcc
   when the package is imported, raising on failure; then it compiles
   ``csrc/blake2b.cu`` and ``csrc/keccak.cu`` with nvcc for sm_90a (one
   nvcc per source, started together) and prints the build
   seconds, ptxas's register report, and the SASS instructions per pipe of
   one blake2b compression and one keccak permutation (``cuobjdump``) that
   the operation bounds are computed from;
3. kernels — each kernel's digests must equal its plain PyTorch version's
   on the card bit for bit (tolerance 0: integer hashing) and the host
   golden model (``hashlib.blake2b``, ``core.hashes.keccak256``) on a
   4,096-row sample; each kernel is timed with CUDA events over 20 warm
   launches, beside its plain version and its bound:
   - blake2b: 1,048,576 messages (BASELINE config 4's scale) from the seed,
     about a third in each size class (≤128 B, 129–256 B, 257–520 B, the
     mix of the range witness);
   - keccak: 1,048,576 single-block messages of 0–135 B, and 262,144
     multi-block messages of 136–543 B (2–4 blocks) with rows whose block
     count is 0 (digest of zeros) or above the layout's 4 (absorbs 4);
4. event path — ``build_range_world(4096, 16, 4, 0.01)`` (BASELINE config
   2), then ``generate_event_proofs_for_range`` with ``get_backend("gpu")``
   and ``verify_proof_bundle`` with the witness CID recompute on the card,
   through the native branches (fused C scan+match, C pass 2, C witness
   materialization, batched replay whose TxMeta recompute is a second
   single-block blake2b launch), each of which must run: every verdict
   true, one proof per matching receipt, every blake2b kernel launched, the
   TxMeta batch's digests from that launch equal to the plain versions' and
   hashlib's on the same messages; a
   second generate with ``IPC_SCAN_FUSED_MATCH=0`` must give the same bundle
   bytes and launch the fingerprint mask on the card once; each kernel is
   held against its plain version on the witness's own blocks; a flipped
   byte in a witness block of each size class must be rejected; a repeat
   of the path under ``torch.profiler`` gives the card's busy time;
5. overlapped event path — the same world through
   ``generate_and_verify_range_overlapped`` (scan ∥ record ∥ merge ∥ verify
   in one bounded-queue executor) with the thread budget
   ``resolve_thread_budget()`` gives on this host (``scan_workers ×
   native_scan_threads`` must not exceed its total) and ``chunk_size =
   max(1, min(1024, pairs // max(4, 2 * scan_workers)))``, each chunk
   verified by `_staged_verify` (the witness CID recompute on the card,
   then the batched replay with the card's TxMeta recompute): the merged
   bundle's bytes must equal ``generate_event_proofs_for_range_chunked``
   at the same chunk size, every per-chunk verdict must be true and their
   concatenation equal whole-bundle verification, neither the single-core
   fallback nor a scan retry may have run, each blake2b class of the
   witness must have launched; the run's backend records every kernel
   call its worker threads make (each chunk's witness batch and TxMeta
   batch), and each recorded result must equal the plain versions (on
   the CPU) and hashlib on the same inputs, and each kernel its plain
   version at every verified chunk bundle's shapes; a repeat under
   ``torch.profiler`` gives the card's busy time; then the same run with
   ``IPC_SCAN_FUSED_MATCH=0`` must pass the same checks, give the same
   bytes and launch the fingerprint mask (its coalescing counted), each
   recorded mask equal to the plain mask on the same arrays;
6. storage path — BASELINE config 3: ``build_chain`` with 256 EVM
   contracts × 256 mapping slots (keys ``keccak(ascii_to_bytes32(
   f"subnet-{c}") ‖ be32(i))``, hashed on the card and sampled against
   ``core.hashes.keccak256``; values ``(i % 251).to_bytes(2, "big")``;
   direct HAMT storage, bit width 5; 50 filler actors), then
   ``generate_event_proofs_for_range`` over the one pair with the 65,536
   slots as its ``storage_specs`` (slot keccaks on the card,
   ``generate_storage_proofs_for_pairs``' batched C HAMT walks, which must
   run, one C witness materialization; the world has no events) and
   ``verify_proof_bundle`` (the batched storage verifier, which must
   run) with the CID recompute on the card: 65,536 proofs, every verdict
   true, every value the fixture's, the single-block keccak kernel and all
   three blake2b kernels launched in this phase; the keccak and blake2b
   kernels held against their plain versions at this path's shapes; a
   flipped witness byte of each size class rejected and a changed value
   given a false verdict;
7. mixed range — ``build_range_world(64, 16, 4, 0.01)`` with the topdown
   nonce slot ``MappingSlotSpec(1001, "calib-subnet-1", 0)`` proved at every
   pair through the native range branches: 64 storage proofs beside the
   event proofs, every verdict true, every proof's slot the expected keccak
   digest, a changed value given a false verdict, the range's one slot-hash
   launch and a blake2b launch for each size class of its witness counted;
   the keccak and blake2b kernels held against their plain versions at this
   path's shapes;
8. resumable mixed range — the same world and slot through
   ``generate_event_proofs_for_range_pipelined`` with a checkpoint
   directory and a job journal (temporary directories): every storage
   verdict true; a second run resumes every chunk from the journal
   (``range_chunks_resumed`` equals the chunk count), gives the same bytes,
   and launches no blake2b kernel and no mask (only the up-front slot
   keccak that the storage leg needs: the pipelined driver journals event
   chunks, not storage items); both runs' slot keccak batches and the
   verification's blake2b batches, as the kernels computed them, must
   equal the plain versions and the host golden models;
9. pure-Python paths — a child process started with
   ``IPC_PROOFS_NO_NATIVE=1`` runs the slice 1–2 branches on the card at
   reduced depth (the event path at 512 pairs; ``generate_storage_proofs_batch``
   at 16 contracts × 256 slots), each verified on the card with its own
   launch counts; their bundle digests (sha256 of the canonical JSON) must
   equal those of the native branches on the same worlds;
10. cold read — the event path's world read cold: the hermetic Lotus node
   (``LocalLotusSession``) → ``LotusClient`` → ``FetchPlane`` (speculate
   depth 1, every wave verified on the card) → ``TieredBlockstore`` over a ``SegmentStore``
   in a temporary directory, through ``generate_event_proofs_for_range_pipelined``
   at the host's thread budget with ``IPC_VERIFY_MIN_BYTES=0``: the bytes
   of the in-memory path; every landed wave of two or more blocks verified
   on the card and every single-block wave on the scalar lane (the
   ``verify.*`` counters equal the waves' split); all three blake2b kernels
   and the flat event mask launched (the tier has no raw map, so the scan
   is the Python walk, as in the reference); every recorded kernel call
   equal to the plain versions and hashlib; no retry of any kind; a
   profiled repeat in a fresh directory gives the card's busy ms, and a
   third run at the default crossover (every wave on the host lane) what
   the forced lane costs;
11. warm restart — the cold run's disk reopened with the sweep at open
   (``verify_scan``) on the card at the default crossover: one verify call
   per segment over every block, no eviction, its kernel calls held against
   plain and hashlib; then the same generate through a fresh plane at
   speculate depth 0 and tier: the same bytes and not one RPC call or want;
   then again at depth 1: the same bytes, no demand want, and the RPC calls
   of the speculation that fetches links the cold run's plane dropped at
   its queue cap and no walk reads (the reference plane fetches the same);
12. lying disk — 64 frames of that disk, at seeded indices, rewritten with a
   changed block byte and a valid CRC: the sweep at open evicts exactly
   those, and a read of each through the tier refetches it (one RPC call
   each) and repairs the disk;
13. lying node — 8 runs at 256 pairs over ``FaultySession`` with seeded
   bit-flip plans (16 lies each): each run gives the in-memory bytes or a
   typed error (``IntegrityError``, ``RpcError``), every lie is counted
   (``rpc.integrity_failures`` + ``fetch.speculative_integrity_drops``), some
   speculative lie is dropped and some run completes (scan retries are the
   expected cost here), and a verifying reopen of each run's disk evicts
   nothing;
14. mixed-multihash sweep — one segment of 65,536 blake2b, 65,536 keccak
   (0–520 B, so both keccak kernels run), 16,384 sha2-256, 4,096 identity
   and 1,024 unknown-code blocks from the seed, 1 % with a flipped bit,
   swept at open on the card: each block kept exactly when
   ``verify_block_bytes`` (run in worker processes: the host keccak is pure
   Python; the keccak CIDs come from the card, so a wrong kernel fails
   here too) accepts it, the flips the only evictions, both keccak and all
   three blake2b kernels launched, the two kernel calls equal to plain and
   the host;
15. autotune — ``autotune_crossover(quick=False)`` on the card, its record
   written as ``verify_autotune_cuda.json``; last, since the tuned crossover
   applies to every later verify call of the process.

Prints per-stage ms of every path with the scanner's thread count and the
CPUs it may use; then, in order before the last line: one line per kernel,
one JSON object ``{"kernels": [...]}``, the ``nvidia-smi`` name/power-limit
line; and as the last line ``{"ok": true, "device": {...}}``. Each path's
launch counts are set to 0 just before it runs and read just after. A
kernel's ``launches`` is the count on the first path that runs it (the
event path for blake2b, the storage path for the single-block keccak, the
mixed-multihash sweep for the multi-block keccak); ``launches_by_path``
holds its count on each path (the unfused event run, the overlapped runs,
the resumable range's two runs, the two pure-Python paths and the cold
read path's phases included).
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import gc
import hashlib
import json
import multiprocessing
import os
import re
import shutil
import struct
import subprocess
import sys
import tempfile
import threading
import time
import zlib

import numpy as np
import torch

from ipc_proofs_tpu_torch.backend import get_backend
from ipc_proofs_tpu_torch.backend.gpu import KECCAK_CLASSES, SIZE_CLASSES, keccak_class, size_class
from ipc_proofs_tpu_torch.backend.native import load_scan_ext
from ipc_proofs_tpu_torch.core.cid import (
    BLAKE2B_256,
    CID,
    DAG_CBOR,
    IDENTITY,
    KECCAK_256,
    SHA2_256,
    PurePythonCID,
)
from ipc_proofs_tpu_torch.core.hashes import keccak256
from ipc_proofs_tpu_torch.fixtures import ContractFixture, build_chain, build_range_world
from ipc_proofs_tpu_torch.ops import blake2b, keccak, match
from ipc_proofs_tpu_torch.jobs.journal import FRAME_HEADER
from ipc_proofs_tpu_torch.ops.build import build_libraries, cuda_tool
from ipc_proofs_tpu_torch.ops.pack import (
    RATE_BYTES,
    pack_single_block_blake2b,
    pack_single_block_keccak,
    pack_two_block_blake2b,
    pad_blake2b,
)
from ipc_proofs_tpu_torch.proofs import event_verifier as event_verifier_mod
from ipc_proofs_tpu_torch.proofs import range as range_mod
from ipc_proofs_tpu_torch.proofs import verifier as verifier_mod
from ipc_proofs_tpu_torch.proofs.bundle import EventProofBundle, ProofBlock, UnifiedProofBundle
from ipc_proofs_tpu_torch.proofs.event_verifier import verify_event_proof
from ipc_proofs_tpu_torch.proofs.generator import EventProofSpec
from ipc_proofs_tpu_torch.proofs.range import (
    TipsetPair,
    generate_and_verify_range_overlapped,
    generate_event_proofs_for_range,
    generate_event_proofs_for_range_chunked,
    generate_event_proofs_for_range_pipelined,
)
from ipc_proofs_tpu_torch.proofs.storage_batch import MappingSlotSpec, generate_storage_proofs_batch
from ipc_proofs_tpu_torch.ops.verify import autotune_crossover, load_autotune
from ipc_proofs_tpu_torch.proofs.verifier import accept_all, verify_proof_bundle
from ipc_proofs_tpu_torch.proofs.witness import load_witness_store
from ipc_proofs_tpu_torch.state.events import ascii_to_bytes32, left_pad_32
from ipc_proofs_tpu_torch.store import fetchplane as fetchplane_mod
from ipc_proofs_tpu_torch.store.faults import FaultPlan, FaultySession, LocalLotusSession
from ipc_proofs_tpu_torch.store.fetchplane import FetchPlane, PlaneBlockstore
from ipc_proofs_tpu_torch.store.rpc import IntegrityError, LotusClient, RpcError, verify_block_bytes
from ipc_proofs_tpu_torch.storex import SEGMENT_MAGIC, SegmentStore, TieredBlockstore
from ipc_proofs_tpu_torch.storex import segments as segments_mod
from ipc_proofs_tpu_torch.utils.metrics import Metrics
from ipc_proofs_tpu_torch.utils.threads import resolve_thread_budget

# Peak rates of one H100 SXM at its 700 W limit. Memory: HBM3 at 3.35 TB/s
# (NVIDIA data sheet). Integer: the CUDA C++ Programming Guide's
# arithmetic-throughput table for compute capability 9.0 gives, per SM and
# clock, 64 results of 32-bit integer add, bitwise logic, shift, funnel
# shift and compare (the ALU pipe) and 64 of integer multiply-add (IMAD, the
# FMA pipe); four schedulers issue 128 thread-instructions in all. The data
# sheet's 67 TFLOP/s fp32 (128 FMA lanes x 2 flops per SM clock) gives the
# SM clocks per second.
HBM_BYTES_PER_S = 3.35e12
SM_CLOCKS_PER_S = 67e12 / (2 * 128)
PIPES = {  # pipe: (SASS opcodes it runs, None = every one; results per SM clock)
    "alu": (("IADD3", "LOP3", "SHF", "ISETP", "SEL", "LEA", "PRMT"), 64),
    "fma": (("IMAD", "IMUL"), 64),
    "issue": (None, 128),
}
# one compression rotates 288 64-bit words by 24, 16 and 63: 576 funnel shifts
SHF_PER_COMPRESSION = 576

SOURCE = "ipc_proofs_tpu_torch/csrc/blake2b.cu"
KERNELS = (
    # name, TPU function it replaces, lengths (lo, hi] of its rows, loader
    # of its kernel instantiation in the source
    ("blake2b256_single_block", "ipc_proofs_tpu/ops/pallas_kernels.py:337", (-1, 128), "SplitPlanes"),
    ("blake2b256_two_block", "ipc_proofs_tpu/ops/pallas_kernels.py:363", (128, 256), "SplitPlanes"),
    ("blake2b256_blocks", "ipc_proofs_tpu/ops/blake2b_jax.py:140", (256, 520), "PaddedBlocks"),
)
KECCAK_SOURCE = "ipc_proofs_tpu_torch/csrc/keccak.cu"
# the path whose launch count is a kernel's ``launches`` (its slice's path)
# the path whose launches a kernel's row reports: the first path that runs it
OWN_PATH = {
    "blake2b256_single_block": "event path",
    "blake2b256_two_block": "event path",
    "blake2b256_blocks": "event path",
    "keccak256_single_block": "storage path",
    "keccak256_blocks": "mixed-multihash sweep",
}
KECCAK_KERNELS = (
    # name, TPU function it replaces, loader of its kernel instantiation
    ("keccak256_single_block", "ipc_proofs_tpu/ops/pallas_kernels.py:304", "SplitPlanes17"),
    ("keccak256_blocks", "ipc_proofs_tpu/ops/keccak_jax.py:123", "PaddedBlocks34"),
)
KECCAK_ROUNDS = 24
KECCAK_MAX_BLOCKS = 4  # the multi-block case's layout: messages of 136–543 B
SIGNATURE = "NewTopDownMessage(bytes32,uint256)"
TOPIC1 = "calib-subnet-1"
ACTOR_ID = 1001
# BASELINE config 3 (benchmarks/run_configs.py:104-158), full size
CONTRACTS = 256
SLOTS_PER_CONTRACT = 256
N_FILLER_ACTORS = 50  # build_chain's default


def _log(msg: str) -> None:
    print(msg, flush=True)


def _cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean milliseconds per call, CUDA events around ``reps`` warm calls.

    A ~25 ms spin kernel goes first, so the host enqueues the timed calls
    while the card is busy and the card then runs them back to back: the
    events measure device time, not the wrapper's host overhead per call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _to(array: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(array).view(np.int32)).to(device)


_SASS_LINE = re.compile(r"/\*([0-9a-f]+)\*/\s+(?:@!?U?P[T0-9]\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")


def _sass_functions(library, loaders) -> "dict[str, list[tuple[int, str, str]]]":
    """The SASS of each kernel instantiation in ``library`` (keyed by the
    loader its mangled name holds): ``(address, opcode, operands)`` rows."""
    sass = subprocess.run(
        [cuda_tool("cuobjdump"), "-sass", str(library)],
        capture_output=True, text=True, check=True,
    ).stdout
    functions = {}
    for function in sass.split("Function : ")[1:]:
        loader = next(name for name in loaders if name in function.splitlines()[0])
        functions[loader] = [
            (int(addr, 16), op, rest) for addr, op, rest in _SASS_LINE.findall(function)
        ]
    return functions


def _loops(code) -> "list[tuple[int, int]]":
    """``(target, branch)`` address pairs of the backward branches."""
    return [
        (int(target.group(1), 16), addr)
        for addr, op, rest in code
        if op == "BRA"
        and (target := re.search(r"0x([0-9a-f]+)", rest))
        and int(target.group(1), 16) < addr
    ]


def _per_pipe(ops) -> "dict[str, int]":
    return {
        pipe: sum(opcodes is None or op.split(".")[0] in opcodes for op in ops)
        for pipe, (opcodes, _) in PIPES.items()
    }


def sass_per_compression(library) -> "dict[str, dict[str, int]]":
    """Instructions per pipe in one compression of each blake2b kernel
    instantiation (keyed by its loader), counted in the SASS of this build:
    the body of the kernel's block loop, from the target of its one backward
    branch to that branch. A body that ptxas unrolled k times holds k times
    the funnel shifts and is divided by k. The per-row code outside the loop
    is left out, so the bound stays a lower one."""
    counts = {}
    for loader, code in _sass_functions(library, [k[3] for k in KERNELS]).items():
        loops = _loops(code)
        if len(loops) != 1:
            raise AssertionError(f"{loader}: expected one block loop in the SASS, found {loops}")
        lo, hi = loops[0]
        body = [op for addr, op, _ in code if lo <= addr <= hi]
        unrolled = max(1, round(sum(op.startswith("SHF.L.W") for op in body) / SHF_PER_COMPRESSION))
        counts[loader] = {pipe: n // unrolled for pipe, n in _per_pipe(body).items()}
    return counts


def sass_per_permutation(library) -> "dict[str, dict[str, int]]":
    """Instructions per pipe in one absorbed keccak block (one
    keccak-f[1600] permutation) of each kernel instantiation, counted in the
    SASS of this build. The kernel has two loops: the round loop inside the
    block loop. A block costs 24 times the round loop's body (one round; the
    body loads one round constant from ``c[0x3]``, a body unrolled k times
    loads k and counts 24 / k times) plus the rest of the block loop's body
    (the loads and the absorbing xors). The per-row code outside the block
    loop is left out, so the bound stays a lower one."""
    counts = {}
    for loader, code in _sass_functions(library, [k[2] for k in KECCAK_KERNELS]).items():
        loops = sorted(_loops(code), key=lambda loop: loop[1] - loop[0])
        if len(loops) != 2 or not loops[1][0] <= loops[0][0] < loops[0][1] <= loops[1][1]:
            raise AssertionError(f"{loader}: expected a round loop inside a block loop, found {loops}")
        (r_lo, r_hi), (b_lo, b_hi) = loops
        rounds = [(op, rest) for addr, op, rest in code if r_lo <= addr <= r_hi]
        absorb = [op for addr, op, _ in code if b_lo <= addr <= b_hi and not r_lo <= addr <= r_hi]
        unrolled = sum("c[0x3]" in rest for _, rest in rounds)
        if unrolled < 1 or KECCAK_ROUNDS % unrolled:
            raise AssertionError(f"{loader}: {unrolled} round-constant loads in the round loop")
        per_body = _per_pipe([op for op, _ in rounds])
        per_block = _per_pipe(absorb)
        counts[loader] = {
            pipe: KECCAK_ROUNDS // unrolled * per_body[pipe] + per_block[pipe] for pipe in PIPES
        }
    return counts


def _ops_ms(per_unit: "dict[str, int]", units: int) -> float:
    """The busiest pipe's time for ``units`` compressions or permutations."""
    return 1e3 * units * max(
        per_unit[pipe] / (rate * SM_CLOCKS_PER_S) for pipe, (_, rate) in PIPES.items()
    )


@dataclasses.dataclass
class KernelCase:
    """One kernel's inputs on the card, plus what its bound is made of."""

    name: str
    loader: str
    args: tuple
    plain: object
    golden: list  # a host golden-model sample: (row, expected digest bytes)
    bytes_moved: int
    units: int  # blake2b compressions or keccak permutations the data needs


def _blake2b(message: bytes) -> bytes:
    return hashlib.blake2b(message, digest_size=32).digest()


def _kernel_cases(n_messages: int, seed: int, device) -> "list[KernelCase]":
    """``n_messages`` random messages split into thirds by size class, each
    third laid out as its blake2b kernel takes it."""
    rng = np.random.default_rng(seed)
    cases = []
    sizes = (n_messages // 3, n_messages // 3, n_messages - 2 * (n_messages // 3))
    for (name, _, (lo, hi), loader), rows in zip(KERNELS, sizes):
        if not size_class(lo + 1) == size_class(hi) == name:
            raise AssertionError(f"lengths {lo + 1}..{hi} do not route to {name}")
        cap = max(128, -(-hi // 128) * 128)
        lengths = rng.integers(lo + 1, hi + 1, size=rows).astype(np.int32)
        raw = rng.integers(0, 256, size=(rows, cap), dtype=np.uint8)
        raw[np.arange(cap)[None, :] >= lengths[:, None]] = 0
        sample = rng.choice(rows, size=min(4096, rows), replace=False)
        golden = [(int(i), _blake2b(raw[i, : lengths[i]].tobytes())) for i in sample]
        n_blocks = np.maximum(-(-lengths // 128), 1).astype(np.int32)
        if name == "blake2b256_blocks":
            blocks = raw.reshape(rows, cap // 128, 128).view(np.uint32)
            args = (_to(blocks, device), _to(n_blocks, device), _to(lengths, device))
            plain = blake2b.blake2b256_blocks_plain
            bytes_moved = int(n_blocks.sum()) * 128 + rows * (4 + 4 + 32)
        else:
            words = raw.view(np.uint32)
            args = (
                _to(words[:, 0::2], device),
                _to(words[:, 1::2], device),
                _to(lengths[:, None], device),
            )
            plain = getattr(blake2b, name + "_plain")
            bytes_moved = rows * (cap + 4 + 32)
        cases.append(
            KernelCase(name, loader, args, plain, golden, bytes_moved, int(n_blocks.sum()))
        )
    return cases


def _keccak_padded(rng, rows: int, lo: int, hi: int, max_blocks: int):
    """``rows`` random messages of lo..hi bytes, keccak-padded in place
    (``0x01`` after the message, ``0x80`` on the last byte of its last rate
    block) in ``[rows, max_blocks * 136]`` bytes; returns (raw, lengths,
    block counts)."""
    cap = max_blocks * RATE_BYTES
    lengths = rng.integers(lo, hi + 1, size=rows)
    raw = rng.integers(0, 256, size=(rows, cap), dtype=np.uint8)
    raw[np.arange(cap)[None, :] >= lengths[:, None]] = 0
    n_blocks = (lengths // RATE_BYTES + 1).astype(np.int32)
    every = np.arange(rows)
    raw[every, lengths] ^= 0x01
    raw[every, n_blocks * RATE_BYTES - 1] ^= 0x80
    return raw, lengths, n_blocks


def _keccak_cases(n_single: int, n_multi: int, seed: int, device) -> "list[KernelCase]":
    """``n_single`` messages of 0–135 B for the single-block kernel and
    ``n_multi`` of 136–543 B for the multi-block one, laid out as each
    takes them. Two multi-block rows get a block count of 0 (the digest
    stays zero) and two 4-block rows one above the layout's 4 (they absorb
    4 blocks, so their digest is still the message's)."""
    rng = np.random.default_rng(seed + 1)
    cases = []
    for (name, _, loader), (rows, lo, hi, max_blocks) in zip(
        KECCAK_KERNELS,
        ((n_single, 0, RATE_BYTES - 1, 1), (n_multi, RATE_BYTES, 4 * RATE_BYTES - 1, KECCAK_MAX_BLOCKS)),
    ):
        if not keccak_class(lo) == keccak_class(hi) == name:
            raise AssertionError(f"lengths {lo}..{hi} do not route to {name}")
        raw, lengths, n_blocks = _keccak_padded(rng, rows, lo, hi, max_blocks)
        sample = rng.choice(rows, size=min(4096, rows), replace=False)
        messages = {int(i): raw[i, : lengths[i]].tobytes() for i in sample}
        if name == "keccak256_blocks":
            empty = [int(i) for i in sample[:2]]
            over = [int(i) for i in sample[2:] if n_blocks[i] == max_blocks][:2]
            n_blocks[empty] = 0
            n_blocks[over] = max_blocks + 3
            golden = [(i, bytes(32) if i in empty else keccak256(m)) for i, m in messages.items()]
            blocks = raw.reshape(rows, max_blocks, RATE_BYTES).view(np.uint32)
            args = (_to(blocks, device), _to(n_blocks, device))
            used = int(np.clip(n_blocks, 0, max_blocks).sum())
            bytes_moved = used * RATE_BYTES + rows * (4 + 32)
        else:
            golden = [(i, keccak256(m)) for i, m in messages.items()]
            words = raw.view(np.uint32)
            args = (_to(words[:, 0::2], device), _to(words[:, 1::2], device))
            used = rows
            bytes_moved = rows * (RATE_BYTES + 32)
        plain = getattr(keccak, name + "_plain")
        cases.append(KernelCase(name, loader, args, plain, golden, bytes_moved, used))
    return cases


def _max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item()) if a.numel() else 0


def kernel_phase(
    cases: "list[KernelCase]", module, per_unit: "dict[str, dict[str, int]]"
) -> "dict[str, dict]":
    """Each case's kernel (``module.<name>``) against its plain version on
    the card and against the host golden sample, then its time, its plain
    version's and its bound."""
    results = {}
    for case in cases:
        kernel = getattr(module, case.name)
        out = kernel(*case.args)
        ref = case.plain(*case.args)
        torch.cuda.synchronize()
        err = _max_abs_err(out, ref)
        if err != 0:
            raise AssertionError(f"{case.name}: kernel differs from its plain version")
        words = out.cpu().numpy().view(np.uint32)
        for row, digest in case.golden:
            if words[row].astype("<u4").tobytes() != digest:
                raise AssertionError(f"{case.name}: row {row} differs from the host golden model")
        ms = _cuda_ms(lambda: kernel(*case.args), reps=20)
        plain_ms = _cuda_ms(lambda: case.plain(*case.args), reps=3, warmup=1)
        bytes_ms = case.bytes_moved / HBM_BYTES_PER_S * 1e3
        ops_ms = _ops_ms(per_unit[case.loader], case.units)
        results[case.name] = {
            "rows": case.args[0].shape[0],
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        }
        _log(
            f"kernel {case.name}: rows={results[case.name]['rows']} equal to plain "
            f"and to the host golden model on {len(case.golden)} rows"
        )
    return results


def _classes(blocks) -> "dict[str, list[int]]":
    """Witness block positions per size class."""
    out: "dict[str, list[int]]" = {name: [] for name in SIZE_CLASSES}
    for i, block in enumerate(blocks):
        out[size_class(len(block.data))].append(i)
    return out


def _check_witness_shapes(blocks, device) -> "list[str]":
    """Each kernel against its plain version on the witness's own blocks,
    packed as the backend packs them; returns the kernels the witness has
    blocks for."""
    by_class = {k: [blocks[i].data for i in v] for k, v in _classes(blocks).items()}
    present = [name for name, data in by_class.items() if data]
    for name in present:
        if name == "blake2b256_blocks":
            packed, n_blocks, lengths = pad_blake2b(by_class[name])
            args = (_to(packed, device), _to(n_blocks, device), _to(lengths, device))
        else:
            packer = {
                "blake2b256_single_block": pack_single_block_blake2b,
                "blake2b256_two_block": pack_two_block_blake2b,
            }[name]
            m_lo, m_hi, lengths, _ = packer(by_class[name])
            args = (_to(m_lo, device), _to(m_hi, device), _to(lengths, device))
        if not torch.equal(getattr(blake2b, name)(*args), getattr(blake2b, name + "_plain")(*args)):
            raise AssertionError(f"{name}: kernel differs from plain at the witness shape")
    return present


def _check_slot_keccak(preimages, device) -> None:
    """The single-block keccak kernel against its plain version on a path's
    own slot preimages, packed as the backend packs them."""
    lo, hi, _ = pack_single_block_keccak(preimages)
    args = (_to(lo, device), _to(hi, device))
    if not torch.equal(keccak.keccak256_single_block(*args), keccak.keccak256_single_block_plain(*args)):
        raise AssertionError("keccak256_single_block: kernel differs from plain at the path's shape")


def _reject_changed_value(bundle) -> None:
    """A storage proof whose value was changed must get a false verdict."""
    proof = bundle.storage_proofs[1 % len(bundle.storage_proofs)]
    value = "0x" + "00" * 31 + ("fe" if proof.value.endswith("ff") else "ff")
    verdict = verify_proof_bundle(
        UnifiedProofBundle(
            storage_proofs=[dataclasses.replace(proof, value=value)],
            event_proofs=[],
            blocks=bundle.blocks,
        ),
        accept_all,
        accept_all,
    ).storage_results
    if verdict != [False]:
        raise AssertionError(f"a changed storage value was given the verdict {verdict}")


def _reset_counts() -> None:
    blake2b.reset_launch_counts()
    keccak.reset_launch_counts()
    for name in match.LAUNCHES:
        match.LAUNCHES[name] = 0


def _counts() -> "dict[str, int]":
    return dict(blake2b.LAUNCHES, **keccak.LAUNCHES, **match.LAUNCHES)


def _require_launched(path: str, launches: "dict[str, int]", names) -> None:
    idle = [name for name in names if launches[name] == 0]
    if idle:
        raise AssertionError(f"{path} did not launch: {idle}")


def _reject_flipped_blocks(bundle, backend) -> None:
    """A flipped byte in one witness block of each size class must make the
    CID recompute raise ValueError (the tampered bundle keeps at most one
    storage proof, so a missed rejection fails fast)."""
    for name, positions in _classes(bundle.blocks).items():
        if not positions:
            raise AssertionError(f"the witness has no block in the class of {name}")
        index = positions[len(positions) // 2]
        block = bundle.blocks[index]
        flipped = bytearray(block.data)
        flipped[len(flipped) // 2] ^= 0x01
        tampered = UnifiedProofBundle(
            storage_proofs=bundle.storage_proofs[:1],
            event_proofs=bundle.event_proofs,
            blocks=bundle.blocks[:index] + [ProofBlock(block.cid, bytes(flipped))] + bundle.blocks[index + 1 :],
        )
        try:
            verify_proof_bundle(
                tampered, accept_all, accept_all, verify_witness_cids=True, cid_backend=backend
            )
        except ValueError:
            continue
        raise AssertionError(f"a flipped byte in a {len(block.data)}-byte block was accepted")


def _verify_cids_s(bundle, backend) -> float:
    """Seconds of the witness CID recompute alone (outside a counted window)."""
    chain = [b for b in bundle.blocks if b.cid.mh_code == BLAKE2B_256]
    t0 = time.perf_counter()
    if not backend.verify_block_cids([b.cid.digest for b in chain], [b.data for b in chain]):
        raise AssertionError("witness CID recompute failed on an untampered bundle")
    return time.perf_counter() - t0


# The native branches of the paths: each entry point is wrapped while a path
# runs, and the path fails unless every one it needs ran and returned its
# native result (not the pure-Python fallback's None / False).
NATIVE_ENTRIES = (
    (range_mod, "_scan_and_match", lambda out: out[1]),
    (range_mod, "_record_pass2_native", lambda out: out is not None),
    (range_mod, "generate_storage_proofs_for_pairs", lambda out: out is not None),
    (event_verifier_mod, "reconstruct_execution_orders_batch", lambda out: out is not None),
    (event_verifier_mod, "scan_events_flat", lambda out: out is not None),
    (verifier_mod, "verify_storage_proofs_batch", lambda out: out is not None),
)
EVENT_BRANCHES = (
    "_scan_and_match",
    "_record_pass2_native",
    "reconstruct_execution_orders_batch",
    "scan_events_flat",
)


@contextlib.contextmanager
def _native_branches(path: str, expected):
    """Fail ``path`` unless each entry named in ``expected`` ran in the block
    and every call of it took the native branch."""
    seen: "dict[str, list[bool]]" = {}
    originals = []

    def spy(fn, name, ok):
        def wrapper(*args, **kwargs):
            out = fn(*args, **kwargs)
            seen.setdefault(name, []).append(bool(ok(out)))
            return out

        return wrapper

    for module, name, ok in NATIVE_ENTRIES:
        originals.append((module, name, getattr(module, name)))
        setattr(module, name, spy(getattr(module, name), name, ok))
    try:
        yield seen
    finally:
        for module, name, fn in originals:
            setattr(module, name, fn)
    missed = [name for name in expected if not seen.get(name) or not all(seen[name])]
    if missed:
        raise AssertionError(f"{path}: the native branch did not run for {missed} ({seen})")
    _log(f"{path}: native branches ran: " + ", ".join(f"{k} x{len(v)}" for k, v in sorted(seen.items())))


@contextlib.contextmanager
def _env(name: str, value: str):
    saved = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if saved is None:
            del os.environ[name]
        else:
            os.environ[name] = saved


def _host_info() -> str:
    return f"scan_threads={load_scan_ext().scan_threads()} cpus={len(os.sched_getaffinity(0))}"


class _RecordingBackend:
    """The card's backend, recording every kernel call a path makes with
    what the kernels returned, from any number of host threads: each
    direct ``blake2b256_batch`` call (the verifier's TxMeta recompute) in
    ``batches``, each ``verify_block_cids`` batch (the witness recompute)
    in ``cid_batches``, each ``keccak256_batch`` call and each fingerprint
    mask with its inputs. `_check_recorded` holds them against the plain
    versions afterwards."""

    def __init__(self, backend):
        self._backend = backend
        self._lock = threading.Lock()
        self.batches: "list[tuple[list[bytes], list[bytes]]]" = []
        self.cid_batches: "list[tuple[list[bytes], list[bytes]]]" = []
        self.keccak_batches: "list[tuple[list[bytes], list[bytes]]]" = []
        self.masks: "list[tuple[tuple, np.ndarray]]" = []
        self.event_masks: "list[tuple[tuple, list]]" = []

    def __getattr__(self, name):
        return getattr(self._backend, name)

    def _record(self, into: list, entry) -> None:
        with self._lock:
            into.append(entry)

    def blake2b256_batch(self, messages):
        digests = self._backend.blake2b256_batch(messages)
        self._record(self.batches, (list(messages), list(digests)))
        return digests

    def verify_block_cids(self, cids_digests, blocks):
        digests = self._backend.blake2b256_batch(blocks)
        self._record(self.cid_batches, (list(blocks), list(digests)))
        return len(digests) == len(cids_digests) and all(d == e for d, e in zip(digests, cids_digests))

    def keccak256_batch(self, messages):
        digests = self._backend.keccak256_batch(messages)
        self._record(self.keccak_batches, (list(messages), list(digests)))
        return digests

    def event_match_mask_fp(self, *args):
        mask = self._backend.event_match_mask_fp(*args)
        self._record(self.masks, (args, np.array(mask, copy=True)))
        return mask

    def event_match_mask(self, events, *args):
        mask = self._backend.event_match_mask(events, *args)
        self._record(self.event_masks, ((list(events), *args), list(mask)))
        return mask


def _check_recorded(label: str, recording: _RecordingBackend, plain_cache: dict) -> dict:
    """Every kernel result a path's run recorded, at the shapes the path
    gave the kernels, against the plain PyTorch versions on the same inputs
    (on the CPU, tolerance 0) and the host golden models (hashlib,
    ``core.hashes.keccak256``); each fingerprint mask against the plain
    mask on the same arrays. ``plain_cache`` keeps plain digests across
    runs of one world. Returns the batch and row counts it checked."""
    cpu = get_backend("gpu", device="cpu")
    checked = {}
    for kind, batches, plain, golden in (
        ("blake2b", recording.batches + recording.cid_batches, cpu.blake2b256_batch, _blake2b),
        ("keccak", recording.keccak_batches, cpu.keccak256_batch, keccak256),
    ):
        cache = plain_cache.setdefault(kind, {})
        todo = list({m for messages, _ in batches for m in messages if m not in cache})
        cache.update(zip(todo, plain(todo)))
        for messages, digests in batches:
            if digests != [cache[m] for m in messages]:
                raise AssertionError(f"{label}: a {kind} batch differs from the plain versions")
            if digests != [golden(m) for m in messages]:
                raise AssertionError(f"{label}: a {kind} batch differs from the host golden model")
        checked[kind] = {"batches": len(batches), "rows": sum(len(m) for m, _ in batches)}
    for args, mask in recording.masks:
        if not np.array_equal(mask, cpu.event_match_mask_fp(*args)):
            raise AssertionError(f"{label}: a fingerprint mask differs from the plain mask")
    checked["event_match_mask_fp"] = {"calls": len(recording.masks), "rows": sum(len(a[0]) for a, _ in recording.masks)}
    for args, mask in recording.event_masks:
        if mask != cpu.event_match_mask(*args):
            raise AssertionError(f"{label}: a flat event mask differs from the plain mask")
    checked["event_match_mask"] = {
        "calls": len(recording.event_masks), "rows": sum(len(a[0]) for a, _ in recording.event_masks)
    }
    return checked


def _check_txmeta_batch(recording: _RecordingBackend) -> int:
    """The event path's one TxMeta batch, as the card computed it during the
    path, against the plain PyTorch versions on the same messages and
    against the host golden model: on an honest bundle the batch must be
    clean. Returns its row count."""
    if len(recording.batches) != 1:
        raise AssertionError(f"event path: {len(recording.batches)} TxMeta batches, expected 1")
    [(messages, digests)] = recording.batches
    if not messages:
        raise AssertionError("event path: the TxMeta batch is empty")
    if digests != get_backend("gpu", device="cpu").blake2b256_batch(messages):
        raise AssertionError("event path: the TxMeta batch differs from the plain versions")
    if digests != [_blake2b(m) for m in messages]:
        raise AssertionError("event path: the TxMeta batch differs from hashlib")
    return len(messages)


def _generate_and_verify(generate, backend):
    """One path's run, counts from 0: ``generate(metrics)`` then the
    verifier with the CID recompute on the card. The garbage of the world's
    set-up is collected first, outside the timed window. Returns (bundle,
    result, metrics, stage ms, launches)."""
    gc.collect()
    metrics = Metrics()
    _reset_counts()
    t0 = time.perf_counter()
    bundle = generate(metrics)
    t1 = time.perf_counter()
    result = verify_proof_bundle(
        bundle, accept_all, accept_all, verify_witness_cids=True, cid_backend=backend
    )
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    stages = {k: v * 1e3 for k, v in metrics.stage_s.items()}
    stages.update(generate_total=(t1 - t0) * 1e3, verify_total=(t2 - t1) * 1e3)
    return bundle, result, metrics, stages, _counts()


def _event_generate(store, pairs, backend):
    spec = EventProofSpec(SIGNATURE, TOPIC1, ACTOR_ID)
    return lambda metrics: generate_event_proofs_for_range(
        store, pairs, spec, match_backend=backend, metrics=metrics
    )


def _profiled(run):
    """``run()`` under torch.profiler: its result, and the device ms of the
    CUDA kernels it launched (None when the profiler saw no CUDA kernel:
    then not measured)."""
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        out = run()
    busy_us = sum(
        getattr(e, "self_device_time_total", 0) or 0
        for e in prof.key_averages()
        if str(getattr(e, "device_type", "")).endswith("CUDA")
    )
    return out, (busy_us / 1e3 if busy_us > 0 else None)


def _device_busy(generate, backend) -> dict:
    """A repeat of a path's run (`_generate_and_verify`) under
    torch.profiler: its stage ms and the card's busy ms."""
    (_, _, _, stages, _), busy_ms = _profiled(lambda: _generate_and_verify(generate, backend))
    return {"stage_ms": stages, "busy_ms": busy_ms}


def event_world(n_pairs: int):
    """BASELINE config 2's world: ``build_range_world(n_pairs, 16, 4, 0.01)``."""
    t0 = time.perf_counter()
    store, pairs, n_matching = build_range_world(n_pairs, 16, 4, 0.01)
    _log(
        f"world: {n_pairs} pairs, {len(store)} blocks, {n_matching} matching receipts, "
        f"{time.perf_counter() - t0:.1f} s"
    )
    return store, pairs, n_matching


def event_path(world, device) -> dict:
    """BASELINE config 2: the 4096-pair event-proof range (``world``, from
    `event_world`) through the native branches (fused C scan+match, C pass
    2, C witness materialization, batched replay with the TxMeta recompute
    on the card)."""
    store, pairs, n_matching = world
    n_pairs = len(pairs)
    backend = get_backend("gpu")
    recording = _RecordingBackend(backend)

    with _native_branches("event path", EVENT_BRANCHES):
        bundle, result, metrics, stages, launches = _generate_and_verify(
            _event_generate(store, pairs, backend), recording
        )
    wall_ms = stages["generate_total"] + stages["verify_total"]
    if len(result.event_results) != n_matching or not all(result.event_results):
        raise AssertionError("event path: a verdict is false")
    if len(bundle.event_proofs) != n_matching:
        raise AssertionError(
            f"event path: {len(bundle.event_proofs)} proofs for {n_matching} matching receipts"
        )
    _require_launched("event path", launches, SIZE_CLASSES)
    # the witness recompute and the batched TxMeta recompute each launch it
    if launches["blake2b256_single_block"] < 2:
        raise AssertionError(f"event path: no TxMeta recompute launch ({launches})")
    txmeta_rows = _check_txmeta_batch(recording)
    _log(f"event path: TxMeta batch of {txmeta_rows} rows equal to plain and to hashlib")

    # the unfused branch: flat arrays, the fingerprint mask on the card
    unfused_metrics = Metrics()
    with _env("IPC_SCAN_FUSED_MATCH", "0"):
        _reset_counts()
        t1 = time.perf_counter()
        unfused = _event_generate(store, pairs, backend)(unfused_metrics)
        unfused_ms = (time.perf_counter() - t1) * 1e3
        unfused_launches = _counts()
    if unfused.to_json() != bundle.to_json():
        raise AssertionError("event path: the unfused bundle differs from the fused one")
    if unfused_launches["event_match_mask_fp"] != 1:
        raise AssertionError(f"event path: unfused mask launches {unfused_launches}")

    verify_cids_s = _verify_cids_s(bundle, backend)
    _check_witness_shapes(bundle.blocks, device)
    _reject_flipped_blocks(bundle, backend)
    profiled = _device_busy(_event_generate(store, pairs, backend), backend)
    return {
        "pairs": n_pairs,
        "proofs": len(bundle.event_proofs),
        "events": metrics.counters.get("range_events", 0),
        "witness_blocks": {name: len(v) for name, v in _classes(bundle.blocks).items()},
        "txmeta_rows": txmeta_rows,
        "stage_ms": dict(stages, verify_cids=verify_cids_s * 1e3),
        "unfused": {
            "generate_total_ms": unfused_ms,
            "stage_ms": {k: v * 1e3 for k, v in unfused_metrics.stage_s.items()},
            "launches": unfused_launches,
        },
        "proofs_per_s": len(bundle.event_proofs) / wall_ms * 1e3,
        "profiled_run": profiled,
        "launches": launches,
        "host": _host_info(),
    }


def _staged_verify(backend, seen: "list | None" = None):
    """The counterpart of the JAX package's ``bench.py`` ``_staged_verify``
    as a ``verify_chunk`` closure: the witness CID recompute on the card
    (``verify_block_cids`` over the chunk's blake2b blocks), then the
    batched replay with the card's TxMeta recompute; returns (verdicts,
    stage seconds). Each chunk bundle it verifies is appended to ``seen``
    (list appends are atomic across the verify workers)."""

    def verify_chunk(bundle):
        if seen is not None:
            seen.append(bundle)
        stages = {}
        t0 = time.perf_counter()
        chain = [b for b in bundle.blocks if b.cid.mh_code == BLAKE2B_256]
        if chain and not backend.verify_block_cids([b.cid.digest for b in chain], [b.data for b in chain]):
            raise ValueError("witness CID mismatch")
        stages["verify_cids"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        store = load_witness_store(bundle.blocks, verify_cids=False)
        stages["load_witness"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        results = verify_event_proof(
            EventProofBundle(proofs=bundle.event_proofs, blocks=bundle.blocks),
            accept_all, accept_all, store=store, hash_backend=backend,
        )
        stages["verify_replay"] = time.perf_counter() - t0
        return results, stages

    return verify_chunk


OVERLAP_STAGES = ("range_scan", "range_match", "range_record", "range_merge", "range_verify")


def _overlapped_run(store, pairs, spec, chunk_size, budget, backend, seen=None):
    """One run of the overlapped driver, counts from 0: (merged bundle,
    per-chunk (verdicts, stage s), metrics, wall ms, launches); the chunk
    bundles it verified go to ``seen``."""
    gc.collect()
    metrics = Metrics()
    _reset_counts()
    t0 = time.perf_counter()
    merged, chunk_out = generate_and_verify_range_overlapped(
        store, pairs, spec, chunk_size=chunk_size, verify_chunk=_staged_verify(backend, seen),
        match_backend=backend, metrics=metrics, threads=budget.total,
        scan_threads=budget.scan_workers, record_workers=budget.record_workers,
        verify_workers=budget.verify_workers,
    )
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    return merged, chunk_out, metrics, wall_ms, _counts()


def _check_overlapped(label, merged, chunk_out, metrics, expected_json, whole, recording, seen, device, plain_cache):
    """A run of the overlapped driver: its bytes, its verdicts, no fallback
    and no retried scan, and every kernel result it recorded held against
    the plain versions; then each kernel is held against its plain version
    at each verified chunk bundle's shapes. Returns what was checked."""
    if merged.to_json() != expected_json:
        raise AssertionError(f"{label}: the merged bundle differs from the chunked driver's")
    flat = [v for verdicts, _ in chunk_out for v in verdicts]
    if not all(flat) or flat != whole:
        raise AssertionError(f"{label}: per-chunk verdicts differ from whole-bundle verification")
    for counter in ("range_pipeline_serial_fallback", "range_scan_retries"):
        if metrics.counter_value(counter):
            raise AssertionError(f"{label}: {counter} = {metrics.counter_value(counter)} on the card host")
    with_chain = sum(any(b.cid.mh_code == BLAKE2B_256 for b in bundle.blocks) for bundle in seen)
    if len(seen) != len(chunk_out) or len(recording.cid_batches) != with_chain:
        raise AssertionError(
            f"{label}: {len(seen)} chunks verified, {len(recording.cid_batches)} witness "
            f"batches recorded, for {len(chunk_out)} chunks ({with_chain} with blake2b blocks)"
        )
    checked = _check_recorded(label, recording, plain_cache)
    for bundle in seen:
        _check_witness_shapes(bundle.blocks, device)
    _log(f"{label}: kernel results equal to plain at the path's shapes: {checked}")
    return checked


def overlapped_path(world, device, serial_proofs_per_s: float) -> dict:
    """The event path's world through the generate ∥ verify driver, the
    thread budget of this host, then its unfused rerun."""
    store, pairs, n_matching = world
    backend = get_backend("gpu")
    budget = resolve_thread_budget()
    if budget.scan_workers * budget.native_scan_threads > budget.total:
        raise AssertionError(f"thread budget oversubscribes: {budget}")
    chunk_size = max(1, min(1024, len(pairs) // max(4, 2 * budget.scan_workers)))
    spec = EventProofSpec(SIGNATURE, TOPIC1, ACTOR_ID)
    # what the overlapped run must reproduce (launches outside any counted window)
    chunk_bundles: list = []
    chunked = generate_event_proofs_for_range_chunked(
        store, pairs, spec, chunk_size=chunk_size, match_backend=backend, on_chunk=chunk_bundles.append
    )
    expected_json = chunked.to_json()
    whole = verify_proof_bundle(chunked, accept_all, accept_all, cid_backend=backend).event_results
    if len(whole) != n_matching or not all(whole):
        raise AssertionError("overlapped event path: whole-bundle verification failed")
    # the same chunk verifications one after another, nothing else running:
    # what a chunk's verify costs without the other stages' threads
    alone_ms: dict = {}
    verify_chunk = _staged_verify(backend)
    for bundle in chunk_bundles:
        for name, seconds in verify_chunk(bundle)[1].items():
            alone_ms[name] = alone_ms.get(name, 0.0) + seconds * 1e3

    plain_cache: dict = {}
    recording, seen = _RecordingBackend(backend), []
    with _native_branches("overlapped event path", EVENT_BRANCHES):
        merged, chunk_out, metrics, wall_ms, launches = _overlapped_run(
            store, pairs, spec, chunk_size, budget, recording, seen
        )
    present = [name for name, v in _classes(merged.blocks).items() if v]
    _require_launched("overlapped event path", launches, present)
    checked = _check_overlapped(
        "overlapped event path", merged, chunk_out, metrics, expected_json, whole, recording, seen,
        device, plain_cache,
    )
    snap = metrics.snapshot()
    verify_stage_ms: dict = {}
    for _, stages in chunk_out:
        for name, seconds in stages.items():
            verify_stage_ms[name] = verify_stage_ms.get(name, 0.0) + seconds * 1e3

    (_, _, profiled_metrics, profiled_wall_ms, _), busy_ms = _profiled(
        lambda: _overlapped_run(store, pairs, spec, chunk_size, budget, backend)
    )

    u_recording, u_seen = _RecordingBackend(backend), []
    with _env("IPC_SCAN_FUSED_MATCH", "0"):
        u_merged, u_out, u_metrics, u_wall_ms, u_launches = _overlapped_run(
            store, pairs, spec, chunk_size, budget, u_recording, u_seen
        )
    if u_launches["event_match_mask_fp"] < 1:
        raise AssertionError(f"overlapped unfused rerun: no fingerprint mask launch ({u_launches})")
    u_checked = _check_overlapped(
        "overlapped unfused rerun", u_merged, u_out, u_metrics, expected_json, whole, u_recording,
        u_seen, device, plain_cache,
    )
    if u_checked["event_match_mask_fp"]["calls"] != u_launches["event_match_mask_fp"]:
        raise AssertionError(f"overlapped unfused rerun: masks recorded {u_checked}, launched {u_launches}")
    return {
        "pairs": len(pairs),
        "proofs": len(merged.event_proofs),
        "chunk_size": chunk_size,
        "chunks": len(chunk_out),
        "budget": dataclasses.asdict(budget),
        "wall_ms": wall_ms,
        "proofs_per_s": len(merged.event_proofs) / wall_ms * 1e3,
        "serial_proofs_per_s": serial_proofs_per_s,
        "overlap_efficiency": snap.get("overlap_efficiency"),
        "stage_busy_ms": {k: v["total_s"] * 1e3 for k, v in snap["timers"].items()},
        "stage_wall_ms": {k: v["wall_s"] * 1e3 for k, v in snap["timers"].items()},
        "verify_chunk_ms": verify_stage_ms,
        "verify_chunks_alone_ms": alone_ms,
        "launches": launches,
        "checked": checked,
        "profiled_run": {
            "wall_ms": profiled_wall_ms,
            "busy_ms": busy_ms,
            "overlap_efficiency": profiled_metrics.overlap_efficiency(),
        },
        "unfused": {
            "wall_ms": u_wall_ms,
            "proofs_per_s": len(u_merged.event_proofs) / u_wall_ms * 1e3,
            "overlap_efficiency": u_metrics.overlap_efficiency(),
            "stage_busy_ms": {k: v * 1e3 for k, v in u_metrics.stage_s.items()},
            "counters": {
                k: u_metrics.counter_value(k) for k in ("range_match_coalesced", "range_scan_retries")
            },
            "launches": u_launches,
            "checked": u_checked,
        },
        "host": _host_info(),
    }


def _storage_world(n_contracts: int, n_slots: int, backend):
    """BASELINE config 3's contracts: slot keys hashed on the card, values
    ``(i % 251).to_bytes(2, "big")``, direct HAMT storage."""
    preimages = [
        ascii_to_bytes32(f"subnet-{c}") + i.to_bytes(32, "big")
        for c in range(n_contracts)
        for i in range(n_slots)
    ]
    keys = backend.keccak256_batch(preimages)
    contracts = [
        ContractFixture(
            actor_id=ACTOR_ID + c,
            storage={keys[c * n_slots + i]: (i % 251).to_bytes(2, "big") for i in range(n_slots)},
        )
        for c in range(n_contracts)
    ]
    world = build_chain(contracts, [], n_filler_actors=N_FILLER_ACTORS)
    specs = [
        MappingSlotSpec(ACTOR_ID + c, f"subnet-{c}", i)
        for c in range(n_contracts)
        for i in range(n_slots)
    ]
    return world, specs, keys, preimages


def _storage_generate(world, specs, backend):
    """The storage proofs of the world's one pair through the range driver's
    storage leg: slot keccaks on the card, one batched C walk of the actors
    tree and one of the storage HAMTs, one C witness materialization. The
    world has no events, so the range's event scan finds none."""
    pairs = [TipsetPair(world.parent, world.child)]
    spec = EventProofSpec(SIGNATURE, TOPIC1, ACTOR_ID)
    return lambda metrics: generate_event_proofs_for_range(
        world.store, pairs, spec, match_backend=backend, metrics=metrics, storage_specs=specs
    )


def storage_path(n_contracts: int, n_slots: int, seed: int, device) -> dict:
    """BASELINE config 3: ``n_contracts`` EVM contracts × ``n_slots``
    mapping slots at one parent/child pair, proved through the range
    driver's storage leg (`generate_storage_proofs_for_pairs`) and verified
    by the batched storage verifier, the hashing on the card."""
    backend = get_backend("gpu")
    t0 = time.perf_counter()
    world, specs, keys, preimages = _storage_world(n_contracts, n_slots, backend)
    rng = np.random.default_rng(seed + 2)
    for k in rng.choice(len(keys), size=min(4096, len(keys)), replace=False):
        if keys[k] != keccak256(preimages[k]):
            raise AssertionError(f"slot key {k} differs from core.hashes.keccak256")
    world_s = time.perf_counter() - t0
    _log(
        f"storage world: {n_contracts} contracts x {n_slots} slots, {len(world.store)} blocks, "
        f"{world_s:.1f} s (slot keys on the card, 4,096 checked against core.hashes.keccak256)"
    )
    with _native_branches(
        "storage path", ["generate_storage_proofs_for_pairs", "verify_storage_proofs_batch"]
    ):
        bundle, result, _, stages, launches = _generate_and_verify(
            _storage_generate(world, specs, backend), backend
        )
    wall_ms = stages["generate_total"] + stages["verify_total"]
    if len(result.storage_results) != len(specs) or not all(result.storage_results):
        raise AssertionError("storage path: a verdict is false")
    expected = [
        ("0x" + keys[k].hex(), "0x" + left_pad_32((k % n_slots % 251).to_bytes(2, "big")).hex())
        for k in range(len(specs))
    ]
    if bundle.event_proofs or [(p.slot, p.value) for p in bundle.storage_proofs] != expected:
        raise AssertionError("storage path: a proof's slot or value is not the fixture's")
    _require_launched("storage path", launches, ["keccak256_single_block", *SIZE_CLASSES])

    verify_cids_s = _verify_cids_s(bundle, backend)
    _check_slot_keccak(preimages, device)
    _check_witness_shapes(bundle.blocks, device)
    _reject_flipped_blocks(bundle, backend)
    _reject_changed_value(bundle)
    return {
        "contracts": n_contracts,
        "slots": len(specs),
        "proofs": len(bundle.storage_proofs),
        "witness_blocks": {name: len(v) for name, v in _classes(bundle.blocks).items()},
        "stage_ms": dict(stages, world_build=world_s * 1e3, verify_cids=verify_cids_s * 1e3),
        "proofs_per_s": len(bundle.storage_proofs) / wall_ms * 1e3,
        "launches": launches,
        "host": _host_info(),
    }


def mixed_range(n_pairs: int, device) -> dict:
    """The topdown nonce slot proved at every pair of a small event range
    through the native range branches, the range's slot keccak hashed once
    on the card. The range world's contract has an empty storage HAMT, so
    every proof reads value 0 at any slot: the slot itself is checked
    against the host keccak."""
    store, pairs, n_matching = build_range_world(n_pairs, 16, 4, 0.01)
    backend = get_backend("gpu")
    spec = MappingSlotSpec(ACTOR_ID, TOPIC1, 0)

    def generate(metrics):
        return generate_event_proofs_for_range(
            store, pairs, EventProofSpec(SIGNATURE, TOPIC1, ACTOR_ID), match_backend=backend,
            metrics=metrics, storage_specs=[spec],
        )

    branches = [*EVENT_BRANCHES, "generate_storage_proofs_for_pairs", "verify_storage_proofs_batch"]
    with _native_branches("mixed range", branches):
        bundle, result, _, stages, launches = _generate_and_verify(generate, backend)
    if len(result.storage_results) != n_pairs or len(result.event_results) != n_matching:
        raise AssertionError(
            f"mixed range: {len(result.storage_results)} storage and "
            f"{len(result.event_results)} event verdicts for {n_pairs} pairs, {n_matching} matches"
        )
    if not result.all_valid():
        raise AssertionError("mixed range: a verdict is false")
    slot = "0x" + keccak256(ascii_to_bytes32(TOPIC1) + (0).to_bytes(32, "big")).hex()
    if [p.slot for p in bundle.storage_proofs] != [slot] * n_pairs:
        raise AssertionError("mixed range: a proof's slot is not keccak(key ‖ be32(0))")

    _check_slot_keccak([spec.key32() + spec.slot_index.to_bytes(32, "big")], device)
    present = _check_witness_shapes(bundle.blocks, device)
    _require_launched("mixed range", launches, ["keccak256_single_block", *present])
    _reject_changed_value(bundle)
    return {
        "pairs": n_pairs,
        "storage_proofs": len(bundle.storage_proofs),
        "event_proofs": len(bundle.event_proofs),
        "stage_ms": stages,
        "launches": launches,
    }


def resumable_mixed_range(n_pairs: int, chunk_size: int, device) -> dict:
    """The mixed range through the pipelined driver with a checkpoint
    directory and a job journal; a second run resumes every chunk."""
    store, pairs, _ = build_range_world(n_pairs, 16, 4, 0.01)
    backend = _RecordingBackend(get_backend("gpu"))
    specs = [MappingSlotSpec(ACTOR_ID, TOPIC1, 0)]
    spec = EventProofSpec(SIGNATURE, TOPIC1, ACTOR_ID)
    n_chunks = -(-n_pairs // chunk_size)
    runs = []
    with tempfile.TemporaryDirectory() as checkpoint_dir, tempfile.TemporaryDirectory() as job_dir:
        for _ in range(2):
            metrics = Metrics()
            _reset_counts()
            t0 = time.perf_counter()
            bundle = generate_event_proofs_for_range_pipelined(
                store, pairs, spec, chunk_size=chunk_size, match_backend=backend, metrics=metrics,
                storage_specs=specs, checkpoint_dir=checkpoint_dir, job_dir=job_dir,
            )
            torch.cuda.synchronize()
            runs.append((bundle, metrics, (time.perf_counter() - t0) * 1e3, _counts()))
    (first, m1, ms1, l1), (second, m2, ms2, l2) = runs
    if second.to_json() != first.to_json():
        raise AssertionError("resumable mixed range: the resumed bundle differs")
    if m1.counter_value("range_chunks_generated") != n_chunks or m2.counter_value("range_chunks_resumed") != n_chunks:
        raise AssertionError(f"resumable mixed range: counters {m1.counters} / {m2.counters}")
    if m2.counter_value("range_chunks_generated") or m1.counter_value("range_pipeline_serial_fallback"):
        raise AssertionError(f"resumable mixed range: counters {m1.counters} / {m2.counters}")
    # the resumed run's only launch is the up-front slot keccak of the
    # storage leg, which the pipelined driver re-proves (it journals event
    # chunks only, as the reference does)
    if {k: v for k, v in l2.items() if v} != {"keccak256_single_block": 1}:
        raise AssertionError(f"resumable mixed range: the resumed run launched {l2}")
    result = verify_proof_bundle(first, accept_all, accept_all, verify_witness_cids=True, cid_backend=backend)
    if len(result.storage_results) != n_pairs or not result.all_valid():
        raise AssertionError("resumable mixed range: a verdict is false")
    # the slot keccak of both runs (one batch each), and the verification's
    # blake2b batches, as the kernels computed them, against the plain versions
    _check_slot_keccak([s.key32() + s.slot_index.to_bytes(32, "big") for s in specs], device)
    checked = _check_recorded("resumable mixed range", backend, {})
    if checked["keccak"]["batches"] != 2:
        raise AssertionError(f"resumable mixed range: {checked['keccak']} slot keccak batches, expected 2")
    return {
        "pairs": n_pairs,
        "chunks": n_chunks,
        "checked": checked,
        "storage_proofs": len(first.storage_proofs),
        "event_proofs": len(first.event_proofs),
        "first_ms": ms1,
        "resumed_ms": ms2,
        "counters": {"first": m1.counters, "resumed": m2.counters},
        "launches": l1,
        "resumed_launches": l2,
    }


def pure_python_paths(n_pairs: int, n_contracts: int, n_slots: int) -> dict:
    """Run in a process started with ``IPC_PROOFS_NO_NATIVE=1``: the
    slice 1–2 pure-Python branches on the card (Python scan with the flat
    mask on the card, scalar pass 2, `generate_storage_proofs_batch`, scalar
    replays), each path's bundle digest, stages and launches."""
    if load_scan_ext() is not None or CID is not PurePythonCID:
        raise AssertionError("the pure-Python paths need IPC_PROOFS_NO_NATIVE=1")
    backend = get_backend("gpu")
    store, pairs, n_matching = build_range_world(n_pairs, 16, 4, 0.01)
    bundle, result, _, stages, launches = _generate_and_verify(
        _event_generate(store, pairs, backend), backend
    )
    if len(result.event_results) != n_matching or not all(result.event_results):
        raise AssertionError("pure event path: a verdict is false")
    _require_launched("pure event path", launches, ["event_match_mask", *SIZE_CLASSES])
    out = {"event": {"digest": bundle.digest(), "proofs": len(bundle.event_proofs),
                     "stage_ms": stages, "launches": launches}}

    world, specs, _, _ = _storage_world(n_contracts, n_slots, backend)
    bundle, result, _, stages, launches = _generate_and_verify(
        lambda metrics: generate_storage_proofs_batch(
            world.store, world.parent, world.child, specs, hash_backend=backend, metrics=metrics
        ),
        backend,
    )
    if len(result.storage_results) != len(specs) or not all(result.storage_results):
        raise AssertionError("pure storage path: a verdict is false")
    _require_launched("pure storage path", launches, ["keccak256_single_block", *SIZE_CLASSES])
    out["storage"] = {"digest": bundle.digest(), "proofs": len(bundle.storage_proofs),
                      "stage_ms": stages, "launches": launches}
    return out


def pure_python_phase(n_pairs: int, n_contracts: int, n_slots: int) -> dict:
    """The pure-Python paths in a child process (the universe is chosen once
    per process), held against the native branches on the same worlds: the
    bundle digests must be equal."""
    cmd = [
        sys.executable, __file__, "--pure-python-paths",
        "--pairs", str(n_pairs), "--contracts", str(n_contracts), "--slots", str(n_slots),
    ]
    env = dict(os.environ, IPC_PROOFS_NO_NATIVE="1")
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=600)
    child_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"pure-Python paths failed:\n{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    pure = json.loads(proc.stdout.strip().splitlines()[-1])

    backend = get_backend("gpu")
    store, pairs, _ = build_range_world(n_pairs, 16, 4, 0.01)
    native_event = _event_generate(store, pairs, backend)(Metrics()).digest()
    world, specs, _, _ = _storage_world(n_contracts, n_slots, backend)
    native_storage = _storage_generate(world, specs, backend)(Metrics()).digest()
    if pure["event"]["digest"] != native_event:
        raise AssertionError(f"{n_pairs}-pair event bundle: pure-Python and native digests differ")
    if pure["storage"]["digest"] != native_storage:
        raise AssertionError(
            f"{n_contracts}x{n_slots} storage bundle: pure-Python and native digests differ"
        )
    _log(
        f"pure-Python paths (child process, {child_s:.1f} s): {n_pairs}-pair event bundle "
        f"sha256 {native_event} and {n_contracts}x{n_slots} storage bundle sha256 "
        f"{native_storage} equal the native branches'"
    )
    return pure


# --------------------------------------------------------------------------
# slice 5: the cold read path
# --------------------------------------------------------------------------

COLD_PREFIXES = ("rpc.", "fetch.", "verify.", "storex.")
LYING_NODE_PAIRS = 256
LYING_NODE_RUNS = 8
FORGED_FRAMES = 64
# the mixed-multihash sweep: (multihash code, blocks, longest block)
UNKNOWN_CODE = 0x15
MIXED_FAMILIES = (
    (BLAKE2B_256, 65_536, 520),
    (KECCAK_256, 65_536, 520),
    (SHA2_256, 16_384, 520),
    (IDENTITY, 4_096, 64),
    (UNKNOWN_CODE, 1_024, 520),
)


def _spec() -> EventProofSpec:
    return EventProofSpec(SIGNATURE, TOPIC1, ACTOR_ID)


def _cold_counters(metrics: Metrics) -> dict:
    return {k: v for k, v in sorted(metrics.counters.items()) if k.startswith(COLD_PREFIXES)}


@contextlib.contextmanager
def _verify_calls(module):
    """Record every `verify_blocks_batch` call ``module`` (the fetch plane
    or the segment store) makes, from any thread: (blocks, wall ms)."""
    calls: list = []
    original = module.verify_blocks_batch

    def spy(cids, blocks, *args, **kwargs):
        t0 = time.perf_counter()
        out = original(cids, blocks, *args, **kwargs)
        calls.append((len(blocks), (time.perf_counter() - t0) * 1e3))
        return out

    module.verify_blocks_batch = spy
    try:
        yield calls
    finally:
        module.verify_blocks_batch = original


def _no_retries(label: str, metrics: Metrics) -> None:
    for counter in ("range_scan_retries", "range_pipeline_serial_fallback", "rpc.retries",
                    "rpc.integrity_failures", "fetch.speculative_integrity_drops"):
        if metrics.counter_value(counter):
            raise AssertionError(f"{label}: {counter} = {metrics.counter_value(counter)}")


def _cold_run(store, pairs, store_dir, backend, budget, chunk_size, session=None, scan_retries=2,
              metrics=None, speculate_depth=1):
    """One pipelined run over the cold read stack, counts from 0: hermetic
    Lotus node → `LotusClient` → `FetchPlane` (every landed wave verified on
    ``backend``) → `TieredBlockstore` over a `SegmentStore` in ``store_dir``
    (batch verify on ``backend``). Returns (bundle, metrics, wall ms,
    launches)."""
    gc.collect()
    metrics = Metrics() if metrics is None else metrics
    client = LotusClient("http://lotus.local", session=session or LocalLotusSession(store), metrics=metrics)
    plane = FetchPlane(
        client, speculate_depth=speculate_depth, backend=backend, metrics=metrics
    )
    disk = SegmentStore(store_dir, backend=backend, metrics=metrics)
    tier = TieredBlockstore(PlaneBlockstore(plane), disk, metrics=metrics)
    plane.set_local(tier)
    _reset_counts()
    t0 = time.perf_counter()
    try:
        bundle = generate_event_proofs_for_range_pipelined(
            tier, pairs, _spec(), chunk_size=chunk_size, match_backend=backend, metrics=metrics,
            threads=budget.total, scan_threads=budget.scan_workers, record_workers=budget.record_workers,
            scan_retries=scan_retries,
        )
        torch.cuda.synchronize()
    finally:
        plane.close()
        disk.close()
    return bundle, metrics, (time.perf_counter() - t0) * 1e3, _counts()


def cold_read_path(world, device, root: str) -> dict:
    """BASELINE config 2 read cold through the hermetic node, the fetch
    plane and the disk tier by the pipelined driver at the host's thread
    budget, every landed wave of two or more blocks verified on the card
    (``IPC_VERIFY_MIN_BYTES=0``): the in-memory path's bytes, the lane
    split, every recorded kernel call held against the plain versions."""
    store, pairs, n_matching = world
    backend = get_backend("gpu")
    budget = resolve_thread_budget()
    chunk_size = max(1, min(1024, len(pairs) // max(4, 2 * budget.scan_workers)))
    expected = generate_event_proofs_for_range(store, pairs, _spec(), match_backend=backend).to_json()
    recording = _RecordingBackend(backend)
    with _env("IPC_VERIFY_MIN_BYTES", "0"), _verify_calls(fetchplane_mod) as waves:
        bundle, metrics, wall_ms, launches = _cold_run(
            store, pairs, os.path.join(root, "cold"), recording, budget, chunk_size
        )
    if bundle.to_json() != expected:
        raise AssertionError("cold read: the bundle differs from the in-memory event path's")
    _no_retries("cold read", metrics)
    # the tier has no raw map, so the scan is the Python walk and the
    # predicate the flat mask on the card (as in the reference)
    _require_launched("cold read", launches, [*SIZE_CLASSES, "event_match_mask"])
    single = sum(n for n, _ in waves if n == 1)
    multi = [n for n, _ in waves if n >= 2]
    lanes = {
        "verify.batch_calls": len(waves),
        "verify.scalar_blocks": single,
        "verify.device_calls": len(multi),
        "verify.device_blocks": sum(multi),
    }
    got = {k: metrics.counter_value(k) for k in lanes}
    if got != lanes:
        raise AssertionError(f"cold read: lane split {got}, waves say {lanes}")
    checked = _check_recorded("cold read", recording, {})
    if checked["blake2b"]["batches"] != len(multi):
        raise AssertionError(f"cold read: {checked['blake2b']} recorded for {len(multi)} device waves")
    _log(f"cold read: every device wave equal to plain and to hashlib: {checked}")

    with _env("IPC_VERIFY_MIN_BYTES", "0"):
        (again, p_metrics, p_wall_ms, _), busy_ms = _profiled(
            lambda: _cold_run(store, pairs, os.path.join(root, "cold-profiled"), backend, budget, chunk_size)
        )
    shutil.rmtree(os.path.join(root, "cold-profiled"))
    if again.to_json() != expected:
        raise AssertionError("cold read (profiled repeat): the bundle differs")
    # the same run at the default crossover, what the lane's routing costs:
    # waves of at most 64 blocks stay below 256 KiB, so all take the host lane
    with _verify_calls(fetchplane_mod) as d_waves:
        default, d_metrics, d_wall_ms, d_launches = _cold_run(
            store, pairs, os.path.join(root, "cold-default"), backend, budget, chunk_size
        )
    shutil.rmtree(os.path.join(root, "cold-default"))
    if default.to_json() != expected:
        raise AssertionError("cold read (default crossover): the bundle differs")
    _no_retries("cold read (default crossover)", d_metrics)
    return {
        "pairs": len(pairs),
        "proofs": len(bundle.event_proofs),
        "chunk_size": chunk_size,
        "budget": dataclasses.asdict(budget),
        "wall_ms": wall_ms,
        "proofs_per_s": len(bundle.event_proofs) / wall_ms * 1e3,
        "stage_busy_ms": {k: v * 1e3 for k, v in metrics.stage_s.items()},
        "counters": _cold_counters(metrics),
        "waves": {"total": len(waves), "single_block": single, "multi_block": len(multi),
                  "largest": max(multi, default=0),
                  "verify_ms": sum(ms for _, ms in waves)},
        "checked": checked,
        "launches": launches,
        "profiled_run": {"wall_ms": p_wall_ms, "busy_ms": busy_ms,
                         "proofs_per_s": len(again.event_proofs) / p_wall_ms * 1e3},
        "default_crossover": {
            "wall_ms": d_wall_ms,
            "proofs_per_s": len(default.event_proofs) / d_wall_ms * 1e3,
            "verify_ms": sum(ms for _, ms in d_waves),
            "counters": {k: v for k, v in _cold_counters(d_metrics).items() if k.startswith("verify.")},
            "launches": d_launches,
        },
        "host": _host_info(),
    }


def _open_swept(store_dir: str, backend, metrics: Metrics):
    """Open a segment store with the sweep at open on ``backend`` at the
    default crossover: (store, open ms, sweep calls)."""
    with _verify_calls(segments_mod) as calls:
        _reset_counts()
        t0 = time.perf_counter()
        disk = SegmentStore(store_dir, verify_scan=True, backend=backend, metrics=metrics)
        torch.cuda.synchronize()
        open_ms = (time.perf_counter() - t0) * 1e3
    return disk, open_ms, calls


def warm_restart(world, root: str) -> dict:
    """Reopen the cold run's disk with the sweep at open on the card, then
    generate again through a fresh plane and tier: the same bytes and no
    RPC call without speculation; at the cold run's depth 1 the same bytes,
    and the speculative fetches that reach the node counted."""
    store, pairs, _ = world
    backend = get_backend("gpu")
    recording = _RecordingBackend(backend)
    store_dir = os.path.join(root, "cold")
    seg_bytes = sum(os.path.getsize(os.path.join(store_dir, n)) for n in os.listdir(store_dir) if n.endswith(".blk"))
    metrics = Metrics()
    disk, open_ms, calls = _open_swept(store_dir, recording, metrics)
    sweep_launches = _counts()
    n_blocks = len(disk)
    if metrics.counter_value("storex.integrity_evictions"):
        raise AssertionError(f"warm restart: the sweep evicted {metrics.counters}")
    n_segments = len([n for n in os.listdir(store_dir) if n.endswith(".blk")])
    if (len(calls) != n_segments or sum(n for n, _ in calls) != n_blocks
            or metrics.counter_value("verify.device_blocks") != n_blocks):
        raise AssertionError(f"warm restart: sweep calls {calls} for {n_blocks} blocks ({metrics.counters})")
    _require_launched("warm restart sweep", sweep_launches, SIZE_CLASSES)
    checked = _check_recorded("warm restart sweep", recording, {})
    swept = [len(m) for messages, _ in recording.batches for m in messages]
    disk.close()

    budget = resolve_thread_budget()
    chunk_size = max(1, min(1024, len(pairs) // max(4, 2 * budget.scan_workers)))
    expected = generate_event_proofs_for_range(store, pairs, _spec(), match_backend=backend).to_json()
    # speculation off: no want may reach the node
    bundle, g_metrics, wall_ms, launches = _cold_run(
        store, pairs, store_dir, backend, budget, chunk_size, speculate_depth=0
    )
    if bundle.to_json() != expected:
        raise AssertionError("warm restart: the bundle differs from the in-memory event path's")
    if g_metrics.counter_value("rpc.calls") or g_metrics.counter_value("fetch.wants"):
        raise AssertionError(f"warm restart: the warm run reached the node: {_cold_counters(g_metrics)}")
    _no_retries("warm restart", g_metrics)
    # the cold run's depth 1: walkers offer links that the cold plane dropped
    # at its queue cap and no walk reads, and the plane fetches them, as the
    # reference's does (tests/test_torch_fetchplane.py::TestWarmRestartSpeculation);
    # every demand is still served from the disk
    spec_bundle, s_metrics, s_wall_ms, _ = _cold_run(store, pairs, store_dir, backend, budget, chunk_size)
    if spec_bundle.to_json() != expected:
        raise AssertionError("warm restart (depth 1): the bundle differs from the in-memory event path's")
    if s_metrics.counter_value("fetch.wants") != s_metrics.counter_value("fetch.speculative_wants"):
        raise AssertionError(f"warm restart (depth 1): a demand reached the node: {_cold_counters(s_metrics)}")
    _no_retries("warm restart (depth 1)", s_metrics)
    return {
        "blocks": n_blocks,
        "block_bytes": sum(swept),
        "segment_bytes": seg_bytes,
        "segments": n_segments,
        "by_class": {name: sum(size_class(n) == name for n in swept) for name in SIZE_CLASSES},
        "open_ms": open_ms,
        "sweep_verify_ms": sum(ms for _, ms in calls),
        "sweep_blocks_per_s": n_blocks / sum(ms for _, ms in calls) * 1e3,
        "sweep_launches": sweep_launches,
        "checked": checked,
        "generate_wall_ms": wall_ms,
        "generate_proofs_per_s": len(bundle.event_proofs) / wall_ms * 1e3,
        "generate_counters": _cold_counters(g_metrics),
        "launches": launches,
        "speculating": {
            "wall_ms": s_wall_ms,
            "proofs_per_s": len(spec_bundle.event_proofs) / s_wall_ms * 1e3,
            "rpc_calls": s_metrics.counter_value("rpc.calls"),
            "counters": _cold_counters(s_metrics),
        },
    }


def _frames(store_dir: str) -> "list[tuple[str, int, int, bytes]]":
    """(segment path, offset, frame length, raw CID) of every frame."""
    out = []
    for name in sorted(os.listdir(store_dir)):
        if not name.endswith(".blk"):
            continue
        path = os.path.join(store_dir, name)
        with open(path, "rb") as fh:
            data = fh.read()
        off = 0
        while off < len(data):
            _, length, _ = FRAME_HEADER.unpack_from(data, off)
            payload = data[off + FRAME_HEADER.size : off + FRAME_HEADER.size + length]
            (cid_len,) = struct.unpack_from("<H", payload, 0)
            out.append((path, off, FRAME_HEADER.size + length, payload[2 : 2 + cid_len]))
            off += FRAME_HEADER.size + length
    return out


def _forge(path: str, off: int, frame_len: int) -> None:
    """Change a frame's last block byte and write a valid CRC over it: the
    CRC passes, only the multihash can tell."""
    with open(path, "r+b") as fh:
        fh.seek(off)
        payload = bytearray(fh.read(frame_len)[FRAME_HEADER.size :])
        payload[-1] ^= 0xFF
        fh.seek(off)
        fh.write(FRAME_HEADER.pack(SEGMENT_MAGIC, len(payload), zlib.crc32(bytes(payload))) + bytes(payload))


def lying_disk(world, root: str, seed: int) -> dict:
    """Forge frames of the cold run's disk at seeded indices: the sweep at
    open evicts exactly that set, and reads through the tier refetch and
    repair each one."""
    store, _, _ = world
    backend = get_backend("gpu")
    store_dir = os.path.join(root, "cold")
    frames = _frames(store_dir)
    rng = np.random.default_rng(seed + 5)
    picked = sorted(int(i) for i in rng.choice(len(frames), size=FORGED_FRAMES, replace=False))
    for i in picked:
        _forge(*frames[i][:3])
    forged = {frames[i][3] for i in picked}
    recording = _RecordingBackend(backend)
    metrics = Metrics()
    disk, open_ms, _ = _open_swept(store_dir, recording, metrics)
    sweep_launches = _counts()
    try:
        evicted = {raw for _, _, _, raw in frames if not disk.contains(CID.from_bytes(raw))}
        if evicted != forged or metrics.counter_value("storex.integrity_evictions") != len(forged):
            raise AssertionError(
                f"lying disk: the sweep evicted {len(evicted)} frames, {len(evicted & forged)} of the "
                f"{len(forged)} forged ({metrics.counters})"
            )
        _require_launched("lying disk sweep", sweep_launches, SIZE_CLASSES)
        checked = _check_recorded("lying disk sweep", recording, {})
        client = LotusClient("http://lotus.local", session=LocalLotusSession(store), metrics=metrics)
        plane = FetchPlane(client, speculate_depth=0, backend=backend, metrics=metrics)
        tier = TieredBlockstore(PlaneBlockstore(plane), disk, metrics=metrics)
        plane.set_local(tier)
        before = metrics.counter_value("rpc.calls")
        try:
            for raw in sorted(forged):
                cid = CID.from_bytes(raw)
                if tier.get(cid) != store.get(cid) or disk.get(cid) != store.get(cid):
                    raise AssertionError(f"lying disk: {cid} was not repaired")
        finally:
            plane.close()
        refetched = metrics.counter_value("rpc.calls") - before
        if refetched != len(forged):
            raise AssertionError(f"lying disk: {refetched} RPC calls to repair {len(forged)} frames")
    finally:
        disk.close()
    return {"frames": len(frames), "forged": len(forged), "evicted": len(evicted), "open_ms": open_ms,
            "refetched": refetched, "launches": sweep_launches, "checked": checked,
            "counters": _cold_counters(metrics)}


def lying_node(n_pairs: int, root: str, seed: int) -> dict:
    """A node that flips bits (`FaultySession` over the hermetic node,
    seeded bit-flip plans): each run gives the in-memory path's bytes or a
    typed error, speculative lies are dropped before use, and no forged
    block reaches the disk (a verifying reopen evicts nothing)."""
    store, pairs, _ = build_range_world(n_pairs, 16, 4, 0.01)
    backend = get_backend("gpu")
    budget = resolve_thread_budget()
    chunk_size = max(1, n_pairs // 8)
    expected = generate_event_proofs_for_range(store, pairs, _spec(), match_backend=backend).to_json()
    runs = []
    launches: dict = {}
    for run in range(LYING_NODE_RUNS):
        # one endpoint and no failover: each lie in a demand wave costs the
        # chunk a scan retry, so the retries cover every lie of the plan
        plan = FaultPlan(seed * 100 + run, fault_rate=0.1, kinds=("bitflip",), max_faults=16)
        session = FaultySession(LocalLotusSession(store), plan, sleep=lambda s: None)
        store_dir = os.path.join(root, f"lying-node-{run}")
        metrics = Metrics()
        with _env("IPC_VERIFY_MIN_BYTES", "0"):
            try:
                bundle, _, _, run_launches = _cold_run(
                    store, pairs, store_dir, backend, budget, chunk_size, session=session, scan_retries=16,
                    metrics=metrics,
                )
                outcome = "identical" if bundle.to_json() == expected else "DIFFERENT"
                caught = metrics.counter_value("rpc.integrity_failures") + metrics.counter_value(
                    "fetch.speculative_integrity_drops"
                )
                if caught != plan.snapshot()["by_kind"].get("bitflip", 0):
                    raise AssertionError(f"lying node run {run}: {caught} lies caught of {plan.snapshot()}")
            except (IntegrityError, RpcError) as exc:  # a typed refusal is an accepted outcome
                outcome, run_launches = type(exc).__name__, _counts()
        if outcome == "DIFFERENT":
            raise AssertionError(f"lying node run {run}: a completed run gave other bytes")
        for k, v in run_launches.items():
            launches[k] = launches.get(k, 0) + v
        reopen = Metrics()
        disk, _, _ = _open_swept(store_dir, backend, reopen)
        disk.close()
        if reopen.counter_value("storex.integrity_evictions"):
            raise AssertionError(f"lying node run {run}: a forged block reached the disk ({reopen.counters})")
        runs.append({
            "outcome": outcome,
            "flips": plan.snapshot()["by_kind"].get("bitflip", 0),
            "counters": _cold_counters(metrics),
            "scan_retries": metrics.counter_value("range_scan_retries"),
        })
        shutil.rmtree(store_dir)
    drops = sum(r["counters"].get("fetch.speculative_integrity_drops", 0) for r in runs)
    if not drops or not any(r["outcome"] == "identical" for r in runs):
        raise AssertionError(f"lying node: no speculative drop or no completed run: {runs}")
    return {"pairs": n_pairs, "runs": runs, "speculative_integrity_drops": drops, "launches": launches}


def _host_verdict(item: "tuple[bytes, bytes]") -> "tuple[bool, bytes | None]":
    """`verify_block_bytes` of one (raw CID, block), and the host golden
    digest of a keccak block; run in worker processes (the host keccak is
    pure Python)."""
    raw, data = item
    cid = CID.from_bytes(raw)
    digest = keccak256(data) if cid.mh_code == KECCAK_256 else None
    return verify_block_bytes(cid, data), digest


def _mixed_blocks(seed: int):
    """The sweep's blocks from the seed: (raw CIDs, stored bytes, flipped
    indices). The keccak CIDs are hashed on the card (outside any counted
    window): a wrong kernel gives wrong CIDs, which the host verdicts then
    reject block by block."""
    rng = np.random.default_rng(seed + 6)
    blocks, codes = [], []
    for code, count, longest in MIXED_FAMILIES:
        lengths = rng.integers(1, longest + 1, size=count)
        lengths[0] = 0  # one empty block per family
        seen: set = set()
        for n in lengths:
            data = rng.integers(0, 256, size=int(n), dtype=np.uint8).tobytes()
            while data in seen:  # short blocks repeat: one CID, one block
                data = rng.integers(0, 256, size=int(n), dtype=np.uint8).tobytes()
            seen.add(data)
            blocks.append(data)
            codes.append(code)
    keccak_rows = [i for i, c in enumerate(codes) if c == KECCAK_256]
    keccak_digests = get_backend("gpu").keccak256_batch([blocks[i] for i in keccak_rows])
    digests = dict(zip(keccak_rows, keccak_digests))
    raws = []
    for i, (code, data) in enumerate(zip(codes, blocks)):
        if code == KECCAK_256:
            cid = CID(1, DAG_CBOR, KECCAK_256, digests[i])
        elif code == UNKNOWN_CODE:
            cid = CID(1, DAG_CBOR, UNKNOWN_CODE, hashlib.sha256(b"unknown %d" % i).digest())
        else:
            cid = CID.hash_of(data, mh_code=code)
        raws.append(cid.to_bytes())
    nonempty = [i for i, data in enumerate(blocks) if data]
    flipped = sorted(int(i) for i in rng.choice(nonempty, size=len(blocks) // 100, replace=False))
    for i in flipped:
        data = bytearray(blocks[i])
        data[int(rng.integers(len(data)))] ^= 1 << int(rng.integers(8))
        blocks[i] = bytes(data)
    return raws, blocks, flipped


def mixed_sweep(root: str, seed: int) -> dict:
    """One segment's worth of blocks of every multihash family, 1 % of them
    with a flipped bit, swept at open on the card: each verdict equal to
    `verify_block_bytes`, the flips the only evictions, both keccak and all
    three blake2b kernels launched."""
    t0 = time.perf_counter()
    ctx = multiprocessing.get_context("spawn")
    workers = len(os.sched_getaffinity(0))
    raws, blocks, flipped = _mixed_blocks(seed)
    with concurrent.futures.ProcessPoolExecutor(max_workers=workers, mp_context=ctx) as pool:
        host = list(pool.map(_host_verdict, list(zip(raws, blocks)), chunksize=1024))
    store_dir = os.path.join(root, "mixed")
    with SegmentStore(store_dir) as disk:
        for raw, data in zip(raws, blocks):
            disk.put(CID.from_bytes(raw), data)
        if len(disk) != len(raws) or disk.stats()["segments"] != 1:
            raise AssertionError(f"mixed sweep: {disk.stats()} for {len(raws)} blocks")
    build_s = time.perf_counter() - t0
    expected = [ok for ok, _ in host]
    golden_keccak = {data: digest for data, (_, digest) in zip(blocks, host) if digest is not None}

    recording = _RecordingBackend(get_backend("gpu"))
    metrics = Metrics()
    disk, open_ms, calls = _open_swept(store_dir, recording, metrics)
    launches = _counts()
    try:
        kept = [disk.contains(CID.from_bytes(raw)) for raw in raws]
    finally:
        disk.close()
    if kept != expected:
        first = next(i for i, (a, b) in enumerate(zip(kept, expected)) if a != b)
        raise AssertionError(f"mixed sweep: block {first}'s verdict differs from verify_block_bytes")
    evicted = [i for i, ok in enumerate(kept) if not ok]
    if not set(evicted) <= set(flipped) or metrics.counter_value("storex.integrity_evictions") != len(evicted):
        raise AssertionError(f"mixed sweep: evictions outside the flipped blocks ({metrics.counters})")
    unknown_flips = sum(CID.from_bytes(raws[i]).mh_code == UNKNOWN_CODE for i in flipped)
    if len(evicted) != len(flipped) - unknown_flips:
        raise AssertionError(f"mixed sweep: {len(evicted)} evictions for {len(flipped)} flips")
    _require_launched("mixed sweep", launches, [*SIZE_CLASSES, *KECCAK_CLASSES])
    cpu = get_backend("gpu", device="cpu")
    for kind, batches, plain, golden in (
        ("blake2b", recording.batches, cpu.blake2b256_batch, _blake2b),
        ("keccak", recording.keccak_batches, cpu.keccak256_batch, golden_keccak.__getitem__),
    ):
        if len(batches) != 1:
            raise AssertionError(f"mixed sweep: {len(batches)} {kind} calls, expected 1")
        [(messages, digests)] = batches
        if digests != plain(messages) or digests != [golden(m) for m in messages]:
            raise AssertionError(f"mixed sweep: the {kind} call differs from plain or the host")
    return {
        "blocks": len(raws),
        "bytes": sum(len(b) for b in blocks),
        "families": {hex(code): count for code, count, _ in MIXED_FAMILIES},
        "flipped": len(flipped),
        "flipped_unknown_code": unknown_flips,
        "evicted": len(evicted),
        "build_s": build_s,
        "open_ms": open_ms,
        "sweep_verify_ms": calls[0][1],
        "counters": _cold_counters(metrics),
        "launches": launches,
    }


def autotune_phase(root: str) -> dict:
    """`autotune_crossover` on the card, its record under the port's own
    file name."""
    store_dir = os.path.join(root, "autotune")
    _reset_counts()
    record = autotune_crossover(store_dir, quick=False, force=True)
    launches = _counts()
    names = sorted(os.listdir(store_dir))
    if names != ["verify_autotune_cuda.json"]:
        raise AssertionError(f"autotune: files {names}")
    if load_autotune(store_dir) != record["min_bytes"] or len(record["samples"]) != 4:
        raise AssertionError(f"autotune: record {record}")
    _require_launched("autotune", launches, SIZE_CLASSES[2:])
    return {"record": record, "launches": launches}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--pairs", type=int, default=4096)
    parser.add_argument("--messages", type=int, default=1 << 20)
    parser.add_argument("--pure-pairs", type=int, default=512)
    parser.add_argument("--pure-contracts", type=int, default=16)
    # the child process of the pure-Python phase
    parser.add_argument("--pure-python-paths", action="store_true", help=argparse.SUPPRESS)
    parser.add_argument("--contracts", type=int, default=CONTRACTS, help=argparse.SUPPRESS)
    parser.add_argument("--slots", type=int, default=SLOTS_PER_CONTRACT, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one card", file=sys.stderr)
        return 1
    if args.pure_python_paths:
        print(json.dumps(pure_python_paths(args.pairs, args.contracts, args.slots)))
        return 0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    device = torch.device("cuda", 0)
    _log(f"card: {smi}")
    _log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    _log(f"host: {_host_info()} (native scanner built from {load_scan_ext().__file__})")

    built = build_libraries(["blake2b", "keccak"])
    for name, info in built.items():
        _log(f"build {name}: {info['seconds']:.1f} s")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                _log(f"  ptxas: {line.strip()}")
    per_compression = sass_per_compression(built["blake2b"]["path"])
    for loader, counts in per_compression.items():
        _log(f"sass blake2b256_kernel<{loader}>: instructions per compression {counts}")
    per_permutation = sass_per_permutation(built["keccak"]["path"])
    for loader, counts in per_permutation.items():
        _log(f"sass keccak256_kernel<{loader}>: instructions per absorbed block {counts}")

    kernels = kernel_phase(_kernel_cases(args.messages, args.seed, device), blake2b, per_compression)
    kernels.update(
        kernel_phase(
            _keccak_cases(args.messages, args.messages // 4, args.seed, device),
            keccak,
            per_permutation,
        )
    )
    paths: dict = {}

    def run(label, fn, *fn_args):
        t0 = time.perf_counter()
        paths[label] = fn(*fn_args)
        _log(f"{label} ({time.perf_counter() - t0:.1f} s): {json.dumps(paths[label])}")

    world = event_world(args.pairs)
    run("event path", event_path, world, device)
    run("overlapped event path", overlapped_path, world, device, paths["event path"]["proofs_per_s"])
    with tempfile.TemporaryDirectory() as root:
        run("cold read", cold_read_path, world, device, root)
        run("warm restart", warm_restart, world, root)
        run("lying disk", lying_disk, world, root, args.seed)
        del world
        run("storage path", storage_path, CONTRACTS, SLOTS_PER_CONTRACT, args.seed, device)
        run("mixed range", mixed_range, 64, device)
        run("resumable mixed range", resumable_mixed_range, 64, 16, device)
        pure = pure_python_phase(args.pure_pairs, args.pure_contracts, SLOTS_PER_CONTRACT)
        run("lying node", lying_node, LYING_NODE_PAIRS, root, args.seed)
        run("mixed-multihash sweep", mixed_sweep, root, args.seed)
        # last: the tuned crossover applies to every later verify call
        run("autotune", autotune_phase, root)
    launch_counts = {label: path["launches"] for label, path in paths.items()}
    launch_counts["event path, unfused"] = paths["event path"]["unfused"]["launches"]
    launch_counts["overlapped event path, unfused"] = paths["overlapped event path"]["unfused"]["launches"]
    launch_counts["resumable mixed range, resumed"] = paths["resumable mixed range"]["resumed_launches"]
    launch_counts["event path, pure Python"] = pure["event"]["launches"]
    launch_counts["storage path, pure Python"] = pure["storage"]["launches"]
    launch_counts["warm restart, sweep"] = paths["warm restart"]["sweep_launches"]
    launch_counts["cold read, default crossover"] = paths["cold read"]["default_crossover"]["launches"]

    rows = []
    for name, replaces, source in [(k[0], k[1], SOURCE) for k in KERNELS] + [
        (k[0], k[1], KECCAK_SOURCE) for k in KECCAK_KERNELS
    ]:
        k = kernels[name]
        per_path = {label: counts.get(name, 0) for label, counts in launch_counts.items()}
        row = {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": per_path[OWN_PATH[name]],
            "launches_by_path": per_path,
            "max_abs_err": k["max_abs_err"],
            "ms": k["ms"],
            "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"],
            "library_ms": None,  # no PyTorch call computes blake2b or keccak-256
        }
        rows.append(row)
        _log(
            f"{name}: rows={k['rows']} kernel_ms={k['ms']} plain_ms={k['plain_ms']} "
            f"bound_ms={k['bound_ms']} ({k['bound_by']}) launches={per_path}"
        )
    _log(f"pure-Python paths: {json.dumps(pure)}")
    event, storage = paths["event path"], paths["storage path"]
    _log(
        f"event path on {smi}: {event['proofs']} proofs, {event['proofs_per_s']} proofs/s, "
        f"{event['host']}"
    )
    overlapped = paths["overlapped event path"]
    budget = overlapped["budget"]
    _log(
        f"overlapped event path on {smi}: {overlapped['proofs']} proofs in {overlapped['chunks']} chunks "
        f"of {overlapped['chunk_size']} pairs, wall {overlapped['wall_ms']} ms, "
        f"{overlapped['proofs_per_s']} proofs/s (serial {overlapped['serial_proofs_per_s']} proofs/s), "
        f"overlap_efficiency {overlapped['overlap_efficiency']}"
    )
    _log(
        "overlapped stage busy ms: "
        + ", ".join(f"{k} {overlapped['stage_busy_ms'].get(k)}" for k in OVERLAP_STAGES)
    )
    _log(
        f"thread budget: total {budget['total']} ({budget['source']}), scan {budget['scan_workers']}, "
        f"record {budget['record_workers']}, verify {budget['verify_workers']}, "
        f"native {budget['native_scan_threads']} (scan x native = "
        f"{budget['scan_workers'] * budget['native_scan_threads']} <= {budget['total']})"
    )
    _log(
        f"overlapped verify_chunk ms summed over chunks: {overlapped['verify_chunk_ms']}; "
        f"the same chunks verified alone, one after another: {overlapped['verify_chunks_alone_ms']}"
    )
    _log(f"overlapped launches: {overlapped['launches']}")
    _log(
        f"overlapped profiled repeat: busy {overlapped['profiled_run']['busy_ms']} ms of "
        f"{overlapped['profiled_run']['wall_ms']} ms wall"
    )
    _log(
        f"overlapped unfused rerun: {overlapped['unfused']['proofs_per_s']} proofs/s, "
        f"counters {overlapped['unfused']['counters']}, "
        f"fingerprint mask launches {overlapped['unfused']['launches']['event_match_mask_fp']}"
    )
    _log(
        f"storage path on {smi}: {storage['proofs']} proofs, {storage['proofs_per_s']} proofs/s, "
        f"{storage['host']}"
    )
    cold, warm = paths["cold read"], paths["warm restart"]
    _log(
        f"cold read on {smi}: {cold['proofs']} proofs over {cold['pairs']} pairs, wall {cold['wall_ms']} ms, "
        f"{cold['proofs_per_s']} proofs/s (in-memory serial {event['proofs_per_s']}); waves "
        f"{cold['waves']}; profiled repeat busy {cold['profiled_run']['busy_ms']} ms of "
        f"{cold['profiled_run']['wall_ms']} ms; at the default crossover "
        f"{cold['default_crossover']['proofs_per_s']} proofs/s"
    )
    _log(f"cold read counters: {json.dumps(cold['counters'])}")
    _log(
        f"warm restart on {smi}: sweep of {warm['blocks']} blocks ({warm['block_bytes']} bytes, "
        f"{warm['by_class']}) in {warm['sweep_verify_ms']} ms verify / {warm['open_ms']} ms open, "
        f"{warm['sweep_blocks_per_s']} blocks/s; warm generate {warm['generate_proofs_per_s']} proofs/s, "
        f"rpc.calls 0; at speculate depth 1 {warm['speculating']['proofs_per_s']} proofs/s, "
        f"rpc.calls {warm['speculating']['rpc_calls']}, "
        f"fetch.speculative_wants {warm['speculating']['counters'].get('fetch.speculative_wants', 0)}"
    )
    mixed = paths["mixed-multihash sweep"]
    _log(
        f"mixed-multihash sweep on {smi}: {mixed['blocks']} blocks, {mixed['flipped']} flipped, "
        f"{mixed['evicted']} evicted, verify {mixed['sweep_verify_ms']} ms, launches {mixed['launches']}"
    )
    _log(f"autotune on {smi}: {json.dumps(paths['autotune']['record'])}")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
