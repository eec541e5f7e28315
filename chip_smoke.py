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
5. storage path — BASELINE config 3: ``build_chain`` with 256 EVM
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
6. mixed range — ``build_range_world(64, 16, 4, 0.01)`` with the topdown
   nonce slot ``MappingSlotSpec(1001, "calib-subnet-1", 0)`` proved at every
   pair through the native range branches: 64 storage proofs beside the
   event proofs, every verdict true, every proof's slot the expected keccak
   digest, a changed value given a false verdict, the range's one slot-hash
   launch and a blake2b launch for each size class of its witness counted;
   the keccak and blake2b kernels held against their plain versions at this
   path's shapes;
7. pure-Python paths — a child process started with
   ``IPC_PROOFS_NO_NATIVE=1`` runs the slice 1–2 branches on the card at
   reduced depth (the event path at 512 pairs; ``generate_storage_proofs_batch``
   at 16 contracts × 256 slots), each verified on the card with its own
   launch counts; their bundle digests (sha256 of the canonical JSON) must
   equal those of the native branches on the same worlds.

Prints per-stage ms of every path with the scanner's thread count and the
CPUs it may use; then, in order before the last line: one line per kernel,
one JSON object ``{"kernels": [...]}``, the ``nvidia-smi`` name/power-limit
line; and as the last line ``{"ok": true, "device": {...}}``. Each path's
launch counts are set to 0 just before it runs and read just after. A
kernel's ``launches`` is the count on the path of the slice that ported it
(the event path for blake2b, the storage path for keccak);
``launches_by_path`` holds its count on each path (the unfused event run
and the two pure-Python paths included).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import hashlib
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

from ipc_proofs_tpu_torch.backend import get_backend
from ipc_proofs_tpu_torch.backend.gpu import SIZE_CLASSES, keccak_class, size_class
from ipc_proofs_tpu_torch.backend.native import load_scan_ext
from ipc_proofs_tpu_torch.core.cid import BLAKE2B_256, CID, PurePythonCID
from ipc_proofs_tpu_torch.core.hashes import keccak256
from ipc_proofs_tpu_torch.fixtures import ContractFixture, build_chain, build_range_world
from ipc_proofs_tpu_torch.ops import blake2b, keccak, match
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
from ipc_proofs_tpu_torch.proofs.bundle import ProofBlock, UnifiedProofBundle
from ipc_proofs_tpu_torch.proofs.generator import EventProofSpec
from ipc_proofs_tpu_torch.proofs.range import TipsetPair, generate_event_proofs_for_range
from ipc_proofs_tpu_torch.proofs.storage_batch import MappingSlotSpec, generate_storage_proofs_batch
from ipc_proofs_tpu_torch.proofs.verifier import accept_all, verify_proof_bundle
from ipc_proofs_tpu_torch.state.events import ascii_to_bytes32, left_pad_32
from ipc_proofs_tpu_torch.utils.metrics import Metrics

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
OWN_PATH = {"blake2b": "event path", "keccak": "storage path"}
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
    """The card's backend, recording each direct ``blake2b256_batch`` call
    with the digests its kernels returned: the verifier's TxMeta recompute.
    (The witness recompute goes through ``verify_block_cids``, which the
    wrapped backend serves itself.)"""

    def __init__(self, backend):
        self._backend = backend
        self.batches: "list[tuple[list[bytes], list[bytes]]]" = []

    def __getattr__(self, name):
        return getattr(self._backend, name)

    def blake2b256_batch(self, messages):
        digests = self._backend.blake2b256_batch(messages)
        self.batches.append((list(messages), list(digests)))
        return digests


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


def _device_busy(generate, backend) -> dict:
    """A repeat of a path's run (`_generate_and_verify`) under
    torch.profiler: its stage ms, and the device time of the CUDA kernels
    it launched (``busy_ms`` None when the profiler saw no CUDA kernel:
    then not measured)."""
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        _, _, _, stages, _ = _generate_and_verify(generate, backend)
    busy_us = sum(
        getattr(e, "self_device_time_total", 0) or 0
        for e in prof.key_averages()
        if str(getattr(e, "device_type", "")).endswith("CUDA")
    )
    return {"stage_ms": stages, "busy_ms": busy_us / 1e3 if busy_us > 0 else None}


def event_path(n_pairs: int, device) -> dict:
    """BASELINE config 2: the 4096-pair event-proof range through the native
    branches (fused C scan+match, C pass 2, C witness materialization,
    batched replay with the TxMeta recompute on the card)."""
    t0 = time.perf_counter()
    store, pairs, n_matching = build_range_world(n_pairs, 16, 4, 0.01)
    world_s = time.perf_counter() - t0
    _log(f"world: {n_pairs} pairs, {len(store)} blocks, {n_matching} matching receipts, {world_s:.1f} s")
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
    paths = {
        "event path": event_path(args.pairs, device),
        "storage path": storage_path(CONTRACTS, SLOTS_PER_CONTRACT, args.seed, device),
        "mixed range": mixed_range(64, device),
    }
    pure = pure_python_phase(args.pure_pairs, args.pure_contracts, SLOTS_PER_CONTRACT)
    launch_counts = {label: path["launches"] for label, path in paths.items()}
    launch_counts["event path, unfused"] = paths["event path"]["unfused"]["launches"]
    launch_counts["event path, pure Python"] = pure["event"]["launches"]
    launch_counts["storage path, pure Python"] = pure["storage"]["launches"]

    rows = []
    for name, replaces, source, family in [(k[0], k[1], SOURCE, "blake2b") for k in KERNELS] + [
        (k[0], k[1], KECCAK_SOURCE, "keccak") for k in KECCAK_KERNELS
    ]:
        k = kernels[name]
        per_path = {label: counts[name] for label, counts in launch_counts.items()}
        row = {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": per_path[OWN_PATH[family]],
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
    for label, path in paths.items():
        _log(f"{label}: {json.dumps(path)}")
    _log(f"pure-Python paths: {json.dumps(pure)}")
    event, storage = paths["event path"], paths["storage path"]
    _log(
        f"event path on {smi}: {event['proofs']} proofs, {event['proofs_per_s']} proofs/s, "
        f"{event['host']}"
    )
    _log(
        f"storage path on {smi}: {storage['proofs']} proofs, {storage['proofs_per_s']} proofs/s, "
        f"{storage['host']}"
    )
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
