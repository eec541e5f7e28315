"""Sanitizer-hardened build + test of the port's native code, host and card.

The port's counterpart of the reference's ``tools/build_native_san.py``, in
two halves.

**Host half** — the reference's gate applied to the port's own C copies:
builds ``backend/native/scan_ext.c`` and ``dagcbor_ext.c`` with ASan+UBSan
and the full warning set promoted to errors (``SAN_FLAGS`` of
``core._cid_native``: ``-fsanitize=address,undefined -Wall -Wextra
-Werror``), then drives them under ``LD_PRELOAD`` of the ASan runtime: the
port's native test files where the reference package (and JAX) is
installed to hold them against and no card is (the JAX package never runs
beside the card), and on every host the soak's native phases
(`NATIVE_SOAK_PHASES`: codec/exec-order parity, DAG-CBOR native/Python
equivalence, header lite/full acceptance, HAMT and AMT shapes), which need
neither. Memory errors and undefined behaviour in the C scanner and codec
become hard failures instead of silent corruption. The sanitized libraries
are ``<module>-<hash>.san.so`` (``IPC_PROOFS_SAN=1``, see
``core._cid_native.build_cpython_ext``), so they never land in the fast
path's cache.

**CUDA half** — the nine C entries of ``csrc/blake2b.cu``,
``csrc/keccak.cu`` and ``csrc/match.cu`` launched at edge sizes
(`kernel_cases`: message lengths around every block edge, multi-block rows
up to the padded maximum, rows whose block count is 0, negative or past
the padded maximum; match worlds of 1, 3, 4, 5 and 33 events a receipt,
the actor filter on and off, receipt ids outside ``[0, num)``;
`match_pipeline` also writing one block into the interior slice of a mesh's
whole outputs, its hits and count stored and ORed and added; and row
counts around the warp and thread-block edges up to 4,097;
each blake2b entry also with one and four lanes a message forced, and
on both sides of its four-lane crossover; the two flat masks also with
topic0 equal to the spec on every row and every fingerprint equal to the
target, at row counts that are not multiples of 2, 4 or 8), each held
against its plain PyTorch version, in a child process (``--cuda-child``):

- the guard-band check, always: every input and the output sit between
  redzones inside a larger device buffer, and each case runs twice with
  other fill patterns in the redzones and in the output. A write past a
  buffer shows as a changed redzone, a write into an input as a changed
  input, and a read past a buffer or of an output row never written as a
  result that differs from the plain version under one of the fills. A
  block written into an interior slice has the rest of the whole outputs
  as a guard band on both sides, held to their fill;
- ``compute-sanitizer --tool memcheck`` and then ``--tool initcheck``
  around the same child, with ``--error-exitcode 1`` and PyTorch's
  caching allocator off (each tensor its own allocation, so memcheck sees
  its bounds). A device the tool refuses ("Device not supported") is
  reported as such, and the guard-band check alone stands for the half.
  Racecheck is not run: the only shared memory written by more than one
  thread is ``match_pipeline``'s per-receipt flags, set to 1 between two
  barriers (racing writes of one value).

Exit codes: 0 = clean run *or* graceful skip (no gcc / no libasan, no card
/ no ``compute-sanitizer`` — images without the toolchain shouldn't fail
the CPU gates); 1 = compile warning, sanitizer report, guard-band
violation, mismatch or test failure. ``--strict`` turns a skip into a
failure. Each half ends with its seconds (``build_native_san: host half
12.3 s``); the CUDA half's result is the line ``build_native_san: cuda
summary {json}`` (launches, per-tool status and error counts,
guard-band violations and mismatches per entry).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[2]
SOURCES = ("scan_ext.c", "dagcbor_ext.c")
MODULES = ("ipc_torch_scan_ext", "ipc_torch_dagcbor_ext")

# the port's counterparts of the reference's NATIVE_TESTS: the C extensions
# end to end against the reference's (scanner, DAG-CBOR, the native CID
# type) and the tampered-bundle and codec fuzz corpora
NATIVE_TESTS = (
    "tests/test_torch_native.py",
    "tests/test_torch_native_verify.py",
    "tests/test_torch_soak.py",
)
# the soak's phases that run the C scanner and codec on fresh seeds, with
# no reference package and no card (`python -m ipc_proofs_tpu_torch.tools.soak`)
NATIVE_SOAK_PHASES = ("codec", "dagcbor", "header", "trees")
SOAK_SEED = 0

SANITIZER_TOOLS = ("memcheck", "initcheck")
# message lengths at every block edge, per kernel entry
BLAKE2B_SINGLE_LENGTHS = (0, 1, 127, 128)
BLAKE2B_TWO_LENGTHS = (0, 1, 127, 128, 129, 255, 256)
BLAKE2B_BLOCK_LENGTHS = (0, 1, 127, 128, 129, 255, 256, 257, 383, 384, 385, 1023, 1024)
KECCAK_SINGLE_LENGTHS = (0, 1, 134, 135)
KECCAK_BLOCK_LENGTHS = (0, 1, 135, 136, 137, 271, 272, 273, 1087)
PADDED_BLOCKS = 8  # the padded maximum of the multi-block entries
# blake2b256_blocks' cases: (case name, lanes a message: None = by row
# count, as the wrapper picks them, or 1 or 4)
BLAKE2B_BLOCK_CASES = (
    ("blake2b256_blocks", None),
    ("blake2b256_blocks[1 lane]", 1),
    ("blake2b256_blocks[4 lanes]", 4),
)
# the same for the single- and two-block entries
BLAKE2B_SPLIT_CASES = {
    entry: ((entry, None), (f"{entry}[1 lane]", 1), (f"{entry}[4 lanes]", 4))
    for entry in ("blake2b256_single_block", "blake2b256_two_block")
}
MATCH_ENTRIES = ("match_pipeline", "event_match_mask", "event_match_mask_fp", "receipts_with_match")
MATCH_EVENTS = (1, 3, 4, 5, 33)  # events a receipt of the match pipeline's cases, in turn
MATCH_ACTOR = 1001
ROW_COUNTS = (1, 31, 32, 33, 127, 128, 129, 4097)
# the flat masks with topic0 equal to the spec on every row (topic1 as
# planted: equal, one word off or not) and with every fingerprint equal to
# the target, at row counts that are not multiples of 2, 4 or 8
FULL_SHARE_CASES = ("event_match_mask[topic0 on every row]", "event_match_mask_fp[target on every row]")
FULL_SHARE_ROWS = (3, 5, 7, 129, 1025)
# `match_pipeline` writing a block of one tipset into the middle of a 3 x 3
# mesh's whole outputs (tipset row 1, event columns E to 2E): as a row's
# first block (hits and count stored), and as a later one (hits ORed, count
# added), at receipt counts around the block edges
SLICE_CASES = ("match_pipeline[interior slice]", "match_pipeline[interior slice, OR and add]")
SLICE_ROWS = (1, 33, 129)
SLICE_MESH = 3
# the padded maximum of blake2b256_blocks' case on each side of the row
# count at which it goes from four lanes a message to one
# (``ops.blake2b.QUAD_ROWS_MAX``)
CROSSOVER_BLOCKS = 3
GUARD_FILLS = 2
REDZONE_WORDS = 4096  # 16 KiB each side, four padded multi-block rows and more

_PROBE_C = "int main(void) { return 0; }\n"
_UNSUPPORTED = "Device not supported"
_SUMMARY_RE = re.compile(r"ERROR SUMMARY: (\d+) error")


def _gcc_file(name: str) -> "str | None":
    """Resolve a runtime library through gcc; None when not installed."""
    try:
        out = subprocess.run(
            ["gcc", "-print-file-name=" + name],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.SubprocessError):
        return None
    path = out.stdout.strip()
    return path if os.path.isabs(path) and os.path.exists(path) else None


def probe_toolchain() -> "tuple[bool, str]":
    """Can this host compile AND run sanitized code?

    Returns (ok, detail) — detail is the LD_PRELOAD string on success, a
    human-readable skip reason on failure.
    """
    try:
        out = subprocess.run(
            ["gcc", "-print-file-name=libasan.so"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.SubprocessError):
        return False, "gcc not found"
    libasan = out.stdout.strip()
    # gcc echoes the bare name back when the runtime isn't installed
    if not libasan or not os.path.isabs(libasan) or not os.path.exists(libasan):
        return False, "libasan runtime not installed"
    # libstdc++ must ride along in LD_PRELOAD: python doesn't link it, so
    # when ASan initializes its __cxa_throw interceptor the real symbol is
    # absent, and the first C++ throw from a later-dlopened lib (torch's,
    # jaxlib's) hits an AddressSanitizer CHECK instead of unwinding
    libstdcpp = _gcc_file("libstdc++.so.6")
    preload = f"{libasan} {libstdcpp}" if libstdcpp else libasan
    with tempfile.TemporaryDirectory(prefix="san_probe_") as td:
        src = Path(td) / "probe.c"
        exe = Path(td) / "probe"
        src.write_text(_PROBE_C)
        try:
            subprocess.run(
                ["gcc", "-fsanitize=address,undefined", str(src), "-o", str(exe)],
                check=True, capture_output=True, timeout=60,
            )
            subprocess.run(
                [str(exe)], check=True, capture_output=True, timeout=30,
                env={**os.environ, "ASAN_OPTIONS": "detect_leaks=0"},
            )
        except (OSError, subprocess.SubprocessError):
            return False, "sanitized probe failed to compile/run"
    return True, preload


def _san_env(preload: str) -> "dict[str, str]":
    return {
        **os.environ,
        "IPC_PROOFS_SAN": "1",
        "LD_PRELOAD": preload,
        # CPython's arenas/interned strings read as leaks; everything else
        # (overflow, UAF) still aborts the run
        "ASAN_OPTIONS": "detect_leaks=0",
        "UBSAN_OPTIONS": "print_stacktrace=1:halt_on_error=1",
        "JAX_PLATFORMS": "cpu",
        "PYTHONPATH": str(REPO_ROOT),
    }


def build_sanitized(preload: str, verbose: bool = True) -> int:
    """Compile both extensions sanitized + warning-clean; 0 on success.

    Builds through the shared builder (with IPC_PROOFS_SAN=1) so the
    ``.san.so`` names, host key and flag set stay in one place — but in a
    SUBPROCESS, because the builder imports the module it built and the
    sanitized .so cannot load into this (unpreloaded) interpreter.
    """
    code = (
        "from ipc_proofs_tpu_torch.core import _cid_native as n\n"
        f"for src, mod in zip({SOURCES!r}, {MODULES!r}):\n"
        "    print(n.build_cpython_ext(n.NATIVE_DIR / src, mod).__file__)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO_ROOT,
        capture_output=True, text=True, timeout=600, env=_san_env(preload),
    )
    if proc.returncode != 0:
        if verbose:
            sys.stderr.write(proc.stderr)
            print("build_native_san: sanitized build FAILED", file=sys.stderr)
        return 1
    if verbose:
        for so in proc.stdout.split():
            print(f"build_native_san: built {Path(so).relative_to(REPO_ROOT)}")
    return 0


def _reference_tests_run_here() -> bool:
    """The native test files hold the port against the JAX reference: they
    run where the reference and JAX are installed, and never on a host with
    a CUDA card (the JAX package is not run beside the card)."""
    import torch

    return (
        (REPO_ROOT / "ipc_proofs_tpu").is_dir()
        and importlib.util.find_spec("jax") is not None
        and not torch.cuda.is_available()
    )


def run_tests(preload: str, extra_pytest_args: "list[str] | None" = None) -> int:
    """Drive the sanitized extensions: the native test files where the
    reference runs (`_reference_tests_run_here`), then the soak's native
    phases."""
    env = _san_env(preload)
    if _reference_tests_run_here():
        # -s: sanitizer reports print to the real stderr as the process
        # dies — pytest's fd capture would swallow them with the test
        cmd = [
            sys.executable, "-m", "pytest", "-q", "-s", "-m", "not slow",
            "-p", "no:cacheprovider",
            *NATIVE_TESTS,
            *(extra_pytest_args or []),
        ]
        rc = subprocess.run(cmd, cwd=REPO_ROOT, timeout=1800, env=env).returncode
        if rc != 0:
            return rc
    else:
        print("build_native_san: no reference to test against here — native soak phases only")
    cmd = [
        sys.executable, "-m", "ipc_proofs_tpu_torch.tools.soak", str(SOAK_SEED),
        *NATIVE_SOAK_PHASES, "--quick", "--device", "cpu",
    ]
    return subprocess.run(cmd, cwd=REPO_ROOT, timeout=1800, env=env).returncode


def host_half(strict: bool, build_only: bool, pytest_args: "list[str]") -> int:
    ok, detail = probe_toolchain()
    if not ok:
        print(f"build_native_san: SKIP host half ({detail})", file=sys.stderr)
        return 1 if strict else 0
    rc = build_sanitized(detail)
    if rc != 0 or build_only:
        return rc
    rc = run_tests(detail, pytest_args)
    if rc != 0:
        print("build_native_san: sanitized tests FAILED", file=sys.stderr)
        return rc
    print("build_native_san: sanitized build + native tests clean")
    return 0


# --- CUDA half ---------------------------------------------------------------


def _messages(rng, edges: "tuple[int, ...]", n: int, cap: int) -> "list[bytes]":
    """``n`` seeded messages: every edge length first (twice over where
    there is room), then uniform lengths in [0, cap]."""
    lengths = [edges[i % len(edges)] if i < 2 * len(edges) else int(rng.integers(0, cap + 1))
               for i in range(n)]
    return [rng.integers(0, 256, length, dtype="uint8").tobytes() for length in lengths]


def _odd_counts(n_blocks, padded: int) -> None:
    """Rows whose block count is 0, negative or past the padded maximum
    (absorbed up to it): the entries' masked-row semantics."""
    if len(n_blocks) >= 3:
        n_blocks[:3] = (0, -1, padded + 2)


def _event_rows(rng, rows: int, spec):
    """Event rows for the match entries: about a third with both topics
    equal to ``spec`` (int32 [16]), some of those with one word flipped,
    ``n_topics`` 0..3, about a tenth invalid, two emitters."""
    import numpy as np

    topics = rng.integers(-(2**31), 2**31, (rows, 2, 8), dtype=np.int64).astype(np.int32)
    planted = rng.random(rows) < 0.35
    topics[planted] = spec.reshape(2, 8)
    near = planted & (rng.random(rows) < 0.2)
    topics[near, 1, 3] ^= 1
    n_topics = rng.integers(0, 4, rows).astype(np.int32)
    valid = rng.random(rows) < 0.9
    emitters = np.where(rng.random(rows) < 0.8, MATCH_ACTOR, MATCH_ACTOR + 1).astype(np.int32)
    return topics, n_topics, valid, emitters


def _match_cases(rng, k: int, n: int):
    """The four match entries' cases at ``n`` rows (receipts for
    `match_pipeline`, one tipset of them)."""
    import numpy as np

    spec = rng.integers(-(2**31), 2**31, 16, dtype=np.int64).astype(np.int32)
    e = MATCH_EVENTS[k % len(MATCH_EVENTS)]
    topics, n_topics, valid, emitters = _event_rows(rng, n * e, spec)
    actor = np.array(-1 if k % 2 else MATCH_ACTOR, dtype=np.int32)
    yield "match_pipeline", n, _pipeline_inputs(topics, n_topics, emitters, valid, spec, actor, n, e), (e, 0, 0, e, 0)
    topics, n_topics, valid, _ = _event_rows(rng, n, spec)
    yield "event_match_mask", n, (topics, n_topics, valid, spec[:8], spec[8:]), ()
    target = int(rng.integers(-(2**63), 2**63 - 1, dtype=np.int64))
    fp = rng.integers(-(2**63), 2**63 - 1, n, dtype=np.int64)
    fp[rng.random(n) < 0.4] = target
    yield "event_match_mask_fp", n, (fp, rng.random(n) < 0.9), (target,)
    num = max(1, n // 3)
    ids = rng.integers(-2 * num, 2 * num, n).astype(np.int64 if k % 2 else np.int32)
    yield "receipts_with_match", n, (rng.random(n) < 0.3, ids), (num, ids.itemsize)


def _pipeline_inputs(topics, n_topics, emitters, valid, spec, actor, n: int, e: int) -> tuple:
    """`match_pipeline`'s inputs for one tipset of ``n`` receipts of ``e``
    events."""
    import numpy as np

    return (
        topics.reshape(1, n, e, 2, 8), n_topics.reshape(1, n, e), emitters.reshape(1, n, e),
        valid.reshape(1, n, e), spec[:8], spec[8:], actor,
    )


def _slice_cases(rng, k: int, n: int):
    """`SLICE_CASES` at ``n`` receipts: extra ints (events a receipt, first
    receipt, first event column, the whole mask's events a receipt, flags)."""
    import numpy as np

    from ipc_proofs_tpu_torch.parallel import pipeline

    spec = rng.integers(-(2**31), 2**31, 16, dtype=np.int64).astype(np.int32)
    e = MATCH_EVENTS[k % len(MATCH_EVENTS)]
    topics, n_topics, valid, emitters = _event_rows(rng, n * e, spec)
    inputs = _pipeline_inputs(topics, n_topics, emitters, valid, spec, np.array(MATCH_ACTOR, dtype=np.int32), n, e)
    for name, flags in zip(SLICE_CASES, (0, pipeline.OR_HITS | pipeline.ADD_COUNT)):
        yield name, n, inputs, (e, n, e, SLICE_MESH * e, flags)


def _full_share_cases(rng, n: int):
    """`FULL_SHARE_CASES` at ``n`` rows."""
    import numpy as np

    spec = rng.integers(-(2**31), 2**31, 16, dtype=np.int64).astype(np.int32)
    topics, n_topics, valid, _ = _event_rows(rng, n, spec)
    topics[:, 0] = spec[:8]
    yield FULL_SHARE_CASES[0], n, (topics, n_topics, valid, spec[:8], spec[8:]), ()
    target = int(rng.integers(-(2**63), 2**63 - 1, dtype=np.int64))
    yield FULL_SHARE_CASES[1], n, (np.full(n, target, dtype=np.int64), rng.random(n) < 0.9), (target,)


def kernel_cases(seed: int = 0):
    """(entry, rows, inputs, extra ints) for every kernel entry and row
    count: ``inputs`` are numpy arrays in the entry's argument order (u32
    data as u32 or int32 words), ``extra`` the ints after the row count
    (the padded maximum of the multi-block entries, then the blake2b
    entries' lanes a message; the match entries'
    events a receipt, fingerprint target, or receipt count and id width)."""
    import numpy as np

    from ipc_proofs_tpu_torch.ops import blake2b, pack

    for k, n in enumerate(ROW_COUNTS):
        rng = np.random.default_rng([seed, k])
        for entry, cases in BLAKE2B_SPLIT_CASES.items():
            yield from _blake2b_split_cases(rng, n, entry, cases)
        yield from _blake2b_block_cases(rng, n, PADDED_BLOCKS, BLAKE2B_BLOCK_CASES)
        blo, bhi, _ = pack.pack_single_block_keccak(_messages(rng, KECCAK_SINGLE_LENGTHS, n, 135))
        yield "keccak256_single_block", n, (blo[:n], bhi[:n]), ()
        blocks, n_blocks = pack.pad_keccak(
            _messages(rng, KECCAK_BLOCK_LENGTHS, n, 136 * PADDED_BLOCKS - 1), PADDED_BLOCKS)
        _odd_counts(n_blocks, PADDED_BLOCKS)
        yield "keccak256_blocks", n, (blocks, n_blocks), (PADDED_BLOCKS,)
        yield from _match_cases(rng, k, n)
    for k, n in enumerate(FULL_SHARE_ROWS):
        yield from _full_share_cases(np.random.default_rng([seed, 200 + k]), n)
    for k, n in enumerate(SLICE_ROWS):
        yield from _slice_cases(np.random.default_rng([seed, 300 + k]), k, n)
    # the wrappers' lanes on each side of their crossovers: four, then one
    most = blake2b.QUAD_ROWS_MAX
    for k, n in enumerate((most, most + 1)):
        yield from _blake2b_block_cases(np.random.default_rng([seed, 100 + k]), n, CROSSOVER_BLOCKS,
                                        BLAKE2B_BLOCK_CASES[:1])
    for j, (entry, cases) in enumerate(BLAKE2B_SPLIT_CASES.items()):
        most = blake2b.quad_rows_max(entry)
        for k, n in enumerate((most, most + 1)):
            yield from _blake2b_split_cases(np.random.default_rng([seed, 110 + 2 * j + k]), n, entry, cases[:1])


def _blake2b_split_cases(rng, n: int, entry: str, cases):
    """The ``cases`` (of `BLAKE2B_SPLIT_CASES`) of ``entry`` at ``n`` rows,
    every message at a block edge of its layout: extra ints (lanes a
    message)."""
    from ipc_proofs_tpu_torch.ops import blake2b, pack

    if entry == "blake2b256_single_block":
        packer, edges, cap = pack.pack_single_block_blake2b, BLAKE2B_SINGLE_LENGTHS, 128
    else:
        packer, edges, cap = pack.pack_two_block_blake2b, BLAKE2B_TWO_LENGTHS, 256
    m_lo, m_hi, lengths, _ = packer(_messages(rng, edges, n, cap))
    for name, lanes in cases:
        yield name, n, (m_lo[:n], m_hi[:n], lengths[:n]), (lanes or blake2b.lanes_for_rows(n, entry),)


def _blake2b_block_cases(rng, n: int, padded: int, cases):
    """The ``cases`` (of `BLAKE2B_BLOCK_CASES`) at ``n`` rows of up to
    ``padded`` blocks: extra ints (padded maximum, lanes a message)."""
    from ipc_proofs_tpu_torch.ops import blake2b, pack

    edges = tuple(length for length in BLAKE2B_BLOCK_LENGTHS if length <= 128 * padded)
    blocks, n_blocks, lengths = pack.pad_blake2b(_messages(rng, edges, n, 128 * padded), padded)
    _odd_counts(n_blocks, padded)
    for name, lanes in cases:
        yield name, n, (blocks, n_blocks, lengths), (padded, lanes or blake2b.lanes_for_rows(n))


def outputs_of(entry: str, n: int, inputs, extra) -> "list[tuple[tuple, object]]":
    """(shape, torch dtype) of each output of ``entry``'s case, in the C
    entry's order."""
    import torch

    if entry in SLICE_CASES:
        return [((SLICE_MESH, n), torch.bool), ((SLICE_MESH, n, SLICE_MESH * extra[0]), torch.bool),
                ((), torch.int32)]
    entry = _c_entry(entry)
    if entry == "match_pipeline":
        return [((1, n), torch.bool), ((1, n, extra[0]), torch.bool), ((), torch.int32)]
    if entry in ("event_match_mask", "event_match_mask_fp"):
        return [((n,), torch.bool)]
    if entry == "receipts_with_match":
        return [((extra[0],), torch.bool)]
    return [((n, 8), torch.int32)]


def _c_entry(entry: str) -> str:
    """The C entry a case name launches (``blake2b256_blocks[1 lane]`` →
    ``blake2b256_blocks``)."""
    return entry.split("[")[0]


def _plain(entry: str):
    """The plain version of ``entry`` as ``fn(input_views, extra, outs=None)``
    → a tuple of its outputs. ``outs``: the case's whole outputs as they
    are before the launch, which `match_pipeline` writes into (its
    `SLICE_CASES` need them: the rest of the outputs keeps its bytes); the
    other entries ignore them."""
    entry = _c_entry(entry)
    from ipc_proofs_tpu_torch.ops import blake2b, keccak, match
    from ipc_proofs_tpu_torch.parallel import pipeline

    if entry == "match_pipeline":
        def pipeline_plain(views, extra, outs=None):
            if outs is None:
                return tuple(pipeline.match_pipeline_plain(*views))
            _, receipt0, col0, _, flags = extra
            return tuple(pipeline.match_pipeline_plain(
                *views, out=tuple(outs), row0=receipt0 // max(views[0].shape[1], 1), col0=col0,
                or_hits=bool(flags & pipeline.OR_HITS), add_count=bool(flags & pipeline.ADD_COUNT)))

        return pipeline_plain
    if entry == "event_match_mask":
        return lambda views, extra, outs=None: (match.topic_mask_plain(*views),)
    if entry == "event_match_mask_fp":
        return lambda views, extra, outs=None: (match.fp_mask_plain(*views, extra[0]),)
    if entry == "receipts_with_match":
        return lambda views, extra, outs=None: (match.receipts_with_match_plain(*views, extra[0]),)
    fn = getattr(blake2b if entry.startswith("blake2b") else keccak, entry + "_plain")
    return lambda views, extra, outs=None: (fn(*views),)


def _host(array):
    """A numpy input as the tensor the kernels take (u32 as int32 bits)."""
    import numpy as np
    import torch

    array = np.asarray(array)
    if array.dtype == np.uint32:
        array = array.view(np.int32)
    return torch.from_numpy(np.array(array, copy=True))


def guarded_run(call, inputs, outputs, device, fill_seed: int, redzone: int = REDZONE_WORDS,
                initial: "list | None" = None):
    """Run ``call(input_views, *output_views)`` once on guarded buffers and
    return (outs, violations): ``outs`` the results on the host,
    ``violations`` a list of what went wrong (an input or an output's
    redzone changed, an input changed).

    ``outputs`` lists each output's (shape, torch dtype); ``outs`` is a
    tuple of them. Every input and output lies at a 16-byte-aligned
    offset inside a byte buffer ``redzone`` words longer at each end; the
    redzones and the outputs are filled from ``fill_seed`` first. A list
    given as ``initial`` receives the outputs as filled, on the host,
    before the call."""
    import numpy as np
    import torch

    rng = np.random.default_rng(fill_seed)
    pad = 4 * redzone

    def guarded(raw: "np.ndarray | None", nbytes: int, dtype, shape):
        fill = rng.integers(0, 256, nbytes + 2 * pad, dtype=np.uint8)
        if raw is not None:
            fill[pad : pad + nbytes] = raw
        host = torch.from_numpy(fill)
        buf = host.to(device, copy=True)
        return host, buf, buf[pad : pad + nbytes].view(dtype).view(shape)

    ins, views = [], []
    for array in inputs:
        tensor = _host(array)
        raw = tensor.reshape(-1).view(torch.uint8).numpy() if tensor.numel() else np.zeros(0, np.uint8)
        host, buf, view = guarded(raw, raw.size, tensor.dtype, tuple(tensor.shape))
        ins.append((host, buf))
        views.append(view)
    outs = []
    for shape, dtype in outputs:
        nbytes = int(np.prod(shape, dtype=np.int64)) * torch.empty((), dtype=dtype).element_size()
        outs.append((nbytes, dtype, shape, *guarded(None, nbytes, dtype, shape)))
    if initial is not None:  # the buffers' bytes: a copy of a bool tensor makes every byte 0 or 1
        initial.extend(buf[pad : pad + nbytes].cpu().clone().view(dtype).view(shape)
                       for nbytes, dtype, shape, _, buf, _ in outs)
    call(views, *(view for *_, view in outs))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    violations = []
    for i, (host, buf) in enumerate(ins):
        if not torch.equal(buf.cpu(), host):
            violations.append(f"input {i} or its redzone changed")
    results = []
    for i, (nbytes, dtype, shape, host, buf, _) in enumerate(outs):
        after = buf.cpu()
        if not (torch.equal(after[:pad], host[:pad]) and torch.equal(after[pad + nbytes :], host[pad + nbytes :])):
            violations.append(f"output {i} redzone changed")
        results.append(after[pad : pad + nbytes].view(dtype).view(shape))
    return tuple(results), violations


def same_bytes(got, want) -> bool:
    """Equal shapes and equal bytes (a bool holding another byte than 0 or
    1 differs)."""
    import torch

    def raw(t):
        return t.reshape(-1).view(torch.uint8) if t.dtype == torch.bool else t

    return got.dtype == want.dtype and got.shape == want.shape and torch.equal(raw(got), raw(want))


def _rows(entry: str, views) -> int:
    """The row count an entry's C call takes (receipts for the pipeline)."""
    shape = views[0].shape
    return shape[0] * shape[1] if _c_entry(entry) == "match_pipeline" else shape[0]


def _kernel_call(entry: str, extra: tuple):
    """``call(views, *outs)`` launching the C entry ``entry`` on PyTorch's
    current stream."""
    import torch

    from ipc_proofs_tpu_torch.ops import blake2b, build, keccak, match
    from ipc_proofs_tpu_torch.parallel import pipeline

    name = _c_entry(entry)
    if name == "match_pipeline":
        library, module = "match", pipeline
    elif name in MATCH_ENTRIES:
        library, module = "match", match
    else:
        library, module = ("blake2b", blake2b) if name.startswith("blake2b") else ("keccak", keccak)
    fn = build._entry(library, name, module._ARGTYPES[name])

    def call(views, *outs):
        device = outs[0].device
        stream = torch.cuda.current_stream(device).cuda_stream
        with torch.cuda.device(device):
            rc = fn(*(v.data_ptr() for v in views), _rows(entry, views), *extra,
                    *(out.data_ptr() for out in outs), stream)
        if rc != 0:
            raise build.DeviceFaultError(f"{entry}: CUDA launch failed with error {rc}")

    return call


def check_kernels(device, call_for=_kernel_call, seed: int = 0) -> dict:
    """Every case of `kernel_cases` under `GUARD_FILLS` fills on
    ``device``: launches made, and the violations and mismatches against
    the plain versions, per entry. ``call_for(entry, extra)`` gives the
    launch (the C entry; a test passes its own)."""
    report: "dict[str, dict]" = {}
    for entry, n, inputs, extra in kernel_cases(seed):
        row = report.setdefault(entry, {"launches": 0, "rows": [], "violations": [], "mismatches": 0})
        row["rows"].append(n)
        plain = _plain(entry)
        want = plain([_host(a) for a in inputs], extra)
        outputs = outputs_of(entry, n, inputs, extra)
        call = call_for(entry, extra)
        for fill in range(GUARD_FILLS):
            initial: list = []
            outs, violations = guarded_run(call, inputs, outputs, device, fill_seed=seed * 1000 + fill,
                                           initial=initial)
            if entry in SLICE_CASES:  # the rest of the whole outputs keeps its fill
                want = plain([_host(a) for a in inputs], extra, initial)
            row["launches"] += 1
            row["violations"] += [f"rows={n} fill={fill}: {v}" for v in violations]
            row["mismatches"] += int(not all(same_bytes(o, w) for o, w in zip(outs, want)))
    return report


def cuda_child() -> int:
    """The child: `check_kernels` on the card, one JSON line, exit 1 on
    any violation or mismatch."""
    import torch

    report = check_kernels(torch.device("cuda"))
    print("CUDA_CHILD " + json.dumps(report, sort_keys=True), flush=True)
    bad = any(r["violations"] or r["mismatches"] for r in report.values())
    return 1 if bad else 0


def _child_report(stdout: str) -> "dict | None":
    for line in stdout.splitlines():
        if line.startswith("CUDA_CHILD "):
            return json.loads(line[len("CUDA_CHILD "):])
    return None


def _run_child(prefix: "list[str]", env: "dict[str, str]") -> "tuple[int, str]":
    proc = subprocess.run(
        [*prefix, sys.executable, "-m", "ipc_proofs_tpu_torch.tools.build_native_san",
         "--cuda-child"],
        cwd=REPO_ROOT, capture_output=True, text=True, timeout=1800, env=env,
    )
    return proc.returncode, proc.stdout + proc.stderr


def cuda_half(strict: bool) -> int:
    import torch

    from ipc_proofs_tpu_torch.ops.build import KERNEL_LIBRARIES, DeviceFaultError, cuda_tool, load_libraries

    if not torch.cuda.is_available():
        print("build_native_san: SKIP cuda half (no CUDA card)", file=sys.stderr)
        return 1 if strict else 0
    try:
        sanitizer = cuda_tool("compute-sanitizer")
        load_libraries(KERNEL_LIBRARIES)  # built here, not under the tool
    except DeviceFaultError as exc:
        print(f"build_native_san: SKIP cuda half ({exc})", file=sys.stderr)
        return 1 if strict else 0
    env = {**os.environ, "PYTHONPATH": str(REPO_ROOT)}
    summary: dict = {"launches": 0, "tools": {}}
    rc, out = _run_child([], env)
    guard = _child_report(out)
    if rc != 0 or guard is None:
        sys.stderr.write(out[-8000:])
        print("build_native_san: guard-band check FAILED", file=sys.stderr)
        return 1
    summary["guard"] = {e: {k: r[k] for k in ("launches", "mismatches")}
                        | {"violations": len(r["violations"])} for e, r in guard.items()}
    summary["launches"] += sum(r["launches"] for r in guard.values())
    # each tensor its own allocation, so memcheck sees every bound
    tool_env = {**env, "PYTORCH_NO_CUDA_MEMORY_CACHING": "1"}
    for tool in SANITIZER_TOOLS:
        rc, out = _run_child(
            [sanitizer, "--tool", tool, "--error-exitcode", "1", "--print-limit", "50"], tool_env
        )
        if _UNSUPPORTED in out:
            summary["tools"][tool] = {"status": "device not supported"}
            continue
        counts = [int(c) for c in _SUMMARY_RE.findall(out)]
        report = _child_report(out)
        errors = sum(counts) if counts else None
        summary["tools"][tool] = {"status": "ran", "errors": errors, "exit": rc}
        if report is not None:
            summary["launches"] += sum(r["launches"] for r in report.values())
        if rc != 0 or errors != 0 or report is None:
            sys.stderr.write(out[-8000:])
            print(f"build_native_san: compute-sanitizer {tool} FAILED", file=sys.stderr)
            print("build_native_san: cuda summary " + json.dumps(summary, sort_keys=True))
            return 1
    print("build_native_san: cuda summary " + json.dumps(summary, sort_keys=True))
    return 0


def main(argv: "list[str] | None" = None) -> int:
    ap = argparse.ArgumentParser(
        prog="ipc_proofs_tpu_torch.tools.build_native_san",
        description="ASan/UBSan build + native tests of the C extensions, "
        "and the CUDA kernels at edge sizes under guard bands and compute-sanitizer",
    )
    ap.add_argument(
        "--strict", action="store_true",
        help="fail (exit 1) instead of skipping when the toolchain or the card is missing",
    )
    ap.add_argument(
        "--build-only", action="store_true",
        help="compile the sanitized extensions but skip the test run and the CUDA half",
    )
    ap.add_argument("--cuda-child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument(
        "pytest_args", nargs="*",
        help="extra args forwarded to pytest (e.g. -k decode)",
    )
    args = ap.parse_args(argv)
    if args.cuda_child:
        return cuda_child()

    t0 = time.perf_counter()
    rc = host_half(args.strict, args.build_only, args.pytest_args)
    print(f"build_native_san: host half {time.perf_counter() - t0:.1f} s", flush=True)
    if rc != 0 or args.build_only:
        return rc
    t0 = time.perf_counter()
    rc = cuda_half(args.strict)
    print(f"build_native_san: cuda half {time.perf_counter() - t0:.1f} s", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
