"""Build, load and launch the package's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes``. Libraries are
built at first use into ``_build/`` beside the sources (git-ignored), named
by a hash of the source and the flags, so an edited source rebuilds and an
unchanged one loads at once. Nothing is built or imported at module import.

The kernel wrappers (``ops/blake2b.py``, ``ops/keccak.py``, ``ops/match.py``
and ``parallel/pipeline.py``'s `match_pipeline`) share the rest:
`check_words` / `check_tensor` on their inputs, `runs_plain` for the device
rule (a CPU tensor runs the plain version, a CUDA tensor launches the
kernel, any other device raises) and `launch`, which calls a kernel's C
entry with the output tensors its caller allocated on PyTorch's current
stream and counts it in the wrapper module's ``LAUNCHES``, and its rows
(messages or events) in the module's ``ROWS``.

Several host threads may launch at once (the pipelined range driver's
verify workers and its coalescer's leader): libraries load under a lock,
each C entry is bound once (its ctypes signature set under the same lock,
never per call), every launch goes to the calling thread's current stream
into outputs its caller allocated, and counts update under a lock.
`load_libraries(KERNEL_LIBRARIES)` builds every source at once, before such
threads start.

A kernel that cannot be built or launched raises `DeviceFaultError`.
`is_device_fault` names every fault of the card (that error, the verify
lane's `VerifyLaneError`, PyTorch's CUDA out-of-memory and accelerator
errors): the serve plane answers them as the server's failure, never as a
client's bad request, and never journals them as a request's result.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from ipc_proofs_tpu_torch.core._cid_native import publish_build

__all__ = [
    "DeviceFaultError",
    "KERNEL_LIBRARIES",
    "NVCC_FLAGS",
    "build_libraries",
    "check_tensor",
    "check_words",
    "cuda_tool",
    "is_device_fault",
    "launch",
    "launch_digests",
    "load_libraries",
    "load_library",
    "loaded_libraries",
    "reset_counts",
    "runs_plain",
]

# every ``csrc/<name>.cu`` the package launches (``csrc/match_study.cu`` and
# ``csrc/blake2b_study.cu`` are chip_smoke.py's measurement-only sources,
# built there alone)
KERNEL_LIBRARIES = ("blake2b", "keccak", "match")

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers / spills per kernel, kept in the build log
)

_lock = threading.Lock()
_loaded: "dict[str, ctypes.CDLL]" = {}  # guarded-by: _lock
_entries: "dict[tuple[str, str], object]" = {}  # guarded-by: _lock; bound C entries
_count_lock = threading.Lock()  # guards every wrapper module's LAUNCHES and ROWS


class DeviceFaultError(RuntimeError):
    """A kernel the card could not build, load or launch."""


# the messages PyTorch builds without a type of their own (a kernel fault
# surfacing at a later synchronisation, a refused allocation)
_CUDA_MESSAGES = ("CUDA error", "CUDA out of memory", "CUBLAS_STATUS", "cudaError")


def is_device_fault(exc: "BaseException | None") -> bool:
    """True when ``exc``, or an exception it was raised from, is a fault of
    the card: `DeviceFaultError`, the verify lane's `VerifyLaneError`,
    ``torch.OutOfMemoryError``, ``torch.AcceleratorError`` where PyTorch
    has it, or a `RuntimeError` carrying a CUDA error message. A client's
    malformed request is none of these."""
    from ipc_proofs_tpu_torch.ops.verify import VerifyLaneError

    kinds = (DeviceFaultError, VerifyLaneError, torch.OutOfMemoryError)
    accelerator = getattr(torch, "AcceleratorError", None)
    if accelerator is not None:
        kinds += (accelerator,)
    for _ in range(16):
        if exc is None:
            return False
        if isinstance(exc, kinds):
            return True
        if isinstance(exc, RuntimeError) and any(m in str(exc) for m in _CUDA_MESSAGES):
            return True
        exc = exc.__cause__
    return False


def cuda_tool(name: str) -> str:
    """Path of a CUDA toolkit program (``nvcc``, ``cuobjdump``)."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", name))
    candidates += [shutil.which(name), f"/usr/local/cuda/bin/{name}"]
    for path in candidates:
        if path and os.path.exists(path):
            return path
    raise DeviceFaultError(f"{name} not found (set CUDA_HOME)")


_INCLUDE = re.compile(rb'^#include "([^"]+)"', re.M)


def _library_path(name: str) -> Path:
    """The library's file, named by a hash of its source, the ``csrc``
    sources it includes and the flags."""
    source = (_CSRC / f"{name}.cu").read_bytes()
    for included in _INCLUDE.findall(source):
        source += (_CSRC / included.decode()).read_bytes()
    key = hashlib.sha256(source + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return _BUILD / f"lib{name}-{key}.so"


def build_libraries(names) -> "dict[str, dict]":
    """Compile every named source that is not built yet — one ``nvcc`` per
    source, all started together — and return, per name, ``{"path",
    "seconds", "log"}`` (``log`` holds ptxas's register report; ``seconds``
    is 0.0 for a library already built). Raises RuntimeError with the
    compiler's output (a `DeviceFaultError`) if any build fails."""
    _BUILD.mkdir(parents=True, exist_ok=True)
    results: "dict[str, dict]" = {}
    running = []
    for name in names:
        path = _library_path(name)
        if path.exists():
            results[name] = {"path": path, "seconds": 0.0, "log": ""}
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [cuda_tool("nvcc"), *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        running.append((name, path, tmp, proc, time.perf_counter()))
    failures = []
    for name, path, tmp, proc, start in running:
        log, _ = proc.communicate()
        seconds = time.perf_counter() - start
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            continue
        publish_build(tmp, path)
        results[name] = {"path": path, "seconds": seconds, "log": log}
    if failures:
        raise DeviceFaultError("kernel build failed:\n" + "\n".join(failures))
    return results


def load_libraries(names) -> "list[ctypes.CDLL]":
    """The loaded ``csrc/<name>.cu`` libraries, those not built yet built
    first, all at once."""
    with _lock:
        missing = [name for name in names if name not in _loaded]
        if missing:
            for name, info in build_libraries(missing).items():  # ipclint: disable=lock-held-blocking (one-time kernel build, serialized by design: a second caller waits for the first build, not a second nvcc)
                _loaded[name] = ctypes.CDLL(str(info["path"]))
        return [_loaded[name] for name in names]


def load_library(name: str) -> ctypes.CDLL:
    """The loaded ``csrc/<name>.cu`` library, built first if needed."""
    return load_libraries([name])[0]


def loaded_libraries() -> "dict[str, str]":
    """The libraries this process has mapped: name -> the file it mapped."""
    with _lock:
        return {name: lib._name for name, lib in sorted(_loaded.items())}


def _entry(library: str, name: str, argtypes: list):
    """The C entry ``name`` of ``csrc/<library>.cu`` with its signature set,
    bound once per process."""
    lib = load_library(library)
    with _lock:
        fn = _entries.get((library, name))
        if fn is None:
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _entries[(library, name)] = fn
        return fn


def check_tensor(
    name: str, tensor: torch.Tensor, dtype: torch.dtype, shape: tuple, device: torch.device,
    align: int = 1,
) -> None:
    """A kernel input must be ``dtype`` of ``shape`` on ``device`` and
    contiguous; on a card its data must also lie on an ``align``-byte
    boundary (the kernel's widest load)."""
    if tensor.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {tensor.dtype}")
    if tuple(tensor.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(tensor.shape)}")
    if tensor.device != device:
        raise ValueError(f"{name}: tensors on {tensor.device} and {device}")
    if not tensor.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")
    if tensor.device.type == "cuda" and tensor.data_ptr() % align:
        raise ValueError(f"{name}: tensor must be {align}-byte aligned")


def check_words(name: str, tensor: torch.Tensor, shape: tuple, device: torch.device) -> None:
    """A kernel input must be int32 (a u32 bit view) of ``shape`` on
    ``device``, contiguous and 16-byte aligned (on the CPU too)."""
    check_tensor(name, tensor, torch.int32, shape, device)
    if tensor.data_ptr() % 16:
        raise ValueError(f"{name}: tensor must be 16-byte aligned")


def runs_plain(name: str, device: torch.device) -> bool:
    """True for the CPU (the wrapper runs its plain version), False for
    CUDA (it launches its kernel); any other device raises."""
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {device}")
    return device.type == "cpu"


def reset_counts(launches: "dict[str, int]") -> None:
    with _count_lock:
        for name in launches:
            launches[name] = 0


def launch(
    library: str,
    name: str,
    argtypes: list,
    args: list,
    outputs: "list[torch.Tensor]",
    device: torch.device,
    launches: "dict[str, int]",
    count_as: "str | None" = None,
    rows: "dict[str, int] | None" = None,
    n_rows: int = 0,
) -> None:
    """Call the C entry ``name`` of ``csrc/<library>.cu`` with ``args``, the
    data pointers of ``outputs`` (tensors the caller allocated on
    ``device``) and PyTorch's current stream, count the launch in
    ``launches[count_as or name]`` and its ``n_rows`` rows in ``rows``
    under the same key, and raise `DeviceFaultError` if the launch was
    refused. Does not synchronise."""
    fn = _entry(library, name, argtypes)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        rc = fn(*args, *(out.data_ptr() for out in outputs), stream)
    key = count_as or name
    with _count_lock:
        launches[key] += 1
        if rows is not None:
            rows[key] += n_rows
    if rc != 0:
        raise DeviceFaultError(f"{name}: CUDA launch failed with error {rc}")


def launch_digests(
    library: str,
    name: str,
    argtypes: list,
    args: list,
    n: int,
    device: torch.device,
    launches: "dict[str, int]",
    rows: "dict[str, int]",
) -> torch.Tensor:
    """`launch` a hash entry over ``n`` rows into a fresh int32 ``[n, 8]``
    digest tensor and return it (no launch for ``n == 0``)."""
    out = torch.empty((n, 8), dtype=torch.int32, device=device)
    if n:
        launch(library, name, argtypes, args, [out], device, launches, rows=rows, n_rows=n)
    return out
