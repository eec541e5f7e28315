"""Build, load and launch the package's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes``. Libraries are
built at first use into ``_build/`` beside the sources (git-ignored), named
by a hash of the source and the flags, so an edited source rebuilds and an
unchanged one loads at once. Nothing is built or imported at module import.

The kernel wrappers (``ops/blake2b.py``, ``ops/keccak.py``) share the rest:
`check_words` on their inputs, `runs_plain` for the device rule (a CPU
tensor runs the plain version, a CUDA tensor launches the kernel, any
other device raises) and `launch`, which calls a kernel's C entry on
PyTorch's current stream and counts it in the wrapper module's
``LAUNCHES``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

__all__ = [
    "NVCC_FLAGS",
    "build_libraries",
    "check_words",
    "cuda_tool",
    "launch",
    "load_library",
    "reset_counts",
    "runs_plain",
]

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
_count_lock = threading.Lock()  # guards every wrapper module's LAUNCHES


def cuda_tool(name: str) -> str:
    """Path of a CUDA toolkit program (``nvcc``, ``cuobjdump``)."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", name))
    candidates += [shutil.which(name), f"/usr/local/cuda/bin/{name}"]
    for path in candidates:
        if path and os.path.exists(path):
            return path
    raise RuntimeError(f"{name} not found (set CUDA_HOME)")


def _library_path(name: str) -> Path:
    source = (_CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(source + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return _BUILD / f"lib{name}-{key}.so"


def build_libraries(names) -> "dict[str, dict]":
    """Compile every named source that is not built yet — one ``nvcc`` per
    source, all started together — and return, per name, ``{"path",
    "seconds", "log"}`` (``log`` holds ptxas's register report; ``seconds``
    is 0.0 for a library already built). Raises RuntimeError with the
    compiler's output if any build fails."""
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
        os.replace(tmp, path)  # atomic: a concurrent loader never sees a partial file
        results[name] = {"path": path, "seconds": seconds, "log": log}
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return results


def load_library(name: str) -> ctypes.CDLL:
    """The loaded ``csrc/<name>.cu`` library, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = build_libraries([name])[name]["path"]
            lib = _loaded[name] = ctypes.CDLL(str(path))
        return lib


def check_words(name: str, tensor: torch.Tensor, shape: tuple, device: torch.device) -> None:
    """A kernel input must be int32 (a u32 bit view) of ``shape`` on
    ``device``, contiguous and 16-byte aligned."""
    if tensor.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32 (u32 bit view), got {tensor.dtype}")
    if tuple(tensor.shape) != shape:
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(tensor.shape)}")
    if tensor.device != device:
        raise ValueError(f"{name}: tensors on {tensor.device} and {device}")
    if not tensor.is_contiguous() or tensor.data_ptr() % 16:
        raise ValueError(f"{name}: tensor must be contiguous and 16-byte aligned")


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
    n: int,
    device: torch.device,
    launches: "dict[str, int]",
) -> torch.Tensor:
    """Call the C entry ``name`` of ``csrc/<library>.cu`` with ``args`` plus
    a fresh int32 ``[n, 8]`` digest tensor and PyTorch's current stream,
    count the launch in ``launches``, and raise if the launch was refused.
    Does not synchronise."""
    out = torch.empty((n, 8), dtype=torch.int32, device=device)
    if n == 0:
        return out
    fn = getattr(load_library(library), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        rc = fn(*args, out.data_ptr(), stream)
    with _count_lock:
        launches[name] += 1
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
    return out
