"""Build and load the port's C extensions (raw CPython API), import-cycle-free.

The counterpart of ``ipc_proofs_tpu.core._cid_native``. It lives in
``core`` (stdlib-only imports) so :mod:`core.cid` can bind the native CID
type when it is imported, before any other module of the package holds the
pure-Python class; ``backend.native`` delegates here, so there is one build
and one loaded module per source.

Each source under ``backend/native/`` compiles with gcc into ``_build/``
beside the package (git-ignored), named by a hash of the source, the flags
and the host's CPU (`host_build_id`: a ``-march=native`` build moved to
another host must rebuild, not die of SIGILL). The compiler writes a temp
file that `publish_build` links into place only if no process got there
first, so processes building the same library at once each load a whole
one, and a library a process has mapped is never replaced under it (its
mapping would turn into a deleted file's). A failed build raises RuntimeError with
gcc's output; there is no pure-Python fallback except the one the user asks
for with ``IPC_PROOFS_NO_NATIVE=1``, read once per process at the first
load.
"""

from __future__ import annotations

import hashlib
import importlib.util
import os
import platform
import subprocess
import sysconfig
import threading
from pathlib import Path

__all__ = [
    "BUILD_DIR", "CFLAGS", "NATIVE_DIR", "build_cpython_ext", "host_build_id", "load",
    "publish_build",
]

_PKG = Path(__file__).resolve().parent.parent
NATIVE_DIR = _PKG / "backend" / "native"
BUILD_DIR = _PKG / "_build"
CFLAGS = ("-O3", "-shared", "-fPIC", "-pthread", "-march=native")

_lock = threading.Lock()
_cached: "object | None | bool" = False  # guarded-by: _lock; False = not loaded yet


def host_build_id() -> str:
    """Identity of the CPU a ``-march=native`` library is built for."""
    model = ""
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                if line.startswith("model name"):
                    model = line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    if not model:
        model = platform.processor() or "unknown"
    return hashlib.sha256(f"{platform.machine()}|{model}".encode()).hexdigest()[:16]


def publish_build(tmp: Path, path: Path) -> None:
    """Move a finished build ``tmp`` to ``path`` unless ``path`` exists.

    A hard link is atomic and fails on an existing name, so the first build
    to finish wins and later ones are dropped: a concurrent loader never
    sees a partial file, and a library already loaded somewhere keeps its
    inode."""
    try:
        os.link(tmp, path)
    except FileExistsError:
        pass
    finally:
        tmp.unlink(missing_ok=True)


def build_cpython_ext(src: Path, mod_name: str, build_dir: Path = BUILD_DIR):
    """Compile ``src`` (unless this source, these flags and this host's
    build exist) and import it as the extension module ``mod_name``, whose
    ``PyInit_<mod_name>`` the source defines. Raises RuntimeError with gcc's
    output when the build fails."""
    flags = (*CFLAGS, f"-I{sysconfig.get_paths()['include']}")
    key = hashlib.sha256(
        src.read_bytes() + " ".join(flags).encode() + host_build_id().encode()
    ).hexdigest()[:16]
    so = build_dir / f"{mod_name}-{key}.so"
    if not so.exists():
        build_dir.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = ["gcc", *flags, str(src), "-o", str(tmp)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        except FileNotFoundError as exc:
            raise RuntimeError(f"building {src.name} needs gcc: {exc}") from exc
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"gcc failed building {src.name} (exit {proc.returncode}):\n"
                f"{proc.stderr}{proc.stdout}"
            )
        publish_build(tmp, so)
    spec = importlib.util.spec_from_file_location(mod_name, so)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load():
    """The DAG-CBOR/CID extension ``ipc_torch_dagcbor_ext``, built at first
    use; None under ``IPC_PROOFS_NO_NATIVE=1``. A failed build raises."""
    global _cached
    with _lock:
        if _cached is False:
            _cached = (
                None
                if os.environ.get("IPC_PROOFS_NO_NATIVE")
                else build_cpython_ext(NATIVE_DIR / "dagcbor_ext.c", "ipc_torch_dagcbor_ext")
            )
        return _cached
