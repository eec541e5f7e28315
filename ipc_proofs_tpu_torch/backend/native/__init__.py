"""Loaders of the port's host C extensions.

The counterpart of ``ipc_proofs_tpu.backend.native`` without its C++ batch
hasher (``hashes.cpp``, ``load_native``): blake2b and keccak run on the
card's kernels (``backend/gpu.py``). Both modules build from the sources
beside this file through `core._cid_native.build_cpython_ext` (raising on a
failed build) and are None only under ``IPC_PROOFS_NO_NATIVE=1``, the
pure-Python universe.

- ``ipc_torch_dagcbor_ext`` (``dagcbor_ext.c``): the C DAG-CBOR decoder and
  the native CID type that `core.cid` binds as ``CID``;
- ``ipc_torch_scan_ext`` (``scan_ext.c``): the receipts/events scanner, the
  batched exec-order, pass-2 and HAMT walkers, witness materialization.
"""

from __future__ import annotations

import threading

from ipc_proofs_tpu_torch.core import _cid_native

__all__ = ["load_dagcbor_ext", "load_scan_ext"]

_lock = threading.Lock()
_scan_cached: "object | None | bool" = False  # guarded-by: _lock; False = not loaded yet


def load_dagcbor_ext():
    """The DAG-CBOR/CID extension module (one build cache with `core.cid`,
    which binds its CID type), or None under ``IPC_PROOFS_NO_NATIVE=1``."""
    return _cid_native.load()


def load_scan_ext():
    """The native scanner module, built at first use, or None in the
    pure-Python universe, which `core._cid_native.load` alone decides (so
    the CID type and the scanner always come from the same universe). A
    failed build raises."""
    global _scan_cached
    with _lock:
        if _scan_cached is False:
            _scan_cached = (
                None
                if _cid_native.load() is None
                else _cid_native.build_cpython_ext(
                    _cid_native.NATIVE_DIR / "scan_ext.c", "ipc_torch_scan_ext"
                )
            )
        return _scan_cached
