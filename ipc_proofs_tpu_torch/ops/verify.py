"""Batched multihash verification on the card: the cold read path's
integrity lane.

The counterpart of ``ipc_proofs_tpu.ops.verify_jax``. Every cold read path
re-hashes blocks before anything observes them (`store.rpc.verify_block_bytes`).
`verify_blocks_batch` takes one chunk's worth of blocks (a fetch-plane
landed wave, a segment-store multi-read, the disk sweep at open) and hashes
each multihash family in ONE backend call: blake2b-256 through
`GpuBackend.blake2b256_batch` (which splits by size class over the three
blake2b kernels) and keccak-256 through `GpuBackend.keccak256_batch` (the
single-block or the multi-block kernel by `keccak_class`). The reference
pads message counts and block counts to powers of two so that XLA compiles
a bounded set of shapes; the CUDA kernels take any shape, so no filler row
is hashed here.

Verdict contract: ``verify_blocks_batch(cids, blocks)[i]`` equals
``verify_block_bytes(cids[i], blocks[i])`` for every i, including the rule
that unknown multihash codes are accepted. Codes without a kernel
(sha2-256, identity, unknown) and sub-crossover batches take the scalar
lane, as in the reference. A kernel or launch fault raises: there is no
fallback that would let the scalar lane hide a broken card.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
import time
from typing import Optional, Sequence

import numpy as np

from ipc_proofs_tpu_torch.core.cid import BLAKE2B_256, CID, DAG_CBOR, IDENTITY, KECCAK_256, SHA2_256
from ipc_proofs_tpu_torch.core.hashes import blake2b_256, keccak256

__all__ = [
    "verify_blocks_batch",
    "batch_min_bytes",
    "autotune_crossover",
    "load_autotune",
    "SCALAR_ONLY_MIN_BYTES",
]

# Below this many payload bytes in one batch the scalar lane runs instead
# (verdicts are identical). The reference's value, kept until the port's
# benchmark measures one on the card; `autotune_crossover` measures it per
# host.
_DEFAULT_MIN_BYTES = 256 * 1024

# Autotuned crossover persisted per host under --store-dir. Its own file
# name: a JAX daemon and a card daemon sharing one --store-dir must not load
# each other's crossover. Resolution order in `batch_min_bytes`: env
# IPC_VERIFY_MIN_BYTES > loaded autotune record > `_DEFAULT_MIN_BYTES`.
_AUTOTUNE_FILE = "verify_autotune_cuda.json"
_AUTOTUNE_VERSION = 1

#: Sentinel crossover meaning "the device lane never beat hashlib on this
#: host": large enough that no real batch reaches it.
SCALAR_ONLY_MIN_BYTES = 1 << 62

_tuned_min_bytes: "int | None" = None


def batch_min_bytes() -> int:
    """Device-lane crossover in payload bytes.

    env IPC_VERIFY_MIN_BYTES > autotuned value (`autotune_crossover` /
    `load_autotune`) > built-in default.
    """
    env = os.environ.get("IPC_VERIFY_MIN_BYTES")
    if env is not None:
        try:
            return int(env)
        except ValueError:
            pass
    if _tuned_min_bytes is not None:
        return _tuned_min_bytes
    return _DEFAULT_MIN_BYTES


def _verify_one(cid: CID, data: bytes) -> bool:
    """Scalar verdict, the rules of `store.rpc.verify_block_bytes` (kept
    here without the import cycle; the differential tests pin equality)."""
    mh = cid.mh_code
    data = bytes(data)
    if mh == BLAKE2B_256:
        return blake2b_256(data) == cid.digest
    if mh == SHA2_256:
        return hashlib.sha256(data).digest() == cid.digest
    if mh == KECCAK_256:
        return keccak256(data) == cid.digest
    if mh == IDENTITY:
        return data == bytes(cid.digest)
    return True


def verify_blocks_batch(
    cids: Sequence[CID], blocks: Sequence[bytes], metrics=None, backend=None
) -> "list[bool]":
    """Batch form of `verify_block_bytes`: one verdict per (cid, block).

    blake2b-256 and keccak-256 blocks hash on ``backend`` (default the card,
    `get_backend("gpu")`, which raises without CUDA), one call per family,
    when the batch holds at least two of them and clears the crossover
    (`batch_min_bytes`); everything else verifies on the scalar lane.
    """
    if backend is None:
        from ipc_proofs_tpu_torch.backend import get_backend

        backend = get_backend("gpu")
    cids = list(cids)
    blocks = [bytes(b) for b in blocks]
    if len(cids) != len(blocks):
        raise ValueError(f"{len(cids)} cids vs {len(blocks)} blocks")
    n = len(cids)
    verdicts = [False] * n
    if metrics is not None:
        metrics.count("verify.batch_calls")
        metrics.count("verify.batch_blocks", n)
    if n == 0:
        return verdicts

    device_idx: "dict[int, list[int]]" = {BLAKE2B_256: [], KECCAK_256: []}
    scalar_idx: "list[int]" = []
    for i, cid in enumerate(cids):
        lane = device_idx.get(cid.mh_code)
        (lane if lane is not None else scalar_idx).append(i)

    batchable = device_idx[BLAKE2B_256] + device_idx[KECCAK_256]
    device_bytes = sum(len(blocks[i]) for i in batchable)
    if not (len(batchable) >= 2 and device_bytes >= batch_min_bytes()):
        scalar_idx.extend(batchable)
        device_idx = {}

    for code, idxs in device_idx.items():
        if not idxs:
            continue
        hasher = backend.blake2b256_batch if code == BLAKE2B_256 else backend.keccak256_batch
        digests = hasher([blocks[i] for i in idxs])
        for i, digest in zip(idxs, digests):
            verdicts[i] = digest == cids[i].digest
        if metrics is not None:
            metrics.count("verify.device_calls")
            metrics.count("verify.device_blocks", len(idxs))

    for i in scalar_idx:
        verdicts[i] = _verify_one(cids[i], blocks[i])
    if metrics is not None and scalar_idx:
        metrics.count("verify.scalar_blocks", len(scalar_idx))
    return verdicts


# --- per-host crossover autotuning ------------------------------------------
#
# `autotune_crossover` measures hashlib's C loop against the card's lane once
# per host, persists the crossover under --store-dir, and later processes on
# the host load the record instead of measuring again.


def load_autotune(store_dir: str) -> "int | None":
    """Load a persisted autotune record, activating its crossover.

    Returns the tuned min-bytes (possibly `SCALAR_ONLY_MIN_BYTES`) or None
    when no valid record exists: an unreadable or wrong-version record is
    treated as absent.
    """
    global _tuned_min_bytes
    path = os.path.join(store_dir, _AUTOTUNE_FILE)
    try:
        with open(path, "r", encoding="utf-8") as fh:
            record = json.load(fh)
        if record.get("version") != _AUTOTUNE_VERSION:
            return None
        min_bytes = int(record["min_bytes"])
    except (OSError, ValueError, TypeError, KeyError, AttributeError):  # fail-soft: a bad tuning record must never block a read path — the default crossover applies
        return None
    _tuned_min_bytes = min_bytes
    return min_bytes


def _autotune_fixture(payload_bytes: int, block_bytes: int = 1024):
    """Deterministic (cids, blocks) covering `payload_bytes` of blake2b
    blocks — the multihash family of every witness block in this repo."""
    n = max(2, payload_bytes // block_bytes)
    rng = np.random.default_rng(11)
    payload = rng.integers(0, 256, size=(n, block_bytes), dtype=np.uint8)
    blocks = [payload[i].tobytes() for i in range(n)]
    cids = [CID.hash_of(b, codec=DAG_CBOR, mh_code=BLAKE2B_256) for b in blocks]
    return cids, blocks


def _best_of(fn, reps: int = 3) -> float:
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def _device_lane_wall(cids, blocks, backend) -> float:
    """Best-of-3 wall of the device lane over (cids, blocks), warmed
    outside the timing. The digests come back to the host inside each run
    and are checked against the cids, so a lane that mis-hashes raises
    rather than winning the tuning."""

    def run():
        digests = backend.blake2b256_batch(blocks)
        if any(d != c.digest for d, c in zip(digests, cids)):
            raise RuntimeError("autotune fixture digest mismatch on the device lane")

    run()
    return _best_of(run)


def autotune_crossover(
    store_dir: Optional[str] = None, quick: bool = True, force: bool = False, backend=None
) -> dict:
    """One-shot per-host crossover measurement.

    Times the scalar hashlib loop against the device lane on ``backend``
    (default the card) over the same blake2b blocks at increasing batch
    payloads; the crossover is the smallest payload where the device lane
    wins, or `SCALAR_ONLY_MIN_BYTES` when it never does. With ``store_dir``
    the record persists as ``verify_autotune_cuda.json`` and later calls load
    it (``force=True`` measures again). A device fault raises. The active
    crossover updates either way; env IPC_VERIFY_MIN_BYTES still wins.
    """
    global _tuned_min_bytes
    if store_dir and not force:
        loaded = load_autotune(store_dir)
        if loaded is not None:
            with open(os.path.join(store_dir, _AUTOTUNE_FILE), "r", encoding="utf-8") as fh:
                return json.load(fh)
    if backend is None:
        from ipc_proofs_tpu_torch.backend import get_backend

        backend = get_backend("gpu")

    sizes = [64 * 1024, 256 * 1024, 1024 * 1024]
    if not quick:
        sizes.append(4 * 1024 * 1024)
    samples: "list[dict]" = []
    min_bytes = SCALAR_ONLY_MIN_BYTES
    scalar_only = True
    for payload in sizes:
        cids, blocks = _autotune_fixture(payload)
        t_scalar = _best_of(lambda: [_verify_one(c, b) for c, b in zip(cids, blocks)])
        t_device = _device_lane_wall(cids, blocks, backend)
        samples.append(
            {"payload_bytes": payload, "scalar_s": round(t_scalar, 6), "device_s": round(t_device, 6)}
        )
        if scalar_only and t_device <= t_scalar:
            min_bytes = payload
            scalar_only = False  # keep sampling: the record shows the whole curve

    record = {
        "version": _AUTOTUNE_VERSION,
        "min_bytes": min_bytes,
        "scalar_only": scalar_only,
        "samples": samples,
    }
    if store_dir:
        os.makedirs(store_dir, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=store_dir, prefix=_AUTOTUNE_FILE, suffix=".tmp")
        try:
            with os.fdopen(fd, "w", encoding="utf-8") as fh:
                json.dump(record, fh, indent=2, sort_keys=True)
            os.replace(tmp, os.path.join(store_dir, _AUTOTUNE_FILE))
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass  # best-effort temp cleanup on a failed persist
            raise
    _tuned_min_bytes = min_bytes
    return record
