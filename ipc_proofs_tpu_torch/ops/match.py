"""Event predicate masks over flat event arrays: the CUDA kernels'
wrappers and plain versions.

The counterparts of ``ipc_proofs_tpu.ops.match_jax``:
``event_match_mask_jit`` (full topic words), ``event_match_mask_fp_jit``
(one u64 topic fingerprint per event) with its mesh branch
(`sharded_fp_mask_fn`: rows split over every mesh device), `pad_to_bucket`,
`receipts_with_match`, and ``backend/tpu.py``'s ``flatten_events``. The
full-word mask takes a mesh too, which the reference's does not: over an
RPC store or a tier (no raw map) the range scan is the Python walk, whose
mask is this one, so a mesh reaches that path only through it.

The JAX package jit-compiles these compares and the receipt reduction
(XLA fuses each into device code); here each is a hand-written kernel of
``csrc/match.cu``, wrapped by a tensor function with its plain PyTorch
version beside it:

=======================  ==============================================  =========================
wrapper                  replaces (TPU device function)                  plain version
=======================  ==============================================  =========================
`topic_mask`             ``ops/match_jax.py:36`` ``_match_mask_topics``  `topic_mask_plain`
`fp_mask`                ``ops/match_jax.py:76-81`` ``_match_mask_fp``   `fp_mask_plain`
`receipts_with_match`    ``ops/match_jax.py:137``                        `receipts_with_match_plain`
=======================  ==============================================  =========================

A wrapper launches its kernel for CUDA tensors (counting the launch in
`LAUNCHES`) and runs the plain version only for CPU tensors; any other
device raises, and a kernel that cannot be built or launched raises
`ops.build.DeviceFaultError` (nothing falls back). What bounds the kernels
and how their design answers it is set out at the top of ``csrc/match.cu``.

The ``n_topics >= 2`` (fingerprint mask) and emitter predicates fold into
``valid`` on the host in numpy, as in the reference: actor IDs are u64.
There is no host crossover: on CUDA every non-empty mask runs on the card.
Without a mesh a mask has the input's length. With one, the fingerprint
mask has the padded length (the reference's contract: slice ``[:N]``); the
full-word mask splits its rows unevenly and keeps the input's length.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Sequence

import numpy as np
import torch

from ipc_proofs_tpu_torch.ops.build import check_tensor, launch, reset_counts, runs_plain
from ipc_proofs_tpu_torch.state.events import StampedEvent, extract_evm_log

__all__ = [
    "LAUNCHES",
    "reset_launch_counts",
    "flatten_events",
    "event_match_mask_flat",
    "event_match_mask_fp",
    "event_match_mask",
    "pad_to_bucket",
    "receipts_with_match",
    "receipts_with_match_plain",
    "sharded_fp_mask_fn",
    "topic_mask",
    "topic_mask_plain",
    "fp_mask",
    "fp_mask_plain",
]

# kernel launches since the last reset, bumped only where a wrapper launches
# its kernel (the sharded masks: one per device block)
LAUNCHES = {
    "event_match_mask": 0,
    "event_match_mask_sharded": 0,
    "event_match_mask_fp": 0,
    "event_match_mask_fp_sharded": 0,
    "receipts_with_match": 0,
}

# the C entries' signatures (`parallel.pipeline` keeps `match_pipeline`'s)
_ARGTYPES = {
    "event_match_mask": [ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_void_p] * 2,
    "event_match_mask_fp": [ctypes.c_void_p] * 2
    + [ctypes.c_longlong, ctypes.c_longlong]
    + [ctypes.c_void_p] * 2,
    "receipts_with_match": [ctypes.c_void_p] * 2
    + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int]
    + [ctypes.c_void_p] * 2,
}


def reset_launch_counts() -> None:
    reset_counts(LAUNCHES)


def _launch(
    name: str, args: list, outputs: "list[torch.Tensor]", device: torch.device, count_as: str
) -> None:
    """`ops.build.launch` of the ``csrc/match.cu`` entry ``name``."""
    launch("match", name, _ARGTYPES[name], args, outputs, device, LAUNCHES, count_as)


def pad_to_bucket(n: int, minimum: int = 256) -> int:
    """Round an event count up to a power-of-two bucket (at least
    ``minimum``): the sizes a mesh's padded dispatches take."""
    bucket = minimum
    while bucket < n:
        bucket *= 2
    return bucket


def receipts_with_match_plain(
    mask: torch.Tensor, receipt_ids: torch.Tensor, num_receipts: int
) -> torch.Tensor:
    """Plain version of `receipts_with_match`."""
    ids = receipt_ids.to(torch.int64)
    ids = torch.where(ids < 0, ids + num_receipts, ids)
    keep = mask & (ids >= 0) & (ids < num_receipts)
    hits = torch.zeros(num_receipts, dtype=torch.bool, device=mask.device)
    hits[ids[keep]] = True
    return hits


def receipts_with_match(mask: torch.Tensor, receipt_ids: torch.Tensor, num_receipts: int) -> torch.Tensor:
    """Per-receipt any-reduce: bool [N] event mask + int32/int64 [N] receipt
    ids → bool [num_receipts] (which receipts hold at least one matching
    event), on the mask's device. As the reference's ``.at[ids].add``: an
    id in ``[-num_receipts, 0)`` wraps to ``id + num_receipts``, and any
    other id outside ``[0, num_receipts)`` is dropped."""
    name = "receipts_with_match"
    device = mask.device
    if mask.dim() != 1:
        raise ValueError(f"{name}: expected a mask [N], got {tuple(mask.shape)}")
    n = mask.shape[0]
    ids = receipt_ids.to(device)
    if ids.dtype not in (torch.int32, torch.int64):
        ids = ids.to(torch.int64)
    check_tensor(name, mask, torch.bool, (n,), device)
    check_tensor(name, ids, ids.dtype, (n,), device)
    if num_receipts < 0:
        raise ValueError(f"{name}: num_receipts {num_receipts} < 0")
    if runs_plain(name, device):
        return receipts_with_match_plain(mask, ids, num_receipts)
    hits = torch.empty(num_receipts, dtype=torch.bool, device=device)
    if n == 0 or num_receipts == 0:
        return hits.zero_()
    args = [mask.data_ptr(), ids.data_ptr(), n, num_receipts, ids.element_size()]
    _launch(name, args, [hits], device, name)
    return hits


def flatten_events(events: Sequence[StampedEvent]):
    """Host-side flattener: events → (topics u32[N,2,8], n_topics i32[N],
    emitters i64[N], valid bool[N]).

    ``valid`` is False for events that are not EVM-log shaped (no topics /
    malformed sizes), mirroring `extract_evm_log`'s rejections.
    """
    n = len(events)
    topics = np.zeros((n, 2, 8), dtype=np.uint32)
    n_topics = np.zeros(n, dtype=np.int32)
    emitters = np.zeros(n, dtype=np.int64)
    valid = np.zeros(n, dtype=bool)
    for i, stamped in enumerate(events):
        emitters[i] = stamped.emitter
        log = extract_evm_log(stamped.event)
        if log is None:
            continue
        valid[i] = True
        n_topics[i] = len(log.topics)
        for j, topic in enumerate(log.topics[:2]):
            topics[i, j] = np.frombuffer(topic, dtype="<u4")
    return topics, n_topics, emitters, valid


def _words(topic: bytes, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.frombuffer(topic, dtype="<i4").copy()).to(device)


def topic_mask_plain(topics, n_topics, valid, topic0, topic1) -> torch.Tensor:
    """Plain version of `topic_mask`."""
    return (
        valid
        & (n_topics >= 2)
        & (topics[:, 0, :] == topic0).all(dim=-1)
        & (topics[:, 1, :] == topic1).all(dim=-1)
    )


def topic_mask(topics, n_topics, valid, topic0, topic1, count_as: str = "event_match_mask") -> torch.Tensor:
    """The full-word mask on tensors: int32 [N, 2, 8] topic words, int32 [N]
    n_topics, bool [N] valid, int32 [8] spec words each → bool [N]
    (``valid & n_topics >= 2 & topic0 == spec0 & topic1 == spec1``). A
    launch counts in ``LAUNCHES[count_as]``."""
    name = "event_match_mask"
    device = topics.device
    n = topics.shape[0]
    check_tensor(name, topics, torch.int32, (n, 2, 8), device, align=16)
    check_tensor(name, n_topics, torch.int32, (n,), device)
    check_tensor(name, valid, torch.bool, (n,), device)
    check_tensor(name, topic0, torch.int32, (8,), device)
    check_tensor(name, topic1, torch.int32, (8,), device)
    if runs_plain(name, device):
        return topic_mask_plain(topics, n_topics, valid, topic0, topic1)
    mask = torch.empty(n, dtype=torch.bool, device=device)
    if n:
        args = [t.data_ptr() for t in (topics, n_topics, valid, topic0, topic1)] + [n]
        _launch(name, args, [mask], device, count_as)
    return mask


def _topic_mask(
    topics, n_topics, valid, topic0: bytes, topic1: bytes, device: torch.device,
    count_as: str = "event_match_mask",
) -> torch.Tensor:
    """`topic_mask` of host arrays, copied to ``device``."""
    return topic_mask(
        torch.from_numpy(np.ascontiguousarray(topics).view(np.int32)).to(device),
        torch.from_numpy(np.ascontiguousarray(n_topics, dtype=np.int32)).to(device),
        torch.from_numpy(np.ascontiguousarray(valid)).to(device),
        _words(topic0, device),
        _words(topic1, device),
        count_as,
    )


def event_match_mask_flat(
    topics: np.ndarray,
    n_topics: np.ndarray,
    emitters: np.ndarray,
    valid: np.ndarray,
    topic0: bytes,
    topic1: bytes,
    actor_id_filter: Optional[int],
    device: "torch.device | str",
    mesh=None,
) -> np.ndarray:
    """Boolean [N] mask: event matches (topic0, topic1[, emitter]) exactly
    like ``EventMatcher.matches_log`` plus the actor filter.

    With a `parallel.mesh.Mesh` the rows split into one contiguous block
    per mesh device (`np.array_split`: an eager mask needs no even split,
    so nothing pads), each block is compared on its device, and the blocks
    concatenate back in order; the mask keeps N rows."""
    device = torch.device(device)
    valid = np.asarray(valid, dtype=bool)
    if actor_id_filter is not None:
        valid = valid & (np.asarray(emitters) == actor_id_filter)
    if topics.shape[0] == 0:
        return np.zeros(0, dtype=bool)
    if mesh is None:
        return _topic_mask(topics, n_topics, valid, topic0, topic1, device).cpu().numpy()
    devices = mesh.devices
    blocks = []
    for dev, t, nt, ok in zip(
        devices, *(np.array_split(a, len(devices)) for a in (topics, n_topics, valid))
    ):
        if len(t):
            blocks.append(_topic_mask(t, nt, ok, topic0, topic1, dev, "event_match_mask_sharded"))
    return np.concatenate([block.cpu().numpy() for block in blocks])


def fp_mask_plain(f: torch.Tensor, valid: torch.Tensor, target: int) -> torch.Tensor:
    """Plain version of `fp_mask`."""
    return valid & (f == target)


def fp_mask(f: torch.Tensor, valid: torch.Tensor, target: int, count_as: str = "event_match_mask_fp") -> torch.Tensor:
    """The fingerprint mask on tensors: int64 [N] fingerprints (u64 bit
    patterns), bool [N] valid and the target as the int64 with the u64's
    bits → bool [N] (``valid & f == target``). A launch counts in
    ``LAUNCHES[count_as]``."""
    name = "event_match_mask_fp"
    device = f.device
    n = f.shape[0]
    check_tensor(name, f, torch.int64, (n,), device)
    check_tensor(name, valid, torch.bool, (n,), device)
    if runs_plain(name, device):
        return fp_mask_plain(f, valid, target)
    mask = torch.empty(n, dtype=torch.bool, device=device)
    if n:
        _launch(name, [f.data_ptr(), valid.data_ptr(), n, target], [mask], device, count_as)
    return mask


def _fp_mask(
    f: np.ndarray, valid: np.ndarray, target: int, device: torch.device,
    count_as: str = "event_match_mask_fp",
) -> torch.Tensor:
    """`fp_mask` of host arrays, copied to ``device``."""
    return fp_mask(
        torch.from_numpy(np.ascontiguousarray(f)).to(device),
        torch.from_numpy(np.ascontiguousarray(valid)).to(device),
        target,
        count_as,
    )


_sharded_fp_cache: dict = {}
_sharded_fp_lock = threading.Lock()


def sharded_fp_mask_fn(mesh):
    """The fingerprint mask over a device mesh: ``fn(f, valid, target)``
    splits the int64 [N] fingerprints and bool [N] valid rows into one
    contiguous block per mesh device (row-major over dp × sp: the match is
    embarrassingly parallel over events), compares each block on its
    device with the replicated target, and concatenates the blocks back in
    order into a numpy bool [N]. N must divide by the mesh's device count.
    Cached per mesh."""
    with _sharded_fp_lock:
        fn = _sharded_fp_cache.get(mesh)
        if fn is None:
            devices = mesh.devices

            def fn(f: np.ndarray, valid: np.ndarray, target: int) -> np.ndarray:
                n = f.shape[0]
                if n % len(devices):
                    raise ValueError(f"{n} rows do not split over {len(devices)} mesh devices")
                rows = n // len(devices)
                blocks = []
                for b, device in enumerate(devices):
                    part = slice(b * rows, (b + 1) * rows)
                    blocks.append(
                        _fp_mask(f[part], valid[part], target, device, "event_match_mask_fp_sharded")
                    )
                return np.concatenate([block.cpu().numpy() for block in blocks])

            _sharded_fp_cache[mesh] = fn
    return fn


def event_match_mask_fp(
    fp: np.ndarray,
    n_topics: np.ndarray,
    emitters: np.ndarray,
    valid: np.ndarray,
    target_fp: int,
    actor_id_filter: Optional[int],
    device: "torch.device | str",
    mesh=None,
) -> np.ndarray:
    """Boolean mask: event fingerprint equals ``target_fp`` (a u64,
    `proofs.scan_native.topic_fingerprint` of the two topics), the event is
    valid, has at least two topics and passes the actor filter. The u64s
    cross to the device as int64 bit patterns, whose equality is the u64's
    (CPU PyTorch has no uint64 compare).

    Without ``mesh`` the mask runs on ``device`` and has N rows. With a
    `parallel.mesh.Mesh` the rows pad with valid=False filler to
    `pad_to_bucket` rounded up to a multiple of the mesh's size and run
    sharded (`sharded_fp_mask_fn`); the mask has the padded length."""
    device = torch.device(device)
    valid = np.asarray(valid, dtype=bool) & (np.asarray(n_topics) >= 2)
    if actor_id_filter is not None:
        valid = valid & (np.asarray(emitters) == actor_id_filter)
    n = fp.shape[0]
    f = np.array(fp, dtype="<u8").view(np.int64)
    target = int.from_bytes(int(target_fp).to_bytes(8, "little"), "little", signed=True)
    if mesh is not None:
        bucket = pad_to_bucket(n)
        bucket += (-bucket) % mesh.size  # rows must split evenly across every device
        if bucket != n:
            f = np.concatenate([f, np.zeros(bucket - n, f.dtype)])
            valid = np.concatenate([valid, np.zeros(bucket - n, bool)])
        return sharded_fp_mask_fn(mesh)(f, valid, target)
    if n == 0:
        return np.zeros(0, dtype=bool)
    return _fp_mask(f, valid, target, device).cpu().numpy()


def event_match_mask(
    events: Sequence[StampedEvent],
    topic0: bytes,
    topic1: bytes,
    actor_id_filter: Optional[int],
    device: "torch.device | str",
    mesh=None,
) -> list[bool]:
    if not events:
        return []
    topics, n_topics, emitters, valid = flatten_events(events)
    return event_match_mask_flat(
        topics, n_topics, emitters, valid, topic0, topic1, actor_id_filter, device, mesh=mesh
    ).tolist()
