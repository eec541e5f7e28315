"""Event predicate masks over flat event arrays.

The counterparts of ``ipc_proofs_tpu.ops.match_jax``:
``event_match_mask_jit`` (full topic words), ``event_match_mask_fp_jit``
(one u64 topic fingerprint per event) with its mesh branch
(`sharded_fp_mask_fn`: rows split over every mesh device), `pad_to_bucket`,
`receipts_with_match`, and ``backend/tpu.py``'s ``flatten_events``. The
full-word mask takes a mesh too, which the reference's does not: over an
RPC store or a tier (no raw map) the range scan is the Python walk, whose
mask is this one, so a mesh reaches that path only through it. The JAX
package leaves these elementwise compares to XLA outside any Pallas kernel;
here they are a few PyTorch tensor ops on the given device(s). The
``n_topics >= 2`` (fingerprint mask) and emitter predicates fold into
``valid`` on the host in numpy, as in the reference: actor IDs are u64.
There is no host crossover: on CUDA every non-empty mask runs on the card.
Without a mesh a mask has the input's length. With one, the fingerprint
mask has the padded length (the reference's contract: slice ``[:N]``); the
full-word mask splits its rows unevenly and keeps the input's length.
"""

from __future__ import annotations

import threading
from typing import Optional, Sequence

import numpy as np
import torch

from ipc_proofs_tpu_torch.state.events import StampedEvent, extract_evm_log

__all__ = [
    "LAUNCHES",
    "flatten_events",
    "event_match_mask_flat",
    "event_match_mask_fp",
    "event_match_mask",
    "pad_to_bucket",
    "receipts_with_match",
    "sharded_fp_mask_fn",
]

# mask evaluations that ran on a CUDA device since the last reset (the
# sharded masks: one per device block)
LAUNCHES = {
    "event_match_mask": 0,
    "event_match_mask_sharded": 0,
    "event_match_mask_fp": 0,
    "event_match_mask_fp_sharded": 0,
}
_count_lock = threading.Lock()


def _count(device: torch.device, name: str) -> None:
    if device.type == "cuda":
        with _count_lock:
            LAUNCHES[name] += 1


def pad_to_bucket(n: int, minimum: int = 256) -> int:
    """Round an event count up to a power-of-two bucket (at least
    ``minimum``): the sizes a mesh's padded dispatches take."""
    bucket = minimum
    while bucket < n:
        bucket *= 2
    return bucket


def receipts_with_match(mask: torch.Tensor, receipt_ids: torch.Tensor, num_receipts: int) -> torch.Tensor:
    """Per-receipt any-reduce: bool [N] event mask + integer [N] receipt ids
    → bool [num_receipts] (which receipts hold at least one matching
    event), on the mask's device: a scatter-add (`index_add_`), then
    ``> 0``. Every id must lie in ``[0, num_receipts)``."""
    hits = torch.zeros(num_receipts, dtype=torch.int32, device=mask.device)
    hits.index_add_(0, receipt_ids.to(device=mask.device, dtype=torch.int64), mask.to(torch.int32))
    return hits > 0


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


def _topic_mask(topics, n_topics, valid, topic0: bytes, topic1: bytes, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(topics).view(np.int32)).to(device)
    ok = torch.from_numpy(np.ascontiguousarray(valid)).to(device)
    nt = torch.from_numpy(np.ascontiguousarray(n_topics, dtype=np.int32)).to(device)
    return (
        ok
        & (nt >= 2)
        & (t[:, 0, :] == _words(topic0, device)).all(dim=-1)
        & (t[:, 1, :] == _words(topic1, device)).all(dim=-1)
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
        mask = _topic_mask(topics, n_topics, valid, topic0, topic1, device)
        _count(device, "event_match_mask")
        return mask.cpu().numpy()
    devices = mesh.devices
    blocks = []
    for dev, t, nt, ok in zip(
        devices, *(np.array_split(a, len(devices)) for a in (topics, n_topics, valid))
    ):
        if len(t):
            blocks.append(_topic_mask(t, nt, ok, topic0, topic1, dev))
            _count(dev, "event_match_mask_sharded")
    return np.concatenate([block.cpu().numpy() for block in blocks])


def _fp_mask(f: np.ndarray, valid: np.ndarray, target: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(valid).to(device) & (torch.from_numpy(f).to(device) == target)


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
                    blocks.append(_fp_mask(f[part], valid[part], target, device))
                    _count(device, "event_match_mask_fp_sharded")
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
    mask = _fp_mask(f, valid, target, device)
    _count(device, "event_match_mask_fp")
    return mask.cpu().numpy()


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
