"""Event predicate masks over flat event arrays.

The counterparts of ``ipc_proofs_tpu.ops.match_jax.event_match_mask_jit``
(full topic words), the single-device branch of its
``event_match_mask_fp_jit`` (one u64 topic fingerprint per event) and
``backend/tpu.py``'s ``flatten_events``. The JAX package leaves these
elementwise compares to XLA outside any Pallas kernel; here they are a few
PyTorch tensor ops on the given device. The ``n_topics >= 2`` (fingerprint
mask) and emitter predicates fold into ``valid`` on the host in numpy, as
in the reference: actor IDs are u64. There is no host crossover: on CUDA
every non-empty mask runs on the card.
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
]

# mask evaluations that ran on a CUDA device since the last reset
LAUNCHES = {"event_match_mask": 0, "event_match_mask_fp": 0}
_count_lock = threading.Lock()


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


def event_match_mask_flat(
    topics: np.ndarray,
    n_topics: np.ndarray,
    emitters: np.ndarray,
    valid: np.ndarray,
    topic0: bytes,
    topic1: bytes,
    actor_id_filter: Optional[int],
    device: "torch.device | str",
) -> np.ndarray:
    """Boolean [N] mask: event matches (topic0, topic1[, emitter]) exactly
    like ``EventMatcher.matches_log`` plus the actor filter."""
    device = torch.device(device)
    valid = np.asarray(valid, dtype=bool)
    if actor_id_filter is not None:
        valid = valid & (np.asarray(emitters) == actor_id_filter)
    if topics.shape[0] == 0:
        return np.zeros(0, dtype=bool)
    t = torch.from_numpy(np.ascontiguousarray(topics).view(np.int32)).to(device)
    ok = torch.from_numpy(valid).to(device)
    nt = torch.from_numpy(np.asarray(n_topics, dtype=np.int32)).to(device)
    mask = (
        ok
        & (nt >= 2)
        & (t[:, 0, :] == _words(topic0, device)).all(dim=-1)
        & (t[:, 1, :] == _words(topic1, device)).all(dim=-1)
    )
    if device.type == "cuda":
        with _count_lock:
            LAUNCHES["event_match_mask"] += 1
    return mask.cpu().numpy()


def event_match_mask_fp(
    fp: np.ndarray,
    n_topics: np.ndarray,
    emitters: np.ndarray,
    valid: np.ndarray,
    target_fp: int,
    actor_id_filter: Optional[int],
    device: "torch.device | str",
) -> np.ndarray:
    """Boolean [N] mask: event fingerprint equals ``target_fp`` (a u64,
    `proofs.scan_native.topic_fingerprint` of the two topics), the event is
    valid, has at least two topics and passes the actor filter. The u64s
    cross to the device as int64 bit patterns, whose equality is the u64's
    (CPU PyTorch has no uint64 compare)."""
    device = torch.device(device)
    valid = np.asarray(valid, dtype=bool) & (np.asarray(n_topics) >= 2)
    if actor_id_filter is not None:
        valid = valid & (np.asarray(emitters) == actor_id_filter)
    if fp.shape[0] == 0:
        return np.zeros(0, dtype=bool)
    f = torch.from_numpy(np.array(fp, dtype="<u8").view(np.int64)).to(device)
    target = int.from_bytes(int(target_fp).to_bytes(8, "little"), "little", signed=True)
    mask = torch.from_numpy(valid).to(device) & (f == target)
    if device.type == "cuda":
        with _count_lock:
            LAUNCHES["event_match_mask_fp"] += 1
    return mask.cpu().numpy()


def event_match_mask(
    events: Sequence[StampedEvent],
    topic0: bytes,
    topic1: bytes,
    actor_id_filter: Optional[int],
    device: "torch.device | str",
) -> list[bool]:
    if not events:
        return []
    topics, n_topics, emitters, valid = flatten_events(events)
    return event_match_mask_flat(
        topics, n_topics, emitters, valid, topic0, topic1, actor_id_filter, device
    ).tolist()
