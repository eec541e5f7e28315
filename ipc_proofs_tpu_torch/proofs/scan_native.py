"""Native Phase-A scan: receipts+events decoded straight into flat tensors.

The pure-Python pass 1 (`event_generator.scan_receipt_events` +
`ops.match.flatten_events`) materializes a Python object per receipt,
event, and entry; at north-star scale (BASELINE.json config 2: 4096 tipsets,
~262k events) host prep dwarfs the device mask. This wrapper drives the C
scanner (`backend/native/scan_ext.c`) which walks the raw IPLD blocks and
fills the padded arrays the match kernel consumes directly.

Parity anchor: same traversal as reference pass 1
(`src/proofs/events/generator.rs:206-239`) minus recording — pass 1 is
deliberately witness-free in both designs.

The counterpart of ``ipc_proofs_tpu.proofs.scan_native``, over the port's
own ``ipc_torch_scan_ext``. Every entry returns None only in the
``IPC_PROOFS_NO_NATIVE=1`` universe, where callers take the pure-Python
paths.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from ipc_proofs_tpu_torch.core.cid import CID
from ipc_proofs_tpu_torch.store.blockstore import (
    Blockstore,
    CachedBlockstore,
    MemoryBlockstore,
)

__all__ = [
    "ScanBatch",
    "RecordBatch",
    "scan_events_flat",
    "scan_match_hits",
    "record_receipt_paths",
    "native_scan_available",
    "topic_fingerprint",
    "match_mask_flat_np",
    "match_mask_fp_np",
    "split_pooled",
]


def split_pooled(pool: bytes, off, ln) -> list[bytes]:
    """Materialize every item of a pooled (pool, i32 offsets, i32 lengths)
    walker output as bytes in one C call. ``off``/``ln`` may be byte
    buffers or little-endian i32 numpy arrays."""
    from ipc_proofs_tpu_torch.backend.native import load_scan_ext

    off_b = off.tobytes() if isinstance(off, np.ndarray) else off
    ln_b = ln.tobytes() if isinstance(ln, np.ndarray) else ln
    return load_scan_ext().split_pool(pool, off_b, ln_b)


_FP_SEED = 0x9E3779B97F4A7C15
_FP_MULT = 0xFF51AFD7ED558CCD
_U64 = (1 << 64) - 1


def topic_fingerprint(topic0: bytes, topic1: bytes) -> int:
    """64-bit mix over the zero-padded 2×32-byte topic words — the target
    value for the transfer-light device match (must equal the C scanner's
    per-event ``fp``). Word-wise (8×u64 LE) rather than byte-wise: the C
    side computes this once per scanned event, and a byte-serial FNV's
    64-multiply dependency chain was the scan's hottest instruction path.
    A fingerprint equality is confirmed exactly in pass 2, which re-applies
    the full matcher per event, so a (2^-64-rare) collision can only add an
    unused witness path, never a wrong claim."""
    buf = (topic0 + b"\x00" * 32)[:32] + (topic1 + b"\x00" * 32)[:32]
    fp = _FP_SEED
    for k in range(8):
        word = int.from_bytes(buf[8 * k : 8 * k + 8], "little")
        fp = ((fp ^ word) * _FP_MULT) & _U64
        fp ^= fp >> 29
    return fp


def match_mask_flat_np(
    topics: np.ndarray,
    n_topics: np.ndarray,
    emitters: np.ndarray,
    valid: np.ndarray,
    topic0: bytes,
    topic1: bytes,
    actor_id_filter: "Optional[int]",
) -> np.ndarray:
    """THE host match predicate over flat scanner arrays: pass 2's claim
    mask and the reference the card's masks are tested against (the C
    fused-match walk mirrors it via the fp formulation; pass 2 confirms hits
    exactly)."""
    t0 = np.frombuffer(topic0, dtype="<u4")
    t1 = np.frombuffer(topic1, dtype="<u4")
    mask = (
        valid
        & (n_topics >= 2)
        & (topics[:, 0, :] == t0).all(axis=1)
        & (topics[:, 1, :] == t1).all(axis=1)
    )
    if actor_id_filter is not None:
        mask = mask & (emitters == actor_id_filter)
    return mask


def match_mask_fp_np(
    fp: np.ndarray,
    n_topics: np.ndarray,
    emitters: np.ndarray,
    valid: np.ndarray,
    topic0: bytes,
    topic1: bytes,
    actor_id_filter: "Optional[int]",
) -> np.ndarray:
    """Fingerprint formulation of :func:`match_mask_flat_np` (one u64
    compare per event; pass 2 confirms every hit exactly): the host
    reference of ``GpuBackend.event_match_mask_fp``."""
    target = topic_fingerprint(topic0, topic1)
    mask = valid & (np.asarray(n_topics) >= 2) & (fp == target)
    if actor_id_filter is not None:
        mask = mask & (np.asarray(emitters) == actor_id_filter)
    return mask


@dataclass
class ScanBatch:
    """Flat arrays over every event of every receipt of every scanned root."""

    topics: np.ndarray  # uint32 [N, 2, 8] — first two topics as LE u32 words
    fp: np.ndarray  # uint64 [N] — topic_fingerprint (word-wise u64 mix)
    n_topics: np.ndarray  # int32 [N] — total topic count (may exceed 2)
    emitters: np.ndarray  # uint64 [N]
    valid: np.ndarray  # bool [N] — EVM-log shaped (extract_evm_log parity)
    pair_ids: np.ndarray  # int32 [N] — which root (position in `roots`)
    exec_idx: np.ndarray  # int32 [N] — receipt index == execution index
    event_idx: np.ndarray  # int32 [N] — index within the receipt's events AMT
    n_receipts: int  # receipts with an events root, across all roots
    # payload mode (verification): full topics/data bytes, pooled
    topics_pool: bytes = b""
    data_pool: bytes = b""
    topics_off: Optional[np.ndarray] = None  # uint32 [N]
    data_off: Optional[np.ndarray] = None  # uint32 [N]
    data_len: Optional[np.ndarray] = None  # uint32 [N]

    @property
    def n_events(self) -> int:
        return len(self.n_topics)

    def event_topics(self, row: int) -> bytes:
        """Full concatenated topics bytes of event ``row`` (payload mode)."""
        start = int(self.topics_off[row])
        return self.topics_pool[start : start + 32 * int(self.n_topics[row])]

    def event_data(self, row: int) -> bytes:
        start = int(self.data_off[row])
        return self.data_pool[start : start + int(self.data_len[row])]


def native_scan_available() -> bool:
    from ipc_proofs_tpu_torch.backend.native import load_scan_ext

    return load_scan_ext() is not None


def has_raw_map(store: Blockstore) -> bool:
    """True when the store can expose a raw dict for C-side lookups — i.e.
    the native scan runs without per-block Python fallback calls."""
    if isinstance(store, MemoryBlockstore):
        return True
    if isinstance(store, CachedBlockstore):
        return has_raw_map(store._inner)
    return False


def _raw_view(store: Blockstore):
    """(raw_dict, fallback_callable) for the C scanner's block access."""
    if isinstance(store, MemoryBlockstore):
        return store._raw_readonly(), None
    if isinstance(store, CachedBlockstore):
        inner_raw, inner_fallback = _raw_view(store._inner)
        if inner_fallback is None:
            return inner_raw, None

    def fallback(cid_bytes: bytes):
        return store.get(CID.from_bytes(cid_bytes))

    return {}, fallback


def _snapshot_of(store: Blockstore, raw: dict, work: "Optional[int]" = None):
    """Persistent C probe table over ``raw``, cached on the owning
    MemoryBlockstore and invalidated by the store's MUTATION COUNTER (not
    dict size — a put_keyed overwrite with different bytes leaves len()
    unchanged but must never be served stale). At range scale the per-call
    transient build costs about as much as the probe savings it buys
    (~100k blocks ≈ milliseconds) — reusing one table across every native
    walk of a pipeline pass removes that entirely. Safe by construction:
    content-addressed stores only ever ADD blocks, so hits on a stale
    table stay valid (entries hold strong refs) and misses fall through to
    the live dict probe inside the C walker.

    ``work`` (roots/keys/blocks the caller is about to touch) gates the
    BUILD: a fresh cached table is always returned (free), but a tiny walk
    over a huge un-snapshotted store keeps the legacy path rather than
    paying an O(|store|) build — mirroring the C side's snapshot_pays.
    Returns None (the transient path) in the pure-Python universe, when
    the store is not memory-backed, or with IPC_SCAN_NO_SNAPSHOT=1 (the C
    scanner then also ignores provided snapshots: the differential knob).
    """
    if os.environ.get("IPC_SCAN_NO_SNAPSHOT") == "1":
        return None
    owner = store
    while isinstance(owner, CachedBlockstore):
        owner = owner._inner
    if not isinstance(owner, MemoryBlockstore) or owner._raw_readonly() is not raw:
        return None
    from ipc_proofs_tpu_torch.backend.native import load_scan_ext

    ext = load_scan_ext()
    if ext is None:
        return None
    version = owner._mutations
    cached = getattr(owner, "_scan_snapshot", None)
    if cached is not None and cached[0] == version:
        return cached[1]
    if work is not None and (work < 64 or len(raw) > 256 * work):
        return None  # build would cost more than the probes it replaces
    # serialize builds PER STORE: the pipelined driver's scan worker and the
    # record phase can race here, and a duplicate O(|store|) build is exactly
    # the cost this cache exists to remove — but builds for *different*
    # stores are independent and must not serialize on one module-global
    # lock
    with owner._snapshot_lock:
        cached = getattr(owner, "_scan_snapshot", None)
        if cached is not None and cached[0] == version:
            return cached[1]
        snap = ext.make_snapshot(raw)
        owner._scan_snapshot = (version, snap)
    return snap


def _snap_kw(store: Blockstore, raw: dict, work: "Optional[int]" = None) -> dict:
    """``{"snapshot": snap}``, or ``{}`` when there is no snapshot (the C
    walkers then probe the live dict)."""
    snap = _snapshot_of(store, raw, work)
    return {"snapshot": snap} if snap is not None else {}


@dataclass
class RecordBatch:
    """Native pass-2 output: payload-mode event arrays over every event of
    every WANTED receipt, plus the touched-block witness per group."""

    batch: ScanBatch
    failed: np.ndarray  # bool [n_groups]
    _touch_pool: bytes
    _touch_off: np.ndarray
    _touch_len: np.ndarray
    _touch_goff: np.ndarray
    _touch_items: "Optional[list[bytes]]" = None  # lazy one-call split

    def touched(self, group: int) -> list[bytes]:
        """Raw CID bytes of every block pass 2 fetched for ``group``
        (receipts-AMT root + targeted paths + full events-AMT walks)."""
        if self._touch_items is None:
            self._touch_items = split_pooled(
                self._touch_pool, self._touch_off, self._touch_len
            )
        lo, hi = int(self._touch_goff[group]), int(self._touch_goff[group + 1])
        return self._touch_items[lo:hi]

    def all_touched(self) -> "list[bytes]":
        """Every group's touched blocks as ONE list (failed groups' spans
        are truncated in C, so this is the union over successful groups) —
        callers whose groups ALL succeeded skip the per-group slicing."""
        if self._touch_items is None:
            self._touch_items = split_pooled(
                self._touch_pool, self._touch_off, self._touch_len
            )
        return self._touch_items

    def row_offsets(self, n_groups: int) -> np.ndarray:
        """Group row boundaries into ``batch`` as one [n_groups+1] array
        (rows are emitted in ascending group order): group g's events are
        rows [out[g], out[g+1])."""
        return np.searchsorted(self.batch.pair_ids, np.arange(n_groups + 1))


def record_receipt_paths(
    store: Blockstore,
    receipts_roots: Sequence[CID],
    wanted: Sequence[Sequence[int]],
) -> Optional[RecordBatch]:
    """Batched PASS 2 (native): for each (receipts root, wanted receipt
    indices) group, walk the receipts-AMT path to each wanted index and the
    full events AMT beneath it, recording every touched block. Returns None
    when the extension is unavailable (callers use the scalar pass 2).
    Per-group failures (missing/malformed blocks) set ``failed[g]``; callers
    redo those groups scalar so errors surface identically.

    Scalar parity anchor: `event_generator.record_matching_receipts`
    (reference `src/proofs/events/generator.rs:241-301`).
    """
    from ipc_proofs_tpu_torch.backend.native import load_scan_ext

    ext = load_scan_ext()
    if ext is None:
        return None
    raw, fallback = _raw_view(store)
    out = ext.record_receipt_paths(
        raw,
        [c.to_bytes() for c in receipts_roots],
        [list(map(int, w)) for w in wanted],
        fallback,
        **_snap_kw(store, raw, len(receipts_roots)),
    )
    n = out["n_events"]
    batch = ScanBatch(
        topics=np.frombuffer(out["topics"], dtype="<u4").reshape(n, 2, 8),
        fp=np.frombuffer(out["fp"], dtype="<u8"),
        n_topics=np.frombuffer(out["n_topics"], dtype="<i4"),
        emitters=np.frombuffer(out["emitters"], dtype="<u8"),
        valid=np.frombuffer(out["valid"], dtype=np.uint8).astype(bool),
        pair_ids=np.frombuffer(out["pair_ids"], dtype="<i4"),
        exec_idx=np.frombuffer(out["exec_idx"], dtype="<i4"),
        event_idx=np.frombuffer(out["event_idx"], dtype="<i4"),
        n_receipts=out["n_receipts"],
        topics_pool=out["topics_pool"],
        data_pool=out["data_pool"],
        topics_off=np.frombuffer(out["topics_off"], dtype="<u4"),
        data_off=np.frombuffer(out["data_off"], dtype="<u4"),
        data_len=np.frombuffer(out["data_len"], dtype="<u4"),
    )
    return RecordBatch(
        batch=batch,
        failed=np.frombuffer(out["failed"], dtype=np.uint8).astype(bool),
        _touch_pool=out["touch_pool"],
        _touch_off=np.frombuffer(out["touch_off"], dtype="<i4"),
        _touch_len=np.frombuffer(out["touch_len"], dtype="<i4"),
        _touch_goff=np.frombuffer(out["touch_goff"], dtype="<i4"),
    )


def scan_match_hits(
    store: Blockstore,
    receipts_roots: Sequence[CID],
    topic0: bytes,
    topic1: bytes,
    actor_id_filter: "Optional[int]",
    threads: "Optional[int]" = None,
) -> "Optional[tuple[int, np.ndarray, np.ndarray]]":
    """Fused Phase A+B: ONE C walk scans every receipts AMT AND evaluates
    the fp match predicate per event in-register, returning
    ``(n_events, hit_pair_ids, hit_exec_idx)`` — no per-event columns cross
    the C boundary at all (the unfused path materializes ~100 B/event; the
    north-star range is ~25 MB of arrays whose only consumer is one
    vectorized compare). Predicate is exactly
    ``GpuBackend.event_match_mask_fp``'s; pass 2 confirms every hit,
    so fp collisions can only add an unused witness path, never a claim.

    Hits are emitted in walk order — (pair, exec, event) ascending — so
    duplicate (pair, exec) rows from multiple matching events in one
    receipt are adjacent. Returns None when the extension is unavailable.
    ``threads`` caps the call's pthread fan-out (the caller's share of the
    process thread budget, `utils.threads`); None keeps the default.
    """
    from ipc_proofs_tpu_torch.backend.native import load_scan_ext

    ext = load_scan_ext()
    if ext is None:
        return None
    raw, fallback = _raw_view(store)
    out = ext.scan_events_batch(
        raw,
        [c.to_bytes() for c in receipts_roots],
        fallback,
        match_fp=topic_fingerprint(topic0, topic1),
        match_actor=actor_id_filter,
        **_snap_kw(store, raw, len(receipts_roots)),
        threads=threads,
    )
    return (
        out["n_events"],
        np.frombuffer(out["hit_pairs"], dtype="<i4"),
        np.frombuffer(out["hit_exec"], dtype="<i4"),
    )


def scan_events_flat(
    store: Blockstore,
    receipts_roots: Sequence[CID],
    skip_missing: bool = False,
    want_payload: bool = False,
    validate_blocks: bool = False,
    threads: "Optional[int]" = None,
) -> Optional[ScanBatch]:
    """Scan every receipts AMT in ``receipts_roots``; None in the
    pure-Python universe (callers use the Python scan path).

    ``skip_missing`` prunes subtrees whose blocks are absent instead of
    raising — the tolerant mode the batch verifier uses over pruned witness
    stores (a proof whose path is missing simply finds no row → False).
    ``want_payload`` additionally pools the full topics/data bytes per event
    for claim comparison. ``validate_blocks`` full-validates every fetched
    block as one trailing-free DAG-CBOR item — REQUIRED when the store
    holds adversarial witness bytes (the batch verifier), so garbage in
    positions the targeted walk skips cannot scan clean where the scalar
    replay's full decode rejects it. ``threads`` caps the pthread fan-out
    as in `scan_match_hits`.
    """
    from ipc_proofs_tpu_torch.backend.native import load_scan_ext

    ext = load_scan_ext()
    if ext is None:
        return None
    raw, fallback = _raw_view(store)
    out = ext.scan_events_batch(
        raw,
        [c.to_bytes() for c in receipts_roots],
        fallback,
        skip_missing=skip_missing,
        want_payload=want_payload,
        validate_blocks=validate_blocks,
        **_snap_kw(store, raw, len(receipts_roots)),
        threads=threads,
    )
    n = out["n_events"]
    return ScanBatch(
        topics=np.frombuffer(out["topics"], dtype="<u4").reshape(n, 2, 8),
        fp=np.frombuffer(out["fp"], dtype="<u8"),
        n_topics=np.frombuffer(out["n_topics"], dtype="<i4"),
        emitters=np.frombuffer(out["emitters"], dtype="<u8"),
        valid=np.frombuffer(out["valid"], dtype=np.uint8).astype(bool),
        pair_ids=np.frombuffer(out["pair_ids"], dtype="<i4"),
        exec_idx=np.frombuffer(out["exec_idx"], dtype="<i4"),
        event_idx=np.frombuffer(out["event_idx"], dtype="<i4"),
        n_receipts=out["n_receipts"],
        topics_pool=out["topics_pool"],
        data_pool=out["data_pool"],
        topics_off=np.frombuffer(out["topics_off"], dtype="<u4") if want_payload else None,
        data_off=np.frombuffer(out["data_off"], dtype="<u4") if want_payload else None,
        data_len=np.frombuffer(out["data_len"], dtype="<u4") if want_payload else None,
    )
