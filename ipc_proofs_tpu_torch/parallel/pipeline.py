"""The batch event-match pipelines and the host stage pipeline.

The counterpart of ``ipc_proofs_tpu.parallel.pipeline``:

1. The **device match pipeline** (`match_pipeline` /
   `sharded_match_pipeline`): one computation over a padded
   ``[tipset, receipt, event]`` world instead of a loop over receipts ×
   events:

       mask    = topic0/topic1/emitter predicate per event   (elementwise)
       hits    = any-reduce over the event axis per receipt  (OR over ``sp``)
       count   = global proof count                          (full reduce)

   The JAX package jit-compiles this step (XLA fuses it outside any Pallas
   kernel); here it is one hand-written kernel of ``csrc/match.cu``
   (`match_pipeline` launches it for CUDA tensors; `match_pipeline_plain`,
   the same step in PyTorch ops, runs for CPU tensors). Sharding (tipsets over ``dp``,
   events over ``sp``) places one block on each mesh device. A block on
   the mesh's first device writes straight into the whole mesh's outputs
   there (its mask slice, its hits stored or ORed over ``sp``, its count
   stored or added), so a mesh on one card runs one launch a block and
   nothing else; a block on another card is copied over and combined.
   Under a process group the count is all-reduced and the hits
   all-gathered across processes (`parallel.multihost`).
2. `PipelineStage` / `run_pipeline`: a bounded-queue, order-preserving,
   multi-worker staged executor for the chunked proof drivers. Stage k+1
   of chunk i runs concurrently with stage k of chunk i+1 (scan ∥ record ∥
   merge ∥ verify), each stage with its own worker count, with
   backpressure (``depth`` buffered results per inter-stage queue) so a
   fast scan can't balloon memory ahead of a slow record, and fail-fast
   cancellation: the first worker exception cancels all pending work and
   re-raises in the caller. The caller's `utils.deadline.CancelScope` and
   its `obs.trace.TraceContext` hop to every stage worker, so spans opened
   inside stage fns (``metrics.stage``, RPC calls, journal appends) parent
   into the caller's trace.
3. `MatchCoalescer`: concurrent scan workers' fingerprint-mask calls on the
   unfused path combine into one call on the card.

u32 words travel as int32 bit patterns (CPU PyTorch lacks most uint32
ops; int32 equality is u32 equality).
"""

from __future__ import annotations

import ctypes
import queue
import threading
from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from ipc_proofs_tpu_torch.obs.trace import current_context, use_context
from ipc_proofs_tpu_torch.ops.build import check_tensor, launch, reset_counts, runs_plain
from ipc_proofs_tpu_torch.ops.pack import to_int32
from ipc_proofs_tpu_torch.utils.deadline import current_scope, use_scope
from ipc_proofs_tpu_torch.utils.lockdep import named_lock

__all__ = [
    "EventBatch",
    "LAUNCHES",
    "batch_args",
    "synthetic_event_batch",
    "match_pipeline",
    "match_pipeline_plain",
    "reset_launch_counts",
    "sharded_match_pipeline",
    "make_specs_u32",
    "PipelineStage",
    "run_pipeline",
    "MatchCoalescer",
]

# match_pipeline kernel launches since the last reset (one per block of a
# sharded call)
LAUNCHES = {"match_pipeline": 0}

# the ``csrc/match.cu`` entry's signature: the seven inputs, receipts,
# events a receipt, the first receipt and event column it writes, the whole
# mask's events a receipt, the flags; hits, mask, count, stream
_ARGTYPES = {
    "match_pipeline": [ctypes.c_void_p] * 7 + [ctypes.c_longlong, ctypes.c_int]
    + [ctypes.c_longlong] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 4,
}
# the entry's flags (``csrc/match.cu`` kOrHits, kAddCount)
OR_HITS = 1
ADD_COUNT = 2


def reset_launch_counts() -> None:
    reset_counts(LAUNCHES)


@dataclass
class EventBatch:
    """Host-side padded batch: T tipsets × R receipts × E event slots."""

    topics: np.ndarray  # uint32 [T, R, E, 2, 8] — first two topics as u32 words
    n_topics: np.ndarray  # int32 [T, R, E]
    emitters: np.ndarray  # int32 [T, R, E]
    valid: np.ndarray  # bool [T, R, E] (False = padding / non-EVM event)

    @property
    def shape(self) -> tuple[int, int, int]:
        return self.n_topics.shape  # type: ignore[return-value]

    @property
    def n_events(self) -> int:
        return int(self.valid.sum())


def make_specs_u32(topic0: bytes, topic1: bytes) -> tuple[np.ndarray, np.ndarray]:
    return (
        np.frombuffer(topic0, dtype="<u4").copy(),
        np.frombuffer(topic1, dtype="<u4").copy(),
    )


def synthetic_event_batch(
    n_tipsets: int,
    receipts_per_tipset: int,
    events_per_receipt: int,
    topic0: bytes,
    topic1: bytes,
    emitter: int = 1001,
    match_rate: float = 0.01,
    seed: int = 0,
) -> EventBatch:
    """A padded event world where ~``match_rate`` of receipts contain one
    matching event (BASELINE.json config 2's sparse-filter shape). The same
    generator calls as the reference, so a seed gives equal arrays."""
    rng = np.random.default_rng(seed)
    t, r, e = n_tipsets, receipts_per_tipset, events_per_receipt
    topics = rng.integers(0, 2**32, size=(t, r, e, 2, 8), dtype=np.uint32)
    n_topics = np.full((t, r, e), 2, dtype=np.int32)
    emitters = np.full((t, r, e), emitter, dtype=np.int32)
    valid = np.ones((t, r, e), dtype=bool)

    spec0, spec1 = make_specs_u32(topic0, topic1)
    match_receipts = rng.random((t, r)) < match_rate
    ts_idx, rc_idx = np.nonzero(match_receipts)
    ev_idx = rng.integers(0, e, size=len(ts_idx))
    topics[ts_idx, rc_idx, ev_idx, 0] = spec0
    topics[ts_idx, rc_idx, ev_idx, 1] = spec1
    return EventBatch(topics=topics, n_topics=n_topics, emitters=emitters, valid=valid)


def batch_args(
    batch: EventBatch, topic0: bytes, topic1: bytes, actor_id: Optional[int], device
) -> tuple:
    """`match_pipeline`'s seven arguments for ``batch`` on ``device``:
    topics, n_topics, emitters and the spec words as int32 bit views,
    ``valid`` as bool, ``actor_id`` as an int32 scalar (-1 = no filter)."""
    device = torch.device(device)
    spec0, spec1 = make_specs_u32(topic0, topic1)
    return (
        to_int32(batch.topics, device),
        to_int32(batch.n_topics.astype(np.int32, copy=False), device),
        to_int32(batch.emitters.astype(np.int32, copy=False), device),
        torch.from_numpy(np.ascontiguousarray(batch.valid, dtype=bool)).to(device),
        to_int32(spec0, device),
        to_int32(spec1, device),
        torch.tensor(-1 if actor_id is None else actor_id, dtype=torch.int32, device=device),
    )


def match_pipeline_plain(topics, n_topics, emitters, valid, topic0, topic1, actor_id,
                         out=None, row0=0, col0=0, or_hits=False, add_count=False):
    """Plain version of `match_pipeline`, with the same arguments: given
    ``out``, it writes the block into those tensors in place and returns
    them."""
    t0_eq = (topics[..., 0, :] == topic0).all(dim=-1)
    t1_eq = (topics[..., 1, :] == topic1).all(dim=-1)
    emitter_ok = (emitters == actor_id) | (actor_id < 0)
    mask = valid & (n_topics >= 2) & t0_eq & t1_eq & emitter_ok
    receipt_hits = mask.any(dim=-1)  # reduce over the (sp-sharded) event axis
    n_proofs = mask.sum(dtype=torch.int32)
    if out is None:
        return receipt_hits, mask, n_proofs
    return _write_block(out, (receipt_hits, mask, n_proofs), row0, col0, or_hits, add_count)


def _write_block(out, block, row0, col0, or_hits, add_count):
    """Write a block's (hits, mask, count) into a mesh's whole outputs
    ``out`` in place, as the kernel does (its kOrHits: only a hit is
    written; kAddCount: the count is added), and return ``out``."""
    hits_out, mask_out, count_out = out
    hits, mask, count = block
    t, _, e = mask.shape
    mask_out[row0 : row0 + t, :, col0 : col0 + e] = mask
    if or_hits:
        hits_out[row0 : row0 + t].masked_fill_(hits, True)  # the OR over sp
    else:
        hits_out[row0 : row0 + t] = hits
    if add_count:
        count_out.add_(count)
    else:
        count_out.copy_(count)
    return out


def match_pipeline(topics, n_topics, emitters, valid, topic0, topic1, actor_id,
                   out=None, row0=0, col0=0, or_hits=False, add_count=False):
    """The device step: per-event mask → per-receipt hits → count.

    Shapes: topics int32 [T,R,E,2,8]; n_topics/emitters int32 and valid
    bool [T,R,E]; topic0/topic1 int32 [8]; actor_id an int32 scalar tensor
    (negative = no filter). All on one device.

    Returns (receipt_hits bool [T,R], event_mask bool [T,R,E], n_proofs
    int32 scalar), on that device. On a card one kernel launch, after a
    memset of the count where the call stores it (the spec words and the
    actor are read on the card: no sync, so a CUDA graph captures it).

    ``out``: a mesh's whole outputs (hits bool [T',R], mask bool [T',R,E'],
    count int32 scalar) on the same device, into which the call writes
    instead, and which it returns: its hits at tipset rows ``row0`` to
    ``row0 + T``, its mask at those rows and event columns ``col0`` to
    ``col0 + E``, and its count. ``or_hits`` ORs its hits in (a block of a
    mesh row after the row's first: only a hit is written), ``add_count``
    adds its count to the output's (every block after a mesh's first);
    otherwise each is stored.
    """
    name = "match_pipeline"
    device = topics.device
    if topics.dim() != 5:
        raise ValueError(f"{name}: expected topics [T, R, E, 2, 8], got {tuple(topics.shape)}")
    t, r, e = topics.shape[:3]
    check_tensor(name, topics, torch.int32, (t, r, e, 2, 8), device, align=16)
    check_tensor(name, n_topics, torch.int32, (t, r, e), device)
    check_tensor(name, emitters, torch.int32, (t, r, e), device)
    check_tensor(name, valid, torch.bool, (t, r, e), device)
    check_tensor(name, topic0, torch.int32, (8,), device)
    check_tensor(name, topic1, torch.int32, (8,), device)
    check_tensor(name, actor_id, torch.int32, (), device)
    if out is None:
        if row0 or col0 or or_hits or add_count:
            raise ValueError(f"{name}: a block's place and flags need the outputs it writes into")
        out = (
            torch.empty((t, r), dtype=torch.bool, device=device),
            torch.empty((t, r, e), dtype=torch.bool, device=device),
            torch.empty((), dtype=torch.int32, device=device),
        )
    else:
        hits, mask, count = out
        check_tensor(name, hits, torch.bool, (*hits.shape[:1], r), device)
        check_tensor(name, mask, torch.bool, (hits.shape[0], r, *mask.shape[2:3]), device)
        check_tensor(name, count, torch.int32, (), device)
        whole_t, whole_e = mask.shape[0], mask.shape[2]
        if not (0 <= row0 <= whole_t - t and 0 <= col0 <= whole_e - e):
            raise ValueError(f"{name}: a block of {t} tipsets x {e} events at ({row0}, {col0}) "
                             f"lies outside outputs of {whole_t} x {whole_e}")
    if runs_plain(name, device):
        return match_pipeline_plain(topics, n_topics, emitters, valid, topic0, topic1, actor_id,
                                    out, row0, col0, or_hits, add_count)
    if t * r == 0:
        if not add_count:
            out[2].zero_()
        return out
    flags = (OR_HITS if or_hits else 0) | (ADD_COUNT if add_count else 0)
    args = [x.data_ptr() for x in (topics, n_topics, emitters, valid, topic0, topic1, actor_id)]
    args += [t * r, e, row0 * r, col0, out[1].shape[2], flags]
    launch("match", name, _ARGTYPES[name], args, list(out), device, LAUNCHES)
    return out


def sharded_match_pipeline(mesh):
    """`match_pipeline` with tipsets sharded over ``dp`` and the event axis
    over ``sp``. Returns ``(fn, shard_batch)``:

    - ``shard_batch(batch, topic0, topic1, actor_id)`` places a host
      `EventBatch` on the mesh: block (d, s) — tipset rows d, event columns
      s — on device ``mesh.grid[d][s]``, the spec words and actor copied to
      every device. It returns seven tuples, one tensor per block each, in
      row-major block order. T must divide by dp and E by sp. Under a
      process group the batch is this process's rows (its share of the
      tipsets, as `parallel.multihost.host_local_pairs` splits them).
    - ``fn(*shard_batch(...))`` computes each block and returns (hits
      [T,R], mask [T,R,E], count) on the mesh's first device: a block on
      that device writes into those outputs itself (`match_pipeline`'s
      ``out``: its mask slice, its hits stored by a row's first block and
      ORed by the rest, its count stored by the first block and added by
      the rest), so a mesh on one card runs its blocks' launches and no
      other kernel; a block on another card computes its own outputs,
      which are copied over and combined. Under a process group the count
      is all-reduced and the hits all-gathered, so hits and count are the
      whole mesh's; the mask stays this process's rows.
    """
    grid = mesh.grid
    dp, sp = mesh.local_dp, len(grid[0])
    out_device = grid[0][0]

    def shard_batch(batch: EventBatch, topic0: bytes, topic1: bytes, actor_id: Optional[int]):
        t, _, e = batch.shape
        if t % dp or e % sp:
            raise ValueError(f"batch {batch.shape}: tipsets must divide by dp={dp}, events by sp={sp}")
        tb, eb = t // dp, e // sp
        blocks = []
        for d in range(dp):
            for s in range(sp):
                rows, cols = slice(d * tb, (d + 1) * tb), slice(s * eb, (s + 1) * eb)
                block = EventBatch(
                    topics=batch.topics[rows, :, cols],
                    n_topics=batch.n_topics[rows, :, cols],
                    emitters=batch.emitters[rows, :, cols],
                    valid=batch.valid[rows, :, cols],
                )
                blocks.append(batch_args(block, topic0, topic1, actor_id, grid[d][s]))
        return tuple(zip(*blocks))

    def fn(topics, n_topics, emitters, valid, topic0, topic1, actor_id):
        tb, r, eb = n_topics[0].shape
        out = (
            torch.empty((dp * tb, r), dtype=torch.bool, device=out_device),
            torch.empty((dp * tb, r, sp * eb), dtype=torch.bool, device=out_device),
            torch.empty((), dtype=torch.int32, device=out_device),
        )
        stored_rows: "set[int]" = set()
        blocks = zip(topics, n_topics, emitters, valid, topic0, topic1, actor_id)
        for k, block in enumerate(blocks):
            d, s = divmod(k, sp)
            place = dict(row0=d * tb, col0=s * eb, or_hits=d in stored_rows, add_count=k > 0)
            if grid[d][s] == out_device:
                match_pipeline(*block, out=out, **place)
            else:  # another card: its outputs copied over and combined
                _write_block(out, [x.to(out_device) for x in match_pipeline(*block)], **place)
            stored_rows.add(d)
        hits, mask, count = out
        if mesh.distributed:
            from ipc_proofs_tpu_torch.parallel.multihost import reduce_across_processes

            hits, count = reduce_across_processes(hits, count)
        return hits, mask, count

    return fn, shard_batch


# --------------------------------------------------------------------------
# device-call coalescing across concurrent pipeline workers
# --------------------------------------------------------------------------


class _MatchReq:
    """One worker's parked fp-match request inside a `MatchCoalescer`."""

    __slots__ = ("fp", "n_topics", "emitters", "valid", "key", "done", "result", "exc")

    def __init__(self, fp, n_topics, emitters, valid, key):
        self.fp = fp
        self.n_topics = n_topics
        self.emitters = emitters
        self.valid = valid
        self.key = key  # (topic0, topic1, actor_id) — only equal keys combine
        self.done = threading.Event()
        self.result = None
        self.exc: Optional[BaseException] = None


class MatchCoalescer:
    """Combine concurrent ``event_match_mask_fp`` calls from in-flight scan
    workers into one larger device call.

    Leader-based combining with NO added latency window: every caller
    parks its request, then queues on the device lock. Whoever gets the
    lock claims everything parked so far and issues one concatenated call
    for each distinct (topic0, topic1, actor) key; callers whose request
    was serviced by an earlier leader skip the call entirely. While a
    leader is inside the device call, later arrivals pile up behind the
    lock — so batches grow exactly when the device is the bottleneck and
    a lone call proceeds immediately.

    Bit-identity: the fp predicate is elementwise per event, so a mask
    computed over a concatenation, split back at the input offsets,
    equals the per-request masks — same contract the sharded device
    pipeline relies on. Counted as ``range_match_coalesced`` (requests
    that rode another caller's device call).

    Dispatch discipline: every batch goes to the card at its own length.
    (The reference pads each dispatch to a power-of-two bucket so that XLA
    traces O(log n) shapes; the port's eager mask compiles nothing per
    shape. Under a device mesh `ops.match.event_match_mask_fp` pads the
    rows to a mesh-divisible bucket itself.)
    """

    def __init__(self, backend, metrics=None):
        self._backend = backend
        self._metrics = metrics
        self._lock = named_lock("MatchCoalescer._lock")
        self._call_lock = named_lock("MatchCoalescer._call_lock")  # serializes device dispatch
        self._pending: "list[_MatchReq]" = []  # guarded-by: _lock

    def match_fp(self, fp, n_topics, emitters, valid, topic0, topic1, actor_id):
        """Drop-in for ``backend.event_match_mask_fp`` (same signature,
        same return contract: a mask at least as long as the input)."""
        req = _MatchReq(fp, n_topics, emitters, valid, (topic0, topic1, actor_id))
        with self._lock:
            self._pending.append(req)
        # lock-order: MatchCoalescer._call_lock < MatchCoalescer._lock
        with self._call_lock:
            if req.done.is_set():
                batch: "list[_MatchReq]" = []
            else:
                with self._lock:
                    batch = self._pending
                    self._pending = []
            if batch:
                self._run(batch)
        if req.exc is not None:
            raise req.exc
        return req.result

    def _run(self, batch: "list[_MatchReq]") -> None:
        groups: "dict[tuple, list[_MatchReq]]" = {}
        for r in batch:
            groups.setdefault(r.key, []).append(r)
        for key, reqs in groups.items():
            topic0, topic1, actor_id = key
            try:
                if len(reqs) == 1:
                    r = reqs[0]
                    fp, n_topics, emitters, valid = (
                        r.fp, r.n_topics, r.emitters, r.valid,
                    )
                else:
                    fp = np.concatenate([r.fp for r in reqs])
                    n_topics = np.concatenate([r.n_topics for r in reqs])
                    emitters = np.concatenate([r.emitters for r in reqs])
                    valid = np.concatenate([r.valid for r in reqs])
                out = self._backend.event_match_mask_fp(
                    fp, n_topics, emitters, valid, topic0, topic1, actor_id
                )
                off = 0
                for r in reqs:
                    n = len(r.fp)
                    r.result = out[off : off + n]
                    off += n
                if self._metrics is not None and len(reqs) > 1:
                    self._metrics.count("range_match_coalesced", len(reqs) - 1)
            except BaseException as exc:  # fail-soft: every parked waiter re-raises this from its own match_fp call — nothing is swallowed
                for r in reqs:
                    r.exc = exc
            finally:
                for r in reqs:
                    r.done.set()


# --------------------------------------------------------------------------
# host stage pipeline: bounded-queue, order-preserving staged executor
# --------------------------------------------------------------------------


@dataclass
class PipelineStage:
    """One stage of a host pipeline: ``fn(item) -> result`` applied by
    ``workers`` threads. Results are forwarded downstream in INPUT order
    regardless of worker completion order, so a multi-worker stage feeding
    an order-sensitive consumer (e.g. chunk-ordered claim emission) stays
    deterministic. ``metrics_stage``, if set, times every ``fn`` call under
    that `Metrics` stage name (the caller passes the `Metrics` to
    `run_pipeline`).

    ``drain_on_cancel``: when another stage's failure cancels the
    pipeline, this stage's queued-but-unclaimed inputs still run
    (inline, best-effort, exceptions swallowed) before the original
    exception re-raises in the caller. For a stage whose ``fn`` has
    durable side effects — e.g. the range driver's record stage
    journaling completed chunks — this salvages work upstream stages
    already paid for, so a resume after the abort doesn't redo it.
    Results are discarded; only the side effects matter."""

    name: str
    fn: Callable[[Any], Any]
    workers: int = 1
    metrics_stage: Optional[str] = None
    drain_on_cancel: bool = False


class _Cancel:
    """First-exception-wins cancellation token shared by every worker."""

    __slots__ = ("_event", "_lock", "exc")

    def __init__(self):
        self._event = threading.Event()
        self._lock = named_lock("_Cancel._lock")
        self.exc: Optional[BaseException] = None  # guarded-by: _lock

    def fail(self, exc: BaseException) -> None:
        with self._lock:
            if self.exc is None:
                self.exc = exc
        self._event.set()

    def is_set(self) -> bool:
        return self._event.is_set()


_STOP = object()  # end-of-stream sentinel (one per downstream worker)
_POLL_S = 0.05  # queue poll granularity; bounds cancellation latency


def _put(q: "queue.Queue", item, cancel: _Cancel) -> bool:
    """Blocking put that aborts (returns False) once the pipeline cancels —
    no worker can stay wedged against a full queue whose consumer died."""
    while not cancel.is_set():
        try:
            q.put(item, timeout=_POLL_S)
            return True
        except queue.Full:
            continue
    return False


def _get(q: "queue.Queue", cancel: _Cancel):
    while not cancel.is_set():
        try:
            return q.get(timeout=_POLL_S)
        except queue.Empty:
            continue
    return _STOP


class _OrderedEmitter:
    """Reorder buffer between a stage's workers and the next queue: workers
    finish out of order, downstream receives strict input order. Emitting a
    result may block on the bounded downstream queue — that IS the
    backpressure (at most ``depth`` results buffered ahead of the
    consumer, plus what the workers hold in flight)."""

    def __init__(self, n_items: int, out_q: "queue.Queue", n_stops: int, cancel: _Cancel):
        self._lock = named_lock("_OrderedEmitter._lock")
        self._buffer: dict[int, Any] = {}  # guarded-by: _lock
        self._next = 0  # guarded-by: _lock
        self._n = n_items
        self._out_q = out_q
        self._n_stops = n_stops  # sentinels owed downstream (0 = caller-consumed)
        self._cancel = cancel

    def emit(self, seq: int, value) -> bool:
        with self._lock:
            self._buffer[seq] = value
            while self._next in self._buffer:
                if not _put(self._out_q, (self._next, self._buffer.pop(self._next)), self._cancel):
                    return False
                self._next += 1
            if self._next == self._n:
                for _ in range(self._n_stops):
                    if not _put(self._out_q, _STOP, self._cancel):
                        return False
        return True


def _stage_worker(
    stage: PipelineStage, in_q, emit, cancel: _Cancel, metrics, trace_ctx=None,
    cancel_scope=None,
) -> None:
    with use_context(trace_ctx), use_scope(cancel_scope):
        while True:
            task = _get(in_q, cancel)
            if task is _STOP:
                return
            seq, item = task
            try:
                # stage boundary = cancellation boundary: an abandoned or
                # expired request stops consuming workers before the next
                # stage fn runs (checkpoints inside fns fire too — the
                # ambient scope is installed on this worker thread)
                if cancel_scope is not None:
                    cancel_scope.check(stage=f"pipeline.{stage.name}")
                if metrics is not None and stage.metrics_stage:
                    with metrics.stage(stage.metrics_stage):
                        result = stage.fn(item)
                else:
                    result = stage.fn(item)
            except BaseException as exc:  # fail-soft: worker strands no one — the failure cancels the pipeline and re-raises in the driver
                cancel.fail(exc)
                return
            if not emit(seq, result):
                return


def run_pipeline(
    items: Sequence,
    stages: Sequence[PipelineStage],
    depth: int = 2,
    metrics=None,
) -> list:
    """Run every item through ``stages`` with inter-stage overlap: item i's
    stage k+1 runs while item i+1 is still in stage k. Returns the final
    stage's results in input order.

    - Each inter-stage queue buffers at most ``depth`` completed results;
      peak memory is ~``depth + workers`` items per stage, regardless of
      ``len(items)``.
    - A worker exception cancels the whole pipeline (pending work is
      dropped, in-flight work is abandoned at the next queue operation)
      and re-raises the ORIGINAL exception in the caller — never a
      deadlock (tests/test_torch_pipeline.py).
    - ``metrics``: a `Metrics` whose ``stage(...)`` times each stage's
      ``fn`` calls under the stage's ``metrics_stage`` name (thread-safe;
      overlapped stages report busy + union wall separately).
    """
    items = list(items)
    stages = list(stages)
    if not stages:
        raise ValueError("run_pipeline needs at least one stage")
    n = len(items)
    if n == 0:
        return []
    depth = max(1, int(depth))
    cancel = _Cancel()
    queues: list[queue.Queue] = [queue.Queue(maxsize=depth) for _ in range(len(stages) + 1)]

    # the caller's TraceContext hops the bounded queues with the work:
    # every stage worker re-installs it so spans opened inside stage fns
    # (e.g. via metrics.stage) parent into the caller's trace
    trace_ctx = current_context()
    # the caller's CancelScope hops too: every stage worker re-installs it
    # and checks it at each stage boundary, so a cancelled/expired request
    # tears the whole pipeline down typed
    cancel_scope = current_scope()

    threads: list[threading.Thread] = []
    for i, stage in enumerate(stages):
        workers = max(1, int(stage.workers))
        # sentinels owed to the NEXT stage's workers; the final queue is
        # consumed by the caller, who counts results instead
        n_stops = max(1, int(stages[i + 1].workers)) if i + 1 < len(stages) else 0
        emitter = _OrderedEmitter(n, queues[i + 1], n_stops, cancel)
        for w in range(workers):
            t = threading.Thread(
                target=_stage_worker,
                args=(stage, queues[i], emitter.emit, cancel, metrics, trace_ctx, cancel_scope),
                name=f"pipeline-{stage.name}-{w}",
                daemon=True,
            )
            threads.append(t)
            t.start()

    def _feed():
        for seq, item in enumerate(items):
            if not _put(queues[0], (seq, item), cancel):
                return
        for _ in range(max(1, int(stages[0].workers))):
            if not _put(queues[0], _STOP, cancel):
                return

    feeder = threading.Thread(target=_feed, name="pipeline-feeder", daemon=True)
    feeder.start()

    results: list = []
    final_q = queues[-1]
    while len(results) < n:
        task = _get(final_q, cancel)
        if task is _STOP:  # cancelled mid-stream
            break
        _seq, value = task
        results.append(value)  # emitters guarantee seq order

    feeder.join()
    for t in threads:
        t.join()
    if cancel.exc is not None:
        _drain_cancelled(stages, queues)
        raise cancel.exc
    return results


def _drain_cancelled(stages: "list[PipelineStage]", queues: "list[queue.Queue]") -> None:
    """Post-cancellation salvage: run ``drain_on_cancel`` stages' queued
    inputs inline (all workers have exited, so the queues are frozen).
    Best-effort — a drain failure must not mask the original exception."""
    for i, stage in enumerate(stages):
        if not stage.drain_on_cancel:
            continue
        q = queues[i]
        while True:
            try:
                task = q.get_nowait()
            except queue.Empty:
                break
            if task is _STOP:
                continue
            _seq, item = task
            try:
                stage.fn(item)
            except BaseException:  # fail-soft: drain-after-cancel salvage — the original failure is already propagating to the driver
                pass
