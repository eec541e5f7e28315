"""Async fetch plane: decouple IPLD traversal from block fetch.

The counterpart of ``ipc_proofs_tpu.store.fetchplane``. Each landed wave
is checked by ONE `ops.verify.verify_blocks_batch` call on ``backend``
(default the card), which `backend.warm()` builds before any dispatcher
thread starts, so no dispatcher runs nvcc. The lane's own routing sends
one-block and sub-crossover waves to hashlib with identical verdicts. A
kernel or launch fault is not a fetch error: it latches the plane, fails
every outstanding want with it, and is re-raised to every current and
later caller (`get`, `fetch_into`), whether the wave was demanded,
prefetched or speculative. Over an `EndpointPool` the pool verifies each
wave on the same lane and the plane skips its own check; the pool's lane
fault (`ops.verify.VerifyLaneError`) latches the plane the same way. A
dispatcher fetches each batch under the trace context of the batch's
first want, so its ``pool.*`` and ``rpc.*`` spans join the wanting
caller's trace.

The cold path walks HAMT/AMT structures pointer-by-pointer — one
`Filecoin.ChainReadObj` round-trip per IPLD edge, so cold latency is RPC
latency × walk depth (the Reddio "asynchronous storage" observation:
execution must never wait on a storage round-trip). This plane breaks the
lockstep three ways:

- **RPC batching** — block wants from concurrent walkers accumulate in a
  bounded want-queue; dispatcher threads drain it and ship each wave as
  ONE JSON-RPC batch array (`LotusClient.chain_read_obj_many`). A walker
  blocked on block A rides the same round-trip as its siblings' blocks
  B…Z.
- **speculative prefetch** — the moment a HAMT/AMT interior node decodes,
  the walker offers its child links (`offer_links`), which enter the
  queue at LOW priority; the plane chases further levels itself up to
  ``speculate_depth``. Mis-speculation is counted, never an error.
- **tier short-circuit** — wants already satisfiable from the local
  tiers (RAM/disk via `TieredBlockstore.get_local`) never reach the
  queue; landed blocks deposit into the tiers so the next request (or
  process) starts warm.

The lying-endpoint rule is non-negotiable: every block — speculative or
demanded — is multihash-verified before anything can observe it (unless
the client sets ``verifies_integrity`` and verifies per endpoint itself).
A speculative block that fails verification is
discarded and counted; the demand path refetches and raises the typed
`IntegrityError` exactly like the sync walker.

Determinism: the plane changes *when* blocks arrive, never *what* any
`get` returns — results are content-addressed and verified, so drivers
above (range pipeline, serve plane) produce byte-identical bundles with
or without the plane. That is the identity bar the grid tests pin.
"""

from __future__ import annotations

import threading
from collections import OrderedDict, deque
from typing import Iterable, Optional

from ipc_proofs_tpu_torch.core.cid import CID
from ipc_proofs_tpu_torch.core.dagcbor import decode as dagcbor_decode
from ipc_proofs_tpu_torch.obs.trace import current_context, use_context
from ipc_proofs_tpu_torch.ops.verify import VerifyLaneError, verify_blocks_batch
from ipc_proofs_tpu_torch.store.blockstore import BlockCache
from ipc_proofs_tpu_torch.store.rpc import IntegrityError
from ipc_proofs_tpu_torch.utils.deadline import checkpoint
from ipc_proofs_tpu_torch.utils.lockdep import named_condition
from ipc_proofs_tpu_torch.utils.threads import locked

__all__ = ["FetchPlane", "PlaneBlockstore"]

# sentinel: a speculative block discarded for failing verification — not
# an error (nothing observed it), not a landing (the want is forgotten so
# a later demand get refetches from scratch)
_DISCARD = RuntimeError("speculative discard")

# cap on links extracted from one speculative block — an adversarially
# wide node must not turn one landing into an unbounded fan-out (same
# bound as the follower's spine walk)
_MAX_LINKS_PER_BLOCK = 32


def _child_links(data: bytes, cap: int = _MAX_LINKS_PER_BLOCK) -> "list[CID]":
    """CID links directly inside one DAG-CBOR block, document order,
    bounded. Undecodable blocks (raw leaves) yield [] — speculation is
    advisory, so decode failures are silent by design."""
    try:
        obj = dagcbor_decode(data)
    except Exception:  # fail-soft: a non-CBOR block simply has no links to follow
        return []
    links: "list[CID]" = []
    stack = [obj]
    while stack and len(links) < cap:
        node = stack.pop(0)
        if isinstance(node, CID):
            links.append(node)
        elif isinstance(node, (list, tuple)):
            stack.extend(node)
        elif isinstance(node, dict):
            stack.extend(node[k] for k in sorted(node))
    return links


class _Want:
    """One block want: queue entry + completion slot its waiters poll."""

    __slots__ = (
        "cid", "depth", "speculative", "done", "data", "error", "used", "waiters", "trace_ctx",
    )

    def __init__(self, cid: CID, speculative: bool, depth: int):
        self.cid = cid
        self.depth = depth
        # the wanting thread's trace context: the dispatcher fetches a
        # batch under its first want's context
        self.trace_ctx = current_context()
        self.speculative = speculative  # guarded-by: FetchPlane._cond
        self.done = False  # guarded-by: FetchPlane._cond
        self.data: Optional[bytes] = None  # guarded-by: FetchPlane._cond
        self.error: Optional[Exception] = None  # guarded-by: FetchPlane._cond
        self.used = False  # guarded-by: FetchPlane._cond
        self.waiters = 0  # demand waiters attached; guarded-by: FetchPlane._cond


class FetchPlane:
    """Want-queue + dispatcher threads between walkers and the RPC client.

    ``client`` is anything client-shaped (`LotusClient`, a test fake):
    `chain_read_obj_many` is used when present, per-CID `chain_read_obj`
    otherwise (no batching, but walkers still overlap). ``local``
    optionally names the local tiers (`TieredBlockstore`, or a plain dict
    in tests): hits short-circuit wants, landings deposit. ``backend`` is
    the verify lane's hash backend (default the card, `get_backend("gpu")`,
    which raises without CUDA).

    Thread safety: ONE condition guards all queue/want state (see the
    `guarded-by` annotations). It is a leaf lock by construction — no
    RPC, disk, or foreign lock is ever touched while holding it (the
    dispatchers fetch and verify strictly outside it), so it cannot
    participate in a lock-order cycle; `Metrics._lock` (declared
    globally-last, `# lock-order: * < Metrics._lock`) is the one lock
    counted under it.
    """

    # --speculate-depth auto: start here and back off one level per
    # window whose counted waste ratio crosses the threshold
    AUTO_START_DEPTH = 2
    AUTO_WASTE_THRESHOLD = 0.6

    def __init__(
        self,
        client,
        local=None,
        *,
        batch_max: int = 64,
        speculate_depth: "int | str" = 1,
        workers: int = 2,
        spec_queue_cap: int = 512,
        landed_cap: int = 2048,
        auto_window: int = 64,
        metrics=None,
        backend=None,
    ):
        self._client = client
        self._local = local
        self.batch_max = max(1, int(batch_max))
        self.adaptive_depth = speculate_depth == "auto"
        if self.adaptive_depth:
            speculate_depth = self.AUTO_START_DEPTH
        # adaptive mode lowers this under _cond; the unlocked reads in
        # speculate()/_fulfil are advisory depth gates, so a stale read
        # costs at most one over-deep speculation wave, never correctness
        self.speculate_depth = max(0, int(speculate_depth))
        if backend is None:
            from ipc_proofs_tpu_torch.backend import get_backend

            backend = get_backend("gpu")
        self._backend = backend
        backend.warm()  # nvcc now, before any dispatcher thread exists
        self._auto_window = max(1, int(auto_window))
        self._auto_fetched0 = 0  # window snapshot; guarded-by: _cond
        self._auto_used0 = 0  # guarded-by: _cond
        self._n_workers = max(1, int(workers))
        self.spec_queue_cap = max(1, int(spec_queue_cap))
        self.landed_cap = max(1, int(landed_cap))
        if metrics is None:
            from ipc_proofs_tpu_torch.utils.metrics import get_metrics

            metrics = get_metrics()
        self._metrics = metrics
        # lock-order: FetchPlane._cond < Metrics._lock
        self._cond = named_condition("FetchPlane._cond")
        self._wants: "dict[CID, _Want]" = {}  # guarded-by: _cond
        self._demand_q: "deque[CID]" = deque()  # guarded-by: _cond
        self._spec_q: "deque[CID]" = deque()  # guarded-by: _cond
        # landed-but-not-yet-demanded speculative blocks, FIFO-bounded by
        # landed_cap so a wild mis-speculation run cannot hold the
        # process's memory hostage
        self._landed_spec: "OrderedDict[CID, None]" = OrderedDict()  # guarded-by: _cond
        self._threads: "list[threading.Thread]" = []  # guarded-by: _cond
        self._closed = False  # guarded-by: _cond
        # the verify lane's first kernel or launch fault, latched: the plane
        # serves nothing after it
        self._fault: Optional[Exception] = None  # guarded-by: _cond
        self._spec_fetched = 0  # guarded-by: _cond
        self._spec_used = 0  # guarded-by: _cond
        self._waste_counted = False  # guarded-by: _cond

    # -- public surface ----------------------------------------------------

    def get(self, cid: CID) -> Optional[bytes]:
        """Demand fetch: local tiers, then the want-queue (coalescing with
        any in-flight or landed want for the same block). Blocks until the
        want completes; raises the same typed errors as the sync path."""
        data = self._local_get(cid)
        if data is not None:
            self._metrics.count("fetch.tier_hits")
            self._consume_landed(cid)
            return data
        want = self._register_demand(cid)
        return self._await(want)

    def offer_links(self, links: "Iterable[CID]") -> None:
        """Walker hook: a HAMT/AMT interior node just decoded; its child
        links become low-priority wants (depth 1 of the speculation
        budget)."""
        self.speculate(links, depth=1)

    def speculate(self, cids: "Iterable[CID]", depth: int = 1) -> None:
        """Enter ``cids`` as speculative wants at ``depth`` (no-op beyond
        ``speculate_depth``). Never blocks, never raises: full queues drop
        (counted), local blocks short-circuit."""
        if depth > self.speculate_depth:
            return
        fresh = [c for c in cids if not self._local_has(c)]
        if not fresh:
            return
        added = dropped = 0
        with self._cond:
            if self._closed or self._fault is not None:
                return
            for cid in fresh:
                if cid in self._wants:
                    continue
                if len(self._spec_q) >= self.spec_queue_cap:
                    dropped += 1
                    continue
                self._wants[cid] = _Want(cid, speculative=True, depth=depth)
                self._spec_q.append(cid)
                added += 1
            if added:
                self._ensure_dispatchers_locked()
                self._cond.notify(added)
        if added:
            self._metrics.count("fetch.wants", added)
            self._metrics.count("fetch.speculative_wants", added)
        if dropped:
            self._metrics.count("fetch.speculative_dropped", dropped)

    def prime(self, cids: "Iterable[CID]") -> None:
        """Schedule-driven speculation: like `speculate`, but EXEMPT from
        the ``speculate_depth`` gate. The backfill work-ahead feeder calls
        this with the tipset headers of windows it KNOWS will execute —
        adaptive backoff (which watches the waste ratio of link-chasing
        guesses) must not drop certain-future demand. Primed wants still
        ride the speculative queue (bounded, droppable, counted), so a
        runaway schedule degrades into drops, never unbounded memory."""
        fresh = [c for c in cids if not self._local_has(c)]
        if not fresh:
            return
        added = dropped = 0
        with self._cond:
            if self._closed or self._fault is not None:
                return
            for cid in fresh:
                if cid in self._wants:
                    continue
                if len(self._spec_q) >= self.spec_queue_cap:
                    dropped += 1
                    continue
                self._wants[cid] = _Want(cid, speculative=True, depth=1)
                self._spec_q.append(cid)
                added += 1
            if added:
                self._ensure_dispatchers_locked()
                self._cond.notify(added)
        if added:
            self._metrics.count("fetch.wants", added)
            self._metrics.count("fetch.speculative_wants", added)
            self._metrics.count("fetch.schedule_primed", added)
        if dropped:
            self._metrics.count("fetch.speculative_dropped", dropped)

    def fetch_into(self, cids: "Iterable[CID]", into: dict) -> "dict[CID, Exception]":
        """Prefetch-wave entry point (`RpcBlockstore.prefetch` reroutes
        here): register every miss as a demand want, then collect — the
        whole wave rides the dispatcher's batch round-trips and coalesces
        with concurrent walkers. Fail-soft per CID, like `prefetch`, for
        fetch and integrity errors; a verify-lane fault raises."""
        failures: "dict[CID, Exception]" = {}
        pending: "list[tuple[CID, _Want]]" = []
        for cid in cids:
            data = self._local_get(cid)
            if data is not None:
                self._metrics.count("fetch.tier_hits")
                self._consume_landed(cid)
                into[cid] = data
                continue
            pending.append((cid, self._register_demand(cid)))
        for cid, want in pending:
            try:
                data = self._await(want)
            except Exception as exc:  # fail-soft: prefetch is advisory — collected, and the block refetched on demand
                if self._lane_fault() is exc:
                    raise
                failures[cid] = exc
                continue
            if data is not None:
                into[cid] = data
        return failures

    def stats(self) -> dict:
        """Speculation accounting for the bench leg and `--metrics`."""
        with self._cond:
            fetched, used = self._spec_fetched, self._spec_used
            return {
                "speculative_fetched": fetched,
                "speculative_used": used,
                "speculative_wasted": fetched - used,
                "waste_pct": (100.0 * (fetched - used) / fetched) if fetched else 0.0,
                "in_flight": len(self._wants),
                "speculate_depth": self.speculate_depth,
            }

    def close(self) -> None:
        """Stop dispatchers, fail outstanding demand waits, count waste."""
        with self._cond:
            if self._closed:
                threads = list(self._threads)
            else:
                self._closed = True
                for want in self._wants.values():
                    if not want.done:
                        want.done = True
                        want.error = RuntimeError("fetch plane closed")
                self._demand_q.clear()
                self._spec_q.clear()
                self._cond.notify_all()
                threads = list(self._threads)
                if not self._waste_counted:
                    self._waste_counted = True
                    wasted = self._spec_fetched - self._spec_used
                    if wasted > 0:
                        self._metrics.count("fetch.speculative_wasted", wasted)
        for t in threads:
            t.join(timeout=5.0)

    def __enter__(self) -> "FetchPlane":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- local tiers -------------------------------------------------------

    def set_local(self, local) -> None:
        """Late-bind the local tiers: the tier object usually WRAPS this
        plane's facade, so it exists only after the plane does."""
        self._local = local  # ipclint: disable=race-unannotated (wiring-time publication: called before any walker or dispatcher traffic)

    def _local_get(self, cid: CID) -> Optional[bytes]:
        local = self._local
        if local is None:
            return None
        getter = getattr(local, "get_local", None)
        if getter is not None:
            return getter(cid)
        if isinstance(local, (dict, BlockCache)):
            return local.get(cid)
        return None

    def _local_has(self, cid: CID) -> bool:
        local = self._local
        if local is None:
            return False
        has = getattr(local, "has_local", None)
        if has is not None:
            return has(cid)
        if isinstance(local, (dict, BlockCache)):
            return cid in local
        return False

    def _local_put(self, cid: CID, data: bytes) -> None:
        local = self._local
        if local is None:
            return
        put = getattr(local, "put_local", None)
        if put is not None:
            put(cid, data)
        elif isinstance(local, dict):
            local[cid] = data
        elif isinstance(local, BlockCache):
            local.put(cid, data)

    # -- want registration / waiting --------------------------------------

    def _lane_fault(self) -> Optional[Exception]:
        with self._cond:
            return self._fault

    def _register_demand(self, cid: CID) -> _Want:
        with self._cond:
            if self._fault is not None:
                raise self._fault
            if self._closed:
                raise RuntimeError("fetch plane closed")
            want = self._wants.get(cid)
            if want is not None:
                self._metrics.count("fetch.coalesced")
                want.waiters += 1
                if not want.done and want.speculative:
                    # promote: a walker is now blocked on this block. If
                    # it is still queued it moves to the demand lane and
                    # stops counting as a speculative fetch; if already in
                    # flight it stays speculative (the fetch was issued on
                    # speculation's dime — landing will count as used, and
                    # a failure re-lanes to demand in _complete because
                    # waiters > 0).
                    try:
                        self._spec_q.remove(cid)
                    except ValueError:
                        pass  # already drained into a dispatcher batch
                    else:
                        want.speculative = False
                        self._demand_q.append(cid)
                        self._cond.notify()
                return want
            want = _Want(cid, speculative=False, depth=0)
            want.waiters = 1
            self._wants[cid] = want
            self._demand_q.append(cid)
            self._metrics.count("fetch.wants")
            self._ensure_dispatchers_locked()
            self._cond.notify()
            return want

    def _await(self, want: _Want) -> Optional[bytes]:
        with self._cond:
            while not want.done:
                # bounded waits so a silently-dead dispatcher surfaces as
                # an error instead of a hang (the client's own timeouts
                # bound how long a live dispatcher can stall); the
                # checkpoint turns a cancelled/expired request's demand
                # wait into a typed abort instead of a worker parked on
                # a want nobody needs anymore
                checkpoint("fetch.demand_wait")
                self._cond.wait(1.0)
                if not want.done and not self._dispatchers_alive_locked():
                    raise RuntimeError("fetch plane dispatcher died")
            if want.speculative and not want.used and want.error is None:
                want.used = True
                self._spec_used += 1
                self._landed_spec.pop(want.cid, None)
                self._metrics.count("fetch.speculative_used")
            self._wants.pop(want.cid, None)
        if want.error is not None:
            raise want.error
        return want.data

    def _consume_landed(self, cid: CID) -> None:
        """A tier hit on a block speculation landed there: that IS the
        speculation paying off — mark the want used and retire it, or the
        waste accounting claims 100% waste on a perfectly warmed walk. A
        latched lane fault raises here too: a faulted plane serves nothing."""
        with self._cond:
            if self._fault is not None:
                raise self._fault
            want = self._wants.get(cid)
            if want is None or not want.done:
                return
            if want.speculative and not want.used and want.error is None:
                want.used = True
                self._spec_used += 1
                self._metrics.count("fetch.speculative_used")
            self._landed_spec.pop(cid, None)
            self._wants.pop(cid, None)

    @locked
    def _dispatchers_alive_locked(self) -> bool:
        return any(t.is_alive() for t in self._threads)

    @locked
    def _ensure_dispatchers_locked(self) -> None:
        if self._threads or self._closed:
            return
        for i in range(self._n_workers):
            t = threading.Thread(
                target=self._run, name=f"fetch-plane-{i}", daemon=True
            )
            self._threads.append(t)
            t.start()

    # -- dispatcher --------------------------------------------------------

    def _run(self) -> None:
        while True:
            batch = self._take_batch()
            if not batch:
                return
            try:
                with use_context(batch[0].trace_ctx):
                    self._fulfil(batch)
            except Exception as exc:  # fail-soft: a dispatcher must outlive any single batch — fail the batch's wants, keep serving
                self._fail_batch(batch, exc)

    def _take_batch(self) -> "list[_Want]":
        """Drain up to ``batch_max`` wants, demand lane first. Blocks until
        there is work; [] means the plane closed or its lane faulted."""
        with self._cond:
            while not self._closed and self._fault is None and not self._demand_q and not self._spec_q:
                self._cond.wait(0.5)
            if self._closed or self._fault is not None:
                return []
            batch: "list[_Want]" = []
            while len(batch) < self.batch_max and (self._demand_q or self._spec_q):
                cid = self._demand_q.popleft() if self._demand_q else self._spec_q.popleft()
                want = self._wants.get(cid)
                if want is not None and not want.done:
                    batch.append(want)
            return batch

    def _fulfil(self, batch: "list[_Want]") -> None:
        subset = [w.cid for w in batch]
        self._metrics.count("fetch.batches")
        self._metrics.count("fetch.batched_blocks", len(subset))
        reader = getattr(self._client, "chain_read_obj_many", None)
        blocks: "list" = []
        if reader is not None:
            try:
                blocks = reader(subset)
            except VerifyLaneError as exc:  # not fail-soft: the pool's lane faulted, which latches the plane
                self._latch_fault(exc)
                return
            except Exception:  # fail-soft: one poisoned batch must not fail unrelated wants — retry per-CID below for cid-precise typed errors
                blocks = None
        if reader is None or blocks is None:
            # waiter-attached speculative wants must NOT take the soft
            # path: an error swallowed into None would surface to the
            # demand waiter as "block absent" — a lie. They fetch
            # demand-style so failures stay typed (and re-lane via
            # _complete's waiter check).
            with self._cond:
                soft = {w.cid: w.speculative and w.waiters == 0 for w in batch}
            blocks = []
            for want in batch:
                if soft[want.cid]:
                    blocks.append(self._read_one_soft(want.cid))
                    continue
                try:
                    blocks.append(self._client.chain_read_obj(want.cid))
                except Exception as exc:  # fail-soft: captured per-want; demand waiters re-raise it typed
                    blocks.append(exc)
        verifies = getattr(self._client, "verifies_integrity", False)
        verdicts: "dict[int, bool]" = {}
        wave = [
            (i, want, data)
            for i, (want, data) in enumerate(zip(batch, blocks))
            if data is not None and not isinstance(data, Exception)
        ]
        if wave and not verifies:
            # one verify_blocks_batch call checks the whole landed wave
            try:
                oks = verify_blocks_batch(
                    [w.cid for _, w, _ in wave],
                    [d for _, _, d in wave],
                    metrics=self._metrics,
                    backend=self._backend,
                )
            except Exception as exc:  # not fail-soft: a kernel or launch fault latches the plane and reaches every caller
                self._latch_fault(exc)
                return
            verdicts = {i: ok for (i, _, _), ok in zip(wave, oks)}
        completions: "list[tuple[_Want, Optional[bytes], Optional[Exception]]]" = []
        chase: "list[tuple[bytes, int]]" = []
        for i, (want, data) in enumerate(zip(batch, blocks)):
            if isinstance(data, Exception):
                completions.append((want, None, data))
                continue
            if data is not None and not verifies and not verdicts[i]:
                if want.speculative:
                    # discard before anything can observe it; the demand
                    # path will refetch-and-raise with endpoint blame
                    self._metrics.count("fetch.speculative_integrity_drops")
                    completions.append((want, None, _DISCARD))
                    continue
                self._metrics.count("rpc.integrity_failures")
                err = IntegrityError(want.cid, getattr(self._client, "endpoint", "?"))
                completions.append((want, None, err))
                continue
            if data is not None:
                self._local_put(want.cid, data)
                if want.speculative and want.depth < self.speculate_depth:
                    chase.append((data, want.depth))
            completions.append((want, data, None))
        self._complete(completions)
        # chase the next speculation level strictly outside the lock
        for data, depth in chase:
            self.speculate(_child_links(data), depth=depth + 1)

    def _read_one_soft(self, cid: CID) -> Optional[bytes]:
        try:
            return self._client.chain_read_obj(cid)
        except Exception:  # fail-soft: speculative fetches never raise
            return None

    def _complete(
        self,
        completions: "list[tuple[_Want, Optional[bytes], Optional[Exception]]]",
    ) -> None:
        with self._cond:
            if self._fault is not None:
                return  # _latch_fault already failed every want
            for want, data, error in completions:
                if error is _DISCARD or (want.speculative and error is not None):
                    if want.waiters and not want.done:
                        # a demand waiter attached while this speculative
                        # fetch was in flight (too late for _register_demand
                        # to re-lane it): re-run it on the demand lane so
                        # the waiter gets the sync walker's contract —
                        # refetch, typed error on failure — instead of
                        # waiting forever on a silently forgotten want
                        want.speculative = False
                        self._demand_q.append(want.cid)
                        self._cond.notify()
                    else:
                        # unobserved failed speculation: forget the want
                        # entirely so a later demand get re-enqueues from
                        # scratch
                        self._wants.pop(want.cid, None)
                    continue
                want.data = data
                want.error = error
                want.done = True
                if want.speculative:
                    self._spec_fetched += 1
                    if data is not None:
                        self._landed_spec[want.cid] = None
                    else:
                        self._wants.pop(want.cid, None)
            # bound the landed-speculative set: evict FIFO (oldest first);
            # evicted blocks count toward waste via fetched-vs-used
            while len(self._landed_spec) > self.landed_cap:
                evicted, _ = self._landed_spec.popitem(last=False)
                self._wants.pop(evicted, None)
            if self.adaptive_depth:
                self._maybe_downshift_locked()
            self._cond.notify_all()

    @locked
    def _maybe_downshift_locked(self) -> None:
        """Adaptive speculation backoff (--speculate-depth auto): once a
        window's worth of speculative fetches has landed, compare that
        window's waste ratio (fetched-but-not-yet-used over fetched)
        against the threshold and lower the depth one level when it
        spikes — atypical state shapes (wide HAMT fan-out, sparse reads)
        stop paying for deep speculation. Use-lag makes the ratio an
        overestimate, so backoff is conservative by construction; depth 0
        still batches demand fetches."""
        window = self._spec_fetched - self._auto_fetched0
        if window < self._auto_window:
            return
        used = self._spec_used - self._auto_used0
        waste_ratio = (window - used) / window
        self._auto_fetched0 = self._spec_fetched
        self._auto_used0 = self._spec_used
        if waste_ratio > self.AUTO_WASTE_THRESHOLD and self.speculate_depth > 0:
            self.speculate_depth -= 1  # ipclint: disable=race-unannotated (lowered only here under _cond; unlocked readers tolerate one stale wave — backoff, not correctness)
            self._metrics.count("fetch.speculate_depth_downshifts")

    def _fail_batch(self, batch: "list[_Want]", exc: Exception) -> None:
        self._complete([(w, None, exc) for w in batch])

    def _latch_fault(self, exc: Exception) -> None:
        """The verify lane raised: a broken card, not a lying node. Latch
        the first such fault and fail every outstanding want with it,
        speculative ones included, so no later wave can pass on the host
        lane while the card is failing; dispatchers then exit."""
        with self._cond:
            if self._fault is None:
                self._fault = exc
            for want in self._wants.values():
                if not want.done:
                    want.done = True
                    want.error = self._fault
            self._demand_q.clear()
            self._spec_q.clear()
            self._cond.notify_all()


class PlaneBlockstore:
    """`Blockstore`-shaped facade over a `FetchPlane` — drops in where
    `RpcBlockstore` sits so everything above (caches, tiers, recording
    wrappers, drivers) is unchanged. Forwards `offer_links` (walker
    speculation) and `prefetch` (batched waves) to the plane."""

    def __init__(self, plane: FetchPlane):
        self._plane = plane

    def get(self, cid: CID) -> Optional[bytes]:
        return self._plane.get(cid)

    def has(self, cid: CID) -> bool:
        return self._plane.get(cid) is not None

    def put_keyed(self, cid: CID, data: bytes) -> None:
        raise NotImplementedError("PlaneBlockstore is read-only")

    def offer_links(self, links: "Iterable[CID]") -> None:
        self._plane.offer_links(links)

    def prefetch(self, cids: "Iterable[CID]", into: dict) -> "dict[CID, Exception]":
        return self._plane.fetch_into(cids, into)

    def close(self) -> None:
        self._plane.close()
