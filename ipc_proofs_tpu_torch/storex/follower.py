"""`ChainFollower`: tail finalized tipsets, pre-warm the tiered store.

The counterpart of ``ipc_proofs_tpu.storex.follower``. A daemon thread
polls the chain head (``Filecoin.ChainHead``) and walks every newly
finalized height through `Tipset.fetch`, prefetching the blocks a proof
request touches first into the local tiers via
`TieredBlockstore.put_local`:

- the block header CIDs of the tipset itself;
- each header's ``parent_state_root``, ``parent_message_receipts`` and
  ``messages`` roots;
- one level of IPLD links under the state root and receipts root (the top
  of the state-HAMT and receipts-AMT spines every claim walk starts from),
  and a bounded second ring below it.

By the time a user asks about a finalized tipset, the spine is already on
disk and the request completes without a single RPC block fetch.

Every landed prefetch wave is multihash-verified BEFORE it is stored, in
ONE `ops.verify.verify_blocks_batch` call on ``backend`` (default the card,
`get_backend("gpu")`, which raises without CUDA); the lane's crossover and
its two-block minimum decide which blocks reach the card. A client that
verifies itself (an `EndpointPool`, ``verifies_integrity``) is trusted and
the follower skips its own check. The reference's ``batch_verify`` switch
is gone: there is no host-only wave path. A block fetched alone (a client
without batch reads, or after a failed batch) verifies on the lane's
one-block case, `store.rpc.verify_block_bytes`.

Fail-soft for the store only: a head poll, tipset fetch or block fetch
that fails with a store error (`ConnectionError`, `TimeoutError`,
`OSError`, `RpcError`, `IntegrityError`, `DegradedError`, a `ValueError`
from decoding, or a `RuntimeError` raised from one of them, as a client's
exhausted retries are) and a rejected block are counted as
``follow.errors`` and retried on the next poll. A fault of the verify lane
or the backend (a `RuntimeError` of its own) is not a store error: it
raises out of `poll_once`, and stops the daemon thread (`fault`), rather
than being retried for ever. Hooks stay fail-soft but for a fault of the
card, which stops the thread the same way.

Works against anything with ``request``/``chain_read_obj`` — a
`LotusClient`, an `EndpointPool`, or a test fake over a fixture world.
"""

from __future__ import annotations

import os
import random
import threading
from typing import Callable, Optional

try:
    import fcntl
except ImportError:  # pragma: no cover - non-POSIX: leader election degrades to always-win
    fcntl = None

from ipc_proofs_tpu_torch.core.cid import CID
from ipc_proofs_tpu_torch.core.dagcbor import decode as dagcbor_decode
from ipc_proofs_tpu_torch.ops.build import is_device_fault
from ipc_proofs_tpu_torch.ops.verify import verify_blocks_batch
from ipc_proofs_tpu_torch.proofs.chain import Tipset
from ipc_proofs_tpu_torch.store.failover import is_store_error
from ipc_proofs_tpu_torch.store.rpc import verify_block_bytes
from ipc_proofs_tpu_torch.utils.lockdep import named_lock, note_flock_acquired
from ipc_proofs_tpu_torch.utils.log import get_logger

__all__ = ["ChainFollower", "FollowLeaderLock"]

logger = get_logger(__name__)

def _is_store_error(exc: BaseException) -> bool:
    """A store error, or a `ValueError` from decoding a block or a tipset:
    counted as ``follow.errors`` and retried next poll. A verify-lane or
    backend fault is neither."""
    return is_store_error(exc, also=(ValueError,))


class FollowLeaderLock:
    """Single-follower election for a shared ``--store-dir``.

    When N serve shards share one disk tier, exactly one of them should
    tail the chain (N followers would fetch every spine block N times and
    race each other's puts for nothing). Election is an ``fcntl.flock``
    on ``<root>/follow.leader.lock``: the winner holds the lock for its
    lifetime, losers skip starting their follower, and the kernel releases
    the lock when the holder dies — so a crashed leader's successor wins
    the very next election with no timeouts or heartbeats. Winning is
    counted as ``follow.leader_elections``.

    On platforms without ``fcntl`` every candidate "wins" (honest
    degradation: a duplicated follower wastes fetches, never corrupts —
    puts are content-addressed).
    """

    def __init__(self, root: str, name: str = "follow.leader.lock"):
        os.makedirs(root, exist_ok=True)
        self.path = os.path.join(root, name)
        self._fh = None

    def try_acquire(self, metrics=None) -> bool:
        """Non-blocking election attempt; True iff this process leads."""
        if self._fh is not None:
            return True  # already held
        if fcntl is None:  # pragma: no cover - non-POSIX
            self._fh = open(self.path, "ab")
            return True
        fh = open(self.path, "ab")
        try:
            fcntl.flock(fh.fileno(), fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            fh.close()
            return False  # another process leads
        self._fh = fh
        # a lifetime lease, not a scoped hold: witness it in the lockdep
        # order graph without pushing a stack frame
        note_flock_acquired("follow.leader")
        if metrics is None:
            from ipc_proofs_tpu_torch.utils.metrics import get_metrics

            metrics = get_metrics()
        metrics.count("follow.leader_elections")
        return True

    def release(self) -> None:
        fh = self._fh
        self._fh = None
        if fh is not None:
            fh.close()  # closing the fd releases the flock

    @property
    def held(self) -> bool:
        return self._fh is not None

    def __enter__(self) -> "FollowLeaderLock":
        return self

    def __exit__(self, *exc) -> None:
        self.release()


# cap on first-level links walked under each root block: the spine top is
# what latency cares about (deeper nodes load on demand); an adversarially
# wide node must not turn one poll into an unbounded crawl
_MAX_LINKS_PER_ROOT = 32

# cap on SECOND-level links per tipset (the ring below the spine top): most
# walk misses sit one level below the spine top, but 32 roots × 32 links
# squared is an unbounded crawl without a hard per-tipset budget
_MAX_SECOND_LEVEL = 256


def _first_level_links(data: bytes) -> "list[CID]":
    """The CID links directly inside one DAG-CBOR block, document order,
    bounded by `_MAX_LINKS_PER_ROOT`. Undecodable blocks yield []."""
    try:
        obj = dagcbor_decode(data)
    except Exception:  # fail-soft: a non-CBOR root (raw block) simply has no links to follow
        return []
    links: "list[CID]" = []
    stack = [obj]
    while stack and len(links) < _MAX_LINKS_PER_ROOT:
        node = stack.pop(0)
        if isinstance(node, CID):
            links.append(node)
        elif isinstance(node, (list, tuple)):
            stack.extend(node)
        elif isinstance(node, dict):
            # deterministic order: sorted keys (dict order is insertion
            # order from the decoder, but sorting costs nothing and pins it)
            stack.extend(node[k] for k in sorted(node))
    return links


class ChainFollower:
    """Daemon thread that keeps the tiered store warm along the chain.

    ``lag`` holds the follower ``lag`` epochs behind the reported head —
    tail *finalized* tipsets, not the live edge. ``start_height`` begins
    the tail at a fixed height (default: the finalized tip at first
    successful poll, i.e. follow forward only).

    ``poll_jitter`` spreads each sleep uniformly over
    ``poll_s * (1 ± poll_jitter)``: N shards tailing one Lotus endpoint
    with identical periods synchronize into a thundering herd of
    simultaneous head polls; jitter decorrelates them. Every poll is
    counted as ``follow.polls`` and the last finalized height lands in
    the ``follow.last_finalized_epoch`` gauge (surfaced by ``/healthz``).

    Finalized-tipset hooks (`add_finalized_hook`) fire once per newly
    finalized height, after its spine is warmed — the standing-query
    matcher rides this. A raising hook is fail-soft (``follow.errors``):
    it never stalls the follow loop or blocks later heights — unless what
    it raised is a fault of the card (`ops.build.is_device_fault`), which
    raises out of `poll_once` with the height not advanced and stops the
    daemon thread like a lane fault.
    """

    def __init__(
        self,
        client,
        store,
        metrics=None,
        poll_s: float = 15.0,
        lag: int = 1,
        start_height: Optional[int] = None,
        max_tipsets_per_poll: int = 16,
        poll_jitter: float = 0.1,
        rng: Optional[random.Random] = None,
        backend=None,
    ):
        self._client = client
        self._store = store
        if backend is None:
            from ipc_proofs_tpu_torch.backend import get_backend

            backend = get_backend("gpu")
        self._backend = backend  # the verify lane of every landed wave
        backend.warm()  # nvcc now, before the daemon thread reads
        if metrics is None:
            from ipc_proofs_tpu_torch.utils.metrics import get_metrics

            metrics = get_metrics()
        self._metrics = metrics
        self.poll_s = poll_s
        self.poll_jitter = min(0.9, max(0.0, float(poll_jitter)))
        self._rng = rng if rng is not None else random.Random()
        self.lag = max(0, int(lag))
        self.max_tipsets_per_poll = max(1, int(max_tipsets_per_poll))
        self._lock = named_lock("ChainFollower._lock")
        self._next_height: Optional[int] = start_height  # guarded-by: _lock
        self._thread: Optional[threading.Thread] = None  # guarded-by: _lock
        self._hooks: "list[Callable]" = []  # guarded-by: _lock
        self._fault: Optional[BaseException] = None  # guarded-by: _lock
        self._stop = threading.Event()

    def add_finalized_hook(self, hook: Callable) -> None:
        """Register ``hook(tipset)`` to fire once per finalized height."""
        with self._lock:
            self._hooks.append(hook)

    # -- lifecycle --------------------------------------------------------

    def start(self) -> None:
        with self._lock:
            if self._thread is not None:
                return
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="chain-follower", daemon=True
            )
            self._thread.start()

    def stop(self, timeout_s: float = 5.0) -> None:
        with self._lock:
            thread = self._thread
            self._thread = None
        self._stop.set()
        if thread is not None:
            thread.join(timeout=timeout_s)

    def _poll_delay(self) -> float:
        """One jittered sleep: uniform over ``poll_s * (1 ± poll_jitter)``."""
        if self.poll_jitter <= 0.0:
            return self.poll_s
        return self.poll_s * (1.0 + self._rng.uniform(-self.poll_jitter, self.poll_jitter))

    @property
    def fault(self) -> Optional[BaseException]:
        """The lane or backend fault that stopped the daemon thread, if any."""
        with self._lock:
            return self._fault

    def _run(self) -> None:
        while not self._stop.wait(self._poll_delay()):
            try:
                self.poll_once()
            except Exception as exc:  # not fail-soft beyond the store: poll_once counts store errors itself
                if _is_store_error(exc):
                    self._metrics.count("follow.errors")
                    continue
                with self._lock:
                    self._fault = exc
                logger.error("chain follower stopped: %s", exc)
                return

    # -- one poll (synchronous — tests drive this directly) ---------------

    def poll_once(self) -> int:
        """Advance over newly finalized tipsets; returns tipsets warmed.

        Idempotent on an unchanged head: no per-height work runs and no
        finalized hooks fire — the matcher's exactly-once-per-height
        contract rides on this. A store error is counted and retried next
        poll; a verify-lane or backend fault raises.
        """
        self._metrics.count("follow.polls")
        try:
            head = self._client.request("Filecoin.ChainHead", [])
            head_height = int(head["Height"])
        except Exception as exc:  # fail-soft for store errors (and a malformed head): counted and retried next tick
            if not (_is_store_error(exc) or isinstance(exc, (KeyError, TypeError))):
                raise
            self._metrics.count("follow.errors")
            logger.warning("chain follower: head poll failed (%s)", exc)
            return 0
        target = head_height - self.lag
        with self._lock:
            if self._next_height is None:
                self._next_height = target  # follow forward from the tip
            nxt = self._next_height
        done = 0
        while nxt <= target and done < self.max_tipsets_per_poll:
            if self._stop.is_set():
                break
            try:
                tipset = Tipset.fetch(self._client, nxt)
                self.prefetch_tipset(tipset)
            except Exception as exc:  # fail-soft for store errors only: one bad height is counted and retried next poll
                if not _is_store_error(exc):
                    raise  # a kernel or launch fault: never a follow.errors tick
                self._metrics.count("follow.errors")
                logger.warning(
                    "chain follower: prefetch of height %d failed (%s)", nxt, exc
                )
                break
            self._metrics.count("follow.tipsets")
            self._metrics.set_gauge("follow.last_finalized_epoch", tipset.height)
            self._fire_hooks(tipset)
            nxt += 1
            done += 1
            with self._lock:
                self._next_height = nxt
        return done

    def _fire_hooks(self, tipset: Tipset) -> None:
        with self._lock:
            hooks = list(self._hooks)
        for hook in hooks:
            try:
                hook(tipset)
            except Exception as exc:  # fail-soft: a broken subscriber plane must not stall chain following
                if is_device_fault(exc):
                    raise  # the card's fault (a push's kernels): the follower stops on it
                self._metrics.count("follow.errors")
                logger.warning(
                    "chain follower: finalized hook failed at height %d (%s)",
                    tipset.height,
                    exc,
                )

    # -- block plumbing ---------------------------------------------------

    def _put_local(self, cid: CID, data: bytes) -> None:
        put = getattr(self._store, "put_local", None)
        if put is not None:
            put(cid, data)
        else:
            self._store.put_keyed(cid, data)

    def _fetch_block(self, cid: CID) -> Optional[bytes]:
        """Fetch + verify + store one block; returns its bytes (None when
        it was already local or the endpoint had nothing)."""
        has_local = getattr(self._store, "has_local", None)
        if has_local is not None and has_local(cid):
            return None
        data = self._client.chain_read_obj(cid)
        if data is None:
            return None
        if not getattr(self._client, "verifies_integrity", False):
            if not verify_block_bytes(cid, data):
                # a lying endpoint must not poison the disk tier; skip the
                # block (demand path will fetch-and-verify with retries)
                self._metrics.count("follow.errors")
                logger.warning("chain follower: %s failed verification — skipped", cid)
                return None
        self._put_local(cid, data)
        self._metrics.count("follow.blocks_prefetched")
        return data

    def _fetch_blocks(self, cids: "list[CID]") -> "dict[CID, bytes]":
        """Batched `_fetch_block`: already-local CIDs are skipped, the rest
        ship as ONE `chain_read_obj_many` wave when the client speaks batch
        framing (sequential otherwise). Returns cid → bytes for blocks
        fetched by THIS call (already-local and missing blocks are absent).
        Same verify-before-store rule as the scalar path."""
        has_local = getattr(self._store, "has_local", None)
        todo: "list[CID]" = []
        seen: "set[CID]" = set()
        for cid in cids:
            if cid in seen:
                continue
            seen.add(cid)
            if has_local is not None and has_local(cid):
                continue
            todo.append(cid)
        out: "dict[CID, bytes]" = {}
        if not todo:
            return out
        blocks = None
        reader = getattr(self._client, "chain_read_obj_many", None)
        if reader is not None:
            try:
                blocks = reader(todo)
            except Exception as exc:  # fail-soft for store errors: fall through to the scalar path — prefetch is advisory
                if not _is_store_error(exc):
                    raise  # the pool's lane faulted (VerifyLaneError), or the card did
                self._metrics.count("follow.errors")
                logger.warning("chain follower: batch fetch failed (%s)", exc)
        if blocks is None:
            for cid in todo:
                data = self._fetch_block(cid)
                if data is not None:
                    out[cid] = data
            return out
        verifies = getattr(self._client, "verifies_integrity", False)
        landed = [(cid, data) for cid, data in zip(todo, blocks) if data is not None]
        if verifies or not landed:
            oks = [True] * len(landed)
        else:
            # the whole wave's multihashes in one lane call, outside the
            # fetch's fail-soft net: a kernel or launch fault raises
            oks = verify_blocks_batch(
                [c for c, _ in landed], [d for _, d in landed],
                metrics=self._metrics, backend=self._backend,
            )
        for (cid, data), ok in zip(landed, oks):
            if not ok:
                self._metrics.count("follow.errors")
                logger.warning(
                    "chain follower: %s failed verification — skipped", cid
                )
                continue
            self._put_local(cid, data)
            self._metrics.count("follow.blocks_prefetched")
            out[cid] = data
        return out

    def prefetch_tipset(self, tipset: Tipset) -> None:
        """Warm every spine block of one tipset (public: tests and the
        bench drive this directly with fixture tipsets, no RPC tail)."""
        spine: "list[CID]" = list(tipset.cids)
        roots: "list[CID]" = []
        for header in tipset.blocks:
            spine.append(header.parent_state_root)
            spine.append(header.parent_message_receipts)
            spine.append(header.messages)
            roots.append(header.parent_state_root)
            roots.append(header.parent_message_receipts)
        self._fetch_blocks(spine)
        seen: "set[CID]" = set(spine)
        # first level under the state/receipts roots: the HAMT/AMT spine
        # top every walk descends through first
        level1: "list[CID]" = []
        for root in dict.fromkeys(roots):
            data = self._root_bytes(root)
            if data is None:
                continue
            for link in _first_level_links(data):
                if link not in seen:
                    seen.add(link)
                    level1.append(link)
        fetched = self._fetch_blocks(level1)
        # second level: the next ring of HAMT/AMT interior nodes, where the
        # walk misses concentrate at depth 1. Expand only blocks available locally (just fetched, or already in
        # the tiers) — never demand-read through RPC just to find links
        level2: "list[CID]" = []
        get_local = getattr(self._store, "get_local", None)
        for cid in level1:
            if len(level2) >= _MAX_SECOND_LEVEL:
                break
            data = fetched.get(cid)
            if data is None and get_local is not None:
                data = get_local(cid)
            if data is None:
                continue
            for link in _first_level_links(data):
                if len(level2) >= _MAX_SECOND_LEVEL:
                    break
                if link not in seen:
                    seen.add(link)
                    level2.append(link)
        if level2:
            self._fetch_blocks(level2)

    def _root_bytes(self, root: CID) -> Optional[bytes]:
        getter = getattr(self._store, "get", None)
        if getter is not None:
            try:
                return getter(root)
            except Exception as exc:  # fail-soft for store errors: a read error only skips link expansion for this root
                if not _is_store_error(exc):
                    raise
                self._metrics.count("follow.errors")
                return None
        return None
