"""Standing-query matcher: the follower's tipset-finalized hook.

On each finalized tipset the matcher forms the (previous, current)
`TipsetPair` and compiles the active subscription set down to its
**distinct filters** — generation cost scales with filters, never with
subscribers (``subs.generations`` counts exactly one per (pair, filter);
the bench gate asserts generations per tipset ≤ distinct filters).

Each distinct filter generates through the SAME driver the
request/response path uses (`generate_event_proofs_for_range_chunked`
with the service's chunk size and match backend), so a pushed bundle is
byte-identical to what `/v1/generate_range` would return for the same
(pair, filter). Distinct filters generate concurrently, and when the
match backend speaks the fp-mask protocol their per-chunk device
predicate calls route through ONE shared
`parallel.pipeline.MatchCoalescer` — one batched device match dispatch
serves every subscriber of the tipset.

Delta delivery (the witness diet): the matcher keeps each
filter's previous (digest, CID set) and, when a subscriber's acked base
(`DeliveryLog.acked_base`) is exactly that digest, ships a
``bundle_delta`` payload — only the blocks the base doesn't hold — via
`ipc_proofs_tpu_torch.witness.delta`. Consecutive epochs share HAMT/AMT
interiors, so a subscriber who acked epoch N receives a fraction of epoch
N+1's bytes. Any base mismatch (lagging sub, restart, compaction) falls
back to the full bundle with ``witness.delta_fallbacks`` counted.

Everything here is fail-soft: a filter whose generation raises counts
``subs.errors`` and the other filters still deliver; the follower's hook
wrapper catches the rest (``follow.errors``) so the follow loop never
stalls on the streaming plane.

The counterpart of ``ipc_proofs_tpu.subs.matcher``: the same deliveries,
payload bytes and digests, with every generation's event mask on the
port's `GpuBackend` — the service's, on its PUSH
lane, or ``match_backend`` (the card when None) without a service. One
departure, by design: a fault of the card (`ops.build.is_device_fault`)
is not one filter's failure. It is not counted in ``subs.errors`` nor
skipped: it raises out of `match_pair` before this tipset appends any
delivery, and the port's follower stops on it (its ``fault``) instead of
ticking ``follow.errors``. Nothing falls back to the host.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

from ipc_proofs_tpu_torch.ops.build import is_device_fault
from ipc_proofs_tpu_torch.proofs.bundle import bundle_obj_digest
from ipc_proofs_tpu_torch.proofs.generator import EventProofSpec, StorageProofSpec
from ipc_proofs_tpu_torch.subs.registry import Subscription, filter_key
from ipc_proofs_tpu_torch.utils.lockdep import named_lock
from ipc_proofs_tpu_torch.utils.log import get_logger
from ipc_proofs_tpu_torch.utils.metrics import Metrics, get_metrics

__all__ = ["StandingQueryMatcher"]

logger = get_logger(__name__)


class _CoalescingBackend:
    """Backend proxy routing fp-mask calls through one shared coalescer.

    Concurrent per-filter generations each scan the same tipset pair;
    wrapping the backend so ``event_match_mask_fp`` is a shared
    `MatchCoalescer.match_fp` (a documented drop-in for it) folds their
    simultaneous predicate calls into one batched device dispatch.
    Every other attribute (mesh, flat/fused entry points, ...) delegates
    to the real backend, and the coalescer's masks are bit-identical to
    unbatched calls (elementwise predicate), so bundles don't change.
    """

    def __init__(self, backend, metrics: Optional[Metrics] = None):
        from ipc_proofs_tpu_torch.parallel.pipeline import MatchCoalescer

        self._backend = backend
        self.event_match_mask_fp = MatchCoalescer(backend, metrics=metrics).match_fp

    def __getattr__(self, name):
        return getattr(self._backend, name)


# Content digest of a bundle's canonical JSON — the idempotency-key
# ingredient that makes matcher replays of a (pair, filter) dedup, and the
# delta-witness base identity (kept under its historical name; the shared
# definition lives beside the bundle type).
_bundle_digest = bundle_obj_digest


class StandingQueryMatcher:
    """Compiles the active filter set against each finalized tipset pair."""

    def __init__(
        self,
        registry,
        log,
        push,
        store,
        metrics: Optional[Metrics] = None,
        chunk_size: int = 8,
        match_backend=None,
        gen_workers: int = 2,
        delta: bool = True,
        service=None,
        provenance=None,
        fleet: str = "default",
    ):
        self._registry = registry
        self._log = log
        self._push = push
        self._store = store
        # provenance registry (ipc_proofs_tpu_torch/registry/): every pushed
        # bundle seals a serve record (whose CID set feeds the fleet base
        # directory), and the delta fallback consults that directory so a
        # base acked against ANOTHER shard — or against this one before a
        # restart — still cuts a delta instead of re-shipping full bytes
        self._provenance = provenance
        self.fleet = fleet
        # with a ProofService attached, generations ride its batcher's
        # PUSH lane (`submit_range_window(lane="push")`) instead of this
        # matcher's private executor — one priority order across
        # interactive requests, standing-query pushes and backfill windows
        # instead of two planes competing blindly for the same workers
        self._service = service
        self._metrics = metrics if metrics is not None else get_metrics()
        self.chunk_size = max(1, int(chunk_size))
        self.delta = bool(delta)
        if match_backend is not None and hasattr(match_backend, "event_match_mask_fp"):
            match_backend = _CoalescingBackend(match_backend, metrics=self._metrics)
        self._backend = match_backend
        self._executor = ThreadPoolExecutor(
            max_workers=max(1, int(gen_workers)), thread_name_prefix="subs-match"
        )
        self._lock = named_lock("StandingQueryMatcher._lock")
        self._prev = None  # guarded-by: _lock (previous finalized tipset)
        self._closed = False  # guarded-by: _lock
        # delta-witness bases: filter key → (digest, frozenset of raw CIDs)
        # of the PREVIOUS cycle's bundle. In-memory only — after a restart
        # the first cycle ships full bundles (witness.delta_fallbacks), the
        # documented sound degradation.
        self._filter_bases: Dict[str, Tuple[str, frozenset]] = {}  # guarded-by: _lock

    def on_tipset(self, tipset) -> int:
        """The `ChainFollower` finalized hook: pair this tipset with the
        previous one and match. Returns deliveries appended."""
        with self._lock:
            if self._closed:
                return 0
            prev, self._prev = self._prev, tipset
        if prev is None or tipset.height <= prev.height:
            return 0  # first observation (no pair yet) or a replayed height
        from ipc_proofs_tpu_torch.proofs.range import TipsetPair

        return self.match_pair(TipsetPair(parent=prev, child=tipset))

    def match_pair(self, pair) -> int:
        """One matching cycle: re-push stragglers, generate once per
        distinct filter, fan the bundles out."""
        subs = self._registry.active()
        self._metrics.count("subs.tipsets_matched")
        # Convergence first: deliveries whose webhook failed on an earlier
        # cycle re-enqueue before this tipset's new work.
        self._push.repush_pending(self._registry)
        if not subs:
            return 0
        groups: Dict[str, Tuple[dict, List[Subscription]]] = {}
        for sub in subs:
            fkey = filter_key(sub.filter)
            if fkey not in groups:
                groups[fkey] = (sub.filter, [])
            groups[fkey][1].append(sub)
        futures = {
            fkey: self._executor.submit(self._generate, filt, pair)
            for fkey, (filt, _members) in groups.items()
        }
        results = {}
        for fkey, fut in futures.items():
            try:
                results[fkey] = fut.result()
            except Exception as exc:  # fail-soft: one filter's generation failure must not starve the other filters' subscribers
                if is_device_fault(exc):
                    # the card's fault: nothing of this tipset is
                    # delivered, and the caller (the follower) stops on it
                    for other in futures.values():
                        other.cancel()
                    raise
                self._metrics.count("subs.errors")
                logger.warning("standing-query generation failed: %s", exc)
        appended = 0
        for fkey, result in results.items():
            if result is None:
                self._metrics.count("subs.empty_matches")
                continue
            bundle, payload, digest = result
            if self._provenance is not None:
                try:
                    self._provenance.append_served(
                        digest, key=fkey, verdict="pushed",
                        cids=bundle.cid_set(),
                    )
                except Exception:  # fail-soft: a registry write failure must never block the push
                    self._metrics.count("registry.append_failures")
            with self._lock:
                prev = self._filter_bases.get(fkey)
            # one delta per (filter, base) serves every subscriber parked
            # on that base — same amortization as the generate-once rule
            deltas: Dict[str, Tuple[dict, str]] = {}
            for sub in groups[fkey][1]:
                pay, pdigest = payload, digest
                if self.delta:
                    pay, pdigest = self._delta_payload(
                        sub, bundle, payload, digest, prev, deltas
                    )
                d = self._log.append(
                    sub.sub_id,
                    pair.child.height,
                    digest,
                    pay,
                    payload_digest=pdigest,
                )
                if d is None:
                    continue  # idempotent replay of a served (pair, filter)
                self._metrics.count("subs.notifications")
                appended += 1
                self._push.push(sub, d)
            with self._lock:
                self._filter_bases[fkey] = (digest, bundle.cid_set())
        return appended

    def _delta_payload(
        self, sub, bundle, payload: dict, digest: str, prev, deltas: dict
    ) -> "Tuple[dict, str]":
        """Pick full vs delta for one subscriber.

        A delta ships ONLY when the sub's acked base (the bundle it
        provably expanded — `DeliveryLog.acked_base`) is exactly the
        filter's previous digest, whose CID set we still hold. Any
        mismatch — sub lagging, matcher restarted, base compacted away —
        falls back to the full bundle and counts
        ``witness.delta_fallbacks``: degradation, never a wrong delta.
        """
        base = self._log.acked_base(sub.sub_id)
        if base is None and self._provenance is not None:
            # fresh delivery log (failover takeover): the fleet directory
            # still knows the base THIS subscriber last acked — recorded
            # by whichever shard served it — so the delta survives the
            # shard that held the local acked state
            try:
                base = self._provenance.fleet_acked_base(
                    self.fleet, filter_key(sub.filter), sub.sub_id
                )
            except Exception:  # fail-soft: directory trouble degrades to a full bundle, never an error
                base = None
        if base is None or base == digest:
            return payload, digest  # nothing held yet / replay of same bundle
        if prev is not None and base == prev[0]:
            base_cids = prev[1]
        else:
            # local miss (matcher restarted, base compacted, or the sub
            # last acked against another shard): the fleet base directory
            # may still know the base's CID set via ANY shard's serve
            # record — a hit keeps the delta alive across failover
            base_cids = None
            if self._provenance is not None:
                try:
                    base_cids = self._provenance.lookup_base(base)
                except Exception:  # fail-soft: directory trouble degrades to a full bundle, never an error
                    base_cids = None
                self._metrics.count(
                    "witness.fleet_base_hits"
                    if base_cids is not None
                    else "witness.fleet_base_misses"
                )
            if base_cids is None:
                self._metrics.count("witness.delta_fallbacks")
                return payload, digest
        if base not in deltas:
            from ipc_proofs_tpu_torch.witness.delta import encode_delta

            dobj = encode_delta(
                bundle, base_cids, base, digest=digest, metrics=self._metrics
            )
            deltas[base] = ({"bundle_delta": dobj}, f"delta:{base}:{digest}")
        self._metrics.count("witness.delta_hits")
        return deltas[base]

    def _generate(self, filt: dict, pair):
        """One generation per distinct (pair, filter) — the amortized unit."""
        from ipc_proofs_tpu_torch.proofs.range import (
            generate_event_proofs_for_range_chunked,
        )

        spec = EventProofSpec(
            event_signature=filt["signature"],
            topic_1=filt.get("topic1"),
            actor_id_filter=filt.get("actor_id"),
        )
        storage_specs = None
        if "slot" in filt:
            storage_specs = [
                StorageProofSpec(
                    actor_id=filt["actor_id"], slot=bytes.fromhex(filt["slot"])
                )
            ]
        if self._service is not None:
            # unified priority lane: the service's batcher orders this
            # push ahead of interactive batches, and the canonical
            # chunked driver keeps the bytes identical to the direct call
            bundle = self._service.submit_range_window(
                [pair],
                chunk_size=self.chunk_size,
                lane="push",
                spec=spec,
                storage_specs=storage_specs,
            ).result()
        else:
            bundle = generate_event_proofs_for_range_chunked(
                self._store,
                [pair],
                spec,
                chunk_size=self.chunk_size,
                match_backend=self._backend,
                metrics=self._metrics,
                storage_specs=storage_specs,
            )
        self._metrics.count("subs.generations")
        if not bundle.event_proofs and not bundle.storage_proofs:
            return None
        bundle_obj = bundle.to_json_obj()
        return bundle, {"bundle": bundle_obj}, _bundle_digest(bundle_obj)

    def drain(self) -> None:
        """Stop matching and wait for in-flight generations."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._executor.shutdown(wait=True)
