"""Long-running proof service: micro-batched verify/generate with drain.

The counterpart of ``ipc_proofs_tpu.serve.service``. `ProofService` is the
in-process API (the HTTP front end in `serve/httpd.py` is a thin shim over
it). Two independent `MicroBatcher`s feed the batch engines,
which run their kernels on the card: the service builds ONE `GpuBackend`
(``get_backend("gpu", device=config.device, mesh_devices=...)``) and hands
it to the range drivers, the fetch plane, the segment store and
`verify_proof_bundle`, so the CID batches and masks of a micro-batch are
one launch set on that backend. ``device="cpu"`` runs the kernels' plain
versions (the tests); there is no host-only path.

- **verify**: N individual `UnifiedProofBundle`s merge into ONE bundle —
  witness blocks deduplicated, proofs concatenated in request order — and
  a single `verify_proof_bundle` call replays them all (grouped event
  replay + batched storage walk, the TxMeta CIDs and, with
  ``verify_witness_cids``, the whole merged witness recomputed as one
  blake2b batch on the card). Per-request verdicts are split back out
  by position. Requests whose witness blocks CONFLICT (same CID, different
  bytes — one of them is lying) are partitioned into compatible sub-merges
  rather than letting one forged block poison a neighbor's verdict.
- **generate**: N individual tipset-pair requests deduplicate into one
  pair list for `generate_event_proofs_for_range` (one device match call
  for the whole micro-batch, on the card). Each response carries its own pair's proofs
  — bit-identical to generating that pair alone — plus the micro-batch's
  shared deduplicated witness (a sound superset: every response bundle
  verifies independently; batching trades some response bytes for the
  shared scan).

All workers share one `CachedBlockstore` over the chain store, backed by a
`BlockCache` (size-capped + TTL) so the cache survives millions of
requests without becoming a slow OOM. With ``store_dir`` set the cache
grows a second, disk-resident tier (`storex.TieredBlockstore` over a
`SegmentStore`): blocks fetched once survive restarts and are shared by
every worker, so a warm tipset serves with zero upstream RPC fetches.
Every multi-block read of the disk tier and every landed fetch wave is
verified on the service's backend; the reference's ``batch_verify`` switch
(host-side verification of fetched blocks) has no counterpart here.

Verification policy (trust policy, event filter, witness-CID checking) is
service-level configuration, fixed at startup: a real deployment serves
one subnet's trust root, and batching is only sound when every request in
a merge is judged under the same policy.
"""

from __future__ import annotations

import hashlib
import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from time import monotonic
from typing import Optional, Sequence

from ipc_proofs_tpu_torch.backend import get_backend
from ipc_proofs_tpu_torch.core.cid import CID
from ipc_proofs_tpu_torch.proofs.bundle import ProofBlock, UnifiedProofBundle
from ipc_proofs_tpu_torch.proofs.range import (
    TipsetPair,
    generate_event_proofs_for_range,
    generate_event_proofs_for_range_chunked,
    generate_event_proofs_for_range_pipelined,
)
from ipc_proofs_tpu_torch.obs.trace import (
    format_span_tree,
    spans_for_trace,
    use_context,
)
from ipc_proofs_tpu_torch.proofs.trust import TrustPolicy
from ipc_proofs_tpu_torch.proofs.verifier import verify_proof_bundle
from ipc_proofs_tpu_torch.serve.batcher import (
    MicroBatcher,
    PendingResult,
    ServiceClosedError,
)
from ipc_proofs_tpu_torch.store.blockstore import BlockCache, CachedBlockstore
from ipc_proofs_tpu_torch.utils.deadline import use_scope
from ipc_proofs_tpu_torch.utils.log import get_logger
from ipc_proofs_tpu_torch.utils.metrics import Metrics
from ipc_proofs_tpu_torch.utils.lockdep import named_lock
from ipc_proofs_tpu_torch.witness.bases import WitnessBaseCache

log = get_logger(__name__)

__all__ = [
    "GenerateResponse",
    "ProofService",
    "ServiceConfig",
    "VerifyResponse",
    "sequential_verify_baseline",
]


@dataclass
class ServiceConfig:
    """Tuning knobs for the serving loop (see README "Serving")."""

    max_batch: int = 32  # flush when a batch reaches this many requests…
    max_wait_ms: float = 4.0  # …or the oldest member has waited this long
    queue_capacity: int = 256  # bounded admission; beyond this → 503
    workers: int = 2  # batch-execution pool (assembly overlaps execution)
    cache_max_bytes: int = 256 * 1024 * 1024  # shared BlockCache budget
    cache_ttl_s: Optional[float] = None  # optional entry TTL
    verify_witness_cids: bool = False  # recompute witness CIDs on verify
    # multi-pair generate batches run the stage-overlapped range engine:
    # chunks of range_chunk_size pairs flow scan → record → merge (→
    # verify) with range_pipeline_depth chunks buffered between stages.
    # `threads` is the engine's ONE shared budget (--threads; partitioned
    # over stage workers + native scan fan-out by
    # utils.threads.resolve_thread_budget); range_scan_threads is the
    # legacy knob that pins the scan stage width
    range_chunk_size: int = 8
    range_scan_threads: Optional[int] = None
    range_pipeline_depth: int = 2
    threads: Optional[int] = None
    # write-ahead journal dir for generate batches: chunk commits become
    # durable/resumable and each response's Server-Timing grows a
    # `journal_ms` entry (wall time spent fsyncing chunk records)
    range_job_dir: Optional[str] = None
    # requests slower than this auto-log their span tree (flight ring) with
    # trace_id correlation and bump the serve.slow_requests counter
    slow_request_ms: float = 1000.0
    # disk tier (storex.SegmentStore) under the shared BlockCache: blocks
    # persist across restarts in append-only segment files, LRU-evicted at
    # store_cap_bytes; None keeps the memory-only CachedBlockstore
    store_dir: Optional[str] = None
    store_cap_bytes: int = 1 * 1024 * 1024 * 1024
    # roll the active segment once it reaches this size. Replication pulls
    # skip the active tail (another process may still be appending), so a
    # replicated tier wants this small enough that hot data rolls into
    # immutable segments promptly; the 64 MB default matches the
    # single-host behavior where rolling cadence is irrelevant
    store_segment_max_bytes: int = 64 * 1024 * 1024
    # owner token for a store_dir SHARED between shard daemons: each
    # process appends only to its own seg-<owner>.* segments and eviction
    # coordinates through the directory flock (see storex/segments.py).
    # None = exclusive single-writer store (the pre-cluster behavior)
    store_owner: Optional[str] = None
    # async fetch plane (store.fetchplane): when the backing store is
    # RPC-fed, interpose a want-queue so concurrent walkers' block fetches
    # ship as JSON-RPC batches and HAMT/AMT child links prefetch
    # speculatively. batch_rpc=False keeps the sync one-call-per-block
    # path; speculate_depth=0 batches without speculation
    batch_rpc: bool = True
    # "auto" starts at FetchPlane.AUTO_START_DEPTH and backs off when the
    # speculation waste ratio spikes (fetch.speculate_depth_downshifts)
    speculate_depth: "int | str" = 1
    # the card: match_backend names the service's BatchHashBackend ("gpu";
    # None is the same backend, as there is no host match path);
    # mesh_devices lays the fingerprint mask across that many local cards
    # (0 = all, None = no mesh); device None is the card, "cpu" the
    # kernels' plain versions. Every engine of the service (range drivers,
    # fetch plane, disk tier, verify) runs on this one backend
    match_backend: Optional[str] = None
    mesh_devices: Optional[int] = None
    device: Optional[str] = None
    # witness plane (witness/): delta witnesses against
    # previously served bundles and compressed framing, negotiated
    # per-request. Disabling compress makes non-identity encodings a
    # typed 400 (encoding is a contract); disabling delta silently
    # serves full bundles (delta is an optimization with a sound
    # degradation). witness_agg_max caps claims per aggregated
    # generate_range; witness_base_cache bounds the digest→CID-set LRU
    witness_delta: bool = True
    witness_compress: bool = True
    witness_agg_max: int = 1024
    witness_base_cache: int = 64
    # per-tenant QoS enforcement (serve/qos.py): token-bucket admission at
    # tenant_rate requests/s with tenant_burst headroom (default 2×rate).
    # None disables throttling — accounting (TenantLedger) still runs.
    # The micro-batcher's fair interactive lane is always on; the bucket
    # only adds the typed-429 rate limit.
    tenant_rate: Optional[float] = None
    tenant_burst: Optional[float] = None
    # per-tenant deficit weights for the batcher's fair interactive lane
    # (--tenant-weight name=N): a weight-N tenant drains up to N queued
    # requests per round-robin turn; unlisted tenants weigh 1
    tenant_weights: Optional[dict] = None
    # adaptive admission (serve/qos.py GradientLimiter, --admit-gradient):
    # AIMD concurrency limit on queue delay replaces queue_capacity as the
    # FIRST gate at the HTTP front door (the batcher capacity stays as a
    # hard backstop). delay budget is the p99 queue-delay SLO in ms.
    admit_gradient: bool = False
    admit_initial: int = 8
    admit_min: int = 2
    admit_max: int = 1024
    admit_delay_budget_ms: float = 250.0
    # deadline propagation (--deadline-floor-ms): requests whose remaining
    # budget (X-IPC-Deadline-Ms header / deadline_ms body field) is below
    # this floor are refused typed at admission instead of admitted to die
    deadline_floor_ms: float = 5.0
    # pool-wide client retry budget in tokens/s (--retry-budget; None =
    # unbudgeted). Wired into EndpointPool at daemon build time.
    retry_budget: Optional[float] = None
    # proof provenance registry (registry/): when registry_dir is set the
    # service opens reg-<registry_owner>.log under that directory, into
    # which each served bundle seals one hash-linked IPR1 frame
    # (`ProvenanceRegistry.append_served`), and witness_bases is
    # front-ended by the fleet-wide base directory (siblings sharing the
    # dir see each other's serve records). registry_fsync=False rides
    # the page cache (the <1% serve-overhead budget); True restores the
    # per-record durable contract.
    registry_dir: Optional[str] = None
    registry_owner: str = "main"
    registry_fsync: bool = False


@dataclass
class VerifyResponse:
    """Per-request verdicts, split out of the merged-batch result."""

    storage_results: list[bool]
    event_results: list[bool]
    batch_size: int  # how many requests shared the replay (observability)
    # per-request latency attribution (queue_ms / batch_wait_ms /
    # verify_ms …), computed from this request's own timestamps — the
    # components sum to the admission→completion wall
    server_timing: dict = field(default_factory=dict)
    trace_id: str = ""

    def all_valid(self) -> bool:
        return all(self.storage_results) and all(self.event_results)


@dataclass
class GenerateResponse:
    """One request's bundle: its pair's proofs + the batch's shared witness."""

    bundle: UnifiedProofBundle
    batch_size: int
    server_timing: dict = field(default_factory=dict)
    trace_id: str = ""

    @property
    def n_event_proofs(self) -> int:
        return len(self.bundle.event_proofs)


def _pair_key(pair: TipsetPair) -> tuple:
    return (
        tuple(str(c) for c in pair.parent.cids),
        tuple(str(c) for c in pair.child.cids),
    )


@dataclass
class _GenerateRequest:
    pair: TipsetPair
    key: tuple = field(init=False)

    def __post_init__(self):
        self.key = _pair_key(self.pair)


@dataclass
class _RangeWindowRequest:
    """One range window riding the generate batcher's LOW or PUSH lane.

    The payload is a whole pair list (not one pair): the window executes
    as a single chunked-driver call, so its bundle is the canonical
    bytes for exactly those pairs and folds bit-identically. ``spec`` /
    ``storage_specs`` override the service-level spec for standing-query
    pushes (one distinct filter per window); None keeps the service's."""

    pairs: list
    chunk_size: Optional[int] = None
    spec: Optional[object] = None
    storage_specs: Optional[list] = None


class ProofService:
    """Micro-batching proof server (in-process API).

    ``store`` + ``spec`` enable the generate path (omit both for a
    verify-only service); ``trust_policy`` defaults to accept-all, which —
    as everywhere else in this repo — is for development and tests only.
    """

    def __init__(
        self,
        store=None,
        spec=None,
        trust_policy: Optional[TrustPolicy] = None,
        event_filter=None,
        config: Optional[ServiceConfig] = None,
        metrics: Optional[Metrics] = None,
        endpoint_pool=None,
    ):
        self.config = config or ServiceConfig()
        self.metrics = metrics if metrics is not None else Metrics()
        self._trust = trust_policy or TrustPolicy.accept_all()
        self._event_filter = event_filter
        self._spec = spec
        # optional store.failover.EndpointPool: when the backing store is
        # RPC-fed, `health()` reports per-endpoint breaker state through it
        self._endpoint_pool = endpoint_pool
        # the one backend every engine of this service launches on
        self._backend = get_backend(
            self.config.match_backend or "gpu",
            device=self.config.device,
            mesh_devices=self.config.mesh_devices,
        )
        self.block_cache = BlockCache(
            max_bytes=self.config.cache_max_bytes, ttl_s=self.config.cache_ttl_s
        )
        if self.config.store_dir:
            # per-host verify-lane crossover: first daemon on a host
            # measures and persists verify_autotune_cuda.json under the
            # store dir, later ones load it (env IPC_VERIFY_MIN_BYTES
            # overrides). An unwritable store dir leaves the default
            # crossover; a device fault is not a tuning problem and raises
            # (before any thread of the service starts)
            from ipc_proofs_tpu_torch.ops.verify import autotune_crossover

            try:
                autotune_crossover(self.config.store_dir, backend=self._backend)
            except OSError as exc:
                log.warning("verify autotune skipped (%s): default crossover applies", exc)
        # async fetch plane: interpose between the local tiers and an
        # RPC-fed store so concurrent request walkers' block fetches ride
        # shared JSON-RPC batches and walker-offered links prefetch
        # speculatively. Only a store that exposes its chain client
        # (RpcBlockstore.client) gets a plane — plain stores (demo worlds,
        # memory fixtures) keep the direct path.
        self.fetch_plane = None
        plane_client = getattr(store, "client", None)
        if store is not None and plane_client is not None and self.config.batch_rpc:
            from ipc_proofs_tpu_torch.store.fetchplane import FetchPlane, PlaneBlockstore

            self.fetch_plane = FetchPlane(
                plane_client,
                speculate_depth=self.config.speculate_depth,
                metrics=self.metrics,
                backend=self._backend,
            )
            store = PlaneBlockstore(self.fetch_plane)
        self._disk_store = None
        if store is not None and self.config.store_dir:
            from ipc_proofs_tpu_torch.storex import SegmentStore, TieredBlockstore

            self._disk_store = SegmentStore(
                self.config.store_dir,
                cap_bytes=self.config.store_cap_bytes,
                segment_max_bytes=self.config.store_segment_max_bytes,
                metrics=self.metrics,
                owner=self.config.store_owner,
                backend=self._backend,
            )
            self._store = TieredBlockstore(
                store,
                self._disk_store,
                cache=self.block_cache,
                metrics=self.metrics,
            )
        elif store is not None:
            self._store = CachedBlockstore(store, shared_cache=self.block_cache)
        else:
            self._store = None
        if self.fetch_plane is not None:
            # the plane's tier short-circuit reads the SAME local tiers
            # that sit above it (both TieredBlockstore and CachedBlockstore
            # expose get_local/has_local/put_local that never touch their
            # inner store, so this is not circular): wants satisfiable
            # locally never reach the queue, landings deposit for next time
            self.fetch_plane.set_local(self._store)
        # witness plane: every served bundle registers here under its
        # canonical digest so later requests can name it as a delta base
        self.witness_bases = WitnessBaseCache(cap=self.config.witness_base_cache)
        # provenance registry: seals every served bundle into the
        # hash-linked audit chain, and (as the fleet base directory)
        # front-ends the local base cache so a digest served by ANY
        # sibling shard still resolves here after a failover
        self.registry = None
        if self.config.registry_dir:
            from ipc_proofs_tpu_torch.registry import ProvenanceRegistry
            from ipc_proofs_tpu_torch.witness.bases import FleetBaseCache

            self.registry = ProvenanceRegistry(
                self.config.registry_dir,
                owner=self.config.registry_owner,
                metrics=self.metrics,
                fsync=self.config.registry_fsync,
            )
            self.witness_bases = FleetBaseCache(
                self.witness_bases, self.registry, metrics=self.metrics
            )
        self._executor = ThreadPoolExecutor(
            max_workers=self.config.workers, thread_name_prefix="proof-serve"
        )
        self._drain_lock = named_lock("ProofService._drain_lock")
        self._drained = False  # guarded-by: _drain_lock
        self._verify_batcher = MicroBatcher(
            self._flush_verify,
            max_batch=self.config.max_batch,
            max_wait_ms=self.config.max_wait_ms,
            capacity=self.config.queue_capacity,
            name="verify",
            metrics=self.metrics,
            executor=self._executor,
            tenant_weights=self.config.tenant_weights,
        )
        self._generate_batcher = (
            MicroBatcher(
                self._flush_generate,
                max_batch=self.config.max_batch,
                max_wait_ms=self.config.max_wait_ms,
                capacity=self.config.queue_capacity,
                name="generate",
                metrics=self.metrics,
                executor=self._executor,
                tenant_weights=self.config.tenant_weights,
            )
            if self._store is not None and self._spec is not None
            else None
        )

    # --- public API --------------------------------------------------------

    def submit_verify(
        self,
        bundle: UnifiedProofBundle,
        timeout_s: Optional[float] = None,
        tenant: Optional[str] = None,
        cancel_scope=None,
    ) -> PendingResult:
        """Admit one verify request; returns immediately with a pending slot.

        Raises `QueueFullError` / `ServiceClosedError` at admission time;
        ``.result()`` raises `DeadlineExceededError` if ``timeout_s`` passes
        before the batch containing it is processed. ``cancel_scope`` rides
        the queue: a cancelled member is dropped typed at dispatch."""
        return self._verify_batcher.submit(
            bundle, timeout_s=timeout_s, tenant=tenant, cancel_scope=cancel_scope
        )

    def verify(
        self,
        bundle: UnifiedProofBundle,
        timeout_s: Optional[float] = None,
        tenant: Optional[str] = None,
        cancel_scope=None,
    ) -> VerifyResponse:
        """Blocking verify: submit and wait for the micro-batched verdict."""
        return self.submit_verify(
            bundle, timeout_s=timeout_s, tenant=tenant, cancel_scope=cancel_scope
        ).result()

    def submit_generate(
        self,
        pair: TipsetPair,
        timeout_s: Optional[float] = None,
        tenant: Optional[str] = None,
        cancel_scope=None,
    ) -> PendingResult:
        if self._generate_batcher is None:
            raise RuntimeError(
                "generate path disabled: service was built without store/spec"
            )
        return self._generate_batcher.submit(
            _GenerateRequest(pair),
            timeout_s=timeout_s,
            tenant=tenant,
            cancel_scope=cancel_scope,
        )

    def generate(
        self,
        pair: TipsetPair,
        timeout_s: Optional[float] = None,
        tenant: Optional[str] = None,
        cancel_scope=None,
    ) -> GenerateResponse:
        return self.submit_generate(
            pair, timeout_s=timeout_s, tenant=tenant, cancel_scope=cancel_scope
        ).result()

    def submit_range_window(
        self,
        pairs: Sequence[TipsetPair],
        chunk_size: Optional[int] = None,
        timeout_s: Optional[float] = None,
        lane: str = "low",
        spec=None,
        storage_specs=None,
        tenant: Optional[str] = None,
        cancel_scope=None,
    ) -> PendingResult:
        """Admit one range window on the generate batcher's LOW (default)
        or PUSH lane.

        LOW is the `BackfillEngine` runner: the window waits behind ALL
        interactive verify/generate traffic and executes as one canonical
        chunked-driver call — a saturating backfill job can never starve
        ``/v1/verify``. PUSH is the standing-query matcher's lane: the
        window jumps AHEAD of interactive batches (a subscriber
        notification is already late by one finality delay) while still
        riding the same admission bounds and the same canonical driver,
        so pushed bundles stay byte-identical to request/response ones.
        ``spec``/``storage_specs`` override the service spec per window
        (the matcher generates one distinct filter per push)."""
        if self._generate_batcher is None:
            raise RuntimeError(
                "generate path disabled: service was built without store/spec"
            )
        return self._generate_batcher.submit(
            _RangeWindowRequest(list(pairs), chunk_size, spec, storage_specs),
            timeout_s=timeout_s,
            tenant=tenant,
            lane=lane if lane == "push" else "low",
            cancel_scope=cancel_scope,
        )

    def generate_range(
        self, pairs: Sequence[TipsetPair], chunk_size: Optional[int] = None
    ) -> UnifiedProofBundle:
        """One canonical range bundle for an explicit pair list.

        This is the scatter-gather sub-request: the cluster router already
        grouped pairs per shard, so it calls straight through to the
        chunked range driver instead of the micro-batcher (re-batching an
        already-batched group would only add latency). The chunked driver
        is the canonical comparator — its bundle is byte-identical to the
        single-daemon run over the same pairs, which is what lets
        `cluster.gather.merge_range_bundles` reassemble shard outputs
        into the exact single-process bytes.
        """
        if self._store is None or self._spec is None:
            raise RuntimeError(
                "generate path disabled: service was built without store/spec"
            )
        if self.draining:
            raise ServiceClosedError("service is draining")
        pairs = list(pairs)
        if not pairs:
            raise RuntimeError("generate_range needs at least one pair")
        with self.metrics.stage("serve.generate_batch"):
            bundle = generate_event_proofs_for_range_chunked(
                self._store,
                pairs,
                self._spec,
                chunk_size=chunk_size or self.config.range_chunk_size,
                metrics=self.metrics,
                match_backend=self._backend,
            )
        self.metrics.count("serve.batches.generate")
        return bundle

    @property
    def draining(self) -> bool:
        return self._verify_batcher.closed

    def health(self) -> dict:
        """Liveness summary for `/healthz`.

        ``"draining"`` once shutdown started (stop routing traffic here);
        ``"degraded"`` when the endpoint pool has an open/half-open breaker
        (still serving — from the remaining endpoints — but worth paging
        on); ``"ok"`` otherwise. Includes per-endpoint breaker state when a
        pool is attached."""
        if self.draining:
            return {"status": "draining"}
        out = (
            self._endpoint_pool.health()
            if self._endpoint_pool is not None
            else {"status": "ok"}
        )
        if self.registry is not None:
            out = dict(
                out,
                registry="degraded" if self.registry.degraded else "ok",
                registry_head=self.registry.head(),
            )
        return out

    @property
    def lotus_down(self) -> bool:
        """True while every pool endpoint's breaker is open (degraded
        serve mode: warm-tier requests still produce bit-identical
        bundles; cold requests fail fast typed ``degraded``)."""
        return self._endpoint_pool is not None and bool(
            getattr(self._endpoint_pool, "lotus_down", False)
        )

    @property
    def blockstore(self):
        """The service's layered store (tiered when ``store_dir`` is set) —
        the `ChainFollower` prefetches into exactly this object so demand
        traffic and the follower share one warm tier."""
        return self._store

    def read_block_slice(self, cid):
        """Zero-copy block read for the streaming wire: a CRC-verified
        ``memoryview`` straight out of the disk tier's segment frame, or
        None (no disk tier, cold block, or a frame that vanished under a
        concurrent eviction — the streamer falls back to the in-memory
        copy it already holds and counts the copied bytes honestly)."""
        if self._disk_store is None:
            return None
        return self._disk_store.read_frame_slice(cid)

    # --- replication plane (storex.replica) --------------------------------

    @property
    def disk_store(self):
        """The tier-2 `SegmentStore` (None without ``store_dir``) — the
        replication plane's unit of transfer is its segment files."""
        return self._disk_store

    def set_replica_peers(self, peers: "Sequence[dict]") -> None:
        """Install/replace the read-repair peer set (the router's
        ``POST /v1/replica_peers`` body: ``[{"name", "url"}, ...]``).
        From then on a local frame that fails CRC/multihash repairs from
        a peer before the inner store is ever consulted."""
        from ipc_proofs_tpu_torch.storex import ReplicaClient, ReplicaSet

        if self._disk_store is None:
            raise RuntimeError("replication needs a disk tier (--store-dir)")
        clients = [ReplicaClient(p["name"], p["url"]) for p in peers]
        # self._store is a TieredBlockstore whenever a disk tier exists
        self._store.set_replicas(ReplicaSet(clients, metrics=self.metrics))

    def replicate_from(
        self, sources: "Sequence[dict]", owners=None
    ) -> dict:
        """Pull-sync segment files from peer shards (the router's
        ``POST /v1/replicate``). ``sources`` is ``[{"name", "url"}, ...]``;
        ``owners`` optionally restricts the pull to those owner tokens
        (the ring arcs this shard is replica for). Per-source failure is
        fail-soft — the error string lands in ``errors`` and the other
        sources still sync."""
        from ipc_proofs_tpu_torch.storex import ReplicaClient, ReplicaError, Replicator

        if self._disk_store is None:
            raise RuntimeError("replication needs a disk tier (--store-dir)")
        rep = Replicator(self._disk_store, metrics=self.metrics)
        out = {"pulled": 0, "bytes": 0, "blocks": 0, "pending": 0, "errors": []}
        for src in sources:
            try:
                r = rep.sync_from(
                    ReplicaClient(src["name"], src["url"]), owners=owners
                )
            except (ReplicaError, KeyError, TypeError) as exc:
                out["errors"].append(str(exc))
                continue
            for k in ("pulled", "bytes", "blocks", "pending"):
                out[k] += r[k]
        return out

    def read_block_local(self, cid_str: str) -> "Optional[bytes]":
        """One block from the LOCAL tiers only (``GET /v1/blocks/<cid>``):
        never consults the inner store, so a peer's read-repair can never
        launder an upstream (Lotus) fetch through this shard. None = 404
        (unparseable CID included — an address we can't hold bytes for)."""
        if self._store is None:
            return None
        try:
            cid = CID.parse(cid_str)
        except (ValueError, KeyError, TypeError):
            return None
        get_local = getattr(self._store, "get_local", None)
        if get_local is None:
            return None
        return get_local(cid)

    @property
    def match_backend(self):
        """The service's backend: every engine of the service launches its
        kernels on it (the range drivers' masks and slot keccaks, the
        verify batches' CIDs, the fetch plane's and disk tier's lanes)."""
        return self._backend

    def metrics_snapshot(self) -> dict:
        snap = self.metrics.snapshot()
        snap["block_cache"] = self.block_cache.stats()
        if self._store is not None:
            snap["block_cache"]["hits"] = self._store.hits
            snap["block_cache"]["misses"] = self._store.misses
        if self._disk_store is not None:
            snap["disk_store"] = self._disk_store.stats()
        return snap

    def drain(self, timeout: Optional[float] = None) -> None:
        """Graceful shutdown: stop admitting, flush everything accepted,
        wait for in-flight batches, release the worker pool. Idempotent."""
        with self._drain_lock:
            if self._drained:
                return
            self._drained = True
        self._verify_batcher.close(drain=True, timeout=timeout)
        if self._generate_batcher is not None:
            self._generate_batcher.close(drain=True, timeout=timeout)
        self._executor.shutdown(wait=True)
        if self.fetch_plane is not None:
            self.fetch_plane.close()
        if self._disk_store is not None:
            self._disk_store.close()
        if self.registry is not None:
            self.registry.close()

    close = drain

    def __enter__(self) -> "ProofService":
        return self

    def __exit__(self, *exc) -> None:
        self.drain()

    # --- per-request latency attribution -----------------------------------

    def _request_timing(
        self, pending: PendingResult, exec_start: float, now: float, exec_key: str
    ) -> dict:
        """queue_ms (admission → batch dispatch) + batch_wait_ms (dispatch →
        execution start on a worker) + <exec_key> (batch execution): the
        components cover the admission→completion interval end to end."""
        dispatched = pending.dispatched_at or exec_start
        return {
            "queue_ms": round(max(0.0, dispatched - pending.enqueued_at) * 1e3, 3),
            "batch_wait_ms": round(max(0.0, exec_start - dispatched) * 1e3, 3),
            exec_key: round(max(0.0, now - exec_start) * 1e3, 3),
        }

    def _maybe_log_slow(
        self, pending: PendingResult, kind: str, total_ms: float, timing: dict
    ) -> None:
        if total_ms <= self.config.slow_request_ms:
            return
        self.metrics.count("serve.slow_requests")
        trace_id = pending.trace_ctx.trace_id if pending.trace_ctx else ""
        tree = ""
        if trace_id:
            spans = spans_for_trace(trace_id)
            if spans:
                tree = "\n" + format_span_tree(spans)
        log.warning(
            "slow %s request: %.1fms (threshold %.0fms) trace_id=%s timing=%s%s",
            kind,
            total_ms,
            self.config.slow_request_ms,
            trace_id or "-",
            timing,
            tree,
        )

    # --- verify batching ---------------------------------------------------

    def _flush_verify(self, batch: list[PendingResult]) -> None:
        """Merge → one `verify_proof_bundle` → split verdicts by span.

        Conflicting witness blocks (same CID, different bytes) partition
        the batch greedily: each request joins the current merge unless one
        of its blocks contradicts a block already merged, in which case it
        starts/joins a later sub-merge. Verdicts are unaffected — a merge
        only ever contains mutually consistent witnesses, and within one
        merge identical CIDs carry identical bytes, so deduplication is
        lossless."""
        remaining = batch
        while remaining:
            merged: list[PendingResult] = []
            deferred: list[PendingResult] = []
            by_cid: dict = {}
            for pending in remaining:
                bundle: UnifiedProofBundle = pending.payload
                conflict = any(
                    by_cid.get(b.cid, b.data) != b.data for b in bundle.blocks
                )
                if conflict:
                    deferred.append(pending)
                else:
                    for b in bundle.blocks:
                        by_cid.setdefault(b.cid, b.data)
                    merged.append(pending)
            self._verify_merged(merged)
            remaining = deferred

    def _verify_merged(self, merged: list[PendingResult]) -> None:
        exec_start = monotonic()
        storage_proofs: list = []
        event_proofs: list = []
        blocks: list[ProofBlock] = []
        seen: set = set()
        spans: list[tuple[int, int, int, int]] = []
        for pending in merged:
            bundle: UnifiedProofBundle = pending.payload
            s0, e0 = len(storage_proofs), len(event_proofs)
            storage_proofs.extend(bundle.storage_proofs)
            event_proofs.extend(bundle.event_proofs)
            for b in bundle.blocks:
                if b.cid not in seen:
                    seen.add(b.cid)
                    blocks.append(b)
            spans.append((s0, len(storage_proofs), e0, len(event_proofs)))

        # the batch executes once, under the OLDEST member's trace: its
        # request tree gets the full execution spans, while every member
        # still gets its own server_timing/trace_id from its timestamps
        with use_context(merged[0].trace_ctx):
            with self.metrics.stage("serve.verify_batch"):
                result = verify_proof_bundle(
                    UnifiedProofBundle(
                        storage_proofs=storage_proofs,
                        event_proofs=event_proofs,
                        blocks=blocks,
                    ),
                    self._trust,
                    event_filter=self._event_filter,
                    verify_witness_cids=self.config.verify_witness_cids,
                    cid_backend=self._backend,
                )
        self.metrics.count("serve.batches.verify")

        now = monotonic()
        slow: list[tuple[PendingResult, float, dict]] = []
        for pending, (s0, s1, e0, e1) in zip(merged, spans):
            total_ms = (now - pending.enqueued_at) * 1e3
            timing = self._request_timing(pending, exec_start, now, "verify_ms")
            self.metrics.observe("serve.latency_ms.verify", total_ms)
            pending.complete(
                VerifyResponse(
                    storage_results=result.storage_results[s0:s1],
                    event_results=result.event_results[e0:e1],
                    batch_size=len(merged),
                    server_timing=timing,
                    trace_id=(
                        pending.trace_ctx.trace_id if pending.trace_ctx else ""
                    ),
                )
            )
            if total_ms > self.config.slow_request_ms:
                slow.append((pending, total_ms, timing))
        for pending, total_ms, timing in slow:
            self._maybe_log_slow(pending, "verify", total_ms, timing)

    # --- generate batching -------------------------------------------------

    def _batch_job_dir(self, unique: dict) -> Optional[str]:
        """Per-batch journal dir under ``config.range_job_dir``.

        A job manifest binds its directory to one exact request (spec +
        pair range), so each distinct batch composition needs its own
        subdirectory; the key digest makes a re-submitted identical batch
        land on the same journal and resume instead of regenerate.
        """
        root = self.config.range_job_dir
        if not root:
            return None
        ident = hashlib.sha256(repr(sorted(unique)).encode()).hexdigest()[:16]
        path = os.path.join(root, f"batch-{ident}")
        os.makedirs(path, exist_ok=True)
        return path

    def _flush_generate(self, batch: list[PendingResult]) -> None:
        """Deduplicate pairs → one range-driver call → split proofs by pair."""
        if isinstance(batch[0].payload, _RangeWindowRequest):
            # lanes assemble exclusively from themselves, so a batch is
            # either all interactive pairs or all windows (low OR push)
            self._flush_range_windows(batch)
            return
        exec_start = monotonic()
        unique: dict[tuple, TipsetPair] = {}
        for pending in batch:
            req: _GenerateRequest = pending.payload
            unique.setdefault(req.key, req.pair)
        pairs = list(unique.values())

        job_dir = self._batch_job_dir(unique)
        journal_us0 = self.metrics.counter_value("jobs.chunk_journal_us")
        # a coalesced batch shares one driver call, so cooperative abort is
        # only safe when the whole batch is one request's work — a shared
        # batch must finish for the members that did NOT cancel
        batch_scope = batch[0].cancel_scope if len(batch) == 1 else None
        with use_context(batch[0].trace_ctx), use_scope(batch_scope):
            with self.metrics.stage("serve.generate_batch"):
                if len(pairs) > 1:
                    # multi-pair batch: stage-overlapped engine (bit-identical
                    # output; scan of later chunks overlaps recording)
                    bundle = generate_event_proofs_for_range_pipelined(
                        self._store,
                        pairs,
                        self._spec,
                        chunk_size=self.config.range_chunk_size,
                        metrics=self.metrics,
                        scan_threads=self.config.range_scan_threads,
                        threads=self.config.threads,
                        pipeline_depth=self.config.range_pipeline_depth,
                        job_dir=job_dir,
                        match_backend=self._backend,
                    )
                elif job_dir is not None:
                    # journalled single-pair path: the chunked driver is the
                    # serial engine plus write-ahead chunk commits
                    bundle = generate_event_proofs_for_range_chunked(
                        self._store,
                        pairs,
                        self._spec,
                        chunk_size=self.config.range_chunk_size,
                        metrics=self.metrics,
                        job_dir=job_dir,
                        match_backend=self._backend,
                    )
                else:
                    bundle = generate_event_proofs_for_range(
                        self._store,
                        pairs,
                        self._spec,
                        metrics=self.metrics,
                        match_backend=self._backend,
                    )
        self.metrics.count("serve.batches.generate")
        if self.lotus_down:
            # the whole batch was satisfied from warm local tiers while
            # every upstream breaker is open — degraded mode's success path
            self.metrics.count("degraded.warm_served", len(batch))
        # Wall-clock microseconds the range driver spent journalling chunk
        # commits while this batch executed (one flush thread drives the
        # generate queue, so the counter delta is this batch's journalling)
        journal_us = (
            self.metrics.counter_value("jobs.chunk_journal_us") - journal_us0
        )

        by_key: dict[tuple, list] = {key: [] for key in unique}
        # EventProof pins (parent_tipset_cids, child_block_cid); a child
        # block cid identifies its pair within one batch
        child_block_to_key: dict[str, tuple] = {}
        for key, pair in unique.items():
            for c in pair.child.cids:
                child_block_to_key[str(c)] = key
        for proof in bundle.event_proofs:
            by_key[child_block_to_key[proof.child_block_cid]].append(proof)

        now = monotonic()
        slow: list[tuple[PendingResult, float, dict]] = []
        for pending in batch:
            req = pending.payload
            total_ms = (now - pending.enqueued_at) * 1e3
            timing = self._request_timing(pending, exec_start, now, "generate_ms")
            if journal_us > 0:
                timing["journal_ms"] = round(journal_us / 1e3, 3)
            self.metrics.observe("serve.latency_ms.generate", total_ms)
            pending.complete(
                GenerateResponse(
                    bundle=UnifiedProofBundle(
                        storage_proofs=[],
                        event_proofs=list(by_key[req.key]),
                        blocks=bundle.blocks,
                    ),
                    batch_size=len(batch),
                    server_timing=timing,
                    trace_id=(
                        pending.trace_ctx.trace_id if pending.trace_ctx else ""
                    ),
                )
            )
            if total_ms > self.config.slow_request_ms:
                slow.append((pending, total_ms, timing))
        for pending, total_ms, timing in slow:
            self._maybe_log_slow(pending, "generate", total_ms, timing)

    def _flush_range_windows(self, batch: list[PendingResult]) -> None:
        """Execute backfill/push windows: one canonical chunked-driver
        call per window (byte-identical to the same pairs served
        interactively). Windows fail individually — one bad window never
        poisons its batch neighbors' jobs."""
        for pending in batch:
            req: _RangeWindowRequest = pending.payload
            try:
                with use_context(pending.trace_ctx), use_scope(
                    pending.cancel_scope
                ):
                    with self.metrics.stage("serve.backfill_window"):
                        bundle = generate_event_proofs_for_range_chunked(
                            self._store,
                            req.pairs,
                            req.spec if req.spec is not None else self._spec,
                            chunk_size=req.chunk_size or len(req.pairs),
                            metrics=self.metrics,
                            match_backend=self._backend,
                            storage_specs=req.storage_specs,
                        )
            except BaseException as exc:  # fail-soft: the window's job sees the error; other windows proceed
                pending.fail(exc)
                continue
            if self.lotus_down:
                self.metrics.count("degraded.warm_served")
            pending.complete(bundle)


def sequential_verify_baseline(
    bundles: Sequence[UnifiedProofBundle],
    trust_policy: Optional[TrustPolicy] = None,
    event_filter=None,
    cid_backend=None,
) -> list[VerifyResponse]:
    """The per-request comparator: one `verify_proof_bundle` call per
    request, no coalescing, its TxMeta recompute on ``cid_backend`` (default
    the card, as in `verify_proof_bundle`). The micro-batcher is measured
    against exactly this."""
    trust = trust_policy or TrustPolicy.accept_all()
    out = []
    for bundle in bundles:
        result = verify_proof_bundle(
            bundle, trust, event_filter=event_filter, cid_backend=cid_backend
        )
        out.append(
            VerifyResponse(
                storage_results=result.storage_results,
                event_results=result.event_results,
                batch_size=1,
            )
        )
    return out
