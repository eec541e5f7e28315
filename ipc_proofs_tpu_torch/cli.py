"""Command-line interface: generate / verify / range / backfill / vectors / cert / demo / serve / cluster.

The counterpart of ``ipc_proofs_tpu.cli`` for the PyTorch/CUDA port, with
the reference's flags and exit codes:

    python -m ipc_proofs_tpu_torch.cli generate --endpoint URL --height H \
        --contract 0x... --slot-subnet calib-subnet-1 --slot-index 0 \
        --event-sig "NewTopDownMessage(bytes32,uint256)" \
        --topic1 calib-subnet-1 -o bundle.json
    python -m ipc_proofs_tpu_torch.cli verify bundle.json [--f3-cert cert.json] \
        [--event-sig ... --topic1 ...] [--check-cids]
    python -m ipc_proofs_tpu_torch.cli range --endpoint URL --from-height A \
        --to-height B --event-sig ... --topic1 ... [--storage-slot KEY]
    python -m ipc_proofs_tpu_torch.cli backfill --demo-world 256 \
        --jobs-dir jobs [--window-size 8]   # durable, resumable, streamed
    python -m ipc_proofs_tpu_torch.cli vectors --endpoint URL --height H
    python -m ipc_proofs_tpu_torch.cli cert cert.json [--power-table t.json \
        --verify-signatures] [--emit-cbor out.cbor]
    python -m ipc_proofs_tpu_torch.cli demo      # hermetic synthetic-chain run
    python -m ipc_proofs_tpu_torch.cli serve --demo-world 256 --port 0 \
        --port-file port.txt [--check-cids] [--store-dir D] [--queue-dir Q] \
        [--registry-dir R] [--subs-dir S] [--slo on] \
        [--backfill-jobs-dir B]   # the proof daemon over JSON-HTTP
    python -m ipc_proofs_tpu_torch.cli cluster --shards 4 --demo-world 256 \
        --port 0 --port-file port.txt [--queue-dir Q] [--store-dir D] \
        [--replication-factor 2]   # N serve shards behind one router

``--backend`` picks where the kernels run: ``gpu`` (the default, the card:
the event mask, the slot keccaks, the witness CID and TxMeta recomputes;
without CUDA the command fails with the backend's error and never drops to
the host), ``cpu`` (the kernels' plain PyTorch versions on the host) or
``none`` (the host too: the port has no separate scalar predicate, so it
runs the plain versions as ``cpu`` does). ``verify`` and ``demo`` take the
flag as well, because the port's verifier recomputes CIDs on the backend.

``range --mesh-devices N`` shards the event mask over a device mesh: the
first N cards (0 = all) under ``--backend gpu``, N virtual CPU devices
under ``--backend cpu``; ``--backend none`` refuses it. Over the CLI's RPC
store the range scan is the Python walk, so the mask it shards is the
full-word one (`ops.match.event_match_mask_flat`), rows split over every
device. The bundle is byte-identical to the single-device run's.

``generate`` and ``range`` take the failover flags: ``--endpoints URL``
(repeatable) puts ``--endpoint`` and every replica behind one
`store.failover.EndpointPool` (circuit breakers at ``--breaker-threshold``
consecutive failures, hedged block reads after ``--hedge-ms``, per-endpoint
integrity demotion), whose batch reads verify on the ``--backend`` lane.
They take the trace flags too: ``--trace-out PATH`` (Chrome trace-event
JSON), ``--trace-otlp PATH`` (OTLP/JSON), ``--trace-otlp-url URL`` (POSTed
to a collector, retried, fail-soft) and ``--trace-sample RATE`` (head
sampling per trace). Every command runs under one root span,
``cli.<command>``, so a traced run is one trace: RPC calls, pool reads,
pipeline stages and journal appends nest under it. ``--profile`` traces the
card with torch.profiler beside them. An unhandled error dumps the flight
recorder's recent spans and warnings to stderr.

``serve`` runs `serve.ProofHTTPServer` over one `serve.ProofService`
whose one backend (``--backend``, default the card; ``--mesh-devices N``
its mesh) runs every kernel: the verify batches' TxMeta and witness CIDs
(``--check-cids``), the range drivers' masks, the fetch plane's and disk
tier's lanes. It takes the reference's store modes (``--demo-world N``, or
``--endpoint``/``--endpoints`` with ``--from-height``/``--to-height``), the
store, fetch-plane, witness, registry, durable-queue (``--queue-dir``,
``--results-cache-bytes``), follower (``--follow``), tenant QoS, adaptive
admission, deadline-floor, retry-budget and trace flags, ``--port-file``,
and drains every accepted request on SIGTERM before it exits 0. With
``--subs-dir`` it mounts the standing queries (webhook push with
``--push-max-inflight`` / ``--delivery-retry-*``, the delivery log's
``--subs-log-cap-bytes``, ``--subs-fleet``), fed by the follower's
finalized tipsets; each push generates on the service's PUSH lane. With
``--slo on`` the burn-rate watchdog (``--slo-*``) adds an ``slo`` block to
``/healthz``; with ``--backfill-jobs-dir`` it mounts ``/v1/backfill``,
whose windows run on the service's LOW lane. SIGTERM stops the watchdog,
then closes the backfill engine, then drains the standing queries, then the
service.

``backfill`` proves a pair range as a durable job
(`backfill.BackfillEngine`): ``--window-size`` windows, journalled under
``--jobs-dir`` (the identical command resumes), streamed chunk by chunk,
the sealed bundle byte-identical to ``range`` over the same pairs. Its store
is ``--demo-world N`` or ``--endpoint`` (with the failover flags) through
the fetch plane (``--batch-rpc``, verifying every wave on the
``--backend`` lane) and the disk tier (``--store-dir``); ``--mesh-devices``
shards its masks as ``range``'s does. A fault of the card stops the job
(``faulted``, not failed; exit 1) with its windows journalled.

``cluster`` spawns ``--shards`` ``serve`` children over one ``--demo-world``
(each with ``--backend``, default the card: N processes on this host's one
card) behind a `cluster.RouterHTTPServer` that speaks the single daemon's
wire protocol (steal-aware placement, failover, scatter-gather ranges,
``--shard-url`` members, ``--replication-factor`` segment replicas, fleet
``/metrics.prom`` and ``/v1/cluster/status``). Under ``--backend gpu`` it
builds the kernels once before the first shard starts; each shard's stderr,
with its ``kernel launches:`` lines, goes to the log file it names at start.
SIGTERM drains the router, then every shard.

``--batch-verify`` has no counterpart: every fetch-plane wave, pool batch
read and disk read of the port goes through the verify lane.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from contextlib import contextmanager

from ipc_proofs_tpu_torch.utils.log import get_logger

log = get_logger(__name__)

BACKENDS = ("gpu", "cpu", "none")


def _backend(name: str, mesh_devices=None):
    """The `GpuBackend` ``--backend`` names: the card, or the plain versions
    on the host for ``cpu`` and ``none``; with ``mesh_devices``, its mesh
    variant (``none`` refuses a mesh). Without CUDA, ``gpu`` exits non-zero
    with the backend's error."""
    from ipc_proofs_tpu_torch.backend import get_backend

    if mesh_devices is not None and name == "none":
        raise SystemExit("--mesh-devices requires --backend gpu or cpu")
    try:
        if name != "gpu":
            return get_backend("gpu", device="cpu", mesh_devices=mesh_devices)
        return get_backend("gpu", mesh_devices=mesh_devices)
    except (RuntimeError, ValueError) as exc:
        raise SystemExit(f"--backend {name}: {exc}") from exc


def _make_rpc_client(args, metrics=None, backend=None):
    """The chain client: one `LotusClient` on ``--endpoint``, or an
    `EndpointPool` across it and every ``--endpoints`` replica, verifying
    its batch reads on ``backend``."""
    from ipc_proofs_tpu_torch.store.rpc import LotusClient

    endpoints = [args.endpoint] if args.endpoint else []
    for extra in getattr(args, "endpoints", None) or []:
        if extra not in endpoints:
            endpoints.append(extra)
    if not endpoints:
        raise ValueError("no RPC endpoint configured")
    clients = [
        LotusClient(e, bearer_token=args.token, timeout_s=args.timeout, metrics=metrics)
        for e in endpoints
    ]
    if len(clients) == 1:
        return clients[0]
    from ipc_proofs_tpu_torch.store.failover import EndpointPool

    log.info(
        "endpoint pool: %d endpoints (breaker_threshold=%d hedge_ms=%s)",
        len(clients), args.breaker_threshold, args.hedge_ms,
    )
    return EndpointPool(
        clients,
        breaker_threshold=args.breaker_threshold,
        hedge_ms=args.hedge_ms,
        # serve only: generate/range runs have no --retry-budget
        retry_budget_per_s=getattr(args, "retry_budget", None),
        metrics=metrics,
        backend=backend,
    )


def _close_client(client) -> None:
    """Stop a pool's hedge threads and log its endpoints' health (a single
    `LotusClient` holds nothing to close)."""
    close = getattr(client, "close", None)
    if close is not None:
        log.info("endpoint pool: %s", client.health())
        close()


def _start_tracing(args) -> bool:
    """Enable the span collector when ``--trace-out``, ``--trace-otlp`` or
    ``--trace-otlp-url`` was given; ``--trace-sample`` head-samples whole
    traces at the collector (the always-on flight ring is unaffected)."""
    if not (
        getattr(args, "trace_out", None)
        or getattr(args, "trace_otlp", None)
        or getattr(args, "trace_otlp_url", None)
    ):
        return False
    from ipc_proofs_tpu_torch.obs import enable_tracing

    enable_tracing(sample=getattr(args, "trace_sample", 1.0))
    return True


def _finish_tracing(args) -> None:
    """Export the collected spans to ``--trace-out`` (Chrome trace JSON,
    load at ui.perfetto.dev or chrome://tracing), ``--trace-otlp``
    (OTLP/JSON file) and ``--trace-otlp-url`` (POSTed, retried, fail-soft)."""
    from ipc_proofs_tpu_torch.obs import (
        disable_tracing,
        get_collector,
        post_otlp_trace,
        write_chrome_trace,
        write_otlp_trace,
    )

    collector = get_collector()
    spans = collector.snapshot() if collector is not None else []
    dropped = collector.dropped if collector is not None else 0
    disable_tracing()
    if getattr(args, "trace_out", None):
        n = write_chrome_trace(args.trace_out, spans)
        log.info(
            "trace: %d events → %s%s", n, args.trace_out,
            f" ({dropped} spans dropped at capacity)" if dropped else "",
        )
    if getattr(args, "trace_otlp", None):
        n = write_otlp_trace(args.trace_otlp, spans)
        log.info("trace: %d spans → %s (OTLP/JSON)", n, args.trace_otlp)
    if getattr(args, "trace_otlp_url", None):
        if post_otlp_trace(args.trace_otlp_url, spans):
            log.info("trace: %d spans POSTed → %s", len(spans), args.trace_otlp_url)


@contextmanager
def _traced(args):
    """Run a command under its root span ``cli.<command>``, collecting
    spans when a trace flag was given and exporting them at exit (a failed
    run's spans too)."""
    from ipc_proofs_tpu_torch.obs import root_span

    tracing = _start_tracing(args)
    try:
        with root_span(f"cli.{args.command}"):
            yield
    finally:
        if tracing:
            _finish_tracing(args)


def _build_slo_watchdog(args, metrics):
    """`--slo on` → a configured (not yet started) burn-rate watchdog."""
    from ipc_proofs_tpu_torch.obs.slo import SloWatchdog, default_targets

    return SloWatchdog(
        metrics=metrics,
        targets=default_targets(
            availability=args.slo_availability,
            generate_p99_ms=args.slo_generate_p99_ms,
            delivery_lag_p99_ms=args.slo_delivery_lag_p99_ms,
        ),
        fast_window_s=args.slo_fast_window_s,
        slow_window_s=args.slo_slow_window_s,
        interval_s=args.slo_interval_s,
    )


def _cmd_generate(args) -> int:
    from ipc_proofs_tpu_torch.proofs.address import resolve_eth_address_to_actor_id
    from ipc_proofs_tpu_torch.proofs.chain import Tipset
    from ipc_proofs_tpu_torch.proofs.generator import (
        EventProofSpec,
        StorageProofSpec,
        generate_proof_bundle,
    )
    from ipc_proofs_tpu_torch.proofs.storage_batch import MappingSlotSpec, hash_slot_specs
    from ipc_proofs_tpu_torch.store.rpc import RpcBlockstore
    from ipc_proofs_tpu_torch.utils.metrics import get_metrics

    backend = _backend(args.backend)
    metrics = get_metrics()
    client = _make_rpc_client(args, metrics=metrics, backend=backend)

    with metrics.stage("fetch_tipsets"):
        parent = Tipset.fetch(client, args.height)
        child = Tipset.fetch(client, args.height + 1)
    log.info("parent tipset @%d: %d blocks", parent.height, len(parent.cids))

    with metrics.stage("resolve_address"):
        actor_id = (
            args.actor_id
            if args.actor_id is not None
            else resolve_eth_address_to_actor_id(client, args.contract)
        )
    log.info("actor id: %d", actor_id)

    storage_specs = []
    if args.slot_subnet is not None:
        # the mapping slot: keccak(bytes32(subnet) ‖ be32(index)) on the backend
        (slot,) = hash_slot_specs(
            [MappingSlotSpec(actor_id=actor_id, key=args.slot_subnet, slot_index=args.slot_index)],
            backend,
        )
        storage_specs.append(StorageProofSpec(actor_id=actor_id, slot=slot))
    event_specs = []
    if args.event_sig:
        event_specs.append(
            EventProofSpec(
                event_signature=args.event_sig,
                topic_1=args.topic1,
                actor_id_filter=None if args.no_actor_filter else actor_id,
            )
        )

    store = RpcBlockstore(client, metrics=metrics)
    try:
        with metrics.stage("generate"):
            bundle = generate_proof_bundle(
                store, parent, child, storage_specs, event_specs, match_backend=backend,
                receipts_client=client if args.receipts_api else None,
            )
    finally:
        _close_client(client)

    output = args.output or "bundle.json"
    with open(output, "w") as fh:
        fh.write(bundle.to_json(indent=2))
    log.info(
        "bundle: %d storage + %d event proofs, %d witness blocks (%d bytes) → %s",
        len(bundle.storage_proofs), len(bundle.event_proofs),
        len(bundle.blocks), bundle.witness_bytes(), output,
    )
    if args.metrics:
        print(metrics.to_json(), file=sys.stderr)
    return 0


def _cmd_verify(args) -> int:
    from ipc_proofs_tpu_torch.proofs.bundle import UnifiedProofBundle
    from ipc_proofs_tpu_torch.proofs.cert import FinalityCertificate
    from ipc_proofs_tpu_torch.proofs.event_verifier import create_event_filter
    from ipc_proofs_tpu_torch.proofs.trust import TrustPolicy
    from ipc_proofs_tpu_torch.proofs.verifier import verify_proof_bundle

    backend = _backend(args.backend)
    with open(args.bundle) as fh:
        bundle = UnifiedProofBundle.from_json(fh.read())

    if args.f3_cert:
        with open(args.f3_cert) as fh:
            cert = FinalityCertificate.from_json_obj(json.load(fh))
        policy = TrustPolicy.with_f3_certificate(cert)
    else:
        log.warning("no F3 certificate — accept-all trust (testing only)")
        policy = TrustPolicy.accept_all()

    event_filter = (
        create_event_filter(args.event_sig, args.topic1) if args.event_sig else None
    )

    start = time.perf_counter()
    result = verify_proof_bundle(
        bundle, policy, event_filter=event_filter, verify_witness_cids=args.check_cids,
        cid_backend=backend,
    )
    elapsed = time.perf_counter() - start

    print(
        json.dumps(
            {
                "storage_results": result.storage_results,
                "event_results": result.event_results,
                "all_valid": result.all_valid(),
                "verify_seconds": round(elapsed, 4),
            }
        )
    )
    return 0 if result.all_valid() else 1


def _cmd_range(args) -> int:
    """Event proofs across a whole epoch range, chunked + resumable."""
    import functools
    import os

    from ipc_proofs_tpu_torch.proofs.address import resolve_eth_address_to_actor_id
    from ipc_proofs_tpu_torch.proofs.chain import Tipset
    from ipc_proofs_tpu_torch.proofs.generator import EventProofSpec
    from ipc_proofs_tpu_torch.proofs.range import (
        TipsetPair,
        generate_event_proofs_for_range_chunked,
        generate_event_proofs_for_range_pipelined,
    )
    from ipc_proofs_tpu_torch.store.rpc import RpcBlockstore
    from ipc_proofs_tpu_torch.utils.metrics import get_metrics
    from ipc_proofs_tpu_torch.utils.profiling import maybe_profile
    from ipc_proofs_tpu_torch.utils.threads import resolve_thread_budget

    if args.storage_slot and not args.contract:
        # validate before any network work: the tipset fetch below can be
        # tens of thousands of RPC calls
        log.error("--storage-slot requires --contract")
        return 2
    if args.resume:
        # --resume asserts that a journaled job already exists; a typo'd
        # --job-dir must fail loudly, not silently start from scratch
        from ipc_proofs_tpu_torch.jobs import JOBS_MANIFEST_NAME

        if not args.job_dir:
            log.error("--resume requires --job-dir")
            return 2
        if not os.path.exists(os.path.join(args.job_dir, JOBS_MANIFEST_NAME)):
            log.error("--resume: no job manifest in %s (nothing to resume)", args.job_dir)
            return 2

    backend = _backend(args.backend, args.mesh_devices)
    if backend.mesh is not None:
        log.info("mesh-sharded matching: %d device(s)", backend.mesh.size)
    metrics = get_metrics()
    client = _make_rpc_client(args, metrics=metrics, backend=backend)

    actor_id = None
    if args.contract:
        actor_id = resolve_eth_address_to_actor_id(client, args.contract)
        log.info("actor id: %d", actor_id)

    with metrics.stage("fetch_tipsets"):
        tipsets = [Tipset.fetch(client, h) for h in range(args.from_height, args.to_height + 2)]
    pairs = [
        TipsetPair(parent=tipsets[i], child=tipsets[i + 1]) for i in range(len(tipsets) - 1)
    ]
    log.info("range: %d tipset pairs", len(pairs))

    spec = EventProofSpec(
        event_signature=args.event_sig, topic_1=args.topic1, actor_id_filter=actor_id
    )
    storage_specs = None
    if args.storage_slot:
        from ipc_proofs_tpu_torch.proofs.storage_batch import MappingSlotSpec

        storage_specs = [
            MappingSlotSpec(actor_id=actor_id, key=key, slot_index=args.slot_index)
            for key in args.storage_slot
        ]

    generate_fn = None
    if args.pipeline_depth > 0:
        # the stage-overlapped engine per checkpoint chunk: each outer chunk
        # splits into sub-chunks so scan workers overlap recording, while
        # checkpoints (and resume) stay at --chunk-size granularity and hold
        # the storage proofs too
        budget = resolve_thread_budget(threads=args.threads, scan_threads=args.scan_threads)
        generate_fn = functools.partial(
            generate_event_proofs_for_range_pipelined,
            chunk_size=max(1, args.chunk_size // max(2, budget.total)),
            scan_threads=args.scan_threads,
            threads=args.threads,
            pipeline_depth=args.pipeline_depth,
        )

    plane = None
    if args.batch_rpc:
        from ipc_proofs_tpu_torch.store.fetchplane import FetchPlane, PlaneBlockstore

        plane = FetchPlane(
            client, speculate_depth=args.speculate_depth, metrics=metrics, backend=backend
        )
        store = PlaneBlockstore(plane)
        log.info("fetch plane: batched RPC, speculate_depth=%s", args.speculate_depth)
    else:
        store = RpcBlockstore(client, metrics=metrics)
    disk = None
    if args.store_dir:
        from ipc_proofs_tpu_torch.storex import SegmentStore, TieredBlockstore

        disk = SegmentStore(
            args.store_dir,
            cap_bytes=args.store_cap_bytes,
            segment_max_bytes=args.store_segment_max_bytes,
            metrics=metrics,
            backend=backend,
        )
        store = TieredBlockstore(store, disk, metrics=metrics)
        if plane is not None:
            # tier short-circuit: wants already on disk never reach the node
            plane.set_local(store)
        log.info("disk tier: %s (%s)", args.store_dir, disk.stats())

    try:
        with maybe_profile(args.profile):
            bundle = generate_event_proofs_for_range_chunked(
                store,
                pairs,
                spec,
                chunk_size=args.chunk_size,
                checkpoint_dir=args.checkpoint_dir,
                match_backend=backend,
                metrics=metrics,
                storage_specs=storage_specs,
                scan_workers=args.scan_workers,
                generate_fn=generate_fn,
                job_dir=args.job_dir,
            )
    finally:
        if plane is not None:
            plane.close()
            log.info("fetch plane: %s", plane.stats())
        if disk is not None:
            disk.close()
        _close_client(client)
    output = args.output or "range_bundle.json"
    with open(output, "w") as fh:
        fh.write(bundle.to_json())
    log.info(
        "range bundle: %d event + %d storage proofs, %d witness blocks → %s",
        len(bundle.event_proofs), len(bundle.storage_proofs), len(bundle.blocks), output,
    )
    if args.metrics:
        print(metrics.to_json(), file=sys.stderr)
    return 0


def _cmd_backfill(args) -> int:
    """Prove deep history as a durable batch job (`backfill`).

    Two store modes mirroring ``range``/``serve``:
    - ``--demo-world N``: hermetic synthetic range world (tests, CI);
    - ``--endpoint`` + ``--from-height/--to-height``: live chain.

    The range splits into ``--window-size`` epoch windows; each committed
    window journals under ``--jobs-dir`` (re-running the identical
    command resumes instead of re-proving) and streams as one log line
    the moment it lands — long before the job completes. The sealed
    bundle is byte-identical to the ``range`` command over the same pairs.
    Every window's mask, and the fetch plane's and disk tier's lanes, run
    on the ``--backend``.
    """
    from ipc_proofs_tpu_torch.backfill import BackfillEngine, local_window_runner
    from ipc_proofs_tpu_torch.ops.build import is_device_fault
    from ipc_proofs_tpu_torch.proofs.generator import EventProofSpec
    from ipc_proofs_tpu_torch.proofs.range import TipsetPair
    from ipc_proofs_tpu_torch.utils.metrics import get_metrics

    backend = _backend(args.backend, args.mesh_devices)
    metrics = get_metrics()

    plane = None
    disk = None
    client = None
    if args.demo_world:
        from ipc_proofs_tpu_torch.fixtures import build_range_world

        sig = args.event_sig or "NewTopDownMessage(bytes32,uint256)"
        topic1 = args.topic1 or "calib-subnet-1"
        store, pairs, n_matching = build_range_world(
            args.demo_world,
            receipts_per_pair=args.demo_receipts,
            match_rate=args.demo_match_rate,
            signature=sig,
            topic1=topic1,
        )
        spec = EventProofSpec(event_signature=sig, topic_1=topic1)
        log.info("demo world: %d pairs, %d matching events", len(pairs), n_matching)
    else:
        from ipc_proofs_tpu_torch.proofs.address import resolve_eth_address_to_actor_id
        from ipc_proofs_tpu_torch.proofs.chain import Tipset
        from ipc_proofs_tpu_torch.store.rpc import RpcBlockstore

        if not args.endpoint:
            log.error("backfill needs --demo-world or --endpoint")
            return 2
        if args.from_height is None or args.to_height is None:
            log.error("--endpoint requires --from-height and --to-height")
            return 2
        if not (args.event_sig and args.topic1):
            log.error("--endpoint requires --event-sig and --topic1")
            return 2
        client = _make_rpc_client(args, metrics=metrics, backend=backend)
        actor_id = None
        if args.contract:
            actor_id = resolve_eth_address_to_actor_id(client, args.contract)
            log.info("actor id: %d", actor_id)
        with metrics.stage("fetch_tipsets"):
            tipsets = [
                Tipset.fetch(client, h) for h in range(args.from_height, args.to_height + 2)
            ]
        pairs = [
            TipsetPair(parent=tipsets[i], child=tipsets[i + 1])
            for i in range(len(tipsets) - 1)
        ]
        spec = EventProofSpec(
            event_signature=args.event_sig, topic_1=args.topic1, actor_id_filter=actor_id
        )
        if args.batch_rpc:
            from ipc_proofs_tpu_torch.store.fetchplane import FetchPlane, PlaneBlockstore

            plane = FetchPlane(
                client, speculate_depth=args.speculate_depth, metrics=metrics, backend=backend
            )
            store = PlaneBlockstore(plane)
        else:
            store = RpcBlockstore(client, metrics=metrics)
        if args.store_dir:
            from ipc_proofs_tpu_torch.storex import SegmentStore, TieredBlockstore

            disk = SegmentStore(
                args.store_dir,
                cap_bytes=args.store_cap_bytes,
                segment_max_bytes=args.store_segment_max_bytes,
                metrics=metrics,
                backend=backend,
            )
            store = TieredBlockstore(store, disk, metrics=metrics)
            if plane is not None:
                plane.set_local(store)

    start = args.pair_start
    end = args.pair_end if args.pair_end is not None else len(pairs)
    if not (0 <= start < end <= len(pairs)):
        log.error("pair range [%d, %d) out of bounds for %d pairs", start, end, len(pairs))
        return 2

    engine = BackfillEngine(
        pairs,
        spec,
        local_window_runner(
            store, spec, chunk_size=args.chunk_size, match_backend=backend, metrics=metrics,
        ),
        jobs_dir=args.jobs_dir,
        window_size=args.window_size,
        work_ahead=args.work_ahead,
        window_parallelism=args.window_parallelism,
        plane=plane,
        metrics=metrics,
    )
    rc = 0
    try:
        job = engine.submit(start, end)
        log.info(
            "backfill %s: %d epochs in %d windows of %d (jobs dir: %s)",
            job.job_id, end - start, len(job.windows), job.window_size,
            args.jobs_dir or "none — not resumable",
        )
        cursor = 0
        while True:
            resp = job.chunks_after(cursor, wait_s=5.0)
            for chunk in resp["chunks"]:
                w = chunk["window"]
                log.info(
                    "chunk %d/%d: window %d pairs [%d, %d) — %d proofs (%s)",
                    chunk["cursor"], len(job.windows), w["index"],
                    w["lo"], w["hi"], chunk["n_event_proofs"], chunk["digest"],
                )
                cursor = chunk["cursor"]
            if resp["state"] != "running" and not resp["chunks"]:
                break
        bundle = job.result(timeout=0)
        output = args.output or "backfill_bundle.json"
        with open(output, "w") as fh:
            fh.write(bundle.to_json())
        status = job.status()
        log.info(
            "backfill %s complete: %d event proofs, %d witness blocks → %s "
            "(%d/%d windows replayed from journal, first chunk %.2fs, "
            "total %.2fs)",
            job.job_id, len(bundle.event_proofs), len(bundle.blocks), output,
            status["windows_replayed"], status["windows_total"],
            status["first_chunk_s"] or 0.0, status["wall_s"],
        )
    except Exception as exc:  # fail-soft: CLI exit path — report + rc 1
        if is_device_fault(exc):
            log.error("backfill stopped on a device fault (windows journalled): %s", exc)
        else:
            log.error("backfill failed: %s", exc)
        rc = 1
    finally:
        engine.close()
        if plane is not None:
            plane.close()
            log.info("fetch plane: %s", plane.stats())
        if disk is not None:
            disk.close()
        if client is not None:
            _close_client(client)
    if args.metrics:
        print(metrics.to_json(), file=sys.stderr)
    return rc


def _cmd_vectors(args) -> int:
    """Capture live-chain byte-compat vectors (headers, TxMeta,
    receipts-AMT root) into a fixtures JSON the test suite consumes."""
    from ipc_proofs_tpu_torch.proofs.vectors import capture_vectors, check_vectors, write_vectors

    client = _make_rpc_client(args)
    doc = capture_vectors(client, args.height)
    n = check_vectors(doc)  # never write vectors we cannot re-verify
    output = args.output or "vectors.json"
    write_vectors(doc, output)
    log.info("captured %d vectors at height %d → %s", n, args.height, output)
    log.info("re-run the byte-compat suite with IPC_VECTORS_FILE=%s", output)
    return 0


def _cmd_cert(args) -> int:
    """Inspect / validate F3 finality certificates (JSON or go-f3 CBOR)."""
    from ipc_proofs_tpu_torch.proofs.cert import (
        FinalityCertificate,
        FinalityCertificateChain,
        PowerTableEntry,
    )
    from ipc_proofs_tpu_torch.proofs.cert_cbor import (
        certificate_from_cbor,
        certificate_to_cbor,
    )

    def load_cert(path: str) -> FinalityCertificate:
        with open(path, "rb") as fh:
            raw = fh.read()
        # JSON certificates are Forest-style objects; anything that does
        # not parse as JSON is treated as certexchange CBOR
        try:
            obj = json.loads(raw)
        except ValueError:
            return certificate_from_cbor(raw)
        return FinalityCertificate.from_json_obj(obj)

    certs = [load_cert(p) for p in args.certificates]
    chain = FinalityCertificateChain(certificates=certs)

    table = None
    if args.power_table:
        with open(args.power_table) as fh:
            rows = json.load(fh)
        if not isinstance(rows, list):
            raise SystemExit("power table JSON must be a list of rows")
        table = [
            PowerTableEntry(
                participant_id=int(r["ParticipantID"]),
                power=int(r["Power"]),
                signing_key=str(r["SigningKey"]),
                pop=str(r.get("Pop", "")),
            )
            for r in rows
        ]

    if args.verify_signatures and table is None:
        raise SystemExit("--verify-signatures requires --power-table")

    if args.emit_cbor:
        if len(certs) != 1:
            raise SystemExit("--emit-cbor takes exactly one certificate")
        with open(args.emit_cbor, "wb") as fh:
            fh.write(certificate_to_cbor(certs[0]))
        log.info("wrote certexchange CBOR → %s", args.emit_cbor)

    status = "ok"
    error = None
    final_table_size = None
    try:
        final = chain.validate(
            initial_power_table=table,
            verify_signatures=args.verify_signatures,
            verify_table_cids=table is not None,
            network=args.network,
        )
        final_table_size = len(final) if final is not None else None
    except ValueError as exc:
        status, error = "invalid", str(exc)

    print(
        json.dumps(
            {
                "certificates": len(certs),
                "instances": [c.instance for c in certs],
                "epochs": [
                    [c.ec_chain[0].epoch, c.ec_chain[-1].epoch] if c.ec_chain else None
                    for c in certs
                ],
                "signatures_verified": bool(args.verify_signatures) and status == "ok",
                "final_power_table_rows": final_table_size,
                "status": status,
                "error": error,
            }
        )
    )
    return 0 if status == "ok" else 1


def _cmd_demo(args) -> int:
    """The reference `main.rs` flow, hermetic: synthesize a chain, generate
    one storage + one event proof, verify offline, print results."""
    from ipc_proofs_tpu_torch.fixtures import ContractFixture, EventFixture, build_chain
    from ipc_proofs_tpu_torch.proofs.event_verifier import create_event_filter
    from ipc_proofs_tpu_torch.proofs.generator import (
        EventProofSpec,
        StorageProofSpec,
        generate_proof_bundle,
    )
    from ipc_proofs_tpu_torch.proofs.storage_batch import MappingSlotSpec, hash_slot_specs
    from ipc_proofs_tpu_torch.proofs.trust import TrustPolicy
    from ipc_proofs_tpu_torch.proofs.verifier import verify_proof_bundle
    from ipc_proofs_tpu_torch.state.storage import calculate_storage_slot

    backend = _backend(args.backend)
    sig = "NewTopDownMessage(bytes32,uint256)"
    subnet = "calib-subnet-1"
    actor = 1001

    world = build_chain(
        [
            ContractFixture(
                actor_id=actor, storage={calculate_storage_slot(subnet, 0): (15).to_bytes(1, "big")}
            )
        ],
        [
            [EventFixture(emitter=actor, signature=sig, topic1=subnet, data=b"\x0f".rjust(32, b"\x00"))],
            [],
            [EventFixture(emitter=actor, signature=sig, topic1=subnet, data=b"\x10".rjust(32, b"\x00"))],
        ],
        parent_height=2_992_953,
    )
    # the fixture's slot is the world's setup; the proof's slot hashes on
    # the backend
    (slot,) = hash_slot_specs([MappingSlotSpec(actor_id=actor, key=subnet, slot_index=0)], backend)
    bundle = generate_proof_bundle(
        world.store,
        world.parent,
        world.child,
        [StorageProofSpec(actor_id=actor, slot=slot)],
        [EventProofSpec(event_signature=sig, topic_1=subnet, actor_id_filter=actor)],
        match_backend=backend,
    )
    print("Unified Proof Bundle generated:")
    print(f"  Storage proofs: {len(bundle.storage_proofs)}")
    print(f"  Event proofs: {len(bundle.event_proofs)}")
    print(f"  Total witness blocks: {len(bundle.blocks)}")

    result = verify_proof_bundle(
        bundle,
        TrustPolicy.accept_all(),
        event_filter=create_event_filter(sig, subnet),
        verify_witness_cids=True,
        cid_backend=backend,
    )
    print("Verification Results:")
    print(f"  Storage proofs valid: {result.storage_results}")
    print(f"  Event proofs valid: {result.event_results}")
    print(f"  All valid: {result.all_valid()}")
    return 0 if result.all_valid() else 1


def _parse_tenant_weights(specs) -> "dict | None":
    """Parse repeated ``--tenant-weight name=N`` into ``{name: N}``.
    Returns None when no weights were given (the FairQueue default —
    every tenant weighs 1). Bad specs abort with exit code 2."""
    if not specs:
        return None
    out: "dict[str, int]" = {}
    for spec in specs:
        name, sep, num = str(spec).partition("=")
        try:
            weight = int(num)
        except ValueError:
            weight = 0
        if not sep or not name or weight < 1:
            raise SystemExit(
                f"--tenant-weight must be name=N with N >= 1 (got {spec!r})"
            )
        out[name] = weight
    return out


def _cmd_serve(args) -> int:
    """Long-running proof service: micro-batched verify/generate over HTTP.

    Three store modes:
    - default: verify-only (``POST /v1/verify`` + ``/metrics``/``/healthz``);
    - ``--demo-world N``: hermetic synthetic range world with N tipset
      pairs — enables ``POST /v1/generate {"pair_index": i}`` with no
      network egress (the serving analogue of ``demo``);
    - ``--endpoint`` + ``--from-height/--to-height``: RPC-backed store,
      pair table fetched from the chain (requires ``--event-sig/--topic1``).

    Every kernel runs on the ``--backend`` (the card by default; without
    CUDA the command exits with the backend's error before it binds).
    """
    import os
    import signal

    from ipc_proofs_tpu_torch.obs.fleet import TenantLedger
    from ipc_proofs_tpu_torch.proofs.event_verifier import create_event_filter
    from ipc_proofs_tpu_torch.proofs.generator import EventProofSpec
    from ipc_proofs_tpu_torch.proofs.range import TipsetPair
    from ipc_proofs_tpu_torch.proofs.trust import TrustPolicy
    from ipc_proofs_tpu_torch.serve import ProofHTTPServer, ProofService, ServiceConfig
    from ipc_proofs_tpu_torch.utils.metrics import Metrics

    # the card (or the plain versions) first: a host without CUDA fails here
    backend = _backend(args.backend, args.mesh_devices)
    # the service owns its metrics registry (not the process-global one) so
    # /metrics reflects exactly this server; the RPC client/pool feed it too
    metrics = Metrics()

    store, pairs, spec = None, [], None
    if args.demo_world:
        from ipc_proofs_tpu_torch.fixtures import build_range_world

        sig = args.event_sig or "NewTopDownMessage(bytes32,uint256)"
        topic1 = args.topic1 or "calib-subnet-1"
        store, pairs, n_matching = build_range_world(
            args.demo_world,
            receipts_per_pair=args.demo_receipts,
            match_rate=args.demo_match_rate,
            signature=sig,
            topic1=topic1,
        )
        spec = EventProofSpec(event_signature=sig, topic_1=topic1)
        log.info("demo world: %d pairs, %d matching events", len(pairs), n_matching)
    endpoint_pool = None
    client = None
    if not args.demo_world and (args.endpoint or args.endpoints):
        from ipc_proofs_tpu_torch.proofs.chain import Tipset
        from ipc_proofs_tpu_torch.store.failover import EndpointPool
        from ipc_proofs_tpu_torch.store.rpc import RpcBlockstore

        if args.from_height is None or args.to_height is None:
            log.error("--endpoint requires --from-height and --to-height")
            return 2
        if not (args.event_sig and args.topic1):
            log.error("--endpoint requires --event-sig and --topic1")
            return 2
        client = _make_rpc_client(args, metrics=metrics, backend=backend)
        if isinstance(client, EndpointPool):
            endpoint_pool = client  # /healthz reports per-endpoint breakers
        tipsets = [Tipset.fetch(client, h) for h in range(args.from_height, args.to_height + 2)]
        pairs = [
            TipsetPair(parent=tipsets[i], child=tipsets[i + 1])
            for i in range(len(tipsets) - 1)
        ]
        store = RpcBlockstore(client)
        spec = EventProofSpec(event_signature=args.event_sig, topic_1=args.topic1)

    if args.f3_cert:
        from ipc_proofs_tpu_torch.proofs.cert import FinalityCertificate

        with open(args.f3_cert) as fh:
            cert = FinalityCertificate.from_json_obj(json.load(fh))
        policy = TrustPolicy.with_f3_certificate(cert)
    else:
        log.warning("no F3 certificate — accept-all trust (testing only)")
        policy = TrustPolicy.accept_all()

    service = ProofService(
        store=store,
        spec=spec,
        trust_policy=policy,
        event_filter=(
            create_event_filter(args.event_sig, args.topic1)
            if args.event_sig and args.topic1
            else None
        ),
        config=ServiceConfig(
            max_batch=args.max_batch,
            max_wait_ms=args.max_wait_ms,
            queue_capacity=args.queue_capacity,
            workers=args.workers,
            cache_max_bytes=args.cache_max_bytes,
            cache_ttl_s=args.cache_ttl_s,
            verify_witness_cids=args.check_cids,
            range_scan_threads=args.scan_threads,
            range_pipeline_depth=args.pipeline_depth,
            threads=args.threads,
            slow_request_ms=args.slow_ms,
            store_dir=args.store_dir,
            store_cap_bytes=args.store_cap_bytes,
            store_segment_max_bytes=args.store_segment_max_bytes,
            store_owner=args.store_owner,
            batch_rpc=args.batch_rpc,
            speculate_depth=args.speculate_depth,
            match_backend="gpu",
            device=None if args.backend == "gpu" else "cpu",
            mesh_devices=args.mesh_devices,
            witness_delta=(args.witness_delta == "on"),
            witness_compress=(args.witness_compress == "on"),
            witness_agg_max=args.witness_agg_max,
            witness_base_cache=args.witness_base_cache,
            tenant_rate=args.tenant_rate,
            tenant_burst=args.tenant_burst,
            tenant_weights=_parse_tenant_weights(args.tenant_weight),
            admit_gradient=args.admit_gradient,
            admit_delay_budget_ms=args.admit_delay_budget_ms,
            deadline_floor_ms=args.deadline_floor_ms,
            retry_budget=args.retry_budget,
            registry_dir=args.registry_dir,
            registry_owner=args.registry_owner,
            registry_fsync=(args.registry_fsync == "on"),
        ),
        endpoint_pool=endpoint_pool,
        metrics=metrics,
    )
    follower = None
    leader_lock = None
    if args.follow:
        if client is None or service.blockstore is None:
            log.error("--follow requires --endpoint (a chain to follow)")
            service.drain()
            return 2
        from ipc_proofs_tpu_torch.storex import ChainFollower, FollowLeaderLock

        lead = True
        if args.store_dir:
            # shared disk tier → exactly one follower per cluster: the
            # flock winner tails the chain for everyone, losers serve only
            # (and the kernel hands the lock to a successor if we die)
            leader_lock = FollowLeaderLock(args.store_dir)
            lead = leader_lock.try_acquire(metrics=metrics)
        if lead:
            follower = ChainFollower(
                client,
                service.blockstore,
                metrics=metrics,
                poll_s=args.follow_poll_s,
                backend=service.match_backend,
            )
            follower.start()
            log.info(
                "chain follower: tailing finalized tipsets every %.1fs%s",
                args.follow_poll_s,
                " (elected leader)" if args.store_dir else "",
            )
        else:
            log.info("chain follower: another shard leads (%s) — serving only", leader_lock.path)
    durable = None
    if args.queue_dir:
        from ipc_proofs_tpu_torch.serve.durable import DurableAdmission

        durable = DurableAdmission(
            service,
            args.queue_dir,
            pairs=pairs,
            results_max_bytes=args.results_cache_bytes,
        )
        if durable.resumed_jobs:
            log.info(
                "durable queue: re-executed %d admitted-but-unfinished "
                "request(s) from %s", durable.resumed_jobs, args.queue_dir,
            )
    subs = None
    if args.subs_dir:
        from ipc_proofs_tpu_torch.subs import StandingQueries

        if service.blockstore is None:
            log.error("--subs-dir needs a store (--demo-world or --endpoint)")
            service.drain()
            return 2
        subs = StandingQueries(
            args.subs_dir,
            store=service.blockstore,
            metrics=metrics,
            chunk_size=service.config.range_chunk_size,
            match_backend=service.match_backend,
            log_cap_bytes=args.subs_log_cap_bytes,
            push_max_inflight=args.push_max_inflight,
            retry_attempts=args.delivery_retry_attempts,
            retry_base_s=args.delivery_retry_base_s,
            retry_max_s=args.delivery_retry_max_s,
            delta=(args.witness_delta == "on"),
            # generate-capable service → standing-query generations ride
            # the batcher's PUSH lane (one priority order with
            # interactive requests and backfill windows)
            service=(service if spec is not None and store is not None else None),
            # fleet base directory: pushed bundles + acked bases seal into
            # the provenance chain so deltas survive failover fleet-wide
            provenance=service.registry,
            fleet=args.subs_fleet,
        )
        if subs.registry.replayed:
            log.info(
                "standing queries: %d subscription(s) active after replay, "
                "%d unacked delivery(ies) re-pushing",
                len(subs.registry), subs.log.pending_total(),
            )
        if follower is not None:
            # the streaming plane: each finalized tipset the (leader)
            # follower warms also drives match → generate-once → fan-out
            follower.add_finalized_hook(subs.on_tipset)
    slo = None
    if args.slo == "on":
        slo = _build_slo_watchdog(args, metrics)
        slo.start()
    backfill = None
    if args.backfill_jobs_dir:
        if spec is None or store is None or not pairs:
            log.error(
                "--backfill-jobs-dir needs a generate-capable service "
                "(--demo-world or --endpoint)"
            )
            if slo is not None:
                slo.stop()
            if subs is not None:
                subs.drain()
            service.drain()
            return 2
        from ipc_proofs_tpu_torch.backfill import BackfillEngine

        def _run_backfill_window(window, wpairs):
            # LOW lane: a backfill window only dispatches when the
            # interactive verify/generate queue is empty
            return service.submit_range_window(wpairs).result()

        backfill = BackfillEngine(
            pairs,
            spec,
            _run_backfill_window,
            jobs_dir=args.backfill_jobs_dir,
            window_size=args.backfill_window_size,
            plane=service.fetch_plane,
            metrics=metrics,
            delivery=(subs.log if subs is not None else None),
        )
        log.info(
            "backfill: /v1/backfill mounted (jobs dir %s, window %d)",
            args.backfill_jobs_dir, args.backfill_window_size,
        )

    httpd = ProofHTTPServer(
        service, host=args.host, port=args.port, pairs=pairs, durable=durable,
        subs=subs, slo=slo,
        tenants=TenantLedger(metrics=metrics, top_k=args.tenant_top_k),
        backfill=backfill,
    )
    if args.port_file:
        # atomic write: a polling parent never reads a half-written port
        tmp = args.port_file + ".tmp"
        with open(tmp, "w") as fh:
            fh.write(str(httpd.port))
        os.replace(tmp, args.port_file)
    log.info(
        "serving on %s (verify%s; max_batch=%d max_wait=%.1fms capacity=%d "
        "workers=%d; kernels on %s)",
        httpd.address,
        " + generate" if spec is not None and store is not None else " only",
        args.max_batch, args.max_wait_ms, args.queue_capacity, args.workers,
        backend.device,
    )
    # the launches of start-up (the lane's crossover measurement over a new
    # --store-dir); the drain's line less this one is what serving launched
    log.info("kernel launches: %s", json.dumps(_kernel_launches()))

    def _sigterm(_signum, _frame):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _sigterm)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        log.info("draining (flushing accepted requests)…")
    finally:
        if follower is not None:
            follower.stop()
        httpd.shutdown()
        if leader_lock is not None:
            leader_lock.release()
        if client is not None:
            _close_client(client)
    log.info("drained; final metrics:\n%s", json.dumps(service.metrics_snapshot()))
    log.info("kernel launches: %s", json.dumps(_kernel_launches()))
    return 0


def _cmd_cluster(args) -> int:
    """Sharded serve plane: spawn N serve shards + the consistent-hash
    router, all over one hermetic ``--demo-world``.

    Each shard is a full ``serve`` child process (own GIL, own durable
    queue under ``--queue-dir/s<k>``, own ``--store-owner`` token in the
    shared ``--store-dir``) running its kernels on ``--backend`` (the card
    by default: every shard on the one card this host has); the router
    front door speaks the exact single-daemon wire protocol, so existing
    clients work unchanged. The router launches no kernel. Under
    ``--backend gpu`` the parent builds the kernels once (nvcc needs no
    CUDA context) before any shard starts, so N children never race N
    compilers; each shard's stderr, with its ``kernel launches:`` lines,
    goes to the log file this command names for it.
    """
    import os
    import signal

    from ipc_proofs_tpu_torch.cluster import (
        ClusterRouter,
        RemoteShard,
        RouterHTTPServer,
        spawn_serve_shard,
    )
    from ipc_proofs_tpu_torch.fixtures import build_range_world
    from ipc_proofs_tpu_torch.obs import tracing_enabled
    from ipc_proofs_tpu_torch.utils.metrics import Metrics

    shard_urls = list(args.shard_url or ())
    if args.shards < 1 and not shard_urls:
        log.error("--shards must be >= 1 (or give at least one --shard-url)")
        return 2
    if args.shards < 0:
        log.error("--shards must be >= 0")
        return 2
    if not args.demo_world:
        log.error("cluster currently requires --demo-world (hermetic mode)")
        return 2
    tenant_weights = _parse_tenant_weights(args.tenant_weight)
    # the card first: a host without CUDA fails here, before any shard
    _backend(args.backend)
    if args.backend == "gpu" and args.shards:
        from ipc_proofs_tpu_torch.ops.build import KERNEL_LIBRARIES, DeviceFaultError, build_libraries

        try:
            build_libraries(KERNEL_LIBRARIES)
        except DeviceFaultError as exc:
            log.error("kernel build failed: %s", exc)
            return 1

    metrics = Metrics()
    tracing = tracing_enabled()  # a trace flag was given (`_traced`)
    sig = args.event_sig or "NewTopDownMessage(bytes32,uint256)"
    topic1 = args.topic1 or "calib-subnet-1"
    # the router needs the pair table the shards will rebuild — the world
    # builder is deterministic, so building it here yields the same table
    _store, pairs, _n = build_range_world(
        args.demo_world,
        receipts_per_pair=args.demo_receipts,
        match_rate=args.demo_match_rate,
        signature=sig,
        topic1=topic1,
    )

    extra: "list[str]" = [
        "--demo-receipts", str(args.demo_receipts),
        "--demo-match-rate", str(args.demo_match_rate),
        "--backend", args.backend,
    ]
    if tracing:
        # the shards must run their span collector too so sampled requests
        # ship their subtree back for stitching (the router grafts them
        # under its dispatch spans); the shard-side export goes nowhere
        extra += [
            "--trace-out", os.devnull,
            "--trace-sample", str(args.trace_sample),
        ]
    if args.store_cap_bytes is not None:
        extra += ["--store-cap-bytes", str(args.store_cap_bytes)]
    if args.store_segment_max_bytes is not None:
        extra += ["--store-segment-max-bytes", str(args.store_segment_max_bytes)]
    # witness diet knobs are cluster-wide: every shard must negotiate the
    # same encodings or the router's scatter-gather sees mixed wire shapes
    extra += [
        "--witness-delta", args.witness_delta,
        "--witness-compress", args.witness_compress,
        "--witness-agg-max", str(args.witness_agg_max),
        "--witness-base-cache", str(args.witness_base_cache),
    ]
    if tenant_weights:
        # fair-lane weights apply where the queues live: in each shard's
        # batcher (the router door throttles, shards order)
        for name, weight in sorted(tenant_weights.items()):
            extra += ["--tenant-weight", f"{name}={weight}"]
    if args.subs_dir:
        # push/retry knobs are cluster-wide; the registry itself shards
        # per process (DIR/s<k>) and the router places subscriptions on
        # their filter-affine arc
        extra += [
            "--push-max-inflight", str(args.push_max_inflight),
            "--delivery-retry-attempts", str(args.delivery_retry_attempts),
            "--delivery-retry-base-s", str(args.delivery_retry_base_s),
            "--delivery-retry-max-s", str(args.delivery_retry_max_s),
            "--subs-log-cap-bytes", str(args.subs_log_cap_bytes),
        ]

    shards = []
    try:
        for k in range(args.shards):
            name = f"s{k}"
            shard_extra = list(extra)
            if args.subs_dir:
                shard_extra += [
                    "--subs-dir", os.path.join(args.subs_dir, name)
                ]
            if args.registry_dir:
                # ONE shared provenance/base directory, one single-writer
                # log per shard (reg-s<k>.log) — this sharing is what lets
                # any shard answer for a base another shard served
                shard_extra += [
                    "--registry-dir", args.registry_dir,
                    "--registry-owner", name,
                    "--registry-fsync", args.registry_fsync,
                    "--subs-fleet", args.subs_fleet,
                ]
            shards.append(
                spawn_serve_shard(
                    name,
                    args.demo_world,
                    sig,
                    topic1,
                    store_dir=args.store_dir,
                    queue_dir=(
                        os.path.join(args.queue_dir, name)
                        if args.queue_dir
                        else None
                    ),
                    extra_args=shard_extra,
                )
            )
            log.info(
                "shard %s up at %s (log %s)",
                name, shards[-1].url, shards[-1].log_path,
            )
    except RuntimeError as exc:
        log.error("shard spawn failed: %s", exc)
        for sh in shards:
            sh.kill()
        return 1

    # multi-host members: daemons someone else runs, probed before
    # admission so a typo'd URL fails loudly at boot instead of as a
    # string of failovers under traffic
    for url in shard_urls:
        member = RemoteShard(url)
        health = member.probe()
        if health is None:
            log.error("remote shard %s is unreachable — not admitted", url)
            for sh in shards:
                sh.kill()
            return 1
        log.info(
            "remote shard %s up at %s (status=%s)",
            member.name, member.url, health.get("status"),
        )
        shards.append(member)

    slo = None
    if args.slo == "on":
        slo = _build_slo_watchdog(args, metrics)
    router = ClusterRouter(
        {sh.name: sh.url for sh in shards},
        pairs,
        steal_threshold=args.steal_threshold,
        steal_latency_unit_s=args.steal_latency_unit_s,
        deadline_floor_ms=args.deadline_floor_ms,
        replication_factor=args.replication_factor,
        cut_through=(args.cut_through == "on"),
        metrics=metrics,
        scrape_interval_s=args.scrape_interval_s,
        scrape_timeout_s=args.scrape_timeout_s,
        slo=slo,
        tenant_top_k=args.tenant_top_k,
        # QoS lives at the front door only: a router-admitted request
        # must never 429 mid-scatter, so shards run unthrottled
        tenant_rate=args.tenant_rate,
        tenant_burst=args.tenant_burst,
    )
    httpd = RouterHTTPServer(router, host=args.host, port=args.port)
    httpd.start()
    if args.port_file:
        tmp = args.port_file + ".tmp"
        with open(tmp, "w") as fh:
            fh.write(str(httpd.port))
        os.replace(tmp, args.port_file)
    log.info(
        "cluster router on %s (%d shards, steal_threshold=%d, pairs=%d, "
        "shard kernels on --backend %s)",
        httpd.address, len(shards), args.steal_threshold, len(pairs),
        args.backend,
    )
    if args.replication_factor > 1:
        # seed the replica tier now — every owner's segments mirror onto
        # its ring successors before the first corrupt frame needs them
        summary = router.replicate_now()
        log.info(
            "replication pass: R=%d, %d under-replicated arc(s), "
            "lag=%d segment(s)",
            args.replication_factor,
            len(summary.get("under_replicated") or ()),
            summary.get("lag_segments", 0),
        )

    def _sigterm(_signum, _frame):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _sigterm)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        log.info("cluster draining (router first, then shards)…")
    finally:
        httpd.shutdown()
        for sh in shards:
            sh.stop()
    log.info("cluster down; router metrics:\n%s", json.dumps(metrics.snapshot()))
    return 0


def _kernel_launches() -> dict:
    """Every kernel wrapper's launch count in this process (a wrapper
    counts its launches on the card, never a CPU tensor's plain version)."""
    from ipc_proofs_tpu_torch.ops import blake2b, keccak, match
    from ipc_proofs_tpu_torch.parallel import pipeline

    return {**blake2b.LAUNCHES, **keccak.LAUNCHES, **match.LAUNCHES, **pipeline.LAUNCHES}


def speculate_depth_arg(value):
    # "auto" → adaptive backoff (FetchPlane lowers the depth when the
    # speculation waste ratio spikes); anything else must parse as int
    if value == "auto":
        return value
    try:
        return int(value)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"expected an integer or 'auto', got {value!r}"
        )


def _add_backend_flag(p) -> None:
    p.add_argument(
        "--backend", default="gpu", choices=BACKENDS,
        help="where the kernels run: gpu (the card, default; fails without "
        "CUDA), cpu or none (the plain PyTorch versions on the host)",
    )


def main(argv=None) -> int:
    from ipc_proofs_tpu_torch.obs import install_crash_dump

    install_crash_dump()  # an unhandled error dumps the flight recorder
    parser = argparse.ArgumentParser(prog="ipc-proofs-tpu-torch")
    sub = parser.add_subparsers(dest="command", required=True)

    def add_failover_flags(p):
        p.add_argument(
            "--endpoints", action="append", default=None, metavar="URL",
            help="additional Lotus endpoint replicas (repeatable): enables "
            "the failover pool — circuit breakers, health-scored routing, "
            "hedged fetches, per-endpoint integrity demotion",
        )
        p.add_argument(
            "--hedge-ms", type=float, default=None,
            help="hedged block fetches: fire a second fetch on the next "
            "healthy endpoint after this many ms (floor; the observed p99 "
            "raises it). Default: hedging off",
        )
        p.add_argument(
            "--breaker-threshold", type=int, default=5,
            help="consecutive failures that open an endpoint's circuit "
            "breaker (default 5)",
        )

    def add_trace_export_flags(p):
        p.add_argument(
            "--trace-out", default=None, metavar="PATH",
            help="export all command/stage/RPC/pool/journal spans as Chrome "
            "trace-event JSON (open at ui.perfetto.dev)",
        )
        p.add_argument(
            "--trace-otlp", default=None, metavar="PATH",
            help="also export collected spans as OTLP/JSON "
            "(resourceSpans/scopeSpans shape — POST to any OpenTelemetry "
            "collector's /v1/traces)",
        )
        p.add_argument(
            "--trace-otlp-url", default=None, metavar="URL",
            help="POST collected spans as OTLP/JSON to a live collector "
            "endpoint (e.g. http://localhost:4318/v1/traces); retried with "
            "bounded exponential backoff, fail-soft — a dead collector "
            "costs a warning and a trace.otlp_post_failures tick, never "
            "the run",
        )
        p.add_argument(
            "--trace-sample", type=float, default=1.0, metavar="RATE",
            help="head-sample collected traces at this rate in [0,1] "
            "(decided once per trace from its id, so exported trees are "
            "never torn; the always-on flight recorder ignores sampling). "
            "Default 1.0",
        )

    def add_store_flags(p):
        p.add_argument(
            "--store-dir", default=None, metavar="DIR",
            help="disk tier for fetched blocks: content-addressed "
            "append-only segment files under DIR, CRC-framed and "
            "multihash-verified on every read, LRU-evicted at "
            "--store-cap-bytes. Survives restarts — a re-run over the same "
            "heights refetches nothing",
        )
        p.add_argument(
            "--store-cap-bytes", type=int, default=1 << 30,
            help="byte cap on the disk tier (whole cold segments are "
            "evicted; default 1 GiB)",
        )
        p.add_argument(
            "--store-segment-max-bytes", type=int, default=64 << 20,
            help="roll the active segment at this size (default 64 MiB)",
        )

    def add_fetch_plane_flags(p):
        p.add_argument(
            "--batch-rpc", action=argparse.BooleanOptionalAction, default=True,
            help="async fetch plane: ship block wants as JSON-RPC batch "
            "arrays (one round-trip per wave) and let HAMT/AMT walkers "
            "prefetch child links speculatively; endpoints that reject "
            "batch framing fall back to sequential calls automatically. "
            "--no-batch-rpc restores the one-call-per-block path",
        )
        p.add_argument(
            "--speculate-depth", type=speculate_depth_arg, default=1,
            metavar="N|auto",
            help="how many link levels the fetch plane chases below a "
            "decoded HAMT/AMT interior node (0 = batch demand fetches "
            "only, no speculation; default 1). 'auto' starts at 2 and "
            "backs off one level whenever a 64-fetch speculation window "
            "wastes more than 60%% of what it fetched",
        )

    def add_witness_flags(p):
        p.add_argument(
            "--witness-delta", choices=["on", "off"], default="on",
            help="delta witnesses: honor If-Witness-Base / base_digest on "
            "requests (ship only blocks the client's base bundle lacks). "
            "Base mismatches fall back to full bundles "
            "(witness.delta_fallbacks) — never a wrong delta (default on)",
        )
        p.add_argument(
            "--witness-compress", choices=["on", "off"], default="on",
            help="compressed witness framing: honor witness_encoding / "
            "Accept-Witness-Encoding zlib (and zstd when importable) — "
            "canonical-order block frame + uncompressed digest; 'off' "
            "rejects compressed encodings with a typed 400 (default on)",
        )
        p.add_argument(
            "--witness-agg-max", type=int, default=1024, metavar="K",
            help="cap on claims per aggregated generate_range request "
            "(aggregate: true) — one merged witness + per-claim span "
            "table; beyond K the request gets a typed 400 (default 1024)",
        )
        p.add_argument(
            "--witness-base-cache", type=int, default=64, metavar="N",
            help="server-side LRU of witness base digests → CID sets used "
            "to answer delta requests (default 64 bases)",
        )

    def add_registry_flags(p):
        p.add_argument(
            "--registry-dir", default=None, metavar="DIR",
            help="proof provenance registry: seal every served bundle "
            "into a hash-linked IPR1 audit log (reg-<owner>.log) under "
            "DIR, mount GET /v1/registry/{head,entry,proof,consistency}, "
            "and use DIR as the fleet-wide delta base directory (shards "
            "sharing DIR see each other's serve records). Appends are "
            "fail-soft: registry trouble degrades /healthz, never serving",
        )
        p.add_argument(
            "--registry-owner", default="main", metavar="TOKEN",
            help="writer token naming this process's registry log file "
            "(each process sharing --registry-dir needs its own; default "
            "main)",
        )
        p.add_argument(
            "--registry-fsync", choices=["on", "off"], default="off",
            help="fsync each registry frame (durable audit contract) "
            "instead of riding the page cache; 'off' keeps append "
            "overhead under the 1%% serve-wall budget (default off)",
        )
        p.add_argument(
            "--subs-fleet", default="default", metavar="NAME",
            help="subscriber-fleet label for registry base records: acked "
            "delta bases are keyed (fleet, filter key) so any shard can "
            "find the newest base the whole fleet acked (default default)",
        )

    def add_subs_flags(p):
        p.add_argument(
            "--subs-dir", default=None, metavar="DIR",
            help="standing queries: durable subscription registry + "
            "delivery log under DIR (IPJ1 journals — registrations and "
            "unacked deliveries survive restart). Mounts /v1/subscribe, "
            "/v1/unsubscribe, /v1/subscriptions and the long-poll "
            "/v1/deliveries; with --follow, each finalized tipset "
            "generates once per distinct filter and fans out to every "
            "subscriber (webhook push or long-poll)",
        )
        p.add_argument(
            "--push-max-inflight", type=int, default=4, metavar="N",
            help="webhook push worker threads (bounded fan-out; default 4)",
        )
        p.add_argument(
            "--delivery-retry-attempts", type=int, default=4, metavar="N",
            help="webhook attempts per delivery before leaving it unacked "
            "for long-poll / next-cycle re-push (default 4)",
        )
        p.add_argument(
            "--delivery-retry-base-s", type=float, default=0.25,
            help="full-jitter backoff base delay between webhook attempts "
            "(default 0.25)",
        )
        p.add_argument(
            "--delivery-retry-max-s", type=float, default=4.0,
            help="full-jitter backoff delay cap (default 4.0)",
        )
        p.add_argument(
            "--subs-log-cap-bytes", type=int, default=64 * 1024 * 1024,
            help="compact the delivery journal above this size — only "
            "acked history is dropped, unacked deliveries always survive "
            "(default 64 MiB)",
        )

    def add_slo_flags(p):
        p.add_argument(
            "--slo", default="off", choices=["on", "off"],
            help="run the SLO burn-rate watchdog: multi-window "
            "(fast/slow) burn rates per declarative target, an 'slo' "
            "block in /healthz, WARN records into the flight ring, and "
            "anomaly signatures (breaker flap storms, eviction storms, "
            "speculation-waste spikes). Default off",
        )
        p.add_argument(
            "--slo-availability", type=float, default=0.999,
            help="availability objective (fraction of requests that must "
            "not be rejected/failed; default 0.999)",
        )
        p.add_argument(
            "--slo-generate-p99-ms", type=float, default=2000.0,
            help="generate latency target: p99 must stay under this "
            "(default 2000)",
        )
        p.add_argument(
            "--slo-delivery-lag-p99-ms", type=float, default=5000.0,
            help="standing-query delivery lag target: p99 append→ack lag "
            "must stay under this (default 5000)",
        )
        p.add_argument(
            "--slo-interval-s", type=float, default=5.0,
            help="watchdog evaluation interval (default 5)",
        )
        p.add_argument(
            "--slo-fast-window-s", type=float, default=300.0,
            help="fast burn-rate window (default 300 = 5 min)",
        )
        p.add_argument(
            "--slo-slow-window-s", type=float, default=3600.0,
            help="slow burn-rate window (default 3600 = 1 h)",
        )

    def add_tenant_admission_flags(p):
        p.add_argument(
            "--tenant-top-k", type=int, default=8, metavar="K",
            help="track per-tenant request/byte counters for the first K "
            "distinct tenants; later tenants aggregate into the 'other' "
            "bucket (bounds metric cardinality; default 8)",
        )
        p.add_argument(
            "--tenant-rate", type=float, default=None, metavar="R",
            help="per-tenant QoS: admit at most R proof requests/second "
            "per tenant (token bucket; sustained excess gets a typed 429 "
            "with Retry-After). Also arms the batcher's weighted-fair "
            "tenant ordering. Default off (no throttling)",
        )
        p.add_argument(
            "--tenant-burst", type=float, default=None, metavar="B",
            help="token-bucket burst depth per tenant (default 2×R): "
            "short spikes up to B requests admit immediately, then the "
            "bucket refills at --tenant-rate",
        )
        p.add_argument(
            "--tenant-weight", action="append", default=None,
            metavar="NAME=N",
            help="deficit weight for one tenant in the batcher's fair "
            "interactive lane (repeatable): a weight-N tenant drains up "
            "to N queued requests per round-robin turn; unlisted tenants "
            "weigh 1",
        )
        p.add_argument(
            "--admit-gradient", action="store_true",
            help="adaptive admission: replace the static queue bound as "
            "the effective concurrency gate with an AIMD limit driven by "
            "observed queue delay (grows +1 while p99 delay is well under "
            "budget, shrinks ×0.8 past it). Overload sheds with a typed "
            "429 + honest Retry-After from the drain estimate; unnamed "
            "('other') tenants shed before --tenant-weight tenants. "
            "Default off (static --queue-capacity only)",
        )
        p.add_argument(
            "--admit-delay-budget-ms", type=float, default=250.0,
            metavar="MS",
            help="queue-delay p99 budget steering --admit-gradient "
            "(default 250)",
        )
        p.add_argument(
            "--deadline-floor-ms", type=float, default=5.0, metavar="MS",
            help="deadline propagation floor: a request whose remaining "
            "budget (X-IPC-Deadline-Ms header / deadline_ms body field) "
            "is at/below this refuses typed (504, error_type=deadline) at "
            "each hop instead of burning a worker on an answer nobody "
            "can use (default 5)",
        )
        p.add_argument(
            "--retry-budget", type=float, default=None, metavar="R",
            help="pool-wide client retry budget in retries/second across "
            "ALL endpoints (token bucket, burst 2×R): during a broad "
            "outage retries stop amplifying load once the budget is dry "
            "(rpc.retry_budget_exhausted) and requests surface their "
            "error instead. Default off (per-request backoff only)",
        )

    gen = sub.add_parser("generate", help="generate a proof bundle from a live chain")
    gen.add_argument("--endpoint", required=True, help="Lotus JSON-RPC endpoint URL")
    gen.add_argument("--token", default=None, help="bearer token")
    gen.add_argument("--timeout", type=float, default=250.0)
    gen.add_argument("--height", type=int, required=True, help="parent epoch H (child is H+1)")
    gen.add_argument("--contract", help="EVM contract address 0x…")
    gen.add_argument("--actor-id", type=int, default=None, help="skip address resolution")
    gen.add_argument("--slot-subnet", default=None, help="subnet id for mapping-slot proof")
    gen.add_argument("--slot-index", type=int, default=0)
    gen.add_argument("--event-sig", default=None, help='e.g. "NewTopDownMessage(bytes32,uint256)"')
    gen.add_argument("--topic1", default=None)
    gen.add_argument("--no-actor-filter", action="store_true")
    _add_backend_flag(gen)
    gen.add_argument(
        "--receipts-api",
        action="store_true",
        help="enumerate pass-1 receipts via Filecoin.ChainGetParentReceipts "
        "(the reference's pathway) instead of walking the receipts AMT; "
        "needed for nodes that serve receipts only through the JSON API",
    )
    gen.add_argument("-o", "--output", default=None)
    gen.add_argument("--metrics", action="store_true")
    add_failover_flags(gen)
    add_trace_export_flags(gen)
    gen.set_defaults(fn=_cmd_generate)

    ver = sub.add_parser("verify", help="verify a saved bundle offline")
    ver.add_argument("bundle")
    ver.add_argument("--f3-cert", default=None, help="F3 finality certificate JSON")
    ver.add_argument("--event-sig", default=None)
    ver.add_argument("--topic1", default=None)
    ver.add_argument("--check-cids", action="store_true", help="recompute every witness CID")
    _add_backend_flag(ver)
    ver.set_defaults(fn=_cmd_verify)

    rng = sub.add_parser(
        "range", help="event (+ storage) proofs over an epoch range (chunked, resumable)"
    )
    rng.add_argument("--endpoint", required=True)
    rng.add_argument("--token", default=None)
    rng.add_argument("--timeout", type=float, default=250.0)
    rng.add_argument("--from-height", type=int, required=True)
    rng.add_argument("--to-height", type=int, required=True)
    rng.add_argument("--contract", default=None)
    rng.add_argument("--event-sig", required=True)
    rng.add_argument("--topic1", required=True)
    rng.add_argument(
        "--storage-slot",
        action="append",
        default=None,
        metavar="KEY",
        help="also prove this mapping key's slot (of --contract) at every "
        "pair; repeatable — both proof kinds share the bundle witness",
    )
    rng.add_argument("--slot-index", type=int, default=0)
    rng.add_argument(
        "--scan-workers", type=int, default=8,
        help="thread-pool width for the Python scan over the RPC store "
        "with --pipeline-depth 0 (overlapping block fetches hides network "
        "latency)",
    )
    rng.add_argument("--chunk-size", type=int, default=64)
    rng.add_argument(
        "--threads", type=int, default=None,
        help="ONE thread budget for the whole range engine: partitioned "
        "over scan/record/verify stage workers and the native scanner's "
        "per-call fan-out so the process never oversubscribes "
        "(flag > IPC_THREADS env > --scan-threads > IPC_SCAN_THREADS > "
        "CPU affinity)",
    )
    rng.add_argument(
        "--scan-threads", type=int, default=None,
        help="legacy: pin the scan+match stage worker count (also sets "
        "the whole budget when --threads/IPC_THREADS are absent)",
    )
    rng.add_argument(
        "--pipeline-depth", type=int, default=2,
        help="chunks buffered between pipeline stages (bounded queues); "
        "0 disables the stage-overlapped engine",
    )
    add_store_flags(rng)
    add_fetch_plane_flags(rng)
    rng.add_argument("--checkpoint-dir", default=None)
    rng.add_argument(
        "--job-dir", default=None, metavar="DIR",
        help="write-ahead journal for crash-safe resume: every completed "
        "chunk is fsync'd to DIR/journal.bin; re-running with the same "
        "flags skips committed chunks (SIGKILL-safe — torn tail records "
        "are discarded)",
    )
    rng.add_argument(
        "--resume", action="store_true",
        help="require an existing job manifest in --job-dir (fail instead "
        "of silently starting a fresh job)",
    )
    _add_backend_flag(rng)
    rng.add_argument(
        "--mesh-devices", type=int, default=None, metavar="N",
        help="shard the event-match batches across a mesh of N devices: "
        "the first N cards (0 = all) with --backend gpu, N virtual CPU "
        "devices with --backend cpu. Results are bit-identical to the "
        "single-device path",
    )
    rng.add_argument("-o", "--output", default=None)
    rng.add_argument("--metrics", action="store_true")
    rng.add_argument(
        "--profile",
        default=None,
        metavar="DIR",
        help="trace generation with torch.profiler into DIR/trace.json "
        "(Chrome trace format; open at ui.perfetto.dev)",
    )
    add_failover_flags(rng)
    add_trace_export_flags(rng)
    rng.set_defaults(fn=_cmd_range)

    bf = sub.add_parser(
        "backfill",
        help="prove deep history as a durable batch job: windowed, "
        "journal-resumable, streamed chunk by chunk",
    )
    bf.add_argument("--endpoint", default=None)
    bf.add_argument("--token", default=None)
    bf.add_argument("--timeout", type=float, default=250.0)
    add_failover_flags(bf)
    bf.add_argument("--from-height", type=int, default=None)
    bf.add_argument("--to-height", type=int, default=None)
    bf.add_argument("--contract", default=None)
    bf.add_argument("--event-sig", default=None)
    bf.add_argument("--topic1", default=None)
    bf.add_argument(
        "--demo-world", type=int, default=0, metavar="N_PAIRS",
        help="hermetic synthetic range world with N tipset pairs instead "
        "of a live endpoint (the batch analogue of `serve --demo-world`)",
    )
    bf.add_argument(
        "--demo-receipts", type=int, default=16, metavar="N",
        help="receipts per pair in the --demo-world (default 16)",
    )
    bf.add_argument(
        "--demo-match-rate", type=float, default=0.01,
        help="fraction of demo-world events matching the spec (default 0.01)",
    )
    bf.add_argument(
        "--pair-start", type=int, default=0, metavar="I",
        help="first pair-table index to prove (default 0)",
    )
    bf.add_argument(
        "--pair-end", type=int, default=None, metavar="J",
        help="one past the last pair-table index (default: whole table)",
    )
    bf.add_argument(
        "--window-size", type=int, default=8, metavar="N",
        help="epochs per schedulable window — the journal's commit and "
        "the stream's chunk granularity (default 8)",
    )
    bf.add_argument(
        "--work-ahead", type=int, default=2, metavar="N",
        help="future windows whose tipset headers prime the fetch "
        "plane's speculative lanes when a window starts (default 2)",
    )
    bf.add_argument(
        "--window-parallelism", type=int, default=1, metavar="N",
        help="windows proving concurrently (default 1 — the whole job "
        "occupies a single lane)",
    )
    bf.add_argument(
        "--jobs-dir", default=None, metavar="DIR",
        help="durable job root: each job journals committed windows "
        "under DIR/<job-id>/ (IPJ1, fsync'd). Re-running the identical "
        "command resumes from the journal — a SIGKILL loses at most the "
        "in-flight windows. Without it the job is not resumable",
    )
    bf.add_argument(
        "--chunk-size", type=int, default=None, metavar="N",
        help="chunk size within one window's driver run (default: the "
        "whole window as one chunk)",
    )
    _add_backend_flag(bf)
    bf.add_argument(
        "--mesh-devices", type=int, default=None, metavar="N",
        help="shard each window's event masks across a mesh of N devices: "
        "the first N cards (0 = all) with --backend gpu, N virtual CPU "
        "devices with --backend cpu. Results are bit-identical to the "
        "single-device path",
    )
    add_store_flags(bf)
    add_fetch_plane_flags(bf)
    bf.add_argument("-o", "--output", default=None)
    bf.add_argument("--metrics", action="store_true")
    add_trace_export_flags(bf)
    bf.set_defaults(fn=_cmd_backfill)

    vec = sub.add_parser(
        "vectors", help="capture live-chain byte-compat vectors to a fixtures JSON"
    )
    vec.add_argument("--endpoint", required=True)
    vec.add_argument("--token", default=None)
    vec.add_argument("--timeout", type=float, default=250.0)
    vec.add_argument("--height", type=int, required=True)
    vec.add_argument("-o", "--output", default=None)
    vec.set_defaults(fn=_cmd_vectors)

    cert = sub.add_parser(
        "cert",
        help="inspect/validate F3 finality certificates (Forest JSON or "
        "go-f3 certexchange CBOR; chain continuity, delta replay, table "
        "commitments, optional BLS verification)",
    )
    cert.add_argument("certificates", nargs="+", help="certificate files (JSON or CBOR)")
    cert.add_argument(
        "--power-table",
        default=None,
        help="initial power table JSON [{ParticipantID, Power, SigningKey, Pop?}, …] "
        "for the first certificate's instance (enables delta replay + commitments)",
    )
    cert.add_argument(
        "--verify-signatures",
        action="store_true",
        help="verify each certificate's aggregate BLS signature and >2/3 quorum "
        "(requires --power-table)",
    )
    cert.add_argument(
        "--network",
        default=None,
        help='gpbft network name in the signing payload (default "filecoin")',
    )
    cert.add_argument(
        "--emit-cbor",
        default=None,
        metavar="PATH",
        help="re-encode the (single) certificate in go-f3 certexchange CBOR",
    )
    cert.set_defaults(fn=_cmd_cert)

    demo = sub.add_parser("demo", help="hermetic end-to-end demo on a synthetic chain")
    _add_backend_flag(demo)
    demo.set_defaults(fn=_cmd_demo)

    srv = sub.add_parser(
        "serve",
        help="long-running proof service: micro-batched verify/generate "
        "over JSON-HTTP with backpressure, deadlines, and /metrics",
    )
    srv.add_argument("--host", default="127.0.0.1")
    srv.add_argument("--port", type=int, default=8411)
    srv.add_argument(
        "--port-file", default=None, metavar="PATH",
        help="write the bound port to PATH once listening (atomic rename) — "
        "how a parent that spawned this daemon on --port 0 learns where it "
        "landed",
    )
    srv.add_argument(
        "--demo-world", type=int, default=0, metavar="N_PAIRS",
        help="serve a hermetic synthetic range world with N tipset pairs "
        "(enables /v1/generate with zero egress)",
    )
    srv.add_argument(
        "--demo-receipts", type=int, default=16, metavar="N",
        help="receipts per pair in the --demo-world (default 16)",
    )
    srv.add_argument(
        "--demo-match-rate", type=float, default=0.01,
        help="fraction of demo-world events matching the spec (default 0.01)",
    )
    srv.add_argument("--endpoint", default=None, help="Lotus JSON-RPC endpoint URL")
    srv.add_argument("--token", default=None)
    srv.add_argument("--timeout", type=float, default=250.0)
    add_failover_flags(srv)
    srv.add_argument("--from-height", type=int, default=None)
    srv.add_argument("--to-height", type=int, default=None)
    srv.add_argument("--event-sig", default=None)
    srv.add_argument("--topic1", default=None)
    srv.add_argument("--f3-cert", default=None, help="F3 finality certificate JSON")
    srv.add_argument("--check-cids", action="store_true")
    srv.add_argument(
        "--max-batch", type=int, default=32,
        help="flush a micro-batch at this many requests",
    )
    srv.add_argument(
        "--max-wait-ms", type=float, default=4.0,
        help="…or when the oldest queued request has waited this long",
    )
    srv.add_argument(
        "--queue-capacity", type=int, default=256,
        help="bounded admission queue; beyond this requests get 503 + Retry-After",
    )
    srv.add_argument("--workers", type=int, default=2, help="batch-execution threads")
    srv.add_argument(
        "--cache-max-bytes", type=int, default=256 * 1024 * 1024,
        help="shared block-cache budget (LRU-evicting)",
    )
    srv.add_argument(
        "--cache-ttl-s", type=float, default=None,
        help="optional TTL on cached blocks",
    )
    srv.add_argument(
        "--threads", type=int, default=None,
        help="ONE thread budget for multi-pair generate batches "
        "(stage-overlapped range engine): partitioned over "
        "scan/record/verify workers + native scan fan-out "
        "(flag > IPC_THREADS > --scan-threads > IPC_SCAN_THREADS > "
        "CPU affinity)",
    )
    srv.add_argument(
        "--scan-threads", type=int, default=None,
        help="legacy: pin the scan+match stage worker count for "
        "multi-pair generate batches",
    )
    srv.add_argument(
        "--pipeline-depth", type=int, default=2,
        help="chunks buffered between range-pipeline stages",
    )
    add_store_flags(srv)
    add_fetch_plane_flags(srv)
    add_witness_flags(srv)
    add_registry_flags(srv)
    add_subs_flags(srv)
    add_slo_flags(srv)
    _add_backend_flag(srv)
    srv.add_argument(
        "--mesh-devices", type=int, default=None, metavar="N",
        help="shard the generate batches' event masks across a mesh of N "
        "devices: the first N cards (0 = all) with --backend gpu, N "
        "virtual CPU devices with --backend cpu. Results are "
        "bit-identical to the single-device path",
    )
    srv.add_argument(
        "--store-owner", default=None, metavar="TOKEN",
        help="join a SHARED --store-dir under this owner token (cluster "
        "shards): this process appends only to its own seg-TOKEN.* "
        "segments, reads everyone's, and eviction coordinates through a "
        "directory flock. Omit for an exclusive single-writer store",
    )
    srv.add_argument(
        "--follow", action="store_true",
        help="chain-follow prefetch: a daemon thread tails finalized "
        "tipsets (ChainHead minus a finality lag) and pre-warms the "
        "tiered store with headers, receipts-AMT and state-HAMT spine "
        "blocks — requests about recent tipsets then complete with zero "
        "upstream block fetches (requires --endpoint; best with "
        "--store-dir)",
    )
    srv.add_argument(
        "--follow-poll-s", type=float, default=15.0,
        help="chain-follower poll interval in seconds (default 15)",
    )
    srv.add_argument(
        "--backfill-jobs-dir", default=None, metavar="DIR",
        help="mount /v1/backfill: durable deep-history batch jobs, "
        "journaled under DIR (IPJ1, one subdirectory per deterministic "
        "job id — SIGKILL-resumable, identical re-submits dedup). "
        "Windows execute on the generate micro-batcher's LOW-priority "
        "lane, so a saturating backfill never starves interactive "
        "/v1/verify or /v1/generate; chunks stream incrementally via the "
        "long-poll cursor protocol (GET /v1/backfill/<id>/chunks"
        "?cursor=N). Needs a generate-capable service (--demo-world or "
        "--endpoint)",
    )
    srv.add_argument(
        "--backfill-window-size", type=int, default=8, metavar="N",
        help="epochs (tipset pairs) per backfill window — the journal "
        "commit and streaming granularity (default 8)",
    )
    srv.add_argument(
        "--queue-dir", default=None, metavar="DIR",
        help="durable admission queue: requests are journaled (fsync) to "
        "DIR/queue.bin before execution, idempotency_key dedupes client "
        "retries, and admitted-but-unfinished requests re-execute on "
        "restart (/healthz reports resumed_jobs / journal_bytes)",
    )
    srv.add_argument(
        "--results-cache-bytes", type=int, default=64 * 1024 * 1024,
        help="byte cap on the in-memory completed-request result cache "
        "(with --queue-dir): colder results spill to their journal frame "
        "and are re-read (CRC-verified) on an idempotent retry "
        "(default 64 MiB)",
    )
    srv.add_argument(
        "--slow-ms", type=float, default=1000.0,
        help="log a WARNING with the request's full span tree when a "
        "request takes longer than this end-to-end (default 1000)",
    )
    add_trace_export_flags(srv)
    add_tenant_admission_flags(srv)
    srv.set_defaults(fn=_cmd_serve)

    clu = sub.add_parser(
        "cluster",
        help="sharded serve plane: N serve shard processes behind a "
        "consistent-hash scatter-gather router (single-daemon wire "
        "protocol at the front door)",
    )
    clu.add_argument("--host", default="127.0.0.1")
    clu.add_argument("--port", type=int, default=8410)
    clu.add_argument(
        "--port-file", default=None, metavar="PATH",
        help="write the router's bound port to PATH once listening",
    )
    clu.add_argument(
        "--shards", type=int, default=4, metavar="N",
        help="serve shard processes to spawn (default 4)",
    )
    clu.add_argument(
        "--steal-threshold", type=int, default=4, metavar="D",
        help="steal a request from its affine shard when that shard's "
        "EFFECTIVE load (in-flight depth + latency penalty) exceeds the "
        "least-loaded shard's by D (affinity is a cache hint, never a "
        "correctness constraint; default 4)",
    )
    clu.add_argument(
        "--steal-latency-unit-s", type=float, default=0.25, metavar="S",
        help="latency-penalty unit for placement: a shard's observed "
        "dispatch EWMA counts as ewma/S phantom queue slots, so slow "
        "(cross-host) members lose steals they'd win on raw queue depth "
        "(default 0.25)",
    )
    clu.add_argument(
        "--shard-url", action="append", default=None, metavar="URL",
        help="admit an ALREADY-RUNNING serve daemon on another host as a "
        "cluster member (repeatable). The member must serve the same "
        "--demo-world pair table; it is health-probed before admission "
        "and failed over like a spawned shard if it stops answering",
    )
    clu.add_argument(
        "--replication-factor", type=int, default=1, metavar="R",
        help="replicate each shard's hot segment files onto the next R-1 "
        "distinct ring successors (R=1 disables). Arms peer-first "
        "read-repair of corrupt frames and re-replication after a host "
        "death. Shards need --store-dir to hold replicas (default 1)",
    )
    clu.add_argument(
        "--cut-through", default="on", choices=["on", "off"],
        help="relay shard stream chunks through the router as they "
        "arrive on streamed range responses, instead of buffering each "
        "shard's JSON sub-response (default on)",
    )
    clu.add_argument(
        "--demo-world", type=int, default=0, metavar="N_PAIRS",
        help="hermetic synthetic range world served by every shard "
        "(deterministic build → identical pair table in each; required)",
    )
    clu.add_argument(
        "--demo-receipts", type=int, default=16, metavar="N",
        help="receipts per pair in the demo world (default 16)",
    )
    clu.add_argument(
        "--demo-match-rate", type=float, default=0.01,
        help="fraction of demo-world events matching the spec (default 0.01)",
    )
    clu.add_argument("--event-sig", default=None)
    clu.add_argument("--topic1", default=None)
    add_store_flags(clu)
    add_subs_flags(clu)
    add_witness_flags(clu)
    add_registry_flags(clu)
    _add_backend_flag(clu)
    clu.add_argument(
        "--queue-dir", default=None, metavar="DIR",
        help="durable admission root: each shard journals under DIR/s<k> "
        "(crash recovery + idempotency dedup per shard — what makes the "
        "router's at-least-once failover retries safe)",
    )
    add_trace_export_flags(clu)
    add_slo_flags(clu)
    add_tenant_admission_flags(clu)
    clu.add_argument(
        "--scrape-interval-s", type=float, default=5.0,
        help="fleet federation: router background-scrape interval for "
        "each shard's /metrics.json + /healthz (default 5)",
    )
    clu.add_argument(
        "--scrape-timeout-s", type=float, default=2.0,
        help="per-shard scrape timeout; a slow or dead shard drops out "
        "of the fleet view for that round instead of stalling it "
        "(default 2)",
    )
    clu.set_defaults(fn=_cmd_cluster)

    args = parser.parse_args(argv)
    if getattr(args, "event_sig", None) and not getattr(args, "topic1", None):
        parser.error("--event-sig requires --topic1")
    with _traced(args):
        return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
