"""Stage timers, counters, gauges and latency histograms.

The counterpart of ``ipc_proofs_tpu.utils.metrics``: the same ``stage()`` /
``count()`` / ``set_gauge()`` / ``observe()`` calls and names
(``range_scan``, ``range_match``, ``range_record``, ``range_merge``,
``range_verify``; the ``rpc.*``, ``pool.*``, ``fetch.*``, ``storex.*``,
``follow.*``, ``trace.*`` and ``verify.*`` names, each one the reference
declares in its vocabularies, as ``tests/test_torch_rpc.py`` checks), so a
caller reads both packages alike and `obs.prom.render_prometheus` renders
the same text for both. Times are host wall-clock seconds.

Each stage keeps its busy seconds (``total_s``: the sum over every entry,
so 8 workers × 1 s is 8 s) and its wall seconds (``wall_s``: the union of
its entry intervals, ~1 s for the same 8 overlapping workers). A union wall
runs across all stages, and ``overlap_efficiency`` is busy over that union
wall: 1.0 for serial code, towards N for N stages that overlap. Every
outermost stage entry is also a trace span (`obs.trace.span`), parented by
the context ambient on the calling thread; a span times host work only and
never synchronises the card.

Histograms are bounded rings (the latest ``maxlen`` observations), so a
long-lived process snapshots in O(maxlen).
"""

from __future__ import annotations

import json
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass

from ipc_proofs_tpu_torch.utils.lockdep import named_lock

__all__ = [
    "ADMIT_COUNTERS",
    "ADMIT_GAUGES",
    "ASYNCFETCH_COUNTERS",
    "BACKFILL_COUNTERS",
    "BACKFILL_GAUGES",
    "CLUSTER_COUNTERS",
    "CLUSTER_GAUGES",
    "DEADLINE_COUNTERS",
    "DEGRADED_COUNTERS",
    "DURABILITY_COUNTERS",
    "DURABILITY_GAUGES",
    "FLEET_COUNTERS",
    "FOLLOW_COUNTERS",
    "FOLLOW_GAUGES",
    "Histogram",
    "Metrics",
    "OBSERVABILITY_COUNTERS",
    "PIPELINE_STAGES",
    "RANGE_COUNTERS",
    "REGISTRY_COUNTERS",
    "RESILIENCE_COUNTERS",
    "SERVE_COUNTERS",
    "SERVE_GAUGES",
    "SERVE_HISTOGRAMS",
    "SLO_COUNTERS",
    "STOREX_COUNTERS",
    "STOREX_GAUGES",
    "SUBS_COUNTERS",
    "SUBS_GAUGES",
    "SUBS_HISTOGRAMS",
    "StageTimer",
    "TENANT_COUNTERS",
    "VERIFY_COUNTERS",
    "WITNESS_COUNTERS",
    "get_metrics",
]

# Counter vocabulary of the fault-tolerance layer (store/failover.py,
# store/rpc.py, proofs/range.py), the reference's names:
#   rpc.calls               — JSON-RPC requests issued (all methods, before
#                             retries); a disk-warm request shows a delta of 0
#   rpc.retries             — transport/rate-limit retries inside LotusClient
#   rpc.failures            — requests that exhausted their retry budget
#   rpc.integrity_failures  — fetched block bytes failed CID verification
#   rpc.prefetch_failures   — per-CID failures absorbed by fail-soft prefetch
#   rpc.hedges              — hedged secondary fetches fired
#   rpc.hedge_wins          — races the hedge answered first
#   rpc.probe_suppressed    — half-open probes deferred while every breaker
#                             is open and another endpoint holds the
#                             pool-wide probe slot
#   rpc.retry_budget_exhausted — retries skipped because the pool-wide
#                             retry budget was dry
#   failover.breaker_open   — circuit-breaker open transitions
#   range_scan_retries      — chunk re-scans after transient store errors
#   range_pipeline_serial_fallback — pipelined driver ran inline
RESILIENCE_COUNTERS = (
    "rpc.calls",
    "rpc.retries",
    "rpc.failures",
    "rpc.integrity_failures",
    "rpc.prefetch_failures",
    "rpc.hedges",
    "rpc.hedge_wins",
    "rpc.probe_suppressed",
    "rpc.retry_budget_exhausted",
    "failover.breaker_open",
    "range_scan_retries",
    "range_pipeline_serial_fallback",
)

# Counter vocabulary of the trace spine and its exporters (obs/):
#   trace.spans_recorded    — spans kept by the opt-in collector
#   trace.spans_dropped     — spans dropped at the collector's capacity
#   trace.spans_sampled_out — spans of traces that lost the head-sampling draw
#   serve.slow_requests     — requests over the service's slow-request
#                             threshold, logged with their span tree
#   trace.otlp_posts        — OTLP/JSON batches POSTed to a collector
#   trace.otlp_post_failures — collector POSTs that exhausted their retries
OBSERVABILITY_COUNTERS = (
    "trace.spans_recorded",
    "trace.spans_dropped",
    "trace.spans_sampled_out",
    "serve.slow_requests",
    "trace.otlp_posts",
    "trace.otlp_post_failures",
)

# The chain follower's part of the reference's STOREX_COUNTERS
# (storex/follower.py):
#   follow.tipsets           — heights whose spine was warmed
#   follow.blocks_prefetched — blocks verified and put into the local tiers
#   follow.errors            — store errors, rejected blocks and raising
#                              hooks, each absorbed and retried next poll
#   follow.leader_elections  — leader-lock elections won
#   follow.polls             — head polls
FOLLOW_COUNTERS = (
    "follow.tipsets",
    "follow.blocks_prefetched",
    "follow.errors",
    "follow.leader_elections",
    "follow.polls",
)
FOLLOW_GAUGES = ("follow.last_finalized_epoch",)  # the last height warmed

# The endpoint pool's all-breakers-open posture (store/failover.py):
#   degraded.entered / degraded.exited — transitions into and out of it
#   degraded.warm_served    — requests the service answered from the warm
#                             tiers alone while degraded
#   degraded.fail_fast      — cold reads refused typed instead of retried
DEGRADED_COUNTERS = (
    "degraded.entered",
    "degraded.exited",
    "degraded.warm_served",
    "degraded.fail_fast",
)

# Counter vocabulary of the standing-query subsystem (subs/):
#   subs.registered        — subscriptions accepted into the registry
#   subs.unsubscribed      — subscriptions removed
#   subs.replays_absorbed  — duplicate subscribe(sub_id) calls absorbed
#                            idempotently (journal replays, cluster
#                            failover re-registration)
#   subs.tipsets_matched   — finalized tipset pairs the matcher compiled
#                            the active filter set against
#   subs.generations       — proof generations run, one per distinct
#                            (pair, filter) — the fan-out amortization
#                            counter (≤ distinct filters per tipset,
#                            NEVER per subscriber)
#   subs.notifications     — deliveries fanned out to subscribers
#   subs.empty_matches     — (pair, filter) generations with zero proofs
#                            (nothing to deliver — not an error)
#   subs.errors            — per-filter generation failures absorbed
#                            fail-soft (other filters still deliver)
#   subs.deliveries        — delivery-log appends (monotonic cursors)
#   subs.delivery_dedup    — appends absorbed by an already-seen
#                            idempotency key (matcher replays)
#   subs.acks              — deliveries acked (push 2xx or long-poll
#                            cursor advance)
#   subs.duplicate_acks    — ack attempts for unknown/already-acked
#                            cursors, refused (the no-duplicate-ack guard)
#   subs.pushes            — webhook pushes that landed (2xx)
#   subs.push_retries      — webhook attempts after the first (full-jitter
#                            backoff)
#   subs.push_failures     — pushes that exhausted retries (delivery stays
#                            unacked for long-poll / next-cycle re-push)
#   subs.log_failures      — registry/delivery journal writes or
#                            compactions that failed (ENOSPC/EROFS
#                            fail-soft: the run completes in-memory)
#   subs.log_compactions   — delivery-journal rewrites under the byte cap
#                            (drops only acked history)
SUBS_COUNTERS = (
    "subs.registered",
    "subs.unsubscribed",
    "subs.replays_absorbed",
    "subs.tipsets_matched",
    "subs.generations",
    "subs.notifications",
    "subs.empty_matches",
    "subs.errors",
    "subs.deliveries",
    "subs.delivery_dedup",
    "subs.acks",
    "subs.duplicate_acks",
    "subs.pushes",
    "subs.push_retries",
    "subs.push_failures",
    "subs.log_failures",
    "subs.log_compactions",
)

SUBS_GAUGES = (
    "subs.active",  # registered subscriptions
    "subs.pending_deliveries",  # unacked deliveries across all subscriptions
    "subs.push_inflight",  # webhook pushes currently in flight
    "subs.log_bytes",  # bytes in the delivery journal (cap trigger)
)

SUBS_HISTOGRAMS = (
    "subs.delivery_lag_ms",  # append→ack latency of webhook/long-poll acks
)

# Counter vocabulary of the bulk backfill engine (backfill/):
#   backfill.jobs            — jobs submitted (fresh threads launched; an
#                              idempotent resubmit of a RUNNING job does
#                              not count)
#   backfill.jobs_resumed    — submits that replayed ≥1 committed window
#                              from the job's IPJ1 journal
#   backfill.windows         — windows proved fresh and committed
#   backfill.windows_replayed— windows satisfied from the journal on resume
#   backfill.epochs          — epochs covered by emitted windows (fresh +
#                              replayed; the epochs/s numerator)
#   backfill.chunks_streamed — chunks entered into jobs' cursor logs
#   backfill.catchup_deliveries — windows landed on a standing-query
#                              delivery log (sub_id catch-up; dedup
#                              absorbs resume replays without a count)
#   backfill.window_failures — jobs failed by a window-runner error or
#                              engine shutdown (journal keeps committed
#                              windows for resume)
#   backfill.device_faults   — jobs stopped by a fault of the card (state
#                              "faulted", never counted as a failure;
#                              the port's own, the reference has none)
BACKFILL_COUNTERS = (
    "backfill.jobs",
    "backfill.jobs_resumed",
    "backfill.windows",
    "backfill.windows_replayed",
    "backfill.epochs",
    "backfill.chunks_streamed",
    "backfill.catchup_deliveries",
    "backfill.window_failures",
    "backfill.device_faults",
)

BACKFILL_GAUGES = (
    "backfill.active_jobs",  # jobs currently in the running state
)

# SLO burn-rate watchdog (obs/slo.py): multi-window availability/latency/
# integrity targets evaluated from periodic metric snapshots.
#   slo.evaluations      — watchdog sample passes (manual or timed)
#   slo.warn_transitions — target entered `warn` (fast or slow window hot)
#   slo.burn_transitions — target entered `burning` (both windows over page
#                          rate, or an integrity zero-tolerance tick)
#   slo.recoveries       — target stepped back to `ok` after the hysteresis
#                          window of consecutive clean evaluations
#   slo.anomalies        — anomaly signatures observed (breaker flap storm,
#                          eviction storm, speculation-waste spike)
SLO_COUNTERS = (
    "slo.evaluations",
    "slo.warn_transitions",
    "slo.burn_transitions",
    "slo.recoveries",
    "slo.anomalies",
)

# The reference's remaining vocabularies, name for name (the port's
# code counts each name where the reference does; tests/test_torch_port.py
# holds every tuple to the reference's).

# Counter vocabulary of the async fetch plane (store/fetchplane.py and the
# batch framing in store/rpc.py / store/failover.py):
#   rpc.batch_calls         — JSON-RPC batch-array round-trips issued (each
#                             also ticks rpc.calls once: a batch IS one
#                             round-trip, which is the whole point)
#   rpc.batched_reads       — individual ChainReadObj reads shipped inside
#                             batch calls (batched_reads / batch_calls =
#                             achieved batching factor)
#   rpc.batch_unsupported   — endpoints that rejected batch framing at the
#                             capability probe (client fell back to
#                             sequential calls, once, permanently)
#   rpc.batch_item_retries  — per-id errors demuxed out of a batch response
#                             and refetched through the sequential path
#   fetch.wants             — block wants enqueued on the plane (all
#                             priorities)
#   fetch.coalesced         — wants that attached to an already-in-flight
#                             or already-landed fetch instead of enqueueing
#   fetch.tier_hits         — wants short-circuited by the local tiers
#                             (RAM/disk) without touching the want-queue
#   fetch.batches           — dispatcher round-trips (batch or sequential
#                             fallback waves)
#   fetch.batched_blocks    — blocks fetched across those round-trips
#   fetch.speculative_wants — low-priority wants entered by HAMT/AMT
#                             interior-node speculation
#   fetch.speculative_used  — speculative blocks a demand get later consumed
#   fetch.speculative_wasted— speculative blocks fetched but never demanded
#                             (counted when the plane closes; mis-speculation
#                             is a cost, never an error)
#   fetch.speculative_dropped — speculative wants dropped at queue capacity
#   fetch.speculative_integrity_drops — speculative blocks that failed
#                             multihash verification and were discarded
#                             before use (demand path refetches + raises)
#   fetch.speculate_depth_downshifts — adaptive-depth backoffs: windows
#                             whose counted waste ratio crossed the
#                             threshold and lowered speculate_depth by one
#                             (--speculate-depth auto)
#   fetch.schedule_primed   — CIDs entered through `FetchPlane.prime`:
#                             schedule-driven speculation from the backfill
#                             work-ahead feeder, exempt from the adaptive
#                             depth gate (the scheduler KNOWS these blocks
#                             will be demanded)
ASYNCFETCH_COUNTERS = (
    "rpc.batch_calls",
    "rpc.batched_reads",
    "rpc.batch_unsupported",
    "rpc.batch_item_retries",
    "fetch.wants",
    "fetch.coalesced",
    "fetch.tier_hits",
    "fetch.batches",
    "fetch.batched_blocks",
    "fetch.speculative_wants",
    "fetch.speculative_used",
    "fetch.speculative_wasted",
    "fetch.speculative_dropped",
    "fetch.speculative_integrity_drops",
    "fetch.speculate_depth_downshifts",
    "fetch.schedule_primed",
)

# Counter vocabulary of the durability layer (jobs/journal.py, jobs/job.py,
# proofs/range.py job wiring, serve/durable.py):
#   jobs.chunks_replayed    — journal records re-admitted on job resume
#   jobs.resume_ms          — milliseconds spent replaying the journal
#   jobs.commit_us          — thread-CPU microseconds spent inside commit
#                             records (serialize + checksum + write +
#                             fsync): the journal's attributable cost,
#                             measured where it happens. CPU time, not
#                             wall: in the pipelined record stage, wall
#                             time would also count GIL/IO waits that
#                             overlap the next chunk's scan
#   jobs.chunk_journal_us   — wall-clock microseconds spent journalling
#                             per chunk/verdict commit (serialize +
#                             write + fsync). Unlike jobs.commit_us this
#                             is wall time: it is what a waiting request
#                             actually experiences, so it is the number
#                             surfaced as `journal_ms` in Server-Timing
#   jobs.journal_failures   — records lost to fail-soft journal I/O degrade
#   jobs.compactions        — journal committed-prefix snapshots swapped in
#                             (each one re-bounds replay time)
#   serve.requests_replayed — admitted-but-unfinished serve requests
#                             re-executed on daemon restart
DURABILITY_COUNTERS = (
    "jobs.chunks_replayed",
    "jobs.resume_ms",
    "jobs.commit_us",
    "jobs.chunk_journal_us",
    "jobs.journal_failures",
    "jobs.compactions",
    "serve.requests_replayed",
)

# Counter vocabulary of the proof engines (proofs/range.py,
# proofs/storage_batch.py): work-item counts the bench legs and the
# `--metrics` CLI flag report.
#   range_events            — event claims matched across the range
#   range_chunks_generated  — chunks proven fresh this run
#   range_chunks_resumed    — chunks satisfied from the journal on resume
#   range_proofs            — event-claim proofs emitted
#   range_storage_proofs    — storage-slot proofs emitted
#   range_match_coalesced   — device match calls saved by the coalescer
#                             (requests folded into another chunk's batch)
#   range_match_retraces    — first-seen coalesced dispatch shapes: each
#                             tick is a (bucketed) batch shape the match
#                             kernel had not compiled before, so the
#                             counter growing like O(log n) — not one per
#                             batch — is the no-unbounded-retracing pin
#                             (the port's coalescer never pads, so it
#                             never counts this one; kept for the names)
#   batch_contracts         — distinct contracts in a storage batch
#   batch_slots             — storage slots read in a storage batch
RANGE_COUNTERS = (
    "range_events",
    "range_chunks_generated",
    "range_chunks_resumed",
    "range_proofs",
    "range_storage_proofs",
    "range_match_coalesced",
    "range_match_retraces",  # ipclint: disable=vocab-dead (the port's coalescer never pads, so no dispatch shape is re-traced; kept for the reference's names)
    "batch_contracts",
    "batch_slots",
)

# Counter vocabulary of the batched integrity plane
# (ops/verify.py::verify_blocks_batch — wired into the fetch plane's
# landed waves, the follower's prefetch batches, and SegmentStore.get_many):
#   verify.batch_calls    — verify_blocks_batch invocations (≤ 1 per
#                           read-path chunk by construction)
#   verify.batch_blocks   — blocks those calls verified (all lanes)
#   verify.device_calls   — fused kernel dispatches (one per size-class
#                           chunk; the bench's ≤-1-device-call-per-chunk
#                           assertion reads this)
#   verify.device_blocks  — blocks hashed on the device lane
#   verify.scalar_blocks  — blocks verified on the scalar lane (odd codes,
#                           sub-crossover batches, device fail-soft)
VERIFY_COUNTERS = (
    "verify.batch_calls",
    "verify.batch_blocks",
    "verify.device_calls",
    "verify.device_blocks",
    "verify.scalar_blocks",
)

# Counter vocabulary of the serve plane (serve/batcher.py,
# serve/service.py, serve/durable.py). `<family>.*` entries are
# per-batcher families — the batcher interpolates its queue name
# (`generate`/`verify`) into the counter, e.g. `serve.accepted.generate`.
SERVE_COUNTERS = (
    "serve.accepted.*",
    "serve.accepted_low.*",  # low-priority lane admissions (backfill windows)
    "serve.accepted_push.*",  # push-lane admissions (standing-query windows)
    "serve.rejected_closed.*",
    "serve.rejected_full.*",
    "serve.deadline_exceeded.*",
    "serve.batches.generate",
    "serve.batches.verify",
    "serve.idempotent_hits",
    "serve.result_cache_evictions",
    # Streaming wire (witness/stream.py + the serve/router front ends):
    #   responses       — streamed responses completed (terminator sent)
    #   zero_copy_bytes — block payload bytes sent as memoryview slices of
    #                     disk-tier segment frames (never copied through
    #                     Python) — the tentpole meter
    #   copied_bytes    — block payload bytes that DID copy (cache-warm
    #                     blocks, eviction fallback, compressed frames)
    #   aborts          — streams ended by an in-band typed error chunk
    "serve.stream.responses",
    "serve.stream.zero_copy_bytes",
    "serve.stream.copied_bytes",
    "serve.stream.aborts",
)

# Counter vocabulary of the tiered block store + chain follower
# (storex/segments.py, storex/tiered.py, storex/follower.py):
#   storex.disk_hits           — verified reads served from the disk tier
#   storex.disk_misses         — disk-tier lookups that fell through to the
#                                inner store (includes integrity evictions)
#   storex.evictions           — whole segments LRU-evicted over the byte cap
#   storex.integrity_evictions — disk frames that failed CRC or multihash
#                                re-verification: evicted + refetched, the
#                                corruption-is-an-availability-event counter
#   storex.write_failures      — blocks the disk tier could not spill
#                                (ENOSPC/EROFS fail-soft read-only degrade)
#   storex.shared_evictions    — segments removed under the cross-process
#                                eviction lock of a SHARED store dir (one
#                                --store-dir serving N shard daemons); a
#                                subset of storex.evictions, counted by
#                                the shard that ran the eviction pass
#   follow.tipsets             — finalized tipsets the chain follower warmed
#   follow.blocks_prefetched   — spine blocks the follower stored locally
#   follow.errors              — follower errors absorbed fail-soft (head
#                                polls, fetches, verification skips,
#                                raising finalized hooks)
#   follow.leader_elections    — times a daemon won the follow-leader lock
#                                (cluster mode runs ONE ChainFollower per
#                                shared --store-dir, not one per shard)
#   follow.polls               — head polls attempted (jittered cadence;
#                                polls × poll_s sanity-checks herd spread)
#   storex.replica_repairs     — corrupt local frames whose bytes were
#                                refetched + re-verified from a replica
#                                peer shard (read-repair hits — each one
#                                is a Lotus fetch that never happened)
#   storex.replica_repair_misses — corrupt frames NO replica could supply
#                                verified bytes for (falls through to the
#                                inner store like a plain miss)
#   storex.replica_segments_pulled — whole segment files ingested from a
#                                peer by a replication sync pass
#   storex.replica_bytes_pulled — bytes of those pulled segment files
#   storex.rebalance_segments_pushed — segment files handed off to a new
#                                arc owner under the rebalance journal
#   storex.rebalance_resumes   — rebalance runs that replayed a partial
#                                journal (crash/SIGKILL mid-handoff)
STOREX_COUNTERS = (
    "storex.disk_hits",
    "storex.disk_misses",
    "storex.slice_hits",  # zero-copy frame slices handed out (mmap-backed)
    "storex.slice_misses",  # slice lookups that fell back to a copied read

    "storex.evictions",
    "storex.integrity_evictions",
    "storex.shared_evictions",
    "storex.write_failures",
    "storex.replica_repairs",
    "storex.replica_repair_misses",
    "storex.replica_segments_pulled",
    "storex.replica_bytes_pulled",
    "storex.rebalance_segments_pushed",
    "storex.rebalance_resumes",
    "follow.tipsets",
    "follow.blocks_prefetched",
    "follow.errors",
    "follow.leader_elections",
    "follow.polls",
)

# Counter vocabulary of the witness plane (witness/,
# cluster/gather.py, subs delta delivery): cross-request aggregation,
# delta witnesses, and compressed framing over the canonical bundle.
#   witness.aggregated_requests — aggregated bundles emitted (one witness
#                             shared by K claims)
#   witness.aggregated_claims — claims folded into those aggregates (the
#                             amortization numerator)
#   witness.merge_sorts      — seal-time canonical CID sorts in the
#                             incremental scatter fold (BundleFold.seal);
#                             one per scatter, never one per arrival
#   witness.delta_hits       — responses/deliveries shipped as deltas
#                             against a known base
#   witness.delta_fallbacks  — delta requested or eligible but the base
#                             was unknown/stale/vanished → full bundle
#                             (the sound degradation, never an error)
#   witness.delta_blocks_dropped — witness blocks omitted from deltas
#                             because the base already holds them (the
#                             bytes-saved numerator)
#   witness.compressed_frames — compressed witness frames emitted
#   witness.encoding_rejects — requests naming an unknown/disabled
#                             encoding, rejected with a typed 4xx
#   witness.fleet_base_hits  — base digests unknown to the local
#                             WitnessBaseCache but recovered from the
#                             fleet-wide registry directory (another
#                             shard's serve record) — the post-failover
#                             delta save
#   witness.fleet_base_misses — local miss AND directory miss → the
#                             delta falls back to full (sound)
WITNESS_COUNTERS = (
    "witness.aggregated_requests",
    "witness.aggregated_claims",
    "witness.merge_sorts",
    "witness.delta_hits",
    "witness.delta_fallbacks",
    "witness.delta_blocks_dropped",
    "witness.compressed_frames",
    "witness.encoding_rejects",
    "witness.fleet_base_hits",
    "witness.fleet_base_misses",
)

# Counter vocabulary of the provenance registry (registry/):
# the hash-linked audit log every served bundle seals a frame into, which
# doubles as the fleet-wide delta base directory.
#   registry.appends         — records committed to this process's chain
#                             (serve seals + fleet base acks)
#   registry.append_failures — appends that failed (write error or an
#                             already-degraded writer): serving continued
#                             bit-identical, the record was dropped — the
#                             fail-soft contract, and the SLO watchdog's
#                             registry_divergence anomaly signal
#   registry.torn_tails      — torn tails truncated on open (crash
#                             residue, recovered exactly like the jobs
#                             journal — never an error)
#   registry.proofs          — inclusion/consistency proofs generated
#   registry.fleet_refresh_errors — sibling-shard log scans that failed
#                             (missing/corrupt/torn sibling): fail-soft,
#                             the directory just misses
REGISTRY_COUNTERS = (
    "registry.appends",
    "registry.append_failures",
    "registry.torn_tails",
    "registry.proofs",
    "registry.fleet_refresh_errors",
)

# Counter vocabulary of the cluster plane (cluster/router.py,
# cluster/gather.py): the consistent-hash front end over N shard serve
# daemons.
#   cluster.requests         — single-key requests routed (verify/generate)
#   cluster.scatter_requests — multi-pair range requests scatter-gathered
#   cluster.sub_requests     — per-shard sub-requests a scatter produced
#   cluster.steals           — requests routed AWAY from their hash-affine
#                              shard because queue-depth imbalance crossed
#                              --steal-threshold (affinity is a cache hint,
#                              never a correctness constraint)
#   cluster.shard_errors     — transport-level shard failures observed
#                              (connection refused/reset/timeout)
#   cluster.shard_failovers  — re-dispatches of in-flight requests to a
#                              surviving shard after a shard death; the
#                              retry reuses the same idempotency key, so
#                              at-least-once + dedup absorbs the repeat
#   cluster.subscribe_requests — standing-query registrations routed to
#                              their filter-affine shard
#   cluster.subs_rearced     — subscriptions re-registered on a surviving
#                              shard after their home shard died (original
#                              sub ids; registry dedup absorbs replays)
#   cluster.stream_blocks_deduped — witness blocks a streamed scatter did
#                              NOT re-send because an earlier shard's
#                              sub-bundle already carried them (the fold's
#                              first-sight filter saves the wire bytes)
#   cluster.stream_cut_through — shard sub-responses relayed chunk-by-chunk
#                              on the streaming wire (Block chunks forwarded
#                              as they arrive) instead of store-and-forward
#                              of the whole shard response
#   cluster.replications_triggered — replication sync passes the router
#                              kicked off (cluster start, membership change,
#                              shard death re-replication to restore R)
#   cluster.slow_quarantines — placements routed away from their affine
#                              shard because its latency EWMA (not queue
#                              depth) dominated the effective-load gap: the
#                              gray-failure quarantine of a slow-not-dead
#                              shard
CLUSTER_COUNTERS = (
    "cluster.requests",
    "cluster.scatter_requests",
    "cluster.sub_requests",
    "cluster.steals",
    "cluster.shard_errors",
    "cluster.shard_failovers",
    "cluster.subscribe_requests",
    "cluster.subs_rearced",
    "cluster.stream_blocks_deduped",
    "cluster.stream_cut_through",
    "cluster.replications_triggered",
    "cluster.slow_quarantines",
)

# Stage-timer vocabulary (`Metrics.stage(...)`): every `with
# metrics.stage("name")` site in the tree must use one of these names —
# a typo'd stage silently forks a new timer that no bench leg reads.
PIPELINE_STAGES = (
    "fetch_tipsets",
    "resolve_address",
    "actor_walks",
    "slot_hash",
    "slot_reads",
    "materialize",
    "generate",
    "range_scan",
    "range_match",
    "range_record",
    "range_materialize",
    "range_merge",
    "range_verify",
    "range_storage",
    "serve.generate_batch",
    "serve.verify_batch",
    "serve.backfill_window",
)

# Gauge vocabulary: instantaneous state, overwritten not accumulated.
SERVE_GAUGES = (
    "serve.queue_depth.*",  # per-batcher queue depth (generate/verify)
    "serve.queue_depth_low.*",  # per-batcher LOW-priority lane depth
    "serve.queue_depth_push.*",  # per-batcher PUSH-priority lane depth
    "serve.result_cache_bytes",  # hot bytes in the spilled result cache
    "qos.tenant_queues",  # live per-tenant sub-queues in the fair queue
)

ADMIT_GAUGES = (
    "admit.limit",  # current AIMD concurrency limit
    "admit.inflight",  # requests holding an admission slot right now
)

DURABILITY_GAUGES = (
    "jobs.journal_bytes",  # bytes in the active job's write-ahead journal
)

STOREX_GAUGES = (
    "storex.disk_bytes",  # bytes across all disk-tier segment files
    "storex.replica_pending_segments",  # peer segments a sync pass still owes
    "follow.last_finalized_epoch",  # last height the follower warmed (healthz)
)

CLUSTER_GAUGES = (
    "cluster.shards_alive",  # shards currently routable (ring members)
    "cluster.inflight.*",  # per-shard outstanding requests (steal signal)
    "cluster.under_replicated_arcs",  # ring arcs whose replica set is not yet synced to R
    "cluster.replication_lag_segments",  # segment files replicas still owe (fleet sum)
)

# Histogram vocabulary: bounded-reservoir distributions (p50/p90/p99).
SERVE_HISTOGRAMS = (
    "serve.latency_ms.generate",
    "serve.latency_ms.verify",
    "serve.batch_size.*",  # per-batcher flushed-batch sizes
)

# Fleet observability plane (obs/fleet.py): the router's federation loop
# scraping every shard's /metrics.json and grafting shard span subtrees.
#   fleet.scrapes        — per-shard scrape attempts by the federation loop
#   fleet.scrape_errors  — scrapes that failed (shard dead/slow); the fleet
#                          view keeps serving degraded and counts the gap
#   fleet.spans_grafted  — shard-shipped spans re-rooted under the router's
#                          scatter-gather spans (trace stitching)
FLEET_COUNTERS = (
    "fleet.scrapes",
    "fleet.scrape_errors",
    "fleet.spans_grafted",
)

# Per-tenant accounting substrate and the QoS meters on top of it
# (serve/qos.py). Bounded cardinality: the first `top_k` tenants seen get
# their own label; everyone else accumulates into the `other` overflow
# bucket.
#   tenant.requests.<slot>  — admitted requests attributed to the slot
#   tenant.bytes.<slot>     — request + response bytes attributed to the
#                             slot (response bytes account at SEND time,
#                             streamed chunks included)
#   tenant.throttled.<slot> — admissions refused by the slot's token
#                             bucket (typed 429 + Retry-After)
#   qos.throttled           — all token-bucket refusals (slot-independent
#                             aggregate the SLO watchdog can page on)
TENANT_COUNTERS = (
    "tenant.requests.*",
    "tenant.bytes.*",
    "tenant.throttled.*",
    "qos.throttled",
)

# Deadline propagation + cooperative cancellation (utils/deadline.py,
# threaded through serve/, cluster/, store/, parallel/, proofs/):
#   serve.deadline_rejects   — requests refused because the remaining budget
#                              could not cover the admitting hop's floor
#                              (typed `deadline` error, never a partial
#                              bundle)
#   serve.cancelled_inflight — in-flight work units aborted by cooperative
#                              cancellation (client disconnect or mid-work
#                              expiry observed at a chunk/stage boundary)
#   deadline.rejects.<hop>   — per-hop budget refusals (`httpd`/`batcher`/
#                              `router`/`rpc`), so dashboards see WHERE
#                              budget dies
#   deadline.reclaimed_ms    — worker milliseconds freed by cancellation:
#                              the remaining batch-execution estimate at
#                              abort time. The overload leg's
#                              cancel_reclaim_pct numerator.
DEADLINE_COUNTERS = (
    "serve.deadline_rejects",
    "serve.cancelled_inflight",
    "deadline.rejects.httpd",
    "deadline.rejects.batcher",
    "deadline.rejects.router",
    "deadline.rejects.rpc",
    "deadline.reclaimed_ms",
)

# Adaptive admission (serve/qos.py GradientLimiter): AIMD concurrency
# limit driven by queue delay, replacing the static queue_capacity as the
# serve plane's first gate.
#   admit.accepted   — requests admitted under the current limit
#   admit.rejects    — requests shed at the limit (typed 429, honest
#                      Retry-After from the drain estimate)
#   admit.shed_other — rejects absorbed by the `other` tenant pool while
#                      named top-K tenants still fit their share (the
#                      tenant-aware shed order)
#   admit.grows      — additive limit increases (queue delay under budget)
#   admit.shrinks    — multiplicative limit decreases (p99 queue delay
#                      crossed the SLO-derived budget)
ADMIT_COUNTERS = (
    "admit.accepted",
    "admit.rejects",
    "admit.shed_other",
    "admit.grows",
    "admit.shrinks",
)

# `obs.trace.span`, bound at first use: obs imports this module (its
# collector counts into a `Metrics`), so the import is deferred
_span_factory = None


def _stage_span(name: str):
    """The trace span that an outermost `Metrics.stage` entry opens."""
    global _span_factory
    factory = _span_factory
    if factory is None:
        from ipc_proofs_tpu_torch.obs.trace import span as factory

        _span_factory = factory
    return factory(name)


@dataclass
class StageTimer:
    """One named stage's busy time and the union of its entry intervals."""

    total_s: float = 0.0
    calls: int = 0
    wall_s: float = 0.0
    _active: int = 0  # concurrent (outermost) entries right now
    _wall_start: float = 0.0  # perf_counter when _active went 0 -> 1

    def add(self, seconds: float) -> None:
        self.total_s += seconds
        self.calls += 1


class Histogram:
    """Bounded reservoir of observations with percentile snapshots.

    Keeps the most recent ``maxlen`` observations in a ring, so percentiles
    describe recent behaviour. Not thread-safe on its own; `Metrics` and
    `store.failover.EndpointPool` serialise access."""

    __slots__ = ("_ring", "_maxlen", "_next", "count", "total")

    def __init__(self, maxlen: int = 8192):
        self._ring: "list[float]" = []
        self._maxlen = maxlen
        self._next = 0  # ring insertion cursor once full
        self.count = 0  # lifetime observations
        self.total = 0.0  # lifetime sum

    def observe(self, value: float) -> None:
        self.count += 1
        self.total += value
        if len(self._ring) < self._maxlen:
            self._ring.append(value)
        else:
            self._ring[self._next] = value
            self._next = (self._next + 1) % self._maxlen

    def percentiles(self, qs=(0.5, 0.9, 0.99)) -> "dict[str, float]":
        """Nearest-rank percentiles over the retained window ({} if empty)."""
        if not self._ring:
            return {}
        ordered = sorted(self._ring)
        n = len(ordered)
        out = {}
        for q in qs:
            rank = min(n - 1, max(0, int(q * n + 0.5) - 1))
            out[f"p{int(q * 100)}"] = ordered[rank]
        return out

    def snapshot(self) -> dict:
        out = {"count": self.count, "mean": (self.total / self.count) if self.count else 0.0}
        out.update(self.percentiles())
        return out


class Metrics:
    """Thread-safe stage timers, counters, gauges and histograms.

    ``stage()`` is re-entrant per thread: nesting the SAME stage name on one
    thread counts only the outermost entry. Pipeline workers timing one
    stage from N threads add their busy time while ``wall_s`` tracks the
    interval union.
    """

    def __init__(self):
        # every subsystem counts/gauges while holding its own lock, so the
        # metrics lock is a terminal leaf in the global acquisition order:
        # lock-order: * < Metrics._lock
        self._lock = named_lock("Metrics._lock")
        self._tls = threading.local()
        self.timers: "dict[str, StageTimer]" = {}  # guarded-by: _lock
        self.counters: "dict[str, int]" = {}  # guarded-by: _lock
        self.gauges: "dict[str, float]" = {}  # guarded-by: _lock
        self.histograms: "dict[str, Histogram]" = {}  # guarded-by: _lock
        self.created_at = time.time()
        self._union_active = 0  # guarded-by: _lock
        self._union_start = 0.0  # guarded-by: _lock
        self.union_wall_s = 0.0  # guarded-by: _lock

    def reset(self) -> None:
        """Drop every timer, counter and gauge (a driver that runs several
        commands in one process reads each command's own counts)."""
        with self._lock:
            self.timers.clear()
            self.counters.clear()
            self.gauges.clear()
            self.histograms.clear()
            self._union_active = 0
            self._union_start = 0.0
            self.union_wall_s = 0.0

    @property
    def stage_s(self) -> "dict[str, float]":
        """Busy seconds per stage (a copy)."""
        with self._lock:
            return {name: timer.total_s for name, timer in self.timers.items()}

    @contextmanager
    def stage(self, name: str):
        depths = getattr(self._tls, "depths", None)
        if depths is None:
            depths = self._tls.depths = {}
        if depths.get(name, 0):
            # same-thread re-entry: the outermost entry covers this interval
            depths[name] += 1
            try:
                yield
            finally:
                depths[name] -= 1
            return
        depths[name] = 1
        try:
            with _stage_span(name):
                start = time.perf_counter()
                with self._lock:
                    timer = self.timers.setdefault(name, StageTimer())
                    if timer._active == 0:
                        timer._wall_start = start
                    timer._active += 1
                    if self._union_active == 0:
                        self._union_start = start
                    self._union_active += 1
                try:
                    yield
                finally:
                    end = time.perf_counter()
                    with self._lock:
                        timer.total_s += end - start
                        timer.calls += 1
                        timer._active -= 1
                        if timer._active == 0:
                            timer.wall_s += end - timer._wall_start
                        self._union_active -= 1
                        if self._union_active == 0:
                            self.union_wall_s += end - self._union_start
        finally:
            depths[name] -= 1
            if not depths[name]:
                del depths[name]

    def overlap_efficiency(self) -> "float | None":
        """Busy over union wall across all stages; None before any stage
        completed."""
        with self._lock:
            busy = sum(t.total_s for t in self.timers.values())
            wall = self.union_wall_s
        return (busy / wall) if wall > 0 else None

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def counter_value(self, name: str) -> int:
        with self._lock:
            return self.counters.get(name, 0)

    def set_gauge(self, name: str, value: float) -> None:
        """Instantaneous state; last write wins."""
        with self._lock:
            self.gauges[name] = value

    def observe(self, name: str, value: float) -> None:
        """Record one histogram observation (latency ms, batch size, …)."""
        with self._lock:
            hist = self.histograms.get(name)
            if hist is None:
                hist = self.histograms[name] = Histogram()
            hist.observe(value)

    def snapshot(self) -> dict:
        with self._lock:
            out = {
                "timers": {
                    k: {"total_s": round(v.total_s, 6), "calls": v.calls, "wall_s": round(v.wall_s, 6)}
                    for k, v in self.timers.items()
                },
                "counters": dict(self.counters),
                "uptime_s": round(time.time() - self.created_at, 3),
            }
            busy = sum(t.total_s for t in self.timers.values())
            if self.union_wall_s > 0:
                out["overlap_efficiency"] = round(busy / self.union_wall_s, 4)
            if self.gauges:
                out["gauges"] = dict(self.gauges)
            if self.histograms:
                out["histograms"] = {
                    k: {
                        key: (round(val, 6) if isinstance(val, float) else val)
                        for key, val in h.snapshot().items()
                    }
                    for k, h in self.histograms.items()
                }
            return out

    def to_json(self) -> str:
        return json.dumps(self.snapshot(), indent=2)


_global = Metrics()


def get_metrics() -> Metrics:
    """The process-global `Metrics` that the RPC client, the fetch plane and
    the blockstores count into when no instance is passed."""
    return _global
