#!/usr/bin/env python
"""Validate the port's BENCH_*.json artifacts against the bench reporting schema.

The port's own copy of the reference's ``tools/check_bench_schema.py``: the
same core and current key sets, the same gates and skip reasons, the same
``main``. It reads what ``bench_torch.py`` prints (the artifacts under
``bench_torch_runs/``) and imports nothing of the reference.

Catches bench-reporting regressions at test time instead of at
artifact-consumption time: a leg that silently stops emitting a key, a
type drift (string where a number was), or a headline missing the overlap
flags. Two strictness levels:

- every artifact (any vintage) must carry the CORE keys with sane types;
- the CURRENT artifact (``--require-current`` / ``require_current=True``)
  must carry the full present-day e2e key set — the orchestrator's
  ``_E2E_SCHEMA_KEYS`` contract plus the satellite leg keys — AND pass
  the perf gates: ``pipeline_speedup_vs_serial >= 1.0`` and
  ``cluster_linearity_4shard >= 0.8``, each whenever ``host_cores > 2``
  (hosts without spare cores skip the gates with a printed reason — see
  `speedup_gate_skip_reason` / `cluster_gate_skip_reason`), plus
  ``device_linearity_Nchip >= 0.8`` whenever ``onchip_devices > 1``
  (single-device hosts skip with a printed reason — see
  `onchip_gate_skip_reason`), plus the host-shape-independent standing
  amortization gate ``standing_generations_per_tipset <=
  standing_distinct_filters`` (see `standing_gate_skip_reason`) and the
  fleet-observability overhead gate ``fleetobs_overhead_pct <= 3``
  whenever ``host_cores > 2`` (the scrape/watchdog threads time-slice
  the request loop otherwise — see `fleetobs_gate_skip_reason`; the
  companion span-stitching check IS host-shape independent), the
  same-shaped trace-spine gate ``trace_overhead_pct <= 3`` whenever
  ``host_cores > 2`` (see `trace_gate_skip_reason`), the verify-autotune
  gate — ``verify_tuned_speedup >= 1.0`` unless the tuner honestly
  recorded ``verify_autotune_scalar_only`` (see
  `verify_autotune_gate_skip_reason`) — and the backfill gates
  ``backfill_epochs_per_sec > 0`` and ``backfill_ttfc_ms <
  backfill_total_ms`` (streaming must beat completion — see
  `backfill_gate_skip_reason`), plus the zero-copy gate
  ``warm_block_bytes_copied_per_resp == 0`` (pure accounting over the
  stream writer's own counters — host-shape independent, exactly zero,
  see `zerocopy_gate_skip_reason`) and the QoS fairness gate
  ``qos_light_tenant_p99_ms <= max(10 x p50, 250ms)`` whenever
  ``host_cores > 2`` (on smaller hosts the heavy flood time-slices the
  light tenant's only cores, so the tail measures core contention, not
  queue ordering — see `qos_gate_skip_reason`), and the multi-host
  gates ``kill_recovery_ms <= 10000``, ``replica_repair_hit_rate >=
  0.99``, and ``aggregate_proofs_per_sec_2host > 0`` whenever
  ``host_cores > 2`` (on smaller hosts the shards, load clients, and
  recovery probe time-slice the same core — see
  `hostkill_gate_skip_reason`), and the overload gates
  ``goodput_ratio_at_2x >= 0.8`` and ``cancel_reclaim_pct > 0`` whenever
  ``host_cores > 2`` (on smaller hosts the 2× closed-loop clients
  time-slice the server's only cores — see `overload_gate_skip_reason`),
  and the provenance-registry gates ``registry_append_overhead_pct < 1``
  and ``fleet_delta_hit_rate > fleet_delta_baseline_hit_rate`` (both are
  same-host ratios — host-shape independent, see
  `registry_gate_skip_reason`).

Importable (``check_artifact(obj) -> list[str]`` of problems) and a CLI::

    python -m ipc_proofs_tpu_torch.tools.check_bench_schema bench_torch_runs/BENCH_*.json
    python -m ipc_proofs_tpu_torch.tools.check_bench_schema --require-current bench_torch_runs/BENCH_torch_r01.json
"""

from __future__ import annotations

import argparse
import json
import sys

# round ≤5 artifacts are raw run-capture wrappers: the orchestrator JSON
# (when the run parsed) sits under "parsed"
_WRAPPER_KEYS = {"cmd", "rc", "tail"}

# every orchestrator artifact, any vintage, must have these
_CORE_REQUIRED = {
    "metric": str,
    "value": (int, float),
    "unit": str,
}

# known keys with their expected types; None is always allowed (legs can
# fail and the orchestrator nulls their keys honestly)
_NUM = (int, float)
_KNOWN_TYPES = {
    "platform": str,
    "devices": int,
    "host_cores": int,
    "host_cores_affinity": int,
    "scan_threads": int,
    "record_workers": int,
    "verify_workers": int,
    "effective_threads": int,
    "native_scan_threads": int,
    "pipeline_depth": int,
    "pipeline_chunk": int,
    "verify_chunk_pairs": int,
    "events_per_sec_e2e": _NUM,
    "proofs": int,
    "stages_ms": dict,
    "stages_wall_ms": dict,
    "stages_overlap": bool,
    "gen_verify_overlap": bool,
    "overlap_efficiency": _NUM,
    "serial_proofs_per_sec": _NUM,
    "serial_e2e_reps_s": list,
    "pipeline_speedup_vs_serial": _NUM,
    "e2e_policy": str,
    "e2e_reps_s": list,
    "vs_baseline": _NUM,
    "vs_native_baseline": _NUM,
    "scalar_baseline_proofs_per_sec": _NUM,
    "native_baseline_proofs_per_sec": _NUM,
    "device_mask_kernel_events_per_sec": _NUM,
    "witness_cid_kernel_per_sec": _NUM,
    "witness_cid_kernel": str,
    "serve_batched_rps": _NUM,
    "serve_sequential_rps": _NUM,
    "serve_speedup_vs_sequential": _NUM,
    "serve_concurrency": int,
    "serve_requests": int,
    "serve_p99_latency_ms": _NUM,
    "serve_mean_batch": _NUM,
    "serve_rejections": int,
    "witness_reduction_pct": _NUM,
    "witness_two_pass_bytes": int,
    "witness_single_pass_bytes": int,
    "witness_sample_pairs": int,
    "witness_bytes_per_proof_k1": _NUM,
    "witness_bytes_per_proof_k16": _NUM,
    "witness_bytes_per_proof_k256": _NUM,
    "witness_delta_ratio": _NUM,
    "witness_compressed_ratio": _NUM,
    "resilience_fault_free_proofs_per_sec": _NUM,
    "integrity_overhead_pct": _NUM,
    "proofs_per_sec_at_fault_rate": _NUM,
    "resilience_fault_rate": _NUM,
    "recovery_ms": _NUM,
    "durability_journal_overhead_pct": _NUM,
    "durability_resume_ms": _NUM,
    "durability_replay_chunks_per_sec": _NUM,
    "durability_journal_bytes": int,
    "durability_chunks": int,
    "trace_overhead_pct": _NUM,
    "spans_per_proof": _NUM,
    "observability_spans_recorded": int,
    "observability_spans_dropped": int,
    "observability_pairs": int,
    "cold_vs_warm_speedup": _NUM,
    "disk_hit_ratio": _NUM,
    "prefetch_hit_ratio": _NUM,
    "storage_cold_rpc_calls": int,
    "storage_warm_rpc_calls": int,
    "storage_prefetched_blocks": int,
    "storage_disk_bytes": int,
    "storage_pairs": int,
    "cold_rpc_roundtrips_per_proof": _NUM,
    "sync_rpc_roundtrips_per_proof": _NUM,
    "cold_speedup_vs_sync_walker": _NUM,
    "speculate_waste_pct": _NUM,
    "asyncfetch_batch_calls": int,
    "asyncfetch_cold_rpc_calls": int,
    "asyncfetch_sync_rpc_calls": int,
    "asyncfetch_pairs": int,
    "cluster_linearity_4shard": _NUM,
    "aggregate_proofs_per_sec": _NUM,
    "steal_events": int,
    "cluster_rps_1shard": _NUM,
    "cluster_rps_4shard": _NUM,
    "cluster_pairs": int,
    "cluster_requests": int,
    "device_linearity_Nchip": _NUM,
    "batch_verify_speedup": _NUM,
    "onchip_devices": int,
    "onchip_match_events": int,
    "onchip_verify_blocks": int,
    "onchip_device_calls": int,
    "verify_tuned_speedup": _NUM,
    "verify_autotune_scalar_only": bool,
    "verify_autotuned_min_bytes": int,
    "backfill_epochs_per_sec": _NUM,
    "backfill_epochs_per_sec_1shard": _NUM,
    "backfill_ttfc_ms": _NUM,
    "backfill_total_ms": _NUM,
    "backfill_occupancy_pct": _NUM,
    "backfill_windows": int,
    "backfill_epochs": int,
    "backfill_shards": int,
    "standing_proofs_pushed_per_sec_1k": _NUM,
    "standing_proofs_pushed_per_sec_10k": _NUM,
    "standing_delivery_lag_p50_ms": _NUM,
    "standing_delivery_lag_p99_ms": _NUM,
    "standing_subscriptions": int,
    "standing_tipsets": int,
    "standing_distinct_filters": int,
    "standing_generations_per_tipset": _NUM,
    "fleetobs_overhead_pct": _NUM,
    "fleetobs_rps_plain": _NUM,
    "fleetobs_rps_observed": _NUM,
    "fleetobs_stitched_spans": int,
    "fleetobs_scrapes": int,
    "fleetobs_pairs": int,
    "fleetobs_requests": int,
    "warm_block_bytes_copied_per_resp": _NUM,
    "stream_ttfb_ms": _NUM,
    "qos_light_tenant_p99_ms": _NUM,
    "qos_light_tenant_p50_ms": _NUM,
    "qos_heavy_backlog_drain_ms": _NUM,
    "zerocopy_bytes_per_resp": _NUM,
    "zerocopy_responses": int,
    "qos_heavy_concurrency": int,
    "qos_heavy_requests": int,
    "zerocopy_host_cpus": int,
    "aggregate_proofs_per_sec_2host": _NUM,
    "replica_repair_hit_rate": _NUM,
    "kill_recovery_ms": _NUM,
    "hostkill_pairs": int,
    "hostkill_requests": int,
    "hostkill_failovers": int,
    "goodput_ratio_at_2x": _NUM,
    "shed_rate": _NUM,
    "light_tenant_p99_ms_overload": _NUM,
    "cancel_reclaim_pct": _NUM,
    "overload_capacity_rps": _NUM,
    "overload_goodput_rps": _NUM,
    "overload_requests": int,
    "overload_doomed_requests": int,
    "overload_admit_limit_final": _NUM,
    "overload_host_cpus": int,
    "registry_append_overhead_pct": _NUM,
    "registry_append_us": _NUM,
    "registry_inclusion_proof_ms": _NUM,
    "fleet_delta_hit_rate": _NUM,
    "fleet_delta_baseline_hit_rate": _NUM,
    "registry_chain_records": int,
    "registry_serve_requests": int,
    "registry_shards": int,
    "registry_lookups": int,
    "legs": dict,
    "watchdog_fallback": bool,
}

# the CURRENT artifact must report the full e2e contract: host
# introspection, pipeline knobs, both overlap flags, and the serial
# comparison the speedup ratio is derived from
_CURRENT_REQUIRED = (
    "platform", "devices", "host_cores", "host_cores_affinity",
    "scan_threads", "record_workers", "verify_workers", "effective_threads",
    "native_scan_threads", "pipeline_depth",
    "pipeline_chunk", "events_per_sec_e2e", "proofs", "stages_ms",
    "stages_wall_ms", "stages_overlap", "gen_verify_overlap",
    "overlap_efficiency", "serial_proofs_per_sec", "serial_e2e_reps_s",
    "pipeline_speedup_vs_serial", "e2e_policy", "e2e_reps_s",
    "vs_baseline", "vs_native_baseline",
    "scalar_baseline_proofs_per_sec", "native_baseline_proofs_per_sec",
    "serve_batched_rps", "serve_speedup_vs_sequential",
    "witness_reduction_pct",
    "witness_bytes_per_proof_k1", "witness_bytes_per_proof_k16",
    "witness_bytes_per_proof_k256", "witness_delta_ratio",
    "witness_compressed_ratio",
    "resilience_fault_free_proofs_per_sec", "integrity_overhead_pct",
    "proofs_per_sec_at_fault_rate", "resilience_fault_rate", "recovery_ms",
    "durability_journal_overhead_pct", "durability_resume_ms",
    "durability_replay_chunks_per_sec", "durability_journal_bytes",
    "durability_chunks",
    "trace_overhead_pct", "spans_per_proof",
    "cold_vs_warm_speedup", "disk_hit_ratio", "prefetch_hit_ratio",
    "cold_rpc_roundtrips_per_proof", "sync_rpc_roundtrips_per_proof",
    "cold_speedup_vs_sync_walker", "speculate_waste_pct",
    "cluster_linearity_4shard", "aggregate_proofs_per_sec", "steal_events",
    "device_linearity_Nchip", "batch_verify_speedup",
    "verify_tuned_speedup", "verify_autotune_scalar_only",
    "backfill_epochs_per_sec", "backfill_ttfc_ms", "backfill_total_ms",
    "standing_proofs_pushed_per_sec_1k", "standing_proofs_pushed_per_sec_10k",
    "standing_delivery_lag_p50_ms", "standing_delivery_lag_p99_ms",
    "standing_subscriptions", "standing_tipsets",
    "standing_distinct_filters", "standing_generations_per_tipset",
    "fleetobs_overhead_pct", "fleetobs_rps_plain", "fleetobs_rps_observed",
    "fleetobs_stitched_spans",
    "warm_block_bytes_copied_per_resp", "stream_ttfb_ms",
    "qos_light_tenant_p99_ms",
    "aggregate_proofs_per_sec_2host", "replica_repair_hit_rate",
    "kill_recovery_ms",
    "goodput_ratio_at_2x", "shed_rate", "light_tenant_p99_ms_overload",
    "cancel_reclaim_pct",
    "registry_append_overhead_pct", "registry_inclusion_proof_ms",
    "fleet_delta_hit_rate", "fleet_delta_baseline_hit_rate",
    "legs", "watchdog_fallback",
)


def check_artifact(obj: dict, require_current: bool = False) -> list[str]:
    """Return a list of problems ([] = valid).

    ``require_current`` additionally demands the full present-day key set
    (apply it to the newest artifact only — old vintages legitimately
    predate newer keys).
    """
    problems: list[str] = []
    if not isinstance(obj, dict):
        return [f"artifact is {type(obj).__name__}, expected object"]

    if _WRAPPER_KEYS <= set(obj):
        # legacy run-capture wrapper: validate the parsed payload when the
        # wrapped run succeeded; a failed capture (parsed: null) is honest
        if require_current:
            problems.append("current artifact must be orchestrator JSON, not a run-capture wrapper")
        parsed = obj.get("parsed")
        if parsed is None:
            return problems
        return problems + [f"parsed: {p}" for p in check_artifact(parsed)]

    for key, types in _CORE_REQUIRED.items():
        if key not in obj:
            problems.append(f"missing required key {key!r}")
        elif obj[key] is not None and not isinstance(obj[key], types):
            problems.append(
                f"{key!r} is {type(obj[key]).__name__}, expected {types}"
            )
    # the headline may be null only in the total-failure artifact, which
    # still carries the schema — "value" must then EXIST and be null
    if "value" in obj and obj["value"] is None and obj.get("platform") is not None:
        problems.append("null value with a non-null platform (partial schema)")

    for key, types in _KNOWN_TYPES.items():
        if key in obj and obj[key] is not None and not isinstance(obj[key], types):
            # bool is an int subclass; don't let flags pass as numbers
            problems.append(
                f"{key!r} is {type(obj[key]).__name__}, expected {types}"
            )
        if (
            key in obj
            and isinstance(obj[key], bool)
            and not (types is bool or types == bool)
        ):
            problems.append(f"{key!r} is bool, expected {types}")

    for key in ("stages_ms", "stages_wall_ms"):
        val = obj.get(key)
        if isinstance(val, dict):
            for stage, ms in val.items():
                if not isinstance(ms, (int, float)) or isinstance(ms, bool):
                    problems.append(f"{key}[{stage!r}] is not a number")

    for key in ("e2e_reps_s", "serial_e2e_reps_s"):
        val = obj.get(key)
        if isinstance(val, list) and any(
            not isinstance(v, (int, float)) or isinstance(v, bool) for v in val
        ):
            problems.append(f"{key!r} has non-numeric entries")

    if require_current:
        for key in _CURRENT_REQUIRED:
            if key not in obj:
                problems.append(f"current artifact missing key {key!r}")
        # the perf gate: with spare cores the stage-overlapped engine must
        # actually BEAT the serial engine, not just exist (>2 because two
        # cores barely cover scan+record and the ratio sits at the noise
        # floor; 1-core hosts run the serial fallback by design)
        if speedup_gate_skip_reason(obj) is None:
            speedup = obj.get("pipeline_speedup_vs_serial")
            if not isinstance(speedup, _NUM) or isinstance(speedup, bool):
                problems.append(
                    "speedup gate: pipeline_speedup_vs_serial is "
                    f"{speedup!r} on a {obj.get('host_cores')}-core host "
                    "(pipelined leg did not run?)"
                )
            elif speedup < 1.0:
                problems.append(
                    f"speedup gate: pipeline_speedup_vs_serial={speedup} "
                    f"< 1.0 on a {obj.get('host_cores')}-core host — the "
                    "stage-overlapped engine must beat serial when cores "
                    "are available"
                )
        # the asyncfetch gate: the fetch plane must issue STRICTLY fewer
        # RPC round-trips per proof than the sync walker in the SAME
        # artifact — batching that doesn't collapse round-trips is a
        # regression, regardless of host shape (round-trip counts are
        # deterministic I/O accounting, not scheduling)
        if asyncfetch_gate_skip_reason(obj) is None:
            cold = obj.get("cold_rpc_roundtrips_per_proof")
            sync = obj.get("sync_rpc_roundtrips_per_proof")
            for name, val in (
                ("cold_rpc_roundtrips_per_proof", cold),
                ("sync_rpc_roundtrips_per_proof", sync),
            ):
                if not isinstance(val, _NUM) or isinstance(val, bool):
                    problems.append(
                        f"asyncfetch gate: {name} is {val!r} "
                        "(asyncfetch leg did not run?)"
                    )
            if (
                isinstance(cold, _NUM) and not isinstance(cold, bool)
                and isinstance(sync, _NUM) and not isinstance(sync, bool)
                and cold >= sync
            ):
                problems.append(
                    f"asyncfetch gate: cold_rpc_roundtrips_per_proof={cold} "
                    f">= sync_rpc_roundtrips_per_proof={sync} — the fetch "
                    "plane must need strictly fewer round-trips than the "
                    "sync walker"
                )
        # the cluster gate: with spare cores, 4 shard processes must keep
        # ≥ 80% of ideal linear scaling over 1 shard. A 1-core host
        # time-slices the shard processes (linearity collapses by design),
        # so the gate applies on the same host shape as the speedup gate.
        # the onchip gate: with more than one accelerator device, the
        # mesh-sharded match kernel must keep ≥ 80% of ideal linear
        # scaling over the single-device path. A 1-device host runs both
        # sides on the same chip — the ratio then measures pjit dispatch
        # overhead, not scaling — so the gate only applies multi-device.
        if onchip_gate_skip_reason(obj) is None:
            linearity = obj.get("device_linearity_Nchip")
            if not isinstance(linearity, _NUM) or isinstance(linearity, bool):
                problems.append(
                    "onchip gate: device_linearity_Nchip is "
                    f"{linearity!r} on a {obj.get('onchip_devices')}-device "
                    "host (onchip leg did not run?)"
                )
            elif linearity < 0.8:
                problems.append(
                    f"onchip gate: device_linearity_Nchip={linearity} "
                    f"< 0.8 on a {obj.get('onchip_devices')}-device host — "
                    "mesh-sharded matching must scale near-linearly across "
                    "local devices"
                )
        # the standing gate: fan-out amortization is an invariant, not a
        # scheduling outcome — proofs generate once per distinct (pair,
        # filter) and fan out to every subscriber, so generations per
        # tipset can never exceed the distinct filter count, on any host
        # shape. Only artifacts predating the leg skip.
        if standing_gate_skip_reason(obj) is None:
            gens = obj.get("standing_generations_per_tipset")
            filts = obj.get("standing_distinct_filters")
            for name, val in (
                ("standing_generations_per_tipset", gens),
                ("standing_distinct_filters", filts),
            ):
                if not isinstance(val, _NUM) or isinstance(val, bool):
                    problems.append(
                        f"standing gate: {name} is {val!r} "
                        "(standing leg did not run?)"
                    )
            if (
                isinstance(gens, _NUM) and not isinstance(gens, bool)
                and isinstance(filts, _NUM) and not isinstance(filts, bool)
                and gens > filts
            ):
                problems.append(
                    f"standing gate: standing_generations_per_tipset={gens} "
                    f"> standing_distinct_filters={filts} — fan-out must "
                    "amortize: one generation per distinct filter shared by "
                    "all its subscribers"
                )
        # the witness-diet gate: aggregation and delta savings are wire
        # accounting, not scheduling — K=16 co-tipset claims must cost
        # strictly fewer bytes per proof than K=1 (the claim table shares
        # one witness), and a consecutive-epoch delta must be strictly
        # smaller than re-shipping the full bundle. Host-shape
        # independent; only artifacts predating the leg skip.
        if witnessdiet_gate_skip_reason(obj) is None:
            k1 = obj.get("witness_bytes_per_proof_k1")
            k16 = obj.get("witness_bytes_per_proof_k16")
            dratio = obj.get("witness_delta_ratio")
            for name, val in (
                ("witness_bytes_per_proof_k1", k1),
                ("witness_bytes_per_proof_k16", k16),
                ("witness_delta_ratio", dratio),
            ):
                if not isinstance(val, _NUM) or isinstance(val, bool):
                    problems.append(
                        f"witness-diet gate: {name} is {val!r} "
                        "(witness leg did not run?)"
                    )
            if (
                isinstance(k1, _NUM) and not isinstance(k1, bool)
                and isinstance(k16, _NUM) and not isinstance(k16, bool)
                and k16 >= k1
            ):
                problems.append(
                    f"witness-diet gate: witness_bytes_per_proof_k16={k16} "
                    f">= witness_bytes_per_proof_k1={k1} — aggregating 16 "
                    "co-tipset claims must cost strictly fewer bytes per "
                    "proof than one claim per response"
                )
            if (
                isinstance(dratio, _NUM) and not isinstance(dratio, bool)
                and dratio >= 1.0
            ):
                problems.append(
                    f"witness-diet gate: witness_delta_ratio={dratio} "
                    ">= 1.0 — a consecutive-epoch delta must be strictly "
                    "smaller than re-shipping the full bundle"
                )
        # the fleet-observability gate: the whole observability plane
        # (federated scraping, SLO watchdog, tenant accounting, sampled
        # trace shipping) must cost ≤ 3% of router throughput. The ratio
        # needs spare cores — on ≤2-core hosts the scrape and watchdog
        # threads time-slice the request loop, so the measurement is core
        # contention, not the plane's cost.
        if fleetobs_gate_skip_reason(obj) is None:
            ovh = obj.get("fleetobs_overhead_pct")
            if not isinstance(ovh, _NUM) or isinstance(ovh, bool):
                problems.append(
                    f"fleetobs gate: fleetobs_overhead_pct is {ovh!r} "
                    "(fleetobs leg did not run?)"
                )
            elif ovh > 3.0:
                problems.append(
                    f"fleetobs gate: fleetobs_overhead_pct={ovh} > 3.0 — "
                    "the fleet observability plane must cost at most 3% "
                    "of router throughput"
                )
        # span stitching is correctness, not perf (measured outside the
        # timed window at sample=1.0): enforced on every artifact carrying
        # the fleetobs keys regardless of host shape.
        if (
            "fleetobs_overhead_pct" in obj
            or "fleetobs_stitched_spans" in obj
        ):
            stitched = obj.get("fleetobs_stitched_spans")
            if (
                isinstance(stitched, _NUM) and not isinstance(stitched, bool)
                and stitched < 1
            ):
                problems.append(
                    f"fleetobs gate: fleetobs_stitched_spans={stitched} "
                    "< 1 — a fully-sampled scatter must graft shard span "
                    "subtrees into the router's trace"
                )
        # the trace-overhead gate: the span collector's ≤ 3% budget,
        # enforced the same way as the fleetobs gate — the off/on delta
        # needs spare cores; on ≤2-core hosts the collector's lock and
        # ring maintenance time-slice the pipeline's only cores and the
        # measurement is contention, not the spine's cost.
        if trace_gate_skip_reason(obj) is None:
            ovh = obj.get("trace_overhead_pct")
            if not isinstance(ovh, _NUM) or isinstance(ovh, bool):
                problems.append(
                    f"trace gate: trace_overhead_pct is {ovh!r} "
                    "(observability leg did not run?)"
                )
            elif ovh > 3.0:
                problems.append(
                    f"trace gate: trace_overhead_pct={ovh} > 3.0 — the "
                    "trace spine must cost at most 3% of pipelined range "
                    "throughput"
                )
        # the verify-autotune gate: the lane the per-host tuner picks must
        # never lose to scalar — either the tuned crossover selected the
        # device lane AND it is at least as fast (speedup ≥ 1.0), or the
        # tuner honestly stayed scalar-only. Host-shape independent: the
        # tuner's whole job is to make the choice correct on THIS host.
        if verify_autotune_gate_skip_reason(obj) is None:
            tuned = obj.get("verify_tuned_speedup")
            scalar_only = obj.get("verify_autotune_scalar_only")
            if not isinstance(tuned, _NUM) or isinstance(tuned, bool):
                problems.append(
                    f"verify-autotune gate: verify_tuned_speedup is "
                    f"{tuned!r} (onchip leg did not run?)"
                )
            elif scalar_only is not True and tuned < 1.0:
                problems.append(
                    f"verify-autotune gate: verify_tuned_speedup={tuned} "
                    "< 1.0 with the device lane selected — the autotuned "
                    "crossover must pick the device lane only when it "
                    "actually wins (or record scalar_only honestly)"
                )
        # the backfill gate: a batch job must make progress AND stream —
        # epochs/s strictly positive and the first chunk strictly before
        # completion. Both are accounting over the engine's own clock, so
        # the gate is host-shape independent.
        if backfill_gate_skip_reason(obj) is None:
            eps = obj.get("backfill_epochs_per_sec")
            ttfc = obj.get("backfill_ttfc_ms")
            total = obj.get("backfill_total_ms")
            for name, val in (
                ("backfill_epochs_per_sec", eps),
                ("backfill_ttfc_ms", ttfc),
                ("backfill_total_ms", total),
            ):
                if not isinstance(val, _NUM) or isinstance(val, bool):
                    problems.append(
                        f"backfill gate: {name} is {val!r} "
                        "(backfill leg did not run?)"
                    )
            if isinstance(eps, _NUM) and not isinstance(eps, bool) and eps <= 0:
                problems.append(
                    f"backfill gate: backfill_epochs_per_sec={eps} <= 0 — "
                    "the batch job made no progress"
                )
            if (
                isinstance(ttfc, _NUM) and not isinstance(ttfc, bool)
                and isinstance(total, _NUM) and not isinstance(total, bool)
                and ttfc >= total
            ):
                problems.append(
                    f"backfill gate: backfill_ttfc_ms={ttfc} >= "
                    f"backfill_total_ms={total} — incremental delivery "
                    "must stream the first chunk strictly before the job "
                    "completes"
                )
        # the zero-copy gate: block payload bytes copied through Python
        # per disk-warm streamed response must be EXACTLY zero — the
        # stream writer accounts every payload it sends as zero-copy
        # (memoryview of a segment frame) or copied, so any non-zero
        # value means a fallback path ran on a warm store. Pure
        # accounting; host-shape independent.
        if zerocopy_gate_skip_reason(obj) is None:
            copied = obj.get("warm_block_bytes_copied_per_resp")
            ttfb = obj.get("stream_ttfb_ms")
            if not isinstance(copied, _NUM) or isinstance(copied, bool):
                problems.append(
                    "zerocopy gate: warm_block_bytes_copied_per_resp is "
                    f"{copied!r} (zerocopy leg did not run?)"
                )
            elif copied != 0:
                problems.append(
                    f"zerocopy gate: warm_block_bytes_copied_per_resp="
                    f"{copied} != 0 — disk-warm streamed responses must "
                    "send block payloads as segment-frame slices, never "
                    "copies"
                )
            if (
                isinstance(ttfb, _NUM)
                and not isinstance(ttfb, bool)
                and ttfb <= 0
            ):
                problems.append(
                    f"zerocopy gate: stream_ttfb_ms={ttfb} <= 0 — "
                    "time-to-first-byte must be a positive measurement"
                )
        # the QoS fairness gate: under a saturating heavy tenant, the
        # light tenant's tail must stay near its median — fair tenant
        # queues bound every light request's wait to a constant number
        # of rounds, while FIFO starvation balloons p99 relative to p50.
        if qos_gate_skip_reason(obj) is None:
            p99 = obj.get("qos_light_tenant_p99_ms")
            p50 = obj.get("qos_light_tenant_p50_ms")
            if not isinstance(p99, _NUM) or isinstance(p99, bool):
                problems.append(
                    f"qos gate: qos_light_tenant_p99_ms is {p99!r} "
                    "(zerocopy leg did not run?)"
                )
            elif isinstance(p50, _NUM) and not isinstance(p50, bool):
                bound = max(10 * p50, 250.0)
                if p99 > bound:
                    problems.append(
                        f"qos gate: qos_light_tenant_p99_ms={p99} > "
                        f"{bound} (max(10 x p50={p50}, 250)) — the fair "
                        "queue must bound the light tenant's tail under "
                        "a heavy tenant's flood"
                    )
        # the hostkill gate: under replication_factor=2, killing one host
        # mid-load must leave the cluster whole again quickly, the
        # replica plane must absorb corrupt-frame evictions without
        # touching Lotus, and the replicated pair must still do real
        # work. All three measurements need spare cores — on ≤2-core
        # hosts the shards, the load clients, and the recovery probe
        # time-slice the same core, so the clock measures contention,
        # not the failover plane (the artifact still records the
        # honestly-measured numbers).
        if hostkill_gate_skip_reason(obj) is None:
            recovery = obj.get("kill_recovery_ms")
            hit_rate = obj.get("replica_repair_hit_rate")
            agg = obj.get("aggregate_proofs_per_sec_2host")
            for name, val in (
                ("kill_recovery_ms", recovery),
                ("replica_repair_hit_rate", hit_rate),
                ("aggregate_proofs_per_sec_2host", agg),
            ):
                if not isinstance(val, _NUM) or isinstance(val, bool):
                    problems.append(
                        f"hostkill gate: {name} is {val!r} "
                        "(hostkill leg did not run?)"
                    )
            if (
                isinstance(recovery, _NUM) and not isinstance(recovery, bool)
                and recovery > 10_000
            ):
                problems.append(
                    f"hostkill gate: kill_recovery_ms={recovery} > 10000 — "
                    "a byte-identical scatter must complete within 10 s of "
                    "a host death"
                )
            if (
                isinstance(hit_rate, _NUM) and not isinstance(hit_rate, bool)
                and hit_rate < 0.99
            ):
                problems.append(
                    f"hostkill gate: replica_repair_hit_rate={hit_rate} "
                    "< 0.99 — with a live replica every corrupt-frame "
                    "eviction must repair peer-to-peer, not from Lotus"
                )
            if (
                isinstance(agg, _NUM) and not isinstance(agg, bool)
                and agg <= 0
            ):
                problems.append(
                    f"hostkill gate: aggregate_proofs_per_sec_2host={agg} "
                    "<= 0 — the replicated pair did no work"
                )
        # the overload gate: a serve plane at 2× offered load must keep
        # doing ≈ its capacity's worth of real work — shedding the excess
        # with honest 429s instead of letting queue collapse drag goodput
        # down. Needs spare cores: on ≤2-core hosts the overload clients
        # time-slice the server's only cores and the ratio measures
        # scheduler contention, not admission control.
        if overload_gate_skip_reason(obj) is None:
            ratio = obj.get("goodput_ratio_at_2x")
            reclaim = obj.get("cancel_reclaim_pct")
            if not isinstance(ratio, _NUM) or isinstance(ratio, bool):
                problems.append(
                    f"overload gate: goodput_ratio_at_2x is {ratio!r} "
                    "(overload leg did not run?)"
                )
            elif ratio < 0.8:
                problems.append(
                    f"overload gate: goodput_ratio_at_2x={ratio} < 0.8 — "
                    "under 2x offered load the admission gate must shed "
                    "the excess and keep goodput near capacity, not let "
                    "queueing collapse it"
                )
            if (
                isinstance(reclaim, _NUM)
                and not isinstance(reclaim, bool)
                and reclaim <= 0
            ):
                problems.append(
                    f"overload gate: cancel_reclaim_pct={reclaim} <= 0 — "
                    "tight-deadline requests must be refused or dropped "
                    "before burning a worker, at least sometimes"
                )
        # the registry gate: sealing one provenance frame per served
        # bundle must cost < 1% of the request it rides on, and the
        # fleet base directory must beat per-shard base caches when a
        # lookup lands on a shard that didn't serve the base. Both are
        # ratios of measurements taken on the SAME host — the append/
        # request costs scale together, and the hit rates are counting —
        # so the gates are host-shape independent; only artifacts
        # predating the registry leg skip.
        if registry_gate_skip_reason(obj) is None:
            ovh = obj.get("registry_append_overhead_pct")
            proof_ms = obj.get("registry_inclusion_proof_ms")
            fleet = obj.get("fleet_delta_hit_rate")
            base = obj.get("fleet_delta_baseline_hit_rate")
            for name, val in (
                ("registry_append_overhead_pct", ovh),
                ("registry_inclusion_proof_ms", proof_ms),
                ("fleet_delta_hit_rate", fleet),
                ("fleet_delta_baseline_hit_rate", base),
            ):
                if not isinstance(val, _NUM) or isinstance(val, bool):
                    problems.append(
                        f"registry gate: {name} is {val!r} "
                        "(registry leg did not run?)"
                    )
            if (
                isinstance(ovh, _NUM) and not isinstance(ovh, bool)
                and ovh >= 1.0
            ):
                problems.append(
                    f"registry gate: registry_append_overhead_pct={ovh} "
                    ">= 1.0 — sealing a provenance frame must cost under "
                    "1% of the request it audits"
                )
            if (
                isinstance(proof_ms, _NUM) and not isinstance(proof_ms, bool)
                and proof_ms <= 0
            ):
                problems.append(
                    f"registry gate: registry_inclusion_proof_ms={proof_ms} "
                    "<= 0 — inclusion proving must be a positive measurement"
                )
            if (
                isinstance(fleet, _NUM) and not isinstance(fleet, bool)
                and isinstance(base, _NUM) and not isinstance(base, bool)
                and fleet <= base
            ):
                problems.append(
                    f"registry gate: fleet_delta_hit_rate={fleet} <= "
                    f"fleet_delta_baseline_hit_rate={base} — the fleet base "
                    "directory must strictly beat per-shard base caches on "
                    "scattered lookups"
                )
        if cluster_gate_skip_reason(obj) is None:
            linearity = obj.get("cluster_linearity_4shard")
            if not isinstance(linearity, _NUM) or isinstance(linearity, bool):
                problems.append(
                    "cluster gate: cluster_linearity_4shard is "
                    f"{linearity!r} on a {obj.get('host_cores')}-core host "
                    "(cluster leg did not run?)"
                )
            elif linearity < 0.8:
                problems.append(
                    f"cluster gate: cluster_linearity_4shard={linearity} "
                    f"< 0.8 on a {obj.get('host_cores')}-core host — "
                    "4 shard processes must scale near-linearly when cores "
                    "are available"
                )
    return problems


def speedup_gate_skip_reason(obj: dict) -> "str | None":
    """Why the ≥1.0 pipeline-speedup gate does NOT apply to this artifact
    (None when it does). Callers print the reason so a skipped gate is
    visible, never silent."""
    cores = obj.get("host_cores")
    if not isinstance(cores, int):
        return f"host_cores={cores!r} (unknown host shape)"
    if cores <= 2:
        return (
            f"host_cores={cores} ≤ 2 — stage overlap cannot pay without "
            "spare cores (1-core hosts run the serial fallback by design)"
        )
    return None


def asyncfetch_gate_skip_reason(obj: dict) -> "str | None":
    """Why the cold-below-sync round-trip gate does NOT apply (None when
    it does). The gate is host-shape independent — round-trip counts are
    I/O accounting — so the only skip is an artifact that predates the
    asyncfetch leg entirely (no keys at all, old vintage validated
    without --require-current)."""
    if (
        "cold_rpc_roundtrips_per_proof" not in obj
        and "sync_rpc_roundtrips_per_proof" not in obj
    ):
        return "artifact predates the asyncfetch leg"
    return None


def cluster_gate_skip_reason(obj: dict) -> "str | None":
    """Why the ≥0.8 cluster-linearity gate does NOT apply to this artifact
    (None when it does). Callers print the reason so a skipped gate is
    visible, never silent."""
    cores = obj.get("host_cores")
    if not isinstance(cores, int):
        return f"host_cores={cores!r} (unknown host shape)"
    if cores <= 2:
        return (
            f"host_cores={cores} ≤ 2 — four shard processes time-slice the "
            "same cores, so linearity over one shard cannot hold"
        )
    return None


def onchip_gate_skip_reason(obj: dict) -> "str | None":
    """Why the ≥0.8 device-linearity gate does NOT apply to this artifact
    (None when it does). Callers print the reason so a skipped gate is
    visible, never silent."""
    devices = obj.get("onchip_devices")
    if not isinstance(devices, int):
        return f"onchip_devices={devices!r} (unknown device count)"
    if devices <= 1:
        return (
            f"onchip_devices={devices} ≤ 1 — mesh and single-device paths "
            "share the one chip, so the ratio measures pjit dispatch "
            "overhead, not device scaling"
        )
    return None


def standing_gate_skip_reason(obj: dict) -> "str | None":
    """Why the generations ≤ distinct-filters amortization gate does NOT
    apply (None when it does). Like the asyncfetch gate this is
    host-shape independent — generation counts are deterministic
    accounting — so the only skip is an artifact predating the standing
    leg (old vintage validated without --require-current)."""
    if (
        "standing_generations_per_tipset" not in obj
        and "standing_distinct_filters" not in obj
    ):
        return "artifact predates the standing leg"
    return None


def witnessdiet_gate_skip_reason(obj: dict) -> "str | None":
    """Why the K=16 < K=1 / delta < 1.0 witness-diet gate does NOT apply
    (None when it does). Wire byte counts are deterministic accounting —
    host-shape independent — so the only skip is an artifact predating
    the witness-diet measurements (old vintage validated without
    --require-current)."""
    if (
        "witness_bytes_per_proof_k1" not in obj
        and "witness_delta_ratio" not in obj
    ):
        return "artifact predates the witness-diet leg"
    return None


def fleetobs_gate_skip_reason(obj: dict) -> "str | None":
    """Why the ≤3% fleet-observability overhead gate does NOT apply (None
    when it does). Measuring the ratio needs spare cores: on ≤2-core
    hosts the federation scrape and SLO watchdog threads time-slice the
    request loop's only cores, so the observed/plain delta reflects core
    contention, not the plane's cost. The companion span-stitching check
    is host-shape independent and is NOT skipped with the ratio."""
    if (
        "fleetobs_overhead_pct" not in obj
        and "fleetobs_stitched_spans" not in obj
    ):
        return "artifact predates the fleetobs leg"
    cores = obj.get("host_cores")
    if not isinstance(cores, int):
        return f"host_cores={cores!r} (unknown host shape)"
    if cores <= 2:
        return (
            f"host_cores={cores} ≤ 2 — the federation scrape and SLO "
            "watchdog threads time-slice the request loop's cores, so "
            "measured overhead is core contention, not the plane's cost"
        )
    return None


def trace_gate_skip_reason(obj: dict) -> "str | None":
    """Why the ≤3% trace-overhead gate does NOT apply (None when it
    does). Same shape as the fleetobs gate: the off/on ratio needs spare
    cores — on ≤2-core hosts the collector time-slices the pipeline's
    only cores, so the measured delta is core contention, not the trace
    spine's cost (BENCH_r18 measured 12.29% on a 1-core host for exactly
    this reason). Callers print the reason so a skipped gate is visible,
    never silent."""
    if "trace_overhead_pct" not in obj:
        return "artifact predates the observability leg"
    cores = obj.get("host_cores")
    if not isinstance(cores, int):
        return f"host_cores={cores!r} (unknown host shape)"
    if cores <= 2:
        return (
            f"host_cores={cores} ≤ 2 — the span collector time-slices the "
            "pipeline's only cores, so the off/on delta measures core "
            "contention, not the trace spine's cost"
        )
    return None


def verify_autotune_gate_skip_reason(obj: dict) -> "str | None":
    """Why the chosen-lane-never-loses gate does NOT apply (None when it
    does). The gate is host-shape independent — the autotuner's contract
    is precisely to be correct per host — so the only skip is an
    artifact predating the autotuned keys."""
    if (
        "verify_tuned_speedup" not in obj
        and "verify_autotune_scalar_only" not in obj
    ):
        return "artifact predates the verify-lane autotuner"
    return None


def backfill_gate_skip_reason(obj: dict) -> "str | None":
    """Why the progress + streaming backfill gate does NOT apply (None
    when it does). Epoch throughput and first-chunk-before-completion are
    accounting over the engine's own clock — host-shape independent — so
    the only skip is an artifact predating the backfill leg."""
    if (
        "backfill_epochs_per_sec" not in obj
        and "backfill_ttfc_ms" not in obj
    ):
        return "artifact predates the backfill leg"
    return None


def zerocopy_gate_skip_reason(obj: dict) -> "str | None":
    """Why the copied-bytes==0 zero-copy gate does NOT apply (None when
    it does). The gate is pure accounting over the stream writer's own
    counters — host-shape independent — so the only skip is an artifact
    predating the zerocopy leg."""
    if (
        "warm_block_bytes_copied_per_resp" not in obj
        and "stream_ttfb_ms" not in obj
    ):
        return "artifact predates the zerocopy leg"
    return None


def qos_gate_skip_reason(obj: dict) -> "str | None":
    """Why the light-tenant-tail fairness gate does NOT apply (None when
    it does). Bounding the tail needs spare cores: on ≤2-core hosts the
    heavy tenant's closed-loop threads time-slice the light tenant's
    only cores, so the measured p99 reflects core contention, not queue
    ordering. Callers print the reason so a skipped gate is visible,
    never silent."""
    if "qos_light_tenant_p99_ms" not in obj:
        return "artifact predates the zerocopy leg"
    cores = obj.get("host_cores")
    if not isinstance(cores, int):
        cores = obj.get("zerocopy_host_cpus")
    if not isinstance(cores, int):
        return f"host_cores={obj.get('host_cores')!r} (unknown host shape)"
    if cores <= 2:
        return (
            f"host_cores={cores} ≤ 2 — the heavy tenant's closed-loop "
            "threads time-slice the light tenant's only cores, so the "
            "measured tail is core contention, not queue ordering"
        )
    return None


def hostkill_gate_skip_reason(obj: dict) -> "str | None":
    """Why the kill-recovery / replica-repair / 2-host throughput gates do
    NOT apply (None when they do). The measurements need spare cores: on
    ≤2-core hosts the two shards, the closed-loop load clients, and the
    recovery probe all time-slice the same core, so kill_recovery_ms and
    the aggregate rate measure scheduler contention, not the failover
    plane. Callers print the reason so a skipped gate is visible, never
    silent."""
    if (
        "kill_recovery_ms" not in obj
        and "replica_repair_hit_rate" not in obj
        and "aggregate_proofs_per_sec_2host" not in obj
    ):
        return "artifact predates the hostkill leg"
    cores = obj.get("host_cores")
    if not isinstance(cores, int):
        return f"host_cores={cores!r} (unknown host shape)"
    if cores <= 2:
        return (
            f"host_cores={cores} ≤ 2 — the shards, load clients, and "
            "recovery probe time-slice the same core, so the clock "
            "measures contention, not the failover plane"
        )
    return None


def registry_gate_skip_reason(obj: dict) -> "str | None":
    """Why the append-overhead / fleet-directory gates do NOT apply (None
    when they do). Both are same-host ratios (append cost over request
    cost; hit counting over scattered lookups) — host-shape independent —
    so the only skip is an artifact predating the registry leg."""
    if (
        "registry_append_overhead_pct" not in obj
        and "fleet_delta_hit_rate" not in obj
    ):
        return "artifact predates the registry leg"
    return None


def overload_gate_skip_reason(obj: dict) -> "str | None":
    """Why the goodput-at-2× gate does NOT apply (None when it does).
    The ratio needs spare cores: on ≤2-core hosts the 2× closed-loop
    clients time-slice the server's only cores, so the measured goodput
    collapse is scheduler contention, not admission control. Callers
    print the reason so a skipped gate is visible, never silent."""
    if "goodput_ratio_at_2x" not in obj and "shed_rate" not in obj:
        return "artifact predates the overload leg"
    cores = obj.get("host_cores")
    if not isinstance(cores, int):
        cores = obj.get("overload_host_cpus")
    if not isinstance(cores, int):
        return f"host_cores={obj.get('host_cores')!r} (unknown host shape)"
    if cores <= 2:
        return (
            f"host_cores={cores} ≤ 2 — the 2× closed-loop clients "
            "time-slice the server's only cores, so the goodput ratio "
            "measures scheduler contention, not admission control"
        )
    return None


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("artifacts", nargs="+", help="BENCH_*.json files")
    parser.add_argument(
        "--require-current",
        action="store_true",
        help="demand the full present-day key set (newest artifact only)",
    )
    args = parser.parse_args(argv)
    rc = 0
    for path in args.artifacts:
        try:
            with open(path) as fh:
                obj = json.load(fh)
        except (OSError, ValueError) as exc:
            print(f"{path}: UNREADABLE ({exc})")
            rc = 1
            continue
        problems = check_artifact(obj, require_current=args.require_current)
        if args.require_current:
            reason = speedup_gate_skip_reason(obj)
            if reason is not None:
                print(f"{path}: speedup gate SKIPPED ({reason})")
            reason = cluster_gate_skip_reason(obj)
            if reason is not None:
                print(f"{path}: cluster gate SKIPPED ({reason})")
            reason = asyncfetch_gate_skip_reason(obj)
            if reason is not None:
                print(f"{path}: asyncfetch gate SKIPPED ({reason})")
            reason = onchip_gate_skip_reason(obj)
            if reason is not None:
                print(f"{path}: onchip gate SKIPPED ({reason})")
            reason = witnessdiet_gate_skip_reason(obj)
            if reason is not None:
                print(f"{path}: witness-diet gate SKIPPED ({reason})")
            reason = fleetobs_gate_skip_reason(obj)
            if reason is not None:
                print(f"{path}: fleetobs gate SKIPPED ({reason})")
            reason = standing_gate_skip_reason(obj)
            if reason is not None:
                print(f"{path}: standing gate SKIPPED ({reason})")
            reason = trace_gate_skip_reason(obj)
            if reason is not None:
                print(f"{path}: trace gate SKIPPED ({reason})")
            reason = verify_autotune_gate_skip_reason(obj)
            if reason is not None:
                print(f"{path}: verify-autotune gate SKIPPED ({reason})")
            reason = backfill_gate_skip_reason(obj)
            if reason is not None:
                print(f"{path}: backfill gate SKIPPED ({reason})")
            reason = zerocopy_gate_skip_reason(obj)
            if reason is not None:
                print(f"{path}: zerocopy gate SKIPPED ({reason})")
            reason = qos_gate_skip_reason(obj)
            if reason is not None:
                print(f"{path}: qos gate SKIPPED ({reason})")
            reason = hostkill_gate_skip_reason(obj)
            if reason is not None:
                print(f"{path}: hostkill gate SKIPPED ({reason})")
            reason = overload_gate_skip_reason(obj)
            if reason is not None:
                print(f"{path}: overload gate SKIPPED ({reason})")
            reason = registry_gate_skip_reason(obj)
            if reason is not None:
                print(f"{path}: registry gate SKIPPED ({reason})")
        if problems:
            rc = 1
            print(f"{path}: {len(problems)} problem(s)")
            for p in problems:
                print(f"  - {p}")
        else:
            print(f"{path}: ok")
    return rc


if __name__ == "__main__":
    sys.exit(main())
