#!/usr/bin/env python
"""The repo's bench on the card: the PyTorch/CUDA port of ``bench.py``.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...}

The same legs, keys and command line as ``bench.py``, each leg driving the
port's counterpart of what the reference leg drives (``ipc_proofs_tpu_torch``
in place of ``ipc_proofs_tpu``). The headline is END-TO-END event proofs
over a 4096-tipset-pair synthetic range (~1 % receipt match rate) on one
H100 —

  generate:  Phase A host scan (native C walker over receipts/events AMTs)
             → Phase B match (fused into the C walk, or the fingerprint
               mask on the card)
             → Phase C pass-2 witness recording (host)
             → Phase D merged witness materialization
  verify:    batched witness-CID recompute (blake2b-256 CUDA kernels on
             the card) → offline replay of every proof (grouped batch
             verifier, its TxMeta CIDs recomputed on the card)

The e2e number includes every host decode, device transfer, and readback a
real user pays (the kernels built and warmed by a pass at the same
shapes). ``vs_baseline`` compares against the reference architecture — a
single-thread scalar decode+match+record+verify over the same world,
measured in-process on a subrange and scaled; ``vs_native_baseline``
against the same architecture on compiled primitives. Both baselines are
host-only by design: they run on a host engine defined in this file (the
port's C scanner and dag-cbor, hashlib's C blake2b-256 and keccak-256 from
``core/hashes.py``), never on the card and never on the kernels' plain
PyTorch versions, which would make a slow baseline.

Watchdog structure: the default invocation runs as an ORCHESTRATOR — every
measurement leg executes in its own subprocess (``--leg NAME``) under a
timeout (``_LEG_TIMEOUTS``, the reference's budgets), so a stalled or
crashed leg costs one leg, not the artifact. Unlike the reference, nothing
moves to the CPU: a leg that stalls or fails on the card keeps its status
(``timeout:cuda`` / ``error:cuda``), its keys are nulled, the artifact line
is still printed, and the process then exits non-zero. ``--platform auto``
(the default) probes the card (`utils.platform.pick_platform`) and raises
when there is none; the CPU runs only under ``--platform cpu``, where every
leg runs the kernels' plain versions on the host and reports ``cpu``.

Every leg reports the platform it ran on (``_platform``: ``cuda``, or
``cpu`` under ``--platform cpu``) and logs its kernel launches
(``bench: kernel launches {...}``) to stderr. Extra diagnostics go to
stderr; stdout carries exactly the one JSON line. Run it on the card as
``python bench_torch.py``, one leg as ``python bench_torch.py --leg e2e``.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time


def _log(*args):
    print(*args, file=sys.stderr, flush=True)


SIG = "NewTopDownMessage(bytes32,uint256)"
TOPIC1 = "calib-subnet-1"
ACTOR = 1001

LEGS = (
    "e2e", "kernel", "cid", "baseline", "native_baseline", "serve",
    "witness", "resilience", "durability", "observability", "storage",
    "asyncfetch", "cluster", "standing", "fleetobs", "onchip", "backfill",
    "zerocopy", "hostkill", "overload", "registry",
)

# per-leg watchdog timeouts in seconds: (full, quick) — the reference's
# budgets, kept as they are (a leg that needs more is a finding, not a
# larger number).
_LEG_TIMEOUTS = {
    "e2e": (480.0, 240.0),
    "kernel": (330.0, 180.0),
    "cid": (480.0, 240.0),
    "baseline": (900.0, 420.0),
    "native_baseline": (420.0, 240.0),
    "serve": (300.0, 150.0),
    "witness": (300.0, 150.0),
    "resilience": (300.0, 150.0),
    "durability": (300.0, 150.0),
    "observability": (300.0, 150.0),
    "storage": (300.0, 150.0),
    "asyncfetch": (300.0, 150.0),
    "cluster": (420.0, 240.0),
    "standing": (420.0, 240.0),
    "fleetobs": (420.0, 240.0),
    "onchip": (480.0, 240.0),
    "backfill": (420.0, 240.0),
    "zerocopy": (420.0, 240.0),
    "hostkill": (420.0, 240.0),
    "overload": (300.0, 150.0),
    "registry": (300.0, 150.0),
}


def _parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--platform", default="auto", help="auto|cuda|cpu (auto: the card, or fail)")
    parser.add_argument("--tipsets", type=int, default=4096, help="tipset pairs in the range")
    parser.add_argument("--receipts", type=int, default=16)
    parser.add_argument("--events", type=int, default=4)
    parser.add_argument("--match-rate", type=float, default=0.01)
    parser.add_argument(
        "--kernel-iters", type=int, default=20,
        help="lower bound for the secondary kernel-slope loop (full runs "
        "floor it at 105 passes; --quick floors at 13)",
    )
    parser.add_argument("--baseline-pairs", type=int, default=128,
                        help="subrange size for the scalar baseline measurement")
    parser.add_argument(
        "--e2e-reps", type=int, default=5,
        help="measured e2e passes; the headline is the best (--quick uses 3)",
    )
    parser.add_argument(
        "--threads", type=int, default=None,
        help="ONE thread budget for the e2e leg's range engine, partitioned "
        "over scan/record/verify workers + native scan fan-out "
        "(default: the process affinity core count)",
    )
    parser.add_argument(
        "--scan-threads", type=int, default=None,
        help="legacy: pin the e2e pipeline's scan+match worker count",
    )
    parser.add_argument(
        "--pipeline-depth", type=int, default=2,
        help="chunks buffered between the e2e pipeline's stages",
    )
    parser.add_argument(
        "--serve-requests", type=int, default=256,
        help="closed-loop requests for the serve leg (--quick uses 96)",
    )
    parser.add_argument(
        "--serve-concurrency", type=int, default=32,
        help="client threads for the serve leg's closed loop",
    )
    parser.add_argument(
        "--probe-timeout", type=float, default=150.0,
        help="per-attempt card-probe timeout (the reference's); 3 retried "
        "attempts, then the bench fails (no CPU fallback)",
    )
    parser.add_argument(
        "--cluster-pairs", type=int, default=16,
        help="demo-world pairs for the cluster leg (--quick uses 8)",
    )
    parser.add_argument(
        "--cluster-requests", type=int, default=64,
        help="closed-loop generate requests per shard-count in the cluster "
        "leg (--quick uses 32)",
    )
    parser.add_argument("--quick", action="store_true", help="small shapes for smoke runs")
    parser.add_argument(
        "--profile", default=None, metavar="DIR",
        help="write a torch.profiler Chrome trace of one measured e2e pass into DIR",
    )
    parser.add_argument(
        "--leg", default=None, choices=LEGS,
        help="run ONE measurement leg in this process and print its partial "
        "JSON (internal: the orchestrator spawns these under watchdogs)",
    )
    parser.add_argument(
        "--leg-timeout-mult", type=float,
        default=float(os.environ.get("IPC_BENCH_LEG_TIMEOUT_MULT", "1.0")),
        help="scale every per-leg watchdog timeout",
    )
    args = parser.parse_args(argv)
    if args.quick:
        args.tipsets = min(args.tipsets, 256)
        args.baseline_pairs = min(args.baseline_pairs, 32)
        args.kernel_iters = min(args.kernel_iters, 5)
        args.serve_requests = min(args.serve_requests, 96)
    return args


def _setup_platform(args) -> str:
    """Resolve the platform for THIS process; returns 'cuda' (the card) or
    'cpu' (asked for by name). 'cuda' without a card raises: the leg fails
    rather than run its numbers on the CPU."""
    from ipc_proofs_tpu_torch.utils.platform import pick_platform

    platform = pick_platform(args.platform, args.probe_timeout, log=_log)
    import torch

    if platform == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("bench: the card was asked for, and torch sees no CUDA device")
        _log(f"bench: devices = {torch.cuda.device_count()} × {torch.cuda.get_device_name(0)}")
    else:
        _log("bench: devices = cpu (the kernels' plain versions)")
    return platform


def _device(platform: str):
    """The port's ``device`` argument for a platform: None (the card, every
    entry point's default) or "cpu"."""
    return None if platform == "cuda" else "cpu"


def _backend(platform: str):
    """The backend every engine of a leg launches on: the card's, or the
    plain versions on the CPU under ``--platform cpu``."""
    from ipc_proofs_tpu_torch.backend import get_backend

    return get_backend("gpu", device=_device(platform))


def _device_count(platform: str) -> int:
    import torch

    return torch.cuda.device_count() if platform == "cuda" else 1


def _mesh_devices(platform: str, n: int):
    """``make_mesh``'s devices: None (every card) or ``n`` CPU devices."""
    import torch

    return None if platform == "cuda" else [torch.device("cpu")] * n


def _launch_counts() -> "dict[str, int]":
    """Every kernel wrapper's launch count in this process (each counts
    where it launches its kernel on the card, and nowhere else), with the
    device match functions'."""
    from ipc_proofs_tpu_torch.ops import blake2b, keccak, match
    from ipc_proofs_tpu_torch.parallel import pipeline

    return dict(blake2b.LAUNCHES, **keccak.LAUNCHES, **match.LAUNCHES, **pipeline.LAUNCHES)


# --------------------------------------------------------------------------
# measurement legs (each runnable standalone via --leg NAME)
# --------------------------------------------------------------------------


def _leg_e2e(args) -> dict:
    """The headline: best-of-n end-to-end generate+verify at the bench shape,
    measured TWICE — serial (flat generation, then staged verification) and
    stage-overlapped (scan ∥ record ∥ verify on the bounded-queue pipeline)
    — so the artifact reports the pipelined headline next to the serial
    figure and their ratio. Returns every headline JSON field except the
    baseline ratios."""
    platform = _setup_platform(args)
    import gc

    from ipc_proofs_tpu_torch.fixtures import build_range_world
    from ipc_proofs_tpu_torch.proofs.generator import EventProofSpec
    from ipc_proofs_tpu_torch.proofs.range import (
        generate_and_verify_range_overlapped,
        generate_event_proofs_for_range,
    )
    from ipc_proofs_tpu_torch.utils.metrics import Metrics

    # --- build the range world (setup, not measured) ------------------------
    t0 = time.perf_counter()
    bs, pairs, n_matching = build_range_world(
        args.tipsets, args.receipts, args.events, args.match_rate
    )
    total_events = args.tipsets * args.receipts * args.events
    _log(
        f"bench: world [{args.tipsets} pairs × {args.receipts} rcpt × "
        f"{args.events} ev] = {total_events} events, {n_matching} matching "
        f"receipts, built in {time.perf_counter() - t0:.1f}s"
    )

    spec = EventProofSpec(event_signature=SIG, topic_1=TOPIC1, actor_id_filter=ACTOR)
    backend = _backend(platform)

    # honest host introspection: cpu_count is the machine; the affinity mask
    # is what THIS process may actually use (containers/cgroups shrink it)
    host_cores = os.cpu_count() or 1
    host_cores_affinity = (
        len(os.sched_getaffinity(0))
        if hasattr(os, "sched_getaffinity")
        else host_cores
    )
    # the bench resolves the SAME budget the drivers would and passes the
    # split explicitly, so the artifact records the real parallelism
    from ipc_proofs_tpu_torch.utils.threads import resolve_thread_budget

    budget = resolve_thread_budget(
        threads=args.threads, scan_threads=args.scan_threads
    )
    scan_threads = budget.scan_workers
    pipeline_depth = max(1, args.pipeline_depth)
    # pipelined chunking: enough chunks in flight to feed every scan worker
    # plus the queue depth, floored so tiny worlds still form a pipeline
    pipe_chunk = max(1, min(1024, len(pairs) // max(4, 2 * scan_threads)))
    # IPC_BENCH_OVERLAP_VERIFY=0 is the escape hatch back to serial-only
    measure_pipelined = os.environ.get("IPC_BENCH_OVERLAP_VERIFY", "") != "0"

    def _run_serial(metrics):
        t0 = time.perf_counter()
        bundle = generate_event_proofs_for_range(
            bs, pairs, spec, match_backend=backend, metrics=metrics
        )
        t_gen = time.perf_counter() - t0
        results, vstages = _staged_verify(bundle, backend)
        assert all(results) and len(results) == len(bundle.event_proofs)
        return bundle, t_gen, sum(vstages.values()), vstages

    def _run_pipelined(metrics):
        # scan (scan_threads workers) ∥ record ∥ verify in ONE bounded-queue
        # executor; bundle + verdicts bit-identical to serial (tests pin it)
        t0 = time.perf_counter()
        bundle, chunk_out = generate_and_verify_range_overlapped(
            bs, pairs, spec, chunk_size=pipe_chunk,
            verify_chunk=lambda b: _staged_verify(b, backend),
            match_backend=backend, metrics=metrics,
            scan_threads=scan_threads, pipeline_depth=pipeline_depth,
            record_workers=budget.record_workers,
            verify_workers=budget.verify_workers,
            threads=args.threads,
        )
        t_wall = time.perf_counter() - t0
        results = [r for res, _ in chunk_out for r in res]
        assert all(results) and len(results) == len(bundle.event_proofs)
        vstages: dict = {}
        for _, chunk_stages in chunk_out:
            for name, seconds in chunk_stages.items():
                vstages[name] = vstages.get(name, 0.0) + seconds
        return bundle, t_wall, sum(vstages.values()), vstages

    # --- warmup: build and load every kernel at BOTH measurement shapes -----
    # (the flat driver verifies one range-sized batch; the pipelined driver
    # pipe_chunk-sized batches). The second pipelined pass settles the
    # caching allocator's pools at the headline shape so the measured reps
    # sample the plateau, not the ramp.
    t0 = time.perf_counter()
    _run_serial(Metrics())
    _log(f"bench: serial warmup (incl. kernel build) {time.perf_counter() - t0:.1f}s")
    if measure_pipelined:
        t0 = time.perf_counter()
        _run_pipelined(Metrics())
        _run_pipelined(Metrics())
        _log(f"bench: pipelined warmup ×2 {time.perf_counter() - t0:.1f}s")

    # optional profiler trace of one representative pass (not measured)
    if args.profile:
        from ipc_proofs_tpu_torch.utils.profiling import maybe_profile

        with maybe_profile(args.profile):
            if measure_pipelined:
                _run_pipelined(Metrics())
            else:
                _run_serial(Metrics())

    # --- measured end-to-end passes (best of n — steady state, GC settled) --
    n_reps = 3 if args.quick else args.e2e_reps

    def _measure(run) -> tuple:
        best = None
        walls: list[float] = []
        for _ in range(n_reps):
            gc.collect()
            metrics = Metrics()
            bundle, t_wall, t_verify, vstages = run(metrics)
            walls.append(t_wall)
            if best is None or t_wall < best[0]:
                best = (t_wall, t_verify, bundle, metrics, vstages)
        return best, walls

    serial_best, serial_walls = _measure(_run_serial)
    pipe_best, pipe_walls = (None, [])
    if measure_pipelined:
        pipe_best, pipe_walls = _measure(_run_pipelined)

    # headline = the pipelined pipeline when measured (the serial figure
    # rides along for the speedup ratio); serial otherwise
    t_e2e, t_verify, bundle, metrics, vstages = pipe_best or serial_best
    rep_walls = pipe_walls or serial_walls
    n_proofs = len(bundle.event_proofs)
    serial_wall = serial_best[0]

    # NOTE: under the pipelined engine stages overlap across worker threads,
    # so busy sums (stages_ms) can exceed the e2e wall; stages_wall_ms is
    # each stage's interval-union wall — the honest per-stage clock. e2e
    # rates always divide by the measured WALL.
    snap = metrics.snapshot()
    gtimers = snap["timers"]
    stages = {
        "scan": gtimers.get("range_scan", {}).get("total_s", 0.0),
        "match": gtimers.get("range_match", {}).get("total_s", 0.0),
        "record": gtimers.get("range_record", {}).get("total_s", 0.0),
        **vstages,
    }
    stages_wall = {
        name: timer["wall_s"]
        for name, timer in gtimers.items()
        if name.startswith("range_")
    }
    stage_str = " ".join(f"{k}={v * 1000:.0f}ms" for k, v in stages.items())
    proofs_per_sec = n_proofs / t_e2e
    events_per_sec = total_events / t_e2e
    serial_proofs_per_sec = n_proofs / serial_wall
    speedup = serial_wall / t_e2e if pipe_best is not None else None
    _log(
        f"bench: e2e wall {t_e2e * 1e3:.0f}ms (verify busy {t_verify * 1e3:.0f}ms "
        f"concurrent) → {n_proofs} proofs, {len(bundle.blocks)} witness blocks "
        f"({bundle.witness_bytes()} B)"
    )
    _log(f"bench: stages {stage_str}")
    _log(
        f"bench: {proofs_per_sec:,.0f} proofs/s e2e pipelined vs "
        f"{serial_proofs_per_sec:,.0f} serial"
        + (f" ({speedup:.2f}x)" if speedup else "")
    )

    # the C scanner sizes its own intra-chunk thread pool; report it next to
    # the pipeline's scan workers rather than conflating the two
    from ipc_proofs_tpu_torch.backend.native import load_scan_ext

    _scan_ext = load_scan_ext()
    native_scan_threads = (
        int(_scan_ext.scan_threads())
        if _scan_ext is not None and hasattr(_scan_ext, "scan_threads")
        else None
    )

    return {
        "metric": "event_proofs_per_sec_4k_range_e2e",
        "value": round(proofs_per_sec, 1),
        "unit": "proofs/s",
        "platform": platform,
        "devices": _device_count(platform),
        "host_cores": host_cores,
        "host_cores_affinity": host_cores_affinity,
        # the pipeline's effective per-stage worker counts for this leg,
        # plus the ONE budget they were partitioned from
        "scan_threads": scan_threads if pipe_best is not None else 1,
        "record_workers": budget.record_workers if pipe_best is not None else 1,
        "verify_workers": budget.verify_workers if pipe_best is not None else 1,
        "effective_threads": budget.total,
        "native_scan_threads": native_scan_threads,
        "pipeline_depth": pipeline_depth if pipe_best is not None else None,
        "pipeline_chunk": pipe_chunk if pipe_best is not None else len(pairs),
        "events_per_sec_e2e": round(events_per_sec, 1),
        "proofs": n_proofs,
        # busy sums can exceed the e2e wall when stages overlap;
        # stages_wall_ms is the per-stage interval-union wall
        "stages_ms": {k: round(v * 1000, 1) for k, v in stages.items()},
        "stages_wall_ms": {k: round(v * 1000, 1) for k, v in stages_wall.items()},
        "stages_overlap": pipe_best is not None,
        "gen_verify_overlap": pipe_best is not None,
        "overlap_efficiency": snap.get("overlap_efficiency"),
        # the serial figure measured in the SAME process at the same shape,
        # and the headline's ratio to it — the honest single-host speedup
        "serial_proofs_per_sec": round(serial_proofs_per_sec, 1),
        "serial_e2e_reps_s": [round(w, 4) for w in serial_walls],
        "pipeline_speedup_vs_serial": round(speedup, 3) if speedup else None,
        # measurement policy, recorded so the headline is auditable: warm
        # passes per variant, best of n_reps; every rep's wall kept for
        # honesty (the spread is the noise the 'best' is picked from)
        "e2e_policy": f"warm-bestof{n_reps}-serial+pipelined",
        "e2e_reps_s": [round(w, 4) for w in rep_walls],
        "_platform": platform,
    }


def _leg_kernel(args) -> dict:
    """The round-1 headline, kept as a secondary line: the device match
    pipeline's slope-timed throughput (`utils.timing.measure_pass_seconds`:
    one pass captured as a CUDA graph on one card and replayed k times).
    Each pass XORs ``i`` into the mesh's replicas of topic0's spec words —
    the reference XORs it into the topics, which XLA fuses into the mask;
    eager PyTorch would make that a 64-bytes-an-event pass of its own."""
    platform = _setup_platform(args)

    from ipc_proofs_tpu_torch.parallel.mesh import make_mesh
    from ipc_proofs_tpu_torch.parallel.pipeline import sharded_match_pipeline, synthetic_event_batch
    from ipc_proofs_tpu_torch.state.events import ascii_to_bytes32, hash_event_signature
    from ipc_proofs_tpu_torch.utils.timing import measure_pass_seconds

    topic0 = hash_event_signature(SIG)
    topic1 = ascii_to_bytes32(TOPIC1)
    batch = synthetic_event_batch(
        args.tipsets, args.receipts, args.events,
        topic0, topic1, emitter=ACTOR, match_rate=args.match_rate, seed=42,
    )
    n_dev = _device_count(platform)
    sp = 2 if (n_dev % 2 == 0 and n_dev > 1) else 1
    mesh = make_mesh(n_dev, sp=sp, devices=_mesh_devices(platform, n_dev))
    jitted, shard_batch = sharded_match_pipeline(mesh)
    sharded_args = shard_batch(batch, topic0, topic1, ACTOR)
    _hits, _mask, count = jitted(*sharded_args)  # build + warm

    def one_pass(i, topics, n_topics, emitters, valid, s0, s1, actor):
        spec0 = tuple(t ^ i.to(t.device) for t in s0)
        _, _, c = jitted(topics, n_topics, emitters, valid, spec0, s1, actor)
        return c

    if args.quick:
        k_small, k_large = 3, max(args.kernel_iters, 13)
    else:
        k_small, k_large = 5, max(args.kernel_iters, 105)
    pt = measure_pass_seconds(one_pass, sharded_args, k_small=k_small, k_large=k_large)
    total_events = args.tipsets * args.receipts * args.events
    rate = total_events / pt.seconds
    _log(
        f"bench: device mask kernel (slope k={pt.k_small}/{pt.k_large}, "
        f"{'CUDA graph' if pt.graph else 'eager'}): "
        f"{pt.seconds * 1e6:.1f} us/pass, {rate:,.0f} events/s "
        f"({int(count)} matches/pass)"
    )
    return {
        "device_mask_kernel_events_per_sec": round(rate, 1),
        "_platform": platform,
    }


# the cid leg's node counts: (full, quick) — the reference's
CID_NODES = (200_000, 20_000)


def _leg_cid(args) -> dict:
    """Witness-verify CIDs/sec (BASELINE config 4's kernel): blake2b-256
    over 200-byte IPLD nodes — config 4's OWN block size
    (`benchmarks/run_configs.py` config 4) — through the two-block CUDA
    kernel (`ops.cid_bench.blake2b_cid_bench_setup`), slope-timed; under
    ``--platform cpu``, the kernel's plain version on the host
    (`witness_cid_kernel` labels which kernel produced the number)."""
    platform = _setup_platform(args)
    import numpy as np

    from ipc_proofs_tpu_torch.core.hashes import blake2b_256
    from ipc_proofs_tpu_torch.ops.cid_bench import blake2b_cid_bench_setup
    from ipc_proofs_tpu_torch.utils.timing import measure_pass_seconds

    n = CID_NODES[1] if args.quick else CID_NODES[0]
    rng = np.random.default_rng(1)
    payload = rng.integers(0, 256, size=(n, 200), dtype=np.uint8)
    messages = [payload[i].tobytes() for i in range(n)]

    one_pass, fn_args, first, kernel = blake2b_cid_bench_setup(messages, device=_device(platform))
    assert first[0].astype("<u4").tobytes() == blake2b_256(messages[0])
    pt = measure_pass_seconds(one_pass, fn_args, k_small=3, k_large=13 if args.quick else 23)
    rate = n / pt.seconds
    _log(
        f"bench: witness-CID recompute ({kernel} kernel, slope "
        f"k={pt.k_small}/{pt.k_large}): {rate:,.0f} CIDs/s"
    )
    return {
        "witness_cid_kernel_per_sec": round(rate, 1),
        "witness_cid_kernel": kernel,
        "_platform": platform,
    }


def _leg_baseline(args) -> dict:
    """Scalar reference-architecture baseline (host-only by design: the
    host engine `_HostHashes`, never the card)."""
    platform = _setup_platform(args)
    t0 = time.perf_counter()
    baseline = _scalar_baseline(
        min(args.baseline_pairs, args.tipsets), args.receipts, args.events
    )
    _log(
        f"bench: scalar reference-architecture baseline ≈ {baseline:,.1f} "
        f"proofs/s e2e (measured in {time.perf_counter() - t0:.1f}s)"
    )
    return {"scalar_baseline_proofs_per_sec": round(baseline, 1), "_platform": platform}


def _leg_native_baseline(args) -> dict:
    """Language-fair native baseline (host-only by design: the host engine
    `_HostHashes`, never the card)."""
    platform = _setup_platform(args)
    t0 = time.perf_counter()
    native_baseline = _native_baseline(
        min(args.baseline_pairs, args.tipsets), args.receipts, args.events
    )
    _log(
        f"bench: native (C-primitive, per-pair) reference-architecture "
        f"baseline ≈ {native_baseline:,.1f} proofs/s e2e "
        f"(measured in {time.perf_counter() - t0:.1f}s)"
    )
    return {"native_baseline_proofs_per_sec": round(native_baseline, 1), "_platform": platform}


def _leg_serve(args) -> dict:
    """Closed-loop load test of the serving daemon (hermetic, its TxMeta
    recomputes on the card): micro-batched throughput through
    `serve.ProofService` vs the same requests verified per-request
    sequentially. Each request is a single-proof bundle over a shared
    synthetic chain — the shape an individual client actually sends — so
    the measured win is exactly the coalescing (shared witness load +
    grouped replay across requests)."""
    platform = _setup_platform(args)
    import threading

    from ipc_proofs_tpu_torch.fixtures import ContractFixture, EventFixture, build_chain
    from ipc_proofs_tpu_torch.proofs.bundle import UnifiedProofBundle
    from ipc_proofs_tpu_torch.proofs.generator import (
        EventProofSpec,
        StorageProofSpec,
        generate_proof_bundle,
    )
    from ipc_proofs_tpu_torch.serve import ProofService, ServiceConfig
    from ipc_proofs_tpu_torch.state.storage import calculate_storage_slot

    slot = calculate_storage_slot(TOPIC1, 0)
    # enough messages that the shared group work (exec-order reconstruction,
    # witness load, header decodes) dominates per-proof replay — that shared
    # work is exactly what coalescing amortizes across the batch
    n_events = 384 if args.quick else 768
    world = build_chain(
        [ContractFixture(actor_id=ACTOR, storage={slot: (42).to_bytes(2, "big")})],
        [
            [EventFixture(emitter=ACTOR, signature=SIG, topic1=TOPIC1,
                          data=i.to_bytes(32, "big"))]
            for i in range(n_events)
        ],
    )
    full = generate_proof_bundle(
        world.store, world.parent, world.child,
        [StorageProofSpec(actor_id=ACTOR, slot=slot)],
        [EventProofSpec(event_signature=SIG, topic_1=TOPIC1, actor_id_filter=ACTOR)],
        match_backend=_backend(platform),
    )
    requests = [
        UnifiedProofBundle(
            storage_proofs=[], event_proofs=[full.event_proofs[i % n_events]],
            blocks=full.blocks,
        )
        for i in range(args.serve_requests)
    ]

    # --- per-request sequential comparator (one replay per request) --------
    from ipc_proofs_tpu_torch.serve import sequential_verify_baseline

    backend = _backend(platform)
    sequential_verify_baseline(requests[:4], cid_backend=backend)  # warm caches/kernels
    t0 = time.perf_counter()
    seq = sequential_verify_baseline(requests, cid_backend=backend)
    t_seq = time.perf_counter() - t0
    assert all(r.all_valid() for r in seq)
    seq_rps = len(requests) / t_seq

    # --- micro-batched closed loop at --serve-concurrency ------------------
    service = ProofService(
        store=world.store,
        config=ServiceConfig(
            max_batch=args.serve_concurrency, max_wait_ms=4.0,
            queue_capacity=max(512, 2 * args.serve_requests), workers=2,
            device=_device(platform),
        ),
    )
    it = iter(range(len(requests)))
    it_lock = threading.Lock()
    failures: list = []

    def client():
        while True:
            with it_lock:
                i = next(it, None)
            if i is None:
                return
            resp = service.verify(requests[i])
            if not resp.all_valid():
                failures.append(i)

    threads = [
        threading.Thread(target=client) for _ in range(args.serve_concurrency)
    ]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    t_batched = time.perf_counter() - t0
    assert not failures, f"serve leg: {len(failures)} requests failed verification"
    batched_rps = len(requests) / t_batched

    snap = service.metrics_snapshot()
    service.drain()
    lat = snap.get("histograms", {}).get("serve.latency_ms.verify", {})
    batch_hist = snap.get("histograms", {}).get("serve.batch_size.verify", {})
    speedup = batched_rps / seq_rps if seq_rps else None
    _log(
        f"bench: serve closed-loop c={args.serve_concurrency}: "
        f"{batched_rps:,.0f} req/s micro-batched vs {seq_rps:,.0f} req/s "
        f"per-request sequential ({speedup:.2f}×); p99 "
        f"{lat.get('p99', float('nan')):.1f}ms, mean batch "
        f"{batch_hist.get('mean', float('nan')):.1f}"
    )
    return {
        "serve_batched_rps": round(batched_rps, 1),
        "serve_sequential_rps": round(seq_rps, 1),
        "serve_speedup_vs_sequential": round(speedup, 2) if speedup else None,
        "serve_concurrency": args.serve_concurrency,
        "serve_requests": len(requests),
        "serve_p99_latency_ms": lat.get("p99"),
        "serve_mean_batch": round(batch_hist.get("mean", 0.0), 2),
        "serve_rejections": sum(
            v for k, v in snap.get("counters", {}).items()
            if k.startswith("serve.rejected")
        ),
        "_platform": platform,
    }


def _leg_witness(args) -> dict:
    """Substantiate the witness savings: the two-pass vs single-pass
    recording win (BASELINE ~60 % row), plus the witness-diet layers —
    bytes/proof under cross-request aggregation at K ∈ {1, 16, 256},
    the consecutive-epoch delta ratio, and the zlib framing ratio."""
    platform = _setup_platform(args)
    backend = _backend(platform)
    from ipc_proofs_tpu_torch.fixtures import build_range_world
    from ipc_proofs_tpu_torch.proofs.event_generator import single_pass_witness_cids
    from ipc_proofs_tpu_torch.proofs.generator import EventProofSpec
    from ipc_proofs_tpu_torch.proofs.range import generate_event_proofs_for_range

    n = min(64, args.tipsets)
    bs, pairs, _ = build_range_world(
        n, args.receipts, args.events, args.match_rate, base_height=30_000_000
    )
    spec = EventProofSpec(event_signature=SIG, topic_1=TOPIC1, actor_id_filter=ACTOR)
    bundle = generate_event_proofs_for_range(bs, pairs, spec, match_backend=backend)
    two_pass_bytes = bundle.witness_bytes()

    needed = set()
    for pair in pairs:
        needed |= single_pass_witness_cids(bs, pair.parent, pair.child)
    single_pass_bytes = 0
    for cid in needed:
        raw = bs.get(cid)
        if raw is not None:
            single_pass_bytes += len(raw)

    pct = 100.0 * (1.0 - two_pass_bytes / single_pass_bytes)
    _log(
        f"bench: witness ({n} pairs): two-pass {two_pass_bytes:,} B vs "
        f"single-pass {single_pass_bytes:,} B → {pct:.1f}% reduction"
    )

    # --- the witness diet (ROADMAP item 1) ---------------------------------
    # the diet layers need non-trivial bundles: at the sparse default
    # --match-rate most single-pair bundles are empty, so measure on a
    # small match-dense world (same shape knobs, floor on the match rate)
    import base64

    from ipc_proofs_tpu_torch.witness import (
        aggregate_range_bundle,
        compress_blocks,
        pack_blocks,
    )
    from ipc_proofs_tpu_torch.witness.delta import encode_delta

    def wire_bytes(obj) -> int:
        return len(json.dumps(obj, sort_keys=True, separators=(",", ":")))

    diet_n = 8
    dbs, dpairs, _ = build_range_world(
        diet_n, args.receipts, args.events, max(args.match_rate, 0.5),
        base_height=30_000_000,
    )

    # aggregation: wire bytes per claim at K co-tipset claims — the claim
    # table maps repeated claims onto shared spans, so the witness (and the
    # proofs) serialize once no matter how many claims reference them
    distinct_n = 4
    solo = generate_event_proofs_for_range(dbs, dpairs[:1], spec, match_backend=backend)
    distinct = generate_event_proofs_for_range(dbs, dpairs[:distinct_n], spec, match_backend=backend)
    bytes_per_proof = {}
    for k in (1, 16, 256):
        d = min(distinct_n, k)
        bundle_k = solo if d == 1 else distinct
        agg = aggregate_range_bundle(
            bundle_k, dpairs, list(range(d)),
            claim_indexes=[i % d for i in range(k)],
        )
        total = wire_bytes(
            {"bundle": bundle_k.to_json_obj(), "claims": agg.claims_json()}
        )
        bytes_per_proof[k] = round(total / k, 1)

    # delta witnesses: epoch N+1 shipped against the client's acked
    # epoch-N base — a range subscriber's base grows one tipset per
    # epoch, so the delta re-ships the (small) proofs but only the new
    # tipset's witness blocks
    prefix = [
        generate_event_proofs_for_range(dbs, dpairs[: i + 1], spec, match_backend=backend)
        for i in range(diet_n)
    ]
    ratios = []
    for base, nxt in zip(prefix, prefix[1:]):
        dobj = encode_delta(nxt, base.cid_set(), base.digest())
        ratios.append(
            wire_bytes({"bundle_delta": dobj})
            / wire_bytes({"bundle": nxt.to_json_obj()})
        )
    delta_ratio = sum(ratios) / len(ratios)

    # compressed framing: zlib frame over the canonical CID ordering
    frame = compress_blocks(distinct.blocks, "zlib")
    compressed_ratio = len(base64.b64decode(frame["frame"])) / len(
        pack_blocks(distinct.blocks)
    )

    _log(
        f"bench: witness diet: {bytes_per_proof[1]:,.0f} B/proof at K=1 → "
        f"{bytes_per_proof[16]:,.0f} at K=16 → {bytes_per_proof[256]:,.0f} "
        f"at K=256; delta ratio {delta_ratio:.3f} "
        f"({len(ratios)} consecutive epochs), zlib ratio {compressed_ratio:.3f}"
    )
    return {
        "witness_reduction_pct": round(pct, 1),
        "witness_two_pass_bytes": two_pass_bytes,
        "witness_single_pass_bytes": single_pass_bytes,
        "witness_sample_pairs": n,
        "witness_bytes_per_proof_k1": bytes_per_proof[1],
        "witness_bytes_per_proof_k16": bytes_per_proof[16],
        "witness_bytes_per_proof_k256": bytes_per_proof[256],
        "witness_delta_ratio": round(delta_ratio, 4),
        "witness_compressed_ratio": round(compressed_ratio, 4),
        "_platform": platform,
    }


def _leg_resilience(args) -> dict:
    """Fault-tolerance measurements (hermetic): range-proof
    throughput through the full failover client stack — `LotusClient`
    (retries) → `EndpointPool` (breakers, integrity verification) →
    `RpcBlockstore` — against in-process Lotus sessions, three ways:

    - fault-free, integrity checks ON (the production configuration);
    - fault-free, integrity checks OFF (isolates the multihash-recompute
      overhead → ``integrity_overhead_pct``);
    - under a seeded 10 % injected fault rate with two endpoints
      (``proofs_per_sec_at_fault_rate`` — what resilience costs when the
      chain actually misbehaves);

    plus ``recovery_ms``: wall time for a block read to fail over from a
    dead primary to a healthy secondary, breaker included. The range
    driver's match and the pool's batch lane run on the card."""
    platform = _setup_platform(args)
    backend = _backend(platform)
    import gc
    import random as _random

    from ipc_proofs_tpu_torch.fixtures import build_range_world
    from ipc_proofs_tpu_torch.proofs.generator import EventProofSpec
    from ipc_proofs_tpu_torch.proofs.range import generate_event_proofs_for_range_pipelined
    from ipc_proofs_tpu_torch.store.failover import EndpointPool
    from ipc_proofs_tpu_torch.store.faults import FaultPlan, FaultySession, LocalLotusSession
    from ipc_proofs_tpu_torch.store.rpc import LotusClient, RpcBlockstore
    from ipc_proofs_tpu_torch.utils.metrics import Metrics

    n_pairs = 16 if args.quick else 48
    bs, pairs, _ = build_range_world(
        n_pairs, args.receipts, args.events, 0.05,
        signature=SIG, topic1=TOPIC1, actor_id=ACTOR, base_height=40_000_000,
    )
    spec = EventProofSpec(event_signature=SIG, topic_1=TOPIC1, actor_id_filter=ACTOR)

    def _client(session, seed=0, **kw):
        kw.setdefault("max_retries", 3)
        return LotusClient(
            "http://bench-resilience", session=session,
            backoff_base_s=0.0005, backoff_max_s=0.002,
            rng=_random.Random(seed), **kw,
        )

    def _run(store, metrics=None):
        t0 = time.perf_counter()
        bundle = generate_event_proofs_for_range_pipelined(
            store, pairs, spec, chunk_size=8, metrics=metrics,
            scan_threads=1, scan_retries=2, force_pipeline=True,
            match_backend=backend,
        )
        return bundle, time.perf_counter() - t0

    def _best_of(store, reps=2):
        best = None
        for _ in range(reps):
            gc.collect()
            bundle, wall = _run(store)
            if best is None or wall < best[1]:
                best = (bundle, wall)
        return best

    # --- fault-free, integrity verification ON (production config) ----------
    verified_store = RpcBlockstore(_client(LocalLotusSession(bs)))
    _run(verified_store)  # warm (kernel build, extension load)
    bundle, t_verified = _best_of(verified_store)
    n_proofs = len(bundle.event_proofs)
    fault_free_rate = n_proofs / t_verified

    # --- fault-free, integrity verification OFF ------------------------------
    # the "pool already verifies" escape hatch doubles as the counterfactual:
    # same stack, multihash recompute skipped
    unverified_client = _client(LocalLotusSession(bs))
    unverified_client.verifies_integrity = True
    _, t_unverified = _best_of(RpcBlockstore(unverified_client))
    overhead_pct = 100.0 * (t_verified - t_unverified) / t_unverified

    # --- throughput at a 10 % injected fault rate ----------------------------
    # two faulty endpoints behind the pool; a typed abort (fault schedule too
    # hostile for the retry budget) just moves to the next seed — the metric
    # is the throughput of a run that SURVIVES faults, and seeds are fixed so
    # the artifact is reproducible
    fault_rate = 0.1
    faulted_rate = None
    faulted_metrics = Metrics()
    for seed in range(10):
        clients = [
            _client(
                FaultySession(
                    LocalLotusSession(bs),
                    FaultPlan(seed * 101 + i, fault_rate=fault_rate),
                    sleep=lambda s: None,
                ),
                seed=seed + i,
                metrics=faulted_metrics,
            )
            for i in range(2)
        ]
        pool = EndpointPool(
            clients, breaker_threshold=3, breaker_reset_s=0.05,
            metrics=faulted_metrics, backend=backend,
        )
        try:
            fb, wall = _run(RpcBlockstore(pool, metrics=faulted_metrics))
        except (RuntimeError, ConnectionError, TimeoutError, OSError):
            continue
        finally:
            pool.close()
        assert fb.to_json() == bundle.to_json(), "faulted bundle diverged"
        faulted_rate = len(fb.event_proofs) / wall
        break

    # --- failover recovery latency ------------------------------------------
    # dead primary (every post raises), healthy secondary; fresh pool per rep
    # so each measurement starts with a closed breaker
    class _DeadSession:
        def post(self, url, json=None, timeout=None, headers=None):
            raise ConnectionError("dead endpoint")

    probe_cid = bundle.blocks[0].cid
    recovery_s = float("inf")
    for rep in range(5):
        dead = _client(_DeadSession(), seed=rep, max_retries=1)
        healthy = _client(LocalLotusSession(bs), seed=rep)
        pool = EndpointPool([dead, healthy], breaker_threshold=1, backend=backend)
        # pin the dead endpoint as the routed-first candidate so the rep
        # really measures detect + fail over, not a lucky healthy-first pick
        pool._endpoints[0].score = 2.0
        t0 = time.perf_counter()
        data = pool.chain_read_obj(probe_cid)
        recovery_s = min(recovery_s, time.perf_counter() - t0)
        assert data == bundle.blocks[0].data
        pool.close()

    counters = faulted_metrics.snapshot()["counters"]
    _log(
        f"bench: resilience ({n_pairs} pairs): {fault_free_rate:,.1f} proofs/s "
        f"fault-free verified (integrity overhead {overhead_pct:.1f}%), "
        + (f"{faulted_rate:,.1f} proofs/s at {fault_rate:.0%} faults"
           if faulted_rate else f"no surviving run at {fault_rate:.0%} faults")
        + f", recovery {recovery_s * 1000:.2f}ms "
        f"(retries={counters.get('rpc.retries', 0)}, "
        f"integrity_failures={counters.get('rpc.integrity_failures', 0)})"
    )
    return {
        "resilience_fault_free_proofs_per_sec": round(fault_free_rate, 1),
        "integrity_overhead_pct": round(overhead_pct, 2),
        "proofs_per_sec_at_fault_rate": (
            round(faulted_rate, 1) if faulted_rate else None
        ),
        "resilience_fault_rate": fault_rate,
        "recovery_ms": round(recovery_s * 1000, 3),
        "_platform": platform,
    }


def _leg_durability(args) -> dict:
    """Durability measurements (hermetic): what the write-ahead
    job journal (`ipc_proofs_tpu_torch/jobs/`) costs and buys on the pipelined
    range driver:

    - ``durability_journal_overhead_pct`` — the journal's attributable
      cost (``jobs.commit_us``: thread-CPU time of serialize + checksum +
      write + fsync per committed chunk, timed where it happens) as a
      share of the un-journaled run's wall clock. Direct attribution, not
      wall-clock subtraction: the commit work runs in the pipeline's
      record stage and largely overlaps the scan of the next chunk, so
      subtracting two ~0.5 s runs is dominated by scheduler noise on
      shared hosts (observed ±8 % swings either sign) while the commit
      CPU time is stable. CPU-time attribution is an *upper bound* on the
      added critical path: it counts every cycle a commit steals from
      compute while excluding the GIL/IO waits that overlap productive
      scanning. The journaled bundle must stay byte-identical to the
      plain run;
    - ``durability_resume_ms`` — wall time for a fully-committed job to
      resume: replay the journal, skip every chunk, merge the final bundle
      (the crash-recovery happy path measured end to end);
    - ``durability_replay_chunks_per_sec`` — journal replay throughput
      (`jobs.resume_ms` over `jobs.chunks_replayed`)."""
    platform = _setup_platform(args)
    backend = _backend(platform)
    import gc
    import shutil
    import tempfile

    from ipc_proofs_tpu_torch.fixtures import build_range_world
    from ipc_proofs_tpu_torch.jobs import JOBS_JOURNAL_NAME
    from ipc_proofs_tpu_torch.proofs.generator import EventProofSpec
    from ipc_proofs_tpu_torch.proofs.range import generate_event_proofs_for_range_pipelined
    from ipc_proofs_tpu_torch.utils.metrics import Metrics

    # leg-local shape, heavier per pair than the orchestrator defaults: the
    # journal writes one fsync'd record per CHUNK, so the honest overhead
    # number needs chunks with representative work in them — against a
    # ~3 ms toy chunk the fsync dominates and the ratio measures the disk,
    # not the design
    n_pairs = 48 if args.quick else 96
    chunk_size = 8 if args.quick else 16
    bs, pairs, _ = build_range_world(
        n_pairs, 48, 8, 0.1,
        signature=SIG, topic1=TOPIC1, actor_id=ACTOR, base_height=50_000_000,
    )
    spec = EventProofSpec(event_signature=SIG, topic_1=TOPIC1, actor_id_filter=ACTOR)

    def _run(job_dir=None, metrics=None):
        t0 = time.perf_counter()
        bundle = generate_event_proofs_for_range_pipelined(
            bs, pairs, spec, chunk_size=chunk_size, metrics=metrics,
            scan_threads=1, force_pipeline=True, job_dir=job_dir,
            match_backend=backend,
        )
        return bundle, time.perf_counter() - t0

    workdir = tempfile.mkdtemp(prefix="bench_durability_")
    try:
        _run()  # warm (kernel build, extension load)
        plain_bundle, t_plain = None, None
        for _ in range(3):
            gc.collect()
            bundle, wall = _run()
            if t_plain is None or wall < t_plain:
                plain_bundle, t_plain = bundle, wall

        # attributable journal cost: best-of-3 of the per-run total of
        # jobs.commit_us (each run gets a fresh job dir — every chunk
        # commits, nothing resumes)
        commit_s = None
        journaled_bundle = None
        for rep in range(3):
            gc.collect()
            jm = Metrics()
            journaled_bundle, _ = _run(
                os.path.join(workdir, f"job{rep}"), metrics=jm
            )
            rep_s = jm.snapshot()["counters"].get("jobs.commit_us", 0) / 1e6
            if commit_s is None or rep_s < commit_s:
                commit_s = rep_s
        assert journaled_bundle.to_json() == plain_bundle.to_json(), (
            "journaled bundle diverged from the plain run"
        )
        overhead_pct = 100.0 * commit_s / t_plain

        # resume latency: a fully-committed job re-run end to end
        resume_dir = os.path.join(workdir, "resume_job")
        _run(resume_dir)
        resume_metrics = Metrics()
        resumed_bundle, t_resume = _run(resume_dir, metrics=resume_metrics)
        assert resumed_bundle.to_json() == plain_bundle.to_json(), (
            "resumed bundle diverged from the plain run"
        )
        counters = resume_metrics.snapshot()["counters"]
        chunks_replayed = counters.get("jobs.chunks_replayed", 0)
        replay_ms = counters.get("jobs.resume_ms", 0)
        n_chunks = (n_pairs + chunk_size - 1) // chunk_size
        assert chunks_replayed == n_chunks, (chunks_replayed, n_chunks)
        replay_rate = (
            chunks_replayed / (replay_ms / 1000.0) if replay_ms > 0 else None
        )
        journal_bytes = os.path.getsize(
            os.path.join(resume_dir, JOBS_JOURNAL_NAME)
        )
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    _log(
        f"bench: durability ({n_pairs} pairs, {n_chunks} chunks): journal "
        f"overhead {overhead_pct:.2f}% ({commit_s * 1000:.1f}ms commit time "
        f"on a {t_plain * 1000:.0f}ms run, {journal_bytes} journal bytes), "
        f"resume {t_resume * 1000:.1f}ms e2e "
        f"(replay {replay_ms}ms for {chunks_replayed} chunks)"
    )
    return {
        "durability_journal_overhead_pct": round(overhead_pct, 2),
        "durability_resume_ms": round(t_resume * 1000, 2),
        "durability_replay_chunks_per_sec": (
            round(replay_rate, 1) if replay_rate is not None else None
        ),
        "durability_journal_bytes": journal_bytes,
        "durability_chunks": n_chunks,
        "_platform": platform,
    }


def _leg_observability(args) -> dict:
    """Observability measurements (hermetic): what the trace
    spine (`ipc_proofs_tpu_torch/obs/`) costs when fully enabled:

    - ``trace_overhead_pct`` — wall-clock cost of running the pipelined
      range driver with the span collector enabled (every stage, RPC, and
      journal span recorded) vs. the always-on default (flight ring
      only). Off/on reps are interleaved and each side takes its best-of-4
      so a load spike on a shared host lands on both sides instead of
      biasing one; clamped at 0 because the delta is within scheduler
      noise when the spine is doing its job. The budget is ≤ 3 %;
    - ``spans_per_proof`` — spans recorded per event proof produced, the
      tracing "weight" of one unit of useful work;
    - ``observability_spans_recorded`` / ``observability_spans_dropped``
      — collector totals for the traced run (drops mean the capacity
      default is too small for this workload shape)."""
    platform = _setup_platform(args)
    backend = _backend(platform)
    import gc

    from ipc_proofs_tpu_torch.fixtures import build_range_world
    from ipc_proofs_tpu_torch.obs import disable_tracing, enable_tracing
    from ipc_proofs_tpu_torch.proofs.generator import EventProofSpec
    from ipc_proofs_tpu_torch.proofs.range import generate_event_proofs_for_range_pipelined
    from ipc_proofs_tpu_torch.utils.metrics import Metrics

    n_pairs = 48 if args.quick else 96
    chunk_size = 8 if args.quick else 16
    bs, pairs, _ = build_range_world(
        n_pairs, 48, 8, 0.1,
        signature=SIG, topic1=TOPIC1, actor_id=ACTOR, base_height=60_000_000,
    )
    spec = EventProofSpec(event_signature=SIG, topic_1=TOPIC1, actor_id_filter=ACTOR)

    def _run(metrics):
        t0 = time.perf_counter()
        bundle = generate_event_proofs_for_range_pipelined(
            bs, pairs, spec, chunk_size=chunk_size, metrics=metrics,
            scan_threads=1, force_pipeline=True, match_backend=backend,
        )
        return bundle, time.perf_counter() - t0

    disable_tracing()  # baseline = the always-on default (flight ring only)
    _run(Metrics())  # warm (kernel build, extension load)
    # interleave off/on reps: a load spike on a shared host hits both
    # sides instead of biasing whichever mode happened to run during it
    t_off = t_on = None
    spans_recorded = spans_dropped = 0
    bundle_off = bundle_on = None
    try:
        for _ in range(4):
            gc.collect()
            disable_tracing()
            bundle_off, wall = _run(Metrics())
            if t_off is None or wall < t_off:
                t_off = wall
            gc.collect()
            m = Metrics()
            enable_tracing(metrics=m)
            bundle_on, wall = _run(m)
            counters = m.snapshot()["counters"]
            if t_on is None or wall < t_on:
                t_on = wall
                spans_recorded = counters.get("trace.spans_recorded", 0)
                spans_dropped = counters.get("trace.spans_dropped", 0)
    finally:
        disable_tracing()
    assert bundle_on.to_json() == bundle_off.to_json(), (
        "traced bundle diverged from the untraced run"
    )

    n_proofs = len(bundle_on.event_proofs)
    overhead_pct = max(0.0, 100.0 * (t_on - t_off) / t_off)
    spans_per_proof = spans_recorded / n_proofs if n_proofs else None
    _log(
        f"bench: observability ({n_pairs} pairs, {n_proofs} proofs): trace "
        f"overhead {overhead_pct:.2f}% ({t_on * 1000:.0f}ms traced vs "
        f"{t_off * 1000:.0f}ms untraced), {spans_recorded} spans recorded "
        f"({spans_dropped} dropped), {spans_per_proof:.1f} spans/proof"
    )
    return {
        "trace_overhead_pct": round(overhead_pct, 2),
        "spans_per_proof": (
            round(spans_per_proof, 2) if spans_per_proof is not None else None
        ),
        "observability_spans_recorded": spans_recorded,
        "observability_spans_dropped": spans_dropped,
        "observability_pairs": n_pairs,
        "_platform": platform,
    }


def _leg_storage(args) -> dict:
    """Tiered-store measurements (hermetic): what the disk tier
    (`ipc_proofs_tpu_torch/storex/`) and the chain-follow prefetch buy on a
    range request whose blocks live behind an RPC with real latency:

    - ``cold_vs_warm_speedup`` — wall-clock ratio of a cold-RPC run
      (every block over `LotusClient`, per-call simulated network delay)
      to a disk-warm run after a simulated restart (fresh memory cache,
      same segment files). The warm run must issue ZERO RPC calls and
      produce a byte-identical bundle — both asserted, not assumed;
    - ``disk_hit_ratio`` — fraction of the warm run's block reads served
      (multihash-verified) from the disk tier;
    - ``prefetch_hit_ratio`` — fraction of a request's block reads served
      locally after the `ChainFollower` pre-warmed the tipset spines into
      a fresh store (the follower only walks the spine + first-level
      links, so this is < 1 by design — it measures how much of a real
      request the follower anticipates).

    The disk tier's sweep and the follower's landed waves verify on the
    card's lane."""
    platform = _setup_platform(args)
    backend = _backend(platform)
    import gc
    import shutil
    import tempfile

    from ipc_proofs_tpu_torch.fixtures import build_range_world
    from ipc_proofs_tpu_torch.proofs.generator import EventProofSpec
    from ipc_proofs_tpu_torch.proofs.range import generate_event_proofs_for_range_pipelined
    from ipc_proofs_tpu_torch.store.faults import LocalLotusSession
    from ipc_proofs_tpu_torch.store.rpc import LotusClient, RpcBlockstore
    from ipc_proofs_tpu_torch.storex import ChainFollower, SegmentStore, TieredBlockstore
    from ipc_proofs_tpu_torch.utils.metrics import Metrics

    n_pairs = 12 if args.quick else 32
    bs, pairs, _ = build_range_world(
        n_pairs, 32, 8, 0.1,
        signature=SIG, topic1=TOPIC1, actor_id=ACTOR, base_height=70_000_000,
    )
    spec = EventProofSpec(event_signature=SIG, topic_1=TOPIC1, actor_id_filter=ACTOR)

    # every RPC pays this much simulated network latency, so cold-vs-warm
    # measures fetch avoidance against a realistic wire, not dict lookups
    delay_s = 0.0002

    class _SlowSession:
        def __init__(self, inner):
            self._inner = inner

        def post(self, url, data=None, headers=None, timeout=None):
            time.sleep(delay_s)
            return self._inner.post(url, data=data, headers=headers, timeout=timeout)

    def _client(metrics):
        return LotusClient(
            "http://bench-storage",
            session=_SlowSession(LocalLotusSession(bs)),
            metrics=metrics,
        )

    def _run(store, metrics=None):
        t0 = time.perf_counter()
        bundle = generate_event_proofs_for_range_pipelined(
            store, pairs, spec, chunk_size=8, metrics=metrics,
            scan_threads=1, force_pipeline=True, match_backend=backend,
        )
        return bundle, time.perf_counter() - t0

    workdir = tempfile.mkdtemp(prefix="bench_storage_")
    try:
        _run(bs)  # warm (kernel build, extension load) off the wire entirely

        # --- cold: every block over RPC, no disk tier -----------------------
        t_cold = rpc_cold = None
        bundle_cold = None
        for _ in range(2):
            gc.collect()
            m = Metrics()
            bundle_cold, wall = _run(RpcBlockstore(_client(m)), metrics=m)
            calls = m.snapshot()["counters"].get("rpc.calls", 0)
            if t_cold is None or wall < t_cold:
                t_cold, rpc_cold = wall, calls

        # --- populate the disk tier, then restart into it -------------------
        store_dir = os.path.join(workdir, "store")
        m_pop = Metrics()
        disk = SegmentStore(store_dir, metrics=m_pop, backend=backend)
        _run(TieredBlockstore(RpcBlockstore(_client(m_pop)), disk, metrics=m_pop))
        disk.close()

        # fresh SegmentStore + empty memory cache over the same files: the
        # restart path — the index rebuilds from the segment frames
        t_warm = rpc_warm = None
        hit_ratio = None
        disk_bytes = disk_entries = 0
        bundle_warm = None
        for _ in range(2):
            gc.collect()
            m = Metrics()
            disk = SegmentStore(store_dir, metrics=m, backend=backend)
            tiered = TieredBlockstore(
                RpcBlockstore(_client(m)), disk, metrics=m
            )
            bundle_warm, wall = _run(tiered, metrics=m)
            counters = m.snapshot()["counters"]
            calls = counters.get("rpc.calls", 0)
            if t_warm is None or wall < t_warm:
                t_warm, rpc_warm = wall, calls
                d_hits = counters.get("storex.disk_hits", 0)
                d_misses = counters.get("storex.disk_misses", 0)
                hit_ratio = d_hits / (d_hits + d_misses) if d_hits + d_misses else None
                stats = disk.stats()
                disk_bytes, disk_entries = stats["bytes"], stats["entries"]
            disk.close()
        assert bundle_warm.to_json() == bundle_cold.to_json(), (
            "disk-warm bundle diverged from the cold-RPC run"
        )
        assert rpc_warm == 0, f"disk-warm run issued {rpc_warm} RPC calls"

        # --- follower prefetch into a fresh store ---------------------------
        m = Metrics()
        disk = SegmentStore(os.path.join(workdir, "follow"), metrics=m, backend=backend)
        tiered = TieredBlockstore(RpcBlockstore(_client(m)), disk, metrics=m)
        follower = ChainFollower(_client(m), tiered, metrics=m, backend=backend)
        for pair in pairs:
            follower.prefetch_tipset(pair.parent)
            follower.prefetch_tipset(pair.child)
        counters = m.snapshot()["counters"]
        prefetched = counters.get("follow.blocks_prefetched", 0)
        h0, mi0 = tiered.hits, tiered.misses
        dh0 = counters.get("storex.disk_hits", 0)
        bundle_follow, _ = _run(tiered, metrics=m)
        counters = m.snapshot()["counters"]
        served_mem = tiered.hits - h0
        served_disk = counters.get("storex.disk_hits", 0) - dh0
        total_gets = served_mem + (tiered.misses - mi0)
        prefetch_ratio = (
            (served_mem + served_disk) / total_gets if total_gets else None
        )
        disk.close()
        assert bundle_follow.to_json() == bundle_cold.to_json(), (
            "follower-prefetched bundle diverged from the cold-RPC run"
        )
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    speedup = t_cold / t_warm if t_warm else None
    _log(
        f"bench: storage ({n_pairs} pairs): cold {t_cold * 1000:.0f}ms "
        f"({rpc_cold} RPC calls) vs disk-warm {t_warm * 1000:.0f}ms "
        f"({rpc_warm} RPC calls) = {speedup:.2f}x; disk_hit_ratio "
        f"{hit_ratio:.3f} over {disk_entries} blocks ({disk_bytes}B); "
        f"follower prefetched {prefetched} blocks → prefetch_hit_ratio "
        f"{prefetch_ratio:.3f}"
    )
    return {
        "cold_vs_warm_speedup": round(speedup, 2) if speedup else None,
        "disk_hit_ratio": round(hit_ratio, 4) if hit_ratio is not None else None,
        "prefetch_hit_ratio": (
            round(prefetch_ratio, 4) if prefetch_ratio is not None else None
        ),
        "storage_cold_rpc_calls": rpc_cold,
        "storage_warm_rpc_calls": rpc_warm,
        "storage_prefetched_blocks": prefetched,
        "storage_disk_bytes": disk_bytes,
        "storage_pairs": n_pairs,
        "_platform": platform,
    }


def _leg_asyncfetch(args) -> dict:
    """Async fetch plane (hermetic): what JSON-RPC batching +
    speculative HAMT/AMT prefetch buy on a COLD range request whose blocks
    live behind a wire with real per-round-trip latency:

    - ``cold_rpc_roundtrips_per_proof`` — HTTP round-trips per proof with
      the fetch plane underneath (one batch array POST per dispatcher
      wave; `rpc.calls` ticks once per round-trip, batch or not);
    - ``sync_rpc_roundtrips_per_proof`` — the SAME request through the
      sync walker (`RpcBlockstore` demand path, one `ChainReadObj` per
      block) against the same endpoint;
    - ``cold_speedup_vs_sync_walker`` — wall-clock ratio (best-of-N);
    - ``speculate_waste_pct`` — speculative blocks fetched but never
      consumed, as a % of speculative fetches (mis-speculation is a
      counted cost, never an error).

    Byte identity between the plane bundle and the sync-walker bundle is
    asserted, not assumed — the plane changes when blocks arrive, never
    what any get returns. Every landed wave verifies on the card's lane."""
    platform = _setup_platform(args)
    backend = _backend(platform)
    import gc

    from ipc_proofs_tpu_torch.fixtures import build_range_world
    from ipc_proofs_tpu_torch.proofs.generator import EventProofSpec
    from ipc_proofs_tpu_torch.proofs.range import generate_event_proofs_for_range_pipelined
    from ipc_proofs_tpu_torch.store.faults import LocalLotusSession
    from ipc_proofs_tpu_torch.store.fetchplane import FetchPlane, PlaneBlockstore
    from ipc_proofs_tpu_torch.store.rpc import LotusClient, RpcBlockstore
    from ipc_proofs_tpu_torch.utils.metrics import Metrics

    n_pairs = 12 if args.quick else 32
    bs, pairs, _ = build_range_world(
        n_pairs, 32, 8, 0.1,
        signature=SIG, topic1=TOPIC1, actor_id=ACTOR, base_height=80_000_000,
    )
    spec = EventProofSpec(event_signature=SIG, topic_1=TOPIC1, actor_id_filter=ACTOR)

    # every round-trip pays this much simulated wire latency — a batch
    # array pays it ONCE for the whole wave, which is the entire point.
    # 2ms is a conservative same-region RPC latency; below ~0.5ms the
    # dispatcher handoff overhead drowns the signal and the leg measures
    # thread scheduling instead of wire behaviour.
    delay_s = 0.002

    class _SlowSession:
        def __init__(self, inner):
            self._inner = inner

        def post(self, url, data=None, headers=None, timeout=None):
            time.sleep(delay_s)
            return self._inner.post(url, data=data, headers=headers, timeout=timeout)

    def _client(metrics):
        return LotusClient(
            "http://bench-asyncfetch",
            session=_SlowSession(LocalLotusSession(bs)),
            metrics=metrics,
        )

    def _run(store, metrics=None):
        t0 = time.perf_counter()
        bundle = generate_event_proofs_for_range_pipelined(
            store, pairs, spec, chunk_size=8, metrics=metrics,
            scan_threads=2, force_pipeline=True, match_backend=backend,
        )
        return bundle, time.perf_counter() - t0

    _run(bs)  # warm (kernel build, extension load) off the wire entirely

    # --- sync walker: one ChainReadObj per demand block ---------------------
    t_sync = rpc_sync = None
    bundle_sync = None
    for _ in range(2):
        gc.collect()
        m = Metrics()
        bundle_sync, wall = _run(RpcBlockstore(_client(m)), metrics=m)
        calls = m.snapshot()["counters"].get("rpc.calls", 0)
        if t_sync is None or wall < t_sync:
            t_sync, rpc_sync = wall, calls

    # --- fetch plane: batched want-queue + speculative prefetch -------------
    t_plane = rpc_plane = batch_calls = None
    waste_pct = None
    bundle_plane = None
    for _ in range(2):
        gc.collect()
        m = Metrics()
        # depth=2 chases grandchildren of every decoded HAMT/AMT interior
        # node — the sweet spot for this world: depth=1 leaves most of the
        # serial walk exposed, depth=3 mostly fetches blocks the proofs
        # never touch (waste without any extra latency hidden).
        plane = FetchPlane(
            _client(m), local={}, speculate_depth=2, metrics=m, backend=backend
        )
        bundle_plane, wall = _run(PlaneBlockstore(plane), metrics=m)
        plane.close()
        counters = m.snapshot()["counters"]
        calls = counters.get("rpc.calls", 0)
        if t_plane is None or wall < t_plane:
            t_plane, rpc_plane = wall, calls
            batch_calls = counters.get("rpc.batch_calls", 0)
            waste_pct = plane.stats()["waste_pct"]
    assert bundle_plane.to_json() == bundle_sync.to_json(), (
        "fetch-plane bundle diverged from the sync-walker run"
    )

    n_proofs = len(bundle_sync.event_proofs)
    cold_rt = rpc_plane / n_proofs if n_proofs else None
    sync_rt = rpc_sync / n_proofs if n_proofs else None
    speedup = t_sync / t_plane if t_plane else None
    _log(
        f"bench: asyncfetch ({n_pairs} pairs, {n_proofs} proofs): plane "
        f"{t_plane * 1000:.0f}ms ({rpc_plane} round-trips, {batch_calls} "
        f"batch POSTs) vs sync walker {t_sync * 1000:.0f}ms ({rpc_sync} "
        f"round-trips) = {speedup:.2f}x; "
        f"{cold_rt:.2f} vs {sync_rt:.2f} round-trips/proof; "
        f"speculate_waste {waste_pct:.1f}%"
    )
    return {
        "cold_rpc_roundtrips_per_proof": (
            round(cold_rt, 2) if cold_rt is not None else None
        ),
        "sync_rpc_roundtrips_per_proof": (
            round(sync_rt, 2) if sync_rt is not None else None
        ),
        "cold_speedup_vs_sync_walker": (
            round(speedup, 2) if speedup is not None else None
        ),
        "speculate_waste_pct": (
            round(waste_pct, 2) if waste_pct is not None else None
        ),
        "asyncfetch_batch_calls": batch_calls,
        "asyncfetch_cold_rpc_calls": rpc_plane,
        "asyncfetch_sync_rpc_calls": rpc_sync,
        "asyncfetch_pairs": n_pairs,
        "_platform": platform,
    }


def _leg_cluster(args) -> dict:
    """Sharded serve plane (REAL processes): aggregate generate
    throughput through the consistent-hash router at 1 vs 4 shard child
    processes over one shared demo world + shared ``--store-dir``.

    - ``aggregate_proofs_per_sec`` — event proofs/s through the 4-shard
      router under a closed-loop client load;
    - ``cluster_linearity_4shard`` — rps(4 shards) / (4 × rps(1 shard)).
      Shards are separate processes (own GILs), so on a multi-core host
      this measures real scaling; the ≥ 0.8 gate is enforced by
      the port's ``check_bench_schema`` only when host_cores > 2 (a 1-core
      host time-slices the shards — the artifact still records the
      honestly-measured number);
    - ``steal_events`` — work-steal placements observed during the load;
    - scatter-gather byte-identity (4-shard vs 1-shard vs single-process
      chunked driver) is ASSERTED here on every run, not gated.

    Every shard child runs ``serve --backend gpu`` (``cpu`` under
    ``--platform cpu``): on one card the shards share it and the host's
    CPUs, so the linearity measures one host's contention, not separate
    machines.
    """
    platform = _setup_platform(args)
    backend = _backend(platform)
    shard_backend = "gpu" if platform == "cuda" else "cpu"
    import shutil
    import tempfile
    import threading

    from ipc_proofs_tpu_torch.cluster import ClusterRouter, spawn_serve_shard
    from ipc_proofs_tpu_torch.fixtures import build_range_world
    from ipc_proofs_tpu_torch.proofs.generator import EventProofSpec
    from ipc_proofs_tpu_torch.proofs.range import generate_event_proofs_for_range_chunked
    from ipc_proofs_tpu_torch.utils.metrics import Metrics

    n_pairs = 8 if args.quick else args.cluster_pairs
    n_requests = 32 if args.quick else args.cluster_requests
    receipts, match_rate = 8, 0.25
    concurrency = 8

    # the same deterministic world the shard children rebuild — the
    # in-process comparator for the byte-identity assertion
    store, pairs, _ = build_range_world(
        n_pairs, receipts_per_pair=receipts, match_rate=match_rate,
        signature=SIG, topic1=TOPIC1,
    )
    spec = EventProofSpec(event_signature=SIG, topic_1=TOPIC1)
    direct = generate_event_proofs_for_range_chunked(
        store, list(pairs), spec, chunk_size=8, match_backend=backend
    )
    direct_json = json.dumps(direct.to_json_obj(), sort_keys=True)
    extra = [
        "--demo-receipts", str(receipts), "--demo-match-rate", str(match_rate),
        "--backend", shard_backend,
    ]

    def measure(n_shards: int, store_dir: str) -> "tuple[float, dict, str]":
        shards = [
            spawn_serve_shard(
                f"s{k}", n_pairs, SIG, TOPIC1,
                store_dir=store_dir, extra_args=extra,
            )
            for k in range(n_shards)
        ]
        m = Metrics()
        router = ClusterRouter(
            {sh.name: sh.url for sh in shards}, pairs,
            steal_threshold=2, metrics=m,
        )
        try:
            # warm every shard (extension load, first-request kernel builds)
            for k in range(len(pairs)):
                status, _ = router.generate(k % len(pairs))
                assert status == 200
            it = iter(range(n_requests))
            it_lock = threading.Lock()
            proofs = [0]
            failures: "list" = []

            def client():
                while True:
                    with it_lock:
                        i = next(it, None)
                    if i is None:
                        return
                    status, obj = router.generate(i % len(pairs))
                    if status != 200:
                        failures.append((i, obj))
                        return
                    with it_lock:
                        proofs[0] += obj["n_event_proofs"]

            threads = [
                threading.Thread(target=client) for _ in range(concurrency)
            ]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            wall = time.perf_counter() - t0
            assert not failures, f"cluster leg: {len(failures)} failures"
            # scatter-gather over the WHOLE table: must match the
            # single-process chunked driver byte for byte
            status, obj = router.generate_range(
                list(range(len(pairs))), chunk_size=8
            )
            assert status == 200, obj
            got = json.dumps(obj["bundle"], sort_keys=True)
            snap = m.snapshot()
            return (
                n_requests / wall,
                {"proofs": proofs[0], "wall": wall, "snap": snap},
                got,
            )
        finally:
            router.close()
            for sh in shards:
                sh.stop()

    workdir = tempfile.mkdtemp(prefix="bench_cluster_")
    try:
        rps1, _info1, bundle1 = measure(1, os.path.join(workdir, "st1"))
        rps4, info4, bundle4 = measure(4, os.path.join(workdir, "st4"))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    assert bundle1 == direct_json, (
        "1-shard scatter bundle diverged from the single-process driver"
    )
    assert bundle4 == direct_json, (
        "4-shard scatter bundle diverged from the single-process driver"
    )
    linearity = rps4 / (4 * rps1) if rps1 else None
    agg_proofs_per_sec = info4["proofs"] / info4["wall"]
    steals = info4["snap"]["counters"].get("cluster.steals", 0)
    _log(
        f"bench: cluster ({n_pairs} pairs, {n_requests} reqs, c={concurrency}): "
        f"{rps1:,.1f} req/s @1 shard vs {rps4:,.1f} req/s @4 shards "
        f"(linearity {linearity:.2f}); {agg_proofs_per_sec:,.0f} proofs/s "
        f"aggregate, {steals} steals; 4-shard bundle byte-identical ✓"
    )
    return {
        "aggregate_proofs_per_sec": round(agg_proofs_per_sec, 1),
        "cluster_linearity_4shard": round(linearity, 3) if linearity else None,
        "steal_events": int(steals),
        "cluster_rps_1shard": round(rps1, 1),
        "cluster_rps_4shard": round(rps4, 1),
        "cluster_pairs": n_pairs,
        "cluster_requests": n_requests,
        "_platform": platform,
    }


def _leg_backfill(args) -> dict:
    """Bulk backfill (REAL shard processes): deep-history
    throughput through the router's backfill engine at 1 vs 4 shard
    child processes over one shared demo world.

    Asserted on every run, never gated:
    - the streamed chunk sequence, folded client-side exactly as a
      consumer would, is byte-identical to the single-process chunked
      driver over the same pairs — at BOTH shard counts;
    - every window arrives exactly once through the cursor protocol.

    Measured numbers:
    - ``backfill_epochs_per_sec`` — epochs proven per second through the
      4-shard scatter (1-shard recorded alongside); gated > 0 by
      the port's ``check_bench_schema``;
    - ``backfill_ttfc_ms`` vs ``backfill_total_ms`` — time to FIRST
      streamed chunk vs job completion; the schema gate demands
      ttfc < total (incremental delivery is the point of the stream);
    - ``backfill_occupancy_pct`` — proving seconds per shard-lane
      second from the engine's busy/wall accounting (the device-side
      utilization a backfill achieves without an interactive load).

    The shard children run ``serve --backend gpu`` and share the one card
    and the host's CPUs.
    """
    platform = _setup_platform(args)
    backend = _backend(platform)
    shard_backend = "gpu" if platform == "cuda" else "cpu"
    import shutil
    import tempfile

    from ipc_proofs_tpu_torch.cluster import ClusterRouter, spawn_serve_shard
    from ipc_proofs_tpu_torch.cluster.gather import BundleFold
    from ipc_proofs_tpu_torch.fixtures import build_range_world
    from ipc_proofs_tpu_torch.proofs.bundle import UnifiedProofBundle
    from ipc_proofs_tpu_torch.proofs.generator import EventProofSpec
    from ipc_proofs_tpu_torch.proofs.range import generate_event_proofs_for_range_chunked
    from ipc_proofs_tpu_torch.utils.metrics import Metrics

    n_pairs = 24 if args.quick else 64
    receipts, match_rate = 8, 0.25
    window_size = 4 if args.quick else 8
    n_windows = -(-n_pairs // window_size)

    store, pairs, _ = build_range_world(
        n_pairs, receipts_per_pair=receipts, match_rate=match_rate,
        signature=SIG, topic1=TOPIC1,
    )
    spec = EventProofSpec(event_signature=SIG, topic_1=TOPIC1)
    direct = generate_event_proofs_for_range_chunked(
        store, list(pairs), spec, chunk_size=window_size, match_backend=backend
    )
    direct_json = json.dumps(direct.to_json_obj(), sort_keys=True)
    extra = [
        "--demo-receipts", str(receipts), "--demo-match-rate", str(match_rate),
        "--backend", shard_backend,
    ]

    def measure(n_shards: int, workdir: str) -> dict:
        shards = [
            spawn_serve_shard(
                f"s{k}", n_pairs, SIG, TOPIC1,
                store_dir=os.path.join(workdir, "store"), extra_args=extra,
            )
            for k in range(n_shards)
        ]
        m = Metrics()
        router = ClusterRouter(
            {sh.name: sh.url for sh in shards}, pairs,
            steal_threshold=2, metrics=m, spec=spec,
            backfill_jobs_dir=os.path.join(workdir, "jobs"),
            backfill_window_size=window_size,
        )
        try:
            # warm every shard (extension load, first-request kernel builds)
            for k in range(2 * n_shards):
                status, _obj = router.generate(k % len(pairs))
                assert status == 200
            status, submitted = router.backfill_submit(
                {"pair_start": 0, "pair_end": n_pairs}
            )
            assert status == 200, submitted
            job_id = submitted["job_id"]
            # consume the stream through the real cursor protocol: each
            # poll acks what we already hold and long-polls for more
            cursor, chunks = 0, []
            while True:
                status, resp = router.backfill_chunks(
                    job_id, cursor, wait_s=10.0
                )
                assert status == 200, resp
                for ch in resp["chunks"]:
                    chunks.append(ch)
                    cursor = ch["cursor"]
                if resp["state"] != "running" and not resp["chunks"]:
                    break
            assert resp["state"] == "complete", resp
            assert len(chunks) == n_windows, (
                f"{len(chunks)} chunks streamed for {n_windows} windows"
            )
            # fold the stream exactly as a consumer would: must equal the
            # single-process chunked driver byte for byte
            fold = BundleFold(pairs, list(range(n_pairs)))
            for ch in chunks:
                fold.fold(UnifiedProofBundle.from_json_obj(ch["bundle"]))
            got = json.dumps(fold.seal().to_json_obj(), sort_keys=True)
            assert got == direct_json, (
                f"{n_shards}-shard backfill stream diverged from the "
                "single-process driver"
            )
            status, st = router.backfill_status(job_id)
            assert status == 200, st
            return st
        finally:
            router.close()
            for sh in shards:
                sh.stop()

    workdir = tempfile.mkdtemp(prefix="bench_backfill_")
    try:
        st1 = measure(1, os.path.join(workdir, "b1"))
        st4 = measure(4, os.path.join(workdir, "b4"))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    epochs1 = n_pairs / st1["wall_s"]
    epochs4 = n_pairs / st4["wall_s"]
    ttfc_ms = (st4["first_chunk_s"] or 0.0) * 1000.0
    total_ms = st4["wall_s"] * 1000.0
    occupancy = 100.0 * st4["busy_s"] / (4 * st4["wall_s"])
    _log(
        f"bench: backfill ({n_pairs} epochs, {n_windows} windows of "
        f"{window_size}): {epochs1:,.1f} epochs/s @1 shard vs "
        f"{epochs4:,.1f} epochs/s @4 shards; first chunk {ttfc_ms:,.0f}ms "
        f"vs total {total_ms:,.0f}ms; lane occupancy {occupancy:.0f}%; "
        "streamed fold byte-identical at both shard counts ✓"
    )
    return {
        "backfill_epochs_per_sec": round(epochs4, 2),
        "backfill_epochs_per_sec_1shard": round(epochs1, 2),
        "backfill_ttfc_ms": round(ttfc_ms, 1),
        "backfill_total_ms": round(total_ms, 1),
        "backfill_occupancy_pct": round(occupancy, 1),
        "backfill_windows": n_windows,
        "backfill_epochs": n_pairs,
        "backfill_shards": 4,
        "_platform": platform,
    }


def _leg_fleetobs(args) -> dict:
    """Fleet observability overhead (REAL processes): the same
    closed-loop generate load through a 2-shard router with the fleet
    observability plane OFF vs ON (federated metrics scraping, SLO
    watchdog, per-tenant accounting, head-sampled tracing with in-band
    span shipping at production rate 0.1).

    - ``fleetobs_overhead_pct`` — throughput cost of the plane; gated
      ≤ 3% by the port's ``check_bench_schema`` on current artifacts from
      hosts with spare cores (on ≤2-core hosts the scrape/watchdog
      threads time-slice the request loop, so the ratio is skipped);
    - correctness is ASSERTED on every run, never sampled: after the
      measured load, a fully-sampled scatter must graft every shard's
      shipped span subtree into ONE rooted tree in the router's
      collector (``fleetobs_stitched_spans`` of them), no orphans.

    Best-of-3 walls per mode: the closed loop over a small demo world is
    short, and the overhead ratio needs both numerators at their noise
    floor, not one lucky and one unlucky pass. The 2 shard children run
    ``serve --backend gpu`` and share the one card and the host's CPUs."""
    platform = _setup_platform(args)
    shard_backend = "gpu" if platform == "cuda" else "cpu"
    import threading

    from ipc_proofs_tpu_torch.cluster import ClusterRouter, spawn_serve_shard
    from ipc_proofs_tpu_torch.fixtures import build_range_world
    from ipc_proofs_tpu_torch.obs import disable_tracing, enable_tracing
    from ipc_proofs_tpu_torch.obs.slo import SloWatchdog, default_targets
    from ipc_proofs_tpu_torch.utils.metrics import Metrics

    n_pairs = 8 if args.quick else args.cluster_pairs
    n_requests = 32 if args.quick else args.cluster_requests
    receipts, match_rate = 8, 0.25
    concurrency, n_shards, reps = 8, 2, 3

    _store, pairs, _ = build_range_world(
        n_pairs, receipts_per_pair=receipts, match_rate=match_rate,
        signature=SIG, topic1=TOPIC1,
    )
    base_extra = [
        "--demo-receipts", str(receipts), "--demo-match-rate", str(match_rate),
        "--backend", shard_backend,
    ]

    def closed_loop(router, observed: bool) -> float:
        it = iter(range(n_requests))
        it_lock = threading.Lock()
        failures: "list" = []

        def client():
            while True:
                with it_lock:
                    i = next(it, None)
                if i is None:
                    return
                status, obj = router.generate(
                    i % len(pairs),
                    tenant=f"team-{i % 3}" if observed else None,
                )
                if status != 200:
                    failures.append((i, obj))
                    return

        threads = [threading.Thread(target=client) for _ in range(concurrency)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        assert not failures, f"fleetobs leg: {len(failures)} failures"
        return n_requests / wall

    def measure(observed: bool) -> "tuple[float, int, int]":
        extra = list(base_extra)
        if observed:
            extra += [
                "--trace-out", os.devnull, "--trace-sample", "0.1",
                "--slo", "on",
            ]
        shards = [
            spawn_serve_shard(f"s{k}", n_pairs, SIG, TOPIC1, extra_args=extra)
            for k in range(n_shards)
        ]
        m = Metrics()
        collector = slo = None
        if observed:
            collector = enable_tracing(metrics=m, sample=0.1)
            slo = SloWatchdog(m, default_targets(), interval_s=0.5)
        router = ClusterRouter(
            {sh.name: sh.url for sh in shards}, pairs, metrics=m,
            scrape_interval_s=0.25, scrape_timeout_s=5.0, slo=slo,
        )
        try:
            if observed:
                router.federation.start()
                slo.start()
            for k in range(len(pairs)):  # warm every shard
                status, _obj = router.generate(k % len(pairs))
                assert status == 200
            rps = max(closed_loop(router, observed) for _ in range(reps))
            grafted = scrapes = 0
            if observed:
                # outside the timed window: the stitching law, asserted
                collector = enable_tracing(metrics=m, sample=1.0)
                status, obj = router.generate_range(
                    list(range(len(pairs))), chunk_size=8
                )
                assert status == 200, obj
                tid = obj["trace_id"]
                spans = [
                    s for s in collector.snapshot() if s.trace_id == tid
                ]
                ids = {s.span_id for s in spans}
                roots = [
                    s for s in spans
                    if not s.parent_id or s.parent_id not in ids
                ]
                assert len(roots) == 1, (
                    "fleetobs leg: sampled scatter did not stitch into one "
                    f"rooted tree ({len(roots)} roots)"
                )
                grafted = sum(1 for s in spans if ":" in s.span_id)
                assert grafted > 0, "fleetobs leg: no shard subtrees grafted"
                scrapes = int(
                    m.snapshot()["counters"].get("fleet.scrapes", 0)
                )
            return rps, grafted, scrapes
        finally:
            router.close()
            if observed:
                disable_tracing()
            for sh in shards:
                sh.stop()

    rps_plain, _, _ = measure(False)
    rps_observed, grafted, scrapes = measure(True)
    overhead = (
        (rps_plain - rps_observed) / rps_plain * 100.0 if rps_plain else None
    )
    _log(
        f"bench: fleetobs ({n_pairs} pairs, {n_requests} reqs, "
        f"c={concurrency}): {rps_plain:,.1f} req/s plain vs "
        f"{rps_observed:,.1f} req/s observed ({overhead:+.2f}% overhead); "
        f"{grafted} spans grafted into one rooted tree ✓, {scrapes} scrapes"
    )
    return {
        "fleetobs_overhead_pct": round(overhead, 2) if overhead is not None else None,
        "fleetobs_rps_plain": round(rps_plain, 1),
        "fleetobs_rps_observed": round(rps_observed, 1),
        "fleetobs_stitched_spans": int(grafted),
        "fleetobs_scrapes": int(scrapes),
        "fleetobs_pairs": n_pairs,
        "fleetobs_requests": n_requests,
        "_platform": platform,
    }


# the onchip leg's sizes: (full, quick) events matched and blocks verified
ONCHIP_EVENTS = (1 << 20, 1 << 16)
ONCHIP_BLOCKS = (1024, 256)


def _best_of_seconds(fn, reps: int = 3) -> float:
    """Best wall seconds of ``reps`` calls of ``fn``."""
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def _leg_onchip(args) -> dict:
    """The on-chip half, sharded: mesh event matching across every local
    card (`GpuBackend(mesh=make_mesh(n))`) + device-batched multihash
    verification.

    Correctness is ASSERTED on every run, never sampled:
    - the mesh-sharded fingerprint match must be bit-identical to the
      single-device path over the same arrays;
    - `verify_blocks_batch` verdicts must equal the scalar
      `verify_block_bytes` loop — including deliberately corrupted blocks,
      every one of which must be caught;
    - cold-path integrity checking must issue ≤ 1 device dispatch per
      size-class chunk (the whole point of batching the verify plane).

    Measured numbers:
    - ``device_linearity_Nchip`` — rate(N devices) / (N × rate(1 device))
      for the match; gated ≥ 0.8 by check_bench_schema only on
      multi-device hosts (a one-card host records the number without a
      gate — it shows the mesh path's overhead against the plain path;
      no virtual mesh stands in for cards that are not there);
    - ``batch_verify_speedup`` — scalar hashlib loop wall / batched device
      plane wall over the same blocks;
    - ``verify_tuned_speedup`` — scalar wall / CHOSEN-lane wall after the
      per-host crossover autotune (`ops.verify.autotune_crossover`, its
      record ``verify_autotune_cuda.json`` in a temp directory, measured
      here). Asserted ≥ 0.8 every run: whatever lane the tuner picks must
      never be slower than scalar beyond noise.
    """
    platform = _setup_platform(args)
    import numpy as np

    from ipc_proofs_tpu_torch.backend.gpu import GpuBackend
    from ipc_proofs_tpu_torch.core.cid import BLAKE2B_256, CID, DAG_CBOR
    from ipc_proofs_tpu_torch.core.hashes import blake2b_256
    from ipc_proofs_tpu_torch.ops.verify import verify_blocks_batch
    from ipc_proofs_tpu_torch.parallel.mesh import make_mesh
    from ipc_proofs_tpu_torch.proofs.scan_native import topic_fingerprint
    from ipc_proofs_tpu_torch.state.events import ascii_to_bytes32, hash_event_signature
    from ipc_proofs_tpu_torch.store.rpc import verify_block_bytes
    from ipc_proofs_tpu_torch.utils.metrics import Metrics

    # force the device lane for the batched verify below (the port's match
    # has no host crossover: the mask always runs on the backend's device)
    os.environ["IPC_VERIFY_MIN_BYTES"] = "0"

    topic0 = hash_event_signature(SIG)
    topic1 = ascii_to_bytes32(TOPIC1)
    fp_target = topic_fingerprint(topic0, topic1)
    n_dev = _device_count(platform)

    n_events = ONCHIP_EVENTS[1] if args.quick else ONCHIP_EVENTS[0]
    rng = np.random.default_rng(7)
    fp = rng.integers(0, 1 << 63, size=n_events, dtype=np.uint64)
    n_topics = rng.integers(2, 4, size=n_events).astype(np.int32)
    emitters = rng.integers(0, 50, size=n_events).astype(np.int64)
    valid = rng.random(n_events) < 0.95
    hit = rng.random(n_events) < args.match_rate
    fp[hit] = np.uint64(fp_target)  # plant real matches

    b1 = GpuBackend(_device(platform))
    bN = GpuBackend(mesh=make_mesh(n_dev, devices=_mesh_devices(platform, n_dev)))

    def match(backend):
        return np.asarray(
            backend.event_match_mask_fp(
                fp, n_topics, emitters, valid, topic0, topic1, None
            )
        )[:n_events]

    mask1 = match(b1)  # also warms each path's kernels
    maskN = match(bN)
    assert np.array_equal(mask1, maskN), (
        "mesh-sharded match diverged from the single-device path"
    )
    assert mask1[valid & hit].all(), "planted matches were missed"

    def match_rate_of(backend) -> float:
        k = 3 if args.quick else 10

        def k_matches():
            for _i in range(k):
                match(backend)

        return n_events * k / _best_of_seconds(k_matches)

    rate_1 = match_rate_of(b1)
    rate_n = match_rate_of(bN)
    linearity = rate_n / (n_dev * rate_1)

    # --- batched multihash verification -------------------------------------
    n_blocks = ONCHIP_BLOCKS[1] if args.quick else ONCHIP_BLOCKS[0]
    block_bytes = 1024  # uniform size → one size class → minimal chunking
    payload = rng.integers(0, 256, size=(n_blocks, block_bytes), dtype=np.uint8)
    blocks = [payload[i].tobytes() for i in range(n_blocks)]
    cids = [CID.hash_of(b, codec=DAG_CBOR, mh_code=BLAKE2B_256) for b in blocks]
    corrupt = set(range(0, n_blocks, 37))
    for i in corrupt:  # flip one byte — every corruption must be caught
        blocks[i] = bytes([blocks[i][0] ^ 0x01]) + blocks[i][1:]

    m = Metrics()
    verify_blocks_batch(cids, blocks, backend=b1)  # warm (kernel build) outside the timing
    d0 = m.counter_value("verify.device_calls")
    got = verify_blocks_batch(cids, blocks, metrics=m, backend=b1)
    device_calls = m.counter_value("verify.device_calls") - d0
    # the reference's chunk of 512 messages (its _CHUNK_MAX_MSGS); the
    # port's lane makes one call per size class, whatever the count
    n_chunks = -(-n_blocks // 512)
    assert device_calls <= n_chunks, (
        f"cold-path verify used {device_calls} device calls for "
        f"{n_chunks} chunk(s)"
    )
    want = [verify_block_bytes(c, b) for c, b in zip(cids, blocks)]
    assert got == want, "batch verify verdicts diverged from the scalar path"
    assert all(not got[i] for i in corrupt), "a corrupted block slipped through"
    assert all(got[i] for i in range(n_blocks) if i not in corrupt)

    t_batch = _best_of_seconds(lambda: verify_blocks_batch(cids, blocks, backend=b1))
    t_scalar = _best_of_seconds(
        lambda: [verify_block_bytes(c, b) for c, b in zip(cids, blocks)]
    )
    speedup = t_scalar / t_batch
    assert blake2b_256(blocks[1]) == cids[1].digest  # sanity on the fixture

    # --- autotuned crossover: the lane the tuner PICKS must never lose ------
    # `batch_verify_speedup` above forces the device lane and records the
    # ratio honestly (< 1 on CPU-only hosts). The autotuner exists so
    # production never runs that losing lane: measure the per-host
    # crossover, persist it, and verify the CHOSEN lane is at least as
    # fast as scalar (beyond timing noise) on the same blocks.
    import shutil as _shutil
    import tempfile as _tempfile

    from ipc_proofs_tpu_torch.ops import verify as _vj

    tune_dir = _tempfile.mkdtemp(prefix="bench_autotune_")
    try:
        # drop the force-device override from the section above so the
        # tuned crossover (not env) governs lane choice
        os.environ.pop("IPC_VERIFY_MIN_BYTES", None)
        record = _vj.autotune_crossover(tune_dir, quick=args.quick, force=True, backend=b1)
        t_tuned = _best_of_seconds(lambda: verify_blocks_batch(cids, blocks, backend=b1))
    finally:
        _shutil.rmtree(tune_dir, ignore_errors=True)
    tuned_speedup = t_scalar / t_tuned
    scalar_only = bool(record["scalar_only"])
    assert tuned_speedup >= 0.8, (
        f"autotuned verify lane ran {1 / tuned_speedup:.2f}× slower than "
        f"scalar (record: {record}) — the tuner must never pick a losing "
        "lane beyond noise"
    )

    _log(
        f"bench: onchip autotune: crossover "
        f"{'scalar-only' if scalar_only else record['min_bytes']}, chosen "
        f"lane {t_tuned * 1e3:.1f} ms vs scalar {t_scalar * 1e3:.1f} ms "
        f"(speedup {tuned_speedup:.2f}) over {len(record['samples'])} "
        "measured sizes"
    )
    _log(
        f"bench: onchip ({n_dev} device(s)): match {rate_1:,.0f} ev/s @1 vs "
        f"{rate_n:,.0f} ev/s @{n_dev} (linearity {linearity:.2f}); "
        f"verify {n_blocks}×{block_bytes}B in {device_calls} device call(s), "
        f"batch {t_batch*1e3:.1f} ms vs scalar {t_scalar*1e3:.1f} ms "
        f"(speedup {speedup:.2f}); mesh + batch verdicts bit-identical ✓"
    )
    return {
        "device_linearity_Nchip": round(linearity, 3),
        "batch_verify_speedup": round(speedup, 3),
        "onchip_devices": n_dev,
        "onchip_match_events": n_events,
        "onchip_verify_blocks": n_blocks,
        "onchip_device_calls": int(device_calls),
        "verify_tuned_speedup": round(tuned_speedup, 3),
        "verify_autotune_scalar_only": scalar_only,
        "verify_autotuned_min_bytes": int(record["min_bytes"]),
        "_platform": platform,
    }


# the standing leg's subscription counts (the "1k" and "10k" of its keys)
STANDING_SUBSCRIPTIONS = (1_000, 10_000)


def _leg_standing(args) -> dict:
    """Standing queries (hermetic): push fan-out throughput and
    delivery lag at 1k and 10k subscriptions over one shared world.

    Subscriptions alternate between TWO distinct filters, so the
    amortization invariant is load-bearing: proofs generate once per
    distinct (pair, filter) and fan out to every subscriber —
    ``standing_generations_per_tipset`` can never exceed
    ``standing_distinct_filters`` regardless of subscriber count (gated
    host-shape-independently by the port's ``check_bench_schema``, and
    ASSERTED here on every run).

    - ``standing_proofs_pushed_per_sec_{1k,10k}`` — acked webhook pushes
      per second of matching+fan-out wall time (instant opener: this
      measures the streaming plane, not a sink's network);
    - ``standing_delivery_lag_{p50,p99}_ms`` — per-delivery lag from the
      tipset's match cycle starting to its webhook landing, at 10k subs.

    Each generation's match runs on the card.
    """
    platform = _setup_platform(args)
    backend = _backend(platform)
    import random
    import shutil
    import tempfile
    import threading

    from ipc_proofs_tpu_torch.fixtures import build_range_world
    from ipc_proofs_tpu_torch.subs import StandingQueries
    from ipc_proofs_tpu_torch.utils.metrics import Metrics

    n_pairs = 3 if args.quick else 5
    receipts, match_rate = 8, 0.5
    store, pairs, _ = build_range_world(
        n_pairs, receipts_per_pair=receipts, match_rate=match_rate,
        signature=SIG, topic1=TOPIC1, actor_id=ACTOR,
    )
    filters = (
        {"signature": SIG, "topic1": TOPIC1},
        {"signature": SIG, "topic1": TOPIC1, "actor_id": ACTOR},
    )

    def measure(n_subs: int) -> dict:
        root = tempfile.mkdtemp(prefix="bench_standing_")
        m = Metrics()
        arrivals: "list[tuple[float, int]]" = []
        arrivals_lock = threading.Lock()

        def opener(url: str, body: bytes, timeout_s: float) -> int:
            tipset = json.loads(body)["tipset"]
            with arrivals_lock:
                arrivals.append((time.perf_counter(), tipset))
            return 200

        sq = StandingQueries(
            root, store=store, metrics=m, fsync=False, match_backend=backend,
            log_cap_bytes=1 << 30, push_max_inflight=8,
            opener=opener, sleep=lambda s: None, rng=random.Random(0),
        )
        try:
            for i in range(n_subs):
                sq.subscribe({
                    "filter": filters[i % len(filters)],
                    "target": {"mode": "webhook",
                               "url": f"http://sink.invalid/{i}"},
                })
            feed_t: "dict[int, float]" = {}
            t0 = time.perf_counter()
            for pair in pairs:
                feed_t[pair.child.height] = time.perf_counter()
                sq.matcher.match_pair(pair)
            sq.push.drain()  # wait for every webhook to land
            wall = time.perf_counter() - t0
            snap = m.snapshot()["counters"]
            lags_ms = sorted(
                (t - feed_t[ts]) * 1e3 for t, ts in arrivals
            )
            gens = snap.get("subs.generations", 0)
            tipsets = snap.get("subs.tipsets_matched", 0)
            gens_per_tipset = gens / tipsets if tipsets else None
            assert gens_per_tipset is not None and (
                gens_per_tipset <= len(filters)
            ), (
                f"standing leg: {gens_per_tipset} generations/tipset with "
                f"{len(filters)} distinct filters — fan-out did not amortize"
            )
            return {
                "pushed_per_sec": snap.get("subs.pushes", 0) / wall,
                "lags_ms": lags_ms,
                "gens_per_tipset": gens_per_tipset,
                "pushes": snap.get("subs.pushes", 0),
                "failures": snap.get("subs.push_failures", 0),
            }
        finally:
            sq.drain()
            shutil.rmtree(root, ignore_errors=True)

    r1k = measure(STANDING_SUBSCRIPTIONS[0])
    r10k = measure(STANDING_SUBSCRIPTIONS[1])
    assert not r1k["failures"] and not r10k["failures"], (
        "standing leg: instant-opener pushes must never exhaust retries"
    )

    def _pct(sorted_vals: "list[float]", q: float) -> "float | None":
        if not sorted_vals:
            return None
        return sorted_vals[int(q * (len(sorted_vals) - 1))]

    lag_p50 = _pct(r10k["lags_ms"], 0.50)
    lag_p99 = _pct(r10k["lags_ms"], 0.99)
    _log(
        f"bench: standing ({n_pairs} tipsets, {len(filters)} filters): "
        f"{r1k['pushed_per_sec']:,.0f} proofs pushed/s @1k subs, "
        f"{r10k['pushed_per_sec']:,.0f}/s @10k "
        f"(lag p50 {lag_p50:.1f} ms, p99 {lag_p99:.1f} ms; "
        f"{r10k['gens_per_tipset']:.1f} generations/tipset ≤ "
        f"{len(filters)} filters ✓)"
    )
    return {
        "standing_proofs_pushed_per_sec_1k": round(r1k["pushed_per_sec"], 1),
        "standing_proofs_pushed_per_sec_10k": round(r10k["pushed_per_sec"], 1),
        "standing_delivery_lag_p50_ms": (
            round(lag_p50, 3) if lag_p50 is not None else None
        ),
        "standing_delivery_lag_p99_ms": (
            round(lag_p99, 3) if lag_p99 is not None else None
        ),
        "standing_subscriptions": STANDING_SUBSCRIPTIONS[1],
        "standing_tipsets": n_pairs,
        "standing_distinct_filters": len(filters),
        "standing_generations_per_tipset": round(r10k["gens_per_tipset"], 3),
        "_platform": platform,
    }


def _leg_zerocopy(args) -> dict:
    """Zero-copy streaming wire + per-tenant QoS (hermetic).

    Phase 1 — streaming: a disk-tier-warm service answers ``/v1/generate``
    over the chunked binary stream wire. Block payloads must leave as
    mmap-backed `memoryview` slices of segment frames, so the tentpole
    meter ``warm_block_bytes_copied_per_resp`` (copied block-payload bytes
    per streamed response) must be EXACTLY 0 on every host — gated
    host-shape-independently by the port's ``check_bench_schema``. Also
    reports ``stream_ttfb_ms`` (p50 time-to-first-byte: request written →
    first response byte readable — the chunk-as-produced win the buffered
    path structurally cannot have).

    Phase 2 — QoS fairness: one heavy tenant saturates the generate
    batcher from ``qos_heavy_concurrency`` closed-loop threads while a
    light tenant sends occasional single requests. The batcher's
    deficit-round-robin tenant queues must bound the light tenant's
    ``qos_light_tenant_p99_ms`` near one batch's service time instead of
    the heavy backlog's drain time (``qos_heavy_backlog_drain_ms``);
    the schema gate checks the ratio and skips (with a printed reason)
    on hosts with ≤ 2 cores, where there is no parallelism for fairness
    to arbitrate.

    Both services run their engines on the card; the disk-tier service's
    start-up autotune measures its crossover there.
    """
    platform = _setup_platform(args)
    import os as _os
    import shutil
    import tempfile
    import threading

    from http.client import HTTPConnection

    from ipc_proofs_tpu_torch.fixtures import build_range_world
    from ipc_proofs_tpu_torch.proofs.generator import EventProofSpec
    from ipc_proofs_tpu_torch.serve import ProofService, ServiceConfig
    from ipc_proofs_tpu_torch.serve.httpd import ProofHTTPServer
    from ipc_proofs_tpu_torch.witness.stream import decode_bundle_stream

    n_pairs = 2 if args.quick else 4
    receipts = 8 if args.quick else 16
    store, pairs, _ = build_range_world(
        n_pairs, receipts_per_pair=receipts, events_per_receipt=2,
        match_rate=0.5, signature=SIG, topic1=TOPIC1, actor_id=ACTOR,
    )
    spec = EventProofSpec(
        event_signature=SIG, topic_1=TOPIC1, actor_id_filter=ACTOR
    )
    root = tempfile.mkdtemp(prefix="bench-zerocopy-")
    try:
        service = ProofService(
            store=store, spec=spec,
            config=ServiceConfig(
                max_batch=8, max_wait_ms=2.0, workers=2, store_dir=root,
                device=_device(platform),
            ),
        )
        httpd = ProofHTTPServer(service, pairs=pairs).start()

        def post(obj):
            conn = HTTPConnection("127.0.0.1", httpd.port, timeout=120)
            t0 = time.perf_counter()
            conn.request(
                "POST", "/v1/generate", json.dumps(obj),
                {"Content-Type": "application/json"},
            )
            resp = conn.getresponse()
            first = resp.read(1)
            ttfb_ms = (time.perf_counter() - t0) * 1e3
            data = first + resp.read()
            conn.close()
            return resp.status, data, ttfb_ms

        # warm pass: the buffered responses spill every block into the
        # disk tier's segment files — the frames the stream then slices
        for i in range(n_pairs):
            st, data, _ = post({"pair_index": i})
            assert st == 200, data[:200]

        reps = 16 if args.quick else 48
        c0 = service.metrics_snapshot()["counters"]
        ttfbs = []
        for r in range(reps):
            st, data, ttfb_ms = post({"pair_index": r % n_pairs, "stream": True})
            assert st == 200, data[:200]
            decode_bundle_stream(data)  # reassembly must verify, every time
            ttfbs.append(ttfb_ms)
        c1 = service.metrics_snapshot()["counters"]
        responses = c1.get("serve.stream.responses", 0) - c0.get(
            "serve.stream.responses", 0
        )
        copied = c1.get("serve.stream.copied_bytes", 0) - c0.get(
            "serve.stream.copied_bytes", 0
        )
        zero_copy = c1.get("serve.stream.zero_copy_bytes", 0) - c0.get(
            "serve.stream.zero_copy_bytes", 0
        )
        assert responses == reps, (responses, reps)
        ttfbs.sort()
        ttfb_p50 = ttfbs[len(ttfbs) // 2]
        httpd.shutdown(timeout=30)
        service.drain()

        # ---- phase 2: light tenant under a heavy tenant's flood ----------
        service = ProofService(
            store=store, spec=spec,
            config=ServiceConfig(max_batch=4, max_wait_ms=2.0, workers=2, device=_device(platform)),
        )
        heavy_threads = 6
        light_reps = 10 if args.quick else 25
        stop = threading.Event()
        heavy_done = []

        def heavy():
            n = 0
            while not stop.is_set():
                service.generate(pairs[n % n_pairs], tenant="bulk-heavy")
                n += 1
            heavy_done.append(n)

        threads = [
            threading.Thread(target=heavy) for _ in range(heavy_threads)
        ]
        for t in threads:
            t.start()
        time.sleep(0.3)  # let the heavy backlog establish
        light_lat = []
        for i in range(light_reps):
            t0 = time.perf_counter()
            service.generate(pairs[i % n_pairs], tenant="interactive-light")
            light_lat.append((time.perf_counter() - t0) * 1e3)
        t_drain0 = time.perf_counter()
        stop.set()
        for t in threads:
            t.join()
        drain_ms = (time.perf_counter() - t_drain0) * 1e3
        service.drain()
        light_lat.sort()
        light_p50 = light_lat[len(light_lat) // 2]
        light_p99 = light_lat[max(0, int(len(light_lat) * 0.99) - 1)]
        heavy_requests = sum(heavy_done)
        _log(
            f"bench: zerocopy: {responses} streamed responses, "
            f"{copied / max(1, responses):.1f} copied B/resp "
            f"({zero_copy / max(1, responses):,.0f} zero-copy B/resp), "
            f"ttfb p50 {ttfb_p50:.1f}ms; light tenant p50 {light_p50:.1f}ms "
            f"p99 {light_p99:.1f}ms beside {heavy_requests} heavy requests "
            f"from {heavy_threads} threads"
        )
        return {
            "warm_block_bytes_copied_per_resp": round(
                copied / max(1, responses), 2
            ),
            "stream_ttfb_ms": round(ttfb_p50, 2),
            "qos_light_tenant_p99_ms": round(light_p99, 2),
            "qos_light_tenant_p50_ms": round(light_p50, 2),
            "qos_heavy_backlog_drain_ms": round(drain_ms, 2),
            "zerocopy_bytes_per_resp": round(zero_copy / max(1, responses)),
            "zerocopy_responses": responses,
            "qos_heavy_concurrency": heavy_threads,
            "qos_heavy_requests": heavy_requests,
            "zerocopy_host_cpus": _os.cpu_count(),
            "_platform": platform,
        }
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _leg_hostkill(args) -> dict:
    """Multi-host kill/recovery (in-process shards with REAL
    replicated disk tiers): a 2-shard replication_factor=2 cluster.

    - ``replica_repair_hit_rate`` — every rolled frame on one shard's
      disk corrupted in place; fraction of the resulting integrity
      evictions absorbed by the replica plane (peer refetch) instead of
      falling through to the Lotus stand-in. Accounting over the shard's
      own ``storex.*`` counters;
    - ``aggregate_proofs_per_sec_2host`` — event proofs/s through the
      2-shard replicated router under a closed-loop client load;
    - ``kill_recovery_ms`` — one shard killed mid-load; ms from the kill
      until a FULL scatter over every pair completes byte-identical to
      the single-process driver (failover re-dispatch on the survivor).
      Byte-identity of every answer is ASSERTED here on every run; the
      numeric gates live in the port's ``check_bench_schema`` and skip
      with a printed reason on small hosts.

    Both shards run in this process on the one card; their recovery is
    one host's, not two machines'.
    """
    platform = _setup_platform(args)
    import shutil
    import tempfile
    import threading

    from ipc_proofs_tpu_torch.cluster import ClusterRouter, LocalShard
    from ipc_proofs_tpu_torch.fixtures import build_range_world
    from ipc_proofs_tpu_torch.proofs.generator import EventProofSpec
    from ipc_proofs_tpu_torch.proofs.range import generate_event_proofs_for_range_chunked
    from ipc_proofs_tpu_torch.serve.service import ServiceConfig
    from ipc_proofs_tpu_torch.utils.metrics import Metrics

    n_pairs = 8 if args.quick else args.cluster_pairs
    n_requests = 32 if args.quick else args.cluster_requests
    receipts, match_rate = 8, 0.25
    concurrency = 4

    store, pairs, _ = build_range_world(
        n_pairs, receipts_per_pair=receipts, match_rate=match_rate,
        signature=SIG, topic1=TOPIC1,
    )
    spec = EventProofSpec(event_signature=SIG, topic_1=TOPIC1)
    direct_json = json.dumps(
        generate_event_proofs_for_range_chunked(
            store, list(pairs), spec, chunk_size=8, match_backend=_backend(platform)
        ).to_json_obj(),
        sort_keys=True,
    )
    idxs = list(range(len(pairs)))

    workdir = tempfile.mkdtemp(prefix="bench_hostkill_")
    shard_metrics = [Metrics() for _ in range(2)]
    shards = [
        LocalShard(
            f"s{k}", store, pairs, spec,
            config=ServiceConfig(
                max_batch=8, max_wait_ms=5.0, workers=1,
                store_dir=os.path.join(workdir, f"s{k}"),
                store_owner=f"s{k}",
                store_segment_max_bytes=1,  # every spill rolls → replicable
                cache_max_bytes=1,  # force disk reads so corruption is seen
                device=_device(platform),
            ),
            metrics=shard_metrics[k],
        ).start()
        for k in range(2)
    ]
    m = Metrics()
    router = ClusterRouter(
        {sh.name: sh.url for sh in shards}, pairs,
        replication_factor=2, metrics=m, scrape_interval_s=60.0,
    )
    try:
        # warm the tier (spill every witness block), then mirror it
        status, obj = router.generate_range(idxs, chunk_size=8)
        assert status == 200, obj
        assert json.dumps(obj["bundle"], sort_keys=True) == direct_json
        summary = router.replicate_now()
        assert not summary["errors"], summary

        # read-repair: corrupt EVERY rolled frame on s0's disk in place
        s0_dir = os.path.join(workdir, "s0")
        flipped = 0
        for name in sorted(os.listdir(s0_dir)):
            if name.endswith(".blk"):
                path = os.path.join(s0_dir, name)
                size = os.path.getsize(path)
                with open(path, "r+b") as fh:
                    fh.seek(size - 1)
                    b = fh.read(1)
                    fh.seek(size - 1)
                    fh.write(bytes([b[0] ^ 0x40]))
                flipped += 1
        status, obj = router.generate_range(idxs, chunk_size=8)
        assert status == 200, obj
        assert json.dumps(obj["bundle"], sort_keys=True) == direct_json, (
            "post-corruption scatter diverged"
        )
        c0 = shard_metrics[0].snapshot()["counters"]
        repairs = c0.get("storex.replica_repairs", 0)
        misses = c0.get("storex.replica_repair_misses", 0)
        hit_rate = repairs / (repairs + misses) if (repairs + misses) else None

        # closed-loop load through the replicated pair → aggregate rate
        def load(n: int, failures: list, proofs: list):
            it = iter(range(n))
            it_lock = threading.Lock()

            def client():
                while True:
                    with it_lock:
                        i = next(it, None)
                    if i is None:
                        return
                    status, obj = router.generate(i % len(pairs))
                    if status != 200:
                        failures.append((i, obj))
                        return
                    with it_lock:
                        proofs[0] += obj["n_event_proofs"]

            threads = [
                threading.Thread(target=client) for _ in range(concurrency)
            ]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            return time.perf_counter() - t0

        failures: list = []
        proofs = [0]
        wall = load(n_requests, failures, proofs)
        assert not failures, f"hostkill leg: {len(failures)} load failures"
        agg_2host = proofs[0] / wall

        # kill one host mid-load; time until a full scatter is whole again
        killer = threading.Timer(wall * 0.25, shards[1].kill)
        failures2: list = []
        killer.start()
        load_thread = threading.Thread(
            target=lambda: load(n_requests, failures2, [0])
        )
        load_thread.start()
        killer.join()
        t_kill = time.perf_counter()
        recovery_ms = None
        deadline = t_kill + 60.0
        while time.perf_counter() < deadline:
            status, obj = router.generate_range(idxs, chunk_size=8)
            if status == 200 and json.dumps(
                obj["bundle"], sort_keys=True
            ) == direct_json:
                recovery_ms = (time.perf_counter() - t_kill) * 1000.0
                break
        load_thread.join()
        assert recovery_ms is not None, "no identical scatter within 60s of kill"
        assert not failures2, (
            f"hostkill leg: {len(failures2)} wrong answers after kill"
        )
        failovers = m.snapshot()["counters"].get("cluster.shard_failovers", 0)
    finally:
        router.close()
        for sh in shards:
            try:
                sh.stop(timeout=10)
            except Exception:
                pass
        shutil.rmtree(workdir, ignore_errors=True)

    _log(
        f"bench: hostkill ({n_pairs} pairs, {n_requests} reqs): "
        f"{agg_2host:,.0f} proofs/s @2 replicated shards; {flipped} frames "
        f"corrupted → repair hit rate {hit_rate}; kill→whole in "
        f"{recovery_ms:,.0f} ms ({failovers} failovers); byte-identical ✓"
    )
    return {
        "aggregate_proofs_per_sec_2host": round(agg_2host, 1),
        "replica_repair_hit_rate": (
            round(hit_rate, 4) if hit_rate is not None else None
        ),
        "kill_recovery_ms": round(recovery_ms, 1),
        "hostkill_pairs": n_pairs,
        "hostkill_requests": n_requests,
        "hostkill_failovers": int(failovers),
        "_platform": platform,
    }


def _leg_overload(args) -> dict:
    """Overload survival (hermetic): a closed loop at ~2× the
    measured capacity against an ``--admit-gradient`` HTTP front end.

    Phase 1 measures capacity: C client threads, think-time 0. Phase 2
    doubles the thread count and adds (a) a light named tenant sending
    occasional requests and (b) a doomed stream of tight-deadline
    requests that must be refused/cancelled BEFORE burning a worker.

    The meters the schema gates ride on:

    - ``goodput_ratio_at_2x``: successful-response rate under 2× offered
      load / capacity rate. A serve plane that degrades gracefully sheds
      the excess and keeps doing its capacity's worth of real work
      (gated ≥ 0.8; skipped with a printed reason on ≤ 2-core hosts);
    - ``shed_rate``: fraction of overload-phase requests answered 429
      (tenant bucket or AIMD admission) — honest shedding, not queuing;
    - ``light_tenant_p99_ms_overload``: the named tenant's p99 while the
      anonymous pool floods — grace headroom + shed-other-first;
    - ``cancel_reclaim_pct``: of the doomed tight-deadline requests, the
      percentage whose work was reclaimed (refused at the door or
      dropped at dispatch) instead of generated-then-thrown-away.

    Shed 429 responses make a closed loop spin faster than real clients
    would; overload clients honor the response's Retry-After estimate up
    to 50 ms so the offered load stays ~2× rather than unbounded. The
    service's engines run on the card."""
    platform = _setup_platform(args)
    import os as _os
    import threading

    from http.client import HTTPConnection

    from ipc_proofs_tpu_torch.fixtures import build_range_world
    from ipc_proofs_tpu_torch.proofs.generator import EventProofSpec
    from ipc_proofs_tpu_torch.serve import ProofService, ServiceConfig
    from ipc_proofs_tpu_torch.serve.httpd import ProofHTTPServer

    n_pairs = 2 if args.quick else 4
    receipts = 8 if args.quick else 12
    store, pairs, _ = build_range_world(
        n_pairs, receipts_per_pair=receipts, events_per_receipt=2,
        match_rate=0.5, signature=SIG, topic1=TOPIC1, actor_id=ACTOR,
    )
    spec = EventProofSpec(
        event_signature=SIG, topic_1=TOPIC1, actor_id_filter=ACTOR
    )
    service = ProofService(
        store=store, spec=spec,
        config=ServiceConfig(
            max_batch=8, max_wait_ms=2.0, workers=2,
            admit_gradient=True, admit_initial=8,
            admit_delay_budget_ms=75.0,
            tenant_weights={"interactive": 4},
            device=_device(platform),
        ),
    )
    httpd = ProofHTTPServer(service, pairs=pairs).start()

    def post(obj, headers=None):
        conn = HTTPConnection("127.0.0.1", httpd.port, timeout=120)
        hdrs = {"Content-Type": "application/json"}
        if headers:
            hdrs.update(headers)
        try:
            conn.request("POST", "/v1/generate", json.dumps(obj), hdrs)
            resp = conn.getresponse()
            data = resp.read()
            return resp.status, data
        finally:
            conn.close()

    for i in range(n_pairs):  # warm every pair through the batcher once
        st, data = post({"pair_index": i})
        assert st == 200, data[:200]

    # ---- phase 1: capacity at C threads ------------------------------------
    cap_threads = 4
    cap_requests = 48 if args.quick else 128
    it = iter(range(cap_requests))
    it_lock = threading.Lock()

    def cap_client():
        while True:
            with it_lock:
                i = next(it, None)
            if i is None:
                return
            st, data = post({"pair_index": i % n_pairs})
            assert st == 200, data[:200]

    threads = [threading.Thread(target=cap_client) for _ in range(cap_threads)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    capacity_rps = cap_requests / (time.perf_counter() - t0)

    # ---- phase 2: 2× closed loop + light tenant + doomed deadlines ---------
    c0 = service.metrics_snapshot()["counters"]
    duration_s = 2.0 if args.quick else 4.0
    stop = threading.Event()
    ok_count = [0]
    shed_count = [0]
    other_count = [0]
    count_lock = threading.Lock()

    def heavy_client():
        while not stop.is_set():
            st, data = post({"pair_index": 0})
            with count_lock:
                if st == 200:
                    ok_count[0] += 1
                elif st == 429:
                    shed_count[0] += 1
                else:
                    other_count[0] += 1
            if st == 429:
                try:
                    retry = float(json.loads(data).get("retry_after_s", 0.05))
                except (ValueError, AttributeError):
                    retry = 0.05
                stop.wait(min(retry, 0.05))

    light_lat: "list[float]" = []

    def light_client():
        while not stop.is_set():
            t0 = time.perf_counter()
            st, _ = post(
                {"pair_index": 1 % n_pairs},
                headers={"X-IPC-Tenant": "interactive"},
            )
            if st == 200:
                light_lat.append((time.perf_counter() - t0) * 1e3)
            stop.wait(0.02)

    doomed = [0]

    def doomed_client():
        # alternate below-floor (refused at the door, 5 ms default floor)
        # and mid-expiry budgets (admitted, then dropped at dispatch once
        # the overload queue delay eats the remainder)
        n = 0
        while not stop.is_set():
            ms = 1 if n % 2 == 0 else 15
            post({"pair_index": 0, "deadline_ms": ms})
            doomed[0] += 1
            n += 1
            stop.wait(0.03)

    workers = [
        threading.Thread(target=heavy_client) for _ in range(2 * cap_threads)
    ] + [threading.Thread(target=light_client), threading.Thread(target=doomed_client)]
    t0 = time.perf_counter()
    for t in workers:
        t.start()
    time.sleep(duration_s)
    stop.set()
    for t in workers:
        t.join()
    elapsed = time.perf_counter() - t0
    snap = service.metrics_snapshot()
    c1 = snap["counters"]
    admit_limit = snap.get("gauges", {}).get("admit.limit")
    httpd.shutdown(timeout=30)
    service.drain()

    goodput_rps = ok_count[0] / elapsed
    goodput_ratio = goodput_rps / capacity_rps if capacity_rps else None
    answered = ok_count[0] + shed_count[0] + other_count[0]
    shed_rate = shed_count[0] / answered if answered else None
    light_lat.sort()
    light_p99 = (
        light_lat[max(0, int(len(light_lat) * 0.99) - 1)] if light_lat else None
    )
    reclaimed = (
        c1.get("serve.deadline_rejects", 0) - c0.get("serve.deadline_rejects", 0)
        + c1.get("serve.cancelled_inflight", 0)
        - c0.get("serve.cancelled_inflight", 0)
    )
    cancel_reclaim_pct = (
        round(100.0 * min(1.0, reclaimed / doomed[0]), 1) if doomed[0] else None
    )
    _log(
        f"bench: overload: capacity {capacity_rps:,.0f} req/s, goodput at 2x "
        f"{goodput_rps:,.0f} req/s (ratio "
        f"{goodput_ratio if goodput_ratio is None else round(goodput_ratio, 2)}), "
        f"shed {shed_count[0]}/{answered}, light p99 "
        f"{light_p99 if light_p99 is None else round(light_p99, 1)}ms, "
        f"{reclaimed}/{doomed[0]} doomed reclaimed"
    )
    return {
        "goodput_ratio_at_2x": (
            round(goodput_ratio, 3) if goodput_ratio is not None else None
        ),
        "shed_rate": round(shed_rate, 3) if shed_rate is not None else None,
        "light_tenant_p99_ms_overload": (
            round(light_p99, 2) if light_p99 is not None else None
        ),
        "cancel_reclaim_pct": cancel_reclaim_pct,
        "overload_capacity_rps": round(capacity_rps, 1),
        "overload_goodput_rps": round(goodput_rps, 1),
        "overload_requests": answered,
        "overload_doomed_requests": doomed[0],
        "overload_admit_limit_final": admit_limit,
        "overload_host_cpus": _os.cpu_count(),
        "_platform": platform,
    }


def _leg_registry(args) -> dict:
    """Proof provenance plane (hermetic): what the audit
    registry costs and what the fleet base directory buys.

    Three meters:

    - ``registry_append_overhead_pct``: one sealed IPR1 frame per served
      bundle, as a percentage of the request it rides on. Measured as a
      ratio of two costs on the SAME host — the direct per-append wall
      cost (a realistic serve record with a CID set, buffered write, no
      fsync) over the mean buffered ``/v1/generate`` request with the
      registry enabled — so the gate (< 1%) is host-shape independent:
      both numerator and denominator scale with the same machine.
    - ``registry_inclusion_proof_ms``: mean wall time to generate AND
      verify an O(log n) inclusion proof against the live root over a
      multi-thousand-record chain — the audit path's cost.
    - ``fleet_delta_hit_rate`` vs ``fleet_delta_baseline_hit_rate``: a
      4-shard scatter appends serve records + base acks to one shared
      registry dir, then every base lookup lands on a RANDOM shard (the
      failover case). The baseline is each shard's private
      `WitnessBaseCache` (hits only when the lookup happens to land on
      the serving shard, ~1/shards); the fleet directory answers from
      ANY shard's records (gated strictly above the baseline).

    The served requests' engines run on the card.
    """
    platform = _setup_platform(args)
    import hashlib as _hashlib
    import random as _random
    import tempfile

    from http.client import HTTPConnection

    from ipc_proofs_tpu_torch.fixtures import build_range_world
    from ipc_proofs_tpu_torch.proofs.generator import EventProofSpec
    from ipc_proofs_tpu_torch.registry import ProvenanceRegistry
    from ipc_proofs_tpu_torch.registry.mmr import verify_inclusion
    from ipc_proofs_tpu_torch.serve import ProofService, ServiceConfig
    from ipc_proofs_tpu_torch.serve.httpd import ProofHTTPServer
    from ipc_proofs_tpu_torch.witness.bases import WitnessBaseCache

    rng = _random.Random(20260807)

    def _digest(tag):
        return _hashlib.sha256(tag.encode()).hexdigest()

    def _cids(tag, k=3):
        return frozenset(
            _hashlib.sha256(f"{tag}-cid-{j}".encode()).digest() for j in range(k)
        )

    # ---- phase 1: append overhead as a fraction of a served request --------
    n_pairs = 2 if args.quick else 4
    receipts = 8 if args.quick else 12
    store, pairs, _ = build_range_world(
        n_pairs, receipts_per_pair=receipts, events_per_receipt=2,
        match_rate=0.5, signature=SIG, topic1=TOPIC1, actor_id=ACTOR,
    )
    spec = EventProofSpec(
        event_signature=SIG, topic_1=TOPIC1, actor_id_filter=ACTOR
    )
    serve_requests = 32 if args.quick else 96
    with tempfile.TemporaryDirectory(prefix="bench-registry-") as reg_dir:
        service = ProofService(
            store=store, spec=spec,
            config=ServiceConfig(
                max_batch=8, max_wait_ms=2.0, workers=2,
                registry_dir=reg_dir, registry_owner="bench",
                device=_device(platform),
            ),
        )
        httpd = ProofHTTPServer(service, pairs=pairs).start()

        def post(obj):
            conn = HTTPConnection("127.0.0.1", httpd.port, timeout=120)
            try:
                conn.request(
                    "POST", "/v1/generate", json.dumps(obj),
                    {"Content-Type": "application/json"},
                )
                resp = conn.getresponse()
                data = resp.read()
                return resp.status, data
            finally:
                conn.close()

        for i in range(n_pairs):  # warm every pair through the batcher once
            st, data = post({"pair_index": i})
            assert st == 200, data[:200]
        t0 = time.perf_counter()
        for i in range(serve_requests):
            st, data = post({"pair_index": i % n_pairs})
            assert st == 200, data[:200]
        serve_mean_s = (time.perf_counter() - t0) / serve_requests
        head = service.registry.head()
        assert head["size"] >= serve_requests, head  # every response sealed
        httpd.shutdown(timeout=30)
        service.drain()

    # the numerator: the same append the serve path pays, microbenched
    # directly (buffered write + chain link + tree append, no fsync)
    append_n = 512 if args.quick else 2048
    with tempfile.TemporaryDirectory(prefix="bench-registry-") as reg_dir:
        reg = ProvenanceRegistry(reg_dir, owner="bench")
        t0 = time.perf_counter()
        for i in range(append_n):
            reg.append_served(
                _digest(f"append-{i}"), trace=f"trace-{i}", tenant="bench",
                key=f"pair:{i % 8}", verdict="served", cids=_cids(f"append-{i}"),
            )
        append_mean_s = (time.perf_counter() - t0) / append_n
        append_overhead_pct = 100.0 * append_mean_s / serve_mean_s

        # ---- phase 2: inclusion-proof latency over the same chain ----------
        proof_n = 64 if args.quick else 200
        seqs = [rng.randrange(append_n) for _ in range(proof_n)]
        t0 = time.perf_counter()
        for seq in seqs:
            proof = reg.inclusion_proof(seq)
            assert verify_inclusion(
                bytes.fromhex(proof["leaf"]), proof["seq"], proof["size"],
                [bytes.fromhex(h) for h in proof["path"]],
                bytes.fromhex(proof["root"]),
            ), proof["seq"]
        inclusion_ms = 1000.0 * (time.perf_counter() - t0) / proof_n
        reg.close()

    # ---- phase 3: fleet base directory vs per-shard caches -----------------
    shards = 4
    filters = 16 if args.quick else 32
    epochs = 4
    with tempfile.TemporaryDirectory(prefix="bench-registry-") as fleet_dir:
        regs = [
            ProvenanceRegistry(fleet_dir, owner=f"shard-{s}")
            for s in range(shards)
        ]
        caches = [WitnessBaseCache(cap=filters * epochs) for _ in range(shards)]
        last = {}
        for e in range(epochs):
            for f in range(filters):
                s = rng.randrange(shards)
                digest = _digest(f"fleet-f{f}-e{e}")
                cids = _cids(f"fleet-f{f}-e{e}")
                regs[s].append_served(
                    digest, key=f"filter:{f}", verdict="pushed", cids=cids
                )
                regs[s].append_base_ack(
                    "bench", f"filter:{f}", f"sub-{f}", digest, e
                )
                caches[s].register(digest, cids)
                last[f] = digest
        fleet_hits = baseline_hits = 0
        for f in range(filters):
            lk = rng.randrange(shards)  # the shard failover lands on
            if caches[lk].lookup(last[f]) is not None:
                baseline_hits += 1
            d = regs[lk].fleet_acked_base("bench", f"filter:{f}", f"sub-{f}")
            if d == last[f] and regs[lk].lookup_base(d) is not None:
                fleet_hits += 1
        for reg in regs:
            reg.close()
    fleet_rate = fleet_hits / filters
    baseline_rate = baseline_hits / filters

    _log(
        f"bench: registry: append {append_mean_s * 1e6:,.1f}us over "
        f"{serve_mean_s * 1e3:,.1f}ms/request = "
        f"{append_overhead_pct:.3f}% overhead, inclusion proof "
        f"{inclusion_ms:.2f}ms @ {append_n} records, fleet base hit rate "
        f"{fleet_rate:.2f} vs per-shard {baseline_rate:.2f}"
    )
    return {
        "registry_append_overhead_pct": round(append_overhead_pct, 4),
        "registry_append_us": round(append_mean_s * 1e6, 2),
        "registry_inclusion_proof_ms": round(inclusion_ms, 3),
        "fleet_delta_hit_rate": round(fleet_rate, 3),
        "fleet_delta_baseline_hit_rate": round(baseline_rate, 3),
        "registry_chain_records": append_n,
        "registry_serve_requests": serve_requests,
        "registry_shards": shards,
        "registry_lookups": filters,
        "_platform": platform,
    }


_LEG_FNS = {
    "e2e": _leg_e2e,
    "kernel": _leg_kernel,
    "cid": _leg_cid,
    "baseline": _leg_baseline,
    "native_baseline": _leg_native_baseline,
    "serve": _leg_serve,
    "witness": _leg_witness,
    "resilience": _leg_resilience,
    "durability": _leg_durability,
    "observability": _leg_observability,
    "storage": _leg_storage,
    "asyncfetch": _leg_asyncfetch,
    "cluster": _leg_cluster,
    "standing": _leg_standing,
    "fleetobs": _leg_fleetobs,
    "onchip": _leg_onchip,
    "backfill": _leg_backfill,
    "zerocopy": _leg_zerocopy,
    "hostkill": _leg_hostkill,
    "overload": _leg_overload,
    "registry": _leg_registry,
}


# --------------------------------------------------------------------------
# shared measurement helpers
# --------------------------------------------------------------------------


def _staged_verify(bundle, backend):
    """Offline verification with per-stage timers; returns (results, stages).
    The witness CIDs and the replay's TxMeta CIDs recompute on ``backend``."""
    from ipc_proofs_tpu_torch.core.cid import BLAKE2B_256
    from ipc_proofs_tpu_torch.proofs.bundle import EventProofBundle
    from ipc_proofs_tpu_torch.proofs.event_verifier import verify_event_proof
    from ipc_proofs_tpu_torch.proofs.witness import load_witness_store

    stages = {}
    t0 = time.perf_counter()
    batch = [b for b in bundle.blocks if b.cid.mh_code == BLAKE2B_256]
    if batch and not backend.verify_block_cids(
        [b.cid.digest for b in batch], [b.data for b in batch]
    ):
        raise ValueError("witness CID mismatch")
    stages["verify_cids"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    store = load_witness_store(bundle.blocks, verify_cids=False)
    stages["load_witness"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    results = verify_event_proof(
        EventProofBundle(proofs=bundle.event_proofs, blocks=bundle.blocks),
        lambda e, c: True,
        lambda e, c: True,
        store=store,
        hash_backend=backend,
    )
    stages["verify_replay"] = time.perf_counter() - t0
    return results, stages


class _HostHashes:
    """The baselines' host engine: the `BatchHashBackend` seam on hashlib's C
    blake2b-256 and ``core/hashes.py``'s keccak-256, with the reference CPU
    backend's per-event Python predicate and its numpy fingerprint mask.
    It exists for the two baselines only — they are host-only by design —
    and no entry point of the package takes it: the port's own backend is
    the card (or the kernels' plain versions, which would make a slow
    baseline)."""

    name = "host"
    mesh = None  # single-host: the range drivers fuse the match into the C scan

    def warm(self) -> None:
        pass

    def keccak256_batch(self, messages):
        from ipc_proofs_tpu_torch.core.hashes import keccak256

        return [keccak256(m) for m in messages]

    def blake2b256_batch(self, messages):
        from ipc_proofs_tpu_torch.core.hashes import blake2b_256

        return [blake2b_256(m) for m in messages]

    def verify_block_cids(self, cids_digests, blocks) -> bool:
        from ipc_proofs_tpu_torch.core.hashes import blake2b_256

        return all(blake2b_256(block) == digest for digest, block in zip(cids_digests, blocks))

    def event_match_mask(self, events, topic0, topic1, actor_id_filter):
        from ipc_proofs_tpu_torch.state.events import extract_evm_log

        mask = []
        for stamped in events:
            if actor_id_filter is not None and stamped.emitter != actor_id_filter:
                mask.append(False)
                continue
            log = extract_evm_log(stamped.event)
            mask.append(
                log is not None
                and len(log.topics) >= 2
                and log.topics[0] == topic0
                and log.topics[1] == topic1
            )
        return mask

    def event_match_mask_fp(self, fp, n_topics, emitters, valid, topic0, topic1, actor_id_filter):
        from ipc_proofs_tpu_torch.proofs.scan_native import match_mask_fp_np

        return match_mask_fp_np(fp, n_topics, emitters, valid, topic0, topic1, actor_id_filter)

    def any_event_matches(self, events, topic0, topic1, actor_id_filter) -> bool:
        return any(self.event_match_mask(events, topic0, topic1, actor_id_filter))


class _ScalarStore:
    """An in-memory store seen without its raw block map: the range driver
    then takes the Python scan and the per-event predicate (the scalar
    architecture), as the reference's does with ``match_backend=None``."""

    def __init__(self, inner):
        self._inner = inner

    def get(self, cid):
        return self._inner.get(cid)

    def put_keyed(self, cid, data) -> None:
        self._inner.put_keyed(cid, data)

    def has(self, cid) -> bool:
        return self._inner.has(cid)


def _scalar_baseline(n_pairs_sample: int, receipts: int, events: int) -> float:
    """Reference-architecture e2e rate (proofs/s): single thread, per-event
    Python decode + match (events/generator.rs:217-239 shape), scalar
    verify with per-proof replay, scalar CID recompute. Measured on a small
    subrange; rates are per-pair-linear so the rate transfers.

    Runs under `force_python_decoder` over `_ScalarStore` on `_HostHashes`
    so the baseline is genuinely the Python scalar loop — without them the
    C DAG-CBOR extension and the C scanner accelerate the baseline too,
    and the reported multiple tracks the extension's build flags rather
    than the batch/fusion design. The compiled-language comparison lives
    in ``vs_native_baseline``."""
    from ipc_proofs_tpu_torch.fixtures import build_range_world
    from ipc_proofs_tpu_torch.proofs.bundle import EventProofBundle
    from ipc_proofs_tpu_torch.proofs.event_verifier import verify_event_proof
    from ipc_proofs_tpu_torch.proofs.generator import EventProofSpec
    from ipc_proofs_tpu_torch.proofs.range import generate_event_proofs_for_range
    from ipc_proofs_tpu_torch.proofs.witness import load_witness_store

    import gc

    from ipc_proofs_tpu_torch.core.dagcbor import force_python_decoder

    bs, pairs, _ = build_range_world(
        n_pairs_sample, receipts, events, base_height=10_000_000
    )
    spec = EventProofSpec(event_signature=SIG, topic_1=TOPIC1, actor_id_filter=ACTOR)
    host = _HostHashes()
    # best-of-2 with GC settled — the same steady-state methodology the
    # headline number uses, so the ratio doesn't swing with one-off GC
    # pauses on small hosts
    best = 0.0
    for _ in range(2):
        gc.collect()
        start = time.perf_counter()
        with force_python_decoder():
            bundle = generate_event_proofs_for_range(_ScalarStore(bs), pairs, spec, match_backend=host)
            # scalar verify, explicitly: per-block CID recompute on load and
            # the per-proof replay loop (batch=False) — the batch verifier is
            # this framework's own machinery, not the reference architecture's
            store = load_witness_store(bundle.blocks, verify_cids=True)
            results = verify_event_proof(
                EventProofBundle(proofs=bundle.event_proofs, blocks=bundle.blocks),
                lambda e, c: True,
                lambda e, c: True,
                store=store,
                batch=False,
                hash_backend=host,
            )
        elapsed = time.perf_counter() - start
        assert all(results) and len(results) == len(bundle.event_proofs)
        if elapsed > 0:
            best = max(best, len(bundle.event_proofs) / elapsed)
    return best


def _native_baseline(n_pairs_sample: int, receipts: int, events: int) -> float:
    """Language-fair baseline (proofs/s): the REFERENCE ARCHITECTURE — one
    (parent, child) pair per invocation, sequential over pairs
    (`src/proofs/generator.rs:43-78` runs specs in a plain loop) — but with
    every hot primitive on compiled C paths on the host (the port's native
    scanner and pass-2 walkers, C dag-cbor, hashlib's C hashes: the
    `_HostHashes` engine, where the reference uses its CPU backend's C++
    batch hashes). What it deliberately lacks is the range-level design:
    cross-pair batching, one fused match over the whole range, range-wide
    witness dedup, phase overlap, and the card. ``vs_native_baseline``
    therefore isolates the architectural win from the Python-vs-compiled
    language gap that ``vs_baseline`` (scalar Python reference loop)
    folds in."""
    from ipc_proofs_tpu_torch.fixtures import build_range_world
    from ipc_proofs_tpu_torch.proofs.generator import EventProofSpec
    from ipc_proofs_tpu_torch.proofs.range import generate_event_proofs_for_range
    from ipc_proofs_tpu_torch.proofs.trust import TrustPolicy
    from ipc_proofs_tpu_torch.proofs.verifier import verify_proof_bundle

    bs, pairs, _ = build_range_world(
        n_pairs_sample, receipts, events, base_height=20_000_000
    )
    spec = EventProofSpec(event_signature=SIG, topic_1=TOPIC1, actor_id_filter=ACTOR)
    import gc

    host = _HostHashes()
    # warm the native extensions (build/load outside the measured region)
    generate_event_proofs_for_range(bs, [pairs[0]], spec, match_backend=host)
    best = 0.0
    for _ in range(2):  # best-of-2, GC settled (headline methodology)
        gc.collect()
        start = time.perf_counter()
        n = 0
        for pair in pairs:  # one pair per invocation, like the reference binary
            bundle = generate_event_proofs_for_range(bs, [pair], spec, match_backend=host)
            result = verify_proof_bundle(
                bundle, TrustPolicy.accept_all(), verify_witness_cids=True, cid_backend=host
            )
            assert result.all_valid()
            n += len(bundle.event_proofs)
        elapsed = time.perf_counter() - start
        if elapsed > 0:
            best = max(best, n / elapsed)
    return best


# --------------------------------------------------------------------------
# orchestrator
# --------------------------------------------------------------------------


# every headline key the e2e leg emits — the total-failure fallback nulls
# exactly this schema so consumers can always index the full key set
_E2E_SCHEMA_KEYS = (
    "value", "platform", "devices", "host_cores", "host_cores_affinity",
    "scan_threads", "record_workers", "verify_workers", "effective_threads",
    "native_scan_threads", "pipeline_depth",
    "pipeline_chunk", "events_per_sec_e2e", "proofs", "stages_ms",
    "stages_wall_ms", "stages_overlap", "gen_verify_overlap",
    "overlap_efficiency", "serial_proofs_per_sec", "serial_e2e_reps_s",
    "pipeline_speedup_vs_serial", "e2e_policy", "e2e_reps_s",
)


def worst_case_seconds(quick: bool, mult: float = 1.0) -> float:
    """Upper bound on one orchestrated run's leg-watchdog spend: every leg
    burning its full timeout (nothing reruns: there is no CPU retry).
    Callers wrapping the bench in their own subprocess timeout should bound
    ABOVE this so the orchestrator's degraded-but-honest JSON always gets
    to print."""
    idx = 1 if quick else 0
    return sum(t[idx] for t in _LEG_TIMEOUTS.values()) * mult


def _leg_timeout(name: str, args) -> float:
    full, quick = _LEG_TIMEOUTS[name]
    return (quick if args.quick else full) * args.leg_timeout_mult


def _spawn_leg(cmd: "list[str]", timeout: float) -> subprocess.CompletedProcess:
    """Run one leg's process in a session of its own, its stdout captured
    and its stderr streamed through. At the watchdog's timeout the whole
    session is killed — the leg and any shard process it started — and
    `subprocess.TimeoutExpired` raised."""
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=None, text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    return subprocess.CompletedProcess(cmd, proc.returncode, out, None)


def _run_leg(name: str, args, platform: str) -> tuple:
    """Run one leg in a watchdogged subprocess; returns (dict|None, status).

    status: 'ok' | 'timeout' | 'error'. Child stderr streams through to
    this process's stderr; stdout's last line is the leg's JSON dict."""
    cmd = [
        sys.executable, os.path.abspath(__file__),
        "--leg", name,
        "--platform", platform,
        "--tipsets", str(args.tipsets),
        "--receipts", str(args.receipts),
        "--events", str(args.events),
        "--match-rate", str(args.match_rate),
        "--kernel-iters", str(args.kernel_iters),
        "--baseline-pairs", str(args.baseline_pairs),
        "--probe-timeout", str(args.probe_timeout),
        "--e2e-reps", str(args.e2e_reps),
        "--serve-requests", str(args.serve_requests),
        "--serve-concurrency", str(args.serve_concurrency),
        "--pipeline-depth", str(args.pipeline_depth),
    ]
    if args.scan_threads is not None:
        cmd += ["--scan-threads", str(args.scan_threads)]
    if args.threads is not None:
        cmd += ["--threads", str(args.threads)]
    if args.quick:
        cmd.append("--quick")
    if args.profile and name == "e2e":
        cmd += ["--profile", args.profile]
    timeout = _leg_timeout(name, args)
    t0 = time.monotonic()
    try:
        proc = _spawn_leg(cmd, timeout)
    except subprocess.TimeoutExpired:
        _log(f"bench: leg {name!r} ({platform}) WATCHDOG TIMEOUT after {timeout:.0f}s")
        return None, f"timeout:{platform}"
    elapsed = time.monotonic() - t0
    if proc.returncode != 0:
        _log(f"bench: leg {name!r} ({platform}) exited rc={proc.returncode}")
        return None, f"error:{platform}"
    try:
        lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
        out = json.loads(lines[-1])
    except (IndexError, ValueError) as exc:
        _log(f"bench: leg {name!r} produced unparseable output ({exc})")
        return None, f"error:{platform}"
    # the leg reports what it REALLY ran on ('_platform'); status strings
    # carry that, so a CPU number can't masquerade as the card's in the
    # artifact
    actual = out.pop("_platform", platform)
    _log(f"bench: leg {name!r} ({actual}) done in {elapsed:.0f}s")
    return out, f"ok:{actual}"


# the legs in the order the orchestrator runs them: the main path and the
# kernels first, then the baselines, the serve plane and the router
ORCHESTRATED_LEGS = (
    "e2e", "kernel", "cid", "onchip", "baseline", "native_baseline",
    "serve", "witness", "resilience", "durability", "observability",
    "storage", "asyncfetch", "cluster", "standing", "fleetobs", "backfill",
    "zerocopy", "hostkill", "overload", "registry",
)


def _orchestrate(args) -> int:
    """Run every leg under a watchdog; assemble and print the one JSON line.

    Returns the process's exit code: 0 only when every leg's status is
    ``ok:<platform>``. Nothing reruns and nothing moves to the CPU: a leg
    that stalls or fails keeps its status and its keys are nulled (the
    reference reruns a stalled e2e on the CPU and downgrades the remaining
    device legs, ``watchdog_fallback``; here that key is always False).
    ``--platform auto`` without a card raises from the probe before any
    leg runs."""
    from ipc_proofs_tpu_torch.utils import platform as _plat

    platform = _plat.pick_platform(args.platform, args.probe_timeout, log=_log)

    legs_status: dict[str, str] = {}
    results: dict = {}
    for name in ORCHESTRATED_LEGS:
        results[name], legs_status[name] = _run_leg(name, args, platform)
    e2e = results["e2e"]
    if e2e is None:
        # emit an honest artifact anyway, with the FULL headline schema
        # nulled (consumers index these keys)
        e2e = {
            "metric": "event_proofs_per_sec_4k_range_e2e",
            "unit": "proofs/s",
            **{k: None for k in _E2E_SCHEMA_KEYS},
        }
    kernel, cid, onchip = results["kernel"], results["cid"], results["onchip"]
    baseline, native = results["baseline"], results["native_baseline"]
    serve, witness = results["serve"], results["witness"]
    resilience, durability = results["resilience"], results["durability"]
    observability, storage = results["observability"], results["storage"]
    asyncfetch, cluster = results["asyncfetch"], results["cluster"]
    standing, fleetobs = results["standing"], results["fleetobs"]
    backfill, zerocopy = results["backfill"], results["zerocopy"]
    hostkill, overload = results["hostkill"], results["overload"]
    registry = results["registry"]

    scalar_rate = (baseline or {}).get("scalar_baseline_proofs_per_sec")
    native_rate = (native or {}).get("native_baseline_proofs_per_sec")
    value = e2e.get("value")

    out = dict(e2e)
    out["vs_baseline"] = (
        round(value / scalar_rate, 2) if value and scalar_rate else None
    )
    out["vs_native_baseline"] = (
        round(value / native_rate, 2) if value and native_rate else None
    )
    out["scalar_baseline_proofs_per_sec"] = scalar_rate
    out["native_baseline_proofs_per_sec"] = native_rate
    out["device_mask_kernel_events_per_sec"] = (
        (kernel or {}).get("device_mask_kernel_events_per_sec")
    )
    out["witness_cid_kernel_per_sec"] = (
        (cid or {}).get("witness_cid_kernel_per_sec")
    )
    out["witness_cid_kernel"] = (cid or {}).get("witness_cid_kernel")
    _SERVE_KEYS = (
        "serve_batched_rps", "serve_sequential_rps",
        "serve_speedup_vs_sequential", "serve_concurrency", "serve_requests",
        "serve_p99_latency_ms", "serve_mean_batch", "serve_rejections",
    )
    for k in _SERVE_KEYS:
        out[k] = (serve or {}).get(k)
    _WITNESS_KEYS = (
        "witness_reduction_pct", "witness_two_pass_bytes",
        "witness_single_pass_bytes", "witness_sample_pairs",
        "witness_bytes_per_proof_k1", "witness_bytes_per_proof_k16",
        "witness_bytes_per_proof_k256", "witness_delta_ratio",
        "witness_compressed_ratio",
    )
    for k in _WITNESS_KEYS:
        out[k] = (witness or {}).get(k)
    _RESILIENCE_KEYS = (
        "resilience_fault_free_proofs_per_sec", "integrity_overhead_pct",
        "proofs_per_sec_at_fault_rate", "resilience_fault_rate",
        "recovery_ms",
    )
    for k in _RESILIENCE_KEYS:
        out[k] = (resilience or {}).get(k)
    _DURABILITY_KEYS = (
        "durability_journal_overhead_pct", "durability_resume_ms",
        "durability_replay_chunks_per_sec", "durability_journal_bytes",
        "durability_chunks",
    )
    for k in _DURABILITY_KEYS:
        out[k] = (durability or {}).get(k)
    _OBSERVABILITY_KEYS = (
        "trace_overhead_pct", "spans_per_proof",
        "observability_spans_recorded", "observability_spans_dropped",
        "observability_pairs",
    )
    for k in _OBSERVABILITY_KEYS:
        out[k] = (observability or {}).get(k)
    _STORAGE_KEYS = (
        "cold_vs_warm_speedup", "disk_hit_ratio", "prefetch_hit_ratio",
        "storage_cold_rpc_calls", "storage_warm_rpc_calls",
        "storage_prefetched_blocks", "storage_disk_bytes", "storage_pairs",
    )
    for k in _STORAGE_KEYS:
        out[k] = (storage or {}).get(k)
    _ASYNCFETCH_KEYS = (
        "cold_rpc_roundtrips_per_proof", "sync_rpc_roundtrips_per_proof",
        "cold_speedup_vs_sync_walker", "speculate_waste_pct",
        "asyncfetch_batch_calls", "asyncfetch_cold_rpc_calls",
        "asyncfetch_sync_rpc_calls", "asyncfetch_pairs",
    )
    for k in _ASYNCFETCH_KEYS:
        out[k] = (asyncfetch or {}).get(k)
    _CLUSTER_KEYS = (
        "cluster_linearity_4shard", "aggregate_proofs_per_sec",
        "steal_events", "cluster_rps_1shard", "cluster_rps_4shard",
        "cluster_pairs", "cluster_requests",
    )
    for k in _CLUSTER_KEYS:
        out[k] = (cluster or {}).get(k)
    _STANDING_KEYS = (
        "standing_proofs_pushed_per_sec_1k",
        "standing_proofs_pushed_per_sec_10k",
        "standing_delivery_lag_p50_ms", "standing_delivery_lag_p99_ms",
        "standing_subscriptions", "standing_tipsets",
        "standing_distinct_filters", "standing_generations_per_tipset",
    )
    for k in _STANDING_KEYS:
        out[k] = (standing or {}).get(k)
    _FLEETOBS_KEYS = (
        "fleetobs_overhead_pct", "fleetobs_rps_plain",
        "fleetobs_rps_observed", "fleetobs_stitched_spans",
        "fleetobs_scrapes", "fleetobs_pairs", "fleetobs_requests",
    )
    for k in _FLEETOBS_KEYS:
        out[k] = (fleetobs or {}).get(k)
    _ONCHIP_KEYS = (
        "device_linearity_Nchip", "batch_verify_speedup", "onchip_devices",
        "onchip_match_events", "onchip_verify_blocks", "onchip_device_calls",
        "verify_tuned_speedup", "verify_autotune_scalar_only",
        "verify_autotuned_min_bytes",
    )
    for k in _ONCHIP_KEYS:
        out[k] = (onchip or {}).get(k)
    _BACKFILL_KEYS = (
        "backfill_epochs_per_sec", "backfill_epochs_per_sec_1shard",
        "backfill_ttfc_ms", "backfill_total_ms", "backfill_occupancy_pct",
        "backfill_windows", "backfill_epochs", "backfill_shards",
    )
    for k in _BACKFILL_KEYS:
        out[k] = (backfill or {}).get(k)
    _ZEROCOPY_KEYS = (
        "warm_block_bytes_copied_per_resp", "stream_ttfb_ms",
        "qos_light_tenant_p99_ms", "qos_light_tenant_p50_ms",
        "qos_heavy_backlog_drain_ms", "zerocopy_bytes_per_resp",
        "zerocopy_responses", "qos_heavy_concurrency", "qos_heavy_requests",
        "zerocopy_host_cpus",
    )
    for k in _ZEROCOPY_KEYS:
        out[k] = (zerocopy or {}).get(k)
    _HOSTKILL_KEYS = (
        "aggregate_proofs_per_sec_2host", "replica_repair_hit_rate",
        "kill_recovery_ms", "hostkill_pairs", "hostkill_requests",
        "hostkill_failovers",
    )
    for k in _HOSTKILL_KEYS:
        out[k] = (hostkill or {}).get(k)
    _OVERLOAD_KEYS = (
        "goodput_ratio_at_2x", "shed_rate", "light_tenant_p99_ms_overload",
        "cancel_reclaim_pct", "overload_capacity_rps", "overload_goodput_rps",
        "overload_requests", "overload_doomed_requests",
        "overload_admit_limit_final", "overload_host_cpus",
    )
    for k in _OVERLOAD_KEYS:
        out[k] = (overload or {}).get(k)
    _REGISTRY_KEYS = (
        "registry_append_overhead_pct", "registry_append_us",
        "registry_inclusion_proof_ms", "fleet_delta_hit_rate",
        "fleet_delta_baseline_hit_rate", "registry_chain_records",
        "registry_serve_requests", "registry_shards", "registry_lookups",
    )
    for k in _REGISTRY_KEYS:
        out[k] = (registry or {}).get(k)
    out["legs"] = legs_status
    out["watchdog_fallback"] = False
    print(json.dumps(out))
    failed = {name: s for name, s in legs_status.items() if s != f"ok:{platform}"}
    if failed:
        _log(f"bench: {len(failed)} leg(s) not ok on {platform}: {failed}")
        return 1
    return 0


def main(argv=None) -> int:
    args = _parse_args(argv)
    if args.leg:
        out = _LEG_FNS[args.leg](args)
        _log(f"bench: kernel launches {json.dumps(_launch_counts())}")
        print(json.dumps(out))
        return 0
    return _orchestrate(args)


if __name__ == "__main__":
    sys.exit(main())
