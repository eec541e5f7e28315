"""Crash-recovery harness: SIGKILL the range driver, resume, demand bit-identity.

The chaos invariant (tools/chaos.py) extended to process death: for every
kill point the journaled range job must resume to a final bundle
**byte-identical** to an uninterrupted run. The harness forks the REAL
driver (`generate_event_proofs_for_range_pipelined` with ``job_dir``) as a
child process and kills it via the journal writer's env fault hook
(`ipc_proofs_tpu_torch.jobs.journal.JournalWriter`):

- ``IPC_JOURNAL_CRASH_AT=N`` — SIGKILL at the N-th journal append,
  *after* the record is fully fsync'd (chunk-boundary kill);
- ``+ IPC_JOURNAL_CRASH_TORN=K`` — SIGKILL after only the first K bytes
  of the frame reach disk (torn mid-record write — the resume must
  discard the tail and regenerate that chunk).

A real ``os.kill(getpid(), SIGKILL)``: no destructors, no atexit, no
buffered-file flush — exactly a preemption or OOM kill. The parent
observes rc ``-SIGKILL``, re-runs the child with the same job dir and no
crash env, and compares the final bundle bytes against the reference.

Compaction kills (``--compaction`` / `run_compaction_grid`): with
``IPC_JOURNAL_COMPACT_BYTES=1`` arming auto-compaction on the first
commit, ``IPC_COMPACT_CRASH_BYTES=K`` tears the snapshot sidecar at byte
K and dies before the atomic swap (live journal must be untouched), and
``IPC_COMPACT_CRASH_POST=1`` dies right after ``os.replace`` (the
journal IS the snapshot). Every point must resume byte-identical.

Usage:
    python -m ipc_proofs_tpu_torch.tools.crashtest SEED [--points N]
        [--pairs P] [--chunk-size C] [--record-workers W] [--quick]
        [--compaction | --backfill | --rebalance | --sigterm | --registry]
        [--device cuda|cpu]

Importable: `run_grid(base_seed, ...)` backs tests/test_torch_crashtest.py
(pinned seeds, against the reference's ``tools/crashtest.py``) and the
`tools.soak` crash phase. The ``--child`` entrypoint is the forked driver
— not for interactive use.

The counterpart of the reference's ``tools/crashtest.py``, kill point for
kill point. Its children run ``python -m
ipc_proofs_tpu_torch.tools.crashtest --child --device <d>`` with the
repository root on ``PYTHONPATH``, on the card unless ``device="cpu"``
(the reference forces its children onto the host). Each child loads the
kernels the parent built (``GpuBackend.warm``: a published build is only
loaded, never rebuilt or replaced) and reports the libraries it mapped.
A child that dies of anything but the expected signal — a CUDA error
included — is ``no_crash`` or ``resume_failed``, never a kill: the
parent checks the exact return code.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import signal
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

from ipc_proofs_tpu_torch.tools import add_device_flag, backend_for

# the repository root: a child runs as ``python -m`` with it on PYTHONPATH
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SIG, SUBNET, ACTOR = "NewTopDownMessage(bytes32,uint256)", "calib-subnet-1", 1001


def _build_world(n_pairs: int, receipts: int, events: int, match_rate: float):
    from ipc_proofs_tpu_torch.fixtures import build_range_world
    from ipc_proofs_tpu_torch.proofs.generator import EventProofSpec

    store, pairs, _ = build_range_world(
        n_pairs, receipts, events, match_rate,
        signature=SIG, topic1=SUBNET, actor_id=ACTOR,
    )
    spec = EventProofSpec(event_signature=SIG, topic_1=SUBNET, actor_id_filter=ACTOR)
    return store, pairs, spec


def _backend(device: str):
    """The `GpuBackend` on ``device`` with its kernels loaded: the parent
    builds them before its first child starts, so a child only loads the
    published build. Without CUDA a ``cuda`` request exits non-zero."""
    backend = backend_for(device)
    backend.warm()
    return backend


def range_reference(shape: dict, device: str = "cuda", backend=None) -> str:
    """The uninterrupted pipelined bundle JSON of the world at ``shape`` —
    what `child_main` writes when no kill fires. Its mask runs on
    ``backend`` (default the one on ``device``)."""
    from ipc_proofs_tpu_torch.proofs.range import generate_event_proofs_for_range_pipelined

    store, pairs, spec = _build_world(
        shape["pairs"], shape["receipts"], shape["events"], shape["match_rate"]
    )
    return generate_event_proofs_for_range_pipelined(
        store, pairs, spec, chunk_size=shape["chunk_size"], scan_threads=2,
        record_workers=shape.get("record_workers") or 1, force_pipeline=True,
        match_backend=backend if backend is not None else _backend(device),
    ).to_json()


def backfill_reference(shape: dict, device: str = "cuda", backend=None) -> str:
    """The chunked range driver's bundle JSON over the world at ``shape``,
    one chunk per backfill window — what `backfill_child_main` must
    reproduce. Its mask runs on ``backend`` (default the one on
    ``device``)."""
    from ipc_proofs_tpu_torch.proofs.range import generate_event_proofs_for_range_chunked

    store, pairs, spec = _build_world(
        shape["pairs"], shape["receipts"], shape["events"], shape["match_rate"]
    )
    return generate_event_proofs_for_range_chunked(
        store, pairs, spec, chunk_size=shape["chunk_size"],
        match_backend=backend if backend is not None else _backend(device),
    ).to_json()


def _write_metrics(path: str, metrics) -> None:
    from ipc_proofs_tpu_torch.ops.build import loaded_libraries

    with open(path, "w") as fh:
        json.dump(
            {"counters": metrics.snapshot()["counters"], "libraries": loaded_libraries()}, fh
        )


def backfill_child_main(args) -> int:
    """Forked backfill driver: deterministic world → journaled
    `BackfillEngine` job at ``--chunk-size`` epochs per window.

    The engine journals under ``--job-dir/<job-id>`` through the same
    IPJ1 writer as the range driver, so the ``IPC_JOURNAL_CRASH_AT`` /
    ``IPC_JOURNAL_CRASH_TORN`` hooks SIGKILL it at exactly the same
    commit points — window boundary or torn mid-record."""
    from ipc_proofs_tpu_torch.backfill import BackfillEngine, local_window_runner
    from ipc_proofs_tpu_torch.utils.metrics import Metrics

    backend = _backend(args.device)
    store, pairs, spec = _build_world(
        args.pairs, args.receipts, args.events, args.match_rate
    )
    metrics = Metrics()
    engine = BackfillEngine(
        pairs,
        spec,
        local_window_runner(store, spec, metrics=metrics, match_backend=backend),
        jobs_dir=args.job_dir,
        window_size=args.chunk_size,
        metrics=metrics,
    )
    try:
        bundle = engine.submit(0, len(pairs)).result(timeout=600.0)
    finally:
        engine.close()
    tmp = args.out + ".tmp"
    with open(tmp, "w") as fh:
        fh.write(bundle.to_json())
    os.replace(tmp, args.out)
    if args.metrics_out:
        _write_metrics(args.metrics_out, metrics)
    return 0


def rebalance_child_main(args) -> int:
    """Forked rebalance handoff: deterministic source segments → journaled
    `RebalanceJob` (storex.replica) pushing whole segment files into a
    destination directory. The journal lives under ``--job-dir`` through
    the same IPJ1 writer as the range driver, so the
    ``IPC_JOURNAL_CRASH_AT`` / ``IPC_JOURNAL_CRASH_TORN`` hooks SIGKILL
    it at every plan/pushed/commit append boundary. ``--pairs`` is reused
    as the segment count (one block per segment via a 1-byte roll
    threshold); the final placement manifest (name → sha256 of the pushed
    file) is what the parent compares across kill points."""
    import hashlib

    from ipc_proofs_tpu_torch.core.cid import CID
    from ipc_proofs_tpu_torch.storex import RebalanceJob, SegmentStore
    from ipc_proofs_tpu_torch.utils.metrics import Metrics

    backend = _backend(args.device)
    src_dir = os.path.join(args.job_dir, "src")
    dest_dir = os.path.join(args.job_dir, "dest")
    os.makedirs(dest_dir, exist_ok=True)
    metrics = Metrics()
    store = SegmentStore(
        src_dir, owner="a", segment_max_bytes=1, metrics=metrics, backend=backend
    )
    if len(store) == 0:
        for i in range(args.pairs):
            data = (b"rebalance-%04d-" % i) * (i + 2)
            store.put(CID.hash_of(data), data)
    segments = [d["name"] for d in store.segment_files() if not d["active"]]

    def push(name: str, data: bytes) -> None:
        tmp = os.path.join(dest_dir, name + ".tmp")
        with open(tmp, "wb") as fh:
            fh.write(data)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, os.path.join(dest_dir, name))

    def read_segment(name: str):
        path = store.segment_path(name)
        if path is None:
            return None
        with open(path, "rb") as fh:
            return fh.read()

    job = RebalanceJob(
        os.path.join(args.job_dir, "rebalance.journal"),
        "dest", segments, push, read_segment, metrics=metrics,
    )
    committed = job.run()
    store.close()
    placement = {}
    for name in sorted(os.listdir(dest_dir)):
        if name.endswith(".tmp"):
            continue
        with open(os.path.join(dest_dir, name), "rb") as fh:
            placement[name] = hashlib.sha256(fh.read()).hexdigest()
    tmp = args.out + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(
            {"committed": committed, "placement": placement}, fh, sort_keys=True
        )
    os.replace(tmp, args.out)
    if args.metrics_out:
        _write_metrics(args.metrics_out, metrics)
    return 0


def stream_child_main(args) -> int:
    """Forked IPBS streamer: deterministic world → one bundle streamed
    through `BundleStreamWriter` into ``--out``, fsync'd per send.

    ``IPC_STREAM_TERM_AT_CHUNK=N`` raises SIGTERM against the process
    right after the N-th send callback lands on disk — a mid-stream
    death with a committed prefix of the IPBS frame sequence, exactly
    what a preempted serve process leaves on a client's socket. The
    parent then demands the truncated stream be DETECTABLY torn (typed
    `WitnessError` from the decoder), never a silently-short document."""
    from ipc_proofs_tpu_torch.proofs.range import generate_event_proofs_for_range_chunked
    from ipc_proofs_tpu_torch.witness.stream import BundleStreamWriter
    from ipc_proofs_tpu_torch.witness.wire import WitnessOptions
    from ipc_proofs_tpu_torch.witness.stream import stream_bundle_doc

    backend = _backend(args.device)
    store, pairs, spec = _build_world(
        args.pairs, args.receipts, args.events, args.match_rate
    )
    bundle = generate_event_proofs_for_range_chunked(
        store, pairs, spec, chunk_size=args.chunk_size, match_backend=backend
    )
    term_at = int(os.environ.get("IPC_STREAM_TERM_AT_CHUNK", "0") or 0)
    sends = 0
    fh = open(args.out, "wb")

    def sink(bufs):
        nonlocal sends
        for b in bufs:
            fh.write(bytes(b))
        fh.flush()
        os.fsync(fh.fileno())
        sends += 1
        if term_at and sends >= term_at:
            os.kill(os.getpid(), signal.SIGTERM)

    stream_bundle_doc(BundleStreamWriter(sink), bundle, WitnessOptions())
    fh.close()
    return 0


def child_main(args) -> int:
    """Forked driver: deterministic world → journaled pipelined range run.

    The world is a pure function of the shape arguments, so the crashed
    child, the resumed child, and the parent's reference all see the same
    blocks — any byte divergence is the journal's fault, never the data's.
    """
    from ipc_proofs_tpu_torch.proofs.range import generate_event_proofs_for_range_pipelined
    from ipc_proofs_tpu_torch.utils.metrics import Metrics

    backend = _backend(args.device)
    store, pairs, spec = _build_world(
        args.pairs, args.receipts, args.events, args.match_rate
    )
    metrics = Metrics()
    bundle = generate_event_proofs_for_range_pipelined(
        store,
        pairs,
        spec,
        chunk_size=args.chunk_size,
        match_backend=backend,
        metrics=metrics,
        scan_threads=2,
        record_workers=args.record_workers,
        force_pipeline=True,
        job_dir=args.job_dir,
    )
    tmp = args.out + ".tmp"
    with open(tmp, "w") as fh:
        fh.write(bundle.to_json())
    os.replace(tmp, args.out)
    if args.metrics_out:
        _write_metrics(args.metrics_out, metrics)
    return 0


def registry_child_main(args) -> int:
    """Forked provenance appender: a `ProvenanceRegistry` at ``--job-dir``
    receives ``--pairs`` deterministic serve records (digest, trace, CID
    set all pure functions of the index), then writes its published head
    to ``--out``.

    ``IPC_REGISTRY_CRASH_AT=N`` SIGKILLs at the N-th append after the
    frame is fully on disk (boundary kill → N+1 committed records);
    ``+ IPC_REGISTRY_CRASH_TORN=K`` persists only the first K bytes of
    that frame (torn kill → N committed records plus residue the reopen
    must truncate). A clean (resume) run reopens the crashed log —
    truncating residue, re-verifying the chain — and appends the same
    ``--pairs`` records again, so the parent knows the exact expected
    record count at every step."""
    import hashlib

    from ipc_proofs_tpu_torch.registry import ProvenanceRegistry
    from ipc_proofs_tpu_torch.utils.metrics import Metrics

    _backend(args.device)
    metrics = Metrics()
    reg = ProvenanceRegistry(args.job_dir, owner="crash", metrics=metrics)
    for i in range(args.pairs):
        digest = hashlib.sha256(f"bundle-{i}".encode()).hexdigest()
        reg.append_served(
            digest,
            trace=f"trace-{i}",
            tenant="crashtest",
            key=f"pair:{i}",
            verdict="valid",
            cids=frozenset(
                hashlib.sha256(f"cid-{i}-{j}".encode()).digest()
                for j in range(2)
            ),
            t=float(i),
        )
    head = reg.head()
    reg.close()
    tmp = args.out + ".tmp"
    with open(tmp, "w") as fh:
        json.dump({"head": head}, fh, sort_keys=True)
    os.replace(tmp, args.out)
    if args.metrics_out:
        _write_metrics(args.metrics_out, metrics)
    return 0


def _spawn_child(
    job_dir: str,
    out: str,
    shape: dict,
    crash_at: "int | None" = None,
    torn: "int | None" = None,
    metrics_out: "str | None" = None,
    timeout_s: float = 300.0,
    extra_env: "dict | None" = None,
    backfill: bool = False,
    rebalance: bool = False,
    stream: bool = False,
    registry: bool = False,
    device: str = "cuda",
) -> subprocess.CompletedProcess:
    cmd = [
        sys.executable, "-m", "ipc_proofs_tpu_torch.tools.crashtest",
        "--child", "--device", device,
        "--job-dir", job_dir, "--out", out,
        "--pairs", str(shape["pairs"]), "--chunk-size", str(shape["chunk_size"]),
        "--receipts", str(shape["receipts"]), "--events", str(shape["events"]),
        "--match-rate", str(shape["match_rate"]),
        "--record-workers", str(shape.get("record_workers") or 1),
    ]
    if backfill:
        cmd.append("--backfill")
    if rebalance:
        cmd.append("--rebalance")
    if stream:
        cmd.append("--stream")
    if registry:
        cmd.append("--registry")
    if metrics_out:
        cmd += ["--metrics-out", metrics_out]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_REPO, env.get("PYTHONPATH", "")) if p
    )
    env["IPC_FORCE_PIPELINE"] = "1"
    for key in (
        "IPC_JOURNAL_CRASH_AT",
        "IPC_JOURNAL_CRASH_TORN",
        "IPC_JOURNAL_CRASH_SIGNAL",
        "IPC_JOURNAL_COMPACT_BYTES",
        "IPC_COMPACT_CRASH_BYTES",
        "IPC_COMPACT_CRASH_POST",
        "IPC_STREAM_TERM_AT_CHUNK",
        "IPC_REGISTRY_CRASH_AT",
        "IPC_REGISTRY_CRASH_TORN",
    ):
        env.pop(key, None)
    if crash_at is not None:
        prefix = "IPC_REGISTRY" if registry else "IPC_JOURNAL"
        env[f"{prefix}_CRASH_AT"] = str(crash_at)
        if torn is not None:
            env[f"{prefix}_CRASH_TORN"] = str(torn)
    if extra_env:
        env.update(extra_env)
    return subprocess.run(
        cmd, env=env, capture_output=True, text=True, timeout=timeout_s, cwd=_REPO
    )


def crash_run(
    reference: str,
    shape: dict,
    crash_at: int,
    torn: "int | None",
    workdir: str,
    tag: "str | int" = 0,
    device: str = "cuda",
) -> dict:
    """One kill point: crash the child at ``crash_at`` (optionally torn at
    byte ``torn``), resume it, and check the final bundle bytes.

    ``tag`` must be unique per call — it keys the job dir, and a repeated
    (crash_at, torn) draw must NOT resume the earlier call's journal (a
    fully-committed job never appends, so the crash hook would never fire).
    """
    from ipc_proofs_tpu_torch.jobs import JOBS_JOURNAL_NAME, read_journal

    job_dir = os.path.join(workdir, f"job_{tag}_at{crash_at}_torn{torn}")
    out = os.path.join(workdir, f"out_{tag}_at{crash_at}_torn{torn}.json")
    metrics_out = out + ".metrics"
    res = {"crash_at": crash_at, "torn": torn}

    crashed = _spawn_child(job_dir, out, shape, crash_at=crash_at, torn=torn, device=device)
    if crashed.returncode != -signal.SIGKILL:
        res["outcome"] = "no_crash"
        res["rc"] = crashed.returncode
        res["stderr"] = crashed.stderr[-2000:]
        return res

    # post-mortem: the journal must hold exactly the committed prefix —
    # crash_at records for a torn kill (+1 when the frame fully landed)
    jpath = os.path.join(job_dir, JOBS_JOURNAL_NAME)
    n_records, torn_tail = 0, False
    if os.path.exists(jpath):
        records, _, torn_tail = read_journal(jpath)
        n_records = len(records)
    res["records_after_crash"] = n_records
    res["torn_tail"] = torn_tail
    expect = crash_at if torn is not None else crash_at + 1
    if n_records != expect:
        res["outcome"] = "journal_mismatch"
        res["expected_records"] = expect
        return res

    resumed = _spawn_child(job_dir, out, shape, metrics_out=metrics_out, device=device)
    if resumed.returncode != 0:
        res["outcome"] = "resume_failed"
        res["rc"] = resumed.returncode
        res["stderr"] = resumed.stderr[-2000:]
        return res
    with open(out) as fh:
        final = fh.read()
    with open(metrics_out) as fh:
        child = json.load(fh)
    counters = child["counters"]
    res["libraries"] = child["libraries"]
    res["chunks_replayed"] = counters.get("jobs.chunks_replayed", 0)
    res["chunks_resumed"] = counters.get("range_chunks_resumed", 0)
    res["outcome"] = "identical" if final == reference else "divergent"
    if res["outcome"] == "identical" and res["chunks_replayed"] != n_records:
        res["outcome"] = "replay_miscount"  # resumed run must reuse every commit
    return res


def _find_backfill_journal(jobs_dir: str) -> "str | None":
    """The backfill engine journals under ``jobs_dir/<bf-...>/`` — one
    subdirectory per deterministic job id. Locate the journal post-mortem."""
    from ipc_proofs_tpu_torch.jobs import JOBS_JOURNAL_NAME

    if not os.path.isdir(jobs_dir):
        return None
    for name in sorted(os.listdir(jobs_dir)):
        jpath = os.path.join(jobs_dir, name, JOBS_JOURNAL_NAME)
        if os.path.exists(jpath):
            return jpath
    return None


def backfill_crash_run(
    reference: str,
    shape: dict,
    crash_at: int,
    torn: "int | None",
    workdir: str,
    tag: "str | int" = 0,
    term: bool = False,
    device: str = "cuda",
) -> dict:
    """One backfill kill point: kill the `BackfillEngine` child at the
    ``crash_at``-th window commit (optionally torn at byte ``torn``),
    resume it from the same jobs dir, and demand the final bundle be
    byte-identical to the reference. The resumed run must replay every
    committed window from the journal (``jobs.chunks_replayed`` at the
    journal layer, ``backfill.windows_replayed`` at the engine).

    ``term=True`` delivers SIGTERM instead of SIGKILL — the
    orchestrator-preemption flavor, landing while later windows are
    still in flight. Recovery must be indistinguishable from a SIGKILL."""
    jobs_dir = os.path.join(workdir, f"bfjob_{tag}_at{crash_at}_torn{torn}")
    out = os.path.join(workdir, f"bfout_{tag}_at{crash_at}_torn{torn}.json")
    metrics_out = out + ".metrics"
    res = {"crash_at": crash_at, "torn": torn, "signal": "TERM" if term else "KILL"}

    crashed = _spawn_child(
        jobs_dir, out, shape, crash_at=crash_at, torn=torn, backfill=True,
        extra_env={"IPC_JOURNAL_CRASH_SIGNAL": "TERM"} if term else None,
            device=device,
        )
    if crashed.returncode != -(signal.SIGTERM if term else signal.SIGKILL):
        res["outcome"] = "no_crash"
        res["rc"] = crashed.returncode
        res["stderr"] = crashed.stderr[-2000:]
        return res

    from ipc_proofs_tpu_torch.jobs import read_journal

    jpath = _find_backfill_journal(jobs_dir)
    n_records, torn_tail = 0, False
    if jpath is not None:
        records, _, torn_tail = read_journal(jpath)
        n_records = len(records)
    res["records_after_crash"] = n_records
    res["torn_tail"] = torn_tail
    expect = crash_at if torn is not None else crash_at + 1
    if n_records != expect:
        res["outcome"] = "journal_mismatch"
        res["expected_records"] = expect
        return res

    resumed = _spawn_child(
        jobs_dir, out, shape, metrics_out=metrics_out, backfill=True, device=device
    )
    if resumed.returncode != 0:
        res["outcome"] = "resume_failed"
        res["rc"] = resumed.returncode
        res["stderr"] = resumed.stderr[-2000:]
        return res
    with open(out) as fh:
        final = fh.read()
    with open(metrics_out) as fh:
        child = json.load(fh)
    counters = child["counters"]
    res["libraries"] = child["libraries"]
    res["chunks_replayed"] = counters.get("jobs.chunks_replayed", 0)
    res["windows_replayed"] = counters.get("backfill.windows_replayed", 0)
    res["outcome"] = "identical" if final == reference else "divergent"
    if res["outcome"] == "identical" and (
        res["chunks_replayed"] != n_records
        or res["windows_replayed"] != n_records
    ):
        res["outcome"] = "replay_miscount"  # resumed run must reuse every commit
    return res


def rebalance_crash_run(
    reference: dict,
    n_segments: int,
    crash_at: int,
    torn: "int | None",
    workdir: str,
    tag: "str | int" = 0,
    device: str = "cuda",
) -> dict:
    """One rebalance kill point: SIGKILL the `RebalanceJob` child at the
    ``crash_at``-th journal append (plan / pushed / commit boundary,
    optionally torn at byte ``torn``), resume it, and demand the final
    destination placement — file names AND bytes — match the
    uninterrupted reference, with the resume actually detected
    (``storex.rebalance_resumes``) whenever the crash left records."""
    from ipc_proofs_tpu_torch.jobs import read_journal

    job_dir = os.path.join(workdir, f"rbjob_{tag}_at{crash_at}_torn{torn}")
    out = os.path.join(workdir, f"rbout_{tag}_at{crash_at}_torn{torn}.json")
    metrics_out = out + ".metrics"
    shape = {
        "pairs": n_segments, "chunk_size": 1,
        "receipts": 1, "events": 1, "match_rate": 0.0,
    }
    res = {"crash_at": crash_at, "torn": torn}

    crashed = _spawn_child(
        job_dir, out, shape, crash_at=crash_at, torn=torn, rebalance=True, device=device
    )
    if crashed.returncode != -signal.SIGKILL:
        res["outcome"] = "no_crash"
        res["rc"] = crashed.returncode
        res["stderr"] = crashed.stderr[-2000:]
        return res

    jpath = os.path.join(job_dir, "rebalance.journal")
    n_records = 0
    already_committed = False
    if os.path.exists(jpath):
        records, _, _torn_tail = read_journal(jpath)
        n_records = len(records)
        already_committed = any(
            isinstance(r, dict) and r.get("kind") == "commit" for r in records
        )
    res["records_after_crash"] = n_records
    expect = crash_at if torn is not None else crash_at + 1
    if n_records != expect:
        res["outcome"] = "journal_mismatch"
        res["expected_records"] = expect
        return res

    resumed = _spawn_child(
        job_dir, out, shape, metrics_out=metrics_out, rebalance=True, device=device
    )
    if resumed.returncode != 0:
        res["outcome"] = "resume_failed"
        res["rc"] = resumed.returncode
        res["stderr"] = resumed.stderr[-2000:]
        return res
    with open(out) as fh:
        final = json.load(fh)
    with open(metrics_out) as fh:
        counters = json.load(fh)["counters"]
    res["resumes"] = counters.get("storex.rebalance_resumes", 0)
    ok = final["committed"] and final["placement"] == reference["placement"]
    res["outcome"] = "identical" if ok else "divergent"
    # a crash that left records but no commit must be DETECTED as a resume;
    # a post-commit kill replays to a no-op and counts nothing
    expect_resumes = 1 if (n_records and not already_committed) else 0
    if res["outcome"] == "identical" and res["resumes"] != expect_resumes:
        res["outcome"] = "resume_miscount"  # committed prefix must be detected
    return res


def run_rebalance_grid(
    base_seed: int, n_segments: int = 3, log=lambda msg: None,
    device: str = "cuda",
) -> dict:
    """Exhaustive rebalance kill grid: every append boundary (plan, each
    pushed record, commit — ``n_segments + 2`` points) plus two seeded
    torn mid-record writes. ``ok`` iff every point crashed, resumed, and
    converged on the byte-identical reference placement."""
    _backend(device)  # build the kernels before any child starts
    with tempfile.TemporaryDirectory(prefix="crashtest_rebalance_") as workdir:
        ref_dir = os.path.join(workdir, "reference")
        ref_out = os.path.join(workdir, "reference.json")
        shape = {
            "pairs": n_segments, "chunk_size": 1,
            "receipts": 1, "events": 1, "match_rate": 0.0,
        }
        ref = _spawn_child(ref_dir, ref_out, shape, rebalance=True, device=device)
        if ref.returncode != 0:
            return {
                "ok": False, "points": 0,
                "violations": [{"outcome": "reference_failed",
                                "stderr": ref.stderr[-2000:]}],
                "counts": {},
            }
        with open(ref_out) as fh:
            reference = json.load(fh)
        if len(reference["placement"]) != n_segments:
            return {
                "ok": False, "points": 0,
                "violations": [{"outcome": "reference_incomplete",
                                "placement": reference["placement"]}],
                "counts": {},
            }

        rng = random.Random(base_seed)
        n_appends = n_segments + 2  # plan + one per segment + commit
        kill_points = [(at, None) for at in range(n_appends)]
        kill_points += [
            (rng.randrange(n_appends), rng.choice([1, 5, 11, 13, 64]))
            for _ in range(2)
        ]
        counts: "dict[str, int]" = {}
        violations = []
        for i, (crash_at, torn) in enumerate(kill_points):
            res = rebalance_crash_run(
                reference, n_segments, crash_at, torn, workdir, tag=i, device=device
            )
            counts[res["outcome"]] = counts.get(res["outcome"], 0) + 1
            if res["outcome"] != "identical":
                violations.append(res)
            log(
                f"rebalance kill at append {crash_at}"
                + (f" torn@{torn}B" if torn is not None else " (boundary)")
                + f": {res['outcome']}"
            )
    return {
        "ok": not violations,
        "points": len(kill_points),
        "kill_points": kill_points,
        "counts": counts,
        "violations": violations,
    }


def run_backfill_grid(
    base_seed: int,
    points: int = 6,
    n_pairs: int = 12,
    window_size: int = 2,
    receipts: int = 4,
    events: int = 2,
    match_rate: float = 0.2,
    log=lambda msg: None,
    device: str = "cuda",
) -> dict:
    """Seeded kill-point grid over the backfill engine: half
    window-boundary kills, half torn mid-record writes. The reference is
    the CHUNKED RANGE DRIVER over the same world at the same chunking —
    so the grid also re-asserts the backfill/driver byte-identity law
    under crash-resume, not just on the happy path."""
    shape = {
        "pairs": n_pairs, "chunk_size": window_size,
        "receipts": receipts, "events": events, "match_rate": match_rate,
        "record_workers": 1,
    }
    n_windows = (n_pairs + window_size - 1) // window_size
    reference = backfill_reference(shape, device)

    rng = random.Random(base_seed)
    kill_points = []
    for i in range(points):
        crash_at = rng.randrange(n_windows - 1) if n_windows > 1 else 0
        if i % 2 == 0:
            kill_points.append((crash_at, None))  # window-boundary kill
        else:
            kill_points.append((crash_at, rng.choice([1, 5, 11, 13, 64, 4096])))

    counts: dict[str, int] = {}
    violations = []
    with tempfile.TemporaryDirectory(prefix="crashtest_backfill_") as workdir:
        for i, (crash_at, torn) in enumerate(kill_points):
            res = backfill_crash_run(
                reference, shape, crash_at, torn, workdir, tag=i, device=device
            )
            counts[res["outcome"]] = counts.get(res["outcome"], 0) + 1
            if res["outcome"] != "identical":
                violations.append(res)
            log(
                f"backfill kill at window {crash_at}"
                + (f" torn@{torn}B" if torn is not None else " (boundary)")
                + f": {res['outcome']}"
                + (
                    f" ({res.get('records_after_crash')} committed, "
                    f"{res.get('windows_replayed')} replayed)"
                    if "records_after_crash" in res else ""
                )
            )
    boundary = sum(1 for _, t in kill_points if t is None)
    ok = (
        not violations
        and boundary > 0
        and boundary < len(kill_points)  # both flavors exercised
    )
    return {
        "ok": ok,
        "points": len(kill_points),
        "kill_points": kill_points,
        "n_windows": n_windows,
        "counts": counts,
        "violations": violations,
    }


def stream_reference_run(
    shape: dict, workdir: str, device: str = "cuda",
) -> "tuple[bytes | None, dict | None]":
    """The stream child's IPBS bytes with no SIGTERM armed: (bytes, None),
    or (None, violation) when the child failed."""
    ref_dir = os.path.join(workdir, "stream_ref")
    ref_out = os.path.join(workdir, "stream_ref.ipbs")
    ref = _spawn_child(ref_dir, ref_out, shape, stream=True, device=device)
    if ref.returncode != 0:
        return None, {"outcome": "stream_reference_failed", "stderr": ref.stderr[-2000:]}
    with open(ref_out, "rb") as fh:
        return fh.read(), None


def sigterm_stream_run(
    reference: bytes,
    shape: dict,
    term_at: int,
    workdir: str,
    tag: "str | int" = 0,
    device: str = "cuda",
) -> dict:
    """One mid-IPBS-stream SIGTERM: the stream child dies right after its
    ``term_at``-th send callback hits disk, leaving a committed prefix of
    the frame sequence — what a preempted serve process leaves on a
    client socket. The invariant is DETECTABILITY: the truncated bytes
    must raise a typed `WitnessError` from the client decoder (torn
    frame / open document / missing trailer), never parse as a complete
    document ("silent_partial" = violation)."""
    from ipc_proofs_tpu_torch.witness.errors import WitnessError
    from ipc_proofs_tpu_torch.witness.stream import decode_bundle_stream

    job_dir = os.path.join(workdir, f"stjob_{tag}_term{term_at}")
    out = os.path.join(workdir, f"stout_{tag}_term{term_at}.ipbs")
    res: dict = {"term_at": term_at}

    crashed = _spawn_child(
        job_dir, out, shape, stream=True,
        extra_env={"IPC_STREAM_TERM_AT_CHUNK": str(term_at)},
            device=device,
        )
    if crashed.returncode != -signal.SIGTERM:
        res["outcome"] = "no_crash"
        res["rc"] = crashed.returncode
        res["stderr"] = crashed.stderr[-2000:]
        return res
    partial = b""
    if os.path.exists(out):
        with open(out, "rb") as fh:
            partial = fh.read()
    res["partial_bytes"] = len(partial)
    res["reference_bytes"] = len(reference)
    if not partial:
        res["outcome"] = "empty_prefix"  # term_at ≥ 1 ⇒ one send committed
        return res
    if partial == reference:
        # the kill landed on the very last send: nothing was torn
        res["outcome"] = "complete_before_term"
        return res
    if not reference.startswith(partial):
        res["outcome"] = "divergent"  # the prefix itself must be honest bytes
        return res
    try:
        decode_bundle_stream(partial)
    except WitnessError as exc:
        res["outcome"] = "typed_tear"
        res["error"] = f"{type(exc).__name__}: {exc}"
        return res
    res["outcome"] = "silent_partial"  # decoder accepted a torn stream
    return res


def run_sigterm_grid(
    base_seed: int,
    n_pairs: int = 8,
    window_size: int = 2,
    receipts: int = 3,
    events: int = 2,
    match_rate: float = 0.25,
    log=lambda msg: None,
    device: str = "cuda",
) -> dict:
    """SIGTERM (orchestrator-preemption) grid, two surfaces:

    - **in-flight backfill window**: TERM at a window-commit append while
      later windows are still un-run — resume must be byte-identical to
      the chunked-driver reference, replaying every committed window;
    - **mid-IPBS-stream**: TERM between stream sends — the committed
      prefix must decode to a typed `WitnessError`, never a document.

    ``ok`` iff every backfill point resumed identical AND every stream
    point tore typed, with at least one point per surface."""
    shape = {
        "pairs": n_pairs, "chunk_size": window_size,
        "receipts": receipts, "events": events, "match_rate": match_rate,
        "record_workers": 1,
    }
    n_windows = (n_pairs + window_size - 1) // window_size
    reference = backfill_reference(shape, device)

    rng = random.Random(base_seed)
    backfill_points = sorted(
        rng.sample(range(max(1, n_windows - 1)), k=min(2, max(1, n_windows - 1)))
    )
    counts: "dict[str, int]" = {}
    violations = []
    stream_points = []
    with tempfile.TemporaryDirectory(prefix="crashtest_sigterm_") as workdir:
        for i, crash_at in enumerate(backfill_points):
            res = backfill_crash_run(
                reference, shape, crash_at, None, workdir, tag=f"term{i}",
                term=True,
            device=device,
        )
            counts[res["outcome"]] = counts.get(res["outcome"], 0) + 1
            if res["outcome"] != "identical":
                violations.append(res)
            log(
                f"SIGTERM backfill at window {crash_at}: {res['outcome']}"
                + (
                    f" ({res.get('records_after_crash')} committed, "
                    f"{res.get('windows_replayed')} replayed)"
                    if "records_after_crash" in res else ""
                )
            )

        # fault-free stream reference (also proves the stream child works)
        stream_reference, failure = stream_reference_run(shape, workdir, device=device)
        if stream_reference is None:
            violations.append(failure)
        else:
            stream_points = [1, 3, 5]
            for i, term_at in enumerate(stream_points):
                res = sigterm_stream_run(
                    stream_reference, shape, term_at, workdir, tag=i, device=device
                )
                counts[res["outcome"]] = counts.get(res["outcome"], 0) + 1
                if res["outcome"] != "typed_tear":
                    violations.append(res)
                log(
                    f"SIGTERM stream at send {term_at}: {res['outcome']}"
                    + (
                        f" ({res.get('partial_bytes')}/"
                        f"{res.get('reference_bytes')} bytes)"
                        if "partial_bytes" in res else ""
                    )
                )
    ok = (
        not violations
        and counts.get("identical", 0) >= 1
        and counts.get("typed_tear", 0) >= 1
    )
    return {
        "ok": ok,
        "backfill_points": backfill_points,
        "stream_points": stream_points,
        "counts": counts,
        "violations": violations,
    }


def compaction_crash_run(
    reference: str,
    shape: dict,
    mode: str,
    workdir: str,
    tag: "str | int" = 0,
    torn_bytes: int = 7,
    device: str = "cuda",
) -> dict:
    """One kill-during-compaction point.

    The child runs with ``IPC_JOURNAL_COMPACT_BYTES=1`` so the very first
    chunk commit triggers a compaction, which the crash hook then kills:

    - ``mode="torn_tmp"``: ``IPC_COMPACT_CRASH_BYTES`` tears the snapshot
      sidecar at ``torn_bytes`` and SIGKILLs BEFORE the atomic swap — the
      live journal must be untouched (the torn sidecar is crash residue);
    - ``mode="post_swap"``: ``IPC_COMPACT_CRASH_POST`` SIGKILLs right
      AFTER ``os.replace`` — the journal now IS the snapshot and must
      replay to the same committed set.

    Either way the resumed run must reproduce the reference bundle
    byte-for-byte, and the post-crash journal must parse with no
    integrity error at any byte.
    """
    from ipc_proofs_tpu_torch.jobs import JOBS_JOURNAL_NAME, read_journal

    job_dir = os.path.join(workdir, f"compact_{tag}_{mode}")
    out = os.path.join(workdir, f"compact_out_{tag}_{mode}.json")
    res: dict = {"mode": mode}
    extra = {"IPC_JOURNAL_COMPACT_BYTES": "1"}
    if mode == "torn_tmp":
        extra["IPC_COMPACT_CRASH_BYTES"] = str(torn_bytes)
    elif mode == "post_swap":
        extra["IPC_COMPACT_CRASH_POST"] = "1"
    else:
        raise ValueError(f"unknown compaction crash mode {mode!r}")

    crashed = _spawn_child(job_dir, out, shape, extra_env=extra, device=device)
    if crashed.returncode != -signal.SIGKILL:
        res["outcome"] = "no_crash"
        res["rc"] = crashed.returncode
        res["stderr"] = crashed.stderr[-2000:]
        return res

    jpath = os.path.join(job_dir, JOBS_JOURNAL_NAME)
    try:
        records, _, torn_tail = read_journal(jpath)
    except Exception as exc:  # fail-soft: a corrupt journal is the grid's FINDING, reported as a violation, not a harness crash
        res["outcome"] = "journal_corrupt"
        res["error"] = f"{type(exc).__name__}: {exc}"
        return res
    res["records_after_crash"] = len(records)
    res["torn_tail"] = torn_tail
    if mode == "torn_tmp":
        # swap never happened: the torn sidecar must still be sitting there
        # and the live journal must hold the committed records untouched
        res["sidecar_left"] = os.path.exists(jpath + ".compact")
        if not res["sidecar_left"]:
            res["outcome"] = "sidecar_missing"
            return res
    if not records:
        res["outcome"] = "journal_empty"  # compaction fired after ≥1 commit
        return res

    resumed = _spawn_child(job_dir, out, shape, device=device)
    if resumed.returncode != 0:
        res["outcome"] = "resume_failed"
        res["rc"] = resumed.returncode
        res["stderr"] = resumed.stderr[-2000:]
        return res
    with open(out) as fh:
        final = fh.read()
    res["outcome"] = "identical" if final == reference else "divergent"
    return res


def run_compaction_grid(
    base_seed: int,
    n_pairs: int = 12,
    chunk_size: int = 2,
    receipts: int = 4,
    events: int = 2,
    match_rate: float = 0.2,
    log=lambda msg: None,
    device: str = "cuda",
) -> dict:
    """Kill-during-compaction grid: torn-sidecar kills at several byte
    offsets plus the post-swap kill. ``ok`` iff every point crashed,
    left a parseable journal, resumed, and reproduced the reference."""
    shape = {
        "pairs": n_pairs, "chunk_size": chunk_size,
        "receipts": receipts, "events": events, "match_rate": match_rate,
        "record_workers": 1,
    }
    reference = range_reference(shape, device)

    rng = random.Random(base_seed)
    points = [
        ("torn_tmp", rng.choice([1, 5, 11])),  # inside the first frame header
        ("torn_tmp", rng.choice([13, 64, 200])),  # inside a payload
        ("post_swap", 0),
    ]
    counts: dict[str, int] = {}
    violations = []
    with tempfile.TemporaryDirectory(prefix="crashtest_compact_") as workdir:
        for i, (mode, torn_bytes) in enumerate(points):
            res = compaction_crash_run(
                reference, shape, mode, workdir, tag=i, torn_bytes=torn_bytes, device=device
            )
            counts[res["outcome"]] = counts.get(res["outcome"], 0) + 1
            if res["outcome"] != "identical":
                violations.append(res)
            log(
                f"compaction kill [{mode}"
                + (f" torn@{torn_bytes}B" if mode == "torn_tmp" else "")
                + f"]: {res['outcome']}"
            )
    return {
        "ok": not violations,
        "points": len(points),
        "kill_points": points,
        "counts": counts,
        "violations": violations,
    }


def registry_crash_run(
    shape: dict,
    crash_at: int,
    torn: "int | None",
    workdir: str,
    tag: "str | int" = 0,
    device: str = "cuda",
) -> dict:
    """One provenance-registry kill point. The invariant is NOT
    byte-identity (the registry is append-only, not replayed) but the
    audit chain's crash contract:

    - the committed prefix is exact — ``crash_at + 1`` records for a
      boundary kill, ``crash_at`` for a torn one (residue truncatable);
    - the survivor log re-verifies: every CRC, every prev-link;
    - the resumed process reopens the SAME log and its appends extend the
      same head — the old root is a proven consistency prefix of the new.
    """
    from ipc_proofs_tpu_torch.registry.log import read_registry_frames, verify_chain
    from ipc_proofs_tpu_torch.registry.mmr import (
        MerkleLog,
        leaf_hash,
        verify_consistency,
    )

    job_dir = os.path.join(workdir, f"reg_{tag}")
    out = os.path.join(workdir, f"reg_out_{tag}.json")
    log_path = os.path.join(job_dir, "reg-crash.log")
    res: dict = {"crash_at": crash_at, "torn": torn}

    crashed = _spawn_child(
        job_dir, out, shape, crash_at=crash_at, torn=torn, registry=True, device=device
    )
    if crashed.returncode != -signal.SIGKILL:
        res["outcome"] = "no_crash"
        res["rc"] = crashed.returncode
        res["stderr"] = crashed.stderr[-2000:]
        return res

    # post-mortem: survivor log must hold the exact committed prefix,
    # chain-verified, with torn residue iff the kill was torn
    try:
        entries, _good, torn_tail = read_registry_frames(log_path)
        verify_chain(entries)
    except Exception as exc:  # fail-soft: any reopen failure IS the grid outcome under test
        res["outcome"] = "chain_corrupt"
        res["error"] = f"{type(exc).__name__}: {exc}"
        return res
    expect = crash_at if torn is not None else crash_at + 1
    res["records_after_crash"] = len(entries)
    res["torn_tail"] = torn_tail
    if len(entries) != expect:
        res["outcome"] = "commit_count_wrong"
        res["expected"] = expect
        return res
    if torn_tail != (torn is not None):
        res["outcome"] = "torn_flag_wrong"
        return res
    old_tree = MerkleLog([leaf_hash(p) for _rec, p, _off in entries])
    old_size, old_root = old_tree.size, old_tree.root()

    # resume: reopen (truncates residue, replays chain), append more
    resumed = _spawn_child(job_dir, out, shape, registry=True, device=device)
    if resumed.returncode != 0:
        res["outcome"] = "resume_failed"
        res["rc"] = resumed.returncode
        res["stderr"] = resumed.stderr[-2000:]
        return res
    try:
        entries2, _good2, torn2 = read_registry_frames(log_path)
        verify_chain(entries2)
    except Exception as exc:  # fail-soft: any reopen failure IS the grid outcome under test
        res["outcome"] = "post_resume_corrupt"
        res["error"] = f"{type(exc).__name__}: {exc}"
        return res
    res["records_after_resume"] = len(entries2)
    if torn2 or len(entries2) != old_size + shape["pairs"]:
        res["outcome"] = "resume_count_wrong"
        res["expected"] = old_size + shape["pairs"]
        return res
    new_tree = MerkleLog([leaf_hash(p) for _rec, p, _off in entries2])
    proof = (
        new_tree.consistency_path(old_size)
        if 0 < old_size < new_tree.size
        else []
    )
    if not verify_consistency(
        old_size, new_tree.size, old_root, new_tree.root(), proof
    ):
        res["outcome"] = "head_diverged"
        return res
    # the child's published head must match the auditor's recomputation
    with open(out) as fh:
        head = json.load(fh)["head"]
    if head["root"] != new_tree.root().hex() or head["size"] != new_tree.size:
        res["outcome"] = "head_mismatch"
        res["head"] = head
        return res
    res["outcome"] = "identical"
    return res


def run_registry_grid(
    base_seed: int,
    points: int = 8,
    n_records: int = 12,
    log=lambda msg: None,
    device: str = "cuda",
) -> dict:
    """Seeded kill grid over the provenance registry writer: half
    boundary kills (frame fully fsync'd), half torn mid-record writes,
    kill indices drawn over the whole append range. ``ok`` iff every
    point crashed, reopened with the exact committed prefix, re-verified
    the chain, and extended the same head — and both flavors occurred."""
    shape = {
        "pairs": n_records, "chunk_size": 2, "receipts": 1, "events": 1,
        "match_rate": 0.0, "record_workers": 1,
    }
    rng = random.Random(base_seed)
    kill_points = []
    for i in range(points):
        crash_at = rng.randrange(n_records)
        if i % 2 == 0:
            kill_points.append((crash_at, None))  # boundary kill
        else:
            # torn write: tear inside the 12-byte header or the payload
            kill_points.append((crash_at, rng.choice([1, 5, 11, 13, 64, 4096])))

    counts: dict[str, int] = {}
    violations = []
    _backend(device)  # build the kernels before any child starts
    with tempfile.TemporaryDirectory(prefix="crashtest_registry_") as workdir:
        for i, (crash_at, torn) in enumerate(kill_points):
            res = registry_crash_run(shape, crash_at, torn, workdir, tag=i, device=device)
            counts[res["outcome"]] = counts.get(res["outcome"], 0) + 1
            if res["outcome"] != "identical":
                violations.append(res)
            log(
                f"registry kill at append {crash_at}"
                + (f" torn@{torn}B" if torn is not None else " (boundary)")
                + f": {res['outcome']}"
                + (
                    f" ({res.get('records_after_crash')} committed, "
                    f"{res.get('records_after_resume')} after resume)"
                    if "records_after_crash" in res else ""
                )
            )
    boundary = sum(1 for _, t in kill_points if t is None)
    ok = (
        not violations
        and boundary > 0
        and boundary < len(kill_points)  # both flavors exercised
    )
    return {
        "ok": ok,
        "points": len(kill_points),
        "kill_points": kill_points,
        "counts": counts,
        "violations": violations,
    }


def run_grid(
    base_seed: int,
    points: int = 8,
    n_pairs: int = 12,
    chunk_size: int = 2,
    receipts: int = 4,
    events: int = 2,
    match_rate: float = 0.2,
    record_workers: int = 1,
    log=lambda msg: None,
    device: str = "cuda",
    workers: int = 1,
    reference: "str | None" = None,
) -> dict:
    """Seeded kill-point grid: half chunk-boundary kills, half torn
    mid-record writes, kill indices drawn over the whole chunk range.
    ``ok`` iff every point crashed, resumed, and reproduced the reference
    byte-for-byte — and both kill flavors actually occurred.

    ``workers`` kill points run at once, each in its own job dir (their
    children start together and load one published kernel build);
    ``libraries`` lists every kernel library path a resumed child mapped.
    ``reference`` is the uninterrupted bundle (`range_reference` of this
    shape), computed here when not given.

    ``record_workers > 1`` kills the child while several record workers
    are committing concurrently: the journal's count-clock (serialized
    under the job lock) still fires at the N-th append, but WHICH chunk
    indices made it in is scheduling-dependent — the count-based
    post-mortem and replay checks are deliberately order-agnostic."""
    shape = {
        "pairs": n_pairs, "chunk_size": chunk_size,
        "receipts": receipts, "events": events, "match_rate": match_rate,
        "record_workers": record_workers,
    }
    n_chunks = (n_pairs + chunk_size - 1) // chunk_size
    if reference is None:
        reference = range_reference(shape, device)

    rng = random.Random(base_seed)
    kill_points = []
    for i in range(points):
        crash_at = rng.randrange(n_chunks - 1) if n_chunks > 1 else 0
        if i % 2 == 0:
            kill_points.append((crash_at, None))  # boundary kill
        else:
            # torn write: tear inside the 12-byte header or the payload
            kill_points.append((crash_at, rng.choice([1, 5, 11, 13, 64, 4096])))

    counts: dict[str, int] = {}
    violations = []
    libraries: "dict[str, set]" = {}
    with tempfile.TemporaryDirectory(prefix="crashtest_") as workdir, \
            ThreadPoolExecutor(max_workers=max(1, workers)) as pool:
        results = pool.map(
            lambda i: crash_run(reference, shape, *kill_points[i], workdir, tag=i, device=device),
            range(len(kill_points)),
        )
        for (crash_at, torn), res in zip(kill_points, results):
            for name, path in res.get("libraries", {}).items():
                libraries.setdefault(name, set()).add(path)
            counts[res["outcome"]] = counts.get(res["outcome"], 0) + 1
            if res["outcome"] != "identical":
                violations.append(res)
            log(
                f"kill at record {crash_at}"
                + (f" torn@{torn}B" if torn is not None else " (boundary)")
                + f": {res['outcome']}"
                + (
                    f" ({res.get('records_after_crash')} committed, "
                    f"{res.get('chunks_replayed')} replayed)"
                    if "records_after_crash" in res else ""
                )
            )
    boundary = sum(1 for _, t in kill_points if t is None)
    ok = (
        not violations
        and boundary > 0
        and boundary < len(kill_points)  # both flavors exercised
    )
    return {
        "ok": ok,
        "points": len(kill_points),
        "kill_points": kill_points,
        "n_chunks": n_chunks,
        "counts": counts,
        "violations": violations,
        "libraries": {name: sorted(paths) for name, paths in sorted(libraries.items())},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("seed", nargs="?", type=int, help="base seed for the kill grid")
    ap.add_argument("--points", type=int, default=8, help="kill points to test")
    ap.add_argument("--pairs", type=int, default=12)
    ap.add_argument("--chunk-size", type=int, default=2)
    ap.add_argument("--receipts", type=int, default=4)
    ap.add_argument("--events", type=int, default=2)
    ap.add_argument("--match-rate", type=float, default=0.2)
    ap.add_argument(
        "--record-workers", type=int, default=1,
        help="record-stage workers in the child (>1 = concurrent commits)",
    )
    ap.add_argument("--quick", action="store_true", help="fewer kill points")
    ap.add_argument(
        "--compaction", action="store_true",
        help="also run the kill-during-compaction grid (torn snapshot "
        "sidecar + post-swap kills via IPC_COMPACT_CRASH_*)",
    )
    ap.add_argument(
        "--backfill", action="store_true",
        help="run the kill grid against the backfill engine instead of "
        "the range driver (reference = chunked driver; in --child mode, "
        "selects the backfill child)",
    )
    ap.add_argument(
        "--rebalance", action="store_true",
        help="run the kill grid against the journaled segment-rebalance "
        "handoff (storex.RebalanceJob) instead of the range driver (in "
        "--child mode, selects the rebalance child)",
    )
    ap.add_argument(
        "--sigterm", action="store_true",
        help="run the SIGTERM (preemption) grid: TERM at an in-flight "
        "backfill window commit (resume must be byte-identical) and TERM "
        "mid-IPBS-stream (the torn prefix must decode to a typed error)",
    )
    ap.add_argument(
        "--registry", action="store_true",
        help="run the kill grid against the provenance registry writer "
        "(IPC_REGISTRY_CRASH_AT/TORN): reopen must truncate residue, "
        "re-verify the hash chain, and extend the same head (in --child "
        "mode, selects the registry child)",
    )
    ap.add_argument(
        "--stream", action="store_true",
        help=argparse.SUPPRESS,  # internal: selects the IPBS stream child
    )
    # --child: the forked driver entrypoint (internal)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--job-dir", help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    ap.add_argument("--metrics-out", help=argparse.SUPPRESS)
    add_device_flag(ap)
    args = ap.parse_args(argv)

    if args.child:
        if not args.job_dir or not args.out:
            ap.error("--child needs --job-dir and --out")
        if args.rebalance:
            return rebalance_child_main(args)
        if args.stream:
            return stream_child_main(args)
        if args.registry:
            return registry_child_main(args)
        return backfill_child_main(args) if args.backfill else child_main(args)
    if args.seed is None:
        ap.error("seed is required")
    backend_for(args.device)

    points = 4 if args.quick and args.points == 8 else args.points
    t0 = time.time()
    if args.registry:
        summary = run_registry_grid(
            args.seed, points=points, n_records=args.pairs,
            log=lambda m: print(f"[{time.time()-t0:6.1f}s] {m}", flush=True),
            device=args.device,
        )
        print(json.dumps(summary, indent=2))
        if not summary["ok"]:
            print("CRASH-RECOVERY INVARIANT VIOLATED", file=sys.stderr)
            return 1
        print("CRASH RECOVERY CLEAN")
        return 0
    if args.sigterm:
        summary = run_sigterm_grid(
            args.seed,
            log=lambda m: print(f"[{time.time()-t0:6.1f}s] {m}", flush=True),
            device=args.device,
        )
        print(json.dumps(summary, indent=2))
        if not summary["ok"]:
            print("CRASH-RECOVERY INVARIANT VIOLATED", file=sys.stderr)
            return 1
        print("CRASH RECOVERY CLEAN")
        return 0
    if args.rebalance:
        summary = run_rebalance_grid(
            args.seed, n_segments=max(1, args.pairs if args.pairs != 12 else 3),
            log=lambda m: print(f"[{time.time()-t0:6.1f}s] {m}", flush=True),
            device=args.device,
        )
        print(json.dumps(summary, indent=2))
        if not summary["ok"]:
            print("CRASH-RECOVERY INVARIANT VIOLATED", file=sys.stderr)
            return 1
        print("CRASH RECOVERY CLEAN")
        return 0
    if args.backfill:
        summary = run_backfill_grid(
            args.seed, points=points, n_pairs=args.pairs,
            window_size=args.chunk_size, receipts=args.receipts,
            events=args.events, match_rate=args.match_rate,
            log=lambda m: print(f"[{time.time()-t0:6.1f}s] {m}", flush=True),
            device=args.device,
        )
        print(json.dumps(summary, indent=2))
        if not summary["ok"]:
            print("CRASH-RECOVERY INVARIANT VIOLATED", file=sys.stderr)
            return 1
        print("CRASH RECOVERY CLEAN")
        return 0
    summary = run_grid(
        args.seed, points=points, n_pairs=args.pairs,
        chunk_size=args.chunk_size, receipts=args.receipts,
        events=args.events, match_rate=args.match_rate,
        record_workers=args.record_workers,
        log=lambda m: print(f"[{time.time()-t0:6.1f}s] {m}", flush=True),
        device=args.device,
    )
    if args.compaction:
        summary["compaction"] = run_compaction_grid(
            args.seed, n_pairs=args.pairs, chunk_size=args.chunk_size,
            receipts=args.receipts, events=args.events,
            match_rate=args.match_rate,
            log=lambda m: print(f"[{time.time()-t0:6.1f}s] {m}", flush=True),
            device=args.device,
        )
        summary["ok"] = summary["ok"] and summary["compaction"]["ok"]
    print(json.dumps(summary, indent=2))
    if not summary["ok"]:
        print("CRASH-RECOVERY INVARIANT VIOLATED", file=sys.stderr)
        return 1
    print("CRASH RECOVERY CLEAN")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
