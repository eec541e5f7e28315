"""One-shot static gate for the port: every repo-native checker in sequence.

The port's counterpart of the reference's ``tools/check_all.py``, with the
same gates in the same order:

1. **ipclint** — lock discipline, determinism, error taxonomy, metrics
   vocabulary over ``ipc_proofs_tpu_torch`` (AST-level, fast);
2. **bench schema** — the port's artifacts (``bench_torch_runs/BENCH_*.json``,
   printed by ``bench_torch.py`` on the card) against the reporting
   contract, through the port's ``check_bench_schema`` (the JAX package's
   ``BENCH_*.json`` at the repo root are not the port's and go through
   nothing here); without any it prints the reference's "skipped" line;
3. **sanitizer probe** — the ASan/UBSan toolchain is present and a probe
   binary compiles and runs (reported, never fatal). Pass ``--san`` to run
   ``build_native_san`` instead: the sanitized host build with the port's
   native tests, and the CUDA kernels under ``compute-sanitizer`` where
   there is a card.

Pass ``--lockdep`` to add a fourth, *dynamic* gate: the port's lock-heavy
test files re-run under ``IPC_LOCKDEP=1`` (strict runtime lock-order
witness, see ``ipc_proofs_tpu_torch/utils/lockdep.py``), with
``tests/test_torch_cuda.py``, which skips without a card and runs the
card's paths under the witness on one. Any acquisition-order inversion,
non-reentrant re-entry, or flock/thread mixed-order violation the tests
exercise raises ``LockOrderError`` and fails the gate.

Exit 0 only when every gate passes::

    python -m ipc_proofs_tpu_torch.tools.check_all            # lint + schema + probe
    python -m ipc_proofs_tpu_torch.tools.check_all --san      # …with the sanitizer run
    python -m ipc_proofs_tpu_torch.tools.check_all --lockdep  # …plus the lockdep sweep
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[2]

# The port's counterparts of the reference's LOCKDEP_TEST_FILES, one by one
# (a port file that covers two reference files appears once): serve plane,
# durable admission, tiered store + flocked segment eviction, job journal,
# pipeline, cluster router, thread budget; then the card's paths.
LOCKDEP_TEST_FILES = (
    "tests/test_torch_auditview.py",  # tests/test_auditview.py
    "tests/test_torch_backfill.py",  # tests/test_backfill.py
    "tests/test_torch_cluster.py",  # tests/test_cluster.py
    "tests/test_torch_cluster_replica.py",  # tests/test_cluster_replica.py
    "tests/test_torch_crashtest.py",  # tests/test_crash_recovery.py
    "tests/test_torch_fetchplane.py",  # tests/test_fetchplane.py
    "tests/test_torch_fleet.py",  # tests/test_fleet.py
    "tests/test_torch_jobs.py",  # tests/test_jobs.py
    "tests/test_torch_pipeline.py",  # tests/test_lockdep.py, tests/test_threads.py
    "tests/test_torch_parallel.py",  # tests/test_parallel.py
    "tests/test_torch_range_pipeline.py",  # tests/test_range_pipeline.py
    "tests/test_torch_registry.py",  # tests/test_registry.py
    "tests/test_torch_replica.py",  # tests/test_replica.py
    "tests/test_torch_serve.py",  # tests/test_serve.py
    "tests/test_torch_durable.py",  # tests/test_serve_durable.py
    "tests/test_torch_slo.py",  # tests/test_slo.py
    "tests/test_torch_rpc.py",  # tests/test_store.py
    "tests/test_torch_httpd.py",  # tests/test_stream_qos.py
    "tests/test_torch_storex.py",  # tests/test_storex.py
    "tests/test_torch_subs.py",  # tests/test_subs.py
    "tests/test_torch_cuda.py",  # the card's paths (skips without one)
)


def _gate(
    name: str, argv: "list[str]", env: "dict[str, str] | None" = None
) -> bool:
    print(f"check_all: [{name}] {' '.join(argv)}", flush=True)
    run_env = None
    if env:
        run_env = dict(os.environ)
        run_env.update(env)
    proc = subprocess.run(
        [sys.executable, *argv], cwd=REPO_ROOT, timeout=1800, env=run_env
    )
    ok = proc.returncode == 0
    print(f"check_all: [{name}] {'ok' if ok else f'FAILED (exit {proc.returncode})'}", flush=True)
    return ok


def main(argv: "list[str] | None" = None) -> int:
    ap = argparse.ArgumentParser(
        prog="ipc_proofs_tpu_torch.tools.check_all",
        description="run every repo-native static gate over the port",
    )
    ap.add_argument(
        "--san", action="store_true",
        help="run the full sanitizer build + native tests, not just the probe",
    )
    ap.add_argument(
        "--lockdep", action="store_true",
        help="re-run the port's lock-heavy test files under IPC_LOCKDEP=1 "
        "(strict runtime lock-order witness; any inversion fails the gate)",
    )
    args = ap.parse_args(argv)

    ok = _gate("ipclint", ["-m", "ipc_proofs_tpu_torch.tools.ipclint", "ipc_proofs_tpu_torch"])

    artifacts = sorted(p.relative_to(REPO_ROOT).as_posix() for p in REPO_ROOT.glob("bench_torch_runs/BENCH_*.json"))
    if artifacts:
        ok &= _gate("bench-schema", ["-m", "ipc_proofs_tpu_torch.tools.check_bench_schema", *artifacts])
    else:
        print("check_all: [bench-schema] no BENCH_*.json artifacts — skipped")

    if args.san:
        ok &= _gate("sanitizer", ["-m", "ipc_proofs_tpu_torch.tools.build_native_san"])
    else:
        from ipc_proofs_tpu_torch.tools.build_native_san import probe_toolchain

        available, detail = probe_toolchain()
        if available:
            print("check_all: [sanitizer] toolchain available (probe compiled+ran)")
        else:
            print(f"check_all: [sanitizer] SKIP ({detail})")

    if args.lockdep:
        present = [f for f in LOCKDEP_TEST_FILES if (REPO_ROOT / f).exists()]
        ok &= _gate(
            "lockdep",
            [
                "-m", "pytest", *present, "-q", "-m", "not slow",
                "-p", "no:cacheprovider", "-p", "no:randomly",
            ],
            env={"IPC_LOCKDEP": "1", "JAX_PLATFORMS": "cpu"},
        )

    print("check_all: " + ("all gates passed" if ok else "FAILED"), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
