"""`ipc_proofs_tpu_torch.tools.crashtest` against the reference's
``tools/crashtest.py``, children on the host (``device="cpu"``).

- ``run_grid(seed, points=4, n_pairs=12, chunk_size=2)`` kills its child
  at the reference's kill points for the same seed (both flavours), and
  every point resumes byte-identical to the uninterrupted bundle, which is
  the reference package's byte for byte.
- One point each of the compaction (post-swap), registry (torn) and
  SIGTERM-stream grids holds its invariant; the points' children are
  ``python -m ipc_proofs_tpu_torch.tools.crashtest --child`` and load no
  JAX.
- A child that dies of another signal, or exits with an error, is never
  taken for a kill.
"""

import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("jax")

import tools.crashtest as ref_ct  # noqa: E402
from ipc_proofs_tpu_torch.tools import crashtest  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
SEED = 20260817
SHAPE = {"pairs": 12, "chunk_size": 2, "receipts": 4, "events": 2, "match_rate": 0.2, "record_workers": 1}


def _reference_kill_points(monkeypatch, seed: int, **kw) -> "tuple[list, str]":
    """The reference grid's kill points and uninterrupted bundle for
    ``seed``, its children stubbed out (no JAX process is spawned)."""
    seen = {}

    def no_child(reference, shape, crash_at, torn, workdir, tag=0):
        seen["reference"] = reference
        return {"outcome": "identical", "crash_at": crash_at, "torn": torn}

    monkeypatch.setattr(ref_ct, "crash_run", no_child)
    summary = ref_ct.run_grid(seed, **kw)
    return [tuple(p) for p in summary["kill_points"]], seen["reference"]


def test_range_grid_matches_the_reference(monkeypatch):
    kw = dict(points=4, n_pairs=12, chunk_size=2)
    ref_points, ref_bundle = _reference_kill_points(monkeypatch, SEED, **kw)
    seen = {}
    crash_run = crashtest.crash_run

    def spy(reference, *args, **kwargs):
        seen["reference"] = reference
        return crash_run(reference, *args, **kwargs)

    monkeypatch.setattr(crashtest, "crash_run", spy)
    summary = crashtest.run_grid(SEED, device="cpu", workers=2, **kw)
    assert summary["ok"], summary
    assert [tuple(p) for p in summary["kill_points"]] == ref_points
    assert {t is None for _, t in ref_points} == {True, False}  # both flavours
    assert summary["counts"] == {"identical": 4}
    assert seen["reference"] == ref_bundle  # the uninterrupted bundle, byte for byte
    assert summary["libraries"] == {}  # the plain versions load no kernel library


def test_compaction_post_swap_point(tmp_path):
    reference = crashtest.range_reference(SHAPE, device="cpu")
    res = crashtest.compaction_crash_run(reference, SHAPE, "post_swap", str(tmp_path), device="cpu")
    assert res["outcome"] == "identical", res
    assert res["records_after_crash"] >= 1


def test_registry_torn_point(tmp_path):
    shape = dict(SHAPE, pairs=6)
    res = crashtest.registry_crash_run(shape, 3, 13, str(tmp_path), device="cpu")
    assert res["outcome"] == "identical", res
    assert (res["records_after_crash"], res["records_after_resume"], res["torn_tail"]) == (3, 9, True)


def test_sigterm_stream_point(tmp_path):
    shape = dict(SHAPE, pairs=8, receipts=3, match_rate=0.25)
    reference, failure = crashtest.stream_reference_run(shape, str(tmp_path), device="cpu")
    assert failure is None, failure
    res = crashtest.sigterm_stream_run(reference, shape, 3, str(tmp_path), device="cpu")
    assert res["outcome"] == "typed_tear", res
    assert 0 < res["partial_bytes"] < res["reference_bytes"]


def test_a_child_that_dies_otherwise_is_no_kill(tmp_path, monkeypatch):
    def killed_by(sig):
        def run(cmd, **kwargs):  # the child's end: another signal, or an error exit
            rc = -sig if sig is not None else 1
            return subprocess.CompletedProcess(cmd, rc, "", "RuntimeError: CUDA error: an illegal memory access")
        return run

    for sig in (signal.SIGSEGV, signal.SIGTERM, None):
        monkeypatch.setattr(crashtest.subprocess, "run", killed_by(sig))
        res = crashtest.crash_run("{}", SHAPE, 1, None, str(tmp_path), tag=str(sig), device="cpu")
        assert res["outcome"] == "no_crash" and "CUDA error" in res["stderr"], res


def test_child_runs_the_port_as_a_module(tmp_path):
    out = tmp_path / "out.json"
    proc = crashtest._spawn_child(str(tmp_path / "job"), str(out), dict(SHAPE, pairs=4), device="cpu",
                                  metrics_out=str(tmp_path / "m.json"))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(out.read_text())["event_proofs"]
    child = json.loads((tmp_path / "m.json").read_text())
    assert child["libraries"] == {} and "range_proofs" in child["counters"]
    refused = subprocess.run(
        [sys.executable, "-m", "ipc_proofs_tpu_torch.tools.crashtest", "--child", "--job-dir",
         str(tmp_path / "j2"), "--out", str(tmp_path / "o2.json")],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": os.environ.get("PATH", "/usr/bin:/bin")},
    )
    assert refused.returncode != 0 and "--device cuda" in refused.stderr
