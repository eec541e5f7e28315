"""`ipc_proofs_tpu_torch.tools.check_bench_schema` against the reference's
``tools/check_bench_schema.py``: the same problem list, skip reasons and
CLI output for every artifact.

Every test of ``tests/test_bench_schema.py`` runs here a second time with
the checker's names — ``check_artifact``, each ``*_gate_skip_reason`` and
``main`` — bound to a differential: each call goes to both checkers with
the same input, their answers (and ``main``'s printed lines and exit code)
must be equal, and the reference's answer goes back to the test. That
covers every checked-in ``BENCH_r*.json`` in both modes and each synthetic
regression. The port's own artifacts (``bench_torch_runs/``) pass the
port's checker in non-current mode.
"""

import contextlib
import copy
import glob
import io
import json
import os
import subprocess
import sys

import pytest

import test_bench_schema as ref_tests
from ipc_proofs_tpu_torch.tools import check_bench_schema as port_checker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ref_checker = sys.modules[ref_tests.check_artifact.__module__]
PORT_ARTIFACTS = sorted(glob.glob(os.path.join(REPO, "bench_torch_runs", "BENCH_*.json")))
CHECKER_NAMES = [name for name in vars(ref_tests) if name == "check_artifact" or name.endswith("_skip_reason")]


def _differential(name):
    ref_fn, port_fn = getattr(ref_checker, name), getattr(port_checker, name)

    def both(*args, **kwargs):
        port_args, port_kwargs = copy.deepcopy(args), copy.deepcopy(kwargs)
        want = ref_fn(*args, **kwargs)
        assert port_fn(*port_args, **port_kwargs) == want, name
        return want

    return both


def _main_both(argv=None):
    outs = []
    for fn in (ref_checker.main, port_checker.main):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = fn(list(argv) if argv is not None else None)
        outs.append((rc, buf.getvalue()))
    assert outs[1] == outs[0]
    print(outs[0][1], end="")
    return outs[0][0]


@pytest.fixture(autouse=True)
def _both_checkers(monkeypatch):
    for name in CHECKER_NAMES:
        monkeypatch.setattr(ref_tests, name, _differential(name))
    monkeypatch.setattr(ref_tests, "main", _main_both)


class TestCheckedInArtifacts(ref_tests.TestCheckedInArtifacts):
    pass


class TestSyntheticRegressions(ref_tests.TestSyntheticRegressions):
    pass


class TestSpeedupGate(ref_tests.TestSpeedupGate):
    pass


class TestClusterGate(ref_tests.TestClusterGate):
    pass


class TestOnchipGate(ref_tests.TestOnchipGate):
    pass


class TestWitnessDietGate(ref_tests.TestWitnessDietGate):
    pass


class TestFleetObsGate(ref_tests.TestFleetObsGate):
    pass


class TestHostkillGate(ref_tests.TestHostkillGate):
    pass


def test_every_reference_test_class_runs_through_both():
    here = {name for name, obj in globals().items() if isinstance(obj, type) and name.startswith("Test")}
    there = {name for name, obj in vars(ref_tests).items() if isinstance(obj, type) and name.startswith("Test")}
    assert here == there


def test_the_checkers_hold_the_same_contract():
    for name in ("_CORE_REQUIRED", "_KNOWN_TYPES", "_CURRENT_REQUIRED", "_WRAPPER_KEYS"):
        assert getattr(port_checker, name) == getattr(ref_checker, name), name
    ref_public = {n for n in vars(ref_checker) if not n.startswith("_") and callable(getattr(ref_checker, n))}
    port_public = {n for n in vars(port_checker) if not n.startswith("_") and callable(getattr(port_checker, n))}
    assert port_public == ref_public


@pytest.mark.parametrize("require_current", [False, True])
def test_every_reference_artifact_gives_the_same_problems(require_current):
    for path in ref_tests.ARTIFACTS:
        with open(path) as fh:
            obj = json.load(fh)
        assert port_checker.check_artifact(copy.deepcopy(obj), require_current) == ref_checker.check_artifact(
            obj, require_current
        ), path


@pytest.mark.parametrize("path", PORT_ARTIFACTS, ids=os.path.basename)
def test_the_ports_artifacts_pass_the_ports_checker(path):
    with open(path) as fh:
        obj = json.load(fh)
    assert port_checker.check_artifact(obj) == []
    assert obj["platform"] == "cuda" and set(obj["legs"]) == {
        "e2e", "kernel", "cid", "baseline", "native_baseline", "serve", "witness", "resilience",
        "durability", "observability", "storage", "asyncfetch", "cluster", "standing", "fleetobs",
        "onchip", "backfill", "zerocopy", "hostkill", "overload", "registry",
    }


def test_port_artifacts_stay_out_of_the_reference_glob():
    assert PORT_ARTIFACTS, "no bench_torch_runs/BENCH_*.json committed"
    assert not set(PORT_ARTIFACTS) & set(ref_tests.ARTIFACTS)


def test_the_cli_runs_as_a_module_without_the_reference(tmp_path):
    """``python -m ipc_proofs_tpu_torch.tools.check_bench_schema``: the
    reference's output for a reference artifact, and neither ``tools`` nor
    ``ipc_proofs_tpu`` nor ``jax`` loaded."""
    path = ref_tests.NEWEST
    code = (
        "import runpy, sys\n"
        f"sys.argv = ['check_bench_schema', '--require-current', {path!r}]\n"
        "try:\n"
        "    runpy.run_module('ipc_proofs_tpu_torch.tools.check_bench_schema', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    rc = e.code\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'ipc_proofs_tpu', 'tools', 'check_bench_schema')]\n"
        "assert not bad, bad\n"
        "print('rc', rc)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr
    want = io.StringIO()
    with contextlib.redirect_stdout(want):
        rc = ref_checker.main(["--require-current", path])
    assert proc.stdout == want.getvalue() + f"rc {rc}\n"
