"""Shared plumbing of the ``tests/test_torch_bench_legs_*.py`` files: run a
leg of ``bench_torch.py`` in process at ``--platform cpu`` and tiny shapes,
and the reference leg's key set and (where it runs on the CPU in seconds)
its numbers.

The reference leg's keys are read from ``bench.py`` itself: the keys of
the dict literal every ``return`` of its ``_leg_<name>`` builds (all of
them must agree). That needs no JAX device and holds for every leg; the
legs whose reference runs on the host in seconds are also run, in
process, at the same arguments, and their counts fixed by bytes compared.
"""

from __future__ import annotations

import ast
import os
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import bench  # noqa: E402
import bench_torch  # noqa: E402

# tiny shapes for every leg: 8 pairs, 8 serve requests, 4 baseline pairs
TINY = ["--quick", "--tipsets", "8", "--serve-requests", "8", "--baseline-pairs", "4"]


def reference_keys(leg: str) -> "set[str]":
    """The keys of the dict every ``return`` of the reference's
    ``_leg_<leg>`` builds."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == f"_leg_{leg}")
    key_sets = [{k.value for k in r.value.keys if isinstance(k, ast.Constant)} for r in leg_returns(fn)]
    assert key_sets and all(ks == key_sets[0] for ks in key_sets), leg
    return key_sets[0]


def leg_returns(fn: ast.FunctionDef) -> "list[ast.Return]":
    """The ``return <dict literal>`` statements of ``fn`` itself (not of
    the functions nested in it)."""
    out, todo = [], list(fn.body)
    while todo:
        node = todo.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda, ast.ClassDef)):
            continue
        if isinstance(node, ast.Return) and isinstance(node.value, ast.Dict):
            out.append(node)
        todo.extend(ast.iter_child_nodes(node))
    return out


def args_for(module, leg: str, *extra: str):
    return module._parse_args(["--leg", leg, "--platform", "cpu", *TINY, *extra])


@pytest.fixture
def bench_env(monkeypatch, tmp_path):
    """Every env var a leg sets comes back, the verify lane's tuned
    crossover is reset, and temp files (a spawned shard's log) land in
    ``tmp_path``."""
    import tempfile

    from ipc_proofs_tpu_torch.ops import verify

    saved = dict(os.environ)
    monkeypatch.setattr(verify, "_tuned_min_bytes", verify._tuned_min_bytes)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.delenv("IPC_BENCH_PLATFORM", raising=False)
    yield tmp_path
    for name in set(os.environ) - set(saved):
        del os.environ[name]
    os.environ.update(saved)


def run_port_leg(leg: str, *extra: str) -> dict:
    """The port's leg at ``--platform cpu``: its JSON dict, ``_platform``
    checked (``cpu``) and taken out, its keys equal to the reference's."""
    out = bench_torch._LEG_FNS[leg](args_for(bench_torch, leg, *extra))
    assert out.pop("_platform") == "cpu"
    assert set(out) == reference_keys(leg) - {"_platform"}, set(out) ^ reference_keys(leg)
    return out


def run_reference_leg(leg: str, *extra: str) -> dict:
    """The reference's leg (a host-only one) at the same arguments."""
    out = bench._LEG_FNS[leg](args_for(bench, leg, *extra))
    out.pop("_platform", None)
    return out


def same(port: dict, ref: dict, keys) -> None:
    """``keys`` (the counts fixed by bytes) hold the same values."""
    for key in keys:
        assert port[key] == ref[key], (key, port[key], ref[key])
