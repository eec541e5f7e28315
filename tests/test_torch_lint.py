"""The port's static gates (``ipc_proofs_tpu_torch/tools/``: ``ipclint``,
``check_all``, ``build_native_san``) against the reference's (repo-root
``tools/``), and the port's tree under them.

- Every fixture of ``tests/test_lint.py``'s rule classes runs through both
  linters: the reference's fixture test itself, with its ``run_lint``
  swapped for one that lints the fixture with each package's
  ``lint_paths`` (its files under the reference's package paths for the
  reference, under the port's for the port: the determinism scope and the
  metrics vocabulary are each package's own) and requires the same
  ``(rule, line)`` findings from both; the test's own assertions then hold
  for the linter it is parametrised with. The CLI's exit code and
  ``--json`` records are the same for both modules.
- The real tree: the port is clean under the port's linter, its
  ``check_all`` exits 0, the ``--lockdep`` gate passes over one file
  (the whole sweep is marked ``slow``), the sanitizer profile is the
  reference's and a sanitized build gets a name of its own, and the port
  counts ``deadline.rejects.rpc`` where the reference does.
"""

import importlib.util
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from ipc_proofs_tpu_torch.tools import check_all
from ipc_proofs_tpu_torch.tools import ipclint as port_ipclint
from tools import ipclint as ref_ipclint

ROOT = Path(__file__).resolve().parent.parent


def _load_reference_tests():
    spec = importlib.util.spec_from_file_location("_reference_lint_tests", ROOT / "tests" / "test_lint.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


REF_TESTS = _load_reference_tests()
RULE_CLASSES = (
    "TestRaceRules", "TestDetRules", "TestErrRules", "TestVocabRules",
    "TestLockOrderRules", "TestParseError", "TestSuppression",
)
# fixtures that lint no snippet through `run_lint` (the CLI's, run below
# for both modules)
CLI_FIXTURES = {"TestParseError.test_cli_exits_nonzero_and_emits_json"}
FIXTURES = [
    f"{cls}.{name}"
    for cls in RULE_CLASSES
    for name in sorted(vars(getattr(REF_TESTS, cls)))
    if name.startswith("test_") and f"{cls}.{name}" not in CLI_FIXTURES
]
LINTERS = {"reference": (ref_ipclint, "ipc_proofs_tpu/"), "port": (port_ipclint, "ipc_proofs_tpu_torch/")}


def _run_lint(root: Path, files: "dict[str, str]", check_vocab: bool, lint_paths):
    """`tests/test_lint.py::run_lint` with the linter as an argument."""
    for rel, source in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(source))
    run = lint_paths([str(root)], repo_root=str(root), check_vocab=check_vocab)
    return [(f.rule, f.line) for f in run.findings]


def _lint(linter: str, root: Path, files: "dict[str, str]", check_vocab: bool = False):
    """Lint the fixture ``files`` with ``linter``, the reference package's
    paths moved under the linter's own package."""
    module, package = LINTERS[linter]
    moved = {package + rel.removeprefix("ipc_proofs_tpu/") if rel.startswith("ipc_proofs_tpu/") else rel: src
             for rel, src in files.items()}
    return _run_lint(root, moved, check_vocab, module.lint_paths)


def test_fixture_list_covers_every_rule_class():
    assert len(FIXTURES) == 32
    assert {f.split(".")[0] for f in FIXTURES} == set(RULE_CLASSES)


@pytest.mark.parametrize("linter", sorted(LINTERS))
@pytest.mark.parametrize("fixture", FIXTURES)
def test_reference_fixture_gives_the_same_findings(monkeypatch, tmp_path, fixture, linter):
    calls = []

    def run_lint(_tmp, files, check_vocab=False):
        got = {
            name: sorted(_lint(name, tmp_path / f"{len(calls)}-{name}", files, check_vocab))
            for name in LINTERS
        }
        assert got["port"] == got["reference"], got
        calls.append(got)
        return got[linter]

    monkeypatch.setattr(REF_TESTS, "run_lint", run_lint)
    cls_name, method = fixture.split(".")
    getattr(getattr(REF_TESTS, cls_name)(), method)(tmp_path)
    assert calls, f"{fixture} linted nothing"


@pytest.mark.parametrize("module", ["tools.ipclint", "ipc_proofs_tpu_torch.tools.ipclint"])
def test_cli_exits_nonzero_and_emits_json(tmp_path, module):
    bad = tmp_path / "bad.py"
    bad.write_text("def broken(:\n    pass\n")
    proc = subprocess.run(
        [sys.executable, "-m", module, str(bad), "--no-vocab", "--json"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 1
    records = [json.loads(line) for line in proc.stdout.splitlines() if line]
    assert [r["rule"] for r in records] == ["parse-error"]
    assert all(set(r) == {"rule", "path", "line", "message"} for r in records)
    assert proc.stderr.strip() == "ipclint: 1 finding(s) in 0 file(s)"


@pytest.mark.parametrize("linter", sorted(LINTERS))
def test_each_package_has_its_own_determinism_scope(tmp_path, linter):
    """A wall-clock read in ``core/`` fires under the linter's own package
    only."""
    source = "import time\n\ndef stamp():\n    return time.time()\n"
    files = {"ipc_proofs_tpu_torch/core/mod.py": source, "ipc_proofs_tpu/core/mod.py": source}
    for rel, text in files.items():
        (tmp_path / rel).parent.mkdir(parents=True)
        (tmp_path / rel).write_text(text)
    module, package = LINTERS[linter]
    run = module.lint_paths([str(tmp_path)], repo_root=str(tmp_path), check_vocab=False)
    assert [(f.path, f.rule) for f in run.findings] == [(package + "core/mod.py", "det-wallclock")]


def test_rules_and_finding_text_are_the_references():
    assert port_ipclint.RULES == ref_ipclint.RULES
    args = ("a/b.py", 3, "race-guard", "msg")
    assert port_ipclint.Finding(*args).render() == ref_ipclint.Finding(*args).render()


# --- the real tree --------------------------------------------------------


def test_port_tree_is_lint_clean():
    """The enforcement test: the port has zero findings under its linter."""
    proc = subprocess.run(
        [sys.executable, "-m", "ipc_proofs_tpu_torch.tools.ipclint"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, f"ipclint found violations:\n{proc.stdout}"
    assert proc.stderr.startswith("ipclint: clean (")


def test_check_all_gate_passes():
    """The chained gate (ipclint → bench schema → sanitizer probe)."""
    proc = subprocess.run(
        [sys.executable, "-m", "ipc_proofs_tpu_torch.tools.check_all"],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, f"{proc.stdout}\n{proc.stderr}"
    assert "check_all: [bench-schema] -m ipc_proofs_tpu_torch.tools.check_bench_schema bench_torch_runs/" in proc.stdout
    assert "check_all: [bench-schema] ok" in proc.stdout
    assert "check_all: all gates passed" in proc.stdout


def test_lockdep_files_are_the_references_counterparts():
    """Each reference file of the sweep is named beside its port
    counterpart, and every port file exists; the card's file comes last."""
    from tools.check_all import LOCKDEP_TEST_FILES as REF_FILES

    source = (ROOT / "ipc_proofs_tpu_torch" / "tools" / "check_all.py").read_text()
    assert all(f"# {f}" in source or f", {f}" in source for f in REF_FILES)
    assert all((ROOT / f).is_file() for f in check_all.LOCKDEP_TEST_FILES)
    assert check_all.LOCKDEP_TEST_FILES[-1] == "tests/test_torch_cuda.py"


def test_lockdep_gate_passes_over_one_file(monkeypatch, capfd):
    monkeypatch.setattr(check_all, "LOCKDEP_TEST_FILES", ("tests/test_torch_pipeline.py",))
    assert check_all.main(["--lockdep"]) == 0
    out = capfd.readouterr().out
    assert "check_all: [lockdep] ok" in out and "tests/test_torch_pipeline.py" in out


@pytest.mark.slow
def test_check_all_lockdep_sweep_passes():
    """The whole dynamic gate: the port's lock-heavy files under
    ``IPC_LOCKDEP=1`` observe zero inversions."""
    proc = subprocess.run(
        [sys.executable, "-m", "ipc_proofs_tpu_torch.tools.check_all", "--lockdep"],
        cwd=ROOT, capture_output=True, text=True, timeout=1800,
    )
    assert proc.returncode == 0, f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}"


def test_sanitizer_flags_are_the_references():
    from ipc_proofs_tpu.core._cid_native import SAN_FLAGS as REF_SAN_FLAGS
    from ipc_proofs_tpu_torch.core._cid_native import SAN_FLAGS

    assert SAN_FLAGS == REF_SAN_FLAGS


_BUILD_BOTH = """
import json, os, sys
from pathlib import Path
from ipc_proofs_tpu_torch.core import _cid_native as n
build_dir = Path(sys.argv[1])
src = n.NATIVE_DIR / "dagcbor_ext.c"
fast = Path(n.build_cpython_ext(src, "ipc_torch_dagcbor_ext", build_dir).__file__)
inode = fast.stat().st_ino
os.environ["IPC_PROOFS_SAN"] = "1"
san = Path(n.build_cpython_ext(src, "ipc_torch_dagcbor_ext", build_dir).__file__)
print(json.dumps({"fast": fast.name, "san": san.name, "kept": fast.stat().st_ino == inode,
                  "files": sorted(p.name for p in build_dir.iterdir())}))
"""


def test_sanitized_build_gets_its_own_name(tmp_path):
    """Under ``IPC_PROOFS_SAN=1`` the builder compiles with `SAN_FLAGS`
    into ``<module>-<hash>.san.so`` beside the fast build, which stays."""
    from ipc_proofs_tpu_torch.tools.build_native_san import _san_env, probe_toolchain

    ok, preload = probe_toolchain()
    if not ok:
        pytest.skip(f"sanitizer toolchain unavailable: {preload}")
    env = _san_env(preload)
    env.pop("IPC_PROOFS_SAN")
    proc = subprocess.run(
        [sys.executable, "-c", _BUILD_BOTH, str(tmp_path)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = json.loads(proc.stdout.splitlines()[-1])
    assert got["kept"] and got["san"].endswith(".san.so") and not got["fast"].endswith(".san.so")
    assert got["san"].split("-")[0] == got["fast"].split("-")[0] == "ipc_torch_dagcbor_ext"
    assert got["files"] == sorted([got["fast"], got["san"]])


def _plain_call(entry, extra):
    """A stand-in for a kernel entry on the CPU: its plain version written
    into the guarded output."""
    from ipc_proofs_tpu_torch.tools.build_native_san import _plain

    plain = _plain(entry)
    return lambda views, out: out.copy_(plain(*views))


def test_guard_band_check_passes_the_plain_versions(monkeypatch):
    """`check_kernels` over every entry at the edge lengths, with the plain
    versions standing in for the kernels: every case launched once a fill,
    nothing flagged."""
    import torch

    from ipc_proofs_tpu_torch.tools import build_native_san as san

    monkeypatch.setattr(san, "ROW_COUNTS", (1, 33, 129))
    report = san.check_kernels(torch.device("cpu"), _plain_call)
    assert sorted(report) == sorted([
        "blake2b256_single_block", "blake2b256_two_block", "blake2b256_blocks",
        "keccak256_single_block", "keccak256_blocks",
    ])
    for row in report.values():
        assert row == {"launches": 3 * san.GUARD_FILLS, "rows": [1, 33, 129], "violations": [], "mismatches": 0}


@pytest.mark.parametrize("fault", ["write past the output", "write an input", "read past an input",
                                   "leave a row unwritten"])
def test_guard_band_check_catches_each_fault(fault):
    """Each fault a memory checker looks for, made on purpose by a stand-in
    for the kernel, shows as a violation or as a result that differs from
    the plain version under one of the two fills."""
    import torch

    from ipc_proofs_tpu_torch.tools import build_native_san as san

    entry, n, inputs, extra = next(c for c in san.kernel_cases() if c[0] == "blake2b256_blocks" and c[1] == 33)
    plain = san._plain(entry)
    want = plain(*(torch.from_numpy(a.view("int32")) for a in inputs))

    def call(views, out):
        if fault == "read past an input":
            views = [torch.as_strided(v, v.shape, v.stride(), v.storage_offset() + 32) for v in views]
        result = plain(*views)
        rows = n - 1 if fault == "leave a row unwritten" else n
        out[:rows] = result[:rows]
        if fault == "write past the output":
            torch.as_strided(out, (out.numel() + 1,), (1,))[-1] = 7
        elif fault == "write an input":
            views[0].view(-1)[5] ^= 1

    runs = [san.guarded_run(call, inputs, n, torch.device("cpu"), fill_seed=fill) for fill in range(san.GUARD_FILLS)]
    flagged = any(violations for _, violations in runs)
    wrong = any(not torch.equal(out, want) for out, _ in runs)
    assert flagged if fault.startswith("write") else wrong and not flagged


class _MaxJitterRng:
    def uniform(self, lo, hi):
        return hi


class _DownSession:
    def post(self, endpoint, data=None, headers=None, timeout=None):
        raise ConnectionError("transport down")


def test_rpc_deadline_reject_is_counted_as_the_reference_counts_it(monkeypatch):
    """A retry whose backoff the ambient budget cannot cover raises
    `DeadlineError` and counts ``deadline.rejects.rpc`` once, in both
    packages."""
    import ipc_proofs_tpu.store.rpc as ref_rpc
    import ipc_proofs_tpu.utils.deadline as ref_deadline
    import ipc_proofs_tpu.utils.metrics as ref_metrics
    import ipc_proofs_tpu_torch.store.rpc as port_rpc
    import ipc_proofs_tpu_torch.utils.deadline as port_deadline
    import ipc_proofs_tpu_torch.utils.metrics as port_metrics

    seen = {}
    for name, rpc, deadline, metrics in (
        ("port", port_rpc, port_deadline, port_metrics),
        ("reference", ref_rpc, ref_deadline, ref_metrics),
    ):
        sleeps = []
        monkeypatch.setattr(rpc.time, "sleep", sleeps.append)
        m = metrics.Metrics()
        client = rpc.LotusClient("http://fake", session=_DownSession(), metrics=m, max_retries=4,
                                 backoff_base_s=10.0, rng=_MaxJitterRng())
        scope = deadline.CancelScope(deadline.Deadline(1.0, clock=lambda: 0.0))
        with deadline.use_scope(scope), pytest.raises(deadline.DeadlineError) as info:
            client.request("Filecoin.Thing", [])
        seen[name] = (str(info.value), sleeps, m.snapshot()["counters"])
    assert seen["port"] == seen["reference"]
    assert seen["port"][2]["deadline.rejects.rpc"] == 1 and seen["port"][1] == []


def test_gates_import_nothing_of_the_reference():
    """The port's gate modules run without the reference: a fresh process
    imports them and ends with no ``tools``, ``ipc_proofs_tpu`` or
    ``jax`` module loaded."""
    code = (
        "import sys\n"
        "import ipc_proofs_tpu_torch.tools.ipclint.__main__, ipc_proofs_tpu_torch.tools.check_all\n"
        "import ipc_proofs_tpu_torch.tools.build_native_san\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in ('tools', 'ipc_proofs_tpu', 'jax')))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"
