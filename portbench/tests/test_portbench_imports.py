"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program.

Top-level module names (the part before the first dot) are compared whole:
``ipc_proofs_tpu_torch`` begins with ``ipc_proofs_tpu`` and is no match.
"""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from portbench.tests.conftest import ROOT

PORTBENCH = ROOT / "portbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "ipc_proofs_tpu"}
PROGRAM = "ipc_proofs_tpu_torch"


def _runnable() -> "list[Path]":
    return sorted(p for p in PORTBENCH.rglob("*.py") if "tests" not in p.relative_to(PORTBENCH).parts)


def _top_level_imports(path: Path) -> "set[str]":
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", _runnable(), ids=lambda p: str(p.relative_to(ROOT)))
def test_module_imports_no_jax(path):
    assert not _top_level_imports(path) & FORBIDDEN
    assert "benchmarks/" not in path.read_text()


@pytest.mark.parametrize(
    "path", sorted((PORTBENCH / "reference").rglob("*.py")),
    ids=lambda p: str(p.relative_to(PORTBENCH / "reference"))
)
def test_reference_imports_nothing_of_the_program(path):
    assert PROGRAM not in _top_level_imports(path)
    assert PROGRAM not in path.read_text()


def test_prefix_is_not_a_match():
    from portbench.run import forbidden_modules

    assert "ipc_proofs_tpu_torch" not in FORBIDDEN
    before = set(sys.modules)
    sys.modules["ipc_proofs_tpu_torch_probe"] = sys.modules[__name__]
    sys.modules["ipc_proofs_tpu.probe"] = sys.modules[__name__]
    try:
        assert forbidden_modules() == ["ipc_proofs_tpu.probe"] + sorted(
            m for m in before if m.split(".")[0] in FORBIDDEN)
    finally:
        del sys.modules["ipc_proofs_tpu_torch_probe"], sys.modules["ipc_proofs_tpu.probe"]


_DRY_RUN = """
import json, sys
sys.path.insert(0, {root!r})
from portbench.tests.conftest import make_tiny_root
from pathlib import Path
from portbench.bench.registry import Registry
import portbench.run as run
reg = Registry(make_tiny_root(Path({tmp!r})))
results = {{}}
for cell in [w["name"] for w in reg.bench["workloads"]]:
    out = run.run_cell(reg, cell, 2**40 + 1, 0.2, False, device="cpu")
    results[cell] = out["correct"]
print(json.dumps({{"correct": results, "forbidden": run.forbidden_modules()}}))
"""


def test_dry_run_loads_no_jax(tmp_path):
    """Every cell run on the CPU (plain kernels) in a fresh process: no JAX
    module and no module of the JAX package in ``sys.modules`` after."""
    code = _DRY_RUN.format(root=str(ROOT), tmp=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["forbidden"] == []
    assert all(result["correct"].values()), result


def test_reference_alone_loads_no_program():
    code = (
        f"import sys; sys.path.insert(0, {str(ROOT)!r}); "
        "import portbench.reference.check, portbench.reference.worlds.range, "
        "portbench.reference.worlds.storage; "
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('ipc_proofs_tpu_torch', 'ipc_proofs_tpu', 'jax', 'torch')))"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
