"""Shared fixtures of the benchmark's own tests (run them with
``python -m pytest portbench/tests``): a copy of the benchmark's data at
tiny sizes, for runs on the CPU with the kernels' plain versions."""

import json
import shutil
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]

# the cells' shapes cut to what a CPU test run holds
TINY = {
    "configs/topdown_range_4k.json": {"shape": {"n_pairs": 16, "match_rate": 0.05}},
    "configs/evm_slots_65k.json": {"shape": {"n_contracts": 4, "n_slots": 8}},
}


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card (skips with a reason elsewhere)")


PIECES = ("configs", "traffic", "metrics", "units", "loops", "stores", "policies",
          "reference/worlds")


def make_tiny_root(dest: Path) -> Path:
    """BENCHMARK.json and the benchmark's pieces under ``dest``, the shapes
    in ``TINY`` cut down."""
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    for folder in PIECES:
        shutil.copytree(ROOT / "portbench" / folder, dest / "portbench" / folder,
                        ignore=shutil.ignore_patterns("__pycache__"))
    for rel, change in TINY.items():
        path = dest / "portbench" / rel
        data = json.loads(path.read_text())
        for key, value in change.items():
            if isinstance(value, dict):
                data[key].update(value)
            else:
                data[key] = value
        path.write_text(json.dumps(data))
    return dest


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny_root(tmp_path)
