"""Each cell run whole on the card, short: the command exits 0 and its last
line reads correct. Skips where there is no CUDA card."""

import json
import subprocess
import sys

import pytest

from portbench.bench.registry import Registry
from portbench.tests.conftest import ROOT


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in Registry(ROOT).bench["workloads"]])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_on_the_card(cell, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed", str(2**32 + 9),
         "--seconds", "3", "--trace", str(trace)],
        capture_output=True, text=True, timeout=600, cwd=ROOT,
    )
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"


def test_without_a_card_the_command_fails_and_prints_nothing():
    """On a machine without CUDA (this one, in the CPU suite) the command
    exits non-zero and prints no result."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "topdown_range_4k.gen_verify",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
    )
    assert out.returncode != 0 and out.stdout == ""
