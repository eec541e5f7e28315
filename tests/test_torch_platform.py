"""`ipc_proofs_tpu_torch.utils.platform` against the reference's
``ipc_proofs_tpu.utils.platform``: the bench's card probe.

- Explicit names and ``IPC_BENCH_PLATFORM`` pass through as the
  reference's do, read in the port's words: the reference's 'default'
  (let JAX pick the chip) is the port's 'cuda'; 'cpu' stays 'cpu'. An
  explicit name never probes.
- 'auto' probes with the same attempts, spacing and env overrides: fed
  the same probe outcomes, both packages sleep the same delays, and a
  success is cached with the probed name.
- The departure: when every attempt fails, the reference returns 'cpu'
  and the port raises `PlatformProbeError`, naming each attempt's outcome.
- The port's probe is a child process that imports torch (never JAX) and
  must see a card; a hung child hits its timeout.
"""

import subprocess
import sys

import pytest

from ipc_proofs_tpu.utils import platform as ref_platform
from ipc_proofs_tpu_torch.utils import platform


class _Clock:
    """``time`` for both modules: ``monotonic`` moves only by what a probe
    takes (``spend``) and ``sleep`` records its delay without waiting."""

    def __init__(self):
        self.now = 0.0
        self.sleeps = []

    def monotonic(self) -> float:
        return self.now

    def sleep(self, seconds: float) -> None:
        self.sleeps.append(seconds)
        self.now += seconds


@pytest.fixture
def fresh(monkeypatch):
    """Both modules with no cached probe, no env override, and a fake clock
    each; returns the two clocks."""
    for mod in (ref_platform, platform):
        monkeypatch.setattr(mod, "_cache", None)
    for name in ("IPC_BENCH_PLATFORM", "IPC_BENCH_PROBE_ATTEMPTS", "IPC_BENCH_PROBE_SPACING"):
        monkeypatch.delenv(name, raising=False)
    clocks = (_Clock(), _Clock())
    monkeypatch.setattr(ref_platform, "time", clocks[0])
    monkeypatch.setattr(platform, "time", clocks[1])
    return clocks


def _in_port_words(ref_result: str) -> str:
    return {"default": "cuda", "cpu": "cpu"}[ref_result]


def _no_probe(*_a, **_k):
    raise AssertionError("an explicit platform must not probe")


@pytest.mark.parametrize("name", ["cpu", "default", "tpu"])
def test_explicit_names_pass_through_as_the_reference(fresh, monkeypatch, name):
    monkeypatch.setattr(ref_platform, "_probe_once", _no_probe)
    monkeypatch.setattr(platform, "_probe_once", _no_probe)
    assert platform.pick_platform(name) == _in_port_words(ref_platform.pick_platform(name))


@pytest.mark.parametrize("name, want", [("cuda", "cuda"), ("gpu", "cuda")])
def test_the_ports_own_names_mean_the_card(fresh, monkeypatch, name, want):
    monkeypatch.setattr(platform, "_probe_once", _no_probe)
    assert platform.pick_platform(name) == want


@pytest.mark.parametrize("env", ["cpu", "default", "tpu"])
def test_env_override_skips_the_probe_as_the_reference(fresh, monkeypatch, env):
    monkeypatch.setenv("IPC_BENCH_PLATFORM", env)
    monkeypatch.setattr(ref_platform, "_probe_once", _no_probe)
    monkeypatch.setattr(platform, "_probe_once", _no_probe)
    assert platform.pick_platform("auto") == _in_port_words(ref_platform.pick_platform("auto"))


@pytest.mark.parametrize("bad", ["tpuv4", "metal", ""])
def test_unknown_names_raise(fresh, monkeypatch, bad):
    monkeypatch.setattr(platform, "_probe_once", _no_probe)
    with pytest.raises(ValueError, match="unknown platform"):
        platform.pick_platform(bad)


def _scripted(clock, outcomes, ported: bool):
    """A `_probe_once` that plays ``outcomes`` in turn: (seconds the
    attempt takes, the card's name or None)."""
    calls = []

    def probe(probe_timeout, log, attempt, attempts):
        spent, name = outcomes[len(calls)]
        calls.append((probe_timeout, attempt, attempts))
        clock.now += spent
        if ported:
            return name, "ok" if name else f"scripted failure {attempt}"
        return name

    return probe, calls


@pytest.mark.parametrize(
    "outcomes",
    [
        [(0.5, None), (0.5, None), (1.0, "NVIDIA H100 80GB HBM3")],  # fast failures: 5 s apart
        [(100.0, None), (0.5, "NVIDIA H100 80GB HBM3")],  # a hang-like failure: full spacing
        [(2.0, "NVIDIA H100 80GB HBM3")],
    ],
    ids=["fast-failures", "slow-failure", "first-try"],
)
def test_retries_and_spacing_match_the_reference(fresh, monkeypatch, outcomes):
    ref_clock, clock = fresh
    ref_probe, ref_calls = _scripted(ref_clock, outcomes, ported=False)
    probe, calls = _scripted(clock, outcomes, ported=True)
    monkeypatch.setattr(ref_platform, "_probe_once", ref_probe)
    monkeypatch.setattr(platform, "_probe_once", probe)
    logs = []
    assert ref_platform.pick_platform("auto", probe_timeout=150.0, log=logs.append) == "default"
    assert platform.pick_platform("auto", probe_timeout=150.0, log=logs.append) == "cuda"
    assert calls == ref_calls
    assert clock.sleeps == ref_clock.sleeps
    assert platform.probed_platform_name() == outcomes[-1][1]
    # cached: a second call does not probe again
    assert platform.pick_platform("auto") == "cuda"
    assert len(calls) == len(outcomes)


def test_env_attempts_and_spacing_match_the_reference(fresh, monkeypatch):
    ref_clock, clock = fresh
    monkeypatch.setenv("IPC_BENCH_PROBE_ATTEMPTS", "4")
    monkeypatch.setenv("IPC_BENCH_PROBE_SPACING", "2")
    outcomes = [(0.1, None)] * 3 + [(0.1, "NVIDIA H100 80GB HBM3")]
    ref_probe, ref_calls = _scripted(ref_clock, outcomes, ported=False)
    probe, calls = _scripted(clock, outcomes, ported=True)
    monkeypatch.setattr(ref_platform, "_probe_once", ref_probe)
    monkeypatch.setattr(platform, "_probe_once", probe)
    assert ref_platform.pick_platform("auto", log=lambda *a: None) == "default"
    assert platform.pick_platform("auto", log=lambda *a: None) == "cuda"
    assert calls == ref_calls and [c[2] for c in calls] == [4] * 4
    assert clock.sleeps == ref_clock.sleeps == [2.0] * 3


def test_exhausted_retries_raise_where_the_reference_falls_back(fresh, monkeypatch):
    """The departure: the same three failed attempts (and the same spacing
    between them) give the reference 'cpu' and the port an error that
    names every attempt's outcome; nothing is cached."""
    ref_clock, clock = fresh
    outcomes = [(0.5, None)] * 3
    ref_probe, _ = _scripted(ref_clock, outcomes, ported=False)
    probe, calls = _scripted(clock, outcomes, ported=True)
    monkeypatch.setattr(ref_platform, "_probe_once", ref_probe)
    monkeypatch.setattr(platform, "_probe_once", probe)
    assert ref_platform.pick_platform("auto", log=lambda *a: None) == "cpu"
    with pytest.raises(platform.PlatformProbeError) as err:
        platform.pick_platform("auto", log=lambda *a: None)
    for attempt in (1, 2, 3):
        assert f"attempt {attempt}: scripted failure {attempt}" in str(err.value)
    assert "no CPU fallback" in str(err.value)
    assert clock.sleeps == ref_clock.sleeps == [5.0, 5.0]
    assert platform._cache is None and platform.probed_platform_name() is None
    assert len(calls) == 3


def test_timeouts_of_both_probes_are_retried_alike(fresh, monkeypatch):
    """Both real `_probe_once` with a child that never answers in time:
    the same attempts, each logged as a timeout; the reference then falls
    back, the port raises."""

    def hung(cmd, **kw):
        raise subprocess.TimeoutExpired(cmd, kw["timeout"])

    monkeypatch.setattr(ref_platform.subprocess, "run", hung)
    monkeypatch.setattr(platform.subprocess, "run", hung)
    ref_logs, logs = [], []
    assert ref_platform.pick_platform("auto", probe_timeout=7, log=ref_logs.append, spacing=0) == "cpu"
    with pytest.raises(platform.PlatformProbeError, match="timed out after 7s"):
        platform.pick_platform("auto", probe_timeout=7, log=logs.append, spacing=0)
    assert [m for m in ref_logs if "timed out" in m] == [m for m in logs if "timed out" in m]
    assert len([m for m in logs if "timed out" in m]) == 3


def test_a_hung_probe_hits_its_timeout(monkeypatch):
    monkeypatch.setattr(platform, "PROBE_CODE", "import time; time.sleep(60)")
    name, outcome = platform._probe_once(1.0, lambda *a: None, 1, 1)
    assert name is None and outcome == "timed out after 1s"


def test_the_probe_child_needs_a_card_and_imports_no_jax(monkeypatch):
    """The real child on a host without a card (CUDA hidden): a non-zero
    exit naming the failed assertion. Its code imports torch, never JAX."""
    assert "jax" not in platform.PROBE_CODE and "import torch" in platform.PROBE_CODE
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    name, outcome = platform._probe_once(120.0, lambda *a: None, 1, 1)
    assert name is None
    assert outcome.startswith("exited rc=1") and "AssertionError" in outcome


def test_a_probe_that_prints_the_card_name_succeeds(monkeypatch):
    monkeypatch.setattr(platform, "PROBE_CODE", "print('noise'); print('NVIDIA H100 80GB HBM3')")
    assert platform._probe_once(60.0, lambda *a: None, 1, 1) == ("NVIDIA H100 80GB HBM3", "ok")


def test_the_port_module_imports_no_jax():
    code = (
        "import sys; import ipc_proofs_tpu_torch.utils.platform as p; "
        "assert not [m for m in sys.modules if m.split('.')[0] in ('jax', 'ipc_proofs_tpu')], 'loaded'"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
