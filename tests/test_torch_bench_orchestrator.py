"""``bench_torch.py``'s per-leg watchdog orchestrator against the
reference's ``bench.py``: every case of ``tests/test_bench_orchestrator.py``.

Both orchestrators are fed the same fake leg dicts (no subprocess, no
device) and their artifact lines are compared key for key, ``platform``
aside: the reference labels its legs ``tpu`` / ``cpu``, the port ``cuda``.
Where the two differ by design the port's case asserts the opposite of the
reference's: a stalled or failed leg is never rerun on the CPU and never
moves later legs there (``watchdog_fallback`` stays False), its keys are
nulled, the artifact line still prints, and the orchestrator returns a
non-zero exit code.
"""

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import bench  # noqa: E402
import bench_torch  # noqa: E402
import ipc_proofs_tpu.utils.platform as ref_plat  # noqa: E402
import ipc_proofs_tpu_torch.utils.platform as plat  # noqa: E402

from test_bench_orchestrator import (  # noqa: E402
    _ASYNCFETCH_OK,
    _BACKFILL_OK,
    _CLUSTER_OK,
    _DURABILITY_OK,
    _E2E_OK,
    _FLEETOBS_OK,
    _HOSTKILL_OK,
    _OBSERVABILITY_OK,
    _ONCHIP_OK,
    _OVERLOAD_OK,
    _REGISTRY_OK,
    _RESILIENCE_OK,
    _SERVE_OK,
    _STANDING_OK,
    _STORAGE_OK,
    _WITNESS_OK,
    _ZEROCOPY_OK,
)


def _args(module, **overrides):
    argv = []
    for k, v in overrides.items():
        argv += [f"--{k.replace('_', '-')}", str(v)]
    return module._parse_args(argv)


class TestParseArgs:
    def test_same_cli_as_the_reference(self):
        assert bench_torch.LEGS == bench.LEGS
        assert bench_torch._LEG_TIMEOUTS == bench._LEG_TIMEOUTS
        for argv in ([], ["--quick"], ["--quick", "--tipsets", "4096"], ["--tipsets", "64", "--serve-requests", "9"]):
            ref, port = vars(bench._parse_args(argv)), vars(bench_torch._parse_args(argv))
            assert port == ref, argv

    def test_quick_clamps_shapes(self):
        args = bench_torch._parse_args(["--quick", "--tipsets", "4096"])
        assert args.tipsets == 256
        assert args.baseline_pairs == 32
        assert args.kernel_iters == 5
        assert args.serve_requests == 96

    def test_leg_choices(self):
        for leg in bench_torch.LEGS:
            assert bench_torch._parse_args(["--leg", leg]).leg == leg
        with pytest.raises(SystemExit):
            bench_torch._parse_args(["--leg", "nonsense"])

    def test_every_leg_has_a_function_and_runs_once(self):
        assert set(bench_torch._LEG_FNS) == set(bench_torch.LEGS)
        assert sorted(bench_torch.ORCHESTRATED_LEGS) == sorted(bench_torch.LEGS)


class _FakePopen:
    """`subprocess.Popen` for `_spawn_leg`: ``communicate`` answers
    (stdout, None) or raises the watchdog's timeout."""

    def __init__(self, returncode=0, stdout="", hang=False):
        self.returncode, self._stdout, self._hang = returncode, stdout, hang
        self.pid = 1 << 30  # no such process group
        self.calls = 0

    def __call__(self, cmd, **kw):
        assert kw["start_new_session"] is True and kw["stdout"] == subprocess.PIPE
        self.cmd = cmd
        return self

    def communicate(self, timeout=None):
        self.calls += 1
        if self._hang and self.calls == 1:
            raise subprocess.TimeoutExpired(cmd="x", timeout=timeout)
        return self._stdout, None


class TestRunLeg:
    """_run_leg parses the child's last stdout line and labels status with
    the platform the leg REPORTS (not the one requested)."""

    def test_ok_pops_reported_platform(self, monkeypatch):
        payload = {"device_mask_kernel_events_per_sec": 5.0, "_platform": "cuda"}
        fake = _FakePopen(0, "torch noise line\n" + json.dumps(payload))
        monkeypatch.setattr(bench_torch.subprocess, "Popen", fake)
        out, status = bench_torch._run_leg("kernel", _args(bench_torch), "cuda")
        assert status == "ok:cuda"
        assert out == {"device_mask_kernel_events_per_sec": 5.0}
        assert fake.cmd[fake.cmd.index("--platform") + 1] == "cuda"
        assert fake.cmd[fake.cmd.index("--leg") + 1] == "kernel"

    def test_ok_without_platform_falls_back_to_requested(self, monkeypatch):
        monkeypatch.setattr(bench_torch.subprocess, "Popen", _FakePopen(0, json.dumps({"x": 1})))
        _out, status = bench_torch._run_leg("kernel", _args(bench_torch), "cpu")
        assert status == "ok:cpu"

    def test_timeout_and_error_statuses(self, monkeypatch):
        killed = []
        monkeypatch.setattr(bench_torch.os, "killpg", lambda pid, sig: killed.append((pid, sig)))
        fake = _FakePopen(hang=True)
        monkeypatch.setattr(bench_torch.subprocess, "Popen", fake)
        out, status = bench_torch._run_leg("e2e", _args(bench_torch), "cuda")
        assert out is None and status == "timeout:cuda"
        assert killed == [(fake.pid, signal.SIGKILL)]

        monkeypatch.setattr(bench_torch.subprocess, "Popen", _FakePopen(3, ""))
        out, status = bench_torch._run_leg("e2e", _args(bench_torch), "cuda")
        assert out is None and status == "error:cuda"

        monkeypatch.setattr(bench_torch.subprocess, "Popen", _FakePopen(0, "not json at all"))
        out, status = bench_torch._run_leg("e2e", _args(bench_torch), "cpu")
        assert out is None and status == "error:cpu"

    def test_timeout_scaling(self):
        args = _args(bench_torch, leg_timeout_mult=2.0)
        assert bench_torch._leg_timeout("e2e", args) == pytest.approx(bench_torch._LEG_TIMEOUTS["e2e"][0] * 2.0)
        args_quick = bench_torch._parse_args(["--quick"])
        assert bench_torch._leg_timeout("cid", args_quick) == pytest.approx(bench_torch._LEG_TIMEOUTS["cid"][1])
        for name in bench_torch.LEGS:
            assert bench_torch._leg_timeout(name, args) == pytest.approx(bench._leg_timeout(name, args))

    def test_the_leg_command_matches_the_reference(self, monkeypatch):
        """The child's argv: the same flags as the reference's, this file
        in place of ``bench.py``."""
        seen = {}

        def ref_run(cmd, **kw):
            seen["ref"] = cmd
            return type("P", (), {"returncode": 0, "stdout": "{}"})()

        fake = _FakePopen(0, "{}")
        monkeypatch.setattr(bench.subprocess, "run", ref_run)
        monkeypatch.setattr(bench_torch.subprocess, "Popen", fake)
        args = bench_torch._parse_args(["--quick", "--threads", "3", "--profile", "/tmp/p"])
        bench._run_leg("e2e", args, "default")
        bench_torch._run_leg("e2e", args, "cuda")
        ref, port = seen["ref"], fake.cmd
        assert Path(ref[1]).name == "bench.py" and Path(port[1]).name == "bench_torch.py"
        assert port[2:] == [("cuda" if a == "default" else a) for a in ref[2:]]

    def test_a_stalled_leg_takes_its_children_with_it(self, tmp_path):
        """The real `_spawn_leg`: at the timeout the leg's whole session
        dies, a grandchild (a shard the leg started) included."""
        pid_file = tmp_path / "grandchild.pid"
        code = (
            "import subprocess, sys, time\n"
            "p = subprocess.Popen([sys.executable, '-c', 'import time; time.sleep(120)'])\n"
            f"open({str(pid_file)!r}, 'w').write(str(p.pid))\n"
            "time.sleep(120)\n"
        )
        t0 = time.monotonic()
        with pytest.raises(subprocess.TimeoutExpired):
            bench_torch._spawn_leg([sys.executable, "-c", code], timeout=3.0)
        assert time.monotonic() - t0 < 60
        grandchild = int(pid_file.read_text())
        for _ in range(100):
            try:
                os.kill(grandchild, 0)
            except ProcessLookupError:
                break
            time.sleep(0.05)
        else:
            pytest.fail("the leg's grandchild outlived the watchdog")


def _orchestrate_with(monkeypatch, capsys, leg_results, requested=None, module=bench_torch, platform="cuda"):
    """Run one package's _orchestrate with faked pick_platform + _run_leg;
    returns (printed artifact, returned value). ``leg_results`` maps leg
    name → list of (dict|None, status) consumed per call; ``requested``
    collects every (leg, platform) the orchestrator asked for."""
    calls = {}

    def fake_run_leg(name, args, plat_name):
        if requested is not None:
            requested.append((name, plat_name))
        seq = leg_results[name]
        result = seq[min(calls.get(name, 0), len(seq) - 1)]
        calls[name] = calls.get(name, 0) + 1
        return result

    monkeypatch.setattr(module, "_run_leg", fake_run_leg)
    if module is bench:
        monkeypatch.setattr(ref_plat, "pick_platform", lambda *a, **k: "default")
    else:
        monkeypatch.setattr(plat, "pick_platform", lambda *a, **k: platform)
    rc = module._orchestrate(_args(module))
    return json.loads(capsys.readouterr().out.strip()), rc


_HOST_OK = {
    "baseline": {"scalar_baseline_proofs_per_sec": 125.0},
    "native_baseline": {"native_baseline_proofs_per_sec": 1000.0},
    "serve": _SERVE_OK, "witness": _WITNESS_OK, "resilience": _RESILIENCE_OK,
    "durability": _DURABILITY_OK, "observability": _OBSERVABILITY_OK, "storage": _STORAGE_OK,
    "asyncfetch": _ASYNCFETCH_OK, "cluster": _CLUSTER_OK, "standing": _STANDING_OK,
    "fleetobs": _FLEETOBS_OK, "backfill": _BACKFILL_OK, "zerocopy": _ZEROCOPY_OK,
    "hostkill": _HOSTKILL_OK, "overload": _OVERLOAD_OK, "registry": _REGISTRY_OK,
}
_DEVICE_OK = {
    "e2e": dict(_E2E_OK, platform="cuda"),
    "kernel": {"device_mask_kernel_events_per_sec": 6e9},
    "cid": {"witness_cid_kernel_per_sec": 1e8, "witness_cid_kernel": "blake2b256_two_block"},
    "onchip": dict(_ONCHIP_OK, onchip_devices=1),
}


def _results(platform: str, device_platform: str, overrides=None) -> dict:
    out = {name: [(dict(d), f"ok:{device_platform}")] for name, d in _DEVICE_OK.items()}
    out["e2e"] = [(dict(_DEVICE_OK["e2e"], platform=device_platform), f"ok:{device_platform}")]
    out.update({name: [(dict(d), f"ok:{platform}")] for name, d in _HOST_OK.items()})
    out.update(overrides or {})
    return out


def _without_platform(status: str) -> str:
    return " → ".join(s.split(":")[0] for s in status.split(" → "))


def _same_artifact(ref: dict, port: dict) -> None:
    """Key for key, ``platform`` aside; the legs' statuses compared with
    their platform labels stripped."""
    assert set(port) == set(ref)
    for key in ref:
        if key == "platform":
            continue
        if key == "legs":
            assert set(port["legs"]) == set(ref["legs"])
            assert {k: _without_platform(v) for k, v in port["legs"].items()} == {
                k: _without_platform(v) for k, v in ref["legs"].items()
            }
            continue
        assert port[key] == ref[key], key


class TestOrchestrate:
    def test_happy_path_ratios(self, monkeypatch, capsys):
        ref, ref_rc = _orchestrate_with(monkeypatch, capsys, _results("cpu", "tpu"), module=bench)
        out, rc = _orchestrate_with(monkeypatch, capsys, _results("cuda", "cuda"))
        assert ref_rc is None and rc == 0
        _same_artifact(ref, out)
        assert out["value"] == 5000.0
        assert out["vs_baseline"] == 40.0
        assert out["vs_native_baseline"] == 5.0
        assert out["watchdog_fallback"] is False
        assert set(out["legs"].values()) == {"ok:cuda"}
        assert out["platform"] == "cuda" and ref["platform"] == "tpu"
        assert out["witness_cid_kernel"] == "blake2b256_two_block"

    def test_cpu_platform_when_asked_for(self, monkeypatch, capsys):
        out, rc = _orchestrate_with(monkeypatch, capsys, _results("cpu", "cpu"), platform="cpu")
        assert rc == 0 and set(out["legs"].values()) == {"ok:cpu"}

    def test_stalled_e2e_is_not_rerun_on_cpu(self, monkeypatch, capsys):
        """The reference reruns a stalled e2e on the CPU and requests every
        later device leg there (`test_stalled_e2e_downgrades_and_retries_on_cpu`).
        The port requests each leg once, on the card; the headline keys
        are nulled, the artifact still prints, and the exit code is 1."""
        ref_requested, requested = [], []
        stall = {"e2e": [(None, "timeout:default"), (dict(_E2E_OK), "ok:cpu")]}
        ref, _ = _orchestrate_with(monkeypatch, capsys, _results("cpu", "cpu", stall), ref_requested, module=bench)
        assert ("e2e", "cpu") in ref_requested and ref["watchdog_fallback"] is True
        out, rc = _orchestrate_with(
            monkeypatch, capsys, _results("cuda", "cuda", {"e2e": [(None, "timeout:cuda")]}), requested
        )
        assert rc == 1
        assert requested == [(name, "cuda") for name in bench_torch.ORCHESTRATED_LEGS]
        assert not [r for r in requested if r[1] == "cpu"]
        assert out["watchdog_fallback"] is False
        assert out["legs"]["e2e"] == "timeout:cuda"
        assert all(out[k] is None for k in bench_torch._E2E_SCHEMA_KEYS)
        assert out["vs_baseline"] is None and out["vs_native_baseline"] is None
        assert out["scalar_baseline_proofs_per_sec"] == 125.0
        assert set(out) == set(ref) | set(bench_torch._E2E_SCHEMA_KEYS)

    def test_stalled_secondary_leg_costs_only_itself(self, monkeypatch, capsys):
        stall = {"kernel": [(None, "timeout:default")]}
        ref, _ = _orchestrate_with(monkeypatch, capsys, _results("cpu", "tpu", stall), module=bench)
        requested = []
        out, rc = _orchestrate_with(
            monkeypatch, capsys, _results("cuda", "cuda", {"kernel": [(None, "timeout:cuda")]}), requested
        )
        assert rc == 1
        assert out["value"] == 5000.0  # headline survives
        assert out["device_mask_kernel_events_per_sec"] is None
        assert out["witness_cid_kernel_per_sec"] == 1e8
        assert ref["watchdog_fallback"] is True and out["watchdog_fallback"] is False
        assert ("cid", "cuda") in requested and ("onchip", "cuda") in requested
        _same_artifact({**ref, "watchdog_fallback": False, "legs": {**ref["legs"], "cid": "ok:x", "onchip": "ok:x"}},
                       {**out, "legs": {**out["legs"], "cid": "ok:x", "onchip": "ok:x"}})

    def test_fast_crash_keeps_the_chip(self, monkeypatch, capsys):
        """A leg that CRASHES quickly (rc!=0): later device legs are still
        requested on the card, nothing falls back, the exit code is 1."""
        requested = []
        out, rc = _orchestrate_with(
            monkeypatch, capsys, _results("cuda", "cuda", {"kernel": [(None, "error:cuda")]}), requested
        )
        assert ("cid", "cuda") in requested
        assert out["watchdog_fallback"] is False
        assert out["device_mask_kernel_events_per_sec"] is None
        assert out["legs"]["kernel"] == "error:cuda"
        assert rc == 1

    def test_total_failure_emits_full_null_schema(self, monkeypatch, capsys):
        ref_fail = {name: [(None, "error:cpu")] for name in bench.LEGS}
        ref_fail["e2e"] = [(None, "timeout:default"), (None, "timeout:cpu")]
        ref, _ = _orchestrate_with(monkeypatch, capsys, ref_fail, module=bench)
        out, rc = _orchestrate_with(
            monkeypatch, capsys, {name: [(None, "timeout:cuda")] for name in bench_torch.LEGS}
        )
        assert rc == 1
        assert set(out) == set(ref)
        nulled = {k for k, v in ref.items() if v is None}
        assert {k for k, v in out.items() if v is None} == nulled
        assert out["legs"] == {name: "timeout:cuda" for name in bench_torch.ORCHESTRATED_LEGS}
        assert out["watchdog_fallback"] is False

    def test_a_failed_probe_prints_no_artifact(self, monkeypatch, capsys):
        def no_card(*_a, **_k):
            raise plat.PlatformProbeError("bench: the card probe failed on every attempt")

        monkeypatch.setattr(plat, "pick_platform", no_card)
        monkeypatch.setattr(bench_torch, "_run_leg", lambda *a: pytest.fail("a leg ran without a card"))
        with pytest.raises(plat.PlatformProbeError):
            bench_torch._orchestrate(_args(bench_torch))
        assert capsys.readouterr().out == ""

    def test_worst_case_has_no_cpu_retry(self):
        for quick in (False, True):
            idx = 1 if quick else 0
            assert bench_torch.worst_case_seconds(quick) == pytest.approx(
                bench.worst_case_seconds(quick) - bench._LEG_TIMEOUTS["e2e"][idx]
            )
