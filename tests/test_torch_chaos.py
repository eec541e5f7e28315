"""`ipc_proofs_tpu_torch.tools.chaos` against the reference's
``tools/chaos.py`` (both on the host: the reference under
``JAX_PLATFORMS=cpu``, the port with ``get_backend("gpu", device="cpu")``).

- The same seed gives the same `FaultPlan` schedule in both packages.
- `chaos_run` gives the reference's outcome, error type and fault
  schedule per (seed, rate) over the same 12-pair world read as one
  chunk, and its reference bundle (so every ``identical`` bundle) is the
  reference's JSON byte for byte. At several chunks the record stage reads
  while the next chunk scans, so which read draws which fault depends on
  thread scheduling in both packages; the grid then holds the invariant
  only.
- The shard grid holds (both doors), with the reference's outcome per
  (seed, rate, door); the slow-shard grid quarantines without an error.
- The fetch-plane wiring (batch reads verified on the lane) holds the
  invariant too; ``main`` takes it, with a 0-byte lane crossover, on the
  card only, and keeps the reference's wiring on the CPU.
- A backend that raises `DeviceFaultError` — in the match or in the
  lane — gives ``device_fault`` and fails the grid, where the reference's
  `TYPED_ERRORS` would count it typed.
"""

import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

pytest.importorskip("jax")

import tools.chaos as ref_chaos  # noqa: E402
from ipc_proofs_tpu.store.faults import FaultPlan as RefFaultPlan  # noqa: E402
from ipc_proofs_tpu_torch.backend import get_backend  # noqa: E402
from ipc_proofs_tpu_torch.ops.build import DeviceFaultError  # noqa: E402
from ipc_proofs_tpu_torch.store.faults import FaultPlan  # noqa: E402
from ipc_proofs_tpu_torch.tools import chaos  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CPU = get_backend("gpu", device="cpu")


@pytest.mark.parametrize("seed", [0, 7, 101, 2**31 - 1])
@pytest.mark.parametrize("rate", [0.05, 0.5])
def test_fault_plan_schedule_equals_the_reference(seed, rate):
    ref, port = RefFaultPlan(seed, fault_rate=rate), FaultPlan(seed, fault_rate=rate)
    assert [port.draw() for _ in range(400)] == [ref.draw() for _ in range(400)]
    assert [port.randrange(97) for _ in range(50)] == [ref.randrange(97) for _ in range(50)]
    assert port.snapshot() == ref.snapshot()


@pytest.fixture(scope="module")
def worlds():
    ref = ref_chaos.build_world()
    port = chaos.build_world(backend=CPU)
    assert port[3] == ref[3]  # the fault-free reference bundle, byte for byte
    return ref, port


def _per_seed(worlds, rate) -> "list[str]":
    (rs, rp, rspec, rref), (store, pairs, spec, reference) = worlds
    outcomes = []
    for seed in range(8):
        want = ref_chaos.chaos_run(rs, rp, rspec, rref, seed, fault_rate=rate, chunk_size=len(rp))
        got = chaos.chaos_run(store, pairs, spec, reference, seed, fault_rate=rate, backend=CPU,
                              chunk_size=len(pairs))
        assert (got["outcome"], got.get("error")) == (want["outcome"], want.get("error")), (seed, rate)
        assert got["faults"] == want["faults"], (seed, rate)
        outcomes.append(got["outcome"])
    assert set(outcomes) <= {"identical", "typed_error"}
    return outcomes


@pytest.mark.parametrize("rate", [0.05, 0.3, 0.6])
def test_chaos_run_outcome_per_seed_equals_the_reference(worlds, rate):
    _per_seed(worlds, rate)


def test_per_seed_grid_sees_both_regimes(worlds):
    assert set(_per_seed(worlds, 0.3) + _per_seed(worlds, 0.6)) == {"identical", "typed_error"}


def test_run_grid_holds_in_both_packages():
    summary = chaos.run_grid(11, runs=4, fault_rates=(0.05, 0.6), backend=CPU)
    ref = ref_chaos.run_grid(11, runs=4, fault_rates=(0.05, 0.6))
    assert summary["ok"] and ref["ok"], (summary, ref)
    assert summary["counts"]["device_fault"] == 0
    assert sum(summary["counts"].values()) == summary["runs"] == ref["runs"]


def test_fetch_plane_wiring_holds_the_invariant(monkeypatch):
    monkeypatch.setenv("IPC_VERIFY_MIN_BYTES", "0")  # every landed wave on the lane
    summary = chaos.run_grid(3, runs=2, fault_rates=(0.05, 0.5), n_pairs=6, backend=CPU, fetch_plane=True)
    assert summary["ok"], summary
    assert summary["counts"]["identical"] > 0


def test_shard_grid_holds_with_the_references_outcomes():
    summary = chaos.run_shard_grid(5, runs=2, fault_rates=(0.1, 0.6), backend=CPU)
    assert summary["ok"], summary
    shards, pairs, reference = chaos.build_shard_world(backend=CPU)
    rshards, rpairs, rreference = ref_chaos.build_shard_world()
    try:
        assert reference == rreference
        for seed in (1, 2):
            for door in ("buffered", "streamed"):
                got = chaos.chaos_shard_run(shards, pairs, reference, seed, fault_rate=0.4, door=door)
                want = ref_chaos.chaos_shard_run(rshards, rpairs, rreference, seed, fault_rate=0.4, door=door)
                assert (got["outcome"], got["faults"]) == (want["outcome"], want["faults"]), (seed, door)
    finally:
        for s in shards + rshards:
            s.stop(timeout=10)


def test_slow_shard_is_quarantined_not_failed():
    summary = chaos.run_slow_shard_grid(2, rounds=4, backend=CPU)
    assert summary["ok"], summary


class _FaultyBackend:
    """The host backend, but ``fail`` raises as a refused launch does."""

    def __init__(self, fail: str):
        self._fail = fail
        self.device = CPU.device

    def __getattr__(self, name):
        if name == self._fail:
            def refuse(*args, **kwargs):
                raise DeviceFaultError(f"{name}: CUDA launch failed with error 700")
            return refuse
        return getattr(CPU, name)


@pytest.mark.parametrize("fail", ["event_match_mask", "blake2b256_batch"])
def test_device_fault_is_its_own_outcome(worlds, monkeypatch, fail):
    # over an RPC store the scan is the Python walk and its mask runs on the
    # backend; with the plane, every landed wave verifies on the lane
    monkeypatch.setenv("IPC_VERIFY_MIN_BYTES", "0")
    _, (store, pairs, spec, reference) = worlds
    backend = _FaultyBackend(fail)
    res = chaos.chaos_run(store, pairs, spec, reference, 1, fault_rate=0.05, backend=backend,
                          fetch_plane=fail == "blake2b256_batch")
    assert res["outcome"] == "device_fault", res
    assert ("DeviceFaultError" if fail != "blake2b256_batch" else "VerifyLaneError") in res["error"]
    # the reference's own classification would have hidden it as typed
    assert isinstance(DeviceFaultError("x"), ref_chaos.TYPED_ERRORS)
    monkeypatch.setattr(chaos, "build_world", lambda *a, **k: (store, pairs, spec, reference))
    summary = chaos.run_grid(1, runs=1, fault_rates=(0.05,), backend=backend,
                             fetch_plane=fail == "blake2b256_batch")
    assert not summary["ok"] and summary["counts"]["device_fault"] == 1
    assert summary["violations"][0]["outcome"] == "device_fault"


def test_classify_asks_about_the_card_first():
    assert chaos.classify(DeviceFaultError("refused"))[0] == "device_fault"
    assert chaos.classify(RuntimeError("CUDA error: an illegal memory access was encountered"))[0] == "device_fault"
    assert chaos.classify(RuntimeError("all 2 endpoints failed"))[0] == "typed_error"
    assert chaos.classify(KeyError("x"))[0] == "untyped_error"


def test_module_exits_nonzero_without_cuda():
    run = [sys.executable, "-m", "ipc_proofs_tpu_torch.tools.chaos", "3", "--quick", "--runs", "1"]
    refused = subprocess.run(run, cwd=ROOT, capture_output=True, text=True, timeout=120,
                             env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert refused.returncode != 0 and not refused.stdout
    assert "--device cuda" in refused.stderr


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_main_wires_the_lane_on_the_card_only(monkeypatch, device):
    seen = {}
    monkeypatch.setattr(chaos, "backend_for", lambda d: SimpleNamespace(device=torch.device(device)))
    monkeypatch.setattr(chaos, "run_grid", lambda *a, **kw: seen.update(kw) or {"ok": True})
    monkeypatch.setenv("IPC_VERIFY_MIN_BYTES", "unset")  # restored when the test ends
    monkeypatch.delenv("IPC_VERIFY_MIN_BYTES")
    assert chaos.main(["3", "--quick", "--device", device]) == 0
    assert seen["fetch_plane"] is (device == "cuda")
    assert os.environ.get("IPC_VERIFY_MIN_BYTES") == ("0" if device == "cuda" else None)
    monkeypatch.setenv("IPC_VERIFY_MIN_BYTES", "4096")  # an operator's crossover wins
    assert chaos.main(["3", "--quick", "--device", device]) == 0
    assert os.environ["IPC_VERIFY_MIN_BYTES"] == "4096"
