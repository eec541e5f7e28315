"""``bench_torch.py``'s serve-plane legs in process at ``--platform cpu``:
``serve``, ``witness``, ``zerocopy``, ``overload`` and ``registry``.

Each leg's key set equals the reference leg's, and each reference leg
(host-only in the JAX package, seconds on the CPU) runs at the same
arguments: the counts fixed by bytes — witness bytes and bytes a proof,
zero-copy bytes a response (and none copied), request counts, the seeded
fleet hit rates — are equal.
"""

from _torch_bench import bench_env, run_port_leg, run_reference_leg, same  # noqa: F401
from _torch_http import count_before_terminator


def test_serve_leg(bench_env):
    out = run_port_leg("serve")
    ref = run_reference_leg("serve")
    same(out, ref, ("serve_concurrency", "serve_requests", "serve_rejections"))
    assert out["serve_requests"] == 8 and out["serve_batched_rps"] > 0 and out["serve_sequential_rps"] > 0


def test_witness_leg(bench_env):
    out = run_port_leg("witness")
    ref = run_reference_leg("witness")
    same(out, ref, sorted(ref))  # every witness number is fixed by bytes
    assert out["witness_two_pass_bytes"] < out["witness_single_pass_bytes"]


def test_zerocopy_leg(bench_env, monkeypatch):
    from ipc_proofs_tpu_torch.ops import verify

    # the disk-tier service tunes its lane at start; on the CPU that is
    # the plain versions' crossover, which says nothing here
    monkeypatch.setattr(verify, "autotune_crossover", lambda *a, **k: {"min_bytes": 1 << 62, "scalar_only": True})
    out = run_port_leg("zerocopy")
    # the reference daemon counts a streamed response after its terminator,
    # so its leg's `responses == reps` could read the counters first; run
    # it with the port's order (count, then terminator)
    count_before_terminator(monkeypatch)
    ref = run_reference_leg("zerocopy")
    same(out, ref, ("warm_block_bytes_copied_per_resp", "zerocopy_bytes_per_resp", "zerocopy_responses",
                    "qos_heavy_concurrency", "zerocopy_host_cpus"))
    assert out["warm_block_bytes_copied_per_resp"] == 0


def test_overload_leg(bench_env):
    out = run_port_leg("overload")
    assert out["overload_capacity_rps"] > 0 and out["overload_requests"] > 0
    assert out["overload_doomed_requests"] > 0 and out["cancel_reclaim_pct"] is not None


def test_registry_leg(bench_env):
    out = run_port_leg("registry")
    ref = run_reference_leg("registry")
    same(out, ref, ("fleet_delta_hit_rate", "fleet_delta_baseline_hit_rate", "registry_chain_records",
                    "registry_serve_requests", "registry_shards", "registry_lookups"))
    assert out["fleet_delta_hit_rate"] > out["fleet_delta_baseline_hit_rate"]
