"""``bench_torch.py``'s fleet legs in process at ``--platform cpu``:
``fleetobs`` (2 shard processes, the observability plane off and on),
``hostkill`` (2 in-process replicated shards, one killed) and
``standing`` (push fan-out over one world).

Each leg's key set equals the reference leg's; ``hostkill`` also runs as
the reference's does on the CPU at the same arguments, and the counts
fixed by bytes (pairs, requests, the share of corrupted frames repaired)
are equal; ``standing`` (at 10 and 100 subscriptions) keeps the
reference's amortization law, at most one generation a distinct filter
and tipset.
"""

import _torch_bench
from _torch_bench import bench_env, run_port_leg, run_reference_leg, same  # noqa: F401


def test_fleetobs_leg(bench_env):
    out = run_port_leg("fleetobs")
    assert (out["fleetobs_pairs"], out["fleetobs_requests"]) == (8, 32)
    assert out["fleetobs_stitched_spans"] > 0 and out["fleetobs_rps_plain"] > 0 and out["fleetobs_rps_observed"] > 0


def test_hostkill_leg(bench_env):
    out = run_port_leg("hostkill")
    ref = run_reference_leg("hostkill")
    same(out, ref, ("hostkill_pairs", "hostkill_requests", "replica_repair_hit_rate"))
    assert out["replica_repair_hit_rate"] == 1.0 and out["kill_recovery_ms"] > 0


def test_standing_leg(bench_env, monkeypatch):
    monkeypatch.setattr(_torch_bench.bench_torch, "STANDING_SUBSCRIPTIONS", (10, 100))
    out = run_port_leg("standing")
    assert out["standing_subscriptions"] == 100 and out["standing_tipsets"] == 3
    assert out["standing_distinct_filters"] == 2
    assert out["standing_generations_per_tipset"] <= out["standing_distinct_filters"]
    assert out["standing_proofs_pushed_per_sec_10k"] > 0 and out["standing_delivery_lag_p99_ms"] is not None
