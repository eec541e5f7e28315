"""``bench_torch.py``'s router legs in process at ``--platform cpu``:
``cluster`` and ``backfill``, each over real shard processes
(``python -m ipc_proofs_tpu_torch.cli serve --backend cpu``).

Each leg's key set equals the reference leg's; each leg asserts on every
run that its scatter (and its folded backfill stream) is the
single-process driver's bundle byte for byte; the counts the shapes fix
(pairs, requests, windows, shards) are the reference's.
"""

from _torch_bench import bench_env, run_port_leg  # noqa: F401


def test_cluster_leg(bench_env):
    out = run_port_leg("cluster")
    assert (out["cluster_pairs"], out["cluster_requests"]) == (8, 32)  # the reference's --quick shape
    assert out["cluster_rps_1shard"] > 0 and out["cluster_rps_4shard"] > 0 and out["aggregate_proofs_per_sec"] > 0
    assert not list(bench_env.glob("shard-*.port"))


def test_backfill_leg(bench_env):
    out = run_port_leg("backfill")
    assert (out["backfill_epochs"], out["backfill_windows"], out["backfill_shards"]) == (24, 6, 4)
    assert 0 < out["backfill_ttfc_ms"] <= out["backfill_total_ms"]
    assert out["backfill_epochs_per_sec"] > 0
