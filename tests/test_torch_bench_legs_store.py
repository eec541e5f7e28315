"""``bench_torch.py``'s read-path legs in process at ``--platform cpu``:
``resilience``, ``durability``, ``observability``, ``storage`` and
``asyncfetch``.

Each leg's key set equals the reference leg's, and each reference leg
(host-only in the JAX package, seconds on the CPU) runs at the same
arguments: the counts fixed by bytes — journal bytes and chunks, RPC
calls of the cold and warm runs, disk bytes, prefetched blocks, the sync
walker's round trips — are equal.
"""

from _torch_bench import bench_env, run_port_leg, run_reference_leg, same  # noqa: F401


def test_resilience_leg(bench_env):
    out = run_port_leg("resilience")
    ref = run_reference_leg("resilience")
    same(out, ref, ("resilience_fault_rate",))
    assert out["resilience_fault_free_proofs_per_sec"] > 0 and out["recovery_ms"] > 0


def test_durability_leg(bench_env):
    out = run_port_leg("durability")
    ref = run_reference_leg("durability")
    same(out, ref, ("durability_chunks", "durability_journal_bytes"))


def test_observability_leg(bench_env):
    out = run_port_leg("observability")
    ref = run_reference_leg("observability")
    same(out, ref, ("observability_pairs", "observability_spans_dropped"))
    assert out["observability_spans_recorded"] > 0


def test_storage_leg(bench_env):
    out = run_port_leg("storage")
    ref = run_reference_leg("storage")
    same(out, ref, ("storage_cold_rpc_calls", "storage_warm_rpc_calls", "storage_disk_bytes",
                    "storage_prefetched_blocks", "storage_pairs", "disk_hit_ratio", "prefetch_hit_ratio"))
    assert out["storage_warm_rpc_calls"] == 0


def test_asyncfetch_leg(bench_env):
    out = run_port_leg("asyncfetch")
    ref = run_reference_leg("asyncfetch")
    same(out, ref, ("asyncfetch_pairs", "asyncfetch_sync_rpc_calls", "sync_rpc_roundtrips_per_proof"))
    assert out["asyncfetch_cold_rpc_calls"] < out["asyncfetch_sync_rpc_calls"]
