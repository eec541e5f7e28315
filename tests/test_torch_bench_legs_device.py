"""``bench_torch.py``'s device legs and baselines in process at
``--platform cpu`` (the kernels' plain versions): ``e2e``, ``kernel``,
``cid``, ``onchip``, ``baseline`` and ``native_baseline``.

Each leg's key set equals the reference leg's (read from ``bench.py``);
the e2e leg's proof count equals the reference package's on the same
world; the baselines run on the bench's host engine only — no backend of
the package, no device — and that engine's bundles are the reference's
byte for byte, its scalar run taking the Python scan.
"""

import json

import pytest

from _torch_bench import ROOT, bench_env, bench_torch, leg_returns, reference_keys, run_port_leg  # noqa: F401

SIG, TOPIC1, ACTOR = bench_torch.SIG, bench_torch.TOPIC1, bench_torch.ACTOR


def _reference_proofs(n_pairs: int, receipts: int, events: int, match_rate: float) -> int:
    from ipc_proofs_tpu.fixtures import build_range_world
    from ipc_proofs_tpu.proofs.generator import EventProofSpec
    from ipc_proofs_tpu.proofs.range import generate_event_proofs_for_range

    bs, pairs, _ = build_range_world(n_pairs, receipts, events, match_rate)
    spec = EventProofSpec(event_signature=SIG, topic_1=TOPIC1, actor_id_filter=ACTOR)
    return len(generate_event_proofs_for_range(bs, pairs, spec).event_proofs)


def test_e2e_leg(bench_env):
    out = run_port_leg("e2e", "--match-rate", "0.25")
    assert out["metric"] == "event_proofs_per_sec_4k_range_e2e" and out["unit"] == "proofs/s"
    assert out["platform"] == "cpu" and out["devices"] == 1
    assert out["proofs"] == _reference_proofs(8, 16, 4, 0.25) > 0
    assert out["stages_overlap"] is True and out["gen_verify_overlap"] is True
    assert out["pipeline_speedup_vs_serial"] is not None and len(out["e2e_reps_s"]) == 3
    assert out["events_per_sec_e2e"] > 0 and out["value"] > 0
    assert set(out["stages_ms"]) >= {"scan", "match", "record", "verify_cids", "load_witness", "verify_replay"}


def test_e2e_leg_writes_a_profiler_trace(bench_env):
    trace_dir = bench_env / "profile"
    run_port_leg("e2e", "--match-rate", "0.25", "--e2e-reps", "1", "--profile", str(trace_dir))
    trace = json.loads((trace_dir / "trace.json").read_text())
    assert trace["traceEvents"]


def test_kernel_leg(bench_env):
    out = run_port_leg("kernel")
    assert out["device_mask_kernel_events_per_sec"] > 0


def test_cid_leg(bench_env, monkeypatch):
    monkeypatch.setattr(bench_torch, "CID_NODES", (512, 512))
    out = run_port_leg("cid")
    assert out["witness_cid_kernel"] == "blake2b256_two_block"
    assert out["witness_cid_kernel_per_sec"] > 0


def test_onchip_leg(bench_env, monkeypatch):
    """Timings are pinned (every best-of is 1 s) so the leg's own
    ``verify_tuned_speedup >= 0.8`` assertion reads no host noise; the
    mesh-vs-single and batch-vs-scalar verdict checks run as they are."""
    monkeypatch.setattr(bench_torch, "ONCHIP_EVENTS", (4096, 4096))
    monkeypatch.setattr(bench_torch, "ONCHIP_BLOCKS", (64, 64))
    monkeypatch.setattr(bench_torch, "_best_of_seconds", lambda fn, reps=3: (fn(), 1.0)[1])
    out = run_port_leg("onchip")
    assert out["onchip_devices"] == 1 and out["onchip_match_events"] == 4096 and out["onchip_verify_blocks"] == 64
    assert out["onchip_device_calls"] == 1
    assert out["device_linearity_Nchip"] == 1.0 and out["verify_tuned_speedup"] == 1.0
    assert isinstance(out["verify_autotune_scalar_only"], bool)


def _no_device_backend(monkeypatch):
    from ipc_proofs_tpu_torch import backend
    from ipc_proofs_tpu_torch.proofs import range as port_range
    from ipc_proofs_tpu_torch.proofs import verifier

    def refuse(*a, **k):
        raise AssertionError("a baseline reached the package's backend")

    for module in (backend, port_range, verifier):
        monkeypatch.setattr(module, "get_backend", refuse)


@pytest.mark.parametrize("leg, key", [("baseline", "scalar_baseline_proofs_per_sec"),
                                      ("native_baseline", "native_baseline_proofs_per_sec")])
def test_baselines_run_on_the_host_engine_only(bench_env, monkeypatch, leg, key):
    _no_device_backend(monkeypatch)
    out = run_port_leg(leg)
    assert out[key] > 0


def _worlds(n_pairs: int):
    from ipc_proofs_tpu.fixtures import build_range_world as ref_world
    from ipc_proofs_tpu.proofs.generator import EventProofSpec as RefSpec
    from ipc_proofs_tpu_torch.fixtures import build_range_world
    from ipc_proofs_tpu_torch.proofs.generator import EventProofSpec

    spec = dict(event_signature=SIG, topic_1=TOPIC1, actor_id_filter=ACTOR)
    return (ref_world(n_pairs, 16, 4, 0.25), RefSpec(**spec)), (build_range_world(n_pairs, 16, 4, 0.25),
                                                                 EventProofSpec(**spec))


@pytest.mark.parametrize("scalar", [True, False], ids=["scalar", "native"])
def test_host_engine_bundles_are_the_references(bench_env, monkeypatch, scalar):
    """`_HostHashes` gives the reference's bundle bytes; over `_ScalarStore`
    the driver takes the Python scan and asks the engine's per-event
    predicate (the fused C walk never runs), and the native run's witness
    verifies on the engine."""
    from ipc_proofs_tpu.proofs.range import generate_event_proofs_for_range as ref_generate
    from ipc_proofs_tpu_torch.proofs import range as port_range
    from ipc_proofs_tpu_torch.proofs.trust import TrustPolicy
    from ipc_proofs_tpu_torch.proofs.verifier import verify_proof_bundle

    _no_device_backend(monkeypatch)
    (ref_w, ref_spec), (port_w, spec) = _worlds(6)
    host = bench_torch._HostHashes()
    masks = []
    original = host.event_match_mask
    host.event_match_mask = lambda *a: masks.append(1) or original(*a)
    if scalar:
        def no_c_walk(*a, **k):
            raise AssertionError("the scalar baseline ran the C scanner")

        monkeypatch.setattr(port_range, "scan_match_hits", no_c_walk)
        monkeypatch.setattr(port_range, "scan_events_flat", no_c_walk)
        store = bench_torch._ScalarStore(port_w[0])
    else:
        store = port_w[0]
    bundle = port_range.generate_event_proofs_for_range(store, port_w[1], spec, match_backend=host)
    want = ref_generate(ref_w[0], ref_w[1], ref_spec)
    assert bundle.event_proofs and json.dumps(bundle.to_json_obj(), sort_keys=True) == json.dumps(
        want.to_json_obj(), sort_keys=True)
    assert bool(masks) is scalar
    assert verify_proof_bundle(bundle, TrustPolicy.accept_all(), verify_witness_cids=True,
                               cid_backend=host).all_valid()


def test_every_leg_reports_its_platform():
    """Each port leg's source returns ``_platform`` (the reference's host
    legs do not): the orchestrator's statuses then say ``cuda`` or ``cpu``
    from what the leg ran on."""
    import ast

    tree = ast.parse((ROOT / "bench_torch.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and node.name[len("_leg_"):] in bench_torch.LEGS:
            returns = leg_returns(node)
            assert returns, node.name
            for r in returns:
                keys = {k.value for k in r.value.keys if isinstance(k, ast.Constant)}
                assert "_platform" in keys, node.name
                assert keys - {"_platform"} == reference_keys(node.name[len("_leg_"):]) - {"_platform"}


def test_the_smoke_holds_phase_33_to_the_reference_keys():
    """``chip_smoke.py``'s phase 33 checks each leg's JSON against a table
    of the reference leg's keys; the table is ``bench.py``'s."""
    import chip_smoke

    assert set(chip_smoke.BENCH_LEG_KEYS) == {"e2e", "kernel", "cid", "onchip"}
    for leg, keys in chip_smoke.BENCH_LEG_KEYS.items():
        assert len(set(keys)) == len(keys) and set(keys) == reference_keys(leg), leg
        assert chip_smoke.BENCH_HEADLINES[leg] in keys
