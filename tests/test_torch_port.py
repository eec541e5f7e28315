"""Boundaries of the PyTorch port: what it may import, where it runs.

- Every module of ``ipc_proofs_tpu`` has its counterpart in the port at
  the same path, or at the one `MODULE_MAP` names, or is listed in
  `NOT_PORTED` with its reason; every reference tool is in `TOOLS_MAP` or
  `TOOLS_NOT_PORTED`; every public name of both (functions, classes,
  methods, UPPER_CASE tuples) has its counterpart, under its own name or
  the one `RENAMED_NAMES` gives, or is in `DROPPED_NAMES` with its reason;
  and every metric vocabulary holds the reference's names, plus only the
  port's own names `PORT_ONLY_METRIC_NAMES` lists with their departure.

- No module of ``ipc_proofs_tpu_torch`` (``parallel/``, ``jobs/``,
  ``utils/``, ``ops/verify.py``, ``store/``, ``storex/``, ``witness/``,
  ``registry/`` and ``serve/`` included) and no
  line of ``chip_smoke.py`` imports ``jax``, the repo root's ``tools`` or anything of
  ``ipc_proofs_tpu`` (an AST walk), and a process that imports every module
  of the port and runs the small range and storage paths, one journaled
  run of the overlapped driver and one cold read (hermetic Lotus node →
  client → fetch plane → tier over a segment store, the landed waves and
  the disk sweep verified on the backend), one traced pooled range (two
  endpoints behind the fetch plane), one served, witness-encoded, sealed
  and re-verified request through the serve plane, one durable HTTP
  generate and verify through ``ProofHTTPServer`` (with the disk tier's
  replication inventory), one aggregated verify and one follower poll on
  ``device="cpu"`` through the native branches ends with neither (nor
  ``requests``) in ``sys.modules`` and no shared library of
  ``ipc_proofs_tpu/`` mapped.
- Entry points default to the card: without CUDA, ``GpuBackend()``,
  ``generate_event_proofs_for_range``, its chunked, pipelined and
  overlapped drivers, ``hash_slot_specs``,
  ``generate_storage_proofs_batch``, ``generate_proof_bundle``,
  ``verify_proof_bundle(..., verify_witness_cids=True)``, the batched
  event replay's TxMeta recompute, ``verify_blocks_batch``,
  ``autotune_crossover`` and the verifying fetch plane and segment store
  raise instead of running on the CPU; the
  scalar replay of the ``IPC_PROOFS_NO_NATIVE=1`` universe runs no kernel.
- The CLI (``python -m ipc_proofs_tpu_torch.cli``) defaults to the card:
  without CUDA its ``demo``, ``verify``, ``range``, ``backfill``, ``serve``
  and ``cluster`` exit with the backend's error before any work (before
  ``cluster`` spawns a shard), and ``--backend cpu`` runs. A ``serve --backend cpu`` daemon (also with standing queries,
  the SLO watchdog and backfill mounted), driven over HTTP and stopped with
  SIGTERM, and a ``backfill --backend cpu`` run load neither ``jax`` nor
  the reference.
"""

import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from ipc_proofs_tpu_torch.backend import get_backend
from ipc_proofs_tpu_torch.backend.gpu import GpuBackend
from ipc_proofs_tpu_torch.core.cid import CID, RAW, SHA2_256
from ipc_proofs_tpu_torch.fixtures import ContractFixture, build_chain, build_range_world
from ipc_proofs_tpu_torch.proofs.bundle import ProofBlock
from ipc_proofs_tpu_torch.proofs.generator import EventProofSpec, generate_proof_bundle
from ipc_proofs_tpu_torch.proofs.range import (
    generate_and_verify_range_overlapped,
    generate_event_proofs_for_range,
    generate_event_proofs_for_range_chunked,
    generate_event_proofs_for_range_pipelined,
)
from ipc_proofs_tpu_torch.proofs.storage_batch import (
    MappingSlotSpec,
    generate_storage_proofs_batch,
    hash_slot_specs,
)
from ipc_proofs_tpu_torch.proofs.trust import MockTrustVerifier, TrustPolicy
from ipc_proofs_tpu_torch.proofs.verifier import verify_proof_bundle

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "ipc_proofs_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "bench_torch.py"]
FORBIDDEN = ("jax", "jaxlib", "ipc_proofs_tpu", "tools", "bench")


def _imported_modules(path: Path) -> "list[str]":
    names = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.extend(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.append(node.module)
    return names


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_port_files_exist():
    rel = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    assert "chip_smoke.py" in rel
    assert "bench_torch.py" in rel
    assert "ipc_proofs_tpu_torch/ops/blake2b.py" in rel
    assert "ipc_proofs_tpu_torch/ops/keccak.py" in rel
    assert "ipc_proofs_tpu_torch/proofs/storage_batch.py" in rel
    for source in ("blake2b.cu", "keccak.cu"):
        assert (ROOT / "ipc_proofs_tpu_torch" / "csrc" / source).is_file()
    for source in ("dagcbor_ext.c", "scan_ext.c"):
        assert (ROOT / "ipc_proofs_tpu_torch" / "backend" / "native" / source).is_file()
    for module in (
        "parallel/pipeline.py", "jobs/journal.py", "jobs/job.py", "utils/threads.py",
        "utils/deadline.py", "utils/log.py", "utils/lockdep.py", "store/rpc.py",
        "ops/verify.py", "store/faults.py", "store/testing.py", "store/fetchplane.py",
        "storex/segments.py", "storex/tiered.py", "cli.py", "crypto/bls.py",
        "crypto/rleplus.py", "proofs/gpbft.py", "proofs/cert.py", "proofs/cert_cbor.py",
        "proofs/trust.py", "proofs/address.py", "proofs/vectors.py", "utils/profiling.py",
        "parallel/mesh.py", "parallel/multihost.py", "utils/timing.py", "ops/cid_bench.py",
        "entry.py", "obs/__init__.py", "obs/trace.py", "obs/flight.py", "obs/prom.py",
        "obs/export.py", "store/failover.py", "storex/follower.py",
        "witness/__init__.py", "witness/errors.py", "witness/framing.py", "witness/bases.py",
        "witness/delta.py", "witness/wire.py", "witness/aggregate.py", "witness/stream.py",
        "registry/__init__.py", "registry/mmr.py", "registry/log.py", "registry/registry.py",
        "serve/__init__.py", "serve/qos.py", "serve/batcher.py", "serve/service.py",
        "serve/httpd.py", "serve/durable.py", "storex/replica.py", "obs/fleet.py",
        "obs/slo.py", "cluster/__init__.py", "cluster/hashring.py", "cluster/gather.py",
        "backfill/__init__.py", "backfill/scheduler.py", "backfill/engine.py", "subs/__init__.py",
        "subs/registry.py", "subs/matcher.py", "subs/delivery.py", "cluster/router.py",
        "cluster/shard.py", "utils/platform.py", "tools/check_bench_schema.py",
    ):
        assert f"ipc_proofs_tpu_torch/{module}" in rel, module


# The module map ipc_proofs_tpu → port. A reference module whose
# counterpart keeps its path (ipc_proofs_tpu/<p> → ipc_proofs_tpu_torch/<p>)
# needs no entry; these are the others, by path under each package (the
# reference's repo-root entry module by its name).
MODULE_MAP = {
    # both backends are one class: GpuBackend on the card, or device="cpu"
    "backend/cpu.py": ("backend/gpu.py",),
    "backend/tpu.py": ("backend/gpu.py",),
    # XLA and Pallas kernels → a PyTorch wrapper (plain version + launch)
    # over a hand-written CUDA source
    "ops/blake2b_jax.py": ("ops/blake2b.py", "csrc/blake2b.cu"),
    "ops/keccak_jax.py": ("ops/keccak.py", "csrc/keccak.cu"),
    "ops/pallas_kernels.py": ("ops/blake2b.py", "ops/keccak.py", "csrc/blake2b.cu", "csrc/keccak.cu"),
    "ops/match_jax.py": ("ops/match.py",),
    "ops/verify_jax.py": ("ops/verify.py",),
    "__graft_entry__.py": ("entry.py",),
}
# reference modules with no counterpart, and why
NOT_PORTED = {
    "ops/u64.py": "emulates u64 on u32 pairs for TPU lanes; CUDA has u64 and no module imports it",
}


def _reference_modules() -> "list[str]":
    ref = ROOT / "ipc_proofs_tpu"
    return sorted(p.relative_to(ref).as_posix() for p in ref.rglob("*.py")) + ["__graft_entry__.py"]


@pytest.mark.parametrize("module", _reference_modules())
def test_every_reference_module_has_a_counterpart_or_a_reason(module):
    port = ROOT / "ipc_proofs_tpu_torch"
    if module in NOT_PORTED:
        assert not (port / module).exists(), f"{module} is ported: take it out of NOT_PORTED"
        return
    targets = MODULE_MAP.get(module, (module,))
    missing = [t for t in targets if not (port / t).is_file()]
    assert not missing, f"reference {module}: no port counterpart {missing} (add it, or map it)"


def test_module_map_names_only_reference_modules():
    modules = set(_reference_modules())
    assert set(MODULE_MAP) <= modules and set(NOT_PORTED) <= modules
    assert not set(MODULE_MAP) & set(NOT_PORTED)
    assert sorted(NOT_PORTED) == ["ops/u64.py"]


# The reference's tools (repo-root ``tools/``, each module of a tool that
# is a package) → the port's (``ipc_proofs_tpu_torch/tools/``), and those
# not ported yet with the ROADMAP item that takes each.
TOOLS_MAP = {
    "traceview.py": "tools/traceview.py",
    "auditview.py": "tools/auditview.py",
    "chaos.py": "tools/chaos.py",
    "crashtest.py": "tools/crashtest.py",
    "soak.py": "tools/soak.py",
    "check_all.py": "tools/check_all.py",
    "build_native_san.py": "tools/build_native_san.py",
    "check_bench_schema.py": "tools/check_bench_schema.py",
    **{
        f"ipclint/{m}.py": f"tools/ipclint/{m}.py"
        for m in ("__init__", "__main__", "engine", "checks_race", "checks_det", "checks_err",
                  "checks_vocab", "checks_lockorder")
    },
}
TOOLS_NOT_PORTED: "dict[str, str]" = {}


def test_tools_map_accounts_for_every_reference_tool():
    tools = ROOT / "tools"
    entries = {p.relative_to(tools).as_posix() for p in tools.rglob("*.py")
               if "__pycache__" not in p.parts and p.relative_to(tools).as_posix() != "__init__.py"}
    assert entries == set(TOOLS_MAP) | set(TOOLS_NOT_PORTED)
    assert not set(TOOLS_MAP) & set(TOOLS_NOT_PORTED)
    for target in TOOLS_MAP.values():
        assert (ROOT / "ipc_proofs_tpu_torch" / target).is_file(), target
    assert (ROOT / "ipc_proofs_tpu_torch" / "tools" / "_fuzz.py").is_file()
    for tool in TOOLS_NOT_PORTED:
        assert not (ROOT / "ipc_proofs_tpu_torch" / "tools" / tool).exists(), tool


def _public_names(path: Path) -> "set[str]":
    """Top-level functions and classes, ``Class.method`` for their methods,
    and module-level UPPER_CASE tuples — each whose own name has no leading
    underscore (``_MergeFold.n_storage_proofs`` counts)."""
    names = set()
    for node in ast.parse(path.read_text(), filename=str(path)).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            if not node.name.startswith("_"):
                names.add(node.name)
            if isinstance(node, ast.ClassDef):
                names.update(
                    f"{node.name}.{sub.name}" for sub in node.body
                    if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)) and not sub.name.startswith("_")
                )
        elif isinstance(node, ast.Assign) and isinstance(node.value, ast.Tuple):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name) and t.id.isupper())
    return names


# reference names whose counterpart has another name or home:
# "module:Name" → "port module:Name" (a class's entry covers its methods)
RENAMED_NAMES = {
    "backend/cpu.py:CpuBackend": "backend/gpu.py:GpuBackend",
    "backend/tpu.py:TpuBackend": "backend/gpu.py:GpuBackend",
    "backend/tpu.py:flatten_events": "ops/match.py:flatten_events",
    "ops/pallas_kernels.py:blake2b256_single_block_pallas": "ops/blake2b.py:blake2b256_single_block",
    "ops/pallas_kernels.py:blake2b256_two_block_pallas": "ops/blake2b.py:blake2b256_two_block",
    "ops/pallas_kernels.py:keccak256_single_block_pallas": "ops/keccak.py:keccak256_single_block",
    "ops/pallas_kernels.py:pack_single_block_blake2b": "ops/pack.py:pack_single_block_blake2b",
    "ops/pallas_kernels.py:pack_two_block_blake2b": "ops/pack.py:pack_two_block_blake2b",
    "ops/pallas_kernels.py:pack_single_block_keccak": "ops/pack.py:pack_single_block_keccak",
}
# reference public names with no counterpart, and why (a class's entry
# covers its methods)
DROPPED_NAMES = {
    "backend/cpu.py:CpuBackend.has_native": "probes the host C++ hasher; the port has none (NativeHashes)",
    "backend/native/__init__.py:NativeHashes": "the CPU backend's C++ batch hasher: the port hashes batches "
    "with the CUDA kernels and single blocks with hashlib",
    "backend/native/__init__.py:load_native": "builds NativeHashes (above)",
    "ops/keccak_jax.py:keccak_f1600_batch": "the XLA permutation on u32 lo/hi planes; the port's runs on "
    "u64 lanes inside csrc/keccak.cu and its plain twin",
    "ops/match_jax.py:event_match_mask_jit": "a jax.jit wrapper; PyTorch runs the mask's ops eagerly",
    "ops/match_jax.py:event_match_mask_fp_jit": "a jax.jit wrapper; PyTorch runs the mask's ops eagerly",
}


def _name_modules() -> "list[str]":
    return [m for m in _reference_modules() if m not in NOT_PORTED] + [f"tools/{t}" for t in TOOLS_MAP]


def _reference_path(module: str) -> Path:
    if module == "__graft_entry__.py" or module.startswith("tools/"):
        return ROOT / module
    return ROOT / "ipc_proofs_tpu" / module


def _port_targets(module: str) -> "tuple[str, ...]":
    if module.startswith("tools/"):
        return (TOOLS_MAP[module.removeprefix("tools/")],)
    return tuple(t for t in MODULE_MAP.get(module, (module,)) if t.endswith(".py"))


def _counterpart(module: str, name: str) -> "tuple[str, str] | None":
    """(port module, name) the reference ``module:name`` maps to, or None
    when it is dropped."""
    owner, _, member = name.partition(".")
    for key in (f"{module}:{name}", f"{module}:{owner}"):
        if key in DROPPED_NAMES:
            return None
        if key in RENAMED_NAMES:
            target, new = RENAMED_NAMES[key].split(":")
            return target, new + (f".{member}" if key.endswith(f":{owner}") and member else "")
    return "", name


@pytest.mark.parametrize("module", _name_modules())
def test_every_reference_public_name_has_a_counterpart_or_a_reason(module):
    port = ROOT / "ipc_proofs_tpu_torch"
    here = set()
    for target in _port_targets(module):
        here |= _public_names(port / target)
    missing = []
    for name in sorted(_public_names(_reference_path(module))):
        found = _counterpart(module, name)
        if found is None:
            continue
        target, new = found
        have = _public_names(port / target) if target else here
        if new not in have:
            missing.append(name)
    assert not missing, f"reference {module}: {missing} neither ported nor in RENAMED_NAMES / DROPPED_NAMES"


def test_dropped_and_renamed_names_are_current():
    port = ROOT / "ipc_proofs_tpu_torch"
    for key in list(DROPPED_NAMES) + list(RENAMED_NAMES):
        module, name = key.split(":")
        assert name in _public_names(_reference_path(module)), f"{key} is not a reference name"
    for key in DROPPED_NAMES:
        module, name = key.split(":")
        here = set().union(*(_public_names(port / t) for t in _port_targets(module)))
        assert name not in here, f"{key} is ported: take it out of DROPPED_NAMES"
    for key, value in RENAMED_NAMES.items():
        target, new = value.split(":")
        assert new in _public_names(port / target), f"{key} → {value}: no such port name"


# metric names the port counts and the reference does not, with the
# departure that brought each
PORT_ONLY_METRIC_NAMES = {
    "BACKFILL_COUNTERS": {
        "backfill.device_faults": "a fault of the card stops a backfill job as faulted, never failed "
        "(ROADMAP Queue 3, departures by design)",
    },
    "PIPELINE_STAGES": {
        "range_materialize": "the reference times materialization inside `range_record`",
    },
}


def _literal_tuples(path: Path) -> "dict[str, tuple]":
    out = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Tuple):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id.isupper():
                    out[t.id] = ast.literal_eval(node.value)
    return out


def test_metric_vocabularies_hold_the_references_names():
    ref = _literal_tuples(ROOT / "ipc_proofs_tpu" / "utils" / "metrics.py")
    port = _literal_tuples(ROOT / "ipc_proofs_tpu_torch" / "utils" / "metrics.py")
    assert set(PORT_ONLY_METRIC_NAMES) <= set(ref)
    for name, names in ref.items():
        assert name in port, name
        assert not set(names) - set(port[name]), (name, sorted(set(names) - set(port[name])))
        assert set(port[name]) - set(names) == set(PORT_ONLY_METRIC_NAMES.get(name, {})), name


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_reference_imports(path):
    bad = [name for name in _imported_modules(path) if _forbidden(name)]
    assert not bad, f"{path.name} imports {bad}"


_RUN_SMALL_PATH = """
import sys
from ipc_proofs_tpu_torch.backend import get_backend
from ipc_proofs_tpu_torch.backend.native import load_scan_ext
from ipc_proofs_tpu_torch.fixtures import build_range_world
from ipc_proofs_tpu_torch.proofs import range as range_mod
from ipc_proofs_tpu_torch.proofs.generator import EventProofSpec
from ipc_proofs_tpu_torch.proofs.range import generate_event_proofs_for_range
from ipc_proofs_tpu_torch.proofs.trust import TrustPolicy
from ipc_proofs_tpu_torch.proofs.verifier import verify_proof_bundle
import chip_smoke  # the smoke script's imports too

assert load_scan_ext() is not None
native_ok = []
scan_and_match = range_mod._scan_and_match
def spy(*args, **kwargs):
    out = scan_and_match(*args, **kwargs)
    native_ok.append(out[1])
    return out
range_mod._scan_and_match = spy
storage_native = []
for_pairs = range_mod.generate_storage_proofs_for_pairs
def storage_spy(*args, **kwargs):
    out = for_pairs(*args, **kwargs)
    storage_native.append(out is not None)
    return out
range_mod.generate_storage_proofs_for_pairs = storage_spy

store, pairs, n_matching = build_range_world(8, 8, 4, 0.125)
backend = get_backend("gpu", device="cpu")
bundle = generate_event_proofs_for_range(
    store, pairs, EventProofSpec("NewTopDownMessage(bytes32,uint256)", "calib-subnet-1", 1001),
    match_backend=backend,
)
assert native_ok == [True], native_ok
result = verify_proof_bundle(bundle, TrustPolicy.accept_all(), verify_witness_cids=True,
                             cid_backend=backend)
assert result.all_valid() and len(result.event_results) == n_matching > 0
event_bundle = bundle

from ipc_proofs_tpu_torch.fixtures import ContractFixture, build_chain
from ipc_proofs_tpu_torch.proofs.range import TipsetPair
from ipc_proofs_tpu_torch.proofs.storage_batch import MappingSlotSpec
from ipc_proofs_tpu_torch.state.storage import calculate_storage_slot

storage = {calculate_storage_slot("subnet-0", i): bytes([i + 1]) for i in range(8)}
world = build_chain([ContractFixture(1001, storage=storage)], [])
specs = [MappingSlotSpec(1001, "subnet-0", i) for i in range(8)]
bundle = generate_event_proofs_for_range(
    world.store, [TipsetPair(world.parent, world.child)],
    EventProofSpec("NewTopDownMessage(bytes32,uint256)", "calib-subnet-1", 1001),
    match_backend=backend, storage_specs=specs,
)
assert storage_native == [True], storage_native
result = verify_proof_bundle(bundle, TrustPolicy.accept_all(), verify_witness_cids=True,
                             cid_backend=backend)
assert result.all_valid() and len(result.storage_results) == 8 and not bundle.event_proofs

import pkgutil, importlib, tempfile
import ipc_proofs_tpu_torch
for info in pkgutil.walk_packages(ipc_proofs_tpu_torch.__path__, "ipc_proofs_tpu_torch."):
    importlib.import_module(info.name)
from ipc_proofs_tpu_torch import cli
assert cli.main(["demo", "--backend", "cpu"]) == 0
from ipc_proofs_tpu_torch.proofs.range import (
    generate_and_verify_range_overlapped,
    generate_event_proofs_for_range_pipelined,
)
with tempfile.TemporaryDirectory() as job_dir:
    merged, verdicts = generate_and_verify_range_overlapped(
        store, pairs, EventProofSpec("NewTopDownMessage(bytes32,uint256)", "calib-subnet-1", 1001),
        chunk_size=3, match_backend=backend, scan_threads=2, force_pipeline=True, job_dir=job_dir,
        verify_chunk=lambda b: verify_proof_bundle(
            b, TrustPolicy.accept_all(), verify_witness_cids=True, cid_backend=backend
        ).event_results,
    )
assert merged.to_json() == event_bundle.to_json()
assert [v for chunk in verdicts for v in chunk] == [True] * n_matching

from ipc_proofs_tpu_torch.serve import ProofService, ServiceConfig
from ipc_proofs_tpu_torch.witness import (
    WitnessOptions, aggregate_range_bundle, encode_bundle_fields, expand_response_fields, verify_aggregated,
)
with tempfile.TemporaryDirectory() as reg_dir:
    with ProofService(store=store, spec=EventProofSpec("NewTopDownMessage(bytes32,uint256)", "calib-subnet-1", 1001),
                      config=ServiceConfig(device="cpu", verify_witness_cids=True, max_wait_ms=1.0,
                                           registry_dir=reg_dir)) as svc:
        served = svc.generate(pairs[0]).bundle
        fields = encode_bundle_fields(served, WitnessOptions(encoding="zlib"), bases=svc.witness_bases)
        assert expand_response_fields(fields).to_json() == served.to_json()
        assert svc.registry.append_served(fields["digest"], cids=served.cid_set()) == 0
        assert svc.verify(served).all_valid()
import json, urllib.request
from ipc_proofs_tpu_torch.serve import DurableAdmission, ProofHTTPServer
from ipc_proofs_tpu_torch.storex import ReplicaClient
with tempfile.TemporaryDirectory() as root:
    svc = ProofService(store=store, spec=EventProofSpec("NewTopDownMessage(bytes32,uint256)", "calib-subnet-1", 1001),
                       config=ServiceConfig(device="cpu", max_wait_ms=1.0, store_dir=root + "/seg",
                                            registry_dir=root + "/reg"))
    httpd = ProofHTTPServer(svc, pairs=pairs, durable=DurableAdmission(svc, root + "/q", pairs=pairs)).start()
    try:
        def call(path, body):
            req = urllib.request.Request(httpd.address + path, data=json.dumps(body).encode(),
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as resp:
                return json.loads(resp.read())
        gen = call("/v1/generate", {"pair_index": 0, "idempotency_key": "k", "witness_encoding": "zlib"})
        assert gen["ok"] and gen["result"]["witness_encoding"] == "zlib"
        assert call("/v1/verify", {"bundle": event_bundle.to_json_obj()})["result"]["all_valid"]
        assert ReplicaClient("self", httpd.address).list_segments()
        with urllib.request.urlopen(httpd.address + "/metrics.prom", timeout=60) as resp:
            assert b"ipc_serve" in resp.read()
    finally:
        httpd.shutdown(timeout=60)
agg = aggregate_range_bundle(event_bundle, pairs, list(range(len(pairs))))
assert all(r.all_valid() for r in verify_aggregated(
    agg, TrustPolicy.accept_all(), verify_witness_cids=True, cid_backend=backend))

import os
os.environ["IPC_VERIFY_MIN_BYTES"] = "0"
from ipc_proofs_tpu_torch.store import FetchPlane, LocalLotusSession, LotusClient, PlaneBlockstore
from ipc_proofs_tpu_torch.storex import SegmentStore, TieredBlockstore
from ipc_proofs_tpu_torch.utils.metrics import Metrics
with tempfile.TemporaryDirectory() as store_dir:
    for sweep in (False, True):
        metrics = Metrics()
        plane = FetchPlane(LotusClient("http://node", session=LocalLotusSession(store), metrics=metrics),
                           backend=backend, metrics=metrics)
        disk = SegmentStore(store_dir, verify_scan=sweep, backend=backend, metrics=metrics)
        tier = TieredBlockstore(PlaneBlockstore(plane), disk, metrics=metrics)
        plane.set_local(tier)
        try:
            cold = generate_event_proofs_for_range_pipelined(
                tier, pairs, EventProofSpec("NewTopDownMessage(bytes32,uint256)", "calib-subnet-1", 1001),
                chunk_size=3, match_backend=backend, force_pipeline=True,
            )
        finally:
            plane.close()
            disk.close()
        assert cold.to_json() == event_bundle.to_json()
        assert metrics.counter_value("verify.device_blocks") > 0
        assert (metrics.counter_value("rpc.calls") == 0) == sweep
import torch
from ipc_proofs_tpu_torch.entry import dryrun_multichip
assert dryrun_multichip(2, devices=[torch.device("cpu")] * 2)["event_proofs"] > 0

from ipc_proofs_tpu_torch.obs import enable_tracing, disable_tracing, root_span, write_otlp_trace
from ipc_proofs_tpu_torch.store import EndpointPool
from ipc_proofs_tpu_torch.storex import ChainFollower
collector = enable_tracing()
metrics = Metrics()
by_height = {p.parent.height: p.parent for p in pairs}
by_height.update({p.child.height: p.child for p in pairs})
def tipset_json(ts):
    return {"Cids": [{"/": str(c)} for c in ts.cids], "Height": ts.height, "Blocks": [
        {"Parents": [{"/": str(p)} for p in h.parents], "Height": h.height, "Timestamp": h.timestamp,
         "ParentStateRoot": {"/": str(h.parent_state_root)}, "Messages": {"/": str(h.messages)},
         "ParentMessageReceipts": {"/": str(h.parent_message_receipts)}} for h in ts.blocks]}
def node():
    return LocalLotusSession(store, {
        "Filecoin.ChainHead": {"Height": max(by_height)},
        "Filecoin.ChainGetTipSetByHeight": lambda params: tipset_json(by_height[params[0]]),
    })
pool = EndpointPool([LotusClient("http://a", session=node(), metrics=metrics),
                     LotusClient("http://b", session=node(), metrics=metrics)],
                    hedge_ms=50.0, backend=backend, metrics=metrics)
plane = FetchPlane(pool, backend=backend, metrics=metrics)
with root_span("small.pool"):
    try:
        pooled = generate_event_proofs_for_range_pipelined(
            PlaneBlockstore(plane), pairs, EventProofSpec("NewTopDownMessage(bytes32,uint256)", "calib-subnet-1", 1001),
            chunk_size=3, match_backend=backend, force_pipeline=True,
        )
    finally:
        plane.close()
        pool.close()
assert pooled.to_json() == event_bundle.to_json()
class Tier(dict):
    put_local = dict.__setitem__
    has_local = dict.__contains__
    get_local = dict.get
follower = ChainFollower(LotusClient("http://c", session=node(), metrics=metrics), Tier(), lag=0,
                         start_height=max(by_height), backend=backend, metrics=metrics)
assert follower.poll_once() == 1 and metrics.counter_value("follow.errors") == 0
with tempfile.TemporaryDirectory() as out:
    assert write_otlp_trace(out + "/t.json", collector.snapshot()) > 0
disable_tracing()
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "ipc_proofs_tpu", "requests"))
print("LOADED", bad)
with open("/proc/self/maps") as fh:
    libs = sorted({line.split()[-1] for line in fh if line.rstrip().endswith(".so")})
print("LIBS", [lib for lib in libs if "/ipc_proofs_tpu/" in lib])
print("PORT", [lib.rsplit("/", 1)[-1].split("-")[0] for lib in libs
               if "/ipc_proofs_tpu_torch/_build/" in lib])
"""


def test_small_range_path_loads_no_jax_or_reference():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run(
        [sys.executable, "-c", _RUN_SMALL_PATH],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert "LOADED []" in proc.stdout, proc.stdout
    assert "LIBS []" in proc.stdout, proc.stdout
    assert "PORT ['ipc_torch_dagcbor_ext', 'ipc_torch_scan_ext']" in proc.stdout, proc.stdout


@pytest.mark.parametrize("driver", ["chunked", "pipelined", "overlapped"])
def test_range_drivers_default_to_the_card(monkeypatch, small_range, driver):
    """Without a backend the chunked, pipelined and overlapped drivers take
    the card, so without CUDA they raise instead of running on the CPU."""
    store, pairs, _ = small_range
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call = {
        "chunked": lambda: generate_event_proofs_for_range_chunked(store, pairs, SPEC, chunk_size=2),
        "pipelined": lambda: generate_event_proofs_for_range_pipelined(
            store, pairs, SPEC, chunk_size=2, force_pipeline=True
        ),
        "overlapped": lambda: generate_and_verify_range_overlapped(
            store, pairs, SPEC, chunk_size=2, verify_chunk=lambda b: None, force_pipeline=True
        ),
    }[driver]
    with pytest.raises(RuntimeError, match="CUDA"):
        call()


@pytest.mark.parametrize("command", ["demo", "verify", "range", "serve", "backfill", "cluster"])
def test_cli_refuses_the_host_without_cuda(monkeypatch, tmp_path, small_range, command):
    """With CUDA reported absent, the CLI's default ``--backend gpu`` exits
    with the backend's error before any work, and ``--backend cpu`` runs."""
    _, _, bundle = small_range
    path = tmp_path / "bundle.json"
    path.write_text(bundle.to_json())
    argv = {
        "demo": ["demo"],
        "verify": ["verify", str(path), "--check-cids"],
        "range": ["range", "--endpoint", "http://node.invalid/rpc/v1", "--from-height", "0",
                  "--to-height", "1", "--event-sig", SPEC.event_signature, "--topic1", "x"],
        "serve": ["serve", "--demo-world", "2", "--port", "0"],
        "backfill": ["backfill", "--demo-world", "2", "-o", str(tmp_path / "bf.json")],
        "cluster": ["cluster", "--demo-world", "2", "--shards", "1", "--port", "0"],
    }[command]
    from ipc_proofs_tpu_torch import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA"):
        cli.main(argv)
    # range's host run needs a node, and serve's and cluster's never return
    # on their own (all in tests/test_torch_cli.py)
    if command not in ("range", "serve", "cluster"):
        assert cli.main(argv + ["--backend", "cpu"]) == 0


def test_cli_module_exits_nonzero_without_cuda():
    """``python -m ipc_proofs_tpu_torch.cli demo`` with CUDA reported
    absent: a non-zero exit with the backend's error, no result printed."""
    script = (
        "import runpy, sys, torch\n"
        "torch.cuda.is_available = lambda: False\n"
        "sys.argv = ['ipc_proofs_tpu_torch.cli', 'demo']\n"
        "runpy.run_module('ipc_proofs_tpu_torch.cli', run_name='__main__')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr
    assert "All valid" not in proc.stdout


@pytest.mark.parametrize(
    "argv, names",
    [
        (["--platform", "auto"], ("card probe", "no CPU fallback")),
        (["--leg", "e2e", "--platform", "cuda"], ("the card was asked for",)),
    ],
    ids=["orchestrator-auto", "leg-cuda"],
)
def test_bench_refuses_the_host_without_cuda(argv, names):
    """``bench_torch.py`` without a card: the orchestrator's probe fails
    (one attempt here) and raises, naming the probe; a leg asked for the
    card fails before any work. Neither prints an artifact line or falls
    back to the CPU."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="", IPC_BENCH_PROBE_ATTEMPTS="1")
    env.pop("IPC_BENCH_PLATFORM", None)
    proc = subprocess.run([sys.executable, str(ROOT / "bench_torch.py"), *argv], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    for name in names:
        assert name in proc.stderr, proc.stderr[-2000:]
    assert proc.stdout.strip() == ""


def test_gpu_backend_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        GpuBackend()
    with pytest.raises(RuntimeError, match="CUDA"):
        get_backend("gpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        GpuBackend("cuda:0")


SPEC = EventProofSpec("NewTopDownMessage(bytes32,uint256)", "calib-subnet-1", 1001)


@pytest.fixture(scope="module")
def small_range():
    store, pairs, _ = build_range_world(4, 4, 2, 0.5)
    bundle = generate_event_proofs_for_range(
        store, pairs, SPEC, match_backend=get_backend("gpu", device="cpu")
    )
    assert bundle.event_proofs
    return store, pairs, bundle


_SCALAR_REPLAY = """
import torch
from ipc_proofs_tpu_torch.backend import get_backend
from ipc_proofs_tpu_torch.backend.native import load_scan_ext
from ipc_proofs_tpu_torch.fixtures import build_range_world
from ipc_proofs_tpu_torch.proofs.generator import EventProofSpec
from ipc_proofs_tpu_torch.proofs.range import generate_event_proofs_for_range
from ipc_proofs_tpu_torch.proofs.trust import TrustPolicy
from ipc_proofs_tpu_torch.proofs.verifier import verify_proof_bundle

assert load_scan_ext() is None
store, pairs, _ = build_range_world(4, 4, 2, 0.5)
bundle = generate_event_proofs_for_range(
    store, pairs, EventProofSpec("NewTopDownMessage(bytes32,uint256)", "calib-subnet-1", 1001),
    match_backend=get_backend("gpu", device="cpu"),
)
torch.cuda.is_available = lambda: False
result = verify_proof_bundle(bundle, TrustPolicy.accept_all())
assert result.event_results and result.all_valid()
print("SCALAR REPLAY OK", len(result.event_results))
"""


def test_entry_points_default_to_the_card(monkeypatch, small_range):
    store, pairs, bundle = small_range
    backend = get_backend("gpu", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        generate_event_proofs_for_range(store, pairs, SPEC)
    with pytest.raises(RuntimeError, match="CUDA"):
        verify_proof_bundle(bundle, TrustPolicy.accept_all(), verify_witness_cids=True)
    # the batched replay's TxMeta recompute needs the card ...
    with pytest.raises(RuntimeError, match="CUDA"):
        verify_proof_bundle(bundle, TrustPolicy.accept_all())
    # ... and runs on the backend it is given
    assert verify_proof_bundle(bundle, TrustPolicy.accept_all(), cid_backend=backend).all_valid()
    # no proof reaches the TxMeta recompute: nothing needs the card
    assert not any(
        verify_proof_bundle(
            bundle, TrustPolicy.with_custom_verifier(MockTrustVerifier(parent_result=False))
        ).event_results
    )
    # the scalar replay of the pure-Python universe runs no kernel
    env = dict(os.environ, PYTHONPATH=str(ROOT), IPC_PROOFS_NO_NATIVE="1")
    proc = subprocess.run(
        [sys.executable, "-c", _SCALAR_REPLAY],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert "SCALAR REPLAY OK" in proc.stdout, proc.stdout


@pytest.mark.parametrize("tamper", [False, True])
def test_witness_block_of_another_multihash_recomputes_on_the_host(small_range, tamper):
    _, _, bundle = small_range
    data = b"a block hashed with sha2-256"
    cid = CID.hash_of(data, codec=RAW, mh_code=SHA2_256)
    extra = ProofBlock(cid, data[:-1] + b"!" if tamper else data)
    mixed = dataclasses.replace(bundle, blocks=sorted(
        bundle.blocks + [extra], key=lambda b: b.cid.to_bytes()
    ))
    backend = get_backend("gpu", device="cpu")
    if tamper:
        with pytest.raises(ValueError):
            verify_proof_bundle(
                mixed, TrustPolicy.accept_all(), verify_witness_cids=True, cid_backend=backend
            )
    else:
        assert verify_proof_bundle(
            mixed, TrustPolicy.accept_all(), verify_witness_cids=True, cid_backend=backend
        ).all_valid()


def test_mesh_entry_points_default_to_the_card(monkeypatch):
    """Without CUDA the mesh, its backend, the multi-device dry run, the
    device step and the CID bench setup raise, unless given CPU devices."""
    from ipc_proofs_tpu_torch.entry import dryrun_multichip, entry
    from ipc_proofs_tpu_torch.ops.cid_bench import blake2b_cid_bench_setup
    from ipc_proofs_tpu_torch.parallel.mesh import make_mesh
    from ipc_proofs_tpu_torch.parallel.multihost import global_mesh, initialize_distributed

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (
        make_mesh,
        global_mesh,
        lambda: get_backend("gpu", mesh_devices=1),
        lambda: get_backend("gpu", mesh_devices=0),
        lambda: GpuBackend(mesh=None),
        entry,
        lambda: dryrun_multichip(1),
        lambda: blake2b_cid_bench_setup([b"x"]),
        lambda: initialize_distributed("127.0.0.1:1", 1, 0),
    ):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    cpu = torch.device("cpu")
    assert make_mesh(2, devices=[cpu] * 2).size == 2
    assert global_mesh(devices=[cpu]).size == 1
    assert get_backend("gpu", device="cpu", mesh_devices=2).mesh.devices == [cpu, cpu]
    assert entry(device="cpu")[1][0].device == cpu


def test_cpu_backend_is_cached_per_variant():
    backend = get_backend("gpu", device="cpu")
    assert backend is get_backend("gpu", device=torch.device("cpu"))
    assert backend.device.type == "cpu" and backend.mesh is None and backend.name == "gpu"


@pytest.mark.parametrize("name", ["cpu", "tpu", "cuda"])
def test_unknown_backend_names_raise(name):
    with pytest.raises(ValueError, match="unknown backend"):
        get_backend(name, device="cpu")


def test_unsupported_device_raises():
    with pytest.raises(ValueError, match="unsupported device"):
        GpuBackend("meta")


def test_storage_entry_points_default_to_the_card(monkeypatch):
    world = build_chain([ContractFixture(1001, storage={b"\x01" * 32: b"\x02"})], [])
    specs = [MappingSlotSpec(1001, "subnet-0", i) for i in range(2)]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        hash_slot_specs(specs)
    with pytest.raises(RuntimeError, match="CUDA"):
        generate_storage_proofs_batch(world.store, world.parent, world.child, specs)
    with pytest.raises(RuntimeError, match="CUDA"):
        generate_proof_bundle(
            world.store, world.parent, world.child, [], [EventProofSpec("E(uint256)", "subnet-0")]
        )
    # slots hashed elsewhere: the batch itself runs no kernel
    bundle = generate_storage_proofs_batch(
        world.store, world.parent, world.child, specs, precomputed_slots=[b"\x01" * 32] * 2
    )
    assert [p.value[-2:] for p in bundle.storage_proofs] == ["02", "02"]


def test_import_builds_nothing():
    code = (
        "import ipc_proofs_tpu_torch.ops.blake2b, ipc_proofs_tpu_torch.ops.keccak, "
        "ipc_proofs_tpu_torch.ops.build as b; "
        "print(b._BUILD.exists())"
    )
    before = (ROOT / "ipc_proofs_tpu_torch" / "_build").exists()
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=60
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == str(before)


def test_cold_read_path_defaults_to_the_card(monkeypatch, tmp_path):
    """The verify lane, its autotuner, the fetch plane and the segment
    store take the card when no backend is given: none of them falls back
    to hashlib for want of CUDA."""
    from ipc_proofs_tpu_torch.ops.verify import autotune_crossover, verify_blocks_batch
    from ipc_proofs_tpu_torch.store import FetchPlane, LocalLotusSession, LotusClient, MemoryBlockstore
    from ipc_proofs_tpu_torch.storex import SegmentStore

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    client = LotusClient("http://node", session=LocalLotusSession(MemoryBlockstore()))
    for call in (
        lambda: verify_blocks_batch([CID.hash_of(b"a")], [b"a"]),
        lambda: autotune_crossover(),
        lambda: FetchPlane(client),
        lambda: SegmentStore(str(tmp_path)),
    ):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


_SERVE_CHILD = """
import runpy, sys
sys.argv = ["ipc_proofs_tpu_torch.cli"] + sys.argv[1:]
try:
    runpy.run_module("ipc_proofs_tpu_torch.cli", run_name="__main__")
finally:
    bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "ipc_proofs_tpu"))
    print("LOADED", bad, flush=True)
"""


def test_cli_serve_loads_no_jax_or_reference(tmp_path):
    """``cli serve`` over a demo world with the durable queue, disk tier
    and registry: it answers generate and verify over HTTP, exits 0 on
    SIGTERM, and never loads ``jax`` or ``ipc_proofs_tpu``."""
    import json
    import signal
    import time
    import urllib.request

    port_file = tmp_path / "port"
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.Popen(
        [sys.executable, "-c", _SERVE_CHILD, "serve", "--backend", "cpu", "--demo-world", "4", "--check-cids",
         "--port", "0", "--port-file", str(port_file), "--store-dir", str(tmp_path / "seg"),
         "--queue-dir", str(tmp_path / "q"), "--registry-dir", str(tmp_path / "reg")],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    try:
        deadline = time.monotonic() + 90
        while not port_file.exists() and proc.poll() is None and time.monotonic() < deadline:
            time.sleep(0.05)
        assert port_file.exists(), proc.communicate(timeout=30)
        base = f"http://127.0.0.1:{port_file.read_text()}"

        def call(path, body):
            req = urllib.request.Request(base + path, data=json.dumps(body).encode(),
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as resp:
                return json.loads(resp.read())

        gen = call("/v1/generate", {"pair_index": 1})
        assert gen["ok"] and call("/v1/verify", {"bundle": gen["result"]["bundle"]})["result"]["all_valid"]
    finally:
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=60)
    assert proc.returncode == 0, err[-2000:]
    assert "LOADED []" in out, out


def test_cli_backfill_and_serve_engines_load_no_jax_or_reference(tmp_path):
    """``cli backfill`` over a demo world writes its bundle, and ``cli
    serve`` with ``--subs-dir``, ``--slo on`` and ``--backfill-jobs-dir``
    answers a subscription, a backfill job to its end and a ``/healthz``
    with the ``slo`` block, exits 0 on SIGTERM; neither loads ``jax`` or
    ``ipc_proofs_tpu``."""
    import json
    import signal
    import time
    import urllib.request

    env = dict(os.environ, PYTHONPATH=str(ROOT))
    done = subprocess.run(
        [sys.executable, "-c", _SERVE_CHILD, "backfill", "--backend", "cpu", "--demo-world", "6",
         "--window-size", "2", "--jobs-dir", str(tmp_path / "jobs"), "-o", str(tmp_path / "bf.json")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120,
    )
    assert done.returncode == 0, done.stderr[-2000:]
    assert "LOADED []" in done.stdout and json.loads((tmp_path / "bf.json").read_text())["blocks"]
    port_file = tmp_path / "port"
    proc = subprocess.Popen(
        [sys.executable, "-c", _SERVE_CHILD, "serve", "--backend", "cpu", "--demo-world", "6",
         "--port", "0", "--port-file", str(port_file), "--subs-dir", str(tmp_path / "subs"),
         "--slo", "on", "--slo-interval-s", "0.05", "--backfill-jobs-dir", str(tmp_path / "bfjobs"),
         "--backfill-window-size", "2"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    try:
        deadline = time.monotonic() + 90
        while not port_file.exists() and proc.poll() is None and time.monotonic() < deadline:
            time.sleep(0.05)
        assert port_file.exists(), proc.communicate(timeout=30)
        base = f"http://127.0.0.1:{port_file.read_text()}"

        def call(path, body=None):
            data = None if body is None else json.dumps(body).encode()
            req = urllib.request.Request(base + path, data=data, headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as resp:
                return json.loads(resp.read())

        sub = call("/v1/subscribe", {"filter": {"signature": "NewTopDownMessage(bytes32,uint256)",
                                                "topic1": "calib-subnet-1"}, "sub_id": "s1"})
        assert sub == {"sub_id": "s1", "created": True}
        job = call("/v1/backfill", {"pair_start": 0, "pair_end": 6})
        while job["state"] == "running" and time.monotonic() < deadline + 60:
            time.sleep(0.05)
            job = call(f"/v1/backfill/{job['job_id']}")
        assert job["state"] == "complete" and job["windows_done"] == 3
        health = call("/healthz")
        assert health["subscriptions"] == 1 and health["slo"]["status"] == "ok"
    finally:
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=60)
    assert proc.returncode == 0, err[-2000:]
    assert "LOADED []" in out, out


@pytest.mark.parametrize("module", ["utils.threads", "obs.slo", "utils.log", "utils.platform"])
def test_a_leaf_module_imports_first(module):
    """A process whose first import of the port is ``module`` starts: the
    first logger imports ``obs``, whose ``slo`` takes ``locked`` from
    ``utils.threads`` (which used to raise ImportError, a partly
    initialized module, when ``utils.threads`` came first)."""
    subprocess.run([sys.executable, "-c", f"import ipc_proofs_tpu_torch.{module}"], cwd=ROOT, check=True,
                   timeout=120, env=dict(os.environ, PYTHONPATH=str(ROOT)))
