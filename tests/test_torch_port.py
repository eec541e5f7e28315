"""Boundaries of the PyTorch port: what it may import, where it runs.

- No module of ``ipc_proofs_tpu_torch`` (``parallel/``, ``jobs/``,
  ``utils/``, ``ops/verify.py``, ``store/`` and ``storex/`` included) and no
  line of ``chip_smoke.py`` imports ``jax`` or anything of
  ``ipc_proofs_tpu`` (an AST walk), and a process that imports every module
  of the port and runs the small range and storage paths, one journaled
  run of the overlapped driver and one cold read (hermetic Lotus node →
  client → fetch plane → tier over a segment store, the landed waves and
  the disk sweep verified on the backend) on ``device="cpu"`` through the
  native branches ends with neither (nor ``requests``) in ``sys.modules``
  and no shared library of ``ipc_proofs_tpu/`` mapped.
- Entry points default to the card: without CUDA, ``GpuBackend()``,
  ``generate_event_proofs_for_range``, its chunked, pipelined and
  overlapped drivers, ``hash_slot_specs``,
  ``generate_storage_proofs_batch``, ``generate_proof_bundle``,
  ``verify_proof_bundle(..., verify_witness_cids=True)``, the batched
  event replay's TxMeta recompute, ``verify_blocks_batch``,
  ``autotune_crossover`` and the verifying fetch plane and segment store
  raise instead of running on the CPU; the
  scalar replay of the ``IPC_PROOFS_NO_NATIVE=1`` universe runs no kernel.
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
from ipc_proofs_tpu_torch.proofs.verifier import accept_all, verify_proof_bundle

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "ipc_proofs_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "ipc_proofs_tpu")


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
        "storex/segments.py", "storex/tiered.py",
    ):
        assert f"ipc_proofs_tpu_torch/{module}" in rel, module


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
from ipc_proofs_tpu_torch.proofs.verifier import accept_all, verify_proof_bundle
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
result = verify_proof_bundle(bundle, accept_all, accept_all, verify_witness_cids=True,
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
result = verify_proof_bundle(bundle, accept_all, accept_all, verify_witness_cids=True,
                             cid_backend=backend)
assert result.all_valid() and len(result.storage_results) == 8 and not bundle.event_proofs

import pkgutil, importlib, tempfile
import ipc_proofs_tpu_torch
for info in pkgutil.walk_packages(ipc_proofs_tpu_torch.__path__, "ipc_proofs_tpu_torch."):
    importlib.import_module(info.name)
from ipc_proofs_tpu_torch.proofs.range import (
    generate_and_verify_range_overlapped,
    generate_event_proofs_for_range_pipelined,
)
with tempfile.TemporaryDirectory() as job_dir:
    merged, verdicts = generate_and_verify_range_overlapped(
        store, pairs, EventProofSpec("NewTopDownMessage(bytes32,uint256)", "calib-subnet-1", 1001),
        chunk_size=3, match_backend=backend, scan_threads=2, force_pipeline=True, job_dir=job_dir,
        verify_chunk=lambda b: verify_proof_bundle(
            b, accept_all, accept_all, verify_witness_cids=True, cid_backend=backend
        ).event_results,
    )
assert merged.to_json() == event_bundle.to_json()
assert [v for chunk in verdicts for v in chunk] == [True] * n_matching

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
from ipc_proofs_tpu_torch.proofs.verifier import accept_all, verify_proof_bundle

assert load_scan_ext() is None
store, pairs, _ = build_range_world(4, 4, 2, 0.5)
bundle = generate_event_proofs_for_range(
    store, pairs, EventProofSpec("NewTopDownMessage(bytes32,uint256)", "calib-subnet-1", 1001),
    match_backend=get_backend("gpu", device="cpu"),
)
torch.cuda.is_available = lambda: False
result = verify_proof_bundle(bundle, accept_all, accept_all)
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
        verify_proof_bundle(bundle, accept_all, accept_all, verify_witness_cids=True)
    # the batched replay's TxMeta recompute needs the card ...
    with pytest.raises(RuntimeError, match="CUDA"):
        verify_proof_bundle(bundle, accept_all, accept_all)
    # ... and runs on the backend it is given
    assert verify_proof_bundle(bundle, accept_all, accept_all, cid_backend=backend).all_valid()
    # no proof reaches the TxMeta recompute: nothing needs the card
    assert not any(
        verify_proof_bundle(bundle, lambda e, c: False, accept_all).event_results
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
                mixed, accept_all, accept_all, verify_witness_cids=True, cid_backend=backend
            )
    else:
        assert verify_proof_bundle(
            mixed, accept_all, accept_all, verify_witness_cids=True, cid_backend=backend
        ).all_valid()


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
