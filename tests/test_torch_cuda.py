"""The port's CUDA kernels on the card (marked ``cuda``; skipped without one).

Run on a machine with an H100: ``python -m pytest -m cuda tests/test_torch_cuda.py``.
This file imports no JAX, so it runs where only PyTorch is installed. Each
kernel must equal its plain PyTorch version bit for bit (tolerance 0:
integer hashing) and count exactly its own launches.
"""

import hashlib
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from ipc_proofs_tpu_torch.backend import get_backend
from ipc_proofs_tpu_torch.backend.gpu import GpuBackend
from ipc_proofs_tpu_torch.backend.native import load_scan_ext
from ipc_proofs_tpu_torch.core.hashes import keccak256
from ipc_proofs_tpu_torch.fixtures import ContractFixture, build_chain, build_range_world
from ipc_proofs_tpu_torch.ops import blake2b, keccak, match, pack
from ipc_proofs_tpu_torch.proofs.generator import EventProofSpec
from ipc_proofs_tpu_torch.proofs.range import (
    generate_and_verify_range_overlapped,
    generate_event_proofs_for_range,
    generate_event_proofs_for_range_chunked,
)
from ipc_proofs_tpu_torch.proofs.storage_batch import (
    MappingSlotSpec,
    generate_storage_proofs_batch,
)
from ipc_proofs_tpu_torch.proofs.verifier import accept_all, verify_proof_bundle
from ipc_proofs_tpu_torch.state.storage import calculate_storage_slot

pytestmark = pytest.mark.cuda
ROOT = Path(__file__).resolve().parent.parent

LENGTHS = [0, 1, 127, 128, 129, 255, 256, 257, 384, 385, 520]
KECCAK_LENGTHS = [0, 1, 63, 64, 65, 134, 135, 136, 137, 271, 272, 273, 543]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (on the card: python -m pytest -m cuda)")
    return torch.device("cuda")


def _messages(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in lengths]


def _t(array):
    return torch.from_numpy(np.ascontiguousarray(array).view(np.int32))


def _cases(messages):
    out = []
    for cap, packer, name in (
        (128, pack.pack_single_block_blake2b, "blake2b256_single_block"),
        (256, pack.pack_two_block_blake2b, "blake2b256_two_block"),
    ):
        m_lo, m_hi, lengths, _ = packer([m for m in messages if len(m) <= cap])
        out.append((name, (_t(m_lo), _t(m_hi), _t(lengths))))
    blocks, n_blocks, lengths = pack.pad_blake2b(messages)
    out.append(("blake2b256_blocks", (_t(blocks), _t(n_blocks), _t(lengths))))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_each_kernel_equals_plain_and_counts_once(cuda_device, seed):
    rng = np.random.default_rng(seed)
    messages = _messages(LENGTHS * 4 + rng.integers(0, 600, 500).tolist(), seed=seed)
    for name, args in _cases(messages):
        blake2b.reset_launch_counts()
        out = getattr(blake2b, name)(*(a.to(cuda_device) for a in args))
        torch.cuda.synchronize()
        assert torch.equal(out.cpu(), getattr(blake2b, name + "_plain")(*args))
        assert blake2b.LAUNCHES[name] == 1
        assert sum(blake2b.LAUNCHES.values()) == 1


def test_backend_split_on_card(cuda_device):
    messages = _messages(LENGTHS * 5, seed=3)
    assert get_backend("gpu").blake2b256_batch(messages) == [
        hashlib.blake2b(m, digest_size=32).digest() for m in messages
    ]


def test_match_mask_on_card_equals_cpu(cuda_device):
    rng = np.random.default_rng(4)
    n = 1000
    topics = rng.integers(0, 4, (n, 2, 8), dtype=np.uint32)
    target = bytes(32)
    n_topics = rng.integers(1, 4, n).astype(np.int32)
    emitters = rng.integers(1000, 1003, n).astype(np.int64)
    valid = rng.random(n) < 0.9
    topics[rng.random(n) < 0.3] = 0
    match.LAUNCHES["event_match_mask"] = 0
    for actor in (None, 1001):
        on_card = match.event_match_mask_flat(
            topics, n_topics, emitters, valid, target, target, actor, cuda_device
        )
        on_cpu = match.event_match_mask_flat(
            topics, n_topics, emitters, valid, target, target, actor, "cpu"
        )
        np.testing.assert_array_equal(on_card, on_cpu)
        assert on_card.any()
    assert match.LAUNCHES["event_match_mask"] == 2


def _reset_match_counts():
    for name in match.LAUNCHES:
        match.LAUNCHES[name] = 0


def test_small_range_path_on_card(cuda_device, monkeypatch):
    """The fused C scan+match launches no mask; the unfused branch runs the
    fingerprint mask on the card once and gives the same bundle."""
    store, pairs, n_matching = build_range_world(16, 8, 4, 0.125)
    spec = EventProofSpec("NewTopDownMessage(bytes32,uint256)", "calib-subnet-1", 1001)
    blake2b.reset_launch_counts()
    _reset_match_counts()
    backend = get_backend("gpu")
    bundle = generate_event_proofs_for_range(store, pairs, spec, match_backend=backend)
    result = verify_proof_bundle(
        bundle, accept_all, accept_all, verify_witness_cids=True, cid_backend=backend
    )
    assert result.all_valid() and len(result.event_results) == n_matching > 0
    assert all(blake2b.LAUNCHES.values()) and not any(match.LAUNCHES.values())
    monkeypatch.setenv("IPC_SCAN_FUSED_MATCH", "0")
    unfused = generate_event_proofs_for_range(store, pairs, spec, match_backend=backend)
    assert match.LAUNCHES == {"event_match_mask": 0, "event_match_mask_fp": 1}
    on_cpu = generate_event_proofs_for_range(
        store, pairs, spec, match_backend=get_backend("gpu", device="cpu")
    )
    assert bundle.digest() == unfused.digest() == on_cpu.digest()


def test_entry_points_default_to_the_card(cuda_device):
    store, pairs, n_matching = build_range_world(8, 8, 4, 0.125)
    spec = EventProofSpec("NewTopDownMessage(bytes32,uint256)", "calib-subnet-1", 1001)
    blake2b.reset_launch_counts()
    bundle = generate_event_proofs_for_range(store, pairs, spec)
    result = verify_proof_bundle(bundle, accept_all, accept_all, verify_witness_cids=True)
    assert result.all_valid() and len(result.event_results) == n_matching > 0
    # the witness recompute and the replay's TxMeta recompute, both on the card
    assert blake2b.LAUNCHES["blake2b256_single_block"] == 2


_PURE_64 = """
from ipc_proofs_tpu_torch.backend import get_backend
from ipc_proofs_tpu_torch.backend.native import load_scan_ext
from ipc_proofs_tpu_torch.fixtures import build_range_world
from ipc_proofs_tpu_torch.proofs.generator import EventProofSpec
from ipc_proofs_tpu_torch.proofs.range import generate_event_proofs_for_range

assert load_scan_ext() is None
store, pairs, _ = build_range_world(64, 16, 4, 0.01)
spec = EventProofSpec("NewTopDownMessage(bytes32,uint256)", "calib-subnet-1", 1001)
print(generate_event_proofs_for_range(store, pairs, spec).to_json())
"""


def test_native_event_path_on_card_equals_pure_python(cuda_device):
    """64 pairs through the native branches on the card, held byte for byte
    against the pure-Python universe's bundle (a child process with
    ``IPC_PROOFS_NO_NATIVE=1``, also on the card)."""
    assert load_scan_ext() is not None
    store, pairs, n_matching = build_range_world(64, 16, 4, 0.01)
    spec = EventProofSpec("NewTopDownMessage(bytes32,uint256)", "calib-subnet-1", 1001)
    bundle = generate_event_proofs_for_range(store, pairs, spec)
    result = verify_proof_bundle(bundle, accept_all, accept_all, verify_witness_cids=True)
    assert result.all_valid() and len(result.event_results) == n_matching > 0
    env = dict(os.environ, PYTHONPATH=str(ROOT), IPC_PROOFS_NO_NATIVE="1")
    proc = subprocess.run(
        [sys.executable, "-c", _PURE_64], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == bundle.to_json()


def _keccak_cases(messages):
    blo, bhi, _ = pack.pack_single_block_keccak([m for m in messages if len(m) < 136])
    blocks, n_blocks = pack.pad_keccak(messages)
    n_blocks[:3] = (0, -1, blocks.shape[1] + 2)  # masked rows: zero state, capped at B
    return [
        ("keccak256_single_block", (_t(blo), _t(bhi))),
        ("keccak256_blocks", (_t(blocks), _t(n_blocks))),
    ]


@pytest.mark.parametrize("seed", [0, 1])
def test_each_keccak_kernel_equals_plain_and_counts_once(cuda_device, seed):
    rng = np.random.default_rng(seed)
    messages = _messages(KECCAK_LENGTHS * 4 + rng.integers(0, 600, 500).tolist(), seed=seed)
    for name, args in _keccak_cases(messages):
        keccak.reset_launch_counts()
        out = getattr(keccak, name)(*(a.to(cuda_device) for a in args))
        torch.cuda.synchronize()
        assert torch.equal(out.cpu(), getattr(keccak, name + "_plain")(*args))
        assert keccak.LAUNCHES[name] == 1
        assert sum(keccak.LAUNCHES.values()) == 1


def test_keccak_backend_split_on_card(cuda_device):
    messages = _messages(KECCAK_LENGTHS * 5, seed=3)
    keccak.reset_launch_counts()
    assert get_backend("gpu").keccak256_batch(messages) == [keccak256(m) for m in messages]
    assert keccak.LAUNCHES == {"keccak256_single_block": 1, "keccak256_blocks": 1}


def test_small_storage_path_on_card(cuda_device):
    storage = {calculate_storage_slot("subnet-0", i): bytes([i + 1]) for i in range(32)}
    world = build_chain([ContractFixture(1001, storage=storage)], [], n_filler_actors=8)
    specs = [MappingSlotSpec(1001, "subnet-0", i) for i in range(33)]
    keccak.reset_launch_counts()
    blake2b.reset_launch_counts()
    bundle = generate_storage_proofs_batch(world.store, world.parent, world.child, specs)
    result = verify_proof_bundle(bundle, accept_all, accept_all, verify_witness_cids=True)
    assert result.all_valid() and len(result.storage_results) == 33
    assert [int(p.value, 16) for p in bundle.storage_proofs] == list(range(1, 33)) + [0]
    assert keccak.LAUNCHES["keccak256_single_block"] == 1
    assert sum(blake2b.LAUNCHES.values()) > 0
    on_cpu = generate_storage_proofs_batch(
        world.store, world.parent, world.child, specs,
        hash_backend=get_backend("gpu", device="cpu"),
    )
    assert bundle.digest() == on_cpu.digest()


class _RecordingBackend(GpuBackend):
    """The card's backend, recording every blake2b batch with the digests
    its kernels returned (thread-safe: verify workers call it at once)."""

    def __init__(self):
        super().__init__("cuda")
        self._lock = threading.Lock()
        self.batches: list = []

    def blake2b256_batch(self, messages):
        digests = super().blake2b256_batch(messages)
        with self._lock:
            self.batches.append((list(messages), digests))
        return digests


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_overlapped_driver_on_card_with_verify_workers(cuda_device, monkeypatch, fused):
    """The overlapped driver on the card: 4 verify workers give the bytes
    and verdicts 1 worker gives (and the plain versions on the CPU give),
    and every blake2b batch its kernels computed equals the plain versions
    on the same messages."""
    if not fused:
        monkeypatch.setenv("IPC_SCAN_FUSED_MATCH", "0")
    store, pairs, n_matching = build_range_world(48, 8, 4, 0.125)
    spec = EventProofSpec("NewTopDownMessage(bytes32,uint256)", "calib-subnet-1", 1001)
    plain = get_backend("gpu", device="cpu")
    expected = generate_event_proofs_for_range_chunked(
        store, pairs, spec, chunk_size=8, match_backend=plain
    ).to_json()
    runs = []
    for verify_workers in (1, 4):
        backend = _RecordingBackend()
        blake2b.reset_launch_counts()
        _reset_match_counts()
        merged, verdicts = generate_and_verify_range_overlapped(
            store, pairs, spec, chunk_size=8, match_backend=backend, scan_threads=4,
            verify_workers=verify_workers, force_pipeline=True,
            verify_chunk=lambda b, backend=backend: verify_proof_bundle(
                b, accept_all, accept_all, verify_witness_cids=True, cid_backend=backend
            ).event_results,
        )
        torch.cuda.synchronize()
        assert merged.to_json() == expected
        assert len(verdicts) == 6 and all(all(v) for v in verdicts)
        assert sum(map(len, verdicts)) == n_matching > 0
        for messages, digests in backend.batches:
            assert digests == plain.blake2b256_batch(messages)
        assert all(blake2b.LAUNCHES.values())
        assert (match.LAUNCHES["event_match_mask_fp"] > 0) == (not fused)
        runs.append((merged.to_json(), verdicts))
    assert runs[0] == runs[1]


def test_verify_lane_on_card_equals_hashlib(cuda_device, monkeypatch, tmp_path):
    """`verify_blocks_batch` on the card (device lane forced): every family
    and size, flipped variants included, against the host verdicts of
    hashlib / `core.hashes.keccak256`; one call per multihash family and
    every blake2b and keccak kernel launched. Then the cold read stack over
    the hermetic node gives the in-memory bundle."""
    from ipc_proofs_tpu_torch.core.cid import BLAKE2B_256, CID, DAG_CBOR, IDENTITY, KECCAK_256, SHA2_256
    from ipc_proofs_tpu_torch.ops.verify import verify_blocks_batch
    from ipc_proofs_tpu_torch.store import FetchPlane, LocalLotusSession, LotusClient, PlaneBlockstore
    from ipc_proofs_tpu_torch.store.rpc import verify_block_bytes
    from ipc_proofs_tpu_torch.storex import SegmentStore, TieredBlockstore
    from ipc_proofs_tpu_torch.utils.metrics import Metrics

    monkeypatch.setenv("IPC_VERIFY_MIN_BYTES", "0")
    cids, blocks = [], []
    for code in (BLAKE2B_256, SHA2_256, KECCAK_256, IDENTITY, 0x15):
        for data in _messages(LENGTHS + KECCAK_LENGTHS, seed=code & 0xFF):
            if code == KECCAK_256:
                cid = CID(1, DAG_CBOR, KECCAK_256, keccak256(data))
            elif code == 0x15:
                cid = CID(1, DAG_CBOR, 0x15, b"\x00" * 32)
            else:
                cid = CID.hash_of(data, mh_code=code)
            cids.append(cid)
            blocks.append(data)
            if data:
                cids.append(cid)
                blocks.append(bytes([data[0] ^ 1]) + data[1:])
    backend = get_backend("gpu")
    blake2b.reset_launch_counts()
    keccak.reset_launch_counts()
    m = Metrics()
    got = verify_blocks_batch(cids, blocks, metrics=m, backend=backend)
    torch.cuda.synchronize()
    assert got == [verify_block_bytes(c, b) for c, b in zip(cids, blocks)]
    assert m.counter_value("verify.device_calls") == 2
    assert all(blake2b.LAUNCHES[name] == 1 for name in blake2b.LAUNCHES)
    assert all(keccak.LAUNCHES[name] == 1 for name in keccak.LAUNCHES)

    store, pairs, _ = build_range_world(16, 8, 4, 0.125)
    spec = EventProofSpec("NewTopDownMessage(bytes32,uint256)", "calib-subnet-1", 1001)
    want = generate_event_proofs_for_range(store, pairs, spec, match_backend=backend).to_json()
    metrics = Metrics()
    plane = FetchPlane(LotusClient("http://node", session=LocalLotusSession(store), metrics=metrics),
                       backend=backend, metrics=metrics)
    disk = SegmentStore(str(tmp_path), backend=backend, metrics=metrics)
    tier = TieredBlockstore(PlaneBlockstore(plane), disk, metrics=metrics)
    plane.set_local(tier)
    try:
        got_bundle = generate_event_proofs_for_range_chunked(
            tier, pairs, spec, chunk_size=4, match_backend=backend, metrics=metrics
        )
    finally:
        plane.close()
        disk.close()
    assert got_bundle.to_json() == want
    assert metrics.counter_value("verify.device_blocks") > 0
