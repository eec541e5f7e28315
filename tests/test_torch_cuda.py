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
from ipc_proofs_tpu_torch.proofs.trust import TrustPolicy
from ipc_proofs_tpu_torch.proofs.verifier import verify_proof_bundle
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


@pytest.mark.parametrize("lanes", [None, 1, 4], ids=["by-rows", "one-lane", "four-lanes"])
@pytest.mark.parametrize("rows", ["few", "at-crossover", "past-crossover", "many"])
def test_blocks_kernel_on_each_lane_count_equals_plain_and_hashlib(cuda_device, rows, lanes):
    """The multi-block kernel on both sides of its four-lane crossover
    (``QUAD_ROWS_MAX`` rows), with the wrapper's lanes and each forced:
    equal to its plain version and to hashlib, one launch a call."""
    most = blake2b.QUAD_ROWS_MAX
    n = {"few": 300, "at-crossover": most, "past-crossover": most + 1, "many": 40_000}[rows]
    rng = np.random.default_rng(n)
    messages = _messages(rng.integers(257, 700, n).tolist(), seed=n)
    blocks, n_blocks, lengths = pack.pad_blake2b(messages)
    args = [_t(blocks), _t(n_blocks), _t(lengths)]
    blake2b.reset_launch_counts()
    out = blake2b.blake2b256_blocks_on_lanes(*(a.to(cuda_device) for a in args), lanes)
    torch.cuda.synchronize()
    assert blake2b.LAUNCHES["blake2b256_blocks"] == 1
    assert torch.equal(out.cpu(), blake2b.blake2b256_blocks_plain(*args))
    assert pack.digests_to_bytes(out.cpu().numpy()) == [hashlib.blake2b(m, digest_size=32).digest() for m in messages]


SPLIT_KERNELS = {
    # name: (packer, message lengths at its block edges, crossover constant)
    "blake2b256_single_block": (pack.pack_single_block_blake2b, (0, 1, 127, 128), "SINGLE_BLOCK_QUAD_ROWS_MAX"),
    "blake2b256_two_block": (pack.pack_two_block_blake2b, (0, 128, 129, 255, 256), "TWO_BLOCK_QUAD_ROWS_MAX"),
}


@pytest.mark.parametrize("lanes", [None, 1, 4], ids=["by-rows", "one-lane", "four-lanes"])
@pytest.mark.parametrize("rows", ["1", "31", "33", "2048", "at-crossover", "past-crossover"])
@pytest.mark.parametrize("name", list(SPLIT_KERNELS), ids=["single", "two"])
def test_split_kernels_on_each_lane_count_equal_plain_and_hashlib(cuda_device, name, rows, lanes):
    """The single- and two-block kernels with the wrapper's lanes and each
    forced, at row counts that are not a multiple of a block's 32 quads
    and on both sides of the crossover, every row at a block edge (a
    two-block warp runs rows of one block beside rows of two): equal to
    the plain version and to hashlib, one launch a call."""
    packer, edges, crossover = SPLIT_KERNELS[name]
    most = getattr(blake2b, crossover)
    n = {"at-crossover": most, "past-crossover": most + 1}.get(rows) or int(rows)
    messages = _messages([edges[i % len(edges)] for i in range(n)], seed=n)
    m_lo, m_hi, lengths, _ = packer(messages)
    args = [_t(m_lo[:n]), _t(m_hi[:n]), _t(lengths[:n])]
    blake2b.reset_launch_counts()
    out = getattr(blake2b, name + "_on_lanes")(*(a.to(cuda_device) for a in args), lanes)
    torch.cuda.synchronize()
    assert blake2b.LAUNCHES[name] == 1 and sum(blake2b.LAUNCHES.values()) == 1
    assert torch.equal(out.cpu(), getattr(blake2b, name + "_plain")(*args))
    assert pack.digests_to_bytes(out.cpu().numpy()) == [hashlib.blake2b(m, digest_size=32).digest() for m in messages]


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
        bundle, TrustPolicy.accept_all(), verify_witness_cids=True, cid_backend=backend
    )
    assert result.all_valid() and len(result.event_results) == n_matching > 0
    assert all(blake2b.LAUNCHES.values()) and not any(match.LAUNCHES.values())
    monkeypatch.setenv("IPC_SCAN_FUSED_MATCH", "0")
    unfused = generate_event_proofs_for_range(store, pairs, spec, match_backend=backend)
    assert match.LAUNCHES == {
        "event_match_mask": 0,
        "event_match_mask_sharded": 0,
        "event_match_mask_fp": 1,
        "event_match_mask_fp_sharded": 0,
        "receipts_with_match": 0,
    }
    on_cpu = generate_event_proofs_for_range(
        store, pairs, spec, match_backend=get_backend("gpu", device="cpu")
    )
    assert bundle.digest() == unfused.digest() == on_cpu.digest()


def test_entry_points_default_to_the_card(cuda_device):
    store, pairs, n_matching = build_range_world(8, 8, 4, 0.125)
    spec = EventProofSpec("NewTopDownMessage(bytes32,uint256)", "calib-subnet-1", 1001)
    blake2b.reset_launch_counts()
    bundle = generate_event_proofs_for_range(store, pairs, spec)
    result = verify_proof_bundle(bundle, TrustPolicy.accept_all(), verify_witness_cids=True)
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
    result = verify_proof_bundle(bundle, TrustPolicy.accept_all(), verify_witness_cids=True)
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
    result = verify_proof_bundle(bundle, TrustPolicy.accept_all(), verify_witness_cids=True)
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
                b, TrustPolicy.accept_all(), verify_witness_cids=True, cid_backend=backend
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
    # one per kernel launch: every blake2b and keccak kernel launched once
    launched = sum(blake2b.LAUNCHES.values()) + sum(keccak.LAUNCHES.values())
    assert m.counter_value("verify.device_calls") == launched == 5
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


# --- the device mesh on the card -------------------------------------------------


def _virtual_mesh(cuda_device, n=4, sp=2):
    from ipc_proofs_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(n, sp=sp, devices=[cuda_device] * n)


@pytest.mark.parametrize("actor", [None, 1001], ids=["no-filter", "actor"])
def test_sharded_pipeline_on_a_virtual_mesh_equals_cpu(cuda_device, actor):
    """The sharded match over ``[cuda] * 4`` (dp=2, sp=2) and the
    single-device match on the card equal the plain run on the CPU; each
    block is one evaluation on the card."""
    from ipc_proofs_tpu_torch.parallel import pipeline
    from ipc_proofs_tpu_torch.state.events import ascii_to_bytes32, hash_event_signature

    t0, t1 = hash_event_signature("NewTopDownMessage(bytes32,uint256)"), ascii_to_bytes32("calib-subnet-1")
    batch = pipeline.synthetic_event_batch(16, 8, 4, t0, t1, emitter=1001, match_rate=0.2, seed=5)
    want = pipeline.match_pipeline(*pipeline.batch_args(batch, t0, t1, actor, "cpu"))
    pipeline.LAUNCHES["match_pipeline"] = 0
    single = pipeline.match_pipeline(*pipeline.batch_args(batch, t0, t1, actor, cuda_device))
    fn, shard_batch = pipeline.sharded_match_pipeline(_virtual_mesh(cuda_device))
    sharded = fn(*shard_batch(batch, t0, t1, actor))
    torch.cuda.synchronize()
    for got in (single, sharded):
        assert all(x.device.type == "cuda" for x in got)
        assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
        assert int(got[2]) == int(want[2]) > 0
    assert pipeline.LAUNCHES["match_pipeline"] == 5


def test_sharded_fp_mask_on_a_virtual_mesh_equals_cpu(cuda_device):
    from ipc_proofs_tpu_torch.backend.gpu import GpuBackend
    from ipc_proofs_tpu_torch.proofs.scan_native import topic_fingerprint

    rng = np.random.default_rng(8)
    n = 1000
    t0, t1 = b"\x11" * 32, b"\x22" * 32
    fp = rng.integers(0, 1 << 63, size=n, dtype=np.uint64)
    fp[rng.random(n) < 0.2] = np.uint64(topic_fingerprint(t0, t1))
    n_topics = rng.integers(1, 4, n).astype(np.int32)
    emitters = rng.integers(1000, 1003, n).astype(np.int64)
    valid = rng.random(n) < 0.9
    _reset_match_counts()
    meshed = GpuBackend(mesh=_virtual_mesh(cuda_device))
    got = meshed.event_match_mask_fp(fp, n_topics, emitters, valid, t0, t1, 1001)
    want = get_backend("gpu", device="cpu").event_match_mask_fp(fp, n_topics, emitters, valid, t0, t1, 1001)
    assert len(got) == 1024 and not got[n:].any()
    np.testing.assert_array_equal(got[:n], want)
    assert want.any()
    assert match.LAUNCHES["event_match_mask_fp_sharded"] == 4


def test_sharded_flat_mask_on_a_virtual_mesh_equals_cpu(cuda_device):
    from ipc_proofs_tpu_torch.backend.gpu import GpuBackend

    rng = np.random.default_rng(11)
    n = 1001
    t0, t1 = b"\x11" * 32, b"\x22" * 32
    topics = rng.integers(0, 1 << 32, (n, 2, 8), dtype=np.uint64).astype(np.uint32)
    planted = rng.random(n) < 0.2
    topics[planted, 0] = np.frombuffer(t0, "<u4")
    topics[planted, 1] = np.frombuffer(t1, "<u4")
    n_topics = rng.integers(1, 4, n).astype(np.int32)
    emitters = rng.integers(1000, 1003, n).astype(np.int64)
    valid = rng.random(n) < 0.9
    _reset_match_counts()
    got = GpuBackend(mesh=_virtual_mesh(cuda_device)).event_match_mask_flat(
        topics, n_topics, emitters, valid, t0, t1, 1001
    )
    want = get_backend("gpu", device="cpu").event_match_mask_flat(topics, n_topics, emitters, valid, t0, t1, 1001)
    assert got.shape == (n,)
    np.testing.assert_array_equal(got, want)
    assert want.any()
    assert match.LAUNCHES["event_match_mask_sharded"] == 4 and match.LAUNCHES["event_match_mask"] == 0


def test_graph_replays_advance_the_pass_index(cuda_device):
    """On the card the pass is one CUDA graph: each replay sees the next
    ``i`` (the warm pass 0, then 1..k) and adds to the one accumulator."""
    from ipc_proofs_tpu_torch.utils.timing import _graph_runner

    x = torch.zeros(1024, dtype=torch.int32, device=cuda_device)
    run = _graph_runner(lambda i, v: (v + i).amax(), (x,), cuda_device)
    assert run(3) == 0 + 1 + 2 + 3
    assert run(2) == 6 + 4 + 5


def test_cid_bench_and_slope_timing_on_the_card(cuda_device):
    from ipc_proofs_tpu_torch.ops.cid_bench import blake2b_cid_bench_setup
    from ipc_proofs_tpu_torch.utils.timing import measure_pass_seconds

    messages = _messages([200] * 4096, seed=9)
    blake2b.reset_launch_counts()
    one_pass, args, first, name = blake2b_cid_bench_setup(messages)
    assert name == "blake2b256_two_block" and blake2b.LAUNCHES[name] == 1
    assert [row.astype("<u4").tobytes() for row in first] == [
        hashlib.blake2b(m, digest_size=32).digest() for m in messages
    ]
    pt = measure_pass_seconds(one_pass, args, k_small=2, k_large=12, repeats=2)
    assert pt.seconds > 0 and pt.k_large >= 12 and pt.graph


def test_dryrun_multichip_on_a_virtual_mesh(cuda_device):
    from ipc_proofs_tpu_torch.entry import dryrun_multichip

    blake2b.reset_launch_counts()
    _reset_match_counts()
    out = dryrun_multichip(4, devices=[cuda_device] * 4)
    assert out["mesh"] == {"dp": 2, "sp": 2} and out["event_proofs"] > 0
    # leg 2: one multi-block launch per mesh device
    assert blake2b.LAUNCHES["blake2b256_blocks"] >= 4
    assert match.LAUNCHES["event_match_mask_fp_sharded"] > 0


# --- csrc/match.cu's four kernels at the edge shapes ---------------------------------


def _match_world(t, r, e, seed, actor_rows=0.8):
    """A [T, R, E] match world: about a third of the events carry the spec
    topics (some with one word flipped), n_topics 0..3, a tenth invalid,
    two emitters."""
    from ipc_proofs_tpu_torch.parallel.pipeline import EventBatch

    rng = np.random.default_rng(seed)
    spec = rng.integers(0, 1 << 32, 16, dtype=np.uint64).astype(np.uint32)
    shape = (t, r, e)
    topics = rng.integers(0, 1 << 32, (*shape, 2, 8), dtype=np.uint64).astype(np.uint32)
    planted = rng.random(shape) < 0.35
    topics[planted] = spec.reshape(2, 8)
    topics[planted & (rng.random(shape) < 0.2), 1, 5] ^= 1
    batch = EventBatch(
        topics=topics,
        n_topics=rng.integers(0, 4, shape).astype(np.int32),
        emitters=np.where(rng.random(shape) < actor_rows, 1001, 1002).astype(np.int32),
        valid=rng.random(shape) < 0.9,
    )
    return batch, spec[:8].tobytes(), spec[8:].tobytes()


@pytest.mark.parametrize("shape", [(3, 77, 1), (5, 41, 3), (2, 9, 33), (7, 3, 300), (1, 1, 4), (0, 4, 4), (2, 3, 0)],
                         ids=["E1", "E3", "E33", "E300", "one-receipt", "no-tipsets", "no-events"])
@pytest.mark.parametrize("actor", [None, 1001], ids=["actor-1", "actor"])
def test_match_pipeline_kernel_equals_plain_at_the_edge_shapes(cuda_device, shape, actor):
    """One launch a call (none for an empty world), results bit-equal to the
    plain version on the same inputs, bool outputs holding only 0 and 1."""
    from ipc_proofs_tpu_torch.parallel import pipeline

    batch, t0, t1 = _match_world(*shape, seed=sum(shape))
    pipeline.reset_launch_counts()
    got = pipeline.match_pipeline(*pipeline.batch_args(batch, t0, t1, actor, cuda_device))
    torch.cuda.synchronize()
    want = pipeline.match_pipeline_plain(*pipeline.batch_args(batch, t0, t1, actor, "cpu"))
    assert pipeline.LAUNCHES["match_pipeline"] == (1 if shape[0] * shape[1] else 0)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g.cpu(), w)
    for g in got[:2]:
        assert int(g.view(torch.uint8).max()) <= 1 if g.numel() else True


@pytest.mark.parametrize("n", [0, 1, 255, 256, 257, 100_003])
def test_flat_mask_kernels_equal_plain(cuda_device, n):
    batch, t0, t1 = _match_world(n, 1, 1, seed=n)
    topics, n_topics, valid = batch.topics.reshape(-1, 2, 8), batch.n_topics.reshape(-1), batch.valid.reshape(-1)
    rng = np.random.default_rng(n)
    fp = rng.integers(-(1 << 63), (1 << 63) - 1, n, dtype=np.int64)
    target = -12345678901234
    fp[rng.random(n) < 0.3] = target
    _reset_match_counts()
    on_card = (
        match._topic_mask(topics, n_topics, valid, t0, t1, cuda_device),
        match._fp_mask(fp, valid, target, cuda_device),
    )
    torch.cuda.synchronize()
    on_cpu = (
        match._topic_mask(topics, n_topics, valid, t0, t1, torch.device("cpu")),
        match._fp_mask(fp, valid, target, torch.device("cpu")),
    )
    for g, w in zip(on_card, on_cpu):
        assert g.dtype == torch.bool and torch.equal(g.cpu(), w)
    assert n < 256 or all(w.any() for w in on_cpu)
    launched = 1 if n else 0
    assert match.LAUNCHES["event_match_mask"] == match.LAUNCHES["event_match_mask_fp"] == launched


# row counts that are not multiples of 2, 4 or 8, around the thread-block
# edges
MASK_ROWS = [1, 3, 5, 255, 257, 1025, 65_537]


def _topic0_share(topics, spec0: bytes, share: str):
    """``topics`` with topic0 equal to the spec on no row ("none"), on every
    row ("all": topic1 stays as it was, matching or one word off or not) or
    as planted ("planted")."""
    topics = topics.copy()
    words = np.frombuffer(spec0, "<u4")
    if share == "none":
        hit = (topics[:, 0] == words).all(axis=-1)
        topics[hit, 0, 0] ^= 1
    elif share == "all":
        topics[:, 0] = words
    return topics


@pytest.mark.parametrize("share", ["none", "planted", "all"])
@pytest.mark.parametrize("n", MASK_ROWS)
def test_flat_masks_equal_plain_over_topic0_shares(cuda_device, n, share):
    """The full-word and fingerprint masks at row counts around the block
    edges, with topic0 (and the fingerprint) matching on no row, on
    the planted rows and on every row: bit-equal to their plain versions,
    one launch each."""
    batch, t0, t1 = _match_world(n, 1, 1, seed=n)
    topics = _topic0_share(batch.topics.reshape(-1, 2, 8), t0, share)
    n_topics, valid = batch.n_topics.reshape(-1), batch.valid.reshape(-1)
    rng = np.random.default_rng(n)
    target = -12345678901234
    fp = rng.integers(-(1 << 63), (1 << 63) - 1, n, dtype=np.int64)
    fp[rng.random(n) < {"none": 0.0, "planted": 0.3, "all": 1.0}[share]] = target
    _reset_match_counts()
    on_card = (
        match._topic_mask(topics, n_topics, valid, t0, t1, cuda_device),
        match._fp_mask(fp, valid, target, cuda_device),
    )
    torch.cuda.synchronize()
    on_cpu = (
        match._topic_mask(topics, n_topics, valid, t0, t1, torch.device("cpu")),
        match._fp_mask(fp, valid, target, torch.device("cpu")),
    )
    for g, w in zip(on_card, on_cpu):
        assert g.dtype == torch.bool and torch.equal(g.cpu(), w)
        assert int(g.view(torch.uint8).max()) <= 1
    assert match.LAUNCHES["event_match_mask"] == match.LAUNCHES["event_match_mask_fp"] == 1
    if share == "none":
        assert not on_cpu[0].any() and not on_cpu[1].any()


@pytest.mark.parametrize("n", [n + 1 for n in MASK_ROWS])
def test_fp_mask_kernel_on_an_offset_view(cuda_device, n):
    """``f[1:]`` of an int64 tensor on the card is 8-byte aligned only: the
    kernel takes it and equals the plain version; so does a view of
    ``valid`` one byte in."""
    rng = np.random.default_rng(n)
    target = 987654321
    fp = rng.integers(-(1 << 63), (1 << 63) - 1, n, dtype=np.int64)
    fp[rng.random(n) < 0.4] = target
    valid = rng.random(n) < 0.9
    f = torch.from_numpy(fp).to(cuda_device)[1:]
    ok = torch.from_numpy(valid).to(cuda_device)[1:]
    assert f.data_ptr() % 16 == 8
    _reset_match_counts()
    got = match.fp_mask(f, ok, target)
    torch.cuda.synchronize()
    want = match.fp_mask_plain(f.cpu(), ok.cpu(), target)
    assert got.shape == (n - 1,) and torch.equal(got.cpu(), want)
    assert match.LAUNCHES["event_match_mask_fp"] == 1


@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64], ids=["int32", "int64"])
@pytest.mark.parametrize("n,num", [(0, 4), (5, 0), (10, 40), (1000, 40), (100_003, 4099)])
def test_receipts_kernel_wraps_and_drops_as_plain(cuda_device, id_dtype, n, num):
    rng = np.random.default_rng(n + num)
    mask = torch.from_numpy(rng.random(n) < 0.3)
    ids = torch.from_numpy(rng.integers(-2 * max(num, 1), 2 * max(num, 1), n)).to(id_dtype)
    _reset_match_counts()
    got = match.receipts_with_match(mask.to(cuda_device), ids.to(cuda_device), num)
    torch.cuda.synchronize()
    want = match.receipts_with_match_plain(mask, ids, num)
    assert got.shape == (num,) and torch.equal(got.cpu(), want)
    assert match.LAUNCHES["receipts_with_match"] == (1 if n and num else 0)
    if n > 100:
        assert want.any() and not want.all()


def _match_case(batch, t0, t1, actor, cuda_device):
    from ipc_proofs_tpu_torch.parallel import pipeline

    return (pipeline.batch_args(batch, t0, t1, actor, cuda_device),
            pipeline.match_pipeline_plain(*pipeline.batch_args(batch, t0, t1, actor, "cpu")))


def _same(got, want):
    return all(g.dtype == w.dtype and torch.equal(g.cpu(), w) for g, w in zip(got, want))


def test_match_pipeline_count_is_right_call_after_call(cuda_device):
    """Back-to-back calls, many matches then none then many again, and
    grids of one block and of hundreds, with no sync between them: each
    count is the plain version's (each call's count starts from its own
    zero)."""
    from ipc_proofs_tpu_torch.parallel import pipeline

    many, t0, t1 = _match_world(256, 16, 4, seed=21)
    none = pipeline.EventBatch(topics=many.topics, n_topics=many.n_topics, emitters=many.emitters,
                               valid=np.zeros_like(many.valid))
    small, _, _ = _match_world(1, 4, 4, seed=22)
    small.topics[..., 0, :] = np.frombuffer(t0, "<u4")
    small.topics[..., 1, :] = np.frombuffer(t1, "<u4")
    cases = [_match_case(b, t0, t1, 1001, cuda_device) for b in (many, none, small, many, small, none)]
    outs = [pipeline.match_pipeline(*args) for args, _ in cases]  # no sync in between
    torch.cuda.synchronize()
    for got, (_, want) in zip(outs, cases):
        assert _same(got, want)
    assert [int(want[2]) > 0 for _, want in cases] == [True, False, True, True, True, False]


def test_match_pipeline_on_a_stream_of_its_own(cuda_device):
    """Calls on a second stream, beside calls on the default one, give
    the plain version's results: a call's memset and kernel run on the
    caller's stream."""
    from ipc_proofs_tpu_torch.parallel import pipeline

    batch, t0, t1 = _match_world(128, 16, 4, seed=23)
    args, want = _match_case(batch, t0, t1, None, cuda_device)
    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream(cuda_device))
    with torch.cuda.stream(side):
        on_side = [pipeline.match_pipeline(*args) for _ in range(3)]
    on_default = [pipeline.match_pipeline(*args) for _ in range(3)]
    torch.cuda.synchronize()
    for got in on_side + on_default:
        assert _same(got, want)
    assert int(want[2]) > 0


def test_match_pipeline_count_is_right_over_graph_replays(cuda_device):
    """One call captured as a CUDA graph: every replay gives the plain
    version's mask, hits and count, and eager calls after it still do."""
    from ipc_proofs_tpu_torch.parallel import pipeline

    batch, t0, t1 = _match_world(64, 16, 4, seed=24)
    args, want = _match_case(batch, t0, t1, 1001, cuda_device)
    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream(cuda_device))
    with torch.cuda.stream(side):
        pipeline.match_pipeline(*args)
    torch.cuda.current_stream(cuda_device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = pipeline.match_pipeline(*args)
    for _ in range(5):
        graph.replay()
        torch.cuda.synchronize()
        assert _same(captured, want)
    assert _same(pipeline.match_pipeline(*args), want)


@pytest.mark.parametrize("actor", [None, 1001], ids=["no-filter", "actor"])
def test_virtual_mesh_blocks_write_into_the_mesh_outputs(cuda_device, monkeypatch, actor):
    """On the virtual (dp=2, sp=2) mesh each block's kernel writes its
    slice, hits and count into the mesh's outputs: one launch a block,
    no ``torch.cat`` or ``torch.stack``, the plain version's results; and
    repeated calls keep giving them."""
    from ipc_proofs_tpu_torch.parallel import pipeline

    batch, t0, t1 = _match_world(16, 8, 6, seed=25)
    want = pipeline.match_pipeline_plain(*pipeline.batch_args(batch, t0, t1, actor, "cpu"))
    fn, shard_batch = pipeline.sharded_match_pipeline(_virtual_mesh(cuda_device))
    args = shard_batch(batch, t0, t1, actor)

    def refuse(*a, **k):
        raise AssertionError("the combine ran torch.cat or torch.stack")

    pipeline.reset_launch_counts()
    monkeypatch.setattr(torch, "cat", refuse)
    monkeypatch.setattr(torch, "stack", refuse)
    outs = [fn(*args) for _ in range(3)]
    monkeypatch.undo()
    torch.cuda.synchronize()
    assert pipeline.LAUNCHES["match_pipeline"] == 12
    for got in outs:
        assert _same(got, want)
    assert int(want[2]) > 0


def test_match_pipeline_replays_as_a_cuda_graph(cuda_device):
    """The kernel reads its spec words and actor on the card, so one pass
    captures as a CUDA graph and every replay launches it."""
    from ipc_proofs_tpu_torch.parallel import pipeline
    from ipc_proofs_tpu_torch.utils.timing import measure_pass_seconds

    batch, t0, t1 = _match_world(64, 16, 4, seed=3)
    args = pipeline.batch_args(batch, t0, t1, 1001, cuda_device)

    def body(i, topics, n_topics, emitters, valid, topic0, topic1, actor_id):
        return pipeline.match_pipeline(topics, n_topics, emitters, valid, topic0 ^ i, topic1, actor_id)[2]

    pipeline.reset_launch_counts()
    pt = measure_pass_seconds(body, args, k_small=2, k_large=12, repeats=2)
    assert pt.graph and pt.seconds > 0
    # captured launches count once each (the replays run inside the graph)
    assert pipeline.LAUNCHES["match_pipeline"] >= 1


def _chain_node(store, pairs):
    """A hermetic node answering the chain head and every height's tipset."""
    from ipc_proofs_tpu_torch.store import LocalLotusSession

    by_height = {p.parent.height: p.parent for p in pairs}
    by_height.update({p.child.height: p.child for p in pairs})

    def tipset_json(ts):
        return {"Cids": [{"/": str(c)} for c in ts.cids], "Height": ts.height, "Blocks": [
            {"Parents": [{"/": str(p)} for p in h.parents], "Height": h.height, "Timestamp": h.timestamp,
             "ParentStateRoot": {"/": str(h.parent_state_root)}, "Messages": {"/": str(h.messages)},
             "ParentMessageReceipts": {"/": str(h.parent_message_receipts)}} for h in ts.blocks]}

    def session():
        return LocalLotusSession(store, {
            "Filecoin.ChainHead": {"Height": max(by_height)},
            "Filecoin.ChainGetTipSetByHeight": lambda params: tipset_json(by_height[params[0]]),
        })

    return session, min(by_height), max(by_height)


class _Tier(dict):
    put_local = dict.__setitem__
    has_local = dict.__contains__
    get_local = dict.get


def test_follower_waves_on_card_equal_the_plain_versions(cuda_device, monkeypatch):
    """The follower's prefetch waves verify on the card's blake2b kernels:
    the same blocks land as with the CPU plain versions, and the kernels
    launched."""
    from ipc_proofs_tpu_torch.store import LotusClient
    from ipc_proofs_tpu_torch.storex import ChainFollower
    from ipc_proofs_tpu_torch.utils.metrics import Metrics

    monkeypatch.setenv("IPC_VERIFY_MIN_BYTES", "0")
    store, pairs, _ = build_range_world(6, 8, 2, 0.25)
    session, lo, hi = _chain_node(store, pairs)
    tiers = {}
    for name, backend in (("card", get_backend("gpu")), ("plain", get_backend("gpu", device="cpu"))):
        blake2b.reset_launch_counts()
        m, tier = Metrics(), _Tier()
        follower = ChainFollower(LotusClient("http://node", session=session(), metrics=m), tier, metrics=m,
                                 lag=0, start_height=lo, max_tipsets_per_poll=64, backend=backend)
        assert follower.poll_once() == hi - lo + 1
        assert m.counter_value("follow.errors") == 0
        tiers[name] = (dict(tier), sum(blake2b.LAUNCHES.values()))
    assert tiers["card"][0] == tiers["plain"][0]
    assert tiers["card"][1] > 0 and tiers["plain"][1] == 0


def test_pool_waves_on_card_equal_the_plain_versions(cuda_device, monkeypatch):
    """A pool behind the fetch plane verifies its batch reads on the card:
    the bundle equals the in-memory one and the plain-version run's, and a
    lying endpoint is demoted by the card's verdicts."""
    import base64
    import json

    from ipc_proofs_tpu_torch.store import EndpointPool, FetchPlane, LotusClient, PlaneBlockstore
    from ipc_proofs_tpu_torch.proofs.range import generate_event_proofs_for_range_pipelined
    from ipc_proofs_tpu_torch.utils.metrics import Metrics

    monkeypatch.setenv("IPC_VERIFY_MIN_BYTES", "0")
    store, pairs, _ = build_range_world(6, 8, 2, 0.25)
    spec = EventProofSpec("NewTopDownMessage(bytes32,uint256)", "calib-subnet-1", 1001)
    session, _, _ = _chain_node(store, pairs)
    want = generate_event_proofs_for_range(store, pairs, spec, match_backend=get_backend("gpu")).to_json()

    class Liar:
        def __init__(self, inner):
            self.inner = inner

        def post(self, url, data=None, headers=None, timeout=None):
            resp = self.inner.post(url, data=data, headers=headers, timeout=timeout)
            body = resp.json()  # the hermetic node's response: edited in place
            for entry in body if isinstance(body, list) else [body]:
                if isinstance(entry.get("result"), str):
                    raw = bytearray(base64.b64decode(entry["result"]))
                    raw[0] ^= 1
                    entry["result"] = base64.b64encode(bytes(raw)).decode()
            return resp

    for name, backend in (("card", get_backend("gpu")), ("plain", get_backend("gpu", device="cpu"))):
        blake2b.reset_launch_counts()
        m = Metrics()
        pool = EndpointPool([LotusClient("http://liar", session=Liar(session()), metrics=m),
                             LotusClient("http://honest", session=session(), metrics=m)],
                            backend=backend, metrics=m)
        plane = FetchPlane(pool, backend=backend, metrics=m)
        try:
            got = generate_event_proofs_for_range_pipelined(
                PlaneBlockstore(plane), pairs, spec, chunk_size=2, scan_threads=2, match_backend=backend,
                force_pipeline=True,
            ).to_json()
        finally:
            plane.close()
            pool.close()
        assert got == want, name
        assert pool.health()["endpoints"][0]["integrity_demotions"] >= 1
        launches = sum(blake2b.LAUNCHES.values())
        assert (launches > 0) == (name == "card")
    assert json.loads(want)["event_proofs"]


def _serve_chain(n_events=16):
    from ipc_proofs_tpu_torch.fixtures import EventFixture

    sig, subnet = "NewTopDownMessage(bytes32,uint256)", "calib-subnet-1"
    world = build_chain(
        [ContractFixture(1001)],
        [[EventFixture(emitter=1001, signature=sig, topic1=subnet, data=i.to_bytes(32, "big"))]
         for i in range(n_events)],
    )
    from ipc_proofs_tpu_torch.proofs.generator import generate_proof_bundle

    return generate_proof_bundle(
        world.store, world.parent, world.child, [], [EventProofSpec(sig, subnet, 1001)],
        match_backend=get_backend("gpu"),
    )


def _classes_present(blocks):
    from ipc_proofs_tpu_torch.backend.gpu import size_class

    return {size_class(len(b.data)) for b in blocks}


@pytest.mark.parametrize("cids", [False, True], ids=["cids-off", "cids-on"])
def test_service_verify_on_card_equals_cpu(cuda_device, cids):
    """The serve plane's verify micro-batches on the card: the CPU's
    verdicts, and the blake2b kernels launched once per merged batch (the
    TxMeta batch, plus each size class of the merged witness with CIDs on)."""
    from ipc_proofs_tpu_torch.proofs.bundle import UnifiedProofBundle
    from ipc_proofs_tpu_torch.serve import ProofService, ServiceConfig, sequential_verify_baseline

    full = _serve_chain()
    reqs = [UnifiedProofBundle([], [full.event_proofs[i % 16]], full.blocks) for i in range(32)]
    expected = [r.event_results for r in sequential_verify_baseline(reqs, cid_backend=get_backend("gpu", device="cpu"))]
    blake2b.reset_launch_counts()
    got = [None] * len(reqs)
    with ProofService(config=ServiceConfig(max_batch=8, max_wait_ms=50.0, verify_witness_cids=cids)) as svc:
        def client(i):
            got[i] = svc.verify(reqs[i]).event_results

        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(reqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        batches = svc.metrics.counter_value("serve.batches.verify")
    assert got == expected == [[True]] * len(reqs)
    assert 0 < batches < len(reqs)
    want = dict.fromkeys(blake2b.LAUNCHES, 0)
    want["blake2b256_single_block"] = batches  # the TxMeta batch
    if cids:
        for name in _classes_present(full.blocks):
            want[name] += batches
    assert blake2b.LAUNCHES == want


def test_verify_aggregated_on_card_equals_cpu(cuda_device):
    from ipc_proofs_tpu_torch.witness import aggregate_range_bundle, verify_aggregated

    store, pairs, n_matching = build_range_world(8, 8, 4, 0.25)
    spec = EventProofSpec("NewTopDownMessage(bytes32,uint256)", "calib-subnet-1", 1001)
    bundle = generate_event_proofs_for_range(store, pairs, spec)
    idxs = list(range(8))
    agg = aggregate_range_bundle(bundle, pairs, idxs, claim_indexes=[idxs[i % 8] for i in range(64)])
    blake2b.reset_launch_counts()
    card = verify_aggregated(agg, TrustPolicy.accept_all(), verify_witness_cids=True)
    launches = dict(blake2b.LAUNCHES)
    cpu = verify_aggregated(
        agg, TrustPolicy.accept_all(), verify_witness_cids=True, cid_backend=get_backend("gpu", device="cpu")
    )
    assert [(r.storage_results, r.event_results) for r in card] == [
        (r.storage_results, r.event_results) for r in cpu
    ]
    assert len(card) == 64 and all(r.all_valid() for r in card) and n_matching > 0
    # one launch set for all 64 claims: each size class of the witness once,
    # plus the one TxMeta batch
    want = dict.fromkeys(launches, 0)
    for name in _classes_present(bundle.blocks):
        want[name] += 1
    want["blake2b256_single_block"] += 1
    assert launches == want


def test_http_verify_with_cids_launches_one_set_a_batch(cuda_device):
    """`ProofHTTPServer` over a card service with CIDs on: 32 concurrent HTTP
    verify requests get the CPU's verdicts, and the blake2b launches are
    exactly one set per merged batch (`serve.batches.verify`)."""
    import json
    import urllib.request

    from ipc_proofs_tpu_torch.proofs.bundle import UnifiedProofBundle
    from ipc_proofs_tpu_torch.serve import ProofHTTPServer, ProofService, ServiceConfig

    full = _serve_chain()
    reqs = [UnifiedProofBundle([], [full.event_proofs[i % 16]], full.blocks).to_json_obj() for i in range(32)]
    blake2b.reset_launch_counts()
    got = [None] * len(reqs)
    svc = ProofService(config=ServiceConfig(max_batch=8, max_wait_ms=50.0, verify_witness_cids=True))
    httpd = ProofHTTPServer(svc).start()
    try:
        def client(i):
            req = urllib.request.Request(httpd.address + "/v1/verify", data=json.dumps({"bundle": reqs[i]}).encode(),
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as resp:
                got[i] = (resp.status, json.loads(resp.read())["event_results"])

        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(reqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        batches = svc.metrics.counter_value("serve.batches.verify")
    finally:
        httpd.shutdown(timeout=60)
    assert got == [(200, [True])] * len(reqs)
    assert 0 < batches < len(reqs)
    want = dict.fromkeys(blake2b.LAUNCHES, 0)
    want["blake2b256_single_block"] = batches
    for name in _classes_present(full.blocks):
        want[name] += batches
    assert blake2b.LAUNCHES == want


def test_ingested_segments_read_in_one_lane_call_on_card(cuda_device, tmp_path, monkeypatch):
    """A replica's `get_many` over segment files ingested from a peer: one
    `verify_blocks_batch` call, whose kernels run on the card, with the
    plain versions' verdicts (a lying frame rejected)."""
    from ipc_proofs_tpu_torch.backend.gpu import size_class
    from ipc_proofs_tpu_torch.core.cid import CID
    from ipc_proofs_tpu_torch.storex import SegmentStore
    from ipc_proofs_tpu_torch.utils.metrics import Metrics

    monkeypatch.setenv("IPC_VERIFY_MIN_BYTES", "0")
    cpu = get_backend("gpu", device="cpu")
    src = SegmentStore(str(tmp_path / "src"), owner="s0", segment_max_bytes=4096, backend=cpu)
    blocks = [(CID.hash_of(m), m) for m in _messages([100 + (i * 37) % 400 for i in range(64)], seed=5)]
    liar = CID.hash_of(b"honest bytes")
    for cid, data in blocks:
        src.put(cid, data)
    src.put(liar, b"lying bytes")
    files = {s["name"]: Path(src.segment_path(s["name"])).read_bytes() for s in src.segment_files()}
    src.close()
    m = Metrics()
    card = SegmentStore(str(tmp_path / "dst"), owner="s1", metrics=m, backend=get_backend("gpu"))
    try:
        assert sum(card.ingest_segment_file(n, raw) for n, raw in sorted(files.items())) == 65
        blake2b.reset_launch_counts()
        got = card.get_many([cid for cid, _ in blocks] + [liar])
        launches = dict(blake2b.LAUNCHES)
    finally:
        card.close()
    assert got == dict(blocks)
    assert m.counter_value("verify.device_blocks") == 65
    assert m.counter_value("storex.integrity_evictions") == 1
    want = dict.fromkeys(launches, 0)
    for name in {size_class(len(d)) for _, d in blocks + [(liar, b"lying bytes")]}:
        want[name] = 1
    assert launches == want


def test_push_on_card_launches_a_mask_a_generation_and_verifies(cuda_device, tmp_path, monkeypatch):
    """Standing queries on a card service (unfused scan: the mask runs on
    the card): one fingerprint-mask launch per generation (distinct filter
    and pair), the pushed bundles equal the CPU's, and the pushed witness's
    CIDs recomputed by the kernels equal hashlib's."""
    import json as _json
    import random
    import time

    from ipc_proofs_tpu_torch.core.cid import CID
    from ipc_proofs_tpu_torch.proofs.bundle import UnifiedProofBundle
    from ipc_proofs_tpu_torch.serve import ProofService, ServiceConfig
    from ipc_proofs_tpu_torch.subs import StandingQueries

    monkeypatch.setenv("IPC_SCAN_FUSED_MATCH", "0")
    sig, topic = "NewTopDownMessage(bytes32,uint256)", "calib-subnet-1"
    store, pairs, _ = build_range_world(4, 6, 3, 0.5, signature=sig, topic1=topic)
    bodies = []
    svc = ProofService(store=store, spec=EventProofSpec(sig, topic), config=ServiceConfig())
    sq = StandingQueries(str(tmp_path), store=store, metrics=svc.metrics, fsync=False, service=svc, delta=False,
                         opener=lambda url, body, t: bodies.append(_json.loads(body)) or 200,
                         sleep=lambda s: None, rng=random.Random(0))
    try:
        for i, filt in enumerate(({"signature": sig, "topic1": topic},
                                  {"signature": sig, "topic1": topic, "actor_id": 1001})):
            sq.subscribe({"filter": filt, "sub_id": f"w{i}", "target": {"url": f"http://hooks/{i}"}})
        match.LAUNCHES.update(dict.fromkeys(match.LAUNCHES, 0))
        for ts in (pairs[0].parent, pairs[0].child):
            sq.on_tipset(ts)
        torch.cuda.synchronize()
        launches = dict(match.LAUNCHES)
        deadline = time.monotonic() + 60
        while len(bodies) < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        sq.drain()
        svc.drain()
    assert launches["event_match_mask_fp"] == 2  # two filters, one pair
    cpu = get_backend("gpu", device="cpu")
    for env in bodies:
        filt = EventProofSpec(sig, topic, 1001 if env["sub_id"] == "w1" else None)
        want = generate_event_proofs_for_range_chunked(store, [pairs[0]], filt, chunk_size=8, match_backend=cpu)
        assert env["bundle"] == want.to_json_obj()
        bundle = UnifiedProofBundle.from_json_obj(env["bundle"])
        blake2b.reset_launch_counts()
        recomputed = get_backend("gpu").blake2b256_batch([b.data for b in bundle.blocks])
        assert sum(blake2b.LAUNCHES.values()) >= 1
        assert recomputed == [hashlib.blake2b(b.data, digest_size=32).digest() for b in bundle.blocks]
        assert all(CID.hash_of(b.data) == b.cid for b in bundle.blocks)


def test_backfill_window_on_card_equals_cpu(cuda_device, tmp_path, monkeypatch):
    """A backfill job on a card service's LOW lane: one mask launch per
    window (unfused scan), the sealed bundle equal to the CPU's range, and
    the card's witness verification launching blake2b."""
    from ipc_proofs_tpu_torch.backfill import BackfillEngine
    from ipc_proofs_tpu_torch.serve import ProofService, ServiceConfig

    monkeypatch.setenv("IPC_SCAN_FUSED_MATCH", "0")
    sig, topic = "NewTopDownMessage(bytes32,uint256)", "calib-subnet-1"
    store, pairs, _ = build_range_world(16, 6, 3, 0.3, signature=sig, topic1=topic)
    spec = EventProofSpec(sig, topic)
    svc = ProofService(store=store, spec=spec, config=ServiceConfig())
    engine = BackfillEngine(pairs, spec, lambda w, p: svc.submit_range_window(p).result(),
                            jobs_dir=str(tmp_path), window_size=4, metrics=svc.metrics)
    try:
        match.LAUNCHES.update(dict.fromkeys(match.LAUNCHES, 0))
        sealed = engine.submit(0, 16).result(timeout=300)
        torch.cuda.synchronize()
        launches = dict(match.LAUNCHES)
    finally:
        engine.close(timeout=60)
        svc.drain()
    assert launches["event_match_mask_fp"] == 4
    want = generate_event_proofs_for_range(store, pairs, spec, match_backend=get_backend("gpu", device="cpu"))
    assert sealed.to_json() == want.to_json()
    blake2b.reset_launch_counts()
    result = verify_proof_bundle(sealed, TrustPolicy.accept_all(), verify_witness_cids=True)
    assert result.all_valid() and sum(blake2b.LAUNCHES.values()) >= 1


def test_cluster_router_over_card_shards_equals_the_driver(cuda_device, monkeypatch):
    """Two `LocalShard`s on the card behind a `ClusterRouter`: the scatter
    is byte-identical to the chunked driver on the CPU, with one mask launch
    a chunk of each group the router formed (unfused scan; the shards share
    this process's counters), and a routed verify launches exactly the
    blake2b set a single daemon launches for the same request."""
    from ipc_proofs_tpu_torch.cluster import ClusterRouter, LocalShard, pair_ring_key
    from ipc_proofs_tpu_torch.proofs.bundle import UnifiedProofBundle
    from ipc_proofs_tpu_torch.serve import ProofService, ServiceConfig

    monkeypatch.setenv("IPC_SCAN_FUSED_MATCH", "0")
    sig, topic = "NewTopDownMessage(bytes32,uint256)", "calib-subnet-1"
    store, pairs, _ = build_range_world(16, 6, 3, 0.3, signature=sig, topic1=topic)
    spec = EventProofSpec(sig, topic)
    config = ServiceConfig(max_wait_ms=1.0, verify_witness_cids=True)
    shards = [LocalShard(f"s{i}", store, pairs, spec, config=config).start() for i in range(2)]
    router = ClusterRouter({s.name: s.url for s in shards}, pairs, scrape_interval_s=60.0)
    try:
        match.LAUNCHES.update(dict.fromkeys(match.LAUNCHES, 0))
        status, obj = router.generate_range(list(range(16)), chunk_size=4)
        torch.cuda.synchronize()
        launches = dict(match.LAUNCHES)
        assert status == 200 and obj["n_groups"] == 2
        with router._lock:
            owners = [router._affinity_locked(pair_ring_key(p)) for p in pairs]
        chunks = sum(-(-owners.count(name) // 4) for name in set(owners))
        assert launches["event_match_mask_fp"] == chunks
        want = generate_event_proofs_for_range_chunked(store, pairs, spec, chunk_size=4,
                                                       match_backend=get_backend("gpu", device="cpu"))
        assert UnifiedProofBundle.from_json_obj(obj["bundle"]).to_json() == want.to_json()

        body = {"bundle": obj["bundle"]}
        blake2b.reset_launch_counts()
        status, routed = router.verify(body)
        torch.cuda.synchronize()
        routed_launches = dict(blake2b.LAUNCHES)
        assert status == 200 and routed["all_valid"] is True
    finally:
        router.close()
        for s in shards:
            s.stop(timeout=60)
    with ProofService(config=config) as single:
        blake2b.reset_launch_counts()
        assert single.verify(want).all_valid()
        torch.cuda.synchronize()
    assert routed_launches == dict(blake2b.LAUNCHES) and sum(routed_launches.values()) >= 2


def test_chaos_run_on_card_launches_blake2b_through_the_lane(cuda_device, monkeypatch):
    from ipc_proofs_tpu_torch.tools import chaos

    monkeypatch.setenv("IPC_VERIFY_MIN_BYTES", "0")  # every landed wave on the card's lane
    backend = get_backend("gpu")
    store, pairs, spec, reference = chaos.build_world(backend=backend)
    want = chaos.build_world(backend=get_backend("gpu", device="cpu"))[3]
    assert reference == want
    outcomes = []
    for seed in range(3):
        blake2b.reset_launch_counts()
        res = chaos.chaos_run(store, pairs, spec, reference, seed, fault_rate=0.05, backend=backend,
                              fetch_plane=True)
        torch.cuda.synchronize()
        assert res["outcome"] in ("identical", "typed_error"), res
        assert sum(blake2b.LAUNCHES.values()) > 0
        assert res["counters"].get("verify.device_blocks", 0) > 0
        outcomes.append(res["outcome"])
    assert "identical" in outcomes


def test_crash_point_with_a_child_on_card_resumes_identically(cuda_device, tmp_path):
    from ipc_proofs_tpu_torch.ops.build import KERNEL_LIBRARIES, build_libraries
    from ipc_proofs_tpu_torch.tools import crashtest

    shape = {"pairs": 12, "chunk_size": 2, "receipts": 4, "events": 2, "match_rate": 0.2, "record_workers": 1}
    reference = crashtest.range_reference(shape, "cuda")
    assert reference == crashtest.range_reference(shape, "cpu")
    res = crashtest.crash_run(reference, shape, 2, 64, str(tmp_path), device="cuda")
    assert res["outcome"] == "identical", res
    built = build_libraries(KERNEL_LIBRARIES)
    assert res["libraries"] == {name: str(info["path"]) for name, info in built.items()}
