"""The port's verify lane (`ops/verify.py`) against the JAX package's
(`ops/verify_jax.py`).

The same seeded inputs go through both packages' `verify_blocks_batch` on
both lanes (the device lane forced with ``IPC_VERIFY_MIN_BYTES=0``, the
scalar lane at the default crossover) and through the reference's
`verify_block_bytes`; the verdicts must be equal, block for block. The
port's device lane runs the kernels' plain versions (CPU backend), the
reference's runs XLA on the CPU. Tolerance: none (verdicts are booleans).

Also: the autotune record's name and version, and that neither package
loads the other's record; and that a kernel fault raises out of the lane,
the fetch plane and the segment store instead of falling back to the
scalar lane.
"""

import json
import threading

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from ipc_proofs_tpu.core.cid import CID as RefCID  # noqa: E402
from ipc_proofs_tpu.ops import verify_jax as ref_verify  # noqa: E402
from ipc_proofs_tpu.store.rpc import verify_block_bytes as ref_verify_block_bytes  # noqa: E402
from ipc_proofs_tpu_torch.backend import get_backend  # noqa: E402
from ipc_proofs_tpu_torch.core.cid import (  # noqa: E402
    BLAKE2B_256,
    CID,
    DAG_CBOR,
    IDENTITY,
    KECCAK_256,
    SHA2_256,
)
from ipc_proofs_tpu_torch.core.hashes import keccak256  # noqa: E402
from ipc_proofs_tpu_torch.ops import verify  # noqa: E402
from ipc_proofs_tpu_torch.ops.verify import (  # noqa: E402
    SCALAR_ONLY_MIN_BYTES,
    autotune_crossover,
    batch_min_bytes,
    load_autotune,
    verify_blocks_batch,
)
from ipc_proofs_tpu_torch.store.faults import LocalLotusSession  # noqa: E402
from ipc_proofs_tpu_torch.store.blockstore import MemoryBlockstore  # noqa: E402
from ipc_proofs_tpu_torch.store.fetchplane import FetchPlane  # noqa: E402
from ipc_proofs_tpu_torch.store.rpc import LotusClient, RpcBlockstore, verify_block_bytes  # noqa: E402
from ipc_proofs_tpu_torch.storex import SegmentStore  # noqa: E402
from ipc_proofs_tpu_torch.utils.metrics import Metrics  # noqa: E402

CPU = get_backend("gpu", device="cpu")
UNKNOWN_CODE = 0x15  # no verifier for it: accepted by contract
FAMILIES = (BLAKE2B_256, SHA2_256, KECCAK_256, IDENTITY, UNKNOWN_CODE)
# straddles the blake2b (128 B, 256 B) and keccak (136 B) block boundaries
SIZES = (0, 1, 100, 127, 128, 129, 135, 136, 137, 256, 257, 300, 520, 1500)
DEVICE, SCALAR = "0", "999999999"


def _cid_for(code: int, data: bytes) -> CID:
    if code == KECCAK_256:
        return CID(1, DAG_CBOR, KECCAK_256, keccak256(data))
    if code == UNKNOWN_CODE:
        return CID(1, DAG_CBOR, UNKNOWN_CODE, b"\x00" * 32)
    return CID.hash_of(data, mh_code=code)


def _flip(data: bytes, bit: int) -> bytes:
    byte, off = divmod(bit, 8)
    return data[:byte] + bytes([data[byte] ^ (1 << off)]) + data[byte + 1 :]


def _grid(seed: int = 5) -> "tuple[list[CID], list[bytes]]":
    """Every family × size from the seed, plus corrupt variants with one
    bit flipped at the start, a seeded middle position and the end."""
    rng = np.random.default_rng(seed)
    cids, blocks = [], []
    for code in FAMILIES:
        for size in SIZES:
            data = rng.integers(0, 256, size=size, dtype=np.uint8).tobytes()
            cids.append(_cid_for(code, data))
            blocks.append(data)
            if size == 0:
                continue
            for bit in (0, int(rng.integers(0, size * 8)), size * 8 - 1):
                cids.append(_cid_for(code, data))
                blocks.append(_flip(data, bit))
    return cids, blocks


def _ref(cids) -> "list[RefCID]":
    return [RefCID.from_bytes(c.to_bytes()) for c in cids]


@pytest.fixture(scope="module")
def grid():
    cids, blocks = _grid()
    ref_cids = _ref(cids)
    want = [ref_verify_block_bytes(c, b) for c, b in zip(ref_cids, blocks)]
    return cids, ref_cids, blocks, want


class TestDifferentialGrid:
    @pytest.mark.parametrize("lane", ["device", "scalar"])
    def test_port_equals_reference_verdicts(self, grid, lane, monkeypatch):
        monkeypatch.setenv("IPC_VERIFY_MIN_BYTES", DEVICE if lane == "device" else SCALAR)
        cids, ref_cids, blocks, want = grid
        m = Metrics()
        got = verify_blocks_batch(cids, blocks, metrics=m, backend=CPU)
        assert got == want
        assert got == ref_verify.verify_blocks_batch(ref_cids, blocks)
        assert got == [verify_block_bytes(c, b) for c, b in zip(cids, blocks)]
        counters = m.snapshot()["counters"]
        assert counters["verify.batch_calls"] == 1
        assert counters["verify.batch_blocks"] == len(cids)
        batchable = sum(c.mh_code in (BLAKE2B_256, KECCAK_256) for c in cids)
        if lane == "device":
            # one backend call per family, no filler rows
            assert counters["verify.device_calls"] == 2
            assert counters["verify.device_blocks"] == batchable
            assert counters["verify.scalar_blocks"] == len(cids) - batchable
        else:
            assert counters.get("verify.device_calls", 0) == 0
            assert counters["verify.scalar_blocks"] == len(cids)

    @pytest.mark.parametrize("code", [BLAKE2B_256, KECCAK_256])
    def test_every_flipped_bit_of_a_sample_is_caught(self, code, monkeypatch):
        """Every bit of a 137-byte block (two keccak rate blocks, two
        blake2b blocks) flipped in turn: each corrupt variant fails on the
        device lane, as on the reference's."""
        monkeypatch.setenv("IPC_VERIFY_MIN_BYTES", DEVICE)
        data = np.random.default_rng(code).integers(0, 256, size=137, dtype=np.uint8).tobytes()
        cid = _cid_for(code, data)
        blocks = [data] + [_flip(data, bit) for bit in range(len(data) * 8)]
        cids = [cid] * len(blocks)
        got = verify_blocks_batch(cids, blocks, backend=CPU)
        assert got == [True] + [False] * (len(blocks) - 1)
        assert got == ref_verify.verify_blocks_batch(_ref(cids), blocks)

    def test_one_huge_block_among_small_ones(self, monkeypatch):
        """One 16 KiB block beside 40 small ones: the same verdicts as the
        reference's, in ONE blake2b call (the backend splits it by size
        class; the reference makes one call per power-of-two class)."""
        monkeypatch.setenv("IPC_VERIFY_MIN_BYTES", DEVICE)
        small = [b"s%02d" % i * 20 for i in range(40)]
        huge = bytes(range(256)) * 64
        blocks = small + [huge]
        cids = [CID.hash_of(b) for b in blocks]
        cids[7] = CID.hash_of(b"not block 7")
        m = Metrics()
        got = verify_blocks_batch(cids, blocks, metrics=m, backend=CPU)
        assert got == [i != 7 for i in range(len(blocks))]
        assert got == ref_verify.verify_blocks_batch(_ref(cids), blocks)
        assert m.snapshot()["counters"]["verify.device_calls"] == 1

    def test_empty_and_mismatched_inputs(self):
        assert verify_blocks_batch([], [], backend=CPU) == []
        assert ref_verify.verify_blocks_batch([], []) == []
        with pytest.raises(ValueError):
            verify_blocks_batch([CID.hash_of(b"x")], [], backend=CPU)
        with pytest.raises(ValueError):
            ref_verify.verify_blocks_batch([RefCID.hash_of(b"x")], [])

    @pytest.mark.parametrize(
        "blocks",
        [
            [b"tiny-%d" % i for i in range(4)],  # below the default crossover
            [b"x" * 300_000],  # one block: `len(batchable) >= 2` fails
        ],
        ids=["small", "single"],
    )
    def test_default_crossover_routes_as_the_reference(self, blocks, monkeypatch):
        monkeypatch.delenv("IPC_VERIFY_MIN_BYTES", raising=False)
        monkeypatch.setattr(verify, "_tuned_min_bytes", None)
        assert batch_min_bytes() == ref_verify.batch_min_bytes() == 256 * 1024
        cids = [CID.hash_of(b) for b in blocks]
        m = Metrics()
        assert verify_blocks_batch(cids, blocks, metrics=m, backend=CPU) == [True] * len(blocks)
        counters = m.snapshot()["counters"]
        assert counters.get("verify.device_calls", 0) == 0
        assert counters["verify.scalar_blocks"] == len(blocks)

    def test_default_backend_is_the_card(self, monkeypatch):
        """Without ``backend=`` the lane asks for the card, which raises on
        a host without CUDA rather than hashing on the CPU."""
        import torch

        if torch.cuda.is_available():
            pytest.skip("a card is present: the default backend is usable here")
        with pytest.raises(RuntimeError, match="CUDA"):
            verify_blocks_batch([CID.hash_of(b"a")], [b"a"])


class _FaultyBackend:
    """A backend whose kernels fail, as a refused launch does."""

    name = "gpu"

    def warm(self) -> None:
        pass

    def blake2b256_batch(self, messages):
        raise RuntimeError("injected kernel fault")

    keccak256_batch = blake2b256_batch


class _HashlibBackend:
    """A fast stand-in for the card in the autotuner's logic tests."""

    name = "gpu"

    def blake2b256_batch(self, messages):
        import hashlib

        return [hashlib.blake2b(m, digest_size=32).digest() for m in messages]


class _GatedClient:
    """A client over ``inner`` whose batch reads wait for ``gate``, so the
    wants queued meanwhile land as one wave; ``entered`` is set when the
    dispatcher has taken a wave."""

    endpoint = "http://gated"

    def __init__(self, inner):
        self.inner, self.gate, self.entered = inner, threading.Event(), threading.Event()

    def chain_read_obj_many(self, batch):
        self.entered.set()
        assert self.gate.wait(5.0)
        return self.inner.chain_read_obj_many(batch)

    def chain_read_obj(self, cid):
        return self.inner.chain_read_obj(cid)


class TestKernelFaultRaises:
    def _blocks(self, n=4):
        blocks = [b"fault-%03d" % i * 9 for i in range(n)]
        return [CID.hash_of(b) for b in blocks], blocks

    def test_lane_raises(self, monkeypatch):
        monkeypatch.setenv("IPC_VERIFY_MIN_BYTES", DEVICE)
        cids, blocks = self._blocks()
        with pytest.raises(RuntimeError, match="injected kernel fault"):
            verify_blocks_batch(cids, blocks, backend=_FaultyBackend())

    def test_segment_store_raises(self, tmp_path, monkeypatch):
        monkeypatch.setenv("IPC_VERIFY_MIN_BYTES", DEVICE)
        cids, blocks = self._blocks()
        with SegmentStore(str(tmp_path), backend=CPU) as seg:
            for c, b in zip(cids, blocks):
                seg.put(c, b)
        with SegmentStore(str(tmp_path), backend=_FaultyBackend()) as seg:
            with pytest.raises(RuntimeError, match="injected kernel fault"):
                seg.get_many(cids)
            assert len(seg) == len(cids)  # nothing evicted on a fault
        with pytest.raises(RuntimeError, match="injected kernel fault"):
            SegmentStore(str(tmp_path), verify_scan=True, backend=_FaultyBackend())

    def _node(self, cids, blocks, m):
        bs = MemoryBlockstore()
        for c, b in zip(cids, blocks):
            bs.put_keyed(c, b)
        return LotusClient("http://fault", session=LocalLotusSession(bs), metrics=m)

    def test_fetch_plane_demand_raises(self, monkeypatch):
        """A demand wave (`fetch_into`) whose check faults raises the
        kernel's error to the caller, and the plane stays faulted."""
        monkeypatch.setenv("IPC_VERIFY_MIN_BYTES", DEVICE)
        cids, blocks = self._blocks()
        m = Metrics()
        # the first wave is held until every want is queued, so the waves
        # are a prefix and the rest: at most one single-block wave
        client = _GatedClient(self._node(cids, blocks, m))
        plane = FetchPlane(client, local={}, workers=1, backend=_FaultyBackend(), metrics=m)
        timer = threading.Timer(0.2, client.gate.set)
        timer.start()
        try:
            with pytest.raises(RuntimeError, match="injected kernel fault"):
                plane.fetch_into(cids, {})
            for cid in cids:
                with pytest.raises(RuntimeError, match="injected kernel fault"):
                    plane.get(cid)
        finally:
            timer.join(5.0)
            plane.close()
        # only a single-block wave (the reference's routing: the scalar
        # lane) may have verified
        assert m.counter_value("verify.scalar_blocks") <= 1

    @pytest.mark.parametrize("wave", ["speculate", "prime", "prefetch"])
    def test_fetch_plane_fault_reaches_the_caller(self, wave, monkeypatch):
        """The only multi-block wave is speculative, primed or a prefetch:
        its fault still reaches the caller, and every later read of the
        plane raises it, though a one-block demand wave would pass on
        hashlib."""
        monkeypatch.setenv("IPC_VERIFY_MIN_BYTES", DEVICE)
        cids, blocks = self._blocks(6)
        m = Metrics()
        client = _GatedClient(self._node(cids, blocks, m))
        plane = FetchPlane(client, local={}, workers=1, speculate_depth=1, backend=_FaultyBackend(), metrics=m)
        try:
            head, later = cids[:4], cids[4:]
            if wave == "prefetch":
                store = RpcBlockstore(client.inner, metrics=m)
                store.attach_plane(plane)
                timer = threading.Timer(0.2, client.gate.set)
                timer.start()
                try:
                    with pytest.raises(RuntimeError, match="injected kernel fault"):
                        store.prefetch(head, {})
                finally:
                    timer.join(5.0)
            else:
                getattr(plane, wave)(head)
                assert client.entered.wait(5.0)
                client.gate.set()
                with pytest.raises(RuntimeError, match="injected kernel fault"):
                    plane.get(head[0])
            for cid in later:
                with pytest.raises(RuntimeError, match="injected kernel fault"):
                    plane.get(cid)
        finally:
            client.gate.set()
            plane.close()
        assert m.counter_value("verify.scalar_blocks") <= (1 if wave == "prefetch" else 0)
        assert m.counter_value("rpc.prefetch_failures") == 0


class TestAutotune:
    def test_record_name_and_version(self, tmp_path, monkeypatch):
        monkeypatch.setattr(verify, "_tuned_min_bytes", None)
        record = autotune_crossover(str(tmp_path), backend=_HashlibBackend())
        path = tmp_path / "verify_autotune_cuda.json"
        assert path.exists() and not (tmp_path / "verify_autotune.json").exists()
        assert json.loads(path.read_text()) == record
        assert record["version"] == 1
        assert [s["payload_bytes"] for s in record["samples"]] == [65536, 262144, 1048576]
        assert record["scalar_only"] == (record["min_bytes"] == SCALAR_ONLY_MIN_BYTES)
        assert load_autotune(str(tmp_path)) == record["min_bytes"]
        # a second call loads the record instead of measuring
        assert autotune_crossover(str(tmp_path), backend=_FaultyBackend()) == record

    def test_neither_package_loads_the_others_record(self, tmp_path, monkeypatch):
        monkeypatch.setattr(verify, "_tuned_min_bytes", None)
        monkeypatch.setattr(ref_verify, "_tuned_min_bytes", None)
        monkeypatch.delenv("IPC_VERIFY_MIN_BYTES", raising=False)
        jax_dir, card_dir = tmp_path / "jax", tmp_path / "card"
        jax_dir.mkdir()
        (jax_dir / ref_verify._AUTOTUNE_FILE).write_text(
            json.dumps({"version": ref_verify._AUTOTUNE_VERSION, "min_bytes": 4096})
        )
        assert ref_verify.load_autotune(str(jax_dir)) == 4096
        assert load_autotune(str(jax_dir)) is None
        assert batch_min_bytes() == 256 * 1024
        autotune_crossover(str(card_dir), backend=_HashlibBackend())
        monkeypatch.setattr(ref_verify, "_tuned_min_bytes", None)
        assert ref_verify.load_autotune(str(card_dir)) is None

    @pytest.mark.parametrize(
        "content", ["not json", json.dumps({"version": 2, "min_bytes": 1}), json.dumps([1])]
    )
    def test_bad_record_is_absent(self, tmp_path, monkeypatch, content):
        monkeypatch.setattr(verify, "_tuned_min_bytes", None)
        (tmp_path / "verify_autotune_cuda.json").write_text(content)
        assert load_autotune(str(tmp_path)) is None
        assert verify._tuned_min_bytes is None

    def test_a_mis_hashing_lane_raises(self, tmp_path, monkeypatch):
        monkeypatch.setattr(verify, "_tuned_min_bytes", None)

        class _WrongBackend(_HashlibBackend):
            def blake2b256_batch(self, messages):
                return [b"\x00" * 32 for _ in messages]

        with pytest.raises(RuntimeError, match="mismatch"):
            autotune_crossover(str(tmp_path), backend=_WrongBackend())
        with pytest.raises(RuntimeError, match="injected kernel fault"):
            autotune_crossover(str(tmp_path), backend=_FaultyBackend())
        assert not (tmp_path / "verify_autotune_cuda.json").exists()

    def test_env_override_wins(self, tmp_path, monkeypatch):
        monkeypatch.setattr(verify, "_tuned_min_bytes", 123)
        monkeypatch.setenv("IPC_VERIFY_MIN_BYTES", "77")
        assert batch_min_bytes() == 77
        monkeypatch.delenv("IPC_VERIFY_MIN_BYTES")
        assert batch_min_bytes() == 123
