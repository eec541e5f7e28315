"""The port's disk tier (`storex/segments.py`, `storex/tiered.py`) and the
receipts-API pathway, against the JAX package.

- the segment store's own tests, as the reference's `tests/test_storex.py`
  states them: round trip, the corruption grid (a flipped byte in every
  frame field, torn tails, in-place flips, forged frames with valid CRCs),
  LRU eviction, the read-only degrade;
- the batched read paths (`get_many`, the sweep at open) on the backend's
  plain versions, verdict for verdict those of the scalar `get`;
- segment directories written by either package open in the other with the
  same index, and the same evictions at a verifying open;
- the tier's bundles (off / on / cold / warm) equal the reference's
  in-memory bundle byte for byte, and the warm run makes no RPC call;
- the receipts-API pathway (`receipt_from_api_json`, `Tipset.from_api_json`,
  `generate_event_proof(..., receipts_client=)`) gives the reference's
  proofs.
"""

import base64
import builtins
import os
import zlib

import pytest

jax = pytest.importorskip("jax")

from ipc_proofs_tpu.core.cid import CID as RefCID  # noqa: E402
from ipc_proofs_tpu.fixtures import ContractFixture as RefContract  # noqa: E402
from ipc_proofs_tpu.fixtures import EventFixture as RefEvent  # noqa: E402
from ipc_proofs_tpu.fixtures import build_chain as ref_build_chain  # noqa: E402
from ipc_proofs_tpu.fixtures import build_range_world as ref_build_range_world  # noqa: E402
from ipc_proofs_tpu.proofs.chain import Tipset as RefTipset  # noqa: E402
from ipc_proofs_tpu.proofs.chain import receipt_from_api_json as ref_receipt_from_api_json  # noqa: E402
from ipc_proofs_tpu.proofs.event_generator import generate_event_proof as ref_generate_event_proof  # noqa: E402
from ipc_proofs_tpu.proofs.generator import EventProofSpec as RefSpec  # noqa: E402
from ipc_proofs_tpu.proofs.range import generate_event_proofs_for_range as ref_generate  # noqa: E402
from ipc_proofs_tpu.store.testing import FakeLotusClient as RefFakeLotusClient  # noqa: E402
from ipc_proofs_tpu.storex import SegmentStore as RefSegmentStore  # noqa: E402
from ipc_proofs_tpu_torch.backend import get_backend  # noqa: E402
from ipc_proofs_tpu_torch.core.cid import CID, RAW  # noqa: E402
from ipc_proofs_tpu_torch.fixtures import ContractFixture, EventFixture, build_chain, build_range_world  # noqa: E402
from ipc_proofs_tpu_torch.jobs.journal import FRAME_HEADER  # noqa: E402
from ipc_proofs_tpu_torch.proofs.chain import Tipset, receipt_from_api_json  # noqa: E402
from ipc_proofs_tpu_torch.proofs.event_generator import generate_event_proof  # noqa: E402
from ipc_proofs_tpu_torch.proofs.generator import EventProofSpec  # noqa: E402
from ipc_proofs_tpu_torch.proofs.range import generate_event_proofs_for_range_chunked  # noqa: E402
from ipc_proofs_tpu_torch.store.faults import LocalLotusSession  # noqa: E402
from ipc_proofs_tpu_torch.store.rpc import LotusClient, RpcBlockstore  # noqa: E402
from ipc_proofs_tpu_torch.store.testing import FakeLotusClient  # noqa: E402
from ipc_proofs_tpu_torch.storex import (  # noqa: E402
    SEGMENT_MAGIC,
    SegmentStore,
    SegmentStoreError,
    TieredBlockstore,
)
from ipc_proofs_tpu_torch.utils.metrics import Metrics  # noqa: E402

SIG = "NewTopDownMessage(bytes32,uint256)"
SUBNET = "calib-subnet-1"
ACTOR = 1001
CPU = get_backend("gpu", device="cpu")


def _block(i: int) -> "tuple[CID, bytes]":
    data = (b"block-%04d-" % i) * (i + 2)
    return CID.hash_of(data), data


def _scan_frames(path: str) -> "list[tuple[int, int]]":
    """(offset, frame_len) of every frame in a segment file, via the
    public framing contract (shared FRAME_HEADER struct)."""
    with open(path, "rb") as fh:
        data = fh.read()
    frames = []
    off = 0
    while off + FRAME_HEADER.size <= len(data):
        magic, length, _crc = FRAME_HEADER.unpack_from(data, off)
        assert magic == SEGMENT_MAGIC
        frames.append((off, FRAME_HEADER.size + length))
        off += FRAME_HEADER.size + length
    assert off == len(data)
    return frames


def _seg_paths(root: str) -> "list[str]":
    return sorted(
        os.path.join(root, n) for n in os.listdir(root) if n.endswith(".blk")
    )


def _flip(path: str, offset: int) -> None:
    with open(path, "r+b") as fh:
        fh.seek(offset)
        b = fh.read(1)
        fh.seek(offset)
        fh.write(bytes([b[0] ^ 0x40]))


class TestSegmentStore:
    def test_round_trip_and_stats(self, tmp_path):
        m = Metrics()
        store = SegmentStore(str(tmp_path), metrics=m, backend=CPU)
        blocks = [_block(i) for i in range(8)]
        for cid, data in blocks:
            assert store.put(cid, data) is True
        for cid, data in blocks:
            assert store.contains(cid)
            assert store.get(cid) == data
        assert len(store) == 8
        stats = store.stats()
        assert stats["entries"] == 8
        assert stats["bytes"] == os.path.getsize(_seg_paths(str(tmp_path))[0])
        assert stats["segments"] == 1
        assert not stats["degraded"]
        counters = m.snapshot()["counters"]
        assert counters["storex.disk_hits"] == 8
        assert "storex.disk_misses" not in counters
        store.close()

    def test_duplicate_put_is_noop(self, tmp_path):
        store = SegmentStore(str(tmp_path), backend=CPU)
        cid, data = _block(1)
        assert store.put(cid, data) is True
        size = store.stats()["bytes"]
        assert store.put(cid, data) is True
        assert store.stats()["bytes"] == size
        assert len(store) == 1
        store.close()

    def test_miss_counts(self, tmp_path):
        m = Metrics()
        store = SegmentStore(str(tmp_path), metrics=m, backend=CPU)
        cid, _ = _block(99)
        assert store.get(cid) is None
        assert m.snapshot()["counters"]["storex.disk_misses"] == 1
        store.close()

    def test_reopen_rebuilds_index(self, tmp_path):
        blocks = [_block(i) for i in range(6)]
        with SegmentStore(str(tmp_path), backend=CPU) as store:
            for cid, data in blocks:
                store.put(cid, data)
        reopened = SegmentStore(str(tmp_path), backend=CPU)
        assert len(reopened) == 6
        for cid, data in blocks:
            assert reopened.get(cid) == data
        reopened.close()

    def test_typed_errors(self, tmp_path):
        with pytest.raises(SegmentStoreError):
            SegmentStore(str(tmp_path), cap_bytes=0, backend=CPU)
        (tmp_path / "seg-bogus.blk").write_bytes(b"")
        with pytest.raises(SegmentStoreError):
            SegmentStore(str(tmp_path), backend=CPU)


class TestCorruptionGrid:
    """Byte-level damage at every structurally distinct frame position.
    The contract under test: corruption is an *availability* event — a
    typed truncation on reopen or a verified miss on read — never bytes
    served that don't match the CID (silent divergence)."""

    # (frame index, byte offset within the frame): magic, len, crc, payload
    POINTS = [
        (k, field_off)
        for k in (0, 1, 2)
        for field_off in (0, 4, 8, FRAME_HEADER.size + 3)
    ]

    def _store_with_blocks(self, root, n=3):
        blocks = [_block(i) for i in range(n)]
        with SegmentStore(root, backend=CPU) as store:
            for cid, data in blocks:
                store.put(cid, data)
        return blocks

    @pytest.mark.parametrize("frame_idx,field_off", POINTS)
    def test_reopen_truncates_at_flip(self, tmp_path, frame_idx, field_off):
        blocks = self._store_with_blocks(str(tmp_path))
        path = _seg_paths(str(tmp_path))[0]
        frames = _scan_frames(path)
        off, _ = frames[frame_idx]
        _flip(path, off + field_off)
        store = SegmentStore(str(tmp_path), backend=CPU)
        # everything before the damaged frame survives; the damaged frame
        # and everything after it is truncated away (refetch on demand)
        for i, (cid, data) in enumerate(blocks):
            if i < frame_idx:
                assert store.get(cid) == data
            else:
                assert store.get(cid) is None
        assert os.path.getsize(path) == off
        store.close()

    @pytest.mark.parametrize("extra", [1, 7, FRAME_HEADER.size + 1])
    def test_reopen_truncates_torn_tail(self, tmp_path, extra):
        blocks = self._store_with_blocks(str(tmp_path))
        path = _seg_paths(str(tmp_path))[0]
        frames = _scan_frames(path)
        last_off, _ = frames[-1]
        with open(path, "r+b") as fh:
            fh.truncate(last_off + extra)
        store = SegmentStore(str(tmp_path), backend=CPU)
        for cid, data in blocks[:-1]:
            assert store.get(cid) == data
        assert store.get(blocks[-1][0]) is None
        assert os.path.getsize(path) == last_off
        store.close()

    def test_inplace_flip_is_verified_miss(self, tmp_path):
        m = Metrics()
        store = SegmentStore(str(tmp_path), metrics=m, backend=CPU)
        blocks = [_block(i) for i in range(3)]
        for cid, data in blocks:
            store.put(cid, data)
        path = _seg_paths(str(tmp_path))[0]
        off, frame_len = _scan_frames(path)[1]
        _flip(path, off + frame_len - 1)  # last payload byte of block 1
        assert store.get(blocks[1][0]) is None  # CRC catches it
        counters = m.snapshot()["counters"]
        assert counters["storex.integrity_evictions"] == 1
        assert not store.contains(blocks[1][0])  # entry evicted
        assert store.get(blocks[0][0]) == blocks[0][1]  # neighbours intact
        assert store.get(blocks[2][0]) == blocks[2][1]
        store.close()

    def test_forged_frame_caught_by_multihash(self, tmp_path):
        """A frame rewritten with a *valid* CRC but wrong block bytes must
        be caught by the multihash re-verification layer — the CRC only
        proves the disk returned what was written, not that what was
        written is the block the CID names."""
        m = Metrics()
        store = SegmentStore(str(tmp_path), metrics=m, backend=CPU)
        cid, data = _block(0)
        store.put(cid, data)
        path = _seg_paths(str(tmp_path))[0]
        off, frame_len = _scan_frames(path)[0]
        with open(path, "r+b") as fh:
            frame = fh.read(frame_len)
            payload = bytearray(frame[FRAME_HEADER.size :])
            payload[-1] ^= 0xFF  # forge the block bytes…
            forged = FRAME_HEADER.pack(
                SEGMENT_MAGIC, len(payload), zlib.crc32(bytes(payload))
            ) + bytes(payload)  # …and recompute a valid CRC
            fh.seek(off)
            fh.write(forged)
        assert store.get(cid) is None
        assert m.snapshot()["counters"]["storex.integrity_evictions"] == 1
        store.close()

    def test_forged_frame_repaired_by_refetch(self, tmp_path):
        """Through the tiered store, the forged frame reads as a miss and
        the refetched clean bytes re-spill: availability, not correctness."""

        class _Inner:
            def __init__(self, mapping):
                self.mapping = mapping
                self.gets = 0

            def get(self, cid):
                self.gets += 1
                return self.mapping.get(cid)

            def has(self, cid):
                return cid in self.mapping

            def put_keyed(self, cid, data):
                self.mapping[cid] = data

        m = Metrics()
        cid, data = _block(0)
        disk = SegmentStore(str(tmp_path), metrics=m, backend=CPU)
        disk.put(cid, data)
        path = _seg_paths(str(tmp_path))[0]
        off, frame_len = _scan_frames(path)[0]
        _flip(path, off + frame_len - 1)
        inner = _Inner({cid: data})
        tiered = TieredBlockstore(inner, disk, metrics=m)
        assert tiered.get(cid) == data  # correct bytes despite disk damage
        assert inner.gets == 1  # repaired via refetch…
        assert m.snapshot()["counters"]["storex.integrity_evictions"] == 1
        assert tiered.get(cid) == data
        assert inner.gets == 1  # …and served from the local tiers after
        disk.close()


class TestEviction:
    def test_lru_eviction_respects_cap(self, tmp_path):
        m = Metrics()
        # segment_max_bytes=1 → every put seals its own segment, so the
        # LRU operates at single-block granularity here
        store = SegmentStore(
            str(tmp_path), cap_bytes=2048, segment_max_bytes=1, metrics=m, backend=CPU,
        )
        blocks = [_block(i) for i in range(20)]
        for cid, data in blocks:
            store.put(cid, data)
        stats = store.stats()
        assert stats["bytes"] <= 2048
        assert 0 < stats["entries"] < 20
        assert m.snapshot()["counters"]["storex.evictions"] == 20 - stats["entries"]
        assert m.snapshot()["gauges"]["storex.disk_bytes"] == stats["bytes"]
        # LRU: the oldest blocks are gone, the newest survive
        assert not store.contains(blocks[0][0])
        assert store.get(blocks[-1][0]) == blocks[-1][1]
        # evicted segment files are actually deleted from disk
        assert len(_seg_paths(str(tmp_path))) == stats["segments"]
        store.close()

    def test_evicted_blocks_refetch_through_tiers(self, tmp_path):
        bs, pairs, _ = build_range_world(
            2, 4, 2, 0.5, signature=SIG, topic1=SUBNET, base_height=500
        )
        m = Metrics()
        disk = SegmentStore(
            str(tmp_path), cap_bytes=4096, segment_max_bytes=1, metrics=m, backend=CPU,
        )
        tiered = TieredBlockstore(bs, disk, cache={}, metrics=m)
        cids = [c for pair in pairs for c in pair.parent.cids + pair.child.cids]
        for cid in cids:
            assert tiered.get(cid) == bs.get(cid)
        # a fresh wrapper (cold memory tier) still returns correct bytes
        # for every CID, evicted or not
        tiered2 = TieredBlockstore(bs, disk, cache={}, metrics=m)
        for cid in cids:
            assert tiered2.get(cid) == bs.get(cid)
        disk.close()


class TestDegrade:
    def test_write_failure_degrades_to_read_only(self, tmp_path, monkeypatch):
        m = Metrics()
        store = SegmentStore(str(tmp_path), metrics=m, backend=CPU)
        cid0, data0 = _block(0)
        store.put(cid0, data0)
        store.close()  # seal the active segment so the next put reopens
        store = SegmentStore(str(tmp_path), metrics=m, backend=CPU)
        real_open = builtins.open

        def deny_append(path, mode="r", *args, **kwargs):
            if str(path).startswith(str(tmp_path)) and "a" in mode:
                raise OSError(28, "No space left on device")
            return real_open(path, mode, *args, **kwargs)

        monkeypatch.setattr(builtins, "open", deny_append)
        cid1, data1 = _block(1)
        assert store.put(cid1, data1) is False
        assert store.degraded
        assert m.snapshot()["counters"]["storex.write_failures"] == 1
        # degraded means read-only, not dead: existing blocks still serve
        assert store.get(cid0) == data0
        # further puts fail fast without re-counting
        assert store.put(cid1, data1) is False
        assert m.snapshot()["counters"]["storex.write_failures"] == 1
        store.close()


def _forge(path: str, frame: "tuple[int, int]") -> None:
    """Rewrite one frame with its last payload byte changed and a valid CRC:
    the CRC passes, only the multihash can catch it."""
    off, frame_len = frame
    with open(path, "r+b") as fh:
        fh.seek(off)
        payload = bytearray(fh.read(frame_len)[FRAME_HEADER.size :])
        payload[-1] ^= 0xFF
        fh.seek(off)
        fh.write(FRAME_HEADER.pack(SEGMENT_MAGIC, len(payload), zlib.crc32(bytes(payload))) + bytes(payload))


class TestBatchedReads:
    @pytest.mark.parametrize("lane", ["0", "999999999"], ids=["device", "scalar"])
    def test_get_many_matches_scalar_gets(self, tmp_path, lane, monkeypatch):
        monkeypatch.setenv("IPC_VERIFY_MIN_BYTES", lane)
        m = Metrics()
        store = SegmentStore(str(tmp_path), metrics=m, backend=CPU)
        blocks = [_block(i) for i in range(12)]
        for cid, data in blocks:
            store.put(cid, data)
        liar = CID.hash_of(b"the bytes this cid claims")
        store.put(liar, b"entirely different bytes")  # frame CRC still valid
        missing = CID.hash_of(b"never stored")
        got = store.get_many([c for c, _ in blocks] + [liar, missing])
        assert got == dict(blocks)
        counters = m.snapshot()["counters"]
        assert counters["storex.disk_hits"] == 12
        assert counters["storex.disk_misses"] == 2
        assert counters["storex.integrity_evictions"] == 1
        assert counters["verify.batch_calls"] == 1
        assert (counters.get("verify.device_blocks", 0) == 13) == (lane == "0")
        assert not store.contains(liar)  # dropped, as a scalar get drops it
        assert [store.get(c) for c, _ in blocks] == [d for _, d in blocks]
        store.close()

    def test_verify_scan_drops_forged_frames_at_open(self, tmp_path, monkeypatch):
        monkeypatch.setenv("IPC_VERIFY_MIN_BYTES", "0")
        blocks = [_block(i) for i in range(10)]
        with SegmentStore(str(tmp_path), backend=CPU) as store:
            for cid, data in blocks:
                store.put(cid, data)
        path = _seg_paths(str(tmp_path))[0]
        frames = _scan_frames(path)
        for k in (2, 7):
            _forge(path, frames[k])
        m = Metrics()
        with SegmentStore(str(tmp_path), metrics=m, verify_scan=True, backend=CPU) as reopened:
            assert [reopened.contains(c) for c, _ in blocks] == [i not in (2, 7) for i in range(10)]
            counters = m.snapshot()["counters"]
            assert counters["storex.integrity_evictions"] == 2
            assert counters["verify.batch_calls"] == 1  # one call for the segment
            assert counters["verify.device_blocks"] == 10


def _populate(root: str, store_cls, cid_cls, n: int, forged=(3, 11), **kw) -> "list[tuple[bytes, bytes]]":
    """Write ``n`` blocks through one package's SegmentStore (two segments),
    then forge two frames; returns (raw cid, data) pairs."""
    out = []
    with store_cls(root, segment_max_bytes=2048, **kw) as store:
        for i in range(n):
            data = (b"x-%04d-" % i) * (i % 7 + 3)
            cid = cid_cls.hash_of(data)
            store.put(cid, data)
            out.append((cid.to_bytes(), data))
    paths = _seg_paths(root)
    assert len(paths) >= 2
    frames = [(p, f) for p in paths for f in _scan_frames(p)]
    for k in forged:
        _forge(*frames[k])
    return out


def _open_view(store, cid_cls, blocks) -> dict:
    return {
        "len": len(store),
        "contains": [store.contains(cid_cls.from_bytes(raw)) for raw, _ in blocks],
        "get": [store.get(cid_cls.from_bytes(raw)) for raw, _ in blocks],
        "segments": store.stats()["segments"],
    }


class TestCrossPackageFiles:
    @pytest.mark.parametrize("writer", ["jax", "port"])
    def test_segment_files_open_in_both_packages(self, tmp_path, writer, monkeypatch):
        monkeypatch.setenv("IPC_VERIFY_MIN_BYTES", "0")
        store_cls, cid_cls, kw = (RefSegmentStore, RefCID, {}) if writer == "jax" else (SegmentStore, CID, {"backend": CPU})
        blocks = _populate(str(tmp_path / "w"), store_cls, cid_cls, 24, **kw)
        views = {}
        for reader in ("jax", "port"):
            root = tmp_path / reader
            root.mkdir()
            for name in os.listdir(tmp_path / "w"):
                (root / name).write_bytes((tmp_path / "w" / name).read_bytes())
            m = Metrics()
            if reader == "jax":
                from ipc_proofs_tpu.utils.metrics import Metrics as RefMetrics

                m = RefMetrics()
                store = RefSegmentStore(str(root), metrics=m, batch_verify=True, verify_scan=True)
                cls = RefCID
            else:
                store = SegmentStore(str(root), metrics=m, verify_scan=True, backend=CPU)
                cls = CID
            with store:
                views[reader] = dict(
                    _open_view(store, cls, blocks),
                    evictions=m.snapshot()["counters"].get("storex.integrity_evictions", 0),
                )
        assert views["port"] == views["jax"]
        assert views["port"]["evictions"] == 2
        assert views["port"]["contains"] == [i not in (3, 11) for i in range(24)]
        assert views["port"]["get"] == [None if i in (3, 11) else d for i, (_, d) in enumerate(blocks)]

    def test_port_appends_to_a_jax_written_store(self, tmp_path):
        blocks = _populate(str(tmp_path), RefSegmentStore, RefCID, 24, forged=())
        with SegmentStore(str(tmp_path), segment_max_bytes=2048, backend=CPU) as store:
            extra = _block(100)
            store.put(*extra)
        with RefSegmentStore(str(tmp_path)) as ref:
            assert ref.get(RefCID.from_bytes(extra[0].to_bytes())) == extra[1]
            assert all(ref.get(RefCID.from_bytes(raw)) == d for raw, d in blocks)


@pytest.fixture(scope="module")
def world():
    kw = dict(signature=SIG, topic1=SUBNET, actor_id=ACTOR, base_height=41_000)
    bs, pairs, n_matching = build_range_world(3, 6, 3, 0.3, **kw)
    ref_bs, ref_pairs, _ = ref_build_range_world(3, 6, 3, 0.3, **kw)
    reference = ref_generate(ref_bs, ref_pairs, RefSpec(SIG, SUBNET, ACTOR)).to_json()
    return bs, pairs, n_matching, reference


def _bundle(store, pairs):
    return generate_event_proofs_for_range_chunked(
        store, pairs, EventProofSpec(SIG, SUBNET, ACTOR), chunk_size=2, match_backend=CPU
    ).to_json()


def _rpc_client(bs, metrics):
    return LotusClient("http://test-storex", session=LocalLotusSession(bs), metrics=metrics)


class TestTierBitIdentity:
    def test_off_on_cold_warm_equal_the_reference_and_warm_is_rpc_free(self, tmp_path, world):
        bs, pairs, n_matching, reference = world
        assert n_matching > 0
        assert _bundle(bs, pairs) == reference  # tier off, memory store

        m_cold = Metrics()
        assert _bundle(RpcBlockstore(_rpc_client(bs, m_cold)), pairs) == reference
        assert m_cold.counter_value("rpc.calls") > 0

        store_dir = str(tmp_path / "store")
        m_pop = Metrics()
        with SegmentStore(store_dir, metrics=m_pop, backend=CPU) as disk:
            tiered = TieredBlockstore(RpcBlockstore(_rpc_client(bs, m_pop)), disk, metrics=m_pop)
            assert _bundle(tiered, pairs) == reference

        # simulated restart: index rebuilt with the sweep, empty memory tier,
        # fresh client, and not one RPC call
        m_warm = Metrics()
        with SegmentStore(store_dir, metrics=m_warm, verify_scan=True, backend=CPU) as disk:
            tiered = TieredBlockstore(RpcBlockstore(_rpc_client(bs, m_warm)), disk, metrics=m_warm)
            assert _bundle(tiered, pairs) == reference
        counters = m_warm.snapshot()["counters"]
        assert counters.get("rpc.calls", 0) == 0
        assert counters["storex.disk_hits"] > 0
        assert counters.get("storex.integrity_evictions", 0) == 0

    def test_block_cache_tier(self, tmp_path, world):
        from ipc_proofs_tpu_torch.store.blockstore import BlockCache

        bs, pairs, _, reference = world
        cache = BlockCache(max_bytes=4096)
        with SegmentStore(str(tmp_path), backend=CPU) as disk:
            tiered = TieredBlockstore(bs, disk, cache=cache)
            assert _bundle(tiered, pairs) == reference
            assert cache.stats()["bytes"] <= 4096 and cache.evictions > 0
            assert tiered.cache_stats() == (cache.stats()["entries"], cache.stats()["bytes"])


class TestBlockCache:
    def test_lru_and_ttl(self):
        from ipc_proofs_tpu.store.blockstore import BlockCache as RefBlockCache
        from ipc_proofs_tpu_torch.store.blockstore import BlockCache

        for cache_cls, cid_cls in ((BlockCache, CID), (RefBlockCache, RefCID)):
            now = [0.0]
            cache = cache_cls(max_bytes=100, ttl_s=5.0, clock=lambda: now[0])
            cids = [cid_cls.hash_of(b"%d" % i) for i in range(4)]
            for i, cid in enumerate(cids[:3]):
                cache.put(cid, bytes([i]) * 40)  # the third evicts the first
            assert cache.get(cids[0]) is None and cache.get(cids[2]) == bytes([2]) * 40
            cache.put(cids[3], b"x" * 101)  # larger than the budget: never cached
            assert cids[3] not in cache
            now[0] = 10.0
            assert cache.get(cids[2]) is None  # expired
            stats = cache.stats()
            assert (stats["evictions"], stats["expirations"], len(cache)) == (1, 1, 1)
        with pytest.raises(ValueError):
            BlockCache(max_bytes=0)


def _receipts_world(pkg: str):
    if pkg == "jax":
        return ref_build_chain(
            [RefContract(actor_id=ACTOR, storage={})],
            [[RefEvent(emitter=ACTOR, signature=SIG, topic1=SUBNET), RefEvent(emitter=ACTOR, signature=SIG, topic1="other")], []],
            parent_height=500,
        )
    return build_chain(
        [ContractFixture(actor_id=ACTOR, storage={})],
        [[EventFixture(emitter=ACTOR, signature=SIG, topic1=SUBNET), EventFixture(emitter=ACTOR, signature=SIG, topic1="other")], []],
        parent_height=500,
    )


def _event_bundle(bundle) -> tuple:
    """An `EventProofBundle` of either package as plain JSON values."""
    return (
        [p.to_json_obj() for p in bundle.proofs],
        [b.to_json_obj() for b in bundle.blocks],
    )


def _tipset_json(tipset) -> dict:
    return {
        "Cids": [{"/": str(c)} for c in tipset.cids],
        "Blocks": [
            {
                "Parents": [{"/": str(c)} for c in h.parents],
                "Height": h.height,
                "ParentStateRoot": {"/": str(h.parent_state_root)},
                "ParentMessageReceipts": {"/": str(h.parent_message_receipts)},
                "Messages": {"/": str(h.messages)},
                "Timestamp": h.timestamp,
            }
            for h in tipset.blocks
        ],
        "Height": tipset.height,
    }


class TestReceiptsApiPathway:
    @pytest.mark.parametrize(
        "obj",
        [
            {"ExitCode": 0, "Return": base64.b64encode(b"\x01\x02").decode(), "GasUsed": 77,
             "EventsRoot": {"/": str(CID.hash_of(b"events", codec=RAW))}},
            {"ExitCode": 1, "Return": None, "GasUsed": 0, "EventsRoot": None},
            {"ExitCode": 3, "Return": ""},
        ],
    )
    def test_receipt_from_api_json(self, obj):
        got, want = receipt_from_api_json(obj), ref_receipt_from_api_json(obj)
        assert (got.exit_code, got.return_data, got.gas_used) == (want.exit_code, want.return_data, want.gas_used)
        assert (got.events_root is None) == (want.events_root is None)
        if got.events_root is not None:
            assert got.events_root.to_bytes() == want.events_root.to_bytes()

    def test_tipset_from_api_json(self):
        world = _receipts_world("port")
        obj = _tipset_json(world.child)
        got, want = Tipset.from_api_json(obj), RefTipset.from_api_json(obj)
        assert [c.to_bytes() for c in got.cids] == [c.to_bytes() for c in want.cids]
        assert got.height == want.height == world.child.height
        assert got.blocks[0].parent_message_receipts == world.child.blocks[0].parent_message_receipts
        assert [str(p) for p in got.blocks[0].parents] == [str(p) for p in want.blocks[0].parents]

    def test_api_pathway_gives_the_references_proofs(self):
        world, ref_world = _receipts_world("port"), _receipts_world("jax")
        client, ref_client = FakeLotusClient(world.store), RefFakeLotusClient(ref_world.store)
        store = RpcBlockstore(client)
        args = (SIG, SUBNET, ACTOR)
        via_amt = generate_event_proof(store, world.parent, world.child, *args, match_backend=CPU)
        via_api = generate_event_proof(
            store, world.parent, world.child, *args, match_backend=CPU, receipts_client=client
        )
        want = ref_generate_event_proof(
            ref_world.store, ref_world.parent, ref_world.child, *args, receipts_client=ref_client
        )
        assert _event_bundle(via_api) == _event_bundle(via_amt) == _event_bundle(want)
        assert len(via_api.proofs) == 1
        assert any(c[0] == "Filecoin.ChainGetParentReceipts" for c in client.calls)

    def test_null_api_receipts_raises(self):
        world = _receipts_world("port")
        client = FakeLotusClient(world.store, responses={"Filecoin.ChainGetParentReceipts": lambda _cid: None})
        with pytest.raises(KeyError, match="ChainGetParentReceipts"):
            generate_event_proof(
                RpcBlockstore(client), world.parent, world.child, SIG, SUBNET,
                match_backend=CPU, receipts_client=client,
            )

    def test_lotus_client_serves_the_receipts_api(self):
        """`LotusClient.chain_get_parent_receipts` over the hermetic node
        with a canned response gives the same proofs."""
        world = _receipts_world("port")
        api = FakeLotusClient(world.store).chain_get_parent_receipts(world.child.cids[0])
        client = LotusClient(
            "http://receipts",
            session=LocalLotusSession(world.store, responses={"Filecoin.ChainGetParentReceipts": api}),
            metrics=Metrics(),
        )
        store = RpcBlockstore(client)
        got = generate_event_proof(
            store, world.parent, world.child, SIG, SUBNET, ACTOR, match_backend=CPU, receipts_client=client
        )
        assert _event_bundle(got) == _event_bundle(
            generate_event_proof(world.store, world.parent, world.child, SIG, SUBNET, ACTOR, match_backend=CPU)
        )


def _owned_block(cid_cls, tag: bytes, i: int):
    data = (b"%s-%04d-" % (tag, i)) * 40
    return cid_cls.hash_of(data), data


class TestSharedMode:
    """Several writers (owners) in one store directory, eviction
    coordinated through the ``evict.lock`` flock — here one writer of each
    package, so the two packages' eviction passes coordinate."""

    def test_coordinated_eviction_across_packages(self, tmp_path):
        from ipc_proofs_tpu.utils.metrics import Metrics as RefMetrics
        from ipc_proofs_tpu_torch.utils import lockdep

        lockdep.enable(strict=True)
        lockdep.reset()
        try:
            m, ref_m = Metrics(), RefMetrics()
            kw = dict(cap_bytes=4000, segment_max_bytes=800)
            a = RefSegmentStore(str(tmp_path), metrics=ref_m, owner="sa", **kw)
            b = SegmentStore(str(tmp_path), metrics=m, owner="sb", **kw, backend=CPU)
            written = []
            for i in range(12):
                c, d = _owned_block(RefCID, b"aa", i)
                assert a.put(c, d)
                written.append((a, c, d))
                c, d = _owned_block(CID, b"bb", i)
                assert b.put(c, d)
                written.append((b, c, d))
            graph = lockdep.order_graph()
        finally:
            lockdep.disable()
        # either writer may run a pass that evicts; both take the flock
        evictions = m.counter_value("storex.shared_evictions") + ref_m.counter_value("storex.shared_evictions")
        assert evictions > 0
        assert ("SegmentStore._lock", "flock:storex.evict") in graph
        names = [n for n in os.listdir(str(tmp_path)) if n.endswith(".blk")]
        assert {n.split(".")[0] for n in names} == {"seg-sa", "seg-sb"}  # both active tails survive
        assert sum(os.path.getsize(os.path.join(str(tmp_path), n)) for n in names) <= 4000 + 2 * 800
        for store, c, d in written:
            got = store.get(c)
            assert got is None or got == d
        a.close()
        b.close()

    def test_reopen_indexes_all_owners(self, tmp_path):
        ca, da = _owned_block(RefCID, b"aa", 1)
        cb, db = _owned_block(CID, b"bb", 1)
        with RefSegmentStore(str(tmp_path), owner="sa") as a:
            a.put(ca, da)
        with SegmentStore(str(tmp_path), owner="sb", backend=CPU) as b:
            b.put(cb, db)
        with SegmentStore(str(tmp_path), owner="sc", backend=CPU) as c:
            assert c.get(CID.from_bytes(ca.to_bytes())) == da
            assert c.get(cb) == db
            assert c.stats()["shared"] is True and c.owner == "sc"

    @pytest.mark.parametrize("owner", ["bad/owner", ""])
    def test_owner_token_validation(self, tmp_path, owner):
        with pytest.raises(SegmentStoreError, match="owner token"):
            SegmentStore(str(tmp_path), owner=owner, backend=CPU)
