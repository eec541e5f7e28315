"""keccak-256 in the PyTorch port against the JAX package, bit for bit.

The port's plain PyTorch versions (what its wrappers run on CPU tensors)
must equal the reference's Pallas kernel in interpret mode, its XLA
multi-block kernel, and the scalar ``core.hashes.keccak256``. The tolerance
is zero: integer hashing. (``hashlib.sha3_256`` pads with 0x06, not
keccak's 0x01, and is no golden model here.) The CUDA kernels themselves
run only on the card: tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ipc_proofs_tpu.ops import pack as ref_pack  # noqa: E402
from ipc_proofs_tpu.ops.keccak_jax import keccak256_blocks as ref_blocks  # noqa: E402
from ipc_proofs_tpu.ops.pallas_kernels import keccak256_single_block_pallas  # noqa: E402
from ipc_proofs_tpu.ops.pallas_kernels import (  # noqa: E402
    pack_single_block_keccak as ref_pack_single,
)
from ipc_proofs_tpu_torch.backend import get_backend  # noqa: E402
from ipc_proofs_tpu_torch.backend.gpu import KECCAK_CLASSES, keccak_class  # noqa: E402
from ipc_proofs_tpu_torch.core.hashes import keccak256  # noqa: E402
from ipc_proofs_tpu_torch.ops import keccak, pack  # noqa: E402

SINGLE_LENGTHS = [0, 1, 63, 64, 65, 134, 135]
MULTI_LENGTHS = [135, 136, 137, 271, 272, 273, 543]


def _messages(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in lengths]


def _golden(messages):
    return [keccak256(m) for m in messages]


def _t(array):
    """u32 numpy array → int32 bit-view tensor (the wrappers' input form)."""
    return torch.from_numpy(np.ascontiguousarray(array).view(np.int32))


def _words(out):
    return out.numpy().view(np.uint32)


@pytest.fixture(scope="module")
def tile_messages():
    """One full TILE (N = 256) of single-block lengths: an interpret-mode
    Pallas compile costs seconds per shape, so the comparison shares it."""
    rng = np.random.default_rng(5)
    lengths = SINGLE_LENGTHS + rng.integers(0, 136, 256 - len(SINGLE_LENGTHS)).tolist()
    return _messages(lengths, seed=6)


@pytest.fixture(scope="module")
def multi_messages():
    rng = np.random.default_rng(9)
    return _messages(MULTI_LENGTHS + rng.integers(0, 600, 25).tolist(), seed=10)


class TestPackers:
    def test_single_block_packer_byte_equal(self, tile_messages):
        ours = pack.pack_single_block_keccak(tile_messages[:200])
        ref = ref_pack_single(tile_messages[:200])
        assert ours[2] == ref[2] == 200
        for a, b in zip(ours[:2], ref[:2]):
            assert a.dtype == b.dtype and a.shape == b.shape == (256, 17)
            assert a.tobytes() == b.tobytes()

    @pytest.mark.parametrize("max_blocks", [None, 6])
    def test_pad_keccak_byte_equal(self, multi_messages, max_blocks):
        for a, b in zip(
            pack.pad_keccak(multi_messages, max_blocks),
            ref_pack.pad_keccak(multi_messages, max_blocks),
        ):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes()

    def test_oversize_raises_like_reference(self):
        with pytest.raises(ValueError):
            pack.pack_single_block_keccak([b"\x00" * 136])
        with pytest.raises(ValueError):
            ref_pack_single([b"\x00" * 136])
        with pytest.raises(ValueError):
            pack.pad_keccak([b"\x00" * 300], max_blocks=2)


class TestPlainVersusReference:
    def test_single_block_equals_pallas_interpret(self, tile_messages):
        blo, bhi, n = ref_pack_single(tile_messages)
        ref = np.asarray(
            keccak256_single_block_pallas(jnp.asarray(blo), jnp.asarray(bhi), interpret=True)
        )
        ours = _words(keccak.keccak256_single_block(_t(blo), _t(bhi)))
        np.testing.assert_array_equal(ours, ref)
        assert pack.digests_to_bytes(ours[:n]) == _golden(tile_messages)

    @pytest.mark.parametrize("max_blocks", [None, 6])
    def test_blocks_equals_xla_kernel(self, multi_messages, max_blocks):
        blocks, n_blocks = ref_pack.pad_keccak(multi_messages, max_blocks)
        ref = np.asarray(ref_blocks(jnp.asarray(blocks), jnp.asarray(n_blocks)))
        ours = _words(keccak.keccak256_blocks(_t(blocks), _t(n_blocks)))
        np.testing.assert_array_equal(ours, ref)
        assert pack.digests_to_bytes(ours) == _golden(multi_messages)

    def test_blocks_masked_rows_equal_xla_kernel(self):
        """Block counts the XLA scan masks agree too: 0 keeps the zero state
        (a digest of 32 zero bytes), more than B absorbs B blocks."""
        blocks, _ = ref_pack.pad_keccak(_messages([5, 300, 140, 0, 543]))
        n_blocks = np.array([0, 3, 9, 1, -2], dtype=np.int32)
        ref = np.asarray(ref_blocks(jnp.asarray(blocks), jnp.asarray(n_blocks)))
        ours = _words(keccak.keccak256_blocks(_t(blocks), _t(n_blocks)))
        np.testing.assert_array_equal(ours, ref)
        assert not ours[0].any() and not ours[4].any()

    @pytest.mark.parametrize("length", SINGLE_LENGTHS + MULTI_LENGTHS)
    def test_edge_lengths_equal_scalar(self, length):
        msg = _messages([length], seed=length)
        blocks, n_blocks = pack.pad_keccak(msg)
        out = keccak.keccak256_blocks(_t(blocks), _t(n_blocks))
        assert pack.digests_to_bytes(_words(out)) == _golden(msg)
        if length < 136:
            blo, bhi, n = pack.pack_single_block_keccak(msg)
            out = keccak.keccak256_single_block(_t(blo), _t(bhi))
            assert pack.digests_to_bytes(_words(out)[:n]) == _golden(msg)


class TestWrappers:
    def test_cpu_tensors_run_plain_and_count_nothing(self, multi_messages):
        keccak.reset_launch_counts()
        blocks, n_blocks = pack.pad_keccak(multi_messages[:4])
        keccak.keccak256_blocks(_t(blocks), _t(n_blocks))
        blo, bhi, _ = pack.pack_single_block_keccak([b"abc"])
        keccak.keccak256_single_block(_t(blo), _t(bhi))
        assert set(keccak.LAUNCHES.values()) == {0}

    def test_other_devices_raise(self):
        lanes = torch.zeros((4, 17), dtype=torch.int32, device="meta")
        with pytest.raises(ValueError, match="unsupported device"):
            keccak.keccak256_single_block(lanes, lanes)
        blocks = torch.zeros((4, 1, 34), dtype=torch.int32, device="meta")
        n_blocks = torch.zeros((4,), dtype=torch.int32, device="meta")
        with pytest.raises(ValueError, match="unsupported device"):
            keccak.keccak256_blocks(blocks, n_blocks)

    @pytest.mark.parametrize(
        "bad",
        [
            lambda m: m.to(torch.int64),
            lambda m: m[:, :8],
            lambda m: m.t().contiguous().t(),
        ],
        ids=["dtype", "shape", "contiguity"],
    )
    def test_bad_inputs_raise(self, bad):
        lanes = torch.zeros((17, 17), dtype=torch.int32)
        with pytest.raises((TypeError, ValueError)):
            keccak.keccak256_single_block(bad(lanes), lanes)

    @pytest.mark.parametrize(
        "blocks,n_blocks",
        [((4, 2, 32), (4,)), ((4, 2, 34), (3,)), ((4, 34), (4,))],
        ids=["lanes", "counts", "rank"],
    )
    def test_bad_block_shapes_raise(self, blocks, n_blocks):
        with pytest.raises(ValueError):
            keccak.keccak256_blocks(
                torch.zeros(blocks, dtype=torch.int32), torch.zeros(n_blocks, dtype=torch.int32)
            )


class TestSizeClassSplit:
    @pytest.mark.parametrize(
        "length,kernel",
        [
            (0, "keccak256_single_block"),
            (64, "keccak256_single_block"),
            (135, "keccak256_single_block"),
            (136, "keccak256_blocks"),
            (543, "keccak256_blocks"),
        ],
    )
    def test_size_class_boundaries(self, length, kernel):
        assert keccak_class(length) == kernel
        assert kernel in KECCAK_CLASSES
        msg = _messages([length], seed=length)
        assert get_backend("gpu", device="cpu").keccak256_batch(msg) == _golden(msg)

    def test_mixed_batch_routes_each_class_once_in_order(self, monkeypatch):
        """Each class goes to its own wrapper in one call, as `keccak_class`
        says, and the digests come back in input order."""
        calls = []
        for name in KECCAK_CLASSES:
            real = getattr(keccak, name)

            def spy(*args, _name=name, _real=real):
                calls.append((_name, args[0].shape[0]))
                return _real(*args)

            monkeypatch.setattr(keccak, name, spy)
        rng = np.random.default_rng(11)
        lengths = rng.permutation(SINGLE_LENGTHS * 3 + MULTI_LENGTHS * 3 + [64] * 40).tolist()
        msgs = _messages(lengths, seed=12)
        assert get_backend("gpu", device="cpu").keccak256_batch(msgs) == _golden(msgs)
        n_single = sum(keccak_class(n) == "keccak256_single_block" for n in lengths)
        assert calls == [
            ("keccak256_single_block", 256),  # padded to TILE
            ("keccak256_blocks", len(lengths) - n_single),
        ]

    def test_empty_batch(self):
        assert get_backend("gpu", device="cpu").keccak256_batch([]) == []
