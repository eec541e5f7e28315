"""blake2b-256 in the PyTorch port against the JAX package, bit for bit.

The port's plain PyTorch versions (what its wrappers run on CPU tensors)
must equal the reference's Pallas kernels in interpret mode, its XLA
multi-block kernel, and hashlib. The tolerance is zero: integer hashing.
The CUDA kernels themselves run only on the card: tests/test_torch_cuda.py.
"""

import hashlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ipc_proofs_tpu.ops import pack as ref_pack  # noqa: E402
from ipc_proofs_tpu.ops.blake2b_jax import blake2b256_blocks as ref_blocks  # noqa: E402
from ipc_proofs_tpu.ops.pallas_kernels import (  # noqa: E402
    blake2b256_single_block_pallas,
    blake2b256_two_block_pallas,
)
from ipc_proofs_tpu.ops.pallas_kernels import (  # noqa: E402
    pack_single_block_blake2b as ref_pack_single,
)
from ipc_proofs_tpu.ops.pallas_kernels import (  # noqa: E402
    pack_two_block_blake2b as ref_pack_two,
)
from ipc_proofs_tpu_torch.backend import get_backend  # noqa: E402
from ipc_proofs_tpu_torch.backend.gpu import SIZE_CLASSES, size_class  # noqa: E402
from ipc_proofs_tpu_torch.ops import blake2b, pack  # noqa: E402

EDGE_LENGTHS = [0, 1, 127, 128, 129, 255, 256, 257, 384, 385, 520]


def _messages(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in lengths]


def _golden(messages):
    return [hashlib.blake2b(m, digest_size=32).digest() for m in messages]


def _t(array):
    """u32 numpy array → int32 bit-view tensor (the wrappers' input form)."""
    return torch.from_numpy(np.ascontiguousarray(array).view(np.int32))


def _words(out):
    return out.numpy().view(np.uint32)


@pytest.fixture(scope="module")
def tile_messages():
    """One full TILE (N = 256) of mixed lengths: interpret-mode Pallas
    compiles cost 5–30 s per shape, so every Pallas comparison shares it."""
    rng = np.random.default_rng(7)
    lengths = list(EDGE_LENGTHS) + rng.integers(0, 521, 256 - len(EDGE_LENGTHS)).tolist()
    return _messages(lengths, seed=8)


class TestPackers:
    @pytest.mark.parametrize("cap", [128, 256])
    def test_split_packers_byte_equal(self, tile_messages, cap):
        msgs = [m for m in tile_messages if len(m) <= cap]
        ref = (ref_pack_single if cap == 128 else ref_pack_two)(msgs)
        ours = (pack.pack_single_block_blake2b if cap == 128 else pack.pack_two_block_blake2b)(msgs)
        assert ours[3] == ref[3]
        for a, b in zip(ours[:3], ref[:3]):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes()

    @pytest.mark.parametrize("max_blocks", [None, 6])
    def test_pad_blake2b_byte_equal(self, tile_messages, max_blocks):
        for a, b in zip(
            pack.pad_blake2b(tile_messages, max_blocks),
            ref_pack.pad_blake2b(tile_messages, max_blocks),
        ):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes()

    @pytest.mark.parametrize("cap", [128, 256])
    def test_split_packers_reject_oversize(self, cap):
        packer = pack.pack_single_block_blake2b if cap == 128 else pack.pack_two_block_blake2b
        with pytest.raises(ValueError):
            packer([b"\x00" * (cap + 1)])

    def test_digests_to_bytes_matches_reference(self):
        rng = np.random.default_rng(3)
        words = rng.integers(0, 1 << 32, (9, 8), dtype=np.uint64).astype(np.uint32)
        assert pack.digests_to_bytes(words) == ref_pack.digests_to_bytes(words)
        assert pack.digests_to_bytes(words.view(np.int32)) == ref_pack.digests_to_bytes(words)


class TestPlainVersusReference:
    def test_single_block_equals_pallas_interpret(self, tile_messages):
        msgs = [m for m in tile_messages if len(m) <= 128]
        m_lo, m_hi, lengths, n = ref_pack_single(msgs)
        ref = np.asarray(
            blake2b256_single_block_pallas(
                jnp.asarray(m_lo), jnp.asarray(m_hi), jnp.asarray(lengths), interpret=True
            )
        )
        ours = _words(blake2b.blake2b256_single_block(_t(m_lo), _t(m_hi), _t(lengths)))
        np.testing.assert_array_equal(ours, ref)
        assert pack.digests_to_bytes(ours[:n]) == _golden(msgs)

    def test_two_block_equals_pallas_interpret(self, tile_messages):
        msgs = [m for m in tile_messages if len(m) <= 256]
        m_lo, m_hi, lengths, n = ref_pack_two(msgs)
        ref = np.asarray(
            blake2b256_two_block_pallas(
                jnp.asarray(m_lo), jnp.asarray(m_hi), jnp.asarray(lengths), interpret=True
            )
        )
        ours = _words(blake2b.blake2b256_two_block(_t(m_lo), _t(m_hi), _t(lengths)))
        np.testing.assert_array_equal(ours, ref)
        assert pack.digests_to_bytes(ours[:n]) == _golden(msgs)

    @pytest.mark.parametrize("max_blocks", [None, 6])
    def test_blocks_equals_xla_kernel(self, tile_messages, max_blocks):
        blocks, n_blocks, lengths = ref_pack.pad_blake2b(tile_messages, max_blocks)
        ref = np.asarray(
            ref_blocks(jnp.asarray(blocks), jnp.asarray(n_blocks), jnp.asarray(lengths))
        )
        ours = _words(blake2b.blake2b256_blocks(_t(blocks), _t(n_blocks), _t(lengths)))
        np.testing.assert_array_equal(ours, ref)
        assert pack.digests_to_bytes(ours) == _golden(tile_messages)

    def test_blocks_masked_rows_equal_xla_kernel(self):
        """Block counts the XLA scan masks (0, and more than B) agree too."""
        blocks, _, lengths = ref_pack.pad_blake2b(_messages([5, 300, 130, 0]))
        n_blocks = np.array([0, 3, 4, 1], dtype=np.int32)
        ref = np.asarray(
            ref_blocks(jnp.asarray(blocks), jnp.asarray(n_blocks), jnp.asarray(lengths))
        )
        ours = _words(blake2b.blake2b256_blocks(_t(blocks), _t(n_blocks), _t(lengths)))
        np.testing.assert_array_equal(ours, ref)

    @pytest.mark.parametrize("length", EDGE_LENGTHS)
    def test_edge_lengths_equal_hashlib(self, length):
        msg = _messages([length], seed=length)
        blocks, n_blocks, lengths = pack.pad_blake2b(msg)
        out = blake2b.blake2b256_blocks(_t(blocks), _t(n_blocks), _t(lengths))
        assert pack.digests_to_bytes(_words(out)) == _golden(msg)
        for cap, packer, kernel in (
            (128, pack.pack_single_block_blake2b, blake2b.blake2b256_single_block),
            (256, pack.pack_two_block_blake2b, blake2b.blake2b256_two_block),
        ):
            if length <= cap:
                m_lo, m_hi, lens, n = packer(msg)
                out = kernel(_t(m_lo), _t(m_hi), _t(lens))
                assert pack.digests_to_bytes(_words(out)[:n]) == _golden(msg)


class TestLanes:
    """`blake2b256_blocks` puts a message over four lanes below
    `QUAD_ROWS_MAX` rows and over one above; the digests do not
    depend on the lanes: against the XLA kernel and hashlib."""

    @pytest.mark.parametrize("lanes", [1, 4])
    @pytest.mark.parametrize("case", ["mixed", "odd-counts", "empty"])
    def test_any_lanes_give_the_reference_digests(self, case, lanes):
        rng = np.random.default_rng(21)
        n = 0 if case == "empty" else 97
        msgs = _messages(rng.integers(0, 5 * 128 + 1, n).tolist(), seed=22)
        blocks, n_blocks, lengths = ref_pack.pad_blake2b(msgs, 6)
        if case == "odd-counts":
            n_blocks[:4] = (0, -1, 8, 6)  # masked, past the layout's 6, and its last
        ref = np.asarray(ref_blocks(jnp.asarray(blocks), jnp.asarray(n_blocks), jnp.asarray(lengths)))
        ours = blake2b.blake2b256_blocks_on_lanes(_t(blocks), _t(n_blocks), _t(lengths), lanes)
        np.testing.assert_array_equal(_words(ours), ref.reshape(n, 8))
        if case == "mixed":
            assert pack.digests_to_bytes(_words(ours)) == _golden(msgs)

    def test_lanes_switch_at_the_crossover(self):
        most = blake2b.QUAD_ROWS_MAX
        assert [blake2b.lanes_for_rows(n) for n in (0, 1, most, most + 1, 10 * most)] == [4, 4, 4, 1, 1]

    @pytest.mark.parametrize("most,lanes", [(2, 4), (1, 1)])
    def test_wrapper_passes_the_lanes_of_its_row_count(self, monkeypatch, most, lanes):
        """The lanes the wrapper gives the C entry, at 2 rows with the
        crossover moved to 2 (four lanes) and to 1 (one)."""
        seen = []
        monkeypatch.setattr(blake2b, "QUAD_ROWS_MAX", most)
        monkeypatch.setattr(blake2b, "runs_plain", lambda name, device: False)
        monkeypatch.setattr(blake2b, "_launch", lambda name, args, n, device: seen.append((name, args[3:], n)))
        blocks, n_blocks, lengths = pack.pad_blake2b(_messages([300, 700], seed=24))
        blake2b.blake2b256_blocks(_t(blocks), _t(n_blocks), _t(lengths))
        assert seen == [("blake2b256_blocks", [2, blocks.shape[1], lanes], 2)]

    @pytest.mark.parametrize("lanes", [0, 2, 32])
    def test_other_lanes_raise(self, lanes):
        blocks, n_blocks, lengths = pack.pad_blake2b(_messages([300], seed=25))
        with pytest.raises(ValueError, match="lanes"):
            blake2b.blake2b256_blocks_on_lanes(_t(blocks), _t(n_blocks), _t(lengths), lanes)


class TestWrappers:
    def test_cpu_tensors_run_plain_and_count_nothing(self, tile_messages):
        blake2b.reset_launch_counts()
        blocks, n_blocks, lengths = pack.pad_blake2b(tile_messages[:8])
        blake2b.blake2b256_blocks(_t(blocks), _t(n_blocks), _t(lengths))
        assert set(blake2b.LAUNCHES.values()) == {0}

    def test_other_devices_raise(self):
        m = torch.zeros((4, 16), dtype=torch.int32, device="meta")
        lengths = torch.zeros((4, 1), dtype=torch.int32, device="meta")
        with pytest.raises(ValueError, match="unsupported device"):
            blake2b.blake2b256_single_block(m, m, lengths)

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
        m = torch.zeros((16, 16), dtype=torch.int32)
        lengths = torch.zeros((16, 1), dtype=torch.int32)
        with pytest.raises((TypeError, ValueError)):
            blake2b.blake2b256_single_block(bad(m), m, lengths)


class TestSizeClassSplit:
    @pytest.mark.parametrize(
        "length,kernel",
        [
            (0, "blake2b256_single_block"),
            (128, "blake2b256_single_block"),
            (129, "blake2b256_two_block"),
            (256, "blake2b256_two_block"),
            (257, "blake2b256_blocks"),
            (520, "blake2b256_blocks"),
        ],
    )
    def test_size_class_boundaries(self, length, kernel):
        assert size_class(length) == kernel
        assert kernel in SIZE_CLASSES
        msg = _messages([length], seed=length)
        assert get_backend("gpu", device="cpu").blake2b256_batch(msg) == _golden(msg)

    def test_shuffled_mixed_batch_keeps_input_order(self):
        rng = np.random.default_rng(11)
        lengths = rng.permutation(list(EDGE_LENGTHS) * 3 + rng.integers(0, 600, 40).tolist())
        msgs = _messages(lengths.tolist(), seed=12)
        backend = get_backend("gpu", device="cpu")
        assert backend.blake2b256_batch(msgs) == _golden(msgs)
        assert backend.blake2b256_batch([]) == []

    def test_verify_block_cids_detects_one_flip(self):
        msgs = _messages([10, 200, 400], seed=13)
        digests = _golden(msgs)
        backend = get_backend("gpu", device="cpu")
        assert backend.verify_block_cids(digests, msgs)
        for i in range(3):
            flipped = list(msgs)
            flipped[i] = bytes([msgs[i][0] ^ 1]) + msgs[i][1:]
            assert not backend.verify_block_cids(digests, flipped)
