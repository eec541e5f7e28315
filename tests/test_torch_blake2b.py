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


# the kernels whose wrappers pick their lanes a message from the row count:
# (short id, packer of the JAX package, its Pallas kernel, byte cap); the
# multi-block kernel's test ids stay bare
LANE_KERNELS = {
    "blake2b256_blocks": None,
    "blake2b256_single_block": ("single", ref_pack_single, blake2b256_single_block_pallas, 128),
    "blake2b256_two_block": ("two", ref_pack_two, blake2b256_two_block_pallas, 256),
}
CROSSOVERS = {
    "blake2b256_blocks": "QUAD_ROWS_MAX",
    "blake2b256_single_block": "SINGLE_BLOCK_QUAD_ROWS_MAX",
    "blake2b256_two_block": "TWO_BLOCK_QUAD_ROWS_MAX",
}


def _by_kernel(params, kernels=tuple(LANE_KERNELS)):
    """``params`` ((values, id) of a test's other arguments) for each of
    ``kernels``, the kernel first."""
    return [
        pytest.param(kernel, *values, id=pid if LANE_KERNELS[kernel] is None else f"{LANE_KERNELS[kernel][0]}-{pid}")
        for kernel in kernels
        for values, pid in params
    ]


def _on_lanes(kernel: str, *args, lanes):
    return getattr(blake2b, kernel + "_on_lanes")(*args, lanes)


def _split_args(kernel: str, lengths, seed: int):
    """Messages of ``lengths`` packed for ``kernel`` by the JAX package's
    packer: (messages, u32 arrays, real rows)."""
    msgs = _messages(lengths, seed=seed)
    *arrays, n = LANE_KERNELS[kernel][1](msgs)
    return msgs, arrays, n


class TestLanes:
    """Each blake2b wrapper puts a message over four lanes up to its
    crossover (`QUAD_ROWS_MAX`, `SINGLE_BLOCK_QUAD_ROWS_MAX`,
    `TWO_BLOCK_QUAD_ROWS_MAX` rows) and over one above; the digests do not
    depend on the lanes: against the JAX package's kernels and hashlib."""

    @pytest.mark.parametrize(
        "kernel,case,lanes",
        _by_kernel([((case, lanes), f"{case}-{lanes}") for case in ("mixed", "odd-counts", "empty") for lanes in (1, 4)]),
    )
    def test_any_lanes_give_the_reference_digests(self, kernel, case, lanes):
        rng = np.random.default_rng(21)
        n = 0 if case == "empty" else 97
        if LANE_KERNELS[kernel] is not None:
            # odd counts: every block edge of the layout, so a warp's rows
            # run one compression and two side by side
            cap, pallas = LANE_KERNELS[kernel][3], LANE_KERNELS[kernel][2]
            edges = [length for length in EDGE_LENGTHS if length <= cap]
            lengths = (edges * 9)[:n] if case == "odd-counts" else rng.integers(0, cap + 1, n).tolist()
            msgs, arrays, rows = _split_args(kernel, lengths, seed=22)
            ours = _words(_on_lanes(kernel, *(_t(a) for a in arrays), lanes=lanes))
            if rows:
                ref = np.asarray(pallas(*(jnp.asarray(a) for a in arrays), interpret=True))
                np.testing.assert_array_equal(ours, ref)
            assert ours.shape == (arrays[0].shape[0], 8)
            assert pack.digests_to_bytes(ours[:rows]) == _golden(msgs)
            return
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

    @pytest.mark.parametrize("kernel", ["blake2b256_single_block", "blake2b256_two_block"], ids=["single", "two"])
    def test_split_lanes_switch_at_their_crossovers(self, kernel):
        """The split kernels' crossovers, at their boundaries, and the
        multi-block kernel's unmoved by them."""
        most = getattr(blake2b, CROSSOVERS[kernel])
        assert [blake2b.lanes_for_rows(n, kernel) for n in (0, 1, most, most + 1, 10 * most)] == [4, 4, 4, 1, 1]
        assert blake2b.lanes_for_rows(blake2b.QUAD_ROWS_MAX) == 4
        assert blake2b.lanes_for_rows(blake2b.QUAD_ROWS_MAX + 1) == 1

    @pytest.mark.parametrize("kernel,most,lanes", _by_kernel([((2, 4), "2-4"), ((1, 1), "1-1")]))
    def test_wrapper_passes_the_lanes_of_its_row_count(self, monkeypatch, kernel, most, lanes):
        """The lanes the wrapper gives the C entry, at 2 rows with its
        crossover moved to 2 (four lanes) and to 1 (one)."""
        seen = []
        monkeypatch.setattr(blake2b, CROSSOVERS[kernel], most)
        monkeypatch.setattr(blake2b, "runs_plain", lambda name, device: False)
        monkeypatch.setattr(blake2b, "_launch", lambda name, args, n, device: seen.append((name, args[3:], n)))
        if LANE_KERNELS[kernel] is None:
            blocks, n_blocks, lengths = pack.pad_blake2b(_messages([300, 700], seed=24))
            blake2b.blake2b256_blocks(_t(blocks), _t(n_blocks), _t(lengths))
            assert seen == [("blake2b256_blocks", [2, blocks.shape[1], lanes], 2)]
            return
        _, arrays, _ = _split_args(kernel, [100, 0], seed=24)
        getattr(blake2b, kernel)(*(_t(a[:2]) for a in arrays))
        assert seen == [(kernel, [2, lanes], 2)]

    @pytest.mark.parametrize("kernel,lanes", _by_kernel([((lanes,), str(lanes)) for lanes in (0, 2, 32)]))
    def test_other_lanes_raise(self, kernel, lanes):
        if LANE_KERNELS[kernel] is None:
            args = pack.pad_blake2b(_messages([300], seed=25))
        else:
            _, args, _ = _split_args(kernel, [100], seed=25)
        with pytest.raises(ValueError, match="lanes"):
            _on_lanes(kernel, *(_t(a) for a in args), lanes=lanes)


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


class TestSmokeLaneBookkeeping:
    """What ``chip_smoke.py`` reports beside the lanes: which kernel
    instantiation a call runs (the SASS counts' keys) and the row counts of
    the paths' launches."""

    @pytest.mark.parametrize("mangled,key", [
        ("_ZN12_GLOBAL__N_117blake2b256_kernelINS_11SplitPlanesEEEvT_PKiS4_xiPm", "SplitPlanes"),
        ("_ZN12_GLOBAL__N_117blake2b256_kernelINS_12PaddedBlocksEEEvT_PKiS4_xiPm", "PaddedBlocks"),
        ("_ZN12_GLOBAL__N_122blake2b256_quad_kernelINS_11SplitPlanesEEEvT_PKiS4_xiPm", "quad<SplitPlanes>"),
        ("_ZN12_GLOBAL__N_122blake2b256_quad_kernelINS_12PaddedBlocksEEEvT_PKiS4_xiPm", "quad<PaddedBlocks>"),
    ], ids=["split", "padded", "quad-split", "quad-padded"])
    def test_each_instantiation_has_its_own_sass_key(self, mangled, key):
        import chip_smoke

        assert chip_smoke._b2b_instantiation(mangled) == key
        assert key in chip_smoke.B2B_LANES

    @pytest.mark.parametrize("kernel", list(LANE_KERNELS), ids=["blocks", "single", "two"])
    def test_the_instantiation_follows_the_lanes_picked(self, kernel):
        import chip_smoke

        loader = "PaddedBlocks" if kernel == "blake2b256_blocks" else "SplitPlanes"
        most = blake2b.quad_rows_max(kernel)
        assert chip_smoke.b2b_instantiation(most, kernel) == f"quad<{loader}>"
        assert chip_smoke.b2b_instantiation(most + 1, kernel) == loader

    def test_launch_rows_add_up_by_path(self, monkeypatch):
        """Rows recorded per path between a reset and a read, binned by
        powers of two; a path whose counts came from elsewhere (a child
        process) is named as unseen, not guessed."""
        import chip_smoke

        def counted(name, args, n, device):  # the wrapper's counting, no kernel
            blake2b.LAUNCHES[name] += 1
            blake2b.ROWS[name] += n

        monkeypatch.setattr(blake2b, "_launch", counted)
        monkeypatch.setattr(blake2b, "runs_plain", lambda name, device: False)
        monkeypatch.setattr(chip_smoke, "_rows_behind", [])
        chip_smoke.record_launch_rows()

        def launch(rows):
            _, arrays, _ = _split_args("blake2b256_single_block", [5] * rows, seed=rows)
            blake2b.blake2b256_single_block(*(_t(a[:rows]) for a in arrays))

        chip_smoke._reset_counts()
        launch(300)
        launch(256)
        launch(2048)
        first = chip_smoke._counts()
        chip_smoke._reset_counts()
        launch(1)
        second = chip_smoke._counts()
        chip_smoke._reset_counts()
        paths = {"a": first, "b": second, "child": {"blake2b256_single_block": 4, "blake2b256_two_block": 0}}
        got = chip_smoke.launch_rows_by_path(paths, ["blake2b256_single_block", "blake2b256_two_block"])
        assert got["blake2b256_single_block"] == {
            "launches": 8, "recorded": 4, "unseen": {"child": 4},
            "bins": {"1-1": 1, "256-511": 2, "2048-4095": 1},
            "rows": {"1": 1, "256": 1, "300": 1, "2048": 1},
        }
        assert got["blake2b256_two_block"] == {"launches": 0, "recorded": 0, "unseen": {}, "bins": {}, "rows": {}}
        # the recorded rows are held to the wrapper's own ROWS
        launch(7)
        blake2b.ROWS["blake2b256_single_block"] += 1
        third = chip_smoke._counts()
        chip_smoke._reset_counts()
        with pytest.raises(AssertionError, match="ROWS counted 8"):
            chip_smoke.launch_rows_by_path({"c": third}, ["blake2b256_single_block"])
