"""The port's device mesh and batch match pipeline against the JAX package.

The JAX reference runs under ``JAX_PLATFORMS=cpu`` with its 8 virtual
devices (``tests/conftest.py``); the port's meshes are explicit CPU device
lists (``[torch.device("cpu")] * n``), which run every block, gather and
reduce of the sharded code on the host. Results compare bit for bit:
masks, hits, counts, digests, bundle JSON.

- `make_mesh` shapes and errors; `synthetic_event_batch` arrays;
  `match_pipeline` with and without the actor filter; the sharded pipeline
  at meshes (1,1), (2,2), (4,2), (8,1) against the reference's (4,2) mesh;
  its blocks writing into the whole mesh's outputs at (dp, sp) (1,1),
  (2,1), (1,2), (2,2) and E 1, 3, 4, 33 a block against the reference's
  sharded pipeline on the same mesh shape (no ``torch.cat`` or
  ``torch.stack``), blocks of another device copied and combined, and an
  empty world;
- `receipts_with_match`, ids outside [0, num) included; the fingerprint
  mask sharded over port meshes
  against the reference's mesh branch; the full-word mask sharded (rows
  split, exact length) against the reference's unsharded mask;
- `MatchCoalescer` under a mesh: the mask layer alone pads (once, to a
  mesh-divisible bucket), filler rows never match, and coalesced requests
  get back their unpadded masks (after ``tests/test_onchip_shard.py``);
- `get_backend` mesh variants; the range drivers with a mesh backend
  (storage specs too) against ``TpuBackend(mesh=make_mesh(8, 2))``;
- `measure_pass_seconds`, `blake2b_cid_bench_setup`, `entry` and
  `dryrun_multichip` over four CPU devices.
"""

import hashlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from ipc_proofs_tpu.backend.tpu import TpuBackend  # noqa: E402
from ipc_proofs_tpu.fixtures import build_range_world as ref_build_range_world  # noqa: E402
from ipc_proofs_tpu.ops import match_jax  # noqa: E402
from ipc_proofs_tpu.parallel import mesh as ref_mesh_mod  # noqa: E402
from ipc_proofs_tpu.parallel import pipeline as ref_pipeline  # noqa: E402
from ipc_proofs_tpu.proofs.generator import EventProofSpec as RefSpec  # noqa: E402
from ipc_proofs_tpu.proofs.range import generate_event_proofs_for_range as ref_generate  # noqa: E402
from ipc_proofs_tpu.proofs.scan_native import match_mask_fp_np  # noqa: E402
from ipc_proofs_tpu.proofs.storage_batch import MappingSlotSpec as RefSlotSpec  # noqa: E402
from ipc_proofs_tpu_torch.backend import get_backend  # noqa: E402
from ipc_proofs_tpu_torch.backend.gpu import GpuBackend  # noqa: E402
from ipc_proofs_tpu_torch.fixtures import build_range_world  # noqa: E402
from ipc_proofs_tpu_torch.ops import blake2b, match  # noqa: E402
from ipc_proofs_tpu_torch.ops.cid_bench import blake2b_cid_bench_setup  # noqa: E402
from ipc_proofs_tpu_torch.parallel import (  # noqa: E402
    EventBatch,
    Mesh,
    make_mesh,
    match_pipeline,
    sharded_match_pipeline,
    synthetic_event_batch,
)
from ipc_proofs_tpu_torch.parallel.pipeline import MatchCoalescer, _MatchReq, batch_args, make_specs_u32  # noqa: E402
from ipc_proofs_tpu_torch.proofs.generator import EventProofSpec  # noqa: E402
from ipc_proofs_tpu_torch.proofs.range import (  # noqa: E402
    generate_and_verify_range_overlapped,
    generate_event_proofs_for_range,
    generate_event_proofs_for_range_pipelined,
)
from ipc_proofs_tpu_torch.proofs.scan_native import topic_fingerprint  # noqa: E402
from ipc_proofs_tpu_torch.proofs.storage_batch import MappingSlotSpec  # noqa: E402
from ipc_proofs_tpu_torch.proofs.trust import TrustPolicy  # noqa: E402
from ipc_proofs_tpu_torch.proofs.verifier import verify_proof_bundle  # noqa: E402
from ipc_proofs_tpu_torch.state.events import ascii_to_bytes32, hash_event_signature  # noqa: E402
from ipc_proofs_tpu_torch.utils.metrics import Metrics  # noqa: E402
from ipc_proofs_tpu_torch.utils.timing import PassTime, measure_pass_seconds  # noqa: E402

CPU = torch.device("cpu")
SIG = "NewTopDownMessage(bytes32,uint256)"
SUBNET = "calib-subnet-1"
ACTOR = 1001
T0 = hash_event_signature(SIG)
T1 = ascii_to_bytes32("subnet-x")


def _cpu_mesh(n: int, sp: int = 1) -> Mesh:
    return make_mesh(n, sp=sp, devices=[CPU] * n)


def _batch(t=8, r=4, e=4, rate=0.25, seed=3) -> EventBatch:
    return synthetic_event_batch(t, r, e, T0, T1, emitter=ACTOR, match_rate=rate, seed=seed)


def _ref_args(batch, actor):
    spec0, spec1 = ref_pipeline.make_specs_u32(T0, T1)
    return (
        jnp.asarray(batch.topics), jnp.asarray(batch.n_topics), jnp.asarray(batch.emitters),
        jnp.asarray(batch.valid), jnp.asarray(spec0), jnp.asarray(spec1),
        jnp.int32(-1 if actor is None else actor),
    )


def _np(out):
    hits, mask, count = out
    return np.asarray(hits), np.asarray(mask), int(count)


def _assert_same(port, ref):
    (h, m, c), (rh, rm, rc) = _np(port), _np(ref)
    assert h.dtype == bool and m.dtype == bool
    np.testing.assert_array_equal(h, rh)
    np.testing.assert_array_equal(m, rm)
    assert c == rc


# --- the mesh ------------------------------------------------------------------


class TestMesh:
    def test_shapes_like_the_reference(self):
        for n, sp in ((8, 2), (4, 1), (8, 1), (1, 1)):
            ours, ref = _cpu_mesh(n, sp), ref_mesh_mod.make_mesh(n, sp=sp)
            assert ours.shape == dict(ref.shape)
            assert ours.axis_names == tuple(ref.axis_names) == ("dp", "sp")
            assert ours.size == ref.size == n
            assert len(ours.devices) == n

    def test_errors_like_the_reference(self):
        devices = [CPU] * 8
        for kwargs in (dict(n_devices=8, sp=3), dict(n_devices=9)):
            with pytest.raises(ValueError):
                ref_mesh_mod.make_mesh(**kwargs)
            with pytest.raises(ValueError):
                make_mesh(**kwargs, devices=devices)

    def test_defaults_to_every_device_given(self):
        mesh = make_mesh(sp=2, devices=[CPU] * 6)
        assert mesh.shape == {"dp": 3, "sp": 2}
        assert not mesh.distributed and mesh.process_count == 1

    def test_hashable_and_equal_by_layout(self):
        assert _cpu_mesh(4, 2) == _cpu_mesh(4, 2)
        assert hash(_cpu_mesh(4, 2)) == hash(_cpu_mesh(4, 2))
        assert _cpu_mesh(4, 2) != _cpu_mesh(4, 1)
        assert len({_cpu_mesh(4, 2), _cpu_mesh(4, 2), _cpu_mesh(4, 1)}) == 2

    def test_needs_cuda_without_a_device_list(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh()
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh(1)


# --- the batch and the single-device pipeline ---------------------------------


@pytest.mark.parametrize("seed", [0, 7, 42])
def test_synthetic_event_batch_equals_the_reference(seed):
    ours = synthetic_event_batch(6, 5, 4, T0, T1, emitter=77, match_rate=0.3, seed=seed)
    ref = ref_pipeline.synthetic_event_batch(6, 5, 4, T0, T1, emitter=77, match_rate=0.3, seed=seed)
    for field in ("topics", "n_topics", "emitters", "valid"):
        a, b = getattr(ours, field), getattr(ref, field)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert ours.shape == ref.shape and ours.n_events == ref.n_events
    np.testing.assert_array_equal(np.stack(make_specs_u32(T0, T1)), np.stack(ref_pipeline.make_specs_u32(T0, T1)))


@pytest.mark.parametrize("actor", [None, ACTOR, 999_999], ids=["no-filter", "actor", "other-actor"])
@pytest.mark.parametrize("seed", [3, 11])
def test_match_pipeline_equals_the_reference(actor, seed):
    batch = _batch(t=8, r=4, e=4, rate=0.4, seed=seed)
    # some rows fail the other predicates too
    rng = np.random.default_rng(seed)
    batch.valid[rng.random(batch.shape) < 0.1] = False
    batch.n_topics[rng.random(batch.shape) < 0.1] = 1
    batch.emitters[rng.random(batch.shape) < 0.2] = ACTOR + 1
    port = match_pipeline(*batch_args(batch, T0, T1, actor, CPU))
    ref = ref_pipeline.match_pipeline(*_ref_args(batch, actor))
    _assert_same(port, ref)
    assert port[2].dtype == torch.int32
    if actor == 999_999:
        assert int(port[2]) == 0
    else:
        assert int(port[2]) > 0


# --- the sharded pipeline ---------------------------------------------------------


@pytest.fixture(scope="module")
def ref_sharded():
    """The reference's sharded run over its (dp=4, sp=2) mesh of 8 virtual
    CPU devices, for the actor filter on and off."""
    batch = _batch(t=8, r=4, e=4, rate=0.25, seed=3)
    jitted, shard = ref_pipeline.sharded_match_pipeline(ref_mesh_mod.make_mesh(8, sp=2))
    return batch, {actor: jitted(*shard(batch, T0, T1, actor)) for actor in (None, ACTOR)}


@pytest.mark.parametrize("n,sp", [(1, 1), (4, 2), (8, 2), (8, 1)], ids=["1x1", "2x2", "4x2", "8x1"])
@pytest.mark.parametrize("actor", [None, ACTOR], ids=["no-filter", "actor"])
def test_sharded_pipeline_equals_the_reference_mesh(ref_sharded, n, sp, actor):
    batch, ref = ref_sharded
    mesh = _cpu_mesh(n, sp)
    assert mesh.shape == {"dp": n // sp, "sp": sp}
    fn, shard_batch = sharded_match_pipeline(mesh)
    args = shard_batch(batch, T0, T1, actor)
    assert len(args) == 7 and all(len(a) == n for a in args)
    _assert_same(fn(*args), ref[actor])
    assert int(ref[actor][2]) > 0


def test_shard_batch_places_one_block_per_device():
    batch = _batch(t=8, r=3, e=4)
    fn, shard_batch = sharded_match_pipeline(_cpu_mesh(8, 2))
    topics, n_topics, emitters, valid, spec0, spec1, actor = shard_batch(batch, T0, T1, ACTOR)
    assert [tuple(t.shape) for t in topics] == [(2, 3, 2, 2, 8)] * 8
    # block (d, s) holds tipset rows d and event columns s
    np.testing.assert_array_equal(topics[3].numpy().view(np.uint32), batch.topics[2:4, :, 2:4])
    np.testing.assert_array_equal(valid[4].numpy(), batch.valid[4:6, :, 0:2])
    assert all(int(a) == ACTOR for a in actor)
    assert all(torch.equal(s, spec0[0]) for s in spec0)


@pytest.mark.parametrize("shape", [(6, 4, 4), (8, 4, 3)], ids=["tipsets", "events"])
def test_sharded_pipeline_refuses_uneven_blocks(shape):
    _, shard_batch = sharded_match_pipeline(_cpu_mesh(8, 2))
    with pytest.raises(ValueError, match="divide"):
        shard_batch(_batch(*shape), T0, T1, ACTOR)


# --- the blocks' writes into the whole mesh's outputs ---------------------------------

# (dp, sp) meshes, and the events a receipt of one block holds
BLOCK_MESHES = [(1, 1), (2, 1), (1, 2), (2, 2)]
BLOCK_EVENTS = [1, 3, 4, 33]
_ref_sharded_fns: dict = {}


def _ref_sharded_run(batch, dp: int, sp: int, actor):
    """The JAX package's sharded pipeline over its (dp, sp) mesh of
    virtual CPU devices (one jit per mesh, kept)."""
    if (dp, sp) not in _ref_sharded_fns:
        _ref_sharded_fns[dp, sp] = ref_pipeline.sharded_match_pipeline(ref_mesh_mod.make_mesh(dp * sp, sp=sp))
    jitted, shard = _ref_sharded_fns[dp, sp]
    return jitted(*shard(batch, T0, T1, actor))


def _edge_batch(t: int, r: int, e: int, seed: int) -> EventBatch:
    """Planted matches, and rows failing each other predicate."""
    batch = _batch(t=t, r=r, e=e, rate=0.5, seed=seed)
    rng = np.random.default_rng(seed)
    batch.valid[rng.random(batch.shape) < 0.1] = False
    batch.n_topics[rng.random(batch.shape) < 0.1] = 1
    batch.emitters[rng.random(batch.shape) < 0.2] = ACTOR + 1
    return batch


def _refuse(*args, **kwargs):
    raise AssertionError("the combine ran a PyTorch concatenation or stack")


@pytest.mark.parametrize("dp,sp", BLOCK_MESHES, ids=[f"{dp}x{sp}" for dp, sp in BLOCK_MESHES])
@pytest.mark.parametrize("e", BLOCK_EVENTS, ids=[f"E{e}" for e in BLOCK_EVENTS])
@pytest.mark.parametrize("actor", [None, ACTOR], ids=["no-filter", "actor"])
def test_sharded_pipeline_writes_blocks_into_the_mesh_outputs(monkeypatch, dp, sp, e, actor):
    """On one device every block writes its mask slice, its hits (stored
    by a row's first block, ORed by the rest) and its count (stored by the
    first block, added by the rest) into the whole mesh's outputs: no
    ``torch.cat`` or ``torch.stack``, and the result equals the JAX
    package's sharded and single-device pipelines."""
    batch = _edge_batch(2 * dp, 8, sp * e, seed=10 * dp + sp + e)
    fn, shard_batch = sharded_match_pipeline(_cpu_mesh(dp * sp, sp))
    args = shard_batch(batch, T0, T1, actor)
    monkeypatch.setattr(torch, "cat", _refuse)
    monkeypatch.setattr(torch, "stack", _refuse)
    got = fn(*args)
    monkeypatch.undo()
    _assert_same(got, _ref_sharded_run(batch, dp, sp, actor))
    _assert_same(got, ref_pipeline.match_pipeline(*_ref_args(batch, actor)))
    assert int(got[2]) > 0 and not bool(got[0].all())


@pytest.mark.parametrize("dp,sp", BLOCK_MESHES[1:], ids=[f"{dp}x{sp}" for dp, sp in BLOCK_MESHES[1:]])
@pytest.mark.parametrize("e", [1, 33], ids=["E1", "E33"])
def test_sharded_pipeline_combines_blocks_of_another_device(dp, sp, e):
    """Blocks whose mesh device is not the first one's (here
    ``torch.device("cpu", 0)`` beside ``torch.device("cpu")``) compute
    their own outputs, which are copied over and combined: the same
    result as the JAX package."""
    n = dp * sp
    devices = [CPU if k % 2 == 0 else torch.device("cpu", 0) for k in range(n)]
    batch = _edge_batch(2 * dp, 5, sp * e, seed=n + e)
    fn, shard_batch = sharded_match_pipeline(make_mesh(n, sp=sp, devices=devices))
    got = fn(*shard_batch(batch, T0, T1, ACTOR))
    _assert_same(got, _ref_sharded_run(batch, dp, sp, ACTOR))


@pytest.mark.parametrize("shape", [(0, 5, 4), (2, 0, 4), (2, 5, 0)], ids=["no-tipsets", "no-receipts", "no-events"])
def test_sharded_pipeline_on_an_empty_world(shape):
    """A (2, 2) mesh over an empty world: outputs of the world's shape,
    no hit and a count of 0, as the JAX package's pipeline gives."""
    t, r, e = shape
    batch = EventBatch(
        topics=np.zeros((t, r, e, 2, 8), np.uint32), n_topics=np.full(shape, 2, np.int32),
        emitters=np.full(shape, ACTOR, np.int32), valid=np.ones(shape, bool),
    )
    fn, shard_batch = sharded_match_pipeline(_cpu_mesh(4, 2))
    hits, mask, count = fn(*shard_batch(batch, T0, T1, ACTOR))
    assert tuple(hits.shape) == (t, r) and tuple(mask.shape) == shape
    _assert_same((hits, mask, count), ref_pipeline.match_pipeline(*_ref_args(batch, ACTOR)))
    assert int(count) == 0


# --- receipts_with_match and the sharded fingerprint mask -------------------------


@pytest.mark.parametrize("ids_from", ["in-range", "wrapped-and-dropped"])
@pytest.mark.parametrize("id_dtype", [np.int32, np.int64], ids=["int32", "int64"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_receipts_with_match_equals_the_reference(seed, id_dtype, ids_from):
    """Ids in [0, num), and ids over [-2·num, 2·num): the reference's
    ``.at[ids].add`` wraps an id in [-num, 0) to id + num and drops any
    other id outside [0, num)."""
    rng = np.random.default_rng(seed)
    n, num_receipts = 500, 40
    mask = rng.random(n) < (0.05 if ids_from == "in-range" else 0.3)
    low, high = (0, num_receipts) if ids_from == "in-range" else (-2 * num_receipts, 2 * num_receipts)
    ids = rng.integers(low, high, size=n).astype(id_dtype)
    ours = match.receipts_with_match(torch.from_numpy(mask), torch.from_numpy(ids), num_receipts)
    ref = match_jax.receipts_with_match(jnp.asarray(mask), jnp.asarray(ids.astype(np.int32)), num_receipts)
    assert ours.dtype == torch.bool and ours.shape == (num_receipts,)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    assert ours.any() and not ours.all()


@pytest.mark.parametrize("mask,ids,want", [
    ([1, 1, 1, 0], [5, -1, 1, 0], [0, 1, 0, 1]),
    ([1, 1, 0, 0], [-5, -4, 1, 0], [1, 0, 0, 0]),
    ([1, 1], [4, -5], [0, 0, 0, 0]),
    ([], [], [0, 0, 0, 0]),
], ids=["past-the-end-and-minus-one", "below-minus-num", "all-dropped", "no-events"])
def test_receipts_with_match_wraps_and_drops_as_the_reference(mask, ids, want):
    mask, ids = np.array(mask, dtype=bool), np.array(ids, dtype=np.int32)
    ours = match.receipts_with_match(torch.from_numpy(mask), torch.from_numpy(ids), 4)
    ref = match_jax.receipts_with_match(jnp.asarray(mask), jnp.asarray(ids), 4)
    np.testing.assert_array_equal(np.asarray(ref), np.array(want, dtype=bool))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_pad_to_bucket_equals_the_reference():
    for n in (0, 1, 255, 256, 257, 1000, 4096, 5000):
        assert match.pad_to_bucket(n) == match_jax.pad_to_bucket(n)
        assert match.pad_to_bucket(n, minimum=8) == match_jax.pad_to_bucket(n, minimum=8)


def _fp_arrays(n: int, seed: int, match_rate: float = 0.1):
    rng = np.random.default_rng(seed)
    fp = rng.integers(0, 1 << 63, size=n, dtype=np.uint64)
    fp[rng.random(n) < match_rate] = np.uint64(topic_fingerprint(T0, T1))
    n_topics = rng.integers(0, 4, size=n).astype(np.int32)
    emitters = rng.integers(ACTOR - 2, ACTOR + 3, size=n).astype(np.int64)
    valid = rng.random(n) < 0.9
    return fp, n_topics, emitters, valid


@pytest.mark.parametrize("n", [1, 5, 255, 256, 257, 1000])
@pytest.mark.parametrize("actor", [None, ACTOR], ids=["no-filter", "actor"])
def test_sharded_fp_mask_equals_the_reference_mesh(n, actor):
    fp, n_topics, emitters, valid = _fp_arrays(n, seed=n)
    target = topic_fingerprint(T0, T1)
    ref = np.asarray(
        match_jax.event_match_mask_fp_jit(
            fp, n_topics, emitters, valid, target, actor, mesh=ref_mesh_mod.make_mesh(8, sp=2)
        )
    )
    for mesh in (_cpu_mesh(8, 2), _cpu_mesh(3), _cpu_mesh(1)):
        ours = match.event_match_mask_fp(fp, n_topics, emitters, valid, target, actor, CPU, mesh=mesh)
        assert len(ours) % mesh.size == 0 and len(ours) >= n
        np.testing.assert_array_equal(ours[:n], ref[:n])
        assert not ours[n:].any()
    assert np.array_equal(ref[:n], match_mask_fp_np(fp, n_topics, emitters, valid, T0, T1, actor)[:n])


def test_sharded_fp_mask_fn_is_cached_per_mesh_and_splits_evenly():
    mesh = _cpu_mesh(4)
    fn = match.sharded_fp_mask_fn(mesh)
    assert match.sharded_fp_mask_fn(_cpu_mesh(4)) is fn
    assert match.sharded_fp_mask_fn(_cpu_mesh(2)) is not fn
    f = np.arange(8, dtype=np.int64)
    assert fn(f, np.ones(8, bool), 5).tolist() == [i == 5 for i in range(8)]
    with pytest.raises(ValueError, match="split"):
        fn(f[:7], np.ones(7, bool), 5)


def test_mesh_backend_runs_the_sharded_mask():
    """A meshed backend's fingerprint mask equals the single-device mask in
    its first N rows, on the padded length."""
    fp, n_topics, emitters, valid = _fp_arrays(300, seed=9, match_rate=0.3)
    single = get_backend("gpu", device="cpu")
    meshed = GpuBackend("cpu", mesh=_cpu_mesh(4, 2))
    want = single.event_match_mask_fp(fp, n_topics, emitters, valid, T0, T1, ACTOR)
    got = meshed.event_match_mask_fp(fp, n_topics, emitters, valid, T0, T1, ACTOR)
    assert len(want) == 300 and len(got) == 512
    np.testing.assert_array_equal(got[:300], want)
    assert meshed.device == CPU and single.mesh is None


def _topic_arrays(n: int, seed: int):
    """Flat event arrays with about a third planted matches, near misses
    (one topic1 word flipped), single-topic and invalid rows and other
    emitters."""
    rng = np.random.default_rng(seed)
    topics = rng.integers(0, 1 << 32, (n, 2, 8), dtype=np.uint64).astype(np.uint32)
    kind = rng.integers(0, 6, n)
    topics[kind <= 3, 0] = np.frombuffer(T0, "<u4")
    topics[kind <= 3, 1] = np.frombuffer(T1, "<u4")
    topics[kind == 3, 1, 0] ^= 1
    n_topics = np.where(kind == 2, 1, 2).astype(np.int32)
    emitters = np.where(kind == 1, ACTOR + 1, ACTOR).astype(np.int64)
    valid = kind != 4
    return topics, n_topics, emitters, valid


@pytest.mark.parametrize("n", [1, 3, 5, 257])
@pytest.mark.parametrize("n_devices", [1, 3, 8])
@pytest.mark.parametrize("actor", [None, ACTOR], ids=["no-filter", "actor"])
def test_sharded_flat_mask_equals_the_reference(n, n_devices, actor):
    """The full-word mask over a mesh splits its rows over every device
    (blocks uneven, fewer rows than devices leave some empty) and keeps
    the input's length; it equals the reference's unsharded mask."""
    topics, n_topics, emitters, valid = _topic_arrays(n, seed=n)
    ref = np.asarray(
        match_jax.event_match_mask_jit(
            topics, n_topics, emitters, valid, np.frombuffer(T0, "<u4"), np.frombuffer(T1, "<u4"), actor
        )
    )[:n]
    ours = match.event_match_mask_flat(
        topics, n_topics, emitters, valid, T0, T1, actor, CPU, mesh=_cpu_mesh(n_devices)
    )
    assert ours.dtype == bool and ours.shape == (n,)
    np.testing.assert_array_equal(ours, ref)


def test_mesh_backend_shards_the_full_word_mask(monkeypatch):
    """A meshed backend's `event_match_mask` (the Python walk's mask) runs
    one block per mesh device and returns the single-device mask."""
    seen: list = []
    real = match._topic_mask

    def spy(topics, *args):
        seen.append(len(topics))
        return real(topics, *args)

    topics, n_topics, emitters, valid = _topic_arrays(10, seed=4)
    single = get_backend("gpu", device="cpu").event_match_mask_flat(
        topics, n_topics, emitters, valid, T0, T1, ACTOR
    )
    monkeypatch.setattr(match, "_topic_mask", spy)
    got = GpuBackend("cpu", mesh=_cpu_mesh(4, 2)).event_match_mask_flat(
        topics, n_topics, emitters, valid, T0, T1, ACTOR
    )
    assert seen == [3, 3, 2, 2]
    np.testing.assert_array_equal(got, single)
    assert single.any() and not single.all()


# --- the coalescer under a mesh -------------------------------------------------------


def _mesh_backend(n: int = 4, sp: int = 2) -> GpuBackend:
    return GpuBackend("cpu", mesh=_cpu_mesh(n, sp))


def _padded(n: int, mesh_size: int) -> int:
    bucket = match.pad_to_bucket(n)
    return bucket + (-bucket) % mesh_size


class _SpyBackend:
    """A backend that records the length of every fingerprint-mask call and
    of every mask it returns."""

    def __init__(self, backend):
        self.backend = backend
        self.calls: list = []
        self.masks: list = []

    def event_match_mask_fp(self, fp, *args):
        self.calls.append(len(fp))
        self.masks.append(self.backend.event_match_mask_fp(fp, *args))
        return self.masks[-1]


class TestCoalescerUnderAMesh:
    def test_coalescer_identical_to_direct_call(self):
        co = MatchCoalescer(_mesh_backend(), metrics=Metrics())
        for n in (1, 37, 300):
            fp, n_topics, emitters, valid = _fp_arrays(n, seed=n)
            got = np.asarray(co.match_fp(fp, n_topics, emitters, valid, T0, T1, ACTOR))[:n]
            want = match_mask_fp_np(fp, n_topics, emitters, valid, T0, T1, ACTOR)[:n]
            assert np.array_equal(got, want)

    @pytest.mark.parametrize("n_devices,sp", [(4, 2), (3, 1), (6, 2)])
    def test_the_mask_layer_alone_pads_once(self, n_devices, sp, monkeypatch):
        """The coalescer hands the backend its requests at their own length;
        the mesh mask pads each call once, to `pad_to_bucket` rounded up to
        the mesh's size (on 3 devices 256 → 258, not 513), and the
        coalescer's results are the unpadded mask's."""
        spy = _SpyBackend(_mesh_backend(n_devices, sp))
        sharded: list = []
        real = match.sharded_fp_mask_fn

        def sharded_spy(mesh):
            fn = real(mesh)

            def wrapped(f, *args):
                sharded.append(len(f))
                return fn(f, *args)

            return wrapped

        monkeypatch.setattr(match, "sharded_fp_mask_fn", sharded_spy)
        co = MatchCoalescer(spy, metrics=Metrics())
        plain = get_backend("gpu", device="cpu")
        sizes = (1, 7, 200, 300, 513)
        for n in sizes:
            fp, n_topics, emitters, valid = _fp_arrays(n, seed=n)
            got = np.asarray(co.match_fp(fp, n_topics, emitters, valid, T0, T1, None))
            np.testing.assert_array_equal(
                got[:n], plain.event_match_mask_fp(fp, n_topics, emitters, valid, T0, T1, None)
            )
        assert spy.calls == list(sizes)
        assert sharded == [_padded(n, n_devices) for n in sizes]

    def test_coalesced_requests_get_their_unpadded_masks(self):
        """Three requests parked together go to the mesh mask as one call;
        each gets back its own rows, equal to its mask alone."""
        m = Metrics()
        spy = _SpyBackend(_mesh_backend(3, 1))
        co = MatchCoalescer(spy, metrics=m)
        plain = get_backend("gpu", device="cpu")
        reqs, wants = [], []
        for n, seed in ((5, 1), (200, 2), (61, 3)):
            arrays = _fp_arrays(n, seed=seed, match_rate=0.3)
            reqs.append(_MatchReq(*arrays, (T0, T1, ACTOR)))
            wants.append(plain.event_match_mask_fp(*arrays, T0, T1, ACTOR))
        co._run(reqs)
        assert spy.calls == [266] and len(spy.masks[0]) == _padded(266, 3)
        assert not spy.masks[0][266:].any()
        for req, want in zip(reqs, wants):
            assert req.exc is None and req.done.is_set()
            np.testing.assert_array_equal(np.asarray(req.result), want)
        assert m.counter_value("range_match_coalesced") == 2

    def test_padding_rows_never_match(self):
        """Every row of the request matches; the mask's filler rows
        (valid=False zeros, here up to the 256 bucket) never do, and the
        request gets back its own rows."""
        spy = _SpyBackend(_mesh_backend())
        co = MatchCoalescer(spy, metrics=Metrics())
        n = 10
        fp = np.full(n, np.uint64(topic_fingerprint(T0, T1)), dtype=np.uint64)
        n_topics = np.full(n, 2, dtype=np.int32)
        emitters = np.full(n, ACTOR, dtype=np.int64)
        valid = np.ones(n, dtype=bool)
        got = np.asarray(co.match_fp(fp, n_topics, emitters, valid, T0, T1, ACTOR))
        assert len(got) == n and got.all()
        [full] = spy.masks
        assert len(full) == 256 and full[:n].all() and not full[n:].any()

    def test_no_mesh_dispatches_unpadded(self):
        m = Metrics()
        co = MatchCoalescer(get_backend("gpu", device="cpu"), metrics=m)
        fp, n_topics, emitters, valid = _fp_arrays(37, seed=1)
        assert len(co.match_fp(fp, n_topics, emitters, valid, T0, T1, None)) == 37
        assert m.counter_value("range_match_coalesced") == 0


# --- the backend registry -----------------------------------------------------------


class TestBackendRegistry:
    def test_mesh_variant_caches_separately(self):
        plain = get_backend("gpu", device="cpu")
        meshed = get_backend("gpu", device="cpu", mesh_devices=4)
        assert plain is not meshed
        assert plain.mesh is None
        assert meshed.mesh.size == 4 and meshed.mesh.devices == [CPU] * 4
        assert get_backend("gpu", device="cpu", mesh_devices=4) is meshed  # cached
        assert get_backend("gpu", device="cpu", mesh_devices=2) is not meshed
        assert meshed.device == CPU

    def test_cpu_mesh_needs_a_device(self):
        with pytest.raises(ValueError, match="mesh_devices"):
            get_backend("gpu", device="cpu", mesh_devices=0)

    def test_mesh_on_the_card_needs_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        for n in (0, 1, 2):
            with pytest.raises(RuntimeError, match="CUDA"):
                get_backend("gpu", mesh_devices=n)

    def test_backend_mesh_defaults_its_device(self):
        backend = GpuBackend(mesh=_cpu_mesh(2))
        assert backend.device == CPU and backend.mesh.size == 2


# --- the range drivers with a mesh backend ----------------------------------------------


WORLD = dict(n_pairs=16, receipts_per_pair=4, events_per_receipt=4, match_rate=0.25)
SPEC = EventProofSpec(SIG, SUBNET, ACTOR)


@pytest.fixture(scope="module")
def ref_mesh_bundles():
    """The reference's range bundles with ``TpuBackend(mesh=make_mesh(8,
    2))``, without and with the topdown nonce slot at every pair."""
    store, pairs, n_matching = ref_build_range_world(**WORLD)
    backend = TpuBackend(mesh=ref_mesh_mod.make_mesh(8, sp=2))
    spec = RefSpec(SIG, SUBNET, ACTOR)
    events = ref_generate(store, pairs, spec, match_backend=backend)
    mixed = ref_generate(
        store, pairs, spec, match_backend=backend, storage_specs=[RefSlotSpec(ACTOR, SUBNET, 0)]
    )
    return n_matching, events.to_json(), mixed.to_json()


@pytest.fixture(scope="module")
def port_world():
    return build_range_world(**WORLD)


@pytest.mark.parametrize("n,sp", [(8, 2), (4, 1), (1, 1)], ids=["4x2", "4x1", "1x1"])
@pytest.mark.parametrize("storage", [False, True], ids=["events", "with-storage"])
def test_range_bundle_with_a_mesh_equals_the_reference(ref_mesh_bundles, port_world, n, sp, storage):
    n_matching, ref_events, ref_mixed = ref_mesh_bundles
    store, pairs, _ = port_world
    specs = [MappingSlotSpec(ACTOR, SUBNET, 0)] if storage else None
    backend = GpuBackend("cpu", mesh=_cpu_mesh(n, sp))
    bundle = generate_event_proofs_for_range(store, pairs, SPEC, match_backend=backend, storage_specs=specs)
    assert bundle.to_json() == (ref_mixed if storage else ref_events)
    assert len(bundle.event_proofs) == n_matching > 0
    if storage:
        assert len(bundle.storage_proofs) == len(pairs)
    single = generate_event_proofs_for_range(
        store, pairs, SPEC, match_backend=get_backend("gpu", device="cpu"), storage_specs=specs
    )
    assert single.to_json() == bundle.to_json()


def test_mesh_turns_the_fused_scan_off(port_world, monkeypatch):
    """Under a mesh the range driver takes the unfused scan and the sharded
    fingerprint mask, as the reference does."""
    store, pairs, _ = port_world
    calls = []
    real = match.sharded_fp_mask_fn

    def spy(mesh):
        fn = real(mesh)

        def wrapped(*args):
            calls.append(len(args[0]))
            return fn(*args)

        return wrapped

    monkeypatch.setattr(match, "sharded_fp_mask_fn", spy)
    generate_event_proofs_for_range(store, pairs, SPEC, match_backend=GpuBackend("cpu", mesh=_cpu_mesh(4, 2)))
    assert calls and all(n % 4 == 0 for n in calls)


def _spy_sharded_fp(monkeypatch) -> list:
    """Record the row count of every sharded fingerprint-mask call."""
    calls: list = []
    real = match.sharded_fp_mask_fn

    def spy(mesh):
        fn = real(mesh)

        def wrapped(*args):
            calls.append((len(args[0]), mesh.size))
            return fn(*args)

        return wrapped

    monkeypatch.setattr(match, "sharded_fp_mask_fn", spy)
    return calls


@pytest.mark.parametrize("storage", [False, True], ids=["events", "with-storage"])
def test_pipelined_driver_over_a_mesh_at_one_scan_worker(ref_mesh_bundles, port_world, storage, monkeypatch):
    """With one scan worker the pipelined driver calls a meshed backend's
    mask directly, which runs sharded on a mesh-divisible length; the bundle
    stays the reference's and nothing coalesces."""
    _, ref_events, ref_mixed = ref_mesh_bundles
    store, pairs, _ = port_world
    specs = [MappingSlotSpec(ACTOR, SUBNET, 0)] if storage else None
    calls = _spy_sharded_fp(monkeypatch)
    m = Metrics()
    got = generate_event_proofs_for_range_pipelined(
        store, pairs, SPEC, chunk_size=4, match_backend=_mesh_backend(), metrics=m,
        scan_threads=1, force_pipeline=True, storage_specs=specs,
    ).to_json()
    assert got == (ref_mixed if storage else ref_events)
    assert calls and all(n % size == 0 for n, size in calls)
    assert m.counter_value("range_match_coalesced") == 0


def test_overlapped_driver_over_a_mesh(ref_mesh_bundles, port_world, monkeypatch):
    _, _, ref_mixed = ref_mesh_bundles
    calls = _spy_sharded_fp(monkeypatch)
    store, pairs, n_matching = port_world
    cpu = get_backend("gpu", device="cpu")
    m = Metrics()
    merged, verdicts = generate_and_verify_range_overlapped(
        store, pairs, SPEC, chunk_size=4, match_backend=_mesh_backend(8, 2), metrics=m,
        storage_specs=[MappingSlotSpec(ACTOR, SUBNET, 0)], scan_threads=2, force_pipeline=True,
        verify_chunk=lambda b: verify_proof_bundle(
            b, TrustPolicy.accept_all(), verify_witness_cids=True, cid_backend=cpu
        ).event_results,
    )
    assert merged.to_json() == ref_mixed
    assert [v for chunk in verdicts for v in chunk] == [True] * n_matching
    assert calls and all(n % size == 0 for n, size in calls)


# --- slope timing ------------------------------------------------------------------------


def test_measure_pass_seconds_slope():
    x = torch.arange(4096, dtype=torch.int32)
    seen = []

    def body(i, v):
        seen.append(int(i))
        return (v ^ i).sum(dtype=torch.int32)

    pt = measure_pass_seconds(body, (x,), k_small=2, k_large=42, repeats=2, max_k=202)
    assert isinstance(pt, PassTime)
    assert pt.seconds > 0
    assert pt.k_large > pt.k_small == 2
    assert pt.per_pass_ms == pt.seconds * 1e3
    assert seen[:2] == [0, 1]  # i counts the passes
    assert not pt.graph  # the CPU runs its passes eagerly


def test_measure_pass_seconds_escalates_k_large():
    x = torch.zeros(1, dtype=torch.int32)
    pt = measure_pass_seconds(
        lambda i, v: (v + i).sum(dtype=torch.int32), (x,), k_small=1, k_large=3, repeats=1,
        max_k=1 + 2 * 4 * 4, min_delta_s=1e3,
    )
    # delta never reaches 1000 s: k_large escalates (k - k_small) * 4 + k_small up to max_k
    assert pt.k_large == 33


@pytest.mark.parametrize("k_small,k_large", [(0, 5), (5, 5), (6, 5)])
def test_measure_pass_seconds_rejects_bad_k(k_small, k_large):
    with pytest.raises(ValueError, match="k_large > k_small >= 1"):
        measure_pass_seconds(lambda i: i, (), k_small=k_small, k_large=k_large)


# --- the CID bench setup ----------------------------------------------------------------


@pytest.mark.parametrize("size,kernel", [(200, "blake2b256_two_block"), (300, "blake2b256_blocks")])
def test_cid_bench_setup_first_digests(size, kernel):
    from ipc_proofs_tpu.ops.cid_bench import blake2b_cid_bench_setup as ref_setup

    rng = np.random.default_rng(size)
    messages = [rng.integers(0, 256, size=int(n), dtype=np.uint8).tobytes()
                for n in rng.integers(size - 60, size + 1, size=24)]
    one_pass, args, first, name = blake2b_cid_bench_setup(messages, device="cpu")
    assert name == kernel
    assert first.dtype == np.uint32 and first.shape == (len(messages), 8)
    assert [row.astype("<u4").tobytes() for row in first] == [
        hashlib.blake2b(m, digest_size=32).digest() for m in messages
    ]
    _, _, ref_first, _ = ref_setup(messages)
    np.testing.assert_array_equal(first, np.asarray(ref_first)[: len(messages)])
    # pass 0 hashes the input as it is; another i changes the sum
    zero = torch.tensor(0, dtype=torch.int32)
    unperturbed = getattr(blake2b, kernel)(*args).sum(dtype=torch.int32)
    assert int(one_pass(zero, *args)) == int(unperturbed)
    assert int(one_pass(zero + 1, *args)) != int(unperturbed)


def test_cid_bench_setup_needs_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        blake2b_cid_bench_setup([b"x" * 200])


# --- entry and the multi-device dry run ----------------------------------------------


def test_entry_equals_the_reference_entry():
    import __graft_entry__ as graft

    from ipc_proofs_tpu_torch.entry import entry

    fn, args = entry(device="cpu")
    ref_fn, ref_args = graft.entry()
    assert len(args) == len(ref_args) == 7
    for ours, ref in zip(args, ref_args):
        np.testing.assert_array_equal(
            ours.numpy(), np.asarray(ref).view(np.int32) if np.asarray(ref).dtype == np.uint32 else np.asarray(ref)
        )
    _assert_same(fn(*args), ref_fn(*ref_args))


def test_entry_needs_cuda_by_default(monkeypatch):
    from ipc_proofs_tpu_torch.entry import dryrun_multichip, entry

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        entry()
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun_multichip(1)


@pytest.mark.parametrize("n", [4, 3])
def test_dryrun_multichip_over_cpu_devices(n):
    from ipc_proofs_tpu_torch.entry import dryrun_multichip

    out = dryrun_multichip(n, devices=[CPU] * n)
    sp = 2 if n % 2 == 0 else 1
    assert out["mesh"] == {"dp": n // sp, "sp": sp}
    assert out["cids"] == 4 * n and out["matches"] > 0
    assert out["event_proofs"] > 0 and out["storage_proofs"] == 2 * n


def test_dryrun_multichip_refuses_too_few_devices():
    from ipc_proofs_tpu_torch.entry import dryrun_multichip

    with pytest.raises(ValueError, match="requested 4 devices"):
        dryrun_multichip(4, devices=[CPU] * 2)
