"""The plain versions of ``csrc/match.cu``'s four kernels against the JAX
package's device functions, bit for bit, and the wrappers' device rule.

Inputs come from a numpy seed and go to both packages as the same arrays
(u32 words as int32 bit views on the port's side):

- `match_pipeline_plain` against ``parallel/pipeline.py:105``
  ``match_pipeline`` at E in {1, 3, 4, 5, 33}, the actor filter off (-1)
  and on, rows with ``n_topics < 2`` and ``valid`` False, an empty world;
  and writing one block into the interior of a mesh's whole outputs
  (stored, or ORed and added; every other byte kept);
- `topic_mask_plain` against ``ops/match_jax.py:36`` ``_match_mask_topics``
  over flat rows, N = 0 and rows padded to `pad_to_bucket` as
  ``event_match_mask_jit`` pads them, and over the topic0 sweep of
  phase 3a on the card (`chip_smoke.topic0_share`: 0 to 100 % of rows with
  topic0 equal to the spec, some with topic1 one word off) at row counts
  that are not multiples of 2, 4 or 8;
- `fp_mask_plain` against ``ops/match_jax.py:76-81`` ``_match_mask_fp``
  (the reference's [N, 2] u32 fingerprint layout), and against
  ``_match_mask_fp_impl`` over 0 to 100 % of fingerprints equal to the
  target, also from the second row on (the kernel's offset view);
- `receipts_with_match` over ids in [-2·num, 2·num) in
  ``tests/test_torch_parallel.py``;
- `build_native_san`'s guard-band cases of the four entries against the
  same JAX functions, so the card's guard-band run checks reference
  results;
- the wrappers: a device other than the CPU or a card raises, and a kernel
  that cannot be built raises `DeviceFaultError` with no launch counted
  and no plain-version fallback.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from ipc_proofs_tpu.ops import match_jax  # noqa: E402
from ipc_proofs_tpu.parallel import pipeline as ref_pipeline  # noqa: E402
from ipc_proofs_tpu_torch.ops import build, match  # noqa: E402
from ipc_proofs_tpu_torch.parallel import pipeline  # noqa: E402
from ipc_proofs_tpu_torch.state.events import ascii_to_bytes32, hash_event_signature  # noqa: E402
from ipc_proofs_tpu_torch.tools import build_native_san as san  # noqa: E402

T0 = hash_event_signature("NewTopDownMessage(bytes32,uint256)")
T1 = ascii_to_bytes32("calib-subnet-1")
ACTOR = 1001


def _i32(array) -> torch.Tensor:
    return torch.from_numpy(np.array(array).view(np.int32))


def _world(t: int, r: int, e: int, seed: int):
    """A [T, R, E] world with planted matches, near misses (one topic word
    flipped), single-topic rows, invalid rows and other emitters."""
    rng = np.random.default_rng(seed)
    batch = pipeline.synthetic_event_batch(t, r, e, T0, T1, emitter=ACTOR, match_rate=0.5, seed=seed)
    shape = (t, r, e)
    batch.valid[rng.random(shape) < 0.1] = False
    batch.n_topics[rng.random(shape) < 0.1] = rng.integers(0, 2)
    batch.emitters[rng.random(shape) < 0.15] = ACTOR + 1
    near = rng.random(shape) < 0.1
    batch.topics[near, 0] = np.frombuffer(T0, "<u4")
    batch.topics[near, 1] = np.frombuffer(T1, "<u4")
    batch.topics[near, int(rng.integers(0, 2)), int(rng.integers(0, 8))] ^= 1
    return batch


@pytest.mark.parametrize("e", [1, 3, 4, 5, 33])
@pytest.mark.parametrize("actor", [None, ACTOR, 999_999], ids=["actor-1", "actor", "absent-actor"])
def test_match_pipeline_plain_equals_the_reference(e, actor):
    batch = _world(6, 5, e, seed=e)
    args = pipeline.batch_args(batch, T0, T1, actor, "cpu")
    hits, mask, count = pipeline.match_pipeline_plain(*args)
    assert [x.dtype for x in (hits, mask, count)] == [torch.bool, torch.bool, torch.int32]
    spec0, spec1 = ref_pipeline.make_specs_u32(T0, T1)
    ref = ref_pipeline.match_pipeline(
        jnp.asarray(batch.topics), jnp.asarray(batch.n_topics), jnp.asarray(batch.emitters),
        jnp.asarray(batch.valid), jnp.asarray(spec0), jnp.asarray(spec1),
        jnp.int32(-1 if actor is None else actor),
    )
    np.testing.assert_array_equal(hits.numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref[1]))
    assert int(count) == int(ref[2])
    assert (int(count) > 0) == (actor != 999_999)
    # the wrapper reaches the plain version for CPU tensors, and counts nothing
    pipeline.reset_launch_counts()
    for got, want in zip(pipeline.match_pipeline(*args), (hits, mask, count)):
        assert torch.equal(got, want)
    assert pipeline.LAUNCHES == {"match_pipeline": 0}


def _ref_pipeline(batch, actor):
    spec0, spec1 = ref_pipeline.make_specs_u32(T0, T1)
    return tuple(np.asarray(x) for x in ref_pipeline.match_pipeline(
        jnp.asarray(batch.topics), jnp.asarray(batch.n_topics), jnp.asarray(batch.emitters),
        jnp.asarray(batch.valid), jnp.asarray(spec0), jnp.asarray(spec1),
        jnp.int32(-1 if actor is None else actor),
    ))


@pytest.mark.parametrize("e", [1, 3, 4, 33])
@pytest.mark.parametrize("mode", ["stored", "ored-and-added"])
def test_match_pipeline_plain_writes_a_block_into_whole_outputs(e, mode):
    """`match_pipeline` (the plain version on the CPU, what the kernel is
    held against) with a block's place: a block of 2 tipsets at tipset row
    1 and event columns E to 2E of a 4-tipset, 3E-event mesh writes its
    mask slice, its hits (stored, or only its hits set) and its count
    (stored, or added to what the output holds), the JAX package's values
    on the block; every other byte keeps its sentinel."""
    batch = _world(2, 5, e, seed=e + 40)
    ref_hits, ref_mask, ref_count = _ref_pipeline(batch, ACTOR)
    hits = np.full((4, 5), 0xAB, np.uint8)
    mask = np.full((4, 5, 3 * e), 0xCD, np.uint8)
    count = np.array(11, np.int32)
    out = (torch.from_numpy(hits.copy()).view(torch.bool), torch.from_numpy(mask.copy()).view(torch.bool),
           torch.from_numpy(count.copy()))
    combine = mode == "ored-and-added"
    args = pipeline.batch_args(batch, T0, T1, ACTOR, "cpu")
    got = pipeline.match_pipeline(*args, out=out, row0=1, col0=e, or_hits=combine, add_count=combine)
    assert all(g is o for g, o in zip(got, out))
    mask[1:3, :, e : 2 * e] = ref_mask
    if combine:
        hits[1:3][ref_hits] = 1
        count = count + ref_count
    else:
        hits[1:3] = ref_hits
        count = ref_count
    np.testing.assert_array_equal(out[0].view(torch.uint8).numpy(), hits)
    np.testing.assert_array_equal(out[1].view(torch.uint8).numpy(), mask)
    assert int(out[2]) == int(count) and int(ref_count) > 0


@pytest.mark.parametrize("case", ["place-without-outputs", "slice-outside"])
def test_match_pipeline_refuses_a_place_it_cannot_write(case):
    batch = _world(2, 5, 3, seed=4)
    args = pipeline.batch_args(batch, T0, T1, ACTOR, "cpu")
    if case == "place-without-outputs":
        kwargs = dict(row0=1)
    else:
        out = (torch.zeros((3, 5), dtype=torch.bool), torch.zeros((3, 5, 6), dtype=torch.bool),
               torch.zeros((), dtype=torch.int32))
        kwargs = dict(out=out, row0=1, col0=4)  # columns 4..7 of 6
    with pytest.raises(ValueError):
        pipeline.match_pipeline(*args, **kwargs)


@pytest.mark.parametrize("shape", [(0, 4, 4), (3, 0, 4), (3, 4, 0)], ids=["no-tipsets", "no-receipts", "no-events"])
def test_match_pipeline_plain_on_an_empty_world(shape):
    batch = pipeline.EventBatch(
        topics=np.zeros((*shape, 2, 8), np.uint32), n_topics=np.full(shape, 2, np.int32),
        emitters=np.full(shape, ACTOR, np.int32), valid=np.ones(shape, bool),
    )
    hits, mask, count = pipeline.match_pipeline(*pipeline.batch_args(batch, T0, T1, ACTOR, "cpu"))
    assert tuple(hits.shape) == shape[:2] and tuple(mask.shape) == shape
    assert not hits.any() and int(count) == 0


def _flat(n: int, seed: int):
    batch = _world(n, 1, 1, seed=seed)
    return (batch.topics.reshape(-1, 2, 8), batch.n_topics.reshape(-1), batch.valid.reshape(-1))


@pytest.mark.parametrize("n", [0, 1, 3, 33, 257, 1000])
def test_topic_mask_plain_equals_the_reference(n):
    topics, n_topics, valid = _flat(n, seed=n)
    spec0, spec1 = (np.frombuffer(t, "<u4") for t in (T0, T1))
    ref = np.asarray(match_jax._match_mask_topics(
        jnp.asarray(topics), jnp.asarray(n_topics), jnp.asarray(valid), jnp.asarray(spec0), jnp.asarray(spec1)
    ))
    ours = match.topic_mask(_i32(topics), _i32(n_topics), torch.from_numpy(valid), _i32(spec0), _i32(spec1))
    assert ours.dtype == torch.bool and ours.shape == (n,)
    np.testing.assert_array_equal(ours.numpy(), ref)


@pytest.mark.parametrize("n", [1, 200, 300])
def test_topic_mask_plain_over_rows_padded_to_the_bucket(n):
    """The reference pads to `pad_to_bucket` with valid=False rows; the
    port's mask over the same padded arrays is the reference's, filler
    rows False."""
    topics, n_topics, valid = _flat(n, seed=n + 7)
    emitters = np.full(n, ACTOR, dtype=np.int64)
    spec0, spec1 = (np.frombuffer(t, "<u4") for t in (T0, T1))
    ref = np.asarray(match_jax.event_match_mask_jit(topics, n_topics, emitters, valid, spec0, spec1, None))
    bucket = match.pad_to_bucket(n)
    assert len(ref) == bucket
    pad = bucket - n
    padded = (
        np.concatenate([topics, np.zeros((pad, 2, 8), topics.dtype)]),
        np.concatenate([n_topics, np.zeros(pad, n_topics.dtype)]),
        np.concatenate([valid, np.zeros(pad, bool)]),
    )
    ours = match.topic_mask_plain(_i32(padded[0]), _i32(padded[1]), torch.from_numpy(padded[2]),
                                  _i32(spec0), _i32(spec1))
    np.testing.assert_array_equal(ours.numpy(), ref)
    assert not ours[n:].any() and ours[:n].any()


@pytest.mark.parametrize("n", [0, 1, 5, 256, 1001])
def test_fp_mask_plain_equals_the_reference(n):
    rng = np.random.default_rng(n)
    target = int(rng.integers(0, 1 << 63, dtype=np.uint64)) | (1 << 63)  # the sign bit set
    fp = rng.integers(0, 1 << 63, size=n, dtype=np.uint64)
    fp[rng.random(n) < 0.3] = np.uint64(target)
    fp[rng.random(n) < 0.1] = np.uint64(target ^ (1 << 40))  # the high word differs
    valid = rng.random(n) < 0.9
    fp2 = np.ascontiguousarray(fp).view("<u4").reshape(n, 2)
    target2 = np.frombuffer(target.to_bytes(8, "little"), "<u4")
    ref = np.asarray(match_jax._match_mask_fp(jnp.asarray(fp2), jnp.asarray(valid), jnp.asarray(target2)))
    signed = int.from_bytes(target.to_bytes(8, "little"), "little", signed=True)
    ours = match.fp_mask(torch.from_numpy(fp.view(np.int64)), torch.from_numpy(valid), signed)
    assert ours.dtype == torch.bool and ours.shape == (n,)
    np.testing.assert_array_equal(ours.numpy(), ref)
    assert n < 5 or ours.any()


# row counts that are not multiples of 2, 4 or 8
SWEEP_ROWS = [7, 13, 301, 1027]


def _sweep_rows(n: int, share: float):
    """Flat rows as phase 3a's topic0 sweep builds them
    (`chip_smoke.topic0_share` over a world with planted full matches),
    plus rows with topic0 matching and topic1 one word off, ``n_topics``
    0..3 and a tenth invalid."""
    import chip_smoke

    rng = np.random.default_rng(n)
    batch = pipeline.synthetic_event_batch(n, 1, 1, T0, T1, emitter=ACTOR, match_rate=0.2, seed=n)
    topics = chip_smoke.topic0_share(batch.topics.reshape(-1, 2, 8), T0, share, seed=n)
    hit0 = (topics[:, 0] == np.frombuffer(T0, "<u4")).all(axis=-1)
    near = hit0 & (rng.random(n) < 0.3)
    topics[near, 1] = np.frombuffer(T1, "<u4")
    topics[near, 1, rng.integers(0, 8)] ^= 1 << int(rng.integers(0, 32))
    n_topics = rng.integers(0, 4, n).astype(np.int32)
    valid = rng.random(n) < 0.9
    return topics, n_topics, valid


@pytest.mark.parametrize("share", [0.0, 0.01, 0.10, 0.50, 1.0])
@pytest.mark.parametrize("n", SWEEP_ROWS)
def test_topic_mask_plain_equals_the_reference_over_the_topic0_sweep(n, share):
    """`topic_mask_plain` (what the kernel is held against)
    equals ``_match_mask_topics`` at each share of rows whose topic0 is
    the spec, rows with topic1 one word off among them."""
    topics, n_topics, valid = _sweep_rows(n, share)
    assert int((topics[:, 0] == np.frombuffer(T0, "<u4")).all(axis=-1).sum()) == round(share * n)
    spec0, spec1 = (np.frombuffer(t, "<u4") for t in (T0, T1))
    ref = np.asarray(match_jax._match_mask_topics(
        jnp.asarray(topics), jnp.asarray(n_topics), jnp.asarray(valid), jnp.asarray(spec0), jnp.asarray(spec1)
    ))
    ours = match.topic_mask(_i32(topics), _i32(n_topics), torch.from_numpy(valid), _i32(spec0), _i32(spec1))
    np.testing.assert_array_equal(ours.numpy(), ref)
    if share == 0.0:
        assert not ref.any()


@pytest.mark.parametrize("share", [0.0, 0.01, 0.10, 0.50, 1.0])
@pytest.mark.parametrize("n", SWEEP_ROWS)
def test_fp_mask_plain_equals_the_reference_impl_over_the_share_sweep(n, share):
    """`fp_mask_plain` equals ``_match_mask_fp_impl`` (the reference's
    function under its jit) at each share of fingerprints equal to the
    target, some of the others one high-word bit off; also on the rows
    after the first (the kernel's offset view ``f[1:]``)."""
    rng = np.random.default_rng(n)
    target = int(rng.integers(0, 1 << 63, dtype=np.uint64)) | (1 << 63)
    fp = rng.integers(0, 1 << 63, size=n, dtype=np.uint64)
    fp[rng.permutation(n)[: round(share * n)]] = np.uint64(target)
    off = (fp != np.uint64(target)) & (rng.random(n) < 0.2)
    fp[off] = np.uint64(target ^ (1 << 40))
    valid = rng.random(n) < 0.9
    signed = int.from_bytes(target.to_bytes(8, "little"), "little", signed=True)
    target2 = jnp.asarray(np.frombuffer(target.to_bytes(8, "little"), "<u4"))
    for first in (0, 1):
        f, ok = fp[first:], valid[first:]
        ref = np.asarray(match_jax._match_mask_fp_impl(
            jnp.asarray(np.ascontiguousarray(f).view("<u4").reshape(-1, 2)), jnp.asarray(ok), target2))
        ours = match.fp_mask(torch.from_numpy(fp.view(np.int64))[first:], torch.from_numpy(valid)[first:], signed)
        np.testing.assert_array_equal(ours.numpy(), ref)


def _reference_outputs(entry: str, inputs, extra):
    """The JAX package's result for a guard-band case of ``entry``."""
    entry = san._c_entry(entry)
    if entry == "match_pipeline":
        topics, n_topics, emitters, valid, spec0, spec1, actor = (jnp.asarray(a) for a in inputs)
        return tuple(np.asarray(x) for x in ref_pipeline.match_pipeline(
            topics.view(jnp.uint32), n_topics, emitters, valid, spec0.view(jnp.uint32),
            spec1.view(jnp.uint32), actor))
    if entry == "event_match_mask":
        topics, n_topics, valid, spec0, spec1 = (jnp.asarray(a) for a in inputs)
        return (np.asarray(match_jax._match_mask_topics(
            topics.view(jnp.uint32), n_topics, valid, spec0.view(jnp.uint32), spec1.view(jnp.uint32))),)
    if entry == "event_match_mask_fp":
        fp, valid = inputs
        target2 = np.frombuffer(int(extra[0]).to_bytes(8, "little", signed=True), "<u4")
        return (np.asarray(match_jax._match_mask_fp(
            jnp.asarray(fp.view("<u4").reshape(-1, 2)), jnp.asarray(valid), jnp.asarray(target2))),)
    mask, ids = inputs
    return (np.asarray(match_jax.receipts_with_match(jnp.asarray(mask), jnp.asarray(ids), int(extra[0]))),)


def _slice_reference(n: int, extra, block):
    """A `SLICE_CASES` case's whole outputs before the launch (sentinel
    bytes everywhere, the count 7) and after it by the JAX package's block
    result: its mask in the slice, its hits stored or only its hits set,
    its count stored or added; bytes elsewhere untouched."""
    e, receipt0, col0, mask_e, flags = extra
    row = receipt0 // n
    hits = np.full((san.SLICE_MESH, n), 0xAB, np.uint8)
    mask = np.full((san.SLICE_MESH, n, mask_e), 0xCD, np.uint8)
    count = np.array(7, np.int32)
    before = [torch.from_numpy(hits.copy()).view(torch.bool), torch.from_numpy(mask.copy()).view(torch.bool),
              torch.from_numpy(count.copy())]
    block_hits, block_mask, block_count = block
    mask[row, :, col0 : col0 + e] = block_mask[0]
    if flags & pipeline.OR_HITS:
        hits[row][block_hits[0]] = 1
    else:
        hits[row] = block_hits[0]
    count = count + block_count if flags & pipeline.ADD_COUNT else np.array(block_count, np.int32)
    return before, (hits, mask, count)


def test_guard_band_cases_of_the_match_entries_equal_the_reference():
    """`build_native_san`'s cases of the four entries (the shapes phase 32
    checks on the card), the flat masks' full-share cases and the
    pipeline's interior-slice cases among them, through their plain
    versions equal the JAX package; an interior slice leaves every other
    byte of the whole outputs as it was."""
    seen = set()
    for entry, n, inputs, extra in san.kernel_cases():
        if san._c_entry(entry) not in san.MATCH_ENTRIES or n > 200:
            continue
        seen.add(entry)
        want = _reference_outputs(entry, inputs, extra)
        views = [torch.from_numpy(np.ascontiguousarray(a)) for a in inputs]
        if entry in san.SLICE_CASES:
            before, want = _slice_reference(n, extra, want)
            got = [x.view(torch.uint8) if x.dtype == torch.bool else x for x in san._plain(entry)(views, extra, before)]
        else:
            got = san._plain(entry)(views, extra)
        assert len(got) == len(want)
        for ours, ref in zip(got, want):
            np.testing.assert_array_equal(ours.numpy(), ref)
    assert seen == set(san.MATCH_ENTRIES) | set(san.FULL_SHARE_CASES) | set(san.SLICE_CASES)


@pytest.mark.parametrize("shape", [(3, 77, 1), (5, 41, 3), (2, 9, 33), (1, 1, 300), (0, 4, 4)],
                         ids=["E1", "E3", "E33", "E300", "empty"])
@pytest.mark.parametrize("receipts", ["fewer-than-events", "more-than-events"])
@pytest.mark.parametrize("id_dtype", [np.int32, np.int64], ids=["int32", "int64"])
def test_receipts_plain_equals_the_reference_on_the_edge_worlds(shape, receipts, id_dtype):
    """`receipts_with_match_plain` (what the kernel is held
    against on the card) over each edge world's match mask, ids over
    [-2·num, 2·num), num below and above the event count, equals the
    reference's ``.at[ids].add``."""
    batch = _world(*shape, seed=sum(shape))
    mask = np.asarray(pipeline.match_pipeline_plain(
        *pipeline.batch_args(batch, T0, T1, ACTOR, "cpu"))[1]).reshape(-1)
    n = mask.size
    num = max(1, n // 3) if receipts == "fewer-than-events" else n + 5
    ids = np.random.default_rng(n + num).integers(-2 * num, 2 * num, n).astype(id_dtype)
    ours = match.receipts_with_match_plain(torch.from_numpy(mask), torch.from_numpy(ids), num)
    ref = match_jax.receipts_with_match(jnp.asarray(mask), jnp.asarray(ids.astype(np.int32)), num)
    assert ours.dtype == torch.bool and ours.shape == (num,)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def _meta(array) -> torch.Tensor:
    return torch.from_numpy(np.array(array)).to("meta")


def test_a_device_other_than_cpu_or_cuda_raises():
    topics, n_topics, valid = _flat(4, seed=2)
    spec0, spec1 = (np.frombuffer(t, "<i4") for t in (T0, T1))
    args = (_meta(topics.view(np.int32)), _meta(n_topics), _meta(valid), _meta(spec0), _meta(spec1))
    with pytest.raises(ValueError, match="unsupported device"):
        match.topic_mask(*args)
    with pytest.raises(ValueError, match="unsupported device"):
        match.receipts_with_match(_meta(valid), _meta(n_topics), 4)


def test_a_refused_build_raises_with_no_fallback(monkeypatch):
    """With the kernel path forced and the build refused, each wrapper
    raises `DeviceFaultError`: no plain-version result, no launch counted."""
    def refuse(names):
        raise build.DeviceFaultError("kernel build failed: nvcc exit 1")

    monkeypatch.setattr(build, "build_libraries", refuse)
    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setattr(build, "_entries", {})
    monkeypatch.setattr(match, "runs_plain", lambda name, device: False)
    monkeypatch.setattr(pipeline, "runs_plain", lambda name, device: False)
    match.reset_launch_counts()
    pipeline.reset_launch_counts()
    topics, n_topics, valid = _flat(8, seed=3)
    spec0, spec1 = (np.frombuffer(t, "<u4") for t in (T0, T1))
    batch = _world(2, 2, 2, seed=3)
    calls = {
        "topic": lambda: match.topic_mask(_i32(topics), _i32(n_topics), torch.from_numpy(valid),
                                          _i32(spec0), _i32(spec1)),
        "fp": lambda: match.fp_mask(torch.arange(8), torch.from_numpy(valid), 3),
        "receipts": lambda: match.receipts_with_match(torch.from_numpy(valid), torch.arange(8), 8),
        "pipeline": lambda: pipeline.match_pipeline(*pipeline.batch_args(batch, T0, T1, ACTOR, "cpu")),
    }
    for label, call in calls.items():
        with pytest.raises(build.DeviceFaultError, match="nvcc"):
            call()
    assert not any(match.LAUNCHES.values()) and not any(pipeline.LAUNCHES.values())
