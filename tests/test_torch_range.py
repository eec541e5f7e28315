"""The port's range event-proof path against the JAX package, end to end.

At ``build_range_world(24, 8, 4, 0.125)`` built by each package: the block
stores are byte-identical, the port's bundle (``to_json()``/``digest()``)
equals the reference's from ``generate_event_proofs_for_range(...,
match_backend=get_backend("cpu"))`` (also with ``storage_specs``, slots
proved at every pair), the verdict lists are equal, and a tampered witness
block is rejected by both.
"""

import dataclasses

import pytest

jax = pytest.importorskip("jax")

from ipc_proofs_tpu.backend import get_backend as ref_get_backend  # noqa: E402
from ipc_proofs_tpu.fixtures import build_range_world as ref_build_range_world  # noqa: E402
from ipc_proofs_tpu.proofs.bundle import UnifiedProofBundle as RefBundle  # noqa: E402
from ipc_proofs_tpu.proofs.generator import EventProofSpec as RefSpec  # noqa: E402
from ipc_proofs_tpu.proofs.range import (  # noqa: E402
    generate_event_proofs_for_range as ref_generate,
)
from ipc_proofs_tpu.proofs.storage_batch import MappingSlotSpec as RefSlotSpec  # noqa: E402
from ipc_proofs_tpu.proofs.trust import TrustPolicy  # noqa: E402
from ipc_proofs_tpu.proofs.verifier import verify_proof_bundle as ref_verify  # noqa: E402
from ipc_proofs_tpu_torch.backend import get_backend  # noqa: E402
from ipc_proofs_tpu_torch.fixtures import build_range_world, world_from_blocks  # noqa: E402
from ipc_proofs_tpu_torch.proofs.bundle import ProofBlock, UnifiedProofBundle  # noqa: E402
from ipc_proofs_tpu_torch.proofs.event_generator import (  # noqa: E402
    EventMatcher,
    mask_receipt_indices,
    match_receipt_indices,
    scan_receipt_events,
)
from ipc_proofs_tpu_torch.proofs.generator import EventProofSpec  # noqa: E402
from ipc_proofs_tpu_torch.proofs.range import generate_event_proofs_for_range  # noqa: E402
from ipc_proofs_tpu_torch.proofs.storage_batch import MappingSlotSpec  # noqa: E402
from ipc_proofs_tpu_torch.proofs.verifier import accept_all, verify_proof_bundle  # noqa: E402
from ipc_proofs_tpu_torch.utils.metrics import Metrics  # noqa: E402

WORLD = dict(n_pairs=24, receipts_per_pair=8, events_per_receipt=4, match_rate=0.125)
SIG, TOPIC1, ACTOR = "NewTopDownMessage(bytes32,uint256)", "calib-subnet-1", 1001


@pytest.fixture(scope="module")
def ref_world():
    store, pairs, n_matching = ref_build_range_world(**WORLD)
    bundle = ref_generate(
        store, pairs, RefSpec(SIG, TOPIC1, ACTOR), match_backend=ref_get_backend("cpu")
    )
    return store, pairs, n_matching, bundle


@pytest.fixture(scope="module")
def port_world():
    store, pairs, n_matching = build_range_world(**WORLD)
    bundle = generate_event_proofs_for_range(
        store, pairs, EventProofSpec(SIG, TOPIC1, ACTOR),
        match_backend=get_backend("gpu", device="cpu"),
    )
    return store, pairs, n_matching, bundle


def _raw(store):
    return {cid.to_bytes(): data for cid, data in store.items()}


def _tampered(bundle, cls, index):
    blocks = list(bundle.blocks)
    block = blocks[index]
    flipped = bytearray(block.data)
    flipped[len(flipped) // 2] ^= 0x01
    blocks[index] = cls(block.cid, bytes(flipped))
    return dataclasses.replace(bundle, blocks=blocks)


def test_stores_are_byte_identical(ref_world, port_world):
    assert _raw(port_world[0]) == _raw(ref_world[0])
    assert port_world[2] == ref_world[2]
    for ours, ref in zip(port_world[1], ref_world[1]):
        assert [c.to_bytes() for c in ours.child.cids] == [c.to_bytes() for c in ref.child.cids]


def test_bundle_equals_reference(ref_world, port_world):
    ours, ref = port_world[3], ref_world[3]
    assert len(ours.event_proofs) == port_world[2] > 0
    assert ours.to_json() == ref.to_json()
    assert ours.digest() == ref.digest()


def test_scalar_match_path_gives_the_same_bundle(port_world):
    """The scalar per-receipt predicate picks the receipts the range's one
    mask call picks, and the rerun gives the same bundle."""
    store, pairs, _, bundle = port_world
    matcher = EventMatcher(SIG, TOPIC1)
    scalar = [
        (str(pair.child.cids[0]), i)
        for pair in pairs
        for i in match_receipt_indices(
            scan_receipt_events(store, pair.child.blocks[0].parent_message_receipts),
            matcher,
            ACTOR,
        )
    ]
    proved = {(p.child_block_cid, p.exec_index) for p in bundle.event_proofs}
    assert len(scalar) == len(set(scalar)) == len(proved) > 0
    assert set(scalar) == proved
    metrics = Metrics()
    again = generate_event_proofs_for_range(
        store, pairs, EventProofSpec(SIG, TOPIC1, ACTOR),
        match_backend=get_backend("gpu", device="cpu"), metrics=metrics,
    )
    assert again.digest() == bundle.digest()
    assert {"range_scan", "range_match", "range_record"} <= metrics.stage_s.keys()
    assert metrics.counters["range_proofs"] == len(bundle.event_proofs)
    assert metrics.counters["range_events"] == WORLD["n_pairs"] * 8 * 4


@pytest.mark.parametrize("actor", [ACTOR, None, 7])
def test_mask_receipt_indices_equals_scalar_predicate(port_world, actor):
    """The one-mask-call predicate the range driver and `generate_event_proof`
    share picks, scan by scan, the receipts the scalar predicate picks, over
    the whole range at once and over one pair at a time."""
    store, pairs, _, _ = port_world
    matcher = EventMatcher(SIG, TOPIC1)
    backend = get_backend("gpu", device="cpu")
    scans = [
        scan_receipt_events(store, pair.child.blocks[0].parent_message_receipts)
        for pair in pairs
    ]
    scalar = [match_receipt_indices(scanned, matcher, actor) for scanned in scans]
    assert (sum(map(len, scalar)) > 0) == (actor != 7)
    assert mask_receipt_indices(scans, matcher, actor, backend) == scalar
    assert [mask_receipt_indices([s], matcher, actor, backend)[0] for s in scans] == scalar
    assert mask_receipt_indices([[], *scans[:1]], matcher, actor, backend) == [[], scalar[0]]


def test_verdicts_equal_reference(ref_world, port_world):
    ref = ref_verify(
        ref_world[3], TrustPolicy.accept_all(),
        verify_witness_cids=True, cid_backend=ref_get_backend("cpu"),
    )
    backend = get_backend("gpu", device="cpu")
    ours = verify_proof_bundle(
        port_world[3], accept_all, accept_all, verify_witness_cids=True, cid_backend=backend
    )
    replay_only = verify_proof_bundle(port_world[3], accept_all, accept_all, cid_backend=backend)
    assert ours.event_results == replay_only.event_results == ref.event_results
    assert ours.all_valid() and len(ours.event_results) == port_world[2]


def test_rejecting_trust_callables_match_reference(ref_world, port_world):
    def reject_parent(epoch, cids):
        return epoch % 4 != 0

    def broken(epoch, cid):
        raise RuntimeError("trust check unavailable")

    backend = get_backend("gpu", device="cpu")
    ref = ref_verify(ref_world[3], TrustPolicy.accept_all()).event_results
    ours = verify_proof_bundle(
        port_world[3], reject_parent, accept_all, cid_backend=backend
    ).event_results
    assert ours == [r and p.parent_epoch % 4 != 0 for r, p in zip(ref, port_world[3].event_proofs)]
    assert not any(
        verify_proof_bundle(port_world[3], accept_all, broken, cid_backend=backend).event_results
    )


@pytest.mark.parametrize("which", ["small", "mid", "large"])
def test_tampered_block_rejected_by_both(ref_world, port_world, which):
    sizes = [len(b.data) for b in port_world[3].blocks]
    pick = {
        "small": lambda n: n <= 128,
        "mid": lambda n: 128 < n <= 256,
        "large": lambda n: n > 256,
    }[which]
    index = next(i for i, n in enumerate(sizes) if pick(n))
    with pytest.raises(ValueError):
        ref_verify(
            _tampered(ref_world[3], type(ref_world[3].blocks[0]), index),
            TrustPolicy.accept_all(),
            verify_witness_cids=True, cid_backend=ref_get_backend("cpu"),
        )
    with pytest.raises(ValueError):
        verify_proof_bundle(
            _tampered(port_world[3], ProofBlock, index), accept_all, accept_all,
            verify_witness_cids=True, cid_backend=get_backend("gpu", device="cpu"),
        )


def test_reference_world_loads_into_the_port(ref_world, port_world):
    ref_store, ref_pairs, n_matching, ref_bundle = ref_world
    store, pairs = world_from_blocks(
        ((cid.to_bytes(), data) for cid, data in ref_store.items()),
        [(p.parent.cids[0].to_bytes(), p.child.cids[0].to_bytes()) for p in ref_pairs],
    )
    bundle = generate_event_proofs_for_range(
        store, pairs, EventProofSpec(SIG, TOPIC1, ACTOR),
        match_backend=get_backend("gpu", device="cpu"),
    )
    assert bundle.digest() == ref_bundle.digest()


def test_reference_bundle_json_parses_and_verifies(ref_world):
    text = ref_world[3].to_json()
    bundle = UnifiedProofBundle.from_json(text)
    assert bundle.to_json() == text
    assert verify_proof_bundle(
        bundle, accept_all, accept_all, cid_backend=get_backend("gpu", device="cpu")
    ).all_valid()
    # and the other way: the port's JSON is a valid reference bundle
    assert RefBundle.from_json(bundle.to_json()).digest() == bundle.digest()


STORAGE_SPECS = [(ACTOR, TOPIC1, 0), (ACTOR, TOPIC1, 1), (ACTOR, "calib-subnet-2", 0)]


@pytest.fixture(scope="module")
def storage_ranges(ref_world, port_world):
    """Each package's range bundle with the topdown-nonce slot grid proved at
    every pair (the use the reference's range docstring describes)."""
    ref = ref_generate(
        ref_world[0], ref_world[1], RefSpec(SIG, TOPIC1, ACTOR),
        match_backend=ref_get_backend("cpu"),
        storage_specs=[RefSlotSpec(*s) for s in STORAGE_SPECS],
    )
    metrics = Metrics()
    ours = generate_event_proofs_for_range(
        port_world[0], port_world[1], EventProofSpec(SIG, TOPIC1, ACTOR),
        match_backend=get_backend("gpu", device="cpu"), metrics=metrics,
        storage_specs=[MappingSlotSpec(*s) for s in STORAGE_SPECS],
    )
    return ours, ref, metrics


def test_range_with_storage_specs_equals_reference(port_world, storage_ranges):
    ours, ref, metrics = storage_ranges
    n_pairs = len(port_world[1])
    assert len(ours.storage_proofs) == n_pairs * len(STORAGE_SPECS)
    assert len(ours.event_proofs) == port_world[2] > 0
    assert ours.to_json() == ref.to_json()
    assert metrics.counters["range_storage_proofs"] == len(ours.storage_proofs)
    assert "range_storage" in metrics.stage_s
    # the witness is a superset of the event-only range's
    assert {b.cid for b in port_world[3].blocks} < {b.cid for b in ours.blocks}
    backend = get_backend("gpu", device="cpu")
    result = verify_proof_bundle(
        ours, accept_all, accept_all, verify_witness_cids=True, cid_backend=backend
    )
    ref_result = ref_verify(
        ref, TrustPolicy.accept_all(), verify_witness_cids=True, cid_backend=ref_get_backend("cpu")
    )
    assert result.all_valid()
    assert result.storage_results == ref_result.storage_results
    assert result.event_results == ref_result.event_results


def test_storage_bundle_json_round_trips_with_reference(storage_ranges):
    ours, ref, _ = storage_ranges
    text = ref.to_json()
    parsed = UnifiedProofBundle.from_json(text)
    assert parsed.to_json() == text and parsed.storage_proofs
    assert RefBundle.from_json(ours.to_json()).digest() == ours.digest()
    broken = text.replace('"actor_id": %d' % ACTOR, '"actor_id": "%d"' % ACTOR, 1)
    assert broken != text
    for parse in (UnifiedProofBundle.from_json, RefBundle.from_json):
        with pytest.raises((TypeError, ValueError)):
            parse(broken)
