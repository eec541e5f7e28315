"""The port's storage-proof path against the JAX package, end to end.

At a small BASELINE-config-3 shape (8 contracts × 32 mapping slots, keys
``keccak(ascii_to_bytes32(f"subnet-{c}") ‖ be32(i))``, values
``(i % 251).to_bytes(2, "big")``) built by each package with ``build_chain``:

- the block stores are byte-identical, for each of the four storage
  encodings;
- the HAMT reader and the five-encoding slot read return what the
  reference's do, and raise the same exception class on malformed nodes;
- every bundle (scalar, batch, unified with event specs) is JSON-equal to
  the reference's, and the verdicts are equal, tampered cases included.

The range driver with storage specs: tests/test_torch_range.py.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from ipc_proofs_tpu.backend import get_backend as ref_get_backend  # noqa: E402
from ipc_proofs_tpu.core.cid import CID as RefCID  # noqa: E402
from ipc_proofs_tpu.fixtures import ContractFixture as RefContract  # noqa: E402
from ipc_proofs_tpu.fixtures import EventFixture as RefEvent  # noqa: E402
from ipc_proofs_tpu.fixtures import build_chain as ref_build_chain  # noqa: E402
from ipc_proofs_tpu.ipld.hamt import HAMT as RefHAMT  # noqa: E402
from ipc_proofs_tpu.proofs.bundle import UnifiedProofBundle as RefBundle  # noqa: E402
from ipc_proofs_tpu.proofs.generator import EventProofSpec as RefEventSpec  # noqa: E402
from ipc_proofs_tpu.proofs.generator import StorageProofSpec as RefStorageSpec  # noqa: E402
from ipc_proofs_tpu.proofs.generator import generate_proof_bundle as ref_generate_bundle  # noqa: E402
from ipc_proofs_tpu.proofs.storage_batch import MappingSlotSpec as RefSlotSpec  # noqa: E402
from ipc_proofs_tpu.proofs.storage_batch import (  # noqa: E402
    generate_storage_proofs_batch as ref_generate_batch,
)
from ipc_proofs_tpu.proofs.storage_generator import (  # noqa: E402
    generate_storage_proof as ref_generate_storage,
)
from ipc_proofs_tpu.proofs.trust import TrustPolicy  # noqa: E402
from ipc_proofs_tpu.proofs.verifier import verify_proof_bundle as ref_verify  # noqa: E402
from ipc_proofs_tpu.core.dagcbor import decode as ref_decode  # noqa: E402
from ipc_proofs_tpu.state.storage import classify_storage_root as ref_classify  # noqa: E402
from ipc_proofs_tpu.state.storage import compute_mapping_slot as ref_mapping_slot  # noqa: E402
from ipc_proofs_tpu.state.storage import read_storage_slot as ref_read_slot  # noqa: E402
from ipc_proofs_tpu.store.blockstore import MemoryBlockstore as RefStore  # noqa: E402
from ipc_proofs_tpu_torch.backend import get_backend  # noqa: E402
from ipc_proofs_tpu_torch.core.cid import CID  # noqa: E402
from ipc_proofs_tpu_torch.core.dagcbor import decode  # noqa: E402
from ipc_proofs_tpu_torch.core.hashes import keccak256  # noqa: E402
from ipc_proofs_tpu_torch.fixtures import (  # noqa: E402
    ContractFixture,
    EventFixture,
    build_chain,
    world_from_blocks,
)
from ipc_proofs_tpu_torch.ipld.hamt import HAMT, hamt_build  # noqa: E402
from ipc_proofs_tpu_torch.proofs.bundle import (  # noqa: E402
    ProofBlock,
    StorageProof,
    UnifiedProofBundle,
)
from ipc_proofs_tpu_torch.proofs.generator import (  # noqa: E402
    EventProofSpec,
    StorageProofSpec,
    generate_proof_bundle,
)
from ipc_proofs_tpu_torch.proofs.storage_batch import (  # noqa: E402
    MappingSlotSpec,
    generate_storage_proofs_batch,
    hash_slot_specs,
)
from ipc_proofs_tpu_torch.proofs.storage_generator import generate_storage_proof  # noqa: E402
from ipc_proofs_tpu_torch.proofs.storage_verifier import verify_storage_proof  # noqa: E402
from ipc_proofs_tpu_torch.proofs.verifier import accept_all, verify_proof_bundle  # noqa: E402
from ipc_proofs_tpu_torch.state.actors import get_actor_state, parse_evm_state  # noqa: E402
from ipc_proofs_tpu_torch.state.address import Address  # noqa: E402
from ipc_proofs_tpu_torch.state.events import ascii_to_bytes32  # noqa: E402
from ipc_proofs_tpu_torch.state.storage import (  # noqa: E402
    calculate_storage_slot,
    classify_storage_root,
    compute_mapping_slot,
    read_storage_slot,
)
from ipc_proofs_tpu_torch.store.blockstore import MemoryBlockstore, put_cbor  # noqa: E402
from ipc_proofs_tpu_torch.utils.metrics import Metrics  # noqa: E402

N_CONTRACTS, N_SLOTS = 8, 32
ENCODINGS = ["direct", "wrapper_tuple", "wrapper_map", "inline"]
SIG = "NewTopDownMessage(bytes32,uint256)"
BACKEND = get_backend("gpu", device="cpu")


def _slot(c, i):
    return keccak256(ascii_to_bytes32(f"subnet-{c}") + i.to_bytes(32, "big"))


def _storage(c, n_slots=N_SLOTS):
    return {_slot(c, i): (i % 251).to_bytes(2, "big") for i in range(n_slots)}


def _world(contract_cls, event_cls, build, encoding):
    """Config 3's contracts (the encoding per contract cycles from
    ``encoding``) plus config 5's shape: each contract's nonce event."""
    contracts = [
        contract_cls(
            actor_id=1000 + c,
            storage=_storage(c),
            nonce=c + 1,
            storage_encoding=ENCODINGS[(ENCODINGS.index(encoding) + c) % 4],
        )
        for c in range(N_CONTRACTS)
    ]
    events = [
        [event_cls(emitter=1000 + c, signature=SIG, topic1=f"subnet-{c}",
                   data=(c + 1).to_bytes(32, "big"))]
        for c in range(N_CONTRACTS)
    ] + [[]]
    return build(contracts, events, n_filler_actors=20)


def _specs(cls, n_contracts=N_CONTRACTS, n_slots=N_SLOTS):
    # every slot of every contract, plus one absent slot per contract
    return [
        cls(1000 + c, f"subnet-{c}", i) for c in range(n_contracts) for i in range(n_slots + 1)
    ]


@pytest.fixture(scope="module", params=ENCODINGS)
def worlds(request):
    ours = _world(ContractFixture, EventFixture, build_chain, request.param)
    ref = _world(RefContract, RefEvent, ref_build_chain, request.param)
    return ours, ref


@pytest.fixture(scope="module")
def batches(worlds):
    ours, ref = worlds
    bundle = generate_storage_proofs_batch(
        ours.store, ours.parent, ours.child, _specs(MappingSlotSpec), hash_backend=BACKEND
    )
    ref_bundle = ref_generate_batch(ref.store, ref.parent, ref.child, _specs(RefSlotSpec))
    return bundle, ref_bundle


def _raw(store):
    return {cid.to_bytes(): data for cid, data in store.items()}


def _ref_store(store):
    """The port's blocks loaded into the reference's store type."""
    ref = RefStore()
    for cid, data in store.items():
        ref.put_keyed(RefCID.from_bytes(cid.to_bytes()), data)
    return ref


def test_build_chain_stores_are_byte_identical(worlds):
    ours, ref = worlds
    assert _raw(ours.store) == _raw(ref.store)
    assert ours.child.cids[0].to_bytes() == ref.child.cids[0].to_bytes()
    assert [c.to_bytes() for c in ours.message_cids] == [c.to_bytes() for c in ref.message_cids]


def test_build_chain_options_are_byte_identical():
    """Several parent blocks, a failed message and both event encodings."""

    def build(contract_cls, event_cls, build_fn):
        events = [
            [event_cls(1000 + m, SIG, f"subnet-{m}", encoding=enc, extra_topics=[bytes([m]) * 32])
             for enc in ("compact", "concat")]
            for m in range(5)
        ]
        world = build_fn(
            [contract_cls(1000, storage=_storage(0, 4), storage_encoding="wrapper_map")], events,
            parent_height=7, n_parent_blocks=2, n_filler_actors=3, failed_message_indices={2},
        )
        return _raw(world.store), [c.to_bytes() for c in world.parent.cids]

    assert build(ContractFixture, EventFixture, build_chain) == build(
        RefContract, RefEvent, ref_build_chain
    )


def test_batch_bundle_equals_reference(batches):
    bundle, ref_bundle = batches
    assert len(bundle.storage_proofs) == N_CONTRACTS * (N_SLOTS + 1)
    assert bundle.to_json() == ref_bundle.to_json()
    values = [p.value for p in bundle.storage_proofs]
    expected = [
        "0x" + (i % 251 if i < N_SLOTS else 0).to_bytes(32, "big").hex()
        for _ in range(N_CONTRACTS)
        for i in range(N_SLOTS + 1)
    ]
    assert values == expected


def test_batch_metrics_and_precomputed_slots(worlds, batches):
    ours, _ = worlds
    specs = _specs(MappingSlotSpec)
    metrics = Metrics()
    again = generate_storage_proofs_batch(
        ours.store, ours.parent, ours.child, specs,
        metrics=metrics, precomputed_slots=hash_slot_specs(specs, BACKEND),
    )
    assert again.digest() == batches[0].digest()
    assert {"slot_hash", "actor_walks", "slot_reads", "materialize"} <= metrics.stage_s.keys()
    assert metrics.counters == {"batch_slots": len(specs), "batch_contracts": N_CONTRACTS}
    with pytest.raises(ValueError, match="precomputed_slots"):
        generate_storage_proofs_batch(
            ours.store, ours.parent, ours.child, specs, precomputed_slots=[b"\0" * 32]
        )


def test_scalar_proofs_equal_reference(worlds):
    ours, ref = worlds
    for c, i in [(0, 0), (3, 17), (7, 31), (5, N_SLOTS)]:
        slot = calculate_storage_slot(f"subnet-{c}", i)
        proof, blocks = generate_storage_proof(ours.store, ours.parent, ours.child, 1000 + c, slot)
        ref_proof, ref_blocks = ref_generate_storage(
            ref.store, ref.parent, ref.child, 1000 + c, slot
        )
        assert proof.to_json_obj() == ref_proof.to_json_obj()
        assert [b.to_json_obj() for b in blocks] == [b.to_json_obj() for b in ref_blocks]
        assert verify_storage_proof(proof, blocks, accept_all)
        assert verify_proof_bundle(
            UnifiedProofBundle([proof], [], blocks), accept_all, accept_all,
            verify_witness_cids=True, cid_backend=BACKEND,
        ).storage_results == [True]
    with pytest.raises(ValueError, match="32 bytes"):
        generate_storage_proof(ours.store, ours.parent, ours.child, 1000, b"short")


def test_unified_bundle_equals_reference(worlds):
    """Config 5's shape: nonce slots and their events in one bundle."""
    ours, ref = worlds
    slots = [(1000 + c, calculate_storage_slot(f"subnet-{c}", 0)) for c in range(N_CONTRACTS)]
    bundle = generate_proof_bundle(
        ours.store, ours.parent, ours.child,
        [StorageProofSpec(a, s) for a, s in slots],
        [EventProofSpec(SIG, f"subnet-{c}", 1000 + c) for c in range(N_CONTRACTS)],
        match_backend=BACKEND,
    )
    ref_bundle = ref_generate_bundle(
        ref.store, ref.parent, ref.child,
        [RefStorageSpec(a, s) for a, s in slots],
        [RefEventSpec(SIG, f"subnet-{c}", 1000 + c) for c in range(N_CONTRACTS)],
    )
    assert len(bundle.storage_proofs) == len(bundle.event_proofs) == N_CONTRACTS
    assert bundle.to_json() == ref_bundle.to_json()
    result = verify_proof_bundle(
        bundle, accept_all, accept_all, verify_witness_cids=True, cid_backend=BACKEND
    )
    ref_result = ref_verify(ref_bundle, TrustPolicy.accept_all())
    assert result.all_valid()
    assert result.storage_results == ref_result.storage_results
    assert result.event_results == ref_result.event_results


def _tamper_proof(bundle, index, **fields):
    proofs = list(bundle.storage_proofs)
    proofs[index] = dataclasses.replace(proofs[index], **fields)
    return dataclasses.replace(bundle, storage_proofs=proofs)


def _both_verdicts(bundle, ref_bundle_cls=RefBundle):
    ours = verify_proof_bundle(
        bundle, accept_all, accept_all, verify_witness_cids=True, cid_backend=BACKEND
    ).storage_results
    ref = ref_verify(
        ref_bundle_cls.from_json(bundle.to_json()), TrustPolicy.accept_all(),
        verify_witness_cids=True, cid_backend=ref_get_backend("cpu"),
    ).storage_results
    return ours, ref


def test_verdicts_equal_reference(batches):
    ours, ref = _both_verdicts(batches[0])
    assert ours == ref and all(ours)


@pytest.mark.parametrize("field", ["value", "actor_state_cid", "storage_root", "parent_state_root"])
def test_tampered_claims_give_the_reference_verdicts(batches, field):
    bundle = batches[0]
    first, other = bundle.storage_proofs[0], bundle.storage_proofs[-1]
    replacement = {
        "value": "0x" + "00" * 31 + "07",
        "actor_state_cid": other.actor_state_cid,
        "storage_root": other.storage_root,
        "parent_state_root": first.actor_state_cid,
    }[field]
    tampered = _tamper_proof(bundle, 0, **{field: replacement})
    ours, ref = _both_verdicts(tampered)
    assert ours == ref
    assert ours[0] is False and all(ours[1:])


def test_rejecting_trust_anchor(batches):
    bundle = batches[0]
    epoch = bundle.storage_proofs[0].child_epoch
    result = verify_proof_bundle(bundle, accept_all, lambda e, cid: e != epoch)
    assert not any(result.storage_results)


def test_flipped_witness_byte_is_rejected_by_both(batches):
    bundle = batches[0]
    sizes = [len(b.data) for b in bundle.blocks]
    for pick in (lambda n: n <= 128, lambda n: 128 < n <= 256, lambda n: n > 256):
        index = next(i for i, n in enumerate(sizes) if pick(n))
        blocks = list(bundle.blocks)
        flipped = bytearray(blocks[index].data)
        flipped[len(flipped) // 2] ^= 0x01
        blocks[index] = ProofBlock(blocks[index].cid, bytes(flipped))
        tampered = dataclasses.replace(bundle, blocks=blocks)
        with pytest.raises(ValueError):
            verify_proof_bundle(
                tampered, accept_all, accept_all, verify_witness_cids=True, cid_backend=BACKEND
            )
        with pytest.raises(ValueError):
            ref_verify(
                RefBundle.from_json(tampered.to_json()), TrustPolicy.accept_all(),
                verify_witness_cids=True, cid_backend=ref_get_backend("cpu"),
            )


def test_storage_bundle_json_round_trips_with_reference(batches):
    bundle, ref_bundle = batches
    text = ref_bundle.to_json()
    parsed = UnifiedProofBundle.from_json(text)
    assert parsed.to_json() == text
    assert RefBundle.from_json(bundle.to_json()).digest() == bundle.digest()
    with pytest.raises((TypeError, ValueError)):
        StorageProof.from_json_obj(dict(bundle.storage_proofs[0].to_json_obj(), actor_id="7"))
    with pytest.raises((KeyError, ValueError)):
        StorageProof.from_json_obj({"slot": "0x00"})


def test_reference_world_loads_into_the_port(worlds, batches):
    _, ref = worlds
    store, [pair] = world_from_blocks(
        ((cid.to_bytes(), data) for cid, data in ref.store.items()),
        [(ref.parent.cids[0].to_bytes(), ref.child.cids[0].to_bytes())],
    )
    bundle = generate_storage_proofs_batch(
        store, pair.parent, pair.child, _specs(MappingSlotSpec), hash_backend=BACKEND
    )
    assert bundle.digest() == batches[1].digest()


# --- the readers, present / absent keys and malformed nodes -----------------


@pytest.fixture(scope="module")
def slot_map():
    store = MemoryBlockstore()
    entries = _storage(0, 200)
    root = hamt_build(store, entries)
    return store, root, entries


def test_hamt_get_and_items_equal_reference(slot_map):
    store, root, entries = slot_map
    ref_store = _ref_store(store)
    ref_root = RefCID.from_bytes(root.to_bytes())
    ours, ref = HAMT.load(store, root), RefHAMT.load(ref_store, ref_root)
    absent = [_slot(1, i) for i in range(50)]
    for key in list(entries) + absent:
        assert ours.get(key) == ref.get(key)
    assert sorted(ours.items()) == sorted(ref.items()) == sorted(entries.items())
    seen = []
    ours.for_each(lambda k, v: seen.append(k))
    assert sorted(seen) == sorted(entries)


@pytest.mark.parametrize("encoding", ENCODINGS)
def test_read_storage_slot_equals_reference(encoding):
    world = build_chain(
        [ContractFixture(7, storage=_storage(2, 40), storage_encoding=encoding)], [],
        n_filler_actors=0,
    )
    ref_store = _ref_store(world.store)
    actor = get_actor_state(world.store, world.state_root_cid, Address.new_id(7))
    root = parse_evm_state(world.store.get(actor.state)).contract_state
    ref_root = RefCID.from_bytes(root.to_bytes())
    for i in range(50):  # 40 present, 10 absent
        key = _slot(2, i)
        assert read_storage_slot(world.store, root, key) == ref_read_slot(ref_store, ref_root, key)
    with pytest.raises(ValueError):
        read_storage_slot(world.store, root, b"\x00" * 31)


@pytest.mark.parametrize("encoding", ENCODINGS)
def test_classify_storage_root_equals_reference(encoding):
    world = build_chain(
        [ContractFixture(7, storage=_storage(1, 12), storage_encoding=encoding)], [],
        n_filler_actors=0,
    )
    actor = get_actor_state(world.store, world.state_root_cid, Address.new_id(7))
    raw = world.store.get(parse_evm_state(world.store.get(actor.state)).contract_state)

    def comparable(arm):
        kind, obj, bit_width = arm
        return kind, obj if kind == "smallmap" else (obj and obj.to_bytes()), bit_width

    ours = comparable(classify_storage_root(decode(raw)))
    assert ours == comparable(ref_classify(ref_decode(raw)))
    assert ours[0] == ("smallmap" if encoding == "inline" else "hamt")


def test_mapping_slot_math_equals_reference():
    rng = np.random.default_rng(3)
    for index in [0, 1, 255, 2**64, 2**256 - 1]:
        key = rng.integers(0, 256, 32, dtype=np.uint8).tobytes()
        assert compute_mapping_slot(key, index) == ref_mapping_slot(key, index)
    with pytest.raises(ValueError):
        compute_mapping_slot(b"\x00" * 31, 0)


def _malformed(case):
    """A one-node HAMT that is broken in one way, and a key that reaches the
    break."""
    store = MemoryBlockstore()
    key = _slot(0, 0)
    bitfield, _ = decode(store.get(hamt_build(store, {key: b"\x01"})))
    if case == "bitmap_exceeds_pointers":
        root = put_cbor(store, [bitfield, []])
    elif case == "bad_bucket_entry":
        root = put_cbor(store, [bitfield, [[[key]]]])
    elif case == "bad_pointer":
        root = put_cbor(store, [bitfield, [7]])
    elif case == "malformed_node":
        root = put_cbor(store, [bitfield])
    elif case == "missing_node":
        child = CID.hash_of(b"a node nobody stored")
        root = put_cbor(store, [bitfield, [child]])
    return store, root, key


@pytest.mark.parametrize(
    "case",
    ["bitmap_exceeds_pointers", "bad_bucket_entry", "bad_pointer", "malformed_node", "missing_node"],
)
def test_malformed_nodes_raise_the_reference_class(case):
    store, root, key = _malformed(case)
    ref_store = _ref_store(store)
    ref_root = RefCID.from_bytes(root.to_bytes())

    def outcome(fn):
        try:
            return ("ok", fn())
        except (KeyError, ValueError) as exc:
            return ("raised", type(exc).__name__)

    ours = outcome(lambda: HAMT.load(store, root).get(key))
    ref = outcome(lambda: RefHAMT.load(ref_store, ref_root).get(key))
    assert ours == ref and ours[0] == "raised"
    expected = "KeyError" if case == "missing_node" else "ValueError"
    assert ours[1] == expected
    assert outcome(lambda: read_storage_slot(store, root, key)) == outcome(
        lambda: ref_read_slot(ref_store, ref_root, key)
    )


def test_mapping_slot_spec_keys():
    key = ascii_to_bytes32("subnet-3")
    assert hash_slot_specs(
        [MappingSlotSpec(1, "subnet-3", 5), MappingSlotSpec(1, key, 5)], BACKEND
    ) == [calculate_storage_slot("subnet-3", 5)] * 2
    with pytest.raises(ValueError, match="32 bytes"):
        MappingSlotSpec(1, b"short").key32()
