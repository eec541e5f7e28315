"""The port's batched verifiers against the JAX package's, on tampered bundles.

Each package builds the same small worlds (event bundles over 1–3 pairs
with mixed event encodings; storage bundles over 2–4 contracts × 4 slots in
several encodings). A seeded mutator — a re-implementation of the JAX
package's verifier fuzz harnesses, not an import of them — damages claim
fields and witness blocks of the port's bundle, and the same mutated bundle
is handed to the reference. For every mutant the port's batched verifier,
the reference's batched verifier and the port's scalar loop must agree
exactly: the same verdict vector, or both abort within the verifier's
abort family (KeyError / ValueError). The TxMeta recompute of the batched
event replay runs as one batch on the CPU backend, whose digest per row
decides its group.
"""

import dataclasses
import random

import pytest

jax = pytest.importorskip("jax")

from ipc_proofs_tpu.core.cid import CID as RefCID  # noqa: E402
from ipc_proofs_tpu.fixtures import ContractFixture as RefContract  # noqa: E402
from ipc_proofs_tpu.fixtures import EventFixture as RefEvent  # noqa: E402
from ipc_proofs_tpu.fixtures import build_chain as ref_build_chain  # noqa: E402
from ipc_proofs_tpu.proofs.bundle import EventData as RefEventData  # noqa: E402
from ipc_proofs_tpu.proofs.bundle import EventProof as RefEventProof  # noqa: E402
from ipc_proofs_tpu.proofs.bundle import EventProofBundle as RefEventBundle  # noqa: E402
from ipc_proofs_tpu.proofs.bundle import ProofBlock as RefBlock  # noqa: E402
from ipc_proofs_tpu.proofs.bundle import StorageProof as RefStorageProof  # noqa: E402
from ipc_proofs_tpu.proofs.bundle import UnifiedProofBundle as RefUnified  # noqa: E402
from ipc_proofs_tpu.proofs.event_generator import (  # noqa: E402
    generate_event_proof as ref_generate_event_proof,
)
from ipc_proofs_tpu.proofs.event_verifier import verify_event_proof as ref_verify_events  # noqa: E402
from ipc_proofs_tpu.proofs.generator import StorageProofSpec as RefStorageSpec  # noqa: E402
from ipc_proofs_tpu.proofs.generator import generate_proof_bundle as ref_generate_bundle  # noqa: E402
from ipc_proofs_tpu.proofs.storage_verifier import (  # noqa: E402
    verify_storage_proofs_batch as ref_verify_storage_batch,
)
from ipc_proofs_tpu.proofs.trust import TrustPolicy  # noqa: E402
from ipc_proofs_tpu.proofs.verifier import verify_proof_bundle as ref_verify  # noqa: E402
from ipc_proofs_tpu.proofs.witness import load_witness_store as ref_load_witness  # noqa: E402
from ipc_proofs_tpu.store.blockstore import MemoryBlockstore as RefStore  # noqa: E402
from ipc_proofs_tpu_torch.backend import get_backend  # noqa: E402
from ipc_proofs_tpu_torch.core.cid import CID, RAW  # noqa: E402
from ipc_proofs_tpu_torch.core.dagcbor import decode, encode  # noqa: E402
from ipc_proofs_tpu_torch.fixtures import (  # noqa: E402
    ContractFixture,
    EventFixture,
    build_chain,
    build_range_world,
)
from ipc_proofs_tpu_torch.proofs.bundle import (  # noqa: E402
    EventProofBundle,
    ProofBlock,
    UnifiedProofBundle,
)
from ipc_proofs_tpu_torch.proofs.event_generator import generate_event_proof  # noqa: E402
from ipc_proofs_tpu_torch.proofs.event_verifier import verify_event_proof  # noqa: E402
from ipc_proofs_tpu_torch.proofs.exec_order import (  # noqa: E402
    reconstruct_execution_order,
    reconstruct_execution_orders_batch,
)
from ipc_proofs_tpu_torch.proofs.generator import StorageProofSpec, generate_proof_bundle  # noqa: E402
from ipc_proofs_tpu_torch.proofs.storage_verifier import (  # noqa: E402
    verify_storage_proof,
    verify_storage_proofs_batch,
)
from ipc_proofs_tpu_torch.proofs.trust import TrustPolicy as PortTrustPolicy  # noqa: E402
from ipc_proofs_tpu_torch.proofs.verifier import verify_proof_bundle  # noqa: E402
from ipc_proofs_tpu_torch.proofs.witness import load_witness_store  # noqa: E402
from ipc_proofs_tpu_torch.state.header import decode_header_lite  # noqa: E402
from ipc_proofs_tpu_torch.state.storage import calculate_storage_slot  # noqa: E402
from ipc_proofs_tpu_torch.store.blockstore import MemoryBlockstore  # noqa: E402

SIG = "NewTopDownMessage(bytes32,uint256)"
SUBNET = "batch-subnet"
ACTOR = 321
BACKEND = get_backend("gpu", device="cpu")


def accept(*_):
    return True


# --- outcomes ----------------------------------------------------------------


def _outcome(run):
    """("ok", verdicts) or ("raise", family): the verifiers abort through
    KeyError (a missing witness block) and the ValueError family (malformed
    bytes or claims); with several independent faults the paths may surface
    different ones first, so both aborting within that family agrees.
    Anything else keeps its type name, so an unplanned crash never hides."""
    try:
        return ("ok", run())
    except (KeyError, ValueError):
        return ("raise", "abort")
    except Exception as exc:  # noqa: BLE001 — parity includes unplanned crashes
        return ("raise", type(exc).__name__)


# --- event bundles -----------------------------------------------------------


def _event_world(contract_cls, event_cls, build, generate, n_pairs, encoding, store_cls, **kw):
    store = store_cls()
    proofs, blocks = [], {}
    for p in range(n_pairs):
        events = [
            [event_cls(emitter=ACTOR, signature=SIG, topic1=SUBNET,
                       data=p.to_bytes(32, "big"), encoding=encoding)],
            [event_cls(emitter=ACTOR, signature="Noise()", topic1="x")],
            [
                event_cls(emitter=ACTOR, signature=SIG, topic1=SUBNET,
                          extra_topics=[b"\x05" * 32], encoding=encoding),
                event_cls(emitter=999, signature=SIG, topic1=SUBNET),
            ],
        ]
        world = build([contract_cls(actor_id=ACTOR)], events, parent_height=10 + 2 * p, store=store)
        bundle = generate(world.store, world.parent, world.child, SIG, SUBNET,
                          actor_id_filter=ACTOR, **kw)
        proofs.extend(bundle.proofs)
        for b in bundle.blocks:
            blocks[b.cid.to_bytes()] = b
    return proofs, [blocks[k] for k in sorted(blocks)]


_EVENT_BASES: dict = {}


def _event_base(n_pairs: int, encoding: str):
    key = (n_pairs, encoding)
    if key not in _EVENT_BASES:
        ours = _event_world(ContractFixture, EventFixture, build_chain, generate_event_proof,
                            n_pairs, encoding, MemoryBlockstore, match_backend=BACKEND)
        ref = _event_world(RefContract, RefEvent, ref_build_chain, ref_generate_event_proof,
                           n_pairs, encoding, RefStore)
        assert [p.to_json_obj() for p in ours[0]] == [p.to_json_obj() for p in ref[0]]
        assert [(b.cid.to_bytes(), b.data) for b in ours[1]] == [
            (b.cid.to_bytes(), b.data) for b in ref[1]
        ]
        _EVENT_BASES[key] = ours
    return _EVENT_BASES[key]


def _ref_blocks(blocks):
    return [RefBlock(cid=RefCID.from_bytes(b.cid.to_bytes()), data=b.data) for b in blocks]


def _ref_event_proofs(proofs):
    return [
        RefEventProof(**{**vars(p), "event_data": RefEventData(**vars(p.event_data))})
        for p in proofs
    ]


def _event_outcomes(proofs, blocks):
    bundle = EventProofBundle(proofs=proofs, blocks=blocks)
    ref_bundle = RefEventBundle(proofs=_ref_event_proofs(proofs), blocks=_ref_blocks(blocks))
    return (
        _outcome(lambda: verify_event_proof(bundle, accept, accept, batch=True,
                                            hash_backend=BACKEND)),
        _outcome(lambda: ref_verify_events(ref_bundle, accept, accept, batch=True)),
        _outcome(lambda: verify_event_proof(bundle, accept, accept, batch=False)),
    )


def _mutate_event_proof(rng: random.Random, proof):
    """One random claim-field mutation."""
    ed = proof.event_data
    choice = rng.randrange(12)
    if choice == 0:
        return dataclasses.replace(proof, exec_index=rng.choice([-1, 0, 3, 2**31, 2**63, 10**20]))
    if choice == 1:
        return dataclasses.replace(proof, event_index=rng.choice([-5, 1, 2**31 - 1, 2**40]))
    if choice == 2:  # JSON-plausible non-int indices
        return dataclasses.replace(proof, exec_index=rng.choice([1.0, 1.5, "0", None]))
    if choice == 3:
        return dataclasses.replace(proof, child_epoch=proof.child_epoch + rng.choice([-1, 1, 1000]))
    if choice == 4:
        return dataclasses.replace(proof, parent_epoch=proof.parent_epoch + rng.choice([-1, 1]))
    if choice == 5:
        return dataclasses.replace(proof, message_cid=str(CID.hash_of(rng.randbytes(8), codec=RAW)))
    if choice == 6:  # malformed CID strings
        return dataclasses.replace(
            proof, child_block_cid=rng.choice(["", "b", "not-a-cid", proof.child_block_cid[:-1]])
        )
    if choice == 7:
        return dataclasses.replace(
            proof,
            parent_tipset_cids=rng.choice([
                [],
                list(reversed(proof.parent_tipset_cids)) * 2,
                [str(CID.hash_of(rng.randbytes(4)))],
            ]),
        )
    if choice == 8:
        return dataclasses.replace(
            proof, event_data=dataclasses.replace(ed, emitter=rng.randrange(5000))
        )
    if choice == 9:
        topics = list(ed.topics)
        i = rng.randrange(len(topics))
        t = topics[i]
        topics[i] = rng.choice([
            t.upper().replace("0X", "0x"), t[:-1], t + "0", t.removeprefix("0x"),
            t[:6] + " " + t[6:], "0x" + "cd" * 32,
        ])
        return dataclasses.replace(proof, event_data=dataclasses.replace(ed, topics=topics))
    if choice == 10:
        return dataclasses.replace(
            proof,
            event_data=dataclasses.replace(
                ed, data=rng.choice([ed.data + "ff", ed.data[:-1], "0x" + "0" * 63, ""])
            ),
        )
    return dataclasses.replace(proof, event_data=dataclasses.replace(ed, topics=ed.topics + [ed.data]))


def _flip(rng, blocks):
    i = rng.randrange(len(blocks))
    data = bytearray(blocks[i].data)
    data[rng.randrange(len(data))] ^= 1 << rng.randrange(8)
    blocks = list(blocks)
    blocks[i] = ProofBlock(blocks[i].cid, bytes(data))
    return blocks


def _mutate_events(rng: random.Random, proofs, blocks):
    """One structural mutation of an event bundle."""
    kind = rng.randrange(10)
    if kind == 0:  # drop a witness block
        drop = rng.randrange(len(blocks))
        return proofs, [b for i, b in enumerate(blocks) if i != drop]
    if kind == 1:  # bit-flip inside a witness block (CID kept)
        return proofs, _flip(rng, blocks)
    if kind == 2 and len(proofs) >= 2:  # cross-wire two proofs' claims
        i, j = rng.sample(range(len(proofs)), 2)
        proofs = list(proofs)
        proofs[i] = dataclasses.replace(
            proofs[i], message_cid=proofs[j].message_cid, exec_index=proofs[j].exec_index
        )
        return proofs, blocks
    if kind == 3:  # duplicate a proof
        return list(proofs) + [rng.choice(proofs)], blocks
    if kind == 4:  # shuffle (groups re-form differently)
        proofs = list(proofs)
        rng.shuffle(proofs)
        return proofs, blocks
    proofs = list(proofs)
    for _ in range(rng.randrange(1, 4)):
        i = rng.randrange(len(proofs))
        proofs[i] = _mutate_event_proof(rng, proofs[i])
    return proofs, blocks


@pytest.mark.parametrize("seed", [0xF3, 0xBEEF, 2026, 106567516, 0xD1CE, 77310, 5, 1234567])
def test_event_verdicts_equal_reference_on_mutants(seed):
    rng = random.Random(seed)
    kinds = set()
    for _ in range(3):
        base = _event_base(rng.choice([1, 2, 3]), rng.choice(["compact", "concat"]))
        for _ in range(25):
            proofs, blocks = _mutate_events(rng, *base)
            if rng.random() < 0.3:
                proofs, blocks = _mutate_events(rng, proofs, blocks)
            ours, ref, scalar = _event_outcomes(proofs, blocks)
            assert ours == ref == scalar, f"seed={seed}: ours={ours} ref={ref} scalar={scalar}"
            kinds.add(ours[0] if ours[0] == "raise" else all(ours[1]))
    assert {"raise", False} <= kinds  # the sweep reached aborts and false verdicts


@pytest.mark.parametrize("damage", ["trailing", "nesting-bomb", "huge-length", "tag-43"])
def test_adversarial_witness_bytes_agree(damage):
    """Crafted damage in positions the C walkers' targeted parse skips but
    the scalar replay's full decode reads (``validate_blocks``)."""
    proofs, blocks = _event_base(1, "compact")
    positions = range(len(blocks))
    if damage == "tag-43":  # tag 43 spliced into a receipt's return data
        pattern = b"\x84\x00\x40\x1a"
        positions = [next(i for i, b in enumerate(blocks) if pattern in b.data)]
    payloads = {
        "nesting-bomb": lambda i: b"\x81" * 100_000 + b"\x80",
        "huge-length": lambda i: b"\x5b" + (1 << 63).to_bytes(8, "big"),
        "trailing": lambda i: blocks[i].data + b"\x00",
        "tag-43": lambda i: blocks[i].data.replace(b"\x84\x00\x40\x1a", b"\x84\x00\xd8\x2b\x00\x1a", 1),
    }
    bites = 0
    for i in positions:
        damaged = list(blocks)
        damaged[i] = ProofBlock(blocks[i].cid, payloads[damage](i))
        ours, ref, scalar = _event_outcomes(proofs, damaged)
        assert ours == ref == scalar, f"block {i}: ours={ours} ref={ref} scalar={scalar}"
        bites += ours[0] == "raise" or not all(ours[1])
    assert bites > 0


# --- the TxMeta recompute on the backend -------------------------------------


class _Spy:
    """A hash backend that records its calls and can return one wrong digest
    (the first row's, with one bit flipped)."""

    def __init__(self, clean: bool):
        self.clean = clean
        self.calls = []

    def blake2b256_batch(self, messages):
        self.calls.append(list(messages))
        digests = BACKEND.blake2b256_batch(messages)
        if not self.clean:
            digests[0] = bytes([digests[0][0] ^ 1]) + digests[0][1:]
        return digests


@pytest.mark.parametrize("clean", [True, False], ids=["batch-clean", "batch-failed"])
def test_txmeta_recompute_runs_once_on_the_backend(clean):
    proofs, blocks = _event_base(3, "compact")
    store = load_witness_store(blocks)
    groups = sorted({tuple(p.parent_tipset_cids) for p in proofs})
    groups = [[CID.from_string(c) for c in g] for g in groups]
    spy = _Spy(clean)
    orders = reconstruct_execution_orders_batch(store, groups, hash_backend=spy)
    # one batch for the whole range: every group's TxMeta block, in group order
    [raws] = spy.calls
    txmetas = [decode_header_lite(store.get(c)).messages for g in groups for c in g]
    assert raws == [store.get(t) for t in txmetas]
    scalar = [[c.to_bytes() for c in reconstruct_execution_order(store, g)] for g in groups]
    # the backend's digest decides: a wrong one fails the group that holds
    # its row (the first) and no other; the host does not rehash
    assert orders == (scalar if clean else [None, *scalar[1:]])


def test_tampered_txmeta_fails_its_group_only():
    """A TxMeta block swapped for another canonical one (its two message
    roots exchanged) hashes to another digest in the backend's batch, which
    fails the group that reads it and no other."""
    store, pairs, _ = build_range_world(4, 4, 2, 0.5)
    groups = [list(pair.parent.cids) for pair in pairs]
    txmetas = [decode_header_lite(store.get(g[0])).messages for g in groups]
    assert len(set(txmetas)) == len(groups)
    bls, secp = decode(store.get(txmetas[0]))
    damaged = MemoryBlockstore()
    for cid, data in store.items():
        damaged.put_keyed(cid, encode([secp, bls]) if cid == txmetas[0] else data)
    spy = _Spy(clean=True)
    orders = reconstruct_execution_orders_batch(damaged, groups, hash_backend=spy)
    assert len(spy.calls) == 1
    assert orders[0] is None and all(o is not None for o in orders[1:])
    clean = reconstruct_execution_orders_batch(store, groups, hash_backend=BACKEND)
    assert orders[1:] == clean[1:]


# --- storage bundles ---------------------------------------------------------


def _storage_world(contract_cls, event_cls, build, generate, spec_cls, store_cls, encodings, **kw):
    store = store_cls()
    contracts, specs = [], []
    for c, enc in enumerate(encodings):
        storage = {
            calculate_storage_slot(f"sub-{c}-{i}", 0): (c * 10 + i + 1).to_bytes(2, "big")
            for i in range(4)
        }
        contracts.append(contract_cls(actor_id=100 + c, storage=storage, storage_encoding=enc))
        specs += [spec_cls(100 + c, slot) for slot in storage]
        specs.append(spec_cls(100 + c, calculate_storage_slot(f"sub-{c}-absent", 7)))
    world = build(contracts, [[event_cls(emitter=100, signature="E()", topic1="x")]], store=store)
    return generate(store, world.parent, world.child, specs, [], **kw)


_STORAGE_BASES: dict = {}


def _storage_base(encodings):
    if encodings not in _STORAGE_BASES:
        ours = _storage_world(ContractFixture, EventFixture, build_chain, generate_proof_bundle,
                              StorageProofSpec, MemoryBlockstore, encodings, match_backend=BACKEND)
        ref = _storage_world(RefContract, RefEvent, ref_build_chain, ref_generate_bundle,
                             RefStorageSpec, RefStore, encodings)
        assert ours.to_json() == ref.to_json()
        _STORAGE_BASES[encodings] = (ours.storage_proofs, ours.blocks)
    return _STORAGE_BASES[encodings]


def _storage_outcomes(proofs, blocks):
    def ours():
        store = load_witness_store(blocks)
        return verify_storage_proofs_batch(store, proofs, accept)

    def ref():
        store = ref_load_witness(_ref_blocks(blocks))
        return ref_verify_storage_batch(store, [RefStorageProof(**vars(p)) for p in proofs], accept)

    def scalar():
        store = load_witness_store(blocks)
        return [verify_storage_proof(p, blocks, accept, store=store) for p in proofs]

    return _outcome(ours), _outcome(ref), _outcome(scalar)


def _mutate_storage_proof(rng: random.Random, proof):
    choice = rng.randrange(9)
    if choice == 0:
        return dataclasses.replace(proof, child_epoch=proof.child_epoch + rng.choice([-1, 1, 999]))
    if choice == 1:
        return dataclasses.replace(
            proof, child_block_cid=rng.choice(["", "b", "junk", str(CID.hash_of(rng.randbytes(4)))])
        )
    if choice == 2:
        return dataclasses.replace(
            proof,
            parent_state_root=rng.choice(
                [str(CID.hash_of(rng.randbytes(4))), proof.parent_state_root.upper()]
            ),
        )
    if choice == 3:
        return dataclasses.replace(proof, actor_id=rng.choice([-1, 0, proof.actor_id + 1, 2**63]))
    if choice == 4:
        return dataclasses.replace(
            proof, actor_state_cid=str(CID.hash_of(rng.randbytes(4), codec=RAW))
        )
    if choice == 5:
        return dataclasses.replace(
            proof, storage_root=rng.choice(["", str(CID.hash_of(rng.randbytes(4)))])
        )
    if choice == 6:
        slot = proof.slot
        return dataclasses.replace(proof, slot=rng.choice([
            slot[:-1], slot + "0", slot.removeprefix("0x"), "0x" + "zz" * 32,
            slot.upper().replace("0X", "0x"),
        ]))
    if choice == 7:
        value = proof.value
        return dataclasses.replace(proof, value=rng.choice([
            "0x" + "ff" * 32, value.upper().replace("0X", "0x"), value[:-2], value[2:],
            value[:6] + " " + value[6:],
        ]))
    return dataclasses.replace(proof, slot=proof.value, value=proof.slot)


def _mutate_storage(rng: random.Random, proofs, blocks):
    kind = rng.randrange(8)
    if kind == 0:
        drop = rng.randrange(len(blocks))
        return proofs, [b for i, b in enumerate(blocks) if i != drop]
    if kind == 1:
        return proofs, _flip(rng, blocks)
    if kind == 2:  # trailing garbage after a block
        i = rng.randrange(len(blocks))
        blocks = list(blocks)
        blocks[i] = ProofBlock(blocks[i].cid, blocks[i].data + b"\x00")
        return proofs, blocks
    if kind == 3 and len(proofs) >= 2:  # cross-wire two proofs' roots
        i, j = rng.sample(range(len(proofs)), 2)
        proofs = list(proofs)
        proofs[i] = dataclasses.replace(
            proofs[i], actor_state_cid=proofs[j].actor_state_cid, storage_root=proofs[j].storage_root
        )
        return proofs, blocks
    if kind == 4:
        proofs = list(proofs)
        rng.shuffle(proofs)
        return proofs, blocks
    proofs = list(proofs)
    for _ in range(rng.randrange(1, 4)):
        i = rng.randrange(len(proofs))
        proofs[i] = _mutate_storage_proof(rng, proofs[i])
    return proofs, blocks


STORAGE_ENCODINGS = ["direct", "wrapper_tuple", "wrapper_map", "inline"]


@pytest.mark.parametrize("seed", [7, 0xA17, 424242, 102662185, 0x5A5A, 88230, 11, 99])
def test_storage_verdicts_equal_reference_on_mutants(seed):
    rng = random.Random(seed)
    kinds = set()
    for _ in range(2):
        encodings = tuple(rng.choice(STORAGE_ENCODINGS) for _ in range(rng.randrange(2, 5)))
        base = _storage_base(encodings)
        for _ in range(30):
            proofs, blocks = _mutate_storage(rng, *base)
            if rng.random() < 0.3:
                proofs, blocks = _mutate_storage(rng, proofs, blocks)
            ours, ref, scalar = _storage_outcomes(proofs, blocks)
            assert ours == ref == scalar, f"seed={seed}: ours={ours} ref={ref} scalar={scalar}"
            kinds.add(ours[0] if ours[0] == "raise" else all(ours[1]))
    assert {"raise", False} <= kinds


# --- whole bundles -----------------------------------------------------------


@pytest.mark.parametrize("encoding", STORAGE_ENCODINGS)
def test_unified_verdicts_equal_reference(encoding):
    """`verify_proof_bundle` with both proof kinds: the batched storage and
    event verifiers give the reference's verdicts, with a changed value and
    a changed event claim given false ones."""
    s_proofs, s_blocks = _storage_base((encoding, "direct"))
    e_proofs, e_blocks = _event_base(2, "compact")
    by_cid = {b.cid.to_bytes(): b for b in s_blocks + e_blocks}
    blocks = [by_cid[k] for k in sorted(by_cid)]
    s_proofs = list(s_proofs)
    s_proofs[1] = dataclasses.replace(s_proofs[1], value="0x" + "ee" * 32)
    e_proofs = list(e_proofs)
    e_proofs[0] = dataclasses.replace(e_proofs[0], event_index=e_proofs[0].event_index + 1)
    ours = verify_proof_bundle(
        UnifiedProofBundle(s_proofs, e_proofs, blocks), PortTrustPolicy.accept_all(),
        verify_witness_cids=True, cid_backend=BACKEND,
    )
    ref = ref_verify(
        RefUnified([RefStorageProof(**vars(p)) for p in s_proofs], _ref_event_proofs(e_proofs),
                   _ref_blocks(blocks)),
        TrustPolicy.accept_all(),
    )
    assert ours.storage_results == ref.storage_results
    assert ours.event_results == ref.event_results
    assert ours.storage_results.count(False) == 1 and ours.event_results.count(False) == 1
