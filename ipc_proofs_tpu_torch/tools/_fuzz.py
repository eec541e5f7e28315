"""The soak's differential fuzz harness: the port's own copies of the
reference's mutators, outcome collapses and fixtures.

The reference's ``tools/soak.py`` imports these from its test files
(``tests/test_batch_verifier_fuzz.py``, ``tests/test_storage_batch_verifier_fuzz.py``,
``tests/test_codec_exec_fuzz.py``, and the fixtures of ``test_cert_cbor``,
``test_native_dagcbor``, ``test_bls``), which import the JAX package, so
the port keeps its own. Each mutator draws from its `random.Random`
exactly as the reference's does: the same seed over the same base bundle
gives the same mutant in both packages (tests/test_torch_soak.py holds
them byte for byte).

The verdict authority is the reference's: the scalar path on the host is
the authority, the batched path runs on ``backend`` (the card unless the
caller passes ``get_backend("gpu", device="cpu")``). On the card the event
differentials launch blake2b (the batched replay's TxMeta recompute), the
storage differentials keccak (each base world's slot digests, one
`hash_slot_specs` batch) and the exec-order parity blake2b.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import random

from ipc_proofs_tpu_torch.backend.native import load_dagcbor_ext
from ipc_proofs_tpu_torch.core.cid import CID, RAW, PurePythonCID
from ipc_proofs_tpu_torch.crypto.rleplus import encode_rleplus
from ipc_proofs_tpu_torch.fixtures import ContractFixture, EventFixture, build_chain
from ipc_proofs_tpu_torch.proofs.bundle import EventProofBundle, ProofBlock, UnifiedProofBundle
from ipc_proofs_tpu_torch.proofs.cert import (
    ECTipSet,
    FinalityCertificate,
    PowerTableDelta,
    SupplementalData,
)
from ipc_proofs_tpu_torch.proofs.event_generator import generate_event_proof
from ipc_proofs_tpu_torch.proofs.event_verifier import verify_event_proof
from ipc_proofs_tpu_torch.proofs.exec_order import (
    reconstruct_execution_order,
    reconstruct_execution_orders_batch,
)
from ipc_proofs_tpu_torch.proofs.generator import StorageProofSpec, generate_proof_bundle
from ipc_proofs_tpu_torch.proofs.storage_batch import MappingSlotSpec, hash_slot_specs
from ipc_proofs_tpu_torch.proofs.storage_verifier import (
    verify_storage_proof,
    verify_storage_proofs_batch,
)
from ipc_proofs_tpu_torch.proofs.witness import load_witness_store
from ipc_proofs_tpu_torch.store.blockstore import MemoryBlockstore

SIG = "NewTopDownMessage(bytes32,uint256)"
SUBNET = "batch-subnet"
ACTOR = 321


def _accept(*_):
    return True


def _family(exc: BaseException) -> str:
    return "KeyError" if isinstance(exc, KeyError) else "ValueError" if isinstance(exc, ValueError) \
        else type(exc).__name__


def comparable(outcome):
    """Collapse an outcome to what the parity contract promises: verdict
    vectors compare exactly; both raising within the abort family (KeyError,
    the ValueError family) agrees; any other exception keeps its name, so an
    unplanned crash is never masked."""
    if outcome[0] == "ok":
        return outcome[:2]
    family = outcome[1]
    return ("raise", "abort" if family in ("KeyError", "ValueError") else family)


# --- event verification --------------------------------------------------------


def make_bundle(n_pairs: int = 3, encoding: str = "compact", backend=None) -> EventProofBundle:
    """The reference's ``tests/test_batch_verifier.make_bundle`` world:
    per pair a matching event, a noise receipt and a receipt of two events
    (one from another emitter); witness blocks in first-seen order."""
    bs = MemoryBlockstore()
    proofs, blocks = [], {}
    for p in range(n_pairs):
        events = [
            [EventFixture(emitter=ACTOR, signature=SIG, topic1=SUBNET,
                          data=p.to_bytes(32, "big"), encoding=encoding)],
            [EventFixture(emitter=ACTOR, signature="Noise()", topic1="x")],
            [
                EventFixture(emitter=ACTOR, signature=SIG, topic1=SUBNET,
                             extra_topics=[b"\x05" * 32], encoding=encoding),
                EventFixture(emitter=999, signature=SIG, topic1=SUBNET),
            ],
        ]
        world = build_chain([ContractFixture(actor_id=ACTOR)], events,
                            parent_height=10 + 2 * p, store=bs)
        bundle = generate_event_proof(
            world.store, world.parent, world.child, SIG, SUBNET, actor_id_filter=ACTOR,
            match_backend=backend,
        )
        proofs.extend(bundle.proofs)
        for b in bundle.blocks:
            blocks[b.cid] = b
    return EventProofBundle(proofs=proofs, blocks=list(blocks.values()))


def event_outcome(bundle, batch: bool, backend=None):
    """("ok", verdicts) or ("raise", family, type, message) of one verify
    path; the batched path recomputes TxMeta CIDs on ``backend``."""
    try:
        return ("ok", verify_event_proof(bundle, _accept, _accept, batch=batch, hash_backend=backend))
    except Exception as exc:  # noqa: BLE001 — parity includes the exception
        return ("raise", _family(exc), type(exc).__name__, str(exc))


def mutate_proof(rng: random.Random, proof):
    """One random claim-field mutation (returns a new EventProof)."""
    ed = proof.event_data
    choice = rng.randrange(12)
    if choice == 0:
        return dataclasses.replace(
            proof, exec_index=rng.choice([-1, 0, 3, 2**31, 2**63, 10**20])
        )
    if choice == 1:
        return dataclasses.replace(
            proof, event_index=rng.choice([-5, 1, 2**31 - 1, 2**40])
        )
    if choice == 2:  # JSON-plausible non-int indices
        as_float = (
            float(proof.exec_index)
            if isinstance(proof.exec_index, int)
            else 1.5  # proof already mutated to a non-number
        )
        return dataclasses.replace(
            proof, exec_index=rng.choice([as_float, "0", None])
        )
    if choice == 3:
        return dataclasses.replace(
            proof, child_epoch=proof.child_epoch + rng.choice([-1, 1, 1000])
        )
    if choice == 4:
        return dataclasses.replace(
            proof, parent_epoch=proof.parent_epoch + rng.choice([-1, 1])
        )
    if choice == 5:
        return dataclasses.replace(
            proof,
            message_cid=str(CID.hash_of(rng.randbytes(8), codec=RAW)),
        )
    if choice == 6:  # malformed CID strings
        return dataclasses.replace(
            proof,
            child_block_cid=rng.choice(
                ["", "b", "not-a-cid", proof.child_block_cid[:-1]]
            ),
        )
    if choice == 7:
        return dataclasses.replace(
            proof,
            parent_tipset_cids=rng.choice(
                [
                    [],
                    list(reversed(proof.parent_tipset_cids)) * 2,
                    [str(CID.hash_of(rng.randbytes(4)))],
                ]
            ),
        )
    if choice == 8:
        return dataclasses.replace(
            proof, event_data=dataclasses.replace(ed, emitter=rng.randrange(5000))
        )
    if choice == 9:
        topics = list(ed.topics)
        if topics:
            i = rng.randrange(len(topics))
            t = topics[i]
            topics[i] = rng.choice(
                [
                    t.upper().replace("0X", "0x"),
                    t[:-1],
                    t + "0",
                    t.removeprefix("0x"),
                    t[:6] + " " + t[6:],
                    "0x" + "cd" * 32,
                ]
            )
        return dataclasses.replace(
            proof, event_data=dataclasses.replace(ed, topics=topics)
        )
    if choice == 10:
        return dataclasses.replace(
            proof,
            event_data=dataclasses.replace(
                ed,
                data=rng.choice(
                    [ed.data + "ff", ed.data[:-1], "0x" + "0" * 63, ""]
                ),
            ),
        )
    return dataclasses.replace(
        proof, event_data=dataclasses.replace(ed, topics=ed.topics + [ed.data])
    )


def mutate_bundle(rng: random.Random, proofs, blocks):
    """Apply one structural mutation; returns (proofs, blocks)."""
    kind = rng.randrange(10)
    if kind == 0 and blocks:  # drop a witness block
        drop = rng.randrange(len(blocks))
        return proofs, [b for i, b in enumerate(blocks) if i != drop]
    if kind == 1 and blocks:  # bit-flip inside a witness block (CID kept)
        i = rng.randrange(len(blocks))
        data = bytearray(blocks[i].data)
        if data:
            data[rng.randrange(len(data))] ^= 1 << rng.randrange(8)
        blocks = list(blocks)
        blocks[i] = ProofBlock(cid=blocks[i].cid, data=bytes(data))
        return proofs, blocks
    if kind == 2 and len(proofs) >= 2:  # cross-wire two proofs' claims
        i, j = rng.sample(range(len(proofs)), 2)
        proofs = list(proofs)
        proofs[i] = dataclasses.replace(
            proofs[i],
            message_cid=proofs[j].message_cid,
            exec_index=proofs[j].exec_index,
        )
        return proofs, blocks
    if kind == 3:  # duplicate a proof
        proofs = list(proofs) + [rng.choice(proofs)]
        return proofs, blocks
    if kind == 4:  # shuffle proof order (groups re-form differently)
        proofs = list(proofs)
        rng.shuffle(proofs)
        return proofs, blocks
    # default: mutate 1-3 random proofs' claim fields
    proofs = list(proofs)
    for _ in range(rng.randrange(1, 4)):
        i = rng.randrange(len(proofs))
        proofs[i] = mutate_proof(rng, proofs[i])
    return proofs, blocks


def event_mutants(rng: random.Random, base: EventProofBundle, rounds: int):
    """The differential's mutants in draw order: mutate, and with
    probability 0.3 mutate again."""
    for _ in range(rounds):
        proofs, blocks = mutate_bundle(rng, base.proofs, base.blocks)
        if rng.random() < 0.3:
            proofs, blocks = mutate_bundle(rng, proofs, blocks)
        yield EventProofBundle(proofs=proofs, blocks=blocks)


def run_differential(rng, seed, base, rounds, backend=None):
    """Mutate-and-compare loop: both verify paths over every mutant, outcome
    parity asserted. Returns (agree_raise, agree_ok) tallies."""
    agree_raise = agree_ok = 0
    for mutated in event_mutants(rng, base, rounds):
        scalar = event_outcome(mutated, batch=False)
        batch = event_outcome(mutated, batch=True, backend=backend)
        assert comparable(scalar) == comparable(batch), (
            f"divergence under seed={seed}: scalar={scalar!r} batch={batch!r}"
        )
        if scalar[0] == "raise":
            agree_raise += 1
        else:
            agree_ok += 1
    return agree_raise, agree_ok


def shape_varied_mutation_differential(seed: int, backend=None) -> None:
    """Base worlds of varied pair count and claim encoding, 30 mutants each."""
    rng = random.Random(seed)
    agree_raise = agree_ok = 0
    for _ in range(4):
        base = make_bundle(
            n_pairs=rng.choice([1, 2, 3, 4]),
            encoding=rng.choice(["compact", "concat"]),
            backend=backend,
        )
        r, o = run_differential(rng, seed, base, 30, backend)
        agree_raise += r
        agree_ok += o
    assert agree_raise and agree_ok  # the sweep exercised both regimes


def randomized_mutation_differential(seed: int, backend=None) -> None:
    """150 mutants of the two-pair world."""
    rng = random.Random(seed)
    agree_raise, agree_ok = run_differential(rng, seed, make_bundle(n_pairs=2, backend=backend), 150, backend)
    assert agree_raise and agree_ok


# --- storage verification ------------------------------------------------------


def make_storage_bundle(encodings=("direct",), n_slots: int = 3, backend=None) -> UnifiedProofBundle:
    """The reference's ``tests/test_storage_batch_verifier.make_storage_bundle``
    world; every slot digest (``keccak(key32 ‖ be32(slot))``) comes from one
    `hash_slot_specs` batch on ``backend``."""
    grid = []
    for c in range(len(encodings)):
        grid += [MappingSlotSpec(100 + c, f"sub-{c}-{i}", 0) for i in range(n_slots)]
        grid.append(MappingSlotSpec(100 + c, f"sub-{c}-absent", 7))
    slots = iter(hash_slot_specs(grid, backend))
    bs = MemoryBlockstore()
    contracts, specs = [], []
    for c, enc in enumerate(encodings):
        present = [next(slots) for _ in range(n_slots)]
        absent = next(slots)
        storage = {slot: (c * 10 + i + 1).to_bytes(2, "big") for i, slot in enumerate(present)}
        contracts.append(ContractFixture(actor_id=100 + c, storage=storage, storage_encoding=enc))
        specs += [StorageProofSpec(actor_id=100 + c, slot=slot) for slot in present]
        specs.append(StorageProofSpec(actor_id=100 + c, slot=absent))  # the zero-value path
    world = build_chain(
        contracts, [[EventFixture(emitter=100, signature="E()", topic1="x")]], store=bs
    )
    bundle = generate_proof_bundle(bs, world.parent, world.child, specs, [], match_backend=backend)
    assert len(bundle.storage_proofs) == len(specs)
    return bundle


def storage_outcome(proofs, blocks, batch: bool):
    try:
        store = load_witness_store(blocks, verify_cids=False)
        if batch:
            out = verify_storage_proofs_batch(store, proofs, _accept)
            if out is None:
                raise RuntimeError("native hamt_lookup_batch unavailable")
        else:
            out = [verify_storage_proof(p, blocks, _accept, store=store) for p in proofs]
        return ("ok", out)
    except Exception as exc:  # noqa: BLE001 — parity includes the exception
        return ("raise", _family(exc), type(exc).__name__, str(exc))


def mutate_storage_proof(rng: random.Random, proof):
    choice = rng.randrange(9)
    if choice == 0:
        return dataclasses.replace(
            proof, child_epoch=proof.child_epoch + rng.choice([-1, 1, 999])
        )
    if choice == 1:
        return dataclasses.replace(
            proof,
            child_block_cid=rng.choice(
                ["", "b", "junk", str(CID.hash_of(rng.randbytes(4)))]
            ),
        )
    if choice == 2:
        return dataclasses.replace(
            proof,
            parent_state_root=rng.choice(
                [str(CID.hash_of(rng.randbytes(4))), proof.parent_state_root.upper()]
            ),
        )
    if choice == 3:
        return dataclasses.replace(
            proof, actor_id=rng.choice([-1, 0, proof.actor_id + 1, 2**63])
        )
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
        return dataclasses.replace(
            proof,
            slot=rng.choice(
                [slot[:-1], slot + "0", slot.removeprefix("0x"), "0x" + "zz" * 32,
                 slot.upper().replace("0X", "0x")]
            ),
        )
    if choice == 7:
        value = proof.value
        return dataclasses.replace(
            proof,
            value=rng.choice(
                ["0x" + "ff" * 32, value.upper().replace("0X", "0x"),
                 value[:-2], value[2:], value[:6] + " " + value[6:]]
            ),
        )
    return dataclasses.replace(
        proof, slot=proof.value, value=proof.slot  # cross-wire the hex fields
    )


def mutate_storage(rng: random.Random, proofs, blocks):
    kind = rng.randrange(8)
    if kind == 0 and blocks:
        drop = rng.randrange(len(blocks))
        return proofs, [b for i, b in enumerate(blocks) if i != drop]
    if kind == 1 and blocks:
        i = rng.randrange(len(blocks))
        data = bytearray(blocks[i].data)
        if data:
            data[rng.randrange(len(data))] ^= 1 << rng.randrange(8)
        blocks = list(blocks)
        blocks[i] = ProofBlock(cid=blocks[i].cid, data=bytes(data))
        return proofs, blocks
    if kind == 2 and blocks:  # trailing garbage after a block
        i = rng.randrange(len(blocks))
        blocks = list(blocks)
        blocks[i] = ProofBlock(cid=blocks[i].cid, data=blocks[i].data + b"\x00")
        return proofs, blocks
    if kind == 3 and len(proofs) >= 2:  # cross-wire two proofs' roots
        i, j = rng.sample(range(len(proofs)), 2)
        proofs = list(proofs)
        proofs[i] = dataclasses.replace(
            proofs[i],
            actor_state_cid=proofs[j].actor_state_cid,
            storage_root=proofs[j].storage_root,
        )
        return proofs, blocks
    if kind == 4:
        proofs = list(proofs)
        rng.shuffle(proofs)
        return proofs, blocks
    proofs = list(proofs)
    for _ in range(rng.randrange(1, 4)):
        i = rng.randrange(len(proofs))
        proofs[i] = mutate_storage_proof(rng, proofs[i])
    return proofs, blocks


def storage_mutants(rng: random.Random, base_proofs, base_blocks, rounds: int):
    for _ in range(rounds):
        proofs, blocks = mutate_storage(rng, base_proofs, base_blocks)
        if rng.random() < 0.3:
            proofs, blocks = mutate_storage(rng, proofs, blocks)
        yield proofs, blocks


def run_storage_differential(rng, seed, base_proofs, base_blocks, rounds):
    agree_raise = agree_ok = 0
    for proofs, blocks in storage_mutants(rng, base_proofs, base_blocks, rounds):
        scalar = storage_outcome(proofs, blocks, batch=False)
        batch = storage_outcome(proofs, blocks, batch=True)
        assert comparable(scalar) == comparable(batch), (
            f"divergence under seed={seed}: scalar={scalar!r} batch={batch!r}"
        )
        if scalar[0] == "raise":
            agree_raise += 1
        else:
            agree_ok += 1
    return agree_raise, agree_ok


STORAGE_ENCODINGS = ("direct", "wrapper_tuple", "wrapper_map", "inline")


def shape_varied_storage_mutation_differential(seed: int, backend=None) -> None:
    rng = random.Random(seed)
    agree_raise = agree_ok = 0
    for _ in range(3):
        base = make_storage_bundle(
            encodings=tuple(rng.choice(STORAGE_ENCODINGS) for _ in range(rng.randrange(1, 5))),
            n_slots=rng.choice([1, 2, 3, 5]),
            backend=backend,
        )
        r, o = run_storage_differential(rng, seed, base.storage_proofs, base.blocks, 30)
        agree_raise += r
        agree_ok += o
    assert agree_raise and agree_ok  # the sweep exercised both regimes


def randomized_storage_mutation_differential(seed: int, backend=None) -> None:
    rng = random.Random(seed)
    base = make_storage_bundle(encodings=("direct", "inline", "wrapper_tuple"), backend=backend)
    agree_raise, agree_ok = run_storage_differential(rng, seed, base.storage_proofs, base.blocks, 120)
    assert agree_raise and agree_ok  # both regimes exercised


# --- codecs and the exec-order walker -----------------------------------------

_B32 = "abcdefghijklmnopqrstuvwxyz234567"


def mutate_str(rng: random.Random, s: str) -> str:
    kind = rng.randrange(7)
    if kind == 0 and s:  # substitute with base32 / invalid / uppercase char
        i = rng.randrange(len(s))
        ch = rng.choice(_B32 + _B32.upper() + "018!=. é")
        return s[:i] + ch + s[i + 1:]
    if kind == 1 and s:
        return s[: rng.randrange(len(s))]  # truncate
    if kind == 2:
        return s + rng.choice(_B32)  # extend
    if kind == 3 and s:
        return rng.choice(["z", "f", "B", ""]) + s[1:]  # multibase prefix
    if kind == 4:
        return s.upper()
    if kind == 5:
        return s + "="  # base32 padding is not accepted unpadded-only
    return s  # unmutated valid string (keeps the accept regime exercised)


def _ext(attr: str):
    ext = load_dagcbor_ext()
    if ext is None or not hasattr(ext, attr):
        raise RuntimeError(f"native {attr} unavailable")
    return ext


def cid_string_mutants(rng: random.Random, n: int = 600):
    bases = [str(CID.hash_of(bytes([i]))) for i in range(8)]
    bases.append(str(CID.hash_of(b"raw", codec=0x55)))
    for _ in range(n):
        s = mutate_str(rng, rng.choice(bases))
        if rng.random() < 0.3:
            s = mutate_str(rng, s)
        yield s


def cid_string_codec_acceptance_parity(seed: int) -> None:
    ext = _ext("cids_from_strs")
    accepted = rejected = 0
    for s in cid_string_mutants(random.Random(seed)):
        try:
            scalar = ("ok", PurePythonCID.from_string(s))
        except ValueError:
            scalar = ("reject",)
        try:
            native = ("ok", CID.from_string(s))
        except ValueError:
            native = ("reject",)
        try:
            batch = ("ok", ext.cids_from_strs([s])[0])
        except ValueError:
            batch = ("reject",)
        assert scalar == native == batch, (
            f"CID string {s!r}: scalar={scalar} native={native} batch={batch}"
        )
        if scalar[0] == "ok":
            # canonical form: an accepted string IS its CID's unique string
            assert str(scalar[1]) == s, f"non-canonical string accepted: {s!r}"
            accepted += 1
        else:
            rejected += 1
    assert accepted and rejected  # both regimes exercised


def cid_bytes_mutants(rng: random.Random, n: int = 600):
    bases = [CID.hash_of(bytes([i])).to_bytes() for i in range(8)]
    for _ in range(n):
        raw = bytearray(rng.choice(bases))
        for _ in range(rng.randrange(1, 3)):
            kind = rng.randrange(4)
            if kind == 0 and raw:
                raw[rng.randrange(len(raw))] ^= 1 << rng.randrange(8)
            elif kind == 1 and raw:
                del raw[rng.randrange(len(raw))]
            elif kind == 2:
                raw.insert(rng.randrange(len(raw) + 1), rng.randrange(256))
        yield bytes(raw)


def cid_bytes_codec_acceptance_parity(seed: int) -> None:
    ext = _ext("make_cids")
    accepted = rejected = 0
    for raw in cid_bytes_mutants(random.Random(seed)):
        try:
            scalar = ("ok", PurePythonCID.from_bytes(raw))
        except ValueError:
            scalar = ("reject",)
        try:
            native = ("ok", CID.from_bytes(raw))
        except ValueError:
            native = ("reject",)
        try:
            batch = ("ok", ext.make_cids([raw])[0])
        except ValueError:
            batch = ("reject",)
        assert scalar == native == batch, (
            f"CID bytes {raw.hex()}: scalar={scalar} native={native} batch={batch}"
        )
        if scalar[0] == "ok":
            accepted += 1
        else:
            rejected += 1
    assert accepted and rejected


def exec_groups_and_store(backend=None):
    """Witness store + per-proof parent-header groups of the three-pair
    event world, and its raw block map (CID → bytes)."""
    bundle = make_bundle(n_pairs=3, backend=backend)
    store = MemoryBlockstore()
    for b in bundle.blocks:
        store.put_keyed(b.cid, b.data)
    seen = set()
    groups = []
    for p in bundle.proofs:
        key = tuple(p.parent_tipset_cids)
        if key not in seen:
            seen.add(key)
            groups.append([CID.from_string(c) for c in key])
    return store, groups, {b.cid: b.data for b in bundle.blocks}


def corrupted_stores(rng: random.Random, raw_map: dict, n: int = 120):
    """Copies of the witness store with blocks flipped, truncated, extended
    or dropped, in the reference's draw order."""
    cids = list(raw_map)
    for _ in range(n):
        mutated = MemoryBlockstore()
        drop = rng.choice(cids) if rng.random() < 0.3 else None
        for cid, raw in raw_map.items():
            if cid == drop:
                continue
            if rng.random() < 0.25:
                data = bytearray(raw)
                kind = rng.randrange(3)
                if kind == 0 and data:
                    data[rng.randrange(len(data))] ^= 1 << rng.randrange(8)
                elif kind == 1 and data:
                    del data[rng.randrange(len(data)):]
                else:
                    data += b"\x00"
                raw = bytes(data)
            mutated.put_keyed(cid, raw)
        yield mutated


def exec_order_batch_scalar_parity_under_corruption(seed: int, backend=None) -> None:
    rng = random.Random(seed)
    _store, groups, raw_map = exec_groups_and_store(backend)
    none_groups = 0
    for mutated in corrupted_stores(rng, raw_map):
        batch = reconstruct_execution_orders_batch(mutated, groups, hash_backend=backend)
        assert batch is not None
        for g, group in enumerate(groups):
            try:
                scalar = [c.to_bytes() for c in reconstruct_execution_order(mutated, group)]
            except (KeyError, ValueError):
                scalar = None
            assert batch[g] == scalar, (
                f"group {g} diverged under seed={seed}: batch={batch[g]!r} scalar={scalar!r}"
            )
            if scalar is None:
                none_groups += 1
    assert none_groups  # the corruption actually bit


# --- JSON trust boundaries -----------------------------------------------------


def _garbage_mutator(rng: random.Random, garbage_values, action_draw: bool):
    """The reference's one-node mutation of a deep copy: pick a (container,
    key) site; the bundle harness deletes a dict key on a draw of 1 of 3,
    the certificate harness on action 1 of 3 (each draws as its own)."""

    def mutate(obj):
        doc = copy.deepcopy(obj)
        sites = []

        def walk(node):
            if isinstance(node, dict):
                for k in node:
                    sites.append((node, k))
                    walk(node[k])
            elif isinstance(node, list):
                for i in range(len(node)):
                    sites.append((node, i))
                    walk(node[i])

        walk(doc)
        container, key = rng.choice(sites)
        if action_draw:
            action = rng.randrange(3)
            if action == 0:
                container[key] = rng.choice(garbage_values)
            elif action == 1 and isinstance(container, dict):
                del container[key]
            else:
                container[key] = rng.choice(garbage_values)
        elif rng.randrange(3) == 1 and isinstance(container, dict):
            del container[key]
        else:
            container[key] = rng.choice(garbage_values)
        return doc

    return mutate


BUNDLE_GARBAGE = [
    None, True, False, -1, 3.5, "x", "", [], {}, [None], {"k": 1},
    "AAA!", 2**70, [2**70],
]
CERT_GARBAGE = [
    None, True, False, 0, -1, 3.5, "x", "", [], {}, [None], {"/": 5},
    {"/": None}, [["nested"]], "not-base64!!", {"Epoch": None}, 2**70,
]
CERT_JSON = {
    "GPBFTInstance": 7,
    "ECChain": [
        {"Epoch": 10, "Key": [{"/": "bafyaa"}], "PowerTable": {"/": "bafypt"}},
        {"Epoch": 11, "Key": ["bafybb"], "PowerTable": "bafypt"},
    ],
    "SupplementalData": {"PowerTable": {"/": "bafypt2"}, "Commitments": [0] * 4},
    "Signers": "AAE=",
    "Signature": "",
    "PowerTableDelta": [
        {"ParticipantID": 3, "PowerDelta": "100", "SigningKey": "", "Pop": ""}
    ],
}


def bundle_json_mutants(rng: random.Random, base: dict, n: int = 250):
    mutate = _garbage_mutator(rng, BUNDLE_GARBAGE, action_draw=False)
    for _ in range(n):
        doc = mutate(base)
        if rng.random() < 0.3:
            doc = mutate(doc)
        yield doc


def bundle_json_garbage_never_leaks(seed: int, backend=None) -> None:
    """`UnifiedProofBundle.from_json_obj` rejects every malformed shape as
    ValueError (anything else propagates)."""
    base = json.loads(make_storage_bundle(backend=backend).to_json())
    parsed = rejected = 0
    for doc in bundle_json_mutants(random.Random(seed), base):
        try:
            UnifiedProofBundle.from_json_obj(doc)
            parsed += 1
        except ValueError:
            rejected += 1
    assert parsed and rejected


def cert_json_mutants(rng: random.Random, n: int = 300):
    mutate = _garbage_mutator(rng, CERT_GARBAGE, action_draw=True)
    for _ in range(n):
        doc = mutate(CERT_JSON)
        if rng.random() < 0.3:
            doc = mutate(doc)
        yield doc


def cert_json_garbage_never_leaks(seed: int) -> None:
    """`FinalityCertificate.from_json_obj` rejects every malformed shape as
    ValueError (anything else propagates)."""
    parsed = rejected = 0
    for doc in cert_json_mutants(random.Random(seed)):
        try:
            FinalityCertificate.from_json_obj(doc)
            parsed += 1
        except ValueError:
            rejected += 1
    assert parsed and rejected


# --- fixtures of the cert and dag-cbor phases ------------------------------------


def _cid(tag: str) -> CID:
    return CID.hash_of(tag.encode())


def sample_certificate() -> FinalityCertificate:
    """The reference's ``tests/test_cert_cbor._cert`` certificate."""
    import base64

    return FinalityCertificate(
        instance=42,
        ec_chain=[
            ECTipSet(
                key=[str(_cid("blk-a")), str(_cid("blk-b"))],
                epoch=100,
                power_table=str(_cid("pt-0")),
                commitments=bytes(32),
            ),
            ECTipSet(
                key=[str(_cid("blk-c"))],
                epoch=101,
                power_table=str(_cid("pt-1")),
                commitments=b"\x11" * 32,
            ),
        ],
        supplemental_data=SupplementalData(
            commitments=b"\x22" * 32, power_table=str(_cid("pt-next"))
        ),
        signers=encode_rleplus([0, 2, 3]),
        signature=b"\xab" * 96,
        power_table_delta=[
            PowerTableDelta(
                participant_id=7,
                power_delta="-50",
                signing_key=base64.b64encode(b"\xcd" * 48).decode(),
            ),
            PowerTableDelta(participant_id=9, power_delta="10", signing_key=""),
        ],
    )


def random_value(rng: random.Random, depth: int = 0):
    """The reference's ``tests/test_native_dagcbor._random_value``."""
    choices = ["int", "bytes", "str", "bool", "none", "cid"]
    if depth < 3:
        choices += ["list", "dict", "list", "dict"]
    kind = rng.choice(choices)
    if kind == "int":
        return rng.choice(
            [0, 1, -1, 23, 24, -24, -25, 255, 65536, 2**32, 2**63 - 1, -(2**63)]
        )
    if kind == "bytes":
        return bytes(rng.randrange(256) for _ in range(rng.randrange(40)))
    if kind == "str":
        return "".join(rng.choice("abcdefémoji🎈xyz ") for _ in range(rng.randrange(20)))
    if kind == "bool":
        return rng.random() < 0.5
    if kind == "none":
        return None
    if kind == "cid":
        return CID.hash_of(bytes(rng.randrange(256) for _ in range(8)), codec=RAW)
    if kind == "list":
        return [random_value(rng, depth + 1) for _ in range(rng.randrange(5))]
    return {
        f"k{i}-{rng.randrange(100)}": random_value(rng, depth + 1)
        for i in range(rng.randrange(5))
    }
