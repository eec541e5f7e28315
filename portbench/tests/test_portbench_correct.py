"""``correct`` comes out false for the control and for each fault the cells
can have, planted in the program underneath a whole run (on the CPU, the
kernels' plain versions, at tiny sizes; the harness's look for a card is
skipped).

Faults: an answer altered where it is produced (an event's data, a storage
value, a witness block's byte, a verdict); half of the batch left out (the
proofs of half the pairs, half the storage grid, half the verdicts). A
step that returns its state unchanged and the exchange between chips have
no counterpart in these cells (no training state; one chip).
"""

import dataclasses

import pytest

from ipc_proofs_tpu_torch.proofs import range as range_mod
from ipc_proofs_tpu_torch.proofs import verifier as verifier_mod
from portbench.bench.registry import Registry
from portbench.run import run_cell

GEN_EVENTS = "topdown_range_4k.gen_verify"
GEN_STORAGE = "evm_slots_65k.gen_verify"
SEED = 2**35 + 11


def _run(root, cell, **kw):
    out = run_cell(Registry(root), cell, SEED, 0.5, False, device="cpu", **kw)
    return out["correct"], {k: v["value"] for k, v in out["checks"].items()}


@pytest.mark.parametrize("cell", [GEN_EVENTS, GEN_STORAGE])
def test_sound_run_is_correct(tiny_root, cell):
    correct, checks = _run(tiny_root, cell)
    assert correct, checks


@pytest.mark.parametrize("cell, reading", [
    (GEN_EVENTS, "unproven"),  # bundles without the child headers
    (GEN_STORAGE, "unproven"),
])
def test_control_is_not_correct(tiny_root, cell, reading):
    correct, checks = _run(tiny_root, cell, control=True)
    assert not correct and checks[reading] > 0, checks


def _alter_event(proofs):
    proof = proofs[0]
    data = dataclasses.replace(proof.event_data, data=proof.event_data.data[:-2] + "ff")
    return [dataclasses.replace(proof, event_data=data)] + proofs[1:]


def _record_fault(kind):
    inner = range_mod._record_chunk

    def record(cached, pairs, matching, *args):
        if kind == "half":
            keep = len(pairs) // 2
            matching = [m if i < keep else [] for i, m in enumerate(matching)]
        proofs, witness, blocks = inner(cached, pairs, matching, *args)
        if kind == "alter" and proofs:
            proofs = _alter_event(proofs)
        return proofs, witness, blocks

    return record


def _storage_fault(kind):
    inner = range_mod._storage_for_pairs

    def storage(*args, **kw):
        proofs, witness, blocks = inner(*args, **kw)
        if kind == "half":
            proofs = proofs[: len(proofs) // 2]
        else:
            proofs = [dataclasses.replace(proofs[0], value="0x" + "11" * 32)] + proofs[1:]
        return proofs, witness, blocks

    return storage


def _witness_fault():
    inner = range_mod._materialize_witness

    def materialize(*args):
        blocks = list(inner(*args))
        block = blocks[len(blocks) // 2]
        data = bytearray(block.data)
        data[-1] ^= 0x01
        blocks[len(blocks) // 2] = type(block)(cid=block.cid, data=bytes(data))
        return blocks

    return materialize


@pytest.mark.parametrize("cell, target, fault, reading", [
    (GEN_EVENTS, "_record_chunk", lambda: _record_fault("alter"), "claims_wrong"),
    (GEN_EVENTS, "_record_chunk", lambda: _record_fault("half"), "claims_wrong"),
    (GEN_EVENTS, "_materialize_witness", _witness_fault, "blocks_wrong"),
    (GEN_STORAGE, "_storage_for_pairs", lambda: _storage_fault("alter"), "claims_wrong"),
    (GEN_STORAGE, "_storage_for_pairs", lambda: _storage_fault("half"), "claims_wrong"),
    (GEN_STORAGE, "_materialize_witness", _witness_fault, "blocks_wrong"),
], ids=["event-altered", "half-the-pairs", "event-witness-byte", "value-altered",
        "half-the-grid", "storage-witness-byte"])
def test_generation_fault_is_caught(tiny_root, monkeypatch, cell, target, fault, reading):
    monkeypatch.setattr(range_mod, target, fault())
    correct, checks = _run(tiny_root, cell)
    assert not correct and checks[reading] > 0, checks


def _verdict_fault(target, kind):
    inner = getattr(verifier_mod, target)

    def verify(*args, **kw):
        results = list(inner(*args, **kw))
        if kind == "flip":
            return [not results[0]] + results[1:]
        return results[: len(results) // 2]

    return verify


@pytest.mark.parametrize("cell, target", [
    (GEN_EVENTS, "verify_event_proof"),
    (GEN_STORAGE, "verify_storage_proofs_batch"),
], ids=["events", "storage"])
@pytest.mark.parametrize("kind", ["flip", "half"], ids=["verdict-flipped", "half-the-verdicts"])
def test_verify_fault_is_caught(tiny_root, monkeypatch, cell, target, kind):
    monkeypatch.setattr(verifier_mod, target, _verdict_fault(target, kind))
    correct, checks = _run(tiny_root, cell)
    assert not correct and checks["verdicts_wrong"] > 0, checks
