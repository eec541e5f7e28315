"""The frozen world writers against the program's own fixture writers:
byte-identical blocks at tiny sizes. The only test that imports both."""

import json
import os

import pytest

from ipc_proofs_tpu_torch.core.hashes import keccak256 as program_keccak256
from ipc_proofs_tpu_torch.fixtures import ContractFixture, build_chain, build_range_world
from ipc_proofs_tpu_torch.state.events import ascii_to_bytes32 as program_ascii32
from portbench.reference.hashes import keccak256_many
from portbench.reference.worlds.range import build as range_world
from portbench.reference.worlds.storage import build as storage_world
from portbench.tests.conftest import ROOT


def _shape(config: str, **change) -> dict:
    data = json.loads((ROOT / "portbench/configs" / f"{config}.json").read_text())
    return {**data["shape"], **data["assumed"], **change}


def _blocks(store) -> dict:
    return {cid.to_bytes(): data for cid, data in store._blocks.items()}


@pytest.mark.parametrize("n_pairs, rate", [(1, 0.05), (6, 0.05), (9, 0.2)])
def test_range_world_is_the_fixture_world(n_pairs, rate):
    world = range_world(_shape("topdown_range_4k", n_pairs=n_pairs, match_rate=rate))
    store, pairs, n_matching = build_range_world(n_pairs, 16, 4, rate)
    assert world.blocks == _blocks(store)
    assert world.pairs == [(p.parent.cids[0].to_bytes(), p.child.cids[0].to_bytes())
                           for p in pairs]
    assert len(world.expected_events) == n_matching


@pytest.mark.parametrize("n_contracts, n_slots", [(1, 1), (3, 7), (5, 40)])
def test_storage_world_is_the_fixture_chain(n_contracts, n_slots):
    world = storage_world(_shape("evm_slots_65k", n_contracts=n_contracts, n_slots=n_slots))
    contracts = [
        ContractFixture(actor_id=1001 + c, storage={
            program_keccak256(program_ascii32(f"subnet-{c}") + i.to_bytes(32, "big")):
                (i % 251).to_bytes(2, "big")
            for i in range(n_slots)})
        for c in range(n_contracts)
    ]
    chain = build_chain(contracts, [], n_filler_actors=50)
    assert world.blocks == _blocks(chain.store)
    assert world.pairs == [(chain.parent.cids[0].to_bytes(), chain.child.cids[0].to_bytes())]


def test_keccak_matches_the_program():
    for length in (0, 1, 32, 64, 135):
        messages = [os.urandom(length) for _ in range(9)]
        assert keccak256_many(messages) == [program_keccak256(m) for m in messages]


@pytest.mark.parametrize("seed", [1, 2**31 + 7, 2**40 + 3])
def test_seed_changes_contents_never_shape(seed):
    base = range_world(_shape("topdown_range_4k", n_pairs=40))
    seeded = range_world(_shape("topdown_range_4k", n_pairs=40), seed)
    assert len(seeded.blocks) == len(base.blocks)
    assert len(seeded.expected_events) == len(base.expected_events) == 7
    assert seeded.blocks != base.blocks
    assert range_world(_shape("topdown_range_4k", n_pairs=40), seed).blocks == seeded.blocks
    s0 = storage_world(_shape("evm_slots_65k", n_contracts=3, n_slots=9))
    s1 = storage_world(_shape("evm_slots_65k", n_contracts=3, n_slots=9), seed)
    assert len(s1.expected_storage) == len(s0.expected_storage) == 27
    assert s1.expected_storage != s0.expected_storage
