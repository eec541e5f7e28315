"""The storage replay's slot re-reads (step 6) as one batched walk.

`verify_storage_proofs_batch` classifies each storage root once and walks
the HAMT-encoded ones in one C call per bit width; the keys the walk does
not find, and roots of an odd bit width, take the scalar cascade.
`SLOT_READS` counts each route, and the ``verify.storage`` span carries the
counts of its call.
"""

import pytest

from ipc_proofs_tpu_torch.backend import get_backend
from ipc_proofs_tpu_torch.obs import trace
from ipc_proofs_tpu_torch.proofs import storage_verifier
from ipc_proofs_tpu_torch.proofs.bundle import UnifiedProofBundle
from ipc_proofs_tpu_torch.proofs.storage_verifier import (
    SLOT_READS,
    verify_storage_proof,
    verify_storage_proofs_batch,
)
from ipc_proofs_tpu_torch.proofs.trust import TrustPolicy
from ipc_proofs_tpu_torch.proofs.verifier import verify_proof_bundle
from ipc_proofs_tpu_torch.proofs.witness import load_witness_store
from ipc_proofs_tpu_torch.utils.metrics import Metrics

from _torch_storage_world import storage_bundle

BACKEND = get_backend("gpu", device="cpu")
_BUNDLES: dict = {}


def accept(*_):
    return True


def _bundle(encodings, n_absent=0):
    key = (encodings, n_absent)
    if key not in _BUNDLES:
        _BUNDLES[key] = storage_bundle(encodings, 64, n_absent, BACKEND)
    return _BUNDLES[key]


@pytest.fixture(autouse=True)
def _tracing_off():
    yield
    trace.disable_tracing()


def _verify(proofs, blocks, monkeypatch=None):
    """(verdicts, growth of `SLOT_READS`, the walks' (bit width, keys) when
    ``monkeypatch`` spies on them); verdicts equal the scalar loop's."""
    calls = []
    if monkeypatch is not None:
        real = storage_verifier.hamt_get_batch

        def spy(store, roots, owners, keys, **kw):
            calls.append((kw.get("bit_width"), len(keys), kw.get("validate_blocks")))
            return real(store, roots, owners, keys, **kw)

        monkeypatch.setattr(storage_verifier, "hamt_get_batch", spy)
    before = dict(SLOT_READS)
    store = load_witness_store(blocks)
    verdicts = verify_storage_proofs_batch(store, proofs, accept)
    grown = {route: SLOT_READS[route] - before[route] for route in SLOT_READS}
    assert verdicts == [verify_storage_proof(p, blocks, accept, store=store) for p in proofs]
    return verdicts, grown, calls


@pytest.mark.parametrize(
    "encodings, widths",
    [
        (("direct",) * 4, [5]),
        (("direct", "wrapper_bw3", "wrapper_map", "wrapper_bw3"), [3, 5]),
    ],
)
def test_step_6_is_one_walk_per_bit_width(monkeypatch, encodings, widths):
    """4 contracts × 64 slots: the availability probe, step 4's walk over
    the actors tree, then one tolerant, validating walk a bit width."""
    proofs, blocks = _bundle(encodings)
    verdicts, grown, calls = _verify(proofs, blocks, monkeypatch)
    assert all(verdicts) and len(verdicts) == 256
    probe, actors, *slots = calls
    assert probe[1] == 0 and actors == (5, 4, True)
    assert [bw for bw, _, _ in slots] == widths
    assert all(validate for _, _, validate in slots)
    assert sum(n for _, n, _ in slots) == 256
    assert grown == {"walk": 256, "map": 0, "scalar": 0}


def test_the_keys_the_walk_does_not_find_take_the_scalar_cascade():
    """Absent slots read as zero through the scalar cascade, exactly one
    scalar read each; the held ones stay on the walk."""
    proofs, blocks = _bundle(("direct",) * 4, n_absent=4)
    verdicts, grown, _ = _verify(proofs, blocks)
    assert all(verdicts) and len(verdicts) == 4 * (64 + 4)
    assert grown == {"walk": 256, "map": 0, "scalar": 16}


def test_smallmap_and_odd_bit_width_roots_take_their_own_routes():
    proofs, blocks = _bundle(("inline", "wrapper_bw9", "direct"))
    verdicts, grown, _ = _verify(proofs, blocks)
    assert all(verdicts)
    assert grown == {"walk": 64, "map": 64, "scalar": 64}


def test_a_one_proof_bundle_is_one_walk_of_one_item(monkeypatch):
    proofs, blocks = _bundle(("direct",) * 4)
    verdicts, grown, calls = _verify(proofs[:1], blocks, monkeypatch)
    assert verdicts == [True]
    assert calls[2:] == [(5, 1, True)]
    assert grown == {"walk": 1, "map": 0, "scalar": 0}


def test_the_verify_storage_span_carries_the_routes():
    proofs, blocks = _bundle(("direct",) * 4, n_absent=4)
    collector = trace.enable_tracing(metrics=Metrics())
    with trace.root_span("unit"):
        result = verify_proof_bundle(
            UnifiedProofBundle(proofs, [], blocks), TrustPolicy.accept_all()
        )
    assert all(result.storage_results)
    (storage,) = [sp for sp in collector.drain() if sp.name == "verify.storage"]
    assert storage.attrs == {"slot_walk": 256, "slot_map": 0, "slot_scalar": 16}
