"""`ipc_proofs_tpu_torch.tools.soak` and its harness `tools._fuzz` against
the reference's soak harness (the fuzz test modules ``tools/soak.py``
imports), on the host.

- For pinned seeds, `_fuzz` draws the reference harness's mutants byte for
  byte: event and storage bundles, CID strings and bytes, corrupted
  exec-order stores, bundle and certificate JSON garbage. The reference's
  own test functions run with their verdict calls recorded, so the
  comparison is against what its harness really drew.
- On each recorded mutant, the port's scalar and batched verdicts (after
  the harness's collapse) equal the reference's.
- ``soak --quick --device cpu`` over rleplus, header and trees is clean;
  `PHASES` has the reference's names, in its order.
"""

import ast
import dataclasses
import random
from pathlib import Path

import pytest

pytest.importorskip("jax")

import tests.test_batch_verifier_fuzz as ref_ev  # noqa: E402
import tests.test_codec_exec_fuzz as ref_cf  # noqa: E402
import tests.test_storage_batch_verifier_fuzz as ref_st  # noqa: E402
from ipc_proofs_tpu.proofs.bundle import UnifiedProofBundle as RefUnified  # noqa: E402
from ipc_proofs_tpu.proofs.cert import FinalityCertificate as RefCert  # noqa: E402
from ipc_proofs_tpu_torch.backend import get_backend  # noqa: E402
from ipc_proofs_tpu_torch.proofs.bundle import EventProofBundle  # noqa: E402
from ipc_proofs_tpu_torch.tools import _fuzz, soak  # noqa: E402

from tests.test_batch_verifier import make_bundle as ref_make_bundle  # noqa: E402
from tests.test_storage_batch_verifier import make_storage_bundle as ref_make_storage_bundle  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CPU = get_backend("gpu", device="cpu")


def _proof_key(p):
    return tuple(sorted(dataclasses.asdict(p).items(), key=lambda kv: kv[0]))


def _canon(proofs, blocks):
    """Comparable form of a (possibly garbled) mutant across packages."""
    return (
        [repr(_proof_key(p)) for p in proofs],
        [(b.cid.to_bytes(), bytes(b.data)) for b in blocks],
    )


def test_base_worlds_equal_the_references():
    for n_pairs, enc in ((1, "compact"), (2, "compact"), (3, "concat")):
        ours, ref = _fuzz.make_bundle(n_pairs, enc, backend=CPU), ref_make_bundle(n_pairs, enc)
        assert _canon(ours.proofs, ours.blocks) == _canon(ref.proofs, ref.blocks)
    for encs, n_slots in ((("direct",), 3), (("direct", "inline", "wrapper_tuple"), 3),
                          (_fuzz.STORAGE_ENCODINGS, 2)):
        ours = _fuzz.make_storage_bundle(encs, n_slots, backend=CPU)
        assert ours.to_json() == ref_make_storage_bundle(encs, n_slots).to_json()


@pytest.mark.parametrize("seed", [0xF3, 2026])
def test_event_mutants_and_verdicts_equal_the_references(seed, monkeypatch):
    seen = []
    outcome = ref_ev._outcome

    def record(bundle, batch):
        out = outcome(bundle, batch)
        if not batch:
            seen.append([bundle])
        seen[-1].append(ref_ev._comparable(out))
        return out

    monkeypatch.setattr(ref_ev, "_outcome", record)
    ref_ev.test_randomized_mutation_differential(seed)
    ours = list(_fuzz.event_mutants(random.Random(seed), _fuzz.make_bundle(2, backend=CPU), 150))
    assert len(ours) == len(seen) == 150
    for mutant, (ref_bundle, ref_scalar, ref_batch) in zip(ours, seen):
        assert _canon(mutant.proofs, mutant.blocks) == _canon(ref_bundle.proofs, ref_bundle.blocks)
        assert _fuzz.comparable(_fuzz.event_outcome(mutant, batch=False)) == ref_scalar
        assert _fuzz.comparable(_fuzz.event_outcome(mutant, batch=True, backend=CPU)) == ref_batch


def test_shape_varied_event_mutants_equal_the_references(monkeypatch):
    seed = 0xD1CE
    seen = []
    outcome = ref_ev._outcome
    monkeypatch.setattr(ref_ev, "_outcome", lambda b, batch: (seen.append(b) if not batch else None,
                                                               outcome(b, batch))[1])
    ref_ev.test_shape_varied_mutation_differential(seed)
    rng, ours = random.Random(seed), []
    for _ in range(4):
        base = _fuzz.make_bundle(rng.choice([1, 2, 3, 4]), rng.choice(["compact", "concat"]), backend=CPU)
        ours += list(_fuzz.event_mutants(rng, base, 30))
    assert [_canon(m.proofs, m.blocks) for m in ours] == [_canon(b.proofs, b.blocks) for b in seen]
    _fuzz.shape_varied_mutation_differential(seed, CPU)


@pytest.mark.parametrize("seed", [7, 102662185])
def test_storage_mutants_and_verdicts_equal_the_references(seed, monkeypatch):
    seen = []
    outcome = ref_st._outcome

    def record(proofs, blocks, batch):
        out = outcome(proofs, blocks, batch)
        if not batch:
            seen.append([proofs, blocks])
        seen[-1].append(ref_st._comparable(out))
        return out

    monkeypatch.setattr(ref_st, "_outcome", record)
    ref_st.test_randomized_storage_mutation_differential(seed)
    base = _fuzz.make_storage_bundle(("direct", "inline", "wrapper_tuple"), backend=CPU)
    ours = list(_fuzz.storage_mutants(random.Random(seed), base.storage_proofs, base.blocks, 120))
    assert len(ours) == len(seen) == 120
    for (proofs, blocks), (ref_proofs, ref_blocks, ref_scalar, ref_batch) in zip(ours, seen):
        assert _canon(proofs, blocks) == _canon(ref_proofs, ref_blocks)
        assert _fuzz.comparable(_fuzz.storage_outcome(proofs, blocks, batch=False)) == ref_scalar
        assert _fuzz.comparable(_fuzz.storage_outcome(proofs, blocks, batch=True)) == ref_batch
    _fuzz.shape_varied_storage_mutation_differential(0x5A5A, CPU)


class _RecordingExt:
    def __init__(self, ext, log):
        self._ext, self._log = ext, log

    def cids_from_strs(self, strs):
        self._log.extend(strs)
        return self._ext.cids_from_strs(strs)

    def make_cids(self, raws):
        self._log.extend(raws)
        return self._ext.make_cids(raws)


@pytest.mark.parametrize("seed", [11, 0xC1D])
def test_cid_mutants_equal_the_references(seed, monkeypatch):
    strs, raws = [], []
    ext_or_skip = ref_cf._ext_or_skip
    monkeypatch.setattr(ref_cf, "_ext_or_skip", lambda attr: _RecordingExt(ext_or_skip(attr), strs))
    ref_cf.test_cid_string_codec_acceptance_parity(seed)
    monkeypatch.setattr(ref_cf, "_ext_or_skip", lambda attr: _RecordingExt(ext_or_skip(attr), raws))
    ref_cf.test_cid_bytes_codec_acceptance_parity(seed)
    assert list(_fuzz.cid_string_mutants(random.Random(seed))) == strs
    assert list(_fuzz.cid_bytes_mutants(random.Random(seed))) == raws
    _fuzz.cid_string_codec_acceptance_parity(seed)
    _fuzz.cid_bytes_codec_acceptance_parity(seed)


@pytest.mark.parametrize("seed", [3, 876857442])
def test_exec_order_corruptions_equal_the_references(seed, monkeypatch):
    seen = []
    batch = ref_cf.reconstruct_execution_orders_batch

    def record(store, groups):
        seen.append(({c.to_bytes(): store.get(c) for c in raw_cids}, batch(store, groups)))
        return seen[-1][1]

    _store, _groups, raw_map = ref_cf._exec_groups_and_store()
    raw_cids = list(raw_map)
    monkeypatch.setattr(ref_cf, "reconstruct_execution_orders_batch", record)
    ref_cf.test_exec_order_batch_scalar_parity_under_corruption(seed)
    _store, groups, ours_map = _fuzz.exec_groups_and_store(CPU)
    assert [c.to_bytes() for c in ours_map] == [c.to_bytes() for c in raw_cids]
    from ipc_proofs_tpu_torch.proofs.exec_order import reconstruct_execution_orders_batch

    stores = list(_fuzz.corrupted_stores(random.Random(seed), ours_map))
    assert len(stores) == len(seen)
    for store, (ref_blocks, ref_orders) in zip(stores, seen):
        assert {c.to_bytes(): store.get(c) for c in ours_map} == ref_blocks
        assert reconstruct_execution_orders_batch(store, groups, hash_backend=CPU) == ref_orders
    _fuzz.exec_order_batch_scalar_parity_under_corruption(seed, CPU)


def _recording_parser(monkeypatch, cls, log):
    parse = cls.from_json_obj.__func__

    def record(klass, obj):
        log.append(repr(obj))
        return parse(klass, obj)

    monkeypatch.setattr(cls, "from_json_obj", classmethod(record))


@pytest.mark.parametrize("seed", [2, 0xB0B])
def test_json_garbage_equals_the_references(seed, monkeypatch):
    bundles, certs = [], []
    _recording_parser(monkeypatch, RefUnified, bundles)
    ref_cf.TestBundleJsonParsing().test_randomized_structural_garbage_never_leaks(seed)
    import tests.test_bls as ref_bls

    _recording_parser(monkeypatch, RefCert, certs)
    ref_bls.TestCertificateJsonParsing().test_randomized_structural_garbage_never_leaks(seed)
    base = __import__("json").loads(_fuzz.make_storage_bundle(backend=CPU).to_json())
    assert [repr(d) for d in _fuzz.bundle_json_mutants(random.Random(seed), base)] == bundles
    assert [repr(d) for d in _fuzz.cert_json_mutants(random.Random(seed))] == certs
    _fuzz.bundle_json_garbage_never_leaks(seed, CPU)
    _fuzz.cert_json_garbage_never_leaks(seed)


def test_fixtures_equal_the_references():
    import tests.test_cert_cbor as ref_cert
    import tests.test_native_dagcbor as ref_dag
    from ipc_proofs_tpu.core.dagcbor import encode as ref_encode
    from ipc_proofs_tpu.proofs.cert_cbor import certificate_to_cbor as ref_to_cbor
    from ipc_proofs_tpu_torch.core.dagcbor import encode
    from ipc_proofs_tpu_torch.proofs.cert_cbor import certificate_to_cbor

    assert certificate_to_cbor(_fuzz.sample_certificate()) == ref_to_cbor(ref_cert._cert())
    r1, r2 = random.Random(5), random.Random(5)
    for _ in range(200):
        assert encode(_fuzz.random_value(r1)) == ref_encode(ref_dag._random_value(r2))
    assert _fuzz.CERT_JSON == ref_bls_valid()


def ref_bls_valid():
    import tests.test_bls as ref_bls

    return ref_bls.TestCertificateJsonParsing.VALID


def _reference_phases() -> "list[str]":
    tree = ast.parse((ROOT / "tools" / "soak.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(getattr(t, "id", "") == "PHASES" for t in node.targets):
            return [k.value for k in node.value.keys]
    raise AssertionError("no PHASES in the reference soak")


def test_phases_are_the_references():
    assert list(soak.PHASES) == _reference_phases()


def test_quick_soak_on_the_host_is_clean(capsys):
    assert soak.main(["7", "rleplus", "header", "trees", "--quick", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "SOAK CLEAN" in out and "HAMT random shapes: 200 trees clean (batch==scalar" in out


def test_soak_refuses_the_host_without_cuda(monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        soak.main(["7", "rleplus", "--quick"])
    assert "--device cuda" in str(exc.value.code)
