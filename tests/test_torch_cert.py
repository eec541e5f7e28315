"""The port's trust and certificate layer held against the JAX package's.

Every module is a copy of the reference's, so each check is exact: RLE+
bytes (a hypothesis sweep over index sets and random blobs, plus the
malformed-input rejections), BLS12-381 serialized points and verdicts for
good, forged and wrong-message aggregates, the gpbft signing payload,
certificate JSON and certexchange CBOR round trips, chain validation
verdicts and final power-table CIDs on good and tampered chains, and
`TrustPolicy` verdicts. Also the repaired verifier signature: the port's
`verify_proof_bundle` takes a `TrustPolicy` as the reference's does, and a
certificate that does not cover a bundle's epochs gives the reference's
verdict lists.

A pure-Python pairing costs about a second, so the BLS checks stay few.
"""

import base64
import inspect
import json
import random

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

jax = pytest.importorskip("jax")

from ipc_proofs_tpu.crypto import bls as ref_bls  # noqa: E402
from ipc_proofs_tpu.crypto import rleplus as ref_rleplus  # noqa: E402
from ipc_proofs_tpu.proofs import cert as ref_cert  # noqa: E402
from ipc_proofs_tpu.proofs import cert_cbor as ref_cert_cbor  # noqa: E402
from ipc_proofs_tpu.proofs import gpbft as ref_gpbft  # noqa: E402
from ipc_proofs_tpu.proofs import trust as ref_trust  # noqa: E402
from ipc_proofs_tpu.proofs.bundle import UnifiedProofBundle as RefBundle  # noqa: E402
from ipc_proofs_tpu.proofs.verifier import verify_proof_bundle as ref_verify  # noqa: E402
from ipc_proofs_tpu_torch.backend import get_backend  # noqa: E402
from ipc_proofs_tpu_torch.core.cid import CID  # noqa: E402
from ipc_proofs_tpu_torch.crypto import bls, rleplus  # noqa: E402
from ipc_proofs_tpu_torch.fixtures import (  # noqa: E402
    build_range_world,
    certificate_json_obj,
    finality_certificates,
    seeded_power_table,
)
from ipc_proofs_tpu_torch.proofs import cert, cert_cbor, gpbft, trust  # noqa: E402
from ipc_proofs_tpu_torch.proofs.generator import EventProofSpec  # noqa: E402
from ipc_proofs_tpu_torch.proofs.range import generate_event_proofs_for_range  # noqa: E402
from ipc_proofs_tpu_torch.proofs.storage_batch import MappingSlotSpec  # noqa: E402
from ipc_proofs_tpu_torch.proofs.verifier import verify_proof_bundle  # noqa: E402

SIG = "NewTopDownMessage(bytes32,uint256)"
SUBNET = "calib-subnet-1"


def _outcome(fn, *args, **kwargs):
    """(\"ok\", value) or (\"error\", exception type name)."""
    try:
        return "ok", fn(*args, **kwargs)
    except (ValueError, KeyError, TypeError, OverflowError) as exc:
        return "error", type(exc).__name__


def _cid(tag: str) -> str:
    return str(CID.hash_of(tag.encode()))


# --- RLE+ ----------------------------------------------------------------------


@settings(max_examples=300, deadline=None)
@given(st.sets(st.integers(min_value=0, max_value=5000), max_size=64))
def test_rleplus_encode_equal_over_index_sets(indices):
    idxs = sorted(indices)
    raw = rleplus.encode_rleplus(idxs)
    assert raw == ref_rleplus.encode_rleplus(idxs)
    assert rleplus.decode_rleplus(raw) == ref_rleplus.decode_rleplus(raw) == idxs


@settings(max_examples=300, deadline=None)
@given(st.binary(max_size=12))
def test_rleplus_decode_equal_over_random_bytes(blob):
    ours = _outcome(rleplus.decode_rleplus, blob, max_bits=1 << 16)
    assert ours == _outcome(ref_rleplus.decode_rleplus, blob, max_bits=1 << 16)
    if ours[0] == "ok":  # every accepted string is canonical
        assert rleplus.encode_rleplus(ours[1]) == blob


@pytest.mark.parametrize(
    "bad",
    [b"", b"\x01", b"\x02", b"\x04", b"\x00\x00", b"\xff\xff\xff\xff\xff\xff\xff\xff"],
    ids=["empty", "version-1", "version-2", "no-runs", "padded-empty", "overlong"],
)
def test_rleplus_malformed_inputs_rejected_alike(bad):
    ours = _outcome(rleplus.decode_rleplus, bad, max_bits=1000)
    assert ours == _outcome(ref_rleplus.decode_rleplus, bad, max_bits=1000)
    assert ours[0] == "error"


@pytest.mark.parametrize("idxs", [[3, 2], [2, 2], [-1]], ids=["unsorted", "duplicate", "negative"])
def test_rleplus_bad_index_sets_rejected_alike(idxs):
    assert _outcome(rleplus.encode_rleplus, idxs) == _outcome(ref_rleplus.encode_rleplus, idxs)
    assert _outcome(rleplus.encode_rleplus, idxs)[0] == "error"


def test_rleplus_width_cap_alike():
    huge = rleplus.encode_rleplus([10**6])
    assert _outcome(rleplus.decode_rleplus, huge, max_bits=1000) == _outcome(
        ref_rleplus.decode_rleplus, huge, max_bits=1000
    ) == ("error", "ValueError")


# --- BLS12-381 -----------------------------------------------------------------

SKS = [0x1234_5678_9ABC, 0x0FED_CBA9_8765, 0x5555_AAAA_3333]
MSG = b"finality payload"


@pytest.mark.parametrize("sk", SKS)
def test_bls_points_serialize_equal(sk):
    pk = bls.sk_to_pk(sk)
    assert bls.g1_compress(pk) == ref_bls.g1_compress(ref_bls.sk_to_pk(sk))
    assert bls.g2_compress(bls.sign(sk, MSG)) == ref_bls.g2_compress(ref_bls.sign(sk, MSG))
    assert bls.g1_compress(bls.g1_decompress(bls.g1_compress(pk))) == bls.g1_compress(pk)


def test_bls_hash_to_g2_and_pop_equal():
    assert bls.g2_compress(bls.hash_to_g2(MSG)) == ref_bls.g2_compress(ref_bls.hash_to_g2(MSG))
    assert bls.g2_compress(bls.pop_prove(SKS[0])) == ref_bls.g2_compress(ref_bls.pop_prove(SKS[0]))


@pytest.mark.parametrize("case", ["good", "forged", "wrong-message"])
def test_bls_aggregate_verdicts_equal(case):
    """The aggregate of three signatures is the signature of the keys'
    sum; a forged aggregate (one signer missing) and a wrong message fail
    in both packages."""
    signers = SKS if case != "forged" else SKS[:2]
    agg = bls.aggregate_signatures([bls.sign(sk, MSG) for sk in signers])
    assert bls.g2_compress(agg) == bls.g2_compress(bls.sign(sum(signers) % bls.CURVE_ORDER, MSG))
    msg = MSG if case != "wrong-message" else b"another payload"
    sig_bytes = bls.g2_compress(agg)
    ours = bls.verify_aggregate_same_message(
        [bls.sk_to_pk(sk) for sk in SKS], msg, bls.g2_decompress(sig_bytes)
    )
    ref = ref_bls.verify_aggregate_same_message(
        [ref_bls.sk_to_pk(sk) for sk in SKS], msg, ref_bls.g2_decompress(sig_bytes)
    )
    assert ours == ref == (case == "good")


@pytest.mark.parametrize(
    "raw", [bytes(48), b"\xc0" + bytes(47), b"\xff" * 48, b"\x80" + b"\x01" * 47],
    ids=["no-flags", "infinity", "all-ones", "off-curve"],
)
def test_bls_g1_decompress_alike(raw):
    ours = _outcome(bls.g1_decompress, raw)
    ref = _outcome(ref_bls.g1_decompress, raw)
    assert ours[0] == ref[0]
    if ours[0] == "ok":
        assert (ours[1] is None) == (ref[1] is None)
    else:
        assert ours == ref


# --- gpbft -----------------------------------------------------------------------


def _ec_chain(module, n: int, commitments: bytes = b""):
    return [
        module.ECTipSet(key=[_cid(f"b{i}"), _cid(f"c{i}")], epoch=100 + i,
                        power_table=_cid("pt"), commitments=commitments)
        for i in range(n)
    ]


@pytest.mark.parametrize(
    "n,commitments,network",
    [(1, b"", None), (3, b"\x11" * 32, None), (2, b"", "calibrationnet")],
    ids=["one", "commitments", "network"],
)
def test_gpbft_signing_payload_bytes_equal(n, commitments, network):
    kwargs = {} if network is None else {"network": network}
    ours = gpbft.payload_marshal_for_signing(
        7, _ec_chain(cert, n, commitments), b"\x22" * 32, _cid("next"), **kwargs
    )
    ref = ref_gpbft.payload_marshal_for_signing(
        7, _ec_chain(ref_cert, n, commitments), b"\x22" * 32, _cid("next"), **kwargs
    )
    assert ours == ref
    assert gpbft.tipset_key_bytes([_cid("a"), _cid("b")]) == ref_gpbft.tipset_key_bytes(
        [_cid("a"), _cid("b")]
    )


@pytest.mark.parametrize("raw", [b"\x01" * 31, b"\x01" * 33, b""], ids=["short", "long", "empty"])
def test_gpbft_commitments_checked_alike(raw):
    assert _outcome(gpbft.commitments32, raw, "c", strict=True) == _outcome(
        ref_gpbft.commitments32, raw, "c", strict=True
    )


# --- certificates ---------------------------------------------------------------


@pytest.fixture(scope="module")
def signers():
    """Two participants from a seed (one PoP each, one hash-to-G2 each)."""
    return seeded_power_table(2, seed=3)


@pytest.fixture(scope="module")
def world():
    store, pairs, _ = build_range_world(6, 4, 2, 0.5, chained=True)
    return store, pairs, [pairs[0].parent] + [p.child for p in pairs]


@pytest.fixture(scope="module")
def chain_objs(world, signers):
    """Three consecutive certificates over the world's 7 tipsets, as JSON."""
    sks, table = signers
    certs = finality_certificates(world[2], sks, table, per_cert=2)
    assert len(certs) == 3
    return [json.loads(json.dumps(certificate_json_obj(c))) for c in certs]


def _table(module, table):
    return [module.PowerTableEntry(e.participant_id, e.power, e.signing_key, e.pop) for e in table]


def test_certificate_json_and_cbor_round_trips_equal(chain_objs):
    for obj in chain_objs:
        ours = cert.FinalityCertificate.from_json_obj(obj)
        ref = ref_cert.FinalityCertificate.from_json_obj(obj)
        raw = cert_cbor.certificate_to_cbor(ours)
        assert raw == ref_cert_cbor.certificate_to_cbor(ref)
        back = cert_cbor.certificate_from_cbor(raw)
        assert cert_cbor.certificate_to_cbor(back) == raw
        assert ref_cert_cbor.certificate_to_cbor(ref_cert_cbor.certificate_from_cbor(raw)) == raw
        assert back.signing_payload() == ref.signing_payload() == ours.signing_payload()
        # CBOR widens empty commitments to 32 zero bytes: compare on the wire
        again = cert.FinalityCertificate.from_json_obj(certificate_json_obj(back))
        assert cert_cbor.certificate_to_cbor(again) == raw


def test_power_table_cid_and_delta_equal(signers):
    _, table = signers
    assert str(cert.power_table_cid(_table(cert, table))) == str(
        ref_cert.power_table_cid(_table(ref_cert, table))
    )
    extra = base64.b64encode(bls.g1_compress(bls.sk_to_pk(99))).decode()
    cases = [
        [("0", "5", "")],
        [("1", f"-{table[1].power}", "")],
        [("7", "20", extra)],
        [("7", "20", "")],  # new participant without a key
        [("1", "0", "")],  # no-op delta
        [("1", "5", ""), ("0", "5", "")],  # unsorted
        [("0", f"-{table[0].power + 1}", "")],  # negative power
    ]
    for case in cases:
        deltas = [(int(p), d, k) for p, d, k in case]
        ours = _outcome(cert.apply_power_table_delta, _table(cert, table),
                        [cert.PowerTableDelta(p, d, k) for p, d, k in deltas])
        ref = _outcome(ref_cert.apply_power_table_delta, _table(ref_cert, table),
                       [ref_cert.PowerTableDelta(p, d, k) for p, d, k in deltas])
        if ours[0] == "ok":
            assert ref[0] == "ok"
            assert [(e.participant_id, e.power, e.signing_key) for e in ours[1]] == [
                (e.participant_id, e.power, e.signing_key) for e in ref[1]
            ]
            assert str(cert.power_table_cid(ours[1])) == str(ref_cert.power_table_cid(ref[1]))
        else:
            assert ours == ref


def _tamper(objs, case: str):
    objs = json.loads(json.dumps(objs))
    if case == "instance-gap":
        objs[1]["GPBFTInstance"] = 5
    elif case == "forked-base":
        objs[1]["ECChain"][0]["Key"] = [{"/": _cid("fork")}]
    elif case == "unordered-epochs":
        objs[2]["ECChain"].reverse()
    elif case == "empty-chain":
        objs[1]["ECChain"] = []
    elif case == "wrong-commitment":
        objs[2]["SupplementalData"]["PowerTable"] = {"/": _cid("other table")}
    elif case == "bad-delta":
        objs[1]["PowerTableDelta"] = [{"ParticipantID": 5, "PowerDelta": "-1", "SigningKey": ""}]
    return objs


def _validate(module, objs, table, **kwargs):
    def run():
        chain = module.FinalityCertificateChain(
            [module.FinalityCertificate.from_json_obj(o) for o in objs]
        )
        final = chain.validate(_table(module, table), **kwargs)
        return str(module.power_table_cid(final))

    return _outcome(run)


@pytest.mark.parametrize(
    "case",
    ["good", "instance-gap", "forked-base", "unordered-epochs", "empty-chain",
     "wrong-commitment", "bad-delta"],
)
def test_chain_validate_verdicts_equal(chain_objs, signers, case):
    """Structural validation with table commitments: verdicts and final
    power-table CIDs equal on the good chain and each tampered one."""
    _, table = signers
    objs = _tamper(chain_objs, case)
    ours = _validate(cert, objs, table, verify_table_cids=True)
    assert ours == _validate(ref_cert, objs, table, verify_table_cids=True)
    assert (ours[0] == "ok") == (case == "good")


@pytest.mark.parametrize("case", ["good", "forged"])
def test_chain_signature_verdicts_equal(chain_objs, signers, case):
    """The first certificate's aggregate signature, verified in both
    packages; the forged copy carries another instance's signature."""
    _, table = signers
    objs = chain_objs[:1]
    if case == "forged":
        objs = [dict(objs[0], Signature=chain_objs[1]["Signature"])]
    ours = _validate(cert, objs, table, verify_signatures=True)
    assert ours == _validate(ref_cert, objs, table, verify_signatures=True)
    assert (ours[0] == "ok") == (case == "good")


# --- TrustPolicy and the verifier's signature -----------------------------------


def test_verify_proof_bundle_takes_a_trust_policy_as_the_reference():
    ours = inspect.signature(verify_proof_bundle).parameters
    ref = inspect.signature(ref_verify).parameters
    assert list(ours) == list(ref) == [
        "bundle", "trust_policy", "event_filter", "verify_witness_cids", "cid_backend"
    ]
    for name in ours:
        assert ours[name].kind == ref[name].kind
        assert ours[name].default == ref[name].default
    assert ours["trust_policy"].annotation in (trust.TrustPolicy, "TrustPolicy")


@pytest.mark.parametrize(
    "policy", ["accept-all", "covering", "first-half", "unbound-first-half", "mock-rejects-child"]
)
def test_trust_policy_verdicts_equal(world, signers, policy):
    """The same bundle under the same policy in both packages: equal
    verdict lists. A certificate that covers only some epochs rejects the
    proofs it does not cover, in both."""
    store, pairs, tipsets = world
    backend = get_backend("gpu", device="cpu")
    bundle = generate_event_proofs_for_range(
        store, pairs, EventProofSpec(SIG, SUBNET, 1001), match_backend=backend,
        storage_specs=[MappingSlotSpec(1001, SUBNET, 0)],
    )
    ref_bundle = RefBundle.from_json(bundle.to_json())
    sks, table = signers

    def make(module):
        if policy == "accept-all":
            return module.TrustPolicy.accept_all()
        if policy == "mock-rejects-child":
            return module.TrustPolicy.with_custom_verifier(module.MockTrustVerifier(True, False))
        cover = tipsets if policy == "covering" else tipsets[:4]
        obj = certificate_json_obj(finality_certificates(cover, sks, table, len(cover))[0])
        certificate = (ref_cert if module is ref_trust else cert).FinalityCertificate.from_json_obj(obj)
        return module.TrustPolicy.with_f3_certificate(
            certificate, bind_tipsets=policy != "unbound-first-half"
        )

    ours = verify_proof_bundle(bundle, make(trust), cid_backend=backend)
    ref = ref_verify(ref_bundle, make(ref_trust))
    assert ours.storage_results == ref.storage_results
    assert ours.event_results == ref.event_results
    assert ours.all_valid() == (policy in ("accept-all", "covering"))
    if policy in ("first-half", "unbound-first-half"):
        assert any(ours.storage_results) and not all(ours.storage_results)


def test_signature_checked_at_construction_alike(chain_objs, signers):
    _, table = signers
    obj = chain_objs[0]
    for module, cert_module in ((trust, cert), (ref_trust, ref_cert)):
        certificate = cert_module.FinalityCertificate.from_json_obj(obj)
        with pytest.raises(ValueError, match="power_table"):
            module.TrustPolicy.with_f3_certificate(certificate, verify_signature=True)
        with pytest.raises(ValueError, match="exactly one"):
            module.TrustPolicy()


def test_seeded_power_table_is_deterministic():
    rng_keys = [random.Random(5).randrange(1, bls.CURVE_ORDER)]
    sks, table = seeded_power_table(1, seed=5)
    assert sks == rng_keys
    assert seeded_power_table(1, seed=5)[1] == table
