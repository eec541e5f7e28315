"""The port's native host layer against the JAX package's, on the CPU.

Every comparison is exact (tolerance 0: bytes, verdicts and exception
families), and the JAX package runs with its own native extensions loaded,
its default:

- both C extensions build from the port's own sources into
  ``ipc_proofs_tpu_torch/_build/`` as ``ipc_torch_*`` modules, distinct from
  the reference's; a broken source raises with gcc's output; three
  processes building at once all load one whole library;
- the native CID type, the batched CID string codecs and
  `decode_header_lite` accept and reject what the reference's do;
- the scanner's flat arrays, the fused and unfused match, the batched HAMT
  walker, range bundles (fused and unfused, with and without storage
  specs) and `generate_storage_proofs_for_pairs` over every storage
  encoding equal the reference's byte for byte;
- the ``IPC_PROOFS_NO_NATIVE=1`` universe gives the same bundle digests.
"""

import dataclasses
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import ipc_proofs_tpu.fixtures as ref_fixtures  # noqa: E402
from ipc_proofs_tpu.backend import get_backend as ref_get_backend  # noqa: E402
from ipc_proofs_tpu.backend.native import load_dagcbor_ext as ref_load_dagcbor  # noqa: E402
from ipc_proofs_tpu.backend.native import load_scan_ext as ref_load_scan  # noqa: E402
from ipc_proofs_tpu.core.cid import CID as RefCID  # noqa: E402
from ipc_proofs_tpu.core.cid import cid_strings as ref_cid_strings  # noqa: E402
from ipc_proofs_tpu.core.cid import cids_from_strings as ref_cids_from_strings  # noqa: E402
from ipc_proofs_tpu.core.dagcbor import decode as ref_decode  # noqa: E402
from ipc_proofs_tpu.core.dagcbor import encode as ref_encode  # noqa: E402
from ipc_proofs_tpu.ipld.hamt import hamt_get_batch as ref_hamt_get_batch  # noqa: E402
from ipc_proofs_tpu.proofs.generator import EventProofSpec as RefSpec  # noqa: E402
from ipc_proofs_tpu.proofs.range import TipsetPair as RefPair  # noqa: E402
from ipc_proofs_tpu.proofs.range import (  # noqa: E402
    generate_event_proofs_for_range as ref_generate,
)
from ipc_proofs_tpu.proofs.scan_native import scan_events_flat as ref_scan_flat  # noqa: E402
from ipc_proofs_tpu.proofs.scan_native import scan_match_hits as ref_scan_hits  # noqa: E402
from ipc_proofs_tpu.proofs.scan_native import (  # noqa: E402
    topic_fingerprint as ref_topic_fingerprint,
)
from ipc_proofs_tpu.proofs.storage_batch import MappingSlotSpec as RefSlotSpec  # noqa: E402
from ipc_proofs_tpu.proofs.storage_batch import (  # noqa: E402
    generate_storage_proofs_for_pairs as ref_storage_for_pairs,
)
from ipc_proofs_tpu.state.header import decode_header_lite as ref_decode_header_lite  # noqa: E402
from ipc_proofs_tpu.store.blockstore import CachedBlockstore as RefCached  # noqa: E402
from ipc_proofs_tpu.store.blockstore import put_cbor as ref_put_cbor  # noqa: E402
import ipc_proofs_tpu_torch.fixtures as fixtures  # noqa: E402
from ipc_proofs_tpu_torch.backend import get_backend  # noqa: E402
from ipc_proofs_tpu_torch.backend.native import load_dagcbor_ext, load_scan_ext  # noqa: E402
from ipc_proofs_tpu_torch.core import _cid_native  # noqa: E402
from ipc_proofs_tpu_torch.core.cid import (  # noqa: E402
    CID,
    CID_TYPES,
    PurePythonCID,
    cid_strings,
    cids_from_strings,
)
from ipc_proofs_tpu_torch.core import dagcbor  # noqa: E402
from ipc_proofs_tpu_torch.core.dagcbor import (  # noqa: E402
    decode,
    decode_py,
    encode,
    force_python_decoder,
)
from ipc_proofs_tpu_torch.core.hashes import keccak256  # noqa: E402
from ipc_proofs_tpu_torch.ipld.hamt import HAMT, hamt_get_batch  # noqa: E402
from ipc_proofs_tpu_torch.proofs.bundle import ProofBlock, UnifiedProofBundle  # noqa: E402
from ipc_proofs_tpu_torch.proofs.generator import EventProofSpec  # noqa: E402
from ipc_proofs_tpu_torch.proofs.range import (  # noqa: E402
    TipsetPair,
    _materialize_witness,
    generate_event_proofs_for_range,
)
from ipc_proofs_tpu_torch.proofs.scan_native import (  # noqa: E402
    match_mask_flat_np,
    match_mask_fp_np,
    scan_events_flat,
    scan_match_hits,
    topic_fingerprint,
)
from ipc_proofs_tpu_torch.proofs.storage_batch import (  # noqa: E402
    MappingSlotSpec,
    generate_storage_proofs_batch,
    generate_storage_proofs_for_pairs,
    hash_slot_specs,
)
from ipc_proofs_tpu_torch.state.actors import StateRoot  # noqa: E402
from ipc_proofs_tpu_torch.state.address import Address  # noqa: E402
from ipc_proofs_tpu_torch.state.events import (  # noqa: E402
    ascii_to_bytes32,
    hash_event_signature,
)
from ipc_proofs_tpu_torch.state.header import BlockHeader, decode_header_lite  # noqa: E402
from ipc_proofs_tpu_torch.store.blockstore import (  # noqa: E402
    CachedBlockstore,
    MemoryBlockstore,
    put_cbor,
)
from ipc_proofs_tpu_torch.utils.metrics import Metrics  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
BUILD = ROOT / "ipc_proofs_tpu_torch" / "_build"
SIG, TOPIC1, ACTOR = "NewTopDownMessage(bytes32,uint256)", "calib-subnet-1", 1001
WORLD = dict(n_pairs=12, receipts_per_pair=8, events_per_receipt=4, match_rate=0.25)
STORAGE_SPECS = [(ACTOR, TOPIC1, 0), (ACTOR, TOPIC1, 1), (ACTOR, "calib-subnet-2", 0)]
BACKEND = get_backend("gpu", device="cpu")


# --- the build ---------------------------------------------------------------

LOADERS = {
    "ipc_torch_dagcbor_ext": (load_dagcbor_ext, ref_load_dagcbor),
    "ipc_torch_scan_ext": (load_scan_ext, ref_load_scan),
}


@pytest.mark.parametrize("name", sorted(LOADERS))
def test_library_builds_from_the_port_sources(name):
    ours, ref = (load() for load in LOADERS[name])
    assert ours.__name__ == name
    path = Path(ours.__file__).resolve()
    assert path.parent == BUILD.resolve() and path.name.startswith(name + "-")
    assert ref is not None and ref is not ours
    assert "/ipc_proofs_tpu/" in Path(ref.__file__).resolve().as_posix()


def test_scan_copy_leaves_host_blake2b_to_the_card():
    source = (ROOT / "ipc_proofs_tpu_torch/backend/native/scan_ext.c").read_text()
    assert "PyInit_ipc_torch_scan_ext" in source and "blake2b256_one" not in source
    assert not hasattr(load_scan_ext(), "verify_blake2b_blocks")
    assert hasattr(ref_load_scan(), "verify_blake2b_blocks")


@pytest.mark.parametrize("source", ["dagcbor_ext.c", "scan_ext.c"])
def test_broken_source_raises_with_gcc_output(tmp_path, source):
    broken = tmp_path / source
    shutil.copy(_cid_native.NATIVE_DIR / source, broken)
    with open(broken, "a") as fh:
        fh.write("\nthis is not C at all;\n")
    build = tmp_path / "build"
    with pytest.raises(RuntimeError, match="gcc failed") as err:
        _cid_native.build_cpython_ext(broken, "ipc_torch_broken", build)
    assert "error" in str(err.value) and source in str(err.value)
    assert list(build.iterdir()) == []  # no partial library, no temp file left


_BUILD_ONE = """
import sys
from pathlib import Path
from ipc_proofs_tpu_torch.core._cid_native import NATIVE_DIR, build_cpython_ext

module = build_cpython_ext(NATIVE_DIR / "dagcbor_ext.c", "ipc_torch_dagcbor_ext", Path(sys.argv[1]))
assert module.decode(bytes([0x82, 0x01, 0x61, 0x61])) == [1, "a"]
print(module.__file__)
"""


def test_concurrent_builds_load_one_library(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _BUILD_ONE, str(tmp_path)],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for _ in range(3)
    ]
    outs = [proc.communicate(timeout=120) for proc in procs]
    assert [proc.returncode for proc in procs] == [0, 0, 0], [err for _, err in outs]
    files = {out.strip() for out, _ in outs}
    assert len(files) == 1
    assert [p.name for p in tmp_path.iterdir()] == [Path(files.pop()).name]


def test_a_published_library_is_never_replaced(tmp_path):
    """A build that finishes second is dropped, so a library some process
    has already mapped keeps its inode (a replaced one would map as a
    deleted file)."""
    target = tmp_path / "lib.so"
    first, second = tmp_path / "a.tmp", tmp_path / "b.tmp"
    first.write_bytes(b"first build")
    second.write_bytes(b"second build")
    _cid_native.publish_build(first, target)
    inode = target.stat().st_ino
    _cid_native.publish_build(second, target)
    assert target.stat().st_ino == inode and target.read_bytes() == b"first build"
    assert sorted(p.name for p in tmp_path.iterdir()) == ["lib.so"]


# --- the CID type and the codecs ---------------------------------------------


def test_cid_is_the_port_native_type():
    assert CID.__module__ == "ipc_torch_dagcbor_ext" and CID is load_dagcbor_ext().CID
    assert CID_TYPES == (CID, PurePythonCID) and CID is not RefCID
    native = CID.hash_of(b"block")
    pure = PurePythonCID.hash_of(b"block")
    assert native.to_bytes() == pure.to_bytes() == RefCID.hash_of(b"block").to_bytes()
    assert str(native) == str(pure)
    # encode accepts either implementation; decode makes the port's type
    assert encode([native]) == encode([pure])
    [decoded] = decode(encode([pure]))
    assert type(decoded) is CID and decoded == native
    assert decode_py(encode([pure])) == [native]


@pytest.mark.parametrize("raw", [b"\x82\x01", b"\x01\x00", b"\xd8\x2b\x00", b"\x9f\xff"])
def test_c_and_pure_decoders_reject_alike(raw):
    """The C decoder, the pure one (`force_python_decoder` routes `decode`
    through it) and the reference's C decoder all reject malformed items."""
    with pytest.raises(ValueError):
        decode(raw)
    with force_python_decoder():
        assert dagcbor._native is None
        with pytest.raises(ValueError):
            decode(raw)
    assert dagcbor._native is load_dagcbor_ext()
    with pytest.raises(ValueError):
        ref_decode(raw)


BAD_CID_STRINGS = ["", "b", "B" + "a" * 58, "bafy!", "zQm", "b" + "a" * 3]


def test_cid_string_codecs_equal_reference():
    cids = [CID.hash_of(bytes([i]) * i) for i in range(1, 9)]
    texts = cid_strings(cids)
    ref_texts = ref_cid_strings([RefCID.from_bytes(c.to_bytes()) for c in cids])
    assert texts == ref_texts == [str(c) for c in cids]
    parsed = cids_from_strings(texts)
    assert parsed == cids and all(type(c) is CID for c in parsed)
    assert [c.to_bytes() for c in ref_cids_from_strings(texts)] == [c.to_bytes() for c in parsed]


@pytest.mark.parametrize("text", BAD_CID_STRINGS + ["NON-CANONICAL"])
def test_cid_string_rejections_equal_reference(text):
    if text == "NON-CANONICAL":  # a set trailing bit: aliases a canonical CID
        good = str(CID.hash_of(b"x"))
        text = good[:-1] + chr(ord(good[-1]) + 1)
    parsers = (
        cids_from_strings,
        ref_cids_from_strings,
        lambda texts: [PurePythonCID.from_string(t) for t in texts],
    )
    for parse in parsers:
        with pytest.raises(ValueError):
            parse([text])


@pytest.fixture(scope="module")
def header_raw():
    store, pairs, _ = fixtures.build_range_world(2, 2, 1, 0.5)
    return store.get(pairs[0].child.cids[0])


def _header_variant(raw: bytes, kind: str) -> bytes:
    fields = decode(raw)
    if kind == "valid":
        return raw
    if kind.startswith("truncated"):
        return raw[: {"truncated-1": len(raw) - 1, "truncated-half": len(raw) // 2,
                      "truncated-head": 1}[kind]]
    if kind == "trailing":
        return raw + b"\x00"
    if kind == "arity-15":
        return encode(fields[:15])
    if kind == "arity-17":
        return encode(fields + [0])
    if kind == "parents-not-cids":
        return encode(fields[:5] + [[b"not a cid"]] + fields[6:])
    if kind == "messages-not-cid":
        return encode(fields[:10] + [b"x"] + fields[11:])
    if kind == "not-a-list":
        return encode({"a": 1})
    raise AssertionError(kind)


def _lite_outcome(decoder, raw):
    try:
        h = decoder(raw)
    except ValueError:
        return ("raise", "ValueError")
    return ("ok", [c.to_bytes() for c in h.parents], h.height,
            h.parent_state_root.to_bytes(), h.parent_message_receipts.to_bytes(),
            h.messages.to_bytes())


@pytest.mark.parametrize("kind", [
    "valid", "truncated-1", "truncated-half", "truncated-head", "trailing",
    "arity-15", "arity-17", "parents-not-cids", "messages-not-cid", "not-a-list",
])
def test_decode_header_lite_acceptance_equals_reference(header_raw, kind):
    raw = _header_variant(header_raw, kind)
    ours = _lite_outcome(decode_header_lite, raw)
    assert ours == _lite_outcome(ref_decode_header_lite, raw)
    # the full decode is the acceptance authority
    assert ours == _lite_outcome(BlockHeader.decode, raw)
    assert (ours[0] == "ok") == (kind == "valid")


def _full_lite_outcome(decoder, raw):
    try:
        h = decoder(raw)
    except ValueError:
        return ("raise", "ValueError")
    return ("ok", [c.to_bytes() for c in h.parents], h.height, h.timestamp,
            h.parent_state_root.to_bytes(), h.parent_message_receipts.to_bytes(),
            h.messages.to_bytes(), h.fork_signaling)


@pytest.mark.parametrize("kind", ["valid", "truncated-1", "trailing", "arity-17", "parents-not-cids"])
def test_block_header_decode_lite_equals_reference(header_raw, kind):
    """`BlockHeader.decode_lite`: the reference's acceptance and fields
    (the opaque ones, the miner included, come back as None in both); a
    lite header refuses to re-encode."""
    from ipc_proofs_tpu.state.header import BlockHeader as RefHeader

    raw = _header_variant(header_raw, kind)
    ours = _full_lite_outcome(BlockHeader.decode_lite, raw)
    assert ours == _full_lite_outcome(RefHeader.decode_lite, raw)
    assert ours == _full_lite_outcome(BlockHeader.decode, raw)
    if kind == "valid":
        with pytest.raises(ValueError, match="decode_lite"):
            BlockHeader.decode_lite(raw).encode()
        assert BlockHeader.decode(raw).cid().to_bytes() == RefHeader.decode(raw).cid().to_bytes()


def test_amt_for_each_and_count_equal_reference():
    from ipc_proofs_tpu.ipld.amt import AMT as RefAMT
    from ipc_proofs_tpu.ipld.amt import amt_build as ref_amt_build
    from ipc_proofs_tpu.ipld.amt import amt_count as ref_amt_count
    from ipc_proofs_tpu.store.blockstore import MemoryBlockstore as RefStore
    from ipc_proofs_tpu_torch.ipld.amt import AMT, amt_build, amt_count

    values = {i * 7: f"v{i}".encode() for i in range(300)}
    store, ref_store = MemoryBlockstore(), RefStore()
    root, ref_root = amt_build(store, values), ref_amt_build(ref_store, values)
    assert root.to_bytes() == ref_root.to_bytes()
    ours, ref = [], []
    AMT.load(store, root).for_each(lambda i, v: ours.append((i, v)))
    RefAMT.load(ref_store, ref_root).for_each(lambda i, v: ref.append((i, v)))
    assert ours == ref == sorted(values.items())
    assert amt_count(values) == ref_amt_count(values) == 300


# --- scanner, match, HAMT walker ---------------------------------------------


@pytest.fixture(scope="module")
def worlds():
    store, pairs, n_matching = fixtures.build_range_world(**WORLD)
    ref_store, ref_pairs, _ = ref_fixtures.build_range_world(**WORLD)
    return store, pairs, n_matching, ref_store, ref_pairs


def _roots(pairs):
    return [p.child.blocks[0].parent_message_receipts for p in pairs]


def test_scan_events_flat_equals_reference(worlds):
    store, pairs, _, ref_store, ref_pairs = worlds
    ours = scan_events_flat(store, _roots(pairs), want_payload=True)
    ref = ref_scan_flat(ref_store, _roots(ref_pairs), want_payload=True)
    assert ours.n_events == ref.n_events == WORLD["n_pairs"] * 8 * 4
    for name in ("topics", "fp", "n_topics", "emitters", "valid", "pair_ids", "exec_idx",
                 "event_idx", "topics_off", "data_off", "data_len"):
        assert np.array_equal(getattr(ours, name), getattr(ref, name)), name
    assert ours.topics_pool == ref.topics_pool and ours.data_pool == ref.data_pool
    assert ours.n_receipts == ref.n_receipts


@pytest.mark.parametrize("actor", [ACTOR, None, 7])
def test_fused_and_card_masks_equal_reference(worlds, actor):
    """The fused C scan+match, the fingerprint mask on the backend and the
    exact host predicate pick the same (pair, receipt) rows as the
    reference's fused walk."""
    store, pairs, _, ref_store, ref_pairs = worlds
    t0, t1 = hash_event_signature(SIG), ascii_to_bytes32(TOPIC1)
    n, hp, he = scan_match_hits(store, _roots(pairs), t0, t1, actor)
    rn, rhp, rhe = ref_scan_hits(ref_store, _roots(ref_pairs), t0, t1, actor)
    assert n == rn and np.array_equal(hp, rhp) and np.array_equal(he, rhe)
    flat = scan_events_flat(store, _roots(pairs))
    args = (flat.n_topics, flat.emitters, flat.valid, t0, t1, actor)
    on_backend = BACKEND.event_match_mask_fp(flat.fp, *args)
    assert np.array_equal(on_backend, match_mask_fp_np(flat.fp, *args))
    assert np.array_equal(on_backend, match_mask_flat_np(flat.topics, *args))
    hits = sorted(set(zip(flat.pair_ids[on_backend].tolist(), flat.exec_idx[on_backend].tolist())))
    assert hits == sorted(set(zip(hp.tolist(), he.tolist())))
    assert (len(hits) > 0) == (actor != 7)
    assert topic_fingerprint(t0, t1) == ref_topic_fingerprint(t0, t1)


@pytest.mark.parametrize("skip_missing", [False, True])
def test_hamt_get_batch_equals_reference_and_scalar(worlds, skip_missing):
    store, pairs, _, ref_store, ref_pairs = worlds
    raw = store.get(pairs[0].child.blocks[0].parent_state_root)
    actors = StateRoot.decode(raw).actors
    keys = [Address.new_id(i).to_bytes() for i in (ACTOR, 0, 1, 99, 12345)]
    ours = hamt_get_batch(store, [actors], [0] * len(keys), keys, skip_missing=skip_missing,
                          validate_blocks=True)
    ref = ref_hamt_get_batch(ref_store, [RefCID.from_bytes(actors.to_bytes())], [0] * len(keys),
                             keys, skip_missing=skip_missing, validate_blocks=True)
    scalar = [HAMT.load(store, actors).get(k) for k in keys]
    assert encode(ours) == encode(scalar)
    assert ours[0] is not None and ours[3] is None
    assert encode(ours) == ref_encode(ref)


def test_put_many_trusted_fills_both_maps():
    blocks = [ProofBlock(CID.hash_of(bytes([i])), bytes([i])) for i in range(5)]
    store = MemoryBlockstore()
    before = store._mutations
    store.put_many_trusted(blocks)
    assert store._mutations == before + 1 and len(store) == 5
    assert store._raw_readonly() == {b.cid.to_bytes(): b.data for b in blocks}
    assert all(store.get(b.cid) == b.data for b in blocks)
    with pytest.raises(TypeError):
        store.put_many_trusted([dataclasses.replace(blocks[0], data=3)])


# --- bundles -----------------------------------------------------------------


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("with_storage", [False, True], ids=["events", "events+storage"])
def test_range_bundle_equals_reference(worlds, monkeypatch, fused, with_storage):
    store, pairs, n_matching, ref_store, ref_pairs = worlds
    if not fused:
        monkeypatch.setenv("IPC_SCAN_FUSED_MATCH", "0")
    metrics = Metrics()
    ours = generate_event_proofs_for_range(
        store, pairs, EventProofSpec(SIG, TOPIC1, ACTOR), match_backend=BACKEND, metrics=metrics,
        storage_specs=[MappingSlotSpec(*s) for s in STORAGE_SPECS] if with_storage else None,
    )
    ref = ref_generate(
        ref_store, ref_pairs, RefSpec(SIG, TOPIC1, ACTOR), match_backend=ref_get_backend("cpu"),
        storage_specs=[RefSlotSpec(*s) for s in STORAGE_SPECS] if with_storage else None,
    )
    assert len(ours.event_proofs) == n_matching > 0
    assert len(ours.storage_proofs) == (len(pairs) * len(STORAGE_SPECS) if with_storage else 0)
    assert ours.to_json() == ref.to_json()
    assert metrics.counters["range_events"] == WORLD["n_pairs"] * 8 * 4
    assert {"range_scan", "range_match", "range_record"} <= metrics.stage_s.keys()


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_no_snapshot_knob_equals_reference(worlds, monkeypatch, fused):
    """``IPC_SCAN_NO_SNAPSHOT=1`` (the differential knob: the C walks probe
    the live dict under the GIL, provided snapshots ignored) gives the
    bundle of the snapshot path, in both packages."""
    from ipc_proofs_tpu_torch.proofs.scan_native import _snapshot_of

    store, pairs, _, ref_store, ref_pairs = worlds
    if not fused:
        monkeypatch.setenv("IPC_SCAN_FUSED_MATCH", "0")
    spec = EventProofSpec(SIG, TOPIC1, ACTOR)
    slots = [MappingSlotSpec(*s) for s in STORAGE_SPECS]
    with_snapshot = generate_event_proofs_for_range(
        store, pairs, spec, match_backend=BACKEND, storage_specs=slots
    ).to_json()
    monkeypatch.setenv("IPC_SCAN_NO_SNAPSHOT", "1")
    assert _snapshot_of(store, store._raw_readonly()) is None
    ours = generate_event_proofs_for_range(store, pairs, spec, match_backend=BACKEND, storage_specs=slots)
    ref = ref_generate(
        ref_store, ref_pairs, RefSpec(SIG, TOPIC1, ACTOR), match_backend=ref_get_backend("cpu"),
        storage_specs=[RefSlotSpec(*s) for s in STORAGE_SPECS],
    )
    assert ours.to_json() == ref.to_json() == with_snapshot


def _extra_encodings(orig, put_cbor):
    """Each package's `_storage_root` plus the two SmallMap arms its
    fixtures do not write: ``[params, [SmallMap]]`` and a bare SmallMap."""

    def storage_root(store, contract):
        small_map = {"v": [[k, v] for k, v in sorted(contract.storage.items())]}
        if contract.storage_encoding == "inline_list":
            return put_cbor(store, [b"params", [small_map]])
        if contract.storage_encoding == "bare_smallmap":
            return put_cbor(store, small_map)
        return orig(store, contract)

    return storage_root


ENCODINGS = ["direct", "wrapper_tuple", "wrapper_map", "inline", "inline_list", "bare_smallmap"]


def _storage_world(build_chain, contract_cls, encoding):
    contracts = [
        contract_cls(
            actor_id=1000 + c,
            storage={
                keccak256(ascii_to_bytes32(f"subnet-{c}") + i.to_bytes(32, "big")): bytes([i + 1])
                for i in range(16)
            },
            storage_encoding=ENCODINGS[(ENCODINGS.index(encoding) + c) % len(ENCODINGS)],
        )
        for c in range(3)
    ]
    return build_chain(contracts, [], n_filler_actors=8)


@pytest.mark.parametrize("encoding", ENCODINGS)
def test_storage_for_pairs_equals_reference(monkeypatch, encoding):
    """Three contracts × 16 slots (+1 absent) whose storage roots cycle
    through every encoding arm of `read_storage_slot`, proved at two pairs
    of one world."""
    monkeypatch.setattr(fixtures, "_storage_root", _extra_encodings(fixtures._storage_root, put_cbor))
    monkeypatch.setattr(
        ref_fixtures, "_storage_root", _extra_encodings(ref_fixtures._storage_root, ref_put_cbor)
    )
    world = _storage_world(fixtures.build_chain, fixtures.ContractFixture, encoding)
    ref_world = _storage_world(ref_fixtures.build_chain, ref_fixtures.ContractFixture, encoding)
    specs = [MappingSlotSpec(1000 + c, f"subnet-{c}", i) for c in range(3) for i in range(17)]
    ref_specs = [RefSlotSpec(s.actor_id, s.key, s.slot_index) for s in specs]
    slots = hash_slot_specs(specs, BACKEND)
    pairs = [TipsetPair(world.parent, world.child)] * 2
    ref_pairs = [RefPair(ref_world.parent, ref_world.child)] * 2
    cached = CachedBlockstore(world.store)
    proofs, witness = generate_storage_proofs_for_pairs(cached, pairs, specs, slots)
    ref_proofs, ref_witness = ref_storage_for_pairs(RefCached(ref_world.store), ref_pairs, ref_specs, slots)
    assert [p.to_json_obj() for p in proofs] == [p.to_json_obj() for p in ref_proofs]
    assert witness == ref_witness
    # field-identical to the scalar batch per pair, and the same witness
    scalar = generate_storage_proofs_batch(
        world.store, world.parent, world.child, specs, precomputed_slots=slots
    )
    assert [p.to_json_obj() for p in proofs] == [p.to_json_obj() for p in scalar.storage_proofs] * 2
    blocks = _materialize_witness(cached, witness)
    assert [b.cid for b in blocks] == [b.cid for b in scalar.blocks]
    assert sum(p.value != "0x" + "00" * 32 for p in proofs) == 2 * 3 * 16


# --- the two universes -------------------------------------------------------

_PURE_DIGESTS = """
from ipc_proofs_tpu_torch.backend import get_backend
from ipc_proofs_tpu_torch.backend.native import load_scan_ext
from ipc_proofs_tpu_torch.core.cid import CID, PurePythonCID
from ipc_proofs_tpu_torch.fixtures import build_range_world
from ipc_proofs_tpu_torch.proofs.generator import EventProofSpec
from ipc_proofs_tpu_torch.proofs.range import generate_event_proofs_for_range
from ipc_proofs_tpu_torch.proofs.storage_batch import MappingSlotSpec

assert load_scan_ext() is None and CID is PurePythonCID
store, pairs, _ = build_range_world({n_pairs}, {receipts_per_pair}, {events_per_receipt}, {match_rate})
for specs in (None, [MappingSlotSpec(*s) for s in {storage_specs!r}]):
    bundle = generate_event_proofs_for_range(
        store, pairs, EventProofSpec({sig!r}, {topic1!r}, {actor}),
        match_backend=get_backend("gpu", device="cpu"), storage_specs=specs,
    )
    print("DIGEST", bundle.digest())
"""


def test_pure_python_universe_gives_the_same_digests(worlds):
    store, pairs, _, _, _ = worlds
    native = [
        generate_event_proofs_for_range(
            store, pairs, EventProofSpec(SIG, TOPIC1, ACTOR), match_backend=BACKEND,
            storage_specs=specs,
        ).digest()
        for specs in (None, [MappingSlotSpec(*s) for s in STORAGE_SPECS])
    ]
    code = _PURE_DIGESTS.format(
        **WORLD, storage_specs=STORAGE_SPECS, sig=SIG, topic1=TOPIC1, actor=ACTOR
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT), IPC_PROOFS_NO_NATIVE="1")
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    pure = [line.split()[1] for line in proc.stdout.splitlines() if line.startswith("DIGEST")]
    assert pure == native


def test_bundle_blocks_are_port_types(worlds):
    store, pairs, _, _, _ = worlds
    bundle = generate_event_proofs_for_range(
        store, pairs, EventProofSpec(SIG, TOPIC1, ACTOR), match_backend=BACKEND
    )
    assert isinstance(bundle, UnifiedProofBundle)
    assert all(type(b) is ProofBlock and type(b.cid) is CID for b in bundle.blocks)
    assert [b.cid.to_bytes() for b in bundle.blocks] == sorted(b.cid.to_bytes() for b in bundle.blocks)
