"""The port's witness plane (`witness/`) and the bundle helpers it stands
on, against the JAX package, byte for byte in both directions.

- the differential grid of aggregation K ∈ {1, 16, 256} × delta base
  {match, stale, missing} × encoding {identity, zlib, zstd}: each cell's
  response fields are the reference's canonical JSON, each package
  expands the other's fields to the plain bundle (or fails typed the same
  way), and the claim tables re-anchor in both;
- tampered deltas, corrupt frames and unknown encodings fail typed in both
  packages; zlib and zstd frames are identical;
- the stream codec's chunks are identical, each package decodes the
  other's (from bytes, from a file, over a socketpair), and every
  malformed stream fails typed alike;
- `verify_aggregated` gives the reference's per-claim verdicts from one
  CID batch on the backend (the plain versions here);
- `ProofBlock._make`, `EventData._make`, `EventProof._make`,
  `UnifiedProofBundle.cid_set`, `block_cid_set`,
  `single_pass_witness_cids`, `collect_base_witness`,
  `build_execution_order` and `decode_prefix` equal the reference's.

Inputs are the fixtures' seeded worlds and numpy-seeded bytes.
"""

import io
import json
import socket
import threading

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import ipc_proofs_tpu.witness as ref_witness  # noqa: E402
import ipc_proofs_tpu.witness.stream as ref_stream  # noqa: E402
import ipc_proofs_tpu_torch.witness as port_witness  # noqa: E402
import ipc_proofs_tpu_torch.witness.stream as port_stream  # noqa: E402
from ipc_proofs_tpu.core import dagcbor as ref_dagcbor  # noqa: E402
from ipc_proofs_tpu.fixtures import build_range_world as ref_build_range_world  # noqa: E402
from ipc_proofs_tpu.proofs import bundle as ref_bundle  # noqa: E402
from ipc_proofs_tpu.proofs.event_generator import (  # noqa: E402
    collect_base_witness as ref_collect_base_witness,
)
from ipc_proofs_tpu.proofs.event_generator import (  # noqa: E402
    single_pass_witness_cids as ref_single_pass_witness_cids,
)
from ipc_proofs_tpu.proofs.exec_order import build_execution_order as ref_build_execution_order  # noqa: E402
from ipc_proofs_tpu.proofs.generator import EventProofSpec as RefSpec  # noqa: E402
from ipc_proofs_tpu.proofs.range import (  # noqa: E402
    generate_event_proofs_for_range_chunked as ref_chunked,
)
from ipc_proofs_tpu.proofs.trust import TrustPolicy as RefTrustPolicy  # noqa: E402
from ipc_proofs_tpu.proofs.witness import WitnessCollector as RefWitnessCollector  # noqa: E402
from ipc_proofs_tpu.proofs.witness import block_cid_set as ref_block_cid_set  # noqa: E402
from ipc_proofs_tpu.utils.metrics import Metrics as RefMetrics  # noqa: E402
from ipc_proofs_tpu_torch.backend import get_backend  # noqa: E402
from ipc_proofs_tpu_torch.core import dagcbor  # noqa: E402
from ipc_proofs_tpu_torch.core.cid import CID  # noqa: E402
from ipc_proofs_tpu_torch.fixtures import build_range_world  # noqa: E402
from ipc_proofs_tpu_torch.proofs.bundle import (  # noqa: E402
    EventData,
    EventProof,
    ProofBlock,
    UnifiedProofBundle,
)
from ipc_proofs_tpu_torch.proofs.event_generator import (  # noqa: E402
    collect_base_witness,
    single_pass_witness_cids,
)
from ipc_proofs_tpu_torch.proofs.exec_order import (  # noqa: E402
    build_execution_order,
    reconstruct_execution_order,
)
from ipc_proofs_tpu_torch.proofs.generator import EventProofSpec  # noqa: E402
from ipc_proofs_tpu_torch.proofs.range import generate_event_proofs_for_range_chunked  # noqa: E402
from ipc_proofs_tpu_torch.proofs.trust import TrustPolicy  # noqa: E402
from ipc_proofs_tpu_torch.proofs.verifier import verify_proof_bundle  # noqa: E402
from ipc_proofs_tpu_torch.proofs.witness import WitnessCollector, block_cid_set  # noqa: E402
from ipc_proofs_tpu_torch.storex import SegmentStore  # noqa: E402
from ipc_proofs_tpu_torch.utils.metrics import Metrics  # noqa: E402

SIG = "NewTopDownMessage(bytes32,uint256)"
SUBNET = "calib-subnet-1"
ACTOR = 1001
DISTINCT = [0, 1, 2, 3]
WORLD = dict(
    receipts_per_pair=6, events_per_receipt=3, match_rate=0.5,
    signature=SIG, topic1=SUBNET, actor_id=ACTOR, base_height=51_000,
)


class _Pkg:
    """One package's witness-plane surface, so a check runs on either."""

    def __init__(self, witness, stream, metrics):
        self.w, self.stream, self.Metrics = witness, stream, metrics


PORT = _Pkg(port_witness, port_stream, Metrics)
REF = _Pkg(ref_witness, ref_stream, RefMetrics)


def _canon(obj) -> str:
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


def _to_ref(bundle):
    return ref_bundle.UnifiedProofBundle.from_json_obj(bundle.to_json_obj())


def _err(fn) -> str:
    """The outcome of ``fn`` as comparable text: its result's canonical
    JSON, or the raised exception's class name."""
    try:
        out = fn()
    except Exception as exc:  # noqa: BLE001 — the class IS the outcome
        return f"raise {type(exc).__name__}"
    return _canon(out) if isinstance(out, (dict, list)) else repr(out)


@pytest.fixture(scope="module")
def cpu():
    return get_backend("gpu", device="cpu")


@pytest.fixture(scope="module")
def worlds():
    return build_range_world(4, **WORLD), ref_build_range_world(4, **WORLD)


@pytest.fixture(scope="module")
def bundles(worlds, cpu):
    (store, pairs, _), (ref_store, ref_pairs, _) = worlds
    spec = EventProofSpec(event_signature=SIG, topic_1=SUBNET)
    ref_spec = RefSpec(event_signature=SIG, topic_1=SUBNET)

    def make(idxs):
        port = generate_event_proofs_for_range_chunked(
            store, [pairs[i] for i in idxs], spec, chunk_size=8, match_backend=cpu
        )
        ref = ref_chunked(ref_store, [ref_pairs[i] for i in idxs], ref_spec, chunk_size=8)
        assert port.to_json() == ref.to_json()
        return port, ref

    out = {"cur": make(DISTINCT), "base": make([0, 1]), "stale": make([2, 3])}
    assert len({b[0].digest() for b in out.values()}) == 3
    return out


def _supported(encoding):
    if encoding not in port_witness.supported_encodings():
        pytest.skip(f"{encoding} does not import on this host")
    assert port_witness.supported_encodings() == ref_witness.supported_encodings()


# --------------------------------------------------------------------------
# the differential grid: aggregate × delta × compression
# --------------------------------------------------------------------------


def _grid_fields(pkg, cur, base, pairs, k, base_kind, encoding):
    m = pkg.Metrics()
    claim_idxs = [DISTINCT[i % len(DISTINCT)] for i in range(k)]
    agg = pkg.w.aggregate_range_bundle(cur, pairs, DISTINCT, claim_indexes=claim_idxs, metrics=m)
    bases = pkg.w.WitnessBaseCache(cap=8)
    if base_kind != "missing":
        bases.register(base.digest(), base.cid_set())
    opts = pkg.w.WitnessOptions(encoding=encoding, base_digest=base.digest())
    fields = pkg.w.encode_bundle_fields(cur, opts, bases=bases, metrics=m, claims=agg.claims_json())
    return fields, m.snapshot()["counters"]


def _expand(pkg, fields, held):
    """Expand ``fields`` (either package's) with ``pkg``; the outcome is the
    bundle's canonical JSON or the typed error's class name."""
    fields = json.loads(json.dumps(fields))
    return _err(lambda: pkg.w.expand_response_fields(fields, base=held).to_json_obj())


@pytest.mark.parametrize("k", [1, 16, 256])
@pytest.mark.parametrize("base_kind", ["match", "stale", "missing"])
@pytest.mark.parametrize("encoding", ["identity", "zlib", "zstd"])
def test_grid_cell_equals_the_reference(worlds, bundles, k, base_kind, encoding):
    _supported(encoding)
    (_, pairs, _), (_, ref_pairs, _) = worlds
    cur, ref_cur = bundles["cur"]
    base, ref_base = bundles["base"]
    fields, counters = _grid_fields(PORT, cur, base, pairs, k, base_kind, encoding)
    ref_fields, ref_counters = _grid_fields(REF, ref_cur, ref_base, ref_pairs, k, base_kind, encoding)
    assert _canon(fields) == _canon(ref_fields)
    assert counters == ref_counters
    assert fields["witness_encoding"] == encoding and fields["digest"] == cur.digest()
    assert len(fields["claims"]) == k
    assert ("bundle_delta" in fields) == (base_kind != "missing")

    held_name = {"match": "base", "stale": "stale", "missing": "base"}[base_kind]
    held, ref_held = bundles[held_name]
    want = _canon(cur.to_json_obj())
    outcomes = {
        "port<-port": _expand(PORT, fields, held),
        "port<-ref": _expand(PORT, ref_fields, held),
        "ref<-port": _expand(REF, fields, ref_held),
        "ref<-ref": _expand(REF, ref_fields, ref_held),
    }
    expected = "raise DeltaBaseMismatchError" if base_kind == "stale" else want
    assert outcomes == dict.fromkeys(outcomes, expected)
    if base_kind != "stale":
        expanded = UnifiedProofBundle.from_json_obj(json.loads(want))
        back = port_witness.AggregatedBundle.claims_from_json(fields["claims"], expanded)
        ref_back = ref_witness.AggregatedBundle.claims_from_json(fields["claims"], _to_ref(expanded))
        assert back.claims_json() == ref_back.claims_json() == fields["claims"]


@pytest.mark.parametrize("pkg", [PORT, REF], ids=["port", "ref"])
def test_delta_without_base_is_typed(bundles, pkg):
    cur, ref_cur = bundles["cur"]
    base, ref_base = bundles["base"]
    c, b = (cur, base) if pkg is PORT else (ref_cur, ref_base)
    bases = pkg.w.WitnessBaseCache(cap=8)
    bases.register(b.digest(), b.cid_set())
    fields = pkg.w.encode_bundle_fields(
        c, pkg.w.WitnessOptions(base_digest=b.digest()), bases=bases, metrics=pkg.Metrics()
    )
    for expander in (PORT, REF):
        with pytest.raises(expander.w.DeltaBaseMissingError):
            expander.w.expand_response_fields(json.loads(json.dumps(fields)), base=None)


@pytest.mark.parametrize("tamper", ["data", "drop", "proof", "base_digest"])
def test_tampered_delta_fails_typed_in_both(bundles, tamper):
    # a drop list needs a base the new bundle does not cover: ship the
    # two-pair bundle against the four-pair one
    new, against = ("base", "cur") if tamper == "drop" else ("cur", "base")
    cur, _ = bundles[new]
    base, ref_base = bundles[against]
    dobj = port_witness.encode_delta(cur, base.cid_set(), base.digest(), metrics=Metrics())
    ref_dobj = ref_witness.encode_delta(_to_ref(cur), base.cid_set(), base.digest(), metrics=RefMetrics())
    assert _canon(dobj) == _canon(ref_dobj)
    assert dobj["drop_cids" if tamper == "drop" else "delta_blocks"]
    assert PORT.w.apply_delta(dobj, base).to_json() == cur.to_json()
    dobj = json.loads(json.dumps(dobj))
    if tamper == "data":
        blk = dobj["delta_blocks"][0]
        blk["data"] = ("00" if blk["data"][:2] != "00" else "ff") + blk["data"][2:]
    elif tamper == "drop":
        dobj["drop_cids"] = dobj["drop_cids"][1:]
    elif tamper == "proof":
        dobj["event_proofs"][0]["event_index"] += 1
    else:
        dobj["base_digest"] = "00" * 32
    outcomes = {
        _err(lambda: PORT.w.apply_delta(dobj, base).to_json_obj()),
        _err(lambda: REF.w.apply_delta(dobj, ref_base).to_json_obj()),
    }
    assert outcomes == {"raise DeltaBaseMismatchError"}


def test_delta_composes_with_a_compressed_frame_across_packages(bundles):
    cur, _ = bundles["cur"]
    base, ref_base = bundles["base"]
    bases = port_witness.WitnessBaseCache()
    bases.register(base.digest(), base.cid_set())
    fields = port_witness.encode_bundle_fields(
        cur, port_witness.WitnessOptions(encoding="zlib", base_digest=base.digest()),
        bases=bases, metrics=Metrics(),
    )
    assert "delta_blocks_frame" in fields["bundle_delta"]
    got = ref_witness.apply_delta_obj(fields["bundle_delta"], ref_base, base_digest=base.digest())
    assert got.to_json() == cur.to_json()


# --------------------------------------------------------------------------
# framing
# --------------------------------------------------------------------------


@pytest.mark.parametrize("encoding", ["zlib", "zstd"])
def test_frames_are_identical_and_decode_across_packages(bundles, encoding):
    _supported(encoding)
    cur, ref_cur = bundles["cur"]
    frame = port_witness.compress_blocks(cur.blocks, encoding, metrics=Metrics())
    ref_frame = ref_witness.compress_blocks(ref_cur.blocks, encoding, metrics=RefMetrics())
    assert frame == ref_frame
    assert port_witness.pack_blocks(cur.blocks) == ref_witness.pack_blocks(ref_cur.blocks)
    assert [b.to_json_obj() for b in port_witness.decompress_blocks(ref_frame)] == cur.to_json_obj()["blocks"]
    assert [b.to_json_obj() for b in ref_witness.decompress_blocks(frame)] == cur.to_json_obj()["blocks"]


def _mutate_frame(frame, how):
    import base64

    out = dict(frame)
    raw = bytearray(base64.b64decode(frame["frame"]))
    if how == "flip":
        raw[len(raw) // 2] ^= 0x10
    elif how == "truncate":
        raw = raw[: len(raw) // 2]
    elif how == "digest":
        out["uncompressed_digest"] = "ab" * 32
        return out
    elif how == "encoding":
        out["encoding"] = "brotli"
        return out
    elif how == "missing":
        del out["uncompressed_digest"]
        return out
    elif how == "not_b64":
        out["frame"] = "!!!"
        return out
    out["frame"] = base64.b64encode(bytes(raw)).decode("ascii")
    return out


@pytest.mark.parametrize("how", ["flip", "truncate", "digest", "encoding", "missing", "not_b64"])
def test_corrupt_frames_fail_typed_in_both(bundles, how):
    cur, _ = bundles["cur"]
    bad = _mutate_frame(port_witness.compress_blocks(cur.blocks, "zlib", metrics=Metrics()), how)
    port = _err(lambda: [b.to_json_obj() for b in port_witness.decompress_blocks(bad)])
    ref = _err(lambda: [b.to_json_obj() for b in ref_witness.decompress_blocks(bad)])
    assert port == ref and port.startswith("raise ")
    if how in ("flip", "truncate", "digest"):
        assert port == "raise WitnessIntegrityError"
    if how == "encoding":
        assert port == "raise WitnessEncodingError"


def test_unknown_encoding_is_typed(bundles):
    cur, _ = bundles["cur"]
    for pkg in (PORT, REF):
        with pytest.raises(pkg.w.WitnessEncodingError):
            pkg.w.compress_blocks(cur.blocks, "brotli")


def test_uvarints_equal_the_reference():
    from ipc_proofs_tpu.witness.framing import read_uvarint as ref_read
    from ipc_proofs_tpu.witness.framing import uvarint as ref_uvarint
    from ipc_proofs_tpu_torch.witness.framing import read_uvarint, uvarint

    rng = np.random.default_rng(7)
    values = [0, 1, 127, 128, 255, 300, 16383, 16384, 2**32, 2**63 - 1]
    values += rng.integers(0, 2**62, 64).tolist()
    for v in values:
        assert uvarint(v) == ref_uvarint(v)
        assert read_uvarint(uvarint(v) + b"\x00", 0) == (v, len(uvarint(v)))
    for bad in (b"", b"\x80", b"\xff" * 10 + b"\x01"):
        assert _err(lambda: read_uvarint(bad, 0)) == _err(lambda: ref_read(bad, 0)) == "raise WitnessIntegrityError"


_BODIES = [
    {},
    {"witness_encoding": "zlib"},
    {"witness_encoding": "zstd", "base_digest": "ab" * 32, "base_epoch": 7},
    {"witness_encoding": "brotli"},
    {"witness_encoding": 3},
    {"base_digest": 5},
    {"base_epoch": True},
    {"base_epoch": "7"},
    {"base_digest": "cd" * 32},
]
_HEADERS = [None, {"Accept-Witness-Encoding": "zlib", "If-Witness-Base": "ef" * 32}]


@pytest.mark.parametrize("body", _BODIES, ids=lambda b: _canon(b))
@pytest.mark.parametrize("headers", _HEADERS, ids=["no-headers", "headers"])
@pytest.mark.parametrize("allow", [(True, True), (False, True), (True, False)], ids=str)
def test_negotiation_equals_the_reference(body, headers, allow):
    import dataclasses

    def run(pkg):
        return dataclasses.asdict(
            pkg.w.negotiate_witness(body, headers=headers, allow_compress=allow[0], allow_delta=allow[1])
        )

    assert _err(lambda: run(PORT)) == _err(lambda: run(REF))
    stream_outcome = _err(lambda: port_stream.negotiate_stream(body, headers=headers))
    assert stream_outcome == _err(lambda: ref_stream.negotiate_stream(body, headers=headers))


def test_stream_negotiation_reads_body_then_accept():
    for pkg in (port_stream, ref_stream):
        assert pkg.negotiate_stream({"stream": True})
        assert not pkg.negotiate_stream({"stream": False}, headers={"Accept": pkg.STREAM_CONTENT_TYPE})
        assert pkg.negotiate_stream({}, headers={"Accept": pkg.STREAM_CONTENT_TYPE})
        with pytest.raises(pkg.WitnessEncodingError):
            pkg.negotiate_stream({"stream": "yes"})


def test_base_cache_lru_equals_the_reference():
    rng = np.random.default_rng(3)
    ops = rng.integers(0, 12, size=(200, 2)).tolist()
    caches = (port_witness.WitnessBaseCache(cap=5), ref_witness.WitnessBaseCache(cap=5))
    trace = ([], [])
    for op, key in ops:
        digest = f"d{key}"
        for cache, out in zip(caches, trace):
            if op % 2:
                cache.register(digest, frozenset({bytes([key])}))
            else:
                out.append(cache.lookup(digest))
            out.append(len(cache))
    assert trace[0] == trace[1]


# --------------------------------------------------------------------------
# aggregation and its verify
# --------------------------------------------------------------------------


class _Counting:
    """The CPU backend, counting its CID batches (one per verify call)."""

    def __init__(self, inner):
        self.inner, self.cid_batches, self.blake2b_batches = inner, 0, 0

    def verify_block_cids(self, digests, blocks):
        self.cid_batches += 1
        return self.inner.verify_block_cids(digests, blocks)

    def blake2b256_batch(self, messages):
        self.blake2b_batches += 1
        return self.inner.blake2b256_batch(messages)


def _tamper_event(bundle, index):
    obj = json.loads(bundle.to_json())
    obj["event_proofs"][index]["event_data"]["data"] = "0x" + "ff" * 32
    return UnifiedProofBundle.from_json_obj(obj)


@pytest.mark.parametrize("tampered", [None, 0, 5], ids=["clean", "first", "sixth"])
def test_verify_aggregated_equals_the_reference(worlds, bundles, cpu, tampered):
    (_, pairs, _), (_, ref_pairs, _) = worlds
    cur, _ = bundles["cur"]
    if tampered is not None:
        cur = _tamper_event(cur, tampered)
    claim_idxs = [DISTINCT[i % 4] for i in range(16)]
    agg = port_witness.aggregate_range_bundle(cur, pairs, DISTINCT, claim_indexes=claim_idxs, metrics=Metrics())
    ref_agg = ref_witness.aggregate_range_bundle(
        _to_ref(cur), ref_pairs, DISTINCT, claim_indexes=claim_idxs, metrics=RefMetrics()
    )
    counting = _Counting(cpu)
    got = port_witness.verify_aggregated(
        agg, TrustPolicy.accept_all(), verify_witness_cids=True, cid_backend=counting
    )
    want = ref_witness.verify_aggregated(ref_agg, RefTrustPolicy.accept_all(), verify_witness_cids=True)
    assert [(r.storage_results, r.event_results) for r in got] == [
        (r.storage_results, r.event_results) for r in want
    ]
    assert len(got) == 16 and (tampered is None) == all(r.all_valid() for r in got)
    # one shared replay: one witness CID batch and one TxMeta batch for all 16 claims
    assert counting.cid_batches == 1 and counting.blake2b_batches == 1
    # each claim's verdict is that claim verified alone over the shared witness
    for i in (0, 1, 5):
        alone = verify_proof_bundle(agg.split_claim(i), TrustPolicy.accept_all(), cid_backend=cpu)
        assert (alone.storage_results, alone.event_results) == (got[i].storage_results, got[i].event_results)


def test_verify_aggregated_defaults_to_the_card(monkeypatch, worlds, bundles):
    (_, pairs, _), _ = worlds
    cur, _ = bundles["cur"]
    agg = port_witness.aggregate_range_bundle(cur, pairs, DISTINCT, metrics=Metrics())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_witness.verify_aggregated(agg, TrustPolicy.accept_all(), verify_witness_cids=True)


def test_claim_span_validation_is_typed(worlds, bundles):
    (_, pairs, _), (_, ref_pairs, _) = worlds
    cur, ref_cur = bundles["cur"]
    bad = [{"pair_index": 0, "storage_proofs": [0, 0], "event_proofs": [0, len(cur.event_proofs) + 5]}]
    for pkg, b, p in ((PORT, cur, pairs), (REF, ref_cur, ref_pairs)):
        with pytest.raises(pkg.w.WitnessError):
            pkg.w.AggregatedBundle.claims_from_json(bad, b)
        with pytest.raises(pkg.w.WitnessError):
            pkg.w.aggregate_range_bundle(b, p, [0], claim_indexes=[3], metrics=pkg.Metrics())
    shuffled = UnifiedProofBundle(list(cur.storage_proofs), list(reversed(cur.event_proofs)), cur.blocks)
    assert _err(
        lambda: port_witness.aggregate_range_bundle(shuffled, pairs, DISTINCT, metrics=Metrics()).claims_json()
    ) == _err(
        lambda: ref_witness.aggregate_range_bundle(
            _to_ref(shuffled), ref_pairs, DISTINCT, metrics=RefMetrics()
        ).claims_json()
    ) == "raise WitnessError"


# --------------------------------------------------------------------------
# the stream codec
# --------------------------------------------------------------------------


def _writer(pkg):
    sent = []
    writer = pkg.stream.BundleStreamWriter(lambda bufs: sent.extend(bytes(b) for b in bufs), metrics=pkg.Metrics())
    return writer, sent


def _stream(pkg, bundle, base, encoding, base_kind, slicer=None):
    writer, sent = _writer(pkg)
    bases = pkg.w.WitnessBaseCache()
    if base_kind == "match":
        bases.register(base.digest(), base.cid_set())
    opts = pkg.w.WitnessOptions(
        encoding=encoding, base_digest=base.digest() if base_kind != "plain" else None
    )
    digest = pkg.stream.stream_bundle_doc(
        writer, bundle, opts, bases=bases, metrics=pkg.Metrics(),
        claims=[{"pair_index": 0}], head_extra={"trace_id": "t-1"}, tail_extra={"n": 3},
        slicer=slicer,
    )
    assert digest == bundle.digest()
    return b"".join(sent), writer


@pytest.mark.parametrize("encoding", ["identity", "zlib", "zstd"])
@pytest.mark.parametrize("base_kind", ["plain", "match", "missing"])
def test_stream_chunks_are_identical_and_decode_across_packages(bundles, encoding, base_kind):
    _supported(encoding)
    cur, ref_cur = bundles["cur"]
    base, ref_base = bundles["base"]
    raw, writer = _stream(PORT, cur, base, encoding, base_kind)
    ref_raw, ref_writer = _stream(REF, ref_cur, ref_base, encoding, base_kind)
    assert raw == ref_raw and writer.bytes_sent == ref_writer.bytes_sent == len(raw)
    assert writer.copied_block_bytes == ref_writer.copied_block_bytes
    for decoder in (port_stream, ref_stream):
        fields = decoder.decode_bundle_stream(raw)
        for expander, held in ((PORT, base), (REF, ref_base)):
            got = expander.w.expand_response_fields(json.loads(json.dumps(fields)), base=held)
            assert got.to_json() == cur.to_json()
    # the incremental (relay) iterator sees the same chunks in both
    chunks = list(port_stream.iter_stream_chunks(io.BytesIO(raw)))
    assert chunks == list(ref_stream.iter_stream_chunks(io.BytesIO(raw)))
    if encoding == "identity" and base_kind != "match":
        blocks = [port_stream.parse_block_chunk(p) for k, p in chunks if k == 0x42]
        assert blocks == [ref_stream.parse_block_chunk(p) for k, p in chunks if k == 0x42]
        assert blocks == [(b.cid.to_bytes(), b.data) for b in cur.blocks]


def test_stream_slicer_sends_segment_views(tmp_path, bundles, cpu):
    """Identity blocks served from the disk tier go out as zero-copy
    segment slices, and the stream is the copied stream's bytes."""
    cur, _ = bundles["cur"]
    base, _ = bundles["base"]
    copied, _ = _stream(PORT, cur, base, "identity", "plain")
    metrics = Metrics()
    with SegmentStore(str(tmp_path), backend=cpu, metrics=metrics) as disk:
        for b in cur.blocks[::2]:
            disk.put(b.cid, b.data)
        raw, writer = _stream(PORT, cur, base, "identity", "plain", slicer=disk.read_frame_slice)
        assert raw == copied
        sliced = sum(len(b.data) for b in cur.blocks[::2])
        assert writer.zero_copy_bytes == sliced
        assert writer.copied_block_bytes == cur.witness_bytes() - sliced
        assert metrics.counter_value("storex.slice_hits") == len(cur.blocks[::2])
        del raw, writer
        import gc

        gc.collect()


def test_backfill_documents_are_identical(bundles):
    cur, ref_cur = bundles["cur"]

    def out(b):
        return {
            "job_id": "job-1", "state": "running", "cursor": 9, "acked": 2,
            "chunks": [
                {"digest": "chunk-0", "index": 0, "bundle": b.to_json_obj()},
                {"digest": "chunk-1", "index": 1},
            ],
        }

    sent = []
    for pkg, b in ((PORT, cur), (REF, ref_cur)):
        writer, raw = _writer(pkg)
        pkg.stream.stream_backfill_chunks(writer, out(b))
        sent.append(b"".join(raw))
    assert sent[0] == sent[1]
    docs = port_stream.decode_bundle_stream_docs(sent[0])
    assert docs == ref_stream.decode_bundle_stream_docs(sent[1])
    assert len(docs) == 3 and docs[0]["bundle"] == cur.to_json_obj()
    assert docs[2] == {"job_id": "job-1", "state": "running", "cursor": 9, "acked": 2}


def _mutations(raw):
    """Malformed streams, each paired with the mutation's name."""
    body = raw[4:]
    return {
        "bad_magic": b"IPBX" + body,
        "empty": b"",
        "truncated": raw[: len(raw) - 7],
        "cut_mid_header": raw[:5],
        "no_trailer": raw[: raw.rindex(b"T")] if b"T" in raw else raw[:-1],
        "two_docs_one_expected": raw + body,
        "unknown_kind": raw + b"\x5a\x00",
        "outside_doc": raw + b"\x42\x00",
        "bad_json": raw[:4] + b"H\x02{x",
        "not_object": raw[:4] + b"H\x02[]",
        "digest_lies": raw.replace(b'"digest":"', b'"digest":"0', 1),
        "abort": raw[:4] + b"E" + bytes([len(b'{"error":"boom","error_type":"merge_conflict"}')])
        + b'{"error":"boom","error_type":"merge_conflict"}',
    }


def test_malformed_streams_fail_typed_alike(bundles):
    cur, _ = bundles["cur"]
    base, _ = bundles["base"]
    raw, _ = _stream(PORT, cur, base, "identity", "plain")
    # a conflicting duplicate block: the same CID with other bytes
    first = next(p for k, p in port_stream.iter_stream_chunks(io.BytesIO(raw)) if k == 0x42)
    cid_raw, data = port_stream.parse_block_chunk(first)
    from ipc_proofs_tpu_torch.witness.framing import read_uvarint, uvarint

    forged = uvarint(len(cid_raw)) + cid_raw + uvarint(len(data)) + bytes(len(data))
    header_len, pos = read_uvarint(raw, 5)
    header_end = pos + header_len
    mutations = _mutations(raw)
    mutations["conflicting_block"] = raw[:header_end] + b"B" + uvarint(len(forged)) + forged + raw[header_end:]
    for name, bad in mutations.items():
        port = _err(lambda: port_stream.decode_bundle_stream(bad))
        ref = _err(lambda: ref_stream.decode_bundle_stream(bad))
        assert port == ref, name
        assert port.startswith("raise "), name
    try:
        port_stream.decode_bundle_stream(mutations["abort"])
    except port_stream.StreamAbortError as exc:
        assert exc.remote_error_type == "merge_conflict"
    for name in ("truncated", "cut_mid_header"):
        outcomes = {
            _err(lambda: list(pkg.iter_stream_chunks(io.BytesIO(mutations[name]))))
            for pkg in (port_stream, ref_stream)
        }
        assert outcomes == {"raise WitnessIntegrityError"}, name


def test_error_chunk_round_trips(bundles):
    for pkg in (PORT, REF):
        writer, sent = _writer(pkg)
        writer.begin({"witness_encoding": "identity"})
        writer.error("shard lost", "merge_conflict")
        raw = b"".join(sent)
        for decoder in (port_stream, ref_stream):
            with pytest.raises(decoder.StreamAbortError) as info:
                decoder.decode_bundle_stream(raw)
            assert info.value.remote_error_type == "merge_conflict"


class _NoSendmsg:
    def __init__(self, sock):
        self.sock = sock

    def sendall(self, data):
        self.sock.sendall(data)


def _over_socketpair(send_buffers, buffers, plain):
    a, b = socket.socketpair()
    got = []

    def read():
        while True:
            chunk = b.recv(65536)
            if not chunk:
                return
            got.append(chunk)

    reader = threading.Thread(target=read)
    reader.start()
    try:
        send_buffers(_NoSendmsg(a) if plain else a, buffers)
        a.shutdown(socket.SHUT_WR)
        reader.join(30)
        assert not reader.is_alive()
    finally:
        a.close()
        b.close()
    return b"".join(got)


@pytest.mark.parametrize("plain", [False, True], ids=["sendmsg", "sendall"])
def test_stream_over_a_socketpair_decodes_in_both(bundles, plain):
    cur, _ = bundles["cur"]
    base, _ = bundles["base"]
    raw, _ = _stream(PORT, cur, base, "identity", "plain")
    buffers = [raw[:4], memoryview(raw)[4:1000], raw[1000:]]
    wire = _over_socketpair(port_stream.send_buffers, buffers, plain)
    assert wire == _over_socketpair(ref_stream.send_buffers, buffers, plain)
    size_line, rest = wire.split(b"\r\n", 1)
    assert int(size_line, 16) == len(raw) and rest == raw + b"\r\n"
    for decoder in (port_stream, ref_stream):
        assert decoder.decode_bundle_stream(raw)["bundle"] == cur.to_json_obj()
    assert _over_socketpair(port_stream.send_buffers, [b""], plain) == b""


# --------------------------------------------------------------------------
# the bundle helpers the witness plane calls
# --------------------------------------------------------------------------


def test_fast_constructors_equal_the_dataclasses(bundles):
    cur, ref_cur = bundles["cur"]
    for b, rb in zip(cur.blocks, ref_cur.blocks):
        made = ProofBlock._make(b.cid, b.data)
        assert made == b and made.to_json_obj() == rb.to_json_obj()
        assert ref_bundle.ProofBlock._make(rb.cid, rb.data).to_json_obj() == made.to_json_obj()
    for p in cur.event_proofs:
        fields = dict(p.__dict__)
        data = EventData._make(**dict(p.event_data.__dict__))
        made = EventProof._make(**dict(fields, event_data=data))
        assert made == p and made.to_json_obj() == p.to_json_obj()
        ref_data = ref_bundle.EventData._make(**dict(p.event_data.__dict__))
        assert ref_bundle.EventProof._make(**dict(fields, event_data=ref_data)).to_json_obj() == made.to_json_obj()


def test_cid_sets_equal_the_reference(bundles):
    for name in ("cur", "base", "stale"):
        port, ref = bundles[name]
        assert port.cid_set() == ref.cid_set() == block_cid_set(port.blocks) == ref_block_cid_set(ref.blocks)
        assert all(isinstance(k, bytes) for k in port.cid_set())


@pytest.fixture(scope="module")
def sparse_worlds():
    kw = dict(receipts_per_pair=8, events_per_receipt=4, match_rate=0.25, base_height=9_000)
    return build_range_world(6, **kw), ref_build_range_world(6, **kw)


def _raws(cids):
    return sorted(c.to_bytes() for c in cids)


def test_single_pass_witness_equals_the_reference(sparse_worlds):
    (store, pairs, _), (ref_store, ref_pairs, _) = sparse_worlds
    union, ref_union = set(), set()
    for pair, ref_pair in zip(pairs, ref_pairs):
        got = single_pass_witness_cids(store, pair.parent, pair.child)
        want = ref_single_pass_witness_cids(ref_store, ref_pair.parent, ref_pair.child)
        assert _raws(got) == _raws(want)
        union |= got
        ref_union |= want
        collector, ref_collector = WitnessCollector(store), RefWitnessCollector(ref_store)
        collect_base_witness(collector, store, pair.parent, pair.child)
        ref_collect_base_witness(ref_collector, ref_store, ref_pair.parent, ref_pair.child)
        assert _raws(collector.needed_cids()) == _raws(ref_collector.needed_cids())
        assert set(_raws(collector.needed_cids())) <= set(_raws(got))
    assert len(union) == len(ref_union) > 0


def test_build_execution_order_equals_the_reference(sparse_worlds):
    (store, pairs, _), (ref_store, ref_pairs, _) = sparse_worlds
    for pair, ref_pair in zip(pairs, ref_pairs):
        got = build_execution_order(store, pair.parent)
        assert [str(c) for c in got] == [str(c) for c in ref_build_execution_order(ref_store, ref_pair.parent)]
        assert got == reconstruct_execution_order(store, list(pair.parent.cids))
        assert got


@pytest.mark.parametrize("seed", range(4))
def test_decode_prefix_equals_the_reference(seed):
    rng = np.random.default_rng(seed)
    cid = CID.hash_of(rng.integers(0, 256, 40, dtype=np.uint8).tobytes())
    items = [
        int(rng.integers(0, 2**40)),
        rng.integers(0, 256, int(rng.integers(0, 300)), dtype=np.uint8).tobytes(),
        [1, "two", None, True, cid],
        {"a": [cid, b"\x00"], "bb": {"c": -5}},
    ]
    for item in items:
        encoded = dagcbor.encode(item)
        trailing = rng.integers(0, 256, int(rng.integers(0, 9)), dtype=np.uint8).tobytes()
        value, used = dagcbor.decode_prefix(encoded + trailing)
        ref_value, ref_used = ref_dagcbor.decode_prefix(encoded + trailing)
        assert used == ref_used == len(encoded)
        assert dagcbor.encode(value) == ref_dagcbor.encode(ref_value) == encoded
    with pytest.raises(ValueError):
        dagcbor.decode_prefix(b"\x5f")
    with pytest.raises(ValueError):
        ref_dagcbor.decode_prefix(b"\x5f")
