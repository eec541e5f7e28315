"""The port's offline CLI held against the JAX package's, byte for byte.

Both packages' ``main`` run the same subcommands with the same flags
(``--backend cpu`` in both) over the same 6-pair `build_range_world`: the
reference through its `FakeLotusClient`, the port through its real
`LotusClient` over the hermetic node (`LocalLotusSession`), each factory
swapped in as the reference's own CLI test does. Outputs compare as exact
bytes (bundle files, vectors, CBOR) or as equal JSON (``verify`` without
``verify_seconds``, ``cert``), and exit codes are equal. A ``range``
checkpoint directory or job journal written by the JAX CLI resumes under
the port's CLI with identical bytes and no block read: the state carried
across packages.
"""

import base64
import json

import pytest

jax = pytest.importorskip("jax")

import ipc_proofs_tpu.store.rpc as ref_rpc  # noqa: E402
import ipc_proofs_tpu_torch.store.rpc as port_rpc  # noqa: E402
from ipc_proofs_tpu import cli as ref_cli  # noqa: E402
from ipc_proofs_tpu.fixtures import build_range_world as ref_build_range_world  # noqa: E402
from ipc_proofs_tpu.state.address import Address as RefAddress  # noqa: E402
from ipc_proofs_tpu.store.testing import FakeLotusClient as RefFakeLotusClient  # noqa: E402
from ipc_proofs_tpu_torch import cli as port_cli  # noqa: E402
from ipc_proofs_tpu_torch.core.cid import CID  # noqa: E402
from ipc_proofs_tpu_torch.ops import match as port_match  # noqa: E402
from ipc_proofs_tpu_torch.fixtures import (  # noqa: E402
    build_range_world,
    certificate_json_obj,
    finality_certificates,
    power_table_json,
    seeded_power_table,
)
from ipc_proofs_tpu_torch.store.faults import LocalLotusSession  # noqa: E402
from ipc_proofs_tpu_torch.store.testing import FakeLotusClient  # noqa: E402

SIG = "NewTopDownMessage(bytes32,uint256)"
SUBNET = "calib-subnet-1"
ETH = "0x" + "52" * 20
F410 = str(RefAddress.from_eth_address(ETH))
BASE = 7000


def _tipset_json(tipset) -> dict:
    return {
        "Cids": [{"/": str(c)} for c in tipset.cids],
        "Blocks": [
            {
                "Parents": [{"/": str(p)} for p in h.parents],
                "Height": h.height,
                "ParentStateRoot": {"/": str(h.parent_state_root)},
                "ParentMessageReceipts": {"/": str(h.parent_message_receipts)},
                "Messages": {"/": str(h.messages)},
                "Timestamp": h.timestamp,
            }
            for h in tipset.blocks
        ],
        "Height": tipset.height,
    }


def _by_height(pairs) -> dict:
    out = {}
    for pair in pairs:
        out[pair.parent.height] = pair.parent
        out[pair.child.height] = pair.child
    return out


class _RecordingSession(LocalLotusSession):
    """The hermetic node, recording each answered method."""

    def __init__(self, store, responses):
        super().__init__(store, responses)
        self.methods: "list[str]" = []

    def _answer(self, req: dict) -> dict:
        self.methods.append(req.get("method"))
        return super()._answer(req)


class Worlds:
    """The 6-pair range world in both packages, and a node for each."""

    def __init__(self):
        self.ref_store, ref_pairs, self.n_matching = ref_build_range_world(
            6, 4, 2, 0.5, base_height=BASE
        )
        self.store, pairs, _ = build_range_world(6, 4, 2, 0.5, base_height=BASE)
        self.ref_by_height = _by_height(ref_pairs)
        self.by_height = _by_height(pairs)
        self.lo, self.hi = min(self.by_height), max(self.by_height)
        self.tipsets = [self.by_height[h] for h in sorted(self.by_height)]

    def ref_client(self):
        return RefFakeLotusClient(
            self.ref_store,
            responses={
                "Filecoin.ChainGetTipSetByHeight": lambda p: _tipset_json(self.ref_by_height[p[0]]),
                "Filecoin.EthAddressToFilecoinAddress": F410,
                "Filecoin.StateLookupID": "f01001",
            },
        )

    def port_session(self):
        fake = FakeLotusClient(self.store)
        return _RecordingSession(
            self.store,
            {
                "Filecoin.ChainGetTipSetByHeight": lambda p: _tipset_json(self.by_height[p[0]]),
                "Filecoin.EthAddressToFilecoinAddress": F410,
                "Filecoin.StateLookupID": "f01001",
                "Filecoin.ChainGetParentReceipts": lambda p: fake.chain_get_parent_receipts(
                    CID.from_string(p[0]["/"])
                ),
            },
        )


@pytest.fixture(scope="module")
def worlds():
    return Worlds()


@pytest.fixture
def nodes(worlds, monkeypatch):
    """Swap both packages' `LotusClient` factories for the hermetic nodes;
    yields (reference client, port session)."""
    ref_client = worlds.ref_client()
    session = worlds.port_session()
    real = port_rpc.LotusClient
    monkeypatch.setattr(ref_rpc, "LotusClient", lambda *a, **k: ref_client)
    monkeypatch.setattr(
        port_rpc, "LotusClient",
        lambda endpoint, **k: real(endpoint, session=session, metrics=k.get("metrics")),
    )
    return ref_client, session


def _both(tmp_path, argv, name: str):
    """Run ``argv`` (with ``-o``) through both CLIs; returns (rc_ref,
    bytes_ref, rc_port, bytes_port)."""
    out = {}
    for label, main in (("ref", ref_cli.main), ("port", port_cli.main)):
        path = tmp_path / f"{label}-{name}"
        rc = main(argv + ["-o", str(path)])
        out[label] = (rc, path.read_bytes() if path.exists() else None)
    return out["ref"][0], out["ref"][1], out["port"][0], out["port"][1]


def _range_argv(worlds, *extra) -> list:
    return [
        "range", "--endpoint", "http://node.invalid/rpc/v1",
        "--from-height", str(worlds.lo), "--to-height", str(worlds.hi - 1),
        "--contract", ETH, "--event-sig", SIG, "--topic1", SUBNET,
        "--storage-slot", SUBNET, "--chunk-size", "2", "--backend", "cpu", *extra,
    ]


@pytest.mark.parametrize(
    "flags",
    [[], ["--pipeline-depth", "0"], ["--no-batch-rpc"], ["--pipeline-depth", "0", "--no-batch-rpc"]],
    ids=["pipelined-plane", "chunked-plane", "pipelined-rpc", "chunked-rpc"],
)
def test_range_bundle_is_byte_equal(worlds, nodes, tmp_path, flags):
    ref_rc, ref_out, rc, out = _both(tmp_path, _range_argv(worlds, *flags), "range.json")
    assert ref_rc == rc == 0
    assert out == ref_out
    bundle = json.loads(out)
    assert len(bundle["event_proofs"]) == worlds.n_matching
    # one storage proof per pair the CLI forms (consecutive heights)
    assert len(bundle["storage_proofs"]) == worlds.hi - worlds.lo


def test_range_profile_writes_a_chrome_trace(worlds, nodes, tmp_path):
    """``--profile DIR`` traces the run with `torch.profiler` into
    ``DIR/trace.json`` (the reference writes a `jax.profiler` trace) and
    leaves the bundle as it is."""
    out = tmp_path / "profiled.json"
    assert port_cli.main(_range_argv(worlds, "--profile", str(tmp_path / "prof"), "-o", str(out))) == 0
    assert ref_cli.main(_range_argv(worlds, "-o", str(tmp_path / "ref.json"))) == 0
    assert out.read_bytes() == (tmp_path / "ref.json").read_bytes()
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert trace["traceEvents"]


@pytest.mark.parametrize("n", [4, 1], ids=["mesh4", "mesh1"])
@pytest.mark.parametrize("flags", [[], ["--pipeline-depth", "0"]], ids=["pipelined", "chunked"])
def test_range_mesh_devices_gives_the_same_bundle(worlds, nodes, tmp_path, caplog, monkeypatch, n, flags):
    """``--mesh-devices N --backend cpu`` shards the event mask over N
    virtual CPU devices and logs the mesh: the bundle is the reference's
    and the port's without the flag, byte for byte. Over the RPC store the
    scan is the Python walk, so every mask it runs is the full-word one,
    sharded over the N devices with the flag and flat without it."""
    import logging

    meshes: list = []
    real = port_match.event_match_mask_flat

    def spy(*args, mesh=None):
        meshes.append(None if mesh is None else mesh.size)
        return real(*args, mesh=mesh)

    monkeypatch.setattr(port_match, "event_match_mask_flat", spy)
    ref_rc, ref_out, rc, out = _both(tmp_path, _range_argv(worlds, *flags), "plain.json")
    assert ref_rc == rc == 0 and out == ref_out
    assert meshes and set(meshes) == {None}
    meshes.clear()
    meshed = tmp_path / "meshed.json"
    with caplog.at_level(logging.INFO):
        assert port_cli.main(_range_argv(worlds, *flags, "--mesh-devices", str(n), "-o", str(meshed))) == 0
    assert meshed.read_bytes() == ref_out
    assert f"mesh-sharded matching: {n} device(s)" in caplog.text
    assert meshes and set(meshes) == {n}


@pytest.mark.parametrize("backend,n", [("none", "2"), ("cpu", "0")])
def test_range_mesh_devices_refusals(worlds, nodes, tmp_path, backend, n):
    argv = _range_argv(worlds, "--mesh-devices", n, "-o", str(tmp_path / "x.json"))
    argv[argv.index("--backend") + 1] = backend
    with pytest.raises(SystemExit, match="mesh"):
        port_cli.main(argv)
    assert not (tmp_path / "x.json").exists()


@pytest.mark.parametrize("state", ["checkpoint-dir", "job-dir"])
def test_jax_written_state_resumes_under_the_port(worlds, nodes, tmp_path, state):
    """The JAX CLI writes the checkpoints (or the job journal); the port's
    CLI resumes every chunk from them: identical bytes, no ChainReadObj."""
    _, session = nodes
    flag = "--checkpoint-dir" if state == "checkpoint-dir" else "--job-dir"
    argv = _range_argv(worlds, flag, str(tmp_path / "state"))
    assert ref_cli.main(argv + ["-o", str(tmp_path / "ref.json")]) == 0
    session.methods.clear()
    assert port_cli.main(argv + ["-o", str(tmp_path / "port.json")]) == 0
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "ref.json").read_bytes()
    assert "Filecoin.ChainReadObj" not in session.methods
    if state == "job-dir":
        assert port_cli.main(argv + ["--resume", "-o", str(tmp_path / "again.json")]) == 0
        assert (tmp_path / "again.json").read_bytes() == (tmp_path / "ref.json").read_bytes()


@pytest.mark.parametrize(
    "argv",
    [
        ["--storage-slot", SUBNET],  # --storage-slot without --contract
        ["--resume"],  # --resume without --job-dir
        ["--resume", "--job-dir", "no-such-job"],  # no manifest to resume
    ],
    ids=["slot-without-contract", "resume-without-job-dir", "resume-without-manifest"],
)
def test_range_refusals_match(worlds, nodes, tmp_path, argv):
    base = [
        "range", "--endpoint", "http://node.invalid/rpc/v1",
        "--from-height", str(worlds.lo), "--to-height", str(worlds.hi - 1),
        "--event-sig", SIG, "--topic1", SUBNET, "--backend", "cpu",
    ]
    argv = [str(tmp_path / a) if a == "no-such-job" else a for a in argv]
    assert ref_cli.main(base + argv) == port_cli.main(base + argv) == 2


@pytest.mark.parametrize(
    "flags",
    [
        ["--contract", ETH, "--slot-subnet", SUBNET, "--event-sig", SIG, "--topic1", SUBNET],
        ["--actor-id", "1001", "--event-sig", SIG, "--topic1", SUBNET, "--no-actor-filter"],
        ["--actor-id", "1001", "--slot-subnet", SUBNET, "--slot-index", "3"],
        ["--contract", ETH, "--event-sig", SIG, "--topic1", SUBNET, "--receipts-api"],
    ],
    ids=["storage+event", "event-unfiltered", "storage-slot-3", "receipts-api"],
)
def test_generate_bundle_is_byte_equal(worlds, nodes, tmp_path, flags):
    argv = ["generate", "--endpoint", "http://node.invalid/rpc/v1", "--height", str(BASE),
            "--backend", "cpu", *flags]
    ref_rc, ref_out, rc, out = _both(tmp_path, argv, "bundle.json")
    assert ref_rc == rc == 0
    assert out == ref_out
    assert json.loads(out)["storage_proofs"] or json.loads(out)["event_proofs"]


def test_vectors_are_byte_equal(worlds, nodes, tmp_path):
    argv = ["vectors", "--endpoint", "http://node.invalid/rpc/v1", "--height", str(BASE)]
    ref_rc, ref_out, rc, out = _both(tmp_path, argv, "vectors.json")
    assert ref_rc == rc == 0
    assert out == ref_out
    assert len(json.loads(out)["vectors"]) == 4  # parent header + TxMeta, child header, receipts root


# --- verify ------------------------------------------------------------------


@pytest.fixture(scope="module")
def signed(worlds):
    """Three signers from a seed, one certificate over the whole range and
    one over other epochs."""
    sks, table = seeded_power_table(3, seed=11)
    (covering,) = finality_certificates(worlds.tipsets, sks, table, per_cert=len(worlds.tipsets))
    elsewhere = finality_certificates(worlds.tipsets[:3], sks, table, per_cert=2)[0]
    return sks, table, covering, elsewhere


@pytest.fixture(scope="module")
def range_bundle(worlds, tmp_path_factory):
    """The range bundle (both packages agree on its bytes, above), written
    by the port's CLI once for the verify tests."""
    path = tmp_path_factory.mktemp("bundle") / "range.json"
    session = worlds.port_session()
    real = port_rpc.LotusClient
    mp = pytest.MonkeyPatch()
    mp.setattr(port_rpc, "LotusClient", lambda endpoint, **k: real(endpoint, session=session))
    try:
        assert port_cli.main(_range_argv(worlds, "-o", str(path))) == 0
    finally:
        mp.undo()
    return path


def _flipped(path, tmp_path):
    obj = json.loads(path.read_text())
    block = obj["blocks"][len(obj["blocks"]) // 2]
    data = bytearray(base64.b64decode(block["data"]))
    data[len(data) // 2] ^= 0x01
    block["data"] = base64.b64encode(bytes(data)).decode()
    out = tmp_path / "flipped.json"
    out.write_text(json.dumps(obj))
    return out


@pytest.mark.parametrize(
    "case",
    ["accept-all", "check-cids", "f3-cert", "f3-cert-other-epochs", "event-filter",
     "flipped-replay"],
)
def test_verify_output_and_exit_code_match(range_bundle, signed, tmp_path, capsys, case):
    _, _, covering, elsewhere = signed
    bundle = str(range_bundle)
    argv = {
        "accept-all": [bundle],
        "check-cids": [bundle, "--check-cids"],
        "f3-cert": [bundle, "--check-cids", "--f3-cert", "COVERING"],
        "f3-cert-other-epochs": [bundle, "--f3-cert", "ELSEWHERE"],
        "event-filter": [bundle, "--event-sig", SIG, "--topic1", "other-subnet"],
        "flipped-replay": [str(_flipped(range_bundle, tmp_path))],
    }[case]
    for label, cert in (("COVERING", covering), ("ELSEWHERE", elsewhere)):
        if label in argv:
            path = tmp_path / f"{label}.json"
            path.write_text(json.dumps(certificate_json_obj(cert)))
            argv[argv.index(label)] = str(path)
    (ref_rc, ref_obj), (rc, obj) = _verify_pair(argv, capsys)
    assert obj == ref_obj
    assert rc == ref_rc
    want_ok = case in ("accept-all", "check-cids", "f3-cert")
    assert (rc == 0) == want_ok and obj["all_valid"] == want_ok


def _verify_pair(argv, capsys):
    capsys.readouterr()
    ref_rc = ref_cli.main(["verify", *argv])
    ref_obj = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    rc = port_cli.main(["verify", *argv, "--backend", "cpu"])
    obj = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    ref_obj.pop("verify_seconds")
    obj.pop("verify_seconds")
    return (ref_rc, ref_obj), (rc, obj)


def test_verify_flipped_block_fails_both_with_check_cids(range_bundle, tmp_path):
    """A flipped witness block under ``--check-cids`` raises ValueError in
    both packages: the witness CID recompute rejects it before replay."""
    flipped = str(_flipped(range_bundle, tmp_path))
    with pytest.raises(ValueError, match="CID"):
        ref_cli.main(["verify", flipped, "--check-cids"])
    with pytest.raises(ValueError, match="CID"):
        port_cli.main(["verify", flipped, "--check-cids", "--backend", "cpu"])


# --- cert ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def cert_chain(worlds, signed, tmp_path_factory):
    """Two consecutive signed certificates as JSON files, the power table,
    and a copy of the second with a forged signature."""
    sks, table, _, _ = signed
    certs = finality_certificates(worlds.tipsets[:5], sks, table, per_cert=2)
    assert len(certs) == 2
    root = tmp_path_factory.mktemp("certs")
    paths = []
    for cert in certs:
        path = root / f"cert{cert.instance}.json"
        path.write_text(json.dumps(certificate_json_obj(cert)))
        paths.append(str(path))
    table_path = root / "table.json"
    table_path.write_text(json.dumps(power_table_json(table)))
    forged = certificate_json_obj(certs[1])
    forged["Signature"] = certificate_json_obj(certs[0])["Signature"]
    forged_path = root / "forged.json"
    forged_path.write_text(json.dumps(forged))
    return paths, str(table_path), str(forged_path)


@pytest.mark.parametrize(
    "case", ["structure-only", "signatures", "forged", "out-of-order", "needs-table"]
)
def test_cert_output_and_exit_code_match(cert_chain, capsys, case):
    paths, table, forged = cert_chain
    argv = {
        "structure-only": paths,
        "signatures": [*paths, "--power-table", table, "--verify-signatures"],
        "forged": [paths[0], forged, "--power-table", table, "--verify-signatures"],
        "out-of-order": [paths[1], paths[0]],
        "needs-table": [*paths, "--verify-signatures"],
    }[case]
    outcomes = []
    for main in (ref_cli.main, port_cli.main):
        capsys.readouterr()
        try:
            rc = main(["cert", *argv])
        except SystemExit as exc:
            rc = ("exit", str(exc.code))
        outcomes.append((rc, capsys.readouterr().out))
    assert outcomes[0] == outcomes[1]
    rc, out = outcomes[1]
    if case == "needs-table":
        assert rc == ("exit", "--verify-signatures requires --power-table")
        return
    obj = json.loads(out)
    assert (rc == 0) == (case in ("structure-only", "signatures")) == (obj["status"] == "ok")
    assert obj["signatures_verified"] == (case == "signatures")


def test_cert_cbor_round_trip_is_byte_equal(cert_chain, tmp_path, capsys):
    """``--emit-cbor`` writes the same certexchange bytes in both packages,
    and each package validates the other's CBOR file."""
    paths, table, _ = cert_chain
    ref_cbor, port_cbor = tmp_path / "ref.cbor", tmp_path / "port.cbor"
    assert ref_cli.main(["cert", paths[0], "--emit-cbor", str(ref_cbor)]) == 0
    assert port_cli.main(["cert", paths[0], "--emit-cbor", str(port_cbor)]) == 0
    assert port_cbor.read_bytes() == ref_cbor.read_bytes()
    capsys.readouterr()
    assert port_cli.main(["cert", str(ref_cbor), "--power-table", table]) == 0
    port_out = capsys.readouterr().out
    assert ref_cli.main(["cert", str(port_cbor), "--power-table", table]) == 0
    assert capsys.readouterr().out == port_out


# --- demo and the parser -----------------------------------------------------------


def test_demo_output_matches(capsys):
    assert ref_cli.main(["demo"]) == 0
    ref_out = capsys.readouterr().out
    assert port_cli.main(["demo", "--backend", "cpu"]) == 0
    assert capsys.readouterr().out == ref_out
    assert "All valid: True" in ref_out


@pytest.mark.parametrize("backend", ["cpu", "none"])
def test_demo_host_backends(capsys, backend):
    assert port_cli.main(["demo", "--backend", backend]) == 0
    assert "All valid: True" in capsys.readouterr().out


def test_event_sig_needs_topic1_in_both():
    argv = ["verify", "bundle.json", "--event-sig", SIG]
    for main in (ref_cli.main, port_cli.main):
        with pytest.raises(SystemExit) as exc:
            main(argv)
        assert exc.value.code == 2


# --- the failover pool and the span exports (slice 8) ----------------------


def _trace_files(tmp_path, label):
    return tmp_path / f"{label}.trace.json", tmp_path / f"{label}.otlp.json"


def _check_trace_files(chrome_path, otlp_path, one_trace: bool = True) -> "list[dict]":
    """Both exports parse and hold the same spans; the port's form one
    trace under the command's root span (the reference's CLI opens no
    root, so its RPC calls outside a stage are traces of their own)."""
    chrome = json.loads(chrome_path.read_text())
    events = [e for e in chrome["traceEvents"] if e["ph"] == "X"]
    otlp = json.loads(otlp_path.read_text())["resourceSpans"][0]["scopeSpans"][0]["spans"]
    assert events and len(events) == len(otlp)
    assert {e["args"]["span_id"] for e in events} == {s["spanId"].lstrip("0") for s in otlp}
    assert len({e["args"]["trace_id"] for e in events}) == 1 or not one_trace
    return events


FAILOVER_FLAGS = ["--endpoints", "http://replica.invalid/rpc/v1", "--hedge-ms", "5", "--breaker-threshold", "3"]


class _RefEndpoint:
    """The reference's fake node as one pool endpoint: the pool passes
    ``timeout_s``, which the fake does not take."""

    def __init__(self, fake, endpoint):
        self._fake, self.endpoint = fake, endpoint

    def request(self, method, params, timeout_s=None):
        return self._fake.request(method, params)

    def chain_read_obj(self, cid):
        return self._fake.chain_read_obj(cid)

    def chain_get_parent_receipts(self, block_cid):
        return self._fake.chain_get_parent_receipts(block_cid)


@pytest.fixture
def pool_nodes(nodes, monkeypatch):
    ref_client, session = nodes
    monkeypatch.setattr(ref_rpc, "LotusClient", lambda endpoint, **k: _RefEndpoint(ref_client, endpoint))
    return nodes


@pytest.mark.parametrize("flags", [[], ["--no-batch-rpc"]], ids=["plane", "rpc"])
def test_range_with_endpoints_and_traces_is_byte_equal(worlds, pool_nodes, tmp_path, monkeypatch, flags):
    """``range --endpoints … --hedge-ms 5 --breaker-threshold 3 --trace-out F
    --trace-otlp G --job-dir J`` over the same node in both packages: the
    bundle is the reference's and the run without the flags, byte for byte;
    the port's F holds the command's root, ``rpc.*``, ``pool.*``, pipeline
    stage and ``journal.append`` spans in one trace, and the pool's waves
    went through the verify lane."""
    from ipc_proofs_tpu_torch.utils.metrics import get_metrics

    monkeypatch.setenv("IPC_VERIFY_MIN_BYTES", "0")
    plain = tmp_path / "plain.json"
    assert port_cli.main(_range_argv(worlds, *flags, "-o", str(plain))) == 0
    outs = {}
    for label, main in (("ref", ref_cli.main), ("port", port_cli.main)):
        chrome, otlp = _trace_files(tmp_path, label)
        get_metrics().reset()
        argv = _range_argv(worlds, *flags, *FAILOVER_FLAGS, "--trace-out", str(chrome), "--trace-otlp", str(otlp),
                           "--job-dir", str(tmp_path / f"{label}-job"), "-o", str(tmp_path / f"{label}.json"))
        assert main(argv) == 0
        outs[label] = (tmp_path / f"{label}.json").read_bytes()
        _check_trace_files(chrome, otlp, one_trace=label == "port")
    assert outs["port"] == outs["ref"] == plain.read_bytes()
    events = _check_trace_files(*_trace_files(tmp_path, "port"))
    names = {e["name"] for e in events}
    assert "cli.range" in names and "journal.append" in names and "fetch_tipsets" in names
    assert any(n.startswith("rpc.") for n in names)
    assert names & {"pool.read", "pool.read_many"}
    assert names & {"range_scan", "range_record", "range_match"}
    if not flags:
        assert get_metrics().counter_value("verify.device_blocks") > 0  # the pool's lane


def test_generate_with_endpoints_and_trace_is_byte_equal(worlds, pool_nodes, tmp_path):
    flags = ["--contract", ETH, "--slot-subnet", SUBNET, "--event-sig", SIG, "--topic1", SUBNET]
    outs = {}
    for label, main in (("ref", ref_cli.main), ("port", port_cli.main)):
        chrome, otlp = _trace_files(tmp_path, label)
        argv = ["generate", "--endpoint", "http://node.invalid/rpc/v1", "--height", str(BASE), "--backend", "cpu",
                *flags, *FAILOVER_FLAGS, "--trace-out", str(chrome), "--trace-otlp", str(otlp),
                "-o", str(tmp_path / f"{label}.json")]
        assert main(argv) == 0
        outs[label] = (tmp_path / f"{label}.json").read_bytes()
    assert outs["port"] == outs["ref"]
    events = _check_trace_files(*_trace_files(tmp_path, "port"))
    names = {e["name"] for e in events}
    assert {"cli.generate", "fetch_tipsets", "generate", "pool.read"} <= names


def test_trace_sample_zero_exports_nothing(worlds, nodes, tmp_path):
    chrome, otlp = _trace_files(tmp_path, "sampled")
    argv = _range_argv(worlds, "--trace-out", str(chrome), "--trace-otlp", str(otlp), "--trace-sample", "0",
                       "-o", str(tmp_path / "out.json"))
    assert port_cli.main(argv) == 0
    assert [e for e in json.loads(chrome.read_text())["traceEvents"] if e["ph"] == "X"] == []


def test_endpoints_path_refuses_the_host_without_cuda(worlds, nodes, tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a for a in _range_argv(worlds, *FAILOVER_FLAGS, "-o", str(tmp_path / "x.json")) if a not in ("--backend", "cpu")]
    with pytest.raises(SystemExit, match="CUDA"):
        port_cli.main(argv)


# --------------------------------------------------------------------------
# serve: both packages' daemons over the same demo world
# --------------------------------------------------------------------------


def _spawn_serve(module, root, extra=()):
    """One ``<module> serve`` daemon over a 6-pair demo world with the durable
    queue, disk tier and registry under ``root``; returns (proc, base URL)."""
    import os
    import subprocess
    import sys
    import time
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    port_file = root / "port"
    if port_file.exists():
        port_file.unlink()  # a restart writes its own
    argv = [sys.executable, "-m", module, "serve", "--demo-world", "6", "--check-cids", "--port", "0",
            "--port-file", str(port_file), "--store-dir", str(root / "seg"), "--queue-dir", str(root / "q"),
            "--registry-dir", str(root / "reg"), "--tenant-weight", "acme=2", "--tenant-rate", "1000",
            "--max-wait-ms", "1", *extra]
    env = dict(os.environ, PYTHONPATH=str(repo), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(argv, cwd=repo, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    deadline = time.monotonic() + 120
    while not port_file.exists() and proc.poll() is None and time.monotonic() < deadline:
        time.sleep(0.05)
    if not port_file.exists():
        proc.kill()
        raise AssertionError(proc.communicate(timeout=30))
    return proc, f"http://127.0.0.1:{port_file.read_text()}"


def _http(base, path, body=None):
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(base + path, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            raw, status, ctype = resp.read(), resp.status, resp.headers.get("Content-Type", "")
    except urllib.error.HTTPError as exc:
        raw, status, ctype = exc.read(), exc.code, exc.headers.get("Content-Type", "")
    return status, (json.loads(raw) if "json" in ctype else raw.decode())


def _stop(proc):
    import signal

    proc.send_signal(signal.SIGTERM)
    out, err = proc.communicate(timeout=120)
    return proc.returncode, err


_VOLATILE = ("trace_id", "server_timing", "journal_ms")


def _strip(obj):
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items() if k not in _VOLATILE}
    if isinstance(obj, list):
        return [_strip(v) for v in obj]
    return obj


def test_serve_daemons_answer_alike_and_drain_on_sigterm(tmp_path):
    """``serve`` of both packages (the port with ``--backend cpu``) over the
    same demo world: equal answers to generate, verify and aggregated
    range requests, equal health; an inclusion proof from
    ``/v1/registry/proof`` checks against ``/v1/registry/head``; SIGTERM
    drains and exits 0, and a restart over the same queue directory serves
    every accepted request from its journal."""
    from ipc_proofs_tpu_torch.registry.mmr import verify_inclusion

    daemons = {}
    try:
        daemons["port"] = _spawn_serve("ipc_proofs_tpu_torch.cli", tmp_path / "p", ["--backend", "cpu"])
        daemons["ref"] = _spawn_serve("ipc_proofs_tpu.cli", tmp_path / "r")
        answers = {}
        for name, (_, base) in daemons.items():
            got = []
            for i in range(3):
                got.append(_http(base, "/v1/generate", {"pair_index": i, "idempotency_key": f"g{i}", "tenant": "acme"}))
            bundle = got[0][1]["result"]["bundle"]
            got.append(_http(base, "/v1/verify", {"bundle": bundle, "idempotency_key": "v"}))
            got.append(_http(base, "/v1/generate_range", {"pair_indexes": [4, 4, 5], "aggregate": True}))
            got.append(_http(base, "/v1/generate", {"pair_index": 0, "idempotency_key": "g0"}))
            got.append(_http(base, "/v1/generate", {"pair_index": 9}))
            answers[name] = got
            status, health = _http(base, "/healthz")
            assert status == 200 and health["status"] == "ok" and health["durable_queue"] is True
            status, snap = _http(base, "/metrics")
            assert status == 200 and snap["counters"]["tenant.requests.acme"] == 3
            status, prom = _http(base, "/metrics.prom")
            assert status == 200 and "ipc_serve" in prom
            status, head = _http(base, "/v1/registry/head")
            status, proof = _http(base, "/v1/registry/proof?seq=1")
            assert status == 200 and proof["size"] == head["size"] and proof["root"] == head["root"]
            assert verify_inclusion(
                bytes.fromhex(proof["leaf"]), 1, proof["size"], [bytes.fromhex(h) for h in proof["path"]],
                bytes.fromhex(head["root"]),
            )
        assert [s for s, _ in answers["port"]] == [s for s, _ in answers["ref"]] == [200] * 6 + [400]
        p = [_strip(dict(b, idempotency_key=None) if "auto-" in str(b.get("idempotency_key")) else b) for _, b in answers["port"]]
        r = [_strip(dict(b, idempotency_key=None) if "auto-" in str(b.get("idempotency_key")) else b) for _, b in answers["ref"]]
        assert p == r
        assert answers["port"][5][1]["cached"] is True
        assert answers["port"][3][1]["result"]["all_valid"] is True
    finally:
        codes = {name: _stop(proc) for name, (proc, _) in daemons.items()}
    for name, (rc, err) in codes.items():
        assert rc == 0, (name, err[-2000:])
    # the port's daemon logs every kernel wrapper's launches at start and at
    # drain; with --backend cpu the plain versions ran and nothing launched
    launch_lines = [line.split("kernel launches: ", 1)[1] for line in codes["port"][1].splitlines()
                    if "kernel launches: " in line]
    assert len(launch_lines) == 2, codes["port"][1][-2000:]
    for line in launch_lines:
        counts = json.loads(line)
        assert "blake2b256_single_block" in counts and "event_match_mask" in counts
        assert set(counts.values()) == {0}, counts
    # and beside each, the rows those launches took, by kernel
    row_lines = [json.loads(line.split("kernel rows: ", 1)[1]) for line in codes["port"][1].splitlines()
                 if "kernel rows: " in line]
    assert len(row_lines) == 2, codes["port"][1][-2000:]
    for rows in row_lines:
        assert {"blake2b256_blocks", "keccak256_single_block", "event_match_mask"} <= set(rows)
        assert set(rows.values()) == {0}, rows
    proc, base = _spawn_serve("ipc_proofs_tpu_torch.cli", tmp_path / "p", ["--backend", "cpu"])
    try:
        for i in range(3):
            status, out = _http(base, "/v1/generate", {"pair_index": i, "idempotency_key": f"g{i}"})
            assert status == 200 and out["cached"] is True
            assert out["result"]["bundle"] == answers["port"][i][1]["result"]["bundle"]
        assert _http(base, "/healthz")[1]["resumed_jobs"] == 0
    finally:
        rc, err = _stop(proc)
    assert rc == 0, err[-2000:]


@pytest.mark.parametrize(
    "specs",
    [None, [], ["acme=2"], ["acme=2", "beta=5", "acme=3"], ["acme"], ["=2"], ["acme=0"], ["acme=x"]],
    ids=["none", "empty", "one", "repeat", "no-weight", "no-name", "zero", "not-a-number"],
)
def test_tenant_weight_parsing_matches(specs):
    def run(parse):
        try:
            return parse(specs)
        except SystemExit as exc:
            return ("exit", str(exc))

    assert run(port_cli._parse_tenant_weights) == run(ref_cli._parse_tenant_weights)


def _backfill_argv(worlds, *extra) -> list:
    return [
        "backfill", "--endpoint", "http://node.invalid/rpc/v1",
        "--from-height", str(worlds.lo), "--to-height", str(worlds.hi - 1),
        "--event-sig", SIG, "--topic1", SUBNET, "--window-size", "3", "--backend", "cpu", *extra,
    ]


@pytest.mark.parametrize(
    "flags",
    [[], ["--no-batch-rpc"], ["--store-dir", "STORE"], ["--mesh-devices", "2"], ["--window-parallelism", "2"]],
    ids=["plane", "rpc", "plane-tier", "mesh2", "parallel"],
)
def test_backfill_bundle_is_byte_equal_and_equals_range(worlds, nodes, tmp_path, flags):
    """``backfill --endpoint`` through the hermetic node (the fetch plane
    verifying on the ``--backend`` lane, the disk tier, a mesh): the sealed
    bundle is the reference CLI's and ``range``'s over the same heights."""
    flags = [str(tmp_path / "store") if f == "STORE" else f for f in flags]
    if "--mesh-devices" in flags:
        ref_rc, ref_out, rc, out = _both(tmp_path, _backfill_argv(worlds), "plain.json")
        meshed = tmp_path / "meshed.json"
        assert port_cli.main(_backfill_argv(worlds, *flags, "-o", str(meshed))) == 0
        out = meshed.read_bytes()
    else:
        ref_rc, ref_out, rc, out = _both(tmp_path, _backfill_argv(worlds, *flags), "bf.json")
    assert ref_rc == rc == 0 and out == ref_out
    rng_out = tmp_path / "range.json"
    argv = ["range", "--endpoint", "http://node.invalid/rpc/v1", "--from-height", str(worlds.lo),
            "--to-height", str(worlds.hi - 1), "--event-sig", SIG, "--topic1", SUBNET, "--backend", "cpu",
            "-o", str(rng_out)]
    assert port_cli.main(argv) == 0
    assert rng_out.read_bytes() == out


def test_jax_written_backfill_journal_resumes_under_the_port(worlds, nodes, tmp_path, caplog):
    """The JAX CLI journals the job; the port's CLI replays every window
    from it: identical bytes, no block read."""
    import logging

    _, session = nodes
    argv = _backfill_argv(worlds, "--jobs-dir", str(tmp_path / "jobs"))
    assert ref_cli.main(argv + ["-o", str(tmp_path / "ref.json")]) == 0
    session.methods.clear()
    with caplog.at_level(logging.INFO):
        assert port_cli.main(argv + ["-o", str(tmp_path / "port.json")]) == 0
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "ref.json").read_bytes()
    assert "Filecoin.ChainReadObj" not in session.methods
    assert "windows replayed from journal" in caplog.text


@pytest.mark.parametrize("argv", [
    ["backfill", "--backend", "cpu"],
    ["backfill", "--backend", "cpu", "--endpoint", "http://node.invalid/rpc/v1"],
    ["backfill", "--backend", "cpu", "--endpoint", "http://node.invalid/rpc/v1", "--from-height", "1",
     "--to-height", "2"],
    ["backfill", "--backend", "cpu", "--demo-world", "4", "--pair-start", "3", "--pair-end", "9"],
], ids=["no-store", "no-heights", "no-filter", "range-out-of-bounds"])
def test_backfill_refusals_match(argv, tmp_path):
    assert port_cli.main(argv + ["-o", str(tmp_path / "p.json")]) == ref_cli.main(argv + ["-o", str(tmp_path / "r.json")]) == 2
    assert not (tmp_path / "p.json").exists()


def test_backfill_demo_world_is_byte_equal(tmp_path):
    ref_rc, ref_out, rc, out = _both(tmp_path, ["backfill", "--demo-world", "12", "--window-size", "5",
                                                "--backend", "cpu"], "demo.json")
    assert ref_rc == rc == 0 and out == ref_out and json.loads(out)["event_proofs"]


# --------------------------------------------------------------------------
# cluster: the port's router over two serve children
# --------------------------------------------------------------------------

_CLUSTER_CHILD = """
import runpy, sys
sys.argv = ["ipc_proofs_tpu_torch.cli"] + sys.argv[1:]
try:
    runpy.run_module("ipc_proofs_tpu_torch.cli", run_name="__main__")
finally:
    bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "ipc_proofs_tpu"))
    print("LOADED", bad, flush=True)
"""


def test_cluster_serves_the_single_daemons_bytes_and_drains_on_sigterm(tmp_path):
    """``cluster --shards 2 --backend cpu --demo-world 8``: the router
    answers a scatter with the reference's single-daemon bytes, a generate
    and its verify, a healthy ``/healthz`` with both shards, the cluster
    status and the fleet exposition; SIGTERM drains the router and both
    shards (exit 0, a done record for every admit in each shard's queue);
    each shard's log, named at start, holds its two ``kernel launches:``
    lines (all zero on the plain versions); the router's trace (the shards
    trace too, and ship their spans back) holds the scatter grafted from
    both shards; the router process loads neither ``jax`` nor the
    reference."""
    import os
    import re
    import signal
    import subprocess
    import sys
    import time
    from pathlib import Path

    from ipc_proofs_tpu.fixtures import build_range_world as ref_build_range_world
    from ipc_proofs_tpu.proofs.generator import EventProofSpec as RefSpec
    from ipc_proofs_tpu.proofs.range import generate_event_proofs_for_range_chunked as ref_chunked
    from ipc_proofs_tpu_torch.jobs.journal import read_journal

    sig, topic1 = "NewTopDownMessage(bytes32,uint256)", "calib-subnet-1"
    repo = Path(__file__).resolve().parent.parent
    port_file = tmp_path / "port"
    argv = [sys.executable, "-c", _CLUSTER_CHILD, "cluster", "--shards", "2", "--backend", "cpu",
            "--demo-world", "8", "--demo-receipts", "8", "--demo-match-rate", "0.25", "--port", "0",
            "--port-file", str(port_file), "--queue-dir", str(tmp_path / "q"), "--scrape-interval-s", "0.2",
            "--trace-out", str(tmp_path / "trace.json")]
    env = dict(os.environ, PYTHONPATH=str(repo))
    proc = subprocess.Popen(argv, cwd=repo, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + 120
        while not port_file.exists() and proc.poll() is None and time.monotonic() < deadline:
            time.sleep(0.05)
        assert port_file.exists(), proc.communicate(timeout=30)
        base = f"http://127.0.0.1:{port_file.read_text()}"
        status, health = _http(base, "/healthz")
        assert status == 200 and health["status"] == "ok" and health["shards_alive"] == 2
        status, obj = _http(base, "/v1/generate_range", {"pair_indexes": list(range(8))})
        assert status == 200 and obj["n_groups"] == 2
        store, pairs, _ = ref_build_range_world(8, receipts_per_pair=8, match_rate=0.25, signature=sig, topic1=topic1)
        direct = ref_chunked(store, pairs, RefSpec(event_signature=sig, topic_1=topic1), chunk_size=8)
        assert json.dumps(obj["bundle"], sort_keys=True) == json.dumps(direct.to_json_obj(), sort_keys=True)
        assert direct.event_proofs
        status, gen = _http(base, "/v1/generate", {"pair_index": 3})
        assert status == 200
        status, verdict = _http(base, "/v1/verify", {"bundle": gen["result"]["bundle"]})
        assert status == 200 and verdict["result"]["all_valid"] is True
        time.sleep(0.5)  # one federation scrape
        status, cs = _http(base, "/v1/cluster/status")
        assert status == 200 and set(cs["ring"]) == {"s0", "s1"} and cs["router"]["requests"] == 3
        status, prom = _http(base, "/metrics.prom")
        assert status == 200 and 'shard="fleet"' in prom and 'shard="router"' in prom
    finally:
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=120)
    rc = proc.returncode
    assert rc == 0, err[-3000:]
    assert "LOADED []" in out, out
    events = json.loads((tmp_path / "trace.json").read_text())
    events = events["traceEvents"] if isinstance(events, dict) else events
    names = {e.get("name") for e in events}
    assert {"cluster.generate_range", "cluster.dispatch", "http.generate_range"} <= names, sorted(names)[:40]
    logs = dict(re.findall(r"shard (s\d) up at http://127\.0\.0\.1:\d+ \(log (\S+)\)", err))
    assert sorted(logs) == ["s0", "s1"], err[-3000:]
    for name, path in logs.items():
        text = Path(path).read_text()
        lines = [json.loads(line.split("kernel launches: ", 1)[1]) for line in text.splitlines()
                 if "kernel launches: " in line]
        assert len(lines) == 2 and all(set(c.values()) == {0} for c in lines), text[-2000:]
        os.remove(path)
        records, _, torn = read_journal(str(tmp_path / "q" / name / "queue.bin"))
        admits = {r["key"] for r in records if r["t"] == "admit"}
        assert not torn and admits == {r["key"] for r in records if r["t"] == "done"}, (name, records)
    assert sum(len(read_journal(str(tmp_path / "q" / n / "queue.bin"))[0]) for n in logs) == 2 * 4


def _subcommand_options(cli, command, monkeypatch) -> dict:
    """Option string → (dest, default, choices) of ``cli``'s ``command``
    parser, captured where `main` parses."""
    import argparse

    captured = {}

    def capture(self, args=None, namespace=None):
        captured["parser"] = self
        raise SystemExit(0)

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", capture)
        with pytest.raises(SystemExit):
            cli.main([command])
    sub = next(a for a in captured["parser"]._actions if isinstance(a, argparse._SubParsersAction))
    return {opt: (a.dest, a.default, a.choices) for a in sub.choices[command]._actions for opt in a.option_strings}


def test_cluster_takes_every_reference_flag_and_backend(monkeypatch):
    """``cluster --help`` of the port lists every flag of the reference's,
    with its default and choices, and ``--backend`` (default the card)."""
    port = _subcommand_options(port_cli, "cluster", monkeypatch)
    ref = _subcommand_options(ref_cli, "cluster", monkeypatch)
    assert set(port) - set(ref) == {"--backend"}
    assert {opt: port[opt] for opt in ref} == ref
    assert port["--backend"] == ("backend", "gpu", ("gpu", "cpu", "none"))
