"""The port's provenance registry (`registry/`) against the JAX package.

- RFC 6962 trees: for every size n = 1…64 over numpy-seeded leaves, the
  root, every inclusion path and every consistency path equal the
  reference's, and each package's verifier accepts the other's proofs and
  rejects tampered ones alike;
- IPR1 logs: a log written by either package, with fixed ``t=``, is the
  same bytes and opens in the other with the same head; a torn tail at
  every cut opens alike (truncated, counted) and appends alike; a single
  flipped bit anywhere is detected alike; a crash mid-append (the
  ``IPC_REGISTRY_CRASH_*`` hooks) leaves a log both packages recover;
- the fleet base directory: `FleetBaseCache` gives a local hit, a fleet
  hit through a sibling's log and a miss, with the reference's counters;
  base acks resolve to the same fleet bases.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import ipc_proofs_tpu.registry as ref_registry  # noqa: E402
import ipc_proofs_tpu.registry.mmr as ref_mmr  # noqa: E402
import ipc_proofs_tpu_torch.registry as port_registry  # noqa: E402
import ipc_proofs_tpu_torch.registry.mmr as port_mmr  # noqa: E402
from ipc_proofs_tpu.utils.metrics import Metrics as RefMetrics  # noqa: E402
from ipc_proofs_tpu.witness.bases import FleetBaseCache as RefFleetBaseCache  # noqa: E402
from ipc_proofs_tpu.witness.bases import WitnessBaseCache as RefWitnessBaseCache  # noqa: E402
from ipc_proofs_tpu_torch.utils.metrics import Metrics  # noqa: E402
from ipc_proofs_tpu_torch.witness.bases import FleetBaseCache, WitnessBaseCache  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
PACKAGES = {"port": port_registry, "ref": ref_registry}
METRICS = {"port": Metrics, "ref": RefMetrics}
T0 = 1_700_000_000.0


def _leaves(n, seed=0):
    rng = np.random.default_rng(seed)
    return [port_mmr.leaf_hash(rng.integers(0, 256, int(rng.integers(1, 80)), dtype=np.uint8).tobytes())
            for _ in range(n)]


def test_hashes_equal_the_reference():
    rng = np.random.default_rng(1)
    for _ in range(32):
        a, b = (rng.integers(0, 256, 32, dtype=np.uint8).tobytes() for _ in range(2))
        assert port_mmr.leaf_hash(a) == ref_mmr.leaf_hash(a)
        assert port_mmr.node_hash(a, b) == ref_mmr.node_hash(a, b)
        assert port_mmr.leaf_hash(a + b) != port_mmr.node_hash(a, b)
    assert port_mmr.merkle_root([]) == ref_mmr.merkle_root([]) == port_mmr.MerkleLog().root()


@pytest.mark.parametrize("n", range(1, 65))
def test_tree_of_size_n_equals_the_reference(n):
    leaves = _leaves(n, seed=n)
    root = port_mmr.merkle_root(leaves)
    assert root == ref_mmr.merkle_root(leaves)
    log, ref_log = port_mmr.MerkleLog(leaves), ref_mmr.MerkleLog(leaves)
    assert log.root() == ref_log.root() == root and log.size == n
    for i in range(n):
        path = log.inclusion_path(i)
        assert path == ref_log.inclusion_path(i)
        for mmr in (port_mmr, ref_mmr):
            assert mmr.verify_inclusion(leaves[i], i, n, path, root)
            assert not mmr.verify_inclusion(leaves[i], (i + 1) % n, n, path, root) or n == 1
            if path:
                bad = list(path)
                bad[-1] = bytes(32)
                assert not mmr.verify_inclusion(leaves[i], i, n, bad, root)
    for m in range(1, n + 1):
        path = log.consistency_path(m)
        assert path == ref_log.consistency_path(m)
        old = log.root_at(m)
        assert old == ref_log.root_at(m) == port_mmr.merkle_root(leaves[:m])
        for mmr in (port_mmr, ref_mmr):
            assert mmr.verify_consistency(m, n, old, root, path)
            if m < n:
                assert not mmr.verify_consistency(m, n, bytes(32), root, path)
                assert not mmr.verify_consistency(m, n, old, root, path + [bytes(32)])
    for mmr in (port_mmr, ref_mmr):
        assert not mmr.verify_inclusion(leaves[0], n, n, [], root)
        assert not mmr.verify_consistency(n + 1, n, root, root, [])
        with pytest.raises(IndexError):
            mmr.inclusion_path(leaves, n)
        with pytest.raises(IndexError):
            mmr.consistency_path(leaves, 0)


# --------------------------------------------------------------------------
# IPR1 logs
# --------------------------------------------------------------------------


def _cids(i, k=3):
    return frozenset(port_mmr.leaf_hash(f"{i}-{j}".encode()) for j in range(k))


def test_base_acks_carry_wall_time(tmp_path):
    """`append_base_ack` stamps the wall clock (in both packages), so two
    logs with acks are compared by their serve records only."""
    for name, pkg in PACKAGES.items():
        reg = pkg.ProvenanceRegistry(str(tmp_path / name), owner="main")
        reg.append_base_ack("f", "k", "s", "d" * 64, 1)
        assert reg.entry(0)["kind"] == "base" and isinstance(reg.entry(0)["t"], float)
        reg.close()


def _fill_serve(pkg, root, n=6, owner="main"):
    reg = pkg.ProvenanceRegistry(root, owner=owner)
    for i in range(n):
        reg.append_served(
            f"{i:064x}", trace=f"t{i}", tenant="acme", key=f"pair:{i}",
            verdict="served" if i % 2 else "valid", cids=_cids(i) if i != 3 else None, t=T0 + i / 7,
        )
    return reg


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_a_log_opens_in_the_other_package_with_the_same_head(tmp_path, writer):
    logs = {}
    for name, pkg in PACKAGES.items():
        reg = _fill_serve(pkg, str(tmp_path / name))
        logs[name] = (reg.head(), Path(reg.path).read_bytes())
        reg.close()
    assert logs["port"][1] == logs["ref"][1]
    assert logs["port"][0] == logs["ref"][0]
    other = "ref" if writer == "port" else "port"
    reopened = PACKAGES[other].ProvenanceRegistry(str(tmp_path / writer))
    try:
        assert reopened.head() == logs[writer][0]
        for seq in range(len(reopened)):
            proof = reopened.inclusion_proof(seq)
            assert port_mmr.verify_inclusion(
                bytes.fromhex(proof["leaf"]), seq, proof["size"],
                [bytes.fromhex(h) for h in proof["path"]], bytes.fromhex(proof["root"]),
            )
        assert reopened.seq_of(f"{4:064x}") == 4
        assert reopened.lookup_base(f"{0:064x}") == _cids(0)
        assert reopened.lookup_base(f"{3:064x}") is None  # served without a CID set
    finally:
        reopened.close()


def test_read_and_verify_chain_equal_the_reference(tmp_path):
    reg = _fill_serve(port_registry, str(tmp_path))
    reg.close()
    entries = port_registry.read_registry_frames(reg.path)
    ref_entries = ref_registry.read_registry_frames(reg.path)
    assert entries == ref_entries and len(entries[0]) == 6 and not entries[2]
    tip = port_registry.verify_chain(entries[0])
    assert tip == ref_registry.verify_chain(ref_entries[0]) == reg.head()["tip"]
    assert port_registry.frame_registry_record({"a": 1}) == ref_registry.frame_registry_record({"a": 1})
    assert port_registry.record_digest(b"x") == ref_registry.record_digest(b"x")
    broken = [entries[0][0], entries[0][2]]
    for pkg in PACKAGES.values():
        with pytest.raises(pkg.RegistryError):
            pkg.verify_chain(broken)


def _open_outcome(pkg, root):
    """A registry open's outcome: its head, its size and its torn-tail count,
    or the typed error's class name."""
    metrics = METRICS["ref" if pkg is ref_registry else "port"]()
    try:
        reg = pkg.ProvenanceRegistry(root, metrics=metrics)
    except pkg.RegistryError as exc:
        return f"raise {type(exc).__name__}"
    try:
        return (reg.head(), metrics.counter_value("registry.torn_tails"))
    finally:
        reg.close()


@pytest.fixture
def log_bytes(tmp_path):
    reg = _fill_serve(port_registry, str(tmp_path / "src"), n=3)
    reg.close()
    return Path(reg.path).read_bytes()


def test_torn_tails_at_every_cut_open_and_append_alike(tmp_path, log_bytes):
    frames = port_registry.read_registry_frames(str(tmp_path / "src" / "reg-main.log"))[0]
    ends = [off + 12 + len(payload) for _, payload, off in frames]
    for cut in range(len(log_bytes) + 1):
        outcomes, files = [], []
        for name, pkg in PACKAGES.items():
            root = tmp_path / f"cut{cut}-{name}"
            root.mkdir()
            (root / "reg-main.log").write_bytes(log_bytes[:cut])
            outcomes.append(_open_outcome(pkg, str(root)))
            reg = pkg.ProvenanceRegistry(str(root))
            reg.append_served("ff" * 32, key="after", cids=_cids(9), t=T0)
            reg.close()
            files.append((root / "reg-main.log").read_bytes())
        assert outcomes[0] == outcomes[1], cut
        head, torn = outcomes[0]
        assert torn == (cut not in [0] + ends), cut
        assert head["size"] == sum(1 for end in ends if end <= cut), cut
        assert files[0] == files[1], cut


def test_single_bit_flips_are_detected_alike(tmp_path, log_bytes):
    rng = np.random.default_rng(5)
    positions = sorted(set(range(0, len(log_bytes), 3)) | {0, 4, 8, 12, len(log_bytes) - 1})
    detected = 0
    for pos in positions:
        flipped = bytearray(log_bytes)
        flipped[pos] ^= 1 << int(rng.integers(0, 8))
        outcomes = []
        for name, pkg in PACKAGES.items():
            root = tmp_path / f"flip{pos}-{name}"
            root.mkdir()
            (root / "reg-main.log").write_bytes(bytes(flipped))
            outcomes.append(_open_outcome(pkg, str(root)))
        assert outcomes[0] == outcomes[1], pos
        if outcomes[0] == "raise RegistryError":
            detected += 1
        else:
            # a flip in a length field reads as a torn tail: the records
            # before it survive, nothing after it is ever trusted
            head, torn = outcomes[0]
            assert torn == 1 and head["size"] < 3, (pos, outcomes[0])
    assert detected > len(positions) * 0.9


_CRASH = """
import sys
from ipc_proofs_tpu_torch.registry import ProvenanceRegistry
reg = ProvenanceRegistry(sys.argv[1])
for i in range(4):
    reg.append_served("%064x" % i, key="pair:%d" % i, t=1.0 + i)
"""


@pytest.mark.parametrize("torn", [None, 7], ids=["boundary", "torn"])
def test_crash_mid_append_recovers_in_both(tmp_path, torn):
    env = dict(os.environ, PYTHONPATH=str(ROOT), IPC_REGISTRY_CRASH_AT="2")
    if torn is not None:
        env["IPC_REGISTRY_CRASH_TORN"] = str(torn)
    crashed = tmp_path / "crashed"
    proc = subprocess.run([sys.executable, "-c", _CRASH, str(crashed)], env=env, timeout=60)
    assert proc.returncode == -9
    want_size = 2 if torn is not None else 3
    heads = []
    for name, pkg in PACKAGES.items():
        # each package opens its own copy: an open truncates the torn tail
        (tmp_path / name).mkdir()
        (tmp_path / name / "reg-main.log").write_bytes((crashed / "reg-main.log").read_bytes())
        head, torn_count = _open_outcome(pkg, str(tmp_path / name))
        assert head["size"] == want_size and torn_count == (torn is not None)
        heads.append(head)
    assert heads[0] == heads[1]


def test_a_failed_write_degrades_without_advancing_the_head(tmp_path):
    heads = []
    for name, pkg in PACKAGES.items():
        metrics = METRICS[name]()
        reg = pkg.ProvenanceRegistry(str(tmp_path / name), metrics=metrics)
        assert reg.append_served("aa" * 32, t=T0) == 0
        before = reg.head()
        # a read-only handle: the next write raises an OSError
        reg._writer._fh.close()
        reg._writer._fh = open(os.devnull, "rb")
        assert reg.append_served("bb" * 32, t=T0) is None
        assert reg.append_served("cc" * 32, t=T0) is None
        assert reg.degraded and reg.head()["size"] == before["size"] == 1
        assert metrics.counter_value("registry.append_failures") == 2
        heads.append({k: v for k, v in reg.head().items() if k != "log_bytes"})
        reg.close()
    assert heads[0] == heads[1]


def test_proofs_and_consistency_between_two_heads(tmp_path):
    out = []
    for name, pkg in PACKAGES.items():
        reg = _fill_serve(pkg, str(tmp_path / name), n=5)
        first = reg.head()
        for i in range(5, 12):
            reg.append_served(f"{i:064x}", key=f"pair:{i}", cids=_cids(i), t=T0 + i)
        proof = reg.consistency(first["size"])
        assert proof["old_root"] == first["root"]
        assert port_mmr.verify_consistency(
            proof["old_size"], proof["size"], bytes.fromhex(proof["old_root"]),
            bytes.fromhex(proof["root"]), [bytes.fromhex(h) for h in proof["path"]],
        )
        out.append((proof, [reg.inclusion_proof(s) for s in range(len(reg))], reg.entry(3)))
        assert reg.inclusion_proof(99) is None and reg.consistency(99) is None and reg.entry(-1) is None
        reg.close()
    assert out[0] == out[1]


# --------------------------------------------------------------------------
# the fleet base directory
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["port", "ref"])
def test_fleet_base_cache_local_hit_fleet_hit_and_miss(tmp_path, name):
    pkg = PACKAGES[name]
    cache_cls = (FleetBaseCache, WitnessBaseCache) if name == "port" else (RefFleetBaseCache, RefWitnessBaseCache)
    sibling = pkg.ProvenanceRegistry(str(tmp_path), owner="shard-1")
    sibling.append_served("aa" * 32, key="pair:1", cids=_cids(1), t=T0)
    own = pkg.ProvenanceRegistry(str(tmp_path), owner="shard-0")
    metrics = METRICS[name]()
    cache = cache_cls[0](cache_cls[1](cap=4), own, metrics=metrics)
    cache.register("bb" * 32, _cids(2))
    outcomes = [cache.lookup("bb" * 32), cache.lookup("aa" * 32), cache.lookup("cc" * 32), cache.lookup("aa" * 32)]
    assert outcomes == [_cids(2), _cids(1), None, _cids(1)]
    counters = metrics.snapshot()["counters"]
    assert counters == {"witness.fleet_base_hits": 1, "witness.fleet_base_misses": 1}
    assert len(cache) == 2
    sibling.close()
    own.close()


def test_fleet_base_cache_treats_directory_trouble_as_a_miss():
    class Broken:
        def lookup_base(self, digest):
            raise OSError("directory unreadable")

    for cls, local, metrics in ((FleetBaseCache, WitnessBaseCache, Metrics),
                                (RefFleetBaseCache, RefWitnessBaseCache, RefMetrics)):
        m = metrics()
        assert cls(local(), Broken(), metrics=m).lookup("dd" * 32) is None
        assert m.counter_value("witness.fleet_base_misses") == 1


def test_fleet_acks_resolve_alike(tmp_path):
    rng = np.random.default_rng(11)
    plan = [(int(rng.integers(0, 3)), f"k{int(rng.integers(0, 2))}", f"s{int(rng.integers(0, 3))}",
             f"{int(rng.integers(0, 6)):064x}", int(rng.integers(0, 5))) for _ in range(40)]
    answers = []
    for name, pkg in PACKAGES.items():
        regs = [pkg.ProvenanceRegistry(str(tmp_path / name), owner=f"shard-{s}") for s in range(3)]
        for shard, key, sub, digest, cursor in plan:
            regs[shard].append_base_ack("fleet", key, sub, digest, cursor)
        got = []
        for reg in regs:
            for key in ("k0", "k1"):
                got.append(reg.newest_common_base("fleet", key))
                got.extend(reg.fleet_acked_base("fleet", key, f"s{s}") for s in range(3))
        answers.append(got)
        for reg in regs:
            reg.close()
    assert answers[0] == answers[1]
    assert any(a is not None for a in answers[0])


def test_a_corrupt_sibling_is_counted_not_fatal(tmp_path):
    for name, pkg in PACKAGES.items():
        root = tmp_path / name
        root.mkdir()
        frame = bytearray(port_registry.frame_registry_record({"kind": "serve", "prev": ""}))
        frame[-2] ^= 0x01  # a complete frame whose CRC no longer matches
        (root / "reg-bad.log").write_bytes(bytes(frame))
        metrics = METRICS[name]()
        reg = pkg.ProvenanceRegistry(str(root), metrics=metrics)
        assert reg.lookup_base("aa" * 32) is None
        assert metrics.counter_value("registry.fleet_refresh_errors") == 1
        reg.close()
