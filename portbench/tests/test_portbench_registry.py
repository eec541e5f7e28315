"""The harness finds configurations, traffic mixes and per-layer metrics by
name, and its last line has the contract's keys."""

import json

from portbench.bench.registry import Registry
from portbench.run import result_line, run_cell
from portbench.tests.conftest import ROOT


def test_benchmark_names_match_files():
    reg = Registry(ROOT)
    for cell in reg.bench["workloads"]:
        reg.cell(cell["name"])  # its configuration and traffic files load
    for entry in reg.bench["per_layer"]:
        module = reg.metric(entry["name"])
        assert (module.UNIT, module.LAYER, module.MOVES) == (
            entry["unit"], entry["layer"], entry["moves"])
    for entry in reg.bench["end_to_end"]:
        assert reg.metric(entry["name"]).UNIT == entry["unit"]
    # each cell reports what its per-layer metrics move
    for cell in reg.bench["workloads"]:
        reported = {m["name"] for m in reg.cell(cell["name"]).end_to_end}
        assert {"setup_s"} < reported
        assert {m["moves"] for m in reg.cell(cell["name"]).per_layer} <= reported
    for config in reg.bench["configs"]:
        data = json.loads((ROOT / config["file"]).read_text())
        assert data["name"] == config["name"] and data["source"] == config["source"]
        assert data["reduced"] == config["reduced"]


def test_new_files_are_found_with_no_edit(tiny_root):
    """A configuration, a traffic mix and a per-layer metric added as files
    (and entries in BENCHMARK.json) run with no other change."""
    pieces = tiny_root / "portbench"
    config = json.loads((pieces / "configs/topdown_range_4k.json").read_text())
    config.update(name="topdown_range_tiny2")
    config["shape"].update(n_pairs=8)
    config["assumed"].update(receipts_per_pair=8)
    (pieces / "configs/topdown_range_tiny2.json").write_text(json.dumps(config))
    traffic = json.loads((pieces / "traffic/gen_verify_serial.json").read_text())
    traffic["clients"] = 2
    (pieces / "traffic/two_relayers.json").write_text(json.dumps(traffic))
    (pieces / "metrics/units.count.py").write_text(
        "UNIT = 'units'\nLAYER = 'device'\nMOVES = 'proofs_per_s'\n\n"
        "def read(record):\n    return record['units'] or None\n")
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "topdown_range_tiny2", "source": "test",
                             "file": "portbench/configs/topdown_range_tiny2.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny2.two", "config": "topdown_range_tiny2",
                               "traffic": "two_relayers", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "units.count", "unit": "units", "better": "higher",
                               "source": "host_clock", "layer": "device",
                               "moves": "proofs_per_s", "workloads": ["tiny2.two"]})
    bench["end_to_end"][0]["workloads"].append("tiny2.two")
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))

    reg = Registry(tiny_root)
    cell = reg.cell("tiny2.two")
    assert cell.traffic["clients"] == 2
    assert [m["name"] for m in cell.per_layer][-1] == "units.count"
    out = run_cell(reg, "tiny2.two", 12345, 0.3, False, device="cpu")
    assert out["correct"], out["checks"]
    assert out["end_to_end"]["proofs_per_s"]["value"] > 0
    assert reg.metric("units.count").read({"units": 3}) == 3


NEW_WORLD = """
import numpy as np
from portbench.reference.chain import World, raw_link


def build(sizes, seed=None):
    rng = np.random.default_rng(seed or 0)
    blocks = {}
    for n in rng.integers(0, sizes["max_bytes"], size=sizes["n_blocks"]):
        data = rng.bytes(int(n))
        blocks[bytes(raw_link(data))] = data
    return World(blocks=blocks, pairs=[], event_spec=("None()", "none", 0))
"""

NEW_UNIT = """
import hashlib
from portbench.bench.traffic import Unit as BaseUnit


class Unit(BaseUnit):
    def setup(self):
        self.messages = sorted(self.world.blocks.values())[: self.params["batch"]]

    def run(self, client, k):
        return self.program.backend.blake2b256_batch(self.messages), len(self.messages)

    def slim(self, k, output):
        return output

    def check(self, done):
        want = [hashlib.blake2b(m, digest_size=32).digest() for m in self.messages]
        return {"digests_wrong": sum(d != w for r in done for d, w in zip(r.output, want))}
"""

NEW_STORE = """
def load(world):
    from ipc_proofs_tpu_torch.fixtures import world_from_blocks

    return world_from_blocks(world.blocks.items(), [])
"""


def test_new_kinds_of_piece_are_found_with_no_edit(tiny_root, monkeypatch):
    """A new world kind, unit kind and store, with a configuration, a mix
    and a metric that use them, all added as files: a cell of them runs and
    its check holds; broken underneath, the same check fails."""
    pieces = tiny_root / "portbench"
    (pieces / "reference/worlds/blobs.py").write_text(NEW_WORLD)
    (pieces / "units/hash_blocks.py").write_text(NEW_UNIT)
    (pieces / "stores/blobs_only.py").write_text(NEW_STORE)
    (pieces / "configs/blobs_small.json").write_text(json.dumps({
        "name": "blobs_small", "source": "test", "world": "blobs",
        "shape": {"n_blocks": 40, "max_bytes": 300}, "reduced": []}))
    (pieces / "traffic/hash_two_clients.json").write_text(json.dumps({
        "loop": "closed", "unit": "hash_blocks", "store": "blobs_only", "policy": "accept_all",
        "clients": 2, "batch": 32}))
    (pieces / "metrics/units.count.py").write_text(
        "UNIT = 'units'\nLAYER = 'device'\nMOVES = 'proofs_per_s'\n\n"
        "def read(record):\n    return record['units'] or None\n")
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "blobs_small", "source": "test",
                             "file": "portbench/configs/blobs_small.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "blobs.hash", "config": "blobs_small",
                               "traffic": "hash_two_clients", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "units.count", "unit": "units", "better": "higher",
                               "source": "host_clock", "layer": "device",
                               "moves": "proofs_per_s", "workloads": ["blobs.hash"]})
    bench["end_to_end"][0]["workloads"].append("blobs.hash")
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))

    reg = Registry(tiny_root)
    out = run_cell(reg, "blobs.hash", 2**33 + 1, 0.3, False, device="cpu")
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == {"units_failed", "digests_wrong"}
    assert out["end_to_end"]["proofs_per_s"]["value"] > 0
    assert reg.metric("units.count").read({"units": 3}) == 3

    from ipc_proofs_tpu_torch.backend import gpu

    inner = gpu.GpuBackend.blake2b256_batch
    monkeypatch.setattr(gpu.GpuBackend, "blake2b256_batch",
                        lambda self, m: [b"\0" * 32] + inner(self, m)[1:])
    out = run_cell(Registry(tiny_root), "blobs.hash", 2**33 + 1, 0.3, False, device="cpu")
    assert not out["correct"] and out["checks"]["digests_wrong"]["value"] > 0


def test_last_line_keys(tiny_root):
    reg = Registry(tiny_root)
    out = run_cell(reg, "evm_slots_65k.gen_verify", 2**33 + 5, 0.2, False, device="cpu")
    line = result_line(out, False, "NVIDIA H100 80GB HBM3", 1)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(line["metrics"]) == {"proofs_per_s", "setup_s"}
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert all(set(c) == {"value", "limit"} for c in line["checks"].values())
    json.dumps(line)

    traced = dict(out, per_layer={"device.idle_pct": {"value": 99.0, "unit": "%"}},
                  busy_s=0.01, breakdown={"device_ops": [], "idle_gaps": []})
    line = result_line(traced, True, "NVIDIA H100 80GB HBM3", 1)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                          "checks"]
    assert {"busy_s", "window_s"} <= set(line["device"])
