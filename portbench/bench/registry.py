"""Finds the benchmark's pieces by name: nothing here lists them.

`BENCHMARK.json` at the root names the cells and the metrics. Each piece is
a file under ``portbench/`` named after what refers to it:

- ``configs/<config>.json``: a configuration; its ``world`` names a world
  builder ``reference/worlds/<kind>.py``;
- ``traffic/<traffic>.json``: a traffic mix, parameters that the one
  generator (`portbench.bench.traffic`) reads; it names its arrival loop
  ``loops/<loop>.py``, its unit of work ``units/<unit>.py``, the store the
  program serves from ``stores/<store>.py`` and its trust policy
  ``policies/<policy>.py``;
- ``metrics/<name>.py``: the reader of one metric, end-to-end or per-layer
  (`reader_beside` lets a reader read what another does, under its own
  name).

Adding a configuration, a mix, a kind of unit, world, store, policy or loop,
or a metric adds files and entries; no file that is there changes.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

__all__ = ["Cell", "Registry", "ROOT", "load_module", "reader_beside"]

ROOT = Path(__file__).resolve().parents[2]  # the checkout: BENCHMARK.json and portbench/


def load_module(path: Path, name: str):
    """The Python file at ``path`` as a module named ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader_beside(path: str, name: str):
    """The metric reader ``<name>.py`` in the folder of the reader at
    ``path``: a metric that reads what another does, under a name, unit,
    layer and ``moves`` of its own."""
    return load_module(Path(path).with_name(f"{name}.py"), f"portbench_metrics_{name}")


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list  # BENCHMARK.json entries this cell reports with --trace 0
    per_layer: list  # ... and with --trace 1


class Registry:
    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())
        self.pieces = self.root / "portbench"
        self._modules: dict = {}

    def _json(self, folder: str, name: str) -> dict:
        return json.loads((self.pieces / folder / f"{name}.json").read_text())

    def module(self, folder: str, name: str):
        """``portbench/<folder>/<name>.py``, loaded once."""
        key = (folder, name)
        if key not in self._modules:
            path = self.pieces / folder / f"{name}.py"
            if not path.is_file():
                raise KeyError(f"no {path.relative_to(self.root)}")
            tag = folder.replace("/", "_")
            self._modules[key] = load_module(path, f"portbench_{tag}_{name}")
        return self._modules[key]

    def config(self, name: str) -> dict:
        return self._json("configs", name)

    def traffic(self, name: str) -> dict:
        return self._json("traffic", name)

    def metric(self, name: str):
        """The reader module of a metric: ``read(record)``."""
        return self.module("metrics", name)

    def world(self, config: dict, seed=None):
        """The world of a configuration: its kind's builder over its sizes
        (``shape`` and the ``assumed`` ones) and the seed."""
        sizes = {**config["shape"], **config.get("assumed", {})}
        return self.module("reference/worlds", config["world"]).build(sizes, seed)

    def cell(self, name: str) -> Cell:
        entry = next((w for w in self.bench["workloads"] if w["name"] == name), None)
        if entry is None:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")

        def applies(metric: dict) -> bool:
            return name in metric.get("workloads", [name])

        return Cell(
            name=name,
            config=self.config(entry["config"]),
            traffic=self.traffic(entry["traffic"]),
            chips=entry["chips"],
            end_to_end=[m for m in self.bench["end_to_end"] if applies(m)],
            per_layer=[m for m in self.bench["per_layer"] if applies(m)],
        )
