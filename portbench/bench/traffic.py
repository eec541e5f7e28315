"""The one traffic generator: a mix's arrival loop over its units of work.

A traffic mix is a data file (``portbench/traffic/<name>.json``) of
parameters. This module reads it and finds the pieces it names:

- ``loop``: ``portbench/loops/<loop>.py``, how units arrive (``closed``:
  closed loops of ``clients`` clients);
- ``unit``: ``portbench/units/<unit>.py``, one kind of work, a `Unit`
  subclass named ``Unit``: its set-up, one unit, what it counts and how
  its answers are checked;
- ``store`` and ``policy``: what `portbench.bench.program.Program` loads.

Every other key is the unit's. Each unit runs timed and is recorded; a
client's previous unit gives up what its `Unit.slim` drops once the next
has finished. Once the window has closed, `Traffic.check` holds every
answer against the reference: each count's limit is 0.
"""

from __future__ import annotations

import random
import time

__all__ = ["Traffic", "Unit", "UnitRecord"]


class UnitRecord:
    __slots__ = ("client", "k", "start", "end", "proofs", "output", "error")

    def __init__(self, client, k, start, end, proofs, output, error=None):
        self.client, self.k, self.start, self.end = client, k, start, end
        self.proofs, self.output, self.error = proofs, output, error


class Unit:
    """One kind of work. ``control`` puts the reference in the program's
    place with one guarantee broken; its runs must read not correct."""

    def __init__(self, program, world, params: dict, rng: random.Random, control: bool):
        self.program, self.world, self.params = program, world, params
        self.rng, self.control = rng, control

    def setup(self) -> None:
        """Untimed work before the warm unit (e.g. bundles to verify)."""

    def warm(self) -> None:
        """Run each shape the window will run once."""
        self.run(0, 0)

    def before(self, seconds: float, warm_s: float) -> None:
        """Called as the window opens, with the warm-up's seconds."""

    def run(self, client: int, k: int):
        """One unit: ``(output, proofs)``, the proofs it completed (only
        those of bundles whose every verdict is true)."""
        raise NotImplementedError

    def slim(self, k: int, output):
        """What of a finished unit's output the check still needs, once the
        same client's next unit has finished."""
        return output

    def check(self, done: "list[UnitRecord]") -> "dict[str, int]":
        """Mismatch counts of the finished units against the reference."""
        raise NotImplementedError


class Traffic:
    def __init__(self, registry, params: dict, program, world, seed: int, control: bool = False):
        self.params = params
        self.loop = registry.module("loops", params["loop"])
        kind = registry.module("units", params["unit"]).Unit
        self.unit = kind(program, world, params, random.Random(seed), control)
        self.clients = int(params.get("clients", 1))
        self.warm_s = 0.0
        self._last: dict = {}  # client -> its previous record

    def setup(self) -> None:
        self.unit.setup()

    def warm(self) -> None:
        t0 = time.perf_counter()
        self.unit.warm()
        self.warm_s = time.perf_counter() - t0

    def _step(self, spans):
        def step(client: int, k: int) -> UnitRecord:
            start = time.perf_counter()
            try:
                output, proofs = self.unit.run(client, k)
                rec = UnitRecord(client, k, start, time.perf_counter(), proofs, output)
            except Exception as exc:  # a failed unit fails the run's check; the client stops
                rec = UnitRecord(client, k, start, time.perf_counter(), 0, None, exc)
            if spans is not None:
                spans.add("unit", rec.start, rec.end)
            previous = self._last.get(client)
            if previous is not None and previous.output is not None:
                previous.output = self.unit.slim(previous.k, previous.output)
            self._last[client] = rec
            return rec

        return step

    def run(self, seconds: float, spans=None) -> "tuple[list[UnitRecord], float, float]":
        """The window: the loop's units until ``seconds`` have passed.
        Returns the records and the window's bounds (its end is the last
        unit's)."""
        self.unit.before(seconds, self.warm_s)
        t0 = time.perf_counter()
        records = self.loop.run(self._step(spans), self.clients, seconds, self.params)
        return records, t0, max(r.end for r in records)

    def check(self, records: "list[UnitRecord]") -> dict:
        counts = {"units_failed": sum(r.error is not None for r in records)}
        counts.update(self.unit.check([r for r in records if r.error is None]))
        return counts

