"""The metrics of a run, each read by its own module.

`read_end_to_end` reads a cell's end-to-end metrics from an untraced run's
record: the harness's clock and, where a metric's ``source`` is
``device_trace``, the card's timeline over the window, which such a cell's
untraced runs record too. `read_all` reduces the card's timeline over the
window of a traced run (busy seconds, idle gaps, the breakdown) into its
record, then reads each per-layer metric of the cell. Each metric is read by
``read(record)`` of ``portbench/metrics/<name>.py``; a reader that finds
nothing to read returns None. Every metric that `BENCHMARK.json` lists for
the cell has something to read in its run, so a None there, or a window in
which the card ran nothing, fails the run rather than leave a metric out.
The record's keys:

- ``units``, ``proofs``, ``clients``, ``unit_seconds``: the window's
  completed units, their proofs, the clients, each unit's wall seconds;
- ``window``: the window's bounds (``time.perf_counter`` seconds);
- ``stages``: the program's own ``Metrics`` stage timers over the window
  (``wall_s``: the union of a stage's intervals, ``total_s``: their sum);
- ``spans``: the benchmark's host spans by name (``unit``,
  ``blake2b256_batch``, ``keccak256_batch``, ``verify_block_cids``);
- ``launches``: kernel launches in the window, from the program's
  ``LAUNCHES`` counters;
- ``hashed``: the lengths of the messages handed to the backend's blake2b
  and keccak entries;
- ``device_ops``: ``(name, start, end)`` of every device operation, on
  the host's clock; ``busy_s`` and ``window_s``: the union of the ops
  within the window, and its length;
- ``setup_s``: process start to the window's opening.
"""

from __future__ import annotations

from portbench.bench.trace import breakdown, busy_and_gaps

__all__ = ["read_all", "read_end_to_end"]


def _window_ops(record: dict) -> list:
    """The device ops inside the window; a trace with none raises."""
    w0, w1 = record["window"]
    ops = [op for op in record["device_ops"] if op[2] > w0 and op[1] < w1]
    if not ops:
        raise RuntimeError("the profiler saw no device operation inside the traced window")
    return ops


def _read(registry, cell, entries, record: dict) -> dict:
    values = {}
    for entry in entries:
        value = registry.metric(entry["name"]).read(record)
        if value is None:
            raise RuntimeError(f"{entry['name']} found nothing to read in {cell.name}'s run")
        values[entry["name"]] = {"value": value, "unit": entry["unit"]}
    return values


def read_end_to_end(registry, cell, record: dict, device_traced: bool) -> dict:
    """The cell's end-to-end metrics. Without the card's timeline (a run on
    the CPU, in the tests) a ``device_trace`` metric is left out."""
    entries = cell.end_to_end
    if device_traced:
        record.update(device_ops=_window_ops(record))
    else:
        entries = [m for m in entries if m["source"] != "device_trace"]
    return _read(registry, cell, entries, record)


def read_all(registry, cell, record: dict, spans) -> "tuple[dict, float, dict]":
    w0, w1 = record["window"]
    ops = _window_ops(record)
    busy, gaps = busy_and_gaps(ops, (w0, w1))
    record.update(device_ops=ops, busy_s=busy, window_s=w1 - w0)
    return _read(registry, cell, cell.per_layer, record), busy, breakdown(ops, gaps, spans)
