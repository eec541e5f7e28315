"""One run of one benchmark cell of ``ipc_proofs_tpu_torch`` on the card.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Loads the kernels, builds the cell's world from the seed, loads it into the
program, runs one warm unit of each shape, then runs whole units for
``--seconds``; ``setup_s`` is everything before the window. With ``--trace 1`` the window
runs under ``torch.profiler`` (CUDA activity only) and the benchmark's own
host spans, and the line carries the per-layer metrics instead of the
end-to-end ones. A cell with an end-to-end metric read from the card's
timeline (``source`` ``device_trace``) runs its untraced window under the
same profiler, without the host spans. Each metric is read by
``portbench/metrics/<name>.py``. Once the window has closed and the peak memory is read,
every unit's answers are held against the plain reference
(`portbench.reference`); the numbers compared and their limits end the
standard error and the result line. The last line of standard output is
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``,
``device`` and, traced, ``breakdown``.

``--control`` puts the reference in the program's place with one guarantee
broken (each unit kind says which, ``portbench/units/``); its runs must
come out not correct. The benchmark's own runs never pass it.
"""

from __future__ import annotations

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench.bench.registry import Registry  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "ipc_proofs_tpu")


def forbidden_modules() -> "list[str]":
    """Loaded modules whose top-level name (before the first dot) is JAX's
    or the JAX package's, compared whole."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def log(message: str) -> None:
    print(f"portbench: {message}", file=sys.stderr, flush=True)


def run_cell(registry: Registry, workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", control: bool = False) -> dict:
    """Everything of a run but the card check and the printing: the result
    object, and ``checks`` (each number compared with its limit)."""
    from portbench.bench import metrics as readers
    from portbench.bench.host import HostWatch, calibrate
    from portbench.bench.program import Program, launch_count
    from portbench.bench.trace import DeviceTimeline, Spans
    from portbench.bench.traffic import Traffic

    cell = registry.cell(workload)
    mix = cell.traffic
    mark = [_T_START]

    def step(what: str) -> None:
        now = time.perf_counter()
        log(f"set-up: {what} in {now - mark[0]:.3f} s")
        mark[0] = now

    step("imports")
    world = registry.world(cell.config, seed)
    step(f"world {cell.config['name']} ({len(world.blocks)} blocks, {len(world.pairs)} pairs)")
    program = Program(world, registry.module("stores", mix["store"]),
                      registry.module("policies", mix["policy"]), device=device)
    step("program loaded (kernels, store)")
    traffic = Traffic(registry, mix, program, world, seed, control=control)
    log(f"thread budget: {program.thread_budget(mix.get('threads'))}")
    traffic.setup()
    step("traffic set up")
    traffic.warm()
    step("warm unit(s)")

    spans = Spans() if trace else None
    hashed: dict = {}
    device_traced = trace or (device == "cuda" and any(
        m["source"] == "device_trace" for m in cell.end_to_end))
    timeline = DeviceTimeline() if device_traced else None
    if trace:
        program.instrument(spans, hashed)
    program.metrics.reset()
    # what set-up made (the world, the store, the reference's claims) is not
    # the window's garbage: the collector leaves it out of its walks
    gc.collect()
    gc.freeze()
    launches0 = launch_count()
    setup_s = time.perf_counter() - _T_START
    if timeline is not None:
        timeline.start()
    host = HostWatch()
    host.start()
    records, w0, w1 = traffic.run(seconds, spans)
    watched = host.stop()
    ops = timeline.stop() if timeline is not None else None
    watched["calibrate_s"] = calibrate()
    launches = launch_count() - launches0
    peak = 0
    if device == "cuda":
        import torch

        peak = torch.cuda.max_memory_allocated()
    if trace:
        program.uninstrument()
    done = [r for r in records if r.error is None]
    took = sorted(r.end - r.start for r in done)
    if took:
        log(f"window {w1 - w0:.3f} s: {len(done)} units, {sum(r.proofs for r in done)} proofs, "
            f"unit s min {took[0]:.4f} median {took[len(took) // 2]:.4f} max {took[-1]:.4f}")
        log("unit s in order: " + " ".join(f"{r.end - r.start:.3f}" for r in done[:60]))
    log("host: " + json.dumps(watched))
    for r in records:
        if r.error is not None:
            log(f"unit failed: {r.error!r}")
    record = {
        "units": len(done),
        "proofs": sum(r.proofs for r in done),
        "clients": traffic.clients,
        "unit_seconds": [r.end - r.start for r in done],
        "window": (w0, w1),
        "stages": program.metrics.snapshot().get("timers", {}),
        "spans": spans.by_name() if spans is not None else {},
        "launches": launches,
        "hashed": hashed,
        "host": watched,
        "device_ops": ops,
        "setup_s": setup_s,
        "window_s": w1 - w0,
    }
    t_check = time.perf_counter()
    checks = traffic.check(records)
    log(f"reference check took {time.perf_counter() - t_check:.3f} s")
    window_s = w1 - w0
    out = {
        "correct": all(v == 0 for v in checks.values()),
        "attempted": len(records),
        "failed": checks["units_failed"],
        "checks": {k: {"value": v, "limit": 0} for k, v in checks.items()},
        "setup_s": setup_s,
        "window_s": window_s,
        "memory_peak_bytes": peak,
    }
    if trace:
        out["per_layer"], out["busy_s"], out["breakdown"] = readers.read_all(
            registry, cell, record, spans)
    else:
        out["end_to_end"] = readers.read_end_to_end(registry, cell, record, device_traced)
    return out


def result_line(out: dict, trace: bool, kind: str, count: int) -> dict:
    """The run's last line: ``correct``, ``attempted``, ``failed``,
    ``metrics``, ``device``, traced ``breakdown``, and the numbers compared
    with their limits last."""
    device = {"platform": "gpu", "kind": kind, "count": count,
              "memory_peak_bytes": out["memory_peak_bytes"]}
    line = {"correct": out["correct"], "attempted": out["attempted"], "failed": out["failed"]}
    if trace:
        device.update(busy_s=out["busy_s"], window_s=out["window_s"])
        line.update(metrics=out["per_layer"], device=device, breakdown=out["breakdown"])
    else:
        line.update(metrics=out["end_to_end"], device=device)
    line["checks"] = out["checks"]
    return line


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    parser.add_argument("--control", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)

    registry = Registry()
    cell = registry.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} CUDA card(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    out = run_cell(registry, args.workload, args.seed, args.seconds, bool(args.trace),
                   control=args.control)
    found = forbidden_modules()
    if found:
        log(f"the run loaded JAX or the JAX package: {', '.join(found)}")
        return 3
    line = result_line(out, bool(args.trace), torch.cuda.get_device_name(0), cell.chips)
    for name, check in line["checks"].items():
        print(f"check {name}: {check['value']} (limit {check['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("USE_FLAX", "0")
    sys.exit(main())
