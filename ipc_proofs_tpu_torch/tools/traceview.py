"""Offline summarizer for ``--trace-out`` Chrome trace JSON.

Perfetto answers "show me everything"; this answers the two questions an
operator actually asks a trace first, without leaving the terminal:

- **where did the time go** — per-stage aggregate (count / total / mean /
  max) over every complete span, plus each trace's *critical path*: the
  chain from the root through its widest child at every level, with the
  unattributed self-time gap at each hop;
- **what was slow** — the top-5 widest spans per trace.

Usage::

    python -m ipc_proofs_tpu_torch.tools.traceview trace.json         # human summary
    python -m ipc_proofs_tpu_torch.tools.traceview trace.json --json  # machine-readable
    python -m ipc_proofs_tpu_torch.tools.traceview trace.json --trace-id ID
    python -m ipc_proofs_tpu_torch.tools.traceview --stitch router.json \
        shard0.json shard1.json --out fleet.json    # merge captures by trace_id
    ... --device cpu                                # on a host without CUDA

The input is the Chrome trace-event JSON written by
``ipc_proofs_tpu_torch.obs.export.write_chrome_trace`` (``--trace-out`` on
``generate`` / ``range`` / ``serve``); any trace-event file whose ``X``
events carry ``args.trace_id`` / ``args.span_id`` works. The counterpart
of the reference's ``tools/traceview.py``, output byte for byte; host code
that launches nothing, but like every tool of the port it asks for the
card unless ``--device cpu`` is given.

``--stitch`` merges captures from DIFFERENT processes of one distributed
request (router + shards) into a single coherent file: span ids are
process-local counters, so each file's ids get a ``f<k>:`` namespace
prefix — except references to span ids that exist in another capture
(the cross-process graft points), which are remapped to THAT capture's
namespace so the subtrees join up under one root per trace.
"""

from __future__ import annotations

import argparse
import json
import sys

from ipc_proofs_tpu_torch.tools import add_device_flag, backend_for

__all__ = ["load_events", "stitch", "summarize", "main"]

TOP_WIDEST = 5


def load_events(path: str) -> "list[dict]":
    """Complete (``ph == "X"``) events from a trace file; accepts both the
    ``{"traceEvents": [...]}`` object form and a bare JSON array."""
    with open(path) as fh:
        obj = json.load(fh)
    events = obj.get("traceEvents", obj) if isinstance(obj, dict) else obj
    if not isinstance(events, list):
        raise ValueError(f"{path}: not a Chrome trace-event file")
    return [e for e in events if isinstance(e, dict) and e.get("ph") == "X"]


def stitch(event_lists: "list[list[dict]]") -> "list[dict]":
    """Merge per-process captures of one distributed request.

    ``event_lists[k]`` is one file's ``X`` events. Span ids are
    process-local counters, so ids from file ``k`` are namespaced
    ``f"f{k}:<id>"``. A ``parent_id`` resolves within the SAME trace_id
    (trace ids are globally unique; span ids are not): same-file first —
    excluding a self-reference, which can only be an adopted span whose
    wire parent happens to collide with its own local id — then the
    first OTHER file holding that span id in the trace (the
    cross-process graft point: a shard's request span parents to the
    router span id it adopted from the wire carrier). Pass the router's
    capture first so ambiguous graft points resolve toward it. Parents
    found nowhere stay verbatim (those spans remain roots).
    """
    ids_by_file: "list[dict]" = []
    for evs in event_lists:
        per_trace: "dict[str, set]" = {}
        for e in evs:
            a = e.get("args", {})
            per_trace.setdefault(a.get("trace_id"), set()).add(a.get("span_id"))
        ids_by_file.append(per_trace)

    def resolve(parent, tid, own, k: int):
        if parent is None:
            return None
        if parent != own and parent in ids_by_file[k].get(tid, ()):
            return f"f{k}:{parent}"
        for j, per in enumerate(ids_by_file):
            if j != k and parent in per.get(tid, ()):
                return f"f{j}:{parent}"
        return parent

    merged: "list[dict]" = []
    for k, evs in enumerate(event_lists):
        for e in evs:
            out = dict(e)
            args = dict(e.get("args", {}))
            sid = args.get("span_id")
            args["parent_id"] = resolve(
                args.get("parent_id"), args.get("trace_id"), sid, k
            )
            if sid is not None:
                args["span_id"] = f"f{k}:{sid}"
            args["capture"] = f"f{k}"
            out["args"] = args
            merged.append(out)
    merged.sort(key=lambda e: e.get("ts", 0))
    return merged


def _critical_path(root: dict, children: "dict[str, list[dict]]") -> "list[dict]":
    """Root → widest child at every level. ``self_us`` is the hop's
    unattributed gap: its duration minus the widest child's — time spent
    in the span itself (or in siblings the path doesn't descend into)."""
    path = []
    node = root
    while node is not None:
        kids = children.get(node["args"]["span_id"], [])
        widest = max(kids, key=lambda e: e.get("dur", 0), default=None)
        path.append(
            {
                "name": node["name"],
                "dur_us": node.get("dur", 0),
                "self_us": node.get("dur", 0)
                - (widest.get("dur", 0) if widest is not None else 0),
            }
        )
        node = widest
    return path


def summarize(events: "list[dict]", trace_id: "str | None" = None) -> dict:
    """Aggregate a list of ``X`` events (see `load_events`)."""
    if trace_id is not None:
        events = [e for e in events if e.get("args", {}).get("trace_id") == trace_id]

    stages: "dict[str, dict]" = {}
    for e in events:
        st = stages.setdefault(
            e["name"], {"count": 0, "total_us": 0, "max_us": 0}
        )
        st["count"] += 1
        st["total_us"] += e.get("dur", 0)
        st["max_us"] = max(st["max_us"], e.get("dur", 0))
    for st in stages.values():
        st["mean_us"] = round(st["total_us"] / st["count"], 1)

    by_trace: "dict[str, list[dict]]" = {}
    for e in events:
        tid = e.get("args", {}).get("trace_id")
        if tid:
            by_trace.setdefault(tid, []).append(e)

    traces = []
    for tid, evs in by_trace.items():
        ids = {e["args"]["span_id"] for e in evs}
        children: "dict[str, list[dict]]" = {}
        roots = []
        for e in evs:
            parent = e["args"].get("parent_id")
            if parent in ids:
                children.setdefault(parent, []).append(e)
            else:
                roots.append(e)
        root = max(roots, key=lambda e: e.get("dur", 0), default=None)
        widest = sorted(evs, key=lambda e: e.get("dur", 0), reverse=True)
        traces.append(
            {
                "trace_id": tid,
                "spans": len(evs),
                "root": root["name"] if root is not None else None,
                "wall_us": root.get("dur", 0) if root is not None else None,
                "critical_path": (
                    _critical_path(root, children) if root is not None else []
                ),
                "widest": [
                    {"name": e["name"], "dur_us": e.get("dur", 0)}
                    for e in widest[:TOP_WIDEST]
                ],
            }
        )
    traces.sort(key=lambda t: t["wall_us"] or 0, reverse=True)
    return {"n_events": len(events), "n_traces": len(traces), "stages": stages,
            "traces": traces}


def _fmt_us(us) -> str:
    return f"{us / 1000:.2f}ms" if us is not None else "?"


def _print_human(summary: dict) -> None:
    print(f"{summary['n_events']} spans, {summary['n_traces']} traces")
    print("\nper-stage totals (busiest first):")
    order = sorted(
        summary["stages"].items(), key=lambda kv: kv[1]["total_us"], reverse=True
    )
    for name, st in order:
        print(
            f"  {name:<28} x{st['count']:<5} total {_fmt_us(st['total_us']):>10}"
            f"  mean {_fmt_us(st['mean_us']):>9}  max {_fmt_us(st['max_us']):>9}"
        )
    for t in summary["traces"]:
        print(
            f"\ntrace {t['trace_id']}  ({t['spans']} spans, "
            f"root {t['root']}, wall {_fmt_us(t['wall_us'])})"
        )
        print("  critical path:")
        for hop in t["critical_path"]:
            print(
                f"    {hop['name']:<28} {_fmt_us(hop['dur_us']):>10}"
                f"  (self {_fmt_us(hop['self_us'])})"
            )
        print(f"  top-{TOP_WIDEST} widest:")
        for w in t["widest"]:
            print(f"    {w['name']:<28} {_fmt_us(w['dur_us']):>10}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="traceview", description=__doc__.splitlines()[0]
    )
    parser.add_argument(
        "trace", nargs="+",
        help="Chrome trace JSON (--trace-out output); several with --stitch",
    )
    parser.add_argument("--trace-id", default=None, help="summarize one trace only")
    parser.add_argument("--json", action="store_true", help="machine-readable output")
    parser.add_argument(
        "--stitch", action="store_true",
        help="merge multiple per-process captures (router first, then "
        "shards) into one coherent trace before summarizing",
    )
    parser.add_argument(
        "--out", default=None, metavar="PATH",
        help="with --stitch: also write the merged trace-event JSON here",
    )
    add_device_flag(parser)
    args = parser.parse_args(argv)
    backend_for(args.device)

    if args.stitch:
        events = stitch([load_events(p) for p in args.trace])
        if args.out:
            with open(args.out, "w") as fh:
                json.dump({"traceEvents": events}, fh)
    elif len(args.trace) > 1:
        parser.error("multiple trace files need --stitch")
        return 2
    else:
        events = load_events(args.trace[0])

    summary = summarize(events, trace_id=args.trace_id)
    if args.json:
        print(json.dumps(summary))
    else:
        _print_human(summary)
    return 0


if __name__ == "__main__":
    sys.exit(main())
