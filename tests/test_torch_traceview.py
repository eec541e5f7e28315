"""`ipc_proofs_tpu_torch.tools.traceview` against the reference's
``tools/traceview.py``: the same files in, the same bytes out.

- A trace written by each package's span collector (`write_chrome_trace`)
  summarizes to the same ``--json`` document (stage totals, top-5 widest
  spans, critical paths) and the same human text in both tools, whole and
  filtered by ``--trace-id``.
- ``--stitch`` of a router capture and two shard captures (each package's
  own carrier hop, and seeded captures whose process-local span ids
  collide) writes byte-equal ``--out`` files and summaries.
- Without CUDA the tool exits non-zero unless given ``--device cpu``.
"""

import json
import random
import subprocess
import sys
import time
from pathlib import Path

import pytest

pytest.importorskip("jax")

import tools.traceview as ref_tv  # noqa: E402
from ipc_proofs_tpu import obs as ref_obs  # noqa: E402
from ipc_proofs_tpu.obs import trace as ref_trace  # noqa: E402
from ipc_proofs_tpu.utils.metrics import Metrics as RefMetrics  # noqa: E402
from ipc_proofs_tpu_torch import obs  # noqa: E402
from ipc_proofs_tpu_torch.obs import trace as port_trace  # noqa: E402
from ipc_proofs_tpu_torch.tools import traceview  # noqa: E402
from ipc_proofs_tpu_torch.utils.metrics import Metrics  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _run(main, argv, capsys) -> "tuple[int, str]":
    rc = main(argv)
    return rc, capsys.readouterr().out


def _both(argv, capsys) -> str:
    ref_rc, ref_out = _run(ref_tv.main, argv, capsys)
    rc, out = _run(traceview.main, argv + ["--device", "cpu"], capsys)
    assert (rc, out) == (ref_rc, ref_out)
    return out


class _StepClock:
    """The span collectors' clock in `_record`: ``perf_counter_ns`` moves
    one microsecond a read, and ``sleep`` moves it by the time asked for
    without waiting, so every span's duration is fixed whatever the load
    on the host. Every other attribute is the real ``time`` module's."""

    def __init__(self):
        self.now_ns = 0

    def perf_counter_ns(self) -> int:
        self.now_ns += 1_000
        return self.now_ns

    def sleep(self, seconds: float) -> None:
        self.now_ns += int(seconds * 1e9)

    def __getattr__(self, name):
        return getattr(time, name)


def _record(pkg, metrics_cls, path: Path, clock: _StepClock) -> None:
    """Two requests through ``pkg``'s span collector, nested three deep with
    siblings, written as Chrome trace-event JSON. The spans' durations come
    from ``clock``: ``stage_b`` takes 2 ms, each ``stage_c`` 0.5 ms."""
    collector = pkg.enable_tracing(metrics=metrics_cls())
    try:
        for req in range(2):
            with pkg.root_span(f"req{req}"):
                with pkg.span("stage_a"):
                    with pkg.span("stage_b"):
                        clock.sleep(0.002)
                    with pkg.span("stage_b2"):
                        pass
                for _ in range(6):
                    with pkg.span("stage_c"):
                        clock.sleep(0.0005)
        pkg.write_chrome_trace(str(path), collector.snapshot())
    finally:
        pkg.disable_tracing()


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_summary_matches_the_reference_tool(writer, tmp_path, capsys, monkeypatch):
    path = tmp_path / "t.json"
    clock = _StepClock()
    for trace_module in (ref_trace, port_trace):
        monkeypatch.setattr(trace_module, "time", clock)
    if writer == "reference":
        _record(ref_obs, RefMetrics, path, clock)
    else:
        _record(obs, Metrics, path, clock)
    summary = json.loads(_both([str(path), "--json"], capsys))
    assert summary["n_traces"] == 2
    for trace in summary["traces"]:
        assert [h["name"] for h in trace["critical_path"]][:3] == [trace["root"], "stage_a", "stage_b"]
        assert len(trace["widest"]) == traceview.TOP_WIDEST
    _both([str(path)], capsys)
    tid = summary["traces"][1]["trace_id"]
    one = json.loads(_both([str(path), "--json", "--trace-id", tid], capsys))
    assert [t["trace_id"] for t in one["traces"]] == [tid]
    assert traceview.summarize(traceview.load_events(str(path))) == ref_tv.summarize(
        ref_tv.load_events(str(path))
    )


def _carrier_captures(pkg, metrics_cls, tmp_path: Path, tag: str) -> "list[str]":
    """A router capture whose scatter hands a carrier to two shard captures
    (each shard adopts the router's dispatch span as its wire parent)."""
    paths = []
    collector = pkg.enable_tracing(metrics=metrics_cls())
    carriers = []
    try:
        with pkg.root_span("cluster.generate_range"):
            for _ in range(2):
                with pkg.span("cluster.dispatch"):
                    carriers.append(pkg.carrier_from_context())
                    time.sleep(0.001)
        router = collector.snapshot()
    finally:
        pkg.disable_tracing()
    captures = [router]
    for carrier in carriers:
        collector = pkg.enable_tracing(metrics=metrics_cls())
        try:
            with pkg.adopted_span("http.generate_range", carrier):
                with pkg.span("serve.generate_range"):
                    time.sleep(0.0005)
            captures.append(collector.snapshot())
        finally:
            pkg.disable_tracing()
    for i, spans in enumerate(captures):
        p = tmp_path / f"{tag}{i}.json"
        pkg.write_chrome_trace(str(p), spans)
        paths.append(str(p))
    return paths


def _colliding_captures(seed: int, tmp_path: Path) -> "list[str]":
    """Seeded router + 2 shard captures whose span ids are process-local
    counters from 1 (they collide), several traces, random widths; each
    shard's request span names the router span it adopted."""
    rng = random.Random(seed)
    files = [[], [], []]
    for t in range(3):
        tid = f"{rng.getrandbits(64):016x}"
        files[0].append({"ph": "X", "name": "cluster.generate_range", "cat": "span", "ts": 100 * t,
                         "dur": rng.randrange(500, 2000), "args": {"trace_id": tid, "span_id": "1",
                                                                   "parent_id": None}})
        for s in (1, 2):
            files[0].append({"ph": "X", "name": "cluster.dispatch", "cat": "span", "ts": 100 * t + s,
                             "dur": rng.randrange(100, 500),
                             "args": {"trace_id": tid, "span_id": str(s + 1), "parent_id": "1"}})
            adopted = rng.choice(["1", str(s + 1)])
            shard = files[s]
            shard.append({"ph": "X", "name": "http.generate_range", "cat": "span", "ts": 100 * t + 5,
                          "dur": rng.randrange(50, 400),
                          "args": {"trace_id": tid, "span_id": "1", "parent_id": adopted}})
            for k in range(rng.randrange(1, 4)):
                shard.append({"ph": "X", "name": f"serve.stage{k}", "cat": "span", "ts": 100 * t + 6 + k,
                              "dur": rng.randrange(10, 200),
                              "args": {"trace_id": tid, "span_id": str(k + 2), "parent_id": "1"}})
    paths = []
    for i, events in enumerate(files):
        p = tmp_path / f"cap{seed}-{i}.json"
        p.write_text(json.dumps({"traceEvents": events}))
        paths.append(str(p))
    return paths


@pytest.mark.parametrize("case", ["reference-carrier", "port-carrier", "colliding-7", "colliding-2026"])
def test_stitch_is_byte_equal_between_packages(case, tmp_path, capsys):
    if case == "reference-carrier":
        paths = _carrier_captures(ref_obs, RefMetrics, tmp_path, "r")
    elif case == "port-carrier":
        paths = _carrier_captures(obs, Metrics, tmp_path, "p")
    else:
        paths = _colliding_captures(int(case.split("-")[1]), tmp_path)
    ref_out, out = tmp_path / "ref-merged.json", tmp_path / "merged.json"
    ref_rc, ref_text = _run(ref_tv.main, ["--stitch", *paths, "--out", str(ref_out), "--json"], capsys)
    rc, text = _run(traceview.main, ["--stitch", *paths, "--out", str(out), "--json", "--device", "cpu"], capsys)
    assert (rc, text) == (ref_rc, ref_text) == (0, text)
    assert out.read_bytes() == ref_out.read_bytes()
    merged = json.loads(out.read_bytes())["traceEvents"]
    ids = {(e["args"]["trace_id"], e["args"]["span_id"]) for e in merged}
    orphans = [e for e in merged if e["args"]["parent_id"]  # a root's is None or ""
               and (e["args"]["trace_id"], e["args"]["parent_id"]) not in ids]
    assert not orphans
    summary = json.loads(text)
    assert all(t["root"] == "cluster.generate_range" for t in summary["traces"])


def test_several_files_need_stitch(tmp_path, capsys):
    paths = _colliding_captures(1, tmp_path)[:2]
    for main, extra in ((ref_tv.main, []), (traceview.main, ["--device", "cpu"])):
        with pytest.raises(SystemExit) as exc:
            main(paths + extra)
        assert exc.value.code == 2
    capsys.readouterr()


def test_module_exits_nonzero_without_cuda(tmp_path):
    path = _colliding_captures(3, tmp_path)[0]
    run = [sys.executable, "-m", "ipc_proofs_tpu_torch.tools.traceview", path, "--json"]
    refused = subprocess.run(run, cwd=ROOT, capture_output=True, text=True, timeout=60,
                             env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert refused.returncode != 0 and not refused.stdout
    assert "--device cuda" in refused.stderr
    ran = subprocess.run(run + ["--device", "cpu"], cwd=ROOT, capture_output=True, text=True, timeout=60)
    assert ran.returncode == 0, ran.stderr
    assert json.loads(ran.stdout)["n_traces"] == 3
