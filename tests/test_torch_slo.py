"""The port's SLO burn-rate watchdog (`obs/slo.py`) against the JAX package's.

Both watchdogs read their own `Metrics` and run under one injected clock;
every step of a scenario ticks the same counters and histogram samples
into both, advances the clock, samples, and compares the two rendered
``status()`` blocks and the counters the watchdog keeps (``slo.*``). The
scenarios are the reference's own grid (`tests/test_slo.py`: ratio,
quantile and zero-tolerance targets, hysteretic recovery, flaps, the
anomaly signatures) plus seeded random walks (numpy) over the stock
targets. The warnings written into the flight ring carry the same
messages. ``/healthz`` of a port daemon built with ``slo=`` carries the
same ``slo`` block as the reference daemon's, and ``cli serve --slo on``
builds the same watchdog as the reference CLI.
"""

import argparse
import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

from ipc_proofs_tpu.obs import flight as ref_flight  # noqa: E402
from ipc_proofs_tpu.obs import slo as ref_slo  # noqa: E402
from ipc_proofs_tpu.utils.metrics import Metrics as RefMetrics  # noqa: E402
from ipc_proofs_tpu_torch.obs import flight as port_flight  # noqa: E402
from ipc_proofs_tpu_torch.obs import slo as port_slo  # noqa: E402
from ipc_proofs_tpu_torch.utils.metrics import Metrics  # noqa: E402

from _torch_http import get, shutdown, strip  # noqa: E402

AVAILABILITY = dict(
    name="availability",
    kind="ratio",
    objective=0.999,
    bad=("serve.rejected_full.*",),
    total=("serve.accepted.*", "serve.rejected_full.*"),
)


class _Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


@pytest.fixture(autouse=True)
def _clean_flight_rings():
    for mod in (port_flight, ref_flight):
        mod.get_flight_recorder().clear()
    yield
    for mod in (port_flight, ref_flight):
        mod.get_flight_recorder().clear()


def _pair(targets=None, **kw):
    """(port watchdog, its metrics), (reference watchdog, its metrics) on
    one shared clock."""
    clock = _Clock()
    kw.setdefault("fast_window_s", 300.0)
    kw.setdefault("slow_window_s", 3600.0)
    kw.setdefault("recovery_samples", 3)
    out = []
    for mod, metrics_cls in ((port_slo, Metrics), (ref_slo, RefMetrics)):
        m = metrics_cls()
        tgts = None if targets is None else [mod.SloTarget(**t) for t in targets]
        out.append((mod.SloWatchdog(metrics=m, targets=tgts, clock=clock, **kw), m))
    return clock, out


def _run(steps, targets=None, **kw):
    """Drive both watchdogs through ``steps``: each is (dt, counts,
    observations); returns the per-step statuses of both."""
    clock, dogs = _pair(targets, **kw)
    seen = ([], [])
    for dt, counts, observations in steps:
        clock.t += dt
        for side, (dog, m) in enumerate(dogs):
            for name, n in counts.items():
                m.count(name, n)
            for name, values in observations.items():
                for v in values:
                    m.observe(name, v)
            seen[side].append(dog.sample())
    return seen, dogs


def _slo_counters(m):
    return {k: v for k, v in m.snapshot()["counters"].items() if k.startswith("slo.")}


def _assert_same(seen, dogs):
    port, ref = seen
    assert port == ref
    assert _slo_counters(dogs[0][1]) == _slo_counters(dogs[1][1])
    assert dogs[0][0].status() == dogs[1][0].status()
    # each package's log handler may copy a warning into the ring once more
    msgs = [
        list(dict.fromkeys(
            e["msg"] for e in mod.get_flight_recorder().snapshot()["logs"]
            if "SLO" in e["msg"] or "anomaly" in e["msg"]
        ))
        for mod in (port_flight, ref_flight)
    ]
    assert msgs[0] == msgs[1]


def _ok(n):
    return {"serve.accepted.verify": n}


def _bad(good, bad):
    return {"serve.accepted.verify": good, "serve.rejected_full.verify": bad}


# the reference's burn grid (tests/test_slo.py), as step lists
SCENARIOS = {
    "all-good": ([(10, _ok(100), {})] * 5, [AVAILABILITY], {}),
    "moderate-errors-warn": ([(0, {}, {}), (10, _bad(995, 5), {})], [AVAILABILITY], {}),
    "sharp-errors-burn": ([(0, {}, {}), (10, _bad(950, 50), {})], [AVAILABILITY], {}),
    "single-sample": ([(0, {"serve.rejected_full.verify": 1000}, {})], [AVAILABILITY], {}),
    "hysteretic-recovery": (
        [(0, {}, {}), (10, _bad(950, 50), {})] + [(40, _ok(100), {})] * 3,
        [AVAILABILITY], {"fast_window_s": 30.0, "slow_window_s": 60.0},
    ),
    "flap-resets-streak": (
        [(0, {}, {}), (10, _bad(950, 50), {})] + [(40, _ok(100), {})] * 2
        + [(10, _bad(950, 50), {})] + [(40, _ok(100), {})] * 4,
        [AVAILABILITY], {"fast_window_s": 30.0, "slow_window_s": 60.0},
    ),
    "p99-breach-warns": (
        [(0, {}, {}), (10, {}, {"serve.latency_ms.generate": [10.0] * 95 + [5000.0] * 5})],
        [dict(name="generate_p99", kind="quantile", objective=0.99, hist="serve.latency_ms.generate",
              quantile="p99", limit_ms=2000.0)], {},
    ),
    "median-breach-burns": (
        [(0, {}, {}), (10, {}, {"serve.latency_ms.generate": [5000.0] * 60 + [10.0] * 40})],
        [dict(name="generate_p99", kind="quantile", objective=0.99, hist="serve.latency_ms.generate",
              quantile="p99", limit_ms=2000.0)], {},
    ),
    "quantile-needs-new-observations": (
        [(0, {}, {"serve.latency_ms.generate": [5000.0] * 10}), (10, {}, {}), (10, {}, {})],
        [dict(name="generate_p99", kind="quantile", objective=0.99, hist="serve.latency_ms.generate",
              quantile="p99", limit_ms=2000.0)], {},
    ),
    "integrity-first-tick-burns": (
        [(0, {}, {}), (10, {"rpc.integrity_failures": 1}, {})],
        [dict(name="integrity", kind="zero", bad=("rpc.integrity_failures", "storex.integrity_evictions"))], {},
    ),
    "integrity-recovers-after-window": (
        [(0, {}, {}), (10, {"storex.integrity_evictions": 1}, {})] + [(20, {}, {})] * 5,
        [dict(name="integrity", kind="zero", bad=("rpc.integrity_failures", "storex.integrity_evictions"))],
        {"fast_window_s": 30.0, "slow_window_s": 60.0},
    ),
    "breaker-flap-storm": (
        [(0, {}, {}), (10, {"failover.breaker_open": 6}, {}), (10, {"failover.breaker_open": 1}, {})],
        None, {},
    ),
    "anomaly-clears-when-window-drains": (
        [(0, {}, {}), (10, {"failover.breaker_open": 6}, {}), (400, {}, {}), (10, {}, {})],
        None, {},
    ),
    "speculation-waste-needs-volume": (
        [(0, {}, {}), (10, {"fetch.speculative_wants": 10, "fetch.speculative_wasted": 9}, {}),
         (10, {"fetch.speculative_wants": 30, "fetch.speculative_wasted": 25}, {})],
        None, {},
    ),
    "eviction-degraded-registry": (
        [(0, {}, {}), (10, {"storex.evictions": 60, "storex.shared_evictions": 50,
                            "degraded.entered": 1, "registry.append_failures": 2}, {})],
        None, {},
    ),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_burn_grid_matches_the_reference(name):
    steps, targets, kw = SCENARIOS[name]
    seen, dogs = _run(steps, targets, **kw)
    _assert_same(seen, dogs)


def _random_walk(seed, n_steps=40):
    rng = np.random.default_rng(seed)
    steps = []
    for _ in range(n_steps):
        counts = {
            "serve.accepted.verify": int(rng.integers(0, 400)),
            "serve.accepted.generate": int(rng.integers(0, 50)),
            "serve.rejected_full.verify": int(rng.integers(0, 3)) * int(rng.integers(0, 20)),
            "rpc.failures": int(rng.random() < 0.1),
            "cluster.requests": int(rng.integers(0, 10)),
            "rpc.integrity_failures": int(rng.random() < 0.05),
            "failover.breaker_open": int(rng.integers(0, 3)),
            "fetch.speculative_wants": int(rng.integers(0, 30)),
            "fetch.speculative_wasted": int(rng.integers(0, 20)),
        }
        obs = {
            "serve.latency_ms.generate": [float(x) for x in rng.gamma(2.0, 400.0, int(rng.integers(0, 30)))],
            "subs.delivery_lag_ms": [float(x) for x in rng.gamma(2.0, 1500.0, int(rng.integers(0, 10)))],
        }
        steps.append((float(rng.integers(1, 120)), counts, obs))
    return steps


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_stock_targets_random_walk_match_the_reference(seed):
    """Seeded walks over the stock table (`default_targets`): every
    sample's block, every transition counter and flight message equal."""
    seen, dogs = _run(_random_walk(seed), None, fast_window_s=120.0, slow_window_s=900.0, recovery_samples=2)
    _assert_same(seen, dogs)


def test_default_targets_match_the_reference():
    kw = dict(availability=0.995, generate_p99_ms=1234.0, delivery_lag_p99_ms=987.0)
    port = [dataclasses.asdict(t) for t in port_slo.default_targets(**kw)]
    ref = [dataclasses.asdict(t) for t in ref_slo.default_targets(**kw)]
    assert port == ref
    assert [dataclasses.asdict(t) for t in port_slo.default_targets()] == [
        dataclasses.asdict(t) for t in ref_slo.default_targets()
    ]


def test_daemon_thread_samples_and_stops():
    m = Metrics()
    dog = port_slo.SloWatchdog(metrics=m, interval_s=0.01)
    dog.start()
    dog.start()  # idempotent
    import time

    deadline = time.monotonic() + 10
    while m.counter_value("slo.evaluations") < 3 and time.monotonic() < deadline:
        time.sleep(0.01)
    dog.stop()
    n = m.counter_value("slo.evaluations")
    assert n >= 3
    time.sleep(0.05)
    assert m.counter_value("slo.evaluations") == n  # stopped for good
    assert dog.status()["status"] == "ok"


def test_healthz_carries_the_same_slo_block():
    """A daemon built with ``slo=``: its ``/healthz`` carries the
    watchdog's block, the reference daemon's for the same samples."""
    from ipc_proofs_tpu.serve.httpd import ProofHTTPServer as RefHTTPServer
    from ipc_proofs_tpu.serve.service import ProofService as RefProofService
    from ipc_proofs_tpu_torch.serve import ProofHTTPServer, ProofService, ServiceConfig

    clock = _Clock()
    daemons = []
    try:
        for svc, server, mod in (
            (ProofService(config=ServiceConfig(device="cpu")), ProofHTTPServer, port_slo),
            (RefProofService(), RefHTTPServer, ref_slo),
        ):
            dog = mod.SloWatchdog(metrics=svc.metrics, clock=clock)
            dog.sample(1000.0)
            svc.metrics.count("rpc.integrity_failures", 1)
            dog.sample(1010.0)
            daemons.append(server(svc, slo=dog).start())
        (ps, _, ph), (rs, _, rh) = (get(d.port, "/healthz") for d in daemons)
        assert ps == rs == 200
        assert ph["slo"] == rh["slo"]
        assert ph["slo"]["status"] == "burning"
        assert strip(ph).keys() == strip(rh).keys()
    finally:
        shutdown(*daemons)


def test_cli_builds_the_reference_watchdog():
    from ipc_proofs_tpu import cli as ref_cli
    from ipc_proofs_tpu_torch import cli as port_cli

    args = argparse.Namespace(
        slo_availability=0.99, slo_generate_p99_ms=1500.0, slo_delivery_lag_p99_ms=2500.0,
        slo_fast_window_s=60.0, slo_slow_window_s=600.0, slo_interval_s=2.5,
    )
    port = port_cli._build_slo_watchdog(args, Metrics())
    ref = ref_cli._build_slo_watchdog(args, RefMetrics())
    for attr in ("fast_window_s", "slow_window_s", "interval_s", "burn_warn", "burn_page", "recovery_samples"):
        assert getattr(port, attr) == getattr(ref, attr), attr
    assert [dataclasses.asdict(t) for t in port.targets] == [dataclasses.asdict(t) for t in ref.targets]
