"""Shard workers: a full serve daemon per shard, in-process or spawned.

The counterpart of ``ipc_proofs_tpu.cluster.shard``. A shard is not a
thinner thing than a daemon — it IS `ProofService` + `ProofHTTPServer`
(+ `DurableAdmission` when given a queue dir), so everything the
single-daemon stack guarantees (micro-batching, bounded admission,
crash-recovery via the durable queue, the tiered disk store) survives
sharding unchanged. Every shard runs its kernels on its service's one
`GpuBackend`: the card unless its ``ServiceConfig(device="cpu")`` (or a
child's ``--backend cpu``) asks for the plain versions. The router treats
a shard as an opaque HTTP base URL; these classes only manage lifecycle.

Two flavors:

- `LocalShard` — in-process, for tests and the scatter-gather identity
  grid: same pair table object, ephemeral port, and a ``kill()`` that
  abandons in-flight work (`ProofHTTPServer.abort`) to simulate a shard
  crash without tearing down the test process. In-process shards on the
  card share one cached backend (`backend.get_backend`) and the
  process-wide launch counters.
- `SubprocessShard` (via `spawn_serve_shard`) — a real
  ``python -m ipc_proofs_tpu_torch.cli serve`` child process, which is
  what the cluster CLI uses: separate GILs, separate crash domains. The
  child writes its bound port to ``--port-file`` (ephemeral ports can't be
  known up front) and each child gets its own ``--store-owner`` token so N
  children can share one ``--store-dir``. One departure from the
  reference, diagnostics only: the child's stderr goes to a log file
  beside its port file (`SubprocessShard.log_path`) instead of nowhere, so
  a child that dies before binding (CUDA init, a kernel build) names its
  cause, and the daemon's ``kernel launches:`` lines — the only reading
  of a child's launches — survive it.

Shards must agree on the pair table (the router speaks pair indexes).
`fixtures.build_range_world` is fully deterministic, so every child
spawned with the same ``--demo-world`` arguments rebuilds the identical
world and table — no table-shipping protocol needed for the hermetic
modes this repo serves.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
import urllib.error
import urllib.request
from typing import Optional, Sequence

from ipc_proofs_tpu_torch.serve.durable import DurableAdmission
from ipc_proofs_tpu_torch.serve.httpd import ProofHTTPServer
from ipc_proofs_tpu_torch.serve.service import ProofService, ServiceConfig
from ipc_proofs_tpu_torch.utils.log import get_logger

__all__ = ["LocalShard", "RemoteShard", "SubprocessShard", "spawn_serve_shard"]

logger = get_logger(__name__)


class LocalShard:
    """One in-process shard daemon (service + HTTP front end).

    ``store_wrapper`` wraps the blockstore before the service sees it —
    the hook the fault-harness tests use to inject seeded RPC faults into
    exactly one shard of a scatter.
    """

    def __init__(
        self,
        name: str,
        store,
        pairs: Sequence,
        spec,
        config: Optional[ServiceConfig] = None,
        queue_dir: Optional[str] = None,
        metrics=None,
        trust_policy=None,
        event_filter=None,
        store_wrapper=None,
        subs=None,
        backfill_jobs_dir=None,
        backfill_window_size: int = 8,
    ):
        self.name = name
        self.pairs = list(pairs)
        if store_wrapper is not None:
            store = store_wrapper(store)
        self.service = ProofService(
            store=store,
            spec=spec,
            trust_policy=trust_policy,
            event_filter=event_filter,
            config=config,
            metrics=metrics,
        )
        self.durable = (
            DurableAdmission(
                self.service, queue_dir, pairs=self.pairs,
                metrics=self.service.metrics,
            )
            if queue_dir
            else None
        )
        self.subs = subs  # StandingQueries, when the shard serves streams
        self.backfill = None
        if backfill_jobs_dir:
            # mirrors the serve daemon: windows enter the generate
            # batcher's LOW lane, so backfill yields to interactive work
            from ipc_proofs_tpu_torch.backfill import BackfillEngine

            service = self.service

            def _run_window(window, wpairs):
                return service.submit_range_window(wpairs).result()

            self.backfill = BackfillEngine(
                self.pairs,
                spec,
                _run_window,
                jobs_dir=backfill_jobs_dir,
                window_size=backfill_window_size,
                metrics=self.service.metrics,
                delivery=(subs.log if subs is not None else None),
            )
        self.httpd = ProofHTTPServer(
            self.service, port=0, pairs=self.pairs, durable=self.durable,
            subs=subs, backfill=self.backfill,
        )

    def start(self) -> "LocalShard":
        self.httpd.start()
        return self

    @property
    def url(self) -> str:
        return self.httpd.address

    def stop(self, timeout: Optional[float] = 10.0) -> None:
        """Graceful: drain accepted work, then release everything."""
        self.httpd.shutdown(timeout=timeout)

    def kill(self) -> None:
        """Crash simulation: the port goes connection-refused with work
        possibly still in flight; the service is NOT drained."""
        self.httpd.abort()

    def __enter__(self) -> "LocalShard":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


class RemoteShard:
    """Handle to a serve daemon SOMEONE ELSE runs (``--shard-url``).

    The multi-host member: the router did not spawn it and must not kill
    it, so lifecycle is reduced to health probing — ``stop()``/``kill()``
    only mark the handle dead locally (the same drain contract shape as
    the owned flavors, minus the process control). ``probe()`` is the
    liveness check the cluster CLI runs before admitting the member and
    the router's health loop repeats; a member that stops answering is
    failed over exactly like a dead subprocess (the router only ever sees
    the URL go connection-refused either way).
    """

    def __init__(self, url: str, name: Optional[str] = None, timeout_s: float = 5.0):
        self.url = url.rstrip("/")
        # default name = host:port — stable across router restarts, so
        # ring arcs (and seg-<owner> tokens keyed on the name) survive
        self.name = name or self.url.split("//", 1)[-1].replace("/", "_")
        self.timeout_s = timeout_s
        self._stopped = False

    def probe(self) -> "Optional[dict]":
        """One ``GET /healthz``: the parsed body (status 200 or 503 —
        draining still answers), or None when the host is unreachable."""
        try:
            with urllib.request.urlopen(
                self.url + "/healthz", timeout=self.timeout_s
            ) as resp:
                return json.loads(resp.read().decode("utf-8"))
        except urllib.error.HTTPError as exc:
            try:
                return json.loads(exc.read().decode("utf-8"))
            except ValueError:
                return {"status": f"http {exc.code}"}
        except (urllib.error.URLError, ConnectionError, TimeoutError, OSError, ValueError):
            return None

    @property
    def alive(self) -> bool:
        return not self._stopped

    def stop(self, timeout: Optional[float] = None) -> None:
        """Drop the handle — never the remote daemon (its own operator
        drains it). Matches the owned shards' drain contract shape."""
        self._stopped = True

    def kill(self) -> None:
        self._stopped = True


class SubprocessShard:
    """Handle to one spawned ``serve`` child process; ``log_path`` is the
    file its stderr goes to."""

    def __init__(
        self,
        name: str,
        proc: subprocess.Popen,
        url: str,
        log_path: Optional[str] = None,
    ):
        self.name = name
        self.proc = proc
        self.url = url
        self.log_path = log_path

    @property
    def alive(self) -> bool:
        return self.proc.poll() is None

    def stop(self, timeout_s: float = 15.0) -> None:
        """Graceful: SIGTERM (the serve CLI drains on it), then wait."""
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=timeout_s)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=5.0)

    def kill(self) -> None:
        """Crash simulation: SIGKILL, no drain, no journal flush."""
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=5.0)


def spawn_serve_shard(
    name: str,
    demo_world: int,
    event_sig: str,
    topic1: str,
    store_dir: Optional[str] = None,
    queue_dir: Optional[str] = None,
    extra_args: Sequence[str] = (),
    startup_timeout_s: float = 60.0,
) -> SubprocessShard:
    """Spawn one ``serve`` child on an ephemeral port and wait for it.

    The child rebuilds the deterministic ``--demo-world`` (identical pair
    table in every shard) and reports its bound port through a temp
    ``--port-file``. With ``store_dir`` set the child joins the shared
    disk tier under its own ``--store-owner`` token (= ``name``). It runs
    its kernels on the card unless ``extra_args`` carries ``--backend
    cpu``; its stderr goes to ``<port file stem>.log`` (kept after start,
    see the module docstring), whose tail a start-up failure quotes.
    """
    fd, port_file = tempfile.mkstemp(prefix=f"shard-{name}-", suffix=".port")
    os.close(fd)
    os.remove(port_file)  # the child's atomic write recreates it
    log_path = port_file[: -len(".port")] + ".log"
    cmd = [
        sys.executable,
        "-m",
        "ipc_proofs_tpu_torch.cli",
        "serve",
        "--port",
        "0",
        "--port-file",
        port_file,
        "--demo-world",
        str(demo_world),
        "--event-sig",
        event_sig,
        "--topic1",
        topic1,
    ]
    if store_dir:
        cmd += ["--store-dir", store_dir, "--store-owner", name]
    if queue_dir:
        cmd += ["--queue-dir", queue_dir]
    cmd += list(extra_args)
    with open(log_path, "wb") as log_fh:
        proc = subprocess.Popen(
            cmd,
            stdout=subprocess.DEVNULL,
            stderr=log_fh,
            start_new_session=True,  # a router SIGINT must not strafe the shards
        )
    deadline = time.monotonic() + startup_timeout_s
    port = None
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            raise RuntimeError(
                f"shard {name!r} exited with {proc.returncode} before binding; "
                f"the end of its stderr ({log_path}):\n{_tail(log_path)}"
            )
        try:
            with open(port_file) as fh:
                text = fh.read().strip()
            if text:
                port = int(text)
                break
        except (OSError, ValueError):
            pass
        time.sleep(0.05)
    if port is None:
        proc.kill()
        proc.wait(timeout=5.0)
        raise RuntimeError(
            f"shard {name!r} did not report a port within {startup_timeout_s}s; "
            f"the end of its stderr ({log_path}):\n{_tail(log_path)}"
        )
    try:
        os.remove(port_file)
    except OSError:
        pass
    return SubprocessShard(name, proc, f"http://127.0.0.1:{port}", log_path)


def _tail(path: str, max_bytes: int = 4096) -> str:
    """The last ``max_bytes`` of a child's log, decoded leniently."""
    try:
        with open(path, "rb") as fh:
            fh.seek(max(0, os.path.getsize(path) - max_bytes))
            return fh.read().decode("utf-8", "replace")
    except OSError as exc:
        return f"(unreadable: {exc})"
