"""JSON-over-HTTP front end for `ProofService` (stdlib `http.server` only).

The counterpart of ``ipc_proofs_tpu.serve.httpd``, route for route: the
same status codes, bodies, headers and IPBS stream bytes for the same
requests, with the proof work underneath on the card (the service's one
`GpuBackend`). One departure, by design: a fault of the card
(`ops.build.is_device_fault`) is the server's failure, answered 500 with
``error_type: device``, never the 400 the
reference gives every `RuntimeError`; in a stream already under way it ends
in the in-band abort chunk with the same type. Nothing falls back to the
host. The listener's accept backlog is 128 connections (the stdlib
default of 5 resets clients that connect together, as a closed loop of 32
does).

A deliberately thin shim: every serving decision — batching, admission,
deadlines, drain — lives in `serve/service.py`; this module only maps HTTP
to the in-process API and serving errors to status codes:

- ``POST /v1/verify``  → `QueueFullError` ⇒ 503 + ``Retry-After``,
  `ServiceClosedError` ⇒ 503 (draining), `DeadlineExceededError` ⇒ 504,
  malformed bundle ⇒ 400, a device fault ⇒ 500.
- ``POST /v1/generate`` → same mapping; the request names a tipset pair by
  index into the server's configured pair table (the hermetic/demo mode —
  a production deployment would resolve pairs from its chain store).
- ``POST /v1/generate_range`` → multi-pair canonical range bundle for an
  explicit ``pair_indexes`` list — the scatter-gather sub-request the
  cluster router dispatches (see `cluster/router.py`). With
  ``"aggregate": true`` the index list may repeat (K co-tipset claims):
  ONE canonical bundle over the distinct pairs comes back with a
  ``claims`` span table (`witness/`). A ``trace``
  carrier in any POST body parents this request's spans under the remote
  caller's span (`obs.adopted_span`).

Witness negotiation (README "Witness diet"): generate bodies may carry
``witness_encoding`` (or an ``Accept-Witness-Encoding`` header) and
``base_digest`` (or ``If-Witness-Base``); the chosen encoding is echoed
in the ``witness_encoding`` field AND a ``Witness-Encoding`` header, an
unknown encoding is a typed 400 (``error_type: witness_encoding``), and
an unknown delta base falls back to a full bundle
(``witness.delta_fallbacks``). ``POST /v1/verify`` accepts plain or
``blocks_frame``-compressed bundles plus an optional ``claims`` table for
per-claim verdicts out of one shared replay.

Streaming wire (README "Streaming wire & tenant QoS"): generate bodies
may carry ``"stream": true`` (or ``Accept:
application/x-ipc-bundle-stream``) to receive the chunked binary IPBS
stream (`witness/stream.py`) instead of a buffered JSON body — on a
disk-warm daemon the block section is ``memoryview`` slices straight out
of `SegmentStore` segments, handed to ``socket.sendmsg`` without copying
through Python. ``GET /v1/backfill/<id>/chunks`` under the same Accept
header streams one document per result chunk. Per-tenant QoS
(``--tenant-rate`` / ``--tenant-burst``) throttles at admission with a
typed 429 + ``Retry-After`` (`serve/qos.py`); response bytes charge the
tenant ledger at send time, streamed chunks included.
- ``GET /metrics``  → `utils/metrics.py` snapshot (stage timers, queue
  depths, batch sizes, p50/p90/p99 latency, rejection counters) as JSON.
- ``GET /metrics.prom`` → the same snapshot in Prometheus text exposition
  format (`obs/prom.py`) for a stock Prometheus scraper.
- ``GET /debug/flight`` → the always-on flight recorder: last N completed
  spans + recent WARN/ERROR log records (`obs/flight.py`).
- ``GET /healthz``  → ``{"status": "ok" | "degraded" | "draining"}``; with
  an `EndpointPool` attached, ``"degraded"`` means some endpoint's circuit
  breaker is open/half-open and the body carries per-endpoint breaker
  state (still HTTP 200 — the service itself serves from what remains;
  draining stays 503). With a follower attached the body carries
  ``last_finalized_epoch``; with standing queries, subscription/delivery
  gauges; with ``slo=``, the watchdog's ``slo`` block.
- ``POST /v1/subscribe`` / ``POST /v1/unsubscribe`` /
  ``GET /v1/subscriptions`` / ``GET /v1/deliveries?sub=<id>&cursor=<n>``
  → the standing-query plane (`subs/`), mounted when the server is built
  with ``subs=`` (``serve --subs-dir``). Deliveries is the long-poll
  fallback to webhook push; asking from cursor N acks everything ≤ N.
- ``POST /v1/backfill`` / ``GET /v1/backfill[/<id>[/chunks]]`` → the
  backfill engine (`backfill/`), mounted with ``backfill=``
  (``serve --backfill-jobs-dir``). A job the card's fault stopped
  (``faulted``) answers 500 ``error_type: device``; its chunk stream ends
  in a ``device`` abort chunk. Without ``subs=`` / ``backfill=`` these
  routes answer the reference's 404s.

Every POST opens a trace root span (`obs/trace.py`) on the handler thread
before admission, so batching/execution spans parent into the request's
trace; 200 responses carry ``trace_id`` + ``server_timing`` in the body
and a standards-shaped ``Server-Timing`` header.

With a `DurableAdmission` queue attached (``serve --queue-dir``), POSTs
route through the journal: the request is fsync'd before execution, an
``idempotency_key`` in the body dedupes client retries (the response
carries ``idempotency_key`` and ``cached``), and ``/healthz`` reports
``resumed_jobs`` / ``journal_bytes`` from the queue journal.

`ThreadingHTTPServer` gives one thread per connection; those threads do no
proof work — they block on ``PendingResult.result()`` while the service's
worker pool executes batches, so slow clients never stall batch execution.
"""

from __future__ import annotations

import json
import os
import select
import socket
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Sequence
from urllib.parse import parse_qs, unquote, urlsplit

from ipc_proofs_tpu_torch.obs.fleet import (
    TenantLedger,
    extract_tenant,
    subtree_for_response,
)
from ipc_proofs_tpu_torch.obs.flight import get_flight_recorder
from ipc_proofs_tpu_torch.obs.prom import CONTENT_TYPE as _PROM_CONTENT_TYPE
from ipc_proofs_tpu_torch.obs.prom import render_prometheus
from ipc_proofs_tpu_torch.obs.trace import adopted_span, tracing_enabled
from ipc_proofs_tpu_torch.ops.build import is_device_fault
from ipc_proofs_tpu_torch.proofs.bundle import UnifiedProofBundle
from ipc_proofs_tpu_torch.proofs.range import TipsetPair
from ipc_proofs_tpu_torch.serve.batcher import (
    QueueFullError,
    ServiceClosedError,
)
from ipc_proofs_tpu_torch.serve.qos import (
    AdmitRejectedError,
    GradientLimiter,
    TenantQoS,
    TenantThrottledError,
)
from ipc_proofs_tpu_torch.serve.service import ProofService
from ipc_proofs_tpu_torch.store.failover import DegradedError
from ipc_proofs_tpu_torch.storex import SegmentStoreError
from ipc_proofs_tpu_torch.utils.deadline import (
    CancelledError,
    CancelScope,
    Deadline,
    DeadlineError,
    use_scope,
)
from ipc_proofs_tpu_torch.witness import (
    AggregatedBundle,
    WitnessEncodingError,
    WitnessError,
    aggregate_range_bundle,
    encode_bundle_fields,
    negotiate_witness,
    parse_bundle_obj,
)
from ipc_proofs_tpu_torch.witness.stream import (
    CHUNKED_TERMINATOR,
    STREAM_CONTENT_TYPE,
    BundleStreamWriter,
    negotiate_stream,
    send_buffers,
    stream_backfill_chunks,
    stream_bundle_doc,
)

__all__ = ["ProofHTTPServer"]

_MAX_BODY_BYTES = 64 * 1024 * 1024  # one bundle; far above any sane request
# how often a handler thread blocked on a pending result checks whether the
# client hung up (EOF on the socket) — the window between a disconnect and
# the in-flight work being cancelled
_DISCONNECT_POLL_S = 0.1
# what the standing-query and backfill routes answer on a server built
# without ``subs=`` / ``backfill=`` (the reference's 404 bodies)
_SUBS_DISABLED = {"error": "standing queries disabled"}
_BACKFILL_DISABLED = {"error": "backfill disabled"}


class _Listener(ThreadingHTTPServer):
    # the stdlib's backlog of 5 resets a burst of concurrent connects
    request_queue_size = 128


class _Handler(BaseHTTPRequestHandler):
    # set per server subclass via ProofHTTPServer
    service: ProofService
    pairs: Sequence[TipsetPair]
    durable = None  # Optional[DurableAdmission]
    subs = None  # Optional[subs.StandingQueries]
    slo = None  # Optional[obs.slo.SloWatchdog]
    backfill = None  # Optional[backfill.BackfillEngine]
    tenants = None  # Optional[obs.fleet.TenantLedger]
    qos = None  # Optional[serve.qos.TenantQoS]
    admit = None  # Optional[serve.qos.GradientLimiter] (--admit-gradient)

    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # silence per-request stderr noise
        pass

    # --- plumbing ----------------------------------------------------------

    def _send_json(self, status: int, obj: dict, headers: Optional[dict] = None):
        body = json.dumps(obj).encode("utf-8")
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)
        # response bytes charge the tenant AT SEND TIME (the streamed path
        # does the same with the writer's byte count), so ``tenant.bytes.*``
        # reflects what actually crossed the wire, not just request bodies
        if getattr(self, "_account_response", False) and self.tenants is not None:
            self.tenants.account_bytes(self._tenant, len(body))

    # --- streamed responses (application/x-ipc-bundle-stream) -------------

    def _start_stream(self, encoding: str) -> None:
        """200 + chunked transfer for an IPBS body. No Content-Length (the
        length is unknown until the last shard/window lands) and no
        Server-Timing header — the timing breakdown rides the trailer
        chunk instead, where ``stream_ms`` can be measured."""
        self.send_response(200)
        self.send_header("Content-Type", STREAM_CONTENT_TYPE)
        self.send_header("Transfer-Encoding", "chunked")
        self.send_header("Witness-Encoding", encoding)
        self.end_headers()
        self.wfile.flush()

    def _send_buffers(self, buffers) -> None:
        """One HTTP chunk, scatter-gather, straight to the socket —
        `witness.stream.send_buffers` (memoryview payloads go mmap →
        kernel with no Python-side copy)."""
        send_buffers(self.connection, buffers)

    def _stream_ok(self, stream_fn, encoding: str) -> None:
        """Send one streamed 200. ``stream_fn(writer)`` emits the
        document(s); an exception after the status line is gone becomes a
        typed in-band ``E`` chunk (`StreamAbortError` client-side) — the
        byte-identical-or-typed-error invariant past the point where HTTP
        status codes can carry it."""
        self._start_stream(encoding)
        writer = BundleStreamWriter(
            self._send_buffers, metrics=self.service.metrics
        )
        try:
            stream_fn(writer)
        except (BrokenPipeError, ConnectionResetError):
            self.close_connection = True
            return
        except WitnessError as exc:
            writer.error(str(exc), exc.error_type)
        except Exception as exc:  # fail-soft: headers are already on the wire — the only sound exit is an in-band typed abort chunk, never a half-document
            writer.error(str(exc), "device" if is_device_fault(exc) else "internal")
        # counted before the terminator: a client that has read the whole
        # body sees its response counted (the reference counts after it)
        self.service.metrics.count("serve.stream.responses")
        if getattr(self, "_account_response", False) and self.tenants is not None:
            self.tenants.account_bytes(self._tenant, writer.bytes_sent)
        try:
            self.connection.sendall(CHUNKED_TERMINATOR)
        except OSError:
            pass
        # one stream per connection: don't risk framing drift poisoning a
        # keep-alive successor request
        self.close_connection = True

    def _send_runtime_error(self, exc: RuntimeError) -> None:
        """A `RuntimeError` out of the service: a fault of the card is the
        server's (500, ``error_type: device``); anything else is the
        request's (400, as in the reference)."""
        if is_device_fault(exc):
            self._send_json(500, {"error": str(exc), "error_type": "device"})
        else:
            self._send_json(400, {"error": str(exc)})

    def _send_text(self, status: int, text: str, content_type: str):
        body = text.encode("utf-8")
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    @staticmethod
    def _server_timing_header(timing: dict) -> str:
        """RFC-shaped Server-Timing value: ``queue;dur=1.2, verify;dur=3.4``
        (metric names come from the server_timing dict, ``_ms`` stripped)."""
        parts = []
        for key, value in timing.items():
            name = key[:-3] if key.endswith("_ms") else key
            parts.append(f"{name};dur={value}")
        return ", ".join(parts)

    def _negotiate_witness(self, body: dict):
        """Resolve the request's witness options (encoding, delta base).

        Unknown/disabled encodings are a TYPED 400 (``error_type:
        witness_encoding`` + ``witness.encoding_rejects``), never a silent
        plain response; returns None after sending the error."""
        cfg = self.service.config
        try:
            return negotiate_witness(
                body,
                headers=self.headers,
                allow_compress=cfg.witness_compress,
                allow_delta=cfg.witness_delta,
            )
        except WitnessEncodingError as exc:
            self.service.metrics.count("witness.encoding_rejects")
            self._send_json(400, {"error": str(exc), "error_type": exc.error_type})
            return None

    def _negotiate_stream(self, body: dict) -> Optional[bool]:
        """Resolve whether this response goes out as an IPBS chunk stream
        (body ``"stream"`` wins, else the ``Accept`` header). Returns
        None after sending the typed 400 for a malformed field."""
        try:
            return negotiate_stream(body, headers=self.headers)
        except WitnessEncodingError as exc:
            self.service.metrics.count("witness.encoding_rejects")
            self._send_json(400, {"error": str(exc), "error_type": exc.error_type})
            return None

    def _witness_fields(self, bundle, opts, claims=None) -> dict:
        return encode_bundle_fields(
            bundle,
            opts,
            bases=self.service.witness_bases,
            metrics=self.service.metrics,
            claims=claims,
        )

    def _read_json_body(self) -> dict:
        length = int(self.headers.get("Content-Length", 0))
        if length <= 0 or length > _MAX_BODY_BYTES:
            raise ValueError(f"Content-Length required, 0 < n <= {_MAX_BODY_BYTES}")
        self._body_bytes = length  # tenant byte accounting reads this
        obj = json.loads(self.rfile.read(length))
        if not isinstance(obj, dict):
            raise ValueError("request body must be a JSON object")
        return obj

    # --- routes ------------------------------------------------------------

    def do_GET(self):
        path = urlsplit(self.path).path
        if path in ("/metrics", "/metrics.json"):
            # /metrics.json is the federation scrape surface: the raw
            # snapshot dict the router's fleet view merges per shard
            self._send_json(200, self.service.metrics_snapshot())
        elif path == "/metrics.prom":
            self._send_text(
                200,
                render_prometheus(self.service.metrics.snapshot()),
                _PROM_CONTENT_TYPE,
            )
        elif path == "/debug/flight":
            self._send_json(200, get_flight_recorder().snapshot())
        elif path == "/healthz":
            health = self.service.health()
            if self.durable is not None:
                health.update(self.durable.health_fields())
            if self.subs is not None:
                health.update(self.subs.health_fields())
            epoch = self.service.metrics.snapshot().get("gauges", {}).get(
                "follow.last_finalized_epoch"
            )
            if epoch is not None:
                health["last_finalized_epoch"] = int(epoch)
            if self.slo is not None:
                health["slo"] = self.slo.status()
            # draining = stop routing here (503); degraded = still serving
            # from healthy endpoints, breaker detail in the body (200)
            self._send_json(503 if health["status"] == "draining" else 200, health)
        elif path == "/v1/subscriptions":
            if self.subs is None:
                self._send_json(404, _SUBS_DISABLED)
            else:
                self._send_json(200, self.subs.subscriptions())
        elif path == "/v1/deliveries":
            self._handle_deliveries()
        elif path == "/v1/backfill":
            if self.backfill is None:
                self._send_json(404, _BACKFILL_DISABLED)
            else:
                self._send_json(200, {"jobs": self.backfill.jobs()})
        elif path.startswith("/v1/backfill/"):
            self._handle_backfill_get(path)
        elif path == "/v1/segments":
            self._handle_segments_list()
        elif path.startswith("/v1/segments/"):
            self._handle_segment_get(path)
        elif path.startswith("/v1/blocks/"):
            self._handle_block_get(path)
        elif path.startswith("/v1/registry/"):
            self._handle_registry_get(path)
        else:
            self._send_json(404, {"error": f"no such path: {self.path}"})

    # --- provenance registry -------------------------------------------------

    def _handle_registry_get(self, path: str) -> None:
        """`/v1/registry/{head,entry,proof,consistency,base}`: the audit
        surface. ``head`` publishes the checkpoint (size + tree root +
        chain tip); ``entry?seq=N`` returns one sealed record;
        ``proof?seq=N`` (or ``?digest=<bundle digest>``) an inclusion
        proof against the current root; ``consistency?old_size=N`` the
        proof that the current root extends the size-N checkpoint;
        ``base?fleet=F&key=K`` the fleet directory's newest common acked
        base for a filter key (digest + CID set)."""
        reg = self.service.registry
        if reg is None:
            self._send_json(404, {"error": "registry disabled"})
            return
        q = parse_qs(urlsplit(self.path).query)

        def _int_param(name):
            try:
                return int(q[name][0])
            except (KeyError, IndexError, ValueError):
                return None

        if path == "/v1/registry/head":
            self._send_json(200, reg.head())
        elif path == "/v1/registry/entry":
            seq = _int_param("seq")
            entry = reg.entry(seq) if seq is not None else None
            if entry is None:
                self._send_json(404, {"error": f"no registry entry seq={seq}"})
            else:
                self._send_json(200, entry)
        elif path == "/v1/registry/proof":
            seq = _int_param("seq")
            if seq is None and "digest" in q:
                seq = reg.seq_of(q["digest"][0])
            proof = reg.inclusion_proof(seq) if seq is not None else None
            if proof is None:
                self._send_json(404, {"error": "no such registry record"})
            else:
                self._send_json(200, proof)
        elif path == "/v1/registry/consistency":
            old = _int_param("old_size")
            proof = reg.consistency(old) if old is not None else None
            if proof is None:
                self._send_json(
                    404, {"error": "old_size required, 0 <= old_size <= size"}
                )
            else:
                self._send_json(200, proof)
        elif path == "/v1/registry/base":
            # fleet base directory query: the newest base every member of
            # (fleet, key) acked — what a post-failover delta builds on
            fleet = (q.get("fleet") or [""])[0]
            key = (q.get("key") or [""])[0]
            if not key:
                self._send_json(404, {"error": "key required"})
                return
            digest = reg.newest_common_base(fleet or "default", key)
            cids = reg.lookup_base(digest) if digest else None
            self._send_json(
                200,
                {
                    "fleet": fleet or "default",
                    "key": key,
                    "digest": digest,
                    "cids": sorted(c.hex() for c in cids) if cids else None,
                },
            )
        else:
            self._send_json(404, {"error": f"no such path: {self.path}"})

    def _registry_append(
        self, digest: str, *, verdict: str = "", key: str = "", trace: str = "",
        cids=None,
    ) -> None:
        """Seal one served bundle into the provenance chain — fail-soft:
        any trouble counts `registry.append_failures` inside the writer
        and the response goes out bit-identical either way.

        ``digest`` and ``cids`` accept zero-arg callables (bound methods)
        resolved only past the ``reg is None`` gate: with the registry
        disabled the serve path must not pay for digesting or CID-set
        materialization it will never use."""
        reg = self.service.registry
        if reg is None:
            return
        if callable(digest):
            digest = digest()
        if not digest:
            return
        try:
            if callable(cids):
                cids = cids()
            reg.append_served(
                digest,
                trace=trace,
                tenant=getattr(self, "_tenant", None) or "",
                key=key,
                verdict=verdict,
                cids=cids,
            )
        except Exception:  # fail-soft: a registry write failure must never block serving
            self.service.metrics.count("registry.append_failures")

    # --- replication plane (storex.replica peers call these) ----------------

    def _send_bytes(self, status: int, data: bytes) -> None:
        self.send_response(status)
        self.send_header("Content-Type", "application/octet-stream")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _handle_segments_list(self):
        """``GET /v1/segments`` — the replication inventory: every segment
        file this shard holds (owner token + active flag), so a replica
        can diff against its own set and pull only what's missing."""
        disk = self.service.disk_store
        if disk is None:
            self._send_json(404, {"error": "no disk tier (serve without --store-dir)"})
            return
        self._send_json(
            200, {"segments": disk.segment_files(), "owner": disk.owner}
        )

    def _handle_segment_get(self, path: str):
        """``GET /v1/segments/<name>`` — one whole segment file, raw.
        Append-only CRC framing makes the transfer trivially safe: the
        puller re-scans every frame before believing a byte."""
        disk = self.service.disk_store
        if disk is None:
            self._send_json(404, {"error": "no disk tier (serve without --store-dir)"})
            return
        name = unquote(path[len("/v1/segments/") :])
        seg_path = disk.segment_path(name)
        if seg_path is None:
            self._send_json(404, {"error": f"no such segment: {name}"})
            return
        try:
            with open(seg_path, "rb") as fh:
                data = fh.read()
        except OSError:
            # evicted between the lookup and the read — a miss, not a fault
            self._send_json(404, {"error": f"no such segment: {name}"})
            return
        self._send_bytes(200, data)

    def _handle_block_get(self, path: str):
        """``GET /v1/blocks/<cid>`` — one block from the LOCAL tiers only
        (read-repair). 404 means this shard doesn't hold it; the route
        never touches the upstream, so a neighbour's repair can't launder
        a Lotus fetch through us."""
        data = self.service.read_block_local(unquote(path[len("/v1/blocks/") :]))
        if data is None:
            self._send_json(404, {"error": "block not in local tiers"})
        else:
            self._send_bytes(200, data)

    def _handle_segment_put(self, path: str):
        """``POST /v1/segments/<name>`` — ingest one pushed segment file
        (rebalance handoff / re-replication push). Idempotent: a name
        already registered is a no-op; every frame is CRC-scanned before
        registration; own-owner names are a typed 400 (a shard must never
        shadow its own active segments)."""
        disk = self.service.disk_store
        if disk is None:
            self._send_json(404, {"error": "no disk tier (serve without --store-dir)"})
            return
        name = unquote(path[len("/v1/segments/") :])
        try:
            length = int(self.headers.get("Content-Length", 0))
        except ValueError:
            length = 0
        if length <= 0 or length > _MAX_BODY_BYTES:
            self._send_json(
                400,
                {"error": f"Content-Length required, 0 < n <= {_MAX_BODY_BYTES}"},
            )
            return
        raw = self.rfile.read(length)
        try:
            blocks = disk.ingest_segment_file(name, raw)
        except SegmentStoreError as exc:
            self._send_json(400, {"error": str(exc), "error_type": "segment_ingest"})
            return
        self._send_json(200, {"segment": name, "blocks": blocks})

    def _handle_replica_peers(self, body: dict):
        """``POST /v1/replica_peers`` — install this shard's read-repair
        peer set (the router computes it from ring arcs)."""
        peers = body.get("peers")
        if not isinstance(peers, list) or not all(
            isinstance(p, dict)
            and isinstance(p.get("name"), str)
            and isinstance(p.get("url"), str)
            for p in peers
        ):
            self._send_json(
                400, {"error": "peers must be a list of {name, url} objects"}
            )
            return
        try:
            self.service.set_replica_peers(peers)
        except RuntimeError as exc:
            self._send_runtime_error(exc)
            return
        self._send_json(200, {"peers": len(peers)})

    def _handle_replicate(self, body: dict):
        """``POST /v1/replicate`` — run one pull-sync pass against the
        named source shards (optionally owner-filtered to the ring arcs
        this shard replicates). Synchronous: the response carries the
        pass's pulled/pending counts for the router's lag gauges."""
        sources = body.get("sources")
        if not isinstance(sources, list) or not all(
            isinstance(s, dict)
            and isinstance(s.get("name"), str)
            and isinstance(s.get("url"), str)
            for s in sources
        ):
            self._send_json(
                400, {"error": "sources must be a list of {name, url} objects"}
            )
            return
        owners = body.get("owners")
        if owners is not None and (
            not isinstance(owners, list)
            or not all(isinstance(o, str) for o in owners)
        ):
            self._send_json(400, {"error": "owners must be a list of strings"})
            return
        try:
            out = self.service.replicate_from(sources, owners=owners)
        except RuntimeError as exc:
            self._send_runtime_error(exc)
            return
        self._send_json(200, out)

    def _handle_backfill_get(self, path: str):
        """``GET /v1/backfill/<id>`` — job status/cursor;
        ``GET /v1/backfill/<id>/chunks?cursor=<n>[&wait_s=<s>]`` — the
        long-poll chunk fetch, `subs/delivery.py` cursor semantics: a
        poll from cursor N acks everything ≤ N (streamed payloads drop
        from memory; the journal keeps the bytes) and blocks up to
        ``wait_s`` for the first chunk above it. A job the card's fault
        stopped answers 500 ``error_type: device`` (its stream: the fresh
        chunks, then a ``device`` abort chunk in place of the envelope)."""
        if self.backfill is None:
            self._send_json(404, _BACKFILL_DISABLED)
            return
        rest = path[len("/v1/backfill/") :]
        job_id, _, tail = rest.partition("/")
        job = self.backfill.job(job_id)
        if job is None:
            self._send_json(404, {"error": f"no such backfill job: {job_id}"})
            return
        if tail == "":
            status = job.status()
            if status.get("error_type") == "device":
                self._send_json(500, {"error": status["error"], "error_type": "device"})
            else:
                self._send_json(200, status)
        elif tail == "chunks":
            q = parse_qs(urlsplit(self.path).query)
            try:
                cursor = int((q.get("cursor") or ["0"])[0])
                wait_s = min(30.0, max(0.0, float((q.get("wait_s") or ["0"])[0])))
            except ValueError:
                self._send_json(400, {"error": "cursor/wait_s must be numeric"})
                return
            out = job.chunks_after(cursor, wait_s=wait_s)
            if negotiate_stream({}, headers=self.headers):
                self._stream_backfill_chunks(out, job.fault)
            elif job.fault is not None:
                self._send_runtime_error(job.fault)
            else:
                self._send_json(200, out)
        else:
            self._send_json(404, {"error": f"no such path: {self.path}"})

    def _stream_backfill_chunks(self, out: dict, fault=None) -> None:
        """``GET /v1/backfill/<id>/chunks`` with
        ``Accept: application/x-ipc-bundle-stream`` — the multi-document
        stream form: one IPBS document per result chunk (block payloads
        sliced zero-copy out of the segment tier when warm), closed by a
        metadata-only envelope document carrying the poll fields
        (``job_id`` / ``state`` / ``cursor`` / ``acked``) — or, for a job
        the card's fault stopped, by the ``device`` abort chunk."""

        def emit(writer) -> None:
            stream_backfill_chunks(
                writer, out, slicer=self.service.read_block_slice,
                envelope=fault is None,
            )
            if fault is not None:
                raise fault

        self._stream_ok(emit, "identity")

    def _handle_deliveries(self):
        """``GET /v1/deliveries?sub=<id>&cursor=<n>[&wait_s=<s>]`` — the
        long-poll fallback: acks everything ≤ cursor, returns what's
        above it (blocking up to ``wait_s``, capped server-side)."""
        if self.subs is None:
            self._send_json(404, _SUBS_DISABLED)
            return
        q = parse_qs(urlsplit(self.path).query)
        sub_id = (q.get("sub") or [""])[0]
        if not sub_id:
            self._send_json(400, {"error": "sub query parameter required"})
            return
        try:
            cursor = int((q.get("cursor") or ["0"])[0])
            wait_s = min(30.0, max(0.0, float((q.get("wait_s") or ["0"])[0])))
        except ValueError:
            self._send_json(400, {"error": "cursor/wait_s must be numeric"})
            return
        out = self.subs.deliveries(sub_id, cursor=cursor, wait_s=wait_s)
        if out is None:
            self._send_json(404, {"error": f"no such subscription: {sub_id}"})
        else:
            self._send_json(200, out)

    def do_POST(self):
        # segment ingest carries a RAW octet-stream body (a whole segment
        # file) — route it before the JSON body parse below
        if self.path.startswith("/v1/segments/"):
            self._handle_segment_put(urlsplit(self.path).path)
            return
        try:
            body = self._read_json_body()
        except (ValueError, json.JSONDecodeError) as exc:
            self._send_json(400, {"error": f"bad request body: {exc}"})
            return
        # the span opens BEFORE admission on this handler thread, so the
        # batcher captures it and execution parents under it. A "trace"
        # carrier in the body (the cluster router's scatter hop) parents
        # this request's spans under the remote dispatch span — one trace
        # covers the whole scatter-gather; without one this is a trace root
        carrier = body.get("trace")
        # tenant accounting at admission: the sanitized label rides the
        # request through batcher/durable-queue; bytes charge the body size
        self._tenant = extract_tenant(body, self.headers)
        self._active_span = None  # set for remote-carried requests (stitching)
        self._account_response = False
        self._cancel_scope = None  # set for proof paths below
        self._admit_slot = None
        self._queue_delay_ms = 0.0  # AIMD signal, filled from server_timing
        if self.path in ("/v1/verify", "/v1/generate", "/v1/generate_range"):
            if self.tenants is not None:
                self.tenants.account(self._tenant, getattr(self, "_body_bytes", 0))
                self._account_response = True
            # QoS admission sits at the very front door — an exhausted
            # bucket never touches the batcher, so a heavy tenant's burst
            # costs one bucket check, not a queue slot
            if self.qos is not None:
                try:
                    self.qos.admit(self._tenant)
                except TenantThrottledError as exc:
                    self._send_json(
                        429,
                        {
                            "error": str(exc),
                            "error_type": "tenant_throttled",
                            # the HONEST refill estimate (seconds until the
                            # bucket actually holds one token), not a fixed
                            # constant — the header rounds it up to >= 1s
                            "retry_after_s": exc.retry_after_s,
                        },
                        headers={
                            "Retry-After": f"{max(1, round(exc.retry_after_s))}"
                        },
                    )
                    return
            # deadline propagation: X-IPC-Deadline-Ms header / deadline_ms
            # body field is the caller's REMAINING budget. A budget already
            # below the admission floor is refused typed here — admitting it
            # would burn a worker on a response nobody can use
            if not self._parse_deadline(body):
                return
            # adaptive admission (--admit-gradient): the AIMD concurrency
            # gate sits after the per-tenant bucket (cheap, per-tenant
            # fairness first) and before any queue slot is taken
            if self.admit is not None:
                try:
                    self._admit_slot = self.admit.acquire(self._tenant)
                except AdmitRejectedError as exc:
                    self._send_json(
                        429,
                        {
                            "error": str(exc),
                            "error_type": "admit_rejected",
                            "retry_after_s": exc.retry_after_s,
                        },
                        headers={
                            "Retry-After": f"{max(1, round(exc.retry_after_s))}"
                        },
                    )
                    return
        try:
            self._route_post(body, carrier)
        finally:
            if self._admit_slot is not None:
                self.admit.release(
                    self._admit_slot, queue_delay_ms=self._queue_delay_ms
                )

    def _route_post(self, body: dict, carrier) -> None:
        if self.path == "/v1/verify":
            with adopted_span("http.verify", carrier, {"path": self.path}) as sp:
                if carrier is not None:
                    self._active_span = sp
                self._handle_verify(body)
        elif self.path == "/v1/generate":
            with adopted_span("http.generate", carrier, {"path": self.path}) as sp:
                if carrier is not None:
                    self._active_span = sp
                self._handle_generate(body)
        elif self.path == "/v1/generate_range":
            with adopted_span(
                "http.generate_range", carrier, {"path": self.path}
            ) as sp:
                if carrier is not None:
                    self._active_span = sp
                self._handle_generate_range(body)
        elif self.path == "/v1/subscribe":
            self._handle_subscribe(body)
        elif self.path == "/v1/unsubscribe":
            self._handle_unsubscribe(body)
        elif self.path == "/v1/backfill":
            self._handle_backfill_submit(body)
        elif self.path == "/v1/replica_peers":
            self._handle_replica_peers(body)
        elif self.path == "/v1/replicate":
            self._handle_replicate(body)
        else:
            self._send_json(404, {"error": f"no such path: {self.path}"})

    def _handle_backfill_submit(self, body: dict):
        """``POST /v1/backfill`` — submit one durable backfill job over
        rows ``[pair_start, pair_end)`` of the server pair table (the
        service's event filter is the job's filter; the pair table IS the
        epoch range). Idempotent: an identical range re-submit returns
        the running job, or resumes its journal after a crash."""
        if self.backfill is None:
            self._send_json(404, _BACKFILL_DISABLED)
            return
        n = len(self.pairs)
        start = body.get("pair_start")
        end = body.get("pair_end")

        def _row(v) -> bool:
            return isinstance(v, int) and not isinstance(v, bool)

        if not (_row(start) and _row(end) and 0 <= start < end <= n):
            self._send_json(
                400,
                {
                    "error": "pair_start/pair_end must be ints with "
                    f"0 <= start < end <= {n} (server pair table)"
                },
            )
            return
        wsize = body.get("window_size")
        if wsize is not None and (not _row(wsize) or wsize < 1):
            self._send_json(400, {"error": "window_size must be a positive int"})
            return
        sub_id = body.get("sub_id")
        if sub_id is not None and not isinstance(sub_id, str):
            self._send_json(400, {"error": "sub_id must be a string"})
            return
        try:
            job = self.backfill.submit(
                start, end, window_size=wsize, sub_id=sub_id
            )
        except ValueError as exc:
            self._send_json(400, {"error": str(exc)})
            return
        except RuntimeError as exc:
            self._send_runtime_error(exc)
            return
        self._send_json(200, job.status())

    def _handle_subscribe(self, body: dict):
        if self.subs is None:
            self._send_json(404, _SUBS_DISABLED)
            return
        try:
            self._send_json(200, self.subs.subscribe(body))
        except ValueError as exc:
            self._send_json(400, {"error": str(exc)})

    def _handle_unsubscribe(self, body: dict):
        if self.subs is None:
            self._send_json(404, _SUBS_DISABLED)
            return
        try:
            self._send_json(200, self.subs.unsubscribe(body))
        except ValueError as exc:
            self._send_json(400, {"error": str(exc)})

    @staticmethod
    def _claim_results(claims, storage_results, event_results) -> list:
        """Per-claim verdicts: each claim's span slices of the flat
        per-proof result vectors (one shared replay, K verdicts)."""
        out = []
        for c in claims:
            s = storage_results[c.storage_lo : c.storage_hi]
            e = event_results[c.event_lo : c.event_hi]
            out.append(
                {
                    "storage_results": s,
                    "event_results": e,
                    "all_valid": all(s) and all(e),
                }
            )
        return out

    def _handle_verify(self, body: dict):
        obj = body.get("bundle", body)
        try:
            # plain or compressed (``blocks_frame``) wire form — the
            # witness-plane parser handles both, digest-checked
            bundle = parse_bundle_obj(obj)
            claims = None
            if body.get("claims") is not None:
                claims = AggregatedBundle.claims_from_json(
                    body["claims"], bundle
                ).claims
        except WitnessError as exc:
            self._send_json(
                400,
                {"error": str(exc), "error_type": exc.error_type},
            )
            return
        except (ValueError, KeyError, TypeError) as exc:
            self._send_json(400, {"error": f"malformed bundle: {exc}"})
            return
        timeout_s = self._effective_timeout(body)
        if self.durable is not None:
            # journal the PLAIN bundle obj (compressed frames expand before
            # admission, so journal replay never needs the codec)
            plain = obj if "blocks_frame" not in obj else bundle.to_json_obj()
            self._submit_durable(
                "verify", plain, body, claims=claims,
                seal=lambda done: self._registry_append(
                    bundle.digest,
                    verdict=(
                        "valid"
                        if (done.get("result") or {}).get("all_valid")
                        else "invalid"
                    ),
                    key="verify",
                )
                if done.get("ok")
                else None,
            )
            return

        def render(resp):
            self._registry_append(
                bundle.digest,
                verdict="valid" if resp.all_valid() else "invalid",
                key="verify",
                trace=resp.trace_id,
            )
            out = {
                "storage_results": resp.storage_results,
                "event_results": resp.event_results,
                "all_valid": resp.all_valid(),
                "batch_size": resp.batch_size,
                "trace_id": resp.trace_id,
                "server_timing": resp.server_timing,
            }
            if claims is not None:
                out["claim_results"] = self._claim_results(
                    claims, resp.storage_results, resp.event_results
                )
            return out

        self._submit(
            lambda: self.service.submit_verify(
                bundle,
                timeout_s=timeout_s,
                tenant=self._tenant,
                cancel_scope=self._cancel_scope,
            ),
            render,
            pending=True,
        )

    def _handle_generate(self, body: dict):
        idx = body.get("pair_index")
        if not isinstance(idx, int) or not (0 <= idx < len(self.pairs)):
            self._send_json(
                400,
                {
                    "error": "pair_index must be an int in "
                    f"[0, {len(self.pairs)}) (server pair table)"
                },
            )
            return
        opts = self._negotiate_witness(body)
        if opts is None:
            return
        stream = self._negotiate_stream(body)
        if stream is None:
            return
        timeout_s = self._effective_timeout(body)
        if self.durable is not None:
            self._submit_durable(
                "generate", idx, body, witness=opts, stream=stream
            )
            return

        def stream_doc(resp, writer):
            digest = stream_bundle_doc(
                writer,
                resp.bundle,
                opts,
                bases=self.service.witness_bases,
                metrics=self.service.metrics,
                head_extra={
                    "n_event_proofs": resp.n_event_proofs,
                    "batch_size": resp.batch_size,
                    "trace_id": resp.trace_id,
                },
                tail_extra={"server_timing": dict(resp.server_timing)},
                slicer=self.service.read_block_slice,
            )
            self._registry_append(
                digest, verdict="served", key=f"pair:{idx}",
                trace=resp.trace_id, cids=resp.bundle.cid_set,
            )

        def render(resp):
            fields = self._witness_fields(resp.bundle, opts)
            self._registry_append(
                fields.get("digest", ""), verdict="served", key=f"pair:{idx}",
                trace=resp.trace_id, cids=resp.bundle.cid_set,
            )
            return dict(
                fields,
                n_event_proofs=resp.n_event_proofs,
                batch_size=resp.batch_size,
                trace_id=resp.trace_id,
                server_timing=resp.server_timing,
            )

        self._submit(
            lambda: self.service.submit_generate(
                self.pairs[idx],
                timeout_s=timeout_s,
                tenant=self._tenant,
                cancel_scope=self._cancel_scope,
            ),
            render,
            stream_fn=stream_doc if stream else None,
            encoding=opts.encoding,
            pending=True,
        )

    def _handle_generate_range(self, body: dict):
        """One multi-pair range sub-request (the scatter-gather unit).

        ``pair_indexes`` selects rows of the server pair table; the
        response bundle is the canonical chunked-driver bytes for exactly
        those pairs, so the router can union sub-bundles bit-identically.
        """
        idxs = body.get("pair_indexes")
        n = len(self.pairs)
        # bool is an int subclass — reject it explicitly, True is not a row
        if (
            not isinstance(idxs, list)
            or not idxs
            or not all(
                isinstance(i, int) and not isinstance(i, bool) and 0 <= i < n
                for i in idxs
            )
        ):
            self._send_json(
                400,
                {
                    "error": "pair_indexes must be a non-empty list of ints "
                    f"in [0, {n}) (server pair table)"
                },
            )
            return
        chunk = body.get("chunk_size")
        if chunk is not None and (
            not isinstance(chunk, int) or isinstance(chunk, bool) or chunk < 1
        ):
            self._send_json(400, {"error": "chunk_size must be a positive int"})
            return
        aggregate = body.get("aggregate", False)
        if not isinstance(aggregate, bool):
            self._send_json(400, {"error": "aggregate must be a boolean"})
            return
        opts = self._negotiate_witness(body)
        if opts is None:
            return
        stream = self._negotiate_stream(body)
        if stream is None:
            return
        if aggregate and len(idxs) > self.service.config.witness_agg_max:
            self._send_json(
                400,
                {
                    "error": f"aggregate request carries {len(idxs)} claims, "
                    f"above --witness-agg-max "
                    f"{self.service.config.witness_agg_max}",
                    "error_type": "witness_agg_max",
                },
            )
            return
        # aggregated requests may repeat pair indexes (K co-tipset claims);
        # the canonical bundle is generated once over the DISTINCT indexes
        # and the claim table maps every claim onto its pair's spans
        gen_idxs = list(dict.fromkeys(idxs)) if aggregate else list(idxs)
        if self.durable is not None:
            self._submit_durable(
                "generate_range",
                {"pair_indexes": gen_idxs, "chunk_size": chunk},
                body,
                witness=opts,
                claim_indexes=list(idxs) if aggregate else None,
                gen_indexes=gen_idxs,
                stream=stream,
            )
            return

        def _claims(bundle):
            if not aggregate:
                return None
            return aggregate_range_bundle(
                bundle,
                self.pairs,
                gen_idxs,
                claim_indexes=idxs,
                metrics=self.service.metrics,
            ).claims_json()

        range_key = "pairs:" + ",".join(str(i) for i in gen_idxs[:32])

        def render(bundle):
            fields = self._witness_fields(bundle, opts, claims=_claims(bundle))
            self._registry_append(
                fields.get("digest", ""), verdict="served", key=range_key,
                cids=bundle.cid_set,
            )
            return dict(
                fields,
                n_event_proofs=len(bundle.event_proofs),
                n_pairs=len(gen_idxs),
            )

        def stream_doc(bundle, writer):
            digest = stream_bundle_doc(
                writer,
                bundle,
                opts,
                bases=self.service.witness_bases,
                metrics=self.service.metrics,
                claims=_claims(bundle),
                head_extra={
                    "n_event_proofs": len(bundle.event_proofs),
                    "n_pairs": len(gen_idxs),
                },
                slicer=self.service.read_block_slice,
            )
            self._registry_append(
                digest, verdict="served", key=range_key, cids=bundle.cid_set
            )

        self._submit(
            # direct synchronous driver call on this handler thread — the
            # scope installs so chunk checkpoints see the deadline (no
            # concurrent disconnect watcher on this path)
            lambda: self._call_scoped(
                lambda: self.service.generate_range(
                    [self.pairs[i] for i in gen_idxs], chunk_size=chunk
                )
            ),
            render,
            stream_fn=stream_doc if stream else None,
            encoding=opts.encoding,
        )

    # --- deadline / cancellation plumbing ----------------------------------

    def _parse_deadline(self, body: dict) -> bool:
        """Install this request's `CancelScope` from its deadline budget.

        ``deadline_ms`` in the body wins over the ``X-IPC-Deadline-Ms``
        header; both mean "milliseconds of budget REMAINING as the request
        reaches me" — each hop re-emits the decremented value, never the
        original. A budget at/below ``--deadline-floor-ms`` is refused
        typed 504 right here (``deadline.rejects.httpd``): admitting work
        that cannot finish inside its budget only burns a worker slot that
        a live request could have used. Returns False after sending an
        error response; a request with no deadline still gets a scope so
        client-disconnect cancellation works."""
        raw = body.get("deadline_ms", None)
        if raw is None:
            raw = self.headers.get("X-IPC-Deadline-Ms")
        deadline = None
        if raw is not None:
            try:
                ms = float(raw)
            except (TypeError, ValueError):
                self._send_json(
                    400, {"error": "deadline_ms must be a number of milliseconds"}
                )
                return False
            deadline = Deadline.from_ms(max(0.0, ms))
            floor_ms = float(
                getattr(self.service.config, "deadline_floor_ms", 0.0)
            )
            if deadline.remaining_ms() <= floor_ms:
                m = self.service.metrics
                m.count("serve.deadline_rejects")
                m.count("deadline.rejects.httpd")
                self._send_json(
                    504,
                    {
                        "error": f"deadline budget {ms:.0f}ms at/below the "
                        f"admission floor ({floor_ms:.0f}ms)",
                        "error_type": "deadline",
                    },
                )
                return False
        self._cancel_scope = CancelScope(deadline)
        return True

    def _effective_timeout(self, body: dict):
        """The batcher timeout for this request: the explicit ``timeout_s``
        clamped to the deadline budget (whichever expires first wins)."""
        timeout_s = body.get("timeout_s")
        scope = getattr(self, "_cancel_scope", None)
        if scope is not None and scope.deadline is not None:
            rem = max(0.0, scope.deadline.remaining_s())
            timeout_s = rem if timeout_s is None else min(float(timeout_s), rem)
        return timeout_s

    def _client_disconnected(self) -> bool:
        """True when the client hung up: the socket is readable AND a
        MSG_PEEK read returns EOF (a pipelined next request makes the
        socket readable too — peeking distinguishes the two without
        consuming bytes)."""
        try:
            readable, _, _ = select.select([self.connection], [], [], 0)
            if not readable:
                return False
            return self.connection.recv(1, socket.MSG_PEEK) == b""
        except (OSError, ValueError):
            return True

    def _await_pending(self, pending):
        """Block on a `PendingResult` while watching the client socket.

        A disconnect cancels the request's scope: the batcher drops it at
        dispatch (or the range driver aborts at its next chunk boundary)
        and the worker time goes to a request somebody still wants. We keep
        waiting after cancelling — the batcher acknowledges with a typed
        `CancelledError` (or completes the batch that already started)."""
        scope = self._cancel_scope
        while True:
            try:
                return pending.result(timeout=_DISCONNECT_POLL_S)
            except TimeoutError:
                if (
                    scope is not None
                    and not scope.cancelled
                    and self._client_disconnected()
                ):
                    scope.cancel("client disconnected")

    def _call_scoped(self, fn):
        """Run a synchronous service call under this request's scope so
        driver checkpoints (`utils.deadline.checkpoint`) see its deadline.
        The call runs on THIS handler thread, so there is no concurrent
        disconnect watcher — expiry aborts at the next chunk/stage/retry
        boundary."""
        scope = getattr(self, "_cancel_scope", None)
        if scope is None:
            return fn()
        with use_scope(scope):
            return fn()

    def _submit(self, call, render, stream_fn=None, encoding=None, pending=False):
        try:
            resp = self._await_pending(call()) if pending else call()
        except QueueFullError as exc:
            self._send_json(
                503,
                {"error": "queue full", "retry_after_s": exc.retry_after_s},
                headers={"Retry-After": f"{max(1, round(exc.retry_after_s))}"},
            )
        except ServiceClosedError:
            self._send_json(503, {"error": "service draining"})
        except CancelledError:
            # only a client disconnect cancels the scope — there is nobody
            # left to answer; close without wasting bytes on the dead socket
            self.close_connection = True
        except DeadlineError as exc:
            # covers batcher DeadlineExceededError + every propagated hop
            # (rpc retry, range chunk, pipeline stage); always typed
            self._send_json(
                504, {"error": str(exc), "error_type": exc.error_type}
            )
        except DegradedError as exc:
            # all breakers open and the request needed the upstream: fail
            # fast typed — warm-tier requests never reach this branch
            self._send_json(
                503, {"error": str(exc), "error_type": exc.error_type}
            )
        except RuntimeError as exc:
            self._send_runtime_error(exc)
        else:
            t = getattr(resp, "server_timing", None)
            if isinstance(t, dict) and "queue_ms" in t:
                # the gradient limiter's AIMD signal: pure queue wait, not
                # execution time (a big batch is throughput, not overload)
                self._queue_delay_ms = float(t["queue_ms"])
            if stream_fn is not None:
                # admission/execution errors above still travel as typed
                # JSON statuses — only a successful response streams
                self._stream_ok(lambda w: stream_fn(resp, w), encoding)
                return
            obj = render(resp)
            self._attach_spans(obj)
            headers = {}
            timing = getattr(resp, "server_timing", None)
            if timing:
                headers["Server-Timing"] = self._server_timing_header(timing)
            # satellite contract: the chosen encoding is ALWAYS echoed —
            # the JSON field plus a header the thinnest client can read
            if "witness_encoding" in obj:
                headers["Witness-Encoding"] = obj["witness_encoding"]
            self._send_json(200, obj, headers=headers or None)

    def _attach_spans(self, obj: dict) -> None:
        """Ship this request's span subtree in the response for sampled,
        remote-carried traces — the router grafts it under its dispatch
        span so one exported tree covers router → shard → workers.
        ``spans_pid`` lets an in-process caller (LocalShard) recognize its
        own spans and skip the graft (they are already in its ring)."""
        sp = getattr(self, "_active_span", None)
        if sp is None or not sp.sampled or not tracing_enabled():
            return
        obj["spans"] = subtree_for_response(sp)
        obj["spans_pid"] = os.getpid()

    def _rewitness_result(
        self, result: dict, witness, claims, claim_indexes, gen_indexes
    ) -> dict:
        """Re-encode a journaled done payload under this request's witness
        options.

        The durable journal always holds the PLAIN canonical result (so
        replay/idempotency never depend on a codec or a base another client
        declared); aggregation claims, delta encoding and compression are
        per-response treatments applied on the way out."""
        if "bundle" in result and witness is not None:
            bundle = UnifiedProofBundle.from_json_obj(result["bundle"])
            claims_json = None
            if claim_indexes is not None:
                claims_json = aggregate_range_bundle(
                    bundle,
                    self.pairs,
                    gen_indexes,
                    claim_indexes=claim_indexes,
                    metrics=self.service.metrics,
                ).claims_json()
            result = {k: v for k, v in result.items() if k != "bundle"}
            result.update(self._witness_fields(bundle, witness, claims=claims_json))
            # durable replays are served responses too: the provenance
            # chain records every bundle that leaves the process, cached
            # or fresh
            self._registry_append(
                result.get("digest", ""), verdict="served", key="replay",
                cids=bundle.cid_set,
            )
        if claims is not None and "storage_results" in result:
            result = dict(
                result,
                claim_results=self._claim_results(
                    claims, result["storage_results"], result["event_results"]
                ),
            )
        return result

    def _submit_durable(
        self,
        kind: str,
        payload,
        body: dict,
        witness=None,
        claims=None,
        claim_indexes=None,
        gen_indexes=None,
        stream=False,
        seal=None,
    ):
        """Route one request through the durable admission queue.

        Same error mapping as `_submit`, but the 200 body is the journaled
        done payload: ``{"ok": ..., "result"|"error": ...}`` plus the
        ``idempotency_key`` that names it and ``cached`` (True when served
        from the idempotency cache instead of a fresh execution). Witness
        treatments (``witness``/``claims``/``claim_indexes``) re-encode the
        plain journaled result per-response — see `_rewitness_result`."""
        key = body.get("idempotency_key")
        if key is not None and not isinstance(key, str):
            self._send_json(400, {"error": "idempotency_key must be a string"})
            return
        try:
            # scoped so the durable layer (and any direct driver call it
            # makes) sees this request's deadline through the ambient scope
            key, done, cached = self._call_scoped(
                lambda: self.durable.submit(
                    kind, payload, idempotency_key=key,
                    timeout_s=self._effective_timeout(body),
                    tenant=self._tenant,
                )
            )
        except QueueFullError as exc:
            self._send_json(
                503,
                {"error": "queue full", "retry_after_s": exc.retry_after_s},
                headers={"Retry-After": f"{max(1, round(exc.retry_after_s))}"},
            )
        except ServiceClosedError:
            self._send_json(503, {"error": "service draining"})
        except DeadlineError as exc:
            self._send_json(
                504, {"error": str(exc), "error_type": exc.error_type}
            )
        except DegradedError as exc:
            self._send_json(
                503, {"error": str(exc), "error_type": exc.error_type}
            )
        except RuntimeError as exc:
            # the queue journals every other failure as the request's
            # result; a device fault alone re-raises (its admit pending)
            if not is_device_fault(exc):
                raise
            self._send_runtime_error(exc)
        else:
            if seal is not None:
                # provenance seal for journaled kinds that carry no bundle
                # (verify): fail-soft like every registry append
                try:
                    seal(done)
                except Exception:  # fail-soft: a registry write failure must never block serving
                    self.service.metrics.count("registry.append_failures")
            headers = None
            if (
                stream
                and witness is not None
                and done.get("ok")
                and isinstance(done.get("result"), dict)
                and "bundle" in done["result"]
            ):
                self._stream_durable(
                    done["result"], key, cached, witness, claim_indexes,
                    gen_indexes,
                )
                return
            if done.get("ok") and isinstance(done.get("result"), dict):
                result = self._rewitness_result(
                    done["result"], witness, claims, claim_indexes, gen_indexes
                )
                done = dict(done, result=result)
                if "witness_encoding" in result:
                    headers = {"Witness-Encoding": result["witness_encoding"]}
            out = dict(done, idempotency_key=key, cached=cached)
            self._attach_spans(out)
            self._send_json(200, out, headers=headers)

    def _stream_durable(
        self, result: dict, key, cached, witness, claim_indexes, gen_indexes
    ) -> None:
        """Streamed form of a durable done payload: the journal's PLAIN
        canonical result re-encoded through the IPBS wire under this
        request's witness options.

        Unlike the buffered durable response there is no ``result``
        envelope — the document IS the result, with ``ok`` /
        ``idempotency_key`` / ``cached`` riding the header chunk. Block
        payloads come from the journal JSON, so they stream as copied
        bytes unless the segment tier still holds them warm (the slicer
        is consulted per block either way)."""
        bundle = UnifiedProofBundle.from_json_obj(result["bundle"])
        claims_json = None
        if claim_indexes is not None:
            claims_json = aggregate_range_bundle(
                bundle,
                self.pairs,
                gen_indexes,
                claim_indexes=claim_indexes,
                metrics=self.service.metrics,
            ).claims_json()
        head = {
            k: v
            for k, v in result.items()
            if k not in ("bundle", "server_timing")
        }
        head.update(ok=True, idempotency_key=key, cached=cached)
        timing = result.get("server_timing")
        tail = (
            {"server_timing": dict(timing)} if isinstance(timing, dict) else None
        )

        def doc(writer):
            digest = stream_bundle_doc(
                writer,
                bundle,
                witness,
                bases=self.service.witness_bases,
                metrics=self.service.metrics,
                claims=claims_json,
                head_extra=head,
                tail_extra=tail,
                slicer=self.service.read_block_slice,
            )
            self._registry_append(
                digest, verdict="served", key="replay", cids=bundle.cid_set
            )

        self._stream_ok(doc, witness.encoding)


class ProofHTTPServer:
    """Own one `ProofService` behind a threading HTTP server.

    ``port=0`` binds an ephemeral port (tests); read ``.port`` after
    construction. `serve_forever()` blocks; `start()` runs the accept loop
    on a daemon thread. `shutdown()` stops accepting, then drains the
    service — zero accepted requests are lost.
    """

    def __init__(
        self,
        service: ProofService,
        host: str = "127.0.0.1",
        port: int = 0,
        pairs: Optional[Sequence[TipsetPair]] = None,
        durable=None,
        subs=None,
        slo=None,
        tenants=None,
        backfill=None,
        qos=None,
    ):
        self.service = service
        self.durable = durable
        self.subs = subs
        self.slo = slo
        self.backfill = backfill  # backfill.BackfillEngine (or None)
        # tenant accounting is always on (bounded top-K, so it's safe);
        # pass an explicit ledger to share one across servers or set top_k
        self.tenants = (
            tenants
            if tenants is not None
            else TenantLedger(metrics=service.metrics)
        )
        # QoS enforcement is opt-in (--tenant-rate); built here so the
        # buckets share the ledger's slot labels for tenant.throttled.*
        self.qos = qos
        if self.qos is None and getattr(service.config, "tenant_rate", None):
            self.qos = TenantQoS(
                service.config.tenant_rate,
                burst=service.config.tenant_burst,
                metrics=service.metrics,
                ledger=self.tenants,
            )
        # adaptive admission (--admit-gradient): one AIMD gate shared by
        # every handler thread; replaces the static queue_capacity as the
        # effective concurrency bound (the batcher capacity stays as a
        # hard backstop behind it)
        self.admit = None
        cfg = service.config
        if getattr(cfg, "admit_gradient", False):
            self.admit = GradientLimiter(
                initial=cfg.admit_initial,
                min_limit=cfg.admit_min,
                max_limit=cfg.admit_max,
                delay_budget_ms=cfg.admit_delay_budget_ms,
                tenant_weights=getattr(cfg, "tenant_weights", None),
                metrics=service.metrics,
            )
        handler = type(
            "_BoundHandler",
            (_Handler,),
            {
                "service": service,
                "pairs": list(pairs or []),
                "durable": durable,
                "subs": subs,
                "slo": slo,
                "tenants": self.tenants,
                "backfill": backfill,
                "qos": self.qos,
                "admit": self.admit,
            },
        )
        self._httpd = _Listener((host, port), handler)
        self._httpd.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def address(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    def serve_forever(self) -> None:
        self._httpd.serve_forever(poll_interval=0.1)

    def start(self) -> "ProofHTTPServer":
        # start()/shutdown() are owner-thread lifecycle calls with a
        # happens-before edge through Thread.start()/join(); no lock needed
        self._thread = threading.Thread(  # ipclint: disable=race-unannotated
            target=self.serve_forever, name="proof-httpd", daemon=True
        )
        self._thread.start()
        return self

    def shutdown(self, timeout: Optional[float] = None) -> None:
        """Stop the accept loop, then drain the service (flushes all
        accepted work before returning).

        Order matters: the standing-query plane drains FIRST — its push
        workers read proof payloads and its matcher reads the blockstore,
        so they must finish before `service.drain()` closes the fetch
        plane and the tiered store underneath them (a SIGTERM mid-push
        must never make a delivery read from a closed tier)."""
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout)
        if self.slo is not None:
            self.slo.stop()
        # backfill aborts at its next window boundary BEFORE the service
        # drains — its window runner submits into the service's batcher,
        # which must still be accepting while running jobs wind down
        if self.backfill is not None:
            self.backfill.close(timeout=timeout)
        if self.subs is not None:
            self.subs.drain()
        self.service.drain(timeout=timeout)
        if self.durable is not None:
            self.durable.close()

    def abort(self) -> None:
        """Crash simulation: stop serving WITHOUT draining.

        Closes the listener and abandons everything in flight — exactly
        what a shard process dying looks like to the cluster router, which
        is what failover tests need to exercise. The durable queue's
        journal is left as crash residue for recovery-on-restart."""
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(1.0)
