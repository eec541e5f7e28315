"""N-way segment replication: peer pulls, read-repair, rebalance journal.

The counterpart of ``ipc_proofs_tpu.storex.replica``: a port shard and a
reference shard replicate from each other (one segment file format, one
journal framing, one HTTP surface). Host code: a repaired block is
re-verified with `store.rpc.verify_block_bytes` (the verify lane's
one-block case), and an ingested segment's blocks are multihash-checked
when they are read, a batch read on the card (`SegmentStore.get_many`).

Segments (`storex.segments`) are append-only ``IPS1`` CRC-framed files,
so replicating one to a peer shard is a whole-file HTTP copy plus an
index scan — no re-serialization, no per-block negotiation. Three layers
ride that fact:

- `ReplicaClient` — stdlib-urllib client for the shard replication
  routes (``GET /v1/segments``, ``GET|POST /v1/segments/<name>``,
  ``GET /v1/blocks/<cid>``). Transport or HTTP failure raises the typed
  `ReplicaError` (an ``OSError`` — inside every chaos harness's typed
  set).
- `ReplicaSet` — the read-repair half: when the local disk tier finds a
  frame that fails CRC/multihash (an integrity eviction), `repair` asks
  each replica peer for the block *before* anyone falls back to Lotus.
  Every returned byte string is re-verified against the CID — a lying
  replica is indistinguishable from a miss. Counted as
  ``storex.replica_repairs`` vs ``storex.replica_repair_misses``.
- `Replicator` — the sync half: pull every non-active segment file a
  peer holds that we don't (optionally filtered to an owner set — the
  ring arcs this shard is replica for), ingest atomically. Restoring
  R after a host death is just re-running `sync_from` against the
  survivors.

`RebalanceJob` is membership churn under journal discipline: a plan
(which segment files move to which destination) is committed to an
``IPJ1`` journal (`jobs.journal`), each pushed segment is journaled
before the next starts, and a final ``commit`` record ends the handoff.
SIGKILL at ANY point resumes to the same final placement: completed
pushes are skipped on replay (segment ingest is idempotent — same name,
same bytes), and the source keeps serving its copy until the commit
record lands, so reads stay correct mid-rebalance. The journal writer's
crash hook (``IPC_JOURNAL_CRASH_AT``) gives the crashtest grid real
SIGKILLs at every append boundary for free.
"""

from __future__ import annotations

import json
import os
import urllib.error
import urllib.parse
import urllib.request
from typing import Callable, Dict, List, Optional, Sequence

from ipc_proofs_tpu_torch.core.cid import CID
from ipc_proofs_tpu_torch.jobs.journal import JournalError, JournalWriter, read_journal
from ipc_proofs_tpu_torch.store.rpc import verify_block_bytes
from ipc_proofs_tpu_torch.storex.segments import SegmentStore
from ipc_proofs_tpu_torch.utils.log import get_logger
from ipc_proofs_tpu_torch.utils.metrics import Metrics, get_metrics

__all__ = [
    "RebalanceJob",
    "ReplicaClient",
    "ReplicaError",
    "ReplicaSet",
    "Replicator",
]

logger = get_logger(__name__)


class ReplicaError(OSError):
    """Typed replication failure: peer unreachable, non-2xx on a
    replication route, or a rebalance journal that contradicts the
    requested plan. An ``OSError`` so every chaos/crashtest typed-error
    set already covers it."""


class ReplicaClient:
    """One peer shard's replication surface over stdlib urllib.

    Content-addressed data needs no auth or freshness negotiation: every
    byte that comes back is CRC/multihash-verified by the caller before
    it is believed.
    """

    def __init__(self, name: str, base_url: str, timeout_s: float = 30.0):
        self.name = name
        self.base_url = base_url.rstrip("/")
        self.timeout_s = timeout_s

    def _request(
        self, method: str, path: str, body: Optional[bytes] = None
    ) -> "tuple[int, bytes]":
        req = urllib.request.Request(
            self.base_url + path,
            data=body,
            method=method,
            headers={"Content-Type": "application/octet-stream"} if body else {},
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
                return resp.status, resp.read()
        except urllib.error.HTTPError as exc:
            return exc.code, exc.read()
        except (urllib.error.URLError, ConnectionError, TimeoutError, OSError) as exc:
            raise ReplicaError(f"replica {self.name} unreachable: {exc}") from exc

    def list_segments(self) -> "List[dict]":
        status, raw = self._request("GET", "/v1/segments")
        if status != 200:
            raise ReplicaError(f"replica {self.name}: HTTP {status} listing segments")
        try:
            return list(json.loads(raw.decode("utf-8"))["segments"])
        except (ValueError, KeyError, TypeError) as exc:
            raise ReplicaError(f"replica {self.name}: bad segment listing") from exc

    def fetch_segment(self, name: str) -> bytes:
        status, raw = self._request(
            "GET", "/v1/segments/" + urllib.parse.quote(name)
        )
        if status != 200:
            raise ReplicaError(f"replica {self.name}: HTTP {status} for segment {name}")
        return raw

    def push_segment(self, name: str, data: bytes) -> dict:
        status, raw = self._request(
            "POST", "/v1/segments/" + urllib.parse.quote(name), body=data
        )
        if status != 200:
            raise ReplicaError(f"replica {self.name}: HTTP {status} pushing {name}")
        try:
            return json.loads(raw.decode("utf-8"))
        except ValueError:
            return {}

    def fetch_block(self, cid: CID) -> Optional[bytes]:
        """One block from the peer's LOCAL tiers (the route never touches
        the peer's upstream — repair must not launder a Lotus fetch
        through a neighbour). None on a peer-side miss."""
        status, raw = self._request(
            "GET", "/v1/blocks/" + urllib.parse.quote(str(cid))
        )
        if status == 404:
            return None
        if status != 200:
            raise ReplicaError(f"replica {self.name}: HTTP {status} for block {cid}")
        return raw


class ReplicaSet:
    """The read-repair peers of one shard, tried in order.

    `repair` is called by the tiered store when a LOCAL frame failed
    CRC/multihash — the one case where a peer almost certainly holds the
    bytes and the upstream fetch it saves is pure waste."""

    def __init__(
        self, peers: "Sequence[ReplicaClient]" = (), metrics: Optional[Metrics] = None
    ):
        self._metrics = metrics if metrics is not None else get_metrics()
        self.peers: "List[ReplicaClient]" = list(peers)

    def set_peers(self, peers: "Sequence[ReplicaClient]") -> None:
        self.peers = list(peers)

    def __len__(self) -> int:
        return len(self.peers)

    def repair(self, cid: CID) -> Optional[bytes]:
        """Fetch + re-verify one block from the first peer that has it.
        Peer failure is fail-soft (next peer); unverifiable bytes are a
        miss from that peer, never served. Returns verified bytes or
        None (``storex.replica_repair_misses``)."""
        for peer in self.peers:
            try:
                data = peer.fetch_block(cid)
            except ReplicaError:
                continue  # fail-soft: a dead peer is the next peer's problem
            if data is not None and verify_block_bytes(cid, data):
                self._metrics.count("storex.replica_repairs")
                return data
        self._metrics.count("storex.replica_repair_misses")
        return None


class Replicator:
    """Pull-based segment sync onto a local `SegmentStore`."""

    def __init__(self, store: SegmentStore, metrics: Optional[Metrics] = None):
        self._store = store
        self._metrics = metrics if metrics is not None else get_metrics()

    def sync_from(
        self,
        peer: ReplicaClient,
        owners: "Optional[Sequence[str]]" = None,
        max_bytes: Optional[int] = None,
    ) -> dict:
        """Pull every non-active segment ``peer`` holds that we don't,
        optionally restricted to an owner-token set (the ring arcs this
        shard replicates). Returns ``{pulled, bytes, blocks, pending}``;
        ``pending`` > 0 means a ``max_bytes`` budget stopped the pass
        early (the gauge ``storex.replica_pending_segments`` tracks it
        for the router's replication-lag view)."""
        remote = peer.list_segments()
        local = {d["name"] for d in self._store.segment_files()}
        own = self._store.owner
        todo = [
            s for s in remote
            if not s.get("active")
            and s["name"] not in local
            and (s.get("owner") or "") != own
            and (owners is None or (s.get("owner") or "") in owners)
        ]
        self._metrics.set_gauge("storex.replica_pending_segments", len(todo))
        pulled = nbytes = blocks = 0
        pending = len(todo)
        for s in todo:
            if max_bytes is not None and nbytes >= max_bytes:
                break
            data = peer.fetch_segment(s["name"])
            blocks += self._store.ingest_segment_file(s["name"], data)
            pulled += 1
            nbytes += len(data)
            pending -= 1
            self._metrics.count("storex.replica_segments_pulled")
            self._metrics.count("storex.replica_bytes_pulled", len(data))
            self._metrics.set_gauge("storex.replica_pending_segments", pending)
        return {"pulled": pulled, "bytes": nbytes, "blocks": blocks, "pending": pending}


class RebalanceJob:
    """One journaled segment handoff: push ``segments`` to ``dest``,
    SIGKILL-resumable, committed exactly once.

    Journal records (IPJ1, fsync per record)::

        {"kind": "plan",   "dest": ..., "segments": [...]}
        {"kind": "pushed", "segment": <name>}     # one per completed push
        {"kind": "commit"}

    ``push(name, data)`` delivers one segment file to the destination
    (HTTP via `ReplicaClient.push_segment` in production; a plain
    callable in the crashtest grid). `run` replays the journal first:
    already-pushed segments are skipped (pushes are idempotent — same
    file name, same bytes), a present ``commit`` makes the whole run a
    no-op. The SOURCE store keeps serving its copies until `run`
    returns True — dropping them (`SegmentStore.drop_segment`) is the
    caller's post-commit step, so mid-rebalance reads always have an
    owner."""

    def __init__(
        self,
        journal_path: str,
        dest: str,
        segments: "Sequence[str]",
        push: "Callable[[str, bytes], None]",
        read_segment: "Callable[[str], Optional[bytes]]",
        metrics: Optional[Metrics] = None,
    ):
        self.journal_path = journal_path
        self.dest = dest
        self.segments = list(segments)
        self._push = push
        self._read_segment = read_segment
        self._metrics = metrics if metrics is not None else get_metrics()
        self.committed = False

    @staticmethod
    def for_store(
        journal_path: str,
        store: SegmentStore,
        dest_peer: ReplicaClient,
        segments: "Sequence[str]",
        metrics: Optional[Metrics] = None,
    ) -> "RebalanceJob":
        """The production wiring: read from ``store``, push over HTTP."""

        def _read(name: str) -> Optional[bytes]:
            path = store.segment_path(name)
            if path is None:
                return None
            try:
                with open(path, "rb") as fh:
                    return fh.read()
            except OSError:
                return None

        return RebalanceJob(
            journal_path, dest_peer.name, segments,
            dest_peer.push_segment, _read, metrics=metrics,
        )

    def _replay(self) -> "tuple[set, bool, bool]":
        """(pushed names, committed, had_records) from the journal."""
        if not os.path.exists(self.journal_path):
            return set(), False, False
        records, good_offset, torn = read_journal(self.journal_path)
        if torn:
            # crash residue mid-append: truncate to the last good record
            # before the writer appends again (journal discipline)
            with open(self.journal_path, "r+b") as fh:
                fh.truncate(good_offset)
        pushed: set = set()
        committed = False
        for rec in records:
            kind = rec.get("kind") if isinstance(rec, dict) else None
            if kind == "plan":
                if rec.get("dest") != self.dest or rec.get("segments") != self.segments:
                    raise ReplicaError(
                        f"rebalance journal {self.journal_path} holds a "
                        f"different plan (dest {rec.get('dest')!r}) — refusing "
                        "to mix handoffs in one journal"
                    )
            elif kind == "pushed":
                pushed.add(rec.get("segment"))
            elif kind == "commit":
                committed = True
        return pushed, committed, bool(records)

    def run(self) -> bool:
        """Execute (or resume) the handoff; True iff committed."""
        try:
            pushed, committed, resumed = self._replay()
        except JournalError as exc:
            raise ReplicaError(f"rebalance journal corrupt: {exc}") from exc
        if committed:
            self.committed = True
            return True
        if resumed:
            self._metrics.count("storex.rebalance_resumes")
        writer = JournalWriter(self.journal_path, metrics=self._metrics)
        try:
            if not resumed:
                writer.append(
                    {"kind": "plan", "dest": self.dest, "segments": self.segments}
                )
            for name in self.segments:
                if name in pushed:
                    continue
                data = self._read_segment(name)
                if data is None:
                    raise ReplicaError(
                        f"rebalance source lost segment {name!r} before handoff"
                    )
                self._push(name, data)
                writer.append({"kind": "pushed", "segment": name})
                self._metrics.count("storex.rebalance_segments_pushed")
            writer.append({"kind": "commit"})
            self.committed = True
        finally:
            writer.close()
        return self.committed
