"""Chunked binary bundle streaming: the zero-copy serve wire.

The counterpart of ``ipc_proofs_tpu.witness.stream``: the compressed
witness framing makes bundles small; this module makes them CHEAP TO MOVE. A streamed response
(``Accept: application/x-ipc-bundle-stream``, or ``"stream": true`` in
the request body) replaces the buffered JSON body with a typed chunk
stream whose block section is raw bytes — on a disk-warm daemon those
bytes are ``memoryview`` slices straight out of `SegmentStore`'s
CRC-framed segments (`read_frame_slice`), handed to the socket without
ever being copied through Python.

Wire layout::

    MAGIC  4 bytes  b"IPBS"           (once, at stream start)
    chunk  u8 kind | uvarint(len) | payload   ...repeated...

One response *document* is ``H`` … ``T``; a stream carries one document
(``/v1/generate``, ``/v1/generate_range``) or several
(``/v1/backfill`` chunk streaming). Kinds:

- ``H`` (0x48) — header JSON: the response fields known before the block
  bytes move (``witness_encoding``, ``digest`` when precomputed, claims,
  trace id, …).
- ``B`` (0x42) — one witness block, exactly one `pack_blocks` entry:
  ``uvarint(cid_len) cid_raw uvarint(data_len) data``. Emitted in
  whatever order the producer reaches them (a router emits each shard's
  blocks as that shard answers); the decoder dedups by raw CID and
  restores canonical order by sorting — the same merge law the range
  drivers seal with.
- ``F`` (0x46) — a compressed ``blocks_frame`` object (JSON), for
  non-identity encodings: the frame already carries its own
  ``uncompressed_digest``.
- ``D`` (0x44) — a ``bundle_delta`` object (JSON), for delta responses.
- ``T`` (0x54) — trailer JSON: closes the document. Carries the proof
  sections (``storage_proofs`` / ``event_proofs`` — lightweight relative
  to blocks, and a router only knows their merged order after the last
  shard lands) plus any remaining response fields (``server_timing``
  with its ``stream_ms`` component, the sealed ``digest`` when it was
  not known at header time).
- ``E`` (0x45) — typed in-band abort: by the time a mid-stream failure
  happens the 200 status line is already on the wire, so the error
  travels as a chunk and the decoder raises `StreamAbortError` — the
  byte-identical-or-typed-error invariant, continued past the point
  where HTTP status codes can carry it.

The decoder (`decode_bundle_stream` / `decode_bundle_stream_docs`)
reassembles the exact response-fields dict the buffered JSON body would
have parsed to — for identity documents it additionally re-derives the
bundle's canonical digest and checks it against the declared one, so a
reassembled stream is BYTE-IDENTICAL to the buffered bundle or fails
typed (`WitnessIntegrityError`). The chunks are byte-identical to the
reference package's, and each package decodes the other's.
"""

from __future__ import annotations

import base64
import json
import time
from typing import Callable, List, Optional, Sequence

from ipc_proofs_tpu_torch.core.cid import CID
from ipc_proofs_tpu_torch.proofs.bundle import (
    ProofBlock,
    UnifiedProofBundle,
    bundle_obj_digest,
)
from ipc_proofs_tpu_torch.utils.metrics import Metrics, get_metrics
from ipc_proofs_tpu_torch.witness.bases import WitnessBaseCache
from ipc_proofs_tpu_torch.witness.delta import encode_delta
from ipc_proofs_tpu_torch.witness.errors import (
    StreamAbortError,
    WitnessEncodingError,
    WitnessIntegrityError,
)
from ipc_proofs_tpu_torch.witness.framing import (
    IDENTITY,
    compress_blocks,
    read_uvarint,
    uvarint,
)
from ipc_proofs_tpu_torch.witness.wire import WitnessOptions

__all__ = [
    "CHUNKED_TERMINATOR",
    "STREAM_CONTENT_TYPE",
    "STREAM_MAGIC",
    "BundleStreamWriter",
    "decode_bundle_stream",
    "decode_bundle_stream_docs",
    "iter_stream_chunks",
    "negotiate_stream",
    "parse_block_chunk",
    "send_buffers",
    "stream_backfill_chunks",
    "stream_bundle_doc",
]

STREAM_CONTENT_TYPE = "application/x-ipc-bundle-stream"
STREAM_MAGIC = b"IPBS"

CHUNK_HEADER = 0x48  # 'H'
CHUNK_BLOCK = 0x42  # 'B'
CHUNK_FRAME = 0x46  # 'F'
CHUNK_DELTA = 0x44  # 'D'
CHUNK_TRAILER = 0x54  # 'T'
CHUNK_ERROR = 0x45  # 'E'


def negotiate_stream(body: dict, headers=None) -> bool:
    """True when the request asked for the chunked binary stream wire:
    body ``{"stream": true}`` (wins) or an ``Accept`` header naming
    ``application/x-ipc-bundle-stream``. A non-boolean body field is a
    typed 400, same contract as ``witness_encoding``."""
    want = body.get("stream")
    if want is not None and not isinstance(want, bool):
        raise WitnessEncodingError("stream must be a boolean")
    if want is None and headers is not None:
        accept = headers.get("Accept") or ""
        want = STREAM_CONTENT_TYPE in accept
    return bool(want)


def _json_bytes(obj: dict) -> bytes:
    return json.dumps(obj, separators=(",", ":")).encode("utf-8")


CHUNKED_TERMINATOR = b"0\r\n\r\n"  # closes an HTTP/1.1 chunked body


def send_buffers(sock, buffers) -> None:
    """One HTTP/1.1 transfer chunk from a scatter-gather buffer list,
    written straight to ``sock``: ``hex(len) CRLF [buffers...] CRLF``.

    ``socket.sendmsg`` takes the buffer list as-is, so a memoryview block
    payload (a `SegmentStore` mmap slice) goes mmap → kernel without ever
    materializing in Python — the zero-copy half of the streaming wire.
    The fallback loop uses ``sendall`` per buffer, which is also
    copy-free for a memoryview."""
    total = sum(len(b) for b in buffers)
    if total == 0:
        return
    views: list = [memoryview(b"%x\r\n" % total)]
    views.extend(
        b if isinstance(b, memoryview) else memoryview(b) for b in buffers
    )
    views.append(memoryview(b"\r\n"))
    sendmsg = getattr(sock, "sendmsg", None)
    if sendmsg is None:
        for v in views:
            sock.sendall(v)
        return
    while views:
        sent = sendmsg(views)
        # walk past fully-sent buffers; re-slice the partial one
        while views and sent >= len(views[0]):
            sent -= len(views[0])
            views.pop(0)
        if views and sent:
            views[0] = views[0][sent:]


class BundleStreamWriter:
    """Encode response documents as IPBS chunks over a ``send`` callable.

    ``send`` receives a list of buffers (bytes and/or memoryview) to put
    on the wire in order — the HTTP front end backs it with
    ``socket.sendmsg`` scatter-gather so a memoryview block payload goes
    from the segment mmap to the kernel without an intermediate copy.

    The writer keeps honest copy accounting: ``zero_copy_bytes`` counts
    block payload handed over as memoryview slices (mmap-backed, never
    materialized in Python), ``copied_block_bytes`` counts block payload
    that had to travel as ``bytes`` (cold store, eviction fallback,
    router re-emission). These feed the ``serve.stream.*`` counters and
    the bench's ``warm_block_bytes_copied_per_resp`` gate.
    """

    def __init__(self, send: Callable, metrics: Optional[Metrics] = None):
        self._send = send
        self._metrics = metrics if metrics is not None else get_metrics()
        self._started = False
        self._doc_t0 = time.monotonic()
        self.bytes_sent = 0
        self.zero_copy_bytes = 0
        self.copied_block_bytes = 0

    def _emit(self, kind: int, *payload: "Sequence[bytes | memoryview]") -> None:
        total = sum(len(p) for p in payload)
        bufs: list = []
        if not self._started:
            self._started = True
            bufs.append(STREAM_MAGIC)
        bufs.append(bytes([kind]) + uvarint(total))
        bufs.extend(payload)
        self._send(bufs)
        self.bytes_sent += sum(len(b) for b in bufs)

    def begin(self, fields: dict) -> None:
        self._doc_t0 = time.monotonic()  # stream_ms clock is per document
        self._emit(CHUNK_HEADER, _json_bytes(fields))

    def block(self, cid_raw: bytes, data) -> None:
        """One witness block; ``data`` is bytes (copied path) or a
        memoryview (zero-copy segment slice)."""
        prefix = uvarint(len(cid_raw)) + cid_raw + uvarint(len(data))
        if isinstance(data, memoryview):
            self.zero_copy_bytes += len(data)
            self._metrics.count("serve.stream.zero_copy_bytes", len(data))
        else:
            self.copied_block_bytes += len(data)
            self._metrics.count("serve.stream.copied_bytes", len(data))
        self._emit(CHUNK_BLOCK, prefix, data)

    def frame_obj(self, frame: dict) -> None:
        self._emit(CHUNK_FRAME, _json_bytes(frame))

    def delta_obj(self, delta: dict) -> None:
        self._emit(CHUNK_DELTA, _json_bytes(delta))

    def end(self, fields: dict) -> None:
        """Trailer. A ``server_timing`` dict in ``fields`` gains its
        ``stream_ms`` component here — measured header→trailer, so the
        breakdown keeps summing to the admission→completion wall that
        the buffered path's components already cover up to response
        hand-off."""
        timing = fields.get("server_timing")
        if isinstance(timing, dict):
            timing = dict(timing)
            timing["stream_ms"] = round(
                (time.monotonic() - self._doc_t0) * 1e3, 3
            )
            fields = dict(fields, server_timing=timing)
        self._emit(CHUNK_TRAILER, _json_bytes(fields))

    def error(self, message: str, error_type: str = "internal") -> None:
        """In-band typed abort (the 200 status line is already gone)."""
        self._metrics.count("serve.stream.aborts")
        self._emit(CHUNK_ERROR, _json_bytes({"error": message, "error_type": error_type}))


def stream_bundle_doc(
    writer: BundleStreamWriter,
    bundle: UnifiedProofBundle,
    opts: WitnessOptions,
    bases: Optional[WitnessBaseCache] = None,
    metrics: Optional[Metrics] = None,
    digest: Optional[str] = None,
    claims: Optional[Sequence[dict]] = None,
    head_extra: Optional[dict] = None,
    tail_extra: Optional[dict] = None,
    slicer: Optional[Callable] = None,
) -> str:
    """Stream ONE response document equivalent to
    `wire.encode_bundle_fields` under the same negotiated options — the
    differential grid pins the equivalence. ``slicer`` maps a block CID
    to a zero-copy memoryview (or None → the in-memory bytes are sent,
    counted as copied). Returns the bundle digest.

    Delta/compressed documents reuse the exact encoder calls of the
    buffered path (`encode_delta` / `compress_blocks`), so their bytes
    cannot drift; only the identity block section takes the zero-copy
    lane.
    """
    metrics = metrics if metrics is not None else get_metrics()
    if digest is None:
        digest = bundle.digest()
    if bases is not None:
        bases.register(digest, bundle.cid_set())
    head = {"witness_encoding": opts.encoding, "digest": digest}
    if claims is not None:
        head["claims"] = list(claims)
    if head_extra:
        head.update(head_extra)
    tail: dict = dict(tail_extra) if tail_extra else {}

    base_cids = None
    if opts.base_digest is not None:
        base_cids = bases.lookup(opts.base_digest) if bases is not None else None
        if base_cids is None:
            metrics.count("witness.delta_fallbacks")

    if base_cids is not None:
        dobj = encode_delta(
            bundle, base_cids, opts.base_digest, digest=digest, metrics=metrics
        )
        metrics.count("witness.delta_hits")
        if opts.encoding != IDENTITY:
            frame = compress_blocks(
                [ProofBlock.from_json_obj(b) for b in dobj.pop("delta_blocks")],
                opts.encoding,
                metrics=metrics,
            )
            dobj["delta_blocks_frame"] = frame
        head["witness_base"] = opts.base_digest
        writer.begin(head)
        writer.delta_obj(dobj)
        writer.end(tail)
        return digest

    if opts.encoding != IDENTITY:
        frame = compress_blocks(bundle.blocks, opts.encoding, metrics=metrics)
        writer.begin(head)
        writer.frame_obj(frame)
    else:
        writer.begin(head)
        for b in bundle.blocks:
            sl = slicer(b.cid) if slicer is not None else None
            writer.block(b.cid.to_bytes(), sl if sl is not None else b.data)
    tail["storage_proofs"] = [p.to_json_obj() for p in bundle.storage_proofs]
    tail["event_proofs"] = [p.to_json_obj() for p in bundle.event_proofs]
    writer.end(tail)
    return digest


def stream_backfill_chunks(
    writer: BundleStreamWriter,
    out: dict,
    slicer: Optional[Callable] = None,
    envelope: bool = True,
) -> None:
    """The multi-document form of a backfill chunk poll: one identity
    document per result chunk, closed by a metadata-only envelope
    document carrying the poll fields (``job_id`` / ``state`` /
    ``cursor`` / ``acked``). Shared by the single-daemon and router
    backfill doors — the only difference is the ``slicer`` (a daemon
    with a warm segment tier slices block payloads zero-copy; a router
    re-emits the journal bytes, counted as copied). ``envelope=False``
    leaves the closing envelope out (the caller ends the stream with an
    abort chunk instead)."""
    chunks = out.get("chunks") or []
    meta = {k: v for k, v in out.items() if k != "chunks"}
    for c in chunks:
        obj = c.get("bundle")
        head = {k: v for k, v in c.items() if k != "bundle"}
        head["job_id"] = meta.get("job_id")
        if obj is None:
            # payload already dropped from memory (the journal keeps the
            # bytes) — ship the metadata document only
            writer.begin(head)
            writer.end({})
            continue
        # the chunk's own digest is the resume CHECKPOINT id (spec + pair
        # window), not a content hash — rename it so ``digest`` can carry
        # the canonical bundle digest the decoder re-derives from the
        # reassembled blocks
        head["chunk_digest"] = head.pop("digest", None)
        head["witness_encoding"] = "identity"
        head["digest"] = bundle_obj_digest(obj)
        writer.begin(head)
        for b in obj["blocks"]:
            cid = CID.parse(b["cid"])
            sl = slicer(cid) if slicer is not None else None
            writer.block(
                cid.to_bytes(),
                sl if sl is not None else base64.b64decode(b["data"]),
            )
        writer.end(
            {
                "storage_proofs": obj["storage_proofs"],
                "event_proofs": obj["event_proofs"],
            }
        )
    if envelope:
        writer.begin(meta)
        writer.end({})


# -- decoding (the client half) -------------------------------------------


def _iter_chunks(raw: bytes, pos: int):
    n = len(raw)
    while pos < n:
        kind = raw[pos]
        length, pos = read_uvarint(raw, pos + 1)
        if pos + length > n:
            raise WitnessIntegrityError("truncated chunk in bundle stream")
        yield kind, raw[pos : pos + length]
        pos += length


def _read_exact(fp, n: int) -> bytes:
    out = b""
    while len(out) < n:
        got = fp.read(n - len(out))
        if not got:
            raise WitnessIntegrityError("bundle stream truncated mid-chunk")
        out += got
    return out


def iter_stream_chunks(fp):
    """Incremental chunk iterator over a FILE-LIKE stream — the relay
    half of the cut-through router: chunks are parsed (and can be
    forwarded) the moment they arrive, never buffering more than one
    chunk's payload. Yields ``(kind, payload)``; a clean EOF between
    chunks ends the iteration, EOF inside a chunk (the producer died
    mid-write) raises `WitnessIntegrityError`."""
    magic = _read_exact(fp, len(STREAM_MAGIC))
    if magic != STREAM_MAGIC:
        raise WitnessIntegrityError("not a bundle stream (bad magic)")
    while True:
        head = fp.read(1)
        if not head:
            return
        # uvarint, byte-at-a-time (can't over-read a live socket)
        length = 0
        shift = 0
        while True:
            b = _read_exact(fp, 1)[0]
            length |= (b & 0x7F) << shift
            if not (b & 0x80):
                break
            shift += 7
            if shift > 63:
                raise WitnessIntegrityError(
                    "uvarint overflow in bundle stream"
                )
        yield head[0], _read_exact(fp, length)


def parse_block_chunk(payload: bytes) -> "tuple[bytes, bytes]":
    """Split one ``B`` chunk payload into ``(cid_raw, data)`` (the
    ``uvarint(cid_len) cid_raw uvarint(data_len) data`` layout)."""
    clen, pos = read_uvarint(payload, 0)
    if pos + clen > len(payload):
        raise WitnessIntegrityError("truncated CID in bundle stream block")
    cid_raw = payload[pos : pos + clen]
    pos += clen
    dlen, pos = read_uvarint(payload, pos)
    if pos + dlen != len(payload):
        raise WitnessIntegrityError("truncated data in bundle stream block")
    return cid_raw, payload[pos:]


class _DocState:
    """One in-flight document between its H and T chunks."""

    def __init__(self, header: dict):
        self.fields = dict(header)
        self.blocks: "dict[bytes, bytes]" = {}
        self.saw_blocks = False
        self.frame: Optional[dict] = None
        self.delta: Optional[dict] = None

    def add_block(self, payload: bytes) -> None:
        self.saw_blocks = True
        cid_raw, data = parse_block_chunk(payload)
        prev = self.blocks.get(cid_raw)
        if prev is not None and prev != data:
            # the one duplicate the merge law forbids: same CID, different
            # bytes — scatter parts disagree, nothing sound to serve
            raise WitnessIntegrityError(
                "bundle stream carries conflicting bytes for one CID"
            )
        self.blocks[cid_raw] = data

    def seal(self, trailer: dict) -> dict:
        fields = self.fields
        proofs_keys = ("storage_proofs", "event_proofs")
        tr = dict(trailer)
        proofs = {k: tr.pop(k, None) for k in proofs_keys}
        fields.update(tr)
        if self.delta is not None:
            fields["bundle_delta"] = self.delta
            return fields
        if self.frame is not None:
            fields["bundle"] = {
                "storage_proofs": proofs["storage_proofs"] or [],
                "event_proofs": proofs["event_proofs"] or [],
                "blocks_frame": self.frame,
            }
            return fields
        if (
            not self.saw_blocks
            and proofs["storage_proofs"] is None
            and proofs["event_proofs"] is None
        ):
            # metadata-only document: no block/frame/delta section and no
            # proof sections in the trailer — pure JSON fields (the
            # backfill poll envelope, or a chunk whose payload already
            # dropped from memory)
            return fields
        # identity document: restore canonical block order (sort by raw
        # CID — the seal law) and re-derive the digest end-to-end
        obj = {
            "storage_proofs": proofs["storage_proofs"] or [],
            "event_proofs": proofs["event_proofs"] or [],
            "blocks": [
                {
                    "cid": str(CID.from_bytes(raw)),
                    "data": base64.b64encode(data).decode("ascii"),
                }
                for raw, data in sorted(self.blocks.items())
            ],
        }
        declared = fields.get("digest")
        if not isinstance(declared, str) or bundle_obj_digest(obj) != declared:
            raise WitnessIntegrityError(
                "reassembled bundle stream does not hash to its declared digest"
            )
        fields["bundle"] = obj
        return fields


def decode_bundle_stream_docs(raw: bytes) -> List[dict]:
    """Parse a complete IPBS stream into its response-fields documents —
    each dict is exactly what the buffered JSON body would have parsed
    to (feed it to `wire.expand_response_fields`). Typed errors
    throughout; an ``E`` chunk raises `StreamAbortError` carrying the
    server's in-band ``error_type``."""
    if raw[:4] != STREAM_MAGIC:
        raise WitnessIntegrityError("bundle stream does not start with IPBS magic")
    docs: List[dict] = []
    doc: Optional[_DocState] = None
    for kind, payload in _iter_chunks(raw, 4):
        if kind == CHUNK_ERROR:
            obj = _json_obj(payload)
            raise StreamAbortError(
                str(obj.get("error", "stream aborted")),
                remote_error_type=str(obj.get("error_type", "internal")),
            )
        if kind == CHUNK_HEADER:
            if doc is not None:
                raise WitnessIntegrityError("bundle stream header inside open document")
            doc = _DocState(_json_obj(payload))
            continue
        if doc is None:
            raise WitnessIntegrityError("bundle stream chunk outside a document")
        if kind == CHUNK_BLOCK:
            doc.add_block(payload)
        elif kind == CHUNK_FRAME:
            doc.frame = _json_obj(payload)
        elif kind == CHUNK_DELTA:
            doc.delta = _json_obj(payload)
        elif kind == CHUNK_TRAILER:
            docs.append(doc.seal(_json_obj(payload)))
            doc = None
        else:
            raise WitnessIntegrityError(
                f"unknown bundle stream chunk kind 0x{kind:02x}"
            )
    if doc is not None:
        raise WitnessIntegrityError("bundle stream ended inside an open document")
    return docs


def decode_bundle_stream(raw: bytes) -> dict:
    """The single-document form (`/v1/generate`, `/v1/generate_range`)."""
    docs = decode_bundle_stream_docs(raw)
    if len(docs) != 1:
        raise WitnessIntegrityError(
            f"expected one bundle stream document, got {len(docs)}"
        )
    return docs[0]


def _json_obj(payload: bytes) -> dict:
    try:
        obj = json.loads(payload.decode("utf-8"))
    except (ValueError, UnicodeDecodeError) as exc:
        raise WitnessIntegrityError(f"malformed JSON chunk in bundle stream: {exc}")
    if not isinstance(obj, dict):
        raise WitnessIntegrityError("bundle stream JSON chunk is not an object")
    return obj
