"""Compressed witness framing: one generic-codec frame over the canonical
CID ordering.

The bundle's blocks are already deduplicated and sorted by raw CID
(the range drivers' merge law), which lays HAMT/AMT interior nodes of
the same tree adjacent in the byte stream — exactly the redundancy a
generic compressor bites on. The frame packs the blocks as::

    uvarint(len(cid_bytes)) cid_bytes uvarint(len(data)) data  ...

in canonical order, compresses the packed stream, and ALWAYS carries the
sha256 of the uncompressed packing (``uncompressed_digest``) so identity
stays checkable end-to-end: decompression that does not reproduce the
digest raises `WitnessIntegrityError`, never yields different blocks.

``zlib`` is the stdlib floor every host speaks; ``zstd`` rides the same
frame when the optional ``zstandard`` module is importable and is simply
absent from `supported_encodings()` otherwise (no new dependency is ever
required). ``identity`` means "no frame" and is the negotiation default.
"""

from __future__ import annotations

import base64
import hashlib
import zlib
from typing import List, Optional, Sequence

from ipc_proofs_tpu_torch.core.cid import CID
from ipc_proofs_tpu_torch.proofs.bundle import ProofBlock
from ipc_proofs_tpu_torch.utils.jsonstrict import strict_fields
from ipc_proofs_tpu_torch.utils.metrics import Metrics, get_metrics
from ipc_proofs_tpu_torch.witness.errors import (
    WitnessEncodingError,
    WitnessIntegrityError,
)

__all__ = [
    "IDENTITY",
    "compress_blocks",
    "decompress_blocks",
    "pack_blocks",
    "read_uvarint",
    "supported_encodings",
    "uvarint",
]

IDENTITY = "identity"

# strict accessors: a compressed frame arrives from the network on the
# verify path, so its fields are exactly as untrusted as a bundle's
_S = strict_fields("malformed witness frame")

try:  # optional codec — never a hard dependency
    import zstandard as _zstd  # type: ignore
except ImportError:  # pragma: no cover - host-dependent
    _zstd = None


def supported_encodings() -> "tuple[str, ...]":
    """Encodings this host can serve/expand, ``identity`` first."""
    out = (IDENTITY, "zlib")
    if _zstd is not None:  # pragma: no cover - host-dependent
        out = out + ("zstd",)
    return out


def uvarint(n: int) -> bytes:
    """LEB128 unsigned varint — the length prefix of this frame AND of
    the streaming wire's chunks (`witness/stream.py` reuses this codec so
    a stream decoder needs exactly one varint implementation)."""
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def read_uvarint(buf: bytes, pos: int) -> "tuple[int, int]":
    """Decode one `uvarint` at ``pos``; returns ``(value, next_pos)``.
    Truncated or >64-bit varints raise `WitnessIntegrityError` — frame
    and stream decoders share the same typed failure."""
    shift = 0
    value = 0
    while True:
        if pos >= len(buf):
            raise WitnessIntegrityError("truncated varint in witness frame")
        b = buf[pos]
        pos += 1
        value |= (b & 0x7F) << shift
        if not (b & 0x80):
            return value, pos
        shift += 7
        if shift > 63:
            raise WitnessIntegrityError("oversized varint in witness frame")


# historical private names (internal callers predate the public export)
_uvarint = uvarint
_read_uvarint = read_uvarint


def pack_blocks(blocks: Sequence[ProofBlock]) -> bytes:
    """The canonical uncompressed packing (blocks must already be in
    canonical CID order — the packer preserves, never sorts)."""
    parts: List[bytes] = []
    for b in blocks:
        raw = b.cid.to_bytes()
        parts.append(_uvarint(len(raw)))
        parts.append(raw)
        parts.append(_uvarint(len(b.data)))
        parts.append(b.data)
    return b"".join(parts)


def _unpack_blocks(packed: bytes) -> List[ProofBlock]:
    blocks: List[ProofBlock] = []
    pos = 0
    n = len(packed)
    while pos < n:
        clen, pos = _read_uvarint(packed, pos)
        if pos + clen > n:
            raise WitnessIntegrityError("truncated CID in witness frame")
        cid = CID.from_bytes(packed[pos : pos + clen])
        pos += clen
        dlen, pos = _read_uvarint(packed, pos)
        if pos + dlen > n:
            raise WitnessIntegrityError("truncated block data in witness frame")
        blocks.append(ProofBlock._make(cid, packed[pos : pos + dlen]))
        pos += dlen
    return blocks


def compress_blocks(
    blocks: Sequence[ProofBlock],
    encoding: str,
    metrics: Optional[Metrics] = None,
) -> dict:
    """Build one compressed frame object over ``blocks`` (canonical
    order), carrying the uncompressed digest."""
    metrics = metrics if metrics is not None else get_metrics()
    if encoding == "zlib":
        packed = pack_blocks(blocks)
        frame = zlib.compress(packed, 6)
    elif encoding == "zstd" and _zstd is not None:  # pragma: no cover - host-dependent
        packed = pack_blocks(blocks)
        frame = _zstd.ZstdCompressor().compress(packed)
    else:
        raise WitnessEncodingError(
            f"unsupported witness encoding {encoding!r} "
            f"(supported: {', '.join(supported_encodings())})"
        )
    metrics.count("witness.compressed_frames")
    return {
        "encoding": encoding,
        "frame": base64.b64encode(frame).decode("ascii"),
        "uncompressed_digest": hashlib.sha256(packed).hexdigest(),
        "n_blocks": len(blocks),
    }


def decompress_blocks(frame_obj: dict) -> List[ProofBlock]:
    """Expand one frame back to its block list; digest-checked, typed
    errors on unknown encodings and corrupt frames."""
    obj = _S.as_map(frame_obj, "witness frame")
    encoding = _S.as_str(_S.get(obj, "encoding", "witness frame"), "encoding")
    raw = _S.b64_strict(
        _S.as_str(_S.get(obj, "frame", "witness frame"), "frame"), "frame"
    )
    declared = _S.as_str(
        _S.get(obj, "uncompressed_digest", "witness frame"), "uncompressed_digest"
    )
    if encoding == "zlib":
        try:
            packed = zlib.decompress(raw)
        except zlib.error as exc:
            raise WitnessIntegrityError(f"corrupt zlib witness frame: {exc}")
    elif encoding == "zstd" and _zstd is not None:  # pragma: no cover - host-dependent
        try:
            packed = _zstd.ZstdDecompressor().decompress(raw)
        except _zstd.ZstdError as exc:
            raise WitnessIntegrityError(f"corrupt zstd witness frame: {exc}")
    else:
        raise WitnessEncodingError(
            f"unsupported witness encoding {encoding!r} "
            f"(supported: {', '.join(supported_encodings())})"
        )
    if hashlib.sha256(packed).hexdigest() != declared:
        raise WitnessIntegrityError(
            "witness frame bytes do not hash to uncompressed_digest"
        )
    return _unpack_blocks(packed)
