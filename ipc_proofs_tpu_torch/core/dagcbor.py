"""Canonical DAG-CBOR codec with tag-42 CID links (pure Python).

Canonical rules (RFC 8949 core deterministic encoding as profiled by DAG-CBOR):
- minimal-length integer heads everywhere;
- definite lengths only;
- map keys must be strings, sorted length-first then bytewise;
- CIDs encode as tag 42 wrapping a byte string of ``0x00 ++ cid-bytes``
  (the multibase identity prefix).

Python value mapping: int, bytes, str, bool, None, list/tuple, dict,
:class:`~ipc_proofs_tpu_torch.core.cid.CID`, float (f64, decode-tolerant).
The counterpart of ``ipc_proofs_tpu.core.dagcbor``: `decode` runs the
port's C decoder (``ipc_torch_dagcbor_ext``) and `decode_py`, the
pure-Python one, is its correctness reference and the decoder of the
``IPC_PROOFS_NO_NATIVE=1`` universe.
"""

from __future__ import annotations

import math
import struct
from contextlib import contextmanager
from typing import Any

from ipc_proofs_tpu_torch.core import _cid_native
from ipc_proofs_tpu_torch.core.cid import CID, CID_TYPES

__all__ = ["encode", "decode", "decode_py", "force_python_decoder"]

_MAJOR_UINT = 0
_MAJOR_NEGINT = 1
_MAJOR_BYTES = 2
_MAJOR_TEXT = 3
_MAJOR_ARRAY = 4
_MAJOR_MAP = 5
_MAJOR_TAG = 6
_MAJOR_SIMPLE = 7

_CID_TAG = 42


def _encode_head(major: int, value: int) -> bytes:
    if value < 24:
        return bytes([(major << 5) | value])
    if value < 0x100:
        return bytes([(major << 5) | 24, value])
    if value < 0x10000:
        return bytes([(major << 5) | 25]) + value.to_bytes(2, "big")
    if value < 0x100000000:
        return bytes([(major << 5) | 26]) + value.to_bytes(4, "big")
    if value < 0x10000000000000000:
        return bytes([(major << 5) | 27]) + value.to_bytes(8, "big")
    raise ValueError("integer too large for CBOR head")


def _encode_item(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(0xF6)
    elif obj is True:
        out.append(0xF5)
    elif obj is False:
        out.append(0xF4)
    elif isinstance(obj, CID_TYPES):  # either CID implementation
        out += _encode_head(_MAJOR_TAG, _CID_TAG)
        inner = b"\x00" + obj.to_bytes()
        out += _encode_head(_MAJOR_BYTES, len(inner))
        out += inner
    elif isinstance(obj, int):
        if obj >= 0:
            out += _encode_head(_MAJOR_UINT, obj)
        else:
            out += _encode_head(_MAJOR_NEGINT, -1 - obj)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        out += _encode_head(_MAJOR_BYTES, len(data))
        out += data
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        out += _encode_head(_MAJOR_TEXT, len(data))
        out += data
    elif isinstance(obj, (list, tuple)):
        out += _encode_head(_MAJOR_ARRAY, len(obj))
        for item in obj:
            _encode_item(item, out)
    elif isinstance(obj, dict):
        out += _encode_head(_MAJOR_MAP, len(obj))
        entries = []
        for key, value in obj.items():
            if not isinstance(key, str):
                raise TypeError(f"DAG-CBOR map keys must be strings, got {type(key)}")
            entries.append((key.encode("utf-8"), value))
        entries.sort(key=lambda kv: (len(kv[0]), kv[0]))
        for key_bytes, value in entries:
            out += _encode_head(_MAJOR_TEXT, len(key_bytes))
            out += key_bytes
            _encode_item(value, out)
    elif isinstance(obj, float):
        if not math.isfinite(obj):
            raise ValueError("DAG-CBOR forbids non-finite floats")
        out.append(0xFB)
        out += struct.pack(">d", obj)
    else:
        raise TypeError(f"cannot encode {type(obj)} as DAG-CBOR")


def encode(obj: Any) -> bytes:
    out = bytearray()
    _encode_item(obj, out)
    return bytes(out)


def _decode_head(data: bytes, pos: int) -> tuple[int, int, int]:
    if pos >= len(data):
        raise ValueError("truncated CBOR head")
    byte = data[pos]
    major = byte >> 5
    info = byte & 0x1F
    pos += 1
    if info < 24:
        return major, info, pos
    if info > 27:
        raise ValueError(
            f"indefinite/reserved CBOR length (info={info}) not allowed in DAG-CBOR"
        )
    extra = 1 << (info - 24)
    if pos + extra > len(data):
        raise ValueError("truncated CBOR head")
    return major, int.from_bytes(data[pos : pos + extra], "big"), pos + extra


# Nesting cap: malicious deeply nested input must raise ValueError, not
# exhaust the stack.
_MAX_DEPTH = 512


def _decode_item(data: bytes, pos: int, depth: int = 0) -> tuple[Any, int]:
    if depth >= _MAX_DEPTH:
        raise ValueError("CBOR nesting too deep")
    head_start = pos
    major, value, pos = _decode_head(data, pos)
    if major == _MAJOR_UINT:
        return value, pos
    if major == _MAJOR_NEGINT:
        return -1 - value, pos
    if major == _MAJOR_BYTES:
        end = pos + value
        if end > len(data):
            raise ValueError("truncated CBOR bytes")
        return bytes(data[pos:end]), end
    if major == _MAJOR_TEXT:
        end = pos + value
        if end > len(data):
            raise ValueError("truncated CBOR text")
        return data[pos:end].decode("utf-8"), end
    if major == _MAJOR_ARRAY:
        items = []
        for _ in range(value):
            item, pos = _decode_item(data, pos, depth + 1)
            items.append(item)
        return items, pos
    if major == _MAJOR_MAP:
        result: dict[str, Any] = {}
        for _ in range(value):
            key, pos = _decode_item(data, pos, depth + 1)
            if not isinstance(key, str):
                raise ValueError("DAG-CBOR map keys must be strings")
            val, pos = _decode_item(data, pos, depth + 1)
            result[key] = val
        return result, pos
    if major == _MAJOR_TAG:
        if value != _CID_TAG:
            raise ValueError(f"unsupported CBOR tag {value} (DAG-CBOR allows only 42)")
        inner, pos = _decode_item(data, pos, depth + 1)
        if not isinstance(inner, bytes) or not inner.startswith(b"\x00"):
            raise ValueError("tag-42 content must be identity-multibase CID bytes")
        return CID.from_bytes(inner[1:]), pos
    # simple values / floats (major 7): distinguish by the head's info bits
    info = data[head_start] & 0x1F
    if info == 27:  # f64 — `value` holds the raw 8-byte payload as an int
        return struct.unpack(">d", value.to_bytes(8, "big"))[0], pos
    if value == 20:
        return False, pos
    if value == 21:
        return True, pos
    if value == 22:
        return None, pos
    raise ValueError(f"unsupported CBOR simple value {value}")


def decode_py(data: bytes) -> Any:
    """The pure-Python decoder (correctness reference for the C extension)."""
    obj, pos = _decode_item(bytes(data), 0)
    if pos != len(data):
        raise ValueError(f"trailing bytes after CBOR item ({len(data) - pos} bytes)")
    return obj


_native: "object | None | bool" = False  # False = not resolved yet; None = pure-Python universe


def _resolve_native():
    global _native
    _native = _cid_native.load()
    return _native


def decode(data: bytes) -> Any:
    """Decode exactly one DAG-CBOR item; trailing bytes are an error. Runs
    the C extension (bulk witness and receipt decode are host hot loops)."""
    native = _native if _native is not False else _resolve_native()
    if native is not None:
        return native.decode(bytes(data))
    return decode_py(data)


@contextmanager
def force_python_decoder():
    """Route :func:`decode` through the pure-Python decoder for the
    duration, so a measurement of the scalar architecture means what it
    says."""
    global _native
    saved = _native
    _native = None
    try:
        yield
    finally:
        _native = saved
