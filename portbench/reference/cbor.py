"""Plain DAG-CBOR: the canonical encoder and a decoder, with CID links.

A frozen, independent copy of the encoding the Filecoin chain uses: minimal
integer heads, definite lengths, string map keys sorted length-first then
bytewise, and CID links as tag 42 over ``0x00 ++ cid-bytes``. A link is a
`Link` (a ``bytes`` subclass holding the binary CID), so it stays apart
from byte strings. Nothing here imports the program under test.
"""

from __future__ import annotations

__all__ = ["Link", "Encoded", "encode", "decode"]


class Link(bytes):
    """A CID link: the binary CID (version, codec, multihash)."""

    __slots__ = ()


class Encoded(bytes):
    """A value already encoded: its bytes go into the output as they are."""

    __slots__ = ()


def _head(major: int, value: int) -> bytes:
    if value < 24:
        return bytes([(major << 5) | value])
    if value < 0x100:
        return bytes([(major << 5) | 24, value])
    if value < 0x10000:
        return bytes([(major << 5) | 25]) + value.to_bytes(2, "big")
    if value < 0x100000000:
        return bytes([(major << 5) | 26]) + value.to_bytes(4, "big")
    return bytes([(major << 5) | 27]) + value.to_bytes(8, "big")


def _enc(obj, out: bytearray) -> None:
    if obj is None:
        out.append(0xF6)
    elif obj is True:
        out.append(0xF5)
    elif obj is False:
        out.append(0xF4)
    elif isinstance(obj, Encoded):
        out += obj
    elif isinstance(obj, Link):
        inner = b"\x00" + bytes(obj)
        out += b"\xd8\x2a" + _head(2, len(inner)) + inner
    elif isinstance(obj, int):
        out += _head(0, obj) if obj >= 0 else _head(1, -1 - obj)
    elif isinstance(obj, bytes):
        out += _head(2, len(obj)) + obj
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        out += _head(3, len(raw)) + raw
    elif isinstance(obj, (list, tuple)):
        out += _head(4, len(obj))
        for item in obj:
            _enc(item, out)
    elif isinstance(obj, dict):
        out += _head(5, len(obj))
        for key in sorted(obj, key=lambda k: (len(k.encode()), k.encode())):
            raw = key.encode("utf-8")
            out += _head(3, len(raw)) + raw
            _enc(obj[key], out)
    else:
        raise TypeError(f"cannot encode {type(obj).__name__}")


def encode(obj) -> bytes:
    out = bytearray()
    _enc(obj, out)
    return bytes(out)


def _dec(data: bytes, pos: int):
    byte = data[pos]
    major, info = byte >> 5, byte & 0x1F
    pos += 1
    if info < 24:
        value = info
    elif info <= 27:
        n = 1 << (info - 24)
        value = int.from_bytes(data[pos : pos + n], "big")
        if pos + n > len(data):
            raise ValueError("truncated head")
        pos += n
    else:
        raise ValueError("indefinite length")
    if major == 0:
        return value, pos
    if major == 1:
        return -1 - value, pos
    if major in (2, 3):
        end = pos + value
        if end > len(data):
            raise ValueError("truncated string")
        raw = data[pos:end]
        return (raw if major == 2 else raw.decode("utf-8")), end
    if major == 4:
        items = []
        for _ in range(value):
            item, pos = _dec(data, pos)
            items.append(item)
        return items, pos
    if major == 5:
        out = {}
        for _ in range(value):
            key, pos = _dec(data, pos)
            if not isinstance(key, str):
                raise ValueError("map key is not a string")
            out[key], pos = _dec(data, pos)
        return out, pos
    if major == 6:
        if value != 42:
            raise ValueError(f"tag {value}")
        inner, pos = _dec(data, pos)
        if not isinstance(inner, bytes) or inner[:1] != b"\x00":
            raise ValueError("bad link")
        return Link(inner[1:]), pos
    if value == 20:
        return False, pos
    if value == 21:
        return True, pos
    if value == 22:
        return None, pos
    raise ValueError(f"simple value {value}")


def decode(data: bytes):
    """Exactly one item; trailing bytes are an error."""
    obj, pos = _dec(data, 0)
    if pos != len(data):
        raise ValueError("trailing bytes")
    return obj
