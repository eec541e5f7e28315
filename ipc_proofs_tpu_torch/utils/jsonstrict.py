"""Strict JSON field accessors for the bundle and certificate parsers.

Proof bundles and F3 certificates arrive from untrusted sources. These
accessors reject every malformed field as ValueError — never leaking KeyError/TypeError from
shape assumptions. Byte fields decode base64 STRICTLY AND CANONICALLY, so
distinct JSON documents can never decode to one object.

Usage: bind the returned object's methods under local names so call
sites stay terse::

    _S = strict_fields("malformed proof bundle")
    _as_map, _get, _as_int = _S.as_map, _S.get, _S.as_int
"""

from __future__ import annotations

import base64
import binascii

__all__ = ["strict_fields", "StrictFields"]


class StrictFields:
    __slots__ = ("prefix",)

    def __init__(self, prefix: str):
        self.prefix = prefix

    def _err(self, msg: str) -> "ValueError":
        return ValueError(f"{self.prefix}: {msg}")

    def as_map(self, v, what: str) -> dict:
        if not isinstance(v, dict):
            raise self._err(f"{what} must be a JSON object")
        return v

    def get(self, obj: dict, key: str, what: str):
        if key not in obj:
            raise self._err(f"{what} missing field {key!r}")
        return obj[key]

    def as_int(self, v, what: str) -> int:
        if not isinstance(v, int) or isinstance(v, bool):
            raise self._err(f"{what} must be an integer")
        return v

    def as_str(self, v, what: str) -> str:
        if not isinstance(v, str):
            raise self._err(f"{what} must be a string")
        return v

    def as_list(self, v, what: str) -> list:
        if not isinstance(v, list):
            raise self._err(f"{what} must be a list")
        return v

    def as_str_list(self, v, what: str) -> list:
        if not isinstance(v, list) or not all(isinstance(s, str) for s in v):
            raise self._err(f"{what} must be a list of strings")
        return v

    def b64_strict(self, v: str, what: str) -> bytes:
        """Strict AND canonical base64: the input must round-trip —
        rejecting discarded garbage characters and non-zero trailing
        padding bits alike."""
        try:
            out = base64.b64decode(v, validate=True)
        except binascii.Error as exc:
            raise self._err(f"{what} bad base64 ({exc})") from None
        if base64.b64encode(out).decode("ascii") != v:
            raise self._err(f"{what} non-canonical base64")
        return out


    def as_bytes(self, v, what: str) -> bytes:
        if isinstance(v, (bytes, bytearray)):
            return bytes(v)
        if isinstance(v, str):  # Forest/bundle JSON byte encoding
            return self.b64_strict(v, what)
        if isinstance(v, list) and all(
            isinstance(b, int) and not isinstance(b, bool) and 0 <= b < 256
            for b in v
        ):
            return bytes(v)
        raise self._err(f"{what} must be bytes")

    def as_cid_str(self, v, what: str) -> str:
        if isinstance(v, dict):  # Lotus/Forest {"/": "<cid>"} form
            v = v.get("/")
        if not isinstance(v, str):
            raise self._err(f"{what} must be a CID string")
        return v


def strict_fields(prefix: str) -> StrictFields:
    return StrictFields(prefix)
