"""CIDv1 with dag-cbor/raw codecs and blake2b-256/sha2-256 multihashes.

Filecoin chain CIDs are CIDv1 / dag-cbor / blake2b-256; strings are
multibase base32-lower ("b" prefix), e.g. ``bafy2bza...``. The counterpart
of ``ipc_proofs_tpu.core.cid``: the dataclass below is the correctness
reference (``PurePythonCID``), and at import ``CID`` is rebound to the
native type of the port's ``ipc_torch_dagcbor_ext`` (same interface and
acceptance, C-slot construction), except under ``IPC_PROOFS_NO_NATIVE=1``.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from functools import total_ordering

from ipc_proofs_tpu_torch.core import _cid_native
from ipc_proofs_tpu_torch.core.hashes import blake2b_256, keccak256
from ipc_proofs_tpu_torch.core.varint import decode_uvarint_min, encode_uvarint

# codecs
DAG_CBOR = 0x71
RAW = 0x55

# multihash codes
BLAKE2B_256 = 0xB220
SHA2_256 = 0x12
KECCAK_256 = 0x1B
IDENTITY = 0x00

__all__ = [
    "CID",
    "DAG_CBOR",
    "RAW",
    "BLAKE2B_256",
    "SHA2_256",
    "KECCAK_256",
    "IDENTITY",
    "CID_TYPES",
    "PurePythonCID",
    "cids_from_strings",
    "cid_strings",
]

# RFC 4648 base32 via Python's C-level big-int parser/formatter: ~5x faster
# than base64.b32encode/b32decode.
_B32_ALPHABET = "abcdefghijklmnopqrstuvwxyz234567"
# int(x, 32) uses digits 0-9a-v; translate the (lowercase-only — multibase
# 'b' is base32-lower) RFC4648 alphabet onto them
_B32_TO_INT32 = str.maketrans(_B32_ALPHABET, "0123456789abcdefghijklmnopqrstuv")

# 10-bit → 2-char lookup halves the per-call loop length vs per-char
_B32_PAIRS = [a + b for a in _B32_ALPHABET for b in _B32_ALPHABET]


def _b32_encode_lower(data: bytes) -> str:
    nbits = len(data) * 8
    n_chars = (nbits + 4) // 5
    n_pairs = (n_chars + 1) // 2
    value = int.from_bytes(data, "big") << (n_pairs * 10 - nbits)
    pairs = _B32_PAIRS
    out = "".join(
        [pairs[(value >> s) & 1023] for s in range((n_pairs - 1) * 10, -1, -10)]
    )
    return out[:n_chars]


_B32_CHARSET = frozenset(_B32_ALPHABET)


def _b32_decode_lower(text: str) -> bytes:
    """STRICT base32-lower decode: every accepted string is the unique
    canonical encoding of its bytes (mixed case, non-canonical lengths and
    non-zero trailing bits are each rejected — each would let distinct
    strings decode to one CID)."""
    if not text:
        return b""
    # RFC 4648 unpadded lengths are ≡ {0,2,4,5,7} (mod 8); the others cannot
    # arise from encoding
    if len(text) % 8 in (1, 3, 6):
        raise ValueError(f"invalid base32 length {len(text)}")
    # membership check BEFORE the int parse: characters outside the
    # lowercase RFC alphabet that happen to be base-32 int digits
    # ('0','1','8','9', uppercase) would otherwise alias 'a', 'i', …
    if not _B32_CHARSET.issuperset(text):
        raise ValueError(f"non-base32 character in {text!r}")
    value = int(text.translate(_B32_TO_INT32), 32)
    nbits = len(text) * 5
    nbytes = nbits // 8
    if value & ((1 << (nbits - nbytes * 8)) - 1):
        raise ValueError(f"non-zero trailing bits in base32 {text!r}")
    return (value >> (nbits - nbytes * 8)).to_bytes(nbytes, "big")


def cids_from_strings(texts) -> "list[CID]":
    """Parse many CID strings in one C call (`CID.from_string` semantics,
    including every rejection); scalar in the pure-Python universe."""
    ext = _cid_native.load()
    if ext is not None:
        return ext.cids_from_strs(list(texts))
    return [CID.from_string(t) for t in texts]


def cid_strings(cids) -> "list[str]":
    """Render many CIDs as multibase strings in one C call (`CID.__str__`
    semantics); scalar in the pure-Python universe."""
    ext = _cid_native.load()
    if ext is not None:
        return ext.cid_strs([c.to_bytes() for c in cids])
    return [str(c) for c in cids]


@total_ordering
@dataclass(frozen=True)
class CID:
    """An immutable CIDv1 (version, codec, multihash code, digest)."""

    version: int
    codec: int
    mh_code: int
    digest: bytes

    # --- constructors ------------------------------------------------------

    @classmethod
    def _make(cls, version: int, codec: int, mh_code: int, digest: bytes) -> "CID":
        """Internal fast constructor: a frozen dataclass pays four
        ``object.__setattr__`` calls per init, which dominates bulk decode
        paths creating tens of thousands of CIDs per range."""
        out = object.__new__(cls)
        out.__dict__.update(
            version=version, codec=codec, mh_code=mh_code, digest=digest
        )
        return out

    @classmethod
    def hash_of(cls, data: bytes, codec: int = DAG_CBOR, mh_code: int = BLAKE2B_256) -> "CID":
        """CID of raw block bytes (the Filecoin chain default: blake2b-256)."""
        if mh_code == BLAKE2B_256:
            digest = blake2b_256(data)
        elif mh_code == SHA2_256:
            digest = hashlib.sha256(data).digest()
        elif mh_code == KECCAK_256:
            digest = keccak256(data)
        elif mh_code == IDENTITY:
            digest = data
        else:
            raise ValueError(f"unsupported multihash code {mh_code:#x}")
        return cls(1, codec, mh_code, digest)

    @classmethod
    def from_bytes(cls, raw: bytes) -> "CID":
        # fast paths: the two canonical chain forms — CIDv1 dag-cbor
        # blake2b-256 (every Filecoin chain block) and CIDv1 raw sha2-256.
        # On the fast paths ``raw`` is the canonical encoding by
        # construction (fixed minimal-varint prefixes), so it is stashed as
        # the to_bytes memo.
        if len(raw) == 38 and raw[1] == 0x71 and raw[:6] == b"\x01\x71\xa0\xe4\x02\x20":
            out = cls._make(1, DAG_CBOR, BLAKE2B_256, raw[6:])
        elif len(raw) == 38 and raw[:6] == b"\x01\x55\xa0\xe4\x02\x20":
            out = cls._make(1, RAW, BLAKE2B_256, raw[6:])
        elif len(raw) == 36 and raw[:4] == b"\x01\x55\x12\x20":
            out = cls._make(1, RAW, SHA2_256, raw[4:])
        else:
            version, off, minimal = decode_uvarint_min(raw)
            if version != 1:
                raise ValueError(f"unsupported CID version {version}")
            codec, off, m = decode_uvarint_min(raw, off)
            minimal &= m
            mh_code, off, m = decode_uvarint_min(raw, off)
            minimal &= m
            mh_len, off, m = decode_uvarint_min(raw, off)
            minimal &= m
            digest = raw[off : off + mh_len]
            if len(digest) != mh_len:
                raise ValueError("truncated CID multihash digest")
            if off + mh_len != len(raw):
                raise ValueError("trailing bytes after CID")
            # strict minimal varints: tolerating non-minimal encodings
            # would give one logical CID two byte forms
            if not minimal:
                raise ValueError("non-canonical CID byte encoding")
            out = cls._make(version, codec, mh_code, digest)
        # accepted ⇒ canonical encoding, so raw is safe to memoize
        out.__dict__["_bytes"] = bytes(raw)
        return out

    @classmethod
    def from_string(cls, text: str) -> "CID":
        if not text:
            raise ValueError("empty CID string")
        if text[0] != "b":
            raise ValueError(f"unsupported multibase prefix {text[0]!r} (base32 only)")
        raw = _b32_decode_lower(text[1:])
        out = cls.from_bytes(raw)
        # defense in depth at the STRING boundary where claims live
        if out.to_bytes() != raw:
            raise ValueError(f"non-canonical CID byte encoding in {text!r}")
        return out

    # --- serialization -----------------------------------------------------

    # precomputed varint prefixes for the canonical 32-byte-digest forms
    _PREFIXES = {
        (1, DAG_CBOR, BLAKE2B_256): b"\x01\x71\xa0\xe4\x02\x20",
        (1, RAW, BLAKE2B_256): b"\x01\x55\xa0\xe4\x02\x20",
        (1, RAW, SHA2_256): b"\x01\x55\x12\x20",
        (1, DAG_CBOR, SHA2_256): b"\x01\x71\x12\x20",
    }

    def to_bytes(self) -> bytes:
        cached = self.__dict__.get("_bytes")
        if cached is None:
            prefix = (
                self._PREFIXES.get((self.version, self.codec, self.mh_code))
                if len(self.digest) == 32
                else None
            )
            if prefix is not None:
                cached = prefix + self.digest
            else:
                cached = (
                    encode_uvarint(self.version)
                    + encode_uvarint(self.codec)
                    + encode_uvarint(self.mh_code)
                    + encode_uvarint(len(self.digest))
                    + self.digest
                )
            object.__setattr__(self, "_bytes", cached)  # frozen-safe memo
        return cached

    def __str__(self) -> str:
        cached = self.__dict__.get("_str")
        if cached is None:
            cached = "b" + _b32_encode_lower(self.to_bytes())
            object.__setattr__(self, "_str", cached)  # frozen-safe memo
        return cached

    def __repr__(self) -> str:
        return f"CID({str(self)})"

    def __lt__(self, other: "CID") -> bool:
        return self.to_bytes() < other.to_bytes()

    def __hash__(self) -> int:  # dataclass frozen gives eq; keep hash cheap
        cached = self.__dict__.get("_hash")
        if cached is None:
            cached = hash(self.digest)
            object.__setattr__(self, "_hash", cached)  # frozen-safe memo
        return cached


# --- native CID binding ----------------------------------------------------
# The port's dagcbor extension ships a C-slot CID type with this exact
# interface (constructor, classmethods, comparison and hash, the same strict
# canonical acceptance at the bytes and string boundaries). The dataclass
# above stays the reference (``PurePythonCID``); when the extension loads,
# ``CID`` IS the native type, so every constructor in the package gets
# C-slot construction. The binding goes through core._cid_native, not the
# backend package, so no module imported on the way captures the
# pure-Python class.

PurePythonCID = CID

_native = _cid_native.load()  # None only under IPC_PROOFS_NO_NATIVE=1
if _native is not None:
    CID = _native.CID  # type: ignore[misc]

# every type that IS a CID in this process: boundaries that accept
# caller-held CIDs (dagcbor.encode) recognise either implementation
CID_TYPES: "tuple[type, ...]" = (CID, PurePythonCID) if CID is not PurePythonCID else (CID,)
