"""Filecoin addresses: ID / secp / actor / BLS / delegated (f410 EVM).

Replaces `fvm_shared::address` as used by the reference
(`src/proofs/common/address.rs`, `src/proofs/common/decode.rs:34`).

Byte form (the state-tree HAMT key): ``protocol_byte ++ payload`` where
payload is a uvarint actor ID (protocol 0), a raw hash (1/2/3), or
``uvarint(namespace) ++ subaddress`` (protocol 4).

String form: ``f``/``t`` + protocol digit + base32-lower(payload ++ checksum)
with checksum = blake2b-4 over ``protocol_byte ++ payload``; ID addresses use
the decimal id; delegated use ``f4<namespace>f<base32>``.
"""

from __future__ import annotations

import base64
import hashlib
from dataclasses import dataclass
from enum import IntEnum

from ipc_proofs_tpu_torch.core.varint import decode_uvarint, encode_uvarint

__all__ = ["Address", "Protocol", "EAM_NAMESPACE"]

EAM_NAMESPACE = 10  # the Ethereum Address Manager actor: f410 addresses


class Protocol(IntEnum):
    ID = 0
    SECP256K1 = 1
    ACTOR = 2
    BLS = 3
    DELEGATED = 4


_PAYLOAD_SIZES = {Protocol.SECP256K1: 20, Protocol.ACTOR: 20, Protocol.BLS: 48}


def _checksum(data: bytes) -> bytes:
    return hashlib.blake2b(data, digest_size=4).digest()


def _b32(data: bytes) -> str:
    return base64.b32encode(data).decode("ascii").rstrip("=").lower()


def _b32_decode(text: str) -> bytes:
    pad = (-len(text)) % 8
    return base64.b32decode(text.upper() + "=" * pad)


@dataclass(frozen=True)
class Address:
    protocol: Protocol
    payload: bytes  # uvarint(id) for ID; raw hash; uvarint(ns)+sub for delegated

    # --- constructors ------------------------------------------------------

    @classmethod
    def new_id(cls, actor_id: int) -> "Address":
        return cls(Protocol.ID, encode_uvarint(actor_id))

    @classmethod
    def new_delegated(cls, namespace: int, subaddress: bytes) -> "Address":
        return cls(Protocol.DELEGATED, encode_uvarint(namespace) + subaddress)

    @classmethod
    def from_eth_address(cls, eth_addr: "str | bytes") -> "Address":
        """f410 delegated address for a 20-byte EVM address."""
        if isinstance(eth_addr, str):
            eth_addr = bytes.fromhex(eth_addr.removeprefix("0x"))
        if len(eth_addr) != 20:
            raise ValueError(f"EVM address must be 20 bytes, got {len(eth_addr)}")
        return cls.new_delegated(EAM_NAMESPACE, eth_addr)

    @classmethod
    def from_bytes(cls, raw: bytes) -> "Address":
        if not raw:
            raise ValueError("empty address bytes")
        protocol = Protocol(raw[0])
        payload = raw[1:]
        cls._validate(protocol, payload)
        return cls(protocol, payload)

    @classmethod
    def from_string(cls, text: str) -> "Address":
        """Parse ``f…``/``t…`` addresses (testnet prefix normalized away,
        like the reference's `parse_address`, `common/address.rs:65-77`)."""
        if len(text) < 2 or text[0] not in "ft":
            raise ValueError(f"invalid address string {text!r}")
        proto_char = text[1]
        body = text[2:]
        if proto_char == "0":
            return cls.new_id(int(body))
        if proto_char in "123":
            protocol = Protocol(int(proto_char))
            decoded = _b32_decode(body)
            payload, check = decoded[:-4], decoded[-4:]
            if _checksum(bytes([protocol]) + payload) != check:
                raise ValueError(f"address checksum mismatch in {text!r}")
            cls._validate(protocol, payload)
            return cls(protocol, payload)
        if proto_char == "4":
            ns_str, sep, sub_str = body.partition("f")
            if not sep:
                raise ValueError(f"malformed delegated address {text!r}")
            namespace = int(ns_str)
            decoded = _b32_decode(sub_str)
            subaddress, check = decoded[:-4], decoded[-4:]
            payload = encode_uvarint(namespace) + subaddress
            if _checksum(bytes([Protocol.DELEGATED]) + payload) != check:
                raise ValueError(f"address checksum mismatch in {text!r}")
            return cls(Protocol.DELEGATED, payload)
        raise ValueError(f"unknown address protocol {proto_char!r}")

    @staticmethod
    def _validate(protocol: Protocol, payload: bytes) -> None:
        expected = _PAYLOAD_SIZES.get(protocol)
        if expected is not None and len(payload) != expected:
            raise ValueError(
                f"protocol {protocol.name} payload must be {expected} bytes, got {len(payload)}"
            )
        if protocol == Protocol.ID:
            decode_uvarint(payload)  # must be a single valid uvarint

    # --- accessors ---------------------------------------------------------

    def id(self) -> int:
        if self.protocol != Protocol.ID:
            raise ValueError(f"not an ID address: {self}")
        value, offset = decode_uvarint(self.payload)
        if offset != len(self.payload):
            raise ValueError("trailing bytes in ID payload")
        return value

    def delegated_parts(self) -> tuple[int, bytes]:
        if self.protocol != Protocol.DELEGATED:
            raise ValueError(f"not a delegated address: {self}")
        namespace, offset = decode_uvarint(self.payload)
        return namespace, self.payload[offset:]

    def to_bytes(self) -> bytes:
        """The state-tree HAMT key form."""
        return bytes([self.protocol]) + self.payload

    def __str__(self) -> str:
        if self.protocol == Protocol.ID:
            return f"f0{self.id()}"
        if self.protocol == Protocol.DELEGATED:
            namespace, sub = self.delegated_parts()
            check = _checksum(self.to_bytes())
            return f"f4{namespace}f{_b32(sub + check)}"
        check = _checksum(self.to_bytes())
        return f"f{int(self.protocol)}{_b32(self.payload + check)}"
