"""Typed errors of the witness plane.

The system invariant this package defends is *byte-identity or a typed
error, never a silently different bundle*: every failure mode of
aggregation, delta application, and compressed framing has a named
exception here, and the serve plane maps each to a typed 4xx (the
``error_type`` field in the JSON body) so clients can distinguish "your
base is stale, re-request full" from "your request named an encoding
this server does not speak".
"""

from __future__ import annotations

__all__ = [
    "DeltaBaseMismatchError",
    "DeltaBaseMissingError",
    "StreamAbortError",
    "WitnessEncodingError",
    "WitnessError",
    "WitnessIntegrityError",
]


class WitnessError(ValueError):
    """Base of every witness-plane failure; ``error_type`` names the
    subclass on the wire."""

    error_type = "witness"


class WitnessEncodingError(WitnessError):
    """The request named a witness encoding this server does not support
    (unknown name, or zstd on a host without the optional codec). Mapped
    to 400 — never silently answered with a plain bundle."""

    error_type = "witness_encoding"


class WitnessIntegrityError(WitnessError):
    """A compressed frame's bytes do not hash to its declared
    ``uncompressed_digest`` — transport corruption or a lying encoder."""

    error_type = "witness_integrity"


class DeltaBaseMissingError(WitnessError):
    """A delta bundle was handed to an expander with no base blocks — the
    delta names ``base_digest`` but the caller holds nothing to overlay."""

    error_type = "witness_delta_base_missing"


class DeltaBaseMismatchError(WitnessError):
    """Overlaying the provided base did not reproduce the declared full
    bundle digest: the base is stale, truncated, or simply a different
    bundle. The expansion is discarded — a wrong base can never produce
    a silently different bundle."""

    error_type = "witness_delta_base"


class StreamAbortError(WitnessError):
    """The server aborted a streamed response in-band (an ``E`` chunk):
    by the time a mid-stream failure happens the 200 status line is
    already on the wire, so the typed error travels as a chunk instead
    of a status code. ``remote_error_type`` carries the server's
    original ``error_type`` (e.g. ``merge_conflict``)."""

    error_type = "stream_abort"

    def __init__(self, message: str, remote_error_type: str = "internal"):
        super().__init__(message)
        self.remote_error_type = remote_error_type
