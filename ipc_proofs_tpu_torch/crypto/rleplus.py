"""Filecoin RLE+ bitfields (go-bitfield wire format).

go-f3 certificates carry their ``Signers`` set as an RLE+ bitfield over
power-table row indices (go-bitfield's serialization, the same format
Filecoin consensus uses for sector bitfields). This module implements the
format bidirectionally with the spec's strict minimality rules so a
bitfield round-trips to the unique canonical byte string.

Wire format (bits consumed LSB-first within each byte):

- 2-bit version, must be ``00``;
- 1 bit: the value of the first run (1 = the bitfield starts with set bits);
- a sequence of run lengths, values alternating, each encoded as one of
  - ``1``               — run of length 1,
  - ``01`` + 4 bits     — run of length 2..15 (LSB-first length bits),
  - ``00`` + LEB128     — run of length >= 16 (varint bytes, bits LSB-first);
- zero-bit padding to the byte boundary.

Strictness (the spec requires decoders to reject non-minimal encodings —
each bitfield has exactly one valid serialization):

- zero-length runs are invalid;
- a short block encoding length < 2, or a long block encoding length < 16,
  is non-minimal and rejected;
- LEB128 varints must be minimal (no redundant trailing zero group);
- padding bits after the final run must all be zero, and confined to the
  final byte;
- the empty bitfield is ``bytes([0])`` — the version header with no runs,
  go-bitfield's encoder output for zero runs; ``b""`` is rejected (as
  go-bitfield's decoder does — callers with an optional-bytes field decide
  for themselves what absence means).

The decoded form used across this package is a sorted list of set-bit
indices (power-table rows).
"""

from __future__ import annotations

from typing import Iterable, Sequence

__all__ = ["encode_rleplus", "decode_rleplus", "runs_to_indices", "indices_to_runs"]

# Ceiling on a decoded run length / total bit width: signers bitmaps index
# power-table rows (thousands at most); a crafted certificate must not be
# able to make the verifier materialize billions of indices. go-bitfield
# similarly caps decoded length (its RLE byte size is consensus-capped).
MAX_BITS_DEFAULT = 1 << 24


class _BitWriter:
    def __init__(self) -> None:
        self._out = bytearray()
        self._acc = 0
        self._nbits = 0

    def write(self, value: int, nbits: int) -> None:
        """Append ``nbits`` of ``value``, LSB-first into the stream."""
        self._acc |= (value & ((1 << nbits) - 1)) << self._nbits
        self._nbits += nbits
        while self._nbits >= 8:
            self._out.append(self._acc & 0xFF)
            self._acc >>= 8
            self._nbits -= 8

    def finish(self) -> bytes:
        if self._nbits:
            self._out.append(self._acc & 0xFF)
            self._acc = 0
            self._nbits = 0
        # strip trailing zero bytes? NO — padding lives inside the final
        # byte only; a full zero byte would be non-minimal output, and the
        # writer never produces one (runs always emit at least one 1-bit
        # per block except long-form varint bytes, whose last byte is
        # nonzero by LEB128 minimality)
        return bytes(self._out)


class _BitReader:
    def __init__(self, data: bytes) -> None:
        self._data = data
        self._pos = 0  # absolute bit position
        self._total = len(data) * 8

    @property
    def bits_left(self) -> int:
        return self._total - self._pos

    def read(self, nbits: int) -> int:
        if nbits > self.bits_left:
            raise ValueError("RLE+ truncated inside a block")
        out = 0
        for i in range(nbits):
            byte = self._data[self._pos >> 3]
            out |= ((byte >> (self._pos & 7)) & 1) << i
            self._pos += 1
        return out

    def rest_is_padding(self) -> bool:
        """True iff every remaining bit is zero (legal end-of-stream)."""
        pos = self._pos
        if pos >> 3 >= len(self._data):
            return True
        # remaining bits of the current byte
        if self._data[pos >> 3] >> (pos & 7):
            return False
        return not any(self._data[(pos >> 3) + 1 :])


def indices_to_runs(indices: Sequence[int]) -> list[tuple[int, int]]:
    """Sorted, distinct set-bit indices -> alternating (value, length) runs
    starting at bit 0."""
    runs: list[tuple[int, int]] = []
    prev_end = 0
    run_start = None
    last = None
    for idx in indices:
        if idx < 0:
            raise ValueError("negative bit index")
        if last is not None and idx <= last:
            raise ValueError("indices must be strictly increasing")
        if run_start is None:
            run_start = idx
        elif idx != last + 1:
            if run_start > prev_end:
                runs.append((0, run_start - prev_end))
            runs.append((1, last + 1 - run_start))
            prev_end = last + 1
            run_start = idx
        last = idx
    if run_start is not None:
        if run_start > prev_end:
            runs.append((0, run_start - prev_end))
        runs.append((1, last + 1 - run_start))
    return runs


def runs_to_indices(runs: Iterable[tuple[int, int]], max_bits: int) -> list[int]:
    out: list[int] = []
    pos = 0
    for value, length in runs:
        if pos + length > max_bits:
            raise ValueError(f"RLE+ bitfield exceeds {max_bits} bits")
        if value:
            out.extend(range(pos, pos + length))
        pos += length
    return out


def _write_varint(writer: _BitWriter, value: int) -> None:
    while True:
        group = value & 0x7F
        value >>= 7
        writer.write(group | (0x80 if value else 0), 8)
        if not value:
            return


def _read_varint(reader: _BitReader) -> int:
    value = 0
    shift = 0
    last_group = 0
    while True:
        byte = reader.read(8)
        last_group = byte & 0x7F
        value |= last_group << shift
        if not byte & 0x80:
            break
        shift += 7
        if shift > 63:
            raise ValueError("RLE+ varint too long")
    if shift and last_group == 0:
        raise ValueError("RLE+ varint not minimally encoded")
    return value


def encode_rleplus(indices: Sequence[int]) -> bytes:
    """Canonical RLE+ bytes for a set of bit indices (sorted, distinct)."""
    runs = indices_to_runs(indices)
    writer = _BitWriter()
    writer.write(0, 2)  # version 00
    writer.write(runs[0][0] if runs else 0, 1)  # first run's value
    if not runs:
        return writer.finish()  # bytes([0]): go-bitfield's empty bitfield
    for _, length in runs:
        if length == 1:
            writer.write(1, 1)
        elif length < 16:
            writer.write(0b10, 2)  # bits 0,1 read in stream order
            writer.write(length, 4)
        else:
            writer.write(0b00, 2)
            _write_varint(writer, length)
    return writer.finish()


def decode_rleplus(data: bytes, max_bits: int = MAX_BITS_DEFAULT) -> list[int]:
    """Decode RLE+ bytes to the sorted set-bit indices; strict-canonical
    (rejects every non-minimal encoding — see module docstring)."""
    if not data:
        raise ValueError("empty RLE+ byte string (the empty bitfield is b'\\x00')")
    reader = _BitReader(data)
    if reader.read(2) != 0:
        raise ValueError("unsupported RLE+ version")
    value = reader.read(1)
    runs: list[tuple[int, int]] = []
    total = 0
    while not reader.rest_is_padding():
        head = reader.read(1)
        if head == 1:
            length = 1
        elif reader.read(1) == 1:
            length = reader.read(4)
            if length < 2:
                raise ValueError(
                    "non-minimal RLE+: short block encoding a length < 2"
                )
        else:
            length = _read_varint(reader)
            if length < 16:
                raise ValueError(
                    "non-minimal RLE+: long block encoding a length < 16"
                )
        total += length
        if total > max_bits:
            raise ValueError(f"RLE+ bitfield exceeds {max_bits} bits")
        runs.append((value, length))
        value ^= 1
    if not runs:
        # a bare version header with no runs is the empty bitfield — but
        # only in its canonical form: first-bit 0, single byte
        if data != b"\x00":
            raise ValueError("non-minimal RLE+ empty bitfield")
        return []
    if runs[-1][0] == 0:
        # a trailing 0-run adds no set bits: encode(decode(x)) would differ
        raise ValueError("non-minimal RLE+: trailing zero run")
    if reader.bits_left >= 8:
        # whole zero bytes after the final run are non-minimal padding —
        # canonical padding is only the final byte's leftover bits
        raise ValueError("non-minimal RLE+: trailing zero bytes")
    return runs_to_indices(runs, max_bits)
