"""Minimal protobuf wire-format encode/decode helpers (no protobuf dependency).

The port's copy of ``realtime_style_transfer_tpu/utils/proto.py``, used by
the TensorBoard event writer (``tracing/tensorboard.py``): the events it
writes are small, stable protos whose hand encoding saves a TensorFlow or
protobuf dependency.
"""

from __future__ import annotations

import struct
from typing import Iterator, Sequence, Tuple


def varint(n: int) -> bytes:
    out = bytearray()
    while True:
        bits = n & 0x7F
        n >>= 7
        if n:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def key(field: int, wire: int) -> bytes:
    return varint((field << 3) | wire)


def enc_double(field: int, value: float) -> bytes:
    return key(field, 1) + struct.pack("<d", value)


def enc_float(field: int, value: float) -> bytes:
    return key(field, 5) + struct.pack("<f", value)


def enc_int64(field: int, value: int) -> bytes:
    return key(field, 0) + varint(value & 0xFFFFFFFFFFFFFFFF)


def enc_bytes(field: int, value: bytes) -> bytes:
    return key(field, 2) + varint(len(value)) + value


def enc_string(field: int, value: str) -> bytes:
    return enc_bytes(field, value.encode("utf-8"))


def enc_packed_doubles(field: int, values: Sequence[float]) -> bytes:
    payload = b"".join(struct.pack("<d", float(v)) for v in values)
    return enc_bytes(field, payload)


def enc_packed_int64s(field: int, values: Sequence[int]) -> bytes:
    payload = b"".join(varint(int(v) & 0xFFFFFFFFFFFFFFFF) for v in values)
    return enc_bytes(field, payload)


def read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    shift, result = 0, 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def parse_fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    """Yield (field_number, wire_type, value) triples from a proto payload.

    Length-delimited fields come back as raw ``bytes`` (decode or recurse at the
    call site); varints as int; fixed64/fixed32 as float (double/float).
    """
    pos = 0
    while pos < len(buf):
        k, pos = read_varint(buf, pos)
        field, wire = k >> 3, k & 7
        if wire == 0:
            value, pos = read_varint(buf, pos)
        elif wire == 1:
            value = struct.unpack("<d", buf[pos:pos + 8])[0]
            pos += 8
        elif wire == 2:
            length, pos = read_varint(buf, pos)
            value = buf[pos:pos + length]
            pos += length
        elif wire == 5:
            value = struct.unpack("<f", buf[pos:pos + 4])[0]
            pos += 4
        else:  # pragma: no cover - group wire types unused in these protos
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, value


def parse_packed_int64s(payload: bytes) -> list:
    out = []
    pos = 0
    while pos < len(payload):
        v, pos = read_varint(payload, pos)
        if v >= 1 << 63:  # two's-complement negative
            v -= 1 << 64
        out.append(v)
    return out
