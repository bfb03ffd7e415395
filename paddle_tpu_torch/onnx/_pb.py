"""Minimal protobuf wire-format encoder/decoder for ONNX serialization.

A copy of ``paddle_tpu/onnx/_pb.py`` (pure Python; the port imports
nothing of the JAX package). The files are written at the protobuf wire
level, without the ``onnx`` package: varint tags and length-delimited
submessages, field numbers from onnx/onnx.proto (IR version 8). The
decoder lets tests and the evaluator read the emitted bytes back.
"""
from __future__ import annotations

import struct
from typing import Dict, List, Tuple, Union

# wire types
_VARINT, _I64, _LEN, _I32 = 0, 1, 2, 5


def varint(n: int) -> bytes:
    """Unsigned LEB128. int64 fields with negative values take the 10-byte
    two's-complement form."""
    if n < 0:
        n += 1 << 64
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def tag(field: int, wire: int) -> bytes:
    return varint((field << 3) | wire)


def f_varint(field: int, n: int) -> bytes:
    return tag(field, _VARINT) + varint(n)


def f_bytes(field: int, data: bytes) -> bytes:
    return tag(field, _LEN) + varint(len(data)) + data


def f_str(field: int, s: str) -> bytes:
    return f_bytes(field, s.encode("utf-8"))


def f_packed_i64(field: int, vals) -> bytes:
    body = b"".join(varint(int(v)) for v in vals)
    return f_bytes(field, body)


def f_packed_f32(field: int, vals) -> bytes:
    return f_bytes(field, struct.pack(f"<{len(vals)}f", *vals))


# -- decoder (for tests) ------------------------------------------------------

def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def decode(buf: bytes) -> Dict[int, List[Union[int, bytes]]]:
    """Decode one message level: field number -> list of raw values
    (ints for varint fields, bytes for length-delimited). Nested messages
    are decoded by calling decode() again on the bytes value."""
    out: Dict[int, List[Union[int, bytes]]] = {}
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == _VARINT:
            val, pos = _read_varint(buf, pos)
        elif wire == _LEN:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wire == _I64:
            val = struct.unpack_from("<q", buf, pos)[0]
            pos += 8
        elif wire == _I32:
            val = struct.unpack_from("<i", buf, pos)[0]
            pos += 4
        else:
            raise ValueError(f"bad wire type {wire}")
        out.setdefault(field, []).append(val)
    return out
