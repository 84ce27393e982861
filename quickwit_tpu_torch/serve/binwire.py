"""Compact binary encoding for the internal search RPC payloads.

Role of the reference's protobuf messages + postcard-serialized
intermediate aggregation bytes on the root↔leaf boundary
(`search.proto:360,616`; `root.rs:1120-1170` merges serialized
intermediate results). The JSON transport encodes numpy aggregation
states as nested lists — O(n) Python objects per bucket array on both
sides; this codec writes array dtype + shape + raw little-endian bytes,
so a 10k-bucket histogram state costs one memcpy instead of 10k boxed
floats.

Self-describing tagged format, no schema compiler:
  N null, T/F bool, i varint-zigzag int, f f64, s utf-8 str, b bytes,
  l list, d dict (str keys), k dict (arbitrary keys), a ndarray,
  I ±inf (JSON-unrepresentable floats ride their own tag).

Counterpart of the JAX package's `serve/binwire.py`, byte for byte: a value
encodes to the same bytes in both packages, so a mixed cluster's nodes read
each other's gRPC payloads. Tensors never reach this codec: the serializers
(`serializers.py`) read them back to numpy first.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np


class BinwireError(ValueError):
    pass


def _uvarint(value: int) -> bytes:
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _zigzag(value: int) -> int:
    return (value << 1) ^ (value >> 63) if value < 0 else value << 1


def _unzigzag(value: int) -> int:
    return (value >> 1) ^ -(value & 1)


def _encode(value: Any, out: bytearray) -> None:
    if value is None:
        out += b"N"
    elif value is True:
        out += b"T"
    elif value is False:
        out += b"F"
    elif isinstance(value, np.ndarray):
        out += b"a"
        dt = value.dtype.str.encode()
        out += _uvarint(len(dt)) + dt
        out += _uvarint(value.ndim)
        for dim in value.shape:
            out += _uvarint(dim)
        raw = np.ascontiguousarray(value).tobytes()
        out += _uvarint(len(raw)) + raw
    elif isinstance(value, np.generic):
        _encode(value.item(), out)
    elif isinstance(value, int):
        out += b"i" + _uvarint(_zigzag(value))
    elif isinstance(value, float):
        if value != value or value in (float("inf"), float("-inf")):
            out += b"I" + (b"+" if value > 0 else b"-" if value < 0 else b"n")
        else:
            out += b"f" + struct.pack("<d", value)
    elif isinstance(value, str):
        raw = value.encode()
        out += b"s" + _uvarint(len(raw)) + raw
    elif isinstance(value, (bytes, bytearray)):
        out += b"b" + _uvarint(len(value)) + bytes(value)
    elif isinstance(value, (list, tuple)):
        out += b"l" + _uvarint(len(value))
        for item in value:
            _encode(item, out)
    elif isinstance(value, dict):
        if all(isinstance(k, str) for k in value):
            out += b"d" + _uvarint(len(value))
            for k, v in value.items():
                raw = k.encode()
                out += _uvarint(len(raw)) + raw
                _encode(v, out)
        else:
            # bucket maps key by numbers/tuples; keys are full values
            out += b"k" + _uvarint(len(value))
            for k, v in value.items():
                _encode(k, out)
                _encode(v, out)
    else:
        raise BinwireError(f"unencodable type {type(value).__name__}")


def encode(value: Any) -> bytes:
    out = bytearray()
    _encode(value, out)
    return bytes(out)


class _Reader:
    __slots__ = ("data", "pos")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        raw = self.data[self.pos: self.pos + n]
        if len(raw) != n:
            raise BinwireError("truncated payload")
        self.pos += n
        return raw

    def uvarint(self) -> int:
        value = 0
        shift = 0
        while True:
            b = self.data[self.pos]
            self.pos += 1
            value |= (b & 0x7F) << shift
            if not b & 0x80:
                return value
            shift += 7


def _decode(r: _Reader) -> Any:
    tag = r.take(1)
    if tag == b"N":
        return None
    if tag == b"T":
        return True
    if tag == b"F":
        return False
    if tag == b"i":
        return _unzigzag(r.uvarint())
    if tag == b"f":
        return struct.unpack("<d", r.take(8))[0]
    if tag == b"I":
        sign = r.take(1)
        return {b"+": float("inf"), b"-": float("-inf"),
                b"n": float("nan")}[sign]
    if tag == b"s":
        return r.take(r.uvarint()).decode()
    if tag == b"b":
        return r.take(r.uvarint())
    if tag == b"l":
        return [_decode(r) for _ in range(r.uvarint())]
    if tag == b"d":
        out = {}
        for _ in range(r.uvarint()):
            key = r.take(r.uvarint()).decode()  # key strictly before value
            out[key] = _decode(r)
        return out
    if tag == b"k":
        out = {}
        for _ in range(r.uvarint()):
            key = _decode(r)
            if isinstance(key, list):
                key = tuple(key)
            out[key] = _decode(r)
        return out
    if tag == b"a":
        dtype = np.dtype(r.take(r.uvarint()).decode())
        shape = tuple(r.uvarint() for _ in range(r.uvarint()))
        raw = r.take(r.uvarint())
        return np.frombuffer(raw, dtype=dtype).reshape(shape).copy()
    raise BinwireError(f"unknown tag {tag!r}")


def decode(data: bytes) -> Any:
    r = _Reader(data)
    try:
        value = _decode(r)
    except IndexError:
        raise BinwireError("truncated payload") from None
    if r.pos != len(data):
        raise BinwireError(f"{len(data) - r.pos} trailing bytes")
    return value
