"""Reads what `flax.serialization.to_bytes` writes, without flax or msgpack.

flax stores a param tree as one msgpack map: nested maps of str keys whose
leaves are arrays, each an ext value of type 1 whose payload is itself the
msgpack array (shape, dtype name, raw C-order bytes); a numpy scalar is
ext type 3 with the same payload.  `unpack` decodes that subset of msgpack
(maps, arrays, str, bin, nil, bool, ints, floats and those two ext types)
in plain Python, array leaves as torch tensors.  bfloat16, which numpy
lacks, comes back as torch.bfloat16.  It raises ValueError on anything
else: another ext type (flax's complex numbers), flax's chunked arrays (an
array over 2**30 bytes is written as a `__msgpack_chunked_array__` map),
an unknown dtype, a map key that is not a str, or bytes that are not one
whole msgpack value.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import torch

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3
_CHUNKED = "__msgpack_chunked_array__"
# numpy dtype names (as flax writes them) -> torch dtypes
_DTYPES = {
    "float64": torch.float64, "float32": torch.float32,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int64": torch.int64, "int32": torch.int32, "int16": torch.int16,
    "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool,
}


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack data ends inside a value")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str) -> Any:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7f:                                   # positive fixint
            return b
        if b >= 0xe0:                                   # negative fixint
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.mapping(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return self.seq(b & 0x0f)
        if 0xa0 <= b <= 0xbf:
            return self.text(b & 0x1f)
        fixed = {0xc0: None, 0xc2: False, 0xc3: True}
        if b in fixed:
            return fixed[b]
        scalars = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H",
                   0xce: ">I", 0xcf: ">Q", 0xd0: ">b", 0xd1: ">h",
                   0xd2: ">i", 0xd3: ">q"}
        if b in scalars:
            return self.unpack(scalars[b])
        sized = {0xc4: (">B", self.blob), 0xc5: (">H", self.blob),
                 0xc6: (">I", self.blob), 0xd9: (">B", self.text),
                 0xda: (">H", self.text), 0xdb: (">I", self.text),
                 0xdc: (">H", self.seq), 0xdd: (">I", self.seq),
                 0xde: (">H", self.mapping), 0xdf: (">I", self.mapping)}
        if b in sized:
            fmt, read = sized[b]
            return read(self.unpack(fmt))
        fixext = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        ext = {0xc7: ">B", 0xc8: ">H", 0xc9: ">I"}
        if b in ext:
            return self.ext(self.unpack(ext[b]))
        raise ValueError(f"byte 0x{b:02x} at offset {self.pos - 1} starts "
                         f"no msgpack value")

    def text(self, n: int) -> str:
        return str(self.take(n), "utf-8")

    def blob(self, n: int) -> bytes:
        return bytes(self.take(n))

    def seq(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def mapping(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            if not isinstance(key, str):
                raise ValueError(f"a map key {key!r} is not a str, as the "
                                 f"keys of a flax tree are")
            out[key] = self.value()
        if _CHUNKED in out:
            raise ValueError("a chunked array (flax writes arrays over 2**30 "
                             "bytes in chunks) is not supported")
        return out

    def ext(self, n: int) -> torch.Tensor:
        code = self.unpack(">b")
        payload = bytes(self.take(n))
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"msgpack ext type {code} is not a flax array")
        shape, dtype, raw = _decode(payload)
        t = _tensor(shape, dtype, raw)
        return t.reshape(()) if code == _EXT_NPSCALAR else t


def _decode(payload: bytes) -> Tuple[tuple, str, bytes]:
    """An ndarray payload: (shape, dtype name, raw bytes)."""
    r = _Reader(payload)
    v = r.value()
    if r.pos != len(payload) or not (
            isinstance(v, list) and len(v) == 3
            and isinstance(v[0], list) and isinstance(v[1], (str, bytes))
            and isinstance(v[2], bytes)):
        raise ValueError("malformed flax ndarray payload")
    dtype = v[1].decode() if isinstance(v[1], bytes) else v[1]
    return tuple(v[0]), dtype, v[2]


def _tensor(shape: tuple, dtype: str, raw: bytes) -> torch.Tensor:
    if dtype not in _DTYPES:
        raise ValueError(f"flax array dtype {dtype!r} is not supported")
    dt = _DTYPES[dtype]
    n = 1
    for d in shape:
        n *= d
    if len(raw) != n * dt.itemsize:
        raise ValueError(f"flax array of shape {shape} and dtype {dtype} "
                         f"holds {len(raw)} bytes")
    if n == 0:
        return torch.empty(shape, dtype=dt)
    # a writable copy, so the tensor owns its memory
    return torch.frombuffer(bytearray(raw), dtype=dt).reshape(shape)


def unpack(data: bytes) -> Any:
    """The tree `flax.serialization.to_bytes` wrote, array leaves as torch
    tensors (numpy scalars as 0-d tensors)."""
    r = _Reader(data)
    v = r.value()
    if r.pos != len(data):
        raise ValueError(f"{len(data) - r.pos} bytes after the msgpack value")
    return v
