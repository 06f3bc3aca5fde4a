"""Reads flax's msgpack variable files without `msgpack` or `flax`
(counterpart of tgsr_tpu/checkpoints/io.py `load_variables`, which is
`flax.serialization.msgpack_restore`).

A small decoder for the msgpack types flax writes: maps (str keys), arrays,
str, bin, ints, floats, nil and bools, and flax's three extension types:

- ext 1, an ndarray: the msgpack of (shape, dtype name, C-order bytes);
- ext 2, a Python complex: the msgpack of (real, imag);
- ext 3, a numpy scalar: as ext 1, of a 0-d array.

An array larger than flax's chunk limit is written as a map
{'__msgpack_chunked_array__': True, 'shape': {...}, 'chunks': {...}} and
comes back whole, as `msgpack_restore` returns it. Everything else (another
extension type, a key that is not a str, an unknown dtype, bytes left over,
a truncated file) raises ValueError. Arrays come back read-only, as flax's
do.
"""

from __future__ import annotations

import struct
from typing import Any, Dict

import numpy as np

CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    def __init__(self, data: bytes, raw: bool):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw  # str as bytes (flax's inner ndarray records)

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack: truncated data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.text(b & 0x1F)
        fixed = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in fixed:
            return fixed[b]
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}  # bin 8/16/32
        if b in sized:
            return bytes(self.take(self.unpack(sized[b])))
        sized = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}  # str 8/16/32
        if b in sized:
            return self.text(self.unpack(sized[b]))
        sized = {0xDC: ">H", 0xDD: ">I"}  # array 16/32
        if b in sized:
            return [self.value() for _ in range(self.unpack(sized[b]))]
        sized = {0xDE: ">H", 0xDF: ">I"}  # map 16/32
        if b in sized:
            return self.map(self.unpack(sized[b]))
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                   0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        sized = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}  # ext 8/16/32
        if b in sized:
            n = self.unpack(sized[b])
            return self.ext(self.unpack(">b"), n)
        if 0xD4 <= b <= 0xD8:  # fixext 1/2/4/8/16
            return self.ext(self.unpack(">b"), 1 << (b - 0xD4))
        raise ValueError(f"msgpack: byte 0x{b:02x} at {self.pos - 1} starts no value")

    def text(self, n: int):
        raw = bytes(self.take(n))
        return raw if self.raw else raw.decode("utf-8")

    def map(self, n: int) -> Dict[str, Any]:
        out = {}
        for _ in range(n):
            key = self.value()
            if not isinstance(key, str):
                raise ValueError(f"msgpack: a map key of type {type(key).__name__}; "
                                 "flax writes str keys")
            out[key] = self.value()
        return out

    def ext(self, code: int, n: int) -> Any:
        body = self.take(n)
        if code == 1:
            return _ndarray(body)
        if code == 2:
            real, imag = _decode(body, raw=False)
            return complex(real, imag)
        if code == 3:
            return _ndarray(body)[()]
        raise ValueError(f"msgpack: extension type {code}; flax writes 1 (ndarray), "
                         "2 (complex) and 3 (numpy scalar)")


def _dtype(name: bytes) -> np.dtype:
    text = name.decode("ascii") if isinstance(name, bytes) else str(name)
    if text == "bfloat16":
        raise ValueError("msgpack: a bfloat16 array; numpy has no bfloat16")
    try:
        return np.dtype(text)
    except TypeError as e:
        raise ValueError(f"msgpack: unknown dtype name {text!r}") from e


def _ndarray(body: memoryview) -> np.ndarray:
    record = _decode(body, raw=True)
    if not (isinstance(record, list) and len(record) == 3 and isinstance(record[0], list)
            and isinstance(record[2], bytes)):
        raise ValueError("msgpack: an ndarray record is not (shape, dtype, bytes)")
    shape, name, buffer = record
    dtype = _dtype(name)
    if int(np.prod(shape, dtype=np.int64)) * dtype.itemsize != len(buffer):
        raise ValueError(f"msgpack: {len(buffer)} bytes for a {dtype} array of shape {shape}")
    return np.frombuffer(buffer, dtype=dtype).reshape(shape)


def _decode(data, raw: bool) -> Any:
    reader = _Reader(data, raw)
    out = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError(f"msgpack: {len(reader.data) - reader.pos} bytes after the value")
    return out


def _unchunk(tree: Any) -> Any:
    if not isinstance(tree, dict):
        return tree
    if CHUNKED in tree:
        shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def msgpack_restore(data: bytes) -> Any:
    """The tree flax's `msgpack_restore` returns for `data`: nested dicts
    (and lists) of numpy arrays and Python values."""
    return _unchunk(_decode(data, raw=False))


def load_variables(path: str) -> Dict[str, Any]:
    """A flax variable file (`save_variables`, `cli.train_gan` snapshots)."""
    with open(path, "rb") as f:
        return msgpack_restore(f.read())
