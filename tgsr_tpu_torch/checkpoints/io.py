"""Variable files in flax's msgpack format (counterpart of
tgsr_tpu/checkpoints/io.py): `save_variables` writes what
`flax.serialization.msgpack_serialize` writes, without `msgpack` or
`flax`; `load_variables` is `checkpoints/msgpack_io.py`'s reader.

A tree is nested dicts with str keys (lists and tuples as msgpack arrays)
of numpy arrays, torch tensors (written as their numpy float32 / int
arrays), numpy scalars and Python scalars; a dict's keys go out sorted, as
flax writes them. Arrays go out as flax's
extension type 1 (the msgpack of (shape, dtype name, C-order bytes)), numpy
scalars as type 3, with msgpack's smallest header for every length, as the
`msgpack` package packs them. An array above flax's chunk size (2^30 bytes),
which flax splits into chunks, is refused: no tree of this port comes near.
"""

from __future__ import annotations

import os
import struct
from typing import Any, Dict, List

import numpy as np
import torch

from tgsr_tpu_torch.checkpoints.msgpack_io import load_variables  # noqa: F401 (re-exported)

MAX_CHUNK_SIZE = 2 ** 30  # flax.serialization's: larger arrays are chunked there


def _int(out: List[bytes], v: int) -> None:
    if 0 <= v < 0x80:
        out.append(struct.pack(">B", v))
    elif -32 <= v < 0:
        out.append(struct.pack(">b", v))
    elif v >= 0:
        for code, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                               (0xCE, ">I", 0xFFFFFFFF), (0xCF, ">Q", 2 ** 64 - 1)):
            if v <= top:
                out.append(struct.pack(">B", code) + struct.pack(fmt, v))
                return
        raise ValueError(f"msgpack: int {v} out of range")
    else:
        for code, fmt, low in ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000),
                               (0xD2, ">i", -0x80000000), (0xD3, ">q", -2 ** 63)):
            if v >= low:
                out.append(struct.pack(">B", code) + struct.pack(fmt, v))
                return
        raise ValueError(f"msgpack: int {v} out of range")


def _header(out: List[bytes], n: int, fix: int, fix_max: int, sized) -> None:
    """A length header: the fix form below fix_max, else the first of
    `sized` ((code, struct format, largest length)) that holds n."""
    if fix is not None and n <= fix_max:
        out.append(struct.pack(">B", fix | n))
        return
    for code, fmt, top in sized:
        if n <= top:
            out.append(struct.pack(">B", code) + struct.pack(fmt, n))
            return
    raise ValueError(f"msgpack: length {n} out of range")


_STR = ((0xD9, ">B", 0xFF), (0xDA, ">H", 0xFFFF), (0xDB, ">I", 0xFFFFFFFF))
_BIN = ((0xC4, ">B", 0xFF), (0xC5, ">H", 0xFFFF), (0xC6, ">I", 0xFFFFFFFF))
_ARRAY = ((0xDC, ">H", 0xFFFF), (0xDD, ">I", 0xFFFFFFFF))
_MAP = ((0xDE, ">H", 0xFFFF), (0xDF, ">I", 0xFFFFFFFF))
_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
_EXT = ((0xC7, ">B", 0xFF), (0xC8, ">H", 0xFFFF), (0xC9, ">I", 0xFFFFFFFF))


def _ext(out: List[bytes], code: int, body: bytes) -> None:
    if len(body) in _FIXEXT:
        out.append(struct.pack(">B", _FIXEXT[len(body)]))
    else:
        _header(out, len(body), None, 0, _EXT)
    out.append(struct.pack(">b", code))
    out.append(body)


def _ndarray(arr: np.ndarray) -> bytes:
    """flax's `_ndarray_to_bytes`: msgpack of (shape, dtype name, bytes)."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError(f"msgpack: a {arr.dtype} array has no byte form")
    if arr.nbytes > MAX_CHUNK_SIZE:
        raise ValueError(f"msgpack: an array of {arr.nbytes} bytes (flax chunks those)")
    out: List[bytes] = []
    _pack(out, [list(arr.shape), arr.dtype.name, np.ascontiguousarray(arr).tobytes()])
    return b"".join(out)


def _pack(out: List[bytes], x: Any) -> None:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    if x is None:
        out.append(b"\xc0")
    elif isinstance(x, (bool, np.bool_)) and not isinstance(x, np.ndarray):
        if isinstance(x, np.bool_):
            _ext(out, 3, _ndarray(np.asarray(x)))
        else:
            out.append(b"\xc3" if x else b"\xc2")
    elif isinstance(x, np.ndarray):
        _ext(out, 1, _ndarray(x))
    elif isinstance(x, np.generic):
        _ext(out, 3, _ndarray(np.asarray(x)))
    elif isinstance(x, int):
        _int(out, x)
    elif isinstance(x, float):
        out.append(b"\xcb" + struct.pack(">d", x))
    elif isinstance(x, str):
        raw = x.encode("utf-8")
        _header(out, len(raw), 0xA0, 31, _STR)
        out.append(raw)
    elif isinstance(x, bytes):
        _header(out, len(x), None, 0, _BIN)
        out.append(x)
    elif isinstance(x, (list, tuple)):
        _header(out, len(x), 0x90, 15, _ARRAY)
        for v in x:
            _pack(out, v)
    elif isinstance(x, dict):
        _header(out, len(x), 0x80, 15, _MAP)
        if not all(isinstance(k, str) for k in x):
            raise ValueError("msgpack: a key that is not a str; flax trees have str keys")
        for k in sorted(x):  # flax's state dicts go out in key order
            _pack(out, k)
            _pack(out, x[k])
    else:
        raise ValueError(f"msgpack: cannot write a {type(x).__name__}")


def msgpack_serialize(tree: Any) -> bytes:
    """The bytes `flax.serialization.msgpack_serialize(tree)` gives."""
    out: List[bytes] = []
    _pack(out, tree)
    return b"".join(out)


def save_variables(path: str, variables: Dict[str, Any]) -> None:
    """Writes `variables` to `path` (its directory made first), as the JAX
    package's `save_variables`."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(msgpack_serialize(variables))
