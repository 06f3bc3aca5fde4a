"""tgsr_tpu_torch's msgpack reader against flax.serialization.msgpack_restore.

Trees are written by flax's own `msgpack_serialize` (what
tgsr_tpu/checkpoints/io.py `save_variables` writes) and read by both; the
port must give the same tree exactly: the same keys in the same order, the
same container and leaf types, numpy arrays of the same dtype, shape and
bits. Whatever flax does not write raises.
"""

import os

import msgpack
import numpy as np
import pytest
from flax import serialization

import tgsr_tpu.checkpoints as ck
from tgsr_tpu.checkpoints.io import load_variables
from tgsr_tpu_torch.checkpoints import msgpack_io

DTYPES = ["float32", "float64", "float16", "int8", "int16", "int32", "int64", "uint8",
          "uint16", "uint32", "uint64", "bool", "complex64", "complex128"]


def assert_same(got, ref, path="tree"):
    assert type(got) is type(ref), f"{path}: {type(got)} vs {type(ref)}"
    if isinstance(ref, dict):
        assert list(got) == list(ref), path
        for k in ref:
            assert_same(got[k], ref[k], f"{path}/{k}")
    elif isinstance(ref, list):
        assert len(got) == len(ref), path
        for i, (g, r) in enumerate(zip(got, ref)):
            assert_same(g, r, f"{path}[{i}]")
    elif isinstance(ref, np.ndarray):
        assert got.dtype == ref.dtype and got.shape == ref.shape, path
        assert got.tobytes() == ref.tobytes(), path
    elif isinstance(ref, np.generic):
        assert got.dtype == ref.dtype and got.tobytes() == ref.tobytes(), path
    elif isinstance(ref, float) and np.isnan(ref):
        assert np.isnan(got), path
    else:
        assert got == ref, path


def random_tree(rng, depth=0):
    """Nested dicts of arrays of every dtype and shape rank (0-d and empty
    included), numpy scalars, Python scalars, lists, str and bytes."""
    tree = {}
    for i in range(int(rng.integers(2, 7))):
        kind = rng.integers(0, 6 if depth < 3 else 4)
        key = f"k{i}_{rng.integers(0, 1000)}"
        dtype = np.dtype(DTYPES[rng.integers(0, len(DTYPES))])
        if kind == 0:
            shape = tuple(int(d) for d in rng.integers(0, 5, rng.integers(0, 4)))
            x = np.abs(rng.normal(size=shape)) * 100
            if dtype.kind == "c":
                x = x + 1j * rng.normal(size=shape)
            tree[key] = x.astype(dtype)
        elif kind == 1:
            tree[key] = np.asarray(abs(rng.normal()) * 10).astype(dtype)[()]
        elif kind == 2:
            tree[key] = [int(rng.integers(-2 ** 40, 2 ** 40)), float(rng.normal()), None, True,
                         "s" * int(rng.integers(0, 40)), b"\x00\xff" * int(rng.integers(0, 9))]
        elif kind == 3:
            tree[key] = complex(rng.normal(), rng.normal())
        else:
            tree[key] = random_tree(rng, depth + 1)
    return tree


@pytest.mark.parametrize("seed", range(8))
def test_random_trees_match_flax(seed):
    tree = random_tree(np.random.default_rng(seed))
    data = serialization.msgpack_serialize(tree)
    assert_same(msgpack_io.msgpack_restore(data), serialization.msgpack_restore(data))


def test_every_msgpack_width_matches_flax():
    """Every integer, float, str, bin, array and map width of the format."""
    ints = [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32, 2 ** 64 - 1, -1, -32,
            -33, -128, -129, -32768, -32769, -2 ** 31, -2 ** 31 - 1, -2 ** 63]
    tree = {"ints": ints, "floats": [0.0, -1.5, 1e300, float("inf"), float("nan")],
            "str": ["", "a" * 31, "b" * 32, "é" * 200, "c" * 70000],
            "bin": [b"", b"x" * 255, b"y" * 256, b"z" * 70000],
            "list16": list(range(16)), "list_big": list(range(70000)),
            "map16": {str(i): i for i in range(16)},
            "map_big": {str(i): i for i in range(70000)},
            "flags": [True, False, None]}
    data = serialization.msgpack_serialize(tree)
    assert_same(msgpack_io.msgpack_restore(data), serialization.msgpack_restore(data))


def test_chunked_arrays_come_back_whole(monkeypatch):
    """flax writes an array above its chunk limit as a map of chunks."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    rng = np.random.default_rng(0)
    tree = {"big": rng.normal(size=(7, 9)).astype(np.float32),
            "nested": {"w": rng.integers(0, 9, (5, 13)).astype(np.int64)},
            "small": np.arange(3, dtype=np.float32)}
    data = serialization.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in data
    got = msgpack_io.msgpack_restore(data)
    assert_same(got, serialization.msgpack_restore(data))
    assert_same(got, tree)


def test_shipped_net_e_matches_flax():
    """The one trained tree in the repo, through `load_variables`."""
    shipped = os.path.join(os.path.dirname(ck.__file__), "face_net_e_s8.msgpack")
    got = msgpack_io.load_variables(shipped)
    assert_same(got, load_variables(shipped))
    assert not got["params"]["embedding"].flags.writeable  # read-only, as flax's


@pytest.mark.parametrize("data", [
    msgpack.packb(msgpack.ExtType(7, b"abc")),  # an extension flax does not write
    msgpack.packb({"a": 1}) + b"\x00",  # bytes after the value
    msgpack.packb({"a": [1, 2, 3]})[:-1],  # truncated
    b"\xc1",  # the byte msgpack never uses
    msgpack.packb({1: 2}),  # a key that is not a str
    msgpack.packb(msgpack.ExtType(1, msgpack.packb(((2,), "bfloat16", b"\x00" * 4),
                                                   use_bin_type=True))),
    msgpack.packb(msgpack.ExtType(1, msgpack.packb(((3,), "float32", b"\x00" * 8),
                                                   use_bin_type=True))),  # short buffer
    msgpack.packb(msgpack.ExtType(1, msgpack.packb(((1,), "nodtype", b"\x00"),
                                                   use_bin_type=True))),
], ids=["ext7", "trailing", "truncated", "c1", "int-key", "bfloat16", "short", "dtype"])
def test_what_flax_does_not_write_raises(data):
    with pytest.raises(ValueError):
        msgpack_io.msgpack_restore(data)
