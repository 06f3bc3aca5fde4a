"""The port's `device_prefetch` (tgsr_tpu_torch/data/pipeline.py) in the
cases of tests/test_device_prefetch.py, on the CPU, against JAX's on the
same streams: values, order and pass-through fields; copies made `depth`
batches ahead; a stream shorter than the depth; an early close; a per-rank
`put` (a rank's rows, `parallel.multihost.land_batch`); and `BatchLoader`
handing each rank its rows of the global batch. The card's path (pinned
memory, the side stream) runs in chip_smoke.py's train_scale_phase."""

import numpy as np
import pytest
import torch

from tgsr_tpu.data.pipeline import device_prefetch as jax_device_prefetch
from tgsr_tpu_torch.data.datasets import TextFaceDataset
from tgsr_tpu_torch.data.pipeline import BatchLoader, device_prefetch
from tgsr_tpu_torch.parallel import mesh as mesh_mod
from tgsr_tpu_torch.parallel import multihost
from tests.torch_cli_data import make_train_face_set

torch.set_num_threads(1)


def _batches(n, record):
    for i in range(n):
        record.append(i)
        yield {"x": np.full((4, 3), i, np.float32), "i": i, "keys": [f"k{i}"],
               "pyr": [np.full((4, 2), i, np.float32)]}


def test_prefetch_values_order_and_passthrough():
    rec = []
    out = list(device_prefetch(_batches(5, rec), depth=2, device="cpu"))
    want = list(jax_device_prefetch(_batches(5, []), depth=2))
    assert [b["i"] for b in out] == [b["i"] for b in want] == list(range(5))
    for b, w in zip(out, want):
        assert isinstance(b["x"], torch.Tensor) and b["x"].device.type == "cpu"
        np.testing.assert_array_equal(b["x"].numpy(), np.asarray(w["x"]))
        np.testing.assert_array_equal(b["pyr"][0].numpy(), np.asarray(w["pyr"][0]))
        assert b["keys"] == w["keys"]  # python fields untouched


def test_prefetch_runs_ahead():
    rec = []
    it = device_prefetch(_batches(6, rec), depth=3, device="cpu")
    first = next(it)
    assert first["i"] == 0
    assert len(rec) >= 3  # pulling one batch made depth batches ahead
    assert [b["i"] for b in it] == [1, 2, 3, 4, 5]


def test_prefetch_short_stream_and_early_close():
    assert [b["i"] for b in device_prefetch(_batches(2, []), depth=8)] == [0, 1]
    it = device_prefetch(_batches(10, []), depth=2, device="cpu")
    next(it)
    it.close()  # abandoning the iterator mid-stream neither raises nor hangs


@pytest.mark.parametrize("count", [2, 4])
def test_prefetch_with_a_per_rank_put(monkeypatch, count):
    """put = a rank's rows: rank r of `count` gets rows r * 16 / count.. of
    each global batch, its keys with them."""
    monkeypatch.setattr(multihost, "process_count", lambda: count)
    for r in range(count):
        monkeypatch.setattr(multihost, "process_index", lambda: r)
        out = list(device_prefetch(
            ({"x": np.full((16, 2), float(i)) + np.arange(16)[:, None],
              "keys": [f"a{i}.{j}" for j in range(16)]} for i in range(3)),
            depth=2, put=multihost.land_batch))
        per = 16 // count
        for i, b in enumerate(out):
            np.testing.assert_array_equal(
                b["x"], (np.full((16, 2), float(i)) + np.arange(16)[:, None])[r * per:(r + 1) * per])
            assert b["keys"] == [f"a{i}.{j}" for j in range(r * per, (r + 1) * per)]


def test_batch_loader_hands_each_rank_its_rows(tmp_path, monkeypatch):
    """BatchLoader(mesh=...) decodes the whole global batch on every rank (the
    random caption draws stay the single process's) and yields a rank its
    rows."""
    make_train_face_set(str(tmp_path), n=5, seed=3)
    ds = TextFaceDataset(str(tmp_path), split="train", words_num=6, imsize=32)
    whole = list(BatchLoader(ds, 4, shuffle=True, seed=9).epoch(1))
    fake_mesh = object()
    monkeypatch.setattr(mesh_mod, "batch_shards", lambda m: 2)
    for r in range(2):
        monkeypatch.setattr(mesh_mod, "data_index", lambda m: r)
        rows = list(BatchLoader(ds, 4, shuffle=True, seed=9, mesh=fake_mesh).epoch(1))
        assert len(rows) == len(whole)
        for got, b in zip(rows, whole):
            for k in ("hr", "captions", "cap_lens", "class_ids"):
                np.testing.assert_array_equal(got[k], b[k][2 * r:2 * r + 2])
