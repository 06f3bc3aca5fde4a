"""The port's BatchLoader (tgsr_tpu_torch/data/pipeline.py) against
tgsr_tpu's: the same batches of the same example set (shuffled or not,
random or deterministic captions, drop_last or not, two epochs), a worker's
exception raised to the consumer, and a generator abandoned early releasing
its worker thread."""

import shutil
import threading
import time

import numpy as np
import pytest

from tgsr_tpu.data.datasets import TextExampleSRDataset as JDataset
from tgsr_tpu.data.pipeline import BatchLoader as JBatchLoader
from tgsr_tpu_torch.cli.test import gen_example_pickle
from tgsr_tpu_torch.data.datasets import TextExampleSRDataset, TextFaceDataset
from tgsr_tpu_torch.data.pipeline import BatchLoader
from tgsr_tpu_torch.data.tokenizer import build_dictionary
from tests.torch_cli_data import make_face_set


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """One face example set (7 images, captions of 4-9 words, longer than
    T = 6 for some, so that the caption draws matter) read by both."""
    d = str(tmp_path_factory.mktemp("loader") / "face")
    make_face_set(d, n=7, seed=5, size=(40, 36), n_attr=(4, 9))
    shutil.copy(f"{d}/testset.txt", f"{d}/list_attr_celeba.txt")
    tr, _ = TextFaceDataset.load_attr_captions(d, True)
    te, _ = TextFaceDataset.load_attr_captions(d, False)
    pickle_path = gen_example_pickle(d, build_dictionary(tr, te)[2])
    kw = dict(words_num=6, imsize=32)
    return TextExampleSRDataset(d, pickle_path, **kw), JDataset(d, pickle_path, **kw)


def _check_same(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.keys() == b.keys() and a["keys"] == b["keys"]
        for k in ("hr", "captions", "cap_lens", "class_ids"):
            np.testing.assert_array_equal(a[k], b[k])
            assert a[k].dtype == b[k].dtype


@pytest.mark.parametrize("shuffle,drop_last,det", [(False, False, True), (True, True, False),
                                                   (True, False, False)])
def test_same_batches_as_jax(datasets, shuffle, drop_last, det):
    tds, jds = datasets
    kw = dict(shuffle=shuffle, seed=3, drop_last=drop_last, deterministic_captions=det)
    t, j = BatchLoader(tds, 3, **kw), JBatchLoader(jds, 3, **kw)
    assert len(t) == len(j) == (2 if drop_last else 3)
    for epoch in (0, 1):
        _check_same(list(t.epoch(epoch)), list(j.epoch(epoch)))


class _Failing:
    """A dataset whose fourth example fails to decode."""

    def __init__(self, base):
        self.base = base

    def __len__(self):
        return len(self.base)

    def __getitem__(self, index, rng=None, sent_ix=None):
        if index == 3:
            raise OSError("image 3 does not decode")
        return self.base.__getitem__(index, rng=rng, sent_ix=sent_ix)


def test_worker_error_reaches_the_consumer(datasets):
    got = []
    with pytest.raises(OSError, match="image 3 does not decode"):
        for batch in BatchLoader(_Failing(datasets[0]), 2, shuffle=False).epoch(0):
            got.append(batch)
    assert len(got) == 1  # the batch before the failing one


def test_abandoned_generator_releases_its_worker(datasets):
    """prefetch 1 over 7 batches of 1: the worker blocks on the full queue
    until the consumer leaves, then stops within its 0.2 s poll."""
    before = set(threading.enumerate())
    gen = BatchLoader(datasets[0], 1, shuffle=False, prefetch=1).epoch(0)
    assert next(gen)["hr"].shape == (1, 32, 32, 3)
    time.sleep(0.3)
    new = [t for t in threading.enumerate() if t not in before]
    assert len(new) == 1 and new[0].daemon and new[0].is_alive()  # blocked on its put
    gen.close()
    new[0].join(timeout=10)
    assert not new[0].is_alive()
