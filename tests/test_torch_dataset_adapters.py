"""The port's JPEG dataset adapters against tgsr_tpu's on the same
synthetic trees (tests/torch_jpeg_data.py): `TextFlowerDataset`
(Oxford-102, '{}' placeholder lines, the last 3 files of a class the test
split, the eval addressing filenames[::3] / captions[::embeddings_num * 3]),
`TextCocoDataset` (train2014 / val2014 images) and the bird-layout
`TextDataset` (CUB bounding-box crops of JPEGs). Filenames, captions, class
ids, vocabularies, the caption caches and every `Example` are equal: the
train split's random crops and flips under the same numpy rng, the test
split's centre crops (the port's through its C loader, JAX pinned to its
PIL path, as the existing CLI tests pin it). `tgsr_tpu_torch.data` exports
what `tgsr_tpu.data` exports."""

import os
import pickle
import shutil

import numpy as np
import pytest

import tgsr_tpu.data as jdata
from tgsr_tpu import native as jnative
from tgsr_tpu.data import datasets as jds
import tgsr_tpu_torch.data as tdata
from tgsr_tpu_torch.data import datasets as tds
from tests.torch_jpeg_data import make_flower_tree, make_text_tree


@pytest.fixture(autouse=True)
def jax_pil_path(monkeypatch):
    monkeypatch.setattr(jnative, "available", lambda: False)


def _twin_dirs(tmp_path, name, build):
    """The same tree twice, one for each package (each writes its cache)."""
    a = tmp_path / "jax" / name
    build(str(a))
    b = tmp_path / "port" / name
    shutil.copytree(a, b)
    return str(a), str(b)


def _same(jd, td, rng_seed=0):
    assert td.filenames == jd.filenames
    assert td.captions == jd.captions
    np.testing.assert_array_equal(td.class_id, jd.class_id)
    assert td.vocab.ixtoword == jd.vocab.ixtoword and td.vocab.wordtoix == jd.vocab.wordtoix
    assert (td.embeddings_num, td.augment) == (jd.embeddings_num, jd.augment)
    for i in range(len(jd)):
        je = jd.__getitem__(i, np.random.default_rng(rng_seed + i))
        te = td.__getitem__(i, np.random.default_rng(rng_seed + i))
        np.testing.assert_array_equal(te.hr, je.hr, err_msg=je.key)
        np.testing.assert_array_equal(te.tokens, je.tokens)
        assert (te.length, te.class_id, te.key) == (je.length, je.class_id, je.key)
        assert te.hr.dtype == np.uint8 and te.hr.shape == (td.imsize, td.imsize, 3)


def _same_cache(a, b, name):
    with open(os.path.join(a, name), "rb") as f:
        ja = pickle.load(f)
    with open(os.path.join(b, name), "rb") as f:
        ta = pickle.load(f)
    assert ta == ja


@pytest.mark.parametrize("split", ["train", "test"])
def test_flower_adapter_matches_jax(tmp_path, split):
    a, b = _twin_dirs(tmp_path, "flowers", lambda d: make_flower_tree(d, seed=1))
    jd = jds.TextFlowerDataset(a, split=split, imsize=64, embeddings_num=3)
    td = tds.TextFlowerDataset(b, split=split, imsize=64, embeddings_num=3)
    _same_cache(a, b, "captions_flower_v2.pickle")
    assert len(td) == (6 if split == "train" else 3)
    _same(jd, td)
    # the cache is read back the same way
    _same(jds.TextFlowerDataset(a, split=split, imsize=64, embeddings_num=3),
          tds.TextFlowerDataset(b, split=split, imsize=64, embeddings_num=3), rng_seed=7)


@pytest.mark.parametrize("split", ["train", "test"])
def test_coco_adapter_matches_jax(tmp_path, split):
    a, b = _twin_dirs(tmp_path, "coco", lambda d: make_text_tree(d, "coco", seed=2))
    jd = jds.TextCocoDataset(a, split=split, imsize=64, embeddings_num=2)
    td = tds.TextCocoDataset(b, split=split, imsize=64, embeddings_num=2)
    _same_cache(a, b, "captions.pickle")
    _same(jd, td)


@pytest.mark.parametrize("split", ["train", "test"])
def test_bird_jpeg_adapter_matches_jax(tmp_path, split):
    a, b = _twin_dirs(tmp_path, "birds", lambda d: make_text_tree(d, "bird", seed=3))
    for cls in (jds.TextDataset, jds.TextSRDataset):
        tcls = getattr(tds, cls.__name__)
        jd = cls(a, split=split, imsize=64, embeddings_num=2)
        td = tcls(b, split=split, imsize=64, embeddings_num=2)
        assert td.bbox == jd.bbox and td.bbox is not None
        _same(jd, td)


def test_exports_match():
    want = {n for n in dir(jdata) if not n.startswith("_") and n not in
            ("datasets", "tokenizer", "pipeline")}
    got = {n for n in dir(tdata) if not n.startswith("_")}
    assert want <= got
