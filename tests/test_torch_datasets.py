"""The port's eval datasets (tgsr_tpu_torch/data/datasets.py) and PIL-exact
image reading and resizing (data/codec.py) against tgsr_tpu's on the same
files: attribute and sentence captions, vocabularies, the example pickle and
its filenames, every example's HR crop bit for bit (JAX's PIL path,
`_center_crop_resize` / `_random_crop_flip`, not its native loader), the
arbitrary-size eval image, and PIL's BILINEAR over odd sizes, up and down.
"""

import dataclasses
import io
import os
import pickle
import shutil
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from tgsr_tpu.cli import test as jcli
from tgsr_tpu.config import config_from_file as jconfig_from_file
from tgsr_tpu.data import datasets as jds
from tgsr_tpu.data.tokenizer import Vocab as JVocab
from tgsr_tpu_torch.cli import test as tcli
from tgsr_tpu_torch.config import config_from_file
from tgsr_tpu_torch.data import codec
from tgsr_tpu_torch.data import datasets as tds
from tgsr_tpu_torch.data.tokenizer import Vocab
from tests.torch_cli_data import ATTRS, YAML, make_face_set


@pytest.fixture
def face(tmp_path):
    d = str(tmp_path / "face")
    make_face_set(d, n=6, seed=3, n_attr=(2, 9))
    return d


def _rgb(rng, h, w):
    return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)


@pytest.mark.parametrize("src,dst", [((37, 53), (16, 21)), ((17, 9), (45, 31)),
                                     ((150, 140), (144, 134)), ((5, 7), (5, 3)),
                                     ((64, 48), (64, 48)), ((1, 9), (3, 2))])
@pytest.mark.parametrize("method", ["bilinear", "bicubic"])
def test_resize_pil_matches_pillow(src, dst, method):
    rng = np.random.default_rng(src[0] * dst[1])
    img = _rgb(rng, *src)
    want = np.asarray(Image.fromarray(img).resize(
        (dst[1], dst[0]), Image.BILINEAR if method == "bilinear" else Image.BICUBIC))
    np.testing.assert_array_equal(codec.resize_pil(img, dst, method), want)


def test_resize_pil_refuses():
    with pytest.raises(ValueError, match="method"):
        codec.resize_pil(np.zeros((4, 4, 3), np.uint8), (2, 2), "lanczos")
    with pytest.raises(ValueError, match="uint8"):
        codec.resize_pil(np.zeros((4, 4, 3), np.float32), (2, 2))


@pytest.mark.parametrize("size,target", [((150, 140), 144), ((140, 150), 144), ((31, 77), 20),
                                         ((64, 64), 72)])
def test_crops_match_jax_pil_path(size, target):
    rng = np.random.default_rng(size[0] + target)
    img = _rgb(rng, *size)
    np.testing.assert_array_equal(tds._resize_short_side(img, target),
                                  jds._resize_short_side(img, target))
    np.testing.assert_array_equal(tds._center_crop_resize(img, 16, 72 / 64),
                                  jds._center_crop_resize(img, 16, 72 / 64))
    r1, r2 = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(3):
        np.testing.assert_array_equal(tds._random_crop_flip(img, 16, 76 / 64, r1),
                                      jds._random_crop_flip(img, 16, 76 / 64, r2))
    np.testing.assert_array_equal(tds.bbox_crop(img, [3, 4, 10, 7]),
                                  jds.bbox_crop(img, [3, 4, 10, 7]))


def test_attr_captions_match_jax(face):
    d = os.path.join(face, "attr")
    os.makedirs(d)
    shutil.copy(os.path.join(face, "testset.txt"), os.path.join(d, "list_attr_celeba.txt"))
    with open(os.path.join(d, "list_attr_celeba.txt"), "a") as f:
        f.write("\n")  # a blank row: skipped by both
        f.write("000099.jpg " + " ".join(["-1"] * len(ATTRS)) + "\n")  # -1: in neither split
    for train in (True, False):
        assert (tds.TextFaceDataset.load_attr_captions(d, train)
                == jds.TextFaceDataset.load_attr_captions(d, train))
    tr, names = tds.TextFaceDataset.load_attr_captions(d, True)
    assert len(tr) == 5 and names[0] == "000000.png" and all(tr)


def test_sentence_captions_match_jax(tmp_path):
    lines = ["0000001.jpg\tA woman, smiling.|She has  long hair.\n",
             "0000002.jpg\tA man with glasses|bald head.|wears a hat\n"] * 4
    (tmp_path / "caps.txt").write_text("".join(lines))
    for train in (True, False):
        assert (tds.TextFaceDataset.load_sentence_captions(str(tmp_path), train)
                == jds.TextFaceDataset.load_sentence_captions(str(tmp_path), train))


def test_face_dataset_examples_match_jax(face):
    """TextFaceDataset (train split: the random crop and flip ride the
    caller's rng; the vocabulary cache written in JAX's layout)."""
    for fn in os.listdir(os.path.join(face, "Img", "changetxt_im1")):
        shutil.copy(os.path.join(face, "Img", "changetxt_im1", fn), os.path.join(face, "Img", fn))
    shutil.copy(os.path.join(face, "testset.txt"), os.path.join(face, "list_attr_celeba.txt"))
    jdir = face + "_jax"
    shutil.copytree(face, jdir)
    t = tds.TextFaceDataset(face, split="train", words_num=6, imsize=16)
    j = jds.TextFaceDataset(jdir, split="train", words_num=6, imsize=16)
    with open(os.path.join(face, "captions_face.pickle"), "rb") as f1, \
            open(os.path.join(jdir, "captions_face.pickle"), "rb") as f2:
        assert pickle.load(f1) == pickle.load(f2)
    assert t.filenames == j.filenames and t.captions == j.captions
    assert t.vocab.ixtoword == j.vocab.ixtoword and len(t) == 5
    r1, r2 = np.random.default_rng(9), np.random.default_rng(9)
    for i in range(len(t)):
        a, b = t.__getitem__(i, rng=r1), j.__getitem__(i, rng=r2)
        np.testing.assert_array_equal(a.hr, b.hr)
        np.testing.assert_array_equal(a.tokens, b.tokens)
        assert (a.length, a.class_id, a.key) == (b.length, b.class_id, b.key)
    again = tds.TextFaceDataset(face, split="test", words_num=6, imsize=16)  # from the cache
    assert again.filenames == ["000005.png"]


@pytest.mark.parametrize("layout", ["image_dir", "attr_table", "partial"])
def test_example_pickle_and_dataset_match_jax(face, layout):
    """build_example_dataset for the face set: the generated testset.pickle
    equal to JAX's, the filenames (sorted image dir; the attribute table's
    train-then-test order when there is no image dir; only the present
    images of a partial snapshot, with JAX's warning), and every
    example's HR crop bit for bit JAX's PIL path."""
    img_dir = os.path.join(face, "Img", "changetxt_im1")
    if layout != "image_dir":  # the images beside testset.txt, one missing if partial
        for fn in os.listdir(img_dir):
            shutil.move(os.path.join(img_dir, fn), os.path.join(face, fn))
        shutil.rmtree(os.path.join(face, "Img"))
        if layout == "partial":
            os.remove(os.path.join(face, "000002.png"))
    jdir = face + "_jax"
    shutil.copytree(face, jdir)
    cfg_path = os.path.join(face, "cfg.yml")
    with open(cfg_path, "w") as f:
        f.write(YAML)
    tcfg = config_from_file(cfg_path)
    if layout == "partial":
        with pytest.warns(UserWarning, match="missing"):
            t = tcli.build_example_dataset(dataclasses.replace(tcfg, DATA_DIR=face))
        with pytest.warns(UserWarning, match="missing"):
            j = jcli.build_example_dataset(dataclasses.replace(jconfig_from_file(cfg_path),
                                                               DATA_DIR=jdir))
    else:
        t = tcli.build_example_dataset(dataclasses.replace(tcfg, DATA_DIR=face))
        j = jcli.build_example_dataset(dataclasses.replace(jconfig_from_file(cfg_path),
                                                           DATA_DIR=jdir))
    with open(os.path.join(face, "testset.pickle"), "rb") as f1, \
            open(os.path.join(jdir, "testset.pickle"), "rb") as f2:
        got, want = pickle.load(f1), pickle.load(f2)
    assert got == want and len(got[0]) == 6 and got[1][0] == "<end>"
    assert t.filenames == j.filenames and t.captions == j.captions
    assert len(t) == (5 if layout == "partial" else 6) and t.n_words == j.n_words
    for i in range(len(t)):
        a = t.__getitem__(i, rng=np.random.default_rng(i), sent_ix=0)
        path = os.path.join(jdir, j.image_subdir, j.filenames[i])
        if not os.path.exists(path):
            path = os.path.join(jdir, j.filenames[i])
        np.testing.assert_array_equal(
            a.hr, jds._center_crop_resize(jds._load_image_rgb(path), 128, 72 / 64))
        b = j.__getitem__(i, rng=np.random.default_rng(i), sent_ix=0)
        np.testing.assert_array_equal(a.tokens, b.tokens)
        assert (a.length, a.key) == (b.length, b.key)
    ex = [(t.__getitem__(i, rng=np.random.default_rng(i)),
           j.__getitem__(i, rng=np.random.default_rng(i))) for i in range(2)]
    batch = tds.prepare_batch([e[0] for e in ex])
    jbatch = jds.prepare_batch([e[1] for e in ex])
    assert batch.keys() == jbatch.keys() and batch["keys"] == jbatch["keys"]
    for k in ("captions", "cap_lens", "class_ids"):
        np.testing.assert_array_equal(batch[k], jbatch[k])
        assert batch[k].dtype == jbatch[k].dtype


def test_text_sr_dataset_and_bird_example_pickle_match_jax(tmp_path):
    """TextSRDataset's train vocabulary (captions5450.pickle) and the example
    pickle build_example_dataset tokenizes with it for a non-face set."""
    rng = np.random.default_rng(4)
    words = "a small bird with red wings and a short beak it has black eyes".split()
    d = tmp_path / "caption_set"
    for split, names in (("train", ["t0", "t1", "t2"]), ("test", ["e0"])):
        (d / split).mkdir(parents=True)
        with open(d / split / "filenames.pickle", "wb") as f:
            pickle.dump(names, f, protocol=2)
    (d / "text").mkdir()
    for name in ["t0", "t1", "t2", "e0"]:
        caps = [" ".join(rng.choice(words, rng.integers(3, 9))) + "." for _ in range(3)]
        (d / "text" / f"{name}.txt").write_text("\n".join(caps) + "\n")
    (d / "testset.txt").write_text("x0\nx1\n")
    for name in ("x0", "x1"):
        (d / f"{name}.txt").write_text("A red bird, small!\n\nblack beak and eyes\n")
    jd = tmp_path / "caption_set_jax"
    shutil.copytree(d, jd)
    kw = dict(split="train", words_num=6, embeddings_num=3)
    t, j = tds.TextSRDataset(str(d), **kw), jds.TextSRDataset(str(jd), **kw)
    assert t.captions == j.captions and t.vocab.ixtoword == j.vocab.ixtoword
    assert t.filenames == j.filenames and list(t.class_id) == list(j.class_id)
    test = tds.TextSRDataset(str(d), split="test", words_num=6, embeddings_num=3)
    jtest = jds.TextSRDataset(str(jd), split="test", words_num=6, embeddings_num=3)
    assert test.captions == jtest.captions and test.filenames == ["e0"]
    vt, vj = Vocab(t.vocab.ixtoword, t.vocab.wordtoix), JVocab(j.vocab.ixtoword, j.vocab.wordtoix)
    tcli.gen_example_pickle(str(d), vt, dataset="birds")
    jcli.gen_example_pickle(str(jd), vj, dataset="birds")
    with open(d / "testset.pickle", "rb") as f1, open(jd / "testset.pickle", "rb") as f2:
        got, want = pickle.load(f1), pickle.load(f2)
    assert got == want and len(got[0]) == 4


def test_arbitrary_eval_image_matches_jax(tmp_path):
    rng = np.random.default_rng(6)
    img = _rgb(rng, 75, 61)
    path = str(tmp_path / "x.png")
    Image.fromarray(img).save(path)
    for src in (path, img):
        lr, gt = tds.load_arbitrary_eval_image(src, 8)
        jlr, jgt = jds.load_arbitrary_eval_image(
            path if isinstance(src, str) else Image.fromarray(src), 8)
        assert lr.dtype == jlr.dtype == np.float32 and lr.shape == (1, 9, 7, 3)
        np.testing.assert_array_equal(lr, jlr)
        np.testing.assert_array_equal(gt, jgt)


def _png_with(ihdr_patch):
    """An 8-bit RGB PNG whose IHDR is patched (bit depth, interlace)."""
    data = bytearray(codec.encode_png(np.zeros((4, 4, 3), np.uint8)))
    body = bytearray(data[16:29])
    for k, v in ihdr_patch.items():
        body[k] = v
    data[16:29] = body
    data[29:33] = struct.pack(">I", zlib.crc32(b"IHDR" + bytes(body)))
    return bytes(data)


def test_load_image_rgb(tmp_path):
    rng = np.random.default_rng(7)
    img = _rgb(rng, 9, 13)
    for mode in ("RGB", "RGBA", "L", "P"):
        path = str(tmp_path / f"x_{mode}.png")
        Image.fromarray(img).convert(mode).save(path)
        np.testing.assert_array_equal(codec.load_image_rgb(path), jds._load_image_rgb(path))
    # JPEG (and every PNG form: tests/test_torch_png_forms.py) reads as PIL
    path = str(tmp_path / "x.jpg")
    Image.fromarray(img).save(path, format="JPEG")
    np.testing.assert_array_equal(codec.load_image_rgb(path), jds._load_image_rgb(path))
    # an 8-bit PNG's data under a 16-bit or an interlaced header no longer
    # fits it; GIF is queued as ROADMAP.md A 6
    gif = io.BytesIO()
    Image.fromarray(img).save(gif, format="GIF")
    cases = {"16bit.png": (_png_with({8: 16}), "shorter"),
             "interlaced.png": (_png_with({12: 1}), "shorter"), "gif": (gif.getvalue(), "A 6")}
    for name, (data, msg) in cases.items():
        path = tmp_path / f"bad.{name}"
        path.write_bytes(data)
        with pytest.raises(ValueError, match=msg) as e:
            codec.load_image_rgb(str(path))
        assert str(path) in str(e.value)
