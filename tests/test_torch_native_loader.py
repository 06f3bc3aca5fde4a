"""The port's host loader (tgsr_tpu_torch/native: csrc/loader.c over
data/codec.py's decoders) against the PIL paths and JAX's native loader:

- `load_image` bit for bit the port's PIL-exact path
  (`_center_crop_resize(load_image_rgb(p))`) and JAX's PIL path
  (`tgsr_tpu.data.datasets._center_crop_resize(_load_image_rgb(p))`), on
  JPEGs and PNGs of many aspect ratios, at the eval crops' targets and
  enlargements;
- within 1 level of JAX's own native loader (`tgsr_tpu.native.load_image`,
  libjpeg / libpng and a float triangle filter) on 8-bit images; on a 16-bit
  grey PNG the two differ by design: the port follows PIL (clamped at 255),
  JAX's native loader takes the high byte (png_set_strip_16);
- `load_batch` equal to the stacked `load_image`s at 1, 3 and 8 threads;
  a file that does not decode raises, naming it (JAX's zero-fills and
  retries through PIL); `probe`, `decode`, and the numpy fallback without
  a C compiler."""

import numpy as np
import pytest
from PIL import Image

from tgsr_tpu import native as jnative
from tgsr_tpu.data import datasets as jds
from tgsr_tpu_torch import native
from tgsr_tpu_torch.data import codec
from tgsr_tpu_torch.data import datasets as tds
from tests.test_torch_image_fixtures import photo
from tests.torch_png_writer import write_png

SHAPES = ((375, 500), (500, 375), (256, 256), (37, 100), (300, 288), (288, 300), (1, 1),
          (601, 287))
CROPS = ((256, 72 / 64), (256, 76 / 64), (64, 1.0), (32, 0.5))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("loader")
    rng = np.random.default_rng(11)
    out = []
    for i, (h, w) in enumerate(SHAPES):
        img = photo(rng, h, w)
        if i % 2:
            p = d / f"img{i}.png"
            Image.fromarray(img).save(p)
        else:
            p = d / f"img{i}.jpg"
            Image.fromarray(img).save(p, "JPEG", quality=90, progressive=i % 4 == 2)
        out.append(str(p))
    return out


def test_load_image_equals_both_pil_paths(files):
    assert native.available()
    for p in files:
        for target, enlarge in CROPS:
            got = native.load_image(p, target, enlarge)
            assert got.shape == (target, target, 3) and got.dtype == np.uint8
            np.testing.assert_array_equal(
                got, tds._center_crop_resize(codec.load_image_rgb(p), target, enlarge),
                err_msg=p)
            np.testing.assert_array_equal(
                got, jds._center_crop_resize(jds._load_image_rgb(p), target, enlarge),
                err_msg=p)


def test_within_one_level_of_jax_native(files):
    assert jnative.available()
    for p in files:
        for target, enlarge in CROPS[:2]:
            got = native.load_image(p, target, enlarge).astype(int)
            want = jnative.load_image(p, target, enlarge).astype(int)
            assert np.abs(got - want).max() <= 1, p


def test_sixteen_bit_grey_is_pils_not_jax_natives(tmp_path):
    """A deliberate difference: PIL (and the port) clamp 16-bit grey at 255,
    JAX's native loader takes the high byte."""
    rng = np.random.default_rng(3)
    px = rng.integers(0, 1 << 16, (40, 50, 1))
    px[:5] = rng.integers(0, 256, (5, 50, 1))  # a band below 256, where clamping keeps it
    p = str(tmp_path / "g16.png")
    with open(p, "wb") as f:
        f.write(write_png(px, 0, 16))
    got = native.load_image(p, 32)
    np.testing.assert_array_equal(got, jds._center_crop_resize(jds._load_image_rgb(p), 32))
    high = np.repeat((px >> 8).astype(np.uint8), 3, -1)
    jax_native = jnative.load_image(p, 32)
    assert np.abs(jax_native.astype(int) - tds._center_crop_resize(high, 32)).max() <= 1
    assert np.abs(jax_native.astype(int) - got).max() > 100


@pytest.mark.parametrize("threads", [1, 3, 8])
def test_load_batch_equals_stacked(files, threads):
    for target, enlarge in CROPS[:2]:
        want = np.stack([native.load_image(p, target, enlarge) for p in files])
        np.testing.assert_array_equal(native.load_batch(files, target, enlarge, threads), want)


def test_bad_file_raises_naming_it(files, tmp_path):
    bad = tmp_path / "cut.jpg"
    with open(files[0], "rb") as f:
        bad.write_bytes(f.read()[:500])
    with pytest.raises(ValueError, match="cut.jpg"):
        native.load_batch(files[:3] + [str(bad)] + files[3:], 64, threads=4)
    with pytest.raises(ValueError, match="cut.jpg"):
        native.load_image(str(bad), 64)
    with pytest.raises(FileNotFoundError):
        native.load_batch([files[0], str(tmp_path / "absent.png")], 64)


def test_probe_and_decode(files):
    for p in files:
        img = codec.load_image_rgb(p)
        assert native.probe(p) == img.shape[:2]
        np.testing.assert_array_equal(native.decode(p), img)


def test_without_a_compiler_the_crop_runs_in_numpy(files, monkeypatch):
    want = native.load_image(files[1], 64, 76 / 64)
    monkeypatch.setattr(native, "_library", lambda: None)
    np.testing.assert_array_equal(native.load_image(files[1], 64, 76 / 64), want)
