"""The port's attention grids (tgsr_tpu_torch/utils/visualize.py) against
tgsr_tpu/utils/visualize.py on the same numpy-seeded images, captions and
maps, and the glyph atlas the port draws captions from.

- `make_atlas` is the function that made tgsr_tpu_torch/utils/glyph_atlas.npz:
  PIL's FreeType rendering of printable ASCII in DejaVu Sans Mono at 50 px,
  each glyph at each character place of a label. Where PIL and the font are
  present it regenerates the atlas and compares it with the committed file.
- Grids: bit for bit JAX's outside the caption band. Inside the band (the
  text), equal too where JAX draws with DejaVu Sans Mono, which the atlas
  holds; where JAX has fallen back to PIL's default font (no DejaVu font on
  the machine) the band is not compared, and the test says so.
- The pieces: the half-pixel bilinear against JAX's OpenCV call, the overlay
  against PIL's paste, the captions against PIL's ImageDraw.text, the scipy
  resizes against tgsr_tpu's.

Sizes are small (attention maps of 16 and 32 px, 2 images, 2-3 words each):
a pyramid_expand to 256 px takes about a second on one core.
"""

import os

import numpy as np
import pytest
from PIL import Image, ImageDraw, ImageFont

from tgsr_tpu.utils import skimage_compat as jskc
from tgsr_tpu.utils import visualize as jvis
from tgsr_tpu_torch.utils import skimage_compat as tskc
from tgsr_tpu_torch.utils import visualize as tvis

FONT = "/usr/share/fonts/truetype/dejavu/DejaVuSansMono.ttf"
WORDS = ["<end>", "Arched_Eyebrows", "Big_Lips", "5_o_Clock_Shadow", "wavy", "Smiling",
         "Mouth_Slightly_Open", "jaw", "Wearing_Hat", "Male", "Young", "Bald", "gray",
         "{x}", "W@M%", "bags_under"]
IXTOWORD = dict(enumerate(WORDS))


def make_atlas(font_path: str, size: int = 50, positions: int = 12, first: int = 32,
               last: int = 126) -> dict:
    """The arrays of glyph_atlas.npz: for each code point first..last and
    each character place p < positions of a label, the coverage PIL's
    ImageDraw.text gives the character drawn after p spaces at an integer
    origin (its sub-pixel phase at that place), cropped to its non-zero
    pixels, with the crop's offset (dx, dy) from the origin; all crops
    raveled into one uint8 buffer at `start`."""
    font = ImageFont.truetype(font_path, size)
    origin, canvas = 2 * size, (positions * size + 4 * size, 4 * size)
    n = last - first + 1
    dx, dy, h, w = (np.zeros((n, positions), np.int32) for _ in range(4))
    start = np.zeros((n, positions), np.int64)
    chunks, pos = [], 0
    for i in range(n):
        for p in range(positions):
            im = Image.new("L", canvas, 0)
            ImageDraw.Draw(im).text((origin, origin), " " * p + chr(first + i), font=font,
                                    fill=255)
            a = np.asarray(im)
            ys, xs = np.nonzero(a)
            start[i, p] = pos
            if len(ys):
                cov = a[ys.min():ys.max() + 1, xs.min():xs.max() + 1]
                dx[i, p], dy[i, p] = xs.min() - origin, ys.min() - origin
                h[i, p], w[i, p] = cov.shape
                chunks.append(cov.ravel())
                pos += cov.size
    return dict(first=np.int32(first), dx=dx, dy=dy, h=h, w=w, start=start,
                coverage=np.concatenate(chunks), font=np.str_(os.path.basename(font_path)),
                size=np.int32(size))


def _jax_has_dejavu() -> bool:
    """True where tgsr_tpu's default_font finds a DejaVu font (else it
    falls back to PIL's default bitmap font)."""
    return isinstance(jvis.default_font(50), ImageFont.FreeTypeFont)


def _text_checked(what: str) -> bool:
    if _jax_has_dejavu():
        return True
    print(f"{what}: no DejaVu font here, so tgsr_tpu draws its captions in PIL's default "
          "font; the caption band is not compared")
    return False


def _captions(rng, b, t, lens):
    cap = rng.integers(1, len(WORDS), (b, t))
    cap[np.arange(t)[None, :] >= np.asarray(lens)[:, None]] = 0
    return cap


def _band_rows(total: int, block: int) -> np.ndarray:
    """Rows of the caption bands: the first FONT_MAX rows of each block."""
    return (np.arange(total) % block) < jvis.FONT_MAX


def _assert_grid(got, want, block, what, resampled=False):
    """Equal outside the caption bands; with `resampled` (an image strip
    upsampled at a ratio where OpenCV's float32 rounding is not reproduced,
    test_bilinear_upsample_near_opencv_elsewhere) within one level there,
    in at most 0.1 % of the pixels, the count printed."""
    assert got is not None and want is not None
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    band = _band_rows(want.shape[0], block)
    if resampled:
        d = np.abs(got[~band].astype(np.int32) - want[~band])
        n = int(d.any(-1).sum())
        print(f"{what}: {n} of {d.shape[0] * d.shape[1]} pixels outside the captions "
              "differ, by one level")
        assert d.max() <= 1 and n <= 1e-3 * d.shape[0] * d.shape[1]
    else:
        np.testing.assert_array_equal(got[~band], want[~band])
    if _text_checked(what):
        n = int((got[band] != want[band]).any(-1).sum())
        assert n == 0, f"{what}: {n} caption-band pixels differ"


def test_atlas_regenerates_from_the_font():
    if not os.path.exists(FONT):
        pytest.skip(f"{FONT} is not installed: the atlas cannot be regenerated here")
    want = make_atlas(FONT)
    atlas = tvis.GlyphAtlas()
    with np.load(tvis.ATLAS_PATH, allow_pickle=False) as z:
        assert sorted(z.files) == sorted(want)
        for k, v in want.items():
            np.testing.assert_array_equal(z[k], v, err_msg=k)
    assert (atlas.font, atlas.size, atlas.positions) == ("DejaVuSansMono.ttf", 50, 12)


@pytest.mark.parametrize("numbered", [True, False])
def test_draw_caption_matches_pil(numbered):
    """Every word of the vocabulary in two captions of 18 words on the
    COLOR_DIC canvas, numbered ("17:Mouth_") and not: the port's atlas
    against tgsr_tpu's draw_caption through PIL and FreeType."""
    if not _text_checked("draw_caption"):
        return
    rng = np.random.default_rng(1)
    cap = np.stack([np.arange(1, 19) % (len(WORDS) - 1) + 1, rng.integers(1, len(WORDS), 18)])
    vis = 64
    canvas = np.ones([2 * jvis.FONT_MAX, 20 * (vis + 2), 3], np.uint8)
    for i in range(18):
        canvas[:, (i + 2) * (vis + 2):(i + 3) * (vis + 2)] = jvis.COLOR_DIC[i]
    want, wsent = jvis.draw_caption(canvas, cap, IXTOWORD, vis, numbered=numbered)
    got, tsent = tvis.draw_caption(canvas, cap, IXTOWORD, vis, numbered=numbered)
    assert tsent == wsent
    np.testing.assert_array_equal(got, np.asarray(want))
    assert (got != canvas).any()


def test_draw_caption_refuses_glyphs_outside_the_atlas():
    canvas = np.ones([jvis.FONT_MAX, 300, 3], np.uint8)
    with pytest.raises(ValueError, match="printable ASCII"):
        tvis.draw_caption(canvas, np.array([[1]]), {1: "tab\there"}, 64, numbered=False)


@pytest.mark.parametrize("size", [(64, 64), (32, 48), (48, 48), (256, 256), (300, 280)])
def test_bilinear_upsample_matches_jax(size):
    """The half-pixel bilinear to 256 px, bit for bit tgsr_tpu's OpenCV
    INTER_LINEAR on float32 (the same size: a copy)."""
    rng = np.random.default_rng(size[0])
    imgs = rng.uniform(-1, 1, (2, *size, 3)).astype(np.float32)
    np.testing.assert_array_equal(tvis._upsample_denorm(imgs, 256),
                                  jvis._upsample_denorm(imgs, 256))


@pytest.mark.parametrize("size,out", [((17, 17), 256), ((5, 17), 256), ((1, 17), 256),
                                      ((48, 48), 272), ((33, 20), 100)])
def test_bilinear_upsample_near_opencv_elsewhere(size, out):
    """Elsewhere OpenCV rounds part of its float32 bilinear its own way
    (which pixels depends on the ratio and on its row buffering; not
    reproduced; its fractions differ in the last bits at such ratios): the
    port is within 2^-16 of its values in [-1, 1] (1e-3 of a level), and
    the count of values that differ is printed."""
    import cv2

    rng = np.random.default_rng(size[1] + out)
    img = rng.uniform(-1, 1, (*size, 3)).astype(np.float32)
    got = tvis.bilinear_upsample(img, out, out)
    want = cv2.resize(img, (out, out), interpolation=cv2.INTER_LINEAR).reshape(got.shape)
    print(f"{size} -> {out}: {int((got != want).sum())} of {want.size} values differ")
    assert np.abs(got - want).max() <= 2.0 ** -16


@pytest.mark.parametrize("alpha,resize_256,size", [(210, False, 256), (180, True, 256),
                                                   (180, True, 128), (210, False, 272)])
def test_paste_overlay_matches_pil(alpha, resize_256, size):
    rng = np.random.default_rng(alpha + size)
    img = rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
    att = rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
    vis = 256 if resize_256 else size
    np.testing.assert_array_equal(tvis._paste_overlay(img, att, vis, alpha, resize_256),
                                  jvis._paste_overlay(img, att, vis, alpha, resize_256))


def test_skimage_compat_matches_jax():
    rng = np.random.default_rng(3)
    a = rng.uniform(0, 1, (16, 16, 3))
    np.testing.assert_array_equal(tskc.pyramid_expand(a, sigma=20, upscale=4),
                                  jskc.pyramid_expand(a, sigma=20, upscale=4))
    np.testing.assert_array_equal(
        tskc.resize(a, (64, 64), anti_aliasing=True, anti_aliasing_sigma=20),
        jskc.resize(a, (64, 64), anti_aliasing=True, anti_aliasing_sigma=20))
    np.testing.assert_array_equal(tskc.resize(a, (40, 24)), jskc.resize(a, (40, 24)))


def test_build_super_images_all_matches_jax():
    """The eval CLI's grid: uint8 SR images at 256 px, attention [B, T, 16,
    16], two images of 3 and 2 words."""
    rng = np.random.default_rng(4)
    lens = [3, 2]
    sr = rng.integers(0, 256, (2, 256, 256, 3), dtype=np.uint8)
    cap = _captions(rng, 2, 6, lens)
    attn = rng.dirichlet(np.ones(6), (2, 16, 16)).transpose(0, 3, 1, 2).astype(np.float32)
    for j in range(2):
        got, tsent = tvis.build_super_images_all(sr[j:j + 1], cap[j:j + 1], [lens[j]],
                                                 IXTOWORD, attn[j:j + 1])
        want, wsent = jvis.build_super_images_all(sr[j:j + 1], cap[j:j + 1], [lens[j]],
                                                  IXTOWORD, attn[j:j + 1])
        assert tsent == wsent
        assert got.shape == (jvis.FONT_MAX + 256, lens[j] * 258, 3)
        _assert_grid(got, want, jvis.FONT_MAX + 256, "build_super_images_all")


def test_build_super_images2_matches_jax():
    """The top-2 grid over float images of 64 px (upsampled to 256), maps
    of 32 px, one image's map at another geometry (the bilinear fallback)."""
    rng = np.random.default_rng(5)
    lens = [3, 2]
    imgs = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    cap = _captions(rng, 2, 6, lens)
    maps = [rng.dirichlet(np.ones(6), (32, 32)).transpose(2, 0, 1).astype(np.float32),
            rng.dirichlet(np.ones(6), (20, 20)).transpose(2, 0, 1).astype(np.float32)]
    got, tsent = tvis.build_super_images2(imgs, cap, lens, IXTOWORD, maps, 32, topK=2)
    want, wsent = jvis.build_super_images2(imgs, cap, lens, IXTOWORD, maps, 32, topK=2)
    assert tsent == wsent
    _assert_grid(got, want, jvis.FONT_MAX + 256, "build_super_images2")


@pytest.mark.parametrize("att_sze,with_lr", [(16, True), (17, False)])
def test_build_super_images_matches_jax(att_sze, with_lr):
    """The training grid: 48 px images (upsampled to 256, or 272 at
    att_sze 17), an optional 24 px LR strip, the channelwise-max map first,
    captions of 2 and 1 words on the COLOR_DIC background."""
    rng = np.random.default_rng(att_sze)
    imgs = rng.uniform(-1, 1, (2, 48, 48, 3)).astype(np.float32)
    lr = rng.uniform(-1, 1, (2, 24, 24, 3)).astype(np.float32) if with_lr else None
    cap = _captions(rng, 2, 4, [2, 1])
    maps = [rng.dirichlet(np.ones(2), (att_sze, att_sze)).transpose(2, 0, 1).astype(np.float32)
            for _ in range(2)]
    kw = dict(lr_imgs=lr, max_word_num=4)
    got, tsent = tvis.build_super_images(imgs, cap, IXTOWORD, maps, att_sze, **kw)
    want, wsent = jvis.build_super_images(imgs, cap, IXTOWORD, maps, att_sze, **kw)
    assert tsent == wsent
    vis = 272 if att_sze == 17 else 256
    _assert_grid(got, want, jvis.FONT_MAX + 2 * vis, "build_super_images",
                 resampled=vis == 272)  # 48 -> 272 px
