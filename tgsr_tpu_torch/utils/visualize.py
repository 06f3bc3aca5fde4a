"""Attention-map grids (counterpart of tgsr_tpu/utils/visualize.py, the
reference's COLOR_DIC, drawCaption / drawCaption_no_order,
build_super_images / build_super_images2 / build_super_imagesall), on the
host in numpy and scipy, without PIL or OpenCV:

* the image upsample is the half-pixel bilinear of the reference's
  nn.Upsample(align_corners=False), computed as the JAX package's OpenCV call
  computes it on float32 at the ratios its grids use (each pass a linear
  interpolation x0 + (x1 - x0) * f with one rounding, the product fused):
  bit for bit at the same size (the eval CLI) and at whole-number upsamples
  to 256 px; at other ratios OpenCV's own rounding is not reproduced, and
  the two agree within 2^-16 before the grid rounds to uint8;
* the overlay is PIL's paste of an RGB map with a constant 'L' alpha mask,
  its integer blend written out: t = map * m + img * (255 - m) + 128, then
  (t + (t >> 8)) >> 8, after PIL's default BICUBIC resize to 256 px (through
  data/codec.py);
* the captions are drawn from a glyph atlas (`glyph_atlas.npz` beside this
  module): printable ASCII of DejaVu Sans Mono at 50 px, the font the JAX
  package picks first, each glyph's coverage as PIL's FreeType rendering
  gives it at each of the first `positions` character places of a label (the
  font's advance is not a whole number of pixels, so each place has its own
  sub-pixel phase); a label's glyphs are combined as PIL combines them
  (t + (255 - t) * g / 255, rounded as above) and white is blended in by
  that coverage, as ImageDraw.text blends its fill. The atlas is made, and
  checked against PIL, by tests/test_torch_visualize.py.

Everything else follows the JAX module operation for operation, including
the reference's quirks: pyramid_expand without multichannel doubles the
channel axis too, and `np.resize(one_map, [256, 256, 3])` then crops the
raveled buffer.

Images are NHWC float in [-1, 1]; attention maps are [T, h, w] per image.
"""

from __future__ import annotations

import functools
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from tgsr_tpu_torch.data.codec import resize_pil
from tgsr_tpu_torch.utils import skimage_compat as skc

COLOR_DIC = {
    0: [128, 64, 128], 1: [244, 35, 232],
    2: [70, 70, 70], 3: [102, 102, 156],
    4: [190, 153, 153], 5: [153, 153, 153],
    6: [250, 170, 30], 7: [220, 220, 0],
    8: [107, 142, 35], 9: [152, 251, 152],
    10: [70, 130, 180], 11: [220, 20, 60],
    12: [255, 0, 0], 13: [0, 0, 142],
    14: [119, 11, 32], 15: [0, 60, 100],
    16: [0, 80, 100], 17: [0, 0, 230],
    18: [0, 0, 70], 19: [0, 0, 0],
}
FONT_MAX = 50
ATLAS_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "glyph_atlas.npz")


def _div255(t: np.ndarray) -> np.ndarray:
    """PIL's DIV255 of an int64 array (its blends' rounding of x / 255)."""
    t = t + 128
    return (t + (t >> 8)) >> 8


class GlyphAtlas:
    """Glyph coverage of one font at one size (the arrays of glyph_atlas.npz):
    for code point c and character place i of a label, a uint8 [h, w]
    coverage whose top-left lies (dx, dy) from the label's origin."""

    def __init__(self, path: str = ATLAS_PATH):
        with np.load(path, allow_pickle=False) as z:
            self.first = int(z["first"])
            self.dx, self.dy = z["dx"], z["dy"]
            self.h, self.w, self.start = z["h"], z["w"], z["start"]
            self.coverage = z["coverage"]
            self.font = str(z["font"])
            self.size = int(z["size"])
        self.positions = self.dx.shape[1]

    def glyph(self, ch: str, place: int) -> Tuple[int, int, np.ndarray]:
        """(dx, dy, coverage) of `ch` at character place `place`."""
        i = ord(ch) - self.first
        if not 0 <= i < self.dx.shape[0]:
            raise ValueError(f"no glyph for {ch!r}: the atlas holds printable ASCII")
        if place >= self.positions:
            raise ValueError(f"a label of more than {self.positions} characters")
        h, w, s = int(self.h[i, place]), int(self.w[i, place]), int(self.start[i, place])
        return (int(self.dx[i, place]), int(self.dy[i, place]),
                self.coverage[s:s + h * w].reshape(h, w))

    def label_mask(self, text: str) -> Tuple[int, int, np.ndarray]:
        """(x0, y0, coverage int64 [H, W]) of a label drawn at the origin."""
        glyphs = [self.glyph(ch, i) for i, ch in enumerate(text)]
        glyphs = [g for g in glyphs if g[2].size]
        if not glyphs:
            return 0, 0, np.zeros((0, 0), np.int64)
        x0 = min(dx for dx, _, _ in glyphs)
        y0 = min(dy for _, dy, _ in glyphs)
        x1 = max(dx + g.shape[1] for dx, _, g in glyphs)
        y1 = max(dy + g.shape[0] for _, dy, g in glyphs)
        mask = np.zeros((y1 - y0, x1 - x0), np.int64)
        for dx, dy, g in glyphs:
            t = mask[dy - y0:dy - y0 + g.shape[0], dx - x0:dx - x0 + g.shape[1]]
            t += _div255((255 - t) * g)
        return x0, y0, mask

    def draw(self, canvas: np.ndarray, xy: Tuple[int, int], text: str) -> None:
        """Blends white into uint8 RGB `canvas` by the label's coverage, the
        label's origin at integer (x, y), clipped to the canvas."""
        x0, y0, mask = self.label_mask(text)
        if not mask.size:
            return
        x0, y0 = x0 + xy[0], y0 + xy[1]
        H, W = canvas.shape[:2]
        cy0, cx0 = max(y0, 0), max(x0, 0)
        cy1, cx1 = min(y0 + mask.shape[0], H), min(x0 + mask.shape[1], W)
        if cy0 >= cy1 or cx0 >= cx1:
            return
        m = mask[cy0 - y0:cy1 - y0, cx0 - x0:cx1 - x0, None]
        region = canvas[cy0:cy1, cx0:cx1].astype(np.int64)
        canvas[cy0:cy1, cx0:cx1] = _div255(region * (255 - m) + 255 * m).astype(np.uint8)


@functools.lru_cache(maxsize=1)
def default_font() -> GlyphAtlas:
    """The packaged atlas (DejaVu Sans Mono, 50 px)."""
    return GlyphAtlas()


def draw_caption(convas: np.ndarray, captions: np.ndarray, ixtoword, vis_size: int,
                 off1: int = 2, off2: int = 2, numbered: bool = True,
                 font: Optional[GlyphAtlas] = None) -> Tuple[np.ndarray, List[List[str]]]:
    """drawCaption (numbered) / drawCaption_no_order: each caption's words on
    row i of a copy of the canvas at column pitch (vis_size + off2), up to
    the <end> = 0 token. Returns (uint8 canvas, the sentences' words)."""
    fnt = font or default_font()
    img_txt = np.array(convas, np.uint8)
    sentence_list = []
    for i in range(captions.shape[0]):
        cap = np.asarray(captions[i])
        sentence = []
        for j in range(len(cap)):
            if cap[j] == 0:
                break
            word = ixtoword[int(cap[j])].encode("ascii", "ignore").decode("ascii")
            label = "%d:%s" % (j, word[:6]) if numbered else "%s" % word[:6]
            fnt.draw(img_txt, ((j + off1) * (vis_size + off2), i * FONT_MAX), label)
            sentence.append(word)
        sentence_list.append(sentence)
    return img_txt, sentence_list


def _lerp_coeffs(in_size: int, out_size: int):
    """Source index pairs and float32 fractions of the half-pixel bilinear:
    x = (d + 0.5) * in / out - 0.5 in float32, clamped to the edges."""
    fx = ((np.arange(out_size) + 0.5) * (in_size / out_size) - 0.5).astype(np.float32)
    sx = np.floor(fx).astype(np.int64)
    fx = (fx - sx).astype(np.float32)
    lo, hi = sx < 0, sx >= in_size - 1
    fx[lo | hi] = 0
    sx[lo] = 0
    sx[hi] = in_size - 1
    return sx, np.minimum(sx + 1, in_size - 1), fx


def _lerp(x0: np.ndarray, x1: np.ndarray, f: np.ndarray) -> np.ndarray:
    """float32 x0 + (x1 - x0) * f with the multiply-add rounded once (the
    product of two float32 is exact in float64)."""
    d = (x1 - x0).astype(np.float64)
    return (x0.astype(np.float64) + d * f).astype(np.float32)


def bilinear_upsample(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """float32 [H, W, C] -> [out_h, out_w, C], the half-pixel bilinear of
    nn.Upsample(mode='bilinear', align_corners=False): the horizontal pass,
    then the vertical, each a rounded linear interpolation."""
    img = np.asarray(img, np.float32)
    sx, sx1, fx = _lerp_coeffs(img.shape[1], out_w)
    sy, sy1, fy = _lerp_coeffs(img.shape[0], out_h)
    rows = _lerp(img[:, sx], img[:, sx1], fx[None, :, None])
    return _lerp(rows[sy], rows[sy1], fy[:, None, None])


def _upsample_denorm(imgs: np.ndarray, vis_size: int) -> np.ndarray:
    """Bilinear (align_corners=False) to (vis, vis), then [-1, 1] -> [0, 255]
    float."""
    imgs = np.asarray(imgs, np.float32)
    out = np.empty((imgs.shape[0], vis_size, vis_size, 3), np.float32)
    for i in range(imgs.shape[0]):
        out[i] = bilinear_upsample(imgs[i], vis_size, vis_size)
    return (out + 1.0) / 2.0 * 255.0


def _paste_overlay(img_u8: np.ndarray, att_u8: np.ndarray, vis_size: int, alpha: int,
                   resize_256: bool = False) -> np.ndarray:
    """PIL's RGBA paste of `att_u8` over `img_u8` with a constant 'L' mask
    `alpha` on a (vis, vis) canvas (alpha 210, or 180 after PIL's default
    BICUBIC resize of both to 256 px)."""
    if resize_256:
        img_u8, att_u8 = resize_pil(img_u8, (256, 256)), resize_pil(att_u8, (256, 256))
    merged = np.zeros((vis_size, vis_size, 3), np.int64)
    h, w = min(vis_size, img_u8.shape[0]), min(vis_size, img_u8.shape[1])
    merged[:h, :w] = img_u8[:h, :w]
    h, w = min(vis_size, att_u8.shape[0]), min(vis_size, att_u8.shape[1])
    merged[:h, :w] = _div255(att_u8[:h, :w].astype(np.int64) * alpha
                             + merged[:h, :w] * (255 - alpha))
    return merged.astype(np.uint8)


def build_super_images(real_imgs: np.ndarray, captions: np.ndarray, ixtoword: dict,
                       attn_maps: Sequence[np.ndarray], att_sze: int,
                       lr_imgs: Optional[np.ndarray] = None,
                       batch_size: Optional[int] = None, max_word_num: int = 18,
                       font: Optional[GlyphAtlas] = None
                       ) -> Tuple[Optional[np.ndarray], List[List[str]]]:
    """Training-time attention grid: per image three stacked strips (the
    caption on COLOR_DIC column backgrounds; LR + raw maps; image + alpha-210
    overlays), a channelwise-max map first, min / max normalised over all
    maps of one image, maps upscaled by skimage's resize with
    anti_aliasing_sigma 20."""
    nvis = min(8, len(attn_maps))
    real_imgs = np.asarray(real_imgs)[:nvis]
    if batch_size is None:
        batch_size = real_imgs.shape[0]
    vis_size = att_sze * 16 if att_sze == 17 else 256

    text_convas = np.ones([batch_size * FONT_MAX, (max_word_num + 2) * (vis_size + 2), 3],
                          dtype=np.uint8)
    for i in range(max_word_num):
        istart = (i + 2) * (vis_size + 2)
        iend = (i + 3) * (vis_size + 2)
        text_convas[:, istart:iend, :] = COLOR_DIC[i]

    real = _upsample_denorm(real_imgs, vis_size)
    middle_pad = np.zeros([vis_size, 2, 3])
    post_pad = np.zeros([vis_size, vis_size, 3])
    if lr_imgs is not None:
        lr = _upsample_denorm(np.asarray(lr_imgs)[:nvis], vis_size)
        lr = np.round(np.maximum(0, np.minimum(255, lr)))

    seq_len = max_word_num
    text_map, sentences = draw_caption(text_convas, captions, ixtoword, vis_size, font=font)

    img_set = []
    for i in range(nvis):
        attn = np.asarray(attn_maps[i], np.float32).reshape(-1, att_sze, att_sze)
        attn = np.concatenate([attn.max(0, keepdims=True), attn], 0)
        attn = np.repeat(attn[:, :, :, None], 3, axis=-1)
        num_attn = attn.shape[0]

        img = np.round(np.maximum(0, np.minimum(255, real[i])))
        lrI = img if lr_imgs is None else lr[i]
        row = [lrI, middle_pad]
        row_merge = [img, middle_pad]
        row_beforeNorm = []
        minVglobal, maxVglobal = 1, 0
        for j in range(num_attn):
            one_map = attn[j]
            if (vis_size // att_sze) > 1:
                one_map = skc.resize(one_map, (vis_size, vis_size), anti_aliasing=True,
                                     anti_aliasing_sigma=20)
            row_beforeNorm.append(one_map)
            minVglobal = min(minVglobal, one_map.min())
            maxVglobal = max(maxVglobal, one_map.max())
        for j in range(seq_len + 1):
            if j < num_attn:
                one_map = (row_beforeNorm[j] - minVglobal) / (maxVglobal - minVglobal) * 255
                merged = _paste_overlay(np.uint8(img), np.uint8(one_map), vis_size, alpha=210)
            else:
                one_map = post_pad
                merged = post_pad
            row.extend([one_map, middle_pad])
            row_merge.extend([merged, middle_pad])
        row = np.concatenate(row, 1)
        row_merge = np.concatenate(row_merge, 1)
        txt = text_map[i * FONT_MAX: (i + 1) * FONT_MAX]
        if txt.shape[1] != row.shape[1]:
            return None, sentences
        img_set.append(np.concatenate([txt, row, row_merge], 0))
    return np.concatenate(img_set, 0).astype(np.uint8), sentences


def _bilinear_align_false(maps: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """torch F.interpolate(mode='bilinear', align_corners=False) over a
    [N, h, w] stack: the upsample of the reference's shape-mismatch
    fallback."""
    n, h, w = maps.shape
    ys = np.maximum((np.arange(out_h) + 0.5) * (h / out_h) - 0.5, 0.0)
    xs = np.maximum((np.arange(out_w) + 0.5) * (w / out_w) - 0.5, 0.0)
    y0 = np.floor(ys).astype(np.int64)
    x0 = np.floor(xs).astype(np.int64)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    fy = (ys - y0).astype(np.float32)[None, :, None]
    fx = (xs - x0).astype(np.float32)[None, None, :]
    top = maps[:, y0][:, :, x0] * (1 - fx) + maps[:, y0][:, :, x1] * fx
    bot = maps[:, y1][:, :, x0] * (1 - fx) + maps[:, y1][:, :, x1] * fx
    return top * (1 - fy) + bot * fy


def _build_super_images2_core(real_imgs, captions, cap_lens, ixtoword, attn_maps, att_sze,
                              att_sze1, vis_size, topK, reorder, numbered, font):
    """The shared body of build_super_images2 (reorder, top K) and
    build_super_imagesall (caption order, every word)."""
    real_imgs = np.asarray(real_imgs)
    batch_size = real_imgs.shape[0]
    if att_sze1 is None:
        att_sze1 = att_sze
    cap_lens = np.asarray(cap_lens)
    max_word_num = int(np.max(cap_lens))
    text_convas = np.ones([batch_size * FONT_MAX, max_word_num * (vis_size + 2), 3],
                          dtype=np.uint8)

    real = _upsample_denorm(real_imgs, vis_size)
    real = np.round(np.maximum(0, np.minimum(255, real)))
    middle_pad = np.zeros([vis_size, 2, 3])

    num = len(attn_maps)
    text_map, sentences = draw_caption(text_convas, captions, ixtoword, vis_size, off1=0,
                                       numbered=numbered, font=font)

    img_set = []
    for i in range(num):
        a = np.asarray(attn_maps[i], np.float32)
        if a.size % (att_sze * att_sze1) == 0:
            attn = a.reshape(-1, att_sze, att_sze1)
        else:
            # the reference's fallback: a map whose geometry disagrees with
            # att_sze is bilinearly resized per word instead of raising
            attn = _bilinear_align_false(a.reshape(-1, a.shape[-2], a.shape[-1]), att_sze,
                                         att_sze1)
        attn = np.repeat(attn[:, :, :, None], 3, axis=-1)
        num_attn = int(cap_lens[i])
        thresh = 2.0 / float(num_attn)
        img = real[i]
        row, row_merge, row_txt = [], [], []
        row_beforeNorm, conf_score = [], []
        for j in range(num_attn):
            one_map = attn[j]
            mask0 = one_map > (2.0 * thresh)
            conf_score.append(np.sum(one_map * mask0))
            mask = one_map > thresh
            one_map = one_map * mask
            if (vis_size // att_sze) > 1:
                # multichannel-unaware: the channel axis scales too, and
                # np.resize below crops the raveled buffer (the reference's
                # scrambled output, kept)
                one_map = skc.pyramid_expand(one_map, sigma=20, upscale=vis_size // att_sze)
            minV, maxV = one_map.min(), one_map.max()
            one_map = (one_map - minV) / (maxV - minV)
            row_beforeNorm.append(one_map)
        sorted_indices = np.argsort(conf_score)[::-1]

        for j in range(num_attn):
            one_map = row_beforeNorm[j] * 255
            one_map = np.resize(one_map, [256, 256, 3])
            merged = _paste_overlay(np.uint8(img), np.uint8(one_map), vis_size, alpha=180,
                                    resize_256=True)
            row.append(np.concatenate([one_map, middle_pad], 1))
            row_merge.append(np.concatenate([merged, middle_pad], 1))
            row_txt.append(text_map[i * FONT_MAX:(i + 1) * FONT_MAX,
                                    j * (vis_size + 2):(j + 1) * (vis_size + 2), :])
        order = list(sorted_indices) if reorder else list(range(num_attn))
        k = topK if reorder else num_attn
        row = np.concatenate([row[idx] for idx in order][:k], 1)
        row_merge = np.concatenate([row_merge[idx] for idx in order][:k], 1)
        txt = np.concatenate([row_txt[idx] for idx in order][:k], 1)
        if txt.shape[1] != row.shape[1]:
            return None, sentences
        img_set.append(np.concatenate([txt, row_merge], 0))
    return np.concatenate(img_set, 0).astype(np.uint8), sentences


def build_super_images2(real_imgs: np.ndarray, captions: np.ndarray, cap_lens: Sequence[int],
                        ixtoword: dict, attn_maps: Sequence[np.ndarray], att_sze: int,
                        att_sze1: Optional[int] = None, vis_size: int = 256, topK: int = 5,
                        font: Optional[GlyphAtlas] = None
                        ) -> Tuple[Optional[np.ndarray], List[List[str]]]:
    """Eval-time top-K grid: per word, confidence = the sum of attention
    above 2 * (2 / T); maps thresholded at 2 / T, pyramid_expand(sigma 20)
    smoothed, each normalised, alpha-180 merged; columns sorted by
    confidence, the top K kept; [numbered caption strip; merged overlays]."""
    return _build_super_images2_core(real_imgs, captions, cap_lens, ixtoword, attn_maps,
                                     att_sze, att_sze1, vis_size, topK, reorder=True,
                                     numbered=True, font=font)


def build_super_imagesall(real_imgs: np.ndarray, captions: np.ndarray,
                          cap_lens: Sequence[int], ixtoword: dict,
                          attn_maps: Sequence[np.ndarray], att_sze: int,
                          att_sze1: Optional[int] = None, vis_size: int = 256,
                          font: Optional[GlyphAtlas] = None
                          ) -> Tuple[Optional[np.ndarray], List[List[str]]]:
    """Every word's grid in caption order, un-numbered text (the eval CLI's
    grid)."""
    return _build_super_images2_core(real_imgs, captions, cap_lens, ixtoword, attn_maps,
                                     att_sze, att_sze1, vis_size, topK=None, reorder=False,
                                     numbered=False, font=font)


def build_super_images_all(images: np.ndarray, captions: np.ndarray, cap_lens: Sequence[int],
                           ixtoword: dict, attn_maps: np.ndarray, vis_size: int = 256
                           ) -> Tuple[Optional[np.ndarray], List[List[str]]]:
    """build_super_imagesall for uint8 NHWC images (cli/test.py)."""
    images = np.asarray(images)
    if images.dtype == np.uint8:
        images = images.astype(np.float32) / 127.5 - 1.0
    attn = np.asarray(attn_maps)
    return build_super_imagesall(images, np.asarray(captions), cap_lens, ixtoword, attn,
                                 att_sze=attn.shape[-2], att_sze1=attn.shape[-1],
                                 vis_size=vis_size)
