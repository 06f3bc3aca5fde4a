"""The two skimage.transform calls of the reference's attention grids, on
scipy.ndimage (counterpart of tgsr_tpu/utils/skimage_compat.py; skimage is
not installed, and modern skimage runs both calls on scipy.ndimage itself):

* `resize(img, shape, order=1, mode='reflect')` is
  `scipy.ndimage.zoom(img, out / in, order=1, mode='mirror', grid_mode=True)`
  (skimage's 'reflect' is numpy.pad naming, ndimage's 'mirror'); with
  `anti_aliasing=True` a `gaussian_filter(sigma=anti_aliasing_sigma)` runs
  first.
* `pyramid_expand(img, upscale, sigma)` in its multichannel-unaware form
  resizes every axis by `upscale`, the channel axis of an H x W x 3 input
  too, then smooths with one scalar sigma over all axes; a [32, 32, 3] map
  becomes [256, 256, 24] at upscale 8, which the grid's
  `np.resize(one_map, [256, 256, 3])` then crops (the reference's quirk).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
from scipy import ndimage as ndi

_SKIMAGE_TO_NDI_MODE = {
    "constant": "constant",
    "edge": "nearest",
    "symmetric": "reflect",
    "reflect": "mirror",
    "wrap": "wrap",
}


def resize(image: np.ndarray, output_shape: Sequence[int], order: int = 1,
           mode: str = "reflect", cval: float = 0.0, anti_aliasing: bool = False,
           anti_aliasing_sigma: Optional[float] = None) -> np.ndarray:
    """skimage.transform.resize on float64 (the clip is a no-op for order
    <= 1, whose output is a convex combination of the input)."""
    image = np.asarray(image, np.float64)
    output_shape = tuple(output_shape)
    if len(output_shape) < image.ndim:  # trailing axes keep their size
        output_shape = output_shape + image.shape[len(output_shape):]
    ndi_mode = _SKIMAGE_TO_NDI_MODE[mode]
    if anti_aliasing:
        sigma = anti_aliasing_sigma
        if sigma is None:  # skimage's default: max(0, (in / out - 1) / 2)
            factors = np.divide(image.shape, output_shape)
            sigma = np.maximum(0, (factors - 1) / 2)
        image = ndi.gaussian_filter(image, sigma, cval=cval, mode=ndi_mode)
    zoom_factors = [o / i for o, i in zip(output_shape, image.shape)]
    return ndi.zoom(image, zoom_factors, order=order, mode=ndi_mode, cval=cval, grid_mode=True)


def pyramid_expand(image: np.ndarray, upscale: int = 2, sigma: Optional[float] = None,
                   order: int = 1, mode: str = "reflect", cval: float = 0.0) -> np.ndarray:
    """skimage.transform.pyramid_expand with multichannel=False: every axis
    scales by `upscale`, then one scalar gaussian over all axes (sigma by
    default 2 * upscale / 6)."""
    image = np.asarray(image, np.float64)
    out_shape = tuple(math.ceil(upscale * d) for d in image.shape)
    if sigma is None:
        sigma = 2 * upscale / 6.0
    resized = resize(image, out_shape, order=order, mode=mode, cval=cval, anti_aliasing=False)
    return ndi.gaussian_filter(resized, sigma, mode=_SKIMAGE_TO_NDI_MODE[mode], cval=cval)
