"""The host image loader (counterpart of tgsr_tpu/native: its loader.cpp and
ctypes bindings): decode, then the eval crop, resize of the short side to
`max(int(target * enlarge), target)` (the long side truncated) and a centre
crop of target x target, on the host, in C where the system has a C
compiler.

- `load_image(path, target, enlarge=1.0)`: uint8 [target, target, 3], bit
  for bit `_center_crop_resize(load_image_rgb(path), target, enlarge)` of
  data/datasets.py, so bit for bit the JAX package's PIL path. (The JAX
  package's own native loader resizes with a float triangle filter, within
  1/255 of PIL, and reads 16-bit PNGs by their high byte where PIL clamps
  16-bit grey at 255.)
- `load_batch(paths, target, enlarge=1.0, threads=8)`: [N, target, target,
  3], `threads` Python threads over the C calls, which run without the
  interpreter lock (the JPEG decode, PNG's zlib inflate and row filters,
  and the resize).
- `probe(path)`: (height, width) from the file's header; `decode(path)`:
  the whole image, uint8 RGB.
- `available()`: whether the C code builds here.

Images are read by data/codec.py (PNG in every form, JPEG by
csrc/jpeg_decode.c); the crop is csrc/loader.c. A file that does not
decode raises, naming it: nothing is zero-filled. Without a C compiler the
crop runs data/datasets.py's numpy path (PNG only: JPEG needs the
compiler).
"""

from __future__ import annotations

import struct
from concurrent.futures import ThreadPoolExecutor
from typing import List, Sequence, Tuple

import numpy as np

from tgsr_tpu_torch.data import codec


def _library():
    from tgsr_tpu_torch.ops._build import host_library

    return host_library("loader")


def available() -> bool:
    """Whether the loader's C code (and the JPEG decoder's) builds here."""
    return _library() is not None and codec.jpeg_library() is not None


def crop_box(h: int, w: int, target: int, enlarge: float) -> Tuple[int, int, int, int]:
    """(resized h, resized w, top, left) of the eval crop of an h x w image:
    torchvision's Resize(int) geometry, then CenterCrop(target)."""
    pre = max(int(target * enlarge), target)
    if w <= h:
        ow, oh = pre, max(pre, int(pre * h / w))
    else:
        ow, oh = max(pre, int(pre * w / h)), pre
    return oh, ow, (oh - target) // 2, (ow - target) // 2


def crop_resize(img: np.ndarray, target: int, enlarge: float = 1.0) -> np.ndarray:
    """The eval crop of a uint8 RGB [H, W, 3] image, [target, target, 3]."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape[:2]
    rh, rw, top, left = crop_box(h, w, target, enlarge)
    lib = _library()
    if lib is None:
        from tgsr_tpu_torch.data.datasets import _center_crop_resize

        return _center_crop_resize(img, target, enlarge)
    out = np.empty((target, target, 3), np.uint8)
    if lib.resize_crop_bilinear(img.ctypes.data, h, w, rh, rw, top, left, target, target,
                                out.ctypes.data):
        raise MemoryError(f"resize of a {h} x {w} image to {rh} x {rw}")
    return out


def decode(path: str) -> np.ndarray:
    """The whole image at `path`, uint8 RGB [H, W, 3]."""
    return codec.load_image_rgb(path)


def probe(path: str) -> Tuple[int, int]:
    """(height, width) of the PNG or JPEG at `path`, from its header."""
    with open(path, "rb") as f:
        data = f.read(1 << 16)
        if data[:3] == codec.JPEG_SIGNATURE:
            data += f.read()  # the frame header may follow large APP segments
    if data[:8] == codec.PNG_SIGNATURE and data[12:16] == b"IHDR":
        w, h = struct.unpack(">II", data[16:24])
        return h, w
    if data[:3] == codec.JPEG_SIGNATURE:
        try:
            return codec.jpeg_size(data)
        except ValueError as e:
            raise ValueError(f"{path}: {e}") from None
    raise ValueError(f"{path}: not a PNG or JPEG image")


def load_image(path: str, target: int, enlarge: float = 1.0) -> np.ndarray:
    """Decode + the eval crop: uint8 [target, target, 3]."""
    return crop_resize(codec.load_image_rgb(path), target, enlarge)


def load_batch(paths: Sequence[str], target: int, enlarge: float = 1.0,
               threads: int = 8) -> np.ndarray:
    """`load_image` of each path on `threads` threads: [N, target, target,
    3] uint8, equal to the stacked `load_image`s. The first file that fails
    raises, naming it."""
    paths: List[str] = list(paths)
    out = np.empty((len(paths), target, target, 3), np.uint8)

    def one(i: int) -> None:
        out[i] = load_image(paths[i], target, enlarge)

    workers = max(1, min(int(threads), len(paths)))
    if workers == 1:
        for i in range(len(paths)):
            one(i)
        return out
    with ThreadPoolExecutor(workers) as pool:
        for f in [pool.submit(one, i) for i in range(len(paths))]:
            f.result()
    return out
