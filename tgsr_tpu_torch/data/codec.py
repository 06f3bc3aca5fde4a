"""PNG in and out, and PIL's resizes, without PIL: what the serving CLI
needs to take an image from a request and give one back, and what the eval
datasets need to read their images.

- `decode_png(data)`: 8-bit PNGs of colour types 0 (grey), 2 (RGB),
  3 (palette), 4 (grey + alpha) and 6 (RGBA), not interlaced, all five row
  filters, to uint8 RGB [H, W, 3] exactly as PIL's `.convert("RGB")`: grey
  replicated, palette looked up, alpha dropped; the row filters undone by a
  C helper (csrc/png_unfilter.c, built by the system's C compiler), or in
  Python where there is none. JPEG, other bit depths,
  interlaced PNGs and images of more than MAX_IMAGE_PIXELS are refused with
  ValueError saying why; image data is inflated no further than the
  header's size.
- `encode_png(rgb, filter_rows=False)`: uint8 [H, W, 3] to an 8-bit RGB
  PNG, rows raw or filtered adaptively as PNG encoders filter them.
- `resize_pil(img, (h, w), "bicubic" | "bilinear")`: uint8 [H, W, C] resized
  bit for bit as `Image.resize((w, h), Image.BICUBIC / BILINEAR)`
  (Pillow's libImaging/Resample.c); `resize_pil_bicubic` is its bicubic form.
- `load_image_rgb(path)`: an image file as uint8 RGB [H, W, 3], as PIL's
  `Image.open(path).convert("RGB")` gives a PNG; other formats raise.
"""

from __future__ import annotations

import struct
import zlib
from typing import Tuple

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# the most pixels a decoded image may have (PIL's MAX_IMAGE_PIXELS), checked
# against the header before anything is inflated
MAX_IMAGE_PIXELS = 89478485
# colour type -> samples per pixel
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunks(data: bytes):
    pos = len(PNG_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length or pos + 12 + length > len(data):
            raise ValueError("truncated PNG chunk")
        crc = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])[0]
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        yield kind, body
        pos += 12 + length


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """The Paeth predictor of int16 left, up and upper-left bytes."""
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def unfilter_library():
    """The C helper that undoes the row filters (csrc/png_unfilter.c),
    compiled on first use; None without a C compiler. A server calls it at
    start, so that no request waits for the build."""
    from tgsr_tpu_torch.ops._build import host_library

    return host_library("png_unfilter")


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """The PNG row filters undone: [h, stride] uint8 from h rows of a filter
    byte and `stride` bytes; by the C helper, or in Python without it."""
    if len(raw) < h * (stride + 1):
        raise ValueError("PNG image data is shorter than its size")
    rows = np.frombuffer(raw, np.uint8, h * (stride + 1)).reshape(h, stride + 1)
    if rows[:, 0].max() > 4:
        y = int(np.argmax(rows[:, 0] > 4))
        raise ValueError(f"PNG row {y} has an unknown filter type {rows[y, 0]}")
    lib = unfilter_library()
    if lib is None:
        return _unfilter_python(rows, bpp)
    out = np.empty((h, stride), np.uint8)
    lib.png_unfilter(rows.ctypes.data, out.ctypes.data, h, stride, bpp)
    return out


def _unfilter_python(rows: np.ndarray, bpp: int) -> np.ndarray:
    """`_unfilter` in Python: vector steps for None, Sub and Up rows, a step
    per byte for Average and Paeth rows, whose bytes each need their left
    neighbour's result."""
    h, stride = rows.shape[0], rows.shape[1] - 1
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = rows[y, 0], rows[y, 1:]
        if kind == 0:  # None
            out[y] = line
        elif kind == 1:  # Sub: a running sum along each byte of the pixel
            out[y] = (np.cumsum(line.reshape(-1, bpp).astype(np.int64), 0) & 0xFF
                      ).reshape(-1)
        elif kind == 2:  # Up
            out[y] = line + prior
        else:  # Average, Paeth
            cur = bytearray(line.tobytes())
            up = prior.tobytes()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = up[i]
                if kind == 3:
                    cur[i] = (cur[i] + ((a + b) >> 1)) & 0xFF
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                    pred = a if pa <= pb and pa <= pc else b if pb <= pc else c
                    cur[i] = (cur[i] + pred) & 0xFF
            out[y] = np.frombuffer(bytes(cur), np.uint8)
        prior = out[y]
    return out


def decode_png(data: bytes) -> np.ndarray:
    """uint8 RGB [H, W, 3] of an 8-bit, non-interlaced PNG of colour type 0,
    2, 3, 4 or 6, as PIL's `Image.open(...).convert("RGB")` gives it.
    Raises ValueError for anything else, saying what it is."""
    if data[:3] == b"\xff\xd8\xff":
        raise ValueError("JPEG input is not supported: send a PNG")
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG image")
    header, palette, idat = None, None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            if len(body) != 13:
                raise ValueError(f"PNG IHDR chunk of {len(body)} bytes, not 13")
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without an IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if ctype not in _CHANNELS:
        raise ValueError(f"PNG colour type {ctype} is not supported")
    if depth != 8:
        raise ValueError(f"{depth}-bit PNGs are not supported: send an 8-bit PNG")
    if interlace:
        raise ValueError("interlaced PNGs are not supported")
    if w == 0 or h == 0:
        raise ValueError("PNG of size zero")
    if w * h > MAX_IMAGE_PIXELS:
        raise ValueError(f"PNG of {w} x {h} pixels, more than {MAX_IMAGE_PIXELS}")
    n = _CHANNELS[ctype]
    try:  # inflated no further than the header's size
        raw = zlib.decompressobj().decompress(b"".join(idat), h * (w * n + 1))
    except zlib.error as e:
        raise ValueError(f"PNG image data does not inflate: {e}") from None
    px = _unfilter(raw, h, w * n, n).reshape(h, w, n)
    if ctype == 3:
        if palette is None:
            raise ValueError("palette PNG without a PLTE chunk")
        # indices past the palette read black, as PIL's 256-entry palette
        full = np.zeros((256, 3), np.uint8)
        full[:len(palette)] = palette[:256]
        return full[px[..., 0]]
    if n <= 2:  # grey (+ alpha)
        return np.repeat(px[..., :1], 3, axis=-1)
    return np.ascontiguousarray(px[..., :3])


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def encode_png(rgb: np.ndarray, filter_rows: bool = False) -> bytes:
    """An 8-bit RGB PNG of uint8 [H, W, 3]; zlib level 6, PIL's default.
    Rows are written raw (filter None), the cheapest on the host; with
    `filter_rows` each row under the filter whose bytes, read as signed,
    sum smallest in magnitude: libpng's adaptive heuristic, as PNG encoders
    write photos, at several times the host time."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[-1] != 3:
        raise ValueError(f"encode_png takes uint8 [H, W, 3], got {rgb.dtype} {rgb.shape}")
    h, w, _ = rgb.shape
    x = rgb.reshape(h, w * 3)
    if not filter_rows:
        rows = np.concatenate([np.zeros((h, 1), np.uint8), x], axis=1)
        return _png_rgb(w, h, rows)
    a, b, c = np.zeros_like(x), np.zeros_like(x), np.zeros_like(x)
    a[:, 3:], b[1:], c[1:, 3:] = x[:, :-3], x[:-1], x[:-1, :-3]
    a16, b16, c16 = a.astype(np.int16), b.astype(np.int16), c.astype(np.int16)
    res = np.empty((5, h, w * 3), np.uint8)  # each filter's bytes, uint8 wrapping mod 256
    res[0] = x
    np.subtract(x, a, out=res[1])
    np.subtract(x, b, out=res[2])
    np.subtract(x, ((a16 + b16) >> 1).astype(np.uint8), out=res[3])
    np.subtract(x, _paeth(a16, b16, c16).astype(np.uint8), out=res[4])
    kind = np.minimum(res, -res).sum(-1, dtype=np.int64).argmin(0)
    rows = np.concatenate([kind[:, None].astype(np.uint8), res[kind, np.arange(h)]], axis=1)
    return _png_rgb(w, h, rows)


def _png_rgb(w: int, h: int, rows: np.ndarray) -> bytes:
    """The PNG of an 8-bit RGB image's filtered rows (uint8 [h, 1 + 3w])."""
    return (PNG_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def load_image_rgb(path: str) -> np.ndarray:
    """uint8 RGB [H, W, 3] of the image file at `path`, as PIL's
    `Image.open(path).convert("RGB")`. PNG only (8-bit, not interlaced):
    JPEG, 16-bit and interlaced images raise ValueError, naming the file."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        return decode_png(data)
    except ValueError as e:
        raise ValueError(f"{path}: {e} (the port reads 8-bit non-interlaced PNG only; "
                         "other image formats are queued as ROADMAP.md A 6)") from None


# -- Pillow's resampling resize (libImaging/Resample.c, 8 bits a channel) -------

PRECISION_BITS = 32 - 8 - 2


def _bicubic(x: float) -> float:
    a = -0.5
    x = abs(x)
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


def _triangle(x: float) -> float:
    x = abs(x)
    return 1.0 - x if x < 1.0 else 0.0


# Pillow's filters: (function, support)
FILTERS = {"bicubic": (_bicubic, 2.0), "bilinear": (_triangle, 1.0)}


def _coeffs(in_size: int, out_size: int, method: str = "bicubic") -> np.ndarray:
    """[out, in] int64 fixed-point weights, Pillow's `precompute_coeffs`
    then `normalize_coeffs_8bpc`: the filter's support widened by the scale
    when downsampling, each output's taps normalised to sum 1 in double,
    then rounded half away from zero to PRECISION_BITS fraction bits."""
    fn, support = FILTERS[method]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = support * filterscale
    k = np.zeros((out_size, in_size), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        ss = 1.0 / filterscale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = [fn((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = sum(w)
        for x, v in enumerate(w):
            if ww != 0.0:
                v /= ww
            scaled = v * (1 << PRECISION_BITS)
            k[xx, xmin + x] = int(scaled - 0.5) if v < 0 else int(scaled + 0.5)
    return k


def _pass(img: np.ndarray, k: np.ndarray, axis: int) -> np.ndarray:
    """One pass along `axis` (0 rows, 1 columns) of int64 [H, W, C]: the
    fixed-point sum with its rounding half, shifted and clipped to uint8."""
    if axis == 1:
        ss = np.einsum("hwc,ow->hoc", img, k)
    else:
        ss = np.einsum("hwc,oh->owc", img, k)
    return np.clip((ss + (1 << (PRECISION_BITS - 1))) >> PRECISION_BITS, 0, 255)


def resize_pil(img: np.ndarray, size: Tuple[int, int], method: str = "bicubic") -> np.ndarray:
    """uint8 [H, W, C] -> uint8 [h, w, C], bit for bit PIL's
    `Image.fromarray(img).resize((w, h), Image.BICUBIC)` (method "bicubic")
    or `Image.BILINEAR` ("bilinear", PIL's triangle filter): the horizontal
    pass, then the vertical, each rounded and clipped to uint8; a dimension
    whose size does not change is not resampled."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3:
        raise ValueError(f"resize_pil takes uint8 [H, W, C], got {img.dtype} {img.shape}")
    if method not in FILTERS:
        raise ValueError(f"resize_pil: method {method!r}, one of {sorted(FILTERS)}")
    h, w = size
    if h < 1 or w < 1:
        raise ValueError(f"resize_pil to {size}")
    out = img.astype(np.int64)
    if w != img.shape[1]:
        out = _pass(out, _coeffs(img.shape[1], w, method), 1)
    if h != img.shape[0]:
        out = _pass(out, _coeffs(img.shape[0], h, method), 0)
    return out.astype(np.uint8)


def resize_pil_bicubic(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """`resize_pil(img, size, "bicubic")`: PIL's `Image.BICUBIC`."""
    return resize_pil(img, size, "bicubic")
