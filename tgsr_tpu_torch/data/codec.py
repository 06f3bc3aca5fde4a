"""Images in and out, and PIL's resizes, without PIL: what the serving CLI
needs to take an image from a request and give one back, and what the
datasets need to read their images.

- `decode_image(data)`: a PNG or a JPEG, told apart by its signature, to
  uint8 RGB [H, W, 3] exactly as PIL's `Image.open(...).convert("RGB")`
  gives it. Other formats PIL reads (GIF, BMP, TIFF, WebP) raise
  ValueError; they are queued as ROADMAP.md A 6.
- `decode_png(data)`: every PNG form: colour types 0 (grey), 2 (RGB),
  3 (palette), 4 (grey + alpha) and 6 (RGBA) at every bit depth each
  allows (1, 2, 4, 8, 16), Adam7 interlaced or not, all five row filters,
  as PIL converts them: grey replicated (1-bit to 0 / 255, 2- and 4-bit
  scaled to 8 bits, 16-bit grey clamped at 255 as PIL's `I;16` -> RGB
  clamps it), palette looked up (indices past the palette read black),
  16-bit colour by its high byte, alpha and tRNS dropped. The row filters
  are undone by a C helper (csrc/png_unfilter.c, built by the system's C
  compiler) or in Python where there is none. Images of more than
  MAX_IMAGE_PIXELS are refused; image data is inflated no further than the
  header's size.
- `decode_jpeg(data)`: baseline and progressive JPEG by the port's own
  decoder (csrc/jpeg_decode.c, built by the system's C compiler, no
  libjpeg): bit for bit what PIL reads through libjpeg (ISLOW IDCT, fancy
  upsampling, libjpeg's colour tables; Adobe CMYK / YCCK as PIL converts
  them). Without a C compiler it raises RuntimeError: there is no Python
  JPEG path. Arithmetic coding and 12-bit samples raise ValueError.
- `encode_png(rgb, filter_rows=False)`: uint8 [H, W, 3] to an 8-bit RGB
  PNG, rows raw or filtered adaptively as PNG encoders filter them.
- `resize_pil(img, (h, w), "bicubic" | "bilinear")`: uint8 [H, W, C] resized
  bit for bit as `Image.resize((w, h), Image.BICUBIC / BILINEAR)`
  (Pillow's libImaging/Resample.c); `resize_pil_bicubic` is its bicubic form.
- `load_image_rgb(path)`: an image file through `decode_image`; a file it
  cannot read raises ValueError naming the file (PIL raises OSError there).
"""

from __future__ import annotations

import ctypes
import struct
import zlib
from typing import Tuple

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
JPEG_SIGNATURE = b"\xff\xd8\xff"
# the most pixels a decoded image may have (PIL's MAX_IMAGE_PIXELS), checked
# against the header before anything is inflated
MAX_IMAGE_PIXELS = 89478485
# colour type -> samples per pixel
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# colour type -> the bit depths it allows
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# Adam7: (x0, y0, dx, dy) of each of the seven passes
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))
# formats PIL reads that the port does not, by signature
_OTHER_FORMATS = ((b"GIF8", "GIF"), (b"BM", "BMP"), (b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF"))


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


def _samples(px: np.ndarray, w: int, n: int, depth: int) -> np.ndarray:
    """Unfiltered rows [h, stride] -> samples [h, w, n] (uint16 at 16 bits,
    uint8 else; sub-byte samples unpacked, most significant bits first)."""
    h = px.shape[0]
    if depth == 16:
        return px.view(">u2")[:, :w * n].astype(np.uint16).reshape(h, w, n)
    if depth == 8:
        return px[:, :w * n].reshape(h, w, n)
    bits = np.unpackbits(px, axis=1)[:, :w * n * depth].reshape(h, w * n, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(-1, dtype=np.uint8).reshape(h, w, n)


def decode_png(data: bytes) -> np.ndarray:
    """uint8 RGB [H, W, 3] of a PNG of any colour type, bit depth and
    interlace method, as PIL's `Image.open(...).convert("RGB")` gives it.
    Raises ValueError for what is not a valid PNG, saying what it is."""
    if data[:3] == JPEG_SIGNATURE:
        raise ValueError("JPEG data, not a PNG (decode_image reads both)")
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG image")
    header, palette, idat = None, None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            if len(body) != 13:
                raise ValueError(f"PNG IHDR chunk of {len(body)} bytes, not 13")
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body[:len(body) // 3 * 3], np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without an IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if ctype not in _CHANNELS:
        raise ValueError(f"PNG colour type {ctype} is not valid")
    if depth not in _DEPTHS[ctype]:
        raise ValueError(f"PNG bit depth {depth} is not valid for colour type {ctype}")
    if interlace > 1:
        raise ValueError(f"PNG interlace method {interlace} is not valid")
    if w == 0 or h == 0:
        raise ValueError("PNG of size zero")
    if w * h > MAX_IMAGE_PIXELS:
        raise ValueError(f"PNG of {w} x {h} pixels, more than {MAX_IMAGE_PIXELS}")
    n = _CHANNELS[ctype]
    bpp = max(1, n * depth // 8)  # the filters' byte distance
    passes = [(0, 0, 1, 1)] if not interlace else _ADAM7
    dims = [(-(-(h - y0) // dy), -(-(w - x0) // dx)) for x0, y0, dx, dy in passes]
    strides = [-(-pw * n * depth // 8) for _, pw in dims]
    size = sum(ph * (st + 1) for (ph, pw), st in zip(dims, strides) if ph and pw)
    try:  # inflated no further than the header's size
        raw = zlib.decompressobj().decompress(b"".join(idat), size)
    except zlib.error as e:
        raise ValueError(f"PNG image data does not inflate: {e}") from None
    if len(raw) < size:
        raise ValueError("PNG image data is shorter than its size")
    dtype = np.uint16 if depth == 16 else np.uint8
    out = np.empty((h, w, n), dtype) if interlace else None
    pos = 0
    for (x0, y0, dx, dy), (ph, pw), st in zip(passes, dims, strides):
        if not ph or not pw:  # an empty pass has no bytes, not even filter bytes
            continue
        px = _unfilter(memoryview(raw)[pos:pos + ph * (st + 1)], ph, st, bpp)
        pos += ph * (st + 1)
        if not interlace:
            out = _samples(px, w, n, depth)
        else:
            out[y0::dy, x0::dx] = _samples(px, pw, n, depth)
    return _to_rgb(out, ctype, depth, palette)


def _to_rgb(px: np.ndarray, ctype: int, depth: int, palette) -> np.ndarray:
    """Samples [h, w, n] -> uint8 RGB as PIL's convert("RGB") of the mode
    PIL opens the PNG in."""
    if ctype == 3:
        if palette is None:
            raise ValueError("palette PNG without a PLTE chunk")
        # indices past the palette read black, as PIL's 256-entry palette
        full = np.zeros((256, 3), np.uint8)
        full[:len(palette)] = palette[:256]
        return full[px[..., 0]]
    if depth == 16:  # colour: the high byte; grey (PIL's I;16): clamped at 255
        px = np.minimum(px, 255).astype(np.uint8) if ctype == 0 else (px >> 8).astype(np.uint8)
    elif depth < 8:  # grey at 1, 2 or 4 bits, scaled to 8 (1-bit: 0 / 255)
        px = (px * (255 // ((1 << depth) - 1))).astype(np.uint8)
    if ctype in (0, 4):  # grey (+ alpha)
        return np.repeat(px[..., :1], 3, axis=-1)
    return np.ascontiguousarray(px[..., :3])


def jpeg_library():
    """The JPEG decoder (csrc/jpeg_decode.c), compiled on first use; None
    without a C compiler."""
    from tgsr_tpu_torch.ops._build import host_library

    return host_library("jpeg_decode")


def decode_jpeg(data: bytes) -> np.ndarray:
    """uint8 RGB [H, W, 3] of a JPEG, as PIL's `Image.open(...)
    .convert("RGB")` gives it. ValueError for what is not a JPEG the
    decoder reads (corrupt, truncated, arithmetic-coded, 12-bit);
    RuntimeError where there is no C compiler to build the decoder."""
    data = bytes(data)
    h, w = jpeg_size(data)
    if w * h > MAX_IMAGE_PIXELS:
        raise ValueError(f"JPEG of {w} x {h} pixels, more than {MAX_IMAGE_PIXELS}")
    out = np.empty((h, w, 3), np.uint8)
    err = ctypes.create_string_buffer(256)
    if jpeg_library().jpeg_decode_rgb(data, len(data), out.ctypes.data, out.size, err, len(err)):
        raise ValueError(err.value.decode())
    return out


def jpeg_size(data: bytes) -> Tuple[int, int]:
    """(height, width) from a JPEG's frame header; ValueError where there is
    none, RuntimeError without a C compiler."""
    lib = jpeg_library()
    if lib is None:
        raise RuntimeError("decoding a JPEG needs a C compiler (cc or gcc) to build "
                           "tgsr_tpu_torch/csrc/jpeg_decode.c; none was found")
    w, h, n = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = ctypes.create_string_buffer(256)
    if lib.jpeg_info(bytes(data), len(data), ctypes.byref(w), ctypes.byref(h), ctypes.byref(n),
                     err, len(err)):
        raise ValueError(err.value.decode())
    return h.value, w.value


def decode_image(data: bytes) -> np.ndarray:
    """uint8 RGB [H, W, 3] of a PNG or a JPEG, told apart by signature."""
    head = bytes(data[:12])
    if head[:8] == PNG_SIGNATURE:
        return decode_png(data)
    if head[:3] == JPEG_SIGNATURE:
        return decode_jpeg(data)
    for sig, name in _OTHER_FORMATS:
        if head.startswith(sig):
            raise ValueError(f"{name} images are not supported (PNG and JPEG only; the other "
                             "formats PIL reads are queued as ROADMAP.md A 6)")
    if head[:4] == b"RIFF" and head[8:12] == b"WEBP":
        raise ValueError("WebP images are not supported (PNG and JPEG only; the other "
                         "formats PIL reads are queued as ROADMAP.md A 6)")
    raise ValueError("not a PNG or JPEG image")


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
    """uint8 RGB [H, W, 3] of the PNG or JPEG file at `path`, as PIL's
    `Image.open(path).convert("RGB")`; a file `decode_image` cannot read
    raises ValueError naming the file."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        return decode_image(data)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None


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
        ww = 0.0
        for v in w:  # summed in order, as Pillow sums (not Python's compensated sum)
            ww += v
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
