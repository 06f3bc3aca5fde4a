"""tgsr_tpu_torch/data/codec.py against PIL: the PNG decoder equal to
PIL's `.convert("RGB")` on every colour type and all five row filters (the
other bit depths and interlacing: tests/test_torch_png_forms.py); PIL decodes the port's encoder's PNG equal; `resize_pil_bicubic`
bit for bit `Image.resize(..., Image.BICUBIC)`; what the decoder refuses.
All gates are equality."""

import io
import struct
import tracemalloc
import zlib

import numpy as np
import pytest
from PIL import Image

from tgsr_tpu_torch.data import codec
from tgsr_tpu_torch.data.codec import (MAX_IMAGE_PIXELS, decode_png, encode_png,
                                       resize_pil_bicubic)

CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else b if pb <= pc else c


def _filter_rows(px, bpp, filters):
    """PNG row filtering written out byte by byte: px [h, stride] uint8,
    filters[y] the filter of row y."""
    out = bytearray()
    prior = [0] * px.shape[1]
    for y, row in enumerate(px.tolist()):
        kind = filters[y % len(filters)]
        out.append(kind)
        for i, v in enumerate(row):
            a = row[i - bpp] if i >= bpp else 0
            b = prior[i]
            c = prior[i - bpp] if i >= bpp else 0
            pred = (0, a, b, (a + b) // 2, _paeth(a, b, c))[kind]
            out.append((v - pred) & 0xFF)
        prior = row
    return bytes(out)


def _chunk(kind, body):
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _png(px, ctype, filters, palette=None, depth=8, interlace=0):
    h, w = px.shape[:2]
    n = CHANNELS[ctype]
    data = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                                              0, 0, interlace))
    if palette is not None:
        data += _chunk(b"PLTE", palette.tobytes())
        data += _chunk(b"tRNS", bytes(range(0, 256, 16)))  # PIL drops it for RGB
    raw = _filter_rows(px.reshape(h, w * n), n, filters)
    # two IDAT chunks, as encoders may split the stream
    z = zlib.compress(raw)
    data += _chunk(b"IDAT", z[:len(z) // 2]) + _chunk(b"IDAT", z[len(z) // 2:])
    return data + _chunk(b"IEND", b"")


def _pil_rgb(data):
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


@pytest.fixture(params=["c", "python"])
def unfilter(request, monkeypatch):
    """Each decoding test runs twice: row filters undone by the C helper and
    by the Python version that runs where no C compiler is."""
    if request.param == "python":
        monkeypatch.setattr(codec, "unfilter_library", lambda: None)
    elif codec.unfilter_library() is None:
        pytest.skip("no C compiler on this machine")
    return request.param


@pytest.mark.parametrize("ctype", sorted(CHANNELS))
@pytest.mark.parametrize("filters", [[0], [1], [2], [3], [4], [0, 1, 2, 3, 4, 4, 3]])
def test_decode_matches_pil(ctype, filters, unfilter):
    rng = np.random.default_rng(ctype * 10 + len(filters))
    h, w = 13, 17
    palette = None
    if ctype == 3:
        palette = rng.integers(0, 256, (40, 3)).astype(np.uint8)
        px = rng.integers(0, 40, (h, w, 1)).astype(np.uint8)
    else:
        px = rng.integers(0, 256, (h, w, CHANNELS[ctype])).astype(np.uint8)
        px[3:6] = px[3:6] // 7 * 7  # runs, where Sub and Paeth predict well
    data = _png(px, ctype, filters, palette)
    got = decode_png(data)
    assert got.dtype == np.uint8 and got.shape == (h, w, 3)
    np.testing.assert_array_equal(got, _pil_rgb(data))


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA", "P"])
def test_decode_pil_written_pngs(mode, unfilter):
    rng = np.random.default_rng(7)
    img = Image.fromarray(rng.integers(0, 256, (31, 45, 3)).astype(np.uint8))
    img = img.quantize(64) if mode == "P" else img.convert(mode)
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    np.testing.assert_array_equal(decode_png(buf.getvalue()), _pil_rgb(buf.getvalue()))


def test_encode_round_trips_through_pil():
    rng = np.random.default_rng(8)
    rgb = rng.integers(0, 256, (29, 38, 3)).astype(np.uint8)
    data = encode_png(rgb)
    img = Image.open(io.BytesIO(data))
    assert img.mode == "RGB" and img.size == (38, 29)
    np.testing.assert_array_equal(np.asarray(img), rgb)
    np.testing.assert_array_equal(decode_png(data), rgb)
    with pytest.raises(ValueError):
        encode_png(rgb.astype(np.float32))


def test_encode_filters_rows_adaptively():
    """With filter_rows the encoder filters each row as PNG encoders do
    (libpng's heuristic): a smooth image gets Sub, Up, Average or Paeth
    rows, not raw rows, and PIL reads it back equal."""
    yy, xx = np.mgrid[:48, :64]
    rgb = np.stack([yy * 4, xx * 3, yy + xx], axis=-1).astype(np.uint8)
    data = encode_png(rgb, filter_rows=True)
    idat = b"".join(data[i + 8:i + 8 + struct.unpack(">I", data[i:i + 4])[0]]
                    for i in range(8, len(data)) if data[i + 4:i + 8] == b"IDAT")
    kinds = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(48, -1)[:, 0]
    assert set(kinds[1:].tolist()) <= {1, 2, 3, 4} and len(set(kinds.tolist())) > 1
    np.testing.assert_array_equal(_pil_rgb(data), rgb)
    np.testing.assert_array_equal(decode_png(data), rgb)


@pytest.mark.parametrize("src, dst", [
    ((40, 40), (16, 16)), ((17, 17), (32, 32)), ((200, 300), (32, 32)), ((32, 32), (32, 32)),
    ((23, 41), (64, 12)), ((40, 56), (40, 7)),
])
def test_resize_pil_bicubic_bit_equal(src, dst):
    rng = np.random.default_rng(sum(src) + sum(dst))
    img = rng.integers(0, 256, (*src, 3)).astype(np.uint8)
    img[::5] = 0
    img[:, ::7] = 255  # edges that drive the cubic's overshoot into the clip
    want = np.asarray(Image.fromarray(img).resize((dst[1], dst[0]), Image.BICUBIC))
    got = resize_pil_bicubic(img, dst)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_refusals():
    rng = np.random.default_rng(9)
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (16, 16, 3)).astype(np.uint8)).save(buf, format="JPEG")
    with pytest.raises(ValueError, match="JPEG"):
        decode_png(buf.getvalue())
    px = rng.integers(0, 256, (4, 4, 3)).astype(np.uint8)
    # interlaced and 16-bit PNGs decode (tests/test_torch_png_forms.py); an
    # unknown interlace method and a depth the colour type does not allow
    # are refused
    with pytest.raises(ValueError, match="interlace method 2"):
        decode_png(_png(px, 2, [0], interlace=2))
    with pytest.raises(ValueError, match="bit depth 16 is not valid"):
        decode_png(_png(px[..., :1], 3, [0], palette=np.zeros((4, 3), np.uint8), depth=16))
    with pytest.raises(ValueError, match="not a PNG"):
        decode_png(b"not an image")
    good = _png(px, 2, [0])
    with pytest.raises(ValueError, match="CRC"):
        decode_png(good[:20] + bytes([good[20] ^ 1]) + good[21:])


def test_refuses_malformed_headers_and_bounds_inflation():
    """An IHDR that is not 13 bytes and a header past MAX_IMAGE_PIXELS are
    refused with ValueError; an IDAT stream that inflates far past the
    header's size (a zlib bomb) is inflated no further than that size."""
    px = np.zeros((4, 4, 3), np.uint8)
    good = _png(px, 2, [0])
    bad_ihdr = good[:8] + _chunk(b"IHDR", good[16:28]) + good[33:]
    with pytest.raises(ValueError, match="IHDR"):
        decode_png(bad_ihdr)
    huge = (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", 20000, 20000, 8, 2, 0, 0, 0))
            + _chunk(b"IEND", b""))
    assert 20000 * 20000 > MAX_IMAGE_PIXELS
    with pytest.raises(ValueError, match="pixels"):
        decode_png(huge)
    z = zlib.compressobj(9)
    stream = b"".join(z.compress(bytes(1 << 20)) for _ in range(64)) + z.flush()
    bomb = (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", 16, 16, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", stream) + _chunk(b"IEND", b""))
    tracemalloc.start()
    try:
        got = decode_png(bomb)
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    np.testing.assert_array_equal(got, np.zeros((16, 16, 3), np.uint8))
    assert peak < 4 << 20, f"decoding a 64 MiB zlib stream of a 16 x 16 PNG peaked at {peak} B"
