"""The committed image fixtures (tests/torch_fixtures/): JPEGs and PNGs of
every form data/codec.py reads, and PIL's `Image.open(f).convert("RGB")`
of each in `pil_rgb.npz` (one array per file name). chip_smoke.py decodes
them on the card's host, where there is no PIL, and holds each to its
array.

`make_fixtures()` is the function that made them: images drawn from a
seed with numpy, written by PIL where PIL writes the form (baseline,
progressive, optimized, restart intervals, 4:4:4 / 4:2:2 / 4:2:0, grey,
Adobe CMYK and RGB) and by the test writers tests/torch_jpeg_writer.py
(4:4:0, 4:1:1, mixed factors, YCCK, RGB named by component ids) and
tests/torch_png_writer.py (every PNG colour type and bit depth, Adam7,
tRNS) where it does not. The test makes them again and asserts the
committed bytes and arrays, then that the port decodes each bit for bit.
To remake them after a deliberate change: `python -m
tests.test_torch_image_fixtures`."""

import io
import os

import numpy as np
import pytest
from PIL import Image

from tgsr_tpu_torch.data import codec
from tests.torch_jpeg_writer import write_jpeg
from tests.torch_png_writer import write_png

DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_fixtures")
ARRAYS = os.path.join(DIR, "pil_rgb.npz")


def photo(rng, h, w, c=3):
    """A uint8 image that compresses like a photograph: smooth ramps, a few
    soft discs, fine noise."""
    yy, xx = np.mgrid[:h, :w] / max(h, w)
    img = np.stack([120 + 100 * np.sin(rng.uniform(2, 6) * xx + rng.uniform(1, 4) * yy
                                       + rng.uniform(0, 6)) for _ in range(c)], -1)
    for _ in range(4):
        cy, cx, r = rng.uniform(0, 1), rng.uniform(0, 1), rng.uniform(0.05, 0.3)
        img += (rng.uniform(-80, 80, c) * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / r ** 2)
                [..., None])
    return np.clip(img + rng.normal(0, 4, img.shape), 0, 255).astype(np.uint8)


def _pil_jpeg(img, mode, **kw):
    buf = io.BytesIO()
    Image.fromarray(img[..., 0] if mode == "L" else img, mode).save(buf, "JPEG", **kw)
    return buf.getvalue()


def make_fixtures():
    """{file name: bytes}."""
    rng = np.random.default_rng(21)
    out = {}
    out["photo_500x375_420.jpg"] = _pil_jpeg(photo(rng, 375, 500), "RGB", quality=90)
    out["noise_q100_444_37x29.jpg"] = _pil_jpeg(
        rng.integers(0, 256, (29, 37, 3), dtype=np.uint8), "RGB", quality=100, subsampling=0)
    out["prog_opt_422_61x45.jpg"] = _pil_jpeg(photo(rng, 45, 61), "RGB", quality=75,
                                              subsampling=1, progressive=True, optimize=True)
    out["prog_rst_420_83x51.jpg"] = _pil_jpeg(photo(rng, 51, 83), "RGB", quality=50,
                                              progressive=True, restart_marker_blocks=3)
    out["grey_rst_q95_33x17.jpg"] = _pil_jpeg(photo(rng, 17, 33, 1), "L", quality=95,
                                              restart_marker_rows=1)
    out["cmyk_40x24.jpg"] = _pil_jpeg(photo(rng, 24, 40, 4), "CMYK", quality=85)
    out["adobe_rgb_21x13.jpg"] = _pil_jpeg(photo(rng, 13, 21), "RGB", quality=80, keep_rgb=True,
                                           subsampling=0)
    out["q5_1x1.jpg"] = _pil_jpeg(photo(rng, 1, 1), "RGB", quality=5)
    planes = lambda h, w, n: [p[..., 0] for p in np.split(photo(rng, h, w, n), n, -1)]  # noqa: E731
    out["s440_31x19.jpg"] = write_jpeg(planes(19, 31, 3), [(1, 2), (1, 1), (1, 1)], 85)
    out["s411_45x23.jpg"] = write_jpeg(planes(23, 45, 3), [(4, 1), (1, 1), (1, 1)], 85,
                                       restart=2)
    out["mixed_29x35.jpg"] = write_jpeg(planes(35, 29, 3), [(2, 2), (1, 2), (2, 1)], 70)
    out["ycck_22x15.jpg"] = write_jpeg(planes(15, 22, 4), [(2, 2), (1, 1), (1, 1), (2, 2)], 90,
                                       jfif=False, adobe_transform=2)
    out["rgb_ids_18x11.jpg"] = write_jpeg(planes(11, 18, 3), [(1, 1)] * 3, 90, jfif=False,
                                          component_ids=[ord("R"), ord("G"), ord("B")])
    for ctype, depths in ((0, (1, 2, 4, 8, 16)), (2, (8, 16)), (3, (1, 2, 4, 8)), (4, (8, 16)),
                          (6, (8, 16))):
        n = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
        for depth in depths:
            interlace = bool(depth % 2 == 0 and (ctype + depth) % 3 == 0) or depth == 16
            h, w = int(rng.integers(5, 24)), int(rng.integers(5, 24))
            px = rng.integers(0, 1 << depth, (h, w, n))
            palette = trns = None
            if ctype == 3:
                k = int(rng.integers(1, (1 << depth) + 1))
                palette = rng.integers(0, 256, (k, 3))
                trns = bytes(rng.integers(0, 256, k, dtype=np.uint8))
            elif ctype in (0, 2):
                trns = b"".join(int(v).to_bytes(2, "big") for v in px[0, 0])
            name = f"png_c{ctype}_d{depth}{'_adam7' if interlace else ''}_{w}x{h}.png"
            out[name] = write_png(px, ctype, depth, interlace, palette, trns)
    return out


def pil_arrays(files):
    return {name: np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
            for name, data in files.items()}


def write_fixtures():
    os.makedirs(DIR, exist_ok=True)
    files = make_fixtures()
    for name, data in files.items():
        with open(os.path.join(DIR, name), "wb") as f:
            f.write(data)
    np.savez_compressed(ARRAYS, **pil_arrays(files))


@pytest.fixture(scope="module")
def made():
    return make_fixtures()


def test_fixtures_regenerate(made):
    """The committed files are what make_fixtures writes, and the committed
    arrays what PIL decodes of them; the set stays small."""
    on_disk = sorted(n for n in os.listdir(DIR) if n != "pil_rgb.npz")
    assert on_disk == sorted(made)
    total = os.path.getsize(ARRAYS)
    for name, data in made.items():
        with open(os.path.join(DIR, name), "rb") as f:
            assert f.read() == data, name
        total += len(data)
    assert total <= 1_500_000
    with np.load(ARRAYS) as z:
        assert sorted(z.files) == sorted(made)
        for name, want in pil_arrays(made).items():
            np.testing.assert_array_equal(z[name], want, err_msg=name)


@pytest.mark.parametrize("name", sorted(make_fixtures()))
def test_fixture_decodes_as_pil(name):
    """Each committed file through `codec.load_image_rgb`: PIL's array, bit
    for bit."""
    with np.load(ARRAYS) as z:
        want = z[name]
    np.testing.assert_array_equal(codec.load_image_rgb(os.path.join(DIR, name)), want)


if __name__ == "__main__":
    write_fixtures()
