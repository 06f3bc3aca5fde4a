"""The port's JPEG decoder (tgsr_tpu_torch/csrc/jpeg_decode.c through
data/codec.py) against PIL's `Image.open(f).convert("RGB")`, which reads
through libjpeg-turbo: bit for bit, every case.

- PIL's encoder: mode (L, RGB, CMYK) x chroma subsampling (4:4:4, 4:2:2,
  4:2:0) x coding (baseline, progressive, baseline with optimized Huffman
  tables), each over quality 5 / 50 / 95 / 100, restart intervals off and
  every 2 blocks, and sizes from 1 x 1 to 300 x 200 (not multiples of the
  MCU), noise at quality 100 (where libjpeg's range-limit table shows) and
  smooth images elsewhere;
- tests/torch_jpeg_writer.py for what PIL cannot write: 4:4:0, 4:1:1,
  mixed and luma-below-chroma factors, Adobe YCCK and CMYK without JFIF,
  RGB named by Adobe transform 0 or by component ids;
- truncated and corrupt files raise ValueError naming the file (PIL raises
  OSError on the truncated ones); arithmetic coding and 12-bit samples
  raise ValueError naming the feature; GIF, BMP, TIFF and WebP raise; with
  no C compiler a JPEG raises RuntimeError."""

import io

import numpy as np
import pytest
from PIL import Image, ImageFile

from tgsr_tpu_torch.data import codec
from tests.test_torch_image_fixtures import photo
from tests.torch_jpeg_writer import write_jpeg

SIZES = ((1, 1), (7, 13), (16, 16), (37, 29), (200, 300))
QUALITIES = (5, 50, 95, 100)
CODINGS = {"baseline": {}, "progressive": {"progressive": True}, "optimize": {"optimize": True}}


def _pil_rgb(path):
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def _check(path):
    np.testing.assert_array_equal(codec.load_image_rgb(str(path)), _pil_rgb(path),
                                  err_msg=str(path))


@pytest.mark.parametrize("coding", sorted(CODINGS))
@pytest.mark.parametrize("subsampling", [0, 1, 2])
@pytest.mark.parametrize("mode", ["L", "RGB", "CMYK"])
def test_pil_written_jpeg_bit_equal(tmp_path, monkeypatch, mode, subsampling, coding):
    # PIL's encoder buffer for optimized and progressive files is sized for
    # photographs; noise at quality 100 needs more
    monkeypatch.setattr(ImageFile, "MAXBLOCK", 1 << 22)
    rng = np.random.default_rng(hash((mode, subsampling, coding)) % 2 ** 32)
    c = {"L": 1, "RGB": 3, "CMYK": 4}[mode]
    for h, w in SIZES:
        for q in QUALITIES:
            for rst in (0, 2):
                img = (rng.integers(0, 256, (h, w, c), dtype=np.uint8) if q == 100
                       else photo(rng, h, w, c))
                path = tmp_path / f"{h}x{w}_q{q}_r{rst}.jpg"
                kw = dict(quality=q, subsampling=subsampling, restart_marker_blocks=rst,
                          **CODINGS[coding])
                Image.fromarray(img[..., 0] if mode == "L" else img, mode).save(path, "JPEG", **kw)
                _check(path)


FORMS = {
    "440": ([(1, 2), (1, 1), (1, 1)], {}),
    "411": ([(4, 1), (1, 1), (1, 1)], {}),
    "mixed": ([(2, 2), (1, 2), (2, 1)], {}),
    "chroma_above_luma": ([(1, 1), (2, 2), (1, 1)], {}),
    "int3x1": ([(3, 1), (1, 1), (1, 1)], {}),
    "rgb_adobe": ([(1, 1)] * 3, dict(jfif=False, adobe_transform=0)),
    "ycc_adobe": ([(2, 1), (1, 1), (1, 1)], dict(jfif=False, adobe_transform=1)),
    "rgb_ids": ([(1, 1)] * 3, dict(jfif=False, component_ids=[82, 71, 66])),
    "other_ids": ([(2, 2), (1, 1), (1, 1)], dict(jfif=False, component_ids=[5, 6, 7])),
    "ycck": ([(2, 2), (1, 1), (1, 1), (2, 2)], dict(jfif=False, adobe_transform=2)),
    "cmyk_adobe": ([(1, 1)] * 4, dict(jfif=False, adobe_transform=0)),
    "cmyk_bare": ([(2, 1), (1, 1), (1, 1), (2, 1)], dict(jfif=False)),
    "grey_2x2": ([(2, 2)], {}),
}


@pytest.mark.parametrize("form", sorted(FORMS))
def test_written_forms_bit_equal(tmp_path, form):
    sampling, kw = FORMS[form]
    rng = np.random.default_rng(len(form))
    for h, w in ((1, 1), (2, 3), (9, 17), (31, 45), (100, 75)):
        for q in (10, 75, 100):
            for rst in (0, 2):
                planes = [p[..., 0] for p in np.split(photo(rng, h, w, len(sampling)),
                                                      len(sampling), -1)]
                path = tmp_path / f"{h}x{w}_q{q}_r{rst}.jpg"
                path.write_bytes(write_jpeg(planes, sampling, q, restart=rst, **kw))
                _check(path)


@pytest.fixture(scope="module")
def good_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("jpeg")
    rng = np.random.default_rng(5)
    out = {}
    for name, kw in (("base", {}), ("prog", {"progressive": True}),
                     ("rst", {"restart_marker_blocks": 1})):
        p = d / f"{name}.jpg"
        Image.fromarray(photo(rng, 40, 56)).save(p, "JPEG", quality=80, **kw)
        out[name] = p.read_bytes()
    return out


@pytest.mark.parametrize("name", ["base", "prog", "rst"])
def test_truncated_raises_naming_the_file(tmp_path, good_files, name):
    data = good_files[name]
    for cut in (2, 20, len(data) // 3, len(data) // 2, len(data) - 40, len(data) - 2):
        path = tmp_path / f"cut{cut}.jpg"
        path.write_bytes(data[:cut])
        with pytest.raises(ValueError, match=str(path)):
            codec.load_image_rgb(str(path))
        with pytest.raises(OSError):
            _pil_rgb(path)


def test_corrupt_raises_naming_the_file(tmp_path, good_files):
    data = bytearray(good_files["rst"])
    sof = data.index(b"\xff\xc0")
    sos = data.index(b"\xff\xda")
    cases = {
        "bad_sof_length": data[:sof + 3] + b"\x05" + data[sof + 4:],
        "three_components_of_two": data[:sof + 9] + b"\x02" + data[sof + 10:],
        "bad_huffman_counts": data.replace(b"\xff\xc4\x00\x1f\x00", b"\xff\xc4\x00\x1f\x00\xff",
                                           1)[:len(data)],
        "unknown_component_in_scan": data[:sos + 5] + b"\x09" + data[sos + 6:],
        "restart_marker_missing": data.replace(b"\xff\xd1", b"\xff\xd3", 1),
        "garbage_after_soi": b"\xff\xd8" + bytes(range(1, 200)) * 4,
    }
    for name, bad in cases.items():
        path = tmp_path / f"{name}.jpg"
        path.write_bytes(bytes(bad))
        with pytest.raises(ValueError, match=str(path)):
            codec.load_image_rgb(str(path))


def test_unsupported_features_named(tmp_path, good_files):
    data = good_files["base"]
    sof = data.index(b"\xff\xc0")
    arith = data[:sof + 1] + b"\xc9" + data[sof + 2:]
    with pytest.raises(ValueError, match="arithmetic"):
        codec.decode_jpeg(arith)
    twelve = data[:sof + 4] + b"\x0c" + data[sof + 5:]
    with pytest.raises(ValueError, match="12-bit"):
        codec.decode_jpeg(twelve)
    path = tmp_path / "arith.jpg"
    path.write_bytes(arith)
    with pytest.raises(ValueError, match="arith.jpg: arithmetic"):
        codec.load_image_rgb(str(path))


@pytest.mark.parametrize("fmt", ["GIF", "BMP", "TIFF", "WEBP"])
def test_other_formats_raise(fmt):
    buf = io.BytesIO()
    Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(buf, fmt)
    with pytest.raises(ValueError, match={"WEBP": "WebP"}.get(fmt, fmt)):
        codec.decode_image(buf.getvalue())


def test_no_compiler_raises_runtime_error(monkeypatch, good_files):
    monkeypatch.setattr(codec, "jpeg_library", lambda: None)
    with pytest.raises(RuntimeError, match="C compiler"):
        codec.decode_image(good_files["base"])
