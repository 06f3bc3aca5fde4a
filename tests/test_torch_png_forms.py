"""data/codec.py's PNG decoder against PIL's `Image.open(f).convert("RGB")`
on every PNG form: each colour type at each bit depth it allows, Adam7
interlaced or not, with and without tRNS, palettes shorter than the index
range, sizes from 1 x 1 up; written by the test-only raw-chunk writer
tests/torch_png_writer.py (all five row filters, two IDAT chunks). All
gates are equality. 16-bit colour reads its high byte and 16-bit grey is
clamped at 255, as PIL converts them."""

import io
import struct

import numpy as np
import pytest
from PIL import Image

from tgsr_tpu_torch.data import codec
from tests.torch_png_writer import CHANNELS, DEPTHS, chunk, write_png

FORMS = [(c, d) for c in sorted(DEPTHS) for d in DEPTHS[c]]


@pytest.mark.parametrize("interlace", [False, True])
@pytest.mark.parametrize("ctype,depth", FORMS)
def test_png_form_bit_equal(ctype, depth, interlace):
    rng = np.random.default_rng(100 * ctype + depth + interlace)
    n = CHANNELS[ctype]
    for h, w in ((1, 1), (1, 9), (7, 3), (17, 23)):
        for with_trns in (False, True):
            px = rng.integers(0, 1 << depth, (h, w, n))
            palette = trns = None
            if ctype == 3:
                k = int(rng.integers(1, (1 << depth) + 1))
                palette = rng.integers(0, 256, (k, 3))
                if with_trns:
                    trns = bytes(rng.integers(0, 256, int(rng.integers(1, k + 1)),
                                              dtype=np.uint8))
            elif with_trns and ctype in (0, 2):
                trns = b"".join(int(v).to_bytes(2, "big") for v in px[0, 0])
            data = write_png(px, ctype, depth, interlace, palette, trns)
            with Image.open(io.BytesIO(data)) as im:
                want = np.asarray(im.convert("RGB"))
            got = codec.decode_png(data)
            assert got.dtype == np.uint8
            np.testing.assert_array_equal(got, want, err_msg=f"{h}x{w} trns={with_trns}")


def test_refuses_invalid_forms():
    px = np.zeros((2, 2, 3), int)
    good = write_png(px, 2, 8)
    ihdr = good.index(b"IHDR")
    for body, msg in ((struct.pack(">IIBBBBB", 2, 2, 4, 2, 0, 0, 0), "bit depth 4"),
                      (struct.pack(">IIBBBBB", 2, 2, 16, 3, 0, 0, 0), "bit depth 16"),
                      (struct.pack(">IIBBBBB", 2, 2, 8, 5, 0, 0, 0), "colour type 5"),
                      (struct.pack(">IIBBBBB", 2, 2, 8, 2, 0, 0, 2), "interlace method 2")):
        bad = good[:ihdr - 4] + chunk(b"IHDR", body) + good[ihdr + 17 + 4:]
        with pytest.raises(ValueError, match=msg):
            codec.decode_png(bad)
    short = write_png(np.zeros((4, 4, 1), int), 0, 16, interlace=True)
    idat = short.index(b"IDAT")
    truncated = short[:idat - 4] + chunk(b"IDAT", b"x\x9c\x03\x00") + chunk(b"IEND", b"")
    with pytest.raises(ValueError, match="shorter"):
        codec.decode_png(truncated)
