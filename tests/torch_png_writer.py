"""A raw-chunk PNG writer for tests: every colour type at every bit depth
it allows, Adam7 interlaced or not, optional PLTE and tRNS chunks, each row
under one of the five filters (written out byte by byte), the IDAT stream
split in two. PIL writes few of these forms (no 2- or 4-bit grey, no
16-bit colour, no interlace), so the port's decoder is held against PIL's
reading of what this writes."""

import struct
import zlib

import numpy as np

CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))


def chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else b if pb <= pc else c


def _row_bytes(samples: np.ndarray, depth: int) -> bytes:
    """One row of samples (ints) packed at `depth` bits, big-endian."""
    if depth == 16:
        return samples.astype(">u2").tobytes()
    if depth == 8:
        return samples.astype(np.uint8).tobytes()
    bits = ((samples[:, None] >> np.arange(depth - 1, -1, -1)) & 1).astype(np.uint8)
    return np.packbits(bits.reshape(-1)).tobytes()


def _filtered(rows, bpp: int, filters, first: int) -> bytes:
    out = bytearray()
    prior = bytes(len(rows[0]))
    for y, row in enumerate(rows):
        kind = filters[(first + y) % len(filters)]
        out.append(kind)
        for i, v in enumerate(row):
            a = row[i - bpp] if i >= bpp else 0
            b = prior[i]
            c = prior[i - bpp] if i >= bpp else 0
            pred = (0, a, b, (a + b) // 2, _paeth(a, b, c))[kind]
            out.append((v - pred) & 0xFF)
        prior = row
    return bytes(out)


def write_png(samples: np.ndarray, ctype: int, depth: int, interlace: bool = False,
              palette=None, trns: bytes = None, filters=(0, 1, 2, 3, 4)) -> bytes:
    """PNG bytes of `samples` [H, W, channels] (ints below 2 ** depth)."""
    h, w, n = samples.shape
    assert n == CHANNELS[ctype] and depth in DEPTHS[ctype]
    bpp = max(1, n * depth // 8)
    raw, first = b"", 0
    for x0, y0, dx, dy in (ADAM7 if interlace else ((0, 0, 1, 1),)):
        sub = samples[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        rows = [_row_bytes(r.reshape(-1), depth) for r in sub]
        raw += _filtered(rows, bpp, filters, first)
        first += len(rows)
    z = zlib.compress(raw, 6)
    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0,
                                                             int(interlace)))
    if palette is not None:
        out += chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        out += chunk(b"tRNS", trns)
    half = len(z) // 2
    return out + chunk(b"IDAT", z[:half]) + chunk(b"IDAT", z[half:]) + chunk(b"IEND", b"")
