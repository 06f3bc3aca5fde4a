"""A baseline JPEG writer for tests: the forms PIL's encoder cannot write
(sampling factors such as 4:4:0 and 4:1:1 or mixed per component, Adobe
YCCK, CMYK or RGB without a JFIF marker, RGB named only by component ids),
so that the port's decoder can be held against PIL's reading of them.

`write_jpeg(planes, sampling, quality)` takes the full-size uint8 planes
as the JPEG stores them (Y, Cb, Cr or C, M, Y, K ...), box-downsamples each
to its sampling factors, and writes sequential Huffman data with
fixed-length codes (DC 4 bits, AC 8 bits: a valid table that no real
encoder would choose, which is fine for a decoder test)."""

from __future__ import annotations

import struct
from typing import Optional, Sequence, Tuple

import numpy as np

ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34, 27,
    20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58,
    59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55, 14, 13, 16, 24, 40, 57, 69,
    56, 14, 17, 22, 29, 51, 87, 80, 62, 18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104,
    113, 92, 49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_U = np.arange(8)
_C = np.sqrt(2 / 8) * np.cos((2 * _U[None, :] + 1) * _U[:, None] * np.pi / 16)
_C[0] /= np.sqrt(2)
DC_SYMS = list(range(12))
AC_SYMS = [0x00, 0xF0] + [(r << 4) | s for r in range(16) for s in range(1, 11)]


def _qtable(quality: int) -> np.ndarray:
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((LUMA_Q * scale + 50) // 100, 1, 255)


class _Bits:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def put(self, value: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            self.acc = (self.acc << 1) | ((value >> i) & 1)
            self.n += 1
            if self.n == 8:
                self.out.append(self.acc)
                if self.acc == 0xFF:
                    self.out.append(0)
                self.acc = self.n = 0

    def flush(self) -> None:
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)


def _category(v: int) -> Tuple[int, int]:
    s = int(abs(v)).bit_length()
    return s, (v if v >= 0 else v + (1 << s) - 1)


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


def _dht(cls: int, ident: int, length: int, syms: Sequence[int]) -> bytes:
    counts = [0] * 16
    counts[length - 1] = len(syms)
    return bytes([(cls << 4) | ident] + counts + list(syms))


def write_jpeg(planes: Sequence[np.ndarray], sampling: Sequence[Tuple[int, int]],
               quality: int = 90, jfif: bool = True, adobe_transform: Optional[int] = None,
               component_ids: Optional[Sequence[int]] = None, restart: int = 0) -> bytes:
    """JPEG bytes of the uint8 [H, W] `planes`, component i sampled at
    `sampling[i]` = (h, v)."""
    H, W = planes[0].shape
    n = len(planes)
    ids = list(component_ids or range(1, n + 1))
    hmax, vmax = max(h for h, _ in sampling), max(v for _, v in sampling)
    mcux, mcuy = -(-W // (8 * hmax)), -(-H // (8 * vmax))
    q = _qtable(quality)
    coefs = []
    for p, (h, v) in zip(planes, sampling):
        fx, fy = hmax // h, vmax // v
        dh, dw = -(-H * v // vmax), -(-W * h // hmax)
        full = np.pad(p.astype(np.float64), ((0, dh * fy - H), (0, dw * fx - W)), mode="edge")
        small = full.reshape(dh, fy, dw, fx).mean((1, 3))
        bh, bw = mcuy * v, mcux * h
        small = np.pad(small, ((0, bh * 8 - dh), (0, bw * 8 - dw)), mode="edge") - 128
        blocks = small.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3)
        dct = np.einsum("ux,abxy,vy->abuv", _C, blocks, _C).reshape(bh, bw, 64)
        coefs.append(np.round(dct / q).astype(np.int64)[..., ZIGZAG])
    bits = _Bits()
    pred = [0] * n
    data = bytearray()
    frame_sampling = list(sampling)
    if n == 1:  # one component: a non-interleaved scan, one block an MCU
        h, v = sampling[0]
        dw, dh = -(-W * h // hmax), -(-H * v // vmax)
        mcux, mcuy = -(-dw // 8), -(-dh // 8)
        sampling = [(1, 1)]
    for m in range(mcux * mcuy):
        if restart and m and m % restart == 0:
            bits.flush()
            data += bits.out + bytes([0xFF, 0xD0 + (m // restart - 1) % 8])
            bits = _Bits()
            pred = [0] * n
        my, mx = divmod(m, mcux)
        for ci, (h, v) in enumerate(sampling):
            for by in range(v):
                for bx in range(h):
                    blk = coefs[ci][my * v + by, mx * h + bx]
                    s, val = _category(int(blk[0]) - pred[ci])
                    pred[ci] = int(blk[0])
                    bits.put(DC_SYMS.index(s), 4)
                    bits.put(val, s)
                    run = 0
                    last = max([k for k in range(1, 64) if blk[k]] or [0])
                    for k in range(1, last + 1):
                        if blk[k] == 0:
                            run += 1
                            continue
                        while run > 15:
                            bits.put(AC_SYMS.index(0xF0), 8)
                            run -= 16
                        s, val = _category(int(blk[k]))
                        bits.put(AC_SYMS.index((run << 4) | s), 8)
                        bits.put(val, s)
                        run = 0
                    if last < 63:
                        bits.put(AC_SYMS.index(0x00), 8)
    bits.flush()
    data += bits.out
    out = bytearray(b"\xff\xd8")
    if jfif:
        out += _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    if adobe_transform is not None:
        out += _segment(0xEE, b"Adobe" + struct.pack(">HHHB", 100, 0, 0, adobe_transform))
    out += _segment(0xDB, bytes([0]) + bytes(q[ZIGZAG].astype(np.uint8)))
    sof = struct.pack(">BHHB", 8, H, W, n)
    for ci, (h, v) in enumerate(frame_sampling):
        sof += bytes([ids[ci], (h << 4) | v, 0])
    out += _segment(0xC0, sof)
    out += _segment(0xC4, _dht(0, 0, 4, DC_SYMS) + _dht(1, 0, 8, AC_SYMS))
    if restart:
        out += _segment(0xDD, struct.pack(">H", restart))
    sos = bytes([n]) + b"".join(bytes([ids[ci], 0x00]) for ci in range(n)) + bytes([0, 63, 0])
    out += _segment(0xDA, sos) + data + b"\xff\xd9"
    return bytes(out)
