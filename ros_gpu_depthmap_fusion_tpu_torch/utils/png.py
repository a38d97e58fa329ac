"""Minimal PNG codec for 16-bit grayscale depth images (numpy copy of
the JAX package's ``utils/png.py``: it writes the same bytes, and reads
Paeth-filtered rows right where that reader does not).

TUM RGB-D depth frames are 16-bit grayscale PNGs (depth in 1/5000 m units).
The environment carries no image library, so this implements the subset of
PNG needed: 8/16-bit grayscale, all five scanline filters, zlib streams.
Pure numpy; used by the dataset loaders and tests.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))


def write_png_gray(path: str, img: np.ndarray) -> None:
    """Write a [H, W] uint8 or uint16 grayscale PNG."""
    img = np.asarray(img)
    assert img.ndim == 2, img.shape
    if img.dtype == np.uint8:
        depth = 8
        raw = img
    elif img.dtype == np.uint16:
        depth = 16
        raw = img.astype(">u2")  # network byte order
    else:
        raise ValueError(f"unsupported dtype {img.dtype}")
    h, w = img.shape
    ihdr = struct.pack(">IIBBBBB", w, h, depth, 0, 0, 0, 0)  # gray, no filt
    scanlines = b"".join(
        b"\x00" + raw[y].tobytes() for y in range(h))
    data = zlib.compress(scanlines, 6)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", data)
                + _chunk(b"IEND", b""))


def read_png_gray(path: str) -> np.ndarray:
    """Read an 8/16-bit grayscale PNG into [H, W] uint8/uint16."""
    with open(path, "rb") as f:
        buf = f.read()
    assert buf[:8] == _SIGNATURE, "not a PNG"
    pos = 8
    width = height = bitdepth = colortype = interlace = None
    idat = bytearray()
    while pos < len(buf):
        (length,) = struct.unpack(">I", buf[pos:pos + 4])
        tag = buf[pos + 4:pos + 8]
        payload = buf[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            width, height, bitdepth, colortype, _, _, interlace = \
                struct.unpack(">IIBBBBB", payload)
            if colortype != 0:
                raise ValueError(f"only grayscale supported, got {colortype}")
            if bitdepth not in (8, 16):
                raise ValueError(f"unsupported bit depth {bitdepth}")
            if interlace:
                raise ValueError("interlaced PNG not supported")
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
    raw = zlib.decompress(bytes(idat))
    bpp = bitdepth // 8
    stride = width * bpp
    out = np.empty((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint16)
    pos = 0
    for y in range(height):
        ftype = raw[pos]
        line = np.frombuffer(raw, np.uint8, stride, pos + 1).astype(np.uint16)
        pos += 1 + stride
        if ftype == 0:                      # None
            cur = line
        elif ftype == 2:                    # Up
            cur = (line + prev) & 0xFF
        elif ftype in (1, 3, 4):            # Sub / Average / Paeth: sequential
            cur = np.zeros(stride, np.uint16)
            for i in range(stride):
                # Python ints: the Paeth predictor's p - a etc. go
                # negative, which wraps in uint16 (the JAX package's
                # reader decodes Paeth rows wrongly for that reason)
                a = int(cur[i - bpp]) if i >= bpp else 0
                b = int(prev[i])
                c = int(prev[i - bpp]) if i >= bpp else 0
                if ftype == 1:
                    pred = a
                elif ftype == 3:
                    pred = (a + b) // 2
                else:
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if (pa <= pb and pa <= pc) else \
                        (b if pb <= pc else c)
                cur[i] = (line[i] + pred) & 0xFF
        else:
            raise ValueError(f"bad filter {ftype}")
        out[y] = cur.astype(np.uint8)
        prev = cur
    if bitdepth == 8:
        return out
    return out.reshape(height, width, 2).astype(np.uint16)[..., 0] * 256 + \
        out.reshape(height, width, 2).astype(np.uint16)[..., 1]
