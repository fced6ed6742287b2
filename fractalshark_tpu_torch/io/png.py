"""Minimal dependency-free PNG writer (8- and 16-bit RGB/RGBA).

Replaces the reference's vendored WPngImage/lodepng stack
(``FractalSharkLib/PngParallelSave.h``). 16-bit output preserves the
RGBA16 palette depth the renderer produces.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + tag + payload +
            struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))


def write_png(path: str, image: np.ndarray, compress_level: int = 6) -> None:
    """image: [H, W, C] uint8 or uint16 with C in {3, 4}."""
    img = np.asarray(image)
    if img.ndim != 3 or img.shape[2] not in (3, 4):
        raise ValueError(f"expected [H,W,3|4], got {img.shape}")
    if img.dtype == np.uint8:
        bit_depth = 8
    elif img.dtype == np.uint16:
        bit_depth = 16
    else:
        raise ValueError(f"expected uint8/uint16, got {img.dtype}")
    h, w, c = img.shape
    color_type = 2 if c == 3 else 6

    if bit_depth == 16:
        raw = img.astype(">u2").tobytes()
    else:
        raw = img.tobytes()
    stride = w * c * (bit_depth // 8)
    # filter byte 0 (None) per scanline
    rows = np.frombuffer(raw, dtype=np.uint8).reshape(h, stride)
    filtered = np.zeros((h, stride + 1), dtype=np.uint8)
    filtered[:, 1:] = rows
    idat = zlib.compress(filtered.tobytes(), compress_level)

    ihdr = struct.pack(">IIBBBBB", w, h, bit_depth, color_type, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_chunk(b"IHDR", ihdr))
        f.write(_chunk(b"IDAT", idat))
        f.write(_chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """Minimal PNG reader for round-trip tests (filter-0, 8/16-bit RGB(A))."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos = 8
    idat = b""
    w = h = depth = ctype = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", payload[:10])
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
    channels = {2: 3, 6: 4}[ctype]
    raw = zlib.decompress(idat)
    stride = w * channels * (depth // 8)
    rows = np.frombuffer(raw, dtype=np.uint8).reshape(h, stride + 1)
    if (rows[:, 0] != 0).any():
        raise NotImplementedError("only filter-0 PNGs supported")
    body = rows[:, 1:].tobytes()
    if depth == 16:
        img = np.frombuffer(body, dtype=">u2").astype(np.uint16)
    else:
        img = np.frombuffer(body, dtype=np.uint8)
    return img.reshape(h, w, channels)
