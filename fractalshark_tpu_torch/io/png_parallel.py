"""Threaded PNG encoding (PngParallelSave analogue,
``FractalSharkLib/PngParallelSave.h:21``): row bands are filtered and
deflate-compressed in parallel (zlib releases the GIL), then emitted as
consecutive IDAT chunks — each band is a Z_FULL_FLUSH-terminated deflate
segment so the concatenated stream stays valid.
"""

from __future__ import annotations

import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from fractalshark_tpu_torch.io.png import _chunk


def write_png_parallel(path: str, image: np.ndarray,
                       compress_level: int = 6,
                       num_threads: int = 4) -> None:
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
    raw = img.astype(">u2").tobytes() if bit_depth == 16 else img.tobytes()
    stride = w * c * (bit_depth // 8)
    rows = np.frombuffer(raw, dtype=np.uint8).reshape(h, stride)
    filtered = np.zeros((h, stride + 1), dtype=np.uint8)
    filtered[:, 1:] = rows

    bands = max(1, min(num_threads * 2, h))
    edges = np.linspace(0, h, bands + 1, dtype=int)

    def compress_band(i):
        data = filtered[edges[i]:edges[i + 1]].tobytes()
        co = zlib.compressobj(compress_level)
        out = co.compress(data)
        if i == bands - 1:
            out += co.flush(zlib.Z_FINISH)
        else:
            out += co.flush(zlib.Z_FULL_FLUSH)
        return out

    with ThreadPoolExecutor(max_workers=num_threads) as ex:
        parts = list(ex.map(compress_band, range(bands)))

    # band streams each start a fresh deflate block; strip the per-band
    # zlib headers except the first, and the final adler from all but
    # the last (full-flush streams have neither — only Z_FINISH does)
    payload = parts[0][:2]  # zlib header from first band
    for i, part in enumerate(parts):
        body = part[2:]  # drop each band's 2-byte zlib header
        payload += body
    # recompute the adler32 over the full filtered data and patch it
    adler = zlib.adler32(filtered.tobytes()) & 0xFFFFFFFF
    payload = payload[:-4] + struct.pack(">I", adler)

    ihdr = struct.pack(">IIBBBBB", w, h, bit_depth, color_type, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_chunk(b"IHDR", ihdr))
        f.write(_chunk(b"IDAT", payload))
        f.write(_chunk(b"IEND", b""))
