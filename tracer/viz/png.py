"""Minimal PNG writer (stdlib ``zlib`` + ``struct``): 8-bit RGB, no filter."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(img) -> bytes:
    """(H, W, 3) float image in [0, 1] (or uint8) -> PNG bytes."""
    a = np.asarray(img)
    if a.dtype != np.uint8:
        a = (np.clip(a, 0.0, 1.0) * 255).astype(np.uint8)
    h, w, c = a.shape
    assert c == 3, "RGB images only"
    raw = b"".join(b"\x00" + a[y].tobytes() for y in range(h))
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw, 6)) + _chunk(b"IEND", b""))


def write_png(path: str, img) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))
