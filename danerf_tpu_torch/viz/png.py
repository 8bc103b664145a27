"""Minimal PNG writer on zlib/struct (8-bit grayscale, gray + alpha, RGB or
RGBA, no filtering), so the port writes frames without an imaging library."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


_COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}   # channels -> colour type


def write_png(path: str, img: np.ndarray) -> None:
    """Write a uint8 (H, W), (H, W, 2) (gray + alpha), (H, W, 3) or (H, W,
    4) (RGBA) array as a PNG file."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (
            img.ndim == 3 and img.shape[2] not in _COLOR_TYPE):
        raise ValueError(f"expected uint8 (H, W) or (H, W, 2|3|4), got {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    color_type = _COLOR_TYPE[1 if img.ndim == 2 else img.shape[2]]
    rows = img.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(raw, 6)) + _chunk(b"IEND", b""))
