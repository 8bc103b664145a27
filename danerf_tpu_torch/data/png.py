"""PNG decoder on zlib/numpy, so the port reads nerf_synthetic frames
without an imaging library.

Handles 8-bit grayscale, grayscale + alpha, RGB and RGBA, non-interlaced,
with any of the five scanline filters (None, Sub, Up, Average, Paeth).
Anything else (16-bit samples, palettes, interlacing) raises ValueError.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}   # colour type -> samples per pixel


def _chunks(data: bytes):
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        yield tag, data[pos + 8:pos + 8 + n]
        pos += 12 + n


def _unfilter_rows(ftype: np.ndarray, line: np.ndarray) -> np.ndarray:
    """Undo None (0), Sub (1) and Up (2) filters a row at a time: Sub is a
    running sum along the row, Up adds the reconstructed row above."""
    out = np.empty_like(line)
    prev = np.zeros_like(line[0])
    for y, f in enumerate(ftype):
        cur = line[y]
        if f == 1:
            cur = np.cumsum(cur, axis=0)
        elif f == 2:
            cur = cur + prev
        prev = out[y] = cur & 0xFF
    return out.astype(np.uint8)


def _unfilter(raw: np.ndarray, h: int, w: int, bpp: int) -> np.ndarray:
    """Undo the per-scanline filters; raw is (h, 1 + w*bpp) uint8.

    Without the Average and Paeth filters (this port's writer uses None on
    every row) the rows are undone one after another.  Otherwise pixel
    (y, x) depends on its reconstructed left (a), upper (b) and upper-left
    (c) neighbours, so the pixels of one anti-diagonal x + y = k are
    independent: the loop runs over the h + w - 1 anti-diagonals, each step
    vectorized over its pixels (each row with its own filter)."""
    ftype = raw[:, 0].astype(np.int32)
    if np.any(ftype > 4):
        raise ValueError(f"bad PNG filter type {int(ftype.max())}")
    line = raw[:, 1:].reshape(h, w, bpp).astype(np.int32)
    if not np.any(ftype > 2):
        return _unfilter_rows(ftype, line)
    out = np.zeros((h + 1, w + 1, bpp), np.int32)      # a zero row and column before
    for k in range(h + w - 1):
        y = np.arange(max(0, k - w + 1), min(h, k + 1))
        x = k - y
        a, b, c = out[y + 1, x], out[y, x + 1], out[y, x]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        f = ftype[y][:, None]
        pred = np.select([f == 1, f == 2, f == 3, f == 4], [a, b, (a + b) >> 1, paeth], 0)
        out[y + 1, x + 1] = (line[y, x] + pred) & 0xFF
    return out[1:, 1:].astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """Decode a PNG file to uint8 (H, W) for grayscale, else (H, W, C) with
    C = 2 (gray + alpha), 3 (RGB) or 4 (RGBA)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path} is not a PNG file")
    ihdr, idat = None, []
    for tag, body in _chunks(data):
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if ihdr is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = ihdr
    if depth != 8 or ctype not in _CHANNELS or interlace != 0:
        raise ValueError(f"{path}: unsupported PNG (bit depth {depth}, colour type {ctype}, "
                         f"interlace {interlace}); only 8-bit gray/gray+alpha/RGB/RGBA, "
                         "non-interlaced")
    ch = _CHANNELS[ctype]
    stride = w * ch
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError(f"{path}: image data of {raw.size} bytes, expected {h * (stride + 1)}")
    img = _unfilter(raw.reshape(h, stride + 1), h, w, ch)
    return img[..., 0] if ch == 1 else img
