"""PNG decoder on zlib/numpy, so the port reads PNG files without an imaging
library.

Reads every PNG that PIL reads: gray at bit depths 1, 2, 4, 8 and 16, gray
+ alpha and RGB and RGBA at 8 and 16, palette (PLTE, with tRNS) at 1, 2, 4
and 8; non-interlaced or Adam7 (seven passes, each unfiltered on its own,
then scattered); any of the five scanline filters (None, Sub, Up, Average,
Paeth).  ``read_png`` gives what ``np.asarray(Image.open(path))`` gives for
the mode PIL opens, with two exceptions where PIL's array is not pixels (a
palette, a 1-bit image); ``decode_png_opened`` gives PIL's array in those
two cases too, and the palette.  Other bit depths and colour types, and other
compression, filter or interlace methods, raise ValueError.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}   # colour type -> samples per pixel
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# Adam7: (x0, y0, dx, dy) of each pass
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))


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


def _samples(raw: np.ndarray, h: int, w: int, ch: int, depth: int) -> np.ndarray:
    """The (h, w, ch) samples of h filtered scanlines of w pixels: uint8 for
    depths up to 8 (sub-byte samples unpacked, not scaled), uint16 for 16.
    The filters work on bytes: a pixel's bytes, or one byte below 8 bits."""
    rowbytes = (w * ch * depth + 7) // 8
    bpp = max(1, ch * depth // 8)
    rows = _unfilter(raw.reshape(h, rowbytes + 1), h, rowbytes // bpp, bpp).reshape(h, rowbytes)
    if depth == 16:
        return rows.view(">u2").astype(np.uint16).reshape(h, w, ch)
    if depth < 8:
        bits = np.unpackbits(rows, axis=1)[:, :w * ch * depth].reshape(h, w * ch, depth)
        rows = (bits << np.arange(depth - 1, -1, -1, dtype=np.uint8)).sum(-1, dtype=np.uint8)
    return rows.reshape(h, w, ch)


def _pixels(raw: np.ndarray, h: int, w: int, ch: int, depth: int, interlace: int):
    """The (h, w, ch) samples of the whole image, from its inflated data."""
    def rowbytes(n):
        return (n * ch * depth + 7) // 8

    if interlace == 0:
        want = h * (rowbytes(w) + 1)
        if raw.size != want:
            raise ValueError(f"image data of {raw.size} bytes, expected {want}")
        return _samples(raw, h, w, ch, depth)
    passes, want = [], 0
    for x0, y0, dx, dy in _ADAM7:
        pw, ph = max(0, -(-(w - x0) // dx)), max(0, -(-(h - y0) // dy))
        n = ph * (rowbytes(pw) + 1) if pw else 0      # an empty pass has no filter bytes
        passes.append((x0, y0, dx, dy, pw, ph, want, n))
        want += n
    if raw.size != want:
        raise ValueError(f"image data of {raw.size} bytes, expected {want} (Adam7)")
    out = np.zeros((h, w, ch), np.uint16 if depth == 16 else np.uint8)
    for x0, y0, dx, dy, pw, ph, start, n in passes:
        if n:
            out[y0::dy, x0::dx] = _samples(raw[start:start + n], ph, pw, ch, depth)
    return out


def _decode(data: bytes):
    """(samples (H, W, C) as ``_pixels`` gives them, colour type, bit depth,
    the palette as PIL pads it (256 RGBA entries) or None)."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    ihdr, plte, trns, idat = None, None, None, []
    for tag, body in _chunks(data):
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body[:13])
        elif tag == b"PLTE":
            plte = body
        elif tag == b"tRNS":
            trns = body
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if ihdr is None:
        raise ValueError("no IHDR chunk")
    w, h, depth, ctype, method, filt, interlace = ihdr
    if ctype not in _CHANNELS or depth not in _DEPTHS[ctype] or method or filt or interlace > 1:
        raise ValueError(f"unsupported PNG (bit depth {depth}, colour type {ctype}, "
                         f"compression {method}, filter {filt}, interlace {interlace})")
    try:
        raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    except zlib.error as e:
        raise ValueError(f"corrupt PNG image data: {e}") from None
    img = _pixels(raw, h, w, _CHANNELS[ctype], depth, interlace)
    lut = None
    if ctype == 3:
        if plte is None or len(plte) % 3 or len(plte) > 768:
            raise ValueError("palette PNG without a valid PLTE chunk")
        # PIL's palette: 256 entries, black past PLTE, opaque past tRNS
        lut = np.zeros((256, 4), np.uint8)
        lut[:len(plte) // 3, :3] = np.frombuffer(plte, np.uint8).reshape(-1, 3)
        lut[:, 3] = 255
        if trns is not None:
            lut[:min(256, len(trns)), 3] = np.frombuffer(trns[:256], np.uint8)
    return img, ctype, depth, lut, trns is not None


def decode_png(data: bytes) -> np.ndarray:
    """The pixels of a PNG file's bytes, as PIL opens them:

    - gray: uint8 (H, W), 2- and 4-bit samples scaled to 8 bits (x85, x17);
      1-bit as 0/255 (``Image.convert("L")``; PIL's own array of mode "1"
      is bool); 16-bit as uint16 (H, W) (mode "I;16");
    - gray + alpha: uint8 (H, W, 2); at 16 bits (H, W, 4), the gray high
      byte repeated, as PIL opens it as RGBA;
    - RGB, RGBA: uint8 (H, W, 3|4), 16-bit samples as their high byte;
    - palette: the palette's colours, (H, W, 3), or (H, W, 4) with the
      alpha of tRNS (255 past its end) where the file has one (PIL's array
      of mode "P" is the indices); an index past PLTE is black, as PIL
      pads its palette.

    A tRNS of gray or RGB is ignored, as in PIL's array.  ``decode_png_opened``
    gives PIL's array where it is not pixels (mode "P" and "1")."""
    return _as_pixels(*_decode(data))


def _as_pixels(img, ctype, depth, lut, has_trns):
    if ctype == 3:
        return lut[img[..., 0]] if has_trns else lut[img[..., 0], :3]
    if depth == 16:
        if ctype == 0:
            return img[..., 0]
        img = (img >> 8).astype(np.uint8)
        if ctype == 4:
            return img[..., [0, 0, 0, 1]]
        return img
    if ctype == 0:
        return img[..., 0] * np.uint8({1: 255, 2: 85, 4: 17, 8: 1}[depth])
    return img


def decode_png_opened(data: bytes):
    """``(array, palette)``: exactly ``np.asarray(Image.open(...))`` (a
    palette image's indices, a 1-bit gray image's bool array, else
    ``decode_png``) and, for a palette image, its (256, 3) palette (black
    past PLTE; tRNS is not part of ``convert("RGB")``); None otherwise."""
    img, ctype, depth, lut, has_trns = _decode(data)
    if ctype == 3:
        return np.ascontiguousarray(img[..., 0]), np.ascontiguousarray(lut[:, :3])
    if ctype == 0 and depth == 1:
        return (img[..., 0] * np.uint8(255)).view(bool), None   # PIL's True is the byte 255
    return _as_pixels(img, ctype, depth, lut, has_trns), None


def read_png(path: str) -> np.ndarray:
    """Decode a PNG file (``decode_png``): uint8 (H, W) for gray (uint16 at
    16 bits), else (H, W, C) with C = 2 (gray + alpha), 3 (RGB) or 4
    (RGBA)."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        return decode_png(data)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None
