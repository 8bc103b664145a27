"""GIF decoder (the first frame) on ``data/lzw.py``, giving what PIL 12
opens: ``np.asarray(Image.open(path))`` and the palette behind it.

Reads GIF87a and GIF89a: the logical screen, the global and local colour
tables, the graphic control extension's transparent index, interlaced rows
and LZW codes of up to 12 bits.  PIL's rules for the first frame:

- the mode is "P" when the frame's colour table (its local one, else the
  global one) is anything but the identity gray ramp (entry i = (i, i, i)),
  else "L": the array holds the indices either way, a gray image saved by
  PIL opens as "P" because PIL's writer trims its palette;
- the image is the logical screen, grown to hold the frame where the frame
  reaches past it; pixels outside the frame are the transparent index
  where the frame has one, else 0;
- ``convert("RGB")`` looks the indices up in that table, black past its
  end (``data/images.py``).

Later frames are not read (PIL's array is the first frame).
"""

from __future__ import annotations

import struct

import numpy as np

from danerf_tpu_torch.data.lzw import lzw_decode

_SIGNATURES = (b"GIF87a", b"GIF89a")


def _table(data: bytes, pos: int, flags: int):
    n = 3 << ((flags & 7) + 1)
    raw = data[pos:pos + n]
    if len(raw) < n:
        raise ValueError("truncated GIF colour table")
    return np.frombuffer(raw, np.uint8).reshape(-1, 3), pos + n


def _sub_blocks(data: bytes, pos: int):
    """The data sub-blocks from ``pos`` (a list of byte strings) and the
    position after their terminator."""
    parts = []
    while True:
        if pos >= len(data):
            raise ValueError("truncated GIF data")
        n = data[pos]
        pos += 1
        if n == 0:
            return parts, pos
        parts.append(data[pos:pos + n])
        pos += n


def _needed(table) -> bool:
    """PIL keeps a palette unless it is the identity gray ramp."""
    return table is not None and not np.array_equal(
        table, np.repeat(np.arange(len(table), dtype=np.uint8)[:, None], 3, axis=1))


def gif_size(data: bytes):
    """(width, height): the logical screen, grown to hold the first frame
    where it reaches past it, as PIL reports it."""
    w, h, x0, y0, fw, fh = _first_frame(data)[:6]
    return max(w, x0 + fw), max(h, y0 + fh)


def _first_frame(data: bytes):
    if data[:6] not in _SIGNATURES:
        raise ValueError("not a GIF file")
    w, h = struct.unpack("<HH", data[6:10])
    flags = data[10]
    pos = 13
    table = None
    if flags & 0x80:
        table, pos = _table(data, pos, flags)
    transparency = None
    while True:
        if pos >= len(data) or data[pos] == 0x3B:
            raise ValueError("GIF file without an image")
        tag = data[pos]
        if tag == 0x21:
            label = data[pos + 1]
            parts, pos = _sub_blocks(data, pos + 2)
            if label == 0xF9 and parts and len(parts[0]) >= 4 and parts[0][0] & 1:
                transparency = parts[0][3]
        elif tag == 0x2C:
            x0, y0, fw, fh, fflags = struct.unpack("<HHHHB", data[pos + 1:pos + 10])
            pos += 10
            if fflags & 0x80:
                table, pos = _table(data, pos, fflags)
            min_bits = data[pos]
            parts, _ = _sub_blocks(data, pos + 1)
            return (w, h, x0, y0, fw, fh, bool(fflags & 0x40), table, transparency, min_bits,
                    b"".join(parts))
        else:
            raise ValueError(f"corrupt GIF data: block type 0x{tag:02x}")


def decode_gif(data: bytes):
    """``(array, palette)``: the first frame's (H, W) uint8 indices (PIL's
    array of mode "P" or "L") and its (256, 3) palette, black past the
    colour table, or None where PIL opens the frame as "L"."""
    w, h, x0, y0, fw, fh, interlace, table, transparency, min_bits, lzw = _first_frame(data)
    if not 2 <= min_bits <= 11:
        raise ValueError(f"corrupt GIF data: LZW minimum code size {min_bits}")
    pix = lzw_decode(lzw, min_bits, msb=False, early=0, limit=fw * fh)
    if pix.size < fw * fh:
        raise ValueError("truncated GIF image data")
    pix = pix.reshape(fh, fw)
    if interlace:
        rows = np.concatenate([np.arange(0, fh, 8), np.arange(4, fh, 8), np.arange(2, fh, 4),
                               np.arange(1, fh, 2)])
        out = np.empty_like(pix)
        out[rows] = pix
        pix = out
    w, h = max(w, x0 + fw), max(h, y0 + fh)
    img = np.full((h, w), transparency or 0, np.uint8)
    img[y0:y0 + fh, x0:x0 + fw] = pix
    if not _needed(table):
        return img, None
    palette = np.zeros((256, 3), np.uint8)
    palette[:len(table)] = table
    return img, palette
