"""BMP decoder in numpy, giving what PIL 12 opens:
``np.asarray(Image.open(path))`` and the palette behind it.

Reads the "BM" file header with an OS/2 core header (12 bytes),
BITMAPINFOHEADER (40) or its V2-V5 forms (52, 56, 64, 108, 124); rows
bottom-up or top-down (a negative height); 1, 4 and 8 bits a pixel through
a palette, uncompressed, RLE8 or RLE4; 16, 24 and 32 bits uncompressed
(BI_RGB) or BI_BITFIELDS with the masks PIL takes.  The modes are PIL's
(``BmpImagePlugin``):

- a palette whose ``colors`` entries are the gray ramp (black and white
  for two colours) opens as "1" (bool) or "L", any other as "P" (its
  entries after the first ``colors`` are black);
- 16 bits: "RGB" from 5-5-5 (BI_RGB) or 5-6-5 / 5-5-5 masks, each sample
  scaled to 8 bits as PIL's "BGR;15"/"BGR;16" unpackers scale it;
- 24 bits: "RGB"; 32 bits BI_RGB: "RGB" (the fourth byte ignored);
  32 bits BI_BITFIELDS: "RGB", or "RGBA" with an alpha mask.

RLE8 and RLE4 are decoded as PIL's ``BmpRleDecoder`` decodes them, its
quirks included: a delta escape reads two bytes more than it uses, an
absolute run of RLE4 keeps an even number of pixels, and a run past the
row's end is cut.  Other header sizes, bit depths, compressions (JPEG,
PNG, Huffman 1D) and bitfield layouts raise ValueError naming them.
"""

from __future__ import annotations

import struct

import numpy as np

_HEADERS = (12, 40, 52, 56, 64, 108, 124)
_MASKS32 = {(0xFF0000, 0xFF00, 0xFF, 0): "BGRX", (0xFF000000, 0xFF0000, 0xFF00, 0): "XBGR",
            (0xFF000000, 0xFF00, 0xFF, 0): "BGXR", (0xFF000000, 0xFF0000, 0xFF00, 0xFF): "ABGR",
            (0xFF, 0xFF00, 0xFF0000, 0xFF000000): "RGBA",
            (0xFF0000, 0xFF00, 0xFF, 0xFF000000): "BGRA",
            (0xFF000000, 0xFF00, 0xFF, 0xFF0000): "BGAR", (0, 0, 0, 0): "BGRA"}
_COMPRESSIONS = {0: "none", 1: "RLE8", 2: "RLE4", 3: "BITFIELDS", 4: "JPEG", 5: "PNG",
                 6: "ALPHABITFIELDS", 11: "CMYK", 12: "CMYK RLE8", 13: "CMYK RLE4"}


def _header(data: bytes):
    if data[:2] != b"BM":
        raise ValueError("not a BMP file")
    offset = struct.unpack("<I", data[10:14])[0]
    size = struct.unpack("<I", data[14:18])[0]
    if size not in _HEADERS:
        raise ValueError(f"unsupported BMP: a header of {size} bytes")
    h = data[18:14 + size]
    if len(h) < size - 4:
        raise ValueError("truncated BMP header")
    info = {"offset": offset, "header": size}
    if size == 12:
        info.update(width=struct.unpack("<H", h[0:2])[0], height=struct.unpack("<H", h[2:4])[0],
                    bits=struct.unpack("<H", h[6:8])[0], compression=0, colors=0,
                    entry=3, top_down=False)
    else:
        width, height, _, bits, comp = struct.unpack("<IIHHI", h[0:16])
        top_down = h[7] == 0xFF
        info.update(width=width, height=(2 ** 32 - height) if top_down else height,
                    bits=bits, compression=comp, colors=struct.unpack("<I", h[28:32])[0],
                    entry=4, top_down=top_down)
        if comp == 3:
            if len(h) >= 48:
                n = 4 if len(h) >= 52 else 3
                masks = struct.unpack(f"<{n}I", h[36:36 + 4 * n])
            else:                                   # masks follow a 40-byte header
                masks = struct.unpack("<3I", data[14 + size:26 + size])
            info["masks"] = tuple(masks) + (0,) * (4 - len(masks))
    info["colors"] = info["colors"] or (1 << info["bits"] if info["bits"] <= 24 else 0)
    return info


def bmp_size(data: bytes):
    """(width, height) from the header."""
    info = _header(data)
    return info["width"], info["height"]


def _scale(v: np.ndarray, bits: int) -> np.ndarray:
    """PIL's 5- and 6-bit to 8-bit scaling: v * 255 // (2**bits - 1)."""
    return (v * 255 // ((1 << bits) - 1)).astype(np.uint8)


def _rle(data: bytes, pos: int, w: int, h: int, rle4: bool) -> np.ndarray:
    """The (H, W) indices PIL's BmpRleDecoder gives, in file row order."""
    out = bytearray()
    x, n = 0, w * h
    end = len(data)
    while len(out) < n:
        if pos + 2 > end:
            break
        count, byte = data[pos], data[pos + 1]
        pos += 2
        if count:
            count = min(count, max(0, w - x))
            if rle4:
                pair = bytes([byte >> 4, byte & 15])
                out += (pair * ((count + 1) // 2))[:count]
            else:
                out += bytes([byte]) * count
            x += count
        elif byte == 0:                             # end of line
            out += bytes(-len(out) % w)
            x = 0
        elif byte == 1:                             # end of bitmap
            break
        elif byte == 2:                             # delta: PIL reads 2 bytes, then 2 more
            if pos + 2 > end:
                break
            pos += 2
            right, up = data[pos], data[pos + 1]
            pos += 2
            out += bytes(right + up * w)
            x = len(out) % w
        else:                                       # absolute run
            nbytes = byte // 2 if rle4 else byte
            chunk = data[pos:pos + nbytes]
            pos += len(chunk)
            if rle4:
                c = np.frombuffer(chunk, np.uint8)
                out += np.stack([c >> 4, c & 15], axis=1).tobytes()
            else:
                out += chunk
            if len(chunk) < nbytes:
                break
            x += byte
            pos += pos % 2                          # word alignment in the file
    if len(out) < n:
        raise ValueError("corrupt BMP RLE data: not enough image data")
    return np.frombuffer(bytes(out[:n]), np.uint8).reshape(h, w)


def decode_bmp(data: bytes):
    """``(array, palette)``: PIL's array (its mode's dtype and shape) and,
    for mode "P", the (256, 3) palette; None otherwise."""
    info = _header(data)
    w, h, bits, comp = info["width"], info["height"], info["bits"], info["compression"]
    if bits not in (1, 4, 8, 16, 24, 32):
        raise ValueError(f"unsupported BMP: {bits} bits a pixel")
    if comp not in (0, 1, 2, 3):
        raise ValueError(f"unsupported BMP: {_COMPRESSIONS.get(comp, comp)} compression")
    offset = info["offset"]
    rgba = False
    if comp == 3:
        masks = info["masks"]
        if bits == 32 and masks in _MASKS32:
            order = _MASKS32[masks]
            rgba = "A" in order
        elif bits == 24 and masks[:3] == (0xFF0000, 0xFF00, 0xFF):
            order = "BGR"
        elif bits == 16 and masks[:3] in ((0xF800, 0x7E0, 0x1F), (0x7C00, 0x3E0, 0x1F)):
            order = "565" if masks[0] == 0xF800 else "555"
        else:
            raise ValueError(f"unsupported BMP: bitfields {tuple(hex(m) for m in masks)} at "
                             f"{bits} bits")
    elif comp in (1, 2):
        if bits != (8 if comp == 1 else 4):
            raise ValueError(f"unsupported BMP: {_COMPRESSIONS[comp]} at {bits} bits")
    else:
        order = {16: "555", 24: "BGR", 32: "BGRX"}.get(bits)
    palette = None
    mode = None
    if bits <= 8:
        colors = info["colors"]
        if not 0 < colors <= 65536:
            raise ValueError(f"unsupported BMP: a palette of {colors} colours")
        entry = info["entry"]
        start = 14 + info["header"]
        raw = np.frombuffer(data[start:start + entry * colors], np.uint8)
        if raw.size < entry * colors:
            raise ValueError("truncated BMP palette")
        table = raw.reshape(colors, entry)[:, 2::-1]          # BGR(X) to RGB
        ramp = np.array([0, 255]) if colors == 2 else np.arange(colors)
        if np.array_equal(table, np.repeat(ramp[:, None], 3, axis=1)):
            mode = "1" if colors == 2 else "L"
            # PIL then unpacks the rows as "1" or "L" whatever the depth
            if (mode == "1" and (bits != 1 or comp)) or (mode == "L" and bits != 8 and not comp):
                raise ValueError(f"unsupported BMP: a {bits}-bit image whose palette is "
                                 f"the gray ramp of {colors} entries (PIL unpacks its rows "
                                 f"as {'1' if mode == '1' else '8'}-bit)")
        else:
            mode = "P"
            palette = np.zeros((256, 3), np.uint8)
            palette[:min(colors, 256)] = table[:256]
        if offset == 14 + info["header"]:
            offset += 4 * colors
    if comp in (1, 2):
        idx = _rle(data, offset, w, h, comp == 2)
    else:
        stride = ((w * bits + 31) >> 3) & ~3
        need = stride * h
        raw = np.frombuffer(data[offset:offset + need], np.uint8)
        if raw.size < need:
            raise ValueError("truncated BMP pixel data")
        rows = raw.reshape(h, stride)
        if bits < 8:
            idx = np.unpackbits(rows, axis=1)[:, :w * bits].reshape(h, w, bits)
            idx = (idx << np.arange(bits - 1, -1, -1, dtype=np.uint8)).sum(-1, dtype=np.uint8)
        elif bits == 8:
            idx = rows[:, :w]
        elif bits == 16:
            v = rows[:, :2 * w].view("<u2").astype(np.int64)
            if order == "565":
                r, g, b = _scale(v >> 11, 5), _scale((v >> 5) & 63, 6), _scale(v & 31, 5)
            else:
                r, g, b = _scale((v >> 10) & 31, 5), _scale((v >> 5) & 31, 5), _scale(v & 31, 5)
            idx = np.stack([r, g, b], axis=-1)
        else:
            px = rows[:, :w * bits // 8].reshape(h, w, bits // 8)
            src = order if bits == 32 else "BGR"
            want = "RGBA" if rgba else "RGB"
            idx = np.stack([px[..., src.index(c)] for c in want], axis=-1)
    if not info["top_down"]:
        idx = idx[::-1]
    arr = np.ascontiguousarray(idx)
    if mode == "1":
        arr = (arr != 0).view(np.uint8) * np.uint8(255)
        arr = arr.view(bool)                           # PIL's True is the byte 255
    return arr, palette
