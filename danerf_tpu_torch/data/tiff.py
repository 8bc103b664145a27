"""TIFF decoder (the first image file directory) in numpy and zlib, giving
what PIL 12 opens: ``np.asarray(Image.open(path))`` and the palette behind
it.

Reads classic TIFF in either byte order (II, MM) and little-endian BigTIFF
(PIL does not open a big-endian one); strips or tiles; PlanarConfiguration
1 (chunky) and 2 (one plane a sample); no compression, LZW
(``data/lzw.py``, early change), Deflate (8 and 32946) and PackBits;
Predictor 2 (horizontal differencing) on 8- and 16-bit samples of LZW and
Deflate data (libtiff ignores the tag otherwise).  The modes are PIL's
(``TiffImagePlugin.OPEN_INFO``):

- MinIsWhite and MinIsBlack: "1" (bool) at 1 bit, "L" at 2, 4 and 8
  bits (2- and 4-bit samples scaled to 8 bits; MinIsWhite inverted),
  16 bits "I;16" (II, either photometric, not inverted, as PIL does),
  "I;16B" (MM, MinIsBlack; a big-endian array) or "I" (signed);
  gray + alpha (ExtraSamples 2) "LA";
- RGB at 8 bits: "RGB", with a fourth sample "RGBA" (ExtraSamples none,
  2 or 999; associated alpha, 1, un-premultiplied as PIL does) or "RGB"
  (an unspecified extra sample, 0, dropped); at 16 bits the high byte
  of each sample;
- palette (ColorMap, its 16-bit entries divided by 256): "P" at 1, 2, 4
  and 8 bits, and with an unspecified extra sample.

The Orientation tag is applied as PIL applies it on loading a TIFF
(``ImageOps.exif_transpose``).  JPEG and old-style JPEG compression,
CCITT, LZMA, ZSTD, WebP and other compressions, YCbCr, CMYK, CIELab,
float and 12- or 32-bit samples, FillOrder 2, palette + alpha, and
anything else PIL opens that this list leaves out raise ValueError naming
it.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from danerf_tpu_torch.data.lzw import lzw_decode

_TYPES = {1: "B", 2: "B", 3: "H", 4: "I", 5: "II", 6: "b", 7: "B", 8: "h", 9: "i",
          10: "ii", 11: "f", 12: "d", 16: "Q", 17: "q", 18: "Q"}
_COMPRESSIONS = {1: "none", 2: "CCITT RLE", 3: "CCITT Group 3", 4: "CCITT Group 4",
                 5: "LZW", 6: "old-style JPEG", 7: "JPEG", 8: "Deflate", 32771: "CCITT RLEW",
                 32773: "PackBits", 32809: "ThunderScan", 32946: "Deflate",
                 34676: "SGILog", 34677: "SGILog24", 34712: "JPEG 2000", 34925: "LZMA",
                 50000: "ZSTD", 50001: "WebP"}
_PHOTOMETRIC = {0: "MinIsWhite", 1: "MinIsBlack", 2: "RGB", 3: "palette",
                4: "transparency mask", 5: "CMYK", 6: "YCbCr", 8: "CIELab", 9: "ICCLab",
                10: "ITULab", 32844: "LogL", 32845: "LogLuv"}
_SIGNATURES = (b"II*\0", b"MM\0*", b"II+\0", b"MM\0+")
_WIDTH, _LENGTH, _BITS, _COMPRESSION, _PHOTO, _FILL = 256, 257, 258, 259, 262, 266
_STRIPS, _ORIENTATION, _SPP, _ROWS, _STRIP_BYTES, _PLANAR = 273, 274, 277, 278, 279, 284
_PREDICTOR, _COLORMAP, _TILE_W, _TILE_L, _TILES, _TILE_BYTES = 317, 320, 322, 323, 324, 325
_EXTRA, _FORMAT = 338, 339


def _ifd(data: bytes):
    """The first IFD's tags ({tag: tuple of values}) and the byte order."""
    head = data[:4]
    if head not in _SIGNATURES:
        if head in (b"MM*\0", b"II\0*"):
            raise ValueError("unsupported TIFF: an invalid header (byte order and magic "
                             "number disagree)")
        raise ValueError("not a TIFF file")
    if head == b"MM\0+":
        raise ValueError("unsupported TIFF: big-endian BigTIFF (PIL 12 reads its header as "
                         "classic TIFF and does not open it)")
    bo = "<" if head[:2] == b"II" else ">"
    big = head[2:] in (b"+\0", b"\0+")
    if big:
        offset = struct.unpack(bo + "Q", data[8:16])[0]
        n_fmt, entry, inline = "Q", 20, 8
    else:
        offset = struct.unpack(bo + "I", data[4:8])[0]
        n_fmt, entry, inline = "H", 12, 4
    if offset + 8 > len(data):
        raise ValueError("corrupt TIFF data: the first IFD lies past the end")
    nsz = struct.calcsize(n_fmt)
    (n,) = struct.unpack(bo + n_fmt, data[offset:offset + nsz])
    tags = {}
    for i in range(n):
        p = offset + nsz + i * entry
        tag, typ = struct.unpack(bo + "HH", data[p:p + 4])
        count = struct.unpack(bo + ("Q" if big else "I"), data[p + 4:p + 4 + inline])[0]
        if typ not in _TYPES:
            continue
        fmt = _TYPES[typ]
        size = struct.calcsize(bo + fmt) * count
        if size <= inline:
            raw = data[p + 4 + inline:p + 4 + inline + size]
        else:
            at = struct.unpack(bo + ("Q" if big else "I"),
                               data[p + 4 + inline:p + 4 + 2 * inline])[0]
            raw = data[at:at + size]
            if len(raw) < size:
                raise ValueError(f"corrupt TIFF data: tag {tag} lies past the end")
        tags[tag] = struct.unpack(bo + fmt * count, raw)
    return tags, bo


def _one(tags, tag, default=None):
    v = tags.get(tag)
    return default if v is None else int(v[0])


def tiff_size(data: bytes):
    """(width, height) as PIL reports it (swapped by an Orientation of 5-8)."""
    tags, _ = _ifd(data)
    w, h = _one(tags, _WIDTH), _one(tags, _LENGTH)
    if w is None or h is None:
        raise ValueError("corrupt TIFF data: no image width or length")
    return (h, w) if _one(tags, _ORIENTATION, 1) in (5, 6, 7, 8) else (w, h)


def _layout(tags, bo):
    """PIL's mode key for the directory: (mode, samples, bits, kind), where
    kind says how samples become the array."""
    photo = _one(tags, _PHOTO, 0)
    comp = _one(tags, _COMPRESSION, 1)
    if comp not in (1, 5, 8, 32773, 32946):
        raise ValueError(f"unsupported TIFF: {_COMPRESSIONS.get(comp, f'compression {comp}')} "
                         "compression")
    if photo not in (0, 1, 2, 3):
        raise ValueError(f"unsupported TIFF: {_PHOTOMETRIC.get(photo, f'photometric {photo}')} "
                         "images")
    if _one(tags, _FILL, 1) != 1:
        raise ValueError("unsupported TIFF: FillOrder 2 (bits in reverse order)")
    fmt = tuple(tags.get(_FORMAT, (1,)))
    if len(fmt) > 1 and max(fmt) == min(fmt) == 1:
        fmt = (1,)
    bits = tuple(tags.get(_BITS, (1,)))
    extra = tuple(tags.get(_EXTRA, ()))
    spp = _one(tags, _SPP, 1)
    if spp < len(bits):
        bits = bits[:spp]
    elif spp > len(bits) and len(bits) == 1:
        bits = bits * spp
    if len(bits) != spp:
        raise ValueError("corrupt TIFF data: unknown data organization")
    if 3 in fmt:
        raise ValueError("unsupported TIFF: float samples")
    if any(b not in (1, 2, 4, 8, 16) for b in bits):
        raise ValueError(f"unsupported TIFF: {bits[0]}-bit samples")
    b = bits[0]
    gray = photo in (0, 1)
    if gray and spp == 1 and fmt == (1,) and b < 16:
        return ("1" if b == 1 else "L"), 1, b, "gray"
    if gray and spp == 1 and b == 8 and fmt == (2,) and photo == 1:
        return "L", 1, 8, "gray"
    if gray and spp == 1 and b == 16 and fmt == (1,) and (bo == "<" or photo == 1):
        return ("I;16" if bo == "<" else "I;16B"), 1, 16, "gray16"
    if gray and spp == 1 and b == 16 and fmt == (2,) and photo == 1:
        return "I", 1, 16, "signed16"
    if photo == 1 and bits == (8, 8) and extra == (2,) and fmt == (1,):
        return "LA", 2, 8, "direct"
    if photo == 2 and fmt == (1,) and b in (8, 16) and all(x == b for x in bits):
        if spp == 3 and not extra:
            return "RGB", 3, b, "direct"
        if spp == 4 and extra in ((), (2,)) + (((999,),) if b == 8 else ()):
            return "RGBA", 4, b, "direct"
        if spp == 4 and extra == (0,):
            return "RGB", 4, b, "drop"
        if spp == 4 and extra == (1,):
            return "RGBA", 4, b, "premultiplied"
    if photo == 3 and fmt == (1,) and (bits in ((1,), (2,), (4,), (8,)) or
                                       (bits == (8, 8) and extra == (0,))):
        return "P", spp, b, "palette"
    if photo == 3 and bits == (8, 8) and extra == (2,):
        raise ValueError("unsupported TIFF: palette + alpha (PIL mode PA)")
    raise ValueError(f"unsupported TIFF: {_PHOTOMETRIC[photo]} with {spp} samples of "
                     f"{bits} bits, SampleFormat {fmt}, ExtraSamples {extra}")


def _packbits(chunk: bytes, want: int) -> bytes:
    out, i, n = bytearray(), 0, len(chunk)
    while i < n and len(out) < want:
        c = chunk[i]
        i += 1
        if c < 128:
            out += chunk[i:i + c + 1]
            i += c + 1
        elif c > 128:
            if i < n:
                out += chunk[i:i + 1] * (257 - c)
            i += 1
    return bytes(out)


def _inflate(chunk: bytes, comp: int, want: int) -> np.ndarray:
    """The bytes of one strip or tile, ``want`` of them (short data is
    zero-filled, as libtiff leaves it)."""
    if comp == 1:
        raw = chunk
    elif comp == 5:
        if chunk[:1] == b"\0" and len(chunk) > 1 and chunk[1] & 1:
            raise ValueError("unsupported TIFF: old-style LZW (LSB-first codes)")
        raw = lzw_decode(chunk, 8, msb=True, early=1, limit=want).tobytes()
    elif comp in (8, 32946):
        try:
            raw = zlib.decompressobj().decompress(chunk, want)
        except zlib.error as e:
            raise ValueError(f"corrupt TIFF Deflate data: {e}") from None
    else:
        raw = _packbits(chunk, want)
    out = np.zeros(want, np.uint8)
    raw = np.frombuffer(raw[:want], np.uint8)
    out[:raw.size] = raw
    return out


def _unpredict(rows: np.ndarray, spp: int, bits: int, bo: str) -> np.ndarray:
    """Undo Predictor 2 on (rows, row bytes): a running sum of each sample
    along the row, modulo the sample size."""
    if bits == 8:
        r = rows.reshape(rows.shape[0], -1, spp)
        return np.cumsum(r, axis=1, dtype=np.uint8).reshape(rows.shape)
    if bits == 16:
        r = rows.view(bo + "u2").reshape(rows.shape[0], -1, spp)
        s = np.cumsum(r.astype(np.uint16), axis=1, dtype=np.uint16)
        return s.astype(bo + "u2").view(np.uint8).reshape(rows.shape)
    raise ValueError(f"unsupported TIFF: Predictor 2 on {bits}-bit samples")


def _planes(data: bytes, tags, bo, spp, bits):
    """The image's samples as (planes, H, row bytes) of its chunks put in
    place: one plane (all samples interleaved) or ``spp`` planes."""
    w, h = _one(tags, _WIDTH), _one(tags, _LENGTH)
    comp = _one(tags, _COMPRESSION, 1)
    planar = _one(tags, _PLANAR, 1)
    pred = _one(tags, _PREDICTOR, 1)
    if pred not in (1, 2):
        raise ValueError(f"unsupported TIFF: Predictor {pred}"
                         + (" (floating point)" if pred == 3 else ""))
    n_planes, per = (spp, 1) if planar == 2 and spp > 1 else (1, spp)
    if _TILES in tags:
        tw, th = _one(tags, _TILE_W), _one(tags, _TILE_L)
        offsets, counts = tags[_TILES], tags.get(_TILE_BYTES)
    elif _STRIPS in tags:
        tw, th = w, min(_one(tags, _ROWS, h), h) or h
        offsets, counts = tags[_STRIPS], tags.get(_STRIP_BYTES)
    else:
        raise ValueError("corrupt TIFF data: no strips or tiles")
    if counts is None:
        raise ValueError("corrupt TIFF data: no strip or tile byte counts")
    across, down = -(-w // tw), -(-h // th)
    if len(offsets) < n_planes * across * down or len(counts) < len(offsets):
        raise ValueError("corrupt TIFF data: too few strips or tiles")
    if across > 1 and (tw * per * bits) % 8:
        raise ValueError("unsupported TIFF: tiles of sub-byte samples not byte aligned")
    row_bytes = (tw * per * bits + 7) // 8
    out_row = (w * per * bits + 7) // 8
    planes = np.zeros((n_planes, down * th, across * row_bytes), np.uint8)
    i = 0
    for p in range(n_planes):
        for ty in range(down):
            for tx in range(across):
                if offsets[i] + counts[i] > len(data):
                    raise ValueError("truncated TIFF data: a strip or tile past the end")
                chunk = data[offsets[i]:offsets[i] + counts[i]]
                i += 1
                rows = _inflate(chunk, comp, th * row_bytes).reshape(th, row_bytes)
                if pred == 2 and comp in (5, 8, 32946):    # libtiff: LZW and Deflate only
                    rows = _unpredict(rows, per, bits, bo)
                planes[p, ty * th:(ty + 1) * th, tx * row_bytes:(tx + 1) * row_bytes] = rows
    return planes[:, :h, :out_row], w, h, per


def _samples(planes: np.ndarray, w: int, h: int, per: int, bits: int, bo: str) -> np.ndarray:
    """(H, W, samples) of one or several planes: uint8, or uint16 at 16 bits."""
    out = []
    for plane in planes:
        if bits == 16:
            s = plane.view(bo + "u2").astype(np.uint16)
        elif bits == 8:
            s = plane
        else:
            s = np.unpackbits(plane, axis=1)[:, :w * per * bits].reshape(h, w * per, bits)
            s = (s << np.arange(bits - 1, -1, -1, dtype=np.uint8)).sum(-1, dtype=np.uint8)
        out.append(s.reshape(h, w, per))
    return np.concatenate(out, axis=-1)


def _orient(a: np.ndarray, orientation: int) -> np.ndarray:
    """PIL's ``exif_transpose`` of an (H, W[, C]) array."""
    t = (1, 0) + tuple(range(2, a.ndim))
    ops = {2: lambda x: x[:, ::-1], 3: lambda x: x[::-1, ::-1], 4: lambda x: x[::-1],
           5: lambda x: x.transpose(t), 6: lambda x: np.rot90(x, -1),
           7: lambda x: x[::-1, ::-1].transpose(t), 8: lambda x: np.rot90(x, 1)}
    return np.ascontiguousarray(ops[orientation](a)) if orientation in ops else a


def decode_tiff(data: bytes):
    """``(array, palette)``: PIL's array of the first image (the mode's
    dtype and shape) and, for mode "P", its (256, 3) palette, black past
    the ColorMap; None otherwise."""
    tags, bo = _ifd(data)
    if 0xBC01 in tags:
        raise ValueError("unsupported TIFF: Windows Media Photo")
    if _one(tags, _WIDTH) is None or _one(tags, _LENGTH) is None:
        raise ValueError("corrupt TIFF data: no image width or length")
    mode, spp, bits, kind = _layout(tags, bo)
    planes, w, h, per = _planes(data, tags, bo, spp, bits)
    s = _samples(planes, w, h, per, bits, bo)
    photo = _one(tags, _PHOTO, 0)
    palette = None
    if kind == "gray":
        v = s[..., 0]
        if photo == 0:
            v = (1 << bits) - 1 - v
        arr = (v * (255 // ((1 << bits) - 1))).astype(np.uint8)
        if bits == 1:
            arr = arr.view(bool)                       # PIL's True is the byte 255
    elif kind == "gray16":
        arr = s[..., 0].astype(bo + "u2")
    elif kind == "signed16":
        arr = s[..., 0].view(np.int16).astype(np.int32)
    elif kind == "palette":
        arr = s[..., 0]
        cmap = tags.get(_COLORMAP)
        n = 1 << bits
        if cmap is None or len(cmap) < 3 * n:
            raise ValueError("corrupt TIFF data: a palette image without its ColorMap")
        palette = np.zeros((256, 3), np.uint8)
        palette[:n] = (np.asarray(cmap[:3 * n], np.int64).reshape(3, n).T // 256)
    else:
        if bits == 16:
            s = (s >> 8).astype(np.uint8)
        if kind == "drop":
            s = s[..., :3]
        elif kind == "premultiplied":
            s = _unpremultiply(s)
        arr = np.ascontiguousarray(s)
    return _orient(arr, _one(tags, _ORIENTATION, 1)), palette


def _unpremultiply(s: np.ndarray) -> np.ndarray:
    """PIL's "RGBa" unpacking: each colour * 255 // alpha, clipped; 0 where
    alpha is 0."""
    a = s[..., 3:].astype(np.int32)
    rgb = np.minimum(s[..., :3].astype(np.int32) * 255 // np.maximum(a, 1), 255)
    rgb = np.where(a == 255, s[..., :3], np.where(a == 0, 0, rgb))
    return np.concatenate([rgb, a], axis=-1).astype(np.uint8)
