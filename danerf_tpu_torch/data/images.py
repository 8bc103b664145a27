"""One image reader for the port, with the views the JAX package takes of
a file: through PIL 12, ``read_array`` is ``np.asarray(Image.open(p))``
(the depth maps of ``fx/``) and ``read_rgb`` is ``np.asarray(Image.open(p)
.convert("RGB"))`` (photos: the custom loader, ``preview``'s picture);
through OpenCV, ``read_cv2`` is ``cv2.imread(p)`` in RGB (``video``'s
frames: EXIF orientation, 16-bit samples shifted down, None where cv2
gives None).  ``image_size`` is ``Image.open(p).size`` from the header
alone.

The format is told by the file's signature, never by its name:

- PNG (``data/png.py``) and JPEG, baseline and progressive
  (``data/jpeg.py``);
- BMP (``data/bmp.py``), Netpbm P1-P6 and PFM (``data/netpbm.py``), TIFF
  and BigTIFF (``data/tiff.py``), GIF (``data/gif.py``, the first frame),
  WebP (``data/webp.py``), lossless or lossy (``data/vp8.py``), with or
  without alpha.

``read_array`` gives each mode's dtype and shape as PIL's array does: the
palette indices of "P", ``bool`` for "1", ``uint16`` for "I;16" (big-endian
for "I;16B"), ``int32`` for "I", ``float32`` for "F", and the channels of
"L", "LA", "RGB" and "RGBA".  ``read_rgb`` converts as PIL's
``convert("RGB")``: gray repeated, alpha dropped, a palette looked up
(black past its entries), "1" as 0/255 (PIL's bool array holds True as the
byte 255, and so does the port's), "I;16" and "I" clipped to 0..255,
"F" clipped and truncated.

Animated WebP, and formats PIL opens that the port does not (JPEG 2000,
AVIF/HEIF, PSD, QOI, ICO, DDS and others with a known signature), raise
ValueError naming the format; a file with no known signature (TGA has
none) raises "unknown image format".
"""

from __future__ import annotations

import importlib
import struct

import numpy as np

_PNG = b"\x89PNG\r\n\x1a\n"
_TIFF = (b"II*\0", b"MM\0*", b"II+\0", b"MM\0+", b"MM*\0", b"II\0*")
_REFUSED = (                       # (signature test, name) of formats PIL opens
    (lambda h: h.startswith(b"\0\0\0\x0cjP  \r\n\x87\n") or h.startswith(b"\xff\x4f\xff\x51"),
     "JPEG 2000"),
    (lambda h: h[4:8] == b"ftyp" and h[8:12] in (b"avif", b"avis"), "AVIF"),
    (lambda h: h[4:8] == b"ftyp" and h[8:12] in (b"heic", b"heix", b"hevc", b"hevx", b"mif1",
                                                  b"msf1", b"heim", b"heis"), "HEIF"),
    (lambda h: h.startswith(b"8BPS"), "PSD"),
    (lambda h: h.startswith(b"qoif"), "QOI"),
    (lambda h: h.startswith(b"\0\0\1\0"), "ICO"),
    (lambda h: h.startswith(b"DDS "), "DDS"),
    (lambda h: h.startswith(b"icns"), "ICNS"),
    (lambda h: h.startswith(b"\x01\xda"), "SGI"),
    (lambda h: h.startswith(b"\x59\xa6\x6a\x95"), "Sun raster"),
    (lambda h: h.startswith(b"%!PS") or h.startswith(b"\xc5\xd0\xd3\xc6"), "EPS"),
    (lambda h: h.startswith(b"/* XPM */"), "XPM"),
    (lambda h: h.startswith(b"SIMPLE  ="), "FITS"),
    (lambda h: h[:1] == b"\x0a" and h[1:2] in b"\x00\x02\x03\x04\x05" and len(h) > 2
     and h[2:3] == b"\x01", "PCX"),
)


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def format_of(data: bytes) -> str:
    """The format a file's first bytes name: "png", "jpeg", "bmp", "gif",
    "tiff", "webp" or "netpbm"; ValueError for any other."""
    from danerf_tpu_torch.data.netpbm import is_netpbm

    if data.startswith(_PNG):
        return "png"
    if data.startswith(b"\xff\xd8"):
        return "jpeg"
    if data.startswith(b"BM"):
        return "bmp"
    if data.startswith((b"GIF87a", b"GIF89a")):
        return "gif"
    if data.startswith(_TIFF):
        return "tiff"
    if data.startswith(b"RIFF") and data[8:12] == b"WEBP":
        return "webp"
    if is_netpbm(data[:2]):
        return "netpbm"
    for test, name in _REFUSED:
        if test(data[:16]):
            raise ValueError(f"unsupported image format: {name}")
    raise ValueError("unknown image format")


def decode(data: bytes):
    """``(array, palette)``: PIL's opened array of the file's bytes and, for
    mode "P", its (256, 3) uint8 palette (None otherwise).  A truncated or
    corrupt file raises ValueError naming its format."""
    fmt = format_of(data)
    try:
        return _decode(fmt, data)
    except (struct.error, IndexError) as e:
        raise ValueError(f"corrupt or truncated {fmt} file ({e})") from None


def _decode(fmt: str, data: bytes):
    if fmt == "png":
        from danerf_tpu_torch.data.png import decode_png_opened

        return decode_png_opened(data)
    if fmt == "jpeg":
        from danerf_tpu_torch.data.jpeg import decode_jpeg, jpeg_header

        rgb = decode_jpeg(data)
        return (np.ascontiguousarray(rgb[..., 0]) if jpeg_header(data)[2] == 1 else rgb), None
    return getattr(importlib.import_module(f"danerf_tpu_torch.data.{fmt}"), f"decode_{fmt}")(data)


def to_rgb(array: np.ndarray, palette=None) -> np.ndarray:
    """PIL's ``convert("RGB")`` of an opened array (and its palette): (H, W,
    3) uint8."""
    a = array
    if a.ndim == 3:
        if a.shape[-1] == 2:                              # LA
            return np.repeat(a[..., :1], 3, axis=-1)
        return np.ascontiguousarray(a[..., :3])
    if palette is not None:
        return palette[a]
    if a.dtype == bool:
        a = (a != 0).astype(np.uint8) * np.uint8(255)
    elif a.dtype != np.uint8:                             # I;16, I, F: clipped (F truncated)
        a = np.clip(a, 0, 255).astype(np.uint8)
    return np.repeat(a[..., None], 3, axis=-1)


def read_array(path: str) -> np.ndarray:
    """``np.asarray(Image.open(path))`` under PIL 12: the dtype and shape of
    the mode PIL opens (module docstring)."""
    try:
        return decode(_read(path))[0]
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None


def read_rgb(path: str) -> np.ndarray:
    """``np.asarray(Image.open(path).convert("RGB"))``: (H, W, 3) uint8."""
    data = _read(path)
    try:
        if format_of(data) == "jpeg":
            from danerf_tpu_torch.data.jpeg import decode_jpeg

            return decode_jpeg(data)
        return to_rgb(*decode(data))
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None


# ------------------------------------------------------------ as cv2.imread reads

_CV2_REFUSED = ("JPEG 2000", "AVIF", "Sun raster")    # cv2 reads these, the port does not
# EXIF orientation -> the transform cv2 applies to an (H, W, C) array
_ORIENT = {2: lambda a: a[:, ::-1], 3: lambda a: a[::-1, ::-1], 4: lambda a: a[::-1],
           5: lambda a: a.transpose(1, 0, 2), 6: lambda a: np.rot90(a, -1),
           7: lambda a: a.transpose(1, 0, 2)[::-1, ::-1], 8: lambda a: np.rot90(a, 1)}


def _exif_orientation(tiff: bytes) -> int:
    """Tag 0x0112 of an EXIF block's first IFD (1 when absent)."""
    if tiff.startswith(b"Exif\0\0"):
        tiff = tiff[6:]
    if tiff[:4] not in (b"II*\0", b"MM\0*"):
        return 1
    bo = "<" if tiff[:2] == b"II" else ">"
    ifd = struct.unpack(bo + "I", tiff[4:8])[0]
    (n,) = struct.unpack(bo + "H", tiff[ifd:ifd + 2])
    for k in range(n):
        e = ifd + 2 + 12 * k
        tag, kind = struct.unpack(bo + "HH", tiff[e:e + 4])
        if tag == 0x0112 and kind == 3:
            return struct.unpack(bo + "H", tiff[e + 8:e + 10])[0]
    return 1


def _exif_block(fmt: str, data: bytes) -> bytes:
    """The EXIF block of a JPEG (APP1), PNG (eXIf) or WebP (EXIF chunk)."""
    if fmt == "jpeg":
        pos = 2
        while pos + 4 <= len(data) and data[pos] == 0xFF and data[pos + 1] not in (0xDA, 0xD9):
            n = struct.unpack(">H", data[pos + 2:pos + 4])[0]
            if data[pos + 1] == 0xE1 and data[pos + 4:pos + 10] == b"Exif\0\0":
                return data[pos + 10:pos + 2 + n]
            pos += 2 + n
    elif fmt == "png":
        pos = len(_PNG)
        while pos + 8 <= len(data):
            n, tag = struct.unpack(">I4s", data[pos:pos + 8])
            if tag == b"eXIf":
                return data[pos + 8:pos + 8 + n]
            if tag == b"IDAT":
                break
            pos += 12 + n
    elif fmt == "webp":
        pos = 12
        while pos + 8 <= len(data):
            tag, n = data[pos:pos + 4], struct.unpack("<I", data[pos + 4:pos + 8])[0]
            if tag == b"EXIF":
                return data[pos + 8:pos + 8 + n]
            pos += 8 + n + (n & 1)
    return b""


def _netpbm_cv2(data: bytes) -> np.ndarray:
    """cv2's samples of a Netpbm file: binary samples as stored, plain
    8-bit ones scaled by 255 // maxval, 16-bit ones (either kind) shifted
    down by 8; bitmaps 0/255 as PIL's."""
    from danerf_tpu_torch.data.netpbm import _header, _plain_tokens, decode_netpbm

    magic, w, h, maxval, pos = _header(data)
    if magic in (b"P1", b"P4"):
        return decode_netpbm(data)[0]
    if magic == b"Pf":
        return None
    bands = 3 if magic in (b"P3", b"P6") else 1
    n = w * h * bands
    if magic in (b"P2", b"P3"):
        v = np.array([int(t) for t in _plain_tokens(data[pos:])[:n]], np.int64)
        if v.size < n:
            raise ValueError("truncated Netpbm data")
        v = v >> 8 if maxval > 255 else v * 255 // maxval
    else:
        wide = maxval > 255
        body = data[pos:pos + n * (2 if wide else 1)]
        if len(body) < n * (2 if wide else 1):
            raise ValueError("truncated Netpbm data")
        v = np.frombuffer(body, ">u2" if wide else np.uint8).astype(np.int64)
        v = v >> 8 if wide else v
    return v.reshape((h, w, 3) if bands == 3 else (h, w)).astype(np.uint8)


def _bmp16_cv2(data: bytes, rgb: np.ndarray) -> np.ndarray:
    """cv2 widens a 16-bit BMP's 5- and 6-bit samples by a shift; PIL (and
    ``decode_bmp``) by v * 255 // (2**bits - 1), which this inverts."""
    green = 6 if rgb.size and struct.unpack("<I", data[54:58])[0] == 0xF800 else 5
    out = rgb.copy()
    for c, bits in ((0, 5), (1, green), (2, 5)):
        back = np.zeros(256, np.uint8)
        levels = np.arange(1 << bits)
        back[levels * 255 // ((1 << bits) - 1)] = levels << (8 - bits)
        out[..., c] = back[rgb[..., c]]
    return out


def _gif_background(data: bytes, palette: np.ndarray) -> np.ndarray:
    return palette[data[11]] if data[10] & 0x80 else np.zeros(3, np.uint8)


def read_cv2(path: str):
    """``cv2.imread(path)`` (``IMREAD_COLOR``) as (H, W, 3) uint8 RGB, or None
    where cv2 returns None, as the JAX ``video`` reads its frames:

    - EXIF orientation applied on JPEG, PNG (eXIf) and WebP; a TIFF's
      Orientation of 2-4 applied, 5-8 unread (None);
    - 16-bit samples shifted down by 8 (PNG, TIFF, Netpbm); Netpbm samples
      as stored, plain 8-bit ones scaled to 255; PFM unread;
    - gray repeated, alpha dropped (a TIFF's colour premultiplied by its
      alpha first, as libtiff's RGBA reader gives it), palettes looked up
      (a GIF's transparent index shows the background colour), 16-bit BMP
      samples widened by a shift;
    - a file without a known signature, or corrupt, gives None; JPEG 2000,
      AVIF and Sun raster, which cv2 reads and the port does not, raise
      ValueError by name.
    """
    data = _read(path)
    try:
        fmt = format_of(data)
    except ValueError as e:
        if any(name in str(e) for name in _CV2_REFUSED):
            raise ValueError(f"{path}: {e}; cv2 reads it, the port does not") from None
        return None
    try:
        if fmt == "netpbm":
            arr, palette = _netpbm_cv2(data), None
            if arr is None:
                return None
        elif fmt == "jpeg":
            from danerf_tpu_torch.data.jpeg import decode_jpeg

            arr, palette = decode_jpeg(data), None
        else:
            arr, palette = decode(data)
    except ValueError:
        return None
    if arr.dtype.kind == "f" or arr.dtype == np.int32:
        raise ValueError(f"{path}: {arr.dtype} samples are not read as cv2 reads them")
    if arr.dtype.kind == "u" and arr.dtype.itemsize == 2:
        arr = (arr >> 8).astype(np.uint8)
    if palette is not None:
        if fmt == "gif":
            from danerf_tpu_torch.data.gif import _first_frame

            t = _first_frame(data)[8]
            rgb = palette[arr]
            if t is not None:
                rgb[arr == t] = _gif_background(data, palette)
        else:
            rgb = palette[arr]
    elif arr.ndim == 3 and arr.shape[-1] == 4 and fmt == "tiff":
        a = arr[..., 3:].astype(np.int64)
        rgb = ((arr[..., :3].astype(np.int64) * a + 127) // 255).astype(np.uint8)
    else:
        rgb = to_rgb(arr)
    if fmt == "bmp" and struct.unpack("<H", data[28:30])[0] == 16:
        rgb = _bmp16_cv2(data, rgb)
    if fmt == "tiff":
        from danerf_tpu_torch.data.tiff import _ORIENTATION, _ifd, _one

        if _one(_ifd(data)[0], _ORIENTATION, 1) in (5, 6, 7, 8):
            return None
    elif fmt in ("jpeg", "png", "webp"):
        o = _exif_orientation(_exif_block(fmt, data))
        if o in _ORIENT:
            rgb = _ORIENT[o](rgb)
    return np.ascontiguousarray(rgb)


def image_size(path: str):
    """``Image.open(path).size``, (width, height), from the header."""
    data = _read(path)
    try:
        fmt = format_of(data)
        if fmt == "png":
            return struct.unpack(">II", data[16:24])
        if fmt == "jpeg":
            from danerf_tpu_torch.data.jpeg import jpeg_size

            h, w = jpeg_size(data)
            return w, h
        module = importlib.import_module(f"danerf_tpu_torch.data.{fmt}")
        return getattr(module, f"{fmt}_size")(data)
    except (struct.error, IndexError) as e:
        raise ValueError(f"{path}: corrupt or truncated {fmt} file ({e})") from None
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None
