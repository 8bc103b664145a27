"""One image reader for the port, with the two views the JAX package takes
of a file through PIL 12: ``read_array`` is ``np.asarray(Image.open(p))``
(the depth maps of ``fx/``), ``read_rgb`` is ``np.asarray(Image.open(p)
.convert("RGB"))`` (photos: the custom loader, ``preview``'s picture,
``video``'s frames).  ``image_size`` is ``Image.open(p).size`` from the
header alone.

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
