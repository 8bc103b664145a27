"""The port's one image reader (``danerf_tpu_torch/data/images.py``) against
PIL 12 and danerf_tpu on the CPU.

Every case writes a file here, with PIL where PIL writes the variant and
by hand where it cannot (RLE BMPs, bitfields and V4/V5 headers; TIFFs that
are tiled, planar, BigTIFF, big-endian, 16-bit colour or with associated
alpha; plain and odd-maxval Netpbm; GIFs with local tables, offsets,
interlacing and a deferred clear; lossless WebPs in a VP8X container; the
lossy WebPs are in ``test_torch_webp_lossy.py``), and
holds ``read_array`` against ``np.asarray(Image.open(p))`` (dtype, shape
and every value), ``read_rgb`` against ``convert("RGB")`` and
``image_size`` against ``Image.open(p).size``.  Refusals name their
format.  A custom scene of these formats loads as the JAX
``load_custom_scene`` loads it, and the port's ``load_depth`` gives the
depth array of the JAX ``preview_from_files`` for JPEG, palette, 1-bit,
16-bit, GIF, RGB and lossy WebP depth maps.  The committed fixtures of
``tests/data_torch/formats/`` (``chip_smoke.py``'s loaders phase decodes
them on the card's host) match their PIL digests.

Tolerance: none; every array equals PIL's bit for bit.
"""

import hashlib
import io
import json
import os
import re
import struct
import zlib

import numpy as np
import pytest
import torch

Image = pytest.importorskip("PIL.Image")
TiffImagePlugin = pytest.importorskip("PIL.TiffImagePlugin")

torch.set_num_threads(2)

FORMATS = os.path.join(os.path.dirname(__file__), "data_torch", "formats")


def _natural(h, w, seed=0, levels=None):
    """A smooth colour picture with texture; ``levels`` posterizes it."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w] / max(h, w)
    img = np.stack([128 + 90 * np.sin(7 * x + 3 * c) * np.cos(5 * y - c) for c in range(3)], -1)
    img = img + rng.normal(0, 10, img.shape)
    img = np.clip(img, 0, 255).astype(np.uint8)
    if levels:
        img = (img // (256 // levels)) * (256 // levels)
    return img


def _pil(img, fmt, mode=None, **kw) -> bytes:
    im = Image.fromarray(img) if not isinstance(img, Image.Image) else img
    if mode:
        im = im.convert(mode)
    buf = io.BytesIO()
    im.save(buf, fmt, **kw)
    return buf.getvalue()


# ----------------------------------------------------------------- encoders

def _lzw(data: bytes, min_bits: int, msb: bool, early: int, clear_at=4094) -> bytes:
    """LZW of ``data`` (a clear code first, an end code last); a clear code
    when the next free code reaches ``clear_at`` (None: never, GIF's
    deferred clear).  Code widths as the decoders read them."""
    clear, end = 1 << min_bits, (1 << min_bits) + 1
    first = clear + 2
    out_bits = []

    def put(code, k):
        free = min(first + max(k - 1, 0), 4096)
        width = min(12, max(min_bits + 1, (free + early).bit_length()))
        out_bits.append((code, width))

    table = {bytes([i]): i for i in range(clear)}
    nxt, k = first, 0
    put(clear, 0)
    w = b""
    for c in data:
        wc = w + bytes([c])
        if wc in table:
            w = wc
            continue
        put(table[w], k)
        k += 1
        if nxt < 4096:
            table[wc] = nxt
            nxt += 1
        if clear_at is not None and nxt >= clear_at:
            put(clear, k)
            table = {bytes([i]): i for i in range(clear)}
            nxt, k = first, 0
        w = bytes([c])
    if w:
        put(table[w], k)
        k += 1
    put(end, k)
    acc, nbits, out = 0, 0, bytearray()
    for code, width in out_bits:
        if msb:
            acc = (acc << width) | code
            nbits += width
            while nbits >= 8:
                out.append((acc >> (nbits - 8)) & 0xFF)
                nbits -= 8
        else:
            acc |= code << nbits
            nbits += width
            while nbits >= 8:
                out.append(acc & 0xFF)
                acc >>= 8
                nbits -= 8
    if nbits:
        out.append(((acc << (8 - nbits)) if msb else acc) & 0xFF)
    return bytes(out)


def _packbits(data: bytes) -> bytes:
    out, i = bytearray(), 0
    while i < len(data):
        j = i
        while j + 1 < len(data) and data[j + 1] == data[i] and j - i < 127:
            j += 1
        if j > i:
            out += bytes([257 - (j - i + 1), data[i]])
            i = j + 1
            continue
        j = i
        while j + 1 < len(data) and data[j + 1] != data[j] and j - i < 127:
            j += 1
        out += bytes([j - i]) + data[i:j + 1]
        i = j + 1
    return bytes(out)


def _tiff(samples, photometric, bits=8, bo="<", big=False, compression=1, predictor=1,
          tile=None, rows=None, planar=1, extra=None, colormap=None, sample_format=None,
          orientation=None, fill=None) -> bytes:
    """A TIFF of (H, W, C) samples (uint8, or uint16 at 16 bits; 1-4 bit
    samples as small uint8 values)."""
    s = np.asarray(samples)
    if s.ndim == 2:
        s = s[..., None]
    h, w, spp = s.shape
    planes = [s[..., i:i + 1] for i in range(spp)] if planar == 2 else [s]
    if tile:
        tw, th = tile
    else:
        tw, th = w, rows or h
    across, down = -(-w // tw), -(-h // th)

    def encode_rows(block):           # (th, tw, per) -> bytes of its rows
        per = block.shape[-1]
        if bits == 16:
            if predictor == 2:
                block = np.diff(block.astype(np.int64), axis=1, prepend=0).astype(np.uint16)
            raw = block.astype(bo + "u2").tobytes()
        elif bits == 8:
            if predictor == 2:
                block = np.diff(block.astype(np.int64), axis=1, prepend=0).astype(np.uint8)
            raw = block.astype(np.uint8).tobytes()
        else:
            v = block.reshape(block.shape[0], -1)
            bitsarr = ((v[..., None] >> np.arange(bits - 1, -1, -1)) & 1).reshape(v.shape[0], -1)
            raw = np.packbits(bitsarr.astype(np.uint8), axis=1).tobytes()
        if compression == 5:
            return _lzw(raw, 8, msb=True, early=1)
        if compression in (8, 32946):
            return zlib.compress(raw)
        if compression == 32773:
            return _packbits(raw)
        return raw

    chunks = []
    for plane in planes:
        for ty in range(down):
            for tx in range(across):
                block = np.zeros((th, tw, plane.shape[-1]), plane.dtype)
                part = plane[ty * th:(ty + 1) * th, tx * tw:(tx + 1) * tw]
                block[:part.shape[0], :part.shape[1]] = part
                if not tile:
                    block = block[:part.shape[0]]
                chunks.append(encode_rows(block))
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * spp), 259: (3, [compression]),
            262: (3, [photometric]), 277: (3, [spp]), 284: (3, [planar])}
    if predictor != 1:
        tags[317] = (3, [predictor])
    if extra is not None:
        tags[338] = (3, list(extra))
    if colormap is not None:
        tags[320] = (3, list(np.asarray(colormap).T.ravel()))
    if sample_format is not None:
        tags[339] = (3, [sample_format] * spp)
    if orientation is not None:
        tags[274] = (3, [orientation])
    if fill is not None:
        tags[266] = (3, [fill])
    off_tag, cnt_tag = (324, 325) if tile else (273, 279)
    if tile:
        tags[322], tags[323] = (3, [tw]), (3, [th])
    else:
        tags[278] = (4, [th])
    head = 16 if big else 8
    pos = head
    offsets = []
    body = bytearray()
    for c in chunks:
        offsets.append(pos + len(body))
        body += c
        body += b"\0" * (len(body) & 1)
    long_t = 16 if big else 4
    tags[off_tag] = (long_t, offsets)
    tags[cnt_tag] = (long_t, [len(c) for c in chunks])
    fmt = {3: "H", 4: "I", 16: "Q"}
    inline = 8 if big else 4
    ifd_at = pos + len(body)
    n = len(tags)
    entry = 20 if big else 12
    extra_at = ifd_at + (8 if big else 2) + n * entry + (8 if big else 4)
    entries, spill = bytearray(), bytearray()
    for tag in sorted(tags):
        typ, vals = tags[tag]
        raw = struct.pack(bo + fmt[typ] * len(vals), *vals)
        entries += struct.pack(bo + "HH", tag, typ)
        entries += struct.pack(bo + ("Q" if big else "I"), len(vals))
        if len(raw) <= inline:
            entries += raw + b"\0" * (inline - len(raw))
        else:
            entries += struct.pack(bo + ("Q" if big else "I"), extra_at + len(spill))
            spill += raw + b"\0" * (len(raw) & 1)
    ifd = struct.pack(bo + ("Q" if big else "H"), n) + entries + bytes(8 if big else 4)
    if big:
        header = (b"II" if bo == "<" else b"MM") + struct.pack(bo + "HHHQ", 43, 8, 0, ifd_at)
    else:
        header = (b"II" if bo == "<" else b"MM") + struct.pack(bo + "HI", 42, ifd_at)
    return bytes(header + body + ifd + spill)


def _bmp(pixels: bytes, w, h, bits, comp=0, palette=None, header=40, masks=None,
         top_down=False, colors=0) -> bytes:
    """A BMP file of the given pixel bytes (rows already in file order)."""
    pal = b""
    if palette is not None:
        entry = 3 if header == 12 else 4
        pal = b"".join(bytes([b, g, r] + [0] * (entry - 3)) for r, g, b in palette)
    if header == 12:
        hdr = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        hdr = struct.pack("<IiiHHIIiiII", header, w, -h if top_down else h, 1, bits, comp,
                          len(pixels), 2835, 2835, colors, 0)
        after = b""
        if masks is not None and header == 40:
            after = struct.pack("<3I", *masks[:3])
        elif header > 40:
            m = list(masks or (0, 0, 0, 0)) + [0] * 4
            hdr += struct.pack("<4I", *m[:4]) + bytes(header - 56)
        hdr += after
    off = 14 + len(hdr) + len(pal)
    return b"BM" + struct.pack("<IHHI", off + len(pixels), 0, 0, off) + hdr + pal + pixels


def _bmp_rows(arr, bits):
    """Bottom-up rows of an (H, W[, C]) array, each padded to 4 bytes."""
    h = arr.shape[0]
    out = bytearray()
    for y in range(h - 1, -1, -1):
        row = arr[y]
        if bits < 8:
            v = row.astype(np.uint8)
            b = ((v[:, None] >> np.arange(bits - 1, -1, -1)) & 1).ravel()
            raw = np.packbits(b.astype(np.uint8)).tobytes()
        elif bits == 16:
            raw = row.astype("<u2").tobytes()
        else:
            raw = row.astype(np.uint8).tobytes()
        out += raw + bytes(-len(raw) % 4)
    return bytes(out)


def _rle8(idx) -> bytes:
    """RLE8 of (H, W) indices, bottom-up: runs, absolute runs of 3+ pixels,
    an end of line a row, an end of bitmap."""
    out = bytearray()
    for row in idx[::-1]:
        x, w = 0, len(row)
        while x < w:
            j = x
            while j + 1 < w and row[j + 1] == row[x] and j - x < 254:
                j += 1
            if j - x >= 1:
                out += bytes([j - x + 1, row[x]])
                x = j + 1
                continue
            j = x
            while j + 1 < w and row[j + 1] != row[j] and j - x < 254:
                j += 1
            n = j - x + 1
            if n >= 3:
                out += bytes([0, n]) + bytes(row[x:x + n].tolist()) + bytes(n & 1)
            else:
                out += b"".join(bytes([1, v]) for v in row[x:x + n].tolist())
            x += n
        out += b"\0\0"
    return bytes(out + b"\0\1")


def _rle4(idx) -> bytes:
    """RLE4 of (H, W) 4-bit indices, bottom-up: runs of two alternating
    values and even-length absolute runs, an end of line a row."""
    out = bytearray()
    for row in idx[::-1]:
        x, w = 0, len(row)
        while x < w:
            if x + 4 <= w and len(set(row[x:x + 4].tolist())) > 2:
                n = min(w - x, 8) & ~1
                vals = row[x:x + n].tolist()
                packed = bytes((vals[i] << 4) | vals[i + 1] for i in range(0, n, 2))
                out += bytes([0, n]) + packed + bytes(len(packed) & 1)
                x += n
            else:
                a = row[x]
                b = row[x + 1] if x + 1 < w else 0
                n = 1
                while x + n < w and row[x + n] == (a if n % 2 == 0 else b) and n < 255:
                    n += 1
                out += bytes([n, (a << 4) | b])
                x += n
        out += b"\0\0"
    return bytes(out + b"\0\1")


def _gif(idx, table, screen=None, offset=(0, 0), local=None, transparency=None,
         interlace=False, min_bits=None, clear_at=4096) -> bytes:
    """A GIF89a of one frame of (fh, fw) indices; ``table`` the global colour
    table (or None), ``local`` a local one."""
    fh, fw = idx.shape
    sw, sh = screen or (fw, fh)

    def tbl(t):
        n = len(t)
        bits = max(1, int(np.ceil(np.log2(max(n, 2)))))
        padded = np.zeros((1 << bits, 3), np.uint8)
        padded[:n] = t
        return bits, padded.tobytes()

    out = bytearray(b"GIF89a" + struct.pack("<HH", sw, sh))
    if table is not None:
        bits, raw = tbl(table)
        out += bytes([0x80 | (bits - 1), 0, 0]) + raw
    else:
        out += bytes([0, 0, 0])
    if transparency is not None:
        out += bytes([0x21, 0xF9, 4, 1, 0, 0, transparency, 0])
    flags = 0x40 if interlace else 0
    lraw = b""
    if local is not None:
        bits, lraw = tbl(local)
        flags |= 0x80 | (bits - 1)
    out += b"," + struct.pack("<HHHHB", offset[0], offset[1], fw, fh, flags) + lraw
    if interlace:
        rows = np.concatenate([np.arange(0, fh, 8), np.arange(4, fh, 8), np.arange(2, fh, 4),
                               np.arange(1, fh, 2)])
        idx = idx[rows]
    mb = min_bits or max(2, int(idx.max()).bit_length())
    data = _lzw(idx.astype(np.uint8).tobytes(), mb, msb=False, early=0, clear_at=clear_at)
    out += bytes([mb])
    for i in range(0, len(data), 255):
        part = data[i:i + 255]
        out += bytes([len(part)]) + part
    return bytes(out + b"\0;")


def _netpbm(magic, w, h, values, maxval=None, comment=False) -> bytes:
    head = magic + (b"\n# a comment\n" if comment else b"\n") + b"%d %d\n" % (w, h)
    if maxval is not None:
        head += b"%d\n" % maxval
    v = np.asarray(values)
    if magic in (b"P1", b"P2", b"P3"):
        toks = [str(int(x)).encode() for x in v.ravel()]
        lines = [b" ".join(toks[i:i + 17]) for i in range(0, len(toks), 17)]
        if comment:
            lines.insert(1, b"# inside the data")
        return head + b"\n".join(lines) + b"\n"
    if maxval is not None and maxval > 255:
        return head + v.astype(">u2").tobytes()
    return head + v.astype(np.uint8).tobytes()


# -------------------------------------------------------------------- cases

PIC = _natural(23, 37, seed=1)
POSTER = _natural(31, 45, seed=2, levels=4)
GRAY = np.asarray(Image.fromarray(PIC).convert("L"))
RNG = np.random.default_rng(5)
IDX16 = RNG.integers(0, 16, (19, 27)).astype(np.uint8)
IDX200 = RNG.integers(0, 200, (19, 27)).astype(np.uint8)
COLOURS = RNG.integers(0, 256, (256, 3)).astype(np.uint8)
RGBA = np.concatenate([PIC, RNG.integers(0, 256, PIC.shape[:2] + (1,)).astype(np.uint8)], -1)
SIXTEEN = (PIC.astype(np.uint16) * 257 + RNG.integers(0, 256, PIC.shape).astype(np.uint16))


def _premultiplied():
    a = RGBA[..., 3:].astype(np.int64)
    a[0, :4, 0] = (0, 255, 1, 128)
    rgb = (RGBA[..., :3].astype(np.int64) * a) // 255
    return np.concatenate([rgb, a], -1).astype(np.uint8)


def _pil_tiff(img, mode=None, **kw):
    return _pil(img, "TIFF", mode, **kw)


BMP_CASES = {
    "bmp_1bit": lambda: _pil(PIC, "BMP", "1"),
    "bmp_gray": lambda: _pil(PIC, "BMP", "L"),
    "bmp_palette": lambda: _pil(Image.fromarray(PIC).quantize(50), "BMP"),
    "bmp_rgb": lambda: _pil(PIC, "BMP"),
    "bmp_rgba_as_rgb": lambda: _pil(RGBA, "BMP"),
    "bmp_4bit": lambda: _bmp(_bmp_rows(IDX16, 4), 27, 19, 4, palette=COLOURS[:16]),
    "bmp_1bit_colour": lambda: _bmp(_bmp_rows(IDX16 & 1, 1), 27, 19, 1,
                                    palette=COLOURS[:2]),
    "bmp_8bit_short_palette": lambda: _bmp(_bmp_rows(IDX200, 8), 27, 19, 8,
                                           palette=COLOURS[:150], colors=150),
    "bmp_top_down": lambda: _bmp(_bmp_rows(PIC[::-1, :, ::-1], 24), 37, 23, 24, top_down=True),
    "bmp_16bit_555": lambda: _bmp(_bmp_rows(
        RNG.integers(0, 1 << 15, (19, 27)).astype(np.uint16), 16), 27, 19, 16),
    "bmp_16bit_565": lambda: _bmp(_bmp_rows(
        RNG.integers(0, 1 << 16, (19, 27)).astype(np.uint16), 16), 27, 19, 16, comp=3,
        masks=(0xF800, 0x7E0, 0x1F)),
    "bmp_32bit_bitfields_v4_alpha": lambda: _bmp(
        _bmp_rows(RGBA[..., [2, 1, 0, 3]], 32), 37, 23, 32, comp=3, header=108,
        masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000)),
    "bmp_32bit_bitfields_v5_rgba": lambda: _bmp(
        _bmp_rows(RGBA, 32), 37, 23, 32, comp=3, header=124,
        masks=(0xFF, 0xFF00, 0xFF0000, 0xFF000000)),
    "bmp_32bit_bitfields_40": lambda: _bmp(
        _bmp_rows(RGBA[..., [2, 1, 0, 3]], 32), 37, 23, 32, comp=3,
        masks=(0xFF0000, 0xFF00, 0xFF)),
    "bmp_32bit_xbgr": lambda: _bmp(
        _bmp_rows(RGBA[..., [3, 2, 1, 0]], 32), 37, 23, 32, comp=3, header=56,
        masks=(0xFF000000, 0xFF0000, 0xFF00, 0)),
    "bmp_core_header": lambda: _bmp(_bmp_rows(IDX200, 8), 27, 19, 8, palette=COLOURS,
                                    header=12),
    "bmp_rle8": lambda: _bmp(_rle8(IDX16 * (IDX16 > 6)), 27, 19, 8, comp=1,
                             palette=COLOURS[:256]),
    "bmp_rle8_gray": lambda: _bmp(_rle8(np.repeat(GRAY[:, ::4], 2, axis=1)), 20, 23, 8,
                                  comp=1, palette=np.repeat(np.arange(256)[:, None], 3, 1)),
    "bmp_rle4": lambda: _bmp(_rle4(IDX16 * (IDX16 > 9)), 27, 19, 4, comp=2,
                             palette=COLOURS[:16]),
    "bmp_rle8_delta_and_odd_runs": lambda: _bmp(
        bytes([3, 7, 0, 3, 1, 2, 3, 0, 0, 0, 2, 1, 0, 5, 9, 0, 0, 0, 5, 4, 4, 4, 4, 4,
               0, 0, 6, 8, 0, 1]), 6, 3, 8, comp=1, palette=COLOURS[:16], colors=16),
    "bmp_rle4_odd_absolute": lambda: _bmp(
        bytes([0, 5, 0x12, 0x34, 0x50, 0, 2, 0x67, 0, 0, 5, 0xAB, 0, 0, 0, 3, 0xCD, 0xE0,
               0, 0, 0, 1]), 5, 3, 4, comp=2, palette=COLOURS[:16]),
}

TIFF_CASES = {
    "tiff_rgb": lambda: _pil_tiff(PIC),
    "tiff_rgb_lzw_predictor": lambda: _pil_tiff(PIC, compression="tiff_lzw",
                                                tiffinfo={317: 2}),
    "tiff_rgb_deflate_predictor": lambda: _pil_tiff(PIC, compression="tiff_deflate",
                                                    tiffinfo={317: 2}),
    "tiff_rgb_packbits": lambda: _pil_tiff(POSTER, compression="packbits"),
    "tiff_rgba_lzw": lambda: _pil_tiff(RGBA, compression="tiff_lzw"),
    "tiff_gray_lzw": lambda: _pil_tiff(GRAY, compression="tiff_lzw"),
    "tiff_la": lambda: _pil_tiff(RGBA, "LA", compression="tiff_deflate"),
    "tiff_1bit": lambda: _pil_tiff(PIC, "1"),
    "tiff_1bit_lzw": lambda: _pil_tiff(PIC, "1", compression="tiff_lzw"),
    "tiff_palette": lambda: _pil_tiff(Image.fromarray(PIC).quantize(60), compression="tiff_lzw"),
    "tiff_16bit_gray_lzw": lambda: _pil_tiff(Image.fromarray(SIXTEEN[..., 0]),
                                             compression="tiff_lzw", tiffinfo={317: 2}),
    "tiff_16bit_gray_mm": lambda: _tiff(SIXTEEN[..., 0], 1, 16, bo=">", compression=5,
                                        predictor=2),
    "tiff_16bit_gray_min_is_white": lambda: _tiff(SIXTEEN[..., 0], 0, 16),
    "tiff_16bit_signed": lambda: _tiff(SIXTEEN[..., 1], 1, 16, sample_format=2),
    "tiff_16bit_rgb": lambda: _tiff(SIXTEEN, 2, 16, compression=8, predictor=2),
    "tiff_16bit_rgb_mm": lambda: _tiff(SIXTEEN, 2, 16, bo=">", compression=5),
    "tiff_16bit_rgba": lambda: _tiff(np.concatenate([SIXTEEN, SIXTEEN[..., :1]], -1), 2, 16,
                                     extra=(2,)),
    "tiff_min_is_white": lambda: _tiff(GRAY, 0, 8, compression=32773),
    "tiff_min_is_white_1bit": lambda: _tiff(GRAY > 100, 0, 1, compression=5),
    "tiff_gray_2bit": lambda: _tiff(GRAY >> 6, 1, 2),
    "tiff_gray_4bit_min_is_white": lambda: _tiff(GRAY >> 4, 0, 4, compression=8),
    "tiff_palette_4bit": lambda: _tiff(IDX16, 3, 4, colormap=COLOURS[:16].astype(np.uint16) * 257
                                       + 100),
    "tiff_palette_extra": lambda: _tiff(np.stack([IDX200, IDX16], -1), 3, 8, extra=(0,),
                                        colormap=COLOURS.astype(np.uint16) * 256),
    "tiff_rgba_associated": lambda: _tiff(_premultiplied(), 2, 8, extra=(1,)),
    "tiff_rgba_unspecified_extra": lambda: _tiff(RGBA, 2, 8, extra=(0,), compression=5),
    "tiff_rgba_no_extra_tag": lambda: _tiff(RGBA, 2, 8),
    "tiff_tiled_lzw_predictor": lambda: _tiff(_natural(41, 53), 2, 8, compression=5,
                                              predictor=2, tile=(16, 16)),
    "tiff_tiled_deflate_32946": lambda: _tiff(_natural(41, 53), 2, 8, compression=32946,
                                              tile=(32, 16)),
    "tiff_tiled_gray16": lambda: _tiff(SIXTEEN[..., 2], 1, 16, compression=8, predictor=2,
                                       tile=(16, 16)),
    "tiff_planar_rgb_lzw": lambda: _tiff(PIC, 2, 8, compression=5, planar=2, rows=7),
    "tiff_planar_rgba_tiled": lambda: _tiff(RGBA, 2, 8, compression=8, planar=2,
                                            tile=(16, 16), extra=(2,)),
    "tiff_strips": lambda: _tiff(PIC, 2, 8, compression=32773, rows=5),
    "tiff_bigtiff": lambda: _tiff(PIC, 2, 8, big=True, compression=5, predictor=2),
    "tiff_bigtiff_tiled": lambda: _tiff(_natural(41, 53), 2, 8, big=True, compression=8,
                                        tile=(16, 32)),
    "tiff_orientation_3": lambda: _tiff(PIC, 2, 8, orientation=3),
    "tiff_orientation_6": lambda: _tiff(PIC, 2, 8, orientation=6),
    "tiff_orientation_7": lambda: _tiff(GRAY, 1, 8, orientation=7),
    "tiff_orientation_8": lambda: _tiff(IDX16, 3, 4, orientation=8,
                                        colormap=COLOURS[:16].astype(np.uint16) * 257),
}

NETPBM_CASES = {
    "pbm_raw": lambda: _pil(PIC, "PPM", "1"),
    "pgm_raw": lambda: _pil(GRAY, "PPM"),
    "ppm_raw": lambda: _pil(PIC, "PPM"),
    "pgm_16bit": lambda: _pil(Image.fromarray(SIXTEEN[..., 0]), "PPM"),
    "pfm_gray": lambda: _pil(Image.fromarray(GRAY.astype(np.float32) * 1.37 - 20), "PPM"),
    "pfm_big_endian": lambda: b"Pf\n5 3\n1.0\n" + (np.arange(15, dtype=">f4") * 20.5
                                                   - 3).tobytes(),
    "pbm_plain": lambda: _netpbm(b"P1", 37, 23, GRAY > 120, comment=True),
    "pgm_plain": lambda: _netpbm(b"P2", 37, 23, GRAY, 255, comment=True),
    "ppm_plain_maxval_15": lambda: _netpbm(b"P3", 37, 23, PIC >> 4, 15),
    "pgm_plain_maxval_300": lambda: _netpbm(b"P2", 37, 23, GRAY.astype(int) + 45, 300),
    "pgm_raw_maxval_100": lambda: _netpbm(b"P5", 37, 23, np.minimum(GRAY, 110), 100),
    "ppm_raw_maxval_1000": lambda: _netpbm(b"P6", 37, 23, PIC.astype(np.uint16) * 4, 1000),
    "pgm_raw_maxval_1000": lambda: _netpbm(b"P5", 37, 23, GRAY.astype(np.uint16) * 4, 1000,
                                           comment=True),
}

GIF_CASES = {
    "gif_rgb": lambda: _pil(PIC, "GIF"),
    "gif_gray_opens_as_p": lambda: _pil(GRAY, "GIF"),
    "gif_identity_ramp_opens_as_l": lambda: _gif(IDX200, np.repeat(np.arange(256)[:, None], 3,
                                                                   1).astype(np.uint8)),
    "gif_poster": lambda: _pil(POSTER, "GIF"),
    "gif_transparency": lambda: _pil(Image.fromarray(PIC).quantize(30), "GIF", transparency=3),
    "gif_interlaced": lambda: _gif(IDX200[:, :25], COLOURS[:200], interlace=True),
    "gif_local_table": lambda: _gif(IDX16, COLOURS[:4], local=COLOURS[100:116]),
    "gif_no_table": lambda: _gif(IDX16, None),
    "gif_offset_in_screen": lambda: _gif(IDX16, COLOURS[:16], screen=(40, 30), offset=(5, 7)),
    "gif_offset_transparent": lambda: _gif(IDX16, COLOURS[:16], screen=(40, 30),
                                           offset=(9, 2), transparency=5),
    "gif_frame_past_screen": lambda: _gif(IDX16, COLOURS[:16], screen=(20, 10), offset=(3, 4)),
    "gif_deferred_clear": lambda: _gif(RNG.integers(0, 256, (90, 80)).astype(np.uint8),
                                       COLOURS, clear_at=None),
    "gif_min_code_size_2": lambda: _gif(IDX16 & 3, COLOURS[:4], min_bits=2),
    "gif_large_min_code_size": lambda: _gif(IDX16 & 3, COLOURS[:4], min_bits=8),
}


def _vp8x(data: bytes, alpha: bool) -> bytes:
    """A bare VP8L file rewrapped in a VP8X container (flag ALPHA as asked)."""
    chunk = data[12:]
    w, h = Image.open(io.BytesIO(data)).size
    vp8x = b"VP8X" + struct.pack("<I", 10) + bytes([0x10 if alpha else 0, 0, 0, 0]) + \
        (w - 1).to_bytes(3, "little") + (h - 1).to_bytes(3, "little")
    body = b"WEBP" + vp8x + chunk
    return b"RIFF" + struct.pack("<I", len(body)) + body


WEBP_CASES = {
    "webp_rgb": lambda: _pil(PIC, "WEBP", lossless=True),
    "webp_rgb_method_0": lambda: _pil(_natural(40, 60), "WEBP", lossless=True, method=0),
    "webp_rgb_method_6": lambda: _pil(_natural(40, 60), "WEBP", lossless=True, method=6,
                                      quality=100),
    "webp_rgba_exact": lambda: _pil(RGBA, "WEBP", lossless=True, exact=True),
    "webp_rgba": lambda: _pil(RGBA, "WEBP", lossless=True),
    "webp_2_colours": lambda: _pil(Image.fromarray(IDX16 & 1).point(lambda v: v * 255)
                                   .convert("RGB"), "WEBP", lossless=True),
    "webp_4_colours": lambda: _pil(COLOURS[IDX16 & 3], "WEBP", lossless=True),
    "webp_16_colours": lambda: _pil(COLOURS[IDX16], "WEBP", lossless=True),
    "webp_200_colours": lambda: _pil(COLOURS[IDX200], "WEBP", lossless=True),
    "webp_poster": lambda: _pil(_natural(64, 96, levels=8), "WEBP", lossless=True),
    "webp_vp8x_exif": lambda: _pil(PIC, "WEBP", lossless=True, exif=b"Exif\0\0MM\0*\0\0\0\x08\0\0"),
    "webp_vp8x_alpha_flag": lambda: _vp8x(_pil(RGBA, "WEBP", lossless=True), True),
    "webp_vp8x_no_alpha_flag": lambda: _vp8x(_pil(RGBA, "WEBP", lossless=True), False),
}

CASES = {**BMP_CASES, **TIFF_CASES, **NETPBM_CASES, **GIF_CASES, **WEBP_CASES}


def _opened(data: bytes):
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im), np.asarray(im.convert("RGB")), im.size, im.mode


@pytest.mark.parametrize("case", sorted(CASES))
def test_reader_equals_pil(tmp_path, case):
    """``read_array``: PIL's opened array (dtype, shape, values);
    ``read_rgb``: ``convert("RGB")``; ``image_size``: PIL's size."""
    from danerf_tpu_torch.data.images import image_size, read_array, read_rgb

    data = CASES[case]()
    path = tmp_path / "img"
    path.write_bytes(data)
    want, want_rgb, size, mode = _opened(data)
    got = read_array(str(path))
    assert got.dtype == want.dtype and got.shape == want.shape, (mode, got.dtype, got.shape)
    assert got.tobytes() == want.tobytes()           # a bool's True too is PIL's byte
    np.testing.assert_array_equal(read_rgb(str(path)), want_rgb)
    assert tuple(image_size(str(path))) == size


def test_image_size_of_an_oriented_tiff_is_swapped(tmp_path):
    """PIL reports an Orientation of 5-8 as the transposed size and loads the
    transposed pixels; the port's header read agrees."""
    from danerf_tpu_torch.data.images import image_size, read_array

    path = tmp_path / "o.tif"
    path.write_bytes(_tiff(PIC, 2, 8, orientation=5))
    with Image.open(path) as im:
        assert im.size == (23, 37)
        np.testing.assert_array_equal(read_array(str(path)), np.asarray(im))
    assert tuple(image_size(str(path))) == (23, 37)


def _inter_frame(data: bytes) -> bytes:
    """A lossy WebP whose frame tag says inter frame (no referee decodes it)."""
    at = data.index(b"VP8 ") + 8
    return data[:at] + bytes([data[at] | 1]) + data[at + 1:]


def _alph_header(data: bytes, head: int) -> bytes:
    """A lossy RGBA WebP with its ALPH header byte replaced."""
    at = data.index(b"ALPH") + 8
    return data[:at] + bytes([head]) + data[at + 1:]


def _animated_webp():
    frames = [Image.fromarray(PIC), Image.fromarray(PIC[::-1].copy())]
    buf = io.BytesIO()
    frames[0].save(buf, "WEBP", save_all=True, append_images=frames[1:], lossless=True)
    return buf.getvalue()


REFUSALS = {
    "webp_lossy": (lambda: _inter_frame(_pil(PIC, "WEBP", quality=80)), "not a key frame"),
    "webp_lossy_alpha": (lambda: _alph_header(_pil(RGBA, "WEBP", quality=80), 0x02),
                         "ALPH header 0x02"),
    "webp_animated": (_animated_webp, "animated WebP"),
    "tiff_jpeg": (lambda: _pil_tiff(PIC, compression="jpeg"), "JPEG compression"),
    "tiff_ccitt_group4": (lambda: _pil_tiff(PIC, "1", compression="group4"), "CCITT"),
    "tiff_cmyk": (lambda: _pil_tiff(PIC, "CMYK"), "CMYK"),
    "tiff_float": (lambda: _pil_tiff(Image.fromarray(GRAY.astype(np.float32))),
                   "float samples"),
    "tiff_32bit": (lambda: _pil_tiff(Image.fromarray(GRAY.astype(np.int32) * 1000)),
                   "32-bit samples"),
    "tiff_ycbcr": (lambda: _tiff(PIC, 6, 8), "YCbCr"),
    "tiff_fill_order_2": (lambda: _tiff(GRAY, 1, 8, fill=2), "FillOrder 2"),
    "tiff_palette_alpha": (lambda: _tiff(np.stack([IDX200, IDX16], -1), 3, 8, extra=(2,),
                                         colormap=COLOURS.astype(np.uint16) * 256),
                           "palette + alpha"),
    "tiff_float_predictor": (lambda: _tiff(GRAY, 1, 8, compression=5, predictor=3),
                             "Predictor 3"),
    "tiff_bigtiff_big_endian": (lambda: _tiff(PIC, 2, 8, bo=">", big=True), "BigTIFF"),
    "bmp_2bit": (lambda: _bmp(_bmp_rows(IDX16 & 3, 2), 27, 19, 2, palette=COLOURS[:4]),
                 "2 bits a pixel"),
    "bmp_jpeg": (lambda: _bmp(_pil(PIC, "JPEG"), 37, 23, 24, comp=4), "JPEG compression"),
    "bmp_odd_bitfields": (lambda: _bmp(_bmp_rows(RGBA, 32), 37, 23, 32, comp=3, header=108,
                                       masks=(0xFF00, 0xFF, 0xFF0000, 0xFF000000)),
                          "bitfields"),
    "bmp_4bit_gray_ramp": (lambda: _bmp(_bmp_rows(IDX16, 4), 27, 19, 4,
                                        palette=np.repeat(np.arange(16)[:, None], 3, 1)),
                           "gray ramp"),
    "pfm_colour": (lambda: b"PF\n2 2\n-1.0\n" + bytes(48), "colour PFM"),
    "cmyk_ppm": (lambda: b"P0CMYK\n2 2\n255\n" + bytes(16), "CMYK"),
    "jpeg2000": (lambda: b"\0\0\0\x0cjP  \r\n\x87\n" + bytes(40), "JPEG 2000"),
    "avif": (lambda: b"\0\0\0\x1cftypavif" + bytes(40), "AVIF"),
    "heif": (lambda: b"\0\0\0\x1cftypheic" + bytes(40), "HEIF"),
    "psd": (lambda: b"8BPS\0\1" + bytes(40), "PSD"),
    "qoi": (lambda: b"qoif" + bytes(40), "QOI"),
    "ico": (lambda: _pil(PIC, "ICO"), "ICO"),
    "dds": (lambda: _pil(RGBA, "DDS"), "DDS"),
    "tga": (lambda: _pil(PIC, "TGA"), "unknown image format"),
    "text": (lambda: b"hello, world\n", "unknown image format"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_name_the_format(tmp_path, case):
    """Files PIL opens (or, for a big-endian BigTIFF, does not) that the
    port does not read raise ValueError naming the format, from every
    entry point: ``read_array``, ``read_rgb`` and the custom loader's
    ``read_rgb``."""
    from danerf_tpu_torch.data import custom, images

    make, name = REFUSALS[case]
    path = tmp_path / "img"
    path.write_bytes(make())
    for read in (images.read_array, images.read_rgb, custom.read_rgb):
        with pytest.raises(ValueError, match=re.escape(name)):
            read(str(path))


@pytest.mark.parametrize("kind,min_bits", [("gif", 2), ("gif", 5), ("gif", 8), ("tiff", 8)])
@pytest.mark.parametrize("data", ["runs", "noise", "long_run"])
def test_lzw_round_trip(kind, min_bits, data):
    """``lzw_decode`` of the test's own encoder: random bytes, runs (chains
    of thousands of parents), a single long run, with clear codes where the
    table fills (TIFF) or a deferred clear (GIF)."""
    from danerf_tpu_torch.data.lzw import lzw_decode

    rng = np.random.default_rng(min_bits)
    top = 1 << min_bits
    if data == "noise":
        raw = rng.integers(0, top, 20000).astype(np.uint8).tobytes()
    elif data == "runs":
        raw = np.repeat(rng.integers(0, top, 300), rng.integers(1, 200, 300)).astype(
            np.uint8).tobytes()
    else:
        raw = bytes([top - 1]) * 100000
    gif = kind == "gif"
    enc = _lzw(raw, min_bits, msb=not gif, early=0 if gif else 1,
               clear_at=None if gif else 4094)
    got = lzw_decode(enc, min_bits, msb=not gif, early=0 if gif else 1, limit=len(raw))
    assert got.tobytes() == raw


def _depth_maps():
    """Depth maps of every kind the JAX preview takes through PIL, from one
    gray picture (149x203 is the committed fixtures' size; here smaller)."""
    g = np.asarray(Image.fromarray(_natural(29, 41, seed=4)).convert("L"))
    return {
        "jpeg": _pil(g, "JPEG", quality=90),
        "palette_png": _pil(Image.fromarray(_natural(29, 41, seed=4)).quantize(40), "PNG"),
        "1bit_png": _pil(g, "PNG", "1"),
        "16bit_png": _pil(Image.fromarray(g.astype(np.uint16) * 300), "PNG"),
        "gif": _pil(g, "GIF"),
        "rgb_png": _pil(_natural(29, 41, seed=4), "PNG"),
        "16bit_tiff_mm": _tiff(g.astype(np.uint16) * 251, 1, 16, bo=">"),
        "pgm_16bit": _pil(Image.fromarray(g.astype(np.uint16) * 257), "PPM"),
        "webp_lossy": _pil(g, "WEBP", quality=90),
    }


DEPTHS = sorted(_depth_maps())


@pytest.mark.parametrize("kind", DEPTHS)
def test_load_depth_equals_the_jax_preview_depth(tmp_path, monkeypatch, kind):
    """The depth array the JAX ``preview_from_files`` hands its effects
    (``np.asarray(Image.open(p))`` as float32, ``[..., 0]`` where 3-D, over
    255: a palette's indices, a 1-bit image's 0 or 1/255, 16-bit samples up
    to 257) equals the port's ``load_depth`` and what the port's
    ``preview_from_files`` hands its effects, bit for bit."""
    import danerf_tpu.fx.preview as jprev

    import danerf_tpu_torch.fx.preview as tprev
    from danerf_tpu_torch.fx.batch import load_depth

    depth = tmp_path / "depth"
    depth.write_bytes(_depth_maps()[kind])
    pic = tmp_path / "pic.png"
    with Image.open(depth) as im:
        Image.fromarray(_natural(im.size[1], im.size[0], seed=9)).save(pic)
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps({"effects": [{"name": "Fog"}]}))
    seen = {}
    monkeypatch.setattr(jprev, "render_previews",
                        lambda image, d, s, out: seen.setdefault("jax", d) is None or [])
    monkeypatch.setattr(tprev, "render_previews",
                        lambda image, d, s, out, device=None: seen.setdefault("port", d)
                        is None or [])
    jprev.preview_from_files(str(pic), str(depth), str(spec), str(tmp_path / "j"))
    tprev.preview_from_files(str(pic), str(depth), str(spec), str(tmp_path / "t"),
                             device="cpu")
    want = seen["jax"]
    got = load_depth(str(depth))
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(seen["port"], want)


def _custom_scene(root):
    """A custom scene of five frames in five of the new formats (four to
    train on, the last, a lossless WebP, to validate on)."""
    images = root / "images"
    images.mkdir(parents=True)
    rng = np.random.default_rng(8)
    pics = [_natural(21, 30, seed=20 + i) for i in range(5)]
    files = {"a.bmp": _pil(pics[0], "BMP"),
             "b.tif": _pil_tiff(pics[1], compression="tiff_lzw", tiffinfo={317: 2}),
             "c.gif": _pil(pics[2], "GIF"),
             "d.ppm": _pil(pics[3], "PPM"),
             "e.webp": _pil(pics[4], "WEBP", lossless=True)}
    frames = []
    for name, data in files.items():
        (images / name).write_bytes(data)
        frames.append({"file_path": name, "transform_matrix": rng.normal(size=(4, 4)).tolist()})
    (root / "transforms.json").write_text(json.dumps({"frames": frames, "camera_angle_x": 0.7}))
    return str(images)


def test_custom_scene_of_the_new_formats_matches_jax(tmp_path):
    """``load_custom_scene`` and ``load_dataset`` on BMP, TIFF, GIF, PPM and
    WebP frames against the JAX ``load_custom_scene`` (PIL's
    ``convert("RGB")``), and the scene's intrinsics from the first frame's
    header."""
    from danerf_tpu.data.custom import load_custom_scene as j_load
    from danerf_tpu_torch.config import NeRFConfig
    from danerf_tpu_torch.data.custom import load_custom_scene
    from danerf_tpu_torch.data.dataset import load_dataset, scene_intrinsics

    path = _custom_scene(tmp_path)
    for split, n in (("train", 4), ("val", 1)):
        want = j_load(path, split=split)
        got = load_custom_scene(path, split=split)
        assert got.n_images == n
        for k in ("images", "alphas", "c2ws"):
            np.testing.assert_array_equal(getattr(got, k), getattr(want, k), err_msg=k)
        assert got.focal == want.focal
        cfg = NeRFConfig(dataset_type="custom", dataset_path=path)
        np.testing.assert_array_equal(load_dataset(cfg, split).images, want.images)
        info = scene_intrinsics(cfg, split)
        assert (info.width, info.focal) == (want.width, want.focal)


# ------------------------------------------------- committed fixtures

def _frame():
    with Image.open(os.path.join(os.path.dirname(FORMATS), "frame.jpg")) as im:
        return np.asarray(im.convert("RGB"))


def _picture_800(h=800, w=800, seed=7, octaves=6):
    """The 800x800 timing picture: a landscape-like picture (a sky over a
    horizon and ground, textured by fractal noise: octaves of
    bicubic-upsampled Gaussian grids, as the loaders' 800x800 JPEG),
    posterized to 16 levels so that the three files stay small."""
    rng = np.random.default_rng(seed)
    field = np.zeros((3, h, w), np.float32)
    for o in range(1, octaves + 1):
        n = 2 ** o + 1
        for c in range(3):
            g = Image.fromarray(rng.normal(size=(n, n)).astype(np.float32))
            field[c] += np.asarray(g.resize((w, h), Image.BICUBIC)) * 0.72 ** o
    y = np.linspace(0, 1, h)[:, None]
    sky = np.stack([120 + 80 * (1 - y), 160 + 70 * (1 - y), 215 + 35 * (1 - y)])
    ground = np.stack([85 + 0 * y, 105 + 0 * y, 55 + 0 * y])
    t = 1 / (1 + np.exp(-(y - 0.5 - 0.1 * field[0]) * 30))
    img = sky * (1 - t) + ground * t + field * (12 + 50 * t)
    return np.clip(img.transpose(1, 2, 0), 0, 255).astype(np.uint8) & 0xF0


def _picture_800_jpeg():
    with Image.open(os.path.join(os.path.dirname(FORMATS), "picture_800.jpg")) as im:
        return np.asarray(im.convert("RGB"))


def format_fixture_bytes(name: str) -> bytes:
    """How each file of tests/data_torch/formats/ was made (Pillow 12.1.0
    with libtiff and libwebp; the hand-written variants by this module's
    writers).  The frames are frame.jpg's pixels (149x203); the lossy
    800x800 WebP is picture_800.jpg's, at PIL's quality 80 and method 4."""
    frame = _frame()
    gray = np.asarray(Image.fromarray(frame).convert("L"))
    q64 = Image.fromarray(frame).quantize(64)
    idx, pal = np.asarray(q64), np.asarray(q64.getpalette()[:192], np.uint8).reshape(-1, 3)
    h, w = gray.shape
    yy, xx = np.mgrid[0:h, 0:w]
    disc = np.clip(255 * (1.4 - np.hypot(xx - w / 2, yy - h / 2) / (0.4 * w)), 0, 255)
    rgba = np.concatenate([frame, disc.astype(np.uint8)[..., None]], -1)
    makers = {
        "frame.bmp": lambda: _pil(frame, "BMP"),
        "frame_rle8.bmp": lambda: _bmp(_rle8(idx), w, h, 8, comp=1, palette=pal, colors=64),
        "frame_565.bmp": lambda: _bmp(_bmp_rows(
            (((frame[..., 0] >> 3).astype(np.uint16) << 11) | ((frame[..., 1] >> 2).astype(
                np.uint16) << 5) | (frame[..., 2] >> 3))[::-1], 16), w, h, 16, comp=3,
            masks=(0xF800, 0x7E0, 0x1F), top_down=True),
        "frame.ppm": lambda: _pil(frame, "PPM"),
        "gray16.pgm": lambda: _pil(Image.fromarray(gray.astype(np.uint16) * 257),
                                   "PPM"),
        "frame_lzw.tif": lambda: _pil_tiff(frame, compression="tiff_lzw", tiffinfo={317: 2}),
        "frame_tiled.tif": lambda: _tiff(rgba, 2, 8, compression=8, predictor=2,
                                         tile=(64, 64), planar=2, extra=(2,)),
        "gray16_mm.tif": lambda: _tiff(gray.astype(np.uint16) * 257, 1, 16, bo=">",
                                       compression=5, predictor=2),
        "frame.gif": lambda: _pil(frame, "GIF"),
        "frame_interlaced.gif": lambda: _gif(idx, pal, interlace=True),
        "frame.webp": lambda: _pil(frame, "WEBP", lossless=True),
        "frame_rgba.webp": lambda: _pil(rgba, "WEBP", lossless=True, exact=True),
        "picture_800_lzw.tif": lambda: _pil_tiff(_picture_800(), compression="tiff_lzw",
                                                 tiffinfo={317: 2}),
        "picture_800.gif": lambda: _pil(_picture_800(), "GIF"),
        "picture_800.webp": lambda: _pil(_picture_800(), "WEBP", lossless=True),
        "frame_lossy.webp": lambda: _pil(frame, "WEBP", quality=80),
        "frame_lossy_rgba.webp": lambda: _pil(rgba, "WEBP", quality=80),
        "picture_800_lossy.webp": lambda: _pil(_picture_800_jpeg(), "WEBP", quality=80,
                                               method=4),
        "depth_lossy.webp": lambda: _pil(gray, "WEBP", quality=90),
        "depth.jpg": lambda: _pil(gray, "JPEG", quality=90),
        "depth_palette.png": lambda: _pil(q64, "PNG"),
        "depth_1bit.png": lambda: _pil(gray, "PNG", "1"),
        "depth.gif": lambda: _pil(gray, "GIF"),
    }
    return makers[name]()


FORMAT_FIXTURES = ("frame.bmp", "frame_rle8.bmp", "frame_565.bmp", "frame.ppm", "gray16.pgm",
                   "frame_lzw.tif", "frame_tiled.tif", "gray16_mm.tif", "frame.gif",
                   "frame_interlaced.gif", "frame.webp", "frame_rgba.webp",
                   "picture_800_lzw.tif", "picture_800.gif", "picture_800.webp", "depth.jpg",
                   "depth_palette.png", "depth_1bit.png", "depth.gif", "frame_lossy.webp",
                   "frame_lossy_rgba.webp", "picture_800_lossy.webp", "depth_lossy.webp")
DEPTH_FIXTURES = ("depth.jpg", "depth_palette.png", "depth_1bit.png", "depth.gif",
                  "depth_lossy.webp")


def _digest(a):
    a = np.ascontiguousarray(a)
    return {"dtype": a.dtype.str, "shape": list(a.shape),
            "sha256": hashlib.sha256(a.tobytes()).hexdigest()}


def pil_format_digests(name: str) -> dict:
    """PIL's views of a fixture by digest key: ``name`` the opened array,
    ``name + " rgb"`` its ``convert("RGB")``; a depth map also ``name + "
    depth"``, the JAX preview's depth array."""
    path = os.path.join(FORMATS, name)
    with Image.open(path) as im:
        opened, rgb = np.asarray(im), np.asarray(im.convert("RGB"))
    out = {name: _digest(opened), f"{name} rgb": _digest(rgb)}
    if name in DEPTH_FIXTURES:
        d = opened.astype(np.float32)
        out[f"{name} depth"] = _digest((d[..., 0] if d.ndim == 3 else d) / 255.0)
    return out


def write_format_fixtures():
    """Write tests/data_torch/formats/ anew: every fixture and the digests."""
    os.makedirs(FORMATS, exist_ok=True)
    digests = {}
    for name in FORMAT_FIXTURES:
        with open(os.path.join(FORMATS, name), "wb") as f:
            f.write(format_fixture_bytes(name))
        digests.update(pil_format_digests(name))
    with open(os.path.join(FORMATS, "pil_digests.json"), "w") as f:
        json.dump(digests, f, indent=1)


def test_format_fixtures_match_their_pil_digests():
    """The files chip_smoke.py decodes on the card's host (no PIL there):
    PIL's views computed again here equal the stored digests, and so do
    the port's ``read_array``, ``read_rgb`` and, for the depth maps,
    ``load_depth``; the folder stays within its 2 MB budget."""
    from danerf_tpu_torch.data.images import read_array, read_rgb
    from danerf_tpu_torch.fx.batch import load_depth

    with open(os.path.join(FORMATS, "pil_digests.json")) as f:
        stored = json.load(f)
    assert sorted(stored) == sorted(k for n in FORMAT_FIXTURES for k in pil_format_digests(n))
    for name in FORMAT_FIXTURES:
        path = os.path.join(FORMATS, name)
        for key, want in pil_format_digests(name).items():
            assert want == stored[key], key
        assert _digest(read_array(path)) == stored[name], name
        assert _digest(read_rgb(path)) == stored[f"{name} rgb"], name
        if name in DEPTH_FIXTURES:
            assert _digest(load_depth(path)) == stored[f"{name} depth"], name
    assert sum(os.path.getsize(os.path.join(FORMATS, n)) for n in os.listdir(FORMATS)) \
        < 2_000_000


if __name__ == "__main__":
    write_format_fixtures()


@pytest.mark.parametrize("name", FORMAT_FIXTURES)
def test_truncated_files_raise_value_error(tmp_path, name):
    """A fixture cut to half its length, to 40 bytes and to 12 bytes: the
    reader raises ValueError, never another error."""
    from danerf_tpu_torch.data.images import read_array, read_rgb

    data = open(os.path.join(FORMATS, name), "rb").read()
    for cut in (len(data) // 2, 40, 12):
        path = tmp_path / f"cut{cut}"
        path.write_bytes(data[:cut])
        for read in (read_array, read_rgb):
            with pytest.raises(ValueError):
                read(str(path))
